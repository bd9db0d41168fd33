// dz: base-level self-referential LZ front end for packed-DNA streams.
//
// Why it exists (r05): the consensus stream's compressibility is mostly
// LONG REPEATS — contigs overlapping other contigs across the genome, in
// BOTH orientations. The dnarc context model captures that only with one
// giant adaptive table over the WHOLE stream, which decodes serially at
// ~4.5 Mbase/s (one latency-bound table miss per base) and loses 21-46%
// size when blocked for parallelism (measured on the 5M-read ref stream).
// dz moves the repeats out of the model: greedy base-granular LZ matching
// (forward + reverse-complement) dedupes them at memcpy speed, and only the
// (mostly unique) literal bases go through an entropy stage — now cheaply
// BLOCKED, so entropy decode parallelizes. The reference outsources the
// same redundancy to bsc's BWT (minicom:115-148).
//
// Matching is exact (DNA repeats here diverge ~0.5%, so runs between
// mismatches average ~200 bases): a single-slot hash table of every
// position's 32-base packed window, greedy forward extension. Encode is
// single-threaded and deterministic.
//
// Token semantics over the BASE sequence (bases = 4 * raw bytes, tail pad
// bases included verbatim): alternating (lit_len, match_len, dist) with
// dist's low bit the strand — 0: out[pos+k] = out[pos-d+k]; 1: the source
// is read backward-complemented from anchor end pos-d. Overlapping copies
// allowed (fwd only; rc sources must fully precede the output cursor).
//
// Layout (little-endian), version 2:
//   u8  'D', u8 version=2
//   u64 raw_len (bytes)   u64 n_lit_bytes   u32 n_tokens   u8 lit_codec
//   u64 clen_tokens | token blob  (3 deinterleaved u32 planes -> o1rc blocked)
//   u64 clen_lits   | literal blob (packed 2-bit; lit_codec 2 = dnarc
//                    blocked 1 MiB, 255 = stored raw — the encoder tries
//                    both and keeps the smaller: post-LZ literals are often
//                    near-random, where the adaptive model's learning cost
//                    exceeds 2 bits/base)
// Version 1 (r05 interim) had no lit_codec byte (always dnarc); decode
// still accepts it.
//
// dz_encode_parts/dz_decode_parts expose the SAME transform with the token
// planes and packed literals returned raw, so the Python layer can route
// the literals through the ON-CHIP context rANS (entropy/device_ctx_rans.py,
// codec "dzt") — the device entropy stage of the BASELINE north star.
//
// Build into _native.so with the other native TUs (see native/__init__.py).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
int64_t rc_encode_blocked(int family, const uint8_t* data, int64_t len,
                          int64_t block, uint8_t* out, int64_t out_cap);
int64_t rc_decode_blocked(int family, const uint8_t* data, int64_t len,
                          uint8_t* out, int64_t raw_len);
}

namespace {

constexpr int kAnchor = 32;        // bases per hash key (one u64)
constexpr int kMinMatch = 32;      // emit threshold (= anchor)
constexpr int64_t kLitBlock = 1 << 20;   // dnarc block for the literal bytes
constexpr int64_t kTokBlock = 8 << 20;   // o1rc block for the token planes

inline uint64_t mix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

// reverse-complement of a 32-base 2-bit-packed word (base 0 at bits 0-1)
inline uint64_t revcomp32(uint64_t x) {
    x = ~x;
    x = ((x & 0x3333333333333333ULL) << 2) |
        ((x >> 2) & 0x3333333333333333ULL);
    x = ((x & 0x0F0F0F0F0F0F0F0FULL) << 4) |
        ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL);
    return __builtin_bswap64(x);
}

inline void unpack_codes(const uint8_t* data, int64_t len, uint8_t* codes) {
    for (int64_t i = 0; i < len; ++i) {
        uint8_t b = data[i];
        codes[4 * i + 0] = b & 3;
        codes[4 * i + 1] = (b >> 2) & 3;
        codes[4 * i + 2] = (b >> 4) & 3;
        codes[4 * i + 3] = (b >> 6) & 3;
    }
}

inline void pack_codes(const uint8_t* codes, int64_t n_bases, uint8_t* out) {
    int64_t len = n_bases / 4;
    for (int64_t i = 0; i < len; ++i)
        out[i] = (uint8_t)(codes[4 * i] | (codes[4 * i + 1] << 2) |
                           (codes[4 * i + 2] << 4) | (codes[4 * i + 3] << 6));
}

inline void store_u64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }
inline void store_u32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }
inline uint64_t load_u64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }
inline uint32_t load_u32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }

// Greedy fwd+rc matcher shared by dz_encode and dz_encode_parts.
void dz_match(const uint8_t* data, int64_t len,
              std::vector<uint32_t>& lit_len, std::vector<uint32_t>& mat_len,
              std::vector<uint32_t>& mat_dist, std::vector<uint8_t>& lits) {
    const int64_t nb = len * 4;
    if (nb >= ((int64_t)1 << 31)) {
        // token fields are u32 with a strand bit: distances past 2^31 bases
        // cannot be represented. A >512 MiB packed stream degrades to one
        // literal run (correct, uncompressed here; the container's best-of
        // trial will pick a host coder instead).
        std::vector<uint8_t> codes((size_t)nb);
        unpack_codes(data, len, codes.data());
        int64_t pos = 0;
        while (pos < nb) {
            int64_t take = nb - pos < 0x7FFFFFFF ? nb - pos : 0x7FFFFFFF;
            lit_len.push_back((uint32_t)take);
            mat_len.push_back(0);
            mat_dist.push_back(0);
            lits.insert(lits.end(), codes.begin() + pos,
                        codes.begin() + pos + take);
            pos += take;
        }
        return;
    }
    std::vector<uint8_t> codes((size_t)nb + kAnchor, 0);
    unpack_codes(data, len, codes.data());

    // single-slot hash table over window positions
    size_t tab_sz = 64;
    while ((int64_t)tab_sz < nb) tab_sz <<= 1;
    if (tab_sz > (1u << 25)) tab_sz = 1u << 25;
    std::vector<int64_t> tab(tab_sz, -1);
    const uint64_t tmask = tab_sz - 1;

    lits.reserve((size_t)nb / 2);

    // rolling 32-base packed window at position i (bases i .. i+31)
    uint64_t w = 0;
    for (int64_t j = 0; j < kAnchor && j < nb; ++j)
        w |= (uint64_t)codes[j] << (2 * j);

    int64_t i = 0, lit_start = 0;
    const uint8_t* c = codes.data();
    while (i + kAnchor <= nb) {
        uint64_t h = mix64(w) & tmask;
        uint64_t hr = mix64(revcomp32(w)) & tmask;
        int64_t p = tab[h];
        int64_t pr = tab[hr];
        tab[h] = i;
        // forward candidate
        int64_t m_f = 0;
        if (p >= 0 && p < i) {
            int64_t lim = nb - i;
            while (m_f < lim && c[p + m_f] == c[i + m_f]) ++m_f;
        }
        // reverse-complement candidate: source anchor END e must precede i
        // so the decoder only reads already-written output
        int64_t m_r = 0, e = -1;
        if (pr >= 0 && pr + kAnchor <= i) {
            e = pr + kAnchor - 1;
            int64_t lim = nb - i < e + 1 ? nb - i : e + 1;
            while (m_r < lim && c[i + m_r] == (uint8_t)(3 - c[e - m_r]))
                ++m_r;
        }
        int64_t m = m_f >= m_r ? m_f : m_r;
        if (m >= kMinMatch) {
            int rc = m_r > m_f;
            lit_len.push_back((uint32_t)(i - lit_start));
            mat_len.push_back((uint32_t)m);
            mat_dist.push_back(
                (uint32_t)(((rc ? i - e : i - p) << 1) | rc));
            lits.insert(lits.end(), c + lit_start, c + i);
            // seed table inside the match (sparse: every 8 bases) so
            // later repeats of THIS region are still found
            int64_t stop = i + m;
            int64_t jj = i + 1;
            for (; jj + kAnchor <= stop && jj + kAnchor <= nb; jj += 8) {
                uint64_t wv = 0;
                for (int k = 0; k < kAnchor; ++k)
                    wv |= (uint64_t)c[jj + k] << (2 * k);
                tab[mix64(wv) & tmask] = jj;
            }
            i = stop;
            lit_start = i;
            if (i + kAnchor <= nb) {
                w = 0;
                for (int k = 0; k < kAnchor; ++k)
                    w |= (uint64_t)c[i + k] << (2 * k);
            }
            continue;
        }
        w = (w >> 2) | ((uint64_t)c[i + kAnchor] << (2 * (kAnchor - 1)));
        ++i;
    }
    lit_len.push_back((uint32_t)(nb - lit_start));
    mat_len.push_back(0);
    mat_dist.push_back(0);
    lits.insert(lits.end(), c + lit_start, c + nb);
}

// token arrays -> 12 deinterleaved u32 byte planes
std::vector<uint8_t> dz_tok_planes(const std::vector<uint32_t>& lit_len,
                                   const std::vector<uint32_t>& mat_len,
                                   const std::vector<uint32_t>& mat_dist) {
    const int64_t nt = (int64_t)lit_len.size();
    std::vector<uint8_t> tok((size_t)nt * 12);
    for (int plane = 0; plane < 4; ++plane) {
        for (int64_t t = 0; t < nt; ++t) {
            tok[(size_t)(plane * nt + t)] =
                (uint8_t)(lit_len[(size_t)t] >> (8 * plane));
            tok[(size_t)(4 * nt + plane * nt + t)] =
                (uint8_t)(mat_len[(size_t)t] >> (8 * plane));
            tok[(size_t)(8 * nt + plane * nt + t)] =
                (uint8_t)(mat_dist[(size_t)t] >> (8 * plane));
        }
    }
    return tok;
}

// pack literal base codes (pad to whole byte with zeros)
std::vector<uint8_t> dz_pack_lits(std::vector<uint8_t>& lits) {
    std::vector<uint8_t> lit_packed((size_t)(lits.size() + 3) / 4, 0);
    lits.resize((lits.size() + 3) & ~(size_t)3, 0);
    pack_codes(lits.data(), (int64_t)lits.size(), lit_packed.data());
    return lit_packed;
}

// apply tokens + literal codes -> packed output (shared decode core)
int64_t dz_apply(const uint8_t* tok, int64_t nt, const uint8_t* lit_packed,
                 int64_t n_lit_bytes, uint8_t* out, int64_t raw_len) {
    const int64_t nb = raw_len * 4;
    std::vector<uint8_t> codes((size_t)nb);
    std::vector<uint8_t> lits((size_t)n_lit_bytes * 4);
    unpack_codes(lit_packed, n_lit_bytes, lits.data());

    const uint8_t* lp = lits.data();
    const uint8_t* lend = lits.data() + lits.size();
    uint8_t* o = codes.data();
    int64_t pos = 0;
    for (int64_t t = 0; t < nt; ++t) {
        uint32_t ll = (uint32_t)tok[(size_t)t]
             | ((uint32_t)tok[(size_t)(nt + t)] << 8)
             | ((uint32_t)tok[(size_t)(2 * nt + t)] << 16)
             | ((uint32_t)tok[(size_t)(3 * nt + t)] << 24);
        uint32_t ml = (uint32_t)tok[(size_t)(4 * nt + t)]
             | ((uint32_t)tok[(size_t)(5 * nt + t)] << 8)
             | ((uint32_t)tok[(size_t)(6 * nt + t)] << 16)
             | ((uint32_t)tok[(size_t)(7 * nt + t)] << 24);
        uint32_t d = (uint32_t)tok[(size_t)(8 * nt + t)]
            | ((uint32_t)tok[(size_t)(9 * nt + t)] << 8)
            | ((uint32_t)tok[(size_t)(10 * nt + t)] << 16)
            | ((uint32_t)tok[(size_t)(11 * nt + t)] << 24);
        if (pos + ll + ml > nb || lp + ll > lend) return -1;
        memcpy(o + pos, lp, (size_t)ll);
        lp += ll;
        pos += ll;
        if (ml) {
            int rc = (int)(d & 1);
            int64_t dist = (int64_t)(d >> 1);
            if (dist > pos || dist == 0) return -1;
            uint8_t* dst = o + pos;
            if (rc) {
                const int64_t e = pos - dist;   // source anchor end
                if ((int64_t)ml - 1 > e) return -1;
                const uint8_t* src = o + e;
                for (uint32_t k = 0; k < ml; ++k)
                    dst[k] = (uint8_t)(3 - src[-(int64_t)k]);
            } else {
                const uint8_t* src = o + pos - dist;
                if (dist >= ml) {
                    memcpy(dst, src, (size_t)ml);
                } else {
                    for (uint32_t k = 0; k < ml; ++k) dst[k] = src[k];
                }
            }
            pos += ml;
        }
    }
    if (pos != nb) return -1;
    pack_codes(codes.data(), nb, out);
    return raw_len;
}

}  // namespace

extern "C" {

// Returns compressed length, or -1 if out_cap is too small (caller retries
// with a larger buffer; a cap of len + len/2 + 4096 always suffices because
// both sub-codecs fall back to near-raw on adversarial input).
int64_t dz_encode(const uint8_t* data, int64_t len, uint8_t* out,
                  int64_t out_cap) {
    std::vector<uint32_t> lit_len, mat_len, mat_dist;
    std::vector<uint8_t> lits;
    dz_match(data, len, lit_len, mat_len, mat_dist, lits);
    std::vector<uint8_t> tok = dz_tok_planes(lit_len, mat_len, mat_dist);
    std::vector<uint8_t> lit_packed = dz_pack_lits(lits);
    const int64_t nt = (int64_t)lit_len.size();

    const int64_t hdr = 2 + 8 + 8 + 4 + 1;
    if (out_cap < hdr + 16) return -1;
    out[0] = 'D';
    out[1] = 2;
    store_u64(out + 2, (uint64_t)len);
    store_u64(out + 10, (uint64_t)lit_packed.size());
    store_u32(out + 18, (uint32_t)nt);
    int64_t off = hdr;

    if (off + 8 > out_cap) return -1;
    int64_t ct = rc_encode_blocked(0 /*o1rc*/, tok.data(), (int64_t)tok.size(),
                                   kTokBlock, out + off + 8,
                                   out_cap - off - 8);
    if (ct < 0) return -1;
    store_u64(out + off, (uint64_t)ct);
    off += 8 + ct;

    // literal codec trial: blocked dnarc vs raw store (post-LZ literals can
    // be near-random, where the adaptive model costs > 2 bits/base)
    if (off + 8 > out_cap) return -1;
    int64_t cl = rc_encode_blocked(2 /*dnarc*/, lit_packed.data(),
                                   (int64_t)lit_packed.size(), kLitBlock,
                                   out + off + 8, out_cap - off - 8);
    if (cl < 0 || cl >= (int64_t)lit_packed.size()) {
        if (off + 8 + (int64_t)lit_packed.size() > out_cap) return -1;
        memcpy(out + off + 8, lit_packed.data(), lit_packed.size());
        cl = (int64_t)lit_packed.size();
        out[22] = 255;   // stored
    } else {
        out[22] = 2;     // dnarc
    }
    store_u64(out + off, (uint64_t)cl);
    off += 8 + cl;
    return off;
}

int64_t dz_decode(const uint8_t* data, int64_t len, uint8_t* out,
                  int64_t raw_len) {
    if (len < 22 || data[0] != 'D' || (data[1] != 1 && data[1] != 2))
        return -1;
    const int version = data[1];
    int64_t rl = (int64_t)load_u64(data + 2);
    int64_t n_lit_bytes = (int64_t)load_u64(data + 10);
    int64_t nt = (int64_t)load_u32(data + 18);
    int lit_codec = version == 2 ? data[22] : 2;
    if (rl != raw_len || nt <= 0) return -1;
    int64_t off = version == 2 ? 23 : 22;

    if (off + 8 > len) return -1;
    int64_t ct = (int64_t)load_u64(data + off);
    off += 8;
    if (off + ct > len) return -1;
    std::vector<uint8_t> tok((size_t)nt * 12);
    if (rc_decode_blocked(0, data + off, ct, tok.data(),
                          (int64_t)tok.size()) < 0)
        return -1;
    off += ct;

    if (off + 8 > len) return -1;
    int64_t cl = (int64_t)load_u64(data + off);
    off += 8;
    if (off + cl > len) return -1;
    std::vector<uint8_t> lit_packed((size_t)n_lit_bytes);
    if (lit_codec == 255) {
        if (cl != n_lit_bytes) return -1;
        memcpy(lit_packed.data(), data + off, (size_t)n_lit_bytes);
    } else if (lit_codec == 2) {
        if (rc_decode_blocked(2, data + off, cl, lit_packed.data(),
                              n_lit_bytes) < 0)
            return -1;
    } else {
        return -1;
    }
    return dz_apply(tok.data(), nt, lit_packed.data(), n_lit_bytes, out,
                    raw_len);
}

// Split transform for the on-chip literal path ("dzt", device_ctx_rans.py):
// token planes and packed literals come back RAW; the caller owns their
// entropy coding. Returns 0, or -1 when a cap is too small — then
// *nt_out / *nlit_out hold the required sizes (tok needs 12*nt bytes).
int64_t dz_encode_parts(const uint8_t* data, int64_t len,
                        uint8_t* tok_out, int64_t tok_cap,
                        uint8_t* lit_out, int64_t lit_cap,
                        int64_t* nt_out, int64_t* nlit_out) {
    std::vector<uint32_t> lit_len, mat_len, mat_dist;
    std::vector<uint8_t> lits;
    dz_match(data, len, lit_len, mat_len, mat_dist, lits);
    std::vector<uint8_t> tok = dz_tok_planes(lit_len, mat_len, mat_dist);
    std::vector<uint8_t> lit_packed = dz_pack_lits(lits);
    *nt_out = (int64_t)lit_len.size();
    *nlit_out = (int64_t)lit_packed.size();
    if ((int64_t)tok.size() > tok_cap ||
        (int64_t)lit_packed.size() > lit_cap)
        return -1;
    memcpy(tok_out, tok.data(), tok.size());
    memcpy(lit_out, lit_packed.data(), lit_packed.size());
    return 0;
}

int64_t dz_decode_parts(const uint8_t* tok, int64_t nt,
                        const uint8_t* lit_packed, int64_t n_lit_bytes,
                        uint8_t* out, int64_t raw_len) {
    if (nt <= 0) return -1;
    return dz_apply(tok, nt, lit_packed, n_lit_bytes, out, raw_len);
}

}  // extern "C"
