// Adaptive binary range coders — the in-process entropy backends that
// replace the reference's external `bsc e -b64p -e2` subprocesses
// (minicom:115-148, SURVEY.md C23). Three context models share one
// carryless 32-bit range coder (LZMA-style renormalization); one pass,
// no tables in the stream, fully deterministic:
//
// * o1rc — bytes through a 255-node bit tree, context = previous byte.
// * o2rc — same tree, context = the previous TWO bytes HASHED into 2^12
//   trees (measured bit-for-bit equal archive size to the full 64K-tree
//   table on the diff streams, with a 16x smaller table that lives in L2 —
//   1.7x faster both directions); wins on the structured diff-text streams.
// * dnarc — 2-bit base symbols (packed 4/byte in the stream) coded in ONE
//   4-ary range step per base; context = a rolling hash of the previous 16
//   bases into a table that SCALES with the stream (2^22..2^26 slots — see
//   dna_ctx_bits). High-order context modeling is what lets repeated genome
//   regions across contigs predict the next base nearly perfectly — the
//   same redundancy the reference outsources to bsc's BWT, at a fraction of
//   the time (and byte-oriented LZ can't see: 2-bit packing misaligns
//   repeats that aren't 0 mod 4 bases apart — measured xz -9e leaving a
//   2x-covered 7.6 Mbase consensus stream at 99.9%).
//
// Every family also has a BLOCKED container (`rc_encode_blocked` /
// `rc_decode_blocked`): streams larger than a family-specific block size are
// split into fixed-size blocks coded independently (model restarts) and in
// parallel with OpenMP — both directions. Blocks are large (>= 4 MiB) so the
// model-restart cost is negligible at the scales where splitting engages;
// the output is a pure function of (data, block size), never of the thread
// count.
//
// Build together with diffcodec.cpp into _native.so (see native/__init__.py).

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr int kProbBits = 12;
constexpr uint16_t kProbInit = 1u << (kProbBits - 1);
constexpr int kMoveBits = 5;

struct Encoder {
    uint8_t* out;
    int64_t cap, n = 0;
    uint32_t range = 0xFFFFFFFFu;
    uint64_t low = 0;
    uint8_t cache = 0;
    int64_t cache_size = 1;

    explicit Encoder(uint8_t* o, int64_t c) : out(o), cap(c) {}

    void shift_low() {
        if ((uint32_t)(low >> 32) != 0 || (uint32_t)low < 0xFF000000u) {
            uint8_t carry = (uint8_t)(low >> 32);
            while (cache_size) {
                if (n < cap) out[n] = (uint8_t)(cache + carry);
                ++n;
                cache = 0xFF;
                --cache_size;
            }
            cache = (uint8_t)(low >> 24);
        }
        ++cache_size;
        low = (low << 8) & 0xFFFFFFFFu;
    }

    void encode(uint16_t* p, int bit) {
        uint32_t bound = (range >> kProbBits) * *p;
        if (!bit) {
            range = bound;
            *p += (uint16_t)(((1u << kProbBits) - *p) >> kMoveBits);
        } else {
            low += bound;
            range -= bound;
            *p -= (uint16_t)(*p >> kMoveBits);
        }
        while (range < kTop) { shift_low(); range <<= 8; }
    }

    // explicit 12-bit P(bit==0), caller owns the model update
    void encode_p(uint32_t p0, int bit) {
        uint32_t bound = (range >> kProbBits) * p0;
        if (!bit) {
            range = bound;
        } else {
            low += bound;
            range -= bound;
        }
        while (range < kTop) { shift_low(); range <<= 8; }
    }

    void flush() { for (int i = 0; i < 5; ++i) shift_low(); }
};

struct Decoder {
    const uint8_t* in;
    int64_t len, pos = 0;
    uint32_t range = 0xFFFFFFFFu, code = 0;

    Decoder(const uint8_t* i, int64_t l) : in(i), len(l) {
        ++pos;  // first byte emitted by the encoder cache is always 0
        for (int i2 = 0; i2 < 4; ++i2)
            code = (code << 8) | (pos < len ? in[pos++] : 0);
    }

    int decode(uint16_t* p) {
        uint32_t bound = (range >> kProbBits) * *p;
        int bit;
        if (code < bound) {
            range = bound;
            *p += (uint16_t)(((1u << kProbBits) - *p) >> kMoveBits);
            bit = 0;
        } else {
            code -= bound;
            range -= bound;
            *p -= (uint16_t)(*p >> kMoveBits);
            bit = 1;
        }
        while (range < kTop) {
            code = (code << 8) | (pos < len ? in[pos++] : 0);
            range <<= 8;
        }
        return bit;
    }

    int decode_p(uint32_t p0) {
        uint32_t bound = (range >> kProbBits) * p0;
        int bit;
        if (code < bound) {
            range = bound;
            bit = 0;
        } else {
            code -= bound;
            range -= bound;
            bit = 1;
        }
        while (range < kTop) {
            code = (code << 8) | (pos < len ? in[pos++] : 0);
            range <<= 8;
        }
        return bit;
    }
};

}  // namespace

extern "C" {

// Encode `len` bytes; out must hold len + len/8 + 64 bytes. Returns bytes
// written, or -1 if out was too small.
int64_t o1rc_encode(const uint8_t* data, int64_t len, uint8_t* out,
                    int64_t out_cap) {
    std::vector<uint16_t> probs((size_t)256 * 256, kProbInit);
    Encoder enc(out, out_cap);
    uint8_t prev = 0;
    for (int64_t i = 0; i < len; ++i) {
        uint16_t* tree = probs.data() + (size_t)prev * 256;
        uint32_t node = 1;
        uint8_t b = data[i];
        for (int k = 7; k >= 0; --k) {
            int bit = (b >> k) & 1;
            enc.encode(&tree[node], bit);
            node = (node << 1) | bit;
        }
        prev = b;
    }
    enc.flush();
    return enc.n <= out_cap ? enc.n : -1;
}

// Decode exactly raw_len bytes.
int64_t o1rc_decode(const uint8_t* data, int64_t len, uint8_t* out,
                    int64_t raw_len) {
    std::vector<uint16_t> probs((size_t)256 * 256, kProbInit);
    Decoder dec(data, len);
    uint8_t prev = 0;
    for (int64_t i = 0; i < raw_len; ++i) {
        uint16_t* tree = probs.data() + (size_t)prev * 256;
        uint32_t node = 1;
        for (int k = 0; k < 8; ++k) node = (node << 1) | dec.decode(&tree[node]);
        uint8_t b = (uint8_t)(node & 0xFF);
        out[i] = b;
        prev = b;
    }
    return raw_len;
}

// ---- order-2 byte coder ---------------------------------------------------

namespace {
constexpr int kO2Bits = 12;
inline uint32_t o2_ctx(uint32_t ctx) {
    return (ctx * 0x9E3779B1u) >> (32 - kO2Bits);
}
}  // namespace

int64_t o2rc_encode(const uint8_t* data, int64_t len, uint8_t* out,
                    int64_t out_cap) {
    std::vector<uint16_t> probs((size_t)(1 << kO2Bits) * 256, kProbInit);
    Encoder enc(out, out_cap);
    uint32_t ctx = 0;  // prev1 | prev2 << 8
    for (int64_t i = 0; i < len; ++i) {
        uint16_t* tree = probs.data() + (size_t)o2_ctx(ctx) * 256;
        uint32_t node = 1;
        uint8_t b = data[i];
        for (int k = 7; k >= 0; --k) {
            int bit = (b >> k) & 1;
            enc.encode(&tree[node], bit);
            node = (node << 1) | bit;
        }
        ctx = ((ctx << 8) | b) & 0xFFFF;
    }
    enc.flush();
    return enc.n <= out_cap ? enc.n : -1;
}

int64_t o2rc_decode(const uint8_t* data, int64_t len, uint8_t* out,
                    int64_t raw_len) {
    std::vector<uint16_t> probs((size_t)(1 << kO2Bits) * 256, kProbInit);
    Decoder dec(data, len);
    uint32_t ctx = 0;
    for (int64_t i = 0; i < raw_len; ++i) {
        uint16_t* tree = probs.data() + (size_t)o2_ctx(ctx) * 256;
        uint32_t node = 1;
        for (int k = 0; k < 8; ++k) node = (node << 1) | dec.decode(&tree[node]);
        uint8_t b = (uint8_t)(node & 0xFF);
        out[i] = b;
        ctx = ((ctx << 8) | b) & 0xFFFF;
    }
    return raw_len;
}

// ---- DNA 2-bit symbol coder -----------------------------------------------
//
// The stream is packed 2-bit codes, 4 bases/byte little-endian-in-byte (the
// pack_2bit layout). Each base is coded in ONE 4-ary range step from a
// 4-count context record selected by hashing the previous 16 bases (rolling
// 32-bit history) into 2^22 contexts, linearly mixed with an order-6 (12-bit
// direct context) fallback. Probabilities are COUNT-BASED (sharpened KT
// estimator), not exponentially-adapted: high-order contexts on contig
// streams are seen only a handful of times, and next-base consistency within
// a repeated context is ~98%, so a confident prediction after ONE
// observation is the right bias — that lets repeated genome regions across
// contigs code at a fraction of a bit per base (the redundancy the reference
// outsources to bsc's BWT). An INVERTED-REPEAT update additionally inserts
// the reverse-complement view of the trailing window into the same table
// (the classic IR model of DNA compressors): contigs covering the same
// region in opposite orientations — ubiquitous here because read strands are
// canonicalized per cluster — predict each other. Trailing pad bases of the
// final byte are coded too (deterministic zeros).
//
// The serial bottleneck is the per-base dependent cache miss into the 16 MiB
// context table, so: (a) IR updates are deferred through a small ring and
// prefetched (encoder and decoder defer identically, streams stay in sync),
// (b) the decoder speculatively prefetches all four possible next-context
// lines before the current symbol resolves, (c) the encoder — which knows
// the future — prefetches the exact context lines 8 bases ahead. Together
// ~1.8x decode / ~2.1x encode over the naive loop at +0.5% size vs the old
// 2-bit-tree model.

namespace {
// Context-table size SCALES with the stream: an order-16 context is ~unique
// per genome position, so the table needs ~4-6 slots per base or hash
// collisions cross-pollute counts and kill the repeat prediction (measured:
// a fixed 2^22 table compresses a 7.6 Mbase consensus stream to 99% — i.e.
// not at all — where 2^25 reaches 78%). Both sides derive the size from the
// raw length they already know, so the format stays self-describing.
inline int dna_ctx_bits(int64_t raw_bytes) {
    int64_t bases = raw_bytes * 4;
    int bits = 22;
    while (bits < 26 && (bases >> (bits - 2)) > 0) ++bits;
    return bits;
}
inline uint32_t dna_ctx(uint32_t hist, uint32_t shift) {
    return (hist * 0x9E3779B1u) >> shift;
}

struct Ctr4 {  // 4-symbol counters, capped by halving (total stays < 60)
    uint8_t n[4];
    inline void update(uint32_t sym) {
        ++n[sym];
        if (n[0] + n[1] + n[2] + n[3] >= 60) {
            n[0] >>= 1; n[1] >>= 1; n[2] >>= 1; n[3] >>= 1;
        }
    }
    inline uint32_t tot() const { return n[0] + n[1] + n[2] + n[3]; }
};

// division-free probability/mix path (hot: 1 per base on encode AND decode).
// P[f][t] = (8f+1)<<12 / (8t+4) — the KT-style 12-bit symbol probability;
// RECIP[d] is an over-estimate reciprocal making num*RECIP[d] >> 40 an EXACT
// floor division for every numerator this model can produce (< 2^18).
struct DnaTables {
    uint16_t P[64][64];
    uint64_t RECIP[50];
    DnaTables() {
        for (int f = 0; f < 64; ++f)
            for (int t = 0; t < 64; ++t)
                P[f][t] = (uint16_t)((((uint32_t)(8 * f + 1)) << 12) /
                                     (8u * t + 4));
        for (int d = 1; d < 50; ++d)
            RECIP[d] = ((uint64_t)1 << 40) / d + 1;
    }
};
static const DnaTables kDna;

struct DnaModel {
    std::vector<Ctr4> hi;   // hashed order-16 contexts (4 B each)
    std::vector<Ctr4> lo;   // direct order-6 contexts
    uint32_t shift;         // 32 - ctx_bits
    explicit DnaModel(int bits)
        : hi((size_t)1 << bits), lo((size_t)1 << 12),
          shift(32u - (uint32_t)bits) {}

    // mixed 12-bit probs -> p[4], sums to exactly 4096; trust the high-order
    // context in proportion to its sample count
    static inline void mix(const Ctr4& h, const Ctr4& l, uint32_t* p) {
        uint32_t th = h.tot(), tl = l.tot();
        uint32_t w = 8u * th;
        if (w > 48) w = 48;
        uint64_t rc = kDna.RECIP[w + 1];
        uint32_t s = 0;
        for (int i = 0; i < 3; ++i) {
            uint32_t num = w * kDna.P[h.n[i]][th] + kDna.P[l.n[i]][tl];
            p[i] = (uint32_t)(((uint64_t)num * rc) >> 40);
            s += p[i];
        }
        p[3] = 4096 - s;
    }
};

// Rolling state shared by encode/decode: hist packs the last 16 bases
// (newest at bits 0-1), rhist their reverse complement in the rc stream's
// own reading order — rhist equals the hist the decoder of the rc sequence
// would hold at the mirrored position.
struct DnaState {
    uint32_t hist = 0, rhist = 0;
    int64_t n = 0;
    static constexpr int kIrLag = 8;  // deferred-IR ring depth
    uint32_t ir_ctx[kIrLag];
    uint8_t ir_sym[kIrLag];
    int ir_n = 0, ir_head = 0;

    inline void advance(DnaModel& m, uint32_t sym) {
        uint32_t oldest = (hist >> 30) & 3;
        hist = (hist << 2) | sym;
        rhist = (rhist >> 2) | ((sym ^ 3u) << 30);
        if (++n >= 17) {  // IR insert: ctx = rc window, symbol = comp(oldest)
            uint32_t c = dna_ctx(rhist, m.shift);
            __builtin_prefetch(&m.hi[c], 1, 1);
            if (ir_n == kIrLag)
                m.hi[ir_ctx[ir_head]].update(ir_sym[ir_head]);
            else
                ++ir_n;
            ir_ctx[ir_head] = c;
            ir_sym[ir_head] = (uint8_t)(oldest ^ 3u);
            ir_head = (ir_head + 1) % kIrLag;
        }
    }
};
}  // namespace

int64_t dnarc_encode(const uint8_t* data, int64_t len, uint8_t* out,
                     int64_t out_cap) {
    DnaModel m(dna_ctx_bits(len));
    DnaState st;
    Encoder enc(out, out_cap);
    constexpr int PF = 8;  // exact-context prefetch lookahead (bases)
    const int64_t nb = len * 4;
    auto sym_at = [&](int64_t j) -> uint32_t {
        return (data[j >> 2] >> (2 * (j & 3))) & 3;
    };
    uint32_t hist_pf = 0, rhist_pf = 0;
    for (int64_t j = 0; j < nb && j < PF; ++j) {
        uint32_t s = sym_at(j);
        hist_pf = (hist_pf << 2) | s;
        rhist_pf = (rhist_pf >> 2) | ((s ^ 3u) << 30);
    }
    uint32_t p[4];
    for (int64_t j = 0; j < nb; ++j) {
        if (j + PF < nb) {
            uint32_t s = sym_at(j + PF);
            hist_pf = (hist_pf << 2) | s;
            rhist_pf = (rhist_pf >> 2) | ((s ^ 3u) << 30);
            __builtin_prefetch(&m.hi[dna_ctx(hist_pf, m.shift)], 1, 1);
            __builtin_prefetch(&m.hi[dna_ctx(rhist_pf, m.shift)], 1, 1);
        }
        uint32_t sym = sym_at(j);
        Ctr4& h = m.hi[dna_ctx(st.hist, m.shift)];
        Ctr4& l = m.lo[st.hist & 0xFFF];
        DnaModel::mix(h, l, p);
        uint32_t cum = 0;
        for (uint32_t i = 0; i < sym; ++i) cum += p[i];
        {   // one 4-ary range step (top symbol absorbs the remainder)
            uint32_t r = enc.range >> kProbBits;
            enc.low += (uint64_t)cum * r;
            enc.range = sym == 3 ? enc.range - cum * r : p[sym] * r;
            while (enc.range < kTop) { enc.shift_low(); enc.range <<= 8; }
        }
        h.update(sym);
        l.update(sym);
        st.advance(m, sym);
    }
    enc.flush();
    return enc.n <= out_cap ? enc.n : -1;
}

int64_t dnarc_decode(const uint8_t* data, int64_t len, uint8_t* out,
                     int64_t raw_len) {
    DnaModel m(dna_ctx_bits(raw_len));
    DnaState st;
    Decoder dec(data, len);
    uint32_t p[4];
    for (int64_t i = 0; i < raw_len; ++i) {
        uint8_t byte = 0;
        for (int s = 0; s < 4; ++s) {
            Ctr4& h = m.hi[dna_ctx(st.hist, m.shift)];
            Ctr4& l = m.lo[st.hist & 0xFFF];
            // speculative prefetch: the 4 possible next context lines
            uint32_t nh = st.hist << 2;
            __builtin_prefetch(&m.hi[dna_ctx(nh, m.shift)], 0, 1);
            __builtin_prefetch(&m.hi[dna_ctx(nh | 1, m.shift)], 0, 1);
            __builtin_prefetch(&m.hi[dna_ctx(nh | 2, m.shift)], 0, 1);
            __builtin_prefetch(&m.hi[dna_ctx(nh | 3, m.shift)], 0, 1);
            DnaModel::mix(h, l, p);
            uint32_t r = dec.range >> kProbBits;
            uint32_t v = dec.code / r;
            if (v > 4095) v = 4095;
            uint32_t cum = 0, sym = 0;
            while (sym < 3 && cum + p[sym] <= v) cum += p[sym++];
            dec.code -= cum * r;
            dec.range = sym == 3 ? dec.range - cum * r : p[sym] * r;
            while (dec.range < kTop) {
                dec.code = (dec.code << 8)
                           | (dec.pos < dec.len ? dec.in[dec.pos++] : 0);
                dec.range <<= 8;
            }
            h.update(sym);
            l.update(sym);
            byte |= (uint8_t)(sym << (2 * s));
            st.advance(m, sym);
        }
        out[i] = byte;
    }
    return raw_len;
}

// ---- blocked container -----------------------------------------------------
//
// Layout: u32 n_blocks | u64 block_raw_bytes | u64 clen[n_blocks] | blobs.
// Blocks are coded independently (model restart per block) so encode AND
// decode parallelize across them; the output depends only on (data, block
// size). Family ids: 0 = o1rc, 1 = o2rc, 2 = dnarc.

namespace {
inline int64_t rc_run(int family, int enc, const uint8_t* in, int64_t n,
                      uint8_t* out, int64_t cap) {
    switch (family * 2 + enc) {
        case 0: return o1rc_decode(in, n, out, cap);
        case 1: return o1rc_encode(in, n, out, cap);
        case 2: return o2rc_decode(in, n, out, cap);
        case 3: return o2rc_encode(in, n, out, cap);
        case 4: return dnarc_decode(in, n, out, cap);
        default: return dnarc_encode(in, n, out, cap);
    }
}
inline void store_u32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }
inline void store_u64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }
inline uint32_t load_u32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
inline uint64_t load_u64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }
}  // namespace

int64_t rc_encode_blocked(int family, const uint8_t* data, int64_t len,
                          int64_t block, uint8_t* out, int64_t out_cap) {
    if (block <= 0) block = len > 0 ? len : 1;
    int64_t nb = len > 0 ? (len + block - 1) / block : 1;
    int64_t hdr = 4 + 8 + 8 * nb;
    if (hdr > out_cap) return -1;
    store_u32(out, (uint32_t)nb);
    store_u64(out + 4, (uint64_t)block);
    std::vector<std::vector<uint8_t>> blobs((size_t)nb);
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t b = 0; b < nb; ++b) {
        int64_t lo = b * block;
        int64_t n = len - lo < block ? len - lo : block;
        std::vector<uint8_t>& v = blobs[(size_t)b];
        int64_t cap = n + n / 4 + 64;
        int64_t e;
        for (;;) {  // adversarial blocks can expand; grow and retry
            v.resize((size_t)cap);
            e = rc_run(family, 1, data + lo, n, v.data(), cap);
            if (e >= 0) break;
            cap *= 4;
        }
        v.resize((size_t)e);
    }
    int64_t off = hdr;
    for (int64_t b = 0; b < nb; ++b) {
        store_u64(out + 4 + 8 + 8 * b, blobs[(size_t)b].size());
        int64_t e = (int64_t)blobs[(size_t)b].size();
        if (off + e > out_cap) return -1;
        memcpy(out + off, blobs[(size_t)b].data(), (size_t)e);
        off += e;
    }
    return off;
}

int64_t rc_decode_blocked(int family, const uint8_t* data, int64_t len,
                          uint8_t* out, int64_t raw_len) {
    if (len < 12) return -1;
    int64_t nb = (int64_t)load_u32(data);
    int64_t block = (int64_t)load_u64(data + 4);
    int64_t hdr = 4 + 8 + 8 * nb;
    if (nb <= 0 || block <= 0 || hdr > len) return -1;
    std::vector<int64_t> off((size_t)nb + 1, hdr);
    for (int64_t b = 0; b < nb; ++b) {
        int64_t c = (int64_t)load_u64(data + 4 + 8 + 8 * b);
        off[(size_t)b + 1] = off[(size_t)b] + c;
    }
    if (off[(size_t)nb] > len || (nb - 1) * block >= raw_len + block)
        return -1;
    int ok = 1;
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t b = 0; b < nb; ++b) {
        int64_t lo = b * block;
        if (lo >= raw_len && !(lo == 0 && raw_len == 0)) continue;
        int64_t n = raw_len - lo < block ? raw_len - lo : block;
        int64_t r = rc_run(family, 0, data + off[(size_t)b],
                           off[(size_t)b + 1] - off[(size_t)b], out + lo, n);
        if (r != n) {
#pragma omp atomic write
            ok = 0;
        }
    }
    return ok ? raw_len : -1;
}

}  // extern "C"
