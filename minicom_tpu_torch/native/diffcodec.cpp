// Native codecs for minicom_tpu: diff-string encode/decode.
//
// Reimplements the reference's textual diff codec exactly
// (print_encode, kthread_dump.c:198-220 — cluster rule: match-run >= 2 emits
// decimal digits, run <= 1 emits the matched char(s) literally; AA/TT/NN rule,
// kthread_dump.c:580-596 — any match-run >= 1 emits digits; empty diff = "0";
// decoder: decompress.c:567-590). Exposed with a plain C ABI for ctypes.
//
// Encode parallelizes over rows with a two-pass (lengths -> prefix offsets ->
// write) scheme; decode indexes the newlines first, then decodes rows in
// parallel. Output bytes are identical for any thread count.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC ... -o _native.so

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__SSSE3__)
#include <tmmintrin.h>
#endif

namespace {

inline int64_t row_encoded_len(const uint8_t* rf, const uint8_t* rd,
                               int64_t len, int run_min) {
    int64_t total = 0, eq = 0;
    for (int64_t i = 0; i < len; ++i) {
        if (rf[i] != rd[i]) {
            if (eq >= run_min) {
                int64_t q = eq, d = 0;
                do { ++d; q /= 10; } while (q);
                total += d;
            } else {
                total += eq;
            }
            eq = 0;
            ++total;
        } else {
            ++eq;
        }
    }
    return total == 0 ? 1 : total;
}

inline uint8_t* encode_row(const uint8_t* rf, const uint8_t* rd, int64_t len,
                           int run_min, uint8_t* o) {
    uint8_t* row_start = o;
    int64_t eq = 0;
    for (int64_t i = 0; i < len; ++i) {
        if (rf[i] != rd[i]) {
            if (eq >= run_min) {
                char buf[12];
                int n = snprintf(buf, sizeof buf, "%lld", (long long)eq);
                memcpy(o, buf, n);
                o += n;
            } else {
                for (int64_t j = i - eq; j < i; ++j) *o++ = rd[j];
            }
            eq = 0;
            *o++ = rd[i];
        } else {
            ++eq;
        }
    }
    if (o == row_start) *o++ = '0';
    *o++ = '\n';
    return o;
}

}  // namespace

extern "C" {

// rows encoded against per-row refs; rule: 0 = cluster (run>=2 -> digits),
// 1 = aattnn (run>=1 -> digits). Returns bytes written to out ('\n' after
// each row). out must hold at least n_rows * (len + 12) bytes.
int64_t diff_encode(const uint8_t* ref, const uint8_t* read,
                    int64_t n_rows, int64_t len, int rule, uint8_t* out) {
    const int run_min = rule == 0 ? 2 : 1;
    std::vector<int64_t> off(n_rows + 1);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < n_rows; ++r)
        off[r + 1] = row_encoded_len(ref + r * len, read + r * len,
                                     len, run_min) + 1;  // + '\n'
    off[0] = 0;
    for (int64_t r = 0; r < n_rows; ++r) off[r + 1] += off[r];
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < n_rows; ++r)
        encode_row(ref + r * len, read + r * len, len, run_min, out + off[r]);
    return off[n_rows];
}

// Decode n_rows diff lines ('\n'-separated) against per-row refs into read
// rows. Returns number of rows decoded (== n_rows on success, < 0 on error).
int64_t diff_decode(const uint8_t* text, int64_t text_len,
                    const uint8_t* ref, int64_t n_rows, int64_t len,
                    uint8_t* out) {
    // index the line starts once (memchr scan), then decode rows in parallel
    std::vector<const uint8_t*> starts(n_rows + 1);
    const uint8_t* p = text;
    const uint8_t* end = text + text_len;
    for (int64_t r = 0; r < n_rows; ++r) {
        starts[r] = p;
        const uint8_t* nl =
            (const uint8_t*)memchr(p, '\n', (size_t)(end - p));
        p = nl ? nl + 1 : end;
    }
    starts[n_rows] = p;

    int64_t bad = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < n_rows; ++r) {
        const uint8_t* q = starts[r];
        const uint8_t* qe = starts[r + 1];
        const uint8_t* rf = ref + r * len;
        uint8_t* rd = out + r * len;
        int64_t pos = 0;
        int64_t eq = 0;
        while (q < qe && *q != '\n') {
            uint8_t c = *q++;
            if (c >= 'A' && c <= 'Z') {
                while (eq > 0 && pos < len) { rd[pos] = rf[pos]; ++pos; --eq; }
                if (pos < len) rd[pos++] = c;
            } else if (c >= '0' && c <= '9') {
                eq = eq * 10 + (c - '0');
            } else {
#ifdef _OPENMP
#pragma omp critical
#endif
                { if (!bad || r + 1 < bad) bad = r + 1; }  // lowest row: deterministic errors
                break;
            }
        }
        while (pos < len) { rd[pos] = rf[pos]; ++pos; }
    }
    return bad ? -bad : n_rows;
}

// Windowed variants working directly on BASE CODES (0..4): the ref window of
// row r starts at ref_codes + win_base[r] in the flat consensus stream, the
// read row is reverse-complemented in place when dirs[r] == 1, and both are
// mapped to ASCII on the fly — replacing three full-matrix host passes
// (gather, orient, code->ASCII) per serialize/decode call.

static const char CODE2ASCII[5] = {'A', 'C', 'G', 'T', 'N'};

namespace {

// 2-bit base codes (0..3, packed-ref alphabet) -> ASCII, one SIMD LUT pass
inline void codes_row_to_ascii(const uint8_t* c, uint8_t* o, int64_t n) {
    int64_t i = 0;
#if defined(__SSSE3__)
    const __m128i lut = _mm_setr_epi8('A', 'C', 'G', 'T', 'N', 0, 0, 0,
                                      0, 0, 0, 0, 0, 0, 0, 0);
    for (; i + 16 <= n; i += 16) {
        __m128i v = _mm_loadu_si128((const __m128i*)(c + i));
        _mm_storeu_si128((__m128i*)(o + i), _mm_shuffle_epi8(lut, v));
    }
#endif
    for (; i < n; ++i) o[i] = (uint8_t)CODE2ASCII[c[i]];
}

struct CompLut {
    uint8_t t[256];
    CompLut() {
        for (int i = 0; i < 256; ++i) t[i] = (uint8_t)i;
        t['A'] = 'T'; t['T'] = 'A'; t['C'] = 'G'; t['G'] = 'C';
    }
};
static const CompLut kComp;

}  // namespace

int64_t diff_encode_win(const uint8_t* ref_codes, const int64_t* win_base,
                        const uint8_t* read_codes, const int8_t* dirs,
                        int64_t n_rows, int64_t len, int rule, uint8_t* out) {
    const int run_min = rule == 0 ? 2 : 1;
    std::vector<int64_t> off(n_rows + 1);
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<uint8_t> rf(len), rd(len);
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
        for (int64_t r = 0; r < n_rows; ++r) {
            const uint8_t* w = ref_codes + win_base[r];
            const uint8_t* rr = read_codes + r * len;
            for (int64_t i = 0; i < len; ++i) rf[i] = CODE2ASCII[w[i]];
            if (dirs && dirs[r]) {
                for (int64_t i = 0; i < len; ++i) {
                    uint8_t c = rr[len - 1 - i];
                    rd[i] = CODE2ASCII[c < 4 ? 3 - c : c];
                }
            } else {
                for (int64_t i = 0; i < len; ++i) rd[i] = CODE2ASCII[rr[i]];
            }
            off[r + 1] =
                row_encoded_len(rf.data(), rd.data(), len, run_min) + 1;
        }
    }
    off[0] = 0;
    for (int64_t r = 0; r < n_rows; ++r) off[r + 1] += off[r];
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<uint8_t> rf(len), rd(len);
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
        for (int64_t r = 0; r < n_rows; ++r) {
            const uint8_t* w = ref_codes + win_base[r];
            const uint8_t* rr = read_codes + r * len;
            for (int64_t i = 0; i < len; ++i) rf[i] = CODE2ASCII[w[i]];
            if (dirs && dirs[r]) {
                for (int64_t i = 0; i < len; ++i) {
                    uint8_t c = rr[len - 1 - i];
                    rd[i] = CODE2ASCII[c < 4 ? 3 - c : c];
                }
            } else {
                for (int64_t i = 0; i < len; ++i) rd[i] = CODE2ASCII[rr[i]];
            }
            encode_row(rf.data(), rd.data(), len, run_min, out + off[r]);
        }
    }
    return off[n_rows];
}

// Windowed decode: diff lines + flat ref codes -> ASCII read rows, applying
// the reverse complement where dirs[r] == 1 (decompress.c:573-602 semantics).
// Row r is written at out + r * out_stride (stride >= len lets callers
// decode straight into an [N, L+1] output-with-newlines matrix, r05).
//
// Fast path: the window codes are converted to ASCII directly into the
// destination row with ONE SIMD LUT pass, then the (few) mismatch chars from
// the diff line are patched in — instead of building the ref row, the read
// row, and copying (3 passes/row).
int64_t diff_decode_win_strided(const uint8_t* text, int64_t text_len,
                                const uint8_t* ref_codes,
                                const int64_t* win_base,
                                const int8_t* dirs, int64_t n_rows,
                                int64_t len, uint8_t* out,
                                int64_t out_stride) {
    std::vector<const uint8_t*> starts(n_rows + 1);
    const uint8_t* p = text;
    const uint8_t* end = text + text_len;
    for (int64_t r = 0; r < n_rows; ++r) {
        starts[r] = p;
        const uint8_t* nl =
            (const uint8_t*)memchr(p, '\n', (size_t)(end - p));
        p = nl ? nl + 1 : end;
    }
    starts[n_rows] = p;

    int64_t bad = 0;
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<uint8_t> tmp(len);
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
        for (int64_t r = 0; r < n_rows; ++r) {
            const uint8_t* w = ref_codes + win_base[r];
            uint8_t* dst = out + r * out_stride;
            const bool rc = dirs && dirs[r];
            uint8_t* rd = rc ? tmp.data() : dst;
            codes_row_to_ascii(w, rd, len);
            const uint8_t* q = starts[r];
            const uint8_t* qe = starts[r + 1];
            int64_t pos = 0, eq = 0;
            while (q < qe && *q != '\n') {
                uint8_t c = *q++;
                if (c >= 'A' && c <= 'Z') {
                    pos += eq;
                    eq = 0;
                    if (pos < len) rd[pos++] = c;
                } else if (c >= '0' && c <= '9') {
                    eq = eq * 10 + (c - '0');
                } else {
#ifdef _OPENMP
#pragma omp critical
#endif
                    { if (!bad || r + 1 < bad) bad = r + 1; }  // lowest row: deterministic errors
                    break;
                }
            }
            if (rc) {
                for (int64_t i = 0; i < len; ++i)
                    dst[i] = kComp.t[rd[len - 1 - i]];
            }
        }
    }
    return bad ? -bad : n_rows;
}

int64_t diff_decode_win(const uint8_t* text, int64_t text_len,
                        const uint8_t* ref_codes, const int64_t* win_base,
                        const int8_t* dirs, int64_t n_rows, int64_t len,
                        uint8_t* out) {
    return diff_decode_win_strided(text, text_len, ref_codes, win_base, dirs,
                                   n_rows, len, out, len);
}

// Cluster stream metadata -> per-member flat ref-window starts + strand
// flags in ONE serial pass (the numpy cumsum/repeat/gather chain cost ~0.9s
// at 5M reads, r05). Semantics mirror pipeline/decode.py: member positions
// are per-cluster running sums of the u16 deltas (escape -> next u32), the
// cluster's consensus length is last position + L, and consensus extents are
// concatenated in cluster order (decompress.c:534-602's implicit state).
// dirs: bit i of dirbits at bit position i%8 of byte i/8 (bit_push layout).
// Returns total consensus bases, or -1 on malformed streams.
int64_t decode_cluster_meta(const uint32_t* cnt, int64_t C,
                            const uint16_t* d16, const uint32_t* dx,
                            int64_t nx, const uint8_t* dirbits,
                            int64_t M, int64_t L, uint32_t esc,
                            int64_t* win_base, int8_t* dirs_out) {
    int64_t mi = 0, xi = 0, rbase = 0;
    for (int64_t c = 0; c < C; ++c) {
        int64_t gp = 0;
        const int64_t n = (int64_t)cnt[c];
        if (mi + n > M) return -1;
        for (int64_t j = 0; j < n; ++j, ++mi) {
            uint32_t d = d16[mi];
            int64_t delta;
            if (d == esc) {
                if (xi >= nx) return -1;
                delta = (int64_t)dx[xi++];
            } else {
                delta = (int64_t)d;
            }
            gp += delta;
            win_base[mi] = rbase + gp;
        }
        rbase += gp + L;
    }
    if (mi != M) return -1;
    for (int64_t i = 0; i < M; ++i)
        dirs_out[i] = (int8_t)((dirbits[i >> 3] >> (i & 7)) & 1);
    return rbase;
}

// Encoded length per row without materializing (used for the 0.4*L accept
// rule in realignment, encode_byte, kthread_hash_realign.c:283-314).
void diff_encode_lengths(const uint8_t* ref, const uint8_t* read,
                         int64_t n_rows, int64_t len, int rule,
                         int32_t* out_lens) {
    const int run_min = rule == 0 ? 2 : 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < n_rows; ++r)
        out_lens[r] = (int32_t)row_encoded_len(ref + r * len, read + r * len,
                                               len, run_min);
}

}  // extern "C"
