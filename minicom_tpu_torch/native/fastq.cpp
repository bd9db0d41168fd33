// Native FASTQ parser (reference: bseq.c + kseq.h, which stream records and
// enforce a uniform read length, bseq.c:54-57).
//
// Two entry points over an in-memory (already un-gzipped) buffer:
//   fastq_scan    — one memchr pass: validates 4-lines-per-record structure,
//                   returns N (reads) and L (uniform sequence length).
//   fastq_extract — indexes sequence-line starts, then converts sequence
//                   bytes to base codes (A=0 C=1 G=2 T=3, other=4 — the
//                   seq_nt4_table rule, sketch.c:8-25) in parallel rows.
//
// Errors: -1 truncated (line count % 4 != 0), -2 non-uniform length,
// -3 read length > 256 (minicom:51-54).

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

const uint8_t* next_nl(const uint8_t* p, const uint8_t* end) {
    const uint8_t* nl = (const uint8_t*)memchr(p, '\n', (size_t)(end - p));
    return nl ? nl : end;
}

struct Nt4 {
    uint8_t tab[256];
    Nt4() {
        memset(tab, 4, sizeof tab);
        tab['A'] = tab['a'] = 0;
        tab['C'] = tab['c'] = 1;
        tab['G'] = tab['g'] = 2;
        tab['T'] = tab['t'] = 3;
    }
};
const Nt4 NT4;

}  // namespace

extern "C" {

int64_t fastq_scan(const uint8_t* data, int64_t n,
                   int64_t* out_n_reads, int64_t* out_len) {
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    int64_t line = 0, L = -1;
    while (p < end) {
        const uint8_t* nl = next_nl(p, end);
        if ((line & 3) == 1) {  // sequence line
            int64_t len = nl - p;
            if (L < 0) L = len;
            else if (len != L) return -2;
        }
        ++line;
        p = nl + 1;
    }
    if (line % 4 != 0) return -1;
    if (L > 256) return -3;
    *out_n_reads = line / 4;
    *out_len = L < 0 ? 0 : L;
    return 0;
}

int64_t fastq_extract(const uint8_t* data, int64_t n,
                      int64_t n_reads, int64_t L, uint8_t* out_codes) {
    std::vector<const uint8_t*> seq(n_reads);
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    for (int64_t r = 0; r < n_reads; ++r) {
        p = next_nl(p, end) + 1;   // skip @name
        seq[r] = p;
        p = next_nl(p, end) + 1;   // skip sequence
        p = next_nl(p, end) + 1;   // skip +
        p = next_nl(p, end) + 1;   // skip quality
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < n_reads; ++r) {
        const uint8_t* s = seq[r];
        uint8_t* o = out_codes + r * L;
        for (int64_t i = 0; i < L; ++i) o[i] = NT4.tab[s[i]];
    }
    return n_reads;
}

// codes [N, L] -> ASCII lines "ACGTN...\n" per row, written to out
// (N*(L+1) bytes). The decode-side inverse of fastq_extract.
void codes_to_lines(const uint8_t* codes, int64_t n_reads, int64_t L,
                    uint8_t* out) {
    static const char B[5] = {'A', 'C', 'G', 'T', 'N'};
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < n_reads; ++r) {
        const uint8_t* c = codes + r * L;
        uint8_t* o = out + r * (L + 1);
        for (int64_t i = 0; i < L; ++i) o[i] = B[c[i]];
        o[L] = '\n';
    }
}

}  // extern "C"
