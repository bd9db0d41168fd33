// Native realignment probe core (reference hot loop 6:
// realign_hash_search, kthread_hash_realign.c:316-508).
//
// r05 redesign: instead of probing every (contig offset, dictionary, strand)
// — 2*n_dicts hash probes per window, the exact shape of the reference's
// dominant loop and 30.6s of the r04 hard-profile encode — ONE combined
// table holds every (segment-key, dict, singleton) entry sorted by
// (key, dict, singleton). The scan then probes each contig POSITION once
// forward and once reverse-complement with rolling keys: a hit yields, per
// dict d in the run, the unique window offset jj that would have probed this
// key (fwd jj = p - dict_start[d]; rc jj = p + dict_start[d] + seg - L).
// Identical candidate set, ~n_dicts x fewer probes/bloom tests.
//
// Everything else is unchanged: candidates are verified by XOR-popcount
// over 2-bit-packed words (basediff, bbhashdict.c:247-254) against the
// threshold, plus the encode-cost <= 0.4*L rule (encode_byte,
// kthread_hash_realign.c:283-314; on the rc path only when threshold > 24,
// :461); the per-(window, dict, strand) hit cap takes the first max_search
// entries in singleton order, exactly like the per-dict sorted tables did.
// The Python side picks one winner per read (order-independent lexsort), so
// emission order does not affect the archive.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif
// libstdc++'s parallel mode only: a build with another standard library
// (clang with libc++) sorts with std::sort
#if defined(_OPENMP) && defined(__GLIBCXX__)
#define MTC_PARALLEL_SORT 1
#include <parallel/algorithm>
#endif

namespace {
inline double now_s() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
}
inline bool probe_debug() {
    static int v = -1;
    if (v < 0) v = getenv("MTC_REALIGN_DEBUG") ? 1 : 0;
    return v == 1;
}
}  // namespace

namespace {

inline uint64_t pack_window(const uint8_t* codes, int len) {
    uint64_t key = 0;
    for (int i = 0; i < len; ++i) key |= (uint64_t)codes[i] << (2 * i);
    return key;
}

inline void pack_words(const uint8_t* codes, int64_t L, uint64_t* words) {
    int64_t W = (L + 31) / 32;
    for (int64_t w = 0; w < W; ++w) words[w] = 0;
    for (int64_t i = 0; i < L; ++i)
        words[i >> 5] |= (uint64_t)codes[i] << (2 * (i & 31));
}

inline int popcount_xor(const uint64_t* a, const uint64_t* b, int64_t W) {
    int c = 0;
    for (int64_t w = 0; w < W; ++w) c += __builtin_popcountll(a[w] ^ b[w]);
    return c;
}

// 2*seg_len bits of the packed window starting at base ds (seg_len <= 31, so
// the key spans at most two words). words must have one zero guard word.
inline uint64_t extract_key(const uint64_t* words, int ds, int seg_len) {
    int shift = 2 * (ds & 31);
    uint64_t key = words[ds >> 5] >> shift;
    if (shift) key |= words[(ds >> 5) + 1] << (64 - shift);
    return key & ((seg_len < 32) ? ((1ULL << (2 * seg_len)) - 1) : ~0ULL);
}

// diff-string encoded length, cluster rule (run >= 2 -> digits), vs capped
// early exit once the 0.4*L budget is exceeded.
inline bool encode_cost_ok(const uint8_t* ref_win, const uint8_t* read,
                           int64_t L, int64_t budget) {
    int64_t total = 0, eq = 0;
    for (int64_t i = 0; i < L; ++i) {
        if (ref_win[i] != read[i]) {
            if (eq >= 2) {
                int64_t q = eq;
                do { ++total; q /= 10; } while (q);
            } else {
                total += eq;
            }
            eq = 0;
            ++total;
            if (total > budget) return false;
        } else {
            ++eq;
        }
    }
    if (total == 0) total = 1;
    return total <= budget;
}

inline uint64_t mix64(uint64_t x) {  // splitmix64 finalizer
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

// Combined-table entry: segment key + payload (dict << 27 | singleton id).
// Payload order within one key = (dict asc, singleton asc) — exactly the
// per-dict sorted-table order the hit cap is defined over.
struct Entry {
    uint64_t k;
    uint32_t p;
};
constexpr uint32_t kPayDictShift = 27;
constexpr uint32_t kPaySgMask = (1u << kPayDictShift) - 1;

// Open-addressing map key -> (start, count) into the sorted (key, idx) table,
// fronted by a compact block-Bloom filter: ~99% of window probes miss, and a
// miss that resolves in the small filter (one cache line, two bits of one
// 64-bit word) avoids touching the much larger key table entirely — the
// probe scan is memory-latency-bound on the miss path (VERDICT r03 item 1).
struct KeyMap {
    std::vector<uint64_t> keys;       // EMPTY = sentinel
    std::vector<uint64_t> slot;       // start << 24 | count (count capped)
    std::vector<uint64_t> bloom;      // 2 bits/key, ~16x n bits total
    uint64_t mask = 0;
    uint64_t bmask = 0;
    static constexpr uint64_t EMPTY = ~0ULL;

    void build_runs(const Entry* tab, size_t n) {
        size_t cap = 16;
        while (cap < n * 2 + 16) cap <<= 1;
        keys.assign(cap, EMPTY);
        slot.assign(cap, 0);
        mask = cap - 1;
        size_t bw = 1024;  // >= 16 bits/key keeps the false-pass rate ~1-2%
        while (bw * 64 < n * 16) bw <<= 1;
        bloom.assign(bw, 0);
        bmask = bw - 1;
        size_t i = 0;
        while (i < n) {
            size_t j = i;
            while (j < n && tab[j].k == tab[i].k) ++j;
            uint64_t k = tab[i].k;
            uint64_t hv = mix64(k);
            uint64_t h = hv & mask;
            while (keys[h] != EMPTY) h = (h + 1) & mask;
            keys[h] = k;
            uint64_t cnt = j - i;
            if (cnt > 0xFFFFFF) cnt = 0xFFFFFF;  // callers cap at max_search
            slot[h] = ((uint64_t)i << 24) | cnt;
            bloom[(hv >> 24) & bmask] |=
                (1ULL << (hv & 63)) | (1ULL << ((hv >> 6) & 63));
            i = j;
        }
    }
    inline uint64_t bloom_word_idx(uint64_t hv) const {
        return (hv >> 24) & bmask;
    }
    inline bool bloom_pass(uint64_t hv) const {
        uint64_t w = bloom[(hv >> 24) & bmask];
        return ((w >> (hv & 63)) & 1) && ((w >> ((hv >> 6) & 63)) & 1);
    }
    // returns count, sets *start; 0 on miss. hv = mix64(key).
    inline uint32_t find(uint64_t k, uint64_t hv, uint32_t* start) const {
        uint64_t h = hv & mask;
        while (true) {
            uint64_t kk = keys[h];
            if (kk == k) {
                uint64_t s = slot[h];
                *start = (uint32_t)(s >> 24);
                return (uint32_t)(s & 0xFFFFFF);
            }
            if (kk == EMPTY) return 0;
            h = (h + 1) & mask;
        }
    }
};

}  // namespace

extern "C" {

// Returns number of candidates written (clipped at out_cap; if the return
// value equals out_cap the caller should retry with a larger buffer).
int64_t realign_probe(
    const uint8_t* ref_flat,      // contig consensus codes, flat
    const int64_t* ref_ptr,       // [n_contigs + 1]
    int64_t n_contigs,
    const uint8_t* sg_codes,      // [n_sg, L] singleton codes (N substituted)
    int64_t n_sg, int64_t L,
    const int32_t* dict_start,    // [n_dicts] window starts
    int32_t seg_len,              // bases per dictionary key (<= 31)
    int32_t n_dicts,
    int32_t thr, int32_t max_search, int32_t rc_skip_cost,  // thr <= 24
    int32_t* out_sg, int32_t* out_contig, int32_t* out_off,
    int8_t* out_dir, int32_t* out_pop, int64_t out_cap) {

    const int64_t W = (L + 31) / 32;
    const uint64_t top_mask =
        (L & 31) ? ((1ULL << (2 * (L & 31))) - 1) : ~0ULL;
    if (n_dicts > 31 || n_sg >= (int64_t)(1u << kPayDictShift))
        return -1;  // config caps at L/11 <= 23 dicts (readlen <= 256)

    // pack singleton reads once, both orientations: the rc-strand popcount
    // compares the forward contig window against rc(read) — same bit count
    // as rc(window) vs read (complement is XOR 3, reversal a permutation)
    std::vector<uint64_t> sg_words((size_t)n_sg * W);
    std::vector<uint64_t> sg_rc_words((size_t)n_sg * W);
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<uint8_t> rcbuf(L);
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
        for (int64_t i = 0; i < n_sg; ++i) {
            const uint8_t* rd = sg_codes + (size_t)i * L;
            pack_words(rd, L, sg_words.data() + i * W);
            for (int64_t j = 0; j < L; ++j) rcbuf[j] = 3 - rd[L - 1 - j];
            pack_words(rcbuf.data(), L, sg_rc_words.data() + i * W);
        }
    }

    double t0 = now_s();
    // combined sorted table over ALL (dict, singleton) segment keys
    const size_t NE = (size_t)n_sg * n_dicts;
    std::vector<Entry> tab(NE);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int32_t d = 0; d < n_dicts; ++d)
        for (int64_t i = 0; i < n_sg; ++i)
            tab[(size_t)d * n_sg + i] = {
                pack_window(sg_codes + i * L + dict_start[d], seg_len),
                ((uint32_t)d << kPayDictShift) | (uint32_t)i};
    auto cmp = [](const Entry& a, const Entry& b) {
        return a.k != b.k ? a.k < b.k : a.p < b.p;
    };
#ifdef MTC_PARALLEL_SORT
    __gnu_parallel::sort(tab.begin(), tab.end(), cmp);
#else
    std::sort(tab.begin(), tab.end(), cmp);
#endif
    double t1 = now_s();
    KeyMap map;
    map.build_runs(tab.data(), NE);
    double t2 = now_s();

    const int64_t cost_budget = (int64_t)(0.4 * L);
    const uint64_t seg_mask = (seg_len < 32)
        ? ((1ULL << (2 * seg_len)) - 1) : ~0ULL;

    // Verified candidates are reduced IN the scan to the best placement per
    // singleton under the claim order (pop, contig, offset, dir) — the exact
    // min the Python claim lexsort would compute over the full candidate
    // list (pipeline/realign.py). The output is bounded by n_sg (no
    // grow-and-rescan retries) and the 7-13M-row claim sorts disappear.
    // One winner slot a singleton, shared by every thread: the placement
    // packs into one 64-bit key whose unsigned order IS the claim order —
    // pop (at most 2 L = 512) above the window's flat position
    // ref_ptr[c] + off (increasing in c, then in off, since off + L <=
    // clen) above dir — and a compare-and-swap keeps the least key. A
    // minimum of a total order does not depend on the thread count or the
    // schedule, so the winners do not either (ties are byte-identical
    // duplicate placements via different dicts).
    constexpr int kPosBits = 53;
    if (ref_ptr[n_contigs] - ref_ptr[0] >= (1LL << kPosBits)) return -1;
    const uint64_t kNone = ~0ULL;   // above every key: pop < 2^10 - 1
    std::vector<uint64_t> best_key((size_t)n_sg, kNone);
    auto claim = [](uint64_t* slot, uint64_t key) {
        uint64_t cur = __atomic_load_n(slot, __ATOMIC_RELAXED);
        while (key < cur &&
               !__atomic_compare_exchange_n(slot, &cur, key, true,
                                            __ATOMIC_RELAXED,
                                            __ATOMIC_RELAXED)) {
        }
    };

#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<uint8_t> rc_read(L);
        std::vector<uint64_t> cw;   // packed contig + guard word
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
        for (int64_t c = 0; c < n_contigs; ++c) {
            const uint8_t* ref = ref_flat + ref_ptr[c];
            int64_t clen = ref_ptr[c + 1] - ref_ptr[c];
            if (clen < L) continue;
            int64_t WC = (clen + 31) / 32;
            if ((int64_t)cw.size() < WC + 1) cw.resize(WC + 1);
            pack_words(ref, clen, cw.data());
            cw[WC] = 0;

            // rolling segment keys at position p: kf = bases p..p+seg-1,
            // kr = their reverse complement
            uint64_t kf = 0, kr = 0;
            for (int64_t j = 0; j < seg_len; ++j) {
                kf |= (uint64_t)ref[j] << (2 * j);
                kr |= (uint64_t)(3 - ref[seg_len - 1 - j]) << (2 * j);
            }
            for (int64_t p = 0; p + seg_len <= clen; ++p) {
                if (p) {
                    uint64_t nb = ref[p + seg_len - 1];
                    kf = (kf >> 2) | (nb << (2 * (seg_len - 1)));
                    kr = ((kr << 2) | (nb ^ 3ULL)) & seg_mask;
                }
                uint64_t hf = mix64(kf), hr = mix64(kr);
                __builtin_prefetch(&map.bloom[map.bloom_word_idx(hf)]);
                __builtin_prefetch(&map.bloom[map.bloom_word_idx(hr)]);
                for (int strand = 0; strand < 2; ++strand) {
                    uint64_t key = strand ? kr : kf;
                    uint64_t hv = strand ? hr : hf;
                    if (!map.bloom_pass(hv)) continue;
                    uint32_t start, cnt;
                    cnt = map.find(key, hv, &start);
                    if (!cnt) continue;
                    // entries sorted by (dict, sg) within the run: per dict
                    // group, derive the unique window offset jj this key
                    // corresponds to, cap hits at max_search in sg order
                    uint32_t r = 0;
                    while (r < cnt) {
                        uint32_t d = tab[start + r].p >> kPayDictShift;
                        // group end by binary search on the payload prefix
                        uint32_t ge = (uint32_t)(std::upper_bound(
                            tab.data() + start + r, tab.data() + start + cnt,
                            Entry{0, ((d + 1) << kPayDictShift) - 1},
                            [](const Entry& a, const Entry& b) {
                                return a.p < b.p;
                            }) - (tab.data() + start));
                        int64_t jj = strand == 0
                            ? p - dict_start[d]
                            : p + dict_start[d] + seg_len - L;
                        if (jj >= 0 && jj + L <= clen) {
                            uint32_t take = ge - r;
                            if ((int32_t)take > max_search)
                                take = max_search;
                            const uint64_t* sgw_base = strand
                                ? sg_rc_words.data() : sg_words.data();
                            for (uint32_t t = 0; t < take; ++t) {
                                uint32_t sgi =
                                    tab[start + r + t].p & kPaySgMask;
                                // window popcount at offset jj via shifts
                                const uint64_t* sgw =
                                    sgw_base + (size_t)sgi * W;
                                int pop = 0;
                                for (int64_t w = 0; w < W; ++w) {
                                    int64_t off = jj + 32 * w;
                                    int sh = 2 * (off & 31);
                                    uint64_t v = cw[off >> 5] >> sh;
                                    if (sh) v |= cw[(off >> 5) + 1]
                                                 << (64 - sh);
                                    if (w == W - 1) v &= top_mask;
                                    pop += __builtin_popcountll(v ^ sgw[w]);
                                }
                                if (pop > thr) continue;
                                // cost rule compares the ORIENTED READ
                                // against the window (encode_byte): fwd ->
                                // read vs window; rc -> rc(read) vs window
                                // (only when the threshold exceeds 24)
                                const uint8_t* win = ref + jj;
                                if (strand == 0) {
                                    if (!encode_cost_ok(
                                            win,
                                            sg_codes + (size_t)sgi * L,
                                            L, cost_budget))
                                        continue;
                                } else if (!rc_skip_cost) {
                                    const uint8_t* rd =
                                        sg_codes + (size_t)sgi * L;
                                    for (int64_t i2 = 0; i2 < L; ++i2)
                                        rc_read[i2] = 3 - rd[L - 1 - i2];
                                    if (!encode_cost_ok(win, rc_read.data(),
                                                        L, cost_budget))
                                        continue;
                                }
                                claim(best_key.data() + sgi,
                                      ((uint64_t)pop << (kPosBits + 1)) |
                                      ((uint64_t)(ref_ptr[c] - ref_ptr[0] +
                                                  jj) << 1) |
                                      (uint64_t)strand);
                            }
                        }
                        r = ge;
                    }
                }
            }
        }
    }

    // emit winners in singleton order; a window's contig is the last
    // whose start lies at or before the window's flat position
    int64_t n_out = 0;
    for (int64_t i = 0; i < n_sg; ++i) {
        const uint64_t key = best_key[i];
        if (key == kNone) continue;
        if (n_out >= out_cap) return -1;   // cannot happen: cap >= n_sg
        const int64_t at =
            ref_ptr[0] + (int64_t)((key >> 1) & ((1ULL << kPosBits) - 1));
        const int64_t c =
            (int64_t)(std::upper_bound(ref_ptr, ref_ptr + n_contigs + 1, at) -
                      ref_ptr) - 1;
        out_sg[n_out] = (int32_t)i;
        out_contig[n_out] = (int32_t)c;
        out_off[n_out] = (int32_t)(at - ref_ptr[c]);
        out_dir[n_out] = (int8_t)(key & 1);
        out_pop[n_out] = (int32_t)(key >> (kPosBits + 1));
        ++n_out;
    }
    if (probe_debug())
        fprintf(stderr,
                "[realign_probe] n_sg=%lld n_contigs=%lld thr=%d "
                "build=%.2fs map=%.2fs scan=%.2fs winners=%lld\n",
                (long long)n_sg, (long long)n_contigs, thr,
                t1 - t0, t2 - t1, now_s() - t2, (long long)n_out);
    return n_out;
}

}  // extern "C"


// match_pro overlap scoring for the merge stage (kthread_cb.c:36-52):
// mismatches of contig b shifted by d into contig a's coordinates over the
// full overlap, early-exited at cap+1.
extern "C" void score_overlaps(const uint8_t* ref_flat, const int64_t* ref_ptr,
                    const int64_t* a, const int64_t* b, const int64_t* d,
                    int64_t n, int32_t cap, int32_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        int64_t la = ref_ptr[a[i] + 1] - ref_ptr[a[i]];
        int64_t lb = ref_ptr[b[i] + 1] - ref_ptr[b[i]];
        int64_t lo = d[i] > 0 ? d[i] : 0;
        int64_t hi = la < d[i] + lb ? la : d[i] + lb;
        if (hi <= lo) { out[i] = cap + 1; continue; }
        const uint8_t* pa = ref_flat + ref_ptr[a[i]] + lo;
        const uint8_t* pb = ref_flat + ref_ptr[b[i]] + lo - d[i];
        int32_t s = 0;
        int64_t len = hi - lo;
        for (int64_t j = 0; j < len; ++j) {
            s += pa[j] != pb[j];
            if (s > cap) { s = cap + 1; break; }
        }
        out[i] = s;
    }
}

extern "C" void set_num_threads(int n) {
#ifdef _OPENMP
    if (n > 0) omp_set_num_threads(n);
#endif
    (void)n;
}
