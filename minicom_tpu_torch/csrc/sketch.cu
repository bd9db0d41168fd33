// Minimizer sketch kernels for Hopper (sm_90a), bound with ctypes from
// minicom_tpu_torch/ops/sketch.py. Plain C interface: every entry point takes
// device pointers and a cudaStream_t, launches on that stream, allocates
// nothing, and returns cudaGetLastError().
//
// Shared rules (identical to minicom_tpu/native/sketch.cpp and to the JAX
// device code): k-mers are 2-bit codes, forward = first base most
// significant, reverse complement = complemented bases, first base least
// significant; canonical = the smaller, strand = 1 iff forward >= rc;
// palindromes (forward == rc, even k only) are invalid; the rank is the
// 32-bit mix32 of (hi, lo) of the canonical 64-bit k-mer, and 0xFFFFFFFF is
// the invalid sentinel (a valid k-mer that hashes to it is never chosen).
//
// mtc_sketch_reads replaces minicom_tpu/ops/sketch.py::_sketch_dyn_body
// (through sketch_reads_dyn_gather_packed): the whole-read canonical
// minimizer of rows gathered by rid, first minimum wins, [3, n] u32 out =
// (hi, lo, end_pos << 1 | strand); a read with no valid k-mer gets zeros.
// The JAX program builds every k-mer with k_max shifted ORs over the whole
// [N, L] matrix plus a roll. Here a warp takes 32 reads at a time (L <=
// 256):
//  - it stages their rows in shared memory, 2 bits a base: the lanes of a
//    row load its 16-byte aligned chunks (coalesced; a few rows a load
//    instruction), each packs its chunk into one word, and a funnel shift
//    with the next lane's word takes out the row's offset in its chunk; the
//    row stride in words is odd, so 32 lanes reading one word of 32 rows
//    hit 32 banks;
//  - a lane extracts its first k-mer whole from the packed words; after
//    that the forward k-mer is read off three words in registers by funnel
//    shifts (no chain from step to step) and the reverse complement rolls,
//    its new base rotated into place, one shared-memory load a 16 bases;
//    for k >= 17 every shift is a 32-bit one; palindromes are tested in the
//    even-k loop only; the loop carries the best (rank, start), and the
//    winner's k-mer and strand are rebuilt once;
//  - a call too small to fill the card (the entry point decides from its
//    reads and the SM count) gives a read 2 or 4 lanes, each ranking a strip
//    of its starts, combined by shuffles, the first start winning ties;
//  - the grid is what the card holds at once: each warp walks its groups of
//    reads and has L2 prefetch the next group's rows while it ranks this
//    one, so loads and ranking overlap instead of alternating in waves.
// Bound: the ranks' operations on the integer pipe (21 a k-mer start at odd
// k, 24 at even; mix32's 4 multiplies issue to the FMA pipe beside it); the
// rows are read once, coalesced; no intermediate touches device memory.
//
// mtc_sketch_windowed replaces minicom_tpu/ops/pallas_sketch.py::_sketch_kernel
// (through sketch_windowed_pallas_compact32) and folds in the row gather of
// ops/sketch.py::gather_contig_rows: rows are read straight from the flat
// contig stream at (start, len), so no padded [rows, Lmax] matrix exists.
// Position i (k-mer start, valid when i + k <= len) is emitted iff its rank
// equals the minimum of some window [j, j + we) covering it (j >= 0, windows
// clipped at the row's valid end, we = min(w, starts of the row); a window
// with no valid k-mer contributes nothing), and the first mb emissions in
// position order are kept as key32 = rank, meta = end_pos << 1 | strand,
// with nv = min(emissions, mb). Every row has its own mb.
//
// One launch sketches every row of a call. The host groups the rows into
// tiles, one block each: up to four consecutive rows with at most kShort
// k-mer starts (a warp each, one chunk, only __syncwarp), or one longer row
// (the whole block, chunks of kChunk starts, stopping at the first chunk
// that fills mb). A chunk, for the warp or the block:
//  - packs its bases 16 to a word in shared memory; each thread takes a
//    strip of consecutive starts, extracts the strip's first k-mer from
//    three words (the reverse complement by reversing its 2-bit groups) and
//    rolls both across the strip: O(1) per start, not k;
//  - window minima and the covering maximum by van Herk / Gil-Werman:
//    prefix and suffix scans over segments of we ranks (one thread a
//    segment and direction), then one min (max) of two entries a position:
//    O(1) per position, not we;
//  - emission slots from __ballot_sync + __popc, one exchange of the warps'
//    counts per chunk in a block.
// The TPU kernel works on a whole padded row block in VMEM with lane rolls,
// int32 sign-flip ordering, a Hillis-Steele prefix sum and masked-sum slot
// selection; none of that carries over.
//
// Layouts. Dense (status == nullptr): row r's entries go to stage + soff[r],
// and nv[r] is written; that is the [rows, mb] form. Compacted (status
// given, zeroed, one word per tile and the ticket): blocks take tiles in
// launch order from a ticket, and each publishes its rows' count and finds
// the entries before it by decoupled look-back (Merrill and Garland), so the
// kept entries of every row land in row order in out, as (key, meta) pairs,
// in the same pass. Bound: the integer operations of the k-mer ranks (about
// 40 a start); the row's bases are read about once, and a row that fills mb
// early stops there.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr uint32_t kU32Max = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t mix32(uint32_t hi, uint32_t lo) {
    uint32_t h = (hi * 0x9E3779B1u) ^ (lo * 0x85EBCA77u);
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

constexpr int kThreads = 128;  // threads per block of the contig sketch
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;    // k-mer starts per chunk of a row in a block
constexpr int kShort = 128;    // rows of at most this many starts: a warp each
constexpr int kEmitRounds = 4;  // ballots a warp takes per chunk
static_assert(kChunk / kWarps == 32 * kEmitRounds, "block chunk layout");
static_assert(kShort == 32 * kEmitRounds, "warp chunk layout");
constexpr unsigned long long kAggregate = 1ULL << 62;  // look-back flags
constexpr unsigned long long kInclusive = 1ULL << 63;
constexpr unsigned long long kCountMask = kAggregate - 1;

// Shared memory of one chunk of up to `cap` ranks (with halos): ranks, the
// two scans, the window minima, the packed bases and the strand bytes, in
// 4-byte words (a multiple of 4, so every region starts 16-byte aligned).
__host__ __device__ inline int region_words(int cap) {
    const int w = 4 * cap + cap / 16 + 6 + (cap + 3) / 4;
    return (w + 3) & ~3;
}

struct Region {
    uint32_t* h;    // ranks of h index u = position - ub
    uint32_t* pre;  // segment prefix scans
    uint32_t* suf;  // segment suffix scans
    uint32_t* win;  // window minima, 0 for none
    uint32_t* pk;   // bases from the chunk's first start, 16 to a word
    uint8_t* z;     // strands
    __device__ Region(uint32_t* base, int cap)
        : h(base), pre(base + cap), suf(base + 2 * cap), win(base + 3 * cap),
          pk(base + 4 * cap),
          z(reinterpret_cast<uint8_t*>(base + 4 * cap + cap / 16 + 6)) {}
};

template <int G>
__device__ __forceinline__ void group_sync() {
    if (G == 32) {
        __syncwarp();
    } else {
        __syncthreads();
    }
}

// 16 bases from base offset b, the first in the top two bits.
__device__ __forceinline__ uint32_t bases16(const uint32_t* pk, int b) {
    return __funnelshift_l(pk[(b >> 4) + 1], pk[b >> 4], 2 * (b & 15));
}

// The forward k-mer whose first base is at base offset b (2k low bits).
__device__ __forceinline__ uint64_t kmer_at(const uint32_t* pk, int b, int k) {
    const int q = b >> 4, s = 2 * (b & 15);
    const uint32_t hi = __funnelshift_l(pk[q + 1], pk[q], s);
    const uint32_t lo = __funnelshift_l(pk[q + 2], pk[q + 1], s);
    return (((uint64_t)hi << 32) | lo) >> (64 - 2 * k);
}

// Reverse complement of a k-mer: complement, reverse the 32 2-bit groups,
// drop the 32 - k groups that came from above the k-mer.
__device__ __forceinline__ uint64_t revcomp(uint64_t x, int k) {
    x = __brevll(~x);
    x = ((x >> 1) & 0x5555555555555555ULL) | ((x & 0x5555555555555555ULL) << 1);
    return x >> (64 - 2 * k);
}

// ---- the read minimizer ------------------------------------------------

// Threads a block: the most (a call of one lane a read), and for a call
// of 2 or 4 lanes a read, which has few reads, so that its blocks spread
// over more SMs.
constexpr int kReadThreads = 512;
constexpr int kSmallThreads = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kLoadsInFlight = 4;  // chunks a lane loads before packing
// Reads an SM for one lane a read: a call with fewer reads than this for
// every SM takes two lanes a read, one with fewer than half of it four.
constexpr int64_t kFillReads = 256;

// Words a staged row takes: its 16-base words, made odd, so that 32 lanes
// reading word q of 32 rows hit 32 banks.
__host__ __device__ inline int read_stride(int64_t L) {
    return (int)((L + 15) >> 4) | 1;
}

// Words of a warp's region: a word before the first row (read, masked
// off, by the first k-mers' high words), 32 rows and the two words that
// kmer_at reads past the end of the last row.
__host__ __device__ inline int read_region(int stride) {
    return 1 + 32 * stride + 2;
}

// Lanes that stage one row: the 16-byte chunks a row of L bases can touch
// from a 16-byte aligned address, as a power of two (at most 32 for
// L <= 256).
__host__ __device__ inline int chunk_lanes(int64_t L) {
    const int c = (int)((L + 30) >> 4);
    int g = 1;
    while (g < c) g <<= 1;
    return g;
}

// The 16 codes (0..3) of a 16-byte chunk, 2 bits each, the first byte's in
// the top bits: one multiply gathers the four of a word into its top byte,
// and byte permutes join the four.
__device__ __forceinline__ uint32_t pack16(uint4 v) {
    const uint32_t m = 0x03030303u, f = 0x40100401u;
    const uint32_t lo = __byte_perm((v.w & m) * f, (v.z & m) * f, 0x0073);
    const uint32_t hi = __byte_perm((v.y & m) * f, (v.x & m) * f, 0x0073);
    return __byte_perm(lo, hi, 0x5410);
}

// Copies rows 0..R-1 of the warp (reads first + r, up to n) into its region,
// 16 bases a word, first base in the top bits. A row takes G lanes
// (chunk_lanes): lane c of the row loads the row's c-th 16-byte aligned
// chunk and packs it into one word, and row word c is that word joined to
// the next lane's by a funnel shift (the row's offset in its first chunk),
// so a load instruction stages 32 / G rows. kLoadsInFlight loads a lane
// are issued before any of them is packed.
__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ codes,
                                           int64_t L,
                                           const int32_t* __restrict__ rids,
                                           int64_t first, int64_t n, int R,
                                           int stride, uint32_t* region) {
    const int lane = threadIdx.x & 31;
    const int G = chunk_lanes(L), per = 32 / G;
    const int sub = lane / G, c = lane % G;
    const int nw = (int)((L + 15) >> 4);
    for (int r0 = 0; r0 < R; r0 += kLoadsInFlight * per) {
        uint4 v[kLoadsInFlight];
        int sh[kLoadsInFlight];
#pragma unroll
        for (int u = 0; u < kLoadsInFlight; ++u) {
            const int r = r0 + u * per + sub;
            v[u] = make_uint4(0u, 0u, 0u, 0u);
            sh[u] = 0;
            if (r < R && first + r < n) {
                const uintptr_t a =
                    (uintptr_t)(codes + (int64_t)rids[first + r] * L);
                sh[u] = (int)(a & 15);
                // a chunk that holds at least one base of the row: within
                // the store's allocation (aligned to 256 bytes or more)
                if (16 * c < sh[u] + L) {
                    v[u] = __ldg(reinterpret_cast<const uint4*>(
                                     a & ~(uintptr_t)15) + c);
                }
            }
        }
#pragma unroll
        for (int u = 0; u < kLoadsInFlight; ++u) {
            const int r = r0 + u * per + sub;
            const uint32_t p = pack16(v[u]);
            const uint32_t next = __shfl_down_sync(kFull, p, 1);
            if (r < R && c < nw) {
                region[r * stride + c] = __funnelshift_l(next, p, 2 * sh[u]);
            }
        }
    }
    __syncwarp();
}

// The rank of a k-mer given forward and reverse complement as (hi, lo)
// words: mix32 of the smaller; kU32Max for a palindrome (even k only).
template <bool kBig, bool kEven>
__device__ __forceinline__ uint32_t rank_of(uint32_t fh, uint32_t fl,
                                            uint32_t rh, uint32_t rl) {
    uint32_t h;
    if (kBig) {
        const uint64_t f = ((uint64_t)fh << 32) | fl;
        const uint64_t r = ((uint64_t)rh << 32) | rl;
        const bool lt = f < r;
        h = mix32(lt ? fh : rh, lt ? fl : rl);
        if (kEven && f == r) h = kU32Max;
    } else {
        h = mix32(0u, min(fl, rl));
        if (kEven && fl == rl) h = kU32Max;
    }
    return h;
}

// (rank << 32 | start) of the first minimum-rank k-mer among those ending
// at bases lo..hi of a staged row (pk[-1] must be readable). The k-mer
// ending at lo is ranked whole from the packed words when it is the row's
// first (lo = k - 1); otherwise the one ending at lo - 1 seeds the roll
// unranked. After that, the k-mer ending at base e = E + u (E a multiple of
// 16) is read off three words in registers, W2, W1, W0 = the bases from
// E - 32, E - 16 and E: its low word is funnelshift(W0, W1, 2u + 2), its
// high word (kBig, k >= 17) the same of (W1, W2) under a mask, so the
// forward k-mer carries no chain; the reverse complement rolls, its new
// base rotated from ~W0 into place. Whole blocks of 16 ends are unrolled,
// with compile-time shifts; the first and last are rolled.
template <bool kBig, bool kEven>
__device__ __forceinline__ uint64_t strip_min(const uint32_t* pk, int lo,
                                              int hi, int k) {
    const int e0 = lo == k - 1 ? lo : lo - 1;  // the seed's end
    const uint64_t f = kmer_at(pk, e0 - k + 1, k);
    const uint64_t rc = revcomp(f, k);
    uint32_t rh = (uint32_t)(rc >> 32), rl = (uint32_t)rc;
    uint32_t best = e0 == lo ? rank_of<kBig, kEven>((uint32_t)(f >> 32),
                                                    (uint32_t)f, rh, rl)
                             : kU32Max;
    int bpos = 0;
    const int rs = kBig ? 2 * k - 34 : 2 * k - 2;
    const uint32_t m3 = 3u << rs;
    const uint32_t mask = kBig ? (1u << (2 * k - 32)) - 1u
                               : 0xFFFFFFFFu >> (32 - 2 * k);
    // ends e0 + 1 .. hi are rolled; start = e - k + 1
    int E = (e0 + 1) & ~15;
    uint32_t W2 = kBig ? pk[(E >> 4) - 2] : 0u, W1 = pk[(E >> 4) - 1];
    auto step = [&](uint32_t W0, uint32_t cwr, int u) {
        // u = 15 takes the whole low word (a funnel shift wraps at 32)
        const int sh = 2 * u + 2;
        const uint32_t fl = (u == 15 ? W0 : __funnelshift_l(W0, W1, sh))
                            & (kBig ? 0xFFFFFFFFu : mask);
        const uint32_t fh =
            kBig ? (u == 15 ? W1 : __funnelshift_l(W1, W2, sh)) & mask : 0u;
        const uint32_t c = __funnelshift_l(cwr, cwr, 2 * u) & m3;
        if (kBig) {
            rl = __funnelshift_r(rl, rh, 2);
            rh = (rh >> 2) | c;
        } else {
            rl = (rl >> 2) | c;
        }
        const uint32_t h = rank_of<kBig, kEven>(fh, fl, rh, rl);
        if (h < best) {
            best = h;
            bpos = E + u - k + 1;
        }
    };
    for (; E <= hi; E += 16) {
        const uint32_t W0 = pk[E >> 4];
        const uint32_t cw = ~W0;
        const uint32_t cwr = __funnelshift_l(cw, cw, rs + 2);
        if (E > e0 && E + 15 <= hi) {
#pragma unroll
            for (int u = 0; u < 16; ++u) step(W0, cwr, u);
        } else {  // a strip's first or last block: rolled, shifts at run time
            const int ub = min(hi - E, 15);
#pragma unroll 1
            for (int u = max(e0 + 1 - E, 0); u <= ub; ++u) step(W0, cwr, u);
        }
        W2 = W1;
        W1 = W0;
    }
    return ((uint64_t)best << 32) | (uint32_t)bpos;
}

// Asks L2 for the cache lines of a row (no registers held, nothing waits).
__device__ __forceinline__ void prefetch_row(const uint8_t* row, int64_t L) {
    const uintptr_t end = (uintptr_t)row + L;
    for (uintptr_t p = (uintptr_t)row & ~(uintptr_t)127; p < end; p += 128) {
        asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
    }
}

// The first end base of lane t's strip of a read: the ends k - 1 .. L - 1
// cut near t / g of the way, at a multiple of 16, so that every strip but
// the first rolls whole blocks of 16 ends from its start.
__device__ __forceinline__ int strip_cut(int t, int g, int S, int k, int L) {
    if (t == 0) return k - 1;
    if (t == g) return L;
    return min(max((k - 1 + t * S / g + 8) & ~15, k), L);
}

// A warp takes groups of 32 >> lg reads, 1 << lg lanes a read: lane t of a
// read ranks the k-mers of its strip of end bases (strip_cut), and the
// lanes of a read keep the least (rank, start) by shuffles, so the first
// start wins on ties. The winner's k-mer and strand are rebuilt once, from
// the staged row. The grid is what the card holds at once, and each warp
// walks its groups: while it ranks one group, L2 fetches the rows of its
// next, so the warps' loads and their ranking overlap instead of
// alternating in waves.
__global__ void __launch_bounds__(kReadThreads)
sketch_reads_kernel(const uint8_t* __restrict__ codes, int64_t L,
                    const int32_t* __restrict__ rids, int64_t n, int k,
                    int lg, uint32_t* __restrict__ out) {
    extern __shared__ uint32_t smem_reads[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = 1 << lg, R = 32 >> lg;
    const int stride = read_stride(L);
    uint32_t* region = smem_reads + warp * read_region(stride) + 1;
    const int r = lane >> lg, t = lane & (g - 1);
    const int S = (int)L - k + 1;  // k-mer starts of a read
    const int lo = strip_cut(t, g, S, k, (int)L);
    const int hi = strip_cut(t + 1, g, S, k, (int)L) - 1;
    const uint32_t* pk = region + r * stride;
    const int warps = blockDim.x >> 5;
    const int64_t hop = (int64_t)gridDim.x * warps * R;  // reads
    for (int64_t first = ((int64_t)blockIdx.x * warps + warp) * R;
         first < n; first += hop) {
        // the rid of this lane's row in the warp's next group, loaded now
        // and prefetched once this group is staged
        const int64_t nx = first + hop + lane;
        const int32_t next_rid = lane < R && nx < n ? rids[nx] : -1;
        __syncwarp();  // the last group's rows are read
        stage_rows(codes, L, rids, first, n, R, stride, region);
        if (next_rid >= 0) prefetch_row(codes + (int64_t)next_rid * L, L);

        const int64_t i = first + r;
        uint64_t key = ~0ULL;
        if (i < n && S > 0 && lo <= hi) {
            if (k >= 17) {
                key = (k & 1) ? strip_min<true, false>(pk, lo, hi, k)
                              : strip_min<true, true>(pk, lo, hi, k);
            } else {
                key = (k & 1) ? strip_min<false, false>(pk, lo, hi, k)
                              : strip_min<false, true>(pk, lo, hi, k);
            }
        }
        for (int d = 1; d < g; d <<= 1) {
            key = min(key, (uint64_t)__shfl_xor_sync(kFull, key, d));
        }
        if (i < n && t == 0) {
            uint32_t khi = 0, klo = 0, meta = 0;
            if ((uint32_t)(key >> 32) != kU32Max) {
                const int sp = (int)(uint32_t)key;
                const uint64_t f = kmer_at(pk, sp, k);
                const uint64_t rc = revcomp(f, k);
                const uint32_t z = f > rc;
                const uint64_t canon = z ? rc : f;
                khi = (uint32_t)(canon >> 32);
                klo = (uint32_t)canon;
                meta = ((uint32_t)(sp + k - 1) << 1) | z;
            }
            out[i] = khi;
            out[n + i] = klo;
            out[2 * n + i] = meta;
        }
    }
}

// pre[i] / suf[i]: the min (kMax: max) of x over i's segment of `seg`
// entries (segments start at 0) up to i / from i on. One thread walks one
// segment in one direction.
template <int G, bool kMax>
__device__ __forceinline__ void scan_segments(const uint32_t* __restrict__ x,
                                              uint32_t* __restrict__ pre,
                                              uint32_t* __restrict__ suf,
                                              int n, int seg, int t) {
    const int nseg = (n + seg - 1) / seg;
    for (int task = t; task < 2 * nseg; task += G) {
        const bool up = task < nseg;
        const int a = (up ? task : task - nseg) * seg;
        const int len = min(seg, n - a);
        const int step = up ? 1 : -1;
        uint32_t* out = up ? pre : suf;
        uint32_t m = kMax ? 0u : kU32Max;
        int i = up ? a : a + len - 1, d = 0;
        for (; d + 4 <= len; d += 4, i += 4 * step) {  // four loads in flight
            uint32_t v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = x[i + e * step];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                m = kMax ? max(m, v[e]) : min(m, v[e]);
                out[i + e * step] = m;
            }
        }
        for (; d < len; ++d, i += step) {
            m = kMax ? max(m, x[i]) : min(m, x[i]);
            out[i] = m;
        }
    }
}

// Sketches one row with a group of G threads (a warp, or the block) on its
// shared-memory region; writes the first mb emissions to key / meta and
// returns nv. Every thread of the group must call it.
template <int G>
__device__ int sketch_row(const uint8_t* __restrict__ seq, int64_t len, int k,
                          int w, int mb, uint32_t* __restrict__ key,
                          int32_t* __restrict__ meta, Region r, int* s_cnt) {
    constexpr int kGroupWarps = G / 32;
    const int t = threadIdx.x % G;
    const int lane = threadIdx.x & 31, warp = t >> 5;
    const int64_t S = len - k + 1;  // k-mer starts of this row
    if (S <= 0) return 0;
    // a window wider than the row covers the same clipped suffix as one of
    // width S
    const int we = (int)min((int64_t)w, S);
    const int cmax = G == 32 ? kShort : kChunk;
    const uint64_t kmask = (1ULL << (2 * k)) - 1;
    const int rc_shift = 2 * (k - 1);
    int count = 0;  // emissions so far; the same in every thread
    for (int64_t p0 = 0; p0 < S && count < mb; p0 += cmax) {
        const int C = (int)min((int64_t)cmax, S - p0);
        const int64_t ub = p0 - (we - 1);  // row position of h index 0
        const int H = C + 2 * (we - 1);    // ranks: C and a halo each side
        const int64_t pa = ub > 0 ? ub : 0;
        const int64_t pb = S < ub + H ? S : ub + H;
        const int nval = (int)(pb - pa);   // valid starts of the chunk
        const int off = (int)(pa - ub);    // h index of start pa
        const int nwords = (nval + k - 1 + 15) / 16 + 2;
        for (int q = t; q < nwords; q += G) {
            const int64_t g0 = pa + 16LL * q;
            uint32_t word = 0;
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                const uint32_t c = g0 + i < len ? (seq[g0 + i] & 3u) : 0u;
                word |= c << (30 - 2 * i);
            }
            r.pk[q] = word;
        }
        group_sync<G>();
        // ranks: a strip of consecutive starts per thread, k-mers rolled
        {
            const int P = (nval + G - 1) / G;
            const int b = t * P, e = min(b + P, nval);
            if (b < e) {
                uint64_t fwd = kmer_at(r.pk, b, k);
                uint64_t rc = revcomp(fwd, k);
                uint32_t next = 0;
                for (int i = b; i < e; ++i) {
                    if (i > b) {
                        const int j = i - b - 1;  // the roll's new base
                        if ((j & 15) == 0) next = bases16(r.pk, b + k + j);
                        const uint64_t c = next >> 30;
                        next <<= 2;
                        fwd = ((fwd << 2) | c) & kmask;
                        rc = (rc >> 2) | ((c ^ 3ULL) << rc_shift);
                    }
                    uint32_t h = kU32Max;
                    uint8_t z = 0;
                    if (fwd != rc) {  // palindromes are invalid
                        z = fwd > rc;
                        const uint64_t canon = z ? rc : fwd;
                        h = mix32((uint32_t)(canon >> 32), (uint32_t)canon);
                    }
                    r.h[off + i] = h;
                    r.z[off + i] = z;
                }
            }
            for (int u = t; u < off; u += G) r.h[u] = kU32Max;
            for (int u = off + nval + t; u < H; u += G) r.h[u] = kU32Max;
        }
        group_sync<G>();
        scan_segments<G, false>(r.h, r.pre, r.suf, H, we, t);
        group_sync<G>();
        // window u starts at row position ub + u and spans h[u, u + we);
        // windows before the row and windows with no valid k-mer give 0
        const int nwin = C + we - 1;
        for (int u = t; u < nwin; u += G) {
            const uint32_t m = min(r.suf[u], r.pre[u + we - 1]);
            r.win[u] = (ub + u < 0 || m == kU32Max) ? 0u : m;
        }
        group_sync<G>();
        scan_segments<G, true>(r.win, r.pre, r.suf, nwin, we, t);
        group_sync<G>();
        // position p0 + v is covered by windows win[v, v + we) and has rank
        // h[v + we - 1]; each warp takes a contiguous span of positions
        const int span = ((C + kGroupWarps - 1) / kGroupWarps + 31) & ~31;
        const int v0 = warp * span;
        uint32_t masks[kEmitRounds];
        int mine = 0;
#pragma unroll
        for (int it = 0; it < kEmitRounds; ++it) {
            const int v = v0 + it * 32 + lane;
            bool emit = false;
            if (it * 32 < span && v < C) {
                const uint32_t h = r.h[v + we - 1];
                emit = h != kU32Max && h == max(r.suf[v], r.pre[v + we - 1]);
            }
            masks[it] = __ballot_sync(0xFFFFFFFFu, emit);
            mine += __popc(masks[it]);
        }
        int before = 0, total = mine;
        if (kGroupWarps > 1) {
            if (lane == 0) s_cnt[warp] = mine;
            __syncthreads();
            total = 0;
            for (int q = 0; q < kGroupWarps; ++q) {
                before += q < warp ? s_cnt[q] : 0;
                total += s_cnt[q];
            }
        }
        int slot = count + before;
#pragma unroll
        for (int it = 0; it < kEmitRounds; ++it) {
            const uint32_t m = masks[it];
            if ((m >> lane) & 1u) {
                const int s = slot + __popc(m & ((1u << lane) - 1u));
                if (s < mb) {
                    const int v = v0 + it * 32 + lane;
                    key[s] = r.h[v + we - 1];
                    meta[s] = (int32_t)(((p0 + v + k - 1) << 1)
                                        | r.z[v + we - 1]);
                }
            }
            slot += __popc(m);
        }
        count += total;
        group_sync<G>();  // the next chunk rewrites the region and s_cnt
    }
    return count < mb ? count : mb;
}

// rows: [R, 4] int64 (start, len, mb, soff); tiles: [T + 1] int64, the
// first row of each tile and then R. A tile whose first row has at most
// short_max starts (short_max > 0) takes a warp per row.
__global__ void __launch_bounds__(kThreads)
sketch_windowed_kernel(const uint8_t* __restrict__ ref,
                       const int64_t* __restrict__ rows,
                       const int64_t* __restrict__ tiles, int k, int w,
                       int short_max, int cap_block, int cap_warp,
                       uint32_t* __restrict__ stage_key,
                       int32_t* __restrict__ stage_meta,
                       int32_t* __restrict__ out, int32_t* __restrict__ nv,
                       unsigned long long* status) {
    extern __shared__ __align__(16) uint32_t smem[];
    __shared__ int s_cnt[kWarps];
    __shared__ int s_nv[kWarps];
    __shared__ long long s_tile, s_base;
    if (threadIdx.x == 0) {
        s_tile = status ? (long long)atomicAdd(&status[gridDim.x], 1ULL)
                        : (long long)blockIdx.x;
    }
    __syncthreads();
    const int64_t tile = s_tile;
    const int64_t r0 = tiles[tile];
    const int nrows = (int)(tiles[tile + 1] - r0);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (short_max > 0 && rows[4 * r0 + 1] - k + 1 <= short_max) {
        int n = 0;
        if (warp < nrows) {
            const int64_t* d = rows + 4 * (r0 + warp);
            n = sketch_row<32>(ref + d[0], d[1], k, w, (int)d[2],
                               stage_key + d[3], stage_meta + d[3],
                               Region(smem + warp * region_words(cap_warp),
                                      cap_warp),
                               s_cnt);
            if (lane == 0) nv[r0 + warp] = n;
        }
        if (lane == 0) s_nv[warp] = n;
    } else {
        const int64_t* d = rows + 4 * r0;
        const int n = sketch_row<kThreads>(ref + d[0], d[1], k, w, (int)d[2],
                                           stage_key + d[3], stage_meta + d[3],
                                           Region(smem, cap_block), s_cnt);
        if (threadIdx.x == 0) nv[r0] = s_nv[0] = n;
    }
    if (status == nullptr) return;
    __syncthreads();
    if (warp == 0) {
        long long agg = 0;
        for (int q = 0; q < nrows; ++q) agg += s_nv[q];
        long long excl = 0;
        if (tile == 0) {
            if (lane == 0) {
                atomicExch(&status[0], kInclusive | (unsigned long long)agg);
            }
        } else {
            if (lane == 0) {
                atomicExch(&status[tile],
                           kAggregate | (unsigned long long)agg);
            }
            // the warp reads 32 predecessors at a time, nearest in lane 0,
            // and stops at the nearest one that holds its inclusive count
            for (int64_t top = tile - 1;; top -= 32) {
                const int64_t p = top - lane;
                unsigned long long v = p >= 0 ? 0ULL : kInclusive;
                do {
                    if (v == 0) {
                        v = *reinterpret_cast<volatile unsigned long long*>(
                            &status[p]);
                    }
                } while (__ballot_sync(0xFFFFFFFFu, v == 0));
                const unsigned incl =
                    __ballot_sync(0xFFFFFFFFu, (v & kInclusive) != 0);
                const int last = incl ? __ffs(incl) - 1 : 31;
                long long c = lane <= last ? (long long)(v & kCountMask) : 0;
                for (int d = 16; d > 0; d >>= 1) {
                    c += __shfl_xor_sync(0xFFFFFFFFu, c, d);
                }
                excl += c;
                if (incl) break;
            }
            if (lane == 0) {
                atomicExch(&status[tile],
                           kInclusive | (unsigned long long)(excl + agg));
            }
        }
        if (lane == 0) s_base = excl;
    }
    __syncthreads();
    // this tile's entries, from their dense slots to their compacted place
    long long base = s_base;
    for (int q = 0; q < nrows; ++q) {
        const int64_t soff = rows[4 * (r0 + q) + 3];
        for (int i = threadIdx.x; i < s_nv[q]; i += kThreads) {
            out[2 * (base + i)] = (int32_t)stage_key[soff + i];
            out[2 * (base + i) + 1] = stage_meta[soff + i];
        }
        base += s_nv[q];
    }
}

// The shared memory of a block, and the rows a warp takes (0: none), for
// windows of up to w starts.
void sketch_layout(int w, int* short_max, size_t* smem, int* cap_block,
                   int* cap_warp) {
    *cap_block = kChunk + 2 * (w - 1);
    *cap_warp = kShort + 2 * (w - 1);
    const size_t block = 4 * (size_t)region_words(*cap_block);
    const size_t warps = 4 * (size_t)kWarps * region_words(*cap_warp);
    const size_t most = 232448;  // an sm_90 block's opt-in maximum
    // four warp regions fit up to w = 1620, one block region up to 6481
    *short_max = warps <= most ? kShort : 0;
    *smem = *short_max ? (block > warps ? block : warps) : block;
}

// The SM count of device dev (threads 0), or the read-minimizer blocks of
// `threads` threads and `smem` bytes that one SM holds; minus a CUDA error.
// Asked once per process and kept: the queries cost more host time than a
// small call's kernel takes.
int card_fill(int dev, int threads, size_t smem) {
    static std::mutex mu;
    static std::map<std::tuple<int, int, size_t>, int> known;
    const std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple(dev, threads, smem);
    const auto it = known.find(key);
    if (it != known.end()) return it->second;
    int v;
    const cudaError_t e =
        threads == 0
            ? cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &v, sketch_reads_kernel, threads, smem);
    if (e != cudaSuccess) return -(int)e;
    known.emplace(key, v);
    return v;
}

}  // namespace

extern "C" {

const char* mtc_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// rids: [n] int32 rows of codes ([N, L] uint8); out: [3, n]. The lanes a
// read follow from n (kFillReads).
int mtc_sketch_reads(const uint8_t* codes, int64_t L, const int32_t* rids,
                     int64_t n, int k, uint32_t* out, void* stream) {
    if (n <= 0) return 0;
    if (k < 1 || k > 31 || L < 1 || L > 256) return (int)cudaErrorInvalidValue;
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const int sms = card_fill(dev, 0, 0);
    if (sms < 0) return -sms;
    const int64_t fill = kFillReads * sms;
    const int lg = n >= fill ? 0 : (2 * n >= fill ? 1 : 2);
    const int threads = lg == 0 ? kReadThreads : kSmallThreads;
    const size_t smem =
        4 * (size_t)(threads / 32) * read_region(read_stride(L));
    const int per_sm = card_fill(dev, threads, smem);
    if (per_sm < 0) return -per_sm;
    const int64_t per_block = (int64_t)(threads / 32) * (32 >> lg);
    const int64_t blocks = min((n + per_block - 1) / per_block,
                               (int64_t)per_sm * sms);
    sketch_reads_kernel<<<(unsigned)blocks, threads, smem,
                          (cudaStream_t)stream>>>(codes, L, rids, n, k, lg,
                                                  out);
    return (int)cudaGetLastError();
}

// out[0]: the most k-mer starts of a row that a warp takes (0: every row
// takes a block); out[1]: rows per tile of warps; for windows of up to w.
void mtc_sketch_layout(int w, int64_t* out) {
    int short_max, cap_block, cap_warp;
    size_t smem;
    sketch_layout(w < 1 ? 1 : w, &short_max, &smem, &cap_block, &cap_warp);
    out[0] = short_max;
    out[1] = kWarps;
}

int mtc_sketch_windowed(const uint8_t* ref, const int64_t* rows,
                        const int64_t* tiles, int64_t n_tiles, int k, int w,
                        uint32_t* stage_key, int32_t* stage_meta, int32_t* out,
                        int32_t* nv, unsigned long long* status,
                        void* stream) {
    if (n_tiles <= 0) return 0;
    if (k < 1 || k > 31 || w < 1 || n_tiles > 0x7FFFFFFF)
        return (int)cudaErrorInvalidValue;
    int short_max, cap_block, cap_warp;
    size_t smem;
    sketch_layout(w, &short_max, &smem, &cap_block, &cap_warp);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            sketch_windowed_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    sketch_windowed_kernel<<<(unsigned)n_tiles, kThreads, smem,
                             (cudaStream_t)stream>>>(
        ref, rows, tiles, k, w, short_max, cap_block, cap_warp, stage_key,
        stage_meta, out, nv, status);
    return (int)cudaGetLastError();
}

}  // extern "C"
