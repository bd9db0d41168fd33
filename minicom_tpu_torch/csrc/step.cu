// The fused cluster step for Hopper (sm_90a), bound with ctypes from
// minicom_tpu_torch/ops/step.py. Plain C interface: device pointers and a
// cudaStream_t in, cudaGetLastError() out, no allocation.
//
// Replaces minicom_tpu/ops/step.py::cluster_step, one whole clustering
// round over an [N, L] batch as one device program: the canonical
// minimizer of every read, a sort on the 62-bit k-mer, segments of equal
// k-mers, members aligned by their mirrored minimizer position, a majority
// vote over a flat column space and each member's mismatch count. The port
// runs it as kernel (c) (csrc/sketch.cu, mtc_sketch_reads), the three
// entries below and one torch.sort between the first and the second:
//
// mtc_step_keys: a thread a read turns (c)'s [3, N] words into the int64
//   key hi << 32 | lo and mz = mpos << 1 | strand (mpos = pos, or L - pos +
//   k - 2 on strand 1). A read with no chosen k-mer ((c) writes zeros: every
//   k-mer a palindrome, or every rank 0xFFFFFFFF) takes the k-mer at start 0,
//   as the JAX argmin over an all-sentinel row does: its key and strand are
//   rebuilt from the read's first k bases. The third word is never 0 for a
//   chosen k-mer except at k = 1, start 0, strand 0, where the rebuild gives
//   the same answer.
//
// mtc_step_segments: the new_seg, cumsum and seg_max lines of the JAX
//   step (minicom_tpu/ops/step.py:50-57). A segment starts where the key
//   changes; both strands of a canonical k-mer share it. seg_id, each
//   segment's first member (at its head) and its max mpos (at its last
//   member) are a scan of (heads, max mpos since the last head), an
//   associative operator; the last item writes first[nseg] = N and nseg
//   into first[N + 1]: the count stays on the card. Bound: bytes, 32 N +
//   8 nseg (skey, order and the gathered mz read once; order32, smz and
//   seg_id written; first and seg_max once a segment). One pass, one kernel
//   after a memset of the status words: a block takes the next tile of
//   kSegTile items from a ticket (so every tile it waits on has started); a
//   warp owns kSegRows rows of 32 consecutive items, one a lane, so each
//   load and store of skey, order, order32, smz and seg_id is one
//   contiguous line a warp, marked streaming (evict first) so that mz (20
//   MB at 5M) stays in L2 for its random gathers. A thread issues its order
//   and key loads, then all its gathers of mz, before it uses any. Heads
//   compare a key with its left neighbour by a shuffle (a key loaded just
//   before and just after each warp's items); a row is scanned by a ballot
//   (heads) and five shuffles (the max, stopped at the lane's segment
//   start), the rows in order, the warps through shared memory. The tile
//   then publishes its reduction and finds its prefix by decoupled
//   look-back (Merrill and Garland 2016): 32 predecessors' status words a
//   step, each a flag and (h, m) in 64 bits, back to the nearest that holds
//   its inclusive prefix; then it publishes its own. Each input is read
//   once. What holds it near 57% of its bound: a tile's life is a chain
//   (ticket, loads, gathers, scan, look-back, stores) with no loads in
//   flight after its gathers; 8 rows and three blocks an SM (72 registers)
//   beat 16 rows and two, 8 rows and four, 512- and 128-thread blocks,
//   128 status words a look-back step, and persistent blocks that prefetch
//   their next tile into L2 (PERF.md).
//
// mtc_step_vote: segment g owns columns [g 2L, g 2L + 2L) (its offsets lie
//   in [0, L - k]). A block takes a tile of G consecutive segment slots, so
//   its members are first[g0] .. first[g1] and its columns are its own: the
//   counts live in shared memory, and no plan comes from the host. As in
//   csrc/consensus.cu, a warp takes a slice of the members, 32 members'
//   metadata at a time, then kU rows at a time, 4 bases a lane (one 4-byte
//   load where L % 4 == 0), oriented in registers, one shared-memory atomic a
//   base; a thread then votes 4 columns (first maximum, ties to the lowest
//   code, an empty column 0) and writes them as one 4-byte and one 16-byte
//   store; then each member's diff against the votes (255 past span_cols).
//   A tile stages its first members and segment maxima in shared memory
//   first, and a warp whose slice is one chunk keeps its members' metadata
//   in registers from the count to the diffs. Slots from nseg on own no
//   member: the columns from the first slot past the last tile on, up to
//   span_cols, are written as zeros kTailCols at a time, work items of a
//   second kind that touch no shared memory (nseg is read on the card, so
//   the host knows neither count). The grid is what the card holds at
//   once (128-thread blocks, 8 an SM); each block takes a tile and a run of
//   zeros in turn, so that its zeros stream out while its next tile waits
//   on its loads. A deep segment (thousands of copies of one read) puts
//   all its members in one block, and their atomics on the same columns
//   serialize: slow, but right.
//   What holds it to about half its bound: a tile is a chain of dependent
//   loads (its first members, its members' metadata, their rows) and four
//   barriers for ~20 members; 64 registers allow 8 blocks an SM. Tiles
//   first and zeros after, 256-thread blocks, 32 registers, and the two
//   kinds alternating by block were each slower (PERF.md).
// Bound of the step: the outputs. consensus (span bytes) and coverage (4
// span bytes) are 5 of the ~5.1 bytes a column the step moves at span = N
// 2L; the rows are read once more by the vote, the metadata a few words a
// read.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kKeyThreads = 256;

__global__ void __launch_bounds__(kKeyThreads)
step_keys_kernel(const uint8_t* __restrict__ codes, int L,
                 const uint32_t* __restrict__ sk, int64_t N, int k,
                 int64_t* __restrict__ key, int32_t* __restrict__ mz) {
    const int64_t i = blockIdx.x * (int64_t)kKeyThreads + threadIdx.x;
    if (i >= N) return;
    const uint32_t meta = sk[2 * N + i];
    uint64_t kmer;
    int pos, strand;
    if (meta != 0) {
        kmer = ((uint64_t)sk[i] << 32) | sk[N + i];
        pos = (int)(meta >> 1);
        strand = (int)(meta & 1u);
    } else {
        const uint8_t* row = codes + i * (int64_t)L;
        uint64_t f = 0, r = 0;
        for (int t = 0; t < k; ++t) {
            const uint64_t c = row[t];
            f = (f << 2) | c;
            r |= (c ^ 3u) << (2 * t);
        }
        strand = f >= r;
        kmer = strand ? r : f;
        pos = k - 1;
    }
    key[i] = (int64_t)kmer;
    mz[i] = (strand ? L - pos + k - 2 : pos) * 2 | strand;
}

// ---- segments

constexpr int kSegThreads = 256;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSegRows = 8;                         // rows of 32 items a warp
constexpr int kSegWarpItems = 32 * kSegRows;
constexpr int kSegTile = kSegThreads * kSegRows;    // items a tile
constexpr unsigned long long kSegAggregate = 1ULL << 62;   // look-back flags
constexpr unsigned long long kSegInclusive = 1ULL << 63;

// (heads, max mpos since the last head); identity (0, -1)
struct Seg {
    int h, m;
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
    return Seg{a.h + b.h, b.h ? b.m : max(a.m, b.m)};
}

// A tile's status word: a flag, h in bits 31-61 and m in bits 0-30 (a
// published Seg covers at least one item and mz >= 0, so 0 <= m < 2^30;
// h <= N < 2^31).
__device__ __forceinline__ unsigned long long seg_word(Seg s,
                                                       unsigned long long f) {
    return f | (unsigned long long)(unsigned)s.h << 31 |
           ((unsigned)s.m & 0x7FFFFFFFu);
}

__device__ __forceinline__ Seg seg_of(unsigned long long w) {
    return Seg{(int)((w >> 31) & 0x7FFFFFFFu), (int)(w & 0x7FFFFFFFu)};
}

// Warp w of a tile owns items w0 .. w0 + kSegWarpItems, lane l item w0 +
// 32 j + l of row j. status: a zeroed word a tile, then the ticket.
__global__ void __launch_bounds__(kSegThreads, 3)
seg_scan_kernel(const int64_t* __restrict__ skey,
                const int64_t* __restrict__ order,
                const int32_t* __restrict__ mz, int64_t N,
                unsigned long long* status, int32_t* __restrict__ order32,
                int32_t* __restrict__ smz, int32_t* __restrict__ seg_id,
                int32_t* __restrict__ first, int32_t* __restrict__ seg_max) {
    const unsigned full = 0xFFFFFFFFu;
    __shared__ Seg s_warp[kSegWarps];
    __shared__ Seg s_before;
    __shared__ int s_tile;
    if (threadIdx.x == 0)
        s_tile = (int)atomicAdd(&status[gridDim.x], 1ULL);
    __syncthreads();
    const int tile = s_tile;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t w0 = (int64_t)tile * kSegTile + warp * kSegWarpItems;

    // every load first: order and the keys, the keys just before and just
    // after the warp's items, then the gathers of mz
    int64_t o[kSegRows], key[kSegRows];
#pragma unroll
    for (int j = 0; j < kSegRows; ++j) {
        const int64_t i = w0 + 32 * j + lane;
        o[j] = i < N ? __ldcs(order + i) : 0;
        key[j] = i < N ? __ldcs(skey + i) : 0;
    }
    int64_t edge = 0;
    if (lane == 0 && w0 > 0 && w0 <= N) edge = __ldg(skey + w0 - 1);
    if (lane == 31 && w0 + kSegWarpItems < N)
        edge = __ldg(skey + w0 + kSegWarpItems);
    int z[kSegRows];
#pragma unroll
    for (int j = 0; j < kSegRows; ++j)
        z[j] = w0 + 32 * j + lane < N ? __ldg(mz + o[j]) : 0;
#pragma unroll
    for (int j = 0; j < kSegRows; ++j) {
        const int64_t i = w0 + 32 * j + lane;
        if (i < N) {
            __stcs(order32 + i, (int32_t)o[j]);
            __stcs(smz + i, z[j]);
        }
    }

    // heads: a row's mask, the same in every lane
    unsigned hm[kSegRows];
    int64_t prev0 = edge;   // lane 0's left neighbour
#pragma unroll
    for (int j = 0; j < kSegRows; ++j) {
        const int64_t i = w0 + 32 * j + lane;
        const int64_t left = __shfl_sync(full, key[j], (lane + 31) & 31);
        const int64_t prev = lane ? left : prev0;
        hm[j] = __ballot_sync(full, i < N && (i == 0 || key[j] != prev));
        prev0 = left;   // in lane 0: row j's last key
    }
    const bool after = w0 + kSegWarpItems >= N ||
                       edge != key[kSegRows - 1];   // read in lane 31

    // each row's segmented scan, then the rows in order: loc[j] is the item's
    // inclusive Seg from the warp's first item
    const unsigned upto = (2u << lane) - 1;
    Seg loc[kSegRows];
    Seg run{0, -1};
#pragma unroll
    for (int j = 0; j < kSegRows; ++j) {
        const unsigned mine = hm[j] & upto;
        const int start = mine ? 31 - __clz(mine) : 0;
        int m = w0 + 32 * j + lane < N ? z[j] >> 1 : -1;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(full, m, d);
            if (lane - d >= start) m = max(m, up);
        }
        loc[j] = combine(run, Seg{__popc(mine), m});
        run = combine(run, Seg{__popc(hm[j]), __shfl_sync(full, m, 31)});
    }
    if (lane == 0) s_warp[warp] = run;
    __syncthreads();

    if (warp == 0) {
        Seg agg{0, -1};
#pragma unroll
        for (int q = 0; q < kSegWarps; ++q) agg = combine(agg, s_warp[q]);
        Seg before{0, -1};
        if (tile == 0) {
            if (lane == 0)
                atomicExch(&status[0], seg_word(agg, kSegInclusive));
        } else {
            if (lane == 0)
                atomicExch(&status[tile], seg_word(agg, kSegAggregate));
            // 32 predecessors a step, nearest in lane 0, to the nearest one
            // that holds its inclusive prefix; their Segs combined in order,
            // lane 31 first
            for (int top = tile - 1;; top -= 32) {
                const int p = top - lane;
                unsigned long long v = p >= 0 ? 0ULL : kSegInclusive;
                do {
                    if (v == 0) {
                        v = *reinterpret_cast<volatile unsigned long long*>(
                            &status[p]);
                    }
                } while (__ballot_sync(full, v == 0));
                const unsigned incl =
                    __ballot_sync(full, (v & kSegInclusive) != 0);
                const int last = incl ? __ffs(incl) - 1 : 31;
                Seg c = lane <= last && p >= 0 ? seg_of(v) : Seg{0, -1};
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    const Seg up{__shfl_down_sync(full, c.h, d),
                                 __shfl_down_sync(full, c.m, d)};
                    if (lane + d < 32) c = combine(up, c);
                }
                before = combine(Seg{__shfl_sync(full, c.h, 0),
                                     __shfl_sync(full, c.m, 0)},
                                 before);
                if (incl) break;
            }
            if (lane == 0) {
                atomicExch(&status[tile],
                           seg_word(combine(before, agg), kSegInclusive));
            }
        }
        if (lane == 0) s_before = before;
    }
    __syncthreads();

    Seg base = s_before;
    for (int q = 0; q < warp; ++q) base = combine(base, s_warp[q]);
#pragma unroll
    for (int j = 0; j < kSegRows; ++j) {
        const int64_t i = w0 + 32 * j + lane;
        if (i >= N) break;
        const Seg s = combine(base, loc[j]);
        const int g = s.h - 1;
        __stcs(seg_id + i, g);
        if ((hm[j] >> lane) & 1) first[g] = (int32_t)i;
        const bool next_head =
            lane < 31 ? (hm[j] >> (lane + 1)) & 1
                      : (j + 1 < kSegRows ? hm[j + 1] & 1 : after);
        if (i + 1 >= N || next_head) seg_max[g] = s.m;
        if (i == N - 1) {
            first[g + 1] = (int32_t)N;
            first[N + 1] = g + 1;
        }
    }
}

// ---- vote

constexpr int kVoteThreads = 128;
constexpr int kVoteWarps = kVoteThreads / 32;
constexpr int kU = 4;           // member rows a lane keeps in flight
constexpr int kPad = 4;         // vote bytes before the tile's first column
constexpr int kTailCols = 4 * 4 * kVoteThreads;   // columns a tail item

// The 4 bytes of row[j0 .. j0 + 4); bytes at or past L read as 0xFF, which
// counts for nothing and is masked out of the diffs.
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int L, int j0,
                                          bool vec4) {
    if (vec4) return *reinterpret_cast<const uint32_t*>(row + j0);
    uint32_t w = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t)
        w |= (uint32_t)(j0 + t < L ? row[j0 + t] : 0xFFu) << (8 * t);
    return w;
}

struct Member {        // one member, as every lane of its warp sees it
    const uint8_t* row;
    int base;          // its first column, relative to the tile's
    bool rev, on;
};

// Adds the lane's 4 bases (row bytes j0 .. j0 + 3) to the tile's counts:
// code c at column base + j, complemented and mirrored on strand 1. Every
// member lies inside its tile.
__device__ __forceinline__ void count4(int* cnt, uint32_t w, const Member& mb,
                                       int j0, int L) {
    const int p0 = mb.rev ? mb.base + L - 1 - j0 : mb.base + j0;
    const int step = mb.rev ? -1 : 1;
    const uint32_t x = mb.rev ? 3u : 0u;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const uint32_t c = (w >> (8 * t)) & 0xFFu;
        if (c < 4) atomicAdd(&cnt[(p0 + step * t) * 4 + (c ^ x)], 1);
    }
}

// The lane's 4 bases against the 4 votes under them, read as one word (two
// aligned words and a funnel shift); on strand 1 the bases byte-reversed and
// complemented; bytes past L do not count.
__device__ __forceinline__ unsigned mismatches4(const uint32_t* vote32,
                                                uint32_t w, const Member& mb,
                                                int j0, int L) {
    const int s = kPad + (mb.rev ? mb.base + L - 4 - j0 : mb.base + j0);
    const uint32_t v = __funnelshift_r(vote32[s >> 2], vote32[(s >> 2) + 1],
                                       (s & 3) * 8);
    const uint32_t c = mb.rev ? __byte_perm(w, 0, 0x0123) ^ 0x03030303u : w;
    uint32_t ne = __vcmpne4(v, c);
    const int valid = L - j0;
    if (valid < 4)
        ne &= mb.rev ? 0xFFFFFFFFu << (8 * (4 - valid))
                     : 0xFFFFFFFFu >> (8 * (4 - valid));
    return __popc(ne) >> 3;
}

// consensus and coverage of columns [lo, hi) set to 0: 4 columns a store
// over the aligned middle (cons 4-byte and cov 16-byte aligned).
__device__ void zero_cols(uint8_t* cons, int32_t* cov, int64_t lo,
                          int64_t hi) {
    const int64_t a = min(hi, (lo + 3) & ~(int64_t)3);
    const int64_t b = max(a, hi & ~(int64_t)3);
    for (int64_t c = lo + threadIdx.x; c < a; c += kVoteThreads)
        cons[c] = 0, cov[c] = 0;
    for (int64_t c = a + 4 * threadIdx.x; c < b; c += 4 * kVoteThreads) {
        *reinterpret_cast<uint32_t*>(cons + c) = 0u;
        *reinterpret_cast<int4*>(cov + c) = make_int4(0, 0, 0, 0);
    }
    for (int64_t c = b + threadIdx.x; c < hi; c += kVoteThreads)
        cons[c] = 0, cov[c] = 0;
}

// The first maximum of four counts (ties to the lowest code; none: 0).
__device__ __forceinline__ uint32_t first_max(int4 v) {
    uint32_t best = 0;
    int bv = v.x;
    if (v.y > bv) { bv = v.y; best = 1; }
    if (v.z > bv) { bv = v.z; best = 2; }
    if (v.w > bv) best = 3;
    return best;
}

// A lane's member of a chunk of 32: its row, its first column relative to
// the tile's, its strand.
struct Meta {
    int r = 0, b = 0, z = 0;
};

__device__ __forceinline__ Meta load_meta(int64_t m, int64_t g0, int L,
                                          const int32_t* order,
                                          const int32_t* smz,
                                          const int32_t* seg_id,
                                          const int* tile_max) {
    const int z = smz[m];
    const int g = (int)(seg_id[m] - g0);
    return Meta{order[m], g * 2 * L + tile_max[g] - (z >> 1), z & 1};
}

// Members u0 .. u0 + kU - 1 of the chunk (n of them), as every lane sees
// them.
__device__ __forceinline__ void members(Member* mb, const Meta& me, int u0,
                                        int n, const uint8_t* codes, int L) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
        const int r = __shfl_sync(0xFFFFFFFFu, me.r, u0 + u);
        const int b = __shfl_sync(0xFFFFFFFFu, me.b, u0 + u);
        const int z = __shfl_sync(0xFFFFFFFFu, me.z, u0 + u);
        const bool on = u0 + u < n;
        mb[u] = Member{codes + (int64_t)r * L, on ? b : 0, z != 0, on};
    }
}

__global__ void __launch_bounds__(kVoteThreads, 8)
step_vote_kernel(const uint8_t* __restrict__ codes, int L, int vec4,
                 const int32_t* __restrict__ order,
                 const int32_t* __restrict__ smz,
                 const int32_t* __restrict__ seg_id,
                 const int32_t* __restrict__ first,
                 const int32_t* __restrict__ seg_max, int64_t N, int G,
                 int64_t span, uint8_t* __restrict__ cons,
                 int32_t* __restrict__ cov, int32_t* __restrict__ diffs) {
    extern __shared__ int4 smem[];
    const int W = G * 2 * L;
    int4* cnt4 = smem;
    int* cnt = reinterpret_cast<int*>(smem);
    const uint32_t* vote32 = reinterpret_cast<const uint32_t*>(smem + W);
    uint8_t* vote = reinterpret_cast<uint8_t*>(smem + W) + kPad;
    int* tile_first = reinterpret_cast<int*>(vote + W + 12);   // G + 1
    int* tile_max = tile_first + G + 1;                         // G
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    // tiles of the segments' slots, and the columns from the first slot
    // past them on, up to span, as zeros kTailCols at a time; a block takes
    // one of each kind in turn (a round: one item a block), so that its
    // zeros stream out while its next tile waits on its loads
    const int64_t nseg = first[N + 1];
    const int64_t tiles = (nseg + G - 1) / G;
    const int64_t zero_lo = min(min(tiles * G, N) * 2 * L, span);
    const int64_t zeros = (span - zero_lo + kTailCols - 1) / kTailCols;
    const int64_t grid = gridDim.x;
    const int64_t rt = (tiles + grid - 1) / grid;
    const int64_t rz = (zeros + grid - 1) / grid;
    const int64_t both = min(rt, rz);

    for (int64_t r = 0; r < rt + rz; ++r) {
        const bool zero = r < 2 * both ? (r & 1) : rz > rt;
        const int64_t u = (r < 2 * both ? r >> 1 : r - both) * grid +
                          blockIdx.x;
        if (zero) {
            const int64_t lo = zero_lo + u * kTailCols;
            if (u < zeros)
                zero_cols(cons, cov, lo, min(span, lo + kTailCols));
            continue;
        }
        if (u >= tiles) continue;
        const int64_t g0 = u * G;
        const int segs = (int)min((int64_t)G, nseg - g0);
        const int64_t w0 = g0 * 2 * L;
        const int width = (int)(min(g0 + G, N) - g0) * 2 * L;
        const int tid = threadIdx.x;
        if (tid <= segs) tile_first[tid] = first[g0 + tid];
        if (tid < segs) tile_max[tid] = seg_max[g0 + tid];
        for (int c = threadIdx.x; c < width; c += kVoteThreads)
            cnt4[c] = make_int4(0, 0, 0, 0);
        __syncthreads();

        // each warp a contiguous slice of the tile's members, 32 members'
        // metadata at a time (kept for the diffs where the slice is one
        // chunk), then kU rows at a time, 4 bases a lane
        const int64_t i0 = tile_first[0], i1 = tile_first[segs];
        const int64_t per = (i1 - i0 + kVoteWarps - 1) / kVoteWarps;
        const int64_t s0 = i0 + warp * per, s1 = min(i1, s0 + per);
        Meta me;
        for (int64_t c0 = s0; c0 < s1; c0 += 32) {
            const int n = (int)min((int64_t)32, s1 - c0);
            if (lane < n)
                me = load_meta(c0 + lane, g0, L, order, smz, seg_id,
                               tile_max);
            for (int u0 = 0; u0 < n; u0 += kU) {
                Member mb[kU];
                members(mb, me, u0, n, codes, L);
                for (int j0 = lane * 4; j0 < L; j0 += 128) {
                    uint32_t w[kU];
#pragma unroll
                    for (int u = 0; u < kU; ++u)
                        w[u] = mb[u].on ? load4(mb[u].row, L, j0, vec4)
                                        : 0xFFFFFFFFu;
#pragma unroll
                    for (int u = 0; u < kU; ++u)
                        count4(cnt, w[u], mb[u], j0, L);
                }
            }
        }
        __syncthreads();

        // 4 columns a thread: votes (255 past span, for the diffs) into
        // shared memory, consensus and coverage out
        for (int c = 4 * threadIdx.x; c < width; c += 4 * kVoteThreads) {
            uint32_t v4 = 0;
            int cv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int4 v = c + q < width ? cnt4[c + q]
                                             : make_int4(0, 0, 0, 0);
                const uint32_t b = w0 + c + q < span ? first_max(v) : 0xFFu;
                v4 |= b << (8 * q);
                cv[q] = v.x + v.y + v.z + v.w;
            }
            *reinterpret_cast<uint32_t*>(vote + c) = v4;
            if (c + 4 <= width && w0 + c + 4 <= span) {
                *reinterpret_cast<uint32_t*>(cons + w0 + c) = v4;
                *reinterpret_cast<int4*>(cov + w0 + c) =
                    make_int4(cv[0], cv[1], cv[2], cv[3]);
            } else {
                for (int q = 0; q < 4 && c + q < width && w0 + c + q < span;
                     ++q) {
                    cons[w0 + c + q] = (uint8_t)(v4 >> (8 * q));
                    cov[w0 + c + q] = cv[q];
                }
            }
        }
        __syncthreads();

        // each member's mismatches; lane u0 + u writes member c0 + u0 + u's
        for (int64_t c0 = s0; c0 < s1; c0 += 32) {
            const int n = (int)min((int64_t)32, s1 - c0);
            if (s1 - s0 > 32 && lane < n)
                me = load_meta(c0 + lane, g0, L, order, smz, seg_id,
                               tile_max);
            for (int u0 = 0; u0 < n; u0 += kU) {
                Member mb[kU];
                members(mb, me, u0, n, codes, L);
                unsigned d[kU];
#pragma unroll
                for (int u = 0; u < kU; ++u) d[u] = 0;
                for (int j0 = lane * 4; j0 < L; j0 += 128) {
#pragma unroll
                    for (int u = 0; u < kU; ++u)
                        if (mb[u].on)
                            d[u] += mismatches4(
                                vote32, load4(mb[u].row, L, j0, vec4), mb[u],
                                j0, L);
                }
#pragma unroll
                for (int u = 0; u < kU; ++u) {
                    const unsigned sum = __reduce_add_sync(0xFFFFFFFFu, d[u]);
                    if (lane == u0 + u && mb[u].on)
                        diffs[c0 + u0 + u] = (int32_t)sum;
                }
            }
        }
        __syncthreads();   // the next tile reuses the counts and votes
    }
}

// Blocks of `kernel` at `threads` and `smem` that one SM holds, and the SM
// count; asked once per process and kept.
int blocks_per_sm(const void* kernel, int threads, size_t smem, int* sms) {
    static std::mutex mu;
    static std::map<std::tuple<int, const void*, size_t>,
                    std::pair<int, int>> known;
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return -(int)e;
    const std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple(dev, kernel, smem);
    auto it = known.find(key);
    if (it == known.end()) {
        int n, per;
        e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                              threads, smem);
        if (e != cudaSuccess) return -(int)e;
        it = known.emplace(key, std::make_pair(per, n)).first;
    }
    *sms = it->second.second;
    return it->second.first;
}

}  // namespace

extern "C" {

// sk: (c)'s [3, N] words; key [N] int64 and mz [N] int32 out.
int mtc_step_keys(const uint8_t* codes, int64_t L, const uint32_t* sk,
                  int64_t N, int k, int64_t* key, int32_t* mz, void* stream) {
    if (N <= 0) return 0;
    if (k < 1 || k > 31 || L < k || L > 256) return (int)cudaErrorInvalidValue;
    step_keys_kernel<<<(unsigned)((N + kKeyThreads - 1) / kKeyThreads),
                       kKeyThreads, 0, (cudaStream_t)stream>>>(
        codes, (int)L, sk, N, k, key, mz);
    return (int)cudaGetLastError();
}

// skey, order: torch.sort's output on key; mz: [N] from mtc_step_keys (every
// value >= 0); scratch: [2 * (ceil(N / kSegTile) + 1)] int32, 8-byte
// aligned, zeroed here on the stream (a status word a tile, the ticket).
// order32, smz (mz in sorted order), seg_id [N] out; first [N + 2] (first[0
// .. nseg], nseg at N + 1) and seg_max [N] (0 .. nseg - 1) out.
int mtc_step_segments(const int64_t* skey, const int64_t* order,
                      const int32_t* mz, int64_t N, int32_t* scratch,
                      int32_t* order32, int32_t* smz, int32_t* seg_id,
                      int32_t* first, int32_t* seg_max, void* stream) {
    if (N <= 0) return 0;
    if (N > 0x7FFFFFFF || (reinterpret_cast<uintptr_t>(scratch) & 7))
        return (int)cudaErrorInvalidValue;
    const int64_t tiles = (N + kSegTile - 1) / kSegTile;
    unsigned long long* status =
        reinterpret_cast<unsigned long long*>(scratch);
    const cudaError_t e = cudaMemsetAsync(
        status, 0, (size_t)(tiles + 1) * sizeof(unsigned long long),
        (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    seg_scan_kernel<<<(unsigned)tiles, kSegThreads, 0,
                      (cudaStream_t)stream>>>(skey, order, mz, N, status,
                                              order32, smz, seg_id, first,
                                              seg_max);
    return (int)cudaGetLastError();
}

// G: segment slots a tile ((G 2L) % 4 == 0); span: consensus [span] u8 and
// coverage [span] int32 out (every column written); diffs [N] int32 out.
int mtc_step_vote(const uint8_t* codes, int64_t L, const int32_t* order,
                  const int32_t* smz, const int32_t* seg_id,
                  const int32_t* first, const int32_t* seg_max, int64_t N,
                  int G, int64_t span, uint8_t* cons, int32_t* cov,
                  int32_t* diffs, void* stream) {
    if (N <= 0) return 0;
    const int64_t W = (int64_t)G * 2 * L;
    // the counts, the votes with kPad bytes before and 12 after, then the
    // tile's first members and segment maxima
    const size_t smem = (size_t)W * sizeof(int4) + (size_t)W + 16 +
                        (size_t)(2 * G + 1) * sizeof(int);
    if (L < 1 || L > 256 || G < 1 || W % 4 || span < 0 || smem > 232448 ||
        (reinterpret_cast<uintptr_t>(cons) & 3) ||
        (reinterpret_cast<uintptr_t>(cov) & 15))
        return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            step_vote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    int sms;
    const int per_sm = blocks_per_sm((const void*)step_vote_kernel,
                                     kVoteThreads, smem, &sms);
    if (per_sm < 0) return -per_sm;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
    // the most work items: every slot a segment's, and the tail
    const int64_t n_work =
        (N + G - 1) / G +
        (max((int64_t)0, span - N * 2 * L) + kTailCols - 1) / kTailCols;
    const int64_t grid = min(n_work, (int64_t)per_sm * sms);
    const int vec4 =
        L % 4 == 0 && (reinterpret_cast<uintptr_t>(codes) & 3) == 0;
    step_vote_kernel<<<(unsigned)grid, kVoteThreads, smem,
                       (cudaStream_t)stream>>>(
        codes, (int)L, vec4, order, smz, seg_id, first, seg_max, N, G, span,
        cons, cov, diffs);
    return (int)cudaGetLastError();
}

}  // extern "C"
