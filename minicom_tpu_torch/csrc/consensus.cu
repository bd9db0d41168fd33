// Segmented majority-vote consensus for Hopper (sm_90a), bound with ctypes
// from minicom_tpu_torch/ops/consensus.py. Plain C interface: device
// pointers and a cudaStream_t in, cudaGetLastError() out, no allocation.
//
// Replaces the consensus family of minicom_tpu/ops/consensus.py
// (consensus_fused_rid_u; scatter_counts_rid_u + consensus_finalize +
// member_diffs_packed_rid_u for many member blocks). Member m is the read
// rd[m] >> 1 of the device-resident read store, reverse-complemented when
// rd[m] & 1 (codes >= 4 stay as they are and count for no base), laid at
// column col[m] of a flat column space shared by all clusters of the call.
// A column votes the first maximum of its four counts (ties to the lowest
// code, the strict-greater update of consensus.cpp and jnp.argmax; no
// coverage votes 0); a member's diff is its number of columns whose code
// differs from the vote.
//
// One launch, one block per tile of the host's plan (ops/consensus.py
// _plan). Clusters own disjoint column ranges, so a tile of whole clusters
// holds every count its columns get: the counts live in shared memory and
// never touch device memory, and no atomic crosses blocks. A tile is
// (w0, w1, r1, i0, i1, indirect): it counts the bases that fall in columns
// [w0, w1) of members i0..i1 (or of members idx[i0..i1] when indirect),
// writes the vote of [w0, r1) and the diff of each member that starts in
// [w0, r1). Consecutive small clusters share a tile; a cluster wider than
// a tile is cut into tiles that each own a piece and also count the L - 1
// columns past it (w1 = r1 + L - 1, clipped at the cluster's end), so every
// member's diff is made in the one tile its first column falls in, against
// votes that tile made whole. Their members come as an index list sorted by
// column, so a piece reads only the members that reach it.
//   1. zero the tile's [w1 - w0, 4] int32 counts in shared memory;
//   2. each warp a contiguous slice of the tile's members: the (m, rd, col)
//      of 32 of them at a time, a lane each; then kU = 4 members at a
//      time, every lane loading its 4 bases of each (one 4-byte load where
//      L % 4 == 0, the kU loads in flight together), oriented in
//      registers, one shared-memory atomic a base;
//   3. a thread per column: the vote into shared memory and, for [w0, r1),
//      into ref (coalesced bytes);
//   4. the same walk over the members that start in [w0, r1): each row
//      again (an L1/L2 hit: the tile read it moments before), 4 bases a
//      lane against 4 votes as one word, a warp sum, one store a member.
// What holds it to ~1/5 of its bound: the shared-memory atomics, ~3 a clock
// an SM, are 3/4 of its time. Spreading them over 32 banks (code-major
// count planes, bytes handed across lanes by shuffles), staging 16 rows a
// warp with cp.async, and counting in registers over columns that a lane
// owns (no atomics, but every member tested against every window) were
// each slower (PERF.md).
// Bound: the member rows (L bytes each, gathered from the store) and a
// handful of integer operations a base; the counts cost shared-memory
// traffic only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileFields = 6;
constexpr int kU = 4;     // member rows a lane keeps in flight
constexpr int kPad = 4;   // vote bytes before the tile's first column

// The 4 bytes of row[j0 .. j0 + 4); bytes at or past L read as 0xFF, which
// counts for nothing and is masked out of the diffs.
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int L, int j0,
                                          bool vec4) {
    if (vec4) return *reinterpret_cast<const uint32_t*>(row + j0);
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        w |= (uint32_t)(j0 + k < L ? row[j0 + k] : 0xFFu) << (8 * k);
    return w;
}

struct Member {          // one member of a group, as every lane sees it
    const uint8_t* row;
    int base;            // its first column, relative to the tile's
    bool rev, on;
};

__device__ __forceinline__ Member member(int64_t r, int64_t b, bool on,
                                         const uint8_t* codes, int L) {
    return Member{codes + (r >> 1) * (int64_t)L, on ? (int)b : 0,
                  (r & 1) != 0, on};
}

// Adds the lane's 4 bases (row bytes j0 .. j0 + 3 of member mb) to the
// tile's counts: code c at column p, complemented and mirrored for a
// reverse member, only columns of the tile's window.
__device__ __forceinline__ void count4(int* cnt, uint32_t w, const Member& mb,
                                       int j0, int L, int width) {
    const int p0 = mb.rev ? mb.base + L - 1 - j0 : mb.base + j0;
    const int step = mb.rev ? -1 : 1;
    const uint32_t x = mb.rev ? 3u : 0u;
    const bool whole = mb.base >= 0 && mb.base + L <= width;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t c = (w >> (8 * k)) & 0xFFu;
        const int p = p0 + step * k;
        if (c < 4 && (whole || (unsigned)p < (unsigned)width))
            atomicAdd(&cnt[p * 4 + (c ^ x)], 1);
    }
}

// The lane's 4 bases against the votes under them: the 4 votes as one word
// (two aligned shared-memory words and a funnel shift), the bases byte
// reversed and complemented for a reverse member (a code >= 4 stays >= 4,
// so it still differs), one byte-wise compare; bytes past L do not count.
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

// At least 5 blocks an SM: the compiler keeps to 48 registers (spilling a
// few bytes), and over a 5M-read compress's calls that beat 62 registers
// and 4 blocks by 4.5%.
__global__ void __launch_bounds__(kThreads, 5)
vote_tiles_kernel(const uint8_t* __restrict__ codes, int L, int vec4,
                  const int64_t* __restrict__ rd,
                  const int64_t* __restrict__ col,
                  const int64_t* __restrict__ tiles,
                  const int64_t* __restrict__ idx, int cap, int want,
                  int32_t* __restrict__ diffs, uint8_t* __restrict__ ref) {
    extern __shared__ int4 smem[];
    int4* cnt4 = smem;
    int* cnt = reinterpret_cast<int*>(smem);
    const uint32_t* vote32 = reinterpret_cast<const uint32_t*>(smem + cap);
    uint8_t* vote = reinterpret_cast<uint8_t*>(smem + cap) + kPad;

    const int64_t* t = tiles + (int64_t)blockIdx.x * kTileFields;
    const int64_t w0 = t[0];
    const int width = (int)(t[1] - w0);
    const int own = (int)(t[2] - w0);
    const int64_t i0 = t[3], i1 = t[4];
    const bool indirect = t[5] != 0;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // each warp a contiguous slice of the tile's members
    const int64_t per = (i1 - i0 + kWarps - 1) / kWarps;
    const int64_t s0 = i0 + warp * per, s1 = min(i1, s0 + per);

    for (int c = threadIdx.x; c < width; c += kThreads)
        cnt4[c] = make_int4(0, 0, 0, 0);
    __syncthreads();

    // 32 members' (m, rd, col) at a time, a lane each; then kU rows at a
    // time, every lane loading its 4 bases of each before counting any
    for (int64_t c0 = s0; c0 < s1; c0 += 32) {
        const int n = (int)min((int64_t)32, s1 - c0);
        int64_t my_r = 0, my_b = 0;
        if (lane < n) {
            const int64_t m = indirect ? idx[c0 + lane] : c0 + lane;
            my_r = rd[m];
            my_b = col[m] - w0;
        }
        for (int u0 = 0; u0 < n; u0 += kU) {
            Member mb[kU];
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const int64_t r = __shfl_sync(0xFFFFFFFFu, my_r, u0 + u);
                const int64_t b = __shfl_sync(0xFFFFFFFFu, my_b, u0 + u);
                mb[u] = member(r, b, u0 + u < n && b < width && b + L > 0,
                               codes, L);
            }
            for (int j0 = lane * 4; j0 < L; j0 += 128) {
                uint32_t w[kU];
#pragma unroll
                for (int u = 0; u < kU; ++u)
                    w[u] = mb[u].on ? load4(mb[u].row, L, j0, vec4)
                                    : 0xFFFFFFFFu;
#pragma unroll
                for (int u = 0; u < kU; ++u)
                    count4(cnt, w[u], mb[u], j0, L, width);
            }
        }
    }
    __syncthreads();

    for (int c = threadIdx.x; c < width; c += kThreads) {
        const int4 v = cnt4[c];
        uint8_t best = 0;
        int bv = v.x;
        if (v.y > bv) { bv = v.y; best = 1; }
        if (v.z > bv) { bv = v.z; best = 2; }
        if (v.w > bv) { best = 3; }
        vote[c] = best;
        if ((want & 1) && c < own) ref[w0 + c] = best;
    }
    if (!(want & 2)) return;
    __syncthreads();

    // the same walk over the members that start in the owned columns;
    // lane u0 + u writes member u0 + u's diff
    for (int64_t c0 = s0; c0 < s1; c0 += 32) {
        const int n = (int)min((int64_t)32, s1 - c0);
        int64_t my_m = 0, my_r = 0, my_b = -1;
        if (lane < n) {
            my_m = indirect ? idx[c0 + lane] : c0 + lane;
            my_r = rd[my_m];
            my_b = col[my_m] - w0;
        }
        for (int u0 = 0; u0 < n; u0 += kU) {
            Member mb[kU];
            unsigned d[kU];
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const int64_t r = __shfl_sync(0xFFFFFFFFu, my_r, u0 + u);
                const int64_t b = __shfl_sync(0xFFFFFFFFu, my_b, u0 + u);
                mb[u] = member(r, b, b >= 0 && b < own, codes, L);
                d[u] = 0;
            }
            for (int j0 = lane * 4; j0 < L; j0 += 128) {
                uint32_t w[kU];
#pragma unroll
                for (int u = 0; u < kU; ++u)
                    w[u] = mb[u].on ? load4(mb[u].row, L, j0, vec4) : 0u;
#pragma unroll
                for (int u = 0; u < kU; ++u)
                    if (mb[u].on) d[u] += mismatches4(vote32, w[u], mb[u],
                                                      j0, L);
            }
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const unsigned sum = __reduce_add_sync(0xFFFFFFFFu, d[u]);
                if (lane == u0 + u && mb[u].on) diffs[my_m] = (int32_t)sum;
            }
        }
    }
}

}  // namespace

extern "C" {

// plan: int64 [rd (M) | col (M) | tiles (n_tiles x 6) | idx], one upload;
// cap: the widest tile's columns (w1 - w0), which sizes shared memory;
// want: 1 ref, 2 diffs, 3 both; diffs [M] int32 and ref [span] u8 out, each
// written only when asked (may then be null).
int mtc_consensus_vote(const uint8_t* codes, int L, const int64_t* plan,
                       int64_t M, int64_t n_tiles, int cap, int want,
                       int32_t* diffs, uint8_t* ref, void* stream) {
    if (n_tiles <= 0) return (int)cudaSuccess;
    // the counts, then the votes with kPad bytes before and 12 after
    const size_t smem = (size_t)cap * sizeof(int4) + (size_t)cap + 16;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            vote_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int vec4 = L % 4 == 0 && (reinterpret_cast<uintptr_t>(codes) & 3) == 0;
    const int64_t* rd = plan;
    const int64_t* col = plan + M;
    const int64_t* tiles = plan + 2 * M;
    const int64_t* idx = tiles + n_tiles * kTileFields;
    vote_tiles_kernel<<<(unsigned)n_tiles, kThreads, smem,
                        (cudaStream_t)stream>>>(codes, L, vec4, rd, col,
                                                tiles, idx, cap, want, diffs,
                                                ref);
    return (int)cudaGetLastError();
}

}  // extern "C"
