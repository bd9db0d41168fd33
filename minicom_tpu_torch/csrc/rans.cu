// Interleaved 128-lane rANS for Hopper (sm_90a), bound with ctypes from
// minicom_tpu_torch/ops/rans.py. Plain C interface: device pointers and a
// cudaStream_t in, cudaGetLastError() out, no allocation.
//
// Replaces the XLA device programs of both on-device entropy codecs:
//   * minicom_tpu/entropy/device_rans.py     _encode_program / _decode_program
//     (codec "trans": order-0, lane l owns symbols l, l+128, ...),
//   * minicom_tpu/entropy/device_ctx_rans.py _encode_program / _decode_program
//     (codecs "trans1", "trans2" and the residual coder of "dzt": order-k
//     contexts over an alphabet of A symbols, lane l owns a contiguous chunk).
// Order-0 is the context coder with C = 1 context and A = 256, so one encode
// and one decode kernel serve both; only the host's lane layout and validity
// mask differ. Encode takes the per-slot frequency f and cumulative c already
// gathered on the host, as the JAX context program does.
//
// State machine (32-bit state in [2^16, 2^32), 16-bit renormalisation,
// M = 2^12): all arithmetic is uint32_t, so decode's f * (x >> 12) + slot - c
// wraps mod 2^32 exactly as the JAX program does. The emit test is written
// (x >> 20) >= f: x >= f << 20 overflows at f = M (a one-symbol block).
//
// Layout: one block of 128 threads per rANS block, one thread per lane; a
// [T, 128] grid is row-major with the lane fastest, so each step's loads and
// stores are coalesced across the block. The format fixes 128 lanes (the
// header stores log2 of the lane count), so a block cannot widen without
// changing bytes. Bound: both scans are serial chains of T dependent steps
// per lane (a u32 division per encode step, three dependent table gathers
// per decode step); the kernels are latency-bound, not bandwidth-bound.
// Encode software-pipelines its loads: the next tile of kTile steps is in
// flight while the current one is coded. Decode keeps each lane's next word
// in a register, so only the table gathers stay on the chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kTile = 16;
constexpr uint32_t kMBits = 12;
constexpr uint32_t kM = 1u << kMBits;
constexpr uint32_t kRansL = 1u << 16;

// steps base-1 .. base-kTile (reverse time) of lane l; t < 0 is a pad step
__device__ __forceinline__ void load_tile(const uint32_t* __restrict__ f,
                                          const uint32_t* __restrict__ c,
                                          const uint8_t* __restrict__ valid,
                                          int64_t base, int l,
                                          uint32_t (&tf)[kTile],
                                          uint32_t (&tc)[kTile],
                                          uint32_t (&tv)[kTile]) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
        const int64_t t = base - 1 - j;
        if (t >= 0) {
            const int64_t i = t * kLanes + l;
            tf[j] = __ldg(f + i);
            tc[j] = __ldg(c + i);
            tv[j] = __ldg(valid + i);
        } else {
            tf[j] = 1;
            tc[j] = 0;
            tv[j] = 0;
        }
    }
}

// f, c: [T, 128] u32; valid: [T, 128] u8 (0/1). Out: states [128] u32, words
// [T, 128] u16 (lane l's words in forward time order in rows 0..counts[l]-1,
// zeros below), counts [128] i32.
__global__ void __launch_bounds__(kLanes)
rans_encode_kernel(const uint32_t* __restrict__ f,
                   const uint32_t* __restrict__ c,
                   const uint8_t* __restrict__ valid, int64_t T,
                   uint32_t* __restrict__ states, uint16_t* __restrict__ words,
                   int32_t* __restrict__ counts) {
    const int l = threadIdx.x;
    uint32_t x = kRansL;
    int64_t n = 0;
    uint32_t af[kTile], ac[kTile], av[kTile];
    uint32_t bf[kTile], bc[kTile], bv[kTile];
    load_tile(f, c, valid, T, l, af, ac, av);
    for (int64_t base = T; base > 0; base -= kTile) {
        if (base > kTile) load_tile(f, c, valid, base - kTile, l, bf, bc, bv);
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
            if (!av[j]) continue;   // pad step: the state passes through
            const uint32_t fj = af[j] > 1u ? af[j] : 1u;
            if ((x >> 20) >= fj) {
                // the reverse scan emits last-first: word e goes to row
                // T-1-e, so rows T-n .. T-1 end up in forward order
                words[(T - 1 - n) * kLanes + l] = (uint16_t)(x & 0xFFFFu);
                ++n;
                x >>= 16;
            }
            x = ((x / fj) << kMBits) | ((x % fj) + ac[j]);
        }
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
            af[j] = bf[j];
            ac[j] = bc[j];
            av[j] = bv[j];
        }
    }
    states[l] = x;
    counts[l] = (int32_t)n;
    // move rows T-n .. T-1 up to 0 .. n-1 (source row >= destination row,
    // so a forward in-place copy is safe) and zero the rest of the column
#pragma unroll 8
    for (int64_t i = 0; i < T; ++i)
        words[i * kLanes + l] =
            i < n ? words[(T - n + i) * kLanes + l] : (uint16_t)0;
}

// states [128] u32; words [W, 128] u16 (W >= 1); valid [T, 128] u8; freq,
// cum [C * A] u32; slot_sym [C * M] u8. Out: syms [T, 128] u8 (every step,
// pad steps included, as the JAX program gives them).
__global__ void __launch_bounds__(kLanes)
rans_decode_kernel(const uint32_t* __restrict__ states,
                   const uint16_t* __restrict__ words, int64_t W,
                   const uint8_t* __restrict__ valid, int64_t T,
                   const uint32_t* __restrict__ freq,
                   const uint32_t* __restrict__ cum,
                   const uint8_t* __restrict__ slot_sym, int32_t A, int32_t C,
                   uint8_t* __restrict__ syms) {
    const int l = threadIdx.x;
    uint32_t x = states[l];
    int64_t ptr = 0;
    int32_t ctx = 0;
    uint32_t next = __ldg(words + l);   // words[min(ptr, W-1)] of this lane
    for (int64_t t = 0; t < T; ++t) {
        const int64_t i = t * kLanes + l;
        const uint32_t slot = x & (kM - 1);
        const uint32_t s = __ldg(slot_sym + (int64_t)ctx * kM + slot);
        const int32_t j = ctx * A + (int32_t)s;
        syms[i] = (uint8_t)s;
        if (__ldg(valid + i)) {
            uint32_t xn = __ldg(freq + j) * (x >> kMBits) + slot
                          - __ldg(cum + j);
            if (xn < kRansL) {
                xn = (xn << 16) | next;
                ++ptr;
                next = __ldg(words + (ptr < W ? ptr : W - 1) * kLanes + l);
            }
            x = xn;
            ctx = (ctx * A + (int32_t)s) % C;
        }
    }
}

}  // namespace

extern "C" {

int mtc_rans_encode(const uint32_t* f, const uint32_t* c,
                    const uint8_t* valid, int64_t T, uint32_t* states,
                    uint16_t* words, int32_t* counts, void* stream) {
    rans_encode_kernel<<<1, kLanes, 0, (cudaStream_t)stream>>>(
        f, c, valid, T, states, words, counts);
    return (int)cudaGetLastError();
}

int mtc_rans_decode(const uint32_t* states, const uint16_t* words, int64_t W,
                    const uint8_t* valid, int64_t T, const uint32_t* freq,
                    const uint32_t* cum, const uint8_t* slot_sym, int A,
                    int C, uint8_t* syms, void* stream) {
    rans_decode_kernel<<<1, kLanes, 0, (cudaStream_t)stream>>>(
        states, words, W, valid, T, freq, cum, slot_sym, A, C, syms);
    return (int)cudaGetLastError();
}

}  // extern "C"
