// Batched XOR-popcount verify for Hopper (sm_90a), bound with ctypes from
// minicom_tpu_torch/ops/verify.py. Plain C interface: device pointers and a
// cudaStream_t in, cudaGetLastError() out, no allocation.
//
// Replaces minicom_tpu/ops/pallas_verify.py _verify_kernel (the Pallas
// kernel of popcount_verify_pallas) and its XLA twin popcount_verify: row r
// of two [N, W] u32 matrices of 2-bit-packed bases gives
// sum_w popcount(a[r, w] ^ b[r, w]) as int32 (basediff, bbhashdict.c:247-254).
// The TPU kernel tiled rows in blocks of 256 through VMEM and needed
// N % 256 == 0; here one thread owns one row (W = 7 words at L = 100), a
// grid-stride loop covers any N, and __popc replaces the SWAR popcount.
// Bound: device-memory bandwidth, 8 W bytes read and 4 written per row;
// neighbouring threads read neighbouring rows, so each warp's loads stay
// within a few cache lines.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
verify_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
              int64_t N, int64_t W, int32_t* __restrict__ out) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; r < N;
         r += stride) {
        const uint32_t* pa = a + r * W;
        const uint32_t* pb = b + r * W;
        int32_t s = 0;
        for (int64_t w = 0; w < W; ++w) s += __popc(__ldg(pa + w) ^ __ldg(pb + w));
        out[r] = s;
    }
}

}  // namespace

extern "C" {

int mtc_popcount_verify(const uint32_t* a, const uint32_t* b, int64_t N,
                        int64_t W, int32_t* out, void* stream) {
    int64_t blocks = (N + kThreads - 1) / kThreads;
    if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
    verify_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        a, b, N, W, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
