"""Batched XOR-popcount verify of 2-bit-packed base windows: the Hamming
check of a candidate (read, contig window) placement in the realign search
(basediff semantics, ``bbhashdict.c:247-254``), as an op.

``popcount_verify`` launches the CUDA kernel of ``csrc/verify.cu`` on CUDA
tensors and runs the plain PyTorch version below on CPU tensors. The
pipeline's realign verifies inside the host C++ probe
(``native.realign_probe``), as the JAX package's does; this op is the
counterpart of the JAX package's ``popcount_verify`` /
``popcount_verify_pallas``, which only its tools and tests call.
"""

from __future__ import annotations

import torch

from minicom_tpu_torch.ops import cuda

U32_MAX = 0xFFFFFFFF


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 tensors holding u32 values."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32_MAX) >> 24


def _verify_plain(a, b):
    x = a.to(torch.int64) ^ b.to(torch.int64)
    return _popcount32(x).sum(dim=1, dtype=torch.int32)


def popcount_verify(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row XOR popcount: a, b [N, W] uint32 -> [N] int32 bit
    differences, for any N. Replaces ``pallas_verify._verify_kernel``
    (``popcount_verify_pallas``) and its XLA twin ``popcount_verify``."""
    cuda.check(a, torch.uint32, 2, "a")
    cuda.check(b, torch.uint32, 2, "b")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("a and b differ in shape or device")
    if a.device.type == "cpu":
        return _verify_plain(a, b)
    cuda.require_cuda(a)
    N, W = a.shape
    out = torch.empty(N, dtype=torch.int32, device=a.device)
    if N:
        cuda.launch("mtc_popcount_verify", a, b, N, W, out)
    return out
