"""The CUDA kernels of ``csrc/``: built with nvcc for sm_90a at first use
(never at import), loaded with ctypes, launch-checked, and counted.

``launches[name]`` grows by one each time a wrapper in ``ops/`` launches its
kernel; launches of a plain PyTorch version on a CPU tensor do not count.
Wrappers launch from several threads at once (the container codes streams
in a thread pool), so the count is taken under a lock.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from minicom_tpu_torch.native import build_shared

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SRCS = [os.path.join(_CSRC, f) for f in ("sketch.cu", "consensus.cu",
                                           "rans.cu", "verify.cu", "step.cu")]

launches: collections.Counter = collections.Counter()
_launches_lock = threading.Lock()

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGS = {
    "mtc_sketch_reads": [_P, _I64, _P, _I64, _INT, _P, _P],
    "mtc_sketch_windowed": [_P, _P, _P, _I64, _INT, _INT, _P, _P, _P, _P,
                            _P, _P],
    "mtc_consensus_vote": [_P, _INT, _P, _I64, _I64, _INT, _INT, _P, _P, _P],
    "mtc_rans_encode": [_P, _P, _P, _I64, _I64, _P, _P, _P, _P],
    "mtc_rans_decode": [_P, _P, _I64, _P, _P, _I64, _I64, _P, _P],
    "mtc_popcount_verify": [_P, _P, _I64, _I64, _P, _P],
    "mtc_step_keys": [_P, _I64, _P, _I64, _INT, _P, _P, _P],
    "mtc_step_segments": [_P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _P],
    "mtc_step_vote": [_P, _I64, _P, _P, _P, _P, _P, _I64, _INT, _I64, _P,
                      _P, _P, _P],
}
_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def lib():
    """The kernel library, built on first call: one nvcc per source, all
    started together, then one link."""
    global _lib
    with _lib_lock:
        if _lib is None:
            nvcc = _nvcc()

            def compile_one(src):
                stem = "_" + os.path.splitext(os.path.basename(src))[0]
                return build_shared(stem, [src], lambda out: [
                    nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c", src,
                    "-o", out], suffix=".o")

            with ThreadPoolExecutor(len(_SRCS)) as pool:
                objs = list(pool.map(compile_one, _SRCS))
            so = build_shared("_kernels", objs, lambda out: [
                nvcc, "-shared", *objs, "-o", out])
            kl = ctypes.CDLL(so)
            for name, args in _SIGS.items():
                fn = getattr(kl, name)
                fn.restype = ctypes.c_int
                fn.argtypes = args
            kl.mtc_cuda_error_string.restype = ctypes.c_char_p
            kl.mtc_cuda_error_string.argtypes = [ctypes.c_int]
            kl.mtc_rans_layout.restype = None
            kl.mtc_rans_layout.argtypes = [ctypes.POINTER(ctypes.c_int64)]
            kl.mtc_sketch_layout.restype = None
            kl.mtc_sketch_layout.argtypes = [_INT,
                                             ctypes.POINTER(ctypes.c_int64)]
            _lib = kl
    return _lib


def launch(name: str, *args) -> None:
    """Call kernel entry point ``name`` (the stream is appended) on the
    device of its tensors and raise on the CUDA error it returns; count the
    launch."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    raw = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    fn = getattr(lib(), name)
    with torch.cuda.device(dev):
        err = fn(*raw, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib().mtc_cuda_error_string(err).decode()})")
    with _launches_lock:
        launches[name] += 1


def sketch_layout(w: int) -> tuple[int, int]:
    """The contig sketch's block layout for windows of up to ``w`` starts:
    (the most k-mer starts of a row that a warp takes, 0 for none; rows per
    block of warps)."""
    out = (ctypes.c_int64 * 2)()
    lib().mtc_sketch_layout(w, out)
    return int(out[0]), int(out[1])


def require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"tensor on {t.device}: the kernels take CUDA "
                         "tensors, the plain versions CPU tensors")


def check(t: torch.Tensor, dtype: torch.dtype, ndim: int, name: str) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {ndim}-d {dtype} tensor,"
                         f" got {t.dtype} {tuple(t.shape)}")
