"""The CUDA kernels of ``csrc/``: built with nvcc for sm_90a at first use
(never at import), loaded with ctypes, launch-checked, and counted; and the
crossings between host and device, timed and counted.

``launches[name]`` grows by one each time a wrapper in ``ops/`` launches its
kernel; launches of a plain PyTorch version on a CPU tensor do not count.
Wrappers launch from several threads at once (the container codes streams
in a thread pool), so the count is taken under a lock.

Every copy between the host and a device in the package goes through
``to_device`` or ``to_host``. Each adds to two process-wide counters, read by
``device_seconds()`` and ``device_bytes()``: the host wall spent in the copy
(for a synchronous download, the queued work it waits for included; for a
non-blocking upload, the enqueue) and the bytes that crossed.
``stats.StageStats`` splits both by stage.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from minicom_tpu_torch.native import build_shared

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SRCS = [os.path.join(_CSRC, f) for f in ("sketch.cu", "consensus.cu",
                                           "rans.cu", "verify.cu", "step.cu")]

launches: collections.Counter = collections.Counter()
_launches_lock = threading.Lock()

_device_seconds = 0.0
_device_bytes = 0
_device_lock = threading.Lock()

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


def reset_device_seconds() -> None:
    """Set the crossing counters to 0."""
    global _device_seconds, _device_bytes
    with _device_lock:
        _device_seconds, _device_bytes = 0.0, 0


def device_seconds() -> float:
    """Host wall seconds spent in crossings since the last reset, summed
    over threads."""
    with _device_lock:
        return _device_seconds


def device_bytes() -> int:
    """Bytes that crossed between host and device since the last reset."""
    with _device_lock:
        return _device_bytes


def _account(dt: float, nbytes: int = 0) -> None:
    global _device_seconds, _device_bytes
    with _device_lock:
        _device_seconds += dt
        _device_bytes += nbytes


def to_device(x, dev, non_blocking: bool = False) -> torch.Tensor:
    """``x`` (a tensor, or a numpy array taken without a copy where it is
    contiguous) on device ``dev``. A copy from the host to a device, or
    back, is timed and counted; ``non_blocking`` as for ``Tensor.to``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    dev = torch.device(dev)
    if x.device.type == dev.type:
        return x.to(dev)
    t0 = time.perf_counter()
    out = x.to(dev, non_blocking=non_blocking)
    _account(time.perf_counter() - t0, x.numel() * x.element_size())
    return out


def to_host(t: torch.Tensor, out: torch.Tensor | None = None
            ) -> torch.Tensor:
    """``t`` on the host: ``t`` itself where it is there, else a new host
    tensor, or ``out`` (a host tensor of t's shape, pinned or not) written
    in place. A copy from a device is timed and counted; it waits for the
    work queued before it."""
    if t.device.type == "cpu":
        return t if out is None else out.copy_(t)
    t0 = time.perf_counter()
    out = t.cpu() if out is None else out.copy_(t)
    _account(time.perf_counter() - t0, t.numel() * t.element_size())
    return out


def named(dev):
    """``dev`` (None, a name or a torch.device) with its card named: a
    CUDA device without an index is the calling thread's current card,
    fixed here for the threads it is handed to, whose own current card is
    0."""
    if dev is None:
        return None
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def pinned(n: int, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """An empty host tensor of ``n`` items in page-locked memory, taken
    under ``dev``'s context: the host allocator uses the calling thread's
    current card where that has a context, so the card is named here."""
    with torch.cuda.device(dev):
        return torch.empty(n, dtype=dtype, pin_memory=True)


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
