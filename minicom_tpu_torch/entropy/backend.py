"""Entropy backends of the host codec family, one named codec per stream:

* "xz"    — LZMA2 raw stream (stdlib),
* "o1rc" / "o2rc" — native order-1 / order-2 adaptive range coders,
* "dnarc" — native 2-bit base coder with a 16-base rolling-hash context,
* "dz"    — native base-level LZ front end + blocked dnarc literals,
* "bz2" / "zlib" / "store" — stdlib;

and the on-device codecs, whose scans run on the ``device`` argument (CUDA
kernels on a CUDA device, their plain PyTorch versions on "cpu"):

* "trans" — order-0 interleaved rANS (``entropy/device_rans.py``),
* "trans1" / "trans2" — order-1 / order-2 context rANS over the used-byte
  alphabet (``entropy/device_ctx_rans.py``),
* "dzt"   — the dz matcher, its tokens and literals coded by the context
  rANS.

Any codec may be prefixed "pK:" (K in 2, 4, 8): the stream is an array of
K-byte little-endian records, deinterleaved into K byte planes before coding.
"""

from __future__ import annotations

import bz2
import lzma
import zlib

import numpy as np

from minicom_tpu_torch import native
from minicom_tpu_torch.entropy import device_ctx_rans, device_rans

# Encode with xz -9e and an 8 MiB dictionary, as the JAX package does (the
# bytes must match). Decode with a 64 MiB dictionary: a raw LZMA2 decoder
# needs a dictionary at least as large as the encoder's, and 64 MiB covers
# every archive either package writes.
_XZ_ENCODE = [{"id": lzma.FILTER_LZMA2, "preset": 9 | lzma.PRESET_EXTREME,
               "dict_size": 1 << 23}]
_XZ_DECODE = [{"id": lzma.FILTER_LZMA2, "dict_size": 1 << 26}]

_RC_FAMILIES = ("o1rc", "o2rc", "dnarc")
DEVICE_CODECS = ("trans", "trans1", "trans2", "dzt")


def _split(name: str) -> tuple[int, str]:
    if name.startswith("p") and ":" in name:
        stride, base = name.split(":", 1)
        return int(stride[1:]), base
    return 1, name


def _deinterleave(data: bytes, stride: int) -> bytes:
    if stride == 1 or len(data) % stride:
        return data
    return np.frombuffer(data, np.uint8).reshape(-1, stride).T.tobytes()


def _interleave(data: bytes, stride: int) -> bytes:
    if stride == 1 or len(data) % stride:
        return data
    return np.frombuffer(data, np.uint8).reshape(stride, -1).T.tobytes()


def is_device_codec(name: str) -> bool:
    """Whether ``name`` (a codec or the "device" table) needs the
    on-device entropy coders."""
    return name == "device" or _split(name)[1] in DEVICE_CODECS


def _need(device, base: str):
    if device is None:
        raise ValueError(f"codec {base!r} codes on a device: pass device=")
    return device


def compress(name: str, data: bytes, device=None) -> bytes:
    """``device`` is used by the on-device codecs only."""
    stride, base = _split(name)
    data = _deinterleave(data, stride)
    if base == "store":
        return data
    if base == "xz":
        return lzma.compress(data, format=lzma.FORMAT_RAW, filters=_XZ_ENCODE)
    if base == "bz2":
        return bz2.compress(data, 9)
    if base == "zlib":
        return zlib.compress(data, 9)
    if base == "dz":
        return native.dz_encode(data)
    if base in _RC_FAMILIES:
        return native.rc_encode(base, data)
    if base == "trans":
        return device_rans.compress(data, _need(device, base))
    if base in ("trans1", "trans2"):
        return device_ctx_rans.compress(data, int(base[-1]),
                                        _need(device, base))
    if base == "dzt":
        return device_ctx_rans.compress_dz(data, _need(device, base))
    raise ValueError(f"unknown codec {name!r}")


def decompress(name: str, data: bytes, raw_len: int, device=None) -> bytes:
    stride, base = _split(name)
    if base == "store":
        out = data
    elif base == "xz":
        out = lzma.decompress(data, format=lzma.FORMAT_RAW,
                              filters=_XZ_DECODE)
    elif base == "bz2":
        out = bz2.decompress(data)
    elif base == "zlib":
        out = zlib.decompress(data)
    elif base == "dz":
        out = native.dz_decode(data, raw_len)
    elif base in _RC_FAMILIES:
        out = native.rc_decode(base, data, raw_len)
    elif base == "trans":
        out = device_rans.decompress(data, _need(device, base))
    elif base in ("trans1", "trans2"):
        out = device_ctx_rans.decompress(data, _need(device, base))
    elif base == "dzt":
        out = device_ctx_rans.decompress_dz(data, _need(device, base))
    else:
        raise ValueError(f"unknown codec {name!r}")
    return _interleave(out, stride)


def available(name: str) -> bool:
    """Whether codec ``name`` can run here: the range coders, dz and dzt
    need the host library, which is built at first use (False where that
    build fails); every other codec is stdlib or runs on the ``device``
    passed to ``compress``."""
    if _split(name)[1] in _RC_FAMILIES + ("dz", "dzt"):
        try:
            native._load()
        except (OSError, RuntimeError):
            return False
    return True


def best_of(candidates: list[str], data: bytes,
            device=None) -> tuple[str, bytes]:
    """The smallest encoding among ``candidates`` (first wins ties)."""
    best = None
    for name in candidates:
        blob = compress(name, data, device)
        if best is None or len(blob) < len(best[1]):
            best = (name, blob)
    return best
