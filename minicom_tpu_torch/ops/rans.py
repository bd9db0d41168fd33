"""Interleaved 128-lane rANS: the encode and decode scans of the on-device
entropy codecs (``entropy/device_rans.py``, codec "trans"; and
``entropy/device_ctx_rans.py``, codecs "trans1", "trans2" and "dzt").

32-bit states in [2^16, 2^32), 16-bit renormalisation, M = 2^12. Order-0 is
the context coder with C = 1 context and A = 256 symbols, so one encode and
one decode serve both codecs; the lane layout and the validity mask are the
caller's.

Each wrapper launches its CUDA kernel (``csrc/rans.cu``) on CUDA tensors and
runs its plain PyTorch version on CPU tensors; both compute, bit for bit, the
JAX package's ``_encode_program`` / ``_decode_program``. The plain versions
loop over the scan steps in Python on [128] tensors and carry u32 values in
int64 masked to 32 bits (CPU PyTorch has no shifts or compares on uint32).
"""

from __future__ import annotations

import torch

from minicom_tpu_torch.ops import cuda

LANES = 128
M_BITS = 12
M = 1 << M_BITS
RANS_L = 1 << 16
U32_MAX = 0xFFFFFFFF


def _encode_plain(f, c, valid):
    T = f.shape[0]
    dev = f.device
    f = f.to(torch.int64).clamp_min(1)
    c = c.to(torch.int64)
    valid = valid.to(torch.bool)
    x = torch.full((LANES,), RANS_L, dtype=torch.int64, device=dev)
    emit = torch.zeros((T, LANES), dtype=torch.bool, device=dev)
    word = torch.zeros((T, LANES), dtype=torch.int64, device=dev)
    for t in range(T - 1, -1, -1):     # the rANS stack: last symbol first
        ft, vt = f[t], valid[t]
        e = ((x >> 20) >= ft) & vt
        emit[t] = e
        word[t] = x & 0xFFFF
        xr = torch.where(e, x >> 16, x)
        xn = (((xr // ft) << M_BITS) | ((xr % ft) + c[t])) & U32_MAX
        x = torch.where(vt, xn, x)     # pad steps pass the state through
    # compaction: lane l's words in forward time order in rows 0..count-1
    counts = emit.sum(dim=0, dtype=torch.int32)
    pos = torch.cumsum(emit.to(torch.int64), dim=0) - 1
    lane = torch.arange(LANES, device=dev).expand(T, LANES)
    out = torch.zeros((T, LANES), dtype=torch.int64, device=dev)
    out[pos[emit], lane[emit]] = word[emit]
    return x.to(torch.uint32), out.to(torch.uint16), counts


def rans_encode(f: torch.Tensor, c: torch.Tensor, valid: torch.Tensor):
    """Reverse rANS scan of a [T, 128] grid of coding slots.

    f, c: [T, 128] uint32 frequency and cumulative frequency of each slot's
    symbol (pad slots may hold 0; they are coded as f = 1 and discarded);
    valid: [T, 128] bool. Returns (states [128] uint32, words [T, 128]
    uint16, counts [128] int32): each lane's final state, and its emitted
    16-bit words in forward time order in rows 0..counts-1, zeros below.
    Replaces ``device_rans._encode_program`` and
    ``device_ctx_rans._encode_program``."""
    for t, dt, nm in ((f, torch.uint32, "f"), (c, torch.uint32, "c"),
                      (valid, torch.bool, "valid")):
        cuda.check(t, dt, 2, nm)
        if t.shape[1] != LANES or t.shape != f.shape:
            raise ValueError(f"{nm}: want [T, {LANES}], got {tuple(t.shape)}")
        if t.device != f.device:
            raise ValueError("f, c and valid on different devices")
    if f.device.type == "cpu":
        return _encode_plain(f, c, valid)
    cuda.require_cuda(f)
    dev = f.device
    T = f.shape[0]
    states = torch.empty(LANES, dtype=torch.uint32, device=dev)
    words = torch.empty((T, LANES), dtype=torch.uint16, device=dev)
    counts = torch.empty(LANES, dtype=torch.int32, device=dev)
    cuda.launch("mtc_rans_encode", f, c, valid, T, states, words, counts)
    return states, words, counts


def _decode_plain(states, words, valid, freq, cum, slot_sym, A, C):
    T, W = valid.shape[0], words.shape[0]
    dev = states.device
    x = states.to(torch.int64)
    words = words.to(torch.int64)
    freq, cum = freq.to(torch.int64), cum.to(torch.int64)
    slot_sym = slot_sym.to(torch.int64)
    valid = valid.to(torch.bool)
    ptr = torch.zeros(LANES, dtype=torch.int64, device=dev)
    ctx = torch.zeros(LANES, dtype=torch.int64, device=dev)
    lanes = torch.arange(LANES, device=dev)
    out = torch.empty((T, LANES), dtype=torch.uint8, device=dev)
    for t in range(T):
        v = valid[t]
        slot = x & (M - 1)
        s = slot_sym[ctx * M + slot]
        j = ctx * A + s
        xn = (freq[j] * (x >> M_BITS) + slot - cum[j]) & U32_MAX
        need = (xn < RANS_L) & v
        nxt = words[ptr.clamp(max=W - 1), lanes]
        xn = torch.where(need, ((xn << 16) | nxt) & U32_MAX, xn)
        ptr = ptr + need
        x = torch.where(v, xn, x)
        ctx = torch.where(v, (ctx * A + s) % C, ctx)
        out[t] = s
    return out


def rans_decode(states: torch.Tensor, words: torch.Tensor,
                valid: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor,
                slot_sym: torch.Tensor, A: int, C: int) -> torch.Tensor:
    """Forward rANS scan: [T, 128] uint8 symbol ids, one per slot (pad slots
    included, as the JAX program gives them).

    states: [128] uint32; words: [W, 128] uint16, W >= 1, each lane's words
    in read order (a lane past its last word reads row W-1); valid: [T, 128]
    bool; freq, cum: [C * A] uint32 rows of the C contexts; slot_sym:
    [C * 4096] uint8 slot -> symbol per context. The context of a lane starts
    at 0 and advances on valid steps as ctx' = (ctx * A + s) mod C; order-0
    is C = 1, A = 256. Replaces ``device_rans._decode_program`` and
    ``device_ctx_rans._decode_program``."""
    dev = states.device
    for t, dt, nd, nm in ((states, torch.uint32, 1, "states"),
                          (words, torch.uint16, 2, "words"),
                          (valid, torch.bool, 2, "valid"),
                          (freq, torch.uint32, 1, "freq"),
                          (cum, torch.uint32, 1, "cum"),
                          (slot_sym, torch.uint8, 1, "slot_sym")):
        cuda.check(t, dt, nd, nm)
        if t.device != dev:
            raise ValueError("rans_decode: tensors on different devices")
    if (states.shape[0] != LANES or words.shape[1] != LANES
            or words.shape[0] < 1 or valid.shape[1] != LANES):
        raise ValueError("rans_decode: want states [128], words [W>=1, 128] "
                         "and valid [T, 128]")
    if not (1 <= A <= 256 and C >= 1 and freq.shape[0] == C * A
            and cum.shape[0] == C * A and slot_sym.shape[0] == C * M):
        raise ValueError(f"rans_decode: tables do not fit A={A}, C={C}")
    if dev.type == "cpu":
        return _decode_plain(states, words, valid, freq, cum, slot_sym, A, C)
    cuda.require_cuda(states)
    T = valid.shape[0]
    syms = torch.empty((T, LANES), dtype=torch.uint8, device=dev)
    if T:
        cuda.launch("mtc_rans_decode", states, words, words.shape[0], valid,
                    T, freq, cum, slot_sym, A, C, syms)
    return syms
