"""Interleaved 128-lane rANS: the encode and decode scans of the on-device
entropy codecs (``entropy/device_rans.py``, codec "trans"; and
``entropy/device_ctx_rans.py``, codecs "trans1", "trans2" and "dzt").

32-bit states in [2^16, 2^32), 16-bit renormalisation, M = 2^12. Order-0 is
the context coder with C = 1 context and A = 256 symbols, so one encode and
one decode serve both codecs; both derive a block's lane layout from its
symbol count and its layout flag (strided or chunked lanes).

Each wrapper launches its CUDA kernel (``csrc/rans.cu``) on CUDA tensors and
runs its plain PyTorch version on CPU tensors; both compute, bit for bit, the
JAX package's ``_encode_program`` / ``_decode_program``. The plain versions
loop over the scan steps in Python on [128] tensors and carry u32 values in
int64 masked to 32 bits (CPU PyTorch has no shifts or compares on uint32).

Both work on a batch, one descriptor row per block, one kernel launch
whatever the number of blocks. ``rans_encode_blocks`` takes a stream's
symbol ids and each block's u16 frequency rows and gives what the block
headers hold: states, words per lane, the lane streams.
``rans_decode_blocks`` takes exactly that and gives the symbols back;
``rans_decode`` is its single-block call with the JAX programs' arguments.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from minicom_tpu_torch.ops import cuda

LANES = 128
M_BITS = 12
M = 1 << M_BITS
RANS_L = 1 << 16
U32_MAX = 0xFFFFFFFF

# columns of a block descriptor row (int64; offsets in elements of their
# buffer), as csrc/rans.cu reads them; the wrapper appends one more column,
# whether the block's slot table is built in shared memory
(D_WORDS, D_NWORDS, D_FREQ, D_OUT, D_N, D_T, D_W, D_A, D_C,
 D_CHUNKED) = range(10)
DESC_FIELDS = 10
# the kernel's shared-memory layout (``_kernel_layout_agrees`` holds these
# against csrc/rans.cu): the dynamic shared memory a Hopper block may opt in
# to; the bytes before the cumulative rows (128 lane counts and the word
# ring, 4 granules of 16 bytes a lane)
SMEM_MAX = 232448
SMEM_FIXED = LANES * 4 + 4 * LANES * 16
GRANULE_WORDS = 8      # a lane reads its words 16 bytes at a time

# columns of an encode descriptor row (int64; offsets in elements of their
# buffer): a block's n symbols from E_SYMS, its [C, A] frequency rows from
# E_FREQ, and from E_WORDS the n words that the output keeps for it (a block
# emits at most one word per symbol). The wrapper appends the order k and
# which of the kernel's two tables the block gets.
(E_SYMS, E_FREQ, E_WORDS, E_N, E_T, E_A, E_C, E_CHUNKED) = range(8)
ENC_FIELDS = 8
MAX_ORDER = 4          # the encode scan weighs the four symbols before a slot
# encode's bytes before a block's table: 128 lane counts, 128 lane offsets,
# the reciprocal (8 bytes) of every frequency 1..M
ENC_SMEM_FIXED = 2 * LANES * 4 + M * 8


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


def _smem(A: int, C: int) -> tuple[int, bool]:
    """(dynamic shared memory bytes of a block, whether its slot -> symbol
    table is built there): the fixed part, C cumulative rows of pow2 >=
    max(A, 2) u16 ending on a 16-byte boundary, and the C * 4096 table where
    it fits."""
    P = max(2, 1 << (A - 1).bit_length())
    rows = SMEM_FIXED + -(-C * P * 2 // 16) * 16
    lut = rows + C * M <= SMEM_MAX
    return rows + (C * M if lut else 0), lut


def _u16(t: torch.Tensor) -> torch.Tensor:
    """uint16 values as int64 (through int16: every op exists for it)."""
    return t.view(torch.int16).to(torch.int64) & 0xFFFF


def _tables_plain(freq: torch.Tensor, A: int, C: int):
    """The tables the kernel derives in shared memory from a block's [C * A]
    uint16 frequency rows, as int64 (freq [C * A], cum [C * A], slot_sym
    [C * 4096]). The kernel keeps inclusive cumulative rows and finds the
    symbol of a slot as the count of entries <= slot (so zero-frequency
    symbols are stepped over), never counting the last entry of a row or
    any entry of a row of sum 0 (an unused context: symbol 0, f = 0,
    c = 0)."""
    f = _u16(freq).view(C, A)
    incl = torch.cumsum(f, dim=1)
    used = incl[:, A - 1:] > 0
    never = 1 << 14     # above every slot
    keys = torch.where(used, incl, never)
    keys[:, A - 1] = never
    slots = torch.arange(M, device=freq.device).expand(C, M).contiguous()
    slot_sym = torch.searchsorted(keys, slots, right=True)
    return (f * used).reshape(-1), ((incl - f) * used).reshape(-1), \
        slot_sym.reshape(-1)


def _word_matrix(flat: torch.Tensor, counts: torch.Tensor, W: int
                 ) -> torch.Tensor:
    """Concatenated lane streams -> the [W, 128] int64 word matrix (lane
    l's words in rows 0..counts[l]-1, zeros below; lanes kept inside
    ``flat``, as the kernel keeps them)."""
    nw = flat.shape[0]
    counts = counts.to(torch.int64)
    starts = (torch.cumsum(counts, 0) - counts).clamp(max=nw)
    counts = torch.minimum(counts, nw - starts)
    lane = torch.repeat_interleave(torch.arange(LANES, device=flat.device),
                                   counts)
    src = torch.arange(lane.shape[0], device=flat.device)
    pos = src - (torch.cumsum(counts, 0) - counts)[lane]
    keep = pos < W
    words = torch.zeros((W, LANES), dtype=torch.int64, device=flat.device)
    words[pos[keep], lane[keep]] = _u16(flat)[(starts[lane] + pos)[keep]]
    return words


def _valid_plain(n: int, T: int, chunked: bool, device) -> torch.Tensor:
    """[T, 128] bool: the slots that hold one of the block's n symbols."""
    t = torch.arange(T, device=device)[:, None]
    l = torch.arange(LANES, device=device)[None, :]
    return (l * T + t if chunked else t * LANES + l) < n


def _decode_blocks_plain(head, words, freq, desc, out_size):
    out = torch.empty(out_size, dtype=torch.uint8, device=head.device)
    for b, d in enumerate(desc.tolist()):
        T, W, A, C = d[D_T], d[D_W], d[D_A], d[D_C]
        tables = _tables_plain(freq[d[D_FREQ]: d[D_FREQ] + C * A], A, C)
        wm = _word_matrix(words[d[D_WORDS]: d[D_WORDS] + d[D_NWORDS]],
                          head[b, LANES:], W)
        valid = _valid_plain(d[D_N], T, bool(d[D_CHUNKED]), head.device)
        out[d[D_OUT]: d[D_OUT] + T * LANES] = _decode_plain(
            head[b, :LANES], wm, valid, *tables, A, C).view(-1)
    return out


def _plan(head, words, freq, desc, out_size):
    """Check a batch against its descriptors (on the host; one sync for
    the row sums) and return the kernel's descriptor tensor, on the CPU
    (``desc`` plus the slot-table column), and its dynamic shared memory
    bytes. Raises ValueError on what the kernel does not take."""
    dev = head.device
    cuda.check(head, torch.uint32, 2, "head")
    cuda.check(words, torch.uint16, 1, "words")
    cuda.check(freq, torch.uint16, 1, "freq")
    cuda.check(desc, torch.int64, 2, "desc")
    if words.device != dev or freq.device != dev:
        raise ValueError("rans_decode_blocks: tensors on different devices")
    if desc.device.type != "cpu" or desc.shape[1] != DESC_FIELDS:
        raise ValueError(f"desc: want [B, {DESC_FIELDS}] on the CPU")
    if max(words.shape[0], out_size) >= 1 << 31:
        raise ValueError("rans_decode_blocks: the kernel indexes with 32 "
                         "bits; split the batch")
    B = desc.shape[0]
    if head.shape != (B, 2 * LANES):
        raise ValueError(f"head: want [{B}, {2 * LANES}]")
    rows = desc.tolist()
    smem, lut = 0, []
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    for d in rows:
        T, W, A, C = d[D_T], d[D_W], d[D_A], d[D_C]
        if not (1 <= A <= 256 and C >= 1 and A * C <= 1 << 16 and T >= 1
                and W >= 1 and 0 <= d[D_N] <= T * LANES):
            raise ValueError(f"rans_decode_blocks: bad block A={A}, C={C}, "
                             f"T={T}, W={W}, n={d[D_N]}")
        need, use = _smem(A, C)
        if need > SMEM_MAX:
            raise ValueError(f"rans_decode_blocks: tables of A={A}, C={C} "
                             "do not fit in shared memory")
        smem = max(smem, need)
        lut.append(use)
        for nm, off, size, have in (
                ("words", d[D_WORDS], d[D_NWORDS], words.shape[0]),
                ("freq", d[D_FREQ], C * A, freq.shape[0]),
                ("out", d[D_OUT], T * LANES, out_size)):
            if off < 0 or size < 0 or off + size > have:
                raise ValueError(f"rans_decode_blocks: {nm} range "
                                 f"[{off}, {off + size}) outside {have}")
        # every row sums to M or (unused) 0: other rows have no slot table
        sums = _u16(freq[d[D_FREQ]: d[D_FREQ] + C * A]).view(C, A).sum(dim=1)
        bad |= ((sums != 0) & (sums != M)).any()
    if B and bool(cuda.to_host(bad)):
        raise ValueError("rans_decode_blocks: a frequency row sums to "
                         f"neither {M} nor 0")
    return torch.cat([desc, torch.tensor(lut, dtype=torch.int64).view(B, 1)],
                     dim=1).contiguous(), smem


@functools.cache
def _kernel_layout_agrees() -> None:
    """Raise unless csrc/rans.cu was built with the layout this module
    plans for."""
    got = (ctypes.c_int64 * 6)()
    cuda.lib().mtc_rans_layout(got)
    want = [DESC_FIELDS + 1, SMEM_MAX, SMEM_FIXED, GRANULE_WORDS,
            ENC_FIELDS + 2, ENC_SMEM_FIXED]
    if list(got) != want:
        raise RuntimeError(f"csrc/rans.cu layout {list(got)} != {want}")


def rans_decode_blocks(head: torch.Tensor, words: torch.Tensor,
                       freq: torch.Tensor, desc: torch.Tensor, out_size: int
                       ) -> torch.Tensor:
    """Forward rANS scan of B blocks in one kernel launch: the [out_size]
    uint8 buffer that holds each block's [T, 128] grid of symbol ids (one
    per slot, pad slots included, as the JAX programs give them) at its
    descriptor's offset.

    head: [B, 256] uint32, each block's 128 lane states then its 128 words
    per lane; words: 1-d uint16, the blocks' lane streams (each lane's words
    in read order, lanes in order; a lane past its last word reads 0, or its
    last word when it has W of them); freq: 1-d uint16, the blocks' [C, A]
    quantized frequency rows, each row summing to 4096 or (an unused
    context) to 0; ``desc``: [B, 10] int64 on the CPU, one row per block in
    the ``D_*`` columns (it is checked here and uploaded; the wrapper decides
    per block whether the slot table fits in shared memory). The context of
    a lane starts at 0 and advances on valid steps as ctx' = (ctx * A + s)
    mod C. A step is valid when its slot holds one of the block's n symbols:
    lane l owns symbols l, l + 128, ..., or with D_CHUNKED the T symbols
    from l * T.

    On CUDA tensors this launches the kernel once, whatever B is; on CPU
    tensors the plain version loops over the blocks, builds the kernel's
    tables with torch ops and runs ``_decode_plain``. Replaces
    ``device_rans._decode_program`` and ``device_ctx_rans._decode_program``
    and the loop over blocks around them."""
    dev = head.device
    full, smem = _plan(head, words, freq, desc, out_size)
    if dev.type == "cpu":
        return _decode_blocks_plain(head, words, freq, desc, out_size)
    cuda.require_cuda(head)
    _kernel_layout_agrees()
    if words.data_ptr() % (2 * GRANULE_WORDS):
        raise ValueError("words: want a buffer on a 16-byte boundary")
    syms = torch.empty(out_size, dtype=torch.uint8, device=dev)
    if len(full):
        cuda.launch("mtc_rans_decode", head, words, words.shape[0], freq,
                    cuda.to_device(full, dev), len(full), smem, syms)
    return syms


def rans_decode(states: torch.Tensor, words: torch.Tensor,
                valid: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor,
                slot_sym: torch.Tensor, A: int, C: int) -> torch.Tensor:
    """Forward rANS scan of one block: [T, 128] uint8 symbol ids, one per
    slot (pad slots included, as the JAX program gives them). The
    single-block case of ``rans_decode_blocks`` behind the arguments of
    ``device_rans._decode_program`` and ``device_ctx_rans._decode_program``.

    states: [128] uint32; words: [W, 128] uint16, W >= 1, each lane's words
    in read order (a lane past its last word reads row W-1); valid: [T, 128]
    bool, the mask of a block of n symbols in one of the two lane layouts
    (lane l owns symbols l, l + 128, ..., or the T symbols from l * T);
    freq: [C * A] uint32 rows of the C contexts, each summing to 4096 or 0;
    cum, slot_sym: [C * A] uint32 and [C * 4096] uint8, the tables of freq.
    The scan derives its tables from freq and reads neither. The context of
    a lane starts at 0 and advances on valid steps as ctx' = (ctx * A + s)
    mod C; order-0 is C = 1, A = 256."""
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
    T, W = valid.shape[0], words.shape[0]
    if T == 0:
        return torch.empty((0, LANES), dtype=torch.uint8, device=dev)
    n = int(valid.sum())
    for chunked in (False, True):
        if torch.equal(valid, _valid_plain(n, T, chunked, dev)):
            break
    else:
        raise ValueError("rans_decode: valid is not the mask of a block in "
                         "either lane layout")
    head = torch.cat([states.to(torch.int64),
                      torch.full((LANES,), W, dtype=torch.int64, device=dev)]
                     ).to(torch.uint32).view(1, 2 * LANES)
    # every lane has W words: its column of the matrix
    flat = words.view(torch.int16).t().contiguous().view(-1).view(
        torch.uint16)
    f16 = (freq.to(torch.int64) & 0xFFFF).to(torch.int16).view(torch.uint16)
    desc = torch.tensor([[0, W * LANES, 0, 0, n, T, W, A, C, int(chunked)]],
                        dtype=torch.int64)
    return rans_decode_blocks(head, flat, f16, desc, T * LANES).view(T, LANES)


# ---- encode: every block of a stream in one call ---------------------------

def _order(A: int, C: int):
    """k with A^k == C (0 where C == 1), or None."""
    k, c = 0, 1
    while c < C and A > 1:
        c *= A
        k += 1
    return k if c == C else None


def _slots_plain(syms, freq, n: int, T: int, A: int, C: int, k: int,
                 chunked: bool):
    """What the kernel finds for each slot of a block, by torch ops: ([T,
    128] int64 f and c, bool valid) from the block's n symbol ids (uint8)
    and its [C * A] uint16 frequency rows. The context of a slot is the k
    symbols before it in its lane, oldest in the highest digit, symbol 0
    before the lane's first; c is the sum of the frequencies before the
    symbol in its context's row (mod 2^16, as the kernel keeps its sums),
    f the symbol's own. Pad slots hold symbol 0."""
    dev = syms.device
    flat = torch.zeros(T * LANES, dtype=torch.int64, device=dev)
    flat[:n] = syms
    grid = flat.view(LANES, T).t() if chunked else flat.view(T, LANES)
    ctx = torch.zeros((T, LANES), dtype=torch.int64, device=dev)
    for j in range(1, min(k, T - 1) + 1):
        ctx[j:] += grid[:T - j] * A ** (j - 1)
    rows = _u16(freq).view(C, A)
    before = (torch.cumsum(rows, dim=1) - rows) & 0xFFFF
    at = ctx * A + grid
    return (rows.reshape(-1)[at], before.reshape(-1)[at],
            _valid_plain(n, T, chunked, dev))


def _encode_blocks_plain(syms, freq, full, size: int):
    B = full.shape[0]
    head = torch.zeros((B, 2 * LANES), dtype=torch.int64, device=syms.device)
    words = torch.zeros(size, dtype=torch.int16, device=syms.device)
    for b, d in enumerate(full.tolist()):
        n, T, A, C = d[E_N], d[E_T], d[E_A], d[E_C]
        states, grid, counts = _encode_plain(*_slots_plain(
            syms[d[E_SYMS]: d[E_SYMS] + n],
            freq[d[E_FREQ]: d[E_FREQ] + C * A], n, T, A, C, d[ENC_FIELDS],
            bool(d[E_CHUNKED])))
        # lane l's rows 0..counts[l]-1, lanes in order
        keep = (torch.arange(T, device=syms.device)[None, :]
                < counts[:, None])
        lanes = grid.view(torch.int16).t()[keep]
        words[d[E_WORDS]: d[E_WORDS] + lanes.shape[0]] = lanes
        head[b, :LANES] = states.to(torch.int64)
        head[b, LANES:] = counts
    return head.to(torch.uint32), words.view(torch.uint16)


def _enc_smem(A: int, C: int) -> tuple[int, bool]:
    """(dynamic shared memory bytes of a block to encode, whether its
    table is the packed one): the fixed part and a 4-byte entry f | c << 16
    for each (context, symbol) where that fits, else cumulative rows of 2
    bytes an entry."""
    packed = ENC_SMEM_FIXED + C * A * 4 <= SMEM_MAX
    return ENC_SMEM_FIXED + C * A * (4 if packed else 2), packed


def _plan_encode(syms, freq, desc):
    """Check a batch against its descriptors (on the host; one sync for
    the values) and return the kernel's descriptor tensor, on the CPU
    (``desc`` plus the order and the table columns), its dynamic shared
    memory bytes, and the size of the words buffer. Raises ValueError on
    what the kernel does not take."""
    dev = syms.device
    cuda.check(syms, torch.uint8, 1, "syms")
    cuda.check(freq, torch.uint16, 1, "freq")
    cuda.check(desc, torch.int64, 2, "desc")
    if freq.device != dev:
        raise ValueError("rans_encode_blocks: tensors on different devices")
    if desc.device.type != "cpu" or desc.shape[1] != ENC_FIELDS:
        raise ValueError(f"desc: want [B, {ENC_FIELDS}] on the CPU")
    smem, size, more, parts = 0, 0, [], []
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    for d in desc.tolist():
        n, T, A, C = d[E_N], d[E_T], d[E_A], d[E_C]
        if not (1 <= A <= 256 and C >= 1 and A * C <= 1 << 16
                and 1 <= T <= 1 << 23 and 0 <= n <= T * LANES):
            raise ValueError(f"rans_encode_blocks: bad block A={A}, C={C}, "
                             f"T={T}, n={n}")
        k = _order(A, C)
        if k is None or k > MAX_ORDER or (k and not d[E_CHUNKED]):
            raise ValueError(
                f"rans_encode_blocks: C={C} contexts over A={A} symbols: "
                f"want C = A^k, k <= {MAX_ORDER}, and k = 0 for strided "
                "lanes")
        for nm, off, size_, have in (
                ("syms", d[E_SYMS], n, syms.shape[0]),
                ("freq", d[E_FREQ], C * A, freq.shape[0]),
                ("words", d[E_WORDS], n, 1 << 31)):
            if off < 0 or off + size_ > have:
                raise ValueError(f"rans_encode_blocks: {nm} range "
                                 f"[{off}, {off + size_}) outside {have}")
        need, packed = _enc_smem(A, C)
        smem = max(smem, need)
        size = max(size, d[E_WORDS] + n)
        more.append((k, int(packed)))
        parts.append((d[E_WORDS], d[E_WORDS] + n))
        if n:       # a symbol id past its row would read another row
            bad |= syms[d[E_SYMS]: d[E_SYMS] + n].max().to(torch.int64) >= A
    parts.sort()
    if any(a[1] > b[0] for a, b in zip(parts, parts[1:])):
        raise ValueError("rans_encode_blocks: the blocks' words overlap")
    if max(syms.shape[0], freq.shape[0]) >= 1 << 31:
        raise ValueError("rans_encode_blocks: the kernel indexes with 32 "
                         "bits; split the batch")
    if freq.shape[0]:
        bad |= _u16(freq).max() > M
    if bool(cuda.to_host(bad)):
        raise ValueError("rans_encode_blocks: a symbol id outside its "
                         f"alphabet, or a frequency above {M}")
    B = desc.shape[0]
    return torch.cat([desc, torch.tensor(more, dtype=torch.int64
                                         ).view(B, 2)], dim=1).contiguous(), \
        smem, size


def rans_encode_blocks(syms: torch.Tensor, freq: torch.Tensor,
                       desc: torch.Tensor):
    """Reverse rANS scan of B blocks in one kernel launch: (head [B, 256]
    uint32, words uint16). head holds each block's 128 final lane states,
    then its 128 words per lane; words holds, from the block's E_WORDS
    offset on, its lane streams as a block header orders them: each lane's
    emitted 16-bit words in decode read order, lanes concatenated in lane
    order (the sum of the block's words per lane says how many; what lies
    beyond them, up to the n the block was given room for, is undefined).

    syms: 1-d uint8, the blocks' symbol ids, each below its block's A;
    freq: 1-d uint16, the blocks' [C, A] quantized frequency rows as their
    headers will hold them, no entry above 4096; ``desc``: [B, 8] int64 on
    the CPU, one row per block in the ``E_*`` columns (checked here and
    uploaded). Lane l owns symbols l, l + 128, ... of its block, or with
    E_CHUNKED the T symbols from l * T; slots past the block's n symbols
    pass the state through. The context of a slot is the k symbols before
    it in its lane (C = A^k, k <= 4; chunked lanes only), symbol 0 before
    the lane's first. A symbol of frequency 0 is coded as frequency 1.

    On CUDA tensors this launches the kernel once, whatever B is; on CPU
    tensors the plain version loops over the blocks, finds each slot's
    frequencies with torch ops and runs ``_encode_plain``. Replaces
    ``device_rans._encode_program`` and ``device_ctx_rans._encode_program``,
    the host gathers before them and the loop over blocks around them."""
    full, smem, size = _plan_encode(syms, freq, desc)
    dev = syms.device
    if dev.type == "cpu":
        return _encode_blocks_plain(syms, freq, full, size)
    cuda.require_cuda(syms)
    _kernel_layout_agrees()
    B = len(full)
    head = torch.empty((B, 2 * LANES), dtype=torch.uint32, device=dev)
    words = torch.empty(size, dtype=torch.uint16, device=dev)
    scratch = torch.empty(size, dtype=torch.uint16, device=dev)
    if B:
        cuda.launch("mtc_rans_encode", syms, freq, cuda.to_device(full, dev),
                    B, smem, head, scratch, words)
    return head, words
