"""The port's consensus vote (minicom_tpu_torch.ops.consensus), in its plain
PyTorch version on the CPU and as the kernel's tile plan run by a numpy
executor of it, against the JAX package's device programs (the one-block
fused program and the multi-block scatter / finalize / diffs chain) and the
host C++ twin. All comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minicom_tpu.ops.consensus import (consensus_finalize,
                                       consensus_fused_rid_u,
                                       member_diffs_packed_rid_u,
                                       scatter_counts_rid_u)
from minicom_tpu.ops.pack import unpack_2bit_words
from minicom_tpu_torch import native
from minicom_tpu_torch.ops import consensus
from minicom_tpu_torch.ops.consensus import (TILE, consensus_vote,
                                             consensus_vote_flat)


def _members(rng, N=600, L=73, C=50):
    """Random clusters anchored at column 0, both strands."""
    codes = rng.integers(0, 4, (N, L), dtype=np.uint8)
    sizes = rng.integers(1, 30, C)
    seg = np.repeat(np.arange(C), sizes)
    off = rng.integers(0, 50, len(seg))
    segptr = np.r_[0, np.cumsum(sizes)]
    off[segptr[:-1]] = 0
    mx = np.zeros(C, np.int64)
    np.maximum.at(mx, seg, off)
    colptr = np.r_[0, np.cumsum(mx + L)]
    rd = rng.integers(0, N, len(seg)) * 2 + rng.integers(0, 2, len(seg))
    return codes, rd, colptr[seg] + off, segptr, colptr


def _port(codes, rd, col, span, want_ref=True, want_diffs=True):
    ref, diffs = consensus_vote(torch.from_numpy(codes), torch.from_numpy(rd),
                                torch.from_numpy(col), span, want_ref,
                                want_diffs)
    return (None if ref is None else ref.numpy(),
            None if diffs is None else diffs.numpy())


def _packed_upload(rd, col, step, Tp):
    """The JAX [n_chunks, 2, step] int32 member upload; padding members
    scatter out of range."""
    n = -(-len(rd) // step)
    u = np.zeros((2, n * step), np.int32)
    u[1] = Tp
    u[0, :len(rd)] = rd
    u[1, :len(rd)] = col
    return jnp.asarray(u.reshape(2, n, step).transpose(1, 0, 2))


def test_matches_fused_program(rng):
    codes, rd, col, _, colptr = _members(rng)
    span, M = int(colptr[-1]), len(rd)
    Tp = 1 << max(4, (span - 1).bit_length())
    u = _packed_upload(rd, col, 1 << 13, Tp)
    packed, diffs = consensus_fused_rid_u(jnp.asarray(codes), u[0], Tp)
    ref, got_diffs = _port(codes, rd, col, span)
    np.testing.assert_array_equal(
        ref, unpack_2bit_words(np.asarray(packed), span))
    np.testing.assert_array_equal(got_diffs,
                                  np.asarray(diffs)[:M].astype(np.int32))


def test_matches_multi_block_chain(rng):
    codes, rd, col, _, colptr = _members(rng, N=900, L=100, C=80)
    span = int(colptr[-1])
    want_ref, want_diffs = _jax_chain(codes, rd, col, span, step=128)
    ref, got_diffs = _port(codes, rd, col, span)
    np.testing.assert_array_equal(ref, want_ref)
    np.testing.assert_array_equal(got_diffs, want_diffs)


@pytest.mark.parametrize("want_ref,want_diffs",
                         [(True, True), (True, False), (False, True)])
def test_matches_host_twin(rng, want_ref, want_diffs):
    codes, rd, col, segptr, colptr = _members(rng)
    span = int(colptr[-1])
    ref, diffs = _port(codes, rd, col, span, want_ref, want_diffs)
    href, hdiffs = native.consensus_host(codes, rd.astype(np.int32), col,
                                         segptr, colptr, span, True, True)
    assert (ref is None) != want_ref and (diffs is None) != want_diffs
    if want_ref:
        np.testing.assert_array_equal(ref, href)
    if want_diffs:
        np.testing.assert_array_equal(diffs, hdiffs)


def test_tie_rule_and_strands():
    # two members disagreeing at every column tie -> lowest code wins; a
    # reverse-strand member votes with its reverse complement
    L = 16
    g, c = np.full(L, 2, np.uint8), np.full(L, 1, np.uint8)
    codes = np.stack([g, c, c])
    ref, diffs = _port(codes, np.array([0, 2]), np.array([0, 0]), L)
    assert (ref == 1).all()
    np.testing.assert_array_equal(diffs, [L, 0])
    # rc(C...) = G...: G twice vs C once
    ref, diffs = _port(codes, np.array([0, 3, 4]), np.array([0, 0, 0]), L)
    assert (ref == 2).all()
    np.testing.assert_array_equal(diffs, [0, 0, L])


def test_validates_members():
    codes = torch.zeros((4, 10), dtype=torch.uint8)
    with pytest.raises(IndexError):    # column past the span
        consensus_vote(codes, torch.tensor([0]), torch.tensor([5]), 12)
    with pytest.raises(IndexError):    # rid past the store
        consensus_vote(codes, torch.tensor([8]), torch.tensor([0]), 12)


def _clusters(rng, sizes, spread, L=73, N=700, pad=0, shuffle=True):
    """Clusters of ``sizes`` members, first columns drawn from 0..spread[c]
    (one member at 0), each cluster ``pad`` columns wider than its members
    reach (columns no member covers); members shuffled within a cluster.
    Returns (codes, rd, col, seg_ptr, col_ptr)."""
    codes = rng.integers(0, 4, (N, L), dtype=np.uint8)
    C = len(sizes)
    seg = np.repeat(np.arange(C), sizes)
    off = (rng.random(len(seg)) * (np.repeat(spread, sizes) + 1)).astype(
        np.int64)
    seg_ptr = np.r_[0, np.cumsum(sizes)].astype(np.int64)
    if shuffle:
        for a, b in zip(seg_ptr[:-1], seg_ptr[1:]):
            off[a:b] = rng.permutation(off[a:b])
    off[seg_ptr[:-1][sizes > 0] + rng.integers(0, 1 << 30, C)[sizes > 0]
        % sizes[sizes > 0]] = 0
    mx = np.full(C, -L - pad, np.int64)
    np.maximum.at(mx, seg, off)
    col_ptr = np.r_[0, np.cumsum(mx + L + pad)].astype(np.int64)
    rd = rng.integers(0, N, len(seg)) * 2 + rng.integers(0, 2, len(seg))
    return codes, rd, col_ptr[seg] + off, seg_ptr, col_ptr


def _orient(codes, rd):
    rows = codes[rd >> 1].astype(np.int64)
    rc = np.where(rows < 4, 3 - rows, rows)[:, ::-1]
    return np.where((rd & 1).astype(bool)[:, None], rc, rows)


def _run_plan(codes, rd, col, seg_ptr, col_ptr, want_ref, want_diffs,
              tile=TILE):
    """The kernel's work, tile by tile, in numpy: each tile counts the bases
    its members put in its window, votes, writes the columns it owns and
    the diffs of the members that start in them. Every column and every
    member must be written by exactly one tile."""
    L, span, M = codes.shape[1], int(col_ptr[-1]), len(rd)
    tiles, idx = consensus._plan(col, seg_ptr, col_ptr, L, tile)
    ref, diffs = np.zeros(span, np.uint8), np.zeros(M, np.int32)
    ref_n, diff_n = np.zeros(span, int), np.zeros(M, int)
    for w0, w1, r1, i0, i1, ind in tiles:
        assert w0 < r1 <= w1 <= r1 + L - 1 and w1 - w0 <= tile + L - 1
        mem = idx[i0:i1] if ind else np.arange(i0, i1)
        oc = _orient(codes, rd[mem])
        p = col[mem][:, None] - w0 + np.arange(L)
        ok = (oc < 4) & (p >= 0) & (p < w1 - w0)
        cnt = np.zeros((w1 - w0, 4), np.int64)
        np.add.at(cnt, (p[ok], oc[ok]), 1)
        vote = cnt.argmax(axis=1)   # the first maximum
        ref[w0:r1] = vote[:r1 - w0]
        ref_n[w0:r1] += 1
        own = (col[mem] >= w0) & (col[mem] < r1)
        assert (p[own] < w1 - w0).all()
        diffs[mem[own]] = (vote[p[own]] != oc[own]).sum(axis=1)
        diff_n[mem[own]] += 1
    assert (ref_n == 1).all() and (diff_n == 1).all()
    return tiles, (ref if want_ref else None), (diffs if want_diffs else None)


def _jax_chain(codes, rd, col, span, step=256):
    """The JAX multi-block scatter / finalize / diffs chain."""
    Tp = 1 << max(4, (span - 1).bit_length())
    u = _packed_upload(rd, col, step, Tp)
    table = jnp.zeros((Tp, 4), jnp.int32)
    for i in range(u.shape[0]):
        table = scatter_counts_rid_u(table, jnp.asarray(codes), u[i])
    packed = consensus_finalize(table)
    diffs = np.concatenate([
        np.asarray(member_diffs_packed_rid_u(packed, jnp.asarray(codes), u[i]))
        for i in range(u.shape[0])])[:len(rd)].astype(np.int32)
    return unpack_2bit_words(np.asarray(packed), span), diffs


def _jax_fused(codes, rd, col, span):
    Tp = 1 << max(4, (span - 1).bit_length())
    packed, diffs = consensus_fused_rid_u(
        jnp.asarray(codes), _packed_upload(rd, col, 1 << 16, Tp)[0], Tp)
    return (unpack_2bit_words(np.asarray(packed), span),
            np.asarray(diffs)[:len(rd)].astype(np.int32))


PLAN_CASES = {   # name: (sizes, spread, pad, tile)
    # many clusters a tile, and a tile per medium cluster
    "small": (lambda r: r.integers(1, 30, 60), lambda r, C: r.integers(
        0, 50, C), 0, 1024),
    "medium": (lambda r: r.integers(2, 20, 12), lambda r, C: r.integers(
        60, 180, C), 0, 256),
    # clusters many tiles wide, members in no order
    "wide": (lambda r: r.integers(50, 400, 6), lambda r, C: r.integers(
        300, 3000, C), 0, 256),
    "mixed": (lambda r: r.integers(1, 200, 40), lambda r, C: r.choice(
        [0, 40, 150, 900, 2500], C), 5, 256),
    # the default tile: clusters of ~100 columns and one of 5,000
    "default": (lambda r: np.r_[r.integers(1, 15, 300), 500],
                lambda r, C: np.r_[r.integers(0, 40, C - 1), 4900], 0, TILE),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_matches_plain_jax_and_host(name):
    """The tile plan run tile by tile == the plain version == the JAX fused
    program == the JAX multi-block chain == the host twin, ref and
    diffs."""
    rng = np.random.default_rng(len(name))
    sizes_f, spread_f, pad, tile = PLAN_CASES[name]
    sizes = sizes_f(rng)
    codes, rd, col, seg_ptr, col_ptr = _clusters(
        rng, sizes, spread_f(rng, len(sizes)), pad=pad)
    span = int(col_ptr[-1])
    tiles, ref, diffs = _run_plan(codes, rd, col, seg_ptr, col_ptr, True,
                                  True, tile)
    pref, pdiffs = consensus_vote_flat(torch.from_numpy(codes), rd, col,
                                       seg_ptr, col_ptr, span)
    jref, jdiffs = _jax_fused(codes, rd, col, span)
    cref, cdiffs = _jax_chain(codes, rd, col, span)
    href, hdiffs = native.consensus_host(codes, rd, col, seg_ptr, col_ptr,
                                         span, True, True)
    for want in (pref, jref, cref, href):
        np.testing.assert_array_equal(ref, want)
    for want in (pdiffs, jdiffs, cdiffs, hdiffs):
        np.testing.assert_array_equal(diffs, want)
    per_tile = [np.searchsorted(seg_ptr, [t[3], t[4]]) for t in tiles
                if not t[5]]
    if name == "small":    # tiles with many clusters
        assert max(b - a for a, b in per_tile) > 3
    if name in ("wide", "mixed", "default"):   # clusters cut into tiles
        assert tiles[:, 5].any()


def test_plan_with_n_ties_empty_and_uncovered_columns():
    """All-N rows, N bases, ties, clusters with columns no member covers
    and a cluster without members: the plan == the plain version == the
    JAX program (the host twin takes codes 0..3 only)."""
    rng = np.random.default_rng(3)
    sizes = np.r_[rng.integers(1, 6, 30), 0, 2, 40]
    codes, rd, col, seg_ptr, col_ptr = _clusters(
        rng, sizes, np.r_[rng.integers(0, 30, 31), 0, 700], pad=7, N=50)
    codes[:5] = 4                                   # all-N rows
    codes[rng.random(codes.shape) < 0.05] = 4
    span = int(col_ptr[-1])
    _, ref, diffs = _run_plan(codes, rd, col, seg_ptr, col_ptr, True, True,
                              128)
    pref, pdiffs = consensus_vote_flat(torch.from_numpy(codes), rd, col,
                                       seg_ptr, col_ptr, span)
    jref, jdiffs = _jax_fused(codes, rd, col, span)
    np.testing.assert_array_equal(ref, pref)
    np.testing.assert_array_equal(ref, jref)
    np.testing.assert_array_equal(diffs, pdiffs)
    np.testing.assert_array_equal(diffs, jdiffs)
    # two members that disagree at every column tie, to the lower code
    codes = np.stack([np.full(300, 2, np.uint8), np.full(300, 1, np.uint8)])
    args = (np.array([0, 2]), np.array([0, 0]), np.array([0, 2]),
            np.array([0, 300]))
    _, ref, diffs = _run_plan(codes, *args, True, True, 128)
    assert (ref == 1).all()
    np.testing.assert_array_equal(diffs, [300, 0])


def test_plan_empty():
    codes = np.zeros((3, 20), np.uint8)
    z = np.zeros(0, np.int64)
    tiles, ref, diffs = _run_plan(codes, z, z, np.zeros(1, np.int64),
                                  np.zeros(1, np.int64), True, True)
    assert len(tiles) == 0 and len(ref) == 0 and len(diffs) == 0
    ref, diffs = consensus_vote_flat(torch.from_numpy(codes), z, z, [0],
                                     [0], 0)
    assert len(ref) == 0 and len(diffs) == 0


@pytest.mark.parametrize("want_ref,want_diffs", [(True, True), (True, False),
                                                 (False, True),
                                                 (False, False)])
def test_flat_outputs_as_asked(want_ref, want_diffs):
    rng = np.random.default_rng(5)
    codes, rd, col, seg_ptr, col_ptr = _clusters(
        rng, rng.integers(1, 20, 25), rng.integers(0, 400, 25))
    span = int(col_ptr[-1])
    _, ref, diffs = _run_plan(codes, rd, col, seg_ptr, col_ptr, want_ref,
                              want_diffs, 256)
    got = consensus_vote_flat(torch.from_numpy(codes), rd, col, seg_ptr,
                              col_ptr, span, want_ref, want_diffs)
    for g, w in zip(got, (ref, diffs)):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g, w)
    # the tensor entry, one cluster of members in any order, agrees
    t_ref, t_diffs = consensus_vote(
        torch.from_numpy(codes), torch.from_numpy(rd), torch.from_numpy(col),
        span, want_ref, want_diffs)
    for g, w in zip((t_ref, t_diffs), (ref, diffs)):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("case", ["rid", "before", "past", "ptr", "span"])
def test_flat_validates_on_the_host(case):
    """Bad members raise IndexError, bad pointers ValueError, before the
    read store is touched: a store on the meta device has no data to
    read."""
    codes = torch.empty((4, 10), dtype=torch.uint8, device="meta")
    rd, col = np.array([0, 2]), np.array([0, 12])
    seg_ptr, col_ptr, span = np.array([0, 1, 2]), np.array([0, 12, 24]), 24
    err = IndexError
    if case == "rid":
        rd = np.array([0, 8])
    elif case == "before":
        col = np.array([0, 11])
    elif case == "past":
        col = np.array([3, 12])
    elif case == "ptr":
        seg_ptr, err = np.array([0, 2, 1]), ValueError
    else:
        span, err = 30, ValueError
    with pytest.raises(err):
        consensus_vote_flat(codes, rd, col, seg_ptr, col_ptr, span)
    if case == "rid":   # the valid call goes on to the device and refuses
        with pytest.raises(ValueError):
            consensus_vote_flat(codes, np.array([0, 2]), col, seg_ptr,
                                col_ptr, span)
