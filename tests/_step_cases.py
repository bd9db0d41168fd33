"""Inputs of the fused cluster step's tests, one card and sharded (numpy, and
the port's plain minimizer for one case: the card's test run has no jax).
Each case is (codes [N, L] uint8 in 0..3, k, span_cols)."""

import numpy as np


def genome_codes(rng, n, L, genome_len=10_000, err=0.01):
    """Reads of a random genome as base codes, as tests/conftest.py::
    genome_reads samples them: substitutions at ``err``, half of the reads
    reverse-complemented."""
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - L, n)
    reads = genome[starts[:, None] + np.arange(L)]
    em = rng.random((n, L)) < err
    reads = np.where(em, (reads + rng.integers(1, 4, (n, L))) % 4,
                     reads).astype(np.uint8)
    flip = rng.random(n) < 0.5
    reads[flip] = np.flip(3 - reads[flip], axis=1)
    return reads


def _at_rows(rng, n, L):
    """Random reads with rows of (AT)^(L/2) among them: at even k every
    k-mer of such a row is a palindrome, so none is chosen."""
    codes = rng.integers(0, 4, (n, L), dtype=np.uint8)
    codes[::3] = np.resize(np.array([0, 3], np.uint8), L)
    return codes


def _copies(rng, n, L, m):
    """n reads of which m are copies of one read (a deep segment, whose
    columns tie where copies and others disagree)."""
    codes = rng.integers(0, 4, (n, L), dtype=np.uint8)
    codes[rng.permutation(n)[:m]] = codes[0]
    return codes


def step_cases(genome=genome_codes):
    """name -> (codes, k, span_cols); ``genome(rng, n, L)`` gives genome
    reads as codes."""
    rng = np.random.default_rng(11)
    cases = {
        # the graft entry's and the sharding test's shapes
        "random_4096x100_k31": (rng.integers(0, 4, (4096, 100), np.uint8),
                                31, 4096 * 200),
        "random_128x48_k17": (rng.integers(0, 4, (128, 48), np.uint8), 17,
                              128 * 96),
    }
    for k in (31, 17, 16):
        cases[f"genome_k{k}"] = (genome(rng, 1500, 100), k, 1500 * 200)
    cases["at_rows_k30"] = (_at_rows(rng, 300, 100), 30, 300 * 200)
    cases["at_rows_k16"] = (_at_rows(rng, 300, 100), 16, 300 * 200)
    pal = np.resize(np.array([0, 3], np.uint8), 16)
    codes = rng.integers(0, 4, (200, 16), np.uint8)
    codes[::2] = pal
    codes[1::4] = np.resize(np.array([1, 2], np.uint8), 16)   # CGCG...
    cases["palindromes_L16_k16"] = (codes, 16, 200 * 32)
    cases["copies_600"] = (_copies(rng, 700, 100, 600), 31, 700 * 200)
    codes, k, span = cases["genome_k17"]
    cases["span_below"] = (codes, k, span // 3 + 7)
    cases["span_above"] = (codes, k, span + 1001)
    return cases


def _cut(codes, k, span, n, L):
    """A case cut to its first n reads and first L bases, span_cols scaled
    with N L (N 2L stays N 2L; below and above stay below and above)."""
    N0, L0 = codes.shape
    c = np.ascontiguousarray(codes[:n, :L])
    return c, k, max(1, span * c.shape[0] * c.shape[1] // (N0 * L0))


def _deep(rng, n, L, k, m):
    """n random reads, m + 1 of them one read, the one whose key sorts last:
    its segment runs from sorted position n - m - 1 to the end."""
    import torch
    from minicom_tpu_torch.ops.step import _minimizers_plain
    codes = rng.integers(0, 4, (n, L), dtype=np.uint8)
    top = int(_minimizers_plain(torch.from_numpy(codes), k)[0].argmax())
    codes[[0, top]] = codes[[top, 0]]
    codes[1 + rng.permutation(n - 1)[:m]] = codes[0]
    return codes


def mesh_cases(genome=genome_codes):
    """The sharded step's cases: ``step_cases`` cut to 384 reads of 48
    bases, and an N that no world size of 2 or 3 divides, an empty shard
    (``mesh_split``), a segment of 301 of 384 reads that begins on rank 0
    and runs to the end (the other ranks own no segment), span_cols a
    quarter of N 2L (the last rank's columns all lie past it) and (AT)^24
    rows at k = 24 (no chosen k-mer) in an uneven N."""
    cases = {name: _cut(*case, 384, 48)
             for name, case in step_cases(genome).items()}
    rng = np.random.default_rng(12)
    cases["uneven_301"] = (genome(rng, 301, 48), 21, 301 * 96)
    cases["empty_shard"] = (genome(rng, 256, 40), 17, 256 * 80)
    cases["deep_spans_ranks"] = (_deep(rng, 384, 48, 23, 300), 23, 384 * 96)
    cases["span_past_last"] = (rng.integers(0, 4, (256, 40), np.uint8), 19,
                               256 * 80 // 4)
    cases["at_rows_k24_uneven"] = (_at_rows(rng, 250, 48), 24, 250 * 96)
    return cases


def mesh_split(name, N, world):
    """The rows of each rank for case ``name``: ~N / world each, but none on
    rank 1 of "empty_shard" (none on rank 0 where world is 2)."""
    if name == "empty_shard":
        return [0, N] if world == 2 else [N // 2, 0, N - N // 2]
    return [len(a) for a in np.array_split(np.arange(N), world)]
