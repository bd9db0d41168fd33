"""Inputs of the fused cluster step's tests (numpy only: the card's test run
has no jax). Each case is (codes [N, L] uint8 in 0..3, k, span_cols)."""

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
