"""The port's XOR-popcount verify (minicom_tpu_torch.ops.verify), in its
plain PyTorch version on the CPU, against the JAX package's XLA
``popcount_verify``, its Pallas kernel in interpret mode and the numpy
oracle of tests/test_realign.py. Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minicom_tpu.ops.pack import pack_2bit_words, popcount_u32
from minicom_tpu.ops.pallas_verify import (popcount_verify as jverify,
                                           popcount_verify_pallas)
from minicom_tpu_torch.ops.verify import popcount_verify


def _jax_both(aw, bw):
    """(XLA, Pallas-interpret) outputs; the Pallas kernel tiles 256 rows,
    so its input is zero-padded to a multiple of 256 and cut back."""
    xla = np.asarray(jverify(jnp.asarray(aw), jnp.asarray(bw)))
    pad = (-len(aw)) % 256
    z = np.zeros((pad, aw.shape[1]), np.uint32)
    pl = np.asarray(popcount_verify_pallas(
        jnp.asarray(np.concatenate([aw, z])),
        jnp.asarray(np.concatenate([bw, z])), block=256,
        interpret=True))[:len(aw)]
    return xla, pl


@pytest.mark.parametrize("N,L", [(1000, 100), (300, 150), (37, 16),
                                 (257, 31)])
def test_packed_reads_match_jax_and_oracle(N, L):
    rng = np.random.default_rng(N + L)
    a = rng.integers(0, 4, (N, L)).astype(np.uint8)
    b = a.copy()
    err = rng.random((N, L)) < 0.05
    b[err] = (b[err] + rng.integers(1, 4, int(err.sum()))) % 4
    aw, bw = pack_2bit_words(a), pack_2bit_words(b)
    got = popcount_verify(torch.from_numpy(aw), torch.from_numpy(bw))
    assert got.dtype == torch.int32 and got.shape == (N,)
    want = popcount_u32(aw ^ bw).sum(axis=1).astype(np.int32)
    xla, pl = _jax_both(aw, bw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(got.numpy(), pl)


def test_full_range_words_match_jax():
    """Arbitrary u32 words, the top bit included."""
    rng = np.random.default_rng(11)
    aw = rng.integers(0, 2**32, (1000, 7), dtype=np.uint32)
    bw = rng.integers(0, 2**32, (1000, 7), dtype=np.uint32)
    aw[0], bw[0] = 0xFFFFFFFF, 0          # 32 bits per word
    got = popcount_verify(torch.from_numpy(aw), torch.from_numpy(bw)).numpy()
    assert got[0] == 7 * 32
    for want in _jax_both(aw, bw):
        np.testing.assert_array_equal(got, want)


def test_empty_and_bad_inputs():
    z = torch.zeros((0, 7), dtype=torch.uint32)
    assert popcount_verify(z, z).shape == (0,)
    a = torch.zeros((4, 7), dtype=torch.uint32)
    with pytest.raises(ValueError):
        popcount_verify(a, a.to(torch.int64))
    with pytest.raises(ValueError):
        popcount_verify(a, a[:, :6].contiguous())
