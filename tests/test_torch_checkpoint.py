"""Stage checkpoint/resume of minicom_tpu_torch (device="cpu"): reruns skip
completed stages and write byte-identical archives; stale or corrupt
snapshots are ignored. The fingerprint and the snapshot format are
minicom_tpu's, so a checkpoint dir written by either package resumes in the
port."""

import dataclasses
import os

import numpy as np
import pytest

from minicom_tpu import CompressorConfig as JConfig
from minicom_tpu import compressor as jcomp
from minicom_tpu import checkpoint as jck
from minicom_tpu_torch import CompressorConfig
from minicom_tpu_torch import checkpoint as ck
from minicom_tpu_torch import compressor
from minicom_tpu_torch.stats import StageStats
from tests.conftest import genome_reads, write_fastq
from tests.test_torch_rans import jax_native  # noqa: F401 (autouse)


def _fastq(tmp_path, rng, name="in.fastq", n=600):
    path = str(tmp_path / name)
    write_fastq(path, genome_reads(rng, n, 100, genome_len=4000, err=0.01,
                                   revcomp=False))
    return path


def _compress(fq, out, ckdir, stats=None, **kw):
    return compressor.compress(fq, out, CompressorConfig(checkpoint_dir=ckdir,
                                                         **kw),
                               stats=stats, device="cpu")


def _boom(*a, **k):
    raise AssertionError("stage re-ran despite checkpoint")


def _no_stage_reruns(monkeypatch):
    monkeypatch.setattr(compressor.cluster_mod, "cluster_rounds", _boom)
    monkeypatch.setattr(compressor, "merge_contigs", _boom)
    monkeypatch.setattr(compressor, "realign_ladder", _boom)


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def test_resume_skips_stages_and_matches(tmp_path, rng, monkeypatch):
    fq = _fastq(tmp_path, rng)
    ckdir = str(tmp_path / "ck")
    _compress(fq, str(tmp_path / "a.mtc"), ckdir)
    assert sorted(os.listdir(ckdir)) == ["cluster.npz", "merge.npz",
                                         "realign.npz"]
    _no_stage_reruns(monkeypatch)
    st = StageStats()
    _compress(fq, str(tmp_path / "b.mtc"), ckdir, st)
    assert st.counters["resumed_from"] == "realign"
    assert _same_bytes(tmp_path / "a.mtc", tmp_path / "b.mtc")


def test_partial_resume_from_cluster(tmp_path, rng):
    """A resume from the cluster snapshot uploads the read store and
    re-votes in merge, so the archive is the uninterrupted run's."""
    fq = _fastq(tmp_path, rng)
    ckdir = str(tmp_path / "ck")
    _compress(fq, str(tmp_path / "a.mtc"), ckdir)
    os.unlink(os.path.join(ckdir, "merge.npz"))
    os.unlink(os.path.join(ckdir, "realign.npz"))
    st = StageStats()
    _compress(fq, str(tmp_path / "b.mtc"), ckdir, st)
    assert st.counters["resumed_from"] == "cluster"
    assert "cluster" not in st.timings
    assert "upload" in st.timings and "merge" in st.timings
    assert _same_bytes(tmp_path / "a.mtc", tmp_path / "b.mtc")


def test_stale_checkpoints_ignored(tmp_path, rng):
    fq = _fastq(tmp_path, rng)
    ckdir = str(tmp_path / "ck")
    _compress(fq, str(tmp_path / "a.mtc"), ckdir)

    # different parameters -> fingerprint mismatch -> full recompute
    st = StageStats()
    _compress(fq, str(tmp_path / "b.mtc"), ckdir, st, diff_threshold=6)
    assert "resumed_from" not in st.counters
    assert "cluster" in st.timings

    # different input content (same length) -> also ignored
    fq2 = _fastq(tmp_path, np.random.default_rng(5), "in2.fastq")
    st = StageStats()
    _compress(fq2, str(tmp_path / "c.mtc"), ckdir, st)
    assert "resumed_from" not in st.counters


def test_midfile_edit_invalidates_fingerprint(tmp_path):
    """A one-byte edit in the middle of a same-size 3 MiB input (past the
    1 MiB head and tail windows) changes the fingerprint."""
    cfg = CompressorConfig()
    p = tmp_path / "big.fastq"
    data = bytearray(os.urandom(3 << 20))
    p.write_bytes(data)
    fp0 = ck.fingerprint([str(p)], cfg)
    data[len(data) // 2] ^= 0xFF
    p.write_bytes(data)
    assert ck.fingerprint([str(p)], cfg) != fp0


def test_midfile_edit_invalidates_fingerprint_large(tmp_path):
    """Same, at a size where strided sampling is in effect: the edit lands
    on a sampled stride offset."""
    cfg = CompressorConfig()
    size = ck._HEAD_TAIL * 2 + ck._N_STRIDES * ck._STRIDE_CHUNK * 3
    p = tmp_path / "huge.fastq"
    data = bytearray(size)
    p.write_bytes(data)
    fp0 = ck.fingerprint([str(p)], cfg)
    lo, hi = ck._HEAD_TAIL, size - ck._HEAD_TAIL
    off = lo + (hi - lo) * (ck._N_STRIDES // 2) // ck._N_STRIDES
    data[off] = 0xAB
    p.write_bytes(data)
    assert ck.fingerprint([str(p)], cfg) != fp0


def test_corrupt_checkpoint_recomputed(tmp_path, rng):
    fq = _fastq(tmp_path, rng)
    ckdir = str(tmp_path / "ck")
    _compress(fq, str(tmp_path / "a.mtc"), ckdir)
    with open(os.path.join(ckdir, "realign.npz"), "wb") as f:
        f.write(b"garbage")
    st = StageStats()
    _compress(fq, str(tmp_path / "b.mtc"), ckdir, st)
    # falls back to the merge snapshot, reruns realign only
    assert st.counters["resumed_from"] == "merge"
    assert _same_bytes(tmp_path / "a.mtc", tmp_path / "b.mtc")


# ---- across packages ----------------------------------------------------

@pytest.mark.parametrize("pe", [False, True])
def test_fingerprint_matches_reference(tmp_path, pe):
    """The same files and config give the same fingerprint in both
    packages; for PE both hash the config with paired=True."""
    rng = np.random.default_rng(6)
    paths = [_fastq(tmp_path, rng, "m1.fastq", 200)]
    if pe:
        paths.append(_fastq(tmp_path, rng, "m2.fastq", 200))
    cfg = CompressorConfig(k=17, order=True, paired=pe, checkpoint_dir="x")
    want = jck.fingerprint(paths, JConfig(**dataclasses.asdict(cfg)))
    assert ck.fingerprint(paths, cfg) == want
    assert ck.fingerprint(paths, dataclasses.replace(cfg,
                                                     paired=not pe)) != want


@pytest.mark.parametrize("stage", ["realign", "cluster"])
def test_reference_checkpoint_resumes_in_port(tmp_path, rng, monkeypatch,
                                              stage):
    """A checkpoint dir written by minicom_tpu resumes in the port (PE, so
    the fingerprint covers paired=True) and gives the JAX archive."""
    fq1 = _fastq(tmp_path, rng, "m1.fastq", 300)
    fq2 = _fastq(tmp_path, rng, "m2.fastq", 300)
    ckdir = str(tmp_path / "ck")
    ja = str(tmp_path / "j.mtc")
    jcomp.compress(fq1, ja, JConfig(checkpoint_dir=ckdir), reads_path2=fq2)
    if stage == "cluster":
        os.unlink(os.path.join(ckdir, "merge.npz"))
        os.unlink(os.path.join(ckdir, "realign.npz"))
    else:
        _no_stage_reruns(monkeypatch)
    st = StageStats()
    ta = str(tmp_path / "t.mtc")
    compressor.compress(fq1, ta, CompressorConfig(checkpoint_dir=ckdir),
                        reads_path2=fq2, stats=st, device="cpu")
    assert st.counters["resumed_from"] == stage
    assert _same_bytes(ja, ta)
