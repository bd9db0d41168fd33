"""minicom_tpu_torch in a process group of 2 and 3 processes (gloo on the
CPU, device="cpu"): archives byte-identical to the single-process archive of
the port and of the JAX package, in every mode; sharded decode equal to the
single-process decode; the collectives and the sharded read store against
plain numpy; and two faults of the JAX package's multi-process path that the
port repairs (checkpoint writes racing on one temporary name, and a rank
whose FASTQ slice fails to parse leaving the others waiting).

Each group runs tests/_torch_dist_worker.py in subprocesses that meet
through a ``file://`` store in the test's tmp dir; one group runs several
jobs, and the tests read its results."""

import gzip
import os
import shutil

import numpy as np
import pytest

from minicom_tpu import CompressorConfig as JConfig
from minicom_tpu import compressor as jcomp
from minicom_tpu.parallel import distributed as jdist
from minicom_tpu_torch import CompressorConfig
from minicom_tpu_torch import compressor as tcomp
from minicom_tpu_torch.parallel import distributed as dist
from tests import _torch_dist_worker as worker
from tests._torch_dist_worker import job_results as _jobs
from tests._torch_dist_worker import run_group as _run_group
from tests.conftest import genome_reads, write_fastq
from tests.test_torch_rans import jax_native  # noqa: F401 (autouse)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


MODES = {   # name: (config kwargs, paired, gzip input)
    "auto": ({}, False, False),
    "order": ({"order": True}, False, False),
    "pe": ({}, True, False),
    "device": ({"codec": "device"}, False, False),
    "gzip": ({}, False, True),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The inputs of tests/test_distributed.py (1,500 x 60 bp genome reads,
    errors and Ns), PE mates of the same genome, a gzip copy; the
    single-process archives and decodes of both packages per mode."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    rng = np.random.default_rng(0)
    fq = os.path.join(tmp, "in.fastq")
    write_fastq(fq, genome_reads(rng, 1500, 60, genome_len=6000, err=0.01,
                                 p_n=0.002))
    fq2 = os.path.join(tmp, "in2.fastq")
    write_fastq(fq2, genome_reads(rng, 1500, 60, genome_len=6000, err=0.01,
                                  p_n=0.002))
    with open(fq, "rb") as src, gzip.open(fq + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    gold = {}
    for mode, (kw, pe, gz) in MODES.items():
        src, m2 = (fq + ".gz" if gz else fq), (fq2 if pe else None)
        j, t = (os.path.join(tmp, f"{mode}_{w}.mtc") for w in ("jax", "port"))
        jcomp.compress(src, j, JConfig(**kw), reads_path2=m2)
        tcomp.compress(src, t, CompressorConfig(**kw), reads_path2=m2,
                       device="cpu")
        tcomp.decompress(t, t + ".dec", t + ".dec2", device="cpu")
        gold[mode] = dict(src=src, fq2=m2, jax=_read(j), port=_read(t),
                          dec=_read(t + ".dec"),
                          dec2=_read(t + ".dec2") if pe else None)
    return dict(tmp=tmp, gold=gold)


def _mode_job(data, world, mode, **kw):
    g = data["gold"][mode]
    base = os.path.join(data["tmp"], f"g{world}_{mode}_{{rank}}")
    job = dict(op="compress", fq=g["src"], fq2=g["fq2"],
               cfg=MODES[mode][0], out=base + ".mtc", write_all=True,
               decode=base + ".dec", decode2=base + ".dec2")
    job.update(kw)
    return job


@pytest.fixture(scope="module")
def group2(data):
    """One 2-rank group: the collectives, every mode with decode, a run
    with rank-0-only writes, and a checkpointed run; then a second group
    that resumes from the checkpoints."""
    tmp = data["tmp"]
    ck = os.path.join(tmp, "ck")
    jobs = ([dict(op="collectives", out=os.path.join(tmp, "c2_{rank}.npz"))]
            + [_mode_job(data, 2, m) for m in MODES]
            + [_mode_job(data, 2, "auto", out=os.path.join(tmp, "r0_{rank}.mtc"),
                         decode=os.path.join(tmp, "r0_{rank}.dec"),
                         decode_from=os.path.join(tmp, "r0_0.mtc"),
                         write_all=False),
               _mode_job(data, 2, "auto", cfg={"checkpoint_dir": ck},
                         out=os.path.join(tmp, "ck_a.mtc"), decode=None,
                         write_all=False)])
    first = _run_group(tmp, "g2", 2, jobs)
    ck_files = sorted(os.listdir(ck))
    rerun = _run_group(tmp, "g2b", 2, [_mode_job(
        data, 2, "auto", cfg={"checkpoint_dir": ck},
        out=os.path.join(tmp, "ck_b.mtc"), decode=None, write_all=False)])
    return dict(first=first, rerun=rerun, ck_files=ck_files, ck=ck)


@pytest.fixture(scope="module")
def group3(data):
    tmp = data["tmp"]
    return _run_group(tmp, "g3", 3, [
        dict(op="collectives", out=os.path.join(tmp, "c3_{rank}.npz")),
        _mode_job(data, 3, "auto")])


@pytest.fixture(params=[2, 3])
def group(request, group2, group3):
    return request.param


@pytest.mark.parametrize("dtype", range(len(worker.DTYPES)))
def test_allgather_ragged_many_is_rank_order_concatenation(data, group,
                                                           dtype):
    """bool, int8, uint32 and int64 arrays of per-rank lengths (the last
    rank's empty) come back on every rank as the rank-order concatenation,
    in their own dtype."""
    world = group
    want = np.concatenate([worker.collective_inputs(r, world)["arrays"][dtype]
                           for r in range(world)])
    for r in range(world):
        with np.load(os.path.join(data["tmp"], f"c{world}_{r}.npz")) as z:
            got = z[f"arr_{dtype}"]
        assert got.dtype == worker.DTYPES[dtype]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["rows", "rows_all"])
def test_sharded_store_rows_equal_plain_indexing(data, group, op):
    """rows: each rank's own request list (23 rows in chunks of 5 on rank
    0, none on rank 1); rows_all: one list on every rank."""
    world = group
    for r in range(world):
        inp = worker.collective_inputs(r, world)
        with np.load(os.path.join(data["tmp"], f"c{world}_{r}.npz")) as z:
            got = z[op]
        np.testing.assert_array_equal(got, inp["codes"][inp[op]])


WEIGHTS = [np.array([5, 1, 1, 1, 8, 1, 1, 1, 1, 4]), np.zeros(0),
           np.array([7]), np.zeros(6), np.arange(1, 40) ** 2,
           np.array([0, 0, 100, 0, 0])]


@pytest.mark.parametrize("nproc", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("w", range(len(WEIGHTS)))
def test_partition_equals_reference(nproc, w):
    weights = WEIGHTS[w]
    try:
        for pid in range(nproc):
            dist.set_process_grid(pid, nproc)
            jdist.set_process_grid(pid, nproc)
            parts = dist.partition(weights)
            assert parts == jdist.partition(weights)
            assert dist.my_partition(weights) == jdist.my_partition(weights)
        assert parts[0][0] == 0 and parts[-1][1] == len(weights)
        for (a, b), (c, d) in zip(parts, parts[1:]):
            assert b == c and a <= b and c <= d
    finally:
        dist.set_process_grid(0, 1)
        jdist.set_process_grid(0, 1)


def test_archive_independent_of_process_count(data, group):
    """codec="auto": every rank's archive equals the JAX package's and the
    port's single-process archive, for 2 and 3 processes."""
    world = group
    g = data["gold"]["auto"]
    assert g["port"] == g["jax"]
    for r in range(world):
        got = _read(os.path.join(data["tmp"], f"g{world}_auto_{r}.mtc"))
        assert got == g["jax"], f"rank {r}/{world} archive differs"


@pytest.mark.parametrize("mode", ["order", "pe", "device", "gzip"])
def test_two_process_archives_in_every_mode(data, group2, mode):
    g = data["gold"][mode]
    assert g["port"] == g["jax"]
    for r in range(2):
        got = _read(os.path.join(data["tmp"], f"g2_{mode}_{r}.mtc"))
        assert got == g["jax"], f"rank {r} {mode} archive differs"


@pytest.mark.parametrize("mode", ["auto", "order", "pe"])
def test_sharded_decode_equals_single_process(data, group2, mode):
    g = data["gold"][mode]
    for r in range(2):
        base = os.path.join(data["tmp"], f"g2_{mode}_{r}")
        assert _read(base + ".dec") == g["dec"], f"rank {r} decode differs"
        if mode == "pe":
            assert _read(base + ".dec2") == g["dec2"]


def test_rank0_only_writes_by_default(data, group2):
    tmp = data["tmp"]
    assert _read(os.path.join(tmp, "r0_0.mtc")) == data["gold"]["auto"]["jax"]
    assert _read(os.path.join(tmp, "r0_0.dec")) == data["gold"]["auto"]["dec"]
    assert not os.path.exists(os.path.join(tmp, "r0_1.mtc"))
    assert not os.path.exists(os.path.join(tmp, "r0_1.dec"))


def test_checkpointed_group_writes_once_and_resumes(data, group2):
    """Two ranks with checkpoint_dir: rank 0 alone writes each snapshot, so
    the run succeeds with no temporary file left (with every rank writing
    through one shared .tmp name, a rank's rename finds it gone); a rerun
    of 2 ranks resumes from realign and writes the same archive."""
    tmp = data["tmp"]
    assert group2["ck_files"] == ["cluster.npz", "merge.npz", "realign.npz"]
    assert sorted(os.listdir(group2["ck"])) == group2["ck_files"]
    for r in range(2):
        assert _jobs(group2["rerun"], r)[0]["resumed_from"] == "realign"
        assert _jobs(group2["first"], r)[-1]["resumed_from"] is None
    want = data["gold"]["auto"]["jax"]
    assert _read(os.path.join(tmp, "ck_a.mtc")) == want
    assert _read(os.path.join(tmp, "ck_b.mtc")) == want


def test_length_changing_fastq_raises_on_every_rank(tmp_path):
    """The second half of the file has shorter reads, so one rank's byte
    slice holds both lengths: every rank exits with the same ValueError
    instead of one raising while the other waits in the next exchange."""
    rng = np.random.default_rng(3)
    fq = str(tmp_path / "bad.fastq")
    write_fastq(fq, genome_reads(rng, 400, 60, genome_len=3000))
    with open(fq, "ab") as f:
        for i, row in enumerate(genome_reads(rng, 400, 50, genome_len=3000)):
            f.write(b"@s%d\n%s\n+\n%s\n" % (i, row.tobytes(), b"I" * 50))
    res = _run_group(str(tmp_path), "bad", 2, [dict(
        op="compress", fq=fq, cfg={}, out=str(tmp_path / "bad.mtc"))],
        expect_ok=False)
    msgs = []
    for r, (rc, out) in enumerate(res):
        assert rc != 0
        # torch prefixes the traceback lines of a group member with its rank
        last = out.strip().splitlines()[-1].removeprefix(f"[rank{r}]: ")
        assert last.startswith("ValueError:"), out[-2000:]
        msgs.append(last)
    assert "non-uniform length" in msgs[0] and msgs[0] == msgs[1]
