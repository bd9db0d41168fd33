"""minicom_tpu_torch in a process group of 2 and 3 processes (gloo on the
CPU, device="cpu"): archives byte-identical to the single-process archive of
the port and of the JAX package, in every mode; sharded decode equal to the
single-process decode; the collectives and the sharded read store against
plain numpy; and three faults of the JAX package's multi-process path that the
port repairs (checkpoint writes racing on one temporary name, a rank
whose FASTQ slice fails to parse leaving the others waiting, and a slice
cut inside the first line of a record); a write that
fails on rank 0 raising on every rank; and the CLI in a 2-rank group.

Each group runs tests/_torch_dist_worker.py in subprocesses that meet
through a ``file://`` store in the test's tmp dir; one group runs several
jobs, and the tests read its results."""

import gzip
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from minicom_tpu import CompressorConfig as JConfig
from minicom_tpu import compressor as jcomp
from minicom_tpu.parallel import distributed as jdist
from minicom_tpu_torch import CompressorConfig
from minicom_tpu_torch import compressor as tcomp
from minicom_tpu_torch.parallel import distributed as dist
from minicom_tpu_torch.pipeline import merge as tmerge
from tests import _torch_dist_worker as worker
from tests._torch_dist_worker import job_results as _jobs
from tests._torch_dist_worker import run_group as _run_group
from tests.conftest import genome_reads, write_fastq
from tests.test_torch_rans import jax_native  # noqa: F401 (autouse)


CPU = torch.device("cpu")


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
    sk = os.path.join(tmp, "sketch_in.npz")
    gold["sketch"] = tmerge.sketch_contigs(worker.sketch_input(sk),
                                           *worker.SKETCH_ARGS, CPU)
    return dict(tmp=tmp, gold=gold, sketch=sk)


def _sketch_job(data, world):
    return dict(op="sketch", cs=data["sketch"],
                out=os.path.join(data["tmp"], f"sk{world}_{{rank}}.npz"))


def _reads_job(data, world):
    return dict(op="reads",
                out=os.path.join(data["tmp"], f"rd{world}_{{rank}}.npz"))


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
    jobs = ([dict(op="collectives", out=os.path.join(tmp, "c2_{rank}.npz")),
             _sketch_job(data, 2), _reads_job(data, 2)]
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
        _sketch_job(data, 3), _reads_job(data, 3),
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


def test_sketch_contigs_ranks_split_the_plan(data, group):
    """Each rank sketches its own range of the plan's chunks (in one
    launch on the card): the ranks' shares, in rank order, are the
    single-process arrays, which every rank gets back whole."""
    world = group
    want = data["gold"]["sketch"]
    shares = []
    for r in range(world):
        with np.load(os.path.join(data["tmp"], f"sk{world}_{r}.npz")) as z:
            got = [z[f"arr_{i}"] for i in range(10)]
        for g, x in zip(got[:5], want):
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g, x)
        shares.append(got[5:])
    assert sum(len(s[0]) > 0 for s in shares) >= 2   # the work is split
    for i, x in enumerate(want):
        np.testing.assert_array_equal(
            np.concatenate([s[i] for s in shares]), x)


def test_sharded_read_minimizer_equals_one_rank(data, group):
    """The cluster rounds' read minimizer over a row-sharded store: each
    rank sketches the pending reads it owns (one ``sketch_reads_flat`` call
    on its slice, local rids) and every rank gets back the one-process
    (key, mpos, strand) of each round, in pending order."""
    from minicom_tpu_torch.pipeline import cluster
    world = group
    codes, rounds = worker.reads_input()
    want = []
    for pending, k in rounds:
        want.extend(cluster._sketch(pending, torch.from_numpy(codes), k,
                                    codes.shape[1]))
    for r in range(world):
        with np.load(os.path.join(data["tmp"], f"rd{world}_{r}.npz")) as z:
            got = [z[f"arr_{i}"] for i in range(len(want))]
        for g, x in zip(got, want):
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g, x)


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


def _last_lines(res):
    """Each rank's exit code must be non-zero; returns the last line of
    each rank's output (torch prefixes a group member's traceback lines
    with its rank)."""
    last = []
    for r, (rc, out) in enumerate(res):
        assert rc != 0, out[-2000:]
        last.append(out.strip().splitlines()[-1].removeprefix(
            f"[rank{r}]: "))
    return last


@pytest.fixture(scope="module")
def small_fastq(tmp_path_factory):
    fq = str(tmp_path_factory.mktemp("small") / "in.fastq")
    write_fastq(fq, genome_reads(np.random.default_rng(5), 300, 60,
                                 genome_len=3000))
    return fq


@pytest.mark.parametrize("step", ["compress", "decompress", "checkpoint"])
def test_failed_rank0_write_raises_on_every_rank(tmp_path, small_fastq,
                                                 step):
    """Rank 0 alone writes the archive, the decoded file and the stage
    snapshots. Its open fails (the directory does not exist; or, for the
    snapshot, its temporary name is taken by a directory): every rank must
    leave with the same error within seconds, where rank 1 used to wait in
    a barrier for the group's timeout."""
    missing = str(tmp_path / "no_such_dir" / "out")
    job = dict(op="compress", fq=small_fastq, cfg={},
               out=str(tmp_path / "ok.mtc"), decode=missing)
    error, where = "FileNotFoundError", "no_such_dir"
    if step == "compress":
        job.update(out=missing, decode=None)
    elif step == "checkpoint":
        os.makedirs(tmp_path / "ck" / "cluster.npz.tmp")
        job.update(cfg={"checkpoint_dir": str(tmp_path / "ck")}, decode=None)
        error, where = "IsADirectoryError", "cluster.npz.tmp"
    t0 = time.monotonic()
    res = _run_group(str(tmp_path), "nodir", 2, [job], expect_ok=False)
    assert time.monotonic() - t0 < 90      # the group's timeout is 120 s
    last = _last_lines(res)
    assert last[0] == last[1]
    assert error in last[0] and where in last[0]
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    assert os.path.exists(tmp_path / "ok.mtc") == (step == "decompress")


def test_write_together_shares_any_exception(monkeypatch, tmp_path):
    """Not only an OSError: whatever rank 0's write raises goes into the
    exchange (here a group of two stands in: the exchange is recorded), and
    the temporary file goes."""
    tmp = tmp_path / "x.tmp0"
    shared = []
    monkeypatch.setattr(dist, "process_grid", lambda: (0, 2))
    monkeypatch.setattr(dist, "raise_together", shared.append)

    def write():
        tmp.write_bytes(b"half")
        raise MemoryError("no room for the buffer")

    dist.write_together(write, True, str(tmp))
    dist.write_together(write, False, str(tmp))     # not a writer: no call
    assert shared == ["MemoryError: no room for the buffer", None]
    assert not tmp.exists()
    monkeypatch.setattr(dist, "process_grid", lambda: (0, 1))
    with pytest.raises(MemoryError):                 # one process: as it is
        dist.write_together(write, True, str(tmp))
    assert not tmp.exists()


def test_failed_write_keeps_its_exception_in_one_process(tmp_path,
                                                         small_fastq):
    with pytest.raises(FileNotFoundError):
        tcomp.compress(small_fastq, str(tmp_path / "no_such_dir" / "a.mtc"),
                       device="cpu")
    arc = str(tmp_path / "a.mtc")
    tcomp.compress(small_fastq, arc, CompressorConfig(order=True),
                   device="cpu")
    with pytest.raises(FileNotFoundError):
        tcomp.decompress(arc, str(tmp_path / "no_such_dir" / "a.reads"))


def _cli_group(args, world=2):
    """``python -m minicom_tpu_torch.cli`` in ``world`` processes that meet
    as torchrun's would (env://, a free port of this host); returns each
    rank's (exit code, standard output) and, second, (exit code, standard
    error)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=worker.REPO, OMP_NUM_THREADS="2",
               GLOO_SOCKET_IFNAME="lo", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE=str(world))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "minicom_tpu_torch.cli", *args,
         "--device", "cpu"], cwd=worker.REPO, env=dict(env, RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        errors="replace") for r in range(world)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return ([(p.returncode, o[0]) for p, o in zip(procs, outs)],
            [(p.returncode, o[1]) for p, o in zip(procs, outs)])


def test_cli_group_prints_its_closing_lines_once(tmp_path, small_fastq):
    arc = str(tmp_path / "cli.mtc")
    res, err = _cli_group(["-r", small_fastq, "-o", arc, "--stats"])
    assert [rc for rc, _ in res] == [0, 0], err
    lines = [ln for _, out in res for ln in out.splitlines()]
    assert len([ln for ln in lines if ln.startswith("Compressed to")]) == 1
    assert len([ln for ln in lines if ln.startswith('{"')]) == 1
    assert res[1][1].strip() == ""
    res, err = _cli_group(["-d", arc, "-o", str(tmp_path / "cli.reads")])
    assert [rc for rc, _ in res] == [0, 0], err
    assert [out.strip() for _, out in res] == [
        f"Decompressed to {tmp_path / 'cli.reads'}", ""]


def test_cli_group_leaves_together_after_a_failed_write(tmp_path,
                                                        small_fastq):
    """Both ranks exit non-zero with the shared error, and neither waits
    for the group's timeout in the closing barrier."""
    t0 = time.monotonic()
    _, err = _cli_group(["-r", small_fastq, "-o",
                         str(tmp_path / "no_such_dir" / "x.mtc")])
    assert time.monotonic() - t0 < 90
    last = _last_lines(err)
    assert last[0] == last[1] and "FileNotFoundError" in last[0]


def _cut_headers_fastq(path):
    """301 records of 50 bp under 301-character names: every slice edge of
    2 and 3 ranks falls inside a name line, the first line of a record."""
    rng = np.random.default_rng(8)
    bases = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (301, 50))]
    with open(path, "wb") as f:
        for i, row in enumerate(bases):
            name = b"@r%05d" % i + b"x" * 295
            f.write(name + b"\n" + row.tobytes() + b"\n+\n" + b"I" * 50
                    + b"\n")
    size = os.path.getsize(path)
    rec = size // 301
    for world in (2, 3):
        for r in range(1, world):
            assert 0 < size * r // world % rec < 301, (world, r)


@pytest.mark.parametrize("world", [2, 3])
def test_slices_cut_inside_a_record_start(tmp_path, world):
    """A rank's byte slice that ends inside the first line of a record takes
    that whole record: the ranks' rows are the file's, in order, and each
    rank's whole matrix is the file's (the JAX package's loader asks for no
    more lines there, and the parse fails on every rank)."""
    from minicom_tpu_torch.io import fastq
    fq = str(tmp_path / "cut.fastq")
    _cut_headers_fastq(fq)
    want = fastq.read_fastq_codes(fq)
    _run_group(str(tmp_path), f"cut{world}", world, [dict(
        op="fastq", fq=fq, out=str(tmp_path / "cut_{rank}.npz"))])
    parts = [np.load(tmp_path / f"cut_{r}.npz") for r in range(world)]
    np.testing.assert_array_equal(
        np.concatenate([p["local"] for p in parts]), want)
    for p in parts:
        np.testing.assert_array_equal(p["full"], want)
