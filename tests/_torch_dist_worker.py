"""One rank of a minicom_tpu_torch process group, for
tests/test_torch_distributed.py and tests/test_torch_mesh.py (CPU) and
tests/test_torch_cuda.py (card), and ``run_group``, which starts a group
of them:

    python tests/_torch_dist_worker.py INIT_FILE WORLD RANK JOBS_JSON

Joins a gloo group through ``file://INIT_FILE`` and runs the jobs of
JOBS_JSON in order, printing one ``JOB {...}`` line each. Output paths may
hold ``{rank}``. Imports no jax. Jobs:

* {"op": "collectives", "out": path}: allgather_ragged_many and the sharded
  store's rows / rows_all on the inputs of ``collective_inputs``; this
  rank's results are saved to ``out`` (an .npz).
* {"op": "compress", "fq", "fq2", "cfg", "out", "write_all", "decode",
  "decode2", "decode_from", "device"}: compress on "device" (default cpu),
  then decompress "decode_from" (default "out") when "decode" is set.
  "write_all" sets MTC_WRITE_ALL_RANKS. Reports the kernel launches of the
  compress.
* {"op": "sketch", "cs": path, "out": path}: the merge stage's
  ``sketch_contigs`` (k = 31, w = 19, rank cap 128, on the CPU) of the
  contigs of ``sketch_input``; saves the gathered arrays and then this
  rank's own share of them to ``out`` (an .npz).
* {"op": "reads", "out": path}: the cluster rounds' read minimizer
  (``cluster._sketch``) over a row-sharded store of ``reads_input``, for
  each of its (pending, k) rounds, on the CPU; saves the (key, mpos,
  strand) of every round to ``out`` (an .npz).
* {"op": "mesh", "cases": path, "out": path, "device", "chunk_bytes"}:
  ``parallel/mesh.py::sharded_cluster_step`` on each case of the .npz that
  ``write_mesh_cases`` wrote, this rank's rows of its split for the world
  size, on "device" (default cpu), with broadcasts of at most "chunk_bytes"
  (default the module's); saves the five outputs of each case to ``out``
  (an .npz) and reports per case the launches and the step's stats.
* {"op": "exchange", "out": path}: the sharded step's row exchange (one
  ``all_to_all_single``) and a plain all-gather of the same rows, on the
  inputs of ``exchange_inputs``; saves both to ``out``.
* {"op": "mesh_errors"}: the sharded step on an int64 matrix from rank 1,
  on reads of another length on rank 1, and at k = 0; reports what each
  rank raised.
* {"op": "allgather", "out": path}: the sharded step's all-gather of
  tensors (``mesh._allgather``) and the host all-gather of the same arrays
  (``allgather_ragged_many``), on the inputs of ``collective_inputs``;
  saves both to ``out``.
* {"op": "fastq", "fq": path, "out": path}: the FASTQ loader's byte
  slices (``read_fastq_store``: this rank's rows; ``read_fastq_full``:
  every row), saved to ``out`` (an .npz) as "local" and "full".
* {"op": "placement", "cards": n}, first in a group's jobs: the group joins
  as on a host with ``n`` cards (``torch.cuda``'s count mocked; the backend
  that ``initialize`` asks for is recorded and gloo joined, this host having
  no NCCL); reports the backend, the cards set current, the placement, the
  device "cuda" and "cuda:1" resolve to, the summary's device and the
  exchange device of the sharded step.
"""

import datetime
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = (np.bool_, np.int8, np.uint32, np.int64)
STORE_N, STORE_L, ROWS_CHUNK = 50, 7, 5


def collective_inputs(rank: int, world: int) -> dict:
    """Every rank's inputs, a pure function of (rank, world): one ragged
    array per dtype (empty on the last rank), the store matrix, this rank's
    row request list (longer than the chunk on rank 0, empty on rank 1) and
    the request list every rank shares."""
    rng = np.random.default_rng(1000 * world + rank)
    n = 0 if rank == world - 1 else 4 + 3 * rank
    arrays = [rng.integers(0, 2, n).astype(bool),
              rng.integers(-128, 128, n).astype(np.int8),
              rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
              rng.integers(-2**62, 2**62, n, dtype=np.int64)]
    codes = np.random.default_rng(world).integers(
        0, 4, (STORE_N, STORE_L)).astype(np.uint8)
    req = {0: 23, 1: 0}.get(rank, 7)
    return dict(arrays=arrays, codes=codes,
                rows=rng.integers(0, STORE_N, req),
                rows_all=np.random.default_rng(world + 1).integers(
                    0, STORE_N, 31))


def _collectives(rank, world, out):
    from minicom_tpu_torch.parallel import distributed as dist
    from minicom_tpu_torch.parallel.store import maybe_shard
    inp = collective_inputs(rank, world)
    got = dist.allgather_ragged_many(inp["arrays"])
    store = maybe_shard(inp["codes"].copy())
    np.savez(out, *got, rows=store.rows(inp["rows"], chunk=ROWS_CHUNK),
             rows_all=store.rows_all(inp["rows_all"]))
    return {"dtypes": [str(g.dtype) for g in got]}


SKETCH_ARGS = (31, 19, 128)   # k, w, rank cap


def sketch_input(path):
    """Contigs of every rung of the merge stage's sketch plan (the 128
    rung in two chunks), saved to ``path``; returns the ClusterSet."""
    rng = np.random.default_rng(9)
    lens = rng.choice([100, 300, 1500, 6000], 4000, p=[.6, .3, .08, .02])
    ptr = np.r_[0, np.cumsum(lens)]
    ref = rng.integers(0, 4, int(ptr[-1]), dtype=np.uint8)
    np.savez(path, ref=ref, ptr=ptr)
    return _contigs(ref, ptr)


def _contigs(ref, ptr):
    from minicom_tpu_torch.pipeline.cluster import ClusterSet
    n = len(ptr) - 1
    return ClusterSet(100, np.zeros(0, np.int64), np.zeros(0, np.int32),
                      np.zeros(0, np.int8), np.zeros(n + 1, np.int64), ref,
                      ptr)


def _sketch(rank, job):
    import torch
    from minicom_tpu_torch.parallel import distributed as dist
    from minicom_tpu_torch.pipeline import merge
    with np.load(job["cs"]) as z:
        cs = _contigs(z["ref"], z["ptr"])
    gather, mine = dist.allgather_ragged_many, []

    def keep(arrays):
        mine.extend(arrays[:5])
        return gather(arrays)

    dist.allgather_ragged_many = keep
    try:
        out = merge.sketch_contigs(cs, *SKETCH_ARGS, torch.device("cpu"))
    finally:
        dist.allgather_ragged_many = gather
    np.savez(job["out"].format(rank=rank), *out, *mine)
    return {"entries": len(mine[0])}


def reads_input():
    """A read store (random reads, palindromic and one-base rows) and the
    (pending rids, k) of two rounds: every read at k = 31, then a subset at
    k = 24, out of order."""
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, (301, 60)).astype(np.uint8)
    codes[:5] = np.resize(np.array([0, 3], np.uint8), 60)
    codes[5:9] = 1
    return codes, [(np.arange(301, dtype=np.int64), 31),
                   (rng.permutation(301)[:170].astype(np.int64), 24)]


def _reads(rank, job):
    from minicom_tpu_torch.parallel.store import maybe_shard
    from minicom_tpu_torch.pipeline import cluster
    import torch
    codes, rounds = reads_input()
    store = maybe_shard(codes).on_device(torch.device("cpu"))
    out = []
    for pending, k in rounds:
        out.extend(cluster._sketch(pending, store, k, codes.shape[1]))
    np.savez(job["out"].format(rank=rank), *out)
    return {"rounds": len(rounds), "rows": store.r1 - store.r0}


def write_mesh_cases(path, cases, split):
    """Cases of ``tests/_step_cases.py::mesh_cases`` into one .npz, with
    each case's rows a rank for 2 and 3 ranks from ``split`` (its
    ``mesh_split``)."""
    arrays = {}
    for name, (codes, k, span) in cases.items():
        arrays[f"{name}/codes"] = codes
        arrays[f"{name}/args"] = np.array([k, span], np.int64)
        for world in (2, 3):
            arrays[f"{name}/split{world}"] = split(name, len(codes), world)
    np.savez(path, **arrays)


def _mesh(rank, world, job):
    import torch
    from minicom_tpu_torch.ops import cuda
    from minicom_tpu_torch.parallel import distributed as dist
    from minicom_tpu_torch.parallel import mesh
    mesh.CHUNK_BYTES = job.get("chunk_bytes", mesh.CHUNK_BYTES)
    dev = torch.device(job.get("device", "cpu"))
    if dev == torch.device("cuda"):   # the rank's own card
        dev = dist.rank_device()
    out, res = {}, {}
    with np.load(job["cases"]) as z:
        for name in sorted(f[:-6] for f in z.files if f.endswith("/codes")):
            codes = z[f"{name}/codes"]
            k, span = (int(x) for x in z[f"{name}/args"])
            b = np.r_[0, np.cumsum(z[f"{name}/split{world}"])]
            local = torch.from_numpy(codes[b[rank]:b[rank + 1]]).to(dev)
            n0, stats = dict(cuda.launches), {}
            got = mesh.sharded_cluster_step(local, k, span, stats)
            for i, x in enumerate(got):
                out[f"{name}/{i}"] = x.cpu().numpy()
            res[name] = dict(stats, launched={
                x: n - n0.get(x, 0) for x, n in cuda.launches.items()
                if n > n0.get(x, 0)})
    np.savez(job["out"].format(rank=rank), **out)
    return res


EXCHANGE_L = 9


def exchange_inputs(rank, world):
    """(rows [n, EXCHANGE_L] uint8 this rank sends, counts [world, world]):
    counts[s, o] rows go from rank s to rank o; none from rank 0 to 1."""
    counts = np.random.default_rng(world).integers(1, 6, (world, world))
    counts[0, 1] = 0
    rows = np.random.default_rng(100 * world + rank).integers(
        0, 256, (int(counts[rank].sum()), EXCHANGE_L)).astype(np.uint8)
    return rows, counts


def _exchange(rank, world, job):
    import torch
    from minicom_tpu_torch.parallel import distributed as dist
    from minicom_tpu_torch.parallel import mesh
    rows, counts = exchange_inputs(rank, world)
    got = mesh._exchange_rows(torch.from_numpy(rows), counts[rank].tolist(),
                              counts[:, rank].tolist()).numpy()
    every = dist.allgather_ragged(rows.reshape(-1)).reshape(-1, EXCHANGE_L)
    start = np.r_[0, np.cumsum(counts.sum(1))]
    plain = np.concatenate([every[start[s] + counts[s, :rank].sum():][
        :counts[s, rank]] for s in range(world)])
    np.savez(job["out"].format(rank=rank), a2a=got, allgather=plain)
    return {"rows": len(got)}


def _mesh_errors(rank, world):
    import torch
    from minicom_tpu_torch.parallel import mesh
    rows = np.random.default_rng(rank).integers(0, 4, (20, 30), np.uint8)
    calls = [(rows.astype(np.int64) if rank == 1 else rows, 17),
             (rows[:, :29].copy() if rank == 1 else rows, 17), (rows, 0)]
    raised = []
    for codes, k in calls:
        try:
            mesh.sharded_cluster_step(torch.from_numpy(codes), k,
                                      20 * world * 60)
            raised.append(None)
        except ValueError as e:
            raised.append([type(e).__name__, str(e)])
    return {"raised": raised}


def _compress(rank, job):
    from minicom_tpu_torch import CompressorConfig, compressor
    from minicom_tpu_torch.ops import cuda
    os.environ["MTC_WRITE_ALL_RANKS"] = "1" if job.get("write_all") else "0"
    fmt = lambda p: p.format(rank=rank) if p else p  # noqa: E731
    dev = job.get("device", "cpu")
    n0 = dict(cuda.launches)
    summary = compressor.compress(
        job["fq"], fmt(job["out"]), CompressorConfig(threads=2, **job["cfg"]),
        reads_path2=job.get("fq2"), device=dev)
    launched = {k: v - n0.get(k, 0) for k, v in cuda.launches.items()}
    if job.get("decode"):
        compressor.decompress(fmt(job.get("decode_from", job["out"])),
                              fmt(job["decode"]),
                              fmt(job.get("decode2")), device=dev)
    return {"resumed_from": summary.get("resumed_from"),
            "archive_bytes": summary["archive_bytes"], "launched": launched,
            "device": summary["device"],
            "card_shared": summary["card_shared"]}


def run_group(tmp, tag, world, jobs, expect_ok=True, env=None):
    """Run ``jobs`` in a group of ``world`` worker processes that meet
    through ``tmp/<tag>.pg``, with ``env`` added to their environment;
    returns each rank's (returncode, output). Every wait has a timeout,
    after which the whole group is killed."""
    import subprocess
    spec = os.path.join(tmp, f"{tag}.json")
    with open(spec, "w") as f:
        json.dump(jobs, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               GLOO_SOCKET_IFNAME="lo", **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         os.path.join(tmp, f"{tag}.pg"), str(world), str(r), spec],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = [(p.returncode, o) for p, o in zip(procs, outs)]
    if expect_ok and any(rc != 0 for rc, _ in res):
        raise AssertionError("\n".join(
            f"rank {r} (exit {rc}):\n{out[-2000:]}"
            for r, (rc, out) in enumerate(res)))
    return res


def job_results(res, rank=0) -> list:
    """The parsed ``JOB`` lines of one rank's output."""
    return [json.loads(line[4:]) for line in res[rank][1].splitlines()
            if line.startswith("JOB ")]


def _fake_cards(count: int) -> dict:
    """``torch.cuda`` as on a host with ``count`` cards, for the group's
    start: what ``initialize`` asks of it is recorded in the dict
    returned."""
    import torch
    import torch.distributed as tdist
    seen = {"set_device": [], "backend": None, "device_id": None}
    torch.cuda.is_available = lambda: count > 0
    torch.cuda.device_count = lambda: count
    torch.cuda.set_device = lambda d: seen["set_device"].append(
        str(torch.device(d)))
    join = tdist.init_process_group

    def init(backend, **kw):
        seen["backend"] = backend
        dev = kw.pop("device_id", None)
        seen["device_id"] = None if dev is None else str(dev)
        join("gloo", **kw)

    tdist.init_process_group = init
    return seen


def _placement(rank, seen):
    from minicom_tpu_torch import compressor
    from minicom_tpu_torch.parallel import distributed as dist
    from minicom_tpu_torch.parallel import mesh
    from minicom_tpu_torch.stats import StageStats
    p = dist.placement()
    res = dict(seen, placement=p and [str(p.device), p.shared],
               nccl=dist.nccl())
    try:
        dev = compressor._device("cuda")
    except RuntimeError as e:
        res["raised"] = str(e)
        return res
    res["explicit"] = str(compressor._device("cuda:1"))
    st = StageStats()
    compressor._name_device(st, dev)
    summary = st.summary()
    res.update(cuda=str(dev), summary=[summary["device"],
                                       summary["card_shared"]],
               exchange=str(mesh.exchange_device(dev)))
    return res


def _allgather(rank, world, job):
    import torch
    from minicom_tpu_torch.parallel import distributed as dist
    from minicom_tpu_torch.parallel import mesh
    arrays = collective_inputs(rank, world)["arrays"]
    counts = dist.allgather_ragged(np.array([len(arrays[0])], np.int64))
    got = mesh._allgather([torch.from_numpy(a) for a in arrays],
                          counts.tolist())
    want = dist.allgather_ragged_many(arrays)
    got = [g.numpy() for g in got]
    np.savez(job["out"].format(rank=rank), *got, *want)
    return {"dtypes": [str(g.dtype) for g in got]}


def _fastq(rank, job):
    from minicom_tpu_torch.io import fastq
    store = fastq.read_fastq_store(job["fq"])
    np.savez(job["out"].format(rank=rank), local=store.local,
             full=fastq.read_fastq_full(job["fq"]))
    return {"rows": len(store.local)}


def main():
    init_file, world, rank, jobs = sys.argv[1:5]
    world, rank = int(world), int(rank)
    with open(jobs) as f:
        jobs = json.load(f)
    seen = (_fake_cards(jobs[0]["cards"])
            if jobs and jobs[0]["op"] == "placement" else None)
    from minicom_tpu_torch.parallel import distributed as dist
    dist.initialize(f"file://{init_file}", world_size=world, rank=rank,
                    timeout=datetime.timedelta(seconds=120))
    with dist.closing_group():
        for job in jobs:
            if job["op"] == "placement":
                res = _placement(rank, seen)
            elif job["op"] == "allgather":
                res = _allgather(rank, world, job)
            elif job["op"] == "fastq":
                res = _fastq(rank, job)
            elif job["op"] == "collectives":
                res = _collectives(rank, world, job["out"].format(rank=rank))
            elif job["op"] == "sketch":
                res = _sketch(rank, job)
            elif job["op"] == "reads":
                res = _reads(rank, job)
            elif job["op"] == "mesh":
                res = _mesh(rank, world, job)
            elif job["op"] == "exchange":
                res = _exchange(rank, world, job)
            elif job["op"] == "mesh_errors":
                res = _mesh_errors(rank, world)
            else:
                res = _compress(rank, job)
            print("JOB " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
