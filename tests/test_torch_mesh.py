"""The port's sharded cluster step (minicom_tpu_torch.parallel.mesh) in
process groups of 2 and 3 ranks (gloo on the CPU, the plain versions): the
rank-order concatenation of each rank's outputs equals, byte for byte, the
port's one-process ``cluster_step``, the JAX ``cluster_step`` and the JAX
``sharded_cluster_step`` over 8 host devices (where 8 divides N), on
``tests/_step_cases.py::mesh_cases``: uneven N, an empty shard, a rank that
owns no segment, columns past span_cols and reads with no chosen k-mer.
Also the row exchange (one all_to_all) against a plain all-gather of the
rows, the tensor all-gather of the keys and diffs against the host
all-gather, what each call's stats say of its exchanges (gloo, no byte
through the host on CPU ranks), and bad inputs raising on every rank. The
exchanges run on tensors of the exchange device, the CPU here: the same
code that moves them between cards over NCCL where every rank owns one.

One group per world size runs every case (``tests/_torch_dist_worker.py``,
jobs "mesh", "exchange", "allgather" and "mesh_errors"); the broadcasts of
the output columns go 64 bytes a call, so that every range takes
several."""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minicom_tpu.ops.step import cluster_step as jax_cluster_step
from minicom_tpu.parallel.mesh import make_mesh
from minicom_tpu.parallel.mesh import sharded_cluster_step as jax_sharded
from minicom_tpu_torch.ops import sketch, step
from minicom_tpu_torch.parallel import mesh
from tests import _torch_dist_worker as worker
from tests._step_cases import mesh_cases, mesh_split
from tests.test_torch_step import OUTPUTS, _conftest_genome

WORLDS = (2, 3)
CASES = mesh_cases(_conftest_genome)


@functools.lru_cache(maxsize=None)
def _reference(name, ref):
    codes, k, span = CASES[name]
    if ref == "port_step":
        got = step.cluster_step(torch.from_numpy(codes), k, span)
        return [x.numpy() for x in got]
    if ref == "jax_step":
        fn = functools.partial(jax_cluster_step, k=k, span_cols=span)
    else:
        fn = jax_sharded(make_mesh(8), k, span)
    return [np.asarray(x) for x in fn(jnp.asarray(codes))]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Per world size: each rank's outputs of every case, its JOB results
    (mesh, exchange, mesh_errors) and the exchange's arrays."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    cases = os.path.join(tmp, "cases.npz")
    worker.write_mesh_cases(cases, CASES, mesh_split)
    out = {}
    for world in WORLDS:
        res = worker.run_group(tmp, f"m{world}", world, [
            dict(op="mesh", cases=cases, chunk_bytes=64,
                 out=os.path.join(tmp, f"m{world}_{{rank}}.npz")),
            dict(op="exchange",
                 out=os.path.join(tmp, f"x{world}_{{rank}}.npz")),
            dict(op="mesh_errors"),
            dict(op="allgather",
                 out=os.path.join(tmp, f"g{world}_{{rank}}.npz"))])
        ranks = []
        for r in range(world):
            with np.load(os.path.join(tmp, f"m{world}_{r}.npz")) as z:
                outs = {f: z[f] for f in z.files}
            with np.load(os.path.join(tmp, f"x{world}_{r}.npz")) as z:
                exch = {f: z[f] for f in z.files}
            with np.load(os.path.join(tmp, f"g{world}_{r}.npz")) as z:
                gath = [z[f"arr_{i}"] for i in range(len(z.files))]
            ranks.append(dict(outs=outs, exchange=exch, gathered=gath,
                              jobs=worker.job_results(res, r)))
        out[world] = ranks
    return out


def _params():
    for name, (codes, _, _) in CASES.items():
        for ref in ("port_step", "jax_step", "jax_sharded"):
            if ref != "jax_sharded" or len(codes) % 8 == 0:
                yield ref, name


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("ref,name", list(_params()))
def test_sharded_step_equals_reference(groups, world, ref, name):
    """Consensus and coverage whole on every rank; diffs, seg_id and order
    each rank's slice of the sorted positions, of its own row count."""
    want = _reference(name, ref)
    ranks = groups[world]
    split = mesh_split(name, len(CASES[name][0]), world)
    for i, (out, w) in enumerate(zip(OUTPUTS, want)):
        parts = [r["outs"][f"{name}/{i}"] for r in ranks]
        if i < 2:
            got = parts
        else:
            assert [len(p) for p in parts] == split, out
            got = [np.concatenate(parts)]
        for g in got:
            assert g.dtype == w.dtype and g.shape == w.shape, out
            np.testing.assert_array_equal(g, w, err_msg=out)


def _stats(groups, world, name):
    return [r["jobs"][0][name] for r in groups[world]]


@pytest.mark.parametrize("world", WORLDS)
def test_cases_reach_their_rules(groups, world):
    """The cases do what they are there for: a rank with no rows, a rank
    with rows that owns no segment, a rank whose owned columns all lie past
    span_cols (it votes nothing), reads with no chosen k-mer, an N that the
    world size does not divide."""
    owned = {name: [s["owned"] for s in _stats(groups, world, name)]
             for name in CASES}
    assert any(o["rows"] == 0 for o in owned["empty_shard"])
    deep = owned["deep_spans_ranks"]
    assert [o["segments"] == 0 for o in deep] == [False] + [True] * (
        world - 1)
    assert all(o["rows"] > 0 for o in deep)
    past = owned["span_past_last"][-1]
    assert past["members"] > 0 and past["columns"] == 0
    assert not past["voted"]
    codes, k, _ = CASES["at_rows_k24_uneven"]
    sk = sketch._sketch_reads_plain(torch.from_numpy(codes),
                                    torch.arange(len(codes)), k)
    assert (sk[2] == 0).sum() > len(codes) // 4
    assert len(CASES["uneven_301"][0]) % world


@pytest.mark.parametrize("world", WORLDS)
def test_owned_ranges_tile_the_step(groups, world):
    """Over the ranks, the rows, owned members and owned columns add up to
    N, N and span_cols, the owned segments to the segment count; the bytes
    of the keys' and the diffs' all-gathers are 12 and 4 a read."""
    for name, (codes, _, span) in CASES.items():
        stats = _stats(groups, world, name)
        owned = [s["owned"] for s in stats]
        N = len(codes)
        nseg = int(_reference(name, "port_step")[3][-1]) + 1
        for key, total in (("rows", N), ("members", N), ("columns", span),
                           ("segments", nseg)):
            assert sum(o[key] for o in owned) == total, (name, key)
        for s, o in zip(stats, owned):
            c = s["collectives"]
            assert c["keys"]["recv_B"] == 12 * (N - o["rows"])
            assert c["diffs"]["recv_B"] == 4 * (N - o["members"])
            assert c["columns"]["recv_B"] == 5 * (span - o["columns"])
            assert s["device_ms"] == {}   # events are taken on the card


@pytest.mark.parametrize("world", WORLDS)
def test_row_exchange_equals_allgather(groups, world):
    """The all_to_all with uneven splits (some empty) hands each rank what a
    plain all-gather of every rank's rows gives it, in rank order."""
    for r, rank in enumerate(groups[world]):
        got = rank["exchange"]
        np.testing.assert_array_equal(got["a2a"], got["allgather"])
        counts = worker.exchange_inputs(r, world)[1]
        want = np.concatenate([
            worker.exchange_inputs(s, world)[0][counts[s, :r].sum():][
                :counts[s, r]] for s in range(world)])
        np.testing.assert_array_equal(got["a2a"], want)
        assert len(want) == counts[:, r].sum() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_bad_input_raises_on_every_rank(groups, world):
    """An int64 matrix on rank 1 alone: GroupError with its message on every
    rank; reads of another length on rank 1, and k = 0: ValueError on
    every rank. The group stays in step for the next call."""
    raised = [r["jobs"][2]["raised"] for r in groups[world]]
    for r in raised:
        assert r[0][0] == "GroupError" and "int64" in r[0][1]
        assert r[1][0] == "ValueError" and "[30, 29" in r[1][1]
        assert r[2][0] == "ValueError" and "k=0" in r[2][1]


@pytest.mark.parametrize("world", WORLDS)
def test_exchanges_over_gloo_move_no_host_bytes(groups, world):
    """Each call on CPU rows reports gloo, and every exchange (keys, rows,
    columns, diffs; the row counts' too) moves no byte between a card and
    the host: the rows already lie there."""
    for name in CASES:
        for s in _stats(groups, world, name):
            assert s["backend"] == "gloo"
            assert set(s["collectives"]) == {"shapes", "keys", "rows",
                                             "columns", "diffs"}
            assert all(c["host_B"] == 0 for c in s["collectives"].values())
            assert s["copies"] == {"s": 0.0, "d2h_B": 0, "h2d_B": 0}


@pytest.mark.parametrize("world", WORLDS)
def test_tensor_allgather_equals_host_allgather(groups, world):
    """``mesh._allgather`` of bool, int8, uint32 and int64 tensors with
    ragged counts (none on the last rank) is the host all-gather, dtype
    and all, on every rank."""
    for rank in groups[world]:
        got = rank["gathered"]
        n = len(got) // 2
        assert rank["jobs"][3]["dtypes"] == [str(g.dtype) for g in got[:n]]
        for g, w in zip(got[:n], got[n:]):
            assert g.dtype == w.dtype and len(w) > 0
            np.testing.assert_array_equal(g, w)


def test_one_process_is_cluster_step():
    codes, k, span = CASES["random_128x48_k17"]
    c = torch.from_numpy(codes)
    for g, w in zip(mesh.sharded_cluster_step(c, k, span),
                    step.cluster_step(c, k, span)):
        assert torch.equal(g, w)
