"""Where the port's ranks run (minicom_tpu_torch.parallel.distributed): the
card of each local rank (``place``), the backend of the group
(``choose_backend``), the local rank's sources (``local_ranks``), the device
that ``compressor._device`` resolves "cuda" to, and the card each summary
names. On this host, which has no card: the plain functions in process, and
gloo groups of 2 and 3 ranks (``tests/_torch_dist_worker.py``, job
"placement") that join as on a host with 0, 1, 2 or 4 cards, with
``torch.cuda``'s count mocked. The group the mocked host would give NCCL
joins over gloo here (this host has no NCCL); what ``initialize`` asked for
is recorded."""

import os

import pytest
import torch

from minicom_tpu_torch import compressor
from minicom_tpu_torch.parallel import distributed as dist
from minicom_tpu_torch.parallel import mesh
from minicom_tpu_torch.stats import StageStats
from tests import _torch_dist_worker as worker

CUDA = torch.device("cuda")


@pytest.mark.parametrize("local_world,count,cards,shared", [
    (1, 1, [0], [False]),
    (2, 2, [0, 1], [False, False]),
    (4, 4, [0, 1, 2, 3], [False] * 4),
    (2, 4, [0, 1], [False, False]),
    (2, 1, [0, 0], [True, True]),
    (3, 2, [0, 1, 0], [True, False, True]),
    (4, 2, [0, 1, 0, 1], [True] * 4),
    (5, 2, [0, 1, 0, 1, 0], [True] * 5),
    (5, 4, [0, 1, 2, 3, 0], [True, False, False, False, True])])
def test_place_gives_each_local_rank_its_card(local_world, count, cards,
                                              shared):
    got = [dist.place(r, local_world, count) for r in range(local_world)]
    assert [p.device for p in got] == [torch.device("cuda", c)
                                       for c in cards]
    assert [p.shared for p in got] == shared


def test_place_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.place(0, 2, 0)


@pytest.mark.parametrize("local_rank,local_world", [(-1, 2), (2, 2)])
def test_place_refuses_a_rank_outside_the_host(local_rank, local_world):
    with pytest.raises(ValueError, match="local rank"):
        dist.place(local_rank, local_world, 4)


@pytest.mark.parametrize("world,local_world,count,want", [
    (1, 1, 0, "gloo"), (4, 4, 0, "gloo"),      # the CPU
    (2, 2, 1, "gloo"), (3, 3, 2, "gloo"),      # ranks share a card
    (8, 4, 2, "gloo"),
    (1, 1, 1, "gloo"), (1, 1, 8, "gloo"),      # one rank: no exchange
    (2, 2, 2, dist.MIXED), (2, 2, 8, dist.MIXED),
    (4, 4, 4, dist.MIXED), (8, 4, 4, dist.MIXED),
    (2, 1, 1, dist.MIXED)])                    # every rank owns one
def test_choose_backend(world, local_world, count, want):
    assert dist.choose_backend(world, local_world, count) == want


@pytest.mark.parametrize("env,args,want", [
    ({}, (3, 4), (3, 4)),                                  # one host
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, (3, 4), (1, 2)),
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, (3, 4, 0), (0, 2)),
    ({}, (3, 4, 1), (1, 4))])
def test_local_ranks_from_arguments_then_torchrun(monkeypatch, env, args,
                                                  want):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dist.local_ranks(*args) == want


def _fake_group(monkeypatch, count, p):
    """This process as a rank placed at ``p`` of a group on a host with
    ``count`` cards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(dist.tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "_PLACEMENT", p)
    monkeypatch.setattr(dist, "_BACKEND", dist.choose_backend(2, 2, count))


@pytest.mark.parametrize("count,local_rank", [(2, 1), (4, 1), (1, 1)])
def test_device_in_a_group_is_the_ranks_card(monkeypatch, count,
                                             local_rank):
    p = dist.place(local_rank, 2, count)
    _fake_group(monkeypatch, count, p)
    assert compressor._device("cuda") == p.device
    assert compressor._device(CUDA) == p.device
    assert compressor._device("cuda:0") == torch.device("cuda", 0)
    assert compressor._device("cpu") == torch.device("cpu")
    st = StageStats()
    compressor._name_device(st, compressor._device("cuda"))
    assert (st.counters["device"], st.counters["card_shared"]) == (
        str(p.device), p.shared)
    # the exchanges go between cards only where no card is shared
    assert mesh.exchange_device(p.device) == (
        torch.device("cpu") if p.shared else p.device)


def test_device_with_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compressor._device("cuda")


def test_exchange_device_outside_a_group_is_the_host():
    assert mesh.exchange_device(torch.device("cpu")) == torch.device("cpu")
    assert mesh.exchange_device(torch.device("cuda", 1)) == torch.device(
        "cpu")


def test_cpu_summaries_name_the_host(tmp_path):
    from tests.conftest import genome_reads, write_fastq
    import numpy as np
    fq, arc = str(tmp_path / "in.fastq"), str(tmp_path / "a.mtc")
    write_fastq(fq, genome_reads(np.random.default_rng(3), 200, 50,
                                 genome_len=2000))
    s = compressor.compress(fq, arc, device="cpu")
    d = compressor.decompress(arc, str(tmp_path / "a.reads"))
    for summary in (s, d):
        assert (summary["device"], summary["card_shared"]) == ("cpu", False)


# (world size, cards on the host) of each group; per rank: the backend
# initialize asks for, the card set current, the placement and what "cuda"
# resolves to
GROUPS = {
    (2, 0): ("gloo", [None, None], [False, False]),
    (2, 1): ("gloo", ["cuda:0", "cuda:0"], [True, True]),
    (2, 2): (dist.MIXED, ["cuda:0", "cuda:1"], [False, False]),
    (3, 2): ("gloo", ["cuda:0", "cuda:1", "cuda:0"], [True, False, True]),
    (3, 4): (dist.MIXED, ["cuda:0", "cuda:1", "cuda:2"], [False] * 3),
}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("placement"))
    out = {}
    for (world, count) in GROUPS:
        res = worker.run_group(tmp, f"p{world}_{count}", world,
                               [dict(op="placement", cards=count)])
        out[world, count] = [worker.job_results(res, r)[0]
                             for r in range(world)]
    return out


@pytest.mark.parametrize("world,count", list(GROUPS))
def test_group_ranks_on_their_cards(groups, world, count):
    backend, cards, shared = GROUPS[world, count]
    for r, got in enumerate(groups[world, count]):
        assert got["backend"] == backend
        if cards[r] is None:    # no card: nothing bound, "cuda" refused
            assert got["set_device"] == [] and got["placement"] is None
            assert "no CUDA device" in got["raised"]
            assert not got["nccl"]
            continue
        assert got["set_device"] == [cards[r]]
        assert got["placement"] == [cards[r], shared[r]]
        assert got["cuda"] == cards[r] and got["explicit"] == "cuda:1"
        assert got["summary"] == [cards[r], shared[r]]
        owns = backend == dist.MIXED
        assert got["nccl"] == owns
        assert got["device_id"] == (cards[r] if owns else None)
        assert got["exchange"] == (cards[r] if owns else "cpu")


def test_cli_ranks_name_their_card(tmp_path):
    """Each rank of a CLI group names on standard error the device it ran
    on; standard output stays rank 0's closing line."""
    from tests.test_torch_distributed import _cli_group
    from tests.conftest import genome_reads, write_fastq
    import numpy as np
    fq, arc = str(tmp_path / "in.fastq"), str(tmp_path / "c.mtc")
    write_fastq(fq, genome_reads(np.random.default_rng(4), 200, 50,
                                 genome_len=2000))
    res, err = _cli_group(["-r", fq, "-o", arc])
    assert [rc for rc, _ in res] == [0, 0], err
    for r, (_, e) in enumerate(err):
        assert f"rank {r} of 2: cpu" in e.splitlines(), e
    assert res[1][1].strip() == "" and os.path.exists(arc)


def test_named_fixes_the_callers_card(monkeypatch):
    """``ops/cuda.py::named``, which the container applies before its pool
    threads (current card 0) see the device: "cuda" becomes the calling
    thread's current card; a named card, "cpu" and None stay."""
    from minicom_tpu_torch.ops import cuda
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert cuda.named("cuda") == torch.device("cuda", 2)
    assert cuda.named(CUDA) == torch.device("cuda", 2)
    assert cuda.named("cuda:1") == torch.device("cuda", 1)
    assert cuda.named("cpu") == torch.device("cpu")
    assert cuda.named(None) is None
