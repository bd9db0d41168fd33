"""Multi-process compression over ``torch.distributed``.

The heavy stages split the SAME canonical work across the processes of a
group and exchange results with ordered ragged all-gathers, so the archive is
byte-identical for any process count. Work is cut into contiguous,
canonically ordered ranges (``partition``): byte ranges of the FASTQ, the
pending reads each rank owns, hash-value ranges of the round sort, cluster
ranges of the consensus, chunk ranges of the contig sketch, probe and pair
ranges of the merge search, contig ranges of the realign probe, member
ranges of the serializer and the decoder, stream ranges of the container.
Rank-order concatenation of the pieces reproduces the serial order.

Every payload of this module is a host numpy array and goes over gloo, as
the JAX package's ``multihost_utils`` moved host arrays. One process runs
per card, the PyTorch form of the JAX mesh: ``initialize`` binds each rank
to its card (``place``: ``cuda:{local_rank}`` where the host has a card for
each local rank) and, where every rank owns its card, the group carries
CUDA tensors over NCCL beside gloo (``choose_backend``), which
``parallel/mesh.py``'s sharded step uses between cards. Where ranks share
a card (NCCL refuses two ranks on one card) or the host has none, the group
is gloo only.

Usage, one process per card:

    torchrun --nproc-per-node 4 prog.py     # prog calls initialize()
    # or, without torchrun (one host: the local rank is the rank):
    distributed.initialize("file:///shared/pg", world_size=2, rank=r)
    compressor.compress(...)   # stages shard; rank 0 writes the archive
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as tdist

_PID = 0
_NPROC = 1

# both backends: host tensors over gloo, CUDA tensors over NCCL
MIXED = "cpu:gloo,cuda:nccl"


@dataclasses.dataclass(frozen=True)
class Placement:
    """The card a rank runs on, and whether another rank of its host runs
    on the same card."""
    device: torch.device
    shared: bool


# what ``initialize`` chose; None outside a group it joined
_PLACEMENT: Placement | None = None
_BACKEND: str | None = None


def place(local_rank: int, local_world_size: int, count: int) -> Placement:
    """The card of local rank ``local_rank`` of ``local_world_size`` on a
    host with ``count`` cards: ``cuda:{local_rank}`` where there is a card
    for each local rank, else ``cuda:{local_rank % count}``, shared by the
    local ranks equal modulo ``count``. RuntimeError without a card."""
    if count < 1:
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available")
    if not 0 <= local_rank < local_world_size:
        raise ValueError(f"local rank {local_rank} outside "
                         f"{local_world_size} local ranks")
    card = local_rank % count
    return Placement(torch.device("cuda", card),
                     card + count < local_world_size)


def choose_backend(world_size: int, local_world_size: int,
                   count: int) -> str:
    """The backend of a group of ``world_size`` ranks, ``local_world_size``
    of them on a host with ``count`` cards: gloo and NCCL (``MIXED``) where
    every rank owns a card, gloo alone where ranks share one, there is
    none, or the group is one rank (nothing to exchange). The same on every
    rank of a host, so the ranks agree."""
    return MIXED if world_size > 1 and local_world_size <= count else "gloo"


def local_ranks(rank: int, world_size: int,
                local_rank: int | None = None) -> tuple[int, int]:
    """(local rank, local world size): ``local_rank`` where given, else
    torchrun's LOCAL_RANK, else the rank; torchrun's LOCAL_WORLD_SIZE, else
    the world size (a group of one host)."""
    env = os.environ
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    return local_rank, int(env.get("LOCAL_WORLD_SIZE", world_size))


def initialize(init_method: str = "env://", world_size: int | None = None,
               rank: int | None = None,
               timeout: datetime.timedelta = datetime.timedelta(minutes=30),
               local_rank: int | None = None) -> None:
    """Join a process group, this rank bound to its card where the host has
    one (``place``, then ``torch.cuda.set_device``), over the backend
    ``choose_backend`` gives. ``env://`` reads MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK, and LOCAL_RANK and LOCAL_WORLD_SIZE (as
    ``torchrun`` sets them); a ``file://`` or ``tcp://`` method needs
    ``world_size`` and ``rank``, and takes ``local_rank`` (default: the
    rank; the host's ranks: the world size, a group of one host).
    A collective that waits longer than ``timeout`` raises."""
    global _PLACEMENT, _BACKEND
    kw = {} if world_size is None else {"world_size": world_size,
                                        "rank": rank}
    g_rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    g_world = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
               else world_size)
    lr, lws = local_ranks(g_rank, g_world, local_rank)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = choose_backend(g_world, lws, count)
    placement = place(lr, lws, count) if count else None
    if placement is not None:
        torch.cuda.set_device(placement.device)
        if backend == MIXED:   # NCCL's communicator made now, on this card
            kw["device_id"] = placement.device
    tdist.init_process_group(backend, init_method=init_method,
                             timeout=timeout, **kw)
    _PLACEMENT, _BACKEND = placement, backend


def placement() -> Placement | None:
    """This rank's placement in a group that ``initialize`` joined on a
    host with cards; None otherwise."""
    if _PLACEMENT is not None and tdist.is_initialized():
        return _PLACEMENT
    return None


def rank_device() -> torch.device:
    """The card this process runs on: its rank's (``placement``) in a
    group, else the calling thread's current CUDA device."""
    p = placement()
    return p.device if p else torch.device("cuda",
                                           torch.cuda.current_device())


def nccl() -> bool:
    """Whether the group carries CUDA tensors over NCCL: every rank owns
    its card."""
    return placement() is not None and _BACKEND == MIXED


def set_process_grid(pid: int, nproc: int) -> None:
    """The grid ``process_grid`` reports while no group is initialized
    (``partition`` alone can run on it; a collective cannot)."""
    global _PID, _NPROC
    if not 0 <= pid < nproc:
        raise ValueError(f"rank {pid} outside a grid of {nproc}")
    _PID, _NPROC = pid, nproc


def process_grid() -> tuple[int, int]:
    """(rank, world size) of the initialized torch group, else the grid of
    ``set_process_grid`` ((0, 1) by default)."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return _PID, _NPROC


def partition(weights: np.ndarray) -> list[tuple[int, int]]:
    """Split items into NPROC contiguous ranges of ~equal total weight.

    Deterministic: ranges depend only on the weights and the process count.
    Returns [(lo, hi)] per rank (some possibly empty).
    """
    _, nproc = process_grid()
    n = len(weights)
    csum = np.cumsum(np.asarray(weights, np.float64))
    total = csum[-1] if n else 0.0
    bounds = [0]
    for p in range(1, nproc):
        bounds.append(int(np.searchsorted(csum, total * p / nproc)))
    bounds.append(n)
    for i in range(1, len(bounds)):  # enforce monotonicity on degenerate data
        bounds[i] = max(bounds[i], bounds[i - 1])
    return [(bounds[p], bounds[p + 1]) for p in range(nproc)]


def my_partition(weights: np.ndarray) -> tuple[int, int]:
    return partition(weights)[process_grid()[0]]


def allgather_ragged(arr: np.ndarray) -> np.ndarray:
    """Ordered all-gather of a 1-D array with per-process lengths; the result
    is the rank-order concatenation (identical on every process). No-op with
    a single process."""
    if process_grid()[1] == 1:
        return arr
    return allgather_ragged_many([arr])[0]


def allgather_ragged_many(arrays: list[np.ndarray]) -> list[np.ndarray]:
    """Ordered all-gather of several 1-D arrays in one exchange: their int64
    byte lengths first, then one uint8 payload per rank, padded to the
    largest rank's; each result is viewed back as its input's dtype."""
    _, nproc = process_grid()
    if nproc == 1:
        return list(arrays)
    views = [np.ascontiguousarray(a).reshape(-1).view(np.uint8)
             for a in arrays]
    lens_local = torch.tensor([len(v) for v in views], dtype=torch.int64)
    lens_all = torch.empty((nproc, len(views)), dtype=torch.int64)
    tdist.all_gather(list(lens_all.unbind(0)), lens_local)
    lens = lens_all.numpy()
    pad = np.zeros(max(1, int(lens.sum(axis=1).max())), np.uint8)
    n = sum(len(v) for v in views)
    if n:
        np.concatenate(views, out=pad[:n])
    got = torch.empty((nproc, len(pad)), dtype=torch.uint8)
    tdist.all_gather(list(got.unbind(0)), torch.from_numpy(pad))
    g = got.numpy()
    starts = np.concatenate([np.zeros((nproc, 1), np.int64),
                             np.cumsum(lens, axis=1)], axis=1)
    return [np.concatenate([g[p, starts[p, i]:starts[p, i + 1]]
                            for p in range(nproc)]).view(np.asarray(a).dtype)
            for i, a in enumerate(arrays)]


def allgather_bytes(data: bytes) -> bytes:
    """Ordered all-gather of byte strings: the rank-order concatenation
    (``data`` itself with a single process)."""
    if process_grid()[1] == 1:
        return data
    return allgather_ragged(np.frombuffer(data, np.uint8)).tobytes()


class GroupError(ValueError):
    """An error that ``raise_together`` raised on every rank of a group at
    the same point: the ranks are still in step, so the group can close
    with its barrier."""


def raise_together(err: str | None) -> None:
    """Collective: raise on every rank when any rank passes an error
    message (the first failing rank's message): ``GroupError``, a
    ValueError, in a group; a plain ValueError with one process. A
    rank-local check that sits before a collective reports through this, so
    no rank raises alone while the others wait in the next exchange."""
    if process_grid()[1] == 1:
        if err is not None:
            raise ValueError(err)
        return
    msg = np.frombuffer((err or "").encode(), np.uint8)
    flags, lens, msgs = allgather_ragged_many(
        [np.array([err is not None], bool), np.array([len(msg)], np.int64),
         msg])
    if flags.any():
        first = int(np.argmax(flags))
        start = int(lens[:first].sum())
        raise GroupError(msgs[start:start + lens[first]].tobytes().decode(
            errors="replace"))


def write_together(write, writer: bool, *tmp_paths: str) -> None:
    """Collective in place of "the writing ranks write, then a barrier":
    the ranks with ``writer`` call ``write()``, then all meet. Whatever a
    write raises (a missing directory, a full disk, no memory for a buffer)
    removes ``tmp_paths`` and raises on every rank within the exchange,
    where a bare barrier would keep the other ranks waiting until the
    group's timeout. With one process the exception itself propagates."""
    err = None
    if writer:
        try:
            write()
        except Exception as e:
            for tmp in tmp_paths:
                with contextlib.suppress(OSError):
                    os.unlink(tmp)
            if process_grid()[1] == 1:
                raise
            err = f"{type(e).__name__}: {e}"
    raise_together(err)


def shutdown(in_step: bool = True) -> None:
    """Leave the group: wait for every rank, then destroy it (a rank that
    exits while another still reads from it can abort in gloo's teardown).
    After an exception that this rank may have raised alone, pass
    ``in_step=False``: no barrier, which the other ranks might never
    reach."""
    global _PLACEMENT, _BACKEND
    if tdist.is_available() and tdist.is_initialized():
        if in_step:
            tdist.barrier()
        tdist.destroy_process_group()
    _PLACEMENT = _BACKEND = None


@contextlib.contextmanager
def closing_group():
    """Leave the group at the end of the block as its outcome allows: with
    the barrier after a clean end or a ``GroupError`` (every rank raised
    it), without it after any other exception, which this rank may have
    raised alone. The exception goes on to the caller, after the group is
    destroyed: a process that ends with a live group can abort in gloo's
    teardown."""
    try:
        yield
    except GroupError:
        shutdown()
        raise
    except BaseException:
        shutdown(in_step=False)
        raise
    shutdown()
