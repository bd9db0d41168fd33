"""The fused cluster step over a process group: one rank per shard of the
reads.

Replaces ``minicom_tpu/parallel/mesh.py::sharded_cluster_step``, which jits
the JAX ``cluster_step`` with the read batch sharded over the mesh axis
``d``: consensus and coverage come out replicated, the per-read vectors
sharded like the input. Here one process per shard, in a
``torch.distributed`` group, stands in for that axis: one process per card
(``distributed.place``) is the port's counterpart of the in-process mesh.
Nothing else of the JAX module is kept.

On each rank, in order (``ops/step.py`` holds the kernels' wrappers):

1. keys: kernel (c) and ``mtc_step_keys`` on the local rows;
2. (key, mz) all-gathered in rank order, 12 bytes a read;
3. one stable ``torch.sort`` of the global keys and ``mtc_step_segments``,
   on every rank. The ranks rely on getting the same order, seg_id, first
   and seg_max: the stable order of equal keys is unique, and the segments
   kernel is deterministic;
4. ownership: rank r owns the segments whose first member's sorted position
   lies in its own row range [b_r, b_r+1); their members are one run of
   sorted positions. A rank whose range lies inside a segment that began on
   an earlier rank owns none; it still joins every collective;
5. rows: one ``all_to_all_single`` hands each owner the rows of its members
   that each rank holds (about N L / P bytes a rank);
6. one launch of ``mtc_step_vote`` on the owned segments, its inputs rebased
   to them: segment g's columns start at g 2L, so rank r's start at g_lo
   2L, and the last owner's run to span_cols, streaming the empty tail as
   zeros. Where every owned column lies at or past span_cols there is
   nothing to vote: each member's L bases are mismatches, as on one card;
7. each owner's column range of consensus and coverage broadcast straight
   into the whole output on every rank, at most ``CHUNK_BYTES`` a call;
   diffs all-gathered; seg_id and order sliced, being replicated.

The four exchanges (keys, rows, columns, diffs) are written once, over
tensors on the exchange device (``exchange_device``): the rank's own card
where every rank owns one (``distributed.nccl``), so NCCL moves them between
cards and none crosses the host, as XLA's collectives over ICI; else the
host, over gloo (ranks that share a card, which NCCL refuses, or CPU ranks),
the rows' bytes copied through host memory. The compute stays on the device
of the local rows.

The module also exposes the process's crossing counters as the JAX module
does: ``device_seconds()``, ``device_bytes()`` and
``reset_device_seconds()`` (kept in ``ops/cuda.py``).
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch
import torch.distributed as tdist

from minicom_tpu_torch.ops import cuda, sketch, step
from minicom_tpu_torch.ops.cuda import (  # noqa: F401 (the JAX names)
    device_bytes, device_seconds, reset_device_seconds)
from minicom_tpu_torch.parallel import distributed as dist

CHUNK_BYTES = 1 << 30   # the most bytes of one broadcast of output columns


def exchange_device(dev: torch.device) -> torch.device:
    """Where the step's exchanges run for rows on ``dev``: ``dev`` itself
    where the group carries CUDA tensors over NCCL (every rank owns its
    card), else the host (gloo)."""
    if dev.type == "cuda" and dist.nccl():
        return dev
    return torch.device("cpu")


class _Record:
    """What a call fills into its ``stats`` dict, if given one: the backend
    of its exchanges, device ms per piece (CUDA events, on the card),
    seconds and bytes this rank sent and received per collective and the
    bytes each moved between the card and the host (``host_B``), host-device
    copies, what it owned, and the wall (to the card's last work)."""

    def __init__(self, stats: dict | None, dev: torch.device,
                 xdev: torch.device):
        self.stats = stats
        self.dev, self.xdev = dev, xdev
        self.events = []
        self.host = collections.Counter()
        self.on_card = dev.type == "cuda"
        self.t0 = time.perf_counter()
        if stats is not None:
            stats.clear()
            stats.update(backend="nccl" if xdev.type == "cuda" else "gloo",
                         device_ms={}, collectives={},
                         copies={"s": 0.0, "d2h_B": 0, "h2d_B": 0})

    def _events(self, dev: torch.device):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record(torch.cuda.current_stream(dev))
        return ev

    @contextlib.contextmanager
    def device(self, name: str):
        if self.stats is None or not self.on_card:
            yield
            return
        ev = self._events(self.dev)
        yield
        ev[1].record(torch.cuda.current_stream(self.dev))
        self.events.append((name, *ev))

    @contextlib.contextmanager
    def collective(self, name: str, sent: int, recv: int):
        """Seconds of the block: host clock over gloo, CUDA events on the
        card over NCCL (an NCCL call returns before it ends)."""
        if self.stats is None:
            yield
            return
        entry = {"s": 0.0, "sent_B": int(sent), "recv_B": int(recv)}
        self.stats["collectives"][name] = entry
        if self.xdev.type == "cuda":
            ev = self._events(self.xdev)
            yield
            ev[1].record(torch.cuda.current_stream(self.xdev))
            self.events.append((entry, *ev))
            return
        t = time.perf_counter()
        yield
        entry["s"] = time.perf_counter() - t

    def to_x(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """``t`` on the exchange device, a crossing counted as the
        exchange ``name``'s host bytes."""
        if t.device == self.xdev:
            return t
        self.host[name] += t.numel() * t.element_size()
        return self.to_host(t)

    def into_x(self, t: torch.Tensor, out: torch.Tensor, name: str) -> None:
        """``t`` written into ``out``, a view of an exchange buffer."""
        if t.device == out.device:
            out[:] = t
            return
        self.host[name] += t.numel() * t.element_size()
        self.to_host(t, out)

    def from_x(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """An exchange's result ``t`` on the device of the rows."""
        if self.xdev == self.dev:
            return t
        self.host[name] += t.numel() * t.element_size()
        return self.to_device(t, self.dev)

    def to_host(self, t: torch.Tensor, out: torch.Tensor | None = None
                ) -> torch.Tensor:
        """``cuda.to_host``, also counted in this call's copies."""
        s = time.perf_counter()
        out = cuda.to_host(t, out)
        if t.device.type != "cpu":
            self._copied("d2h_B", t, time.perf_counter() - s)
        return out

    def to_device(self, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """``cuda.to_device``, also counted in this call's copies."""
        s = time.perf_counter()
        out = cuda.to_device(t, dev)
        if t.device.type != dev.type:
            self._copied("h2d_B", t, time.perf_counter() - s)
        return out

    def _copied(self, key: str, t: torch.Tensor, dt: float) -> None:
        if self.stats is not None:
            c = self.stats["copies"]
            c["s"] += dt
            c[key] += t.numel() * t.element_size()

    def finish(self, **owned) -> None:
        if self.stats is None:
            return
        if self.on_card:
            torch.cuda.synchronize(self.dev)
        for what, a, b in self.events:
            if isinstance(what, dict):
                what["s"] = a.elapsed_time(b) / 1e3
            else:
                self.stats["device_ms"][what] = a.elapsed_time(b)
        for name, entry in self.stats["collectives"].items():
            entry["host_B"] = self.host[name]
        self.stats["owned"] = owned
        self.stats["wall_s"] = time.perf_counter() - self.t0


def _local_error(codes: torch.Tensor) -> str | None:
    """What this rank's input alone makes wrong, else None."""
    try:
        cuda.check(codes, torch.uint8, 2, "codes")
    except ValueError as e:
        return str(e)
    if codes.device.type not in ("cpu", "cuda"):
        return (f"codes on {codes.device}: the kernels take CUDA tensors, "
                "the plain versions CPU tensors")
    if codes.device.type == "cuda" and codes.shape[1] > step.L_MAX:
        return (f"reads of {codes.shape[1]} bases: the card takes at most "
                f"{step.L_MAX}")
    return None


def _local_keys(codes: torch.Tensor, k: int):
    """(key int64, mz int32) of the local rows: kernel (c) and
    ``mtc_step_keys`` on the card (no launch for no rows), the plain
    minimizer on the CPU."""
    n = codes.shape[0]
    if codes.device.type == "cpu":
        return step._minimizers_plain(codes, k)
    if n == 0:
        return (torch.empty(0, dtype=torch.int64, device=codes.device),
                torch.empty(0, dtype=torch.int32, device=codes.device))
    rids = torch.arange(n, dtype=torch.int32, device=codes.device)
    return step._keys(codes, sketch.sketch_reads_device(codes, rids, k), k)


def _allgather(parts: list[torch.Tensor], counts: list[int]
               ) -> list[torch.Tensor]:
    """Collective: 1-D tensors of ``counts[rank]`` items each, on one device,
    gathered in rank order over that device: tensors of sum(counts) items.
    A rank's items go as one row of bytes, each part padded to the largest
    count."""
    nproc = len(counts)
    most = max(counts)
    dev = parts[0].device
    width = [most * p.element_size() for p in parts]
    row = torch.zeros(sum(width), dtype=torch.uint8, device=dev)
    at = 0
    for p, w in zip(parts, width):
        if p.numel():   # (an empty array's view may have stride 0)
            raw = p.reshape(-1).view(torch.uint8)
            row[at:at + len(raw)] = raw
        at += w
    got = torch.empty((nproc, len(row)), dtype=torch.uint8, device=dev)
    tdist.all_gather(list(got.unbind(0)), row)
    out, at = [], 0
    for p, w in zip(parts, width):
        size = p.element_size()
        out.append(torch.cat([got[r, at:at + counts[r] * size]
                              for r in range(nproc)]).view(p.dtype))
        at += w
    return out


def _exchange_rows(send: torch.Tensor, send_counts: list[int],
                   recv_counts: list[int]) -> torch.Tensor:
    """Collective: uint8 rows [n, L], the first send_counts[0] to rank 0,
    the next send_counts[1] to rank 1, ...; returns the rows received,
    recv_counts[r] from rank r, in rank order, on the device of ``send``."""
    recv = torch.empty((sum(recv_counts), send.shape[1]), dtype=torch.uint8,
                       device=send.device)
    tdist.all_to_all_single(recv, send, recv_counts, send_counts)
    return recv


def _broadcast_ranges(out: torch.Tensor, col: list[int]) -> None:
    """Collective: rank r's range out[col[r]:col[r + 1]] broadcast in place
    to every rank, at most CHUNK_BYTES a call."""
    step_n = max(1, CHUNK_BYTES // out.element_size())
    for r in range(len(col) - 1):
        for a in range(col[r], col[r + 1], step_n):
            tdist.broadcast(out[a:min(a + step_n, col[r + 1])], src=r)


def sharded_cluster_step(codes_local: torch.Tensor, k: int, span_cols: int,
                         stats: dict | None = None):
    """One clustering round over the rows that the ranks of the group hold.

    Collective: every rank calls it with its own rows of the batch,
    ``codes_local`` [n_r, L] uint8 (codes 0..3, N substituted), in rank
    order; any split, an empty shard too. Returns (consensus [span_cols]
    uint8 and coverage [span_cols] int32, whole on every rank; diffs,
    seg_id and order, int32, this rank's slice [b_r, b_r+1) of the sorted
    positions, where b_r is the number of rows before this rank's; order
    holds global row ids), on the device of ``codes_local``. The
    rank-order concatenation of the slices is ``ops/step.py::cluster_step``
    of the whole batch, byte for byte; with one process this is that call.

    On the card it launches kernel (c), ``mtc_step_keys``,
    ``mtc_step_segments`` and ``mtc_step_vote`` once each (no keys for an
    empty shard; no vote for a rank that owns no segment or whose columns
    all lie at or past span_cols) and one ``torch.sort``; on the CPU the
    plain versions. ValueError on every rank for what ``cluster_step``
    refuses (on the global N) and for ranks whose rows differ in length or
    whose input is not a uint8 matrix; a failed launch or collective
    raises: over NCCL too, with no other way round. ``stats``, a dict, is
    filled with the exchanges' backend ("nccl" or "gloo"), this call's
    device ms per piece (on the card), seconds and bytes sent and received
    per collective and the bytes each moved between card and host
    (``host_B``: 0 over NCCL), host-device copies, what the rank owned and
    the wall."""
    pid, nproc = dist.process_grid()
    if nproc == 1:
        return step.cluster_step(codes_local, k, span_cols)
    dist.raise_together(_local_error(codes_local))
    dev = codes_local.device
    xdev = exchange_device(dev)
    rec = _Record(stats, dev, xdev)
    n_r, L = codes_local.shape
    with rec.collective("shapes", 16 * (nproc - 1), 16 * (nproc - 1)):
        shapes = dist.allgather_ragged(np.array([n_r, L], np.int64))
    shapes = shapes.reshape(nproc, 2)
    if (shapes[:, 1] != L).any():
        raise ValueError(f"the ranks' reads have {shapes[:, 1].tolist()} "
                         "bases")
    bounds = np.concatenate([[0], np.cumsum(shapes[:, 0])])
    N = int(bounds[-1])
    step._check(N, L, k, span_cols)
    b0, b1 = int(bounds[pid]), int(bounds[pid + 1])
    on_card = dev.type == "cuda"

    # 1-2. the local keys, gathered in rank order
    with rec.device("keys"):
        key, mz = _local_keys(codes_local, k)
    key, mz = rec.to_x(key, "keys"), rec.to_x(mz, "keys")
    with rec.collective("keys", 12 * n_r * (nproc - 1), 12 * (N - n_r)):
        key, mz = _allgather([key, mz], shapes[:, 0].tolist())
    key, mz = rec.from_x(key, "keys"), rec.from_x(mz, "keys")

    # 3. sort and segments, the same on every rank
    with rec.device("sort"):
        skey, order = torch.sort(key, stable=True)
    del key
    with rec.device("segments"):
        if on_card:
            order32, smz, seg_id, first, seg_max = step._segments(skey, order,
                                                                  mz)
            nseg = first[N + 1:N + 2]
        else:
            order32, smz, seg_id, first, seg_max = step._segments_plain(
                skey, order, mz)
            nseg = torch.tensor([len(first) - 1], dtype=torch.int32)
    del skey, order, mz

    # 4. ownership: g[r], the segments before rank r's first owned one, is
    # 1 + the segment of the member before b_r; f[r] = first[g[r]] its first
    # member; C[s, o] the members of rank o's segments that rank s holds
    bnd = rec.to_device(torch.from_numpy(bounds.astype(np.int32)), dev)
    inner = bnd[1:-1]
    g = torch.cat([bnd[:1], torch.where(
        inner > 0, seg_id[(inner - 1).clamp(min=0).long()] + 1, 0), nseg])
    f = first[g.long()]
    src = torch.searchsorted(bnd[1:], order32, right=True)
    owner = torch.repeat_interleave(
        torch.arange(nproc, device=dev), (f[1:] - f[:-1]).long(),
        output_size=N)
    C = torch.bincount(src * nproc + owner, minlength=nproc * nproc)
    plan = rec.to_host(torch.cat([g.long(), f.long(), C])).numpy()
    g, f = plan[:nproc + 1].tolist(), plan[nproc + 1:2 * nproc + 2].tolist()
    C = plan[2 * nproc + 2:].reshape(nproc, nproc)
    del owner
    g0, g1, f0, f1 = g[pid], g[pid + 1], f[pid], f[pid + 1]
    n_own = f1 - f0
    # owned columns: rank r's from g[r] 2L (span_cols for a rank after the
    # last owner), so the last owner's run to span_cols
    col = [span_cols if g[r] >= g[nproc] else min(span_cols, g[r] * 2 * L)
           for r in range(nproc)] + [span_cols]

    # 5. the owned segments' rows, sorted position by position as received
    held = torch.nonzero(src == pid)[:, 0]
    send = rec.to_x(codes_local[(order32[held] - b0).long()], "rows")
    del held
    send_counts, recv_counts = C[pid].tolist(), C[:, pid].tolist()
    with rec.collective("rows", L * (sum(send_counts) - C[pid, pid]),
                        L * (sum(recv_counts) - C[pid, pid])):
        rows = _exchange_rows(send, send_counts, recv_counts)
    del send
    rows = rec.from_x(rows, "rows")
    got = torch.argsort(src[f0:f1], stable=True)
    order_loc = torch.empty(n_own, dtype=torch.int32, device=dev)
    order_loc[got] = torch.arange(n_own, dtype=torch.int32, device=dev)
    del src, got

    # 6. the vote of the owned segments, rebased to them
    span_loc = col[pid + 1] - g0 * 2 * L
    voted = n_own > 0 and span_loc > 0
    if voted:
        smz_loc, sid_loc = smz[f0:f1], seg_id[f0:f1] - g0
        with rec.device("vote"):
            if on_card:
                first_loc = torch.empty(n_own + 2, dtype=torch.int32,
                                        device=dev)
                first_loc[:g1 - g0 + 1] = first[g0:g1 + 1] - f0
                first_loc[n_own + 1] = g1 - g0
                cons_loc, cov_loc, diffs_loc = step._vote(
                    rows, order_loc, smz_loc, sid_loc, first_loc,
                    seg_max[g0:g1], span_loc)
            else:
                cons_loc, cov_loc, diffs_loc = step._vote_plain(
                    rows, order_loc, smz_loc, sid_loc, seg_max[g0:g1],
                    span_loc)
    else:   # no columns: every base against 255
        diffs_loc = torch.full((n_own,), L, dtype=torch.int32, device=dev)
    del rows, order_loc, smz, first, seg_max

    # 7. the outputs
    lo, hi = col[pid], col[pid + 1]
    cons = torch.empty(span_cols, dtype=torch.uint8, device=xdev)
    cov = torch.empty(span_cols, dtype=torch.int32, device=xdev)
    if voted:   # straight into the whole output: no transient copy
        rec.into_x(cons_loc, cons[lo:hi], "columns")
        rec.into_x(cov_loc, cov[lo:hi], "columns")
        del cons_loc, cov_loc
    with rec.collective("columns", 5 * (hi - lo) * (nproc - 1),
                        5 * (span_cols - (hi - lo))):
        _broadcast_ranges(cons, col)
        _broadcast_ranges(cov, col)
    diffs_loc = rec.to_x(diffs_loc, "diffs")
    with rec.collective("diffs", 4 * n_own * (nproc - 1), 4 * (N - n_own)):
        (diffs,) = _allgather([diffs_loc], [f[r + 1] - f[r]
                                            for r in range(nproc)])
    del diffs_loc
    out = (rec.from_x(cons, "columns"), rec.from_x(cov, "columns"),
           rec.from_x(diffs[b0:b1].clone(), "diffs"),
           seg_id[b0:b1].clone(), order32[b0:b1].clone())
    rec.finish(rows=n_r, segments=g1 - g0, members=n_own, columns=hi - lo,
               voted=voted)
    return out
