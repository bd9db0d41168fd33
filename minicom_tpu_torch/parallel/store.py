"""Row-sharded read store of a multi-process run.

Each rank keeps only its contiguous row slice of the [N, L] read store
(``local``), so per-rank memory is the store / P; after classify it can also
hold that slice on its device (``local_dev``), where the read-minimizer
kernel reads the rows it owns in place. Stages that need other rows fetch
them through collective exchanges with bounded transient buffers:

* rows(rids)      — rank-SPECIFIC request lists (each rank asks for the rows
                    of its own work range: the serializer's members, the
                    consensus members),
* rows_all(rids)  — IDENTICAL list on every rank (the realignment singleton
                    table, the special-class streams): each rank serves its
                    owned rows once and everyone reassembles.

Both are collective: every rank reaches the same call site (the stages run
in lockstep, the same deterministic host logic computing the same global
decisions everywhere). Request rounds are chunked and the round count is
agreed up front, so ranks with short request lists keep participating until
the longest one is served.

Single-process runs never build this class: the pipeline keeps the plain
matrix, which ``rows_all`` below indexes directly.
"""

from __future__ import annotations

import numpy as np
import torch

from minicom_tpu_torch.ops import cuda
from minicom_tpu_torch.parallel import distributed as dist


class ShardedReadStore:
    def __init__(self, local: np.ndarray, bounds: np.ndarray,
                 local_dev: torch.Tensor | None = None):
        pid, nproc = dist.process_grid()
        if len(bounds) != nproc + 1:
            raise ValueError(f"{len(bounds) - 1} row ranges for {nproc} ranks")
        self.local = local                     # [n_local, L] uint8 (owned)
        self.bounds = np.asarray(bounds, np.int64)
        self.r0 = int(self.bounds[pid])
        self.r1 = int(self.bounds[pid + 1])
        if local.shape[0] != self.r1 - self.r0:
            raise ValueError("local rows differ from the rank's row range")
        self.local_dev = local_dev             # the same rows on a device

    @property
    def shape(self) -> tuple[int, int]:
        return int(self.bounds[-1]), int(self.local.shape[1])

    @property
    def L(self) -> int:
        return int(self.local.shape[1])

    def on_device(self, device: torch.device) -> "ShardedReadStore":
        """The same store with the local slice also on ``device``."""
        return ShardedReadStore(self.local, self.bounds,
                                cuda.to_device(self.local, device))

    # -- collective row access ------------------------------------------------

    def rows(self, rids: np.ndarray, chunk: int | None = None) -> np.ndarray:
        """Gather arbitrary global rows; COLLECTIVE — every rank passes its
        own request list (lengths may differ). Returns [len(rids), L]."""
        _, nproc = dist.process_grid()
        rids = np.asarray(rids, np.int64)
        chunk = chunk or max(1 << 16, (1 << 19) // nproc)
        n_rounds = int(dist.allgather_ragged(
            np.array([-(-len(rids) // chunk)], np.int64)).max())
        out = np.empty((len(rids), self.L), np.uint8)
        for r in range(n_rounds):
            my_req = rids[r * chunk: (r + 1) * chunk]
            out[r * chunk: r * chunk + len(my_req)] = self._exchange(my_req)
        return out

    def rows_all(self, rids: np.ndarray) -> np.ndarray:
        """Gather rows for an IDENTICAL request list on every rank: each rank
        serves its owned rows once. Returns [len(rids), L], identical
        everywhere."""
        pid, _ = dist.process_grid()
        rids = np.asarray(rids, np.int64)
        owner = np.searchsorted(self.bounds[1:-1], rids, side="right")
        payload = self.local[rids[owner == pid] - self.r0].reshape(-1)
        served = dist.allgather_ragged(payload).reshape(-1, self.L)
        # served rows are in (owner rank, request order) order
        inv = np.empty(len(rids), np.int64)
        inv[np.argsort(owner, kind="stable")] = np.arange(len(rids))
        return served[inv]

    def _exchange(self, my_req: np.ndarray) -> np.ndarray:
        pid, _ = dist.process_grid()
        lens, all_req = dist.allgather_ragged_many(
            [np.array([len(my_req)], np.int64), my_req])
        owner = np.searchsorted(self.bounds[1:-1], all_req, side="right")
        payload = self.local[all_req[owner == pid] - self.r0].reshape(-1)
        served = dist.allgather_ragged(payload).reshape(-1, self.L)
        inv = np.empty(len(all_req), np.int64)
        inv[np.argsort(owner, kind="stable")] = np.arange(len(all_req))
        q0 = int(lens[:pid].sum())
        return served[inv[q0: q0 + len(my_req)]]


def maybe_shard(codes: np.ndarray):
    """A fully parsed matrix as a ShardedReadStore (each rank KEEPS only its
    slice) in a multi-process run; the matrix itself otherwise. For inputs
    whose parse cannot be byte-sharded (gzip, the two files of PE)."""
    pid, nproc = dist.process_grid()
    if nproc == 1:
        return codes
    bounds = np.array([codes.shape[0] * p // nproc
                       for p in range(nproc + 1)], np.int64)
    local = np.ascontiguousarray(codes[bounds[pid]:bounds[pid + 1]])
    return ShardedReadStore(local, bounds)


def rows_all(codes, rids: np.ndarray) -> np.ndarray:
    """codes[rids] of a plain matrix, or the collective ``rows_all`` of a
    sharded store (the same request list on every rank)."""
    if isinstance(codes, ShardedReadStore):
        return codes.rows_all(rids)
    return codes[rids]
