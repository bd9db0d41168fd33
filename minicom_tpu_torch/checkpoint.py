"""Stage checkpoint / resume (the reference has none; a crash mid-run just
leaves scratch dirs behind, kthread_hash_realign.c:22,63).

The pipeline's stage boundaries are plain numpy arrays, so a checkpoint is one
``.npz`` per completed expensive stage (``cluster`` -> ``merge`` ->
``realign``), written atomically (tmp + rename). A rerun of ``compress`` with
the same inputs and parameters resumes from the newest valid stage and skips
everything before it; archives produced with and without resume are
byte-identical because every stage is deterministic.

A fingerprint guards against stale state: sha256 over each input file's size,
head and tail bytes, 64 KiB chunks at 64 evenly strided interior offsets, plus
the full user config. Any mismatch makes old checkpoints invisible (they are
ignored, never deleted: a rerun with the original input can still use them).

The ``.npz`` keys and the fingerprint recipe are ``minicom_tpu``'s, so either
package resumes from the other's snapshots. In a multi-process run rank 0
writes each snapshot and every rank reads them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import zipfile

import numpy as np

from minicom_tpu_torch.parallel import distributed as dist
from minicom_tpu_torch.pipeline.cluster import ClusterSet

#: pipeline order; resume picks the latest stage present & valid
STAGES = ("cluster", "merge", "realign")

_HEAD_TAIL = 1 << 20   # bytes of each input hashed from both ends
_N_STRIDES = 64        # interior sample points between head and tail
_STRIDE_CHUNK = 1 << 16  # bytes hashed at each interior sample


def fingerprint(paths: list[str], cfg) -> str:
    """Content+config fingerprint. Hashes the head/tail megabyte plus 64 KiB
    at 64 evenly strided interior offsets: O(MB) for multi-GB inputs, but a
    single-byte edit anywhere leaves at most a ~(size/64) blind span, and the
    size itself participates so same-prefix growth is always caught."""
    h = hashlib.sha256()
    for p in paths:
        size = os.path.getsize(p)
        h.update(f"{os.path.basename(p)}:{size}:".encode())
        with open(p, "rb") as f:
            h.update(f.read(_HEAD_TAIL))
            lo, hi = _HEAD_TAIL, max(_HEAD_TAIL, size - _HEAD_TAIL)
            if 0 < hi - lo <= _N_STRIDES * _STRIDE_CHUNK:
                h.update(f.read(hi - lo))  # small interior: hash it all
            elif hi - lo > 0:
                for i in range(_N_STRIDES):
                    off = lo + (hi - lo) * i // _N_STRIDES
                    f.seek(off)
                    h.update(f.read(min(_STRIDE_CHUNK, hi - off)))
            if size > _HEAD_TAIL:
                f.seek(hi)
                h.update(f.read(_HEAD_TAIL))
    d = dataclasses.asdict(cfg)
    d.pop("checkpoint_dir", None)  # resuming is not parameter-relevant
    h.update(json.dumps(d, sort_keys=True).encode())
    return h.hexdigest()


class StageCheckpoint:
    """Save/load the (ClusterSet, singletons, extra arrays) state at stage
    boundaries."""

    def __init__(self, ckpt_dir: str, paths: list[str], cfg):
        self.dir = ckpt_dir
        self.fp = fingerprint(paths, cfg)
        os.makedirs(ckpt_dir, exist_ok=True)

    def _path(self, stage: str) -> str:
        return os.path.join(self.dir, f"{stage}.npz")

    def save(self, stage: str, cset: ClusterSet, sg: np.ndarray,
             extra: dict[str, np.ndarray] | None = None) -> None:
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r}")
        arrays = {
            "cs_mem_rid": cset.mem_rid, "cs_mem_off": cset.mem_off,
            "cs_mem_dir": cset.mem_dir, "cs_cluster_ptr": cset.cluster_ptr,
            "cs_ref_flat": cset.ref_flat, "cs_ref_ptr": cset.ref_ptr,
            "readlen": np.int64(cset.readlen), "sg": sg,
            "fp": np.frombuffer(self.fp.encode(), np.uint8),
        }
        for k, v in (extra or {}).items():
            arrays["x_" + k] = v
        tmp = self._path(stage) + ".tmp"

        def write():
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            with open(tmp, "wb") as f:
                f.write(buf.getvalue())
            os.replace(tmp, self._path(stage))

        # every rank holds the same state: rank 0 alone writes it (ranks
        # sharing one tmp name would race on its rename), the rest wait; a
        # failed write raises on every rank
        dist.write_together(write, dist.process_grid()[0] == 0, tmp)

    def load(self, stage: str):
        """-> (ClusterSet, sg, extra dict), or None if absent, stale or
        unreadable (the stage is then recomputed)."""
        path = self._path(stage)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                if bytes(z["fp"]).decode() != self.fp:
                    return None
                cset = ClusterSet(
                    int(z["readlen"]), z["cs_mem_rid"], z["cs_mem_off"],
                    z["cs_mem_dir"], z["cs_cluster_ptr"], z["cs_ref_flat"],
                    z["cs_ref_ptr"])
                extra = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
                return cset, z["sg"], extra
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile, UnicodeDecodeError):
            return None  # unreadable/truncated checkpoint: recompute

    def latest(self):
        """Newest valid stage -> (stage name, state) or (None, None). In a
        group the ranks must find the same stage (they would otherwise run
        different stages and wait on each other): ValueError on every rank
        if they do not."""
        found = None, None
        for stage in reversed(STAGES):
            state = self.load(stage)
            if state is not None:
                found = stage, state
                break
        idx = STAGES.index(found[0]) if found[0] else -1
        seen = dist.allgather_ragged(np.array([idx], np.int64))
        if np.any(seen != seen[0]):
            raise ValueError("ranks found different checkpoint stages: "
                             + ", ".join(STAGES[i] if i >= 0 else "none"
                                         for i in seen))
        return found
