"""Per-stage wall seconds and counters of one compress or decompress run."""

from __future__ import annotations

import contextlib
import json
import time

from minicom_tpu_torch.ops import cuda


@contextlib.contextmanager
def substage(counters: dict | None, key: str):
    """Add the wall seconds of the block to counters['<key>_s'] (a split
    inside a stage; no-op without counters)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if counters is not None:
            counters[key + "_s"] = round(
                counters.get(key + "_s", 0.0) + time.perf_counter() - t0, 3)


class StageStats:
    """Wall seconds by stage, and counters. A stage in which the host
    crossed to a device (``ops/cuda.py``: the host wall spent in the copies,
    summed over threads, and the bytes) also counts those as
    ``device_<stage>_s`` (rounded to ms) and ``device_<stage>_bytes``, by
    the JAX package's rule: only where the stage spent more than 0.1 ms in
    crossings or moved a byte. Unlike the JAX package, which uploads the
    read store outside any stage, the port uploads it in the stage
    ``upload``, so its bytes appear as ``device_upload_bytes``."""

    def __init__(self):
        self.timings: dict[str, float] = {}
        self.counters: dict[str, int | float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        d0, b0 = cuda.device_seconds(), cuda.device_bytes()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = (self.timings.get(name, 0.0)
                                  + time.perf_counter() - t0)
            ds = cuda.device_seconds() - d0
            db = cuda.device_bytes() - b0
            if ds > 1e-4 or db:
                self.counters[f"device_{name}_s"] = round(
                    self.counters.get(f"device_{name}_s", 0.0) + ds, 3)
                self.counters[f"device_{name}_bytes"] = (
                    self.counters.get(f"device_{name}_bytes", 0) + db)

    def set(self, key: str, value):
        self.counters[key] = value

    def summary(self) -> dict:
        out = {"timings_s": {k: round(v, 4) for k, v in self.timings.items()},
               **self.counters}
        nbytes = self.counters.get("input_bytes")
        if nbytes:
            out["stage_MBps"] = {
                k: round(nbytes / v / 1e6, 2)
                for k, v in self.timings.items() if v > 1e-9}
        return out

    def dump(self) -> str:
        return json.dumps(self.summary(), sort_keys=True)
