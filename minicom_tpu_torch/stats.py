"""Per-stage wall seconds and counters of one compress or decompress run,
and the spans that name them in a ``torch.profiler`` trace.

Every stage (``StageStats.stage``) and sub-stage (``substage``) is also a
``torch.profiler.record_function`` span named ``mtc.<name>``: ``mtc.load``,
``mtc.cluster``, ``mtc.cluster_sort``, ``mtc.entropy.<stream>``, ... A
sub-stage's name starts with its stage's (``stage_of``). Without a running
profiler a span costs one dispatcher call on entry and one on exit."""

from __future__ import annotations

import contextlib
import json
import time

import torch
from torch.profiler import record_function

from minicom_tpu_torch.ops import cuda

SPAN_PREFIX = "mtc."


def stage_of(name: str) -> str:
    """The stage that the sub-stage ``name`` lies in: the part before its
    first "_" or "." (``cluster_sort`` -> ``cluster``, ``entropy.diff`` ->
    ``entropy``)."""
    return name.replace(".", "_").split("_")[0]


@contextlib.contextmanager
def substage(counters: dict | None, key: str):
    """Add the wall seconds of the block to counters['<key>_s'] (a split
    inside a stage, summed over calls; no counter without counters) and
    open the span ``mtc.<key>`` around it (also without counters)."""
    t0 = time.perf_counter()
    try:
        with record_function(SPAN_PREFIX + key):
            yield
    finally:
        if counters is not None:
            counters[key + "_s"] = (counters.get(key + "_s", 0.0)
                                    + time.perf_counter() - t0)


@contextlib.contextmanager
def profiler(device, **kwargs):
    """A running ``torch.profiler.profile`` of the host, every thread of it
    (the entropy stage's pool threads open spans too), and, where ``device``
    is a CUDA device, of the card, started and stopped with that card
    current."""
    dev = torch.device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    card = contextlib.nullcontext()
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        card = torch.cuda.device(dev)
    with card, torch.profiler.profile(
            activities=acts, experimental_config=torch._C._profiler.
            _ExperimentalConfig(profile_all_threads=True), **kwargs) as prof:
        yield prof


class StageStats:
    """Wall seconds by stage, and counters. A stage in which the host
    crossed to a device (``ops/cuda.py``: the host wall spent in the copies,
    summed over threads, and the bytes) also counts those as
    ``device_<stage>_s`` (rounded to ms) and ``device_<stage>_bytes``, by
    the JAX package's rule: only where the stage spent more than 0.1 ms in
    crossings or moved a byte. Unlike the JAX package, which uploads the
    read store outside any stage, the port uploads it in the stage
    ``upload``, so its bytes appear as ``device_upload_bytes``. Sub-stage
    walls (``substage``) are summed unrounded; the summary rounds every
    float ``*_s`` counter to 0.1 ms."""

    def __init__(self):
        self.timings: dict[str, float] = {}
        self.counters: dict[str, int | float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        d0, b0 = cuda.device_seconds(), cuda.device_bytes()
        t0 = time.perf_counter()
        try:
            with record_function(SPAN_PREFIX + name):
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
               **{k: round(v, 4) if k.endswith("_s")
                  and isinstance(v, float) else v
                  for k, v in self.counters.items()}}
        nbytes = self.counters.get("input_bytes")
        if nbytes:
            out["stage_MBps"] = {
                k: round(nbytes / v / 1e6, 2)
                for k, v in self.timings.items() if v > 1e-9}
        return out

    def dump(self) -> str:
        return json.dumps(self.summary(), sort_keys=True)
