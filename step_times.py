#!/usr/bin/env python3
"""The fused cluster step of minicom_tpu_torch on one CUDA GPU: its kernels
timed at the main path's shapes, beside any other ``csrc/step.cu``.

    python3 step_times.py [N_READS] [NAME=PATH ...]   # repository root

Runs chip_smoke.py's phase 0 (the card's name and power limit, the build),
makes N_READS reads (default 5,000,000: chip_smoke's phase 2 set,
``bench.make_dataset``, seed 7) and their read store (N substituted by
``classify``). Builds the shipped ``csrc/step.cu`` and each NAME=PATH given
(another step.cu with the same three entry points, the parent commit's,
say, written into a gitignored directory) as shared libraries of their own
(one nvcc each, all at once, ``-Xptxas -v``). Then, on the store's first
2^20 reads (chip_smoke's phase 7 set) and on all of it (k = 31, span_cols
N 2L): runs ``ops/step.py::cluster_step``'s pieces once, holds each
library's three kernels equal to the module's outputs on the same device
tensors (the segments' outputs filled with -7 first), and times each kernel
from CUDA graphs of 20 launches (median of 10 replays), the libraries in
turns: in order, then reversed; the step and the sort from CUDA events.
Prints each library's registers and spills and its ms per kernel and turn;
the last line is the JSON list, a size each, of those with the bounds of
the kernels' work (``chip_smoke._step_bounds``). Any failure ends the run
with a traceback and a non-zero exit.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

import chip_smoke
from bench import make_dataset
from minicom_tpu_torch import CompressorConfig
from minicom_tpu_torch.io import fastq
from minicom_tpu_torch.ops import cuda, sketch, step
from minicom_tpu_torch.pipeline import classify

SRC = os.path.join(chip_smoke.ROOT, "minicom_tpu_torch", "csrc", "step.cu")
KERNELS = chip_smoke.STEP_KERNELS


def build(sources, out_dir):
    """{name: {entry: ctypes function}}, one shared library a source, all
    nvcc runs at once; prints the registers and spills ptxas reports."""
    procs = {}
    for name, path in sources.items():
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = so, subprocess.Popen(
            [cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             "-Xptxas", "-v", path, "-o", so], stderr=subprocess.PIPE,
            text=True)
    libs = {}
    for name, (so, p) in procs.items():
        err = p.communicate()[1]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        lines = err.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln:
                kernel = ln.split("_kernel")[0].rsplit("_", 1)[-1]
                print(f"[step] {name} {kernel}: " + "; ".join(
                    x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 5]
                    if "registers" in x or "spill" in x))
        lib = ctypes.CDLL(so)
        libs[name] = {}
        for entry in KERNELS:
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = cuda._SIGS[entry]
            libs[name][entry] = fn
    return libs


def call(fn, *args):
    """One launch of a ctypes entry point on the current stream."""
    raw = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = fn(*raw, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA error {err}")


def time_at(c, libs) -> dict:
    """Each library's three kernels on the reads ``c`` (k = 31, span_cols N
    2L): held equal to the module's outputs, then timed from CUDA graphs in
    turns (in order, then reversed); with the step's and the sort's ms
    (CUDA events, medians of 10) and the bounds of the kernels' work."""
    N, L = c.shape
    k, span, G = 31, N * 2 * L, step.tile_slots(L)
    rids = torch.arange(N, dtype=torch.int32, device=c.device)
    sk = sketch.sketch_reads_device(c, rids, k)
    key, mz = step._keys(c, sk, k)
    skey, order = torch.sort(key, stable=True)
    seg = step._segments(skey, order, mz)
    want = (key, mz) + seg + step._vote(c, *seg, span)
    nseg = int(seg[3][N + 1])

    # each library's outputs, into buffers shared by all of them; the
    # segments' scratch four times the shipped size, room for a variant
    # with tiles down to a quarter of SEG_TILE (or the older two-pass scan)
    keys = (torch.empty_like(key), torch.empty_like(mz))
    segs = tuple(torch.empty_like(x) for x in seg)
    scratch = torch.empty(4 * step.seg_scratch_words(N), dtype=torch.int32,
                          device=c.device)
    outs = tuple(torch.empty_like(x) for x in want[7:])
    runs = {name: {
        "mtc_step_keys": lambda f=f: call(f["mtc_step_keys"], c, L, sk, N,
                                          k, *keys),
        "mtc_step_segments": lambda f=f: call(f["mtc_step_segments"], skey,
                                              order, mz, N, scratch,
                                              *segs),
        "mtc_step_vote": lambda f=f: call(f["mtc_step_vote"], c, L, *seg, N,
                                          G, span, *outs),
    } for name, f in libs.items()}
    for name, run in runs.items():
        for out in segs:
            out.fill_(-7)
        for fn in run.values():
            fn()
        got = keys + segs + outs
        for i, (g, w) in enumerate(zip(got, want)):
            m = nseg + 1 if i == 5 else (nseg if i == 6 else len(w))
            if not torch.equal(g[:m], w[:m]) or (
                    i == 5 and not torch.equal(g[N + 1], w[N + 1])):
                raise AssertionError(f"{name}: output {i} differs")
    times = {name: {kn: [] for kn in KERNELS} for name in runs}
    for name in list(runs) + list(reversed(runs)):
        for kn, fn in runs[name].items():
            times[name][kn].append(chip_smoke._graph_ms(fn))
        print(f"[step] {N} reads, {name}: " + json.dumps(
            {kn: t[-1] for kn, t in times[name].items()}))
    rebuilt = int((sk[2] == 0).sum())
    return {"reads": N, "segments": nseg,
            "step_ms": chip_smoke._ms(lambda: step.cluster_step(c, k, span),
                                      10),
            "sort_ms": chip_smoke._ms(lambda: torch.sort(key, stable=True),
                                      10),
            "ms": times, "bounds": chip_smoke._step_bounds(
                N, L, k, span, nseg, rebuilt)}


def main() -> int:
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.N_READS
    given = dict(a.split("=", 1) for a in sys.argv[2:])
    dev = chip_smoke.phase0_device()
    if dev is None:
        return 1
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     dir=chip_smoke.ROOT) as tmp:
        fq = os.path.join(tmp, "in.fastq")
        make_dataset(fq, n_reads)
        codes = fastq.read_fastq_codes(fq)
        store = classify.classify(codes, CompressorConfig().resolve(
            codes.shape[1])).codes_sub
        libs = build({"shipped": SRC, **given}, tmp)
    c = torch.from_numpy(store).to(dev)
    sizes = sorted({len(c), min(len(c), chip_smoke.STEP_SEG_READS)})
    print(json.dumps([time_at(c[:n], libs) for n in sizes]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
