#!/usr/bin/env python3
"""The read-minimizer kernel of minicom_tpu_torch on the calls of a compress,
on one CUDA GPU: its variants timed on the pipeline's own shapes.

    python3 minimizer_times.py [N_READS] [NAME=PATH ...]   # repository root

Runs chip_smoke.py's phase 0 (the card's name and power limit, the build)
and phase 1's read-minimizer check, then compresses N_READS reads (default
5,000,000, chip_smoke's phase 2 set) with codec="auto" and records every
``sketch_reads_flat`` call of the cluster rounds: its rids, k, reads and
host wall. Then builds each variant of ``csrc/sketch.cu`` as a shared
library of its own (one nvcc each, all at once, ``-Xptxas -v``) and times
phase 1's set (2^17 reads x 100, k = 31) and every recorded call through
it from a CUDA graph of 20 launches (median of 10 replays), on the same
device read store. Variants are text edits of the shipped source:

  shipped     the source as it is
  g1, g2, g4  1, 2 or 4 lanes a read on every call (shipped: by the call's
              reads against kFillReads an SM)
  fill128, fill1024   kFillReads 128 or 1024 (256)
  big256      256 threads a block for a call of one lane a read (512)
  small256    256 threads a block for a call of 2 or 4 lanes a read (128)
  inflight2   16-byte chunks a lane loads before it packs them: 2 (4)
  noprefetch  no L2 prefetch of a warp's next group of rows
  waves       a block a group of reads, the grid as large as the call
              (shipped: what the card holds at once, warps walking groups)
  stageonly   the rows staged, no k-mer ranked (wrong results)
  nomix       the rank without mix32: the smaller k-mer's low word (wrong
              results)

and any NAME=PATH given: another sketch.cu with the same entry point
(the parent commit's, say), its rids int32 or int64 as that entry
declares them. Every variant that computes the function is held equal to
``shipped`` on every call, and ``shipped`` to the plain version. Also
replays each recorded call's host path both ways, in turns: the flat
entry as the rounds call it now, and the earlier path (an upload of the
int64 rids from pageable memory, a range check by ``aminmax`` on the card
and two ``.item()`` syncs, their cast to int32 on the card, the launch,
``.cpu().numpy()``); warm (the pinned buffers of the flat entry cached by
PyTorch's host allocator, as in every call but the first of a size) and
cold (that cache emptied before each turn, as in a process's first
compress). Prints per call its reads, k and each variant's ms; the last
line is the JSON of each variant's phase-1 ms, summed ms over the calls,
the bound of the calls' work and each sum's share of it, and the calls'
host walls. Any failure ends the run with a traceback and a non-zero
exit.
"""

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke
from bench import make_dataset
from minicom_tpu_torch import compressor
from minicom_tpu_torch.ops import cuda, sketch
from minicom_tpu_torch.pipeline import cluster

SRC = os.path.join(chip_smoke.ROOT, "minicom_tpu_torch", "csrc",
                   "sketch.cu")
ENTRY = "mtc_sketch_reads"
RULE = "lg = n >= fill ? 0 : (2 * n >= fill ? 1 : 2);"
FILL = "kFillReads = 256;"
STEP = "if (i < n && S > 0 && lo <= hi) {"
PREFETCH = ("if (next_rid >= 0) prefetch_row(codes + (int64_t)next_rid "
            "* L, L);")
# name: (edits of the shipped source, computes the function)
VARIANTS = {
    "shipped": ([], True),
    "g1": ([(RULE, "lg = 0;")], True),
    "g2": ([(RULE, "lg = 1;")], True),
    "g4": ([(RULE, "lg = 2;")], True),
    "fill128": ([(FILL, "kFillReads = 128;")], True),
    "fill1024": ([(FILL, "kFillReads = 1024;")], True),
    "big256": ([("kReadThreads = 512;", "kReadThreads = 256;")], True),
    "small256": ([("kSmallThreads = 128;", "kSmallThreads = 256;")], True),
    "inflight2": ([("kLoadsInFlight = 4;", "kLoadsInFlight = 2;")], True),
    "noprefetch": ([(PREFETCH, "")], True),
    "waves": ([("(int64_t)per_sm * sms);", "(int64_t)1 << 40);")], True),
    "stageonly": ([(STEP, STEP.replace("lo <= hi", "lo > hi"))], False),
    "nomix": ([("h = mix32(lt ? fh : rh, lt ? fl : rl);",
                "h = lt ? fl : rl;"),
               ("h = mix32(0u, min(fl, rl));", "h = min(fl, rl);")], False),
}


def rid_type(src: str):
    """The numpy type of the rids that the entry point in src takes."""
    entry = re.search(r"int mtc_sketch_reads\(([^)]*)\)", src).group(1)
    return np.int32 if "int32_t* rids" in entry else np.int64


def build(variants, out_dir):
    """One shared library a variant, all nvcc runs at once; returns each
    one's (entry point, rid type). Prints the registers and spills ptxas
    reports."""
    procs, rid_types = {}, {}
    for name, (path, edits) in variants.items():
        with open(path) as f:
            src = f.read()
        for old, new in edits:
            if src.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} not once in {path}")
            src = src.replace(old, new)
        rid_types[name] = rid_type(src)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             "-Xptxas", "-v", cu, "-o", cu[:-3] + ".so"],
            stderr=subprocess.PIPE, text=True)
    fns = {}
    for name, p in procs.items():
        err = p.communicate()[1]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        lines = err.splitlines()
        for i, ln in enumerate(lines):
            if "sketch_reads" in ln and "Compiling entry" in ln:
                print(f"[minimizer] {name}: " + "; ".join(
                    x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "registers" in x or "spill" in x))
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        fn = getattr(lib, ENTRY)
        fn.restype = ctypes.c_int
        fn.argtypes = cuda._SIGS[ENTRY]
        fns[name] = fn, rid_types[name]
    return fns


def record_calls(dev, n, tmp):
    """The sketch_reads_flat calls of an n-read compress on dev: (codes,
    rids, k, host wall s) each."""
    calls, fn = [], cluster.sketch_reads_flat

    def record(codes, rids, k):
        t0 = time.perf_counter()
        out = fn(codes, rids, k)
        calls.append((codes, np.array(rids, np.int64), k,
                      time.perf_counter() - t0))
        return out

    fq = os.path.join(tmp, "a.fastq")
    make_dataset(fq, n)
    cluster.sketch_reads_flat = record
    try:
        summary = compressor.compress(fq, os.path.join(tmp, "a.mtc"),
                                      device=dev)
    finally:
        cluster.sketch_reads_flat = fn
    print(f"[minimizer] {n} reads: archive {summary['archive_bytes']} B, "
          f"cluster stage {summary['timings_s']['cluster']} s")
    return calls


def earlier_path(codes, rids, k):
    """The host path of the read minimizer before ``sketch_reads_flat``:
    int64 rids up from pageable memory, checked on the card with two syncs,
    cast to the kernel's int32 there, one launch, the result down with
    ``.cpu().numpy()``."""
    r = torch.from_numpy(np.ascontiguousarray(rids)).to(codes.device)
    lo, hi = torch.aminmax(r)
    if lo.item() < 0 or hi.item() >= codes.shape[0]:
        raise IndexError("rid outside the read store")
    out = torch.empty((3, len(rids)), dtype=torch.int32, device=codes.device)
    cuda.launch(ENTRY, codes, codes.shape[1], r.to(torch.int32), len(rids),
                k, out)
    return out.cpu().numpy().view(np.uint32)


def host_walls(calls, cold, reps=3):
    """Median host wall s of each call's path, both ways in turns: (flat,
    earlier) per call; cold: a function that empties PyTorch's cache of
    pinned host blocks, called before each turn."""
    out = []
    for codes, rids, k, _ in calls:
        t = {"flat": [], "earlier": []}
        for _ in range(reps):
            for way in ("earlier", "flat", "flat", "earlier"):
                fn = sketch.sketch_reads_flat if way == "flat" \
                    else earlier_path
                torch.cuda.synchronize()
                if cold:
                    cold()
                t0 = time.perf_counter()
                fn(codes, rids, k)
                t[way].append(time.perf_counter() - t0)
        out.append((statistics.median(t["flat"]),
                    statistics.median(t["earlier"])))
    return out


def main() -> int:
    args = sys.argv[1:]
    n = int(args.pop(0)) if args and "=" not in args[0] else \
        chip_smoke.N_READS
    dev = chip_smoke.phase0_device()
    if dev is None:
        return 1
    specs = {name: (SRC, edits) for name, (edits, _) in VARIANTS.items()}
    checked = {name: ok for name, (_, ok) in VARIANTS.items()}
    for a in args:
        name, path = a.split("=", 1)
        specs[name], checked[name] = (path, []), True
    report = {}
    chip_smoke.phase1_sketch_reads(dev, report)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_minimizer_",
                                     dir=chip_smoke.ROOT) as tmp:
        fns = build(specs, tmp)
        calls = record_calls(dev, n, tmp)
        # phase 1's set first (call -1), then the compress's calls
        rng = np.random.default_rng(1)
        p_codes = torch.from_numpy(chip_smoke._reads_store(
            rng, 1 << 17, 100)).to(dev)
        p_rids = rng.permutation(1 << 17).astype(np.int64)
        work = [(p_codes, p_rids, 31, None)] + calls
        totals = {name: 0.0 for name in specs}
        phase1 = {}
        bound_ms = 0.0
        for i, (codes, rids, k, wall) in enumerate(work, start=-1):
            m, L = len(rids), codes.shape[1]
            r_of = {t: torch.from_numpy(rids.astype(t)).to(dev)
                    for t in (np.int32, np.int64)}
            out = torch.empty((3, m), dtype=torch.int32, device=dev)
            want, row = None, {}
            for name, (fn, rt) in fns.items():
                r = r_of[rt]

                def launch():
                    err = fn(codes.data_ptr(), L, r.data_ptr(), m, k,
                             out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                out.fill_(-1)
                launch()
                got = out.cpu().numpy()
                if want is None:
                    want = got
                    chip_smoke._equal(f"call {i} vs plain", got,
                                      sketch._sketch_reads_plain(
                                          codes, r, k).cpu().numpy()
                                      .view(np.int32))
                elif checked[name]:
                    chip_smoke._equal(f"{name}, call {i}", got, want)
                row[name] = chip_smoke._graph_ms(launch)
                if i < 0:
                    phase1[name] = row[name]
                else:
                    totals[name] += row[name]
            b = chip_smoke._bound(m * (L + 4 + 12),
                                  m * max(L - k + 1, 0)
                                  * chip_smoke.kmer_min_ops(k))
            if i >= 0:
                bound_ms += b["bound_ms"]
            print(f"[minimizer] call {i}: {m} reads, k={k}, bound "
                  f"{b['bound_ms']:.5f} ms ({b['bound_by']})"
                  + ("" if wall is None else f", host wall {wall:.5f} s")
                  + ": " + json.dumps({x: round(v, 5)
                                       for x, v in row.items()}))
        # the name of the call that empties the cache differs by version
        empty = (getattr(torch._C, "_host_emptyCache", None)
                 or getattr(torch._C, "_accelerator_emptyHostCache", None))
        walls = {"warm": host_walls(calls, None)}
        if empty:
            walls["cold"] = host_walls(calls, empty)
        else:
            print("[minimizer] no call empties the pinned host cache: cold "
                  "walls not measured")
        for how, w in walls.items():
            for i, (flat, early) in enumerate(w):
                print(f"[minimizer] call {i}: host wall {how}, median of 6 "
                      f"in turns: flat entry {flat:.5f} s, earlier path "
                      f"{early:.5f} s")
    print(json.dumps({
        "phase1_ms": phase1, "calls": len(calls), "calls_ms": totals,
        "calls_bound_ms": bound_ms,
        "share_of_bound": {x: bound_ms / v for x, v in totals.items()},
        "host_wall_s": {"in_compress": sum(c[3] for c in calls),
                        **{f"{way}_{how}": sum(x[j] for x in w)
                           for how, w in walls.items()
                           for j, way in enumerate(("flat", "earlier"))}}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
