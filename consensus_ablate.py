#!/usr/bin/env python3
"""Variants of the consensus-vote kernel on the calls of a compress, on one
CUDA GPU: what each part of ``csrc/consensus.cu`` costs at the pipeline's
shapes.

    python3 consensus_ablate.py [N_READS] [NAME=PATH ...]   # repository root

Compresses N_READS reads (default 5,000,000, chip_smoke's phase 2 set) and
records every ``consensus_vote_flat`` call (its host arrays and the device
read store). Then builds each variant of ``csrc/consensus.cu`` as a shared
library of its own (one nvcc each, all at once) and times every recorded
call through it from a CUDA graph of 5 launches (median of 3 replays) on
the same tile plan. Variants are text edits of the shipped source:

  shipped   the source as it is
  bounds4   without the launch bound's 5 blocks an SM (62 registers)
  t128      128 threads a block          t512   512 threads a block
  u2, u8    2 or 8 member rows in flight a warp (kU)
  tile1024  tiles that own at most 1,024 columns (the plan's, not an edit)
  noatom    the count's shared-memory atomics left out (wrong results)
  nocount   the whole count pass left out (wrong results)

and any NAME=PATH given: another consensus.cu with the same entry point
(an earlier version, say). Every variant that computes the function is held
equal to ``shipped`` on every call. Prints per call its members, columns,
clusters and each variant's ms; the last line is the JSON of each variant's
summed ms. Any failure ends the run with a traceback and a non-zero exit.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke
from bench import make_dataset
from minicom_tpu_torch import compressor
from minicom_tpu_torch.ops import consensus, cuda
from minicom_tpu_torch.pipeline import cluster

SRC = os.path.join(chip_smoke.ROOT, "minicom_tpu_torch", "csrc",
                   "consensus.cu")
BOUNDS = "__launch_bounds__(kThreads, 5)"
ATOMIC = "atomicAdd(&cnt[p * 4 + (c ^ x)], 1);"
COUNT = ("for (int64_t c0 = s0; c0 < s1; c0 += 32) {\n"
         "        const int n = (int)min((int64_t)32, s1 - c0);\n"
         "        int64_t my_r = 0, my_b = 0;")
# name: (edits, tile, computes the function)
VARIANTS = {
    "shipped": ([], consensus.TILE, True),
    "bounds4": ([(BOUNDS, "__launch_bounds__(kThreads)")], consensus.TILE,
                True),
    "t128": ([("kThreads = 256;", "kThreads = 128;")], consensus.TILE, True),
    "t512": ([("kThreads = 256;", "kThreads = 512;")], consensus.TILE, True),
    "u2": ([("kU = 4;", "kU = 2;")], consensus.TILE, True),
    "u8": ([("kU = 4;", "kU = 8;")], consensus.TILE, True),
    "tile1024": ([], 1024, True),
    "noatom": ([(ATOMIC, 'asm volatile("" ::"r"(p * 4 + (int)(c ^ x)));')],
               consensus.TILE, False),
    "nocount": ([(COUNT, COUNT.replace("c0 < s1", "c0 < s0"))],
                consensus.TILE, False),
}


def build(variants, out_dir):
    """One shared library a variant, all nvcc runs at once; returns each
    one's entry point and the registers ptxas reports."""
    procs = {}
    for name, (path, edits) in variants.items():
        with open(path) as f:
            src = f.read()
        for old, new in edits:
            if src.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} not once in {path}")
            src = src.replace(old, new)
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
        print(f"[ablate] {name}: " + "; ".join(
            ln.split(":", 1)[-1].strip() for ln in err.splitlines()
            if "registers" in ln or "spill" in ln))
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        fn = lib.mtc_consensus_vote
        fn.restype = ctypes.c_int
        fn.argtypes = cuda._SIGS["mtc_consensus_vote"]
        fns[name] = fn
    return fns


def record_calls(dev, n, tmp):
    """The consensus_vote_flat calls of an n-read compress on dev."""
    calls, fn = [], cluster.consensus_vote_flat

    def record(*a):
        calls.append(a)
        return fn(*a)

    fq = os.path.join(tmp, "a.fastq")
    make_dataset(fq, n)
    cluster.consensus_vote_flat = record
    try:
        compressor.compress(fq, os.path.join(tmp, "a.mtc"), device=dev)
    finally:
        cluster.consensus_vote_flat = fn
    return calls


def main() -> int:
    args = sys.argv[1:]
    n = int(args.pop(0)) if args and "=" not in args[0] else \
        chip_smoke.N_READS
    dev = chip_smoke.phase0_device()
    if dev is None:
        return 1
    specs = {name: (SRC, edits) for name, (edits, _, _) in VARIANTS.items()}
    tiles = {name: tile for name, (_, tile, _) in VARIANTS.items()}
    checked = {name: ok for name, (_, _, ok) in VARIANTS.items()}
    for a in args:
        name, path = a.split("=", 1)
        specs[name], tiles[name], checked[name] = (path, []), \
            consensus.TILE, True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ablate_",
                                     dir=chip_smoke.ROOT) as tmp:
        fns = build(specs, tmp)
        calls = record_calls(dev, n, tmp)
        totals = {name: 0.0 for name in specs}
        for i, (codes, rd, col, sp, cp, span, want_ref, want_diffs) in \
                enumerate(calls):
            M, L = len(rd), codes.shape[1]
            flag = int(want_ref) | 2 * int(want_diffs)
            want, row = None, {}
            for name, fn in fns.items():
                t, idx = consensus._plan(col, sp, cp, L, tiles[name])
                plan = torch.from_numpy(np.concatenate(
                    [rd, col, t.ravel(), idx])).to(dev)
                cap = int((t[:, 1] - t[:, 0]).max())
                ref = torch.zeros(span, dtype=torch.uint8, device=dev)
                diffs = torch.zeros(M, dtype=torch.int32, device=dev)

                def launch():
                    err = fn(codes.data_ptr(), L, plan.data_ptr(), M, len(t),
                             cap, flag,
                             diffs.data_ptr() if want_diffs else None,
                             ref.data_ptr() if want_ref else None,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                launch()
                got = (ref.cpu().numpy(), diffs.cpu().numpy())
                if want is None:
                    want = got
                elif checked[name]:
                    for g, w in zip(got, want):
                        chip_smoke._equal(f"{name}, call {i}", g, w)
                row[name] = chip_smoke._graph_ms(launch, n=5, reps=3)
                totals[name] += row[name]
            print(f"[ablate] call {i}: {M} members, {span} columns, "
                  f"{len(sp) - 1} clusters, ref {want_ref}, diffs "
                  f"{want_diffs}: " + json.dumps(
                      {k: round(v, 4) for k, v in row.items()}))
    print(json.dumps(totals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
