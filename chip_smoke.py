#!/usr/bin/env python3
"""Drive minicom_tpu_torch's main path once on one CUDA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one GPU
    python3 chip_smoke.py --cards    # phase 13 alone, on 2-4 GPUs of a host

With ``--cards`` it runs phase 13 and only what it needs: phase 0, phase 2,
phase 3's cuda archives (not their cpu twins) and phase 8's one-card
digests; its last line is the same ``{"ok": true, ...}`` object.

Phases (any failure ends the run with a traceback and a non-zero exit):
  0. device: a CUDA device must be present; prints the card's name and power
     limit (nvidia-smi) and builds the CUDA kernels and the host library
     (g++ of the port's own C++, ``minicom_tpu_torch/native/*.cpp``), each
     timed.
  1. kernels: each CUDA kernel against its plain PyTorch version on the same
     CUDA tensors (and against its host C++ twin or numpy oracle), exact, at
     the main path's shapes; kernel times are from CUDA graphs of 20
     launches (a launch from Python outlasts these kernels; medians of 10
     replays bracketed by CUDA events), the plain versions' from events
     around single calls. The read minimizer runs both entries on 2^17
     reads x 100 at k in (31, 17, 4, 30), on 1, 33 and 255 reads, and on
     reads of L in (36, 101, 150, 256), as many as take 1, 2 and 4 lanes a
     read on the card (``reads_for_lanes``). The consensus vote runs the
     first cluster round's ejection pass of the phase-3 set as the round
     calls it (its clusters' pointers, one launch), also against the host
     twin and the one-cluster tensor entry. The contig sketch runs 2048
     rows of each rung (128 to 8192), each rung alone in the dense layout
     and then all four as one batched call of the merge stage's entry
     point (one launch, entries compacted on the card); its bound counts
     the k-mer starts the rows need (a row that fills its slots stops a
     window past its last kept entry).
     The rANS scans take their blocks from the streams of phase 2's archive:
     a full order-0 block (T = 8192) and a full trans2 block (T = 32768) of
     the diff text, and a dzt literal block (A = 4, k = 4) of the consensus,
     each coded and decoded by the batched kernels at B = 1, the coded
     block also equal to its bytes in the stream that compress writes. Then
     two batches, each one encode launch and one decode launch: the first
     three order-0 blocks of the diff stream plus its tail block, and the
     first two trans2 blocks; each equal to the plain version and to the
     stream's bytes, and timed beside the sum of its blocks' B = 1 launches.
  2. end to end: compress(device="cuda") + decompress of a 5,000,000-read x
     100 bp dataset (bench.py make_dataset, default profile, seed 7), exact
     roundtrip, the archive the default cell's pin in BENCHMARK.json; every
     kernel of the path must have launched during compress.
     The contig sketch's work is counted per ``sketch_contigs`` call (its
     contigs, k-mer starts, launches), with its device seconds, the bound of
     that work and the merge_sketch sub-stage; more than one contig-sketch
     launch per call fails the phase. Likewise the consensus vote per
     ``consensus_from_members`` call (members, bases, columns, clusters,
     launches, host wall; the device seconds and the bound of that work): a
     call that makes other than one launch fails the phase; and the read
     minimizer per ``sketch_reads_flat`` call (reads, k, launches, host
     wall, device ms; the bound of that work): more launches than calls
     fail the phase. Every compress and decompress of phase 2 (and 2d,
     and of every cell of phase 9) prints its device seconds and bytes by
     stage (the
     summary's device_<stage>_s and device_<stage>_bytes: the host wall
     spent in crossings between host and card, and the bytes that crossed)
     and their seconds over the run's wall; a stage whose device seconds
     exceed its wall fails the phase. The codec="auto" compress also
     prints its number of crossings and what the accounting costs.
  3. same bytes: at 100,000 reads, device="cuda" and device="cpu" write
     identical archives, with codec="auto" and with codec="device"; in
     order-preserving mode with codec="auto"; and for 50,000 pairs (the
     PE cell's input cut to 100,000 reads, ``bench_torch.make_inputs``:
     the two ends of one fragment) with codec="auto" and with
     codec="device".
  2d. codec="device" (the on-device entropy coders) on phase 3's 100k set,
     after phase 3: exact roundtrip, the archive phase 3's codec=device
     one, rANS encode launched during compress and rANS decode during
     decompress: at most one decode launch per device-coded stream (two for
     dzt, which has two coded planes), and at most one encode launch per
     coded plane of every candidate codec tried for a stream.
  (2o and 2p, the order-preserving and paired-end runs on phase 3's set,
     are phase 9's order and PE cells, which carry their checks.)
  4. realign verify: on the 100,000-read set, the popcount verify kernel
     recomputes the mismatch count of every placement the host realign probe
     chose at the first threshold, and must agree with it.
  5. trace and resume: at 100,000 reads, a compress without MTC_TRACE_DIR
     and two with it: each archive must equal phase 3's, and each trace
     (torch.profiler) must hold device events of the read minimizer, the
     vote and the contig sketch. The three runs' device bytes by stage
     must be equal, add up to each call's ``mesh.device_bytes()`` delta
     (no crossing outside a stage) and, in each trace, equal the bytes of
     its host-to-device and device-to-host copies (Kineto's gpu_memcpy
     events). Each trace must hold exactly one span ``mtc.<stage>`` per
     stage, a span of each sub-stage wall of the summary inside its
     stage's, and one ``mtc.entropy.<stream>`` per stream of the archive
     (``bench_torch.span_faults``); prints the busy share by stage and the
     idle seconds by innermost span (``bench_torch.stage_trace_summary``).
     Then, with a checkpoint dir, compress,
     delete the merge and realign snapshots, compress again: the second
     run resumes from the cluster snapshot, launches the merge kernels (the
     contig sketch and the re-vote) and not the read minimizer, and writes
     the same archive.
  6. two ranks: this script starts workers of itself (``--dist-worker``)
     that join one gloo group through a file store, each with half the
     host's cores; they see one card, so ``distributed.place`` puts both on
     cuda:0, and each compress names cuda:0, shared, in its summary. First
     one rank alone compresses and
     decompresses phase 2's 5M file (the single-process walls and peak RSS
     of a fresh process); then two ranks do: rank 0's archive must equal
     phase 2's and its decode phase 2's decoded file, byte for byte, rank 1
     must write neither, and each rank must have launched the read
     minimizer, the vote and the contig sketch. Then two ranks on the 100k
     set with codec=device (the rANS encode and decode launched on some
     rank), ORDER and PE: each archive must equal phase 3's cuda archive,
     and each decode must be exact. Prints per rank the walls, stages,
     launches, the seconds and bytes spent in the package's all-gathers,
     the busiest call sites of those, and the peak RSS of compress and of
     decompress (sampled from /proc/self/statm; the 5M runs each in fresh
     processes).
  7. cluster step: ``ops/step.py::cluster_step`` (kernel (c) and the three
     kernels of csrc/step.cu, one torch.sort) on phase 2's read store, k =
     31. On its first 2^20 reads (span_cols N 2L) all five outputs equal
     the plain version's, and each kernel's its plain version's; the same
     on 2,048 rows of (AT)^50 and 2,048 copies of one read at k = 30. Then
     all 5,000,000 reads, span_cols 10^9, on the kernel path alone: order
     equals numpy's stable argsort of the keys from sketch_reads_flat,
     coverage sums to N L, every diff lies in [0, L], and the call launches
     each of its four kernels once; the keys and segments kernels equal
     their plain versions there. Prints the step's and each piece's ms
     (the step and the sort from CUDA events around single calls, medians
     of 10; the kernels from CUDA graphs), the peak device memory and the
     bounds. ``step_times.py`` times the step's kernels alone.
  8. sharded cluster step: ``parallel/mesh.py::sharded_cluster_step`` in
     two workers of this script (``--dist-worker``) that join one gloo
     group and share cuda:0 (they see one card), each with half the rows:
     (i) phase 7's first
     2^20 reads, span_cols N 2L; (ii) 4,096 rows of phase 2's store, 2,049
     of them the one whose key sorts last, at k = 30 (one segment across
     both ranks; rank 1 owns none); (iii) all 5,000,000 reads, span_cols
     10^9. The ranks' consensus and coverage (whole on each) and the
     rank-order concatenation of their diffs, seg_id and order must equal
     the one-card ``cluster_step``'s, by SHA-256 digest; each rank must
     launch kernel (c), the keys and segments kernels once each, and the
     vote once where it owns a segment with columns below span_cols (rank
     1 of (ii) owns none and launches no vote). Prints per rank the step's
     wall, device ms per piece (CUDA events), the exchanges' backend,
     seconds and bytes sent, received and moved through the host per
     collective, host-device copies, what it owned, its launches, peak
     device memory and peak RSS.
  9. bench: ``bench_torch.run_cell`` on every cell of ``BENCHMARK.json``
     cut to 100,000 reads and one repeat (the default profile at seed 7 is
     phase 3's input): each must be correct (roundtrip exact, archives of
     the cold, timed and traced runs identical), its timed compress must
     launch the cell's ``kernels`` and its timed decompress its
     ``decode_kernels``, and a single-end cell of the default profile must
     write phase 3's cuda archive of its settings (``PHASE3_ARCHIVE``:
     codec=auto, codec=device, order with codec=auto, PE with codec=auto),
     and its traced run must report no ``trace_span_faults``; a stage's
     device seconds must not exceed its wall (as in phase 2). The order and
     PE cells' archives (phase 3's) are decoded once more on the card: the
     order cell's lines must equal the input's in input order, byte for
     byte, and the PE cell's multiset of (line i of file 1, line i of file
     2) pairs the input's pairs. Prints the cell's rates, archive, launches
     of compress and decompress, stage walls, device seconds and bytes, the
     traced run's busy share, its spans, their cost untraced and the busy
     share by stage.
  10. codec table: ``tools/codecs_table_torch.py``'s ``main`` on phase 3's
     100k codec=auto cuda archive, its on-device codecs on the card: every
     device trial decodes back exactly (the tool exits otherwise), each
     launches the rANS encode, and the run launches both the rANS encode
     and decode (kernels (f)+(g)), the encodes as many times as its rows
     count (the tool's set-up codes one small stream apart from them). Prints the device_vs_host line and the phase's wall.
  11. kernel bench: ``tools/kernel_bench_torch.py``'s ``main`` at scale 1
     (the JAX tool's rows and shapes, and the cluster step's pieces at 2^20
     reads), the launches counted from 0 around it: each kernel timed cold
     (L2 flushed before each launch) and warm (CUDA graphs) against the
     count of its work. Fails on a missing row, a call that did not launch
     its kernels once each, a share of the bound over 1.05 cold, or a cold
     time under 0.95 of the warm one. Prints the table and the phase's
     wall.
  12. configurations: every entry of CONFIGS_torch.json (the reference's
     documented command lines at 50-256 bp, and gzip input; 1,000,000
     reads each, ``configs_torch.py``), its inputs written by a child
     interpreter started at the top of the run. First each main-path
     kernel against its plain version and host twin at the entries' new
     shapes: the read minimizer at L = 50 and 75 (k 17, 23, 25, 31) and at
     k = 23 and 25 (L 100, 101, 150, 256), the contig sketch at each new
     (k, w) on rows of every rung up to 32,768 bases, the vote on the
     first cluster round at L = 50, 75, 101 and 256. Then each entry:
     compress on the card with its settings, the launch counts set to 0
     just before it (the read minimizer, the contig sketch and the vote
     must each launch), the archive's SHA-256 its pin (the JAX package's
     archive on the CPU, ``tools/reference_sha256.py --config``), and a
     decompress on the card whose reads equal the input's as a multiset.
     Prints one line a configuration (resolved k, w and dictionaries,
     archive bytes and bits a base, walls, stage walls, launches and
     device ms of each kernel) and the phase's wall.
  13. a card a rank, where the machine has 2 or more cards (up to 4, P;
     on one card it prints on a line that it did not run, and why): the
     workers see P cards, so rank r runs on cuda:r and the group carries
     CUDA tensors over NCCL. (i) Phase 2's 5M file compressed and
     decompressed in P ranks: rank 0's archive must equal phase 2's (the
     default cell's pin) and its decode phase 2's decoded file, byte for
     byte; each rank must launch the read minimizer, the vote and the
     contig sketch, its summaries must name cuda:r, not shared, and it
     must hold device memory on cuda:r and on no other card. Then the 100k
     set with codec=device, ORDER and PE in P ranks: each archive phase
     3's, each decode exact. (ii) phase 8's three cases in P ranks, one a
     card: the digests phase 8's one-card step's, every exchange over NCCL
     with no byte through the host. Prints every card's name and power
     limit, per rank the walls and stages, and the step's wall, device ms
     per piece and seconds and bytes per collective.
Three lines end the output: the script's whole wall; a JSON object with
each kernel's numbers
(bytes_bound_ms: the bytes its inputs and outputs hold over 3.35 TB/s;
ops_bound_ms: the integer operations its function needs, see ``OPS``, over
16.75 T/s; bound_ms: the larger of the two; ms_cold and share_cold: phase
11's cold time and share of its row ``cold_row``, at the kernel bench's
shapes); and {"ok": true, "device": {...}}. ``rans_times.py``,
``sketch_times.py`` and ``consensus_times.py`` run phase 1's checks of one
kernel alone. The rows of the step's kernels give ms and bound_ms at
5,000,000 reads, ms_at_2p20 at 2^20, and plain_ms at ``plain_reads``
reads (the vote's plain version needs a [span, 4] count table: 2^20
reads).
"""

from __future__ import annotations

import filecmp
import contextlib
import hashlib
import importlib.util
import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

import bench_torch
import configs_torch
from bench import make_dataset
from bench_torch import decoded_rows, input_rows, sorted_rows
from minicom_tpu_torch import CompressorConfig, compressor, native
from minicom_tpu_torch.entropy import device_ctx_rans, device_rans
from minicom_tpu_torch.io import container, fastq
from minicom_tpu_torch.ops import consensus, cuda, rans, sketch, step, verify
from minicom_tpu_torch.ops.pack import (pack_2bit_words, popcount_u32,
                                        revcomp_codes)
from minicom_tpu_torch.parallel import mesh
from minicom_tpu_torch.pipeline import classify, cluster, merge
from minicom_tpu_torch.pipeline.merge import (_batch_m, _lmax_bucket,
                                              _rows_tile, merge_contigs)
from minicom_tpu_torch.stats import StageStats

ROOT = os.path.dirname(os.path.abspath(__file__))
N_READS = 5_000_000
N_SAME_BYTES = 100_000


def _ms(fn, reps: int) -> float:
    """Median milliseconds of fn() on the current stream (after one warm-up
    call), each run bracketed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def _graph_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Milliseconds of one fn() from a CUDA graph of n calls replayed
    (median of reps): for a kernel shorter than its launch from Python,
    which a CUDA-event pair around one call would time instead."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return _ms(g.replay, reps) / n


def _once_ms(fn):
    """(fn(), its milliseconds) from one call bracketed by CUDA events: for
    the plain rANS scans, whose Python loops take seconds a call."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def _equal(name, got, want) -> int:
    """Exact equality of integer arrays; returns max |got - want| (0)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    err = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max()) \
        if got.size else 0
    if err:
        raise AssertionError(f"{name}: max |diff| {err}")
    return err


HBM_BYTES_S = 3.35e12
# integer operations a second: a quarter of the card's 67 TFLOP/s float32
# rate outside the tensor cores (an SM has half as many int32 lanes as
# float32 lanes, and the float rate counts a fused multiply-add as two)
INT_OPS_S = 16.75e12

# 32-bit integer operations that each function needs for one element of its
# work, counted on the function's definition (its plain version in ops/),
# not on a kernel: the fewest a straightforward evaluation takes, a
# division, a modulo or a population count taken as one operation, loads and
# stores as none. Too few only lowers a bound, which then still holds.
OPS = {
    # one k-mer start of a read, as the plain version computes it (k-mers of
    # up to 62 bits in two words), a three-input logic operation taken as
    # one: roll the forward k-mer (funnel shift, shift-add, mask) 3, the
    # reverse complement (shift the complement base up, xor-or it in, shift,
    # funnel shift) 4, the canonical one (64-bit compare, two selects) 4,
    # mix32's xors and shifts 7, the first minimum (compare, select rank and
    # position) 3; at even k the palindrome rule (64-bit equality, select)
    # adds 3: odd k has no palindromes. mix32's 4 multiplies are not
    # counted: they issue to the FMA pipe beside the integer pipe, at the
    # same rate, so the integer pipe is the busier one
    "kmer_min": 21, "kmer_palindrome": 3,
    # one k-mer start of a contig row: roll the forward k-mer 4, the reverse
    # complement 5, the canonical one 4, the palindrome rule 3, mix32 11,
    # in the row (add, compare) 2, the window minimum and the covering
    # maximum in running form 3 + 3, emitted (two compares) 2, its running
    # count 1, within the cap and its slot 2, position and strand 2
    "kmer_window": 42,
    # one base of a member row: complement 1, a real base 1, its counter's
    # index (add the column, shift-or) 2, count 1, differs from the
    # consensus 1, sum 1; one consensus column: the first maximum of four
    # counts (3 compares, 6 selects)
    "vote_base": 7, "vote_column": 9,
    # one 32-bit word pair: xor, population count, add
    "verify_word": 3,
    # the fused step: one read's key and mz from (c)'s words (join hi and
    # lo 2, position and strand 2, the mirror 2); one base of a read whose
    # k-mer at start 0 is rebuilt (forward shift-or 2, complement 1, its
    # shift-or 2); one sorted item's segment (the key against the one
    # before 2, the running count 1, the segment max 1); one column of the
    # step's vote (the first maximum 9, the coverage 3)
    "step_key": 6, "step_rebuild_base": 5, "segment_item": 4,
    "step_column": 12,
    # one coding slot: f >= 1, the emit test (shift, compare, and valid) 3,
    # the word 1, the renormalised state (shift, select) 2, quotient and
    # remainder 2, shift, add c, or 3, keep the state on a pad slot 1,
    # count the word 1
    "rans_encode_slot": 14,
    # one decode step, the symbol search apart: the slot 1, f from two
    # cumulative entries 1, the state (shift, multiply, add, subtract) 4,
    # refill (compare, and valid, shift, or, select) 5, the word pointer
    # (add, clamp) 2, the context (multiply, add, modulo) 3, keep state and
    # context on a pad step 2; the search is ceil(log2 A) compares
    "rans_decode_step": 18,
}


def kmer_min_ops(k: int) -> int:
    """``OPS`` of one k-mer start of the read minimizer at k."""
    return OPS["kmer_min"] + (OPS["kmer_palindrome"] if k % 2 == 0 else 0)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take. bytes_bound_ms: ``nbytes`` (every
    input read once, every output written once) over the memory rate;
    ops_bound_ms: ``ops`` integer operations (``OPS``) over the integer
    rate; bound_ms: the longer of the two. No single PyTorch call computes
    any of these kernels' functions, so library_ms is null."""
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, ops / INT_OPS_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes_bound_ms=by_bytes, ops_bound_ms=by_ops,
                library_ms=None)


def _reads_store(rng, n, L):
    """[n, L] codes with palindromic rows (0, 3, 0, 3, ...; at even k every
    k-mer) and rows of one base among random ones."""
    codes = rng.integers(0, 4, (n, L), dtype=np.uint8)
    codes[:64] = np.resize(np.array([0, 3], np.uint8), L)
    codes[64:96] = 2
    return codes


def _check_reads(dev, tag, codes, c, rids, ks) -> int:
    """Both entries of the read minimizer on the card (one launch each)
    against the plain version and the host twin, for each k; returns the
    max |diff| (0)."""
    r = torch.from_numpy(rids).to(dev)
    err = 0
    for k in ks:
        n0 = cuda.launches["mtc_sketch_reads"]
        flat = sketch.sketch_reads_flat(c, rids, k)
        got = sketch.sketch_reads_gather(c, r, k).cpu().numpy()
        if cuda.launches["mtc_sketch_reads"] != n0 + 2 * (len(rids) > 0):
            raise AssertionError(f"{tag} k={k}: not one launch a call")
        plain = sketch._sketch_reads_plain(c, r, k).cpu().numpy()
        hi, lo, pos, z = native.sketch_reads_host(codes, rids, k)
        err = max(err, _equal(f"{tag} k={k} flat vs plain", flat, plain),
                  _equal(f"{tag} k={k} gather vs plain", got, plain))
        _equal(f"{tag} k={k} vs host", flat,
               np.stack([hi, lo, (pos.astype(np.uint32) << 1) | z]))
    return err


# kFillReads of csrc/sketch.cu: a call of at least this many reads an SM
# takes one lane a read, one of at least half of it two, a smaller one four
READ_FILL = 256


def reads_for_lanes(dev) -> dict:
    """A read count that the kernel's rule gives 1, 2 or 4 lanes a read on
    dev; the one-lane count is past what the card holds at once (at most
    2048 threads an SM), so that warps walk several groups of reads."""
    fill = READ_FILL * torch.cuda.get_device_properties(
        dev).multi_processor_count
    return {1: 8 * fill + 33, 2: fill - 1, 4: fill // 2 - 1}


def phase1_sketch_reads(dev, report):
    """The read minimizer: 2^17 reads x 100 (a permutation of the store,
    the first cluster round's shape) at k in (31, 17, 4, 30); 1, 33 and 255
    reads of that store; then stores of L in (36, 101, 150, 256) (odd L and
    L = 150 put row starts off 4-byte alignment), each with the read
    counts that take 1, 2 and 4 lanes a read (rids with repeats). Both
    entries against the plain version and the host twin. The 2^17 set at
    k = 31 is timed from CUDA graphs."""
    rng = np.random.default_rng(1)
    ks = (31, 17, 4, 30)
    n, L = 1 << 17, 100
    codes = _reads_store(rng, n, L)
    rids = rng.permutation(n).astype(np.int64)
    c = torch.from_numpy(codes).to(dev)
    err = _check_reads(dev, f"sketch_reads {n} x {L}", codes, c, rids, ks)
    for m in (1, 33, 255):
        err = max(err, _check_reads(dev, f"sketch_reads {m} x {L}", codes,
                                    c, rng.integers(0, n, m), ks))
    sizes = reads_for_lanes(dev)
    for Lx in (36, 101, 150, 256):
        cx = _reads_store(rng, 1 << 15, Lx)
        dx = torch.from_numpy(cx).to(dev)
        for lanes, m in sizes.items():
            err = max(err, _check_reads(
                dev, f"sketch_reads {m} x {Lx} ({lanes} lanes a read)", cx,
                dx, rng.integers(0, 1 << 15, m), ks))
    r = torch.from_numpy(rids.astype(np.int32)).to(dev)
    out = torch.empty((3, n), dtype=torch.int32, device=dev)
    ms = _graph_ms(lambda: cuda.launch("mtc_sketch_reads", c, L, r, n, 31,
                                       out))
    plain_ms = _ms(lambda: sketch._sketch_reads_plain(c, r, 31), 5)
    print(f"[1] sketch_reads {n} x {L} k=31: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms; flat and gather entries equal to plain and "
          f"host for k in {ks} at {n} x {L}, 1, 33 and 255 reads, and "
          f"{sorted(sizes.values())} reads (1, 2, 4 lanes a read) of L in "
          f"(36, 101, 150, 256)")
    report["mtc_sketch_reads"] = dict(
        name="sketch_reads_flat", route="cuda",
        source="minicom_tpu_torch/csrc/sketch.cu",
        replaces="minicom_tpu/ops/sketch.py:146", max_abs_err=err, ms=ms,
        plain_ms=plain_ms,
        **_bound(_nbytes(c, r, out), n * (L - 31 + 1) * kmer_min_ops(31)))


def _sketch_work(lens, k, w, mb, nv, last_end):
    """(bytes, needed k-mer starts, all k-mer starts) of a contig sketch:
    the rows' bases and (start, length, slots) in, the kept (key, meta)
    entries and a count per row out (see ``needed_starts``)."""
    need = needed_starts(lens, k, w, mb, nv, last_end)
    return (int(lens.sum()) + 16 * len(lens) + 8 * int(nv.sum())
            + 4 * len(lens), int(need.sum()),
            int(np.maximum(lens - k + 1, 0).sum()))


def phase1_sketch_windowed(dev, report):
    """The contig sketch at the merge stage's shapes: 2048 rows of each
    rung (128 to 8192) at k = 31, w = 19, each rung alone in the dense
    layout against the plain version and the host twin, then all of them
    as one batched call (rows in plan order, each rung's mb) against the
    batched plain version and the host twin; every launch timed."""
    rng = np.random.default_rng(2)
    k, w, cap = 31, 19, 128
    lens, refs, mbs, wes, rung_of = [], [], [], [], []
    for Lmax in (128, 512, 2048, 8192):
        rows = _rows_tile(Lmax)
        ln = rng.integers(Lmax // 4, Lmax + 1, rows).astype(np.int32)
        ln[:3] = [0, k - 1, Lmax]
        refs.append(rng.integers(0, 4, int(ln.sum()), dtype=np.uint8))
        lens.append(np.sort(ln, kind="stable"))   # plan order in a rung
        mbs.append(np.full(rows, _batch_m(Lmax, k, w, cap), np.int64))
        wes.append(np.full(rows, min(w, Lmax - k + 1), np.int32))
        rung_of.append(Lmax)
    ref = np.concatenate(refs)
    lens_all = np.concatenate(lens)
    starts_all = np.r_[0, np.cumsum(lens_all[:-1], dtype=np.int64)]
    mb_all, we_all = np.concatenate(mbs), np.concatenate(wes)
    ref_d = torch.from_numpy(ref).to(dev)
    hk, hm, hn = native.sketch_windowed_host(
        ref, starts_all, lens_all, k, we_all, mb_all.astype(np.int32),
        int(mb_all.max()))
    err, rung_ms, rung_plain, r0 = 0, [], [], 0
    for Lmax, ln, mbr in zip(rung_of, lens, mbs):
        rows, mb = len(ln), int(mbr[0])
        we = min(w, Lmax - k + 1)
        st = starts_all[r0:r0 + rows]
        args = (ref_d, torch.from_numpy(st).to(dev),
                torch.from_numpy(ln).to(dev))
        key, meta, nv = (x.cpu().numpy() for x in
                         sketch.sketch_windowed_compact32(*args, Lmax, k, we,
                                                          mb))
        pk, pm, pn = (x.cpu().numpy() for x in sketch._sketch_windowed_plain(
            *args, Lmax, k, we, mb))
        v = np.arange(mb)[None, :] < nv[:, None]
        h = slice(r0, r0 + rows)
        err = max(err, _equal(f"rung {Lmax} nv", nv, pn),
                  _equal(f"rung {Lmax} key", key[v], pk[v]),
                  _equal(f"rung {Lmax} meta", meta[v], pm[v]))
        _equal(f"rung {Lmax} nv vs host", nv, hn[h])
        _equal(f"rung {Lmax} key vs host", key[v], hk[h, :mb][v])
        _equal(f"rung {Lmax} meta vs host", meta[v], hm[h, :mb][v])
        desc, tiles, w_eff = sketch._plan(st, ln.astype(np.int64), mbr,
                                          np.arange(rows) * mb, k, we)
        desc = torch.from_numpy(desc).to(dev)
        outs = (torch.empty((rows, mb), dtype=torch.uint32, device=dev),
                torch.empty((rows, mb), dtype=torch.int32, device=dev),
                torch.empty(rows, dtype=torch.int32, device=dev))
        rung_ms.append(_graph_ms(lambda: sketch._launch(
            ref_d, desc, rows, tiles, k, w_eff, outs)))
        rung_plain.append(_ms(lambda: sketch._sketch_windowed_plain(
            *args, Lmax, k, we, mb), 5))
        print(f"[1] contig sketch rung {Lmax} ({rows} rows, mb={mb}, dense, "
              f"{tiles} blocks): kernel {rung_ms[-1]:.4f} ms, plain "
              f"{rung_plain[-1]:.3f} ms; equal to plain and host")
        r0 += rows

    # the four rungs as one call of the merge stage's entry point
    n0 = cuda.launches["mtc_sketch_windowed"]
    key, meta, nv = sketch.sketch_windowed_flat(ref_d, starts_all, lens_all,
                                                mb_all, k, w)
    if cuda.launches["mtc_sketch_windowed"] != n0 + 1:
        raise AssertionError("the batched contig sketch: not one launch")
    pk, pm, pn = sketch._sketch_windowed_flat_plain(
        ref_d, starts_all, lens_all, mb_all, k, w)
    hv = np.arange(hk.shape[1])[None, :] < hn[:, None]
    err = max(err, _equal("batched nv", nv, pn), _equal("batched key", key, pk),
              _equal("batched meta", meta, pm))
    _equal("batched nv vs host", nv, hn)
    _equal("batched key vs host", key, hk[hv])
    _equal("batched meta vs host", meta, hm[hv])
    R = len(lens_all)
    soff = np.r_[0, np.cumsum(mb_all)[:-1]]
    desc, tiles, w_eff = sketch._plan(starts_all, lens_all.astype(np.int64),
                                      mb_all, soff, k, w)
    desc = torch.from_numpy(desc).to(dev)
    cap_n = int(mb_all.sum())
    stage = (torch.empty(cap_n, dtype=torch.uint32, device=dev),
             torch.empty(cap_n, dtype=torch.int32, device=dev),
             torch.empty(R, dtype=torch.int32, device=dev))
    out = torch.empty((cap_n, 2), dtype=torch.int32, device=dev)
    status = torch.zeros(tiles + 1, dtype=torch.int64, device=dev)

    def batched():   # the ticket and look-back words start at zero
        status.zero_()
        sketch._launch(ref_d, desc, R, tiles, k, w_eff, stage, out, status)

    ms = _graph_ms(batched)
    dense_ms = _graph_ms(lambda: sketch._launch(ref_d, desc, R, tiles, k,
                                                w_eff, stage))
    plain_ms = _ms(lambda: sketch._sketch_windowed_flat_plain(
        ref_d, starts_all, lens_all, mb_all, k, w), 3)
    last = np.zeros(R, np.int32)
    ends = np.cumsum(nv) - 1
    last[nv > 0] = meta[ends[nv > 0]] >> 1
    nbytes, need, every = _sketch_work(lens_all.astype(np.int64), k, w,
                                       mb_all, nv, last)
    b_all = _bound(nbytes, every * OPS["kmer_window"])
    print(f"[1] contig sketch, the 4 rungs: one launch a rung (dense) "
          f"{sum(rung_ms):.4f} ms in all, plain {sum(rung_plain):.3f} ms; "
          f"one batched launch ({R} rows, {tiles} blocks, {len(key)} "
          f"entries kept, compacted) {ms:.4f} ms (dense: {dense_ms:.4f} ms),"
          f" plain {plain_ms:.3f} ms; "
          "equal to plain and host; bound "
          f"{b_all['bound_ms']:.5f} ms counting every k-mer start ({every}),"
          f" the reported bound counts the {need} needed")
    report["mtc_sketch_windowed"] = dict(
        name="sketch_windowed_flat", route="cuda",
        source="minicom_tpu_torch/csrc/sketch.cu",
        replaces="minicom_tpu/ops/pallas_sketch.py:93", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, **_bound(nbytes, need * OPS["kmer_window"]))


def _check_vote(dev, fastq_path, tag):
    """The vote on the first cluster round's ejection-pass members of the
    reads of ``fastq_path`` (at their read length's default settings), as
    the round calls it (its clusters' member and column pointers): one
    launch, equal to the plain version, the host twin and the tensor entry
    (the same members as one cluster, in their own tiles). Returns the max
    |diff| (0) and what timing the launch needs."""
    codes = fastq.read_fastq_codes(fastq_path)
    cfg = CompressorConfig().resolve(codes.shape[1])
    cls = classify.classify(codes, cfg)
    codes_dev = torch.from_numpy(cls.codes_sub).to(dev)
    calls = []

    def record(*a):
        calls.append(a)
        return consensus.consensus_vote_flat(*a)

    cluster.consensus_vote_flat = record
    try:
        cluster._one_round(codes_dev, cls.pool,
                           *cluster._sketch(cls.pool, codes_dev, cfg.k,
                                            codes.shape[1]),
                           cfg.diff_threshold, codes.shape[1])
    finally:
        cluster.consensus_vote_flat = consensus.consensus_vote_flat
    _, rd, col, seg_ptr, col_ptr, span = calls[0][:6]
    L = codes.shape[1]
    n0 = cuda.launches["mtc_consensus_vote"]
    ref, diffs = consensus.consensus_vote_flat(codes_dev, rd, col, seg_ptr,
                                               col_ptr, span)
    if cuda.launches["mtc_consensus_vote"] != n0 + 1:
        raise AssertionError(f"{tag} consensus_vote_flat: not one launch")
    rd_d, col_d = (torch.from_numpy(x).to(dev) for x in (rd, col))
    pref, pdiffs = consensus._consensus_plain(codes_dev, rd_d, col_d, span,
                                              True)
    err = max(_equal(f"{tag} consensus ref vs plain", ref, pref.cpu()),
              _equal(f"{tag} consensus diffs vs plain", diffs,
                     pdiffs.cpu()))
    href, hdiffs = native.consensus_host(cls.codes_sub, rd, col, seg_ptr,
                                         col_ptr, span, True, True)
    _equal(f"{tag} consensus ref vs host", ref, href)
    _equal(f"{tag} consensus diffs vs host", diffs, hdiffs)
    tref, tdiffs = consensus.consensus_vote(codes_dev, rd_d, col_d, span)
    _equal(f"{tag} consensus ref, one cluster", tref.cpu(), ref)
    _equal(f"{tag} consensus diffs, one cluster", tdiffs.cpu(), diffs)
    return err, (codes_dev, rd, col, seg_ptr, col_ptr, span, rd_d, col_d,
                 L)


def phase1_consensus(dev, fastq_path, report):
    """The vote of ``_check_vote`` on the phase-3 dataset; the launch timed
    from CUDA graphs (a launch from Python outlasts it)."""
    err, (codes_dev, rd, col, seg_ptr, col_ptr, span, rd_d, col_d,
          L) = _check_vote(dev, fastq_path, "phase 1")
    M = len(rd)
    t0 = time.perf_counter()
    plan, n_tiles, cap = consensus._upload(rd, col, seg_ptr, col_ptr, L, dev)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    outs = (torch.empty(span, dtype=torch.uint8, device=dev),
            torch.empty(M, dtype=torch.int32, device=dev))
    ms = _graph_ms(lambda: consensus._kernel(codes_dev, plan, M, n_tiles,
                                             cap, *outs))
    plain_ms = _ms(lambda: consensus._consensus_plain(codes_dev, rd_d, col_d,
                                                      span, True), 5)
    print(f"[1] consensus_vote_flat {M} members in {len(seg_ptr) - 1} "
          f"clusters, span {span}, {n_tiles} tiles (widest {cap} columns): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, plan and upload "
          f"{host_ms:.3f} ms on the host; equal to plain, host and the "
          "one-cluster entry")
    report["mtc_consensus_vote"] = dict(
        name="consensus_vote_flat", route="cuda",
        source="minicom_tpu_torch/csrc/consensus.cu",
        replaces="minicom_tpu/ops/consensus.py:115", max_abs_err=err, ms=ms,
        plain_ms=plain_ms,
        # the member rows that the vote gathers, not the whole store
        **_bound(M * (L + 16) + span + 4 * M,
                 M * L * OPS["vote_base"] + span * OPS["vote_column"]))


def phase1_verify(dev, report):
    rng = np.random.default_rng(4)
    N, W = 1 << 20, 7
    a = rng.integers(0, 2**32, (N, W), dtype=np.uint32)
    b = a ^ (rng.random((N, W)) < 0.02).astype(np.uint32) << np.uint32(
        2 * rng.integers(0, 16, (N, W)).astype(np.uint32))
    da, db = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    got = verify.popcount_verify(da, db)
    err = _equal("verify vs plain", got.cpu(),
                 verify._verify_plain(da, db).cpu())
    _equal("verify vs numpy", got.cpu(),
           popcount_u32(a ^ b).sum(axis=1).astype(np.int32))
    out = torch.empty(N, dtype=torch.int32, device=dev)
    ms = _graph_ms(lambda: cuda.launch("mtc_popcount_verify", da, db, N, W,
                                       out))
    plain_ms = _ms(lambda: verify._verify_plain(da, db), 5)
    print(f"[1] popcount_verify {N} x {W} words: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; equal to plain and numpy")
    report["mtc_popcount_verify"] = dict(
        name="popcount_verify", route="cuda",
        source="minicom_tpu_torch/csrc/verify.cu",
        replaces="minicom_tpu/ops/pallas_verify.py:49", max_abs_err=err,
        ms=ms, plain_ms=plain_ms,
        **_bound(_nbytes(da, db, out), N * W * OPS["verify_word"]))


def _decode_ms(batch, only=None, reps=10):
    """Median milliseconds of one decode launch over an uploaded batch, or
    over its block ``only`` alone (the same buffers, one descriptor)."""
    head, words, freq, desc, size = batch
    full, smem = rans._plan(*batch)
    if only is not None:
        head, full = head[only: only + 1], full[only: only + 1]
    full = full.to(head.device)
    out = torch.empty(size, dtype=torch.uint8, device=head.device)
    return _ms(lambda: cuda.launch("mtc_rans_decode", head, words,
                                   words.shape[0], freq, full, len(full),
                                   smem, out), reps)


def _encode_ms(args, only=None, reps=10):
    """The same for one encode launch over uploaded symbols and rows."""
    syms, freq, _ = args
    full, smem, size = rans._plan_encode(*args)
    if only is not None:
        full = full[only: only + 1]
    full = full.to(syms.device)
    head = torch.empty((len(full), 256), dtype=torch.uint32,
                       device=syms.device)
    scratch, words = (torch.empty(size, dtype=torch.uint16,
                                  device=syms.device) for _ in range(2))
    return _ms(lambda: cuda.launch("mtc_rans_encode", syms, freq, full,
                                   len(full), smem, head, scratch, words),
               reps)


def _encode_checked(label, models, args):
    """One encode launch over ``args`` (``pack_symbols`` of ``models``),
    equal to the plain version on the same tensors: states, counts, and
    every block's lane streams. Returns (the coded blocks, max |diff|, the
    plain version's milliseconds)."""
    n0 = cuda.launches["mtc_rans_encode"]
    enc = rans.rans_encode_blocks(*args)
    if cuda.launches["mtc_rans_encode"] != n0 + 1:
        raise AssertionError(f"{label}: not one encode launch")
    full, _, size = rans._plan_encode(*args)
    penc, plain_ms = _once_ms(lambda: rans._encode_blocks_plain(
        args[0], args[1], full, size))
    coded, pcoded = (device_rans.unpack_words(models, args[2], *e)
                     for e in (enc, penc))
    err = max(_equal(f"{label} encode {nm} of block {i} vs plain",
                     getattr(g, nm), getattr(p, nm))
              for i, (g, p) in enumerate(zip(coded, pcoded))
              for nm in ("head", "words"))
    return coded, err, plain_ms


def _same_block(label, got, want):
    """A coded block equal to one parsed from a stream."""
    for nm in ("n", "T", "A", "C", "chunked"):
        if getattr(got, nm) != getattr(want, nm):
            raise AssertionError(f"{label}: {nm} {getattr(got, nm)} != the "
                                 f"stream's {getattr(want, nm)}")
    for nm in ("freq", "head", "words"):
        _equal(f"{label} {nm} vs the stream", getattr(got, nm),
               getattr(want, nm))


def _coder(dev, buf, k):
    """What the codec with order ``k`` (None: order-0 "trans") makes of the
    bytes ``buf``: (symbol ids, one model per block, the blocks parsed from
    the stream that compress writes)."""
    if k is None:
        syms, step, model = buf, device_rans.BLOCK, device_rans._model
        blob = device_rans.compress(buf.tobytes(), dev)
        parse = device_rans._parse_block
    else:
        alphabet, syms = device_ctx_rans.remap(buf)
        step = device_ctx_rans.BLOCK
        model = lambda part: device_ctx_rans._model(  # noqa: E731
            part, len(alphabet), k)
        blob = device_ctx_rans.compress(buf.tobytes(), k, dev)
        parse = device_ctx_rans._parse_block
    models = [model(syms[i: i + step]) for i in range(0, len(syms), step)]
    return syms, models, _stream_blocks(blob, parse)


def _rans_block(dev, label, buf, k):
    """Kernel vs plain encode and decode of one block, both batched kernels
    at B = 1, from the block's symbols and quantized rows as the codec
    makes them; the coded block must equal its bytes in the stream that
    compress writes, and the decoded symbols the block's. Returns a dict of
    errors, times, and the (bytes, operations) of each launch."""
    syms, models, in_stream = _coder(dev, buf, k)
    model = models[0]
    T, A, C = model.T, model.A, model.C
    args = device_rans.pack_symbols(syms, models, dev)
    (block,), enc_err, penc_ms = _encode_checked(label, models, args)
    _same_block(label, block, in_stream[0])
    batch = device_rans.pack_blocks([block], dev)
    out = rans.rans_decode_blocks(*batch)
    pout, pdec_ms = _once_ms(lambda: rans._decode_blocks_plain(*batch))
    dec_err = _equal(f"{label} decode vs plain", out.cpu(), pout.cpu())
    got = device_rans.unpack_symbols([block], out.cpu().numpy())[0]
    if not np.array_equal(got, syms):
        raise AssertionError(f"{label}: decode does not give back the block")
    enc_ms = _encode_ms(args)
    dec_ms = _decode_ms(batch)
    # what the function must move whatever implements it: the symbols and
    # the frequency rows in, the states, the counts and the words out
    enc_work = (model.n + 2 * C * A + 4 * 256 + 2 * len(block.words),
                T * 128 * OPS["rans_encode_slot"])
    dec_work = (_nbytes(*batch[:3], out), T * 128 * (
        OPS["rans_decode_step"] + (A - 1).bit_length()))
    eb, db = _bound(*enc_work), _bound(*dec_work)
    print(f"[1] rans {label} (T={T}, A={A}, C={C}, {len(block.words)} "
          f"words): encode kernel (B=1) {enc_ms:.3f} ms = "
          f"{enc_ms * 1e6 / T:.1f} ns a step, plain {penc_ms:.3f} ms, bytes "
          f"bound {eb['bytes_bound_ms']:.5f} ms, operations bound "
          f"{eb['ops_bound_ms']:.5f} ms; decode kernel (B=1) "
          f"{dec_ms:.3f} ms = {dec_ms * 1e6 / T:.1f} ns a step, plain "
          f"{pdec_ms:.3f} ms, bytes bound {db['bytes_bound_ms']:.5f} ms, "
          f"operations bound {db['ops_bound_ms']:.5f} ms; equal to plain "
          "and to the stream, roundtrip exact")
    return dict(enc_err=enc_err, dec_err=dec_err, enc_ms=enc_ms,
                penc_ms=penc_ms, dec_ms=dec_ms, pdec_ms=pdec_ms,
                enc_work=enc_work, dec_work=dec_work)


def _rans_batch(dev, label, buf, k):
    """Every block of the bytes ``buf`` in one encode launch and one decode
    launch: each equal to the plain version on the same tensors and to the
    stream that compress writes of ``buf``; each launch's time beside the
    sum of the blocks' B = 1 launches."""
    syms, models, in_stream = _coder(dev, buf, k)
    args = device_rans.pack_symbols(syms, models, dev)
    blocks, _, penc_ms = _encode_checked(label, models, args)
    for i, (got, want) in enumerate(zip(blocks, in_stream)):
        _same_block(f"{label} block {i}", got, want)
    batch = device_rans.pack_blocks(blocks, dev)
    n0 = cuda.launches["mtc_rans_decode"]
    out = rans.rans_decode_blocks(*batch)
    if cuda.launches["mtc_rans_decode"] != n0 + 1:
        raise AssertionError(f"{label}: not one decode launch")
    pout, pdec_ms = _once_ms(lambda: rans._decode_blocks_plain(*batch))
    _equal(f"{label} decode vs plain", out.cpu(), pout.cpu())
    got = np.concatenate(device_rans.unpack_symbols(blocks,
                                                    out.cpu().numpy()))
    if not np.array_equal(got, syms):
        raise AssertionError(f"{label}: decode does not give back the "
                             "stream")
    for what, ms, each, plain_ms in (
            ("encode", _encode_ms(args),
             [_encode_ms(args, i) for i in range(len(blocks))], penc_ms),
            ("decode", _decode_ms(batch),
             [_decode_ms(batch, i) for i in range(len(blocks))], pdec_ms)):
        print(f"[1] rans {label} {what}: {len(blocks)} blocks (T = "
              f"{[b.T for b in blocks]}) in one launch {ms:.3f} ms; one "
              f"launch a block {sum(each):.3f} ms "
              f"({', '.join(f'{e:.3f}' for e in each)}); plain "
              f"{plain_ms:.3f} ms; equal to plain and to the stream")


def _stream_blocks(blob, parse):
    """The parsed blocks of a coded stream."""
    n = int(np.frombuffer(blob, "<u8", 1)[0])
    mv, off, got, blocks = memoryview(blob), 8, 0, []
    while got < n:
        parsed = parse(mv[off:])
        blocks.append(parsed[0])
        got += parsed[0].n
        off += parsed[-1]
    return blocks


def phase1_rans(dev, streams, report):
    """The rANS scans on blocks of the 5M run's own streams; the JSON
    line's times are the sums over the three blocks."""
    diff = np.frombuffer(streams["diff"], np.uint8)
    if len(diff) < 1 << 22:
        raise AssertionError(f"diff stream of {len(diff)} B: want a full "
                             "trans2 block")
    tok, nt, lit = native.dz_encode_parts(streams["ref"])
    lit_codes = np.stack([(np.frombuffer(lit, np.uint8) >> (2 * i)) & 3
                          for i in range(4)], axis=-1).reshape(-1).astype(
                              np.uint8)
    res = [_rans_block(dev, label, buf, k) for label, buf, k in (
        ("order-0 diff", diff[:device_rans.BLOCK], None),
        ("trans2 diff", diff[:device_ctx_rans.BLOCK], 2),
        ("dzt literals", lit_codes[:device_ctx_rans.BLOCK], 4))]

    # batches, one launch each way: the first three order-0 blocks of the
    # diff stream and its tail block (blocks code independently, so these
    # are the stream's own), and the first two trans2 blocks
    full = len(diff) // device_rans.BLOCK * device_rans.BLOCK
    _rans_batch(dev, "order-0 batch",
                np.concatenate([diff[:3 * device_rans.BLOCK], diff[full:]]),
                None)
    _rans_batch(dev, "trans2 batch", diff[:2 * device_ctx_rans.BLOCK], 2)

    def summed(key):   # the three blocks together
        return sum(r[key] for r in res)

    def bound(key):
        return _bound(*(sum(r[key][i] for r in res) for i in (0, 1)))

    report["mtc_rans_encode"] = dict(
        name="rans_encode", route="cuda",
        source="minicom_tpu_torch/csrc/rans.cu",
        replaces="minicom_tpu/entropy/device_rans.py:79",
        max_abs_err=max(r["enc_err"] for r in res), ms=summed("enc_ms"),
        plain_ms=summed("penc_ms"), **bound("enc_work"))
    report["mtc_rans_decode"] = dict(
        name="rans_decode", route="cuda",
        source="minicom_tpu_torch/csrc/rans.cu",
        replaces="minicom_tpu/entropy/device_rans.py:123",
        max_abs_err=max(r["dec_err"] for r in res), ms=summed("dec_ms"),
        plain_ms=summed("pdec_ms"), **bound("dec_work"))


class _LaunchTimer:
    """Counts set to 0 on entry and read on exit, and CUDA events around
    every kernel launch in between (the launch itself, and its count, are
    unchanged): which kernels a run launched, and their device seconds."""

    def __enter__(self):
        self.events = []
        self._launch = cuda.launch

        def timed_launch(name, *args):
            # on the stream the launch takes: its tensors' card's
            stream = torch.cuda.current_stream(next(
                a.device for a in args if isinstance(a, torch.Tensor)))
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record(stream)
            self._launch(name, *args)
            t1.record(stream)
            self.events.append((name, t0, t1))

        cuda.launches.clear()
        cuda.launch = timed_launch
        return self

    def __exit__(self, *exc):
        cuda.launch = self._launch
        self.launched = dict(cuda.launches)

    def seconds(self) -> dict:
        out = {}
        for name, e0, e1 in self.events:
            e1.synchronize()
            out[name] = out.get(name, 0.0) + e0.elapsed_time(e1) / 1e3
        return out


class _Crossings:
    """The bytes of each crossing between host and card that the package's
    helpers (``ops/cuda.py``: ``to_device``, ``to_host``) account while it
    is open, one entry a crossing (list.append holds up under the
    container's pool threads)."""

    def __enter__(self):
        self.nbytes = []
        self._account = cuda._account

        def counted(dt, nbytes=0):
            self.nbytes.append(nbytes)
            self._account(dt, nbytes)

        cuda._account = counted
        return self

    def __exit__(self, *exc):
        cuda._account = self._account


def _accounting_cost_s(n: int = 100_000) -> float:
    """At most the host seconds that the helpers' accounting adds to one
    crossing: two clock reads and one locked update of the counters (the
    loop's own cost included)."""
    t0 = time.perf_counter()
    for _ in range(n):
        s = time.perf_counter()
        cuda._account(0.0 * (time.perf_counter() - s))
    return (time.perf_counter() - t0) / n


def _device_by_stage(tag, what, summary, wall_s) -> dict:
    """Prints a run's device seconds and bytes by stage (the summary's
    device_<stage>_s and device_<stage>_bytes) and their seconds over the
    run's wall; fails where a stage's device seconds exceed the stage's
    wall by more than the summary's rounding (ms for device seconds, 0.1 ms
    for stage walls)."""
    by = {}
    for key, v in summary.items():
        if key.startswith("device_"):
            stage, unit = key[len("device_"):].rsplit("_", 1)
            by.setdefault(stage, {})[unit] = v
    secs = sum(x["s"] for x in by.values())
    print(f"[{tag}] {what} device s and bytes by stage: {json.dumps(by)}; "
          f"{secs:.3f} s in all, {secs / wall_s:.6f} of the {what} wall "
          f"{wall_s:.2f} s")
    walls = summary["timings_s"]
    over = {s: [x["s"], walls[s]] for s, x in by.items()
            if x["s"] - 5e-4 > walls[s] + 5e-5}
    if over:
        raise AssertionError(f"[{tag}] {what}: device seconds above the "
                             f"stage wall: {over}")
    return by


def _mb_of(lens, k, w, cap):
    """Each contig's slot count: its rung's ``_batch_m`` (merge's plan)."""
    u, inv = np.unique(np.maximum(lens, k + 1), return_inverse=True)
    return np.array([_batch_m(_lmax_bucket(int(n)), k, w, cap)
                     for n in u], np.int64)[inv]


def needed_starts(lens, k, w, mb, nv, last_end):
    """The k-mer starts that a contig sketch must rank: every start of a row
    whose emissions stay under its slot count ``mb``; up to the last kept
    emission's start plus a window for a row that fills it (past there no
    window can change what was kept). ``last_end``: the end position of
    each row's last kept entry."""
    S = np.maximum(lens.astype(np.int64) - k + 1, 0)
    cut = np.minimum(S, last_end.astype(np.int64) - k + 1
                     + np.minimum(w, S))
    return np.where(nv >= mb, cut, S)


class _SketchCalls:
    """Wraps ``merge.sketch_contigs`` for a span: per call its contigs,
    their k-mer starts (all, and what the call's data needs: see
    ``needed_starts``), the bytes the call's function must move, the
    contig-sketch launches it made and its host wall seconds."""

    def __enter__(self):
        self.calls = []
        self._fn = merge.sketch_contigs

        def counted(cs, k, w, rank_cap, device, stats=None):
            n0 = cuda.launches["mtc_sketch_windowed"]
            t0 = time.perf_counter()
            out = self._fn(cs, k, w, rank_cap, device, stats)
            t1 = time.perf_counter()
            lens = cs.ref_lengths().astype(np.int64)
            cid, pos = out[1], out[2]
            nv = np.bincount(cid, minlength=len(lens))
            # a contig's entries lie together, in position order
            last = np.zeros(len(lens), np.int64)
            ends = np.flatnonzero(np.r_[cid[1:] != cid[:-1], True]) \
                if len(cid) else np.zeros(0, np.int64)
            last[cid[ends]] = pos[ends]
            nbytes, need, every = _sketch_work(
                lens, k, w, _mb_of(lens, k, w, rank_cap), nv, last)
            self.calls.append(dict(
                rows=len(lens), starts=every, needed=need, bytes=nbytes,
                launches=cuda.launches["mtc_sketch_windowed"] - n0,
                wall_s=t1 - t0, counting_s=time.perf_counter() - t1))
            return out

        merge.sketch_contigs = counted
        return self

    def __exit__(self, *exc):
        merge.sketch_contigs = self._fn

    def report(self, tag, device_s, substage_s):
        """Prints the calls and returns their totals."""
        c = self.calls
        tot = {key: sum(x[key] for x in c)
               for key in ("rows", "starts", "needed", "bytes", "launches")}
        b_all = _bound(tot["bytes"], tot["starts"] * OPS["kmer_window"])
        b_need = _bound(tot["bytes"], tot["needed"] * OPS["kmer_window"])
        # this accounting runs inside the merge_sketch sub-stage: take it out
        counting = sum(x["counting_s"] for x in c)
        tot.update(calls=len(c), device_s=device_s,
                   merge_sketch_s=substage_s - counting,
                   bound_all_ms=b_all["bound_ms"],
                   bound_needed_ms=b_need["bound_ms"],
                   bound_by=b_need["bound_by"],
                   calls_wall_s=sum(x["wall_s"] for x in c),
                   counting_s=counting)
        print(f"[{tag}] contig sketch per sketch_contigs call (rows, k-mer "
              "starts, starts needed, launches): " + json.dumps(
                  [[x["rows"], x["starts"], x["needed"], x["launches"]]
                   for x in c]))
        print(f"[{tag}] contig sketch totals: " + json.dumps(tot))
        return tot


class _ConsensusCalls:
    """Wraps ``consensus_from_members`` (the entry of the cluster rounds and
    of merge's re-votes) for a span: per call its members, bases, columns
    and segments, the consensus launches it made, its host wall seconds and
    the bytes its function must move (the member rows, (rd, col) as int64,
    the ref and diffs asked for); with the span's ``_LaunchTimer``, also
    the device seconds of its launches."""

    def __init__(self, timer=None):
        self.timer = timer

    def __enter__(self):
        self.calls = []
        self._fn = cluster.consensus_from_members

        def counted(readlen, seg_id, offsets, rids, dirs, n_segments,
                    codes_dev, want_ref=True, want_diffs=True):
            n0 = cuda.launches["mtc_consensus_vote"]
            e0 = len(self.timer.events) if self.timer else 0
            t0 = time.perf_counter()
            out = self._fn(readlen, seg_id, offsets, rids, dirs, n_segments,
                           codes_dev, want_ref, want_diffs)
            wall = time.perf_counter() - t0
            M, span = len(seg_id), int(out[1][-1])
            self.calls.append(dict(
                members=M, bases=M * readlen, columns=span,
                segments=int(np.count_nonzero(np.diff(out[1]))),
                launches=cuda.launches["mtc_consensus_vote"] - n0,
                wall_s=wall, bytes=M * (readlen + 16) + span * want_ref
                + 4 * M * want_diffs,
                events=self.timer.events[e0:] if self.timer else [],
                peak_B=torch.cuda.max_memory_allocated()
                if torch.cuda.is_available() else None))
            return out

        cluster.consensus_from_members = merge.consensus_from_members = counted
        return self

    def __exit__(self, *exc):
        cluster.consensus_from_members = merge.consensus_from_members = \
            self._fn

    def report(self, tag, device_s):
        """Prints the calls and returns their totals; fails where a call
        made more than one consensus launch, or one with members none."""
        c = self.calls
        if self.timer:
            torch.cuda.synchronize()
        for x in c:
            x["device_ms"] = sum(e0.elapsed_time(e1) for name, e0, e1
                                 in x.pop("events")
                                 if name == "mtc_consensus_vote")
        tot = {key: sum(x[key] for x in c)
               for key in ("members", "bases", "columns", "segments",
                           "launches", "wall_s", "bytes")}
        b = _bound(tot["bytes"], tot["bases"] * OPS["vote_base"]
                   + tot["columns"] * OPS["vote_column"])
        tot.update(calls=len(c), device_s=device_s, bound_ms=b["bound_ms"],
                   bound_by=b["bound_by"], bytes_bound_ms=b["bytes_bound_ms"],
                   ops_bound_ms=b["ops_bound_ms"],
                   share_of_bound=b["bound_ms"] / 1e3 / device_s
                   if device_s else None)
        print(f"[{tag}] consensus per consensus_from_members call (members, "
              "bases, columns, clusters, launches, host wall s, device ms): "
              + json.dumps([[x["members"], x["bases"], x["columns"],
                             x["segments"], x["launches"],
                             round(x["wall_s"], 4), round(x["device_ms"], 4)]
                            for x in c]))
        print(f"[{tag}] consensus: peak device memory after each call B: "
              + json.dumps([x["peak_B"] for x in c]))
        print(f"[{tag}] consensus totals: " + json.dumps(tot))
        bad = [i for i, x in enumerate(c)
               if x["launches"] > 1 or (x["members"] and not x["launches"])]
        if bad:
            raise AssertionError(f"consensus calls {bad} did not make one "
                                 "launch each")
        return tot


class _ReadSketchCalls:
    """Wraps the cluster rounds' ``sketch_reads_flat`` for a span: per call
    the reads sketched, k, the launches and the host wall seconds; with the
    span's ``_LaunchTimer``, the device ms of its launches; the bytes and
    operations of the work (every k-mer start of every read ranked,
    ``kmer_min_ops``)."""

    def __init__(self, timer=None):
        self.timer = timer

    def __enter__(self):
        self.calls = []
        self._fn = cluster.sketch_reads_flat

        def counted(codes, rids, k):
            n0 = cuda.launches["mtc_sketch_reads"]
            e0 = len(self.timer.events) if self.timer else 0
            t0 = time.perf_counter()
            out = self._fn(codes, rids, k)
            wall = time.perf_counter() - t0
            n, L = len(rids), codes.shape[1]
            starts = n * max(L - k + 1, 0)
            self.calls.append(dict(
                reads=n, k=k, starts=starts, ops=starts * kmer_min_ops(k),
                bytes=n * (L + 4 + 12),   # a row, its int32 rid, 3 words
                launches=cuda.launches["mtc_sketch_reads"] - n0, wall_s=wall,
                events=self.timer.events[e0:] if self.timer else []))
            return out

        cluster.sketch_reads_flat = counted
        return self

    def __exit__(self, *exc):
        cluster.sketch_reads_flat = self._fn

    def report(self, tag, device_s):
        """Prints the calls and returns their totals; fails where the calls
        made more launches than there were calls."""
        c = self.calls
        if self.timer:
            torch.cuda.synchronize()
        for x in c:
            x["device_ms"] = sum(e0.elapsed_time(e1) for name, e0, e1
                                 in x.pop("events")
                                 if name == "mtc_sketch_reads")
        tot = {key: sum(x[key] for x in c)
               for key in ("reads", "starts", "ops", "bytes", "launches",
                           "wall_s")}
        b = _bound(tot["bytes"], tot["ops"])
        tot.update(calls=len(c), device_s=device_s, bound_ms=b["bound_ms"],
                   bound_by=b["bound_by"],
                   share_of_bound=b["bound_ms"] / 1e3 / device_s
                   if device_s else None)
        print(f"[{tag}] read minimizer per sketch_reads_flat call (reads, k, "
              "launches, host wall s, device ms): " + json.dumps(
                  [[x["reads"], x["k"], x["launches"], round(x["wall_s"], 5),
                    round(x["device_ms"], 4)] for x in c]))
        print(f"[{tag}] read minimizer totals: " + json.dumps(tot))
        if tot["launches"] > tot["calls"]:
            raise AssertionError(f"{tot['launches']} read-minimizer launches "
                                 f"for {tot['calls']} sketch_reads_flat "
                                 "calls")
        return tot


def _require(launched, names, where):
    missing = [k for k in names if launched.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"{where} never launched {missing}")


def _check_roundtrip(dec, want, n):
    if not np.array_equal(sorted_rows(decoded_rows(dec, n, 100)), want):
        raise AssertionError("roundtrip is not exact")


def phase2_end_to_end(dev, tmp):
    fq, arc, dec = (os.path.join(tmp, f) for f in ("e2e.fastq", "e2e.mtc",
                                                  "e2e.reads"))
    t0 = time.perf_counter()
    make_dataset(fq, N_READS)
    print(f"[2] dataset {N_READS} reads x 100 bp generated in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    with _LaunchTimer() as lt, _SketchCalls() as sk, \
            _ConsensusCalls(lt) as cc, _ReadSketchCalls(lt) as rs, \
            _Crossings() as cx:
        t0 = time.perf_counter()
        summary = compressor.compress(fq, arc, device=dev)
        enc_s = time.perf_counter() - t0
    kernel_s = lt.seconds()
    peak_dev = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    dsum = compressor.decompress(arc, dec, device=dev)
    dec_s = time.perf_counter() - t0

    want = sorted_rows(input_rows(fq))
    _check_roundtrip(dec, want, N_READS)
    mb = summary["input_bytes"] / 1e6
    sub = {k: v for k, v in summary.items()
           if k.endswith("_s") and isinstance(v, float)}
    print(f"[2] roundtrip exact; encode {enc_s:.2f} s = {mb / enc_s:.3f} "
          f"MB/s, decode {dec_s:.2f} s = {mb / dec_s:.3f} MB/s, archive "
          f"{summary['archive_bytes']} B (ratio "
          f"{summary['input_bytes'] / summary['archive_bytes']:.3f}), peak "
          f"device memory {peak_dev} B, peak host RSS of this process "
          "(dataset generation and checks included) "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024} B")
    print("[2] encode stages s: " + json.dumps(summary["timings_s"]))
    print("[2] encode sub-stages s: " + json.dumps(sub))
    print("[2] counters: " + json.dumps(
        {k: summary[k] for k in ("clusters_initial", "singletons_initial",
                                 "clusters_merged", "singletons_final",
                                 "merge_probe_drops", "merge_rank_saturated")}))
    print("[2] decode stages s: " + json.dumps(dsum["timings_s"]))
    print("[2] kernel launches during compress: " + json.dumps(lt.launched))
    print(f"[2] kernel device seconds during compress: "
          f"{json.dumps(kernel_s)}; {sum(kernel_s.values()) / enc_s:.6f} of "
          "the encode wall")
    tot = sk.report("2", kernel_s.get("mtc_sketch_windowed", 0.0),
                    summary.get("merge_sketch_s"))
    if tot["launches"] > tot["calls"]:
        raise AssertionError(f"{tot['launches']} contig-sketch launches for "
                             f"{tot['calls']} sketch_contigs calls")
    cc.report("2", kernel_s.get("mtc_consensus_vote", 0.0))
    rs.report("2", kernel_s.get("mtc_sketch_reads", 0.0))
    _device_by_stage("2", "encode", summary, enc_s)
    _device_by_stage("2", "decode", dsum, dec_s)
    pin = bench_torch.load_cell("se-5M-100bp-default")[0]["archive"]
    with open(arc, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if N_READS == 5_000_000 and digest != pin["sha256"]:
        raise AssertionError(f"the 5M archive ({summary['archive_bytes']} "
                             f"B) is not the default cell's pin "
                             f"({pin['bytes']} B, {pin['sha256'][:12]})")
    cost = _accounting_cost_s()
    print(f"[2] {len(cx.nbytes)} crossings between host and card during "
          f"compress ({sum(cx.nbytes)} B); the accounting costs at most "
          f"{cost * 1e6:.3f} us a crossing here, "
          f"{cost * len(cx.nbytes):.6f} s of the encode")
    return fq, arc, lt.launched


def phase2_device_codecs(dev, fq, same):
    """codec="device" on phase 3's 100k set: the entropy stage on the card;
    the archive must equal phase 3's codec=device cuda archive."""
    tmp = os.path.dirname(fq)
    arc, dec = (os.path.join(tmp, f) for f in ("dev.mtc", "dev.reads"))
    auto_bytes = os.path.getsize(same["codec=auto"])
    with _LaunchTimer() as enc:
        t0 = time.perf_counter()
        summary = compressor.compress(fq, arc, CompressorConfig(codec="device"),
                                      device=dev)
        enc_s = time.perf_counter() - t0
    enc_k = enc.seconds()
    with _LaunchTimer() as dec_lt:
        t0 = time.perf_counter()
        dsum = compressor.decompress(arc, dec, device=dev)
        dec_s = time.perf_counter() - t0
    dec_k = dec_lt.seconds()
    _check_roundtrip(dec, sorted_rows(input_rows(fq)), N_SAME_BYTES)
    _same_archive(arc, same["codec=device"], "2d and phase 3's codec=device")
    mb = summary["input_bytes"] / 1e6
    nb = summary["archive_bytes"]
    print(f"[2d] codec=device roundtrip exact; encode {enc_s:.2f} s = "
          f"{mb / enc_s:.3f} MB/s, decode {dec_s:.2f} s = {mb / dec_s:.3f} "
          f"MB/s, archive {nb} B (ratio {summary['input_bytes'] / nb:.3f}; "
          f"{nb / auto_bytes:.6f} x the codec=auto archive's {auto_bytes} B)")
    print("[2d] streams {name: [codec, raw B, coded B]}: " + json.dumps(
        {e["name"]: [e["codec"], e["rlen"], e["clen"]]
         for e in container.read_header(arc)["streams"]}))
    print("[2d] encode stages s: " + json.dumps(summary["timings_s"]))
    print("[2d] decode stages s: " + json.dumps(dsum["timings_s"]))
    print("[2d] kernel launches: compress " + json.dumps(enc.launched)
          + ", decompress " + json.dumps(dec_lt.launched))
    print("[2d] kernel device seconds: compress " + json.dumps(enc_k)
          + ", decompress " + json.dumps(dec_k) + "; read_container stage "
          f"{dsum['timings_s']['read_container']} s")
    _device_by_stage("2d", "encode", summary, enc_s)
    _device_by_stage("2d", "decode", dsum, dec_s)

    def planes(codec):   # coded planes of a codec: launches it may make
        base = codec.split(":")[-1]
        return 2 if base == "dzt" else int(base in ("trans", "trans1",
                                                    "trans2"))

    # one decode launch per coded plane of the codec a stream was given;
    # one encode launch per coded plane of every candidate tried for it
    table = container.read_header(arc)["streams"]
    most_dec = sum(planes(e["codec"]) for e in table)
    most_enc = sum(planes(c) for e in table for c in
                   container._auto_candidates(e["name"], e["rlen"], "device"))
    for what, lt, most in (("decode", dec_lt, most_dec),
                           ("encode", enc, most_enc)):
        n = lt.launched.get(f"mtc_rans_{what}", 0)
        if n > most:
            raise AssertionError(f"{n} rANS {what} launches for {most} "
                                 "coded planes: more than one launch a plane")
    print(f"[2d] rANS encode launches {enc.launched['mtc_rans_encode']} <= "
          f"{most_enc} coded planes of the candidates tried for "
          f"{len(table)} streams: {enc_k['mtc_rans_encode']:.6f} device s, "
          f"entropy stage {summary['timings_s']['entropy']} s; rANS decode "
          f"launches {dec_lt.launched['mtc_rans_decode']} <= {most_dec} "
          f"coded planes: {dec_k['mtc_rans_decode']:.6f} device s")
    return enc.launched, dec_lt.launched


def _same_archive(a, b, what):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError(f"{what}: archives differ")


def phase3_same_bytes(dev, fq, tmp, twins=True):
    """Returns the mate files and the cuda archive of each case, by tag.
    The mates are the PE cell's input cut to 100,000 reads
    (``bench_torch.make_inputs``: fragment pairs at the benchmark's seed).
    Without ``twins`` (``--cards``) only the cuda archives are made."""
    seed = bench_torch.load_cell("pe-5M-100bp-default")[2]
    m1, m2 = bench_torch.make_inputs(os.path.join(tmp, "same_pe.fastq"),
                                     N_SAME_BYTES, seed, "default", True)
    cuda_archives = {}
    for i, (tag, cfg, fq2) in enumerate((
            ("codec=auto", CompressorConfig(), None),
            ("codec=device", CompressorConfig(codec="device"), None),
            ("order, codec=auto", CompressorConfig(order=True), None),
            ("PE, codec=auto", CompressorConfig(), m2),
            ("PE, codec=device", CompressorConfig(codec="device"), m2))):
        a, b = (os.path.join(tmp, f"same{i}_{d}.mtc") for d in ("cuda",
                                                                "cpu"))
        src = fq if fq2 is None else m1
        compressor.compress(src, a, cfg, reads_path2=fq2, device=dev)
        cuda_archives[tag] = a
        n = (f"{N_SAME_BYTES // 2} pairs" if fq2 else f"{N_SAME_BYTES} reads")
        if not twins:
            print(f"[3] {n}, {tag}: cuda archive {os.path.getsize(a)} B")
            continue
        compressor.compress(src, b, cfg, reads_path2=fq2, device="cpu")
        _same_archive(a, b, f"{tag}: cuda and cpu")
        print(f"[3] {n}, {tag}: cuda and cpu archives identical "
              f"({os.path.getsize(a)} B)")
    return m1, m2, cuda_archives


def phase4_verify_path(dev, fq):
    """The popcount verify of every placement that the host realign probe
    picks at the first threshold of the ladder, on the cluster and merge
    output of the 100,000-read set."""
    codes = fastq.read_fastq_codes(fq)
    L = codes.shape[1]
    cfg = CompressorConfig().resolve(L)
    cls = classify.classify(codes, cfg)
    codes_dev = torch.from_numpy(cls.codes_sub).to(dev)
    cset, sg = cluster.cluster_rounds(codes_dev, cls.pool, cfg)
    rcfg = CompressorConfig().resolve(L, n_singletons=len(sg))
    cset = merge_contigs(cset, rcfg, dev, {}, codes_dev=codes_dev)
    sgc = cls.codes_sub[sg]
    thr = rcfg.diff_threshold
    sg_i, cl, off, dirs, pop = native.realign_probe(
        cset.ref_flat, cset.ref_ptr, sgc,
        np.array([s for s, _ in rcfg.dict_ranges()], np.int32),
        rcfg.dict_seg_len, thr, rcfg.max_search, rc_skip_cost=thr <= 24)
    if len(sg_i) == 0:
        raise AssertionError("the realign probe placed no read")
    start = cset.ref_ptr[cl].astype(np.int64) + off
    win = cset.ref_flat[start[:, None] + np.arange(L)]
    win = np.where((dirs == 1)[:, None], revcomp_codes(win), win)
    a = torch.from_numpy(pack_2bit_words(win)).to(dev)
    b = torch.from_numpy(pack_2bit_words(sgc[sg_i])).to(dev)
    with _LaunchTimer() as lt:
        got = verify.popcount_verify(a, b)
    _equal("verify path vs the realign probe", got.cpu(),
           pop.astype(np.int32))
    print(f"[4] realign verify: {len(sg_i)} placements of {len(sg)} "
          f"singletons at threshold {thr}; the kernel's mismatch counts "
          "equal the host probe's")
    return lt.launched


# Names of the kernels that a traced compress must show (csrc/).
TRACED_KERNELS = {"mtc_sketch_reads": "sketch_reads_kernel",
                  "mtc_consensus_vote": "vote_tiles_kernel",
                  "mtc_sketch_windowed": "sketch_windowed_kernel"}


def _counted_compress(dev, fq, out):
    """One compress: (its device bytes by stage, its wall, its number of
    crossings, its summary); fails unless the stages' device bytes add up
    to the ``device_bytes()`` delta of the call (no crossing outside a
    stage)."""
    b0 = mesh.device_bytes()
    with _Crossings() as cx:
        t0 = time.perf_counter()
        summary = compressor.compress(fq, out, device=dev)
        wall = time.perf_counter() - t0
    delta = mesh.device_bytes() - b0
    by_stage = {k: v for k, v in summary.items()
                if k.startswith("device_") and k.endswith("_bytes")}
    if sum(by_stage.values()) != delta or sum(cx.nbytes) != delta:
        raise AssertionError(f"stages' device bytes {by_stage}, crossings' "
                             f"{sum(cx.nbytes)}, device_bytes() delta {delta}")
    return by_stage, wall, len(cx.nbytes), summary


def _trace_copies(events) -> dict:
    """The host-to-device and device-to-host copies of a trace (Kineto's
    gpu_memcpy events; device-to-device ones left out): their count, bytes
    and device seconds."""
    cp = [e for e in events if e.get("cat") == "gpu_memcpy"
          and ("HtoD" in e.get("name", "") or "DtoH" in e.get("name", ""))]
    return {"copies": len(cp),
            "bytes": sum(e["args"]["bytes"] for e in cp),
            "device_s": sum(e.get("dur", 0) for e in cp) / 1e6,
            "by_kind": {k: sum(k in e["name"] for e in cp)
                        for k in ("HtoD", "DtoH")}}


def _traced_compress(dev, fq, tmp, want):
    """One compress without MTC_TRACE_DIR, then two with it (the first pays
    the profiler's start-up): every archive must equal ``want``, and each
    trace must hold device events of the read minimizer, the vote and the
    contig sketch. The three runs' device bytes by stage must be equal,
    add up to each call's ``device_bytes()`` delta, and, in each trace,
    equal the bytes of its host-to-device and device-to-host copies."""
    out = os.path.join(tmp, "trace.mtc")
    by_stage, wall, _, _ = _counted_compress(dev, fq, out)
    walls, stages = [wall], [by_stage]
    _same_archive(out, want, "untraced compress and phase 3")
    for i in range(2):
        trace_dir = os.path.join(tmp, f"trace{i}")
        os.environ["MTC_TRACE_DIR"] = trace_dir
        try:
            by_stage, wall, crossings, summary = _counted_compress(dev, fq,
                                                                   out)
            walls.append(wall)
        finally:
            del os.environ["MTC_TRACE_DIR"]
        stages.append(by_stage)
        _same_archive(out, want, "traced compress and phase 3")
        files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
        if len(files) != 1 or not files[0].endswith(".pt.trace.json"):
            raise AssertionError(f"MTC_TRACE_DIR holds {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        kern = [e for e in events if e.get("cat") == "kernel"]
        found = {k: sum(fn in e.get("name", "") for e in kern)
                 for k, fn in TRACED_KERNELS.items()}
        if not all(found.values()):
            raise AssertionError(f"trace kernel events by kernel: {found}")
        busy = sum(e.get("dur", 0) for e in kern) / 1e6
        print(f"[5] MTC_TRACE_DIR, compress {i + 1}: "
              f"{os.path.getsize(files[0])} B trace, {len(events)} events, "
              f"{len(kern)} kernel events ({busy:.6f} s on the card), ours "
              f"by name {json.dumps(found)}")
        copies = _trace_copies(events)
        staged = sum(by_stage.values())
        print(f"[5] compress {i + 1}: the stages' device bytes {staged} in "
              f"{crossings} crossings; the trace's host-device copies "
              f"{json.dumps(copies)}")
        if copies["bytes"] != staged:
            raise AssertionError(f"the trace's copies moved "
                                 f"{copies['bytes']} B, the stages "
                                 f"{staged} B")
        streams = [e["name"] for e in container.read_header(out)["streams"]]
        faults = bench_torch.span_faults(events, None, summary, streams)
        if faults:
            raise AssertionError(f"compress {i + 1}: the trace's spans: "
                                 + "; ".join(faults))
        spans = bench_torch.stage_trace_summary(events, None)
        stage_share = {k: round(v, 6) for k, v in spans["busy_share"].items()
                       if k in summary["timings_s"]}
        print(f"[5] compress {i + 1}: {spans['entries']} spans, one for "
              f"each of the {len(summary['timings_s'])} stages, each "
              "sub-stage's inside its stage's, mtc.entropy.<stream> for each"
              f" of {len(streams)} streams; busy share by stage "
              f"{json.dumps(stage_share)}; idle s by innermost span "
              + json.dumps({k: round(v, 6)
                            for k, v in spans["idle_s"].items()}))
    if any(s != stages[0] for s in stages):
        raise AssertionError(f"device bytes by stage differ: {stages}")
    print(f"[5] compress walls s, untraced then traced twice: "
          f"{json.dumps(walls)}; archives equal phase 3's; device bytes by "
          f"stage equal in the three {json.dumps(stages[0])}, each the "
          "call's device_bytes() delta and, traced, the trace's copies")


def phase5_resume(dev, fq, tmp, want):
    """A traced compress; then a run resumed from the cluster snapshot
    re-votes in merge and writes the uninterrupted run's archive."""
    _traced_compress(dev, fq, tmp, want)
    ck = os.path.join(tmp, "ck")
    a, b = (os.path.join(tmp, f"resume_{x}.mtc") for x in ("a", "b"))
    cfg = CompressorConfig(checkpoint_dir=ck)
    compressor.compress(fq, a, cfg, device=dev)
    for stage in ("merge", "realign"):
        os.unlink(os.path.join(ck, f"{stage}.npz"))
    with _LaunchTimer() as lt:
        summary = compressor.compress(fq, b, cfg, device=dev)
    if summary.get("resumed_from") != "cluster":
        raise AssertionError(f"resumed from {summary.get('resumed_from')}, "
                             "want cluster")
    _require(lt.launched, ("mtc_sketch_windowed", "mtc_consensus_vote"),
             "the resumed compress")
    if lt.launched.get("mtc_sketch_reads", 0):
        raise AssertionError("the resumed compress ran the cluster stage")
    _same_archive(a, b, "resumed and uninterrupted runs")
    print(f"[5] {N_SAME_BYTES} reads resumed from the cluster snapshot: "
          f"launches {json.dumps(lt.launched)}, stages s "
          f"{json.dumps(summary['timings_s'])}; archive equals the "
          f"uninterrupted run's ({os.path.getsize(b)} B)")


class _NamedStages(StageStats):
    """StageStats that also names the stage open now (for _RssPeak)."""
    current = None

    @contextlib.contextmanager
    def stage(self, name: str):
        self.current = name
        try:
            with super().stage(name):
                yield
        finally:
            self.current = None


class _RssPeak:
    """Peak resident bytes of this process over a span, sampled every 5 ms
    from /proc/self/statm by a thread: ru_maxrss cannot be reset, and a
    worker's starts at its parent's high-water mark (fork copies it and
    exec keeps it). ``peak`` is None where /proc has no statm;
    ``by_stage`` holds the peak within each stage of ``stats``."""

    def __init__(self, stats: _NamedStages | None = None):
        self.peak = self.now()
        self.stats = stats
        self.by_stage = {}
        self._stop = threading.Event()

    @staticmethod
    def now():
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, IndexError, ValueError):
            return None

    def _run(self):
        while not self._stop.wait(0.005):
            rss = self.now() or 0
            self.peak = max(self.peak, rss)
            name = self.stats and self.stats.current
            if name:
                self.by_stage[name] = max(self.by_stage.get(name, 0), rss)

    def __enter__(self):
        if self.peak is not None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self.peak is not None:
            self._thread.join()
            self.peak = max(self.peak, self.now() or 0)


def _digests(outs) -> list[str]:
    """SHA-256 of each tensor's bytes."""
    return [hashlib.sha256(x.cpu().numpy()).hexdigest() for x in outs]


def _card_peaks() -> dict:
    """The peak bytes PyTorch's allocator held on each card this process
    sees, since the last ``_reset_card_peaks``."""
    return {f"cuda:{i}": torch.cuda.max_memory_allocated(i)
            for i in range(torch.cuda.device_count())}


def _reset_card_peaks() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)


def _sharded_step(rank, world, job, dev):
    """Phases 8 and 13's job on one rank: this rank's share of the first
    "n" rows of the .npy "rows", as ``mesh.sharded_cluster_step`` takes
    them; returns its numbers and the digests of consensus and coverage,
    and writes its slices of diffs, seg_id and order to "slices"."""
    rows = np.load(job["rows"], mmap_mode="r")
    b = [job["n"] * r // world for r in range(world + 1)]
    local = torch.from_numpy(np.ascontiguousarray(
        rows[b[rank]:b[rank + 1]])).to(dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    n0, stats = dict(cuda.launches), {}
    with _RssPeak() as rss:
        t0 = time.perf_counter()
        out = mesh.sharded_cluster_step(local, job["k"], job["span"], stats)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launched = {x: v - n0.get(x, 0) for x, v in cuda.launches.items()
                if v > n0.get(x, 0)}
    for i, x in enumerate(out[2:]):
        x.cpu().numpy().tofile(job["slices"].format(rank=rank, i=i + 2))
    return dict(rows=b[rank + 1] - b[rank], step_s=wall, stats=stats,
                launched=launched, peak_device_B=peak,
                device_over_rows_B=peak - base, peak_rss_B=rss.peak,
                digests=_digests(out[:2]))


def dist_worker(argv) -> int:
    """One rank of phases 6, 8 and 13: ``chip_smoke.py --dist-worker RANK
    WORLD STORE JOBS``. Joins a group through ``file://STORE`` as local
    rank RANK, on the card ``distributed.place`` gives it among those the
    process sees (CUDA_VISIBLE_DEVICES: one card in phases 6 and 8, which
    the ranks share over gloo; a card a rank in phase 13, NCCL between
    them), and runs the jobs of JOBS (a JSON list) on that card: a job with
    "fq" compresses (device "cuda", the rank's card), one with "arc"
    decompresses (after the compress when it has both), one with "rows"
    runs the sharded cluster step (``_sharded_step``). Prints one ``DIST
    {...}`` line per job: walls, stages, kernel launches, the seconds and
    bytes spent in the package's all-gathers, the card each summary names,
    the peak bytes the allocator held on each card it sees, and the peak
    RSS of the process after each step."""
    import datetime
    from minicom_tpu_torch.parallel import distributed
    rank, world, store, spec = int(argv[0]), int(argv[1]), argv[2], argv[3]
    distributed.initialize(f"file://{store}", world_size=world, rank=rank,
                           local_rank=rank,
                           timeout=datetime.timedelta(seconds=600))
    dev = distributed.rank_device()
    start_rss = _RssPeak.now()   # imports and the group, before any job
    coll = {}
    gather = distributed.allgather_ragged_many
    pkg = os.path.dirname(distributed.__file__)

    def timed_gather(arrays):
        if world == 1:   # a no-op: nothing is exchanged
            return gather(arrays)
        # the call site: the first frame outside parallel/
        f = sys._getframe(1)
        while os.path.dirname(f.f_code.co_filename) == pkg:
            f = f.f_back
        site = f"{os.path.basename(f.f_code.co_filename)}:{f.f_code.co_name}"
        t0 = time.perf_counter()
        out = gather(arrays)
        dt = time.perf_counter() - t0
        recv = sum(o.nbytes for o in out)
        coll["s"] = coll.get("s", 0.0) + dt
        coll["calls"] = coll.get("calls", 0) + 1
        coll["sent_B"] = coll.get("sent_B", 0) + sum(
            np.asarray(a).nbytes for a in arrays)
        coll["recv_B"] = coll.get("recv_B", 0) + recv
        calls, sec, nb = coll.setdefault("sites", {}).get(site, (0, 0.0, 0))
        coll["sites"][site] = (calls + 1, sec + dt, nb + recv)
        return out

    distributed.allgather_ragged_many = timed_gather
    fmt = lambda p: p and p.format(rank=rank)  # noqa: E731
    with open(spec) as f:
        jobs = json.load(f)
    os.environ["MTC_WRITE_ALL_RANKS"] = "0"
    for job in jobs:
        res = {"rank": rank, "world": world, "tag": job["tag"],
               "start_rss_B": start_rss, "card": str(dev),
               "nccl": distributed.nccl()}
        _reset_card_peaks()
        if job.get("fq"):
            cfg = CompressorConfig(threads=os.cpu_count() // world,
                                   **job["cfg"])
            coll.clear()
            st = _NamedStages()
            with _LaunchTimer() as lt, _RssPeak(st) as rss:
                t0 = time.perf_counter()
                summary = compressor.compress(
                    job["fq"], fmt(job["out"]), cfg,
                    reads_path2=job.get("fq2"), stats=st, device="cuda")
                res["encode_s"] = time.perf_counter() - t0
            res.update(encode_stages=summary["timings_s"],
                       encode_launches=lt.launched,
                       encode_kernel_s=lt.seconds(), encode_coll=dict(coll),
                       encode_peak_rss_B=rss.peak,
                       encode_stage_rss_B=rss.by_stage,
                       archive_bytes=summary["archive_bytes"],
                       encode_device=[summary["device"],
                                      summary["card_shared"]])
        if job.get("arc"):
            coll.clear()
            st = _NamedStages()
            with _LaunchTimer() as lt, _RssPeak(st) as rss:
                t0 = time.perf_counter()
                dsum = compressor.decompress(job["arc"], fmt(job["dec"]),
                                             fmt(job.get("dec2")), stats=st,
                                             device="cuda")
                res["decode_s"] = time.perf_counter() - t0
            res.update(decode_stages=dsum["timings_s"],
                       decode_launches=lt.launched, decode_coll=dict(coll),
                       decode_peak_rss_B=rss.peak,
                       decode_stage_rss_B=rss.by_stage,
                       decode_device=[dsum["device"], dsum["card_shared"]])
        if job.get("rows"):
            res.update(_sharded_step(rank, world, job, dev))
        res["cards_B"] = _card_peaks()
        print("DIST " + json.dumps(res), flush=True)
    distributed.shutdown()
    return 0


def _run_dist(tmp, tag, world, jobs, timeout, cards=1):
    """Start ``world`` workers of this script on ``jobs``, seeing the first
    ``cards`` cards of the machine (``distributed.place`` puts them there:
    all on cuda:0 with one card, rank r on cuda:r with a card each); a
    worker that fails, or a group that outlives ``timeout`` seconds, kills
    the group and fails the phase. Returns each job's results, one list per
    rank."""
    spec = os.path.join(tmp, f"{tag}.json")
    with open(spec, "w") as f:
        json.dump(jobs, f)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
               CUDA_VISIBLE_DEVICES=",".join(_card_ids()[:cards]))
    logs = [os.path.join(tmp, f"{tag}.{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-worker",
                 str(r), str(world), os.path.join(tmp, f"{tag}.pg"), spec],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        with open(log) as f:
            outs.append(f.read())
    if any(p.returncode != 0 for p in procs):
        for r, (p, out) in enumerate(zip(procs, outs)):
            print(f"group {tag} rank {r} exit {p.returncode}:\n{out[-3000:]}",
                  file=sys.stderr)
        raise AssertionError(f"group {tag} failed")
    return [[json.loads(line[5:]) for line in out.splitlines()
             if line.startswith("DIST ")] for out in outs]


def _card_ids() -> list[str]:
    """The ids of the cards this process sees, as CUDA_VISIBLE_DEVICES
    names them."""
    seen = os.environ.get("CUDA_VISIBLE_DEVICES")
    return (seen.split(",") if seen
            else [str(i) for i in range(torch.cuda.device_count())])


def _print_dist(res, phase=6):
    """The per-rank numbers of one job."""
    head = f"[{phase}] {res['tag']} rank {res['rank']}/{res['world']}"
    print(f"{head} on {res['card']} (NCCL between cards: {res['nccl']}); "
          "peak allocated B by card: " + json.dumps(res["cards_B"]))
    for step, wall in (("encode", "compress"), ("decode", "decompress")):
        if f"{step}_s" not in res:
            continue
        c = res[f"{step}_coll"]
        print(f"{head} {wall} on {res[f'{step}_device']} [device, shared]: "
              f"{res[f'{step}_s']:.2f} s; all-gathers "
              f"{c.get('calls', 0)} calls {c.get('s', 0.0):.3f} s, sent "
              f"{c.get('sent_B', 0)} B, received {c.get('recv_B', 0)} B; "
              f"peak RSS {res[f'{step}_peak_rss_B']} B ({res['start_rss_B']}"
              " B at the worker's start; None: /proc has no statm)")
        print(f"{head} {wall} stages s: " + json.dumps(res[f"{step}_stages"])
              + "; launches " + json.dumps(res[f"{step}_launches"])
              + "; peak RSS by stage B: "
              + json.dumps(res[f"{step}_stage_rss_B"]))
        sites = sorted(c.get("sites", {}).items(), key=lambda kv: -kv[1][1])
        if sites:
            print(f"{head} {wall} all-gathers by call site [calls, s, "
                  "received B], slowest first: "
                  + json.dumps(dict(sites[:8])))
    if "encode_kernel_s" in res:
        print(f"{head} compress kernel device s: "
              + json.dumps(res["encode_kernel_s"]))


def _group_job(tmp, name, tag, cfg=None, src=None, src2=None,
               decode=True):
    """A worker job under ``tmp/<name>_<tag>``: compress ``src`` (and its
    mate ``src2``) with the settings ``cfg`` where given, then decompress
    rank 0's archive where ``decode``."""
    base = os.path.join(tmp, f"{name}_{tag}")
    j = {"tag": tag, "cfg": cfg or {}}
    if src:
        j.update(fq=src, fq2=src2, out=base + "_{rank}.mtc")
    if decode:
        j.update(arc=base + "_0.mtc", dec=base + "_{rank}.reads",
                 dec2=base + "_{rank}.reads2" if src2 else None)
    return j


def _small_jobs(tmp, name, fq_small, m1, m2):
    """The 100k set with codec=device, ORDER and PE, compressed and
    decoded."""
    return [_group_job(tmp, name, "device", {"codec": "device"}, fq_small),
            _group_job(tmp, name, "order", {"order": True}, fq_small),
            _group_job(tmp, name, "pe", {}, m1, m2)]


def _small_checks(phase, tmp, name, small, fq_small, m1, m2, same):
    """``_small_jobs``' results in a group: each archive phase 3's cuda
    archive, the rANS encode and decode launched on some rank, each decode
    exact (line for line in ORDER, the pairs in PE)."""
    world = len(small)
    for i, (tag, key) in enumerate((("device", "codec=device"),
                                    ("order", "order, codec=auto"),
                                    ("pe", "PE, codec=auto"))):
        for r in range(world):
            _print_dist(small[r][i], phase)
        _same_archive(os.path.join(tmp, f"{name}_{tag}_0.mtc"), same[key],
                      f"100k {key}: {world} ranks and one")
        print(f"[{phase}] 100k {key}, {world} ranks: archive equals the "
              "one-process cuda archive")
    for stage, kernel in (("encode_launches", "mtc_rans_encode"),
                          ("decode_launches", "mtc_rans_decode")):
        if sum(small[r][0][stage].get(kernel, 0) for r in range(world)) < 1:
            raise AssertionError(f"codec=device: no rank launched {kernel}")
    _check_roundtrip(os.path.join(tmp, f"{name}_device_0.reads"),
                     sorted_rows(input_rows(fq_small)), N_SAME_BYTES)
    want = input_rows(fq_small)
    if not np.array_equal(decoded_rows(os.path.join(
            tmp, f"{name}_order_0.reads"), len(want), 100), want):
        raise AssertionError(f"{world}-rank ORDER decode is not line for "
                             "line")
    w1, w2 = input_rows(m1), input_rows(m2)
    got = np.concatenate([
        decoded_rows(os.path.join(tmp, f"{name}_pe_0.reads"), len(w1), 100),
        decoded_rows(os.path.join(tmp, f"{name}_pe_0.reads2"), len(w2),
                     100)], axis=1)
    if not np.array_equal(sorted_rows(got),
                          sorted_rows(np.concatenate([w1, w2], axis=1))):
        raise AssertionError(f"{world}-rank PE decode does not keep the "
                             "pairs")


def phase6_two_ranks(tmp, fq, arc, fq_small, m1, m2, same):
    """Two ranks of one gloo group on cuda:0 (the group sees one card):
    phase 2's 5M file (after one rank alone, for the walls and peak RSS of
    a fresh single process), each of compress and decompress in fresh
    processes; then the 100k set with codec=device, ORDER and PE."""
    t0 = time.perf_counter()
    walls = {}
    for world in (1, 2):
        t = time.perf_counter()
        enc = _run_dist(tmp, f"c{world}", world, [_group_job(
            tmp, f"d{world}", "5M", src=fq, decode=False)], 400)
        walls[f"{world}c"] = time.perf_counter() - t
        t = time.perf_counter()
        dec = _run_dist(tmp, f"d{world}", world,
                        [_group_job(tmp, f"d{world}", "5M")], 200)
        walls[f"{world}d"] = time.perf_counter() - t
        for r in range(world):
            _print_dist(enc[r][0])
            _print_dist(dec[r][0])
            _require(enc[r][0]["encode_launches"], MAIN_PATH,
                     f"5M compress on rank {r} of {world}")
            if enc[r][0]["encode_device"] != ["cuda:0", world > 1]:
                raise AssertionError(f"rank {r} of {world} compressed on "
                                     f"{enc[r][0]['encode_device']}")
        _same_archive(os.path.join(tmp, f"d{world}_5M_0.mtc"), arc,
                      f"5M: {world} rank(s) and phase 2")
        if not filecmp.cmp(os.path.join(tmp, f"d{world}_5M_0.reads"),
                           os.path.join(tmp, "e2e.reads"), shallow=False):
            raise AssertionError(f"5M: the {world}-rank decode differs from "
                                 "phase 2's")
    for f in ("d2_5M_1.mtc", "d2_5M_1.reads"):
        if os.path.exists(os.path.join(tmp, f)):
            raise AssertionError(f"rank 1 wrote {f}")
    print(f"[6] 5M, 1 and 2 ranks: rank 0's archive equals phase 2's "
          f"({os.path.getsize(arc)} B), its decode equals phase 2's byte for "
          "byte, rank 1 wrote neither; group walls s (worker start "
          "included): " + json.dumps(walls))

    small = _run_dist(tmp, "small", 2, _small_jobs(tmp, "d2", fq_small, m1,
                                                   m2), 300)
    _small_checks(6, tmp, "d2", small, fq_small, m1, m2, same)
    print(f"[6] 100k, 2 ranks: device, ORDER and PE decodes exact; phase 6 "
          f"took {time.perf_counter() - t0:.1f} s")


STEP_KERNELS = ("mtc_step_keys", "mtc_step_segments", "mtc_step_vote")
STEP_SEG_READS = 1 << 20   # the reads held exactly against the plain step


def _step_keys_host(store, words, k):
    """The step's sort keys from ``sketch_reads_flat``'s words, on the host:
    hi << 32 | lo, or the k-mer at start 0 where no k-mer was chosen."""
    key = words[0].astype(np.int64) << 32 | words[1]
    none = np.flatnonzero(words[2] == 0)
    if len(none):
        f = np.zeros(len(none), np.int64)
        r = np.zeros(len(none), np.int64)
        for t in range(k):
            c = store[none, t].astype(np.int64)
            f = f << 2 | c
            r |= (c ^ 3) << (2 * t)
        key[none] = np.minimum(f, r)
    return key, len(none)


def _step_pieces(c, k):
    """Kernel (c) on an arange of c's rows, then the step's keys and
    segments kernels, each against its plain version on the same inputs;
    returns the intermediates and the max |diff| (0)."""
    N = c.shape[0]
    rids = torch.arange(N, dtype=torch.int32, device=c.device)
    sk = sketch.sketch_reads_device(c, rids, k)
    key, mz = step._keys(c, sk, k)
    err = 0
    for name, g, w in zip(("key", "mz"), (key, mz),
                          step._keys_plain(c, sk, k)):
        err = max(err, _equal(f"step keys {name} vs plain", g.cpu(),
                              w.cpu()))
    skey, order = torch.sort(key, stable=True)
    seg = step._segments(skey, order, mz)
    want = step._segments_plain(skey, order, mz)
    nseg = len(want[3]) - 1
    if int(seg[3][N + 1]) != nseg:
        raise AssertionError("step segments: segment count")
    for name, g, w in zip(("order", "smz", "seg_id", "first", "seg_max"),
                          seg, want):
        err = max(err, _equal(f"step segments {name} vs plain",
                              g[:len(w)].cpu(), w.cpu()))
    return dict(rids=rids, sk=sk, key=key, mz=mz, skey=skey, order=order,
                seg=seg, seg_plain=want, nseg=nseg), err


def _step_exact(tag, c, k, span):
    """cluster_step on the card (one launch of each of its four kernels)
    equal to _cluster_step_plain, all five outputs; each piece equal to its
    plain version. Returns the pieces and the max |diff| (0)."""
    n0 = dict(cuda.launches)
    got = step.cluster_step(c, k, span)
    made = {x: cuda.launches[x] - n0.get(x, 0)
            for x in ("mtc_sketch_reads",) + STEP_KERNELS}
    if set(made.values()) != {1}:
        raise AssertionError(f"{tag}: launches {made}, want one each")
    want = step._cluster_step_plain(c, k, span)
    err = 0
    for name, g, w in zip(("consensus", "coverage", "diffs", "seg_id",
                           "order"), got, want):
        err = max(err, _equal(f"{tag} {name} vs plain", g.cpu(), w.cpu()))
    pieces, e = _step_pieces(c, k)
    vote = step._vote(c, *pieces["seg"], span)
    ref = step._vote_plain(c, *pieces["seg_plain"][:3],
                           pieces["seg_plain"][4], span)
    for name, g, w in zip(("consensus", "coverage", "diffs"), vote, ref):
        err = max(err, _equal(f"{tag} vote {name} vs plain", g.cpu(),
                              w.cpu()))
    return pieces, max(err, e)


def _step_work(N, L, k, span, nseg, rebuilt) -> dict:
    """(bytes, integer operations) of each kernel's function and of the
    whole step (``OPS``): each input read once, each output written once."""
    seg_out = 4 * (3 * N + 2 * nseg + 2)
    return {
        "mtc_step_keys": (24 * N + rebuilt * k, N * OPS["step_key"]
                          + rebuilt * k * OPS["step_rebuild_base"]),
        "mtc_step_segments": (20 * N + seg_out, N * OPS["segment_item"]),
        "mtc_step_vote": (N * (L + 16) + 8 * nseg + 5 * span,
                          N * L * OPS["vote_base"]
                          + span * OPS["step_column"]),
        "step": (N * L + 5 * span + 12 * N,
                 N * (L - k + 1) * kmer_min_ops(k)
                 + N * (OPS["step_key"] + OPS["segment_item"])
                 + N * L * OPS["vote_base"] + span * OPS["step_column"]),
    }


def _step_bounds(N, L, k, span, nseg, rebuilt):
    """``_bound`` of each piece of ``_step_work``."""
    return {name: _bound(*w) for name, w in
            _step_work(N, L, k, span, nseg, rebuilt).items()}


def _vote_ms(c, seg, span):
    """mtc_step_vote on the segments ``seg`` of c, from CUDA graphs."""
    N, L = c.shape
    outs = (torch.empty(span, dtype=torch.uint8, device=c.device),
            torch.empty(span, dtype=torch.int32, device=c.device),
            torch.empty(N, dtype=torch.int32, device=c.device))
    return _graph_ms(lambda: cuda.launch("mtc_step_vote", c, L, *seg, N,
                                         step.tile_slots(L), span, *outs))


def _step_store(fq) -> np.ndarray:
    """The read store of ``fq`` as the pipeline uploads it: its codes, N
    substituted by classify."""
    codes = fastq.read_fastq_codes(fq)
    return classify.classify(codes, CompressorConfig().resolve(
        codes.shape[1])).codes_sub


def phase7_cluster_step(dev, fq, report):
    """The fused cluster step on the phase-2 read store (N substituted by
    classify), k = 31: exact against the plain version on its first 2^20
    reads (span N 2L), then on 2,048 rows of (AT)^50 and 2,048 copies of
    one read at k = 30; then all 5,000,000 reads (span_cols 10^9) on the
    kernel path alone: order equal to numpy's stable argsort of the keys
    from sketch_reads_flat, coverage summing to N L, every diff <= L, one
    launch of each kernel. Times: CUDA events, medians of 10 (the step and
    the sort), the kernels from CUDA graphs of 20 launches (medians of 10
    replays). Returns the 5M call's launches of the three step kernels and
    the read store."""
    t_start = time.perf_counter()
    store = _step_store(fq)
    c_all = torch.from_numpy(store).to(dev)
    N, L = c_all.shape
    k = 31

    n = min(STEP_SEG_READS, N)
    c = c_all[:n]
    span_n = n * 2 * L
    pieces, err = _step_exact(f"step {n} x {L}", c, k, span_n)
    rng = np.random.default_rng(30)
    odd = np.empty((4096, L), np.uint8)
    odd[:2048] = np.resize(np.array([0, 3], np.uint8), L)
    odd[2048:] = store[int(rng.integers(0, N))]
    odd = torch.from_numpy(odd).to(dev)
    deep, e = _step_exact("step (AT)^50 and copies, k=30", odd, 30,
                          4096 * 2 * L)
    err = max(err, e)
    # the vote's cost of two segments of 2,048 members against 4,096 reads
    # of the store in their own segments
    few, _ = _step_pieces(c[:4096], 30)
    deep_ms = {"two segments of 2048": _vote_ms(odd, deep["seg"],
                                                4096 * 2 * L),
               f"{few['nseg']} segments": _vote_ms(c[:4096], few["seg"],
                                                   4096 * 2 * L)}
    del deep, few, odd
    seg = pieces["seg"]
    scratch = torch.empty(step.seg_scratch_words(n), dtype=torch.int32,
                          device=dev)
    small = dict(
        step=_ms(lambda: step.cluster_step(c, k, span_n), 10),
        plain=_ms(lambda: step._cluster_step_plain(c, k, span_n), 3),
        mtc_step_keys=_graph_ms(lambda: cuda.launch(
            "mtc_step_keys", c, L, pieces["sk"], n, k, pieces["key"],
            pieces["mz"])),
        mtc_step_segments=_graph_ms(lambda: cuda.launch(
            "mtc_step_segments", pieces["skey"], pieces["order"],
            pieces["mz"], n, scratch, *seg)),
        mtc_step_vote=_vote_ms(c, seg, span_n),
        plain_mtc_step_keys=_ms(lambda: step._keys_plain(c, pieces["sk"],
                                                         k), 5),
        plain_mtc_step_segments=_ms(lambda: step._segments_plain(
            pieces["skey"], pieces["order"], pieces["mz"]), 5),
        plain_mtc_step_vote=_ms(lambda: step._vote_plain(
            c, *pieces["seg_plain"][:3], pieces["seg_plain"][4], span_n),
            3))
    del pieces, seg, scratch
    print(f"[7] cluster_step {n} x {L}, k={k}, span {span_n}: equal to the "
          "plain step, all five outputs, and each kernel to its plain "
          f"version; (AT)^50 and copies at k=30 equal too; ms "
          f"{json.dumps(small)}; the vote at 4096 x {L}, k=30, ms "
          f"{json.dumps(deep_ms)}")

    # all the reads, on the kernel path alone
    span = N * 2 * L
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    with _LaunchTimer() as lt:
        cons, cov, diffs, seg_id, order = step.cluster_step(c_all, k, span)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    made = {x: lt.launched.get(x, 0)
            for x in ("mtc_sketch_reads",) + STEP_KERNELS}
    if set(made.values()) != {1}:
        raise AssertionError(f"5M cluster_step launches {made}, want one "
                             "each")
    words = sketch.sketch_reads_flat(c_all, np.arange(N), k)
    key, rebuilt = _step_keys_host(store, words, k)
    _equal("5M order vs numpy's stable argsort", order.cpu(),
           np.argsort(key, kind="stable"))
    if int(cov.sum()) != N * L:
        raise AssertionError("5M coverage does not sum to N L")
    if int(diffs.max()) > L or int(diffs.min()) < 0:
        raise AssertionError("5M diffs outside [0, L]")
    nseg = int(seg_id[-1]) + 1
    del cons, cov, diffs, seg_id, order

    # the 5M call's pieces and their plain versions (the vote's plain
    # version needs the whole [span, 4] count table: 2^20 reads above)
    pieces, e = _step_pieces(c_all, k)
    err = max(err, e)
    seg = pieces["seg"]
    scratch = torch.empty(step.seg_scratch_words(N), dtype=torch.int32,
                          device=dev)
    full = dict(
        step=_ms(lambda: step.cluster_step(c_all, k, span), 10),
        mtc_sketch_reads=_graph_ms(lambda: cuda.launch(
            "mtc_sketch_reads", c_all, L, pieces["rids"], N, k,
            pieces["sk"])),
        mtc_step_keys=_graph_ms(lambda: cuda.launch(
            "mtc_step_keys", c_all, L, pieces["sk"], N, k, pieces["key"],
            pieces["mz"])),
        sort=_ms(lambda: torch.sort(pieces["key"], stable=True), 10),
        mtc_step_segments=_graph_ms(lambda: cuda.launch(
            "mtc_step_segments", pieces["skey"], pieces["order"],
            pieces["mz"], N, scratch, *seg)),
        mtc_step_vote=_vote_ms(c_all, seg, span),
        plain_mtc_step_keys=_ms(lambda: step._keys_plain(
            c_all, pieces["sk"], k), 5),
        plain_mtc_step_segments=_ms(lambda: step._segments_plain(
            pieces["skey"], pieces["order"], pieces["mz"]), 5))
    bounds = _step_bounds(N, L, k, span, nseg, rebuilt)
    sizes = np.diff(seg[3][:nseg + 1].cpu().numpy())
    print(f"[7] cluster_step {N} x {L}, k={k}, span {span}: order equals "
          f"numpy's stable argsort of sketch_reads_flat's keys ({rebuilt} "
          f"reads without a chosen k-mer), coverage sums to N L, diffs in "
          f"[0, {L}]; {nseg} segments (largest {int(sizes.max())} "
          "members), "
          f"one launch each {json.dumps(made)}; device s "
          f"{json.dumps(lt.seconds())}; peak device memory {peak} B "
          f"({peak - base_mem} B over the store); ms {json.dumps(full)}; "
          f"bound of the step {json.dumps(bounds['step'])}; keys and "
          "segments equal to their plain versions at 5M")
    for name in STEP_KERNELS:
        report[name] = dict(
            name=f"cluster_step {name[9:]}", route="cuda",
            source="minicom_tpu_torch/csrc/step.cu",
            replaces="minicom_tpu/ops/step.py:28", max_abs_err=err,
            ms=full[name], reads=N, ms_at_2p20=small[name],
            plain_ms=full.get("plain_" + name, small["plain_" + name]),
            plain_reads=N if "plain_" + name in full else n,
            **bounds[name])
    del pieces, seg, scratch, c_all
    torch.cuda.empty_cache()
    print(f"[7] phase 7 took {time.perf_counter() - t_start:.1f} s")
    return {x: made[x] for x in STEP_KERNELS}, store


MESH_SPAN = 10 ** 9   # phase 8's columns at all the reads, as phase 7's


def _deep_rows(store, rng, k):
    """4,096 rows of the store, 2,048 of them copies of the one whose key
    sorts last (found by the plain minimizer on the host): its segment of
    2,049 members runs from sorted position 2,047 to the end, across both
    ranks, and rank 1 owns no segment."""
    rows = store[np.sort(rng.choice(len(store), 4096, replace=False))]
    top = int(step._minimizers_plain(torch.from_numpy(rows), k)[0].argmax())
    rows[[0, top]] = rows[[top, 0]]
    rows[1 + rng.permutation(4095)[:2048]] = rows[0]
    return rows


def _rank_bound(N, L, k, nseg, owned) -> dict:
    """The least time of one rank's device work in the sharded step, each
    piece's bound (``_bound``) added: kernel (c) and the keys on its rows,
    the sort of all N keys (8 bytes in, 16 out a key), the segments of all
    N, the vote of the members and columns it owns."""
    n, m, cols = owned["rows"], owned["members"], owned["columns"]
    pieces = {
        "keys": _bound(n * (L + 16), n * (L - k + 1) * kmer_min_ops(k)),
        "keys_words": _bound(24 * n, n * OPS["step_key"]),
        "sort": _bound(24 * N, 0),
        "segments": _bound(20 * N + 4 * (3 * N + 2 * nseg + 2),
                           N * OPS["segment_item"]),
        "vote": _bound(m * (L + 16) + 8 * owned["segments"] + 5 * cols,
                       m * L * OPS["vote_base"] + cols * OPS["step_column"])
        if owned["voted"] else _bound(0, 0)}
    return {"bound_ms": sum(b["bound_ms"] for b in pieces.values()),
            **{name: b["bound_ms"] for name, b in pieces.items()}}


def _print_sharded(phase, tag, r, got, bound):
    st = got["stats"]
    coll = {k: [round(v["s"], 4), v["sent_B"], v["recv_B"], v["host_B"]]
            for k, v in st["collectives"].items()}
    print(f"[{phase}] {tag} rank {r}/{got['world']} on {got['card']} "
          f"({got['rows']} rows; exchanges over {st['backend']}): step "
          f"{got['step_s']:.3f} s (wall in the step {st['wall_s']:.3f}); "
          f"device ms {json.dumps(st['device_ms'])}; collectives [s, sent "
          f"B, received B, B through the host] {json.dumps(coll)}; "
          f"host-device copies {json.dumps(st['copies'])}; owned "
          f"{json.dumps(st['owned'])}; launches "
          f"{json.dumps(got['launched'])}; peak device memory "
          f"{got['peak_device_B']} B ({got['device_over_rows_B']} B over "
          f"the rows); peak RSS {got['peak_rss_B']} B ({got['start_rss_B']} "
          f"B at the worker's start); device ms in all "
          f"{sum(st['device_ms'].values()):.4f}, bound of that work "
          f"{json.dumps(bound)}")


DEEP_ROWS, DEEP_MEMBERS = 4096, 2049   # _deep_rows: its last segment


def _step_refs(dev, tmp, store):
    """Phases 8 and 13's cases of the sharded step on the phase-2 read
    store, saved where the workers load them: (i) its first 2^20 reads,
    span_cols N 2L; (ii) ``_deep_rows`` at k = 30; (iii) all its reads,
    span_cols 10^9; each with the SHA-256 digests of the one-card
    ``cluster_step``'s five outputs on the same rows. Returns (cases, the
    digests, seconds)."""
    t0 = time.perf_counter()
    N, L = store.shape
    paths = {"store": os.path.join(tmp, "step_store.npy"),
             "deep": os.path.join(tmp, "step_deep.npy")}
    deep = _deep_rows(store, np.random.default_rng(31), 30)
    np.save(paths["store"], store)
    np.save(paths["deep"], deep)
    n = min(STEP_SEG_READS, N)
    cases = [(f"(i) {n} x {L}, k=31, span {n * 2 * L}", "store", n, 31,
              n * 2 * L),
             (f"(ii) {DEEP_ROWS} x {L}, {DEEP_MEMBERS} one read, k=30",
              "deep", DEEP_ROWS, 30, DEEP_ROWS * 2 * L),
             (f"(iii) {N} x {L}, k=31, span {MESH_SPAN}", "store", N, 31,
              MESH_SPAN)]
    want = []
    for _, rows, m, k, span in cases:
        c = torch.from_numpy((deep if rows == "deep" else store)[:m]).to(dev)
        want.append(_digests(step.cluster_step(c, k, span)))
        del c
    torch.cuda.empty_cache()
    return ([dict(tag=tag, rows=paths[rows], n=m, k=k, span=span, L=L)
             for tag, rows, m, k, span in cases], want,
            time.perf_counter() - t0)


def _sharded_groups(phase, tmp, cases, want, world, cards, timeout):
    """The cases of ``_step_refs`` in ``world`` ranks that see ``cards``
    cards, each with its share of the rows. The rank-order concatenation of
    the ranks' outputs (consensus and coverage whole on each) must equal
    the one-card step's, by SHA-256 digest; each rank must launch kernel
    (c), the keys and segments kernels once each, and the vote once where
    it owns a segment with columns below span_cols, else not at all; a
    rank whose rows all lie inside the deep case's last segment owns none,
    and each rank votes in the store's cases. Returns each case's results,
    one list per rank."""
    slices = os.path.join(
        tmp, f"step{phase}_{{case}}_{{{{rank}}}}_{{{{i}}}}.bin")
    res = _run_dist(tmp, f"step{phase}", world, [
        dict(c, slices=slices.format(case=j)) for j, c in enumerate(cases)],
        timeout, cards)
    for j, case in enumerate(cases):
        tag, m, L = case["tag"], case["n"], case["L"]
        nseg = sum(res[r][j]["stats"]["owned"]["segments"]
                   for r in range(world))
        for r in range(world):
            got = res[r][j]
            _print_sharded(phase, tag, r, got, _rank_bound(
                m, L, case["k"], nseg, got["stats"]["owned"]))
            if got["digests"] != want[j][:2]:
                raise AssertionError(f"{tag}: rank {r}'s consensus or "
                                     "coverage differs from one card's")
            owned = got["stats"]["owned"]
            made = {x: 1 for x in ("mtc_sketch_reads", "mtc_step_keys",
                                   "mtc_step_segments")}
            if owned["voted"]:
                made["mtc_step_vote"] = 1
            if got["launched"] != made:
                raise AssertionError(f"{tag}: rank {r} launched "
                                     f"{got['launched']}, want {made}")
        first = [m * r // world for r in range(world)]
        if case["rows"].endswith("step_deep.npy"):
            inside = [first[r] > DEEP_ROWS - DEEP_MEMBERS
                      for r in range(world)]
            if [not res[r][j]["stats"]["owned"]["segments"]
                    for r in range(world)] != inside:
                raise AssertionError(f"{tag}: the ranks inside the last "
                                     "segment are not those that own none")
        elif not all(res[r][j]["stats"]["owned"]["voted"]
                     for r in range(world)):
            raise AssertionError(f"{tag}: a rank voted nothing")
        for i, name in ((2, "diffs"), (3, "seg_id"), (4, "order")):
            h = hashlib.sha256()
            for r in range(world):
                with open(slices.format(case=j).format(rank=r, i=i),
                          "rb") as f:
                    h.update(f.read())
            if h.hexdigest() != want[j][i]:
                raise AssertionError(f"{tag}: the ranks' {name} differ "
                                     "from one card's")
        print(f"[{phase}] {tag}: the {world} ranks' consensus and coverage, "
              "and their diffs, seg_id and order in rank order, equal the "
              "one-card step's (SHA-256)")
    return res


def phase8_sharded_step(dev, tmp, store):
    """The sharded cluster step (``parallel/mesh.py``) in two ranks of one
    gloo group on cuda:0, each with half the rows, on the cases of
    ``_step_refs``, held by ``_sharded_groups``. Returns the cases and the
    one-card digests, which phase 13 reuses."""
    t_start = time.perf_counter()
    cases, want, t_ref = _step_refs(dev, tmp, store)
    _sharded_groups(8, tmp, cases, want, 2, 1, 400)
    print(f"[8] phase 8 took {time.perf_counter() - t_start:.1f} s (the "
          f"one-card references {t_ref:.1f} s)")
    return cases, want


def phase13_cards(tmp, fq, arc, fq_small, m1, m2, same, cases, want):
    """A card a rank, on every card the machine has, up to 4 (P), where it
    has 2 or more; otherwise it says on one line why it did not run. Each
    rank's group joins with P cards in view, so ``distributed.place`` puts
    rank r on cuda:r and the group carries CUDA tensors over NCCL. (i) The
    pipeline: phase 2's 5M file compressed and decompressed by P ranks:
    rank 0's archive must equal phase 2's (the default cell's pin) and its
    decode phase 2's decoded file, byte for byte; each rank must launch the
    read minimizer, the vote and the contig sketch, name cuda:r in its
    summaries, and hold device memory on its own card and on no other.
    Then the 100k set with codec=device, ORDER and PE: each archive must
    equal phase 3's, each decode exact, every rank on its own card. (ii)
    The sharded cluster step over NCCL on P cards, the cases of phase 8
    (``_sharded_groups``), the digests phase 7's one-card step's: each
    rank's exchanges must report NCCL and move no byte through the host.
    Prints per rank the walls, the step's device ms per piece and the
    seconds and bytes per collective."""
    count = torch.cuda.device_count()
    if count < 2:
        print(f"[13] phase 13 did not run: a card a rank needs 2 or more "
              f"cards, this machine has {count}")
        return
    t0 = time.perf_counter()
    world = min(4, count)
    name = f"k{world}"
    print(f"[13] {world} of {count} cards, rank r on cuda:r:\n{_smi(True)}")

    def held(res, where, uses=True):
        """Each rank on its own card, and nowhere else: its summaries name
        it (a decompress of host codecs names the host), it allocated on
        no other card, and on its own where the job ``uses`` the card."""
        for r, got in enumerate(res):
            card = f"cuda:{r}"
            if got["card"] != card or not got["nccl"]:
                raise AssertionError(f"{where}: rank {r} on {got['card']}, "
                                     f"NCCL {got['nccl']}, want {card}")
            named = {step: got[f"{step}_device"] for step in ("encode",
                                                              "decode")
                     if f"{step}_device" in got}
            if (named.get("encode", [card, False]) != [card, False]
                    or named.get("decode", [card, False]) not in (
                        [card, False], ["cpu", False])):
                raise AssertionError(f"{where}: rank {r}'s summaries name "
                                     f"{named}")
            mine = got["cards_B"].pop(card)
            if any(got["cards_B"].values()) or (uses and not mine):
                raise AssertionError(f"{where}: rank {r} allocated {mine} B "
                                     f"on {card}, by other card "
                                     f"{got['cards_B']}")
            got["cards_B"][card] = mine

    t = time.perf_counter()
    enc = _run_dist(tmp, "cards_c", world, [_group_job(
        tmp, name, "5M", src=fq, decode=False)], 600, world)
    walls = {"compress": time.perf_counter() - t}
    t = time.perf_counter()
    dec = _run_dist(tmp, "cards_d", world, [_group_job(tmp, name, "5M")],
                    300, world)
    walls["decompress"] = time.perf_counter() - t
    for r in range(world):
        _print_dist(enc[r][0], 13)
        _print_dist(dec[r][0], 13)
        _require(enc[r][0]["encode_launches"], MAIN_PATH,
                 f"5M compress on cuda:{r} of {world}")
    held([x[0] for x in enc], "5M compress")
    held([x[0] for x in dec], "5M decompress", uses=False)
    base = os.path.join(tmp, f"{name}_5M")
    _same_archive(base + "_0.mtc", arc, f"5M: {world} cards and phase 2")
    if not filecmp.cmp(base + "_0.reads", os.path.join(tmp, "e2e.reads"),
                       shallow=False):
        raise AssertionError(f"5M: the {world}-card decode differs from "
                             "phase 2's")
    print(f"[13] (i) 5M on {world} cards: rank 0's archive equals phase 2's "
          f"({os.path.getsize(arc)} B, the default cell's pin), its decode "
          "phase 2's byte for byte; rank r ran on cuda:r and allocated on "
          "no other card; group walls s (worker start included): "
          + json.dumps(walls))
    small = _run_dist(tmp, "cards_small", world,
                      _small_jobs(tmp, name, fq_small, m1, m2), 400, world)
    _small_checks(13, tmp, name, small, fq_small, m1, m2, same)
    for i in range(3):
        held([x[i] for x in small], "100k " + small[0][i]["tag"])
    print(f"[13] (i) 100k codec=device, ORDER and PE on {world} cards: "
          "archives equal phase 3's, decodes exact, rank r on cuda:r")

    res = _sharded_groups(13, tmp, cases, want, world, world, 600)
    for j, case in enumerate(cases):
        for r in range(world):
            st = res[r][j]["stats"]
            moved = {c: v["host_B"] for c, v in st["collectives"].items()}
            if st["backend"] != "nccl" or any(moved.values()):
                raise AssertionError(
                    f"{case['tag']}: rank {r}'s exchanges over "
                    f"{st['backend']}, bytes through the host {moved}")
        held([x[j] for x in res], case["tag"])
    print(f"[13] (ii) the sharded step on {world} cards: every exchange "
          f"over NCCL, no byte through the host; phase 13 took "
          f"{time.perf_counter() - t0:.1f} s")


# phase 3's cuda archive that a 100k cell of the default profile must write,
# by the cell's (order, paired, codec)
PHASE3_ARCHIVE = {(False, False, "auto"): "codec=auto",
                  (False, False, "device"): "codec=device",
                  (True, False, "auto"): "order, codec=auto",
                  (False, True, "auto"): "PE, codec=auto"}


def _mode_decode(dev, name, workdir, paired):
    """One more decompress of a 100k order or PE cell's archive (phase 3's):
    the decoded lines must equal the input's in input order, byte for byte
    (order), or the multiset of (line i of file 1, line i of file 2) pairs
    must equal the input's (PE)."""
    fq = os.path.join(workdir, bench_torch.FASTQ)
    fqs = [f"{fq}.1", f"{fq}.2"] if paired else [fq]
    outs = [os.path.join(workdir, f"mode_{i}.reads") for i in (1, 2)]
    t0 = time.perf_counter()
    compressor.decompress(os.path.join(workdir, bench_torch.ARCHIVE), *outs,
                          device=dev)
    wall = time.perf_counter() - t0
    want = np.concatenate([input_rows(f) for f in fqs], axis=1)
    got = np.concatenate([decoded_rows(o, len(want), 100)
                          for o in outs[:len(fqs)]], axis=1)
    if paired:
        if not np.array_equal(sorted_rows(got), sorted_rows(want)):
            raise AssertionError(f"[9] {name}: paired-end roundtrip does not "
                                 "keep the pairs")
        what = f"{len(want)} pairs decoded, the multiset of pairs exact"
    else:
        if not np.array_equal(got, want):
            raise AssertionError(f"[9] {name}: order-preserving roundtrip "
                                 "is not line for line")
        what = (f"{len(want)} lines decoded in input order, byte for "
                "byte")
    print(f"[9] {name}: {what} ({wall:.2f} s); streams {{name: [codec, raw "
          "B, coded B]}: " + json.dumps(
              {e["name"]: [e["codec"], e["rlen"], e["clen"]] for e in
               container.read_header(os.path.join(
                   workdir, bench_torch.ARCHIVE))["streams"]}))


def phase9_bench(dev, tmp, same):
    """Each cell of the benchmark cut to 100,000 reads and one repeat; the
    launches are counted from 0 around each cell. ``same``: phase 3's cuda
    archives by tag."""
    with open(bench_torch.BENCHMARK) as f:
        cells = json.load(f)["workloads"]
    for cell in cells:
        name = cell["name"]
        workdir = os.path.join(tmp, f"bench_{name}")
        os.makedirs(workdir)
        cuda.launches.clear()
        r = bench_torch.run_cell(name, workdir, reads=N_SAME_BYTES,
                                 repeats=1, device=dev)
        launched = dict(cuda.launches)
        if not r["correct"]:
            raise AssertionError(
                f"[9] {name}: not correct: errors {r['run_errors']}, "
                f"archives identical {r['archives_identical']}")
        _require(launched, cell["kernels"], f"the bench's cell {name}")
        _require(r["launches"], cell["kernels"],
                 f"the bench's timed compress ({name})")
        _require(r["decode_launches"], cell["decode_kernels"],
                 f"the bench's timed decompress ({name})")
        if r["trace_span_faults"]:
            raise AssertionError(f"[9] {name}: the traced run's spans: "
                                 + "; ".join(r["trace_span_faults"]))
        st = r["settings"]
        tag = PHASE3_ARCHIVE.get((st["order"], st["paired"], st["codec"]))
        held = "held to no phase-3 archive"
        arc = os.path.join(workdir, bench_torch.ARCHIVE)
        if r["profile"] == "default" and tag is not None:
            _same_archive(arc, same[tag], f"the bench's cell {name} at 100k "
                          f"and phase 3's {tag}")
            held = f"equal to phase 3's {tag} archive"
        if not r["roundtrip_exact"]:
            raise AssertionError(f"[9] {name}: roundtrip not exact")
        for what, sums, wall in (
                ("encode", r["stage_s"], r["encode_s"]),
                ("decode", r["decode_stage_s"], r["decode_s"])):
            _device_by_stage(f"9 {name}", what, dict(
                {f"device_{s}_{u}": r[f"device_{s}_{u}"] for s in sums
                 for u in ("s", "bytes")}, timings_s=sums), wall)
        if st["order"] or st["paired"]:
            _mode_decode(dev, name, workdir, st["paired"])
        print(f"[9] bench {name}, {r['n_reads']} x {r['read_length']} bp: "
              f"correct; encode {r['encode_MBps']:.3f} MB/s, decode "
              f"{r['decode_MBps']:.3f} MB/s, archive {r['archive_bytes']} B "
              f"({r['archive_bits_per_base']:.6f} bit/base, {held}), "
              f"launches {json.dumps(r['launches'])}, decode launches "
              f"{json.dumps(r['decode_launches'])}, peak device memory "
              f"{r['peak_device_bytes']} B; device blocked "
              f"{r['device_blocked_s']:.4f} s for "
              f"{r['device_transfer_bytes']} B; traced busy share "
              f"{r['device_busy_share']:.6f} of {r['trace_span_s']:.3f} s")
        print("[9] stages s: " + json.dumps(r["stage_s"]))
        print(f"[9] traced: {r['trace_span_entries']} spans "
              f"({r['span_overhead_share']:.6f} of the encode wall at "
              f"{r['span_cost_s'] * 1e6:.3f} us a span untraced); busy share "
              "by stage " + json.dumps(
                  {k: round(v, 6) for k, v in
                   r["trace_stage_busy_share"].items()
                   if k in r["stage_s"]}))


def _smi(every=False) -> str:
    """The card's name and power limit, as nvidia-smi gives them (every
    card's, one a line, with ``every``)."""
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.splitlines()
    return "\n".join(lines) if every else lines[0]


def phase0_device():
    """cuda:0 with its name and power limit printed and the kernels and the
    host library built; None where there is no CUDA device."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return None
    dev = torch.device("cuda", 0)
    print(_smi())
    t0 = time.perf_counter()
    cuda.lib()
    t1 = time.perf_counter()
    native._load()
    print(f"[0] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; kernels built in {t1 - t0:.1f} s, "
          f"host library ({len(native._SRCS)} sources in "
          f"{os.path.relpath(native._SRC_DIR, ROOT)}/) in "
          f"{time.perf_counter() - t1:.1f} s")
    return dev


def phase10_codecs_table(tmp, arc):
    """``tools/codecs_table_torch.py``'s main on ``arc`` with its on-device
    codecs on the card, the launches counted from 0 around it: every device
    trial decodes back (the tool exits otherwise) and launches the rANS
    encode, and the run launches the encode and the decode."""
    spec = importlib.util.spec_from_file_location(
        "codecs_table_torch", os.path.join(ROOT, "tools",
                                           "codecs_table_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = os.path.join(tmp, "codecs_table.json")
    t0 = time.perf_counter()
    cuda.launches.clear()
    rc = tool.main([arc, out, "--device", "cuda"])
    launched = dict(cuda.launches)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"[10] the codec table exited {rc}")
    _require(launched, ("mtc_rans_encode", "mtc_rans_decode"),
             "the codec table")
    with open(out) as f:
        result = json.load(f)
    trials = {f"{name}:{k[:-len('_launches')]}": v
              for name, row in result["streams"].items()
              for k, v in row.items() if k.endswith("_launches")}
    if not trials or min(trials.values()) < 1:
        raise AssertionError(f"[10] a device trial launched no encode: "
                             f"{trials}")
    setup = result["setup_launches"].get("mtc_rans_encode", 0)
    if sum(trials.values()) + setup != launched["mtc_rans_encode"]:
        raise AssertionError(f"[10] the rows count {sum(trials.values())} "
                             f"encode launches and the set-up {setup}, the "
                             f"run {launched['mtc_rans_encode']}")
    print(f"[10] codec table of {os.path.basename(arc)} "
          f"({os.path.getsize(arc)} B): "
          f"{len(trials)} device trials decoded exactly; launches "
          f"{json.dumps(launched)}; " + json.dumps(
              {k: v for k, v in result.items()
               if k not in ("streams", "what")}))
    print(f"[10] phase 10 took {wall:.1f} s")


# each kernel's row in tools/kernel_bench_torch.py
BENCH_ROWS = {"mtc_sketch_reads": "sketch_reads_cuda",
              "mtc_sketch_windowed": "sketch_windowed_cuda",
              "mtc_consensus_vote": "consensus_vote_cuda",
              "mtc_rans_encode": "rans_encode_cuda",
              "mtc_rans_decode": "rans_decode_cuda",
              "mtc_popcount_verify": "popcount_verify_cuda",
              "mtc_step_keys": "cluster_step_keys_cuda",
              "mtc_step_segments": "cluster_step_segments_cuda",
              "mtc_step_vote": "cluster_step_vote_cuda"}


def phase11_kernel_bench(tmp) -> dict:
    """``tools/kernel_bench_torch.py``'s main at scale 1 on the card, the
    launches counted from 0 around it (the tool itself raises unless every
    timed call launched its kernels once each). Fails on a missing row, an
    entry that did not launch each of its kernels once, a share_cold over
    1.05 or an ms_cold under 0.95 ms_warm. Returns the rows."""
    spec = importlib.util.spec_from_file_location(
        "kernel_bench_torch", os.path.join(ROOT, "tools",
                                           "kernel_bench_torch.py"))
    tool = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = os.path.join(tmp, "kernels.json")
    t0 = time.perf_counter()
    cuda.launches.clear()
    rc = tool.main(["--out", out])
    launched = dict(cuda.launches)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"[11] the kernel bench exited {rc}")
    _require(launched, BENCH_ROWS, "the kernel bench")
    with open(out) as f:
        rows = json.load(f)["rows"]
    faults = [f"{name}: missing" for name in tool.ROWS if name not in rows]
    for name, r in rows.items():
        print(f"[11] {name}: cold {r['ms_cold']:.5f} ms (quarter "
              f"{r['ms_cold_quarter']:.5f}; clean L2 {r['ms_cold_clean']:.5f}"
              f"), warm {r['ms_warm']:.5f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), share cold {r['share_cold']:.4f} / clean "
              f"{r['share_cold_clean']:.4f} / warm {r['share_warm']:.4f}, "
              f"{r['GBps_cold']:.1f} GB/s cold, {r['rw_bytes']} B, launches "
              f"{json.dumps(r['launches'])}")
        if r["launches"] != {k: 1 for k in r["kernels"]}:
            faults.append(f"{name}: launches {r['launches']}, want "
                          f"{r['kernels']} once each")
        if r["share_cold"] > 1.05:
            faults.append(f"{name}: share_cold {r['share_cold']:.4f} > 1.05")
        if r["ms_cold"] < 0.95 * r["ms_warm"]:
            faults.append(f"{name}: ms_cold {r['ms_cold']:.5f} < 0.95 "
                          f"ms_warm {r['ms_warm']:.5f}")
    print(f"[11] phase 11 took {wall:.1f} s")
    if faults:
        raise AssertionError("[11] " + "; ".join(faults))
    return rows


# The kernels every compress launches: the read minimizer, the contig
# sketch and the vote
MAIN_PATH = ("mtc_sketch_reads", "mtc_sketch_windowed", "mtc_consensus_vote")
# Phase 12's kernel shapes: those of CONFIGS_torch.json's entries that no
# earlier phase gives a kernel. The read minimizer at each new (L, k);
CONFIG_SHAPE_ROWS = 1 << 15
CONFIG_READ_SHAPES = ((50, (17, 23, 25, 31)), (75, (17, 23, 25, 31)),
                      (100, (23, 25)), (101, (23, 25)), (150, (23, 25)),
                      (256, (23, 25)))
# the contig sketch at each new (k, w), on rows of every rung up to the
# longest contigs of a 256 bp run (7,375 bases at 200,000 reads of
# L256-default, the port on the CPU), a rung's rows as many as the merge
# stage's tile (2048) or, on long rungs, fewer (the plain version holds
# [rows, Lmax] tensors);
CONFIG_WINDOWS = ((17, 3), (17, 20), (23, 5), (25, 15), (25, 20), (31, 97))
CONFIG_RUNGS = ((128, 2048), (512, 2048), (2048, 2048), (8192, 1024),
                (32768, 256))
# the vote at each new read length (L % 4 != 0 takes the scalar loads)
CONFIG_VOTE_L = (50, 75, 101, 256)


def _check_windowed(dev, rng, k, w, cap=128) -> int:
    """One call of the merge stage's contig-sketch entry point (one launch,
    entries compacted on the card) over rows of every rung of
    ``CONFIG_RUNGS`` in plan order, each row with its rung's slot count at
    (k, w), against the batched plain version and the host twin. Rows:
    empty, shorter than k, a palindromic run and a long repeat among random
    ones. Returns the max |diff| (0)."""
    lens = [np.array([0, k - 1, 600, 4000])]
    for Lmax, rows in CONFIG_RUNGS:
        lens.append(rng.integers(Lmax // 4 + 1 if Lmax > 128 else 0,
                                 Lmax + 1, rows))
    lens = np.sort(np.concatenate(lens)).astype(np.int64)
    rung = np.array([_lmax_bucket(max(int(n), k + 1)) for n in lens])
    mb = np.array([_batch_m(int(r), k, w, cap) for r in rung], np.int64)
    we = np.minimum(w, rung - k + 1).astype(np.int32)
    starts = np.r_[0, np.cumsum(lens)[:-1]].astype(np.int64)
    ref = rng.integers(0, 4, int(lens.sum()), dtype=np.uint8)
    for n, pattern in ((600, np.array([0, 3], np.uint8)),
                       (4000, np.array([2], np.uint8))):
        r = int(np.flatnonzero(lens == n)[0])
        ref[starts[r]:starts[r] + n] = np.resize(pattern, n)
    ref_d = torch.from_numpy(ref).to(dev)
    n0 = cuda.launches["mtc_sketch_windowed"]
    key, meta, nv = sketch.sketch_windowed_flat(ref_d, starts, lens, mb, k,
                                                w)
    if cuda.launches["mtc_sketch_windowed"] != n0 + 1:
        raise AssertionError(f"[12] contig sketch k={k} w={w}: not one "
                             "launch")
    pk, pm, pn = sketch._sketch_windowed_flat_plain(ref_d, starts, lens, mb,
                                                    k, w)
    tag = f"[12] contig sketch k={k} w={w}"
    err = max(_equal(f"{tag} nv", nv, pn), _equal(f"{tag} key", key, pk),
              _equal(f"{tag} meta", meta, pm))
    hk, hm, hn = native.sketch_windowed_host(ref, starts, lens, k, we,
                                             mb.astype(np.int32),
                                             int(mb.max()))
    hv = np.arange(hk.shape[1])[None, :] < hn[:, None]
    _equal(f"{tag} nv vs host", nv, hn)
    _equal(f"{tag} key vs host", key, hk[hv])
    _equal(f"{tag} meta vs host", meta, hm[hv])
    print(f"{tag}: {len(lens)} rows up to {int(lens.max())} bases, slots "
          f"{sorted(set(mb.tolist()))}, {len(key)} entries kept "
          f"({int((nv >= mb).sum())} rows full); one launch, equal to plain "
          "and host")
    return err


def phase12_kernel_shapes(dev, tmp, report):
    """Each main-path kernel against its plain version (and host twin) at
    the shapes that CONFIGS_torch.json's entries give it and no earlier
    phase does: the read minimizer at L = 50 and 75 for k in (17, 23, 25,
    31), and at k = 23 and 25 for L in (100, 101, 150, 256), each on
    2^15-row stores with the read counts that take 1, 2 and 4 lanes a read;
    the contig sketch at each new (k, w) (``_check_windowed``); the vote on
    the first cluster round of 2^15 reads of ``bench.make_dataset`` at L =
    50, 75, 101 and 256 (``_check_vote``). Folds each kernel's max |diff|
    into ``report``."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    sizes = reads_for_lanes(dev)
    errs = dict.fromkeys(MAIN_PATH, 0)
    for L, ks in CONFIG_READ_SHAPES:
        codes = _reads_store(rng, CONFIG_SHAPE_ROWS, L)
        c = torch.from_numpy(codes).to(dev)
        for lanes, m in sizes.items():
            errs["mtc_sketch_reads"] = max(
                errs["mtc_sketch_reads"], _check_reads(
                    dev, f"[12] sketch_reads {m} x {L} ({lanes} lanes a "
                    "read)", codes, c, rng.integers(0, CONFIG_SHAPE_ROWS, m),
                    ks))
    t1 = time.perf_counter()
    print(f"[12] read minimizer equal to plain and host at "
          + ", ".join(f"L={L} k in {ks}" for L, ks in CONFIG_READ_SHAPES)
          + f", {sorted(sizes.values())} reads (1, 2, 4 lanes a read) of "
          f"2^15-row stores ({t1 - t0:.1f} s)")
    for k, w in CONFIG_WINDOWS:
        errs["mtc_sketch_windowed"] = max(errs["mtc_sketch_windowed"],
                                          _check_windowed(dev, rng, k, w))
    t2 = time.perf_counter()
    for L in CONFIG_VOTE_L:
        path = os.path.join(tmp, f"vote_{L}.fastq")
        make_dataset(path, CONFIG_SHAPE_ROWS, L=L)
        err, args = _check_vote(dev, path, f"[12] L={L}")
        errs["mtc_consensus_vote"] = max(errs["mtc_consensus_vote"], err)
        print(f"[12] consensus_vote_flat L={L}: {len(args[1])} members of "
              f"the first cluster round of {CONFIG_SHAPE_ROWS} reads, span "
              f"{args[5]}; one launch, equal to plain, host and the "
              "one-cluster entry")
        os.remove(path)
    for name, err in errs.items():
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
    print(f"[12] kernel shapes: read minimizer {t1 - t0:.1f} s, contig "
          f"sketch {t2 - t1:.1f} s, vote {time.perf_counter() - t2:.1f} s")


def _start_inputs(workdir) -> subprocess.Popen:
    """A child interpreter (numpy, no torch) that writes every input of
    CONFIGS_torch.json into ``workdir`` (``configs_torch.py``), printing
    each path."""
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "configs_torch.py"), workdir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase12_configs(dev, tmp, writer, report):
    """Each entry of CONFIGS_torch.json (the reference's documented command
    lines, 50-256 bp reads and gzip input, 1,000,000 reads each) through
    the main path on the card, after the kernels at the entries' shapes
    (``phase12_kernel_shapes``): compress with the entry's settings, the
    launch counts set to 0 just before it and read just after (each of the
    read minimizer, the contig sketch and the vote at least once); the
    archive's SHA-256 must be the entry's pin (the JAX package's archive);
    decompress on the card, and the decoded reads must equal the input's as
    a multiset. ``writer``: the child of ``_start_inputs``, started at the
    top of ``main``. Prints one line a configuration and the phase's
    wall."""
    t_start = time.perf_counter()
    print(f"[12] {_smi()}")
    phase12_kernel_shapes(dev, tmp, report)
    t0 = time.perf_counter()
    out, err = writer.communicate()
    if writer.returncode != 0:
        raise AssertionError(f"[12] the inputs' writer exited "
                             f"{writer.returncode}: {err}")
    paths = out.split()
    entries = configs_torch.load_configs()
    print(f"[12] inputs of {len(entries)} configurations ready after "
          f"{time.perf_counter() - t0:.1f} s more")
    want, results = {}, {}
    for entry, fq in zip(entries, paths, strict=True):
        name, L, n = entry["name"], entry["L"], entry["reads"]
        cfg = CompressorConfig(**entry["settings"])
        rc = cfg.resolve(L)
        arc, dec = (os.path.join(os.path.dirname(fq), name + x)
                    for x in (".mtc", ".reads"))
        with _LaunchTimer() as lt:
            t0 = time.perf_counter()
            summary = compressor.compress(fq, arc, cfg, device=dev)
            enc_s = time.perf_counter() - t0
        kernel_ms = {k: v * 1e3 for k, v in lt.seconds().items()}
        _require(lt.launched, MAIN_PATH, f"[12] {name}'s compress")
        digest = bench_torch._sha256(arc)
        if digest != entry["reference_sha256"]:
            raise AssertionError(
                f"[12] {name}: the archive ({summary['archive_bytes']} B, "
                f"{digest[:12]}) is not its pin, the JAX package's "
                f"({entry['archive_bytes']} B, "
                f"{entry['reference_sha256'][:12]})")
        t0 = time.perf_counter()
        dsum = compressor.decompress(arc, dec, device=dev)
        dec_s = time.perf_counter() - t0
        plain = os.path.join(os.path.dirname(fq), configs_torch.input_name(
            dict(entry, gzip=False)))
        if plain not in want:
            want[plain] = sorted_rows(input_rows(plain))
        if not np.array_equal(sorted_rows(decoded_rows(dec, n, L)),
                              want[plain]):
            raise AssertionError(f"[12] {name}: roundtrip is not exact")
        nb = summary["archive_bytes"]
        results[name] = dict(
            k=rc.k, w=rc.contig_window, dicts=rc.num_dicts,
            archive_bytes=nb, bits_per_base=8 * nb / (n * L),
            encode_s=enc_s, decode_s=dec_s,
            launches=lt.launched, kernel_ms=kernel_ms,
            stage_s=summary["timings_s"], decode_stage_s=dsum["timings_s"])
        print(f"[12] {name} ({n} x {L} bp{', gzip' if entry['gzip'] else ''};"
              f" k {rc.k}, w {rc.contig_window}, {rc.num_dicts} dicts of "
              f"{rc.dict_seg_len}, e {rc.diff_threshold}, S {rc.thr_step}, E "
              f"{rc.max_threshold}, m {rc.first_minimizers}): archive {nb} B "
              f"= its pin, {8 * nb / (n * L):.6f} bit/base; compress "
              f"{enc_s:.2f} s, decompress {dec_s:.2f} s, roundtrip exact; "
              f"launches {json.dumps(lt.launched)}, device ms "
              + json.dumps({k: round(v, 4) for k, v in kernel_ms.items()})
              + "; stages s " + json.dumps(summary["timings_s"])
              + ", decode " + json.dumps(dsum["timings_s"]))
        for path in (arc, dec):
            os.remove(path)
    print("[12] configurations: " + json.dumps(results))
    print(f"[12] phase 12 took {time.perf_counter() - t_start:.1f} s")


def _device_line() -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def cards_main(t_start) -> int:
    """``chip_smoke.py --cards``: phase 13 with only what it needs: the
    build (phase 0), phase 2's file, archive and decode, phase 3's cuda
    archives (their cpu twins left out) and phase 8's one-card digests."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as tmp:
        dev = phase0_device()
        fq_small = os.path.join(tmp, "same.fastq")
        make_dataset(fq_small, N_SAME_BYTES)
        fq, arc, launched = phase2_end_to_end(dev, tmp)
        _require(launched, MAIN_PATH, "compress")
        m1, m2, same = phase3_same_bytes(dev, fq_small, tmp, twins=False)
        cases, want, t_ref = _step_refs(dev, tmp, _step_store(fq))
        print(f"[8] the one-card references {t_ref:.1f} s")
        phase13_cards(tmp, fq, arc, fq_small, m1, m2, same, cases, want)
    print(f"chip_smoke --cards: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(_device_line())
    return 0


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--dist-worker":
        return dist_worker(sys.argv[2:])
    t_start = time.perf_counter()
    if sys.argv[1:] not in ([], ["--cards"]):
        print("usage: chip_smoke.py [--cards]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--cards"]:
        return cards_main(t_start)
    report = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as tmp, \
            contextlib.ExitStack() as stack:
        # phase 12's inputs, written while the earlier phases run
        os.makedirs(os.path.join(tmp, "configs"))
        writer = stack.enter_context(_start_inputs(os.path.join(tmp,
                                                                "configs")))
        stack.callback(writer.kill)
        dev = phase0_device()
        fq_small = os.path.join(tmp, "same.fastq")
        make_dataset(fq_small, N_SAME_BYTES)
        phase1_sketch_reads(dev, report)
        phase1_sketch_windowed(dev, report)
        phase1_consensus(dev, fq_small, report)
        phase1_verify(dev, report)
        fq, arc, launched = phase2_end_to_end(dev, tmp)
        _require(launched, MAIN_PATH, "compress")
        phase1_rans(dev, container.read_container(arc)[1], report)
        m1, m2, same = phase3_same_bytes(dev, fq_small, tmp)
        enc, dec = phase2_device_codecs(dev, fq_small, same)
        _require(enc, ("mtc_rans_encode",), "codec=device compress")
        _require(dec, ("mtc_rans_decode",), "codec=device decompress")
        ver = phase4_verify_path(dev, fq_small)
        _require(ver, ("mtc_popcount_verify",), "the realign verify path")
        phase5_resume(dev, fq_small, tmp, same["codec=auto"])
        phase6_two_ranks(tmp, fq, arc, fq_small, m1, m2, same)
        steps, store = phase7_cluster_step(dev, fq, report)
        cases, want = phase8_sharded_step(dev, tmp, store)
        del store
        phase9_bench(dev, tmp, same)
        phase10_codecs_table(tmp, same["codec=auto"])
        cold = phase11_kernel_bench(tmp)
        phase12_configs(dev, tmp, writer, report)
        phase13_cards(tmp, fq, arc, fq_small, m1, m2, same, cases, want)
    launched.update(mtc_rans_encode=enc["mtc_rans_encode"],
                    mtc_rans_decode=dec["mtc_rans_decode"],
                    mtc_popcount_verify=ver["mtc_popcount_verify"], **steps)
    kernels = [dict(report[k], launches=launched[k],
                    ms_cold=cold[BENCH_ROWS[k]]["ms_cold"],
                    share_cold=cold[BENCH_ROWS[k]]["share_cold"],
                    cold_row=BENCH_ROWS[k]) for k in
               MAIN_PATH + ("mtc_rans_encode", "mtc_rans_decode",
                            "mtc_popcount_verify") + STEP_KERNELS]
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(_device_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
