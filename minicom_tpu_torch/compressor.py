"""compress / decompress entry points (reference: minicommain.c +
preprocess.c orchestration).

compress():  load (one FASTQ, or the two mates of a paired-end run) ->
             classify -> upload the read store to ``device`` -> cluster
             rounds -> contig merge -> realignment ladder -> serialize ->
             .mtc container. With ``checkpoint_dir`` the state after
             cluster, merge and realign is saved, and a rerun resumes from
             the newest valid snapshot.
decompress(): container -> streams -> assembly by mode: unordered (streamed
             to disk by a writer thread), order-preserving (every read at
             its input line) or paired-end (two files, line i of the second
             the mate of line i of the first). Host work, apart from the
             streams that an on-device codec coded.

On ``device="cuda"`` the device stages launch the CUDA kernels; on
``device="cpu"`` they run the kernels' plain PyTorch versions. Both write the
same archive, byte for byte, as ``minicom_tpu.compressor.compress``. With
``codec="device"`` (or one of the on-device codecs) the entropy stage runs
on ``device`` too.

Called in every process of a ``torch.distributed`` group
(``parallel.distributed``), both entry points shard their stages: each rank
keeps 1/P of the read store, runs the kernels on its share of the work and
exchanges results with ordered all-gathers, so the archive and the decoded
output are the single-process ones, byte for byte. Rank 0 writes the files
(every rank with MTC_WRITE_ALL_RANKS=1). ``device="cuda"`` is the rank's own
card there (``distributed.place``), and each summary names it.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading

import numpy as np
import torch

from minicom_tpu_torch import native
from minicom_tpu_torch.checkpoint import StageCheckpoint
from minicom_tpu_torch.config import CompressorConfig
from minicom_tpu_torch.entropy.backend import is_device_codec
from minicom_tpu_torch.io import container, fastq
from minicom_tpu_torch.ops import cuda
from minicom_tpu_torch.parallel import distributed as dist
from minicom_tpu_torch.parallel.store import ShardedReadStore, maybe_shard
from minicom_tpu_torch.pipeline import classify as classify_mod
from minicom_tpu_torch.pipeline import cluster as cluster_mod
from minicom_tpu_torch.pipeline import decode as decode_mod
from minicom_tpu_torch.pipeline import encode as encode_mod
from minicom_tpu_torch.pipeline.merge import merge_contigs
from minicom_tpu_torch.pipeline.realign import realign_ladder
from minicom_tpu_torch.stats import StageStats, profiler


def _device(device) -> torch.device:
    """``device`` with its card named: "cuda" is the rank's card in a group
    (``distributed.rank_device``), else the current one; "cuda:i" and "cpu"
    stay as given. Every thread of a run, the pools' too, then works on
    that card, whatever its own current device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dist.rank_device() if dev == torch.device("cuda") else dev


def _name_device(stats: StageStats, dev: torch.device | None) -> None:
    """The summary's ``device`` (the card the run used, "cpu" where it ran
    on the host alone) and ``card_shared`` (another rank of the host runs
    on that card)."""
    p = dist.placement()
    stats.set("device", str(dev) if dev is not None else "cpu")
    stats.set("card_shared", bool(p and p.shared and dev == p.device))


def _load(reads_path, reads_path2):
    """(store, half_val): one FASTQ's [N, L] codes and 0, or mate 1's rows
    then mate 2's and the mate-1 count. In a group the store is a
    ShardedReadStore."""
    if reads_path2 is None:
        return fastq.read_fastq_store(reads_path), 0
    codes = fastq.read_fastq_full(reads_path)
    codes2 = fastq.read_fastq_full(reads_path2)
    if codes2.shape[1] != codes.shape[1]:
        raise ValueError("paired files have different read lengths")
    if codes2.shape[0] != codes.shape[0]:
        raise ValueError("paired files contain different read counts")
    return (maybe_shard(np.concatenate([codes, codes2], axis=0)),
            codes.shape[0])


def compress(reads_path: str, out_path: str, cfg: CompressorConfig | None = None,
             reads_path2: str | None = None, stats: StageStats | None = None,
             device="cuda") -> dict:
    """Compress a FASTQ file (with ``reads_path2``: the two files of a
    paired-end run) into a .mtc archive; returns the run summary. ``cfg`` is
    not modified.

    With MTC_TRACE_DIR set, the run is traced by ``torch.profiler`` (host
    activity of every thread, and the card's kernels when ``device`` is a
    CUDA device) and the trace written into that directory as
    ``<host>_<pid>.<ns>.pt.trace.json`` (TensorBoard's and Perfetto's
    format); the archive is the same. Every stage and sub-stage is a span
    ``mtc.<name>`` of the trace (``stats.py``)."""
    # paired is set on a copy: the caller's config stays reusable for a
    # single-end run
    cfg = dataclasses.replace(cfg or CompressorConfig(),
                              paired=reads_path2 is not None)
    dev = _device(device)
    stats = stats or StageStats()
    _name_device(stats, dev)
    trace_dir = os.environ.get("MTC_TRACE_DIR")
    if not trace_dir:
        return _compress(reads_path, out_path, cfg, reads_path2, stats, dev)
    from torch.profiler import tensorboard_trace_handler
    with profiler(dev, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        return _compress(reads_path, out_path, cfg, reads_path2, stats, dev)


def _compress(reads_path, out_path, cfg, reads_path2, stats, dev) -> dict:
    with stats.stage("load"):
        codes, half_val = _load(reads_path, reads_path2)
    n_seq, L = codes.shape
    rcfg = cfg.resolve(L if L else 1)
    if rcfg.threads > 0:  # -t: cap native OpenMP + entropy pool workers
        native.set_threads(rcfg.threads)
        container.set_threads(rcfg.threads)

    with stats.stage("classify"):
        cls = classify_mod.classify(codes, rcfg, stats.counters)
    del codes

    # stage snapshots of the (ClusterSet, singletons) state; a rerun with the
    # same input + config resumes from the newest (every stage is
    # deterministic, so the archive is the same)
    ck = done = None
    if cfg.checkpoint_dir:
        paths = [reads_path] + ([reads_path2] if reads_path2 else [])
        ck = StageCheckpoint(cfg.checkpoint_dir, paths, cfg)
        done, state = ck.latest()
        if done:
            cset, sg, extra = state
            stats.set("resumed_from", done)
    rank = {"cluster": 1, "merge": 2, "realign": 3}.get(done, 0)

    # the read store goes to the device once; every round and the merge
    # re-vote gather member rows there by rid (so it is uploaded whenever
    # merge runs, a resume from the cluster snapshot included). A sharded
    # store uploads only this rank's slice
    codes_dev = None
    if rank < 2:
        with stats.stage("upload"):
            if isinstance(cls.codes_sub, ShardedReadStore):
                codes_dev = cls.codes_sub.on_device(dev)
            else:
                codes_dev = cuda.to_device(cls.codes_sub, dev)
    if rank < 1:
        with stats.stage("cluster"):
            cset, sg = cluster_mod.cluster_rounds(codes_dev, cls.pool, rcfg,
                                                  stats.counters)
        if ck:
            ck.save("cluster", cset, sg)
    stats.set("clusters_initial", cset.n_clusters)
    stats.set("singletons_initial", len(sg))

    # widen realign search when few singletons remain (preprocess.c:169-172)
    rcfg = cfg.resolve(L if L else 1, n_singletons=len(sg))

    if rank < 2:
        with stats.stage("merge"):
            cset = merge_contigs(cset, rcfg, dev, stats.counters,
                                 codes_dev=codes_dev)
        if ck:
            ck.save("merge", cset, sg)
    del codes_dev
    stats.set("clusters_merged", cset.n_clusters)
    stats.set("consensus_bases", int(cset.ref_ptr[-1]))

    if rank < 3:
        with stats.stage("realign"):
            cset, sg, extra_a, extra_t = realign_ladder(
                cset, sg, cls.codes_sub, cls.n_mask, rcfg,
                stats=stats.counters)
        if ck:
            ck.save("realign", cset, sg,
                    {"extra_a": extra_a, "extra_t": extra_t})
    else:
        extra_a, extra_t = extra["extra_a"], extra["extra_t"]
    stats.set("singletons_final", len(sg))

    # leftover singles containing N join the single_N stream
    # (kthread_dump.c:396-404)
    with stats.stage("serialize"):
        sg_has_n = cls.has_n[sg]
        inp = encode_mod.EncodeInput(
            readlen=L, n_seq=n_seq, half_val=half_val, order=rcfg.order,
            paired=rcfg.paired, codes_sub=cls.codes_sub,
            n_mask=cls.n_mask, all_a=cls.all_a, all_t=cls.all_t,
            all_n=cls.all_n,
            near_a=np.concatenate([cls.near_a, extra_a]),
            near_t=np.concatenate([cls.near_t, extra_t]),
            mostly_n=cls.mostly_n,
            nfile=np.concatenate([cls.nfile, sg[sg_has_n]]),
            single=sg[~sg_has_n], clusters=cset)
        meta, streams = encode_mod.serialize(inp, stats.counters)

    with stats.stage("entropy"):
        total = container.write_container(out_path, meta, streams, rcfg.codec,
                                          dev, stats.counters)
    stats.set("archive_bytes", total)
    stats.set("input_bytes", int(n_seq) * (L + 1))
    return stats.summary()


def decompress(archive_path: str, out_path: str,
               out_path2: str | None = None,
               stats: StageStats | None = None, device="cuda") -> dict:
    """Decode a .mtc archive to ``out_path``, one sequence per line: in
    canonical order (unordered archives), in input order (ORDER), or mate 1
    (PE), whose mates go to ``out_path2`` (default ``out_path + ".2"``).
    ``device`` decodes the streams of on-device codecs and is needed only
    when the archive has such streams.

    In a group every rank assembles the whole output; rank 0 writes it
    (every rank with MTC_WRITE_ALL_RANKS=1) and all meet: a write that
    fails raises on every rank."""
    stats = stats or StageStats()
    with stats.stage("read_container"):   # archive read + entropy decode
        header = container.read_header(archive_path)
        dev = None
        if any(is_device_codec(e["codec"]) for e in header["streams"]):
            dev = _device(device)
        _name_device(stats, dev)
        pre = decode_mod.Prealloc(header)
        meta, streams = container.read_container(archive_path, stats.counters,
                                                 dev)

    pid, nproc = dist.process_grid()
    if meta["pe"] or meta["order"] or nproc > 1:
        with stats.stage("decode"):
            f2 = None
            if meta["pe"]:
                f1, f2 = decode_mod.assemble_pe(meta, streams, stats.counters,
                                                pre)
            elif meta["order"]:
                f1 = decode_mod.assemble_order(meta, streams, stats.counters,
                                               pre)
            else:
                f1 = decode_mod.assemble_unordered(
                    meta, streams, stats.counters, pre, lambda part: None)

        def write():   # lines matrices: pure I/O
            fastq.write_lines(out_path, f1)
            if f2 is not None:
                fastq.write_lines(out_path2 or out_path + ".2", f2)

        with stats.stage("write"):
            dist.write_together(
                write,
                pid == 0 or os.environ.get("MTC_WRITE_ALL_RANKS") == "1")
        return stats.summary()

    # unordered, one process: finished row ranges stream to a writer thread
    # while later rows still decode
    q: "queue.Queue" = queue.Queue(maxsize=8)
    werr = []

    def _writer():
        try:
            with open(out_path, "wb") as f:
                while True:
                    part = q.get()
                    if part is None:
                        return
                    f.write(memoryview(part).cast("B"))
        except BaseException as e:   # surfaced after the join
            werr.append(e)
            while q.get() is not None:   # keep the producer unblocked
                pass

    def _sink(part):
        if len(part):                    # empty views cannot cast
            q.put(part)

    wt = threading.Thread(target=_writer, daemon=True)
    wt.start()
    try:
        with stats.stage("decode"):
            decode_mod.assemble_unordered(meta, streams, stats.counters,
                                          pre=pre, sink=_sink)
    finally:
        with stats.stage("write"):   # residual writer drain
            q.put(None)
            wt.join()
    if werr:
        raise werr[0]
    return stats.summary()
