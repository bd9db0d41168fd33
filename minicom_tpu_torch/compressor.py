"""compress / decompress entry points (reference: minicommain.c +
preprocess.c orchestration).

compress():  load -> classify -> upload the read store to ``device`` ->
             cluster rounds -> contig merge -> realignment ladder ->
             serialize -> .mtc container.
decompress(): container -> streams -> unordered assembly, streamed to disk
             by a writer thread. Host work, apart from the streams that an
             on-device codec coded.

On ``device="cuda"`` the device stages launch the CUDA kernels; on
``device="cpu"`` they run the kernels' plain PyTorch versions. Both write the
same archive, byte for byte, as ``minicom_tpu.compressor.compress``. With
``codec="device"`` (or one of the on-device codecs) the entropy stage runs
on ``device`` too.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from minicom_tpu_torch import native
from minicom_tpu_torch.config import CompressorConfig
from minicom_tpu_torch.entropy.backend import is_device_codec
from minicom_tpu_torch.io import container, fastq
from minicom_tpu_torch.pipeline import classify as classify_mod
from minicom_tpu_torch.pipeline import cluster as cluster_mod
from minicom_tpu_torch.pipeline import decode as decode_mod
from minicom_tpu_torch.pipeline import encode as encode_mod
from minicom_tpu_torch.pipeline.merge import merge_contigs
from minicom_tpu_torch.pipeline.realign import realign_ladder
from minicom_tpu_torch.stats import StageStats


def _check_in_slice(cfg: CompressorConfig, reads_path2) -> None:
    """Raise NotImplementedError for what this port does not do yet."""
    if reads_path2 is not None or cfg.paired:
        raise NotImplementedError("paired-end input is not ported yet")
    if cfg.order:
        raise NotImplementedError("order-preserving mode is not ported yet")
    if cfg.checkpoint_dir:
        raise NotImplementedError("stage checkpoints are not ported yet")
    if (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError("multi-process runs are not ported yet")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def compress(reads_path: str, out_path: str, cfg: CompressorConfig | None = None,
             reads_path2: str | None = None, stats: StageStats | None = None,
             device="cuda") -> dict:
    """Compress a FASTQ file into a .mtc archive; returns the run summary."""
    cfg = cfg or CompressorConfig()
    _check_in_slice(cfg, reads_path2)
    dev = _device(device)
    stats = stats or StageStats()

    with stats.stage("load"):
        codes = fastq.read_fastq_store(reads_path)
    n_seq, L = codes.shape
    rcfg = cfg.resolve(L if L else 1)
    if rcfg.threads > 0:  # -t: cap native OpenMP + entropy pool workers
        native.set_threads(rcfg.threads)
        container.set_threads(rcfg.threads)

    with stats.stage("classify"):
        cls = classify_mod.classify(codes, rcfg)
    del codes

    # the read store goes to the device once; every round and the merge
    # re-vote gather member rows there by rid
    with stats.stage("upload"):
        codes_dev = torch.from_numpy(cls.codes_sub).to(dev)
    with stats.stage("cluster"):
        cset, sg = cluster_mod.cluster_rounds(codes_dev, cls.pool, rcfg)
    stats.set("clusters_initial", cset.n_clusters)
    stats.set("singletons_initial", len(sg))

    # widen realign search when few singletons remain (preprocess.c:169-172)
    rcfg = cfg.resolve(L if L else 1, n_singletons=len(sg))

    with stats.stage("merge"):
        cset = merge_contigs(cset, rcfg, dev, stats.counters,
                             codes_dev=codes_dev)
    del codes_dev
    stats.set("clusters_merged", cset.n_clusters)
    stats.set("consensus_bases", int(cset.ref_ptr[-1]))

    with stats.stage("realign"):
        cset, sg, extra_a, extra_t = realign_ladder(
            cset, sg, cls.codes_sub, cls.n_mask, rcfg, stats=stats.counters)
    stats.set("singletons_final", len(sg))

    # leftover singles containing N join the single_N stream
    # (kthread_dump.c:396-404)
    with stats.stage("serialize"):
        sg_has_n = cls.has_n[sg]
        inp = encode_mod.EncodeInput(
            readlen=L, n_seq=n_seq, codes_sub=cls.codes_sub,
            n_mask=cls.n_mask, all_a=cls.all_a, all_t=cls.all_t,
            all_n=cls.all_n,
            near_a=np.concatenate([cls.near_a, extra_a]),
            near_t=np.concatenate([cls.near_t, extra_t]),
            mostly_n=cls.mostly_n,
            nfile=np.concatenate([cls.nfile, sg[sg_has_n]]),
            single=sg[~sg_has_n], clusters=cset)
        meta, streams = encode_mod.serialize(inp)

    with stats.stage("entropy"):
        total = container.write_container(out_path, meta, streams, rcfg.codec,
                                          dev)
    stats.set("archive_bytes", total)
    stats.set("input_bytes", int(n_seq) * (L + 1))
    return stats.summary()


def decompress(archive_path: str, out_path: str,
               out_path2: str | None = None,
               stats: StageStats | None = None, device="cuda") -> dict:
    """Decode a single-end unordered .mtc archive to ``out_path`` (one
    sequence per line, canonical order). ``device`` decodes the streams of
    on-device codecs and is needed only when the archive has such streams.
    ``out_path2`` is for paired-end archives, which are not ported yet."""
    stats = stats or StageStats()
    with stats.stage("read_container"):   # archive read + entropy decode
        header = container.read_header(archive_path)
        if header.get("pe") or header.get("order"):
            raise NotImplementedError(
                "decoding paired-end or order-preserving archives is not "
                "ported yet")
        dev = None
        if any(is_device_codec(e["codec"]) for e in header["streams"]):
            dev = _device(device)
        pre = decode_mod.Prealloc(header)
        meta, streams = container.read_container(archive_path, stats.counters,
                                                 dev)

    # finished row ranges stream to a writer thread while later rows still
    # decode
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
