"""Stream serialization (reference: kthread_dump.c / kthread_dump_pe.c).

Builds the canonical `.mtc` streams from the final cluster set and the special
read classes, as single deterministic byte sequences:

* clusters in canonical order (ascending minimum member rid),
* members within a cluster sorted by (pos, dir, rid) (cmpcluster2,
  kthread_cb.c:54-69), or by (pos, rid) in ORDER/PE modes (cmpcluster3),
* special-class id lists sorted ascending.

Stream records per cluster (print_encode, kthread_dump.c:142-236): consensus
2-bit-packed, u32 member count, per member u16 Δpos (escape 0xFFFF + u32 side
stream for giants), strand bit, and a textual diff line. The consensus length
is implied: last member pos + readlen (decompress.c:92-100).

Canonical emission order (also the PE pairing order, the mpv replay of
kthread_dump_pe.c:280-335): allA, allT, allN, AA, TT, NN, single_N, single,
then cluster members. ORDER adds the id streams that put every read back at
its input index; PE adds the file bit of each emitted read and, for each
mate-2 read, the emission ordinal of its mate 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from minicom_tpu_torch import native
from minicom_tpu_torch.ops.pack import codes_to_ascii, pack_2bit, pack_bits
from minicom_tpu_torch.parallel import distributed as dist
from minicom_tpu_torch.parallel.store import ShardedReadStore, rows_all
from minicom_tpu_torch.pipeline.cluster import ClusterSet

FORMAT_VERSION = 1
DPOS_ESCAPE = 0xFFFF


@dataclasses.dataclass
class EncodeInput:
    readlen: int
    n_seq: int
    half_val: int                 # PE: reads in file 1 (0 otherwise)
    order: bool
    paired: bool
    codes_sub: np.ndarray         # [N, L] codes, N substituted (or their
    #                               ShardedReadStore)
    n_mask: "object"              # SparseNMask: [rids] -> dense bool rows
    all_a: np.ndarray
    all_t: np.ndarray
    all_n: np.ndarray
    near_a: np.ndarray            # incl. realign-absorbed (bbhashdict.c:127-227)
    near_t: np.ndarray
    mostly_n: np.ndarray
    nfile: np.ndarray             # N-heavy + leftover singles containing N
    single: np.ndarray            # leftover singles without N
    clusters: ClusterSet


def _restored_ascii(inp: EncodeInput, rids: np.ndarray) -> np.ndarray:
    codes = rows_all(inp.codes_sub, rids)
    codes[inp.n_mask[rids]] = 4
    return codes_to_ascii(codes)


def _delta_u32(ids: np.ndarray) -> bytes:
    """First id, then u32 differences (wrapping) of a sorted id list."""
    ids = np.asarray(ids, np.uint32)
    out = ids.copy()
    out[1:] = ids[1:] - ids[:-1]
    return out.tobytes()


def _const_row(char: bytes, n: int, L: int) -> np.ndarray:
    return np.full((n, L), char[0], dtype=np.uint8)


def serialize(inp: EncodeInput) -> tuple[dict, dict]:
    """Returns (meta, streams) ready for io.container.write_container."""
    L = inp.readlen
    cs = inp.clusters
    streams: dict[str, bytes] = {}

    # ---- canonical cluster order: ascending min member rid --------------
    C = cs.n_clusters
    sizes = cs.cluster_sizes()
    if C and cs.n_members:
        seg = np.repeat(np.arange(C), sizes)
        min_rid = np.full(C, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(min_rid, seg, cs.mem_rid)
        cl_order = np.argsort(min_rid, kind="stable")
    else:
        cl_order = np.arange(C)

    # flat member arrays reordered to canonical cluster + in-cluster order
    new_ptr = np.zeros(C + 1, np.int64)
    new_ptr[1:] = np.cumsum(sizes[cl_order])
    flat_idx = (np.repeat(cs.cluster_ptr[cl_order] - new_ptr[:-1],
                          sizes[cl_order]) + np.arange(cs.n_members))
    rid = cs.mem_rid[flat_idx]
    off = cs.mem_off[flat_idx].astype(np.int64)
    dirs = cs.mem_dir[flat_idx]
    segc = np.repeat(np.arange(C), sizes[cl_order])
    # segc is nondecreasing, so the sort splits into contiguous member
    # ranges cut at cluster boundaries: each rank sorts its range and the
    # rank-order concatenation is the global sort
    c0, c1 = dist.my_partition(sizes[cl_order])
    m0, m1 = int(new_ptr[c0]), int(new_ptr[c1])
    keys = (rid, off, segc) if inp.order or inp.paired else (rid, dirs, off,
                                                             segc)
    order2 = dist.allgather_ragged(np.lexsort([x[m0:m1] for x in keys]) + m0)
    rid, off, dirs = rid[order2], off[order2], dirs[order2]

    # ---- cluster streams -------------------------------------------------
    streams["cnt"] = sizes[cl_order].astype(np.uint32).tobytes()
    first = new_ptr[:-1]
    prev = np.empty_like(off)
    prev[1:] = off[:-1]
    prev[first] = 0
    delta = off - prev
    if (delta < 0).any():
        raise RuntimeError("members not sorted by position")
    esc = delta >= DPOS_ESCAPE
    d16 = np.where(esc, DPOS_ESCAPE, delta).astype(np.uint16)
    streams["dpos"] = d16.tobytes()
    streams["dposx"] = delta[esc].astype(np.uint32).tobytes()
    streams["dir"] = pack_bits(dirs.astype(np.uint8)).tobytes()

    # consensus refs, canonical order, 2-bit packed as one stream
    ref_lens = cs.ref_lengths()[cl_order]
    ref_ptr_new = np.zeros(C + 1, np.int64)
    ref_ptr_new[1:] = np.cumsum(ref_lens)
    total_ref = int(ref_ptr_new[-1])
    ref_cat = cs.ref_flat[np.repeat(cs.ref_ptr[cl_order] - ref_ptr_new[:-1],
                                    ref_lens) + np.arange(total_ref)]
    streams["ref"] = pack_2bit(ref_cat).tobytes()

    # diff lines: oriented restored reads vs their ref window, in row chunks
    # (the text is row-aligned, so chunking never changes the bytes; the
    # restored-codes transient of a whole-member pass is the stage's RSS
    # peak). Each rank encodes a contiguous member range and the text
    # gathers in rank order; a sharded store fetches the range's rows in
    # one collective (chunked inside)
    base = ref_ptr_new[segc] + off
    d0, d1 = dist.my_partition(np.ones(cs.n_members, np.int32))
    sharded = isinstance(inp.codes_sub, ShardedReadStore)
    my_rows = inp.codes_sub.rows(rid[d0:d1]) if sharded else None
    parts = []
    CH = 1 << 18
    for s in range(d0, d1, CH):
        t = min(s + CH, d1)
        restored = (my_rows[s - d0:t - d0] if sharded
                    else inp.codes_sub[rid[s:t]])
        nm = inp.n_mask[rid[s:t]]
        if nm.any():
            restored[nm] = 4
        parts.append(native.diff_encode_win(ref_cat, base[s:t], restored,
                                            dirs[s:t], 0))
    streams["diff"] = dist.allgather_bytes(b"".join(parts))

    # ---- special-class streams ------------------------------------------
    all_a, all_t = np.sort(inp.all_a), np.sort(inp.all_t)
    all_n = np.sort(inp.all_n)
    near_a, near_t = np.sort(inp.near_a), np.sort(inp.near_t)
    mostly_n, nfile = np.sort(inp.mostly_n), np.sort(inp.nfile)
    single = np.sort(inp.single)

    streams["aa"] = native.diff_encode(_const_row(b"A", len(near_a), L),
                                       _restored_ascii(inp, near_a), 1)
    streams["tt"] = native.diff_encode(_const_row(b"T", len(near_t), L),
                                       _restored_ascii(inp, near_t), 1)
    streams["nn"] = native.diff_encode(_const_row(b"N", len(mostly_n), L),
                                       _restored_ascii(inp, mostly_n), 1)
    nsingle = np.empty((len(nfile), L + 1), np.uint8)
    nsingle[:, :L] = _restored_ascii(inp, nfile)
    nsingle[:, L] = ord("\n")
    streams["nsingle"] = nsingle.tobytes()
    streams["single"] = pack_2bit(
        rows_all(inp.codes_sub, single).reshape(-1)).tobytes() \
        if len(single) else b""

    # ---- ORDER id streams ------------------------------------------------
    if inp.order:
        for name, ids in (("ids_alla", all_a), ("ids_allt", all_t),
                          ("ids_alln", all_n), ("ids_aa", near_a),
                          ("ids_tt", near_t), ("ids_nn", mostly_n),
                          ("ids_nsingle", nfile), ("ids_single", single)):
            streams[name] = _delta_u32(ids)
        # cluster member ids: absolute at a new position, the u32 delta from
        # the previous member at a repeated one (kthread_dump.c:117-128)
        ids_out = rid.astype(np.uint32)
        same_pos = np.zeros(len(rid), bool)
        same_pos[1:] = (d16[1:] == 0) & (delta[1:] == 0)
        same_pos[first] = False
        ids_out[1:] = np.where(same_pos[1:], ids_out[1:] - ids_out[:-1],
                               ids_out[1:])
        streams["ids"] = ids_out.tobytes()

    # ---- PE pairing streams ---------------------------------------------
    if inp.paired:
        emit_rids = np.concatenate([all_a, all_t, all_n, near_a, near_t,
                                    mostly_n, nfile, single, rid])
        half = inp.half_val
        is_m2 = emit_rids >= half
        # mpv: ordinal of each emitted mate-1 read in emission order
        mpv = np.zeros(half, np.uint32)
        m1 = emit_rids[~is_m2]
        mpv[m1] = np.arange(len(m1), dtype=np.uint32)
        streams["fbits"] = pack_bits(is_m2.astype(np.uint8)).tobytes()
        streams["peids"] = mpv[emit_rids[is_m2] - half].tobytes()

    meta = {
        "version": FORMAT_VERSION, "readlen": L, "n_seq": int(inp.n_seq),
        "order": bool(inp.order), "pe": bool(inp.paired),
        "half": int(inp.half_val),
        "n_alla": len(all_a), "n_allt": len(all_t), "n_alln": len(all_n),
        "n_aa": len(near_a), "n_tt": len(near_t), "n_nn": len(mostly_n),
        "n_nsingle": len(nfile), "n_single": len(single),
        "n_clusters": int(C), "n_members": int(cs.n_members),
    }
    return meta, streams
