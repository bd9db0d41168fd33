"""`.mtc` archive container (the JAX package's format, byte for byte).

Layout: `MTC1` magic | u32 header length | header JSON | concatenated
compressed streams. The header carries the mode, read length, read counts and
the stream table (name -> offset/compressed/raw lengths + codec + crc32 of the
raw stream). Archives are a pure function of (input, config); every stream's
crc32 is verified after decoding.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np

from minicom_tpu_torch.entropy import backend
from minicom_tpu_torch.ops import cuda
from minicom_tpu_torch.parallel import distributed as dist
from minicom_tpu_torch.stats import substage as _sub

MAGIC = b"MTC1"

# streams code independently and both lzma and the native coders release the
# GIL; the pool size follows the -t flag via set_threads
_POOL: ThreadPoolExecutor | None = None
_POOL_SIZE = max(2, (os.cpu_count() or 2))


def set_threads(n: int) -> None:
    global _POOL, _POOL_SIZE
    if n > 0 and n != _POOL_SIZE:
        _POOL_SIZE = n
        _POOL = None


def _pool() -> ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=_POOL_SIZE)
    return _POOL


# "auto" candidate codecs per stream class. The 2-bit packed DNA streams get
# the base-context coders; the diff text the order-2 byte coder; fixed-width
# integer streams are deinterleaved into byte planes first. "store" last
# guarantees no stream ever inflates.
_AUTO: Dict[str, list] = {
    "ref": ["dz", "dnarc", "xz"],
    "single": ["dz", "dnarc", "xz"],
    "diff": ["o2rc", "o1rc"],
    "nsingle": ["o2rc", "o1rc", "xz"],
    "aa": ["o2rc", "o1rc", "xz"],
    "tt": ["o2rc", "o1rc", "xz"],
    "nn": ["o2rc", "o1rc", "xz"],
    "cnt": ["p4:xz", "p4:o1rc"],
    "dpos": ["p2:o1rc", "p2:xz"],
    "dposx": ["p4:xz", "p4:o1rc"],
    "ids": ["p4:xz", "p4:o1rc"],
    "peids": ["p4:xz", "p4:o1rc"],
}
_AUTO_DEFAULT = ["xz", "o1rc"]

# codec="device": every stream through the on-device rANS family (dzt = the
# dz LZ transform with its residual coded on the device); "store" guards
# the streams the static-table coders lose.
_DEVICE_AUTO: Dict[str, list] = {
    "ref": ["dzt"],
    "single": ["dzt", "trans1"],
    "diff": ["trans2", "trans1"],
    "nsingle": ["trans2", "trans1"],
    "aa": ["trans2", "trans1"],
    "tt": ["trans2", "trans1"],
    "nn": ["trans2", "trans1"],
    "cnt": ["p4:trans1"],
    "dpos": ["p2:trans1"],
    "dposx": ["p4:trans1"],
    "ids": ["p4:trans1"],
    "peids": ["p4:trans1"],
}

# Above this raw size, xz -9e trial encodes cost more time than they save
# bytes; large streams take the range-coder candidates only.
_TRIAL_MAX = 1 << 19


def _auto_candidates(name: str, rlen: int = 0, table: str = "auto") -> list:
    key = "ids" if name.startswith("ids_") else name
    if table == "device":
        return _DEVICE_AUTO.get(key, ["trans1"]) + ["store"]
    cands = _AUTO.get(key, _AUTO_DEFAULT)
    if rlen > _TRIAL_MAX:
        cands = [c for c in cands if not c.endswith("xz")] or cands
    return cands + ["store"]


def write_container(path: str, meta: dict, streams: Dict[str, bytes],
                    codec: str, device=None, stats: dict | None = None
                    ) -> int:
    """Compress and write streams; returns total archive bytes. ``codec`` is
    one codec for every stream, or the candidate table "auto" (host codecs)
    or "device" (on-device codecs); ``device`` runs the on-device codecs.
    ``stats`` receives the sub-stage walls entropy_code_s (every stream's
    coding, in the pool) and entropy_write_s (the header and the file);
    each stream's coding is the span ``mtc.entropy.<stream>`` on its pool
    thread.

    In a multi-process run each rank codes a contiguous range of the sorted
    stream names, weighted by raw size, and the coded streams all-gather in
    rank order. Rank 0 writes the file (every rank with
    MTC_WRITE_ALL_RANKS=1, each through its own temporary name) and all
    ranks meet before returning: a write that fails on one rank removes its
    temporary file and raises on every rank."""
    names = sorted(streams)
    device = cuda.named(device)   # the pool's threads code on this card

    def encode_one(name: str) -> tuple[str, bytes]:
        raw = streams[name]
        with _sub(None, f"entropy.{name}"):
            if codec in ("auto", "device"):
                return backend.best_of(
                    _auto_candidates(name, len(raw), codec), raw, device)
            return codec, backend.compress(codec, raw, device)

    pid, nproc = dist.process_grid()
    with _sub(stats, "entropy_code"):
        if nproc == 1:
            encoded = list(_pool().map(encode_one, names))
        else:
            lo, hi = dist.my_partition(
                np.array([len(streams[n]) for n in names], np.int64))
            payload = b"".join(
                struct.pack("<HQ", len(used.encode()), len(blob))
                + used.encode() + blob
                for used, blob in _pool().map(encode_one, names[lo:hi]))
            buf = dist.allgather_bytes(payload)
            encoded, pos = [], 0
            while pos < len(buf):
                nlen, blen = struct.unpack_from("<HQ", buf, pos)
                pos += 10
                encoded.append((buf[pos:pos + nlen].decode(),
                                buf[pos + nlen:pos + nlen + blen]))
                pos += nlen + blen
            if len(encoded) != len(names):
                raise RuntimeError("sharded stream coding lost a stream")

    with _sub(stats, "entropy_write"):
        table = []
        blobs = []
        off = 0
        for name, (used, blob) in zip(names, encoded):
            raw = streams[name]
            table.append({"name": name, "off": off, "clen": len(blob),
                          "rlen": len(raw), "codec": used,
                          "crc": zlib.crc32(raw)})
            blobs.append(blob)
            off += len(blob)
        header = dict(meta)
        header["streams"] = table
        hdr = json.dumps(header, separators=(",", ":"),
                         sort_keys=True).encode()
        tmp = path + f".tmp{pid}"

        def write():
            with open(tmp, "wb") as f:
                f.write(MAGIC)
                f.write(struct.pack("<I", len(hdr)))
                f.write(hdr)
                for b in blobs:
                    f.write(b)
            os.replace(tmp, path)

        dist.write_together(
            write, pid == 0 or os.environ.get("MTC_WRITE_ALL_RANKS") == "1",
            tmp)
    return len(MAGIC) + 4 + len(hdr) + off


def _parse_header(path: str, head: bytes) -> tuple[dict, int]:
    """(header dict, header length) from the first 8 + hlen bytes."""
    if head[:4] != MAGIC:
        raise ValueError(f"{path}: not a .mtc archive")
    if len(head) < 8:
        raise ValueError(f"{path}: truncated archive header")
    (hlen,) = struct.unpack("<I", head[4:8])
    if len(head) < 8 + hlen:
        raise ValueError(f"{path}: truncated archive header")
    try:
        return json.loads(head[8:8 + hlen]), hlen
    except ValueError as e:
        raise ValueError(f"{path}: corrupt archive header ({e})") from None


def read_header(path: str) -> dict:
    """Just the archive header (mode, counts, stream table)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) == 8 and head[:4] == MAGIC:
            head += f.read(struct.unpack("<I", head[4:8])[0])
    return _parse_header(path, head)[0]


def read_container(path: str, stats: dict | None = None, device=None
                   ) -> tuple[dict, Dict[str, bytes]]:
    """(header, raw streams). ``stats`` receives each stream's entropy
    decode seconds as entropy_<stream>_s; ``device`` runs the on-device
    codecs."""
    device = cuda.named(device)   # the pool's threads decode on this card
    with open(path, "rb") as f:
        data = f.read()
    meta, hlen = _parse_header(path, data)
    base = 8 + hlen

    def decode_one(ent):
        t0 = time.perf_counter()
        end = base + ent["off"] + ent["clen"]
        if end > len(data):
            raise ValueError(
                f"{path}: stream {ent['name']!r} extends past end of file "
                "(truncated archive)")
        blob = data[base + ent["off"]: end]
        try:
            raw = backend.decompress(ent["codec"], blob, ent["rlen"], device)
        except Exception as e:
            raise ValueError(
                f"{path}: stream {ent['name']!r} failed to decode "
                f"({e})") from None
        if len(raw) != ent["rlen"]:
            raise ValueError(
                f"{path}: stream {ent['name']!r} decoded to {len(raw)} bytes,"
                f" expected {ent['rlen']} (corrupt archive)")
        if "crc" in ent and zlib.crc32(raw) != ent["crc"]:
            raise ValueError(
                f"{path}: stream {ent['name']!r} checksum mismatch "
                "(corrupt archive)")
        if stats is not None:
            stats[f"entropy_{ent['name']}_s"] = round(
                time.perf_counter() - t0, 4)
        return ent["name"], raw

    ents = meta["streams"]
    if dist.process_grid()[1] == 1:
        return meta, dict(_pool().map(decode_one, ents))
    # each rank decodes a contiguous stream range, weighted by raw size; a
    # corrupt stream raises the same ValueError on every rank
    lo, hi = dist.my_partition(np.array([e["rlen"] for e in ents], np.int64))
    try:
        mine, err = list(_pool().map(decode_one, ents[lo:hi])), None
    except ValueError as e:
        mine, err = [], str(e)
    dist.raise_together(err)
    merged = dist.allgather_bytes(
        b"".join(struct.pack("<Q", len(raw)) + raw for _, raw in mine))
    streams, pos = {}, 0
    for e in ents:
        (blen,) = struct.unpack_from("<Q", merged, pos)
        streams[e["name"]] = merged[pos + 8:pos + 8 + blen]
        pos += 8 + blen
    return meta, streams
