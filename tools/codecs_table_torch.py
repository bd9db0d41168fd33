"""Per-stream codec sizes of an archive, on minicom_tpu_torch's codecs: the
counterpart of ``tools/codecs_table.py``, with the on-device codecs run on
the card.

    python3 tools/codecs_table_torch.py ARCHIVE [OUT_JSON] [--device cuda|cpu]

For every non-empty stream of the archive (read with
``minicom_tpu_torch.io.container.read_container``, so an archive written with
``codec="device"`` reads too) it trial-encodes the HOST codecs (o1rc, o2rc,
dnarc, dz, xz as the stream's name decides) and the DEVICE codecs (trans1,
trans2, dzt), each family with ``store`` beside it, through
``entropy.backend.compress``, and records each size and encode seconds
(``<codec>_enc_s``) and each family's best. Then it totals two archives:
``host_archive_stream_bytes``, the host winners (what ``codec="auto"``
writes), and ``device_archive_stream_bytes``, the best on-device codec of
each stream (``store`` where raw is smaller), with their ratio
``device_vs_host`` and ``gate_device_within_5pct``. Keys and sizes are the
JAX tool's.

The device codecs run kernels (f) and (g) (``csrc/rans.cu``) on a CUDA
device (``--device cuda``, the default); ``--device cpu`` runs their plain
PyTorch versions instead. Without a CUDA device and without ``--device cpu``
it exits 1 before it codes anything. Each device trial is decoded back with
``backend.decompress`` on the same device and must equal the stream, or the
tool exits non-zero. Beside each device trial's ``<codec>_enc_s``:
``<codec>_launches``, the kernel launches of its encode
(``ops/cuda.py::launches``), and on a CUDA device ``<codec>_device_s`` and
``<codec>_device_bytes``, the host wall blocked in crossings between host
and card during the encode and the bytes that crossed
(``cuda.device_seconds`` / ``device_bytes``); the rest of the encode's wall
is host work. Before the first trial the host library and the kernels are
loaded and, on a CUDA device, one small ``trans1`` stream coded both ways,
so that no trial carries the process's first crossing; ``setup_s`` and
``setup_launches`` are that set-up's wall and launches by kernel. One JSON line a
stream, then the totals; OUT_JSON receives the whole table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from minicom_tpu_torch import native  # noqa: E402
from minicom_tpu_torch.entropy import backend  # noqa: E402
from minicom_tpu_torch.io import container  # noqa: E402
from minicom_tpu_torch.ops import cuda  # noqa: E402

# the candidates of each stream by name, and of any other stream
HOST_CANDIDATES = {
    "ref": ["dz", "dnarc"], "single": ["dz", "dnarc"],
    "diff": ["o2rc", "o1rc"], "nsingle": ["o1rc"],
    "dpos": ["p2:o1rc"], "cnt": ["p4:xz"], "dposx": ["p4:xz"],
}
DEVICE_CANDIDATES = {
    "ref": ["dzt"], "single": ["dzt"],
    "diff": ["trans2", "trans1"], "nsingle": ["trans2", "trans1"],
    "dpos": ["p2:trans1"], "cnt": ["p4:trans1"], "dposx": ["p4:trans1"],
}
HOST_OTHER = ["o1rc", "xz"]
DEVICE_OTHER = ["trans1"]


def _trial(name: str, codec: str, raw: bytes, row: dict, dev) -> int:
    """Encode ``raw`` with ``codec`` into ``row`` (size, seconds and, for
    an on-device codec, its counters) and return the size; an on-device
    codec's blob must decode back to ``raw`` on ``dev``."""
    on_device = backend.is_device_codec(codec)
    launched = sum(cuda.launches.values())
    blocked, crossed = cuda.device_seconds(), cuda.device_bytes()
    t0 = time.perf_counter()
    blob = backend.compress(codec, raw, dev)
    row[codec + "_enc_s"] = time.perf_counter() - t0
    row[codec] = len(blob)
    if on_device:
        row[codec + "_launches"] = sum(cuda.launches.values()) - launched
        if dev.type == "cuda":
            row[codec + "_device_s"] = cuda.device_seconds() - blocked
            row[codec + "_device_bytes"] = cuda.device_bytes() - crossed
        if backend.decompress(codec, blob, len(raw), dev) != raw:
            raise SystemExit(f"codecs_table_torch: stream {name!r} coded "
                             f"with {codec} does not decode to itself")
    return len(blob)


def _set_up(dev) -> tuple[float, dict]:
    """Load the host library and, on a CUDA device, the kernels, and code
    one small stream both ways there; (seconds, launches by kernel)."""
    launched = dict(cuda.launches)
    t0 = time.perf_counter()
    native._load()
    if dev.type == "cuda":
        cuda.lib()
        raw = bytes(range(256)) * 64
        if backend.decompress("trans1", backend.compress("trans1", raw, dev),
                              len(raw), dev) != raw:
            raise SystemExit("codecs_table_torch: the set-up stream does not "
                             "decode to itself")
    return time.perf_counter() - t0, {
        k: v - launched.get(k, 0) for k, v in cuda.launches.items()
        if v > launched.get(k, 0)}


def table(path: str, dev: torch.device) -> dict:
    """The codec table of the archive at ``path``, device codecs on
    ``dev``; prints one line a stream."""
    setup_s, setup_launches = _set_up(dev)
    _, streams = container.read_container(path, device=dev)
    rows = {}
    host_total = dev_total = 0
    for name in sorted(streams):
        raw = streams[name]
        if not raw:
            continue
        row = {"raw": len(raw)}
        for fam, cands in (
                ("host", HOST_CANDIDATES.get(name, HOST_OTHER)),
                ("device", DEVICE_CANDIDATES.get(name, DEVICE_OTHER))):
            best = ("store", len(raw))
            for c in cands + ["store"]:
                if not backend.available(c):
                    continue
                n = _trial(name, c, raw, row, dev)
                if n < best[1]:
                    best = (c, n)
            row[fam + "_best"] = best[0]
            row[fam + "_bytes"] = best[1]
        host_total += row["host_bytes"]
        dev_total += row["device_bytes"]
        rows[name] = row
        print(name, json.dumps(row), flush=True)
    return {
        "what": ("Per-stream host vs on-device codec sizes of an archive; "
                 "device_archive = every stream through the device rANS "
                 "family (trans/trans1/trans2/dzt)"),
        "archive": os.path.basename(path),
        "device": dev.type,
        "setup_s": setup_s,
        "setup_launches": setup_launches,
        "streams": rows,
        "host_archive_stream_bytes": host_total,
        "device_archive_stream_bytes": dev_total,
        "device_vs_host": round(dev_total / host_total, 4),
        "gate_device_within_5pct": dev_total <= host_total * 1.05,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("archive")
    ap.add_argument("out_json", nargs="?")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the on-device codecs run (cpu: their plain "
                    "versions)")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("codecs_table_torch: no CUDA device (--device cpu runs the "
              "plain versions)", file=sys.stderr)
        return 1
    dev = torch.device(a.device, 0) if a.device == "cuda" else torch.device(
        "cpu")
    result = table(a.archive, dev)
    print(json.dumps({k: v for k, v in result.items() if k != "streams"}))
    if a.out_json:
        with open(a.out_json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
