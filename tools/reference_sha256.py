"""SHA-256 of the reference's archive for cells of BENCHMARK.json and for
the configurations of CONFIGS_torch.json.

For each cell: the cell's data (``bench_torch.make_inputs``: the reads,
profile and mate split that ``bench_torch.py`` compresses) at the
benchmark's seed, compressed by ``minicom_tpu.compressor.compress`` (the
JAX package, on the CPU) with the cell's configuration's ``settings``.
A cell's ``archive.reference_sha256`` in BENCHMARK.json is this digest at
the cell's own reads; the port's pin, ``archive.sha256``, must equal it.

For a configuration (``--config NAME``): its input
(``configs_torch.make_input``: ``bench.make_dataset``'s reads of the
entry's length at its seed, gzipped where the entry says so) compressed
with the entry's ``settings``. The entry's ``reference_sha256`` is this
digest at its own reads, and ``archive_bytes`` the archive's size.

    JAX_PLATFORMS=cpu python tools/reference_sha256.py [--cell NAME ...]
        [--config NAME ...] [--workdir DIR] [--reads N]

One JSON line a cell or configuration: its name (``cell`` or ``config``),
reads, seed, archive bytes, SHA-256 and the compress wall in seconds.
``--workdir`` holds the data (default a temporary directory; a 5M-read
cell writes ~1 GB of FASTQ); ``--reads`` cuts every cell and configuration
to N reads (default each one's own). With neither ``--cell`` nor
``--config``, every cell.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import bench_torch  # noqa: E402
import configs_torch  # noqa: E402
from minicom_tpu import compressor  # noqa: E402
from minicom_tpu.config import CompressorConfig  # noqa: E402


def reference_archive(name: str, workdir: str, reads: int | None = None,
                      benchmark=bench_torch.BENCHMARK) -> dict:
    """The reference's archive of the cell ``name`` of ``benchmark``, its
    files in ``workdir`` (removed after): bytes, SHA-256 and wall."""
    cell, config, seed = bench_torch.load_cell(name, benchmark)
    data = cell["data"]
    n = data["reads"] if reads is None else reads
    cfg = CompressorConfig(**config["settings"])
    fqs = bench_torch.make_inputs(os.path.join(workdir, "reads.fastq"), n,
                                  seed, data["profile"], cfg.paired)
    arc = os.path.join(workdir, "reference.mtc")
    t0 = time.perf_counter()
    compressor.compress(fqs[0], arc, cfg,
                        reads_path2=fqs[1] if len(fqs) > 1 else None)
    wall = time.perf_counter() - t0
    out = {"cell": name, "reads": n, "seed": seed,
           "bytes": os.path.getsize(arc), "sha256": bench_torch._sha256(arc),
           "seconds": wall}
    for path in fqs + [arc]:
        os.remove(path)
    return out


def config_archive(name: str, workdir: str, reads: int | None = None) -> dict:
    """The reference's archive of the configuration ``name`` of
    CONFIGS_torch.json, its files in ``workdir`` (removed after): bytes,
    SHA-256 and wall."""
    entry = configs_torch.config_entry(name)
    n = entry["reads"] if reads is None else reads
    sub = tempfile.mkdtemp(dir=workdir)
    fq = configs_torch.make_input(entry, sub, n)
    arc = os.path.join(sub, "reference.mtc")
    t0 = time.perf_counter()
    compressor.compress(fq, arc, CompressorConfig(**entry["settings"]))
    wall = time.perf_counter() - t0
    out = {"config": name, "reads": n, "seed": entry["seed"],
           "bytes": os.path.getsize(arc), "sha256": bench_torch._sha256(arc),
           "seconds": wall}
    shutil.rmtree(sub)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", action="append",
                    help="a name in BENCHMARK.json's workloads (default all, "
                    "where no --config is given)")
    ap.add_argument("--config", action="append", default=[],
                    help="a name in CONFIGS_torch.json")
    ap.add_argument("--workdir", help="where the data is written")
    ap.add_argument("--reads", type=int, help="reads a cell (default its own)")
    a = ap.parse_args(argv)
    with open(bench_torch.BENCHMARK) as f:
        names = a.cell or ([] if a.config else
                           [w["name"] for w in json.load(f)["workloads"]])
    with tempfile.TemporaryDirectory(dir=a.workdir) as tmp:
        for name in names:
            print(json.dumps(reference_archive(name, tmp, a.reads)),
                  flush=True)
        for name in a.config:
            print(json.dumps(config_archive(name, tmp, a.reads)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
