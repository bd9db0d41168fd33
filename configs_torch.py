"""The reference's documented configurations, as the port runs them: the
table ``CONFIGS_torch.json`` and the input each entry compresses. Numpy and
the standard library, never torch or jax, so that a child interpreter
writes the inputs beside a run of the port.

An entry is one command line of the reference's users (``source``: the
reference's ``non-default-parameters.txt`` line, or the limit of its
surface it reproduces) on ``reads`` reads of ``L`` bases from
``bench.make_dataset(path, reads, L=L, seed=seed)`` (the default profile),
gzipped at level 1 where ``gzip`` is true, compressed with ``settings``
(fields of ``CompressorConfig``). ``archive_bytes`` and
``reference_sha256`` pin the JAX package's archive of that input on the
CPU (``tools/reference_sha256.py --config NAME``); the port must write
the same bytes.

    python3 configs_torch.py DIR

writes every entry's input into DIR, one file a read length and a gzip
copy where an entry asks for one, and prints each path in the table's
order.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import sys

from bench import make_dataset

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(ROOT, "CONFIGS_torch.json")


def load_configs() -> list[dict]:
    """The entries of the table, in its order."""
    with open(CONFIGS) as f:
        return json.load(f)["configs"]


def config_entry(name: str) -> dict:
    """The entry called ``name``; KeyError names the known ones."""
    entries = {e["name"]: e for e in load_configs()}
    if name not in entries:
        raise KeyError(f"{name!r} is not in {os.path.basename(CONFIGS)}: "
                       f"{sorted(entries)}")
    return entries[name]


def input_name(entry: dict, reads: int | None = None) -> str:
    """The file name of the entry's input: one a (reads, L, seed), with
    ``.gz`` for the gzip copy."""
    n = entry["reads"] if reads is None else reads
    base = f"reads_{n}_L{entry['L']}_s{entry['seed']}.fastq"
    return base + ".gz" if entry["gzip"] else base


def make_input(entry: dict, workdir: str, reads: int | None = None) -> str:
    """The entry's input in ``workdir`` (made where it is not there yet):
    ``bench.make_dataset``'s reads, and for a gzip entry their gzip stream
    at level 1 with no name or time in its header. Returns its path."""
    n = entry["reads"] if reads is None else reads
    path = os.path.join(workdir, input_name(entry, n))
    if os.path.exists(path):
        return path
    plain = os.path.join(workdir, input_name(dict(entry, gzip=False), n))
    if not os.path.exists(plain):
        make_dataset(plain + ".tmp", n, L=entry["L"], seed=entry["seed"])
        os.replace(plain + ".tmp", plain)
    if entry["gzip"]:
        with open(plain, "rb") as src, open(path + ".tmp", "wb") as raw, \
                gzip.GzipFile("", "wb", 1, raw, mtime=0) as dst:
            shutil.copyfileobj(src, dst, 1 << 24)
        os.replace(path + ".tmp", path)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dir", help="where the inputs are written")
    a = ap.parse_args(argv)
    for e in load_configs():
        print(make_input(e, a.dir), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
