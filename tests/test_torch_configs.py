"""The configurations of CONFIGS_torch.json (the reference's documented
command lines, 50-256 bp reads, gzip input) on the CPU: each entry's input
cut to 3,000 reads, compressed by the port (``device="cpu"``, the kernels'
plain versions) and by the JAX package, must give the same archive, and the
port's decompress must give the input's reads back; the gzip entry's
archive is its plain twin's. Also the table itself, and
``tools/reference_sha256.py --config``. On the card, ``chip_smoke.py``
phase 12 runs every entry at its full 1,000,000 reads against its pin."""

import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import configs_torch
from bench_torch import decoded_rows, input_rows, sorted_rows
from minicom_tpu import CompressorConfig as JConfig
from minicom_tpu import compressor as jcomp
from minicom_tpu_torch import CompressorConfig, compressor
from tests.test_torch_rans import jax_native  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = 3000
ENTRIES = configs_torch.load_configs()
NAMES = [e["name"] for e in ENTRIES]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs of every entry at READS reads, in one directory: the
    gzip entry's beside its plain twin."""
    d = str(tmp_path_factory.mktemp("configs"))
    return d, {e["name"]: configs_torch.make_input(e, d, READS)
               for e in ENTRIES}


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _twin(entry):
    """The entry's input without gzip: the FASTQ whose reads it holds."""
    return configs_torch.input_name(dict(entry, gzip=False), READS)


@pytest.mark.parametrize("name", NAMES)
def test_archive_equals_the_jax_packages_and_decodes(tmp_path, inputs, name):
    d, fqs = inputs
    entry = configs_torch.config_entry(name)
    fq = fqs[name]
    ours, theirs, dec = (str(tmp_path / f) for f in ("port.mtc", "jax.mtc",
                                                     "port.reads"))
    summary = compressor.compress(fq, ours,
                                  CompressorConfig(**entry["settings"]),
                                  device="cpu")
    jcomp.compress(fq, theirs, JConfig(**entry["settings"]))
    assert _sha(ours) == _sha(theirs)
    assert summary["input_bytes"] == READS * (entry["L"] + 1)
    compressor.decompress(ours, dec)
    want = input_rows(os.path.join(d, _twin(entry)))
    assert want.shape == (READS, entry["L"])
    np.testing.assert_array_equal(
        sorted_rows(decoded_rows(dec, READS, entry["L"])), sorted_rows(want))


def test_gzip_archive_equals_its_plain_twins(tmp_path, inputs):
    d, fqs = inputs
    gz = [e for e in ENTRIES if e["gzip"]]
    assert gz
    for entry in gz:
        with open(fqs[entry["name"]], "rb") as f:
            assert f.read(2) == b"\x1f\x8b"
        twin = [e for e in ENTRIES if not e["gzip"]
                and (e["L"], e["seed"], e["reads"], e["settings"])
                == (entry["L"], entry["seed"], entry["reads"],
                    entry["settings"])]
        assert len(twin) == 1
        cfg = CompressorConfig(**entry["settings"])
        a, b = str(tmp_path / "gz.mtc"), str(tmp_path / "plain.mtc")
        compressor.compress(fqs[entry["name"]], a, cfg, device="cpu")
        compressor.compress(fqs[twin[0]["name"]], b, cfg, device="cpu")
        assert _sha(a) == _sha(b)
        assert entry["reference_sha256"] == twin[0]["reference_sha256"]
        assert entry["archive_bytes"] == twin[0]["archive_bytes"]


def test_the_table():
    """Every entry: a unique name, a source, seed 7 and 1,000,000 reads, L
    in the reference's range, settings that are fields of both packages'
    CompressorConfig, and a pin of 64 hex digits with its bytes."""
    ours = {f.name for f in dataclasses.fields(CompressorConfig)}
    theirs = {f.name for f in dataclasses.fields(JConfig)}
    assert len(set(NAMES)) == len(NAMES) == 8
    for e in ENTRIES:
        assert set(e) == {"name", "source", "reads", "L", "seed", "settings",
                          "gzip", "archive_bytes", "reference_sha256"}
        assert e["source"] and len(e["source"]) <= 200
        assert (e["reads"], e["seed"]) == (1_000_000, 7)
        assert 1 <= e["L"] <= 256 and isinstance(e["gzip"], bool)
        assert set(e["settings"]) <= ours & theirs, e["name"]
        assert re.fullmatch(r"[0-9a-f]{64}", e["reference_sha256"])
        assert isinstance(e["archive_bytes"], int) and e["archive_bytes"] > 0
    with open(configs_torch.CONFIGS) as f:
        assert set(json.load(f)) == {"what", "configs"}


@pytest.mark.parametrize("name,resolved", [
    ("L50-k17", (17, 3, 4, 11, 25)),
    ("L75-m20-e2-E16", (17, 20, 6, 11, 16)),
    ("L100-k17-w3-m20", (17, 3, 5, 17, 50)),
    ("L150-k25-m30-w20-e18-S5", (25, 20, 8, 17, 75)),
    ("L100-k23-e2-m30-w5-E24", (23, 5, 5, 17, 24)),
    ("L101-k25-m25-w15", (25, 15, 5, 17, 50)),
    ("L256-default", (31, 97, 15, 17, 128)),
])
def test_entries_resolve_to_the_shapes_they_stand_for(name, resolved):
    """(k, w, dictionaries, dictionary length, threshold cap) of each entry
    at its read length, equal in both packages."""
    entry = configs_torch.config_entry(name)
    for cls in (CompressorConfig, JConfig):
        r = cls(**entry["settings"]).resolve(entry["L"])
        assert (r.k, r.contig_window, r.num_dicts, r.dict_seg_len,
                r.max_threshold) == resolved


def test_unknown_entry_is_named():
    with pytest.raises(KeyError, match="L50-k17"):
        configs_torch.config_entry("L51")


def test_reference_tool_gives_the_ports_digest(tmp_path, inputs):
    """``tools/reference_sha256.py --config NAME --reads 3000`` prints the
    digest and size of the port's archive of that input."""
    name = "L50-k17-gzip"
    entry = configs_torch.config_entry(name)
    arc = str(tmp_path / "port.mtc")
    compressor.compress(inputs[1][name], arc,
                        CompressorConfig(**entry["settings"]), device="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "reference_sha256.py"),
         "--config", name, "--reads", str(READS), "--workdir",
         str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.splitlines()[-1])
    assert (out["config"], out["reads"], out["seed"]) == (name, READS, 7)
    assert (out["sha256"], out["bytes"]) == (_sha(arc), os.path.getsize(arc))
    assert sorted(os.listdir(tmp_path)) == ["port.mtc"]
