"""``tools/codecs_table_torch.py``, the port's per-stream codec table, on the
CPU (``--device cpu``: the on-device codecs' plain versions): the same
sizes as ``tools/codecs_table.py`` on the same port archive, for both codec
tables; no launch and no device counter on the CPU; a device trial that
does not decode back fails the tool; without a card it exits before coding;
its import loads no JAX and builds nothing."""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from conftest import genome_reads, write_fastq
from minicom_tpu_torch import CompressorConfig, compressor
from minicom_tpu_torch.entropy import device_ctx_rans
from tests.test_torch_rans import jax_native  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
TOOL = REPO / "tools" / "codecs_table_torch.py"
_COUNTERS = ("_enc_s", "_launches", "_device_s", "_device_bytes")


def _tool():
    spec = importlib.util.spec_from_file_location("codecs_table_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """About 2,000 reads with N's, compressed by the port on the CPU with
    each codec table."""
    d = tmp_path_factory.mktemp("codecs_table")
    fq = str(d / "in.fastq")
    write_fastq(fq, genome_reads(np.random.default_rng(11), 2000, 100,
                                 p_n=0.002))
    out = {}
    for codec in ("auto", "device"):
        out[codec] = str(d / f"{codec}.mtc")
        compressor.compress(fq, out[codec], CompressorConfig(codec=codec),
                            device="cpu")
    return out


def _sizes(result, keys):
    """The table's ``keys`` but ``what``, its rows without timings and
    counters."""
    return {**{k: result[k] for k in keys if k not in ("streams", "what")},
            "streams": {name: {k: v for k, v in row.items()
                               if not k.endswith(_COUNTERS)}
                        for name, row in result["streams"].items()}}


@pytest.mark.parametrize("codec", ["auto", "device"])
def test_sizes_equal_the_jax_tool(archives, codec, tmp_path):
    want_json = tmp_path / "jax.json"
    r = subprocess.run(
        [sys.executable, str(REPO / "tools" / "codecs_table.py"),
         archives[codec], str(want_json)], cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True,
        text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    got_json = tmp_path / "port.json"
    assert _tool().main([archives[codec], str(got_json),
                         "--device", "cpu"]) == 0
    got, want = (json.loads(p.read_text()) for p in (got_json, want_json))
    assert set(got) == set(want) | {"device", "setup_s", "setup_launches"}
    assert set(got["streams"]) == set(want["streams"]) != set()
    assert _sizes(got, want) == _sizes(want, want)
    for name, row in got["streams"].items():
        assert ({k for k in row if k.endswith("_enc_s")}
                == {k for k in want["streams"][name] if k.endswith("_enc_s")})


def test_counters_on_the_cpu(archives, tmp_path):
    out = tmp_path / "t.json"
    assert _tool().main([archives["auto"], str(out), "--device", "cpu"]) == 0
    result = json.loads(out.read_text())
    assert result["device"] == "cpu" and result["setup_launches"] == {}
    tried = 0
    for row in result["streams"].values():
        assert not [k for k in row if "_device_" in k], row
        for k, v in row.items():
            if k.endswith("_launches"):
                codec = k[:-len("_launches")]
                assert v == 0 and codec + "_enc_s" in row
                tried += 1
    assert tried >= len(result["streams"])


def test_a_device_trial_that_does_not_decode_fails(archives, tmp_path,
                                                   monkeypatch):
    """The context rANS decoder (trans1, trans2) gives wrong bytes; the
    archive's own streams (host codecs) still read."""
    tool = _tool()
    monkeypatch.setattr(device_ctx_rans, "decompress",
                        lambda blob, device: b"\0")
    out = tmp_path / "t.json"
    with pytest.raises(SystemExit) as e:
        tool.main([archives["auto"], str(out), "--device", "cpu"])
    assert e.value.code not in (0, None)
    assert not out.exists()


def test_without_a_card_it_exits_before_coding(archives, tmp_path):
    out = tmp_path / "t.json"
    r = subprocess.run([sys.executable, str(TOOL), archives["auto"],
                        str(out)], cwd=tmp_path,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and r.stdout == ""
    assert not out.exists() and list(tmp_path.iterdir()) == []


def test_import_loads_no_jax_and_builds_nothing():
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('t', {str(TOOL)!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'minicom_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert 'minicom_tpu_torch.entropy.backend' in sys.modules\n"
        "import minicom_tpu_torch.ops.cuda as c\n"
        "import minicom_tpu_torch.native as n\n"
        "assert c._lib is None and n._lib is None, 'built at import'\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
