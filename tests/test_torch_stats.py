"""The port's host-device accounting: the crossing counters and helpers of
``minicom_tpu_torch/ops/cuda.py`` (re-exported by ``parallel/mesh.py`` under
the JAX package's names), ``StageStats``' split of them by stage, held to the
JAX package's ``StageStats``, and an AST check that every crossing in the
package goes through the helpers. Also ``entropy/backend.available``.

Every comparison here is exact unless its test says otherwise."""

import ast
import json
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from minicom_tpu import cli as jcli
from minicom_tpu import compressor as jcomp
from minicom_tpu.entropy import backend as jbackend
from minicom_tpu.parallel import mesh as jmesh
from minicom_tpu.stats import StageStats as JStageStats
from minicom_tpu_torch import cli
from minicom_tpu_torch import compressor as tcomp
from minicom_tpu_torch.entropy import backend
from minicom_tpu_torch.ops import cuda
from minicom_tpu_torch.parallel import mesh
from minicom_tpu_torch.stats import StageStats
from tests.conftest import genome_reads, write_fastq
from tests.test_torch_rans import jax_native  # noqa: F401 (autouse)

PKG = pathlib.Path(__file__).resolve().parents[1] / "minicom_tpu_torch"


@pytest.fixture
def counters():
    """Both packages' counters at 0 before and after the test."""
    jmesh.reset_device_seconds()
    cuda.reset_device_seconds()
    yield
    jmesh.reset_device_seconds()
    cuda.reset_device_seconds()


def _script(stats, account) -> dict:
    """Stages nested and repeated, with crossings of chosen (dt, nbytes)."""
    with stats.stage("upload"):
        account(0.25, 100 * 1000)
    with stats.stage("cluster"):
        account(5e-5)            # under 0.1 ms and no bytes: no key
    with stats.stage("realign"):
        account(2.5e-4)          # over 0.1 ms, no bytes: a key
    with stats.stage("merge"):
        account(0.0, 64)         # bytes alone make a key
        with stats.stage("merge_sketch"):
            account(0.0123, 7)
            account(0.0042, 9)
        account(3e-5)
    with stats.stage("entropy"):
        account(0.5, 3)
    with stats.stage("entropy"):   # entered twice: summed
        account(0.0004, 5)
    for _ in range(3):
        with stats.stage("round"):
            account(0.00049, 1)
    with stats.stage("write"):
        pass
    return stats.summary()


def _device_keys(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k.startswith("device_")}


def test_stage_split_matches_the_jax_stagestats(counters):
    want = _device_keys(_script(JStageStats(), jmesh._account))
    got_stats = StageStats()
    got = _device_keys(_script(got_stats, cuda._account))
    assert got == want
    assert "device_cluster_s" not in got and "device_write_s" not in got
    assert got["device_realign_bytes"] == 0
    assert got["device_merge_bytes"] == 64 + 7 + 9
    assert got["device_entropy_bytes"] == 8
    assert got["device_upload_bytes"] == 100 * 1000
    assert cuda.device_bytes() == jmesh.device_bytes()
    assert cuda.device_seconds() == jmesh.device_seconds()
    assert json.loads(got_stats.dump()) == got_stats.summary()


def test_mesh_exposes_the_counters_under_the_jax_names(counters):
    cuda._account(0.125, 11)
    assert (mesh.device_seconds(), mesh.device_bytes()) == (0.125, 11)
    mesh.reset_device_seconds()
    assert (cuda.device_seconds(), cuda.device_bytes()) == (0.0, 0)


def test_counters_are_thread_safe(counters):
    """8 threads x 10,000 crossings of (1e-6 s, 3 B): no update lost
    (seconds within 1e-9 of 0.08: float sums in another order)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(10_000):
                cuda._account(1e-6, 3)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert cuda.device_bytes() == 240_000
    assert abs(cuda.device_seconds() - 0.08) <= 1e-9


META = torch.device("meta")   # an upload's stand-in: no card here


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32, np.int64])
@pytest.mark.parametrize("kind", ["tensor", "numpy", "numpy_view"])
def test_to_device_counts_the_bytes_that_cross(counters, dtype, kind):
    a = np.arange(40 * 50).astype(dtype).reshape(40, 50)
    x = {"tensor": torch.from_numpy(a), "numpy": a,
         "numpy_view": a[:, ::2]}[kind]
    out = cuda.to_device(x, META)
    assert out.device == META and out.shape == x.shape
    assert out.dtype == torch.from_numpy(a).dtype
    assert cuda.device_bytes() == np.asarray(x).size * a.itemsize
    assert cuda.device_seconds() > 0


def test_same_place_copies_count_nothing(counters):
    a = np.arange(1000, dtype=np.int32)
    t = torch.from_numpy(a)
    assert cuda.to_device(t, "cpu") is t
    assert cuda.to_device(t, torch.device("cpu")) is t
    np.testing.assert_array_equal(cuda.to_device(a, "cpu").numpy(), a)
    assert cuda.to_host(t) is t
    out = torch.empty_like(t)
    assert cuda.to_host(t, out) is out
    np.testing.assert_array_equal(out.numpy(), a)
    m = cuda.to_device(t, META)
    cuda.reset_device_seconds()
    assert cuda.to_device(m, META) is m
    assert (cuda.device_seconds(), cuda.device_bytes()) == (0.0, 0)


@pytest.fixture
def fastq(tmp_path):
    path = str(tmp_path / "in.fastq")
    write_fastq(path, genome_reads(np.random.default_rng(5), 800, 90,
                                   genome_len=4000, p_n=0.002))
    return path


def test_cpu_compress_has_no_device_keys(counters, fastq, tmp_path,
                                         monkeypatch):
    """On device="cpu" nothing crosses: the archive is the JAX package's,
    and neither summary has a device_* key (the JAX package's default CPU
    run keeps every stage on the host)."""
    monkeypatch.delenv("MTC_HOST_SKETCH", raising=False)
    ja, ta = str(tmp_path / "j.mtc"), str(tmp_path / "t.mtc")
    want = jcomp.compress(fastq, ja)
    got = tcomp.compress(fastq, ta, device="cpu")
    with open(ja, "rb") as a, open(ta, "rb") as b:
        assert a.read() == b.read()
    assert _device_keys(want) == {}
    assert _device_keys(got) == {}
    assert cuda.device_bytes() == 0


# ---- every crossing goes through ops/cuda.py ------------------------------

SCANNED = ["compressor.py", "pipeline", "ops", "entropy", "parallel"]
# calls that the rule cannot tell from a crossing, by file and source text,
# each with why it does not cross
ALLOWED = {
    ("ops/sketch.py", "buf[:n].copy_(torch.from_numpy(rids))"):
        "host rids into the pinned host buffer of the upload",
}


def _is_dtype(node) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "torch"
            and isinstance(getattr(torch, node.attr, None), torch.dtype))


def _crossings(src: str):
    """The source of each call in ``src`` that may copy between host and
    device: .cpu(), .cuda(), .copy_(x), .to(x) but for a dtype conversion,
    and torch.tensor / torch.as_tensor with a device."""
    for node in ast.walk(ast.parse(src)):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        name = node.func.attr
        dtype = (any(k.arg == "dtype" for k in node.keywords)
                 or (node.args and _is_dtype(node.args[0])))
        onto = any(k.arg == "device" for k in node.keywords)
        if (name in ("cpu", "cuda", "copy_")
                or (name == "to" and not dtype)
                or (name in ("tensor", "as_tensor") and onto)):
            yield ast.get_source_segment(src, node)


@pytest.mark.parametrize("src,n", [
    ("x.to(dev)", 1), ("x.to(x.device, non_blocking=True)", 1),
    ("x.to(torch.int64)", 0), ("x.to(dtype=torch.uint8)", 0),
    ("x.cpu().numpy()", 1), ("x.cuda()", 1), ("a.copy_(b)", 1),
    ("torch.tensor([1], device=dev)", 1), ("torch.tensor([1])", 0),
    ("torch.as_tensor(a, device='cuda')", 1), ("x.view(torch.int16)", 0)])
def test_crossing_rule(src, n):
    assert len(list(_crossings(src))) == n


def test_every_crossing_goes_through_the_helpers():
    files = [PKG / "compressor.py"] + [
        p for d in SCANNED[1:] for p in sorted((PKG / d).rglob("*.py"))]
    seen, bad = set(), []
    for p in files:
        rel = p.relative_to(PKG).as_posix()
        if rel == "ops/cuda.py":
            continue
        for call in _crossings(p.read_text()):
            if (rel, call) in ALLOWED:
                seen.add((rel, call))
            else:
                bad.append(f"{rel}: {call}")
    assert not bad, "copies outside ops/cuda.py's helpers:\n" + "\n".join(bad)
    assert seen == set(ALLOWED), "allowlist entries no longer in the code"


# ---- entropy/backend.available --------------------------------------------

def _codec_choices(parser):
    return next(a.choices for a in parser._actions if a.dest == "codec")


def test_cli_codec_choices_match_the_jax_cli():
    assert _codec_choices(cli.build_parser()) == _codec_choices(
        jcli.build_parser())


@pytest.mark.parametrize("name", _codec_choices(jcli.build_parser())
                         + ["p2:o1rc", "p4:dz", "p8:dzt", "p4:trans2"])
def test_available_matches_the_jax_backend(name):
    assert backend.available(name) == jbackend.available(name)


def test_available_is_false_without_the_host_library(monkeypatch):
    def fail():
        raise RuntimeError("building _native failed")

    monkeypatch.setattr(backend.native, "_load", fail)
    assert not backend.available("o2rc") and not backend.available("p4:dzt")
    assert backend.available("xz") and backend.available("trans")

