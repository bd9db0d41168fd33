"""``tools/kernel_bench_torch.py``, the port's kernel table, on the CPU
(``--device cpu``: the plain versions, counts only): a fresh interpreter
that runs it loads no JAX and builds nothing; every row's ``rw_bytes`` and
``ops`` equal a count by hand, with the data-dependent quantities (the
contig sketch's kept entries, the rANS words, the coded stream, the step's
segments) taken from the JAX package on the same inputs; each count shared
with ``tools/kernel_bench.py`` equals the JAX tool's formula (written out
below with its lines) or differs from it by what the row's ``detail``
states; without a card the tool exits 1 and writes nothing."""

import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minicom_tpu.entropy import device_ctx_rans as jax_ctx_rans
from minicom_tpu.entropy import device_rans as jax_rans
from minicom_tpu.ops.sketch import sketch_windowed_compact32 as jax_windowed
from minicom_tpu.ops.step import cluster_step as jax_cluster_step

REPO = pathlib.Path(__file__).resolve().parents[1]
TOOL = REPO / "tools" / "kernel_bench_torch.py"
SCALE = 64
ROWS = ["sketch_windowed_cuda", "sketch_reads_cuda", "consensus_vote_cuda",
        "popcount_verify_cuda", "rans_encode_cuda", "rans_decode_cuda",
        "ctx_rans_decode_e2e", "cluster_step_keys_cuda", "cluster_step_sort",
        "cluster_step_segments_cuda", "cluster_step_vote_cuda"]
TIMES = ("ms_cold", "ms_cold_clean", "ms_warm", "share_cold",
         "share_cold_clean", "share_warm", "GBps_cold", "ms_cold_quarter",
         "GBps_marginal", "library_ms")

# tools/kernel_bench.py's rw at its shapes: (rows, Lmax, m) = (2048, 512,
# 48) at :96-102; (N, L) = (2^17, 100) at :111-118; (M, L, Tp) = (2^17,
# 100, 2^16) at :126-143; (Nv, W) = (2^18, 7) at :151-159; nb = BLOCK =
# 2^20 at :168-183 (encode and decode); nbc = 2^21 at :210-233
JAX_RW = {
    "sketch_windowed_cuda": lambda n: n * 512 + n * (2 * 48 * 4 + 4),
    "sketch_reads_cuda": lambda n: n * 100 + n * 12,
    "consensus_vote_cuda": lambda n: n * 100 + n * 8 + 2 * (1 << 16) * 4 * 4,
    "popcount_verify_cuda": lambda n: 2 * n * 7 * 4 + n * 4,
    "rans_encode_cuda": lambda n: n + n // 2,
    "rans_decode_cuda": lambda n: n + n // 2,
    "ctx_rans_decode_e2e": lambda n: n + n // 2,
}
FULL_N = {"sketch_windowed_cuda": 2048, "sketch_reads_cuda": 1 << 17,
          "consensus_vote_cuda": 1 << 17, "popcount_verify_cuda": 1 << 18,
          "rans_encode_cuda": 1 << 20, "rans_decode_cuda": 1 << 20,
          "ctx_rans_decode_e2e": 1 << 21, "cluster_step_keys_cuda": 1 << 20,
          "cluster_step_sort": 1 << 20, "cluster_step_segments_cuda": 1 << 20,
          "cluster_step_vote_cuda": 1 << 20}


def _tool():
    spec = importlib.util.spec_from_file_location("kernel_bench_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod    # the tool's dataclass looks itself up
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """The tool at --device cpu --scale SCALE in a fresh interpreter: (its
    table, its wall, the foreign modules it held at its end, whether
    importing it built the kernels)."""
    out = tmp_path_factory.mktemp("kernel_bench") / "k.json"
    code = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('kb', {str(TOOL)!r})\n"
        "kb = sys.modules['kb'] = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(kb)\n"
        "built = kb.cuda._lib is not None\n"
        f"rc = kb.main(['--device', 'cpu', '--scale', '{SCALE}', '--out', "
        f"{str(out)!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'minicom_tpu', 'triton'))\n"
        "print(json.dumps({'rc': rc, 'bad': bad, 'built': built}))\n")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    assert r.returncode == 0, r.stderr
    status = json.loads(r.stdout.strip().splitlines()[-1])
    assert status["rc"] == 0
    return json.loads(out.read_text()), wall, status


@pytest.fixture(scope="module")
def inputs():
    return _tool().inputs(SCALE)


def test_run_imports_no_jax_and_builds_nothing(cpu_run):
    _, _, status = cpu_run
    assert status["bad"] == []
    assert not status["built"]


def test_cpu_run_is_whole_quick_and_untimed(cpu_run):
    table, wall, _ = cpu_run
    assert wall < 30
    assert list(table["rows"]) == ROWS
    assert table["device"]["name"] == "cpu" and table["scale"] == SCALE
    assert table["peaks"] == {"hbm_bytes_s": 3.35e12, "int_ops_s": 16.75e12}
    for name, row in table["rows"].items():
        assert [row[k] for k in TIMES] == [None] * len(TIMES), name
        assert row["launches"] == {}
        assert row["n"] == FULL_N[name] // SCALE
        assert row["n_quarter"] == row["n"] // 4
        by_bytes = row["rw_bytes"] / 3.35e12 * 1e3
        by_ops = row["ops"] / 16.75e12 * 1e3
        assert row["bound_ms"] == pytest.approx(max(by_bytes, by_ops),
                                                rel=1e-12)
        assert row["bound_by"] == ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _windowed_needed(codes, k=31, w=19, mb=48):
    """(k-mer starts the rows need, entries kept), from the JAX sketch."""
    rows, L = codes.shape
    flat = np.asarray(jax_windowed(jnp.asarray(codes), jnp.full(
        rows, L, jnp.int32), k, w, mb))
    meta = flat[rows * mb: 2 * rows * mb].reshape(rows, mb).astype(np.int64)
    nv = flat[2 * rows * mb:].astype(np.int64)
    S = L - k + 1
    last = meta[np.arange(rows), np.maximum(nv - 1, 0)] >> 1
    need = np.where(nv >= mb, np.minimum(S, last - k + 1 + min(w, S)), S)
    return int(need.sum()), int(nv.sum())


def _rans_words(syms, whole):
    """Words that the JAX package's order-0 encode emits for ``syms`` with
    the table of ``whole`` (the JAX tool's way, :166-186)."""
    n = len(syms)
    T = jax_rans._tier(max(1, -(-n // 128)))
    grid = np.zeros(T * 128, np.uint8)
    grid[:n] = syms
    freq_d, cum_d, _ = jax_rans._tables(jax_rans.quantize_freqs(
        np.bincount(whole, minlength=256)))
    valid = (np.arange(T * 128) < n).reshape(T, 128)
    _, _, counts = jax_rans._encode_program(T)(
        jnp.asarray(grid.reshape(T, 128)), jnp.asarray(valid), freq_d, cum_d)
    return int(np.asarray(counts).sum())


def _hand(name, n, inp):
    """(rw_bytes, ops) of row ``name`` at count ``n``, by hand."""
    if name == "sketch_windowed_cuda":
        need, _ = _windowed_needed(inp["windowed"][:n])
        return n * 512 + 12 * n + n * (8 * 48 + 4), need * 42
    if name == "sketch_reads_cuda":
        return n * 100 + 16 * n, n * 70 * 21
    if name == "consensus_vote_cuda":
        return n * 116 + (1 << 16) + 4 * n, n * 100 * 7 + (1 << 16) * 9
    if name == "popcount_verify_cuda":
        return 2 * n * 7 * 4 + 4 * n, n * 7 * 3
    if name in ("rans_encode_cuda", "rans_decode_cuda"):
        T = max(256, 1 << int(np.ceil(np.log2(n / 128))))
        # the quarter keeps the whole block's table, as the JAX tool's
        words = _rans_words(inp["rans"][:n], inp["rans"])
        if name == "rans_encode_cuda":
            return n + 512 + 1024 + 2 * words, T * 128 * 14
        return 1024 + 2 * words + 512 + T * 128, T * 128 * (18 + 8)
    if name == "ctx_rans_decode_e2e":
        data = inp["ctx"][:n].tobytes()
        T = max(256, 1 << int(np.ceil(np.log2(n / 128))))
        return (len(jax_ctx_rans.compress(data, k=2)) + n,
                T * 128 * (18 + 4))
    N, L, span = n, 100, n * 200
    seg_id = np.asarray(jax_cluster_step(jnp.asarray(inp["step"][:N]), 31,
                                         span)[3])
    nseg = int(seg_id.max()) + 1
    return {"cluster_step_keys_cuda": (24 * N, 6 * N),
            "cluster_step_sort": (24 * N, 0),
            "cluster_step_segments_cuda": (20 * N + 4 * (3 * N + 2 * nseg
                                                         + 2), 4 * N),
            "cluster_step_vote_cuda": (N * 116 + 8 * nseg + 5 * span,
                                       N * 100 * 7 + span * 12)}[name]


@pytest.mark.parametrize("name", ROWS)
def test_counts_equal_hand_counts(cpu_run, inputs, name):
    row = cpu_run[0]["rows"][name]
    assert (row["rw_bytes"], row["ops"]) == _hand(name, row["n"], inputs)
    assert (row["rw_bytes_quarter"], row["ops_quarter"]) == _hand(
        name, row["n_quarter"], inputs)


def _stated_diff(name, n, row):
    """rw_bytes - jax_rw_bytes as the row's detail states it."""
    if name == "sketch_windowed_cuda":
        return 12 * n
    if name == "sketch_reads_cuda":
        return 4 * n
    if name == "consensus_vote_cuda":
        return 12 * n - 31 * (1 << 16)
    if name == "popcount_verify_cuda":
        return 0
    if name == "rans_encode_cuda":
        return 1536 + 2 * row["words"] - n // 2
    if name == "rans_decode_cuda":
        return 1536 + 2 * row["words"] + 128 * row["T"] - n - n // 2
    return row["blob_bytes"] - n // 2


@pytest.mark.parametrize("name", list(JAX_RW))
def test_counts_against_the_jax_tool(cpu_run, name):
    """At SCALE the row holds the JAX tool's count and differs from it by
    what its detail states; at scale 1 the tool's count functions differ
    from the JAX formula by the same rule."""
    row = cpu_run[0]["rows"][name]
    n = row["n"]
    assert row["jax_row"].split()[0] in (
        "sketch_windowed_pallas", "sketch_reads_dyn", "consensus_scatter",
        "popcount_verify_pallas", "rans_encode", "rans_decode",
        "ctx_rans_decode_e2e")
    assert row["jax_rw_bytes"] == JAX_RW[name](n)
    assert row["rw_minus_jax"] == _stated_diff(name, n, row)
    assert row["rw_bytes"] - row["jax_rw_bytes"] == row["rw_minus_jax"]
    assert ("rw_bytes - jax_rw_bytes" in row["detail"]
            or "equals the JAX count" in row["detail"])

    tool = _tool()
    n1 = FULL_N[name]
    assert tool.jax_rw_bytes(name, n1) == JAX_RW[name](n1)
    T, words, blob = 8192, 123_457, 654_321    # any data-dependent values
    rw1 = {"sketch_windowed_cuda": lambda: tool.windowed_work(n1, 0)[0],
           "sketch_reads_cuda": lambda: tool.reads_work(n1)[0],
           "consensus_vote_cuda": lambda: tool.vote_work(n1)[0],
           "popcount_verify_cuda": lambda: tool.verify_work(n1)[0],
           "rans_encode_cuda": lambda: tool.encode_work(n1, T, 256, 1,
                                                        words)[0],
           "rans_decode_cuda": lambda: tool.decode_work(T, 256, 1, words)[0],
           "ctx_rans_decode_e2e": lambda: tool.ctx_work(n1, blob, T, 16)[0]
           }[name]()
    assert rw1 - JAX_RW[name](n1) == _stated_diff(
        name, n1, {"words": words, "T": T, "blob_bytes": blob})


def test_windowed_kept_entries_equal_the_jax_sketch(cpu_run, inputs):
    row = cpu_run[0]["rows"]["sketch_windowed_cuda"]
    need, kept = _windowed_needed(inputs["windowed"][:row["n"]])
    assert (row["needed_starts"], row["kept"]) == (need, kept)


def test_inputs_are_the_jax_tools(inputs):
    """The JAX tool's draws, in its order, at SCALE's shapes."""
    rng = np.random.default_rng(5)
    rows, N, M = 2048 // SCALE, (1 << 17) // SCALE, (1 << 17) // SCALE
    np.testing.assert_array_equal(
        inputs["windowed"], rng.integers(0, 4, (rows, 512), dtype=np.uint8))
    np.testing.assert_array_equal(
        inputs["store"], rng.integers(0, 4, (N, 100), dtype=np.uint8))
    np.testing.assert_array_equal(inputs["rd"], rng.integers(0, N, M) * 2)
    np.testing.assert_array_equal(inputs["col"],
                                  rng.integers(0, (1 << 16) - 100, M))
    for x in "ab":
        np.testing.assert_array_equal(inputs[x], rng.integers(
            0, 2**32, ((1 << 18) // SCALE, 7), dtype=np.uint32))
    np.testing.assert_array_equal(inputs["rans"], rng.choice(
        np.arange(8, dtype=np.uint8), (1 << 20) // SCALE,
        p=[.4, .2, .1, .1, .08, .06, .04, .02]))
    steps = np.random.default_rng(5).integers(-1, 2, (1 << 21) // SCALE)
    np.testing.assert_array_equal(inputs["ctx"],
                                  (steps.cumsum() % 16 + 48).astype(np.uint8))


def test_no_card_exits_1_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "k.json"
    assert _tool().main(["--out", str(out)]) == 1
    assert not out.exists()


@pytest.mark.parametrize("scale", ["0", "513"])
def test_scale_out_of_range_is_refused(tmp_path, scale):
    out = tmp_path / "k.json"
    with pytest.raises(SystemExit):
        _tool().main(["--device", "cpu", "--scale", scale, "--out",
                      str(out)])
    assert not out.exists()
