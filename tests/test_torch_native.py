"""The port's host library (``minicom_tpu_torch/native/``, its own copy of the
C++) against the JAX package's: every C entry point of ``native._SIGS``
through both packages' wrappers on the same seeded inputs, exact, at 100 and
150 bp with N in the reads and on empty inputs; each codec decoded both ways
(the port's output by the JAX decoder and the JAX output by the port's); and
the port built and run from a copy of ``minicom_tpu_torch/`` alone."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import genome_reads, write_fastq
from minicom_tpu import native as J
from minicom_tpu_torch import compressor
from minicom_tpu_torch import native as P
from minicom_tpu_torch.config import CompressorConfig
from tests.test_torch_rans import jax_native  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
_ACGT = np.frombuffer(b"ACGT", np.uint8)
_CODE = np.full(256, 4, np.uint8)
_CODE[_ACGT] = np.arange(4, dtype=np.uint8)


def _ascii(rng, n, L, genome_len=6_000):
    """[n, L] ASCII reads of one genome; row 1 holds scattered N's, row 2
    is all N."""
    reads = genome_reads(rng, n, L, genome_len=genome_len, p_n=0.002)
    if n > 2:
        reads[1, ::7] = ord("N")
        reads[2] = ord("N")
    return reads


def _substituted(codes):
    """Base codes with each N replaced by its row's majority base (ties
    A, T, G, C), as the classify stage leaves the read store."""
    counts = np.stack([(codes == c).sum(1) for c in (0, 3, 2, 1)])
    maj = np.array([0, 3, 2, 1], np.uint8)[np.argmax(counts, 0)]
    return np.where(codes == 4, maj[:, None], codes).astype(np.uint8)


def _mutated(rng, rows, rate=0.02):
    """ASCII rows with substitutions, an N-containing row and one row
    that differs everywhere."""
    out = rows.copy()
    hit = rng.random(rows.shape) < rate
    out[hit] = _ACGT[rng.integers(0, 4, hit.sum())]
    if len(out) > 3:
        out[1, 3::11] = ord("N")
        out[3] = _ACGT[(_CODE[rows[3]] + 1) % 4]
    return out


def _contigs(rng, n_contigs, L):
    """Contig codes 0..3 (lengths L to 4L) flat, with their pointers."""
    lens = rng.integers(L, 4 * L, n_contigs)
    flat = rng.integers(0, 4, int(lens.sum()), dtype=np.uint8)
    return flat, np.r_[0, np.cumsum(lens)].astype(np.int64)


def _windowed(rng, L, empty):
    """Inputs of the windowed diff: reference codes, each read's window
    base, read codes (4 for N) and strands."""
    n = 0 if empty else 300
    ref, _ = _contigs(rng, 8, L)
    base = rng.integers(0, len(ref) - L, n).astype(np.int64)
    reads = _CODE[_mutated(rng, _ACGT[ref[base[:, None] + np.arange(L)]])]
    dirs = (rng.random(n) < 0.5).astype(np.int8)
    reads[dirs == 1] = np.where(reads[dirs == 1] == 4, 4,
                                3 - reads[dirs == 1])[:, ::-1]
    return ref, base, reads.reshape(n, L), dirs


def _dna_bytes(rng, L, empty):
    """2-bit-packed bases with repeats and reverse-complement repeats."""
    if empty:
        return b""
    g = rng.integers(0, 4, 40 * L, dtype=np.uint8)
    parts = [g]
    for _ in range(30):
        s = int(rng.integers(0, len(g) - 2 * L))
        seg = g[s:s + int(rng.integers(L // 2, 2 * L))]
        parts.append(3 - seg[::-1] if rng.random() < 0.5 else seg)
    codes = np.concatenate(parts)
    codes = codes[:len(codes) // 4 * 4].reshape(-1, 4)
    return (codes[:, 0] | codes[:, 1] << 2 | codes[:, 2] << 4
            | codes[:, 3] << 6).astype(np.uint8).tobytes()


def _text(rng, L, empty):
    """A diff-text stream of the reads."""
    if empty:
        return b""
    ref = _ascii(rng, 400, L)
    return P.diff_encode(ref, _mutated(rng, ref), 0)


def _streams(rng, L, empty):
    """(family, raw) pairs of the range coders."""
    return [("o1rc", _text(rng, L, empty)), ("o2rc", _text(rng, L, empty)),
            ("dnarc", _dna_bytes(rng, L, empty))]


def _cluster_meta(rng, L, empty):
    C = 0 if empty else 60
    cnt = rng.integers(0, 12, C).astype(np.uint32)
    M = int(cnt.sum())
    esc = 0xFFFF
    d16 = rng.integers(0, L, M).astype(np.uint16)
    d16[rng.random(M) < 0.1] = esc
    dx = rng.integers(esc, 1 << 20, int((d16 == esc).sum())).astype(np.uint32)
    dirbits = rng.integers(0, 256, (M + 7) // 8).astype(np.uint8)
    return cnt, d16, dx, dirbits, M, L, esc


def _members(rng, L, empty):
    """Clusters of reads placed in disjoint column ranges."""
    codes = _substituted(_CODE[_ascii(rng, 500, L)])
    C = 0 if empty else 40
    size = rng.integers(1, 9, C)
    widths = L + rng.integers(0, L, C)
    colptr = np.r_[0, np.cumsum(widths)].astype(np.int64)
    segptr = np.r_[0, np.cumsum(size)].astype(np.int64)
    seg = np.repeat(np.arange(C), size)
    col = colptr[seg] + (rng.random(len(seg)) * (widths[seg] - L + 1)
                         ).astype(np.int64)
    rid2d = (rng.integers(0, len(codes), len(seg)) * 2
             + rng.integers(0, 2, len(seg))).astype(np.int32)
    return codes, rid2d, col, segptr, colptr, int(colptr[-1])


def _index(rng, empty):
    """Merge index entries and probes sharing few keys, so buckets
    overflow the cap."""
    def entries(n):
        return (rng.integers(0, 40, n).astype(np.uint32),
                rng.integers(0, 30, n).astype(np.int64),
                rng.integers(0, 500, n).astype(np.int32),
                rng.integers(0, 2, n).astype(np.int8))
    return (*entries(0 if empty else 900), *entries(0 if empty else 700))


def _case_diff_encode(rng, L, empty):
    ref = _ascii(rng, 0 if empty else 400, L)
    read = _mutated(rng, ref)
    return [(f.diff_encode(ref, read, 0), f.diff_encode(ref, read, 1))
            for f in (P, J)]


def _case_diff_decode(rng, L, empty):
    ref = _ascii(rng, 0 if empty else 400, L)
    out = []
    for rule in (0, 1):
        text = P.diff_encode(ref, _mutated(rng, ref), rule)
        out.append([f.diff_decode(text, ref, len(ref)) for f in (P, J)])
    return list(zip(*out))


def _case_diff_encode_lengths(rng, L, empty):
    ref = _ascii(rng, 0 if empty else 400, L)
    read = _mutated(rng, ref)
    return [(f.diff_encode_lengths(ref, read, 0),
             f.diff_encode_lengths(ref, read, 1)) for f in (P, J)]


def _case_diff_encode_win(rng, L, empty):
    ref, base, reads, dirs = _windowed(rng, L, empty)
    return [f.diff_encode_win(ref, base, reads, dirs, 0) for f in (P, J)]


def _case_diff_decode_win_strided(rng, L, empty):
    ref, base, reads, dirs = _windowed(rng, L, empty)
    text = P.diff_encode_win(ref, base, reads, dirs, 0)
    n = len(reads)
    lines = np.full((n, L + 1), ord("\n"), np.uint8)
    got = P.diff_decode_win(text, ref, base, dirs, n, L, lines[:, :L])
    return [np.array(got), J.diff_decode_win(text, ref, base, dirs, n, L)]


def _case_decode_cluster_meta(rng, L, empty):
    args = _cluster_meta(rng, L, empty)
    return [f.decode_cluster_meta(*args) for f in (P, J)]


def _case_dz_encode(rng, L, empty):
    data = _dna_bytes(rng, L, empty)
    return [f.dz_encode(data) for f in (P, J)]


def _case_dz_decode(rng, L, empty):
    data = _dna_bytes(rng, L, empty)
    blob = P.dz_encode(data)
    return [f.dz_decode(blob, len(data)) for f in (P, J)]


def _case_dz_encode_parts(rng, L, empty):
    data = _dna_bytes(rng, L, empty)
    return [f.dz_encode_parts(data) for f in (P, J)]


def _case_dz_decode_parts(rng, L, empty):
    data = _dna_bytes(rng, L, empty)
    tok, nt, lit = P.dz_encode_parts(data)
    return [f.dz_decode_parts(tok, nt, lit, len(data)) for f in (P, J)]


def _case_rc_encode_blocked(rng, L, empty):
    streams = _streams(rng, L, empty)
    return [[f.rc_encode(fam, raw) for fam, raw in streams] for f in (P, J)]


def _case_rc_decode_blocked(rng, L, empty):
    streams = _streams(rng, L, empty)
    blobs = [(fam, P.rc_encode(fam, raw), len(raw)) for fam, raw in streams]
    return [[f.rc_decode(*b) for b in blobs] for f in (P, J)]


def _case_realign_probe(rng, L, empty):
    cfg = CompressorConfig().resolve(L)
    ref, ptr = _contigs(rng, 30, L)
    n = 0 if empty else 400
    c = rng.integers(0, len(ptr) - 1, n)
    off = (rng.random(n) * (ptr[c + 1] - ptr[c] - L + 1)).astype(np.int64)
    sg = _substituted(_CODE[_mutated(rng, _ACGT[
        ref[(ptr[c] + off)[:, None] + np.arange(L)]], 0.01)]).reshape(n, L)
    flip = rng.random(n) < 0.5
    sg[flip] = 3 - sg[flip][:, ::-1]
    sg[n // 2:n // 2 + 20] = rng.integers(0, 4, (min(20, n), L))
    starts = np.array([s for s, _ in cfg.dict_ranges()], np.int32)
    out = []
    for thr in (cfg.diff_threshold, cfg.diff_threshold + 3 * cfg.thr_step):
        out.append([f.realign_probe(ref, ptr, sg, starts, cfg.dict_seg_len,
                                    thr, cfg.max_search, thr <= 24)
                    for f in (P, J)])
    return list(zip(*out))


def _fastq(rng, L, empty):
    if empty:
        return b""
    reads = _ascii(rng, 300, L)
    return b"".join(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), b"I" * L)
                    for i, r in enumerate(reads))


def _case_fastq_scan(rng, L, empty):
    data = _fastq(rng, L, empty)
    out = [f.fastq_parse_codes(data) for f in (P, J)]
    if empty:
        return out
    lines = data.split(b"\n")
    longer = b"\n".join([lines[0], lines[1] + b"A"] + lines[2:])
    for bad in (data + b"@x\nAC\n", longer):
        for f in (P, J):
            with pytest.raises(ValueError):
                f.fastq_parse_codes(bad)
    return out


_case_fastq_extract = _case_fastq_scan


def _case_set_num_threads(rng, L, empty):
    ref = _ascii(rng, 0 if empty else 2000, L)
    read = _mutated(rng, ref)
    out = []
    for f in (P, J):
        got = []
        for n in ((0,) if empty else (1, 3, os.cpu_count())):
            f.set_threads(n)
            got.append(f.diff_encode_lengths(read, ref, 0))
        out.append(got)
    return out


def _case_score_overlaps(rng, L, empty):
    ref, ptr = _contigs(rng, 20, L)
    n = 0 if empty else 500
    a = rng.integers(0, 20, n)
    b = rng.integers(0, 20, n)
    d = rng.integers(-4 * L, 4 * L, n)
    return [f.score_overlaps(ref, ptr, a, b, d, 8) for f in (P, J)]


def _case_sketch_windowed_host(rng, L, empty):
    ref, ptr = _contigs(rng, 0 if empty else 40, L)
    starts, lens = ptr[:-1], np.diff(ptr).astype(np.int32)
    if not empty:
        lens[0] = 10                           # shorter than k
    rows = len(starts)
    we = rng.integers(3, 20, rows).astype(np.int32)
    mcap = rng.integers(4, 25, rows).astype(np.int32)
    return [f.sketch_windowed_host(ref, starts, lens, 17, we, mcap, 24)
            for f in (P, J)]


def _case_sketch_reads_host(rng, L, empty):
    codes = _substituted(_CODE[_ascii(rng, 300, L)])
    codes[4] = 0                               # no k-mer is canonical twice
    rids = rng.integers(0, len(codes), 0 if empty else 500)
    return [[f.sketch_reads_host(codes, rids, k) for k in (31, 30, 4)]
            for f in (P, J)]


def _case_popcounts_at(rng, L, empty):
    codes = _substituted(_CODE[_ascii(rng, 300, L)])
    rids = rng.integers(0, len(codes), 0 if empty else 500)
    return [f.popcounts_at(codes, rids) for f in (P, J)]


def _case_probe_index_pairs(rng, L, empty):
    args = _index(rng, empty)
    return [f.probe_index_pairs(*args, 4) for f in (P, J)]


def _case_consensus_host(rng, L, empty):
    args = _members(rng, L, empty)
    return [[f.consensus_host(*args, want_ref, want_diffs)
             for want_ref, want_diffs in ((True, True), (True, False),
                                          (False, True))] for f in (P, J)]


def _size(x) -> int:
    """Elements and bytes in an output, summed through nested tuples."""
    if isinstance(x, (tuple, list)):
        return sum(_size(y) for y in x)
    return x.size if isinstance(x, np.ndarray) else len(x) if isinstance(
        x, bytes) else 0


def _same(a, b, where="out"):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, where


ENTRY_POINTS = sorted(P._SIGS)


def test_every_entry_point_has_a_case():
    assert [e for e in ENTRY_POINTS if f"_case_{e}" not in globals()] == []


@pytest.mark.parametrize("shape", ["L100", "L150", "empty"])
@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_equals_the_jax_package(entry, shape):
    L = 150 if shape == "L150" else 100
    rng = np.random.default_rng(ENTRY_POINTS.index(entry) * 7 + L)
    got, want = globals()[f"_case_{entry}"](rng, L, shape == "empty")
    assert _size(got) > 0 or shape == "empty", "the case made no output"
    _same(got, want)


def _encode_decode(codec, rng, L):
    """(encode, decode, raw) of one codec for each package; decode takes
    the encoded form and gives back what ``raw`` holds."""
    if codec in ("o1rc", "o2rc", "dnarc"):
        raw = (_dna_bytes(rng, L, False) if codec == "dnarc"
               else _text(rng, L, False))
        return raw, [(lambda f=f: f.rc_encode(codec, raw),
                      lambda blob, f=f: f.rc_decode(codec, blob, len(raw)))
                     for f in (P, J)]
    if codec == "dz":
        raw = _dna_bytes(rng, L, False)
        return raw, [(lambda f=f: f.dz_encode(raw),
                      lambda blob, f=f: f.dz_decode(blob, len(raw)))
                     for f in (P, J)]
    if codec == "dz_parts":
        raw = _dna_bytes(rng, L, False)
        return raw, [(lambda f=f: f.dz_encode_parts(raw),
                      lambda parts, f=f: f.dz_decode_parts(*parts, len(raw)))
                     for f in (P, J)]
    if codec == "diff":
        ref = _ascii(rng, 400, L)
        raw = _mutated(rng, ref)
        return raw, [(lambda f=f: f.diff_encode(ref, raw, 0),
                      lambda text, f=f: f.diff_decode(text, ref, len(ref)))
                     for f in (P, J)]
    ref, base, reads, dirs = _windowed(rng, L, False)
    raw = np.frombuffer(b"ACGTN", np.uint8)[reads]   # the reads' own strand
    n = len(reads)
    return raw, [
        (lambda f=f: f.diff_encode_win(ref, base, reads, dirs, 0),
         lambda text, f=f: np.array(f.diff_decode_win(
             text, ref, base, dirs, n, L, np.empty((n, L), np.uint8))))
        for f in (P, J)]


@pytest.mark.parametrize("L", [100, 150])
@pytest.mark.parametrize("codec", ["diff", "diff_win", "o1rc", "o2rc",
                                   "dnarc", "dz", "dz_parts"])
def test_codec_decodes_both_ways(codec, L):
    """The port's output through the JAX package's decoder, and the JAX
    output through the port's."""
    raw, ((p_enc, p_dec), (j_enc, j_dec)) = _encode_decode(
        codec, np.random.default_rng(L), L)
    _same(j_dec(p_enc()), raw, "JAX decode of the port's output")
    _same(p_dec(j_enc()), raw, "port decode of the JAX output")


def test_sources_are_the_ports_own():
    own = REPO / "minicom_tpu_torch" / "native"
    assert len(P._SRCS) == 7
    for src in P._SRCS:
        assert pathlib.Path(src).parent == own and os.path.isfile(src), src


def test_port_builds_and_runs_without_the_jax_package(tmp_path):
    """``minicom_tpu_torch/`` alone (no ``_build/``), with no
    ``minicom_tpu/`` beside it: its library builds there and a CPU
    compress -> decompress is exact and writes the repo tree's archive."""
    copy = tmp_path / "alone"
    shutil.copytree(REPO / "minicom_tpu_torch", copy / "minicom_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    assert sorted(p.name for p in copy.iterdir()) == ["minicom_tpu_torch"]
    reads = genome_reads(np.random.default_rng(3), 1500, 100, p_n=0.001)
    fq = tmp_path / "in.fastq"
    write_fastq(str(fq), reads)
    code = (
        "import sys\n"
        "sys.path[:] = [p for p in sys.path if p not in ('', %r)]\n"
        "sys.path.insert(0, %r)\n"
        "from minicom_tpu_torch import compressor, native\n"
        "assert native._SRC_DIR.startswith(%r), native._SRC_DIR\n"
        "compressor.compress(sys.argv[1], sys.argv[2], device='cpu')\n"
        "compressor.decompress(sys.argv[2], sys.argv[3])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'minicom_tpu')]\n"
        "assert not bad, bad\n" % (str(REPO), str(copy), str(copy)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", code, str(fq), str(tmp_path / "alone.mtc"),
         str(tmp_path / "alone.reads")], cwd=copy, env=env,
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert list((copy / "minicom_tpu_torch" / "_build").glob("_native-*.so"))
    got = sorted((tmp_path / "alone.reads").read_bytes().splitlines())
    assert got == sorted(r.tobytes() for r in reads)
    compressor.compress(str(fq), str(tmp_path / "repo.mtc"), device="cpu")
    assert ((tmp_path / "alone.mtc").read_bytes()
            == (tmp_path / "repo.mtc").read_bytes())


# Runs the realign probe with the OpenMP team set to 1, then 8, threads,
# in a process of its own (the team size is process-wide).
_THREADS_CHILD = """
import sys
import numpy as np
from minicom_tpu_torch import native
a = dict(np.load(sys.argv[1]))
out = {}
for t in (1, 8):
    native.set_threads(t)
    for j, thr in enumerate(a["thrs"]):
        got = native.realign_probe(a["ref"], a["ptr"], a["sg"], a["starts"],
                                   int(a["seg"]), int(thr), int(a["search"]),
                                   int(thr) <= 24)
        for i, x in enumerate(got):
            out[f"t{t}_{j}_{i}"] = x
np.savez(sys.argv[2], **out)
"""


def test_realign_winners_do_not_depend_on_the_thread_count(tmp_path):
    """The realign probe's winners at 1 and at 8 OpenMP threads are the
    same, and the JAX package's, on the shape of CONFIGS_torch.json's
    L150-k25-m30-w20-e18-S5 (8 dictionaries of 17 bases, the ladder's
    thresholds 18 to 73 in steps of 5): 1,500 reads from a 6 kb genome
    with repeats, against 120 contigs cut from it that overlap, so most
    reads have tied placements in several contigs that different threads
    scan."""
    cfg = CompressorConfig(k=25, first_minimizers=30, contig_window=20,
                           diff_threshold=18, thr_step=5).resolve(150)
    assert (cfg.num_dicts, cfg.dict_seg_len, cfg.max_threshold) == (8, 17, 75)
    rng = np.random.default_rng(150)
    genome = rng.integers(0, 4, 6_000, dtype=np.uint8)
    genome[3_000:4_000] = genome[1_000:2_000]       # a repeat
    lens = rng.integers(150, 900, 120)
    at = rng.integers(0, len(genome) - lens)
    ref = np.concatenate([genome[a:a + n] for a, n in zip(at, lens)])
    ptr = np.r_[0, np.cumsum(lens)].astype(np.int64)
    pick = rng.integers(0, len(genome) - 150, 1_500)
    sg = _substituted(_CODE[_mutated(rng, _ACGT[
        genome[pick[:, None] + np.arange(150)]], 0.03)])
    flip = rng.random(len(sg)) < 0.5
    sg[flip] = 3 - sg[flip][:, ::-1]
    starts = np.array([s for s, _ in cfg.dict_ranges()], np.int32)
    thrs = np.arange(cfg.diff_threshold, cfg.max_threshold, cfg.thr_step)
    np.savez(tmp_path / "in.npz", ref=ref, ptr=ptr, sg=sg, starts=starts,
             seg=cfg.dict_seg_len, search=cfg.max_search, thrs=thrs)
    r = subprocess.run([sys.executable, "-c", _THREADS_CHILD,
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = np.load(tmp_path / "out.npz")
    for j, thr in enumerate(thrs):
        want = J.realign_probe(ref, ptr, sg, starts, cfg.dict_seg_len,
                               int(thr), cfg.max_search, thr <= 24)
        one = tuple(got[f"t1_{j}_{i}"] for i in range(5))
        eight = tuple(got[f"t8_{j}_{i}"] for i in range(5))
        _same(one, eight, f"thr {thr}: 1 and 8 threads")
        _same(one, want, f"thr {thr}: the JAX package's")
        assert len(one[0]) > 0.8 * len(sg)
