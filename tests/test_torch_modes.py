"""Order-preserving (-p) and paired-end (-1/-2) modes of minicom_tpu_torch
(device="cpu": the kernels' plain PyTorch versions) against minicom_tpu.

The serializer's streams must equal the JAX package's at the stage boundary,
the archives must be byte-identical, and each package must decode the
other's archive exactly: ORDER line for line, PE pair for pair. Exact
equality throughout."""

import dataclasses

import numpy as np
import pytest

from minicom_tpu import CompressorConfig as JConfig
from minicom_tpu import compressor as jcomp
from minicom_tpu.io import container as jcontainer
from minicom_tpu.ops.pack import ascii_to_codes
from minicom_tpu.pipeline import classify as jclassify
from minicom_tpu.pipeline import cluster as jcluster
from minicom_tpu.pipeline import decode as jdecode
from minicom_tpu.pipeline import encode as jencode
from minicom_tpu.pipeline import merge as jmerge
from minicom_tpu.pipeline import realign as jrealign
from minicom_tpu_torch import CompressorConfig, from_reference
from minicom_tpu_torch import compressor as tcomp
from minicom_tpu_torch.io import container
from minicom_tpu_torch.pipeline import classify as tclassify
from minicom_tpu_torch.pipeline import decode as tdecode
from minicom_tpu_torch.pipeline import encode as tencode
from tests.conftest import genome_reads, random_reads, write_fastq
from tests.test_param_sweep import SWEEP
from tests.test_roundtrip import _special_reads
from tests.test_torch_rans import jax_native  # noqa: F401 (autouse)


def _reads(rng, n, L, n_random=20):
    """Genome reads with errors and Ns, random reads and every special
    class, shuffled."""
    reads = np.concatenate([
        genome_reads(rng, n, L, genome_len=3000, err=0.01, p_n=0.002),
        random_reads(rng, n_random, L), _special_reads(L)])
    return reads[rng.permutation(len(reads))]


def _lines(path):
    with open(path, "rb") as f:
        return f.read().splitlines()


def _rows(reads):
    return [bytes(r) for r in reads]


def _pairs(p1, p2):
    return sorted(zip(_lines(p1), _lines(p2)))


def _write(tmp_path, name, reads):
    path = str(tmp_path / name)
    write_fastq(path, reads)
    return path


def _both_archives(tmp_path, cfg, fq, fq2=None):
    """(JAX archive, port archive) of the same input and config."""
    ja, ta = str(tmp_path / "j.mtc"), str(tmp_path / "t.mtc")
    jcomp.compress(fq, ja, JConfig(**dataclasses.asdict(cfg)),
                   reads_path2=fq2)
    tcomp.compress(fq, ta, cfg, reads_path2=fq2, device="cpu")
    return ja, ta


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# ---- stage boundary: serialize ------------------------------------------

@pytest.fixture(scope="module")
def pe_stages():
    """The JAX pipeline's state before serialize, on a paired-end input
    (mate 1 rows then mate 2 rows)."""
    rng = np.random.default_rng(8)
    L = 100
    r1, r2 = _reads(rng, 300, L), _reads(rng, 300, L)
    codes = ascii_to_codes(np.concatenate([r1, r2]))
    cfg = JConfig(paired=True).resolve(L)
    cls = jclassify.classify(codes, cfg)
    cset, sg = jcluster.cluster_rounds(cls.codes_sub, cls.pool, cfg)
    rcfg = JConfig(paired=True).resolve(L, n_singletons=len(sg))
    cset = jmerge.merge_contigs(cset, rcfg, {}, codes_host=cls.codes_sub)
    cset, sg, extra_a, extra_t = jrealign.realign_ladder(
        cset, sg, cls.codes_sub, cls.n_mask, rcfg)
    return dict(L=L, half=len(r1), cls=cls, cset=cset, sg=sg,
                extra_a=extra_a, extra_t=extra_t)


@pytest.mark.parametrize("order,paired", [(True, False), (False, True),
                                          (True, True)])
def test_serialize_streams_match_reference(pe_stages, order, paired):
    s, cls = pe_stages, pe_stages["cls"]
    sg_has_n = cls.has_n[s["sg"]]
    jinp = jencode.EncodeInput(
        readlen=s["L"], n_seq=2 * s["half"],
        half_val=s["half"] if paired else 0, order=order, paired=paired,
        codes_sub=cls.codes_sub, n_mask=cls.n_mask, all_a=cls.all_a,
        all_t=cls.all_t, all_n=cls.all_n,
        near_a=np.concatenate([cls.near_a, s["extra_a"]]),
        near_t=np.concatenate([cls.near_t, s["extra_t"]]),
        mostly_n=cls.mostly_n,
        nfile=np.concatenate([cls.nfile, s["sg"][sg_has_n]]),
        single=s["sg"][~sg_has_n], clusters=s["cset"])
    jm = cls.n_mask
    fields = {f.name: getattr(jinp, f.name)
              for f in dataclasses.fields(tencode.EncodeInput)}
    fields.update(clusters=from_reference(jinp.clusters),
                  n_mask=tclassify.SparseNMask(jm.L, jm.has_n, jm.nz_rids,
                                               jm.ptr, jm.pos))
    want_meta, want = jencode.serialize(jinp)
    got_meta, got = tencode.serialize(tencode.EncodeInput(**fields))
    assert got_meta == want_meta
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], f"stream {name!r} differs"
    assert ("ids" in got) == order and ("peids" in got) == paired


@pytest.mark.parametrize("mode", ["order", "pe"])
def test_assemble_matches_reference(tmp_path, mode):
    """The decoder at the stage boundary: the same streams give the same
    lines matrices in both packages (no Prealloc: the plain allocation)."""
    rng = np.random.default_rng(14)
    fq = _write(tmp_path, "m1.fastq", _reads(rng, 200, 80))
    fq2 = _write(tmp_path, "m2.fastq", _reads(rng, 200, 80)) \
        if mode == "pe" else None
    arc = str(tmp_path / "j.mtc")
    jcomp.compress(fq, arc, JConfig(order=mode == "order"), reads_path2=fq2)
    meta, streams = jcontainer.read_container(arc)
    if mode == "pe":
        want = jdecode.assemble_pe(meta, streams)
        got = tdecode.assemble_pe(meta, streams)
    else:
        want = [jdecode.assemble_order(meta, streams)]
        got = [tdecode.assemble_order(meta, streams)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---- archives and cross-decoding ----------------------------------------

@pytest.mark.parametrize("codec", ["auto", "device"])
@pytest.mark.parametrize("mode", ["order", "pe", "pe+order"])
def test_mode_archive_identical_and_cross_decode(tmp_path, mode, codec):
    rng = np.random.default_rng(9)
    L = 100
    r1 = _reads(rng, 300, L)
    fq = _write(tmp_path, "in1.fastq", r1)
    fq2 = None
    if mode != "order":
        r2 = _reads(rng, 300, L)
        fq2 = _write(tmp_path, "in2.fastq", r2)
    cfg = CompressorConfig(order=mode != "pe", codec=codec)
    ja, ta = _both_archives(tmp_path, cfg, fq, fq2)
    assert _same_bytes(ja, ta)
    tj = [str(tmp_path / f"tj{i}.reads") for i in (1, 2)]
    jt = [str(tmp_path / f"jt{i}.reads") for i in (1, 2)]
    tcomp.decompress(ja, *tj, device="cpu")   # port decodes JAX
    jcomp.decompress(ta, *jt)                 # JAX decodes port
    if fq2 is None:
        assert _lines(tj[0]) == _rows(r1)
        assert _lines(jt[0]) == _rows(r1)
    else:
        want = sorted(zip(_rows(r1), _rows(r2)))
        assert _pairs(*tj) == want
        assert _pairs(*jt) == want
        assert _same_bytes(tj[1], jt[1])
    assert _same_bytes(tj[0], jt[0])


@pytest.mark.parametrize("kwargs,L", SWEEP,
                         ids=[f"L{L}-" + ("-".join(f"{k}{v}" for k, v
                                                   in kw.items()) or "default")
                              for kw, L in SWEEP])
def test_order_archive_identical_param_sweep(tmp_path, kwargs, L):
    rng = np.random.default_rng(L)
    reads = np.concatenate([
        genome_reads(rng, 500, L, genome_len=4000, err=0.01, p_n=0.002),
        random_reads(rng, 25, L)])
    reads = reads[rng.permutation(len(reads))]
    fq = _write(tmp_path, "in.fastq", reads)
    ja, ta = _both_archives(tmp_path, CompressorConfig(order=True, **kwargs),
                            fq)
    assert _same_bytes(ja, ta)
    out = str(tmp_path / "o.reads")
    tcomp.decompress(ta, out)
    assert _lines(out) == _rows(reads)


@pytest.mark.parametrize("L", [64, 150])
def test_pe_archive_identical_read_lengths(tmp_path, L):
    rng = np.random.default_rng(L + 1)
    r1, r2 = _reads(rng, 250, L), _reads(rng, 250, L)
    fq1, fq2 = (_write(tmp_path, "m1.fastq", r1),
                _write(tmp_path, "m2.fastq", r2))
    ja, ta = _both_archives(tmp_path, CompressorConfig(), fq1, fq2)
    assert _same_bytes(ja, ta)
    o1, o2 = str(tmp_path / "o1.reads"), str(tmp_path / "o2.reads")
    tcomp.decompress(ja, o1, o2)
    assert _pairs(o1, o2) == sorted(zip(_rows(r1), _rows(r2)))


# ---- config, input and archive faults ----------------------------------

def test_reused_config_pe_then_single_end(tmp_path):
    """compress takes paired on a copy: one config serves a PE run and then
    a single-end run, and the caller's object is unchanged."""
    rng = np.random.default_rng(10)
    r1, r2 = _reads(rng, 150, 80), _reads(rng, 150, 80)
    fq1, fq2 = (_write(tmp_path, "m1.fastq", r1),
                _write(tmp_path, "m2.fastq", r2))
    cfg = CompressorConfig()
    want = dataclasses.asdict(cfg)
    tcomp.compress(fq1, str(tmp_path / "pe.mtc"), cfg, reads_path2=fq2,
                   device="cpu")
    assert dataclasses.asdict(cfg) == want and cfg.paired is False
    se = str(tmp_path / "se.mtc")
    tcomp.compress(fq1, se, cfg, device="cpu")
    jse = str(tmp_path / "jse.mtc")
    jcomp.compress(fq1, jse, JConfig())
    assert _same_bytes(se, jse)
    assert not container.read_header(se)["pe"]


@pytest.mark.parametrize("n2,L2,match", [(40, 60, "read counts"),
                                         (50, 70, "read lengths")])
def test_mismatched_mates_raise(tmp_path, n2, L2, match):
    rng = np.random.default_rng(11)
    fq1 = _write(tmp_path, "m1.fastq", random_reads(rng, 50, 60))
    fq2 = _write(tmp_path, "m2.fastq", random_reads(rng, n2, L2))
    with pytest.raises(ValueError, match=match):
        tcomp.compress(fq1, str(tmp_path / "o.mtc"), reads_path2=fq2,
                       device="cpu")


def test_pe_default_second_output(tmp_path):
    rng = np.random.default_rng(12)
    r1, r2 = _reads(rng, 120, 60), _reads(rng, 120, 60)
    fq1, fq2 = (_write(tmp_path, "m1.fastq", r1),
                _write(tmp_path, "m2.fastq", r2))
    arc, out = str(tmp_path / "o.mtc"), str(tmp_path / "o.reads")
    tcomp.compress(fq1, arc, reads_path2=fq2, device="cpu")
    tcomp.decompress(arc, out)
    assert _pairs(out, out + ".2") == sorted(zip(_rows(r1), _rows(r2)))


@pytest.mark.parametrize("stream,pe", [("ids", False), ("ids_single", False),
                                       ("peids", True), ("fbits", True)])
def test_truncated_mode_stream_raises(tmp_path, stream, pe):
    """An archive whose id or pairing stream is one record short (crc
    recomputed, so only the length check can catch it) raises ValueError
    before any read is placed."""
    rng = np.random.default_rng(13)
    fq = _write(tmp_path, "m1.fastq", _reads(rng, 150, 60))
    fq2 = _write(tmp_path, "m2.fastq", _reads(rng, 150, 60)) if pe else None
    arc = str(tmp_path / "o.mtc")
    tcomp.compress(fq, arc, CompressorConfig(order=not pe), reads_path2=fq2,
                   device="cpu")
    meta, streams = container.read_container(arc)
    cut = 1 if stream == "fbits" else 4
    assert len(streams[stream]) >= cut
    streams[stream] = streams[stream][:-cut]
    meta.pop("streams")
    container.write_container(arc, meta, streams, "store")
    with pytest.raises(ValueError, match="corrupt archive"):
        tcomp.decompress(arc, str(tmp_path / "o.reads"))
