"""The port's pipeline (minicom_tpu_torch, device="cpu": the kernels' plain
PyTorch versions) against the JAX package, stage by stage and end to end.

Each stage of the port is fed the JAX package's output of the stage before,
so the first mismatch points at one stage. The archive must be byte-identical,
and each package must decode the other's archive exactly."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from minicom_tpu import CompressorConfig as JConfig
from minicom_tpu import compressor as jcomp
from minicom_tpu.ops.pack import ascii_to_codes
from minicom_tpu.pipeline import classify as jclassify
from minicom_tpu.pipeline import cluster as jcluster
from minicom_tpu.pipeline import merge as jmerge
from minicom_tpu.pipeline import realign as jrealign
from minicom_tpu_torch import CompressorConfig, cli, from_reference
from minicom_tpu_torch import compressor as tcomp
from minicom_tpu_torch import native
from minicom_tpu_torch.pipeline import classify as tclassify
from minicom_tpu_torch.pipeline import cluster as tcluster
from minicom_tpu_torch.pipeline import merge as tmerge
from minicom_tpu_torch.pipeline import realign as trealign
from tests.conftest import genome_reads, random_reads, write_fastq
from tests.test_roundtrip import _special_reads
from tests.test_torch_rans import jax_native  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def _assert_csets_equal(a, b):
    assert a.readlen == b.readlen
    for f in ("mem_rid", "mem_off", "mem_dir", "cluster_ptr", "ref_flat",
              "ref_ptr"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.fixture(scope="module")
def stages():
    """JAX stage outputs on genome reads with both strands, errors and Ns."""
    rng = np.random.default_rng(3)
    L = 100
    reads = np.concatenate([
        genome_reads(rng, 1500, L, genome_len=5000, err=0.01, p_n=0.002),
        random_reads(rng, 40, L), _special_reads(L)])
    codes = ascii_to_codes(reads)
    jcfg = JConfig().resolve(L)
    cls = jclassify.classify(codes.copy(), jcfg)
    cset, sg = jcluster.cluster_rounds(cls.codes_sub, cls.pool, jcfg)
    rcfg = JConfig().resolve(L, n_singletons=len(sg))
    counters = {}
    merged = jmerge.merge_contigs(cset, rcfg, counters,
                                  codes_host=cls.codes_sub)
    return dict(codes=codes, cfg=jcfg, rcfg=rcfg, cls=cls, cset=cset, sg=sg,
                merged=merged, counters=counters)


def test_from_reference_config():
    jc = JConfig(k=17, diff_threshold=3, merge_revote=False)
    assert dataclasses.asdict(from_reference(jc)) == dataclasses.asdict(jc)
    assert from_reference(jc).resolve(100) == from_reference(jc.resolve(100))
    for L, n in ((100, None), (64, 10), (150, 6_000_000)):
        assert (dataclasses.asdict(CompressorConfig().resolve(L, n))
                == dataclasses.asdict(JConfig().resolve(L, n)))


def test_classify_matches_reference(stages):
    got = tclassify.classify(stages["codes"].copy(), from_reference(stages["cfg"]))
    want = stages["cls"]
    for f in ("codes_sub", "has_n", "all_a", "all_t", "all_n", "near_a",
              "near_t", "mostly_n", "nfile", "pool"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    for f in ("nz_rids", "ptr", "pos"):
        np.testing.assert_array_equal(getattr(got.n_mask, f),
                                      getattr(want.n_mask, f), f)


def test_cluster_rounds_matches_reference(stages):
    cls = stages["cls"]
    cset, sg = tcluster.cluster_rounds(torch.from_numpy(cls.codes_sub),
                                       cls.pool, from_reference(stages["cfg"]))
    _assert_csets_equal(cset, stages["cset"])
    np.testing.assert_array_equal(sg, stages["sg"])


@pytest.mark.parametrize("which", ["first", "ejected"])
def test_round_sketch_matches_reference(stages, which):
    """``cluster._sketch`` (one ``sketch_reads_flat`` call) gives the JAX
    round's (key, mpos, strand): the first round over the pool at k, and
    the second over the reads the first ejected (with a diff threshold
    of 1, so that it ejects some of these reads), at k - 1."""
    import jax.numpy as jnp
    cls, cfg = stages["cls"], stages["cfg"]
    L, k = cls.codes_sub.shape[1], cfg.k
    codes_j = jnp.asarray(cls.codes_sub)
    pending = np.asarray(cls.pool, np.int64)
    if which == "ejected":
        h, mpos, strand = jcluster._sketch(pending, codes_j, k, L)
        pending = jcluster._one_round(codes_j, cls.codes_sub, pending, h,
                                      mpos, strand, 1, L)[2]
        assert len(pending)
        k -= 1
    want = jcluster._sketch(pending, codes_j, k, L)
    got = tcluster._sketch(pending, torch.from_numpy(cls.codes_sub), k, L)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("revote", [True, False])
def test_merge_matches_reference(stages, revote):
    cls, rcfg = stages["cls"], stages["rcfg"]
    cset = from_reference(stages["cset"])
    counters = {}
    got = tmerge.merge_contigs(
        cset, from_reference(rcfg), CPU, counters,
        codes_dev=torch.from_numpy(cls.codes_sub) if revote else None)
    if revote:
        want, want_counters = stages["merged"], stages["counters"]
    else:
        want_counters = {}
        want = jmerge.merge_contigs(stages["cset"], rcfg, want_counters)
    _assert_csets_equal(got, want)
    assert got.n_clusters < cset.n_clusters
    for key in ("merge_probe_drops", "merge_rank_saturated"):
        assert counters[key] == want_counters[key], key


@pytest.mark.parametrize("which", ["cset", "merged"])
def test_sketch_contigs_matches_reference(stages, which):
    """The merge stage's contig sketch, array for array and dtype for
    dtype, on the clusters before and after merging; and the same
    saturated-row count."""
    rcfg = stages["rcfg"]
    cset = stages[which]
    args = (rcfg.k, rcfg.contig_window, rcfg.merge_rank_cap)
    got_stats, want_stats = {}, {}
    got = tmerge.sketch_contigs(from_reference(cset), *args, CPU, got_stats)
    want = jmerge.sketch_contigs(cset, *args, stats=want_stats)
    assert len(got[0]) > 0
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)
    assert got_stats == want_stats


def test_merge_incremental_equals_full(stages):
    cfg = from_reference(stages["rcfg"])
    cset = from_reference(stages["cset"])
    inc = tmerge.merge_contigs(cset, cfg, CPU, incremental=True)
    full = tmerge.merge_contigs(cset, cfg, CPU, incremental=False)
    _assert_csets_equal(inc, full)


def test_realign_matches_reference(stages):
    cls, rcfg = stages["cls"], stages["rcfg"]
    want = jrealign.realign_ladder(stages["merged"], stages["sg"],
                                   cls.codes_sub, cls.n_mask, rcfg)
    got = trealign.realign_ladder(from_reference(stages["merged"]),
                                  stages["sg"], cls.codes_sub, cls.n_mask,
                                  from_reference(rcfg))
    _assert_csets_equal(got[0], want[0])
    assert got[0].n_members > stages["merged"].n_members
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def test_realign_numpy_probe_matches_native(stages):
    """probe_numpy reduced to the best placement per read == the native
    probe's winners."""
    cls, cfg = stages["cls"], from_reference(stages["rcfg"])
    cset, sg = from_reference(stages["merged"]), stages["sg"]
    sgc = cls.codes_sub[sg]
    thr = cfg.diff_threshold + cfg.thr_step

    def winners(t):
        sg_i, cl, off, dirs, pop = (np.asarray(x, np.int64) for x in t)
        order = np.lexsort((dirs, off, cl, pop, sg_i))
        first = np.r_[True, sg_i[order][1:] != sg_i[order][:-1]]
        return np.stack([x[order][first] for x in (sg_i, cl, off, dirs,
                                                   pop)])

    nat = native.realign_probe(
        cset.ref_flat, cset.ref_ptr, sgc,
        np.array([s for s, _ in cfg.dict_ranges()], np.int32),
        cfg.dict_seg_len, thr, cfg.max_search, rc_skip_cost=thr <= 24)
    got = winners(trealign.probe_numpy(cset, sgc, cfg, thr))
    assert got.shape[1] > 0
    np.testing.assert_array_equal(got, winners(nat))


def _archives(tmp_path, reads_or_fastq, cfg=None):
    if isinstance(reads_or_fastq, str):
        fq = reads_or_fastq
    else:
        fq = str(tmp_path / "in.fastq")
        write_fastq(fq, reads_or_fastq)
    ja, ta = str(tmp_path / "j.mtc"), str(tmp_path / "t.mtc")
    jcomp.compress(fq, ja, cfg and JConfig(**dataclasses.asdict(cfg)))
    summary = tcomp.compress(fq, ta, cfg, device="cpu")
    return fq, ja, ta, summary


def _sorted_reads(fastq):
    return sorted(open(fastq, "rb").read().splitlines()[1::4])


def _sorted_lines(path):
    return sorted(open(path, "rb").read().splitlines())


@pytest.mark.parametrize("L", [100, 64])
def test_archive_identical_and_cross_decode(tmp_path, L):
    """The inputs of test_roundtrip.py::test_roundtrip_unordered."""
    rng = np.random.default_rng(0)
    reads = np.concatenate([
        genome_reads(rng, 600, L, genome_len=4000, err=0.01, p_n=0.002),
        random_reads(rng, 30, L), _special_reads(L)])
    fq, ja, ta, summary = _archives(tmp_path, reads)
    assert open(ta, "rb").read() == open(ja, "rb").read()
    assert summary["archive_bytes"] < summary["input_bytes"]
    want = _sorted_reads(fq)
    tcomp.decompress(ja, str(tmp_path / "tj.reads"))   # port decodes JAX
    jcomp.decompress(ta, str(tmp_path / "jt.reads"))   # JAX decodes port
    assert _sorted_lines(tmp_path / "tj.reads") == want
    assert _sorted_lines(tmp_path / "jt.reads") == want
    # unordered output order is canonical: identical files either way
    assert (open(tmp_path / "tj.reads", "rb").read()
            == open(tmp_path / "jt.reads", "rb").read())


def test_archive_identical_hard_profile(tmp_path):
    """bench.py's hard profile: 150 bp, 2% error, skewed coverage."""
    from bench import make_dataset
    fq = str(tmp_path / "hard.fastq")
    make_dataset(fq, 20_000, profile="hard")
    _, ja, ta, _ = _archives(tmp_path, fq)
    assert open(ta, "rb").read() == open(ja, "rb").read()
    tcomp.decompress(ta, str(tmp_path / "h.reads"))
    assert _sorted_lines(tmp_path / "h.reads") == _sorted_reads(fq)


@pytest.mark.parametrize("cfg", [CompressorConfig(k=17, diff_threshold=3),
                                 CompressorConfig(merge_revote=False),
                                 CompressorConfig(codec="xz")])
def test_archive_identical_options(tmp_path, cfg):
    rng = np.random.default_rng(5)
    reads = genome_reads(rng, 800, 80, genome_len=3000, err=0.01, p_n=0.002)
    _, ja, ta, _ = _archives(tmp_path, reads, cfg)
    assert open(ta, "rb").read() == open(ja, "rb").read()


def _device_reads():
    rng = np.random.default_rng(0)
    return np.concatenate([
        genome_reads(rng, 600, 100, genome_len=4000, err=0.01, p_n=0.002),
        random_reads(rng, 30, 100), _special_reads(100)])


@pytest.mark.parametrize("codec", ["device", "trans", "trans1", "trans2",
                                   "dzt"])
def test_device_codec_archive_identical(tmp_path, codec):
    """The on-device codecs, scans in their plain versions: the archive
    equals the JAX package's and decodes both ways."""
    fq, ja, ta, _ = _archives(tmp_path, _device_reads(),
                              CompressorConfig(codec=codec))
    assert open(ta, "rb").read() == open(ja, "rb").read()
    want = _sorted_reads(fq)
    tcomp.decompress(ja, str(tmp_path / "tj.reads"), device="cpu")
    jcomp.decompress(ta, str(tmp_path / "jt.reads"))
    assert _sorted_lines(tmp_path / "tj.reads") == want
    assert _sorted_lines(tmp_path / "jt.reads") == want


def test_device_table_archive_identical_bench(tmp_path):
    """codec="device" on bench.py's default profile at 20,000 reads, where
    the table picks on-device codecs for the large streams."""
    from bench import make_dataset
    from minicom_tpu_torch.io import container
    fq = str(tmp_path / "bench.fastq")
    make_dataset(fq, 20_000)
    _, ja, ta, _ = _archives(tmp_path, fq, CompressorConfig(codec="device"))
    assert open(ta, "rb").read() == open(ja, "rb").read()
    used = {e["name"]: e["codec"] for e in container.read_header(ta)["streams"]}
    assert (used["diff"], used["nsingle"], used["dpos"], used["cnt"]) == (
        "trans1", "trans1", "p2:trans1", "p4:trans1"), used
    tcomp.decompress(ja, str(tmp_path / "tj.reads"), device="cpu")
    assert _sorted_lines(tmp_path / "tj.reads") == _sorted_reads(fq)
    jcomp.decompress(ta, str(tmp_path / "jt.reads"))
    assert _sorted_lines(tmp_path / "jt.reads") == _sorted_reads(fq)


def test_cli_device_codec_roundtrip(tmp_path):
    rng = np.random.default_rng(6)
    reads = genome_reads(rng, 300, 80, genome_len=2000)
    fq = str(tmp_path / "in.fastq")
    write_fastq(fq, reads)
    arc, out = str(tmp_path / "o.mtc"), str(tmp_path / "o.reads")
    assert cli.main(["-r", fq, "-o", arc, "--codec", "device",
                     "--device", "cpu"]) == 0
    assert cli.main(["-d", arc, "-o", out, "--device", "cpu"]) == 0
    assert _sorted_lines(out) == sorted(bytes(r) for r in reads)


def test_tiny_inputs_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    for reads in (np.tile(random_reads(rng, 1, 60), (5, 1)),
                  random_reads(rng, 1, 60), random_reads(rng, 2, 60)):
        fq, ja, ta, _ = _archives(tmp_path, reads)
        assert open(ta, "rb").read() == open(ja, "rb").read()
        tcomp.decompress(ta, str(tmp_path / "o.reads"))
        assert _sorted_lines(tmp_path / "o.reads") == _sorted_reads(fq)


def test_cli_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    reads = genome_reads(rng, 200, 80, genome_len=1500)
    fq = str(tmp_path / "in.fastq")
    write_fastq(fq, reads)
    arc, out = str(tmp_path / "o.mtc"), str(tmp_path / "o.reads")
    assert cli.main(["-r", fq, "-o", arc, "-k", "17", "-e", "3",
                     "--device", "cpu"]) == 0
    assert cli.main(["-d", arc, "-o", out]) == 0
    assert _sorted_lines(out) == sorted(bytes(r) for r in reads)
    assert cli.main([]) == 2


@pytest.mark.parametrize("argv", [
    ["-p"], ["--checkpoint", "{tmp}/ck"],
    ["-1", "{fq}", "-2", "{fq2}", "-O", "{tmp}/o2.reads"]])
def test_out_of_slice_options_raise(tmp_path, argv):
    """The options that were out of the first slices (-p, --checkpoint,
    -1/-2 with -O) now roundtrip through the CLI on the CPU."""
    rng = np.random.default_rng(0)
    r1 = genome_reads(rng, 150, 60, genome_len=900)
    r2 = genome_reads(rng, 150, 60, genome_len=900)
    fq, fq2 = str(tmp_path / "in.fastq"), str(tmp_path / "in2.fastq")
    write_fastq(fq, r1)
    write_fastq(fq2, r2)
    argv = [a.format(fq=fq, fq2=fq2, tmp=tmp_path) for a in argv]
    pe = "-1" in argv
    if not pe:
        argv = ["-r", fq] + argv
    arc, out = str(tmp_path / "o.mtc"), str(tmp_path / "o.reads")
    assert cli.main(argv + ["-o", arc, "--device", "cpu"]) == 0
    dec = ["-d", arc, "-o", out] + (argv[argv.index("-O"):] if pe else [])
    assert cli.main(dec) == 0
    got = open(out, "rb").read().splitlines()
    if pe:
        got2 = open(tmp_path / "o2.reads", "rb").read().splitlines()
        assert (sorted(zip(got, got2))
                == sorted(zip((bytes(r) for r in r1), (bytes(r) for r in r2))))
    elif "-p" in argv:
        assert got == [bytes(r) for r in r1]
    else:
        assert sorted(got) == sorted(bytes(r) for r in r1)
        assert sorted(os.listdir(tmp_path / "ck")) == [
            "cluster.npz", "merge.npz", "realign.npz"]


def test_out_of_slice_archives_raise(tmp_path):
    """An order-preserving archive of the JAX package, once refused, now
    decodes in the port line for line."""
    rng = np.random.default_rng(4)
    reads = genome_reads(rng, 100, 60, genome_len=800)
    fq = str(tmp_path / "in.fastq")
    write_fastq(fq, reads)
    arc = str(tmp_path / "o.mtc")
    jcomp.compress(fq, arc, JConfig(order=True))
    tcomp.decompress(arc, str(tmp_path / "o.reads"))
    assert (open(tmp_path / "o.reads", "rb").read().splitlines()
            == [bytes(r) for r in reads])


def test_torch_group_made_by_hand_is_honoured(tmp_path):
    """A gloo group made with init_process_group in this process (world
    size 1) is the process grid, over a grid set by hand, and compress and
    decompress in it write the single-process archive and output."""
    from minicom_tpu_torch.parallel import distributed as dist
    fq = str(tmp_path / "in.fastq")
    write_fastq(fq, genome_reads(np.random.default_rng(0), 300, 60,
                                 genome_len=2000))
    arc = str(tmp_path / "o.mtc")
    tcomp.compress(fq, arc, device="cpu")
    tcomp.decompress(arc, str(tmp_path / "o.reads"))
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        dist.set_process_grid(1, 2)
        assert dist.process_grid() == (0, 1)
        tcomp.compress(fq, str(tmp_path / "g.mtc"), device="cpu")
        tcomp.decompress(str(tmp_path / "g.mtc"), str(tmp_path / "g.reads"))
    finally:
        dist.set_process_grid(0, 1)
        torch.distributed.destroy_process_group()
    assert open(tmp_path / "g.mtc", "rb").read() == open(arc, "rb").read()
    assert (open(tmp_path / "g.reads", "rb").read()
            == open(tmp_path / "o.reads", "rb").read())


def test_cuda_device_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fq = str(tmp_path / "in.fastq")
    write_fastq(fq, random_reads(np.random.default_rng(0), 10, 50))
    with pytest.raises(RuntimeError, match="CUDA"):
        tcomp.compress(fq, str(tmp_path / "o.mtc"))


def test_device_codec_on_cuda_needs_a_gpu(tmp_path):
    """No CPU fallback: the on-device codecs on device="cuda" raise without
    a GPU, in compress and in decompress; a host-codec archive still decodes
    with device="cuda" and no GPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fq = str(tmp_path / "in.fastq")
    write_fastq(fq, random_reads(np.random.default_rng(0), 10, 50))
    with pytest.raises(RuntimeError, match="CUDA"):
        tcomp.compress(fq, str(tmp_path / "o.mtc"),
                       CompressorConfig(codec="device"), device="cuda")
    dev_arc, host_arc = str(tmp_path / "d.mtc"), str(tmp_path / "h.mtc")
    tcomp.compress(fq, dev_arc, CompressorConfig(codec="trans1"),
                   device="cpu")
    tcomp.compress(fq, host_arc, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcomp.decompress(dev_arc, str(tmp_path / "d.reads"), device="cuda")
    tcomp.decompress(host_arc, str(tmp_path / "h.reads"), device="cuda")
    assert _sorted_lines(tmp_path / "h.reads") == _sorted_reads(fq)
