"""MTC_TRACE_DIR: the port's compress traced by torch.profiler (the
counterpart of the JAX package's jax.profiler hook), on the CPU."""

import glob
import json
import os

import numpy as np
import pytest
import torch.profiler

from minicom_tpu_torch import compressor
from tests.conftest import genome_reads, write_fastq


@pytest.fixture
def fastq(tmp_path):
    path = str(tmp_path / "in.fastq")
    write_fastq(path, genome_reads(np.random.default_rng(3), 600, 80,
                                   genome_len=3000))
    return path


def test_trace_dir_writes_a_trace_and_the_same_archive(fastq, tmp_path,
                                                       monkeypatch):
    plain, traced = str(tmp_path / "plain.mtc"), str(tmp_path / "traced.mtc")
    monkeypatch.delenv("MTC_TRACE_DIR", raising=False)
    compressor.compress(fastq, plain, device="cpu")
    trace_dir = str(tmp_path / "trace")
    monkeypatch.setenv("MTC_TRACE_DIR", trace_dir)
    compressor.compress(fastq, traced, device="cpu")
    with open(plain, "rb") as a, open(traced, "rb") as b:
        assert a.read() == b.read()
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_no_profiler_without_trace_dir(fastq, tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("profiler started without MTC_TRACE_DIR")

    monkeypatch.delenv("MTC_TRACE_DIR", raising=False)
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    compressor.compress(fastq, str(tmp_path / "out.mtc"), device="cpu")
