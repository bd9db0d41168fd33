"""minicom_tpu_torch — the PyTorch + CUDA port of the minicom_tpu compressor.

Compress -> decompress in every mode of the JAX package (single-end
unordered, order-preserving, paired-end), with every codec (host ``auto``,
on-device ``device``) and stage checkpoint/resume. The device stages
(whole-read minimizer, consensus vote, windowed contig sketch, rANS scans)
run as hand-written CUDA kernels on a CUDA device, or as their plain PyTorch
versions on the CPU; the archive is byte-identical either way and
byte-identical to the JAX package's. In a ``torch.distributed`` group
(``parallel/``: one process a card, gloo for host arrays, NCCL between
cards where every rank owns one) the stages shard across the processes and
the archive stays the same. The host C++ is this package's own (``native/*.cpp``, built at
first use by ``native/__init__.py``).

This package never imports jax or ``minicom_tpu``, and reads no file of
it.
"""

__version__ = "0.1.0"

from minicom_tpu_torch.config import CompressorConfig  # noqa: E402,F401


def from_reference(obj):
    """The port's counterpart of a ``minicom_tpu`` config or ClusterSet.

    Takes the JAX package's ``CompressorConfig``, ``ResolvedConfig`` or
    ``ClusterSet`` (by duck type, so this module needs no jax) and returns
    the same state as this package's class: same fields, same numpy arrays
    and dtypes. Lets a test feed one JAX stage's output into the next port
    stage."""
    import dataclasses

    from minicom_tpu_torch import config
    if hasattr(obj, "mem_rid"):
        from minicom_tpu_torch.pipeline.cluster import ClusterSet
        return ClusterSet(**{f.name: getattr(obj, f.name)
                             for f in dataclasses.fields(ClusterSet)})
    if hasattr(obj, "dict_ranges"):
        return config.ResolvedConfig(**dataclasses.asdict(obj))
    if hasattr(obj, "resolve"):
        return config.CompressorConfig(**dataclasses.asdict(obj))
    raise TypeError(f"no port counterpart for {type(obj).__name__}")
