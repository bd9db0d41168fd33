#!/usr/bin/env python3
"""The contig-sketch kernel of minicom_tpu_torch alone on one CUDA GPU: the
quick loop for work on the contig sketch of ``csrc/sketch.cu``.

    python3 sketch_times.py [N_READS]      # from the repository root

Runs chip_smoke.py's phase 0 (the card's name and power limit, the build),
phase 1's contig-sketch check (the kernel against its plain version and the
host twin, timed), and then, unless N_READS is 0, a compress of N_READS
reads (default 5,000,000: chip_smoke's phase 2 set) with phase 2's
contig-sketch accounting: per ``sketch_contigs`` call its contigs, k-mer
starts and launches; in all, the kernel's device seconds, the bound of that
work and the ``merge_sketch`` sub-stage. The last line is the kernel's entry
of chip_smoke's JSON line (without ``launches``) and the compress totals.
Any failure ends the run with a traceback and a non-zero exit.
"""

import json
import os
import sys
import tempfile

import chip_smoke
from bench import make_dataset
from minicom_tpu_torch import compressor


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.N_READS
    dev = chip_smoke.phase0_device()
    if dev is None:
        return 1
    report = {}
    chip_smoke.phase1_sketch_windowed(dev, report)
    tot = None
    if n:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_sketch_",
                                         dir=chip_smoke.ROOT) as tmp:
            fq, arc = (os.path.join(tmp, f) for f in ("s.fastq", "s.mtc"))
            make_dataset(fq, n)
            with chip_smoke._LaunchTimer() as lt, \
                    chip_smoke._SketchCalls() as sk:
                summary = compressor.compress(fq, arc, device=dev)
            tot = sk.report("sketch", lt.seconds().get("mtc_sketch_windowed",
                                                       0.0),
                            summary.get("merge_sketch_s"))
            print(f"[sketch] {n} reads: archive {summary['archive_bytes']} B, "
                  "encode stages s " + json.dumps(summary["timings_s"]))
    print(json.dumps({"kernels": list(report.values()), "compress": tot}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
