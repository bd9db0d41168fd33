#!/usr/bin/env python3
"""The consensus-vote kernel of minicom_tpu_torch alone on one CUDA GPU: the
quick loop for work on ``csrc/consensus.cu``.

    python3 consensus_times.py [N_READS]    # from the repository root

Runs chip_smoke.py's phase 0 (the card's name and power limit, the build),
phase 1's consensus check (the kernel against its plain version and the host
twin on the first cluster round's ejection pass of a 100,000-read set, timed
from CUDA graphs), and then, unless N_READS is 0, a compress of N_READS reads
(default 5,000,000: chip_smoke's phase 2 set) with phase 2's consensus and
read-minimizer accounting: per ``consensus_from_members`` call its members,
bases, columns, segments, launches and host wall; in all, the kernel's
device seconds, the bound of that work and the peak device memory. The last
line is the kernel's entry of chip_smoke's JSON line (without ``launches``)
and the compress totals. Any failure ends the run with a traceback and a
non-zero exit.
"""

import json
import os
import sys
import tempfile

import torch

import chip_smoke
from bench import make_dataset
from minicom_tpu_torch import compressor


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.N_READS
    dev = chip_smoke.phase0_device()
    if dev is None:
        return 1
    report, tot = {}, None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_consensus_",
                                     dir=chip_smoke.ROOT) as tmp:
        small = os.path.join(tmp, "same.fastq")
        make_dataset(small, chip_smoke.N_SAME_BYTES)
        chip_smoke.phase1_consensus(dev, small, report)
        if n:
            fq, arc = (os.path.join(tmp, f) for f in ("c.fastq", "c.mtc"))
            make_dataset(fq, n)
            torch.cuda.reset_peak_memory_stats()
            with chip_smoke._LaunchTimer() as lt, \
                    chip_smoke._ConsensusCalls(lt) as cc, \
                    chip_smoke._ReadSketchCalls(lt) as rs:
                summary = compressor.compress(fq, arc, device=dev)
            peak = torch.cuda.max_memory_allocated()
            secs = lt.seconds()
            tot = cc.report("consensus",
                            secs.get("mtc_consensus_vote", 0.0))
            tot["peak_device_B"] = peak
            rs.report("consensus", secs.get("mtc_sketch_reads", 0.0))
            print(f"[consensus] {n} reads: archive "
                  f"{summary['archive_bytes']} B, peak device memory {peak} "
                  "B, encode stages s " + json.dumps(summary["timings_s"]))
    print(json.dumps({"kernels": list(report.values()), "compress": tot}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
