#!/usr/bin/env python3
"""The rANS kernels of minicom_tpu_torch alone on one CUDA GPU: the quick
loop for work on ``csrc/rans.cu``.

    python3 rans_times.py [N_READS]      # from the repository root

Runs chip_smoke.py's phase 0 (the card's name and power limit, the build), a
compress of N_READS reads (default 5,000,000, chip_smoke's phase 2, so that
every block has the main path's shape; 1,000,000 is quicker and leaves the
dzt literal block at T = 16384), and phase 1's rANS checks on that archive's
streams: encode and decode kernels against their plain versions on three
blocks, the two batches each way, all timed. The last line is the two
kernels' entries of chip_smoke's JSON line (without ``launches``). Any
failure ends the run with a traceback and a non-zero exit.
"""

import json
import os
import sys
import tempfile

import chip_smoke
from bench import make_dataset
from minicom_tpu_torch import compressor
from minicom_tpu_torch.io import container


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.N_READS
    dev = chip_smoke.phase0_device()
    if dev is None:
        return 1
    report = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rans_",
                                     dir=chip_smoke.ROOT) as tmp:
        fq, arc = (os.path.join(tmp, f) for f in ("r.fastq", "r.mtc"))
        make_dataset(fq, n)
        compressor.compress(fq, arc, device=dev)
        print(f"[rans] streams of a {n}-read archive")
        chip_smoke.phase1_rans(dev, container.read_container(arc)[1], report)
    print(json.dumps({"kernels": list(report.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
