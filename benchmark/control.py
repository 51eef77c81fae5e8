"""The control of the comparison that decides ``correct``.

    python benchmark/control.py --workload <cell> --seeds 1 2 3

puts the configuration's reference (``harness.reference_of``) in the
program's place, with its counts narrowed to
int8 (saturating at 127, as an 8-bit accumulator of the epilogue would
hold them), and prints, a seed a line, the numbers that the comparison
of ``compare.py`` reads for it against the exact reference: the control
has to come out not correct. The configurations state exact int32
counts; int16 would still hold every count of these corpora (a protein
of at most 1,051 residues shares at most 1,047 5-mers), so int8 is the
narrowing that breaks the guarantee. It runs on the host alone, at the
cell's own size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import compare
import corpus
import harness


def control_checks(config: dict, traffic: dict, seed: int):
    """(checks, correct) of the int8 control against the reference for
    ``config`` and ``seed``: the configuration's own reference, taken as
    the harness takes it."""
    seq_buf, offsets, classes = corpus.synth_proteins(config["corpus"], seed)
    ref_impl, kwargs = harness.reference_of(config, traffic)
    ref = ref_impl.answer(seq_buf, offsets, classes, **kwargs)
    ctl = ref_impl.answer(seq_buf, offsets, classes, count_dtype=np.int8,
                          **kwargs)
    checks, _ = compare.judge([ctl], 0, ref, getattr(ref_impl, "CHECKS", {}))
    return checks, compare.passes(checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    spec = harness.load_json(harness.ROOT, "BENCHMARK.json")
    _, config, traffic = harness.cell_parts(spec, args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        checks, ok = control_checks(config, traffic, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": ok, "checks": checks,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
