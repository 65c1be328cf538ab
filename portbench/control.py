#!/usr/bin/env python3
"""The control of a cell, at the cell's own size: the plain reference
put in the program's place, one precision lower, judged by the same
numbers as a run of the program.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

Prints one JSON line a seed: each compared number beside its limit and
`correct`, judged by the function the benchmark's runs use (run.judge).
A limit is sound only where the control comes out not correct (see
PERF.md); the benchmark's own runs never run this.  The dist cells'
control computes the estimators in bfloat16 from the exact registers.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import jobs, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    _, cell, config, traffic, limits = run.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        job = jobs.make(config, traffic, seed, torch.device("cuda", 0))
        try:
            job.setup()
            numbers = job.check(control=True)
        finally:
            job.close()
        checks, correct = run.judge(numbers, limits, 0)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": correct, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
