"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmarks/tools/readings.py --workload <cell> \\
        --seeds <n,n,...> --control-seeds <n,n,...> --seconds <s>

runs the cell in this one process once per seed as the benchmark runs
it (a short window at the cell's own load) and once per control seed
with the program in its next lower precision tier, and prints each
run's numbers (one JSON line each), then per number the largest reading
of the program's seeds (the lower reading) and the smallest of the
control's (the upper reading). The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    sys.path[:0] = [ROOT, BENCH_DIR]
    import torch

    from harness import runner

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    runs = [(int(s), False) for s in a.seeds.split(",") if s]
    runs += [(int(s), True) for s in a.control_seeds.split(",") if s]
    got = {False: [], True: []}
    for seed, control in runs:
        t0 = time.perf_counter()
        out = runner.run_cell(a.workload, seed, a.seconds, False,
                              device="cuda", control=control, root=ROOT)
        nums = {k: v["value"] for k, v in out["checks"].items()}
        got[control].append(nums)
        print(json.dumps(dict(workload=a.workload, seed=seed,
                              control=control, correct=out["correct"],
                              seconds=time.perf_counter() - t0,
                              metrics={k: v["value"] for k, v in
                                       out["metrics"].items()},
                              numbers=nums)), flush=True)
    names = sorted({k for r in got[False] + got[True] for k in r})
    summary = {}
    for k in names:
        lo = [r[k] for r in got[False] if r.get(k) is not None]
        up = [r[k] for r in got[True] if r.get(k) is not None]
        summary[k] = dict(lower=max(lo) if lo else None,
                          upper=min(up) if up else None,
                          program=sorted(lo), control=sorted(up))
    print(json.dumps(dict(workload=a.workload, summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
