"""Readings of a cell's control and faults, at the cell's size, on a card.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13

For each seed, the cell's driver builds the inputs a run of that seed
would, and puts in the program's place (a) the reference computed in the
precision below the configuration's (float32 products in TF32), and, for a
training cell, (b) the reference with half of each batch left out, the
mean over the rest. It prints one JSON line a seed with the numbers that
the cell compares, as a run prints them, beside the cell's limits. The
limits are set between the program's readings (the runs' own) and these.
A state left unchanged reads 1 by the training numbers' measure and is
not run. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench.run import CHECKOUT, _cache_dirs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    _cache_dirs()

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec(CHECKOUT)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.cell_run(spec, args.workload, seed, 0.0, False,
                               "cuda:0", time.perf_counter())
        t0 = time.perf_counter()
        readings = harness.driver(run).control(run)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": readings, "limits": run.limits,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
