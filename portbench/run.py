"""Runs one cell of the port's benchmark once and prints its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``iffnerf_tpu_torch`` beside
``BENCHMARK.json``. Set-up (imports, kernel builds, inputs, warm-up and the
steps the comparison follows) counts from the process's start to the first
timed unit. Then the window runs units for ``--seconds``; with ``--trace
1`` a traced segment follows. Last, the reference checks what the program
produced. The last line of standard output is the result (JSON); the last
lines of standard error each give a number compared and its limit. Without
a CUDA card, or with modules of JAX or the JAX package loaded once the
window has closed, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own ``build/kernels`` is there already); JAX kept out of
    libraries that would load it."""
    cache = CHECKOUT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()

    import torch

    from portbench import harness

    spec = harness.load_spec(CHECKOUT)
    entry = next((w for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = harness.cell_run(spec, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda:0", T_START)
    out = harness.execute(run)
    for line in harness.check_lines(out):
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
