"""A traced run of one cell, split by the program's spans.

    python3 -m portbench.split --workload <cell> --seed <n> --seconds <s> \
        [--out DIR]

Runs the cell as ``portbench.run --trace 1`` does and prints its result
line; then, from the same traced segment, a unit's device ms, device ops
and idle ms under each program span (``portbench/spans.py``'s rules: the
backward through ``backward_of`` beside), each span's kernels by name,
the share of the kernel time under the unit's root span and under any
program span, and the kernels that no span holds. The split is written
to ``DIR/split_<cell>_<seed>.json`` (default ``build/portbench/split``).
Needs a CUDA card, as ``portbench.run`` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOTS = ("pose.estimate", "train.step", "id.step")


def _by_name(tr, ops, n: int = 8) -> list:
    """The kernels among ``ops`` by name (its first 100 characters), their
    ms a unit, most first."""
    by = collections.Counter()
    for e in {id(e): e for e in ops}.values():
        if e.get("cat") == "kernel":
            by[e["name"][:100]] += e["dur"] * 1e-3 / tr.units
    return by.most_common(n)


def split(tr) -> dict:
    """{span: {device_ms, backward_ms, ops, idle_ms, top}} a unit, with the
    covered shares and the top kernels outside every span."""
    from portbench import spans

    idx = spans.index(tr)
    out = {}
    for name in sorted(idx.names):
        ops = spans.under(tr, (name,))
        back = spans.backward_of(tr, (name,))
        out[name] = {"device_ms": spans.device_ms(tr, ops),
                     "backward_ms": spans.device_ms(tr, back),
                     "ops": len(ops) / tr.units,
                     "idle_ms": spans.idle_under(tr, name),
                     "top": _by_name(tr, ops + back)}
    held = {id(e) for e in spans.under(tr, sorted(idx.names))}
    loose = [e for e, _, _ in idx.ops if id(e) not in held]
    busy = tr.busy_intervals()
    idle = sum(nxt - end for (_, end), (nxt, _) in zip(busy, busy[1:]))
    return {"units": tr.units, "window_ms": tr.window_s * 1e3 / tr.units,
            "kernel_ms": spans.device_ms(tr, [e for e, _, _ in idx.ops]),
            "idle_ms": idle * 1e-3 / tr.units,
            "root_share": spans.covered_share(tr, ROOTS),
            "any_span_share": spans.covered_share(tr, sorted(idx.names)),
            "spans": out,
            "outside_ms": _by_name(tr, loose, 12)}


def main(argv=None) -> int:
    from portbench import run as bench_run

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default="build/portbench/split")
    args = p.parse_args(argv)
    bench_run._cache_dirs()

    import torch

    from portbench import harness
    from portbench import trace as trace_mod

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    kept = []
    traced = trace_mod.traced

    def keep(fn, units):
        kept.append(traced(fn, units))
        return kept[-1]

    trace_mod.traced = keep
    spec = harness.load_spec(bench_run.CHECKOUT)
    run = harness.cell_run(spec, args.workload, args.seed, args.seconds,
                           True, "cuda:0", T_START)
    line = harness.execute(run)
    result = split(kept[0])
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"split_{args.workload}_{args.seed}.json", "w") as f:
        json.dump({"line": line, "split": result}, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "spans"}),
          file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
