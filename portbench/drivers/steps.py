"""What the training cells share: a parameter tree's leaves by name, the
first steps' record, and the numbers that hold a training run to the
reference.

Set-up runs the first ``compared`` steps through the window's own call and
feed and keeps: each step's loss, the first gradient as Adam got it
(worked out from its first moment after one step, m1 = (1 - beta1) g1),
the parameters before the first step and after the last compared one. The
reference follows the same steps from the same parameters and inputs. By
the worst leaf, the gap between the program's norm and the reference's,
over the reference's norm of that leaf or of the median leaf, whichever is
larger. Leaves whose reference gradient is under a thousandth of the
median leaf's move under Adam by round-off alone and are left out of both
the gradient's and the change's numbers.
"""

from __future__ import annotations

import statistics
import sys

import torch


def named(tree, prefix: str = "") -> list:
    """(path, tensor) of a nested dict/tuple's leaves, in its order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in named(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def unflatten(values: dict):
    """The nested dicts and tuples of ``values`` ({path: tensor}, as
    ``named`` gives them): a level whose keys are all indices is a
    tuple."""
    root: dict = {}
    for path, v in values.items():
        node = root
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return tuple(fix(node[str(i)]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


class Record:
    """The compared steps of a training run, as the side under test ran
    them: losses [steps], the first gradient {path: tensor}, the
    parameters before and after {path: tensor}."""

    def __init__(self, params):
        self.before = {k: t.detach().clone() for k, t in named(params)}
        self.losses = []
        self.grad1 = None
        self.after = None
        self.feeds = []


def grad_from_adam(opt: torch.optim.Optimizer, params, beta1: float) -> dict:
    """The gradient of Adam's first step, from its first moment (zero where
    Adam holds none: a step that left it untouched)."""
    out = {}
    for k, t in named(params):
        m = opt.state[t].get("exp_avg")
        out[k] = (torch.zeros_like(t) if m is None
                  else m.detach() / (1 - beta1))
    return out


def _norms(d: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in d.items()}


def gaps(got: Record, want: Record) -> dict:
    """loss_gap, grad_gap and change_gap of the side under test against the
    reference (module docstring)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got.losses, want.losses))
    g_got, g_want = _norms(got.grad1), _norms(want.grad1)
    med_g = statistics.median(g_want.values())
    live = [k for k, v in g_want.items() if v > 0 and v >= 1e-3 * med_g]
    print(f"leaves left out of grad_gap and change_gap: "
          f"{sorted(set(g_want) - set(live))}", file=sys.stderr)
    grad = max(abs(g_got[k] - g_want[k]) / max(g_want[k], med_g)
               for k in live)
    c_got = _norms({k: got.after[k] - got.before[k] for k in live})
    c_want = _norms({k: want.after[k] - want.before[k] for k in live})
    med_c = statistics.median(c_want.values())
    change = max(abs(c_got[k] - c_want[k]) / max(c_want[k], med_c, 1e-30)
                 for k in live)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}
