"""The program's own spans in a traced segment, and three rules that tie
the card's work to them.

The port opens ``torch.profiler.record_function`` spans at its layer
boundaries (``iffnerf_tpu_torch/tracing.py``); they reach the chrome trace
as ``user_annotation`` events. A program span is one whose name starts
with a layer prefix of ``PREFIXES``; the harness's own spans and torch's
(``Optimizer.step#...``) are not. Only ``Trace``'s public attributes are
read (``device``, ``host``, ``launch_ts``, ``spans``, ``units``,
``busy_intervals()``).

- ``under(trace, names)``: the device ops whose launch falls inside an
  instance of one of the spans, launched on the span's own thread or on
  a thread with no program span open then (autograd's device thread while
  the caller blocks in ``backward`` or ``autograd.grad``).
- ``backward_of(trace, names)``: the kernels launched inside an
  ``autograd::engine::evaluate_function: ...`` event whose ``Sequence
  number`` is that of a forward op that ran under one of the spans. A
  forward op records the sequence number the next autograd node will
  take, so several ops can carry one number: the node belongs to the last
  of them, the op that made it.
- ``idle_under(trace, name)``: the card's idle gaps whose start falls
  while the span is open on the main thread: of the threads that open
  program spans, the one that launched the most work.

Device ops launched inside a ``trace.count`` span (a counter's device
sum) are left out everywhere. The readers give values a unit
(``trace.units``) and None where a span never opened.
"""

from __future__ import annotations

import bisect
import collections
import weakref

PREFIXES = ("pose.", "train.", "render.", "field.", "id.", "trace.")
COUNT = "trace.count"
BACKWARD = "autograd::engine::evaluate_function: "

_INDEX = weakref.WeakKeyDictionary()


def is_program(name: str) -> bool:
    return name.startswith(PREFIXES)


class _Intervals:
    """Closed intervals on one thread, sorted, for point queries."""

    def __init__(self, spans):
        self.spans = sorted((s, t) for s, t in spans)
        self.starts = [s for s, _ in self.spans]
        # the latest end among intervals starting at or before each one
        self.reach = []
        for _, t in self.spans:
            self.reach.append(max(t, self.reach[-1]) if self.reach else t)

    def holds(self, ts: float) -> bool:
        i = bisect.bisect_right(self.starts, ts) - 1
        return i >= 0 and self.reach[i] >= ts


class _Index:
    """A trace's program spans by (name, thread) and by thread, and each
    device op's launch."""

    def __init__(self, trace):
        by_name = collections.defaultdict(list)
        by_tid = collections.defaultdict(list)
        for name, spans in trace.spans.items():
            if not is_program(name):
                continue
            for s, t, tid in spans:
                by_name[(name, tid)].append((s, t))
                by_tid[tid].append((s, t))
        self.by_name = {k: _Intervals(v) for k, v in by_name.items()}
        self.by_tid = {k: _Intervals(v) for k, v in by_tid.items()}
        self.names = {name for name, _ in by_name}
        self.tids = collections.defaultdict(list)
        for name, tid in by_name:
            self.tids[name].append(tid)
        self.ops = []  # (event, launch ts, launch tid), counters' left out
        for e in trace.device:
            launch = trace.launch_ts.get(e.get("args", {}).get("correlation"))
            if launch is None:
                continue
            ts, tid = launch
            cnt = self.by_name.get((COUNT, tid))
            if cnt is not None and cnt.holds(ts):
                continue
            self.ops.append((e, ts, tid))

    def inside(self, name: str, ts: float, tid) -> bool:
        """Whether a launch at ``ts`` on ``tid`` falls under ``name``."""
        own = self.by_name.get((name, tid))
        if own is not None and own.holds(ts):
            return True
        open_here = self.by_tid.get(tid)
        if open_here is not None and open_here.holds(ts):
            return False
        return any(self.by_name[(name, t)].holds(ts)
                   for t in self.tids[name] if t != tid)


def index(trace) -> _Index:
    idx = _INDEX.get(trace)
    if idx is None:
        idx = _INDEX[trace] = _Index(trace)
    return idx


def opened(trace, names) -> bool:
    """Whether any of the spans ``names`` opened in the trace."""
    return bool(set(names) & index(trace).names)


def under(trace, names) -> list:
    """Device ops (kernels, copies, sets) under any of the spans."""
    idx = index(trace)
    names = [n for n in names if n in idx.names]
    return [e for e, ts, tid in idx.ops
            if any(idx.inside(n, ts, tid) for n in names)]


def backward_of(trace, names) -> list:
    """Device ops launched by the backward of the autograd nodes that ops
    under the spans ``names`` made."""
    idx = index(trace)
    names = [n for n in names if n in idx.names]
    maker = {}  # sequence number -> (ts, tid) of the op that made the node
    evaluate = []
    for e in trace.host:
        args = e.get("args", {})
        seq = args.get("Sequence number")
        if seq is None or e["cat"] != "cpu_op":
            continue
        if e["name"].startswith(BACKWARD):
            evaluate.append((seq, e))
        elif not args.get("Fwd thread id") and not \
                e["name"].startswith("autograd::"):
            if seq not in maker or e["ts"] >= maker[seq][0]:
                maker[seq] = (e["ts"], e.get("tid"))
    ours = collections.defaultdict(list)
    for seq, e in evaluate:
        made = maker.get(seq)
        if made is None:
            continue
        ts, tid = made
        if any(idx.by_name.get((n, tid)) is not None
               and idx.by_name[(n, tid)].holds(ts) for n in names):
            ours[e.get("tid")].append((e["ts"], e["ts"] + e["dur"]))
    inside = {tid: _Intervals(v) for tid, v in ours.items()}
    return [e for e, ts, tid in idx.ops
            if tid in inside and inside[tid].holds(ts)]


def kernels(ops) -> list:
    return [e for e in ops if e.get("cat") == "kernel"]


def device_ms(trace, ops) -> float:
    """Device ms a unit of the kernels among ``ops`` (each counted once)."""
    unique = {id(e): e for e in kernels(ops)}
    return sum(e["dur"] for e in unique.values()) * 1e-3 / trace.units


def main_tid(trace):
    """The thread that launched the most device work among those that
    opened program spans (autograd's device thread opens none)."""
    spanned = {tid for _, tid in index(trace).by_name}
    counts = collections.Counter(t for _, t in trace.launch_ts.values()
                                 if t in spanned)
    return counts.most_common(1)[0][0] if counts else None


def idle_under(trace, name: str) -> float | None:
    """Idle ms a unit whose gap began while ``name`` was open on the main
    launching thread; None where the span never opened there."""
    held = index(trace).by_name.get((name, main_tid(trace)))
    if held is None:
        return None
    busy = trace.busy_intervals()
    total = sum(nxt - end for (_, end), (nxt, _) in zip(busy, busy[1:])
                if held.holds(end))
    return total * 1e-3 / trace.units


def covered_share(trace, roots) -> float | None:
    """The share (%) of the segment's kernel time under the root spans."""
    total = sum(e["dur"] for e in kernels(e for e, _, _ in index(trace).ops))
    if not total or not opened(trace, roots):
        return None
    return 100.0 * sum(e["dur"] for e in kernels(under(trace, roots))) / total
