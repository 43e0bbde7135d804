"""The device trace of a run's traced segment, read from ``torch.profiler``.

The profiler records the host's ops, the harness's ``record_function``
spans and the card's kernels, copies and sets; its chrome trace is written
to the run's ``TMPDIR``, read and deleted. A kernel is tied to the host
call that launched it by CUPTI's correlation id, and so to the spans open
at that moment on the launching thread.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Trace:
    """Kernels and host events of a traced segment (times in us)."""

    def __init__(self, events: list, window_s: float, units: int):
        self.window_s = window_s
        self.units = units
        self.device = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                              and e.get("ph") == "X"), key=lambda e: e["ts"])
        self.host = [e for e in events if e.get("cat") in HOST_CATS
                     and e.get("ph") == "X"]
        self.launch_ts = {}
        for e in self.host:
            corr = e.get("args", {}).get("correlation")
            if corr is not None and e["cat"] in ("cuda_runtime", "cuda_driver"):
                self.launch_ts[corr] = (e["ts"], e.get("tid"))
        self.spans = collections.defaultdict(list)
        for e in self.host:
            if e["cat"] == "user_annotation":
                self.spans[e["name"]].append((e["ts"], e["ts"] + e["dur"],
                                              e.get("tid")))

    def kernels(self, pattern: str | None = None) -> list:
        """Kernels whose name matches ``pattern`` (all without one)."""
        ks = [e for e in self.device if e["cat"] == "kernel"]
        if pattern is None:
            return ks
        rx = re.compile(pattern, re.IGNORECASE)
        return [e for e in ks if rx.search(e["name"])]

    def kernel_s(self, pattern: str | None = None) -> float:
        return sum(e["dur"] for e in self.kernels(pattern)) * 1e-6

    def kernel_s_in_span(self, span: str) -> float | None:
        """Seconds of the kernels launched while a ``span`` was open on the
        launching thread; None where the span never opened."""
        spans = sorted(self.spans.get(span, ()))
        if not spans:
            return None
        starts = [s[0] for s in spans]
        total = 0.0
        for k in self.kernels():
            launch = self.launch_ts.get(k.get("args", {}).get("correlation"))
            if launch is None:
                continue
            ts, tid = launch
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and spans[i][1] >= ts and spans[i][2] == tid:
                total += k["dur"]
        return total * 1e-6

    def busy_intervals(self) -> list:
        """Merged intervals [start, end] in which any kernel, copy or set
        ran."""
        out = []
        for e in self.device:
            s, t = e["ts"], e["ts"] + e["dur"]
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for e in self.device:
            by[e["name"][:120]] += e["dur"] * 1e-6
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle gaps, summed by what the host was doing when
        each began: the innermost host event open then on the thread that
        launched the most kernels ("python" between events)."""
        busy = self.busy_intervals()
        counts = collections.Counter(t for _, t in self.launch_ts.values())
        tid = counts.most_common(1)[0][0] if counts else None
        host = sorted((e for e in self.host if e.get("tid") == tid),
                      key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        by = collections.Counter()
        for (_, end), (nxt, _) in zip(busy, busy[1:]):
            label = "python"
            i = bisect.bisect_right(starts, end) - 1
            for j in range(i, max(i - 4000, -1), -1):
                if host[j]["ts"] + host[j]["dur"] >= end:
                    label = host[j]["name"][:120]
                    break
            by[label] += (nxt - end) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]


def traced(fn, units: int) -> Trace:
    """Runs ``fn()`` (which does ``units`` units of work and returns) under
    the profiler, synchronised at both ends -> its trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, window, units)
