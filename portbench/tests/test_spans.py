"""``portbench/spans.py``'s rules and the readers of the program's spans and
counters, on a synthetic chrome trace worked out by hand.

The trace: a main thread (tid 1) runs one training step inside program
spans; autograd's device thread (tid 2) runs two backward functions whose
sequence numbers lead back to forward ops; a third thread (tid 3) launches
under a program span of its own; a counter's kernel runs inside
``trace.count``. Times in us, two units.
"""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, spans
from portbench.trace import Trace

MAIN, AUTOGRAD, OTHER = 1, 2, 3


def _span(name, ts, end, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": end - ts, "tid": tid}


def _op(name, ts, seq, tid=MAIN, dur=1, fwd_tid=0):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": {"Sequence number": seq,
                                 "Fwd thread id": fwd_tid}}


def _launch(corr, ts, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 0.5, "tid": tid, "args": {"correlation": corr}}


def _kernel(corr, ts, dur, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _events():
    ev = [
        _span("train.step", 0, 100), _span("train.forward", 0, 40),
        _span("field.features", 5, 20), _span("trace.count", 25, 30),
        _span("render.shading", 30, 38), _span("train.backward", 40, 90),
        _span("train.adam", 90, 100),
        _span("Optimizer.step#Adam.step", 91, 99),
        _span("pose.image_queries", 92, 94, tid=OTHER),
        # forward ops: 7 made in field.features; 8 shown first by an op
        # that made no node (in train.forward), then made in render.shading
        _op("IffFeatures", 6, 7), _op("aten::abs", 21, 8),
        _op("aten::mm", 31, 8),
        # the backward functions on autograd's thread
        _op("autograd::engine::evaluate_function: MmBackward0", 45, 8,
            tid=AUTOGRAD, dur=10, fwd_tid=1),
        _op("MmBackward0", 45.5, 8, tid=AUTOGRAD, dur=9, fwd_tid=1),
        _op("autograd::engine::evaluate_function: IffFeaturesBackward", 60,
            7, tid=AUTOGRAD, dur=10, fwd_tid=1),
    ]
    # (correlation, launch ts, launch thread, kernel start, kernel dur)
    launches = [(1, 7, MAIN, 10, 4), (2, 26, MAIN, 14, 1),
                (3, 32, MAIN, 33, 3), (4, 50, AUTOGRAD, 51, 8),
                (5, 65, AUTOGRAD, 66, 6),
                (6, 95, MAIN, 96, 2), (7, 105, MAIN, 111, 1),
                (8, 51, AUTOGRAD, 52, 1), (9, 52, AUTOGRAD, 53, 1),
                (10, 53, AUTOGRAD, 54, 1), (11, 54, AUTOGRAD, 55, 1),
                (12, 93, OTHER, 96.5, 1)]
    for corr, ts, tid, start, dur in launches:
        ev += [_launch(corr, ts, tid), _kernel(corr, start, dur)]
    return ev


@pytest.fixture
def trace():
    return Trace(_events(), window_s=200e-6, units=2)


def _corrs(ops):
    return sorted(e["args"]["correlation"] for e in ops)


def test_program_spans_by_prefix():
    assert spans.is_program("field.features")
    assert not spans.is_program("Optimizer.step#Adam.step")
    assert not spans.is_program("portbench.image_queries")
    from iffnerf_tpu_torch.tracing import SPANS

    assert all(spans.is_program(name) for name, _ in SPANS)


@pytest.mark.parametrize("names,want", [
    (("field.features",), [1]),
    (("render.shading",), [3]),
    (("train.adam",), [6]),  # the third thread has a span of its own open
    # autograd's thread, with no program span open, falls under the span
    # the caller blocks in
    (("train.backward",), [4, 5, 8, 9, 10, 11]),
    (("train.step",), [1, 3, 4, 5, 6, 8, 9, 10, 11]),
    (("pose.image_queries",), [12]),
    (("trace.count",), []),  # a counter's kernels are left out everywhere
    (("pose.estimate",), []),
])
def test_under(trace, names, want):
    assert _corrs(spans.under(trace, names)) == want


@pytest.mark.parametrize("names,want", [
    (("field.features",), [5]),
    # 8's node was made by aten::mm in render.shading, not by aten::abs
    (("render.shading",), [4, 8, 9, 10, 11]),
    (("train.forward",), [4, 5, 8, 9, 10, 11]),
    (("field.mask_lookup",), []),
])
def test_backward_of(trace, names, want):
    assert _corrs(spans.backward_of(trace, names)) == want


@pytest.mark.parametrize("name,want_us", [
    # gaps start at 15, 36, 59, 72 and 98 (busy: 10-15, 33-36, 51-59,
    # 66-72, 96-98, 111-112)
    ("field.features", 18), ("render.shading", 15),
    ("train.forward", 18 + 15), ("train.backward", 7 + 24),
    ("train.adam", 13), ("train.step", 18 + 15 + 7 + 24 + 13),
])
def test_idle_under(trace, name, want_us):
    # the main thread is MAIN, not autograd's, which launched more
    assert spans.main_tid(trace) == MAIN
    assert spans.idle_under(trace, name) == pytest.approx(want_us * 1e-3 / 2)


def test_idle_under_a_span_of_another_thread_is_none(trace):
    assert spans.idle_under(trace, "pose.image_queries") is None


def test_covered_share(trace):
    # all kernels but the counter's: 29 us, 27 of them under train.step
    assert spans.covered_share(trace, ("train.step",)) == \
        pytest.approx(100 * 27 / 29)
    assert spans.covered_share(trace, ("pose.estimate",)) is None


def _measure(tr):
    return harness.Measure(trace=tr, host={}, counts={}, marks={})


NEW = {"pose.image_device_ms": 0.0005,  # kernel 12, on the third thread
       "pose.topk_solve_device_ms": None,
       "pose.launches": None,
       "pose.image_idle_ms": None,  # not open on the main thread
       # 4 + 6 us of field kernels (kernel 1, kernel 5's backward)
       "train.field_device_ms": 0.005,
       # 3 us + the backward of aten::mm: 8 + 4
       "train.shading_device_ms": 0.0075,
       "train.launches": 4.5,
       "train.forward_idle_ms": 0.0165,
       "id.image_losses_device_ms": None, "id.launches": None,
       "id.image_losses_idle_ms": None}


@pytest.mark.parametrize("name", sorted(NEW))
def test_span_readers_by_hand(trace, name):
    got = harness.reader(name).read(_measure(trace))
    assert got == (None if NEW[name] is None else pytest.approx(NEW[name]))


@pytest.mark.parametrize("name", sorted(NEW) + ["train.live_share",
                                                 "train.app_share"])
def test_readers_without_a_trace(name):
    assert harness.reader(name).read(_measure(None)) is None


def test_readers_on_a_trace_without_program_spans():
    tr = Trace([_span("portbench.image_queries", 0, 10), _launch(1, 2),
                _kernel(1, 3, 4)], window_s=20e-6, units=1)
    for name in NEW:
        assert harness.reader(name).read(_measure(tr)) is None, name


@pytest.mark.parametrize("name,want", [("train.live_share", 40.0),
                                       ("train.app_share", 10.0)])
def test_counter_readers(trace, name, want):
    from iffnerf_tpu_torch import tracing

    tracing.reset_counters()
    reader = harness.reader(name)
    assert reader.read(_measure(trace)) is None  # no counters
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("render.samples", 100)
        tracing.count("render.live_samples", torch.arange(100) < 40)
        tracing.count("render.app_samples", torch.arange(100) < 10)
    try:
        assert reader.read(_measure(trace)) == pytest.approx(want)
    finally:
        tracing.reset_counters()


def test_split_by_hand(trace):
    from portbench.split import main, split

    got = split(trace)
    assert got["spans"]["train.step"]["ops"] == 4.5
    assert got["spans"]["field.features"]["backward_ms"] == \
        pytest.approx(0.003)
    assert got["idle_ms"] == pytest.approx(0.0385)
    assert got["root_share"] == pytest.approx(100 * 27 / 29)
    # kernel 7 alone runs outside every span
    assert got["outside_ms"] == [("k", pytest.approx(0.0005))]
    if not torch.cuda.is_available():
        assert main(["--workload", "lego_vm.pose_sweep", "--seed", "1",
                     "--seconds", "1"]) == 2
