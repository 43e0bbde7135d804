"""Spans and counters of the port's layers, on the profiler's clock.

Tracing is on only while a ``torch.profiler`` session records: there is
no flag, no environment variable and no exporter of its own. A span is a
``torch.profiler.record_function`` range, so it lands in the profiler's
trace beside the host's ops and the card's kernels (CUPTI ties each
kernel to the host call that launched it, and so to the spans open then);
the profiler's chrome trace is the export. With no profiler recording,
``span`` returns one shared no-op context after one flag read, and
``count`` returns at once.

A unit's root span (``pose.estimate``, ``train.step``, ``id.step``) opens
once a frame or a step, and its children nest inside it on the calling
thread. Autograd runs a CUDA backward on a thread of its own, outside any
span: a reader ties those kernels to the forward span that made their
autograd node through the ``Sequence number`` both carry in the trace.

``span(name, mark)`` calls ``mark(label)`` when the span closes, whether
or not a profiler records, with ``label`` the name after its layer's
prefix (``train.forward`` -> ``"forward"``): the trainers' CUDA-event
hooks.

Counters add host ints or the sums of device tensors (no host sync) while
a profiler records; ``counters()`` syncs once and returns the totals,
``reset_counters()`` clears them. ``SPANS`` and ``COUNTERS`` name all the
program emits.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

SPANS = (
    ("pose.estimate", "one single-image estimate (pose/solve.py: banked, "
     "exact or sharded), from its inputs on the device to c2w"),
    ("pose.image_queries", "the image side: preprocessing, the ViT, the "
     "positional encoding and q (pose/id_module.py image_queries)"),
    ("pose.score", "the rays' scores: banked kernel, exact chain or fused "
     "ray route (pose/id_module.py score_rays, pose/solve.py)"),
    ("pose.topk", "the exact top-k of the scores (ops/topk.py)"),
    ("pose.solve", "the closed-form pose from the top-k rays "
     "(pose/solve.py solve_pose_from_topk)"),
    ("train.step", "one field optimizer step (train/trainer.py train_step)"),
    ("train.forward", "the step's loss: the batch's render and the "
     "regularisers (field_loss)"),
    ("train.backward", "the step's backward, with the mesh's gradient "
     "average"),
    ("train.adam", "the step's Adam update"),
    ("render.sample", "render_rays' samples, dists and alpha-mask test"),
    ("field.mask_lookup", "the alpha-mask lookup (models/field.py "
     "sample_alpha, K3)"),
    ("field.features", "the field's density and appearance features before "
     "basis_mat (VM kernel, CP kernel or grid samplers)"),
    ("field.basis_mat", "the appearance features' basis_mat product"),
    ("render.shading", "the shading head on the accumulated features "
     "(models/shading.py apply_shading)"),
    ("id.step", "one ID-module optimizer step (pose/trainer.py "
     "id_train_step)"),
    ("id.ray_features", "the candidate rays' features, once a step"),
    ("id.image_losses", "the loop over the step's images"),
    ("id.image_loss", "one image: per_image_loss, its gradient and the "
     "accumulation"),
    ("id.ray_backward", "the summed feature cotangent back through the ray "
     "MLP"),
    ("id.adam", "the gradients' scale and the Adam update"),
    ("trace.count", "a counter's device sum (readers leave it out)"),
)

COUNTERS = (
    ("render.samples", "samples rendered: rays x samples a render_rays call"),
    ("render.live_samples", "samples inside the AABB that pass the alpha "
     "mask (ray_valid)"),
    ("render.app_samples", "samples whose appearance is computed and gets "
     "upstream in the backward (weight over the threshold: app_mask)"),
)

_OFF = contextlib.nullcontext()
_TOTALS: dict = {}


class _Marked:
    """A span that calls ``mark(label)`` when it closes without an error."""

    __slots__ = ("inner", "mark", "label")

    def __init__(self, inner, mark, label: str):
        self.inner, self.mark, self.label = inner, mark, label

    def __enter__(self):
        return self.inner.__enter__()

    def __exit__(self, *exc):
        self.inner.__exit__(*exc)
        if exc[0] is None:
            self.mark(self.label)
        return False


def span(name: str, mark=None):
    """A context that records the span ``name`` while a profiler records
    (a shared no-op one otherwise); with ``mark``, it calls
    ``mark(label)`` on a clean exit, ``label`` the name after its first
    dot."""
    inner = (torch.profiler.record_function(name)
             if _profiler._is_profiler_enabled else _OFF)
    if mark is None:
        return inner
    return _Marked(inner, mark, name.split(".", 1)[1])


def count(name: str, value) -> None:
    """Adds ``value`` (a host int, or a device tensor's sum) to the counter
    ``name`` while a profiler records; the device sum stays on the device
    and runs inside a ``trace.count`` span."""
    if not _profiler._is_profiler_enabled:
        return
    if isinstance(value, torch.Tensor):
        with torch.profiler.record_function("trace.count"):
            value = value.detach().sum(
                dtype=(torch.float64 if value.is_floating_point()
                       else torch.int64))
            prev = _TOTALS.get(name)
            _TOTALS[name] = value if prev is None else prev + value
    else:
        _TOTALS[name] = _TOTALS.get(name, 0) + value


def counters() -> dict:
    """{counter: total} as floats, one sync a device; the totals are kept."""
    out = {k: float(v) for k, v in _TOTALS.items()
           if not isinstance(v, torch.Tensor)}
    by_device: dict = {}
    for k, v in _TOTALS.items():
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append((k, v))
    for items in by_device.values():
        values = torch.stack([v.double() for _, v in items]).tolist()
        out.update((k, float(x)) for (k, _), x in zip(items, values))
    return out


def reset_counters() -> None:
    _TOTALS.clear()
