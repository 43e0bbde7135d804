"""Share of the rendered samples that are live: inside the AABB and past
the alpha mask (the program's counters ``render.live_samples`` over
``render.samples``, over the traced segment)."""

LAYER = "field kernels: ops/field_features.py, ops/cp_features.py, ops/gather.py"
UNIT = "%"
MOVES = "field_step_ms"
SOURCE = "program_counter"
COUNTER = "render.live_samples"


def read(m):
    if m.trace is None:
        return None
    try:
        from iffnerf_tpu_torch.tracing import counters
    except ImportError:
        return None
    totals = counters()
    if not totals.get("render.samples") or COUNTER not in totals:
        return None
    return 100.0 * totals[COUNTER] / totals["render.samples"]
