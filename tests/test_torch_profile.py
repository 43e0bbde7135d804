"""The port's profiler (``iffnerf_tpu_torch/profile_cli.py``, the
counterpart of ``profile_performance.py``) on the CPU at small sizes: its
sections under profile_performance.py's labels, each line parsed, every
time and FLOP count positive and the peak shares n/a; the FLOP counter
against analytic counts; the trace file."""

import json
import math
import os
import re

import pytest
import torch

from iffnerf_tpu_torch import profile_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the test's sizes: candidate rays, image side, ViT depth, top-k
N_RAYS, IMG_SIDE, DEPTH, K_TOP = 2000, 96, 1, 16
SMALL = ["--config", os.path.join(REPO, "configs", "lego.txt"), "--device",
         "cpu", "--N_voxel_init", "4096", "--batch_size", "128",
         "--nSamples", "64"]
LINE = re.compile(r"^(?P<label>.+?): (?P<ms>[0-9.]+) ms \(device n/a\)  "
                  r"(?P<flops>[0-9.]+) (?P<unit>[TGM]?FLOPs)(  \[.+\])?$")
SHARE = re.compile(r"^ {10}(?P<tflops>[0-9.]+) TFLOP/s = n/a of the time at "
                   r"the H100 peaks \(bf16 [0-9.]+ [TGM]?FLOPs, float32 "
                   r"[0-9.]+ [TGM]?FLOPs\); bytes n/a$")
UNITS = {"TFLOPs": 1e12, "GFLOPs": 1e9, "MFLOPs": 1e6, "FLOPs": 1.0}


@pytest.fixture(scope="module", params=["exact", "fused"])
def profiled(request, tmp_path_factory):
    """profile_cli.main on the CPU at the test's sizes, the pose program
    on its exact route and (IFFNERF_FUSED_POSE=1) on K2's, the second
    with --trace -> (route, records, printed lines, trace dir)."""
    trace = tmp_path_factory.mktemp("trace")
    argv = SMALL + (["--trace", str(trace)] if request.param == "fused"
                    else [])
    lines = []
    env = {"IFFNERF_FUSED_POSE": "1" if request.param == "fused" else "0"}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        records = profile_cli.main(argv, n_rays=N_RAYS, img_side=IMG_SIDE,
                                   depth=DEPTH, k_top=K_TOP, reps=2,
                                   steps_in_row=3, log=lines.append)
    return request.param, records, lines, trace


def test_sections_print_and_parse(profiled):
    """profile_performance.py's sections in its order, each a line that
    parses (ms, FLOPs) and a line of TFLOP/s and shares (n/a on the CPU,
    bytes n/a); every time and count positive and finite, as printed."""
    route, records, lines, trace = profiled
    labels = [r["section"] for r in records]
    assert labels[:3] == ["forward", "train step (fwd+bwd+adam)",
                          "train step (x3 in a row, one synchronize)"]
    tag = "fused K2 scoring" if route == "fused" else "exact scoring"
    assert labels[3] == f"pose program ({N_RAYS} rays, bf16, {tag})"
    assert labels[4].startswith(f"pose program BANKED ({N_RAYS} rays, bank ")
    assert lines[0] == "device: cpu; peak shares n/a"
    body = [ln for ln in lines[1:] if not ln.startswith("profiler trace")]
    assert len(body) == 2 * len(records)
    for rec, head, share in zip(records, body[::2], body[1::2]):
        m, s = LINE.match(head), SHARE.match(share)
        assert m and s, (head, share)
        assert m["label"] == rec["section"]
        assert math.isclose(float(m["ms"]), rec["ms"], rel_tol=1e-3,
                            abs_tol=1e-3)
        flops = float(m["flops"]) * UNITS[m["unit"]]
        assert math.isclose(flops, sum(rec["flops"].values()), rel_tol=1e-2)
        assert rec["ms"] > 0 and math.isfinite(rec["ms"]) and flops > 0
        assert rec["device_ms"] is None and rec["share"] is None
        assert rec["tflops"] > 0
    json.dumps(records)


def test_pose_flops_cover_the_logits(profiled):
    """The pose programs' counts are at least the logits' analytic 2 P R D
    (256 patches, D = 384); on K2's and K1's routes the scoring's part is
    counted as bf16, the rest float32 (the port's bf16 matmuls upcast)."""
    route, records, _, _ = profiled
    logits = 2 * 256 * N_RAYS * 384
    pose, banked = records[3], records[4]
    assert sum(pose["flops"].values()) >= logits
    assert sum(banked["flops"].values()) >= logits
    assert banked["flops"]["bfloat16"] == logits
    if route == "fused":
        assert pose["flops"]["bfloat16"] > logits
        assert "exact route" in pose["note"]
    else:
        assert pose["flops"]["bfloat16"] == 0
    assert f"{profile_cli.K1_PASSES} passes" in banked["note"]


def test_trace_is_written(profiled):
    """--trace DIR writes a torch.profiler trace of 5 train steps."""
    route, _, lines, trace = profiled
    if route != "fused":
        assert not any(ln.startswith("profiler trace") for ln in lines)
        return
    assert lines[-1] == f"profiler trace written to {trace}"
    with open(trace / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_count_flops_splits_by_dtype(dtype):
    """count_flops: a [64, 32] x [32, 48] matmul is 2 x 64 x 32 x 48 FLOPs,
    tallied under its operands' dtype; elementwise work is not counted."""
    a, b = torch.ones(64, 32, dtype=dtype), torch.ones(32, 48, dtype=dtype)
    got = profile_cli.count_flops(lambda: (a @ b).exp() + 1)
    key = "bfloat16" if dtype == torch.bfloat16 else "float32"
    assert got[key] == 2 * 64 * 32 * 48
    assert sum(got.values()) == got[key]


def test_mfu_shares_on_the_card():
    """A program's share is the time its counted FLOPs need at the H100's
    peaks over its measured time: 67 GFLOPs of float32 and 989 GFLOPs of
    bf16 in 2 ms is 1 ms at each peak, a share of 1."""
    rec = profile_cli.mfu({"float32": 67e9, "bfloat16": 989e9}, 2.0, True)
    assert math.isclose(rec["share"], 1.0)
    assert math.isclose(rec["tflops"], (67e9 + 989e9) / 2e-3 / 1e12)
    assert profile_cli.mfu({"float32": 1e9, "bfloat16": 0}, 1.0,
                           False)["share"] is None
