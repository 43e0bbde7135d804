"""The benchmark's files, counts, references, rehearsals of every cell at
tiny sizes on the CPU, and the faults that ``correct`` has to catch."""

from __future__ import annotations

import ast
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import tiny
from portbench import counts, harness, make
from portbench.drivers import steps
from portbench.reference import field as ref_field
from portbench.reference import pose as ref_pose
from portbench.trace import Trace

ROOT = Path(harness.ROOT)
SPEC = harness.load_spec(ROOT.parent)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


# --------------------------------------------------------------------------
# files
# --------------------------------------------------------------------------


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names), names
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert entry["chips"] == 1 and _line(entry["why"])
    assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
    run = harness.cell_run(SPEC, cell, 1, 1.0, False, "cpu", 0.0)
    assert _line(run.traffic["why"])
    assert run.traffic["end_to_end"] in {m["name"] for m in SPEC["end_to_end"]}
    assert set(run.limits) and all(v > 0 for v in run.limits.values())
    for hook in ("prepare", "unit", "drain", "tally", "traced_hooks", "host",
                 "counts", "marks", "check", "control"):
        assert callable(getattr(harness.driver(run), hook))


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    data = harness.load_json(ROOT.parent / conf["file"])
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    assert _line(conf["source"]) and conf["source"].startswith("https://")
    assert data["reduced"] == conf["reduced"] == []
    assert isinstance(data["assumed"], dict) and data["assumed"]
    assert data["precision"] == "float32"


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_readers_declare_what_the_spec_says(metric):
    mod = harness.reader(metric["name"])
    assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
        metric["layer"], metric["unit"], metric["moves"], metric["source"])
    assert _line(metric["layer"])
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for cell in metric["workloads"]:
        assert cell in CELLS and harness.covers(e2e[metric["moves"]], cell)


def test_every_cell_reports_setup_and_another_metric():
    for cell in CELLS:
        e2e = [m["name"] for m in SPEC["end_to_end"] if harness.covers(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_and_a_plain_reference():
    for path in ROOT.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "iffnerf_tpu"}, path
        if "reference" in path.parts:
            assert not tops & {"iffnerf_tpu_torch"}, path


# --------------------------------------------------------------------------
# counts
# --------------------------------------------------------------------------


def _pose():
    return harness.load_json(ROOT / "configs" / "lego_vm.json")["pose"]


def test_pose_counts_by_hand():
    pose = _pose()
    # ViT-S/14: 257 tokens; a block 2*257*(384*1152 + 384^2 + 2*384*1536)
    # plus the two attention products 2*2*257^2*384; patch embedding
    block = 2 * 257 * (384 * 1152 + 384 * 384 + 2 * 384 * 1536) \
        + 4 * 257 * 257 * 384
    assert counts.vit_forward_flops(pose["vit"]) == 12 * block \
        + 2 * 256 * 588 * 384
    rays = 540_000
    assert counts.logit_flops(pose, rays) == 2 * 256 * rays * 384
    assert counts.k1_least_s(pose, rays) == pytest.approx(
        2 * 256 * rays * 384 / 165e12)
    assert counts.pose_frame_flops(pose, rays) == pytest.approx(118.4e9,
                                                               rel=2e-3)
    assert counts.ray_in_dim(pose) == 141
    assert counts.ray_mlp_macs(pose) == 141 * 256 + 256 * 256 \
        + 397 * 256 + 256 * 384
    assert counts.id_step_flops(pose, rays, 32) == pytest.approx(12.8e12,
                                                                rel=0.01)


def test_field_counts_by_hand():
    vm = harness.load_json(ROOT / "configs" / "lego_vm.json")["field"]
    cp = harness.load_json(ROOT / "configs" / "lego_cp.json")["field"]
    assert counts.n_samples(vm) == 1039 and counts.n_samples(cp) == 1731
    assert counts.table_elems(vm) == 3 * (300 * 300 + 300) * 64
    assert counts.table_elems(cp) == (505 + 505 + 489) * 384
    assert counts.sample_flops(vm) == 3 * 64 * 10 + 192 + 48 + 2 * 144 * 27
    tiny_vm = dict(vm, grid_size=[2, 2, 2], density_n_comp=[1, 1, 1],
                   app_n_comp=[1, 1, 1])
    n = 10
    tables = 4 * 3 * (4 + 2) * 2
    want = ((n * 16 + n * 3 * 4 + tables) + (n * 16 + n * 3 * 4 + 2 * tables)
            + (n * 64 + 8 * 4)) / 3.35e12
    assert counts.field_least_s(tiny_vm, n, 8) == pytest.approx(want)


# --------------------------------------------------------------------------
# references against hand cases and the port's plain versions
# --------------------------------------------------------------------------


def test_lerp_and_mask_by_hand():
    line = torch.tensor([[0.0], [10.0], [20.0]])
    got = ref_field.lerp_line(line, torch.tensor([-1.0, -0.5, 0.25, 1.0, 1.5]))
    # 1.5 lies half a texel past the end: half the last texel, half zero
    assert got[:, 0].tolist() == pytest.approx([0.0, 5.0, 12.5, 20.0, 10.0])
    plane = torch.arange(4.0).reshape(2, 2, 1)
    got = ref_field.lerp_plane(plane, torch.tensor([0.0]), torch.tensor([0.0]))
    assert float(got) == pytest.approx(1.5)
    vol = torch.zeros(2, 2, 2)
    vol[1, 1, 1] = 8.0
    assert float(ref_field.mask_lookup(vol, torch.zeros(1, 3))) == \
        pytest.approx(1.0)


def test_ide_matches_the_port():
    from iffnerf_tpu_torch.ops.ide import integrated_dir_enc

    g = torch.Generator().manual_seed(0)
    d = torch.randn(64, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    k = torch.rand(64, 1, generator=g)
    assert torch.allclose(ref_field.ide(d, k), integrated_dir_enc(d, k),
                          atol=2e-5)


def test_solve_by_hand():
    centre = np.array([0.3, -0.2, 2.0])
    g = np.random.default_rng(0)
    ori = g.normal(size=(6, 3))
    dirs = centre - ori
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    c2w = ref_pose.solve(ori, dirs, np.ones(6), np.array([0.0, 0.0, 1.0]))
    assert np.allclose(c2w[:3, 3], centre)
    assert np.allclose(c2w[:3, :3] @ c2w[:3, :3].T, np.eye(3))
    # every origin shared: nothing kept, the identity
    same = np.repeat(ori[:1], 6, 0)
    assert np.array_equal(ref_pose.solve(same, dirs, np.ones(6),
                                         np.array([0.0, 0.0, 1.0])), np.eye(4))


def test_topk_takes_the_lower_index_first():
    s = torch.tensor([0.5, 0.9, 0.5, 0.9, 0.1])
    assert ref_pose.topk(s, 3).tolist() == [1, 3, 0]


def test_pose_reference_matches_the_port_at_tiny_sizes():
    from iffnerf_tpu_torch.pose.id_module import image_queries, ray_bank
    from portbench.drivers.pose_sweep import id_config

    pose = dict(_pose(), **tiny.POSE)
    params = make.id_params(5, "cpu", pose)
    imgs, masks = make.frames(5, "cpu", 1, 40, 48)
    rays = make.candidate_rays(5, "cpu", 30, 9)
    cfg = id_config(pose, "float32", False)
    q, valid, _ = image_queries(params, cfg, imgs[0], masks[0])
    q_ref, valid_ref = ref_pose.queries(params, pose, imgs[0], masks[0])
    assert torch.equal(valid, valid_ref)
    assert torch.allclose(q, q_ref, rtol=1e-5, atol=1e-5)
    k = ray_bank(params, cfg, *rays, device="cpu")
    assert torch.allclose(k, ref_pose.keys(params, pose, *rays), rtol=1e-5,
                          atol=1e-5)


def test_unflatten_inverts_named():
    tree = {"a": ({"w": torch.zeros(1)}, {"w": torch.ones(1)}),
            "b": {"c": torch.zeros(2)}}
    back = steps.unflatten(dict(steps.named(tree)))
    assert [k for k, _ in steps.named(back)] == [k for k, _ in
                                                 steps.named(tree)]
    assert isinstance(back["a"], tuple)


def test_gaps_by_hand():
    got, want = steps.Record({}), steps.Record({})
    for r, scale in ((got, 1.1), (want, 1.0)):
        r.losses = [2.0 * scale]
        r.before = {"a": torch.zeros(2), "b": torch.zeros(2)}
        r.grad1 = {"a": torch.tensor([3.0 * scale, 4.0 * scale]),
                   "b": torch.tensor([1e-9, 0.0])}
        r.after = {"a": torch.tensor([0.0, scale]), "b": torch.ones(2)}
    out = steps.gaps(got, want)
    # b's gradient is under a thousandth of the median's: left out
    assert out["loss_gap"] == pytest.approx(0.1)
    assert out["grad_gap"] == pytest.approx(0.1)
    assert out["change_gap"] == pytest.approx(0.1)


# --------------------------------------------------------------------------
# the trace reader
# --------------------------------------------------------------------------


def test_trace_reader_on_a_synthetic_trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "span", "ts": 0,
         "dur": 10, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 2, "dur": 1, "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 20, "dur": 1, "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 30,
         "dur": 40, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "void iff::banked_pass<float>",
         "ts": 5, "dur": 20, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 15, "dur": 20,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 60, "dur": 10,
         "args": {"correlation": 9}},
    ]
    tr = Trace(ev, window_s=100e-6, units=2)
    assert tr.busy_s() == pytest.approx(40e-6)
    assert tr.kernel_s("banked") == pytest.approx(20e-6)
    assert tr.kernel_s_in_span("span") == pytest.approx(20e-6)
    assert tr.kernel_s_in_span("absent") is None
    assert tr.idle_gaps() == [["aten::item", pytest.approx(25e-6)]]
    assert tr.top_ops()[0][0] == "gemm"


# --------------------------------------------------------------------------
# rehearsals and faults
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct(cell):
    out = harness.execute(tiny.run(cell))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    e2e = {m["name"] for m in SPEC["end_to_end"] if harness.covers(m, cell)}
    assert set(out["metrics"]) == e2e
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in out["metrics"].values())
    assert list(out)[-1] == "checks"


def _half_batch_field(monkeypatch):
    from iffnerf_tpu_torch.train import trainer

    inner = trainer.train_step

    def half(config, params, opt, mask, rays, rgbs, *a, jitter=None, **kw):
        n = rays.shape[0] // 2
        return inner(config, params, opt, mask, rays[:n], rgbs[:n], *a,
                     jitter=jitter[:n], **kw)

    monkeypatch.setattr(trainer, "train_step", half)


def _half_batch_id(monkeypatch):
    from iffnerf_tpu_torch.pose import trainer

    inner = trainer.id_train_step

    def half(params, opt, imgs, masks, poses, *rays_cfg, **kw):
        n = imgs.shape[0] // 2
        *rays, cfg, _ = rays_cfg
        return inner(params, opt, imgs[:n], masks[:n], poses[:n], *rays, cfg,
                     n, **kw)

    monkeypatch.setattr(trainer, "id_train_step", half)


def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


TRAINING = [c for c in CELLS if "train" in c]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", TRAINING)
def test_training_faults_fail(cell, fault, monkeypatch):
    if fault == "unchanged":
        _unchanged(monkeypatch)
    elif "id_train" in cell:
        _half_batch_id(monkeypatch)
    else:
        _half_batch_field(monkeypatch)
    out = harness.execute(tiny.run(cell))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("part", ["c2w", "scores"])
def test_an_altered_pose_fails(part, monkeypatch):
    from iffnerf_tpu_torch.pose import solve

    inner = solve.estimate_pose_single_banked

    def altered(*a, **kw):
        c2w, scores, idx, w = inner(*a, **kw)
        if part == "c2w":
            c2w = c2w.clone()
            c2w[0, 3] += 1e-2
        else:
            scores = scores * 1.001
        return c2w, scores, idx, w

    monkeypatch.setattr(solve, "estimate_pose_single_banked", altered)
    out = harness.execute(tiny.run("lego_vm.pose_sweep"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_runs_at_tiny_sizes(cell):
    """The control's path on the CPU, where TF32 does not exist: the
    reference against itself reads at most rounding."""
    r = tiny.run(cell)
    readings = harness.driver(r).control(r)
    assert set(readings["control"]) == set(r.limits)
    assert all(v <= r.limits[k] for k, v in readings["control"].items())
    if "train" in cell:
        assert any(v > r.limits[k] for k, v in
                   readings["half_batch"].items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_a_card(cell, card):
    """The reference in TF32 in the program's place fails the limits at
    tiny sizes on a card."""
    r = tiny.run(cell, dev=card)
    readings = harness.driver(r).control(r)
    assert any(v > r.limits[k] for k, v in readings["control"].items())


def test_the_run_needs_a_card():
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1"], cwd=ROOT.parent,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""

