"""Tiny versions of the cells, for rehearsals on the CPU: the same
configurations, traffic and limits with every size cut."""

from __future__ import annotations

import copy
import time

from portbench import harness

POSE = {"vit": {"img_size": 224, "patch_size": 14, "dim": 32, "depth": 1,
                "num_heads": 2, "mlp_ratio": 2},
        "ray_feature_c": 16, "gen_points": 60, "isocell_dirs": 9, "k": 10,
        "id_accum": 2}
# ranks cut, so the density factors' mean is raised to keep sigma about 2
FIELD = {"lego_vm": ({"grid_size": [16, 16, 16], "density_n_comp": [2, 2, 2],
                      "app_n_comp": [3, 3, 3], "feature_c": 8}, [1.45, 0.1]),
         "lego_cp": ({"grid_size": [16, 16, 15], "density_n_comp": [4, 4, 4],
                      "app_n_comp": [6, 6, 6], "feature_c": 8}, [1.45, 0.1])}
TRAFFIC = {"frames": 3, "frame_hw": [40, 48], "warm_frames": 2,
           "check_frames": 3, "check_within": 4, "pool_frames": 3,
           "warm_units": 1, "compared": 3}


def run(cell: str, seed: int = 7, seconds: float = 0.3, dev: str = "cpu"):
    spec = harness.load_spec(harness.ROOT.parent)
    r = harness.cell_run(spec, cell, seed, seconds, False, dev,
                         time.perf_counter())
    cfg = copy.deepcopy(r.config)
    cfg["pose"].update(POSE)
    field, density = FIELD[cfg["name"]]
    cfg["field"].update(field)
    cfg["init"]["density"] = density
    cfg["train"]["batch_size"] = 32
    cfg["mask_grid"] = [8, 8, 8]
    cfg["reference"]["chunk_rays"] = 12
    r.config = cfg
    r.traffic = dict(r.traffic, **{k: v for k, v in TRAFFIC.items()
                                   if k in r.traffic})
    return r
