"""Experiment-directory scanning (reference pose_estimation/eval_utils.py:4-36)."""

from __future__ import annotations

import os

CKPT_EXTS = (".npz", ".th")


def get_highest_valid_checkpoint(root_dir: str) -> str:
    """Latest FIELD checkpoint in the run dir; the ``id_module.npz`` that
    the pose CLI keeps beside it is never taken for the field."""
    for file_name in sorted(os.listdir(root_dir), reverse=True):
        path = os.path.join(root_dir, file_name)
        if (os.path.isfile(path) and path.endswith(CKPT_EXTS)
                and file_name != "id_module.npz"):
            return path
    return ""


def parse_exp_dir(exp_dir: str, suffix: str) -> dict:
    """Scan ``exp_dir`` for ``tensorf_<obj>_<suffix>`` run dirs and return
    {object_id: {checkpoint_filepath, sequence_id, category_name}}."""
    objects = {}
    for name in os.listdir(exp_dir):
        path = os.path.join(exp_dir, name)
        if not (os.path.isdir(path) and name.startswith("tensorf_")
                and name.endswith(suffix)):
            continue
        sequence_id = path.split("_")[-2]
        ckpt = get_highest_valid_checkpoint(path)
        if not ckpt:
            print(f"Object {sequence_id} skipped: no valid checkpoint found")
            continue
        objects[sequence_id] = {
            "checkpoint_filepath": ckpt,
            "sequence_id": sequence_id,
            "category_name": "",
        }
    return objects
