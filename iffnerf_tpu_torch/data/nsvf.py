"""NSVF-layout helpers (reference dataLoader/nsvf.py). The NSVF loader
itself is not ported yet; Tanks&Temples shares its split rule."""

from __future__ import annotations

import os


def _split_files(root: str, sub: str, split: str):
    """Sorted files of ``root/sub`` for a split: ``0_`` train, ``1_`` val,
    ``2_`` test (``1_`` when a scene has no ``2_``)."""
    files = sorted(os.listdir(os.path.join(root, sub)))
    prefix = {"train": "0_", "val": "1_"}.get(split)
    if prefix is not None:
        return [f for f in files if f.startswith(prefix)]
    test = [f for f in files if f.startswith("2_")]
    if not test:
        test = [f for f in files if f.startswith("1_")]
    return test
