"""Experiment sweep of the port (the JAX package's
``extra/auto_run_paramsets.py``; reference extra/auto_run_paramsets.py:
1-207): independent ``train_cli`` processes, each pinned to one card by
``CUDA_VISIBLE_DEVICES``, with the reference's crash-tolerant folder
protocol: a run whose folder exists is skipped, a ``lockFolder`` is the
mutex (mkdir is atomic) and a ``stopFolder`` stops the launching of new
runs.

Edit PARAM_DICT below (the reference's grid format) and run:

    python -m iffnerf_tpu_torch.tools.auto_run_paramsets

``IFFNERF_DEVICES`` lists the cards to use (``0,1,2,3``), ``IFFNERF_DATA``
the NeRF-synthetic root.
"""

from __future__ import annotations

import itertools
import os
import queue
import subprocess
import sys
import threading
import time

DATA_FOLDER = os.environ.get("IFFNERF_DATA", "./data/nerf_synthetic")
EXP_FOLDER = "sweep/"
BASE_CONFIG = "configs/lego.txt"
DEVICES = os.environ.get("IFFNERF_DEVICES", "0").split(",")

PARAM_DICT = {
    "data_name": ["lego"],
    ("n_lamb_sigma", "n_lamb_sh"): [("[16,16,16]", "[48,48,48]")],
    ("shadingMode", "view_pe", "fea_pe"): [("Ref", 2, 2)],
}


def get_folder_locker(log_folder: str) -> None:
    """mkdir-as-mutex (reference :7-13)."""
    while True:
        try:
            os.makedirs(os.path.join(log_folder, "lockFolder"))
            return
        except OSError:
            time.sleep(0.01)


def release_folder_locker(log_folder: str) -> None:
    os.rmdir(os.path.join(log_folder, "lockFolder"))


def stop_requested(log_folder: str) -> bool:
    return os.path.isdir(os.path.join(log_folder, "stopFolder"))


def get_param_str(key: str, val) -> str:
    if key == "data_name":
        return f"--datadir {DATA_FOLDER}/{val} "
    return f"--{key} {val} "


def get_param_list(param_dict: dict):
    """Cartesian product over the grid; tuple keys vary jointly
    (reference :26-66)."""
    keys = list(param_dict.keys())
    params, expnames = [], []
    for combo in itertools.product(*[param_dict[k] for k in keys]):
        flags, name = "", ""
        for key, val in zip(keys, combo):
            if isinstance(key, tuple):
                assert len(key) == len(val)
                for k, v in zip(key, val):
                    flags += get_param_str(k, v)
                    name += f"{v},"
                name = name[:-1] + "-"
            else:
                flags += get_param_str(key, val)
                name += f"{val}-"
        params.append(flags)
        expnames.append(name.replace(" ", "")[:-1])
    return params, expnames


def train_command(expname: str, flags: str, log_folder: str) -> str:
    """The shell command of one run: the port's training CLI."""
    return (f"{sys.executable} -m iffnerf_tpu_torch.train_cli --expname "
            f"{expname} --basedir ./{log_folder} --config {BASE_CONFIG} "
            f"{flags}")


def device_env(device: str) -> dict:
    """The environment of a run on card ``device``: it sees that card
    alone."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = device
    return env


def main():
    log_folder = f"log/{EXP_FOLDER}"
    os.makedirs(log_folder, exist_ok=True)

    device_queue: queue.Queue = queue.Queue()
    for d in DEVICES:
        device_queue.put(d)

    def run_program(device: str, expname: str, flags: str):
        cmd = train_command(expname, flags, log_folder)
        print(cmd)
        out = os.path.join(log_folder, expname, f"{expname}.txt")
        with open(out, "w") as fh:
            subprocess.run(cmd, shell=True, env=device_env(device), stdout=fh,
                           stderr=subprocess.STDOUT)
        device_queue.put(device)

    params, expnames = get_param_list(PARAM_DICT)
    threads = []
    for flags, expname in zip(params, expnames):
        if stop_requested(log_folder):
            break
        target = os.path.join(log_folder, expname)
        device = device_queue.get()
        get_folder_locker(log_folder)
        if os.path.isdir(target):
            release_folder_locker(log_folder)
            device_queue.put(device)
            continue
        os.makedirs(target, exist_ok=True)
        print("making", target, "running", expname, flags)
        release_folder_locker(log_folder)

        t = threading.Thread(target=run_program,
                             args=(device, expname, flags), daemon=True)
        t.start()
        threads.append(t)

    for t in threads:
        t.join()


if __name__ == "__main__":
    main()
