"""Builds the CUDA kernels of ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface, loaded with ``ctypes``. The library's file name
carries a hash of the sources and flags, so a changed source is rebuilt
and an unchanged one is loaded as it is. Libraries go to ``build/kernels``
at the root of the checkout (listed in ``.gitignore``). Nothing here runs
when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("banked_attention", "fused_ray_attention", "gather_rows",
           "field_features")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
_SMS: dict[int, int] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compiles every named kernel whose library is missing, all nvcc
    processes at once. -> {name: seconds} for the ones built. The
    ``-Xptxas -v`` report (registers, shared memory, spills) is kept
    beside each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".so.log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       log, tmp, out, time.perf_counter())
    took = {}
    failed = []
    for name, (proc, log, tmp, out, t0) in procs.items():
        rc = proc.wait()
        log.close()
        took[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n"
                          + out.with_suffix(".so.log").read_text()[-4000:])
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with ``argtypes`` set from
    ``signatures`` ({function: [ctypes types]}); every entry returns an
    int cudaError_t."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def sm_count(device: torch.device) -> int:
    """Multiprocessors of a CUDA ``device``, queried once: the query costs
    more host time than a short kernel's launch."""
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def refuse_grad(what: str, tensors) -> None:
    """Raises before a launch when autograd would track one of ``tensors``:
    the scoring kernels and the row gather have no backward (the row
    gather's is ROADMAP item 21; ``field_features`` has one), and a result
    that silently carries no gradient is worse than an error. Run under
    ``torch.no_grad()``, or on the CPU, where the plain versions are
    differentiable."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward on CUDA yet (ROADMAP item 21): an "
            f"input requires grad; call it under torch.no_grad()")
