"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with ``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the root of
the checkout (``build/`` is git-ignored); the ``csrc/*.cuh`` headers are
shared.  The library file name carries a hash of the sources, headers and
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is.  Nothing is compiled when a module is
imported; without ``nvcc`` the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = (
    "gt_attention_fwd", "gt_attention_bwd", "window_attention_fwd", "window_attention_bwd",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: anemoi_tpu_torch builds its CUDA kernels from source at "
        "first use and needs the CUDA toolkit (put nvcc on PATH or set CUDA_HOME)"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, temp output, final path),
    or None when the library is already built."""
    path = library_path(name)
    if path.exists():
        return None
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, path


def _finish(name: str, started) -> None:
    proc, tmp, path = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n{log}")
    path.with_suffix(".log").write_text(log)
    os.replace(tmp, path)  # atomic: concurrent builders never see a partial file


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Build every named source, one nvcc each, all started together.
    Returns the wall seconds until each was built (0.0 when cached)."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in names}
    seconds = {}
    for name, st in started.items():
        if st is not None:
            _finish(name, st)
        seconds[name] = time.perf_counter() - t0 if st is not None else 0.0
    return seconds


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill counts) of the built library."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def ptxas_usage(log: str) -> Dict[str, dict]:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}
    from the ``-Xptxas -v`` lines of a build log (:func:`build_log`)."""
    usage = {}
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        usage[name] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_stores": int(spills.group(1)) if spills else None,
            "spill_loads": int(spills.group(2)) if spills else None,
        }
    return usage


def load_library(name: str) -> ctypes.CDLL:
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))
