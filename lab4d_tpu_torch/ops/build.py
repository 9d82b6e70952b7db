"""Build and load the port's CUDA kernels.

Each kernel under `lab4d_tpu_torch/csrc/<name>.cu` exposes a plain C
interface and is compiled with nvcc for sm_90a into a shared library that
`ctypes` loads. The build runs at first use, on the machine with the card,
into `build/lab4d_tpu_torch/` beside the package (listed in .gitignore);
the library's file name carries a hash of its source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited kernel is rebuilt and a stale
one is never loaded. The compiler's register and shared-memory report
(`-Xptxas -v`) is kept next to it as `<name>-<hash>.log`. `build_all`
compiles several kernels with one nvcc process each, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC_DIR.parents[1] / "build" / "lab4d_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        candidates.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


KERNELS = ("fused_relu_mlp", "fused_pe_mlp", "nerf_heads")


def library_path(name: str) -> Path:
    blob = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        blob += header.read_bytes()
    digest = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start_build(name: str):
    """Start nvcc on csrc/<name>.cu; returns (process, temp path, library path)."""
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc, tmp: Path, out: Path):
    stdout, stderr = proc.communicate()
    out.with_suffix(".log").write_text(stdout + stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{stderr}")
    os.replace(tmp, out)


def build_all(names=KERNELS):
    """Compile every missing library of `names`, one nvcc each, in parallel."""
    started = [(n, *_start_build(n)) for n in names if not library_path(n).exists()]
    for n, proc, tmp, out in started:
        _finish_build(n, proc, tmp, out)


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if its library is missing, then load it."""
    out = library_path(name)
    if not out.exists():
        _finish_build(name, *_start_build(name))
    return ctypes.CDLL(str(out))


def build_log(name: str) -> str:
    """The compiler's report for the current build of `name` ('' if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
