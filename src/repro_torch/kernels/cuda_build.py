"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file exposes a plain C launch function and is compiled on
first use into ``build/torch_ext/`` at the repository root (listed in
``.gitignore``), under a name that hashes the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is. A plain C
interface keeps PyTorch's headers out of the build: one such file compiles
in seconds, where a ``torch.utils.cpp_extension`` build takes minutes.
``build()`` starts one ``nvcc`` per source, all together.

Nothing here runs at import: the CPU tests import every module, and this
machine has no ``nvcc``. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
SOURCES = {name: CSRC / f"{name}.cu" for name in (
    "analog_update", "analog_mvm", "sp_filter", "fastrng")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
PTXAS_LOG: Dict[str, str] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built on the machine with the card")
    return found


def library_path(name: str) -> Path:
    src = SOURCES[name].read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}_{tag}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile ``names`` (default: every source) that are not built yet, one
    ``nvcc`` process each, all started together. Returns {name: .so path}."""
    names = list(SOURCES if names is None else names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = out[n].with_name(f"{out[n].stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        PTXAS_LOG[n] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{stderr}")
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of source ``name`` (built first if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib
