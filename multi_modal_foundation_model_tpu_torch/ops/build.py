"""Build the port's CUDA sources (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes``. Libraries land in ``build/torch_kernels/``
beside the package (git-ignored), named by a hash of the source and the
shared headers, so a changed source or header rebuilds and an unchanged
one loads at once. A failed build raises with the compiler's output.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

# sm_90a (not sm_90): Hopper's wgmma/setmaxnreg exist only for that target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc")
    if path is None and CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    """Path of ``csrc/<name>.cu``'s library, keyed by a hash of the source,
    the headers beside it (``csrc/*.cuh``) and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns seconds per build
    (0.0 where the library was already there). ``ptxas`` output (registers,
    shared memory, spills) goes to a ``.log`` beside each library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    seconds = {n: 0.0 for n in names}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc rc {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)               # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def kernel_sources() -> Sequence[str]:
    """Names of every CUDA source of the port (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))
