"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, ``build/kernels/lib<name>.so`` at the root of the
checkout, and is loaded with ``ctypes``.  The build runs at first use (one
``nvcc`` per source, all started together) and is skipped while the library
is newer than its source.  A source may also be built with one
preprocessor macro defined (``define``), into a library of its own beside
the normal one.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("sw_block", "dense_mha", "vq_nearest", "fused_conv", "subpixel_up", "group_norm",
           "bias_add")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[Tuple[str, str], ctypes.CDLL] = {}


def _nvcc() -> str:
    # torch's lookup: $CUDA_HOME / $CUDA_PATH, then nvcc on PATH, then the
    # default install prefix
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def library_path(name: str, define: str = "") -> Path:
    return BUILD_DIR / (f"lib{name}-{define}.so" if define else f"lib{name}.so")


def _stale(name: str, define: str = "") -> bool:
    lib = library_path(name, define)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build(names: Iterable[str] = SOURCES, force: bool = False,
          define: str = "") -> Dict[str, str]:
    """Compile the named kernels in parallel, with the macro `define`
    defined if one is given; returns {name: ptxas report} (empty for a
    library that was already up to date).  Raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not force and not _stale(name, define):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, *([f"-D{define}"] if define else []), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name, define))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str, define: str = "") -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (built with `define` if one is
    given), built first if needed."""
    lib = _libs.get((name, define))
    if lib is None:
        if _stale(name, define):
            build([name], define=define)
        lib = ctypes.CDLL(str(library_path(name, define)))
        _libs[(name, define)] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
