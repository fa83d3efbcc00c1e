"""Build and load the port's CUDA kernels (nvcc → shared libraries → ctypes).

Each ``csrc/<name>.cu`` compiles on first use, with its own ``nvcc``
process (all started together), into
``build/kernels/lib<name>-<hash>.so`` under the checkout root, and exports
``<name>_launch``; the libraries load with ``ctypes``. Eight sources, one
per TPU kernel: ``factor_mean.cu``, the five fold sources,
``lora_matmul.cu`` and ``flash_swa.cu``. The hash covers the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source never loads a stale library. The sources expose a plain C interface (no
PyTorch headers), which keeps each build to seconds. Nothing here runs at
import time: the CPU tests import every module on a machine without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_VP, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# <name>_launch lives in csrc/<name>.cu
SIGNATURES = {
    # the group's table goes as a host int64 array, 6 entries a tensor
    "factor_mean_launch": (_VP, _I, _VP, _I, _I, _VP),
    "fedex_fold_launch": (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                          _I64, _I64, _I64, _I64, _F, _VP),
    "product_fold_launch": (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                            _I64, _I64, _I64, _I64, _F, _VP),
    "product_accum_launch": (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                             _I64, _I64, _I64, _I64, _F, _VP),
    "perclient_fold_launch": (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                              _I64, _I64, _I64, _I64, _F, _VP),
    "hetero_fold_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I,
                           _I, _I, _I, _I64, _I64, _I64, _I64, _I64, _I64,
                           _F, _VP),
    # the last int before the stream: the operands are bf16 (1) or f32 (0)
    "lora_matmul_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F,
                           _I, _I, _I, _I, _I, _VP),
    # the 12 (batch, position, head) strides go as a host int64 array
    "flash_swa_launch": (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP, _I,
                         _I, _F, _I, _I, _I, _VP),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels build on a machine with the CUDA toolkit")


def library_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> List[Path]:
    """Compile every library that is not built yet, one ``nvcc`` per
    source, all in parallel; returns the libraries' paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = [library_path(src) for src in sorted(CSRC.glob("*.cu"))]
    jobs = []
    for src, lib in zip(sorted(CSRC.glob("*.cu")), libs):
        if lib.exists():
            continue
        # build into a private temp name, then rename: a concurrent or cut-off
        # build never leaves a half-written library under the final name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, str(src)]
        jobs.append((cmd, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    t0 = time.perf_counter()
    errors = []
    for cmd, tmp, lib, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                          f"\n{out}\n{err}")
            continue
        if verbose:
            print(f"nvcc {lib.name}:\n{err}", flush=True)
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    if verbose and jobs:
        print(f"nvcc: {len(jobs)} sources in parallel, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return libs


@functools.lru_cache(maxsize=None)
def load_library() -> SimpleNamespace:
    """Build (if needed) and load the kernel libraries once per process;
    returns a namespace of the ``<name>_launch`` functions."""
    libs = {lib.name.split("-")[0][3:]: ctypes.CDLL(str(lib))
            for lib in build()}
    fns = {}
    for name, argtypes in SIGNATURES.items():
        fn = getattr(libs[name[:-len("_launch")]], name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return SimpleNamespace(**fns)


def check_launch(name: str, code: int) -> None:
    """Raise if a launch function reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")
