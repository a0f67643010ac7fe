"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with
a plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds).  A library is named after a hash of its sources and
flags, built at first use into `build/torch_kernels/` at the repository
root (listed in .gitignore), and reused while the sources are unchanged.

Flags: sm_90a, C++17, -O3, and -fmad=false so that no a*b+c is contracted
into an FMA: the kernels must give the bytes of their plain PyTorch
versions, which round every elementwise op on its own.  No fast math.
A failed build raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "torch_kernels")
KERNELS = ("brute_intersect", "traverse_grid", "packed_march", "gather_row_test",
           "whitted_wave", "gi_wave", "empty_boxes", "grid_bin", "take_grad")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
_LAUNCHERS: Dict[tuple, object] = {}  # (library, launcher) -> bound C function


def nvcc_path() -> str:
    """nvcc from $NVCC, the PATH, or the toolkit PyTorch was built against."""
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources(name: str):
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return [os.path.join(CSRC, name + ".cu")] + [os.path.join(CSRC, h) for h in headers]


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, one nvcc process
    per source, all started together.  Returns {name: library path}.
    Raises with nvcc's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failures = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        with open(path + ".log", "w") as fh:
            fh.write(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(path)
        _LOADED[name] = lib
    return lib


def launcher(lib: str, name: str, argtypes):
    """The C launcher `name` of kernel library `lib`, bound with its
    signature once, at first use."""
    fn = _LAUNCHERS.get((lib, name))
    if fn is None:
        fn = getattr(library(lib), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _LAUNCHERS[(lib, name)] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {err}")
