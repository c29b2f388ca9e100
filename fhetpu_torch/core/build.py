"""Build and load the package's CUDA kernels (``fhetpu_torch/csrc/*.cu``).

The sources have a plain C interface: each entry point takes raw device
pointers and a ``cudaStream_t`` and returns the launch's ``cudaError_t``.
They are compiled with plain ``nvcc`` at first use, without PyTorch's
headers (seconds instead of minutes): one ``nvcc`` process per source, all
started together, then one link into a shared library, loaded with
``ctypes``.  The library lands in ``fhetpu_torch/build/`` and is rebuilt
when any source is newer than it.

There is no fallback: a missing ``nvcc`` or a failed build raises with the
compiler's output, since a CUDA tensor must run on its kernel.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libfhetpu_torch_kernels.so")
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = GENCODE + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


class KernelBuildError(RuntimeError):
    pass


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise KernelBuildError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin); the CUDA kernels "
        "of fhetpu_torch need the CUDA toolkit")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = _sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(s) > built for s in deps)


def build() -> str:
    """Compile every ``csrc/*.cu`` into the shared library if it is stale;
    returns the library's path."""
    if not _stale():
        return LIB_PATH
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = os.getpid()
    jobs = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *COMPILE_FLAGS, "-c", src, "-o", obj]
        jobs.append((obj, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True)))
    tmp = f"{LIB_PATH}.{tag}.tmp"
    try:
        errors = []
        for _, cmd, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}")
        if errors:
            raise KernelBuildError("\n".join(errors))
        cmd = [nvcc, *GENCODE, "-shared", "-o", tmp] + [obj for obj, _, _ in jobs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise KernelBuildError(
                f"nvcc link failed (exit {r.returncode}): {' '.join(cmd)}\n{r.stderr}")
        os.replace(tmp, LIB_PATH)  # atomic: concurrent builders never see a torn file
    finally:
        for obj, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(obj):
                os.remove(obj)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = ctypes.CDLL(build())
        return _LIB


def check(err: int, what: str):
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        describe = lib().fhetpu_cuda_error_string
        describe.argtypes, describe.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: {describe(err).decode()} (CUDA error {err})")
