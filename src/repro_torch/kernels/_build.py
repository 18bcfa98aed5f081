"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Every ``src/repro_torch/csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch_kernels/lib<name>-<hash>.so

under the repository's git-ignored ``build/`` directory.  The file name
carries a hash of the source, so an edited source is rebuilt and an
unchanged one is loaded as it is.  No ``--use_fast_math``: it would turn
``log2f`` into an approximation and flush denormals, and ``split_gain``
would drift from its plain version.

nvcc's output (``-Xptxas -v``: registers, spills and shared memory of each
kernel) is kept beside the library as ``lib<name>-<hash>.ptxas`` and in
``BUILD_LOG``, also for a library built earlier.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises when that is not 0.  Nothing here
touches CUDA or ``nvcc`` before the first kernel is asked for, so the CPU
tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}     # name -> {"seconds", "ptxas", "cached"}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built at first use and need the CUDA toolkit")
    return path


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every kernel source not loaded yet."""
    with _lock:
        sources = sorted(CSRC.glob("*.cu"))
        todo = [s for s in sources if s.stem not in _libs]
        procs = {}
        started = time.perf_counter()
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for src in todo:
            out = _target(src)
            if out.exists():
                log = out.with_suffix(".ptxas")
                BUILD_LOG[src.stem] = {
                    "seconds": 0.0, "cached": True,
                    "ptxas": log.read_text() if log.exists() else ""}
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[src] = (out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for src, (out, tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
                continue
            out.with_suffix(".ptxas").write_text(log)
            os.replace(tmp, out)
            BUILD_LOG[src.stem] = {
                "seconds": time.perf_counter() - started, "ptxas": log,
                "cached": False}
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        for src in todo:
            _libs[src.stem] = ctypes.CDLL(str(_target(src)))
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of ``csrc/<name>.cu`` with its C signature declared:
    ``ctypes.c_void_p`` for pointers and the stream, so that no pointer is
    cut to 32 bits, and an int status as the result."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def check_tensor(t, dtype, shape, name, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor (on ``device`` when
    given) of ``dtype`` and ``shape``: what a launcher takes."""
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name} must be on {device or 'a CUDA device'}, "
                         f"got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, "
                         f"got {t.dtype} of shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def aligned16(t):
    """``t``, or a copy of it when its data does not start on a 16-byte
    boundary (a view into another tensor can start anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
