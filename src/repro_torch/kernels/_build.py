"""Build, load and launch-count the port's CUDA kernels.

The sources in `csrc/` (`*.cu`, `*.cuh`) are compiled for `sm_90a` at
first use: one `nvcc -c` per source, all started together, then one link
into a shared library with a plain C interface, bound with `ctypes`. The
library lands in `build/torch_kernels/<key>/` under the repository root
(listed in .gitignore), keyed on a hash of the sources and the flags, so a
fresh checkout builds everything on first use and an unchanged one loads
what it built before. Nothing here runs at import time: the CPU tests
import every module and never build.

`launch_counts` holds one integer per kernel; each wrapper adds one to
its count where it launches its kernel, and nowhere else, so a run can
show that its path went through the kernels (`chip_smoke.py`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("gather_rows", "scatter_rows", "bcsr_spmm", "gather_spmm")
launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    "repro_gather_rows_f32": [_P, _P, _P, _I, _I, _P],
    "repro_scatter_rows_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "repro_bcsr_spmm_f32": [_P, _I, _I, _P, _P, _I, _I, _P, _P],
    "repro_gather_spmm_f32": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I,
                              _P, _P],
}

_lock = threading.Lock()
_lib = None


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")
    if not Path(cand).exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the port's kernels are built from "
                           f"{CSRC} at first use")
    return cand


def build() -> Path:
    """Compile the sources (in parallel) and link the library unless a
    build with the same key exists. Returns the library's path; the
    compiler's output (ptxas register and spill counts included) is kept
    beside it in `build.log`."""
    out_dir = BUILD_DIR / _key()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    tmp = out_dir / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in _sources():
        obj = tmp / (src.stem + ".o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS[:2], "-shared", *map(str, objs), "-o",
         str(tmp / LIB_NAME)], capture_output=True, text=True)
    log.append(f"== link (rc {link.returncode})\n{link.stdout}{link.stderr}")
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n"
                           + "\n".join(log))
    (tmp / "build.log").write_text("\n".join(log))
    os.replace(tmp / "build.log", out_dir / "build.log")
    os.replace(tmp / LIB_NAME, lib_path)
    shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.repro_error_string.argtypes = [ctypes.c_int]
            handle.repro_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        msg = lib().repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({rc})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The checks every wrapper makes before a launch: all tensors on one
    CUDA device (the current one) and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: every operand must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        # the launchers run on the current device's stream
        raise ValueError(f"{name}: tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return dev


def require_dtype(name: str, t: torch.Tensor, dtype: torch.dtype,
                  what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
