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
from typing import Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
# no --use_fast_math: the int8 and vq kernels divide and multiply with
# IEEE rounding, so their codes and dequantized rows are bitwise the plain
# versions', and PNA's backward passes divide the min/max cotangents by
# their tie counts as the reference does
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the int8 and vq bodies are kernels of their own; the bf16 instantiations of
# gather_rows, scatter_rows and gather_spmm share their f32 kernels'
# sources and count apart ("*_bf16"), so a run shows which tables it read
KERNELS = ("gather_rows", "scatter_rows", "bcsr_spmm", "gather_spmm",
           "edge_softmax_fwd", "edge_softmax_bwd_row", "edge_softmax_bwd_col",
           "gather_rows_dq", "scatter_rows_q", "gather_spmm_dq",
           "gather_rows_bf16", "scatter_rows_bf16", "gather_spmm_bf16",
           "pna_reduce_fwd", "pna_reduce_bwd_row", "pna_reduce_bwd_col",
           "gather_rows_vq", "scatter_rows_vq", "gather_spmm_vq",
           "flash_decode", "gather_rows_raw", "scatter_rows_raw")
launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    # (tables, rows, row counts, row bytes: host arrays of T entries; T,
    # idx, [winner,] M, stream); the `_ctas` entries (T, M, int64 out): the
    # CTAs the call would launch on the same plan
    "repro_gather_rows_raw_many": [_P] * 4 + [_I, _P, _I, _P],
    "repro_scatter_rows_raw_many": [_P] * 4 + [_I, _P, _P, _I, _P],
    "repro_gather_rows_raw_many_ctas": [_P] * 4 + [_I, _I, _P],
    "repro_scatter_rows_raw_many_ctas": [_P] * 4 + [_I, _I, _P],
    "repro_host_device_ptr": [_P, ctypes.POINTER(ctypes.c_void_p)],
    "repro_gather_rows": [_P, _P, _P] + [_I] * 7 + [_P],
    "repro_gather_rows_dq": [_P] * 4 + [_I] * 7 + [_P],
    "repro_gather_rows_vq": [_P] * 5 + [_I] * 7 + [_P],
    "repro_scatter_rows_vq": [_P] * 8 + [_I] * 6 + [_P],
    "repro_gather_spmm_vq": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I,
                             _I, _P, _P],
    "repro_scatter_rows_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "repro_scatter_rows_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
    "repro_scatter_rows_q": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "repro_bcsr_spmm_f32": [_P, _I, _I, _P, _P, _I, _I, _P, _P],
    "repro_gather_spmm_f32": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I,
                              _P, _P],
    "repro_gather_spmm_bf16": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I,
                               _P, _P],
    "repro_gather_spmm_dq": [_P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I,
                             _P, _P],
    "repro_edge_softmax_fwd_f32": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _I,
                                   _I, _F, _P, _P, _P, _P],
    "repro_edge_softmax_bwd_row_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _P, _P, _I, _I, _F, _P, _P],
    "repro_edge_softmax_bwd_col_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _P, _P, _I, _I, _F, _P, _P,
                                       _P],
    "repro_pna_reduce_fwd_f32": [_P, _P, _I, _I, _I, _P, _P, _I, _I, _P, _P,
                                 _P, _P, _P, _P, _P],
    "repro_pna_reduce_bwd_row_f32": [_P] * 9 + [_I, _I, _I, _P, _P, _I, _I,
                                                _P, _P],
    "repro_pna_reduce_bwd_col_f32": [_P] * 9 + [_I, _I, _I, _P, _P, _I, _I,
                                                _P, _P],
    "repro_flash_decode_f32": [_P] * 5 + [_I] * 9 + [_F, _P],
    "repro_flash_decode_bf16": [_P] * 5 + [_I] * 9 + [_F, _P],
}

_lock = threading.Lock()
_lib = None


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def _sources(csrc: Path) -> List[Path]:
    return sorted(csrc.glob("*.cu"))


def _key(csrc: Path, flags: List[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(csrc.glob("*.cu*")):
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


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR,
          defines: Tuple[str, ...] = ()) -> Path:
    """Compile the sources in `csrc` (in parallel) and link the library
    unless a build with the same key exists under `build_dir`. Returns the
    library's path; the compiler's output (ptxas register and spill counts
    included) is kept beside it in `build.log`. Another checkout's `csrc`
    builds that checkout's kernels (`chip_smoke.py --parent-csrc`);
    `defines` ("NAME=VALUE") set a source's build switches
    (`chip_smoke.py --vq-ablation`)."""
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    out_dir = build_dir / _key(csrc, flags)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    tmp = out_dir / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in _sources(csrc):
        obj = tmp / (src.stem + ".o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *flags, "-c", str(src), "-o", str(obj)],
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


def load(path: Path) -> ctypes.CDLL:
    """A built kernel library with its launchers' signatures set. An entry
    point the library lacks is left out (another checkout's library,
    `chip_smoke.py --parent-csrc`, may predate it); calling it raises."""
    handle = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name, None)
        if fn is None:
            continue
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.repro_error_string.argtypes = [ctypes.c_int]
    handle.repro_error_string.restype = ctypes.c_char_p
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        msg = lib().repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({rc})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor,
                 pinned: Tuple[torch.Tensor, ...] = ()) -> torch.device:
    """The checks every wrapper makes before a launch: all tensors on one
    CUDA device (the current one) and contiguous. A tensor in `pinned` (a
    history table or scale table, in the wrappers that read or write one
    through its unified address: the raw pull and push and the three
    pushes)
    may instead be a pinned CPU tensor; a CPU tensor that is not pinned
    raises, and so does any other mix of devices."""
    dev = tensors[0].device
    for t in tensors + tuple(p for p in pinned if p.device.type != "cpu"):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    for t in tensors + tuple(pinned):
        if not t.is_contiguous():
            raise ValueError(f"{name}: every operand must be contiguous")
    for p in pinned:
        if p.device.type == "cpu" and not p.is_pinned():
            raise ValueError(f"{name}: a CPU table must be in pinned host "
                             "memory (a history_storage='host' store's)")
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        # the launchers run on the current device's stream
        raise ValueError(f"{name}: tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return dev


def device_ptr(t: torch.Tensor) -> int:
    """The address a kernel reads or writes `t` through: its data pointer
    on the card, or, for a pinned CPU tensor, the unified address that
    maps its host buffer (`repro_host_device_ptr`)."""
    if t.device.type != "cpu":
        return t.data_ptr()
    out = ctypes.c_void_p()
    rc = lib().repro_host_device_ptr(t.data_ptr(), ctypes.byref(out))
    if rc != 0:
        raise ValueError(f"no device address for a CPU tensor: "
                         f"{lib().repro_error_string(rc).decode()}")
    return out.value


def pointers(values: List[int]) -> ctypes.Array:
    """A host array of addresses, for a launcher that takes one entry a
    table (the raw pull and push)."""
    return (ctypes.c_void_p * len(values))(*values)


def int64s(values: List[int]) -> ctypes.Array:
    """A host array of int64, one entry a table."""
    return (ctypes.c_int64 * len(values))(*values)


def require_dtype(name: str, t: torch.Tensor, dtype: torch.dtype,
                  what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
