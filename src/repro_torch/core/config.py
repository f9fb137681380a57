"""Shared execution config and device resolution.

`HistoryExecConfig` is the port of `repro.core.config.HistoryExecConfig`:
the knobs every config that executes against a `HistoryStore` shares.
The reference's `backend` knob has no counterpart here: the port has one
implementation per op, and which one runs follows the device of the
tensors (a CUDA tensor launches the hand-written kernel, a CPU tensor runs
its plain PyTorch version).

`resolve_device` is the one rule every entry point applies to its
`device` argument: None means "cuda"; a CUDA device without a card
raises — the port never falls back to the CPU quietly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

HISTORY_DTYPES = ("f32", "bf16", "int8", "vq")


def check_history_dtype(history_dtype: str) -> None:
    """Only f32 stores are ported. The other reference precisions raise
    with the ROADMAP item that brings them."""
    if history_dtype not in HISTORY_DTYPES:
        raise ValueError(f"history_dtype must be one of {HISTORY_DTYPES}, "
                         f"got {history_dtype}")
    if history_dtype != "f32":
        raise NotImplementedError(
            f"history_dtype={history_dtype!r} is not ported yet (ROADMAP "
            "Queue A, quantized histories); the port serves f32 stores")


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """None -> "cuda" (as the indexed current device, so devices compare
    equal). Raises if a CUDA device is asked for and none is present. On
    CUDA, float32 matrix products and convolutions are pinned
    to full f32 (`allow_tf32 = False` for cuBLAS and cuDNN), as the
    reference computes them."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclass(frozen=True, kw_only=True)
class HistoryExecConfig:
    """`history_dtype` — history-table storage precision; only "f32" is
    ported (None means "f32"). Serving validates it against the bound
    store.

    `staleness_slo` — max acceptable history age (steps since a row was
    last pushed) of any row an execution may read. Serving overrides the
    default to 0 (refresh to exactness) and treats None as pure cache
    reads (never refresh)."""
    history_dtype: Optional[str] = None
    staleness_slo: Optional[int] = None

    def __post_init__(self):
        if self.history_dtype is not None:
            check_history_dtype(self.history_dtype)
