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
    """`history_dtype` — history-table storage precision, a name of the
    codec registry (`core.history.get_codec`): "f32", "bf16", "int8" or
    "vq". In training, None resolves as the reference's: to
    $REPRO_HISTORY_DTYPE where it is set, else "f32"
    (`core.history.resolve_history_dtype`, which `build_plan` and the
    store's `create` call). Serving validates a name against the bound
    store and reads None as "the bound store's".

    `staleness_slo` — max acceptable history age (steps since a row was
    last pushed) of any row an execution may read. Serving overrides the
    default to 0 (refresh to exactness) and treats None as pure cache
    reads (never refresh)."""
    history_dtype: Optional[str] = None
    staleness_slo: Optional[int] = None

    def __post_init__(self):
        if self.history_dtype is not None:
            from .history import get_codec  # history imports this module
            get_codec(self.history_dtype)
