"""Historical embedding storage (the paper's central data structure).

The port of `repro.core.history`: one [N+1, d] table per hidden layer
holding each node's layer output from the last time it was computed (the
+1 row is a masked sentinel that padded indices point at, and the push's
sacrificial row), plus the staleness clock `age` [N+1] int32.

Storage precision (`history_dtype`) comes from the reference's codec
registry (`HistoryCodec`, `get_codec`), the one place that decides: f32
tables; bf16 tables (pushes round to bf16, pulls return bf16 rows that
are upcast where they are consumed); and int8 tables of symmetric
per-row codes beside a per-row f32 scale table `scales` [N+1] (push
quantizes `s_i = max|v_i| / 127`, `q_i = round(v_i / s_i)`, pull
dequantizes `q_i * s_i` in f32; `kernels.ref.quantize_rows`). The added
error of a push is `quantization_error`, the `hist_quant_err` diagnostic.
vq (codebook) stores are in the registry and raise (ROADMAP Queue A
item 3).

The reference store is a frozen pytree whose methods return new stores,
and XLA performs its push in place only when the jitted step donates the
tables. Here the store is mutable: `push` scatters into the table (and
scale) tensors themselves and `tick` updates `age` in place, and both
return the store for chaining. Host-memory tables are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import (dequantize_rows, quantize_rows,
                                     relative_row_error, row_scales)
from .config import resolve_device

__all__ = ["HistoryCodec", "HISTORY_DTYPES", "get_codec", "row_scales",
           "quantize_rows", "dequantize_rows", "quantization_error",
           "HistoryStore"]


# ---------------------------------------------------------------------------
# History-dtype registry (`repro.core.history:74-146`): one table drives
# every dtype decision, and every entry point rejects an unknown name with
# the same ValueError (via `get_codec`).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HistoryCodec:
    """One row of the registry. `lossless`: push/pull round-trips
    bit-exact (quantization error 0). `scaled`: a per-row f32 scale table
    rides beside each layer table. `vq`: a per-layer codebook rides along
    (not ported). `roundtrip(values)` is the f32 reconstruction a
    push-then-pull returns."""
    name: str
    storage: torch.dtype
    lossless: bool
    scaled: bool
    vq: bool
    roundtrip: Callable = field(default=lambda v: v)


def _roundtrip_bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float32)


def _roundtrip_int8(v: torch.Tensor) -> torch.Tensor:
    return dequantize_rows(*quantize_rows(v))


_CODECS = {
    "f32": HistoryCodec("f32", torch.float32, lossless=True, scaled=False,
                        vq=False),
    "bf16": HistoryCodec("bf16", torch.bfloat16, lossless=False,
                         scaled=False, vq=False, roundtrip=_roundtrip_bf16),
    "int8": HistoryCodec("int8", torch.int8, lossless=False, scaled=True,
                         vq=False, roundtrip=_roundtrip_int8),
    "vq": HistoryCodec("vq", torch.uint8, lossless=False, scaled=True,
                       vq=True),
}

HISTORY_DTYPES = tuple(_CODECS)


def get_codec(history_dtype: str) -> HistoryCodec:
    """Registry lookup. An unknown name raises the reference's ValueError,
    word for word; "vq" raises NotImplementedError (not ported)."""
    codec = _CODECS.get(history_dtype)
    if codec is None:
        raise ValueError(
            f"history_dtype must be one of {HISTORY_DTYPES}, "
            f"got {history_dtype}")
    if codec.vq:
        raise NotImplementedError(
            "history_dtype='vq' (codebook-quantized histories) is not "
            "ported yet (ROADMAP Queue A item 3)")
    return codec


def quantization_error(values: torch.Tensor, mask: torch.Tensor,
                       history_dtype: str) -> torch.Tensor:
    """Mean per-row relative L2 error `||v - dq(q(v))|| / ||v||` a push of
    `values` incurs under `history_dtype`, over the `mask`-valid rows;
    exactly 0 for a lossless codec (`repro.core.history:347`)."""
    codec = get_codec(history_dtype)
    if codec.lossless:
        return torch.zeros((), dtype=torch.float32, device=values.device)
    v = values.to(torch.float32)
    return _masked_mean(relative_row_error(v, codec.roundtrip(v)), mask)


def _masked_mean(row_err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    valid = mask.to(torch.float32)
    return torch.sum(row_err * valid) / torch.clamp(valid.sum(), min=1.0)


@dataclass
class HistoryStore:
    tables: List[torch.Tensor]
    age: torch.Tensor
    history_dtype: str = "f32"
    scales: Optional[List[torch.Tensor]] = None   # int8: [N+1] f32 each

    @classmethod
    def create(cls, num_nodes: int, dims: List[int],
               history_dtype: Optional[str] = None,
               device=None) -> "HistoryStore":
        """Zero tables (zero codes at scale 1.0 for int8, as the
        reference's `create`) and ages. `num_nodes` must include the
        sentinel row (pass N + 1). `history_dtype=None` means "f32";
        `device=None` means "cuda"."""
        hd = history_dtype or "f32"
        codec = get_codec(hd)
        dev = resolve_device(device)
        scales = ([torch.ones((num_nodes,), dtype=torch.float32, device=dev)
                   for _ in dims] if codec.scaled else None)
        return cls(tables=[torch.zeros((num_nodes, d), dtype=codec.storage,
                                       device=dev) for d in dims],
                   age=torch.zeros((num_nodes,), dtype=torch.int32,
                                   device=dev),
                   history_dtype=hd, scales=scales)

    @property
    def device(self) -> torch.device:
        return self.age.device

    @property
    def num_layers(self) -> int:
        return len(self.tables)

    def layer_scales(self, ell: int) -> Optional[torch.Tensor]:
        """The per-row f32 scale table of layer `ell` (None unless
        int8)."""
        return None if self.scales is None else self.scales[ell]

    def pull(self, ell: int, idx: torch.Tensor) -> torch.Tensor:
        """Gather rows of H̄^(ell) (idx clipped to the table), dequantized:
        f32 rows for f32 and int8 stores, bf16 rows for bf16 stores
        (upcast where they are consumed), as the reference's pull. At the
        table's own width: the reference's `pad_out=True` pull, which
        keeps its kernels' 128-lane padding, has no counterpart because
        the port's kernels mask ragged widths."""
        return ops.pull_rows(self.tables[ell], idx,
                             scales=self.layer_scales(ell))

    def push(self, ell: int, idx: torch.Tensor, values: torch.Tensor,
             mask: torch.Tensor) -> "HistoryStore":
        """Scatter fresh rows into H̄^(ell) in place where `mask`,
        quantizing to the store's precision on the way in; masked rows go
        to the sentinel row."""
        self.push_measured(ell, idx, values, mask)
        return self

    def push_measured(self, ell: int, idx: torch.Tensor,
                      values: torch.Tensor,
                      mask: torch.Tensor) -> Optional[torch.Tensor]:
        """`push`, returning the error it incurred: `quant_error` of the
        same rows (the push's term of `hist_quant_err`), or None for a
        lossless store, whose term is exactly 0. An int8 push takes the
        per-row errors its kernel writes beside the codes, so the codec
        does not run a second time."""
        if self.scales is not None:
            err = ops.push_rows_q(self.tables[ell], self.scales[ell], idx,
                                  values, mask, scratch_last_row=True)[2]
            return _masked_mean(err, mask)
        ops.push_rows(self.tables[ell], idx, values, mask,
                      scratch_last_row=True)
        if get_codec(self.history_dtype).lossless:
            return None
        return self.quant_error(values, mask)

    def quant_error(self, values: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
        """The relative error a push of `values` incurs at this precision
        (the `hist_quant_err` diagnostic; exactly 0 for f32 stores)."""
        return quantization_error(values, mask, self.history_dtype)

    def tick(self, batch_idx: torch.Tensor,
             mask: torch.Tensor) -> "HistoryStore":
        """Advance the staleness clock in place: age += 1, just-pushed
        rows -> 0."""
        self.age += 1
        return self.reset_age(batch_idx, mask)

    def reset_age(self, idx: torch.Tensor,
                  mask: torch.Tensor) -> "HistoryStore":
        """In place: age[idx[i]] = 0 where mask[i] (masked entries are
        dropped). A mask over the clock, so no host sync."""
        n = self.age.shape[0]
        hit = torch.zeros((n + 1,), dtype=torch.bool, device=self.device)
        hit[torch.where(mask, idx.long(), n)] = True
        self.age.masked_fill_(hit[:n], 0)
        return self

    def clone(self) -> "HistoryStore":
        """A copy with its own tables, scales and clock. The reference's
        stores are immutable, so its `predict` scans over a copy for free;
        the port's pushes are in place, so `runtime.predict` runs on a
        clone."""
        return HistoryStore(
            tables=[t.clone() for t in self.tables], age=self.age.clone(),
            history_dtype=self.history_dtype,
            scales=None if self.scales is None
            else [s.clone() for s in self.scales])

    def bytes(self) -> int:
        """Table bytes, the scale tables included (the reference's
        `bytes_per_table` summed)."""
        aux = self.scales or []
        return sum(t.numel() * t.element_size()
                   for t in list(self.tables) + list(aux))
