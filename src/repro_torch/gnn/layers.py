"""Message-passing operators over padded GAS subgraphs — GCN so far.

The port of the GCN part of `repro.gnn.layers`, with the reference's
calling convention:

    apply(params, x_all, edges, edge_w, n_out, blocks=None) -> [n_out, d_out]

where `x_all` holds the in-batch rows 0..n_out-1, then the halo rows and
one all-zero dummy row. Aggregation goes through `kernels.ops`: the BCSR
kernel when the batch's `blocks` are given, the plain COO sum otherwise.
The post-aggregation transform is `gcn_combine`, shared with the fused
halo path (`gnn.model._fused_prop`). Its product stays in `torch.matmul`,
as the reference leaves it to XLA outside every Pallas kernel; on CUDA it
runs in full f32 (`core.config.resolve_device` turns TF32 off). The other
operators of the reference's zoo (GAT, GIN, GCNII, APPNP, PNA) are not
ported yet (ROADMAP Queue A).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.kernels import ops

Params = Dict[str, Any]


def _glorot(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform(-lim, lim) with lim = sqrt(6 / (fan_in + fan_out)), drawn
    on the CPU from `gen` (the reference's distribution, not its bits)."""
    fan_in, fan_out = shape[0], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -lim, lim, generator=gen)


def init_gcn(gen: torch.Generator, d_in: int, d_out: int) -> Params:
    return {"w": _glorot(gen, (d_in, d_out)),
            "b": torch.zeros((d_out,), dtype=torch.float32)}


def gcn_combine(params: Params, agg: torch.Tensor) -> torch.Tensor:
    return agg @ params["w"] + params["b"]


def gcn(params: Params, x_all: torch.Tensor, edges, edge_w: torch.Tensor,
        n_out: int, *, blocks=None) -> torch.Tensor:
    agg = ops.gcn_aggregate(x_all, edges, edge_w, n_out, blocks)
    return gcn_combine(params, agg)
