"""Message-passing operators over padded GAS subgraphs — GCN and GAT.

The port of the GCN and GAT parts of `repro.gnn.layers`, with the
reference's calling convention:

    apply(params, x_all, edges, edge_w, n_out, blocks=None) -> [n_out, d_out]

where `x_all` holds the in-batch rows 0..n_out-1, then the halo rows and
one all-zero dummy row. Aggregation goes through `kernels.ops`: the BCSR
kernel when the batch's `blocks` are given, the plain COO sum otherwise.
The post-aggregation transform is `gcn_combine`, shared with the fused
halo path (`gnn.model._fused_prop`). Its product stays in `torch.matmul`,
as the reference leaves it to XLA outside every Pallas kernel; on CUDA it
runs in full f32 (`core.config.resolve_device` turns TF32 off).

GAT splits into the per-node `gat_transform` (head-split values and the
two additive logit halves), the edge softmax (`ops.edge_softmax_aggregate`:
the CUDA kernels over the batch's unit-weight blocks, or the per-edge
softmax over the COO when no blocks are given) and `gat_combine` (heads
concatenated). The other operators of the reference's zoo (GIN, GCNII,
APPNP, PNA) are not ported yet (ROADMAP Queue A item 2).
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


# ---------------------------------------------------------------------------
# GAT (Velickovic et al. 2018)
# ---------------------------------------------------------------------------

def init_gat(gen: torch.Generator, d_in: int, d_out: int,
             heads: int = 8) -> Params:
    """Glorot `w` [d_in, heads * f] and 0.1 * standard-normal attention
    vectors [heads, f], f = d_out // heads (the reference's
    distributions, drawn on the CPU from `gen`)."""
    if d_out % heads:
        raise ValueError(f"d_out={d_out} is not a multiple of heads={heads}")
    f = d_out // heads
    w = _glorot(gen, (d_in, heads * f))
    a_src = 0.1 * torch.randn((heads, f), generator=gen)
    a_dst = 0.1 * torch.randn((heads, f), generator=gen)
    return {"w": w, "a_src": a_src, "a_dst": a_dst}


def gat_transform(params: Params, x_all: torch.Tensor):
    """Per-node half of GAT: head-split values wx = x_all @ W [M, H, F] and
    the two additive logit halves a_d, a_s [M, H] (the per-edge logit is
    a_d[dst] + a_s[src])."""
    H = int(params["a_src"].shape[0])
    wx = (x_all @ params["w"]).reshape(x_all.shape[0], H, -1)
    a_s = torch.sum(wx * params["a_src"], dim=-1)
    a_d = torch.sum(wx * params["a_dst"], dim=-1)
    return wx, a_d, a_s


def gat_combine(att: torch.Tensor) -> torch.Tensor:
    """Post-aggregation transform: concatenate the heads."""
    return att.reshape(att.shape[0], -1)


def gat_transform_split(params: Params, x_b: torch.Tensor,
                        xh: torch.Tensor):
    """The halo-split GAT transform of layers >= 1: `x_b` [n_b, d] holds
    the exact in-batch rows, `xh` [n_h, d] the pulled halo rows. The
    weight is consumed as its [d, H, F] reshape, so the values are born
    head-split. Returns what `gat_transform` returns over
    [x_b ; xh ; 0]. The reference pulls the halo zero-padded to 128 lanes
    and pads the weight to match (its gather kernel's width); the port
    pulls at the unpadded width d, so no padding is needed and the values
    are the same."""
    H = int(params["a_src"].shape[0])
    d = params["w"].shape[0]
    w3 = params["w"].reshape(d, H, -1)
    wx_b = torch.einsum("md,dhf->mhf", x_b, w3)
    wx_h = torch.einsum("md,dhf->mhf", xh, w3)
    wx = torch.cat([wx_b, wx_h, wx_b.new_zeros((1,) + wx_b.shape[1:])], 0)
    a_s = torch.sum(wx * params["a_src"], dim=-1)
    a_d = torch.sum(wx * params["a_dst"], dim=-1)
    return wx, a_d, a_s


def gat(params: Params, x_all: torch.Tensor, edges, edge_w: torch.Tensor,
        n_out: int, *, ublocks=None) -> torch.Tensor:
    wx, a_d, a_s = gat_transform(params, x_all)
    att = ops.edge_softmax_aggregate(wx, a_d, a_s, edges, edge_w, n_out,
                                     ublocks)
    return gat_combine(att)
