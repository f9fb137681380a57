"""Message-passing operators over padded GAS subgraphs — the reference's
six: GCN, GIN, GAT, GCNII, APPNP and PNA.

The port of `repro.gnn.layers`, with the reference's calling convention:

    apply(params, x_all, edges, edge_w, n_out, blocks=None) -> [n_out, d_out]

where `x_all` holds the in-batch rows 0..n_out-1, then the halo rows and
one all-zero dummy row. Aggregation goes through `kernels.ops`: the BCSR
kernel when the batch's `blocks` are given, the plain COO sum otherwise.
Each fixed-weight operator's post-aggregation transform (`gcn_combine`,
`gin_combine`, `gcnii_combine`, `appnp_combine`) is shared with the
fused halo path (`gnn.model._fused_prop`). GIN sums its neighbors with
unit weights: over the COO it strips the edge weights to 0/1, on blocks
it reads the unit-weight family. Products stay in `torch.matmul`, as
the reference leaves them to XLA outside every Pallas kernel; on CUDA
they run in full f32 (`core.config.resolve_device` turns TF32 off).

GAT splits into the per-node `gat_transform` (head-split values and the
two additive logit halves), the edge softmax (`ops.edge_softmax_aggregate`:
the CUDA kernels over the batch's unit-weight blocks, or the per-edge
softmax over the COO when no blocks are given) and `gat_combine` (heads
concatenated).

PNA splits the same way: `pna_transform` (the two per-node halves of
its edge MLP), the multi-aggregator reduction (`ops.pna_reduce`: the
CUDA kernels over the unit-weight blocks, or the segment reduction over
the COO) and `pna_combine` (degree scalers and the readout MLP).
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
# GIN (Xu et al. 2019): sum aggregation + MLP
# ---------------------------------------------------------------------------

def init_gin(gen: torch.Generator, d_in: int, d_out: int,
             d_hidden: int = 0) -> Params:
    """Glorot `w1` [d_in, h] and `w2` [h, d_out] (h = d_hidden or d_out),
    zero biases and a 0-d `eps` (the reference's shapes and
    distributions, drawn on the CPU from `gen`)."""
    d_hidden = d_hidden or d_out
    return {"w1": _glorot(gen, (d_in, d_hidden)),
            "b1": torch.zeros((d_hidden,), dtype=torch.float32),
            "w2": _glorot(gen, (d_hidden, d_out)),
            "b2": torch.zeros((d_out,), dtype=torch.float32),
            "eps": torch.zeros((), dtype=torch.float32)}


def gin_mlp(params: Params, h: torch.Tensor) -> torch.Tensor:
    h = torch.relu(h @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def gin_combine(params: Params, x_in: torch.Tensor,
                agg: torch.Tensor) -> torch.Tensor:
    return gin_mlp(params, (1.0 + params["eps"]) * x_in + agg)


def gin(params: Params, x_all: torch.Tensor, edges, edge_w: torch.Tensor,
        n_out: int, *, blocks=None) -> torch.Tensor:
    """`blocks` are the unit-weight family (`batch.ublocks`): GIN's
    unweighted neighbor sum is the same SpMM over them; over the COO the
    valid edges' weights become 1."""
    uw = (edge_w > 0).to(edge_w.dtype)
    agg = ops.gcn_aggregate(x_all, edges, uw, n_out, blocks)
    return gin_combine(params, x_all[:n_out], agg)


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


# ---------------------------------------------------------------------------
# GCNII (Chen et al. 2020): initial residual + identity map
# ---------------------------------------------------------------------------

def init_gcnii(gen: torch.Generator, d: int) -> Params:
    return {"w": _glorot(gen, (d, d))}


def gcnii_combine(params: Params, agg: torch.Tensor, x0_b: torch.Tensor,
                  alpha: float, beta: float) -> torch.Tensor:
    """`alpha` and `beta` are Python floats, as in the reference."""
    sup = (1.0 - alpha) * agg + alpha * x0_b
    return (1.0 - beta) * sup + beta * (sup @ params["w"])


def gcnii(params: Params, x_all: torch.Tensor, edges, edge_w: torch.Tensor,
          n_out: int, x0: torch.Tensor, alpha: float, beta: float, *,
          blocks=None) -> torch.Tensor:
    agg = ops.gcn_aggregate(x_all, edges, edge_w, n_out, blocks)
    return gcnii_combine(params, agg, x0[:n_out], alpha, beta)


# ---------------------------------------------------------------------------
# APPNP (Klicpera et al. 2019): fixed propagation of MLP predictions
# ---------------------------------------------------------------------------

def appnp_combine(agg: torch.Tensor, h0_b: torch.Tensor,
                  alpha: float) -> torch.Tensor:
    return (1.0 - alpha) * agg + alpha * h0_b


def appnp_prop(x_all: torch.Tensor, edges, edge_w: torch.Tensor,
               n_out: int, h0: torch.Tensor, alpha: float, *,
               blocks=None) -> torch.Tensor:
    agg = ops.gcn_aggregate(x_all, edges, edge_w, n_out, blocks)
    return appnp_combine(agg, h0[:n_out], alpha)


# ---------------------------------------------------------------------------
# PNA (Corso et al. 2020): multi-aggregator + degree scalers
# ---------------------------------------------------------------------------

def init_pna(gen: torch.Generator, d_in: int, d_out: int) -> Params:
    """Glorot `w1` [2 d_in, f] (the edge MLP over [x_dst ; x_src]) and `w2`
    [d_in + 9 f, d_out] (the readout over [x ; 3 aggregators x 3
    scalers]), zero biases; f = d_out (the reference's shapes and
    distributions, drawn on the CPU from `gen`)."""
    f = d_out
    w1 = _glorot(gen, (2 * d_in, f))
    w2 = _glorot(gen, (d_in + 9 * f, d_out))
    return {"w1": w1, "b1": torch.zeros((f,), dtype=torch.float32),
            "w2": w2, "b2": torch.zeros((d_out,), dtype=torch.float32)}


def pna_transform(params: Params, x_all: torch.Tensor):
    """Per-node halves of PNA's edge MLP: relu([x_dst ; x_src] @ w1 + b1)
    splits exactly into relu(xd[dst] + xs[src]) with xd = x_all @ w1[:d]
    and xs = x_all @ w1[d:] + b1."""
    d_in = x_all.shape[-1]
    xd = x_all @ params["w1"][:d_in]
    xs = x_all @ params["w1"][d_in:] + params["b1"]
    return xd, xs


def pna_combine(params: Params, x_in: torch.Tensor, s, mn, mx, cnt,
                log_deg_mean: float) -> torch.Tensor:
    """Post-aggregation transform: the degree scalers (identity,
    amplification log(d + 1) / log_deg_mean, attenuation log_deg_mean /
    log(d + 1)) over the (mean, min, max) aggregators, then the readout
    MLP over [x_in ; the nine]. `cnt`/`mn`/`mx` follow the
    `ops.pna_reduce` contract (mn/mx are 0 for empty destinations). The
    divisions by `log_deg_mean` divide by a tensor: PyTorch multiplies by
    the reciprocal for a Python-number divisor on CUDA and for a
    Python-number numerator everywhere, which rounds otherwise than the
    reference's division."""
    deg = torch.clamp(cnt, min=1.0)
    mean = s / deg[:, None]
    logd = torch.log(deg + 1.0)
    ldm = torch.full((), log_deg_mean, dtype=logd.dtype,
                     device=logd.device)
    s_amp = (logd / ldm)[:, None]
    s_att = (ldm / torch.clamp(logd, min=1e-6))[:, None]
    aggs = []
    for agg in (mean, mn, mx):
        aggs.extend([agg, agg * s_amp, agg * s_att])
    h = torch.cat([x_in] + aggs, dim=-1)
    return h @ params["w2"] + params["b2"]


def pna_transform_split(params: Params, x_b: torch.Tensor,
                        xh: torch.Tensor):
    """The halo-split PNA transform of layers >= 1: `x_b` [n_b, d] holds
    the exact in-batch rows, `xh` [n_h, d] the pulled halo rows. Halo rows
    are never edge destinations, so their xd half is zeros; the dummy
    row's xs half is b1, as `pna_transform` gives it over a zero row.
    Returns what `pna_transform` returns over [x_b ; xh ; 0]. The
    reference computes both halves at 128 lanes from a lane-padded pull
    and zero-padded weights; the port computes them at the width f
    unpadded, as the kernels mask the ragged features."""
    d = x_b.shape[-1]
    wd, ws, b1 = params["w1"][:d], params["w1"][d:], params["b1"]
    n_h = xh.shape[0]
    xd = torch.cat([x_b @ wd, x_b.new_zeros((n_h + 1, wd.shape[1]))], 0)
    xs = torch.cat([x_b @ ws + b1, xh @ ws + b1, b1[None]], 0)
    return xd, xs


def pna(params: Params, x_all: torch.Tensor, edges, edge_w: torch.Tensor,
        n_out: int, log_deg_mean: float, *, ublocks=None) -> torch.Tensor:
    xd, xs = pna_transform(params, x_all)
    s, mn, mx, cnt = ops.pna_reduce(xd, xs, edges, edge_w, n_out, ublocks)
    return pna_combine(params, x_all[:n_out], s, mn, mx, cnt, log_deg_mean)
