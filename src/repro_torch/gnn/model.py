"""GNN model assembled for GAS batches and for the full graph — GCN, GAT
and PNA.

The port of `repro.gnn.model` for the GCN, GAT and PNA operators. A model is
(pre, prop-layer stack, post); `gas_batch_forward` runs Algorithm 1 on
one padded batch against the history store, `full_forward` runs the same
layers on the whole graph (the exact evaluation, and the full-batch
baseline).

`gas_batch_forward` keeps the reference's gating of its three routes
(except that the fused route does not need the transposed blocks until
a backward runs, so forward-only serve batches take it too):

  * materialized (layer 0, and every layer when `fuse_halo=False` or
    `use_history=False`): `x_all = [x_b ; halo ; 0]`, aggregated through
    `bcsr_spmm` (GCN), the edge-softmax kernels (GAT) or the
    `pna_reduce` kernels (PNA) over the batch's blocks;
  * fused (GCN layers >= 1): `gather_spmm` reads halo rows straight out
    of the history table;
  * halo-split (GAT and PNA layers >= 1): the halo rows are pulled from
    the table and transformed apart from the in-batch rows
    (`gat_transform_split`, `pna_transform_split`).

Each hidden layer's in-batch rows are pushed into the store in place,
detached. The reference traces this under `jax.value_and_grad` and XLA
applies the pushes to the donated tables; here autograd records the
step eagerly while the pushes write the tables as it goes, which is safe
because no backward saves a table. The Eq. 3 regularizer, dropout and
staleness decay are not ported (ROADMAP Queue A item 2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.batch import GASBatch
from repro_torch.core.config import resolve_device
from repro_torch.core.gas import materialize_x_all, staleness_diags
from repro_torch.core.history import HistoryStore
from repro_torch.kernels import ops
from . import layers as L

_OPS_PORTED = ("gcn", "gat", "pna")
# fixed-weight SpMM ops: the fused history-gather route for layers >= 1
FUSED_OPS = ("gcn",)
# data-dependent aggregations: the halo-split route for layers >= 1
HALO_SPLIT_OPS = ("gat", "pna")
# ops that read the unit-weight (multiplicity) blocks
UNIT_BLOCK_OPS = ("gat", "pna")
# ops with a readout head after the propagation layers, each of which
# ends in a ReLU, the last one included
HEAD_OPS = ("pna",)


# the reference's defaults of the fields only unported operators read
_UNPORTED_DEFAULTS = {"alpha": 0.1, "lam": 0.5}


@dataclass(frozen=True)
class GNNSpec:
    op: str                     # gcn | gat | pna (the rest: ROADMAP Queue A)
    d_in: int
    d_hidden: int
    num_classes: int
    num_layers: int             # number of propagation layers K
    heads: int = 8              # gat
    alpha: float = 0.1          # appnp / gcnii
    lam: float = 0.5            # gcnii identity-map strength
    dropout: float = 0.0
    reg_delta: float = 0.0      # Eq. 3 perturbation radius (0 = off)
    reg_weight: float = 0.0
    log_deg_mean: float = 1.0   # pna

    def __post_init__(self):
        for name, op in (("alpha", "appnp / gcnii"), ("lam", "gcnii")):
            if getattr(self, name) != _UNPORTED_DEFAULTS[name]:
                raise NotImplementedError(
                    f"{name} is read only by {op}, which is not ported yet "
                    f"(ROADMAP Queue A item 2); leave it at its default "
                    f"{_UNPORTED_DEFAULTS[name]}")
        if self.dropout != 0.0:
            raise NotImplementedError(
                "dropout is not ported yet (ROADMAP Queue A item 2); the "
                "reference's default is 0.0")
        if self.reg_weight != 0.0 or self.reg_delta != 0.0:
            raise NotImplementedError(
                "the Eq. 3 regularizer (reg_delta / reg_weight) is not "
                "ported yet (ROADMAP Queue A item 2)")

    def hist_dims(self) -> List[int]:
        """Dims of H̄^(1..K-1) — outputs of prop layers 0..K-2."""
        return [self.d_hidden] * (self.num_layers - 1)


def _check_op(spec: GNNSpec) -> None:
    if spec.op not in _OPS_PORTED:
        raise NotImplementedError(
            f"op {spec.op!r} is not ported yet (ROADMAP Queue A item 2, "
            f"operator zoo); ported: {_OPS_PORTED}")


def to_device(params, device) -> Any:
    """The params tree (dicts/lists of tensors) on `device`."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, device) for v in params]
    return params.to(device)


def init_gnn(spec: GNNSpec, seed: int = 0, device=None) -> Dict[str, Any]:
    """The reference's initializers' distributions, drawn from a
    `torch.Generator` seeded with `seed` (on the CPU, so every device gets
    the same values), then moved to `device` (None means "cuda")."""
    _check_op(spec)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if spec.op == "pna":
        dims = [spec.d_in] + [spec.d_hidden] * spec.num_layers
        layers = [L.init_pna(gen, dims[i], dims[i + 1])
                  for i in range(spec.num_layers)]
        head = {"w": L._glorot(gen, (spec.d_hidden, spec.num_classes)),
                "b": torch.zeros((spec.num_classes,), dtype=torch.float32)}
        return to_device({"layers": layers, "head": head}, dev)
    dims = [spec.d_in] + [spec.d_hidden] * (spec.num_layers - 1) + \
        [spec.num_classes]
    if spec.op == "gcn":
        layers = [L.init_gcn(gen, dims[i], dims[i + 1])
                  for i in range(spec.num_layers)]
    else:
        layers = [L.init_gat(gen, dims[i], dims[i + 1],
                             spec.heads if i < spec.num_layers - 1 else 1)
                  for i in range(spec.num_layers)]
    return to_device({"layers": layers}, dev)


def _pre(params, spec: GNNSpec, x):
    return x


def _post(params, spec: GNNSpec, h):
    if spec.op in HEAD_OPS:
        return h @ params["head"]["w"] + params["head"]["b"]
    return h


def _act(spec: GNNSpec, ell: int, h):
    """The layer's nonlinearity: GCN's ReLU and GAT's ELU on the hidden
    layers only (the last one is the logits); PNA's ReLU on every layer,
    the last one included, as its head follows (`model.py:142-146` of
    the reference)."""
    if spec.op in HEAD_OPS:
        return torch.relu(h)
    if ell == spec.num_layers - 1:
        return h
    return torch.relu(h) if spec.op == "gcn" else F.elu(h)


def _prop(params, spec: GNNSpec, ell: int, x_all, edges, edge_w, n_out,
          batch=None):
    """One propagation layer over a materialized x_all: on the batch's
    blocks when `batch` is given, over the COO otherwise."""
    _check_op(spec)
    p = params["layers"][ell]
    if spec.op == "gcn":
        h = L.gcn(p, x_all, edges, edge_w, n_out,
                  blocks=None if batch is None else batch.blocks)
    elif spec.op == "gat":
        h = L.gat(p, x_all, edges, edge_w, n_out,
                  ublocks=None if batch is None else batch.ublocks)
    else:
        h = L.pna(p, x_all, edges, edge_w, n_out, spec.log_deg_mean,
                  ublocks=None if batch is None else batch.ublocks)
    return _act(spec, ell, h)


def _fused_prop(params, spec: GNNSpec, ell: int, x_cur,
                store: HistoryStore, batch: GASBatch):
    """One GCN layer on the fused path: the aggregation reads halo columns
    straight out of the layer's history table (no materialized x_all;
    int8 rows are dequantized and vq code rows decoded in the kernel
    against the store's per-row scales and codebook), then the combine
    transform."""
    n_out = batch.batch_mask.shape[0]
    agg = ops.gas_aggregate(x_cur, store.tables[ell - 1], batch.halo_nodes,
                            batch.halo_mask, n_out, batch.blocks,
                            scales=store.layer_scales(ell - 1),
                            codebook=store.layer_codebook(ell - 1))
    return _act(spec, ell, L.gcn_combine(params["layers"][ell], agg))


def _halo_prop(params, spec: GNNSpec, ell: int, x_cur,
               store: HistoryStore, batch: GASBatch, edges, edge_w):
    """One GAT or PNA layer on the halo-split path: the halo rows are
    pulled from the previous layer's table at its own width (int8 rows
    dequantized and vq code rows decoded in the gather, bf16 rows upcast
    here) and transformed
    apart from the in-batch rows (`gat_transform_split`,
    `pna_transform_split`), then the edge softmax or PNA's reduction runs
    over the unit-weight blocks."""
    n_out = batch.batch_mask.shape[0]
    p = params["layers"][ell]
    xh = store.pull(ell - 1, batch.halo_nodes).to(x_cur.dtype) * \
        batch.halo_mask[:, None]
    if spec.op == "pna":
        xd, xs = L.pna_transform_split(p, x_cur, xh)
        s, mn, mx, cnt = ops.pna_reduce(xd, xs, edges, edge_w, n_out,
                                        batch.ublocks)
        return _act(spec, ell, L.pna_combine(p, x_cur, s, mn, mx, cnt,
                                             spec.log_deg_mean))
    wx, a_d, a_s = L.gat_transform_split(p, x_cur, xh)
    att = ops.edge_softmax_aggregate(wx, a_d, a_s, edges, edge_w, n_out,
                                     batch.ublocks)
    return _act(spec, ell, L.gat_combine(att))


def gas_batch_forward(params, spec: GNNSpec, x_global: torch.Tensor,
                      batch: GASBatch, store: HistoryStore,
                      use_history: bool = True, fuse_halo: bool = True,
                      vq_stats: bool = True
                      ) -> Tuple[torch.Tensor, HistoryStore,
                                 Dict[str, torch.Tensor]]:
    """Returns (logits [max_b, C], the store, diagnostics). The store is
    updated in place: each hidden layer's in-batch rows are pushed and the
    clock is ticked. `batch` must be a single batch on the store's device
    carrying the op's block family (forward blocks for GCN, unit blocks
    for GAT and PNA; the transposed ones too when a gradient is taken).
    Diagnostics: mean/max history age of the halo rows (read before the
    pushes) and `hist_quant_err`, the mean over the hidden layers of the
    relative error their pushes incur at the store's precision (0 for f32
    stores). The reference's third return value, the Eq. 3 regularizer,
    is always 0 here and left out. `vq_stats=False` keeps a vq store's
    k-means statistics as they are (serving; the reference restores them
    after its serving step)."""
    _check_op(spec)
    unit = spec.op in UNIT_BLOCK_OPS
    if (batch.ublocks if unit else batch.blocks) is None:
        raise ValueError(
            "gas_batch_forward needs the batch's "
            f"{'unit-weight' if unit else 'forward'} BCSR blocks "
            "(build_batches(build_blocks=True"
            f"{', unit_weights=True' if unit else ''}))")
    bmask = batch.batch_mask
    hmask = batch.halo_mask
    edges = (batch.edge_dst, batch.edge_src)
    max_b = bmask.shape[0]
    # a backward without the transposed blocks raises in ops.gas_aggregate
    fuse = fuse_halo and use_history and spec.op in FUSED_OPS
    halo_split = fuse_halo and use_history and spec.op in HALO_SPLIT_OPS

    xb = ops.pull_rows(x_global, batch.batch_nodes) * bmask[:, None]
    xh = ops.pull_rows(x_global, batch.halo_nodes) * hmask[:, None]
    hb = _pre(params, spec, xb)
    hh = _pre(params, spec, xh)

    diags = staleness_diags(store.age, batch.halo_nodes, hmask)
    qerr = None                # the sum of the lossy pushes' errors
    x_cur = hb
    for ell in range(spec.num_layers):
        if ell > 0 and fuse:
            x_next = _fused_prop(params, spec, ell, x_cur, store, batch)
        elif ell > 0 and halo_split:
            x_next = _halo_prop(params, spec, ell, x_cur, store, batch,
                                edges, batch.edge_w)
        else:
            x_all = materialize_x_all(ell, x_cur, hh, store, batch,
                                      use_history)
            x_next = _prop(params, spec, ell, x_all, edges, batch.edge_w,
                           max_b, batch)
        if ell < spec.num_layers - 1:
            err = store.push_measured(ell, batch.batch_nodes,
                                      x_next.detach(), bmask, vq_stats)
            if err is not None:
                qerr = err if qerr is None else qerr + err
        x_cur = x_next

    diags["hist_quant_err"] = (
        torch.zeros((), dtype=torch.float32, device=hb.device)
        if qerr is None else qerr / max(spec.num_layers - 1, 1))
    store.tick(batch.batch_nodes, bmask)
    return _post(params, spec, x_cur), store, diags


def full_forward(params, spec: GNNSpec, x: torch.Tensor,
                 edges: Tuple[torch.Tensor, torch.Tensor],
                 edge_w: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """The whole graph, halo-free, aggregated over the COO in plain tensor
    code (no kernel): the exact evaluation and the full-batch baseline."""
    h = _pre(params, spec, x)
    for ell in range(spec.num_layers):
        dummy = torch.zeros((1, h.shape[-1]), dtype=h.dtype, device=h.device)
        x_all = torch.cat([h, dummy], dim=0)
        h = _prop(params, spec, ell, x_all, edges, edge_w, num_nodes)
    return _post(params, spec, h)
