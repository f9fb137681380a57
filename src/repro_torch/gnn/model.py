"""GNN model assembled for GAS batches and for the full graph — GCN so far.

The port of `repro.gnn.model` for the GCN operator. A model is (pre,
prop-layer stack, post); `gas_batch_forward` runs Algorithm 1 on one
padded batch against the history store, `full_forward` runs the same
layers on the whole graph (the exact reference of serving at SLO=0).

`gas_batch_forward` ports the serving branch of the reference: histories
on, the fused halo route for layers >= 1, no Eq. 3 regularizer, no
staleness decay and no prefetched pulls. Layer 0 aggregates the exact
[in-batch ; halo ; 0] features through `bcsr_spmm`; layers >= 1
aggregate through `gather_spmm`, which reads halo rows straight out of
the history table; each hidden layer's in-batch rows are pushed into the
store in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core.batch import GASBatch
from repro_torch.core.config import resolve_device
from repro_torch.core.gas import materialize_x_all, staleness_diags
from repro_torch.core.history import HistoryStore
from repro_torch.kernels import ops
from . import layers as L

_OPS_PORTED = ("gcn",)


@dataclass(frozen=True)
class GNNSpec:
    op: str                     # gcn (the other operators: ROADMAP Queue A)
    d_in: int
    d_hidden: int
    num_classes: int
    num_layers: int             # number of propagation layers K

    def hist_dims(self) -> List[int]:
        """Dims of H̄^(1..K-1) — outputs of prop layers 0..K-2."""
        return [self.d_hidden] * (self.num_layers - 1)


def _check_op(spec: GNNSpec) -> None:
    if spec.op not in _OPS_PORTED:
        raise NotImplementedError(
            f"op {spec.op!r} is not ported yet (ROADMAP Queue A, operator "
            f"zoo); ported: {_OPS_PORTED}")


def to_device(params, device) -> Any:
    """The params tree (dicts/lists of tensors) on `device`."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, device) for v in params]
    return params.to(device)


def init_gnn(spec: GNNSpec, seed: int = 0, device=None) -> Dict[str, Any]:
    """Glorot weights and zero biases, drawn from a `torch.Generator`
    seeded with `seed` (on the CPU, so every device gets the same
    values), then moved to `device` (None means "cuda")."""
    _check_op(spec)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dims = [spec.d_in] + [spec.d_hidden] * (spec.num_layers - 1) + \
        [spec.num_classes]
    params = {"layers": [L.init_gcn(gen, dims[i], dims[i + 1])
                         for i in range(spec.num_layers)]}
    return to_device(params, dev)


def _pre(params, spec: GNNSpec, x):
    return x


def _post(params, spec: GNNSpec, h):
    return h


def _prop(params, spec: GNNSpec, ell: int, x_all, edges, edge_w, n_out,
          blocks=None):
    _check_op(spec)
    h = L.gcn(params["layers"][ell], x_all, edges, edge_w, n_out,
              blocks=blocks)
    return h if ell == spec.num_layers - 1 else torch.relu(h)


def _fused_prop(params, spec: GNNSpec, ell: int, x_cur,
                store: HistoryStore, batch: GASBatch):
    """One propagation layer on the fused path: the aggregation reads halo
    columns straight out of the layer's history table (no materialized
    x_all), then the op's combine transform."""
    _check_op(spec)
    n_out = batch.batch_mask.shape[0]
    agg = ops.gas_aggregate(x_cur, store.tables[ell - 1], batch.halo_nodes,
                            batch.halo_mask, n_out, batch.blocks)
    h = L.gcn_combine(params["layers"][ell], agg)
    return h if ell == spec.num_layers - 1 else torch.relu(h)


def gas_batch_forward(params, spec: GNNSpec, x_global: torch.Tensor,
                      batch: GASBatch, store: HistoryStore,
                      use_history: bool = True, fuse_halo: bool = True
                      ) -> Tuple[torch.Tensor, HistoryStore,
                                 Dict[str, torch.Tensor]]:
    """Returns (logits [max_b, C], the store, diagnostics). The store is
    updated in place: each hidden layer's in-batch rows are pushed and the
    clock is ticked. `batch` must be on the store's device and carry its
    forward blocks. Diagnostics: mean/max history age of the halo rows
    (read before the pushes) and `hist_quant_err`, 0 for f32 stores.

    Only the serving branch of the reference is ported; the other
    branches raise."""
    _check_op(spec)
    if not (use_history and fuse_halo):
        raise NotImplementedError(
            "gas_batch_forward ports the serving branch only "
            "(use_history=True, fuse_halo=True); the unfused and "
            "history-free paths come with the training slice (ROADMAP "
            "Queue A)")
    if batch.forward is None:
        raise ValueError("gas_batch_forward needs the batch's forward BCSR "
                         "blocks (subgraph_batch(build_blocks=True))")
    bmask = batch.batch_mask
    hmask = batch.halo_mask
    edges = (batch.edge_dst, batch.edge_src)
    max_b = bmask.shape[0]

    xb = ops.pull_rows(x_global, batch.batch_nodes) * bmask[:, None]
    xh = ops.pull_rows(x_global, batch.halo_nodes) * hmask[:, None]
    hb = _pre(params, spec, xb)
    hh = _pre(params, spec, xh)

    diags = staleness_diags(store.age, batch.halo_nodes, hmask)
    x_cur = hb
    for ell in range(spec.num_layers):
        if ell > 0:
            x_next = _fused_prop(params, spec, ell, x_cur, store, batch)
        else:
            x_all = materialize_x_all(ell, x_cur, hh, store, batch)
            x_next = _prop(params, spec, ell, x_all, edges, batch.edge_w,
                           max_b, blocks=batch.blocks)
        if ell < spec.num_layers - 1:
            store.push(ell, batch.batch_nodes, x_next.detach(), bmask)
        x_cur = x_next

    diags["hist_quant_err"] = torch.zeros((), dtype=torch.float32,
                                          device=x_cur.device)
    store.tick(batch.batch_nodes, bmask)
    return _post(params, spec, x_cur), store, diags


def full_forward(params, spec: GNNSpec, x: torch.Tensor,
                 edges: Tuple[torch.Tensor, torch.Tensor],
                 edge_w: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """The whole graph, halo-free, aggregated over the COO in plain tensor
    code (no kernel): the exact reference serving is checked against."""
    h = _pre(params, spec, x)
    for ell in range(spec.num_layers):
        dummy = torch.zeros((1, h.shape[-1]), dtype=h.dtype, device=h.device)
        x_all = torch.cat([h, dummy], dim=0)
        h = _prop(params, spec, ell, x_all, edges, edge_w, num_nodes)
    return _post(params, spec, h)
