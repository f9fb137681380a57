"""GNN model assembled for GAS batches and for the full graph — the
reference's six operators: GCN, GIN, GAT, GCNII, APPNP and PNA.

The port of `repro.gnn.model`. A model is (pre, prop-layer stack, post):
`_pre` is GCNII's input projection (ReLU) or APPNP's two-layer MLP,
identity otherwise; `_post` is the readout head of GIN, GCNII and PNA.
`gas_batch_forward` runs Algorithm 1 on one padded batch against the
history store, `full_forward` runs the same layers on the whole graph
(the exact evaluation, and the full-batch baseline).

`gas_batch_forward` keeps the reference's gating of its three routes
(except that the fused route does not need the transposed blocks until
a backward runs, so forward-only serve batches take it too):

  * materialized (layer 0, and every layer when `fuse_halo=False`,
    `use_history=False`, the Eq. 3 regularizer is on or
    `halo_age_decay > 0`): `x_all = [x_b ; halo ; 0]`, aggregated through
    `bcsr_spmm` (GCN, GCNII and APPNP over the weighted blocks, GIN over
    the unit-weight ones), the edge-softmax kernels (GAT) or the
    `pna_reduce` kernels (PNA);
  * fused (GCN, GIN, GCNII and APPNP layers >= 1): `gather_spmm` reads
    halo rows straight out of the history table;
  * halo-split (GAT and PNA layers >= 1): the halo rows are pulled from
    the table and transformed apart from the in-batch rows
    (`gat_transform_split`, `pna_transform_split`).

With a generator given and `reg_weight > 0`, each layer adds the Eq. 3
term: the layer run again on `x_all + reg_delta * noise` (`reg_noise`),
the per-node distance over sqrt(d), averaged over the batch's rows and
the layers. `halo_age_decay > 0` damps every pulled halo row by
1 / (1 + decay * age), from the clock before the step. `dropout` is a
field the reference never reads, and neither does the port.

With `pulled` (the halo's rows prefetched from the store,
`HistoryStore.prefetch`) every history read of the three routes goes to
the device mini-tables of `store.with_pulled(pulled)` at arange(max_h),
which is bit for bit a read of the full tables at the halo's ids; a host
store (`history_storage="host"`) is always read that way, its prefetch
taken here when the caller gave none.

Each hidden layer's in-batch rows are pushed into the store in place,
detached. The reference traces this under `jax.value_and_grad` and XLA
applies the pushes to the donated tables; here autograd records the
step eagerly while the pushes write the tables as it goes, which is safe
because no backward saves a table.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.batch import GASBatch
from repro_torch.core.config import resolve_device
from repro_torch.core.gas import (ensure_batch, history_view,
                                  materialize_x_all, resolve_store,
                                  staleness_diags)
from repro_torch.core.history import HistoryStore
from repro_torch.kernels import ops
from . import layers as L

OPS = ("gcn", "gin", "gat", "gcnii", "appnp", "pna")
# fixed-weight SpMM ops: the fused history-gather route for layers >= 1
FUSED_OPS = ("gcn", "gin", "gcnii", "appnp")
# data-dependent aggregations: the halo-split route for layers >= 1
HALO_SPLIT_OPS = ("gat", "pna")
# ops that read the unit-weight (multiplicity) blocks; every op reads one
# block family (the weighted one unless it is in UNIT_BLOCK_OPS)
UNIT_BLOCK_OPS = ("gin", "gat", "pna")
BLOCK_OPS = ("gcn", "gin", "gcnii", "appnp", "gat", "pna")
# ops with a readout head after the propagation layers, each of which
# ends in a ReLU, the last one included
HEAD_OPS = ("gin", "gcnii", "pna")


@dataclass(frozen=True)
class GNNSpec:
    op: str                     # gcn | gat | gin | gcnii | appnp | pna
    d_in: int
    d_hidden: int
    num_classes: int
    num_layers: int             # number of propagation layers K
    heads: int = 8              # gat
    alpha: float = 0.1          # appnp / gcnii
    lam: float = 0.5            # gcnii identity-map strength
    dropout: float = 0.0        # never read, as in the reference
    reg_delta: float = 0.0      # Eq. 3 perturbation radius (0 = off)
    reg_weight: float = 0.0
    log_deg_mean: float = 1.0   # pna

    def hist_dims(self) -> List[int]:
        """Dims of H̄^(1..K-1) — outputs of prop layers 0..K-2 (APPNP
        propagates its MLP's class scores)."""
        d = self.num_classes if self.op == "appnp" else self.d_hidden
        return [d] * (self.num_layers - 1)


def _check_op(spec: GNNSpec) -> None:
    if spec.op not in OPS:
        raise ValueError(f"unknown op {spec.op!r}; the operators: {OPS}")


def to_device(params, device) -> Any:
    """The params tree (dicts/lists of tensors) on `device`."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, device) for v in params]
    return params.to(device)


def init_gnn(spec: GNNSpec, seed: int = 0, device=None) -> Dict[str, Any]:
    """The reference's initializers' distributions and shapes, drawn from a
    `torch.Generator` seeded with `seed` (on the CPU, so every device gets
    the same values), then moved to `device` (None means "cuda")."""
    _check_op(spec)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    op, K = spec.op, spec.num_layers

    def head():
        return {"w": L._glorot(gen, (spec.d_hidden, spec.num_classes)),
                "b": torch.zeros((spec.num_classes,), dtype=torch.float32)}

    p: Dict[str, Any] = {"layers": []}
    if op in ("gcn", "gat"):
        dims = [spec.d_in] + [spec.d_hidden] * (K - 1) + [spec.num_classes]
        if op == "gcn":
            p["layers"] = [L.init_gcn(gen, dims[i], dims[i + 1])
                           for i in range(K)]
        else:
            p["layers"] = [L.init_gat(gen, dims[i], dims[i + 1],
                                      spec.heads if i < K - 1 else 1)
                           for i in range(K)]
    elif op in ("gin", "pna"):
        dims = [spec.d_in] + [spec.d_hidden] * K
        init = L.init_gin if op == "gin" else L.init_pna
        p["layers"] = [init(gen, dims[i], dims[i + 1]) for i in range(K)]
        p["head"] = head()
    elif op == "gcnii":
        p["w_in"] = {"w": L._glorot(gen, (spec.d_in, spec.d_hidden)),
                     "b": torch.zeros((spec.d_hidden,), dtype=torch.float32)}
        p["layers"] = [L.init_gcnii(gen, spec.d_hidden) for _ in range(K)]
        p["head"] = head()
    else:
        p["mlp"] = {"w1": L._glorot(gen, (spec.d_in, spec.d_hidden)),
                    "b1": torch.zeros((spec.d_hidden,), dtype=torch.float32),
                    "w2": L._glorot(gen, (spec.d_hidden, spec.num_classes)),
                    "b2": torch.zeros((spec.num_classes,),
                                      dtype=torch.float32)}
    return to_device(p, dev)


def _pre(params, spec: GNNSpec, x):
    if spec.op == "gcnii":
        return torch.relu(x @ params["w_in"]["w"] + params["w_in"]["b"])
    if spec.op == "appnp":
        h = torch.relu(x @ params["mlp"]["w1"] + params["mlp"]["b1"])
        return h @ params["mlp"]["w2"] + params["mlp"]["b2"]
    return x


def _post(params, spec: GNNSpec, h):
    if spec.op in HEAD_OPS:
        return h @ params["head"]["w"] + params["head"]["b"]
    return h


def _act(spec: GNNSpec, ell: int, h):
    """The layer's nonlinearity: GCN's ReLU and GAT's ELU on the hidden
    layers only (the last one is the logits); GIN's, GCNII's and PNA's
    ReLU on every layer, the last one included, as their head follows;
    none for APPNP's propagation (`model.py:117-147` of the reference)."""
    if spec.op in HEAD_OPS:
        return torch.relu(h)
    if spec.op == "appnp" or ell == spec.num_layers - 1:
        return h
    return torch.relu(h) if spec.op == "gcn" else F.elu(h)


def _beta(spec: GNNSpec, ell: int) -> float:
    """GCNII's identity-map weight at layer `ell`, a Python float."""
    return math.log(spec.lam / (ell + 1) + 1.0)


def _prop(params, spec: GNNSpec, ell: int, x_all, edges, edge_w, n_out,
          batch=None, h0=None):
    """One propagation layer over a materialized x_all: on the batch's
    blocks when `batch` is given, over the COO otherwise. `h0` holds the
    `_pre` rows of the destinations (GCNII's initial residual, APPNP's
    teleport)."""
    _check_op(spec)
    op = spec.op
    blocks = ublocks = None
    if batch is not None:
        blocks, ublocks = batch.blocks, batch.ublocks
    if op == "appnp":
        return L.appnp_prop(x_all, edges, edge_w, n_out, h0, spec.alpha,
                            blocks=blocks)
    p = params["layers"][ell]
    if op == "gcn":
        h = L.gcn(p, x_all, edges, edge_w, n_out, blocks=blocks)
    elif op == "gin":
        h = L.gin(p, x_all, edges, edge_w, n_out, blocks=ublocks)
    elif op == "gcnii":
        h = L.gcnii(p, x_all, edges, edge_w, n_out, h0, spec.alpha,
                    _beta(spec, ell), blocks=blocks)
    elif op == "gat":
        h = L.gat(p, x_all, edges, edge_w, n_out, ublocks=ublocks)
    else:
        h = L.pna(p, x_all, edges, edge_w, n_out, spec.log_deg_mean,
                  ublocks=ublocks)
    return _act(spec, ell, h)


def _fused_prop(params, spec: GNNSpec, ell: int, x_cur,
                store: HistoryStore, batch: GASBatch, h0):
    """One GCN, GIN, GCNII or APPNP layer on the fused path: the
    aggregation reads halo columns straight out of the layer's history
    table (no materialized x_all; int8 rows are dequantized and vq code
    rows decoded in the kernel against the store's per-row scales and
    codebook; GIN over the unit-weight blocks), then the op's combine
    transform."""
    n_out = batch.batch_mask.shape[0]
    op = spec.op
    agg = ops.gas_aggregate(x_cur, store.tables[ell - 1], batch.halo_nodes,
                            batch.halo_mask, n_out,
                            batch.ublocks if op == "gin" else batch.blocks,
                            scales=store.layer_scales(ell - 1),
                            codebook=store.layer_codebook(ell - 1))
    if op == "appnp":
        return L.appnp_combine(agg, h0, spec.alpha)
    p = params["layers"][ell]
    if op == "gcn":
        h = L.gcn_combine(p, agg)
    elif op == "gin":
        h = L.gin_combine(p, x_cur, agg)
    else:
        h = L.gcnii_combine(p, agg, h0, spec.alpha, _beta(spec, ell))
    return _act(spec, ell, h)


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


def reg_noise(gen: torch.Generator, shape, device) -> torch.Tensor:
    """The Eq. 3 term's standard-normal draw for one layer, from `gen` on
    `device` (the reference's distribution, not its bits). Every draw of
    a step goes through here, one call per layer in layer order."""
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def _eq3_term(x_next, x_pert, bmask, num_layers: int) -> torch.Tensor:
    """One layer's share of the Eq. 3 regularizer: the eps-guarded
    per-node norm of (f(h) - f(h + noise)) over sqrt(d) (the guard keeps
    the gradient of an all-zero padding row finite), summed over the
    rows, over the batch's valid rows and over the layer count. Each
    divisor is a tensor, so that the card divides as the reference does
    (PyTorch multiplies by a Python divisor's reciprocal on CUDA)."""
    sq = torch.sum(torch.square((x_next - x_pert) * bmask[:, None]), dim=-1)
    diff = torch.sqrt(sq + 1e-12) / torch.full(
        (), math.sqrt(x_next.shape[-1]), dtype=sq.dtype, device=sq.device)
    n = torch.clamp(bmask.sum(), min=1).to(torch.float32)
    return torch.sum(diff) / n / torch.full((), float(num_layers),
                                            dtype=n.dtype, device=n.device)


def gas_batch_forward(params, spec: GNNSpec, x_global: torch.Tensor,
                      batch: GASBatch, store: HistoryStore,
                      use_history: bool = True, fuse_halo: bool = True,
                      vq_stats: bool = True,
                      gen: Optional[torch.Generator] = None,
                      halo_age_decay: float = 0.0,
                      pulled: Optional[tuple] = None,
                      return_pushed: bool = False,
                      apply_pushes: bool = True) -> tuple:
    """Returns (logits [max_b, C], the store, diagnostics). The store is
    updated in place: each hidden layer's in-batch rows are pushed and the
    clock is ticked. A legacy `Histories` tuple is taken too and comes
    back as one (`core.gas.resolve_store`). `batch` must be a single
    batch on the store's device carrying the op's block family (forward
    blocks for GCN, GCNII and APPNP, unit blocks for GIN, GAT and PNA;
    the transposed ones too when a gradient is taken). Diagnostics:
    mean/max history age of the halo rows (read before the pushes),
    `hist_quant_err`, the mean over the hidden layers of the relative
    error their pushes incur at the store's precision (0 for f32 stores),
    and `reg`, the Eq. 3 regularizer (the
    reference's third return value; 0 unless `spec.reg_weight > 0` and a
    generator `gen` on the batch's device draws its noise).
    `halo_age_decay > 0` damps the pulled halo rows of layers >= 1 by
    1 / (1 + decay * age) from the clock before the step; it and an
    active regularizer take every layer onto the materialized route, as
    in the reference. `vq_stats=False` keeps a vq store's k-means
    statistics as they are (serving; the reference restores them after
    its serving step).

    `pulled` (from `store.prefetch(batch.halo_nodes)`, perhaps taken
    before earlier pushes and then patched, `HistoryStore.patch_pulled`)
    feeds every history read from device mini-tables, bit for bit what
    the full tables would give; the pushes and the clock still go to
    `store`. A host store with no `pulled` prefetches here, so no kernel
    but `gather_rows_raw` and the pushes touches its tables. With
    `return_pushed` a fourth element follows: the tuple of the hidden
    layers' pushed rows, what `patch_pulled` takes (the reference's
    `return_pushed=True`).

    `apply_pushes=False` (the reference's flag) computes the forward, the
    pushed rows and `hist_quant_err` (`store.quant_error` of the rows)
    without writing anything: no table is pushed and the clock does not
    tick. A serving frontend runs it against its pulled mini-tables and
    ships the rows to the store's owner (`core.serve_service`)."""
    _check_op(spec)
    batch = ensure_batch(batch)
    store, legacy = resolve_store(store)
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
    reg_on = spec.reg_weight > 0.0 and gen is not None
    # the fused and halo-split routes read raw table rows and build no
    # x_all to perturb; a backward without the transposed blocks raises
    # in ops.gas_aggregate
    direct = fuse_halo and use_history and not reg_on and not halo_age_decay
    fuse = direct and spec.op in FUSED_OPS
    halo_split = direct and spec.op in HALO_SPLIT_OPS

    xb = ops.pull_rows(x_global, batch.batch_nodes) * bmask[:, None]
    xh = ops.pull_rows(x_global, batch.halo_nodes) * hmask[:, None]
    hb = _pre(params, spec, xb)
    hh = _pre(params, spec, xh)

    diags = staleness_diags(store.age, batch.halo_nodes, hmask)
    view, vbatch = history_view(store, batch, pulled, use_history)
    halo_scale = None
    if halo_age_decay and use_history:
        # one trust weight per halo slot from the clock before the step
        # (it ticks only at the end), the same for every layer
        hage = store.age[batch.halo_nodes.long().clamp(
            0, store.age.shape[0] - 1)].to(torch.float32)
        halo_scale = torch.reciprocal(1.0 + halo_age_decay * hage)
    reg = torch.zeros((), dtype=torch.float32, device=hb.device)
    qerr = None                # the sum of the lossy pushes' errors
    pushed = []
    x_cur = hb
    for ell in range(spec.num_layers):
        if ell > 0 and fuse:
            x_next = _fused_prop(params, spec, ell, x_cur, view, vbatch, hb)
        elif ell > 0 and halo_split:
            x_next = _halo_prop(params, spec, ell, x_cur, view, vbatch,
                                edges, batch.edge_w)
        else:
            x_all = materialize_x_all(ell, x_cur, hh, view, vbatch,
                                      use_history, halo_scale=halo_scale)
            x_next = _prop(params, spec, ell, x_all, edges, batch.edge_w,
                           max_b, batch, hb)
            if reg_on:
                # Eq. 3: || f(h) - f(h + eps) ||, eps ~ B_delta(0)
                noise = spec.reg_delta * reg_noise(gen, tuple(x_all.shape),
                                                   x_all.device)
                x_pert = _prop(params, spec, ell, x_all + noise, edges,
                               batch.edge_w, max_b, batch, hb)
                reg = reg + _eq3_term(x_next, x_pert, bmask,
                                      spec.num_layers)
        if ell < spec.num_layers - 1:
            pushed.append(x_next.detach())
            err = (store.push_measured(ell, batch.batch_nodes, pushed[-1],
                                       bmask, vq_stats) if apply_pushes
                   else store.quant_error(pushed[-1], bmask, ell))
            if err is not None:
                qerr = err if qerr is None else qerr + err
        x_cur = x_next

    diags["hist_quant_err"] = (
        torch.zeros((), dtype=torch.float32, device=hb.device)
        if qerr is None else qerr / max(spec.num_layers - 1, 1))
    diags["reg"] = reg
    if apply_pushes:
        store.tick(batch.batch_nodes, bmask)
    out = (_post(params, spec, x_cur),
           store.to_histories() if legacy else store, diags)
    return out + (tuple(pushed),) if return_pushed else out


def full_forward(params, spec: GNNSpec, x: torch.Tensor,
                 edges: Tuple[torch.Tensor, torch.Tensor],
                 edge_w: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """The whole graph, halo-free, aggregated over the COO in plain tensor
    code (no kernel): the exact evaluation and the full-batch baseline."""
    h = h0 = _pre(params, spec, x)
    for ell in range(spec.num_layers):
        dummy = torch.zeros((1, h.shape[-1]), dtype=h.dtype, device=h.device)
        x_all = torch.cat([h, dummy], dim=0)
        h = _prop(params, spec, ell, x_all, edges, edge_w, num_nodes, h0=h0)
    return _post(params, spec, h)
