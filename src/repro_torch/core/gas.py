"""GAS batch construction (numpy) and the per-layer executor helpers.

The port of `repro.core.gas`: the GCN-normalized global COO, the weighted
in-edge CSR, `build_batches` (the stacked padded batches of one
partition, with the weighted or the unit-weight BCSR families),
`group_partition` / `padding_bounds` (several clusters per batch),
`patch_batches` (the stack re-emitted only for the parts a graph delta
touched, `core.dynamic.advance`'s), `subgraph_batch` (one padded batch
over an arbitrary node set, serving's and the dynamic re-push's), the
executor's argument guards `ensure_batch` / `resolve_store`, the
per-layer helpers `staleness_diags` / `materialize_x_all`, and
`gas_forward`, the executor over layer callbacks. The host code is a
copy of the reference's numpy code, so its arrays are bitwise the
reference's (tests/test_torch_host.py, tests/test_torch_train.py,
tests/test_torch_dynamic.py).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.data.graphs import Graph
from repro_torch.kernels import ops
from . import history as H
from .batch import BlockStructure, GASBatch


def ensure_batch(batch: GASBatch) -> GASBatch:
    """Type guard of the executor entry points: `GASBatch` is the only
    batch type they take (the reference's legacy batch dict is gone)."""
    if not isinstance(batch, GASBatch):
        raise TypeError(
            f"expected core.batch.GASBatch, got {type(batch)} (the legacy "
            "dict shim was removed; build_batches returns a GASBatch)")
    return batch


def resolve_store(hist: Union[H.HistoryStore, H.Histories]
                  ) -> Tuple[H.HistoryStore, bool]:
    """Normalize the history argument of the executors: (store,
    was_legacy). A `HistoryStore` passes as it is; the legacy `Histories`
    tuple is wrapped (`HistoryStore.from_histories`, the same tensors, so
    the pushes land in its tables), and the executors hand it back as a
    `Histories`. The reference's `backend` has no counterpart: the
    tensors' device picks the kernel or its plain version."""
    if isinstance(hist, H.HistoryStore):
        return hist, False
    return H.HistoryStore.from_histories(hist), True


def gcn_edge_weights(graph: Graph, add_self_loops: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global COO with symmetric GCN normalization (self-loops included)."""
    dst, src = graph.coo()
    if add_self_loops:
        loops = np.arange(graph.num_nodes, dtype=np.int32)
        dst = np.concatenate([dst, loops])
        src = np.concatenate([src, loops])
    deg = np.bincount(dst, minlength=graph.num_nodes).astype(np.float64)
    w = 1.0 / np.sqrt(deg[dst] * deg[src])
    return dst.astype(np.int32), src.astype(np.int32), w.astype(np.float32)


def weighted_in_csr(graph: Graph) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """The weighted in-edge CSR (self-loops included, per-destination
    global-COO order preserved): (indptr [N+1] int64, src [E], w [E])."""
    N = graph.num_nodes
    dst, src, w = gcn_edge_weights(graph)
    order = np.argsort(dst, kind="stable")   # keeps per-dst edge order
    counts = np.bincount(dst[order], minlength=N)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return indptr, src[order], w[order]


def group_partition(part: np.ndarray, clusters_per_batch: int,
                    rng=None) -> np.ndarray:
    """Relabel clusters into batches of `clusters_per_batch` random clusters
    (PyGAS dataloader semantics: mixing clusters per batch de-correlates
    label-pure clusters, e.g. SBM communities)."""
    num_clusters = int(part.max()) + 1
    order = (np.random.default_rng(0) if rng is None else rng
             ).permutation(num_clusters)
    group_of = np.empty(num_clusters, np.int32)
    for i, c in enumerate(order):
        group_of[c] = i // clusters_per_batch
    return group_of[part]


def padding_bounds(graph: Graph, part: np.ndarray, clusters_per_batch: int,
                   add_self_loops: bool = True):
    """Worst-case (max_b, max_h, max_e) over any grouping of k clusters:
    sums of the k largest per-cluster sizes (halo/edges are subadditive)."""
    singles = build_batches(graph, part, add_self_loops, build_blocks=False)
    k = clusters_per_batch
    b_sizes = np.sort(singles.batch_mask.sum(1))[::-1]
    h_sizes = np.sort(singles.halo_mask.sum(1))[::-1]
    e_sizes = np.sort((singles.edge_w > 0).sum(1))[::-1]
    return (int(b_sizes[:k].sum()), int(max(h_sizes[:k].sum(), 1)),
            int(e_sizes[:k].sum()))


def build_batches(graph: Graph, part: np.ndarray,
                  add_self_loops: bool = True,
                  pad_to: Optional[tuple] = None,
                  build_blocks: bool = False,
                  bn: int = 128,
                  pad_k: Optional[int] = None,
                  pad_k_t: Optional[int] = None,
                  unit_weights: bool = False) -> GASBatch:
    """The stacked host `GASBatch` of one partition (numpy leaves with a
    leading batch axis; `.to(device)` moves it). The BCSR families
    describe each batch's local [max_b, max_b+max_h+1] adjacency
    (GCN-normalized weights baked in) tiled into bn x bn blocks, plus its
    transpose, which the backward reads. With `unit_weights=True` (GAT)
    the unit-weight (edge-multiplicity) families are built instead of the
    weighted ones, sharing the same column structure. `pad_to` floors
    (max_b, max_h, max_e), `pad_k`/`pad_k_t` floor the block counts.

    The reference builds blocks by default exactly when its kernel
    backend is not "jnp"; the port has no such backend, so blocks are
    built when `build_blocks=True` and `core.runtime.build_plan` always
    asks for them."""
    N = graph.num_nodes
    B = int(part.max()) + 1
    dst, src, w = gcn_edge_weights(graph, add_self_loops)

    order = np.argsort(part[dst], kind="stable")
    dst_s, src_s, w_s = dst[order], src[order], w[order]
    edge_part = part[dst_s]
    bounds = np.searchsorted(edge_part, np.arange(B + 1))

    batches, halos, edges = [], [], []
    for b in range(B):
        nodes_b = np.flatnonzero(part == b).astype(np.int32)
        e0, e1 = bounds[b], bounds[b + 1]
        d_b, s_b, w_b = dst_s[e0:e1], src_s[e0:e1], w_s[e0:e1]
        halo = np.setdiff1d(s_b, nodes_b)
        # local index map: batch nodes -> [0, nb), halo -> [nb, nb+nh)
        batches.append(nodes_b)
        halos.append(halo.astype(np.int32))
        edges.append((d_b, s_b, w_b))

    max_b = max(len(x) for x in batches)
    max_h = max(max(len(x) for x in halos), 1)
    max_e = max(len(e[0]) for e in edges)
    if pad_to is not None:
        max_b = max(max_b, pad_to[0])
        max_h = max(max_h, pad_to[1])
        max_e = max(max_e, pad_to[2])

    bnode = np.full((B, max_b), N, np.int32)
    bmask = np.zeros((B, max_b), bool)
    hn = np.full((B, max_h), N, np.int32)
    hm = np.zeros((B, max_h), bool)
    ed = np.full((B, max_e), max_b, np.int32)          # trash row
    es = np.full((B, max_e), max_b + max_h, np.int32)  # dummy zero row
    ew = np.zeros((B, max_e), np.float32)

    for b in range(B):
        nodes_b, halo = batches[b], halos[b]
        d_b, s_b, w_b = edges[b]
        nb, nh, ne = len(nodes_b), len(halo), len(d_b)
        bnode[b, :nb] = nodes_b
        bmask[b, :nb] = True
        hn[b, :nh] = halo
        hm[b, :nh] = True
        # global -> local
        lookup = np.full(N + 1, max_b + max_h, np.int64)
        lookup[nodes_b] = np.arange(nb)
        lookup[halo] = max_b + np.arange(nh)
        ed[b, :ne] = lookup[d_b]      # always < nb (dst in batch)
        es[b, :ne] = lookup[s_b]
        ew[b, :ne] = w_b

    fwd = tr = un = un_t = None
    if build_blocks:
        # K/K_t padded to the max over batches (pad_k/pad_k_t keep
        # regrouped epochs at one shape, see runtime._regroup)
        per = [_emit_part_blocks(ed[b], es[b], ew[b], max_b, max_h, bn,
                                 unit_weights) for b in range(B)]
        R = per[0]["v"].shape[0]
        R_t = per[0]["vt"].shape[0]
        K = max(max(e["c"].shape[1] for e in per), pad_k or 1)
        K_t = max(max(e["ct"].shape[1] for e in per), pad_k_t or 1)
        vals = np.zeros((B, R, K, bn, bn), np.float32)
        blk_cols = np.zeros((B, R, K), np.int32)
        vals_t = np.zeros((B, R_t, K_t, bn, bn), np.float32)
        blk_cols_t = np.zeros((B, R_t, K_t), np.int32)
        for b, e in enumerate(per):
            vals[b, :, :e["v"].shape[1]] = e["v"]
            blk_cols[b, :, :e["c"].shape[1]] = e["c"]
            vals_t[b, :, :e["vt"].shape[1]] = e["vt"]
            blk_cols_t[b, :, :e["ct"].shape[1]] = e["ct"]
        if unit_weights:
            un = BlockStructure(vals, blk_cols)
            un_t = BlockStructure(vals_t, blk_cols_t)
        else:
            fwd = BlockStructure(vals, blk_cols)
            tr = BlockStructure(vals_t, blk_cols_t)
    return GASBatch(bnode, bmask, hn, hm, ed, es, ew,
                    forward=fwd, transposed=tr, unit=un, unit_transposed=un_t,
                    num_batches=B, max_b=max_b, max_h=max_h, max_e=max_e,
                    bn=bn)


def _emit_part_blocks(ed_row: np.ndarray, es_row: np.ndarray,
                      ew_row: np.ndarray, max_b: int, max_h: int,
                      bn: int, unit_weights: bool = False,
                      transposed: bool = True) -> dict:
    """BCSR forward (+ transposed, unless `transposed=False`) blocks for
    one batch's padded local COO. Valid slots are `ew > 0` —
    GCN-normalized weights are strictly positive, padding is 0. With
    `unit_weights` (GIN, GAT, PNA) the values are the edge
    multiplicities."""
    valid = ew_row > 0
    d_b, s_b, w_b = ed_row[valid], es_row[valid], ew_row[valid]
    wv = np.ones_like(w_b) if unit_weights else w_b
    n_cols = max_b + max_h + 1
    v, c, _, _ = ops.build_bcsr_rect(d_b, s_b, wv, max_b, n_cols, bn=bn)
    out = {"v": v, "c": c}
    if transposed:
        out["vt"], out["ct"], _, _ = ops.build_bcsr_rect(
            s_b, d_b, wv, n_cols, max_b, bn=bn)
    return out


def _next_pow2(n: int) -> int:
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _pad_blocks(v: np.ndarray, c: np.ndarray, pad_k: Optional[int],
                bn: int) -> BlockStructure:
    """Zero-pad a block family's K axis up to the floor `pad_k`."""
    K = max(c.shape[1], pad_k or 1)
    if K == c.shape[1]:
        return BlockStructure(v, c)
    vals = np.zeros((v.shape[0], K, bn, bn), np.float32)
    cols = np.zeros((c.shape[0], K), np.int32)
    vals[:, :v.shape[1]] = v
    cols[:, :c.shape[1]] = c
    return BlockStructure(vals, cols)


# ---------------------------------------------------------------------------
# Incremental batch patching (evolving graphs, core/dynamic.py)
# ---------------------------------------------------------------------------

def _part_edges(graph: Graph, part: np.ndarray, b: int, deg: np.ndarray,
                add_self_loops: bool = True):
    """Part `b`'s slice of the part-sorted global COO, rebuilt without
    the global COO: the global order is [real edges (destination-major,
    CSR source order) ; self-loops (node order)] and the part sort is
    stable, so within a part it is (the members' real in-edges, members
    ascending, CSR order each) then (the members' self-loops, ascending).
    `deg` is the global float64 degree vector (the self-loop included
    with `add_self_loops`), so the weights are bitwise
    `gcn_edge_weights`'. Returns (nodes_b, halo, d_b, s_b, w_b) in
    global ids."""
    nodes_b = np.flatnonzero(part == b).astype(np.int32)
    indptr = graph.indptr.astype(np.int64)
    starts = indptr[nodes_b]
    lens = indptr[nodes_b + 1] - starts
    total = int(lens.sum())
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    flat = np.repeat(starts - offs, lens) + np.arange(total)
    dst_r = np.repeat(nodes_b, lens)
    src_r = graph.indices[flat].astype(np.int32)
    if add_self_loops:
        d_b = np.concatenate([dst_r, nodes_b]).astype(np.int32)
        s_b = np.concatenate([src_r, nodes_b]).astype(np.int32)
    else:
        d_b, s_b = dst_r.astype(np.int32), src_r
    w_b = (1.0 / np.sqrt(deg[d_b] * deg[s_b])).astype(np.float32)
    halo = np.setdiff1d(s_b, nodes_b).astype(np.int32)
    return nodes_b, halo, d_b, s_b, w_b


def _fill_batch_row(bnode, bmask, hn, hm, ed, es, ew, b: int,
                    nodes_b, halo, d_b, s_b, w_b, N: int) -> None:
    """Overwrite batch row `b` of the padded arrays in place: the whole
    row reset to its pad values (node N, trash row max_b, dummy zero row
    max_b + max_h, weight 0), then filled as `build_batches`' loop fills
    it."""
    max_b, max_h = bnode.shape[1], hn.shape[1]
    nb, nh, ne = len(nodes_b), len(halo), len(d_b)
    bnode[b] = N
    bnode[b, :nb] = nodes_b
    bmask[b] = False
    bmask[b, :nb] = True
    hn[b] = N
    hn[b, :nh] = halo
    hm[b] = False
    hm[b, :nh] = True
    lookup = np.full(N + 1, max_b + max_h, np.int64)
    lookup[nodes_b] = np.arange(nb)
    lookup[halo] = max_b + np.arange(nh)
    ed[b] = max_b
    ed[b, :ne] = lookup[d_b]
    es[b] = max_b + max_h
    es[b, :ne] = lookup[s_b]
    ew[b] = 0.0
    ew[b, :ne] = w_b


def _grow_k(vals: np.ndarray, cols: np.ndarray, k: int
            ) -> Tuple[np.ndarray, np.ndarray]:
    """A stacked block family zero-extended along K to `k` blocks a row:
    padding slots are all-zero blocks at column 0, as `build_batches`
    pads."""
    grow = k - cols.shape[2]
    if grow <= 0:
        return vals, cols
    vals = np.concatenate(
        [vals, np.zeros(vals.shape[:2] + (grow,) + vals.shape[3:],
                        vals.dtype)], axis=2)
    cols = np.concatenate(
        [cols, np.zeros(cols.shape[:2] + (grow,), cols.dtype)], axis=2)
    return vals, cols


def patch_batches(graph: Graph, part: np.ndarray, old: GASBatch,
                  rebuild_parts, num_nodes_old: Optional[int] = None,
                  add_self_loops: bool = True) -> Optional[GASBatch]:
    """Patch a stacked host `GASBatch` after a graph delta: re-emit only
    the batches in `rebuild_parts` (index rows and their BCSR block rows,
    whichever family `old` carries), and copy every other batch's arrays
    as they are. The result is bitwise what `build_batches(graph, part,
    pad_to=old pads, pad_k=K, pad_k_t=K_t, build_blocks=..., unit_weights
    =...)` builds (tests/test_torch_dynamic.py).

    The pads hold: growing max_b or max_h would shift every untouched
    batch's local index space (edge_src offsets, trash and dummy rows),
    so a rebuilt part that overflows the old pads, or a changed part
    count, returns None and the caller rebuilds cold (`core.dynamic`
    sizes the pads with slack to make that rare). A grown node count
    moves only the pad values (node id N), which are fixed up here in the
    untouched rows. The block counts K and K_t may grow: their padding
    slots are all-zero blocks at column 0, as `build_batches` pads."""
    N = graph.num_nodes
    if int(part.max()) + 1 != old.num_batches:
        return None
    B = old.num_batches
    max_b, max_h, max_e = old.max_b, old.max_h, old.max_e
    n_old = N if num_nodes_old is None else int(num_nodes_old)

    deg = np.diff(graph.indptr).astype(np.float64)
    if add_self_loops:
        deg = deg + 1.0

    rebuilt = {}
    for b in sorted({int(b) for b in np.asarray(rebuild_parts).ravel()}):
        nodes_b, halo, d_b, s_b, w_b = _part_edges(
            graph, part, b, deg, add_self_loops)
        if (len(nodes_b) > max_b or len(halo) > max_h
                or len(d_b) > max_e):
            return None
        rebuilt[b] = (nodes_b, halo, d_b, s_b, w_b)

    bnode = np.array(old.batch_nodes, np.int32)
    bmask = np.array(old.batch_mask, bool)
    hn = np.array(old.halo_nodes, np.int32)
    hm = np.array(old.halo_mask, bool)
    ed = np.array(old.edge_dst, np.int32)
    es = np.array(old.edge_src, np.int32)
    ew = np.array(old.edge_w, np.float32)
    if N != n_old:
        # the pad slots are the masked-off slots: repoint them at the new
        # sentinel row, so that untouched batches keep gathering zeros
        bnode[~bmask] = N
        hn[~hm] = N
    for b, (nodes_b, halo, d_b, s_b, w_b) in rebuilt.items():
        _fill_batch_row(bnode, bmask, hn, hm, ed, es, ew, b,
                        nodes_b, halo, d_b, s_b, w_b, N)

    fams = {}
    unit_weights = old.unit is not None
    bs = old.unit if unit_weights else old.forward
    bs_t = old.unit_transposed if unit_weights else old.transposed
    if bs is not None:
        bn = old.bn
        per = {b: _emit_part_blocks(ed[b], es[b], ew[b], max_b, max_h,
                                    bn, unit_weights) for b in rebuilt}
        vals, cols = _grow_k(
            np.array(bs.vals, np.float32), np.array(bs.cols, np.int32),
            max([bs.cols.shape[2]] + [e["c"].shape[1] for e in per.values()]))
        vals_t, cols_t = _grow_k(
            np.array(bs_t.vals, np.float32), np.array(bs_t.cols, np.int32),
            max([bs_t.cols.shape[2]]
                + [e["ct"].shape[1] for e in per.values()]))
        for b, e in per.items():
            vals[b] = 0.0
            cols[b] = 0
            vals[b, :, :e["v"].shape[1]] = e["v"]
            cols[b, :, :e["c"].shape[1]] = e["c"]
            vals_t[b] = 0.0
            cols_t[b] = 0
            vals_t[b, :, :e["vt"].shape[1]] = e["vt"]
            cols_t[b, :, :e["ct"].shape[1]] = e["ct"]
        names = (("unit", "unit_transposed") if unit_weights
                 else ("forward", "transposed"))
        fams = dict(zip(names, (BlockStructure(vals, cols),
                                BlockStructure(vals_t, cols_t))))
    return GASBatch(bnode, bmask, hn, hm, ed, es, ew, num_batches=B,
                    max_b=max_b, max_h=max_h, max_e=max_e, bn=old.bn,
                    **fams)


def subgraph_batch(indptr: np.ndarray, src: np.ndarray, w: np.ndarray,
                   num_nodes: int, nodes: np.ndarray,
                   max_b: Optional[int] = None,
                   max_h: Optional[int] = None,
                   max_e: Optional[int] = None,
                   build_blocks: bool = False,
                   bn: int = 128,
                   pad_k: Optional[int] = None,
                   pad_k_t: Optional[int] = None,
                   transposed: bool = True,
                   unit_weights: bool = False) -> GASBatch:
    """One host `GASBatch` over an arbitrary node set, cut from a weighted
    in-edge CSR (`weighted_in_csr`), with the reference's index
    conventions and per-destination edge order. Pads default to the next
    power of two of the needed size; explicit pads raise on overflow.
    `build_blocks=True` also tiles the local [max_b, max_b+max_h+1]
    adjacency into the forward and transposed BCSR families;
    `pad_k`/`pad_k_t` are monotone floors on their block counts.
    `unit_weights=True` builds the unit-weight (edge-multiplicity)
    families instead (`unit`, `unit_transposed`), for the ops that never
    read the normalized weights (GIN, GAT, PNA), as the reference's
    `subgraph_batch` does. `transposed=False` leaves the transposed family
    (the operand of a backward pass) out, as forward-only serving does."""
    N = int(num_nodes)
    nodes = np.asarray(nodes, np.int64)
    nb = len(nodes)
    indptr = np.asarray(indptr, np.int64)
    starts = indptr[nodes]
    lens = indptr[nodes + 1] - starts
    total = int(lens.sum())
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    flat = np.repeat(starts - offs, lens) + np.arange(total)
    e_src = np.asarray(src)[flat].astype(np.int64)
    e_w = np.asarray(w)[flat]
    e_dst = np.repeat(np.arange(nb, dtype=np.int64), lens)
    halo = np.setdiff1d(e_src, nodes)
    nh = len(halo)

    max_b = _next_pow2(nb) if max_b is None else int(max_b)
    max_h = _next_pow2(nh) if max_h is None else int(max_h)
    max_e = _next_pow2(total) if max_e is None else int(max_e)
    if nb > max_b or nh > max_h or total > max_e:
        raise ValueError(
            f"subgraph ({nb}, {nh}, {total}) exceeds pads "
            f"({max_b}, {max_h}, {max_e})")

    lookup = np.full(N + 1, max_b + max_h, np.int64)
    lookup[nodes] = np.arange(nb)
    lookup[halo] = max_b + np.arange(nh)
    bnode = np.full(max_b, N, np.int32)
    bnode[:nb] = nodes
    bmask = np.zeros(max_b, bool)
    bmask[:nb] = True
    hn = np.full(max_h, N, np.int32)
    hn[:nh] = halo
    hm = np.zeros(max_h, bool)
    hm[:nh] = True
    ed = np.full(max_e, max_b, np.int32)
    ed[:total] = e_dst
    es = np.full(max_e, max_b + max_h, np.int32)
    es[:total] = lookup[e_src]
    ew = np.zeros(max_e, np.float32)
    ew[:total] = e_w

    fam = fam_t = None
    if build_blocks:
        e = _emit_part_blocks(ed, es, ew, max_b, max_h, bn, unit_weights,
                              transposed=transposed)
        fam = _pad_blocks(e["v"], e["c"], pad_k, bn)
        if transposed:
            fam_t = _pad_blocks(e["vt"], e["ct"], pad_k_t, bn)
    kw = (dict(unit=fam, unit_transposed=fam_t) if unit_weights
          else dict(forward=fam, transposed=fam_t))
    return GASBatch(bnode, bmask, hn, hm, ed, es, ew, max_b=max_b,
                    max_h=max_h, max_e=max_e, bn=bn, **kw)


def staleness_diags(age: torch.Tensor, halo_nodes: torch.Tensor,
                    halo_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mean/max history age of the halo rows this batch pulls."""
    idx = halo_nodes.long().clamp(0, age.shape[0] - 1)
    hage = age[idx].to(torch.float32)
    valid = halo_mask.to(torch.float32)
    n = torch.clamp(valid.sum(), min=1.0)
    return {"halo_age_mean": (hage * valid).sum() / n,
            "halo_age_max": (hage * valid).max()}


def history_view(store, batch: GASBatch, pulled=None,
                 use_history: bool = True) -> Tuple[Any, GASBatch]:
    """(the store to read history from, the batch to read it with). With
    `pulled` (`store.prefetch(batch.halo_nodes)`, perhaps patched since),
    or for a host store, which is read only that way (its prefetch taken
    here), the reads go to `store.with_pulled(pulled)`, whose row i holds
    halo node i: the batch's halo ids become arange(max_h), bit for bit
    the same reads. Otherwise (store, batch) as they are."""
    if use_history and pulled is None and store.storage == "host":
        pulled = store.prefetch(batch.halo_nodes)
    if not use_history or pulled is None:
        return store, batch
    hmask = batch.halo_mask
    return store.with_pulled(pulled), replace(batch, halo_nodes=torch.arange(
        hmask.shape[0], dtype=torch.int32, device=hmask.device))


def materialize_x_all(ell: int, x_cur: torch.Tensor, xh: torch.Tensor,
                      store, batch: GASBatch, use_history: bool = True,
                      halo_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Unfused layer input `x_all = [x_cur ; halo_rows ; dummy-zero row]`:
    layer 0 uses the exact halo rows `xh`; layers >= 1 pull the previous
    layer's history rows through the store (dequantized for int8, decoded
    for vq, upcast for bf16; zeros when history is off). `halo_scale`
    [max_h], when given, damps the pulled rows (staleness compensation,
    `GASConfig.halo_age_decay`); layer 0's halo rows are exact and never
    scaled."""
    if ell == 0:
        halo_rows = xh
    elif use_history:
        halo_rows = store.pull(ell - 1, batch.halo_nodes)
        halo_rows = halo_rows.to(x_cur.dtype) * batch.halo_mask[:, None]
        if halo_scale is not None:
            halo_rows = halo_rows * halo_scale[:, None]
    else:
        halo_rows = torch.zeros((batch.halo_nodes.shape[0],
                                 x_cur.shape[-1]), dtype=x_cur.dtype,
                                device=x_cur.device)
    dummy = torch.zeros((1, x_cur.shape[-1]), dtype=x_cur.dtype,
                        device=x_cur.device)
    return torch.cat([x_cur, halo_rows, dummy], dim=0)


def gas_forward(layer_apply: Callable[[int, torch.Tensor, GASBatch],
                                      torch.Tensor],
                num_layers: int, x_global: torch.Tensor, batch: GASBatch,
                store, use_history: bool = True,
                fused_layer_apply: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
    """Runs `num_layers` layers of any operator on one padded batch
    (`core/gas.py:572-646` of the reference): `layer_apply(ell, x_all,
    batch)` returns the new in-batch rows [max_b, d] from a materialized
    x_all. `fused_layer_apply(ell, x_cur, (table, scales, codebook,
    halo_nodes, halo_mask), batch)`, when given, replaces it for layers
    >= 1 with history on: the callee aggregates through
    `ops.gas_aggregate`, which reads the halo rows straight out of the
    table. Each hidden layer's rows are pushed into `store` in place,
    detached, and the clock ticks. Returns (the last layer's rows, the
    store, diagnostics: the halo rows' mean/max age and
    `hist_quant_err`). `store` may be a `HistoryStore` or the legacy
    `Histories` tuple, which comes back as a `Histories`."""
    batch = ensure_batch(batch)
    store, legacy = resolve_store(store)
    bmask, hmask = batch.batch_mask, batch.halo_mask
    xb = ops.pull_rows(x_global, batch.batch_nodes) * bmask[:, None]
    xh = ops.pull_rows(x_global, batch.halo_nodes) * hmask[:, None]
    diags = staleness_diags(store.age, batch.halo_nodes, hmask)
    view, vbatch = history_view(store, batch, use_history=use_history)
    fuse = fused_layer_apply is not None and use_history
    qerr = None
    x_cur = xb
    for ell in range(num_layers):
        if ell > 0 and fuse:
            x_next = fused_layer_apply(
                ell, x_cur, (view.tables[ell - 1],
                             view.layer_scales(ell - 1),
                             view.layer_codebook(ell - 1),
                             vbatch.halo_nodes, hmask), batch)
        else:
            x_all = materialize_x_all(ell, x_cur, xh, view, vbatch,
                                      use_history)
            x_next = layer_apply(ell, x_all, batch)
        if ell < num_layers - 1:
            err = store.push_measured(ell, batch.batch_nodes,
                                      x_next.detach(), bmask)
            if err is not None:
                qerr = err if qerr is None else qerr + err
        x_cur = x_next
    diags["hist_quant_err"] = (
        torch.zeros((), dtype=torch.float32, device=xb.device)
        if qerr is None else qerr / max(num_layers - 1, 1))
    store.tick(batch.batch_nodes, bmask)
    return x_cur, (store.to_histories() if legacy else store), diags
