"""GAS batch construction (numpy) and the executor helpers serving needs.

The port of the serving half of `repro.core.gas`: the GCN-normalized
global COO, the weighted in-edge CSR, `subgraph_batch` (one padded batch
over an arbitrary node set, optionally tiled into BCSR blocks) and the
per-layer helpers `staleness_diags` / `materialize_x_all`. The host code
is a copy of the reference's numpy code, so its arrays are bitwise the
reference's (tests/test_torch_host.py). Partition-based `build_batches`
belongs to the training slice (ROADMAP Queue A).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.graphs import Graph
from repro_torch.kernels import ops
from .batch import BlockStructure, GASBatch


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


def _emit_part_blocks(ed_row: np.ndarray, es_row: np.ndarray,
                      ew_row: np.ndarray, max_b: int, max_h: int,
                      bn: int, transposed: bool = True) -> dict:
    """BCSR forward (+ transposed, unless `transposed=False`) blocks for
    one batch's padded local COO. Valid slots are `ew > 0` —
    GCN-normalized weights are strictly positive, padding is 0."""
    valid = ew_row > 0
    d_b, s_b, w_b = ed_row[valid], es_row[valid], ew_row[valid]
    n_cols = max_b + max_h + 1
    v, c, _, _ = ops.build_bcsr_rect(d_b, s_b, w_b, max_b, n_cols, bn=bn)
    out = {"v": v, "c": c}
    if transposed:
        out["vt"], out["ct"], _, _ = ops.build_bcsr_rect(
            s_b, d_b, w_b, n_cols, max_b, bn=bn)
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


def subgraph_batch(indptr: np.ndarray, src: np.ndarray, w: np.ndarray,
                   num_nodes: int, nodes: np.ndarray,
                   max_b: Optional[int] = None,
                   max_h: Optional[int] = None,
                   max_e: Optional[int] = None,
                   build_blocks: bool = False,
                   bn: int = 128,
                   pad_k: Optional[int] = None,
                   pad_k_t: Optional[int] = None,
                   transposed: bool = True) -> GASBatch:
    """One host `GASBatch` over an arbitrary node set, cut from a weighted
    in-edge CSR (`weighted_in_csr`), with the reference's index
    conventions and per-destination edge order. Pads default to the next
    power of two of the needed size; explicit pads raise on overflow.
    `build_blocks=True` also tiles the local [max_b, max_b+max_h+1]
    adjacency into the forward and transposed BCSR families;
    `pad_k`/`pad_k_t` are monotone floors on their block counts.
    `transposed=False` leaves the transposed family (the operand of a
    backward pass) out, as forward-only serving does."""
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

    fwd = tr = None
    if build_blocks:
        e = _emit_part_blocks(ed, es, ew, max_b, max_h, bn, transposed)
        fwd = _pad_blocks(e["v"], e["c"], pad_k, bn)
        if transposed:
            tr = _pad_blocks(e["vt"], e["ct"], pad_k_t, bn)
    return GASBatch(bnode, bmask, hn, hm, ed, es, ew, forward=fwd,
                    transposed=tr, max_b=max_b, max_h=max_h, max_e=max_e,
                    bn=bn)


def staleness_diags(age: torch.Tensor, halo_nodes: torch.Tensor,
                    halo_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mean/max history age of the halo rows this batch pulls."""
    idx = halo_nodes.long().clamp(0, age.shape[0] - 1)
    hage = age[idx].to(torch.float32)
    valid = halo_mask.to(torch.float32)
    n = torch.clamp(valid.sum(), min=1.0)
    return {"halo_age_mean": (hage * valid).sum() / n,
            "halo_age_max": (hage * valid).max()}


def materialize_x_all(ell: int, x_cur: torch.Tensor, xh: torch.Tensor,
                      store, batch: GASBatch) -> torch.Tensor:
    """Unfused layer input `x_all = [x_cur ; halo_rows ; dummy-zero row]`:
    layer 0 uses the exact halo rows `xh`; layers >= 1 pull the previous
    layer's history rows."""
    if ell == 0:
        halo_rows = xh
    else:
        halo_rows = store.pull(ell - 1, batch.halo_nodes)
        halo_rows = halo_rows * batch.halo_mask[:, None]
    dummy = torch.zeros((1, x_cur.shape[-1]), dtype=x_cur.dtype,
                        device=x_cur.device)
    return torch.cat([x_cur, halo_rows, dummy], dim=0)
