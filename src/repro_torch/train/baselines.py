"""Scalability baselines the paper compares against (Tables 3/5):

  - GraphSAGETrainer — node-wise neighbor sampling (Hamilton et al., 2017):
    recursive fixed-fanout L-hop mini-batches; drops edges, working set
    grows ~fanout^L (the neighbor-explosion regime GAS eliminates).
  - SGCTrainer — Simplifying Graph Convolution (Wu et al., 2019):
    non-trainable propagation Â^K X precomputed once, then logistic
    regression; fast but provably less expressive (no trainable MESSAGE).
  - CLUSTER-GCN is GASTrainer(use_history=False) — intra-cluster edges only.

The port of `repro.train.baselines`. The host sampler is the reference's
numpy, line for line: from `np.random.default_rng(seed)` it draws the
same shuffles and neighbor choices, so every sampled batch is bitwise
the reference's. Both baselines aggregate over a COO in plain tensor
code (`kernels.ref.segment_sum`, the same bits on every run), as the
reference does with `jax.ops.segment_sum` outside any kernel. Initial weights are the reference's distribution
(Glorot) drawn from a `torch.Generator` seeded with `tcfg.seed`, not its
bits. The reference jits the step; the port runs it eagerly, updating
params and moments in place. Entry points run on the card unless the
caller passes `device="cpu"`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.config import resolve_device
from repro_torch.core.gas import gcn_edge_weights
from repro_torch.core.runtime import _accuracy, masked_cross_entropy
from repro_torch.data.graphs import Graph
from repro_torch.gnn import layers as L
from repro_torch.gnn.model import to_device
from repro_torch.kernels.ref import segment_sum
from .gas_trainer import TrainConfig
from .optimizer import (adamw_init, adamw_update, clip_by_global_norm,
                        grad_leaves)


def _masks(graph: Graph, device) -> Dict[str, torch.Tensor]:
    return {n: torch.from_numpy(np.asarray(m)).to(device)
            for n, m in (("train", graph.train_mask), ("val", graph.val_mask),
                         ("test", graph.test_mask))}


# ---------------------------------------------------------------------------
# GraphSAGE: recursive neighbor sampling
# ---------------------------------------------------------------------------

class GraphSAGETrainer:
    """GCN-mean aggregation over sampled fixed-fanout neighborhoods.

    Batches are padded to static shapes: layer ℓ has at most
    batch_size * prod(fanouts[:ℓ]) rows — the exponential working set the
    paper's Table 4/Figure 1b describes."""

    def __init__(self, graph: Graph, d_hidden: int, num_layers: int = 2,
                 fanout: int = 10, batch_size: int = 256,
                 tcfg: Optional[TrainConfig] = None, device=None):
        tcfg = TrainConfig() if tcfg is None else tcfg
        self.g, self.tcfg = graph, tcfg
        self.L, self.fanout, self.bs = num_layers, fanout, batch_size
        self.device = dev = resolve_device(device)
        self.rng = np.random.default_rng(tcfg.seed)

        gen = torch.Generator().manual_seed(tcfg.seed)
        dims = [graph.x.shape[1]] + [d_hidden] * (num_layers - 1) + \
            [graph.num_classes]
        self.params = to_device(
            {"layers": [L.init_gcn(gen, dims[i], dims[i + 1])
                        for i in range(num_layers)]}, dev)
        self.opt_state = adamw_init(self.params)
        self.train_nodes = np.flatnonzero(graph.train_mask)
        # static per-layer frontier caps: bs * (fanout+1)^ell
        self.caps = [batch_size * (fanout + 1) ** ell
                     for ell in range(num_layers + 1)]
        self._x = torch.from_numpy(np.concatenate(
            [graph.x, np.zeros((1, graph.x.shape[1]), np.float32)])).to(dev)
        self._y = torch.from_numpy(graph.y).to(dev).long()

    # -- host-side sampling --------------------------------------------------
    def _sample_batch(self, seeds: np.ndarray):
        """Returns per-layer padded (dst_local, src_local, w) with STATIC
        shapes (frontier padded to bs*(fanout+1)^ell) plus the padded global
        ids feeding the innermost layer (-1 = padding row)."""
        g = self.g
        layers = []
        frontier = np.full(self.caps[0], -1, np.int64)
        frontier[:len(seeds)] = seeds
        for ell in range(self.L):
            n_out = self.caps[ell]
            max_e = n_out * (self.fanout + 1)
            dst = np.full(max_e, n_out, np.int32)          # trash row
            src_g = np.full(max_e, -1, np.int64)
            w = np.zeros(max_e, np.float32)
            nxt: List[int] = [int(v) for v in frontier if v >= 0]
            index = {int(v): i for i, v in enumerate(frontier) if v >= 0}
            e = 0
            for i, v in enumerate(frontier):
                if v < 0:
                    continue
                nbrs = g.indices[g.indptr[v]:g.indptr[v + 1]]
                if len(nbrs) > self.fanout:
                    nbrs = self.rng.choice(nbrs, self.fanout, replace=False)
                deg = max(len(nbrs), 1)
                # self loop + sampled neighbors (mean aggregation)
                for u in np.concatenate([[v], nbrs]):
                    dst[e] = i
                    src_g[e] = u
                    w[e] = 1.0 / (deg + 1)
                    e += 1
                    if int(u) not in index:
                        index[int(u)] = len(nxt)
                        nxt.append(int(u))
            src = np.array([index[int(u)] if u >= 0 else -1
                            for u in src_g], np.int32)
            layers.append((dst, src, w))
            frontier = np.full(self.caps[ell + 1], -1, np.int64)
            frontier[:len(nxt)] = nxt
        return layers, frontier

    def device_batch(self, seeds: np.ndarray, layers, base):
        """A sampled batch on the device: (x_rows, layer_data, labels,
        lmask), the step's inputs, as the reference's `fit` builds them."""
        dev = self.device
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
        x_rows = self._x[t(np.where(base >= 0, base, self.g.num_nodes))]
        layer_data = [(t(d), t(s), t(w)) for d, s, w in layers]
        seeds_pad = np.zeros(self.caps[0], np.int64)
        seeds_pad[:len(seeds)] = seeds
        lmask = t((np.arange(self.caps[0]) < len(seeds)).astype(np.float32))
        return x_rows, layer_data, self._y[t(seeds_pad)], lmask

    def grads_and_metrics(self, x_rows, layer_data, labels, lmask
                          ) -> Tuple[List[torch.Tensor], Dict[str, float]]:
        """The step's forward and backward on a device batch: the
        gradients (unclipped, in `tree_leaves(params)` order) and the loss
        and accuracy over the batch's seeds."""
        params, leaves = grad_leaves(self.params)
        h = x_rows
        for ell in reversed(range(self.L)):
            dst, src, w = layer_data[ell]
            n_out = self.caps[ell]
            h_all = torch.cat([h, h.new_zeros((1, h.shape[-1]))])
            src_safe = torch.where(src >= 0, src, h.shape[0])
            h = L.gcn(params["layers"][self.L - 1 - ell], h_all,
                      (dst, src_safe), w, n_out)
            if ell != 0:
                h = torch.relu(h)
        ce = masked_cross_entropy(h, labels, lmask)
        grads = list(torch.autograd.grad(ce, leaves))
        return grads, {"loss": float(ce.detach()),
                       "acc": float(_accuracy(h.detach(), labels, lmask > 0))}

    def apply_update(self, grads: List[torch.Tensor]) -> None:
        """Global-norm clipping, then AdamW (b2 = 0.999), in place."""
        grads, _ = clip_by_global_norm(grads, self.tcfg.grad_clip)
        _, self.opt_state = adamw_update(
            grads, self.opt_state, self.params, lr=self.tcfg.lr, b1=0.9,
            b2=0.999, weight_decay=self.tcfg.weight_decay)

    def train_step(self, x_rows, layer_data, labels, lmask
                   ) -> Dict[str, float]:
        """One clipped AdamW step on a device batch; its loss and
        accuracy."""
        grads, metrics = self.grads_and_metrics(x_rows, layer_data, labels,
                                                lmask)
        self.apply_update(grads)
        return metrics

    def fit(self, epochs: Optional[int] = None) -> List[Dict[str, float]]:
        out = []
        for _ in range(epochs or self.tcfg.epochs):
            self.rng.shuffle(self.train_nodes)
            for lo in range(0, len(self.train_nodes), self.bs):
                seeds = self.train_nodes[lo: lo + self.bs]
                layers, base = self._sample_batch(seeds)
                out.append(self.train_step(
                    *self.device_batch(seeds, layers, base)))
        return out

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Exact full-graph inference (no sampling at test time)."""
        dev = self.device
        dst, src, w = (torch.from_numpy(a).to(dev)
                       for a in gcn_edge_weights(self.g))
        h = self._x[:self.g.num_nodes]
        for ell in range(self.L):
            h_all = torch.cat([h, h.new_zeros((1, h.shape[-1]))])
            h = L.gcn(self.params["layers"][ell], h_all, (dst, src), w,
                      self.g.num_nodes)
            if ell != self.L - 1:
                h = torch.relu(h)
        y = self._y
        return {f"{n}_acc": float(_accuracy(h, y, m))
                for n, m in _masks(self.g, dev).items()}


# ---------------------------------------------------------------------------
# SGC: non-trainable propagation + linear head
# ---------------------------------------------------------------------------

class SGCTrainer:
    def __init__(self, graph: Graph, k: int = 2,
                 tcfg: Optional[TrainConfig] = None, device=None):
        tcfg = TrainConfig() if tcfg is None else tcfg
        self.g, self.tcfg = graph, tcfg
        self.device = dev = resolve_device(device)
        dst, src, w = (torch.from_numpy(a).to(dev)
                       for a in gcn_edge_weights(graph))
        x = torch.from_numpy(graph.x).to(dev)
        for _ in range(k):   # Â^k X precomputed once (decoupled propagation)
            msg = x[src.long()] * w[:, None]
            x = segment_sum(dst.long(), msg, x.shape[0])
        self.features = x
        gen = torch.Generator().manual_seed(tcfg.seed)
        self.params = to_device(
            {"w": L._glorot(gen, (graph.x.shape[1], graph.num_classes)),
             "b": torch.zeros((graph.num_classes,), dtype=torch.float32)},
            dev)
        self.opt_state = adamw_init(self.params)
        self._y = torch.from_numpy(graph.y).to(dev).long()
        self._m = torch.from_numpy(np.asarray(graph.train_mask)).to(dev)

    def grads_and_metrics(self) -> Tuple[List[torch.Tensor],
                                          Dict[str, float]]:
        """The gradients of the training loss (in `tree_leaves(params)`
        order: b, w) and the loss."""
        params, leaves = grad_leaves(self.params)
        logits = self.features @ params["w"] + params["b"]
        loss = masked_cross_entropy(logits, self._y, self._m)
        return (list(torch.autograd.grad(loss, leaves)),
                {"loss": float(loss.detach())})

    def apply_update(self, grads: List[torch.Tensor]) -> None:
        """AdamW at the reference's defaults (b2 = 0.95), no clip, in
        place."""
        _, self.opt_state = adamw_update(
            grads, self.opt_state, self.params, lr=self.tcfg.lr,
            weight_decay=self.tcfg.weight_decay)

    def train_step(self) -> Dict[str, float]:
        """One step; its loss."""
        grads, metrics = self.grads_and_metrics()
        self.apply_update(grads)
        return metrics

    def fit(self, epochs: Optional[int] = None) -> List[Dict[str, float]]:
        return [self.train_step() for _ in range(epochs or self.tcfg.epochs)]

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        logits = self.features @ self.params["w"] + self.params["b"]
        return {f"{n}_acc": float(_accuracy(logits, self._y, m))
                for n, m in _masks(self.g, self.device).items()}
