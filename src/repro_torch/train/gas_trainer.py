"""The full-batch baseline of the quickstart: `FullBatchTrainer`.

The port of `repro.train.gas_trainer`'s `TrainConfig` and
`FullBatchTrainer`: every step runs the model on the whole graph over the
COO in plain tensor code (`gnn.model.full_forward`, no kernel), with the
same loss, clipping and AdamW as a GAS step. The reference jits the step;
the port runs it eagerly, updating params and moments in place.
`GASTrainer`, the reference's object shell over `core.runtime`, is not
ported yet (ROADMAP Queue A item 5): use the runtime directly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import gas as G
from repro_torch.core.config import resolve_device
from repro_torch.core.runtime import _accuracy, masked_cross_entropy
from repro_torch.data.graphs import Graph
from repro_torch.gnn.model import GNNSpec, full_forward, init_gnn
from .optimizer import (adamw_init, adamw_update, clip_by_global_norm,
                        grad_leaves)


@dataclass
class TrainConfig:
    lr: float = 0.01
    weight_decay: float = 5e-4
    grad_clip: float = 2.0
    epochs: int = 100
    seed: int = 0


class FullBatchTrainer:
    def __init__(self, graph: Graph, spec: GNNSpec,
                 tcfg: Optional[TrainConfig] = None, device=None):
        tcfg = TrainConfig() if tcfg is None else tcfg
        self.graph, self.spec, self.tcfg = graph, spec, tcfg
        dev = resolve_device(device)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
        dst, src, w = G.gcn_edge_weights(graph)
        self.edges = (t(dst), t(src))
        self.edge_w = t(w)
        self.x = t(graph.x)
        self.y = t(graph.y).long()
        self.masks = {n: t(m) for n, m in
                      (("train", graph.train_mask), ("val", graph.val_mask),
                       ("test", graph.test_mask))}
        self.params = init_gnn(spec, seed=tcfg.seed, device=dev)
        self.opt_state = adamw_init(self.params)

    def step(self) -> Dict[str, float]:
        """One full-batch AdamW step; returns its loss and accuracy."""
        params, leaves = grad_leaves(self.params)
        logits = full_forward(params, self.spec, self.x, self.edges,
                              self.edge_w, self.graph.num_nodes)
        m = self.masks["train"]
        ce = masked_cross_entropy(logits, self.y, m)
        grads = list(torch.autograd.grad(ce, leaves))
        grads, _ = clip_by_global_norm(grads, self.tcfg.grad_clip)
        _, self.opt_state = adamw_update(
            grads, self.opt_state, self.params, lr=self.tcfg.lr, b1=0.9,
            b2=0.999, weight_decay=self.tcfg.weight_decay)
        return {"loss": float(ce.detach()),
                "acc": float(_accuracy(logits.detach(), self.y, m))}

    def fit(self, epochs: Optional[int] = None) -> List[Dict[str, float]]:
        return [self.step() for _ in range(epochs or self.tcfg.epochs)]

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        logits = full_forward(self.params, self.spec, self.x, self.edges,
                              self.edge_w, self.graph.num_nodes)
        return {f"{n}_acc": float(_accuracy(logits, self.y, m))
                for n, m in self.masks.items()}
