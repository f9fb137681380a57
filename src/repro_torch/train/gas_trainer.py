"""Trainers: GAS mini-batch (the paper) and full-batch (the baseline).

The port of `repro.train.gas_trainer`. `GASTrainer` is a thin shell over
`core.runtime`: construction builds a `GASConfig` from its kwargs (the
reference's, with `device` for its `backend`), `build_plan` and an
initial `GASState`; the train / predict / evaluate methods delegate to
`runtime.train_step`, `train_epoch`, `fit`, `predict` and
`evaluate_exact` and keep `self.state` threaded; `fused_epoch=True` runs
each epoch as one unit (on the card one CUDA graph replay an epoch,
`runtime.train_epoch`).

`FullBatchTrainer`: every step runs the model on the whole graph over the
COO in plain tensor code (`gnn.model.full_forward`, no kernel), with the
same loss, clipping and AdamW as a GAS step. The reference jits the step;
the port runs it eagerly, updating params and moments in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import gas as G
from repro_torch.core import runtime as R
from repro_torch.core.config import resolve_device
from repro_torch.core.runtime import GASConfig, _accuracy, masked_cross_entropy
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


class GASTrainer:
    """Convenience shell over `core.runtime`. `tcfg` defaults to a fresh
    `TrainConfig` per instance. `device` (None means "cuda") is where the
    plan and state live; `part`, a partition computed beforehand
    (`runtime.partition(graph, config)`), is passed to `build_plan`,
    which otherwise partitions the graph itself."""

    def __init__(self, graph: Graph, spec: GNNSpec, num_parts: int,
                 partitioner: str = "metis", use_history: bool = True,
                 clusters_per_batch: int = 1, fused_epoch: bool = False,
                 device=None, fuse_halo: bool = True,
                 history_dtype: Optional[str] = None,
                 tcfg: Optional[TrainConfig] = None,
                 part: Optional[np.ndarray] = None):
        tcfg = TrainConfig() if tcfg is None else tcfg
        self.tcfg = tcfg
        config = GASConfig(
            num_parts=num_parts, partitioner=partitioner,
            clusters_per_batch=clusters_per_batch,
            use_history=use_history, fused_epoch=fused_epoch,
            fuse_halo=fuse_halo, history_dtype=history_dtype,
            lr=tcfg.lr, weight_decay=tcfg.weight_decay,
            grad_clip=tcfg.grad_clip, epochs=tcfg.epochs, seed=tcfg.seed)
        self.plan = R.build_plan(graph, spec, config, device=device,
                                 part=part)
        self.state = R.init_state(self.plan)

    # --- delegating views over plan/state --------------------------------
    @property
    def graph(self) -> Graph:
        return self.plan.graph

    @property
    def spec(self) -> GNNSpec:
        return self.plan.spec

    @property
    def config(self) -> GASConfig:
        return self.plan.config

    @property
    def device(self) -> torch.device:
        return self.plan.device

    @property
    def part(self) -> np.ndarray:
        return self.plan.part

    @property
    def batches(self):
        return self.plan.batches

    @property
    def batch_stack(self):
        return self.plan.batch_stack

    @property
    def x(self):
        return self.plan.x

    @property
    def y(self):
        return self.plan.y

    @property
    def train_mask(self):
        return self.plan.train_mask

    @property
    def params(self):
        return self.state.params

    @params.setter
    def params(self, v):
        self.state = self.state.replace(params=v)

    @property
    def opt_state(self):
        return self.state.opt_state

    @opt_state.setter
    def opt_state(self, v):
        self.state = self.state.replace(opt_state=v)

    @property
    def hist(self):
        return self.state.histories

    @hist.setter
    def hist(self, v):
        self.state = self.state.replace(histories=v)

    @property
    def rng(self):
        return self.state.rng

    # --- training / inference --------------------------------------------
    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        self.state, metrics = R.train_step(self.plan, self.state, batch)
        return metrics

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        self.state, metrics = R.train_epoch(self.plan, self.state, epoch)
        return metrics

    def fit(self, epochs: Optional[int] = None, log_every: int = 0
            ) -> List[Dict[str, float]]:
        self.state, out = R.fit(self.plan, self.state, epochs=epochs,
                                log_every=log_every)
        return out

    # exact full-propagation evaluation (paper evaluates exactly)
    def evaluate(self) -> Dict[str, float]:
        return R.evaluate_exact(self.plan, self.state)

    # constant-memory history-based inference (paper advantage #2)
    def gas_predict(self) -> torch.Tensor:
        return R.predict(self.plan, self.state)


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
