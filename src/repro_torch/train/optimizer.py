"""AdamW, SGD, global-norm clipping and the cosine schedule, written out
as the reference writes them.

The port of `repro.train.optimizer`'s `adamw_init`, `adamw_update`,
`clip_by_global_norm`, `cosine_schedule` and `sgd_update` over the
port's param trees (dicts and lists of tensors). Plain tensor code, not
`torch.optim.AdamW`, which orders its rounding differently: each update
is the reference's expression, step by step, in float32. The reference
returns new params and moments (XLA reuses the donated buffers); here
`adamw_update` overwrites the params, both moments and the step count in
place and returns them, so that a training step captured in a CUDA graph
(`core.runtime`'s fused epoch) reads and writes the same tensors at
every replay.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Tuple, Union

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor           # () int32
    m: Any
    v: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params tree in the reference's flattening order
    (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def grad_leaves(params) -> Tuple[Any, List[torch.Tensor]]:
    """(tree, leaves): a copy of the params tree whose leaves are detached
    views that require grad, and those leaves in `tree_leaves` order, for
    `torch.autograd.grad`. The views share storage with `params`, which
    the in-place update then overwrites."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        if isinstance(tree, list):
            return [build(v) for v in tree]
        return next(it)

    return build(params), leaves


def adamw_init(params) -> AdamWState:
    dev = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Any, AdamWState]:
    """One AdamW step, in place on `params`, the moments and the step
    count. `grads` is a list in `tree_leaves(params)` order or a tree
    shaped like `params`."""
    step = state.step.add_(1)
    stepf = step.to(torch.float32)
    # the bias corrections in f32, as the reference computes
    # `b1 ** step.astype(f32)` with a weakly typed python float (filled on
    # the device: no host copy, which a CUDA graph's capture refuses)
    bc1 = 1 - torch.pow(torch.full((), b1, dtype=torch.float32,
                                   device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.full((), b2, dtype=torch.float32,
                                   device=stepf.device), stepf)
    flat_g = grads if isinstance(grads, list) else tree_leaves(grads)
    for g, m, v, p in zip(flat_g, tree_leaves(state.m), tree_leaves(state.v),
                          tree_leaves(params)):
        g = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + \
            weight_decay * p.to(torch.float32)
        p.sub_(lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v)


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale the gradient list so its global L2 norm is at most
    `max_norm`; returns (clipped, norm). The squares are summed leaf by
    leaf in order, as the reference's Python `sum` does, in float64, and
    the norm is rounded to float32 once: the card and the CPU, which sum
    a leaf in other orders, then agree on the norm to the last bit (in
    float32 they differ by ulps, and the clipped gradients and the AdamW
    moments with them)."""
    gn = torch.zeros((), dtype=torch.float64, device=grads[0].device)
    for g in grads:
        gn = gn + torch.sum(torch.square(g.to(torch.float64)))
    gn = torch.sqrt(gn).to(torch.float32)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return [g * scale.to(g.dtype) for g in grads], gn


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """lr(step): linear warm-up to `base_lr` over `warmup` steps, then a
    half cosine down to 0 at `total`. `step` is an int or a 0-d tensor;
    the result is a 0-d float32 tensor on the step's device, computed in
    float32 as the reference computes it after `step.astype(f32)` (its
    Python constants rounded to f32 first, as JAX's weak types are)."""
    def lr(step: Union[int, torch.Tensor]) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                     device=step.device)
        warm = f32(base_lr) * step / f32(max(warmup, 1))
        frac = torch.clamp((step - f32(warmup)) / f32(max(total - warmup, 1)),
                           0.0, 1.0)
        cos = f32(base_lr * 0.5) * (f32(1.0) + torch.cos(f32(math.pi) * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def _map2(fn, a, b):
    """`fn` over the leaves of two trees of one structure."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


@torch.no_grad()
def sgd_update(grads, params, lr: float):
    """A new params tree, p - lr * g for each leaf, computed in float32 and
    cast back to the param's dtype. `grads` is shaped like `params`."""
    return _map2(lambda p, g: (p.to(torch.float32) - lr * g.to(torch.float32)
                               ).to(p.dtype), params, grads)
