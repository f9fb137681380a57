"""GAS for sequences: train a causal LM on sequences longer than the chunk
the device ever holds activations for (the paper's historical-embedding
scheme applied along the sequence axis, `core/seq_gas.py`).

The counterpart of `examples/seq_gas_long_context.py`: qwen3-0.6b's SMOKE
config, 2 sequences of 1,024 MarkovTokens in 8 chunks of 128, AdamW at lr
1e-3; then the check that the chunked forward equals the full one in f32
(causal chunking has zero staleness).

    python -m repro_torch.examples.seq_gas_long_context [--steps 40]
        [--seq-len 1024] [--chunk 128] [--device cuda|cpu]

`--device` defaults to cuda and raises without a card.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.seq_gas import chunked_loss, forward_chunked
from repro_torch.data.tokens import MarkovTokens
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         grad_leaves, tree_map)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def train(cfg, params, *, batch, seq_len, chunk, steps, lr=1e-3, seed=0,
          log_every=10):
    """`steps` AdamW steps of `chunked_loss` on MarkovTokens (the
    reference example's stream: 32 effective tokens, concentration 0.08),
    updating `params` in place. Returns (the losses, each step's ms on
    the host clock to a sync, the last batch)."""
    dev = params["lm_head"].device
    opt = adamw_init(params)
    it = MarkovTokens(cfg.vocab_size, effective=32, concentration=0.08,
                      seed=seed).batches(batch, seq_len)
    losses, ms = [], []
    for i in range(1, steps + 1):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        t0 = time.perf_counter()
        tree, leaves = grad_leaves(params)
        loss, _ = chunked_loss(tree, cfg, b, chunk)
        grads = torch.autograd.grad(loss, leaves)
        _, opt = adamw_update(list(grads), opt, params, lr=lr)
        loss = float(loss.detach())
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if log_every and i % log_every == 0:
            print(f"step {i:3d}  ce {loss:.4f}  "
                  f"({batch * seq_len * i / (sum(ms) / 1e3):,.0f} tok/s)")
    return losses, ms, b


@torch.no_grad()
def chunked_vs_full(cfg, params, batch, chunk) -> float:
    """max |chunked logits - full logits| in f32 (the params cast)."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda a: a.to(torch.float32), params)
    full, _ = tf.forward(p32, cfg32, batch)
    chunked, _ = forward_chunked(p32, cfg32, batch, chunk)
    return float((full - chunked).abs().max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config("qwen3-0.6b", "smoke")
    B, T, C = 2, args.seq_len, args.chunk
    params = tf.init_params(cfg, seed=0, device=args.device)

    # the device's activation working set: a chunk against the sequence
    act_chunk = B * C * cfg.d_model * 4 * cfg.num_layers
    act_full = B * T * cfg.d_model * 4 * cfg.num_layers
    hist = B * T * cfg.num_kv_heads * cfg.head_dim_ * 2 * 4 * cfg.num_layers
    print(f"activations/layer-stack: chunked {act_chunk / 1e6:.1f}MB vs "
          f"full {act_full / 1e6:.1f}MB ({act_full / act_chunk:.0f}x); "
          f"K/V history (offloadable, the paper's H-bar): "
          f"{hist / 1e6:.1f}MB")
    losses, _, batch = train(cfg, params, batch=B, seq_len=T, chunk=C,
                             steps=args.steps)
    err = chunked_vs_full(cfg, params, batch, C)
    print("max |chunked - full| =", err,
          "(causal chunking is exact; staleness only arises for encoders)")
    return losses, err


if __name__ == "__main__":
    main()
