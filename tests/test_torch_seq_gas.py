"""PyTorch port, seq-GAS training (`core/seq_gas.py`) against the JAX
package at SMOKE widths in f32, from the reference's `init_params`
carried across: `forward_chunked`'s logits and pushed K/V, each of
hubert's bidirectional passes, `chunked_loss` and its gradients against
jax.grad, and three AdamW steps against the reference's trajectory. Then
the reference test's three properties (tests/test_seq_gas.py) on the
port alone.

Tolerances: logits and histories 1e-5 and the loss 1e-5 (the same f32
operations summed in another order), gradients 1e-4 (they sum over every
chunk's backward, with remat on both sides), the params after 3 AdamW
steps 1e-4 (a step moves each param by ~lr, so 1e-4 absolute holds the
update to ~10% of a step)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

from repro.configs import base as r_base
from repro.core import seq_gas as r_sg
from repro.models import transformer as r_tf
from repro.train import optimizer as r_opt

from repro_torch.configs import base as t_base
from repro_torch.core import seq_gas as t_sg
from repro_torch.models import transformer as t_tf
from repro_torch.train import optimizer as t_opt
from repro_torch.train.checkpoint import transformer_params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _configs(arch, **over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(r_base.get_config(arch, "smoke"), **over),
            dataclasses.replace(t_base.get_config(arch, "smoke"), **over))


def _params(rc, seed):
    rp = r_tf.init_params(jax.random.key(seed), rc)
    return rp, transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rp), device="cpu")


def _tokens(rc, B, T, seed, high=None):
    toks = np.random.default_rng(seed).integers(
        0, high or rc.vocab_size, (B, T)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)})


@pytest.mark.parametrize("chunk", [32, 48])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen3-0.6b",
                                  "qwen2-72b"])
def test_forward_chunked_matches_reference(arch, chunk):
    rc, tc = _configs(arch)
    rp, tp = _params(rc, 0)
    rb, tb = _tokens(rc, 2, 96, 1)
    want, whist = r_sg.forward_chunked(rp, rc, rb, chunk_len=chunk)
    with torch.no_grad():
        got, ghist = t_sg.forward_chunked(tp, tc, tb, chunk_len=chunk)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert len(ghist) == len(whist) == rc.num_layers
    for g, w in zip(ghist, whist):
        for n in ("k", "v"):
            assert g[n].shape == w[n].shape
            np.testing.assert_allclose(_np(g[n]), _np(w[n]), **TOL)


def test_bidirectional_passes_match_reference():
    """hubert: each of num_layers + 1 passes, every pass reading its own
    package's previous history; logits and pushed K/V."""
    rc, tc = _configs("hubert-xlarge")
    rp, tp = _params(rc, 2)
    frames = np.random.default_rng(3).normal(
        size=(2, 96, rc.d_model)).astype(np.float32)
    rhist = thist = None
    for _ in range(rc.num_layers + 1):
        want, rhist = r_sg.forward_chunked(rp, rc, {"frames": jnp.asarray(
            frames)}, 32, history=rhist, bidirectional=True)
        with torch.no_grad():
            got, thist = t_sg.forward_chunked(tp, tc, {"frames":
                                              torch.from_numpy(frames)}, 32,
                                              history=thist,
                                              bidirectional=True)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        for g, w in zip(thist, rhist):
            for n in ("k", "v"):
                np.testing.assert_allclose(_np(g[n]), _np(w[n]), **TOL)


def _grads_pair(rc, tc, rp, tp, rb, tb, chunk, **kw):
    (want, _), wg = jax.value_and_grad(
        lambda p: r_sg.chunked_loss(p, rc, rb, chunk, **kw),
        has_aux=True)(rp)
    tree, leaves = t_opt.grad_leaves(tp)
    got, _ = t_sg.chunked_loss(tree, tc, tb, chunk, **kw)
    grads = torch.autograd.grad(got, leaves)
    return want, got, jax.tree_util.tree_leaves(wg), grads


@pytest.mark.parametrize("arch,masked", [("qwen3-0.6b", False),
                                         ("qwen3-0.6b", True),
                                         ("stablelm-1.6b", False)])
def test_chunked_loss_and_gradients_match_reference(arch, masked):
    """With remat on (the configs' default: each chunk under
    torch.utils.checkpoint), the loss and every param's gradient."""
    rc, tc = _configs(arch)
    assert tc.remat
    rp, tp = _params(rc, 4)
    rb, tb = _tokens(rc, 2, 64, 5)
    if masked:
        mask = (np.random.default_rng(6).random((2, 64)) < 0.7).astype(
            np.int32)
        rb["mask"], tb["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    want, got, wg, gg = _grads_pair(rc, tc, rp, tp, rb, tb, 32)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert len(wg) == len(gg)
    for w, g in zip(wg, gg):
        np.testing.assert_allclose(_np(g), _np(w), **GRAD_TOL)


def test_adamw_steps_match_reference():
    """Three AdamW steps (lr 1e-3) of chunked_loss from the same params:
    the losses along the way and the params after."""
    rc, tc = _configs("qwen3-0.6b")
    rp, tp = _params(rc, 7)
    rb, tb = _tokens(rc, 2, 64, 8, high=16)
    ropt, topt = r_opt.adamw_init(rp), t_opt.adamw_init(tp)

    @jax.jit
    def r_step(params, opt):
        (loss, _), g = jax.value_and_grad(
            lambda p: r_sg.chunked_loss(p, rc, rb, 32), has_aux=True)(params)
        params, opt = r_opt.adamw_update(g, opt, params, lr=1e-3)
        return params, opt, loss

    for _ in range(3):
        rp, ropt, rloss = r_step(rp, ropt)
        tree, leaves = t_opt.grad_leaves(tp)
        tloss, _ = t_sg.chunked_loss(tree, tc, tb, 32)
        grads = torch.autograd.grad(tloss, leaves)
        _, topt = t_opt.adamw_update(list(grads), topt, tp, lr=1e-3)
        np.testing.assert_allclose(_np(tloss), _np(rloss), **GRAD_TOL)
    for w, g in zip(jax.tree_util.tree_leaves(rp), t_opt.tree_leaves(tp)):
        np.testing.assert_allclose(_np(g), _np(w), **GRAD_TOL)


# ---------------------------------------------------------------------------
# the reference test's properties, on the port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen3-0.6b",
                                  "qwen2-72b"])
def test_port_causal_chunked_equals_full(arch):
    """Left-to-right chunking has zero staleness for causal models: the
    chunked forward equals the full forward."""
    _, tc = _configs(arch)
    tp = t_tf.init_params(tc, seed=0, device="cpu")
    toks = torch.randint(0, tc.vocab_size, (2, 96),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        full, _ = t_tf.forward(tp, tc, batch)
        for chunk in (32, 48):
            chunked, hist = t_sg.forward_chunked(tp, tc, batch, chunk)
            np.testing.assert_allclose(_np(chunked), _np(full), rtol=2e-4,
                                       atol=2e-4)
    assert hist[0]["k"].shape[1] == 96     # the full history pushed


def test_port_bidirectional_staleness_decays():
    """hubert: future chunks from the last pass's history; the error
    against the full bidirectional forward decays to zero within
    num_layers + 1 passes with frozen params (Theorem 2 on sequences)."""
    _, tc = _configs("hubert-xlarge")
    tp = t_tf.init_params(tc, seed=2, device="cpu")
    frames = torch.randn((2, 96, tc.d_model),
                         generator=torch.Generator().manual_seed(3))
    batch = {"frames": frames}
    errs, hist = [], None
    with torch.no_grad():
        full, _ = t_tf.forward(tp, tc, batch)
        for _ in range(tc.num_layers + 1):
            logits, hist = t_sg.forward_chunked(tp, tc, batch, 32,
                                                history=hist,
                                                bidirectional=True)
            errs.append(float((logits - full).abs().max()))
    assert errs[0] > 1e-2                  # the first pass is approximate
    assert errs[-1] < 1e-4, errs           # flushed to exact
    assert errs[0] > errs[1] > errs[-1] - 1e-9


def test_port_chunked_training_learns():
    _, tc = _configs("qwen3-0.6b")
    tp = t_tf.init_params(tc, seed=4, device="cpu")
    state = t_opt.adamw_init(tp)
    toks = torch.randint(0, 16, (4, 64),
                         generator=torch.Generator().manual_seed(5))
    batch = {"tokens": toks, "labels": toks}
    losses = []
    for _ in range(30):
        tree, leaves = t_opt.grad_leaves(tp)
        loss, _ = t_sg.chunked_loss(tree, tc, batch, 32)
        _, state = t_opt.adamw_update(list(torch.autograd.grad(loss, leaves)),
                                      state, tp, lr=1e-3)
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


def test_seq_gas_rejects_recurrent_stacks():
    _, tc = _configs("recurrentgemma-9b")
    tp = t_tf.init_params(tc, seed=0, device="cpu")
    with pytest.raises(AssertionError, match="attention stacks"):
        t_sg.forward_chunked(tp, tc, {"tokens": torch.zeros(
            (1, 32), dtype=torch.int32)}, 16)
