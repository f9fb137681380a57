"""PyTorch port, the sequence mixers and losses against the JAX package:
the RG-LRU scan and block (`models/rglru.py`), the MoE layer
(`models/moe.py`), seq-GAS's `attention_with_history` and cross
attention (`models/attention.py`), the two cross-entropy losses
(`models/common.py`), the `utils/tree` helpers and `launch/mesh.py`'s
`make_mesh` under 4 gloo ranks. The same numpy inputs and params go to
both packages.

Tolerances (f32): 1e-5 for outputs and gradients (the same f32
operations summed in another order; the RG-LRU scan combines the affine
pairs in another tree, log-step against the reference's
`associative_scan`), the MoE's aux losses at 1e-6, and the MoE's kept
(token, expert) set exactly: a capacity drop is a discrete decision."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

from repro.models import attention as r_attn
from repro.models import common as r_common
from repro.models import moe as r_moe
from repro.models import rglru as r_rg
from repro.utils import tree as r_tree
from repro.configs import base as r_base
from repro.models import transformer as r_tf

from repro_torch.configs import base as t_base
from repro_torch.core import _rank_bodies as t_rb
from repro_torch.core import dist_gas as t_dg
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import moe as t_moe
from repro_torch.models import rglru as t_rg
from repro_torch.models import transformer as t_tf
from repro_torch.train.checkpoint import transformer_params_from_numpy
from repro_torch.train.optimizer import tree_leaves
from repro_torch.utils import tree as t_tree

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _pair(tree):
    """A numpy tree as (jax tree, torch tree) of the same f32 values."""
    jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    return jt, transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jt), device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 17, 64, 100])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(T, with_h0):
    """The log-step scan against `associative_scan`, with and without an
    initial state, at lengths around powers of two."""
    rng = np.random.default_rng(T + with_h0)
    B, W = 2, 8
    a = 1 / (1 + np.exp(-rng.normal(size=(B, T, W)))).astype(np.float32)
    b = rng.normal(size=(B, T, W)).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32) if with_h0 else None
    want = r_rg.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                           None if h0 is None else jnp.asarray(h0))
    got = t_rg.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                          None if h0 is None else torch.from_numpy(h0))
    _close(got, want)


def _rglru_params(rng, D, W, Wc=4):
    p = {"in_x": rng.normal(size=(D, W)) / np.sqrt(D),
         "in_gate": rng.normal(size=(D, W)) / np.sqrt(D),
         "conv_w": rng.normal(size=(Wc, W)) * 0.3,
         "conv_b": rng.normal(size=W) * 0.1,
         "w_r": rng.normal(size=(W, W)) / np.sqrt(W),
         "w_i": rng.normal(size=(W, W)) / np.sqrt(W),
         # spread softplus(lam) * 8 over slow and fast decays; one entry
         # past softplus's linear threshold of 20 in F.softplus
         "lam": np.concatenate([rng.normal(size=W - 1), [25.0]]),
         "out": rng.normal(size=(W, D)) / np.sqrt(W)}
    return _pair({k: np.asarray(v, np.float32) for k, v in p.items()})


def test_rglru_block_forward_and_decode_match_reference():
    """The block over a sequence, then continued from its state over a
    second one, then token by token in decode: outputs and states."""
    rng = np.random.default_rng(3)
    D, W, B = 16, 24, 2
    jp, tp = _rglru_params(rng, D, W)
    x1, x2 = (rng.normal(size=(B, T, D)).astype(np.float32)
              for T in (9, 6))
    wy, wst = r_rg.rglru_block_forward(jp, jnp.asarray(x1))
    gy, gst = t_rg.rglru_block_forward(tp, torch.from_numpy(x1))
    _close(gy, wy)
    for n in ("h", "conv"):
        _close(gst[n], wst[n])
    wy2, wst2 = r_rg.rglru_block_forward(jp, jnp.asarray(x2), wst)
    gy2, gst2 = t_rg.rglru_block_forward(tp, torch.from_numpy(x2), gst)
    _close(gy2, wy2)
    assert gst2["h"].dtype == torch.float32
    for t in range(x2.shape[1]):
        wy, wst = r_rg.rglru_block_decode(jp, jnp.asarray(x2[:, t:t + 1]),
                                          wst)
        gy, gst = t_rg.rglru_block_decode(tp, torch.from_numpy(
            x2[:, t:t + 1]), gst)
        _close(gy, wy)
        _close(gy, gy2[:, t:t + 1])
        for n in ("h", "conv"):
            _close(gst[n], wst[n])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_params(rng, D, F, E, marker=False):
    if not marker:
        p = {"router": rng.normal(size=(D, E)) / np.sqrt(D),
             "w_gate": rng.normal(size=(E, D, F)) / np.sqrt(D),
             "w_up": rng.normal(size=(E, D, F)) / np.sqrt(D),
             "w_down": rng.normal(size=(E, F, D)) / np.sqrt(F)}
    else:
        # every expert's output marks it: feature D - 1 of x is 1, so
        # silu(4) * 1 in every hidden unit, and expert e writes column e
        # only; out[t, e] is then token t's combine weight for e, nonzero
        # exactly where the choice was kept. Expert 0 is favoured, so
        # capacity drops happen
        p = {"router": rng.normal(size=(D, E)) / np.sqrt(D),
             "w_gate": np.zeros((E, D, F)), "w_up": np.zeros((E, D, F)),
             "w_down": np.zeros((E, F, D))}
        p["router"][D - 1, 0] += 2.0
        p["w_gate"][:, D - 1] = 4.0
        p["w_up"][:, D - 1] = 1.0
        for e in range(E):
            p["w_down"][e, :, e] = 1.0 / F
    return _pair({k: np.asarray(v, np.float32) for k, v in p.items()})


@pytest.mark.parametrize("cf,group", [(1.25, 512), (1.0, 32), (1.0, 16),
                                      (8.0, 64)])
def test_moe_forward_matches_reference(cf, group):
    rng = np.random.default_rng(int(cf * 10) + group)
    D, F, E, K = 16, 32, 4, 2
    x = rng.normal(size=(2, 32, D)).astype(np.float32)
    kw = dict(num_experts=E, top_k=K, capacity_factor=cf, group_size=group)
    jp, tp = _moe_params(rng, D, F, E)
    want, waux = r_moe.moe_forward(jp, jnp.asarray(x), **kw)
    got, gaux = t_moe.moe_forward(tp, torch.from_numpy(x), **kw)
    _close(got, want)
    for n in ("load_balance_loss", "z_loss"):
        _close(gaux[n], waux[n], dict(rtol=1e-6, atol=1e-6))

    # the kept (token, expert) set, exactly
    x[..., D - 1] = 1.0
    jp, tp = _moe_params(rng, D, F, E, marker=True)
    want, _ = r_moe.moe_forward(jp, jnp.asarray(x), **kw)
    got, _ = t_moe.moe_forward(tp, torch.from_numpy(x), **kw)
    wkeep = np.asarray(want)[..., :E] > 0
    np.testing.assert_array_equal(_np(got)[..., :E] > 0, wkeep)
    _close(got, want)
    C = t_moe.moe_capacity(min(group, 64), E, K, cf)
    assert C == r_moe.moe_capacity(min(group, 64), E, K, cf)
    if cf == 1.0:
        assert wkeep.sum() < x.shape[0] * x.shape[1] * K, "nothing dropped"


# ---------------------------------------------------------------------------
# attention: seq-GAS history and cross attention
# ---------------------------------------------------------------------------

def _attn_params(rng, D, H, Kh, Dh):
    p = {"wq": rng.normal(size=(D, H * Dh)) / np.sqrt(D),
         "wk": rng.normal(size=(D, Kh * Dh)) / np.sqrt(D),
         "wv": rng.normal(size=(D, Kh * Dh)) / np.sqrt(D),
         "wo": rng.normal(size=(H * Dh, D)) / np.sqrt(H * Dh),
         "bq": rng.normal(size=H * Dh) * 0.1,
         "bk": rng.normal(size=Kh * Dh) * 0.1,
         "bv": rng.normal(size=Kh * Dh) * 0.1,
         "q_norm": {"scale": 1 + 0.1 * rng.normal(size=Dh)},
         "k_norm": {"scale": 1 + 0.1 * rng.normal(size=Dh)}}
    return _pair(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                        p))


@pytest.mark.parametrize("case", ["no_history", "past", "past_window",
                                  "past_and_future"])
def test_attention_with_history_matches_reference(case):
    """A 16-token chunk at positions 32-47 over pulled K/V: none, the 32
    past positions (causal; with a window of 12), or the past and 16
    future ones (bidirectional, as hubert's passes)."""
    rng = np.random.default_rng(len(case))
    B, D, H, Kh, Dh, C = 2, 32, 4, 2, 16, 16
    jp, tp = _attn_params(rng, D, H, Kh, Dh)
    x = rng.normal(size=(B, C, D)).astype(np.float32)
    pos = np.arange(32, 48, dtype=np.int32)
    hp = {"no_history": None, "past": np.arange(32),
          "past_window": np.arange(32),
          "past_and_future": np.concatenate([np.arange(32),
                                             np.arange(48, 64)])}[case]
    hk = hv = None
    if hp is not None:
        hp = hp.astype(np.int32)
        hk, hv = (rng.normal(size=(B, len(hp), Kh, Dh)).astype(np.float32)
                  for _ in range(2))
    kw = dict(num_heads=H, num_kv_heads=Kh, head_dim=Dh, rope_theta=1e4,
              window=12 if case == "past_window" else 0,
              causal=case != "past_and_future")

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    want = r_attn.attention_with_history(
        jp, jnp.asarray(x), positions=jnp.asarray(pos), hist_k=j(hk),
        hist_v=j(hv), hist_positions=j(hp), **kw)
    got = t_attn.attention_with_history(
        tp, torch.from_numpy(x), positions=torch.from_numpy(pos),
        hist_k=t(hk), hist_v=t(hv), hist_positions=t(hp), **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_cross_attention_matches_reference():
    """Cross attention over 5 image tokens: the full-sequence form (no
    RoPE, no causal mask; its cache the image K/V) and a decode step over
    that cache (every slot valid, the cache untouched)."""
    rng = np.random.default_rng(11)
    B, D, H, Kh, Dh, T, n = 2, 32, 4, 2, 16, 7, 5
    jp, tp = _attn_params(rng, D, H, Kh, Dh)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    img = rng.normal(size=(B, n, D)).astype(np.float32)
    kw = dict(num_heads=H, num_kv_heads=Kh, head_dim=Dh, rope_theta=1e4)
    want, wc = r_attn.attention_forward(
        jp, jnp.asarray(x), positions=jnp.arange(T, dtype=jnp.int32),
        kv_x=jnp.asarray(img), kv_positions=jnp.arange(n, dtype=jnp.int32),
        causal=False, **kw)
    got, gc = t_attn.attention_forward(
        tp, torch.from_numpy(x), positions=torch.arange(T, dtype=torch.int32),
        kv_x=torch.from_numpy(img),
        kv_positions=torch.arange(n, dtype=torch.int32), causal=False, **kw)
    _close(got, want)
    for name in ("k", "v"):
        _close(gc[name], wc[name])
    before = {k: v.clone() for k, v in gc.items()}
    xt = rng.normal(size=(B, 1, D)).astype(np.float32)
    want, _ = r_attn.attention_decode(jp, jnp.asarray(xt), wc,
                                      jnp.array(T, jnp.int32), cross=True,
                                      use_rope=False, **kw)
    got, gc2 = t_attn.attention_decode(tp, torch.from_numpy(xt), gc, T,
                                       cross=True, use_rope=False, **kw)
    _close(got, want)
    assert gc2 is gc and all(torch.equal(gc[k], before[k]) for k in gc)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [16, 50, 64])
def test_chunked_cross_entropy_matches_reference(masked, chunk):
    """V = 50: chunks of 16 (the last one padded with 14 masked columns),
    one whole chunk, one padded chunk; the value and both gradients (x and
    lm_head) against jax.grad."""
    rng = np.random.default_rng(chunk + masked)
    D, V = 16, 50
    x = rng.normal(size=(2, 7, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.5).astype(np.float32)
    labels = rng.integers(0, V, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.int32) if masked else None

    def r_loss(x_, w_):
        return r_common.chunked_cross_entropy(
            x_, w_, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), chunk)

    want, (wgx, wgw) = jax.value_and_grad(r_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = t_common.chunked_cross_entropy(
        tx, tw, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), chunk)
    gx, gw = torch.autograd.grad(got, (tx, tw))
    for g, wv in ((got, want), (gx, wgx), (gw, wgw)):
        _close(g, wv)
    # and the unchunked loss over the same logits agrees
    full = t_common.cross_entropy_loss(
        tx @ tw, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    _close(full, want)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_reference(masked):
    rng = np.random.default_rng(5 + masked)
    logits = (rng.normal(size=(3, 5, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.5).astype(np.int32) if masked else None
    want, wg = jax.value_and_grad(lambda z: r_common.cross_entropy_loss(
        z, jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask)))(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = t_common.cross_entropy_loss(
        tl, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    (g,) = torch.autograd.grad(got, (tl,))
    _close(got, want)
    _close(g, wg)


# ---------------------------------------------------------------------------
# utils/tree and launch/mesh
# ---------------------------------------------------------------------------

def test_tree_helpers_match_reference():
    """Over recurrentgemma's SMOKE params in bf16 (f32 leaves among them)
    and its meta-device specs: sizes, counts, casts, zeros, shapes."""
    rc = r_base.get_config("recurrentgemma-9b", "smoke")
    tc = t_base.get_config("recurrentgemma-9b", "smoke")
    rp = r_tf.init_params(jax.random.key(0), rc)
    tp = t_tf.init_params(tc, seed=0, device="cpu")
    assert t_tree.tree_size_bytes(tp) == r_tree.tree_size_bytes(rp)
    assert t_tree.tree_num_params(tp) == r_tree.tree_num_params(rp)
    spec = t_tree.tree_shape_dtype(tp)
    assert t_tree.tree_size_bytes(spec) == r_tree.tree_size_bytes(
        r_tree.tree_shape_dtype(rp))
    assert all(t.device.type == "meta" for t in tree_leaves(spec))
    cast = t_tree.tree_cast({"a": tp["lm_head"], "i": torch.arange(3)},
                            torch.float32)
    rcast = r_tree.tree_cast({"a": rp["lm_head"], "i": jnp.arange(3)},
                             jnp.float32)
    assert cast["a"].dtype == torch.float32 and cast["i"].dtype == \
        torch.int64 and rcast["i"].dtype == jnp.int32
    np.testing.assert_array_equal(cast["a"].numpy(), np.asarray(
        tp["lm_head"].float()))
    z = t_tree.tree_zeros_like(tp)
    assert [(a.shape, a.dtype) for a in tree_leaves(z)] == \
        [(a.shape, a.dtype) for a in tree_leaves(tp)]
    assert not any(bool(a.any()) for a in tree_leaves(z))


def test_mesh_constants_and_production_mesh():
    assert t_mesh.DEVICE == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert t_mesh.HBM_BW == 3.35e12 and t_mesh.PEAK_FLOPS_BF16 == 989e12
    with pytest.raises(NotImplementedError, match="A14"):
        t_mesh.make_production_mesh()


@pytest.mark.slow
def test_make_mesh_under_gloo_ranks():
    """A 2 x 2 ("data", "model") mesh over 4 spawned gloo ranks: the
    reference's layout (rank-major, as `jax.make_mesh` lays out devices),
    4 devices, each rank's coordinate, and one all-reduce over each axis's
    group summing the ranks on it."""
    out = t_dg.run_ranks(t_rb.mesh_rank, 4, (2, 2), ("data", "model"),
                         device="cpu")
    for r, o in enumerate(out):
        assert o["mesh"] == [[0, 1], [2, 3]] and o["n"] == 4
        assert o["coord"] == [r // 2, r % 2]
        assert o["sums"] == {"data": float(2 * (r % 2) + 2),
                             "model": float(4 * (r // 2) + 1)}
