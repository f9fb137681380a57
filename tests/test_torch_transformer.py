"""PyTorch port, transformer serving: configs, the building blocks, the
attention layers and the model's entry points (`forward`, `prefill`,
`decode_step`) against the JAX package, on the same numpy inputs and with
the reference's params carried across (`transformer_params_from_numpy`).

Tolerances. f32: the building blocks and attention at 1e-5, the whole
model at 1e-4 (the same f32 operations, summed in another order by the
two frameworks' matmuls; observed ~1e-6). `rope_freqs` bitwise, and
`apply_rope` at 1e-6 (the two libraries' cos and sin differ by one ulp on
a few angles up to 32,767 rad). bf16 at rtol = atol = 3e-2: bf16 steps
by 2^-8 relative, the frameworks round at other places (matmul outputs,
the casts around the f32 norms), and the decode path differs from the
reference's on purpose: the reference rounds its scores to bf16 (a bf16
einsum returns bf16, `attention.py:211`) and normalizes p before
rounding it, while the port's kernel keeps the scores in f32 and divides
after `p @ v`, as the Pallas `flash_decode` does. Over the SMOKE
configs' two layers the logits (magnitude ~1) stay within ~0.012 and the
caches (up to ~4) within ~3 bf16 steps of the reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")

from repro.configs import base as r_base
from repro.data import tokens as r_tokens
from repro.models import attention as r_attn
from repro.models import common as r_common
from repro.models import transformer as r_tf

from repro_torch.configs import base as t_base
from repro_torch.data import tokens as t_tokens
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import transformer as t_tf
from repro_torch.train.checkpoint import (transformer_cache_from_numpy,
                                          transformer_params_from_numpy)

BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _np(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.detach().float().numpy()


def _to_torch(tree):
    return transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _configs(arch, variant="smoke", **over):
    return (dataclasses.replace(r_base.get_config(arch, variant), **over),
            dataclasses.replace(t_base.get_config(arch, variant), **over))


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", r_base.ARCH_IDS)
def test_configs_match_reference(arch):
    """Every id's FULL, LONG and SMOKE values, and the derived layer
    stack, cache lengths and parameter counts."""
    assert t_base.ARCH_IDS == r_base.ARCH_IDS
    assert t_base.INPUT_SHAPES == r_base.INPUT_SHAPES
    assert t_base.normalize(arch) == r_base.normalize(arch)
    for variant in ("full", "long", "smoke"):
        try:
            rc = r_base.get_config(arch, variant)
        except AttributeError:
            with pytest.raises(AttributeError):
                t_base.get_config(arch, variant)
            continue
        tc = t_base.get_config(arch, variant)
        assert dataclasses.asdict(tc) == dataclasses.asdict(rc)
        assert tc.head_dim_ == rc.head_dim_
        assert tc.segments() == rc.segments()
        assert tc.layer_types() == rc.layer_types()
        assert tc.param_counts() == rc.param_counts()
        for lt in set(rc.layer_types()):
            assert tc.decode_cache_len(6144, lt) == \
                rc.decode_cache_len(6144, lt)
        assert tc.activation_dtype == {"bfloat16": torch.bfloat16,
                                       "float32": torch.float32}[tc.dtype]


def test_markov_tokens_match_reference():
    r, t = r_tokens.MarkovTokens(512, seed=3), t_tokens.MarkovTokens(512,
                                                                     seed=3)
    np.testing.assert_array_equal(r.sample(3, 40), t.sample(3, 40))
    rb, tb = next(r.batches(2, 16)), next(t.batches(2, 16))
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(rb[key], tb[key])
    rc, tc = _configs("qwen3-0.6b")
    for a, b in zip(r_tokens.synthetic_batch(rc, 2, 8, seed=1).values(),
                    t_tokens.synthetic_batch(tc, 2, 8, seed=1).values()):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# building blocks (f32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim,theta", [(128, 1e6), (32, 1e6),
                                            (64, 1e4)])
def test_rope_freqs_bitwise(head_dim, theta):
    np.testing.assert_array_equal(
        t_common.rope_freqs(head_dim, theta).numpy(),
        np.asarray(r_common.rope_freqs(head_dim, theta)))


@pytest.mark.parametrize("block", ["rmsnorm", "layernorm", "mlp_silu",
                                   "mlp_gelu", "rope"])
def test_common_blocks_match_reference(block):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 3, 64)).astype(np.float32) * 3 + 0.5
    tx = torch.from_numpy(x)
    if block in ("rmsnorm", "layernorm"):
        p = {"scale": rng.normal(size=64).astype(np.float32),
             "bias": rng.normal(size=64).astype(np.float32)}
        if block == "rmsnorm":
            p.pop("bias")
        want = getattr(r_common, block)(p, jnp.asarray(x))
        got = getattr(t_common, block)(
            {k: torch.from_numpy(v) for k, v in p.items()}, tx)
        tol = 1e-5
    elif block.startswith("mlp"):
        act = block[4:]
        p = {"up": rng.normal(size=(64, 96)).astype(np.float32) / 8,
             "down": rng.normal(size=(96, 64)).astype(np.float32) / 10}
        if act == "silu":
            p["gate"] = rng.normal(size=(64, 96)).astype(np.float32) / 8
        want = r_common.mlp(p, jnp.asarray(x), act)
        got = t_common.mlp({k: torch.from_numpy(v) for k, v in p.items()}, tx,
                           act)
        tol = 1e-5
    else:
        # positions up to 32,767 (decode_32k's length) at qwen3's width
        x = rng.normal(size=(2, 6, 4, 128)).astype(np.float32)
        pos = np.array([0, 1, 4095, 4096, 30000, 32767], np.int32)
        want = r_common.apply_rope(jnp.asarray(x), jnp.asarray(pos)[None],
                                   1e6)
        got = t_common.apply_rope(torch.from_numpy(x),
                                  torch.from_numpy(pos)[None], 1e6)
        tol = 1e-6
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_params(rng, D, H, Kh, Dh, dtype, bias=True, qk_norm=True):
    p = {"wq": rng.normal(size=(D, H * Dh)) / np.sqrt(D),
         "wk": rng.normal(size=(D, Kh * Dh)) / np.sqrt(D),
         "wv": rng.normal(size=(D, Kh * Dh)) / np.sqrt(D),
         "wo": rng.normal(size=(H * Dh, D)) / np.sqrt(H * Dh)}
    if bias:
        p.update(bq=rng.normal(size=H * Dh) * 0.1,
                 bk=rng.normal(size=Kh * Dh) * 0.1,
                 bv=rng.normal(size=Kh * Dh) * 0.1)
    if qk_norm:
        p.update(q_norm={"scale": 1 + 0.1 * rng.normal(size=Dh)},
                 k_norm={"scale": 1 + 0.1 * rng.normal(size=Dh)})
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), p)
    return jp, _to_torch(jp)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T,q_block,window", [(40, 1024, 0), (40, 16, 0),
                                              (40, 16, 12)])
def test_attention_forward_matches_reference(dtype, T, q_block, window):
    """One block (T <= q_block) and the blockwise loop (three query
    blocks, the last one ragged), causal, with and without a window:
    the output and the roped cache."""
    rng = np.random.default_rng(T + q_block + window)
    B, D, H, Kh, Dh = 2, 64, 4, 2, 32
    jp, tp = _attn_params(rng, D, H, Kh, Dh, dtype)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    x = jnp.asarray(rng.normal(size=(B, T, D)), jdt)
    kw = dict(num_heads=H, num_kv_heads=Kh, head_dim=Dh, window=window,
              rope_theta=1e6, q_block=q_block)
    want, wc = r_attn.attention_forward(
        jp, x, positions=jnp.arange(T, dtype=jnp.int32), **kw)
    got, gc = t_attn.attention_forward(
        tp, _to_torch(x), positions=torch.arange(T, dtype=torch.int32), **kw)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else BF16_TOL
    for a, b in ((got, want), (gc["k"], wc["k"]), (gc["v"], wc["v"])):
        np.testing.assert_allclose(_np(a), _np(b), **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("Sc,pos", [(64, 20), (64, 64), (64, 150),
                                    (300, 299), (300, 0)])
def test_attention_decode_matches_reference(dtype, Sc, pos):
    """One decode step over a random cache: inside it (masked tail),
    at and past its end (the rolling buffer, every slot live), an Sc that
    is not a multiple of 256, and pos 0. The port writes the cache in
    place: the tensors it returns are the ones passed in."""
    rng = np.random.default_rng(Sc + pos)
    B, D, H, Kh, Dh = 2, 64, 4, 2, 32
    jp, tp = _attn_params(rng, D, H, Kh, Dh, dtype)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    x = jnp.asarray(rng.normal(size=(B, 1, D)), jdt)
    cache = {n: jnp.asarray(rng.normal(size=(B, Sc, Kh, Dh)), jdt)
             for n in ("k", "v")}
    kw = dict(num_heads=H, num_kv_heads=Kh, head_dim=Dh, rope_theta=1e6)
    want, wc = r_attn.attention_decode(jp, x, cache,
                                       jnp.array(pos, jnp.int32), **kw)
    tcache = _to_torch(cache)
    got, gc = t_attn.attention_decode(tp, _to_torch(x), tcache, pos, **kw)
    assert gc["k"] is tcache["k"] and gc["v"] is tcache["v"]
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(gc[n]), _np(wc[n]), **tol)
    with pytest.raises(NotImplementedError, match="A9"):
        t_attn.attention_decode(tp, _to_torch(x), tcache, pos, cross=True,
                                **kw)


# ---------------------------------------------------------------------------
# the model: forward, prefill and decode steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over", [
    ("qwen3-0.6b", dict(dtype="float32")),
    ("qwen3-0.6b", dict(dtype="float32", window=16)),   # rolled cache
    ("stablelm-1.6b", dict(dtype="float32")),           # layernorm, bias, G=1
    ("qwen3-0.6b", dict(dtype="bfloat16")),
])
def test_serving_matches_reference(arch, over):
    """From the reference's `init_params`, carried across: `forward`'s
    logits over prompt and continuation; `prefill`'s last logits and cache
    (24 prompt tokens into 40 slots, or rolled into a 16-slot window);
    then 4 `decode_step`s, each one's logits and cache against the
    reference's, fed the reference's cache carried across for the first
    step and the port's own after it."""
    rc, tc = _configs(arch, **over)
    rp = r_tf.init_params(jax.random.key(1), rc)
    tp = _to_torch(rp)
    T, steps, cache_len = 24, 4, 40
    toks = np.random.default_rng(5).integers(
        0, rc.vocab_size, (2, T + steps)).astype(np.int32)
    tol = BF16_TOL if over["dtype"] == "bfloat16" else dict(rtol=1e-4,
                                                           atol=1e-4)
    want, _ = r_tf.forward(rp, rc, {"tokens": jnp.asarray(toks)})
    got, aux = t_tf.forward(tp, tc, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    assert float(aux["load_balance_loss"]) == 0.0

    rlast, rcache = r_tf.prefill(rp, rc, {"tokens": jnp.asarray(toks[:, :T])},
                                 cache_len)
    tlast, tcache = t_tf.prefill(tp, tc, {"tokens": torch.from_numpy(
        toks[:, :T])}, cache_len)
    assert tcache["pos"] == int(rcache["pos"]) == T

    def check(logits, cache, rlogits, rc_):
        np.testing.assert_allclose(_np(logits), _np(rlogits), **tol)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(cache["segs"][0]["0"][name]),
                                       _np(rc_["segs"][0]["0"][name]), **tol)

    check(tlast, tcache, rlast, rcache)
    Sc = tcache["segs"][0]["0"]["k"].shape[2]
    assert Sc == (16 if over.get("window") else cache_len)
    tcache = transformer_cache_from_numpy(
        jax.tree_util.tree_map(np.asarray, rcache), device="cpu")
    decode = jax.jit(r_tf.decode_step, static_argnums=1)
    for s in range(steps):
        tok = toks[:, T + s:T + s + 1]
        rlogits, rcache = decode(rp, rc, rcache, jnp.asarray(tok))
        logits, tcache = t_tf.decode_step(tp, tc, tcache,
                                          torch.from_numpy(tok))
        assert tcache["pos"] == int(rcache["pos"]) == T + s + 1
        check(logits, tcache, rlogits, rcache)


def test_init_params_match_reference_distributions():
    """The port's own initializer: the reference's tree, shapes and
    dtypes, and per-leaf standard deviations within 10% (ones and zeros
    exactly), at qwen3's SMOKE widths in bf16 and stablelm's in f32."""
    for arch, over in (("qwen3-0.6b", {}),
                       ("stablelm-1.6b", dict(dtype="float32"))):
        rc, tc = _configs(arch, **over)
        rp = jax.tree_util.tree_map(np.asarray,
                                    r_tf.init_params(jax.random.key(0), rc))
        tp = t_tf.init_params(tc, seed=0, device="cpu")
        rl, rdef = jax.tree_util.tree_flatten(rp)
        tl, tdef = jax.tree_util.tree_flatten(tp)
        assert rdef == tdef
        for a, b in zip(rl, tl):
            assert tuple(b.shape) == a.shape
            assert str(b.dtype).split(".")[-1] == a.dtype.name
            a, b = a.astype(np.float32), b.float().numpy()
            if a.std() == 0:
                np.testing.assert_array_equal(a, b)
            else:
                assert abs(b.std() / a.std() - 1) < 0.1, (a.std(), b.std())


@pytest.mark.parametrize("arch,over", [
    ("qwen3-0.6b", dict(pattern=("moe",), num_experts=4, top_k=2)),
    ("recurrentgemma-9b", {}),
    ("qwen3-0.6b", dict(pattern=("dense", "cross"), num_image_tokens=4)),
    ("hubert-xlarge", {}),
])
def test_unported_layers_raise(arch, over):
    _, tc = _configs(arch, **over)
    with pytest.raises(NotImplementedError, match="A9"):
        t_tf.init_params(tc, device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        t_tf.init_cache(tc, 1, 8, device="cpu")
