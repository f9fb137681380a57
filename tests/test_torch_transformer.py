"""PyTorch port, the transformer substrate: configs, the building blocks,
the attention layers and the model's entry points (`forward`, `loss_fn`,
`prefill`, `decode_step`) for every layer type (dense, local, moe, cross,
rec) and the audio family, and the shape-only helpers (`abstract_params`,
`cache_specs`, `input_specs`), against the JAX package, on the same numpy
inputs and with the reference's params carried across
(`transformer_params_from_numpy`).

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
import _torch_threads  # noqa: E402  one torch thread a test process

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
from repro_torch.train.optimizer import grad_leaves, tree_leaves
from repro_torch.utils import tree as t_tree
from repro.utils import tree as r_tree

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
    # cross attention: the same cache as image K/V, every slot valid
    # whatever pos, no RoPE, the cache left as it was
    before = {n: a.clone() for n, a in gc.items()}
    kw["use_rope"] = False
    want, _ = r_attn.attention_decode(jp, x, wc, jnp.array(pos, jnp.int32),
                                      cross=True, **kw)
    got, gc2 = t_attn.attention_decode(tp, _to_torch(x), gc, pos,
                                       cross=True, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    assert gc2 is gc and all(torch.equal(gc[n], before[n]) for n in gc)


# ---------------------------------------------------------------------------
# the model: forward, prefill and decode steps
# ---------------------------------------------------------------------------

# the image tokens of the cross-attention cases, and the tanh gates the
# reference initializes at zero (a closed gate would hide the layer)
N_IMG = 4
GATES = {"g_attn": 0.5, "g_mlp": -0.3}


def _cross_ready(rp, rc):
    """The reference's params with every cross layer's gates opened."""
    if "cross" not in rc.layer_types():
        return rp
    segs = [{i: ({**lp, **{g: jnp.full_like(lp[g], v)
                           for g, v in GATES.items()}} if "g_attn" in lp
                 else lp) for i, lp in seg.items()} for seg in rp["segs"]]
    return {**rp, "segs": segs}


@pytest.mark.parametrize("arch,over", [
    ("qwen3-0.6b", dict(dtype="float32")),
    ("qwen3-0.6b", dict(dtype="float32", window=16)),   # rolled cache
    ("stablelm-1.6b", dict(dtype="float32")),           # layernorm, bias, G=1
    ("qwen3-0.6b", dict(dtype="bfloat16")),
    # rec, rec, local: the 64-slot local cache rolled by a 72-token prompt
    ("recurrentgemma-9b", dict(dtype="float32")),
    ("qwen3-0.6b", dict(dtype="float32", pattern=("moe",), num_experts=4,
                        top_k=2)),
    ("qwen3-0.6b", dict(dtype="float32", pattern=("dense", "cross"),
                        family="vlm", num_image_tokens=N_IMG)),
    ("qwen2-72b", dict(dtype="float32")),               # qkv bias
    ("qwen2-72b", dict(dtype="float32", window=16)),
    ("stablelm-1.6b", dict(dtype="float32", window=16)),
])
def test_serving_matches_reference(arch, over):
    """From the reference's `init_params`, carried across: `forward`'s
    logits and aux losses over prompt and continuation; `prefill`'s last
    logits and every cache leaf (24 prompt tokens into 40 slots, or
    rolled into a 16-slot window; recurrentgemma's 72 into its 64-slot
    window); then 4 `decode_step`s, each one's logits and cache against
    the reference's, fed the reference's cache carried across for the
    first step and the port's own after it. MoE decode is held to the
    reference's decode, not to `forward`: capacity drops depend on the
    group, 2 tokens in a decode step."""
    rc, tc = _configs(arch, **over)
    rp = _cross_ready(r_tf.init_params(jax.random.key(1), rc), rc)
    tp = _to_torch(rp)
    T = 72 if arch == "recurrentgemma-9b" else 24
    steps, cache_len = 4, T + 16
    rng = np.random.default_rng(5)
    toks = rng.integers(0, rc.vocab_size, (2, T + steps)).astype(np.int32)
    extra = {}
    if "cross" in rc.layer_types():
        extra["image_embeds"] = rng.normal(
            size=(2, N_IMG, rc.d_model)).astype(np.float32)
    rx = {k: jnp.asarray(v) for k, v in extra.items()}
    tx = {k: torch.from_numpy(v) for k, v in extra.items()}
    tol = BF16_TOL if over["dtype"] == "bfloat16" else dict(rtol=1e-4,
                                                           atol=1e-4)
    want, waux = r_tf.forward(rp, rc, {"tokens": jnp.asarray(toks), **rx})
    got, aux = t_tf.forward(tp, tc, {"tokens": torch.from_numpy(toks), **tx})
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    for name in ("load_balance_loss", "z_loss"):
        np.testing.assert_allclose(_np(aux[name]), _np(waux[name]),
                                   rtol=1e-5, atol=1e-6)

    rlast, rcache = r_tf.prefill(rp, rc, {"tokens": jnp.asarray(toks[:, :T]),
                                          **rx}, cache_len)
    tlast, tcache = t_tf.prefill(tp, tc, {"tokens": torch.from_numpy(
        toks[:, :T]), **tx}, cache_len)
    assert tcache["pos"] == int(rcache["pos"]) == T

    def check(logits, cache, rlogits, rc_):
        np.testing.assert_allclose(_np(logits), _np(rlogits), **tol)
        got_l = tree_leaves(cache["segs"])
        want_l = jax.tree_util.tree_leaves(rc_["segs"])
        assert len(got_l) == len(want_l)
        for a, b in zip(got_l, want_l):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(_np(a), _np(b), **tol)

    check(tlast, tcache, rlast, rcache)
    if tc.pattern == ("dense",):
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


def test_audio_forward_and_loss_match_reference():
    """hubert SMOKE (frames in, learned positions, bidirectional,
    layernorm): `forward`'s logits, then `loss_fn` with a mask; an
    encoder has no decode step."""
    rc, tc = _configs("hubert-xlarge", dtype="float32")
    rp = r_tf.init_params(jax.random.key(2), rc)
    tp = _to_torch(rp)
    rng = np.random.default_rng(3)
    frames = rng.normal(size=(2, 40, rc.d_model)).astype(np.float32)
    labels = rng.integers(0, rc.vocab_size, (2, 40)).astype(np.int32)
    mask = (rng.random((2, 40)) < 0.5).astype(np.int32)
    want, _ = r_tf.forward(rp, rc, {"frames": jnp.asarray(frames)})
    got, _ = t_tf.forward(tp, tc, {"frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    rb = {"frames": jnp.asarray(frames), "labels": jnp.asarray(labels),
          "mask": jnp.asarray(mask)}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}
    wl, wm = r_tf.loss_fn(rp, rc, rb)
    with torch.no_grad():
        gl, gm = t_tf.loss_fn(tp, tc, tb)
    np.testing.assert_allclose(_np(gl), _np(wl), rtol=1e-5, atol=1e-5)
    assert sorted(gm) == sorted(wm)
    assert not tc.has_decode
    with pytest.raises(ValueError, match="encoder-only"):
        t_tf.decode_step(tp, tc, {"pos": 0, "segs": []},
                         torch.zeros((2, 1), dtype=torch.int32))


@pytest.mark.parametrize("arch,over", [
    ("qwen3-0.6b", dict(chunked_ce=0)),
    ("qwen3-0.6b", dict(chunked_ce=200)),     # V = 512: the last chunk padded
    ("qwen3-0.6b", dict(chunked_ce=0, pattern=("moe",), num_experts=4,
                        top_k=2)),
    ("recurrentgemma-9b", dict(chunked_ce=128)),
])
def test_loss_fn_matches_reference(arch, over):
    """`loss_fn` (ce + 0.01 lb + 1e-3 z) with and without `chunked_ce`,
    remat on (per layer under torch.utils.checkpoint): the loss, its
    metrics and every param's gradient against jax.grad (1e-4: sums over
    the whole backward)."""
    rc, tc = _configs(arch, dtype="float32", **over)
    rp = r_tf.init_params(jax.random.key(3), rc)
    tp = _to_torch(rp)
    toks = np.random.default_rng(4).integers(
        0, rc.vocab_size, (2, 33)).astype(np.int32)
    rb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}
    (wl, wm), wg = jax.value_and_grad(
        lambda p: r_tf.loss_fn(p, rc, rb), has_aux=True)(rp)
    tree, leaves = grad_leaves(tp)
    gl, gm = t_tf.loss_fn(tree, tc, tb)
    grads = torch.autograd.grad(gl, leaves)
    assert sorted(gm) == sorted(wm)
    for name in wm:
        np.testing.assert_allclose(_np(gm[name]), _np(wm[name]), rtol=1e-5,
                                   atol=1e-5)
    if "moe" in rc.layer_types():
        assert float(gm["load_balance_loss"].detach()) > 0
    wgl = jax.tree_util.tree_leaves(wg)
    assert len(wgl) == len(grads)
    for w, g in zip(wgl, grads):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# shapes without allocation
# ---------------------------------------------------------------------------

def _spec_leaves(tree):
    return [(tuple(a.shape), str(a.dtype).split(".")[-1])
            for a in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("arch", r_base.ARCH_IDS)
def test_abstract_params_and_cache_specs_match_reference(arch):
    """At the published widths: every params leaf and every cache leaf
    (B = 2 at decode_32k's length; hubert has no decode but its cache
    struct builds) with the reference's shape and dtype, all on the meta
    device, and the byte totals equal."""
    rc, tc = r_base.get_config(arch, "full"), t_base.get_config(arch,
                                                               "full")
    rp, tp = r_tf.abstract_params(rc), t_tf.abstract_params(tc)
    assert jax.tree_util.tree_structure(rp) == \
        jax.tree_util.tree_structure(tp)
    assert _spec_leaves(tp) == _spec_leaves(rp)
    assert all(a.device.type == "meta" for a in tree_leaves(tp))
    assert t_tree.tree_size_bytes(tp) == r_tree.tree_size_bytes(rp)
    assert t_tree.tree_num_params(tp) == r_tree.tree_num_params(rp)
    rcs, tcs = r_tf.cache_specs(rc, 2, 32768), t_tf.cache_specs(tc, 2, 32768)
    assert _spec_leaves(tcs["segs"]) == _spec_leaves(rcs["segs"])
    assert tcs["pos"].dtype == torch.int32 and tcs["pos"].shape == ()
    assert all(a.device.type == "meta" for a in tree_leaves(tcs["segs"]))


def test_input_specs_and_all_configs_match_reference():
    rall, tall = r_base.all_configs(), t_base.all_configs()
    assert list(tall) == list(rall)
    for arch, rc in rall.items():
        tc = tall[arch]
        assert dataclasses.asdict(tc) == dataclasses.asdict(rc)
        assert tc.has_decode == rc.has_decode
        for shape in r_base.INPUT_SHAPES:
            assert tc.supports_shape(shape) == rc.supports_shape(shape)
            want = r_base.input_specs(rc, shape)
            got = t_base.input_specs(tc, shape)
            assert list(got) == list(want)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape
                assert str(got[k].dtype).split(".")[-1] == \
                    want[k].dtype.name
                assert got[k].device.type == "meta"
    smoke = t_base.all_configs("smoke")
    assert list(smoke) == list(r_base.all_configs("smoke"))


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
    """The layer types and the family that raised before they were ported
    (moe, rec and local, cross, audio): the port's own `init_params` and
    `init_cache` trees against the reference's, key for key, in shape and
    dtype (the rec state's h in f32, the cross gates f32 scalars)."""
    rc, tc = _configs(arch, **over)
    rp = r_tf.init_params(jax.random.key(0), rc)
    tp = t_tf.init_params(tc, seed=0, device="cpu")
    assert jax.tree_util.tree_structure(rp) == \
        jax.tree_util.tree_structure(tp)
    assert _spec_leaves(tp) == _spec_leaves(rp)
    rcache = r_tf.init_cache(rc, 2, 96)
    tcache = t_tf.init_cache(tc, 2, 96, device="cpu")
    assert tcache["pos"] == int(rcache["pos"]) == 96
    assert jax.tree_util.tree_structure(rcache["segs"]) == \
        jax.tree_util.tree_structure(tcache["segs"])
    assert _spec_leaves(tcache["segs"]) == _spec_leaves(rcache["segs"])
    assert not any(bool(a.any()) for a in tree_leaves(tcache["segs"]))
