"""PyTorch port, `flash_decode`: the plain version (`kernels/ref.py:
flash_decode_ref`, what the wrapper runs on CPU tensors and what
`chip_smoke.py` and `tests/test_torch_cuda.py` hold the CUDA kernel to)
against the reference's Pallas kernel in interpret mode, on the same
numpy inputs.

Tolerances are the Pallas kernel's own test's (tests/test_kernels.py):
1e-5 in f32 (the same f32 sums in another order: one softmax against an
online one over 256-slot blocks) and 2e-2 in bf16 (p rounded to bf16
before p @ v in both, but from maxima and sums taken otherwise, so a p
near a rounding boundary may land one bf16 step apart)."""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.decode_attn import flash_decode as pallas_flash_decode
from repro_torch.kernels.decode_attn import (
    CTAS_PER_SM, F32_CTAS_PER_SM, MAX_GROUP_TILE, TILE, TILE_F32,
    flash_decode, flash_decode_plan)
from repro_torch.kernels.ref import flash_decode_ref

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, Kh, G, Dh, S, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, Kh, G, Dh), (B, S, Kh, Dh), (B, S, Kh, Dh))]
    _, jdt, tdt = DTYPES[dtype]
    # both packages see the same values: rounded to bf16 once, by jax
    jx = [jnp.asarray(a, jdt) for a in arrs]
    tx = [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in jx]
    return jx, tx, rng


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,Kh,G,Dh,S,pos", [
    (2, 2, 4, 64, 512, 511), (1, 4, 2, 128, 1024, 300),
    (2, 1, 8, 64, 512, 600),   # pos >= S: the rolling buffer, all valid
    (2, 2, 2, 32, 1024, 0),    # one valid slot, three blocks wholly masked
    # recurrentgemma-9b's heads (Dh 256, MQA: Kh 1, G 16), rolled and not
    (2, 1, 16, 256, 512, 600), (2, 1, 16, 256, 512, 300),
])
def test_flash_decode_ref_matches_pallas(dtype, B, Kh, G, Dh, S, pos):
    (jq, jk, jv), (tq, tk, tv), _ = _inputs(B + S + pos, B, Kh, G, Dh, S,
                                            dtype)
    want = pallas_flash_decode(jq, jk, jv, jnp.array(pos, jnp.int32),
                               block_s=256)
    got = flash_decode_ref(tq, tk, tv, pos)
    # the wrapper runs the plain version on CPU tensors
    assert torch.equal(flash_decode(tq, tk, tv, pos), got)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 1e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 1023), st.sampled_from(["f32", "bf16"]), st.data())
def test_flash_decode_ref_ignores_masked_tail(pos, dtype, data):
    """Slots past `pos` never influence the output: new k and v values
    there leave it bitwise unchanged."""
    seed = data.draw(st.integers(0, 2**31))
    B, Kh, G, Dh, S = 1, 2, 2, 64, 1024
    _, (q, k, v), rng = _inputs(seed, B, Kh, G, Dh, S, dtype)
    out = flash_decode_ref(q, k, v, pos)
    k2, v2 = k.clone(), v.clone()
    tail = k2[:, pos + 1:].shape
    k2[:, pos + 1:] = torch.from_numpy(
        rng.normal(size=tail).astype(np.float32)).to(k.dtype)
    v2[:, pos + 1:] = torch.from_numpy(
        rng.normal(size=tail).astype(np.float32)).to(v.dtype)
    assert torch.equal(out, flash_decode_ref(q, k2, v2, pos))


@pytest.mark.parametrize("B,Kh,G,n_valid", [
    (8, 8, 2, 3001), (8, 8, 2, 32768), (1, 1, 1, 1), (2, 4, 3, 255),
    (1, 2, 12, 70000), (128, 8, 8, 32768), (8, 8, 2, 4096), (1, 1, 2, 65),
    (1, 2, 20, 500), (100, 1, 2, 5000), (8, 1, 16, 2048)])
def test_flash_decode_plan_covers_valid_slots(B, Kh, G, n_valid):
    """The bf16 kernel's grid on a card of 132 SMs: the chunks cover
    exactly the valid slots with none empty (the launcher refuses any
    other cut), each a whole number of TILE-slot tiles, the group in one
    tile of up to MAX_GROUP_TILE members (tiles of it past that), and no
    more CTAs than the card holds in one wave unless each (b, h, group
    tile) already has a single chunk."""
    gt, n_splits, chunk = flash_decode_plan(B, Kh, G, n_valid, 132)
    assert gt == min(G, MAX_GROUP_TILE)
    assert (n_splits - 1) * chunk < n_valid <= n_splits * chunk
    assert chunk % TILE == 0 and 1 <= n_splits <= 65535
    pairs = B * Kh * -(-G // gt)
    assert n_splits == 1 or pairs * n_splits <= CTAS_PER_SM * 132
    # the longest chunk as short as one wave allows: the tiles spread
    # over as many splits as fit, at least one, at most one per tile
    tiles = -(-n_valid // TILE)
    fit = max(1, min(CTAS_PER_SM * 132 // pairs, tiles))
    assert chunk == TILE * -(-tiles // fit)


@pytest.mark.parametrize("pairs,n_sm,want", [
    ((8, 8), 132, 2), ((8, 8), 66, 1), ((8, 8), 16, 1), ((2, 2), 132, 33),
    ((1, 1), 132, 33), ((1, 1), 8, 7)])
def test_flash_decode_plan_follows_the_sm_count(pairs, n_sm, want):
    """The bf16 splits come from the SM count passed in: CTAS_PER_SM
    CTAs on each SM over the (b, h) pairs, at least one per pair, at most
    one per tile of the 2,049 valid slots (33 tiles; the 8 CTAs that 8 SMs
    hold take chunks of 5 tiles, so 7 splits)."""
    B_, Kh = pairs
    gt, n_splits, chunk = flash_decode_plan(B_, Kh, 2, 2049, n_sm)
    assert n_splits == want, (n_splits, chunk)
    assert (n_splits - 1) * chunk < 2049 <= n_splits * chunk


@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("B,Kh,G,n_valid", [
    (8, 8, 2, 3001), (1, 1, 1, 1), (2, 4, 3, 255), (1, 2, 12, 70000),
    (8, 1, 16, 2048), (2, 1, 16, 2048), (1, 1, 20, 500)])
def test_flash_decode_plan_f32_covers_valid_slots(B, Kh, G, n_valid, dh):
    """The f32 kernel's grid on a card of 132 SMs: the chunks cover
    exactly the valid slots with none empty (the launcher refuses any
    other cut), each a whole number of TILE_F32-slot
    tiles, the group in one tile of up to MAX_GROUP_TILE members (so a k
    and v row is read once a step for G <= 16; 20 takes tiles of 16), and
    no more CTAs than F32_CTAS_PER_SM[dh] on each SM hold in one wave
    unless each (b, h, group tile) already has a single chunk."""
    gt, n_splits, chunk = flash_decode_plan(B, Kh, G, n_valid, 132,
                                            torch.float32, dh)
    assert gt == min(G, MAX_GROUP_TILE)
    assert (n_splits - 1) * chunk < n_valid <= n_splits * chunk
    assert chunk % TILE_F32 == 0 and 1 <= n_splits <= 65535
    pairs = B * Kh * -(-G // gt)
    per_sm = F32_CTAS_PER_SM[dh]
    assert n_splits == 1 or pairs * n_splits <= per_sm * 132
    tiles = -(-n_valid // TILE_F32)
    fit = max(1, min(per_sm * 132 // pairs, tiles))
    assert chunk == TILE_F32 * -(-tiles // fit)


@pytest.mark.parametrize("B,Kh,G,n_valid,dh,n_sm,want", [
    # phase 9b's f32 decode of recurrentgemma-9b: 64 splits of one tile,
    # 128 CTAs (two group tiles of 8 on 256-slot chunks ran 32)
    (2, 1, 16, 2048, 256, 132, 64), (8, 1, 16, 2048, 256, 132, 16),
    (8, 8, 2, 3001, 128, 132, 4), (8, 8, 2, 3001, 128, 66, 2),
    (8, 8, 2, 3001, 128, 16, 1), (1, 1, 2, 2049, 32, 132, 65),
    (1, 1, 2, 2049, 64, 8, 22)])
def test_flash_decode_plan_f32_follows_the_sm_count(B, Kh, G, n_valid, dh,
                                                    n_sm, want):
    """The f32 splits come from the SM count passed in: F32_CTAS_PER_SM
    [dh] CTAs on each SM over the (b, h) pairs, at least one per pair, at
    most one per 32-slot tile (2,049 slots are 65 tiles; the 32 CTAs that
    8 SMs hold at Dh 64 take chunks of 3 tiles, so 22 splits)."""
    gt, n_splits, chunk = flash_decode_plan(B, Kh, G, n_valid, n_sm,
                                            torch.float32, dh)
    assert n_splits == want, (n_splits, chunk)
    assert (n_splits - 1) * chunk < n_valid <= n_splits * chunk


@pytest.mark.parametrize("dh", [None, 80])
def test_flash_decode_plan_f32_needs_head_dim(dh):
    """The f32 CTAs an SM holds depend on the head_dim: the f32 plan takes
    no default and no head_dim the kernel is not built for."""
    with pytest.raises(ValueError, match="head_dim"):
        flash_decode_plan(8, 8, 2, 3001, 132, torch.float32, dh)


def test_flash_decode_rejects_negative_pos():
    _, (q, k, v), _ = _inputs(0, 1, 1, 1, 32, 8, "f32")
    with pytest.raises(ValueError, match="pos"):
        flash_decode(q, k, v, -1)
