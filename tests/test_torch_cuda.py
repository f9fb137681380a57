"""PyTorch port on the card: each CUDA kernel against its plain version,
and a training step on the card against the same step on the CPU.

Every test here is marked `cuda` and skips without a CUDA device (decided
inside the `dev` fixture, never at import). On a machine with the card
and `nvcc`:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The first call builds the kernels (kernels/_build.py). Tolerances: the
row max M of the edge softmax is bitwise its plain version's (a max over
the same scores), and so are PNA's min, max, count and tie counts (one
add and a max per message, sums of small integers; its sums and
gradients at 1e-5), and the row moves: the f32 and bf16 gathers and
scatters, the dequantizing gather and the quantizing scatter (codes and
scales; the same division, rounding and multiply); everything else
compares at rtol = atol = 1e-4 (sums in another order, and expf against
torch.exp in the last bits); a warm repeat of each kernel is bitwise
identical (no atomics). Quantized training steps hold the tables as
dequantized values within one quantization step s_i per row, with at
least 99.9% of the codes equal: a pushed value a rounding away from a
code's .5 boundary may land on the other side. Every history pull
(`ops.pull_rows` over an f32, bf16, int8 or vq table) is one device
kernel that clips its indices itself, bitwise its plain version for
indices below 0 and past N - 1. The vq kernels: the
decoding pull and the encoding push bitwise (codes, scales, decoded
rows: one division, distances summed left to right, the first minimum,
one multiply), the fused vq body at 1e-5, a refit on the card against
the same refit on the CPU (codebooks at 1e-6, >= 99.9% of the codes
equal), and vq training steps with >= 99.9% of the codes equal.
The block contractions (`bcsr_spmm`, `gather_spmm`'s four bodies) at
1e-4 over sparse, dense and all-zero blocks, dense ones on a grid where
every order of summation is exact, and their one departure from the
plain version pinned: a non-finite row that only zero entries reach
stays out of the output.
`flash_decode` against its plain version at 1e-5 in f32 (the Pallas
kernel's own tolerance) and in bf16 within 2e-2 of the largest
|output|, its masked tail never read (the output bitwise unchanged), at
Dh 32 to 256, and transformer decode steps on the card against the
CPU's, for dense, rec / local, moe and cross stacks: logits at 1e-4,
caches at 1e-5; seq-GAS's chunked_loss and gradients and hubert's
bidirectional passes against the CPU's. The operator zoo's
training steps (GIN, GCNII, APPNP, and GIN with the Eq. 3 regularizer
and the staleness decay), the f32 `gather_spmm` at d = 6 and 48 over
forward and unit-weight training blocks, the row kernels at d = 6, and
`gas_aggregate`'s float-table gradient against the CPU's. `scatter_rows`, and
`scatter_rows_q`'s codes and scales, bitwise over the whole table on
both of their paths (the one-launch scan and the claim passes past
SCAN_MAX_ROWS rows). The trainer shell and table 5's baselines:
`GASTrainer`'s two epochs against the CPU's (losses at 1e-4), and one
GraphSAGE step on one sampled batch and one SGC step against the CPU's
as the training steps are held. Evolving graphs: an incremental
`advance` on the card against the CPU's (GCN, GAT and PNA over f32 and
int8; batches bitwise, tables at 1e-5, int8 codes >= 99.9% equal, the
old state's store unchanged, no backward kernel launched), and a pinned
store's `grow` right after a queued push (pinned, bitwise the device
store's). Distributed GAS: 2 gloo ranks on the card (both on cuda:0
with one card) against the same ranks on the CPU: f32, bf16 and int8
halos bitwise, and GCNII's and an int8 GCN's supersteps (loss and
summed gradients at 1e-5, int8 codes >= 99.9% equal). The full-graph
forward (`full_forward`, every sum of its COO route through
`ref.segment_sum`) of all six operators bitwise across two runs. The raw
pull and push over many tables (`gather_rows_raw_many`,
`scatter_rows_raw_many`) bitwise their plain versions at 1 to 65 tables
of every width, pinned, on the card and mixed, and one raw kernel a
`HistoryStore.prefetch` and a `push_raw` (torch.profiler, one window);
the raw entries' grid queries against grids worked by hand."""
import collections
import ctypes
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")

from repro_torch.configs.base import get_config
from repro_torch.core import runtime as R
from repro_torch.core.config import resolve_device
from repro_torch.data.graphs import citation_graph
from repro_torch.gnn.model import GNNSpec
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import edge_softmax as esk
from repro_torch.kernels import pna_reduce as pnk
from repro_torch.kernels.bcsr_spmm import bcsr_spmm
from repro_torch.kernels.decode_attn import _sm_count, flash_decode
from repro_torch.kernels.fused import gather_plan, gather_spmm
from repro_torch.core.gas import gcn_edge_weights
from repro_torch.core.history import vq_init_codebook
from repro_torch.gnn import model as gnn_model
from repro_torch.kernels.gather import (gather_rows, gather_rows_dq,
                                        gather_rows_vq)
from repro_torch.kernels.scatter import (SCAN_MAX_ROWS, scatter_rows,
                                         scatter_rows_q, scatter_rows_vq,
                                         scatter_rows_vq_plan)
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import tree_leaves, tree_map

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return resolve_device("cuda")


def _blocks(seed, n_out, M, ne, empty_from=None):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, empty_from or n_out, ne).astype(np.int32)
    src = rng.integers(0, M - 40, ne).astype(np.int32)
    k = ne // 10
    dst[:k], src[:k] = dst[k:2 * k], src[k:2 * k]   # duplicate edges
    ones = np.ones(ne, np.float32)
    uv, uc, _, _ = ops.build_bcsr_rect(dst, src, ones, n_out, M)
    uvt, uct, _, _ = ops.build_bcsr_rect(src, dst, ones, M, n_out)
    return [torch.from_numpy(a) for a in (uv, uc, uvt, uct)], rng


_ES_KERNELS = ("edge_softmax_fwd", "edge_softmax_bwd_row",
               "edge_softmax_bwd_col")


def _edge_softmax_all(dev, H, F, uv, uc, uvt, uct, ad, as_, wx, g):
    """The three kernels on the card against their plain versions: M
    bitwise, the rest at TOL; then a warm repeat of each bitwise, and
    exactly one launch per call. Returns the kernels' outputs."""
    ad_d, as_d, wx_d, g_d = (torch.from_numpy(a).to(dev)
                             for a in (ad, as_, wx, g))
    uv_d, uc_d, uvt_d, uct_d = (t.to(dev) for t in (uv, uc, uvt, uct))
    before = dict(_build.launch_counts)
    out, mm, ll = esk.edge_softmax_fwd(ad_d, as_d, wx_d, uv_d, uc_d)
    p_out, p_mm, p_ll = ref.edge_softmax_fwd_ref(ad_d, as_d, wx_d, uv_d,
                                                 uc_d)
    assert torch.equal(mm, p_mm)
    torch.testing.assert_close(out, p_out, **TOL)
    torch.testing.assert_close(ll, p_ll, **TOL)
    delta = (g_d * p_out).sum(-1)
    bwd = (ad_d, as_d, wx_d, g_d, p_mm, p_ll, delta)
    dad = esk.edge_softmax_bwd_row(*bwd, uv_d, uc_d)
    torch.testing.assert_close(dad, ref.edge_softmax_bwd_row_ref(
        *bwd, uv_d, uc_d), **TOL)
    dwx, das = esk.edge_softmax_bwd_col(*bwd, uvt_d, uct_d)
    p_dwx, p_das = ref.edge_softmax_bwd_col_ref(*bwd, uvt_d, uct_d)
    torch.testing.assert_close(dwx, p_dwx, **TOL)
    torch.testing.assert_close(das, p_das, **TOL)
    torch.cuda.synchronize()
    for k in _ES_KERNELS:
        assert _build.launch_counts[k] == before[k] + 1, k
    # a warm repeat of each is bitwise the same
    for a, b in zip(esk.edge_softmax_fwd(ad_d, as_d, wx_d, uv_d, uc_d),
                    (out, mm, ll)):
        assert torch.equal(a, b)
    assert torch.equal(esk.edge_softmax_bwd_row(*bwd, uv_d, uc_d), dad)
    again = esk.edge_softmax_bwd_col(*bwd, uvt_d, uct_d)
    assert torch.equal(again[0], dwx) and torch.equal(again[1], das)
    return out, mm, ll, dad, dwx, das


@pytest.mark.parametrize("H,F,n_out,M", [(8, 8, 194, 474), (1, 7, 194, 474),
                                         (2, 20, 300, 700), (12, 3, 130, 260),
                                         (8, 16, 194, 474), (2, 40, 203, 474),
                                         (1, 130, 141, 300), (3, 30, 141, 300),
                                         (8, 8, 194, 129)])
def test_edge_softmax_kernels_match_plain(dev, H, F, n_out, M):
    """The three kernels at GAT's layer shapes on the Cora-shaped batches
    (8 heads of 8, one head of 7), F past one register tile, H past one
    CTA's 8 heads; H*F past one 64-pair lane tile (8 x 16: two tiles
    split between heads; 2 x 40 and 3 x 30: a head straddles the tiles;
    1 x 130: one head over three), in the forward and the row pass over
    destination rows and in the column pass over source rows; n_out and
    M not multiples of 8 throughout (M = 129: one source past a block
    row), so a CTA of the warp-per-row kernels holds live and dead warps.
    The last 5 destinations have no edges (out, dad 0); the last 40
    sources are reached by no edge and carry poisoned values (dwx, das
    0)."""
    (uv, uc, uvt, uct), rng = _blocks(H + F, n_out, M, 6 * n_out,
                                      empty_from=n_out - 5)
    wx = rng.normal(size=(M, H, F)).astype(np.float32)
    as_ = rng.normal(size=(M, H)).astype(np.float32)
    wx[M - 40:] = 1e30
    as_[M - 40:] = 50.0
    ad = rng.normal(size=(n_out, H)).astype(np.float32)
    g = rng.normal(size=(n_out, H, F)).astype(np.float32)
    out, mm, ll, dad, dwx, das = _edge_softmax_all(dev, H, F, uv, uc, uvt,
                                                   uct, ad, as_, wx, g)
    assert torch.all(out[n_out - 5:] == 0) and torch.all(dad[n_out - 5:] == 0)
    assert torch.all(mm[n_out - 5:] == ref.NEG)
    assert torch.all(ll[n_out - 5:] == 0)
    assert torch.all(dwx[M - 40:] == 0) and torch.all(das[M - 40:] == 0)


@pytest.mark.parametrize("hub_side", ["dst", "src"])
@pytest.mark.parametrize("H,F,M", [(8, 8, 1300), (1, 7, 1300),
                                   (2, 40, 4500)])
def test_edge_softmax_hub_row_overflows_the_queue(dev, H, F, M, hub_side):
    """A hub row whose edges overflow the warp's 128-entry queue, spread
    over every block of the other side (K = 11 and K = 36), with
    duplicate edges. A hub destination ("dst": 150 destinations, M
    sources) overflows the forward's and the row pass's queue; its
    sources' scores rise along the row, so a later queue batch raises the
    running max and the overflow branch rescales. A hub source ("src": M
    destinations, 150 sources) overflows the column pass's queue over the
    transposed blocks (K_t = 11 and 36), which drains in batches. M
    bitwise, out, L, dad and the column pass at 1e-4, repeats bitwise."""
    few = 150
    rng = np.random.default_rng(M + H)
    hub = 77
    hub_nbr = np.sort(rng.choice(M, size=600, replace=False))
    hub_nbr = np.concatenate([hub_nbr, hub_nbr[::7]])     # duplicates
    other_few = rng.integers(0, few, 4 * few)
    other_many = rng.integers(0, M, 4 * few)
    few_side = np.concatenate([np.full(hub_nbr.size, hub), other_few])
    many_side = np.concatenate([hub_nbr, other_many])
    if hub_side == "dst":
        n_out, n_src, dst, src = few, M, few_side, many_side
    else:
        n_out, n_src, dst, src = M, few, many_side, few_side
    ones = np.ones(dst.size, np.float32)
    uv, uc, _, _ = ops.build_bcsr_rect(dst.astype(np.int32),
                                       src.astype(np.int32), ones, n_out,
                                       n_src)
    uvt, uct, _, _ = ops.build_bcsr_rect(src.astype(np.int32),
                                         dst.astype(np.int32), ones, n_src,
                                         n_out)
    hub_blocks, hub_row = (uv, uc) if hub_side == "dst" else (uvt, uct)
    assert hub_row.shape[1] == -(-M // 128)
    assert int((hub_blocks[hub // 128, :, hub % 128] > 0).sum()) > 128
    assert float(hub_blocks.max()) >= 2
    as_ = (rng.normal(size=(n_src, H)) +
           np.arange(n_src)[:, None] * (8.0 / n_src)).astype(np.float32)
    wx = rng.normal(size=(n_src, H, F)).astype(np.float32)
    ad = rng.normal(size=(n_out, H)).astype(np.float32)
    g = rng.normal(size=(n_out, H, F)).astype(np.float32)
    _edge_softmax_all(dev, H, F, *(torch.from_numpy(a)
                                   for a in (uv, uc, uvt, uct)),
                      ad, as_, wx, g)


@pytest.mark.parametrize("H", [1, 3, 70])
def test_edge_softmax_zero_features(dev, H):
    """Heads of F = 0 features (the plain versions cannot reshape an empty
    feature axis, so they run at F = 1 on zero features, which gives the
    same M, L, dad and das): out and dwx are empty, M bitwise, L at 1e-4,
    and with a nonzero delta dad = -delta sum_j alpha' and das = -sum_i
    alpha' delta_i at 1e-4 (their g . wx terms vanish), one launch per
    call. Each head takes one lane pair; 70 heads take two tiles."""
    (uv, uc, uvt, uct), rng = _blocks(H, 130, 260, 600)
    uv, uc, uvt, uct = (t.to(dev) for t in (uv, uc, uvt, uct))
    ad = torch.from_numpy(rng.normal(size=(130, H)).astype(np.float32))
    as_ = torch.from_numpy(rng.normal(size=(260, H)).astype(np.float32))
    ad, as_ = ad.to(dev), as_.to(dev)
    z = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    before = dict(_build.launch_counts)
    out, mm, ll = esk.edge_softmax_fwd(ad, as_, z(260, H, 0), uv, uc)
    _, p_mm, p_ll = ref.edge_softmax_fwd_ref(ad, as_, z(260, H, 1), uv, uc)
    assert out.shape == (130, H, 0)
    assert torch.equal(mm, p_mm)
    torch.testing.assert_close(ll, p_ll, **TOL)
    delta = torch.from_numpy(rng.normal(size=(130, H)).astype(np.float32))
    delta = delta.to(dev)
    bwd = (ad, as_, z(260, H, 0), z(130, H, 0), mm, ll, delta)
    dad = esk.edge_softmax_bwd_row(*bwd, uv, uc)
    dwx, das = esk.edge_softmax_bwd_col(*bwd, uvt, uct)
    assert dwx.shape == (260, H, 0)
    plain = (ad, as_, z(260, H, 1), z(130, H, 1), mm, ll, delta)
    p_dad = ref.edge_softmax_bwd_row_ref(*plain, uv, uc)
    p_dwx, p_das = ref.edge_softmax_bwd_col_ref(*plain, uvt, uct)
    assert torch.all(p_dwx == 0) and bool((p_das != 0).any())
    torch.testing.assert_close(dad, p_dad, **TOL)
    torch.testing.assert_close(das, p_das, **TOL)
    torch.cuda.synchronize()
    for k in _ES_KERNELS:
        assert _build.launch_counts[k] == before[k] + 1, k


def _hub_blocks(seed, n_out, M, side, n_hub, k_span):
    """`_blocks`' random edges (6 per destination, the last 5
    destinations without edges, the last 40 sources reached by none) and
    one hub row: destination 77 ("dst") or source 77 ("src") with n_hub
    neighbours spread evenly over the first k_span column blocks of its
    row, every fifth of them twice (multiplicity 2)."""
    rng = np.random.default_rng(seed)
    ne = 6 * n_out
    dst = rng.integers(0, n_out - 5, ne).astype(np.int32)
    src = rng.integers(0, M - 40, ne).astype(np.int32)
    step = k_span * 128 // n_hub
    nbr = np.arange(n_hub) * step + rng.integers(0, step, n_hub)
    nbr = np.concatenate([nbr, nbr[::5]]).astype(np.int32)
    hub = np.full(nbr.size, 77, np.int32)
    if side == "dst":
        assert nbr.max() < M - 40
        dst, src = np.concatenate([dst, hub]), np.concatenate([src, nbr])
    else:
        assert nbr.max() < n_out - 5
        dst, src = np.concatenate([dst, nbr]), np.concatenate([src, hub])
    ones = np.ones(dst.size, np.float32)
    uv, uc, _, _ = ops.build_bcsr_rect(dst, src, ones, n_out, M)
    uvt, uct, _, _ = ops.build_bcsr_rect(src, dst, ones, M, n_out)
    return [torch.from_numpy(a) for a in (uv, uc, uvt, uct)], rng


@pytest.mark.parametrize("F,n_out,M,ties,hub", [
    pytest.param(48, 300, 474, True, None, id="48-300-474-True"),
    pytest.param(16, 194, 474, False, None, id="16-194-474-False"),
    pytest.param(130, 260, 520, True, None, id="130-260-520-True"),
    pytest.param(5, 130, 260, True, None, id="5-130-260-True"),
    # a hub destination: 40 sources (48 edges) over K = 11 column blocks
    pytest.param(48, 300, 11 * 128 + 40, True, ("dst", 40, 11),
                 id="hub_dst-40-K11"),
    # a hub source of the transposed blocks: 40 destinations over K_t = 11
    pytest.param(48, 11 * 128 + 5, 474, True, ("src", 40, 11),
                 id="hub_src-40-K11"),
    # K = 24, three chunks of the 8 block rows a backward warp reads at
    # once, and a hub destination of 150 sources (180 edges) past the
    # 128-entry queue
    pytest.param(48, 300, 24 * 128 + 40, True, ("dst", 150, 24),
                 id="hub_dst-150-K24"),
])
def test_pna_kernels_match_plain(dev, F, n_out, M, ties, hub):
    """The three PNA kernels against their plain versions on the card: the
    table-5 width (48, two feature tiles), one tile, F past four tiles and
    ragged in every one, a width below one thread's 8; duplicate edges,
    the last 5 destinations without edges, inputs on a 0.5 grid for ties
    at the min and max, and the last 40 sources reached by no edge
    carrying poisoned values. min, max, count and tie counts bitwise, the
    sums and both gradients at 1e-5, and a warm repeat bit-identical. The
    hub cases give one row more edges than a backward drain loads at once
    and a K past the block rows a backward warp reads at once
    (`_hub_blocks`)."""
    if hub is None:
        (uv, uc, uvt, uct), rng = _blocks(F + n_out, n_out, M, 6 * n_out,
                                          empty_from=n_out - 5)
    else:
        (uv, uc, uvt, uct), rng = _hub_blocks(F + n_out, n_out, M, *hub)
        side, n_hub, k_span = hub
        assert (uc if side == "dst" else uct).shape[1] >= k_span
    xd = rng.normal(size=(n_out, F)).astype(np.float32)
    xs = rng.normal(size=(M, F)).astype(np.float32)
    if ties:
        xd, xs = np.round(xd * 2) / 2, np.round(xs * 2) / 2
    xs[M - 40:] = np.where(rng.random((40, F)) < 0.5, 1e30, -1e30)
    g = [rng.normal(size=(n_out, F)).astype(np.float32) for _ in range(3)]
    xd_d, xs_d, uv_d, uc_d, uvt_d, uct_d = (
        t.to(dev) for t in (torch.from_numpy(xd), torch.from_numpy(xs), uv,
                            uc, uvt, uct))
    g_d = [torch.from_numpy(a).to(dev) for a in g]
    tol = dict(rtol=1e-5, atol=1e-5)

    before = dict(_build.launch_counts)
    out = pnk.pna_reduce_fwd(xd_d, xs_d, uv_d, uc_d)
    want = ref.pna_reduce_fwd_ref(xd_d, xs_d, uv_d, uc_d)
    for name, a, b in zip(("s", "mn", "mx", "cnt", "cmin", "cmax"), out,
                          want):
        if name == "s":
            torch.testing.assert_close(a, b, **tol)
        else:
            assert torch.equal(a, b), name
    s, mn, mx, cnt, cmin, cmax = want
    assert torch.all(cnt[n_out - 5:] == 0) and torch.all(mn[n_out - 5:] == 0)
    if ties:
        assert float(cmin.max()) >= 2 and float(cmax.max()) >= 2
    stats = (*g_d, mn, mx, cmin, cmax)
    dxd = pnk.pna_reduce_bwd_row(xd_d, xs_d, *stats, uv_d, uc_d)
    torch.testing.assert_close(dxd, ref.pna_reduce_bwd_row_ref(
        xd_d, xs_d, *stats, uv_d, uc_d), **tol)
    dxs = pnk.pna_reduce_bwd_col(xd_d, xs_d, *stats, uvt_d, uct_d)
    torch.testing.assert_close(dxs, ref.pna_reduce_bwd_col_ref(
        xd_d, xs_d, *stats, uvt_d, uct_d), **tol)
    assert torch.all(dxs[M - 40:] == 0)
    # a warm repeat of each is bitwise the same
    for a, b in zip(pnk.pna_reduce_fwd(xd_d, xs_d, uv_d, uc_d), out):
        assert torch.equal(a, b)
    assert torch.equal(pnk.pna_reduce_bwd_row(xd_d, xs_d, *stats, uv_d,
                                              uc_d), dxd)
    assert torch.equal(pnk.pna_reduce_bwd_col(xd_d, xs_d, *stats, uvt_d,
                                              uct_d), dxs)
    torch.cuda.synchronize()
    for k in ("pna_reduce_fwd", "pna_reduce_bwd_row", "pna_reduce_bwd_col"):
        assert _build.launch_counts[k] == before[k] + 2, k


def test_autograd_functions_launch_their_kernels(dev):
    """`ops.edge_softmax_aggregate` and `ops.gcn_aggregate` on the card:
    the backward launches the backward kernels (bcsr_spmm on the
    transposed blocks for GCN) and agrees with the same op on the CPU;
    then `ops.pna_reduce`'s forward and both backward kernels."""
    (uv, uc, uvt, uct), rng = _blocks(3, 194, 474, 1200)
    H, F = 8, 8
    wx = torch.from_numpy(rng.normal(size=(474, H, F)).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=(474, H)).astype(np.float32))
    grads = {}
    for d in ("cpu", dev):
        ts = [t.to(d).requires_grad_(True) for t in (wx, a, a * 0.5)]
        blocks = tuple(t.to(d) for t in (uv, uc, uvt, uct))
        before = dict(_build.launch_counts)
        out = ops.edge_softmax_aggregate(*ts, None, None, 194, blocks)
        grads[str(d)] = [out.detach().cpu()] + [
            t.cpu() for t in torch.autograd.grad(out.square().sum(), ts)]
        if d != "cpu":
            torch.cuda.synchronize()
            for k in ("edge_softmax_fwd", "edge_softmax_bwd_row",
                      "edge_softmax_bwd_col"):
                assert _build.launch_counts[k] == before[k] + 1, k
    for x, y in zip(grads["cpu"], grads[str(dev)]):
        torch.testing.assert_close(y, x, **TOL)
    x = torch.from_numpy(rng.normal(size=(474, 64)).astype(np.float32))
    for d in ("cpu", dev):
        xd = x.to(d).requires_grad_(True)
        blocks = tuple(t.to(d) for t in (uv, uc, uvt, uct))
        out = ops.gcn_aggregate(xd, None, None, 194, blocks)
        before = _build.launch_counts["bcsr_spmm"]
        (gx,) = torch.autograd.grad(out.square().sum(), (xd,))
        grads[str(d)] = gx.cpu()
        if d != "cpu":
            assert _build.launch_counts["bcsr_spmm"] == before + 1
    torch.testing.assert_close(grads[str(dev)], grads["cpu"], **TOL)
    for d in ("cpu", dev):
        ts = [h.to(d).requires_grad_(True) for h in (x[:, :48], x[:, 16:])]
        blocks = tuple(t.to(d) for t in (uv, uc, uvt, uct))
        before = dict(_build.launch_counts)
        out = ops.pna_reduce(*ts, None, None, 194, blocks)
        grads[str(d)] = [o.detach().cpu() for o in out] + [
            t.cpu() for t in torch.autograd.grad(
                sum(o.square().sum() for o in out[:3]), ts)]
        if d != "cpu":
            torch.cuda.synchronize()
            for k in ("pna_reduce_fwd", "pna_reduce_bwd_row",
                      "pna_reduce_bwd_col"):
                assert _build.launch_counts[k] == before[k] + 1, k
    for x, y in zip(grads["cpu"], grads[str(dev)]):
        torch.testing.assert_close(y, x, **TOL)


def test_prefetch_and_push_raw_are_one_kernel(dev):
    """For each store (f32, bf16, int8, vq; 3 layers) on the card and on
    the host: `HistoryStore.prefetch` (every table and scale table) is
    one device kernel, and `push_raw` of the rows one raw kernel beside
    the elementwise ones that mask its index. One torch.profiler window
    for all sixteen calls (late in a long run the profiler misses events,
    and every window brings that nearer), each call's kernels between
    marker kernels (a one-row `scatter_rows`). The pulled rows are
    bitwise the tables', the pushed ones land bitwise."""
    from repro_torch.core.history import HistoryStore
    n1, cases = 2001, []
    g = torch.Generator(device=dev).manual_seed(2)
    for hd in ("f32", "bf16", "int8", "vq"):
        for storage in ("host", "device"):
            store = HistoryStore.create(n1, [64, 64, 64], hd, dev,
                                        storage=storage)
            idx = torch.randperm(n1 - 1, device=dev, generator=g)[:300].to(
                torch.int32)
            for ell in range(3):
                store.push(ell, idx, torch.randn(300, 64, device=dev,
                                                 generator=g),
                           torch.ones(300, dtype=torch.bool, device=dev))
            pull = idx[:274]
            pulled = store.prefetch(pull)
            store.sync()
            for ell, (rows, scl) in enumerate(pulled):
                assert torch.equal(rows.cpu(), ref.gather_rows_raw_ref(
                    store.tables[ell].cpu(), pull.cpu()))
                if scl is not None:
                    assert torch.equal(scl.cpu(), ref.gather_rows_raw_ref(
                        store.scales[ell].cpu(), pull.cpu()))
            cases.append((store, pull, torch.flip(pull, [0]),
                          torch.ones(274, dtype=torch.bool, device=dev),
                          [p[0] for p in pulled],
                          None if store.scales is None else
                          [p[1] for p in pulled]))
    mark = (torch.zeros(2, 8, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.ones(1, 8, device=dev))

    def calls():
        for store, pull, back, mask, rows, scales in cases:
            scatter_rows(*mark)
            store.prefetch(pull)
            scatter_rows(*mark)
            store.push_raw(back, mask, rows, scales)
        scatter_rows(*mark)

    kernels = _device_kernels(calls)
    spans, span = [], None
    for k in kernels:
        if "scatter_rows_last_kernel" in k:
            if span is not None:
                spans.append(span)
            span = []
        elif span is not None:
            span.append(k)
    assert len(spans) == 2 * len(cases), kernels
    for pre, push in zip(spans[0::2], spans[1::2]):
        assert len(pre) == 1 and "gather_rows_raw" in pre[0], pre
        raw = [k for k in push if "rows_raw" in k]
        assert len(raw) == 1 and "scatter_rows_raw" in raw[0], push
    for store, pull, back, mask, rows, scales in cases:
        store.sync()
        at = back.long().cpu()
        for ell, r in enumerate(rows):
            assert torch.equal(store.tables[ell].cpu()[at], r.cpu())
            if scales is not None:
                assert torch.equal(store.scales[ell].cpu()[at],
                                   scales[ell].cpu())


@pytest.mark.parametrize("op", ["gcn", "gat", "pna", "gin", "gcnii",
                                "appnp", "gin+reg+decay"])
def test_train_step_on_card_matches_cpu(dev, op, monkeypatch):
    """Two steps on both devices, each from the same state (the CPU state
    takes the card's before the second): loss, gradients and history
    tables at 1e-4. The update then runs on both devices from the card's
    gradients (fed their own, an element whose gradient sits at rounding
    level moves by lr one way and not the other in AdamW's first steps):
    params at lr * 1e-4 absolute, the moments at 1e-4 relative, as the
    clip's global norm sums the squares in another order on each
    device. GIN, GCNII and APPNP run 3 layers (APPNP's tables are 4
    wide); the last case turns on the Eq. 3 regularizer, whose noise
    both states draw alike (one CPU generator each, seeded the same,
    moved to the device), and `halo_age_decay`."""
    import repro_torch.gnn.model as M
    g = citation_graph(num_nodes=600, num_features=40, num_classes=4,
                       seed=1)
    base = op.split("+")[0]
    extra = dict(reg_delta=0.05, reg_weight=0.05) if "reg" in op else {}
    spec = GNNSpec(op=base, d_in=40, d_hidden=32, num_classes=4,
                   num_layers=2 if base in ("gcn", "gat", "pna") else 3,
                   heads=4, log_deg_mean=1.8 if op == "pna" else 1.0,
                   **extra)
    cfg = R.GASConfig(num_parts=4,
                      halo_age_decay=0.3 if "decay" in op else 0.0)
    gens = {}    # one CPU generator per state's generator
    monkeypatch.setattr(M, "reg_noise", lambda gen, shape, device: torch.randn(
        shape, generator=gens.setdefault(id(gen),
                                         torch.Generator().manual_seed(7))
    ).to(device))
    plans = {d: R.build_plan(g, spec, cfg, device=d) for d in ("cpu", dev)}
    states = {d: R.init_state(p) for d, p in plans.items()}
    for b in (0, 1):
        if b:
            with torch.no_grad():
                for x, y in zip(_state_tensors(states["cpu"]),
                                _state_tensors(states[dev])):
                    x.copy_(y)
        out = {}
        for d, p in plans.items():
            grads, m = R.grads_and_metrics(p, states[d], p.batch(b))
            out[d] = (m["loss"].cpu(), [x.cpu() for x in grads],
                      [t.cpu() for t in states[d].histories.tables])
        (lc, gc, tc), (lg, gg, tg) = out["cpu"], out[dev]
        torch.testing.assert_close(lg, lc, **TOL)
        for x, y in zip(gg, gc):
            torch.testing.assert_close(x, y, **TOL)
        for x, y in zip(tg, tc):
            torch.testing.assert_close(x, y, **TOL)
        R.apply_update(plans[dev], states[dev], [x.to(dev) for x in gg])
        R.apply_update(plans["cpu"], states["cpu"], gg)
        c, k = states["cpu"], states[dev]
        for xs, ys, tol in (
                (k.params, c.params, dict(rtol=1e-6, atol=1e-6)),
                (k.opt_state.m, c.opt_state.m, dict(rtol=1e-4, atol=1e-12)),
                (k.opt_state.v, c.opt_state.v, dict(rtol=1e-4, atol=1e-12))):
            for x, y in zip(tree_leaves(xs), tree_leaves(ys)):
                torch.testing.assert_close(x.cpu(), y, **tol)


def _state_tensors(state):
    opt = state.opt_state
    h = state.histories
    aux = [t for name in ("scales", "codebooks", "cb_counts", "cb_sums")
           for t in getattr(h, name) or []]
    return (tree_leaves(state.params) + tree_leaves(opt.m)
            + tree_leaves(opt.v) + list(h.tables) + aux
            + [h.age, opt.step])


def _assert_tables_close(got, want):
    """Quantized history tables on two devices: int8 dequantized within
    one step s_i per row and 1e-5 of it for the scales' own rounding, bf16
    within one bf16 step at the larger magnitude plus the f32 tables'
    1e-4 (the sentinel row, which takes masked pushes, left out); at
    least 99.9% of the codes equal."""
    n = want.tables[0].shape[0] - 1
    for ell, (a, b) in enumerate(zip(got.tables, want.tables)):
        idx = torch.arange(n, dtype=torch.int32)
        ra = got.pull(ell, idx.to(got.device)).float().cpu()
        rb = want.pull(ell, idx).float()
        step = (want.scales[ell][:n, None] if want.scales is not None
                else torch.maximum(ra.abs(), rb.abs()) * 2.0 ** -7 + 1e-4)
        assert torch.all((ra - rb).abs() <= step * (1 + 1e-5))
        same = (a[:n].cpu() == b[:n]).float().mean().item()
        assert same >= 0.999, same


def _quant_values(rng, m, d):
    """Rows for the quantizing push: normal rows, an all-zero row, rows
    whose v / s land exactly on .5 (ties to even) or on the clip, negative
    zeros, and rows of 1e30 and 1e-30."""
    v = rng.normal(size=(m, d)).astype(np.float32)
    v[0] = 0.0
    v[1] = (rng.integers(-127, 127, d) + 0.5).astype(np.float32)
    v[1, 0] = 127.0                              # s = 1: v / s = v exactly
    v[2] = -0.0
    v[2, d // 2] = -3.0
    v[3] *= 1e30
    v[4] *= 1e-30
    v[5, :] = 127.0
    return v


@pytest.mark.parametrize("d", [256, 64, 20, 130, 6])
def test_int8_row_kernels_match_plain(dev, d):
    """`scatter_rows_q` against its plain version, bitwise: duplicate
    indices (last writer wins, for codes and scales alike), dropped
    out-of-range rows, the sentinel row, ties, clipping and zero rows;
    aligned (D % 4 == 0) and ragged D; a warm repeat bit-identical. The
    push's per-row relative errors at 1e-5. (The pull of the pushed
    table, `gather_rows_dq`, is test_row_pulls_match_plain's.)"""
    rng = np.random.default_rng(d)
    n, m = 301, 220
    v = torch.from_numpy(_quant_values(rng, m, d))
    idx = rng.integers(0, n - 1, m).astype(np.int32)
    idx[10:30] = idx[30:50]                     # duplicates
    idx[60:70] = n - 1                          # masked -> sentinel row
    idx[70:75] = n + 5                          # out of range: dropped
    idx = torch.from_numpy(idx)
    q0 = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8))
    s0 = torch.from_numpy(rng.random(n).astype(np.float32))
    want_q, want_s, want_e = ref.scatter_rows_q_ref(q0.clone(), s0.clone(),
                                                    idx, v)
    # the plain version on the card rounds as on the CPU (a tensor divisor:
    # PyTorch's CUDA division by a Python number multiplies by its inverse)
    on_card = ref.scatter_rows_q_ref(q0.clone().to(dev), s0.clone().to(dev),
                                     idx.to(dev), v.to(dev))
    assert torch.equal(on_card[0].cpu(), want_q)
    assert torch.equal(on_card[1].cpu(), want_s)
    errs = []
    for _ in range(2):
        got_q, got_s, got_e = scatter_rows_q(
            q0.clone().to(dev), s0.clone().to(dev), idx.to(dev), v.to(dev))
        assert torch.equal(got_q.cpu(), want_q)
        assert torch.equal(got_s.cpu(), want_s)
        errs.append(got_e.cpu())
    # each row's relative error, every row (dropped ones too): the same
    # sums in another order, so f32 rounding apart (row 3's squares pass
    # f32's range: NaN on both sides, as in the reference); a warm repeat
    # is bit-identical
    assert torch.isnan(want_e[3]) and int(torch.isnan(want_e).sum()) == 1
    torch.testing.assert_close(errs[0], want_e, rtol=1e-5, atol=1e-7,
                               equal_nan=True)
    assert torch.equal(errs[0].isnan(), errs[1].isnan())
    assert torch.equal(errs[0].nan_to_num(), errs[1].nan_to_num())


@pytest.mark.parametrize("d", [256, 20])
def test_bf16_row_kernels_match_plain(dev, d):
    """The bf16 instantiation of `scatter_rows` (through `ops.push_rows`,
    which rounds the f32 rows to bf16 first) against its plain version,
    bitwise, and its launch counted apart. (The bf16 `gather_rows` is
    test_row_pulls_match_plain's.)"""
    rng = np.random.default_rng(d + 1)
    n, m = 301, 220
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)
                             ).to(torch.bfloat16)
    v = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n - 1, m).astype(np.int32))
    idx[10:30] = idx[30:50].clone()
    mask = torch.from_numpy(rng.random(m) > 0.1)
    want = ops.push_rows(table.clone(), idx, v, mask, scratch_last_row=True)
    got = ops.push_rows(table.clone().to(dev), idx.to(dev), v.to(dev),
                        mask.to(dev), scratch_last_row=True)
    assert torch.equal(got.cpu()[:-1], want[:-1])
    before = dict(_build.launch_counts)
    scatter_rows(got, idx[:4].to(dev), v[:4].to(dev, torch.bfloat16))
    assert _build.launch_counts["scatter_rows_bf16"] == \
        before["scatter_rows_bf16"] + 1


ROW_PULL_D = (1, 3, 4, 6, 8, 16, 20, 64, 125, 130, 256, 500)
ROW_PULL_M = (1, 7, 8, 9, 4096)
# the vq pull's codes a row (subvectors of 8): one to 63, one lane's units
# and several, rows sharing a warp and a warp's single pass
ROW_PULL_S = (1, 2, 3, 4, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63)
ROW_PULL_NAME = {"f32": "gather_rows", "bf16": "gather_rows_bf16",
                 "int8": "gather_rows_dq", "vq": "gather_rows_vq"}


def _bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype])


@pytest.mark.parametrize("m", ROW_PULL_M)
@pytest.mark.parametrize("kind,d", [(k, d) for k in ("f32", "bf16", "int8")
                                    for d in ROW_PULL_D]
                         + [("vq", 8 * s) for s in ROW_PULL_S])
def test_row_pulls_match_plain(dev, kind, d, m):
    """`gather_rows` over f32 and bf16 tables, `gather_rows_dq` over int8
    ones and `gather_rows_vq` over vq codes, bitwise their plain versions
    at the edges of their launch plans (`kernels/gather.py` `row_plan`,
    `dq_plan`, `vq_plan`): rows of 1 to 500 elements (ragged, narrower
    than a unit, sharing a warp, several passes a lane; vq: 1 to 63
    codes), 1 to 4,096 rows (one warp part full, one full, one past it, a
    wave); a table view offset by one element, and an output offset by
    one element (through the wrappers' launch helpers, since the wrappers
    allocate aligned outputs), each breaking 16-byte units (the vq
    decode's float4 stores refuse it); duplicate indices, index N - 1 and
    indices -7, N and N + 3, which the kernels clip; NaN, inf and -0.0
    entries copied bit for bit (vq codebooks: -0.0, subnormal and huge
    entries; a NaN product would take the card's canonical NaN), scales
    from 0 and subnormal to overflowing products; exactly one launch per
    call; a warm repeat bit-identical."""
    from repro_torch.kernels.gather import _decode, _dequant, _row_copy
    rng = np.random.default_rng(1000 * d + m)
    n, name = 301, ROW_PULL_NAME[kind]
    idx = rng.integers(0, n, m).astype(np.int32)
    k = min(m, 4)
    idx[:k] = (n - 1, -7, n, n + 3)[:k]
    idx[-1] = idx[m // 2]
    idx_c = torch.from_numpy(idx)
    idx_d = idx_c.to(dev)
    width = d // 8 if kind == "vq" else d
    if kind in ("int8", "vq"):
        s = (rng.random(n) * 10.0 ** rng.integers(-40, 38, n)).astype(
            np.float32)
        s[:3] = (0.0, 1e-40, 3e38)
        scales = torch.from_numpy(s)
        scales_d = scales.to(dev)
        out_dtype = torch.float32
    if kind == "int8":
        flat = torch.from_numpy(rng.integers(-128, 128, n * d + 1,
                                             dtype=np.int8))

        def plain(t):
            return ref.gather_rows_dq_ref(t, scales, idx_c)

        def pull(t):
            return gather_rows_dq(t, scales_d, idx_d)

        def pull_into(t, out):
            return _dequant(t, scales_d, idx_d, out)
    elif kind == "vq":
        flat = torch.from_numpy(rng.integers(0, 256, n * width + 1,
                                             dtype=np.uint8))
        c = rng.normal(size=(width, 256, 8)).astype(np.float32)
        c[0, 1, :3] = (-0.0, 1e-40, 3e38)   # no NaN: the card's is canonical
        cb = torch.from_numpy(c)
        cb_d = cb.to(dev)

        def plain(t):
            return ref.gather_rows_vq_ref(t, cb, scales, idx_c)

        def pull(t):
            return gather_rows_vq(t, cb_d, scales_d, idx_d)

        def pull_into(t, out):
            return _decode(t, cb_d, scales_d, idx_d, out)
    else:
        v = rng.normal(size=n * d + 1).astype(np.float32)
        v[:4] = (np.nan, np.inf, -0.0, -np.inf)
        flat = torch.from_numpy(v).to(
            torch.bfloat16 if kind == "bf16" else torch.float32)

        def plain(t):
            return ref.gather_rows_ref(t, idx_c)

        def pull(t):
            return gather_rows(t, idx_d)

        def pull_into(t, out):
            return _row_copy(name, t, idx_d, out)

        out_dtype = flat.dtype
    flat_d = flat.to(dev)
    for t_off, o_off in ((0, 0), (1, 0), (0, 1)):
        case = (kind, d, m, t_off, o_off)
        table_d = flat_d[t_off:t_off + n * width].view(n, width)
        want = _bits(plain(flat[t_off:t_off + n * width].view(n, width)))
        before = _build.launch_counts[name]
        if o_off:
            buf = torch.empty(m * d + 1, dtype=out_dtype, device=dev)
            if kind == "vq":
                with pytest.raises(RuntimeError, match="misaligned"):
                    pull_into(table_d, buf[1:].view(m, d))
                assert _build.launch_counts[name] == before, case
                continue
            got = pull_into(table_d, buf[1:].view(m, d))
        else:
            got = pull(table_d)
        torch.cuda.synchronize()
        assert _build.launch_counts[name] == before + 1, case
        assert got.dtype == out_dtype and got.shape == (m, d), case
        assert torch.equal(_bits(got).cpu(), want), case
        if not (t_off or o_off):
            assert torch.equal(_bits(pull(table_d)), _bits(got)), case


@pytest.mark.parametrize("hd", ["f32", "bf16", "int8", "vq"])
def test_pull_rows_is_one_device_kernel(dev, hd):
    """`ops.pull_rows`, the history pull of every store, given int32
    indices (as the batches hold them) with -7, N and N + 3 among them:
    torch.profiler sees exactly one device kernel a call, the pull's own
    (the clip runs inside it), and the rows are bitwise the plain
    version's."""
    rng = np.random.default_rng(7)
    n, d, m = 301, 64, 274
    idx = rng.integers(0, n, m).astype(np.int32)
    idx[:3] = (-7, n, n + 3)
    v = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    kw = {}
    if hd in ("f32", "bf16"):
        table = v.to(torch.bfloat16) if hd == "bf16" else v
    elif hd == "int8":
        table, s = ref.quantize_rows(v)
        kw = dict(scales=s)
    else:
        cb = vq_init_codebook(d, device="cpu")
        table, s = ref.vq_encode_rows(v, cb)
        kw = dict(scales=s, codebook=cb)
    want = ops.pull_rows(table, torch.from_numpy(idx), **kw)
    table_d, idx_d = table.to(dev), torch.from_numpy(idx).to(dev)
    kw_d = {k: t.to(dev) for k, t in kw.items()}
    got = ops.pull_rows(table_d, idx_d, **kw_d)
    assert torch.equal(_bits(got).cpu(), _bits(want))
    kernels = _device_kernels(lambda: ops.pull_rows(table_d, idx_d, **kw_d))
    assert len(kernels) == 1 and "gather_rows" in kernels[0], kernels


@pytest.mark.parametrize("op", ["gcn", "gat", "pna", "gin", "gcnii",
                                "appnp"])
def test_full_forward_bitwise_across_runs(dev, op):
    """`full_forward` (the full-graph route of `evaluate_exact` and of
    serving's SLO=0 check: every per-destination sum through
    `ref.segment_sum`) twice on fresh copies of the features and the
    COO, another allocation between them so that the second lands
    elsewhere: the two outputs bitwise equal. Atomic adds would order
    each destination's sum by arrival."""
    g = citation_graph(num_nodes=6000, num_features=96, num_classes=3,
                       seed=2)
    spec = GNNSpec(op=op, d_in=96, d_hidden=48 if op == "pna" else 64,
                   num_classes=3, num_layers=3, heads=4,
                   log_deg_mean=1.8 if op == "pna" else 1.0)
    params = gnn_model.init_gnn(spec, seed=0, device=dev)
    dst, src, w = gcn_edge_weights(g)
    outs, spacers = [], []
    for _ in range(2):
        x = torch.from_numpy(g.x).to(dev)
        coo = (torch.from_numpy(dst).to(dev), torch.from_numpy(src).to(dev))
        ew = torch.from_numpy(w).to(dev)
        outs.append(gnn_model.full_forward(params, spec, x, coo, ew,
                                           g.num_nodes))
        spacers.append(torch.empty(12345, device=dev))
    torch.cuda.synchronize()
    assert outs[0].shape == (g.num_nodes, 3)
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(_bits(outs[0]), _bits(outs[1])), \
        float((outs[0] - outs[1]).abs().max())


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("d", [256, 20])
def test_quantized_gather_spmm_matches_plain(dev, dtype, d):
    """The int8 body (`gather_spmm_dq`) and the bf16 instantiation of
    `gather_spmm` against the plain version over a real batch's blocks
    and gather plan; a warm repeat bit-identical."""
    g = citation_graph(num_nodes=600, num_features=8, num_classes=3,
                       seed=2)
    from repro_torch.core import gas as G
    from repro_torch.core.partition import metis_like_partition
    part = metis_like_partition(g.indptr, g.indices, 3)
    b = G.build_batches(g, part, build_blocks=True).to("cpu")[0]
    rng = np.random.default_rng(d)
    n_table = g.num_nodes + 1
    x_in = torch.from_numpy(rng.normal(size=(b.max_b, d)).astype(np.float32))
    rows = torch.from_numpy(rng.normal(size=(n_table, d)).astype(np.float32))
    if dtype == "int8":
        table, scales = ref.quantize_rows(rows)
    else:
        table, scales = rows.to(torch.bfloat16), None
    vals, cols = b.forward.vals, b.forward.cols
    plan = gather_plan(cols, b.halo_nodes, b.halo_mask, b.max_b, n_table)
    assert set(torch.unique(plan[0]).tolist()) == {0, 1, 2}
    want = ref.gather_spmm_ref(x_in, table, vals, cols, *plan, scales)
    on = lambda t: None if t is None else t.to(dev)  # noqa: E731
    args = [on(t) for t in (x_in, table, vals, cols, *plan)]
    name = "gather_spmm_dq" if dtype == "int8" else "gather_spmm_bf16"
    before = _build.launch_counts[name]
    got = gather_spmm(*args, scales=on(scales))
    torch.testing.assert_close(got.cpu(), want, **TOL)
    assert torch.equal(gather_spmm(*args, scales=on(scales)), got)
    assert _build.launch_counts[name] == before + 2


@pytest.mark.parametrize("history_dtype", ["int8", "bf16"])
@pytest.mark.parametrize("op", ["gcn", "gat"])
def test_quantized_train_step_on_card_matches_cpu(dev, op, history_dtype):
    """Two steps over an int8 or bf16 store on both devices, each from the
    same state: loss and gradients at 1e-4, the tables within one
    quantization step per row with >= 99.9% of the codes equal, and the
    quantized path's kernels launched (GCN: gather_spmm_dq or
    gather_spmm_bf16; GAT: gather_rows_dq or gather_rows_bf16; both:
    scatter_rows_q or scatter_rows_bf16)."""
    g = citation_graph(num_nodes=600, num_features=40, num_classes=4,
                       seed=1)
    spec = GNNSpec(op=op, d_in=40, d_hidden=32, num_classes=4,
                   num_layers=2, heads=4)
    cfg = R.GASConfig(num_parts=4, history_dtype=history_dtype)
    plans = {d: R.build_plan(g, spec, cfg, device=d) for d in ("cpu", dev)}
    states = {d: R.init_state(p) for d, p in plans.items()}
    before = dict(_build.launch_counts)
    for b in (0, 1):
        if b:
            with torch.no_grad():
                for x, y in zip(_state_tensors(states["cpu"]),
                                _state_tensors(states[dev])):
                    x.copy_(y)
        out = {}
        for d, p in plans.items():
            grads, m = R.grads_and_metrics(p, states[d], p.batch(b))
            out[d] = (m["loss"].cpu(), [x.cpu() for x in grads],
                      m["hist_quant_err"].cpu())
        for x, y in zip(out[dev], out["cpu"]):
            for a, c in zip(x if isinstance(x, list) else [x],
                            y if isinstance(y, list) else [y]):
                torch.testing.assert_close(a, c, **TOL)
        _assert_tables_close(states[dev].histories, states["cpu"].histories)
    ran = {k for k in _build.launch_counts
           if _build.launch_counts[k] > before[k]}
    sfx = "_q" if history_dtype == "int8" else "_bf16"
    read = ("gather_spmm" if op == "gcn" else "gather_rows") + (
        "_dq" if history_dtype == "int8" else "_bf16")
    assert {"scatter_rows" + sfx, read} <= ran, ran


def test_bcsr_spmm_on_transposed_blocks(dev):
    """The GCN backward's use of bcsr_spmm: the transposed family (more
    row blocks than columns) against the plain version."""
    (_, _, vt, ct), rng = _blocks(9, 260, 700, 2000)
    gout = torch.from_numpy(rng.normal(size=(260, 64)).astype(np.float32))
    got = bcsr_spmm(gout.to(dev), vt.to(dev), ct.to(dev))
    torch.testing.assert_close(got.cpu(), ref.bcsr_spmm_ref(gout, vt, ct),
                               **TOL)


def _sparse_blocks(seed, R, K, density, n_cb):
    """Blocks [R, K, 128, 128] with each entry nonzero (uniform in (0, 1])
    with probability `density`, and column ids over n_cb column blocks."""
    rng = np.random.default_rng(seed)
    keep = rng.random((R, K, 128, 128)) < density
    vals = np.where(keep, 1.0 - rng.random((R, K, 128, 128)), 0.0)
    cols = rng.integers(0, n_cb, (R, K))
    return (torch.from_numpy(vals.astype(np.float32)),
            torch.from_numpy(cols.astype(np.int32)), rng)


# serving's refresh blocks hold ~0.05% nonzeros, training's ~0.6%
DENSITIES = {"serving": 5e-4, "training": 6e-3, "dense": 1.0, "zero": 0.0}


@pytest.mark.parametrize("K", [1, 76])
@pytest.mark.parametrize("d", [1, 7, 64, 130, 256, 500, 513, 1433])
@pytest.mark.parametrize("density", list(DENSITIES))
def test_bcsr_spmm_matches_plain(dev, density, d, K):
    """The block contraction against its plain version on the card, over
    the density of serving's and training's blocks, fully dense and all
    zero blocks; ragged D, more than one 512-column tile (513, 1433), x
    rows that stop short of a whole block; a warm repeat bitwise."""
    vals, cols, rng = _sparse_blocks(d * 100 + K, 2, K,
                                     DENSITIES[density], 4)
    n_x = 4 * 128 - 37               # column block 3 ragged
    x = torch.from_numpy(rng.normal(size=(n_x, d)).astype(np.float32))
    if density == "dense":
        # 9,728 terms an output: on a grid (block values k/8, x integers)
        # every order of summation is exact, so the check holds the terms
        # and not the order of the sums (~1e-3 apart otherwise)
        vals, x = torch.ceil(vals * 8) / 8, torch.round(x * 4)
    args = [t.to(dev) for t in (x, vals, cols)]
    before = _build.launch_counts["bcsr_spmm"]
    got = bcsr_spmm(*args)
    want = ref.bcsr_spmm_ref(*args)
    assert got.shape == (2 * 128, d)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(bcsr_spmm(*args), got)
    assert _build.launch_counts["bcsr_spmm"] == before + 2


@pytest.mark.parametrize("d", [256, 72])
@pytest.mark.parametrize("body", ["f32", "bf16", "int8", "vq"])
def test_gather_spmm_bodies_on_sparse_blocks(dev, body, d):
    """The four bodies of gather_spmm over serving-like sparse blocks whose
    plan mixes in-batch rows (sel 0), table rows (sel 1) and zeros (sel 2),
    against the plain version; a warm repeat bitwise."""
    vals, cols, rng = _sparse_blocks(d, 3, 40, 2e-3, 8)
    n_in, n_table = 300, 500
    halo = torch.from_numpy(rng.integers(0, n_table, 8 * 128 - n_in)
                            .astype(np.int32))
    mask = torch.from_numpy(rng.random(halo.shape[0]) < 0.7)
    plan = gather_plan(cols, halo, mask, n_in, n_table)
    assert set(torch.unique(plan[0]).tolist()) == {0, 1, 2}
    x_in = torch.from_numpy(rng.normal(size=(n_in, d)).astype(np.float32))
    rows = torch.from_numpy(rng.normal(size=(n_table, d)).astype(np.float32))
    scales = cb = None
    if body == "f32":
        table = rows
    elif body == "bf16":
        table = rows.to(torch.bfloat16)
    elif body == "int8":
        table, scales = ref.quantize_rows(rows)
    else:
        cb = vq_init_codebook(d, device="cpu")
        table, scales = ref.vq_encode_rows(rows, cb)
    on = lambda t: None if t is None else t.to(dev)  # noqa: E731
    args = [on(t) for t in (x_in, table, vals, cols, *plan)]
    kw = dict(scales=on(scales), codebook=on(cb))
    name = {"f32": "gather_spmm", "bf16": "gather_spmm_bf16",
            "int8": "gather_spmm_dq", "vq": "gather_spmm_vq"}[body]
    before = _build.launch_counts[name]
    got = gather_spmm(*args, **kw)
    torch.testing.assert_close(got, ref.gather_spmm_ref(*args, **kw), **TOL)
    assert torch.equal(gather_spmm(*args, **kw), got)
    assert _build.launch_counts[name] == before + 2


@pytest.mark.parametrize("d", [6, 48])
@pytest.mark.parametrize("family", ["forward", "unit"])
def test_f32_gather_spmm_on_training_blocks(dev, family, d):
    """The f32 body of `gather_spmm` at the operands of the zoo's fused
    layers: d = 6 (APPNP's class-score tables, a row shorter than one
    16-byte piece) and d = 48 (GIN and GCNII), over a training batch's
    forward blocks and its unit-weight blocks (GIN's), then `bcsr_spmm`
    on the transposed family (the backward); against the plain versions
    at 1e-4, a warm repeat bitwise, one launch each."""
    from repro_torch.core import gas as G
    from repro_torch.core.partition import metis_like_partition
    g = citation_graph(num_nodes=600, num_features=8, num_classes=3,
                       seed=4)
    part = metis_like_partition(g.indptr, g.indices, 3)
    b = G.build_batches(g, part, build_blocks=True,
                        unit_weights=family == "unit").to("cpu")[0]
    fam = b.unit if family == "unit" else b.forward
    fam_t = b.unit_transposed if family == "unit" else b.transposed
    rng = np.random.default_rng(d)
    n_table = g.num_nodes + 1
    x_in = torch.from_numpy(rng.normal(size=(b.max_b, d)).astype(np.float32))
    table = torch.from_numpy(rng.normal(size=(n_table, d)).astype(np.float32))
    plan = gather_plan(fam.cols, b.halo_nodes, b.halo_mask, b.max_b, n_table)
    assert set(torch.unique(plan[0]).tolist()) == {0, 1, 2}
    want = ref.gather_spmm_ref(x_in, table, fam.vals, fam.cols, *plan)
    args = [t.to(dev) for t in (x_in, table, fam.vals, fam.cols, *plan)]
    before = dict(_build.launch_counts)
    got = gather_spmm(*args)
    torch.testing.assert_close(got.cpu(), want, **TOL)
    assert torch.equal(gather_spmm(*args), got)
    gcot = torch.from_numpy(rng.normal(size=tuple(want.shape)).astype(
        np.float32))
    dx = bcsr_spmm(gcot.to(dev), fam_t.vals.to(dev), fam_t.cols.to(dev))
    torch.testing.assert_close(dx.cpu(), ref.bcsr_spmm_ref(
        gcot, fam_t.vals, fam_t.cols), **TOL)
    torch.cuda.synchronize()
    assert _build.launch_counts["gather_spmm"] == before["gather_spmm"] + 2
    assert _build.launch_counts["bcsr_spmm"] == before["bcsr_spmm"] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gas_aggregate_table_gradient_on_card(dev, dtype):
    """`ops.gas_aggregate` differentiated w.r.t. x_in and a float table on
    the card against the same on the CPU (a real batch's blocks at
    APPNP's d = 6): dx_in at 1e-4, the table's gradient (the transposed
    product's halo rows index-added at the halo ids) at 1e-4 in f32 and
    within one bf16 step in bf16; one `bcsr_spmm` launch for the
    backward."""
    from repro_torch.core import gas as G
    from repro_torch.core.partition import metis_like_partition
    g = citation_graph(num_nodes=600, num_features=8, num_classes=3,
                       seed=5)
    part = metis_like_partition(g.indptr, g.indices, 3)
    b = G.build_batches(g, part, build_blocks=True).to("cpu")[1]
    rng = np.random.default_rng(11)
    d, n_table = 6, g.num_nodes + 1
    x_in = torch.from_numpy(rng.normal(size=(b.max_b, d)).astype(np.float32))
    table = torch.from_numpy(rng.normal(size=(n_table, d)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(b.max_b, d)).astype(np.float32))
    out = {}
    for where in ("cpu", dev):
        on = lambda t: t.to(where)  # noqa: E731
        xi = on(x_in).requires_grad_(True)
        tb = on(table).to(dtype).requires_grad_(True)
        blocks = tuple(on(t) for t in b.blocks)
        res = ops.gas_aggregate(xi, tb, on(b.halo_nodes), on(b.halo_mask),
                                b.max_b, blocks)
        before = _build.launch_counts["bcsr_spmm"]
        grads = torch.autograd.grad((res.float() * on(cot)).sum(), (xi, tb))
        if where != "cpu":
            torch.cuda.synchronize()
            assert _build.launch_counts["bcsr_spmm"] == before + 1
        out[str(where)] = [t.detach().float().cpu() for t in (res,) + grads]
    (o_c, dx_c, dt_c), (o_k, dx_k, dt_k) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(o_k, o_c, **(TOL if dtype == torch.float32
                                            else dict(rtol=1e-3, atol=1e-3)))
    torch.testing.assert_close(dx_k, dx_c, **TOL)
    assert dt_c.abs().sum() > 0
    if dtype == torch.float32:
        torch.testing.assert_close(dt_k, dt_c, **TOL)
    else:
        torch.testing.assert_close(dt_k, dt_c, rtol=2.0 ** -7, atol=1e-4)


@pytest.mark.parametrize("kernel", ["bcsr_spmm", "gather_spmm"])
def test_contraction_skips_zero_entries_of_non_finite_rows(dev, kernel):
    """The kernels' one departure from the plain version: a non-finite row
    that only zero entries reach stays out of the output (the plain
    version gives 0 * inf = NaN there), while one that a nonzero entry
    reaches spreads as in the plain version."""
    vals, cols, rng = _sparse_blocks(11, 2, 3, 0.05, 2)
    cols = torch.tensor([[0, 1, 0], [1, 0, 1]], dtype=torch.int32)
    d = 40
    x = torch.from_numpy(rng.normal(size=(256, d)).astype(np.float32))
    # rows 5 (inf) and 130 (NaN) are reached by zero entries only; row 77
    # (inf) by one nonzero entry, of output row 3
    for v in (vals[0, 0], vals[0, 2], vals[1, 1]):
        v[:, 5] = 0.0
        v[:, 77] = 0.0
    for v in (vals[0, 1], vals[1, 0], vals[1, 2]):
        v[:, 2] = 0.0
    vals[0, 0, 3, 77] = 0.5
    bad = x.clone()
    bad[5], bad[130], bad[77] = float("inf"), float("nan"), float("inf")
    finite = bad.clone()         # what every output row but 3 may see
    finite[5], finite[130], finite[77] = 0.0, 0.0, 0.0
    if kernel == "bcsr_spmm":
        run = lambda x_: bcsr_spmm(x_.to(dev), vals.to(dev),  # noqa: E731
                                   cols.to(dev))
        plain = lambda x_: ref.bcsr_spmm_ref(x_, vals, cols)  # noqa: E731
    else:
        plan = gather_plan(cols, torch.zeros(1, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.bool), 256, 1)
        table = torch.zeros((1, d))
        run = lambda x_: gather_spmm(  # noqa: E731
            x_.to(dev), table.to(dev), vals.to(dev), cols.to(dev),
            *(p.to(dev) for p in plan))
        plain = lambda x_: ref.gather_spmm_ref(  # noqa: E731
            x_, table, vals, cols, *plan)
    got = run(bad).cpu()
    assert not torch.isfinite(plain(bad)).all()      # the plain version: NaN
    assert torch.isinf(got[3]).any()                 # the nonzero's row
    rest = torch.ones(256, dtype=torch.bool)
    rest[3] = False
    assert torch.isfinite(got[rest]).all()
    torch.testing.assert_close(got[rest], plain(finite)[rest], **TOL)


def _vq_values(rng, m, d, cb):
    """Rows for the encoding push: normal rows, an all-zero row, a row of
    negative zeros with one value, rows of 1e15 and 1e-15, and rows whose
    subvectors sit a few ulps from the midpoint of two entries (max 1.0)."""
    v = rng.normal(size=(m, d)).astype(np.float32)
    v[1] = 0.0
    v[2] = -0.0
    v[2, d // 2] = -3.0
    v[3] *= 1e15
    v[4] *= 1e-15
    s_n = d // 8
    for i in range(5, m, 3):
        a, b = rng.integers(0, 256, (2, s_n))
        mid = ((cb[np.arange(s_n), a] + cb[np.arange(s_n), b]) / 2.0
               ).astype(np.float32)
        mid = np.nextafter(mid, np.where(rng.random(mid.shape) < 0.5,
                                         -np.inf, np.inf).astype(np.float32))
        v[i] = mid.reshape(d)
        v[i, -1] = 1.0
    return v


def _in_child(name, **kw):
    """`_child_<name>(**kw)` of this file run in a Python process of its
    own on the card (`python tests/test_torch_cuda.py NAME JSON`); its
    JSON result. A count of device kernels taken there sees a profiler
    that has not gone blind late in a long run (ROADMAP Queue B notes),
    and a CUDA graph's capture there leaves this process as it was."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, __file__, name, json.dumps(kw)],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _marked_segments(fns):
    """(the device events of each call of `fns`, names in start order;
    every event of the window): all in one torch.profiler window, each
    call between marker kernels (`torch.cuda._sleep`'s `spin_kernel`);
    raises if the profiler missed a marker. The window opens with one
    more marker, alone: the profiler may drop the first device event of
    a window, even early in a process."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for fn in fns:
            torch.cuda._sleep(1000)
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    segments, cur = [], None
    for e in events:
        if "spin_kernel" in e.name:
            if cur is not None:
                segments.append(cur)
            cur = []
        elif cur is not None:
            cur.append(e.name)
    if len(segments) == len(fns) + 1 and not segments[0]:
        segments = segments[1:]          # the opening marker was seen
    if len(segments) != len(fns):
        raise RuntimeError(f"the profiler saw {len(segments) + 1} of "
                           f"{len(fns) + 2} marker kernels")
    return segments, prof.events()


def _device_kernels(fn, windows=3):
    """The names of the device kernels one call of `fn` ran
    (torch.profiler). A marker kernel (`torch.cuda._sleep`'s
    `spin_kernel`) runs first in the window and is left out: late in a
    long run the profiler drops the first device event of a window. A
    window in which it saw no device event at all, the marker included,
    observed nothing (it can go blind late in a long run) and is taken
    again, up to `windows` windows; `fn` must be safe to repeat."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(windows):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return [n for n in names if "spin_kernel" not in n]


# entries of the test codebook made exact copies of lower ones (tie ->
# first): in one lane's range and across the ranges of a split pair
_VQ_TIES = ((1, 255), (100, 128), (33, 40))
# the lane split each push below takes on a card of 132 SMs (an H100 SXM)
# through the public plan: 8 lanes for 1 row, 194 (the training push) and
# 1,024 rows of 8 subvectors (the most the plan splits), 1 for 2,501 rows
# (the GCN refit push) and 4,097 (the claim passes)
_VQ_LANES_132 = {(256, 1): 8, (64, 194): 8, (64, 1024): 8, (64, 2501): 1,
                 (256, 4097): 1}


@pytest.mark.parametrize("d,m", [
    pytest.param(2048, 220, id="2048"), pytest.param(256, 220, id="256"),
    pytest.param(64, 220, id="64"), pytest.param(16, 220, id="16"),
    (256, 1), (64, 194), (64, 1024), (64, 2501), (256, 4097)])
def test_vq_row_kernels_match_plain(dev, d, m):
    """`scatter_rows_vq` and `gather_rows_vq` against their plain versions,
    bitwise (d = 2048: 256 subvectors, 16 a warp): table codes, scales and
    every pushed row's codes, with duplicate indices (last writer wins,
    codes and scale alike), dropped out-of-range rows, the sentinel row,
    zero rows and near-tie rows; the decoded rows; a warm repeat
    bit-identical. The push's per-row errors at 1e-5. The plain encode on
    the card is bitwise the CPU's. The four widths at 220 rows keep their
    data (seed d, the codebook as made). The further pushes reach every
    lane split of the plan on an H100 (_VQ_LANES_132) and add exact ties:
    three entries of the codebook are copies of lower ones, and rows made
    of a lower entry must take the lower index (the first minimum, within
    one lane's range and across the ranges of a split pair). Every push of
    at most SCAN_MAX_ROWS rows runs one device kernel, 4,097 rows the
    claim passes first (three): the launch counter and torch.profiler,
    which must see the card."""
    ties = m != 220
    rng = np.random.default_rng(d + m if ties else d)
    n = 301
    s_n = d // 8
    cb = vq_init_codebook(d, device="cpu")
    lanes = scatter_rows_vq_plan(m, s_n, _sm_count(torch.device(dev)))[0]
    if ties:
        for lo, hi in _VQ_TIES:
            cb[:, hi] = cb[:, lo]
        if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
            assert lanes == _VQ_LANES_132[(d, m)]
    v = _vq_values(rng, max(m, 5), d, cb.numpy())[:m]
    tie_rows = {}               # row -> the lower entry of each subvector
    for i in range(6, m if ties else 0, 9):  # each subvector a lower tied
        lo = np.array(_VQ_TIES)[rng.integers(0, len(_VQ_TIES), s_n), 0]
        v[i] = cb.numpy()[np.arange(s_n), lo].reshape(d)   # entry exactly
        v[i, -1] = 1.0          # s_i = 1 (entries lie in [-1, 1)), u = v
        tie_rows[i] = lo
    v = torch.from_numpy(v)
    idx = rng.integers(0, n - 1, m).astype(np.int32)
    if m >= 75:
        idx[10:30] = idx[30:50]                 # duplicates
        idx[60:70] = n - 1                      # masked -> sentinel row
        idx[70:75] = n + 5                      # out of range: dropped
    idx = torch.from_numpy(idx)
    q0 = torch.from_numpy(rng.integers(0, 256, (n, s_n)).astype(np.uint8))
    s0 = torch.from_numpy(rng.random(n).astype(np.float32))
    want = ref.scatter_rows_vq_ref(q0.clone(), s0.clone(), idx, v, cb)
    for i, lo in tie_rows.items():  # the last subvector holds the 1.0
        assert want[2][i, :-1].tolist() == lo[:-1].tolist(), i
    on_card = ref.scatter_rows_vq_ref(q0.clone().to(dev), s0.clone().to(dev),
                                      idx.to(dev), v.to(dev), cb.to(dev))
    for a, b in zip(on_card[:3], want[:3]):
        assert torch.equal(a.cpu(), b)
    args = (idx.to(dev), v.to(dev), cb.to(dev))
    errs = []
    for _ in range(2):
        before = _build.launch_counts["scatter_rows_vq"]
        got = scatter_rows_vq(q0.clone().to(dev), s0.clone().to(dev), *args)
        torch.cuda.synchronize()
        assert _build.launch_counts["scatter_rows_vq"] == before + 1
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a.cpu(), b)
        errs.append(got[3].cpu())
    torch.testing.assert_close(errs[0], want[3], rtol=1e-5, atol=1e-7)
    assert torch.equal(errs[0], errs[1])
    q1, s1 = q0.clone().to(dev), s0.clone().to(dev)
    kernels = _device_kernels(lambda: scatter_rows_vq(q1, s1, *args))
    assert len(kernels) == (1 if m <= SCAN_MAX_ROWS else 3), (lanes, kernels)
    gidx = torch.from_numpy(rng.integers(0, n, 500).astype(np.int32))
    plain = ref.gather_rows_vq_ref(want[0], cb, want[1], gidx)
    for _ in range(2):
        out = gather_rows_vq(got[0], cb.to(dev), got[1], gidx.to(dev))
        assert out.shape == (500, d) and torch.equal(out.cpu(), plain)


def test_vq_push_non_finite_rows(dev):
    """Rows holding inf, -inf or NaN, beside finite ones, at the serving
    width (d = 256) and the training push's (d = 64, split lanes). An inf
    row's codes and scale are bitwise the plain version's (s = inf, so u
    is 0 or NaN: code 0 everywhere). A NaN row departs from it as documented in
    csrc/scatter.cu, as the kernel before this design did: the scale is
    the max of the row's other |values| (fmaxf skips a NaN; the plain
    amax gives NaN and then 1), the codes are the plain search's on u = v
    / that scale (a subvector holding the NaN takes code 0 in both). Every
    non-finite row's error is NaN in both."""
    for d, m in ((256, 64), (64, 194)):
        rng = np.random.default_rng(d)
        cb = vq_init_codebook(d, device="cpu")
        v = rng.normal(size=(m, d)).astype(np.float32)
        v[3, 5] = np.inf
        v[4, d - 1] = -np.inf
        v[5, 9] = np.nan
        v[6, :] = np.nan
        v[7, 0], v[7, 1] = np.nan, np.inf
        nan_rows = [5, 6, 7]
        v = torch.from_numpy(v)
        idx = torch.from_numpy(rng.permutation(m).astype(np.int32))
        n = m + 1
        q0 = torch.zeros((n, d // 8), dtype=torch.uint8)
        s0 = torch.zeros((n,), dtype=torch.float32)
        want = ref.scatter_rows_vq_ref(q0.clone(), s0.clone(), idx, v, cb)
        amax = torch.where(torch.isnan(v), 0.0, v.abs()).amax(1)
        scale = torch.where(amax > 0, amax, torch.ones_like(amax))
        codes = ref.vq_nearest((v / scale[:, None]).view(m, d // 8, 8), cb)
        assert torch.equal(codes[:5], want[2][:5])   # finite and inf rows
        got = [t.cpu() for t in scatter_rows_vq(
            q0.clone().to(dev), s0.clone().to(dev), idx.to(dev), v.to(dev),
            cb.to(dev))]
        assert torch.equal(got[2], codes)
        tgt = idx.long()
        assert torch.equal(got[0][tgt], codes)
        assert torch.equal(got[1][tgt], scale)
        keep = torch.ones(m, dtype=torch.bool)
        keep[nan_rows] = False
        assert torch.equal(got[2][keep], want[2][keep])
        assert torch.equal(got[1][tgt[keep]], want[1][tgt[keep]])
        finite = torch.isfinite(v).all(1)
        assert finite.sum() == m - 5
        assert torch.isnan(got[3][~finite]).all()
        assert torch.isnan(want[3][~finite]).all()
        torch.testing.assert_close(got[3][finite], want[3][finite],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("d", [256, 64])
def test_vq_gather_spmm_matches_plain(dev, d):
    """The vq body (`gather_spmm_vq`) against the plain version over a real
    batch's blocks and gather plan, at 1e-5; at d = 256 its codebook is
    256 KB, more than a CTA's shared memory (it is read through L2); a
    warm repeat bit-identical."""
    g = citation_graph(num_nodes=600, num_features=8, num_classes=3,
                       seed=2)
    from repro_torch.core import gas as G
    from repro_torch.core.partition import metis_like_partition
    part = metis_like_partition(g.indptr, g.indices, 3)
    b = G.build_batches(g, part, build_blocks=True).to("cpu")[0]
    rng = np.random.default_rng(d)
    n_table = g.num_nodes + 1
    x_in = torch.from_numpy(rng.normal(size=(b.max_b, d)).astype(np.float32))
    rows = torch.from_numpy(rng.normal(size=(n_table, d)).astype(np.float32))
    cb = vq_init_codebook(d, device="cpu")
    table, scales = ref.vq_encode_rows(rows, cb)
    vals, cols = b.forward.vals, b.forward.cols
    plan = gather_plan(cols, b.halo_nodes, b.halo_mask, b.max_b, n_table)
    assert set(torch.unique(plan[0]).tolist()) == {0, 1, 2}
    want = ref.gather_spmm_ref(x_in, table, vals, cols, *plan, scales, cb)
    args = [t.to(dev) for t in (x_in, table, vals, cols, *plan)]
    before = _build.launch_counts["gather_spmm_vq"]
    got = gather_spmm(*args, scales=scales.to(dev), codebook=cb.to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(gather_spmm(*args, scales=scales.to(dev),
                                   codebook=cb.to(dev)), got)
    assert _build.launch_counts["gather_spmm_vq"] == before + 2


def test_vq_refit_on_card_matches_cpu(dev):
    """A store after pushes on the card, copied to the CPU: the refit on
    the card (through gather_rows_vq and scatter_rows_vq over every row)
    against the same refit on the CPU: codebooks at 1e-6, entry 0 zero,
    >= 99.9% of the codes equal, the statistics zeroed."""
    from repro_torch.core.history import HistoryStore
    rng = np.random.default_rng(7)
    n, dims = 400, [64, 32]
    store = HistoryStore.create(n + 1, dims, "vq", dev)
    for _ in range(3):
        for ell, d in enumerate(dims):
            v = torch.from_numpy(rng.normal(size=(150, d)).astype(np.float32))
            idx = torch.from_numpy(rng.integers(0, n, 150).astype(np.int32))
            mask = torch.from_numpy(rng.random(150) > 0.1)
            store.push(ell, idx.to(dev), v.to(dev), mask.to(dev))
    cpu = store.to("cpu")
    before = dict(_build.launch_counts)
    store.refit_codebooks()
    cpu.refit_codebooks()
    for k in ("gather_rows_vq", "scatter_rows_vq"):
        assert _build.launch_counts[k] == before[k] + len(dims)
    for ell in range(len(dims)):
        torch.testing.assert_close(store.codebooks[ell].cpu(),
                                   cpu.codebooks[ell], rtol=0, atol=1e-6)
        assert torch.all(store.codebooks[ell][:, 0] == 0)
        same = (store.tables[ell].cpu() == cpu.tables[ell]).float().mean()
        assert same >= 0.999, same
        assert not store.cb_counts[ell].any() and \
            not store.cb_sums[ell].any()


@pytest.mark.parametrize("op", ["gcn", "gat", "pna"])
def test_vq_train_step_on_card_matches_cpu(dev, op):
    """Two steps over a vq store on both devices, each from the same state
    (codebooks and statistics included): loss, gradients and
    `hist_quant_err` at 1e-4, the scales at 1e-4, >= 99.9% of the codes
    equal, and the vq path's kernels launched (GCN: gather_spmm_vq; GAT and
    PNA: gather_rows_vq; all: scatter_rows_vq)."""
    g = citation_graph(num_nodes=600, num_features=40, num_classes=4,
                       seed=1)
    spec = GNNSpec(op=op, d_in=40, d_hidden=32, num_classes=4,
                   num_layers=2, heads=4,
                   log_deg_mean=1.8 if op == "pna" else 1.0)
    cfg = R.GASConfig(num_parts=4, history_dtype="vq")
    plans = {d: R.build_plan(g, spec, cfg, device=d) for d in ("cpu", dev)}
    states = {d: R.init_state(p) for d, p in plans.items()}
    before = dict(_build.launch_counts)
    for b in (0, 1):
        if b:
            with torch.no_grad():
                for x, y in zip(_state_tensors(states["cpu"]),
                                _state_tensors(states[dev])):
                    x.copy_(y)
        out = {}
        for d, p in plans.items():
            grads, m = R.grads_and_metrics(p, states[d], p.batch(b))
            out[d] = [m["loss"].cpu(), m["hist_quant_err"].cpu()] + \
                [x.cpu() for x in grads]
        for a, c in zip(out[dev], out["cpu"]):
            torch.testing.assert_close(a, c, **TOL)
        got, want = states[dev].histories, states["cpu"].histories
        n = want.tables[0].shape[0] - 1
        for ell in range(want.num_layers):
            same = (got.tables[ell][:n].cpu() == want.tables[ell][:n]
                    ).float().mean().item()
            assert same >= 0.999, same
            torch.testing.assert_close(got.scales[ell][:n].cpu(),
                                       want.scales[ell][:n], **TOL)
    ran = {k for k in _build.launch_counts
           if _build.launch_counts[k] > before[k]}
    read = "gather_spmm_vq" if op == "gcn" else "gather_rows_vq"
    assert {"scatter_rows_vq", read} <= ran, ran


def _decode_inputs(seed, B, Kh, G, Dh, S, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dtype)
               for shape in ((B, Kh, G, Dh), (B, S, Kh, Dh), (B, S, Kh, Dh)))
    return q, k, v, rng


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Kh,G,Dh,S,pos", [
    (2, 2, 2, 128, 4096, 3000), (8, 8, 2, 128, 4096, 5000),
    (2, 4, 1, 64, 700, 0), (3, 2, 8, 32, 333, 200), (1, 2, 3, 64, 1000, 999),
    (2, 1, 12, 128, 2049, 2048), (1, 2, 4, 32, 512, 10_000),
    (2, 2, 2, 128, 4096, 64), (2, 2, 2, 128, 4096, 40),
    (8, 8, 2, 128, 4096, 2048), (1, 1, 2, 128, 8192, 8000),
    (2, 1, 3, 128, 3001, 3000), (1, 1, 20, 64, 300, 299),
    # recurrentgemma-9b's heads (Dh 256; MQA, G 16 in one tile)
    (8, 1, 16, 256, 2048, 3000), (8, 1, 16, 256, 2048, 1000),
    (2, 1, 16, 256, 700, 65), (1, 2, 5, 256, 333, 332),
    # phase 9b's f32 decode (B 2, the window rolled); one valid slot; one
    # past an f32 tile (33 slots); G 17 (tiles of 16 and 1); G 16 at Dh
    # 32 and 64
    (2, 1, 16, 256, 2048, 3000), (2, 1, 16, 256, 2048, 0),
    (1, 2, 16, 128, 500, 32), (2, 1, 17, 128, 1000, 900),
    (2, 2, 16, 32, 1000, 999), (1, 1, 16, 64, 3000, 2500)])
def test_flash_decode_matches_plain(dev, dtype, B, Kh, G, Dh, S, pos):
    """The kernel against `flash_decode_ref` on the card: f32 at 1e-5
    (the Pallas kernel's tolerance in tests/test_kernels.py), bf16 within
    2e-2 of the largest |output| (a sound kernel differs by at most one
    flip of the output's bf16 rounding, <= 2^-7 of it; an absolute 2e-2
    is the size of a typical output over thousands of slots and would
    pass a kernel that lost a warp's slots): Dh 32 to 128, G 1 to 12 (3
    and 12 fill their group tiles only in part; 20 takes two bf16 tiles
    of up to 16), S not a multiple of 256, pos 0, inside the cache and
    past it (a rolling buffer); for the bf16 kernel's 64-slot tiles,
    n_valid one past a tile (65), below one tile (41), 2,049 and 3,001,
    and one (b, h) pair, so the plan cuts 8,001 slots into many splits;
    Dh 256 (a 3-stage ring) at recurrentgemma's shape, rolled and not;
    for the f32 kernel's 32-slot tiles and 16-member group tile, phase
    9b's B 2 shape, n_valid 1 and 33, G 17 and G 16 at Dh 32 and 64; a
    warm repeat bitwise equal."""
    q, k, v, _ = _decode_inputs(B + S + pos, B, Kh, G, Dh, S, dtype)
    q, k, v = q.to(dev), k.to(dev), v.to(dev)
    before = _build.launch_counts["flash_decode"]
    out = flash_decode(q, k, v, pos)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_decode"] == before + 1
    want = ref.flash_decode_ref(q, k, v, pos).float()
    if dtype == torch.float32:
        torch.testing.assert_close(out.float(), want, rtol=1e-5, atol=1e-5)
    else:
        err = float((out.float() - want).abs().max())
        assert err <= 2e-2 * float(want.abs().max()), err
    assert torch.equal(out, flash_decode(q, k, v, pos))
    assert out.dtype == dtype and out.shape == q.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d", [(1, 256), (37, 20), (37, 256), (4096, 256),
                                 (4097, 256), (37, 6), (150, 6)])
def test_scatter_rows_last_writer_matches_plain(dev, dtype, m, d):
    """`scatter_rows` against its plain version, bitwise over the whole
    table, the sentinel row included: duplicate valid indices (the last
    writer wins), negative and >= N indices (dropped), about a quarter of
    the rows on the last row as a serving push's padding (~1,100 of
    4,096); M = 1, 37 (d = 20: the unvectorized copy) and 4,096 take the
    one-launch scan, 4,097 (past SCAN_MAX_ROWS) the claim passes. One
    launch counted per call; a repeat bitwise equal."""
    assert SCAN_MAX_ROWS == 4096     # 4,096 scans, 4,097 claims
    rng = np.random.default_rng(m + d)
    n = 5000
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)
                             ).to(dtype)
    vals = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)
                            ).to(dtype)
    idx = rng.integers(0, n - 1, m)
    idx[rng.random(m) < 0.27] = n - 1            # padding on the sentinel
    dup = rng.random(m) < 0.1
    idx[dup] = idx[rng.integers(0, m, m)][dup]   # duplicates of any row
    bad = rng.random(m) < 0.05
    idx[bad] = rng.choice([-7, -1, n, n + 3], int(bad.sum()))
    idx = torch.from_numpy(idx.astype(np.int32))
    want = ref.scatter_rows_ref(table.clone(), idx, vals)
    name = "scatter_rows" if dtype == torch.float32 else "scatter_rows_bf16"
    for _ in range(2):
        before = _build.launch_counts[name]
        got = scatter_rows(table.clone().to(dev), idx.to(dev), vals.to(dev))
        torch.cuda.synchronize()
        assert _build.launch_counts[name] == before + 1
        assert torch.equal(got.cpu(), want)


_Q_PUSH_CASES = [(1, 256), (37, 20), (194, 64), (4096, 256), (4097, 256)]


def _q_push_case(m, d):
    """`test_scatter_rows_q_last_writer_matches_plain`'s operands at (m, d),
    on the CPU: the table, the scales, the pushed rows and the index."""
    rng = np.random.default_rng(m + d)
    n = 5000
    q0 = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8))
    s0 = torch.from_numpy(rng.random(n).astype(np.float32))
    v = _quant_values(rng, max(m, 8), d)
    v[6] = rng.normal(size=d).astype(np.float32) * np.float32(1e-40)
    v[7] = (rng.integers(-127, 127, d) + 0.5).astype(np.float32) / 8
    v[7, 0] = 127.0 / 8                          # s = 2^-3: v / s exact
    vals = torch.from_numpy(v[:m])
    idx = rng.integers(0, n - 1, m)
    idx[rng.random(m) < 0.27] = n - 1            # padding on the sentinel
    dup = rng.random(m) < 0.1
    idx[dup] = idx[rng.integers(0, m, m)][dup]   # duplicates of any row
    bad = rng.random(m) < 0.05
    idx[bad] = rng.choice([-7, -1, n, n + 3], int(bad.sum()))
    return q0, s0, vals, torch.from_numpy(idx.astype(np.int32))


def _child_q_push_kernels():
    """In a child process: the device kernels of one `scatter_rows_q` at
    each of _Q_PUSH_CASES, all in one torch.profiler window, each case's
    between marker kernels (`torch.cuda._sleep`'s `spin_kernel`)."""
    dev = resolve_device("cuda")
    calls = []
    for m, d in _Q_PUSH_CASES:
        q0, s0, vals, idx = _q_push_case(m, d)
        args = (q0.to(dev), s0.to(dev), idx.to(dev), vals.to(dev))
        scatter_rows_q(*(a.clone() for a in args))      # built and warm
        calls.append(args)
    segments, _ = _marked_segments([lambda a=a: scatter_rows_q(*a)
                                    for a in calls])
    return {f"{m},{d}": seg for (m, d), seg in zip(_Q_PUSH_CASES, segments)}


@pytest.fixture(scope="module")
def q_push_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return _in_child("q_push_kernels")


@pytest.mark.parametrize("m,d", _Q_PUSH_CASES)
def test_scatter_rows_q_last_writer_matches_plain(dev, m, d, q_push_kernels):
    """`scatter_rows_q` against its plain version: codes and scales
    bitwise over the whole table, the sentinel row included, with
    duplicate valid indices (the last writer wins, codes and scale
    alike), negative and >= N indices (dropped) and about a quarter of
    the rows on the last row as a serving push's padding; every pushed
    row's error at 1e-5. Beside `_quant_values`' rows, a row of
    denormals (a denormal scale) and a row of exact ties at the scale
    2^-3. M = 1, 37 (d = 20), 194 (GAT's training
    push) and 4,096 take the one-launch scan, 4,097 the claim passes:
    one launch counted per call, one device kernel up to SCAN_MAX_ROWS
    and three past it (torch.profiler, which must see the card; counted
    for every case in one window of a child process of its own, where
    the profiler has not gone blind late in a long run); a repeat
    bitwise equal."""
    assert SCAN_MAX_ROWS == 4096     # 4,096 scans, 4,097 claims
    q0, s0, vals, idx = _q_push_case(m, d)
    want_q, want_s, want_e = ref.scatter_rows_q_ref(q0.clone(), s0.clone(),
                                                    idx, vals)
    args = (idx.to(dev), vals.to(dev))
    errs = []
    for _ in range(2):
        before = _build.launch_counts["scatter_rows_q"]
        got_q, got_s, got_e = scatter_rows_q(q0.clone().to(dev),
                                             s0.clone().to(dev), *args)
        torch.cuda.synchronize()
        assert _build.launch_counts["scatter_rows_q"] == before + 1
        assert torch.equal(got_q.cpu(), want_q)
        assert torch.equal(got_s.cpu(), want_s)
        errs.append(got_e.cpu())
    torch.testing.assert_close(errs[0], want_e, rtol=1e-5, atol=1e-7,
                               equal_nan=True)
    assert torch.equal(errs[0].isnan(), errs[1].isnan())
    assert torch.equal(errs[0].nan_to_num(), errs[1].nan_to_num())
    kernels = q_push_kernels[f"{m},{d}"]
    assert len(kernels) == (1 if m <= SCAN_MAX_ROWS else 3), kernels


def test_flash_decode_rejects_unbuilt_head_dim(dev):
    """Only Dh 32, 64, 128 and 256 are built: another (80, hubert-xlarge's,
    an encoder with no decode) raises before a launch."""
    q, k, v, _ = _decode_inputs(0, 1, 2, 2, 80, 64, torch.bfloat16)
    before = _build.launch_counts["flash_decode"]
    with pytest.raises(ValueError, match="head_dim 80"):
        flash_decode(q.to(dev), k.to(dev), v.to(dev), 10)
    assert _build.launch_counts["flash_decode"] == before


@pytest.mark.parametrize("plan,ok", [
    ((16, 64, 32), True), ((8, 8, 256), True), ((16, 32, 64), True),
    ((16, 1, 2048), True), ((16, 65, 32), False), ((16, 63, 32), False),
    ((16, 63, 33), False), ((17, 1, 2048), False)])
def test_flash_decode_f32_checks_its_plan(dev, plan, ok):
    """The f32 launcher takes any plan its kernel can compute and refuses
    the rest before a launch, at phase 9b's shape (B 2, Kh 1, G 16, Dh
    256, 2,048 valid slots): the wrapper's plan on 132 SMs (64 splits of
    one tile), two group tiles of 8 on 256-slot chunks, fewer splits and
    one split all match the plain version; an empty chunk, chunks short
    of the valid slots, a chunk of no whole tiles and a group tile of 17
    are refused, and nothing is written."""
    B, Kh, G, Dh, S, pos = 2, 1, 16, 256, 2048, 3000
    q, k, v, _ = _decode_inputs(0, B, Kh, G, Dh, S, torch.float32)
    q, k, v = q.to(dev), k.to(dev), v.to(dev)
    gt, n_splits, chunk = plan
    part = torch.empty((B * Kh * -(-G // gt), n_splits, gt, Dh + 2),
                       device=dev)
    out = torch.zeros_like(q)
    rc = _build.lib().repro_flash_decode_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), part.data_ptr(),
        out.data_ptr(), B, S, Kh, G, Dh, gt, S, n_splits, chunk, Dh ** -0.5,
        _build.stream_ptr(q.device))
    torch.cuda.synchronize()
    if ok:
        assert rc == 0
        torch.testing.assert_close(out, ref.flash_decode_ref(q, k, v, pos),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert rc != 0, plan
        assert not out.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Kh,G,Dh,S", [(2, 8, 2, 128, 4096),
                                         (2, 1, 16, 256, 2048)])
@pytest.mark.parametrize("pos", [0, 255, 256, 1000, 4094, 63, 64, 3000, 32,
                                 2020])
def test_flash_decode_ignores_masked_tail(dev, dtype, B, Kh, G, Dh, S, pos):
    """Slots past `pos` are never read: new values there (NaN included)
    leave the output bitwise unchanged, at qwen3's heads and at
    recurrentgemma's (Dh 256, G 16), with the last f32 tile ragged (33,
    1,001 and 2,021 valid slots among others) or whole (256, 64)."""
    q, k, v, rng = _decode_inputs(pos, B, Kh, G, Dh, S, dtype)
    q, k, v = q.to(dev), k.to(dev), v.to(dev)
    out = flash_decode(q, k, v, pos)
    k2, v2 = k.clone(), v.clone()
    k2[:, pos + 1:] = torch.from_numpy(rng.normal(
        size=k2[:, pos + 1:].shape).astype(np.float32)).to(dev, dtype)
    v2[:, pos + 1:] = float("nan")
    assert torch.equal(out, flash_decode(q, k2, v2, pos))


def test_decode_steps_on_card_match_cpu(dev):
    """qwen3's SMOKE widths in f32, one set of weights on both devices:
    prefill and 4 decode steps (the cache of 40 slots past the 24-token
    prompt, so decode reads a masked tail), logits at 1e-4 and caches at
    1e-5, and one flash_decode launch per layer and step on the card."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b", "smoke"),
                              dtype="float32")
    params = T.init_params(cfg, seed=0, device=dev)
    cparams = tree_map(lambda a: a.cpu(), params)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 28))
    toks = torch.from_numpy(toks.astype(np.int32))
    out = {}
    before = _build.launch_counts["flash_decode"]
    for d, p in ((dev, params), ("cpu", cparams)):
        logits, cache = T.prefill(p, cfg, {"tokens": toks[:, :24].to(d)},
                                  cache_len=40)
        steps = [logits]
        for s in range(4):
            logits, cache = T.decode_step(p, cfg, cache,
                                          toks[:, 24 + s:25 + s].to(d))
            steps.append(logits)
        out[d] = ([x.cpu() for x in steps],
                  [x.cpu() for x in cache["segs"][0]["0"].values()])
    assert _build.launch_counts["flash_decode"] == before + 4 * cfg.num_layers
    for a, c in zip(out[dev][0], out["cpu"][0]):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
    for a, c in zip(out[dev][1], out["cpu"][1]):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,over,n", [
    ("recurrentgemma-9b", {}, 72),
    ("qwen3-0.6b", dict(pattern=("moe",), num_experts=4, top_k=2), 24),
    ("qwen3-0.6b", dict(pattern=("dense", "cross"), family="vlm",
                        num_image_tokens=4), 24)])
def test_layer_types_decode_on_card_match_cpu(dev, arch, over, n):
    """The rec / local (recurrentgemma SMOKE: a 72-token prompt rolls the
    64-slot window), moe and cross layers in f32 on one set of weights
    (the cross gates opened): forward, prefill and 4 decode steps on the
    card against the CPU, logits at 1e-4 and every cache leaf at 1e-5;
    flash_decode launched once per attention or cross layer and step."""
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32",
                              **over)
    params = _open_gates(T.init_params(cfg, seed=0, device=dev))
    cparams = tree_map(lambda a: a.cpu(), params)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, n + 4))
                            .astype(np.int32))
    img = torch.from_numpy(rng.normal(size=(2, 4, cfg.d_model))
                           .astype(np.float32))
    extra = {"image_embeds": img} if "cross" in cfg.layer_types() else {}
    n_attn = sum(lt != "rec" for lt in cfg.layer_types())
    out = {}
    before = _build.launch_counts["flash_decode"]
    for d, p in ((dev, params), ("cpu", cparams)):
        ex = {k: v.to(d) for k, v in extra.items()}
        full, _ = T.forward(p, cfg, {"tokens": toks.to(d), **ex})
        logits, cache = T.prefill(p, cfg, {"tokens": toks[:, :n].to(d),
                                           **ex}, cache_len=n + 8)
        steps = [full, logits]
        for s in range(4):
            logits, cache = T.decode_step(p, cfg, cache,
                                          toks[:, n + s:n + s + 1].to(d))
            steps.append(logits)
        out[d] = ([x.cpu() for x in steps],
                  [x.cpu() for x in tree_leaves(cache["segs"])])
    assert _build.launch_counts["flash_decode"] == before + 4 * n_attn
    for a, c in zip(out[dev][0], out["cpu"][0]):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
    for a, c in zip(out[dev][1], out["cpu"][1]):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)


def _open_gates(params):
    """Every cross layer's tanh gates opened (the init closes them)."""
    for seg in params["segs"]:
        for lp in seg.values():
            if "g_attn" in lp:
                lp["g_attn"].fill_(0.5)
                lp["g_mlp"].fill_(-0.3)
    return params


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "hubert-xlarge"])
def test_chunked_loss_on_card_matches_cpu(dev, arch):
    """seq-GAS in f32 at SMOKE widths on one set of weights: qwen3's
    chunked_loss and every gradient (remat on), hubert's 3 bidirectional
    passes' logits, on the card against the CPU (loss and logits at 1e-5,
    gradients at 1e-4)."""
    from repro_torch.core import seq_gas as SG
    from repro_torch.train.optimizer import grad_leaves
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32")
    params = T.init_params(cfg, seed=3, device=dev)
    cparams = tree_map(lambda a: a.cpu(), params)
    rng = np.random.default_rng(2)
    if cfg.family == "audio":
        frames = torch.from_numpy(rng.normal(size=(2, 96, cfg.d_model))
                                  .astype(np.float32))
        outs = {}
        for d, p in ((dev, params), ("cpu", cparams)):
            hist, logits = None, []
            with torch.no_grad():
                for _ in range(cfg.num_layers + 1):
                    lg, hist = SG.forward_chunked(
                        p, cfg, {"frames": frames.to(d)}, 32, history=hist,
                        bidirectional=True)
                    logits.append(lg.cpu())
            outs[d] = logits
        for a, c in zip(outs[dev], outs["cpu"]):
            torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)
        return
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 96))
                            .astype(np.int32))
    res = {}
    for d, p in ((dev, params), ("cpu", cparams)):
        tree, leaves = grad_leaves(p)
        loss, _ = SG.chunked_loss(tree, cfg, {"tokens": toks.to(d),
                                              "labels": toks.to(d)}, 32)
        grads = torch.autograd.grad(loss, leaves)
        res[d] = (loss.detach().cpu(), [g.cpu() for g in grads])
    torch.testing.assert_close(res[dev][0], res["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    for a, c in zip(res[dev][1], res["cpu"][1]):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)


def test_gas_trainer_on_card_matches_cpu(dev):
    """`GASTrainer` for two epochs on the card and on the CPU from the same
    initial params and partition: the epoch losses at 1e-4 and the exact
    accuracies within two test nodes; the card's run launches the GCN
    path's four kernels."""
    from repro_torch.train.gas_trainer import GASTrainer, TrainConfig
    g = citation_graph(num_nodes=600, num_features=40, num_classes=4,
                       seed=1)
    spec = GNNSpec(op="gcn", d_in=40, d_hidden=32, num_classes=4,
                   num_layers=3)
    trs = {d: GASTrainer(g, spec, num_parts=4, device=d,
                         tcfg=TrainConfig(epochs=2)) for d in ("cpu", dev)}
    assert trs[dev].device == dev
    losses = {}
    for d, tr in trs.items():
        _build.reset_launch_counts()
        losses[d] = [m["loss"] for m in tr.fit()]
    launches = dict(_build.launch_counts)
    np.testing.assert_allclose(losses[dev], losses["cpu"], **TOL)
    for k in ("bcsr_spmm", "gather_spmm", "gather_rows", "scatter_rows"):
        assert launches[k] > 0, (k, launches)
    accs = {d: tr.evaluate() for d, tr in trs.items()}
    n_test = int(g.test_mask.sum())
    for k, v in accs["cpu"].items():
        assert abs(accs[dev][k] - v) <= 2.0 / n_test, (k, accs)


@pytest.mark.parametrize("kind", ["graphsage", "sgc"])
def test_baseline_step_on_card_matches_cpu(dev, kind):
    """One GraphSAGE step on the same sampled batch (one SGC step on the
    same propagated features) on both devices from the same initial
    params: the loss and the gradients at 1e-4 (SGC's features too); the
    update then runs on both devices from the card's gradients, params at
    lr * 1e-4 absolute and the moments at 1e-4, as
    test_train_step_on_card_matches_cpu holds them."""
    from repro_torch.train.baselines import GraphSAGETrainer, SGCTrainer
    g = citation_graph(num_nodes=600, num_features=40, num_classes=4,
                       seed=1)
    if kind == "graphsage":
        trs = {d: GraphSAGETrainer(g, d_hidden=16, fanout=5, batch_size=64,
                                   device=d) for d in ("cpu", dev)}
        seeds = trs["cpu"].train_nodes[:64]
        layers, base = trs["cpu"]._sample_batch(seeds)
        out = {d: tr.grads_and_metrics(*tr.device_batch(seeds, layers,
                                                        base))
               for d, tr in trs.items()}
    else:
        trs = {d: SGCTrainer(g, k=2, device=d) for d in ("cpu", dev)}
        torch.testing.assert_close(trs[dev].features.cpu(),
                                   trs["cpu"].features, **TOL)
        out = {d: tr.grads_and_metrics() for d, tr in trs.items()}
    (gc, mc), (gg, mg) = out["cpu"], out[dev]
    np.testing.assert_allclose(mg["loss"], mc["loss"], **TOL)
    for x, y in zip(gg, gc):
        torch.testing.assert_close(x.cpu(), y, **TOL)
    trs[dev].apply_update(gg)
    trs["cpu"].apply_update([x.cpu() for x in gg])
    c, k = trs["cpu"], trs[dev]
    for xs, ys, tol in (
            (k.params, c.params, dict(rtol=1e-6, atol=1e-6)),
            (k.opt_state.m, c.opt_state.m, dict(rtol=1e-4, atol=1e-12)),
            (k.opt_state.v, c.opt_state.v, dict(rtol=1e-4, atol=1e-12))):
        for x, y in zip(tree_leaves(xs), tree_leaves(ys)):
            torch.testing.assert_close(x.cpu(), y, **tol)


# ---------------------------------------------------------------------------
# The async history pipeline: gather_rows_raw, pinned host stores, the
# pipelined epoch on the side stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["pinned", "device"])
@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (300, 64)), (torch.bfloat16, (300, 33)),
    (torch.int8, (300, 37)), (torch.uint8, (300, 8)),
    (torch.float32, (300,)), (torch.float32, (300, 5))])
def test_gather_rows_raw_matches_plain(dev, where, dtype, shape):
    """Every element width, 16-byte rows and ragged ones (66, 37, 20
    bytes), 1-wide scale tables; a pinned host table read through its
    unified address and a device table; indices past both ends clipped:
    bitwise the plain version, one launch."""
    from repro_torch.kernels.gather import gather_rows_raw
    g = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        host = torch.randn(shape, generator=g).to(dtype)
    else:
        lo = -128 if dtype == torch.int8 else 0
        host = torch.randint(lo, lo + 256, shape, generator=g, dtype=dtype)
    idx = torch.randint(-20, shape[0] + 20, (274,), generator=g,
                        dtype=torch.int32)
    table = host.pin_memory() if where == "pinned" else host.to(dev)
    n0 = _build.launch_counts["gather_rows_raw"]
    got = gather_rows_raw(table, idx.to(dev))
    torch.cuda.synchronize()
    assert _build.launch_counts["gather_rows_raw"] == n0 + 1
    assert got.device == dev and got.dtype == dtype
    assert torch.equal(got.cpu(), ref.gather_rows_raw_ref(host, idx))


@pytest.mark.parametrize("hd", ["int8", "vq"])
def test_host_store_is_pinned_and_small_on_card(dev, hd):
    """A host store's tables and scale tables are pinned CPU tensors, and
    creating it allocates on the card only its clock and (vq) codebooks
    and statistics; pushes write the pinned tables as a device store's
    pushes write its own."""
    from repro_torch.core.history import HistoryStore
    n1, dims = 20_001, [64, 64]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    h = HistoryStore.create(n1, dims, history_dtype=hd, device=dev,
                            storage="host")
    grew = torch.cuda.memory_allocated(dev) - before
    dev_bytes = h.placement_bytes()["device"]
    n_dev = 1 + 3 * len(dims) * (hd == "vq")
    assert dev_bytes <= grew <= dev_bytes + 512 * n_dev   # block rounding
    assert h.placement_bytes()["host"] > dev_bytes or hd == "vq"
    for t in h.tables + h.scales:
        assert t.device.type == "cpu" and t.is_pinned()
    d = HistoryStore.create(n1, dims, history_dtype=hd, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    idx = torch.randperm(n1 - 1, device=dev, generator=g)[:500].to(
        torch.int32)
    vals = torch.randn(500, 64, device=dev, generator=g)
    mask = torch.rand(500, device=dev, generator=g) < 0.9
    for s in (h, d):
        s.push(0, idx, vals, mask)
    h.sync()
    assert torch.equal(h.tables[0], d.tables[0].cpu())
    assert torch.equal(h.scales[0], d.scales[0].cpu())
    assert torch.equal(h.pull(0, idx), d.pull(0, idx))


def _card_run(dev, op, hd, depth, storage, epochs=2, **cfg):
    g = citation_graph(num_nodes=600, num_features=32, num_classes=4,
                       seed=2)
    spec = GNNSpec(op=op, d_in=32, d_hidden=64, num_classes=4,
                   num_layers=3, heads=8)
    plan = R.build_plan(g, spec, R.GASConfig(
        num_parts=5, history_dtype=hd, history_storage=storage,
        prefetch_depth=depth, seed=1, **cfg), device=dev)
    state = R.init_state(plan)
    metrics = [R.train_epoch(plan, state, e)[1] for e in range(epochs)]
    state.histories.sync()
    return state, metrics


@pytest.mark.parametrize("op,hd", [("gcn", "f32"), ("gcn", "int8"),
                                   ("gat", "vq")])
def test_host_pipeline_on_card_bitwise(dev, op, hd):
    """Two epochs at host/1 and at device/2 against device/0 on the card
    (a vq refit between them): params, moments, tables, scales, clock
    and epoch metrics bitwise, the host tables pinned, and the pipelined
    runs' prefetches on the side stream."""
    kw = dict(vq_refit_every=1)
    base, mb = _card_run(dev, op, hd, 0, "device", **kw)
    n0 = _build.launch_counts["gather_rows_raw"]
    for depth, storage in ((1, "host"), (2, "device")):
        state, m = _card_run(dev, op, hd, depth, storage, **kw)
        assert m == mb
        a, b = base.histories, state.histories
        for x, y in zip(tree_leaves(base.params) + tree_leaves(
                base.opt_state.m) + tree_leaves(base.opt_state.v) +
                a.tables + (a.scales or []) + [a.age] + (a.codebooks or []),
                tree_leaves(state.params) + tree_leaves(state.opt_state.m)
                + tree_leaves(state.opt_state.v) + b.tables + (b.scales or [])
                + [b.age] + (b.codebooks or [])):
            assert torch.equal(x.cpu(), y.cpu())
        if storage == "host":
            assert all(t.is_pinned() for t in b.tables + (b.scales or []))
    assert _build.launch_counts["gather_rows_raw"] > n0


def test_mixed_devices_raise(dev):
    """A pinned table stands only in the raw gather's and the pushes'
    table slots: every other kernel given one raises, as does a pageable
    CPU table, and a pinned tensor in any other slot."""
    from repro_torch.kernels.gather import gather_rows_raw
    t = torch.randn(50, 16).pin_memory()
    q = torch.zeros(50, 16, dtype=torch.int8).pin_memory()
    s = torch.ones(50).pin_memory()
    idx = torch.arange(10, dtype=torch.int32, device=dev)
    vals = torch.randn(10, 16, device=dev)
    with pytest.raises(ValueError):
        gather_rows(t, idx)
    with pytest.raises(ValueError):
        gather_rows_dq(q, s, idx)
    with pytest.raises(ValueError):
        gather_rows_raw(torch.randn(50, 16), idx)          # pageable
    with pytest.raises(ValueError):
        scatter_rows(t.to(dev), idx, vals.cpu().pin_memory())
    with pytest.raises(ValueError):
        scatter_rows_q(q, s, idx, vals.cpu())              # CPU values
    with pytest.raises(ValueError):
        scatter_rows_q(q, s, idx.cpu(), vals)              # CPU index
    vals_b, cols = _blocks(0, 128, 150, 400)[0][:2]
    sel, xrow, trow = gather_plan(cols.to(dev), idx, torch.ones(
        10, dtype=torch.bool, device=dev), 128, 50, 128)
    with pytest.raises(ValueError):
        gather_spmm(torch.randn(128, 16, device=dev), t, vals_b.to(dev),
                    cols.to(dev), sel, xrow, trow)
    # the pushes do take a pinned table: nothing raised above was a push
    scatter_rows(t, idx, vals)
    torch.cuda.synchronize()
    assert torch.equal(t[:10], vals.cpu())


# the raw pull's and push's many-table launches: (dtype, width) of each
# table in turn, the widths a store holds (vq codes, scales, bf16 rows,
# int8 codes) and misaligned ones (odd row bytes: 37, 66, 20 bytes), each
# table of _RAW_N rows; every third table is a view that starts one
# element into its buffer (an offset pointer)
_RAW_WIDTHS = ((torch.uint8, (8,)), (torch.float32, ()),
               (torch.bfloat16, (64,)), (torch.int8, (256,)),
               (torch.int8, (37,)), (torch.bfloat16, (33,)),
               (torch.float32, (5,)))
_RAW_N = 300


def _raw_draw(g, dtype, shape):
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g).to(dtype)
    lo = -128 if dtype == torch.int8 else 0
    return torch.randint(lo, lo + 256, shape, generator=g, dtype=dtype)


def _raw_tables(dev, where, count, seed):
    """`count` tables of _RAW_WIDTHS in turn, with their CPU copies: all
    pinned, all on the card, or alternating ("mixed")."""
    g = torch.Generator().manual_seed(seed)
    host, placed = [], []
    for j in range(count):
        dtype, width = _RAW_WIDTHS[j % len(_RAW_WIDTHS)]
        t = _raw_draw(g, dtype, (_RAW_N,) + width)
        pin = where == "pinned" or (where == "mixed" and j % 2 == 0)
        flat = torch.empty(t.numel() + 1, dtype=dtype,
                           pin_memory=pin, device="cpu" if pin else dev)
        # every third table an offset view into its buffer
        off = 1 if j % 3 == 2 else 0
        view = flat[off:off + t.numel()].view(t.shape)
        view.copy_(t)
        host.append(t)
        placed.append(view)
    return host, placed


@pytest.mark.parametrize("count", [1, 2, 31, 62, 65])
@pytest.mark.parametrize("where", ["pinned", "device", "mixed"])
def test_gather_rows_raw_many_matches_plain(dev, where, count):
    """One many-table pull over every width (1-d scales, odd row bytes,
    offset views) from pinned, device and mixed tables, indices past both
    ends clipped: each output bitwise the plain version's, one launch for
    up to 64 tables (65 take two)."""
    from repro_torch.kernels.gather import gather_rows_raw_many
    host, tables = _raw_tables(dev, where, count, seed=count)
    g = torch.Generator().manual_seed(7)
    idx = torch.randint(-20, _RAW_N + 20, (274,), generator=g,
                        dtype=torch.int32)
    n0 = _build.launch_counts["gather_rows_raw"]
    got = gather_rows_raw_many(tables, idx.to(dev))
    torch.cuda.synchronize()
    assert _build.launch_counts["gather_rows_raw"] == n0 + -(-count // 64)
    for h, o in zip(host, got):
        assert o.device == dev and o.dtype == h.dtype and o.is_contiguous()
        assert torch.equal(o.cpu(), ref.gather_rows_raw_ref(h, idx))


@pytest.mark.parametrize("m", [128, SCAN_MAX_ROWS + 3])
@pytest.mark.parametrize("count", [1, 2, 31, 62, 65])
@pytest.mark.parametrize("where", ["pinned", "device", "mixed"])
def test_scatter_rows_raw_many_matches_plain(dev, where, count, m):
    """One many-table push of every width into pinned, device and mixed
    tables (offset views, odd row bytes, 1-d scales), with repeated and
    dropped rows, on the one-launch scan and past SCAN_MAX_ROWS on the
    claim passes, right after a queued kernel write into the same tables
    (stream order, no host sync): every table bitwise the plain version's,
    one counted launch for up to 64 tables."""
    from repro_torch.kernels.scatter import (scatter_rows_raw,
                                             scatter_rows_raw_many)
    host, tables = _raw_tables(dev, where, count, seed=count + m)
    g = torch.Generator().manual_seed(m)
    rows = [_raw_draw(g, h.dtype, (m,) + tuple(h.shape[1:])) for h in host]
    idx = torch.randint(-20, _RAW_N + 20, (m,), generator=g,
                        dtype=torch.int32)
    idx[m // 2:m // 2 + 30] = idx[:30]               # repeats
    first = torch.arange(7, dtype=torch.int32)
    for t, r in zip(tables, rows):                   # queued writes first
        scatter_rows_raw(t, first.to(dev), r[:7].to(dev))
    for h, r in zip(host, rows):
        ref.scatter_rows_raw_ref(h, first, r[:7])
    want = ref.scatter_rows_raw_many_ref(host, idx, rows)
    n0 = _build.launch_counts["scatter_rows_raw"]
    scatter_rows_raw_many(tables, idx.to(dev), [r.to(dev) for r in rows])
    torch.cuda.synchronize()
    assert _build.launch_counts["scatter_rows_raw"] == n0 + -(-count // 64)
    for t, w in zip(tables, want):
        assert torch.equal(t.cpu(), w)


def test_raw_many_refuse_pageable_and_mixed_devices(dev):
    """A pageable host table, in any slot, raises; so does an index or a
    rows tensor off the card, as the one-table wrappers refuse them."""
    from repro_torch.kernels.gather import gather_rows_raw_many
    from repro_torch.kernels.scatter import scatter_rows_raw_many
    _, tables = _raw_tables(dev, "mixed", 4, seed=1)
    idx = torch.arange(10, dtype=torch.int32, device=dev)
    rows = [t[:10].to(dev) for t in tables]
    for slot in range(4):
        bad = list(tables)
        bad[slot] = bad[slot].cpu().clone()            # pageable
        if bad[slot].is_pinned():
            continue
        with pytest.raises(ValueError):
            gather_rows_raw_many(bad, idx)
        with pytest.raises(ValueError):
            scatter_rows_raw_many(bad, idx, rows)
        off = list(rows)
        off[slot] = off[slot].cpu()                    # rows on the host
        with pytest.raises(ValueError):
            scatter_rows_raw_many(tables, idx, off)
    with pytest.raises(ValueError):
        gather_rows_raw_many(tables, idx.cpu())        # index on the host
    with pytest.raises(ValueError):
        scatter_rows_raw_many(tables, idx.cpu(), rows)


# (entry, tables, row shape, M, CTAs): the grids the raw entries plan,
# worked by hand. A 256-byte row is 16 units of 16 bytes and a 4-byte one
# one unit; the pull keeps one unit a thread while its grid stays within
# 528 CTAs (20 at the GCN quickstart's 314 rows), else takes 4 (61 CTAs a
# table at GCNII-32L's 3,885 rows, 31 tables); 65 tables are a launch of
# 64 and one of 1; the push is a CTA for every 8 rows in each launch.
@pytest.mark.parametrize("entry,count,shape,m,ctas", [
    ("gather", 1, (64,), 314, 20), ("gather", 31, (64,), 3885, 1891),
    ("gather", 65, (), 300, 130), ("gather", 2, (64,), 0, 0),
    ("scatter", 1, (64,), 128, 16), ("scatter", 4, (64,), 128, 16),
    ("scatter", 65, (), 128, 32)])
def test_raw_many_ctas_is_the_launch_plan(dev, entry, count, shape, m, ctas):
    """`repro_gather_rows_raw_many_ctas` and
    `repro_scatter_rows_raw_many_ctas` (chip_smoke.py sizes each raw
    line's launch floor by them) return the CTAs of the entry's own plan
    for device tables and rows from the allocator."""
    tables = [torch.zeros((_RAW_N,) + shape, device=dev)
              for _ in range(count)]
    rows = [torch.zeros((m,) + shape, device=dev) for _ in range(count)]
    name = f"repro_{entry}_rows_raw_many_ctas"
    out = ctypes.c_int64(-1)
    _build.check(getattr(_build.lib(), name)(
        _build.pointers([t.data_ptr() for t in tables]),
        _build.pointers([r.data_ptr() for r in rows]),
        _build.int64s([_RAW_N] * count),
        _build.int64s([4 * math.prod(shape)] * count),
        count, m, ctypes.byref(out)), name)
    assert out.value == ctas


# ---------------------------------------------------------------------------
# Serving's split: scatter_rows_raw, the frontend on the card, a host-store
# backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["pinned", "device"])
@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (300, 64)), (torch.bfloat16, (300, 33)),
    (torch.int8, (300, 37)), (torch.uint8, (300, 8)),
    (torch.float32, (300,)), (torch.float32, (300, 5))])
@pytest.mark.parametrize("m", [128, SCAN_MAX_ROWS + 3])
def test_scatter_rows_raw_matches_plain(dev, where, dtype, shape, m):
    """Every element width, 16-byte rows and ragged ones (66, 37, 20
    bytes), 1-wide scale tables; a pinned host table written through its
    unified address and a device table; indices past both ends (dropped)
    and repeated ones (the last writer wins), on the one-launch scan and
    past SCAN_MAX_ROWS on the claim passes: the whole table bitwise the
    plain version's, one counted launch, and after queued kernel writes to
    the same table (stream order, no host sync)."""
    from repro_torch.kernels.scatter import scatter_rows_raw
    g = torch.Generator().manual_seed(m)

    def draw(s):
        if dtype.is_floating_point:
            return torch.randn(s, generator=g).to(dtype)
        lo = -128 if dtype == torch.int8 else 0
        return torch.randint(lo, lo + 256, s, generator=g, dtype=dtype)

    host = draw(shape)
    rows = draw((m,) + shape[1:])
    idx = torch.randint(-20, shape[0] + 20, (m,), generator=g,
                        dtype=torch.int32)
    idx[m // 2:m // 2 + 30] = idx[:30]               # repeats
    table = host.pin_memory() if where == "pinned" else host.to(dev)
    # a queued kernel write into the table first: the raw push lands after
    first = draw((7,) + shape[1:])
    scatter_rows_raw(table, torch.arange(7, dtype=torch.int32, device=dev),
                     first.to(dev))
    want = ref.scatter_rows_raw_ref(
        ref.scatter_rows_raw_ref(host.clone(), torch.arange(
            7, dtype=torch.int32), first), idx, rows)
    n0 = _build.launch_counts["scatter_rows_raw"]
    scatter_rows_raw(table, idx.to(dev), rows.to(dev))
    torch.cuda.synchronize()
    assert _build.launch_counts["scatter_rows_raw"] == n0 + 1
    assert torch.equal(table.cpu(), want)
    with pytest.raises(TypeError):
        scatter_rows_raw(table, idx.to(dev), rows.to(dev).float()
                         if dtype != torch.float32 else rows.to(dev).half())


def _split_on(dev, op, hd, storage="device"):
    from repro_torch.core import serve as S
    from repro_torch.core import serve_service as SS
    from repro_torch.core.history import HistoryStore
    from repro_torch.gnn.model import init_gnn
    g = citation_graph(num_nodes=600, num_features=32, num_classes=4,
                       seed=2)
    spec = GNNSpec(op=op, d_in=32, d_hidden=64, num_classes=4,
                   num_layers=3, heads=8)
    params = init_gnn(spec, seed=1, device=dev)
    cfg = S.ServeConfig(staleness_slo=0, buckets=(32, 128))

    def state(plan, where):
        store = HistoryStore.create(601, spec.hist_dims(), hd, dev,
                                    storage=where)
        return S.init_serve_state(plan, S.ServeState(params, store))

    pr = S.build_serve_plan(g, spec, cfg, device=dev)
    pb = S.build_serve_plan(g, spec, cfg, device=dev)
    be = SS.HistoryBackend(pb, state(pb, storage))
    fe = SS.ServeFrontend(g, spec, cfg, SS.InProcTransport(be), device=dev)
    return pr, state(pr, "device"), be, fe


@pytest.mark.parametrize("op,hd", [("gcn", "f32"), ("gcn", "int8"),
                                   ("gat", "vq"), ("pna", "bf16")])
def test_split_frontend_bitwise_inprocess_on_card(dev, op, hd):
    """At SLO=0 a frontend on the card, over an InProcTransport to a
    backend on the card, answers bitwise what the in-process
    `serve_request` answers from the same state (the same kernels on the
    same bits), and leaves the backend's tables, scales and clock bitwise
    the in-process store's; the backend's push ran `scatter_rows_raw`."""
    from repro_torch.core import serve as S
    pr, sr, be, fe = _split_on(dev, op, hd)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        n0 = _build.launch_counts["scatter_rows_raw"]
        for _ in range(3):
            q = rng.choice(600, 100, replace=False)
            want, sr, _ = S.serve_request(pr, sr, q)
            got, d = fe.serve_request(q)
            np.testing.assert_array_equal(got, want)
            assert d["num_retries"] == 0.0
    assert _build.launch_counts["scatter_rows_raw"] > n0
    a, b = sr.histories, be.state.histories
    for x, y in zip(a.tables + (a.scales or []) + [a.age],
                    b.tables + (b.scales or []) + [b.age]):
        assert torch.equal(x[:600], y[:600])


@pytest.mark.parametrize("hd", ["f32", "int8"])
def test_host_store_backend_pushes_into_pinned_tables(dev, hd):
    """A backend over a `history_storage="host"` store: its pulls read the
    pinned tables through `gather_rows_raw`, the frontend's pushes land in
    them through `scatter_rows_raw` (the tables stay pinned), and the
    answers and tables are bitwise those of in-process serving from a
    device store."""
    from repro_torch.core import serve as S
    pr, sr, be, fe = _split_on(dev, "gcn", hd, storage="host")
    b = be.state.histories
    assert all(t.device.type == "cpu" and t.is_pinned()
               for t in b.tables + (b.scales or []))
    rng = np.random.default_rng(4)
    with torch.no_grad():
        n_raw = (_build.launch_counts["gather_rows_raw"],
                 _build.launch_counts["scatter_rows_raw"])
        for _ in range(2):
            q = rng.choice(600, 64, replace=False)
            want, sr, _ = S.serve_request(pr, sr, q)
            got, _ = fe.serve_request(q)
            np.testing.assert_array_equal(got, want)
    assert _build.launch_counts["gather_rows_raw"] > n_raw[0]
    assert _build.launch_counts["scatter_rows_raw"] > n_raw[1]
    b.sync()
    a = sr.histories
    for x, y in zip(a.tables + (a.scales or []) + [a.age],
                    b.tables + (b.scales or []) + [b.age]):
        assert torch.equal(x[:600].cpu(), y[:600].cpu())
    assert all(t.is_pinned() for t in b.tables + (b.scales or []))


# ---------------------------------------------------------------------------
# Evolving graphs: advance and HistoryStore.grow on the card
# ---------------------------------------------------------------------------

def _dyn_pair(dev, op, hd):
    """The same dynamic plan (one partition) on the CPU and on the card,
    and states with the same initial weights and one epoch trained on the
    CPU, the card's a copy of the CPU's."""
    from repro_torch.core import dynamic as DY
    from repro_torch.gnn.model import to_device
    g = citation_graph(num_nodes=600, num_features=32, num_classes=4,
                       seed=2)
    spec = GNNSpec(op=op, d_in=32, d_hidden=64, num_classes=4,
                   num_layers=3, heads=8)
    dcfg = DY.DynamicGASConfig(base=R.GASConfig(
        num_parts=5, history_dtype=hd, seed=1), cold_rebuild_frac=1.01)
    cplan = DY.build_dynamic_plan(g, spec, dcfg, device="cpu")
    plan = DY.build_dynamic_plan(g, spec, dcfg, device=dev, part=cplan.part)
    cstate, _ = R.fit(cplan, R.init_state(cplan), epochs=1)
    from repro_torch.train.optimizer import AdamWState
    o = cstate.opt_state
    state = R.GASState(params=to_device(cstate.params, dev),
                       opt_state=AdamWState(o.step.to(dev),
                                            to_device(o.m, dev),
                                            to_device(o.v, dev)),
                       histories=cstate.histories.to(dev), rng=cstate.rng)
    return dcfg, cplan, cstate, plan, state


def _store_tensors(store):
    h = store.sync()
    return [t.cpu().clone() for t in h.tables + (h.scales or []) + [h.age]
            + (h.codebooks or []) + (h.cb_counts or []) + (h.cb_sums or [])]


@pytest.mark.parametrize("hd", ["f32", "int8"])
@pytest.mark.parametrize("op", ["gcn", "gat", "pna"])
def test_advance_on_card_matches_cpu(dev, op, hd):
    """One incremental advance on the card against the same advance on the
    CPU: the partition and patched batches bitwise (the card's stack too),
    tables at 1e-5 (int8: codes >= 99.9% equal, the dequantized rows
    within one step), ages exact; the old state's store bitwise as it
    was; the re-push launched the pulls and pushes and no backward."""
    from repro_torch.core import delta as Dl
    from repro_torch.core import dynamic as DY
    dcfg, cplan, cstate, plan, state = _dyn_pair(dev, op, hd)
    d = Dl.random_delta(cplan.graph, edge_churn=0.01, nodes_add=2,
                        feat_frac=0.005, seed=100)
    old = _store_tensors(state.histories)
    cplan2, cstate2, cinfo = DY.advance(cplan, cstate, d, dcfg)
    _build.reset_launch_counts()
    plan2, state2, info = DY.advance(plan, state, d, dcfg)
    counts = dict(_build.launch_counts)
    assert not info.cold and dataclasses.asdict(info).keys() == \
        dataclasses.asdict(cinfo).keys()
    for f in ("closure_size", "rebuilt_parts", "reassigned",
              "num_new_nodes"):
        assert getattr(info, f) == getattr(cinfo, f), f
    assert np.array_equal(plan2.part, cplan2.part)
    for f in ("batch_nodes", "halo_nodes", "edge_dst", "edge_src",
              "edge_w"):
        a, b = getattr(plan2.batches, f), getattr(cplan2.batches, f)
        assert np.array_equal(a, b), f
        assert torch.equal(getattr(plan2.batch_stack, f).cpu(),
                           torch.from_numpy(np.ascontiguousarray(b))), f
    fam = "unit" if plan.unit_blocks else "forward"
    assert np.array_equal(getattr(plan2.batches, fam).vals,
                          getattr(cplan2.batches, fam).vals)
    h, ch = state2.histories, cstate2.histories
    assert torch.equal(h.age.cpu(), ch.age)
    n = cplan2.graph.num_nodes
    for ell in range(h.num_layers):
        if hd == "int8":
            codes = h.tables[ell].cpu()[:n]
            assert (codes == ch.tables[ell][:n]).float().mean() >= 0.999
            got = codes.float() * h.scales[ell].cpu()[:n, None]
            want = ch.tables[ell][:n].float() * ch.scales[ell][:n, None]
            step = torch.maximum(h.scales[ell].cpu()[:n],
                                 ch.scales[ell][:n])[:, None]
            assert bool((torch.abs(got - want) <= step * (1 + 1e-5)
                         + 1e-6).all())
        else:
            torch.testing.assert_close(h.tables[ell].cpu()[:n],
                                       ch.tables[ell][:n], rtol=1e-5,
                                       atol=1e-5)
    assert all(torch.equal(a, b)
               for a, b in zip(old, _store_tensors(state.histories)))
    agg = {"gcn": "bcsr_spmm", "gat": "edge_softmax_fwd",
           "pna": "pna_reduce_fwd"}[op]
    q = hd == "int8"
    for name in (agg, "gather_rows", "gather_rows_dq" if q else "gather_rows",
                 "scatter_rows_q" if q else "scatter_rows"):
        assert counts[name] > 0, (name, counts)
    assert not any(v for k, v in counts.items() if "_bwd" in k), counts


@pytest.mark.parametrize("hd", ["f32", "int8", "vq"])
def test_pinned_store_grows_pinned(dev, hd):
    """`grow` of a host store on the card, called right after a push whose
    kernels are still queued: every table and scale table pinned, and the
    grown store bitwise the device store's grow after the same push."""
    from repro_torch.core.history import HistoryStore
    n1, dims = 30_001, [64, 64]
    h = HistoryStore.create(n1, dims, history_dtype=hd, device=dev,
                            storage="host")
    d = HistoryStore.create(n1, dims, history_dtype=hd, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    idx = torch.randperm(n1 - 1, device=dev, generator=g)[:4000].to(
        torch.int32)
    vals = torch.randn(4000, 64, device=dev, generator=g)
    mask = torch.ones(4000, dtype=torch.bool, device=dev)
    for s in (d, h):
        for ell in range(len(dims)):
            s.push(ell, idx, vals * (ell + 1), mask)
    hg = h.grow(7)              # the pushes may still run on the card
    dg = d.grow(7)
    for t in hg.tables + (hg.scales or []):
        assert t.device.type == "cpu" and t.is_pinned()
    assert hg.tables[0].shape[0] == n1 + 7 and hg.storage == "host"
    assert hg.age.device.type == "cuda"
    for a, b in zip(_store_tensors(hg), _store_tensors(dg)):
        assert torch.equal(a, b)
    assert torch.equal(h.tables[0], d.tables[0].cpu())


def _dist_structs(ranks=2, n=300):
    from repro_torch.core import dist_gas as DG
    from repro_torch.core.partition import metis_like_partition
    g = citation_graph(num_nodes=n, num_features=8, num_classes=3, seed=5)
    part = metis_like_partition(g.indptr, g.indices, ranks, seed=0)
    return g, DG.build_dist_structs(g, part)


def test_dist_halo_exchange_on_card_bitwise(dev):
    """2 gloo ranks on the card (one card: both on cuda:0, the exchange
    staged through pinned host buffers): f32, bf16 and int8 halos (raw
    rows and scales) bitwise the same exchange on the CPU, the pack and
    unpack launched on every rank."""
    from repro_torch.core import _rank_bodies as RB
    from repro_torch.core import dist_gas as DG
    g, S = _dist_structs()
    n = S.num_ranks * S.rows
    vals = np.random.default_rng(0).normal(size=(n, 16)).astype(np.float32)
    q, s = ref.quantize_rows(torch.from_numpy(vals))
    args = (S, [vals, vals, q.numpy()], [None, None, s.numpy()],
            ["f32", "bf16", "int8"])
    card = DG.run_ranks(RB.exchange_rank, 2, *args, device="cuda")
    cpu = DG.run_ranks(RB.exchange_rank, 2, *args, device="cpu")
    for c, h in zip(card, cpu):
        for a, b in zip(c["halos"], h["halos"]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(c["scales"][2], h["scales"][2])
        assert c["launches"]["gather_rows_raw"] == 4
        assert c["launches"]["scatter_rows_raw"] == 4
        assert c["stats"]["staged"] == 4
        assert h["launches"]["gather_rows_raw"] == 0


@pytest.mark.parametrize("op,hd", [("gcnii", "f32"), ("gcn", "int8")])
def test_dist_superstep_on_card(dev, op, hd):
    """One superstep of 2 gloo ranks on the card against the same on the
    CPU: loss and summed gradients within 1e-5 (GCNII's through the
    layer-0 exchange's backward), f32 tables at 1e-5, int8 ones within
    one step per row with >= 99.9% of the codes equal; the row movers and,
    for int8, `scatter_rows_q` launched on every rank."""
    from repro_torch.core import _rank_bodies as RB
    from repro_torch.core import dist_gas as DG
    from repro_torch.gnn.model import init_gnn
    from repro_torch.train import checkpoint as ckpt
    g, S = _dist_structs()
    spec = dict(op=op, d_in=8, d_hidden=16, num_classes=3, num_layers=3)
    params = ckpt._flatten("", init_gnn(GNNSpec(**spec), seed=0,
                                        device="cpu"))
    job = dict(spec=spec, params=params, history_dtype=hd, steps=2,
               x=DG.permute_node_array(S, g.x),
               y=DG.permute_node_array(S, g.y.astype(np.int32)),
               m=DG.permute_node_array(S, g.train_mask), adamw=None)
    card = DG.run_ranks(RB.supersteps_rank, 2, S, job, device="cuda")
    cpu = DG.run_ranks(RB.supersteps_rank, 2, S, job, device="cpu")
    tol = dict(rtol=1e-5, atol=1e-5)
    for c, h in zip(card, cpu):
        for step in range(2):
            np.testing.assert_allclose(c["loss"][step], h["loss"][step], **tol)
            for k, v in h["grads"][step].items():
                np.testing.assert_allclose(c["grads"][step][k], v, **tol,
                                           err_msg=k)
            for ell, (a, b) in enumerate(zip(c["tables"][step],
                                             h["tables"][step])):
                if hd == "int8":
                    sc = h["scales"][step][ell][:, None]
                    np.testing.assert_allclose(c["scales"][step][ell],
                                               sc[:, 0], **tol)
                    assert np.all(np.abs(a.astype(np.float32) * sc
                                         - b.astype(np.float32) * sc)
                                  <= sc * (1 + 1e-5))
                    assert np.mean(a == b) >= 0.999
                else:
                    np.testing.assert_allclose(a, b, **tol)
        assert c["launches"]["gather_rows_raw"] > 0
        assert c["launches"]["scatter_rows_raw"] > 0
        assert (c["launches"]["scatter_rows_q"] > 0) == (hd == "int8")


# ---------------------------------------------------------------------------
# The fused epoch on the card: one CUDA graph an epoch (`runtime.
# _fused_on_card`), each test's body in a child process (`_in_child`)
# ---------------------------------------------------------------------------

# (op, GASConfig changes, regularizer weight): the cases a captured epoch
# is held to the eager body on
FUSED_CASES = {
    "gcn": ("gcn", {}, 0.0),
    "gat-int8-host1": ("gat", dict(history_dtype="int8",
                                   history_storage="host",
                                   prefetch_depth=1), 0.0),
    "gin-reg": ("gin", {}, 0.5),
    "pna-vq-cpb2": ("pna", dict(history_dtype="vq", clusters_per_batch=2,
                                vq_refit_every=1), 0.0),
    "gat-vq-refit2": ("gat", dict(history_dtype="vq", vq_refit_every=2),
                      0.0),
}


def _fused_plan(case):
    """A fused plan of `case` on the card (2,000 nodes, 8 parts, 2 layers
    32 wide) and its initial state."""
    op, cfg, reg = FUSED_CASES[case]
    g = citation_graph(num_nodes=2000, num_features=32, num_classes=4,
                       seed=1)
    spec = GNNSpec(op=op, d_in=32, d_hidden=32, num_classes=4, num_layers=2,
                   heads=2, log_deg_mean=1.5, reg_weight=reg)
    plan = R.build_plan(g, spec, R.GASConfig(num_parts=8, fused_epoch=True,
                                             **cfg),
                        device=resolve_device("cuda"))
    return plan, R.init_state(plan)


def _eager_body_epoch(plan, state, epoch):
    """`train_epoch` with the fused body run eagerly on the card (no
    graph): what each replay is held to."""
    on_card = R._fused_on_card
    R._fused_on_card = lambda p, s, fe: R.fused_body(p, s, fe)
    try:
        return R.train_epoch(plan, state, epoch)[1]
    finally:
        R._fused_on_card = on_card


def _state_bits(state):
    h = state.histories.sync()
    out = tree_leaves(state.params) + [state.opt_state.step] + \
        tree_leaves(state.opt_state.m) + tree_leaves(state.opt_state.v) + \
        h.tables + [h.age]
    for name in ("scales", "codebooks", "cb_counts", "cb_sums"):
        out += getattr(h, name) or []
    return [t.detach().cpu().clone() for t in out]


def _same(a, b):
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                    for x, y in zip(a, b))


def _counts():
    return {k: v for k, v in _build.launch_counts.items() if v}


def _child_fused_replays(case):
    """Three fused epochs of `case` beside three epochs of its body run
    eagerly: epoch 0 eager on both (the plan's first), epoch 1 the
    capture and one replay, epoch 2 one replay in another order. Each
    epoch's state and metrics compared bitwise; the launches counted in
    each epoch; epoch 2's replay and the eager body's epoch 2 in one
    torch.profiler window (device kernels and graph launches each)."""
    (gp, gs), (ep, es) = _fused_plan(case), _fused_plan(case)
    out, buffers = {"epochs": []}, []
    for e in range(3):
        _build.reset_launch_counts()
        if e < 2:
            mg = R.train_epoch(gp, gs, e)[1]
            cg = _counts()
            _build.reset_launch_counts()
            me = _eager_body_epoch(ep, es, e)
        else:
            box = {}

            def graph_epoch():
                box["g"] = R.train_epoch(gp, gs, e)[1]
                box["cg"] = _counts()
                _build.reset_launch_counts()

            def eager_epoch():
                box["e"] = _eager_body_epoch(ep, es, e)

            segs, events = _marked_segments([graph_epoch, eager_epoch])
            mg, cg, me = box["g"], box["cg"], box["e"]
            # a copy or fill is a copy activity ("Memcpy DtoD ...") in an
            # eager epoch and may run as a kernel ("memcpy32_post") in a
            # graph: the kernels compared are the rest
            kernels = [[n for n in seg if not n.lower().startswith(
                ("memcpy", "memset"))] for seg in segs]
            out["replay_kernels"] = sorted(kernels[0])
            out["eager_kernels"] = sorted(kernels[1])
            out["graph_launches"] = sum(1 for ev in events
                                        if ev.name == "cudaGraphLaunch")
        ce = _counts()
        # a regrouping that grows the padded shapes makes new buffers,
        # captured anew
        new = not any(gp._fused is b for b in buffers)
        buffers.append(gp._fused)
        out["epochs"].append(dict(
            new_buffers=new,
            metrics=mg == me, state=_same(_state_bits(gs), _state_bits(es)),
            graph_counts=cg, eager_counts=ce, order=np.random.default_rng(
                gp.config.seed * 1000 + e).permutation(
                    gp.batches.num_batches).tolist()))
    out["captures"], out["replays"] = gp._fused.captures, gp._fused.replays
    return out


def _child_fused_moves(tmp):
    """GAT over vq, refit at epoch 2: epochs 0-2 fused beside the eager
    body, then both states saved and restored (new tensors and a new
    generator) and a fourth epoch run on each; the captures and replays
    after every epoch, each epoch bitwise."""
    from repro_torch.train import checkpoint as ckpt
    (gp, gs), (ep, es) = _fused_plan("gat-vq-refit2"), \
        _fused_plan("gat-vq-refit2")
    out = []
    for e in range(4):
        if e == 3:
            ckpt.save_gas_state(f"{tmp}/g.npz", gs, step=3)
            ckpt.save_gas_state(f"{tmp}/e.npz", es, step=3)
            gs = ckpt.load_gas_state(f"{tmp}/g.npz", history_dtype="vq")[0]
            es = ckpt.load_gas_state(f"{tmp}/e.npz", history_dtype="vq")[0]
        mg = R.train_epoch(gp, gs, e)[1]
        me = _eager_body_epoch(ep, es, e)
        out.append(dict(metrics=mg == me,
                        state=_same(_state_bits(gs), _state_bits(es)),
                        captures=gp._fused.captures,
                        replays=gp._fused.replays))
    return out


def _child_fused_sync():
    """A host sync in the body (`float` of a metric where a step writes
    its row): in the plan's first fused epoch, which runs eagerly under
    the sync debug mode, and in the capture of its second. Whether each
    raised, and whether the failed capture left the state as it was (no
    step ran in its place), no graph and no replay; then, the sync
    removed, whether the epoch captures and replays."""
    gp, gs = _fused_plan("gcn")
    write = R._write_metrics

    def syncing(row, metrics):
        float(metrics["loss"])
        write(row, metrics)

    out = {}
    R._write_metrics = syncing
    try:
        R.train_epoch(gp, gs, 0)
        out["first"] = "no error"
    except RuntimeError as err:
        out["first"] = str(err)[:200]
    R._write_metrics = write
    gp, gs = _fused_plan("gcn")
    R.train_epoch(gp, gs, 0)
    before = _state_bits(gs)
    R._write_metrics = syncing
    try:
        R.train_epoch(gp, gs, 1)
        out["capture"] = "no error"
    except RuntimeError as err:
        out["capture"] = str(err)[:200]
    R._write_metrics = write
    torch.cuda.synchronize()
    out["unchanged"] = _same(before, _state_bits(gs))
    out["graph"] = gp._fused.graph is not None
    out["replays"] = gp._fused.replays
    R.train_epoch(gp, gs, 1)
    out["after"] = (gp._fused.captures, gp._fused.replays)
    return out


@pytest.mark.parametrize("case", ["gcn", "gat-int8-host1", "gin-reg",
                                  "pna-vq-cpb2"])
def test_fused_epoch_replays_match_eager_body(dev, case):
    """A fused epoch on the card is one graph launch, bitwise its body run
    eagerly: the first epoch eager (no capture), the second captured and
    replayed, the third replayed in another order; every state leaf and
    epoch metric equal in each. The launches counted at the capture equal
    the eager body's, and a replay counts none; in one profiler window
    the replay ran the eager body's device kernels, name for name, in one
    cudaGraphLaunch (copies aside, and the two fills of the generator's
    seed and offset that precede a replay that draws noise). GCN, GAT over a pinned int8
    store at depth 1, GIN with the Eq. 3 regularizer (its noise from the
    state's generator, registered with the graph) and PNA over vq with
    two clusters a batch and a refit every epoch."""
    got = _in_child("fused_replays", case=case)
    ep = got["epochs"]
    assert ep[1]["order"] != ep[2]["order"]
    for e, r in enumerate(ep):
        assert r["metrics"] and r["state"], (e, r)
    assert ep[0]["graph_counts"] == ep[0]["eager_counts"]
    assert ep[1]["graph_counts"] == ep[1]["eager_counts"]
    if ep[2]["new_buffers"]:
        # captured again over the new buffers
        assert ep[2]["graph_counts"] == ep[2]["eager_counts"]
    elif FUSED_CASES[case][1].get("vq_refit_every"):
        # the refit runs before the replay, outside the graph
        assert ep[2]["graph_counts"] and set(ep[2]["graph_counts"]) <= {
            "gather_rows_vq", "scatter_rows_vq"}
    else:
        assert ep[2]["graph_counts"] == {}
    assert got["captures"] == 1 + ep[2]["new_buffers"]
    assert got["replays"] == 2
    assert got["graph_launches"] == 1
    # the replay ran the eager body's kernels; before it PyTorch fills a
    # generator's seed and offset buffers (two int64 fills) when the graph
    # draws from it (the regularizer's noise)
    replay = collections.Counter(got["replay_kernels"])
    eager = collections.Counter(got["eager_kernels"])
    fills = {n: 2 for n in replay if "FillFunctor<long>" in n} \
        if FUSED_CASES[case][2] else {}
    assert len(fills) <= 1 and eager, (replay - eager, eager - replay)
    assert replay - eager == collections.Counter(fills) and \
        not eager - replay, (replay - eager, eager - replay)


def test_fused_epoch_follows_moved_tensors(dev, tmp_path):
    """After a vq refit (codebooks copied in place) the graph replays
    with no new capture; after a checkpoint restore (new tensors, a new
    generator) it is captured again; every epoch bitwise the eager
    body's."""
    got = _in_child("fused_moves", tmp=str(tmp_path))
    for e, r in enumerate(got):
        assert r["metrics"] and r["state"], (e, r)
    assert [(r["captures"], r["replays"]) for r in got] == \
        [(0, 0), (1, 1), (1, 2), (2, 3)]


def test_fused_epoch_host_sync_raises(dev):
    """A host sync in the body raises in the first fused epoch (eager,
    under the sync debug mode) and in the capture of the second; the
    failed capture runs no step in its place (the state as it was, no
    graph, no replay); with the sync gone the next epoch captures and
    replays."""
    got = _in_child("fused_sync")
    assert "synchroniz" in got["first"], got
    assert got["capture"] != "no error", got
    assert got["unchanged"] and not got["graph"] and got["replays"] == 0
    assert got["after"] == [1, 1]


if __name__ == "__main__":
    name, kw = sys.argv[1], json.loads(sys.argv[2]) if len(sys.argv) > 2 \
        else {}
    print(json.dumps(globals()[f"_child_{name}"](**kw)))
