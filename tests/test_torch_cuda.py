"""PyTorch port on the card: each CUDA kernel against its plain version,
and a training step on the card against the same step on the CPU.

Every test here is marked `cuda` and skips without a CUDA device (decided
inside the `dev` fixture, never at import). On a machine with the card
and `nvcc`:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The first call builds the kernels (kernels/_build.py). Tolerances: the
row max M of the edge softmax is bitwise its plain version's (a max over
the same scores); everything else compares at rtol = atol = 1e-4 (sums
in another order, and expf against torch.exp in the last bits); a warm
repeat of each kernel is bitwise identical (no atomics)."""
import numpy as np
import pytest
import torch

from repro_torch.core import runtime as R
from repro_torch.core.config import resolve_device
from repro_torch.data.graphs import citation_graph
from repro_torch.gnn.model import GNNSpec
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import edge_softmax as esk
from repro_torch.kernels.bcsr_spmm import bcsr_spmm
from repro_torch.train.optimizer import tree_leaves

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return resolve_device("cuda")


def _blocks(seed, n_out, M, ne, empty_from=None):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, empty_from or n_out, ne).astype(np.int32)
    src = rng.integers(0, M - 40, ne).astype(np.int32)
    dst[:ne // 10], src[:ne // 10] = dst[ne // 10:ne // 5], \
        src[ne // 10:ne // 5]                         # duplicate edges
    ones = np.ones(ne, np.float32)
    uv, uc, _, _ = ops.build_bcsr_rect(dst, src, ones, n_out, M)
    uvt, uct, _, _ = ops.build_bcsr_rect(src, dst, ones, M, n_out)
    return [torch.from_numpy(a) for a in (uv, uc, uvt, uct)], rng


@pytest.mark.parametrize("H,F,n_out,M", [(8, 8, 194, 474), (1, 7, 194, 474),
                                         (2, 20, 300, 700), (12, 3, 130, 260)])
def test_edge_softmax_kernels_match_plain(dev, H, F, n_out, M):
    """The three kernels at GAT's layer shapes on the Cora-shaped batches
    (8 heads of 8, one head of 7), F past one register tile, H past one
    CTA's 8 heads; the last 40 sources are reached by no edge and carry
    poisoned values."""
    (uv, uc, uvt, uct), rng = _blocks(H + F, n_out, M, 6 * n_out,
                                      empty_from=n_out - 5)
    wx = rng.normal(size=(M, H, F)).astype(np.float32)
    as_ = rng.normal(size=(M, H)).astype(np.float32)
    wx[M - 40:] = 1e30
    as_[M - 40:] = 50.0
    ad = rng.normal(size=(n_out, H)).astype(np.float32)
    g = rng.normal(size=(n_out, H, F)).astype(np.float32)
    cpu = [torch.from_numpy(a) for a in (ad, as_, wx, g)]
    ad_d, as_d, wx_d, g_d = (t.to(dev) for t in cpu)
    uv_d, uc_d, uvt_d, uct_d = (t.to(dev) for t in (uv, uc, uvt, uct))

    out, mm, ll = esk.edge_softmax_fwd(ad_d, as_d, wx_d, uv_d, uc_d)
    p_out, p_mm, p_ll = ref.edge_softmax_fwd_ref(ad_d, as_d, wx_d, uv_d,
                                                 uc_d)
    assert torch.equal(mm, p_mm)
    torch.testing.assert_close(out, p_out, **TOL)
    torch.testing.assert_close(ll, p_ll, **TOL)
    assert torch.all(out[n_out - 5:] == 0)
    delta = (g_d * p_out).sum(-1)
    dad = esk.edge_softmax_bwd_row(ad_d, as_d, wx_d, g_d, p_mm, p_ll, delta,
                                   uv_d, uc_d)
    torch.testing.assert_close(dad, ref.edge_softmax_bwd_row_ref(
        ad_d, as_d, wx_d, g_d, p_mm, p_ll, delta, uv_d, uc_d), **TOL)
    dwx, das = esk.edge_softmax_bwd_col(ad_d, as_d, wx_d, g_d, p_mm, p_ll,
                                        delta, uvt_d, uct_d)
    p_dwx, p_das = ref.edge_softmax_bwd_col_ref(ad_d, as_d, wx_d, g_d, p_mm,
                                                p_ll, delta, uvt_d, uct_d)
    torch.testing.assert_close(dwx, p_dwx, **TOL)
    torch.testing.assert_close(das, p_das, **TOL)
    assert torch.all(dwx[M - 40:] == 0) and torch.all(das[M - 40:] == 0)
    # a warm repeat is bitwise the same
    again = esk.edge_softmax_bwd_col(ad_d, as_d, wx_d, g_d, p_mm, p_ll,
                                     delta, uvt_d, uct_d)
    assert torch.equal(again[0], dwx) and torch.equal(again[1], das)
    assert torch.equal(esk.edge_softmax_fwd(ad_d, as_d, wx_d, uv_d,
                                            uc_d)[0], out)


def test_autograd_functions_launch_their_kernels(dev):
    """`ops.edge_softmax_aggregate` and `ops.gcn_aggregate` on the card:
    the backward launches the backward kernels (bcsr_spmm on the
    transposed blocks for GCN) and agrees with the same op on the CPU."""
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


@pytest.mark.parametrize("op", ["gcn", "gat"])
def test_train_step_on_card_matches_cpu(dev, op):
    """Two steps on both devices, each from the same state (the CPU state
    takes the card's before the second): loss, gradients and history
    tables at 1e-4. The update then runs on both devices from the card's
    gradients (fed their own, an element whose gradient sits at rounding
    level moves by lr one way and not the other in AdamW's first steps):
    params at lr * 1e-4 absolute, the moments at 1e-4 relative, as the
    clip's global norm sums the squares in another order on each
    device."""
    g = citation_graph(num_nodes=600, num_features=40, num_classes=4,
                       seed=1)
    spec = GNNSpec(op=op, d_in=40, d_hidden=32, num_classes=4,
                   num_layers=2, heads=4)
    cfg = R.GASConfig(num_parts=4)
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
    return (tree_leaves(state.params) + tree_leaves(opt.m)
            + tree_leaves(opt.v) + list(state.histories.tables)
            + [state.histories.age, opt.step])


def test_bcsr_spmm_on_transposed_blocks(dev):
    """The GCN backward's use of bcsr_spmm: the transposed family (more
    row blocks than columns) against the plain version."""
    (_, _, vt, ct), rng = _blocks(9, 260, 700, 2000)
    gout = torch.from_numpy(rng.normal(size=(260, 64)).astype(np.float32))
    got = bcsr_spmm(gout.to(dev), vt.to(dev), ct.to(dev))
    torch.testing.assert_close(got.cpu(), ref.bcsr_spmm_ref(gout, vt, ct),
                               **TOL)
