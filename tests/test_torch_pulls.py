"""PyTorch port, the history pull's index clip and the COO route's sums,
on the CPU against the JAX package.

Every pull clips its indices to [0, N - 1] inside its one kernel launch
(`csrc/gather.cu`), so `ops.pull_rows` launches no clamp before it; the
plain versions clip the same way. Here `pull_rows` and each plain pull
(`gather_rows_ref` over f32 and bf16 tables, `gather_rows_dq_ref` over
int8, `gather_rows_vq_ref` over vq codes), given indices below 0, at N
and past it, are bitwise the reference's `pull_rows` on its "jnp" route,
which clips with `jnp.clip` (`src/repro/kernels/ops.py:582`).

`ref.segment_sum` is every per-destination sum of the COO route
(`gcn_aggregate` without blocks, the segment edge softmax and PNA
reduction, SGC's propagation, the distributed exchange's backward). On
the CPU it is `index_add` exactly, its gradient included, so no CPU
result of those routes moves; on the card it sums in an order that does
not change from run to run (`tests/test_torch_cuda.py` holds
`full_forward` bitwise across two runs)."""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

from repro.core.history import vq_init_codebook as r_vq_init_codebook
from repro.kernels import ops as r_ops

from repro_torch.kernels import gather as t_gather
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

T = torch.from_numpy
J = jnp.asarray
N = 57


def _idx(seed, m=40):
    """Indices below 0, at N and past it, the edges of the table and
    random ones in between, with duplicates."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-10, N + 10, m).astype(np.int32)
    idx[:7] = (-7, -1, 0, N - 1, N, N + 3, np.iinfo(np.int32).max)
    idx[-1] = idx[m // 2]
    return idx


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


@pytest.mark.parametrize("kind,d", [(k, d) for k in ("f32", "bf16", "int8")
                                    for d in (20, 64)]
                         + [("vq", 16), ("vq", 64)])
def test_pulls_clip_like_reference(kind, d):
    """`pull_rows`, the wrapper and the plain version of each store's
    pull, bitwise the reference's `pull_rows` ("jnp") on the same numpy
    table and out-of-range indices."""
    rng = np.random.default_rng(d)
    idx = _idx(d)
    v = rng.normal(size=(N, d)).astype(np.float32)
    kw, t_kw = {}, {}
    if kind in ("f32", "bf16"):
        v[0, :3] = (np.nan, np.inf, -0.0)       # copied bit for bit
        table = T(v).to(torch.bfloat16) if kind == "bf16" else T(v)
        r_table = J(table.view(torch.int16).numpy().view(jnp.bfloat16)
                    if kind == "bf16" else v)
        plain = t_ref.gather_rows_ref(table, T(idx))
        wrapper = t_gather.gather_rows(table, T(idx))
    elif kind == "int8":
        q, s = t_ref.quantize_rows(T(v))
        table, r_table = q, J(q.numpy())
        kw, t_kw = dict(scales=J(s.numpy())), dict(scales=s)
        plain = t_ref.gather_rows_dq_ref(q, s, T(idx))
        wrapper = t_gather.gather_rows_dq(q, s, T(idx))
    else:
        cb = np.array(r_vq_init_codebook(d))
        q, s = t_ref.vq_encode_rows(T(v), T(cb))
        table, r_table = q, J(q.numpy())
        kw = dict(scales=J(s.numpy()), codebook=J(cb))
        t_kw = dict(scales=s, codebook=T(cb))
        plain = t_ref.gather_rows_vq_ref(q, T(cb), s, T(idx))
        wrapper = t_gather.gather_rows_vq(q, T(cb), s, T(idx))
    want = _bits(r_ops.pull_rows(r_table, J(idx), backend="jnp", **kw))
    got = t_ops.pull_rows(table, T(idx), **t_kw)
    assert got.shape == (len(idx), d)
    for out in (got, plain, wrapper):
        o = out.view(torch.int16) if out.dtype == torch.bfloat16 else out
        np.testing.assert_array_equal(_bits(o.numpy()), want)


def test_pull_rows_launches_no_clamp(monkeypatch):
    """`pull_rows` hands its indices to the pull as they are (the kernel
    clips them): no clamp, no copy of an int32 index."""
    seen = []
    monkeypatch.setattr(t_ops, "gather_rows",
                        lambda table, idx: seen.append(idx) or table[:0])
    idx = T(_idx(1))
    t_ops.pull_rows(torch.zeros(N, 4), idx)
    assert seen[0] is idx


def _coo(seed, n, e, shape):
    """Random COO into n destinations (duplicates and destinations
    without edges) and messages x[src] * w with a tenth of the edge
    weights 0, as the padded batches carry them."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n - 3, e)
    dst[: e // 4] = dst[e // 4: 2 * (e // 4)]
    x = T(rng.normal(size=(e,) + shape).astype(np.float32))
    w = rng.random(e).astype(np.float32)
    w[rng.random(e) < 0.1] = 0.0
    w = T(w).reshape((e,) + (1,) * len(shape))
    return T(dst), x, w


@pytest.mark.parametrize("shape", [(), (7,), (3, 5)], ids=["E", "ExF",
                                                           "ExHxF"])
def test_segment_sum_is_index_add_on_cpu(shape):
    """Bitwise `index_add` into zeros, the gradient of its messages
    bitwise `index_add`'s too."""
    n = 50
    dst, x, w = _coo(len(shape), n, 400, shape)
    outs, grads = [], []
    g = torch.randn((n,) + shape, generator=torch.Generator().manual_seed(0))
    for fn in (lambda m: t_ref.segment_sum(dst, m, n),
               lambda m: torch.zeros((n,) + shape).index_add_(0, dst, m)):
        xx = x.clone().requires_grad_(True)
        out = fn(xx * w)
        out.backward(g)
        outs.append(out.detach())
        grads.append(xx.grad)
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    assert torch.equal(grads[0].view(torch.int32),
                       grads[1].view(torch.int32))
    assert (outs[0][n - 3:] == 0).all()


def test_gcn_aggregate_coo_route_is_index_add_on_cpu():
    """`gcn_aggregate` without blocks (the full-graph forward's route):
    bitwise the `index_add_` it ran before the sums went through
    `segment_sum`, the trash row dropped."""
    n_out, m, e = 40, 60, 300
    rng = np.random.default_rng(3)
    x_all = T(rng.normal(size=(m + 1, 9)).astype(np.float32))
    dst = T(rng.integers(0, n_out + 1, e).astype(np.int32))
    src = T(rng.integers(0, m + 1, e).astype(np.int32))
    w = T(rng.random(e).astype(np.float32))
    got = t_ops.gcn_aggregate(x_all, (dst, src), w, n_out)
    want = torch.zeros(n_out + 1, 9).index_add_(
        0, dst.long(), x_all[src.long()] * w[:, None])[:n_out]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
