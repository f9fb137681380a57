"""PyTorch port, the raw history pull and push over many tables, on the
CPU against the JAX package.

`gather_rows_raw_many` and `scatter_rows_raw_many` (`kernels/gather.py`,
`kernels/scatter.py`) move the rows of every table a prefetch or a raw
push touches under one index, in one launch on the card
(`csrc/gather.cu`, `csrc/scatter.cu`). Their plain versions, which the CPU
runs, are held here table by table against the reference's own moves:
`jnp.take(..., mode="clip")` (`src/repro/core/history.py:595-601`) and
`.at[safe].set(..., mode="drop")` (`src/repro/core/serve_service.py:
255-298`), bitwise, over tables of mixed widths (uint8 codes [N, 8], f32
scales [N], bf16 rows [N, 64], int8 codes [N, 256]) in one call. A push
with repeats and dropped rows takes each target's rows in every table from
the same pushed row. `HistoryStore.prefetch`, a host store's `pull`, the
serving backend's `_op_pull` and `HistoryStore.push_raw` each make exactly
one many-table call."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

from repro_torch.core import history as t_hist
from repro_torch.core import serve_service as t_ss
from repro_torch.core.history import HistoryStore
from repro_torch.kernels import gather as t_gather
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import scatter as t_scatter

N = 41
# (dtype, width past the first axis): the widths of a prefetch's tables
WIDTHS = ((torch.uint8, (8,)), (torch.float32, ()), (torch.bfloat16, (64,)),
          (torch.int8, (256,)))


def _table(rng, dtype, shape):
    """Random bits of `dtype` (floats drawn as normals)."""
    if dtype.is_floating_point:
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dtype)
    lo = -128 if dtype == torch.int8 else 0
    return torch.from_numpy(rng.integers(lo, lo + 256, size=shape)).to(dtype)


def _tables(seed, count, n=N):
    rng = np.random.default_rng(seed)
    return [_table(rng, *WIDTHS[j % len(WIDTHS)][:1],
                   (n,) + WIDTHS[j % len(WIDTHS)][1])
            for j in range(count)]


def _np(t):
    """A tensor's bits as numpy, bf16 as jnp.bfloat16."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _bits(x):
    """Bitwise-comparable numpy of a jax array or a tensor."""
    a = _np(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _idx(seed, m):
    """Indices below 0, at N and past it, the table's edges and random
    ones, with repeats."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-5, N + 5, m).astype(np.int32)
    idx[: min(m, 6)] = np.array([-7, 0, N - 1, N, N + 3, 2 ** 31 - 1],
                                np.int32)[: min(m, 6)]
    return idx


@pytest.mark.parametrize("count,m", [(4, 40), (4, 0), (1, 17), (65, 23)],
                         ids=["mixed", "M0", "one-1d", "65"])
def test_gather_many_is_reference_take(count, m):
    """Each output bitwise the reference's `jnp.take(table, idx,
    mode="clip")` of its table; one output a table, in order, of the
    table's type and width."""
    tables = _tables(count, count)
    if count == 1:
        tables = [tables[0].float()[:, 0].contiguous()]     # a 1-d table
    idx = _idx(m, m)
    got = t_gather.gather_rows_raw_many(tables, torch.from_numpy(idx))
    assert len(got) == len(tables)
    for t, g in zip(tables, got):
        want = jnp.take(jnp.asarray(_np(t)), jnp.asarray(idx), axis=0,
                        mode="clip")
        assert g.dtype == t.dtype and g.shape == (m,) + t.shape[1:]
        np.testing.assert_array_equal(_bits(g), _bits(want))


@pytest.mark.parametrize("count", [4, 65])
def test_scatter_many_is_reference_set(count):
    """Each table after the push bitwise the reference's `.at[safe].set(
    rows, mode="drop")` of its table (masked rows sent to N, past the
    table, and dropped; repeated indices take the last row), the rows
    never converted."""
    tables = _tables(100 + count, count)
    m = 30
    # the reference's pushes name no negative index (`jnp.where(mask, idx,
    # N)` over node ids), and `.at[]` would wrap one
    idx = np.abs(_idx(count, m))
    idx[10:16] = idx[:6]                        # repeats of earlier rows
    rows = [t[:m].clone() for t in _tables(200 + count, count, n=m)]
    want = [jnp.asarray(_np(t)).at[jnp.asarray(idx)].set(
        jnp.asarray(_np(r)), mode="drop") for t, r in zip(tables, rows)]
    out = t_scatter.scatter_rows_raw_many(tables, torch.from_numpy(idx),
                                          rows)
    assert all(a is b for a, b in zip(out, tables))
    for t, w in zip(tables, want):
        np.testing.assert_array_equal(_bits(t), _bits(w))


def test_scatter_many_one_winner_for_every_table():
    """Repeats and dropped rows: each target's rows in every table (codes,
    scales, rows of each width) come from its last pushed row, and no
    dropped row lands anywhere."""
    m, n = 64, 20
    rng = np.random.default_rng(5)
    idx = rng.integers(-3, n + 3, m).astype(np.int32)
    idx[40:50] = idx[0:10]
    # pushed row i carries i in every table, so a target's winner reads
    # back from each of them
    pos = np.arange(m)
    rows = [torch.from_numpy(np.repeat(pos[:, None], 8, 1)).to(torch.uint8),
            torch.from_numpy(pos.astype(np.float32)),
            torch.from_numpy(np.repeat(pos[:, None], 64, 1).astype(
                np.float32)).to(torch.bfloat16),
            torch.from_numpy(np.repeat(pos[:, None], 256, 1)).to(torch.int8)]
    untouched = 100                             # no pushed row's mark
    tables = [torch.full((n,) + r.shape[1:], untouched, dtype=r.dtype)
              for r in rows]
    t_scatter.scatter_rows_raw_many(tables, torch.from_numpy(idx), rows)
    for t in range(n):
        hits = np.nonzero(idx == t)[0]
        want = hits[-1] if hits.size else untouched
        for table in tables:
            got = table[t].reshape(-1).float()
            assert torch.all(got == got[0]), "a row mixes two pushes"
            assert int(got[0]) == want, (t, table.dtype)


def test_raw_many_validation_on_cpu():
    """The checks the CPU reaches: rows of another dtype (TypeError) or
    shape (ValueError) than their table, a row set for each table."""
    tables = _tables(7, 4)
    idx = torch.arange(5, dtype=torch.int32)
    rows = [t[:5].clone() for t in tables]
    bad = list(rows)
    bad[2] = bad[2].float()
    with pytest.raises(TypeError):
        t_scatter.scatter_rows_raw_many(tables, idx, bad)
    bad = list(rows)
    bad[3] = bad[3][:, :100].contiguous()
    with pytest.raises(ValueError):
        t_scatter.scatter_rows_raw_many(tables, idx, bad)
    bad = list(rows)
    bad[0] = bad[0][:4]
    with pytest.raises(ValueError):
        t_scatter.scatter_rows_raw_many(tables, idx, bad)
    with pytest.raises(ValueError):
        t_scatter.scatter_rows_raw_many(tables, idx, rows[:3])
    with pytest.raises(TypeError):
        t_scatter.scatter_rows_raw(tables[1], idx, rows[1].double())
    # nothing was written by the refused calls
    assert all(torch.equal(a, b) for a, b in zip(tables, _tables(7, 4)))


def _spy(monkeypatch, name):
    """Count the calls of `core.history`'s `name`, still calling it."""
    calls = []
    fn = getattr(t_hist, name)

    def wrapped(tables, *a, **k):
        calls.append(len(tables))
        return fn(tables, *a, **k)

    monkeypatch.setattr(t_hist, name, wrapped)
    return calls


def _store(hd, storage="device"):
    """A seeded store of 3 layers, 16 wide (two 8-wide vq subvectors)."""
    store = HistoryStore.create(N + 1, [16, 16, 16], hd, "cpu",
                                storage=storage)
    g = torch.Generator().manual_seed(3)
    idx = torch.randperm(N, generator=g)[:30].to(torch.int32)
    for ell in range(3):
        store.push(ell, idx, torch.randn(30, 16, generator=g),
                   torch.ones(30, dtype=torch.bool))
    return store


@pytest.mark.parametrize("hd", ["f32", "bf16", "int8", "vq"])
def test_store_reads_and_raw_push_are_one_call(monkeypatch, hd):
    """`prefetch` (every layer), a host store's `pull` (one layer),
    `_op_pull` and `push_raw` each make exactly one many-table call over
    every table they touch (a layer's table and, for int8 and vq, its
    scale table), and read or write what the one-table plain versions
    do."""
    pulls = _spy(monkeypatch, "gather_rows_raw_many")
    pushes = _spy(monkeypatch, "scatter_rows_raw_many")
    per = 2 if hd in ("int8", "vq") else 1
    store = _store(hd)
    idx = torch.from_numpy(_idx(9, 25))
    pulled = store.prefetch(idx)
    assert pulls == [3 * per]
    for ell, (rows, scl) in enumerate(pulled):
        assert torch.equal(rows, t_ref.gather_rows_raw_ref(
            store.tables[ell], idx))
        assert (scl is None) == (per == 1)
        if scl is not None:
            assert torch.equal(scl, t_ref.gather_rows_raw_ref(
                store.scales[ell], idx))
    host = _store(hd, storage="host")
    got = host.pull(1, idx)
    assert pulls == [3 * per, per]
    assert torch.equal(got, store.pull(1, idx))
    backend = types.SimpleNamespace(state=types.SimpleNamespace(
        histories=store))
    meta, arrays = t_ss.HistoryBackend._op_pull(backend, {}, [idx.numpy()])
    assert pulls == [3 * per, per, 3 * per]
    assert len(arrays) == 3 * per and meta["scaled"] == (per == 2)
    mask = torch.ones(25, dtype=torch.bool)
    mask[::4] = False
    rows = [torch.flip(p[0], [0]) for p in pulled]
    scales = [torch.flip(p[1], [0]) for p in pulled] if per == 2 else None
    want = [t.clone() for t in store.tables + (store.scales or [])]
    safe = torch.where(mask, idx, N + 1).to(torch.int32)
    for t, r in zip(want, rows + (scales or [])):
        t_ref.scatter_rows_raw_ref(t, safe, r)
    store.push_raw(idx, mask, rows, scales)
    assert pushes == [3 * per]
    assert all(torch.equal(a, b) for a, b in zip(
        store.tables + (store.scales or []), want))
