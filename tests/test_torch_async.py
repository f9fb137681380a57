"""PyTorch port, the async history pipeline on the CPU: history tables in
host memory (`history_storage="host"`) and the pipelined epoch
(`prefetch_depth`).

On the CPU a host store is a CPU store that runs the card's code path: every
read goes through `gather_rows_raw`'s plain version into device-side
mini-tables. The port holds both features to its own synchronous
device-store epoch bitwise (params, AdamW moments, tables, scales, codes,
codebooks, the clock and every epoch metric), and its pipelined epochs to
the reference's device-store pipelined epochs at the same depth: floats
within 1e-5, int8 codes and scales bitwise. The reference's own
host-store tests are red (ROADMAP Queue C), so no host store of the
reference is compared against."""

import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

from repro.core import history as r_hist
from repro.core import runtime as r_rt
from repro.data.graphs import citation_graph as r_citation
from repro.gnn import model as r_model
from repro.train import checkpoint as r_ckpt

from repro_torch.core import history as t_hist
from repro_torch.core import runtime as t_rt
from repro_torch.data.graphs import citation_graph as t_citation
from repro_torch.gnn import model as t_model
from repro_torch.kernels import gather, ops, scatter
from repro_torch.launch import train_gas
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train.optimizer import tree_leaves

N, F, D, C = 150, 16, 16, 4


def _graph(n=N):
    return t_citation(num_nodes=n, num_features=F, num_classes=C, seed=7)


def _spec(op, layers=3):
    return t_model.GNNSpec(op=op, d_in=F, d_hidden=D, num_classes=C,
                           num_layers=layers, heads=2,
                           log_deg_mean=1.8 if op == "pna" else 1.0)


def _plan(op, hd, depth=0, storage="device", **cfg):
    config = t_rt.GASConfig(num_parts=3, history_dtype=hd, seed=3,
                            history_storage=storage, prefetch_depth=depth,
                            **cfg)
    return t_rt.build_plan(_graph(), _spec(op), config, device="cpu")


def _train(op, hd, depth=0, storage="device", epochs=2, **cfg):
    plan = _plan(op, hd, depth, storage, **cfg)
    state = t_rt.init_state(plan)
    metrics = []
    for e in range(epochs):
        state, m = t_rt.train_epoch(plan, state, e)
        metrics.append(m)
    return plan, state, metrics


def _leaves(state):
    h = state.histories
    return {"params": tree_leaves(state.params),
            "m": tree_leaves(state.opt_state.m),
            "v": tree_leaves(state.opt_state.v),
            "step": [state.opt_state.step], "tables": h.tables,
            "scales": h.scales or [], "age": [h.age],
            "codebooks": h.codebooks or [], "cb_counts": h.cb_counts or [],
            "cb_sums": h.cb_sums or []}


def _assert_bitwise(a, b, ma=None, mb=None):
    la, lb = _leaves(a), _leaves(b)
    for k in la:
        assert len(la[k]) == len(lb[k]), k
        for i, (x, y) in enumerate(zip(la[k], lb[k])):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{k}[{i}]"
    assert ma == mb


@pytest.mark.parametrize("hd", ["f32", "int8"])
@pytest.mark.parametrize("op", ["gcn", "gat", "pna", "gcnii"])
def test_pipelined_and_host_epochs_bitwise(op, hd):
    """Depths 1, 2 and 99 (clamped to 2 over 3 batches) over a device
    store, and depths 0 and 2 over a host store, against the synchronous
    device-store epochs: every leaf and every epoch metric bitwise. GCN
    and GCNII read the halo on the fused route (GCNII's float-table
    gradient path, now on a [max_h, d] mini-table), GAT and PNA on the
    halo-split route."""
    _, base, mb = _train(op, hd)
    for depth, storage in ((1, "device"), (2, "device"), (99, "device"),
                           (0, "host"), (2, "host")):
        plan, state, m = _train(op, hd, depth, storage)
        assert t_rt._resolved_depth(plan) == min(depth, 2)
        assert state.histories.storage == storage
        _assert_bitwise(base, state, mb, m)


@pytest.mark.parametrize("hd", ["bf16", "vq"])
def test_host_pipeline_bf16_and_vq_with_refit(hd, monkeypatch):
    """bf16 and vq stores at host/1 and device/2 against device/0 over
    three epochs with a vq refit every epoch; the host store's refit runs
    in chunks of 64 rows (its REFIT_CHUNK_ROWS is 4,096), bitwise the one
    pass of the device store."""
    monkeypatch.setattr(t_hist, "REFIT_CHUNK_ROWS", 64)
    kw = dict(epochs=3, vq_refit_every=1)
    _, base, mb = _train("gat", hd, **kw)
    for depth, storage in ((1, "host"), (2, "device")):
        _, state, m = _train("gat", hd, depth, storage, **kw)
        _assert_bitwise(base, state, mb, m)


def _reference_run(hd, depth, epochs=2):
    """The reference's pipelined epochs on "jnp" and the port's at the
    same depth, from the reference's initial params; lr 0, so that both
    see the same params through the epochs and what is compared is the
    pipeline's reads, pushes and patches (an AdamW step fed gradients a
    rounding apart moves an element at rounding level by about lr in
    either direction; tests/test_torch_train.py bounds the steps)."""
    g_kw = dict(num_nodes=N, num_features=F, num_classes=C, seed=7)
    kw = dict(op="gcn", d_in=F, d_hidden=D, num_classes=C, num_layers=3)
    rplan = r_rt.build_plan(r_citation(**g_kw), r_model.GNNSpec(**kw),
                            r_rt.GASConfig(num_parts=3, backend="jnp",
                                           history_dtype=hd, lr=0.0,
                                           prefetch_depth=depth, seed=3))
    rstate = r_rt.init_state(rplan)
    flat = {k: np.asarray(v)
            for k, v in r_ckpt._flatten(rstate.params).items()}
    tplan = t_rt.build_plan(t_citation(**g_kw), t_model.GNNSpec(**kw),
                            t_rt.GASConfig(num_parts=3, history_dtype=hd,
                                           lr=0.0, prefetch_depth=depth,
                                           seed=3), device="cpu")
    tstate = t_rt.init_state(tplan, params=t_ckpt.params_from_numpy(
        flat, device="cpu"))
    out = []
    for e in range(epochs):
        rstate, rm = r_rt.train_epoch(rplan, rstate, e)
        tstate, tm = t_rt.train_epoch(tplan, tstate, e)
        out.append((rm, tm))
    return rstate, tstate, out


@pytest.mark.parametrize("hd,depth", [("f32", 1), ("int8", 2)])
def test_pipeline_matches_reference_pipeline(hd, depth):
    rstate, tstate, metrics = _reference_run(hd, depth)
    for rm, tm in metrics:
        for k in ("loss", "ce", "acc", "hist_quant_err", "halo_age_mean",
                  "halo_age_max"):
            np.testing.assert_allclose(tm[k], rm[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    rh, th = rstate.histories, tstate.histories
    np.testing.assert_array_equal(th.age.numpy(), np.asarray(rh.age))
    flat = {k: np.asarray(v)
            for k, v in r_ckpt._flatten(rstate.opt_state).items()}
    for name, tree in (("m", tstate.opt_state.m), ("v", tstate.opt_state.v)):
        want = t_ckpt.params_from_numpy(
            {k: v for k, v in flat.items() if k.startswith(f"{name}/")},
            device="cpu")
        for a, b in zip(tree_leaves(tree), tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    for ell, (a, b) in enumerate(zip(th.tables, rh.tables)):
        if hd == "int8":
            # the codes bitwise; each scale is max|v| / 127 of pushed rows
            # that the two packages sum in other orders, so it agrees to
            # rounding (2.8e-7 relative seen), not to the bit
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_allclose(th.scales[ell].numpy(),
                                       np.asarray(rh.scales[ell]),
                                       rtol=1e-5, atol=0)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def _random_store(hd, n1=41, d=64, seed=2):
    store = t_hist.HistoryStore.create(n1, [d], history_dtype=hd,
                                       device="cpu")
    vals = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n1 - 1, d)).astype(np.float32))
    store.push(0, torch.arange(n1 - 1, dtype=torch.int32), vals,
               torch.ones(n1 - 1, dtype=torch.bool))
    return store


@pytest.mark.parametrize("hd", ["f32", "bf16", "int8", "vq"])
def test_patch_pulled_matches_fresh_pull(hd):
    """prefetch, an intervening push, `patch_pulled`, then a read of the
    view: bitwise a pull of the pushed store at the halo (the reference's
    `test_history_prefetch_patch_matches_pull`), with masked halo slots
    and masked batch rows in the push."""
    rng = np.random.default_rng(2)
    n1, max_h, max_b = 41, 7, 9
    store = _random_store(hd, n1)
    halo = torch.from_numpy(rng.choice(n1 - 1, max_h, replace=False)
                            .astype(np.int32))
    hmask = torch.arange(max_h) < max_h - 2
    pulled = store.prefetch(halo)
    # the batch pushes two valid halo rows, one masked halo row (not
    # patched: masked slots keep their prefetched bits) and others
    others = np.setdiff1d(np.arange(n1 - 1), halo.numpy())
    bnodes = torch.cat([halo[:2], halo[-1:], torch.from_numpy(
        rng.choice(others, max_b - 3, replace=False).astype(np.int32))])
    bmask = torch.ones(max_b, dtype=torch.bool)
    bmask[-1] = False
    pvals = torch.from_numpy(rng.normal(size=(max_b, 64)).astype(np.float32))
    stale = store.with_pulled(pulled).pull(
        0, torch.arange(max_h, dtype=torch.int32))
    store.push(0, bnodes, pvals, bmask)
    store.patch_pulled(pulled, halo, hmask, bnodes, bmask, (pvals,))
    got = store.with_pulled(pulled).pull(
        0, torch.arange(max_h, dtype=torch.int32))
    want = store.pull(0, halo)
    assert torch.equal(got[hmask], want[hmask])
    assert torch.equal(got[~hmask], stale[~hmask])
    assert not torch.equal(got[:2], stale[:2])


def test_resolve_history_storage_matches_reference(monkeypatch):
    monkeypatch.delenv("REPRO_HISTORY_STORAGE", raising=False)
    assert t_hist.HISTORY_STORAGES == r_hist.HISTORY_STORAGES
    for arg in (None, "device", "host"):
        assert t_hist.resolve_history_storage(arg) == \
            r_hist.resolve_history_storage(arg)
    monkeypatch.setenv("REPRO_HISTORY_STORAGE", "host")
    assert t_hist.resolve_history_storage(None) == \
        r_hist.resolve_history_storage(None) == "host"
    assert t_hist.resolve_history_storage("device") == "device"
    plan = _plan("gcn", "f32", storage=None)   # left to the environment
    assert plan.history_storage == "host"
    assert t_rt.init_state(plan).histories.storage == "host"
    for bad in ("pcie", "vmem"):
        with pytest.raises(ValueError) as te:
            t_hist.resolve_history_storage(bad)
        with pytest.raises(ValueError) as re_:
            r_hist.resolve_history_storage(bad)
        assert str(te.value) == str(re_.value)
    monkeypatch.setenv("REPRO_HISTORY_STORAGE", "pcie")
    with pytest.raises(ValueError, match="storage must be one of"):
        t_rt.build_plan(_graph(), _spec("gcn"),
                        t_rt.GASConfig(num_parts=3), device="cpu")


@pytest.mark.parametrize("hd", ["int8", "vq"])
def test_host_checkpoint_roundtrip_then_an_epoch(tmp_path, hd):
    """A host store saved after one pipelined epoch and restored with
    history_storage="host" stays host and bitwise; one more epoch from it
    equals one more from the uninterrupted state, bitwise."""
    plan, state, _ = _train("gcn", hd, 1, "host", epochs=1)
    path = str(tmp_path / "host.npz")
    t_ckpt.save_gas_state(path, state, step=1)
    back, step = t_ckpt.load_gas_state(path, device="cpu",
                                       history_storage="host")
    assert step == 1 and back.histories.storage == "host"
    _assert_bitwise(state, back)
    s1, m1 = t_rt.train_epoch(plan, state, 1)
    s2, m2 = t_rt.train_epoch(plan, back, 1)
    _assert_bitwise(s1, s2, m1, m2)


def test_host_store_placement_clone_and_predict():
    """A host store's bytes split into the device's (the clock, codebooks
    and statistics) and the host's (tables and scales); its clone is its
    own and a host store; `predict` over it equals the device store's
    and leaves the state as it was."""
    plan, state, _ = _train("gcn", "vq", 1, "host", epochs=1)
    h = state.histories
    nb = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa
    assert h.placement_bytes() == {
        "device": nb([h.age] + h.codebooks + h.cb_counts + h.cb_sums),
        "host": nb(h.tables + h.scales)}
    c = h.clone()
    assert c.storage == "host" and all(
        a.data_ptr() != b.data_ptr() for a, b in zip(c.tables, h.tables))
    dplan, dstate, _ = _train("gcn", "vq", epochs=1)
    assert dstate.histories.placement_bytes()["host"] == 0
    before = [t.clone() for t in h.tables]
    assert torch.equal(t_rt.predict(plan, state), t_rt.predict(dplan, dstate))
    assert all(torch.equal(a, b) for a, b in zip(before, h.tables))


def test_pipelined_step_call_order(monkeypatch):
    """The wrapper calls of one depth-2 step, in order: the forward's
    reads come from the prefetched mini-tables (no raw gather before the
    first push), then the layers' pushes into the store, then the patch
    of the other entry in flight (a push into its mini-table), then the
    prefetch of batch i + 2 (raw gathers), and only then the backward's
    contractions: the prefetch overlaps the backward and the update, and
    never a push (`runtime.prefetch_step`)."""
    plan = _plan("gcn", "f32", depth=2)
    state = t_rt.init_state(plan)
    order = [0, 1, 2]
    queue = tuple(t_rt._prefetch_entry(plan, state.histories, plan.batch(b))
                  for b in order[:2])
    calls = []

    def spy(module, name, table_arg=None):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            mini = table_arg is not None and a[table_arg].shape[0] != N + 1
            calls.append(name + ("(mini)" if mini else ""))
            return fn(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    spy(ops, "scatter_rows", table_arg=0)
    spy(ops, "gather_spmm", table_arg=1)
    spy(ops, "bcsr_spmm")
    spy(t_hist, "gather_rows_raw_many")
    state, _, queue = t_rt.prefetch_step(plan, state, plan.batch(0),
                                         plan.batch(2), queue)
    assert len(queue) == 2
    at = {c: [i for i, x in enumerate(calls) if x == c] for c in set(calls)}
    # forward: layer 0 on the blocks, layers 1-2 fused over mini-tables,
    # the two hidden layers pushed into the [N+1, d] tables
    assert len(at["scatter_rows"]) == 2 and "gather_spmm" not in at
    assert len(at["gather_spmm(mini)"]) == 2
    last_push = at["scatter_rows"][-1]
    assert at["gather_spmm(mini)"][-1] > last_push
    # then the other entry's patch (a push into each mini-table), the
    # prefetch of batch 2, and only then the backward
    patches, raw = at["scatter_rows(mini)"], at["gather_rows_raw_many"]
    assert len(patches) == 2 and len(raw) == 1     # both layers, one call
    bwd = [i for i in at["bcsr_spmm"] if i > last_push]
    assert last_push < patches[0] and patches[-1] < raw[0] < bwd[0]
    assert not [i for i in raw if i < last_push]


def test_launcher_host_storage_and_prefetch_depth():
    out = train_gas.main(["--device", "cpu", "--smoke", "--history-storage",
                          "host", "--prefetch-depth", "1"])
    assert all(np.isfinite(m["loss"]) for m in out["epochs"])
    assert out["predict_test_acc"] > 0.5


def test_raw_gather_plain_version_clips_every_width():
    """`gather_rows_raw` on CPU tensors: the raw bits of every element
    width and of 1-d scale tables, indices clipped to the table."""
    rng = np.random.default_rng(0)
    idx = torch.tensor([3, -4, 0, 99, 7], dtype=torch.int32)
    for t in (torch.randn(8, 5), torch.randn(8, 3).to(torch.bfloat16),
              torch.from_numpy(rng.integers(-127, 128, (8, 37), np.int8)),
              torch.from_numpy(rng.integers(0, 256, (8, 8), np.uint8)),
              torch.rand(8)):
        got = gather.gather_rows_raw(t, idx)
        assert got.dtype == t.dtype and torch.equal(
            got, t[torch.tensor([3, 0, 0, 7, 7])])
    assert scatter.SCAN_MAX_ROWS == t_hist.REFIT_CHUNK_ROWS


@pytest.mark.parametrize("hd", ["f32", "int8"])
def test_gas_forward_over_a_host_store_bitwise(hd):
    """`core.gas.gas_forward`, the layer-callback executor, reads a host
    store through prefetched mini-tables on both of its routes (the fused
    hook gets the mini-table and arange(max_h) as its halo ids): two
    passes, outputs, tables and diagnostics bitwise a device store's."""
    from repro_torch.core import gas as t_gas
    plan = _plan("gcn", hd)
    batch = plan.batch(1)
    ws = [torch.from_numpy(np.random.default_rng(i).normal(
        size=(F if i == 0 else D, D)).astype(np.float32) * 0.3)
        for i in range(3)]

    def apply(ell, x_all, bt):
        return torch.tanh(ops.gcn_aggregate(
            x_all, None, None, bt.max_b, bt.blocks) @ ws[ell])

    def fused(ell, x_cur, halo_src, bt):
        table, scales, codebook, hn, hm = halo_src
        agg = ops.gas_aggregate(x_cur, table, hn, hm, bt.max_b, bt.blocks,
                                scales=scales, codebook=codebook)
        return torch.tanh(agg @ ws[ell])

    for hook in (None, fused):
        out = {}
        for storage in ("device", "host"):
            store = t_hist.HistoryStore.create(N + 1, [D, D],
                                               history_dtype=hd,
                                               device="cpu", storage=storage)
            for _ in range(2):      # the second pass reads the first's
                y, store, diags = t_gas.gas_forward(
                    apply, 3, plan.x, batch, store, fused_layer_apply=hook)
            out[storage] = (y, store.tables + (store.scales or []), diags)
        (ya, ta, da), (yb, tb, db) = out["device"], out["host"]
        assert torch.equal(ya, yb) and da.keys() == db.keys()
        assert all(torch.equal(a, b) for a, b in zip(ta, tb))
        assert all(torch.equal(da[k], db[k]) for k in da)
