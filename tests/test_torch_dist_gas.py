"""PyTorch port, distributed GAS against the JAX reference.

Host structures compare bitwise: `build_dist_structs` (sizes, the id maps,
the rank-stacked batch, the routing tables) and `permute_node_array` for
2, 3 and 4 ranks on two seeded graphs, from the reference's partition.

The supersteps run once in each package over the same 200-node graph, 4
ranks and the port's initial params carried across: the reference in one
subprocess (4 host devices, `jax.jit(jax.value_and_grad(loss_fn))` under
`shard_map`), the port in 4 spawned gloo ranks on the CPU (the kernels'
plain versions), at the same time. Each case runs 3 supersteps from fixed
params. Tolerances: loss, accuracy, logits, pushed f32 tables and the
summed gradients at rtol = atol = 1e-5 for the six operators over f32
(GCNII's and APPNP's gradients pass through the layer-0 exchange's
backward); GCN over bf16 and int8 the same for the floats, its pushed
tables within one step of the store's precision per row with at least
99.9% of the codes equal (as tests/test_torch_quant.py holds them). The
int8 halo exchange is bitwise a direct gather of the same rows and
scales (as tests/test_dist_gas.py states it) and bitwise the reference's
exchanged halo; with fixed params the logits converge to the exact
full-graph forward within 1e-3 after num_layers supersteps
(tests/test_dist_gas.py's property, for every operator); after an AdamW
superstep every rank holds the same params, bit for bit.

`python tests/test_torch_dist_gas.py --reference IN.npz OUT.npz` is the
reference's side of those runs. `python tests/test_torch_dist_gas.py
--reference-acc [PARTITION.npz]` prints the reference example's test
accuracy (`examples/distributed_gas.py`: 2,000 nodes, 4 ranks, 80
supersteps) from the port's initial params, on this host's partition or
on the one in the file, with the partition's digest, for chip_smoke.py's
phase 8."""
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":      # the reference's side runs on 4 host devices
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

from repro.core import dist_gas as r_dg
from repro.core.partition import metis_like_partition as r_metis
from repro.data.graphs import citation_graph as r_citation

from repro_torch.core import _rank_bodies as t_rb
from repro_torch.core import dist_gas as t_dg
from repro_torch.core.gas import gcn_edge_weights
from repro_torch.data.graphs import citation_graph as t_citation
from repro_torch.examples import distributed_gas as t_example
from repro_torch.gnn import model as t_model
from repro_torch.kernels import ref as t_ref
from repro_torch.train import checkpoint as t_ckpt

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
RANKS = 4
GRAPH = dict(num_nodes=200, num_features=8, num_classes=3, seed=4)
STEPS = 3
SPEC = dict(d_in=8, d_hidden=8, num_classes=3, num_layers=3, heads=2,
            log_deg_mean=1.8)
# (name, op, history precision); "gcn legacy" runs on a list of tables
CASES = (("gcn f32", "gcn", "f32"), ("gin f32", "gin", "f32"),
         ("gat f32", "gat", "f32"), ("gcnii f32", "gcnii", "f32"),
         ("appnp f32", "appnp", "f32"), ("pna f32", "pna", "f32"),
         ("gcn bf16", "gcn", "bf16"), ("gcn int8", "gcn", "int8"))
F32_CASES = [c for c in CASES if c[2] == "f32"]
ADAMW = dict(lr=0.01, b1=0.9, b2=0.999, weight_decay=5e-4, clip=2.0)
EXAMPLE_ACC_CASE = "gcnii f32"   # the case that also takes an AdamW step


def _structs_equal(rs, ts):
    for k in ("num_ranks", "rows", "max_halo", "max_edges"):
        assert getattr(rs, k) == getattr(ts, k), k
    for k in ("sizes", "old_of_new", "new_of_old", "send_idx", "send_mask",
              "recv_pos"):
        a, b = getattr(rs, k), getattr(ts, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in ("batch_nodes", "batch_mask", "halo_nodes", "halo_mask",
              "edge_dst", "edge_src", "edge_w"):
        a, b = getattr(rs.batch, k), getattr(ts.batch, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in ("num_batches", "max_b", "max_h", "max_e"):
        assert getattr(rs.batch, k) == getattr(ts.batch, k), k
    assert ts.batch.forward is None and ts.batch.unit is None


# ---------------------------------------------------------------------------
# Host structures, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks", [2, 3, 4])
@pytest.mark.parametrize("seed,n", [(3, 150), (9, 400)])
def test_dist_structs_bitwise(ranks, seed, n):
    kw = dict(num_nodes=n, num_features=6, num_classes=3, seed=seed)
    rg, tg = r_citation(**kw), t_citation(**kw)
    part = r_metis(rg.indptr, rg.indices, ranks, seed=0)
    rs, ts = r_dg.build_dist_structs(rg, part), t_dg.build_dist_structs(
        tg, part)
    _structs_equal(rs, ts)
    for arr, fill in ((rg.x, 0), (rg.y.astype(np.int32), 0),
                      (rg.train_mask, False), (rg.x, -1.5)):
        a = r_dg.permute_node_array(rs, arr, fill)
        b = t_dg.permute_node_array(ts, arr, fill)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _small_structs(ranks=3, n=120):
    g = t_citation(num_nodes=n, num_features=6, num_classes=3, seed=1)
    part = r_metis(g.indptr, g.indices, ranks, seed=0)
    return g, t_dg.build_dist_structs(g, part)


def test_dist_accessors():
    g, S = _small_structs()
    P_, C = S.num_ranks, S.send_idx.shape[-1]
    for r in range(P_):
        b = S.device_batch(r, "cpu")
        assert b.batch_mask.shape == (S.rows,) and b.num_batches == 1
        assert torch.equal(b.halo_nodes, torch.from_numpy(
            S.batch.halo_nodes[r]))
        ex = S.exchange_arrays(r, "cpu")
        assert ex["send_idx"].shape == (P_, C) and \
            ex["send_idx"].dtype == torch.int32
        assert torch.equal(ex["send_mask"], torch.from_numpy(S.send_mask[r]))
        assert torch.equal(ex["recv_pos"], torch.from_numpy(S.recv_pos[r]))
        # each peer's real entries land on its halo slots, every padded
        # entry past the halo (where the unpack drops it)
        idx = ex["recv_idx"].view(P_, C).numpy()
        real = S.send_mask[:, r]
        assert np.array_equal(idx[real], S.recv_pos[r][real])
        assert np.all(idx[~real] == S.max_halo)
        got = np.sort(idx[real])
        assert np.array_equal(got, np.arange(S.batch.halo_mask[r].sum()))
    with pytest.raises(ValueError, match="rank"):
        S.device_batch(P_, "cpu")


@pytest.mark.parametrize("hd,dtype", [("f32", torch.float32),
                                      ("bf16", torch.bfloat16),
                                      ("int8", torch.int8)])
def test_dist_init_store(hd, dtype, monkeypatch):
    g, S = _small_structs()
    rs = r_dg.build_dist_structs(
        r_citation(num_nodes=120, num_features=6, num_classes=3, seed=1),
        np.asarray(r_metis(g.indptr, g.indices, 3, seed=0)))
    for store in (S.init_store([8, 5], hd, rank=1, device="cpu"),
                  _with_env(monkeypatch, hd, lambda: S.init_store(
                      [8, 5], rank=2, device="cpu"))):
        assert store.history_dtype == hd and store.storage == "device"
        assert [tuple(t.shape) for t in store.tables] == [(S.rows, 8),
                                                          (S.rows, 5)]
        assert all(t.dtype == dtype for t in store.tables)
        assert store.age.shape == (S.rows,)
        if hd == "int8":
            assert [tuple(s.shape) for s in store.scales] == [(S.rows,)] * 2
            assert all(torch.all(s == 1.0) for s in store.scales)
        else:
            assert store.scales is None
    # the reference's store holds every rank's rows: each rank's shard is
    # its block of them
    ref = rs.init_store([8, 5], history_dtype=hd)
    assert ref.tables[0].shape == (S.num_ranks * S.rows, 8)
    assert str(ref.tables[0].dtype) == {"f32": "float32", "bf16": "bfloat16",
                                        "int8": "int8"}[hd]


def _with_env(monkeypatch, hd, fn):
    monkeypatch.setenv("REPRO_HISTORY_DTYPE", hd)
    try:
        return fn()
    finally:
        monkeypatch.delenv("REPRO_HISTORY_DTYPE")


def test_dist_unported_paths_raise(monkeypatch):
    g, S = _small_structs()
    rs = r_dg.build_dist_structs(
        r_citation(num_nodes=120, num_features=6, num_classes=3, seed=1),
        np.asarray(r_metis(g.indptr, g.indices, 3, seed=0)))
    for init in (lambda: S.init_store([8], "vq", rank=0, device="cpu"),
                 lambda: rs.init_store([8], history_dtype="vq")):
        with pytest.raises(NotImplementedError, match="raw rows \\+ per-row"):
            init()
    monkeypatch.setenv("REPRO_HISTORY_DTYPE", "vq")
    with pytest.raises(NotImplementedError, match="vq"):
        S.init_store([8], rank=0, device="cpu")
    monkeypatch.delenv("REPRO_HISTORY_DTYPE")
    with pytest.raises(ValueError, match="history_dtype"):
        S.init_store([8], "f16", rank=0, device="cpu")
    # a vq store reaching the loss raises, as in the reference
    from repro_torch.core.history import HistoryStore
    spec = t_model.GNNSpec(op="gcn", d_in=6, d_hidden=8, num_classes=3,
                           num_layers=2)
    loss_fn = t_dg.make_dist_loss_fn(spec, S)
    vq = HistoryStore.create(S.rows, [8], "vq", device="cpu")
    with pytest.raises(NotImplementedError, match="vq"):
        loss_fn(None, vq, None, None, None, None, None)
    for call in (lambda: t_dg.run_ranks(t_rb.exchange_rank, 2, backend="nccl",
                                        device="cpu"),
                 lambda: t_dg.init_process_group(0, 1, "never-made",
                                                 backend="nccl")):
        with pytest.raises(NotImplementedError, match="Queue A item 14"):
            call()
    with pytest.raises(ValueError, match="gloo"):
        t_dg.run_ranks(t_rb.exchange_rank, 2, backend="mpi", device="cpu")


# ---------------------------------------------------------------------------
# The supersteps: one reference subprocess, one spawn of gloo ranks
# ---------------------------------------------------------------------------

def _spec(op):
    return t_model.GNNSpec(op=op, **SPEC)


def _padded(structs, g):
    return (t_dg.permute_node_array(structs, g.x),
            t_dg.permute_node_array(structs, g.y.astype(np.int32)),
            t_dg.permute_node_array(structs, g.train_mask))


def _exchange_tables(structs, d=8):
    """Seeded padded tables for the exchange runs: int8 codes and scales
    from f32 rows, the f32 rows, the f32 rows in bf16, and an f32 table
    whose row 0 on every rank holds a sentinel (the row each padded
    entry packs)."""
    n = structs.num_ranks * structs.rows
    vals = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    q, s = t_ref.quantize_rows(torch.from_numpy(vals))
    sentinel = vals.copy()
    sentinel[::structs.rows] = 1e30
    return vals, q.numpy(), s.numpy(), sentinel


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' supersteps and exchanges, computed concurrently."""
    tmp = tmp_path_factory.mktemp("dist")
    g = t_citation(**GRAPH)
    part = np.asarray(r_metis(g.indptr, g.indices, RANKS, seed=0))
    S = t_dg.build_dist_structs(g, part)
    x, y, m = _padded(S, g)
    params = {name: t_ckpt._flatten("", t_model.init_gnn(
        _spec(op), seed=0, device="cpu")) for name, op, _ in CASES}
    vals, q, s, sentinel = _exchange_tables(S)
    inp = {"part": part, "q": q, "s": s, "meta": json.dumps(
        {"graph": GRAPH, "ranks": RANKS, "steps": STEPS, "spec": SPEC,
         "cases": [list(c) for c in CASES]})}
    for name, ps in params.items():
        inp.update({f"{name}/{k}": v for k, v in ps.items()})
    np.savez(tmp / "in.npz", **inp)
    env = _torch_threads.subprocess_env(
        PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={RANKS}")
    env.pop("REPRO_HISTORY_DTYPE", None)
    proc = subprocess.Popen(
        [sys.executable, __file__, "--reference", str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        jobs = [dict(spec=dict(op=op, **SPEC), params=params[name],
                     history_dtype=hd, x=x, y=y, m=m, steps=STEPS,
                     adamw=ADAMW if name == EXAMPLE_ACC_CASE else None)
                for name, op, hd in CASES]
        jobs.append(dict(jobs[0], legacy=True))
        with t_dg.RankPool(RANKS, "cpu") as pool:
            # by rank, then by job
            port = [list(r) for r in zip(*(
                pool.run(t_rb.supersteps_rank, S, job) for job in jobs))]
            exch = pool.run(
                t_rb.exchange_rank, S, [q, vals, vals, sentinel],
                [s, None, None, None], ["int8", "f32", "bf16", "f32"])
        _, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    ref = dict(np.load(tmp / "out.npz"))
    return dict(g=g, structs=S, port=port, exch=exch, ref=ref,
                params=params, vals=vals, q=q, s=s, sentinel=sentinel)


def _cat(port, i, key, step, sub=None):
    """Rank-concatenated [P*rows, ...] array of job i's `key` at `step`."""
    parts = [r[i][key][step] for r in port]
    if sub is not None:
        parts = [p[sub] for p in parts]
    return np.concatenate(parts, axis=0)


@pytest.mark.slow
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dist_supersteps_match_reference(runs, case):
    name, op, hd = case
    i = CASES.index(case)
    port, ref = runs["port"], runs["ref"]
    for step in range(STEPS):
        pre = f"{name}/{step}/"
        for r in port:        # every rank holds the reference's value
            np.testing.assert_allclose(r[i]["loss"][step], ref[pre + "loss"],
                                       **TOL)
            np.testing.assert_allclose(r[i]["acc"][step], ref[pre + "acc"],
                                       **TOL)
        np.testing.assert_allclose(_cat(port, i, "logits", step),
                                   ref[pre + "logits"], **TOL)
        keys = sorted(k[len(pre + "grads/"):] for k in ref
                      if k.startswith(pre + "grads/"))
        for r in port:        # the summed gradient, the same on every rank
            assert sorted(r[i]["grads"][step]) == keys
            for k in keys:
                np.testing.assert_allclose(r[i]["grads"][step][k],
                                           ref[pre + "grads/" + k], **TOL,
                                           err_msg=k)
                assert np.array_equal(r[i]["grads"][step][k],
                                      port[0][i]["grads"][step][k])
        for ell in range(SPEC["num_layers"] - 1):
            got = _cat(port, i, "tables", step, ell)
            want = ref[pre + f"tables/{ell}"]
            if hd == "int8":
                scl = ref[pre + f"scales/{ell}"]
                np.testing.assert_allclose(
                    _cat(port, i, "scales", step, ell), scl, **TOL)
                deq = got.astype(np.float32) * _cat(
                    port, i, "scales", step, ell)[:, None]
                assert np.all(np.abs(deq - want.astype(np.float32)
                                     * scl[:, None])
                              <= scl[:, None] * (1 + 1e-5))
                assert np.mean(got == want) >= 0.999
            elif hd == "bf16":
                step_ = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7
                assert np.all(np.abs(got - want) <= step_ + 1e-5)
            else:
                np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.slow
def test_dist_legacy_store_matches_store(runs):
    port, j = runs["port"], len(CASES)
    for r in port:
        for key in ("loss", "acc"):
            assert r[j][key] == r[0][key]
        for step in range(STEPS):
            assert np.array_equal(r[j]["logits"][step], r[0]["logits"][step])
            for a, b in zip(r[j]["tables"][step], r[0]["tables"][step]):
                assert np.array_equal(a, b)
            assert r[j]["scales"][step] is None


@pytest.mark.slow
@pytest.mark.parametrize("case", F32_CASES, ids=[c[0] for c in F32_CASES])
def test_dist_converges_to_exact(runs, case):
    """With fixed params the supersteps' logits reach the exact full-graph
    forward after num_layers supersteps, and the error falls."""
    i = CASES.index(case)
    g, S = runs["g"], runs["structs"]
    params = t_ckpt.params_from_numpy(runs["params"][case[0]], device="cpu")
    dst, src, w = gcn_edge_weights(g)
    T = torch.from_numpy
    with torch.no_grad():
        exact = t_model.full_forward(params, _spec(case[1]), T(g.x),
                                     (T(dst), T(src)), T(w),
                                     g.num_nodes).numpy()
    valid = S.old_of_new >= 0
    errs = []
    for step in range(STEPS):
        got = np.zeros_like(exact)
        got[S.old_of_new[valid]] = _cat(runs["port"], i, "logits",
                                        step)[valid]
        errs.append(float(np.abs(got - exact).max()))
    assert errs[-1] < 1e-3, errs
    assert errs[0] > errs[-1], errs


def _halos(runs, j):
    return (np.stack([r["halos"][j] for r in runs["exch"]]),
            [r["scales"][j] for r in runs["exch"]])


def _direct(runs, table):
    """Each rank's halo rows gathered straight from the padded table, 0 at
    the masked slots."""
    S = runs["structs"]
    hn = np.clip(S.batch.halo_nodes, 0, S.num_ranks * S.rows - 1)
    return np.where(S.batch.halo_mask[..., None], table[hn], 0)


@pytest.mark.slow
def test_dist_int8_exchange_bitwise(runs):
    """Raw int8 rows and their scales on the wire: bitwise a direct gather
    of the same codes and scales (dequantized: bitwise `dequantize_rows`),
    and bitwise the reference's exchanged halo."""
    raw, scl = _halos(runs, 0)
    S, ref = runs["structs"], runs["ref"]
    assert raw.dtype == np.int8 and scl[0].dtype == np.float32
    scl = np.stack(scl)
    hm = S.batch.halo_mask
    assert np.array_equal(np.where(hm[..., None], raw, 0),
                          _direct(runs, runs["q"]))
    assert np.array_equal(np.where(hm, scl, 0),
                          np.where(hm, runs["s"][np.clip(
                              S.batch.halo_nodes, 0, len(runs["s"]) - 1)], 0))
    deq = raw.astype(np.float32) * scl[..., None] * hm[..., None]
    want = t_ref.dequantize_rows(torch.from_numpy(runs["q"]),
                                 torch.from_numpy(runs["s"])).numpy()
    assert np.array_equal(deq, _direct(runs, want))
    assert np.array_equal(raw, ref["exchange/raw"].reshape(raw.shape))
    assert np.array_equal(scl, ref["exchange/scales"].reshape(scl.shape))
    assert np.array_equal(deq, ref["exchange/deq"].reshape(deq.shape))


@pytest.mark.slow
def test_dist_float_exchanges_bitwise(runs):
    f32, _ = _halos(runs, 1)
    bf16, _ = _halos(runs, 2)
    hm = runs["structs"].batch.halo_mask[..., None]
    assert np.array_equal(np.where(hm, f32, 0), _direct(runs, runs["vals"]))
    want = torch.from_numpy(runs["vals"]).to(torch.bfloat16).float().numpy()
    assert np.array_equal(np.where(hm, bf16, 0), _direct(runs, want))
    # slots past a rank's halo stay zero
    assert np.all(np.where(hm, 0, f32) == 0)


@pytest.mark.slow
def test_dist_exchange_padded_entries_land_nowhere(runs):
    """Every padded send entry packs local row 0, here a sentinel 1e30 on
    every rank: no halo slot may hold it unless it really is a peer's
    row 0, and slot 0 keeps its real row."""
    got, _ = _halos(runs, 3)
    S = runs["structs"]
    want = _direct(runs, runs["sentinel"])
    assert np.array_equal(np.where(S.batch.halo_mask[..., None], got, 0),
                          want)
    real0 = (S.batch.halo_nodes % S.rows == 0) & S.batch.halo_mask
    assert np.all((got == 1e30).any(-1) == real0)


@pytest.mark.slow
def test_dist_params_identical_after_adamw(runs):
    i = [c[0] for c in CASES].index(EXAMPLE_ACC_CASE)
    first = runs["port"][0][i]["params"]
    start = runs["params"][EXAMPLE_ACC_CASE]
    moved = False
    for r in runs["port"][1:]:
        for k, v in r[i]["params"].items():
            assert np.array_equal(v, first[k]), k
    for k, v in first.items():
        moved |= not np.array_equal(v, start[k])
    assert moved


# ---------------------------------------------------------------------------
# The reference's side (run as a script, with 4 host devices)
# ---------------------------------------------------------------------------

def _rebuild(tree, flat, prefix=""):
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, flat, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return jnp.asarray(flat[prefix[:-1]])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def reference_runs(inp: str, out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.gnn.model import GNNSpec, init_gnn
    from repro.launch.mesh import compat_make_mesh

    z = np.load(inp)
    meta = json.loads(str(z["meta"]))
    mesh = compat_make_mesh((meta["ranks"],), ("data",))
    g = r_citation(**meta["graph"])
    S = r_dg.build_dist_structs(g, z["part"])
    x, y, m = (jnp.asarray(r_dg.permute_node_array(S, a)) for a in
               (g.x, g.y.astype(np.int32), g.train_mask))
    batch, exchange = S.device_batch(), S.exchange_arrays()
    res = {}
    for name, op, hd in meta["cases"]:
        spec = GNNSpec(op=op, **meta["spec"])
        params = _rebuild(init_gnn(jax.random.key(0), spec),
                          {k[len(name) + 1:]: z[k] for k in z.files
                           if k.startswith(name + "/")})
        store = S.init_store(spec.hist_dims(), history_dtype=hd)
        vg = jax.jit(jax.value_and_grad(r_dg.make_dist_loss_fn(spec, S, mesh),
                                        has_aux=True))
        with mesh:
            for step in range(meta["steps"]):
                (loss, (store, acc, logits)), grads = vg(
                    params, store, x, y, m, batch, exchange)
                pre = f"{name}/{step}/"
                res[pre + "loss"] = np.asarray(loss)
                res[pre + "acc"] = np.asarray(acc)
                res[pre + "logits"] = np.asarray(logits)
                for ell, t in enumerate(store.tables):
                    res[pre + f"tables/{ell}"] = _f32(t)
                for ell, s in enumerate(store.scales or ()):
                    res[pre + f"scales/{ell}"] = np.asarray(s)
                res.update({pre + "grads/" + k: v
                            for k, v in _flat(grads).items()})

    def body(t, s, hm, pl_):
        pl_ = jax.tree_util.tree_map(lambda a: a[0], pl_)
        raw, scl = r_dg.halo_exchange(t, pl_, S.max_halo, "data",
                                      scales_loc=s)
        deq = raw.astype(jnp.float32) * scl[:, None] * hm[0][:, None]
        return raw, scl, deq

    sm = r_dg._compat_shard_map(
        body, mesh=mesh, in_specs=(P("data"), P("data"), P("data"),
                                   {k: P("data") for k in exchange}),
        out_specs=(P("data"), P("data"), P("data")))
    with mesh:
        raw, scl, deq = sm(jnp.asarray(z["q"]), jnp.asarray(z["s"]),
                           jnp.asarray(S.batch.halo_mask), exchange)
    res.update({"exchange/raw": np.asarray(raw),
                "exchange/scales": np.asarray(scl),
                "exchange/deq": np.asarray(deq)})
    np.savez(out, **res)


def reference_example_accuracy(part=None):
    """(the partition's digest, the reference example's test accuracy)
    from the port's initial params, on `part` or this host's partition."""
    import jax
    import jax.numpy as jnp
    from repro.core.gas import gcn_edge_weights as r_weights
    from repro.gnn.model import GNNSpec, full_forward, init_gnn
    from repro.launch.mesh import compat_make_mesh
    from repro.train.optimizer import (adamw_init, adamw_update,
                                       clip_by_global_norm)

    ranks = 4
    mesh = compat_make_mesh((ranks,), ("data",))
    g = r_citation(**t_example.GRAPH)
    if part is None:
        part = r_metis(g.indptr, g.indices, ranks, seed=0)
    part = np.asarray(part, np.int32)
    S = r_dg.build_dist_structs(g, part)
    spec = GNNSpec(**t_example.SPEC)
    tspec = t_model.GNNSpec(**t_example.SPEC)
    params = _rebuild(init_gnn(jax.random.key(0), spec), t_ckpt._flatten(
        "", t_model.init_gnn(tspec, seed=0, device="cpu")))
    opt = adamw_init(params)
    store = S.init_store(spec.hist_dims())
    x, y, m = (jnp.asarray(r_dg.permute_node_array(S, a)) for a in
               (g.x, g.y.astype(np.int32), g.train_mask))
    batch, exchange = S.device_batch(), S.exchange_arrays()
    loss_fn = r_dg.make_dist_loss_fn(spec, S, mesh)

    @jax.jit
    def superstep(params, opt, store):
        (loss, (store, acc, _)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, store, x, y, m, batch, exchange)
        grads, _ = clip_by_global_norm(grads, t_example.CLIP)
        params, opt = adamw_update(grads, opt, params, **t_example.ADAMW)
        return params, opt, store, loss

    with mesh:
        for _ in range(80):
            params, opt, store, loss = superstep(params, opt, store)
    dst, src, w = r_weights(g)
    logits = full_forward(params, spec, jnp.asarray(g.x),
                          (jnp.asarray(dst), jnp.asarray(src)),
                          jnp.asarray(w), g.num_nodes)
    pred = np.asarray(jnp.argmax(logits, -1))
    digest = hashlib.sha256(part.tobytes()).hexdigest()[:12]
    return digest, float((pred[g.test_mask] == g.y[g.test_mask]).mean())


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        reference_runs(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "--reference-acc":
        part = (np.load(sys.argv[2])["dist"] if len(sys.argv) > 2 else None)
        print(*reference_example_accuracy(part))
    else:
        sys.exit(f"usage: {sys.argv[0]} --reference IN OUT | "
                 "--reference-acc [PARTITIONS.npz]")
