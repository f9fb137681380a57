"""PyTorch port, the serving process split (`core/serve_service.py`)
against its own in-process path and against the JAX reference's.

 - Framing: `encode_msg` / `decode_msg` round-trip every wire dtype (bf16
   included, with no `ml_dtypes` on the port's side), reject corrupt
   frames, and make the reference's bytes for the same arrays; params
   trees round-trip.
 - The split is bitwise the in-process path: at SLO=0 a frontend over an
   `InProcTransport` to a `HistoryBackend` answers exactly what the
   port's `serve_request` answers from the same state, for GCN, GAT and
   PNA over f32, int8 and vq stores, and leaves the backend's tables,
   scales and clock bitwise the in-process ones (the sentinel row
   aside).
 - Across the packages: a port frontend over a reference backend, and a
   reference frontend over a port backend, answer within rtol=1e-5,
   atol=2e-5 of the reference's in-process serve, and send the
   reference frontend's `age`, `refresh` and `pull` frames byte for
   byte.
 - The protocol: version skew forces a retry, a stale push is refused,
   `hello` rejects a mismatched frontend, two frontends share one
   backend, a feature update goes through a frontend, the socket
   transport serves the same answers, a reply's version is stamped under
   the lock, quantized rows never cross the wire dequantized, and the
   launcher's two processes pass their smoke on the CPU.
"""
import dataclasses
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

from repro.core import history as r_hist
from repro.core import serve as r_serve
from repro.core import serve_service as r_ss
from repro.data.graphs import citation_graph as r_citation
from repro.gnn import model as r_model

from repro_torch.core import history as t_hist
from repro_torch.core import serve as t_serve
from repro_torch.core import serve_service as SS
from repro_torch.data.graphs import citation_graph as t_citation
from repro_torch.gnn import model as t_model
from repro_torch.train.checkpoint import params_from_numpy

N, F, D, C, L, HEADS = 100, 8, 8, 3, 3, 2
TOL = dict(rtol=1e-5, atol=2e-5)
ROOT = Path(__file__).resolve().parents[1]


def _spec(op, pkg=t_model, C=C):
    return pkg.GNNSpec(op=op, d_in=F, d_hidden=D, num_classes=C,
                       num_layers=L, heads=HEADS)


def _graph(seed=31, pkg=t_citation):
    return pkg(num_nodes=N, num_features=F, num_classes=C, seed=seed)


def _store(spec, history_dtype="f32", seed=0):
    """A port store holding pushed random rows (every layer, every node)
    and a random clock."""
    store = t_hist.HistoryStore.create(N + 1, spec.hist_dims(),
                                       history_dtype, "cpu")
    rng = np.random.default_rng(seed)
    idx = torch.arange(N, dtype=torch.int32)
    for ell, d in enumerate(spec.hist_dims()):
        store.push(ell, idx, torch.from_numpy(
            rng.standard_normal((N, d)).astype(np.float32)),
            torch.ones(N, dtype=torch.bool))
    store.age = torch.from_numpy(rng.integers(0, 4, N + 1).astype(np.int32))
    return store


def _split(op="gcn", history_dtype="f32", slo=0, hook=None, seed=31,
           transport=SS.InProcTransport):
    """An in-process (plan, state) and a backend + frontend pair over
    copies of the same state."""
    g = _graph(seed)
    spec = _spec(op)
    params = t_model.init_gnn(spec, seed=0, device="cpu")
    store = _store(spec, history_dtype)
    cfg = t_serve.ServeConfig(staleness_slo=slo, buckets=(16,))
    pr = t_serve.build_serve_plan(g, spec, cfg, device="cpu")
    sr = t_serve.init_serve_state(pr, t_serve.ServeState(params,
                                                         store.clone()))
    pb = t_serve.build_serve_plan(g, spec, cfg, device="cpu")
    be = SS.HistoryBackend(pb, t_serve.init_serve_state(
        pb, t_serve.ServeState(params, store.clone())))
    fe = SS.ServeFrontend(g, spec, cfg, transport(be, hook=hook),
                          device="cpu")
    return g, spec, cfg, pr, sr, be, fe


def _assert_states_match(state, backend):
    a, b = state.histories, backend.state.histories
    assert state.version == backend.version
    for x, y in zip(a.tables + (a.scales or []) + [a.age],
                    b.tables + (b.scales or []) + [b.age]):
        assert torch.equal(x[:N], y[:N])


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------

def _wire_arrays():
    bf = np.linspace(-2, 2, 6).astype(np.float32)
    return [
        np.arange(12, dtype=np.int32).reshape(3, 4),
        np.arange(5, dtype=np.int64),
        np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32),
        np.array([True, False, True]),
        np.arange(8, dtype=np.int8).reshape(2, 4),
        np.arange(6, dtype=np.uint8).reshape(3, 2),
        torch.from_numpy(bf).to(torch.bfloat16),
        np.zeros((0, 4), np.float32),          # empty is legal
        np.float32(0.5),                       # a 0-d leaf (GIN's eps)
    ], np.asarray(jnp.asarray(bf).astype(jnp.bfloat16))


def test_framing_roundtrips_all_wire_dtypes():
    arrays, ref_bf16 = _wire_arrays()
    buf = SS.encode_msg("pull", {"expect": 3, "slo": None}, arrays)
    kind, meta, back = SS.decode_msg(buf)
    assert kind == "pull" and meta == {"expect": 3, "slo": None}
    assert len(back) == len(arrays)
    for a, b in zip(arrays, back):
        if isinstance(a, torch.Tensor):
            assert b.dtype == torch.bfloat16 and b.shape == a.shape
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        else:
            # a 0-d array travels 1-wide, as the reference's framing
            # (np.ascontiguousarray) sends it
            a = np.atleast_1d(a)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # the reference's bf16 (an ml_dtypes array) travels as the same bits
    _, _, (b,) = SS.decode_msg(SS.encode_msg("x", {}, [ref_bf16]))
    assert torch.equal(b.view(torch.int16),
                       arrays[6].view(torch.int16))


def test_framing_rejects_corrupt_frames():
    buf = SS.encode_msg("age", {}, [np.arange(3)])
    with pytest.raises(ValueError, match="magic"):
        SS.decode_msg(b"XXXXX" + buf[5:])
    with pytest.raises(ValueError, match="length"):
        SS.decode_msg(buf + b"\x00")
    with pytest.raises(ValueError):
        SS.decode_msg(buf[:-1])


def test_encode_msg_bytes_equal_reference():
    """The same arrays and meta make the same frame in both packages, a
    port bf16 tensor the frame of the reference's bf16 array; each
    package decodes the other's frames."""
    arrays, ref_bf16 = _wire_arrays()
    ref_arrays = arrays[:6] + [ref_bf16] + arrays[7:]
    meta = {"expect": 7, "ok": True, "slo": None, "spec": {"d": {"a": 1}},
            "err": 0.25}
    ours = SS.encode_msg("push", meta, arrays)
    theirs = r_ss.encode_msg("push", meta, ref_arrays)
    assert ours == theirs
    kind, rmeta, back = r_ss.decode_msg(ours)
    assert kind == "push" and rmeta == meta
    np.testing.assert_array_equal(np.asarray(back[6], np.float32),
                                  np.asarray(ref_bf16, np.float32))
    _, _, back = SS.decode_msg(theirs)
    assert torch.equal(back[6].view(torch.int16),
                       arrays[6].view(torch.int16))


def test_params_tree_roundtrip():
    tree = {"layers": [{"w": torch.ones((2, 3)), "b": torch.zeros(3)},
                       {"eps": torch.tensor(0.5)}],
            "head": (np.full((3,), 2.0, np.float32),)}
    arrays = []
    spec = SS._tree_split(tree, arrays)
    _, _, wire = SS.decode_msg(SS.encode_msg("hello", {"s": spec}, arrays))
    back = SS._tree_join(spec, wire)
    assert isinstance(back["layers"], list)
    assert isinstance(back["head"], tuple)
    np.testing.assert_array_equal(back["layers"][0]["w"], np.ones((2, 3)))
    assert back["layers"][1]["eps"].shape == (1,)   # 0-d travels 1-wide
    assert sorted(SS._flat_paths(back)) == [
        "head/0", "layers/0/b", "layers/0/w", "layers/1/eps"]


# ---------------------------------------------------------------------------
# The split, bitwise its own in-process path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,history_dtype", [
    (op, hd) for op in ("gcn", "gat", "pna") for hd in ("f32", "int8", "vq")
] + [("gin", "f32")])
def test_frontend_bitwise_matches_inprocess(op, history_dtype):
    """At SLO=0 the frontend answers bitwise what the in-process path
    answers from the same state, with the same diagnostics, and leaves
    the backend's store bitwise the in-process one; GIN's 0-d eps, which
    reaches the frontend 1-wide (the framing's), broadcasts alike."""
    _, _, _, pr, sr, be, fe = _split(op, history_dtype)
    rng = np.random.default_rng(14)
    for _ in range(2):
        q = rng.choice(N, size=10, replace=False)
        ref, sr, rd = t_serve.serve_request(pr, sr, q)
        got, fd = fe.serve_request(q)
        np.testing.assert_array_equal(ref, got)
        assert fd["num_retries"] == 0.0
        for k in ("halo_age_mean", "halo_age_max", "refreshed",
                  "num_steps", "num_chunks"):
            assert rd[k] == fd[k], k
        np.testing.assert_allclose(fd["hist_quant_err"],
                                   rd["hist_quant_err"], rtol=1e-5,
                                   atol=1e-12)
    _assert_states_match(sr, be)


def test_slo_none_split_is_pure_cache_reads():
    _, _, _, pr, sr, be, fe = _split("gcn", slo=None)
    age0 = be.state.histories.age.clone()
    q = np.arange(12)
    ref, sr, _ = t_serve.serve_request(pr, sr, q)
    got, fd = fe.serve_request(q)
    np.testing.assert_array_equal(ref, got)
    assert fd["refreshed"] == 0.0
    assert torch.equal(be.state.histories.age, age0)
    _assert_states_match(sr, be)


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------

class _Recording:
    """A transport of either package that keeps every request frame."""

    def __init__(self, cls, backend, ss):
        self.inner, self.ss, self.frames = cls(backend), ss, []

    def request(self, kind, meta, arrays):
        self.frames.append((kind, self.ss.encode_msg(kind, meta, arrays)))
        return self.inner.request(kind, meta, arrays)

    def close(self):
        pass


def _pkg_states(op):
    """Reference and port (params, store) over the same weights, tables
    and clock."""
    rspec = _spec(op, r_model)
    rparams = r_model.init_gnn(jax.random.PRNGKey(0), rspec)
    flat = {k: np.asarray(v) for k, v in
            SS._flat_paths(jax.tree_util.tree_map(np.asarray,
                                                  rparams)).items()}
    tstore = _store(_spec(op), "f32", seed=2)
    rstore = dataclasses.replace(
        r_hist.HistoryStore.create(N + 1, rspec.hist_dims(), backend="jnp",
                                   history_dtype="f32"),
        tables=tuple(jnp.asarray(t.numpy()) for t in tstore.tables),
        age=jnp.asarray(tstore.age.numpy()))
    return (rparams, rstore), (params_from_numpy(flat, device="cpu"), tstore)


def _ref_backend(op, rstate, cfg):
    g = _graph(pkg=r_citation)
    pb = r_serve.build_serve_plan(g, _spec(op, r_model), cfg)
    return r_ss.HistoryBackend(pb, r_serve.init_serve_state(
        pb, SimpleNamespace(params=rstate[0], histories=rstate[1])))


@pytest.mark.parametrize("direction", ("port-frontend", "port-backend"))
@pytest.mark.parametrize("op", ("gcn", "gat", "pna"))
def test_cross_framework_pairings(op, direction):
    """A port frontend over a reference backend, or a reference frontend
    over a port backend, at SLO=0: the answers within the tolerance of
    the reference's in-process serve, and the `age`, `refresh` and `pull`
    frames byte for byte those of a reference frontend over a reference
    backend."""
    rstate, tstate = _pkg_states(op)
    rcfg = r_serve.ServeConfig(staleness_slo=0, buckets=(16,),
                               backend="jnp")
    tcfg = t_serve.ServeConfig(staleness_slo=0, buckets=(16,))
    rg, tg = _graph(pkg=r_citation), _graph()
    baseline = _Recording(r_ss.InProcTransport,
                          _ref_backend(op, rstate, rcfg), r_ss)
    rfe = r_ss.ServeFrontend(rg, _spec(op, r_model), rcfg, baseline)
    if direction == "port-frontend":
        tr = _Recording(SS.InProcTransport, _ref_backend(op, rstate, rcfg),
                        SS)
        fe = SS.ServeFrontend(tg, _spec(op), tcfg, tr, device="cpu")
    else:
        pb = t_serve.build_serve_plan(tg, _spec(op), tcfg, device="cpu")
        be = SS.HistoryBackend(pb, t_serve.init_serve_state(
            pb, t_serve.ServeState(*tstate)))
        tr = _Recording(r_ss.InProcTransport, be, r_ss)
        fe = r_ss.ServeFrontend(rg, _spec(op, r_model), rcfg, tr)
    pr = r_serve.build_serve_plan(rg, _spec(op, r_model), rcfg)
    sr = r_serve.init_serve_state(
        pr, SimpleNamespace(params=rstate[0], histories=rstate[1]))
    rng = np.random.default_rng(15)
    for _ in range(2):
        q = rng.choice(N, size=12, replace=False)
        want, sr, _ = r_serve.serve_request(pr, sr, q)
        got, fd = fe.serve_request(q)
        base, _ = rfe.serve_request(q)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)
        np.testing.assert_array_equal(np.asarray(base), np.asarray(want))
        assert fd["num_retries"] == 0.0
    kinds = ("age", "refresh", "pull")
    mine = [f for f in tr.frames if f[0] in kinds]
    theirs = [f for f in baseline.frames if f[0] in kinds]
    assert [k for k, _ in mine] == [k for k, _ in theirs]
    assert {k for k, _ in mine} == set(kinds)
    for (_, a), (_, b) in zip(mine, theirs):
        assert a == b


# ---------------------------------------------------------------------------
# The version handshake and the backend's guarantees
# ---------------------------------------------------------------------------

def test_version_skew_forces_retry_and_stays_exact():
    """A write landing between a frontend's age read and its pull (here a
    feature update that leaves the features as they are) moves the
    version: the chunk retries and the answer is still the exact one."""
    fired = []
    box = {}

    def hook(kind, meta):
        if kind == "pull" and not fired:
            fired.append(True)
            be = box["be"]
            be.handle(SS.encode_msg(
                "feature_update", {},
                [np.array([0], np.int64),
                 np.asarray(be.plan.graph.x[:1], np.float32)]))

    g, spec, cfg = _graph(), _spec("gcn"), t_serve.ServeConfig(
        staleness_slo=0, buckets=(16,))
    params = t_model.init_gnn(spec, seed=0, device="cpu")
    store = _store(spec)
    pr = t_serve.build_serve_plan(g, spec, cfg, device="cpu")
    sr = t_serve.init_serve_state(pr, t_serve.ServeState(params,
                                                         store.clone()))
    pb = t_serve.build_serve_plan(g, spec, cfg, device="cpu")
    box["be"] = SS.HistoryBackend(pb, t_serve.init_serve_state(
        pb, t_serve.ServeState(params, store.clone())))
    fe = SS.ServeFrontend(g, spec, cfg, SS.InProcTransport(box["be"], hook),
                          device="cpu")
    q = np.arange(10)
    ref, sr, _ = t_serve.serve_request(pr, sr, q)
    got, fd = fe.serve_request(q)
    assert fd["num_retries"] >= 1.0
    np.testing.assert_array_equal(ref, got)


def test_push_cas_rejects_superseded_generation():
    _, _, _, _, _, be, _ = _split("gcn", "int8", slo=None)
    store = be.state.histories
    payload = [np.zeros(4, np.int32), np.zeros(4, bool),
               np.zeros(4, np.int32), np.zeros(4, bool)]
    for t in store.tables:
        payload += [np.zeros((4, t.shape[1]), np.int8),
                    np.ones(4, np.float32)]
    before = [t.clone() for t in store.tables + store.scales + [store.age]]
    v0 = be.version
    _, meta, _ = SS.decode_msg(be.handle(SS.encode_msg(
        "push", {"expect": v0 + 5}, payload)))
    assert meta["ok"] is False and meta["version"] == v0
    for a, b in zip(before, store.tables + store.scales + [store.age]):
        assert torch.equal(a, b)
    # a push of the wrong arity is shipped back as an error
    _, meta, _ = SS.decode_msg(be.handle(SS.encode_msg(
        "push", {"expect": v0}, payload[:-1])))
    assert "push carries" in meta["error"]
    kind, meta, _ = SS.decode_msg(be.handle(SS.encode_msg("nope", {}, [])))
    assert kind == "error" and "unknown op" in meta["error"]


def test_hello_rejects_mismatched_frontend():
    g, spec, cfg, _, _, be, _ = _split("gcn")
    with pytest.raises(ValueError, match="staleness_slo"):
        SS.ServeFrontend(g, spec, dataclasses.replace(cfg, staleness_slo=3),
                         SS.InProcTransport(be), device="cpu")
    with pytest.raises(ValueError, match="spec"):
        SS.ServeFrontend(g, _spec("gin"), cfg, SS.InProcTransport(be),
                         device="cpu")
    with pytest.raises(ValueError, match="classes"):
        SS.ServeFrontend(g, _spec("gcn", C=5), cfg, SS.InProcTransport(be),
                         device="cpu")
    with pytest.raises(ValueError, match="nodes"):
        SS.ServeFrontend(t_citation(num_nodes=N + 5, num_features=F,
                                    num_classes=C, seed=31),
                         spec, cfg, SS.InProcTransport(be), device="cpu")
    with pytest.raises(ValueError, match="history_dtype"):
        SS.ServeFrontend(g, spec, dataclasses.replace(cfg,
                                                      history_dtype="int8"),
                         SS.InProcTransport(be), device="cpu")


def test_two_frontends_share_one_backend_exactly():
    g, spec, cfg, pr, sr, be, fa = _split("gat", "int8")
    fb = SS.ServeFrontend(g, spec, cfg, SS.InProcTransport(be),
                          device="cpu")
    rng = np.random.default_rng(16)
    for i in range(4):
        q = rng.choice(N, size=8, replace=False)
        ref, sr, _ = t_serve.serve_request(pr, sr, q)
        got, _ = (fa if i % 2 == 0 else fb).serve_request(q)
        np.testing.assert_array_equal(ref, got)
    _assert_states_match(sr, be)


def test_feature_update_through_frontend():
    g, spec, cfg, pr, sr, be, fe = _split("pna")
    q = np.arange(12)
    ref0, sr, _ = t_serve.serve_request(pr, sr, q)
    got0, _ = fe.serve_request(q)
    np.testing.assert_array_equal(ref0, got0)
    rng = np.random.default_rng(17)
    upd = np.array([1, 5, 9], np.int64)
    vals = (g.x[upd] + rng.normal(0, 2, (3, F))).astype(np.float32)
    v0 = be.version
    sr = t_serve.apply_feature_update(pr, sr, upd, vals)
    fe.apply_feature_update(upd, vals)
    assert be.version == v0 + 1
    assert torch.equal(fe.plan.x, pr.x) and torch.equal(be.plan.x, pr.x)
    ref1, sr, _ = t_serve.serve_request(pr, sr, q)
    got1, _ = fe.serve_request(q)
    np.testing.assert_array_equal(ref1, got1)
    assert np.abs(got1 - got0).max() > 0
    _assert_states_match(sr, be)


def test_socket_transport_matches_inprocess():
    g, spec, cfg, pr, sr, be, _ = _split("gcn", "int8")
    ports = queue.Queue()
    stop = threading.Event()
    t = threading.Thread(
        target=SS.serve_backend_forever, args=(be,),
        kwargs=dict(port=0, ready=ports.put, stop_event=stop), daemon=True)
    t.start()
    try:
        fe = SS.ServeFrontend(g, spec, cfg, SS.SocketTransport(
            "127.0.0.1", ports.get(timeout=10)), device="cpu")
        rng = np.random.default_rng(18)
        for _ in range(2):
            q = rng.choice(N, size=10, replace=False)
            ref, sr, _ = t_serve.serve_request(pr, sr, q)
            got, _ = fe.serve_request(q)
            np.testing.assert_array_equal(ref, got)
        _assert_states_match(sr, be)
        fe.close()
    finally:
        stop.set()
        t.join(timeout=5)
    assert not t.is_alive()


def test_reply_version_is_stamped_under_the_lock():
    """While an `age` request is answered, a write stands ready to land
    the moment the lock is free: the reply must still carry the version
    of the data it holds, and the clock bytes of that generation."""
    write_now = threading.Event()
    wrote = threading.Event()
    reader = threading.current_thread()

    class _Probe(SS.HistoryBackend):
        @property
        def version(self):
            if threading.current_thread() is reader and \
                    not write_now.is_set():
                write_now.set()
                wrote.wait(timeout=2.0)
            return super().version

    g, spec = _graph(53), _spec("gcn")
    cfg = t_serve.ServeConfig(staleness_slo=0, buckets=(16,))
    pb = t_serve.build_serve_plan(g, spec, cfg, device="cpu")
    be = _Probe(pb, t_serve.init_serve_state(pb, t_serve.ServeState(
        t_model.init_gnn(spec, device="cpu"), _store(spec))))
    v0 = SS.HistoryBackend.version.fget(be)
    age0 = be.state.histories.age.clone()

    def writer():
        write_now.wait(timeout=10)
        be.handle(SS.encode_msg("feature_update", {}, [
            np.array([0], np.int64), np.asarray(g.x[:1], np.float32)]))
        wrote.set()

    w = threading.Thread(target=writer, daemon=True)
    w.start()
    _, meta, arrays = SS.decode_msg(be.handle(SS.encode_msg("age", {}, [])))
    w.join(timeout=10)
    assert not w.is_alive() and wrote.is_set()
    assert SS.HistoryBackend.version.fget(be) == v0 + 1
    assert meta["version"] == v0
    # the reply was copied inside the lock: the update's INVALID_AGE
    # stamps (made in place after it) are not in it
    np.testing.assert_array_equal(arrays[0], age0.numpy())
    assert (be.state.histories.age.numpy()[0] == t_serve.INVALID_AGE)


def test_socket_concurrent_clients_version_stamp_is_exact():
    """Concurrent socket clients, one thread each on the backend: while a
    writer churns versions (a push resetting ages, then a feature update
    stamping INVALID_AGE), two replies that carry the same version always
    carry the same clock bytes."""
    g, spec, _, _, _, be, _ = _split("gcn", seed=51)
    ports = queue.Queue()
    stop = threading.Event()
    srv = threading.Thread(
        target=SS.serve_backend_forever, args=(be,),
        kwargs=dict(port=0, ready=ports.put, stop_event=stop), daemon=True)
    srv.start()
    seen, seen_lock, mismatches, failures = {}, threading.Lock(), [], []
    done = threading.Event()

    def reader(port):
        tr = SS.SocketTransport("127.0.0.1", port)
        try:
            while not done.is_set():
                meta, arrays = tr.request("age", {}, [])
                v, ab = int(meta["version"]), arrays[0].tobytes()
                with seen_lock:
                    prev = seen.setdefault(v, ab)
                if prev != ab:
                    mismatches.append(v)
                    done.set()
        except Exception as e:                   # noqa: BLE001
            failures.append(e)
            done.set()
        finally:
            tr.close()

    def writer(port, rounds=80):
        tr = SS.SocketTransport("127.0.0.1", port)
        try:
            widths = [t.shape[1] for t in be.state.histories.tables]
            v = int(tr.request("age", {}, [])[0]["version"])
            x0 = np.asarray(g.x[:1], np.float32)
            for _ in range(rounds):
                payload = [np.zeros(4, np.int32), np.zeros(4, bool),
                           np.arange(8, dtype=np.int32), np.ones(8, bool)]
                payload += [np.zeros((4, w), np.float32) for w in widths]
                meta, _ = tr.request("push", {"expect": v}, payload)
                assert meta["ok"], "the single writer's CAS cannot fail"
                meta, _ = tr.request("feature_update", {},
                                     [np.array([0], np.int64), x0])
                v = int(meta["version"])
        except Exception as e:                   # noqa: BLE001
            failures.append(e)
        finally:
            done.set()
            tr.close()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        port = ports.get(timeout=10)
        threads = [threading.Thread(target=reader, args=(port,),
                                    daemon=True) for _ in range(2)]
        threads.append(threading.Thread(target=writer, args=(port,),
                                        daemon=True))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        stop.set()
        srv.join(timeout=5)
    assert not failures, failures
    assert not mismatches, mismatches
    assert len(seen) > 60          # the writer really churned versions


@pytest.mark.parametrize("history_dtype,code_dtype",
                         [("int8", np.int8), ("vq", np.uint8),
                          ("bf16", "bfloat16")])
def test_quantized_rows_never_dequantized_on_wire(history_dtype,
                                                  code_dtype):
    """Pull replies and push payloads carry storage-precision rows (codes
    beside f32 scales, bf16 bits under "bfloat16"): no f32 row tensor of
    a compressed store crosses the transport."""
    log = []

    class _Log(SS.InProcTransport):
        def request(self, kind, meta, arrays):
            rmeta, rarrays = super().request(kind, meta, arrays)
            log.append((kind, SS.encode_msg(kind, meta, arrays),
                        SS.encode_msg(kind, rmeta, rarrays)))
            return rmeta, rarrays

    _, _, _, _, _, _, fe = _split("gcn", history_dtype, transport=_Log)
    fe.serve_request(np.arange(10))

    def dtypes(frame):
        (n,) = np.frombuffer(frame[5:9], "<u4")
        return [a["dtype"] for a in json.loads(frame[9:9 + n])["arrays"]]

    scaled = history_dtype != "bf16"
    pulls = [dtypes(r) for k, _, r in log if k == "pull"]
    pushes = [dtypes(q)[4:] for k, q, _ in log if k == "push"]
    assert pulls and pushes
    want = str(np.dtype(code_dtype)) if scaled else code_dtype
    for rows in pulls + pushes:
        step = 2 if scaled else 1
        assert all(d == want for d in rows[0::step]), rows
        if scaled:
            assert all(d == "float32" for d in rows[1::2]), rows


def test_two_process_launcher_smoke_cpu(tmp_path):
    """`serve_gas --role backend` in one process (it trains, then serves
    on an ephemeral port), `--role frontend --smoke` in another: the
    frontend's smoke holds the SLO contract through the wire, SLO=0 at the
    launcher's SMOKE_TOL of the full forward."""
    env = _torch_threads.subprocess_env(PYTHONPATH=str(ROOT / "src"))
    port_file = tmp_path / "port"
    common = [sys.executable, "-m", "repro_torch.launch.serve_gas",
              "--smoke", "--slo", "0", "--device", "cpu", "--op", "gat",
              "--history-dtype", "int8"]
    be = subprocess.Popen(
        common + ["--role", "backend", "--port", "0", "--port-file",
                  str(port_file)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if port_file.exists() and port_file.read_text().strip():
                break
            if be.poll() is not None:
                pytest.fail(f"backend died:\n{be.stdout.read()}")
            time.sleep(0.2)
        else:
            pytest.fail("backend never published its port")
        out = subprocess.run(
            common + ["--role", "frontend", "--port",
                      port_file.read_text().strip()],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "smoke OK" in out.stdout and "retries 0" in out.stdout
    finally:
        be.send_signal(signal.SIGTERM)
        try:
            be.wait(timeout=10)
        except subprocess.TimeoutExpired:
            be.kill()
            be.wait()
