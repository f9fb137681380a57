"""Serving process split: one history-owning backend, N stateless
frontends, a versioned pull/push wire protocol.

The port of `repro.core.serve_service`, on the same wire protocol byte
for byte, so that either package's frontend can talk to either package's
backend:

  * `HistoryBackend` — the sole writer. It owns a `ServePlan` and a
    `ServeState` and is the only place refreshes run, pushes land,
    feature updates apply and ages reset. Every write bumps the state's
    `version`.
  * `ServeFrontend` — a stateless query resolver. It holds the static
    plan (graph CSR, spec, bucket pads) and the model params (and a vq
    store's codebooks), fetched once at `hello`, but no table: per chunk
    it pulls the age vector, resolves the stale closure locally, asks the
    backend to run the refresh, pulls the request batch's halo rows in raw
    storage precision, runs the forward with pushes disabled
    (`gas_batch_forward(apply_pushes=False)`) against the pulled
    mini-tables, and ships the computed rows back, encoded by the store's
    own push kernels (`HistoryCodec.encode`).

Framing (`encode_msg` / `decode_msg`): the magic `GASW1`, a little-endian
u32 header length, the header as `json.dumps` with its default separators
(`{"kind", "meta", "arrays": [{"dtype", "shape"}, ...]}`), then each
array's raw bytes. Rows travel in raw storage precision, never
dequantized: int8 codes and vq uint8 codes beside their f32 scales, bf16
as its bits under the header dtype "bfloat16" (the name the reference's
`ml_dtypes` arrays carry; the port moves the bits as int16 views and
needs no `ml_dtypes`), and a 0-d array 1-wide (`np.ascontiguousarray`,
as the reference's framing sends it: GIN's eps reaches a frontend as
[1], which broadcasts alike). Integer arrays keep the reference's wire
types: int32 halo and push ids, int64 refresh sets, bool masks, the int32
age vector. A `ServeState.version` is a Python int here and an int32 leaf
there; on the wire both are the same JSON integer.

Version handshake: every reply carries the backend's table version,
stamped inside the backend's lock, with its arrays copied to the host
there too (the port's store is written in place, so a reply must not
alias a table a later write changes). A frontend records the version its
chunk started from and requires every versioned interaction of that chunk
(the refresh's and the push's compare-and-swap, the pull) to see the same
one; any mismatch retries the chunk from the age pull, up to
`_RETRY_LIMIT` times. At SLO=0 a frontend's answers are bitwise the
in-process `serve_request`'s: the refreshes run on the backend through the
same `serve_step`, the pulled mini-tables are the tables' bits
(`HistoryStore.prefetch`, one `gather_rows_raw_many` launch), and the
pushes carry the bits an in-process push would write, landed raw by
`HistoryStore.push_raw` (one `scatter_rows_raw_many` launch). The
sentinel row N is outside that contract.

Transports: `InProcTransport` (same process; every message still goes
through the framing) and `SocketTransport` (length-prefixed frames over
TCP to `serve_backend_forever`, one thread per client; the launcher's
`--role backend` / `--role frontend`).
"""
from __future__ import annotations

import dataclasses
import json
import socket
import struct
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.gnn.model import gas_batch_forward
from repro_torch.train.checkpoint import params_from_numpy
from . import serve as S
from .history import HistoryStore, get_codec

_MAGIC = b"GASW1"
_RETRY_LIMIT = 256
_BF16 = "bfloat16"


# ---------------------------------------------------------------------------
# Framing: magic + u32 header length + JSON header + raw array bytes
# ---------------------------------------------------------------------------

def _wire(a) -> Tuple[str, np.ndarray]:
    """(the header's dtype name, a contiguous host array of the bytes) of
    one array: a numpy array (an `ml_dtypes` bfloat16 one too, whose
    dtype prints "bfloat16") or a torch tensor (bf16 as its bits)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _BF16, t.view(torch.int16).numpy()
        a = t.numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return str(a.dtype), a


def encode_msg(kind: str, meta: Dict[str, Any], arrays: List[Any]) -> bytes:
    """One self-describing frame: `kind` routes, `meta` is JSON-able
    scalars, `arrays` (numpy arrays or torch tensors) travel as raw
    contiguous bytes, dtype and shape in the header."""
    wire = [_wire(a) for a in arrays]
    header = {"kind": kind, "meta": meta,
              "arrays": [{"dtype": d, "shape": list(a.shape)}
                         for d, a in wire]}
    hb = json.dumps(header).encode()
    parts = [_MAGIC, struct.pack("<I", len(hb)), hb]
    parts += [a.tobytes() for _, a in wire]
    return b"".join(parts)


def decode_msg(buf: bytes) -> Tuple[str, Dict[str, Any], List[Any]]:
    """Inverse of `encode_msg`; validates the magic and the exact length.
    Arrays come back as read-only numpy arrays, a "bfloat16" one as a
    torch.bfloat16 tensor holding the same bits."""
    if buf[:len(_MAGIC)] != _MAGIC:
        raise ValueError("bad frame magic")
    off = len(_MAGIC)
    (hlen,) = struct.unpack_from("<I", buf, off)
    off += 4
    header = json.loads(buf[off:off + hlen].decode())
    off += hlen
    arrays: List[Any] = []
    for d in header["arrays"]:
        bf16 = d["dtype"] == _BF16
        dt = np.dtype(np.int16 if bf16 else d["dtype"])
        n = int(np.prod(d["shape"])) * dt.itemsize
        a = np.frombuffer(buf[off:off + n], dt).reshape(d["shape"])
        arrays.append(torch.from_numpy(a.copy()).view(torch.bfloat16)
                      if bf16 else a)
        off += n
    if off != len(buf):
        raise ValueError(f"frame length mismatch: {off} != {len(buf)}")
    return header["kind"], header["meta"], arrays


def _tensor(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A decoded wire array as a tensor on `device` (a copy: frames are
    read-only)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _host(t) -> Any:
    """A host copy of a reply array, taken under the backend's lock."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True)
    return np.array(t)


# params trees (nested dicts, lists and tuples of arrays) ride the same
# frames: a JSON spec tree indexes into the frame's array list

def _tree_split(tree, arrays: List[Any]):
    if isinstance(tree, dict):
        return {"d": {k: _tree_split(v, arrays)
                      for k, v in sorted(tree.items())}}
    if isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        return {tag: [_tree_split(v, arrays) for v in tree]}
    arrays.append(tree)
    return {"a": len(arrays) - 1}


def _tree_join(spec, arrays: List[Any]):
    """The tree `_tree_split` described, its leaves the arrays as they
    came off the wire."""
    if "d" in spec:
        return {k: _tree_join(v, arrays) for k, v in spec["d"].items()}
    if "l" in spec:
        return [_tree_join(v, arrays) for v in spec["l"]]
    if "t" in spec:
        return tuple(_tree_join(v, arrays) for v in spec["t"])
    return arrays[spec["a"]]


def _flat_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{"layers/0/w": leaf, ...}: a params tree flattened to the key paths
    `params_from_numpy` reads."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flat_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


# ---------------------------------------------------------------------------
# The backend service (sole writer)
# ---------------------------------------------------------------------------

class HistoryBackend:
    """History-owning serving backend: one `ServePlan` and `ServeState`
    behind the wire protocol, on the plan's device (the card unless the
    plan was built with device="cpu"). Thread-safe: every op runs under
    one lock, and a reply's version and arrays are taken inside it, so
    the version is exact for everything the reply carries. All writes go
    through here; nothing else may write the bound state while a backend
    serves it."""

    def __init__(self, plan: S.ServePlan, state: S.ServeState):
        self.plan = plan
        self.state = state
        self._lock = threading.RLock()

    @property
    def version(self) -> int:
        return int(self.state.version)

    # -- transport entry ---------------------------------------------------

    def handle(self, payload: bytes) -> bytes:
        """Decode one request frame, dispatch, encode the reply."""
        kind, meta, arrays = decode_msg(payload)
        op = getattr(self, f"_op_{kind}", None)
        if op is None:
            return encode_msg("error", {"error": f"unknown op {kind!r}"},
                              [])
        with self._lock:
            try:
                rmeta, rarrays = op(meta, arrays)
                # the version and the reply's bytes are taken INSIDE the
                # lock: a write between the op and the stamp must not tag
                # this reply with a newer generation than its data
                rarrays = [_host(a) for a in rarrays]
                version = self.version
            except Exception as e:  # ship the failure to the frontend
                return encode_msg("error", {"error": f"{type(e).__name__}: "
                                                     f"{e}"}, [])
        rmeta["version"] = version
        return encode_msg(kind, rmeta, rarrays)

    # -- ops ---------------------------------------------------------------

    def _op_hello(self, meta, arrays):
        """Static handshake: graph, spec and store identity, the model
        params and (vq) the codebooks."""
        plan, store = self.plan, self.state.histories
        params_arrays: List[Any] = []
        spec_tree = _tree_split(self.state.params, params_arrays)
        cbs = list(store.codebooks) if store.codebooks is not None else []
        rmeta = {
            "num_nodes": plan.graph.num_nodes,
            "num_layers": plan.spec.num_layers,
            "num_classes": plan.spec.num_classes,
            "op": plan.spec.op,
            "history_dtype": store.history_dtype,
            "staleness_slo": plan.config.staleness_slo,
            "params_spec": spec_tree,
            "num_codebooks": len(cbs),
        }
        return rmeta, params_arrays + cbs

    def _op_age(self, meta, arrays):
        """The staleness clock, versioned."""
        return {}, [self.state.histories.age]

    def _op_refresh(self, meta, arrays):
        """One layer-synchronous refresh batch over the closure the
        frontend resolved, through the in-process `serve_step`;
        compare-and-swap on the version the closure was computed from.
        Replies with the ages after the refresh."""
        if int(meta["expect"]) != self.version:
            return {"ok": False}, []
        nodes = np.asarray(arrays[0]).astype(np.int64)
        reset = np.asarray(arrays[1]).astype(np.int64)
        plan = self.plan
        bucket = S._bucket_for(plan.refresh_buckets, len(nodes))
        batch = S.build_request_batch(plan, nodes, bucket)
        ridx, rmask = S._reset_arrays(reset, bucket, plan.device)
        _, self.state, rdiags = S.serve_step(plan, self.state, batch, ridx,
                                             rmask)
        return ({"ok": True,
                 "hist_quant_err": float(rdiags["hist_quant_err"])},
                [self.state.histories.age])

    def _op_pull(self, meta, arrays):
        """Every layer table's rows at the requested ids (clipped) in raw
        storage precision, with the per-row scales of int8 and vq stores:
        `HistoryStore.prefetch` (one `gather_rows_raw_many` launch over
        every table), in one locked request so the rows cannot straddle a
        write."""
        store = self.state.histories
        idx = _tensor(arrays[0], store.device, torch.int32)
        out: List[Any] = []
        for rows, scl in store.prefetch(idx):
            out.append(rows)
            if scl is not None:
                out.append(scl)
        return {"scaled": store.scales is not None}, out

    def _op_push(self, meta, arrays):
        """Land a frontend's computed rows, already in storage precision,
        raw (`HistoryStore.push_raw`, never re-quantized), then the query
        step's age resets; compare-and-swap on the version the rows were
        computed from."""
        if int(meta["expect"]) != self.version:
            return {"ok": False}, []
        store = self.state.histories
        dev = store.device
        per = 2 if store.scales is not None else 1
        rest = arrays[4:]
        if len(rest) != per * store.num_layers:
            raise ValueError(
                f"push carries {len(rest)} arrays, store wants "
                f"{per * store.num_layers}")
        idx = _tensor(arrays[0], dev, torch.int32)
        mask = _tensor(arrays[1], dev, torch.bool)
        rows = [_tensor(a, dev) for a in rest[::per]]
        scales = ([_tensor(a, dev, torch.float32) for a in rest[1::per]]
                  if per == 2 else None)
        store.push_raw(idx, mask, rows, scales)
        # the query step's clock: it does not advance, only the rows the
        # caller proves fresh reset
        store.reset_age(_tensor(arrays[2], dev, torch.int32),
                        _tensor(arrays[3], dev, torch.bool))
        self.state = self.state.replace(version=self.state.version + 1)
        return {"ok": True}, []

    def _op_feature_update(self, meta, arrays):
        """A node-feature update on the owning side (the plan rewritten,
        the closure invalidated: a new write generation). Frontends that
        serve the updated nodes apply it to their own plan copy too
        (`ServeFrontend.apply_feature_update` does both)."""
        self.state = S.apply_feature_update(
            self.plan, self.state, np.asarray(arrays[0]).astype(np.int64),
            np.asarray(arrays[1], np.float32))
        return {"ok": True}, []


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

class InProcTransport:
    """Same-process transport: every request and reply still goes through
    the full framing. `hook(kind, meta)`, called before the backend sees
    each request, lets tests put writes between a frontend's protocol
    steps. The backend may be either package's (anything whose `handle`
    takes and returns a frame)."""

    def __init__(self, backend,
                 hook: Optional[Callable[[str, Dict], None]] = None):
        self.backend = backend
        self.hook = hook

    def request(self, kind: str, meta: Dict[str, Any], arrays: List[Any]
                ) -> Tuple[Dict[str, Any], List[Any]]:
        if self.hook is not None:
            self.hook(kind, meta)
        rkind, rmeta, rarrays = decode_msg(
            self.backend.handle(encode_msg(kind, meta, arrays)))
        if rkind == "error":
            raise RuntimeError(f"backend error: {rmeta['error']}")
        return rmeta, rarrays

    def close(self) -> None:
        pass


def _send_frame(sock: socket.socket, buf: bytes) -> None:
    sock.sendall(struct.pack("<Q", len(buf)) + buf)


def _recv_frame(sock: socket.socket) -> Optional[bytes]:
    hdr = b""
    while len(hdr) < 8:
        part = sock.recv(8 - len(hdr))
        if not part:
            return None
        hdr += part
    (n,) = struct.unpack("<Q", hdr)
    chunks: List[bytes] = []
    got = 0
    while got < n:
        part = sock.recv(min(1 << 20, n - got))
        if not part:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(part)
        got += len(part)
    return b"".join(chunks)


class SocketTransport:
    """Length-prefixed (u64) `encode_msg` frames over TCP to a
    `serve_backend_forever` loop. `timeout` bounds each round trip (a cold
    backend's first refresh builds the kernel library); `connect_timeout`
    only the connect."""

    def __init__(self, host: str, port: int, timeout: float = 600.0,
                 connect_timeout: float = 60.0):
        self.timeout = timeout
        self.sock = socket.create_connection((host, port),
                                             timeout=connect_timeout)
        self.sock.settimeout(timeout)

    def request(self, kind, meta, arrays):
        try:
            _send_frame(self.sock, encode_msg(kind, meta, arrays))
            buf = _recv_frame(self.sock)
        except socket.timeout as e:
            raise TimeoutError(
                f"backend did not answer {kind!r} within "
                f"{self.timeout:.0f}s (the peer did not close the "
                "connection)") from e
        if buf is None:
            raise ConnectionError(
                f"backend closed the connection during {kind!r}")
        rkind, rmeta, rarrays = decode_msg(buf)
        if rkind == "error":
            raise RuntimeError(f"backend error: {rmeta['error']}")
        return rmeta, rarrays

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def serve_backend_forever(backend: HistoryBackend, host: str = "127.0.0.1",
                          port: int = 0,
                          ready: Optional[Callable[[int], None]] = None,
                          stop_event: Optional[threading.Event] = None
                          ) -> None:
    """Accept loop of a socket-served backend: one thread per client
    connection, each request handled under the backend's lock. `ready`
    receives the bound port (0 asks for an ephemeral one) before the
    first accept; `stop_event` ends the loop (checked once per 0.25 s
    accept timeout)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(16)
    srv.settimeout(0.25)
    if ready is not None:
        ready(srv.getsockname()[1])

    def _client(conn: socket.socket) -> None:
        with conn:
            conn.settimeout(600.0)
            while True:
                try:
                    buf = _recv_frame(conn)
                except (ConnectionError, OSError):
                    return
                if buf is None:
                    return
                _send_frame(conn, backend.handle(buf))

    try:
        while stop_event is None or not stop_event.is_set():
            try:
                conn, _addr = srv.accept()
            except socket.timeout:
                continue
            threading.Thread(target=_client, args=(conn,),
                             daemon=True).start()
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# The stateless frontend
# ---------------------------------------------------------------------------

class ServeFrontend:
    """One stateless query frontend on `device` (None means "cuda"). It
    owns the static plan (built from the graph, spec and config the
    backend serves) and the params and codebooks fetched at `hello`, but
    no table: every chunk resolves its closure against a pulled age
    vector, runs the refresh on the backend, pulls the batch's halo rows
    raw, computes with pushes disabled, and ships the computed rows back
    encoded. `serve_request` returns what `serve.serve_request` returns
    but the state (which lives on the backend), plus `num_retries`: the
    chunk retries version skew caused. A params tree from either package
    is mapped into the port's layout (`params_from_numpy`)."""

    def __init__(self, graph, spec, config: S.ServeConfig, transport,
                 device=None):
        self.plan = S.build_serve_plan(graph, spec, config, device)
        self.transport = transport
        self.retries = 0
        dev = self.plan.device

        meta, arrays = transport.request("hello", {}, [])
        if meta["num_nodes"] != graph.num_nodes:
            raise ValueError(
                f"backend serves {meta['num_nodes']} nodes, frontend "
                f"graph has {graph.num_nodes}")
        if meta["num_layers"] != spec.num_layers or \
                meta["op"] != spec.op:
            raise ValueError(
                f"backend spec ({meta['op']}, {meta['num_layers']} "
                f"layers) != frontend spec ({spec.op}, "
                f"{spec.num_layers})")
        if meta["num_classes"] != spec.num_classes:
            raise ValueError(
                f"backend serves {meta['num_classes']} classes, frontend "
                f"spec has {spec.num_classes}")
        if config.history_dtype is not None and \
                meta["history_dtype"] != config.history_dtype:
            raise ValueError(
                f"config pins history_dtype={config.history_dtype!r} but "
                f"the backend store is {meta['history_dtype']!r}")
        if meta["staleness_slo"] != config.staleness_slo:
            raise ValueError(
                f"backend staleness_slo={meta['staleness_slo']} != "
                f"frontend {config.staleness_slo}: closure resolution "
                "and age-reset semantics would diverge")
        self.history_dtype = meta["history_dtype"]
        self.codec = codec = get_codec(self.history_dtype)
        n_cb = meta["num_codebooks"]
        n_params = len(arrays) - n_cb
        tree = _tree_join(meta["params_spec"], arrays[:n_params])
        self.params = params_from_numpy(
            {k: np.asarray(v) for k, v in _flat_paths(tree).items()}, dev)
        self.codebooks = ([_tensor(c, dev, torch.float32)
                           for c in arrays[n_params:]] if n_cb else None)

        # skeleton store: what gas_batch_forward reads the clock and the
        # codebooks from; its 1-row tables are never read (the reads go
        # to the pulled mini-tables) or written (apply_pushes=False). The
        # age is swapped in per chunk
        widths = [codec.table_width(d) for d in spec.hist_dims()]
        n1 = graph.num_nodes + 1
        self._skel = HistoryStore(
            tables=[torch.zeros((1, w), dtype=codec.storage, device=dev)
                    for w in widths],
            age=torch.zeros((n1,), dtype=torch.int32, device=dev),
            history_dtype=self.history_dtype,
            scales=([torch.ones((1,), dtype=torch.float32, device=dev)
                     for _ in widths] if codec.scaled else None),
            codebooks=self.codebooks,
            cb_counts=([torch.zeros(cb.shape[:2], device=dev)
                        for cb in self.codebooks] if codec.vq else None),
            cb_sums=([torch.zeros_like(cb) for cb in self.codebooks]
                     if codec.vq else None))

    # -- protocol steps ----------------------------------------------------

    def _pull_rows(self, halo_nodes: np.ndarray) -> Tuple[int, tuple]:
        meta, arrays = self.transport.request(
            "pull", {}, [np.asarray(halo_nodes, np.int32)])
        dev = self.plan.device
        per = 2 if meta["scaled"] else 1
        pulled = tuple(
            (_tensor(arrays[per * ell], dev),
             _tensor(arrays[per * ell + 1], dev, torch.float32)
             if meta["scaled"] else None)
            for ell in range(len(arrays) // per))
        return int(meta["version"]), pulled

    def _forward(self, age: np.ndarray, pulled, batch) -> tuple:
        """(logits [max_b, C] on the host, diagnostics, the encoded push
        payload): the query batch's forward against the pulled
        mini-tables, writing nothing, and its hidden layers' rows in
        storage precision (cast for f32 and bf16, `codec.encode` for int8
        and vq: the bits an in-process push would write)."""
        store = dataclasses.replace(
            self._skel, age=torch.from_numpy(np.array(age, np.int32)).to(
                self.plan.device))
        logits, _, diags, pushed = gas_batch_forward(
            self.params, self.plan.spec, self.plan.x, batch, store,
            vq_stats=False, pulled=pulled, return_pushed=True,
            apply_pushes=False)
        enc: List[Any] = []
        for ell, pay in enumerate(pushed):
            if self.codec.encode is None:
                enc.append(pay.to(self.codec.storage))
            else:
                enc.extend(self.codec.encode(pay,
                                             store.layer_codebook(ell)))
        return logits.cpu().numpy(), diags, enc

    # -- request orchestration (mirror of serve.serve_request) -------------

    def serve_request(self, query_nodes
                      ) -> Tuple[np.ndarray, Dict[str, float]]:
        """Answer one batched inference request through the split: (logits
        [len(query_nodes), C] in input order, diagnostics as
        `serve.serve_request`'s plus `num_retries`)."""
        plan = self.plan
        slo = plan.config.staleness_slo
        N = plan.graph.num_nodes
        q = np.asarray(query_nodes, np.int64).ravel()
        if q.size == 0:
            raise ValueError("empty query")
        if q.min() < 0 or q.max() >= N:
            raise ValueError(f"query ids must be in [0, {N})")
        uniq, inv = np.unique(q, return_inverse=True)
        max_q = plan.query_buckets[-1]
        chunks = np.array_split(uniq, -(-len(uniq) // max_q))

        out = np.zeros((len(uniq), plan.spec.num_classes), np.float32)
        halo_means: List[float] = []
        halo_max = 0.0
        qerrs: List[float] = []
        refreshed = steps = pos = 0
        retries0 = self.retries
        for chunk in chunks:
            logits, cd = self._serve_chunk(chunk, slo)
            out[pos:pos + len(chunk)] = logits[:len(chunk)]
            halo_means.append(cd["halo_age_mean"])
            halo_max = max(halo_max, cd["halo_age_max"])
            qerrs.extend(cd["qerrs"])
            refreshed += cd["refreshed"]
            steps += cd["steps"]
            pos += len(chunk)
        diags = {
            "halo_age_mean": float(np.mean(halo_means)),
            "halo_age_max": halo_max,
            "hist_quant_err": float(np.mean(qerrs)),
            "refreshed": float(refreshed),
            "num_steps": float(steps),
            "num_chunks": float(len(chunks)),
            "num_retries": float(self.retries - retries0),
        }
        return out[inv], diags

    def _serve_chunk(self, chunk: np.ndarray, slo
                     ) -> Tuple[np.ndarray, Dict[str, Any]]:
        plan = self.plan
        for _attempt in range(_RETRY_LIMIT):
            qerrs: List[float] = []
            steps = 0
            # (1) the clock, versioned: the chunk's generation starts here
            meta, arrays = self.transport.request("age", {}, [])
            version = int(meta["version"])
            age = arrays[0]
            # (2) the closure resolved here, refreshed on the backend
            refresh, depth1 = S.stale_closure(plan, age, chunk, slo)
            if refresh.size:
                reset_rows = depth1 if slo == 0 else refresh
                rmeta, rarr = self.transport.request(
                    "refresh", {"expect": version},
                    [refresh, np.asarray(reset_rows, np.int64)])
                if not rmeta["ok"]:
                    self.retries += 1
                    continue
                version = int(rmeta["version"])
                age = rarr[0]
                qerrs.append(float(rmeta["hist_quant_err"]))
                steps += 1
            # (3) the padded request batch, its halo rows pulled raw
            bucket = S._bucket_for(plan.query_buckets, len(chunk))
            hbatch = S._host_request_batch(plan, chunk, bucket)
            pull_version, pulled = self._pull_rows(hbatch.halo_nodes)
            if pull_version != version:
                self.retries += 1
                continue
            # (4) the forward: mini-table reads, no writes
            logits, qdiags, encoded = self._forward(
                age, pulled, hbatch.to(plan.device))
            steps += 1
            # (5) the computed rows back, compare-and-swap on the version
            reset_rows = chunk if slo is not None else np.zeros(0, np.int64)
            ridx, rmask = S.reset_rows_np(reset_rows, bucket)
            payload = [np.asarray(hbatch.batch_nodes, np.int32),
                       np.asarray(hbatch.batch_mask, bool), ridx,
                       rmask] + encoded
            pmeta, _ = self.transport.request("push", {"expect": version},
                                              payload)
            if not pmeta["ok"]:
                self.retries += 1
                continue
            qerrs.append(float(qdiags["hist_quant_err"]))
            return logits, {
                "halo_age_mean": float(qdiags["halo_age_mean"]),
                "halo_age_max": float(qdiags["halo_age_max"]),
                "qerrs": qerrs,
                "refreshed": int(refresh.size),
                "steps": steps,
            }
        raise RuntimeError(
            f"chunk retried {_RETRY_LIMIT} times without observing a "
            "stable table version: the backend is under pathological "
            "write churn")

    def apply_feature_update(self, nodes: np.ndarray,
                             values: np.ndarray) -> None:
        """Send a node-feature update to the owning backend and apply the
        same rewrite to this frontend's plan (other frontends of the same
        backend must be updated too: the protocol does not broadcast)."""
        nodes = np.asarray(nodes, np.int64).ravel()
        values = np.asarray(values, np.float32)
        self.transport.request("feature_update", {}, [nodes, values])
        S._rewrite_features(self.plan, nodes, values)

    def close(self) -> None:
        self.transport.close()
