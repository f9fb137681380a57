"""Distributed GAS: partition-parallel training over `torch.distributed`.

The port of `repro.core.dist_gas`, the paper's §7 future work ("the
fusion of GAS into a distributed training algorithm"):

 - P ranks each own one METIS-like cluster. Nodes are renumbered into a
   padded id space (new_id = rank * rows + slot), so every rank owns a
   contiguous, equally sized block of rows (`build_dist_structs`, host
   numpy, bitwise the reference's).
 - Histories are split by rows: rank r holds the [rows, d] shard of each
   table (`DistStructs.init_store`). Pushes are local: a rank writes only
   the rows of its own cluster.
 - Halo rows move by a fixed exchange (`halo_exchange`): the rows each
   peer needs are packed into one [P*C, d] buffer (`gather_rows_raw`),
   moved by one `all_to_all_single`, and unpacked at their halo slots
   (`scatter_rows_raw`). The reference runs P-1 `ppermute` rounds
   instead; the slots are disjoint, so the order does not matter. Rows
   travel in their storage type: an int8 store sends its int8 rows and,
   in a second `all_to_all_single`, their per-row f32 scales, and the
   receiver dequantizes. Gloo moves CPU tensors, so on the card the
   packed buffers are staged through pinned host buffers.
 - One superstep runs every rank on its cluster at once
   (`make_dist_loss_fn`). Layer 0 exchanges the `_pre` rows, which for
   GCNII and APPNP depend on the parameters, through an autograd
   Function whose backward runs the reverse exchange. The loss and the
   accuracy are sums all-reduced over the ranks; each rank backpropagates
   its own share, and `allreduce_grads` sums the shares once, which is
   the gradient `jax.grad` takes of the reference's loss. Halo rows of
   layers >= 1 are one superstep stale: the "one-shot" regime of Cong et
   al. (2020), error-bounded by Theorem 2.

The process group: `RankPool` (and `run_ranks`, one task on a fresh
pool) spawns P processes (start method "spawn": CUDA cannot fork) that
meet in a gloo group over a `file://` rendezvous in a fresh temporary
directory, so that concurrent runs never race for a TCP port, and binds
gloo to the loopback device. The kernels are built in the parent
first. On the card the ranks run on `cuda` (all on cuda:0 when there is
one card); `device="cpu"` runs them on the CPU, one thread each, with
the kernels' plain versions. NCCL, one card per rank, is not ported
(ROADMAP Queue A item 14). A task's body is a module-level function the
children can import: the example's `train_rank`, or the parity bodies of
`core._rank_bodies`.
"""
from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.data.graphs import Graph
from repro_torch.kernels import _build
from repro_torch.kernels.gather import gather_rows_raw
from repro_torch.kernels.ref import segment_sum
from repro_torch.kernels.scatter import scatter_rows_q, scatter_rows_raw
from repro_torch.train import optimizer as opt
from . import gas as G
from . import history as H
from .batch import GASBatch
from .config import resolve_device

__all__ = ["DistStructs", "build_dist_structs", "permute_node_array",
           "halo_exchange", "make_dist_loss_fn", "allreduce_grads",
           "superstep", "init_process_group", "RankPool", "run_ranks",
           "stats", "reset_stats", "NCCL_ITEM"]

NCCL_ITEM = "ROADMAP Queue A item 14"
GROUP_TIMEOUT_S = 600.0     # a collective's limit inside the group
RANK_TIMEOUT_S = 900.0      # the parent's wait for every rank's answer
# Host-clock seconds of this process: inside the halo exchanges (forward
# and backward) and the all-reduces, and, summed over every collective,
# their four parts: the wait for the kernels queued before the staging
# copy (on the card, where the ranks' contexts share it), the copy to
# pinned host memory, the gloo call (which also waits for the slowest
# rank to arrive) and the copy back. Also the bytes the exchanges sent to
# other ranks (a rank's own chunk of an all_to_all stays with it) and how
# many collectives were staged through pinned host buffers (a card's).
_ZERO = dict(exchange_s=0.0, allreduce_s=0.0, wait_s=0.0, d2h_s=0.0,
             gloo_s=0.0, h2d_s=0.0, wire_bytes=0, exchanges=0, staged=0)
stats: Dict[str, float] = dict(_ZERO)


def reset_stats() -> None:
    stats.update(_ZERO)


@dataclass
class DistStructs:
    """The static distributed plan, host numpy. `batch` is a `GASBatch`
    stacked over the ranks (batch r is rank r's cluster: `batch_mask` the
    valid slots, `edge_*` the local padded COO, `halo_*` the remote rows
    the rank pulls; no blocks, as the reference aggregates over the COO).
    `send_idx[q, r]` are the local rows rank q sends to rank r,
    `send_mask[q, r]` which of the C entries are real, `recv_pos[r, q]`
    the halo slots of rank r the rows from q land in; padded entries are
    0 in both, as in the reference."""
    num_ranks: int
    rows: int                      # row slots per rank
    sizes: np.ndarray              # [P] real nodes per rank
    old_of_new: np.ndarray         # [P*rows] padded new id -> old id (or -1)
    new_of_old: np.ndarray         # [N] old id -> padded new id
    max_halo: int
    max_edges: int
    batch: GASBatch                # stacked over ranks (numpy leaves)
    send_idx: np.ndarray           # [P, P, C] my local slots to send to peer q
    send_mask: np.ndarray          # [P, P, C]
    recv_pos: np.ndarray           # [P, P, C] halo slots for rows from peer q

    def _rank(self, rank: int) -> int:
        if not 0 <= rank < self.num_ranks:
            raise ValueError(f"rank {rank} outside [0, {self.num_ranks})")
        return rank

    def device_batch(self, rank: int, device=None) -> GASBatch:
        """Rank `rank`'s batch on `device` (None means "cuda")."""
        return self.batch[self._rank(rank)].to(resolve_device(device))

    def exchange_arrays(self, rank: int, device=None
                        ) -> Dict[str, torch.Tensor]:
        """Rank `rank`'s routing tables on `device`: its rows of
        `send_idx`, `send_mask` and `recv_pos` ([P, C] each), and
        `recv_idx` [P*C] int32, the halo slot of each entry the
        all_to_all brings in. An entry no peer fills (its sender's
        `send_mask` is False) gets slot max_halo, which the unpack drops:
        the padded entries' `recv_pos` is 0, a real slot, and the unpack
        writes the last row it is given, where the reference adds a zero
        row."""
        r = self._rank(rank)
        dev = resolve_device(device)
        recv_idx = np.where(self.send_mask[:, r], self.recv_pos[r],
                            self.max_halo).reshape(-1)

        def t(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        return {"send_idx": t(self.send_idx[r]),
                "send_mask": t(self.send_mask[r]),
                "recv_pos": t(self.recv_pos[r]),
                "recv_idx": t(recv_idx, np.int32)}

    def init_store(self, dims: List[int], history_dtype: Optional[str] = None,
                   *, rank: int, device=None) -> H.HistoryStore:
        """Rank `rank`'s shard of the row-split histories: [rows, d] per
        hidden layer, on the device. `history_dtype` resolves as the
        single-host store's (argument, $REPRO_HISTORY_DTYPE, "f32"); an
        int8 shard carries its [rows] scale shard, which `halo_exchange`
        sends beside the raw rows. vq stores are not supported (the
        reference's reason below). The tables stay on the device: a host
        store is a single-host feature."""
        self._rank(rank)
        resolved = H.resolve_history_dtype(history_dtype)
        if H.get_codec(resolved).vq:
            raise NotImplementedError(
                "dist_gas does not support history_dtype='vq': the halo "
                "exchange wire protocol carries raw rows + per-row "
                "scales, not codebooks — use f32/bf16/int8 for sharded "
                "runs")
        return H.HistoryStore.create(self.rows, dims, history_dtype=resolved,
                                     device=device, storage="device")


def build_dist_structs(graph: Graph, part: np.ndarray) -> DistStructs:
    """The reference's `build_dist_structs`, line for line: every integer
    output bitwise."""
    N = graph.num_nodes
    P_ = int(part.max()) + 1
    sizes = np.bincount(part, minlength=P_)
    rows = int(sizes.max())

    new_of_old = np.empty(N, np.int64)
    old_of_new = np.full(P_ * rows, -1, np.int64)
    for r in range(P_):
        mine = np.flatnonzero(part == r)
        new_of_old[mine] = r * rows + np.arange(len(mine))
        old_of_new[r * rows: r * rows + len(mine)] = mine

    dst, src, w = G.gcn_edge_weights(graph)
    dst_n, src_n = new_of_old[dst], new_of_old[src]
    owner_d = dst_n // rows

    halos: List[np.ndarray] = []
    edges = []
    for r in range(P_):
        sel = owner_d == r
        d_r, s_r, w_r = dst_n[sel], src_n[sel], w[sel]
        remote = s_r[(s_r // rows) != r]
        halos.append(np.unique(remote))
        edges.append((d_r, s_r, w_r))
    max_h = max(max((len(h) for h in halos), default=1), 1)
    max_e = max(len(e[0]) for e in edges)

    node_mask = np.arange(rows)[None, :] < sizes[:, None]
    ed = np.full((P_, max_e), rows, np.int32)              # trash row
    es = np.full((P_, max_e), rows + max_h, np.int32)      # dummy zero row
    ew = np.zeros((P_, max_e), np.float32)
    hmask = np.zeros((P_, max_h), bool)

    C = 1
    plans = []
    for r in range(P_):
        halo = halos[r]
        hmask[r, :len(halo)] = True
        lookup = np.full(P_ * rows + 1, rows + max_h, np.int64)
        lookup[r * rows: (r + 1) * rows] = np.arange(rows)
        lookup[halo] = rows + np.arange(len(halo))
        d_r, s_r, w_r = edges[r]
        ed[r, :len(d_r)] = (d_r - r * rows)
        es[r, :len(s_r)] = lookup[s_r]
        ew[r, :len(w_r)] = w_r
        plan = []
        for q in range(P_):
            sel = np.flatnonzero((halo // rows) == q)
            plan.append((sel, halo[sel] - q * rows))
            if q != r:
                C = max(C, len(sel))
        plans.append(plan)

    send_idx = np.zeros((P_, P_, C), np.int32)
    send_mask = np.zeros((P_, P_, C), bool)
    recv_pos = np.zeros((P_, P_, C), np.int32)
    for r in range(P_):
        for q in range(P_):
            if q == r:
                continue
            slots, qrows = plans[r][q]
            send_idx[q, r, :len(qrows)] = qrows
            send_mask[q, r, :len(qrows)] = True
            recv_pos[r, q, :len(slots)] = slots

    bnode = np.where(node_mask,
                     np.arange(rows, dtype=np.int64)[None, :]
                     + rows * np.arange(P_, dtype=np.int64)[:, None],
                     P_ * rows).astype(np.int32)
    hnode = np.full((P_, max_h), P_ * rows, np.int32)
    for r in range(P_):
        hnode[r, :len(halos[r])] = halos[r]
    batch = GASBatch(bnode, node_mask, hnode, hmask, ed, es, ew,
                     num_batches=P_, max_b=rows, max_h=max_h, max_e=max_e)
    return DistStructs(num_ranks=P_, rows=rows, sizes=sizes,
                       old_of_new=old_of_new, new_of_old=new_of_old,
                       max_halo=max_h, max_edges=max_e, batch=batch,
                       send_idx=send_idx, send_mask=send_mask,
                       recv_pos=recv_pos)


def permute_node_array(structs: DistStructs, arr: np.ndarray,
                       fill=0) -> np.ndarray:
    """old-id array [N, ...] -> padded new-id layout [P*rows, ...]."""
    out = np.full((structs.num_ranks * structs.rows,) + arr.shape[1:], fill,
                  arr.dtype)
    valid = structs.old_of_new >= 0
    out[valid] = arr[structs.old_of_new[valid]]
    return out


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

def _staged(t: torch.Tensor, fn: Callable[[torch.Tensor], None]
            ) -> torch.Tensor:
    """Run the collective `fn` on `t`'s bytes, in place: a CPU tensor
    directly; a card's through a pinned host buffer (gloo moves CPU
    tensors), copied back to the card after. Returns the tensor holding
    the result. Each part's host seconds go to `stats`; the copies are
    blocking, so each reads its own time."""
    if t.device.type == "cpu":
        t0 = time.perf_counter()
        fn(t)
        stats["gloo_s"] += time.perf_counter() - t0
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    t0 = time.perf_counter()
    torch.cuda.current_stream(t.device).synchronize()
    t1 = time.perf_counter()
    host.copy_(t)
    t2 = time.perf_counter()
    fn(host)
    t3 = time.perf_counter()
    out = host.to(t.device)
    t4 = time.perf_counter()
    stats["wait_s"] += t1 - t0
    stats["d2h_s"] += t2 - t1
    stats["gloo_s"] += t3 - t2
    stats["h2d_s"] += t4 - t3
    stats["staged"] += 1
    return out


def _all_to_all_rows(send: torch.Tensor, group) -> torch.Tensor:
    """send [P*C, ...] -> recv [P*C, ...]: chunk q of `send` goes to rank
    q, chunk q of the result came from rank q, as raw bytes."""
    send = send.contiguous()
    world = dist.get_world_size(group)
    stats["wire_bytes"] += (send.numel() * send.element_size()
                            * (world - 1) // world)
    return _staged(send, lambda t: dist.all_to_all_single(
        t.view(torch.uint8), t.clone().view(torch.uint8), group=group))


def _exchange(table_loc: torch.Tensor, plan: Dict[str, torch.Tensor],
              max_halo: int, group) -> torch.Tensor:
    """[rows, ...] local table -> [max_halo, ...] halo rows in the table's
    type: pack, all_to_all, unpack; slots nothing lands in stay 0."""
    rows = _all_to_all_rows(
        gather_rows_raw(table_loc.contiguous(),
                        plan["send_idx"].reshape(-1)), group)
    halo = torch.zeros((max_halo,) + tuple(table_loc.shape[1:]),
                       dtype=table_loc.dtype, device=table_loc.device)
    return scatter_rows_raw(halo, plan["recv_idx"], rows)


def halo_exchange(table_loc: torch.Tensor, plan: Dict[str, torch.Tensor],
                  max_halo: int, group=None,
                  scales_loc: Optional[torch.Tensor] = None):
    """[rows, d] local history shard -> [max_halo, d] halo rows pulled
    from their owners, in the table's raw type (f32, bf16 or int8 rows;
    `plan` is `DistStructs.exchange_arrays(rank)`). With `scales_loc`
    ([rows] f32, an int8 shard's scales) the return is the pair (rows,
    scales) and the caller dequantizes at the receiver (`rows.float() *
    scales[:, None]`, bitwise the single-host `dequantize_rows` of the
    same rows). On the card the pack is `gather_rows_raw` and the unpack
    `scatter_rows_raw`; every rank must call it in the same order."""
    t0 = time.perf_counter()
    halo = _exchange(table_loc, plan, max_halo, group)
    if scales_loc is not None:
        halo = (halo, _exchange(scales_loc, plan, max_halo, group))
    stats["exchange_s"] += time.perf_counter() - t0
    stats["exchanges"] += 1
    return halo


class _HaloExchange(torch.autograd.Function):
    """The layer-0 exchange of the `_pre` rows, differentiable: forward is
    `halo_exchange`; backward packs the halo's cotangent at the slots the
    rows came into, sends it back by the reverse all_to_all (the same
    call: chunk q goes to rank q), and adds what comes in at `send_idx`,
    its padded entries masked. An add, not a push: one local row may go
    to several peers. Every rank reaches this collective in the same
    order, as every rank runs the same layers."""

    @staticmethod
    def forward(ctx, hb, send_idx, send_mask, recv_idx, max_halo, group):
        ctx.group, ctx.rows = group, hb.shape[0]
        ctx.save_for_backward(send_idx, send_mask, recv_idx)
        plan = {"send_idx": send_idx, "recv_idx": recv_idx}
        return halo_exchange(hb.detach(), plan, max_halo, group)

    @staticmethod
    def backward(ctx, g):
        t0 = time.perf_counter()
        send_idx, send_mask, recv_idx = ctx.saved_tensors
        # a padded entry's slot max_halo clips to the last row; its
        # sender masks what comes back
        back = _all_to_all_rows(gather_rows_raw(g.contiguous(), recv_idx),
                                ctx.group)
        back = torch.where(send_mask.reshape(-1, 1), back,
                           torch.zeros_like(back))
        dhb = segment_sum(send_idx.reshape(-1).long(), back, ctx.rows)
        stats["exchange_s"] += time.perf_counter() - t0
        stats["exchanges"] += 1
        return dhb, None, None, None, None, None


class _ReplicatedLoss(torch.autograd.Function):
    """Forward: the all-reduced loss (every rank's value the reference's
    `loss`). Backward: the cotangent goes to this rank's share
    ce_sum_r / cnt, so that the shares' gradients, summed once over the
    ranks (`allreduce_grads`), are the loss's gradient."""

    @staticmethod
    def forward(ctx, share, total):
        return total.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of `t`, a fresh tensor that a CPU run
    overwrites (every rank gets the same bits)."""
    t0 = time.perf_counter()
    out = _staged(t, lambda x: dist.all_reduce(x, group=group))
    stats["allreduce_s"] += time.perf_counter() - t0
    return out


def allreduce_grads(grads: List[torch.Tensor], group=None
                    ) -> List[torch.Tensor]:
    """Sum each rank's gradient shares over the ranks, in one all-reduce
    of the flattened list: called after every rank's backward, the result
    is the gradient of the reference's `loss_fn` under `jax.grad`, the
    same bits on every rank."""
    flat = _all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view(g.shape))
        at += g.numel()
    return out


def superstep(loss_fn: Callable, params, store, x_loc, y_loc, m_loc,
              batch: GASBatch, exchange: Dict[str, torch.Tensor],
              group=None) -> Tuple[Any, ...]:
    """One superstep's forward and backward on this rank (every rank calls
    it in step): `loss_fn` from `make_dist_loss_fn`, then the gradient
    shares summed over the ranks. Returns (loss, new_store, acc,
    logits_loc, grads), `grads` a tree shaped like `params` (dict keys
    sorted); the caller clips and updates the params."""
    tree, leaves = opt.grad_leaves(params)
    loss, (store, acc, logits) = loss_fn(tree, store, x_loc, y_loc, m_loc,
                                         batch, exchange)
    grads = iter(allreduce_grads(list(torch.autograd.grad(loss, leaves)),
                                 group))
    return loss, store, acc, logits, opt.tree_map(lambda _: next(grads),
                                                  tree)


# ---------------------------------------------------------------------------
# The superstep
# ---------------------------------------------------------------------------

def make_dist_loss_fn(spec, structs: DistStructs, group=None) -> Callable:
    """Builds loss_fn(params, store, x_loc, y_loc, m_loc, batch, exchange)
    -> (loss, (new_store, acc, logits_loc)) on this rank's shard: `store`
    its `HistoryStore` shard (`structs.init_store(rank=...)`) or a legacy
    list of [rows, d] tables, `x_loc` / `y_loc` / `m_loc` its rows of the
    padded features, labels and train mask, `batch` and `exchange` its
    `structs.device_batch(rank)` and `structs.exchange_arrays(rank)`.
    The layers are the model's `_pre` / `_prop` / `_post` over the COO,
    as in the reference. `loss` and `acc` are the all-reduced values, the
    same on every rank; `loss.backward()` gives this rank's share of the
    gradient (sum the shares with `allreduce_grads`). The new store holds
    the fresh rows of every hidden layer, pushed without gradient (f32
    as they are, bf16 by a cast, int8 by `scatter_rows_q` over all rows),
    and a reset clock; the old store is not written."""
    from repro_torch.gnn.model import _post, _pre, _prop

    rows, max_h = structs.rows, structs.max_halo
    num_layers = spec.num_layers

    def loss_fn(params, store: Union[H.HistoryStore, List], x_loc, y_loc,
                m_loc, batch: GASBatch, exchange: Dict):
        legacy = not isinstance(store, H.HistoryStore)
        if not legacy and H.get_codec(store.history_dtype).vq:
            raise NotImplementedError(
                "dist_gas does not support history_dtype='vq' (no "
                "codebook exchange on the wire) — use f32/bf16/int8")
        tables = list(store) if legacy else list(store.tables)
        quantized = (not legacy) and store.scales is not None
        node_mask = batch.batch_mask
        halo_mask = batch.halo_mask[:, None]
        edges = (batch.edge_dst, batch.edge_src)

        hb = _pre(params, spec, x_loc) * node_mask[:, None]
        # exact layer-0 halo: the *input features* transformed by pre
        # (per node, exact: no staleness at layer 0, Theorem 2)
        hh0 = _HaloExchange.apply(hb, exchange["send_idx"],
                                  exchange["send_mask"],
                                  exchange["recv_idx"], max_h, group)
        hh0 = hh0 * halo_mask

        new_tables, new_scales = [], []
        x_cur = hb
        for ell in range(num_layers):
            if ell == 0:
                halo_rows = hh0
            else:
                if quantized:
                    # raw int8 rows + scales on the wire; dequantized at
                    # the receiver
                    hraw, hscl = halo_exchange(
                        tables[ell - 1], exchange, max_h, group,
                        scales_loc=store.scales[ell - 1])
                    halo_rows = hraw.to(torch.float32) * hscl[:, None]
                else:
                    halo_rows = halo_exchange(tables[ell - 1], exchange,
                                              max_h, group)
                    halo_rows = halo_rows.to(torch.float32)
                halo_rows = halo_rows * halo_mask
            dummy = torch.zeros((1, x_cur.shape[-1]), dtype=x_cur.dtype,
                                device=x_cur.device)
            x_all = torch.cat([x_cur, halo_rows, dummy], dim=0)
            x_next = _prop(params, spec, ell, x_all, edges, batch.edge_w,
                           rows, h0=hb)
            if ell < num_layers - 1:
                fresh = x_next.detach() * node_mask[:, None]
                if quantized:
                    q = torch.empty(fresh.shape, dtype=torch.int8,
                                    device=fresh.device)
                    s = torch.empty((rows,), dtype=torch.float32,
                                    device=fresh.device)
                    scatter_rows_q(q, s, torch.arange(
                        rows, dtype=torch.int32, device=fresh.device),
                        fresh.contiguous())
                    new_tables.append(q)
                    new_scales.append(s)
                else:
                    new_tables.append(fresh.to(tables[ell].dtype))
            x_cur = x_next

        logits = _post(params, spec, x_cur)
        m = m_loc & node_mask
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y_loc.long()[:, None])[:, 0]
        ce_sum = torch.sum((logz - gold) * m)
        cnt = torch.sum(m)
        correct = torch.sum((torch.argmax(logits, -1) == y_loc) & m)
        # counts are exact in f32 far past any graph here
        tot = _all_reduce_sum(torch.stack(
            [ce_sum.detach(), cnt.to(torch.float32),
             correct.to(torch.float32)]), group)
        denom = torch.clamp(tot[1], min=1.0)
        loss = _ReplicatedLoss.apply(ce_sum / denom, tot[0] / denom)
        acc = tot[2] / denom
        if legacy:
            return loss, (new_tables, acc, logits)
        # every rank pushes all of its rows each superstep, so the whole
        # clock resets: histories are exactly one superstep stale
        new_store = H.HistoryStore(
            tables=new_tables, age=torch.zeros_like(store.age),
            history_dtype=store.history_dtype,
            scales=new_scales if quantized else None,
            storage=store.storage)
        return loss, (new_store, acc, logits)

    return loss_fn


# ---------------------------------------------------------------------------
# The process group
# ---------------------------------------------------------------------------

def _check_backend(backend: str) -> None:
    if backend == "nccl":
        raise NotImplementedError(
            "dist_gas runs its ranks over gloo; NCCL (one card per rank) "
            f"is not ported ({NCCL_ITEM}): NCCL refuses two ranks on one "
            "card")
    if backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r}; the port runs "
                         "'gloo'")


def init_process_group(rank: int, world_size: int, init_file: str,
                       backend: str = "gloo"):
    """Join the gloo group of `world_size` ranks that meet at `init_file`
    (a path that does not exist yet, the same for every rank), bound to
    the loopback device unless $GLOO_SOCKET_IFNAME names another. Returns
    the group (the default one)."""
    _check_backend(backend)
    if os.path.exists("/sys/class/net/lo"):
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    return dist.group.WORLD


def _rank_device(device: torch.device, rank: int) -> torch.device:
    """cuda without an index: rank r on card r mod the card count (all on
    cuda:0 with one card); any other device as it is."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def _rank_main(rank, world_size, init_file, device, backend, tasks,
               results, t_spawn):
    """A spawned rank: its device (and CUDA context), its group, then the
    tasks (fn, args) from `tasks` until a None, each answered on
    `results`; the launch counts and `stats` start from 0 at each task."""
    try:
        t_imported = time.time() - t_spawn
        dev = _rank_device(torch.device(device), rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            dev = resolve_device(dev)
            torch.zeros(1, device=dev)          # the context, now
        else:
            torch.set_num_threads(1)
        t_context = time.time() - t_spawn
        group = init_process_group(rank, world_size, init_file, backend)
        results.put((rank, "ready", (t_imported, t_context,
                                     time.time() - t_spawn)))
        for fn, args in iter(tasks.get, None):
            _build.reset_launch_counts()
            reset_stats()
            try:
                results.put((rank, "done", fn(rank, world_size, group, dev,
                                              *args)))
            except BaseException:      # noqa: BLE001 - sent to the parent
                results.put((rank, "failed", traceback.format_exc()))
        dist.destroy_process_group()
    except BaseException:              # noqa: BLE001 - sent to the parent
        results.put((rank, "failed", traceback.format_exc()))


class RankPool:
    """`world_size` spawned processes joined in one gloo group, which run
    tasks until closed: `run(fn, *args)` calls fn(rank, world_size, group,
    device, *args) on every rank and returns the results (picklable), by
    rank. `fn` must be importable by the children (a module-level
    function of an installed module). The ranks start at construction
    (the process, the imports, a CUDA context each, the rendezvous), so
    a caller can overlap that with other work; `ready()` waits for them
    and gives each rank's seconds from its spawn to its imports, its
    context and its group. `device=None` means "cuda" and raises without
    a card; "cpu" runs the plain versions, one thread a rank.
    On the card the kernels are built here first. A rank that raises
    fails the call with its traceback, and `close()` (or leaving the
    `with` block) stops every rank."""

    def __init__(self, world_size: int, device=None, backend: str = "gloo"):
        _check_backend(backend)
        dev = resolve_device(device)
        child_dev = str(dev)
        if dev.type == "cuda":
            _build.lib()
            if torch.device(device or "cuda").index is None:
                child_dev = "cuda"          # spread over the cards
        self.world_size = world_size
        self.ready_s: Optional[List[tuple]] = None
        self._tmp = tempfile.mkdtemp(prefix="repro-dist-")
        ctx = multiprocessing.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(world_size)]
        self._procs = [ctx.Process(target=_rank_main, args=(
            r, world_size, os.path.join(self._tmp, "rendezvous"), child_dev,
            backend, self._tasks[r], self._results, time.time()))
            for r in range(world_size)]
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.close()
            raise

    def _collect(self, kind: str) -> List[Any]:
        got: Dict[int, Any] = {}
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while len(got) < self.world_size:
            try:
                rank, what, val = self._results.get(timeout=max(
                    min(deadline - time.monotonic(), 5.0), 0.1))
            except queue_mod.Empty:
                codes = [p.exitcode for p in self._procs]
                if any(c not in (None, 0) for c in codes) or \
                        time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"dist ranks: {len(got)} of {self.world_size} "
                        f"answered (exit codes {codes})")
                continue
            if what == "failed":
                raise RuntimeError(f"dist rank {rank} failed:\n{val}")
            assert what == kind, (what, kind)
            got[rank] = val
        return [got[r] for r in range(self.world_size)]

    def ready(self) -> List[tuple]:
        if self.ready_s is None:
            self.ready_s = self._collect("ready")
        return self.ready_s

    def run(self, fn: Callable, *args) -> List[Any]:
        self.ready()
        for q in self._tasks:
            q.put((fn, args))
        return self._collect("done")

    def close(self) -> None:
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            if p.pid is not None:
                p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is not None:          # a rank may sit in a collective
            for p in self._procs:
                if p.is_alive():
                    p.terminate()
        self.close()


def run_ranks(fn: Callable, world_size: int, *args, device=None,
              backend: str = "gloo") -> List[Any]:
    """fn(rank, world_size, group, device, *args) on `world_size` ranks of
    a fresh `RankPool`, the results by rank; the pool is closed after."""
    with RankPool(world_size, device, backend) as pool:
        return pool.run(fn, *args)
