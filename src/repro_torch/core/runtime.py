"""GAS training runtime: `GASConfig` -> `GASPlan` -> `GASState`.

The port of `repro.core.runtime`, the paper's Algorithm 1 as a training
loop:

    plan  = build_plan(graph, spec, config)            # static, built once
    state = init_state(plan)                           # params, opt, store
    state, metrics = train_step(plan, state, batch)    # one cluster batch
    state, metrics = train_epoch(plan, state, epoch)   # shuffled epoch
    logits         = predict(plan, state)              # history inference
    accs           = evaluate_exact(plan, state)       # full propagation

The reference jits the step and donates the whole state. The port runs
a step eagerly: it records the batch forward under autograd, takes the
gradients with `torch.autograd.grad`, clips them and applies AdamW in
place on the params, moments and step count; the history pushes, the
clock and the vq statistics are in place too. So a step returns the
state it was given, updated. `make_step_fn` and `make_prefetch_step_fn`
give the step and the pipelined step as plain functions, as the
reference's do. With `fused_epoch` (the reference's one `lax.scan`
dispatch an epoch) the epoch's steps run as one unit over the stacked
batches, selected by a device index (`fused_body`): on the card one
CUDA graph, captured once and replayed once an epoch, bitwise the
per-step loop. `predict` runs on a clone of the store, since the
reference's `predict` leaves the state's tables untouched.

Entry points run on the card (`device=None` means "cuda") unless the
caller asks for the CPU, where every kernel runs its plain version.
The store's precision is `GASConfig.history_dtype` (f32, bf16, int8 or
vq; None reads $REPRO_HISTORY_DTYPE, else f32, as in the reference; the
epoch metrics carry `hist_quant_err`, the error its pushes
incur). A vq store's codebooks are refit at the start of an epoch on the
reference's cadence (`vq_refit_every`) or drift (`vq_refit_drift`) gate.
The step's loss is `ce + spec.reg_weight * reg`, the Eq. 3 regularizer's
noise drawn from the state's generator; `halo_age_decay` damps stale
halo rows in training and in `predict`.

The async history pipeline (`repro.core.runtime:321-475`):
`history_storage="host"` (None reads $REPRO_HISTORY_STORAGE, else
"device") keeps the tables in pinned host memory and reads them only
through prefetched device mini-tables (`core.history`), and
`prefetch_depth = k > 0` pipelines the epoch: a prologue prefetches the
first k batches' halos, and each step then prefetches batch i + k's
(`prefetch_step`, whose docstring states the stream schedule). Every
placement and depth is bitwise the device store's synchronous epoch.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.graphs import Graph
from repro_torch.train.optimizer import (AdamWState, adamw_init,
                                         adamw_update, clip_by_global_norm,
                                         grad_leaves, tree_leaves)
from . import gas as G
from .batch import GASBatch
from .config import HistoryExecConfig, resolve_device
from .history import (HistoryStore, resolve_history_dtype,
                      resolve_history_storage)
from .partition import metis_like_partition, random_partition


@dataclass(frozen=True, kw_only=True)
class GASConfig(HistoryExecConfig):
    """Every knob of a GAS training run, with the reference's names and
    defaults (the paper's citation-graph hyperparameters). The shared
    `history_dtype` / `staleness_slo` come from `HistoryExecConfig`. For
    "vq", `vq_refit_every = k > 0` refits the codebooks from the pushes'
    statistics at the start of every k-th epoch, and `vq_refit_drift > 0`
    also whenever the previous epoch's mean `hist_quant_err` exceeded it
    (0 turns either off). `history_storage` ("device", "host", or None
    for $REPRO_HISTORY_STORAGE, else "device") places the tables;
    `prefetch_depth` pipelines the epoch's halo reads (0 is synchronous;
    deeper than the batches allow is clamped, `_resolved_depth`).
    `fused_epoch` runs each epoch as one unit (`train_epoch`; on the card
    one CUDA graph replay an epoch), bitwise the per-step loop. The
    reference's `backend` has no counterpart (the tensors' device picks
    the kernel or its plain version)."""
    num_parts: int
    partitioner: str = "metis"          # "metis" | "random"
    clusters_per_batch: int = 1
    use_history: bool = True
    fused_epoch: bool = False
    fuse_halo: bool = True
    vq_refit_every: int = 0             # epochs between vq codebook refits
    vq_refit_drift: float = 0.0         # hist_quant_err that forces one
    halo_age_decay: float = 0.0
    prefetch_depth: int = 0
    history_storage: Optional[str] = None  # "device" | "host"
    lr: float = 0.01
    weight_decay: float = 5e-4
    grad_clip: float = 2.0
    epochs: int = 100
    seed: int = 0

    def __post_init__(self):
        super().__post_init__()
        if self.partitioner not in ("metis", "random"):
            raise ValueError(f"partitioner must be metis or random, got "
                             f"{self.partitioner!r}")
        if self.history_storage not in (None, "device", "host"):
            raise ValueError(f"history_storage must be device or host, got "
                             f"{self.history_storage!r}")


@dataclass
class GASState:
    """Everything that changes during training: the params tree, the AdamW
    state, the history store, `rng`, the uint32 key data the reference
    keeps beside them, and `gen`, the generator the Eq. 3 regularizer
    draws its noise from. `rng` stays the initial key data `[0, seed +
    1]` of the reference's `jax.random.key(seed + 1)`, carried so that a
    checkpoint has every key the reference reads; `gen` is a
    `torch.Generator` on the plan's device seeded with its second word
    (`noise_generator`). Its bits are not `jax.random.normal`'s, and a
    checkpoint does not hold its position: a restored state draws from
    the seed again. None (a state built by hand) makes the step seed one
    when the regularizer first needs it."""
    params: Any
    opt_state: AdamWState
    histories: HistoryStore
    rng: np.ndarray
    gen: Optional[torch.Generator] = None

    def replace(self, **kw) -> "GASState":
        return replace(self, **kw)


@dataclass
class GASPlan:
    """Static execution plan, built once by `build_plan`. Mutable only in
    that `clusters_per_batch > 1` epochs regroup the clusters (`_regroup`),
    which swaps `batches` / `batch_stack` keeping the padded shapes (a
    fused plan copies the new batches into its stack while they hold)."""
    graph: Graph
    spec: Any                            # gnn.model.GNNSpec
    config: GASConfig
    device: torch.device
    part: np.ndarray
    batches: Optional[GASBatch]          # host (numpy) stack
    batch_stack: Optional[GASBatch]      # device stack
    x: torch.Tensor
    y: torch.Tensor                      # [N+1] padded labels
    train_mask: torch.Tensor             # [N+1]
    eval_edges: Tuple[torch.Tensor, torch.Tensor]
    eval_w: torch.Tensor
    unit_blocks: bool
    history_storage: str = "device"
    _pad_to: Optional[Tuple[int, int, int]] = None
    _pad_k: int = 1
    _pad_k_t: int = 1
    _np_rng: Any = None
    # the last epoch's mean hist_quant_err, which vq_refit_drift reads
    _last_qerr: Optional[float] = None
    # the pipelined epoch's prefetch stream on the card (`_prefetch_entry`)
    _side: Any = None
    # the fused epoch's buffers and graph (`FusedEpoch`), and whether the
    # plan ran its first fused epoch on the card (eagerly)
    _fused: Any = None
    _fused_warm: bool = False

    def batch(self, b) -> GASBatch:
        """One device batch off the stack (views, no copy)."""
        return self.batch_stack[b]


def _accuracy(logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    pred = torch.argmax(logits, dim=-1)
    ok = (pred == labels) & mask
    return ok.sum() / torch.clamp(mask.sum(), min=1)


def partition(graph: Graph, config: GASConfig) -> np.ndarray:
    """The graph's partition under `config` (its partitioner, part count
    and seed): the part of every node."""
    if config.partitioner == "metis":
        return metis_like_partition(graph.indptr, graph.indices,
                                    config.num_parts, seed=config.seed)
    return random_partition(graph.num_nodes, config.num_parts,
                            seed=config.seed)


def build_plan(graph: Graph, spec, config: GASConfig,
               device=None, part: Optional[np.ndarray] = None) -> GASPlan:
    """Partition the graph (or take `part`, `partition(graph, config)`
    computed beforehand), build the stacked batches (with the op's block
    families and their transposes) and upload them, the features, labels
    and the exact-evaluation COO to `device` (None means "cuda"). The
    reference builds blocks only for its kernel backends; the port's
    every op runs on blocks, so it always builds them."""
    from repro_torch.gnn.model import UNIT_BLOCK_OPS, _check_op

    _check_op(spec)
    resolve_history_dtype(config.history_dtype)  # a bad name fails here
    dev = resolve_device(device)
    N = graph.num_nodes
    if part is None:
        part = partition(graph, config)
    elif part.shape != (N,):
        raise ValueError(f"part must have shape ({N},), got {part.shape}")
    dst, src, w = G.gcn_edge_weights(graph)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    plan = GASPlan(
        graph=graph, spec=spec, config=config, device=dev, part=part,
        batches=None, batch_stack=None, x=t(graph.x),
        y=t(np.concatenate([graph.y, np.zeros(1, np.int32)])),
        train_mask=t(np.concatenate([graph.train_mask, [False]])),
        eval_edges=(t(dst), t(src)), eval_w=t(w),
        unit_blocks=spec.op in UNIT_BLOCK_OPS,
        history_storage=resolve_history_storage(config.history_storage),
        _np_rng=np.random.default_rng(config.seed + 17))
    if config.clusters_per_batch > 1:
        # k random clusters per batch, regrouped each epoch: pad to the
        # worst case so every epoch has one shape; K grows lazily
        plan._pad_to = G.padding_bounds(graph, part,
                                        config.clusters_per_batch)
        _regroup(plan)
    else:
        plan.batches = G.build_batches(graph, part, build_blocks=True,
                                       unit_weights=plan.unit_blocks)
        plan.batch_stack = plan.batches.to(dev)
    return plan


def _regroup(plan: GASPlan) -> None:
    cfg = plan.config
    grouped = G.group_partition(plan.part, cfg.clusters_per_batch,
                                plan._np_rng)
    plan.batches = G.build_batches(plan.graph, grouped, pad_to=plan._pad_to,
                                   build_blocks=True, pad_k=plan._pad_k,
                                   pad_k_t=plan._pad_k_t,
                                   unit_weights=plan.unit_blocks)
    fwd = plan.batches.unit if plan.unit_blocks else plan.batches.forward
    tr = plan.batches.unit_transposed if plan.unit_blocks \
        else plan.batches.transposed
    plan._pad_k = max(plan._pad_k, fwd.cols.shape[2])
    plan._pad_k_t = max(plan._pad_k_t, tr.cols.shape[2])
    old = plan.batch_stack
    if plan.config.fused_epoch and old is not None and [
            a.shape for a in old.arrays()] == [
            a.shape for a in plan.batches.arrays()]:
        # while the padded shapes hold, the new batches go into the stack
        # the fused epoch's graph reads (no second stack on the card)
        for dst, src in zip(old.arrays(), plan.batches.arrays()):
            dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))
    else:
        plan.batch_stack = plan.batches.to(plan.device)


def _array_shapes(batch: GASBatch) -> list:
    return [(tuple(a.shape), a.dtype) for a in batch.arrays()]


def noise_generator(rng: np.ndarray, device) -> torch.Generator:
    """The regularizer's generator on `device`, seeded with the second
    word of the reference's key data `rng` (seed + 1)."""
    return torch.Generator(device=device).manual_seed(int(rng[-1]))


def init_state(plan: GASPlan, params=None) -> GASState:
    """Fresh params (the port's `init_gnn(spec, seed)` unless `params` is
    given, e.g. the reference's carried across), a zero AdamW state, a
    zero history store of `config.history_dtype` (None: the precision
    $REPRO_HISTORY_DTYPE names, else f32) placed as the plan's
    `history_storage`, the initial rng key data and the regularizer's
    generator seeded from it."""
    from repro_torch.gnn.model import init_gnn

    cfg = plan.config
    if params is None:
        params = init_gnn(plan.spec, seed=cfg.seed, device=plan.device)
    store = HistoryStore.create(plan.graph.num_nodes + 1,
                                plan.spec.hist_dims(),
                                history_dtype=cfg.history_dtype,
                                device=plan.device,
                                storage=plan.history_storage)
    rng = np.array([0, cfg.seed + 1], np.uint32)
    return GASState(params=params, opt_state=adamw_init(params),
                    histories=store, rng=rng,
                    gen=noise_generator(rng, plan.device))


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """The reference's loss: mean cross-entropy over the masked rows."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1)


def _loss(logits: torch.Tensor, batch: GASBatch, y: torch.Tensor,
          train_mask: torch.Tensor):
    """The loss and accuracy over the batch's training nodes (`y` and
    `train_mask` the padded [N+1] labels and mask)."""
    idx = batch.batch_nodes.long().clamp(0, y.shape[0] - 1)
    labels = y[idx].long()
    m = train_mask[idx] & batch.batch_mask
    return masked_cross_entropy(logits, labels, m), _accuracy(logits, labels,
                                                              m)


def grads_and_metrics(plan: GASPlan, state: GASState, batch: GASBatch,
                      pulled: Optional[tuple] = None,
                      after_forward: Optional[Callable] = None, *,
                      x: Optional[torch.Tensor] = None,
                      y: Optional[torch.Tensor] = None,
                      train_mask: Optional[torch.Tensor] = None):
    """The step's forward and backward without the update: the gradients
    (a list in `tree_leaves(params)` order, unclipped) and the metrics
    (STEP_METRICS, in that order). The loss is `ce + spec.reg_weight *
    reg`, the reference's. The history pushes of the forward land in
    `state.histories`. The extended step of the pipeline (the
    reference's `_make_step_fn_ex`): `pulled` feeds the forward's history
    reads from prefetched mini-tables, and `after_forward(pushed)`, given
    the hidden layers' pushed rows, runs once the pushes are queued and
    before the backward. `x`, `y` and `train_mask` default to the
    plan's."""
    from repro_torch.gnn.model import gas_batch_forward

    cfg, spec = plan.config, plan.spec
    x = plan.x if x is None else x
    y = plan.y if y is None else y
    train_mask = plan.train_mask if train_mask is None else train_mask
    if state.gen is None:
        state.gen = noise_generator(state.rng, plan.device)
    params, leaves = grad_leaves(state.params)
    logits, _, diags, pushed = gas_batch_forward(
        params, spec, x, batch, state.histories,
        use_history=cfg.use_history, fuse_halo=cfg.fuse_halo,
        gen=state.gen, halo_age_decay=cfg.halo_age_decay, pulled=pulled,
        return_pushed=True)
    if after_forward is not None:
        after_forward(pushed)
    reg = diags.pop("reg")
    ce, acc = _loss(logits, batch, y, train_mask)
    loss = ce + spec.reg_weight * reg
    grads = list(torch.autograd.grad(loss, leaves))
    metrics = {"loss": loss.detach(), "ce": ce.detach(), "acc": acc,
               "reg": reg.detach(), **diags}
    return grads, metrics


def apply_update(plan: GASPlan, state: GASState,
                 grads: List[torch.Tensor]) -> GASState:
    """The step's update: global-norm clipping, then AdamW with b2 = 0.999
    (as the reference's step passes), in place on the params, the moments
    and the step count. Returns `state`."""
    cfg = plan.config
    grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    _, state.opt_state = adamw_update(
        grads, state.opt_state, state.params, lr=cfg.lr, b1=0.9, b2=0.999,
        weight_decay=cfg.weight_decay)
    return state


def make_step_fn(plan: GASPlan) -> Callable:
    """The step as a plain function, `step(state, batch, x, y, train_mask)
    -> (state, metrics)` (the reference's `make_step_fn`): the forward
    with its history pushes, the backward (`grads_and_metrics`) and
    `apply_update`, all in place on `state`, which is returned; `x`, `y`
    and `train_mask` are the features and the padded labels and mask.
    The metrics stay tensors on the device (no host sync)."""
    def step(state: GASState, batch: GASBatch, x, y, train_mask):
        grads, metrics = grads_and_metrics(plan, state, batch, x=x, y=y,
                                           train_mask=train_mask)
        return apply_update(plan, state, grads), metrics

    return step


def train_step(plan: GASPlan, state: GASState, batch: GASBatch
               ) -> Tuple[GASState, Dict[str, torch.Tensor]]:
    """One optimization step on one cluster batch: `make_step_fn(plan)`
    on the plan's features, labels and mask."""
    return make_step_fn(plan)(state, batch, plan.x, plan.y, plan.train_mask)


@dataclass
class PrefetchEntry:
    """One halo prefetch in flight: the mini-tables (`HistoryStore.
    prefetch`), the target batch's halo ids and mask (the patches read
    them) and, on the card, the event that ends its reads on the side
    stream."""
    pulled: tuple
    halo_nodes: torch.Tensor
    halo_mask: torch.Tensor
    done: Any = None


def _prefetch_entry(plan: GASPlan, store: HistoryStore, batch: GASBatch,
                    slot: Optional[tuple] = None) -> PrefetchEntry:
    """Start the prefetch of `batch`'s halo rows, into new mini-tables or
    into `slot` (`HistoryStore.prefetch_buffers`, the fused epoch's ring).
    On the card its gathers run on the plan's side stream, behind an
    event recorded on the main stream now, so they read the tables as
    every push queued so far left them; new mini-tables are allocated on
    the side stream and marked used by the main one (`record_stream`),
    which patches and reads them (a slot and the fused epoch's batches
    outlive the epoch, and need no mark). On the CPU the gathers run in
    place."""
    if plan.device.type != "cuda":
        return PrefetchEntry(store.prefetch(batch.halo_nodes, out=slot),
                             batch.halo_nodes, batch.halo_mask)
    main = torch.cuda.current_stream(plan.device)
    if plan._side is None:
        plan._side = torch.cuda.Stream(device=plan.device)
    side = plan._side
    side.wait_stream(main)
    with torch.cuda.stream(side):
        if slot is None:
            batch.halo_nodes.record_stream(side)
        pulled = store.prefetch(batch.halo_nodes, out=slot)
        done = torch.cuda.Event()
        done.record(side)
    if slot is None:
        for rows, scl in pulled:
            for t in (rows,) if scl is None else (rows, scl):
                t.record_stream(main)
    return PrefetchEntry(pulled, batch.halo_nodes, batch.halo_mask, done)


def make_prefetch_step_fn(plan: GASPlan, depth: int) -> Callable:
    """One step of the pipelined epoch as a plain function (the
    reference's `make_prefetch_step_fn`): `pf_step(state, batch,
    future_batch, queue, x, y, train_mask) -> (state, metrics, queue)`.
    `depth` is the number of prefetches in flight at the head of the
    epoch (`_resolved_depth`), as the reference's signature has it (the
    step reads the queue it is given); `queue` holds the prefetches in
    flight,
    its head this batch's, and a keyword `slot` (the fused epoch's) takes
    `future_batch`'s rows. The schedule, which keeps every read of a
    table off the rows the main stream is writing:

      1. the main stream waits for every prefetch in `queue`, so their
         reads end before this step's first push;
      2. the forward reads the halo from the head's mini-tables and
         pushes into the store;
      3. after the pushes, the other entries (read before them) are
         patched with this step's pushed rows (`patch_pulled`, on the main
         stream), then `future_batch`'s prefetch starts on the side stream
         behind an event at the last push, so it reads the tables the
         synchronous schedule's pull would and overlaps this step's
         backward and update;
      4. the backward and the update.

    A masked halo slot reads the sentinel row, which every push writes
    and no patch restores; the schedule never lets a prefetch read it
    while a push writes it. Returns (state, metrics, queue[1:] + the new
    entry, if `future_batch` is not None)."""
    def pf_step(state: GASState, batch: GASBatch,
                future_batch: Optional[GASBatch], queue: tuple, x, y,
                train_mask, *, slot: Optional[tuple] = None):
        if plan.device.type == "cuda":
            main = torch.cuda.current_stream(plan.device)
            for e in queue:
                main.wait_event(e.done)
        head, rest = queue[0], list(queue[1:])

        def after_forward(pushed):
            for e in rest:
                state.histories.patch_pulled(
                    e.pulled, e.halo_nodes, e.halo_mask, batch.batch_nodes,
                    batch.batch_mask, pushed)
            if future_batch is not None:
                rest.append(_prefetch_entry(plan, state.histories,
                                            future_batch, slot))

        grads, metrics = grads_and_metrics(
            plan, state, batch, pulled=head.pulled,
            after_forward=after_forward, x=x, y=y, train_mask=train_mask)
        return apply_update(plan, state, grads), metrics, tuple(rest)

    return pf_step


def prefetch_step(plan: GASPlan, state: GASState, batch: GASBatch,
                  future_batch: Optional[GASBatch], queue: tuple
                  ) -> Tuple[GASState, Dict[str, torch.Tensor], tuple]:
    """One step of the pipelined epoch: `make_prefetch_step_fn`'s step on
    the plan's features, labels and mask."""
    return make_prefetch_step_fn(plan, len(queue))(
        state, batch, future_batch, queue, plan.x, plan.y, plan.train_mask)


def _resolved_depth(plan: GASPlan) -> int:
    """`prefetch_depth` clamped to [0, num_batches): each prefetch in
    flight is a distinct later batch's (the reference's clamp)."""
    nb = plan.batches.num_batches
    return max(0, min(plan.config.prefetch_depth, nb - 1))


def train_epoch(plan: GASPlan, state: GASState, epoch: int
                ) -> Tuple[GASState, Dict[str, float]]:
    """One epoch over every cluster batch in the reference's shuffled
    order (`default_rng(seed * 1000 + epoch).permutation`). With
    `clusters_per_batch > 1` the clusters are regrouped first (from epoch
    1 on). A vq store's codebooks are refit first when the cadence
    (`vq_refit_every`) or the drift gate (`vq_refit_drift`, against the
    previous epoch's mean `hist_quant_err`) says so, as the reference's
    epoch does. With `prefetch_depth` k > 0 (clamped, `_resolved_depth`)
    the first k batches' halos are prefetched first and each step then
    runs `prefetch_step`, which prefetches batch i + k's; bitwise the
    synchronous epoch. With `fused_epoch` the steps run as one unit
    (`_fused_epoch`: on the card one CUDA graph replay an epoch), bitwise
    the per-step loop. Returns the per-step metrics' means."""
    cfg = plan.config
    cadence_due = (cfg.vq_refit_every > 0 and epoch > 0
                   and epoch % cfg.vq_refit_every == 0)
    drift_due = (cfg.vq_refit_drift > 0 and plan._last_qerr is not None
                 and plan._last_qerr > cfg.vq_refit_drift)
    if (cadence_due or drift_due) and \
            state.histories.history_dtype == "vq":
        state.histories.refit_codebooks()
    if cfg.clusters_per_batch > 1 and epoch > 0:
        _regroup(plan)
    order = np.random.default_rng(cfg.seed * 1000 + epoch).permutation(
        plan.batches.num_batches)
    depth, nb = _resolved_depth(plan), len(order)
    if cfg.fused_epoch:
        out = _fused_epoch(plan, state, order, depth)
        plan._last_qerr = out["hist_quant_err"]
        return state, out
    agg = []
    queue = tuple(_prefetch_entry(plan, state.histories,
                                  plan.batch(int(order[j])))
                  for j in range(depth))
    for i, b in enumerate(order):
        if depth == 0:
            state, metrics = train_step(plan, state, plan.batch(int(b)))
        else:
            future = (plan.batch(int(order[i + depth])) if i + depth < nb
                      else None)
            state, metrics, queue = prefetch_step(
                plan, state, plan.batch(int(b)), future, queue)
        agg.append(metrics)
    stacked = {k: torch.stack([m[k].to(torch.float32) for m in agg]).cpu()
               for k in agg[0]}
    out = {k: float(np.mean(v.numpy())) for k, v in stacked.items()}
    plan._last_qerr = out["hist_quant_err"]
    return state, out


# ---------------------------------------------------------------------------
# The fused epoch (the reference's `fused_epoch`: one jitted `lax.scan`
# over the stacked batches, `repro.core.runtime:418-464`)
# ---------------------------------------------------------------------------

# the metrics a step returns, in its order: the rows of the fused epoch's
# metric buffer
STEP_METRICS = ("loss", "ce", "acc", "reg", "halo_age_mean", "halo_age_max",
                "hist_quant_err")


@dataclass
class FusedEpoch:
    """The fused epoch's buffers, which outlive every epoch, and its
    graph. `order` [nb] int64 is written before each epoch; position i
    selects batch order[i] off the stack into `batches[i]` ([1, ...]
    buffers of every array of one batch); `slots` are the depth + 1 ring
    slots of prefetched mini-tables (position j's in slot j % (depth +
    1)); every step writes its STEP_METRICS into its row of `metrics`
    [nb, 7] f32. On the card: `stream`, which the body runs and is
    captured on; `graph`, the captured epoch; `held`, the tensors it
    reads and writes outside its own memory pool (the state's, the
    stack's, the plan's features, labels and mask) and the regularizer's
    generator, kept alive while the graph may replay over them; `key`,
    their addresses, shapes, strides and types; `captures` and
    `replays`, the graph's captures and launches."""
    order: torch.Tensor
    batches: List[GASBatch]
    slots: List[tuple]
    metrics: torch.Tensor
    depth: int
    shapes: list
    stream: Any = None
    graph: Any = None
    held: tuple = ()
    key: tuple = ()
    captures: int = 0
    replays: int = 0


def _fused_buffers(plan: GASPlan, state: GASState, depth: int) -> FusedEpoch:
    """The plan's `FusedEpoch`, made anew (and any graph dropped) when the
    stack's padded shapes or the depth changed since it was made."""
    fe = plan._fused
    if fe is not None and fe.depth == depth and \
            fe.shapes == _array_shapes(plan.batch_stack):
        return fe
    plan._fused = None
    dev, stack = plan.device, plan.batch_stack
    nb = stack.num_batches
    fe = FusedEpoch(
        order=torch.zeros((nb,), dtype=torch.int64, device=dev),
        batches=[stack.map_arrays(lambda a: torch.empty(
            (1,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev))
            for _ in range(nb)],
        slots=[state.histories.prefetch_buffers(stack.max_h)
               for _ in range(depth + 1 if depth else 0)],
        metrics=torch.zeros((nb, len(STEP_METRICS)), dtype=torch.float32,
                            device=dev),
        depth=depth, shapes=_array_shapes(plan.batch_stack))
    plan._fused = fe
    return fe


def _write_metrics(row: torch.Tensor, metrics: Dict[str, torch.Tensor]
                   ) -> None:
    if tuple(metrics) != STEP_METRICS:
        raise ValueError(f"a step returned the metrics {tuple(metrics)}, "
                         f"the fused epoch's buffer holds {STEP_METRICS}")
    torch.stack([metrics[k].to(torch.float32) for k in STEP_METRICS],
                out=row)


def fused_body(plan: GASPlan, state: GASState, fe: FusedEpoch) -> None:
    """The fused epoch's body, the same code on both devices: every
    position selects its batch off `plan.batch_stack` by the device index
    `fe.order[i]` into its buffers (the reference's `tree_map(lambda a:
    a[idx], batch_stack)`), then the `nb` steps run unrolled in position
    order: `make_step_fn`'s step at depth 0; at depth k the prologue's k
    prefetches, then `make_prefetch_step_fn`'s step at every position,
    which prefetches position i + k's halo into its ring slot. Each step
    writes its metrics into its row of `fe.metrics`. It reads nothing
    from the host and syncs nothing, so on the card it is captured as
    one CUDA graph; on the CPU it is the fused epoch's plain version, run
    eagerly every epoch. In place on `state`."""
    stack = plan.batch_stack.arrays()
    for i, pos in enumerate(fe.batches):
        sel = fe.order[i:i + 1]
        for src, dst in zip(stack, pos.arrays()):
            torch.index_select(src, 0, sel, out=dst)
    batches = [pos[0] for pos in fe.batches]
    nb, k = len(batches), fe.depth
    x, y, tm = plan.x, plan.y, plan.train_mask
    if k == 0:
        step = make_step_fn(plan)
        for i, batch in enumerate(batches):
            state, metrics = step(state, batch, x, y, tm)
            _write_metrics(fe.metrics[i], metrics)
        return
    pf_step = make_prefetch_step_fn(plan, k)
    queue = tuple(_prefetch_entry(plan, state.histories, batches[j],
                                  fe.slots[j % (k + 1)]) for j in range(k))
    for i, batch in enumerate(batches):
        future = batches[i + k] if i + k < nb else None
        state, metrics, queue = pf_step(
            state, batch, future, queue, x, y, tm,
            slot=fe.slots[(i + k) % (k + 1)])
        _write_metrics(fe.metrics[i], metrics)


def _graph_operands(plan: GASPlan, state: GASState) -> list:
    """Every tensor a captured epoch reads or writes that lives outside
    its memory pool: the params, the AdamW state, the store's tables,
    scales, clock, codebooks and statistics, the batch stack and the
    plan's features, labels and mask."""
    h, opt = state.histories, state.opt_state
    out = tree_leaves(state.params) + [opt.step] + tree_leaves(opt.m) + \
        tree_leaves(opt.v) + h.tables + [h.age]
    for aux in (h.scales, h.codebooks, h.cb_counts, h.cb_sums):
        out += aux or []
    return out + plan.batch_stack.arrays() + [plan.x, plan.y,
                                              plan.train_mask]


def _fused_on_card(plan: GASPlan, state: GASState, fe: FusedEpoch) -> None:
    """The fused epoch on the card. The plan's first fused epoch runs the
    body eagerly on `fe.stream` (the kernels build at first use, and a
    capture wants warmed allocators), with host syncs made errors
    (`torch.cuda.set_sync_debug_mode`), so that one in the body raises
    there, naming its call; that run is the epoch. Every later epoch
    replays `fe.graph` once, capturing it first when there is none or
    when any tensor it was captured over has moved (a checkpoint
    restore, a new store; the vq refit and the regrouping copy into the
    tensors they had, and a regrouping that grows the padded shapes makes
    new buffers, `_fused_buffers`). A capture that fails raises; nothing
    runs the steps eagerly instead."""
    main = torch.cuda.current_stream(plan.device)
    if fe.stream is None:
        fe.stream = torch.cuda.Stream(device=plan.device)
    if state.gen is None:
        state.gen = noise_generator(state.rng, plan.device)
    if not plan._fused_warm:
        fe.stream.wait_stream(main)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(fe.stream):
                fused_body(plan, state, fe)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        main.wait_stream(fe.stream)
        plan._fused_warm = True
        return
    operands = _graph_operands(plan, state)
    key = tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype,
                 t.device) for t in operands) + (id(state.gen),)
    if fe.graph is None or key != fe.key:
        fe.graph, fe.held, fe.key = None, (), ()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.gen)
        with torch.cuda.graph(graph, stream=fe.stream):
            fused_body(plan, state, fe)
        fe.graph, fe.held, fe.key = graph, (operands, state.gen), key
        fe.captures += 1
    fe.graph.replay()
    fe.replays += 1


def _fused_epoch(plan: GASPlan, state: GASState, order: np.ndarray,
                 depth: int) -> Dict[str, float]:
    """One fused epoch in `order` (`GASConfig.fused_epoch`): the order is
    copied once into the device index `fe.order`, the body runs
    (`fused_body`; on the card as one graph replay, `_fused_on_card`),
    and the host reads the metric buffer once and takes each metric's
    mean over the steps in step order, as the per-step epoch does, so the
    means are bitwise its."""
    fe = _fused_buffers(plan, state, depth)
    fe.order.copy_(torch.from_numpy(np.asarray(order, np.int64)))
    if plan.device.type == "cuda":
        _fused_on_card(plan, state, fe)
    else:
        fused_body(plan, state, fe)
    cols = np.ascontiguousarray(fe.metrics.cpu().numpy().T)
    return {k: float(np.mean(cols[j])) for j, k in enumerate(STEP_METRICS)}


def fit(plan: GASPlan, state: GASState, epochs: Optional[int] = None,
        log_every: int = 0) -> Tuple[GASState, List[Dict[str, float]]]:
    out = []
    for e in range(epochs or plan.config.epochs):
        state, m = train_epoch(plan, state, e)
        out.append(m)
        if log_every and (e + 1) % log_every == 0:
            ev = evaluate_exact(plan, state)
            print(f"epoch {e+1}: loss={m['loss']:.4f} "
                  f"val={ev['val_acc']:.4f} test={ev['test_acc']:.4f}")
    return state, out


@torch.no_grad()
def predict(plan: GASPlan, state: GASState) -> torch.Tensor:
    """History-based inference (the paper's constant-memory advantage):
    every batch in stack order against a clone of the store, so the
    state's tables and clock are left as they were (a host store's clone
    is pinned host memory too, and is read through prefetched
    mini-tables). Returns [N, C]."""
    from repro_torch.gnn.model import gas_batch_forward

    cfg = plan.config
    N, C = plan.graph.num_nodes, plan.spec.num_classes
    store = state.histories.clone()
    out = torch.zeros((N + 1, C), dtype=torch.float32, device=plan.device)
    for b in range(plan.batches.num_batches):
        batch = plan.batch(b)
        logits, store, _ = gas_batch_forward(
            state.params, plan.spec, plan.x, batch, store,
            use_history=cfg.use_history, fuse_halo=cfg.fuse_halo,
            halo_age_decay=cfg.halo_age_decay)
        safe = torch.where(batch.batch_mask, batch.batch_nodes.long(),
                           torch.full_like(batch.batch_nodes.long(), N))
        # each node lives in exactly one cluster: order-independent
        out[safe] = logits
    return out[:N]


@torch.no_grad()
def evaluate_exact(plan: GASPlan, state: GASState) -> Dict[str, float]:
    """Exact full-propagation evaluation (the paper evaluates exactly),
    over the COO in plain tensor code."""
    from repro_torch.gnn.model import full_forward

    g = plan.graph
    logits = full_forward(state.params, plan.spec, plan.x, plan.eval_edges,
                          plan.eval_w, g.num_nodes)
    y = plan.y[:g.num_nodes]
    out = {}
    for name, mask in (("train", g.train_mask), ("val", g.val_mask),
                       ("test", g.test_mask)):
        m = torch.from_numpy(np.asarray(mask)).to(plan.device)
        out[f"{name}_acc"] = float(_accuracy(logits, y, m))
    return out
