"""GAS training runtime: `GASConfig` -> `GASPlan` -> `GASState`.

The port of `repro.core.runtime`, the paper's Algorithm 1 as a training
loop:

    plan  = build_plan(graph, spec, config)            # static, built once
    state = init_state(plan)                           # params, opt, store
    state, metrics = train_step(plan, state, batch)    # one cluster batch
    state, metrics = train_epoch(plan, state, epoch)   # shuffled epoch
    logits         = predict(plan, state)              # history inference
    accs           = evaluate_exact(plan, state)       # full propagation

The reference jits the step, donates the whole state and, with
`fused_epoch`, scans an epoch in one dispatch. The port runs eagerly:
a step records the batch forward under autograd, takes the gradients
with `torch.autograd.grad`, clips them and applies AdamW in place on the
params and moments; the history pushes are in place too. So a step
returns the state it was given, updated, and an epoch is always the
per-step loop, which computes what the reference's scan computes; the
port's `GASConfig` has no `fused_epoch`. `predict` runs on a clone of
the store, since the reference's `predict` leaves the state's tables
untouched.

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
                                         grad_leaves)
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
    deeper than the batches allow is clamped, `_resolved_depth`). The
    reference's `backend` has no counterpart (the tensors' device picks
    the kernel or its plain version), nor has `fused_epoch`: an epoch is
    always the eager per-step loop."""
    num_parts: int
    partitioner: str = "metis"          # "metis" | "random"
    clusters_per_batch: int = 1
    use_history: bool = True
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
    which swaps `batches` / `batch_stack` keeping the padded shapes."""
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
    plan.batch_stack = plan.batches.to(plan.device)


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


def _loss(plan: GASPlan, logits: torch.Tensor, batch: GASBatch):
    """The loss and accuracy over the batch's training nodes."""
    idx = batch.batch_nodes.long().clamp(0, plan.y.shape[0] - 1)
    labels = plan.y[idx].long()
    m = plan.train_mask[idx] & batch.batch_mask
    return masked_cross_entropy(logits, labels, m), _accuracy(logits, labels,
                                                              m)


def grads_and_metrics(plan: GASPlan, state: GASState, batch: GASBatch,
                      pulled: Optional[tuple] = None,
                      after_forward: Optional[Callable] = None):
    """The step's forward and backward without the update: the gradients
    (a list in `tree_leaves(params)` order, unclipped) and the metrics.
    The loss is `ce + spec.reg_weight * reg`, the reference's. The
    history pushes of the forward land in `state.histories`. The extended
    step of the pipeline (the reference's `_make_step_fn_ex`): `pulled`
    feeds the forward's history reads from prefetched mini-tables, and
    `after_forward(pushed)`, given the hidden layers' pushed rows, runs
    once the pushes are queued and before the backward."""
    from repro_torch.gnn.model import gas_batch_forward

    cfg, spec = plan.config, plan.spec
    if state.gen is None:
        state.gen = noise_generator(state.rng, plan.device)
    params, leaves = grad_leaves(state.params)
    logits, _, diags, pushed = gas_batch_forward(
        params, spec, plan.x, batch, state.histories,
        use_history=cfg.use_history, fuse_halo=cfg.fuse_halo,
        gen=state.gen, halo_age_decay=cfg.halo_age_decay, pulled=pulled,
        return_pushed=True)
    if after_forward is not None:
        after_forward(pushed)
    reg = diags.pop("reg")
    ce, acc = _loss(plan, logits, batch)
    loss = ce + spec.reg_weight * reg
    grads = list(torch.autograd.grad(loss, leaves))
    metrics = {"loss": loss.detach(), "ce": ce.detach(), "acc": acc,
               "reg": reg.detach(), **diags}
    return grads, metrics


def apply_update(plan: GASPlan, state: GASState,
                 grads: List[torch.Tensor]) -> GASState:
    """The step's update: global-norm clipping, then AdamW with b2 = 0.999
    (as the reference's step passes), in place on the params and moments.
    Returns `state`."""
    cfg = plan.config
    grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    _, state.opt_state = adamw_update(
        grads, state.opt_state, state.params, lr=cfg.lr, b1=0.9, b2=0.999,
        weight_decay=cfg.weight_decay)
    return state


def train_step(plan: GASPlan, state: GASState, batch: GASBatch
               ) -> Tuple[GASState, Dict[str, torch.Tensor]]:
    """One optimization step on one cluster batch: forward with history
    pushes, backward through the kernels' autograd.Functions
    (`grads_and_metrics`), then `apply_update`, all in place on `state`,
    which is returned. Metrics stay tensors on the device (no host
    sync)."""
    grads, metrics = grads_and_metrics(plan, state, batch)
    return apply_update(plan, state, grads), metrics


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


def _prefetch_entry(plan: GASPlan, store: HistoryStore,
                    batch: GASBatch) -> PrefetchEntry:
    """Start the prefetch of `batch`'s halo rows. On the card its gathers
    run on the plan's side stream, behind an event recorded on the main
    stream now, so they read the tables as every push queued so far left
    them; the mini-tables are allocated on the side stream and marked
    used by the main one (`record_stream`), which patches and reads them.
    On the CPU the gathers run in place."""
    if plan.device.type != "cuda":
        return PrefetchEntry(store.prefetch(batch.halo_nodes),
                             batch.halo_nodes, batch.halo_mask)
    main = torch.cuda.current_stream(plan.device)
    if plan._side is None:
        plan._side = torch.cuda.Stream(device=plan.device)
    side = plan._side
    side.wait_stream(main)
    with torch.cuda.stream(side):
        batch.halo_nodes.record_stream(side)
        pulled = store.prefetch(batch.halo_nodes)
        done = torch.cuda.Event()
        done.record(side)
    for rows, scl in pulled:
        for t in (rows,) if scl is None else (rows, scl):
            t.record_stream(main)
    return PrefetchEntry(pulled, batch.halo_nodes, batch.halo_mask, done)


def prefetch_step(plan: GASPlan, state: GASState, batch: GASBatch,
                  future_batch: Optional[GASBatch], queue: tuple
                  ) -> Tuple[GASState, Dict[str, torch.Tensor], tuple]:
    """One step of the pipelined epoch (the step the reference's
    `make_prefetch_step_fn` builds). `queue` holds the prefetches in
    flight, its head this batch's. The schedule, which keeps every read
    of a table off the rows the main stream is writing:

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
    entry, if `future_batch` is given)."""
    if plan.device.type == "cuda":
        main = torch.cuda.current_stream(plan.device)
        for e in queue:
            main.wait_event(e.done)
    head, rest = queue[0], list(queue[1:])

    def after_forward(pushed):
        for e in rest:
            state.histories.patch_pulled(e.pulled, e.halo_nodes, e.halo_mask,
                                         batch.batch_nodes, batch.batch_mask,
                                         pushed)
        if future_batch is not None:
            rest.append(_prefetch_entry(plan, state.histories, future_batch))

    grads, metrics = grads_and_metrics(plan, state, batch, pulled=head.pulled,
                                       after_forward=after_forward)
    return apply_update(plan, state, grads), metrics, tuple(rest)


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
    synchronous epoch. Returns the per-step metrics' means."""
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
    agg = []
    depth, nb = _resolved_depth(plan), len(order)
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
