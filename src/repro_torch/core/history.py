"""Historical embedding storage (the paper's central data structure).

The port of `repro.core.history`: one [N+1, d] table per hidden layer
holding each node's layer output from the last time it was computed (the
+1 row is a masked sentinel that padded indices point at, and the push's
sacrificial row), plus the staleness clock `age` [N+1] int32.

Storage precision (`history_dtype`) comes from the reference's codec
registry (`HistoryCodec`, `get_codec`), the one place that decides: f32
tables; bf16 tables (pushes round to bf16, pulls return bf16 rows that
are upcast where they are consumed); and int8 tables of symmetric
per-row codes beside a per-row f32 scale table `scales` [N+1] (push
quantizes `s_i = max|v_i| / 127`, `q_i = round(v_i / s_i)`, pull
dequantizes `q_i * s_i` in f32; `kernels.ref.quantize_rows`). The added
error of a push is `quantization_error`, the `hist_quant_err` diagnostic.
vq stores (product quantization, `repro.core.history:258-344`) hold one
uint8 code per 8-wide subvector, [N+1, d/8] per layer, beside the per-row
f32 scale `max|v_i|` and a per-layer codebook [d/8, 256, 8] f32 whose
entry 0 is pinned to zero; a push encodes each subvector of `v_i / s_i`
as its nearest entry (`kernels.ref.vq_encode_rows`), a pull decodes. Each
push also folds its rows' codes into k-means statistics (`cb_counts`
[d/8, 256], `cb_sums` [d/8, 256, 8]), from which `refit_codebooks` moves
the codebooks and re-encodes every stored row (`GASConfig.vq_refit_every`
and `vq_refit_drift` decide when).

The reference store is a frozen pytree whose methods return new stores,
and XLA performs its push in place only when the jitted step donates the
tables. Here the store is mutable: `push` scatters into the table (and
scale) tensors themselves and `tick` updates `age` in place, and both
return the store for chaining; a vq push adds into the k-means
statistics, and a refit copies the new codebooks into the old ones and
zeroes the statistics, all in place.

Placement (`storage`, `repro.core.history:165-215`): "device" keeps
everything on the store's device; "host" keeps the tables and the int8
/ vq scale tables in pinned host memory (the paper's large-graph setup:
table capacity then scales with host RAM, and only pulled rows reach the
card), while the clock, the vq codebooks and their statistics stay on
the card. The pushes write a host table through its unified address, and
every read of one goes through `prefetch`: one `gather_rows_raw_many`
launch copies every layer's halo rows (and scales) into device
mini-tables, and `with_pulled` makes a read view of them, so no
contraction kernel ever reads a host table. On the CPU
(`device="cpu"`) a host store is a CPU store and the same code runs, as
the reference's moves are no-ops on a host-less runtime. `prefetch`, `with_pulled` and `patch_pulled` also carry the
epoch pipeline (`GASConfig.prefetch_depth`) over either placement.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.gather import gather_rows_raw_many
from repro_torch.kernels.ref import (dequantize_rows, quantize_rows,
                                     relative_row_error, row_scales,
                                     vq_decode_rows, vq_encode_rows,
                                     vq_row_scales)
from repro_torch.kernels.scatter import (SCAN_MAX_ROWS, scatter_rows_q,
                                         scatter_rows_raw_many,
                                         scatter_rows_vq)
from .config import resolve_device

__all__ = ["HistoryCodec", "HISTORY_DTYPES", "get_codec",
           "resolve_history_dtype", "HISTORY_STORAGES",
           "resolve_history_storage", "REFIT_CHUNK_ROWS", "row_scales",
           "quantize_rows", "dequantize_rows", "quantization_error",
           "VQ_SUBDIM", "VQ_CODES", "VQ_SEED", "vq_table_width",
           "vq_init_codebook", "vq_row_scales", "vq_encode_rows",
           "vq_decode_rows", "vq_accumulate_stats", "vq_refit_codebook",
           "storage_dtype", "host_storage_supported", "Histories",
           "init_histories", "pull", "push", "tick", "history_bytes",
           "HistoryStore"]

# Product quantization (history_dtype="vq"): each row is split into
# d / VQ_SUBDIM subvectors, each stored as one uint8 index into a
# per-layer [S, VQ_CODES, VQ_SUBDIM] f32 codebook (the reference's
# constants, `repro.core.history:58-63`).
VQ_SUBDIM = 8
VQ_CODES = 256
VQ_SEED = 0

HISTORY_STORAGES = ("device", "host")
# the most rows a host store's refit decodes and re-encodes at a time: a
# push of at most SCAN_MAX_ROWS rows needs no N-entry winner scratch on
# the card, and no [N, d] f32 copy of a table is made
REFIT_CHUNK_ROWS = SCAN_MAX_ROWS


# ---------------------------------------------------------------------------
# History-dtype registry (`repro.core.history:74-146`): one table drives
# every dtype decision, and every entry point rejects an unknown name with
# the same ValueError (via `get_codec`).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HistoryCodec:
    """One row of the registry. `lossless`: push/pull round-trips
    bit-exact (quantization error 0). `scaled`: a per-row f32 scale table
    rides beside each layer table. `vq`: a per-layer codebook (and its
    refit statistics) rides along, and the layer table holds uint8 codes
    of width d / VQ_SUBDIM. `roundtrip(values, codebook)` is the f32
    reconstruction a push-then-pull returns. `encode(values, codebook)`
    -> (table rows, scales), for the scaled codecs, is what a push writes
    for each row (None for f32 and bf16, whose push writes the rows cast
    to `storage`): the store's own push kernel run into a scratch table at
    arange(M), so the codes and scales are bitwise those of a push."""
    name: str
    storage: torch.dtype
    lossless: bool
    scaled: bool
    vq: bool
    roundtrip: Callable = field(default=lambda v, cb: v)
    encode: Optional[Callable] = None

    def table_width(self, d: int) -> int:
        return vq_table_width(d) if self.vq else d


def _roundtrip_bf16(v: torch.Tensor, cb) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float32)


def _roundtrip_int8(v: torch.Tensor, cb) -> torch.Tensor:
    return dequantize_rows(*quantize_rows(v))


def _roundtrip_vq(v: torch.Tensor, cb) -> torch.Tensor:
    codes, scales = vq_encode_rows(v, cb)
    return vq_decode_rows(codes, cb, scales)


def _scratch(v: torch.Tensor, width: int, dtype: torch.dtype):
    """(a zero [M, width] table, a [M] scale table of ones, arange(M)
    int32) on `v`'s device: the scratch an encode pushes into."""
    m = v.shape[0]
    return (torch.zeros((m, width), dtype=dtype, device=v.device),
            torch.ones((m,), dtype=torch.float32, device=v.device),
            torch.arange(m, dtype=torch.int32, device=v.device))


def _encode_int8(v: torch.Tensor, cb) -> Tuple[torch.Tensor, torch.Tensor]:
    rows, scales, idx = _scratch(v, v.shape[1], torch.int8)
    scatter_rows_q(rows, scales, idx, v.to(torch.float32).contiguous())
    return rows, scales


def _encode_vq(v: torch.Tensor, cb) -> Tuple[torch.Tensor, torch.Tensor]:
    rows, scales, idx = _scratch(v, cb.shape[0], torch.uint8)
    scatter_rows_vq(rows, scales, idx, v.to(torch.float32).contiguous(), cb)
    return rows, scales


_CODECS = {
    "f32": HistoryCodec("f32", torch.float32, lossless=True, scaled=False,
                        vq=False),
    "bf16": HistoryCodec("bf16", torch.bfloat16, lossless=False,
                         scaled=False, vq=False, roundtrip=_roundtrip_bf16),
    "int8": HistoryCodec("int8", torch.int8, lossless=False, scaled=True,
                         vq=False, roundtrip=_roundtrip_int8,
                         encode=_encode_int8),
    "vq": HistoryCodec("vq", torch.uint8, lossless=False, scaled=True,
                       vq=True, roundtrip=_roundtrip_vq, encode=_encode_vq),
}

HISTORY_DTYPES = tuple(_CODECS)


def get_codec(history_dtype: str) -> HistoryCodec:
    """Registry lookup. An unknown name raises the reference's ValueError,
    word for word."""
    codec = _CODECS.get(history_dtype)
    if codec is None:
        raise ValueError(
            f"history_dtype must be one of {HISTORY_DTYPES}, "
            f"got {history_dtype}")
    return codec


def resolve_history_dtype(history_dtype: Optional[str] = None) -> str:
    """The argument, else $REPRO_HISTORY_DTYPE, else "f32", the
    reference's order (`repro.core.history.resolve_history_dtype`); the
    name it takes is checked with `get_codec`."""
    for cand in (history_dtype,
                 os.environ.get("REPRO_HISTORY_DTYPE") or None):
        if cand is not None:
            get_codec(cand)
            return cand
    return "f32"


def resolve_history_storage(storage: Optional[str] = None) -> str:
    """The argument, else $REPRO_HISTORY_STORAGE, else "device", the
    reference's order (`repro.core.history.resolve_history_storage`); a
    name outside HISTORY_STORAGES raises the reference's ValueError, word
    for word."""
    for cand in (storage,
                 os.environ.get("REPRO_HISTORY_STORAGE") or None):
        if cand is not None:
            if cand not in HISTORY_STORAGES:
                raise ValueError(
                    f"storage must be one of {HISTORY_STORAGES}, "
                    f"got {cand}")
            return cand
    return "device"


def storage_dtype(history_dtype: str) -> torch.dtype:
    """The table's element type for a resolved history_dtype."""
    return get_codec(history_dtype).storage


def host_storage_supported() -> bool:
    """True when tables can be kept in host memory: always here. On a card
    they are pinned and reached by unified address; on the CPU a host
    store is a CPU store (the reference's moves are no-ops on a host-less
    runtime too)."""
    return True


# ---------------------------------------------------------------------------
# The legacy tuple and its free functions (`repro.core.history:372-412`)
# ---------------------------------------------------------------------------

class Histories(NamedTuple):
    """The legacy history container: L-1 tables [N+1, d] and the clock
    [N+1] int32. Allocate N + 1 rows: the last is the sentinel that padded
    indices point at, and the executors' pushes use it as their
    sacrificial row. `gas_forward` and `gas_batch_forward` take it as the
    reference's do (`core.gas.resolve_store`)."""
    tables: List[torch.Tensor]       # L-1 tables [N+1, d_hidden]
    age: torch.Tensor                # [N+1] int32, steps since last push


def init_histories(num_nodes: int, dims: List[int],
                   dtype=torch.float32, device=None) -> Histories:
    """Zero tables of `dtype` and a zero clock on `device` (None means
    "cuda")."""
    dev = resolve_device(device)
    return Histories(
        tables=[torch.zeros((num_nodes, d), dtype=dtype, device=dev)
                for d in dims],
        age=torch.zeros((num_nodes,), dtype=torch.int32, device=dev))


def pull(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather halo rows; `idx` is clipped to the table, so padded indices
    read the last row."""
    return ops.pull_rows(table, idx)


def push(table: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """A new table: `table` with rows `idx` set to `values` where `mask`
    (masked rows dropped, the last writer wins), as the reference's
    functional push; `table` itself is left as it was."""
    return ops.push_rows(table.clone(), idx, values, mask)


def tick(hist: Histories, batch_idx: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """A new clock: age + 1 everywhere, 0 for the just-pushed nodes."""
    return HistoryStore(tables=[], age=hist.age + 1).reset_age(
        batch_idx, mask).age


def history_bytes(hist: Histories) -> int:
    return _nbytes(hist.tables)


# ---------------------------------------------------------------------------
# vq helpers (`repro.core.history:258-344`). The encode and decode are the
# plain versions of the kernels (`kernels.ref`); the k-means statistics
# and the refit are plain tensor code.
# ---------------------------------------------------------------------------

def vq_table_width(d: int) -> int:
    """Code-table width S for a d-wide layer; vq needs d % VQ_SUBDIM == 0
    (the reference's ValueError, word for word)."""
    if d % VQ_SUBDIM:
        raise ValueError(
            f"history_dtype='vq' requires feature dims divisible by "
            f"{VQ_SUBDIM}, got {d}")
    return d // VQ_SUBDIM


def vq_init_codebook(d: int, seed: int = VQ_SEED,
                     device=None) -> torch.Tensor:
    """The initial codebook [S, VQ_CODES, VQ_SUBDIM] f32, uniform in
    [-1, 1) from a `torch.Generator` seeded with `seed` (on the CPU, so
    every device gets the same values), entry 0 pinned to the zero vector
    so that all-zero rows, a fresh table's, round-trip exactly. The
    reference draws from `jax.random`: the same distribution, other
    values (tests carry the reference's codebooks across)."""
    s = vq_table_width(d)
    gen = torch.Generator().manual_seed(seed)
    cb = torch.rand((s, VQ_CODES, VQ_SUBDIM), generator=gen,
                    dtype=torch.float32) * 2.0 - 1.0
    cb[:, 0, :] = 0.0
    return cb.to(resolve_device(device))


def vq_accumulate_stats(codes: torch.Tensor, values: torch.Tensor,
                        scales: torch.Tensor, mask: torch.Tensor,
                        counts: torch.Tensor, sums: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one push's assignments into the k-means statistics (counts
    [S, C], sums [S, C, ds]; the E-step came free with the encode), in
    place, so that a captured training epoch (`core.runtime`) finds them
    where it did: returns (counts, sums), the reference's new statistics.
    Masked rows contribute nothing; duplicates count once each. The sums
    are the one-hot assignments times the normalized subvectors as one
    batched matrix product, so they are deterministic on the card (no
    atomics)."""
    s_, c = counts.shape
    v = values.to(torch.float32)
    u = (v / scales[:, None]).reshape(v.shape[0], s_, -1)
    entries = torch.arange(c, device=codes.device)
    onehot = (codes.long()[:, :, None] == entries).to(torch.float32)
    onehot = onehot * mask.to(torch.float32)[:, None, None]
    dsum = torch.bmm(onehot.permute(1, 2, 0), u.permute(1, 0, 2))
    return counts.add_(onehot.sum(0)), sums.add_(dsum)


def vq_refit_codebook(codebook: torch.Tensor, counts: torch.Tensor,
                      sums: torch.Tensor) -> torch.Tensor:
    """The k-means M-step: entries with assignments move to the mean of
    their assigned normalized subvectors, the others stay, entry 0 stays
    at zero."""
    hit = (counts > 0)[:, :, None]
    new = torch.where(hit, sums / torch.clamp(counts, min=1.0)[:, :, None],
                      codebook)
    new[:, 0, :] = 0.0
    return new


def quantization_error(values: torch.Tensor, mask: torch.Tensor,
                       history_dtype: str,
                       codebook: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Mean per-row relative L2 error `||v - dq(q(v))|| / ||v||` a push of
    `values` incurs under `history_dtype` (vq: against `codebook`), over
    the `mask`-valid rows; exactly 0 for a lossless codec
    (`repro.core.history:347`)."""
    codec = get_codec(history_dtype)
    if codec.lossless:
        return torch.zeros((), dtype=torch.float32, device=values.device)
    v = values.to(torch.float32)
    return _masked_mean(relative_row_error(v, codec.roundtrip(v, codebook)),
                        mask)


def _masked_mean(row_err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    valid = mask.to(torch.float32)
    return torch.sum(row_err * valid) / torch.clamp(valid.sum(), min=1.0)


@dataclass
class HistoryStore:
    tables: List[torch.Tensor]
    age: torch.Tensor
    history_dtype: str = "f32"
    scales: Optional[List[torch.Tensor]] = None     # int8/vq: [N+1] f32
    codebooks: Optional[List[torch.Tensor]] = None  # vq: [S, 256, 8] f32
    cb_counts: Optional[List[torch.Tensor]] = None  # vq: [S, 256] f32
    cb_sums: Optional[List[torch.Tensor]] = None    # vq: [S, 256, 8] f32
    storage: str = "device"                         # "device" | "host"

    @classmethod
    def create(cls, num_nodes: int, dims: List[int],
               history_dtype: Optional[str] = None,
               device=None, storage: Optional[str] = None
               ) -> "HistoryStore":
        """Zero tables (zero codes at scale 1.0 for int8 and vq, as the
        reference's `create`; a vq store also gets `vq_init_codebook(d)`
        per layer and zero statistics) and ages. `num_nodes` must include
        the sentinel row (pass N + 1). `history_dtype` resolves as
        `resolve_history_dtype` (argument, $REPRO_HISTORY_DTYPE, "f32"),
        `storage` as `resolve_history_storage` (argument,
        $REPRO_HISTORY_STORAGE, "device"); `device=None` means "cuda". A
        host store on the card allocates its tables and scale tables in
        pinned host memory, and only the clock, codebooks and statistics
        on the card."""
        hd = resolve_history_dtype(history_dtype)
        st = resolve_history_storage(storage)
        codec = get_codec(hd)
        widths = [codec.table_width(d) for d in dims]
        dev = resolve_device(device)
        where = (dict(device="cpu", pin_memory=True)
                 if st == "host" and dev.type == "cuda" else dict(device=dev))
        scales = ([torch.ones((num_nodes,), dtype=torch.float32, **where)
                   for _ in dims] if codec.scaled else None)
        codebooks = counts = sums = None
        if codec.vq:
            codebooks = [vq_init_codebook(d, device=dev) for d in dims]
            counts = [torch.zeros(cb.shape[:2], dtype=torch.float32,
                                  device=dev) for cb in codebooks]
            sums = [torch.zeros_like(cb) for cb in codebooks]
        return cls(tables=[torch.zeros((num_nodes, w), dtype=codec.storage,
                                       **where) for w in widths],
                   age=torch.zeros((num_nodes,), dtype=torch.int32,
                                   device=dev),
                   history_dtype=hd, scales=scales, codebooks=codebooks,
                   cb_counts=counts, cb_sums=sums, storage=st)

    @property
    def device(self) -> torch.device:
        return self.age.device

    @property
    def pinned(self) -> bool:
        """True for a host store on the card: its tables and scale tables
        are pinned host tensors that the kernels reach by unified
        address."""
        return self.storage == "host" and self.device.type == "cuda"

    def _placed(self, t: torch.Tensor, copy: bool = False) -> torch.Tensor:
        """`t` where this store keeps its tables (pinned host memory for a
        host store on the card, plain CPU memory for one on the CPU, else
        the store's device): `t` itself where it is there already, unless
        `copy`."""
        if self.pinned:
            if t.device.type == "cpu" and t.is_pinned() and not copy:
                return t
            return torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=True).copy_(t)
        where = "cpu" if self.storage == "host" else self.device
        return t.to(where, copy=copy)

    def place(self) -> "HistoryStore":
        """In place: the tables and scale tables moved to where `storage`
        keeps them; idempotent, and the re-placement after a checkpoint
        restore, as the reference's `place`. Returns the store."""
        resolve_history_storage(self.storage)
        self.tables = [self._placed(t) for t in self.tables]
        if self.scales is not None:
            self.scales = [self._placed(t) for t in self.scales]
        return self

    def sync(self) -> "HistoryStore":
        """Wait for the card's queued writes into a pinned table (the
        pushes) before the host reads it; a no-op for other stores."""
        if self.pinned:
            torch.cuda.synchronize(self.device)
        return self

    @property
    def num_layers(self) -> int:
        return len(self.tables)

    def layer_scales(self, ell: int) -> Optional[torch.Tensor]:
        """The per-row f32 scale table of layer `ell` (None unless int8 or
        vq)."""
        return None if self.scales is None else self.scales[ell]

    def layer_codebook(self, ell: int) -> Optional[torch.Tensor]:
        """The [S, 256, 8] f32 codebook of layer `ell` (None unless vq)."""
        return None if self.codebooks is None else self.codebooks[ell]

    def pull(self, ell: int, idx: torch.Tensor) -> torch.Tensor:
        """Gather rows of H̄^(ell) (idx clipped to the table), dequantized:
        f32 rows for f32, int8 and vq stores, bf16 rows for bf16 stores
        (upcast where they are consumed), as the reference's pull. At the
        layer's own width: the reference's `pad_out=True` pull, which
        keeps its kernels' 128-lane padding, has no counterpart because
        the port's kernels mask ragged widths. A host store's rows are
        first copied raw into device mini-tables (`prefetch`), then read
        from them."""
        if self.storage == "host":
            (rows, scl), = self.prefetch(idx, layers=(ell,))
            mini = torch.arange(rows.shape[0], dtype=torch.int32,
                                device=rows.device)
            return ops.pull_rows(rows, mini, scales=scl,
                                 codebook=self.layer_codebook(ell))
        return ops.pull_rows(self.tables[ell], idx,
                             scales=self.layer_scales(ell),
                             codebook=self.layer_codebook(ell))

    # -- the epoch pipeline's reads (`repro.core.history:581-616, 702-743`)

    def prefetch(self, idx: torch.Tensor,
                 layers: Optional[Tuple[int, ...]] = None,
                 out: Optional[tuple] = None) -> tuple:
        """Every layer's rows `idx` (clipped to the table) in raw storage
        precision, with their scales for int8 and vq: one `(rows,
        scales|None)` pair a layer, on the store's device, through one
        `gather_rows_raw_many` call over every table and scale table (one
        launch, which reads a pinned host table across the link). No
        dequantization happens here: the rows are the table's bits, so a
        read view of them (`with_pulled`) gives what a pull of the full
        table gives, bit for bit. `layers` picks some layers only. `out`,
        buffers shaped like the result (`prefetch_buffers`), takes the
        rows in place of new tensors: the fused epoch's ring slots."""
        idx = idx.to(device=self.device, dtype=torch.int32)
        ells = range(self.num_layers) if layers is None else layers
        dst = None if out is None else [t for pair in out for t in pair
                                        if t is not None]
        if self.scales is None:
            return tuple((rows, None) for rows in gather_rows_raw_many(
                [self.tables[ell] for ell in ells], idx, out=dst))
        got = gather_rows_raw_many([t for ell in ells for t in (
            self.tables[ell], self.scales[ell])], idx, out=dst)
        return tuple(zip(got[0::2], got[1::2]))

    def prefetch_buffers(self, m: int) -> tuple:
        """Device buffers shaped like `prefetch` of `m` indices over every
        layer, one `(rows, scales|None)` pair a layer, for its `out`."""
        def like(t):
            return torch.empty((m,) + tuple(t.shape[1:]), dtype=t.dtype,
                               device=self.device)
        return tuple((like(t), None if self.scales is None
                      else like(self.scales[ell]))
                     for ell, t in enumerate(self.tables))

    def with_pulled(self, pulled) -> "HistoryStore":
        """A read view whose layer tables are the prefetched rows (`pulled`
        from `prefetch`): its row i holds what row halo_nodes[i] of the full
        store held, so reading the view at arange(max_h) gives a pull of
        the halo bit for bit, through the same dequantizing or decoding
        kernel. The view shares the clock (staleness reads index it with
        the real halo ids), the codebooks and the statistics, and lies on
        the device. Push into the store, never into the view."""
        return HistoryStore(
            tables=[p[0] for p in pulled], age=self.age,
            history_dtype=self.history_dtype,
            scales=None if self.scales is None else [p[1] for p in pulled],
            codebooks=self.codebooks, cb_counts=self.cb_counts,
            cb_sums=self.cb_sums, storage="device")

    def patch_pulled(self, pulled, halo_nodes: torch.Tensor,
                     halo_mask: torch.Tensor, batch_nodes: torch.Tensor,
                     batch_mask: torch.Tensor, pushed):
        """The pipeline's write-after-read repair, in place: `pulled` was
        prefetched for a later batch before the batch that just ran pushed
        its rows, so every halo slot whose node that batch pushed holds the
        old bits. Each such slot is rewritten from the pushed rows
        (`pushed`, one [max_b, d] tensor a layer) by the store's own push
        kernel on the mini-table (`push_rows`, `push_rows_q`,
        `push_rows_vq`), which writes exactly the bits, codes and scales
        that the push wrote into the full table; masked halo slots are
        left as they are. The batch's nodes are found by a sorted search
        over its max_b rows (no [N+1] position array). Returns
        `pulled`."""
        hit, row = _halo_hits(halo_nodes, halo_mask, batch_nodes,
                              batch_mask)
        slots = torch.arange(halo_nodes.shape[0], dtype=torch.int32,
                             device=hit.device)
        for ell, (rows, scl) in enumerate(pulled):
            vals = pushed[ell][row]
            if self.codebooks is not None:
                ops.push_rows_vq(rows, scl, slots, vals, hit,
                                 self.codebooks[ell])
            elif scl is not None:
                ops.push_rows_q(rows, scl, slots, vals, hit)
            else:
                ops.push_rows(rows, slots, vals, hit)
        return pulled

    def push(self, ell: int, idx: torch.Tensor, values: torch.Tensor,
             mask: torch.Tensor) -> "HistoryStore":
        """Scatter fresh rows into H̄^(ell) in place where `mask`,
        quantizing to the store's precision on the way in; masked rows go
        to the sentinel row. A vq push also folds the rows' codes into the
        layer's k-means statistics."""
        self.push_measured(ell, idx, values, mask)
        return self

    def push_measured(self, ell: int, idx: torch.Tensor,
                      values: torch.Tensor, mask: torch.Tensor,
                      stats: bool = True) -> Optional[torch.Tensor]:
        """`push`, returning the error it incurred: `quant_error` of the
        same rows (the push's term of `hist_quant_err`), or None for a
        lossless store, whose term is exactly 0. An int8 or vq push takes
        the per-row errors its kernel writes beside the codes, so the
        codec does not run a second time; a vq push folds the per-row
        codes the kernel writes into the statistics, unless `stats` is
        False (serving, which must leave them as they are)."""
        if self.codebooks is not None:
            _, _, codes, err = ops.push_rows_vq(
                self.tables[ell], self.scales[ell], idx, values, mask,
                self.codebooks[ell], scratch_last_row=True)
            if stats:
                v = values.to(torch.float32)
                vq_accumulate_stats(codes, v, vq_row_scales(v), mask,
                                    self.cb_counts[ell], self.cb_sums[ell])
            return _masked_mean(err, mask)
        if self.scales is not None:
            err = ops.push_rows_q(self.tables[ell], self.scales[ell], idx,
                                  values, mask, scratch_last_row=True)[2]
            return _masked_mean(err, mask)
        ops.push_rows(self.tables[ell], idx, values, mask,
                      scratch_last_row=True)
        if get_codec(self.history_dtype).lossless:
            return None
        return self.quant_error(values, mask, ell)

    def push_raw(self, idx: torch.Tensor, mask: torch.Tensor,
                 rows, scales=None) -> "HistoryStore":
        """In place: every layer's rows `rows[ell]` [M, w], already in
        storage precision (f32 or bf16 rows, int8 or vq codes: what
        `HistoryCodec.encode` or a cast to `storage` made), written raw,
        never re-quantized, at `idx` where `mask`, with `scales[ell]` [M]
        beside them for int8 and vq; masked and out-of-range rows are
        dropped, and a repeated index takes its last row. The serving
        backend lands a frontend's push through it: one
        `scatter_rows_raw_many` call over every table and scale table (one
        launch, which writes a pinned host table through its unified
        address, on the current stream, and takes each target's rows in
        every table from the same pushed row). The clock is not touched.
        Returns the store."""
        n = self.age.shape[0]
        idx = idx.to(device=self.device)
        mask = mask.to(device=self.device, dtype=torch.bool)
        safe = torch.where(mask, idx.to(torch.int32), n)
        if len(rows) != self.num_layers or (scales is None) != (
                self.scales is None) or (scales is not None and len(
                    scales) != self.num_layers):
            raise ValueError(
                f"push_raw: {len(rows)} row sets and "
                f"{'no' if scales is None else len(scales)} scale sets for "
                f"a {self.history_dtype} store of {self.num_layers} layers")
        tables, pushed = [], []
        for ell in range(self.num_layers):
            tables.append(self.tables[ell])
            pushed.append(rows[ell].to(self.device).contiguous())
            if self.scales is not None:
                tables.append(self.scales[ell])
                pushed.append(scales[ell].to(self.device).contiguous())
        scatter_rows_raw_many(tables, safe, pushed)
        return self

    def quant_error(self, values: torch.Tensor, mask: torch.Tensor,
                    ell: int = 0) -> torch.Tensor:
        """The relative error a push of `values` incurs at this precision
        (the `hist_quant_err` diagnostic; exactly 0 for f32 stores); `ell`
        picks the codebook of a vq store."""
        return quantization_error(values, mask, self.history_dtype,
                                  self.layer_codebook(ell))

    def refit_codebooks(self) -> "HistoryStore":
        """In place: the k-means M-step from the statistics the pushes
        since the last refit gathered (`vq_refit_codebook`), then every
        stored row (the sentinel's too) decoded under the old codebook and
        re-encoded under the new one, as the reference's refit, and the
        statistics zeroed. The decode and the encode are the pull's and
        the push's kernels (`pull`, `scatter_rows_vq`): a device store
        takes all rows at once (a transient f32 copy of each table), a
        host store REFIT_CHUNK_ROWS rows at a time, so that no O(N) f32
        table or winner scratch lands on the card. Each row is re-encoded
        on its own, so the chunks give the one pass's codes bit for bit.
        The codebooks and statistics keep their tensors (the new
        codebook is copied into the old one), so that a captured training
        epoch (`core.runtime`) reads them where it did. A no-op for other
        stores."""
        if self.codebooks is None:
            return self
        for ell in range(self.num_layers):
            cb_old = self.codebooks[ell]
            cb = vq_refit_codebook(cb_old, self.cb_counts[ell],
                                   self.cb_sums[ell])
            table, scales = self.tables[ell], self.scales[ell]
            n = table.shape[0]
            chunk = REFIT_CHUNK_ROWS if self.storage == "host" else n
            for a in range(0, n, chunk):
                idx = torch.arange(a, min(a + chunk, n), dtype=torch.int32,
                                   device=self.device)
                scatter_rows_vq(table, scales, idx, self.pull(ell, idx), cb)
            cb_old.copy_(cb)
            self.cb_counts[ell].zero_()
            self.cb_sums[ell].zero_()
        return self

    def tick(self, batch_idx: torch.Tensor,
             mask: torch.Tensor) -> "HistoryStore":
        """Advance the staleness clock in place: age += 1, just-pushed
        rows -> 0."""
        self.age += 1
        return self.reset_age(batch_idx, mask)

    def reset_age(self, idx: torch.Tensor,
                  mask: torch.Tensor) -> "HistoryStore":
        """In place: age[idx[i]] = 0 where mask[i] (masked entries are
        dropped). A mask over the clock, filled on the device, so no host
        sync (an indexed assignment of a Python value would copy it from
        the host)."""
        n = self.age.shape[0]
        hit = torch.zeros((n + 1,), dtype=torch.bool, device=self.device)
        hit.index_fill_(0, torch.where(mask, idx.long(), n), True)
        self.age.masked_fill_(hit[:n], 0)
        return self

    def grow(self, n_new: int) -> "HistoryStore":
        """A store extended by `n_new` nodes (evolving graphs): zero rows
        spliced in before the sentinel row, so every existing row, its
        scale and age, and the sentinel keep their meaning. A zero row is
        what `create` makes for every codec (zero f32/bf16 rows, zero int8
        codes at scale 1.0, zero vq codes, codebook entry 0 being pinned
        to zero), so a grown row reads as never pushed; its age is 0.
        Codebooks and their statistics are per layer and keep their
        values. The result owns every tensor, placed as this store's (a
        host store's tables in new pinned buffers), and this store is left
        as it was; `n_new <= 0` returns this store, as the reference's."""
        if n_new <= 0:
            return self
        self.sync()       # the host copies a pinned table on the host

        def splice(t, fill):
            n = t.shape[0]
            where = (dict(pin_memory=True) if t.device.type == "cpu"
                     and self.pinned else dict(device=t.device))
            out = torch.empty((n + n_new,) + tuple(t.shape[1:]),
                              dtype=t.dtype, **where)
            out[:n - 1].copy_(t[:n - 1])
            out[n - 1:n - 1 + n_new].fill_(fill)
            out[n - 1 + n_new:].copy_(t[n - 1:])
            return out

        def cloned(ts):
            return None if ts is None else [t.clone() for t in ts]

        return HistoryStore(
            tables=[splice(t, 0) for t in self.tables],
            age=splice(self.age, 0), history_dtype=self.history_dtype,
            scales=(None if self.scales is None
                    else [splice(t, 1.0) for t in self.scales]),
            codebooks=cloned(self.codebooks),
            cb_counts=cloned(self.cb_counts), cb_sums=cloned(self.cb_sums),
            storage=self.storage)

    @classmethod
    def from_histories(cls, hist: Histories) -> "HistoryStore":
        """A device store over the legacy tuple's own tensors (bf16 when
        its tables are, else f32), so pushes into the store land in them.
        The reference's `backend` argument has no counterpart."""
        hd = ("bf16" if hist.tables and hist.tables[0].dtype == torch.bfloat16
              else "f32")
        return cls(tables=list(hist.tables), age=hist.age, history_dtype=hd)

    def to_histories(self) -> Histories:
        if get_codec(self.history_dtype).scaled:
            raise ValueError(
                f"{self.history_dtype} HistoryStore cannot round-trip "
                "through the legacy Histories tuple (it has no "
                "scale/codebook tables)")
        return Histories(tables=list(self.tables), age=self.age)

    def clone(self) -> "HistoryStore":
        """A copy with its own tables, scales, codebooks, statistics and
        clock, placed as this store (a host store's tables in new pinned
        buffers). The reference's stores are immutable, so its `predict`
        scans over a copy for free; the port's pushes are in place, so
        `runtime.predict` runs on a clone."""
        return self.to(self.device)

    def to(self, device) -> "HistoryStore":
        """A copy on `device` (tables, scales, codebooks, statistics and
        clock) with this store's `storage`: a host store's tables land in
        pinned host memory when `device` is a card, in CPU memory
        otherwise."""
        self.sync()       # the host copies a pinned table on the host

        def move(ts):
            return None if ts is None else [t.to(device, copy=True)
                                             for t in ts]

        out = HistoryStore(
            tables=[], age=self.age.to(device, copy=True),
            history_dtype=self.history_dtype, codebooks=move(self.codebooks),
            cb_counts=move(self.cb_counts), cb_sums=move(self.cb_sums),
            storage=self.storage)
        out.tables = [out._placed(t, copy=True) for t in self.tables]
        if self.scales is not None:
            out.scales = [out._placed(t, copy=True) for t in self.scales]
        return out

    def bytes_per_table(self) -> List[int]:
        """Each layer's bytes: its table with its scale table, codebook
        and statistics."""
        out = [_nbytes([t]) for t in self.tables]
        for aux in (self.scales, self.codebooks, self.cb_counts,
                    self.cb_sums):
            if aux is not None:
                out = [b + _nbytes([a]) for b, a in zip(out, aux)]
        return out

    def bytes(self) -> int:
        """Table bytes, the scale tables, codebooks and their statistics
        included."""
        return sum(self.bytes_per_table())

    def placement_bytes(self) -> dict:
        """{"device": bytes on the store's device, "host": bytes in host
        memory}, the clock included: a host store keeps its tables and
        scale tables on the host and the clock, codebooks and statistics
        on the device; a device store keeps everything on the device."""
        tables = _nbytes(self.tables) + _nbytes(self.scales)
        rest = sum(_nbytes(ts) for ts in (
            [self.age], self.codebooks, self.cb_counts, self.cb_sums))
        if self.storage == "host":
            return {"device": rest, "host": tables}
        return {"device": rest + tables, "host": 0}

    def f32_bytes(self) -> int:
        """The bytes the same tables take at f32 (rows times the layers'
        feature widths times 4), the yardstick of the store's
        compression."""
        widths = [t.shape[1] if cb is None else cb.shape[0] * cb.shape[2]
                  for t, cb in zip(self.tables, self.codebooks or
                                   [None] * self.num_layers)]
        return sum(t.shape[0] * w * 4 for t, w in zip(self.tables, widths))


def _nbytes(ts) -> int:
    return 0 if ts is None else sum(t.numel() * t.element_size() for t in ts)


def _halo_hits(halo_nodes: torch.Tensor, halo_mask: torch.Tensor,
               batch_nodes: torch.Tensor, batch_mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hit [max_h] bool, row [max_h] int64): hit[j] where valid halo slot
    j names a node that a valid row of the batch holds, row[j] that row
    (any row where not hit). The batch's valid nodes are distinct; its
    masked rows take -1, which no node id equals."""
    b = torch.where(batch_mask, batch_nodes.long(),
                    torch.full_like(batch_nodes, -1, dtype=torch.long))
    sb, perm = torch.sort(b)
    h = halo_nodes.long()
    k = torch.searchsorted(sb, h).clamp_(max=sb.shape[0] - 1)
    return (sb[k] == h) & halo_mask, perm[k]
