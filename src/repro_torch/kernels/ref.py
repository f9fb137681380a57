"""Plain PyTorch versions of the port's seventeen CUDA kernels.

Each function computes what its kernel computes, on the same arguments, in
plain tensor code: the kernel wrappers (`gather.py`, `scatter.py`,
`bcsr_spmm.py`, `fused.py`, `edge_softmax.py`, `pna_reduce.py`,
`decode_attn.py`) run them
when handed CPU tensors, the tests hold them against the JAX package's
Pallas kernels, and `chip_smoke.py` holds each kernel against them on
the card. They repeat the kernels' arithmetic and are no yardstick of
speed.

`row_scales`, `quantize_rows` and `dequantize_rows` are the symmetric
per-row int8 codec of `repro.core.history` (`:217-245`), and
`relative_row_error` the per-row term of its quantization error (`:366`):
the one definition the int8 store, the quantizing push's plain version and
`core.history.quantization_error` share; the CUDA kernels mirror them
op for op (`csrc/scatter.cu`, `csrc/gather.cu`, `csrc/fused.cu`).
`vq_row_scales`, `vq_encode_rows` and `vq_decode_rows` are the product
quantizer of `repro.core.history` (`:258-309`) the same way: one code per
8-wide subvector, the nearest (L2) entry of a per-layer codebook to the
row divided by its `max|v|`, the distances summed left to right over the
subvector and the first minimum taken, which is the order in which XLA's
sum over the last axis adds them.

`edge_softmax_coo` and `pna_reduce_coo` are not kernels' plain versions:
they are the per-edge (segment) routes of the reference's "jnp" backend,
which `full_forward` and `evaluate_exact` run in plain tensor code, as
the reference's `evaluate_exact` does on every backend, and so does the
distributed superstep (`core.dist_gas`), as the reference's does. Every
per-destination sum of those routes goes through `segment_sum`, the
reference's `jax.ops.segment_sum`: the same bits on every run, on the
card too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def row_scales(values: torch.Tensor) -> torch.Tensor:
    """Symmetric per-row scale `s_i = max|v_i| / 127` (1.0 for all-zero
    rows, so the dequant stays finite), in f32: a max is exact in any
    order, and the one division rounds as the reference's does. The
    divisor is a tensor: PyTorch's CUDA division multiplies by the
    reciprocal of a Python-number divisor, which rounds otherwise."""
    amax = torch.amax(torch.abs(values.to(torch.float32)), dim=-1)
    return torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                       torch.ones_like(amax))


def quantize_rows(values: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """values [M, d] -> (q int8 [M, d], scales f32 [M]): `q_i =
    clip(round(v_i / s_i), -127, 127)`, rounding half to even (as
    `jnp.round`); the division is a division, never a multiply by the
    reciprocal, as in the reference. Per-element error <= s_i / 2."""
    v = values.to(torch.float32)
    scales = row_scales(v)
    q = torch.clamp(torch.round(v / scales[:, None]), -127, 127)
    return q.to(torch.int8), scales


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(q int8 [M, d], scales f32 [M]) -> f32 [M, d], one multiply per
    element."""
    return q.to(torch.float32) * scales[:, None]


def relative_row_error(values: torch.Tensor,
                       back: torch.Tensor) -> torch.Tensor:
    """Per-row relative L2 error `||v - back|| / (||v|| + 1e-12)` in f32:
    the per-row term of `core.history.quantization_error`."""
    v = values.to(torch.float32)
    num = torch.sqrt(torch.sum(torch.square(v - back), dim=-1))
    den = torch.sqrt(torch.sum(torch.square(v), dim=-1)) + 1e-12
    return num / den


def vq_row_scales(values: torch.Tensor) -> torch.Tensor:
    """Per-row normalizer `s_i = max|v_i|` (1.0 for all-zero rows) in f32,
    not divided by anything: the codebook entries live in [-1, 1]^ds."""
    amax = torch.amax(torch.abs(values.to(torch.float32)), dim=-1)
    return torch.where(amax > 0, amax, torch.ones_like(amax))


# distances per chunk of rows in `vq_nearest` (64 MiB of f32), so that a
# refresh batch's push does not build its [M, S, C] distances at once
_VQ_CHUNK = 1 << 24


def vq_nearest(u: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """u [M, S, ds] normalized subvectors -> uint8 [M, S], per subvector
    the index of the nearest entry of `codebook` [S, C, ds]: the squared
    distance summed left to right over the ds components, each term one
    rounded subtract and multiply, and the first minimum (as XLA's
    `jnp.sum(jnp.square(u - cb), -1)` and `jnp.argmin`)."""
    m, s_, ds = u.shape
    c = codebook.shape[1]
    out = torch.empty((m, s_), dtype=torch.uint8, device=u.device)
    step = max(1, _VQ_CHUNK // max(s_ * c, 1))
    for i in range(0, m, step):
        uc = u[i:i + step]
        d2 = None
        for j in range(ds):
            diff = uc[:, :, None, j] - codebook[None, :, :, j]
            sq = diff * diff
            d2 = sq if d2 is None else d2 + sq
        out[i:i + step] = torch.argmin(d2, dim=-1).to(torch.uint8)
    return out


def vq_encode_rows(values: torch.Tensor, codebook: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """values [M, S*ds] -> (codes uint8 [M, S], scales f32 [M]): the
    nearest entry to each subvector of `v_i / s_i`, s = `vq_row_scales`;
    the divisor is a tensor (see `row_scales`)."""
    v = values.to(torch.float32)
    scales = vq_row_scales(v)
    s_, _, ds = codebook.shape
    u = (v / scales[:, None]).reshape(v.shape[0], s_, ds)
    return vq_nearest(u, codebook), scales


def vq_decode_rows(codes: torch.Tensor, codebook: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """(codes uint8 [M, S], codebook [S, C, ds], scales f32 [M]) -> f32
    [M, S*ds]: each element one codebook element times the row's scale,
    one multiply."""
    s_, _, ds = codebook.shape
    sub = torch.arange(s_, device=codes.device)[None, :]
    rec = codebook[sub, codes.long()]
    return rec.reshape(codes.shape[0], s_ * ds) * \
        scales[:, None].to(torch.float32)


def _clipped(idx: torch.Tensor, n: int) -> torch.Tensor:
    """A pull's row indices clipped to [0, n - 1], as its kernel clips
    them (and the reference's `pull_rows`, with `jnp.clip`)."""
    return idx.long().clamp(0, n - 1)


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[clip(idx[i], 0, N-1)] (f32 or bf16 rows, in the
    table's type)."""
    return table[_clipped(idx, table.shape[0])]


def gather_rows_raw_ref(table: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[clip(idx[i], 0, N-1)], the raw storage bits of a
    row of any type (a 1-d table's rows are single elements): the plain
    version of `gather_rows_raw`, the epoch pipeline's prefetch."""
    return table[_clipped(idx, table.shape[0])]


def gather_rows_dq_ref(table: torch.Tensor, scales: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """The dequantizing pull: out[i] = float(q[t]) * scales[t] in f32, t =
    clip(idx[i], 0, N-1), bitwise `dequantize_rows` of the gathered
    rows."""
    i = _clipped(idx, table.shape[0])
    return dequantize_rows(table[i], scales[i])


def gather_rows_vq_ref(table: torch.Tensor, codebook: torch.Tensor,
                       scales: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    """The decoding pull of a vq table: out[i] = decode(table[t]) *
    scales[t] in f32 [M, S*ds], t = clip(idx[i], 0, N-1), bitwise
    `vq_decode_rows` of the gathered code rows."""
    i = _clipped(idx, table.shape[0])
    return vq_decode_rows(table[i], codebook, scales[i])


def _last_writer(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The positions that write under last-writer-wins: per target row in
    [0, n) the largest position naming it; out-of-range rows never
    write."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    ok = (idx >= 0) & (idx < n)
    tgt = torch.where(ok, idx, torch.full_like(idx, n))
    last = torch.full((n + 1,), -1, dtype=torch.long, device=idx.device)
    last.scatter_reduce_(0, tgt, pos, reduce="amax")
    return ok & (last[tgt] == pos)


def scatter_rows_ref(table: torch.Tensor, idx: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """In place: table[idx[i]] = values[i]; returns `table`.

    Rows whose index lies outside [0, N) are dropped. Duplicate indices
    resolve to the LAST occurrence in row order (the reference's
    sequential-grid semantics): a first pass takes, per target row, the
    largest position that names it, and only that position writes. A
    bf16 table takes the values rounded to bf16 (nearest, ties to even,
    as XLA's convert)."""
    idx = idx.long()
    win = _last_writer(idx, table.shape[0])
    table[idx[win]] = values[win].to(table.dtype)
    return table


def scatter_rows_raw_ref(table: torch.Tensor, idx: torch.Tensor,
                         rows: torch.Tensor) -> torch.Tensor:
    """In place: table[idx[i]] = rows[i], the raw storage bits of rows of
    any type (a 1-d table's rows are single elements), never converted:
    `rows` has the table's type. Rows whose index lies outside [0, N) are
    dropped; duplicates resolve to the last occurrence. The plain version
    of `scatter_rows_raw`, the serving backend's push of encoded rows.
    Returns `table`."""
    if rows.dtype != table.dtype:
        raise TypeError(f"scatter_rows_raw: rows are {rows.dtype}, the "
                        f"table {table.dtype}")
    idx = idx.long()
    win = _last_writer(idx, table.shape[0])
    table[idx[win]] = rows[win]
    return table


def scatter_rows_q_ref(table: torch.Tensor, scales: torch.Tensor,
                       idx: torch.Tensor, values: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The quantizing push, in place: for each pushed f32 row i, s_i =
    `row_scales(values)_i` and q_i = `quantize_rows(values)_i`; table
    [N, D] int8 takes q_i and scales [N] f32 takes s_i at row idx[i].
    Rows outside [0, N) are dropped; duplicates resolve to the last
    occurrence for the code row and its scale alike (one owner per
    target row). Returns (table, scales, err), err [M] the relative error
    of every pushed row, dropped rows included."""
    idx = idx.long()
    win = _last_writer(idx, table.shape[0])
    q, s = quantize_rows(values)
    table[idx[win]] = q[win]
    scales[idx[win]] = s[win]
    return table, scales, relative_row_error(values, dequantize_rows(q, s))


def scatter_rows_vq_ref(table: torch.Tensor, scales: torch.Tensor,
                        idx: torch.Tensor, values: torch.Tensor,
                        codebook: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
    """The encoding push of a vq table, in place: for each pushed f32 row
    i, (codes_i, s_i) = `vq_encode_rows(values)_i`; table [N, S] uint8
    takes codes_i and scales [N] f32 takes s_i at row idx[i]. Rows outside
    [0, N) are dropped; duplicates resolve to the last occurrence for the
    code row and its scale alike. Returns (table, scales, codes, err):
    codes [M, S] uint8 every pushed row's codes and err [M] its relative
    error (dropped rows included), what the codebook statistics and
    `hist_quant_err` read."""
    idx = idx.long()
    win = _last_writer(idx, table.shape[0])
    codes, s = vq_encode_rows(values, codebook)
    table[idx[win]] = codes[win]
    scales[idx[win]] = s[win]
    err = relative_row_error(values, vq_decode_rows(codes, codebook, s))
    return table, scales, codes, err


def _gather_blocks(rows: torch.Tensor, blk_cols: torch.Tensor,
                   bn: int) -> torch.Tensor:
    """[n, D] rows -> [R, K, bn, D]: the bn-row block at each column block
    id, rows past n reading as zeros."""
    n, D = rows.shape
    nb = -(-n // bn)        # named: view cannot infer -1 when D = 0
    xb = F.pad(rows, (0, 0, 0, nb * bn - n)).view(nb, bn, D)
    return xb[blk_cols.long()]


def bcsr_spmm_ref(x: torch.Tensor, blk_vals: torch.Tensor,
                  blk_cols: torch.Tensor) -> torch.Tensor:
    """out[r*bn:(r+1)*bn] = sum_k blk_vals[r, k] @ x[blk_cols[r, k]*bn : +bn]
    in f32. x [n_x, D]: rows past n_x read as zeros. Returns [R*bn, D]."""
    R, K, bn, _ = blk_vals.shape
    g = _gather_blocks(x.to(torch.float32), blk_cols, bn)
    out = torch.einsum("rkab,rkbd->rad", blk_vals, g)
    return out.reshape(R * bn, x.shape[1])


def gather_spmm_ref(x_in: torch.Tensor, table: torch.Tensor,
                    blk_vals: torch.Tensor, blk_cols: torch.Tensor,
                    sel: torch.Tensor, xrow: torch.Tensor,
                    trow: torch.Tensor,
                    scales: Optional[torch.Tensor] = None,
                    codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused history-gather aggregation, routed by the gather plan
    (`fused.gather_plan`): row b of block (r, k) is x_in[xrow] where
    sel == 0, the table row trow where sel == 1 and zeros where sel == 2;
    the staged [R, K, bn, D] operand is contracted with the blocks.
    Table rows are f32, bf16 (upcast exactly) or, with `scales` [N] f32,
    int8 codes dequantized as `dequantize_rows` does (one multiply), or,
    with `codebook` [S, C, ds] too, uint8 vq code rows [N, S] decoded as
    `vq_decode_rows` does (D = S*ds). Returns
    [R*bn, D] f32 (the reference's `ref.gather_spmm_ref` builds the same
    operand as x_all = [x_in ; dequant(table)[halo] * mask ; 0]
    instead)."""
    R, K, bn, _ = blk_vals.shape
    D = x_in.shape[1]
    xs = x_in[xrow.long()]                          # [R, K, bn, D]
    t = trow.long()
    if codebook is not None:
        ts = vq_decode_rows(table[t].reshape(-1, table.shape[1]), codebook,
                            scales[t].reshape(-1)).reshape(R, K, bn, D)
    else:
        ts = table[t].to(torch.float32)
        if scales is not None:
            ts = ts * scales[t][..., None]
    s = sel[..., None]
    g = torch.where(s == 0, xs, torch.where(s == 1, ts, torch.zeros_like(ts)))
    out = torch.einsum("rkab,rkbd->rad", blk_vals, g)
    return out.reshape(R * bn, D)


# ---------------------------------------------------------------------------
# Edge softmax (GAT): the three kernels of csrc/edge_softmax.cu
# ---------------------------------------------------------------------------
#
# Layouts are the port's, node-major (the reference's kernels take head-
# major [H, rows] operands padded to whole blocks and 128 lanes; the port's
# take the op's own layouts): ad [n_out, H] destination logit halves,
# as_ [M, H] source halves, wx [M, H, F] values, g [n_out, H, F] the
# output cotangent, M/L/delta [n_out, H]. Blocks are the unit-weight
# (multiplicity) families: ublk_vals [R, K, 128, 128] over destinations x
# sources with R*128 >= n_out, ublk_vals_t [R_t, K_t, 128, 128] over
# sources x destinations with R_t*128 >= M.

NEG = -1e30     # the reference kernels' score mask and row-max floor
TINY = 1e-30    # their normalizer floor


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    return F.pad(t, (0,) * (2 * t.dim() - 2) + (0, rows - t.shape[0]))


def _block_scores(a_rows: torch.Tensor, b_cols: torch.Tensor,
                  mult: torch.Tensor, neg_slope: float):
    """z [R, K, bn_a, bn_b, H] = a_rows[r, a] + b_cols[r, k, b] and the
    masked leaky-ReLU scores s (NEG where mult == 0)."""
    z = a_rows[:, None, :, None, :] + b_cols[:, :, None, :, :]
    s = torch.where(z > 0, z, neg_slope * z)
    s = torch.where(mult[..., None] > 0, s, torch.full_like(s, NEG))
    return z, s


def _softmax_weights(ad, as_, ublk_vals, blk_cols, M_, L_, neg_slope):
    """Recompute alpha and alpha' = alpha * lrelu'(z) over the forward
    blocks, [R, K, bn, bn, H]."""
    R, K, bn, _ = ublk_vals.shape
    adb = _pad_rows(ad, R * bn).view(R, bn, -1)
    asb = _gather_blocks(as_, blk_cols, bn)                 # [R, K, bn, H]
    z, s = _block_scores(adb, asb, ublk_vals, neg_slope)
    Mb = _pad_rows(M_, R * bn).view(R, 1, bn, 1, -1)
    Lb = _pad_rows(L_, R * bn).view(R, 1, bn, 1, -1)
    p = ublk_vals[..., None] * torch.exp(s - Mb)
    alpha = p / torch.clamp(Lb, min=TINY)
    slope = torch.where(z > 0, torch.ones_like(z),
                        torch.full_like(z, neg_slope))
    return alpha, alpha * slope


def edge_softmax_fwd_ref(ad: torch.Tensor, as_: torch.Tensor,
                         wx: torch.Tensor, ublk_vals: torch.Tensor,
                         blk_cols: torch.Tensor, neg_slope: float = 0.2):
    """out[i, h] = sum_j softmax_j(leaky_relu(ad[i, h] + as_[j, h])) wx[j, h]
    over the multiplicity blocks, each duplicate edge its own term.
    Returns (out [n_out, H, F], M [n_out, H] the row max of the masked
    scores (NEG for a row without edges), L [n_out, H] the normalizer).
    Rows without edges come out exactly 0."""
    n_out, H = ad.shape
    R, K, bn, _ = ublk_vals.shape
    Fd = wx.shape[2]
    adb = _pad_rows(ad, R * bn).view(R, bn, H)
    asb = _gather_blocks(as_, blk_cols, bn)                 # [R, K, bn, H]
    _, s = _block_scores(adb, asb, ublk_vals, neg_slope)
    M_ = torch.clamp(s.amax(dim=(1, 3)), min=NEG)           # [R, bn, H]
    p = ublk_vals[..., None] * torch.exp(s - M_[:, None, :, None, :])
    L_ = p.sum(dim=(1, 3))                                  # [R, bn, H]
    wxb = _gather_blocks(wx.reshape(wx.shape[0], H * Fd), blk_cols, bn)
    wxb = wxb.view(R, K, bn, H, Fd)
    acc = torch.einsum("rkabh,rkbhf->rahf", p, wxb)
    out = acc / torch.clamp(L_, min=TINY)[..., None]
    return (out.reshape(R * bn, H, Fd)[:n_out],
            M_.reshape(R * bn, H)[:n_out], L_.reshape(R * bn, H)[:n_out])


def edge_softmax_bwd_row_ref(ad, as_, wx, g, M_, L_, delta, ublk_vals,
                             blk_cols, neg_slope: float = 0.2
                             ) -> torch.Tensor:
    """dad [n_out, H] = sum_j alpha'_ij (g_i . wx_j) - delta_i sum_j
    alpha'_ij over the forward blocks, alpha recomputed from (ad, as_, M,
    L); delta = sum_f g * out."""
    n_out, H = ad.shape
    R, K, bn, _ = ublk_vals.shape
    Fd = wx.shape[2]
    _, ap = _softmax_weights(ad, as_, ublk_vals, blk_cols, M_, L_,
                             neg_slope)
    wxb = _gather_blocks(wx.reshape(wx.shape[0], H * Fd), blk_cols, bn)
    wxb = wxb.view(R, K, bn, H, Fd)
    gb = _pad_rows(g, R * bn).view(R, bn, H, Fd)
    gv = torch.einsum("rahf,rkbhf->rkabh", gb, wxb)
    dad = (ap * gv).sum(dim=(1, 3)) - \
        _pad_rows(delta, R * bn).view(R, bn, H) * ap.sum(dim=(1, 3))
    return dad.reshape(R * bn, H)[:n_out]


def edge_softmax_bwd_col_ref(ad, as_, wx, g, M_, L_, delta, ublk_vals_t,
                             blk_cols_t, neg_slope: float = 0.2):
    """Over the transposed blocks (sources x destinations): dwx [M, H, F]
    = sum_i alpha_ij g_i and das [M, H] = sum_i alpha'_ij (g_i . wx_j -
    delta_i). Each source row has one owner block row, so there is no
    reduction across block rows."""
    n_src, H, Fd = wx.shape
    R_t, K_t, bn, _ = ublk_vals_t.shape
    asb = _pad_rows(as_, R_t * bn).view(R_t, bn, H)
    adb = _gather_blocks(ad, blk_cols_t, bn)                 # [R_t, K_t, bn, H]
    z, s = _block_scores(asb, adb, ublk_vals_t, neg_slope)
    Mb = _gather_blocks(M_, blk_cols_t, bn)[:, :, None]      # dst-side stats
    Lb = _gather_blocks(L_, blk_cols_t, bn)[:, :, None]
    db = _gather_blocks(delta, blk_cols_t, bn)[:, :, None]
    p = ublk_vals_t[..., None] * torch.exp(s - Mb)
    alpha = p / torch.clamp(Lb, min=TINY)
    ap = alpha * torch.where(z > 0, torch.ones_like(z),
                             torch.full_like(z, neg_slope))
    gb = _gather_blocks(g.reshape(g.shape[0], H * Fd), blk_cols_t, bn)
    gb = gb.view(R_t, K_t, bn, H, Fd)
    dwx = torch.einsum("rkjah,rkahf->rjhf", alpha, gb)
    wxb = _pad_rows(wx, R_t * bn).view(R_t, bn, H, Fd)
    gv = torch.einsum("rjhf,rkahf->rkjah", wxb, gb)
    das = (ap * gv).sum(dim=(1, 3)) - (ap * db).sum(dim=(1, 3))
    return (dwx.reshape(R_t * bn, H, Fd)[:n_src],
            das.reshape(R_t * bn, H)[:n_src])


def segment_sum(dst: torch.Tensor, msg: torch.Tensor, n: int) -> torch.Tensor:
    """out [n, ...] = per destination the sum of the rows of `msg` whose
    `dst` names it (zeros where none does); `dst` int64 [E] in [0, n),
    `msg` [E, ...]. Differentiable w.r.t. `msg` (its gradient is a
    gather). On the CPU it is `index_add`, which adds each destination's
    rows in edge order. On the card `index_add` adds with atomics in an
    order that changes from run to run; `index_put_` with
    accumulate=True sorts the edges by destination (a stable radix sort)
    and reduces each destination's run, so the sum has the same bits on
    every run."""
    out = msg.new_zeros((n,) + tuple(msg.shape[1:]))
    if msg.device.type == "cpu":
        return out.index_add(0, dst, msg)
    return out.index_put((dst,), msg, accumulate=True)


def edge_softmax_coo(wx: torch.Tensor, ad: torch.Tensor, as_: torch.Tensor,
                     edges, edge_w: torch.Tensor, n_out: int,
                     neg_slope: float = 0.2) -> torch.Tensor:
    """The per-edge (segment) edge softmax of the reference's "jnp" route
    (`repro.kernels.ops.edge_softmax_aggregate` with ublocks=None), over
    the padded COO: weight-0 edges are masked with the f32 cap
    finfo.min / 2, destination n_out is the trash row. The row max is
    detached; the softmax does not depend on it, so the gradient is the
    same."""
    dst, src = edges[0].long(), edges[1].long()
    e = ad[dst] + as_[src]
    e = torch.where(e > 0, e, neg_slope * e)
    neg = torch.finfo(e.dtype).min / 2
    valid = (edge_w > 0)[:, None]
    e = torch.where(valid, e, torch.full_like(e, neg))
    H = e.shape[1]
    emax = torch.full((n_out + 1, H), neg, dtype=e.dtype, device=e.device)
    emax = emax.scatter_reduce(0, dst[:, None].expand(-1, H), e.detach(),
                               reduce="amax", include_self=False)[:n_out]
    emax = torch.clamp(emax, neg, -neg)
    emax = F.pad(emax, (0, 0, 0, 1))                        # trash row
    ee = torch.exp(e - emax[dst])
    ee = torch.where(valid, ee, torch.zeros_like(ee))
    denom = segment_sum(dst, ee, n_out + 1)[:n_out]
    msg = ee[:, :, None] * wx[src]
    out = segment_sum(dst, msg, n_out + 1)[:n_out]
    tiny = torch.finfo(denom.dtype).tiny
    return out / torch.clamp(denom, min=tiny)[:, :, None]


# ---------------------------------------------------------------------------
# PNA's multi-aggregator reduction: the three kernels of csrc/pna_reduce.cu
# ---------------------------------------------------------------------------
#
# msg = relu(xd[dst] + xs[src]) per edge, reduced per destination and
# feature into (sum, min, max, count) weighted by the edge multiplicities
# of the unit-weight blocks, with the multiplicity-weighted tie counts at
# the min and max that the backward passes split the min/max cotangents
# by. Layouts are unpadded and node-major: xd [n_dst, F] (the destination
# rows), xs [n_src, F]; ublk_vals [R, K, 128, 128] over destinations x
# sources with R*128 >= n_dst, ublk_vals_t [R_t, K_t, 128, 128] over
# sources x destinations with R_t*128 >= n_src. Rows past n_dst / n_src
# read as zeros (the reference pads with zeros).

BIG = 1e30      # the reference kernels' min/max sentinel


def _pna_rows(xd, xs, blk_cols, bn):
    """xd as [R, bn, F] block rows and xs gathered per block [R, K, bn, F]."""
    R = blk_cols.shape[0]
    return _pad_rows(xd, R * bn).view(R, bn, -1), \
        _gather_blocks(xs, blk_cols, bn)


def pna_reduce_fwd_ref(xd: torch.Tensor, xs: torch.Tensor,
                       ublk_vals: torch.Tensor, blk_cols: torch.Tensor):
    """(s, mn, mx, cnt, cmin, cmax) over the forward multiplicity blocks:
    s/mn/mx/cmin/cmax [n_dst, F] f32, cnt [n_dst] f32; mn and mx are 0 on
    rows without edges. One K step at a time, as the reference's grid
    walks K: a strictly better block value resets a tie count, an equal
    one adds its multiplicity (`pna_reduce.py:68-84`), so the counts are
    the multiplicity sums of the entries equal to the final min and max.
    Masked entries are left out, never multiplied."""
    n_dst, Fd = xd.shape
    R, K, bn, _ = ublk_vals.shape
    xdb, xsb = _pna_rows(xd, xs, blk_cols, bn)
    shape = (R, bn, Fd)
    s = xd.new_zeros(shape)
    cnt = xd.new_zeros((R, bn, 1))
    mn, mx = xd.new_full(shape, BIG), xd.new_full(shape, -BIG)
    cmin, cmax = xd.new_zeros(shape), xd.new_zeros(shape)
    for k in range(K):
        m = ublk_vals[:, k, :, :, None]                     # [R, a, b, 1]
        v = m > 0
        msg = torch.relu(xdb[:, :, None, :] + xsb[:, k, None, :, :])
        s = s + torch.where(v, m * msg, 0.0).sum(2)
        cnt = cnt + m.sum(2)
        for acc, cacc, fill, pick in ((mn, cmin, BIG, torch.minimum),
                                      (mx, cmax, -BIG, torch.maximum)):
            blk = torch.where(v, msg, fill)
            new = pick(acc, blk.amin(2) if fill > 0 else blk.amax(2))
            here = torch.where(v & (msg == new[:, :, None]), m, 0.0).sum(2)
            cacc.copy_(torch.where(acc == new, cacc, 0.0) + here)
            acc.copy_(new)
    has = cnt > 0
    mn = torch.where(has, mn, 0.0)
    mx = torch.where(has, mx, 0.0)
    flat = lambda t: t.reshape(R * bn, -1)[:n_dst]  # noqa: E731
    return (flat(s), flat(mn), flat(mx), flat(cnt)[:, 0], flat(cmin),
            flat(cmax))


def _pna_dmsg(z, m, gs, gmn_c, gmx_c, mn, mx):
    """The even-split cotangent of one message block (`pna_reduce.py:156-
    165`): relu'(z) * m * (gs + [msg == mn] gmn / max(cmin, 1) + [msg ==
    mx] gmx / max(cmax, 1)) on the valid entries, 0 elsewhere. The stats
    broadcast against z; gmn_c and gmx_c are the divided cotangents."""
    msg = torch.relu(z)
    v = m > 0
    grad = gs + torch.where(msg == mn, gmn_c, 0.0) + \
        torch.where(msg == mx, gmx_c, 0.0)
    return torch.where(v & (z > 0), m * grad, 0.0)


def _split_cotangents(gmn, gmx, cmin, cmax):
    """gmn / max(cmin, 1) and gmx / max(cmax, 1): each tie's share."""
    return gmn / torch.clamp(cmin, min=1.0), gmx / torch.clamp(cmax, min=1.0)


def pna_reduce_bwd_row_ref(xd, xs, gs, gmn, gmx, mn, mx, cmin, cmax,
                           ublk_vals, blk_cols) -> torch.Tensor:
    """dxd [n_dst, F] = sum over the sources of each destination of the
    even-split message cotangent, messages recomputed over the forward
    blocks; gs/gmn/gmx are the (s, mn, mx) cotangents and mn/mx/cmin/cmax
    the forward's saved stats, all [n_dst, F]."""
    n_dst, Fd = xd.shape
    R, K, bn, _ = ublk_vals.shape
    xdb, xsb = _pna_rows(xd, xs, blk_cols, bn)
    gmn_c, gmx_c = _split_cotangents(gmn, gmx, cmin, cmax)
    rows = [_pad_rows(t, R * bn).view(R, bn, 1, Fd)
            for t in (gs, gmn_c, gmx_c, mn, mx)]
    dxd = xd.new_zeros((R, bn, Fd))
    for k in range(K):
        z = xdb[:, :, None, :] + xsb[:, k, None, :, :]      # [R, a, b, F]
        dxd = dxd + _pna_dmsg(z, ublk_vals[:, k, :, :, None], *rows).sum(2)
    return dxd.reshape(R * bn, Fd)[:n_dst]


def pna_reduce_bwd_col_ref(xd, xs, gs, gmn, gmx, mn, mx, cmin, cmax,
                           ublk_vals_t, blk_cols_t) -> torch.Tensor:
    """dxs [n_src, F] = sum over the destinations of each source of the
    even-split message cotangent, over the transposed blocks (rows are
    sources): the destination-side stats are fetched through the
    transposed column ids, so each source row has one owner block row."""
    n_src, Fd = xs.shape
    R_t, K_t, bn, _ = ublk_vals_t.shape
    xsb, xdb = _pna_rows(xs, xd, blk_cols_t, bn)
    gmn_c, gmx_c = _split_cotangents(gmn, gmx, cmin, cmax)
    cols = [_gather_blocks(t, blk_cols_t, bn)
            for t in (gs, gmn_c, gmx_c, mn, mx)]            # [R_t, K_t, a, F]
    dxs = xs.new_zeros((R_t, bn, Fd))
    for k in range(K_t):
        z = xsb[:, :, None, :] + xdb[:, k, None, :, :]      # [R_t, j, a, F]
        dxs = dxs + _pna_dmsg(z, ublk_vals_t[:, k, :, :, None],
                              *(c[:, k, None] for c in cols)).sum(2)
    return dxs.reshape(R_t * bn, Fd)[:n_src]


def pna_reduce_coo(xd: torch.Tensor, xs: torch.Tensor, edges,
                   edge_w: torch.Tensor, n_out: int):
    """The segment reduction of the reference's "jnp" route
    (`repro.kernels.ops.pna_reduce` with ublocks=None, `ops.py:534-548`)
    over the padded COO: (s, mn, mx, cnt) = sum / min / max / count of
    relu(xd[dst] + xs[src]) over the valid (weight > 0) edges, min and
    max 0 on rows without one; destination n_out is the trash row.
    Differentiable w.r.t. xd and xs: the min and max split their
    cotangents evenly across the tied edges, as `jax.ops.segment_min` /
    `segment_max` do (each tie gets g / ties). Not a kernel's plain
    version: `full_forward`, `evaluate_exact` and the distributed
    superstep (`core.dist_gas`) run it, as the reference's do on every
    backend."""
    dst, src = edges[0].long(), edges[1].long()
    valid = (edge_w > 0)[:, None]
    pre = torch.relu(xd[dst] + xs[src])
    n1, Fd = n_out + 1, pre.shape[1]
    big = torch.finfo(pre.dtype).max / 2        # the reference's -neg_cap
    idx = dst[:, None].expand(-1, Fd)
    cnt = segment_sum(dst, valid[:, 0].to(pre.dtype), n1)
    s = segment_sum(dst, torch.where(valid, pre, 0.0), n1)[:n_out]
    has = (cnt[:n_out] > 0)[:, None]
    out = [s]
    for fill, reduce in ((big, "amin"), (-big, "amax")):
        v = torch.where(valid, pre, fill).detach()
        ext = pre.new_full((n1, Fd), fill).scatter_reduce(
            0, idx, v, reduce=reduce, include_self=True)
        # the value is the detached extreme; its gradient reaches each
        # tied edge as g / ties through a term that adds exact zeros
        tie = valid & (v == ext[dst])
        ties = segment_sum(dst, tie.to(pre.dtype), n1)
        share = torch.where(tie, (pre - v) / torch.clamp(ties[dst], min=1.0),
                            0.0)
        ext = ext + segment_sum(dst, share, n1)
        out.append(torch.where(has, ext[:n_out], 0.0))
    return out[0], out[1], out[2], cnt[:n_out]


def flash_decode_valid(pos: int, seq_len: int) -> int:
    """The number of leading cache slots one decode step attends to: slots
    past `pos` are masked unless `pos >= seq_len` (a rolling buffer whose
    every slot holds a live position)."""
    if pos < 0:
        raise ValueError(f"flash_decode: pos must be >= 0, got {pos}")
    return seq_len if pos >= seq_len else pos + 1


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: int, scale: Optional[float] = None
                     ) -> torch.Tensor:
    """GQA single-token attention over a KV cache, as the Pallas
    `flash_decode` computes it: q [B, Kh, G, Dh], k / v [B, S, Kh, Dh]
    (f32 or bf16), `pos` the decode position. Scores in f32 (exact
    products of the inputs) times `scale` (default Dh^-0.5) after the
    dot; slots past `pos` masked to -1e30 unless `pos >= S`; p =
    exp(s - max) rounded to v's type before `p @ v`, the normalizer summed
    from the unrounded p; out = acc / max(l, 1e-30) in q's type."""
    S, Dh = k.shape[1], q.shape[-1]
    scale = Dh ** -0.5 if scale is None else scale
    s = torch.einsum("bhgd,bshd->bhgs", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    valid = torch.arange(S, device=q.device) < flash_decode_valid(pos, S)
    s = torch.where(valid, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
