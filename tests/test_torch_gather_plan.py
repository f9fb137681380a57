"""PyTorch port, the history pull's launch plan (`kernels/gather.py`
`row_plan`, `dq_plan`, `vq_plan`), replayed in numpy on the CPU: no
kernel runs.

The replay follows `csrc/gather.cu` (`lane_row`, `lane_col` and the two
kernels' unit loops): warp w of the plan's grid takes rows w << (5 -
shift) onwards, 2**shift lanes a row, and lane `col` of a row moves its
units col, col + 2**shift, ... For the f32 and bf16 copy and the int8
dequant, at every row width and row count of the card test
(`tests/test_torch_cuda.py::test_row_pulls_match_plain`), with aligned
buffers and with the table or the output offset by one element: every
output unit is written exactly once, from the same unit of row idx[row]
(and so every element: the unit divides the row); the unit divides the
row and the buffers' alignment (16-byte aligned float4 stores for the
dequant); the lanes a row takes cover it without a power of two to
spare; and the grid is no larger than its rows need, with the CTA size
the kernel source states. For the vq decode (float4 units, the halves
of decoded subvectors) at S = 1 to 63 codes a row, indices outside
[0, N) among them: the replayed kernel's output, each float4 the
codebook half of the code its lane read from row clip(idx[row]) times
that row's scale, is bitwise the plain version's, every float4 written
once. The card test holds the kernels' bytes."""
import re
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

from repro_torch.kernels import gather as G
from repro_torch.kernels import ref

CSRC = Path(G.__file__).with_name("csrc") / "gather.cu"
ROW_D = (1, 3, 4, 6, 8, 16, 20, 64, 125, 130, 256, 500)
ROW_M = (1, 7, 8, 9, 4096)
N_TABLE = 301
ELEM = {"f32": 4, "bf16": 2, "int8": 1}
OUT_ELEM = {"f32": 4, "bf16": 2, "int8": 4}


def _replay(plan, m, idx):
    """(row, col, t) for every lane that works: lane `col` of the 2**shift
    on output row `row` moves the units col, col + 2**shift, ... of
    source row t (the row's index, loaded by the lane itself)."""
    warp = np.arange(plan.ctas * G.WARPS_PER_CTA)[:, None]
    lane = np.arange(32)[None, :]
    row = (warp << (5 - plan.shift)) + (lane >> plan.shift)
    col = np.broadcast_to(lane & ((1 << plan.shift) - 1), row.shape)
    ok = row < m
    return row[ok], col[ok], idx[row[ok]]


def _kernel_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         CSRC.read_text()).group(1))


def test_plan_constants_are_the_kernels():
    assert _kernel_constant("kThreads") == 32 * G.WARPS_PER_CTA


@pytest.mark.parametrize("t_off,o_off", [(0, 0), (1, 0), (0, 1)],
                         ids=["aligned", "table+1", "out+1"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_replayed_plan_writes_every_unit_once(kind, t_off, o_off):
    """`t_off` / `o_off`: the table / output offset by that many elements
    from a 512-byte aligned allocation."""
    rng = np.random.default_rng(7)
    e, oe = ELEM[kind], OUT_ELEM[kind]
    t_addr, o_addr = (1 << 20) + t_off * e, (2 << 20) + o_off * oe
    for d in ROW_D:
        for m in ROW_M:
            idx = rng.integers(0, N_TABLE, m).astype(np.int32)
            idx[0] = N_TABLE - 1                  # the last row
            idx[-1] = idx[m // 2]                 # a duplicate
            if kind == "int8":
                plan = G.dq_plan(m, d, t_addr, o_addr)
                row_bytes = d
                if plan.unit > 1:
                    assert o_addr % 16 == 0 and (4 * d) % 16 == 0
            else:
                row_bytes = d * e
                plan = G.row_plan(m, row_bytes, t_addr | o_addr)
                assert plan.unit >= e
                assert o_addr % plan.unit == 0
            case = (kind, d, m, t_off, o_off, plan)
            assert row_bytes % plan.unit == 0, case
            assert t_addr % plan.unit == 0, case
            assert plan.unroll in (1, 2, 4) and 0 <= plan.shift <= 5
            nu = row_bytes // plan.unit
            p = 1 << plan.shift
            # the lanes of a row cover it, none of 32 idle by choice
            assert p >= min(32, nu) and (p == 1 or p < 2 * nu), case
            # the grid covers the rows (the launcher refuses less) with
            # less than one CTA to spare
            assert (plan.ctas * G.WARPS_PER_CTA) << (5 - plan.shift) >= m
            assert ((plan.ctas - 1) * G.WARPS_PER_CTA) << (
                5 - plan.shift) < m, case
            # each row gets each of its lanes once, from idx[row], and
            # the lanes' units tile the row: every unit written once
            row, col, t = _replay(plan, m, idx)
            turns = np.bincount(row * p + col, minlength=m * p)
            assert (turns == 1).all(), case
            assert (t == idx[row]).all(), case
            units = np.concatenate([np.arange(c, nu, p) for c in range(p)])
            assert (np.bincount(units, minlength=nu) == 1).all(), case


VQ_S = (1, 2, 3, 4, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63)


@pytest.mark.parametrize("m", ROW_M)
def test_replayed_vq_plan_decodes_every_float4_once(m):
    """The decode's plan replayed as csrc/gather.cu's gather_rows_vq_kernel
    runs it: lane `col` of row `row` takes units col, col + 2**shift, ...
    of the 2*S, clips idx[row], reads the unit's code (byte u // 2 of
    the row) and the codebook's float4 half u % 2 of that entry, and
    multiplies by the row's scale."""
    rng = np.random.default_rng(m)
    for s_n in VQ_S:
        codes = rng.integers(0, 256, (N_TABLE, s_n)).astype(np.uint8)
        cb = rng.normal(size=(s_n, 256, 8)).astype(np.float32)
        scales = rng.random(N_TABLE).astype(np.float32)
        idx = rng.integers(-5, N_TABLE + 5, m).astype(np.int32)
        idx[:min(m, 4)] = (-7, N_TABLE, N_TABLE + 3, N_TABLE - 1)[:m]
        plan = G.vq_plan(m, s_n)
        case = (s_n, m, plan)
        nu, p = 2 * s_n, 1 << plan.shift
        assert plan.unit == 16 and plan.unroll in (1, 2, 4), case
        assert p >= min(32, nu) and (p == 1 or p < 2 * nu), case
        assert ((plan.ctas - 1) * G.WARPS_PER_CTA) << (5 - plan.shift) < m
        row, col, t = _replay(plan, m, idx)
        t = np.clip(t, 0, N_TABLE - 1)
        cb4 = cb.reshape(-1, 4)
        # every lane's units, one pass of the loop a column
        u = col[:, None] + p * np.arange(-(-nu // p))[None, :]
        ok = u < nu
        r, u, tt = (np.broadcast_to(a, u.shape)[ok]
                    for a in (row[:, None], u, t[:, None]))
        turns = np.bincount(r * nu + u, minlength=m * nu)
        assert (turns == 1).all(), case
        entry = (u // 2) * 256 + codes[tt, u // 2]
        out = np.full((m, nu, 4), np.nan, np.float32)
        out[r, u] = cb4[entry * 2 + u % 2] * scales[tt][:, None]
        want = ref.gather_rows_vq_ref(torch.from_numpy(codes),
                                      torch.from_numpy(cb),
                                      torch.from_numpy(scales),
                                      torch.from_numpy(idx))
        assert np.array_equal(out.reshape(m, -1).view(np.uint32),
                              want.numpy().view(np.uint32)), case


def test_plans_of_the_main_path():
    """The plans chip_smoke.py's phase 2 times: the serving refresh
    batch's feature pull (4,096 rows of D = 500 f32) is 512 CTAs, a warp
    a row, 4 units of 16 bytes a lane; GAT's hidden-layer pulls (274
    rows, d = 64) share warps: 2 int8 or vq rows (16 lanes of 4 codes or
    of a float4 half-subvector) or 4 bf16 rows a warp; the int8 pull at
    d = 256 is a warp a row, 2 units of 4 codes a lane, and so is the vq
    pull at S = 32."""
    assert G.row_plan(4096, 2000, 0) == G.RowPlan(16, 5, 4, 512)
    assert G.dq_plan(274, 64, 0, 0) == G.RowPlan(4, 4, 1, 18)
    assert G.row_plan(274, 128, 0) == G.RowPlan(16, 3, 1, 9)
    assert G.dq_plan(4096, 256, 0, 0) == G.RowPlan(4, 5, 2, 512)
    # a misaligned output leaves the dequant one code a unit
    assert G.dq_plan(4096, 256, 0, 4).unit == 1
    # the vq decode: GAT's pull (S = 8, 16 float4 units) 2 rows a warp,
    # 18 CTAs; the refresh batch's (S = 32) a warp a row, 2 units a lane
    assert G.vq_plan(274, 8) == G.RowPlan(16, 4, 1, 18)
    assert G.vq_plan(4096, 32) == G.RowPlan(16, 5, 2, 512)
