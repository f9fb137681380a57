#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; each prints one line (or a few), and the script stops
with a non-zero exit at the first failure:

1. toolchain — torch/CUDA versions and the card's name and power limit;
   build the CUDA kernels from src/repro_torch/kernels/csrc (nvcc, one
   process per source, into build/torch_kernels/).
2. kernels — each of the four kernels of the serving path against its
   plain PyTorch version, on seeded inputs at the shapes the path gives
   it (the PubMed-shaped features, the history tables and the blocks of
   a real SLO=0 refresh batch), timed with CUDA events (warm-up, then the
   median of 25 launches) beside the plain version, one PyTorch library
   call where one computes the same function, and the card's bound.
3. serving — the PubMed-shaped graph (19,717 nodes, degree 4.5, 500
   features, 3 classes) and a 3-layer, 256-wide GCN with seeded random
   weights and a zero f32 history store; 16 requests x 128 queries at
   SLO=0, then the same 16 at SLO=None. Checks: halo_age_max <= slo,
   SLO=0 logits against the plain full-graph forward on the card, the
   SLO=None pass against SLO=0, a repeated request bit-identical, and
   every kernel's launch counter risen during the 32 requests.

Then it prints the kernels line (JSON), the card's name and power limit
(nvidia-smi), and as the last line {"ok": true, "device": {...}}. Without
a CUDA device, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import gas as G  # noqa: E402
from repro_torch.core import serve as S  # noqa: E402
from repro_torch.core.config import resolve_device  # noqa: E402
from repro_torch.core.history import HistoryStore  # noqa: E402
from repro_torch.data.graphs import citation_graph  # noqa: E402
from repro_torch.gnn import model  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.bcsr_spmm import bcsr_spmm  # noqa: E402
from repro_torch.kernels.fused import gather_plan, gather_spmm  # noqa: E402
from repro_torch.kernels.gather import gather_rows  # noqa: E402
from repro_torch.kernels.scatter import scatter_rows  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# f32 outside the tensor cores — the kernels' bound_ms uses these
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

N_NODES, AVG_DEGREE, N_FEATURES, N_CLASSES = 19717, 4.5, 500, 3
D_HIDDEN, N_LAYERS = 256, 3
N_REQUESTS, QUERY_SIZE, SEED = 16, 128, 0
# bcsr_spmm / gather_spmm against their plain versions, and serving
# against the full-graph forward: the same f32 sums taken in another order
RTOL, ATOL = 1e-4, 1e-4
TIMED_REPS = 25


def _phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn) -> float:
    """Median over TIMED_REPS calls of CUDA-event time, after warm-up.
    Each call is queued behind a ~1 ms device sleep, so the host has
    issued all of its launches before the start event fires and the
    interval holds device time only, not the host's launch gaps."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(n_bytes: float, flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _row(name, source, replaces, err, ms, plain_ms, library_ms, n_bytes,
         flops):
    bound_ms, bound_by = _bound(n_bytes, flops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "max_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def kernel_phase(g, spec, device):
    """Phase 2. Returns the kernel rows (launches filled in later)."""
    N = g.num_nodes
    kplan = S.build_serve_plan(g, spec, S.ServeConfig(staleness_slo=0),
                               device=device)
    rng = np.random.default_rng(SEED)
    q0 = rng.choice(N, size=QUERY_SIZE, replace=False)
    refresh, _ = S.stale_closure(kplan, np.ones(N + 1, np.int32), q0, 0)
    bucket = S._bucket_for(kplan.refresh_buckets, len(refresh))
    batch = S.build_request_batch(kplan, refresh, bucket)
    vals, cols = batch.forward.vals, batch.forward.cols
    R, K = cols.shape
    _phase("kernels", f"refresh batch of {len(refresh)} nodes, bucket "
           f"{bucket}, max_h {batch.max_h}, blocks [{R}, {K}, 128, 128]")
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = []

    # gather_rows: the feature pull of the refresh batch
    idx = torch.clamp(batch.batch_nodes, 0, N - 1).to(torch.int32)
    table = kplan.x
    out = gather_rows(table, idx)
    want = ref.gather_rows_ref(table, idx)
    assert torch.equal(out, want), "gather_rows differs from its plain version"
    M, D = idx.shape[0], table.shape[1]
    # bytes this run's data needs: each distinct source row read once
    # (the padding indices all clamp to row N-1), every output row written
    n_src = int(torch.unique(idx).numel())
    rows.append(_row(
        "gather_rows", "src/repro_torch/kernels/csrc/gather.cu",
        "src/repro/kernels/gather.py:37", 0.0,
        _time_ms(lambda: gather_rows(table, idx)),
        _time_ms(lambda: ref.gather_rows_ref(table, idx)),
        _time_ms(lambda: torch.index_select(table, 0, idx)),
        M * 4 + n_src * D * 4 + M * D * 4, 0))

    # scatter_rows: the push into a [N+1, 256] table — first a check with
    # duplicate valid indices and masked rows, then timings on the real
    # push of the refresh batch (padding rows land on the sentinel row)
    hist = torch.randn((N + 1, D_HIDDEN), generator=gen, device=device)
    vals_p = torch.randn((M, D_HIDDEN), generator=gen, device=device)
    dup = torch.clamp(batch.batch_nodes, 0, N - 1).to(torch.int32).clone()
    dup[1::7] = dup[0:-1:7]                  # duplicates of earlier rows
    dup[5::11] = N                           # masked rows -> sentinel
    a = scatter_rows(hist.clone(), dup, vals_p)
    b = ref.scatter_rows_ref(hist.clone(), dup, vals_p)
    assert torch.equal(a[:N], b[:N]), "scatter_rows differs (duplicates)"
    push_idx = torch.where(batch.batch_mask, batch.batch_nodes,
                           torch.full_like(batch.batch_nodes, N)
                           ).to(torch.int32)
    a = scatter_rows(hist.clone(), push_idx, vals_p)
    b = ref.scatter_rows_ref(hist.clone(), push_idx, vals_p)
    assert torch.equal(a[:N], b[:N]), "scatter_rows differs (push)"
    valid = batch.batch_mask
    uniq_idx, uniq_vals = push_idx[valid].long(), vals_p[valid]
    tgt = hist.clone()
    # bytes this run's data needs: the index, and one row read and one
    # written per distinct target (the padding rows all land on the
    # sentinel row, one target); the kernel's winner scratch is its own
    # cost, not the function's
    n_tgt = int(torch.unique(push_idx).numel())
    rows.append(_row(
        "scatter_rows", "src/repro_torch/kernels/csrc/scatter.cu",
        "src/repro/kernels/scatter.py:39", 0.0,
        _time_ms(lambda: scatter_rows(tgt, push_idx, vals_p)),
        _time_ms(lambda: ref.scatter_rows_ref(tgt, push_idx, vals_p)),
        _time_ms(lambda: tgt.index_copy_(0, uniq_idx, uniq_vals)),
        M * 4 + 2 * n_tgt * D_HIDDEN * 4, 0))

    # bcsr_spmm: the layer-0 aggregation over [x_b ; x_halo ; 0]
    xb = ops.pull_rows(kplan.x, batch.batch_nodes) * batch.batch_mask[:, None]
    xh = ops.pull_rows(kplan.x, batch.halo_nodes) * batch.halo_mask[:, None]
    x_all = torch.cat([xb, xh, torch.zeros_like(xb[:1])], 0)
    out = bcsr_spmm(x_all, vals, cols)
    want = ref.bcsr_spmm_ref(x_all, vals, cols)
    torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    err = float((out - want).abs().max())
    # the library yardstick: cuSPARSE CSR x dense over the blocks' nonzeros
    nz = vals.nonzero(as_tuple=True)
    ridx = nz[0] * 128 + nz[2]
    cidx = cols[nz[0], nz[1]].long() * 128 + nz[3]
    n_cols = -(-x_all.shape[0] // 128) * 128
    a_csr = torch.sparse_coo_tensor(
        torch.stack([ridx, cidx]), vals[nz], (R * 128, n_cols)
    ).coalesce().to_sparse_csr()
    x_pad = torch.cat([x_all, x_all.new_zeros(n_cols - x_all.shape[0],
                                              x_all.shape[1])], 0)
    torch.testing.assert_close(torch.sparse.mm(a_csr, x_pad), want,
                               rtol=RTOL, atol=ATOL)
    _phase("kernels", f"blocks hold {a_csr._nnz()} nonzeros in "
           f"{vals.numel()} stored values")
    # every bound counts the blocks as the reference stores them (all
    # R*K*128*128 values, padding blocks included), the source rows the
    # blocks' columns reach, each once, and the output written once
    blk_bytes = vals.numel() * 4 + cols.numel() * 4
    n_x = sum(min(128, x_all.shape[0] - c * 128)
              for c in torch.unique(cols).tolist())
    rows.append(_row(
        "bcsr_spmm", "src/repro_torch/kernels/csrc/bcsr_spmm.cu",
        "src/repro/kernels/bcsr_spmm.py:42", err,
        _time_ms(lambda: bcsr_spmm(x_all, vals, cols)),
        _time_ms(lambda: ref.bcsr_spmm_ref(x_all, vals, cols)),
        _time_ms(lambda: torch.sparse.mm(a_csr, x_pad)),
        blk_bytes + n_x * x_all.shape[1] * 4 + R * 128 * x_all.shape[1] * 4,
        2.0 * R * K * 128 * 128 * x_all.shape[1]))

    # gather_spmm: the layer-1 aggregation, halo rows out of the table
    x_in = torch.randn((bucket, D_HIDDEN), generator=gen, device=device)
    sel, xrow, trow = gather_plan(
        cols, batch.halo_nodes, batch.halo_mask, bucket, N + 1)
    out = gather_spmm(x_in, hist, vals, cols, sel, xrow, trow)
    want = ref.gather_spmm_ref(x_in, hist, vals, cols, sel, xrow, trow)
    torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    err = float((out - want).abs().max())
    n_xrows = int(torch.unique(xrow[sel == 0]).numel())
    n_trows = int(torch.unique(trow[sel == 1]).numel())
    rows.append(_row(
        "gather_spmm", "src/repro_torch/kernels/csrc/fused.cu",
        "src/repro/kernels/fused.py:203 (f32 body _make_kernel :172)", err,
        _time_ms(lambda: gather_spmm(
            x_in, hist, vals, cols, sel, xrow, trow)),
        _time_ms(lambda: ref.gather_spmm_ref(
            x_in, hist, vals, cols, sel, xrow, trow)),
        None,
        blk_bytes + 3 * sel.numel() * 4 + (n_xrows + n_trows) * D_HIDDEN * 4
        + R * 128 * D_HIDDEN * 4,
        2.0 * R * K * 128 * 128 * D_HIDDEN))
    for r in rows:
        _phase("kernels", f"{r['name']}: err {r['max_abs_err']:.3g}, "
               f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
               f"{r['library_ms']}, bound {r['bound_ms']:.4f} by "
               f"{r['bound_by']})")
    del batch, x_all, xb, xh
    return rows, kplan


def serving_phase(g, spec, device, kplan):
    """Phase 3. Returns the launch counts of the 32 requests."""
    N = g.num_nodes
    params = model.init_gnn(spec, seed=SEED, device=device)

    def fresh_state(plan):
        store = HistoryStore.create(N + 1, spec.hist_dims(), device=device)
        return S.init_serve_state(plan, S.ServeState(params, store))

    rng = np.random.default_rng(SEED + 1)
    queries = [rng.choice(N, size=QUERY_SIZE, replace=False)
               for _ in range(N_REQUESTS)]
    # warm-up on a throwaway store (library load, cuBLAS handles)
    S.serve_request(kplan, fresh_state(kplan), queries[0])

    plan0 = S.build_serve_plan(g, spec, S.ServeConfig(staleness_slo=0),
                               device=device)
    plan_none = dataclasses.replace(
        plan0, config=S.ServeConfig(staleness_slo=None))
    state = fresh_state(plan0)
    results = {}
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for slo, plan in ((0, plan0), (None, plan_none)):
        # host_ms: host time spent cutting request batches and tiling
        # their blocks (numpy), from the request diagnostics; the rest of
        # a request is the upload, the device work and the orchestration
        lat, logits, refreshed, host_ms = [], [], [], 0.0
        for q in queries:
            t0 = time.perf_counter()
            lg, state, d = S.serve_request(plan, state, q)
            lat.append((time.perf_counter() - t0) * 1e3)
            assert lg.shape == (QUERY_SIZE, N_CLASSES), lg.shape
            assert np.isfinite(lg).all(), "non-finite logits"
            if slo is not None:
                assert d["halo_age_max"] <= slo, (d, slo)
            assert d["host_build_ms"] > 0, d
            logits.append(lg)
            refreshed.append(int(d["refreshed"]))
            host_ms += d["host_build_ms"]
        results[slo] = (lat, logits, refreshed, host_ms)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels never launched while serving: {missing}"

    for slo, (lat, _, refreshed, host_ms) in results.items():
        _phase("serving", f"slo={slo}: {N_REQUESTS} x {QUERY_SIZE} queries, "
               f"p50 {np.percentile(lat, 50):.3f} ms, "
               f"p99 {np.percentile(lat, 99):.3f} ms, total {sum(lat):.1f} "
               f"ms of which host batch build {host_ms:.1f} ms; refreshed "
               f"rows {refreshed} (total {sum(refreshed)})")

    # SLO=0 against the plain full-graph forward on the card
    dst, src, w = G.gcn_edge_weights(g)
    exact = model.full_forward(
        params, spec, plan0.x,
        (torch.from_numpy(dst).to(device), torch.from_numpy(src).to(device)),
        torch.from_numpy(w).to(device), N).cpu().numpy()
    err0 = max(float(np.abs(lg - exact[q]).max())
               for q, lg in zip(queries, results[0][1]))
    for q, lg in zip(queries, results[0][1]):
        np.testing.assert_allclose(lg, exact[q], rtol=RTOL, atol=ATOL)
    # the warm cache holds the rows SLO=0 proved exact
    err_none = max(float(np.abs(a - b).max())
                   for a, b in zip(results[None][1], results[0][1]))
    for a, b in zip(results[None][1], results[0][1]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    # a repeated request reads the same cached rows: bit-identical
    rep1 = S.serve_request(plan_none, state, queries[0])[0]
    rep2 = S.serve_request(plan_none, state, queries[0])[0]
    assert np.array_equal(rep1, rep2), "warm-cache repeat differs"
    _phase("serving", f"SLO=0 vs full forward max abs err {err0:.3g}; "
           f"SLO=None vs SLO=0 {err_none:.3g}; repeat bit-identical; "
           f"launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    smi = _smi()
    _phase("toolchain", f"python {sys.version.split()[0]}, torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.device_count()} device(s); nvidia-smi: {smi}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _phase("build", f"{lib_path.relative_to(ROOT)} in "
           f"{time.perf_counter() - t0:.1f} s")
    log = (lib_path.parent / "build.log").read_text().splitlines()
    for line in log:
        if "Compiling entry" in line or "registers" in line:
            print("  " + line.strip())

    device = resolve_device("cuda")
    with torch.no_grad():
        t0 = time.perf_counter()
        g = citation_graph(num_nodes=N_NODES, avg_degree=AVG_DEGREE,
                           num_features=N_FEATURES, num_classes=N_CLASSES,
                           seed=SEED)
        spec = model.GNNSpec(op="gcn", d_in=N_FEATURES, d_hidden=D_HIDDEN,
                             num_classes=N_CLASSES, num_layers=N_LAYERS)
        _phase("setup", f"graph {g.num_nodes} nodes, {g.num_edges} edges, "
               f"{N_FEATURES} features in {time.perf_counter() - t0:.1f} s")
        rows, kplan = kernel_phase(g, spec, device)
        launches = serving_phase(g, spec, device, kplan)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
