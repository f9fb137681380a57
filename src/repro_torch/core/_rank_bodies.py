"""Rank bodies of the distributed-GAS parity runs: tasks for
`dist_gas.RankPool.run` / `run_ranks` that the tests and chip_smoke.py's
phase 8 run on every rank and compare with the reference, with a direct
gather or with the CPU. Module-level, so that spawned ranks import them.
Each returns picklable numpy, the task's launch counts and its `stats`
(both start from 0 at each task)."""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from . import dist_gas as DG

_TYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host; bf16 widens to f32, exactly."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def _shard(structs: DG.DistStructs, a: np.ndarray, rank: int, device,
           dtype=None) -> torch.Tensor:
    """Rank `rank`'s rows of a padded [P*rows, ...] array, on `device`."""
    rows = a[rank * structs.rows:(rank + 1) * structs.rows]
    return torch.from_numpy(np.ascontiguousarray(rows)).to(device, dtype)


def exchange_rank(rank: int, world_size: int, group, device,
                  structs: DG.DistStructs, tables: List[np.ndarray],
                  scales: List[Optional[np.ndarray]], dtypes: List[str]
                  ) -> Dict[str, Any]:
    """`halo_exchange` of each padded table ([P*rows, d] numpy; this
    rank's shard is sent, cast to `dtypes[i]`, "f32", "bf16" or "int8")
    with its scales where `scales[i]` is not None. Returns this rank's
    halos (bf16 widened) and the halos' scales (None where none were
    sent)."""
    plan = structs.exchange_arrays(rank, device)
    halos, hscales = [], []
    for t, sc, dt in zip(tables, scales, dtypes):
        loc = _shard(structs, t, rank, device, _TYPES[dt])
        s = None if sc is None else _shard(structs, sc, rank, device)
        got = DG.halo_exchange(loc, plan, structs.max_halo, group,
                               scales_loc=s)
        halos.append(_np(got if s is None else got[0]))
        hscales.append(None if s is None else _np(got[1]))
    return {"halos": halos, "scales": hscales,
            "launches": dict(_build.launch_counts), "stats": dict(DG.stats)}


def supersteps_rank(rank: int, world_size: int, group, device,
                    structs: DG.DistStructs, job: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """`job["steps"]` supersteps from fixed params, then, with `adamw`
    given, one more that clips the summed gradients (`clip`) and takes an
    AdamW step. `job` holds `spec` (GNNSpec kwargs), `params` (flat
    numpy, the reference's keys), `history_dtype`, optionally `tables` /
    `scales` (padded numpy, the initial store; zero otherwise), the
    padded `x`, `y` and `m`, `steps`, `adamw` (adamw_update kwargs and
    `clip`, or None) and `legacy` (run on the legacy list of tables).
    Returns per step this rank's loss, acc, logits, new tables and
    scales, the summed gradients before clipping (flat numpy) and the
    host seconds (to a device sync); with `adamw` the params after it."""
    from repro_torch.gnn.model import GNNSpec

    batch = structs.device_batch(rank, device)
    plan = structs.exchange_arrays(rank, device)
    spec = GNNSpec(**job["spec"])
    params = ckpt.params_from_numpy(job["params"], device=device)
    store = structs.init_store(spec.hist_dims(), job["history_dtype"],
                               rank=rank, device=device)
    if job.get("tables") is not None:
        store.tables = [_shard(structs, t, rank, device, s.dtype)
                        for t, s in zip(job["tables"], store.tables)]
    if job.get("scales") is not None:
        store.scales = [_shard(structs, s, rank, device)
                        for s in job["scales"]]
    if job.get("legacy"):
        store = list(store.tables)
    x, y, m = (_shard(structs, job[k], rank, device) for k in "xym")
    loss_fn = DG.make_dist_loss_fn(spec, structs, group)
    res = {k: [] for k in ("loss", "acc", "logits", "tables", "scales",
                           "grads", "seconds")}
    state = opt.adamw_init(params) if job.get("adamw") else None
    for step in range(job["steps"] + (state is not None)):
        t0 = time.perf_counter()
        loss, store, acc, logits, grads = DG.superstep(
            loss_fn, params, store, x, y, m, batch, plan, group)
        if step == job["steps"]:
            kw = dict(job["adamw"])
            clipped, _ = opt.clip_by_global_norm(opt.tree_leaves(grads),
                                                 kw.pop("clip"))
            opt.adamw_update(clipped, state, params, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        res["seconds"].append(time.perf_counter() - t0)
        res["loss"].append(float(loss.detach()))
        res["acc"].append(float(acc))
        res["logits"].append(_np(logits))
        legacy = isinstance(store, list)
        res["tables"].append([_np(t) for t in (
            store if legacy else store.tables)])
        res["scales"].append(None if legacy or store.scales is None
                             else [_np(s) for s in store.scales])
        res["grads"].append(ckpt._flatten("", grads))
    if state is not None:
        res["params"] = ckpt._flatten("", params)
    res["launches"] = dict(_build.launch_counts)
    res["stats"] = dict(DG.stats)
    return res


def mesh_rank(rank: int, world_size: int, group, device, shape, axes):
    """`launch.mesh.make_mesh` on every rank: the mesh's rank layout, its
    device count, this rank's coordinate, and a sum over each axis's
    group of the ranks on it (one all-reduce an axis)."""
    import torch.distributed as dist
    from ..launch import mesh as M
    mesh = M.make_mesh(shape, axes)
    sums = {}
    for ax in axes:
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=mesh.get_group(ax))
        sums[ax] = float(t)
    return {"mesh": mesh.mesh.tolist(), "n": M.mesh_num_devices(mesh),
            "coord": list(mesh.get_coordinate()), "sums": sums}
