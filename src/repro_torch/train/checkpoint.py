"""Reading the reference's checkpoints (numpy only).

`repro.train.checkpoint.save_gas_state` writes one flat npz whose keys are
the path strings of the flattened `GASState`:

    state/params/layers/{i}/w, state/params/layers/{i}/b
    state/histories/tables/{l}       [N+1, d] f32
    state/histories/age              [N+1] int32
    state/opt/..., state/rng         (training only; serving ignores them)
    step, and meta_json when the writer passed `meta`

`load_gas_state_npz` reads such a file into the port's params dict and an
f32 `HistoryStore`; `params_from_numpy` maps a flattened param tree given
as numpy arrays into the params dict. Saving from the port, and
optimizer state, come with the training slice (ROADMAP Queue A).
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.config import resolve_device
from repro_torch.core.history import HistoryStore

_PARAM_KEY = re.compile(r"^layers/(\d+)/(w|b)$")


def params_from_numpy(flat: Mapping[str, np.ndarray],
                      device=None) -> Dict[str, Any]:
    """{"layers/0/w": array, "layers/0/b": array, ...} (keys as the
    reference flattens its param tree; a "params/" or "state/params/"
    prefix is accepted) -> {"layers": [{"w": tensor, "b": tensor}, ...]}
    on `device` (None means "cuda")."""
    dev = resolve_device(device)
    layers: Dict[int, Dict[str, torch.Tensor]] = {}
    for key, arr in flat.items():
        name = key.split("params/", 1)[-1]
        m = _PARAM_KEY.match(name)
        if m is None:
            raise KeyError(f"unsupported param key {key!r} (the port "
                           "holds GCN params: layers/{i}/w and /b)")
        layers.setdefault(int(m.group(1)), {})[m.group(2)] = \
            torch.from_numpy(np.array(arr, np.float32)).to(dev)
    if sorted(layers) != list(range(len(layers))):
        raise KeyError(f"layer indices {sorted(layers)} are not 0..L-1")
    return {"layers": [layers[i] for i in range(len(layers))]}


def load_gas_state_npz(path: str, device=None
                       ) -> Tuple[Dict[str, Any], HistoryStore, int]:
    """Read a `.npz` written by the reference's `save_gas_state`. Returns
    (params, f32 `HistoryStore`, step) on `device` (None means "cuda")."""
    dev = resolve_device(device)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    # bf16 tables are widened to f32 on disk, so the writer's meta and the
    # scale tables are what tell a quantized store apart
    meta = json.loads(str(flat["meta_json"])) if "meta_json" in flat else {}
    hd = meta.get("args", {}).get("history_dtype")
    if hd not in (None, "f32") or any(
            k.startswith("state/histories/scales/") for k in flat):
        raise NotImplementedError(
            f"{path} holds a quantized ({hd}) history store; the port reads "
            "f32 stores only (ROADMAP Queue A, quantized histories)")
    params = params_from_numpy(
        {k: v for k, v in flat.items() if k.startswith("state/params/")},
        device=dev)
    n_tables = sum(1 for k in flat if k.startswith("state/histories/tables/"))
    tables = []
    for ell in range(n_tables):
        t = np.ascontiguousarray(flat[f"state/histories/tables/{ell}"],
                                 np.float32)
        tables.append(torch.from_numpy(t).to(dev))
    age = torch.from_numpy(
        flat["state/histories/age"].astype(np.int32)).to(dev)
    store = HistoryStore(tables=tables, age=age, history_dtype="f32")
    return params, store, int(flat["step"])


def load_gas_meta(path: str) -> Optional[dict]:
    """The `meta` dict a checkpoint was written with, or None."""
    with np.load(path) as data:
        if "meta_json" not in data.files:
            return None
        return json.loads(str(data["meta_json"]))
