"""Checkpoints in the reference's npz layout (numpy only).

`repro.train.checkpoint.save_gas_state` writes one flat npz whose keys are
the path strings of the flattened `GASState`:

    state/params/layers/{i}/{w,b}            (GCN)
    state/params/layers/{i}/{w,a_src,a_dst}  (GAT)
    state/params/layers/{i}/{w1,b1,w2,b2,eps}  (GIN; eps is 0-d)
    state/params/layers/{i}/w                (GCNII)
    state/params/layers/{i}/{w1,b1,w2,b2}    (PNA)
    state/params/w_in/{w,b}                  (GCNII's input projection)
    state/params/mlp/{w1,b1,w2,b2}           (APPNP's MLP; no layers)
    state/params/head/{w,b}                  (GIN's, GCNII's, PNA's readout)
    state/opt_state/step                     () int32
    state/opt_state/{m,v}/layers/{i}/...     the AdamW moments
    state/histories/tables/{l}               [N+1, d] f32, int8 codes,
                                             or bf16 widened to f32
    state/histories/age                      [N+1] int32
    state/histories/scales/{l}               [N+1] f32 (int8 and vq stores)
    state/histories/codebooks/{l}            [S, 256, 8] f32 (vq stores)
    state/histories/cb_counts/{l}            [S, 256] f32 (vq stores)
    state/histories/cb_sums/{l}              [S, 256, 8] f32 (vq stores)
    state/rng                                [2] uint32 key data
    step, and meta_json when the writer passed `meta`

`load_gas_state_npz` reads such a file into the port's params dict and a
`HistoryStore` of the precision it holds (what serving needs);
`load_gas_state` reads the whole training state, optimizer included;
`save_gas_state` writes the port's state in the same layout, so the
reference's `load_gas_state` reads it. A vq store (uint8 code tables
[N+1, d/8]) is told apart by its codebooks, an int8 store by its int8
tables and scale tables; a bf16 store only by the writer's meta
(`args.history_dtype`) or the caller's `history_dtype`, since npz cannot
hold bf16 and both packages widen it to f32 (exactly) on disk. The file
does not say where the tables lived: the reader's `history_storage`
places them (argument, $REPRO_HISTORY_STORAGE, "device"), and a host
store restored on the card is pinned again, its bits unchanged.
`params_from_numpy` maps a flattened param tree given as numpy arrays
into the params dict.

`save_checkpoint` / `load_checkpoint` are the reference's generic pair:
any tree of dicts, lists and NamedTuples (params, an `AdamWState`) as
`params/<path>`, `opt/<path>` and `step`, read back by structural match
against a template; files cross-read with the reference's bitwise.

`transformer_params_from_numpy` and `transformer_cache_from_numpy` carry
the transformer's params tree (`repro.models.transformer.init_params`)
and its decode cache `{"pos", "segs"}`, given as nested dicts and lists
of numpy arrays, into the port's (`repro_torch.models.transformer`). The
walk is generic, so every layer type's leaves cross in their own types:
`rg`, `moe`, the cross gates `g_attn` / `g_mlp` (f32 scalars per layer),
`pos_embed`, and the rec caches' f32 `h` beside their activation-dtype
`conv`.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.config import resolve_device
from repro_torch.core.history import (HistoryStore, get_codec,
                                      resolve_history_storage)

_LEAF = r"(w|b|a_src|a_dst|w1|b1|w2|b2|eps)"
# a layer's leaf, or a leaf of a dict beside the layer list (each op's)
_PARAM_KEY = re.compile(
    rf"(?:^|/)(?:layers/(\d+)/{_LEAF}|(head|w_in|mlp)/{_LEAF})$")


def params_from_numpy(flat: Mapping[str, np.ndarray],
                      device=None) -> Dict[str, Any]:
    """{"layers/0/w": array, "layers/0/b": array, ...} (keys as the
    reference flattens its param tree; a prefix ending in "params/" or
    "state/opt_state/m/" etc. is accepted) -> {"layers": [{"w": tensor,
    "b": tensor}, ...]} on `device` (None means "cuda"), with a "head",
    "w_in" or "mlp" dict where the keys hold one. GCN layers hold w and
    b, GAT layers w, a_src and a_dst, GIN layers w1, b1, w2, b2 and a 0-d
    eps, GCNII layers w beside w_in/{w,b}, PNA layers w1, b1, w2 and b2;
    GIN, GCNII and PNA have a head/{w,b}, and APPNP has no layers but an
    mlp/{w1,b1,w2,b2}."""
    dev = resolve_device(device)
    layers: Dict[int, Dict[str, torch.Tensor]] = {}
    side: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, arr in flat.items():
        m = _PARAM_KEY.search(key)
        if m is None:
            raise KeyError(f"unsupported param key {key!r} (the port "
                           "holds layers/{i}/ w, b, a_src, a_dst, w1, b1, "
                           "w2, b2 and eps, and head/, w_in/ and mlp/ "
                           "dicts of those)")
        t = torch.from_numpy(np.array(arr, np.float32)).to(dev)
        if m.group(3) is not None:
            side.setdefault(m.group(3), {})[m.group(4)] = t
        else:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = t
    if sorted(layers) != list(range(len(layers))):
        raise KeyError(f"layer indices {sorted(layers)} are not 0..L-1")
    out: Dict[str, Any] = {"layers": [layers[i] for i in range(len(layers))]}
    out.update(side)
    return out


_VQ_AUX = ("codebooks", "cb_counts", "cb_sums")


def _store_dtype(flat: Mapping[str, np.ndarray],
                 history_dtype: Optional[str]) -> str:
    """The precision of the store in a flat checkpoint: the caller's, else
    the writer's meta, else vq where codebooks are present, int8 where
    scale tables are, else f32; raises where the arrays contradict it."""
    meta = json.loads(str(flat["meta_json"])) if "meta_json" in flat else {}
    scaled = any(k.startswith("state/histories/scales/") for k in flat)
    vq = any(k.startswith("state/histories/codebooks/") for k in flat)
    hd = history_dtype or meta.get("args", {}).get("history_dtype") or (
        "vq" if vq else "int8" if scaled else "f32")
    codec = get_codec(hd)
    for what, has, needs in (("scale tables", scaled, codec.scaled),
                             ("codebooks", vq, codec.vq)):
        if has != needs:
            raise ValueError(f"checkpoint {'has' if has else 'lacks'} "
                             f"{what}, which a {hd} store "
                             f"{'lacks' if has else 'needs'}")
    return hd


def load_gas_state_npz(path: str, device=None,
                       history_dtype: Optional[str] = None,
                       history_storage: Optional[str] = None
                       ) -> Tuple[Dict[str, Any], HistoryStore, int]:
    """Read a `.npz` written by either package's `save_gas_state`. Returns
    (params, `HistoryStore`, step) on `device` (None means "cuda"). The
    store's precision is `history_dtype`, else the one the writer's meta
    names, else vq where the file has codebooks, int8 where it has scale
    tables, else f32 (a bf16 store written without meta must be named
    here). The store is placed as `history_storage` resolves
    (`HistoryStore.place`)."""
    dev = resolve_device(device)
    st = resolve_history_storage(history_storage)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    hd = _store_dtype(flat, history_dtype)
    storage = get_codec(hd).storage
    params = params_from_numpy(
        {k: v for k, v in flat.items() if k.startswith("state/params/")},
        device=dev)
    n_tables = sum(1 for k in flat if k.startswith("state/histories/tables/"))
    codec = get_codec(hd)

    def leaf(key: str, dtype=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(flat[key], dtype)).to(dev)

    tables, scales = [], []
    aux = {name: [] for name in _VQ_AUX}
    for ell in range(n_tables):
        t = torch.from_numpy(np.ascontiguousarray(
            flat[f"state/histories/tables/{ell}"]))
        if storage in (torch.int8, torch.uint8) and t.dtype != storage:
            raise ValueError(f"a {hd} store's table {ell} holds {t.dtype}")
        tables.append(t.to(storage))
        if codec.scaled:
            scales.append(torch.from_numpy(np.ascontiguousarray(
                flat[f"state/histories/scales/{ell}"], np.float32)))
        if codec.vq:
            for name in _VQ_AUX:
                aux[name].append(leaf(f"state/histories/{name}/{ell}",
                                      np.float32))
    age = torch.from_numpy(
        flat["state/histories/age"].astype(np.int32)).to(dev)
    store = HistoryStore(tables=tables, age=age, history_dtype=hd,
                         scales=scales or None, storage=st,
                         **{k: v or None for k, v in aux.items()})
    return params, store.place(), int(flat["step"])


def load_gas_meta(path: str) -> Optional[dict]:
    """The `meta` dict a checkpoint was written with, or None."""
    with np.load(path) as data:
        if "meta_json" not in data.files:
            return None
        return json.loads(str(data["meta_json"]))


def _flatten(prefix: str, tree) -> Dict[str, np.ndarray]:
    """The leaves of a tree of dicts, lists and NamedTuples (an
    `AdamWState`) as {prefix + path: array}, the path the reference's
    `_flatten` writes (dict keys, list indices and field names joined by
    "/"); bf16 leaves widen to f32, as the reference writes them (npz
    cannot hold bf16)."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        t = torch.as_tensor(tree).detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return {prefix.rstrip("/"): t.cpu().numpy()}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(_flatten(f"{prefix}{k}/", v))
    return out


def _restore_tree(template, flat: Mapping[str, np.ndarray], prefix: str):
    """A tree shaped like `template` with each leaf read from
    `flat[prefix + path]`, on the template leaf's device in its dtype (a
    bf16 leaf narrows back from the f32 on disk, exactly)."""
    if isinstance(template, Mapping):
        return {k: _restore_tree(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if hasattr(template, "_fields"):
        return type(template)(*(_restore_tree(v, flat, f"{prefix}{k}/")
                                for k, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        return [_restore_tree(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(template)]
    key = prefix.rstrip("/")
    arr = flat[key]
    if arr.shape != tuple(template.shape):
        raise ValueError(f"{key}: shape {arr.shape} on disk, "
                         f"{tuple(template.shape)} in the template")
    return _tensor_from_numpy(arr, template.device).to(template.dtype)


def save_checkpoint(path: str, params, opt_state=None, step: int = 0
                    ) -> None:
    """Write a params tree (and an optimizer state) as one flat npz in the
    reference's layout: `params/<path>`, `opt/<path>` and `step`, which
    `repro.train.checkpoint.load_checkpoint` reads."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = _flatten("params/", params)
    if opt_state is not None:
        arrays.update(_flatten("opt/", opt_state))
    arrays["step"] = np.asarray(step)
    np.savez(path, **arrays)


def load_checkpoint(path: str, params_template, opt_template=None
                    ) -> Tuple[Any, Optional[Any], int]:
    """Read a file either package's `save_checkpoint` wrote, by structural
    match against `params_template` (and `opt_template`): returns
    (params, opt_state or None, step), each leaf on its template leaf's
    device in its dtype."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    params = _restore_tree(params_template, flat, "params/")
    opt = _restore_tree(opt_template, flat, "opt/") \
        if opt_template is not None else None
    return params, opt, int(flat["step"])


def save_gas_state(path: str, state, step: int = 0,
                   meta: Optional[dict] = None) -> None:
    """Write a `core.runtime.GASState` (params, AdamW state, history
    tables, scale tables, vq codebooks and statistics, and clock, rng key
    data) as one flat npz in
    the reference's layout, which `repro.train.checkpoint.load_gas_state`
    restores (bf16 tables widened to f32, as the reference writes
    them)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = _flatten("state/params/", state.params)
    arrays.update(_flatten("state/opt_state/", state.opt_state))
    store = state.histories.sync()      # a pinned table is read on the host
    for ell, t in enumerate(store.tables):
        if t.dtype == torch.bfloat16:   # npz cannot hold bf16
            t = t.to(torch.float32)
        arrays[f"state/histories/tables/{ell}"] = t.cpu().numpy()
    for ell, sc in enumerate(store.scales or []):
        arrays[f"state/histories/scales/{ell}"] = sc.cpu().numpy()
    for name in _VQ_AUX:
        for ell, a in enumerate(getattr(store, name) or []):
            arrays[f"state/histories/{name}/{ell}"] = a.cpu().numpy()
    arrays["state/histories/age"] = state.histories.age.cpu().numpy()
    arrays["state/rng"] = np.asarray(state.rng, np.uint32)
    arrays["step"] = np.asarray(step)
    if meta is not None:
        arrays["meta_json"] = np.asarray(json.dumps(meta))
    np.savez(path, **arrays)


def load_gas_state(path: str, device=None,
                   history_dtype: Optional[str] = None,
                   history_storage: Optional[str] = None):
    """Read a whole training state written by either package's
    `save_gas_state`: returns (`core.runtime.GASState`, step) on `device`
    (None means "cuda"); `history_dtype` and `history_storage` as in
    `load_gas_state_npz`."""
    from repro_torch.core.runtime import GASState, noise_generator
    from .optimizer import AdamWState

    dev = resolve_device(device)
    params, store, step = load_gas_state_npz(
        path, device=dev, history_dtype=history_dtype,
        history_storage=history_storage)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    opt = AdamWState(
        step=torch.from_numpy(np.asarray(
            flat["state/opt_state/step"], np.int32)).to(dev),
        m=params_from_numpy({k: v for k, v in flat.items()
                             if k.startswith("state/opt_state/m/")}, dev),
        v=params_from_numpy({k: v for k, v in flat.items()
                             if k.startswith("state/opt_state/v/")}, dev))
    rng = np.asarray(flat["state/rng"], np.uint32)
    return GASState(params=params, opt_state=opt, histories=store, rng=rng,
                    gen=noise_generator(rng, dev)), step


def _tensor_from_numpy(arr, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor of the same type; bf16 arrays (numpy's
    `bfloat16` extension type, as `np.asarray` gives a jax bf16 array)
    widen to f32 and round back, exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def _tree_from_numpy(tree, device: torch.device):
    if isinstance(tree, Mapping):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_from_numpy(v, device) for v in tree]
    return _tensor_from_numpy(tree, device)


def transformer_params_from_numpy(tree: Mapping[str, Any], device=None
                                  ) -> Dict[str, Any]:
    """The reference transformer's params tree ({"embed", "segs": [{"0":
    {...}}, ...], "final_norm", "lm_head"}, leaves as numpy arrays) ->
    the port's, leaf for leaf in the same types, on `device` (None means
    "cuda")."""
    return _tree_from_numpy(tree, resolve_device(device))


def transformer_cache_from_numpy(cache: Mapping[str, Any], device=None
                                 ) -> Dict[str, Any]:
    """The reference's decode cache {"pos": int32 scalar, "segs": [...]}
    -> the port's, with `pos` a host int."""
    dev = resolve_device(device)
    return {"pos": int(np.asarray(cache["pos"])),
            "segs": _tree_from_numpy(cache["segs"], dev)}
