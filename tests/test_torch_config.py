"""The history store's precision as both packages resolve it: the
argument, else $REPRO_HISTORY_DTYPE, else f32. A default `GASConfig` run
under the variable builds the same store in the port as in the
reference, an explicit argument beats the variable, and an unknown name
raises in both."""
import numpy as np
import pytest

torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

from repro.core import runtime as r_rt
from repro.data.graphs import citation_graph as r_citation
from repro.gnn.model import GNNSpec as RSpec

from repro_torch.core import history as t_hist
from repro_torch.core import runtime as t_rt
from repro_torch.data.graphs import citation_graph as t_citation
from repro_torch.gnn.model import GNNSpec as TSpec

GRAPH = dict(num_nodes=160, num_features=16, num_classes=4, seed=0)
SPEC = dict(op="gcn", d_in=16, d_hidden=16, num_classes=4, num_layers=2)


def _stores(**cfg):
    """The reference's and the port's fresh stores from `build_plan` and
    `init_state` on one small citation graph."""
    rplan = r_rt.build_plan(r_citation(**GRAPH), RSpec(**SPEC),
                            r_rt.GASConfig(num_parts=4, backend="jnp", **cfg))
    tplan = t_rt.build_plan(t_citation(**GRAPH), TSpec(**SPEC),
                            t_rt.GASConfig(num_parts=4, **cfg), device="cpu")
    return (r_rt.init_state(rplan).histories,
            t_rt.init_state(tplan).histories)


def _storage(store) -> str:
    dt = store.tables[0].dtype
    return (str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype)
            else np.dtype(dt).name)


@pytest.mark.parametrize("hd", ["int8", "vq", "bf16"])
def test_history_dtype_from_environment(monkeypatch, hd):
    monkeypatch.setenv("REPRO_HISTORY_DTYPE", hd)
    r_store, t_store = _stores()
    assert r_store.history_dtype == t_store.history_dtype == hd
    assert _storage(t_store) == _storage(r_store)
    assert len(t_store.tables) == len(r_store.tables)
    for rt, tt in zip(r_store.tables, t_store.tables):
        assert tuple(tt.shape) == tuple(rt.shape)
    assert (t_store.scales is None) == (r_store.scales is None)
    assert (t_store.codebooks is None) == (r_store.codebooks is None)
    assert t_hist.resolve_history_dtype() == hd
    assert t_hist.HistoryStore.create(
        5, [16], device="cpu").history_dtype == hd


@pytest.mark.parametrize("hd", ["int8", "vq", "bf16"])
def test_history_dtype_argument_beats_environment(monkeypatch, hd):
    monkeypatch.setenv("REPRO_HISTORY_DTYPE", hd)
    r_store, t_store = _stores(history_dtype="f32")
    assert r_store.history_dtype == t_store.history_dtype == "f32"
    assert _storage(t_store) == _storage(r_store) == "float32"
    assert t_hist.resolve_history_dtype("int8") == "int8"


def test_history_dtype_default_without_environment(monkeypatch):
    monkeypatch.delenv("REPRO_HISTORY_DTYPE", raising=False)
    r_store, t_store = _stores()
    assert r_store.history_dtype == t_store.history_dtype == "f32"
    assert _storage(t_store) == _storage(r_store) == "float32"


def test_unknown_history_dtype_raises(monkeypatch):
    monkeypatch.setenv("REPRO_HISTORY_DTYPE", "fp8")
    with pytest.raises(ValueError, match="history_dtype must be one of") as r:
        r_rt.build_plan(r_citation(**GRAPH), RSpec(**SPEC),
                        r_rt.GASConfig(num_parts=4, backend="jnp"))
    with pytest.raises(ValueError, match="history_dtype must be one of") as t:
        t_rt.build_plan(t_citation(**GRAPH), TSpec(**SPEC),
                        t_rt.GASConfig(num_parts=4), device="cpu")
    assert str(t.value) == str(r.value)
    with pytest.raises(ValueError, match="history_dtype must be one of"):
        t_hist.HistoryStore.create(5, [16], device="cpu")
