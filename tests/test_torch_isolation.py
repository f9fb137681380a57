"""PyTorch port, isolation: the port imports neither jax nor the JAX
package, and its entry points run on the card unless asked for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import serve as t_serve
from repro_torch.core.history import HistoryStore
from repro_torch.data.graphs import citation_graph
from repro_torch.gnn import model as t_model
from repro_torch.launch import serve_gas
from repro_torch.train import checkpoint as t_ckpt

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)|"
                        r"from\s+(jax|repro)\b(?!_torch))", re.M)


def test_import_leaves_jax_and_reference_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    n_mods, bad = out.stdout.strip().splitlines()
    assert int(n_mods) >= 25, n_mods       # every module was imported
    assert bad == "[]", bad


def test_sources_import_no_jax_and_no_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 25
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)
    # the scan itself catches what it is for
    for line in ("import jax", "from jax import numpy", "import repro.core",
                 "from repro.kernels import ops", "  from repro import x"):
        assert _FORBIDDEN.search(line), line
    assert not _FORBIDDEN.search("from repro_torch.core import serve")


def test_entry_points_default_to_cuda():
    """device=None means "cuda": without a card every entry point raises
    instead of running on the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    g = citation_graph(num_nodes=40, num_features=4, num_classes=2, seed=0)
    spec = t_model.GNNSpec(op="gcn", d_in=4, d_hidden=8, num_classes=2,
                           num_layers=2)
    calls = [
        lambda: t_serve.build_serve_plan(g, spec, t_serve.ServeConfig()),
        lambda: t_model.init_gnn(spec),
        lambda: HistoryStore.create(41, [8]),
        lambda: t_ckpt.params_from_numpy(
            {"layers/0/w": np.zeros((4, 8), np.float32)}),
        lambda: t_ckpt.load_gas_state_npz("never-read.npz"),
        lambda: serve_gas.main(["--smoke"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_unported_options_raise():
    spec = t_model.GNNSpec(op="gat", d_in=4, d_hidden=8, num_classes=2,
                           num_layers=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_model.init_gnn(spec, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_serve.ServeConfig(history_dtype="int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        HistoryStore.create(5, [4], history_dtype="vq", device="cpu")
    with pytest.raises(ValueError, match="history_dtype"):
        HistoryStore.create(5, [4], history_dtype="f16", device="cpu")
