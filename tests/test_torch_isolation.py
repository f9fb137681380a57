"""PyTorch port, isolation: the port imports neither jax nor the JAX
package, and its entry points run on the card unless asked for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch",
                            reason="the PyTorch port's tests need torch")
import _torch_threads  # noqa: E402  one torch thread a test process

from repro_torch.core import dist_gas as t_dist
from repro_torch.core import runtime as t_rt
from repro_torch.core import seq_gas as t_seq_gas  # noqa: F401
from repro_torch.core import serve as t_serve
from repro_torch.configs.base import get_config
from repro_torch.core.history import HistoryStore
from repro_torch.data.graphs import citation_graph
from repro_torch.examples import deep_gnn_large_graph as t_deep_example
from repro_torch.examples import distributed_gas as t_dist_example
from repro_torch.examples import seq_gas_long_context as t_seq_example
from repro_torch.gnn import model as t_model
from repro_torch.launch import mesh as t_mesh  # noqa: F401
from repro_torch.launch import serve_gas, train_gas
from repro_torch.models import moe as t_moe  # noqa: F401
from repro_torch.models import rglru as t_rglru  # noqa: F401
from repro_torch.models import transformer as t_tf
from repro_torch.utils import tree as t_tree  # noqa: F401
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train.baselines import GraphSAGETrainer, SGCTrainer
from repro_torch.train.gas_trainer import FullBatchTrainer, GASTrainer

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
    env = _torch_threads.subprocess_env(PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    n_mods, bad = out.stdout.strip().splitlines()
    assert int(n_mods) >= 62, n_mods       # every module was imported
    assert bad == "[]", bad


def test_sources_import_no_jax_and_no_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 63
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
    structs = t_dist.build_dist_structs(g, np.arange(40) % 2)
    calls = [
        lambda: t_serve.build_serve_plan(g, spec, t_serve.ServeConfig()),
        lambda: t_model.init_gnn(spec),
        lambda: HistoryStore.create(41, [8]),
        lambda: t_ckpt.params_from_numpy(
            {"layers/0/w": np.zeros((4, 8), np.float32)}),
        lambda: t_ckpt.load_gas_state_npz("never-read.npz"),
        lambda: serve_gas.main(["--smoke"]),
        lambda: t_rt.build_plan(g, spec, t_rt.GASConfig(num_parts=2)),
        lambda: FullBatchTrainer(g, spec),
        lambda: GASTrainer(g, spec, num_parts=2),
        lambda: GraphSAGETrainer(g, d_hidden=8),
        lambda: SGCTrainer(g),
        lambda: t_ckpt.load_gas_state("never-read.npz"),
        lambda: train_gas.main(["--smoke"]),
        lambda: t_tf.init_params(get_config("qwen3-0.6b", "smoke")),
        lambda: t_tf.init_cache(get_config("qwen3-0.6b", "smoke"), 1, 8),
        lambda: t_tf.init_params(get_config("recurrentgemma-9b", "smoke")),
        lambda: t_tf.init_params(get_config("hubert-xlarge", "smoke")),
        lambda: t_seq_example.main(["--steps", "1"]),
        lambda: t_deep_example.main(["--nodes", "200", "--epochs", "1"]),
        lambda: t_ckpt.transformer_params_from_numpy(
            {"embed": np.zeros((4, 2), np.float32)}),
        lambda: t_ckpt.transformer_cache_from_numpy(
            {"pos": np.int32(0), "segs": []}),
        lambda: t_dist_example.main(ranks=2, supersteps=1, nodes=60),
        lambda: t_dist.run_ranks(t_dist_example.train_rank, 2),
        lambda: structs.device_batch(0),
        lambda: structs.exchange_arrays(0),
        lambda: structs.init_store([8], rank=0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_unported_options_raise():
    # every operator trains and serves: GIN's serve plan reads the
    # unit-weight blocks; an unknown store precision raises
    spec = t_model.GNNSpec(op="gin", d_in=4, d_hidden=8, num_classes=2,
                           num_layers=2)
    params = t_model.init_gnn(spec, device="cpu")
    g = citation_graph(num_nodes=50, num_features=4, num_classes=2, seed=0)
    plan = t_serve.build_serve_plan(g, spec, t_serve.ServeConfig(),
                                    device="cpu")
    assert plan.unit_weights
    state = t_serve.init_serve_state(plan, t_serve.ServeState(
        params, HistoryStore.create(51, spec.hist_dims(), device="cpu")))
    logits, _, _ = t_serve.serve_request(plan, state, np.arange(5))
    assert logits.shape == (5, 2) and np.isfinite(logits).all()
    # the fused epoch is ported: the trainer takes it
    tr = GASTrainer(g, spec, num_parts=2, fused_epoch=True, device="cpu")
    assert np.isfinite(tr.fit(1)[0]["loss"]) and tr.plan._fused is not None
    with pytest.raises(ValueError, match="history_dtype"):
        HistoryStore.create(5, [4], history_dtype="f16", device="cpu")


def test_distributed_example_runs_on_cpu_when_asked():
    """The example's command line with --device cpu: 2 spawned gloo ranks,
    a few supersteps on a small graph, its test accuracy printed."""
    env = _torch_threads.subprocess_env(PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.distributed_gas",
         "--device", "cpu", "--ranks", "2", "--supersteps", "3", "--nodes",
         "240"], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "240 nodes on 2 ranks" in out.stdout
    acc = float(out.stdout.strip().splitlines()[-1].split()[-1])
    assert 0.0 <= acc <= 1.0


@pytest.mark.parametrize("example,args,expect", [
    ("seq_gas_long_context", ["--steps", "2", "--seq-len", "128",
                              "--chunk", "32"], "max |chunked - full| ="),
    ("deep_gnn_large_graph", ["--nodes", "600", "--epochs", "1"],
     "GIN-4L on CLUSTER-SBM:"),
])
def test_examples_run_on_cpu_when_asked(example, args, expect):
    """The seq-GAS and deep-GNN examples' command lines with --device cpu
    at a small size."""
    env = _torch_threads.subprocess_env(PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{example}", "--device",
         "cpu", *args], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert expect in out.stdout
