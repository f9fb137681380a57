"""Device meshes and the card's peak figures.

The port of `repro.launch.mesh`. The reference's constants are a TPU
v5e's; these are the published peaks of the card the port runs on,
NVIDIA H100 80GB HBM3 (SXM) at its 700.00 W limit (NVIDIA's data sheet,
dense rates), the figures `chip_smoke.py`'s bounds use. A card set below
700 W runs slower under load.

`make_mesh` builds a `torch.distributed` DeviceMesh over the ranks of the
current process group, so it is called inside ranks that joined one
(`core.dist_gas.run_ranks` / `RankPool`). `make_production_mesh` (the
reference's 256- and 512-chip pods) needs many cards.
"""
from __future__ import annotations

import math
from typing import Sequence

DEVICE = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS_BF16 = 989e12        # tensor cores, dense
PEAK_FLOPS_F32 = 67e12          # outside the tensor cores
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 450e9               # bytes/s each way to the host's other cards


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A DeviceMesh of `shape` named `axes` over the default group's gloo
    ranks (the product of `shape` must be the world size), rank-major as
    `jax.make_mesh` lays out devices; its per-axis groups carry gloo
    collectives."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "a production mesh needs many cards, one rank each over NCCL "
        "(ROADMAP Queue A item A14)")


def mesh_num_devices(mesh) -> int:
    return math.prod(mesh.shape)
