"""Mesh construction and the card's peaks for the roofline analysis
(reference: the reference package's ``launch/mesh.py``).

Functions, not module-level meshes: importing this module touches no
device and starts no process group.

A ``DeviceMesh`` has one process per position, so a local mesh is built
over the running fleet (``parallel/rendezvous.py``): ``data * model``
processes, this one among them. The production mesh shards model compute,
which this package does not run yet (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80GB data-sheet peaks, per card, used by the roofline
# analysis (launch/roofline.py, launch/dryrun.py); bounds, not measurements
PEAK_FLOPS_BF16 = 989.4e12      # bf16 tensor cores, dense
HBM_BW = 3.35e12                # HBM3 bytes/s
NVLINK_BW = 450e9               # NVLink 4: bytes/s per direction per GPU


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "the production mesh shards model compute (constrain under a mesh, "
        "expert parallelism, a stage axis), which this package does not run "
        "yet (ROADMAP queue 1, item 10: sharded model compute)")


def make_local_mesh(data: int = 1, model: int = 1, *, device: str = "cuda"):
    """A ("data", "model") ``DeviceMesh`` over the running fleet of
    ``data * model`` processes (``parallel.rendezvous.init_distributed``
    starts one)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.parallel.rendezvous import current_group

    if not dist.is_initialized():
        raise ValueError("no fleet is running: start one with "
                         "parallel.rendezvous.init_distributed")
    n = data * model
    fleet = current_group().num_processes
    if fleet != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {n} processes, "
                         f"the fleet has {fleet}")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(n).reshape(data, model),
                      mesh_dim_names=("data", "model"))
