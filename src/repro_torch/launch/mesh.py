"""Mesh construction and the card's peaks for the roofline analysis
(reference: the reference package's ``launch/mesh.py``).

Functions, not module-level meshes: importing this module touches no
device and starts no process group.

A ``DeviceMesh`` has one process per position, so a local mesh is built
over the running fleet (``parallel/rendezvous.py``): ``data * model``
processes, this one among them; the dense and MoE train step runs sharded
on it (``train.step.build_train_step(mesh=)``). The production mesh adds
the "pod" axis and the serving layouts, which run sharded in the next
slice of the port (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80GB data-sheet peaks, per card, used by the roofline
# analysis (launch/roofline.py, launch/dryrun.py); bounds, not measurements
PEAK_FLOPS_BF16 = 989.4e12      # bf16 tensor cores, dense
HBM_BW = 3.35e12                # HBM3 bytes/s
NVLINK_BW = 450e9               # NVLink 4: bytes/s per direction per GPU


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "the production mesh (a 'pod' axis over many hosts, the serving "
        "layouts, every family) needs sharded model compute beyond the "
        "dense and MoE step: the next slice of the port (ROADMAP queue 1, "
        "item 3); a local ('data', 'model') mesh over a fleet runs that "
        "step: make_local_mesh")


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
