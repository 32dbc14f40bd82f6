"""Mesh construction and the card's peaks for the roofline analysis
(reference: the reference package's ``launch/mesh.py``).

Functions, not module-level meshes: importing this module touches no
device and starts no process group.

A ``DeviceMesh`` has one process per position, so a local mesh is built
over the running fleet (``parallel/rendezvous.py``): ``data * model``
processes, this one among them; every family's train step and serving
path runs sharded on it (``train.step.build_train_step(mesh=)``,
``models.api.Model.prefill`` / ``decode`` under ``use_mesh``).

The production mesh — the reference's (16, 16) ("data", "model") or (2,
16, 16) ("pod", "data", "model") — has 256 or 512 positions. It is built
over a FAKE process group in this one process, as rank 0: the dry run
(``launch/dryrun.py``) traces rank 0's program on it, over fake tensors,
and its collectives become ``_c10d_functional`` nodes. Nothing runs on
it: a fake group returns no data.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80GB data-sheet peaks, per card, used by the roofline
# analysis (launch/roofline.py, launch/dryrun.py); bounds, not measurements
PEAK_FLOPS_BF16 = 989.4e12      # bf16 tensor cores, dense
HBM_BW = 3.35e12                # HBM3 bytes/s
NVLINK_BW = 450e9               # NVLink 4: bytes/s per direction per GPU


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh as a ``DeviceMesh`` over a fake
    process group of 512 ranks started in this process (rank 0; the (16,
    16) mesh takes its first 256). For tracing only. Refuses while a real
    process group is up."""
    return make_fake_mesh(*PRODUCTION[multi_pod])


def make_fake_mesh(shape, names, world: int = 512):
    """A ``DeviceMesh`` of ``shape`` over the first ranks of a fake process
    group of ``world`` ranks in this process (rank 0), started here if
    none is up: ``make_production_mesh``'s, for a mesh of any shape."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "the production mesh starts a fake process group for "
                "tracing; a real one is up in this process")
        if dist.get_world_size() < world or dist.get_rank() != 0:
            raise RuntimeError("a fake process group of another size or "
                               "rank is up in this process")
    else:
        # an internal module of torch: the one place this package uses it
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    n = 1
    for d in shape:
        n *= d
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


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
