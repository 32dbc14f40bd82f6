"""How far a bf16 step on a mesh moves the loss from the same step on one
process, in both packages.

A zamba2-7b smoke record on a (2, 2) mesh in the config's bf16, replayed
on one process, moves the loss past the deferred check's 1e-4. This test
measures that gap where it starts: both packages take ``STEPS`` steps from
the same state (the port's ``init_state`` through numpy) on the same
synthetic batches, once sharded on a (2, 2) ("data", "model") mesh and
once on one process, in bf16 compute. The reference jits its step on four
forced host devices over an ``Auto``-axis ``jax.sharding.Mesh`` (and on
one device); the port runs a four-process gloo fleet (and, in its first
process, the step with no mesh).
Each side's largest |sharded - unsharded| loss over the steps is printed;
the port's may not exceed twice the reference's (the ``GAP_RATIO``),
which would make it a fault of the port's own rounding."""
import pickle
import subprocess
import sys

import numpy as np

from torch_fleet import SRC, _env, run_fleet

STEPS, BATCH, SEQ = 2, 8, 16
ARCH = "zamba2-7b"
GAP_RATIO = 2.0
CONSTS = f"STEPS, BATCH, SEQ, ARCH = {STEPS}, {BATCH}, {SEQ}, {ARCH!r}\n"

REF = r"""
import pickle, sys
import numpy as np
import jax
import repro.configs as JC
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeSpec
from repro.data import synthetic_batch
from repro.launch.specs import batch_shardings, state_shardings
from repro.models import build_model
from repro.parallel import use_mesh
from repro.train.state import TrainState
from repro.train.step import build_train_step

state_in, out = sys.argv[1:3]
with open(state_in, "rb") as f:
    st = TrainState(*pickle.load(f))
cfg = JC.get_smoke(ARCH)
model = build_model(cfg)
_, step = build_train_step(cfg)
one = jax.jit(step)
state, losses = st, {"unsharded": [], "sharded": []}
for i in range(STEPS):
    state, mt = one(state, synthetic_batch(cfg, BATCH, SEQ, i, 0))
    losses["unsharded"].append(float(mt["loss"]))
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
with use_mesh(mesh):
    _, step = build_train_step(cfg)
    st_sh = state_shardings(cfg, mesh, st)
    b_sh, _ = batch_shardings(model, ShapeSpec("t", "train", SEQ, BATCH),
                              mesh)
    ts = jax.jit(step, in_shardings=(st_sh, b_sh),
                 out_shardings=(st_sh, NamedSharding(mesh, P())))
    state = jax.device_put(st, st_sh)
    for i in range(STEPS):
        state, mt = ts(state, synthetic_batch(cfg, BATCH, SEQ, i, 0))
        losses["sharded"].append(float(mt["loss"]))
with open(out, "wb") as f:
    pickle.dump(losses, f)
"""

PORT = """
import pickle
from torch.distributed.device_mesh import DeviceMesh
import repro_torch.configs as C
from repro_torch.data import synthetic_batch
from repro_torch.launch.specs import state_shardings
from repro_torch.parallel import place
from repro_torch.train.state import state_from_numpy
from repro_torch.train.step import build_train_step
from repro_torch.utils.pytree import tree_map


def main(rank, world, args):
    state_in, out = args
    with open(state_in, "rb") as f:
        st = pickle.load(f)
    cfg = C.get_smoke(ARCH)
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    _, ts = build_train_step(cfg, device="cpu", mesh=mesh)
    state = state_from_numpy(st, "cpu")
    sh = state_shardings(cfg, mesh, state)
    state = tree_map(lambda x, s: place(x, mesh, s.spec), state, sh)
    losses = {"unsharded": [], "sharded": []}
    for i in range(STEPS):
        state, mt = ts(state, synthetic_batch(cfg, BATCH, SEQ, i, 0))
        losses["sharded"].append(float(mt["loss"]))
    if rank == 0:
        # one process, on the same single thread as the fleet's ranks
        _, step = build_train_step(cfg, device="cpu")
        state = state_from_numpy(st, "cpu")
        for i in range(STEPS):
            state, mt = step(state, synthetic_batch(cfg, BATCH, SEQ, i, 0))
            losses["unsharded"].append(float(mt["loss"]))
        with open(out, "wb") as f:
            pickle.dump(losses, f)
"""


def test_zamba2_bf16_mesh_loss_gap_against_reference(tmp_path):
    sys.path.insert(0, SRC)
    import repro_torch.configs as C
    from repro_torch.train.state import state_to_numpy
    from repro_torch.train.step import build_train_step

    cfg = C.get_smoke(ARCH)
    assert cfg.dtype == "bfloat16"
    init, _ = build_train_step(cfg, device="cpu")
    st = init(0)
    state_in = str(tmp_path / "state.pkl")
    with open(state_in, "wb") as f:
        pickle.dump(tuple(state_to_numpy(st)), f)
    ref_out, port_out = str(tmp_path / "ref.pkl"), str(tmp_path / "port.pkl")
    prelude = ("import os\nos.environ['XLA_FLAGS'] = "
               "'--xla_force_host_platform_device_count=4'\n"
               "os.environ['JAX_PLATFORMS'] = 'cpu'\n")
    ref = subprocess.Popen([sys.executable, "-c", prelude + CONSTS + REF,
                            state_in, ref_out], env=_env(),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        outs = run_fleet(CONSTS + PORT, 4, str(tmp_path), state_in,
                         port_out, timeout=300)
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    for rc, text in outs:
        assert rc == 0, text[-3000:]
    assert ref.returncode == 0, err[-3000:]
    with open(port_out, "rb") as f:
        got = pickle.load(f)
    with open(ref_out, "rb") as f:
        want = pickle.load(f)
    port_gap, ref_gap = (max(abs(a - b) for a, b in zip(r["sharded"],
                                                         r["unsharded"]))
                         for r in (got, want))
    print(f"{ARCH} bf16 (2, 2): |sharded - unsharded| loss, port "
          f"{port_gap:.3e} (steps {got['sharded']} vs {got['unsharded']}),"
          f" reference {ref_gap:.3e} (steps {want['sharded']} vs "
          f"{want['unsharded']})")
    assert np.isfinite(port_gap) and np.isfinite(ref_gap)
    assert port_gap <= GAP_RATIO * ref_gap, (port_gap, ref_gap)
