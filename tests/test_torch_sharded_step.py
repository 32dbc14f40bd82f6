"""The port's sharded train step against the reference's sharded step.

Both sides start from the same numpy TrainState (the port's unsharded
``init_state``, moved with ``state_to_numpy`` / ``state_from_numpy``) and
take two steps on the same synthetic batches under a ("data", "model")
mesh: the reference jits its ``train_step`` with ``state_shardings`` /
``batch_shardings`` on forced host devices, on a mesh built as
``jax.sharding.Mesh`` (``Auto`` axes; ``jax.make_mesh`` gives ``Explicit``
axes, which its ``with_sharding_constraint`` refuses), and the port runs
``build_train_step(cfg, mesh=)`` in a gloo fleet of CPU processes
(``tests/torch_fleet.py``). The two sides run side by side.

Compared, in f32 compute: each step's loss, ce, z_loss, moe_aux,
moe_dropped and grad_norm within ``RTOL`` relative, and the updated
parameters within ``PTOL`` of each leaf's largest magnitude. The MoE
capacity is per token shard in both, so a sharded MoE step is held to the
reference's sharded step, not to an unsharded one. In every fleet the
state ``init_state`` makes on the mesh equals ``place`` of the unsharded
one, and a second run of each step from the same state gives the same
bits."""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from torch_fleet import SRC, _env, run_fleet

# f32 compute on both sides: only the order of sums differs (matmul
# blocking, partial sums psummed over ranks), ~1e-6 relative
RTOL = 2e-5
PTOL = 2e-6
STEPS, BATCH, SEQ = 2, 8, 16
# the launchers' bf16 compute, sharded against unsharded: the row-parallel
# sums round once either way, but the per-shard bf16 weight gradients do
# not; measured at smoke widths 2.7e-4 (loss) and 1.6e-2 (grad_norm) at
# most, over florbench-100m, granite-3-2b and mixtral-8x7b. chip_smoke's
# phase P1 holds the card's sharded launcher to path A2 with these
BF16_LOSS_RTOL, BF16_GN_RTOL = 1e-3, 2e-2

REF = r"""
import json, pickle, sys
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

state_in, out, arch, d, m, over = sys.argv[1:7]
d, m = int(d), int(m)
cfg = JC.get_smoke(arch).replace(dtype="float32")
over = json.loads(over)
if "num_experts" in over:
    import dataclasses
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, num_experts=over.pop("num_experts")))
cfg = cfg.replace(**over)
mesh = Mesh(np.array(jax.devices()).reshape(d, m), ("data", "model"))
with open(state_in, "rb") as f:
    st = TrainState(*pickle.load(f))
model = build_model(cfg)
with use_mesh(mesh):
    _, train_step = build_train_step(cfg)
    st_sh = state_shardings(cfg, mesh, st)
    b_sh, _ = batch_shardings(model, ShapeSpec("t", "train", SEQ, BATCH),
                              mesh)
    rep = NamedSharding(mesh, P())
    ts = jax.jit(train_step, in_shardings=(st_sh, b_sh),
                 out_shardings=(st_sh, rep))
    state = jax.device_put(st, st_sh)
    metrics = []
    for step in range(STEPS):
        state, mt = ts(state, synthetic_batch(cfg, BATCH, SEQ, step, 0))
        metrics.append({k: float(v) for k, v in mt.items()})
with open(out, "wb") as f:
    pickle.dump({"metrics": metrics,
                 "params": jax.tree_util.tree_map(
                     np.asarray, jax.device_get(state.params))}, f)
"""
CONSTS = f"STEPS, BATCH, SEQ = {STEPS}, {BATCH}, {SEQ}\n"

PORT = """
import json, pickle
import numpy as np
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.data import synthetic_batch
from repro_torch.launch.specs import state_shardings
from repro_torch.parallel import place
from repro_torch.train.state import state_from_numpy
from repro_torch.train.step import build_train_step
from repro_torch.utils.pytree import tree_leaves, tree_map
from test_cfg import make_cfg


def main(rank, world, args):
    state_in, out, arch, d, m, over = args
    cfg = make_cfg(arch, json.loads(over))
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(int(d), int(m)),
                      mesh_dim_names=("data", "model"))
    init_u, _ = build_train_step(cfg, device="cpu")
    init_s, ts = build_train_step(cfg, device="cpu", mesh=mesh)
    sh = state_shardings(cfg, mesh, init_u(0))
    placed = lambda st: tree_map(lambda x, s: place(x, mesh, s.spec), st, sh)
    # init on the mesh: each rank's slices of the unsharded init
    for a, b in zip(tree_leaves(init_s(0)), tree_leaves(placed(init_u(0)))):
        assert a.placements == b.placements
        assert torch.equal(a.to_local(), b.to_local())
    with open(state_in, "rb") as f:
        state = placed(state_from_numpy(pickle.load(f), "cpu"))
    metrics = []
    for step in range(STEPS):
        batch = synthetic_batch(cfg, BATCH, SEQ, step, 0)
        again, m2 = ts(state, batch)
        state, mt = ts(state, batch)
        for a, b in zip(tree_leaves(state), tree_leaves(again)):
            assert torch.equal(a.to_local(), b.to_local()), "not bitwise"
        assert all(torch.equal(mt[k], m2[k]) for k in mt)
        metrics.append({k: float(v) for k, v in mt.items()})
    full = tree_map(lambda x: x.full_tensor().numpy(), state.params)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump({"metrics": metrics, "params": full}, f)
"""

CFG = """
import dataclasses
import repro_torch.configs as C


def make_cfg(arch, over):
    cfg = C.get_smoke(arch).replace(dtype="float32")
    over = dict(over)
    if "num_experts" in over:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, num_experts=over.pop("num_experts")))
    return cfg.replace(**over)
"""

CASES = [
    ("florbench-100m", (2, 2), {}),
    ("florbench-100m", (1, 4), {}),
    ("granite-3-2b", (2, 2), {}),
    # kv_heads 2 does not divide "model" 4: GQA replicates, q gathers
    ("granite-3-2b", (1, 4), {}),
    # EP on E: 4 experts, 2 per "model" rank
    ("mixtral-8x7b", (2, 2), {}),
    # 6 experts on "model" 4: every expert's d_ff sliced instead
    ("mixtral-8x7b", (1, 4), {"num_experts": 6}),
    # dense_layout="dp": tokens over ("data", "model"), all-gathered for
    # dispatch and the combine reduce-scattered
    ("mixtral-8x7b", (2, 2), {"dense_layout": "dp"}),
]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("arch,mesh,over", CASES,
                         ids=[f"{a}-{m[0]}x{m[1]}-{'-'.join(o) or 'base'}"
                              for a, m, o in CASES])
def test_sharded_step_matches_reference(tmp_path, arch, mesh, over):
    sys.path.insert(0, SRC)
    from repro_torch.train.state import state_to_numpy
    from repro_torch.train.step import build_train_step

    exec(CFG, ns := {})
    cfg = ns["make_cfg"](arch, over)
    init, _ = build_train_step(cfg, device="cpu")
    state_in = os.path.join(tmp_path, "state.pkl")
    with open(state_in, "wb") as f:
        pickle.dump(tuple(state_to_numpy(init(0))), f)
    with open(os.path.join(tmp_path, "test_cfg.py"), "w") as f:
        f.write(CFG)
    args = (arch, mesh[0], mesh[1], json.dumps(over))
    ref_out = os.path.join(tmp_path, "ref.pkl")
    prelude = (f"import os\nos.environ['XLA_FLAGS'] = "
               f"'--xla_force_host_platform_device_count={mesh[0] * mesh[1]}'"
               f"\nos.environ['JAX_PLATFORMS'] = 'cpu'\n")
    ref = subprocess.Popen([sys.executable, "-c", prelude + CONSTS + REF,
                            state_in,
                            ref_out, *map(str, args)], env=_env(),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    port_out = os.path.join(tmp_path, "port.pkl")
    try:
        outs = run_fleet(CONSTS + PORT, mesh[0] * mesh[1], tmp_path,
                         state_in,
                         port_out, *args,
                         env={"PYTHONPATH": f"{SRC}{os.pathsep}{tmp_path}"},
                         timeout=240)
        _, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    for rc, text in outs:
        assert rc == 0, text[-3000:]
    assert ref.returncode == 0, err[-3000:]
    with open(ref_out, "rb") as f:
        want = pickle.load(f)
    with open(port_out, "rb") as f:
        got = pickle.load(f)
    for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k, v in w.items():
            assert g[k] == pytest.approx(v, rel=RTOL, abs=1e-7), (step, k)
    for (p, a), (q, b) in zip(_leaves(got["params"]),
                              _leaves(want["params"])):
        assert p == q
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=PTOL * max(np.abs(b).max(), 1e-30),
                                   err_msg=p)



def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_launcher_fleet_replays_through_the_normal_launcher(
        tmp_path):
    """``launch/train.py --mesh 2x2 --num-processes 4 --device cpu`` trains
    sharded (each process prints the same per-step loss and grad_norm,
    within the bf16 tolerances of an unsharded launcher run's) and
    stitches every
    epoch; ``launch/replay`` then re-executes the run unsharded and its
    deferred check passes."""
    import re

    from repro_torch.checkpoint import CheckpointStore

    common = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
              "--epochs", "2", "--steps-per-epoch", "2", "--no-adaptive",
              "--print-steps"]
    run = str(tmp_path / "run")
    env = dict(_env(), OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *common,
         "--run-dir", run, "--mesh", "2x2", "--num-processes", "4",
         "--process-id", str(i), "--coordinator", f"127.0.0.1:{port}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(4)]
    one = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *common,
         "--run-dir", str(tmp_path / "one")], env=env, capture_output=True,
        text=True, timeout=300)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 4, outs[0][-3000:]
    assert one.returncode == 0, one.stderr[-3000:]

    def steps(text):
        return [tuple(map(float, m)) for m in re.findall(
            r"step \d+ loss (\S+) grad_norm (\S+)", text)]
    got = steps(outs[0])
    assert len(got) == 4 and all(steps(o) == got for o in outs)
    assert all("sharded step" in o for o in outs)
    for (loss, gn), (loss1, gn1) in zip(got, steps(one.stdout)):
        assert loss == pytest.approx(loss1, rel=BF16_LOSS_RTOL)
        assert gn == pytest.approx(gn1, rel=BF16_GN_RTOL)
    store = CheckpointStore(os.path.join(run, "store"))
    for e in range(2):
        m = store.get_manifest(f"train@{e}.0")
        assert m["version"] == 4 and len(m["members"]) == 4
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.replay", "--run-dir", run,
         "--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
         "--nworkers", "2", "--probe", "train", "--check"], env=env,
        capture_output=True, text=True, timeout=300)
    assert rep.returncode == 0, rep.stderr[-3000:]
    m = re.search(r"deferred check: ok=(\w+) compared=(\d+) hindsight=(\d+)",
                  rep.stdout)
    assert m and m[1] == "True" and int(m[3]) == 4, rep.stdout[-2000:]
