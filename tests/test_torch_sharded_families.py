"""Every remaining family's sharded train step against the reference's.

The families whose sharded compute the port added last: MLA (deepseek-v3,
its MoE layers under MLA), Mamba1 (falcon-mamba), Mamba2 with the shared
attention block (zamba2), the encoder-decoder (seamless-m4t), the vision
prefix (llava-next) and sequence parallelism (qwen3-14b, ``seq_shard``).
As in ``test_torch_sharded_step.py`` both sides start from the port's
unsharded ``init_state`` (through numpy) and take two steps on the same
synthetic batches, in f32: the reference jits its ``train_step`` with
``state_shardings`` / ``batch_shardings`` on 4 forced host devices over an
``Auto``-axis ``jax.sharding.Mesh``; the port runs
``build_train_step(cfg, mesh=)`` in a gloo fleet of 4 CPU processes. One
reference process and one fleet run every case (both meshes have 4
positions), side by side; each case is then checked on its own.

Compared: each step's loss, ce, z_loss, moe_aux, moe_dropped and
grad_norm within ``RTOL``; the updated parameters within ``PTOL`` of each
leaf's largest magnitude plus ``STOL`` of its largest change over the two
steps (a gradient summed in another order, as AdamW normalizes it: all
that a leaf starting at zero, such as ``conv_b``, holds). An element
whose reference gradient nearly cancels at some step (below ``CANCEL`` of
its leaf's gradient RMS) is allowed ``UTOL`` of that change instead:
AdamW's update is the gradient over its own root mean square, so where
the gradient is a small difference of large terms the order in which the
two sides sum them moves the update by a large share of the step size.
In the fleet a second run of each step from the same state
gives the same bits, and a case that sets ``remat`` / ``remat_policy``
gives, rank by rank, the same local shards and metrics as the config's
default setting at every step."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from torch_fleet import SRC, _env, run_fleet

# f32 compute on both sides: only the order of sums differs (matmul
# blocking, partial sums psummed over ranks, the chunked scans' split)
RTOL = 2e-5
PTOL = 2e-6
# shares of a leaf's largest update: any element (measured at most
# 3.6e-5, in zamba2's zero-initialized conv_b), and one whose reference
# gradient is below CANCEL of its leaf's RMS (measured 9.6e-3, at a conv_b
# element whose gradient is 4e-6 of the RMS)
STOL = 1e-4
UTOL = 2e-2
CANCEL = 1e-3
STEPS, BATCH, SEQ = 2, 8, 16

CASES = [
    # MLA: heads over "model"; its two MoE layers under MLA
    ("deepseek-v3-671b", (2, 2), {}),
    # Mamba1: in_proj split before the split, x_proj psummed
    ("falcon-mamba-7b", (2, 2), {}),
    # Mamba2 groups + the shared attention block, sliding window
    ("zamba2-7b", (2, 2), {}),
    ("seamless-m4t-large-v2", (2, 2), {}),
    # the image prefix cut to the local rows
    ("llava-next-mistral-7b", (2, 2), {}),
    # seq_shard: the residual's sequence over "model"
    ("qwen3-14b", (2, 2), {}),
    # kv_heads 2 does not divide "model" 4: K/V replicate; the chunked
    # path runs the seq_mp layout (each rank its own queries)
    ("qwen3-14b", (1, 4), {"attention_impl": "chunked",
                           "attention_chunk": 4}),
    # per-layer remat: the cases above run the default (on, "nothing");
    # these run it off and under "dots", dense and expert-parallel, and
    # the fleet holds each to the default's bits
    ("florbench-100m", (2, 2), {"remat": False}),
    ("florbench-100m", (2, 2), {"remat_policy": "dots"}),
    ("mixtral-8x7b", (2, 2), {"remat": False}),
    ("mixtral-8x7b", (2, 2), {"remat_policy": "dots"}),
]
REMAT = {"remat", "remat_policy"}


def _case_id(arch, mesh, over) -> str:
    tag = "-chunked" if "attention_impl" in over else \
        "-remat-off" if over.get("remat") is False else \
        "-dots" if over.get("remat_policy") == "dots" else ""
    return f"{arch}-{mesh[0]}x{mesh[1]}{tag}"


IDS = [_case_id(*c) for c in CASES]
REMAT_IDS = [i for i, (_, _, o) in zip(IDS, CASES) if REMAT & set(o)]

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

cases_in, out = sys.argv[1:3]
with open(cases_in, "rb") as f:
    cases = pickle.load(f)
res = {}
for c in cases:
    cfg = JC.get_smoke(c["arch"]).replace(dtype="float32", **c["over"])
    d, m = c["mesh"]
    mesh = Mesh(np.array(jax.devices()).reshape(d, m), ("data", "model"))
    model = build_model(cfg)
    st = TrainState(*c["state"])
    with use_mesh(mesh):
        _, train_step = build_train_step(cfg)
        st_sh = state_shardings(cfg, mesh, st)
        b_sh, _ = batch_shardings(model, ShapeSpec("t", "train", SEQ,
                                                   BATCH), mesh)
        rep = NamedSharding(mesh, P())
        ts = jax.jit(train_step, in_shardings=(st_sh, b_sh),
                     out_shardings=(st_sh, rep))
        grad = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]),
                       in_shardings=(st_sh.params, b_sh),
                       out_shardings=st_sh.params)
        state = jax.device_put(st, st_sh)
        metrics, grads = [], []
        for step in range(STEPS):
            batch = synthetic_batch(cfg, BATCH, SEQ, step, 0)
            grads.append(jax.tree_util.tree_map(
                np.asarray, jax.device_get(grad(state.params, batch))))
            state, mt = ts(state, batch)
            metrics.append({k: float(v) for k, v in mt.items()})
    res[c["id"]] = {"metrics": metrics, "grads": grads,
                    "params": jax.tree_util.tree_map(
                        np.asarray, jax.device_get(state.params))}
with open(out, "wb") as f:
    pickle.dump(res, f)
"""
CONSTS = f"STEPS, BATCH, SEQ, REMAT = {STEPS}, {BATCH}, {SEQ}, {REMAT}\n"

PORT = """
import pickle
from torch.distributed.device_mesh import DeviceMesh
import repro_torch.configs as C
from repro_torch.data import synthetic_batch
from repro_torch.launch.specs import state_shardings
from repro_torch.parallel import place
from repro_torch.train.state import state_from_numpy
from repro_torch.train.step import build_train_step
from repro_torch.utils.pytree import tree_leaves, tree_map


def main(rank, world, args):
    cases_in, out = args
    with open(cases_in, "rb") as f:
        cases = pickle.load(f)
    res = {}
    for c in cases:
        cfg = C.get_smoke(c["arch"]).replace(dtype="float32", **c["over"])
        d, m = c["mesh"]
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(d, m),
                          mesh_dim_names=("data", "model"))
        _, ts = build_train_step(cfg, device="cpu", mesh=mesh)
        state = state_from_numpy(c["state"], "cpu")
        sh = state_shardings(cfg, mesh, state)
        state = tree_map(lambda x, s: place(x, mesh, s.spec), state, sh)
        same = None
        if REMAT & set(c["over"]):
            # the same steps under the config's default remat setting
            base = {k: v for k, v in c["over"].items() if k not in REMAT}
            _, ts0 = build_train_step(C.get_smoke(c["arch"]).replace(
                dtype="float32", **base), device="cpu", mesh=mesh)
            state0, same = state, True
        metrics = []
        for step in range(STEPS):
            batch = synthetic_batch(cfg, BATCH, SEQ, step, 0)
            again, m2 = ts(state, batch)
            state, mt = ts(state, batch)
            for a, b in zip(tree_leaves(state), tree_leaves(again)):
                assert torch.equal(a.to_local(), b.to_local()), c["id"]
            assert all(torch.equal(mt[k], m2[k]) for k in mt), c["id"]
            if same is not None:
                state0, m0 = ts0(state0, batch)
                same = same and all(
                    torch.equal(a.to_local(), b.to_local())
                    for a, b in zip(tree_leaves(state), tree_leaves(state0))
                ) and all(torch.equal(mt[k], m0[k]) for k in mt)
            metrics.append({k: float(v) for k, v in mt.items()})
        full = tree_map(lambda x: x.full_tensor().numpy(), state.params)
        res[c["id"]] = {"metrics": metrics, "params": full, "same": same}
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
"""


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port results, reference results) of every case."""
    sys.path.insert(0, SRC)
    import repro_torch.configs as C
    from repro_torch.train.state import state_to_numpy
    from repro_torch.train.step import build_train_step

    tmp = tmp_path_factory.mktemp("families")
    cases = []
    for cid, (arch, mesh, over) in zip(IDS, CASES):
        cfg = C.get_smoke(arch).replace(dtype="float32", **over)
        init, _ = build_train_step(cfg, device="cpu")
        cases.append({"id": cid, "arch": arch, "mesh": mesh, "over": over,
                      "state": tuple(state_to_numpy(init(0)))})
    cases_in = str(tmp / "cases.pkl")
    with open(cases_in, "wb") as f:
        pickle.dump(cases, f)
    ref_out, port_out = str(tmp / "ref.pkl"), str(tmp / "port.pkl")
    prelude = ("import os\nos.environ['XLA_FLAGS'] = "
               "'--xla_force_host_platform_device_count=4'\n"
               "os.environ['JAX_PLATFORMS'] = 'cpu'\n")
    ref = subprocess.Popen([sys.executable, "-c", prelude + CONSTS + REF,
                            cases_in, ref_out], env=_env(),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        outs = run_fleet(CONSTS + PORT, 4, str(tmp), cases_in, port_out,
                         timeout=400)
        _, err = ref.communicate(timeout=400)
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
    init = {c["id"]: c["state"][0] for c in cases}
    return got, want, init


@pytest.mark.parametrize("cid", IDS)
def test_sharded_family_step_matches_reference(runs, cid):
    got, want, init = runs[0][cid], runs[1][cid], runs[2][cid]
    for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        assert set(g) == set(w), (step, set(g) ^ set(w))
        for k, v in w.items():
            assert g[k] == pytest.approx(v, rel=RTOL, abs=1e-7), \
                (step, k, g[k], v)
    grads = [dict(_leaves(g)) for g in want["grads"]]
    for (p, a), (q, b), (_, b0) in zip(_leaves(got["params"]),
                                       _leaves(want["params"]),
                                       _leaves(init)):
        assert p == q
        cancel = np.zeros(b.shape, dtype=bool)
        for g in grads:
            cancel |= np.abs(g[p]) < CANCEL * np.sqrt(np.mean(g[p] ** 2))
        step = np.abs(b - b0).max()
        tol = PTOL * np.abs(b).max() + np.where(cancel, UTOL, STOL) * step
        err = np.abs(a - b)
        bad = err > tol
        assert not bad.any(), (p, int(bad.sum()), float((err / tol).max()))


@pytest.mark.parametrize("cid", REMAT_IDS)
def test_sharded_remat_setting_gives_the_default_bits(runs, cid):
    """Every rank's local shards and metrics after each step equal, bit
    for bit, those of the config's default setting (remat on,
    "nothing")."""
    assert runs[0][cid]["same"] is True


def test_zamba2_launcher_fleet_records_and_replays(tmp_path):
    """``launch/train.py --arch zamba2-7b --smoke --mesh 2x2
    --num-processes 4 --device cpu`` records a sharded run (a v4 manifest
    with four members per epoch) and ``launch/replay`` re-executes it
    unsharded with ``deferred check: ok=True``. The record computes in f32
    (``--dtype float32``) and keeps the dtype with the run, so the replay,
    given no dtype, re-executes in f32 too: in the config's bf16 an
    unsharded re-execution of a sharded step rounds its row-parallel sums
    elsewhere, and zamba2's 13 layers move the loss by 4.8e-4, past the
    check's 1e-4 (ROADMAP queue 3)."""
    import re
    import socket

    from repro_torch.checkpoint import CheckpointStore

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    common = ["--arch", "zamba2-7b", "--smoke", "--dtype", "float32",
              "--device", "cpu", "--batch", "4", "--seq", "32", "--epochs", "2",
              "--steps-per-epoch", "2", "--no-adaptive"]
    run = str(tmp_path / "run")
    env = dict(_env(), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *common,
         "--run-dir", run, "--mesh", "2x2", "--num-processes", "4",
         "--process-id", str(i), "--coordinator", f"127.0.0.1:{port}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 4, outs[0][-3000:]
    assert all("sharded step" in o for o in outs)
    store = CheckpointStore(os.path.join(run, "store"))
    for e in range(2):
        m = store.get_manifest(f"train@{e}.0")
        assert m["version"] == 4 and len(m["members"]) == 4
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.replay", "--run-dir", run,
         "--arch", "zamba2-7b", "--smoke", "--device",
         "cpu", "--batch", "4",
         "--seq", "32", "--nworkers", "2", "--probe", "train", "--check"],
        env=env, capture_output=True, text=True, timeout=400)
    assert rep.returncode == 0, rep.stderr[-3000:]
    m = re.search(r"deferred check: ok=(\w+) compared=(\d+) hindsight=(\d+)",
                  rep.stdout)
    assert m and m[1] == "True", rep.stdout[-2000:]
    print(m[0])
