"""The port's cross-family record -> hindsight-replay matrix, a copy of
``tests/test_family_matrix.py`` on the CPU: every model family (dense,
MoE, SSM, hybrid, audio enc-dec, VLM) records through the full Session
path and hindsight-replays to a BIT-IDENTICAL state and the same log rows.

One more case per family the port gained last (MLA in deepseek-v3's MoE,
SSM, hybrid, audio): the reference records a run, the port records one
from the same weights carried across, and the deferred check holds the
port's logged losses to the reference's at its own rtol 1e-4 (both in f32
compute, where the packages agree to 1e-5). And the record and replay
launchers take each of those four archs with ``--layers`` cutting depth
(deepseek-v3 to its leading dense layer, so that its checkpoints carry
the zero-byte leaves of an empty MoE stack)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.flor as jflor
import repro_torch.configs as C
import repro_torch.flor as flor
from repro.train.step import build_train_step as jax_build_train_step
from repro_torch.data import synthetic_batch
from repro_torch.logging import FingerprintLog
from repro_torch.train.state import state_from_numpy
from repro_torch.train.step import build_train_step
from repro_torch.utils.pytree import tree_leaves

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
EPOCHS, STEPS = 2, 2
BATCH, SEQ = 2, 32

# one representative arch per family
FAMILIES = [
    ("dense", "gemma-2b"),
    ("moe", "mixtral-8x7b"),
    ("ssm", "falcon-mamba-7b"),
    ("hybrid", "zamba2-7b"),
    ("audio", "seamless-m4t-large-v2"),
    ("vlm", "llava-next-mistral-7b"),
]
NEW = ["deepseek-v3-671b", "falcon-mamba-7b", "zamba2-7b",
       "seamless-m4t-large-v2"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _loop(sess, cfg, state, ts, probe=False):
    with sess.checkpointing(state=state) as ckpt:
        for epoch in sess.loop("epochs", range(EPOCHS)):
            for s in sess.loop("train", range(STEPS)):
                b = synthetic_batch(cfg, BATCH, SEQ, epoch * STEPS + s)
                ckpt.state, m = ts(ckpt.state, b)
                if probe:
                    flor.log("probe_gnorm", m["grad_norm"])
            if sess.executed("train"):
                flor.log("loss", m["loss"])
        return ckpt.state


def _bits(t):
    t = t.detach().contiguous()
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(view[t.element_size()]) if t.is_floating_point() else t


def _leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


@pytest.mark.slow
@pytest.mark.parametrize("family,arch", FAMILIES,
                         ids=[f for f, _ in FAMILIES])
def test_family_record_replay_bit_identical(tmp_path, family, arch):
    cfg = C.get_smoke(arch)
    assert cfg.family == family
    init_state, ts = build_train_step(cfg, device="cpu")
    run = str(tmp_path / arch)

    with flor.Session(run, mode="record",
                      record=flor.RecordSpec(adaptive=False)) as sess:
        final = _loop(sess, cfg, init_state(0), ts)

    with flor.Session(run, mode="replay",
                      replay=flor.ReplaySpec(probed={"train"})) as sess:
        out = _loop(sess, cfg, init_state(0), ts, probe=True)

    # 1) replayed final state is bit-identical
    assert _leaves_equal(final, out), f"{arch}: state diverged in replay"
    # 2) every recorded log row is reproduced bit-identically, and the
    #    hindsight probes landed
    rec, reps = flor.run_logs(run)
    res = flor.deferred_check(rec, reps)
    assert res.ok, (arch, res.anomalies)
    assert res.compared == EPOCHS            # one loss row per epoch
    assert res.hindsight_only == EPOCHS * STEPS
    rec_loss = [r["value"] for r in FingerprintLog.read(rec)
                if r["key"] == "loss"]
    rep_loss = [r["value"] for p in reps for r in FingerprintLog.read(p)
                if r["key"] == "loss"]
    assert rec_loss == rep_loss and len(rec_loss) == EPOCHS


def _jax_record(cfg, run, jstate):
    _, jstep = jax_build_train_step(cfg)
    jstep = jax.jit(jstep)
    with jflor.Session(run, mode="record",
                       record=jflor.RecordSpec(adaptive=False)) as sess:
        with sess.checkpointing(state=jstate) as ckpt:
            for epoch in sess.loop("epochs", range(EPOCHS)):
                for s in sess.loop("train", range(STEPS)):
                    b = {k: jnp.asarray(v) for k, v in synthetic_batch(
                        cfg, BATCH, SEQ, epoch * STEPS + s).items()}
                    ckpt.state, m = jstep(ckpt.state, b)
                if sess.executed("train"):
                    jflor.log("loss", m["loss"])


@pytest.mark.parametrize("arch", NEW)
def test_port_run_passes_the_deferred_check_against_reference_logs(
        tmp_path, arch):
    cfg = JC.get_smoke(arch).replace(dtype="float32")
    init_state, _ = jax_build_train_step(cfg)
    jstate = jax.jit(init_state)(jax.random.PRNGKey(0))
    jrun = str(tmp_path / "reference")
    _jax_record(cfg, jrun, jstate)

    np_state = jax.tree_util.tree_map(np.array, jax.device_get(jstate))
    _, ts = build_train_step(cfg, device="cpu")
    run = str(tmp_path / "port")
    with flor.Session(run, mode="record",
                      record=flor.RecordSpec(adaptive=False)) as sess:
        _loop(sess, cfg, state_from_numpy(np_state, "cpu"), ts)

    rec, _ = jflor.run_logs(jrun)
    port_rec, _ = flor.run_logs(run)
    for check in (flor.deferred_check, jflor.deferred_check):
        res = check(rec, [port_rec])
        assert res.ok, res.anomalies
        assert res.compared == EPOCHS and res.hindsight_only == 0


def _launch(module, args, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=timeout)


# the launchers' --layers cut per arch: deepseek-v3 to its leading dense
# layer (an empty MoE stack, every checkpoint carrying its zero-byte
# leaves), zamba2 to one group and one trailing block
CUTS = {"deepseek-v3-671b": 1, "falcon-mamba-7b": 1, "zamba2-7b": 7,
        "seamless-m4t-large-v2": 1}


@pytest.mark.parametrize("arch", NEW)
def test_launchers_record_then_replay_check(tmp_path, arch):
    run = str(tmp_path / "run")
    args = ["--arch", arch, "--smoke", "--layers", str(CUTS[arch]),
            "--device", "cpu", "--batch", "2", "--seq", "32"]
    r = _launch("repro_torch.launch.train",
                args + ["--epochs", "2", "--steps-per-epoch", "2",
                        "--no-adaptive", "--run-dir", run])
    assert r.returncode == 0, r.stderr[-3000:]
    r = _launch("repro_torch.launch.replay",
                args + ["--run-dir", run, "--nworkers", "2", "--probe",
                        "train", "--check"])
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "deferred check: ok=True compared=2 hindsight=4" in r.stdout
