"""The port's hindsight replay end to end on the CPU: record -> replay
through ``flor.Session(mode="replay")``, the planner and scheduler, the
replay launcher, and the deferred check; then replay across packages (a run
recorded by the reference package replayed by the port, and the reverse).

The model is the tiny florbench config of the reference package's own
record/replay tests, on ``device="cpu"``. Within the port, replay must give
the recorded final state bit for bit. Across packages the deferred check
holds the replayed losses to the record's at its own rtol of 1e-4, on f32
compute: the two frameworks sum in other orders, and bf16 would round at
other places. Cross-package replays start at epoch 1 (restored from epoch
0's checkpoint), since ``jax.random`` init is not reproducible in torch;
the train step never draws from ``state.rng``.
"""
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
from repro.data import synthetic_batch as jax_synthetic_batch
from repro.train.step import build_train_step as jax_build_train_step
from repro_torch.checkpoint import CheckpointStore
from repro_torch.data import synthetic_batch
from repro_torch.replay import balanced_shares
from repro_torch.train.step import build_train_step
from repro_torch.utils.pytree import tree_leaves

EPOCHS, STEPS = 5, 2
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
            vocab_size=512, head_dim=32)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = C.get_smoke("florbench-100m").replace(**TINY)
    init_state, train_step = build_train_step(cfg, device="cpu")
    return cfg, init_state, train_step


def _loop(tiny, run_dir, mode="record", probe=False, record=None,
          replay=None, epochs=EPOCHS):
    """The record/replay script: main loop "epochs", inner block "train"
    over the checkpointed state; `probe` adds a hindsight flor.log."""
    cfg, init_state, ts = tiny
    state = init_state(0)
    with flor.Session(run_dir, mode=mode, record=record,
                      replay=replay) as sess:
        with sess.checkpointing(state=state) as ckpt:
            for epoch in sess.loop("epochs", range(epochs)):
                for s in sess.loop("train", range(STEPS)):
                    ckpt.state, m = ts(ckpt.state, synthetic_batch(
                        cfg, 2, 32, epoch * STEPS + s))
                    if probe:
                        flor.log("probe_gnorm", m["grad_norm"])
                if sess.executed("train"):
                    flor.log("loss", m["loss"])
    return ckpt.state


def _record(tiny, run_dir, **kw):
    return _loop(tiny, run_dir, record=flor.RecordSpec(adaptive=False), **kw)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.reshape(-1).numpy().view(np.uint8)


def _states_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and np.array_equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _check(run_dir, rows=None):
    rec, reps = flor.run_logs(run_dir)
    return flor.deferred_check(rec, reps if rows is None else rows)


# ------------------------------------------------------------- in-package
def test_record_then_skip_replay_exact(tmp_path, tiny):
    """No probed block: every epoch restores its checkpoint; the final
    state is the recorded one, bit for bit."""
    run = str(tmp_path / "run")
    final = _record(tiny, run)
    out = _loop(tiny, run, mode="replay",
                replay=flor.ReplaySpec(probed=set()))
    assert _states_equal(final, out)
    assert _check(run).ok


def test_probed_replay_reexecutes_and_matches(tmp_path, tiny):
    run = str(tmp_path / "run")
    final = _record(tiny, run)
    out = _loop(tiny, run, mode="replay", probe=True,
                replay=flor.ReplaySpec(probed={"train"}))
    assert _states_equal(final, out)
    res = _check(run)
    assert res.ok and res.hindsight_only == EPOCHS * STEPS
    assert res.compared == EPOCHS


@pytest.mark.parametrize("init_mode", ["strong", "weak"])
@pytest.mark.parametrize("nworkers", [2, 3])
def test_parallel_replay_partitions_match(tmp_path, tiny, init_mode,
                                          nworkers):
    """The contiguous pid/nworkers split (a deprecation shim): every
    worker's probed epochs match the record, and the last partition ends
    at the recorded final state."""
    run = str(tmp_path / "run")
    final = _record(tiny, run)
    last = None
    for pid in range(nworkers):
        with pytest.warns(flor.FlorDeprecationWarning):
            last = _loop(tiny, run, mode="replay",
                         replay=flor.ReplaySpec(pid=pid, nworkers=nworkers,
                                                init_mode=init_mode,
                                                probed={"train"}))
    assert _states_equal(final, last)
    res = _check(run)
    assert res.ok, res.anomalies
    assert res.compared == EPOCHS


def test_weak_init_uses_nearest_checkpoint_under_sparsity(tmp_path, tiny):
    """A sparse record (as the adaptive controller leaves it: here epochs
    2-4 lost their checkpoints) must make weak init re-execute the gap from
    the nearest checkpoint instead of starting from garbage."""
    run = str(tmp_path / "run")
    final = _record(tiny, run)
    store = CheckpointStore(os.path.join(run, "store"))
    for e in (2, 3, 4):
        store.delete_manifest(f"train@{e}.0")
    assert sorted(store.list_keys()) == ["train_at_0.0", "train_at_1.0"]
    with pytest.warns(flor.FlorDeprecationWarning):
        out = _loop(tiny, run, mode="replay",
                    replay=flor.ReplaySpec(pid=1, nworkers=2,
                                           init_mode="weak",
                                           probed={"train"}))
    assert _states_equal(final, out)
    # init restored epoch 1 and re-executed epoch 2; work ran epochs 3-4
    rows = flor.FingerprintLog.read(flor.run_logs(run)[1][0])
    assert [r["epoch"] for r in rows if r["key"] == "loss"] == [2, 3, 4]


def test_deferred_check_catches_corruption(tmp_path, tiny):
    """Tamper with a stored checkpoint: a replay that weak-inits from it
    must produce fingerprint anomalies (paper section 5.2.2)."""
    run = str(tmp_path / "run")
    _record(tiny, run)
    store = CheckpointStore(os.path.join(run, "store"))
    man = store.resolve_manifest("train@2.0")
    victim = man["leaves"][2]
    z = np.zeros(int(np.prod(victim["shape"]) or 1),
                 np.dtype(victim["dtype"]))
    h, _, _ = store.put_chunk(z.tobytes())
    victim["chunks"] = [h] * len(victim["chunks"])
    store.put_manifest(man)
    with pytest.warns(flor.FlorDeprecationWarning):
        _loop(tiny, run, mode="replay",
              replay=flor.ReplaySpec(pid=1, nworkers=2, init_mode="weak",
                                     probed={"train"}))
    res = _check(run)
    assert not res.ok and len(res.anomalies) >= 1


def test_sampling_replay_random_access(tmp_path, tiny):
    """Paper section 8: probe a sampled subset of epochs; each re-executes
    from the nearest checkpoint and its values match the record."""
    run = str(tmp_path / "run")
    _record(tiny, run)
    cfg, init_state, ts = tiny
    sampled = {}
    with flor.Session(run, mode="replay",
                      replay=flor.ReplaySpec(probed={"train"})) as sess:
        with sess.checkpointing(state=init_state(0)) as ckpt:
            for epoch in flor.sampling_generator(range(EPOCHS),
                                                 sample=[1, 3]):
                for s in sess.loop("train", range(STEPS)):
                    ckpt.state, m = ts(ckpt.state, synthetic_batch(
                        cfg, 2, 32, epoch * STEPS + s))
                if sess.ctx.replay_phase == "exec":
                    sampled[epoch] = float(m["loss"])
                    flor.log("loss", m["loss"])
    assert set(sampled) == {1, 3}
    res = _check(run)
    assert res.ok and res.compared == 2, res.anomalies


def _planned_worker(tiny, run, pid, visits, probe=True):
    _loop(tiny, run, mode="replay", probe=probe,
          replay=flor.ReplaySpec(pid=pid, probed={"train"},
                                 segments=visits))


def test_planned_two_worker_merge_identical_to_one(tmp_path, tiny):
    """Plan -> LPT shares -> per-worker visit lists -> merge by plan
    segment: two workers' merged log equals one worker's, row for row."""
    run = str(tmp_path / "run")
    _record(tiny, run)
    plan = flor.build_plan(run, probed={"train"})
    assert len(plan.exec_segments()) == EPOCHS
    _planned_worker(tiny, run, 0, plan.visits_for())
    one = flor.merge_replay_logs(run, [("replay_p0", plan.epochs)])
    shares = balanced_shares(plan.work_segments(), 2)
    owners = []
    for i, share in enumerate(shares):
        _planned_worker(tiny, run, 10 + i, plan.visits_for(share))
        owners.append((f"replay_p{10 + i}", [s.epoch for s in share]))
    two = flor.merge_replay_logs(run, owners, out_path=True)
    assert two == one and len(one) == EPOCHS * (STEPS + 1)
    assert os.path.exists(os.path.join(run, "logs", "merged_replay.jsonl"))
    rec, _ = flor.run_logs(run)
    res = flor.deferred_check(rec, two)
    assert res.ok and res.hindsight_only == EPOCHS * STEPS


# ---------------------------------------------------------------- launcher
LAUNCH = ["--smoke", "--batch", "2", "--seq", "32"]


def _launch(module, args, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_replay_launcher_end_to_end_on_cpu(tmp_path):
    run = str(tmp_path / "run")
    r = _launch("repro_torch.launch.train",
                LAUNCH + ["--device", "cpu", "--epochs", "3",
                          "--steps-per-epoch", "2", "--no-adaptive",
                          "--run-dir", run])
    assert r.returncode == 0, r.stderr[-3000:]
    r = _launch("repro_torch.launch.replay",
                LAUNCH + ["--device", "cpu", "--run-dir", run,
                          "--nworkers", "2", "--probe", "train", "--check"])
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "plan: 3/3 epochs re-execute" in r.stdout
    assert "deferred check: ok=True compared=3 hindsight=6" in r.stdout
    assert "straggler speculation: on" in r.stdout    # measured default
    assert os.path.exists(os.path.join(run, "replay.plan.json"))


@pytest.fixture(scope="module")
def launcher_run(tmp_path_factory):
    """A 3 x 2-step run recorded by the record launcher on the CPU."""
    run = str(tmp_path_factory.mktemp("launcher") / "run")
    r = _launch("repro_torch.launch.train",
                LAUNCH + ["--device", "cpu", "--epochs", "3",
                          "--steps-per-epoch", "2", "--no-adaptive",
                          "--run-dir", run])
    assert r.returncode == 0, r.stderr[-3000:]
    return run


def _probe_added_source(tmp_path) -> str:
    """The record launcher's script with one hindsight log line added in
    its "train" block, as a user would edit it after the run."""
    import repro_torch.launch.train as script
    with open(script.__file__) as f:
        src = f.read()
    step = "ckpt.state, m = ts(ckpt.state, b)\n"
    indent = src.split(step)[0].rsplit("\n", 1)[1]
    assert src.count(step) == 1 and not indent.strip()
    path = tmp_path / "train_edited.py"
    path.write_text(src.replace(step, step + indent
                                + 'flor.log("gnorm", m["grad_norm"])\n'))
    return str(path)


CHECKED = "deferred check: ok=True compared=3 hindsight=6"


@pytest.mark.parametrize("option", ["plan-only", "partition", "hosts",
                                    "tasks-per-worker", "straggler-factor",
                                    "probe-auto"])
def test_replay_launcher_options(tmp_path, launcher_run, option):
    """Each scheduling and planning option of the launcher, one replay of
    the same recorded run each (on a copy of it)."""
    import shutil
    run = str(tmp_path / "run")
    shutil.copytree(launcher_run, run)
    common = LAUNCH + ["--device", "cpu", "--run-dir", run,
                       "--nworkers", "2"]
    args, want = {
        "plan-only": (["--probe", "train", "--plan-only"],
                      ["plan: 3/3 epochs re-execute", "  task 1: epochs"]),
        "partition": (["--probe", "train", "--partition", "contiguous",
                       "--check"],
                      ["parallel replay (planned, contiguous): 2 workers / "
                       "2 tasks", CHECKED]),
        "hosts": (["--probe", "train", "--hosts", "2", "--check"],
                  [", host 0)", ", host 1)", CHECKED]),
        "tasks-per-worker": (["--probe", "train", "--tasks-per-worker", "2",
                              "--check"],
                             ["2 workers / 3 tasks", CHECKED]),
        "straggler-factor": (["--probe", "train", "--straggler-factor", "0",
                              "--check"], [CHECKED]),
        "probe-auto": (["--probe", "auto", "--current-src",
                        _probe_added_source(tmp_path), "--check"],
                       ["probe auto: 1 added line(s) -> inner blocks "
                        "['train']", CHECKED]),
    }[option]
    r = _launch("repro_torch.launch.replay", common + args)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    for w in want:
        assert w in r.stdout, (w, r.stdout[-3000:])
    merged = os.path.join(run, "logs", "merged_replay.jsonl")
    assert os.path.exists(merged) == (option != "plan-only")
    if option == "straggler-factor":
        assert "straggler speculation" not in r.stdout


def test_replay_launcher_without_device_flag_refuses_cpu(tmp_path):
    """With no card, the launcher's cuda default fails instead of
    replaying on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default would run on it")
    run = str(tmp_path / "run")
    os.makedirs(run)
    r = _launch("repro_torch.launch.replay",
                LAUNCH + ["--run-dir", run, "--probe", "train"])
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert not os.path.exists(os.path.join(run, "replay.plan.json"))


def test_multi_process_replay_is_not_ported(tmp_path, launcher_run,
                                            capsys):
    """``--num-processes 2`` runs: each host derives the same plan and
    host partition and takes its own share (plan only here; the fleet's
    full replay and merge are in test_torch_dist_record.py)."""
    import shutil

    from repro_torch.launch import replay as launcher
    run = str(tmp_path / "run")
    shutil.copytree(launcher_run, run)
    for host in (1, 0):
        launcher.main(LAUNCH + ["--device", "cpu", "--run-dir", run,
                                "--nworkers", "2", "--probe", "train",
                                "--num-processes", "2", "--process-id",
                                str(host), "--plan-only"])
    out = capsys.readouterr().out
    assert "host 1/2: executing 1/2 task(s)" in out
    assert "host 0/2: executing 1/2 task(s)" in out
    assert os.path.exists(os.path.join(run, "replay.plan.json"))


# ----------------------------------------------------------- cross-package
XEPOCHS = 3
XSEGMENTS = [(0, "init")] + [(e, "exec") for e in range(1, XEPOCHS)]


@pytest.fixture(scope="module")
def f32_pair():
    """The tiny config in f32 compute, for both packages."""
    jcfg = JC.get_smoke("florbench-100m").replace(dtype="float32", **TINY)
    cfg = C.get_smoke("florbench-100m").replace(dtype="float32", **TINY)
    init_state, train_step = build_train_step(cfg, device="cpu")
    jinit, jstep = jax_build_train_step(jcfg)
    return (cfg, init_state, train_step), (jcfg, jax.jit(jinit),
                                           jax.jit(jstep))


def _jax_loop(jtiny, run_dir, mode, replay=None):
    cfg, init_state, ts = jtiny
    kw = {"record": jflor.RecordSpec(adaptive=False)} if mode == "record" \
        else {"replay": replay}
    state = init_state(jax.random.PRNGKey(0))
    with jflor.Session(run_dir, mode=mode, **kw) as sess:
        with sess.checkpointing(state=state) as ckpt:
            for epoch in sess.loop("epochs", range(XEPOCHS)):
                for s in sess.loop("train", range(STEPS)):
                    b = {k: jnp.asarray(v) for k, v in jax_synthetic_batch(
                        cfg, 2, 32, epoch * STEPS + s).items()}
                    ckpt.state, m = ts(ckpt.state, b)
                    if mode == "replay":
                        jflor.log("probe_gnorm", m["grad_norm"])
                if sess.executed("train"):
                    jflor.log("loss", m["loss"])


def test_reference_recorded_run_replays_in_the_port(tmp_path, f32_pair):
    tiny, jtiny = f32_pair
    run = str(tmp_path / "run")
    _jax_loop(jtiny, run, "record")
    _loop(tiny, run, mode="replay", probe=True, epochs=XEPOCHS,
          replay=flor.ReplaySpec(probed={"train"}, segments=XSEGMENTS))
    res = _check(run)
    assert res.ok, res.anomalies
    assert res.compared == XEPOCHS - 1
    assert res.hindsight_only == (XEPOCHS - 1) * STEPS


def test_port_recorded_run_replays_in_the_reference(tmp_path, f32_pair):
    tiny, jtiny = f32_pair
    run = str(tmp_path / "run")
    _record(tiny, run, epochs=XEPOCHS)
    _jax_loop(jtiny, run, "replay",
              replay=jflor.ReplaySpec(probed={"train"}, segments=XSEGMENTS))
    rec, reps = jflor.run_logs(run)
    res = jflor.deferred_check(rec, reps)
    assert res.ok, res.anomalies
    assert res.compared == XEPOCHS - 1
    assert res.hindsight_only == (XEPOCHS - 1) * STEPS
