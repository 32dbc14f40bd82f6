"""The port's record path end to end on the CPU: the launcher records and
restores (and resumes), ``flor.Session`` records with error-bounded slots
and the overlapped checkpoint pass, the package stands alone (no jax, no
reference package), its entry points refuse to run on the CPU unless asked
to, and what is not ported yet raises.
"""
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.configs as C
import repro_torch.flor as flor
from repro_torch.checkpoint import CheckpointStore
from repro_torch.data import synthetic_batch
from repro_torch.launch import train as launcher
from repro_torch.logging import read_stream
from repro_torch.train.step import build_train_step
from repro_torch.utils.pytree import keystr, tree_flatten_with_path

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
SMALL = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
         "--no-adaptive"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.reshape(-1).numpy().view(np.uint8)


def test_launcher_records_restores_and_resumes(tmp_path):
    run = str(tmp_path / "run")
    out = launcher.main(SMALL + ["--epochs", "2", "--steps-per-epoch", "2",
                                 "--run-dir", run])
    state = out["state"]
    assert int(state.step) == 4 and len(out["ckpt_stats"]) == 2
    store = CheckpointStore(os.path.join(run, "store"))
    assert sorted(store.list_keys()) == ["train_at_0.0", "train_at_1.0"]
    back = store.get_tree("train@1.0", like={"state": state})
    got, _ = tree_flatten_with_path(back)
    want, _ = tree_flatten_with_path({"state": state})
    assert [keystr(p) for p, _ in got] == [keystr(p) for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
    # crash-restart: a longer run on the same dir restores epoch 1 and
    # trains only the missing epoch
    out2 = launcher.main(SMALL + ["--epochs", "3", "--steps-per-epoch", "2",
                                  "--run-dir", run])
    assert int(out2["state"].step) == 6
    assert len(out2["ckpt_stats"]) == 1
    rows = read_stream(os.path.join(run, "logs", "record.jsonl"))
    assert [r["key"] for r in rows].count("loss") == 3


def test_session_error_bounds_with_overlap(tmp_path):
    """The q4/q8 slots of a Session restore within their bounds, every
    other leaf bit for bit, through the overlapped (writer-thread) pass."""
    cfg = C.get_smoke("florbench-100m")
    init_state, step = build_train_step(cfg, device="cpu")
    state = init_state(0)
    spec = flor.RecordSpec(adaptive=False, ckpt_overlap=True,
                           ckpt_error_bounds={"mu": 1e-2, "nu": 1e-3})
    with flor.Session(str(tmp_path / "run"), record=spec) as sess:
        with sess.checkpointing(state=state) as ckpt:
            for epoch in sess.loop("epochs", range(2)):
                for s in sess.loop("train", range(2)):
                    ckpt.state, m = step(ckpt.state, synthetic_batch(
                        cfg, 2, 32, epoch * 2 + s))
                flor.log("loss", m["loss"])
        store = sess.ctx.store
    state = ckpt.state
    man = store.resolve_manifest("train@1.0")
    encs = {e for lf in man["leaves"] for e in (lf.get("enc") or ["raw"])}
    assert encs & {"q4", "q4+z"}, encs
    back = store.get_tree("train@1.0", like={"state": state})
    got, _ = tree_flatten_with_path(back)
    want, _ = tree_flatten_with_path({"state": state})
    for (p, a), (_, b) in zip(got, want):
        path = keystr(p)
        if ".mu" in path or ".nu" in path:
            atol = 1e-2 if ".mu" in path else 1e-3
            assert float((a - b).abs().max()) <= atol, path
        else:
            assert np.array_equal(_bits(a), _bits(b)), path


def test_package_imports_neither_jax_nor_reference():
    """Import every module of the port in a fresh interpreter: neither jax
    nor the reference package may end up in sys.modules."""
    root = os.path.join(SRC, "repro_torch")
    mods = sorted(
        "repro_torch." + os.path.relpath(f, root)[:-3].replace(os.sep, ".")
        .removesuffix(".__init__")
        for f in glob.glob(os.path.join(root, "**", "*.py"), recursive=True))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=SRC,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert len(mods) >= 49
    assert {"repro_torch.launch.replay", "repro_torch.replay.plan",
            "repro_torch.kernels.flash_attention"} <= set(mods)


def test_launcher_without_device_flag_refuses_cpu(tmp_path):
    """With no card, the launcher's cuda default fails instead of running
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default would run on it")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--epochs", "1", "--steps-per-epoch", "1",
         "--run-dir", str(tmp_path / "run")],
        env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert not os.path.exists(str(tmp_path / "run"))


def test_unported_modes_raise(tmp_path):
    """Warm start and mesh-sharded / multi-process runs are later slices:
    they raise instead of running something else."""
    with flor.Session(str(tmp_path / "w")) as sess:
        with pytest.raises(NotImplementedError, match="warm_start"):
            sess.warm_start("train")
    for kw in ({"mesh": object()}, {"distributed": True}):
        with pytest.raises(NotImplementedError, match="items 12-13"):
            flor.FlorContext(str(tmp_path / "m"), "record", **kw)
    with pytest.raises(NotImplementedError, match="items 12-13"):
        flor.FlorContext(str(tmp_path / "m"), "replay", mesh=object())
