"""The PyTorch port's copies of the two main-path examples, run on the CPU
with ``--device cpu``: examples/torch_quickstart.py records, then
examples/torch_hindsight_replay.py replays the run with its outer probe
only (every epoch restored) and with its inner probe (every epoch
re-executed). Each replay must pass the deferred check and end on the
recorded final state's digest, bit for bit. The serving example prints a
request's greedy tokens, and the two mesh examples relaunch themselves as
four-process gloo fleets."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS, STEPS = 2, 2


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                     script),
                        "--device", "cpu", "--epochs", str(EPOCHS),
                        "--steps-per-epoch", str(STEPS), *args],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def _digest(out):
    return re.search(r"final state digest: ([0-9a-f]{32})", out)[1]


@pytest.mark.parametrize("arch", ["florbench-100m", "mixtral-8x7b"])
def test_examples_record_then_replay_bit_identical(tmp_path, arch):
    run = str(tmp_path / "run")
    recorded = _digest(_run("torch_quickstart.py", "--arch", arch,
                            "--run-dir", run, "--no-adaptive"))
    for probe, compared, hindsight in (
            ([], 0, EPOCHS),                              # embed_norm only
            (["--probe-inner"], EPOCHS, EPOCHS * STEPS + EPOCHS)):
        out = _run("torch_hindsight_replay.py", "--arch", arch, "--run-dir",
                   run, *probe)
        assert (f"deferred correctness check: ok=True compared={compared} "
                f"hindsight_values={hindsight}") in out
        assert _digest(out) == recorded


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-7b"])
def test_serve_example_prints_greedy_tokens(arch):
    """examples/torch_serve.py on the CPU prints the tokens that the port's
    ``greedy_generate`` gives for the same config, seed and prompts."""
    import torch

    import repro_torch.configs as C
    from repro_torch.data import synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.serve.step import greedy_generate

    batch, prompt_len, steps = 2, 24, 6
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                     "torch_serve.py"),
                        "--device", "cpu", "--arch", arch, "--batch",
                        str(batch), "--prompt-len", str(prompt_len),
                        "--steps", str(steps)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    printed = re.search(r"tokens of request 0: (\[.*\])", r.stdout)[1]
    cfg = C.get_smoke(arch)
    n = torch.get_num_threads()
    torch.set_num_threads(2)            # as the example runs
    try:
        want = greedy_generate(cfg, build_model(cfg).init(0, "cpu"),
                               synthetic_batch(cfg, batch, prompt_len, 0),
                               steps=steps, max_len=prompt_len + steps)
    finally:
        torch.set_num_threads(n)
    assert printed == str(want[0].tolist())


@pytest.mark.slow
@pytest.mark.parametrize("script,ok", [
    ("torch_distributed_record.py", "DISTRIBUTED_RECORD_OK"),
    ("torch_sharded_replay.py", "deferred check: ok=True compared=4 "
                                "hindsight=16")])
def test_fleet_examples_on_cpu(tmp_path, script, ok):
    """The mesh examples relaunch themselves as gloo fleets: a (2, 2)
    record with a crash round, and a (2, 2) record restored on (1, 4),
    (4, 1) and unsharded."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    r = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                     script),
                        "--device", "cpu", "--run-dir", str(tmp_path / "r")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert ok in r.stdout
