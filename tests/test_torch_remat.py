"""Per-layer activation checkpointing (``cfg.remat``, ``cfg.remat_policy``)
in the port's train step, against the reference's ``_remat``.

- ``remat=False``, ``"nothing"`` (and ``"full"``, which the reference
  treats as "nothing") and ``"dots"`` give the same loss bits and the same
  updated TrainState bits on one process, for every family's smoke arch:
  the recompute runs the same ops on the same inputs.
- The port with ``remat=False`` and with ``"dots"`` matches the reference
  with the same setting (its own ``build_train_step`` on
  ``cfg.replace(...)``) at the f32 tolerances of
  ``tests/test_torch_model.py``.
- The counterpart of ``tests/test_hlo_analysis.py::
  test_remat_sees_physical_compute``: a traced florbench smoke step holds
  less live memory the less it saves (off > "dots" > "nothing") and
  counts more FLOPs the more it recomputes ("nothing" > "dots" > off), and
  ``dryrun --override remat=false`` traces another graph.
- Under a mesh each recomputed layer gathers its own FSDP weights again
  in its backward: one more all-gather of each layer's weights, and no
  layer's gathered weights kept between the passes.
"""
import gc
import json
import os
import subprocess
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as C
from repro.models import build_model as jax_build_model
from repro.train.step import build_train_step as jax_build_train_step
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import synthetic_batch
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.models.layers import batch_free
from repro_torch.train.state import state_from_numpy
from repro_torch.train.step import build_train_step
from repro_torch.utils.pytree import (tree_digest, tree_flatten, tree_leaves,
                                      tree_unflatten)
from test_torch_model import (GRAD_RTOL_F32, LOSS_RTOL_F32, PARAM_ATOL_F32,
                              UPDATE_RTOL_F32)
from torch_fleet import SRC, _env

FAMILIES = ["florbench-100m", "mixtral-8x7b", "deepseek-v3-671b",
            "falcon-mamba-7b", "zamba2-7b", "seamless-m4t-large-v2",
            "llava-next-mistral-7b"]
SETTINGS = {"off": {"remat": False}, "nothing": {},
            "full": {"remat_policy": "full"},
            "dots": {"remat_policy": "dots"}}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_batch_free_follows_dot_general():
    for eq in ("bsd,df->bsf", "bsd,dnh->bsnh", "bsnh,nhd->bsd",
               "td,de->te", "bsf,fd->bsd"):
        assert batch_free(eq), eq
    for eq in ("bhqd,bhkd->bhqk", "ecd,edf->ecf", "bqngh,bknh->bngqk",
               "bqn,bsn->bqs"):
        assert not batch_free(eq), eq


# chunked: the attention's chunk recompute nested inside the layer's
# (falcon-mamba-7b has no attention layer)
BIT_CASES = [(a, False) for a in FAMILIES] + \
    [(a, True) for a in FAMILIES if a != "falcon-mamba-7b"]


@pytest.mark.parametrize("arch,chunked", BIT_CASES,
                         ids=[a + ("-chunked" if c else "")
                              for a, c in BIT_CASES])
def test_remat_settings_give_the_same_bits(arch, chunked):
    """One train step from one state and batch under every setting: the
    same loss bits and the same updated TrainState bits."""
    over = {"attention_impl": "chunked", "attention_chunk": 8} \
        if chunked else {}
    base = C.get_smoke(arch).replace(**over)
    got = {}
    for name, setting in SETTINGS.items():
        cfg = base.replace(**setting)
        init, step = build_train_step(cfg, device="cpu")
        new, m = step(init(0), synthetic_batch(cfg, 2, 32, 0))
        got[name] = (m["loss"].view(torch.int32).item(), tree_digest(new),
                     {k: v.item() for k, v in m.items()})
    want = got["off"]
    for name, g in got.items():
        assert g[:2] == want[:2], (name, g[2], want[2])
        assert g[2] == want[2], name


def _reference(cfg, batch=2, seq=32):
    init_state, _ = jax_build_train_step(cfg)
    jstate = jax.jit(init_state)(jax.random.PRNGKey(0))
    np_state = jax.tree_util.tree_map(np.array, jax.device_get(jstate))
    return jstate, np_state, synthetic_batch(cfg, batch, seq, step=3, seed=0)


@pytest.mark.parametrize("setting", ["off", "dots"])
@pytest.mark.parametrize("arch", ["florbench-100m", "mixtral-8x7b",
                                  "zamba2-7b", "seamless-m4t-large-v2"])
def test_f32_remat_setting_matches_reference(arch, setting):
    """The port's loss, gradients and step with ``setting`` against the
    reference's with the same setting, in f32."""
    cfg = JC.get_smoke(arch).replace(dtype="float32", **SETTINGS[setting])
    jstate, np_state, b = _reference(cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jax_build_model(cfg).loss, has_aux=True))(jstate.params, jb)
    pcfg = C.get_smoke(arch).replace(dtype="float32", **SETTINGS[setting])
    state = state_from_numpy(np_state, "cpu")
    leaves, treedef = tree_flatten(state.params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss, _ = build_model(pcfg).loss(tree_unflatten(treedef, leaves),
                                     {k: torch.from_numpy(v)
                                      for k, v in b.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL_F32)
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        jg = np.asarray(jg)
        scale = max(float(np.abs(jg).max()), 1e-30)
        assert np.abs(g.numpy() - jg).max() <= GRAD_RTOL_F32 * scale
    _, jstep = jax_build_train_step(cfg)
    jnew, jm = jax.jit(jstep)(jstate, jb)
    _, step = build_train_step(pcfg, device="cpu")
    new, m = step(state, b)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL_F32)
    for a, ja, old in zip(tree_leaves(new.params),
                          jax.tree_util.tree_leaves(jnew.params),
                          tree_leaves(state.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(ja),
                                   atol=PARAM_ATOL_F32, rtol=0)
        old = old.numpy().astype(np.float64)
        d = a.numpy().astype(np.float64) - old
        jd = np.asarray(ja, np.float64) - old
        assert np.linalg.norm(d - jd) <= UPDATE_RTOL_F32 * np.linalg.norm(jd)


def test_remat_trace_orders_memory_and_flops(tmp_path, monkeypatch):
    """A florbench smoke step at 8 x 256 tokens, where the layers'
    activations outweigh the state's temporaries. Measured: temp_bytes
    126 416 748 (off) > 49 018 732 ("dots") > 35 419 148 ("nothing");
    FLOPs 14 489 223 168 (off) < 15 562 964 992 ("dots") <
    18 784 190 464 ("nothing")."""
    monkeypatch.chdir(tmp_path)
    shape = ShapeSpec("t", "train", 256, 8)
    r = {name: dryrun.run_cell("florbench-100m", shape, device="cpu",
                               smoke=True, overrides=over)
         for name, over in (("off", {"remat": "false"}), ("nothing", {}),
                            ("dots", {"remat_policy": "dots"}))}
    mem = {k: v["memory"]["temp_bytes"] for k, v in r.items()}
    flops = {k: v["flops_per_device"] for k, v in r.items()}
    print("temp_bytes", mem, "flops", flops)
    assert mem["off"] > mem["dots"] > mem["nothing"]
    assert flops["nothing"] > flops["dots"] > flops["off"]


def test_dryrun_override_remat_changes_the_trace(tmp_path, monkeypatch):
    """``--override remat=false`` on the CLI traces the step without the
    recompute: fewer FLOPs and nodes, more live memory, its own file."""
    monkeypatch.chdir(tmp_path)
    rows = {}
    for extra in ([], ["--override", "remat=false"]):
        out = tmp_path / f"d{len(extra)}.json"
        with pytest.raises(SystemExit) as done:
            dryrun.main(["--arch", "florbench-100m", "--shape", "train_4k",
                         "--smoke", "--device", "cpu", "--out", str(out),
                         *extra])
        assert done.value.code == 0
        rows[bool(extra)] = json.loads(out.read_text())[0]
    on, off = rows[False], rows[True]
    assert on["status"] == off["status"] == "ok"
    assert off["flops_per_device"] < on["flops_per_device"]
    assert off["graph_nodes"] < on["graph_nodes"]
    assert off["memory"]["temp_bytes"] > on["memory"]["temp_bytes"]
    assert sorted(os.listdir(tmp_path / "results" / "fx")) == [
        "florbench-100m_train_4k_card_smoke.fx.zst",
        "florbench-100m_train_4k_card_smoke__remat-false.fx.zst"]


MESH = """
import json, os, sys
os.chdir(sys.argv[1])
import repro_torch.configs as C
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh
m = make_fake_mesh((2, 4), ("data", "model"))
out = {}
for layers in (2, 4):
    for name, over in (("off", {"remat": "false"}), ("nothing", {}),
                       ("dots", {"remat_policy": "dots"})):
        cfg = C.with_layers(C.get_smoke("florbench-100m"), layers)
        dryrun.get_smoke = lambda arch, cfg=cfg: cfg
        r = dryrun.run_cell("florbench-100m", ShapeSpec("t", "train", 256, 8),
                            device="cpu", smoke=True, device_mesh=m,
                            overrides=over)
        out[f"{name}{layers}"] = [r["collective_counts"]["all-gather"],
                                  r["memory"]["temp_bytes"]]
print("MESH", json.dumps(out))
"""


def test_sharded_remat_gathers_each_layer_again(tmp_path):
    """A florbench smoke step traced on a fake (2, 4) mesh at 2 and 4
    layers: each layer's forward gathers its FSDP weights (the count
    grows with depth), and with remat each layer's backward gathers them
    once more inside its recompute (the same count again), under either
    policy; live memory falls with remat."""
    p = subprocess.run([sys.executable, "-c", MESH, str(tmp_path)],
                       env=_env(), capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads([x for x in p.stdout.splitlines()
                      if x.startswith("MESH")][-1][5:])
    print(got)
    per_layer = (got["off4"][0] - got["off2"][0]) // 2
    assert per_layer > 0
    for layers in (2, 4):
        off = got[f"off{layers}"]
        for name in ("nothing", "dots"):
            on = got[f"{name}{layers}"]
            assert on[0] - off[0] == layers * per_layer, (name, layers, got)
            assert on[1] < off[1], (name, layers, got)


def test_remat_step_frees_the_old_state_at_once():
    """``test_train_step_frees_the_old_state_at_once`` under "dots": the
    matmul outputs a layer keeps leave no reference cycle behind."""
    cfg = C.get_smoke("mixtral-8x7b").replace(remat_policy="dots")
    init_state, step = build_train_step(cfg, device="cpu")
    st = init_state(0)
    alive = [weakref.ref(x) for x in tree_leaves(st)
             if x.is_floating_point()]
    gc.collect()
    gc.disable()
    try:
        st, _ = step(st, synthetic_batch(cfg, 2, 48, 0))
        assert not any(r() is not None for r in alive)
    finally:
        gc.enable()


def test_serving_ignores_remat():
    """Prefill and decode run without gradients: the setting changes
    neither by a bit."""
    from repro_torch.serve.step import build_decode_step, build_prefill_step
    base = C.get_smoke("zamba2-7b")
    params = build_model(base).init(0, "cpu")
    batch = {"tokens": torch.from_numpy(
        synthetic_batch(base, 2, 16, 0)["tokens"])}
    outs = []
    for setting in SETTINGS.values():
        cfg = base.replace(**setting)
        caches, logits = build_prefill_step(cfg, 24)(params, batch)
        tok, logits2, caches2 = build_decode_step(cfg)(
            params, caches, logits.argmax(-1)[:, None].to(torch.int32), 16)
        outs.append(tree_digest([caches, logits, tok, logits2, caches2]))
    assert len(set(outs)) == 1
