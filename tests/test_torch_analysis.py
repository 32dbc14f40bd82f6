"""The port's analysis tools (``repro_torch.launch``: hlo_analysis over a
traced aten graph, dryrun, roofline, reanalyze, mesh) against the
reference's on the CPU, at smoke widths.

- ``analyze`` on the reference test's six programs (tests/
  test_hlo_analysis.py) with its analytic expectations;
- ``model_flops`` on every applicable (arch, shape) cell, and
  ``build_rows`` on one results list, against the reference's;
- ``trace_cell``'s FLOPs for florbench-100m smoke train / prefill / decode
  against the reference's ``analyze`` of the same steps compiled on one
  CPU device;
- ``reanalyze_store`` / ``reanalyze_logs`` lines on stores recorded by
  each package.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

import repro_torch.configs as C
from repro_torch.launch import dryrun, reanalyze, roofline
from repro_torch.launch.hlo_analysis import analyze, analyze_graph
from repro_torch.models.layers import recomputed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_TRAIN = C.ShapeSpec("smoke_train", "train", 64, 2)
SMOKE_PREFILL = C.ShapeSpec("smoke_prefill", "prefill", 64, 2)
SMOKE_DECODE = C.ShapeSpec("smoke_decode", "decode", 64, 2)


def _analyze(fn, *shapes):
    gm = make_fx(fn, tracing_mode="fake")(*[torch.zeros(s) for s in shapes])
    return analyze_graph(gm)


# ---------------------------------------------- the reference's six cases --

def test_single_matmul_flops():
    r = _analyze(lambda x, y: x @ y, (128, 256), (256, 64))
    assert r["flops"] == 2 * 128 * 256 * 64


@pytest.mark.parametrize("trips", [4, 16])
def test_unrolled_loop_counts_every_trip(trips):
    def f(x, w):
        for i in range(w.shape[0]):
            x = x @ w[i]
        return x
    r = _analyze(f, (128, 128), (trips, 128, 128))
    expect = trips * 2 * 128 ** 3
    assert abs(r["flops"] - expect) / expect < 0.01, (trips, r["flops"])


def test_nested_loop_counts_both_levels():
    def f(x, w):
        for i in range(w.shape[0]):
            for j in range(w.shape[1]):
                x = x @ w[i, j]
        return x
    r = _analyze(f, (64, 64), (3, 5, 64, 64))
    expect = 3 * 5 * 2 * 64 ** 3
    assert abs(r["flops"] - expect) / expect < 0.01


def test_batched_dot_flops():
    r = _analyze(lambda x, y: torch.einsum("bik,bkj->bij", x, y),
                 (8, 32, 64), (8, 64, 16))
    assert r["flops"] == 2 * 8 * 32 * 64 * 16


def test_remat_sees_physical_compute():
    """The port's recompute (``layers.recomputed``, the counterpart of
    ``jax.checkpoint``) re-runs the forward inside the traced backward; both
    it and plain autograd fall within the analytic fwd+bwd envelope, and
    the recompute costs its forward's two matmuls more."""
    def g(w):
        h = w @ w
        return ((h @ h).sum(),)

    def remat(w):
        w = w.requires_grad_(True)
        (y,) = recomputed(g, w)
        return torch.autograd.grad(y, w)[0].sum()

    def plain(w):
        w = w.requires_grad_(True)
        return torch.autograd.grad(g(w)[0], w)[0].sum()

    one_mm = 2 * 64 ** 3
    r, r2 = _analyze(remat, (64, 64)), _analyze(plain, (64, 64))
    for rr in (r, r2):
        assert 0 < rr["flops"] <= 8 * one_mm, rr["flops"]
    assert r["flops"] == r2["flops"] + 2 * one_mm


def test_bytes_positive_and_bounded():
    r = _analyze(lambda x: (x + 1.0) * 2.0, (1024, 1024))
    nbytes = 1024 * 1024 * 4
    assert nbytes <= r["bytes"] <= 6 * nbytes


def test_views_cost_nothing_and_tuple_results_count():
    r = _analyze(lambda x: (x.view(64, 16), x.t()[None].expand(3, 64, 16)),
                 (16, 64))
    assert r["bytes"] == 0 and r["flops"] == 0
    # a reshape that must copy is a real op: read + write
    r = _analyze(lambda x: x.t().reshape(-1), (16, 64))
    assert r["bytes"] == 2 * 16 * 64 * 4
    r = _analyze(lambda x: torch.sort(x, dim=-1), (32, 32))
    assert r["bytes"] == 32 * 32 * (4 + 4 + 8)        # read + values + ids


# ---------------------------------------------------------- model_flops --

def test_model_flops_equal_reference_on_every_cell():
    from repro.launch import roofline as ref
    n = 0
    for arch in C.ARCHS:
        for shape in C.SHAPES:
            if not C.cell_applicable(arch, shape)[0]:
                continue
            assert roofline.model_flops(arch, shape) == \
                ref.model_flops(arch, shape), (arch, shape)
            n += 1
    assert n == 33


def _results():
    """One dry-run results list: two ok cells (compute- and memory-bound),
    a skipped one and an error."""
    def ok(arch, shape, flops, nbytes):
        return {"arch": arch, "shape": shape, "mesh": "single",
                "status": "ok", "ndev": 1, "flops_per_device": flops,
                "roofline": {"compute_s": flops / 989.4e12,
                             "memory_s": nbytes / 3.35e12,
                             "collective_s": 0.0}}
    return [ok("qwen3-14b", "train_4k", 3.1e17, 2.2e13),
            ok("mixtral-8x7b", "decode_32k", 3.4e12, 1.1e12),
            {"arch": "gemma-2b", "shape": "long_500k", "mesh": "single",
             "status": "skipped", "reason": "full-attention arch"},
            {"arch": "zamba2-7b", "shape": "train_4k", "mesh": "single",
             "status": "error", "error": "RuntimeError: boom"}]


def test_build_rows_match_reference():
    from repro.launch import roofline as ref
    from repro.launch.mesh import PEAK_FLOPS_BF16 as TPU_PEAK
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    got = roofline.build_rows(_results())
    want = ref.build_rows(_results())
    assert [r["status"] for r in got] == [r["status"] for r in want]
    for g, w in zip(got, want):
        if w["status"] != "ok":
            assert g["note"] == w["note"]
            continue
        for k in ("compute_s", "memory_s", "collective_s", "dominant",
                  "model_flops", "hlo_flops_global", "useful_ratio"):
            assert g[k] == w[k], k
        assert g["roofline_frac"] == pytest.approx(
            w["roofline_frac"] * TPU_PEAK / PEAK_FLOPS_BF16, rel=1e-12)
    assert [r["dominant"] for r in got[:2]] == ["compute", "memory"]
    md = roofline.to_markdown(got)
    assert "| qwen3-14b | train_4k |" in md and "skipped" in md


# ------------------------------------------- the smoke steps, traced --

def _reference_flops(kind: str, remat: bool = True) -> float:
    """The reference's ``analyze`` of its florbench-100m smoke step, jitted
    and compiled on one CPU device, at the port's smoke shapes."""
    import jax

    import repro.configs as RC
    from repro.launch.hlo_analysis import analyze as ref_analyze
    from repro.models import build_model
    from repro.models.params import shape_tree
    from repro.serve.step import build_decode_step, build_prefill_step
    from repro.train.step import build_train_step

    cfg = RC.get_smoke("florbench-100m").replace(remat=remat)
    model = build_model(cfg)
    if kind == "train":
        init_state, step = build_train_step(cfg)
        st = jax.eval_shape(init_state, jax.random.PRNGKey(0))
        low = jax.jit(step).lower(st, model.input_specs(SMOKE_TRAIN))
    else:
        p = shape_tree(model.param_spec(), cfg.dtype)
        if kind == "prefill":
            low = jax.jit(build_prefill_step(cfg, 64)).lower(
                p, model.input_specs(SMOKE_PREFILL))
        else:
            spec = model.input_specs(SMOKE_DECODE)
            low = jax.jit(build_decode_step(cfg)).lower(
                p, model.cache_spec(2, 64), spec["tokens"], spec["pos"])
    return ref_analyze(low.compile().as_text())["flops"]


@pytest.mark.parametrize("shape", [SMOKE_TRAIN, SMOKE_PREFILL, SMOKE_DECODE],
                         ids=lambda s: s.kind)
def test_traced_smoke_step_flops_match_reference(shape, tmp_path,
                                                 monkeypatch):
    """Measured (florbench-100m smoke, batch 2 x 64): prefill 218 628 096
    and decode 3 932 160 FLOPs in both packages, exactly. Train with
    ``remat=False``: the port 753 401 856 against the reference's
    753 659 904 (-0.034%): the reference picks the gold logit as a one-hot
    dot, 2 * 2 * 63 * 1024 = 258 048 FLOPs; the port gathers it. Train
    with the default ``remat=True``: the port 971 505 664 against the
    reference's 904 654 848 (+7.4%): both recompute each layer's forward
    in its backward, but XLA drops the recompute of the layer's last
    matmul (the MLP's output projection, 2 * 2 * 64 * 512 * 128 FLOPs a
    layer), whose result the backward does not read; the port's recompute
    runs the whole layer."""
    monkeypatch.chdir(tmp_path)                # results/fx/ goes there
    r = dryrun.run_cell("florbench-100m", shape, device="cpu", smoke=True)
    assert r["status"] == "ok" and (r["mesh"], r["ndev"]) == ("card", 1)
    got = r["flops_per_device"]
    if shape.kind == "train":
        off = dryrun.run_cell("florbench-100m", shape, device="cpu",
                              smoke=True, overrides={"remat": "false"})
        want = _reference_flops("train", remat=False)
        assert want - off["flops_per_device"] == 2 * 2 * 63 * 1024
        want = _reference_flops("train", remat=True)
        assert got - want == 4 * 2 * 2 * 64 * 512 * 128 - 2 * 2 * 63 * 1024
    else:
        want = _reference_flops(shape.kind)
        assert got == want
    mem = r["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert r["roofline"]["collective_s"] == 0.0


def test_trace_allocates_nothing_and_memory_is_counted():
    """A train trace holds fake tensors only; its memory numbers are the
    TrainState's bytes in and out."""
    from torch._subclasses.fake_tensor import FakeTensor
    cfg = C.get_smoke("florbench-100m")
    gm = dryrun.trace_cell("florbench-100m", SMOKE_TRAIN, device="cpu",
                           smoke=True)
    vals = [n.meta["val"] for n in gm.graph.nodes
            if isinstance(n.meta.get("val"), torch.Tensor)]
    assert vals and all(isinstance(v, FakeTensor) for v in vals)
    mem = dryrun.memory_analysis(gm)
    n = cfg.param_count()
    assert mem["argument_bytes"] == 3 * 4 * n + 4 + 8 + 2 * 64 * 4
    assert mem["output_bytes"] >= 3 * 4 * n
    assert mem["alias_bytes"] == 8                       # rng passes through


def test_mixtral_step_traces_and_keeps_its_bits(tmp_path, monkeypatch):
    """The MoE layer counts choices per expert into a fixed [E] buffer
    (bincount's length depends on the data, which a fake trace cannot
    know): the counts equal bincount's, a step gives the same bits twice,
    and ``trace_cell`` traces the step."""
    from repro_torch.data import synthetic_batch
    from repro_torch.models import moe
    from repro_torch.train.step import build_train_step
    from repro_torch.utils.pytree import tree_digest

    cfg = C.get_smoke("mixtral-8x7b")
    torch.manual_seed(0)
    x = torch.randn(64, cfg.d_model)
    p = {"router": torch.randn(cfg.d_model, cfg.moe.num_experts)}
    _, ids, _ = moe.route(cfg, p["router"], x)
    ids_f = ids.reshape(-1)
    counts = torch.zeros(cfg.moe.num_experts, dtype=torch.int64) \
        .index_add_(0, ids_f, torch.ones_like(ids_f))
    assert torch.equal(counts, torch.bincount(ids_f,
                                              minlength=cfg.moe.num_experts))
    init_state, step = build_train_step(cfg, device="cpu")
    b = synthetic_batch(cfg, 2, 32, 0, 0)
    outs = [tree_digest(step(init_state(0), b)[0]) for _ in range(2)]
    assert outs[0] == outs[1]
    monkeypatch.chdir(tmp_path)
    r = dryrun.run_cell("mixtral-8x7b", SMOKE_TRAIN, device="cpu",
                        smoke=True)
    assert r["status"] == "ok" and r["flops_per_device"] > 0


def test_cli_cells_errors_jobs_and_the_multi_pod_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = tmp_path / "r.json"
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "gemma-2b", "--shape", "long_500k",
                        "--device", "cpu", "--out", str(out)],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(out.read_text())[0]["status"] == "skipped"
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "gemma-2b", "--override", "nope=1",
                        "--shape", "train_4k", "--device", "cpu"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 1 and '"status": "error"' in p.stdout
    # rank 0 of the (2, 16, 16) production mesh, over a fake group
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--multi-pod", "--arch", "florbench-100m", "--smoke",
                        "--shape", "decode_32k", "--device", "cpu",
                        "--out", "multi.json"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    r, = json.loads((tmp_path / "multi.json").read_text())
    assert (r["mesh"], r["ndev"], r["status"]) == ("multi", 512, "ok")
    assert r["collective_counts"]["all-gather"] > 0
    # every shape of a reduced config, two cells side by side, then the
    # roofline of the results
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "florbench-100m", "--smoke", "--jobs", "2",
                        "--device", "cpu", "--out", "all.json"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads((tmp_path / "all.json").read_text())
    assert [r["status"] for r in res] == ["ok", "ok", "ok", "skipped"]
    assert all(r["smoke"] for r in res[:3])
    assert len(list((tmp_path / "results" / "fx").glob(
        "*_card_smoke.fx.zst"))) == 3
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline",
                        "--in", "all.json"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and "| florbench-100m | decode_32k |" in p.stdout


def test_reanalyze_json_rederives_rows_from_the_archived_graph(
        tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    r = dryrun.run_cell("florbench-100m", "decode_32k", device="cpu",
                        smoke=True)
    want = dict(r)
    r["flops_per_device"], r["roofline"] = -1.0, {}
    (tmp_path / "d.json").write_text(json.dumps([r]))
    reanalyze.reanalyze_json(str(tmp_path / "d.json"))
    got = json.loads((tmp_path / "d.json").read_text())[0]
    assert got["flops_per_device"] == want["flops_per_device"]
    assert got["roofline"] == want["roofline"]


def test_mesh_module_peaks_and_meshes():
    from repro_torch.launch import mesh
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.NVLINK_BW) == \
        (989.4e12, 3.35e12, 450e9)
    with pytest.raises(ValueError, match="init_distributed"):
        mesh.make_local_mesh(1, 1, device="cpu")
    # the production mesh starts a fake group of 512 ranks in its process:
    # built in a process of its own
    code = ("from repro_torch.launch.mesh import make_production_mesh\n"
            "m = make_production_mesh(multi_pod=True)\n"
            "print(m.mesh_dim_names, tuple(m.shape))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=dict(
                           os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert p.returncode == 0, p.stderr[-2000:]
    assert "('pod', 'data', 'model') (2, 16, 16)" in p.stdout


# ------------------------------------------------------------ reanalyze --

def _torch_record(run_dir, store, run_id, parent=None):
    import repro_torch.flor as flor
    lineage = flor.LineageSpec(store_root=store, run_id=run_id,
                               parent_run=parent)
    with flor.Session(run_dir, record=flor.RecordSpec(adaptive=False),
                      lineage=lineage) as sess:
        state = {"w": torch.arange(6.0, dtype=torch.float64)}
        if parent is not None:
            state = sess.warm_start("train", like=state)
        with sess.checkpointing(state=state) as ckpt:
            for e in sess.loop("epochs", range(3)):
                for _ in sess.loop("train", range(2)):
                    ckpt.state = {"w": ckpt.state["w"] + 1.0}
                sess.log("loss", float(ckpt.state["w"][0]))


def _jax_record(run_dir, store, run_id, parent=None):
    import repro.flor as jflor
    lineage = jflor.LineageSpec(store_root=store, run_id=run_id,
                                parent_run=parent)
    with jflor.Session(run_dir, record=jflor.RecordSpec(adaptive=False),
                       lineage=lineage) as sess:
        state = {"w": np.arange(6.0)}
        if parent is not None:
            state = sess.warm_start("train", like=state)
        with sess.checkpointing(state=state) as ckpt:
            for e in sess.loop("epochs", range(3)):
                for _ in sess.loop("train", range(2)):
                    ckpt.state = {"w": np.asarray(ckpt.state["w"]) + 1.0}
                sess.log("loss", float(np.asarray(ckpt.state["w"])[0]))


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_reanalyze_lines_equal_reference(package, tmp_path, capsys):
    from repro.launch import reanalyze as ref
    store = str(tmp_path / "store")
    rec = _jax_record if package == "repro" else _torch_record
    runs = [str(tmp_path / "base"), str(tmp_path / "ft")]
    rec(runs[0], store, "base")
    rec(runs[1], store, "ft", parent="base")
    rec(str(tmp_path / "solo"), None, None)
    runs.append(str(tmp_path / "solo"))
    capsys.readouterr()
    lines = []
    for mod in (ref, reanalyze):
        for rd in runs:
            mod.reanalyze_store(rd)
        mod.reanalyze_logs(store)
        lines.append(capsys.readouterr().out.splitlines())
    assert lines[0] == lines[1]
    assert len(lines[1]) == 3 + 3
    assert any("(parent base)" in ln for ln in lines[1])


def test_make_local_mesh_over_a_running_fleet(tmp_path):
    """Two gloo processes: ``make_local_mesh(2, 1)`` is a ("data",
    "model") DeviceMesh over them; a shape of another size raises."""
    from torch_fleet import run_fleet
    body = """
    def main(rank, world, args):
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(2, 1, device="cpu")
        assert mesh.mesh_dim_names == ("data", "model"), mesh
        assert tuple(mesh.mesh.shape) == (2, 1)
        try:
            make_local_mesh(1, 1, device="cpu")
        except ValueError as e:
            assert "needs 1 processes" in str(e)
        else:
            raise AssertionError("a (1, 1) mesh over 2 ranks")
        print("MESH_OK", rank)
    """
    out = run_fleet(body, 2, str(tmp_path))
    for rc, text in out:
        assert rc == 0 and "MESH_OK" in text, text[-2000:]
