"""The production mesh and the dry run on it.

``launch/mesh.py::make_production_mesh`` builds the reference's (16, 16)
("data", "model") and (2, 16, 16) ("pod", "data", "model") meshes over a
fake process group of 512 ranks in one process, and ``launch/dryrun.py``
traces rank 0's program of a cell on them (``--multi-pod``,
``--both-meshes``). A fake group stays up in its process, so every case
here runs in a subprocess of its own.

Checked: the meshes' shapes and names; the refusal while a real group is
up; the traced forms of the collectives (``ppermute`` among them) counted
by ``hlo_analysis``; a smoke cell of every family traced on both meshes
with ``status: ok``; and, on a fake (2, 4) mesh, the per-device FLOPs of
florbench-100m's smoke train and decode cells within 5% of the
reference's compiled per-device FLOPs on 8 forced host devices over an
``Auto``-axis mesh (collective bytes printed beside the reference's)."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from torch_fleet import _env


def _run(code: str, timeout: float = 300):
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       env=_env(), capture_output=True, text=True,
                       timeout=timeout)
    assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-3000:])
    return p.stdout


def test_production_meshes_are_the_references():
    out = _run("""
        import json
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.parallel.sharding import mesh_axis_sizes
        s = make_production_mesh()
        m = make_production_mesh(multi_pod=True)
        print(json.dumps([mesh_axis_sizes(s), mesh_axis_sizes(m),
                          s.size(), m.size(),
                          m.get_group("model").size()]))
        """)
    single, multi, ns, nm, gm = json.loads(out.strip().splitlines()[-1])
    assert single == {"data": 16, "model": 16} and ns == 256
    assert multi == {"pod": 2, "data": 16, "model": 16} and nm == 512
    assert gm == 16


def test_production_mesh_refuses_a_real_group(tmp_path):
    _run(f"""
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_production_mesh
        dist.init_process_group("gloo", store=dist.FileStore(
            {str(tmp_path / 'g.store')!r}, 1), rank=0, world_size=1)
        try:
            make_production_mesh()
        except RuntimeError as e:
            assert "real one is up" in str(e), e
        else:
            raise AssertionError("a fake group over a real one")
        finally:
            dist.destroy_process_group()
        """)


def test_traced_collectives_are_counted():
    """Each collective of ``parallel/collectives.py`` on fake tensors is
    its ``_c10d_functional`` form: all-gather, all-reduce (psum, pmax),
    reduce-scatter, and ppermute as an all-to-all; forward and backward
    of the differentiable ones."""
    out = _run("""
        import json, torch
        from torch.fx.experimental.proxy_tensor import make_fx
        from repro_torch.launch.hlo_analysis import analyze_graph
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.parallel import collectives as col
        from repro_torch.parallel.sharding import use_mesh
        mesh = make_production_mesh(multi_pod=True)

        def fn(x):
            with use_mesh(mesh):
                y = col.all_gather(x, "model", 0)
                y = col.psum(y, ("pod", "data"))
                y = col.psum_scatter(y, "model", 0)
                y = col.ppermute(y, "data", [(i, (i + 1) % 16)
                                             for i in range(16)])
                m = col.pmax(y.sum(), "model")
                g = torch.autograd.grad((y * m).sum(), x)[0]
            return y, g
        x = torch.randn(4, 8, requires_grad=True)
        hl = analyze_graph(make_fx(fn, tracing_mode="fake")(x))
        print(json.dumps(hl["coll_counts"]))
        """)
    counts = json.loads(out.strip().splitlines()[-1])
    # forward: 1 gather, 2 sums (pod, data), 1 scatter, 1 permute, 1 max;
    # backward: scatter->gather, permute back, psums, gather->scatter
    assert counts["all-gather"] == 2 and counts["reduce-scatter"] == 2
    assert counts["all-reduce"] == 5 and counts["all-to-all"] == 2


# a smoke cell of each family, the quick ones: a state-space train or
# prefill cell unrolls its chunked scan into one trace of ~10^5 nodes
CELLS = [("deepseek-v3-671b", "decode_32k"),       # MLA, MoE under MLA
         ("falcon-mamba-7b", "decode_32k"), ("zamba2-7b", "decode_32k"),
         ("seamless-m4t-large-v2", "decode_32k"),
         ("llava-next-mistral-7b", "prefill_32k"),  # the image prefix
         ("qwen3-14b", "train_4k"),                 # seq_shard
         ("mixtral-8x7b", "long_500k")]             # B = 1: cache_seq


def test_every_family_traces_on_both_meshes(tmp_path):
    """A smoke cell of every family on the (16, 16) and (2, 16, 16)
    meshes (the CLI's ``--both-meshes`` and ``--multi-pod``)."""
    out = _run(f"""
        import json, os
        os.chdir({str(tmp_path)!r})
        from repro_torch.launch import dryrun
        rows = [dryrun.run_cell(a, s, device="cpu", smoke=True, mesh=m)
                for a, s in {CELLS!r} for m in ("single", "multi")]
        print(json.dumps([[r["arch"], r["mesh"], r["status"],
                           r.get("ndev"), r.get("error")] for r in rows]))
        """, timeout=600)
    rows = json.loads(out.strip().splitlines()[-1])
    assert len(rows) == 2 * len(CELLS)
    for arch, mesh, status, ndev, err in rows:
        assert status == "ok", (arch, mesh, err)
        assert ndev == {"single": 256, "multi": 512}[mesh]
    env = _env()
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "gemma-2b", "--smoke", "--shape",
                        "decode_32k", "--multi-pod", "--device", "cpu",
                        "--out", "m.json"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads((tmp_path / "m.json").read_text())
    assert [(x["mesh"], x["ndev"], x["status"]) for x in r] == \
        [("multi", 512, "ok")]
    assert os.path.exists(tmp_path / "results" / "fx" /
                          "gemma-2b_decode_32k_multi_smoke.fx.zst")


REF = """
import sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import repro.configs as RC
from repro.configs.base import ShapeSpec
from repro.launch.hlo_analysis import analyze
from repro.launch.specs import (batch_shardings, cache_shardings,
                                param_shardings, state_shardings)
from repro.models import build_model
from repro.parallel import use_mesh
from repro.serve.step import build_decode_step
from repro.train.step import build_train_step

kind = sys.argv[1]
cfg = RC.get_smoke("florbench-100m").replace(remat=False)
model = build_model(cfg)
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
shape = ShapeSpec(kind, kind, 64, 8)
with mesh, use_mesh(mesh):
    rep = NamedSharding(mesh, P())
    b_sh, b_specs = batch_shardings(model, shape, mesh)
    if kind == "train":
        init_state, step = build_train_step(cfg)
        st = jax.eval_shape(init_state, jax.random.PRNGKey(0))
        st_sh = state_shardings(cfg, mesh, st)
        low = jax.jit(step, in_shardings=(st_sh, b_sh),
                      out_shardings=(st_sh, rep)).lower(st, b_specs)
    else:
        p_sh, p_shapes = param_shardings(model, mesh, serve=False)
        c_sh, c_specs = cache_shardings(model, shape, mesh)
        low = jax.jit(build_decode_step(cfg),
                      in_shardings=(p_sh, c_sh, b_sh["tokens"], rep),
                      out_shardings=(rep, rep, c_sh)).lower(
            p_shapes, c_specs, b_specs["tokens"], b_specs["pos"])
hl = analyze(low.compile().as_text())
print("REF", hl["flops"], dict(hl["coll"]))
"""

PORT = """
import json, os, sys
os.chdir(sys.argv[2])
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh
kind = sys.argv[1]
m = make_fake_mesh((2, 4), ("data", "model"))
r = dryrun.run_cell("florbench-100m", ShapeSpec(kind, kind, 64, 8),
                    device="cpu", smoke=True, device_mesh=m,
                    overrides={"remat": "false"})
print("PORT", json.dumps([r["status"], r["mesh"], r["ndev"],
                          r["flops_per_device"],
                          r["collective_bytes_per_device"]]))
"""


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_sharded_smoke_flops_match_reference(kind, tmp_path):
    """Measured (florbench-100m smoke, batch 8 x 64, (2, 4)): decode
    1 966 080 FLOPs a device in both packages; train 376 700 928 against
    the reference's 376 829 952, both with ``remat=False`` (-0.034%: its
    gold logit is a one-hot dot, the port's a gather)."""
    ref = subprocess.Popen(
        [sys.executable, "-c",
         "import os\nos.environ['XLA_FLAGS'] = "
         "'--xla_force_host_platform_device_count=8'\n"
         "os.environ['JAX_PLATFORMS'] = 'cpu'\n" + REF, kind],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    port = subprocess.run([sys.executable, "-c", PORT, kind, str(tmp_path)],
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    line = [x for x in out.splitlines() if x.startswith("REF")][-1]
    want = float(line.split()[1])
    status, mesh, ndev, got, coll = json.loads(
        [x for x in port.stdout.splitlines()
         if x.startswith("PORT")][-1][5:])
    assert (status, mesh, ndev) == ("ok", "2x4", 8)
    assert abs(got - want) / want < 0.05, (got, want)
    print(f"{kind}: flops {got:.0f} vs {want:.0f}; collective bytes "
          f"port {coll} | reference {line.split(' ', 2)[2]}")
