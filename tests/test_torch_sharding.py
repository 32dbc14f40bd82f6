"""The port's sharding resolver, placements and launch specs against the
reference package (``repro.parallel.sharding``, ``repro.launch.specs``,
``Model.cache_axes``): specs are compared entry for entry (tolerance 0),
shard bounds index for index.

The resolver needs only axis names and sizes, so both packages resolve on a
duck-typed mesh whose ``shape`` maps names to sizes (the reference's
``test_respec_resolves_and_falls_back`` builds its ``AbstractMesh`` from
name/size pairs, which this jax refuses). Shard
bounds come from real layouts: the reference's ``addressable_shards`` on 8
forced host devices, the port's ``local_box`` in each process of an 8-rank
gloo fleet."""
import json
import os

import jax
import pytest
import torch
from proptest import given, st

import repro.configs as JC
import repro_torch.configs as C
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.launch import specs as jspecs
from repro.models import build_model as jax_build_model
from repro.parallel import sharding as jsh
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import specs
from repro_torch.models.api import build_model
from repro_torch.parallel import sharding as tsh
from torch_fleet import ref_subprocess, run_fleet


class DuckMesh:
    """Axis names and sizes: all a resolver reads."""

    def __init__(self, shape, names=("pod", "data", "model")):
        self.shape = dict(zip(names, shape))


LOGICAL = ["batch", "batch_dp3", "embed", "heads", "kv_heads", "mlp",
           "cache_seq", "vocab", "expert", "dinner", "layer", "seq_mp",
           None]
MESHES = [(2, 4, 4), (1, 2, 2), (4, 1, 8), (2, 16, 16), (1, 1, 1)]


@given(dims=st.lists(st.sampled_from([1, 2, 3, 6, 8, 16, 17, 64, 4096]),
                     min_size=1, max_size=4),
       names=st.lists(st.sampled_from(LOGICAL), min_size=1, max_size=4),
       mesh=st.sampled_from(MESHES))
def test_physical_spec_and_respec_match_reference(dims, names, mesh):
    n = min(len(dims), len(names))
    dims, names = dims[:n], names[:n]
    m = DuckMesh(mesh)
    got = tsh.physical_spec(names, dims, m)
    assert got == tuple(jsh.physical_spec(names, dims, m))
    entries = tsh.spec_entries(got)
    assert entries == jsh.spec_entries(jsh.physical_spec(names, dims, m))
    # the recorded spec re-resolved on every other mesh, fallbacks included
    for other in MESHES:
        o = DuckMesh(other)
        assert tsh.respec(entries, dims, o) \
            == tuple(jsh.respec(entries, dims, o))
    two = DuckMesh(mesh[1:], ("data", "model"))
    assert tsh.respec(entries, dims, two) \
        == tuple(jsh.respec(entries, dims, two))


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    m = DuckMesh((2, 2), ("data", "model"))
    assert tsh.placements(("data", "model"), m) == (Shard(0), Shard(1))
    assert tsh.placements((None, "data"), m) == (Shard(1), Replicate())
    # a joined entry: Shard(d) on each of its axes, split in mesh order
    assert tsh.placements((("data", "model"), None), m) \
        == (Shard(0), Shard(0))
    assert tsh.spec_from_placements((Shard(0), Shard(0)), 2, m) \
        == (("data", "model"), None)
    for spec in [(), ("model",), (None, ("data", "model")),
                 ("model", "data")]:
        pls = tsh.placements(spec, m)
        want = tuple(spec) + (None,) * (2 - len(spec))
        assert tsh.spec_from_placements(pls, 2, m) == want
    # against mesh order there is no torch layout: it raises
    with pytest.raises(ValueError, match="mesh order"):
        tsh.placements((("model", "data"),), m)
    with pytest.raises(ValueError, match="shards two dims"):
        tsh.placements(("data", "data"), m)
    with pytest.raises(ValueError, match="not in mesh"):
        tsh.placements(("pod",), m)


def test_constrain_is_identity_without_mesh_and_raises_under_one():
    """Without a mesh ``constrain`` is the identity and ``constrain_spec``
    gives back the declared layout (none declared: replicated). Under a
    mesh a call that declares no layout (``have``) raises — a site that
    forgot it would compute in a layout nobody chose; one that declares
    it is moved (``test_constrain_sites_hold_the_reference_shards``)."""
    x = torch.ones(4, 4)
    assert tsh.constrain(x, ("batch", None)) is x
    assert tsh.constrain_spec(x, ("batch", None)) == (x, (None, None))
    assert tsh.constrain_spec(x, ("batch", None), have=("data", None)) \
        == (x, ("data", None))
    with tsh.use_mesh(DuckMesh((2, 2), ("data", "model"))):
        assert tsh.current_mesh() is not None
        with pytest.raises(ValueError, match="have="):
            tsh.constrain(x, ("batch", None))
        # a layout that already is the constrained one needs no collective
        y, spec = tsh.constrain_spec(x, ("batch", "mlp"),
                                     have=("data", "model"))
        assert y is x and spec == ("data", "model")
        assert tsh.global_shape((4, 4), ("data", None)) == (8, 4)
    assert tsh.current_mesh() is None


FAMILY_ARCH = {"mla": "deepseek-v3-671b", "ssm": "falcon-mamba-7b",
               "hybrid": "zamba2-7b", "encdec": "seamless-m4t-large-v2"}


@pytest.mark.parametrize("family", ["mla", "ssm", "hybrid", "encdec"])
def test_next_slice_families_raise_under_a_mesh(family, tmp_path):
    """The MLA, SSM, hybrid and encoder-decoder families run under a mesh
    (they raised before their sharded compute was ported): on a one-rank
    ("data", "model") mesh the sharded loss, every collective a no-op,
    equals the unsharded loss (f32)."""
    from repro_torch.data import synthetic_batch
    from torch_fleet import world1
    cfg = C.get_smoke(FAMILY_ARCH[family]).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(cfg, 2, 16, 0, 0).items()}
    want, _ = model.loss(params, batch)
    with world1(tmp_path, (1, 1), ("data", "model")) as mesh:
        with tsh.use_mesh(mesh):
            got, metrics = model.loss(params, batch)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert "ce" in metrics


def test_serving_raises_under_a_mesh(tmp_path):
    """Prefill and decode run under a mesh (they raised before): on a
    one-rank mesh the parameters go in whole, the caches come out as
    DTensors, and the logits equal the unsharded ones."""
    from torch.distributed.tensor import DTensor
    from torch_fleet import world1
    cfg = C.get_smoke("florbench-100m").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, "cpu")
    tokens = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    with torch.no_grad():
        caches, want = model.prefill(params, {"tokens": tokens}, 16)
        want2, _ = model.decode(params, caches, tokens[:, :1], 8)
        with world1(tmp_path, (1, 1), ("data", "model")) as mesh:
            with tsh.use_mesh(mesh):
                sc, got = model.prefill(params, {"tokens": tokens}, 16)
                got2, sc2 = model.decode(params, sc, tokens[:, :1], 8)
    assert isinstance(sc["layers"]["k"], DTensor)
    assert isinstance(sc2["layers"]["k"], DTensor)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got2, want2, rtol=1e-5, atol=1e-6)


SITES = """
import json
from torch.distributed.device_mesh import DeviceMesh
import repro_torch.configs as C
from repro.parallel import sharding as jsh
from repro_torch.data import synthetic_batch
from repro_torch.launch.specs import state_shardings
from repro_torch.models import attention, layers, transformer
from repro_torch.models.api import build_model
from repro_torch.parallel import sharding as tsh
from repro_torch.train.step import build_train_step
from repro_torch.utils.pytree import tree_map

RECORD = []


def recording(x, logical, have=None):
    y, spec = tsh.constrain_spec(x, logical, have)
    RECORD.append((tuple(logical), y.detach().clone(), spec))
    return y, spec


for mod in (attention, layers, transformer):
    mod.constrain = lambda x, logical, have=None: recording(x, logical,
                                                            have)[0]
    mod.constrain_spec = recording


class Duck:
    def __init__(self, sizes):
        self.shape = sizes


def main(rank, world, args):
    arch, d, m, over = args[0], int(args[1]), int(args[2]), json.loads(args[3])
    cfg = C.get_smoke(arch).replace(dtype="float32", **over)
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(d, m),
                      mesh_dim_names=("data", "model"))
    init, _ = build_train_step(cfg, device="cpu")
    state = init(0)
    sh = state_shardings(cfg, mesh, state)
    local = tree_map(lambda x, s: tsh.place(x, mesh, s.spec).to_local(),
                     state.params, sh.params)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(cfg, 8, 16, 0, 0).items()}
    model = build_model(cfg)
    model.loss(state.params, batch)
    full = list(RECORD)
    RECORD.clear()
    with tsh.use_mesh(mesh):
        model.loss(local, batch)
    # one walk: the same sites in the same order with and without a mesh
    sharded = list(RECORD)
    assert len(full) == len(sharded) > 4, (len(full), len(sharded))
    sizes = {"data": d, "model": m}
    for (lg, x, _), (lg2, y, spec) in zip(full, sharded):
        assert lg == lg2, (lg, lg2)
        want = tuple(jsh.physical_spec(lg, x.shape, Duck(sizes)))
        want += (None,) * (x.ndim - len(want))
        assert tsh.spec_entries(spec) == tsh.spec_entries(want), \
            (lg, spec, want)
        box = tsh.local_box(x.shape, mesh, tsh.placements(spec, mesh))
        part = x[tuple(slice(lo, hi) for lo, hi in box)]
        assert y.shape == part.shape, (lg, y.shape, part.shape)
        torch.testing.assert_close(y, part, rtol=0,
                                   atol=1e-5 * float(x.abs().max()))
    print("SITES", len(full))
"""


@pytest.mark.parametrize("arch,mesh,over", [
    ("florbench-100m", (2, 2), {}),
    ("granite-3-2b", (1, 4), {}),
    # MoE on (1, 4): each expert's capacity is the unsharded one (tokens
    # replicated over "model", or all-gathered there with "dp"), so the
    # same choices drop and the activations stay comparable
    ("mixtral-8x7b", (1, 4), {}),
    ("mixtral-8x7b", (1, 4), {"dense_layout": "dp"}),
], ids=["florbench-2x2", "granite-1x4", "mixtral-1x4", "mixtral-dp-1x4"])
def test_constrain_sites_hold_the_reference_shards(tmp_path, arch, mesh,
                                                   over):
    """At every constrain site of the dense / MoE loss (embedding, residual,
    q, k, MLP hidden, block outputs, logits), in a fleet of CPU processes:
    the spec the port resolves equals the reference's ``physical_spec`` at
    the activation's global shape, and the local tensor equals that shard
    of the same site's activation in the unsharded loss (f32)."""
    res = run_fleet(SITES, mesh[0] * mesh[1], tmp_path, arch, mesh[0],
                    mesh[1], json.dumps(over))
    assert all(rc == 0 for rc, _ in res), [t[-2000:] for _, t in res]
    assert "SITES" in res[0][1]


def test_relayout_moves_shards_through_collectives(tmp_path):
    """``relayout`` on a (2, 2) fleet: every (have, want) pair over a
    [4, 8] tensor gives the local slice ``want`` names, and its gradient
    is the zero-padded / reduce-scattered transpose."""
    body = """
    import itertools
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel import sharding as tsh
    from repro_torch.parallel.sharding import local_box, placements

    def main(rank, world, args):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        full = torch.arange(32.0).reshape(4, 8)
        specs = [(None, None), ("data", None), ("model", None),
                 (None, "data"), ("data", "model"), ("model", "data"),
                 ((("data", "model")), None), (None, ("data", "model"))]
        with tsh.use_mesh(mesh):
            for have, want in itertools.product(specs, specs):
                box = local_box((4, 8), mesh, placements(have, mesh))
                x = full[tuple(slice(*b) for b in box)].clone()
                x.requires_grad_(True)
                y = tsh.relayout(x, have, want)
                wbox = local_box((4, 8), mesh, placements(want, mesh))
                assert torch.equal(y, full[tuple(slice(*b) for b in wbox)]), \
                    (have, want)
                # the gradient of the sum of y over all ranks: partial
                # cotangents, so summed over the ranks x is replicated on
                # it counts each element once per rank that holds it in y
                (g,) = torch.autograd.grad(y.sum(), x)
                rep = lambda sp: 4 // 2 ** len(  # noqa: E731
                    {a for ax in tsh.spec_axes(sp, 2) for a in ax})
                used = {a for ax in tsh.spec_axes(have, 2) for a in ax}
                g = col.psum(g, tuple(a for a in ("data", "model")
                                      if a not in used))
                assert torch.all(g == rep(want)), (have, want, g)
    """
    res = run_fleet(body, 4, tmp_path)
    assert all(rc == 0 for rc, _ in res), res[0][1][-3000:]


# ------------------------------------------------------------ model axes --
@pytest.mark.parametrize("arch", sorted(C.ARCHS))
def test_cache_and_param_axes_match_reference(arch):
    model = build_model(C.get_smoke(arch))
    jmodel = jax_build_model(JC.get_smoke(arch))
    is_ax = lambda x: isinstance(x, tuple)  # noqa: E731
    assert model.cache_axes() == jmodel.cache_axes()
    assert model.param_axes() == jmodel.param_axes()
    # the cache axes fit the cache spec leaf for leaf
    for ax, (shape, _) in zip(
            jax.tree_util.tree_leaves(model.cache_axes(), is_leaf=is_ax),
            jax.tree_util.tree_leaves(model.cache_spec(2, 64),
                                      is_leaf=is_ax)):
        assert len(ax) == len(shape)


def _jspecs(tree):
    return [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: hasattr(x, "spec"))]


def _tspecs(tree):
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            out.append(t.spec)
    walk(tree)
    return out


@pytest.mark.parametrize("arch", ["florbench-100m", "mixtral-8x7b",
                                  "deepseek-v3-671b", "zamba2-7b",
                                  "seamless-m4t-large-v2"])
def test_launch_specs_match_reference(arch):
    cfg, jcfg = C.get_smoke(arch), JC.get_smoke(arch)
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    names = ("data", "model")
    jmesh = jax.sharding.AbstractMesh((2, 4), names)
    mesh = DuckMesh((2, 4), names)
    for serve in (False, True):
        got, _ = specs.param_shardings(model, mesh, serve=serve)
        want, _ = jspecs.param_shardings(jmodel, jmesh, serve=serve)
        assert _tspecs(got) == _jspecs(want)
    shape = ShapeSpec("decode", "decode", 128, 8)
    got, _ = specs.cache_shardings(model, shape, mesh)
    want, _ = jspecs.cache_shardings(jmodel, JShapeSpec("d", "decode", 128,
                                                        8), jmesh)
    assert _tspecs(got) == _jspecs(want)
    for kind in ("train", "decode"):
        shape = ShapeSpec(kind, kind, 128, 8)
        got, tin = specs.batch_shardings(model, shape, mesh)
        want, jin = jspecs.batch_shardings(
            jmodel, JShapeSpec(kind, kind, 128, 8), jmesh)
        assert {k: g.spec for k, g in got.items()} \
            == {k: tuple(w.spec) for k, w in want.items()}
        assert {k: tuple(v[0]) for k, v in tin.items()} \
            == {k: tuple(v.shape) for k, v in jin.items()}


def test_state_shardings_cover_the_train_state():
    from repro_torch.train.state import TrainState
    from repro_torch.train.step import build_train_step
    cfg = C.get_smoke("florbench-100m")
    init_state, _ = build_train_step(cfg, device="cpu")
    st = init_state(0)
    sh = specs.state_shardings(cfg, DuckMesh((2, 2), ("data", "model")), st)
    assert isinstance(sh, TrainState)
    assert sh.step.spec == () and sh.rng.spec == ()
    assert _tspecs(sh.params) == _tspecs(sh.mu) == _tspecs(sh.nu)
    used = [{a for e in s if e for a in (e if isinstance(e, tuple) else (e,))}
            for s in _tspecs(sh.params)]
    assert {"data", "model"} in used


# ----------------------------------------------------- bounds from layouts --
BOUND_MESHES = [(2, 4), (4, 2), (1, 8), (8, 1)]
BOUND_CASES = [([8, 16], ["data", "model"]), ([16, 4], ["model", None]),
               ([24, 8], [["data", "model"], None]), ([32], ["data"]),
               ([4, 6], [None, "model"]), ([8, 8, 2], [None, None, None]),
               ([], [])]

REF_BOUNDS = """
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.parallel.sharding import respec
meshes, cases = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {}
for shape in meshes:
    mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
    ords = {d.id: i for i, d in enumerate(mesh.devices.flat)}
    for c, (gshape, entries) in enumerate(cases):
        spec = respec(entries, gshape, mesh)
        x = jax.make_array_from_callback(
            tuple(gshape), NamedSharding(mesh, spec),
            lambda idx: np.zeros([len(range(*s.indices(d))) for s, d in
                                  zip(idx, gshape)], np.float32))
        own = {}
        for sh in x.addressable_shards:
            if sh.replica_id == 0:
                own[ords[sh.device.id]] = [
                    [int(s.start or 0), int(s.stop if s.stop is not None
                                            else d)]
                    for s, d in zip(sh.index, gshape)]
        out[f"{shape}|{c}"] = {"spec": [list(e) if isinstance(e, tuple)
                                        else e for e in spec],
                               "own": own}
print("BOUNDS" + json.dumps(out))
"""

PORT_BOUNDS = """
import json
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate
from repro_torch.parallel.sharding import local_box, placements, respec


def main(rank, world, args):
    meshes, cases, out_dir = json.loads(args[0]), json.loads(args[1]), args[2]
    out = {}
    for shape in meshes:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=("data", "model"))
        coord = mesh.get_coordinate()
        for c, (gshape, entries) in enumerate(cases):
            spec = respec(entries, gshape, mesh)
            pls = placements(spec, mesh)
            owner = not any(isinstance(p, Replicate) and x != 0
                            for p, x in zip(pls, coord))
            out[f"{shape}|{c}"] = {
                "spec": [list(e) if isinstance(e, tuple) else e
                         for e in spec],
                "box": local_box(gshape, mesh, pls) if owner else None}
    with open(os.path.join(out_dir, f"b{rank}.json"), "w") as f:
        json.dump(out, f)
"""


@pytest.mark.slow
def test_shard_bounds_match_reference_addressable_shards(tmp_path):
    """Each owner's box from the port's placements (8-rank gloo fleet)
    equals the reference's replica-0 ``addressable_shards`` index on the
    same mesh shape, and the owners are the same mesh positions."""
    meshes, cases = json.dumps(BOUND_MESHES), json.dumps(BOUND_CASES)
    ref = ref_subprocess(REF_BOUNDS, 8, meshes, cases)
    line = [ln for ln in ref.stdout.splitlines() if ln.startswith("BOUNDS")]
    assert line, ref.stderr[-3000:]
    want = json.loads(line[0][len("BOUNDS"):])
    res = run_fleet(PORT_BOUNDS, 8, tmp_path, meshes, cases, tmp_path)
    assert all(rc == 0 for rc, _ in res), res
    per_rank = []
    for r in range(8):
        with open(os.path.join(tmp_path, f"b{r}.json")) as f:
            per_rank.append(json.load(f))
    for key, w in want.items():
        assert per_rank[0][key]["spec"] == w["spec"], key
        got = {str(r): per_rank[r][key]["box"] for r in range(8)
               if per_rank[r][key]["box"] is not None}
        assert got == w["own"], key
