"""Sharded serving — prefill and decode under a mesh — against the
reference's sharded prefill and decode.

Both sides take the same parameters (the port's ``init``, through numpy),
the same prompt and the same teacher-forced decode tokens, in f32, on a
("data", "model") mesh of 4: the reference jits ``build_prefill_step`` /
``build_decode_step`` with ``param_shardings`` and ``cache_shardings``
(logits replicated, as its dry run lays the cells out) on 4 forced host
devices over an ``Auto``-axis ``jax.sharding.Mesh``; the port places the
parameters by its ``param_shardings`` (DTensors) and calls
``Model.prefill`` / ``decode`` under ``use_mesh`` in a gloo fleet of 4 CPU
processes, its caches DTensors laid out by ``cache_shardings``. One
reference process and one fleet run every case side by side.

Compared: the prefill's last-position logits and each of 4 decode steps'
logits within ``TOL`` of the reference's largest logit, and the caches
after the last step, gathered whole, leaf for leaf. In the fleet a second
run of the whole sequence gives the same bits."""
import pickle
import subprocess
import sys
import zlib

import numpy as np
import pytest

from torch_fleet import SRC, _env, run_fleet

# f32 on both sides; measured at most 9.5e-7 of the largest logit (zamba2)
TOL = 1e-4
STEPS = 4
B = 4

CASES = [
    # (arch, mesh, prompt length, serve layout, config overrides)
    ("deepseek-v3-671b", (2, 2), 8, False, {}),      # MLA, MoE under MLA
    ("falcon-mamba-7b", (2, 2), 8, False, {}),
    ("zamba2-7b", (2, 2), 8, False, {}),
    ("seamless-m4t-large-v2", (2, 2), 8, False, {}),
    ("llava-next-mistral-7b", (2, 2), 8, False, {}),
    ("qwen3-14b", (2, 2), 8, False, {}),             # seq_shard prefill
    # the sliding-window ring (window 32): the prompt fills it and every
    # decode step writes past it, in the slot its owner holds
    ("mixtral-8x7b", (2, 2), 40, False, {}),
    # kv_heads 2 on "model" 4: the cache's slots over "model"; the serving
    # layout drops the FSDP dim (the reference's serve_replicate_fsdp)
    ("qwen3-14b", (1, 4), 8, True, {"serve_replicate_fsdp": True}),
    ("zamba2-7b", (1, 4), 40, True, {}),
]
IDS = [f"{a}-{m[0]}x{m[1]}-S{s}{'-serve' if v else ''}"
       for a, m, s, v, _ in CASES]

REF = r"""
import pickle, sys
import numpy as np
import jax
import jax.numpy as jnp
import repro.configs as JC
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeSpec
from repro.launch.specs import cache_shardings, param_shardings
from repro.models import build_model
from repro.parallel import use_mesh
from repro.serve.step import build_decode_step, build_prefill_step

cases_in, out = sys.argv[1:3]
with open(cases_in, "rb") as f:
    cases = pickle.load(f)
res = {}
for c in cases:
    cfg = JC.get_smoke(c["arch"]).replace(dtype="float32", **c["over"])
    d, m = c["mesh"]
    mesh = Mesh(np.array(jax.devices()).reshape(d, m), ("data", "model"))
    model = build_model(cfg)
    with use_mesh(mesh):
        p_sh, _ = param_shardings(model, mesh, serve=c["serve"])
        c_sh, _ = cache_shardings(
            model, ShapeSpec("s", "decode", c["max_len"], c["B"]), mesh)
        rep = NamedSharding(mesh, P())
        params = jax.device_put(
            jax.tree_util.tree_map(jnp.asarray, c["params"]), p_sh)
        prefill = jax.jit(build_prefill_step(cfg, c["max_len"]),
                          out_shardings=(c_sh, rep))
        decode = jax.jit(build_decode_step(cfg),
                         in_shardings=(p_sh, c_sh, rep, rep),
                         out_shardings=(rep, rep, c_sh))
        caches, logits = prefill(params, c["batch"])
        logs = [np.asarray(logits)]
        for i, tok in enumerate(c["tokens"]):
            _, lg, caches = decode(params, caches, jnp.asarray(tok),
                                   jnp.asarray(c["start"] + i, jnp.int32))
            logs.append(np.asarray(lg))
    res[c["id"]] = {"logits": logs, "caches": jax.tree_util.tree_map(
        np.asarray, jax.device_get(caches))}
with open(out, "wb") as f:
    pickle.dump(res, f)
"""

PORT = """
import pickle
from torch.distributed.device_mesh import DeviceMesh
import repro_torch.configs as C
from repro_torch.launch.specs import param_shardings
from repro_torch.models import build_model
from repro_torch.parallel import place
from repro_torch.parallel.sharding import use_mesh
from repro_torch.utils.pytree import tree_map


def run(model, placed, c, mesh):
    batch = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
    with use_mesh(mesh), torch.no_grad():
        caches, logits = model.prefill(placed, batch, c["max_len"])
        logs = [logits]
        for i, tok in enumerate(c["tokens"]):
            logits, caches = model.decode(placed, caches,
                                          torch.from_numpy(tok),
                                          c["start"] + i)
            logs.append(logits)
    full = tree_map(lambda x: x.full_tensor(), caches)
    return logs, full


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
        model = build_model(cfg)
        params = tree_map(torch.from_numpy, c["params"])
        sh, _ = param_shardings(model, mesh, serve=c["serve"])
        placed = tree_map(lambda x, s: place(x, mesh, s.spec), params, sh)
        logs, caches = run(model, placed, c, mesh)
        logs2, caches2 = run(model, placed, c, mesh)
        assert all(torch.equal(a, b) for a, b in zip(logs, logs2)), c["id"]
        same = tree_map(lambda a, b: bool(torch.equal(a, b)), caches,
                        caches2)
        assert all(v for v in _flat(same)), c["id"]
        res[c["id"]] = {"logits": [x.numpy() for x in logs],
                        "caches": tree_map(lambda x: x.numpy(), caches)}
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)


def _flat(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _flat(v)
    else:
        yield t
"""


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _case(cid, arch, mesh, S, serve, over):
    import repro_torch.configs as C
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_map

    cfg = C.get_smoke(arch).replace(dtype="float32", **over)
    params = tree_map(lambda t: t.numpy(), build_model(cfg).init(0, "cpu"))
    rng = np.random.default_rng(zlib.crc32(cid.encode()))
    toks = lambda shape: rng.integers(  # noqa: E731
        0, cfg.vocab_size, shape).astype(np.int32)
    if cfg.family == "audio":
        batch = {"enc_embeds": rng.standard_normal(
                     (B, 12, cfg.d_model)).astype(np.float32),
                 "dec_tokens": toks((B, S))}
        start = S
    else:
        batch = {"tokens": toks((B, S))}
        start = S
        if cfg.family == "vlm":
            batch["embeds"] = rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
            start += cfg.frontend_tokens
    return {"id": cid, "arch": arch, "mesh": mesh, "serve": serve,
            "over": over, "params": params, "batch": batch, "B": B,
            "start": start, "max_len": start + STEPS + 4,
            "tokens": [toks((B, 1)) for _ in range(STEPS)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    sys.path.insert(0, SRC)
    tmp = tmp_path_factory.mktemp("serve")
    cases = [_case(cid, *c) for cid, c in zip(IDS, CASES)]
    cases_in = str(tmp / "cases.pkl")
    with open(cases_in, "wb") as f:
        pickle.dump(cases, f)
    ref_out, port_out = str(tmp / "ref.pkl"), str(tmp / "port.pkl")
    prelude = ("import os\nos.environ['XLA_FLAGS'] = "
               "'--xla_force_host_platform_device_count=4'\n"
               "os.environ['JAX_PLATFORMS'] = 'cpu'\n")
    ref = subprocess.Popen([sys.executable, "-c", prelude + REF, cases_in,
                            ref_out], env=_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        outs = run_fleet(PORT, 4, str(tmp), cases_in, port_out, timeout=400)
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
    return got, want


@pytest.mark.parametrize("cid", IDS)
def test_sharded_prefill_and_decode_match_reference(runs, cid):
    got, want = runs[0][cid], runs[1][cid]
    scale = max(float(np.abs(w).max()) for w in want["logits"])
    assert len(got["logits"]) == len(want["logits"]) == STEPS + 1
    for step, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        assert g.shape == w.shape, (step, g.shape, w.shape)
        err = float(np.abs(g - w).max())
        print(f"{cid} step {step}: {err / scale:.2e} of {scale:.3f}")
        assert err <= TOL * scale, (step, err, scale)
    for (p, a), (q, b) in zip(_leaves(got["caches"]),
                              _leaves(want["caches"])):
        assert p == q and a.shape == b.shape, (p, q, a.shape, b.shape)
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=p)
        else:
            np.testing.assert_allclose(
                a, b, rtol=0, atol=TOL * max(np.abs(b).max(), 1e-30),
                err_msg=p)
