"""The check of a routed model on the CPU: the reference follows the
program's own choices of experts, a number of their own judges the
choices, and the recompute's choices are held to the forward's.

The MoE smoke cell runs the program in float32 here, so a sound run's gaps
are float32 rounding; the limits are the real cell's."""
import json
import os

import pytest
import torch
import torch.nn.functional as F

from portbench import calibrate, check, harness
from portbench.reference import model as ref
from portbench.tests.smoke import smoke_tree

MOE, DENSE = 2, 0          # smoke cells: granite's two, the held-back MoE one


def _cell(tmp_path, index, dtype="float32"):
    bench, here, cells = smoke_tree(str(tmp_path))
    cell = cells[index]
    path = os.path.join(here, "configs", cell.split(".")[0] + ".json")
    with open(path) as f:
        conf = json.load(f)
    conf["run"]["dtype"] = dtype
    with open(path, "w") as f:
        json.dump(conf, f)
    return bench, here, cell


def _run(bench, here, cell, seed=21, **kw):
    diag = {}
    r = harness.run_cell(bench, cell, seed, 0.0, False, "cpu", 0.0,
                         here=here, log=lambda s: None, diag=diag, **kw)
    return r, diag


def test_reference_given_its_own_choices_reads_as_free_running(tmp_path):
    bench, here, cell = _cell(tmp_path, MOE)
    c = harness.Cell(bench, cell, here)
    dev = torch.device("cpu")
    own = harness.reference_readings(c.conf, c.mix, 7, dev, "float32")
    given = harness.reference_readings(
        c.conf, c.mix, 7, dev, "float32",
        routes=calibrate.own_routes(own, c.dims["k"]))
    for key in ("loss", "grad", "change", "dropped"):
        assert given[key] == own[key], key
    assert own["route_gap"] == given["route_gap"] == [0.0] * len(own["loss"])
    assert own["route_miss"] == given["route_miss"] == [0.0] * len(own["loss"])


def test_route_gap_is_the_shortfall_of_a_swapped_choice():
    m = {"E": 4, "k": 2, "capacity_factor": 1.25}
    T, d, f = 16, 8, 12
    g = torch.Generator().manual_seed(3)
    x, router = torch.randn(T, d, generator=g), torch.randn(d, 4, generator=g)
    wi, wg, wo = (torch.randn(4, *s, generator=g)
                  for s in ((d, f), (d, f), (f, d)))
    *_, rank, gap, miss = ref.moe(m, x, router, wi, wg, wo, "float32")
    assert gap.item() == 0.0 and miss.item() == 0.0
    ids = rank[:, :2].clone()
    ids[5, 1] = rank[5, 2]
    *_, gap, miss = ref.moe(m, x, router, wi, wg, wo, "float32", ids)
    probs = torch.softmax(x @ router, dim=-1)
    hand = probs[5, rank[5, 1]] - probs[5, rank[5, 2]]
    assert hand > 0
    assert abs(gap.item() - hand.item()) <= 4 * torch.finfo(torch.float32).eps
    assert miss.item() == 1 / T
    # the same set in another order is no miss
    *_, gap, miss = ref.moe(m, x, router, wi, wg, wo, "float32",
                            rank[:, :2].flip(-1))
    assert gap.item() == 0.0 and miss.item() == 0.0


def test_capture_keeps_each_layers_choices_and_restores_route(tmp_path):
    from repro_torch.models import moe

    original = moe.route
    seen = []

    def watch(step):
        def call(state, batch):
            seen.append(moe.route is original)
            return step(state, batch)
        return call

    bench, here, cell = _cell(tmp_path, MOE)
    c = harness.Cell(bench, cell, here)
    r, diag = _run(bench, here, cell, wrap_step=watch)
    warm = c.mix["check_steps"]
    T, k = c.mix["batch"] * c.mix["seq"], c.dims["k"]
    assert len(diag["routes"]) == warm
    for step in diag["routes"]:
        assert len(step) == c.dims["L"]
        assert all(ids.shape == (T, k) and ids.dtype == torch.int64
                   for ids in step)
    # set-up's steps ran the capture, the window the program untouched
    assert seen[:warm] == [False] * warm
    assert len(seen) > warm and all(seen[warm:])
    assert moe.route is original
    assert r["correct"], r["checks"]
    assert r["checks"]["route_mismatch"]["value"] == 0


def test_capture_counts_layers_and_recompute_differences():
    from repro_torch.models import moe

    original = moe.route
    cfg = harness.port_config(_smoke_moe_conf())
    x = torch.randn(10, cfg.d_model)
    w0, w1 = torch.randn(2, cfg.d_model, cfg.moe.num_experts).unbind(0)
    cap = harness.RouteCapture()
    try:
        cap.step()
        a = moe.route(cfg, w0, x)[1]
        moe.route(cfg, w1, x)
        moe.route(cfg, w1, x)               # layer 1's recompute: the same
        cap.step()
        moe.route(cfg, w0, x)
        moe.route(cfg, w0, -x)              # a recompute that differs
    finally:
        cap.stop()
    assert moe.route is original
    assert cap.mismatch == 1
    assert cap.routes(2, 10, cfg.moe.top_k) is None   # step 2 lacks layer 1
    assert torch.equal(cap.steps[0][(w0.data_ptr(), tuple(w0.shape))], a)
    cap.steps.pop()
    assert len(cap.routes(2, 10, cfg.moe.top_k)[0]) == 2
    assert cap.routes(2, 11, cfg.moe.top_k) is None


def _smoke_moe_conf():
    path = os.path.join(harness.HERE, "configs", "mixtral-8x7b.json")
    with open(path) as f:
        conf = json.load(f)
    conf.update(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                num_key_value_heads=2, num_hidden_layers=2, vocab_size=256,
                num_local_experts=4)
    return conf


def misrouting(route):
    """The program's router with each fourth token's last choice swapped
    for the next expert in rank, its gates and router loss taken from the
    swapped choices: the layer computes what it chose, but chose wrong."""
    from repro_torch.models import moe

    def planted(cfg, router_w, x_flat):
        logits = moe.dot("td,de->te", x_flat,
                         router_w.to(x_flat.dtype)).float()
        probs = torch.softmax(logits, dim=-1)
        rank = torch.sort(probs.detach(), dim=-1, descending=True,
                          stable=True).indices
        k, E = cfg.moe.top_k, probs.shape[-1]
        ids = rank[:, :k].clone()
        rows = torch.arange(0, ids.shape[0], 4)
        ids[rows, k - 1] = rank[rows, k]
        top = probs.gather(-1, ids)
        first = F.one_hot(ids[:, 0], E).float().mean(0)
        return (top / top.sum(-1, keepdim=True), ids,
                E * (first * probs.mean(0)).sum())
    return planted


def near_ties_biased(route, margin=1e-2):
    """The program's router taking, on every token whose k-th and
    (k+1)-th probabilities lie within ``margin``, the (k+1)-th: a bias in
    choosing that no single token's shortfall shows."""
    from repro_torch.models import moe

    def planted(cfg, router_w, x_flat):
        logits = moe.dot("td,de->te", x_flat,
                         router_w.to(x_flat.dtype)).float()
        probs = torch.softmax(logits, dim=-1)
        ranked, rank = torch.sort(probs.detach(), dim=-1, descending=True,
                                  stable=True)
        k, E = cfg.moe.top_k, probs.shape[-1]
        ids = rank[:, :k].clone()
        near = ranked[:, k - 1] - ranked[:, k] < margin
        ids[near, k - 1] = rank[near, k]
        top = probs.gather(-1, ids)
        first = F.one_hot(ids[:, 0], E).float().mean(0)
        return (top / top.sum(-1, keepdim=True), ids,
                E * (first * probs.mean(0)).sum())
    return planted


def recompute_differs(route):
    """The program's router choosing other experts each second time a
    layer calls it: in its recompute."""
    calls = {}

    def planted(cfg, router_w, x_flat):
        w, ids, aux = route(cfg, router_w, x_flat)
        n = calls[router_w.data_ptr()] = calls.get(router_w.data_ptr(),
                                                   0) + 1
        if n % 2 == 0:
            ids = (ids + 1) % cfg.moe.num_experts
        return w, ids, aux
    return planted


@pytest.mark.parametrize("fault,number", [(None, None),
                                          (misrouting, "route_gap"),
                                          (near_ties_biased,
                                           "route_miss_share"),
                                          (recompute_differs,
                                           "route_mismatch")])
def test_routing_fault_fails_the_check(tmp_path, monkeypatch, fault, number):
    from repro_torch.models import moe

    if fault is not None:
        monkeypatch.setattr(moe, "route", fault(moe.route))
    bench, here, cell = _cell(tmp_path, MOE)
    r, _ = _run(bench, here, cell)
    failing = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    if fault is None:
        assert r["correct"] and not failing, r["checks"]
        return
    assert not r["correct"] and number in failing, r["checks"]
    # the reference followed the choices: only a number of the choices
    # themselves can fail
    if fault is misrouting:
        assert failing == {"route_gap", "route_miss_share"}, r["checks"]
    if fault is near_ties_biased:
        assert failing == {"route_miss_share"}, r["checks"]


def test_dense_numbers_and_leaves_are_as_before(tmp_path):
    bench, here, cell = _cell(tmp_path, DENSE)
    r, diag = _run(bench, here, cell)
    nums = check.numbers(diag["prog"], diag["ref"])
    assert set(nums) == {"loss_gap", "grad_gap", "change_gap"}
    assert not any(k.startswith("route") for k in r["checks"])
    assert diag["routes"] is None
    L = harness.Cell(bench, cell, here).dims["L"]
    names = set(diag["ref"]["grad"])
    assert names == set(diag["prog"]["grad"])
    assert "layers/attn/wq/0" in names and "layers/mlp/wi/1" in names
    assert all(n.count("/") <= 3 for n in names)
    assert len([n for n in names if n.startswith("layers/")]) == 9 * L


def test_expert_leaves_are_split_by_layer_and_expert(tmp_path):
    bench, here, cell = _cell(tmp_path, MOE)
    r, diag = _run(bench, here, cell)
    c = harness.Cell(bench, cell, here)
    names = set(diag["ref"]["grad"])
    assert names == set(diag["prog"]["grad"])
    experts = {n for n in names if n.startswith("layers/moe/experts/")}
    assert len(experts) == 3 * c.dims["L"] * c.dims["E"]
    assert "layers/moe/experts/wi/1/3" in experts
    assert "layers/moe/router/1" in names
