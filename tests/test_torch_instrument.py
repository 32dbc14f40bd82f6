"""Hands-free mode in the port (``repro_torch.core.changeset``,
``repro_torch.core.instrument``, ``repro_torch.flor``): the Table-1
changeset rules and the instrumenter on the reference's own cases
(tests/test_flor_core.py), the instrumented source against the reference
package's, and the script tier end to end on the CPU with a torch training
script (tests/test_record_replay.py): record, probe detection, replay."""
import ast
import os
import textwrap

import pytest
import torch

import repro.flor as jax_flor
import repro_torch.flor as flor
from repro.core.instrument import instrument_source as jax_instrument_source
from repro_torch.core.changeset import analyze_loop, augment_changeset
from repro_torch.core.instrument import exec_instrumented, instrument_source
from repro_torch.core.probes import detect_probes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _loop(src):
    tree = ast.parse(textwrap.dedent(src))
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.While)):
            return node, tree
    raise AssertionError("no loop")


# ------------------------------------------------------ changeset (5.2) ----

RULE1 = """
for batch in data:
    preds = net.forward(batch)
"""
RULE2 = """
for batch in data:
    state = step(state, batch)
"""
RULE4 = """
for batch in data:
    optimizer.step()
"""
RULE5 = """
for epoch in range(10):
    train()
    evaluate(net)
"""
RULE0 = """
for i in data:
    x = f(i)
    x = y
"""
FIGURE6 = """
for batch in training_data_loader:
    preds = net(batch.X)
    avg_loss = loss(preds, batch.Y)
    avg_loss.backward()
    optimizer.step()
"""


@pytest.mark.parametrize("src,outer,want", [
    (RULE1, {"net", "data"}, ["net"]),                 # preds/batch scoped
    (RULE2, {"state", "step", "data"}, ["state"]),
    (RULE4, {"optimizer", "data"}, ["optimizer"]),
], ids=["rule1_method_call_assignment", "rule2_function_call_assignment",
        "rule4_method_call_statement"])
def test_changeset_rules(src, outer, want):
    res = analyze_loop(_loop(src)[0], outer_assigned=outer)
    assert res.ok and res.changeset == want


@pytest.mark.parametrize("src,outer,rule", [
    (RULE5, {"net"}, "rule 5"),
    (RULE0, {"x", "y", "data"}, "rule 0"),
], ids=["rule5_refuses_bare_call", "rule0_refuses_reassignment"])
def test_changeset_refusals(src, outer, rule):
    res = analyze_loop(_loop(src)[0], outer_assigned=outer)
    assert not res.ok and rule in res.refused_reason


def test_figure6_example():
    """The paper's Fig. 6 inner loop: changeset {optimizer} after
    filtering (net added later by runtime augmentation)."""
    res = analyze_loop(_loop(FIGURE6)[0], outer_assigned={
        "net", "loss", "optimizer", "training_data_loader"})
    assert res.ok
    assert res.changeset in (["avg_loss", "optimizer"],
                             ["optimizer", "avg_loss"], ["optimizer"])
    assert "batch" in res.loop_scoped and "preds" in res.loop_scoped


def test_runtime_augmentation_optimizer_implies_model():
    """The ``flor_tracks`` protocol, as the reference has it: an object in
    the changeset names the objects it changes with it."""
    class Opt:
        def flor_tracks(self):
            return ["net"]

    net = object()
    ns = {"optimizer": Opt(), "net": net}
    assert augment_changeset(["optimizer"], ns) == ["optimizer", "net"]
    assert flor.augment({"optimizer": ns["optimizer"]}, ns) == {
        "optimizer": ns["optimizer"], "net": net}


# ---------------------------------------------------- instrumenter (4.2) ----

WRAPS = """
state = init()
metrics = {}
for epoch in range(4):
    for s in range(3):
        state, metrics = step(state, s)
    report(metrics)
"""
REFUSES = """
for epoch in range(4):
    for s in range(3):
        do_stuff(s)
"""
WHILE = """
state = init()
epoch = 0
while epoch < 3:
    for s in range(2):
        state = step(state, s)
    epoch = epoch + 1
"""
CONTINUE_BREAK = """
state = init()
for epoch in range(4):
    for s in range(5):
        if s == 1:
            continue
        state = step(state, s)
        if s == 3:
            break
    flor.log('s', state)
"""
NESTED3 = """
state = init()
opt = make_opt()
for epoch in range(2):
    for chunk in range(3):
        for s in range(4):
            state = step(state, chunk, s)
            opt.update(state)
    flor.log('state', state)
"""


def test_instrument_wraps_inner_loop_and_main_generator():
    out, rep = instrument_source(textwrap.dedent(WRAPS))
    # session surface: the outer loop wraps the main iterator, the inner
    # loop is a named flor.loop inside a flor.checkpointing scope
    assert out.startswith("import repro_torch.flor as flor\n")
    assert "flor.loop('main_L4', range(4))" in out
    assert "flor.loop('L5'" in out
    assert "flor.checkpointing(" in out
    assert "flor.skipblock" not in out
    assert list(rep.instrumented.values()) == [["state", "metrics"]]
    assert len(rep.main_loops) == 1     # not skippable (report() is rule 5)


def test_instrument_refuses_rule5_inner_loop():
    _, rep = instrument_source(textwrap.dedent(REFUSES))
    assert rep.instrumented == {}
    assert len(rep.refused) == 1


def _example(name):
    with open(os.path.join(ROOT, "examples", name)) as f:
        return f.read()


@pytest.mark.parametrize("src", [
    WRAPS, REFUSES, WHILE, CONTINUE_BREAK, NESTED3, RULE1, RULE2, RULE4,
    RULE5, RULE0, FIGURE6, "example:quickstart.py",
    "example:torch_quickstart.py"],
    ids=["wraps", "refuses", "while", "continue_break", "nested3", "rule1",
         "rule2", "rule4", "rule5", "rule0", "figure6", "quickstart",
         "torch_quickstart"])
def test_instrumented_source_matches_reference(src):
    """The same source out of both packages but for the import line, and
    the same report."""
    src = _example(src.split(":", 1)[1]) if src.startswith("example:") \
        else textwrap.dedent(src)
    out, rep = instrument_source(src)
    jout, jrep = jax_instrument_source(src)
    head, _, body = out.partition("\n")
    jhead, _, jbody = jout.partition("\n")
    assert head == "import repro_torch.flor as flor"
    assert jhead == "import repro.flor as flor"
    assert body == jbody
    assert rep.__dict__ == jrep.__dict__


def test_flor_exports_cover_reference():
    public = {n for n in dir(jax_flor) if not n.startswith("_")}
    assert public <= set(dir(flor)), sorted(public - set(dir(flor)))


# ------------------------------------------------------- script tier (3) ----

SCRIPT = """
import repro_torch.configs as C
from repro_torch.data import synthetic_batch
from repro_torch.train.step import build_train_step
cfg = C.get_smoke('florbench-100m').replace(
    num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=32)
init_state, ts = build_train_step(cfg, device='cpu')
state = init_state(0)
metrics = {}
for epoch in range(3):
    for s in range(2):
        batch = synthetic_batch(cfg, 2, 32, epoch * 2 + s)
        state, metrics = ts(state, batch)
    flor.log('loss', metrics['loss'])
"""


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
        else t


def test_script_tier_end_to_end(tmp_path):
    """``import flor`` is the only user-visible change (paper section 3):
    record an instrumented torch script, detect the added probe against
    the recorded source, replay with it (deferred check), then replay with
    no probe: every epoch restored, the final state the recorded one."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.utils.pytree import tree_leaves

    torch.set_num_threads(2)
    script = tmp_path / "train_script.py"
    script.write_text(textwrap.dedent(SCRIPT))
    run = str(tmp_path / "run")
    ns, report = exec_instrumented(str(script), run_dir=run, mode="record",
                                   adaptive=False)
    assert list(report.instrumented.values()) == [["state", "metrics"]]
    recorded = [x.clone() for x in tree_leaves(ns["state"])]
    store = CheckpointStore(os.path.join(run, "store"))
    assert len(store.list_keys()) == 3          # every epoch checkpointed

    probed_src = script.read_text().replace(
        "state, metrics = ts(state, batch)",
        "state, metrics = ts(state, batch)\n        "
        "flor.log('probe', metrics['grad_norm'])")
    probed_path = tmp_path / "probed.py"
    probed_path.write_text(probed_src)
    rep = detect_probes(store.get_meta("source")["src"], probed_src)
    assert rep.probed_blocks and not rep.suspicious
    exec_instrumented(str(probed_path), run_dir=run, mode="replay",
                      probed=rep.probed_blocks)
    res = flor.deferred_check(*flor.run_logs(run))
    assert res.ok and res.hindsight_only == 6

    ns2, _ = exec_instrumented(str(script), run_dir=run, mode="replay")
    got = tree_leaves(ns2["state"])
    assert len(got) == len(recorded)
    for a, b in zip(got, recorded):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def test_restore_grafts_an_empty_dict_into_its_checkpoint(tmp_path):
    """A checkpoint of ``{"metrics": {...}, "state": ...}`` restores into
    a ``like`` whose ``metrics`` is still ``{}`` (the scope a skipped first
    epoch restores into); any other mismatch still raises."""
    from repro_torch.checkpoint import CheckpointStore

    store = CheckpointStore(str(tmp_path / "store"))
    tree = {"metrics": {"loss": torch.tensor(1.5), "sub": {
        "a": torch.arange(3)}}, "state": (torch.ones(2), torch.zeros(1))}
    store.put_tree("k", tree)
    got = store.get_tree("k", like={"metrics": {},
                                    "state": (torch.ones(2), torch.ones(1))})
    assert got["metrics"]["loss"] == 1.5
    assert torch.equal(got["metrics"]["sub"]["a"], torch.arange(3))
    assert torch.equal(got["state"][1], torch.zeros(1))
    with pytest.raises(ValueError, match="structure mismatch"):
        store.get_tree("k", like={"metrics": {}, "state": (torch.ones(2),)})
