"""Logged bfloat16 values: the port's log rows against the reference
package's, on the CPU.

A bfloat16 array larger than the spill threshold is stored in the run's
checkpoint store and logged as a pointer row ``{ref, dtype, shape, nbytes,
digest}``. Both packages must write the same row for the same value: dtype
``"bfloat16"``, the 2-byte values' ``nbytes`` and their blake2b digest, so
a deferred check across the packages compares equal. Below the threshold
the value is inlined as floats, equal in both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.flor as jflor
import repro_torch.flor as flor
from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.logging import FingerprintLog as JaxLog
from repro_torch.checkpoint import CheckpointStore
from repro_torch.logging import FingerprintLog

N = 1000                      # 2000 bytes in bf16, 4000 in f32
SPILL = 1024                  # bytes: the bf16 value spills, 200 do not
EPOCHS = 2


def _values(n=N, seed=0):
    """The same bfloat16 values on both sides (f32 rounded to nearest
    even, which both frameworks do alike)."""
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return jnp.asarray(x, dtype=jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _rows(log_cls, store, path, value):
    log = log_cls(path, fresh=True, spill_bytes=SPILL, store=store)
    log.log(0, "act", value)
    log.close()
    return log_cls.read(path)


@pytest.mark.parametrize("n", [N, 200], ids=["spilled", "inline"])
def test_bf16_row_equals_reference(tmp_path, n):
    jv, tv = _values(n)
    want = _rows(JaxLog, JaxStore(str(tmp_path / "jstore")),
                 str(tmp_path / "j.jsonl"), jv)
    got = _rows(FingerprintLog, CheckpointStore(str(tmp_path / "tstore")),
                str(tmp_path / "t.jsonl"), tv)
    assert len(got) == len(want) == 1
    g, w = got[0]["value"], want[0]["value"]
    if n * 2 > SPILL:
        assert g["dtype"] == w["dtype"] == "bfloat16"
        assert g["nbytes"] == w["nbytes"] == 2 * n
        assert g["shape"] == w["shape"] == [n]
        assert g["digest"] == w["digest"]
        # the stored value is the bf16 tensor itself, bit for bit
        back = CheckpointStore(str(tmp_path / "tstore")) \
            .get_tree(g["ref"])["['v']"]
        assert back.dtype == torch.bfloat16
        assert torch.equal(back.view(torch.int16), tv.view(torch.int16))
    else:
        # inline: float32 values, which hold every bfloat16 value exactly
        assert g == [float(v) for v in tv.float()]
        assert np.allclose(w, g, rtol=0, atol=0)


def _session(pkg, run_dir, mode, value, replay=None):
    kw = {"record": pkg.RecordSpec(adaptive=False, log_spill_bytes=SPILL)} \
        if mode == "record" else {"replay": replay}
    state = {"w": torch.zeros(4) if pkg is flor else jnp.zeros(4)}
    with pkg.Session(run_dir, mode=mode, **kw) as sess:
        with sess.checkpointing(state=state) as ckpt:
            for epoch in sess.loop("epochs", range(EPOCHS)):
                for _ in sess.loop("train", range(2)):
                    ckpt.state = {"w": ckpt.state["w"] + 1}
                pkg.log("act", value)


@pytest.mark.parametrize("recorder", ["reference", "port"])
def test_cross_package_deferred_check_on_a_spilled_bf16_probe(tmp_path,
                                                               recorder):
    """Record with one package, replay every epoch with the other: the
    spilled bf16 rows of record and replay compare equal by digest."""
    jv, tv = _values()
    run = str(tmp_path / "run")
    if recorder == "reference":
        _session(jflor, run, "record", jv)
        _session(flor, run, "replay", tv,
                 replay=flor.ReplaySpec(probed={"train"},
                                        log_spill_bytes=SPILL))
        rec, reps = flor.run_logs(run)
        res = flor.deferred_check(rec, reps)
    else:
        _session(flor, run, "record", tv)
        _session(jflor, run, "replay", jv,
                 replay=jflor.ReplaySpec(probed={"train"},
                                         log_spill_bytes=SPILL))
        rec, reps = jflor.run_logs(run)
        res = jflor.deferred_check(rec, reps)
    assert res.ok, res.anomalies
    assert res.compared == EPOCHS
    rows = [r for r in flor.log_records(run) if r["key"] == "act"]
    assert len(rows) == 2 * EPOCHS
    assert all(r["value"]["dtype"] == "bfloat16" for r in rows)
