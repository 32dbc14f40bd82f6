"""``flor.log`` of CUDA tensors on the card (``cuda``-marked: each skips
without a CUDA card):

a logged value is the tensor's value when it was logged, whatever the
step path writes into the tensor afterwards, in the asynchronous log (an
asynchronous copy into pinned memory, which the stage waits for) as in the
synchronous one, for float32, bfloat16 and integer tensors, logged behind
a hundred large products queued on the card.

Run on the card with ``python -m pytest -m cuda tests/test_torch_log_card.py``.
"""
import pytest
import torch

from repro_torch.logging import FingerprintLog


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the copy under test is the card's")
    return torch.device("cuda")


def _values(dev):
    return {"loss": torch.tensor(2.5, device=dev),
            "act": torch.linspace(-1, 1, 300, device=dev).bfloat16(),
            "count": torch.arange(7, device=dev, dtype=torch.int64)}


@pytest.mark.cuda
@pytest.mark.parametrize("async_log", [True, False], ids=["async", "sync"])
def test_logged_value_is_its_value_when_logged(tmp_path, dev, async_log):
    vals = _values(dev)
    want = {k: v.float().cpu().tolist() for k, v in vals.items()}
    log = FingerprintLog(str(tmp_path / "log"), fresh=True,
                         async_log=async_log)
    _keep_busy(100)
    for k, v in vals.items():
        log.log(0, k, v)
        v.add_(1)               # the step path reuses the tensor
    log.close()
    rows = {r["key"]: r["value"] for r in FingerprintLog.read(
        str(tmp_path / "log"))}
    assert set(rows) == set(want)
    for k, v in want.items():
        assert rows[k] == pytest.approx(v, abs=0.0), k


def _keep_busy(n):
    """Queue ``n`` products of two 8192-square bfloat16 matrices, 1.1 TFLOP
    each: at least 1.1 ms apiece at an H100's 989 TFLOP/s peak."""
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    b = torch.empty_like(a)
    for _ in range(n):
        torch.matmul(a, a, out=b)
