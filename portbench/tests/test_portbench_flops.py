"""The useful-FLOP count against values worked out by hand."""
import json
import os

import pytest

from portbench import flops
from portbench.reference import model as ref

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def _dims(name):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return ref.dims(json.load(f))


def test_keys_seen():
    assert flops.keys_seen(4, None) == 1 + 2 + 3 + 4
    assert flops.keys_seen(6, 3) == 1 + 2 + 3 + 3 + 3 + 3
    assert flops.keys_seen(5, 8) == 15


def test_granite_3_2b():
    m = _dims("granite-3-2b")
    # a layer: q and o 2048 x 2048 each, k and v 2048 x 512 each, SwiGLU
    # 3 x 2048 x 8192, two norms of 2048; 8 layers and the final norm
    layer = 2 * 2048 * 2048 + 2 * 2048 * 512 + 3 * 2048 * 8192 + 2 * 2048
    assert layer == 60_821_504
    assert flops.active_params(m) == 8 * layer + 2048 == 486_574_080
    # record_4k: 4 x 4096 tokens
    body = 6 * 486_574_080 * 16_384
    head = 6 * 2048 * 49_155 * 4 * 4095
    attn = 12 * 4 * 32 * 64 * (4096 * 4097 // 2) * 8
    assert flops.step_flops(m, 4, 4096) == body + head + attn
    assert flops.step_flops(m, 4, 4096) == pytest.approx(6.4324e13, rel=1e-4)
    # record_512: 32 x 512, the same tokens
    attn512 = 12 * 32 * 32 * 64 * (512 * 513 // 2) * 8
    head512 = 6 * 2048 * 49_155 * 32 * 511
    assert flops.step_flops(m, 32, 512) == body + head512 + attn512
    assert flops.step_flops(m, 32, 512) == pytest.approx(5.8535e13, rel=1e-4)


def test_mixtral_8x7b():
    m = _dims("mixtral-8x7b")
    # a token: q and o 4096 x 4096, k and v 4096 x 1024, two of eight
    # SwiGLU experts 3 x 4096 x 14336, the 4096 x 8 router, two norms;
    # then the final norm
    layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 2 * 3 * 4096 * 14336 \
        + 4096 * 8 + 2 * 4096
    assert flops.active_params(m) == layer + 4096 == 394_309_632
    body = 6 * 394_309_632 * 8192
    head = 6 * 4096 * 32_000 * 8191
    attn = 12 * 32 * 128 * (8192 * 8193 // 2)      # causal: no window
    assert flops.step_flops(m, 1, 8192) == body + head + attn
    assert flops.step_flops(m, 1, 8192) == pytest.approx(2.7472e13, rel=1e-4)


def test_window_counts_fewer_keys():
    m = dict(_dims("mixtral-8x7b"), window=4096)
    full = flops.step_flops(dict(m, window=None), 1, 8192)
    cut = 12 * 32 * 128 * (8192 * 8193 // 2 - flops.keys_seen(8192, 4096))
    assert flops.step_flops(m, 1, 8192) == full - cut
