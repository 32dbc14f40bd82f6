"""The port's kernels (plain versions and ops dispatch) held against the
reference package's on the same inputs, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
reference runs its jnp oracles or its Pallas kernels in interpret mode (on
the CPU its ops dispatch to those). The bar is exact for the checkpoint
kernels: digests and masks bit for bit, q8/q4 payloads and scales byte for
byte, wire codecs byte for byte, quantize / dequantize values bit for bit.
Flash attention is held to the reference package's own test tolerance
(atol = rtol 2e-6 in f32, 2e-2 in bf16): the two sum in other orders. The
card kernels' key split and the tensor-core kernel's hi/lo split of P are
held here through their plain-torch arithmetic.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.checkpoint.pipeline import PIPELINE_CHUNK_WORDS as CW
from repro_torch.kernels import adamw as adamw_kernels
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels.chunk_delta import changed_mask_cuda, fingerprint_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.quantize import (dequantize_rows_cuda,
                                          gather_quantize4_cuda,
                                          gather_quantize_cuda, q4_lanes,
                                          q8_lanes, quantize_rows_cuda)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(a: np.ndarray):
    """(reference-package array, port tensor) holding the same bytes."""
    if a.dtype == jnp.bfloat16:
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return jnp.asarray(a), t


def _u32(t: torch.Tensor) -> np.ndarray:
    """Port digests (int32 bit patterns) as the reference's uint32."""
    return t.numpy().view(np.uint32)


def _leaf(kind: str, n: int, rng) -> np.ndarray:
    if kind == "float32":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "bfloat16":
        return rng.standard_normal(n).astype(np.float32).astype(jnp.bfloat16)
    if kind == "float16":
        return (-rng.random(n)).astype(np.float16)    # sign bits set
    if kind == "int32":
        return rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64) \
            .astype(np.int32)
    if kind == "uint32":
        return rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "uint8":
        return rng.integers(0, 256, n).astype(np.uint8)
    if kind == "bool":
        return rng.random(n) < 0.5
    raise ValueError(kind)


KINDS = ["float32", "bfloat16", "float16", "int32", "uint32", "uint8", "bool"]


# ------------------------------------------------------- word view / digest
@pytest.mark.parametrize("kind", KINDS + ["int64"])
def test_as_u32_blocks_matches_reference(kind):
    rng = np.random.default_rng(1)
    n = 1001
    if kind == "int64":
        a = rng.integers(-2 ** 62, 2 ** 62, n, dtype=np.int64)
        # the reference fingerprints 64-bit host leaves through their u32
        # view (pipeline._fp_view); the port's word view of int64 is that
        # same view
        jx = jnp.asarray(a.view(np.uint32))
        t = torch.from_numpy(a.copy())
    else:
        jx, t = _pair(_leaf(kind, n, rng))
    want = np.asarray(jops._as_u32_blocks(jx, 64))
    got = ops._as_u32_blocks(t, 64)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert ops.native_bytes_per_word(t.dtype) \
        == jops.native_bytes_per_word(kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,cw", [(1, 16), (999, 64), (40001, CW)])
def test_fingerprint_and_changed_match_reference(kind, n, cw):
    rng = np.random.default_rng(n)
    jx, t = _pair(_leaf(kind, n, rng))
    want = np.asarray(jops.fingerprint_leaf(jx, cw))
    got = ops.fingerprint_leaf(t, cw)
    np.testing.assert_array_equal(_u32(got), want)
    prev = want.copy()
    prev[::3, 0] ^= np.uint32(1)
    jd, jm = jops.fingerprint_and_changed(jx, jnp.asarray(prev), cw)
    d, m = ops.fingerprint_and_changed(
        t, torch.from_numpy(prev.view(np.int32).copy()), cw)
    np.testing.assert_array_equal(_u32(d), np.asarray(jd))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert m.dtype == torch.int32 and int(m.sum()) == len(prev[::3])


@pytest.mark.parametrize("case", ["scalar", "ones_rows", "zero_rows",
                                  "int64_odd", "florbench_wq_rows"])
def test_fingerprint_edge_cases(case):
    """The chip_smoke edge inputs: a scalar leaf (8 rows of zero padding
    folded in), 0xFFFFFFFF rows, all-zero rows (padding words still mix
    their position), an odd-length int64 leaf (two words an element, as
    the reference fingerprints its u32 view), and the row count of a real
    florbench-100m leaf (attn wq [12, 768, 12, 64]: 433 rows, partial
    last, G padded to 440)."""
    if case == "int64_odd":
        a = np.random.default_rng(5).integers(-2 ** 62, 2 ** 62, 12345,
                                              dtype=np.int64)
        want = np.asarray(jops.fingerprint_leaf(
            jnp.asarray(a.view(np.uint32)), CW))
        np.testing.assert_array_equal(
            _u32(ops.fingerprint_leaf(torch.from_numpy(a.copy()), CW)), want)
        return
    if case == "scalar":
        a = np.asarray(7, np.int32)
    elif case == "ones_rows":
        a = np.full(3 * CW + 5, -1, np.int32)
    elif case == "zero_rows":
        a = np.zeros(2 * CW, np.float32)
    else:
        a = np.random.default_rng(0).standard_normal(
            (12, 768, 12, 64)).astype(np.float32)
    jx, t = _pair(a)
    want = np.asarray(jops.fingerprint_leaf(jx, CW))
    got = ops.fingerprint_leaf(t, CW)
    assert got.shape[0] % 8 == 0 and got.shape == want.shape
    np.testing.assert_array_equal(_u32(got), want)
    if case == "zero_rows":
        assert (want != 0).all()             # (0 ^ j*P1)*P2 != 0


def test_fingerprint_ref_position_and_bit_sensitivity():
    x = torch.arange(4 * 64, dtype=torch.int64).reshape(4, 64)
    d = ref.fingerprint_ref(x)
    flipped = x.clone()
    flipped[2, 5] ^= 1
    swapped = x.clone()
    swapped[1, [3, 4]] = swapped[1, [4, 3]]
    assert (ref.fingerprint_ref(flipped) != d).any(dim=1).tolist() \
        == [False, False, True, False]
    assert (ref.fingerprint_ref(swapped) != d).any(dim=1).tolist() \
        == [False, True, False, False]


# ------------------------------------------------------- gather + quantize
def _ties(q4: bool, W: int) -> np.ndarray:
    """Every element divides by its block scale to an exact k + 0.5."""
    qmax = 7.0 if q4 else 127.0
    j = np.arange(W, dtype=np.float32)
    h = np.remainder(j, 2 * int(qmax)) - qmax + 0.5
    h[::256] = qmax
    return np.concatenate([h, 2.0 * h]).astype(np.float32)


def _q_case(case: str, q4: bool):
    rng = np.random.default_rng(7)
    if case == "f32_partial_last_row_C1":
        return (1e-3 * rng.standard_normal(5 * CW + 777)).astype(
            np.float32), [5], CW
    if case == "f32_rows_cw16":
        return rng.standard_normal(999).astype(np.float32), \
            [62, 0, 7, 3], 16
    if case == "f32_cw1024":
        return rng.standard_normal(20001).astype(np.float32), \
            list(range(0, 20, 3)), 1024
    if case == "bf16_odd":
        return _leaf("bfloat16", 50001, rng), [0, 1, 2, 3], CW
    if case == "f16_odd":
        return _leaf("float16", 40003, rng), [2, 0], CW
    if case == "zero_rows":
        return np.zeros(3 * CW + 100, np.float32), [0, 1, 2, 3], CW
    if case == "ties":
        return _ties(q4, CW), [0, 1], CW
    raise ValueError(case)


Q_CASES = ["f32_partial_last_row_C1", "f32_rows_cw16", "f32_cw1024",
           "bf16_odd", "f16_odd", "zero_rows", "ties"]


@pytest.mark.parametrize("q4", [False, True], ids=["q8", "q4"])
@pytest.mark.parametrize("case", Q_CASES)
def test_gather_quantize_matches_reference(case, q4):
    a, idx, cw = _q_case(case, q4)
    jx, t = _pair(a)
    jf = jops.gather_quantize4_blocks if q4 else jops.gather_quantize_blocks
    tf = ops.gather_quantize4_blocks if q4 else ops.gather_quantize_blocks
    jq, js = jf(jx, jnp.asarray(idx, jnp.int32), cw)
    q, s = tf(t, torch.tensor(idx, dtype=torch.int32), cw)
    assert q.dtype == (torch.uint8 if q4 else torch.int8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))


def _gq4_lanes_emulated(rows: torch.Tensor, W: int, block: int):
    """The q4 kernel's work split in plain torch: thread t of a row owns
    packed bytes [16t, 16t + 16), i.e. 16 elements of each half-row; each
    half's absmax reduces over the ``q4_lanes`` neighbouring threads (both
    halves together when the row is one sub-block)."""
    G = q4_lanes(W, block)
    C = rows.shape[0]
    half, n_sub = W // 2, W // block
    lo = rows[:, :half].reshape(C, -1, 16)
    hi = rows[:, half:].reshape(C, -1, 16)
    m_lo, m_hi = lo.abs().amax(-1), hi.abs().amax(-1)      # per thread
    if n_sub == 1:
        m_lo = m_hi = torch.maximum(m_lo, m_hi)
    m_lo = m_lo.reshape(C, -1, G).amax(-1).repeat_interleave(G, dim=1)
    m_hi = m_hi.reshape(C, -1, G).amax(-1).repeat_interleave(G, dim=1)
    recip = torch.full((), 1.0 / 7.0, dtype=torch.float32)
    s_lo = torch.clamp_min(m_lo * recip, 1e-12)
    s_hi = torch.clamp_min(m_hi * recip, 1e-12)
    q_lo = torch.clamp(torch.round(lo / s_lo[..., None]), -7, 7).to(
        torch.int32) & 0xF
    q_hi = torch.clamp(torch.round(hi / s_hi[..., None]), -7, 7).to(
        torch.int32) & 0xF
    packed = (q_lo | (q_hi << 4)).reshape(C, half).to(torch.uint8)
    seg0 = torch.arange(0, W // 32, G)                      # group leaders
    scales = torch.empty(C, n_sub)
    scales[:, 16 * seg0 // block] = s_lo[:, seg0]
    if n_sub > 1:
        scales[:, (16 * seg0 + half) // block] = s_hi[:, seg0]
    return packed, scales


@pytest.mark.parametrize("W,block", [(CW, 256), (1024, 256), (256, 256),
                                     (64, 64), (512, 16)])
def test_q4_kernel_work_split_matches_plain(W, block):
    """The q4 gather kernel's lanes, segments and scale writes, emulated in
    torch, give the plain version's bytes and scales exactly (exact .5 ties
    and random rows)."""
    rng = np.random.default_rng(W + block)
    rows = torch.from_numpy(np.concatenate([
        rng.standard_normal((3, W)).astype(np.float32),
        np.resize(_ties(True, 256)[:256], (1, W))]))
    q, s = _gq4_lanes_emulated(rows, W, block)
    q2, s2 = ref.gather_quantize4_ref(rows, torch.arange(4), block)
    assert torch.equal(q, q2)
    assert torch.equal(s.view(torch.int32), s2.view(torch.int32))


@pytest.mark.parametrize("W,block", [(16, 16), (768, 256), (2048, 1024),
                                     (96, 96), (4096, 8)])
def test_q4_kernel_refuses_row_shapes_it_does_not_take(W, block):
    with pytest.raises(ValueError, match="q4 kernel"):
        q4_lanes(W, block)


def _gq8_lanes_emulated(rows: torch.Tensor, W: int, block: int):
    """The q8 kernel's work split in plain torch: thread t of a row owns
    elements [16t, 16t + 16), its 16 output bytes; the absmax reduces over
    the ``q8_lanes`` neighbouring threads, whose first writes the scale."""
    G = q8_lanes(W, block)
    C = rows.shape[0]
    x = rows.reshape(C, -1, 16)
    m = x.abs().amax(-1)                                    # per thread
    m = m.reshape(C, -1, G).amax(-1).repeat_interleave(G, dim=1)
    recip = torch.full((), 1.0 / 127.0, dtype=torch.float32)
    s = torch.clamp_min(m * recip, 1e-12)
    q = torch.clamp(torch.round(x / s[..., None]), -127, 127).to(
        torch.int8).reshape(C, W)
    seg0 = torch.arange(0, W // 16, G)                      # group leaders
    scales = torch.empty(C, W // block)
    scales[:, 16 * seg0 // block] = s[:, seg0]
    return q, scales


@pytest.mark.parametrize("W,block", [(CW, 256), (1024, 256), (768, 256),
                                     (64, 64), (16, 16), (512, 512)])
def test_q8_kernel_work_split_matches_plain(W, block):
    """The q8 gather kernel's lanes, segments and scale writes, emulated in
    torch, give the plain version's bytes and scales exactly (random rows,
    and exact .5 ties with every sub-block's absmax at 127 and 254)."""
    rng = np.random.default_rng(W + block)
    ties = _ties(False, W).reshape(2, W)
    ties[:, ::block] = ties[:, :1]
    rows = torch.from_numpy(np.concatenate([
        rng.standard_normal((3, W)).astype(np.float32), ties]))
    q, s = _gq8_lanes_emulated(rows, W, block)
    q2, s2 = ref.gather_quantize_ref(rows, torch.arange(5), block)
    assert torch.equal(q, q2)
    assert torch.equal(s.view(torch.int32), s2.view(torch.int32))


@pytest.mark.parametrize("W,block", [(16, 8), (40, 16), (96, 96),
                                     (2048, 1024), (768, 48), (64, 128)])
def test_q8_kernel_refuses_row_shapes_it_does_not_take(W, block):
    with pytest.raises(ValueError, match="the q8 kernel"):
        q8_lanes(W, block)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "float16"])
def test_chunk_absmax_matches_reference(kind):
    jx, t = _pair(_leaf(kind, 3 * 64 + 5, np.random.default_rng(3)))
    np.testing.assert_array_equal(ops.chunk_absmax(t, 64).numpy(),
                                  np.asarray(jops.chunk_absmax(jx, 64)))
    assert ops.quantizable_dtype(t.dtype) and jops.quantizable_dtype(kind)


# ----------------------------------------------- changed mask (stand-alone)
def test_changed_chunks_matches_reference():
    """Digests that differ in word 0 only, word 1 only, both, or neither."""
    rng = np.random.default_rng(4)
    d = rng.integers(0, 2 ** 32, (64, 2), dtype=np.uint64).astype(np.uint32)
    prev = d.copy()
    prev[1::4, 0] ^= np.uint32(1)
    prev[2::4, 1] ^= np.uint32(0x80000000)
    prev[3::4] ^= np.uint32(0xFFFFFFFF)
    want = np.asarray(jops.changed_chunks(jnp.asarray(d), jnp.asarray(prev)))
    got = ops.changed_chunks(torch.from_numpy(d.view(np.int32).copy()),
                             torch.from_numpy(prev.view(np.int32).copy()))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.tolist() == [0, 1, 1, 1] * 16


# ---------------------------------------------- quantize / dequantize rows
def _qrow_case(case: str) -> np.ndarray:
    rng = np.random.default_rng(9)
    if case == "f32_odd":
        return (1e-3 * rng.standard_normal(5001)).astype(np.float32)
    if case == "f32_2d":
        return rng.standard_normal((37, 129)).astype(np.float32)
    if case in ("bfloat16", "float16"):
        return _leaf(case, 3001, rng)
    if case == "zero_rows":
        return np.zeros(8 * 256 + 100, np.float32)
    if case == "ties":
        return _ties(False, 2048)
    if case == "pm_absmax":
        a = (2 * rng.random(16 * 256) - 1).astype(np.float32)
        a[0::256], a[1::256] = 3.0, -3.0
        a[600] = -5.0
        return a
    raise ValueError(case)


@pytest.mark.parametrize("case", ["f32_odd", "f32_2d", "bfloat16", "float16",
                                  "zero_rows", "ties", "pm_absmax"])
def test_quantize_dequantize_blocks_match_reference(case):
    """q, scales (the folded absmax * fl(1/127)) and the dequantized
    values trimmed and cast back to the leaf's dtype, bit for bit."""
    a = _qrow_case(case)
    jx, t = _pair(a)
    jq, js = jops.quantize_blocks(jx, block=256)
    q, s = ops.quantize_blocks(t, 256)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape[0] % 8 == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    jback = np.asarray(jops.dequantize_blocks(jq, js, a.shape, jx.dtype))
    back = ops.dequantize_blocks(q, s, a.shape, t.dtype)
    assert back.dtype == t.dtype and tuple(back.shape) == a.shape
    np.testing.assert_array_equal(_np_bits(back), _np_bits(jback))


def _np_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 \
        else x.view(np.dtype(f"u{x.dtype.itemsize}"))


# --------------------------------------------------------- flash attention
FLASH_CFGS = [
    # B, H, KV, Sq, Sk, d, bq, bk, causal (the reference's own test cases)
    (1, 2, 2, 128, 128, 64, 64, 64, True),
    (2, 4, 2, 128, 128, 64, 128, 128, True),
    (1, 8, 1, 64, 256, 32, 64, 64, True),     # MQA, decode-ish Sq < Sk
    (2, 2, 2, 128, 128, 128, 64, 32, False),  # bidirectional
    (1, 4, 2, 128, 64, 32, 64, 64, True),     # Sq > Sk: rows that see no key
]


def _qkv(cfg, dtype):
    B, H, KV, Sq, Sk, d = cfg[:6]
    rng = np.random.default_rng(sum(cfg[:8]))
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d))]
    if dtype == "bfloat16":
        arrs = [a.astype(jnp.bfloat16) for a in arrs]
    return [_pair(a) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", FLASH_CFGS)
def test_flash_attention_matches_reference_kernel(dtype, cfg):
    (jq, q), (jk, k), (jv, v) = _qkv(cfg, dtype)
    causal = cfg[8]
    want = flash_attention_pallas(jq, jk, jv, causal=causal,
                                  block_q=cfg[6], block_k=cfg[7])
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and tuple(got.shape) == want.shape
    tol = 2e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_flash_attention_fully_masked_rows_average_v():
    """Causal with Sq > Sk: query rows r < Sq - Sk see no key; -1e30 (not
    -inf) makes them the mean of v, in both packages."""
    cfg = FLASH_CFGS[-1]
    (jq, q), (jk, k), (jv, v) = _qkv(cfg, "float32")
    B, H, KV, Sq, Sk = cfg[:5]
    got = ops.flash_attention(q, k, v, causal=True)
    mean_v = v.mean(dim=2).repeat_interleave(H // KV, dim=1)
    blind = got[:, :, :Sq - Sk]
    torch.testing.assert_close(blind, mean_v[:, :, None].expand_as(blind),
                               atol=1e-6, rtol=1e-6)
    want = np.asarray(flash_attention_pallas(jq, jk, jv, causal=True,
                                             block_q=64, block_k=64))
    np.testing.assert_allclose(blind.numpy(), want[:, :, :Sq - Sk],
                               atol=2e-6, rtol=2e-6)


# ------------------------------------------- flash attention: key split
SPLIT_SHAPES = [
    # B, H, Sq, Sk, d
    (1, 40, 128, 2048, 128),      # chip_smoke's Sq < Sk case: 3 splits
    (1, 40, 2048, 2048, 128),     # qwen3-14b layer: grid large, no split
    (8, 12, 512, 512, 64),        # florbench-100m: no split
    (2, 4, 200, 200, 24),         # ragged, CUDA-core route, 4 splits
    (1, 4, 320, 256, 64),         # rows that see no key, 4 splits
    (1, 1, 1, 1, 64),             # one key
    (1, 2, 64, 4097, 128),        # ragged last tile
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_flash_split_plan_covers_every_key_once(shape, dtype):
    """The wrapper's split plan (a pure function of the shapes): the key
    ranges of the splits are non-empty, in order, and cover [0, Sk) exactly
    once; a split grid stays within the CTAs the card holds at once for the
    route, and a grid that fills them is not split."""
    B, H, Sq, Sk, d = shape
    p = fa.plan(B, H, Sq, Sk, d, dtype)
    assert p["route"] == ("wgmma" if dtype == torch.bfloat16
                          and d in (64, 128) else "cuda-core")
    ranges = fa.split_ranges(Sk, p["n_split"], p["per"])
    assert len(ranges) == p["n_split"] >= 1
    covered = np.zeros(Sk, np.int64)
    for k0, k1 in ranges:
        assert k0 < k1 and k0 % fa.KEY_TILE == 0
        covered[k0:k1] += 1
    assert (covered == 1).all()
    assert [r[0] for r in ranges] == sorted(r[0] for r in ranges)
    ctas = -(-Sq // p["block_q"]) * H * B
    slots = fa.RESIDENT_CTAS[p["route"]]
    if ctas * 2 > slots or Sk <= fa.KEY_TILE:
        assert p["n_split"] == 1
    else:
        assert 2 <= p["n_split"] and ctas * p["n_split"] <= slots


def _split_combine(q, k, v, *, causal, n_split, per, block_q, block_k=64):
    """Plain-torch split-and-combine in flash_attention_ref's arithmetic (f32
    scores, -1e30 causal mask), following the kernels' rules: each query
    tile runs the key tiles up to its last row's diagonal when its every row
    sees key 0 (else all of them), split s takes tiles [s per, (s + 1) per)
    of those; a split with no tile has m = -inf, l = 0 and weighs 0."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G, off = H // KV, Sk - Sq
    s = torch.einsum("bkgqd,bksd->bkgqs",
                     q.reshape(B, KV, G, Sq, d).float(), k.float())
    s = s / np.sqrt(d)
    if causal:
        keep = torch.arange(Sk)[None, :] <= torch.arange(Sq)[:, None] + off
        s = torch.where(keep, s, torch.full((), -1e30))
    n_kt = -(-Sk // block_k)
    ms, ls, accs = [], [], []
    for sp in range(n_split):
        m_t, l_t, a_t = [], [], []
        for row0 in range(0, Sq, block_q):
            rows = slice(row0, min(row0 + block_q, Sq))
            kt_end = n_kt
            if causal and row0 + off >= 0:
                kt_end = min(n_kt, (min(row0 + block_q, Sq) - 1 + off)
                             // block_k + 1)
            k0 = sp * per * block_k
            k1 = min(min((sp + 1) * per, kt_end) * block_k, Sk)
            st = s[..., rows, :]
            if k1 <= k0:
                m_t.append(torch.full(st.shape[:-1], -torch.inf))
                l_t.append(torch.zeros(st.shape[:-1]))
                a_t.append(torch.zeros(*st.shape[:-1], d))
                continue
            st = st[..., k0:k1]
            m = st.amax(dim=-1)
            e = torch.exp(st - m[..., None])
            m_t.append(m)
            l_t.append(e.sum(dim=-1))
            a_t.append(torch.einsum("bkgqs,bksd->bkgqd", e,
                                    v[:, :, k0:k1].float()))
        ms.append(torch.cat(m_t, dim=-1))
        ls.append(torch.cat(l_t, dim=-1))
        accs.append(torch.cat(a_t, dim=-2))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    m_max = torch.where(l > 0, m, -torch.inf).amax(dim=0)
    w = torch.where(l > 0, torch.exp(m - m_max), torch.zeros(()))
    o = (w[..., None] * acc).sum(0) / torch.clamp_min((w * l).sum(0),
                                                      1e-30)[..., None]
    # partials with no key tile, and partials of rows that see a key but
    # none in this split (scored -1e30 throughout): both must weigh 0
    sees = (torch.arange(Sq) + off >= 0)
    masked = (l > 0) & (m <= -1e30) & sees
    return o.reshape(B, H, Sq, d), int((l == 0).sum()), int(masked.sum())


@pytest.mark.parametrize("cfg", [
    # B, H, KV, Sq, Sk, d, route of the plan
    (1, 2, 1, 128, 2048, 32, "wgmma"),
    (1, 2, 1, 128, 2048, 32, "cuda-core"),
    (1, 2, 1, 256, 256, 32, "wgmma"),          # splits that see no key
    (1, 2, 1, 256, 256, 32, "cuda-core"),
    (1, 4, 2, 320, 256, 64, "wgmma"),          # rows that see no key
    (1, 4, 2, 320, 128, 32, "cuda-core"),
], ids=["sq<sk-bq128", "sq<sk-bq64", "square-bq128", "square-bq64",
        "blind-bq128", "blind-bq64"])
def test_flash_split_combine_matches_reference_kernel(cfg):
    """Splitting the keys and combining the partials computes the
    reference's function: held against flash_attention_pallas (interpret
    mode) at 2e-6 in f32. The split counts are those the wrapper picks at
    this (narrow) grid, at least 2; on the square causal shape some splits
    see no key tile and some rows see no key in a split (both weigh 0), and
    rows that see no key at all still average v."""
    B, H, KV, Sq, Sk, d, rt = cfg
    rng = np.random.default_rng(Sq + Sk)
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d))]
    (jq, q), (jk, k), (jv, v) = (_pair(a) for a in arrs)
    bq = fa.query_tile(rt)
    n_split, per = fa.split_plan(B, H, Sq, Sk, bq, fa.RESIDENT_CTAS[rt])
    assert n_split >= 2
    got, n_empty, n_masked = _split_combine(q, k, v, causal=True,
                                            n_split=n_split, per=per,
                                            block_q=bq)
    want = np.asarray(flash_attention_pallas(jq, jk, jv, causal=True,
                                             block_q=64, block_k=64))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=2e-6)
    if Sq > Sk:
        mean_v = v.mean(dim=2).repeat_interleave(H // KV, dim=1)
        blind = got[:, :, :Sq - Sk]
        torch.testing.assert_close(blind, mean_v[:, :, None].expand_as(blind),
                                   atol=1e-6, rtol=1e-6)
    if Sq == Sk:      # early query tiles end before the last splits
        assert n_empty > 0
        assert n_masked > 0 or bq == 64


def _hi_lo(p: torch.Tensor, dtype):
    hi = p.to(dtype)
    return hi, (p - hi.float()).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_p_hi_lo_reconstructs_p(dtype):
    """hi = fl16(p), lo = fl16(p - hi): hi + lo is p to within 2**-16
    relative (plus half of f16's subnormal spacing, 2**-25, where lo falls
    below f16's normal range), for p over the softmax's range (0, 1]."""
    rng = np.random.default_rng(5)
    p = torch.from_numpy(np.exp(-rng.uniform(0, 20, 100_000))
                         .astype(np.float32))
    hi, lo = _hi_lo(p, dtype)
    err = (hi.float() + lo.float() - p).abs()
    floor = 2.0 ** -25 if dtype == torch.float16 else 0.0
    assert bool((err <= 2.0 ** -16 * p + floor).all())
    # hi alone is 8 (bf16) or 11 (f16) bits: far from that bound
    assert float(((hi.float() - p).abs() / p).max()) > 2.0 ** -13


def test_flash_p_hi_lo_keeps_cancelling_rows_in_tolerance():
    """Why the tensor-core kernel splits P: on a row whose output cancels,
    a single bf16 rounding of P before P.V leaves FLASH_TOL's (atol 1e-4,
    rtol 1e-2), the hi + lo pair stays inside it. Seeded worst case of the
    2**-9 sum(p |v|) bound: v = +-1 following the sign of p's rounding
    error, 2048 keys, scores in [-1, 0]."""
    rng = np.random.default_rng(9)
    p = torch.from_numpy(np.exp(-rng.uniform(0, 1, 2048))
                         .astype(np.float32))
    hi, lo = _hi_lo(p, torch.bfloat16)
    v = torch.sign(hi.float() - p)
    v[v == 0] = 1.0
    l = p.sum()
    want = (p.double() @ v.double()) / l.double()

    def off_tol(o):
        return float((o.double() - want).abs() - 1e-2 * want.abs()) > 1e-4

    single = (hi.float() @ v) / l
    pair = (hi.float() @ v + lo.float() @ v) / l
    assert off_tol(single)
    assert not off_tol(pair)


# --------------------------------------------------------------- codecs
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("q4", [False, True], ids=["q8", "q4"])
def test_wire_codecs_match_reference(dtype, q4):
    """Encode the same quantized row with both packages (bytes equal), then
    decode to native leaf bytes (equal, bf16 included)."""
    rng = np.random.default_rng(11)
    W, n_el = 1024, 1000
    scales = (rng.random(W // 256) + 0.1).astype(np.float32)
    if q4:
        row = rng.integers(0, 256, W // 2).astype(np.uint8)
        enc = (ops.q4_encode_chunk(row, scales, n_el),
               jops.q4_encode_chunk(row, scales, n_el))
    else:
        row = rng.integers(-127, 128, W).astype(np.int8)
        enc = (ops.q8_encode_chunk(row, scales, n_el),
               jops.q8_encode_chunk(row, scales, n_el))
    assert enc[0] == enc[1]
    name = "q4" if q4 else "q8"
    assert ops.decode_wire_chunk(enc[0], name, dtype) \
        == jops.decode_wire_chunk(enc[1], name, dtype)


def test_decode_wire_chunk_entropy_suffix():
    from repro.parallel.compression import entropy_encode_bytes
    rng = np.random.default_rng(2)
    payload = jops.q8_encode_chunk(
        np.zeros(512, np.int8), np.ones(2, np.float32), 512)
    z = entropy_encode_bytes(payload, itemsize=1)
    assert ops.decode_wire_chunk(z, "q8+z", "float32") \
        == jops.decode_wire_chunk(z, "q8+z", "float32")
    raw = rng.standard_normal(64).astype(np.float32).tobytes()
    assert ops.decode_wire_chunk(raw, "raw", "float32") == raw


# ------------------------------------------------------- dispatch contract
def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only; the CPU path is the ops
    dispatch to the plain versions, chosen by the tensor's device."""
    x = torch.zeros(64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fingerprint_cuda(x, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather_quantize_cuda(x, torch.zeros(1, dtype=torch.int32), 16, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather_quantize4_cuda(x, torch.zeros(1, dtype=torch.int32), 32, 16)
    d = torch.zeros(8, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        changed_mask_cuda(d, d)
    with pytest.raises(ValueError, match="CUDA tensor"):
        quantize_rows_cuda(x, 16, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dequantize_rows_cuda(torch.zeros(8, 16, dtype=torch.int8),
                             torch.ones(8), 64, torch.float32)
    qkv = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(qkv, qkv, qkv)
    with pytest.raises(ValueError, match="CUDA tensors"):
        adamw_kernels.norm_and_scale([x], 1.0)
    s = torch.ones(())
    with pytest.raises(ValueError, match="CUDA tensors"):
        adamw_kernels.update([x], [x], [x], [x], [False], s, s, s, s,
                             b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
                             moment_dtype=torch.float32)
    ops.reset_launch_counts()
    ops.fingerprint_leaf(x, 16)
    ops.changed_chunks(d, d)
    ops.dequantize_blocks(*ops.quantize_blocks(x), x.shape, x.dtype)
    ops.flash_attention(qkv, qkv, qkv)
    assert set(ops.launch_counts().values()) == {0}
    assert len(ops.launch_counts()) == 12


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """On the card: each kernel against its plain version on the same CUDA
    tensors (chip_smoke.py runs the full set of cases)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(3 * CW + 77, generator=gen, device=dev)
    d, m = ops.fingerprint_and_changed(x, ops.fingerprint_leaf(x, CW), CW)
    assert torch.equal(d, ref.fingerprint_ref(ops._as_u32_blocks(x, CW)))
    assert int(m.sum()) == 0
    idx = torch.tensor([3, 0], dtype=torch.int32, device=dev)
    for kern, plain in ((ops.gather_quantize_blocks, ref.gather_quantize_ref),
                        (ops.gather_quantize4_blocks,
                         ref.gather_quantize4_ref)):
        q, s = kern(x, idx, CW)
        q2, s2 = plain(ops._padded_float_blocks(x, CW), idx)
        assert torch.equal(q, q2) and torch.equal(s, s2)
    # q8 at chunk_words 64 (4 lanes a sub-block): the last 67 rows, the
    # last one partial, so the second CTA's first warp has idle lanes that
    # join the shuffles
    g64 = -(-x.numel() // 64)
    idx = torch.arange(g64 - 67, g64, dtype=torch.int32, device=dev)
    q, s = ops.gather_quantize_blocks(x, idx, 64)
    q2, s2 = ref.gather_quantize_ref(ops._padded_float_blocks(x, 64), idx, 64)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    prev = d.clone()
    prev[::2, 1] ^= 1
    assert torch.equal(ops.changed_chunks(d, prev),
                       ref.changed_mask_ref(d, prev).to(torch.int32))
    q, s = ops.quantize_blocks(x)
    g = q.shape[0]
    q2, s2 = ref.quantize_ref(torch.nn.functional.pad(
        x, (0, g * 256 - x.numel())).reshape(g, 256))
    assert torch.equal(q, q2) and torch.equal(s, s2)
    back = ops.dequantize_blocks(q, s, x.shape, torch.bfloat16)
    assert torch.equal(back, ref.dequantize_ref(q, s).reshape(-1)[
        :x.numel()].to(torch.bfloat16))
    # both compute in f32: bf16 / f16 outputs differ by one ulp at most.
    # Shapes [B, H, KV, Sq, Sk, d]: both routes, a key split at Sq < Sk
    # (7 splits on the tensor cores, 4 on the CUDA cores), d 24 (CUDA-core
    # route in f16)
    tol = {torch.float32: (2e-6, 2e-6), torch.bfloat16: (1e-4, 1e-2),
           torch.float16: (1e-4, 1e-2)}
    for dtype, (B, H, KV, Sq, Sk, d) in (
            (torch.float32, (2, 8, 2, 200, 200, 64)),
            (torch.bfloat16, (2, 8, 2, 200, 200, 64)),
            (torch.float16, (2, 8, 2, 200, 200, 128)),
            (torch.bfloat16, (1, 40, 8, 128, 2048, 128)),
            (torch.float32, (1, 40, 8, 128, 2048, 128)),
            (torch.float16, (2, 4, 2, 200, 200, 24))):
        qkv = [torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d))]
        atol, rtol = tol[dtype]
        torch.testing.assert_close(
            ops.flash_attention(*qkv).float(),
            ref.flash_attention_ref(*qkv).float(), atol=atol, rtol=rtol)
