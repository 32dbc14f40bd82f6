"""The port's kernels (plain versions and ops dispatch) held against the
reference package's on the same inputs, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
reference runs its jnp oracles or its Pallas kernels in interpret mode (on
the CPU its ops dispatch to those). The bar is exact for the checkpoint
kernels: digests and masks bit for bit, q8/q4 payloads and scales byte for
byte, wire codecs byte for byte, quantize / dequantize values bit for bit.
Flash attention is held to the reference package's own test tolerance
(atol = rtol 2e-6 in f32, 2e-2 in bf16): the two sum in other orders.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.checkpoint.pipeline import PIPELINE_CHUNK_WORDS as CW
from repro_torch.kernels import ops, ref
from repro_torch.kernels.chunk_delta import changed_mask_cuda, fingerprint_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.quantize import (dequantize_rows_cuda,
                                          gather_quantize_cuda,
                                          quantize_rows_cuda)


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
    ops.reset_launch_counts()
    ops.fingerprint_leaf(x, 16)
    ops.changed_chunks(d, d)
    ops.dequantize_blocks(*ops.quantize_blocks(x), x.shape, x.dtype)
    ops.flash_attention(qkv, qkv, qkv)
    assert set(ops.launch_counts().values()) == {0}
    assert len(ops.launch_counts()) == 8


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
    # both compute in f32: bf16 outputs differ by one ulp at most
    for dtype, atol, rtol in ((torch.float32, 2e-6, 2e-6),
                              (torch.bfloat16, 1e-4, 1e-2)):
        qkv = [torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((2, 8, 200, 64), (2, 2, 200, 64), (2, 2, 200, 64))]
        torch.testing.assert_close(
            ops.flash_attention(*qkv).float(),
            ref.flash_attention_ref(*qkv).float(), atol=atol, rtol=rtol)
