"""The port's checkpoint kernels (plain versions and ops dispatch) held
against the reference package's on the same inputs, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
reference runs its jnp oracles (on the CPU its ops dispatch to them). The
bar is exact: digests and masks bit for bit, q8/q4 payloads and scales byte
for byte, wire codecs byte for byte.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.checkpoint.pipeline import PIPELINE_CHUNK_WORDS as CW
from repro_torch.kernels import ops, ref
from repro_torch.kernels.chunk_delta import fingerprint_cuda
from repro_torch.kernels.quantize import gather_quantize_cuda


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
    ops.reset_launch_counts()
    ops.fingerprint_leaf(x, 16)
    assert set(ops.launch_counts().values()) == {0}


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
