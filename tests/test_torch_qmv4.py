"""The port's v4 runtime format and its plain dequant-matmul against the JAX
package.

Layers are quantized by the JAX package from numpy inputs made from a seed;
both packages pack the same codes. Planes must be byte-equal (a bf16 scale
plane compared by its bits) and dequantization bit-equal, for every K-quant
type, both layouts ("i32", "i8") and both scale dtypes. JAX's three v4
Pallas bodies run on the CPU in interpret mode, the "i8" ones included
(``pltpu.bitcast`` interprets), so the plain version is held to them:
within 1e-4 of the largest sum of |terms| of one output (the same bf16
products; only the order of the f32 sums differs). Where JAX's dispatch
runs XLA instead (a d_out its tiles cannot cover), the reference is the
exact f32 product and the bound covers three bf16 roundings per term (x,
the scale, the scale * code product): 2^-7 of the sum of |terms|. The
kernel itself is checked on the card by tests/test_torch_kernel_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptq_gguf_tpu.formats.ggml import GGMLQuantizationType as T
from gptq_gguf_tpu.ops import kquant, qmatmul as jq, qmv4 as jv4
from gptq_gguf_tpu_torch.formats import ggml
from gptq_gguf_tpu_torch.ops import qmatmul, qmv4
from gptq_gguf_tpu_torch.ops.kquant import SuperGroupParams

ALL_K = [T.Q2_K, T.Q3_K, T.Q4_K, T.Q5_K, T.Q6_K]
FORMS = [("i32", "f32"), ("i32", "bf16"), ("i8", "f32"), ("i8", "bf16")]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _codes(qtype, d_out, d_in, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d_out, d_in)).astype(np.float32) * 0.1
    q, p = kquant.quantize_rtn(jnp.asarray(w), qtype)
    return np.asarray(q), p, SuperGroupParams(*(np.asarray(a) for a in p))


def _pair(qtype, layout="i32", sdt="f32", d_out=512, d_in=512, seed=0):
    q, jp, tp = _codes(qtype, d_out, d_in, seed)
    jr = jv4.pack_runtime_v4(q, jp, qtype, scale_dtype=DTYPES[sdt][0], layout=layout)
    tr = qmv4.pack_runtime_v4(q, tp, ggml.GGMLQuantizationType(int(qtype)),
                              scale_dtype=DTYPES[sdt][1], layout=layout, device="cpu")
    return jr, tr


def _bits(a):
    """Exact numpy view of a JAX array or a tensor (bf16 as its bits)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_same_v4(jr, tr):
    for name in ("qs", "scale", "offc"):
        a, b = getattr(jr, name), getattr(tr, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a, b = _bits(a), _bits(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(b, a, err_msg=name)
    for k in ("d_in", "group_size", "per_byte", "layout"):
        assert getattr(tr, k) == getattr(jr, k), k
    assert tr.packed_bits_per_weight == pytest.approx(jr.packed_bits_per_weight, rel=1e-12)


def term_magnitude(x, tr):
    """max over outputs of the sum of |terms| the v4 product adds up:
    |bf16(x)| @ |w| + |xsum| @ |offc|."""
    ng = tr.scale.shape[0]
    s = tr.scale.to(torch.bfloat16).float()
    w = (qmv4._codes_v4(tr).reshape(ng, tr.group_size, tr.d_out) * s[:, None, :]).reshape(
        tr.d_in_local, tr.d_out)
    xb = x.to(torch.bfloat16).float()
    mag = xb.abs() @ w.abs()
    if tr.offc is not None:
        mag = mag + qmv4._group_sums(x, tr.group_size).abs() @ tr.offc.abs()
    return mag.max().item()


@pytest.mark.parametrize("layout,sdt", FORMS)
@pytest.mark.parametrize("qtype", ALL_K)
def test_pack_v4_planes_byte_equal_and_dequant_bit_equal(qtype, layout, sdt):
    jr, tr = _pair(qtype, layout, sdt, seed=int(qtype))
    assert_same_v4(jr, tr)
    got = qmv4.dequantize_runtime_v4(tr).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jv4.dequantize_runtime_v4(jr)))


@pytest.mark.parametrize("sdt", ["f32", "bf16"])
@pytest.mark.parametrize("qtype", ALL_K)
def test_v4_from_v2_equal(qtype, sdt):
    q, jp, tp = _codes(qtype, 256, 512, 40 + int(qtype))
    j2 = jq.pack_runtime_v2(q, jp, qtype)
    t2 = qmatmul.pack_runtime_v2(q, tp, ggml.GGMLQuantizationType(int(qtype)), device="cpu")
    jr = jv4.v4_from_v2(j2, scale_dtype=DTYPES[sdt][0])
    tr = qmv4.v4_from_v2(t2, scale_dtype=DTYPES[sdt][1])
    assert tr.qs is t2.qs  # the code bytes are shared
    assert_same_v4(jr, tr)
    # the same weights as packing the codes directly (i32 layout)
    assert_same_v4(jv4.pack_runtime_v4(q, jp, qtype, scale_dtype=DTYPES[sdt][0]), tr)


@pytest.mark.parametrize("parts", [
    [(T.Q4_K, "i32"), (T.Q4_K, "i32"), (T.Q4_K, "i32")],
    [(T.Q6_K, "i8"), (T.Q6_K, "i8")],
    [(T.Q4_K, "i32"), (T.Q6_K, "i32")],  # a Q4_K_M layer: mixed types stay apart
    [(T.Q4_K, "i32"), (T.Q4_K, "i8")],   # mixed layouts stay apart
])
def test_fuse_rql_v4_equal(parts):
    pairs = [_pair(qt, layout, d_out=256, seed=i) for i, (qt, layout) in enumerate(parts)]
    jf = jv4.fuse_rql_v4([p[0] for p in pairs])
    tf = qmv4.fuse_rql_v4([p[1] for p in pairs])
    if jf is None:
        assert tf is None
        return
    assert_same_v4(jf, tf)
    assert qmv4.fuse_rql_v4([pairs[0][1], qmatmul.pack_runtime_v2(
        *_codes(T.Q4_K, 256, 512, 0)[::2], ggml.GGMLQuantizationType.Q4_K,
        device="cpu")]) is None  # not all v4


@pytest.mark.parametrize("M", [1, 8, 33])
@pytest.mark.parametrize("layout,sdt", FORMS)
@pytest.mark.parametrize("qtype", ALL_K)
def test_plain_v4_matches_jax_interpret(qtype, layout, sdt, M):
    """JAX's v4 Pallas body (by type and layout) plus its offset
    correction, in interpret mode, against the port's plain version."""
    jr, tr = _pair(qtype, layout, sdt, d_out=512, d_in=1024, seed=10 + int(qtype))
    x = np.random.default_rng(M).normal(size=(M, 1024)).astype(np.float32)
    want = np.asarray(jv4.dequant_matmul_v4(jnp.asarray(x), jr, tile_in=512, tile_out=256,
                                            interpret=True))
    xt = torch.from_numpy(x)
    got = qmv4.dequant_matmul_v4_reference(xt, tr).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * term_magnitude(xt, tr))
    # the CPU dispatch takes the plain version
    np.testing.assert_array_equal(qmatmul.dequant_matmul(xt, tr).numpy(), got)


@pytest.mark.parametrize("layout,sdt", [("i32", "f32"), ("i8", "bf16")])
@pytest.mark.parametrize("qtype", [T.Q4_K, T.Q6_K])
def test_plain_v4_matches_jax_interpret_at_a_ragged_decode_m(qtype, layout, sdt):
    """At a decode M the tensor-core decode tile takes (5 rows: its n8
    padded), JAX's v4 body in interpret mode against the port's plain
    version, both layouts, within 1e-4 of the largest sum of |terms|."""
    jr, tr = _pair(qtype, layout, sdt, d_out=512, d_in=1024, seed=60 + int(qtype))
    x = np.random.default_rng(5).normal(size=(5, 1024)).astype(np.float32)
    want = np.asarray(jv4.dequant_matmul_v4(jnp.asarray(x), jr, tile_in=512, tile_out=256,
                                            interpret=True))
    xt = torch.from_numpy(x)
    got = qmv4.dequant_matmul_v4_reference(xt, tr).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * term_magnitude(xt, tr))


def test_bf16_activations_take_the_same_path():
    """bf16 x: the main dot and xsum see the same values as an f32 x of the
    bf16-rounded values."""
    _, tr = _pair(T.Q4_K, seed=3)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(4, 512)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    np.testing.assert_array_equal(qmv4.dequant_matmul_v4(xb, tr).numpy(),
                                  qmv4.dequant_matmul_v4(xb.float(), tr).numpy())


@pytest.mark.parametrize("qtype", [T.Q4_K, T.Q6_K])
def test_plain_v4_close_to_jax_dispatch_on_a_ragged_d_out(qtype):
    """d_out = 333: JAX's select_tiles_v4 finds no tile and its dispatch
    runs the exact f32 XLA product (as it does for every v4 shape on the
    CPU); the port's plain version rounds to bf16, bound 2^-7 of the sum of
    |terms| (three bf16 roundings per term)."""
    jr, tr = _pair(qtype, d_out=333, seed=50 + int(qtype))
    assert jv4.select_tiles_v4(512, 333) is None
    x = np.random.default_rng(9).normal(size=(5, 512)).astype(np.float32)
    want = np.asarray(jq.dequant_matmul(jnp.asarray(x), jr))
    xt = torch.from_numpy(x)
    got = qmatmul.dequant_matmul(xt, tr).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7 * term_magnitude(xt, tr))


def test_wrapper_checks_v4_planes():
    _, tr = _pair(T.Q4_K, seed=4)
    x = torch.zeros(2, 512)
    qmatmul._check_planes(x, tr)
    bad = qmv4.RuntimeQuantLinearV4(tr.qs, tr.scale.half(), tr.offc, tr.d_in, tr.group_size,
                                    tr.per_byte)
    with pytest.raises(ValueError, match="scale"):
        qmatmul._check_planes(x, bad)
    short = qmv4.RuntimeQuantLinearV4(tr.qs, tr.scale, tr.offc[:4], tr.d_in, tr.group_size,
                                      tr.per_byte)
    with pytest.raises(ValueError, match="offc"):
        qmatmul._check_planes(x, short)
    with pytest.raises(ValueError, match="layout"):
        qmv4.pack_runtime_v4(np.zeros((4, 256), np.uint8), SuperGroupParams(
            *(np.zeros((4, n), dt) for n, dt in ((1, np.float16), (1, np.float16),
                                                 (8, np.uint8), (8, np.uint8)))),
            ggml.GGMLQuantizationType.Q4_K, layout="u4", device="cpu")
