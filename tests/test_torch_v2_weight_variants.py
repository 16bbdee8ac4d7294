"""The port's per-weight v2 kernel variants v3, v2f, v2h and v2s against
the JAX package's Pallas bodies in interpret mode (the layers and the
checks of test_torch_v2_variants.py; a file of their own so that neither
file holds up one test worker for long). The kernels themselves are
checked on the card by tests/test_torch_kernel_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptq_gguf_tpu.ops import qmatmul as jq
from gptq_gguf_tpu_torch.ops import qmatmul
from tests.test_torch_kernel_cuda import _edge_planes, _v2h_edge_planes
from tests.test_torch_qmatmul import ALL_K
from tests.test_torch_v2_variants import MXU, PLAIN, _pair, check_plain_against_jax


@pytest.mark.parametrize("mxu", list(MXU))
@pytest.mark.parametrize("M", [1, 8, 33])
@pytest.mark.parametrize("variant,qtype", [(v, q) for v in ("v3", "v2f", "v2h", "v2s")
                                           for q in PLAIN[v][1]],
                         ids=lambda a: getattr(a, "name", a))
def test_per_weight_plain_matches_jax_interpret(variant, qtype, M, mxu):
    """As test_plain_matches_jax_interpret: rtol 1e-5, atol 1e-4 of max|y|
    (the same products, another order of the f32 sums)."""
    check_plain_against_jax(variant, qtype, M, mxu)


@pytest.mark.parametrize("qtype", PLAIN["v2s"][1], ids=lambda q: q.name)
def test_v2s_plain_matches_jax_interpret_at_prefill_rows(qtype):
    """v2s at 130 rows with bf16 operands, a shape its tensor-core tiles
    serve on the card: the plain version they are held to there against
    JAX's body (rtol 1e-5, atol 1e-4 of max|y|)."""
    check_plain_against_jax("v2s", qtype, 130, "bf16")


@pytest.mark.parametrize("mxu", list(MXU))
@pytest.mark.parametrize("variant", ["v3", "v2f", "v2h"])
def test_per_weight_build_bit_equal_to_jax(variant, mxu):
    """x = I through JAX's body in interpret mode returns its weights (the
    products with 1 and 0 are exact), less the xsum term's off2 for v3: the
    plain version's weights, with each rounding in JAX's order (v2h rounds
    after its product and after its subtraction), equal them bit for bit.
    v2f's f32 weight is v2's, dequantize_runtime_v2."""
    tdt, jdt = MXU[mxu]
    eye = np.eye(512, dtype=np.float32)
    for qtype in ALL_K:
        jr, tr = _pair(qtype)
        want = np.asarray(jq.dequant_matmul_pallas_v2(jnp.asarray(eye), jr, interpret=True,
                                                      variant=variant, mxu_dtype=jdt))
        got = PLAIN[variant][0](torch.from_numpy(eye), tr, tdt).numpy()
        np.testing.assert_array_equal(got, want, err_msg=qtype.name)
        if variant == "v2f":
            w, corrects = qmatmul._v2_operand(tr, "v2f", torch.float32)
            assert not corrects
            np.testing.assert_array_equal(w.numpy(), qmatmul.dequantize_runtime_v2(tr).T.numpy())


def _round_bf16(v):
    """float64 values rounded to nearest even at bf16's 8-bit significand
    (as float64; no value here overflows or is subnormal in bf16)."""
    b = v.view(np.uint64)
    lsb = (b >> np.uint64(45)) & np.uint64(1)
    b = (b + np.uint64((1 << 44) - 1) + lsb) & ~np.uint64((1 << 45) - 1)
    return b.view(np.float64)


def test_v2h_bf16_pair_arithmetic_equals_the_f32_path():
    """v2h's decode tile forms each weight in packed bf16 arithmetic, an FMA
    s (128 + q) - 128 s and a subtraction, each rounded once to nearest
    even; the plain version (and JAX's body) round f32 results,
    T(T(s * q) - o), s = T(scale), o = T(off2). On the card test's planted
    planes, emulated exactly in float64 (the exact values need at most 49
    significant bits there), the two are bit-equal, with ties in either
    rounding and exponent gaps past 16 binades (where the f32 subtraction
    itself rounds) among the weights."""
    rql = _v2h_edge_planes("cpu")
    scale, off2 = qmatmul._folded_planes_v2(rql)
    q = qmatmul._unpack_codes(rql.qs, 2, 256).double().reshape(8, 32, -1).numpy()
    s = scale.to(torch.bfloat16).double().numpy()[:, None, :]
    o = off2.to(torch.bfloat16).double().numpy()[:, None, :]
    exact_p = s * q
    p = _round_bf16(exact_p)
    exact_w = p - o
    got = _round_bf16(exact_w).reshape(256, -1)
    want = qmatmul._v2_operand(rql, "v2h", torch.bfloat16)[0].double().numpy()
    np.testing.assert_array_equal(got, want)

    def ties(v):
        return int(((v.view(np.uint64) & np.uint64((1 << 45) - 1)) == np.uint64(1 << 44)).sum())

    gap = np.abs(np.floor(np.log2(np.abs(p) + 1e-300)) - np.floor(np.log2(np.abs(o) + 1e-300)))
    assert ties(exact_p) > 0 and ties(exact_w) > 0
    assert int(((gap > 16) & (p != 0)).sum()) > 1000


def _ties(v):
    """float64 values exactly halfway between two bf16 neighbours."""
    return int(((v.view(np.uint64) & np.uint64((1 << 45) - 1)) == np.uint64(1 << 44)).sum())


@pytest.mark.parametrize("qtype", ALL_K, ids=lambda q: q.name)
def test_v3_bf16_pair_arithmetic_equals_the_f32_path(qtype):
    """v3's decode tile forms each weight in packed bf16 arithmetic: one
    byte permute and a mask give bf16(128 + q) (exact: at most 8
    significant bits), one FMA s (128 + q) - 128 s (128 s exact in bf16)
    rounds the exact s * q once to nearest even. The plain version (and
    JAX's body) round the f32 product, T(T(scale) * q), exact in f32. On
    the planted planes of _edge_planes (the largest super-scale, scale and
    code of the format among them), emulated exactly in float64, the two
    are equal, with ties of the rounding among the weights."""
    rql = _edge_planes(qtype, "cpu")
    scale, _ = qmatmul._folded_planes_v2(rql)
    ng, gs, d_out = scale.shape[0], rql.group_size, rql.d_out
    q = qmatmul._unpack_codes(rql.qs, rql.per_byte, rql.d_in_local).double()
    q = q.reshape(ng, gs, d_out).numpy()
    s = scale.to(torch.bfloat16).double().numpy()[:, None, :]
    m = 128 + q
    assert np.array_equal(_round_bf16(m), m) and np.array_equal(_round_bf16(128 * s), 128 * s)
    exact = s * m - 128 * s  # the FMA's exact value (at most 16 significant bits)
    got = _round_bf16(exact).reshape(ng * gs, d_out)
    want = qmatmul._v2_operand(rql, "v3", torch.bfloat16)[0].double().numpy()
    np.testing.assert_array_equal(got, want)
    assert _ties(exact) > 0
    # the largest super-scale, scale magnitude and code meet in one weight
    sc_big = np.abs(rql.sc_q.numpy().astype(np.float64)).max()
    biggest = _round_bf16(_round_bf16(np.array([65504 * sc_big])) * q.max())[0]
    assert np.abs(got).max() == biggest


def _v2_fma_form(rql):
    """The weights of v2's decode-tile FMA forms (V2Mma::frags_v2) on the
    planes of rql, f32 (d_in, d_out): fma(s, 128 + q, nb) with nb = -s (128
    + shift), emulated with the FMA's one rounding taken from the exact
    float64 value, then, for the formats with a min, one f32 subtraction
    of off2. Asserts nb exact and, without a min, the FMA exact."""
    scale, off2 = qmatmul._folded_planes_v2(rql)
    ng, gs, d_out = scale.shape[0], rql.group_size, rql.d_out
    q = qmatmul._unpack_codes(rql.qs, rql.per_byte, rql.d_in_local).numpy().astype(np.float32)
    q = q.reshape(ng, gs, d_out)
    s = scale.numpy()[:, None, :]
    nb = -s * np.float32(128 + rql.shift)  # f32 product
    assert np.array_equal(nb.astype(np.float64), -s.astype(np.float64) * (128 + rql.shift))
    exact = s.astype(np.float64) * (np.float32(128) + q).astype(np.float64) + nb
    w = exact.astype(np.float32)  # the FMA's one rounding
    if rql.has_min:
        w = w - off2.numpy()[:, None, :]
    else:
        assert np.array_equal(w.astype(np.float64), exact)  # s (q - shift), exact
    return w.reshape(ng * gs, d_out)


@pytest.mark.parametrize("qtype", ALL_K, ids=lambda q: q.name)
def test_v2_fma_forms_equal_the_f32_path(qtype):
    """v2's decode tile forms each weight as fma(s, 128 + q, nb) with nb =
    -s (128 + shift) (128 + q from one byte permute), then, for the formats
    with a min, one f32 subtraction of off2. nb is exact in f32 (s has at
    most 18 significant bits, 128 + shift is 128, 132 or 160), so the FMA
    rounds the exact s (q - shift) once, which is itself; the subtraction
    rounds s * q - off2 once. On the planted planes of _edge_planes,
    emulated with the FMA's one rounding taken from the exact float64
    value, these are weight_q<kV2>'s f32 weights (dequantize_runtime_v2)
    bit for bit, and so are their bf16 roundings."""
    rql = _edge_planes(qtype, "cpu")
    w = _v2_fma_form(rql)
    want = qmatmul._v2_operand(rql, "v2", torch.float32)[0].numpy()
    np.testing.assert_array_equal(w, want)
    np.testing.assert_array_equal(
        torch.from_numpy(w).to(torch.bfloat16).float().numpy(),
        qmatmul._v2_operand(rql, "v2", torch.bfloat16)[0].numpy())


@pytest.mark.parametrize("mxu", ["f32", "bf16"])
@pytest.mark.parametrize("qtype", ALL_K, ids=lambda q: q.name)
def test_v2f_fma_form_equals_the_f32_path(qtype, mxu):
    """v2f's decode tile builds v2's fragments (V2Mma<kV2f> takes
    frags_v2): its weight scale * q - off2 is v2's value, for off2 is v2's
    offset where the format has a min (shift 0) and the exact scale *
    shift where it has none (shift 4 or 32, powers of two), and scale * q -
    scale * shift is the exact scale * (q - shift) (at most 24 significant
    bits). On the planted planes of _edge_planes the FMA form equals the
    plain version's v2f operand (_v2_operand(rql, "v2f", ...), the JAX
    body's weight) bit for bit, in f32 and rounded to bf16."""
    rql = _edge_planes(qtype, "cpu")
    w = torch.from_numpy(_v2_fma_form(rql))
    dt = torch.float32 if mxu == "f32" else torch.bfloat16
    want = qmatmul._v2_operand(rql, "v2f", dt)[0]
    assert want.dtype == torch.float32
    np.testing.assert_array_equal(w.to(dt).float().numpy(), want.numpy())
