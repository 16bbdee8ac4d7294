"""The port's v2 kernel variants against the JAX package.

The variant dispatch (``PALLAS_V2_VARIANT`` / ``_GS16`` through
``_effective_v2_variant``) must pick what JAX picks; the plain versions of
the per-weight kernels (v2g, v2, v3, v2f, v2h, v2s) and of the group-dot
kernels (v2m, v2t, v2p) are held to JAX's Pallas bodies in interpret mode;
the Q8 path to JAX's XLA reference. Layers are quantized by the JAX package from seeded
numpy inputs and packed by both packages (``test_torch_qmatmul._layer``).
The kernels themselves are checked on the card by
tests/test_torch_kernel_cuda.py."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptq_gguf_tpu.formats.ggml import GGMLQuantizationType as T
from gptq_gguf_tpu.ops import qmatmul as jq
from gptq_gguf_tpu_torch.formats import ggml
from gptq_gguf_tpu_torch.ops import qmatmul
from tests.test_torch_qmatmul import ALL_K, _layer

MXU = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}
NIBBLE_K = [T.Q2_K, T.Q3_K, T.Q4_K]


def per_weight_plain(variant):
    return lambda x, rql, mxu=torch.bfloat16: qmatmul.dequant_matmul_v2w_reference(
        x, rql, mxu, variant)


# each variant, its plain version, and the types it runs on itself (v2g's
# are held to JAX in test_torch_qmatmul.py; the held cases of v3, v2f, v2h
# and v2s are in test_torch_v2_weight_variants.py, which shares this file's
# layers)
PLAIN = {"v2": (qmatmul.dequant_matmul_v2_reference, ALL_K),
         "v3": (per_weight_plain("v3"), ALL_K), "v2f": (per_weight_plain("v2f"), ALL_K),
         "v2h": (per_weight_plain("v2h"), ALL_K), "v2s": (per_weight_plain("v2s"), NIBBLE_K),
         "v2m": (qmatmul.dequant_matmul_v2m_reference, [T.Q4_K, T.Q5_K]),
         "v2t": (qmatmul.dequant_matmul_v2m_reference, [T.Q4_K, T.Q5_K]),
         "v2p": (qmatmul.dequant_matmul_v2m_reference, [T.Q2_K, T.Q3_K, T.Q6_K])}
HERE = ("v2", "v2m", "v2t", "v2p")
WRAPPERS = qmatmul.V2_WRAPPERS


@functools.lru_cache(maxsize=None)
def _pair(qtype):
    """(JAX weight, port weight) of one seeded 512 x 512 layer."""
    return _layer(qtype, seed=40 + int(qtype))


def _spec(qtype):
    return ggml.KQUANT_SPECS[ggml.GGMLQuantizationType(int(qtype))]


@pytest.mark.parametrize("variant", qmatmul.V2_VARIANTS)
def test_effective_variant_matches_jax(variant):
    """JAX's table at every tile_in / B the TPU could take: its sublane
    rules never fire when tile_in is a multiple of 256."""
    assert qmatmul.V2_VARIANTS == tuple(jq._V2_KERNELS)
    for qtype in ALL_K:
        spec = _spec(qtype)
        per_byte = 2 if spec.bits <= 4 else 1
        got = qmatmul._effective_v2_variant(variant, gs=spec.group_size, per_byte=per_byte)
        for tile_in in (256, 1024, 8192):
            for B in (1, 3, 8, 33):
                assert got == jq._effective_v2_variant(
                    variant, gs=spec.group_size, per_byte=per_byte, tile_in=tile_in,
                    B=B), (qtype.name, tile_in, B)


@pytest.mark.parametrize("knob,gs16", [("v2g", ""), ("v2", ""), ("v2m", ""), ("v2t", ""),
                                       ("v2p", ""), ("v2g", "v2p"), ("v2m", "v2"),
                                       ("v2s", ""), ("v3", "v2h"), ("v2f", "")])
def test_effective_variant_for_follows_the_knobs(knob, gs16, monkeypatch):
    for mod in (qmatmul, jq):
        monkeypatch.setattr(mod, "PALLAS_V2_VARIANT", knob)
        monkeypatch.setattr(mod, "PALLAS_V2_VARIANT_GS16", gs16)
    for qtype in ALL_K:
        jr, tr = _pair(qtype)
        for B in (1, 8):
            assert qmatmul.effective_v2_variant_for(tr, B) == jq.effective_v2_variant_for(
                jr, B), qtype.name
        assert qmatmul.effective_v2_variant_for(tr, variant="v2t") == \
            jq.effective_v2_variant_for(jr, variant="v2t")


@pytest.mark.parametrize("mxu", list(MXU))
@pytest.mark.parametrize("M", [1, 8, 33])
@pytest.mark.parametrize("variant,qtype", [(v, q) for v in HERE for q in PLAIN[v][1]],
                         ids=lambda a: getattr(a, "name", a))
def test_plain_matches_jax_interpret(variant, qtype, M, mxu):
    check_plain_against_jax(variant, qtype, M, mxu)


@pytest.mark.parametrize("variant,qtype", [(v, q) for v in qmatmul.MMA_GROUP_DOT
                                           for q in PLAIN[v][1]],
                         ids=lambda a: getattr(a, "name", a))
def test_plain_matches_jax_interpret_at_prefill_rows(variant, qtype):
    """v2m / v2t / v2p at 130 rows with bf16 operands, a shape their
    tensor-core tiles serve on the card: the plain version they are held to
    there against JAX's body."""
    check_plain_against_jax(variant, qtype, 130, "bf16")


def check_plain_against_jax(variant, qtype, M, mxu):
    """Tolerance: the plain version and JAX's body of the same variant form
    the same products (bf16 x bf16 or raw codes, exact in f32; or the same
    f32 operands) and differ only in the order of the f32 sums: rtol 1e-5,
    atol 1e-4 of max|y|."""
    jr, tr = _pair(qtype)
    tdt, jdt = MXU[mxu]
    x = np.random.default_rng(M + 100 * int(qtype)).normal(size=(M, 512)).astype(np.float32)
    want = np.asarray(jq.dequant_matmul_pallas_v2(jnp.asarray(x), jr, interpret=True,
                                                  variant=variant, mxu_dtype=jdt))
    plain = PLAIN[variant][0]
    got = plain(torch.from_numpy(x), tr, tdt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4 * np.abs(want).max())
    # the wrapper and the dispatch take the plain version for a CPU x
    wrapper = getattr(qmatmul, WRAPPERS[variant])
    np.testing.assert_array_equal(wrapper(torch.from_numpy(x), tr, tdt).numpy(), got)
    np.testing.assert_array_equal(
        qmatmul.dequant_matmul_v2(torch.from_numpy(x), tr, variant=variant,
                                  mxu_dtype=tdt).numpy(), got)


def _decode_slice(pb, kh, j):
    """csrc/qmatmul_decode_mma.cuh::decode_slice: the k16 slice (of a 64-row
    step) that K half kh's warps take as their slice j."""
    return kh + 2 * j if pb == 2 else 2 * kh + j


def _in_decode_order(x, rql, form, swap=False):
    """A variant as its tensor-core decode tile computes it (the decode
    mainloop of csrc/qmatmul_decode_mma.cuh), in f32: per 64-row step q of a
    supergroup the staged code rows (4-bit codes: byte rows 32q.. of the
    supergroup, whose low nibbles are step rows 0-31 and high nibbles
    32-63; byte codes: rows 64q..), each K half kh's two k16 slices j taken
    by decode_slice's map; the first half also takes the step's xsum @
    off2 out; the halves meet at the end. The forms:

    * "v2t" (GroupSumMma): each slice's exact partial bf16(x) @ q scaled by
      the step's group 16 * sl / 32, the two summed into a step sum added
      to the half once;
    * "v2m" (GroupDotMma at gs 32): each scaled slice partial added to the
      half by itself;
    * "v2s" (V2Mma<kV2s>, F::SPLIT_HALVES): v2g's weights bf16(scale * q),
      slice 0 (the low nibbles) added to the half, slice 1 (the high
      nibbles, 128 rows up) summed apart and added after it.

    ``swap`` plants a fault: the group-dot forms give each slice the
    step's other group (a wrong nibble-group map), v2s dots each nibble
    slice with the x rows of the other nibble."""
    M, d_in = x.shape
    pb, gs, d_out = rql.per_byte, rql.group_size, rql.d_out
    scale, off2 = qmatmul._folded_planes_v2(rql)
    w = qmatmul._v2_operand(rql, "v2s", torch.bfloat16)[0] if form == "v2s" else None
    xb, x32 = x.to(torch.bfloat16).float(), x.float()
    half = [torch.zeros(M, d_out), torch.zeros(M, d_out)]
    for sg in range(d_in // 256):
        for q in range(4):
            if pb == 2:
                b = rql.qs[sg * 128 + 32 * q: sg * 128 + 32 * q + 32].int()
                codes = torch.cat([b & 0xF, b >> 4]).float()
                rows = [*range(32 * q, 32 * q + 32), *range(128 + 32 * q, 160 + 32 * q)]
            else:
                codes = rql.qs[sg * 256 + 64 * q: sg * 256 + 64 * q + 64].float()
                rows = list(range(64 * q, 64 * q + 64))
            rows = torch.tensor(rows) + 256 * sg
            x_rows = torch.cat([rows[32:], rows[:32]]) if swap and form == "v2s" else rows
            group = [int(rows[32 * lg]) // 32 for lg in range(2)]  # the step's staged gs-32 groups
            for kh in range(2):
                s = None
                for j in range(2):
                    sl = _decode_slice(pb, kh, j)
                    k = slice(16 * sl, 16 * sl + 16)
                    if form == "v2s":
                        p = xb[:, x_rows[k]] @ w[rows[k]]
                    else:
                        g = group[(16 * sl // 32) ^ int(swap)]
                        p = (xb[:, rows[k]] @ codes[k]) * scale[g]
                    if form == "v2t":
                        s = p if s is None else s + p
                    else:
                        half[kh] = half[kh] + p
                if form == "v2t":
                    half[kh] = half[kh] + s
            for g in sorted({int(r) // gs for r in rows}):
                xs = x32[:, torch.arange(gs * g, gs * g + gs)].sum(1, keepdim=True)
                half[0] = half[0] - xs * off2[g]
    return half[0] + half[1]


@pytest.mark.parametrize("form,qtype", [("v2t", T.Q4_K), ("v2t", T.Q5_K), ("v2m", T.Q4_K),
                                        ("v2m", T.Q5_K), ("v2s", T.Q4_K), ("v2s", T.Q2_K),
                                        ("v2s", T.Q3_K)], ids=lambda a: getattr(a, "name", a))
@pytest.mark.parametrize("M", [1, 8])
def test_decode_order_matches_jax_interpret(form, qtype, M):
    """The function v2t's, v2m's and v2s's decode tiles compute, each in
    its order (_in_decode_order), against JAX's _kernel_v2t, _kernel_v2m and
    _kernel_v2s in interpret mode on a bf16-valued x: the products are
    exact on both sides (raw codes, or v2g's bf16 weights) and only the
    grouping and the order of the f32 sums differ, so within 1e-5 of the
    largest sum of |terms| of an output (the limit the tiles are held to
    on the card). The same order with the planted fault (the slices'
    groups swapped; for v2s x's halves swapped against the nibbles) fails
    that limit."""
    jr, tr = _pair(qtype)
    x = torch.from_numpy(np.random.default_rng(M + 50).normal(size=(M, 512)).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    want = np.asarray(jq.dequant_matmul_pallas_v2(jnp.asarray(x.numpy()), jr, interpret=True,
                                                  variant=form, mxu_dtype=jnp.bfloat16))
    _, off2 = qmatmul._folded_planes_v2(tr)
    # the weights as the terms: v2s's rounded, the group dots' scale * q unrounded
    w = qmatmul._v2_operand(tr, "v2s" if form == "v2s" else "v2g",
                            torch.bfloat16 if form == "v2s" else torch.float32)[0]
    gs = tr.group_size
    terms = x.abs() @ w.abs() + x.reshape(M, 512 // gs, gs).sum(-1).abs() @ off2.abs()
    tol = 1e-5 * terms.max().item()
    np.testing.assert_allclose(_in_decode_order(x, tr, form).numpy(), want, rtol=0, atol=tol)
    assert np.abs(_in_decode_order(x, tr, form, swap=True).numpy() - want).max() > tol


@pytest.mark.parametrize("qtype", ALL_K)
def test_v2_weight_bit_equal_to_dequantize(qtype):
    """The v2 kernel builds each weight as d * sc, then * (q - shift), then
    - off (JAX's order). Every product is exact in f32 (at most 24
    significant bits), so that f32 weight equals dequantize_runtime_v2 bit
    for bit, and so does the same value with the subtraction fused (one
    rounding of the exact s * q - off, as an FMA gives). The plain version
    reproduces it: x = I returns W^T exactly, in f32 and rounded to bf16."""
    jr, tr = _pair(qtype)
    spec = _spec(qtype)
    gs, d_out = tr.group_size, tr.d_out
    q = qmatmul._unpack_codes(tr.qs, tr.per_byte, 512).numpy().astype(np.float32)
    d = np.repeat(tr.d_sg[::tr.d_rep].numpy(), 256 // gs, axis=0)
    s = d * tr.sc_q.numpy().astype(np.float32)  # (ng, d_out)
    o = (np.repeat(tr.dmin_sg[::tr.d_rep].numpy(), 256 // gs, axis=0)
         * tr.mn_q.numpy().astype(np.float32) if tr.has_min else np.zeros_like(s))
    qv = (q - np.float32(tr.shift)).reshape(-1, gs, d_out)
    prod = s[:, None, :] * qv
    assert np.array_equal(prod.astype(np.float64), s[:, None, :].astype(np.float64) * qv)
    two_roundings = (prod - o[:, None, :]).reshape(512, d_out)
    fused = (s[:, None, :].astype(np.float64) * qv - o[:, None, :]).astype(np.float32)
    want = np.asarray(jq.dequantize_runtime_v2(jr)).T
    np.testing.assert_array_equal(two_roundings, want)
    np.testing.assert_array_equal(fused.reshape(512, d_out), want)
    np.testing.assert_array_equal(qmatmul.dequantize_runtime_v2(tr).numpy().T, want)
    eye = torch.eye(512)
    np.testing.assert_array_equal(
        qmatmul.dequant_matmul_v2_reference(eye, tr, torch.float32).numpy(), want)
    np.testing.assert_array_equal(
        qmatmul.dequant_matmul_v2_reference(eye, tr).numpy(),
        torch.from_numpy(want.copy()).to(torch.bfloat16).float().numpy())
    assert spec.signed == (not tr.has_min)


@pytest.mark.parametrize("qtype", [T.Q4_K, T.Q6_K])
def test_v2_f32_matches_exact_xla(qtype):
    """In f32 the v2 plain version is JAX's dequant_matmul_xla_v2: the same
    f32 weights and products, sums in another order."""
    jr, tr = _pair(qtype)
    x = np.random.default_rng(9).normal(size=(8, 512)).astype(np.float32)
    want = np.asarray(jq.dequant_matmul_xla_v2(jnp.asarray(x), jr))
    got = qmatmul.dequant_matmul_v2_reference(torch.from_numpy(x), tr, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("knob,gs16", [("v2g", ""), ("v2", ""), ("v2m", ""), ("v2t", ""),
                                       ("v2p", ""), ("v2g", "v2p"), ("v2s", ""), ("v3", ""),
                                       ("v2f", "v2h")])
def test_cpu_dispatch_runs_the_effective_variant(knob, gs16, monkeypatch):
    """dequant_matmul reads the knobs at every call and runs the effective
    variant's wrapper, which takes its plain version for a CPU x."""
    calls = []
    for v, name in WRAPPERS.items():
        fn = getattr(qmatmul, name)
        monkeypatch.setattr(qmatmul, name,
                            lambda x, rql, mxu=torch.bfloat16, _v=v, _fn=fn:
                            calls.append(_v) or _fn(x, rql, mxu))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 512)).astype(np.float32))
    monkeypatch.setattr(qmatmul, "PALLAS_V2_VARIANT", knob)
    monkeypatch.setattr(qmatmul, "PALLAS_V2_VARIANT_GS16", gs16)
    for qtype in (T.Q4_K, T.Q5_K, T.Q3_K, T.Q6_K):
        jr, tr = _pair(qtype)
        want_v = jq.effective_v2_variant_for(jr, B=3, variant=(
            gs16 if tr.group_size == 16 and gs16 else knob))
        calls.clear()
        got = qmatmul.dequant_matmul(x, tr)
        assert calls == [want_v], qtype.name
        plain = (qmatmul.dequant_matmul_v2g_reference if want_v == "v2g"
                 else PLAIN[want_v][0])
        np.testing.assert_array_equal(got.numpy(), plain(x, tr).numpy())


def test_unported_and_unknown_variants_raise():
    """Every JAX variant is ported, so only an unknown name, an operand
    type other than bf16 / f32, or a wrapper called on a format its kernel
    does not take raises; nothing falls back to another kernel."""
    _, q4 = _pair(T.Q4_K)
    _, q6 = _pair(T.Q6_K)
    x = torch.zeros(2, 512)
    for v in qmatmul.V2_VARIANTS:
        assert qmatmul.dequant_matmul_v2(x, q4, variant=v).shape == (2, 512)
    # v2s on byte codes resolves to v2g, as in JAX
    np.testing.assert_array_equal(qmatmul.dequant_matmul_v2(x, q6, variant="v2s").numpy(),
                                  qmatmul.dequant_matmul_v2g_reference(x, q6).numpy())
    with pytest.raises(ValueError, match="unknown v2 kernel variant"):
        qmatmul.dequant_matmul_v2(x, q4, variant="v9")
    with pytest.raises(ValueError, match="mxu_dtype"):
        qmatmul.dequant_matmul_v2(x, q4, variant="v2", mxu_dtype=torch.float16)
    for wrapper, rql in ((qmatmul.dequant_matmul_v2m, q6), (qmatmul.dequant_matmul_v2t, q6),
                         (qmatmul.dequant_matmul_v2p, q4)):
        with pytest.raises(ValueError, match="group size"):
            wrapper(x, rql)
    with pytest.raises(ValueError, match="4-bit codes only"):
        qmatmul.dequant_matmul_v2s(x, q6)


@pytest.mark.parametrize("M,d_out,n_sg,vec,want", [
    (8, 4096, 16, 4, (8, 1, 16)),
    (128, 4096, 16, 4, (8, 8, 2)),    # prefill rows stay on 8-row tiles
    (128, 28672, 16, 4, (8, 16, 1)),
    (300, 1000, 8, 1, (8, 8, 1)),
    (1, 333, 2, 1, (1, 1, 2)),
])
def test_group_dot_launch_plan(M, d_out, n_sg, vec, want):
    assert qmatmul._launch_plan(M, d_out, n_sg, n_sm=132, vec=vec, mt_max=8) == want


@pytest.mark.parametrize("variant", qmatmul.PER_WEIGHT_VARIANTS)
@pytest.mark.parametrize("mxu", ["bf16", "f32"])
@pytest.mark.parametrize("M,d_out,n_sg,vec,mma_want,core_want", [
    (8, 4096, 16, 4, (8, 1, 16), (8, 1, 16)),         # below the threshold
    (9, 4096, 16, 4, (32, 4, 4), (8, 2, 8)),          # at it
    (128, 28672, 16, 4, (128, 16, 1), (8, 16, 1)),    # gate/up, a prefill chunk
    (1024, 128512, 16, 4, (128, 16, 1), (8, 16, 1)),  # the lm_head, a perplexity batch
    (1024, 333, 2, 1, (8, 2, 1), (8, 2, 1)),          # one column per thread
])
def test_per_weight_route(variant, mxu, M, d_out, n_sg, vec, mma_want, core_want):
    """Every per-weight build, v2s among them, takes the tensor-core tiles
    with bf16 operands from MMA_MIN_ROWS rows (v2g, v2h and v2s below that
    their tensor-core decode tiles); f32 operands and vec-1 weights keep
    the 8-row CUDA-core tiles at any M."""
    dt = torch.bfloat16 if mxu == "bf16" else torch.float32
    route = qmatmul._v2_route(variant, dt)
    want = mma_want if mxu == "bf16" and variant in qmatmul.MMA_VARIANTS else core_want
    if variant in ("v2g", "v2h", "v2s") and (mxu, M, vec) == ("bf16", 8, 4):  # their decode tiles
        want = (qmatmul.DECODE_MMA_TILE, 1, 16)
    assert qmatmul._plan(M, d_out, n_sg, 132, vec, *route) == want
    assert variant in qmatmul.MMA_VARIANTS


@pytest.mark.parametrize("variant", ["v2m", "v2t", "v2p"])
@pytest.mark.parametrize("mxu", ["bf16", "f32"])
@pytest.mark.parametrize("M,d_out,n_sg,vec,mma_want,core_want", [
    (8, 4096, 16, 4, (8, 1, 16), (8, 1, 16)),         # below the threshold
    (9, 4096, 16, 4, (32, 4, 4), (8, 2, 8)),          # at it
    (64, 4096, 56, 4, (64, 12, 5), (8, 19, 3)),       # down, a short prompt
    (128, 28672, 16, 4, (128, 16, 1), (8, 16, 1)),    # gate/up, a prefill chunk
    (1024, 128512, 16, 4, (128, 16, 1), (8, 16, 1)),  # the lm_head, a perplexity batch
    (1024, 333, 2, 1, (8, 2, 1), (8, 2, 1)),          # one column per thread
])
def test_group_dot_route(variant, mxu, M, d_out, n_sg, vec, mma_want, core_want):
    """v2m, v2t and v2p take the tensor-core tiles with bf16 operands from
    MMA_MIN_ROWS rows (v2t's of at most 64 rows), and below that their
    tensor-core decode tiles; f32 operands and vec-1 weights keep the
    8-row CUDA-core tiles at any M."""
    dt = torch.bfloat16 if mxu == "bf16" else torch.float32
    want = mma_want if mxu == "bf16" else core_want
    if variant == "v2t" and mxu == "bf16":  # its tiles stop at 64 rows (MMA_BM_MAX)
        want = {(128, 28672): (64, 16, 1), (1024, 128512): (64, 16, 1)}.get((M, d_out), want)
    if (mxu, M, vec) == ("bf16", 8, 4):  # their decode tiles
        want = (qmatmul.DECODE_MMA_TILE, 1, 16)
    assert qmatmul._plan(M, d_out, n_sg, 132, vec, *qmatmul._v2_route(variant, dt)) == want
    assert qmatmul.MMA_GROUP_DOT == ("v2m", "v2t", "v2p")


def test_group_dot_tensor_core_counts_stay_on_the_cpu():
    """The v2m / v2t / v2p wrappers count tensor-core launches; a CPU x at
    prefill rows runs the plain version and counts nothing."""
    _, q4 = _pair(T.Q4_K)
    _, q6 = _pair(T.Q6_K)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(130, 512)).astype(np.float32))
    for fn, rql in ((qmatmul.dequant_matmul_v2m, q4), (qmatmul.dequant_matmul_v2t, q4),
                    (qmatmul.dequant_matmul_v2p, q6)):
        n0, m0 = fn.launches, fn.mma_launches
        np.testing.assert_array_equal(fn(x, rql).numpy(),
                                      qmatmul.dequant_matmul_v2m_reference(x, rql).numpy())
        assert (fn.launches, fn.mma_launches) == (n0, m0) == (0, 0)


def test_quantize_activations_q8_bit_equal():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(5, 1024)).astype(np.float32) * rng.uniform(0.01, 10, (5, 1))
    x[2, 256:512] = 0.0  # a zero supergroup: d = 0, codes 0
    x[3, 7] = 1e4       # an outlier sets one supergroup's scale
    jq8, jd = jq.quantize_activations_q8(jnp.asarray(x))
    tq8, td = qmatmul.quantize_activations_q8(torch.from_numpy(x))
    assert tq8.dtype == torch.int8 and td.dtype == torch.float32
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("qtype", ALL_K)
def test_q8_matmul_matches_jax(qtype):
    """Exact integer group dots on both sides; the scale fixups are f32
    products and sums in another order: within 1e-5 relative."""
    jr, tr = _pair(qtype)
    x = np.random.default_rng(12).normal(size=(4, 512)).astype(np.float32)
    want = np.asarray(jq.q8_matmul_xla(jnp.asarray(x), jr))
    got = qmatmul.q8_matmul(torch.from_numpy(x), tr).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
