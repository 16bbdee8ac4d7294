"""The port's v2 runtime format and v2g matmul against the JAX package.

Layers are quantized by the JAX package from numpy inputs made from a seed;
both packages pack the same codes. Planes must be byte-equal and
dequantization bit-equal. The plain v2g version is held to JAX's v2g
kernel run in interpret mode, and to JAX's exact XLA path. The kernel
itself is checked on the card by tests/test_torch_kernel_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptq_gguf_tpu.formats.ggml import GGMLQuantizationType as T
from gptq_gguf_tpu.ops import kquant, qmatmul as jq
from gptq_gguf_tpu_torch.formats import ggml
from gptq_gguf_tpu_torch.ops import qmatmul
from gptq_gguf_tpu_torch.ops.kquant import SuperGroupParams

ALL_K = [T.Q2_K, T.Q3_K, T.Q4_K, T.Q5_K, T.Q6_K]
PLANES = ("qs", "d_sg", "dmin_sg", "sc_q", "mn_q")


def _layer(qtype, d_out=512, d_in=512, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d_out, d_in)).astype(np.float32) * 0.1
    q, p = kquant.quantize_rtn(jnp.asarray(w), qtype)
    q = np.asarray(q)
    jr = jq.pack_runtime_v2(q, p, qtype)
    params = SuperGroupParams(*(np.asarray(a) for a in p))
    tr = qmatmul.pack_runtime_v2(q, params, ggml.GGMLQuantizationType(int(qtype)),
                                 device="cpu")
    return jr, tr


def _assert_same_planes(jr, tr):
    for name in PLANES:
        a, b = getattr(jr, name), getattr(tr, name)
        if a is None:
            assert b is None
            continue
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for k in ("d_in", "group_size", "per_byte", "shift", "d_rep"):
        assert getattr(tr, k) == getattr(jr, k), k


@pytest.mark.parametrize("qtype", ALL_K)
def test_pack_planes_byte_equal_and_dequant_bit_equal(qtype):
    jr, tr = _layer(qtype, seed=int(qtype))
    _assert_same_planes(jr, tr)
    want = np.asarray(jq.dequantize_runtime_v2(jr))
    got = qmatmul.dequantize_runtime_v2(tr).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qtypes", [(T.Q4_K, T.Q4_K, T.Q4_K), (T.Q4_K, T.Q6_K)])
def test_fuse_and_pad_equal(qtypes):
    pairs = [_layer(qt, d_out=256, seed=i) for i, qt in enumerate(qtypes)]
    jf = jq.fuse_rql_v2([p[0] for p in pairs])
    tf = qmatmul.fuse_rql_v2([p[1] for p in pairs])
    if jf is None:  # mixed layouts (Q4_K_M q/k with Q6_K v) do not fuse
        assert tf is None
        return
    _assert_same_planes(jf, tf)
    jp, tp = jq.pad_dout_v2(jf, 512), qmatmul.pad_dout_v2(tf, 512)
    assert tp.d_out == 1024
    _assert_same_planes(jp, tp)
    np.testing.assert_array_equal(qmatmul.dequantize_runtime_v2(tp).numpy(),
                                  np.asarray(jq.dequantize_runtime_v2(jp)))


@pytest.mark.parametrize("qtype", ALL_K)
@pytest.mark.parametrize("M", [1, 8, 33])
def test_plain_v2g_matches_jax_interpret(qtype, M):
    """Tolerance: the plain version and JAX's v2g kernel compute the same
    bf16 products and differ only in the order of the f32 sums: rtol 1e-5,
    atol 1e-4 of max|y|."""
    jr, tr = _layer(qtype, seed=10 + int(qtype))
    x = np.random.default_rng(M).normal(size=(M, 512)).astype(np.float32)
    want = np.asarray(jq.dequant_matmul_pallas_v2(
        jnp.asarray(x), jr, interpret=True, variant="v2g"))
    got = qmatmul.dequant_matmul_v2g_reference(torch.from_numpy(x), tr).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4 * np.abs(want).max())
    # the CPU dispatch takes the plain version
    np.testing.assert_array_equal(qmatmul.dequant_matmul(torch.from_numpy(x), tr).numpy(), got)


@pytest.mark.parametrize("qtype", ALL_K)
def test_bytes_read_counts_one_copy_of_each_super_scale_row(qtype):
    """The kernel reads codes, group scales (and mins), and one f32 super
    scale (and super min) per supergroup and column: the JAX planes' bytes
    less the d_rep - 1 replicas of d_sg / dmin_sg."""
    d_out, d_in = 512, 512
    jr, tr = _layer(qtype, seed=30 + int(qtype))
    spec = ggml.KQUANT_SPECS[ggml.GGMLQuantizationType(int(qtype))]
    per_weight = (1 / tr.per_byte + (2 if tr.has_min else 1) / spec.group_size
                  + (2 if tr.has_min else 1) * 4 / 256)
    assert tr.bytes_read == int(per_weight * d_out * d_in)
    jax_bytes = sum(np.asarray(getattr(jr, n)).nbytes for n in PLANES
                    if getattr(jr, n) is not None)
    sg_bytes = sum(np.asarray(getattr(jr, n)).nbytes for n in ("d_sg", "dmin_sg")
                   if getattr(jr, n) is not None)
    assert tr.bytes_read == jax_bytes - sg_bytes * (jr.d_rep - 1) // jr.d_rep


@pytest.mark.parametrize("qtype", [T.Q4_K, T.Q6_K])
def test_plain_v2g_close_to_exact_xla(qtype):
    """Against the exact f32 XLA path the plain version differs by the bf16
    rounding of weights and activations (8-bit mantissas), so the bound is
    2e-2 of max|y| for 512-term sums."""
    jr, tr = _layer(qtype, seed=20 + int(qtype))
    x = np.random.default_rng(5).normal(size=(8, 512)).astype(np.float32)
    want = np.asarray(jq.dequant_matmul_xla_v2(jnp.asarray(x), jr))
    got = qmatmul.dequant_matmul_v2g_reference(torch.from_numpy(x), tr).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


def test_bf16_activations_take_the_same_path():
    """bf16 x: the main dot and xsum see the same values as an f32 x of the
    bf16-rounded values."""
    _, tr = _layer(T.Q4_K, seed=3)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(4, 512)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    np.testing.assert_array_equal(
        qmatmul.dequant_matmul(xb, tr).numpy(),
        qmatmul.dequant_matmul(xb.float(), tr).numpy())


@pytest.mark.parametrize("M,d_out,n_sg,vec,want", [
    (8, 4096, 16, 4, (8, 1, 16)),     # o: 32 column blocks -> K split 16 ways
    (8, 6144, 16, 4, (8, 2, 8)),      # qkv
    (8, 28672, 16, 4, (8, 6, 3)),     # gate/up
    (8, 4096, 56, 4, (8, 4, 14)),     # down
    (8, 128512, 16, 4, (8, 16, 1)),   # lm_head: enough column blocks, no split
    (128, 4096, 16, 4, (32, 1, 16)),  # prefill: 32-row tiles
    (5, 1000, 8, 1, (8, 1, 8)),       # ragged d_out: one column per thread
    (3, 1000, 8, 1, (8, 1, 8)),
])
def test_launch_plan(M, d_out, n_sg, vec, want):
    assert qmatmul._launch_plan(M, d_out, n_sg, n_sm=132, vec=vec) == want


@pytest.mark.parametrize("M,d_out,n_sg,vec,want", [
    (8, 4096, 16, 4, (8, 1, 16)),     # decode, one row below the threshold: as before
    (9, 4096, 16, 4, (32, 4, 4)),     # at the threshold: 32-row tensor-core tiles
    (32, 4096, 16, 4, (32, 4, 4)),
    (33, 4096, 16, 4, (64, 4, 4)),
    (128, 6144, 16, 4, (128, 6, 3)),  # the Llama-3-8B shapes at M = 128
    (128, 4096, 16, 4, (128, 4, 4)),
    (128, 28672, 16, 4, (128, 16, 1)),
    (128, 4096, 56, 4, (128, 12, 5)),
    (128, 128512, 16, 4, (128, 16, 1)),
    (1024, 6144, 16, 4, (128, 16, 1)),  # ... and at M = 1024: no split
    (1024, 4096, 16, 4, (128, 16, 1)),
    (1024, 4096, 56, 4, (128, 56, 1)),
    (300, 1000, 8, 1, (8, 8, 1)),     # one column per thread: CUDA-core tiles at any M
])
def test_v2g_plan(M, d_out, n_sg, vec, want):
    """The default variant with bf16 operands: the tensor-core tiles from
    MMA_MIN_ROWS rows for vec-4 weights, the decode tiles otherwise."""
    assert qmatmul.MMA_MIN_ROWS == 9
    route = qmatmul._per_weight_route("v2g", torch.bfloat16)
    assert qmatmul._plan(M, d_out, n_sg, 132, vec, *route) == want


@pytest.mark.parametrize("M,d_out,n_sg,want", [
    (8, 4096, 16, (8, 1, 16)), (128, 4096, 16, (32, 1, 16)), (1024, 28672, 16, (32, 16, 1)),
    (1024, 128256, 16, (32, 16, 1))])
def test_v1_v4_plan_unchanged(M, d_out, n_sg, want):
    """The v1 wrapper calls launch_setup(x, rql): its defaults keep v1's
    CUDA-core tiles of up to 32 rows at every M (v4's plan:
    test_v4_plan)."""
    import inspect

    defaults = {k: p.default for k, p in inspect.signature(qmatmul.launch_setup).parameters.items()
                if p.default is not inspect.Parameter.empty}
    assert defaults == {"mt_max": 32, "mma": False}
    got = qmatmul._plan(M, d_out, n_sg, 132, 4, **defaults)
    assert got == qmatmul._launch_plan(M, d_out, n_sg, 132, 4) == want


@pytest.mark.parametrize("M,d_out,n_sg,vec,want", [
    (1, 4096, 16, 4, (1, 1, 16)),       # decode: the CUDA-core tiles
    (8, 4096, 16, 4, (8, 1, 16)),
    (9, 4096, 16, 4, (32, 4, 4)),       # from MMA_MIN_ROWS: the tensor-core tiles
    (128, 28672, 16, 4, (128, 16, 1)),
    (512, 128256, 16, 4, (128, 16, 1)),  # a perplexity batch on the unpadded head
    (1024, 4096, 56, 4, (128, 56, 1)),
    (9, 333, 2, 1, (32, 1, 2)),         # vec 1: the CUDA-core tiles of up to 32 rows
    (300, 1000, 8, 1, (32, 2, 4)),
])
def test_v4_plan(M, d_out, n_sg, vec, want):
    """The v4 wrapper calls launch_setup(x, rql, mma=True): _mma_plan for
    vec-4 weights from MMA_MIN_ROWS rows, _launch_plan (up to 32 rows)
    below that and for vec-1 weights at any M."""
    got = qmatmul._plan(M, d_out, n_sg, 132, vec, mma=True)
    if vec == 4 and M >= qmatmul.MMA_MIN_ROWS:
        assert got == qmatmul._mma_plan(M, d_out, n_sg, 132) == want
    else:
        assert got == qmatmul._launch_plan(M, d_out, n_sg, 132, vec) == want


@pytest.mark.parametrize("fmt,want", [("v1", {}), ("v4", {"mma": True})])
def test_v1_v4_wrappers_ask_for_their_plan(fmt, want, monkeypatch):
    """A tensor off the CPU (here one on the meta device) goes to
    launch_setup: v1 with its defaults, v4 asking for the tensor-core
    tiles."""
    from gptq_gguf_tpu_torch.ops import qmv4

    mod, fn = ((qmatmul, qmatmul.dequant_matmul_v1) if fmt == "v1"
               else (qmv4, qmv4.dequant_matmul_v4))
    seen = []

    def setup(x, rql, *args, **kwargs):
        seen.append((args, kwargs))
        raise LookupError("stop before the launch")

    monkeypatch.setattr(mod, "launch_setup", setup)
    with pytest.raises(LookupError, match="stop"):
        fn(torch.empty(9, 256, device="meta"), None)
    assert seen == [((), want)]


def _v1_pair(qtype, d_out=512, d_in=512, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d_out, d_in)).astype(np.float32) * 0.1
    q, p = kquant.quantize_rtn(jnp.asarray(w), qtype)
    q = np.asarray(q)
    params = SuperGroupParams(*(np.asarray(a) for a in p))
    return (jq.pack_runtime(q, p, qtype),
            qmatmul.pack_runtime(q, params, ggml.GGMLQuantizationType(int(qtype)),
                                 device="cpu"))


def _assert_same_v1(jr, tr):
    for name in ("qs", "scale_t", "offset_t"):
        a, b = np.asarray(getattr(jr, name)), getattr(tr, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for k in ("d_in", "group_size", "per_byte"):
        assert getattr(tr, k) == getattr(jr, k), k
    assert tr.packed_bits_per_weight == pytest.approx(jr.packed_bits_per_weight, rel=1e-12)


@pytest.mark.parametrize("qtype", ALL_K)
def test_pack_v1_planes_byte_equal_and_dequant_bit_equal(qtype):
    jr, tr = _v1_pair(qtype, seed=60 + int(qtype))
    _assert_same_v1(jr, tr)
    got = qmatmul.dequantize_runtime(tr).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jq.dequantize_runtime(jr)))


@pytest.mark.parametrize("qtype", ALL_K)
@pytest.mark.parametrize("M", [1, 8, 33])
def test_plain_v1_matches_jax_interpret(qtype, M):
    """JAX's v1 Pallas kernel in interpret mode against the port's plain
    version: both are f32 products and f32 sums of the same weights, so
    they differ only in the order of the sums: within 1e-4 of the largest
    sum of |terms| of one output."""
    jr, tr = _v1_pair(qtype, d_in=1024, seed=70 + int(qtype))
    x = np.random.default_rng(M).normal(size=(M, 1024)).astype(np.float32)
    want = np.asarray(jq.dequant_matmul_pallas(jnp.asarray(x), jr, tile_out=256,
                                               tile_in=512, interpret=True))
    xt = torch.from_numpy(x)
    got = qmatmul.dequant_matmul_v1_reference(xt, tr).numpy()
    mag = (xt.abs() @ qmatmul.dequantize_runtime(tr).T.abs()).max().item()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * mag)
    # the CPU dispatch takes the plain version; JAX's CPU dispatch runs XLA
    np.testing.assert_array_equal(qmatmul.dequant_matmul(xt, tr).numpy(), got)
    np.testing.assert_allclose(np.asarray(jq.dequant_matmul(jnp.asarray(x), jr)), got,
                               rtol=0, atol=1e-4 * mag)


@pytest.mark.parametrize("fmt", ["v1", "v2", "v4"])
def test_pack_runtime_auto_formats(fmt, monkeypatch):
    """fmt= picks the format; without it both packages read their
    RUNTIME_FORMAT constant ("v2" by default). v4 packs f32 scales, i32."""
    from gptq_gguf_tpu.ops import qmv4 as jv4
    from gptq_gguf_tpu_torch.ops import qmv4
    from tests.test_torch_qmv4 import assert_same_v4

    assert qmatmul.RUNTIME_FORMAT == jq.RUNTIME_FORMAT == "v2"
    rng = np.random.default_rng(80)
    w = rng.normal(size=(256, 512)).astype(np.float32) * 0.1
    q, p = kquant.quantize_rtn(jnp.asarray(w), T.Q4_K)
    q = np.asarray(q)
    tp = SuperGroupParams(*(np.asarray(a) for a in p))
    tq = ggml.GGMLQuantizationType.Q4_K
    monkeypatch.setattr(qmatmul, "RUNTIME_FORMAT", fmt)
    monkeypatch.setattr(jq, "RUNTIME_FORMAT", fmt)
    for jr, tr in ((jq.pack_runtime_auto(q, p, T.Q4_K),
                    qmatmul.pack_runtime_auto(q, tp, tq, device="cpu")),
                   (jq.pack_runtime_auto(q, p, T.Q4_K, fmt=fmt),
                    qmatmul.pack_runtime_auto(q, tp, tq, fmt=fmt, device="cpu"))):
        if fmt == "v1":
            assert type(tr) is qmatmul.RuntimeQuantLinear
            _assert_same_v1(jr, tr)
        elif fmt == "v2":
            assert type(tr) is qmatmul.RuntimeQuantLinearV2
            _assert_same_planes(jr, tr)
        else:
            assert type(tr) is qmv4.RuntimeQuantLinearV4 and tr.layout == "i32"
            assert tr.scale.dtype == torch.float32 and isinstance(jr, jv4.RuntimeQuantLinearV4)
            assert_same_v4(jr, tr)


def test_dispatch_refuses_other_weights():
    with pytest.raises(TypeError, match="not a packed weight"):
        qmatmul.dequant_matmul(torch.zeros(2, 256), torch.zeros(256, 256))


def test_wrapper_checks_v1_planes():
    _, tr = _v1_pair(T.Q4_K, seed=5)
    x = torch.zeros(2, 512)
    qmatmul._check_planes(x, tr)
    bad = qmatmul.RuntimeQuantLinear(tr.qs, tr.scale_t.double(), tr.offset_t, tr.d_in,
                                     tr.group_size, tr.per_byte)
    with pytest.raises(ValueError, match="scale_t"):
        qmatmul._check_planes(x, bad)


def test_wrapper_checks_planes():
    _, tr = _layer(T.Q4_K, seed=4)
    x = torch.zeros(2, 512)
    with pytest.raises(ValueError, match="d_in"):
        qmatmul._check_planes(torch.zeros(2, 256), tr)
    bad = qmatmul.RuntimeQuantLinearV2(tr.qs, tr.d_sg, tr.dmin_sg, tr.sc_q.to(torch.int8),
                                       tr.mn_q, tr.d_in, tr.group_size, tr.per_byte,
                                       tr.shift, tr.d_rep)
    with pytest.raises(ValueError, match="sc_q"):
        qmatmul._check_planes(x, bad)
    qmatmul._check_planes(x, tr)
