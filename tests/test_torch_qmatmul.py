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
    (8, 4096, 16, 4, (16, 1, 16)),    # decode, one row below the threshold: the decode tile
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
    MMA_MIN_ROWS rows for vec-4 weights, the tensor-core decode tile
    below, the CUDA-core tiles for vec-1 weights."""
    assert qmatmul.MMA_MIN_ROWS == 9
    route = qmatmul._v2_route("v2g", torch.bfloat16)
    assert qmatmul._plan(M, d_out, n_sg, 132, vec, *route) == want


# the Llama-3-8B shapes of one decode step: (d_out, supergroups of d_in)
STEP_8B = {"qkv": (6144, 16), "o": (4096, 16), "gateup": (28672, 16), "down": (4096, 56),
           "lm_head": (128512, 16)}


@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("shape,want", [
    ("qkv", (16, 1, 16)),      # 48 column blocks -> every supergroup its own split
    ("o", (16, 1, 16)),        # 32 column blocks: the same
    ("gateup", (16, 4, 4)),    # 224 column blocks -> 4 splits (896 blocks)
    ("down", (16, 2, 28)),     # 32 column blocks, 56 supergroups -> 28 splits
    ("lm_head", (16, 16, 1)),  # 1004 column blocks: no split
])
def test_decode_mma_plan(shape, want, M):
    """The tensor-core decode tile's plan at the 8B decode shapes: one
    tile code for every M of 1-8, the K axis split over supergroups into
    as many splits as keep the grid at DECODE_MMA_BLOCKS_PER_SM (8) blocks
    or fewer on each of 132 SMs."""
    assert qmatmul.DECODE_MMA_BLOCKS_PER_SM == 8
    d_out, n_sg = STEP_8B[shape]
    assert qmatmul.DECODE_MMA_TILE not in (1, 2, 4, 8, 32, 64, 128)
    assert qmatmul._decode_mma_plan(d_out, n_sg, 132) == want
    route = qmatmul._v2_route("v2g", torch.bfloat16)
    got = qmatmul._plan(M, d_out, n_sg, 132, 4, *route)
    if M >= qmatmul.DECODE_MMA_MIN_ROWS["v2g"]:
        assert got == want
    else:  # the CUDA-core tile (timed faster at one row)
        assert got == qmatmul._launch_plan(M, d_out, n_sg, 132, 4, 8)


@pytest.mark.parametrize("M", [1, 2, 3, 5, 8])
def test_v2g_bf16_decode_takes_the_decode_tile(M):
    """v2g with bf16 operands on a vec-4 weight: every M from its
    DECODE_MMA_MIN_ROWS (2) to MMA_MIN_ROWS - 1 takes the decode tile, one
    row the CUDA-core tile."""
    assert qmatmul.DECODE_MMA_MIN_ROWS["v2g"] == 2
    route = qmatmul._v2_route("v2g", torch.bfloat16)
    assert route[3] is True
    got = qmatmul._plan(M, 768, 4, 132, 4, *route)
    if M >= qmatmul.DECODE_MMA_MIN_ROWS["v2g"]:
        assert got == qmatmul._decode_mma_plan(768, 4, 132)
    else:
        assert got == qmatmul._launch_plan(M, 768, 4, 132, 4, 8)


@pytest.mark.parametrize("variant,mxu,vec", [
    ("v2g", torch.float32, 4),   # f32 operands (the test mode)
    ("v2g", torch.bfloat16, 1),  # a vec-1 weight
    *[(v, torch.bfloat16, 4) for v in ("v2", "v3", "v2f", "v2h", "v2s", "v2m", "v2t", "v2p")],
], ids=lambda a: str(a).replace("torch.", ""))
@pytest.mark.parametrize("M", [1, 8])
def test_decode_keeps_the_cuda_core_tiles_elsewhere(variant, mxu, vec, M):
    """f32 operands, vec-1 weights and the variants without a decode tile
    (v2, v3, v2f) keep _launch_plan's CUDA-core tiles at M <= 8; v2h, v2s,
    v2m, v2t and v2p (bf16 operands, vec 4) take their own decode tiles
    from their DECODE_MMA_MIN_ROWS."""
    assert qmatmul.DECODE_MMA_VARIANTS == ("v2g", "v2p", "v2h", "v2t", "v2m", "v2s")
    route = qmatmul._v2_route(variant, mxu)
    decode = variant in qmatmul.DECODE_MMA_VARIANTS and mxu == torch.bfloat16
    assert route[3] is decode
    for d_out, n_sg in STEP_8B.values():
        want = qmatmul._launch_plan(M, d_out, n_sg, 132, vec, 8)
        if decode and vec == 4 and M >= qmatmul.DECODE_MMA_MIN_ROWS[variant]:
            want = qmatmul._decode_mma_plan(d_out, n_sg, 132)
        assert qmatmul._plan(M, d_out, n_sg, 132, vec, *route) == want


@pytest.mark.parametrize("mt,counted", [(8, None), (qmatmul.DECODE_MMA_TILE, "decode_mma_launches"),
                                        (32, "mma_launches")])
def test_v2g_wrapper_counts_each_tile(mt, counted, monkeypatch):
    """A launch counts once on ``launches`` and, by the tile that ran, on
    ``decode_mma_launches`` or ``mma_launches`` (here the launch is a
    stand-in on the meta device that reports the tile)."""
    fn = qmatmul.dequant_matmul_v2g
    routes = []

    def launch(lib, code, x, rql, mxu_dtype, *route):
        routes.append((lib, code, route))
        return torch.empty(x.shape[0], 8, device="meta"), mt

    monkeypatch.setattr(qmatmul, "_launch_v2", launch)
    before = {k: getattr(fn, k) for k in ("launches", "decode_mma_launches", "mma_launches")}
    fn(torch.empty(8, 256, device="meta"), None)
    assert routes == [("qmatmul_v2g", 0, qmatmul._v2_route("v2g", torch.bfloat16))]
    after = {k: getattr(fn, k) - v for k, v in before.items()}
    assert after == {"launches": 1, "decode_mma_launches": int(counted == "decode_mma_launches"),
                     "mma_launches": int(counted == "mma_launches")}


@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("M,d_out,n_sg,want", [
    (8, 4096, 16, (8, 1, 16)), (128, 4096, 16, (32, 1, 16)), (1024, 28672, 16, (32, 16, 1)),
    (1024, 128256, 16, (32, 16, 1))])
def test_v1_v4_plan_unchanged(M, d_out, n_sg, want, x_dtype):
    """The v1 wrapper calls launch_setup(x, rql, mma=x is bf16): with an
    f32 x the defaults keep v1's CUDA-core tiles of up to 32 rows at every
    M; a bf16 x of MMA_MIN_ROWS rows or more takes the tensor-core tiles
    (_mma_plan), and 1-8 rows the same CUDA-core tiles (v4's plan:
    test_v4_plan)."""
    import inspect

    defaults = {k: p.default for k, p in inspect.signature(qmatmul.launch_setup).parameters.items()
                if p.default is not inspect.Parameter.empty}
    assert defaults == {"mt_max": 32, "mma": False, "bm_max": 128, "decode_mma": False,
                        "decode_min_rows": None}
    ask = {**defaults, "mma": x_dtype == "bf16"}
    got = qmatmul._plan(M, d_out, n_sg, 132, 4, **ask)
    if x_dtype == "bf16" and M >= qmatmul.MMA_MIN_ROWS:
        assert got == qmatmul._mma_plan(M, d_out, n_sg, 132)
    else:
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
    """The v4 plan with the tensor-core prefill tiles allowed (mma=True):
    _mma_plan for vec-4 weights from MMA_MIN_ROWS rows, _launch_plan (up
    to 32 rows) below that and for vec-1 weights at any M (the wrapper
    also allows the decode tile: test_v4_plan_with_the_decode_tile)."""
    got = qmatmul._plan(M, d_out, n_sg, 132, vec, mma=True)
    if vec == 4 and M >= qmatmul.MMA_MIN_ROWS:
        assert got == qmatmul._mma_plan(M, d_out, n_sg, 132) == want
    else:
        assert got == qmatmul._launch_plan(M, d_out, n_sg, 132, vec) == want


@pytest.mark.parametrize("M,d_out,n_sg,vec", [
    (1, 4096, 16, 4),        # from qmv4.DECODE_MMA_MIN_ROWS (1) to 8 rows: the decode tile
    (2, 4096, 16, 4),
    (5, 6144, 16, 4),
    (8, 28672, 16, 4),
    (8, 4096, 56, 4),
    (8, 128256, 16, 4),      # the unpadded Q6_K head of a B=8 step
    (9, 4096, 16, 4),        # from MMA_MIN_ROWS: the tensor-core prefill tiles
    (1024, 4096, 56, 4),
    (5, 1000, 8, 1),         # vec 1: the CUDA-core tiles at any M
    (8, 333, 2, 1),
    (40, 333, 2, 1),
])
def test_v4_plan_with_the_decode_tile(M, d_out, n_sg, vec):
    """The v4 wrapper's plan (launch_setup(x, rql, mma=True,
    decode_mma=True, decode_min_rows=qmv4.DECODE_MMA_MIN_ROWS)): vec-4
    weights at 1 to 8 rows take _decode_mma_plan (v4's CUDA-core tile ran
    one row slower: PERF.md); vec-1 weights and M >= MMA_MIN_ROWS keep the
    plans test_v4_plan holds. v2g's threshold stays at 2 rows."""
    from gptq_gguf_tpu_torch.ops import qmv4

    assert qmv4.DECODE_MMA_MIN_ROWS == 1 and qmatmul.DECODE_MMA_MIN_ROWS["v2g"] == 2
    got = qmatmul._plan(M, d_out, n_sg, 132, vec, mma=True, decode_mma=True,
                        decode_min_rows=qmv4.DECODE_MMA_MIN_ROWS)
    if vec == 4 and M < qmatmul.MMA_MIN_ROWS:
        assert got == qmatmul._decode_mma_plan(d_out, n_sg, 132)
        assert got[0] == qmatmul.DECODE_MMA_TILE
    else:
        assert got == qmatmul._plan(M, d_out, n_sg, 132, vec, mma=True)
        assert got[0] != qmatmul.DECODE_MMA_TILE


@pytest.mark.parametrize("tile,counted", [("cuda_core", None), ("decode_mma", "decode_mma"),
                                          ("mma", "mma")])
@pytest.mark.parametrize("per_byte,layout,body", [(2, "i32", "pb2"), (2, "i8", "pb2_i8"),
                                                  (1, "i8", "pb1")])
def test_v4_wrapper_counts_each_tile(tile, counted, per_byte, layout, body, monkeypatch):
    """A v4 launch counts once on ``launches`` and its body's count and, by
    the tile that ran, on ``decode_mma_launches`` or ``mma_launches`` and
    that tile's count of the body (here the launch is a stand-in on the
    meta device that reports the tile)."""
    from types import SimpleNamespace

    from gptq_gguf_tpu_torch.ops import qmv4

    fn = qmv4.dequant_matmul_v4
    asks = []

    def launch(x, rql, *args, **kwargs):
        asks.append((args, kwargs))
        return torch.empty(x.shape[0], 8, device="meta"), tile

    monkeypatch.setattr(qmv4, "_launch_v4", launch)
    keys = ("launches", "decode_mma_launches", "mma_launches")
    before = {k: getattr(fn, k) for k in keys}
    bodies = {k: dict(getattr(fn, k)) for k in
              ("body_launches", "body_decode_mma_launches", "body_mma_launches")}
    fn(torch.empty(8, 256, device="meta"), SimpleNamespace(per_byte=per_byte, layout=layout))
    assert asks == [((), {})]  # the wrapper's own route: every tile allowed
    assert {k: getattr(fn, k) - v for k, v in before.items()} == {
        "launches": 1, "decode_mma_launches": int(counted == "decode_mma"),
        "mma_launches": int(counted == "mma")}
    for k, was in bodies.items():
        n = int(k == "body_launches" or k == f"body_{counted}_launches")
        assert getattr(fn, k) == {b: c + n * (b == body) for b, c in was.items()}, k


@pytest.mark.parametrize("fmt,want", [("v1", {"mma": False}), ("v1 bf16", {"mma": True}),
                                      ("v4", {"mma": True, "decode_mma": True,
                                              "decode_min_rows": 1})])
def test_v1_v4_wrappers_ask_for_their_plan(fmt, want, monkeypatch):
    """A tensor off the CPU (here one on the meta device) goes to
    launch_setup: v1 asking for the tensor-core prefill tiles with a bf16
    x only (its other defaults: the CUDA-core tiles of up to 32 rows), v4
    for the tensor-core prefill tiles and the tensor-core decode tile from
    one row (qmv4.DECODE_MMA_MIN_ROWS) whatever x is."""
    from gptq_gguf_tpu_torch.ops import qmv4

    mod, fn = ((qmatmul, qmatmul.dequant_matmul_v1) if fmt.startswith("v1")
               else (qmv4, qmv4.dequant_matmul_v4))
    seen = []

    def setup(x, rql, *args, **kwargs):
        seen.append((args, kwargs))
        raise LookupError("stop before the launch")

    monkeypatch.setattr(mod, "launch_setup", setup)
    dtype = torch.bfloat16 if fmt.endswith("bf16") else torch.float32
    with pytest.raises(LookupError, match="stop"):
        fn(torch.empty(9, 256, device="meta", dtype=dtype), None)
    assert seen == [((), want)]


@pytest.mark.parametrize("x_dtype,M,vec,tile", [
    ("bf16", 9, 4, "mma"),            # from MMA_MIN_ROWS: the tensor-core tiles
    ("bf16", 1024, 4, "mma"),
    ("bf16", 8, 4, "cuda_core"),      # 1-8 rows: v1_kernel, as before
    ("bf16", 1, 4, "cuda_core"),
    ("f32", 128, 4, "cuda_core"),     # an f32 x would be rounded: v1_kernel at any M
    ("bf16", 128, 1, "cuda_core"),    # vec 1: one column per thread
])
def test_v1_route_and_counts(x_dtype, M, vec, tile, monkeypatch):
    """v1's route end to end up to the C call (on the meta device, with
    launch_setup's plan for a card of 132 SMs and a stand-in library): the
    tile code the entry point gets (1: the tensor-core tiles), the rows
    per block, and the counts on dequant_matmul_v1 (every launch; the
    tensor-core ones also on mma_launches)."""
    from types import SimpleNamespace

    fn = qmatmul.dequant_matmul_v1
    d_out, n_sg = 4096, 16
    calls = []

    def setup(x, rql, mt_max=32, mma=False, bm_max=128, decode_mma=False,
              decode_min_rows=None):
        mt, per, splits = qmatmul._plan(x.shape[0], d_out, n_sg, 132, vec, mt_max, mma, bm_max,
                                        decode_mma, decode_min_rows)
        return x, vec, mt, per, splits, torch.empty(x.shape[0], d_out, device="meta"), None

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(qmatmul, "launch_setup", setup)
    monkeypatch.setattr(qmatmul, "c_function", lambda lib, sym, argtypes: entry)
    monkeypatch.setattr(qmatmul, "_ptr", lambda t: None)
    monkeypatch.setattr(qmatmul.torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    rql = SimpleNamespace(qs=None, scale_t=None, offset_t=None, d_out=d_out, per_byte=2,
                          group_size=32)
    x = torch.empty(M, 256 * n_sg, device="meta",
                    dtype=torch.bfloat16 if x_dtype == "bf16" else torch.float32)
    before = (fn.launches, fn.mma_launches)
    for k, v in zip(("launches", "mma_launches"), before):  # restored after the test
        monkeypatch.setattr(fn, k, v)
    fn(x, rql)
    (args,) = calls
    assert len(args) == len(qmatmul._V1_ARGS)
    tc, mt = args[12], args[13]  # after M, d_in, d_out, per_byte, group_size
    assert (tc, args[1]) == (int(tile == "mma"), int(x_dtype == "bf16"))
    if tile == "mma":
        assert mt == qmatmul._mma_plan(M, d_out, n_sg, 132)[0] in (32, 64, 128)
    else:
        assert mt == qmatmul._launch_plan(M, d_out, n_sg, 132, vec)[0] <= 32
    assert (fn.launches - before[0], fn.mma_launches - before[1]) == (1, int(tile == "mma"))


@pytest.mark.parametrize("M", [1, 2, 3, 5, 8])
def test_v2p_bf16_decode_takes_the_decode_tile(M):
    """v2p with bf16 operands on a vec-4 weight: every M from its
    DECODE_MMA_MIN_ROWS to MMA_MIN_ROWS - 1 takes the group-dot form of
    the decode tile (the Q6_K head of a B=8 step under v2m), fewer rows
    the CUDA-core tile; f32 operands and vec-1 weights keep the CUDA-core
    tiles; v2t and v2m take their own decode tiles from their thresholds."""
    route = qmatmul._v2_route("v2p", torch.bfloat16)
    assert route[3:] == (True, qmatmul.DECODE_MMA_MIN_ROWS["v2p"])
    d_out, n_sg = STEP_8B["lm_head"]
    got = qmatmul._plan(M, d_out, n_sg, 132, 4, *route)
    core = qmatmul._launch_plan(M, d_out, n_sg, 132, 4, 8)
    if M >= qmatmul.DECODE_MMA_MIN_ROWS["v2p"]:
        assert got == qmatmul._decode_mma_plan(d_out, n_sg, 132) == (16, 16, 1)
    else:
        assert got == core
    for variant, mxu, vec in (("v2p", torch.float32, 4), ("v2p", torch.bfloat16, 1)):
        assert qmatmul._plan(M, d_out, n_sg, 132, vec, *qmatmul._v2_route(variant, mxu)) == \
            qmatmul._launch_plan(M, d_out, n_sg, 132, vec, 8)
    for variant in ("v2t", "v2m"):
        got = qmatmul._plan(M, d_out, n_sg, 132, 4, *qmatmul._v2_route(variant, torch.bfloat16))
        assert got == (qmatmul._decode_mma_plan(d_out, n_sg, 132)
                       if M >= qmatmul.DECODE_MMA_MIN_ROWS[variant] else core)


@pytest.mark.parametrize("mt,counted", [(8, None), (qmatmul.DECODE_MMA_TILE, "decode_mma_launches"),
                                        (32, "mma_launches")])
def test_v2p_wrapper_counts_each_tile(mt, counted, monkeypatch):
    """A v2p launch counts once on ``launches`` and, by the tile that ran,
    on ``decode_mma_launches`` or ``mma_launches``; it asks for v2p's own
    route (a stand-in launch on the meta device reports the tile)."""
    from types import SimpleNamespace

    fn = qmatmul.dequant_matmul_v2p
    routes = []

    def launch(lib, code, x, rql, mxu_dtype, *route):
        routes.append((lib, code, route))
        return torch.empty(x.shape[0], 8, device="meta"), mt

    monkeypatch.setattr(qmatmul, "_launch_v2", launch)
    before = {k: getattr(fn, k) for k in ("launches", "decode_mma_launches", "mma_launches")}
    for k, v in before.items():  # restored after the test: others read the counts
        monkeypatch.setattr(fn, k, v)
    fn(torch.empty(8, 256, device="meta"), SimpleNamespace(group_size=16))
    assert routes == [("qmatmul_v2m", 2, qmatmul._v2_route("v2p", torch.bfloat16))]
    after = {k: getattr(fn, k) - v for k, v in before.items()}
    assert after == {"launches": 1, "decode_mma_launches": int(counted == "decode_mma_launches"),
                     "mma_launches": int(counted == "mma_launches")}


@pytest.mark.parametrize("variant", ["v2h", "v2t", "v2m", "v2s"])
@pytest.mark.parametrize("M", [1, 2, 3, 5, 8])
def test_v2h_v2t_bf16_decode_takes_the_decode_tile(variant, M):
    """v2h, v2t, v2m and v2s with bf16 operands on a vec-4 weight: every M
    from the variant's DECODE_MMA_MIN_ROWS to MMA_MIN_ROWS - 1 takes its
    decode tile at every 8B decode shape it runs (v2h the head too; v2t
    and v2s leave the gs-16 head to v2g, v2m to v2p), fewer rows the
    CUDA-core tiles; f32 operands and vec-1 weights keep the CUDA-core
    tiles."""
    lo = qmatmul.DECODE_MMA_MIN_ROWS[variant]
    assert 1 <= lo < qmatmul.MMA_MIN_ROWS
    route = qmatmul._v2_route(variant, torch.bfloat16)
    assert route[3:] == (True, lo)
    shapes = STEP_8B if variant == "v2h" else {k: v for k, v in STEP_8B.items() if k != "lm_head"}
    for d_out, n_sg in shapes.values():
        core = qmatmul._launch_plan(M, d_out, n_sg, 132, 4, 8)
        got = qmatmul._plan(M, d_out, n_sg, 132, 4, *route)
        assert got == (qmatmul._decode_mma_plan(d_out, n_sg, 132) if M >= lo else core)
        for mxu, vec in ((torch.float32, 4), (torch.bfloat16, 1)):
            assert qmatmul._plan(M, d_out, n_sg, 132, vec, *qmatmul._v2_route(variant, mxu)) == \
                qmatmul._launch_plan(M, d_out, n_sg, 132, vec, 8)


@pytest.mark.parametrize("variant,lib,code,gs", [("v2h", "qmatmul_v3", 4, 32),
                                                 ("v2t", "qmatmul_v2m", 1, 32),
                                                 ("v2m", "qmatmul_v2m", 0, 32),
                                                 ("v2s", "qmatmul_v2g", 5, 32)])
@pytest.mark.parametrize("mt,counted", [(8, None), (qmatmul.DECODE_MMA_TILE, "decode_mma_launches"),
                                        (32, "mma_launches")])
def test_v2h_v2t_wrappers_count_each_tile(variant, lib, code, gs, mt, counted, monkeypatch):
    """A v2h, v2t, v2m or v2s launch counts once on ``launches`` and, by the
    tile that ran, on ``decode_mma_launches`` or ``mma_launches``; each
    asks for its own route (a stand-in launch on the meta device reports
    the tile)."""
    from types import SimpleNamespace

    fn = getattr(qmatmul, qmatmul.V2_WRAPPERS[variant])
    routes = []

    def launch(lib, code, x, rql, mxu_dtype, *route):
        routes.append((lib, code, route))
        return torch.empty(x.shape[0], 8, device="meta"), mt

    monkeypatch.setattr(qmatmul, "_launch_v2", launch)
    before = {k: getattr(fn, k) for k in ("launches", "decode_mma_launches", "mma_launches")}
    for k, v in before.items():  # restored after the test: others read the counts
        monkeypatch.setattr(fn, k, v)
    fn(torch.empty(8, 256, device="meta"), SimpleNamespace(group_size=gs, per_byte=2))
    assert routes == [(lib, code, qmatmul._v2_route(variant, torch.bfloat16))]
    after = {k: getattr(fn, k) - v for k, v in before.items()}
    assert after == {"launches": 1, "decode_mma_launches": int(counted == "decode_mma_launches"),
                     "mma_launches": int(counted == "mma_launches")}


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


def _v1_in_tile_order(x, rql):
    """v1 as its tensor-core tiles compute it (csrc/qmatmul_v1_mma.cuh on
    the mainloop of csrc/qmatmul_mma.cuh), in f32: for each 64-row step q
    of a supergroup the staged code rows (4-bit codes: byte rows 32q.. of
    the supergroup, whose low nibbles are weight rows 32q.. and high
    nibbles 128 + 32q..; byte codes: rows 64q..), each group's exact
    partial bf16(x_g) @ q_g times its scale_t row into the sum, then the
    step's groups' xsum @ offset_t rows out of it."""
    M, d_in = x.shape
    gs, pb, d_out = rql.group_size, rql.per_byte, rql.d_out
    xb, x32 = x.to(torch.bfloat16).float(), x.float()
    y = torch.zeros(M, d_out)
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
            groups = [(int(rows[lg * gs]) // gs, slice(lg * gs, lg * gs + gs))
                      for lg in range(64 // gs)]
            for g, k in groups:
                y = y + (xb[:, rows[k]] @ codes[k]) * rql.scale_t[g]
            for g, k in groups:
                y = y - x32[:, rows[k]].sum(1, keepdim=True) * rql.offset_t[g]
    return y


@pytest.mark.parametrize("qtype", ALL_K)
@pytest.mark.parametrize("M", [9, 33])
def test_v1_group_dot_in_tile_order_matches_jax_interpret(qtype, M):
    """The function v1's tensor-core tiles compute, in their order (raw
    codes read by the tiles' row map, each group's partial scaled by
    scale_t, xsum @ offset_t, which carries Q3_K's and Q6_K's shift),
    against JAX's v1 Pallas kernel in interpret mode on a bf16-valued x:
    the products are exact on both sides and only the grouping and the
    order of the f32 sums differ, so within 1e-5 of the largest sum of
    |terms| of an output (the limit the tiles are held to on the card); so
    does the port's plain version."""
    jr, tr = _v1_pair(qtype, d_in=1024, seed=70 + int(qtype))
    xt = torch.from_numpy(np.random.default_rng(M).normal(size=(M, 1024)).astype(np.float32))
    xt = xt.to(torch.bfloat16).float()
    want = np.asarray(jq.dequant_matmul_pallas(jnp.asarray(xt.numpy()), jr, tile_out=256,
                                               tile_in=512, interpret=True))
    got = _v1_in_tile_order(xt, tr).numpy()
    ng, gs = tr.scale_t.shape[0], tr.group_size
    q = qmatmul._unpack_codes(tr.qs, tr.per_byte, 1024).float()
    sq = (q.reshape(ng, gs, -1) * tr.scale_t[:, None, :]).reshape(1024, -1)
    terms = (xt.abs() @ sq.abs() + xt.reshape(M, ng, gs).sum(-1).abs() @ tr.offset_t.abs())
    tol = 1e-5 * terms.max().item()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(qmatmul.dequant_matmul_v1_reference(xt, tr).numpy(), got,
                               rtol=0, atol=tol)


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


def test_cuda_build_runs_nvcc_in_csrc_on_the_bare_name(tmp_path, monkeypatch):
    """cuda_build.build runs nvcc in ops/csrc on the bare source name and
    hands cudafe++ that name as the source's path (it hashes the path into
    the anonymous namespace's symbols, so an absolute path made the build
    depend on where the tree lies), writes to an absolute temporary path
    moved into place with nvcc's output kept beside it, and keys the
    library on the command's form too. nvcc and subprocess.run are
    stand-ins here: no compiler runs."""
    from pathlib import Path
    from types import SimpleNamespace

    from gptq_gguf_tpu_torch.ops import cuda_build

    calls = []

    def run(cmd, **kw):
        calls.append((cmd, kw))
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
        return SimpleNamespace(returncode=0, stdout="ptxas info")

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", run)
    assert cuda_build.build("qmatmul_v2m") == "ptxas info"
    (cmd, kw), = calls
    assert kw["cwd"] == cuda_build.CSRC and (cuda_build.CSRC / "qmatmul_v2m.cu").is_file()
    assert cmd[0] == "/usr/local/cuda/bin/nvcc" and cmd[-1] == "qmatmul_v2m.cu"
    assert [a for a in cmd if a.endswith(".cu")] == ["--orig_src_path_name=qmatmul_v2m.cu",
                                                     "qmatmul_v2m.cu"]
    assert cmd[cmd.index("--orig_src_path_name=qmatmul_v2m.cu") - 1] == "-Xcudafe"
    assert not any(str(cuda_build.CSRC) in a for a in cmd)
    assert tuple(cmd[1:1 + len(cuda_build.NVCC_FLAGS)]) == cuda_build.NVCC_FLAGS
    tmp = Path(cmd[cmd.index("-o") + 1])
    lib = cuda_build.library_path("qmatmul_v2m")
    assert tmp.is_absolute() and tmp.parent == lib.parent == tmp_path / "_build"
    assert not tmp.exists() and lib.read_bytes() == b"lib"
    assert lib.with_suffix(".log").read_text() == "ptxas info"
    assert cuda_build.build("qmatmul_v2m") is None and len(calls) == 1  # built already
    command = cuda_build._command  # another form of the command is another library
    monkeypatch.setattr(cuda_build, "_command", lambda *a: command(*a)[:-1] + ["./qmatmul_v2m.cu"])
    assert cuda_build.library_path("qmatmul_v2m") != lib
