"""The CUDA kernels (v2g, v1 and v4 dequant-matmul, the v2 variants v2 /
v3 / v2f / v2h / v2s / v2m / v2t / v2p, the tensor-core prefill tiles of
every v2 variant, of v1 and of v4, the tensor-core decode tiles of v2g,
v2, v3, v2f, v2h, v2s, v2m, v2t, v2p, v1 and v4, GPTQ
column-block solve, paged
flash-decode over bf16 / f32 and int4 pools) against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one. The file imports neither JAX nor the JAX package, so on
a card host it runs without them:

    python -m pytest tests/test_torch_kernel_cuda.py --noconftest -q

Tolerances: v2g and its plain version compute the same bf16 products and
differ only in the order of the f32 sums: atol 1e-4 of max|y|. The v1
(f32) and v4 (bf16 products) kernels likewise: atol 1e-4 of the largest
sum of |terms| of one output (1e-5 on v4's and v1's tensor-core tiles,
their decode tiles among them, each with a planted control that must
fail it), and so do
the v2 variant kernels in either operand type (1e-5 on the group-dot
and v2s tensor-core tiles and on the decode tiles of v2g, v2, v3, v2f,
v2h, v2s, v2m, v2t, v2p and v4). The GPTQ solve repeats its plain version's
IEEE f32 operations in the same order: codes and errors equal bit for bit. The paged decode kernels and their
plain versions sum the same f32 terms in another order (and take exp and
tanh from other libraries; the bf16 / int4 kernels' tensor-core products
carry q in three bf16 parts and P in two): atol 1e-4 of max|out|.

Beside the kernels, the K-quant fit (no kernel: a string of torch
operations) on the card against the CPU: every step elementwise IEEE in a
fixed order, so params and codes equal bit for bit."""

import numpy as np
import pytest
import torch

from gptq_gguf_tpu_torch.formats.ggml import KQUANT_SPECS, GGMLQuantizationType as T
from gptq_gguf_tpu_torch.models.llama import LlamaConfig
from gptq_gguf_tpu_torch.ops import gptq, paged_attention as pa, qmatmul, qmv4
from gptq_gguf_tpu_torch.ops.kquant import SuperGroupParams
from gptq_gguf_tpu_torch.serving import model as qmodel

ALL_K = [T.Q2_K, T.Q3_K, T.Q4_K, T.Q5_K, T.Q6_K]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rql(qtype, d_out, d_in, seed, device, pack=qmatmul.pack_runtime_v2):
    """Random codes and scales (weights of std ~ 1/sqrt(d_in)), packed by
    ``pack`` (any format's packer)."""
    rng = np.random.default_rng(seed)
    spec = KQUANT_SPECS[qtype]
    n_sg, ng = d_in // 256, d_in // spec.group_size
    q = rng.integers(spec.qmin, spec.qmax + 1, size=(d_out, d_in))
    ss = (rng.uniform(0.5, 1.5, (d_out, n_sg)) / (d_in ** 0.5 * spec.scale_maxq
                                                  * (spec.qmax - spec.qmin))).astype(np.float16)
    if spec.signed:
        sc = rng.integers(-spec.scale_maxq, spec.scale_maxq + 1, (d_out, ng))
        zq = np.zeros((d_out, ng), np.int64)
    else:
        sc = rng.integers(0, spec.scale_maxq + 1, (d_out, ng))
        zq = rng.integers(0, spec.scale_maxq + 1, (d_out, ng))
    return pack(q, SuperGroupParams(ss, ss, sc, zq), qtype, device=device)


def _check(x, rql):
    n0 = qmatmul.dequant_matmul_v2g.launches
    got = qmatmul.dequant_matmul(x, rql)
    want = qmatmul.dequant_matmul_v2g_reference(x, rql)
    torch.cuda.synchronize()
    assert qmatmul.dequant_matmul_v2g.launches == n0 + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5,
                               atol=1e-4 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", ALL_K)
@pytest.mark.parametrize("M,d_out,d_in,dtype", [
    (1, 512, 512, torch.float32),     # one row, K split across supergroups
    (3, 768, 1024, torch.bfloat16),
    (8, 4096, 512, torch.bfloat16),   # decode tile, four warps per supergroup
    (40, 768, 512, torch.float32),    # tensor-core tile of 64 rows, ragged
    (5, 1000, 1024, torch.bfloat16),  # d_out % 4 == 0, 1000 columns
    (6, 333, 512, torch.float32),     # ragged d_out: one column per thread
])
def test_kernel_matches_plain(cuda, qtype, M, d_out, d_in, dtype):
    rql = _rql(qtype, d_out, d_in, seed=M * 7 + int(qtype), device=cuda)
    x = torch.randn(M, d_in, generator=torch.Generator().manual_seed(M)).to(cuda, dtype)
    _check(x, rql)


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", ALL_K, ids=lambda t: t.name)
def test_kquant_fit_on_card_equals_cpu(cuda, qtype):
    """quantize_rtn with and without an importance matrix, the card against
    the CPU (the llama-quantize route's fit); the GPTQ refit's card_sums
    path runs too (its sums may differ in the last bit)."""
    from gptq_gguf_tpu_torch.ops import kquant

    rng = np.random.default_rng(int(qtype))
    x = torch.from_numpy((rng.normal(size=(96, 1024)) * 0.02).astype(np.float32))
    x[0, :256] = 0.0
    im = torch.from_numpy(rng.uniform(0.05, 3.0, 1024).astype(np.float32))
    for imx in (None, im):
        q_cpu, p_cpu = kquant.quantize_rtn(x, qtype, imatrix=imx)
        q_gpu, p_gpu = kquant.quantize_rtn(x.to(cuda), qtype,
                                           imatrix=None if imx is None else imx.to(cuda))
        assert torch.equal(q_gpu.cpu(), q_cpu)
        for a, b in zip(p_gpu, p_cpu):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    p = kquant.fit_supergroups(x.to(cuda), qtype, card_sums=True)
    assert all(a.is_cuda and a.shape == b.shape for a, b in zip(p, p_cpu))


@pytest.mark.cuda
def test_misaligned_planes_take_the_scalar_path(cuda):
    rql = _rql(T.Q4_K, 512, 512, seed=1, device=cuda)
    buf = torch.empty(rql.qs.numel() + 1, dtype=torch.uint8, device=cuda)
    qs = buf[1:].view(rql.qs.shape)
    qs.copy_(rql.qs)
    shifted = qmatmul.RuntimeQuantLinearV2(qs, rql.d_sg, rql.dmin_sg, rql.sc_q, rql.mn_q,
                                           rql.d_in, rql.group_size, rql.per_byte,
                                           rql.shift, rql.d_rep)
    _check(torch.randn(4, 512, device=cuda), shifted)


@pytest.mark.cuda
def test_wrong_planes_raise(cuda):
    rql = _rql(T.Q4_K, 256, 512, seed=2, device=cuda)
    bad = qmatmul.RuntimeQuantLinearV2(rql.qs, rql.d_sg, rql.dmin_sg, rql.sc_q.cpu(),
                                       rql.mn_q, rql.d_in, rql.group_size, rql.per_byte,
                                       rql.shift, rql.d_rep)
    with pytest.raises(ValueError, match="sc_q"):
        qmatmul.dequant_matmul(torch.randn(2, 512, device=cuda), bad)
    with pytest.raises(ValueError, match="d_in"):
        qmatmul.dequant_matmul(torch.randn(2, 256, device=cuda), rql)


@pytest.mark.cuda
def test_forward_cached_on_card_matches_cpu(cuda):
    """A tiny random model's prefill + 2 decode steps on the card (kernel)
    and on the CPU (plain version): logits within 2e-2 of max|logit| (bf16
    rounding of activations turns f32 sum-order differences into rare
    one-ulp flips), 4 kernel launches per layer plus the lm_head."""
    cfg = LlamaConfig(vocab_size=512, hidden_size=512, intermediate_size=1024,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)

    def params(dev):
        layers = []
        for li in range(2):
            s = 10 * li
            layers.append(qmodel.fuse_layer_projections({
                "input_layernorm": torch.ones(512, device=dev),
                "post_attention_layernorm": torch.ones(512, device=dev),
                "q_proj": _rql(T.Q4_K, 512, 512, s + 1, dev),
                "k_proj": _rql(T.Q4_K, 256, 512, s + 2, dev),
                "v_proj": _rql(T.Q4_K, 256, 512, s + 3, dev),
                "o_proj": _rql(T.Q4_K, 512, 512, s + 4, dev),
                "gate_proj": _rql(T.Q4_K, 1024, 512, s + 5, dev),
                "up_proj": _rql(T.Q4_K, 1024, 512, s + 6, dev),
                "down_proj": _rql(T.Q6_K, 512, 1024, s + 7, dev),
            }))
        return {"embed_tokens": emb.to(dev), "norm": torch.ones(512, device=dev),
                "lm_head": _rql(T.Q6_K, 512, 512, 99, dev), "layers": layers}

    emb = (torch.randn(512, 512, generator=gen) * 0.5).to(torch.bfloat16)
    ids = torch.randint(0, 512, (2, 9), generator=gen)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        p = params(dev)
        cache = qmodel.init_cache(cfg, 2, 1024, device=dev)  # the chunked decode path
        n0 = qmatmul.dequant_matmul_v2g.launches
        m0 = qmatmul.dequant_matmul_v2g.mma_launches
        rows, step = [], ids.to(dev)
        for _ in range(3):
            logits, cache = qmodel.forward_cached(p, cfg, step, cache)
            rows.append(logits.cpu())
            step = ids[:, :1].to(dev)  # the same tokens on both devices
        out[dev.type] = torch.stack(rows)
        if dev.type == "cuda":
            assert qmatmul.dequant_matmul_v2g.launches - n0 == 3 * (4 * 2 + 1)
            # the 18-row prefill's projections on the tensor cores; its
            # lm_head (each sequence's last row) and the 2-row steps not
            assert qmatmul.dequant_matmul_v2g.mma_launches - m0 == 4 * 2
    want = out["cpu"]
    np.testing.assert_allclose(out["cuda"].numpy(), want.numpy(), rtol=0,
                               atol=2e-2 * want.abs().max().item())


def _v4_packer(scale_dtype, layout):
    return lambda q, p, t, device: qmv4.pack_runtime_v4(q, p, t, scale_dtype=scale_dtype,
                                                        layout=layout, device=device)


# the v1 and v4 packers, and per format its kernel wrapper and plain version
PACKERS = {"v1": qmatmul.pack_runtime,
           "v4": _v4_packer(torch.float32, "i32"),
           "v4 bf16": _v4_packer(torch.bfloat16, "i32"),
           "v4 i8": _v4_packer(torch.float32, "i8"),
           "v4 i8 bf16": _v4_packer(torch.bfloat16, "i8")}


def _fns(rql):
    if isinstance(rql, qmatmul.RuntimeQuantLinear):
        return qmatmul.dequant_matmul_v1, qmatmul.dequant_matmul_v1_reference
    return qmv4.dequant_matmul_v4, qmv4.dequant_matmul_v4_reference


def _terms(x, rql):
    """max over outputs of the sum of |terms| both versions add up."""
    if isinstance(rql, qmatmul.RuntimeQuantLinear):
        return (x.float().abs() @ qmatmul.dequantize_runtime(rql).T.abs()).max().item()
    ng = rql.scale.shape[0]
    s = rql.scale.to(torch.bfloat16).float()
    w = (qmv4._codes_v4(rql).reshape(ng, rql.group_size, rql.d_out) * s[:, None, :])
    mag = x.to(torch.bfloat16).float().abs() @ w.reshape(rql.d_in_local, rql.d_out).abs()
    if rql.offc is not None:
        mag = mag + qmv4._group_sums(x, rql.group_size).abs() @ rql.offc.abs()
    return mag.max().item()


@pytest.fixture
def f32_exact(monkeypatch):
    """The plain v1 version is an f32 product: TF32 off."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", list(PACKERS))
@pytest.mark.parametrize("qtype", ALL_K)
@pytest.mark.parametrize("M,d_out,d_in,dtype", [
    (1, 768, 1024, torch.float32),    # one row, K split across supergroups
    (8, 768, 1024, torch.bfloat16),   # decode tile, four warps per supergroup
    (128, 768, 1024, torch.bfloat16),
    (300, 512, 1024, torch.float32),  # prefill rows, ragged last 32-row tile
    (5, 333, 512, torch.bfloat16),    # ragged d_out: one column per thread
    (40, 333, 512, torch.float32),    # both: 32-row tiles of one column per thread
])
def test_v1_v4_kernels_match_plain(cuda, f32_exact, fmt, qtype, M, d_out, d_in, dtype):
    """The v1 kernel (f32) and the v4 kernel (bf16 products, f32 sums)
    against their plain versions: the same products, f32 sums in another
    order: within 1e-4 of the largest sum of |terms| of one output."""
    rql = _rql(qtype, d_out, d_in, seed=M + 3 * int(qtype), device=cuda, pack=PACKERS[fmt])
    fn, ref = _fns(rql)
    x = torch.randn(M, d_in, generator=torch.Generator().manual_seed(M)).to(cuda, dtype)
    n0 = fn.launches
    got = qmatmul.dequant_matmul(x, rql)
    want = ref(x, rql)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert got.shape == want.shape == (M, d_out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                               atol=1e-4 * _terms(x, rql))


@pytest.mark.cuda
def test_v4_kernel_without_offsets(cuda):
    """A v4 weight without an offc plane (a type with neither a min nor a
    shift): the kernel skips the correction as its plain version does."""
    v4 = _rql(T.Q4_K, 512, 1024, 4, cuda, pack=PACKERS["v4 bf16"])
    bare = qmv4.RuntimeQuantLinearV4(v4.qs, v4.scale, None, v4.d_in, v4.group_size,
                                     v4.per_byte)
    x = torch.randn(8, 1024, generator=torch.Generator().manual_seed(4)).to(cuda)
    got = qmatmul.dequant_matmul(x, bare)
    want = qmv4.dequant_matmul_v4_reference(x, bare)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                               atol=1e-4 * _terms(x, bare))


# the v4 tensor-core tiles: at the threshold, a ragged 33, 128 with K split
# over supergroups, a ragged last 128-row tile (300) and 1024 rows unsplit;
# d_out 768, 1000 (code rows not 16-byte aligned: 4-byte copies) and 996
# (bf16 scale rows not 16-byte aligned either); 333 (one column per thread)
# stays on the CUDA-core tiles at any M
V4_MMA_CASES = [(qmatmul.MMA_MIN_ROWS, 768, 1024), (33, 768, 1024), (128, 768, 2048),
                (300, 768, 512), (1024, 2048, 256), (40, 1000, 512), (40, 996, 512),
                (40, 333, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32x", "bf16x"])
@pytest.mark.parametrize("M,d_out,d_in", V4_MMA_CASES)
@pytest.mark.parametrize("qtype", ALL_K, ids=lambda q: q.name)
@pytest.mark.parametrize("fmt", ["v4", "v4 bf16", "v4 i8", "v4 i8 bf16"])
def test_v4_mma_tiles_match_plain(cuda, fmt, qtype, M, d_out, d_in, dtype):
    """The v4 kernel's three bodies (4-bit codes in both layouts, 5/6-bit
    codes), f32 and bf16 scales, f32 and bf16 x, at prefill rows against
    the plain version: the same bf16 products, f32 sums in another order,
    within 1e-5 of the largest sum of |terms| of an output (reordering f32
    sums costs ~1e-7 * sqrt(d_in) of it). A vec-4 weight counts one
    tensor-core launch, a vec-1 weight none."""
    rql = _rql(qtype, d_out, d_in, seed=M + 7 * d_out + int(qtype), device=cuda,
               pack=PACKERS[fmt])
    fn = qmv4.dequant_matmul_v4
    x = (torch.randn(M, d_in, generator=torch.Generator().manual_seed(M + d_out)) * 0.5
         ).to(cuda, dtype)
    n0, m0 = fn.launches, fn.mma_launches
    body0 = dict(fn.body_launches)
    got = qmatmul.dequant_matmul(x, rql)
    want = qmv4.dequant_matmul_v4_reference(x, rql)
    torch.cuda.synchronize()
    assert (fn.launches - n0, fn.mma_launches - m0) == (1, int(d_out % 4 == 0))
    assert fn.body_launches[qmv4.body_of(rql)] == body0[qmv4.body_of(rql)] + 1
    assert got.shape == want.shape == (M, d_out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                               atol=1e-5 * _terms(x, rql))


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", [T.Q4_K, T.Q6_K], ids=lambda q: q.name)
def test_v4_mma_tiles_without_offsets_and_misaligned_x(cuda, qtype):
    """A v4 weight without an offc plane skips the xsum term on the
    tensor-core tiles too, and an x whose data is not 16-byte aligned is
    copied before those tiles read it; both within 1e-5 of the largest sum
    of |terms|, both counted on the tensor-core tiles."""
    v4 = _rql(qtype, 512, 1024, 5, cuda, pack=PACKERS["v4"])
    bare = qmv4.RuntimeQuantLinearV4(v4.qs, v4.scale, None, v4.d_in, v4.group_size,
                                     v4.per_byte)
    buf = torch.randn(64 * 1024 + 1, generator=torch.Generator().manual_seed(6)).to(cuda)
    bbuf = buf.to(torch.bfloat16)
    xs = (buf[:-1].view(64, 1024), buf[1:].view(64, 1024), bbuf[1:].view(64, 1024))
    assert [x.data_ptr() % 16 != 0 for x in xs] == [False, True, True]
    for x in xs:
        for w in (v4, bare):
            m0 = qmv4.dequant_matmul_v4.mma_launches
            got = qmv4.dequant_matmul_v4(x, w)
            want = qmv4.dequant_matmul_v4_reference(x, w)
            torch.cuda.synchronize()
            assert qmv4.dequant_matmul_v4.mma_launches == m0 + 1
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                                       atol=1e-5 * _terms(x, w))


@pytest.mark.cuda
def test_v1_v4_wrappers_refuse_wrong_planes(cuda):
    v1 = _rql(T.Q4_K, 256, 512, 2, cuda, pack=qmatmul.pack_runtime)
    bad = qmatmul.RuntimeQuantLinear(v1.qs, v1.scale_t.cpu(), v1.offset_t, v1.d_in,
                                     v1.group_size, v1.per_byte)
    with pytest.raises(ValueError, match="scale_t"):
        qmatmul.dequant_matmul(torch.randn(2, 512, device=cuda), bad)
    v4 = _rql(T.Q6_K, 256, 512, 3, cuda, pack=PACKERS["v4"])
    with pytest.raises(ValueError, match="d_in"):
        qmatmul.dequant_matmul(torch.randn(2, 256, device=cuda), v4)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["v1", "v4"])
def test_forward_cached_formats_on_card_match_cpu(cuda, f32_exact, fmt):
    """A tiny random model in the v1 or v4 format: prefill + 2 decode steps
    on the card (kernels) and on the CPU (plain versions), logits within
    2e-2 of max|logit| (bf16 activations turn f32 sum-order differences
    into rare one-ulp flips); v4 fuses q/k/v and gate/up (4 launches per
    layer plus the lm_head), v1 does not fuse (7 per layer plus the head)."""
    cfg = LlamaConfig(vocab_size=500, hidden_size=512, intermediate_size=1024,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(1)
    pack = PACKERS[fmt]

    def params(dev):
        layers = []
        for li in range(2):
            s = 10 * li
            layers.append(qmodel.fuse_layer_projections({
                "input_layernorm": torch.ones(512, device=dev),
                "post_attention_layernorm": torch.ones(512, device=dev),
                "q_proj": _rql(T.Q4_K, 512, 512, s + 1, dev, pack),
                "k_proj": _rql(T.Q4_K, 256, 512, s + 2, dev, pack),
                "v_proj": _rql(T.Q4_K, 256, 512, s + 3, dev, pack),
                "o_proj": _rql(T.Q4_K, 512, 512, s + 4, dev, pack),
                "gate_proj": _rql(T.Q4_K, 1024, 512, s + 5, dev, pack),
                "up_proj": _rql(T.Q4_K, 1024, 512, s + 6, dev, pack),
                "down_proj": _rql(T.Q6_K, 512, 1024, s + 7, dev, pack),
            }))
        # an unpadded head: d_out 500 is not a multiple of the column tile
        return {"embed_tokens": emb.to(dev), "norm": torch.ones(512, device=dev),
                "lm_head": _rql(T.Q6_K, 500, 512, 99, dev, pack), "layers": layers}

    emb = (torch.randn(500, 512, generator=gen) * 0.5).to(torch.bfloat16)
    ids = torch.randint(0, 500, (2, 9), generator=gen)
    fn = qmatmul.dequant_matmul_v1 if fmt == "v1" else qmv4.dequant_matmul_v4
    out = {}
    for dev in (torch.device("cpu"), cuda):
        p = params(dev)
        cache = qmodel.init_cache(cfg, 2, 64, device=dev)
        n0, v2g0 = fn.launches, qmatmul.dequant_matmul_v2g.launches
        rows, step = [], ids.to(dev)
        for _ in range(3):
            logits, cache = qmodel.forward_cached(p, cfg, step, cache)
            rows.append(logits.cpu())
            step = ids[:, :1].to(dev)
        out[dev.type] = torch.stack(rows)
        if dev.type == "cuda":
            per_layer = 7 if fmt == "v1" else 4
            assert fn.launches - n0 == 3 * (per_layer * 2 + 1)
            assert qmatmul.dequant_matmul_v2g.launches == v2g0
    want = out["cpu"]
    assert want.shape == (3, 2, 500)
    np.testing.assert_allclose(out["cuda"].numpy(), want.numpy(), rtol=0,
                               atol=2e-2 * want.abs().max().item())


def _solve_inputs(d_row, bs, qtype, seed, device):
    """w, U (the upper factor of a seeded SPD matrix), s, z for one block."""
    spec = KQUANT_SPECS[qtype]
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(bs, min(4 * bs, 1024)))  # 1024 samples at most: wide blocks stay cheap
    Hm = torch.from_numpy(A @ A.T / A.shape[1] + 0.1 * np.eye(bs))
    Ur = torch.linalg.cholesky(Hm.flip(0, 1)).flip(0, 1)
    U = torch.linalg.solve_triangular(Ur, torch.eye(bs, dtype=torch.float64), upper=True)
    w = rng.normal(size=(d_row, bs)) * 0.05
    s = rng.uniform(0.002, 0.01, size=(d_row, bs))
    z = np.zeros_like(s) if spec.signed else rng.uniform(0, 0.05, size=(d_row, bs))
    return [torch.as_tensor(a, dtype=torch.float32).to(device).contiguous()
            for a in (w, U, s, z)]


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", [T.Q4_K, T.Q6_K, T.Q3_K], ids=lambda q: q.name)
@pytest.mark.parametrize("d_row,bs", [(1, 32), (77, 128), (4096, 128), (300, 256),
                                      (20000, 128), (33, 64), (300, 512), (64, 4096),
                                      (28672, 128), (100, 200), (16400, 300)])
def test_gptq_solve_kernel_matches_plain(cuda, qtype, d_row, bs):
    spec = KQUANT_SPECS[qtype]
    args = _solve_inputs(d_row, bs, qtype, d_row + bs, cuda) + [spec.qmin, spec.qmax, 1e-9]
    n0 = gptq.solve_block.launches
    qk, ek = gptq.solve_block(*args)
    qp, ep = gptq.solve_block_reference(*args)
    torch.cuda.synchronize()
    assert gptq.solve_block.launches == n0 + 1
    assert torch.equal(qk, qp) and torch.equal(ek, ep)


@pytest.mark.cuda
def test_gptq_solve_kernel_refuses_what_it_does_not_take(cuda):
    w, U, s, z = _solve_inputs(64, 128, T.Q4_K, 1, cuda)
    with pytest.raises(ValueError, match="u:"):
        gptq.solve_block(w, U.double(), s, z, 0, 15, 1e-9)
    with pytest.raises(ValueError, match="s:"):
        gptq.solve_block(w, U, s.T.contiguous().T, z, 0, 15, 1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [128, 300])
def test_gptq_solve_kernel_extreme_values(cuda, bs):
    """Operands outside the kernel's fast division (a zero row, huge and
    tiny weights, a huge scale) send their panels through its exact pass:
    still bit-equal."""
    spec = KQUANT_SPECS[T.Q6_K]
    w, U, s, z = _solve_inputs(40, bs, T.Q6_K, 5, cuda)
    w[0] = 0.0
    w[1, 5], w[2, 7], w[3, bs - 1] = 1e30, 1e-30, -3e-39
    s[4, 9] = 1e25
    args = [w, U, s, z, spec.qmin, spec.qmax, 1e-9]
    qk, ek = gptq.solve_block(*args)
    qp, ep = gptq.solve_block_reference(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(ek).all()
    assert torch.equal(qk, qp) and torch.equal(ek, ep)


@pytest.mark.cuda
@pytest.mark.parametrize("qtype,kw", [(T.Q4_K, {}), (T.Q6_K, {"act_order": True,
                                                               "static_groups": True}),
                                      (T.Q4_K, {"static_groups": True, "block_size": 0})])
def test_gptq_quantize_matrix_kernel_equals_plain_on_card(cuda, qtype, kw, monkeypatch):
    rng = np.random.default_rng(3)
    W = (rng.normal(size=(96, 512)) * 0.08).astype(np.float32)
    X = rng.normal(size=(2048, 512)).astype(np.float32) @ (
        rng.normal(size=(512, 512)).astype(np.float32) / 23 + np.eye(512, dtype=np.float32))
    H = 2 * X.T @ X / 2048
    n0 = gptq.solve_block.launches
    got = gptq.gptq_quantize_matrix(W, H, qtype, gptq.GPTQConfig(**kw))
    # 512 columns in blocks of 128, or one block of all 512 (block_size 0)
    assert gptq.solve_block.launches - n0 == 512 // (kw.get("block_size", 128) or 512)
    monkeypatch.setattr(gptq, "solve_block", gptq.solve_block_reference)
    want = gptq.gptq_quantize_matrix(W, H, qtype, gptq.GPTQConfig(**kw))
    assert torch.equal(got.qweight, want.qweight)
    for a, b in zip(got.params, want.params):
        assert torch.equal(a, b)


def _paged_inputs(B, nKV, G, hd, page, pps, mode, seed, device, lengths=None):
    """q, the pools (bf16 / f32, or combined int4), a scrambled table with
    -1 past each slot's live pages, and lengths from 0 to the table's end
    (or ``lengths``)."""
    gen = torch.Generator().manual_seed(seed)
    n_pages = B * pps
    lengths = (torch.linspace(0, pps * page - 1, B).to(torch.int32) if lengths is None
               else torch.tensor(lengths, dtype=torch.int32))
    table = torch.full((B, pps), -1, dtype=torch.int32)
    order = torch.randperm(n_pages, generator=gen).to(torch.int32)
    for b in range(B):
        live = int(lengths[b]) // page + 1
        table[b, :live] = order[b * pps:b * pps + live]
    q = torch.randn(B, nKV, G, hd, generator=gen)
    k = torch.randn(n_pages + 1, nKV, page, hd, generator=gen) * 0.3
    v = torch.randn(n_pages + 1, nKV, page, hd, generator=gen)
    if mode == "q4":
        kq, ks = qmodel._quantize_kv_q4(k)
        vq, vs = qmodel._quantize_kv_q4(v)
        k, v = torch.cat([kq, vq], -1), torch.cat([ks, vs], -1).transpose(2, 3).contiguous()
    elif mode == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    return [t.to(device) for t in (q, k, v, table, lengths)]


def _fixed_splits(monkeypatch, n_split):
    """Make the wrapper split every slot's pages into n_split ranges of
    ceil(pps / n_split) pages (in place of its own plan)."""
    def plan(B, nKV, pps, page, n_sm):
        per = -(-pps // n_split)
        return -(-pps // per), per

    monkeypatch.setattr(pa, "_split_plan", plan)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "f32", "q4"])
@pytest.mark.parametrize("B,nKV,G,hd,page,pps,kw", [
    (8, 8, 4, 128, 64, 32, {}),                                  # Llama-3-8B decode
    (3, 2, 8, 64, 16, 9, {"window": 20}),                         # window page skip
    (2, 1, 16, 256, 40, 5, {"softcap": 30.0, "sinks": True}),    # ragged chunks
    (5, 4, 1, 192, 256, 3, {"sinks": True, "window": 300}),
    # every M row of the tensor-core tile a head; one head and a softcap at hd 64
    (2, 1, 16, 128, 64, 3, {"sinks": True}),
    (4, 3, 1, 64, 32, 4, {"softcap": 30.0}),
    # split edges: pps 7 in splits of 3 pages (the last of 1)
    (4, 2, 4, 128, 64, 7, {"n_split": 3}),
    # lengths ending exactly on a split's last position (splits of 32 positions)
    (3, 2, 4, 128, 16, 8, {"n_split": 4, "lengths": [31, 63, 95]}),
    # every split but the first empty
    (3, 2, 4, 128, 16, 8, {"n_split": 4, "lengths": [0, 5, 31], "sinks": True}),
    # a window across split edges (splits of 2 pages of 16)
    (3, 2, 8, 64, 16, 9, {"n_split": 5, "window": 40, "lengths": [30, 70, 143]}),
    # fill 2047 on a full 32-page table, the wrapper's own plan
    (8, 8, 4, 128, 64, 32, {"lengths": [2047] * 8}),
])
def test_paged_decode_kernel_matches_plain(cuda, monkeypatch, mode, B, nKV, G, hd, page, pps,
                                           kw):
    q, k, v, table, lengths = _paged_inputs(B, nKV, G, hd, page, pps, mode, B * hd + page, cuda,
                                            kw.get("lengths"))
    if "n_split" in kw:
        _fixed_splits(monkeypatch, kw["n_split"])
    kw = {k_: a for k_, a in kw.items() if k_ not in ("n_split", "lengths")}
    kw = dict(kw, scale=hd ** -0.5)
    if kw.pop("sinks", False):
        kw["sinks"] = torch.randn(nKV * G, generator=torch.Generator().manual_seed(1)).to(cuda)
    fn, ref = ((pa.paged_flash_decode_q4, pa.paged_flash_decode_q4_reference) if mode == "q4"
               else (pa.paged_flash_decode, pa.paged_flash_decode_reference))
    n0 = fn.launches
    got = fn(q, k, v, table, lengths, **kw)
    want = ref(q, k, v, table, lengths, **kw)
    again = fn(q, k, v, table, lengths, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 2
    assert got.shape == want.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
    assert torch.equal(got, again)  # partials joined in a fixed order: bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "q4"])
def test_paged_decode_kernel_reads_no_device_tensor(cuda, mode):
    """The wrapper plans its grid from shapes: no call synchronises with the
    card (no .item(), .cpu() or .tolist() of lengths or table)."""
    q, k, v, table, lengths = _paged_inputs(8, 8, 4, 128, 64, 32, mode, 5, cuda)
    fn = pa.paged_flash_decode_q4 if mode == "q4" else pa.paged_flash_decode
    fn(q, k, v, table, lengths, scale=0.1)  # first call: build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(q, k, v, table, lengths, scale=0.1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_paged_decode_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, table, lengths = _paged_inputs(2, 2, 4, 128, 16, 4, "bf16", 3, cuda)
    kw = dict(scale=0.1)
    with pytest.raises(ValueError, match="hd in"):
        pa.paged_flash_decode(q[..., :80].contiguous(), k[..., :80].contiguous(),
                              v[..., :80].contiguous(), table, lengths, **kw)
    with pytest.raises(ValueError, match="query heads"):
        pa.paged_flash_decode(q.repeat(1, 1, 5, 1), k, v, table, lengths, **kw)
    with pytest.raises(ValueError, match="table"):
        pa.paged_flash_decode(q, k, v, table.long(), lengths, **kw)
    with pytest.raises(ValueError, match="pools must be bf16 or f32"):
        pa.paged_flash_decode(q, k.half(), v.half(), table, lengths, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "f32", "q4"])
@pytest.mark.parametrize("B,nKV,G,hd,page,pps,kw", [
    # Phi-3-mini: 32 kv heads of one query head at hd 96, fills 300 and 1900
    (4, 32, 1, 96, 64, 32, {"lengths": [300, 1900, 0, 2047]}),
    # hd 96 with every tensor-core M row a head, a window across pages, a softcap
    (3, 2, 16, 96, 16, 9, {"window": 20, "softcap": 5.0, "sinks": True}),
    # Gemma-2-9B: 8 kv heads of two at hd 256, window 4096, softcap 50, fills
    # 4095-4097 (the window's edge) and the last position of page 64
    (5, 8, 2, 256, 64, 66, {"window": 4096, "softcap": 50.0,
                            "lengths": [4095, 4096, 4097, 4159, 4160]}),
])
def test_paged_decode_kernel_at_the_gemma2_and_phi3_shapes(cuda, mode, B, nKV, G, hd, page,
                                                           pps, kw):
    """The paged kernel against its plain version at the attention shapes
    of Phi-3-mini (hd 96: bf16 pools on the tensor-core body, f32 on the
    CUDA-core one; int4 pools refused there, as in the JAX package) and
    Gemma-2-9B (hd 256 on the CUDA-core body with its window and softcap),
    within 1e-4 of max|out| as the kernel's other cases."""
    q, k, v, table, lengths = _paged_inputs(B, nKV, G, hd, page, pps, mode, B * hd + page, cuda,
                                            kw.get("lengths"))
    kw = dict({k_: a for k_, a in kw.items() if k_ != "lengths"}, scale=hd ** -0.5)
    if kw.pop("sinks", False):
        kw["sinks"] = torch.randn(nKV * G, generator=torch.Generator().manual_seed(1)).to(cuda)
    fn, ref = ((pa.paged_flash_decode_q4, pa.paged_flash_decode_q4_reference) if mode == "q4"
               else (pa.paged_flash_decode, pa.paged_flash_decode_reference))
    if mode == "q4" and hd % 64:
        with pytest.raises(ValueError, match="multiple of 64"):
            fn(q, k, v, table, lengths, **kw)
        return
    n0 = fn.launches
    got = fn(q, k, v, table, lengths, **kw)
    want = ref(q, k, v, table, lengths, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("d_out,d_in,qtype", [(8192, 3584, T.Q4_K), (3584, 14336, T.Q4_K),
                                              (256000, 3584, T.Q6_K), (9216, 3072, T.Q4_K),
                                              (3072, 8192, T.Q4_K), (32064, 3072, T.Q6_K)],
                         ids=["gemma2_qkv", "gemma2_down", "gemma2_head", "phi3_qkv",
                              "phi3_down", "phi3_head"])
def test_v2g_at_the_gemma2_and_phi3_shapes(cuda, d_out, d_in, qtype):
    """v2g against its plain version at Gemma-2-9B's fused q / k / v, its
    down projection and its 256000-row head, and at Phi-3-mini's fused
    q / k / v, down and 32064-row head (padded to 32256 as the serving
    loader pads it), with the limits of the qwen family case."""
    rql = _rql(qtype, d_out, d_in, seed=d_out + d_in, device=cuda)
    if d_out % 512:
        rql = qmatmul.pad_dout_v2(rql)
    fn = qmatmul.dequant_matmul_v2g
    gen = torch.Generator().manual_seed(d_in)
    for M, limit in ((1, 1e-4), (8, 1e-5), (128, 1e-4)):
        x = torch.randn(M, d_in, generator=gen).to(cuda, torch.bfloat16)
        got = fn(x, rql)
        want = qmatmul.dequant_matmul_v2g_reference(x, rql)
        torch.cuda.synchronize()
        assert got.shape == (M, rql.d_out) and bool(torch.isfinite(got).all())
        err = (got - want).abs().max().item()
        assert err <= limit * _v2_terms(x, rql, torch.bfloat16), (M, err)


# the v2 kernel variants: (variant, wrapper, plain version) and the types
# each runs on itself (v2s on 4-bit codes, v2m / v2t at group size 32, v2p
# at 16)
def _per_weight(variant):
    return (getattr(qmatmul, qmatmul.V2_WRAPPERS[variant]),
            lambda x, rql, mxu: qmatmul.dequant_matmul_v2w_reference(x, rql, mxu, variant))


V2_VARIANTS = {**{v: (*_per_weight(v), ALL_K) for v in ("v2g", "v2", "v3", "v2f", "v2h")},
               "v2s": (*_per_weight("v2s"), [T.Q2_K, T.Q3_K, T.Q4_K]),
               "v2m": (qmatmul.dequant_matmul_v2m, qmatmul.dequant_matmul_v2m_reference,
                       [T.Q4_K, T.Q5_K]),
               "v2t": (qmatmul.dequant_matmul_v2t, qmatmul.dequant_matmul_v2m_reference,
                       [T.Q4_K, T.Q5_K]),
               "v2p": (qmatmul.dequant_matmul_v2p, qmatmul.dequant_matmul_v2m_reference,
                       [T.Q2_K, T.Q3_K, T.Q6_K])}
MXU = {"bf16": torch.bfloat16, "f32": torch.float32}
# every v2 kernel wrapper, by the variant it runs
V2_WRAPPERS = {v: getattr(qmatmul, name) for v, name in qmatmul.V2_WRAPPERS.items()}


def _v2_terms(x, rql, mxu_dtype):
    """max over outputs of the sum of |terms| a v2 variant adds up: the
    rounded x against |scale * (q - shift)| (v2's per-weight offset adds
    |off|), and for the group-dot kernels |xsum| against |off2|."""
    gs, d_in = rql.group_size, rql.d_in_local
    scale, off = qmatmul._group_scales_v2(rql)
    _, off2 = qmatmul._folded_planes_v2(rql)
    q = qmatmul._unpack_codes(rql.qs, rql.per_byte, d_in).float().reshape(-1, gs, rql.d_out)
    w = (scale[:, None, :] * q).abs() + off[:, None, :].abs()
    xr = qmatmul._mxu_round(x.float(), mxu_dtype).abs()
    mag = xr @ w.reshape(d_in, rql.d_out)
    if off2 is not None:
        mag = mag + x.float().reshape(x.shape[0], -1, gs).sum(-1).abs() @ off2.abs()
    return mag.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", list(MXU))
@pytest.mark.parametrize("M,d_out,d_in,dtype", [
    (1, 768, 1024, torch.float32),    # one row, K split across supergroups
    (8, 768, 1024, torch.bfloat16),   # decode tile, four warps per supergroup
    (33, 512, 1024, torch.float32),   # ragged last row tile
    (128, 768, 1024, torch.bfloat16),
    (300, 512, 1024, torch.float32),  # prefill rows
    (5, 333, 512, torch.bfloat16),    # ragged d_out: one column per thread
])
@pytest.mark.parametrize("variant,qtype", [(v, q) for v, (_, _, qs) in V2_VARIANTS.items()
                                           for q in qs], ids=lambda a: getattr(a, "name", a))
def test_v2_variant_kernels_match_plain(cuda, f32_exact, variant, qtype, M, d_out, d_in, dtype,
                                        mxu):
    """Each v2 variant kernel against its plain version: the same products
    (bf16 operands, raw codes or f32), f32 sums in another order: within
    1e-4 of the largest sum of |terms| of one output."""
    fn, ref, _ = V2_VARIANTS[variant]
    rql = _rql(qtype, d_out, d_in, seed=M + 5 * int(qtype), device=cuda)
    x = torch.randn(M, d_in, generator=torch.Generator().manual_seed(M)).to(cuda, dtype)
    n0 = fn.launches
    got = fn(x, rql, MXU[mxu])
    want = ref(x, rql, MXU[mxu])
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert got.shape == want.shape == (M, d_out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                               atol=1e-4 * _v2_terms(x, rql, MXU[mxu]))


# the tensor-core tiles (csrc/qmatmul_v2_mma.cuh): M one below and at the
# threshold, a ragged row tile (300), 128 and 1024 rows; d_out 768, a ragged
# 1000 (d_out % 16 != 0: 4-byte copies) and a one-column-per-thread 333 (the
# CUDA-core tiles at any M); x in f32 (rounded while staged) and bf16;
# K split over supergroups or not (2048 columns at 1024 rows)
MMA_CASES = [
    (qmatmul.MMA_MIN_ROWS - 1, 768, 1024, torch.bfloat16),
    (qmatmul.MMA_MIN_ROWS, 768, 1024, torch.float32),
    (qmatmul.MMA_MIN_ROWS, 1000, 1024, torch.bfloat16),
    (128, 768, 1024, torch.bfloat16),
    (128, 1000, 512, torch.float32),
    (300, 768, 512, torch.float32),
    (300, 1000, 1024, torch.bfloat16),
    (1024, 768, 1024, torch.bfloat16),
    (1024, 1000, 512, torch.float32),
    (1024, 2048, 256, torch.bfloat16),
    (40, 333, 512, torch.bfloat16),
    (300, 333, 512, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("M,d_out,d_in,dtype", MMA_CASES)
@pytest.mark.parametrize("variant,qtype", [(v, q) for v in qmatmul.MMA_VARIANTS
                                           for q in V2_VARIANTS[v][2]],
                         ids=lambda a: getattr(a, "name", a))
def test_mma_tiles_match_plain(cuda, f32_exact, variant, qtype, M, d_out, d_in, dtype):
    """The per-weight builds with bf16 operands at prefill rows against their
    plain versions, within 1e-4 of the largest sum of |terms| of an output
    (the same products, f32 sums in another order); from MMA_MIN_ROWS rows
    a vec-4 weight counts one tensor-core launch and no decode-tile one."""
    fn, ref, _ = V2_VARIANTS[variant]
    rql = _rql(qtype, d_out, d_in, seed=M + 3 * d_out + int(qtype), device=cuda)
    x = (torch.randn(M, d_in, generator=torch.Generator().manual_seed(M + d_out)) * 0.5
         ).to(cuda, dtype)
    n0, m0 = fn.launches, fn.mma_launches
    got = fn(x, rql, torch.bfloat16)
    want = ref(x, rql, torch.bfloat16)
    torch.cuda.synchronize()
    mma = M >= qmatmul.MMA_MIN_ROWS and d_out % 4 == 0
    assert (fn.launches - n0, fn.mma_launches - m0) == (1, int(mma))
    assert got.shape == want.shape == (M, d_out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                               atol=1e-4 * _v2_terms(x, rql, torch.bfloat16))


@pytest.mark.cuda
def test_mma_tiles_take_a_misaligned_x_and_leave_f32_alone(cuda):
    """An x whose data is not 16-byte aligned is copied before the
    tensor-core tiles of v2g and v2s read it; f32 operands stay on the
    CUDA-core tiles at prefill rows, for every per-weight variant."""
    rql = _rql(T.Q4_K, 512, 512, seed=4, device=cuda)
    buf = torch.randn(64 * 512 + 1, device=cuda).to(torch.bfloat16)
    x = buf[1:].view(64, 512)
    assert x.data_ptr() % 16
    for v in ("v2g", "v2s"):
        fn, ref, _ = V2_VARIANTS[v]
        m0 = fn.mma_launches
        got = fn(x, rql, torch.bfloat16)
        want = ref(x, rql, torch.bfloat16)
        torch.cuda.synchronize()
        assert fn.mma_launches == m0 + 1
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                                   atol=1e-5 * _v2_terms(x, rql, torch.bfloat16))
    counts = {v: V2_WRAPPERS[v].mma_launches for v in qmatmul.MMA_VARIANTS}
    n_s = qmatmul.dequant_matmul_v2s.launches
    for v in qmatmul.MMA_VARIANTS:
        V2_WRAPPERS[v](x, rql, torch.float32)
    torch.cuda.synchronize()
    assert {v: V2_WRAPPERS[v].mma_launches for v in qmatmul.MMA_VARIANTS} == counts
    assert qmatmul.dequant_matmul_v2s.launches == n_s + 1


# the group-dot tensor-core tiles (csrc/qmatmul_v2m_mma.cuh): M at the
# threshold (K split over supergroups), 64 and 130 (every row tile), 1024;
# a ragged d_out (1000: 4-byte copies) and a one-column-per-thread 333 (the
# CUDA-core tiles at any M); x in f32 (rounded while staged) and bf16
GROUP_DOT_MMA_CASES = [
    (qmatmul.MMA_MIN_ROWS, 768, 1024, torch.bfloat16),
    (qmatmul.MMA_MIN_ROWS, 1000, 2048, torch.float32),
    (64, 768, 2048, torch.bfloat16),
    (130, 1000, 1024, torch.bfloat16),
    (130, 768, 512, torch.float32),
    (1024, 2048, 512, torch.bfloat16),
    (40, 333, 512, torch.bfloat16),
]
GROUP_DOT_TYPES = [("v2m", T.Q4_K), ("v2m", T.Q5_K), ("v2t", T.Q4_K), ("v2t", T.Q5_K),
                   ("v2p", T.Q2_K), ("v2p", T.Q3_K), ("v2p", T.Q6_K)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,d_out,d_in,dtype", GROUP_DOT_MMA_CASES)
@pytest.mark.parametrize("variant,qtype", GROUP_DOT_TYPES, ids=lambda a: getattr(a, "name", a))
def test_group_dot_mma_tiles_match_plain(cuda, f32_exact, variant, qtype, M, d_out, d_in, dtype):
    """v2m, v2t and v2p with bf16 operands at prefill rows against their
    plain version, within 1e-5 of the largest sum of |terms| of an output
    (the same products of raw codes, partials scaled in f32, the sums in
    another order); from MMA_MIN_ROWS rows a vec-4 weight counts one
    tensor-core launch."""
    check_tile_1e5(cuda, variant, qtype, M, d_out, d_in, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("M,d_out,d_in,dtype", GROUP_DOT_MMA_CASES)
@pytest.mark.parametrize("qtype", V2_VARIANTS["v2s"][2], ids=lambda q: q.name)
def test_v2s_mma_tiles_match_plain(cuda, f32_exact, qtype, M, d_out, d_in, dtype):
    """v2s with bf16 operands at prefill rows (its two half-depth sums)
    against its plain version, held as the group-dot tiles are."""
    check_tile_1e5(cuda, "v2s", qtype, M, d_out, d_in, dtype)


def check_tile_1e5(cuda, variant, qtype, M, d_out, d_in, dtype):
    """One call of ``variant``'s wrapper against its plain version, within
    1e-5 of the largest sum of |terms| of an output, counting one launch
    and, from MMA_MIN_ROWS rows on a vec-4 weight, one tensor-core launch."""
    fn, ref, _ = V2_VARIANTS[variant]
    rql = _rql(qtype, d_out, d_in, seed=M + 7 * d_out + int(qtype), device=cuda)
    x = (torch.randn(M, d_in, generator=torch.Generator().manual_seed(M + d_in)) * 0.5
         ).to(cuda, dtype)
    n0, m0 = fn.launches, fn.mma_launches
    got = fn(x, rql, torch.bfloat16)
    want = ref(x, rql, torch.bfloat16)
    torch.cuda.synchronize()
    mma = M >= qmatmul.MMA_MIN_ROWS and d_out % 4 == 0
    assert (fn.launches - n0, fn.mma_launches - m0) == (1, int(mma))
    assert got.shape == want.shape == (M, d_out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                               atol=1e-5 * _v2_terms(x, rql, torch.bfloat16))


@pytest.mark.cuda
def test_group_dot_mma_tiles_take_a_misaligned_x_and_leave_f32_and_vec1_alone(cuda):
    """v2m / v2t / v2p copy an x that is not 16-byte aligned before the
    tensor-core tiles read it; f32 operands and vec-1 weights stay on the
    CUDA-core tiles at prefill rows (mma_launches unchanged)."""
    q4 = _rql(T.Q4_K, 512, 512, seed=4, device=cuda)
    q6 = _rql(T.Q6_K, 512, 512, seed=6, device=cuda)
    buf = torch.randn(64 * 512 + 1, device=cuda).to(torch.bfloat16)
    x = buf[1:].view(64, 512)
    assert x.data_ptr() % 16
    pairs = ((qmatmul.dequant_matmul_v2m, q4), (qmatmul.dequant_matmul_v2t, q4),
             (qmatmul.dequant_matmul_v2p, q6))
    for fn, rql in pairs:
        m0 = fn.mma_launches
        got = fn(x, rql)
        want = qmatmul.dequant_matmul_v2m_reference(x, rql)
        torch.cuda.synchronize()
        assert fn.mma_launches == m0 + 1
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                                   atol=1e-5 * _v2_terms(x, rql, torch.bfloat16))
    counts = [fn.mma_launches for fn, _ in pairs]
    n_t = qmatmul.dequant_matmul_v2t.launches
    for fn, rql in pairs:
        fn(x, rql, torch.float32)
    qmatmul.dequant_matmul_v2m(x, _rql(T.Q4_K, 333, 512, seed=8, device=cuda))
    qmatmul.dequant_matmul_v2t(x, _rql(T.Q5_K, 333, 512, seed=10, device=cuda))
    qmatmul.dequant_matmul_v2p(x, _rql(T.Q6_K, 333, 512, seed=9, device=cuda))
    torch.cuda.synchronize()
    assert [fn.mma_launches for fn, _ in pairs] == counts
    assert qmatmul.dequant_matmul_v2t.launches == n_t + 2


# v2g's tensor-core decode tile (csrc/qmatmul_decode_mma.cuh): every M of
# 1-8, d_out 768, a ragged 1000 (d_out % 16 != 0: 4-byte copies) and 4096;
# x in f32 (rounded while staged) and bf16; the K axis split over
# supergroups as the plan does (blocks 4: splits > 1 at these widths) or
# not at all (blocks 0: one split)
DECODE_MMA_CASES = [
    (1, 768, 1024, torch.bfloat16, 4),
    (1, 4096, 512, torch.float32, 0),
    (2, 768, 2048, torch.bfloat16, 4),
    (3, 1000, 1024, torch.float32, 4),
    (4, 768, 512, torch.bfloat16, 0),
    (5, 1000, 2048, torch.bfloat16, 4),
    (6, 768, 1024, torch.float32, 0),
    (7, 4096, 1024, torch.bfloat16, 4),
    (8, 768, 2048, torch.bfloat16, 4),
    (8, 1000, 512, torch.float32, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("M,d_out,d_in,dtype,blocks", DECODE_MMA_CASES)
@pytest.mark.parametrize("qtype", ALL_K, ids=lambda q: q.name)
def test_decode_mma_tile_matches_plain(cuda, f32_exact, monkeypatch, qtype, M, d_out, d_in, dtype,
                                       blocks):
    """v2g with bf16 operands at 1-8 rows on its tensor-core decode tile
    (one row too, which the route leaves to the CUDA-core tile:
    DECODE_MMA_MIN_ROWS lowered here) against its plain version, within
    1e-5 of the largest sum of |terms| of an output (the same bf16
    products, f32 sums in another order): one launch, counted on
    ``decode_mma_launches`` and not on ``mma_launches``; a second call is
    bit-equal (split-K partials reduced in a fixed order)."""
    monkeypatch.setattr(qmatmul, "DECODE_MMA_BLOCKS_PER_SM", blocks)
    monkeypatch.setitem(qmatmul.DECODE_MMA_MIN_ROWS, "v2g", 1)
    fn = qmatmul.dequant_matmul_v2g
    rql = _rql(qtype, d_out, d_in, seed=M + 11 * d_out + int(qtype), device=cuda)
    x = (torch.randn(M, d_in, generator=torch.Generator().manual_seed(M + d_in)) * 0.5
         ).to(cuda, dtype)
    splits = qmatmul._plan(M, d_out, d_in // 256, qmatmul._sm_count(cuda.index or 0), 4,
                           *qmatmul._v2_route("v2g", torch.bfloat16))[2]
    assert (splits == 1) == (blocks == 0)
    n0, d0, m0 = fn.launches, fn.decode_mma_launches, fn.mma_launches
    got = fn(x, rql)
    want = qmatmul.dequant_matmul_v2g_reference(x, rql)
    again = fn(x, rql)
    torch.cuda.synchronize()
    assert (fn.launches - n0, fn.decode_mma_launches - d0, fn.mma_launches - m0) == (2, 2, 0)
    assert got.shape == want.shape == (M, d_out) and got.dtype == torch.float32
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                               atol=1e-5 * _v2_terms(x, rql, torch.bfloat16))


@pytest.mark.cuda
def test_decode_mma_tile_takes_a_misaligned_x_and_leaves_the_rest_alone(cuda):
    """The decode tile copies an x that is not 16-byte aligned before it
    reads it; f32 operands, vec-1 weights, fewer rows than v2g's
    DECODE_MMA_MIN_ROWS and every other variant stay off v2g's decode tile
    at M <= 8 (v2g's decode_mma_launches unchanged, and no variant's
    mma_launches moves; the others run their own decode tiles)."""
    fn = qmatmul.dequant_matmul_v2g
    rql = _rql(T.Q4_K, 512, 512, seed=4, device=cuda)
    buf = torch.randn(8 * 512 + 1, device=cuda).to(torch.bfloat16)
    x = buf[1:].view(8, 512)
    assert x.data_ptr() % 16
    d0 = fn.decode_mma_launches
    got = fn(x, rql)
    want = qmatmul.dequant_matmul_v2g_reference(x, rql)
    torch.cuda.synchronize()
    assert fn.decode_mma_launches == d0 + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                               atol=1e-5 * _v2_terms(x, rql, torch.bfloat16))
    q6 = _rql(T.Q6_K, 512, 512, seed=6, device=cuda)
    mma = {v: V2_WRAPPERS[v].mma_launches for v in qmatmul.MMA_VARIANTS + qmatmul.MMA_GROUP_DOT}
    n0 = {v: f.launches for v, f in V2_WRAPPERS.items()}
    p0 = qmatmul.dequant_matmul_v2p.decode_mma_launches
    fn(x, rql, torch.float32)
    fn(x[:qmatmul.DECODE_MMA_MIN_ROWS["v2g"] - 1], rql)  # below the decode tile's rows
    fn(x, _rql(T.Q4_K, 333, 512, seed=8, device=cuda))
    for v in ("v2", "v3", "v2f", "v2h", "v2s", "v2m", "v2t"):
        V2_WRAPPERS[v](x, rql)
    qmatmul.dequant_matmul_v2p(x, q6)
    torch.cuda.synchronize()
    assert fn.decode_mma_launches == d0 + 1
    assert qmatmul.dequant_matmul_v2p.decode_mma_launches == p0 + 1
    assert {v: V2_WRAPPERS[v].mma_launches for v in mma} == mma
    assert {v: f.launches - n0[v] for v, f in V2_WRAPPERS.items()} == {
        "v2g": 3, **{v: 1 for v in V2_WRAPPERS if v != "v2g"}}


@pytest.mark.cuda
def test_decode_mma_tile_failures_raise(cuda, monkeypatch):
    """No fallback: a decode-tile launch the source does not instantiate
    (v2g's build with f32 operands given the decode tile's code; v1's
    entry point given it, tile code 1, with an f32 x) raises or returns an
    error, and so does a build failure of the library (v2g's, v1's), which
    counts nothing."""
    rql = _rql(T.Q4_K, 512, 512, seed=5, device=cuda)
    x = torch.randn(8, 512, device=cuda).to(torch.bfloat16)
    lib, code = qmatmul._PER_WEIGHT["v2g"]
    n0 = {v: (f.launches, f.decode_mma_launches) for v, f in V2_WRAPPERS.items()
          if hasattr(f, "decode_mma_launches")}
    with pytest.raises(RuntimeError, match="launch failed"):
        qmatmul._launch_v2(lib, code, x, rql, torch.float32,
                           *qmatmul._v2_route("v2g", torch.bfloat16))
    v1 = _rql(T.Q4_K, 512, 512, seed=5, device=cuda, pack=qmatmul.pack_runtime)
    xf, out = x.float(), torch.empty(8, 512, device=cuda)
    # tile 1 with mt DECODE_MMA_TILE (the decode tile), vec 4, 2 supergroups in 1 split
    rc = qmatmul.c_function("qmatmul_v1", "gg_v1_matmul", qmatmul._V1_ARGS)(
        xf.data_ptr(), 0, v1.qs.data_ptr(), v1.scale_t.data_ptr(), v1.offset_t.data_ptr(),
        None, out.data_ptr(), 8, 512, 512, v1.per_byte, v1.group_size, 1,
        qmatmul.DECODE_MMA_TILE, 4, 2, 1, torch.cuda.current_stream().cuda_stream)
    assert rc != 0
    assert {v: (f.launches, f.decode_mma_launches) for v, f in V2_WRAPPERS.items()
            if v in n0} == n0

    def broken(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(qmatmul, "c_function", lambda lib, *a: broken(lib))
    n0 = qmatmul.dequant_matmul_v2g.decode_mma_launches
    with pytest.raises(RuntimeError, match="nvcc failed for qmatmul_v2g"):
        qmatmul.dequant_matmul_v2g(x, rql)
    assert qmatmul.dequant_matmul_v2g.decode_mma_launches == n0
    fn = qmatmul.dequant_matmul_v1
    n1 = (fn.launches, fn.decode_mma_launches)
    with pytest.raises(RuntimeError, match="nvcc failed for qmatmul_v1"):
        fn(x, v1)
    assert (fn.launches, fn.decode_mma_launches) == n1


# v4's tensor-core decode tile (csrc/qmatmul_decode_mma.cuh with V4Mma):
# M = 1, 2, 5, 8; d_out 768, 1000 (code rows not 16-byte aligned: 4-byte
# copies) and 996 (bf16 scale rows not 16-byte aligned either); x in f32
# (rounded while staged) and bf16; the K axis split as the plan does
# (blocks 4) or not at all (blocks 0)
V4_DECODE_CASES = [
    (1, 768, 1024, torch.float32, 4),
    (2, 768, 1024, torch.bfloat16, 4),
    (2, 1000, 512, torch.float32, 0),
    (5, 1000, 2048, torch.float32, 4),
    (5, 996, 1024, torch.bfloat16, 4),
    (8, 996, 512, torch.bfloat16, 0),
    (8, 768, 2048, torch.float32, 4),
]


def _v4_unrounded(x, rql):
    """The planted control of the v4 tiles (chip_smoke.v4_unrounded): the
    plain version with each weight q * bf16(s) left unrounded (f32)."""
    ng = rql.scale.shape[0]
    s = rql.scale.to(torch.bfloat16).float()
    w = qmv4._codes_v4(rql).reshape(ng, rql.group_size, rql.d_out) * s[:, None, :]
    y = x.to(torch.bfloat16).float() @ w.reshape(rql.d_in_local, rql.d_out)
    if rql.offc is not None:
        y -= qmv4._group_sums(x, rql.group_size) @ rql.offc
    return y


def _v4_counts():
    fn = qmv4.dequant_matmul_v4
    return (fn.launches, fn.decode_mma_launches, fn.mma_launches,
            dict(fn.body_decode_mma_launches))


@pytest.mark.cuda
@pytest.mark.parametrize("M,d_out,d_in,dtype,blocks", V4_DECODE_CASES)
@pytest.mark.parametrize("qtype", ALL_K, ids=lambda q: q.name)
@pytest.mark.parametrize("fmt", ["v4", "v4 bf16", "v4 i8", "v4 i8 bf16"])
def test_v4_decode_mma_tile_matches_plain(cuda, monkeypatch, fmt, qtype, M, d_out, d_in, dtype,
                                          blocks):
    """The v4 kernel's three bodies (4-bit codes in both layouts, 5/6-bit
    codes), f32 and bf16 scales, f32 and bf16 x, at decode rows on the
    tensor-core decode tile against the plain version: the same bf16
    products, f32 sums in another order, within 1e-5 of the largest sum of
    |terms| of an output, a limit the unrounded weights (the planted
    control) fail. Each call counts one launch, on ``decode_mma_launches``
    and its body's, none on ``mma_launches``; a second call is bit-equal
    (split-K partials reduced in a fixed order)."""
    monkeypatch.setattr(qmatmul, "DECODE_MMA_BLOCKS_PER_SM", blocks)
    rql = _rql(qtype, d_out, d_in, seed=M + 13 * d_out + int(qtype), device=cuda,
               pack=PACKERS[fmt])
    fn = qmv4.dequant_matmul_v4
    x = (torch.randn(M, d_in, generator=torch.Generator().manual_seed(M + d_in)) * 0.5
         ).to(cuda, dtype)
    splits = qmatmul._plan(M, d_out, d_in // 256, qmatmul._sm_count(cuda.index or 0), 4,
                           mma=True, decode_mma=True,
                           decode_min_rows=qmatmul.DECODE_MMA_MIN_ROWS["v4"])[2]
    assert (splits == 1) == (blocks == 0)
    n0, d0, m0, body0 = _v4_counts()
    got = fn(x, rql)
    want = qmv4.dequant_matmul_v4_reference(x, rql)
    again = fn(x, rql)
    control = _v4_unrounded(x, rql)
    torch.cuda.synchronize()
    body = qmv4.body_of(rql)
    assert (fn.launches - n0, fn.decode_mma_launches - d0, fn.mma_launches - m0) == (2, 2, 0)
    assert fn.body_decode_mma_launches[body] == body0[body] + 2
    assert got.shape == want.shape == (M, d_out) and got.dtype == torch.float32
    assert torch.equal(got, again)
    tol = 1e-5 * _terms(x, rql)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=tol)
    assert (got - control).abs().max().item() > tol


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,qtype", [("v4", T.Q4_K), ("v4 i8", T.Q4_K), ("v4 i8 bf16", T.Q2_K),
                                       ("v4 bf16", T.Q3_K), ("v4 i8", T.Q6_K)],
                         ids=lambda a: getattr(a, "name", a))
def test_v4_decode_mma_tile_weights_bit_equal(cuda, fmt, qtype):
    """Through unit rows of x and without offc, the decode tile returns its
    bf16 weights: every row of the weight equal to bf16(q * bf16(s)) of
    the plain version, the "i8" high nibbles' 16 ((n ^ 8) - 8) * s
    (hi_code<true>) among them."""
    v4 = _rql(qtype, 512, 512, seed=21 + int(qtype), device=cuda, pack=PACKERS[fmt])
    bare = qmv4.RuntimeQuantLinearV4(v4.qs, v4.scale, None, v4.d_in, v4.group_size,
                                     v4.per_byte, v4.layout)
    ng = bare.scale.shape[0]
    s = bare.scale.to(torch.bfloat16).float()
    w = (qmv4._codes_v4(bare).reshape(ng, bare.group_size, 512) * s[:, None, :]).to(
        torch.bfloat16).float().reshape(512, 512)
    eye = torch.eye(512, device=cuda, dtype=torch.bfloat16)
    d0 = qmv4.dequant_matmul_v4.decode_mma_launches
    got = torch.cat([qmv4.dequant_matmul_v4(eye[k:k + 8], bare) for k in range(0, 512, 8)])
    torch.cuda.synchronize()
    assert qmv4.dequant_matmul_v4.decode_mma_launches == d0 + 64
    assert torch.equal(got, w)


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", [T.Q4_K, T.Q6_K], ids=lambda q: q.name)
def test_v4_decode_mma_tile_without_offsets_and_misaligned_x(cuda, qtype):
    """A v4 weight without an offc plane skips the xsum term on the decode
    tile too, and an x whose data is not 16-byte aligned is copied before
    the tile reads it; both within 1e-5 of the largest sum of |terms|,
    both counted on the decode tile."""
    v4 = _rql(qtype, 512, 1024, 7, cuda, pack=PACKERS["v4 i8"])
    bare = qmv4.RuntimeQuantLinearV4(v4.qs, v4.scale, None, v4.d_in, v4.group_size,
                                     v4.per_byte, v4.layout)
    buf = torch.randn(6 * 1024 + 1, generator=torch.Generator().manual_seed(8)).to(cuda)
    bbuf = buf.to(torch.bfloat16)
    xs = (buf[:-1].view(6, 1024), buf[1:].view(6, 1024), bbuf[1:].view(6, 1024))
    assert [x.data_ptr() % 16 != 0 for x in xs] == [False, True, True]
    for x in xs:
        for w in (v4, bare):
            n0, d0, m0, _ = _v4_counts()
            got = qmv4.dequant_matmul_v4(x, w)
            want = qmv4.dequant_matmul_v4_reference(x, w)
            torch.cuda.synchronize()
            assert _v4_counts()[:3] == (n0 + 1, d0 + 1, m0)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                                       atol=1e-5 * _terms(x, w))


@pytest.mark.cuda
def test_v4_decode_keeps_the_cuda_core_tiles_elsewhere(cuda):
    """Vec-1 weights (d_out % 4 != 0) stay on the CUDA-core tiles at M <=
    8, and _launch_v4 with the tensor-core tiles ruled out runs them for a
    vec-4 weight too, each held to the plain version within 1e-4 of the
    largest sum of |terms|."""
    fn = qmv4.dequant_matmul_v4
    v4 = _rql(T.Q4_K, 512, 512, 9, cuda, pack=PACKERS["v4"])
    ragged = _rql(T.Q6_K, 333, 512, 10, cuda, pack=PACKERS["v4 i8"])
    x = torch.randn(8, 512, generator=torch.Generator().manual_seed(10)).to(cuda, torch.bfloat16)
    for xi, w in ((x[:1], ragged), (x, ragged), (x[:2], ragged)):
        n0, d0, m0, _ = _v4_counts()
        got = fn(xi, w)
        want = qmv4.dequant_matmul_v4_reference(xi, w)
        torch.cuda.synchronize()
        assert _v4_counts()[:3] == (n0 + 1, d0, m0)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                                   atol=1e-4 * _terms(xi, w))
    n0 = _v4_counts()
    got, tile = qmv4._launch_v4(x, v4, mma=False, decode_mma=False)
    want = qmv4.dequant_matmul_v4_reference(x, v4)
    torch.cuda.synchronize()
    assert tile == "cuda_core" and _v4_counts() == n0  # a direct launch counts nothing
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                               atol=1e-4 * _terms(x, v4))


@pytest.mark.cuda
def test_v4_decode_mma_tile_failures_raise(cuda, monkeypatch):
    """No fallback: a decode-tile launch the source does not instantiate (a
    group size of 64, which no K-quant has) raises, and so does a build
    failure of the library; neither counts a launch."""
    v4 = _rql(T.Q4_K, 512, 512, seed=11, device=cuda, pack=PACKERS["v4"])
    gs64 = qmv4.RuntimeQuantLinearV4(v4.qs, v4.scale[::2].contiguous(), v4.offc[::2].contiguous(),
                                     v4.d_in, 64, v4.per_byte)
    x = torch.randn(8, 512, device=cuda).to(torch.bfloat16)
    n0 = _v4_counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        qmv4.dequant_matmul_v4(x, gs64)

    def broken(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(qmv4, "c_function", lambda lib, *a: broken(lib))
    with pytest.raises(RuntimeError, match="nvcc failed for qmatmul_v4"):
        qmv4.dequant_matmul_v4(x, v4)
    assert _v4_counts() == n0


@pytest.mark.cuda
@pytest.mark.parametrize("knob,gs16,want", [
    ("v2", "", {"v2": 2}), ("v2m", "", {"v2m": 1, "v2p": 1}), ("v2t", "", {"v2t": 1, "v2g": 1}),
    ("v2g", "v2p", {"v2g": 1, "v2p": 1}), ("v2p", "", {"v2m": 1, "v2p": 1}),
    ("v3", "", {"v3": 2}), ("v2f", "v2h", {"v2f": 1, "v2h": 1}), ("v2s", "", {"v2s": 1, "v2g": 1})])
def test_dispatch_launches_the_effective_variant(cuda, monkeypatch, knob, gs16, want):
    """dequant_matmul on a Q4_K and a Q6_K weight under each knob setting
    launches exactly the effective variants' kernels."""
    monkeypatch.setattr(qmatmul, "PALLAS_V2_VARIANT", knob)
    monkeypatch.setattr(qmatmul, "PALLAS_V2_VARIANT_GS16", gs16)
    n0 = {k: f.launches for k, f in V2_WRAPPERS.items()}
    x = torch.randn(8, 512, device=cuda, dtype=torch.bfloat16)
    for qtype in (T.Q4_K, T.Q6_K):
        qmatmul.dequant_matmul(x, _rql(qtype, 256, 512, seed=int(qtype), device=cuda))
    torch.cuda.synchronize()
    assert {k: f.launches - n0[k] for k, f in V2_WRAPPERS.items() if f.launches != n0[k]} == want


@pytest.mark.cuda
def test_v2_variant_wrappers_refuse(cuda):
    """Wrong planes raise, and so does a kernel given a format it does not
    take (v2s on byte codes, v2p at group size 32)."""
    rql = _rql(T.Q4_K, 256, 512, seed=2, device=cuda)
    bad = qmatmul.RuntimeQuantLinearV2(rql.qs, rql.d_sg, rql.dmin_sg, rql.sc_q.cpu(),
                                       rql.mn_q, rql.d_in, rql.group_size, rql.per_byte,
                                       rql.shift, rql.d_rep)
    x = torch.randn(2, 512, device=cuda)
    for fn in V2_WRAPPERS.values():
        if fn is qmatmul.dequant_matmul_v2p:
            continue
        with pytest.raises(ValueError, match="sc_q"):
            fn(x, bad)
        with pytest.raises(ValueError, match="d_in"):
            fn(torch.randn(2, 256, device=cuda), rql)
    with pytest.raises(ValueError, match="group size"):
        qmatmul.dequant_matmul_v2p(x, rql)
    with pytest.raises(ValueError, match="4-bit codes only"):
        qmatmul.dequant_matmul_v2s(x, _rql(T.Q6_K, 256, 512, seed=3, device=cuda))
    with pytest.raises(ValueError, match="mxu_dtype"):
        qmatmul.dequant_matmul_v2(x, rql, variant="v2g", mxu_dtype=torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["v2", "v2m", "v2t", "v3", "v2f", "v2h", "v2s"])
def test_forward_cached_variants_on_card_match_cpu(cuda, monkeypatch, variant):
    """test_forward_cached_on_card_matches_cpu under PALLAS_V2_VARIANT: the
    kernels on the card against the plain versions on the CPU (logits
    within 2e-2 of max|logit|), and the launches per forward of the
    effective variants (Q4_K layers and the Q6_K down / lm_head)."""
    monkeypatch.setattr(qmatmul, "PALLAS_V2_VARIANT", variant)
    cfg = LlamaConfig(vocab_size=512, hidden_size=512, intermediate_size=1024,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(2)

    def params(dev):
        layers = []
        for li in range(2):
            s = 10 * li
            layers.append(qmodel.fuse_layer_projections({
                "input_layernorm": torch.ones(512, device=dev),
                "post_attention_layernorm": torch.ones(512, device=dev),
                "q_proj": _rql(T.Q4_K, 512, 512, s + 1, dev),
                "k_proj": _rql(T.Q4_K, 256, 512, s + 2, dev),
                "v_proj": _rql(T.Q4_K, 256, 512, s + 3, dev),
                "o_proj": _rql(T.Q4_K, 512, 512, s + 4, dev),
                "gate_proj": _rql(T.Q4_K, 1024, 512, s + 5, dev),
                "up_proj": _rql(T.Q4_K, 1024, 512, s + 6, dev),
                "down_proj": _rql(T.Q6_K, 512, 1024, s + 7, dev),
            }))
        return {"embed_tokens": emb.to(dev), "norm": torch.ones(512, device=dev),
                "lm_head": _rql(T.Q6_K, 512, 512, 99, dev), "layers": layers}

    emb = (torch.randn(512, 512, generator=gen) * 0.5).to(torch.bfloat16)
    ids = torch.randint(0, 512, (2, 9), generator=gen)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        p = params(dev)
        cache = qmodel.init_cache(cfg, 2, 64, device=dev)
        n0 = {k: f.launches for k, f in V2_WRAPPERS.items()}
        rows, step = [], ids.to(dev)
        for _ in range(3):
            logits, cache = qmodel.forward_cached(p, cfg, step, cache)
            rows.append(logits.cpu())
            step = ids[:, :1].to(dev)
        out[dev.type] = torch.stack(rows)
        if dev.type == "cuda":
            # per forward: 3 Q4_K projections per layer, the Q6_K down of
            # each layer and the Q6_K head
            q6 = {"v2m": "v2p", "v2t": "v2g", "v2s": "v2g"}.get(variant, variant)
            want = {variant: 3 * 3 * 2}
            want[q6] = want.get(q6, 0) + 3 * 3
            got = {k: f.launches - n0[k] for k, f in V2_WRAPPERS.items() if f.launches != n0[k]}
            assert got == want
    want = out["cpu"]
    np.testing.assert_allclose(out["cuda"].numpy(), want.numpy(), rtol=0,
                               atol=2e-2 * want.abs().max().item())


# v1's tensor-core tiles (csrc/qmatmul_v1_mma.cuh, a bf16 x at MMA_MIN_ROWS
# rows or more on a vec-4 weight): the threshold, a ragged 33 (K split over
# supergroups), 128 and a ragged last 128-row tile (300); d_out 768, 1000
# (code rows not 16-byte aligned: 4-byte copies) and 4096
V1_MMA_CASES = [(qmatmul.MMA_MIN_ROWS, 768, 1024), (33, 768, 2048), (128, 1000, 512),
                (128, 4096, 1024), (300, 768, 512)]


def _v1_group_terms(x, rql):
    """max over outputs of the sum of |terms| v1's group dot adds up:
    |x| against |scale_t * q|, and |xsum| against |offset_t|."""
    ng, gs = rql.scale_t.shape[0], rql.group_size
    q = qmatmul._unpack_codes(rql.qs, rql.per_byte, rql.d_in_local).float()
    sq = (q.reshape(ng, gs, rql.d_out) * rql.scale_t[:, None, :]).reshape(rql.d_in_local, -1)
    xsum = x.float().reshape(x.shape[0], ng, gs).sum(-1)
    return (x.float().abs() @ sq.abs() + xsum.abs() @ rql.offset_t.abs()).max().item()


def _v1_bf16_weights(x, rql):
    """The planted control of v1's tiles: the plain version with each
    weight rounded to bf16 (what a dequantizing bf16 tile would compute),
    which the tiles' limit must reject."""
    w = qmatmul.dequantize_runtime(rql).to(torch.bfloat16).float()
    return x.float() @ w.T


@pytest.mark.cuda
@pytest.mark.parametrize("M,d_out,d_in", V1_MMA_CASES)
@pytest.mark.parametrize("qtype", ALL_K, ids=lambda q: q.name)
def test_v1_mma_tiles_match_plain(cuda, f32_exact, qtype, M, d_out, d_in):
    """v1 with a bf16 x at prefill rows on its tensor-core tiles against
    its plain version (the JAX kernel's f32 function): the same exact
    products of bf16 x values and codes, f32 sums grouped otherwise,
    within 1e-5 of the largest sum of |terms| of an output; the weights
    rounded to bf16 fail that limit. One launch, counted on mma_launches;
    a second call is bit-equal."""
    rql = _rql(qtype, d_out, d_in, seed=M + 13 * d_out + int(qtype), device=cuda,
               pack=qmatmul.pack_runtime)
    fn = qmatmul.dequant_matmul_v1
    x = (torch.randn(M, d_in, generator=torch.Generator().manual_seed(M + d_in)) * 0.5
         ).to(cuda, torch.bfloat16)
    n0, m0 = fn.launches, fn.mma_launches
    got = qmatmul.dequant_matmul(x, rql)
    again = fn(x, rql)
    want = qmatmul.dequant_matmul_v1_reference(x, rql)
    control = _v1_bf16_weights(x, rql)
    torch.cuda.synchronize()
    assert (fn.launches - n0, fn.mma_launches - m0) == (2, 2)
    assert got.shape == want.shape == (M, d_out) and got.dtype == torch.float32
    assert torch.equal(got, again)
    tol = 1e-5 * _v1_group_terms(x, rql)
    assert (got - want).abs().max().item() <= tol
    assert (got - control).abs().max().item() > tol


@pytest.mark.cuda
def test_v1_mma_tiles_take_a_misaligned_x_and_leave_the_rest_alone(cuda, f32_exact):
    """v1's tiles copy a bf16 x that is not 16-byte aligned before they
    read it; an f32 x at prefill rows, 1-8 rows of a bf16 x (the decode
    tile) and vec-1 weights stay off the prefill tiles (mma_launches
    unchanged), each within its limit; _launch_v1 without mma runs
    v1_kernel on the tiles' inputs."""
    fn = qmatmul.dequant_matmul_v1
    rql = _rql(T.Q4_K, 512, 1024, seed=4, device=cuda, pack=qmatmul.pack_runtime)
    buf = torch.randn(64 * 1024 + 1, generator=torch.Generator().manual_seed(5)).to(cuda)
    x = buf.to(torch.bfloat16)[1:].view(64, 1024)
    assert x.data_ptr() % 16
    m0 = fn.mma_launches
    got = fn(x, rql)
    want = qmatmul.dequant_matmul_v1_reference(x, rql)
    torch.cuda.synchronize()
    assert fn.mma_launches == m0 + 1
    assert (got - want).abs().max().item() <= 1e-5 * _v1_group_terms(x, rql)
    vec1 = _rql(T.Q6_K, 333, 512, seed=6, device=cuda, pack=qmatmul.pack_runtime)
    n0, d0 = fn.launches, fn.decode_mma_launches
    for xx, w in ((x.float(), rql), (x[:8], rql), (x[:40, :512], vec1)):
        got = fn(xx, w)
        want = qmatmul.dequant_matmul_v1_reference(xx, w)
        torch.cuda.synchronize()
        tol = 1e-5 * _v1_group_terms(xx, w) if xx.shape[0] <= 8 else 1e-4 * _terms(xx, w)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=tol)
    y, tile = qmatmul._launch_v1(x, rql, mma=False)
    want = qmatmul.dequant_matmul_v1_reference(x, rql)
    torch.cuda.synchronize()
    assert tile == "cuda_core"
    assert (y - want).abs().max().item() <= 1e-4 * _terms(x, rql)
    assert (fn.launches - n0, fn.mma_launches, fn.decode_mma_launches - d0) == (3, m0 + 1, 1)


@pytest.mark.cuda
def test_v1_mma_tiles_refuse_an_f32_x(cuda, monkeypatch):
    """No fallback: the tensor-core tile code with an f32 x (which the
    tiles would round) is refused by the entry point, and a build failure
    raises; neither counts a launch."""
    rql = _rql(T.Q4_K, 512, 512, seed=7, device=cuda, pack=qmatmul.pack_runtime)
    x = torch.randn(64, 512, device=cuda)
    out = torch.empty(64, 512, device=cuda)
    # tile 1 (tensor cores), 64 rows per block, vec 4, 2 supergroups in 1 split
    rc = qmatmul.c_function("qmatmul_v1", "gg_v1_matmul", qmatmul._V1_ARGS)(
        x.data_ptr(), 0, rql.qs.data_ptr(), rql.scale_t.data_ptr(), rql.offset_t.data_ptr(),
        None, out.data_ptr(), 64, 512, 512, rql.per_byte, rql.group_size, 1, 64, 4, 2, 1,
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0

    def broken(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    fn = qmatmul.dequant_matmul_v1
    n0 = (fn.launches, fn.mma_launches)
    monkeypatch.setattr(qmatmul, "c_function", lambda lib, *a: broken(lib))
    with pytest.raises(RuntimeError, match="nvcc failed for qmatmul_v1"):
        fn(x.to(torch.bfloat16), rql)
    assert (fn.launches, fn.mma_launches) == n0


# v1's tensor-core decode tile (csrc/qmatmul_decode_mma.cuh with V1Mma:
# a bf16 x of DECODE_MMA_MIN_ROWS["v1"] to 8 rows on a vec-4 weight): M =
# 1, 2, 5, 8; d_out 768 and a ragged 1000 (code rows not 16-byte aligned:
# 4-byte copies); the K axis split as the plan does (blocks 4) or not at
# all (blocks 0)
V1_DECODE_CASES = [
    (1, 768, 1024, 4),
    (2, 1000, 512, 0),
    (2, 768, 2048, 4),
    (5, 1000, 2048, 4),
    (5, 768, 512, 0),
    (8, 768, 2048, 4),
    (8, 1000, 1024, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("M,d_out,d_in,blocks", V1_DECODE_CASES)
@pytest.mark.parametrize("qtype", ALL_K, ids=lambda q: q.name)
def test_v1_decode_mma_tile_matches_plain(cuda, f32_exact, monkeypatch, qtype, M, d_out, d_in,
                                          blocks):
    """v1 with a bf16 x at decode rows on its tensor-core decode tile (the
    group dot of raw codes, each k16 slice's partial scaled by its group's
    scale_t, xsum @ offset_t) against its plain version (the JAX kernel's
    f32 function): exact products, f32 sums grouped otherwise, within 1e-5
    of the largest sum of |terms| of an output; the weights rounded to
    bf16 fail that limit. One launch, counted on decode_mma_launches and
    not on mma_launches; a second call is bit-equal."""
    monkeypatch.setattr(qmatmul, "DECODE_MMA_BLOCKS_PER_SM", blocks)
    rql = _rql(qtype, d_out, d_in, seed=M + 17 * d_out + int(qtype), device=cuda,
               pack=qmatmul.pack_runtime)
    fn = qmatmul.dequant_matmul_v1
    x = (torch.randn(M, d_in, generator=torch.Generator().manual_seed(M + d_in)) * 0.5
         ).to(cuda, torch.bfloat16)
    splits = qmatmul._plan(M, d_out, d_in // 256, qmatmul._sm_count(cuda.index or 0), 4,
                           decode_mma=True, decode_min_rows=qmatmul.DECODE_MMA_MIN_ROWS["v1"])[2]
    assert (splits == 1) == (blocks == 0)
    n0, d0, m0 = fn.launches, fn.decode_mma_launches, fn.mma_launches
    got = qmatmul.dequant_matmul(x, rql)
    again = fn(x, rql)
    want = qmatmul.dequant_matmul_v1_reference(x, rql)
    control = _v1_bf16_weights(x, rql)
    torch.cuda.synchronize()
    assert (fn.launches - n0, fn.decode_mma_launches - d0, fn.mma_launches - m0) == (2, 2, 0)
    assert got.shape == want.shape == (M, d_out) and got.dtype == torch.float32
    assert torch.equal(got, again)
    tol = 1e-5 * _v1_group_terms(x, rql)
    assert (got - want).abs().max().item() <= tol
    assert (got - control).abs().max().item() > tol


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", [T.Q4_K, T.Q6_K], ids=lambda q: q.name)
def test_v1_decode_mma_tile_takes_a_misaligned_x_and_leaves_the_rest_alone(cuda, f32_exact,
                                                                           qtype):
    """v1's decode tile copies a bf16 x that is not 16-byte aligned before
    it reads it; an f32 x at 1-8 rows (which the tile would round) and
    vec-1 weights stay on v1_kernel (decode_mma_launches unchanged), each
    within its limit; _launch_v1 with neither tile runs v1_kernel on the
    tile's inputs and names it."""
    fn = qmatmul.dequant_matmul_v1
    rql = _rql(qtype, 512, 1024, seed=9 + int(qtype), device=cuda, pack=qmatmul.pack_runtime)
    buf = torch.randn(8 * 1024 + 1, generator=torch.Generator().manual_seed(6)).to(cuda)
    x = buf.to(torch.bfloat16)[1:].view(8, 1024)
    assert x.data_ptr() % 16
    n0, d0, m0 = fn.launches, fn.decode_mma_launches, fn.mma_launches
    got = fn(x, rql)
    want = qmatmul.dequant_matmul_v1_reference(x, rql)
    torch.cuda.synchronize()
    assert fn.decode_mma_launches == d0 + 1
    assert (got - want).abs().max().item() <= 1e-5 * _v1_group_terms(x, rql)
    vec1 = _rql(qtype, 333, 512, seed=10, device=cuda, pack=qmatmul.pack_runtime)
    for xx, w in ((x.float(), rql), (x[:5].float(), rql), (x[:8, :512], vec1)):
        got = fn(xx, w)
        want = qmatmul.dequant_matmul_v1_reference(xx, w)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                                   atol=1e-4 * _terms(xx, w))
    y, tile = qmatmul._launch_v1(x, rql, mma=False, decode_mma=False)
    want = qmatmul.dequant_matmul_v1_reference(x, rql)
    torch.cuda.synchronize()
    assert tile == "cuda_core"
    assert (y - want).abs().max().item() <= 1e-4 * _terms(x, rql)
    assert (fn.launches - n0, fn.decode_mma_launches - d0, fn.mma_launches - m0) == (4, 1, 0)


# v2p's tensor-core decode tile (csrc/qmatmul_decode_mma.cuh with
# GroupDotMma at gs 16): every M of 1-8; d_out 768, a ragged 1000 (4-byte
# copies) and 4096; x in f32 (rounded while staged) and bf16; the K axis
# split as the plan does (blocks 4) or not at all (blocks 0)
V2P_DECODE_CASES = [
    (1, 768, 1024, torch.bfloat16, 4),
    (2, 1000, 512, torch.float32, 0),
    (3, 768, 2048, torch.bfloat16, 4),
    (4, 4096, 1024, torch.bfloat16, 4),
    (5, 1000, 2048, torch.bfloat16, 4),
    (6, 768, 512, torch.float32, 4),
    (7, 768, 1024, torch.bfloat16, 0),
    (8, 1000, 1024, torch.bfloat16, 4),
    (8, 4096, 512, torch.float32, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("M,d_out,d_in,dtype,blocks", V2P_DECODE_CASES)
@pytest.mark.parametrize("qtype", [T.Q2_K, T.Q3_K, T.Q6_K], ids=lambda q: q.name)
def test_v2p_decode_mma_tile_matches_plain(cuda, f32_exact, monkeypatch, qtype, M, d_out, d_in,
                                           dtype, blocks):
    """v2p with bf16 operands at 1-8 rows on the group-dot form of the
    decode tile (every row count: its DECODE_MMA_MIN_ROWS lowered here)
    against its plain version, within 1e-5 of the largest sum of |terms| of
    an output (exact products of raw codes, partials scaled in f32, the
    sums in another order); v2g's rounding, bf16(scale * q), fails that
    limit. One launch, counted on decode_mma_launches and not on
    mma_launches; a second call is bit-equal."""
    monkeypatch.setattr(qmatmul, "DECODE_MMA_BLOCKS_PER_SM", blocks)
    monkeypatch.setitem(qmatmul.DECODE_MMA_MIN_ROWS, "v2p", 1)
    fn = qmatmul.dequant_matmul_v2p
    rql = _rql(qtype, d_out, d_in, seed=M + 17 * d_out + int(qtype), device=cuda)
    x = (torch.randn(M, d_in, generator=torch.Generator().manual_seed(M + d_in)) * 0.5
         ).to(cuda, dtype)
    splits = qmatmul._plan(M, d_out, d_in // 256, qmatmul._sm_count(cuda.index or 0), 4,
                           *qmatmul._v2_route("v2p", torch.bfloat16))[2]
    assert (splits == 1) == (blocks == 0)
    n0, d0, m0 = fn.launches, fn.decode_mma_launches, fn.mma_launches
    got = fn(x, rql)
    again = fn(x, rql)
    want = qmatmul.dequant_matmul_v2m_reference(x, rql)
    control = qmatmul.dequant_matmul_v2g_reference(x, rql)
    torch.cuda.synchronize()
    assert (fn.launches - n0, fn.decode_mma_launches - d0, fn.mma_launches - m0) == (2, 2, 0)
    assert got.shape == want.shape == (M, d_out) and got.dtype == torch.float32
    assert torch.equal(got, again)
    tol = 1e-5 * _v2_terms(x, rql, torch.bfloat16)
    assert (got - want).abs().max().item() <= tol
    assert (got - control).abs().max().item() > tol


@pytest.mark.cuda
def test_v2p_decode_mma_tile_takes_a_misaligned_x_and_leaves_the_rest_alone(cuda, monkeypatch):
    """v2p's decode tile copies an x that is not 16-byte aligned; f32
    operands, vec-1 weights and fewer rows than its DECODE_MMA_MIN_ROWS
    stay on the CUDA-core tiles (decode_mma_launches unchanged); at gs 32
    v2t and v2m run their own decode tiles at 8 rows."""
    monkeypatch.setitem(qmatmul.DECODE_MMA_MIN_ROWS, "v2p", 2)
    fn = qmatmul.dequant_matmul_v2p
    q6 = _rql(T.Q6_K, 512, 512, seed=12, device=cuda)
    buf = torch.randn(8 * 512 + 1, device=cuda).to(torch.bfloat16)
    x = buf[1:].view(8, 512)
    assert x.data_ptr() % 16
    d0 = fn.decode_mma_launches
    got = fn(x, q6)
    want = qmatmul.dequant_matmul_v2m_reference(x, q6)
    torch.cuda.synchronize()
    assert fn.decode_mma_launches == d0 + 1
    assert (got - want).abs().max().item() <= 1e-5 * _v2_terms(x, q6, torch.bfloat16)
    fn(x, q6, torch.float32)
    fn(x[:1], q6)
    fn(x, _rql(T.Q6_K, 333, 512, seed=13, device=cuda))
    q4 = _rql(T.Q4_K, 512, 512, seed=14, device=cuda)
    n0 = {v: V2_WRAPPERS[v].launches for v in ("v2m", "v2t")}
    t0 = {v: V2_WRAPPERS[v].decode_mma_launches for v in n0}
    qmatmul.dequant_matmul_v2m(x, q4)
    qmatmul.dequant_matmul_v2t(x, q4)
    torch.cuda.synchronize()
    assert fn.decode_mma_launches == d0 + 1
    assert {v: V2_WRAPPERS[v].launches - n0[v] for v in n0} == {"v2m": 1, "v2t": 1}
    assert {v: V2_WRAPPERS[v].decode_mma_launches - t0[v] for v in n0} == {"v2m": 1, "v2t": 1}


# the decode tiles of v2h (V2Mma<kV2h>, all five K-quants: DECODE_MMA_CASES),
# v2t (GroupSumMma, Q4_K / Q5_K: V2P_DECODE_CASES), v2m (GroupDotMma at gs
# 32, Q4_K / Q5_K), v2s (V2Mma<kV2s>, split halves: Q4_K / Q2_K / Q3_K), v3
# (V2Mma<kV3>, packed bf16 weights and the xsum term) and v2 (V2Mma<kV2>,
# its FMA forms), the last two at all five K-quants, each with the planted
# control its limit must reject: v2h against v2f's f32 affine (bf16(scale *
# q - off2), one rounding), v2t, v2m and v2 against v2g's rounding
# (bf16(scale * q), the offset out of the weight), v2s and v3 against the
# unrounded scale * q (the group-dot plain version)
V2H_V2T_DECODE = [*[("v2h", q, *c) for q in ALL_K for c in DECODE_MMA_CASES],
                  *[("v2t", q, *c) for q in (T.Q4_K, T.Q5_K) for c in V2P_DECODE_CASES],
                  *[("v2m", q, *c) for q in (T.Q4_K, T.Q5_K) for c in V2P_DECODE_CASES],
                  *[("v2s", q, *c) for q in (T.Q4_K, T.Q2_K, T.Q3_K) for c in DECODE_MMA_CASES],
                  *[(v, q, *c) for v in ("v3", "v2", "v2f") for q in ALL_K
                    for c in DECODE_MMA_CASES]]
DECODE_CONTROL = {"v2h": lambda x, rql: qmatmul.dequant_matmul_v2w_reference(
                      x, rql, torch.bfloat16, "v2f"),
                  "v2t": qmatmul.dequant_matmul_v2g_reference,
                  "v2m": qmatmul.dequant_matmul_v2g_reference,
                  "v2s": qmatmul.dequant_matmul_v2m_reference,
                  "v3": qmatmul.dequant_matmul_v2m_reference,
                  "v2": qmatmul.dequant_matmul_v2g_reference,
                  "v2f": qmatmul.dequant_matmul_v2g_reference}


@pytest.mark.cuda
@pytest.mark.parametrize("variant,qtype,M,d_out,d_in,dtype,blocks", V2H_V2T_DECODE,
                         ids=lambda a: getattr(a, "name", str(a)))
def test_v2h_v2t_decode_mma_tiles_match_plain(cuda, f32_exact, monkeypatch, variant, qtype, M,
                                             d_out, d_in, dtype, blocks):
    """v2h, v2t, v2m, v2s, v3, v2 and v2f with bf16 operands at 1-8 rows on
    their decode tiles (every row count: their DECODE_MMA_MIN_ROWS lowered
    here) against their plain versions, within 1e-5 of the largest sum of
    |terms| of an output (v2h, v3, v2, v2f: their bf16 weights bit for bit
    (v2f's from v2's FMA forms), f32 sums in another order, v3 with the
    xsum term;
    v2t: exact products of raw codes, each step's scaled slice partials
    summed before the accumulator; v2m: each slice partial scaled into the
    accumulator; v2s: v2g's bf16 weights, each step's high-nibble slice
    summed apart); the planted control fails that limit. One launch,
    counted on decode_mma_launches and not on mma_launches; a second call
    is bit-equal."""
    monkeypatch.setattr(qmatmul, "DECODE_MMA_BLOCKS_PER_SM", blocks)
    monkeypatch.setitem(qmatmul.DECODE_MMA_MIN_ROWS, variant, 1)
    fn, ref, _ = V2_VARIANTS[variant]
    rql = _rql(qtype, d_out, d_in, seed=M + 19 * d_out + int(qtype), device=cuda)
    x = (torch.randn(M, d_in, generator=torch.Generator().manual_seed(M + d_in)) * 0.5
         ).to(cuda, dtype)
    splits = qmatmul._plan(M, d_out, d_in // 256, qmatmul._sm_count(cuda.index or 0), 4,
                           *qmatmul._v2_route(variant, torch.bfloat16))[2]
    assert (splits == 1) == (blocks == 0)
    n0, d0, m0 = fn.launches, fn.decode_mma_launches, fn.mma_launches
    got = fn(x, rql)
    again = fn(x, rql)
    want = ref(x, rql, torch.bfloat16)
    control = DECODE_CONTROL[variant](x, rql)
    torch.cuda.synchronize()
    assert (fn.launches - n0, fn.decode_mma_launches - d0, fn.mma_launches - m0) == (2, 2, 0)
    assert got.shape == want.shape == (M, d_out) and got.dtype == torch.float32
    assert torch.equal(got, again)
    tol = 1e-5 * _v2_terms(x, rql, torch.bfloat16)
    assert (got - want).abs().max().item() <= tol
    assert (got - control).abs().max().item() > tol


def _v2h_edge_planes(device):
    """A Q4_K weight (256 x 512) planted for v2h's two roundings: per
    column a super-min 2^-31..2^31 times its super-scale, so bf16(s * q)
    and bf16(off2) lie up to ~40 binades apart, and 6-bit scales, mins
    and codes drawn at random, which give ties in both roundings
    (test_torch_v2_weight_variants.py counts both)."""
    rng = np.random.default_rng(33)
    d_out = 512
    d = (2.0 ** rng.integers(-20, -4, d_out) * rng.uniform(1, 2, d_out)).astype(np.float32)
    dmin = (d * 2.0 ** rng.integers(-31, 32, d_out) * rng.uniform(1, 2, d_out)).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return qmatmul.RuntimeQuantLinearV2(
        t(rng.integers(0, 256, (128, d_out)).astype(np.uint8)), t(np.stack([d, d])),
        t(np.stack([dmin, dmin])), t(rng.integers(1, 64, (8, d_out)).astype(np.uint8)),
        t(rng.integers(0, 64, (8, d_out)).astype(np.uint8)), 256, 32, 2, 0, 2)


@pytest.mark.cuda
def test_v2h_decode_mma_tile_weights_bit_equal(cuda, monkeypatch):
    """Through unit rows of x (v2h has no xsum term) the decode tile
    returns its bf16 weights, which it forms in packed bf16 arithmetic:
    every one equal to the plain version's T(T(T(scale) * q) - T(off2)),
    rounded in f32, on the planted planes (exponent gaps past 16 binades
    and ties in both roundings) and on Q3_K and Q6_K layers."""
    monkeypatch.setitem(qmatmul.DECODE_MMA_MIN_ROWS, "v2h", 1)
    fn = qmatmul.dequant_matmul_v2h
    for rql in (_v2h_edge_planes(cuda), _rql(T.Q3_K, 512, 512, seed=23, device=cuda),
                _rql(T.Q6_K, 512, 512, seed=24, device=cuda)):
        d_in = rql.d_in_local
        w = qmatmul._v2_operand(rql, "v2h", torch.bfloat16)[0]
        eye = torch.eye(d_in, device=cuda, dtype=torch.bfloat16)
        d0 = fn.decode_mma_launches
        got = torch.cat([fn(eye[k:k + 8], rql) for k in range(0, d_in, 8)])
        torch.cuda.synchronize()
        assert fn.decode_mma_launches == d0 + d_in // 8
        assert torch.equal(got, w)


def _edge_planes(qtype, device, off: bool = True):
    """A 512 x 512 weight of ``qtype`` planted at its extremes, for the
    decode tiles' weight arithmetic (v3's packed bf16 FMA, v2's FMA forms):
    f16 super-scales (and super-mins) over their range, 2^-24 to 65504,
    group scales (int8 for Q6_K: -128..127) and codes over their whole
    ranges; column 0 holds the largest super-scale, the largest scale
    magnitudes (both signs for the signed types) and codes alternating
    between 0 and the largest. ``off`` False leaves off2 zero (mins of 0,
    shift 0), so unit rows of x return v3's weights with its xsum term."""
    rng = np.random.default_rng(34 + int(qtype))
    spec = KQUANT_SPECS[qtype]
    d_in = d_out = 512
    n_sg, ng, gs = d_in // 256, d_in // spec.group_size, spec.group_size
    per_byte = 2 if spec.bits <= 4 else 1
    q_hi = spec.qmax - spec.qmin
    lo, hi = ((-128, 127) if qtype == T.Q6_K else (-32, 31)) if spec.signed else (0, spec.scale_maxq)

    def super_scale():
        v = 2.0 ** rng.integers(-24, 16, (n_sg, d_out)) * rng.uniform(1, 2, (n_sg, d_out))
        v = np.minimum(v, 65504).astype(np.float16).astype(np.float32)
        v[:, 0] = 65504
        return np.repeat(v, 2, axis=0)  # d_rep 2

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)

    sc = rng.integers(lo, hi + 1, (ng, d_out))
    sc[:, 0] = np.where(np.arange(ng) % 2, lo, hi) if spec.signed else hi
    codes = rng.integers(0, q_hi + 1, (d_in, d_out))
    codes[:, 0] = np.where(np.arange(d_in) % 2, q_hi, 0)
    qs = qmatmul._nibble_pack(codes) if per_byte == 2 else codes
    mn = dmin = None
    if not spec.signed:
        mn = rng.integers(0, spec.scale_maxq + 1, (ng, d_out)) * off
        mn[:, 0] = spec.scale_maxq * off
        dmin = super_scale()
    return qmatmul.RuntimeQuantLinearV2(
        t(qs.astype(np.uint8)), t(super_scale()), t(dmin),
        t(sc.astype(np.int8 if spec.signed else np.uint8)),
        t(None if mn is None else mn.astype(np.uint8)), d_in, gs, per_byte,
        -spec.qmin if off else 0, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", ALL_K, ids=lambda q: q.name)
@pytest.mark.parametrize("variant", ["v3", "v2", "v2f"])
def test_v3_v2_decode_mma_tile_weights_bit_equal(cuda, monkeypatch, variant, qtype):
    """Through unit rows of x the v3, v2 and v2f decode tiles return their
    bf16 weights, on the planted planes of _edge_planes: v3's from one
    bf16x2 FMA per pair (its off2 left zero here, so the xsum term
    subtracts nothing), v2's and v2f's from one f32 FMA per weight and a
    subtraction of the offset; each equal to the plain version's
    T(T(scale) * q), T(scale * (q - shift) - off) and T(scale * q - off2),
    rounded in f32 (v3's from the planes with their offsets, which its
    weights do not depend on)."""
    monkeypatch.setitem(qmatmul.DECODE_MMA_MIN_ROWS, variant, 1)
    fn = V2_WRAPPERS[variant]
    rql = _edge_planes(qtype, cuda, off=variant != "v3")
    w = qmatmul._v2_operand(_edge_planes(qtype, cuda), variant, torch.bfloat16)[0]
    eye = torch.eye(512, device=cuda, dtype=torch.bfloat16)
    d0 = fn.decode_mma_launches
    got = torch.cat([fn(eye[k:k + 8], rql) for k in range(0, 512, 8)])
    torch.cuda.synchronize()
    assert fn.decode_mma_launches == d0 + 64
    assert torch.equal(got, w)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["v3", "v2", "v2f"])
def test_v3_v2_decode_mma_tile_failures_raise(cuda, monkeypatch, variant):
    """No fallback: the decode tile's code with f32 operands, which the
    source does not instantiate, raises; a build failure of the library
    raises and counts nothing."""
    rql = _rql(T.Q6_K, 512, 512, seed=6, device=cuda)
    x = torch.randn(8, 512, device=cuda).to(torch.bfloat16)
    lib, code = qmatmul._PER_WEIGHT[variant]
    with pytest.raises(RuntimeError, match="launch failed"):
        qmatmul._launch_v2(lib, code, x, rql, torch.float32,
                           *qmatmul._v2_route(variant, torch.bfloat16))
    fn = V2_WRAPPERS[variant]

    def broken(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(qmatmul, "c_function", lambda lib, *a: broken(lib))
    n0, d0 = fn.launches, fn.decode_mma_launches
    with pytest.raises(RuntimeError, match=f"nvcc failed for {lib}"):
        fn(x, rql)
    assert (fn.launches, fn.decode_mma_launches) == (n0, d0)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,qtype", [("v2h", T.Q4_K), ("v2h", T.Q6_K), ("v2t", T.Q4_K),
                                           ("v2t", T.Q5_K), ("v2m", T.Q4_K), ("v2m", T.Q5_K),
                                           ("v2s", T.Q4_K), ("v2s", T.Q3_K), ("v3", T.Q4_K),
                                           ("v3", T.Q6_K), ("v2", T.Q4_K), ("v2", T.Q6_K),
                                           ("v2f", T.Q4_K), ("v2f", T.Q3_K)],
                         ids=lambda a: getattr(a, "name", a))
def test_v2h_v2t_decode_mma_tiles_take_a_misaligned_x_and_leave_the_rest_alone(
        cuda, monkeypatch, variant, qtype):
    """The v2h, v2t, v2m, v2s, v3, v2 and v2f decode tiles copy an x that is
    not 16-byte aligned;
    f32 operands, vec-1 weights and fewer rows than the variant's
    DECODE_MMA_MIN_ROWS stay on the CUDA-core tiles (decode_mma_launches
    unchanged, no mma_launches)."""
    monkeypatch.setitem(qmatmul.DECODE_MMA_MIN_ROWS, variant, 2)
    fn, ref, _ = V2_VARIANTS[variant]
    rql = _rql(qtype, 512, 512, seed=21 + int(qtype), device=cuda)
    buf = torch.randn(8 * 512 + 1, device=cuda).to(torch.bfloat16)
    x = buf[1:].view(8, 512)
    assert x.data_ptr() % 16
    n0, d0, m0 = fn.launches, fn.decode_mma_launches, fn.mma_launches
    got = fn(x, rql)
    want = ref(x, rql, torch.bfloat16)
    torch.cuda.synchronize()
    assert fn.decode_mma_launches == d0 + 1
    assert (got - want).abs().max().item() <= 1e-5 * _v2_terms(x, rql, torch.bfloat16)
    fn(x, rql, torch.float32)
    fn(x[:1], rql)
    fn(x, _rql(qtype, 333, 512, seed=22 + int(qtype), device=cuda))
    torch.cuda.synchronize()
    assert (fn.launches - n0, fn.decode_mma_launches - d0, fn.mma_launches - m0) == (4, 1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d_out,d_in,qtype", [(512, 3584, T.Q4_K), (3584, 18944, T.Q4_K),
                                              (151936, 4096, T.Q6_K), (151936, 3584, T.Q4_K)],
                         ids=["kv_3584", "down_18944", "qwen3_head", "qwen2_head"])
def test_v2g_at_the_qwen_family_shapes(cuda, d_out, d_in, qtype):
    """v2g against its plain version at the shapes the qwen families bring:
    Qwen2.5-7B's k / v projections (d_out 512 over d_in 3584 = 14 x 256, no
    multiple of 512), its down projection (d_in 18944) and the heads of
    151936 rows padded to 152064 as the serving loader pads them. M = 1
    runs the CUDA-core tile (within 1e-4 of the largest sum of |terms|),
    M = 8 the tensor-core decode tile (1e-5), M = 128 the tensor-core
    prefill tiles (1e-4: chip_smoke's PREFILL_TILE_LIMIT)."""
    rql = _rql(qtype, d_out, d_in, seed=d_out + d_in, device=cuda)
    if d_out % 512:
        rql = qmatmul.pad_dout_v2(rql)
        assert rql.d_out == 152064
    fn = qmatmul.dequant_matmul_v2g
    gen = torch.Generator().manual_seed(d_in)
    for M, tile, limit in ((1, "core", 1e-4), (8, "decode", 1e-5), (128, "mma", 1e-4)):
        x = torch.randn(M, d_in, generator=gen).to(cuda, torch.bfloat16)
        n0, d0, m0 = fn.launches, fn.decode_mma_launches, fn.mma_launches
        got = fn(x, rql)
        want = qmatmul.dequant_matmul_v2g_reference(x, rql)
        torch.cuda.synchronize()
        ran = (fn.launches - n0, fn.decode_mma_launches - d0, fn.mma_launches - m0)
        assert ran == {"core": (1, 0, 0), "decode": (1, 1, 0), "mma": (1, 0, 1)}[tile], M
        assert got.shape == (M, rql.d_out) and bool(torch.isfinite(got).all())
        err = (got - want).abs().max().item()
        assert err <= limit * _v2_terms(x, rql, torch.bfloat16), (M, err)
        if d_out % 512:
            assert got[:, d_out:].abs().max().item() == 0  # the pad rows give exact zeros


@pytest.mark.cuda
def test_stacked_ladders_on_the_card_match_the_cpu(cuda):
    """The FastOBQ / FastOBC ladders (``ops/sparse_gptq.py``, plain torch:
    every level's rows in one column loop) on the card against the same
    ladders on the CPU, at 512 x 1024 with a correlated Hessian. Every
    elementwise step is IEEE and the rank-1 updates are rounded once in
    both, but the factorization and the trailing products sum in another
    order: codes and masks equal on at least 99.9% of entries, each
    level's relative error within 1e-3 of the CPU's."""
    from gptq_gguf_tpu_torch.ops import sparse_gptq

    rng = np.random.default_rng(25)
    d_row, d_col = 512, 1024
    W = torch.from_numpy((rng.normal(size=(d_row, d_col)) * 0.02).astype(np.float32))
    A = rng.normal(size=(d_col, d_col)).astype(np.float32) / np.sqrt(d_col)
    A += 0.5 * np.eye(d_col, dtype=np.float32)
    X = rng.normal(size=(4096, d_col)).astype(np.float32) @ A
    H = torch.from_numpy((2.0 * X.T @ X / 4096).astype(np.float32))
    bits = (2, 3, 4, 5, 6, 8)
    cpu = sparse_gptq.fast_obq_quantize(W, H, bits)
    card = sparse_gptq.fast_obq_quantize(W.to(cuda), H.to(cuda), bits)
    for b in bits:
        assert card[b][0].device.type == "cuda"
        agree = (card[b][0].cpu() == cpu[b][0]).float().mean()
        e_card = float(sparse_gptq.relative_layer_error(W, card[b][2].cpu(), H))
        e_cpu = float(sparse_gptq.relative_layer_error(W, cpu[b][2], H))
        assert agree >= 0.999 and abs(e_card - e_cpu) <= 1e-3 * e_cpu, (b, agree, e_card, e_cpu)
    sparsities = (0.4375, 0.5, 0.5625)
    cpu_w = sparse_gptq.fast_obc_prune(W, H, sparsities)
    card_w = sparse_gptq.fast_obc_prune(W.to(cuda), H.to(cuda), sparsities)
    for s, a, b in zip(sparsities, card_w, cpu_w):
        a = a.cpu()
        assert ((a == 0) == (b == 0)).float().mean() >= 0.999, s
        assert abs(float((a == 0).float().mean()) - s) < 1e-3
