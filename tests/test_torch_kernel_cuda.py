"""The CUDA kernels (v2g, v1 and v4 dequant-matmul, the v2 variants v2 /
v3 / v2f / v2h / v2s / v2m / v2t / v2p, the tensor-core prefill tiles of
the per-weight variants and of v4, GPTQ column-block solve, paged
flash-decode over bf16 / f32 and int4 pools) against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one. The file imports neither JAX nor the JAX package, so on
a card host it runs without them:

    python -m pytest tests/test_torch_kernel_cuda.py --noconftest -q

Tolerances: v2g and its plain version compute the same bf16 products and
differ only in the order of the f32 sums: atol 1e-4 of max|y|. The v1
(f32) and v4 (bf16 products) kernels likewise: atol 1e-4 of the largest
sum of |terms| of one output (1e-5 on v4's tensor-core tiles), and so do
the v2 variant kernels in either operand type. The GPTQ solve repeats its plain version's
IEEE f32 operations in the same order: codes and errors equal bit for bit. The paged decode kernels and their
plain versions sum the same f32 terms in another order (and take exp and
tanh from other libraries): atol 1e-4 of max|out|."""

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
    A = rng.normal(size=(bs, 4 * bs))
    Hm = torch.from_numpy(A @ A.T / (4 * bs) + 0.1 * np.eye(bs))
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
                                      (20000, 128), (33, 64)])
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
    w2, U2, s2, z2 = _solve_inputs(8, 512, T.Q4_K, 2, cuda)
    with pytest.raises(ValueError, match="at most 256"):
        gptq.solve_block(w2, U2, s2, z2, 0, 15, 1e-9)
    with pytest.raises(ValueError, match="u:"):
        gptq.solve_block(w, U.double(), s, z, 0, 15, 1e-9)
    with pytest.raises(ValueError, match="s:"):
        gptq.solve_block(w, U, s.T.contiguous().T, z, 0, 15, 1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("qtype,kw", [(T.Q4_K, {}), (T.Q6_K, {"act_order": True,
                                                               "static_groups": True})])
def test_gptq_quantize_matrix_kernel_equals_plain_on_card(cuda, qtype, kw, monkeypatch):
    rng = np.random.default_rng(3)
    W = (rng.normal(size=(96, 512)) * 0.08).astype(np.float32)
    X = rng.normal(size=(2048, 512)).astype(np.float32) @ (
        rng.normal(size=(512, 512)).astype(np.float32) / 23 + np.eye(512, dtype=np.float32))
    H = 2 * X.T @ X / 2048
    n0 = gptq.solve_block.launches
    got = gptq.gptq_quantize_matrix(W, H, qtype, gptq.GPTQConfig(**kw))
    assert gptq.solve_block.launches - n0 == 4  # 512 columns in blocks of 128
    monkeypatch.setattr(gptq, "solve_block", gptq.solve_block_reference)
    want = gptq.gptq_quantize_matrix(W, H, qtype, gptq.GPTQConfig(**kw))
    assert torch.equal(got.qweight, want.qweight)
    for a, b in zip(got.params, want.params):
        assert torch.equal(a, b)


def _paged_inputs(B, nKV, G, hd, page, pps, mode, seed, device):
    """q, the pools (bf16 / f32, or combined int4), a scrambled table with
    -1 past each slot's live pages, and lengths from 0 to the table's end."""
    gen = torch.Generator().manual_seed(seed)
    n_pages = B * pps
    lengths = torch.linspace(0, pps * page - 1, B).to(torch.int32)
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


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "f32", "q4"])
@pytest.mark.parametrize("B,nKV,G,hd,page,pps,kw", [
    (8, 8, 4, 128, 64, 32, {}),                                  # Llama-3-8B decode
    (3, 2, 8, 64, 16, 9, {"window": 20}),                         # window page skip
    (2, 1, 16, 256, 40, 5, {"softcap": 30.0, "sinks": True}),    # ragged 32-chunks
    (5, 4, 1, 192, 256, 3, {"sinks": True, "window": 300}),
])
def test_paged_decode_kernel_matches_plain(cuda, mode, B, nKV, G, hd, page, pps, kw):
    q, k, v, table, lengths = _paged_inputs(B, nKV, G, hd, page, pps, mode, B * hd + page, cuda)
    kw = dict(kw, scale=hd ** -0.5)
    if kw.pop("sinks", False):
        kw["sinks"] = torch.randn(nKV * G, generator=torch.Generator().manual_seed(1)).to(cuda)
    fn, ref = ((pa.paged_flash_decode_q4, pa.paged_flash_decode_q4_reference) if mode == "q4"
               else (pa.paged_flash_decode, pa.paged_flash_decode_reference))
    n0 = fn.launches
    got = fn(q, k, v, table, lengths, **kw)
    want = ref(q, k, v, table, lengths, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert got.shape == want.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())


@pytest.mark.cuda
def test_paged_decode_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, table, lengths = _paged_inputs(2, 2, 4, 128, 16, 4, "bf16", 3, cuda)
    kw = dict(scale=0.1)
    with pytest.raises(ValueError, match="multiple of 64"):
        pa.paged_flash_decode(q[..., :96].contiguous(), k[..., :96].contiguous(),
                              v[..., :96].contiguous(), table, lengths, **kw)
    with pytest.raises(ValueError, match="query heads"):
        pa.paged_flash_decode(q.repeat(1, 1, 5, 1), k, v, table, lengths, **kw)
    with pytest.raises(ValueError, match="table"):
        pa.paged_flash_decode(q, k, v, table.long(), lengths, **kw)
    with pytest.raises(ValueError, match="pools must be bf16 or f32"):
        pa.paged_flash_decode(q, k.half(), v.half(), table, lengths, **kw)


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
@pytest.mark.parametrize("qtype", ALL_K, ids=lambda q: q.name)
@pytest.mark.parametrize("variant", qmatmul.MMA_VARIANTS)
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
def test_mma_tiles_take_a_misaligned_x_and_leave_f32_and_v2s_alone(cuda):
    """An x whose data is not 16-byte aligned is copied before the
    tensor-core tiles read it; f32 operands and v2s stay on the CUDA-core
    tiles at prefill rows."""
    rql = _rql(T.Q4_K, 512, 512, seed=4, device=cuda)
    buf = torch.randn(64 * 512 + 1, device=cuda).to(torch.bfloat16)
    x = buf[1:].view(64, 512)
    assert x.data_ptr() % 16
    m0 = qmatmul.dequant_matmul_v2g.mma_launches
    got = qmatmul.dequant_matmul_v2g(x, rql)
    want = qmatmul.dequant_matmul_v2g_reference(x, rql)
    torch.cuda.synchronize()
    assert qmatmul.dequant_matmul_v2g.mma_launches == m0 + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                               atol=1e-4 * _v2_terms(x, rql, torch.bfloat16))
    counts = {v: V2_WRAPPERS[v].mma_launches for v in qmatmul.MMA_VARIANTS}
    n_s = qmatmul.dequant_matmul_v2s.launches
    for v in qmatmul.MMA_VARIANTS:
        V2_WRAPPERS[v](x, rql, torch.float32)
    qmatmul.dequant_matmul_v2s(x, rql, torch.bfloat16)
    torch.cuda.synchronize()
    assert {v: V2_WRAPPERS[v].mma_launches for v in qmatmul.MMA_VARIANTS} == counts
    assert qmatmul.dequant_matmul_v2s.launches == n_s + 1


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
