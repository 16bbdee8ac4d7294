"""The CUDA kernels (v2g dequant-matmul, GPTQ column-block solve, paged
flash-decode over bf16 / f32 and int4 pools) against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one. The file imports neither JAX nor the JAX package, so on
a card host it runs without them:

    python -m pytest tests/test_torch_kernel_cuda.py --noconftest -q

Tolerances: v2g and its plain version compute the same bf16 products and
differ only in the order of the f32 sums: atol 1e-4 of max|y|. The GPTQ
solve repeats its plain version's IEEE f32 operations in the same order:
codes and errors equal bit for bit. The paged decode kernels and their
plain versions sum the same f32 terms in another order (and take exp and
tanh from other libraries): atol 1e-4 of max|out|."""

import numpy as np
import pytest
import torch

from gptq_gguf_tpu_torch.formats.ggml import KQUANT_SPECS, GGMLQuantizationType as T
from gptq_gguf_tpu_torch.models.llama import LlamaConfig
from gptq_gguf_tpu_torch.ops import gptq, paged_attention as pa, qmatmul
from gptq_gguf_tpu_torch.ops.kquant import SuperGroupParams
from gptq_gguf_tpu_torch.serving import model as qmodel

ALL_K = [T.Q2_K, T.Q3_K, T.Q4_K, T.Q5_K, T.Q6_K]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rql(qtype, d_out, d_in, seed, device):
    """Random codes and scales (weights of std ~ 1/sqrt(d_in))."""
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
    return qmatmul.pack_runtime_v2(q, SuperGroupParams(ss, ss, sc, zq), qtype, device=device)


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
    (40, 768, 512, torch.float32),    # 32-row prefill tiles, ragged last tile
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
        rows, step = [], ids.to(dev)
        for _ in range(3):
            logits, cache = qmodel.forward_cached(p, cfg, step, cache)
            rows.append(logits.cpu())
            step = ids[:, :1].to(dev)  # the same tokens on both devices
        out[dev.type] = torch.stack(rows)
        if dev.type == "cuda":
            assert qmatmul.dequant_matmul_v2g.launches - n0 == 3 * (4 * 2 + 1)
    want = out["cpu"]
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
