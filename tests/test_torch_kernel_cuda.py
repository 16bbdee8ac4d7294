"""The v2g CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one. The file imports neither JAX nor the JAX package, so on
a card host it runs without them:

    python -m pytest tests/test_torch_kernel_cuda.py --noconftest -q

Tolerance: kernel and plain version compute the same bf16 products and
differ only in the order of the f32 sums: atol 1e-4 of max|y|."""

import numpy as np
import pytest
import torch

from gptq_gguf_tpu_torch.formats.ggml import KQUANT_SPECS, GGMLQuantizationType as T
from gptq_gguf_tpu_torch.models.llama import LlamaConfig
from gptq_gguf_tpu_torch.ops import qmatmul
from gptq_gguf_tpu_torch.ops.kquant import SuperGroupParams
from gptq_gguf_tpu_torch.serving import model as qmodel

ALL_K = [T.Q2_K, T.Q3_K, T.Q4_K, T.Q5_K, T.Q6_K]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the v2g CUDA kernel has no CPU mode")
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
