"""The phi3 family through the port's pipeline, against the JAX package (and
HF transformers) on the CPU.

The model is a tiny HF phi3 built from its config by transformers: 2 layers,
hidden 768, intermediate 512, 8 heads of 96 (Phi-3-mini's head width, which
the paged decode kernel takes since this family), 4 KV heads, vocab 320,
longrope with ``original_max_position_embeddings`` 32 of 128 and 48 long /
short factors drawn from a seed, saved as f32 safetensors with a BPE
tokenizer. Its checkpoint holds the fused ``qkv_proj`` / ``gate_up_proj``;
the walk quantizes the split projections and ``pack`` fuses them again.

Longrope switches factors past 32 positions: the dense forward on the
sequence length, serving on the cache's capacity; each side of the switch
is held against JAX (and the dense one against HF), and the switch changes
the result.

Tolerances are those of tests/torch_family_checks.py: the block and its
captures within 1e-5, the model's logits within 2e-4 of HF's and JAX's, the
GPTQ objective within 2% of JAX's walk, RTN artifacts and every GGUF byte
for byte, served logits within LOGIT_TOL with greedy tokens equal, the
paged forward within LOGIT_TOL of the contiguous one, perplexity within
1e-4.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptq_gguf_tpu.models import llama as jl
from gptq_gguf_tpu.models import loader as jloader
from gptq_gguf_tpu.ops import qmatmul as jq
from gptq_gguf_tpu.serving import model as jmodel
from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
from gptq_gguf_tpu_torch.models import llama, loader
from gptq_gguf_tpu_torch.ops import paged_attention as pa
from gptq_gguf_tpu_torch.serving import model as qmodel
from tests import torch_family_checks as fc

V = 320
HD = 96
_rng = np.random.default_rng(96)
HF = dict(hidden_size=768, intermediate_size=512, num_attention_heads=8, num_key_value_heads=4,
          rms_norm_eps=1e-5, rope_theta=10000.0, pad_token_id=0,
          original_max_position_embeddings=32, max_position_embeddings=128,
          rope_scaling={"type": "longrope",
                        "long_factor": [float(x) for x in np.sort(_rng.uniform(1, 8, HD // 2))],
                        "short_factor": [float(x) for x in np.sort(_rng.uniform(1, 1.5, HD // 2))]})


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module, as in tests/test_torch_families.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fam(tmp_path_factory):
    """(family, checkpoint dir, the HF model)."""
    d, m = fc.build_checkpoint(tmp_path_factory.mktemp("family_phi3"), "phi3", V, 37, 1.0, **HF)
    return "phi3", d, m


@pytest.fixture(scope="module")
def walked(fam):
    return fc.walk_both(fam[1], V)


def test_config_and_params_match_jax(fam):
    """The fused checkpoint tensors split by rows into q / k / v and gate /
    up as JAX splits them, and against the HF module's fused rows."""
    _, d, m = fam
    cfg = fc.check_config_and_params(d, set(llama.BLOCK_LINEAR_KEYS)
                                     | {"input_layernorm", "post_attention_layernorm"})
    assert cfg.head_dim_ == HD and cfg.sliding_window is None and not cfg.rms_add_unit
    rs = dict(cfg.rope_scaling)
    assert rs["original_max_position_embeddings"] == 32 and rs["type"] == "longrope"
    tp = loader.load_params(d, cfg)
    hf = m.model.layers[1]
    qkv = hf.self_attn.qkv_proj.weight.detach()
    np.testing.assert_array_equal(torch.cat([tp["layers"][1][k] for k in ("q_proj", "k_proj",
                                                                          "v_proj")]).numpy(),
                                  qkv.numpy())
    assert tp["layers"][1]["k_proj"].shape == (4 * HD, 768)
    np.testing.assert_array_equal(torch.cat([tp["layers"][1]["gate_proj"],
                                             tp["layers"][1]["up_proj"]]).numpy(),
                                  hf.mlp.gate_up_proj.weight.detach().numpy())


@pytest.mark.parametrize("layer_idx", [0, 1])
def test_block_capture_matches_jax(fam, layer_idx):
    fc.check_block_capture(fam[1], V, 16, layer_idx)


@pytest.mark.parametrize("S", [24, 40])
def test_logits_match_hf_and_jax(fam, S):
    """Both sides of original_max_position_embeddings (32): short factors
    at 24 positions, long ones at 40."""
    ids = np.random.default_rng(7).integers(0, V, size=(1, S))
    fc.check_logits(fam[1], fam[2], ids)


def test_long_factors_bite(fam):
    """The first 24 positions of a 40-position forward (long factors, and
    the attention scaling sqrt(1 + ln 4 / ln 32)) differ from a 24-position
    one (short factors) by far more than the forward's 2e-4."""
    d = fam[1]
    cfg = loader.load_config(d)
    tp = loader.load_params(d, cfg)
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, V, size=(1, 40)))
    long = llama.forward(tp, ids, cfg)[:, :24]
    short = llama.forward(tp, ids[:, :24], cfg)
    assert float((long - short).abs().max()) > 1e-2
    assert llama._rope_params(cfg, 40)[1] == pytest.approx(
        math.sqrt(1 + math.log(4) / math.log(32)))
    jcfg = jloader.load_config(d)
    for seq_len in (None, 32, 33):
        want = jl._rope_params(jcfg, seq_len)
        got = llama._rope_params(cfg, seq_len)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_quantize_walk_matches_jax(fam, walked):
    fc.check_walk(fam[1], walked, 7 * 2 + 2)


def test_pack_matches_jax(fam, walked):
    """Byte-equal files; the fused attn_qkv / ffn_up are the row
    concatenations of the per-projection artifacts; the longrope keys and
    factor tensors."""
    d = fam[1]
    r = fc.check_pack(d, walked)
    assert r.get("general.architecture") == "phi3"
    assert r.get("phi3.rope.scaling.original_context_length") == 32
    assert r.get("phi3.attention.sliding_window") == 0
    assert r.get("phi3.rope.scaling.attn_factor") == pytest.approx(
        math.sqrt(1 + math.log(4) / math.log(32)))
    np.testing.assert_array_equal(r.tensor_float("rope_factors_long.weight"),
                                  np.float32(HF["rope_scaling"]["long_factor"]))
    np.testing.assert_array_equal(r.tensor_float("rope_factors_short.weight"),
                                  np.float32(HF["rope_scaling"]["short_factor"]))
    assert r.tensors["blk.0.attn_qkv.weight"].shape == (8 * HD + 2 * 4 * HD, 768)
    assert r.tensors["blk.0.ffn_up.weight"].shape == (2 * 512, 768)
    assert r.tensors["blk.0.attn_qkv.weight"].ggml_type == T.Q4_K
    assert "blk.0.attn_q.weight" not in r.tensors and "blk.0.ffn_gate.weight" not in r.tensors
    assert len(r.tensors) == 5 + 6 * 2


def test_served_f32_gguf_matches_dense_forward(fam, tmp_path):
    """An f32 pack served: the split rows are the checkpoint's (a swapped
    k / v or gate / up would still run), and forward_cached at a capacity of
    24 (short factors) gives the dense logits; both loaders agree."""
    _, d, m = fam
    path = fc.check_f32_pack(d, tmp_path)
    tp, tcfg = fc.check_served_against_jax(path, 24)
    hf = m.model.layers[0]
    qkv = hf.self_attn.qkv_proj.weight.detach().numpy()
    for key, rows in (("q_proj", qkv[:768]), ("k_proj", qkv[768:1152]), ("v_proj", qkv[1152:]),
                      ("gate_proj", hf.mlp.gate_up_proj.weight.detach().numpy()[:512])):
        np.testing.assert_array_equal(tp["layers"][0][key].numpy(), rows, err_msg=key)
    cfg = loader.load_config(d)
    ids = np.random.default_rng(9).integers(0, V, size=(2, 20))
    want = llama.forward(loader.load_params(d, cfg), torch.from_numpy(ids), cfg)[:, -1].numpy()
    got = fc.forward_steps(qmodel.fuse_params_for_serving(tp, tcfg), tcfg, ids, 24, 1)[0][0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("max_len", [24, 64])
def test_gguf_serving_matches_jax(fam, walked, monkeypatch, max_len):
    """Both loaders on the port's GGUF: params byte-equal, forward_cached
    logits at a capacity of 24 (short factors) and 64 (long ones: serving
    picks them by capacity, not by the live length), greedy engine
    streams; the two capacities give different logits."""
    monkeypatch.setattr(jq, "FORCE_PALLAS_INTERPRET", True)
    tp, tcfg = fc.check_served_against_jax(walked["gguf"], max_len)
    assert llama.uses_long_factors(tcfg, max_len) == (max_len > 32)
    if max_len == 64:
        jp, jcfg = jmodel.load_gguf_for_serving(walked["gguf"], dtype=jnp.float32)
        fc.check_engine_streams(jp, jcfg, tp, tcfg, 128)
        tf = qmodel.fuse_params_for_serving(tp, tcfg)
        ids = np.random.default_rng(3).integers(0, 256, size=(2, 12))
        a = fc.forward_steps(tf, tcfg, ids, 24, 1)[0][0]
        b = fc.forward_steps(tf, tcfg, ids, 64, 1)[0][0]
        assert np.abs(a - b).max() > 1e-2


def test_forward_paged_matches_contiguous(fam, walked):
    """head_dim 96 on the paged path (the kernel's plain version here): 12
    prefill tokens and 12 decode steps across page edges, f32 pools against
    an f32 contiguous cache of the same capacity (64: long factors in
    both). int4 pools take no hd 96, as in the JAX package."""
    table = [[5, 0, 3, 1, 14, 8, 9, 2], [6, 7, 4, 15, 10, 11, 12, 13]]
    cfg = fc.check_paged_against_contiguous(walked["gguf"], table, 8, 64, 12, V)
    assert cfg.head_dim_ == HD
    with pytest.raises(NotImplementedError, match="head_dim divisible by 64"):
        fc.paged.init_paged_cache(cfg, 2, 64, 8, kv_dtype="int4", device="cpu")


def test_paged_decode_plain_version_takes_head_dim_96():
    """The paged decode plain version at hd 96 against a dense masked
    softmax over the slot's positions (window and softcap on), and the
    wrapper on CPU tensors runs it."""
    gen = torch.Generator().manual_seed(96)
    B, nKV, G, page, pps = 2, 4, 2, 8, 4
    q = torch.randn(B, nKV, G, HD, generator=gen)
    k = torch.randn(B * pps + 1, nKV, page, HD, generator=gen)
    v = torch.randn(B * pps + 1, nKV, page, HD, generator=gen)
    table = torch.tensor([[3, 0, 5, 1], [2, 7, 4, 6]], dtype=torch.int32)
    lengths = torch.tensor([13, 30], dtype=torch.int32)
    kw = dict(scale=HD ** -0.5, window=10, softcap=5.0)
    got = pa.paged_flash_decode(q, k, v, table, lengths, **kw)
    for b in range(B):
        ks = k[table[b].long()].permute(1, 0, 2, 3).reshape(nKV, -1, HD)
        vs = v[table[b].long()].permute(1, 0, 2, 3).reshape(nKV, -1, HD)
        L = int(lengths[b])
        sl = slice(L - 10 + 1, L + 1)
        s = torch.einsum("kgh,kth->kgt", q[b] * kw["scale"], ks[:, sl])
        p = torch.softmax(5.0 * torch.tanh(s / 5.0), dim=-1)
        want = torch.einsum("kgt,kth->kgh", p, vs[:, sl])
        np.testing.assert_allclose(got[b].numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_rtn_route_matches_jax(fam, tmp_path):
    r = fc.gguf.GGUFReader(fc.check_rtn_route(fam[1], V, tmp_path))
    assert "blk.1.attn_qkv.weight" in r.tensors


def test_commands_on_the_gguf(fam, walked, tmp_path):
    """serve --paged at head_dim 96 gives the contiguous engine's tokens."""
    fc.check_commands(fam[1], walked["gguf"], tmp_path, 16)


def test_split_stitch_round_trip(fam, walked, tmp_path):
    fc.check_split_stitch(walked["gguf"], tmp_path)


def test_window_dense_and_served_follow_jax(tmp_path):
    """A phi3 checkpoint with sliding_window 8: the JAX package's dense
    forward drops the window (``from_hf_dict``) while its GGUF loader applies
    ``phi3.attention.sliding_window`` on the even layers; the port follows
    each function as it is. Over 20 positions the two JAX paths differ (the
    difference is printed; ROADMAP lists it as a fault of the reference)."""
    d, m = fc.build_checkpoint(tmp_path, "phi3", V, 41, 1.0, **dict(HF, sliding_window=8))
    cfg = loader.load_config(d)
    assert cfg.sliding_window is None
    ids = np.random.default_rng(11).integers(0, V, size=(1, 20))
    dense = llama.forward(loader.load_params(d, cfg), torch.from_numpy(ids), cfg)[:, -1].numpy()
    jcfg = jloader.load_config(d)
    jdense = np.asarray(jl.forward(jloader.load_params(d, jcfg), jnp.asarray(ids), jcfg))[:, -1]
    np.testing.assert_allclose(dense, jdense, rtol=2e-4, atol=2e-4)
    path = fc.check_f32_pack(d, tmp_path)
    tp, tcfg = fc.check_served_against_jax(path, 24)
    assert tcfg.sliding_window == 8 and [llama.layer_window(tcfg, i) for i in range(2)] == [8, None]
    served = fc.forward_steps(qmodel.fuse_params_for_serving(tp, tcfg), tcfg, ids, 24, 1)[0][0]
    diff = float(np.abs(served - dense).max())
    print(f"phi3 window 8, 20 positions: served vs dense max|diff| {diff:.4g} "
          f"of max|logit| {float(np.abs(dense).max()):.4g}")
    assert diff > 1e-2
