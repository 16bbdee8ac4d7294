"""The gemma and gemma2 families through the port's pipeline, against the
JAX package (and HF transformers) on the CPU.

Each family is a tiny HF model built from its config by transformers
(2 layers, hidden 256, intermediate 512, 2 heads of 256 (head_dim is not
hidden / heads), one KV head, vocab 320: not a multiple of 512, so a packed
head is padded and its logits sliced back), its norm weights drawn around
0 (gemma's norms scale by 1 + w), saved as f32 safetensors with a BPE
tokenizer. gemma2 gets a sliding window of 8 on its even layer,
``query_pre_attn_scalar`` 64 and softcaps of 5 (attention) and 3 (final
logits): the published 4096 / 50 / 30 would not touch sequences and
logits this small, so here each of them changes the result
(``test_window_and_softcaps_bite``).

Tolerances are those of tests/torch_family_checks.py: the block and its
captures within 1e-5, the model's logits within 2e-4 of HF's and JAX's, the
GPTQ objective within 2% of JAX's walk, RTN artifacts and every GGUF byte
for byte, served logits within LOGIT_TOL with greedy tokens equal, the
paged forward within LOGIT_TOL of the contiguous one, perplexity within
1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptq_gguf_tpu.models import llama as jl
from gptq_gguf_tpu.models import loader as jloader
from gptq_gguf_tpu.ops import qmatmul as jq
from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
from gptq_gguf_tpu_torch.models import llama, loader
from gptq_gguf_tpu_torch.serving import model as qmodel
from tests import torch_family_checks as fc

V = 320
HF = dict(hidden_size=256, intermediate_size=512, num_attention_heads=2, num_key_value_heads=1,
          head_dim=256, rms_norm_eps=1e-6, rope_theta=10000.0, max_position_embeddings=2048)
GEMMA2 = dict(sliding_window=8, query_pre_attn_scalar=64, attn_logit_softcapping=5.0,
              final_logit_softcapping=3.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module, as in tests/test_torch_families.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["gemma", "gemma2"])
def fam(request, tmp_path_factory):
    """(family, checkpoint dir, the HF model)."""
    name = request.param
    root = tmp_path_factory.mktemp(f"family_{name}")
    d, m = fc.build_checkpoint(root, name, V, 31, 0.0,
                               **HF, **(GEMMA2 if name == "gemma2" else {}))
    return name, d, m


@pytest.fixture(scope="module")
def walked(fam):
    return fc.walk_both(fam[1], V)


def test_config_and_params_match_jax(fam):
    name, d, _ = fam
    extra = {"pre_feedforward_layernorm", "post_feedforward_layernorm"} if name == "gemma2" \
        else set()
    cfg = fc.check_config_and_params(d, set(llama.BLOCK_LINEAR_KEYS) | extra
                                     | {"input_layernorm", "post_attention_layernorm"})
    assert cfg.rms_add_unit and cfg.embed_scale and cfg.act_fn == "gelu_tanh"
    assert cfg.head_dim_ == 256
    if name == "gemma2":
        assert (cfg.sliding_window, cfg.sliding_layers) == (8, (True, False))
        assert (cfg.attn_logit_softcap, cfg.final_logit_softcap,
                cfg.query_pre_attn_scalar) == (5.0, 3.0, 64)
        assert [llama.layer_window(cfg, i) for i in range(2)] == [8, None]
    else:
        assert cfg.sliding_window is None and cfg.final_logit_softcap is None


@pytest.mark.parametrize("layer_idx", [0, 1])
def test_block_capture_matches_jax(fam, layer_idx):
    """Layer 0 slides (gemma2), layer 1 is global; 16 positions, past the window."""
    fc.check_block_capture(fam[1], V, 16, layer_idx)


def test_block_capture_long_sequence_matches_jax(fam):
    """1024 positions take the chunked online-softmax path (softcap and
    window inside it) on the sliding layer."""
    fc.check_block_capture(fam[1], V, 1024, 0)


def test_logits_match_hf_and_jax(fam):
    ids = np.random.default_rng(7).integers(0, V, size=(1, 40))
    fc.check_logits(fam[1], fam[2], ids)


@pytest.mark.parametrize("fam", ["gemma2"], indirect=True)
def test_window_and_softcaps_bite(fam):
    """Each of gemma2's window, attention softcap and final softcap moves
    the logits by more than the 2e-4 the forward is held to: taking it off
    the config changes the result."""
    d = fam[1]
    cfg = loader.load_config(d)
    tp = loader.load_params(d, cfg)
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, V, size=(1, 40)))
    base = llama.forward(tp, ids, cfg)
    for off in (dict(sliding_window=None), dict(attn_logit_softcap=None),
                dict(final_logit_softcap=None)):
        moved = (llama.forward(tp, ids, dataclasses.replace(cfg, **off)) - base).abs().max()
        assert float(moved) > 1e-2, off


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_scale_matches_jax(dtype):
    """sqrt(hidden) is cast to the model dtype before it multiplies: 59.75 in
    bf16 and 59.866 in f32 at Gemma-2-9B's hidden 3584, as in JAX."""
    jcfg = jl.LlamaConfig(vocab_size=16, hidden_size=3584, intermediate_size=8,
                          num_hidden_layers=0, num_attention_heads=16, num_key_value_heads=8,
                          embed_scale=True, dtype=getattr(jnp, dtype))
    cfg = llama.config_from_reference(jcfg)
    emb = np.random.default_rng(2).normal(size=(16, 3584)).astype(np.float32)
    ids = np.array([[3, 1, 15]])
    want = np.asarray(jl.embed_forward({"embed_tokens": jnp.asarray(emb)}, jnp.asarray(ids),
                                       jcfg).astype(jnp.float32))
    got = llama.embed_forward({"embed_tokens": torch.from_numpy(emb)}, torch.from_numpy(ids),
                              cfg).float().numpy()
    np.testing.assert_array_equal(got, want)
    factor = float(llama.scale_embeddings(torch.ones(1, dtype=cfg.dtype), cfg))
    assert factor == (59.75 if dtype == "bfloat16" else np.float32(np.sqrt(3584.0)))


def test_quantize_walk_matches_jax(fam, walked):
    fc.check_walk(fam[1], walked, 7 * 2 + 2)


def test_pack_matches_jax(fam, walked):
    """Byte-equal files; gemma2's shifted norm names and keys; every norm
    stored as 1 + w."""
    name, d, _ = fam
    r = fc.check_pack(d, walked)
    assert r.get("general.architecture") == name
    assert r.get(f"{name}.attention.key_length") == 256
    norms = {"attn_norm": "input_layernorm",
             "ffn_norm": ("pre_feedforward_layernorm" if name == "gemma2"
                          else "post_attention_layernorm")}
    if name == "gemma2":
        assert r.get("gemma2.attention.sliding_window") == 8
        assert r.get("gemma2.attn_logit_softcapping") == 5.0
        assert r.get("gemma2.final_logit_softcapping") == 3.0
        assert r.get("gemma2.attention.query_pre_attn_scalar") == 64.0
        norms.update(post_attention_norm="post_attention_layernorm",
                     post_ffw_norm="post_feedforward_layernorm")
    tp = loader.load_params(d)
    for comp, key in norms.items():
        np.testing.assert_array_equal(r.tensor_float(f"blk.1.{comp}.weight"),
                                      tp["layers"][1][key].numpy() + 1.0, err_msg=comp)
    np.testing.assert_array_equal(r.tensor_float("output_norm.weight"), tp["norm"].numpy() + 1.0)
    assert r.tensors["token_embd.weight"].ggml_type == T.Q6_K
    assert len(r.tensors) == 2 + (9 + 2 * (name == "gemma2")) * 2


def test_served_f32_gguf_matches_dense_forward(fam, tmp_path):
    """The +1 is folded once: an f32 pack served (its norms plain RMSNorm
    weights, gemma2's names mapped back) gives the checkpoint's dense logits
    through forward_cached, and both loaders agree on it."""
    d = fam[1]
    path = fc.check_f32_pack(d, tmp_path)
    tp, tcfg = fc.check_served_against_jax(path, 64)
    assert not tcfg.rms_add_unit and tcfg.embed_scale
    cfg = loader.load_config(d)
    ids = np.random.default_rng(9).integers(0, V, size=(2, 20))
    want = llama.forward(loader.load_params(d, cfg), torch.from_numpy(ids), cfg)[:, -1].numpy()
    got = fc.forward_steps(qmodel.fuse_params_for_serving(tp, tcfg), tcfg, ids, 64, 1)[0][0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_gguf_serving_matches_jax(fam, walked, monkeypatch):
    """Both loaders on the port's GGUF: params byte-equal, forward_cached
    logits over 16 positions (past gemma2's window) and greedy engine
    streams."""
    monkeypatch.setattr(jq, "FORCE_PALLAS_INTERPRET", True)
    tp, tcfg = fc.check_served_against_jax(walked["gguf"], 64)
    jp, jcfg = fc.jmodel.load_gguf_for_serving(walked["gguf"], dtype=jnp.float32)
    fc.check_engine_streams(jp, jcfg, tp, tcfg, 128)


@pytest.mark.parametrize("kv_dtype", [None, "int4"])
def test_forward_paged_matches_contiguous(fam, walked, kv_dtype):
    """12 prefill tokens and 12 decode steps across page edges (pages of 8,
    past gemma2's window of 8): the paged forward against the contiguous
    one, in f32 and int4 pools."""
    fc.check_paged_against_contiguous(walked["gguf"], [[2, 0, 3, 1], [5, 7, 4, 6]], 8, 32, 12, V,
                                      kv_dtype)


def test_rtn_route_matches_jax(fam, tmp_path):
    fc.check_rtn_route(fam[1], V, tmp_path)


def test_commands_on_the_gguf(fam, walked, tmp_path):
    fc.check_commands(fam[1], walked["gguf"], tmp_path, 16)


def test_split_stitch_round_trip(fam, walked, tmp_path):
    fc.check_split_stitch(walked["gguf"], tmp_path)
