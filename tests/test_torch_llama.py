"""The port's dense-Llama building blocks against the JAX package, in f32.

Same numpy inputs (from a seed) through both; tolerance 1e-5 (f32
transcendentals and sum order differ between the two libraries)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptq_gguf_tpu.models import llama as jl
from gptq_gguf_tpu_torch.models import llama

RNG = np.random.default_rng(71)

ROPES = {
    "default": None,
    "linear": (("factor", 4.0), ("rope_type", "linear")),
    "llama3": (("factor", 8.0), ("high_freq_factor", 4.0), ("low_freq_factor", 1.0),
               ("original_max_position_embeddings", 64), ("rope_type", "llama3")),
    "gguf_factors": (("factors", tuple(np.linspace(1.0, 8.0, 32).tolist())),
                     ("rope_type", "gguf_factors")),
}


def _cfgs(rope_scaling=None, **kw):
    jcfg = jl.LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=512,
                          num_hidden_layers=2, num_attention_heads=4,
                          num_key_value_heads=2, rope_theta=500000.0,
                          rope_scaling=rope_scaling, **kw)
    return jcfg, llama.config_from_reference(jcfg)


def test_config_from_reference():
    jcfg, cfg = _cfgs(dtype=jnp.bfloat16)
    assert cfg.dtype == torch.bfloat16 and cfg.head_dim_ == 64
    assert cfg.num_key_value_heads == 2 and cfg.rope_theta == 500000.0
    for bad in (dict(sliding_window=16), dict(qk_norm=True), dict(act_fn="gelu_tanh"),
                dict(norm_type="layernorm"), dict(moe_num_experts=4)):
        with pytest.raises(NotImplementedError):
            llama.config_from_reference(dataclasses.replace(jcfg, **bad))


def test_rms_norm():
    x = RNG.normal(size=(3, 5, 256)).astype(np.float32)
    w = RNG.normal(size=(256,)).astype(np.float32)
    want = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = llama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", sorted(ROPES))
def test_rope(kind):
    jcfg, cfg = _cfgs(ROPES[kind])
    inv_j, s_j = jl._rope_params(jcfg)
    inv_t, s_t = llama._rope_params(cfg)
    np.testing.assert_array_equal(inv_t, inv_j)
    assert s_t == s_j
    pos = RNG.integers(0, 300, size=(2, 7))
    cj, sj = jl.rope_cos_sin_all(jcfg, jnp.asarray(pos))
    ct, st = llama.rope_cos_sin_all(cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    q = RNG.normal(size=(2, 4, 7, 64)).astype(np.float32)
    k = RNG.normal(size=(2, 2, 7, 64)).astype(np.float32)
    qj, kj = jl.apply_rope(jnp.asarray(q), jnp.asarray(k), cj, sj)
    qt, kt = llama.apply_rope(torch.from_numpy(q), torch.from_numpy(k), ct, st)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-5, atol=1e-5)


def test_unported_rope_type_raises():
    _, cfg = _cfgs((("factor", 2.0), ("rope_type", "yarn")))
    with pytest.raises(NotImplementedError, match="yarn"):
        llama._rope_params(cfg)


@pytest.mark.parametrize("S,dynamic", [(1, True), (5, False)])
def test_flash_attention(S, dynamic):
    B, nH, nKV, hd, L, chunk = 3, 4, 2, 32, 96, 32
    q = RNG.normal(size=(B, nH, S, hd)).astype(np.float32)
    k = RNG.normal(size=(B, nKV, L, hd)).astype(np.float32)
    v = RNG.normal(size=(B, nKV, L, hd)).astype(np.float32)
    qpos = np.asarray([[3], [40], [70]]) + np.arange(S)[None, :]
    want = np.asarray(jl.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        chunk=chunk, dynamic_length=dynamic))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(qpos))
    got = llama.flash_attention(*args, chunk=chunk, dynamic_length=dynamic).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if dynamic:  # a host-known chunk count, even a too-high one, is exact
        for n_live in (3, 7):
            again = llama.flash_attention(*args, chunk=chunk, dynamic_length=True,
                                          n_live=n_live).numpy()
            np.testing.assert_array_equal(again, got)


def test_mlp_act():
    jcfg, cfg = _cfgs()
    g = RNG.normal(size=(4, 64)).astype(np.float32)
    u = RNG.normal(size=(4, 64)).astype(np.float32)
    want = np.asarray(jl._mlp_act(jnp.asarray(g), jnp.asarray(u), jcfg))
    got = llama._mlp_act(torch.from_numpy(g), torch.from_numpy(u), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
