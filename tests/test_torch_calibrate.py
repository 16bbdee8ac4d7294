"""The port's quantize path against the JAX package on the CPU: the block
with its captures, the checkpoint and calibration-data readers, the
artifacts, and a 2-layer hidden-256 llama through the whole calibration
walk (``quantize_model`` and the ``quantize`` command line).

Tolerances: the block's output and captures within 1e-5 (f32 sum order
differs between the libraries); the walk's per-linear objective
tr((W - W_hat) H (W - W_hat)^T) within 2% of the JAX walk's, H from the
unquantized model's activations (the two walks' Hessians drift apart by
f32 rounding, and GPTQ's codes with them)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from safetensors.numpy import save_file

from gptq_gguf_tpu.models import llama as jl
from gptq_gguf_tpu.models import loader as jloader
from gptq_gguf_tpu.ops import kquant as jk
from gptq_gguf_tpu.quant import artifacts as jart
from gptq_gguf_tpu.quant import calibrate as jcal
from gptq_gguf_tpu.utils import data as jdata
from gptq_gguf_tpu_torch.__main__ import main
from gptq_gguf_tpu_torch.formats import safetensors as tst
from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
from gptq_gguf_tpu_torch.models import llama, loader
from gptq_gguf_tpu_torch.ops import kquant as tk
from gptq_gguf_tpu_torch.quant import artifacts, calibrate
from gptq_gguf_tpu_torch.utils import data

H, I, V, L, NH, NKV = 256, 512, 320, 2, 4, 2
QCFG = {k: "Q4_K" for k in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                            "down_proj")}


def _tiny_tensors(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    hd = H // NH
    t = {"model.embed_tokens.weight": rng.normal(size=(V, H)) * 0.5,
         "model.norm.weight": np.ones(H),
         "lm_head.weight": rng.normal(size=(V, H)) * 0.05}
    for i in range(L):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = 1 + 0.1 * rng.normal(size=H)
        t[p + "post_attention_layernorm.weight"] = 1 + 0.1 * rng.normal(size=H)
        for n, sh in (("self_attn.q_proj", (NH * hd, H)), ("self_attn.k_proj", (NKV * hd, H)),
                      ("self_attn.v_proj", (NKV * hd, H)), ("self_attn.o_proj", (H, NH * hd)),
                      ("mlp.gate_proj", (I, H)), ("mlp.up_proj", (I, H)),
                      ("mlp.down_proj", (H, I))):
            t[p + n + ".weight"] = rng.normal(size=sh) * 0.05
        t[p + "self_attn.rotary_emb.inv_freq"] = np.ones(hd // 2)  # derived: skipped
    return {k: v.astype(dtype) for k, v in t.items()}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_llama")
    json.dump(dict(model_type="llama", vocab_size=V, hidden_size=H, intermediate_size=I,
                   num_hidden_layers=L, num_attention_heads=NH, num_key_value_heads=NKV,
                   max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0,
                   tie_word_embeddings=False), open(d / "config.json", "w"))
    save_file(_tiny_tensors(), str(d / "model.safetensors"))
    return d


def test_safetensors_reader_reads_the_package_files(tmp_path):
    import ml_dtypes

    rng = np.random.default_rng(1)
    want = {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float16),
            "c": rng.normal(size=(2, 3, 4)).astype(ml_dtypes.bfloat16),
            "d": rng.integers(-9, 9, size=(4,)).astype(np.int64),
            "e": rng.integers(0, 255, size=(6,)).astype(np.uint8)}
    save_file(want, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got = dict(tst.iter_dir(tmp_path))
    assert sorted(got) == sorted(want)
    assert got["c"].dtype == torch.bfloat16 and got["b"].dtype == torch.float16
    for k, a in want.items():
        b = got[k]
        if b.dtype == torch.bfloat16:
            np.testing.assert_array_equal(b.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)
    with pytest.raises(FileNotFoundError):
        list(tst.iter_dir(tmp_path / "missing"))


def test_loader_matches_jax(ckpt, tmp_path):
    jcfg = jloader.load_config(ckpt)
    cfg = loader.load_config(ckpt)
    assert cfg == llama.config_from_reference(jcfg)
    jp = jloader.load_params(ckpt, jcfg, host=True)
    tp = loader.load_params(ckpt, cfg)
    assert sorted(tp) == sorted(jp) and len(tp["layers"]) == L
    for k in ("embed_tokens", "norm", "lm_head"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    for lj, lt in zip(jp["layers"], tp["layers"]):
        assert sorted(lj) == sorted(lt)
        for k in lj:
            np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]))
    # bf16 checkpoints widen to f32 on the host, as the JAX loader does
    import ml_dtypes

    (tmp_path / "config.json").write_text((ckpt / "config.json").read_text())
    save_file({k: v.astype(ml_dtypes.bfloat16) for k, v in _tiny_tensors(2).items()},
              str(tmp_path / "model.safetensors"))
    jb = jloader.load_params(tmp_path, jcfg, host=True)
    tb = loader.load_params(tmp_path, cfg)
    assert tb["layers"][1]["q_proj"].dtype == torch.float32
    np.testing.assert_array_equal(tb["layers"][1]["q_proj"].numpy(), np.asarray(jb["layers"][1]["q_proj"]))


def test_loader_refuses_other_model_types(tmp_path):
    for mt in ("gemma3_text", "phi"):  # families not ported yet
        (tmp_path / "config.json").write_text(json.dumps({"model_type": mt}))
        with pytest.raises(NotImplementedError, match=mt):
            loader.load_config(tmp_path)
    with pytest.raises(NotImplementedError, match="mlp_bias"):
        llama.LlamaConfig.from_hf_dict(dict(model_type="llama", vocab_size=8, hidden_size=8,
                                            intermediate_size=8, num_hidden_layers=1,
                                            num_attention_heads=1, mlp_bias=True))


@pytest.mark.parametrize("S", [16, 1024])  # 1024: the chunked (flash) attention path
def test_block_capture_matches_jax(ckpt, S):
    jcfg = jloader.load_config(ckpt)
    cfg = llama.config_from_reference(jcfg)
    jp = jloader.load_params(ckpt, jcfg, host=True)
    tp = llama.dense_params_from_numpy(jp, cfg, device="cpu")
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, H)).astype(np.float32)
    pos = np.arange(S)[None, :]
    cj, sj = jl.rope_cos_sin(jcfg, jnp.asarray(pos))
    cj, sj = jnp.broadcast_to(cj, (2, S, cj.shape[-1])), jnp.broadcast_to(sj, (2, S, sj.shape[-1]))
    ct, st = llama.rope_cos_sin(cfg, torch.from_numpy(pos))
    ct, st = ct.expand(2, S, -1), st.expand(2, S, -1)
    out_j, cap_j = jl.block_capture({k: jnp.asarray(v) for k, v in jp["layers"][1].items()},
                                    jnp.asarray(x), cj, sj, jl.causal_mask(2, S), jcfg, 1)
    out_t, cap_t = llama.block_capture(tp["layers"][1], torch.from_numpy(x), ct, st,
                                       llama.causal_mask(2, S), cfg, 1)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    assert sorted(cap_t) == sorted(cap_j) == ["down", "gateup", "o", "qkv"]
    for k in cap_j:
        np.testing.assert_allclose(cap_t[k].numpy(), np.asarray(cap_j[k]), rtol=1e-5, atol=1e-5)
    emb = llama.embed_forward(tp, torch.tensor([[1, 5, 7]]), cfg)
    np.testing.assert_array_equal(emb.numpy(), np.asarray(jl.embed_forward(
        jp, jnp.asarray([[1, 5, 7]]), jcfg)))
    np.testing.assert_allclose(llama.head_forward(tp, torch.from_numpy(x[:, :4]), cfg).numpy(),
                               np.asarray(jl.head_forward(jp, jnp.asarray(x[:, :4]), jcfg)),
                               rtol=1e-5, atol=1e-5)


def test_linear_names_and_set_linear(ckpt):
    jcfg = jloader.load_config(ckpt)
    cfg = llama.config_from_reference(jcfg)
    for nb in (False, True):
        assert llama.linear_layer_names(cfg, nb) == jl.linear_layer_names(jcfg, nb)
    tp = loader.load_params(ckpt, cfg)
    name = "model.layers.1.mlp.down_proj"
    p2 = llama.set_linear(tp, name, torch.zeros(H, I))
    assert llama.get_linear(p2, name).abs().sum() == 0 and llama.get_linear(tp, name).abs().sum() > 0
    assert llama.get_linear(tp, "lm_head") is tp["lm_head"]


def test_dense_params_refuse_other_blocks(ckpt):
    jcfg = jloader.load_config(ckpt)
    jp = jloader.load_params(ckpt, jcfg, host=True)
    jp["layers"][0]["gate_inp"] = np.zeros((4, H), np.float32)
    with pytest.raises(NotImplementedError, match="gate_inp"):
        llama.dense_params_from_numpy(jp, llama.config_from_reference(jcfg), device="cpu")


def test_calibration_data_matches_jax(tmp_path):
    for train in (True, False):
        a = data.get_data("synthetic", 300, 64, train=train, vocab_size=V, seed=3)
        b = jdata.get_data("synthetic", 300, 64, None, train=train, vocab_size=V, seed=3)
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    toks = np.arange(5 * 40).reshape(5, 40)
    np.save(tmp_path / "t.npy", toks)
    got = data.get_data(str(tmp_path / "t.npy"), 96, 32)
    assert [g.tolist() for g in got] == [toks[i:i + 1, :32].tolist() for i in range(3)]
    torch.save([torch.arange(40), torch.arange(40) + 1], tmp_path / "t.pt")
    assert data.load_token_file(str(tmp_path / "t.pt"), 80, 16)[1].tolist() == [list(range(1, 17))]
    with pytest.raises(NotImplementedError, match="wikitext2"):
        data.get_data("wikitext2", 100, 10)


def test_artifacts_read_across_packages(tmp_path):
    x = (np.random.default_rng(9).normal(size=(8, 512)) * 0.05).astype(np.float32)
    q, p = tk.quantize_rtn(torch.from_numpy(x), T.Q6_K)
    artifacts.save_layer(tmp_path / "t", "model.layers.0.mlp.down_proj",
                         artifacts.LayerArtifact.from_result(T.Q6_K, q, p))
    qj, pj = jk.quantize_rtn(jnp.asarray(x), T.Q6_K)
    jart.save_layer(tmp_path / "j", "model.layers.0.mlp.down_proj",
                    jart.LayerArtifact.from_result(T.Q6_K, qj, pj))
    a = jart.load_layer(tmp_path / "t", "model.layers.0.mlp.down_proj")
    b = artifacts.load_layer(tmp_path / "j", "model.layers.0.mlp.down_proj")
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape
            np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb
    np.testing.assert_array_equal(b.dequantize().numpy(), a.dequantize())
    assert list(artifacts.list_layers(tmp_path / "t")) == ["model.layers.0.mlp.down_proj"]


def _unquantized_hessians(jp, jcfg, calib):
    """Per capture and layer, 2/n X^T X of the unquantized model's inputs."""
    S = calib[0].shape[1]
    cos, sin = jl.rope_cos_sin(jcfg, jnp.arange(S)[None, :])
    xs = [jl.embed_forward(jp, jnp.asarray(b), jcfg) for b in calib]
    out = []
    for li, layer in enumerate(jp["layers"]):
        layer = {k: jnp.asarray(v) for k, v in layer.items()}
        hs, new = {}, []
        for x in xs:
            y, caps = jl.block_capture(layer, x, cos, sin, jl.causal_mask(1, S), jcfg, li)
            new.append(y)
            for k, c in caps.items():
                c = np.asarray(c, np.float64).reshape(-1, c.shape[-1])
                hs[k] = hs.get(k, 0) + c.T @ c
        out.append(hs)
        xs = new
    return out


CAPTURE = {"q_proj": "qkv", "k_proj": "qkv", "v_proj": "qkv", "o_proj": "o",
           "gate_proj": "gateup", "up_proj": "gateup", "down_proj": "down"}


def test_quantize_walk_matches_jax(ckpt, tmp_path):
    jcfg = jloader.load_config(ckpt)
    jp = jloader.load_params(ckpt, jcfg, host=True)
    calib = jdata.get_data("synthetic", 1024, 64, None, vocab_size=V)
    jcal.quantize_model(jp, jcfg, calib, quant_config=QCFG, save_dir=tmp_path / "jax")
    # the port's walk on the JAX package's own params, carried across
    cfg = llama.config_from_reference(jcfg)
    tp = llama.dense_params_from_numpy(jp, cfg, device="cpu")
    stages = {}
    out = calibrate.quantize_model(tp, cfg, calib, quant_config=QCFG, save_dir=tmp_path / "port",
                                   stage_times=stages, device="cpu")
    assert set(stages) == set(calibrate.STAGES)
    names = sorted(jart.list_layers(tmp_path / "jax"))
    assert names == sorted(artifacts.list_layers(tmp_path / "port")) and len(names) == 7 * L
    hs = _unquantized_hessians(jp, jcfg, calib)
    for name in names:
        a = jart.load_layer(tmp_path / "jax", name)
        b = jart.load_layer(tmp_path / "port", name)  # the JAX reader reads the port's files
        assert a.q_type == b.q_type == T.Q4_K
        for f in ("qweight", "super_group_scale", "super_group_zero", "group_scale_quant",
                  "group_zero_quant"):
            va, vb = getattr(a, f), getattr(b, f)
            assert va.dtype == vb.dtype and va.shape == vb.shape, (name, f)
        li, key = int(name.split(".")[2]), name.split(".")[-1]
        W = np.asarray(jp["layers"][li][key], np.float64)
        Hm = hs[li][CAPTURE[key]]
        obj = [float(np.trace((W - art.dequantize()) @ Hm @ (W - art.dequantize()).T))
               for art in (a, b)]
        assert abs(obj[1] - obj[0]) <= 0.02 * obj[0], (name, obj)
        # the walk's returned weights are the dequantized artifacts
        np.testing.assert_array_equal(out["layers"][li][key].numpy(), b.dequantize())
    assert out["embed_tokens"] is tp["embed_tokens"]


def test_quantize_command_line(ckpt, tmp_path):
    save = tmp_path / "layers"
    main(["quantize", "--model_name_or_path", str(ckpt), "--calibration_data", "synthetic",
          "--calibration_tokens", "256", "--calibration_sequence_length", "64",
          "--default_bit_width", "Q6_K", "--quant_non_block_modules", "--save_dir", str(save),
          "--device", "cpu", "--stage-profile"])
    names = sorted(artifacts.list_layers(save))
    assert names == sorted(["model.embed_tokens", "lm_head"]
                           + [n for n in jl.linear_layer_names(jloader.load_config(ckpt))])
    art = jart.load_layer(save, "model.layers.0.self_attn.q_proj")
    assert art.q_type == T.Q6_K and art.qweight.dtype == np.int8
    timings = json.loads((save / "stage_timings.json").read_text())
    assert "quantize/factorize_solve" in timings and timings["quantize"] > 0
