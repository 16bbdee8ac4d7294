"""The mistral, qwen2 and qwen3 families through the port's pipeline, against
the JAX package (and HF transformers) on the CPU.

Each family is a tiny HF model built from its config by transformers
(2 layers, vocab 320: not a multiple of 512, so the packed head is padded
and its logits sliced back), saved as f32 safetensors with a BPE tokenizer:

* mistral: hidden 512, 4 heads of 128, 2 KV heads, sliding_window 4096
  (dropped, as the JAX package drops it);
* qwen2: the same widths, q / k / v biases drawn (HF initialises them to 0);
* qwen3: hidden 256, 4 heads of 128 (head_dim is not hidden / heads), 2 KV
  heads, q / k norm weights drawn (HF initialises them to 1).

Every K-quant d_out is a multiple of 256, so JAX's dispatch takes its Pallas
kernels (interpret mode) where the port takes their plain versions.

Tolerances are those of the matching llama tests: the block and its
captures within 1e-5 (tests/test_torch_calibrate.py), the full model's
logits within 2e-4 of HF's (the JAX package's tests/test_model.py), the GPTQ
objective of each linear within 2% of the JAX walk's, RTN artifacts and
every GGUF byte for byte, serving logits within LOGIT_TOL of max|logit| with
greedy tokens equal up to near-ties (tests/test_torch_serving.py), the paged
forward within 2e-4 of the contiguous one (tests/test_torch_paged.py),
dense perplexity within 1e-4 (tests/test_torch_rtn.py).
"""

import contextlib
import dataclasses
import filecmp
import io
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptq_gguf_tpu.__main__ import main as jmain
from gptq_gguf_tpu.mapper import splitter as jsplit
from gptq_gguf_tpu.models import llama as jl
from gptq_gguf_tpu.models import loader as jloader
from gptq_gguf_tpu.ops import qmatmul as jq
from gptq_gguf_tpu.quant import artifacts as jart
from gptq_gguf_tpu.quant import calibrate as jcal
from gptq_gguf_tpu.quant import recipes as jrecipes
from gptq_gguf_tpu.quant import rtn as jrtn
from gptq_gguf_tpu.serving import model as jmodel
from gptq_gguf_tpu.utils import data as jdata
from gptq_gguf_tpu_torch.__main__ import main
from gptq_gguf_tpu_torch.formats import gguf
from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
from gptq_gguf_tpu_torch.models import llama, loader
from gptq_gguf_tpu_torch.ops import qmatmul
from gptq_gguf_tpu_torch.ops.kquant import SuperGroupParams
from gptq_gguf_tpu_torch.quant import artifacts, calibrate, recipes, rtn
from gptq_gguf_tpu_torch.serving import model as qmodel
from gptq_gguf_tpu_torch.serving import paged
from tests.test_torch_calibrate import CAPTURE, QCFG, _unquantized_hessians
from tests.test_torch_mapper import assert_same_tree
from tests.test_torch_serving import (LOGIT_TOL, _assert_tree_equal, _check_engine_streams,
                                      _check_forward_logits, _numpy_tree)
from tests.torch_pack_fixtures import write_bpe

V = 320
FAMILIES = ("mistral", "qwen2", "qwen3")
HF = {
    "mistral": dict(hidden_size=512, num_attention_heads=4, num_key_value_heads=2,
                    rope_theta=10000.0, rms_norm_eps=1e-5, sliding_window=4096),
    "qwen2": dict(hidden_size=512, num_attention_heads=4, num_key_value_heads=2,
                  rope_theta=1000000.0, rms_norm_eps=1e-6),
    "qwen3": dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2, head_dim=128,
                  rope_theta=1000000.0, rms_norm_eps=1e-6, attention_bias=False),
}
FIELDS = ("q_type", "qweight", "super_group_scale", "super_group_zero", "group_scale_quant",
          "group_zero_quant")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module, as in tests/test_torch_rtn.py: the
    tests run in parallel workers, where a thread per core in each stalls
    the many small operations of the walk and the fits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue().strip().splitlines()


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request, tmp_path_factory):
    """(family, checkpoint dir, the HF model) of one family."""
    from transformers import AutoConfig, AutoModelForCausalLM

    name = request.param
    hf = AutoConfig.for_model(model_type=name, vocab_size=V, intermediate_size=512,
                              num_hidden_layers=2, max_position_embeddings=2048,
                              tie_word_embeddings=False, torch_dtype="float32",
                              initializer_range=0.05, **HF[name])
    torch.manual_seed(29)
    m = AutoModelForCausalLM.from_config(hf).eval().float()
    with torch.no_grad():
        for pname, p in m.named_parameters():
            if pname.endswith(".bias"):
                p.normal_(0.0, 0.5)
            elif ".q_norm." in pname or ".k_norm." in pname:
                p.copy_(1.0 + 0.3 * torch.randn_like(p))
    d = tmp_path_factory.mktemp(f"family_{name}") / "m"
    m.save_pretrained(d, safe_serialization=True)
    write_bpe(d, V)
    return name, d, m


@pytest.fixture(scope="module")
def walked(fam):
    """Both packages' GPTQ walks (block linears Q4_K, embed / head RTN Q6_K)
    on 512 synthetic tokens, and the port's pack of its own artifacts."""
    name, d, _ = fam
    root = d.parent
    jcfg = jloader.load_config(d)
    jp = jloader.load_params(d, jcfg, host=True)
    calib = jdata.get_data("synthetic", 512, 64, None, vocab_size=V)
    jcal.quantize_model(jp, jcfg, calib, quant_config=QCFG, save_dir=root / "jax",
                        quant_non_block=True)
    cfg = llama.config_from_reference(jcfg)
    tp = llama.dense_params_from_numpy(jp, cfg, device="cpu")
    out = calibrate.quantize_model(tp, cfg, calib, quant_config=QCFG, save_dir=root / "port",
                                   quant_non_block=True, device="cpu")
    _run(main, ["pack", "--model_dir", str(d), "--quant_dir", str(root / "port"),
                "--outfile", str(root / "port.gguf")])
    return dict(jcfg=jcfg, jp=jp, calib=calib, out=out, gguf=root / "port.gguf")


def test_config_and_params_match_jax(fam):
    name, d, _ = fam
    jcfg = jloader.load_config(d)
    cfg = loader.load_config(d)
    assert cfg == llama.config_from_reference(jcfg)
    assert cfg.qk_norm == (name == "qwen3") and not cfg.attention_bias
    assert cfg.head_dim_ == 128 and cfg.rope_theta == HF[name]["rope_theta"]
    jp = jloader.load_params(d, jcfg, host=True)
    tp = loader.load_params(d, cfg)
    assert sorted(tp) == sorted(jp)
    for k in ("embed_tokens", "norm", "lm_head"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    extra = {"mistral": set(), "qwen2": {"q_bias", "k_bias", "v_bias"},
             "qwen3": {"q_norm", "k_norm"}}[name]
    for lj, lt in zip(jp["layers"], tp["layers"]):
        assert sorted(lt) == sorted(lj) == sorted(set(llama.BLOCK_LINEAR_KEYS) | extra
                                                  | {"input_layernorm",
                                                     "post_attention_layernorm"})
        for k in lj:
            np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]), err_msg=k)


def test_block_capture_matches_jax(fam):
    _, d, _ = fam
    jcfg = jloader.load_config(d)
    cfg = llama.config_from_reference(jcfg)
    jp = jloader.load_params(d, jcfg, host=True)
    tp = llama.dense_params_from_numpy(jp, cfg, device="cpu")
    S = 16
    # the block's input at its real scale: embedded tokens
    x = np.asarray(jp["embed_tokens"])[np.random.default_rng(5).integers(0, V, size=(2, S))]
    pos = np.arange(S)[None, :]
    cj, sj = jl.rope_cos_sin(jcfg, jnp.asarray(pos))
    cj, sj = jnp.broadcast_to(cj, (2, S, cj.shape[-1])), jnp.broadcast_to(sj, (2, S, sj.shape[-1]))
    ct, st = llama.rope_cos_sin(cfg, torch.from_numpy(pos))
    out_j, cap_j = jl.block_capture({k: jnp.asarray(v) for k, v in jp["layers"][1].items()},
                                    jnp.asarray(x), cj, sj, jl.causal_mask(2, S), jcfg, 1)
    out_t, cap_t = llama.block_capture(tp["layers"][1], torch.from_numpy(x),
                                       ct.expand(2, S, -1), st.expand(2, S, -1),
                                       llama.causal_mask(2, S), cfg, 1)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    assert sorted(cap_t) == sorted(cap_j) == ["down", "gateup", "o", "qkv"]
    for k in cap_j:
        np.testing.assert_allclose(cap_t[k].numpy(), np.asarray(cap_j[k]), rtol=1e-5, atol=1e-5)


def test_logits_match_hf_and_jax(fam):
    """The port's dense forward against transformers' model and the JAX
    package's forward on the same checkpoint."""
    _, d, m = fam
    cfg = loader.load_config(d)
    tp = loader.load_params(d, cfg)
    ids = np.random.default_rng(7).integers(0, V, size=(1, 40))
    with torch.no_grad():
        want = m(torch.from_numpy(ids)).logits.numpy()
    got = llama.forward(tp, torch.from_numpy(ids), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    jcfg = jloader.load_config(d)
    jp = jloader.load_params(d, jcfg)
    np.testing.assert_allclose(got, np.asarray(jl.forward(jp, jnp.asarray(ids), jcfg)),
                               rtol=2e-4, atol=2e-4)


def test_config_refusals():
    base = dict(vocab_size=8, hidden_size=8, intermediate_size=8, num_hidden_layers=1,
                num_attention_heads=1)
    for mt in ("gemma3_text", "phi", "qwen3_moe"):
        with pytest.raises(NotImplementedError, match=mt):
            llama.LlamaConfig.from_hf_dict(dict(base, model_type=mt))
    with pytest.raises(NotImplementedError, match="mlp_bias"):
        llama.LlamaConfig.from_hf_dict(dict(base, model_type="qwen2", mlp_bias=True))
    jcfg = jl.LlamaConfig(vocab_size=8, hidden_size=64, intermediate_size=8,
                          num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
                          qk_norm=True)
    with pytest.raises(NotImplementedError, match="qk_norm_after_rope"):  # hunyuan
        llama.config_from_reference(dataclasses.replace(jcfg, qk_norm_after_rope=True))
    cfg = llama.config_from_reference(jcfg)
    q = torch.zeros(1, 2, 3, 32)
    with pytest.raises(NotImplementedError, match="flat"):  # olmo2: one norm over all heads
        llama.head_qk_norm(q, q, {"q_norm": torch.ones(64), "k_norm": torch.ones(64)}, cfg)
    with pytest.raises(NotImplementedError, match="gate_bias"):
        llama.check_dense_layer({"q_proj": 0, "gate_bias": 0})


def test_quantize_walk_matches_jax(fam, walked):
    _, d, _ = fam
    root = d.parent
    names = sorted(jart.list_layers(root / "jax"))
    assert names == sorted(artifacts.list_layers(root / "port")) and len(names) == 7 * 2 + 2
    hs = _unquantized_hessians(walked["jp"], walked["jcfg"], walked["calib"])
    for name in names:
        a = jart.load_layer(root / "jax", name)
        b = jart.load_layer(root / "port", name)
        assert a.q_type == b.q_type
        if "layers" not in name:  # embed / head: RTN, the same codes
            for f in FIELDS[1:]:
                np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=name)
            continue
        li, key = int(name.split(".")[2]), name.split(".")[-1]
        W = np.asarray(walked["jp"]["layers"][li][key], np.float64)
        Hm = hs[li][CAPTURE[key]]
        obj = [float(np.trace((W - art.dequantize()) @ Hm @ (W - art.dequantize()).T))
               for art in (a, b)]
        assert abs(obj[1] - obj[0]) <= 0.02 * obj[0], (name, obj)
        np.testing.assert_array_equal(walked["out"]["layers"][li][key].numpy(), b.dequantize())


def test_pack_matches_jax(fam, walked):
    """pack of the port's artifacts by both command lines: the same file."""
    name, d, _ = fam
    root = d.parent
    argv = ["pack", "--model_dir", str(d), "--quant_dir", str(root / "port")]
    _run(jmain, [*argv, "--outfile", str(root / "jax-pack.gguf")])
    assert filecmp.cmp(root / "jax-pack.gguf", walked["gguf"], shallow=False)
    r = gguf.GGUFReader(walked["gguf"])
    arch = {"mistral": "llama", "qwen2": "qwen2", "qwen3": "qwen3"}[name]
    assert r.get("general.architecture") == arch
    assert r.get("tokenizer.ggml.pre") == ("llama-bpe" if name == "mistral" else "qwen2")
    assert (r.get(f"{arch}.attention.key_length") == 128) == (name == "qwen3")
    extra = {"mistral": 0, "qwen2": 3, "qwen3": 2}[name]
    assert len(r.tensors) == 3 + (9 + extra) * 2
    if name == "qwen2":
        assert r.tensors["blk.0.attn_q.bias"].ggml_type == T.F32
    if name == "qwen3":
        assert r.tensors["blk.1.attn_k_norm.weight"].shape == (128,)


def _retagged(src, path, arch):
    """A copy of the GGUF ``src`` whose architecture tag and keys are ``arch``'s."""
    r = gguf.GGUFReader(src)
    old = r.get("general.architecture")
    w = gguf.GGUFWriter(path)
    for k, v in r.metadata.items():
        w.add_kv(arch + k[len(old):] if k.startswith(old + ".") else k,
                 arch if k == "general.architecture" else v)
    for t in r.tensor_order:
        info = r.tensors[t]
        w.add_tensor(t, np.asarray(r.tensor_bytes(t)), raw_dtype=info.ggml_type,
                     raw_shape=info.shape)
    w.write()
    return path


def test_qk_rows_by_arch(fam, tmp_path, monkeypatch):
    """An f32 GGUF loaded dense gives the checkpoint's q / k rows back: the
    loader un-permutes the llama-tagged file of a mistral checkpoint (and the
    same file under the mistral tag) and leaves qwen files alone. With the
    rule reversed the rows come back scrambled."""
    name, d, m = fam
    (tmp_path / "none").mkdir()
    src = tmp_path / "f32.gguf"
    _run(main, ["pack", "--model_dir", str(d), "--quant_dir", str(tmp_path / "none"),
                "--outfile", str(src), "--outtype", "f32"])
    paths = [src] + ([_retagged(src, tmp_path / "mistral.gguf", "mistral")]
                     if name == "mistral" else [])
    want = m.model.layers[1].self_attn
    for path in paths:
        tp, cfg = qmodel.load_gguf_for_serving(path, dtype=torch.float32, device="cpu",
                                               dense=True)
        for key in ("q_proj", "k_proj"):
            np.testing.assert_array_equal(tp["layers"][1][key].numpy(),
                                          getattr(want, key).weight.detach().numpy())
    monkeypatch.setattr(qmodel, "PERMUTED_QK_ARCHES",
                        tuple(set(qmodel.GGUF_ARCHES) - set(qmodel.PERMUTED_QK_ARCHES)))
    for path in paths:
        tp, _ = qmodel.load_gguf_for_serving(path, dtype=torch.float32, device="cpu",
                                             dense=True)
        assert not np.array_equal(tp["layers"][1]["q_proj"].numpy(),
                                  want.q_proj.weight.detach().numpy())
    with pytest.raises(NotImplementedError, match="'gemma3'"):
        qmodel.load_gguf_for_serving(_retagged(src, tmp_path / "gemma3.gguf", "gemma3"),
                                     device="cpu")


def test_gguf_serving_matches_jax(fam, walked, monkeypatch):
    """Both loaders on the port's GGUF: packed planes, biases and norms
    byte-equal, the same fusion (q / k / v apart where there are biases),
    forward_cached logits and greedy engine streams."""
    monkeypatch.setattr(jq, "FORCE_PALLAS_INTERPRET", True)
    name = fam[0]
    jp, jcfg = jmodel.load_gguf_for_serving(walked["gguf"], dtype=jnp.float32)
    tp, tcfg = qmodel.load_gguf_for_serving(walked["gguf"], dtype=torch.float32, device="cpu")
    assert tcfg.attention_bias == (name == "qwen2") and tcfg.qk_norm == (name == "qwen3")
    assert llama.config_from_reference(jcfg) == dataclasses.replace(tcfg, attention_bias=False)
    assert tp["lm_head"].d_out == 512 and tcfg.vocab_size == V
    _assert_tree_equal(tp, _numpy_tree(jp))
    jf, tf = jmodel.fuse_params_for_serving(jp, jcfg), qmodel.fuse_params_for_serving(tp, tcfg)
    _assert_tree_equal(tf, _numpy_tree(jf))
    assert ("qkv_proj" in tf["layers"][0]) == (name != "qwen2")
    assert "gateup_proj" in tf["layers"][0]
    _check_forward_logits(jf, jcfg, tf, tcfg)
    _check_engine_streams(jp, jcfg, tp, tcfg, 128)


def test_forward_paged_matches_contiguous(fam, walked):
    """Prefill of 12 tokens, then 10 decode steps across a page boundary:
    the paged forward (f32 pools, scrambled tables) against forward_cached
    (f32 cache) on the served GGUF's fused params, within the serving
    tests' LOGIT_TOL of max|logit| (the kernels round activations to bf16,
    and the two attentions' last-bit differences can flip a rounding),
    greedy tokens equal where the top-2 gap is clear."""
    tp, cfg = qmodel.load_gguf_for_serving(walked["gguf"], dtype=torch.float32, device="cpu")
    tp = qmodel.fuse_params_for_serving(tp, cfg)
    B, S, page, max_len = 2, 12, 8, 32
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, V, size=(B, S)))
    pc = paged.init_paged_cache(cfg, B, max_len, page, dtype=torch.float32, device="cpu")
    pc = pc._replace(page_table=torch.tensor([[2, 0, 3, 1], [5, 7, 4, 6]], dtype=torch.int32))
    cc = qmodel.init_cache(cfg, B, max_len, dtype=torch.float32, device="cpu")
    for step in range(page + 3):
        lp, pc = paged.forward_paged(tp, cfg, ids, pc)
        lc, cc = qmodel.forward_cached(tp, cfg, ids, cc)
        want = lc.numpy()
        tol = LOGIT_TOL * np.abs(want).max()
        np.testing.assert_allclose(lp.numpy(), want, rtol=0, atol=tol, err_msg=f"step {step}")
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > tol
        np.testing.assert_array_equal(lp.argmax(-1).numpy()[clear], want.argmax(-1)[clear])
        ids = lc.argmax(-1)[:, None]
    np.testing.assert_array_equal(pc.lengths.numpy(), cc.lengths.numpy())


def test_padded_head_never_wins():
    """The head is padded to a multiple of 512 with zero rows; logits are
    sliced back to the vocabulary. Here every real logit is negative, so
    the pad columns (exactly 0) would win an argmax over the padded width."""
    rng = np.random.default_rng(3)
    rows, cols = 300, 256
    q = rng.integers(1, 16, size=(rows, cols)).astype(np.uint8)
    p = SuperGroupParams(np.full((rows, 1), 0.01, np.float16), np.zeros((rows, 1), np.float16),
                         rng.integers(1, 64, size=(rows, 8)).astype(np.uint8),
                         np.zeros((rows, 8), np.uint8))
    head = qmatmul.pad_dout_v2(qmatmul.pack_runtime_auto(q, p, T.Q4_K, device="cpu"))
    assert head.d_out == 512
    cfg = llama.LlamaConfig(vocab_size=rows, hidden_size=cols, intermediate_size=256,
                            num_hidden_layers=0, num_attention_heads=2, num_key_value_heads=2)
    h = -torch.ones((2, cols))
    full = qmatmul.dequant_matmul(h, head)
    assert (full[:, :rows] < 0).all() and int(full.argmax(-1)[0]) >= rows
    logits = qmodel._head_logits({"lm_head": head, "embed_tokens": None}, cfg, h)
    assert logits.shape == (2, rows)
    np.testing.assert_array_equal(logits.numpy(), full[:, :rows].numpy())


def test_rtn_route_matches_jax(fam, tmp_path):
    """compute_imatrix within the rtn tests' 1e-5, rtn_quantize_model given
    JAX's importance bit for bit, rtn-quantize of both command lines (no
    importance) and llama-quantize Q4_K_M of the port's f16 pack: the same
    files."""
    _, d, _ = fam
    jcfg = jloader.load_config(d)
    jp = jloader.load_params(d, jcfg, host=True)
    cfg = llama.config_from_reference(jcfg)
    tp = llama.dense_params_from_numpy(jp, cfg, device="cpu")
    calib = [np.random.default_rng(18).integers(0, V, size=(1, 64)) for _ in range(3)]
    jim = jrtn.compute_imatrix(jp, jcfg, calib, batch_size=2)
    got = rtn.compute_imatrix(tp, cfg, calib, batch_size=2, device="cpu")
    assert list(got) == list(jim) and len(got) == 14
    for k in jim:
        np.testing.assert_allclose(got[k], jim[k], rtol=1e-5, atol=0, err_msg=k)
    jrtn.rtn_quantize_model(jp, jcfg, save_dir=tmp_path / "jax", imatrix=jim)
    rtn.rtn_quantize_model(tp, cfg, save_dir=tmp_path / "port", imatrix=jim, device="cpu")
    names = sorted(jart.list_layers(tmp_path / "jax"))
    assert names == sorted(artifacts.list_layers(tmp_path / "port")) and len(names) == 14
    for n in names:
        a, b = jart.load_layer(tmp_path / "jax", n), artifacts.load_layer(tmp_path / "port", n)
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(b, f)), np.asarray(getattr(a, f)))
    data = ["--calibration_data", "synthetic", "--calibration_tokens", "128",
            "--calibration_sequence_length", "64"]
    for who, fn, dev in (("jax", jmain, []), ("port", main, ["--device", "cpu"])):
        _run(fn, ["rtn-quantize", "--model_name_or_path", str(d), *data, "--save_dir",
                  str(tmp_path / f"{who}-rtn"), "--outfile", str(tmp_path / f"{who}-rtn.gguf"),
                  *dev])
    assert filecmp.cmp(tmp_path / "jax-rtn.gguf", tmp_path / "port-rtn.gguf", shallow=False)
    (tmp_path / "none").mkdir()
    _run(main, ["pack", "--model_dir", str(d), "--quant_dir", str(tmp_path / "none"),
                "--outfile", str(tmp_path / "f16.gguf")])
    jrecipes.llama_quantize(tmp_path / "f16.gguf", tmp_path / "jax-q4km.gguf", "Q4_K_M")
    recipes.llama_quantize(tmp_path / "f16.gguf", tmp_path / "port-q4km.gguf", "Q4_K_M",
                           device="cpu")
    assert filecmp.cmp(tmp_path / "jax-q4km.gguf", tmp_path / "port-q4km.gguf", shallow=False)


def test_commands_on_the_gguf(fam, walked, tmp_path):
    """quantize of the family's checkpoint, then serve (contiguous and
    paged) and ppl of its GGUF through the port's command line: dense
    perplexity within 1e-4 of the JAX command's."""
    main(["quantize", "--model_name_or_path", str(fam[1]), "--calibration_data", "synthetic",
          "--calibration_tokens", "128", "--calibration_sequence_length", "64", "--save_dir",
          str(tmp_path / "layers"), "--device", "cpu"])
    assert len(artifacts.list_layers(tmp_path / "layers")) == 7 * 2
    path = str(walked["gguf"])
    serve = ["serve", "--gguf-file", path, "--prompt-tokens", "5", "6", "7",
             "--max-new-tokens", "4", "--max-len", "64", "--num-slots", "1", "--device", "cpu"]
    out = _run(main, serve)
    assert out[0].startswith("generated 4 tokens") and len(json.loads(out[1])) == 4
    assert _run(main, [*serve, "--paged", "--page-size", "16"])[1] == out[1]
    argv = ["ppl", "--gguf-file", path, "--gguf-path", "dense", "--datasets", "synthetic",
            "--eval_tokens", "256", "--sequence_length", "64"]
    _run(jmain, [*argv, "--output_path", str(tmp_path / "jax.json")])
    _run(main, [*argv, "--output_path", str(tmp_path / "port.json"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax.json").read_text())["synthetic"]
    got = json.loads((tmp_path / "port.json").read_text())["synthetic"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _run(main, [*argv[:4], "serving", *argv[5:], "--output_path", str(tmp_path / "s.json"),
                "--device", "cpu"])
    assert np.isfinite(json.loads((tmp_path / "s.json").read_text())["synthetic"])


def test_split_stitch_round_trip(fam, walked, tmp_path):
    """split -> stitch of the family's GGUF through the command line (each
    tensor at the one level it has) gives back the file's tensors; both
    splits against JAX's."""
    src = walked["gguf"]
    main(["split", "--gguf-file", str(src), "--output-dir", str(tmp_path / "db"),
          "--gguf-layers"])
    assert _run(main, ["stitch", "--split-dir", str(tmp_path / "db"),
                       "--validate-only"])[-1] == "configuration valid"
    main(["stitch", "--split-dir", str(tmp_path / "db"), "--output", str(tmp_path / "back.gguf")])
    a, b = gguf.GGUFReader(src), gguf.GGUFReader(tmp_path / "back.gguf")
    assert b.tensor_order == a.tensor_order
    for t in a.tensor_order:
        assert b.tensors[t].ggml_type == a.tensors[t].ggml_type, t
        assert bytes(b.tensor_bytes(t)) == bytes(a.tensor_bytes(t)), t
    main(["split", "--gguf-file", str(src), "--output-dir", str(tmp_path / "port-hf"),
          "--hf-layers"])
    jsplit.split_hf(src, tmp_path / "jax-hf")
    assert_same_tree(tmp_path / "port-hf", tmp_path / "jax-hf", hf=True)
    shutil.rmtree(tmp_path / "db")


def test_chunked_load_and_pack_equal_whole(fam, walked, monkeypatch, tmp_path):
    """The serving loader and ``pack_layer`` work on large tensors in chunks
    of convert.CHUNK_ROWS rows on host threads; here 64-row chunks (the
    embedding, the head and gate / up in 5-8 chunks) give the same params as
    whole tensors in every runtime format and dense, and ``pack`` the same
    file."""
    from gptq_gguf_tpu_torch.formats import convert
    from gptq_gguf_tpu_torch.ops import qmatmul as tq

    d = fam[1]
    loads = {}
    for chunk in (1 << 30, 64):
        monkeypatch.setattr(convert, "CHUNK_ROWS", chunk)
        _run(main, ["pack", "--model_dir", str(d), "--quant_dir", str(d.parent / "port"),
                    "--outfile", str(tmp_path / f"{chunk}.gguf")])
        for fmt in ("v2", "v4", "v1", "dense"):
            monkeypatch.setattr(tq, "RUNTIME_FORMAT", "v2" if fmt == "dense" else fmt)
            loads[chunk, fmt] = qmodel.load_gguf_for_serving(
                walked["gguf"], dtype=torch.float32, device="cpu", dense=fmt == "dense")[0]
    for fmt in ("v2", "v4", "v1", "dense"):
        _assert_tree_equal(loads[64, fmt], loads[1 << 30, fmt], path=fmt)
    assert filecmp.cmp(tmp_path / "64.gguf", tmp_path / f"{1 << 30}.gguf", shallow=False)
    assert filecmp.cmp(tmp_path / "64.gguf", walked["gguf"], shallow=False)
