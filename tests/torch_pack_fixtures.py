"""Checkpoint and artifact files for the tests of the port's ``pack`` and of
what reads its GGUFs (the layer database, the search, the stitcher).

``write_safetensors`` and ``write_bpe`` need neither JAX, ml_dtypes nor the
safetensors package, so the test that holds the port free of them can use
them too; ``_checkpoint`` reaches the JAX package (its SentencePiece
model writer, the tiny llama's tensors of ``tests/test_torch_calibrate.py``)
only when it runs. ``_codes`` and ``_write_artifacts`` write seeded
K-quant artifacts without running GPTQ.
"""

import json
import struct

import numpy as np

from gptq_gguf_tpu_torch.formats import ggml
from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
from gptq_gguf_tpu_torch.quant import artifacts

KQ = (T.Q2_K, T.Q3_K, T.Q4_K, T.Q5_K, T.Q6_K)
LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
           "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def write_safetensors(path, tensors):
    """A safetensors file whose header lists ``tensors`` in the given order."""
    header, off = {}, 0
    for name, a in tensors.items():
        dt = {"float32": "F32", "float16": "F16", "bfloat16": "BF16"}[a.dtype.name]
        header[name] = {"dtype": dt, "shape": list(a.shape), "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a).tobytes())


def write_bpe(d, vocab_size):
    """A BPE ``tokenizer.json`` of ``vocab_size`` tokens (merges, special and
    added tokens, a multi-byte piece) and its ``tokenizer_config.json``."""
    vocab = {f"<t{i}>": i for i in range(vocab_size - 2)}
    vocab["Ġhé"] = vocab_size - 2
    tok = {"model": {"type": "BPE", "vocab": vocab, "merges": [["<t1>", "<t2>"], "<t3> <t4>"]},
           "added_tokens": [{"id": 0, "content": "<t0>", "special": True},
                            {"id": 5, "content": "<t5>", "special": False},
                            {"id": vocab_size - 1, "content": "<eot>", "special": True}]}
    (d / "tokenizer.json").write_text(json.dumps(tok))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"bos_token_id": 0, "eos_token_id": 1, "add_bos_token": True,
         "chat_template": "{{ messages }}"}))


def _codes(rng, qtype, rows, cols):
    """Seeded artifact fields of one (rows, cols) layer of ``qtype``, each in
    its type's range and dtype."""
    spec = ggml.KQUANT_SPECS[qtype]
    n_sg, ng = cols // 256, cols // spec.group_size
    q = rng.integers(spec.qmin, spec.qmax + 1, size=(rows, cols))
    if spec.signed:
        lo, hi = (-32, 32) if qtype == T.Q3_K else (-128, 128)
        sc = rng.integers(lo, hi, size=(rows, ng)).astype(np.int8)
        mn = np.zeros((rows, ng), np.int8)
        dmin = np.zeros((rows, n_sg), np.float16)
    else:
        sc = rng.integers(0, spec.scale_maxq + 1, size=(rows, ng)).astype(np.uint8)
        mn = rng.integers(0, spec.scale_maxq + 1, size=(rows, ng)).astype(np.uint8)
        dmin = rng.uniform(0, 0.01, size=(rows, n_sg)).astype(np.float16)
    d = rng.uniform(0, 0.01, size=(rows, n_sg)).astype(np.float16)
    return (q.astype(np.int8 if spec.signed else np.uint8), d, sc, dmin, mn)


def _write_spm(d):
    from gptq_gguf_tpu.export import spm as jspm
    from tests.test_torch_calibrate import V

    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(f"▁p{i}", -float(i) / 3, 1) for i in range(V - 10)]
    pieces += [(f"<0x{i:02X}>", 0.0, 6) for i in range(4)]
    (d / "tokenizer.model").write_bytes(jspm.build_model(pieces, unk_id=0, bos_id=1, eos_id=2,
                                                         pad_id=-1))
    (d / "added_tokens.json").write_text(json.dumps({"<extra>": V - 2}))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "added_tokens_decoder": {str(V - 1): {"content": "<end>", "special": False},
                                 "1": {"content": "<s>"}},
        "chat_template": [{"name": "default", "template": "d"},
                          {"name": "tool_use", "template": "t"}, {"name": "broken"}]}))
    (d / "generation_config.json").write_text(json.dumps({"eos_token_id": [2, 7]}))


def _write_artifacts(q, seed, names, qtype=None):
    """Seeded artifacts of ``names`` under ``q``: every one of ``qtype``, or
    the K-quant types in turn from ``seed``."""
    from tests.test_torch_calibrate import H, I, NH, NKV, V

    rng = np.random.default_rng(seed)
    shapes = {"self_attn.q_proj": (H, H), "self_attn.k_proj": (NKV * H // NH, H),
              "self_attn.v_proj": (NKV * H // NH, H), "self_attn.o_proj": (H, H),
              "mlp.gate_proj": (I, H), "mlp.up_proj": (I, H), "mlp.down_proj": (H, I),
              "model.embed_tokens": (V, H), "lm_head": (V, H)}
    for k, name in enumerate(names):
        qt = qtype or KQ[(k + seed) % len(KQ)]
        fields = _codes(rng, qt, *shapes[name.split(".", 3)[-1] if "layers" in name else name])
        artifacts.save_layer(q, name, artifacts.LayerArtifact(qt, *fields[:2], fields[3],
                                                               fields[2], fields[4]))


def _checkpoint(root, case):
    """A tiny llama checkpoint (and artifacts) for one pack case; returns
    (model_dir, quant_dir)."""
    import ml_dtypes

    from tests.test_torch_calibrate import H, I, L, NH, NKV, V, _tiny_tensors

    d, q = root / "m", root / "layers"
    d.mkdir()
    cfg = dict(model_type="llama", vocab_size=V, hidden_size=H, intermediate_size=I,
               num_hidden_layers=L, num_attention_heads=NH, num_key_value_heads=NKV,
               max_position_embeddings=512, rms_norm_eps=1e-6, rope_theta=500000.0,
               tie_word_embeddings=False, _name_or_path="tiny/llama")
    t = _tiny_tensors(seed=4, dtype=ml_dtypes.bfloat16 if case == "bf16_auto" else np.float32)
    if case == "llama3_tied":
        cfg.update(tie_word_embeddings=True, rope_scaling=dict(
            rope_type="llama3", factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
            original_max_position_embeddings=128))
        del t["lm_head.weight"]
    if case == "tied_quantized":
        cfg.update(tie_word_embeddings=True, rope_scaling=dict(type="linear", factor=2.0))
        del t["lm_head.weight"]
    if case == "attention_bias":  # llama's attention_bias / mlp_bias: 1-D f32 tensors
        cfg.update(attention_bias=True, mlp_bias=True)
        rng = np.random.default_rng(5)
        for name in [n for n in t if n.endswith("_proj.weight")]:
            t[name[:-len("weight")] + "bias"] = rng.normal(size=t[name].shape[0]).astype(np.float32)
    (d / "config.json").write_text(json.dumps(cfg))
    if case == "unsorted_two_files":  # headers in reverse order; files sorted by name
        names = sorted(t, reverse=True)
        write_safetensors(d / "model-00002-of-00002.safetensors", {n: t[n] for n in names[:9]})
        write_safetensors(d / "model-00001-of-00002.safetensors", {n: t[n] for n in names[9:]})
    else:
        write_safetensors(d / "model.safetensors", t)
    _write_spm(d) if case == "spm" else write_bpe(d, V)
    names = [f"model.layers.{i}.{n}" for i in range(L) for n in LINEARS]
    if case == "tied_quantized":
        names += ["model.embed_tokens", "lm_head"]
    if case == "bf16_auto":
        names = names[::3]  # some linears stay float
    _write_artifacts(q, sum(map(ord, case)) % 5, names)
    return d, q


def write_level_ggufs(root, levels=("Q2_K", "Q4_K", "Q6_K")):
    """Pack case ``bpe_f16``'s checkpoint once per K-quant level, every
    linear at that level (seeded artifacts), through the port's ``pack``:
    returns (model_dir, {level: GGUF path}); each file's name carries its
    level, as ``build-db`` reads it."""
    from gptq_gguf_tpu_torch.export import packer
    from tests.test_torch_calibrate import L

    d, _ = _checkpoint(root, "bpe_f16")
    names = [f"model.layers.{i}.{n}" for i in range(L) for n in LINEARS]
    out = {}
    for k, level in enumerate(levels):
        q = root / f"layers-{level}"
        _write_artifacts(q, 11 + k, names, qtype=T[level])
        out[level] = packer.pack_model(d, q, root / f"tiny-{level}.gguf")
    return d, out
