"""The port's ``pack`` against the JAX package's, on the CPU.

Every writer of the port is held to the JAX package's bytes on the same
inputs: each K-quant packer (and Q8_0's quantizer) on seeded codes and
scales, the GGUF writer on typed metadata and tensors of every dtype (one
over the 1 MiB spill threshold), ``pack_model`` through both command lines
on a tiny llama (hidden 256, 2 layers) with mixed Q2_K..Q6_K artifacts, BPE
and SentencePiece vocabularies, llama3 rope scaling, tied embeddings, every
``--outtype``, ``--vocab-only`` and safetensors headers in unsorted order,
and the shards of ``split_gguf_file``. All comparisons are exact.

Then the pipeline entirely in the port on the CPU: ``quantize`` (with
``--eval_perplexity``), ``pack``, and ``serve`` and ``ppl`` on that GGUF.
"""

import contextlib
import filecmp
import io
import json

import ml_dtypes
import numpy as np
import pytest
import torch

from gptq_gguf_tpu.__main__ import main as jmain
from gptq_gguf_tpu.cli import common as jcommon
from gptq_gguf_tpu.export import spm as jspm
from gptq_gguf_tpu.formats import convert as jconvert, ggml as jggml, gguf as jgguf
from gptq_gguf_tpu.mapper import shards as jshards
from gptq_gguf_tpu_torch.__main__ import main
from gptq_gguf_tpu_torch.evals import ppl
from gptq_gguf_tpu_torch.export import packer, spm
from gptq_gguf_tpu_torch.formats import convert, ggml, gguf
from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
from gptq_gguf_tpu_torch.mapper import shards
from gptq_gguf_tpu_torch.models import llama
from gptq_gguf_tpu_torch.quant import artifacts, calibrate
from gptq_gguf_tpu_torch.utils import data
from tests.test_torch_calibrate import H, I, L, NH, NKV, V, _tiny_tensors
from tests.torch_pack_fixtures import (KQ, _checkpoint, _codes, _write_spm, write_bpe,
                                       write_safetensors)

# ---------------------------------------------------------------------------
# Block packers and the GGUF writer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qtype", KQ, ids=lambda t: t.name)
def test_block_packers_bit_equal(qtype):
    rng = np.random.default_rng(int(qtype))
    q, d, sc, dmin, mn = _codes(rng, qtype, 24, 512)
    want = jconvert.pack_layer(q, d, sc, dmin, mn, jggml.GGMLQuantizationType(int(qtype)))
    got = convert.pack_layer(q, d, sc, dmin, mn, qtype)
    assert got.dtype == np.uint8 and got.shape == (48, ggml.type_size(qtype))
    np.testing.assert_array_equal(got, want)
    # the per-type packer itself, and the unpacker reads it back
    flat = [a.reshape(48, -1) for a in (q, sc, mn)]
    args = ((flat[0], d.reshape(-1), flat[1]) if qtype in (T.Q3_K, T.Q6_K)
            else (flat[0], d.reshape(-1), flat[1], dmin.reshape(-1), flat[2]))
    name = f"pack_{qtype.name.lower()}"
    np.testing.assert_array_equal(getattr(ggml, name)(*args), getattr(jggml, name)(*args))
    back = convert.unpack_layer(got, qtype, q.shape)
    np.testing.assert_array_equal(back[0], q)
    np.testing.assert_array_equal(back[1], d)


def test_scale_min_and_q8_0_bit_equal():
    rng = np.random.default_rng(3)
    sc, mn = rng.integers(0, 64, size=(2, 40, 8)).astype(np.uint8)
    np.testing.assert_array_equal(ggml.pack_scale_min_k4(sc, mn), jggml.pack_scale_min_k4(sc, mn))
    np.testing.assert_array_equal(ggml.unpack_scale_min_k4(ggml.pack_scale_min_k4(sc, mn))[1], mn)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    x[3] = 0.0  # an all-zero block: d = 0
    x[5, 7] = 1e4  # one outlier
    np.testing.assert_array_equal(ggml.quantize_q8_0(x), jggml.quantize_q8_0(x))
    q = rng.integers(-128, 128, size=(64, 32)).astype(np.int8)
    d = rng.uniform(0, 1, size=64).astype(np.float32)
    np.testing.assert_array_equal(ggml.pack_q8_0(q, d), jggml.pack_q8_0(q, d))


def test_bf16_rounding_matches_ml_dtypes():
    """The packer's f32 -> bf16 bits equal ml_dtypes' (the JAX packer's) on
    every kind of f32: normals of every exponent, subnormals, infinities,
    signed zeros, the largest finite values, and NaNs with any payload."""
    rng = np.random.default_rng(8)
    x = np.concatenate([
        (rng.normal(size=20000) * 10.0 ** rng.integers(-45, 38, 20000)).astype(np.float32),
        np.array([np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 3.4028235e38, -3.4028235e38,
                  1e-45, -1e-45], np.float32),
        rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32).view(np.float32)])
    with np.errstate(invalid="ignore"):  # NaN payloads
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(packer._bf16_bits(x), want)


def _writer_calls(mod, bf16):
    """The same add_kv / add_tensor calls on a writer of either package."""
    V_ = mod.GGUFValueType
    kv = [("general.architecture", "llama"), ("a.bool", True), ("a.u32", 7),
          ("a.u64", 2 ** 33), ("a.i32", -5), ("a.i64", -(2 ** 40)), ("a.f32", 0.1),
          ("a.str", "ünïcode"), ("a.bytes", b"\x00raw"), ("a.strs", ["x", "", "ÿ"]),
          ("a.ints", [3, -1, 2]), ("a.uints", [1, 2, 2 ** 31]), ("a.floats", [1.5, -2.25]),
          ("a.bools", [True, False]), ("a.empty", []), ("a.tuple", (4, 5)),
          ("t.u32", mod.GGUFValue(V_.UINT32, 3)), ("t.u8", mod.GGUFValue(V_.UINT8, 255)),
          ("t.i8", mod.GGUFValue(V_.INT8, -128)), ("t.u16", mod.GGUFValue(V_.UINT16, 65535)),
          ("t.i16", mod.GGUFValue(V_.INT16, -2)),
          ("t.f64", mod.GGUFValue(V_.FLOAT64, 1 / 3)),
          ("t.arr_u16", mod.GGUFValue(V_.ARRAY, [1, 2], elem_type=V_.UINT16)),
          ("t.nested", mod.GGUFValue(V_.ARRAY, [
              mod.GGUFValue(V_.ARRAY, [1.0], elem_type=V_.FLOAT32),
              mod.GGUFValue(V_.ARRAY, ["s"], elem_type=V_.STRING)], elem_type=V_.ARRAY)),
          ("a.u32", 9)]  # again: replaced in its first position
    rng = np.random.default_rng(5)
    q4 = jconvert.pack_layer(*_codes(rng, T.Q4_K, 4, 512), jggml.GGMLQuantizationType.Q4_K)
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    tensors = [("f32", (f32,), {}), ("f16", (f32.astype(np.float16),), {}),
               ("i32", (np.arange(6, dtype=np.int32).reshape(2, 3),), {}),
               ("i64", (np.arange(4, dtype=np.int64),), {}),
               ("bf16", (bf16(f32),), {}),
               ("raw_bf16", (f32.astype(ml_dtypes.bfloat16).view(np.uint16),),
                {"raw_dtype": 30, "raw_shape": (3, 5)}),
               ("big", (rng.normal(size=(520, 512)).astype(np.float32),), {}),  # > 1 MiB: spilled
               ("q4", (q4,), {"raw_dtype": 12, "raw_shape": (4, 512)}),
               ("scalar", (np.ones(1, np.float32),), {})]
    return kv, tensors


def test_gguf_writer_byte_equal(tmp_path):
    outs = []
    for mod, bf16, qt in ((jgguf, lambda a: a.astype(ml_dtypes.bfloat16),
                           jggml.GGMLQuantizationType),
                          (gguf, lambda a: torch.from_numpy(a).to(torch.bfloat16), T)):
        kv, tensors = _writer_calls(mod, bf16)
        path = tmp_path / f"{mod.__name__.split('.')[0]}.gguf"
        w = mod.GGUFWriter(path)
        for k, v in kv:
            w.add_kv(k, v)
        for name, args, kw in tensors:
            if "raw_dtype" in kw:
                kw = {**kw, "raw_dtype": qt(kw["raw_dtype"])}
            w.add_tensor(name, *args, **kw)
        w.write()
        assert not path.with_name(path.name + ".data.tmp").exists()
        outs.append(path)
    assert filecmp.cmp(*outs, shallow=False)
    r = gguf.GGUFReader(outs[1])
    assert r.get("a.u32") == 9 and list(r.metadata)[2] == "a.u32"
    big = dict((name, args[0]) for name, args, _ in tensors)["big"]
    np.testing.assert_array_equal(r.tensor_float("big"), big)  # the spilled payload
    assert r.tensors["bf16"].ggml_type == T.BF16
    np.testing.assert_array_equal(r.tensor_float("bf16"), r.tensor_float("raw_bf16"))


def test_gguf_writer_refuses_wrong_sizes(tmp_path):
    w = gguf.GGUFWriter(tmp_path / "x.gguf")
    with pytest.raises(ValueError, match="raw bytes"):
        w.add_tensor("q", np.zeros(100, np.uint8), raw_dtype=T.Q4_K, raw_shape=(1, 256))
    with pytest.raises(TypeError, match="unsupported dtype"):
        w.add_tensor("b", np.zeros(3, np.bool_))


# ---------------------------------------------------------------------------
# pack_model: the whole file, both command lines
# ---------------------------------------------------------------------------


PACK_CASES = {
    "bpe_f16": [],
    "bpe_f32": ["--outtype", "f32"],
    "bpe_bf16": ["--outtype", "bf16"],
    "bpe_q8_0": ["--outtype", "q8_0"],
    "attention_bias": [],
    "spm": ["--model-name", "renamed"],
    "llama3_tied": ["--outtype", "bf16"],
    "tied_quantized": [],
    "unsorted_two_files": ["--outtype", "q8_0"],
    "bf16_auto": ["--outtype", "auto"],
    "vocab_only": ["--vocab-only", "--outtype", "bf16"],
}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_model_byte_equal(tmp_path, case, monkeypatch):
    d, q = _checkpoint(tmp_path, case)
    extra = tmp_path / "meta.json"
    extra.write_text(json.dumps({"general.author": "me", "general.name": "from-file"}))
    argv = ["pack", "--model_dir", str(d), "--quant_dir", str(q), "--metadata", str(extra),
            *PACK_CASES[case]]
    jmain([*argv, "--outfile", str(tmp_path / "jax.gguf")])
    main([*argv, "--outfile", str(tmp_path / "port.gguf")])
    assert filecmp.cmp(tmp_path / "jax.gguf", tmp_path / "port.gguf", shallow=False)
    assert not list(tmp_path.glob("*.tmp"))  # the spill file is gone
    r = gguf.GGUFReader(tmp_path / "port.gguf")
    if case == "vocab_only":
        assert not r.tensors and r.get("general.file_type") == 32
        return
    if case == "llama3_tied":
        assert r.tensor_order[0] == "rope_freqs.weight"
    n_bias = 7 * L if case == "attention_bias" else 0
    assert "output.weight" in r.tensors
    assert len(r.tensors) == 3 + 9 * L + (case == "llama3_tied") + n_bias
    assert r.get("general.name") == ("renamed" if case == "spm" else "from-file")
    assert r.get("tokenizer.ggml.model") == ("llama" if case == "spm" else "gpt2")
    # the q / k artifacts come back through the unpacker and the inverse permutation
    art = artifacts.load_layer(q, "model.layers.1.self_attn.k_proj") \
        if (q / "model.layers.1.self_attn.k_proj").exists() else None
    if art is not None:
        info = r.tensors["blk.1.attn_k.weight"]
        codes = convert.unpack_layer(np.asarray(r.tensor_bytes(info.name)), info.ggml_type,
                                     info.shape)[0]
        inv = np.argsort(convert.gqa_permute_rows(info.shape[0], NKV))
        np.testing.assert_array_equal(codes[inv], art.qweight)


def test_pack_model_no_tokenizer_no_artifacts(tmp_path):
    """A checkpoint without tokenizer files and no quant_dir: float tensors
    only, general.file_type from the float type (the API call)."""
    from gptq_gguf_tpu.export import packer as jpacker

    d, _ = _checkpoint(tmp_path, "bpe_f16")
    for f in ("tokenizer.json", "tokenizer_config.json"):
        (d / f).unlink()
    jpacker.pack_model(d, tmp_path / "none", tmp_path / "jax.gguf",
                       default_float=jggml.GGMLQuantizationType.F32)
    packer.pack_model(d, None, tmp_path / "port.gguf", default_float=T.F32)
    assert filecmp.cmp(tmp_path / "jax.gguf", tmp_path / "port.gguf", shallow=False)
    assert gguf.GGUFReader(tmp_path / "port.gguf").get("general.file_type") == 0


@pytest.mark.parametrize("how", ["tensors", "size", "tensors_and_size"])
def test_split_byte_equal(tmp_path, how):
    d, q = _checkpoint(tmp_path, "bpe_f16")
    src = tmp_path / "whole.gguf"
    packer.pack_model(d, q, src)
    kw = {"tensors": dict(max_tensors=5), "size": dict(max_size=200_000),
          "tensors_and_size": dict(max_tensors=4, max_size=300_000)}[how]
    want = jshards.split_gguf_file(src, tmp_path / "jax", **kw)
    got = shards.split_gguf_file(src, tmp_path / "port", **kw)
    assert len(got) == len(want) > 2
    for a, b in zip(want, got):
        assert b.name == a.name.replace("jax", "port")
        assert filecmp.cmp(a, b, shallow=False)
    whole, parts = gguf.GGUFReader(src), shards.open_gguf(got[-1])
    assert parts.tensor_order == whole.tensor_order
    for name in whole.tensor_order:
        np.testing.assert_array_equal(parts.tensor_bytes(name), whole.tensor_bytes(name))


def test_pack_cli_split_matches_jax(tmp_path):
    d, q = _checkpoint(tmp_path, "bpe_f16")
    argv = ["pack", "--model_dir", str(d), "--quant_dir", str(q), "--split-max-size", "256K"]
    jmain([*argv, "--outfile", str(tmp_path / "jax.gguf")])
    main([*argv, "--outfile", str(tmp_path / "port.gguf")])
    got = sorted(tmp_path.glob("port-*.gguf"))
    assert not (tmp_path / "port.gguf").exists() and len(got) > 2
    for p in got:
        assert filecmp.cmp(p, tmp_path / p.name.replace("port", "jax"), shallow=False)


def test_pack_refusals(tmp_path, capsys):
    d, q = _checkpoint(tmp_path, "bpe_f16")
    out = str(tmp_path / "x.gguf")
    with pytest.raises(NotImplementedError, match="--mmproj is not ported yet"):
        main(["pack", "--model_dir", str(d), "--outfile", out, "--mmproj"])
    cfg = json.loads((d / "config.json").read_text())
    for mt in ("gemma3_text", "phi"):  # families not ported yet
        (d / "config.json").write_text(json.dumps({**cfg, "model_type": mt}))
        with pytest.raises(NotImplementedError, match=f"model_type '{mt}' is not ported yet"):
            packer.pack_model(d, q, out)
    (d / "config.json").write_text(json.dumps({**cfg, "text_config": {"model_type": "llama"}}))
    with pytest.raises(NotImplementedError, match="multimodal"):
        packer.pack_model(d, q, out)
    (d / "config.json").write_text(json.dumps(cfg))
    for mtype in ("Unigram", "WordPiece", "WordLevel"):
        (d / "tokenizer.json").write_text(json.dumps({"model": {"type": mtype, "vocab": []}}))
        with pytest.raises(NotImplementedError, match=mtype):
            packer.pack_model(d, q, out)
    (d / "rwkv_vocab_v20230424.txt").write_text("1 'a' 1\n")
    with pytest.raises(NotImplementedError, match="RWKV"):
        packer.tokenizer_metadata(d)
    with pytest.raises(SystemExit, match="--quant_dir is required"):
        main(["pack", "--model_dir", str(d), "--outfile", out])
    capsys.readouterr()
    assert main(["pack", "--print-supported-models"]) == 0
    assert capsys.readouterr().out.split() == ["llama", "mistral", "qwen2", "qwen3", "gemma",
                                               "gemma2", "phi3"]


def test_spm_reader_matches_jax(tmp_path):
    _write_spm(tmp_path)
    blob = (tmp_path / "tokenizer.model").read_bytes()
    want, got = jspm.parse_model(blob), spm.parse_model(blob)
    assert [(p.piece, p.score, p.type) for p in got.pieces] == \
        [(p.piece, p.score, p.type) for p in want.pieces]
    assert (got.unk_id, got.bos_id, got.eos_id, got.pad_id) == (0, 1, 2, -1)


# ---------------------------------------------------------------------------
# The pipeline in the port: quantize, pack, serve, ppl
# ---------------------------------------------------------------------------


def _tiny_ckpt(root):
    d = root / "m"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(
        model_type="llama", vocab_size=V, hidden_size=H, intermediate_size=I,
        num_hidden_layers=L, num_attention_heads=NH, num_key_value_heads=NKV,
        max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False)))
    write_safetensors(d / "model.safetensors", _tiny_tensors())
    return d


QUANTIZE = ["--calibration_data", "synthetic", "--calibration_tokens", "256",
            "--calibration_sequence_length", "64", "--eval_perplexity",
            "--eval_sequence_length", "32"]


@pytest.fixture
def one_thread():
    """One torch thread while the port computes on the CPU: the tests run in
    parallel workers, and torch's default pool of a thread per core in each of
    them stalls the walk's many small operations."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def quantized(tmp_path_factory):
    """The tiny llama quantized once by the port's command line with
    ``--eval_perplexity``: (checkpoint dir, artifacts dir, the printed
    perplexity, compute_perplexity on the walk's returned params)."""
    tmp = tmp_path_factory.mktemp("pipeline")
    d = _tiny_ckpt(tmp)
    write_bpe(d, V)
    seen = {}
    walk = calibrate.quantize_model

    def spy(*a, **kw):
        seen["params"] = walk(*a, **kw)
        return seen["params"]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as one_thread does
    buf = io.StringIO()
    try:
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
            mp.setattr(calibrate, "quantize_model", spy)
            main(["quantize", "--model_name_or_path", str(d), *QUANTIZE, "--save_dir",
                  str(tmp / "layers"), "--device", "cpu"])
        qp = seen["params"]
        want = ppl.compute_perplexity(
            {**{k: v.float() for k, v in qp.items() if k != "layers"},
             "layers": [{k: v.float() for k, v in layer.items()} for layer in qp["layers"]]},
            llama.LlamaConfig.from_hf_dict(json.loads((d / "config.json").read_text())),
            data.get_data("synthetic", 3200, 32, train=False, vocab_size=V))
    finally:
        torch.set_num_threads(threads)
    printed = float(buf.getvalue().split("synthetic perplexity:")[1].split()[0])
    return d, tmp / "layers", printed, want


def test_pipeline_in_the_port(quantized, tmp_path, capsys, one_thread):
    d, save, _, _ = quantized
    out = tmp_path / "model.gguf"
    main(["pack", "--model_dir", str(d), "--quant_dir", str(save), "--outfile", str(out)])
    jmain(["pack", "--model_dir", str(d), "--quant_dir", str(save), "--outfile",
           str(tmp_path / "jax.gguf")])
    assert filecmp.cmp(out, tmp_path / "jax.gguf", shallow=False)
    r = gguf.GGUFReader(out)
    assert r.get("general.file_type") == 15
    for name in artifacts.list_layers(save):
        art = artifacts.load_layer(save, name)
        li, comp = name.split(".")[2], name.split(".")[-1]
        gname = f"blk.{li}.{packer.hf_to_gguf_name(name + '.weight').split('.', 2)[2]}"
        info = r.tensors[gname]
        back = convert.unpack_layer(np.asarray(r.tensor_bytes(gname)), info.ggml_type, info.shape)
        perm = convert.gqa_permute_rows(info.shape[0], NH if comp == "q_proj" else NKV) \
            if comp in ("q_proj", "k_proj") else np.arange(info.shape[0])
        inv = np.argsort(perm)
        np.testing.assert_array_equal(back[0][inv].astype(art.qweight.dtype), art.qweight)
        np.testing.assert_array_equal(back[1][inv], art.super_group_scale)
        np.testing.assert_array_equal(back[2][inv], art.group_scale_quant)
    capsys.readouterr()
    main(["serve", "--gguf-file", str(out), "--prompt-tokens", "5", "6", "7",
          "--max-new-tokens", "6", "--max-len", "64", "--num-slots", "1", "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0].startswith("generated 6 tokens")
    toks = json.loads(printed[-1])
    assert len(toks) == 6 and all(0 <= t < V for t in toks)
    main(["serve", "--gguf-file", str(out), "--prompt", "<t5><t5>", "--max-new-tokens", "3",
          "--max-len", "64", "--num-slots", "1", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("generated 3 tokens")
    res = main(["ppl", "--gguf-file", str(out), "--gguf-path", "serving", "--datasets",
                "synthetic", "--eval_tokens", "128", "--sequence_length", "64", "--device",
                "cpu", "--output_path", str(tmp_path / "ppl.json")])
    assert res == 0
    got = json.loads((tmp_path / "ppl.json").read_text())["synthetic"]
    assert np.isfinite(got) and 1 < got < 10 * V


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_bf16_gguf_loads_its_bits(quantized, tmp_path, dtype, one_thread):
    """A bf16 GGUF (no artifacts: every linear dense) loads for serving from
    its raw bits: each tensor equals its f32 dequantization cast to the
    model's dtype, q / k rows back in HF's order; norms stay f32."""
    from gptq_gguf_tpu_torch.serving import model as qmodel

    d = quantized[0]
    out = tmp_path / "bf16.gguf"
    packer.pack_model(d, None, out, default_float=T.BF16)
    params, cfg = qmodel.load_gguf_for_serving(out, dtype=dtype, device="cpu")
    r = gguf.GGUFReader(out)
    keys = {"attn_q": ("q_proj", NH), "attn_k": ("k_proj", NKV), "attn_v": ("v_proj", 0),
            "attn_output": ("o_proj", 0), "ffn_gate": ("gate_proj", 0),
            "ffn_up": ("up_proj", 0), "ffn_down": ("down_proj", 0)}
    seen = 0
    for name in r.tensor_order:
        if r.tensors[name].ggml_type != T.BF16:
            continue
        w = r.tensor_float(name)
        parts = name.split(".")
        if name == "token_embd.weight":
            got = params["embed_tokens"]
        elif name == "output.weight":
            got = params["lm_head"]
        else:
            key, heads = keys[parts[2]]
            got = params["layers"][int(parts[1])][key]
            if heads:
                w = w[np.argsort(convert.gqa_permute_rows(w.shape[0], heads))]
        assert got.dtype == dtype and torch.equal(got, torch.from_numpy(w).to(dtype)), name
        seen += 1
    assert seen == 2 + 7 * cfg.num_hidden_layers - cfg.tie_word_embeddings
    assert params["norm"].dtype == torch.float32


def test_quantize_eval_perplexity(quantized, tmp_path, capsys, monkeypatch):
    """``quantize --eval_perplexity``: the printed perplexity is the port's
    compute_perplexity on the quantized params (relative 1e-4: it is printed
    to 4 decimals), and within 0.05 nats/token of the JAX command line's on
    the same checkpoint (the cross-route bound of test_torch_ppl.py)."""
    d, save, got, want = quantized
    assert abs(got - want) / want < 1e-4, (got, want)
    assert json.loads((save / "stage_timings.json").read_text())["eval_perplexity"] > 0
    # the JAX command line, its tokenizer lookup skipped (synthetic data needs none)
    monkeypatch.setattr(jcommon, "load_tokenizer", lambda args: None)
    capsys.readouterr()
    jmain(["quantize", "--model_name_or_path", str(d), *QUANTIZE, "--save_dir",
           str(tmp_path / "jax")])
    jax_ppl = float(capsys.readouterr().out.split("perplexity:")[1].split()[0])
    assert abs(np.log(got) - np.log(jax_ppl)) < 0.05, (got, jax_ppl)
