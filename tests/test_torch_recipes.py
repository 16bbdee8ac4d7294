"""The port's llama-quantize recipes, its Q4_0 / Q8_K / IQ4 codecs and its
``.imatrix`` files against the JAX package's, on the CPU.

Every comparison is exact: the codecs' bytes and dequantizations on seeded
blocks (all-zero and exact-codebook blocks among them, IQ4 with and without
importance weights); ``use_more_bits`` and ``recipe_tensor_type`` over
every recipe, the dense llama tensor names, layers of 2-80-layer models and
GQA ratios 1 / 4 / 8; ``llama_quantize`` of one tiny F16 GGUF (written by
the port's ``pack``; its ffn_down rows of 384 do not tile 256, which takes
the F16 fallback) under nine recipes, ``--pure`` and an importance matrix,
file for file; and the ``.imatrix`` bytes, each package reading the
other's file and both refusing garbage with the same message."""

import filecmp
import json

import numpy as np
import pytest
import torch

from gptq_gguf_tpu.formats import ggml as jggml
from gptq_gguf_tpu.quant import imatrix_io as jio
from gptq_gguf_tpu.quant import recipes as jrecipes
from gptq_gguf_tpu_torch.export import packer
from gptq_gguf_tpu_torch.formats import ggml
from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
from gptq_gguf_tpu_torch.formats.gguf import GGUFReader
from gptq_gguf_tpu_torch.quant import imatrix_io, recipes
from tests.torch_pack_fixtures import write_bpe, write_safetensors

# the recipe model: 2 layers, hidden 256, ffn 384 (rows of 384 do not tile
# 256: the K-quant and IQ4_XS recipes fall back to F16 on ffn_down), 4
# heads over 1 KV head (GQA 4)
H, I, V, L, NH, NKV = 256, 384, 320, 2, 4, 1

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the whole module, as tests/test_torch_pack.py's
    one_thread: the tests run in parallel workers, and torch's default pool
    of a thread per core in each of them stalls the fit's many small
    operations."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (codec, block elements, importance weights) of the codec cases
CODECS = [("q4_0", 32, False), ("q8_k", 256, False), ("iq4_nl", 32, False),
          ("iq4_nl", 32, True), ("iq4_xs", 256, False), ("iq4_xs", 256, True)]


def _blocks(codec, be, seed):
    """Seeded (n, be) rows: a zero block, an exact-codebook block, then
    normal values of varied scale."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(24, be)) * rng.uniform(0.01, 2.0, size=(24, 1))).astype(np.float32)
    x[0] = 0.0
    d = np.float32(0.03125)
    if codec.startswith("iq4"):
        x[1] = d * ggml.IQ4NL_VALUES[rng.integers(0, 16, be)].astype(np.float32)
    elif codec == "q4_0":
        x[1] = d * (rng.integers(0, 16, be) - 8).astype(np.float32)
        x[1, 0] = -8 * d  # the largest magnitude sets d
    else:
        x[1] = d * rng.integers(-127, 128, be).astype(np.float32)
        x[1, 0] = -127 * d
    return x


@pytest.mark.parametrize("codec,be,weighted", CODECS,
                         ids=[f"{c}{'-weighted' if w else ''}" for c, _, w in CODECS])
def test_codec_bytes_and_dequant_equal(codec, be, weighted):
    x = _blocks(codec, be, seed=be + weighted)
    args = (x,)
    if weighted:
        qw = np.abs(np.random.default_rng(7).normal(size=x.shape)).astype(np.float32) + 0.1
        args = (x, qw)
    want = getattr(jggml, f"quantize_{codec}")(*args)
    got = getattr(ggml, f"quantize_{codec}")(*args)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    qtype = T[codec.upper()]
    assert got.shape == (x.size // be, ggml.type_size(qtype))
    deq = getattr(ggml, f"dequant_{codec}")(got)
    np.testing.assert_array_equal(deq, getattr(jggml, f"dequant_{codec}")(want))
    # the generic dispatch (the reader's tensor_float) of a (rows, cols) tensor
    shape = (4, x.size // 4)
    np.testing.assert_array_equal(
        ggml.dequantize(got, qtype, shape),
        jggml.dequantize(want, jggml.GGMLQuantizationType[qtype.name], shape))
    np.testing.assert_array_equal(ggml.dequantize(got, qtype, shape), deq.reshape(shape))
    np.testing.assert_array_equal(deq[0], 0.0)
    if codec in ("q4_0", "iq4_nl"):  # one f16 d a block: the codebook block comes back
        np.testing.assert_array_equal(deq[1], x[1])
    assert ggml.block_elems(qtype) == be
    assert ggml.BITS_PER_WEIGHT[qtype] == jggml.BITS_PER_WEIGHT[jggml.GGMLQuantizationType[
        qtype.name]]


@pytest.mark.parametrize("n_layers", [2, 8, 32, 80])
def test_use_more_bits_matches_jax(n_layers):
    got = [recipes.use_more_bits(i, n_layers) for i in range(n_layers)]
    assert got == [jrecipes.use_more_bits(i, n_layers) for i in range(n_layers)]
    assert got[-1] and got[0] == (n_layers >= 8)


NAMES = ("token_embd.weight", "output.weight", "blk.{i}.attn_q.weight",
         "blk.{i}.attn_k.weight", "blk.{i}.attn_v.weight", "blk.{i}.attn_output.weight",
         "blk.{i}.attn_qkv.weight", "blk.{i}.ffn_gate.weight", "blk.{i}.ffn_up.weight",
         "blk.{i}.ffn_down.weight")


@pytest.mark.parametrize("ftype", sorted(recipes.FTYPE_IDS))
def test_recipe_tensor_type_matches_jax(ftype):
    assert recipes.FTYPE_IDS == jrecipes.FTYPE_IDS
    assert recipes._BASE_TYPE[ftype].name == jrecipes._BASE_TYPE[ftype].name
    seen = set()
    for n_layers in (2, 8, 32, 80):
        for i in range(n_layers):
            for tpl in NAMES:
                for n_gqa in (1, 4, 8):
                    name = tpl.format(i=i)
                    got = recipes.recipe_tensor_type(ftype, name, i, n_layers, n_gqa)
                    want = jrecipes.recipe_tensor_type(ftype, name, i, n_layers, n_gqa)
                    assert got.name == want.name, (name, n_layers, n_gqa)
                    seen.add(got.name)
    assert recipes._BASE_TYPE[ftype].name in seen


def _write_f16_gguf(root):
    """The recipe model's checkpoint, packed by the port with no artifacts
    (every 2-D tensor F16, norms F32)."""
    d = root / "m"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(
        model_type="llama", vocab_size=V, hidden_size=H, intermediate_size=I,
        num_hidden_layers=L, num_attention_heads=NH, num_key_value_heads=NKV,
        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False)))
    rng = np.random.default_rng(23)
    hd = H // NH
    t = {"model.embed_tokens.weight": rng.normal(size=(V, H)) * 0.5,
         "model.norm.weight": np.ones(H), "lm_head.weight": rng.normal(size=(V, H)) * 0.05}
    for i in range(L):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = 1 + 0.1 * rng.normal(size=H)
        t[p + "post_attention_layernorm.weight"] = 1 + 0.1 * rng.normal(size=H)
        for n, sh in (("self_attn.q_proj", (NH * hd, H)), ("self_attn.k_proj", (NKV * hd, H)),
                      ("self_attn.v_proj", (NKV * hd, H)), ("self_attn.o_proj", (H, NH * hd)),
                      ("mlp.gate_proj", (I, H)), ("mlp.up_proj", (I, H)),
                      ("mlp.down_proj", (H, I))):
            t[p + n + ".weight"] = rng.normal(size=sh) * 0.05
    write_safetensors(d / "model.safetensors", {k: v.astype(np.float32) for k, v in t.items()})
    write_bpe(d, V)
    (root / "none").mkdir()
    return packer.pack_model(d, root / "none", root / "f16.gguf")


# (recipe, pure, with the importance matrix, fit chunk elements or None)
CASES = {"Q2_K": ("Q2_K", False, False, None), "Q3_K_M": ("Q3_K_M", False, False, None),
         "Q4_K_M": ("Q4_K_M", False, False, None), "Q5_K_S": ("Q5_K_S", False, False, None),
         "Q6_K": ("Q6_K", False, False, None), "Q4_0": ("Q4_0", False, False, None),
         "Q8_0": ("Q8_0", False, False, None), "IQ4_NL": ("IQ4_NL", False, False, None),
         "IQ4_XS": ("IQ4_XS", False, False, None),
         "Q4_K_M-pure": ("Q4_K_M", True, False, None),
         "IQ4_XS-imatrix": ("IQ4_XS", False, True, None),
         # the imatrix-weighted K-quant fits, in chunks of 128 rows of 256
         "Q4_K_M-imatrix-chunked": ("Q4_K_M", False, True, 128 * 256)}


@pytest.fixture(scope="module")
def recipe_files(tmp_path_factory):
    """The F16 GGUF, a seeded importance matrix (every quantizable tensor's
    d_in, as ``llama-imatrix`` writes one), and each case's file written
    by the JAX package."""
    root = tmp_path_factory.mktemp("recipes")
    src = _write_f16_gguf(root)
    r = GGUFReader(src)
    rng = np.random.default_rng(31)
    im = {n: rng.uniform(0.05, 4.0, size=i.shape[-1]).astype(np.float32)
          for n, i in r.tensors.items() if recipes._is_quantizable(n, i.shape)}
    want = {}
    for case, (ftype, pure, use_im, _) in CASES.items():
        want[case] = jrecipes.llama_quantize(src, root / f"jax-{case}.gguf", ftype,
                                             imatrix=im if use_im else None, pure=pure)
    return root, src, im, want


@pytest.mark.parametrize("case", list(CASES))
def test_llama_quantize_byte_equal(recipe_files, case, monkeypatch):
    root, src, im, want = recipe_files
    ftype, pure, use_im, chunk = CASES[case]
    if chunk:
        monkeypatch.setattr(recipes, "FIT_CHUNK_ELEMS", chunk)
    seen, times = [], {}
    out = recipes.llama_quantize(src, root / f"port-{case}.gguf", ftype,
                                 imatrix=im if use_im else None, pure=pure,
                                 progress=lambda n, t: seen.append((n, t)), device="cpu",
                                 stage_times=times)
    assert filecmp.cmp(out, want[case], shallow=False)
    r, r0 = GGUFReader(out), GGUFReader(src)
    assert r.get("general.file_type") == recipes.FTYPE_IDS[ftype]
    assert r.tensor_order == r0.tensor_order
    types = {n: r.tensors[n].ggml_type for n in r.tensor_order}
    assert dict(seen) == {n: t.name for n, t in types.items() if recipes._is_quantizable(
        n, r0.tensors[n].shape)}
    # the non-tiling ffn_down rows: F16 unless the type's blocks tile 384
    tiles = ggml.block_elems(recipes._BASE_TYPE[ftype]) == 32
    if not tiles:
        assert types["blk.0.ffn_down.weight"] == T.F16
    for n in ("output_norm.weight", "blk.1.attn_norm.weight"):  # passthrough
        assert types[n] == T.F32
        np.testing.assert_array_equal(r.tensor_bytes(n), r0.tensor_bytes(n))
    if pure:
        assert {types[n] for n, _ in seen} <= {recipes._BASE_TYPE[ftype], T.F16}
    assert set(times) <= {"read", "fit", "pack", "codec", "write"} and "read" in times


def test_quantize_tensor_blocks_refuses_other_types():
    with pytest.raises(NotImplementedError, match="Q5_0"):
        recipes.quantize_tensor_blocks(np.zeros((2, 32), np.float32), T.Q5_0, device="cpu")
    with pytest.raises(ValueError, match="unknown recipe"):
        recipes.llama_quantize("x.gguf", "y.gguf", "Q9_K", device="cpu")


def test_imatrix_files_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    im = {f"blk.{i}.{n}.weight": rng.uniform(0, 3, size=d).astype(np.float32)
          for i in range(2) for n, d in (("attn_q", 256), ("ffn_down", 384))}
    a = jio.save_imatrix(im, tmp_path / "jax.imatrix", ncall=3, dataset="wiki")
    b = imatrix_io.save_imatrix(im, tmp_path / "port.imatrix", ncall=3, dataset="wiki")
    assert a.read_bytes() == b.read_bytes()
    for load, path in ((imatrix_io.load_imatrix, a), (jio.load_imatrix, b)):
        vals, ncalls, dataset = load(path)
        assert list(vals) == list(im) and dataset == "wiki" and set(ncalls.values()) == {3}
        for k in im:
            np.testing.assert_array_equal(vals[k], jio.load_imatrix(a)[0][k])
    # without the optional trailer: the values, no dataset
    (tmp_path / "bare.imatrix").write_bytes(a.read_bytes()[:-(8 + 4)])
    assert imatrix_io.load_imatrix(tmp_path / "bare.imatrix")[2] == ""
    assert jio.load_imatrix(tmp_path / "bare.imatrix")[2] == ""
    garbage = tmp_path / "garbage.imatrix"
    garbage.write_bytes(b"\xff\xff\xff\xff" + bytes(16))
    with pytest.raises(ValueError) as want:
        jio.load_imatrix(garbage)
    with pytest.raises(ValueError) as got:
        imatrix_io.load_imatrix(garbage)
    assert str(got.value) == str(want.value) and "not a llama.cpp imatrix file" in str(got.value)
