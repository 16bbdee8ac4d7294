"""The port's GGUF / GGML readers against the JAX package's, on the CPU.

Same inputs for both (made with numpy from a seed, blocks packed by the
JAX package), outputs compared bit for bit."""

import numpy as np
import pytest

import jax.numpy as jnp

from gptq_gguf_tpu.formats import convert as jconvert, ggml as jggml
from gptq_gguf_tpu.formats.gguf import GGUFWriter
from gptq_gguf_tpu.mapper import shards as jshards
from gptq_gguf_tpu.ops import kquant
from gptq_gguf_tpu_torch.formats import convert, ggml
from gptq_gguf_tpu_torch.formats.gguf import GGUFReader
from gptq_gguf_tpu_torch.mapper.shards import GGUFSetReader, open_gguf

T = jggml.GGMLQuantizationType
ALL_K = [T.Q2_K, T.Q3_K, T.Q4_K, T.Q5_K, T.Q6_K]


def _blocks(qtype, seed, shape=(24, 512)):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32) * 0.1
    q, p = kquant.quantize_rtn(jnp.asarray(w), qtype)
    blocks = jconvert.pack_layer(np.asarray(q), np.asarray(p.super_scale),
                                 np.asarray(p.scale_q), np.asarray(p.super_zero),
                                 np.asarray(p.zero_q), qtype)
    return blocks, shape


@pytest.mark.parametrize("qtype", ALL_K)
def test_unpack_layer_bit_equal(qtype):
    blocks, shape = _blocks(qtype, 1)
    want = jconvert.unpack_layer(blocks, qtype, shape)
    got = convert.unpack_layer(blocks, ggml.GGMLQuantizationType(int(qtype)), shape)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("qtype", ALL_K + [T.Q8_0])
def test_dequantize_bit_equal(qtype):
    if qtype == T.Q8_0:
        x = np.random.default_rng(2).normal(size=(64, 32)).astype(np.float32)
        blocks, shape = jggml.quantize_q8_0(x), (8, 256)
    else:
        blocks, shape = _blocks(qtype, 3)
    want = jggml.dequantize(blocks, qtype, shape)
    got = ggml.dequantize(blocks, ggml.GGMLQuantizationType(int(qtype)), shape)
    np.testing.assert_array_equal(got, want)


def _write_gguf(path, seed=4):
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path, arch="llama")
    w.add_kv("llama.block_count", 2)
    w.add_kv("llama.rope.freq_base", 500000.0)
    w.add_kv("tokenizer.ggml.tokens", [f"<t{i}>" for i in range(8)])
    w.add_tensor("a.weight", rng.normal(size=(3, 32)).astype(np.float32))
    w.add_tensor("b.weight", rng.normal(size=(4, 64)).astype(np.float16))
    blocks, shape = _blocks(T.Q4_K, seed, (8, 256))
    w.add_tensor("c.weight", blocks, raw_dtype=T.Q4_K, raw_shape=shape)
    w.write()


def test_gguf_reader_matches(tmp_path):
    from gptq_gguf_tpu.formats.gguf import GGUFReader as JReader

    path = tmp_path / "m.gguf"
    _write_gguf(path)
    want, got = JReader(path), GGUFReader(path)
    assert got.tensor_order == want.tensor_order
    assert {k: v.value for k, v in got.metadata.items()} == \
        {k: v.value for k, v in want.metadata.items()}
    for name in want.tensor_order:
        assert got.tensors[name].shape == want.tensors[name].shape
        assert int(got.tensors[name].ggml_type) == int(want.tensors[name].ggml_type)
        np.testing.assert_array_equal(got.tensor_bytes(name), want.tensor_bytes(name))
        np.testing.assert_array_equal(got.tensor_float(name), want.tensor_float(name))


def test_open_gguf_shard_set(tmp_path):
    path = tmp_path / "m.gguf"
    _write_gguf(path)
    parts = jshards.split_gguf_file(path, tmp_path / "s", max_tensors=1)
    assert len(parts) == 3
    whole, sset = GGUFReader(path), open_gguf(parts[1])  # any shard opens the set
    assert isinstance(sset, GGUFSetReader)
    assert sset.tensor_order == whole.tensor_order
    assert sset.get("llama.block_count") == 2
    assert sset.get("split.count") is None
    for name in whole.tensor_order:
        np.testing.assert_array_equal(sset.tensor_float(name), whole.tensor_float(name))
    assert isinstance(open_gguf(path), GGUFReader)
    parts[2].unlink()
    with pytest.raises(FileNotFoundError, match="incomplete"):
        open_gguf(parts[0])
