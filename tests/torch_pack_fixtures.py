"""Checkpoint files for the tests of the port's ``pack``, written without
JAX, ml_dtypes or the safetensors package (so the test that holds the port
free of them can use them too)."""

import json
import struct

import numpy as np


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
