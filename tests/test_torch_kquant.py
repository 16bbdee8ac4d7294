"""The port's K-quant fitting against the JAX package, bit for bit.

The same seeded numpy weights (with all-zero, constant and negative
degenerate groups) go through ``gptq_gguf_tpu.ops.kquant`` and
``gptq_gguf_tpu_torch.ops.kquant`` on the CPU; params, codes and the
dequantized weights must be equal in every bit (fp16 compared as bits)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptq_gguf_tpu.formats.ggml import GGMLQuantizationType as T
from gptq_gguf_tpu.ops import kquant as jk
from gptq_gguf_tpu_torch.ops import kquant as tk

UNSIGNED = [T.Q2_K, T.Q4_K, T.Q5_K]
SIGNED = [T.Q3_K, T.Q6_K]
CASES = ([(qt, "absmax", compat, imx) for qt in UNSIGNED for compat in (True, False)
          for imx in (False, True)]
         + [(qt, scale, True, imx) for qt in SIGNED for scale in ("absmax", "mse")
            for imx in (False, True)])


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint16) if a.dtype == np.float16 else a


def _weights(seed, d_row=24, d_col=512):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(d_row, d_col)) * rng.uniform(0.01, 0.2, size=(d_row, 1))).astype(np.float32)
    x[0, :32] = 0.0           # an all-zero group
    x[1, :64] = 0.5           # constant groups
    x[2, :16] = -0.25         # a negative constant group
    x[3, :256] = 0.0          # an all-zero supergroup
    im = rng.uniform(0.1, 2.0, size=d_col).astype(np.float32)
    return x, im


@pytest.mark.parametrize("qtype,quant_scale,compat,imatrix", CASES,
                         ids=[f"{q.name}-{s}-{'wrap' if c else 'clean'}-{'im' if i else 'noim'}"
                              for q, s, c, i in CASES])
def test_fit_quantize_dequantize_bit_equal(qtype, quant_scale, compat, imatrix):
    x, im = _weights(int(qtype) * 7 + imatrix)
    jcfg = jk.ScaleSearchConfig(quant_scale=quant_scale, compat_uint8_overflow=compat)
    tcfg = tk.ScaleSearchConfig(quant_scale=quant_scale, compat_uint8_overflow=compat)
    jim = jnp.asarray(im) if imatrix else None
    tim = torch.from_numpy(im) if imatrix else None

    qj, pj = jk.quantize_rtn(jnp.asarray(x), qtype, jcfg, jim)
    qt, pt = tk.quantize_rtn(torch.from_numpy(x), qtype, tcfg, tim)
    for name, a, b in zip(pj._fields, pj, pt):
        assert b.dtype == getattr(torch, str(np.asarray(a).dtype)), name
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=name)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert qt.dtype == (torch.int8 if qtype in SIGNED else torch.uint8)

    # quantize / dequantize on their own, from the same params
    params = tk.SuperGroupParams(*(torch.from_numpy(np.array(a)) for a in pj))
    np.testing.assert_array_equal(tk.quantize(torch.from_numpy(x), params, qtype).numpy(),
                                  np.asarray(jk.quantize(jnp.asarray(x), pj, qtype)))
    np.testing.assert_array_equal(tk.dequantize(qt, pt, qtype).numpy(),
                                  np.asarray(jk.dequantize(qj, pj, qtype)))


@pytest.mark.parametrize("qtype", UNSIGNED + SIGNED, ids=lambda q: q.name)
def test_dequantize_rtn_and_column_slice(qtype):
    x, _ = _weights(5, d_row=8)
    want = np.asarray(jk.dequantize_rtn(jnp.asarray(x), qtype))
    np.testing.assert_array_equal(tk.dequantize_rtn(torch.from_numpy(x), qtype).numpy(), want)
    q, p = tk.quantize_rtn(torch.from_numpy(x), qtype)
    qj, pj = jk.quantize_rtn(jnp.asarray(x), qtype)
    col = 300
    g = col // (16 if qtype in (T.Q2_K, T.Q3_K, T.Q6_K) else 32)
    for a, b in zip(tk.quantize_column_slice(torch.from_numpy(x[:, col]), p, qtype, col // 256, g),
                    jk.quantize_column_slice(jnp.asarray(x[:, col]), pj, qtype, col // 256, g)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_degenerate_groups_stay_finite():
    x = np.zeros((2, 512), np.float32)
    x[1] = 3.14
    for qtype in UNSIGNED + SIGNED:
        y = tk.dequantize_rtn(torch.from_numpy(x), qtype)
        assert torch.isfinite(y).all()
