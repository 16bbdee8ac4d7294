"""Round-to-nearest K-quant quantization: the llama-quantize route of stage 1.

Port of ``gptq_gguf_tpu/quant/rtn.py``. The reference shells out to
llama.cpp's ``llama-quantize`` for plain (non-GPTQ) K-quant models,
optionally with an importance matrix; this module does both:

* :func:`compute_imatrix`: one float-model pass over the calibration
  batches, collecting each linear's per-column importance, the diagonal of
  its GPTQ Hessian over 2 (what llama.cpp's imatrix tool measures);
* :func:`rtn_quantize_model`: round-to-nearest K-quant of every selected
  linear (imatrix-weighted scale fitting when given), writing the same
  artifacts as the GPTQ walk, so ``pack`` and the layer database apply;
* :func:`quantization_summary`: the size and bits-per-weight report.

The importance pass accumulates only the diagonal of each Hessian, with the
walk's EMA weights (``ops.gptq.accumulate_hessian``): the same values as
the JAX package's diag(H) / 2 up to f32 summation order, without
materializing the (d_in, d_in) matrices (down's is 822 MB at Llama-3-8B
width). Weights and activations stage onto ``device`` one block at a time,
as ``calibrate.quantize_model`` stages them.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .. import resolve_device
from ..formats.ggml import KQUANT_SPECS
from ..models import llama
from ..models.llama import LlamaConfig
from ..ops import kquant
from . import artifacts
from .calibrate import (_LINEAR_SPECS, DEFAULT_BLOCK_QTYPE, DEFAULT_NON_BLOCK_QTYPE,
                        resolve_quant_config)


def _accumulate_diag(d: torch.Tensor, num_samples: float,
                     x: torch.Tensor) -> float:
    """The diagonal of ``ops.gptq.accumulate_hessian``'s EMA update, in
    place: ``d <- beta d + alpha sum(x^2)`` over all but the last axis;
    batch counts sequences. Returns the new sample count."""
    batch = x.shape[0]
    x2 = x.reshape(-1, x.shape[-1]).float()
    n = np.float32(num_samples)
    beta = float(n / (n + np.float32(batch)))
    alpha = float(np.float32(2.0) / (n + np.float32(batch)))
    d.mul_(beta).add_((x2 * x2).sum(0), alpha=alpha)
    return num_samples + batch


def compute_imatrix(params: Dict[str, Any], cfg: LlamaConfig,
                    calibration_ids: Sequence[np.ndarray], batch_size: int = 1,
                    device="cuda") -> Dict[str, np.ndarray]:
    """Per-linear importance vectors (mean squared activation per input
    column, f32 numpy) from one float-model calibration pass, keyed by HF
    module name in ``calibrate._LINEAR_SPECS`` order. params: the
    ``models.llama`` dict, host-staged or on the card; device: "cuda" (the
    default; raises without a card) or "cpu"."""
    dev = resolve_device(device)
    if any("gate_inp" in layer for layer in params["layers"]):
        raise NotImplementedError("MoE blocks are not ported yet")
    ids = [np.atleast_2d(np.asarray(a)) for a in calibration_ids]
    S = ids[0].shape[1]
    batches = [np.concatenate(ids[i:i + batch_size], axis=0)
               for i in range(0, len(ids), batch_size)]
    cos1, sin1 = llama.rope_cos_sin(cfg, torch.arange(S, device=dev)[None, :])
    act_bytes = sum(b.shape[0] * S * cfg.hidden_size * 4 for b in batches)
    act_home = torch.device("cpu") if act_bytes > 2 * 2 ** 30 else dev

    embed = params["embed_tokens"].to(dev)
    xs = [llama.embed_forward({"embed_tokens": embed}, torch.as_tensor(b, device=dev),
                              cfg).to(act_home) for b in batches]
    del embed

    out: Dict[str, np.ndarray] = {}
    with torch.no_grad():
        for li, src in enumerate(params["layers"]):
            layer = {k: (v.to(dev).float() if v.dtype == torch.float16 else v.to(dev))
                     for k, v in src.items()}
            diags: Dict[str, torch.Tensor] = {}
            counts: Dict[str, float] = {}
            new_xs = []
            for x in xs:
                x = x.to(dev)
                b = x.shape[0]
                cos, sin = cos1.expand(b, S, cos1.shape[-1]), sin1.expand(b, S, sin1.shape[-1])
                y, caps = llama.block_capture(layer, x, cos, sin, llama.causal_mask(b, S, dev),
                                              cfg, li)
                for key, cap in caps.items():
                    if key not in diags:
                        diags[key] = torch.zeros(cap.shape[-1], dtype=torch.float32, device=dev)
                        counts[key] = 0.0
                    counts[key] = _accumulate_diag(diags[key], counts[key], cap)
                new_xs.append(y.to(act_home))  # float-model propagation
                del caps
            halves = {k: (d / 2.0).cpu().numpy() for k, d in diags.items()}
            for _, cap, name_tpl in _LINEAR_SPECS:
                out[name_tpl.format(i=li)] = halves[cap]
            xs = new_xs
            del layer, diags
    return out


def rtn_quantize_model(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    quant_config: Optional[Dict[str, Any]] = None,
    save_dir: Optional[Union[str, Path]] = None,
    *,
    scale_cfg: kquant.ScaleSearchConfig = kquant.ScaleSearchConfig(),
    imatrix: Optional[Dict[str, np.ndarray]] = None,
    quant_non_block: bool = False,
    quantizable_regex: str = ".*",
    device="cuda",
) -> Dict[str, Any]:
    """Quantize every selected linear with (optionally imatrix-weighted)
    RTN; returns params with each quantized weight replaced by its
    dequantization, where and in the dtype the original was. Unlisted block
    linears default to Q4_K, embed_tokens / lm_head (``quant_non_block``)
    to Q6_K. The fits run on ``device``, one weight at a time."""
    dev = resolve_device(device)
    qcfg = resolve_quant_config(quant_config)
    pattern = re.compile(quantizable_regex)

    def quantize_one(name, W, qtype):
        im = None
        if imatrix is not None and name in imatrix:
            im = torch.from_numpy(np.asarray(imatrix[name], np.float32)).to(dev)
        q, p = kquant.quantize_rtn(W.to(dev).float(), qtype, scale_cfg, im)
        q = q.to(torch.int8 if KQUANT_SPECS[qtype].signed else torch.uint8)
        if save_dir is not None:
            artifacts.save_layer(save_dir, name,
                                 artifacts.LayerArtifact.from_result(qtype, q, p))
        return kquant.dequantize(q, p, qtype).to(W.device, W.dtype)

    if quant_non_block:
        for name in ["model.embed_tokens"] + ([] if cfg.tie_word_embeddings else ["lm_head"]):
            qtype = qcfg.get(name.split(".")[-1], DEFAULT_NON_BLOCK_QTYPE)
            params = llama.set_linear(params, name,
                                      quantize_one(name, llama.get_linear(params, name), qtype))

    layers = []
    for li, layer in enumerate(params["layers"]):
        new_layer = dict(layer)
        for key, _, name_tpl in _LINEAR_SPECS:
            name = name_tpl.format(i=li)
            if pattern.search(name):
                new_layer[key] = quantize_one(name, layer[key],
                                              qcfg.get(key, DEFAULT_BLOCK_QTYPE))
        layers.append(new_layer)
    return {**params, "layers": layers}


def quantization_summary(gguf_path: Union[str, Path],
                         out_path: Optional[Union[str, Path]] = None) -> Dict[str, Any]:
    """Size and bits-per-weight report of a GGUF: tensors, bytes and
    elements per type and in all; written as JSON to ``out_path`` if given."""
    from ..formats.gguf import GGUFReader

    r = GGUFReader(gguf_path)
    per_type: Dict[str, Dict[str, int]] = {}
    total_bytes = total_elems = 0
    for info in r.tensors.values():
        t = per_type.setdefault(info.ggml_type.name, {"tensors": 0, "bytes": 0, "elements": 0})
        n = math.prod(int(v) for v in info.shape)
        t["tensors"] += 1
        t["bytes"] += info.nbytes
        t["elements"] += n
        total_bytes += info.nbytes
        total_elems += n
    summary = {
        "file": str(gguf_path),
        "file_size_bytes": Path(gguf_path).stat().st_size,
        "tensor_bytes": total_bytes,
        "total_elements": total_elems,
        "bits_per_weight": 8.0 * total_bytes / max(total_elems, 1),
        "types": per_type,
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=2)
    return summary
