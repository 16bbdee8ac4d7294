"""Sequential block-wise GPTQ calibration walk (dense Llama).

Port of ``gptq_gguf_tpu/quant/calibrate.py``:

* block-0 inputs come from running the embedding;
* per block, one capture pass over the calibration batches accumulates the
  Hessians of all its linears (q/k/v share one input, gate/up another, so
  four Hessians serve seven linears);
* linears that share a Hessian and a quant type are solved together by
  row concatenation (q/k/v in one solve, gate/up in another) with
  ``ops.gptq.gptq_quantize_matrix``; each weight is replaced by its
  dequantized result and its artifact written at once;
* the block is run again to propagate the quantized activations;
* embeddings / lm_head are RTN-quantized without a Hessian when
  ``quant_non_block`` is set.

Weights stage onto the card one block at a time; calibration activations
stay on the card unless they exceed 2 GB. Everything runs in f32 with TF32
off. MoE blocks, meshes and the single-program batch scan of the JAX
package are not ported and raise when asked for.
"""

from __future__ import annotations

import re
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .. import resolve_device
from ..formats.ggml import GGMLQuantizationType
from ..models import llama
from ..models.llama import LlamaConfig
from ..ops import gptq as gptq_ops
from ..ops import kquant
from ..ops.gptq import GPTQConfig
from . import artifacts

# which capture feeds each linear, and the HF module-name template
_LINEAR_SPECS = [
    ("q_proj", "qkv", "model.layers.{i}.self_attn.q_proj"),
    ("k_proj", "qkv", "model.layers.{i}.self_attn.k_proj"),
    ("v_proj", "qkv", "model.layers.{i}.self_attn.v_proj"),
    ("o_proj", "o", "model.layers.{i}.self_attn.o_proj"),
    ("gate_proj", "gateup", "model.layers.{i}.mlp.gate_proj"),
    ("up_proj", "gateup", "model.layers.{i}.mlp.up_proj"),
    ("down_proj", "down", "model.layers.{i}.mlp.down_proj"),
]

DEFAULT_BLOCK_QTYPE = GGMLQuantizationType.Q4_K
DEFAULT_NON_BLOCK_QTYPE = GGMLQuantizationType.Q6_K
STAGES = ("stage_in", "capture", "factorize_solve", "artifact", "propagate", "unstage")


def resolve_quant_config(
        quant_config: Optional[Dict[str, Union[str, GGMLQuantizationType]]]
) -> Dict[str, GGMLQuantizationType]:
    out = {}
    for k, v in (quant_config or {}).items():
        out[k] = GGMLQuantizationType[v] if isinstance(v, str) else GGMLQuantizationType(v)
    return out


def activation_home(batches: Sequence[np.ndarray], cfg: LlamaConfig, dev) -> torch.device:
    """Where a block walk keeps its activations between blocks: the host
    when the f32 hidden states of every batch exceed 2 GiB, else ``dev``."""
    act_bytes = sum(b.size * cfg.hidden_size * 4 for b in batches)
    return torch.device("cpu") if act_bytes > 2 * 2 ** 30 else torch.device(dev)


def _capture_sizes(layer, cfg: LlamaConfig) -> Dict[str, int]:
    """capture name -> input dim of the dense-layer Hessians."""
    return {"qkv": cfg.hidden_size, "o": layer["o_proj"].shape[1],
            "gateup": cfg.hidden_size, "down": layer["down_proj"].shape[1]}


def quantize_model(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    calibration_ids: Sequence[np.ndarray],
    quant_config: Optional[Dict[str, Any]] = None,
    gptq_cfg: GPTQConfig = GPTQConfig(),
    save_dir: Optional[Union[str, Path]] = None,
    *,
    quant_non_block: bool = False,
    quantizable_regex: str = ".*",
    batch_size: int = 1,
    mesh=None,
    scan_batches: Optional[bool] = None,
    verbose: bool = False,
    stage_times: Optional[Dict[str, float]] = None,
    offload_activations: Optional[bool] = None,
    offload_weights: Optional[bool] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Run the GPTQ calibration walk; returns params with quantized weights.

    params: the ``models.llama`` dict, host-staged (``loader.load_params``)
    or on the card. calibration_ids: list of (B, S) or (S,) int token
    arrays (equal S). quant_config: {module_suffix: qtype}; unlisted block
    linears default to Q4_K, non-block modules to Q6_K.

    stage_times: when a dict is passed, the walk adds each stage's wall
    time into it (see STAGES; seconds), synchronising the card at stage
    ends, so pass one only to profile. offload_activations: keep the
    calibration activations in host memory between blocks; None (auto)
    does so only above 2 GB. offload_weights: return each quantized block to
    host memory; None (auto) does so when the stack exceeds 4 GB.
    device: "cuda" (the default; raises without a card) or "cpu".
    """
    dev = resolve_device(device)
    if mesh is not None:
        raise NotImplementedError("data-parallel Hessians (mesh) are not ported yet")
    if scan_batches:
        raise NotImplementedError("scan_batches is not ported yet")
    if any("gate_inp" in layer for layer in params["layers"]):
        raise NotImplementedError("MoE blocks are not ported yet")
    # f32 products stay f32 (the reference disables TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    qcfg = resolve_quant_config(quant_config)
    pattern = re.compile(quantizable_regex)
    t_start = time.perf_counter()

    class _tick:
        """Adds a stage's wall time into stage_times, the card synchronised
        at its end; no-op (and no syncs) when profiling is off."""

        def __init__(self, name):
            self.name = name

        def __enter__(self):
            if stage_times is not None:
                self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            if stage_times is not None and exc[0] is None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                stage_times[self.name] = (stage_times.get(self.name, 0.0)
                                          + time.perf_counter() - self.t0)
            return False

    ids = [np.atleast_2d(np.asarray(a)) for a in calibration_ids]
    S = ids[0].shape[1]
    batches = [np.concatenate(ids[i:i + batch_size], axis=0)
               for i in range(0, len(ids), batch_size)]
    cos1, sin1 = llama.rope_cos_sin(cfg, torch.arange(S, device=dev)[None, :])

    def rope_mask(b):
        return (cos1.expand(b, S, cos1.shape[-1]), sin1.expand(b, S, sin1.shape[-1]),
                llama.causal_mask(b, S, device=dev))

    if quant_non_block:
        params = _quant_non_block(params, "model.embed_tokens",
                                  qcfg.get("embed_tokens", DEFAULT_NON_BLOCK_QTYPE),
                                  gptq_cfg, save_dir, verbose, dev)

    if offload_activations is None:
        offload_activations = activation_home(batches, cfg, dev) != torch.device(dev)
    if offload_weights is None:
        offload_weights = sum(t.numel() * t.element_size() for layer in params["layers"]
                              for t in layer.values()) > 4 * 2 ** 30
    host = torch.device("cpu")
    act_home = host if offload_activations else dev

    def stage_in(t):
        """One block leaf onto the card; fp16 host weights widen to f32 there."""
        t = t.to(dev)
        return t.float() if t.dtype == torch.float16 else t

    embed = params["embed_tokens"].to(dev)
    xs = [llama.embed_forward({"embed_tokens": embed},
                              torch.as_tensor(b, device=dev), cfg).to(act_home)
          for b in batches]
    del embed

    n_layers = cfg.num_hidden_layers
    for li in range(n_layers):
        t0 = time.perf_counter()
        src = params["layers"][li]
        with _tick("stage_in"):
            layer = {k: stage_in(v) for k, v in src.items()}
        llama.check_dense_layer(layer)
        sizes = _capture_sizes(layer, cfg)
        hs = {k: torch.zeros((d, d), dtype=torch.float32, device=dev) for k, d in sizes.items()}
        counts = {k: 0.0 for k in sizes}

        with _tick("capture"):
            for x in xs:
                x = x.to(dev)
                cos, sin, mask = rope_mask(x.shape[0])
                _, caps = llama.block_capture(layer, x, cos, sin, mask, cfg, li)
                for key in hs:
                    hs[key], counts[key] = gptq_ops.accumulate_hessian(hs[key], counts[key],
                                                                       caps[key])
                del caps

        # linears sharing a Hessian AND a quant type are solved together by
        # row concatenation (rows are independent given the shared factor)
        new_layer = dict(layer)
        by_cap: Dict[str, list] = {}
        for key, cap, name_tpl in _LINEAR_SPECS:
            name = name_tpl.format(i=li)
            if pattern.search(name):
                by_cap.setdefault(cap, []).append((key, name, qcfg.get(key, DEFAULT_BLOCK_QTYPE)))
        for cap, members in by_cap.items():
            by_qtype: Dict[Any, list] = {}
            for m in members:
                by_qtype.setdefault(m[2], []).append(m)
            for qtype, group in by_qtype.items():
                with _tick("factorize_solve"):
                    Ws = [layer[key] for key, _, _ in group]
                    W_cat = torch.cat([w.float() for w in Ws], dim=0)
                    res = gptq_ops.gptq_quantize_matrix(W_cat, hs[cap], qtype, gptq_cfg,
                                                        device=dev)
                    del W_cat
                    w_hat = kquant.dequantize(res.qweight, res.params, qtype)
                row = 0
                for (key, name, _), W in zip(group, Ws):
                    sl = slice(row, row + W.shape[0])
                    row += W.shape[0]
                    new_layer[key] = w_hat[sl].to(W.dtype)
                    if save_dir is not None:
                        with _tick("artifact"):
                            artifacts.save_layer(save_dir, name, artifacts.LayerArtifact.from_result(
                                qtype, res.qweight[sl],
                                kquant.SuperGroupParams(*(p[sl] for p in res.params))))
                if verbose and res.issue_non_invertible:
                    names = ", ".join(n for _, n, _ in group)
                    print(f"[calibrate] {names}: non-invertible Hessian, identity fallback")
                del res, w_hat
        del hs

        with _tick("propagate"):
            new_xs = []
            for x in xs:
                x = x.to(dev)
                cos, sin, mask = rope_mask(x.shape[0])
                new_xs.append(llama.block_forward(new_layer, x, cos, sin, mask, cfg, li)
                              .to(act_home))
            xs = new_xs

        with _tick("unstage"):
            if offload_weights:
                # fp16 checkpoints go back at fp16, as the JAX walk does
                half = any(t.dtype == torch.float16 for t in src.values())
                new_layer = {k: (v.half() if half and v.dtype == torch.float32 else v).to(host)
                             for k, v in new_layer.items()}
            layers = list(params["layers"])
            layers[li] = new_layer
            params = {**params, "layers": layers}

        if verbose:
            print(f"[calibrate] block {li + 1}/{n_layers} done in "
                  f"{time.perf_counter() - t0:.2f}s")

    if quant_non_block and not cfg.tie_word_embeddings:
        params = _quant_non_block(params, "lm_head", qcfg.get("lm_head", DEFAULT_NON_BLOCK_QTYPE),
                                  gptq_cfg, save_dir, verbose, dev)
    if verbose:
        print(f"[calibrate] total {time.perf_counter() - t_start:.2f}s")
    return params


def _quant_non_block(params, name, qtype, gptq_cfg, save_dir, verbose, dev):
    """RTN-quantize embed_tokens / lm_head on the card; the dequantized
    weight goes back where the original was."""
    W = llama.get_linear(params, name)
    q, p = kquant.quantize_rtn(W.to(dev).float(), qtype, gptq_cfg.scale_cfg)
    w_hat = kquant.dequantize(q, p, qtype).to(W.device, W.dtype)
    if save_dir is not None:
        artifacts.save_layer(save_dir, name, artifacts.LayerArtifact.from_result(qtype, q, p))
    if verbose:
        print(f"[calibrate] RTN-quantized {name} to {qtype.name}")
    return llama.set_linear(params, name, w_hat)
