"""Perplexity and KL evaluation.

Port of ``compute_perplexity`` (with its two batch scorers),
``compute_perplexity_layer_per_layer``, ``compute_kl_div`` and
``compute_sparse_kl_div`` from ``gptq_gguf_tpu/evals/ppl.py``. Perplexity
keeps the reference's running-mean NLL exactly: per batch, the mean
cross-entropy over shifted tokens is folded into a running mean weighted by
token counts, and perplexity is exp of the final mean. The KL scores are
token means of KL(teacher || model) against cached teacher logits, dense or
top-k. The batches run on the device the params live on (block by block:
on the device asked for).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..models import llama
from ..models.llama import LlamaConfig
from ..quant.calibrate import activation_home


def _shifted_nll(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL of (B, S, V) logits for (B, S) ids, f32."""
    shift_logits = logits[:, :-1, :].float()
    shift_labels = ids[:, 1:]
    logz = torch.logsumexp(shift_logits, dim=-1)
    tok = torch.gather(shift_logits, -1, shift_labels[..., None])[..., 0]
    return torch.mean(logz - tok)


def _batch_nll(params, ids: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Mean next-token NLL of one (B, S) batch through the dense forward."""
    return _shifted_nll(llama.forward(params, ids, cfg), ids)


def _batch_nll_serving(params, ids: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """_batch_nll through the quantized serving forward: weights stay
    packed and every projection and the lm_head run through the format's
    kernel at M = B * S rows (how a GGUF too large for dense f32 weights
    is scored on one card)."""
    from ..serving import model as qmodel

    B, S = ids.shape
    cache = qmodel.init_cache(cfg, B, S, dtype=cfg.dtype, device=ids.device)
    logits, _ = qmodel.forward_cached(params, cfg, ids, cache, all_logits=True)
    return _shifted_nll(logits, ids)


def compute_perplexity(params, cfg: LlamaConfig, data: Sequence[np.ndarray],
                       batch_size: int = 1, serving: bool = False) -> float:
    """Reference-exact running-mean perplexity (metrics.py:10-37).

    serving=True scores through the quantized serving forward
    (``_batch_nll_serving``) instead of the dense ``llama.forward``."""
    nll = _batch_nll_serving if serving else _batch_nll
    device = params["embed_tokens"].device
    nll_running = 0.0
    tokens_processed = 0
    data = [np.atleast_2d(np.asarray(d)) for d in data]
    with torch.no_grad():
        for i in range(0, len(data), batch_size):
            ids = np.concatenate(data[i : i + batch_size], axis=0)
            loss = float(nll(params, torch.as_tensor(ids, device=device), cfg))
            n_new = ids[:, 1:].size
            a = n_new / (tokens_processed + n_new)
            b = tokens_processed / (tokens_processed + n_new)
            nll_running = a * loss + b * nll_running
            tokens_processed += n_new
    return float(np.exp(nll_running))


def _token_kl(logits: torch.Tensor, teacher: torch.Tensor) -> torch.Tensor:
    """KL(teacher || model) at each position of (B, S, K) logits, f32:
    sum q * (log q - log p) over the last axis (F.kl_div with log
    targets)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    logq = torch.log_softmax(teacher.float(), dim=-1)
    return torch.sum(torch.exp(logq) * (logq - logp), dim=-1)


def _batch_kl(params, ids: torch.Tensor, target_logits: torch.Tensor, cfg: LlamaConfig):
    """(mean, per-position) KL of one (B, S) batch over its shifted
    positions against the teacher's (B, S, V) logits."""
    kl = _token_kl(llama.forward(params, ids, cfg)[:, :-1, :], target_logits[:, :-1, :])
    return torch.mean(kl), kl


def compute_kl_div(params, cfg: LlamaConfig, data: Sequence[np.ndarray],
                   target_logits: Sequence[Any]) -> float:
    """Token-mean KL against cached dense teacher logits (metrics.py:41-86).

    The reference's batchmean over B * S * V elements ranks the same as
    this token mean; the JAX package returns the token mean too."""
    device = params["embed_tokens"].device
    total, count = 0.0, 0
    with torch.no_grad():
        for ids, tl in zip(data, target_logits):
            ids = torch.as_tensor(np.atleast_2d(np.asarray(ids)), device=device)
            _, kl = _batch_kl(params, ids, torch.as_tensor(tl, device=device), cfg)
            total += float(kl.sum())
            count += kl.numel()
    return total / max(count, 1)


def compute_sparse_kl_div(params, cfg: LlamaConfig, data: Sequence[np.ndarray],
                          sparse_targets: Sequence[Any]) -> float:
    """Top-k sparse KL (metrics.py:89-119): the model's and the teacher's
    logits both restricted to the teacher's top-k ids at each position.
    ``sparse_targets`` holds (values, ids) per sequence, numpy or tensors
    (on the params' device, as ``search.evopress.compute_target_logits``
    keeps them)."""
    device = params["embed_tokens"].device
    total, count = 0.0, 0
    with torch.no_grad():
        for ids, (t_logits, t_ids) in zip(data, sparse_targets):
            ids = torch.as_tensor(np.atleast_2d(np.asarray(ids)), device=device)
            logits = llama.forward(params, ids, cfg)
            g = torch.gather(logits, -1, torch.as_tensor(t_ids, device=device).long())
            t = torch.as_tensor(t_logits, device=device)
            kl = _token_kl(g[:, :-1, :], t[:, :-1, :])
            total += float(kl.sum())
            count += kl.numel()
    return total / max(count, 1)


def compute_perplexity_layer_per_layer(params, cfg: LlamaConfig, data: Sequence[np.ndarray],
                                       batch_size: int = 1, device=None) -> float:
    """Memory-bounded perplexity (metrics.py:122-192): the embedding of
    every batch, then each block over every batch, then the head, with the
    same running mean of NLLs as ``compute_perplexity``. Each block's
    weights go to the device for its pass and the activations stay there,
    unless they exceed 2 GiB (the calibration walk's rule,
    ``quant.calibrate``): then they wait in host memory between blocks.
    device: where the blocks run (default: where the embedding lives)."""
    dev = torch.device(device) if device is not None else params["embed_tokens"].device
    data = [np.atleast_2d(np.asarray(d)) for d in data]
    batches = [np.concatenate(data[i: i + batch_size], axis=0)
               for i in range(0, len(data), batch_size)]
    S = batches[0].shape[1]
    act_home = activation_home(batches, cfg, dev)
    with torch.no_grad():
        cos1, sin1 = llama.rope_cos_sin(cfg, torch.arange(S, device=dev)[None, :])
        embed = {"embed_tokens": params["embed_tokens"].to(dev)}
        xs = [llama.embed_forward(embed, torch.as_tensor(b, device=dev), cfg).to(act_home)
              for b in batches]
        del embed
        for li, src in enumerate(params["layers"]):
            layer = {k: v.to(dev) for k, v in src.items()}
            new_xs = []
            for x in xs:
                b = x.shape[0]
                mask = llama.causal_mask(b, S, device=dev)
                new_xs.append(llama.block_forward(
                    layer, x.to(dev), cos1.expand(b, S, cos1.shape[-1]),
                    sin1.expand(b, S, sin1.shape[-1]), mask, cfg, li).to(act_home))
            xs = new_xs
            del layer
        # the head's weight (lm_head, or the tied embedding) under the key
        # head_forward falls back to
        head = {"norm": params["norm"].to(dev),
                "embed_tokens": params.get("lm_head", params["embed_tokens"]).to(dev)}
        nll_running = 0.0
        tokens_processed = 0
        for ids, x in zip(batches, xs):
            logits = llama.head_forward(head, x.to(dev), cfg)
            loss = float(_shifted_nll(logits, torch.as_tensor(ids, device=dev)))
            n_new = ids[:, 1:].size
            a = n_new / (tokens_processed + n_new)
            b_ = tokens_processed / (tokens_processed + n_new)
            nll_running = a * loss + b_ * nll_running
            tokens_processed += n_new
    return float(np.exp(nll_running))
