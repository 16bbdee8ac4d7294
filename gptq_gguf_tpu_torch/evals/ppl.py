"""Perplexity evaluation.

Port of ``compute_perplexity`` and its two batch scorers from
``gptq_gguf_tpu/evals/ppl.py``. It keeps the reference's running-mean NLL
exactly: per batch, the mean cross-entropy over shifted tokens is folded
into a running mean weighted by token counts, and perplexity is exp of the
final mean. The batches run on the device the params live on.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..models import llama
from ..models.llama import LlamaConfig


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
