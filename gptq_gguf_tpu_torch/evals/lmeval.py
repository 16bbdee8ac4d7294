"""lm-eval-harness integration.

Port of ``gptq_gguf_tpu/evals/lmeval.py``: the dense model exposed as an
``lm_eval.api.model.LM`` subclass (``TorchCausalLM``; ``JaxCausalLM`` is
its other name, the JAX package's), so any param dict (float, dequantized,
weight-swapped) is evaluated directly.

Scoring is batched: requests are grouped into padded length buckets and
scored ``batch_size`` at a time through the dense ``models.llama.forward``
on the params' device; each row's log-softmax runs there too, so only its
scores come back. lm_eval is optional: the scorers work without it (and
are tested so), only the adapter class needs it.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

try:
    import lm_eval
    from lm_eval.api.model import LM

    HAS_LM_EVAL = True
except Exception:  # optional dependency
    HAS_LM_EVAL = False
    LM = object

from ..models import llama
from ..models.llama import LlamaConfig

_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return n


def score_continuations(
    params,
    cfg: LlamaConfig,
    pairs: Sequence[Tuple[Sequence[int], Sequence[int]]],
    max_length: int,
    batch_size: int = 8,
) -> List[Tuple[float, bool]]:
    """Batched (logprob, is_greedy) for (context_ids, continuation_ids) pairs.

    Right-pads within a length bucket: causal attention means padding after
    a row's true tokens cannot affect its scored positions.
    """
    device = params["embed_tokens"].device
    items = []
    for i, (ctx, cont) in enumerate(pairs):
        ids = (list(ctx) + list(cont))[-max_length:]
        n_cont = min(len(cont), len(ids) - 1)
        items.append((i, ids, n_cont))

    results: List[Optional[Tuple[float, bool]]] = [None] * len(items)
    groups = defaultdict(list)
    for it in items:
        groups[_bucket(len(it[1]))].append(it)

    with torch.no_grad():
        for L, its in sorted(groups.items()):
            for j in range(0, len(its), batch_size):
                chunk = its[j: j + batch_size]
                arr = np.zeros((len(chunk), L), np.int64)
                for b, (_, ids, _) in enumerate(chunk):
                    arr[b, : len(ids)] = ids
                logits = llama.forward(params, torch.as_tensor(arr, device=device), cfg)
                for b, (i, ids, nc) in enumerate(chunk):
                    rows = logits[b, len(ids) - nc - 1: len(ids) - 1].float()
                    rows = rows - rows.max(dim=-1, keepdim=True).values
                    logz = torch.log(torch.exp(rows).sum(dim=-1))
                    toks = torch.as_tensor(ids[len(ids) - nc:], device=device)
                    lps = rows[torch.arange(nc, device=device), toks] - logz
                    greedy = bool((rows.argmax(dim=-1) == toks).all())
                    results[i] = (float(lps.sum()), greedy)
    return results  # type: ignore[return-value]


def score_rolling(
    params,
    cfg: LlamaConfig,
    token_lists: Sequence[Sequence[int]],
    max_length: int,
    batch_size: int = 8,
) -> List[float]:
    """Batched full-sequence loglikelihood (loglikelihood_rolling); a
    sequence of fewer than two tokens scores 0."""
    pairs = []
    keep = []
    for ids in token_lists:
        ids = list(ids)[:max_length]
        if len(ids) < 2:
            pairs.append(None)
            continue
        pairs.append((ids[:1], ids[1:]))
        keep.append(len(pairs) - 1)
    scored = score_continuations(params, cfg, [pairs[i] for i in keep], max_length, batch_size)
    out = [0.0] * len(pairs)
    for i, (lp, _) in zip(keep, scored):
        out[i] = lp
    return out


class TorchCausalLM(LM):
    """lm-eval adapter over (params, cfg, tokenizer)."""

    def __init__(self, params, cfg: LlamaConfig, tokenizer, batch_size: int = 8,
                 max_length: Optional[int] = None):
        if not HAS_LM_EVAL:
            raise ImportError(
                "lm_eval is not installed; `pip install lm-eval` to use TorchCausalLM")
        super().__init__()
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length or cfg.max_position_embeddings

    def _encode(self, text: str) -> List[int]:
        return self.tokenizer(text, add_special_tokens=False)["input_ids"]

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        pairs = []
        for req in requests:
            context, continuation = req.args
            ctx_ids = self._encode(context) if context else [self.tokenizer.bos_token_id or 0]
            pairs.append((ctx_ids, self._encode(continuation)))
        return score_continuations(self.params, self.cfg, pairs, self.max_length,
                                   self.batch_size)

    def loglikelihood_rolling(self, requests) -> List[float]:
        token_lists = [self._encode(req.args[0]) for req in requests]
        return score_rolling(self.params, self.cfg, token_lists, self.max_length,
                             self.batch_size)

    def generate_until(self, requests) -> List[str]:
        """Greedy generation through ``serving.engine.generate``, cut at the
        first stop string."""
        from ..serving import engine

        out = []
        for req in requests:
            context, gen_kwargs = req.args
            until = gen_kwargs.get("until", [])
            max_new = gen_kwargs.get("max_gen_toks", 128)
            ctx_ids = np.asarray(self._encode(context), dtype=np.int64)
            toks = engine.generate(self.params, self.cfg, [ctx_ids], max_new_tokens=max_new,
                                   eos_token_id=self.tokenizer.eos_token_id)[0]
            text = self.tokenizer.decode(toks)
            for stop in until:
                idx = text.find(stop)
                if idx >= 0:
                    text = text[:idx]
            out.append(text)
        return out


JaxCausalLM = TorchCausalLM  # the JAX package's name for the adapter


def evaluate(
    params,
    cfg: LlamaConfig,
    tokenizer,
    tasks: List[str],
    num_fewshot: Optional[int] = None,
    batch_size: int = 8,
    limit: Optional[int] = None,
) -> Dict[str, Any]:
    """simple_evaluate wrapper (reference eval/lmeval.py:299-407)."""
    if not HAS_LM_EVAL:
        raise ImportError("lm_eval is not installed")
    lm = TorchCausalLM(params, cfg, tokenizer, batch_size=batch_size)
    return lm_eval.simple_evaluate(model=lm, tasks=tasks, num_fewshot=num_fewshot, limit=limit)
