"""Generation engine: prefill/decode steps + continuous batching.

Port of the dense-Llama engines of ``gptq_gguf_tpu/serving/engine.py``.
``ContinuousBatchingEngine`` (contiguous cache: bf16, int8 or int4): B
fixed slots; finished requests free their slot and queued requests are
prefilled into it (reusing any KV prefix the slot's previous occupant left)
while other slots keep decoding. Decoding runs in k-step blocks: tokens
stay on the device between the steps of a block and come back to the host
once, as one (k, B) array. ``PagedContinuousBatchingEngine`` (paged cache):
slots own pages of shared pools, admission waits for free pages, one
decode step per ``step()``.

Each request carries its own sampling settings (``sampling.SamplingParams``):
a batch with any non-trivial request runs the per-slot sampler chain
(penalty counts, seeds and draw counters stay on the device); an
all-greedy batch takes the argmax. Requests may ask for the top-k
logprobs of every generated token (single steps then, as in the JAX
package).

PyTorch runs eagerly, so the JAX package's jitted programs become plain
functions; the cache and the sampler state are updated in place instead of
being donated.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.llama import LlamaConfig
from . import model as qmodel, paged, sampling
from .model import KVCache
from .paged import PagedKVCache
from .sampling import GREEDY, SamplingParams

# multi_step="auto" block-size caps: 128 when nobody waits, 8 while requests
# are queued (a retiring slot turns over at the next block edge)
MULTI_STEP_AUTO_CAP = 128
MULTI_STEP_ADMIT_CAP = 8


def _decode_step(params, cfg: LlamaConfig, tokens: torch.Tensor, cache: KVCache,
                 fill_max: Optional[int] = None):
    """One greedy decode step for all slots. tokens: (B,) int32 on device."""
    logits, cache = qmodel.forward_cached(params, cfg, tokens[:, None], cache,
                                          fill_max=fill_max)
    next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    return next_tokens, logits, cache


def _decode_steps_scan(params, cfg: LlamaConfig, tokens: torch.Tensor,
                       cache: KVCache, k: int, fill_max: Optional[int] = None):
    """k greedy decode steps; the fed tokens never leave the device and the
    caller reads the (k, B) block back once. ``fill_max`` is the host
    mirror of max(cache.lengths) before the block."""
    rows = []
    for j in range(k):
        fm = None if fill_max is None else fill_max + j
        tokens, _, cache = _decode_step(params, cfg, tokens, cache, fm)
        rows.append(tokens)
    return tokens, torch.stack(rows), cache  # (k, B)


def _kv_dtype(kv_quantized) -> Optional[str]:
    """The engine-facing kv_quantized knob: bools keep the JAX package's
    int8 meaning, strings name a cache dtype ("bf16" | "int8" | "int4")."""
    if isinstance(kv_quantized, str):
        return kv_quantized
    return "int8" if kv_quantized else None


def _sampled_decode_step(params, cfg: LlamaConfig, tokens: torch.Tensor, cache,
                         sampler: sampling.SlotSampling, fill_max: Optional[int] = None):
    """Decode step through the per-slot sampler chain. The fed tokens are
    counted here (each generated token is fed exactly once; prompt tokens
    were counted at admit), so penalty counts, seeds and draw counters stay
    on the device."""
    sampling.count_tokens(sampler, tokens)
    logits, cache = qmodel.forward_cached(params, cfg, tokens[:, None], cache,
                                          fill_max=fill_max)
    next_tokens, sampler = sampling.sample_step(logits, sampler)
    return next_tokens, logits, sampler, cache


def _sampled_decode_steps_scan(params, cfg: LlamaConfig, tokens: torch.Tensor, cache,
                               sampler: sampling.SlotSampling, k: int,
                               fill_max: Optional[int] = None):
    """k sampled decode steps; tokens, counts and draw counters stay on the
    device and the caller reads the (k, B) block back once."""
    rows = []
    for j in range(k):
        fm = None if fill_max is None else fill_max + j
        tokens, _, sampler, cache = _sampled_decode_step(params, cfg, tokens, cache,
                                                         sampler, fm)
        rows.append(tokens)
    return tokens, torch.stack(rows), sampler, cache  # (k, B)


def _sample_step(params, cfg: LlamaConfig, tokens: torch.Tensor, cache, seeds: torch.Tensor,
                 draws: torch.Tensor, vocab_hash: torch.Tensor, temperature: float,
                 fill_max: Optional[int] = None):
    """``generate``'s sampled step: categorical over logits / temperature,
    by Gumbel-max with the noise of each row's (seed, draw)."""
    logits, cache = qmodel.forward_cached(params, cfg, tokens[:, None], cache,
                                          fill_max=fill_max)
    noisy = logits / max(temperature, 1e-6) + sampling.gumbel_noise(seeds, draws, vocab_hash)
    return torch.argmax(noisy, dim=-1).to(torch.int32), logits, cache


def _topk_logprobs(logits: torch.Tensor, chosen: torch.Tensor, k: int):
    """log-softmax top-k and the chosen tokens' logprobs, on the device (the
    host reads (B, k) values, not the (B, V) logits)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    vals, ids = torch.topk(lp, k, dim=-1)
    chosen_lp = torch.gather(lp, -1, chosen.long()[:, None])[:, 0]
    return vals, ids, chosen_lp


def _note_logprobs(req: "Request", tok: torch.Tensor, logits_row: torch.Tensor) -> None:
    """The (chosen logprob, top ids, top logprobs) entry of an admitted
    request's first token (``tok`` a 0-d tensor on the device)."""
    vals, ids, chosen = _topk_logprobs(logits_row[None, :], tok.reshape(1), req.logprobs)
    req.logprob_data.append((float(chosen[0]), ids[0].tolist(), vals[0].tolist()))


def _note_step_logprobs(slot_req, lp_slots, logits: torch.Tensor, tokens: torch.Tensor) -> None:
    """Append each logprob request's entry for the step's token."""
    kmax = max(slot_req[s].logprobs for s in lp_slots)
    vals, ids, chosen = _topk_logprobs(logits, tokens, kmax)
    vals, ids, chosen = vals.tolist(), ids.tolist(), chosen.tolist()
    for s in lp_slots:
        n = slot_req[s].logprobs
        slot_req[s].logprob_data.append((chosen[s], ids[s][:n], vals[s][:n]))


_PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def _bucket_len(n: int, max_len: Optional[int] = None) -> int:
    for b in _PREFILL_BUCKETS:
        if n <= b and (max_len is None or b <= max_len):
            return b
    return n


def _pad_prompt(prompt: np.ndarray, max_len: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Right-pad to the next length bucket (a few prefill shapes instead of
    one per prompt length)."""
    n = len(prompt)
    b = max(_bucket_len(n, max_len), n)
    if b == n:
        return prompt, n
    out = np.zeros((b,), prompt.dtype)
    out[:n] = prompt
    return out, n


def _prefill_slot(params, cfg: LlamaConfig, prompt: torch.Tensor, cache: KVCache,
                  slot: int, n_valid: Optional[int] = None, start: int = 0):
    """Prefill one slot with a (1, S) prompt, IN PLACE: the slot's K/V rows
    and its length are written into ``cache``; other slots are untouched.

    prompt may be right-padded; n_valid is the true token count (defaults
    to S). ``start`` places the new tokens at positions start..start+S
    (prefix reuse: the slot already holds KV for the first ``start``
    tokens). Returns (next token (0-d int32 on device), logits row, cache).
    Works for the bf16, int8 and int4 caches (the slot's codes and scales)."""
    S = prompt.shape[1]
    n = S if n_valid is None else int(n_valid)
    dev = prompt.device
    # device-side fills, not host tensors: a host-to-device copy would make
    # the host wait for the card
    sub = qmodel.slot_view(cache, slot, torch.full((1,), start, dtype=torch.int32, device=dev))
    logits, _ = qmodel.forward_cached(
        params, cfg, prompt, sub,
        n_valid=torch.full((1,), n, dtype=torch.int32, device=dev))
    cache.lengths[slot] = start + n
    next_token = torch.argmax(logits[0], dim=-1).to(torch.int32)
    return next_token, logits[0], cache


def _params_device(params) -> torch.device:
    return params["embed_tokens"].device


def generate(
    params,
    cfg: LlamaConfig,
    prompts: Sequence[np.ndarray],
    max_new_tokens: int = 32,
    *,
    max_len: Optional[int] = None,
    eos_token_id: Optional[int] = None,
    temperature: float = 0.0,
    seed: int = 0,
    kv_quantized=False,
) -> List[List[int]]:
    """Batch generation (greedy, or sampled at ``temperature`` > 0 from
    ``seed``); prompts may differ in length. Runs where the params live.
    As in the JAX package the prefill's token is the argmax, and each later
    step draws from logits / temperature (row b of step j with draw number
    j * B + b of the seed). kv_quantized: False / True (int8) or a
    kv_dtype string ("bf16" | "int8" | "int4")."""
    B = len(prompts)
    prompts = [np.atleast_1d(np.asarray(p)).reshape(-1) for p in prompts]
    if any(len(p) == 0 for p in prompts):
        raise ValueError("empty prompt: every prompt needs >= 1 token")
    max_len = max_len or (max(len(p) for p in prompts) + max_new_tokens)
    dev = _params_device(params)
    cache = qmodel.init_cache(cfg, B, max_len, kv_dtype=_kv_dtype(kv_quantized), device=dev)

    tokens = torch.zeros((B,), dtype=torch.int32, device=dev)
    fill = np.zeros((B,), np.int64)
    for b, p in enumerate(prompts):
        padded, n = _pad_prompt(p, max_len)
        prompt = torch.as_tensor(padded, dtype=torch.int64, device=dev)[None, :]
        tokens[b], _, cache = _prefill_slot(params, cfg, prompt, cache, b, n)
        fill[b] = n
    if temperature > 0:
        seeds = torch.full((B,), sampling._seed64(seed), dtype=torch.int64, device=dev)
        draws = torch.arange(B, dtype=torch.int64, device=dev)
        vhash = sampling.vocab_hash(cfg.vocab_size, dev)

    outputs: List[List[int]] = [[t] for t in tokens.tolist()]
    done = [False] * B
    for _ in range(max_new_tokens - 1):
        if all(done):
            break
        if temperature > 0:
            tokens, _, cache = _sample_step(params, cfg, tokens, cache, seeds, draws, vhash,
                                            temperature, int(fill.max()))
            draws = draws + B
        else:
            tokens, _, cache = _decode_step(params, cfg, tokens, cache, int(fill.max()))
        fill += 1
        for b, t in enumerate(tokens.tolist()):
            if not done[b]:
                outputs[b].append(t)
                done[b] = eos_token_id is not None and t == eos_token_id
    return outputs


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_at: float = dataclasses.field(default_factory=time.time)
    finished_at: Optional[float] = None
    sampling: SamplingParams = GREEDY
    finish_reason: Optional[str] = None  # "stop" (eos), "length" or "cancelled"
    logprobs: int = 0  # top-k logprobs per generated token (0 = off)
    # one (chosen_logprob, top_ids, top_logprobs) triple per output token
    logprob_data: List[Tuple[float, List[int], List[float]]] = \
        dataclasses.field(default_factory=list)


class ContinuousBatchingEngine:
    """Slot-based continuous batching over the quantized model.

    submit() enqueues requests; step() admits queued requests into free
    slots and runs one decode step (or one k-step block) for all slots.
    The engine runs on the device its params live on. kv_quantized: False
    (bf16 cache), True / "int8" or "int4" (quantized caches). temperature
    > 0 makes that the default request's sampler; ``seed`` seeds the
    fallback seeds of requests that name none (seed * 1000003 + uid).
    """

    def __init__(self, params, cfg: LlamaConfig, num_slots: int = 8,
                 max_len: int = 2048, eos_token_id: Optional[int] = None,
                 kv_quantized=False, temperature: float = 0.0, seed: int = 0,
                 multi_step="auto"):
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos = eos_token_id
        # "auto": pick the block size per step (see _auto_block); an int
        # fixes it (1 = one token per step); logprob requests take single
        # steps either way
        self.multi_step = 0 if multi_step == "auto" else max(1, int(multi_step))
        self.default_sampling = (SamplingParams(temperature=temperature) if temperature > 0
                                 else GREEDY)
        self._seed_base = seed * 1000003  # per-request fallback seeds
        self.device = _params_device(params)
        self.sampler = sampling.init_state(num_slots, cfg.vocab_size, device=self.device)
        self.cache = qmodel.init_cache(cfg, num_slots, max_len,
                                       kv_dtype=_kv_dtype(kv_quantized), device=self.device)
        self.tokens = torch.zeros((num_slots,), dtype=torch.int32, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        # host mirror of cache.lengths (no readback per step; also the
        # chunk count of the decode attention and the out-of-cache checks)
        self._fill = np.zeros((num_slots,), np.int64)
        # per-slot token history whose KV occupies positions 0..fill-1;
        # dropped once the slot sits idle through a decode step
        self.slot_hist: List[Optional[List[int]]] = [None] * num_slots
        self.queue: deque = deque()
        self._uid = 0
        self.completed: List[Request] = []
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 64,
               sampling_params: Optional[SamplingParams] = None, logprobs: int = 0) -> int:
        self._uid += 1
        if np.asarray(prompt).size == 0:
            raise ValueError("empty prompt: every request needs >= 1 token")
        # the cache must hold at least one prompt token plus the new tokens
        max_new_tokens = min(max_new_tokens, self.max_len - 1)
        self.queue.append(Request(self._uid, np.asarray(prompt).reshape(-1),
                                  max_new_tokens,
                                  sampling=sampling_params or self.default_sampling,
                                  logprobs=int(logprobs)))
        return self._uid

    def _admit_into(self, slot: int, req: Request) -> None:
        """Prefill ``req`` into ``slot``, reusing any shared KV prefix the
        slot's previous occupant left behind; reset the slot's sampler row
        (on every admit: a stale row would leak into a later trivial
        request through the batched sampled step) and sample the first
        token through it."""
        keep = max(1, self.max_len - req.max_new_tokens)
        prompt = list(map(int, req.prompt[-keep:]))
        hist = self.slot_hist[slot]
        shared = 0
        if hist:
            limit = min(len(hist), len(prompt) - 1)
            while shared < limit and hist[shared] == prompt[shared]:
                shared += 1
        if shared:
            self.prefix_hits += 1
            self.prefix_tokens_reused += shared
        padded, n = _pad_prompt(np.asarray(prompt[shared:], dtype=np.int64), self.max_len)
        # one copy to the device: the prompt for the counts, its padded
        # remainder for the prefill
        ids = torch.as_tensor(np.concatenate([np.asarray(prompt[:shared], np.int64), padded]),
                              device=self.device)
        tok, logits, self.cache = _prefill_slot(
            self.params, self.cfg, ids[None, shared:], self.cache, slot, n, start=shared)
        sampling.set_slot(self.sampler, slot, req.sampling, ids[:shared + n],
                          fallback_seed=self._seed_base + req.uid)
        if not req.sampling.is_greedy:
            tok, _ = sampling.sample_slot(logits, self.sampler, slot)
        self.tokens[slot] = tok
        self._fill[slot] = shared + n
        req.output.append(int(tok))
        if req.logprobs:
            _note_logprobs(req, tok, logits)
        self.slot_req[slot] = req
        self.slot_hist[slot] = prompt

    def _admit(self) -> None:
        for slot in range(self.num_slots):
            if self.slot_req[slot] is None and self.queue:
                self._admit_into(slot, self.queue.popleft())

    def _retire(self, slot: int, reason: str) -> None:
        req = self.slot_req[slot]
        req.done = True
        req.finish_reason = reason
        req.finished_at = time.time()
        self.slot_req[slot] = None

    def _reset_slot(self, slot: int) -> None:
        self.slot_hist[slot] = None
        self._fill[slot] = 0
        self.cache.lengths[slot] = 0

    def cancel(self, uid: int) -> bool:
        """Drop a queued or in-flight request; frees the slot at once."""
        for i, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[i]
                return True
        for slot, r in enumerate(self.slot_req):
            if r is not None and r.uid == uid:
                self._retire(slot, "cancelled")
                self._reset_slot(slot)
                return True
        return False

    def _sampled(self, active) -> bool:
        return any(not self.slot_req[s].sampling.is_trivial for s in active)

    def step(self) -> int:
        """Admit + one decode step (or one multi_step block); returns the
        number of active slots."""
        self._admit()
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        lp_slots = [s for s in active if self.slot_req[s].logprobs]
        if self.multi_step != 1 and not lp_slots:
            k = self.multi_step or self._auto_block(active)
            if k > 1:
                return self._step_block(active, k)
        fed = self.tokens.tolist()  # decode inputs land in the KV cache
        fill_max = int(self._fill.max())
        if self._sampled(active):
            self.tokens, logits, self.sampler, self.cache = _sampled_decode_step(
                self.params, self.cfg, self.tokens, self.cache, self.sampler, fill_max)
        else:
            self.tokens, logits, self.cache = _decode_step(
                self.params, self.cfg, self.tokens, self.cache, fill_max)
        if lp_slots:
            _note_step_logprobs(self.slot_req, lp_slots, logits, self.tokens)
        host = self.tokens.tolist()
        self._fill += 1
        for slot in range(self.num_slots):
            if self.slot_req[slot] is not None:
                if self.slot_hist[slot] is not None:
                    self.slot_hist[slot].append(fed[slot])
            else:
                # idle slots still get garbage KV writes from the batched
                # step: their cached prefix is no longer trustworthy
                self.slot_hist[slot] = None
        for slot in active:
            req = self.slot_req[slot]
            req.output.append(host[slot])
            hit_eos = self.eos is not None and host[slot] == self.eos
            if (hit_eos or len(req.output) >= req.max_new_tokens
                    or self._fill[slot] >= self.max_len - 1):
                self._retire(slot, "stop" if hit_eos else "length")
                self.completed.append(req)
                if self.queue:
                    # admit at once: the retiring slot's KV prefix is intact
                    self._admit_into(slot, self.queue.popleft())
                else:
                    self._reset_slot(slot)
        return len(active)

    def _auto_block(self, active) -> int:
        """Largest power of two <= the cap (MULTI_STEP_ADMIT_CAP while
        requests wait, else MULTI_STEP_AUTO_CAP) that fits the smallest
        remaining token budget and the cache headroom of the fullest slot."""
        budget = min(self.slot_req[s].max_new_tokens - len(self.slot_req[s].output)
                     for s in active)
        headroom = int(self.max_len - 1 - max(self._fill[s] for s in active))
        cap = MULTI_STEP_ADMIT_CAP if self.queue else MULTI_STEP_AUTO_CAP
        k = min(cap, max(1, budget), max(1, headroom))
        return 1 << (k.bit_length() - 1)

    def _step_block(self, active, k: int) -> int:
        """k decode steps with one (k, B) readback. Retired slots keep
        decoding garbage to the block's end (outputs dropped; their KV
        prefix below the retire point stays intact for prefix reuse, and
        writes past max_len land in the cache's drop row). Admits happen at
        block edges."""
        fed_prev = self.tokens.tolist()
        fill_max = int(self._fill.max())
        if self._sampled(active):
            self.tokens, toks, self.sampler, self.cache = _sampled_decode_steps_scan(
                self.params, self.cfg, self.tokens, self.cache, self.sampler, k, fill_max)
        else:
            self.tokens, toks, self.cache = _decode_steps_scan(
                self.params, self.cfg, self.tokens, self.cache, k, fill_max)
        host = toks.tolist()  # one readback per block
        for j in range(k):
            for slot in range(self.num_slots):
                if self.slot_req[slot] is not None and self.slot_hist[slot] is not None:
                    self.slot_hist[slot].append(fed_prev[slot])
            for slot in range(self.num_slots):
                req = self.slot_req[slot]
                if req is None:
                    continue
                tok = host[j][slot]
                req.output.append(tok)
                hit_eos = self.eos is not None and tok == self.eos
                if (hit_eos or len(req.output) >= req.max_new_tokens
                        or self._fill[slot] + j + 1 >= self.max_len - 1):
                    self._retire(slot, "stop" if hit_eos else "length")
                    self.completed.append(req)
            fed_prev = host[j]
        self._fill += k
        return len(active)

    def run_until_done(self, max_steps: int = 100000) -> List[Request]:
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.completed


# ---------------------------------------------------------------------------
# Paged continuous batching (block-table KV, vLLM-style)
# ---------------------------------------------------------------------------


def _paged_decode_step(params, cfg: LlamaConfig, tokens: torch.Tensor, cache: PagedKVCache):
    """One greedy decode step for all slots of a paged cache (in place)."""
    logits, cache = paged.forward_paged(params, cfg, tokens[:, None], cache)
    return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache


def _paged_sampled_decode_step(params, cfg: LlamaConfig, tokens: torch.Tensor,
                               cache: PagedKVCache, sampler: sampling.SlotSampling):
    """One decode step of a paged cache through the per-slot sampler chain
    (the fed tokens counted first, as in ``_sampled_decode_step``)."""
    sampling.count_tokens(sampler, tokens)
    logits, cache = paged.forward_paged(params, cfg, tokens[:, None], cache)
    next_tokens, sampler = sampling.sample_step(logits, sampler)
    return next_tokens, logits, sampler, cache


def _paged_prefill_slot(params, cfg: LlamaConfig, prompt: torch.Tensor, cache: PagedKVCache,
                        slot: int, n_valid: int):
    """Prefill one slot of a paged cache with a (1, S) right-padded prompt
    (its pages must be assigned), IN PLACE, through a one-row view of the
    table over the shared pools: other slots' pages and lengths are not
    touched. Returns (next token (0-d int32 on device), logits row, cache)."""
    dev = prompt.device
    sub = PagedKVCache(cache.k_pages, cache.v_pages, cache.page_table[slot:slot + 1],
                       torch.zeros((1,), dtype=torch.int32, device=dev))
    logits, _ = paged.forward_paged(
        params, cfg, prompt, sub, n_valid=torch.full((1,), n_valid, dtype=torch.int32,
                                                     device=dev))
    cache.lengths[slot] = n_valid
    return torch.argmax(logits[0], dim=-1).to(torch.int32), logits[0], cache


_PAGED_KV = {False: None, "int4": "int4"}  # kv_quantized -> init_paged_cache kv_dtype


class PagedContinuousBatchingEngine:
    """Continuous batching over the paged KV cache.

    Pages come from a shared pool, possibly oversubscribed (fewer pages
    than slots x max_len / page_size): a request is admitted only when its
    worst-case page need (prompt plus budget, never above max_len) fits,
    so decode never needs another page. One decode step per ``step()``.
    kv_quantized: False (bf16 pools) or "int4" (combined int4 pools).
    Requests sample as in ``ContinuousBatchingEngine`` (fallback seeds
    seed * 1000003 + uid). The engine runs on ``device`` (the card unless
    the caller asks for the CPU), where its params must live.
    """

    def __init__(self, params, cfg: LlamaConfig, num_slots: int = 8, max_len: int = 2048,
                 page_size: int = 64, n_pages: Optional[int] = None,
                 eos_token_id: Optional[int] = None, seed: int = 0, kv_quantized=False,
                 device="cuda"):
        if kv_quantized not in _PAGED_KV:
            raise ValueError(f"kv_quantized must be False or 'int4', got {kv_quantized!r}")
        self.device = resolve_device(device)
        if _params_device(params).type != self.device.type:
            raise ValueError(f"params live on {_params_device(params)}, not on {self.device}")
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.page_size = page_size
        self.eos = eos_token_id
        self.cache = paged.init_paged_cache(cfg, num_slots, max_len, page_size, n_pages,
                                            kv_dtype=_PAGED_KV[kv_quantized],
                                            device=self.device)
        self.alloc = paged.PageAllocator(self.cache.n_pages)
        self._seed_base = seed * 1000003
        self.sampler = sampling.init_state(num_slots, cfg.vocab_size, device=self.device)
        self.slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
        self.tokens = torch.zeros((num_slots,), dtype=torch.int32, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        # host mirror of cache.lengths for the live slots (no readback per step)
        self._fill = np.zeros((num_slots,), np.int64)
        # 1 for a live slot: idle slots' lengths stay 0, so the kernel reads
        # one page for them however long they sit idle
        self._live = torch.zeros((num_slots,), dtype=torch.int32, device=self.device)
        self.queue: deque = deque()
        self._uid = 0
        self.completed: List[Request] = []

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 64,
               sampling_params: Optional[SamplingParams] = None, logprobs: int = 0) -> int:
        if np.asarray(prompt).size == 0:
            raise ValueError("empty prompt: every request needs >= 1 token")
        self._uid += 1
        max_new_tokens = min(max_new_tokens, self.max_len - 1)
        self.queue.append(Request(self._uid, np.asarray(prompt).reshape(-1), max_new_tokens,
                                  sampling=sampling_params or GREEDY, logprobs=int(logprobs)))
        return self._uid

    def _set_table_row(self, slot: int, pages: List[int]) -> None:
        row = np.full((self.cache.page_table.shape[1],), -1, np.int32)
        row[:len(pages)] = pages
        self.cache.page_table[slot] = torch.from_numpy(row).to(self.device)

    def _admit(self) -> None:
        for slot in range(self.num_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            keep = max(1, self.max_len - req.max_new_tokens)
            prompt = req.prompt[-keep:]
            # the prompt is cut so that prompt + budget <= max_len, a whole
            # number of pages: the table row always holds the need
            need = -(-(len(prompt) + req.max_new_tokens) // self.page_size)
            pages = self.alloc.alloc(need)
            if pages is None:
                return  # pool exhausted: wait for retirements
            self.queue.popleft()
            self.slot_pages[slot] = pages
            self._set_table_row(slot, pages)
            padded, n = _pad_prompt(np.asarray(prompt, dtype=np.int64), self.max_len)
            ids = torch.as_tensor(padded, device=self.device)
            tok, logits, self.cache = _paged_prefill_slot(
                self.params, self.cfg, ids[None, :], self.cache, slot, n)
            sampling.set_slot(self.sampler, slot, req.sampling, ids[:n],
                              fallback_seed=self._seed_base + req.uid)
            if not req.sampling.is_greedy:
                tok, _ = sampling.sample_slot(logits, self.sampler, slot)
            self.tokens[slot] = tok
            self._live[slot] = 1
            self._fill[slot] = n
            req.output.append(int(tok))
            if req.logprobs:
                _note_logprobs(req, tok, logits)
            self.slot_req[slot] = req

    def _free_slot(self, slot: int, reason: str) -> Request:
        """Retire the slot's request and return its pages to the pool."""
        req = self.slot_req[slot]
        req.done = True
        req.finish_reason = reason
        req.finished_at = time.time()
        self.slot_req[slot] = None
        self.alloc.release(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self._set_table_row(slot, [])
        self.cache.lengths[slot] = 0
        self._live[slot] = 0
        self._fill[slot] = 0
        return req

    def cancel(self, uid: int) -> bool:
        """Drop a queued or in-flight request, releasing its pages."""
        for i, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[i]
                return True
        for slot, r in enumerate(self.slot_req):
            if r is not None and r.uid == uid:
                self._free_slot(slot, "cancelled")
                return True
        return False

    def step(self) -> int:
        """Admit, then one decode step for all slots; returns the number of
        active slots."""
        self._admit()
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        if any(not self.slot_req[s].sampling.is_trivial for s in active):
            self.tokens, logits, self.sampler, self.cache = _paged_sampled_decode_step(
                self.params, self.cfg, self.tokens, self.cache, self.sampler)
        else:
            self.tokens, logits, self.cache = _paged_decode_step(
                self.params, self.cfg, self.tokens, self.cache)
        self.cache = self.cache._replace(lengths=self.cache.lengths * self._live)
        lp_slots = [s for s in active if self.slot_req[s].logprobs]
        if lp_slots:
            _note_step_logprobs(self.slot_req, lp_slots, logits, self.tokens)
        host = self.tokens.tolist()
        for slot in active:
            self._fill[slot] += 1
            req = self.slot_req[slot]
            req.output.append(host[slot])
            hit_eos = self.eos is not None and host[slot] == self.eos
            if (hit_eos or len(req.output) >= req.max_new_tokens
                    or self._fill[slot] >= self.max_len - 1):
                self.completed.append(self._free_slot(slot, "stop" if hit_eos else "length"))
        return len(active)

    def run_until_done(self, max_steps: int = 100000) -> List[Request]:
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) and steps < max_steps:
            if self.step() == 0 and self.queue:
                raise RuntimeError("page pool too small to admit any queued request")
            steps += 1
        return self.completed
