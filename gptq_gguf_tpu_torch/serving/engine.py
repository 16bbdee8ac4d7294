"""Generation engine: prefill/decode steps + greedy continuous batching.

Port of the contiguous-cache part of ``gptq_gguf_tpu/serving/engine.py``.
B fixed slots; finished requests free their slot and queued requests are
prefilled into it (reusing any KV prefix the slot's previous occupant left)
while other slots keep decoding. Decoding runs in k-step blocks: tokens stay
on the device between the steps of a block and come back to the host once,
as one (k, B) array.

PyTorch runs eagerly, so the JAX package's jitted programs become plain
functions; the cache is updated in place instead of being donated.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.llama import LlamaConfig
from . import model as qmodel
from .model import KVCache
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
    tokens). Returns (next token (0-d int32 on device), logits row, cache)."""
    S = prompt.shape[1]
    n = S if n_valid is None else int(n_valid)
    dev = prompt.device
    # device-side fills, not host tensors: a host-to-device copy would make
    # the host wait for the card
    sub = KVCache([kb[slot:slot + 1] for kb in cache.k],
                  [vb[slot:slot + 1] for vb in cache.v],
                  torch.full((1,), start, dtype=torch.int32, device=dev))
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
) -> List[List[int]]:
    """Greedy batch generation; prompts may differ in length. Runs where
    the params live."""
    if temperature > 0:
        raise NotImplementedError("sampled generation is not ported yet")
    B = len(prompts)
    prompts = [np.atleast_1d(np.asarray(p)).reshape(-1) for p in prompts]
    if any(len(p) == 0 for p in prompts):
        raise ValueError("empty prompt: every prompt needs >= 1 token")
    max_len = max_len or (max(len(p) for p in prompts) + max_new_tokens)
    dev = _params_device(params)
    cache = qmodel.init_cache(cfg, B, max_len, device=dev)

    tokens = torch.zeros((B,), dtype=torch.int32, device=dev)
    fill = np.zeros((B,), np.int64)
    for b, p in enumerate(prompts):
        padded, n = _pad_prompt(p, max_len)
        prompt = torch.as_tensor(padded, dtype=torch.int64, device=dev)[None, :]
        tokens[b], _, cache = _prefill_slot(params, cfg, prompt, cache, b, n)
        fill[b] = n

    outputs: List[List[int]] = [[t] for t in tokens.tolist()]
    done = [False] * B
    for _ in range(max_new_tokens - 1):
        if all(done):
            break
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


class ContinuousBatchingEngine:
    """Slot-based greedy continuous batching over the quantized model.

    submit() enqueues requests; step() admits queued requests into free
    slots and runs one decode step (or one k-step block) for all slots.
    The engine runs on the device its params live on.
    """

    def __init__(self, params, cfg: LlamaConfig, num_slots: int = 8,
                 max_len: int = 2048, eos_token_id: Optional[int] = None,
                 multi_step="auto"):
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos = eos_token_id
        # "auto": pick the block size per step (see _auto_block); an int
        # fixes it (1 = one token per step)
        self.multi_step = 0 if multi_step == "auto" else max(1, int(multi_step))
        self.device = _params_device(params)
        self.cache = qmodel.init_cache(cfg, num_slots, max_len, device=self.device)
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
               sampling_params: Optional[SamplingParams] = None) -> int:
        self._uid += 1
        if np.asarray(prompt).size == 0:
            raise ValueError("empty prompt: every request needs >= 1 token")
        # the cache must hold at least one prompt token plus the new tokens
        max_new_tokens = min(max_new_tokens, self.max_len - 1)
        self.queue.append(Request(self._uid, np.asarray(prompt).reshape(-1),
                                  max_new_tokens, sampling=sampling_params or GREEDY))
        return self._uid

    def _admit_into(self, slot: int, req: Request) -> None:
        """Prefill ``req`` into ``slot``, reusing any shared KV prefix the
        slot's previous occupant left behind."""
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
        tok, _, self.cache = _prefill_slot(
            self.params, self.cfg,
            torch.as_tensor(padded, device=self.device)[None, :],
            self.cache, slot, n, start=shared)
        self.tokens[slot] = tok
        self._fill[slot] = shared + n
        req.output.append(int(tok))
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

    def step(self) -> int:
        """Admit + one decode step (or one multi_step block); returns the
        number of active slots."""
        self._admit()
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        k = self.multi_step or self._auto_block(active)
        if k > 1:
            return self._step_block(active, k)
        fed = self.tokens.tolist()  # decode inputs land in the KV cache
        self.tokens, _, self.cache = _decode_step(
            self.params, self.cfg, self.tokens, self.cache, int(self._fill.max()))
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
        self.tokens, toks, self.cache = _decode_steps_scan(
            self.params, self.cfg, self.tokens, self.cache, k, int(self._fill.max()))
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
