"""Per-slot batched sampling for the serving engine.

Port of ``gptq_gguf_tpu/serving/sampling.py``: llama.cpp's sampler chain
(penalties -> top-k -> top-p -> min-p -> temperature -> dist) over the
whole (B, V) logits batch with per-slot parameter rows, so a batch mixing
greedy and sampled requests, each with its own settings, is one pass of
tensor operations on the device per step. Semantics follow llama.cpp:

- repetition_penalty: seen tokens' positive logits divided, negative ones
  multiplied (llama.cpp's penalties sampler);
- presence / frequency penalties: subtractive, from the per-slot token
  counts (prompt + generated so far);
- top_k <= 0 disables; top_p keeps the smallest prefix of the sorted
  distribution whose exclusive cumulative probability is < top_p (at
  least one token); min_p keeps tokens with prob >= min_p * max_prob;
- temperature <= 0 means greedy (argmax of the penalized logits).

One descending sort of the scaled logits serves top-k, top-p and min-p;
masked entries get finfo(f32).min.

The random draw. The JAX package draws with threefry keys split per step,
which torch cannot replay. Here each slot carries (seed, draw counter) on
the device, and a draw is Gumbel-max (``jax.random.categorical`` is
argmax(logits + gumbel) too) with noise made by an integer hash of (seed,
counter, vocab index) in int64 tensor operations: every product stays
below 2**49, so the bits are the same on the CPU and on the card, and a
slot's draws depend on its own seed and draw count only (not on its slot,
its batch-mates or the block size). No torch.Generator is involved.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["SamplingParams", "GREEDY", "SlotSampling", "init_state", "set_slot",
           "sample", "sample_step", "sample_slot", "count_tokens", "gumbel_noise",
           "vocab_hash"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling settings (llama.cpp sampler-chain analogue)."""

    temperature: float = 0.0   # <= 0 -> greedy
    top_k: int = 0             # <= 0 -> disabled
    top_p: float = 1.0
    min_p: float = 0.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    seed: Optional[int] = None  # per-request seed (reproducible sampling)

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0

    @property
    def is_trivial(self) -> bool:
        """Greedy with no penalties: the plain argmax decode path applies."""
        return (self.is_greedy and self.presence_penalty == 0.0
                and self.frequency_penalty == 0.0
                and self.repetition_penalty == 1.0)


GREEDY = SamplingParams()


class SlotSampling(NamedTuple):
    """Per-slot sampler state on the engine's device (one row per slot),
    updated in place."""

    temperature: torch.Tensor  # (B,) f32
    top_k: torch.Tensor        # (B,) i32
    top_p: torch.Tensor        # (B,) f32
    min_p: torch.Tensor        # (B,) f32
    presence: torch.Tensor     # (B,) f32
    frequency: torch.Tensor    # (B,) f32
    repetition: torch.Tensor   # (B,) f32
    counts: torch.Tensor       # (B, V) i32 token counts (prompt + generated)
    seeds: torch.Tensor        # (B,) i64 per-slot seeds (set at admit)
    draws: torch.Tensor        # (B,) i64 draws made since the admit
    vocab_hash: torch.Tensor   # (V,) i64 the vocab indices' hashes (constant)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for 0 <= x < 2**32, in 16-bit halves: every product
    stays below 2**48 (signed int64 overflow is not portable)."""
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (hi + (x & 0xFFFF) * c) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash ("lowbias32") of each element."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def vocab_hash(vocab_size: int, device) -> torch.Tensor:
    """(V,) int64 hashes of the vocab indices (the per-element half of the
    noise's key)."""
    return _mix32(torch.arange(vocab_size, dtype=torch.int64, device=device) ^ 0xA4093822)


def _row_keys(seeds: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """(B,) 32-bit keys of each row's (seed, draw counter)."""
    k = _mix32((seeds & _M32) ^ 0x243F6A88)
    k = _mix32(k ^ ((seeds >> 32) & _M32) ^ 0x85A308D3)
    k = _mix32(k ^ (draws & _M32) ^ 0x13198A2E)
    return _mix32(k ^ ((draws >> 32) & _M32) ^ 0x03707344)


def gumbel_noise(seeds: torch.Tensor, draws: torch.Tensor,
                 vocab_hash_: torch.Tensor) -> torch.Tensor:
    """(B, V) f32 standard Gumbel noise of each row's (seed, draw):
    -log(-log u) of the uniform of each element's hashed bits."""
    bits = _mix32(_row_keys(seeds, draws)[:, None] ^ vocab_hash_[None, :])
    return -torch.log(-torch.log(_uniform(bits)))


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """u = (k + 0.5) / 2**23 of the top 23 of 32 hashed bits: exact in f32
    and within [2**-24, 1 - 2**-24], so its Gumbel noise is finite (with
    24 bits the top value rounds to 1.0, whose noise is +inf)."""
    return ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def _seed64(seed: int) -> int:
    """A Python int seed as the int64 the state holds (mod 2**64)."""
    seed %= 1 << 64
    return seed - (1 << 64) if seed >= 1 << 63 else seed


def init_state(num_slots: int, vocab_size: int, device="cpu") -> SlotSampling:
    def z(dtype=torch.float32):
        return torch.zeros((num_slots,), dtype=dtype, device=device)

    return SlotSampling(
        temperature=z(), top_k=z(torch.int32),
        top_p=torch.ones((num_slots,), dtype=torch.float32, device=device), min_p=z(),
        presence=z(), frequency=z(),
        repetition=torch.ones((num_slots,), dtype=torch.float32, device=device),
        counts=torch.zeros((num_slots, vocab_size), dtype=torch.int32, device=device),
        seeds=z(torch.int64), draws=z(torch.int64),
        vocab_hash=vocab_hash(vocab_size, device),
    )


def set_slot(state: SlotSampling, slot: int, sp: SamplingParams,
             prompt: Optional[torch.Tensor] = None,
             fallback_seed: int = 0) -> SlotSampling:
    """Reset one slot's row for a newly admitted request, in place. The
    prompt's token counts (ids modulo V) are a bincount on the device
    (``scatter_add_``: ``torch.bincount`` on a card reads its maximum back
    to the host). The slot's seed is sp.seed or ``fallback_seed`` (the
    engine's, from the request uid); its draw counter restarts at 0."""
    V = state.counts.shape[1]
    for field, value in (("temperature", sp.temperature), ("top_k", sp.top_k),
                         ("top_p", sp.top_p), ("min_p", sp.min_p),
                         ("presence", sp.presence_penalty),
                         ("frequency", sp.frequency_penalty),
                         ("repetition", sp.repetition_penalty)):
        getattr(state, field)[slot] = value
    row = state.counts[slot]
    row.zero_()
    if prompt is not None and len(prompt):
        ids = torch.as_tensor(prompt, device=row.device).reshape(-1).to(torch.int64) % V
        row.scatter_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
    state.seeds[slot] = _seed64(sp.seed if sp.seed is not None else fallback_seed)
    state.draws[slot] = 0
    return state


def _rows(state: SlotSampling, sl: slice) -> SlotSampling:
    """The state of the slots in ``sl`` (views; vocab_hash shared)."""
    return SlotSampling(*(t if name == "vocab_hash" else t[sl]
                          for name, t in zip(SlotSampling._fields, state)))


def sample(logits: torch.Tensor, state: SlotSampling) -> torch.Tensor:
    """(B,) int32 tokens of one step over (B, V) logits with each row's
    current (seed, draw); the counters are not advanced."""
    masked, penalized, greedy = _chain(logits, state)
    noisy = masked + gumbel_noise(state.seeds, state.draws, state.vocab_hash)
    sampled = torch.argmax(noisy, dim=-1)
    return torch.where(greedy, torch.argmax(penalized, dim=-1), sampled).to(torch.int32)


def sample_step(logits: torch.Tensor, state: SlotSampling
                ) -> Tuple[torch.Tensor, SlotSampling]:
    """One decode-time step: (B,) tokens, and every slot's draw counter
    advanced (greedy slots' too, as JAX splits every slot's key)."""
    toks = sample(logits, state)
    state.draws.add_(1)
    return toks, state


def sample_slot(logits_row: torch.Tensor, state: SlotSampling, slot: int
                ) -> Tuple[torch.Tensor, SlotSampling]:
    """Sample one token for one slot with its own settings, advancing its
    counter (the prefill's first generated token). Returns a 0-d int32
    tensor on the device."""
    tok = sample(logits_row[None, :], _rows(state, slice(slot, slot + 1)))[0]
    state.draws[slot] += 1
    return tok, state


def count_tokens(state: SlotSampling, tokens: torch.Tensor) -> SlotSampling:
    """Add each slot's fed token to its counts, in place (every generated
    token is fed exactly once; the prompt was counted at admit)."""
    V = state.counts.shape[1]
    flat = torch.arange(tokens.shape[0], device=tokens.device) * V + tokens.long()
    state.counts.view(-1).scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return state


def _chain(logits: torch.Tensor, state: SlotSampling):
    """The sampler chain up to (but excluding) the random draw: returns
    (masked scaled logits, penalized logits, per-row greedy flags)."""
    V = logits.shape[-1]
    l = logits.float()
    counts = state.counts.float()
    seen = counts > 0
    # llama.cpp repetition penalty: seen & positive -> /p, seen & negative -> *p
    rp = state.repetition[:, None]
    l = torch.where(seen, torch.where(l > 0, l / rp, l * rp), l)
    l = (l - torch.where(seen, state.presence[:, None], 0.0)
         - counts * state.frequency[:, None])

    greedy = state.temperature <= 0.0
    t = torch.where(greedy, 1.0, state.temperature)[:, None]
    s = l / t
    sorted_desc = torch.sort(s, dim=-1, descending=True).values
    # top-k: threshold at the k-th largest (ties widen the pool)
    k = torch.where(state.top_k <= 0, V, state.top_k.clamp(1, V)).long()
    kth = torch.gather(sorted_desc, -1, (k - 1)[:, None])
    keep = s >= kth
    # top-p over the sorted distribution (exclusive cumsum < p always keeps
    # the first token; the kept set's inclusive mass is >= p like llama.cpp)
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    nkeep = torch.clamp_min(((cum - probs) < state.top_p[:, None]).sum(dim=-1), 1)
    pth = torch.gather(sorted_desc, -1, (nkeep - 1)[:, None])
    keep &= s >= pth
    # min-p: prob >= min_p * max_prob  <=>  s >= s_max + log(min_p)
    keep &= s >= (sorted_desc[:, :1]
                  + torch.log(torch.clamp_min(state.min_p, 1e-38))[:, None])

    masked = torch.where(keep, s, torch.finfo(torch.float32).min)
    return masked, l, greedy
