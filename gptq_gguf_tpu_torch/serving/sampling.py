"""Per-request sampling settings for the serving engine.

Port of the greedy part of ``gptq_gguf_tpu/serving/sampling.py``. The
greedy engine takes the argmax of the logits and keeps no per-slot sampler
state; constructing non-greedy settings (temperature, penalties) raises
``NotImplementedError`` until the sampler chain is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["SamplingParams", "GREEDY"]


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
    seed: Optional[int] = None

    def __post_init__(self):
        if not self.is_trivial:
            raise NotImplementedError(
                "sampled decoding (temperature / penalties) is not ported "
                "yet; the engine serves greedy requests only")

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
