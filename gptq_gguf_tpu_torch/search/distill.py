"""Post-compression finetuning utilities.

Port of ``gptq_gguf_tpu/search/distill.py`` (the reference's
evopress/src/losses.py squarehead loss, optim_utils.py masked optimizer and
prompter.py Alpaca templates), with ``torch.optim`` where the JAX package
uses optax: ``masked_sgd`` is plain SGD whose every update is multiplied by
its mask before it is applied, so a pruned weight stays exactly 0.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

import torch


def squarehead_loss(student_feats: torch.Tensor, teacher_feats: torch.Tensor) -> torch.Tensor:
    """Per-layer feature distillation: ||s - t||^2 / ||t||^2 (losses.py:6-13)."""
    num = torch.sum((student_feats.float() - teacher_feats.float()) ** 2)
    den = torch.clamp_min(torch.sum(teacher_feats.float() ** 2), 1e-30)
    return num / den


class MaskedSGD(torch.optim.SGD):
    """SGD (no momentum, no weight decay: optax.sgd's defaults) with each
    parameter's update multiplied by its mask, 1 where trainable
    (optim_utils.py:12-29)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, masks: Sequence[torch.Tensor]):
        params = list(params)
        if len(params) != len(masks):
            raise ValueError(f"{len(params)} parameters, {len(masks)} masks")
        super().__init__(params, lr=lr)
        self.masks = list(masks)

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        lr = self.param_groups[0]["lr"]
        for p, m in zip(self.param_groups[0]["params"], self.masks):
            if p.grad is not None:
                p.sub_(lr * p.grad * m)
        return loss


def masked_sgd(learning_rate: float, masks: Sequence[torch.Tensor],
               params: Iterable[torch.Tensor]) -> MaskedSGD:
    """The masked optimizer over ``params`` (one mask per parameter, in
    order; 1.0 where trainable), as JAX's ``masked_sgd`` is an optax
    transformation over its pytree."""
    return MaskedSGD(params, learning_rate, masks)


def sparsity_masks(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Masks preserving the sparsity pattern (nonzero -> trainable)."""
    return {k: (p != 0).to(p.dtype) for k, p in params.items()}


ALPACA_TEMPLATE = {
    "prompt_input": (
        "Below is an instruction that describes a task, paired with an input "
        "that provides further context. Write a response that appropriately "
        "completes the request.\n\n### Instruction:\n{instruction}\n\n"
        "### Input:\n{input}\n\n### Response:\n"
    ),
    "prompt_no_input": (
        "Below is an instruction that describes a task. Write a response "
        "that appropriately completes the request.\n\n### Instruction:\n"
        "{instruction}\n\n### Response:\n"
    ),
}


def build_prompt(instruction: str, input_text: str = "") -> str:
    """Alpaca prompt template (prompter.py:8-85)."""
    if input_text:
        return ALPACA_TEMPLATE["prompt_input"].format(instruction=instruction, input=input_text)
    return ALPACA_TEMPLATE["prompt_no_input"].format(instruction=instruction)

