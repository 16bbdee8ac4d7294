"""PyTorch / CUDA port of ``gptq_gguf_tpu`` for NVIDIA Hopper (sm_90a).

The package mirrors the JAX package's module paths so each counterpart is
easy to find (``formats/ggml.py`` here ports ``gptq_gguf_tpu/formats/ggml.py``
and so on). It imports nothing of the JAX package: what it needs from there
is copied and trimmed. Entry points run on the card (``device="cuda"``) and
raise when CUDA is missing; only an explicit ``device="cpu"`` runs the plain
PyTorch versions on the host.

Ported: GPTQ quantization of a dense Llama checkpoint (the safetensors
reader, K-quant fitting, the GPTQ solver with its hand-written column-block
CUDA kernel, the calibration walk and its per-layer artifacts:
``quantize``) and its GGUF (``pack``); stage 1's other route, the
llama-quantize recipes with importance vectors and round-to-nearest
artifacts (``imatrix``, ``llama-quantize``, ``rtn-quantize``). The layer
database, the EvoPress
bit-width search and the stitcher that assembles a mixed GGUF
(``build-db``, ``search``, ``stitch``). Serving a K-quant GGUF Llama:
GGUF reading, the v2 runtime weight format, the hand-written v2g
dequant-matmul CUDA kernel, the dense Llama decoder with a contiguous bf16,
int8 or int4 KV cache, the per-slot sampler chain (penalties, top-k / top-p
/ min-p, temperature, seeded draws, logprobs), and the continuous-batching
engine (``serve``). Paged serving
over HTTP: block-table KV page pools (bf16 or int4), the paged engine,
the hand-written paged flash-decode CUDA kernels, the GGUF tokenizer and
the HTTP server (``serve --http --paged``).
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """Validate an entry point's ``device`` argument.

    ``"cuda"`` (the default everywhere) raises when no card is visible:
    the port never falls back to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' explicitly to run "
                "the plain PyTorch path on the host")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
