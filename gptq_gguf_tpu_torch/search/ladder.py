"""Ladder builders: per-layer multi-level databases for EvoPress.

Port of ``gptq_gguf_tpu/search/ladder.py``: the block walks of the
reference's FastOBQ bit-width ladders (``<layer>/<bits>.pth`` dequantized
weights, evopress/src/quantizer.py) and FastOBC sparsity ladders
(``<layer>/<level>.pth``, evopress/src/pruner.py), the OWL outlier ratios
(owl_pruner.py) and the per-level error estimator (error_estimator.py).

The walk is the calibration walk's (``quant/calibrate.py``): per block one
capture pass accumulates the four Hessians (``models/llama.py::
block_capture``, ``ops/gptq.py::accumulate_hessian``), a solver sees each
linear with its Hessian and may return its replacement, and the block is
run again to propagate. Each block's weights are staged onto the device for
its pass and go back where they came from; activations stay on the device
unless they exceed 2 GiB. Ladder files are f16 of the f32 solutions, as the
JAX package writes them.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import resolve_device
from ..models import llama
from ..models.llama import LlamaConfig
from ..ops import gptq as gptq_ops
from ..ops import sparse_gptq
from ..quant.calibrate import _LINEAR_SPECS, _capture_sizes, activation_home

# solver(layer_index, key, hf_name, W, H) -> replacement weight or None
Solver = Callable[[int, str, str, torch.Tensor, torch.Tensor], Optional[torch.Tensor]]


def _save_pth(path: Path, w: torch.Tensor) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(w.detach().half().cpu().contiguous(), path)


def _block_walk(params, cfg: LlamaConfig, calibration_ids, batch_size: int, solver: Solver,
                device="cuda"):
    """Shared walk: per block, accumulate the Hessians, call ``solver`` on
    each linear (its weight in the checkpoint's dtype, fp16 widened to f32
    as the calibration walk stages it), cast a replacement back to that
    dtype, propagate. Returns params with the replacements."""
    dev = resolve_device(device)
    ids = [np.atleast_2d(np.asarray(a)) for a in calibration_ids]
    S = ids[0].shape[1]
    batches = [np.concatenate(ids[i:i + batch_size], axis=0)
               for i in range(0, len(ids), batch_size)]
    act_home = activation_home(batches, cfg, dev)
    with torch.no_grad():
        cos1, sin1 = llama.rope_cos_sin(cfg, torch.arange(S, device=dev)[None, :])

        def rope_mask(b):
            return (cos1.expand(b, S, cos1.shape[-1]), sin1.expand(b, S, sin1.shape[-1]),
                    llama.causal_mask(b, S, device=dev))

        embed = {"embed_tokens": params["embed_tokens"].to(dev)}
        xs = [llama.embed_forward(embed, torch.as_tensor(b, device=dev), cfg).to(act_home)
              for b in batches]
        del embed
        for li in range(cfg.num_hidden_layers):
            src = params["layers"][li]
            layer = {k: (v.to(dev).float() if v.dtype == torch.float16 else v.to(dev))
                     for k, v in src.items()}
            sizes = _capture_sizes(layer, cfg)
            hs = {k: torch.zeros((d, d), dtype=torch.float32, device=dev)
                  for k, d in sizes.items()}
            counts = {k: 0.0 for k in sizes}
            for x in xs:
                _, caps = llama.block_capture(layer, x.to(dev), *rope_mask(x.shape[0]), cfg, li)
                for key in hs:
                    hs[key], counts[key] = gptq_ops.accumulate_hessian(hs[key], counts[key],
                                                                       caps[key])
                del caps

            new_layer = dict(layer)
            for key, cap, name_tpl in _LINEAR_SPECS:
                replacement = solver(li, key, name_tpl.format(i=li), layer[key], hs[cap])
                if replacement is not None:
                    new_layer[key] = replacement.to(layer[key].dtype)
            del hs

            xs = [llama.block_forward(new_layer, x.to(dev), *rope_mask(x.shape[0]), cfg, li)
                  .to(act_home) for x in xs]
            layers = list(params["layers"])
            layers[li] = {k: v.to(src[k].device) if k in src else v
                          for k, v in new_layer.items()}
            params = {**params, "layers": layers}
            del layer, new_layer
    return params


def build_fastobq_ladder(
    params,
    cfg: LlamaConfig,
    calibration_ids,
    save_dir: Union[str, Path],
    bitwidths: Sequence[int] = (2, 3, 4, 5, 6, 8),
    *,
    propagate_bits: Optional[int] = 4,
    sym: bool = False,
    group_size: Optional[int] = None,
    block_size: int = 128,
    rel_damp: float = 1e-2,
    batch_size: int = 1,
    device="cuda",
):
    """FastOBQ multi-bitwidth database (evopress/src/quantizer.py:130-171):
    ``<layer>/<bits>.pth`` for every bit width; the walk propagates the
    ``propagate_bits`` solution (None: the original weights)."""
    save_dir = Path(save_dir)

    def solver(li, key, name, W, H):
        results = sparse_gptq.fast_obq_quantize(
            W.float(), H, bitwidths, sym=sym, group_size=group_size, block_size=block_size,
            rel_damp=rel_damp)
        for bits, (_, _, w_hat) in results.items():
            _save_pth(save_dir / name / f"{bits}.pth", w_hat)
        if propagate_bits is not None and propagate_bits in results:
            return results[propagate_bits][2]
        return None

    return _block_walk(params, cfg, calibration_ids, batch_size, solver, device)


def obc_levels(numel: int, base: float, num_levels: int, weights_diff: int):
    """(levels, sparsities) of one linear's FastOBC ladder: ``base + l *
    weights_diff / numel`` for l in [-min_level, max_level], as many levels
    on each side as fit in [0, 1], at most ``num_levels``."""
    step = weights_diff / numel
    min_level = min(int(base // step), num_levels)
    max_level = min(int((1 - base) // step), num_levels)
    levels = list(range(-min_level, max_level + 1))
    return levels, [base + level * step for level in levels]


def build_fastobc_ladder(
    params,
    cfg: LlamaConfig,
    calibration_ids,
    save_dir: Union[str, Path],
    sparsity: float = 0.5,
    num_levels: int = 4,
    weights_diff: int = 1 << 20,
    *,
    sparsity_distribution: Optional[np.ndarray] = None,
    block_size: int = 128,
    rel_damp: float = 1e-2,
    batch_size: int = 1,
    propagate: bool = True,
    device="cuda",
):
    """FastOBC sparsity-level database (evopress/src/pruner.py:149-165):
    per linear, ``<level>.pth`` for the levels of ``obc_levels``; the walk
    propagates level 0 (the base sparsity).

    ``sparsity_distribution``: optional per-block base sparsity (OWL,
    owl_pruner.py:226-266)."""
    save_dir = Path(save_dir)

    def solver(li, key, name, W, H):
        base = (float(sparsity_distribution[li]) if sparsity_distribution is not None
                else sparsity)
        levels, sparsities = obc_levels(int(np.prod(W.shape)), base, num_levels, weights_diff)
        sparse = sparse_gptq.fast_obc_prune(W.float(), H, sparsities, block_size=block_size,
                                            rel_damp=rel_damp)
        for level, w in zip(levels, sparse):
            _save_pth(save_dir / name / f"{level}.pth", w)
        if propagate:
            return sparse[levels.index(0)]
        return None

    return _block_walk(params, cfg, calibration_ids, batch_size, solver, device)


def compute_owl_outlier_ratios(
    params,
    cfg: LlamaConfig,
    calibration_ids,
    m: float = 5.0,
    batch_size: int = 1,
    device="cuda",
) -> List[float]:
    """Per-block mean outlier ratio of the OWL metric (owl_pruner.py:169-201),
    from the diagonals of the walk's full Hessians."""
    per_block: Dict[int, List[float]] = {}

    def solver(li, key, name, W, H):
        metric = sparse_gptq.owl_metric(W.float(), torch.diagonal(H))
        per_block.setdefault(li, []).append(sparse_gptq.owl_outlier_ratio(metric, m))
        return None

    _block_walk(params, cfg, calibration_ids, batch_size, solver, device)
    return [float(np.mean(per_block[li])) for li in sorted(per_block)]


def estimate_layer_errors(
    params,
    cfg: LlamaConfig,
    calibration_ids,
    db_path: Union[str, Path],
    batch_size: int = 1,
    out_path: Optional[Union[str, Path]] = None,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """Per-layer normalized proxy loss (dW H dW^T) / (W H W^T) against every
    level file of the database (error_estimator.py:16-262).

    Returns {layer_name: {level_filename: relative_error}}; optionally
    dumps it as JSON."""
    db_path = Path(db_path)
    results: Dict[str, Dict[str, float]] = {}

    def solver(li, key, name, W, H):
        layer_dir = db_path / name
        if not layer_dir.is_dir():
            return None
        W32 = W.float()
        errs = {}
        for f in sorted(layer_dir.glob("*.pth")):
            w_hat = torch.load(f, map_location="cpu", weights_only=True).to(W.device).float()
            errs[f.name] = float(sparse_gptq.relative_layer_error(W32, w_hat, H))
        results[name] = errs
        return None

    _block_walk(params, cfg, calibration_ids, batch_size, solver, device)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
    return results
