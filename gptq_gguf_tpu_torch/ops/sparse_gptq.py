"""FastOBQ / FastOBC / OWL primitives: the EvoPress databases beyond K-quants.

Port of ``gptq_gguf_tpu/ops/sparse_gptq.py``:

* ``fast_obq_quantize``: GPTQ with a flat (sym / asym, per-channel or
  per-group) min / max quantizer, a ladder of integer bit widths from one
  Hessian factorization;
* ``fast_obc_prune``: OBC sparsification, per-block scores
  ``w^2 / diag(U)^2``, a k-th value threshold, error feedback, several
  sparsity levels from one factorization;
* the OWL metric and its layerwise sparsity distribution, and the
  relative layer error of the error estimator.

The JAX solvers are XLA programs (``lax.scan``, no ``pl.pallas_call``), so
these are plain PyTorch on the device of their inputs. Rows are independent
given the factor U, so a ladder's levels are stacked along the rows (each
bit width's or sparsity's copy of W) and one column loop serves them all:
an 8B-width layer at six bit widths takes its ~39k column steps once, not
six times. Each column's rank-1 update is rounded once per element, as a
fused multiply-add (the product exact in f64, the sum rounded to f32),
which is how XLA compiles ``wb - err * u`` on the CPU; the other steps keep
JAX's order of operations.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .gptq import prepare_hessian_inverse


class FlatQuantParams(NamedTuple):
    scale: torch.Tensor  # (d_row, n_groups)
    zero: torch.Tensor  # (d_row, n_groups)


def _find_params(x: torch.Tensor, maxq, sym: bool, reciprocal: bool = False) -> FlatQuantParams:
    """``simple_find_params`` with ``maxq`` a number or a per-row f32
    tensor (the stacked ladder's rows each have their own). reciprocal:
    multiply the range by the f32 reciprocal of maxq instead of dividing,
    as JAX's compiled solver does with its constant maxq."""
    xmin = x.amin(dim=-1)
    xmax = x.amax(dim=-1)
    if sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = xmin == xmax
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)
    if reciprocal:
        scale = (xmax - xmin) * (1.0 / torch.as_tensor(maxq, dtype=torch.float32,
                                                       device=x.device))
    else:
        scale = (xmax - xmin) / maxq
    if sym:
        zero = torch.ones_like(scale) * ((maxq + 1) / 2)
    else:
        zero = torch.round(-xmin / scale)
    return FlatQuantParams(scale, zero)


def simple_find_params(x: torch.Tensor, bits: int, sym: bool) -> FlatQuantParams:
    """Flat min / max quantizer fit over the last axis (the reference's
    Quantizer, weight=True, per channel)."""
    return _find_params(x, float(2 ** bits - 1), sym)


def _flat_quantize(col, scale, zero, maxq, eps: float = 1e-9):
    """(codes, dequantized values): ``col / max(scale, eps) + zero``, then
    round, then clip; ``scale * (q - zero)``."""
    q = torch.round(col / torch.clamp_min(scale, eps) + zero)
    q = torch.minimum(torch.clamp_min(q, 0.0), torch.as_tensor(maxq, dtype=q.dtype,
                                                                device=q.device))
    return q, scale * (q - zero)


def _fma_sub(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out = a - b * c (broadcasting), rounded once to out's f32, as a fused
    multiply-add: c is f64 (exact for f32 values), so the product is exact
    and the one f64 rounding of the difference leaves the f32 rounding of
    the exact result. One launch; out may alias a."""
    return torch.addcmul(a, b, c, value=-1, out=out)


def _stacked_fast_obq(W: torch.Tensor, U: torch.Tensor, maxq: torch.Tensor, sym: bool,
                      group_size: int, block_size: int):
    """FastOBQ over stacked rows (reference fast_obq.py:146-199). W: (R,
    d_col) f32; maxq: (R,) f32, each row's largest code. Returns (codes f32,
    scale, zero, w_hat), all per row."""
    R, d_col = W.shape
    gs = group_size or d_col
    ng = d_col // gs
    bs = min(block_size or d_col, gs)
    if ng == 1:
        p = _find_params(W, maxq, sym, reciprocal=True)
        scale, zero = p.scale[:, None].clone(), p.zero[:, None].clone()
    else:
        scale = torch.zeros((R, ng), dtype=torch.float32, device=W.device)
        zero = torch.zeros_like(scale)
    w = W.clone()
    codes = torch.empty_like(w)
    floor = torch.zeros_like(maxq)
    for c1 in range(0, d_col, bs):
        g = c1 // gs  # a block lies in one group (bs <= gs)
        if ng > 1 and c1 % gs == 0:
            # each group's quantizer is fit on the residual at its start
            p = _find_params(w[:, c1:c1 + gs], maxq, sym, reciprocal=True)
            scale[:, g], zero[:, g] = p.scale, p.zero
        s, z = scale[:, g], zero[:, g]
        s_div, s64 = torch.clamp_min(s, 1e-9), s.double()
        c2 = c1 + bs
        wb = w[:, c1:c2]
        u64 = U[c1:c2, c1:c2].double()
        errs = torch.empty_like(wb)
        for i in range(bs):
            col, q = wb[:, i], codes[:, c1 + i]
            # _flat_quantize's codes, written in place
            torch.div(col, s_div, out=q)
            q.add_(z).round_().clamp_(floor, maxq)
            # col - scale * (q - zero), then the rank-1 update of the block
            # (the column itself too: its final state is w_hat), each rounded
            # once, as XLA contracts them
            err = _fma_sub(col, s64, q - z, out=errs[:, i]).div_(U[c1 + i, c1 + i])
            _fma_sub(wb[:, i:], err[:, None], u64[i, i:][None, :], out=wb[:, i:])
        if c2 < d_col:
            w[:, c2:] -= errs @ U[c1:c2, c2:]
    return codes, scale, zero, w


def fast_obq_quantize(
    W: torch.Tensor,
    H: torch.Tensor,
    bitwidths: Sequence[int],
    *,
    sym: bool = False,
    group_size: Optional[int] = None,
    block_size: int = 128,
    rel_damp: float = 1e-2,
) -> Dict[int, Tuple[torch.Tensor, FlatQuantParams, torch.Tensor]]:
    """Multi-bitwidth GPTQ from one Hessian (fast_obq.py:108-199), every
    bit width's rows in one column loop. Returns {bits: (qweight u8,
    params, dequantized weight f32)} on W's device."""
    W32, U, _ = prepare_hessian_inverse(torch.as_tensor(H), torch.as_tensor(W), rel_damp)
    d_row = W32.shape[0]
    bits = [int(b) for b in bitwidths]
    maxq = torch.tensor([2.0 ** b - 1 for b in bits], dtype=torch.float32,
                        device=W32.device).repeat_interleave(d_row)
    codes, scale, zero, w_hat = _stacked_fast_obq(W32.repeat(len(bits), 1), U, maxq, sym,
                                                  group_size or W32.shape[1], block_size)
    out = {}
    for k, b in enumerate(bits):
        rows = slice(k * d_row, (k + 1) * d_row)
        out[b] = (codes[rows].to(torch.uint8), FlatQuantParams(scale[rows], zero[rows]),
                  w_hat[rows])
    return out


# ---------------------------------------------------------------------------
# FastOBC sparsification
# ---------------------------------------------------------------------------


def _prune_count(numel_blk: int, sparsity: float) -> int:
    """k = clip(round(numel * sparsity), 1, numel), the product in f32 and
    rounded half to even, as JAX computes it."""
    k = int(np.round(np.float32(numel_blk) * np.float32(sparsity)))
    return min(max(k, 1), numel_blk)


def _stacked_fast_obc(W: torch.Tensor, U: torch.Tensor, chunks: Sequence[Tuple[int, int, float]],
                      block_size: int, stats: Optional[list] = None) -> torch.Tensor:
    """FastOBC over stacked rows (reference fast_obc.py:119-155). chunks:
    (first row, end row, sparsity), each with its own threshold per block.
    stats: when a list is passed, one (chunk, block, k, entries at or below
    the threshold) per chunk and block is appended, the count a 0-d tensor
    (read without stopping the device)."""
    R, d_col = W.shape
    bs = block_size or d_col
    w = W.clone()
    for c1 in range(0, d_col, bs):
        c2 = c1 + bs
        wb = w[:, c1:c2].clone()
        ub = U[c1:c2, c1:c2]
        diag = torch.diagonal(ub)
        scores = wb * wb / (diag * diag)[None, :]
        keep = torch.empty_like(wb, dtype=torch.bool)
        for ci, (r0, r1, sparsity) in enumerate(chunks):
            s = scores[r0:r1]
            k = _prune_count(s.numel(), sparsity)
            thr = torch.kthvalue(s.reshape(-1), k).values
            keep[r0:r1] = s > thr
            if stats is not None:
                stats.append((ci, c1 // bs, k, (~keep[r0:r1]).sum()))
        u64, nil = ub.double(), torch.zeros((), dtype=wb.dtype, device=wb.device)
        pruned = torch.empty_like(wb)
        errs = torch.empty_like(wb)
        for i in range(bs):
            col = wb[:, i]
            q = torch.where(keep[:, i], col, nil, out=pruned[:, i])
            err = torch.sub(col, q, out=errs[:, i]).div_(ub[i, i])
            _fma_sub(wb[:, i:], err[:, None], u64[i, i:][None, :], out=wb[:, i:])
        # the pruned values, not the error-updated block, are written back
        # (fast_obc.py:152: w[:, c1:c2] = res)
        w[:, c1:c2] = pruned
        if c2 < d_col:
            w[:, c2:] -= errs @ U[c1:c2, c2:]
    return w


def fast_obc_prune(
    W: torch.Tensor,
    H: torch.Tensor,
    sparsities: Sequence[float],
    *,
    block_size: int = 128,
    rel_damp: float = 1e-2,
    stats: Optional[list] = None,
) -> List[torch.Tensor]:
    """Multi-sparsity OBC pruning from one Hessian (fast_obc.py:108-172),
    every level's rows in one column loop. stats: see
    ``_stacked_fast_obc`` (chunk = level)."""
    W32, U, _ = prepare_hessian_inverse(torch.as_tensor(H), torch.as_tensor(W), rel_damp)
    d_row = W32.shape[0]
    chunks = [(k * d_row, (k + 1) * d_row, float(s)) for k, s in enumerate(sparsities)]
    w = _stacked_fast_obc(W32.repeat(len(chunks), 1), U, chunks, block_size, stats)
    return [w[r0:r1] for r0, r1, _ in chunks]


# ---------------------------------------------------------------------------
# OWL (outlier-weighed layerwise sparsity)
# ---------------------------------------------------------------------------


def owl_metric(W: torch.Tensor, H_diag: torch.Tensor) -> torch.Tensor:
    """|W| * sqrt(diag H) (owl_pruner.py:63-68)."""
    return W.abs() * torch.sqrt(H_diag)[None, :]


def owl_outlier_ratio(metric: torch.Tensor, m: float) -> float:
    """Fraction of entries above m * mean (owl_pruner.py:77-79)."""
    return float((metric > m * metric.mean()).float().mean())


def owl_sparsity_distribution(outlier_ratios: Sequence[float], sparsity: float,
                              owl_lambda: float) -> np.ndarray:
    """Lambda-scaled nonuniform sparsity across layers (owl_pruner.py:205-221)."""
    lor = np.asarray(outlier_ratios, dtype=np.float64)
    rng = lor.max() - lor.min()
    if rng == 0:
        return np.full_like(lor, sparsity)
    lor = 2 * owl_lambda * (lor - lor.min()) / rng
    return sparsity - lor + lor.mean()


# ---------------------------------------------------------------------------
# Error estimation
# ---------------------------------------------------------------------------


def relative_layer_error(W: torch.Tensor, W_hat: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Normalized proxy loss (dW H dW^T) / (W H W^T) (error_estimator.py:95-103)."""
    dW = (W - W_hat).float()
    num = torch.sum(dW * (dW @ H))
    den = torch.sum(W * (W @ H))
    return num / torch.clamp_min(den, 1e-30)
