"""K-quant codebook fitting in PyTorch.

Port of ``gptq_gguf_tpu/ops/kquant.py``: every routine is vectorized over
all supergroups of a weight matrix at once (a weight is (d_row, d_col);
supergroups are runs of 256 columns, groups runs of 16 or 32 columns inside
one). Numerics follow the reference: f32 compute, fp16 super-scale
rounding, the same refinement schedule, and both of its quirks (the uint8
square that wraps mod 256, and candidates anchored at the current best
min).

Arithmetic order. The JAX package's results are those of XLA, which fuses
a product that feeds an add into one fused multiply-add (one rounding),
sums a reduction in index order and moves a constant factor onto the
smaller operand of a product. The port writes those fused products out
(``_fma``), sums in XLA:CPU's order (``_red``), rounds square roots and
divisions as XLA:CPU does and multiplies in XLA's order, so on the CPU its
codes and params are bit-equal to the JAX package's. Every step is an
elementwise IEEE operation in a fixed order (no torch reduction but
``amax`` / ``amin``, which are exact), so the card computes the same bits
as the host: a fit does not depend on the device it runs on.

``card_sums=True`` trades that for speed on the card: each ordered sum and
fused product becomes one torch reduction or ``torch.addcmul`` (about a
third of the launches), whose last bit, and rarely a code, may differ from
the host's. The GPTQ walk's dynamic refit takes it: its residual already
follows the card's solve, not the CPU's. On the CPU it changes nothing.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..formats.ggml import KQUANT_SPECS, GGMLQuantizationType, KQuantSpec

DEFAULT_EPS = 1e-9


class ScaleSearchConfig(NamedTuple):
    """Hyperparameters of the scale search (the reference's defaults)."""

    quant_scale: str = "absmax"  # "absmax" | "mse"
    grid: int = 100
    maxshrink: float = 0.80
    norm: float = 2.0
    rmin: float = -1.0
    rdelta: float = 0.1
    nstep: int = 20
    eps: float = DEFAULT_EPS
    # Replicate the reference's uint8 overflow in ``new_q**2`` (uint8
    # squares wrap mod 256, which corrupts sum_l2 for Q5_K where maxq=31).
    # Published reference models were produced with it; False is the
    # mathematically clean path.
    compat_uint8_overflow: bool = True


class SuperGroupParams(NamedTuple):
    """Two-level quantization parameters of a (d_row, d_col) weight:
      super_scale: (d_row, n_sg) fp16 — per-supergroup scale of scales
      super_zero:  (d_row, n_sg) fp16 — per-supergroup scale of mins
      scale_q:     (d_row, n_groups) int — quantized group scales
      zero_q:      (d_row, n_groups) int — quantized group mins
    Fields may be torch tensors or numpy arrays (``qmatmul.pack_runtime_v2``
    reads them through numpy).
    """

    super_scale: Any
    super_zero: Any
    scale_q: Any
    zero_q: Any


# ---------------------------------------------------------------------------
# Arithmetic helpers
# ---------------------------------------------------------------------------


def _f32(v: float) -> float:
    """A Python scalar rounded to f32, as JAX rounds a weak-typed scalar."""
    return float(np.float32(v))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
         card_sums: bool = False) -> torch.Tensor:
    """a * b + c with one rounding to f32: the product of two f32 values is
    exact in f64, so one f64 add and one cast round like a fused
    multiply-add (up to a double rounding too rare to matter), on every
    device alike; with ``card_sums`` on the card, ``torch.addcmul``."""
    if card_sums and a.device.type != "cpu":
        return torch.addcmul(c, a, b)
    return (a.double() * b.double() + c.double()).float()


# XLA:CPU compiles each reduction to a loop that LLVM may vectorize; then
# lane k sums terms k, k+L, k+2L, ... and the lanes are added pairwise at
# the end. The lane count L of each reduction, by (site, length), as
# XLA:CPU picks it on an x86-64 host with AVX2 / AVX-512, where LLVM
# prefers 256-bit vectors: 8 f32 lanes (measured against the JAX package:
# tests/test_torch_kquant.py); 1 is index order. The table is a property of
# that host, not of the arithmetic: where XLA:CPU vectorizes otherwise
# (another vector width, an aarch64 host), the two packages sum in another
# order, and the CPU tests' bit-equality can fail in the last bit of a sum
# with no change to either package.
_LANES = {("sum_l", 32): 8, ("sum_l2", 32): 8, ("sum_xl", 32): 8, ("err0", 32): 8,
          ("err", 32): 8, ("sum_l2", 16): 8}


def _red(a: torch.Tensor, b: Optional[torch.Tensor] = None, site: str = "",
         card_sums: bool = False) -> torch.Tensor:
    """sum over the last axis, kept, of a * b (each product fused into the
    running sum) or of a, in XLA:CPU's order on every device; with
    ``card_sums`` on the card, one torch reduction."""
    if card_sums and a.device.type != "cpu":
        return (a if b is None else a * b).sum(-1, keepdim=True)
    if b is None:
        p = a.double()
    else:
        a, b = torch.broadcast_tensors(a, b)
        p = a.double() * b.double()  # exact: a fused product
    n = p.shape[-1]
    lanes = min(_LANES.get((site, n), 1), n)
    acc = p[..., :lanes].float()
    for i in range(lanes, n, lanes):
        acc = (acc.double() + p[..., i:i + lanes]).float()
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root (torch's vectorized CPU sqrt is
    not: it is off by an ulp on ~1% of inputs; the card's is, and f64's
    rounded to f32 is too)."""
    return torch.sqrt(t.double()).float()


def _div_c(t: torch.Tensor, c: float) -> torch.Tensor:
    """t / c for a constant c as XLA computes it: times the f32 reciprocal."""
    return t * float(np.float32(1.0) / np.float32(c))


def _rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """a / t as one true division (torch computes ``float / tensor`` as a
    reciprocal times a, which rounds twice). On the card a 0-d host tensor
    is passed to the division kernel as its argument: one launch."""
    if t.device.type != "cpu":
        return torch.tensor(_f32(a), dtype=t.dtype) / t
    return torch.full_like(t, _f32(a)) / t


def _where(cond, a, b) -> torch.Tensor:
    """torch.where with Python scalars kept in f32. A scalar stays a host
    scalar: a 0-d tensor made on the card would cost a copy from host
    memory, and with it a wait for the card, at every call."""
    a = _f32(a) if isinstance(a, float) else a
    b = _f32(b) if isinstance(b, float) else b
    return torch.where(cond, a, b)


# ---------------------------------------------------------------------------
# Group-level scale fitting
# ---------------------------------------------------------------------------


def _symmetric_range(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xmin, xmax) of make_quants' symmetric grid over the last axis
    (-1 and 1 for a degenerate group)."""
    xmin0 = x.amin(dim=-1)
    xmax0 = x.amax(dim=-1)
    xmax = torch.maximum(xmin0.abs(), xmax0)
    xmin = torch.where(xmin0 < 0, -xmax, xmin0)
    degenerate = xmin == xmax
    return _where(degenerate, -1.0, xmin), _where(degenerate, 1.0, xmax)


def make_quants(x: torch.Tensor, maxq: int, cfg: ScaleSearchConfig = ScaleSearchConfig(),
                card_sums: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric min/max grid fit for the signed K-quants (Q3_K / Q6_K).
    ``x``: (..., gs); returns (scale, zero) of shape (...,), zero always 0.
    The "mse" branch runs the intended shrink search (rounding the
    quotient), as the JAX package does."""
    xmin, xmax = _symmetric_range(x)
    scale = _div_c(xmax - xmin, maxq)

    if cfg.quant_scale == "mse":
        zero_val = (maxq + 1) / 2.0
        steps = int(cfg.maxshrink * cfg.grid) + 1
        step = np.float32(1.0) / np.float32(cfg.maxshrink * cfg.grid)
        best, min_loss = scale, torch.full_like(scale, float("inf"))
        amax = torch.maximum(xmax, xmin.abs())
        for i in range(steps):
            # 1 - i / (maxshrink * grid): one fused multiply-add by the
            # f32 reciprocal, as XLA compiles it
            alpha = float(np.float32(1.0 - np.float64(i) * np.float64(step)))
            cand_max = amax * alpha
            xmax1 = torch.minimum(xmax, cand_max)
            xmin1 = torch.maximum(xmin, -cand_max)
            scale1 = _div_c(xmax1 - xmin1, maxq)
            q = torch.clamp(torch.round(
                (x - zero_val) / torch.clamp_min(scale1, _f32(1e-9))[..., None]), 0, maxq)
            y = _fma(q, scale1[..., None], torch.full_like(q, zero_val), card_sums)
            d = (y - x).abs()
            if cfg.norm == 2.0:
                loss = _red(d, d, "mse", card_sums)[..., 0]
            else:
                loss = _red(d ** cfg.norm, None, "mse", card_sums)[..., 0]
            better = loss < min_loss
            best = torch.where(better, scale1, best)
            min_loss = torch.where(better, loss, min_loss)
        scale = best
    return scale, torch.zeros_like(scale)


def make_k_quants(x: torch.Tensor, maxq: int, cfg: ScaleSearchConfig = ScaleSearchConfig(),
                  weights: Optional[torch.Tensor] = None,
                  card_sums: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted least-squares scale/min refinement for the unsigned K-quants
    (Q2_K / Q4_K / Q5_K), llama.cpp's ``make_qkx2_quants`` scheme.
    ``x``: (..., gs); returns (scale, zero) of shape (...,) with
    zero = -best_min >= 0. ``weights`` default to av_x + |x|; they may
    also be given as a pair (a, b) of factors of a * b, whose sum the
    reference's compiled program takes as fused products."""
    red = functools.partial(_red, card_sums=card_sums)
    fma = functools.partial(_fma, card_sums=card_sums)
    eps = _f32(cfg.eps)
    gs = x.shape[-1]
    factors = weights if isinstance(weights, tuple) else None
    if factors is not None:
        weights = factors[0] * factors[1]
    sum_x2 = red(x, x, "sum_x2")
    av_x = _sqrt(_div_c(sum_x2, gs))
    if weights is None:
        weights = av_x + x.abs()

    x_min = torch.clamp_max(x.amin(dim=-1, keepdim=True), 0.0)
    x_max = x.amax(dim=-1, keepdim=True)
    const_mask = x_max == x_min

    sum_w = red(*factors, "sum_w") if factors is not None else red(weights, None, "sum_w")
    wx = weights * x  # rounded once: XLA keeps it for sum_x and sum_xl
    sum_x = red(wx, None, "sum_x")

    scale0 = _where(const_mask, 0.0, _div_c(x_max - x_min, maxq))
    iscale0 = _rdiv(1.0, torch.clamp_min(scale0, eps))
    q0 = torch.clamp(torch.round((x - x_min) * iscale0), 0, maxq)
    q0 = _where(const_mask, 0.0, q0)

    diff0 = fma(scale0, q0, x_min.expand_as(q0)) - x
    best_err = red(weights * diff0, diff0, "err0")

    if cfg.nstep < 1:
        return scale0.squeeze(-1), (-x_min).squeeze(-1)

    # candidate numerators in f64 on the host, cast once to f32, as the
    # reference's Python-scalar arithmetic gives them
    numerators = (np.float64(cfg.rmin) + np.float64(cfg.rdelta) * np.arange(cfg.nstep + 1)
                  + maxq).astype(np.float32)

    best_scale, best_min = scale0, x_min
    for i in range(cfg.nstep + 1):
        # the candidate grid is anchored at the current best min, not the
        # data min: the reference aliases best_min = x_min and updates it in
        # place, so accepted steps feed later candidates
        cand_iscale = _rdiv(numerators[i], torch.clamp_min(x_max - best_min, eps))
        new_q = torch.clamp(torch.round((x - best_min) * cand_iscale), 0, maxq)
        new_q = _where(const_mask, 0.0, new_q)

        sum_l = red(weights, new_q, "sum_l")
        if cfg.compat_uint8_overflow:
            u = new_q.to(torch.uint8)
            nq_sq = (u * u).float()  # wraps mod 256, as uint8 does
        else:
            nq_sq = new_q * new_q
        sum_l2 = red(weights, nq_sq, "sum_l2")
        sum_xl = red(wx, new_q, "sum_xl")

        D = fma(sum_w, sum_l2, -(sum_l * sum_l))
        valid = D > eps
        Dsafe = _where(valid, D, 1.0)
        this_scale = fma(sum_w, sum_xl, -(sum_x * sum_l)) / Dsafe
        this_min = fma(sum_l2, sum_x, -(sum_l * sum_xl)) / Dsafe
        pos = this_min > 0
        this_scale = torch.where(pos, sum_xl / torch.clamp_min(sum_l2, eps), this_scale)
        this_min = _where(pos, 0.0, this_min)

        diff = fma(this_scale, new_q, this_min.expand_as(new_q)) - x
        cand_err = red(weights * diff, diff, "err")
        better = valid & (cand_err < best_err)
        best_scale = torch.where(better, this_scale, best_scale)
        best_min = torch.where(better, this_min, best_min)
        best_err = torch.where(better, cand_err, best_err)
    return best_scale.squeeze(-1), (-best_min).squeeze(-1)


# ---------------------------------------------------------------------------
# Supergroup double quantization
# ---------------------------------------------------------------------------


_MAKE_FN = {
    GGMLQuantizationType.Q2_K: make_k_quants,
    GGMLQuantizationType.Q3_K: make_quants,
    GGMLQuantizationType.Q4_K: make_k_quants,
    GGMLQuantizationType.Q5_K: make_k_quants,
    GGMLQuantizationType.Q6_K: make_quants,
}


def _int_dtype(spec: KQuantSpec) -> torch.dtype:
    return torch.int8 if spec.signed else torch.uint8


def fit_supergroups(x: torch.Tensor, qtype: GGMLQuantizationType,
                    cfg: ScaleSearchConfig = ScaleSearchConfig(),
                    imatrix: Optional[torch.Tensor] = None,
                    card_sums: bool = False) -> SuperGroupParams:
    """Fit quantization parameters for all supergroups of a (d_row, d_col)
    weight at once (d_col % 256 == 0).

    ``imatrix``: optional (d_col,) importance weights (mean squared
    activations) for the llama-quantize ``--imatrix`` path: the weighted
    types' group weights become ``im * sqrt(sigma2 + x^2)``. ``card_sums``:
    the card's faster sums (module docstring)."""
    spec = KQUANT_SPECS[qtype]
    d_row, d_col = x.shape
    n_sg = d_col // spec.super_group_size
    gpsg = spec.num_groups
    x = x.float().reshape(d_row, n_sg, gpsg, spec.group_size)

    maxq = 2 ** spec.bits - 1
    if imatrix is not None and _MAKE_FN[qtype] is make_k_quants:
        im = imatrix.float().reshape(1, n_sg, gpsg, spec.group_size)
        flat = x.reshape(d_row, n_sg, 1, gpsg * spec.group_size)
        sigma2 = _div_c(_red(flat, flat, "sigma2", card_sums), gpsg * spec.group_size)
        w = (im, _sqrt(_fma(x, x, sigma2.expand_as(x), card_sums)))
        scale, zero = make_k_quants(x, maxq, cfg, weights=w, card_sums=card_sums)
    else:  # (d_row, n_sg, gpsg)
        scale, zero = _MAKE_FN[qtype](x, maxq, cfg, card_sums=card_sums)

    max_scale = scale.amax(dim=-1)
    max_zero = zero.amax(dim=-1)
    super_scale = _div_c(max_scale, spec.scale_maxq).to(torch.float16)
    super_zero = _div_c(max_zero, spec.scale_maxq).to(torch.float16)

    def inv(m):
        pos = m > 0
        return _where(pos, _rdiv(spec.scale_maxq, _where(pos, m, 1.0)), 0.0)

    int_dtype = _int_dtype(spec)
    if _MAKE_FN[qtype] is make_quants and cfg.quant_scale != "mse":
        # an absmax scale is (xmax - xmin) times the f32 constant 1 / maxq,
        # and the JAX package's compiled fit moves that constant onto the
        # per-supergroup inverse: round((xmax - xmin) * (inv * (1 / maxq)))
        xmin, xmax = _symmetric_range(x)
        scale_q = (xmax - xmin) * _div_c(inv(max_scale), maxq)[..., None]
    else:
        scale_q = inv(max_scale)[..., None] * scale
    scale_q = torch.clamp(torch.round(scale_q), 0, spec.scale_maxq).to(int_dtype)
    zero_q = torch.clamp(torch.round(inv(max_zero)[..., None] * zero), 0,
                         spec.scale_maxq).to(int_dtype)
    return SuperGroupParams(super_scale, super_zero,
                            scale_q.reshape(d_row, n_sg * gpsg),
                            zero_q.reshape(d_row, n_sg * gpsg))


def _expanded_scales(params: SuperGroupParams, spec: KQuantSpec,
                     d_col: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-element (scale, offset), (d_row, d_col) f32; both products are
    exact in f32 (an fp16 value times a small integer)."""
    gs, sgs = spec.group_size, spec.super_group_size
    ss = params.super_scale.float().repeat_interleave(sgs, dim=1)
    sz = params.super_zero.float().repeat_interleave(sgs, dim=1)
    sq = params.scale_q.float().repeat_interleave(gs, dim=1)
    zq = params.zero_q.float().repeat_interleave(gs, dim=1)
    return ss * sq, sz * zq


def quantize(x: torch.Tensor, params: SuperGroupParams, qtype: GGMLQuantizationType,
             eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Elementwise quantize a (d_row, d_col) matrix to integer codes."""
    spec = KQUANT_SPECS[qtype]
    scale, offset = _expanded_scales(params, spec, x.shape[1])
    q = torch.round((x.float() + offset) / torch.clamp_min(scale, _f32(eps)))
    return torch.clamp(q, spec.qmin, spec.qmax).to(_int_dtype(spec))


def dequantize(q: torch.Tensor, params: SuperGroupParams,
               qtype: GGMLQuantizationType) -> torch.Tensor:
    """Elementwise dequantize integer codes back to f32."""
    spec = KQUANT_SPECS[qtype]
    scale, offset = _expanded_scales(params, spec, q.shape[1])
    return scale * q.float() - offset


def quantize_column_slice(w_col: torch.Tensor, params: SuperGroupParams,
                          qtype: GGMLQuantizationType, sg_idx, g_idx,
                          eps: float = DEFAULT_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize and dequantize one column: (d_row,) -> (q, w_q)."""
    spec = KQUANT_SPECS[qtype]
    s = params.super_scale[:, sg_idx].float() * params.scale_q[:, g_idx].float()
    z = params.super_zero[:, sg_idx].float() * params.zero_q[:, g_idx].float()
    q = torch.clamp(torch.round((w_col + z) / torch.clamp_min(s, _f32(eps))),
                    spec.qmin, spec.qmax)
    return q, s * q - z


def quantize_rtn(x: torch.Tensor, qtype: GGMLQuantizationType,
                 cfg: ScaleSearchConfig = ScaleSearchConfig(),
                 imatrix: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, SuperGroupParams]:
    """Round-to-nearest K-quant of a full matrix (no Hessian solve)."""
    params = fit_supergroups(x, qtype, cfg, imatrix)
    return quantize(x, params, qtype), params


def dequantize_rtn(x, qtype, cfg=ScaleSearchConfig()):
    q, params = quantize_rtn(x, qtype, cfg)
    return dequantize(q, params, qtype)
