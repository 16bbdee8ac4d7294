"""GPTQ solver in PyTorch, with the column-block solve as a CUDA kernel.

Port of ``gptq_gguf_tpu/ops/gptq.py``:

* Hessian accumulation is the reference's EMA of X^T X, one f32 GEMM per
  batch (TF32 stays off: the caller's entry point sets it so).
* The factorization is the reversed-Cholesky identity: with J the exchange
  matrix, one Cholesky of J H J gives H = Ur Ur^T with Ur upper, and
  U = Ur^-1 satisfies H^-1 = U^T U. Non-finite factors fall back to the
  identity and raise the issue flag, as the reference does.
* The column loop runs block by block. At each supergroup boundary the
  dynamic scales are refit on the current residual; each block's
  recurrence (128 columns by default, any width) is one launch of
  ``csrc/gptq_solve.cu`` (its plain PyTorch version for CPU tensors); the
  trailing columns take one f32 GEMM of the block's errors.
* act_order (stable argsort of the Hessian diagonal), static groups and the
  Q3_K special case follow the reference.

Rows are independent given U, which is what the kernel exploits: each row
is spread over a few lanes of one warp, its columns in their registers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..formats.ggml import KQUANT_SPECS, GGMLQuantizationType
from . import kquant
from .kquant import ScaleSearchConfig, SuperGroupParams

# d_col above which the factorization runs on host LAPACK (scipy)
HOST_FACTORIZE_THRESHOLD = 16384


class GPTQConfig(NamedTuple):
    """GPTQ hyperparameters (the reference's defaults)."""

    rel_damp: float = 1e-2
    block_size: int = 128
    act_order: bool = False
    static_groups: bool = False
    scale_cfg: ScaleSearchConfig = ScaleSearchConfig()


class GPTQResult(NamedTuple):
    qweight: torch.Tensor  # (d_row, d_col) integer codes
    params: SuperGroupParams
    issue_non_invertible: bool


# ---------------------------------------------------------------------------
# Hessian accumulation
# ---------------------------------------------------------------------------


def init_hessian(d_col: int, device="cuda") -> Tuple[torch.Tensor, float]:
    return torch.zeros((d_col, d_col), dtype=torch.float32, device=device), 0.0


def accumulate_hessian(H: torch.Tensor, num_samples: float,
                       x: torch.Tensor) -> Tuple[torch.Tensor, float]:
    """EMA update ``H <- beta H + alpha X^T X`` in place; ``x`` is
    (batch, ..., d_col) and batch counts sequences, as in the reference.
    The weights are formed in f32, as the JAX package forms them."""
    batch = x.shape[0]
    x2 = x.reshape(-1, x.shape[-1]).float()
    n = np.float32(num_samples)
    beta = float(n / (n + np.float32(batch)))
    alpha = float(np.float32(2.0) / (n + np.float32(batch)))
    H.addmm_(x2.T, x2, beta=beta, alpha=alpha)
    return H, num_samples + batch


# ---------------------------------------------------------------------------
# Cholesky pipeline
# ---------------------------------------------------------------------------


def _mask_and_damp(H: torch.Tensor, W: torch.Tensor,
                   rel_damp: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pruned-channel / dead-column masking and damping (the reference's).
    Returns new (W_masked, H_damped); the arguments are left as they are."""
    W = W.float().clone()
    H = H.float().clone()
    pruned = H.diagonal() == 0
    H.diagonal()[pruned] = 1.0
    W[:, pruned] = 0.0
    zero_cols = (W == 0).all(dim=0)
    H[zero_cols, :] = 0.0
    H[:, zero_cols] = 0.0
    H.diagonal()[zero_cols] = 1.0
    damp = rel_damp * H.diagonal().mean()
    H.diagonal().add_(damp)
    return W, H


def _factorize_device(H: torch.Tensor) -> torch.Tensor:
    """Upper U with H^-1 = U^T U, on H's device. A Cholesky that fails
    leaves non-finite values, which the caller turns into the fallback."""
    n = H.shape[0]
    Lr, info = torch.linalg.cholesky_ex(H.flip(0, 1))
    Ur = Lr.flip(0, 1)
    del Lr
    eye = torch.eye(n, dtype=torch.float32, device=H.device)
    U = torch.linalg.solve_triangular(Ur, eye, upper=True)
    if int(info) != 0:
        U.fill_(float("nan"))
    return U


def _factorize_host(H: torch.Tensor) -> torch.Tensor:
    """The same factorization through host LAPACK (scipy)."""
    import scipy.linalg as sla

    Hn = H.detach().cpu().numpy()
    n = Hn.shape[0]
    try:
        Lr = sla.cholesky(Hn[::-1, ::-1], lower=True, check_finite=False)
        Ur = np.ascontiguousarray(Lr[::-1, ::-1])
        U = sla.solve_triangular(Ur, np.eye(n, dtype=np.float32), lower=False,
                                 check_finite=False)
    except Exception:  # LinAlgError or non-finite input: the caller falls back
        U = np.full((n, n), np.nan, dtype=np.float32)
    return torch.from_numpy(np.ascontiguousarray(U, dtype=np.float32)).to(H.device)


def factorize_hinv_cholesky(H: torch.Tensor, method: str = "auto") -> Tuple[torch.Tensor, bool]:
    """(U, issue): upper-triangular U with H^-1 = U^T U, or the identity and
    True when the factorization is not finite."""
    d_col = H.shape[0]
    if method == "auto":
        method = "host" if d_col > HOST_FACTORIZE_THRESHOLD else "device"
    U = _factorize_host(H) if method == "host" else _factorize_device(H)
    bad = not bool(torch.isfinite(U).all())
    if bad:
        U = torch.eye(d_col, dtype=torch.float32, device=H.device)
    return U, bad


def prepare_hessian_inverse(H: torch.Tensor, W: torch.Tensor, rel_damp: float,
                            method: str = "auto"):
    """Regularize H, zero dead columns, factorize: (W_masked, U, issue)."""
    W, H = _mask_and_damp(H, W, rel_damp)
    U, bad = factorize_hinv_cholesky(H, method)
    return W, U, bad


# ---------------------------------------------------------------------------
# The column-block solve: kernel and plain version
# ---------------------------------------------------------------------------


def solve_block_reference(w_blk: torch.Tensor, u_blk: torch.Tensor, s_blk: torch.Tensor,
                          z_blk: torch.Tensor, qmin: float, qmax: float,
                          eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the block solve, on any device: for each
    column i of the block,

        q   = clip(round((w_i + z_i) / max(s_i, eps)), qmin, qmax)
        err = (w_i - (s_i * q - z_i)) / U_ii
        w[:, j] -= err * U[i, j]   for j > i

    Returns (q, err), both (d_row, bs) f32. Every step is one IEEE f32
    operation (no fused multiply-add), which the kernel repeats in the same
    order, so the two agree bit for bit."""
    w = w_blk.float().clone()
    d_row, bs = w.shape
    q = torch.empty_like(w)
    err = torch.empty_like(w)
    for i in range(bs):
        col = w[:, i]
        s = s_blk[:, i]
        z = z_blk[:, i]
        qi = torch.clamp(torch.round((col + z) / torch.clamp_min(s, eps)), qmin, qmax)
        e = (col - (s * qi - z)) / u_blk[i, i]
        if i + 1 < bs:
            w[:, i + 1:] -= e[:, None] * u_blk[i, i + 1:][None, :]
        q[:, i] = qi
        err[:, i] = e
    return q, err


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The bound C entry point (library built and loaded on first use)."""
    from .cuda_build import load

    fn = load("gptq_solve").gg_gptq_solve_block
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def solve_block(w_blk: torch.Tensor, u_blk: torch.Tensor, s_blk: torch.Tensor,
                z_blk: torch.Tensor, qmin: float, qmax: float,
                eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, err) of one column block. CUDA tensors launch
    ``csrc/gptq_solve.cu`` on the current stream and count one launch; CPU
    tensors run ``solve_block_reference``. The kernel takes blocks of any
    width (128 columns in registers at a time) and raises on anything it
    does not take."""
    if w_blk.device.type == "cpu":
        return solve_block_reference(w_blk, u_blk, s_blk, z_blk, qmin, qmax, eps)
    if w_blk.device.type != "cuda":
        raise ValueError(f"unsupported device {w_blk.device}")
    d_row, bs = w_blk.shape
    for name, t, shape in (("w", w_blk, (d_row, bs)), ("u", u_blk, (bs, bs)),
                           ("s", s_blk, (d_row, bs)), ("z", z_blk, (d_row, bs))):
        if t.device != w_blk.device or t.dtype != torch.float32 or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"contiguous={t.is_contiguous()}; want f32 {shape} contiguous "
                             f"on {w_blk.device}")
    q = torch.empty_like(w_blk)
    err = torch.empty_like(w_blk)
    rc = _kernel_fn()(w_blk.data_ptr(), u_blk.data_ptr(), s_blk.data_ptr(), z_blk.data_ptr(),
                      q.data_ptr(), err.data_ptr(), d_row, bs, float(qmin), float(qmax),
                      float(eps), torch.cuda.current_stream(w_blk.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gptq_solve launch failed: CUDA error {rc}")
    solve_block.launches += 1
    return q, err


solve_block.launches = 0


# ---------------------------------------------------------------------------
# Blocked column loop
# ---------------------------------------------------------------------------


def _params_f32(p: SuperGroupParams):
    return tuple(t.float() for t in p)


def _solve_core(W: torch.Tensor, U: torch.Tensor, col_group: torch.Tensor,
                col_sg: torch.Tensor, init_params, qtype: GGMLQuantizationType,
                cfg: GPTQConfig):
    """Blocked GPTQ loop over W (already permuted under act_order); returns
    (f32 codes in that column order, f32 params)."""
    spec = KQUANT_SPECS[qtype]
    d_row, d_col = W.shape
    bs = cfg.block_size or d_col
    sgs = spec.super_group_size
    gpsg = spec.num_groups
    dynamic = not cfg.static_groups
    if dynamic:
        bs = min(bs, sgs)
        if sgs % bs != 0:
            raise ValueError(
                f"block_size {bs} must divide the supergroup size {sgs} for "
                "dynamic group fitting (default configuration uses 128)")
    if d_col % bs != 0:
        raise ValueError(f"d_col {d_col} must be divisible by block_size {bs}")
    eps = cfg.scale_cfg.eps

    ss, sz, sq, zq = (p.clone() for p in init_params)
    w = W.clone()  # residual, updated in place; solved columns are never read again
    qweight = torch.empty_like(w)
    for c1 in range(0, d_col, bs):
        if dynamic and c1 % sgs == 0:
            # dynamic supergroup refit on the current residual of the next
            # 256 columns
            sg = c1 // sgs
            p = kquant.fit_supergroups(w[:, c1:c1 + sgs], qtype, cfg.scale_cfg,
                                        card_sums=True)
            ss[:, sg] = p.super_scale.float()[:, 0]
            sz[:, sg] = p.super_zero.float()[:, 0]
            sq[:, sg * gpsg:(sg + 1) * gpsg] = p.scale_q.float()
            zq[:, sg * gpsg:(sg + 1) * gpsg] = p.zero_q.float()
        c2 = c1 + bs
        idx_g, idx_sg = col_group[c1:c2], col_sg[c1:c2]
        s_blk = ss[:, idx_sg] * sq[:, idx_g]
        z_blk = sz[:, idx_sg] * zq[:, idx_g]
        qblk, errs = solve_block(w[:, c1:c2].contiguous(), U[c1:c2, c1:c2].contiguous(),
                                 s_blk, z_blk, spec.qmin, spec.qmax, eps)
        qweight[:, c1:c2] = qblk
        if c2 < d_col:
            # the reference's masked update, restricted to the columns its
            # mask keeps (the rest are multiplied by zero there)
            w[:, c2:] -= errs @ U[c1:c2, c2:]
    return qweight, (ss, sz, sq, zq)


def _cast_result(qweight, params, spec):
    ss, sz, sq, zq = params
    int_dtype = torch.int8 if spec.signed else torch.uint8
    return qweight.to(int_dtype), SuperGroupParams(
        ss.to(torch.float16), sz.to(torch.float16), sq.to(int_dtype), zq.to(int_dtype))


def _solve_with_init(W32, U, col_group, col_sg, qtype, cfg: GPTQConfig):
    """Static group init (when enabled) + blocked solve + output cast."""
    spec = KQUANT_SPECS[qtype]
    d_row, d_col = W32.shape
    if cfg.static_groups:
        init = _params_f32(kquant.fit_supergroups(W32, qtype, cfg.scale_cfg, card_sums=True))
    else:
        n_sg, ng = d_col // spec.super_group_size, d_col // spec.group_size
        z = functools.partial(torch.zeros, dtype=torch.float32, device=W32.device)
        init = (z((d_row, n_sg)), z((d_row, n_sg)), z((d_row, ng)), z((d_row, ng)))
    qweight, params = _solve_core(W32, U, col_group, col_sg, init, qtype, cfg)
    return _cast_result(qweight, params, spec)


def gptq_quantize_matrix(W, H, qtype: GGMLQuantizationType, cfg: GPTQConfig = GPTQConfig(),
                         factorize: str = "auto", device="cuda") -> GPTQResult:
    """Quantize one (d_row, d_col) weight with GPTQ error correction, given
    its accumulated (d_col, d_col) Hessian (tensors or numpy arrays). On the
    card (the default) every block solve launches the kernel; with
    ``device="cpu"`` the plain version runs. ``factorize``: auto | device |
    host."""
    dev = resolve_device(device)
    W = torch.as_tensor(W).to(dev)
    H = torch.as_tensor(H).to(dev)
    spec = KQUANT_SPECS[qtype]
    d_row, d_col = W.shape
    if qtype == GGMLQuantizationType.Q3_K:  # the reference forces these off
        cfg = cfg._replace(act_order=False, static_groups=False)
    if cfg.act_order and not cfg.static_groups:
        raise ValueError("act_order requires static_groups")
    cols = torch.arange(d_col, device=W.device)
    group_of_col = cols // spec.group_size
    sg_of_col = cols // spec.super_group_size

    if cfg.act_order:
        # permute columns by descending Hessian diagonal; the static scales
        # are fit on the unpermuted masked weights, as the reference does
        W_masked, _ = _mask_and_damp(H, W, cfg.rel_damp)
        perm = torch.argsort(-H.diagonal(), stable=True)
        W32, Hd = _mask_and_damp(H[perm][:, perm], W_masked[:, perm], cfg.rel_damp)
        U, issue = factorize_hinv_cholesky(Hd, factorize)
        del Hd
        init = _params_f32(kquant.fit_supergroups(W_masked, qtype, cfg.scale_cfg,
                                                   card_sums=True))
        qweight, params = _solve_core(W32, U, group_of_col[perm], sg_of_col[perm], init,
                                      qtype, cfg)
        qweight, result = _cast_result(qweight, params, spec)
        return GPTQResult(qweight[:, torch.argsort(perm)], result, issue)

    W32, Hd = _mask_and_damp(H, W, cfg.rel_damp)
    U, issue = factorize_hinv_cholesky(Hd, factorize)
    del Hd
    qweight, result = _solve_with_init(W32, U, group_of_col, sg_of_col, qtype, cfg)
    return GPTQResult(qweight, result, issue)
