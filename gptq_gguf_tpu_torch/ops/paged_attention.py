"""Flash-decode over a paged KV cache: one query token per slot.

Port of ``gptq_gguf_tpu/ops/paged_attention.py``. The hand-written kernel
(``csrc/paged_decode.cu``) reads only the live pages of each slot's block
table from the shared pools, so decode KV traffic is ``length // page + 1``
pages per kv head instead of the slot's whole provisioned cache. It runs
in two passes (flash-decoding): each (slot, kv head)'s pages are split
into ``n_split`` ranges, one block each, which stage K / V in shared
memory in their stored type through a ring of ``cp.async`` copies and fold
them into a partial online softmax (max, denominator, unnormalised
output); the partials are then joined in split order, the sink mass added
and the sum divided. ``n_split`` comes from the shapes alone
(``_split_plan``), never from ``lengths`` or ``table``, so the wrapper
reads no device tensor on the host. What bounds it is bytes: each attended
position is read once per kv head for ~4 G hd f32 operations.

Layouts are the JAX package's:

* ``q``: (B, nKV, G, hd), the query before the softmax scale;
* bf16 / f32 pools: (n_pages, nKV, page, hd) K and V;
* int4 pools (combined layout): codes (n_pages, nKV, page, hd) u8, k's
  packed bytes in [0, hd/2) and v's after, split-nibble per half, codes
  carrying +8; scales (n_pages, nKV, 2 * hd / 32, page) f32, k's groups
  first, positions on the last axis;
* ``table``: (B, pps) int32 page ids, -1 for unassigned (read as page 0);
* ``lengths``: (B,) int32 query positions: the cache holds [0, lengths[b]].

Both return (B, nKV, G, hd) f32. A CUDA ``q`` launches the kernel (or
raises); a CPU ``q`` runs the plain PyTorch version beside it, which
gathers the slot's pages, dequantizes where needed and runs a masked
softmax in f32. ``paged_flash_decode_split_reference`` (and ``_q4_``) model
the kernel's two passes on the CPU; nothing on the serving path calls
them. The JAX package's Mosaic tiling rules (``page % 128``, the
zero-padded query planes of its int4 kernel) are not carried over: the
kernel takes hd 64, 96 (bf16 / f32 pools: Phi-3's heads), 128, 192 and 256,
any page up to 256 and up to 16 query heads per kv head, and raises on
anything else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..models.llama import KV_Q4_GROUP, dequant_kv_q4

MAX_HEAD_DIM = 256
HEAD_DIMS = (64, 96, 128, 192, 256)  # the kernel's instances; int4 pools: multiples of 64
MAX_PAGE = 256
MAX_GROUP = 16
_MODES = {torch.float32: 0, torch.bfloat16: 1}
_MODE_Q4 = 2
SPLIT_BLOCKS_PER_SM = 4  # split blocks _split_plan aims for per SM on a full table
MIN_SPLIT_POSITIONS = 64  # no split smaller than one staged chunk
MAX_SPLITS = 64  # the kernel's limit


def _gather_slot_kv(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(n_pages, nKV, page, hd) + (B, pps) -> (B, nKV, pps * page, hd);
    unassigned entries read page 0."""
    g = pool[table.clamp_min(0).long()]  # (B, pps, nKV, page, hd)
    B, pps, nKV, page, hd = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, nKV, pps * page, hd)


def _gather_slot_scales_t(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(n_pages, nKV, ng2, page) + (B, pps) -> (B, nKV, pps * page, ng2)."""
    g = pool[table.clamp_min(0).long()]  # (B, pps, nKV, ng2, page)
    B, pps, nKV, ng2, page = g.shape
    return g.permute(0, 2, 1, 4, 3).reshape(B, nKV, pps * page, ng2)


def _gather_q4(kv_pages, s_pages, table, hd):
    """The slots' dequantized K and V, (B, nKV, pps * page, hd) f32 each,
    from the combined int4 pools."""
    ngk = hd // KV_Q4_GROUP
    codes = _gather_slot_kv(kv_pages, table)
    scales = _gather_slot_scales_t(s_pages, table)
    return (dequant_kv_q4(codes[..., : hd // 2], scales[..., :ngk]),
            dequant_kv_q4(codes[..., hd // 2:], scales[..., ngk:]))


def _scores(q, k_all, lengths, scale, window, softcap):
    """(B, nKV, G, T) f32 scores over gathered K, softcapped before
    masking as the kernel, and the (B, T) mask of attended positions."""
    s = torch.einsum("bkgh,bkth->bkgt", q.float() * scale, k_all.float())
    if softcap:
        s = softcap * torch.tanh(s * (1.0 / softcap))
    pos = torch.arange(k_all.shape[2], device=q.device)[None, :]
    L = lengths.long()[:, None]
    valid = pos <= L
    if window:
        valid = valid & (pos > L - window)
    return s, valid


def _masked_decode(q, k_all, v_all, lengths, scale, window, sinks, softcap):
    """Masked softmax over gathered (B, nKV, T, hd) K / V in f32."""
    B, nKV, G, _ = q.shape
    s, valid = _scores(q, k_all, lengths, scale, window, softcap)
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, -1e30)
    m = s.amax(dim=-1)
    if sinks is not None:
        sk = sinks.float().reshape(nKV, G)[None]
        m = torch.maximum(m, sk)
    e = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    denom = e.sum(dim=-1)
    if sinks is not None:
        denom = denom + torch.exp(sk - m)
    p = e / torch.clamp_min(denom, 1e-30)[..., None]
    return torch.einsum("bkgt,bkth->bkgh", p, v_all.float())


def paged_flash_decode_reference(q, k_pages, v_pages, table, lengths, *, scale: float,
                                 window: int = 0, sinks=None, softcap: float = 0.0):
    """Plain PyTorch version of the bf16 / f32 kernel, on any device."""
    return _masked_decode(q, _gather_slot_kv(k_pages, table), _gather_slot_kv(v_pages, table),
                          lengths, scale, window, sinks, softcap)


def paged_flash_decode_q4_reference(q, kv_pages, s_pages, table, lengths, *, scale: float,
                                    window: int = 0, sinks=None, softcap: float = 0.0):
    """Plain PyTorch version of the int4 kernel: gather, dequantize, then
    the masked softmax."""
    k_all, v_all = _gather_q4(kv_pages, s_pages, table, q.shape[-1])
    return _masked_decode(q, k_all, v_all, lengths, scale, window, sinks, softcap)


def _split_plan(B: int, nKV: int, pps: int, page: int, n_sm: int) -> tuple[int, int]:
    """(n_split, pages per split) of the kernel's grid, from shapes alone:
    about SPLIT_BLOCKS_PER_SM blocks per SM when every page of the table
    is live, no split under MIN_SPLIT_POSITIONS positions, at most
    MAX_SPLITS splits, every page of [0, pps) in exactly one split and no
    split past pps."""
    want = -(-SPLIT_BLOCKS_PER_SM * n_sm // (B * nKV))
    per = max(-(-pps // want), -(-MIN_SPLIT_POSITIONS // page), -(-pps // MAX_SPLITS), 1)
    per = min(per, pps)
    return -(-pps // per), per


def _split_partials(q, k_all, v_all, lengths, scale, window, softcap, page, pps_split,
                    n_split):
    """Pass 1 of the kernel, plainly: per split of ``pps_split`` pages, the
    masked softmax state (max m, denominator l, unnormalised acc) over the
    split's positions; an empty split gives m = -1e30, l = 0, acc = 0."""
    s, valid = _scores(q, k_all, lengths, scale, window, softcap)
    split_of = torch.arange(k_all.shape[2], device=q.device)[None, :] // (pps_split * page)
    ms, ls, accs = [], [], []
    for sp in range(n_split):
        mask = (valid & (split_of == sp))[:, None, None, :]
        m = torch.where(mask, s, -1e30).amax(dim=-1)
        e = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        ms.append(m)
        ls.append(e.sum(dim=-1))
        accs.append(torch.einsum("bkgt,bkth->bkgh", e, v_all.float()))
    return torch.stack(ms, 2), torch.stack(ls, 2), torch.stack(accs, 2)


def _combine_partials(m, l, acc, sinks):
    """Pass 2 of the kernel, plainly: (B, nKV, n_split, G[, hd]) partials
    joined in split order, the sink mass added, then the division."""
    B, nKV, n_split, G = m.shape
    M = m.amax(dim=2)
    if sinks is not None:
        sk = sinks.float().reshape(nKV, G)[None]
        M = torch.maximum(M, sk)
    L = torch.zeros_like(M)
    A = torch.zeros_like(acc[:, :, 0])
    for sp in range(n_split):  # fixed order, as the kernel
        w = torch.exp(m[:, :, sp] - M)
        L = L + l[:, :, sp] * w
        A = A + acc[:, :, sp] * w[..., None]
    if sinks is not None:
        L = L + torch.exp(sk - M)
    return A / torch.clamp_min(L, 1e-30)[..., None]


def _split_decode(q, k_all, v_all, lengths, page, pps, n_split, scale, window, sinks,
                  softcap):
    per = -(-pps // n_split)
    parts = _split_partials(q, k_all, v_all, lengths, scale, window, softcap, page, per,
                            -(-pps // per))
    return _combine_partials(*parts, sinks)


def paged_flash_decode_split_reference(q, k_pages, v_pages, table, lengths, *, scale: float,
                                       n_split: int, window: int = 0, sinks=None,
                                       softcap: float = 0.0):
    """The bf16 / f32 kernel's two passes in plain PyTorch: partials over
    ``n_split`` page ranges (``ceil(pps / n_split)`` pages each), joined in
    split order. Same function as ``paged_flash_decode_reference``."""
    return _split_decode(q, _gather_slot_kv(k_pages, table), _gather_slot_kv(v_pages, table),
                         lengths, k_pages.shape[2], table.shape[1], n_split, scale, window,
                         sinks, softcap)


def paged_flash_decode_q4_split_reference(q, kv_pages, s_pages, table, lengths, *,
                                          scale: float, n_split: int, window: int = 0,
                                          sinks=None, softcap: float = 0.0):
    """The int4 kernel's two passes in plain PyTorch (as
    ``paged_flash_decode_split_reference``, over dequantized K / V)."""
    k_all, v_all = _gather_q4(kv_pages, s_pages, table, q.shape[-1])
    return _split_decode(q, k_all, v_all, lengths, kv_pages.shape[2], table.shape[1], n_split,
                         scale, window, sinks, softcap)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The bound C entry point (library built and loaded on first use)."""
    from .cuda_build import load

    fn = load("paged_decode").gg_paged_flash_decode
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                         f"contiguous={t.is_contiguous()}; want {dtype} {tuple(shape)} "
                         f"contiguous on {device}")


def _launch(mode: int, q, k_pool, v_pool, table, lengths, scale, window, sinks, softcap):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, nKV, G, hd), got {tuple(q.shape)}")
    B, nKV, G, hd = q.shape
    if hd not in HEAD_DIMS or (mode == _MODE_Q4 and hd % 64) or not 1 <= G <= MAX_GROUP:
        raise ValueError(f"the kernel takes hd in {HEAD_DIMS} (int4 pools: a multiple of 64) "
                         f"and 1-{MAX_GROUP} query heads per kv head, got hd={hd}, G={G}")
    n_pool = k_pool.shape[0]
    page = k_pool.shape[2]
    if not 1 <= page <= MAX_PAGE:
        raise ValueError(f"the kernel takes pages of 1-{MAX_PAGE} positions, got {page}")
    dev = q.device
    if mode == _MODE_Q4:
        _check(k_pool, "kv_pages", (n_pool, nKV, page, hd), torch.uint8, dev)
        _check(v_pool, "s_pages", (n_pool, nKV, 2 * hd // KV_Q4_GROUP, page), torch.float32,
               dev)
    else:
        _check(k_pool, "k_pages", (n_pool, nKV, page, hd), k_pool.dtype, dev)
        _check(v_pool, "v_pages", (n_pool, nKV, page, hd), k_pool.dtype, dev)
    if any(t.data_ptr() % 16 for t in (k_pool, v_pool)):
        raise ValueError("the page pools must start on a 16-byte boundary")
    pps = table.shape[1] if table.dim() == 2 else -1
    _check(table, "table", (B, pps), torch.int32, dev)
    _check(lengths, "lengths", (B,), torch.int32, dev)
    qf = q.float().contiguous()
    sk = None
    if sinks is not None:
        sk = sinks.float().contiguous()
        _check(sk, "sinks", (nKV * G,), torch.float32, dev)
    out = torch.empty((B, nKV, G, hd), dtype=torch.float32, device=dev)
    n_split, per = _split_plan(B, nKV, pps, page, _sm_count(dev.index or 0))
    part = torch.empty(B * nKV * n_split * G * (hd + 2), dtype=torch.float32, device=dev)
    rc = _kernel_fn()(
        qf.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), mode, table.data_ptr(),
        lengths.data_ptr(), None if sk is None else sk.data_ptr(), out.data_ptr(),
        part.data_ptr(), B, nKV, G, hd, page, pps, n_pool, n_split, per, float(scale),
        int(window or 0), float(softcap or 0.0), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {rc}")
    return out


def paged_flash_decode(q, k_pages, v_pages, table, lengths, *, scale: float, window: int = 0,
                       sinks: Optional[torch.Tensor] = None,
                       softcap: float = 0.0) -> torch.Tensor:
    """Decode attention straight off bf16 or f32 page pools (module
    docstring). window: sliding-window size (0 = full attention; pages
    wholly below the window are never read). sinks: optional (nKV * G,)
    sink logits joining the softmax denominator. softcap: logit softcap
    applied before masking (0 = off). Returns (B, nKV, G, hd) f32."""
    if q.device.type == "cpu":
        return paged_flash_decode_reference(q, k_pages, v_pages, table, lengths, scale=scale,
                                            window=window, sinks=sinks, softcap=softcap)
    if k_pages.dtype not in _MODES:
        raise ValueError(f"pools must be bf16 or f32, got {k_pages.dtype}")
    out = _launch(_MODES[k_pages.dtype], q, k_pages, v_pages, table, lengths, scale, window,
                  sinks, softcap)
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0


def paged_flash_decode_q4(q, kv_pages, s_pages, table, lengths, *, scale: float,
                          window: int = 0, sinks: Optional[torch.Tensor] = None,
                          softcap: float = 0.0) -> torch.Tensor:
    """paged_flash_decode over the combined int4 pools (module docstring):
    decode reads hd / 2 + hd / 8 bytes per cached position and kv head for
    each of k and v, against 2 * hd in bf16. Returns (B, nKV, G, hd) f32."""
    if q.device.type == "cpu":
        return paged_flash_decode_q4_reference(q, kv_pages, s_pages, table, lengths,
                                               scale=scale, window=window, sinks=sinks,
                                               softcap=softcap)
    out = _launch(_MODE_Q4, q, kv_pages, s_pages, table, lengths, scale, window, sinks,
                  softcap)
    paged_flash_decode_q4.launches += 1
    return out


paged_flash_decode_q4.launches = 0

