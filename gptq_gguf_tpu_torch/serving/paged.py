"""Paged KV cache: block-table attention for serving.

Port of ``gptq_gguf_tpu/serving/paged.py``. K/V live in shared page pools
and each slot owns a list of pages (vLLM-style block tables), so memory
follows the actual context and freed pages recycle across requests. The
host-side allocator hands out pages (``PageAllocator``); the engine is
``engine.PagedContinuousBatchingEngine``.

Decode (one token per slot) reads the pools through the paged flash-decode
kernel (``ops/paged_attention.py``); prefill gathers the slot's pages into
the contiguous cache's attention, as the JAX package does.

Pools are updated in place. Each pool has one row more than the allocator
hands out: row ``n_pages`` is a drop page that absorbs writes to unassigned
(-1) or out-of-table pages (the JAX package drops them with
``.at[...].set(mode="drop")``; indexing a PyTorch pool with -1 would write
the last page, another slot's). The allocator and the kernel never see it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import llama
from ..models.llama import LlamaConfig
from ..ops import paged_attention
from ..ops.paged_attention import _gather_slot_kv, _gather_slot_scales_t
from . import model as qmodel
from .model import _q_linear


class PagedKVCache(NamedTuple):
    """bf16 / f32 caches: ``k_pages`` / ``v_pages`` hold per layer
    (n_pages + 1, nKV, page, hd) K / V pools.

    int4 caches (the JAX package's combined layout): ``k_pages`` holds the
    packed codes (n_pages + 1, nKV, page, hd) u8, k's in [0, hd/2) and v's
    after; ``v_pages`` the group scales (n_pages + 1, nKV, 2 * hd / 32,
    page) f32, k's groups first, positions last. int4 is told by the u8
    code dtype (``q4``). The last row of every pool is the drop page."""

    k_pages: List[torch.Tensor]
    v_pages: List[torch.Tensor]
    page_table: torch.Tensor  # (B, pages_per_slot) int32, -1 = unassigned
    lengths: torch.Tensor     # (B,) int32

    @property
    def q4(self) -> bool:
        return self.k_pages[0].dtype == torch.uint8

    @property
    def page_size(self) -> int:
        return self.k_pages[0].shape[2]

    @property
    def n_pages(self) -> int:
        """Pages the allocator hands out (the drop page excluded)."""
        return self.k_pages[0].shape[0] - 1

    @property
    def max_len(self) -> int:
        return self.page_table.shape[1] * self.page_size


def init_paged_cache(cfg: LlamaConfig, batch: int, max_len: int, page_size: int = 64,
                     n_pages: Optional[int] = None, dtype=torch.bfloat16,
                     kv_dtype: Optional[str] = None, device="cuda") -> PagedKVCache:
    """Zeroed pools. n_pages defaults to full provisioning (batch * max_len
    / page_size); pass less to oversubscribe (the engine then admits only
    what fits). kv_dtype "int4": packed-code pools plus group-scale pools."""
    dev = resolve_device(device)
    if max_len % page_size:
        raise ValueError(f"max_len {max_len} is not a multiple of page_size {page_size}")
    pps = max_len // page_size
    if n_pages is None:
        n_pages = batch * pps
    hd = cfg.head_dim_
    n = cfg.num_hidden_layers
    nkv = cfg.num_key_value_heads
    if kv_dtype == "int4":
        if hd % (2 * llama.KV_Q4_GROUP):
            raise NotImplementedError(
                f"int4 paged KV needs head_dim divisible by {2 * llama.KV_Q4_GROUP}, got {hd}")
        shape_c = (n_pages + 1, nkv, page_size, hd)
        shape_s = (n_pages + 1, nkv, 2 * hd // llama.KV_Q4_GROUP, page_size)
        k = [torch.zeros(shape_c, dtype=torch.uint8, device=dev) for _ in range(n)]
        v = [torch.zeros(shape_s, dtype=torch.float32, device=dev) for _ in range(n)]
    elif kv_dtype in (None, "bf16"):
        shape = (n_pages + 1, nkv, page_size, hd)
        k = [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(n)]
        v = [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(n)]
    else:
        raise ValueError(f"unsupported paged kv_dtype {kv_dtype!r}")
    return PagedKVCache(k, v, torch.full((batch, pps), -1, dtype=torch.int32, device=dev),
                        torch.zeros((batch,), dtype=torch.int32, device=dev))


def paged_cache_from_numpy(k_pages, v_pages, page_table, lengths, device="cuda") -> PagedKVCache:
    """The JAX package's paged cache, given as numpy (per-layer pools of
    n_pages rows), as the port's: each pool gains its zeroed drop page."""
    dev = resolve_device(device)

    def pool(a):
        t = qmodel._to_tensor(a, dev)
        return torch.cat([t, torch.zeros_like(t[:1])])

    return PagedKVCache([pool(a) for a in k_pages], [pool(a) for a in v_pages],
                        qmodel._to_tensor(np.asarray(page_table, np.int32), dev),
                        qmodel._to_tensor(np.asarray(lengths, np.int32), dev))


def _page_slots(pool_rows: int, table: torch.Tensor, positions: torch.Tensor,
                page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page id, offset) per (B, S) position; unassigned (-1) or
    out-of-table pages map to the drop page (row pool_rows - 1)."""
    pps = table.shape[1]
    page_idx = positions // page_size
    ids = torch.gather(table, 1, page_idx.clamp(0, pps - 1)).long()
    ids = torch.where((ids < 0) | (page_idx >= pps), pool_rows - 1, ids)
    return ids, positions % page_size


def _write_paged(pool: torch.Tensor, table: torch.Tensor, positions: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """Scatter (B, S, nKV, hd) vals at absolute (B, S) positions into the
    (n_pages + 1, nKV, page, hd) pool, IN PLACE; returns the pool."""
    ids, offs = _page_slots(pool.shape[0], table, positions, pool.shape[2])
    pool[ids, :, offs, :] = vals.to(pool.dtype)
    return pool


def _write_paged_t(pool: torch.Tensor, table: torch.Tensor, positions: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """_write_paged for the transposed scale pools (n_pages + 1, nKV, ng2,
    page), positions on the last axis; vals (B, S, nKV, ng2). The advanced
    indices around the slices put (B, S) first, as numpy and JAX do."""
    ids, offs = _page_slots(pool.shape[0], table, positions, pool.shape[3])
    pool[ids, :, :, offs] = vals.to(pool.dtype)
    return pool


def forward_paged(params: Dict[str, Any], cfg: LlamaConfig, input_ids: torch.Tensor,
                  cache: PagedKVCache,
                  n_valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, PagedKVCache]:
    """forward_cached over a paged cache (see that docstring for n_valid):
    the pools are written IN PLACE; returns (logits (B, vocab) f32, the
    cache with advanced lengths). Takes fused (``qkv_proj``,
    ``gateup_proj``) and unfused projections alike. The kernel gets each
    layer's window, the attention softcap and the score scale; longrope
    picks its factors by the slot's capacity (pages per slot times page)."""
    B, S = input_ids.shape
    hd = cfg.head_dim_
    lengths = cache.lengths
    dev = input_ids.device
    positions = lengths[:, None].long() + torch.arange(S, device=dev)[None, :]
    cos, sin = llama.rope_cos_sin_all(cfg, positions, seq_len=cache.max_len)
    table = cache.page_table
    q4 = cache.q4
    scale = llama.attention_scale(cfg)

    x = llama.embed_forward(params, input_ids, cfg)
    for li, layer in enumerate(params["layers"]):
        window = llama.layer_window(cfg, li)
        h = llama.apply_norm(x, cfg, layer["input_layernorm"])
        if "qkv_proj" in layer:
            qkv = _q_linear(h, layer["qkv_proj"])
            kv_dim = cfg.num_key_value_heads * hd
            d_q = qkv.shape[-1] - 2 * kv_dim
            q, k, v = qkv[..., :d_q], qkv[..., d_q:d_q + kv_dim], qkv[..., d_q + kv_dim:]
        else:
            q = _q_linear(h, layer["q_proj"])
            k = _q_linear(h, layer["k_proj"])
            v = _q_linear(h, layer["v_proj"])
        q, k, v = llama.add_qkv_bias(q, k, v, layer)
        nH = q.shape[-1] // hd
        nKV = k.shape[-1] // hd
        q = q.reshape(B, S, nH, hd).transpose(1, 2)
        k = k.reshape(B, S, nKV, hd).transpose(1, 2)
        v = v.reshape(B, S, nKV, hd)
        q, k = llama.head_qk_norm(q, k, layer, cfg)
        cos_l, sin_l = llama.select_rope(cos, sin, cfg, li)
        q, k = llama.apply_rope(q, k, cos_l, sin_l)
        k = k.transpose(1, 2)  # (B, S, nKV, hd)

        k_pool, v_pool = cache.k_pages[li], cache.v_pages[li]
        if q4:
            kq, ks = qmodel._quantize_kv_q4(k)
            vq, vs = qmodel._quantize_kv_q4(v)
            # combined layout: codes side by side, scales k groups first
            _write_paged(k_pool, table, positions, torch.cat([kq, vq], dim=-1))
            _write_paged_t(v_pool, table, positions, torch.cat([ks, vs], dim=-1))
        else:
            _write_paged(k_pool, table, positions, k)
            _write_paged(v_pool, table, positions, v)

        if S == 1:
            # the kernel walks the block table: only live pages are read
            qk = q[:, :, 0].reshape(B, nKV, nH // nKV, hd)
            decode = (paged_attention.paged_flash_decode_q4 if q4
                      else paged_attention.paged_flash_decode)
            attn = decode(qk, k_pool, v_pool, table, lengths,
                          scale=scale if scale is not None else 1.0 / math.sqrt(hd),
                          window=window or 0, softcap=cfg.attn_logit_softcap or 0.0)
            attn = attn.reshape(B, nH, 1, hd).to(q.dtype)
        else:
            if q4:
                codes = _gather_slot_kv(k_pool, table)
                scales = _gather_slot_scales_t(v_pool, table)
                ngk = hd // llama.KV_Q4_GROUP
                k_all = llama.dequant_kv_q4(codes[..., : hd // 2], scales[..., :ngk])
                v_all = llama.dequant_kv_q4(codes[..., hd // 2:], scales[..., ngk:])
            else:
                k_all = _gather_slot_kv(k_pool, table)
                v_all = _gather_slot_kv(v_pool, table)
            attn = qmodel._cached_attention(q, k_all, v_all, lengths, scale,
                                            cfg.attn_logit_softcap, window)
        attn = attn.transpose(1, 2).reshape(B, S, nH * hd)
        x = qmodel._mlp_block(x, qmodel._o_proj(attn, layer), layer, cfg)

    if n_valid is None:
        last = x[:, -1, :]
        advance = S
    else:
        last = x[torch.arange(B, device=dev), n_valid.long() - 1, :]
        advance = n_valid
    logits = qmodel._head_logits(params, cfg, llama.apply_norm(last, cfg, params["norm"]))
    return logits, cache._replace(lengths=(lengths + advance).to(torch.int32))


class PageAllocator:
    """Host-side free list over the shared page pools."""

    def __init__(self, n_pages: int):
        self.free: List[int] = list(range(n_pages - 1, -1, -1))

    def alloc(self, n: int) -> Optional[List[int]]:
        if len(self.free) < n:
            return None
        return [self.free.pop() for _ in range(n)]

    def release(self, pages) -> None:
        for p in pages:
            if p >= 0:
                self.free.append(int(p))

    @property
    def available(self) -> int:
        return len(self.free)
