"""The v4 runtime format and its fused dequant-matmul: per-group scales and
offsets folded into one correction.

Port of ``gptq_gguf_tpu/ops/qmv4.py``. The planes are byte-identical to the
JAX package's ``RuntimeQuantLinearV4`` (input-dim-major):

* ``qs``: (d_in / per_byte, d_out) uint8, the v2 byte layout (byte k of a
  256-row supergroup holds row k in the low nibble and row k + 128 in the
  high nibble for <= 4-bit types; one byte per code for Q5_K / Q6_K);
* ``scale``: (n_groups, d_out) f32 or bf16 per-group scale, natural group
  order;
* ``offc``: (n_groups, d_out) f32 folded offset, dmin * mn + scale * shift
  (None when a type has neither a min nor a shift).

The affine offset is linear in x, so it leaves the per-weight work and
becomes one correction: y = x @ (scale * q)^T - xsum @ offc, with xsum the
group sums of the un-rounded x. The main dot rounds x, the scale and each
scale * code product to bf16 and sums in f32, as the JAX kernels do on the
MXU. The ``layout`` "i8" stores the high nibble biased by -8 so that the
signed value of (byte & 0xF0) is 16 * (hi - 8); the x16 lives in the
hi-group scales (s / 16) and the -8 in ``offc`` (offc_hi -= 8 * s).

``dequant_matmul_v4`` launches the hand-written kernel
(``csrc/qmatmul_v4.cu``: CUDA-core tiles at decode, tensor-core tiles from
``qmatmul.MMA_MIN_ROWS`` rows) for a CUDA tensor and runs its plain PyTorch
version, ``dequant_matmul_v4_reference``, for a CPU tensor. The JAX
package's ``_split_planes`` and ``select_tiles_v4`` are TPU layout rules
(x re-ordered into nibble planes for Mosaic's sublane tiling, tiles that
divide the shape): the CUDA kernel reads x rows k and k + 128 of each
supergroup directly and takes any d_out, so neither is needed.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..formats.ggml import KQUANT_SPECS, QK_K, GGMLQuantizationType
from .kquant import SuperGroupParams
from .qmatmul import (_HALF, _folded_planes_v2, _nibble_pack, _pack_codes, _ptr, _to_device,
                      c_function, launch_setup)

_SCALE_DTYPES = (torch.float32, torch.bfloat16)


class RuntimeQuantLinearV4:
    """Packed quantized weight, v4 layout (input-dim-major)."""

    def __init__(self, qs, scale, offc, d_in: int, group_size: int, per_byte: int,
                 layout: str = "i32"):
        self.qs = qs          # (d_in // per_byte, d_out) uint8
        self.scale = scale    # (n_groups, d_out) f32 or bf16
        self.offc = offc      # (n_groups, d_out) f32 or None
        self.d_in = int(d_in)
        self.group_size = int(group_size)
        self.per_byte = int(per_byte)
        self.layout = str(layout)
        self._checked_on = None  # device the kernel wrapper validated the planes for
        self._vec = 1  # columns per kernel thread, chosen with that validation

    @property
    def d_out(self) -> int:
        return self.qs.shape[1]

    @property
    def d_in_local(self) -> int:
        return self.qs.shape[0] * self.per_byte

    @property
    def has_off(self) -> bool:
        return self.offc is not None

    @property
    def packed_bits_per_weight(self) -> float:
        return self.bytes_read * 8 / (self.d_in_local * self.d_out)

    @property
    def bytes_read(self) -> int:
        """Plane bytes one matmul must read: every plane once."""
        return sum(t.numel() * t.element_size() for t in self.planes())

    def planes(self):
        return [t for t in (self.qs, self.scale, self.offc) if t is not None]

    def plane_specs(self):
        """name -> (dtype, rows) of every plane the kernel reads."""
        ng = self.d_in_local // self.group_size
        specs = {"qs": (torch.uint8, self.qs.shape[0]), "scale": (self.scale.dtype, ng)}
        if self.scale.dtype not in _SCALE_DTYPES:
            raise ValueError(f"plane scale: {self.scale.dtype}; want f32 or bf16")
        if self.layout not in ("i32", "i8"):
            raise ValueError(f"layout {self.layout!r}; want 'i32' or 'i8'")
        if self.has_off:
            specs["offc"] = (torch.float32, ng)
        return specs


def pack_runtime_v4(qweight, params: SuperGroupParams, qtype: GGMLQuantizationType,
                    scale_dtype=torch.float32, layout: str = "i32",
                    device="cuda") -> RuntimeQuantLinearV4:
    """Build the v4 format from layer codes (d_out, d_in) and their
    SuperGroupParams, in numpy exactly as the JAX package computes it (the
    scale plane rounded to ``scale_dtype`` last), then move it to
    ``device``."""
    dev = resolve_device(device)
    if layout not in ("i32", "i8"):
        raise ValueError(f"layout {layout!r}; want 'i32' or 'i8'")
    spec = KQUANT_SPECS[qtype]
    d_in = np.shape(qweight)[1]
    gs = spec.group_size
    gpsg = spec.num_groups
    ss = np.asarray(params.super_scale, np.float16).astype(np.float32)
    sq = np.asarray(params.scale_q).astype(np.float32)
    codes_t, shift = _pack_codes(qweight, qtype)
    scale = np.repeat(ss, gpsg, axis=1) * sq  # (d_out, ng), exact in f32
    offc = scale * shift if shift else None
    if not spec.signed:
        sz = np.asarray(params.super_zero, np.float16).astype(np.float32)
        zq = np.asarray(params.zero_q).astype(np.float32)
        off_min = np.repeat(sz, gpsg, axis=1) * zq
        offc = off_min if offc is None else offc + off_min

    scale_t = np.ascontiguousarray(scale.T)  # (ng, d_out)
    offc_t = None if offc is None else np.ascontiguousarray(offc.T)
    if spec.bits <= 4:
        per_byte = 2
        if layout == "i8":
            # hi nibble stored biased by -8: signed(byte & 0xF0) == 16 * (hi - 8);
            # w = s * hi = (s / 16) * (16 * (hi - 8)) + 8 * s
            d_out = codes_t.shape[1]
            c = codes_t.reshape(d_in // QK_K, QK_K, d_out)
            lo, hi = c[:, :_HALF, :], c[:, _HALF:, :]
            qs = (lo | (((hi.astype(np.int16) - 8) & 0xF) << 4).astype(np.uint8)).reshape(
                d_in // 2, d_out)
            gh = gpsg // 2  # groups per half-supergroup
            sc3 = scale_t.reshape(d_in // QK_K, gpsg, d_out)
            hi_s = sc3[:, gh:, :]
            if offc_t is None:
                offc_t = np.zeros_like(scale_t)
            of3 = offc_t.reshape(d_in // QK_K, gpsg, d_out)
            of3[:, gh:, :] -= 8.0 * hi_s
            scale_t = np.concatenate([sc3[:, :gh], hi_s / 16.0], axis=1).reshape(d_in // gs, d_out)
            offc_t = of3.reshape(d_in // gs, d_out)
        else:
            qs = _nibble_pack(codes_t)
    else:
        per_byte = 1
        qs = codes_t  # 5/6-bit codes are < 128: int8-safe as stored
    qs_t, scale_f32, offc_d = _to_device([qs, scale_t, offc_t], dev)
    return RuntimeQuantLinearV4(qs_t, scale_f32.to(scale_dtype), offc_d, d_in, gs, per_byte,
                                layout)


def v4_from_v2(rql2, scale_dtype=torch.float32) -> RuntimeQuantLinearV4:
    """A v4 weight from a v2 one, on the v2 weight's device: the qs bytes
    are shared (same layout); the scale planes are expanded per group in
    the canonical f32 op order."""
    scale, offc = _folded_planes_v2(rql2)
    return RuntimeQuantLinearV4(rql2.qs, scale.to(scale_dtype), offc, rql2.d_in,
                                rql2.group_size, rql2.per_byte)


def _codes_v4(rql: RuntimeQuantLinearV4) -> torch.Tensor:
    """(d_in, d_out) f32 code values the kernel multiplies: for the "i8"
    layout the hi plane reads as the signed value of (byte & 0xF0) =
    16 * (hi - 8), and 5/6-bit bytes as int8."""
    d_in, d_out = rql.d_in_local, rql.d_out
    if rql.per_byte == 1:
        q = rql.qs.view(torch.int8) if rql.layout == "i8" else rql.qs
        return q.float()
    if rql.layout == "i8":
        lo = rql.qs & 0x0F
        hi = (rql.qs & 0xF0).view(torch.int8)
    else:
        lo, hi = rql.qs & 0x0F, rql.qs >> 4
    lo = lo.float().reshape(d_in // QK_K, _HALF, d_out)
    hi = hi.float().reshape(d_in // QK_K, _HALF, d_out)
    return torch.cat([lo, hi], dim=1).reshape(d_in, d_out)


def dequantize_runtime_v4(rql: RuntimeQuantLinearV4) -> torch.Tensor:
    """Reference dequantization: (d_out, d_in) f32 (scale * code is exact in
    f32; one rounding in the offset subtraction)."""
    d_in, d_out = rql.d_in_local, rql.d_out
    ng = rql.scale.shape[0]
    w_t = _codes_v4(rql).reshape(ng, rql.group_size, d_out) * rql.scale.float()[:, None, :]
    if rql.offc is not None:
        w_t = w_t - rql.offc[:, None, :]
    return w_t.reshape(d_in, d_out).T


def _group_sums(x: torch.Tensor, gs: int) -> torch.Tensor:
    """(M, d_in) -> (M, n_groups) f32 group sums of the un-rounded x."""
    M, d_in = x.shape
    return x.float().reshape(M, d_in // gs, gs).sum(dim=-1)


def dequant_matmul_v4_reference(x: torch.Tensor, rql: RuntimeQuantLinearV4) -> torch.Tensor:
    """Plain PyTorch version of the v4 kernel, on any device:

        y (M, d_out) f32 = sum_k bf16(x_k) * bf16(bf16(q_k) * bf16(s_g)) - xsum @ offc

    the JAX kernels' arithmetic (the scale rounded to bf16 even when
    stored in f32, the product of two bf16 values rounded to bf16, f32
    sums); only the order of the f32 sums can differ."""
    d_in, d_out = rql.d_in_local, rql.d_out
    ng = rql.scale.shape[0]
    s = rql.scale.to(torch.bfloat16).float()
    w = (_codes_v4(rql).reshape(ng, rql.group_size, d_out) * s[:, None, :]).to(torch.bfloat16)
    y = x.float().to(torch.bfloat16).float() @ w.float().reshape(d_in, d_out)
    if rql.offc is not None:
        y = y - _group_sums(x, rql.group_size) @ rql.offc
    return y


_V4_ARGS = ((ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int)
            + (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 10 + (ctypes.c_void_p,))


def dequant_matmul_v4(x: torch.Tensor, rql: RuntimeQuantLinearV4) -> torch.Tensor:
    """y (M, d_out) f32 = x @ dequant(W)^T through the v4 kernel
    (``csrc/qmatmul_v4.cu``; the offset correction runs inside it, one
    launch); a CPU ``x`` runs the plain version. From ``MMA_MIN_ROWS``
    rows a vec-4 weight (f32 or bf16 x) runs the tensor-core tiles, also
    counted in ``mma_launches``; fewer rows, and vec-1 weights at any M,
    the CUDA-core tiles. The planes are validated on the first call with
    each weight; later calls check only x."""
    if x.device.type == "cpu":
        return dequant_matmul_v4_reference(x, rql)
    x, vec, mt, per, splits, out, part = launch_setup(x, rql, mma=True)
    M, d_in = x.shape
    rc = c_function("qmatmul_v4", "gg_v4_matmul", _V4_ARGS)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), _ptr(rql.qs), _ptr(rql.scale),
        int(rql.scale.dtype == torch.bfloat16), _ptr(rql.offc), _ptr(part), out.data_ptr(),
        M, d_in, rql.d_out, rql.per_byte, rql.group_size, int(rql.layout == "i8"),
        mt, vec, per, splits, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qmatmul_v4 launch failed: CUDA error {rc}")
    body = body_of(rql)
    dequant_matmul_v4.launches += 1
    dequant_matmul_v4.body_launches[body] += 1
    if vec == 4 and mt > 8:  # 32, 64 or 128 rows: the tensor-core tiles
        dequant_matmul_v4.mma_launches += 1
        dequant_matmul_v4.body_mma_launches[body] += 1
    return out


def body_of(rql: RuntimeQuantLinearV4) -> str:
    """The JAX kernel body a v4 weight runs: "pb2" (4-bit, i32 layout),
    "pb2_i8" (4-bit, i8 layout) or "pb1" (5/6-bit, either layout)."""
    if rql.per_byte == 1:
        return "pb1"
    return "pb2_i8" if rql.layout == "i8" else "pb2"


# launches of the kernel, in all and per JAX body it stands for; and of its
# tensor-core tiles, in all and per body
dequant_matmul_v4.launches = 0
dequant_matmul_v4.body_launches = {"pb2": 0, "pb2_i8": 0, "pb1": 0}
dequant_matmul_v4.mma_launches = 0
dequant_matmul_v4.body_mma_launches = {"pb2": 0, "pb2_i8": 0, "pb1": 0}


def fuse_rql_v4(parts: Sequence) -> Optional[RuntimeQuantLinearV4]:
    """Concatenate v4 packed weights along the output dim (same d_in): one
    kernel launch for q/k/v or gate/up. Exact (every plane is
    per-output-column). None if the parts don't share a layout."""
    if not all(isinstance(p, RuntimeQuantLinearV4) for p in parts):
        return None
    p0 = parts[0]
    if not all(
        (p.group_size, p.per_byte, p.d_in, p.has_off, p.scale.dtype, p.layout)
        == (p0.group_size, p0.per_byte, p0.d_in, p0.has_off, p0.scale.dtype, p0.layout)
        for p in parts
    ):
        return None

    def cat(attr):
        return torch.cat([getattr(p, attr) for p in parts], dim=1)

    return RuntimeQuantLinearV4(cat("qs"), cat("scale"), cat("offc") if p0.has_off else None,
                                p0.d_in, p0.group_size, p0.per_byte, p0.layout)
