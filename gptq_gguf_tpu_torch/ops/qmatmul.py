"""Fused K-quant dequant + matmul for serving: the v1 and v2 runtime formats
and the dispatch over all three (v4 lives in ``ops/qmv4.py``).

Port of ``gptq_gguf_tpu/ops/qmatmul.py``. Weights stay in device memory in
a packed integer layout and are dequantized inside a hand-written kernel
right before the multiply-add, so decode reads 4.75-6 bits per Q4_K weight
instead of 16. Every layout is byte-identical to the JAX package's
(everything input-dim-major):

* ``qs`` (all formats): (d_in / per_byte, d_out) uint8. For <= 4-bit types
  byte k of a 256-row supergroup holds row k in the low nibble and row
  k + 128 in the high nibble; Q5_K / Q6_K use one byte per code. Codes are
  unsigned: the signed types carry ``shift`` (4 for Q3_K, 32 for Q6_K).
* v1 (``RuntimeQuantLinear``): ``scale_t`` / ``offset_t`` (n_groups, d_out)
  f32, w = scale_t * q - offset_t with the signed shift folded into
  ``offset_t``. Kernel: ``csrc/qmatmul_v1.cu``, f32 end to end; with a
  bf16 x the tensor-core tiles of ``csrc/qmatmul_v1_mma.cuh`` (the prefill
  tiles from ``MMA_MIN_ROWS`` rows, the decode tile from
  ``DECODE_MMA_MIN_ROWS["v1"]`` to 8 rows), the same function as a group
  dot of raw codes (exact bf16 products, f32 sums).
* v2 (``RuntimeQuantLinearV2``): ``d_sg`` / ``dmin_sg`` (d_rep * n_sg, d_out)
  f32 super-scale / super-min, each supergroup row replicated ``d_rep`` = 2
  times (a TPU tiling rule the layout keeps so packed weights compare equal
  across the two packages); ``sc_q`` / ``mn_q`` (n_groups, d_out) quantized
  group scales (int8 for the signed types, else uint8) and mins (None for
  the signed types).

A v2 weight runs one of the JAX package's kernel variants, picked by
``PALLAS_V2_VARIANT`` / ``PALLAS_V2_VARIANT_GS16`` (env
``GG_PALLAS_V2_VARIANT`` / ``GG_PALLAS_V2_VARIANT_GS16``, the JAX names)
through ``_effective_v2_variant``. All nine have a kernel: the per-weight
builds ``v2g`` (the default) and ``v2s`` (``csrc/qmatmul_v2g.cu``), ``v2``
and ``v2f`` (``csrc/qmatmul_v2.cu``), ``v3`` and ``v2h``
(``csrc/qmatmul_v3.cu``), all instances of ``csrc/qmatmul_v2_weight.cuh``
(CUDA cores) and of ``csrc/qmatmul_v2_mma.cuh`` (v2's policy for the
tensor-core mainloop of ``csrc/qmatmul_mma.cuh``: bf16 operands at
``MMA_MIN_ROWS`` rows or more, prefill and perplexity; and, for every
per-weight variant, of the tensor-core decode mainloop of
``csrc/qmatmul_decode_mma.cuh``: bf16 operands from the variant's
``DECODE_MMA_MIN_ROWS`` to 8 rows, every B=8 decode step);
and the group-dot family ``v2m`` / ``v2t`` / ``v2p``
(``csrc/qmatmul_v2m.cu``, and ``csrc/qmatmul_v2m_mma.cuh``, their policies
for the same mainloop: the raw codes as the B operand, each group's
partial product scaled in f32; all three also for the decode mainloop,
bf16 operands from their ``DECODE_MMA_MIN_ROWS`` to 8 rows). The
variants differ only in where the scale
and offset arithmetic happens, not in the format, so the packers and
loaders are the same for all of them.

``dequant_matmul`` routes by the weight's class. A CUDA tensor launches that
format's kernel (or raises); a CPU tensor runs the kernel's plain PyTorch
version. The kernels take every shape with d_in % 256 == 0 and any d_out or
M, so there is no other path. ``pack_runtime_auto`` packs in the format
``RUNTIME_FORMAT`` names, as the JAX package does. ``q8_matmul`` is the
JAX package's Q8 integer-dot reference (plain PyTorch; no kernel there).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..formats.ggml import KQUANT_SPECS, QK_K, GGMLQuantizationType
from .kquant import SuperGroupParams

_HALF = QK_K // 2  # 128


def _pack_codes(qweight, qtype: GGMLQuantizationType):
    """(unsigned codes (d_in, d_out) u8, shift): layer codes (d_out, d_in)
    plus the type's shift, transposed input-dim-major."""
    spec = KQUANT_SPECS[qtype]
    shift = -spec.qmin  # 0 for unsigned types, 4 / 32 for Q3_K / Q6_K
    codes = np.asarray(qweight).astype(np.int16) + shift
    if codes.min() < 0:
        raise ValueError(f"codes below {spec.qmin} for {qtype.name}")
    return np.ascontiguousarray(codes.T).astype(np.uint8), shift


def _nibble_pack(codes_t: np.ndarray) -> np.ndarray:
    """(d_in, d_out) codes < 16 -> (d_in / 2, d_out) bytes: byte k of a
    supergroup holds row k (low nibble) and row k + 128 (high nibble)."""
    d_in, d_out = codes_t.shape
    c = codes_t.reshape(d_in // QK_K, QK_K, d_out)
    return (c[:, :_HALF, :] | (c[:, _HALF:, :] << 4)).reshape(d_in // 2, d_out)


def _to_device(planes, dev):
    return [None if p is None else torch.from_numpy(np.ascontiguousarray(p)).to(dev)
            for p in planes]


# ---------------------------------------------------------------------------
# v1: per-group f32 scale and offset
# ---------------------------------------------------------------------------


class RuntimeQuantLinear:
    """Packed quantized weight, v1 layout (input-dim-major)."""

    def __init__(self, qs, scale_t, offset_t, d_in: int, group_size: int, per_byte: int):
        self.qs = qs              # (d_in // per_byte, d_out) uint8
        self.scale_t = scale_t    # (n_groups, d_out) f32
        self.offset_t = offset_t  # (n_groups, d_out) f32, the signed shift folded in
        self.d_in = int(d_in)
        self.group_size = int(group_size)
        self.per_byte = int(per_byte)
        self._checked_on = None  # device the kernel wrapper validated the planes for
        self._vec = 1  # columns per kernel thread, chosen with that validation

    @property
    def d_out(self) -> int:
        return self.qs.shape[1]

    @property
    def d_in_local(self) -> int:
        return self.qs.shape[0] * self.per_byte

    @property
    def packed_bits_per_weight(self) -> float:
        return (self.qs.shape[0] + 8 * self.scale_t.shape[0]) * 8 / self.d_in

    @property
    def bytes_read(self) -> int:
        """Plane bytes one matmul must read: every plane once."""
        return sum(t.numel() * t.element_size() for t in self.planes())

    def planes(self):
        return [self.qs, self.scale_t, self.offset_t]

    def plane_specs(self):
        """name -> (dtype, rows) of every plane the kernel reads."""
        ng = self.d_in_local // self.group_size
        return {"qs": (torch.uint8, self.qs.shape[0]), "scale_t": (torch.float32, ng),
                "offset_t": (torch.float32, ng)}


def pack_runtime(qweight, params: SuperGroupParams, qtype: GGMLQuantizationType,
                 device="cuda") -> RuntimeQuantLinear:
    """Build the v1 runtime format from layer codes (d_out, d_in) and their
    SuperGroupParams, in numpy exactly as the JAX package computes it, then
    move it to ``device``."""
    dev = resolve_device(device)
    spec = KQUANT_SPECS[qtype]
    d_in = np.shape(qweight)[1]
    ss = np.asarray(params.super_scale, np.float16).astype(np.float32)
    sz = np.asarray(params.super_zero, np.float16).astype(np.float32)
    sq = np.asarray(params.scale_q).astype(np.float32)
    zq = np.asarray(params.zero_q).astype(np.float32)
    gpsg = spec.num_groups
    codes_t, shift = _pack_codes(qweight, qtype)
    scale = np.repeat(ss, gpsg, axis=1) * sq  # (d_out, ng), exact in f32
    off = np.repeat(sz, gpsg, axis=1) * zq + scale * shift
    per_byte = 2 if spec.bits <= 4 else 1
    qs = _nibble_pack(codes_t) if per_byte == 2 else codes_t
    qs_t, scale_t, offset_t = _to_device([qs, scale.T, off.T], dev)
    return RuntimeQuantLinear(qs_t, scale_t, offset_t, d_in, spec.group_size, per_byte)


def dequantize_runtime(rql: RuntimeQuantLinear) -> torch.Tensor:
    """Reference dequantization: (d_out, d_in) f32 (scale * q is exact in
    f32, so one rounding in the subtraction, as in the JAX package)."""
    d_in = rql.d_in_local
    q = _unpack_codes(rql.qs, rql.per_byte, d_in).float()
    ng = rql.scale_t.shape[0]
    w_t = q.reshape(ng, rql.group_size, rql.d_out) * rql.scale_t[:, None, :] \
        - rql.offset_t[:, None, :]
    return w_t.reshape(d_in, rql.d_out).T


def dequant_matmul_v1_reference(x: torch.Tensor, rql: RuntimeQuantLinear) -> torch.Tensor:
    """Plain PyTorch version of the v1 kernel, on any device: y (M, d_out)
    f32 = f32(x) @ (scale_t * q - offset_t), f32 products and sums (the
    JAX kernel's f32 dot; on the card TF32 must be off)."""
    return x.float() @ dequantize_runtime(rql).T


class RuntimeQuantLinearV2:
    """Packed quantized weight, compact-scale layout (input-dim-major)."""

    def __init__(self, qs, d_sg, dmin_sg, sc_q, mn_q, d_in: int, group_size: int,
                 per_byte: int, shift: int, d_rep: int = 1):
        self.qs = qs            # (d_in // per_byte, d_out) uint8
        self.d_sg = d_sg        # (d_rep * n_sg, d_out) f32 super-scale
        self.dmin_sg = dmin_sg  # (d_rep * n_sg, d_out) f32 super-min (None if signed)
        self.sc_q = sc_q        # (n_groups, d_out) uint8 / int8 quantized scales
        self.mn_q = mn_q        # (n_groups, d_out) uint8 mins (None if signed)
        self.d_in = int(d_in)
        self.group_size = int(group_size)
        self.per_byte = int(per_byte)
        self.shift = int(shift)
        self.d_rep = int(d_rep)
        self._checked_on = None  # device the kernel wrapper validated the planes for
        self._vec = 1  # columns per kernel thread, chosen with that validation

    @property
    def d_out(self) -> int:
        return self.qs.shape[1]

    @property
    def d_in_local(self) -> int:
        return self.qs.shape[0] * self.per_byte

    @property
    def has_min(self) -> bool:
        return self.dmin_sg is not None

    @property
    def bytes_read(self) -> int:
        """Plane bytes one matmul must read: every plane once, but only one
        of the ``d_rep`` copies of each super-scale row (the copies exist
        for the TPU's tiling; the kernel reads row ``d_rep * sg``)."""
        return sum(t.numel() * t.element_size() // (self.d_rep if t is self.d_sg
                                                     or t is self.dmin_sg else 1)
                   for t in self.planes())

    def planes(self):
        """The tensors of this weight, None-free."""
        return [t for t in (self.qs, self.d_sg, self.dmin_sg, self.sc_q, self.mn_q)
                if t is not None]

    def plane_specs(self):
        """name -> (dtype, rows) of every plane the kernel reads."""
        n_sg, ng = self.d_in_local // QK_K, self.d_in_local // self.group_size
        specs = {"qs": (torch.uint8, self.qs.shape[0]),
                 "d_sg": (torch.float32, self.d_rep * n_sg),
                 "sc_q": (torch.uint8 if self.has_min else torch.int8, ng)}
        if self.has_min:
            specs.update(dmin_sg=(torch.float32, self.d_rep * n_sg), mn_q=(torch.uint8, ng))
        return specs


def pack_runtime_v2(qweight, params: SuperGroupParams, qtype: GGMLQuantizationType,
                    device="cuda") -> RuntimeQuantLinearV2:
    """Build the compact-scale runtime format from layer codes (d_out, d_in)
    and their SuperGroupParams; the planes are computed in numpy exactly as
    the JAX package computes them, then moved to ``device``."""
    dev = resolve_device(device)
    spec = KQUANT_SPECS[qtype]
    d_in = np.shape(qweight)[1]
    ss = np.asarray(params.super_scale, np.float16).astype(np.float32)  # (d_out, n_sg)
    sq = np.asarray(params.scale_q)
    codes_t, shift = _pack_codes(qweight, qtype)
    per_byte = 2 if spec.bits <= 4 else 1
    qs = _nibble_pack(codes_t) if per_byte == 2 else codes_t

    d_rep = 2
    sc_dtype = np.int8 if spec.signed else np.uint8
    planes = [qs, np.repeat(np.ascontiguousarray(ss.T), d_rep, axis=0), None,
              sq.astype(sc_dtype).T, None]
    if not spec.signed:
        sz = np.asarray(params.super_zero, np.float16).astype(np.float32)
        zq = np.asarray(params.zero_q)
        planes[2] = np.repeat(np.ascontiguousarray(sz.T), d_rep, axis=0)
        planes[4] = zq.astype(np.uint8).T
    qs_t, d_sg, dmin_sg, sc_q, mn_q = _to_device(planes, dev)
    return RuntimeQuantLinearV2(qs_t, d_sg, dmin_sg, sc_q, mn_q, d_in,
                                spec.group_size, per_byte, shift, d_rep)


def _unpack_codes(qs: torch.Tensor, per_byte: int, d_in: int) -> torch.Tensor:
    """(d_in/per_byte, d_out) u8 -> (d_in, d_out) u8 codes."""
    if per_byte == 1:
        return qs
    d_out = qs.shape[1]
    b = qs.reshape(d_in // QK_K, _HALF, d_out)
    return torch.cat([b & 0x0F, b >> 4], dim=1).reshape(d_in, d_out)


def _group_scales_v2(rql: RuntimeQuantLinearV2):
    """(scale, off) per (n_groups, d_out) in the canonical f32 op order."""
    gpsg = QK_K // rql.group_size
    d = rql.d_sg[:: rql.d_rep].repeat_interleave(gpsg, dim=0)
    scale = d * rql.sc_q.float()  # exact: 17-bit product
    if rql.has_min:
        off = rql.dmin_sg[:: rql.d_rep].repeat_interleave(gpsg, dim=0) * rql.mn_q.float()
    else:
        off = torch.zeros_like(scale)
    return scale, off


def _folded_planes_v2(rql: RuntimeQuantLinearV2):
    """(scale, offc) per (n_groups, d_out): the group scale and the offset
    with the signed shift folded in, scale * shift + dmin * mn (offc None
    for a type with neither), in the JAX package's f32 op order."""
    scale, off = _group_scales_v2(rql)
    offc = scale * float(rql.shift) if rql.shift else None
    if rql.has_min:
        offc = off if offc is None else offc + off
    return scale, offc


def _wt_v2_fields(qs, d_sg, dmin_sg, sc_q, mn_q, *, gs, per_byte, shift,
                  d_rep) -> torch.Tensor:
    """(d_in, d_out) f32 W^T from v2 fields, bit-exact canonical op order."""
    d_in = qs.shape[0] * per_byte
    d_out = qs.shape[1]
    q = _unpack_codes(qs, per_byte, d_in).int() - shift
    gpsg = QK_K // gs
    scale = d_sg[::d_rep].repeat_interleave(gpsg, dim=0) * sc_q.float()
    if dmin_sg is not None:
        off = dmin_sg[::d_rep].repeat_interleave(gpsg, dim=0) * mn_q.float()
    else:
        off = torch.zeros_like(scale)
    ng = scale.shape[0]
    qf = q.reshape(ng, gs, d_out).float()
    w_t = scale[:, None, :] * qf - off[:, None, :]
    return w_t.reshape(d_in, d_out)


def dequantize_runtime_v2(rql: RuntimeQuantLinearV2) -> torch.Tensor:
    """Bit-exact reference dequantization: (d_out, d_in) f32."""
    return _wt_v2_fields(
        rql.qs, rql.d_sg, rql.dmin_sg, rql.sc_q, rql.mn_q,
        gs=rql.group_size, per_byte=rql.per_byte, shift=rql.shift,
        d_rep=rql.d_rep,
    ).T


def _mxu_round(t: torch.Tensor, mxu_dtype) -> torch.Tensor:
    """t (f32) as the kernels' operand type sees it: rounded to bf16 (to
    nearest even, as JAX's astype) or kept in f32."""
    if mxu_dtype == torch.bfloat16:
        return t.to(torch.bfloat16).float()
    if mxu_dtype == torch.float32:
        return t
    raise ValueError(f"mxu_dtype must be torch.bfloat16 or torch.float32, got {mxu_dtype}")


def _v2_operand(rql: RuntimeQuantLinearV2, variant: str, mxu_dtype):
    """(W^T (d_in, d_out) f32 as ``variant``'s kernel feeds it to the
    products, each value representable in ``mxu_dtype``; whether the
    variant subtracts xsum @ off2), with T the rounding to ``mxu_dtype``:

        v2g, v2s  T(scale * q)                       xsum term
        v3        T(T(q) * T(scale))                 xsum term
        v2        T(scale * (q - shift) - off)       (dequantize_runtime_v2)
        v2f       T(scale * q - off2)                (the same f32 value)
        v2h       T(T(T(scale) * T(q)) - T(off2))    each step rounded

    q is the raw unsigned code. Every product is exact in f32, so these are
    the JAX bodies' weights bit for bit."""
    def t(v):
        return _mxu_round(v, mxu_dtype)

    if variant == "v2":
        return t(dequantize_runtime_v2(rql).T), False
    scale, off2 = _folded_planes_v2(rql)  # (ng, d_out)
    ng, gs, d_out = scale.shape[0], rql.group_size, rql.d_out
    q = _unpack_codes(rql.qs, rql.per_byte, rql.d_in_local).float().reshape(ng, gs, d_out)
    s, o2 = scale[:, None, :], off2[:, None, :]
    if variant in ("v2g", "v2s"):
        w, corrects = t(s * q), True
    elif variant == "v3":
        w, corrects = t(q * t(s)), True
    elif variant == "v2f":
        w, corrects = t(s * q - o2), False
    elif variant == "v2h":
        w, corrects = t(t(t(s) * q) - t(o2)), False
    else:
        raise ValueError(f"not a per-weight v2 variant: {variant!r}")
    return w.reshape(ng * gs, d_out), corrects


def dequant_matmul_v2w_reference(x: torch.Tensor, rql: RuntimeQuantLinearV2,
                                 mxu_dtype=torch.bfloat16, variant: str = "v2g") -> torch.Tensor:
    """Plain PyTorch version of the per-weight kernel variants, on any
    device:

        y (M, d_out) f32 = T(x) @ w  [ - xsum @ off2 ]

    with w and the xsum term as ``_v2_operand`` gives them for ``variant``
    and xsum the f32 group sums of the un-rounded x (the JAX bodies'
    arithmetic; only the sum order of the f32 accumulation can differ: v2s
    is v2g's function with the nibble halves summed apart). In f32, v2's is
    the counterpart of JAX's ``dequant_matmul_xla_v2``."""
    x32 = x.float()
    w, corrects = _v2_operand(rql, variant, mxu_dtype)
    y = _mxu_round(x32, mxu_dtype) @ w
    if corrects:
        M, d_in = x32.shape
        _, off2 = _folded_planes_v2(rql)
        y = y - x32.reshape(M, d_in // rql.group_size, rql.group_size).sum(dim=-1) @ off2
    return y


def dequant_matmul_v2g_reference(x: torch.Tensor, rql: RuntimeQuantLinearV2,
                                 mxu_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the v2g kernel: T(x) @ T(scale * q) - xsum @ off2."""
    return dequant_matmul_v2w_reference(x, rql, mxu_dtype, "v2g")


def dequant_matmul_v2_reference(x: torch.Tensor, rql: RuntimeQuantLinearV2,
                                mxu_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the v2 kernel: T(x) @ T(w), w the bit-exact f32
    weight of ``dequantize_runtime_v2``; no xsum term."""
    return dequant_matmul_v2w_reference(x, rql, mxu_dtype, "v2")


def dequant_matmul_v2m_reference(x: torch.Tensor, rql: RuntimeQuantLinearV2,
                                 mxu_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the group-dot kernels v2m, v2t and v2p (one
    function, three schedules):

        y (M, d_out) f32 = sum_g scale_g * (T(x_g) @ q_g)  -  xsum @ off2

    q_g the raw unsigned codes of group g (< 64, exact in bf16), each
    group's dot summed in f32 and then multiplied by its scale; xsum the
    f32 group sums of the un-rounded x. The per-group partial sums are
    taken a few groups at a time (at most 256 MiB of them)."""
    x32 = x.float()
    M, d_in = x32.shape
    gs, d_out = rql.group_size, rql.d_out
    ng = d_in // gs
    xsum = x32.reshape(M, ng, gs).sum(dim=-1)
    scale, off2 = _folded_planes_v2(rql)  # (ng, d_out)
    xg = _mxu_round(x32, mxu_dtype).reshape(M, ng, gs).transpose(0, 1)  # (ng, M, gs)
    q = _unpack_codes(rql.qs, rql.per_byte, d_in).reshape(ng, gs, d_out)
    y = torch.zeros((M, d_out), dtype=torch.float32, device=x.device)
    step = max(1, (1 << 26) // (M * d_out))
    for g0 in range(0, ng, step):
        g1 = min(ng, g0 + step)
        parts = torch.bmm(xg[g0:g1], q[g0:g1].float())  # (groups, M, d_out)
        y += (parts * scale[g0:g1, None, :]).sum(dim=0)
    if off2 is not None:
        y = y - xsum @ off2
    return y


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def c_function(lib: str, symbol: str, argtypes: tuple):
    """The bound C entry point ``symbol`` of ``csrc/<lib>.cu`` (the library
    is built and loaded on first use); every entry point returns a CUDA
    error code."""
    from .cuda_build import load

    fn = getattr(load(lib), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_planes(x: torch.Tensor, rql) -> None:
    """Raise ValueError unless x and every plane ``rql.plane_specs()`` names
    are what the format's kernel takes."""
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be 2-D f32 or bf16, got {tuple(x.shape)} {x.dtype}")
    if x.shape[1] != rql.d_in_local or x.shape[1] % QK_K or x.shape[0] < 1:
        raise ValueError(f"x {tuple(x.shape)} does not match d_in {rql.d_in_local}")
    for name, (dtype, rows) in rql.plane_specs().items():
        t = getattr(rql, name)
        if t is None:
            raise ValueError(f"plane {name} is missing")
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous() \
                or t.dim() != 2 or t.shape[1] != rql.d_out:
            raise ValueError(
                f"plane {name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                f"contiguous={t.is_contiguous()}; want {dtype} on {x.device}")
        if t.shape[0] != rows:
            raise ValueError(f"plane {name} has {t.shape[0]} rows; d_in needs {rows}")


def _launch_plan(M: int, d_out: int, n_sg: int, n_sm: int, vec: int = 4, mt_max: int = 32):
    """(rows per block, supergroups per split, splits). Blocks cover 128
    columns at MT <= 8 (four warps split each supergroup) and 512 beyond,
    a quarter of that with vec 1; the K axis is split over supergroups only
    as far as needed to put ~4 blocks on every SM. ``mt_max`` 8 keeps a
    kernel on its decode tiles at any M (the group-dot kernels hold a
    group's partial sums beside the accumulator)."""
    mt = 1
    while mt < min(M, mt_max):
        mt *= 2
    if vec == 1:
        mt = 1 if mt == 1 else 8 if mt <= 8 else 32
    cols = (128 if mt <= 8 else 512) * vec // 4
    base = -(-M // mt) * -(-d_out // cols)
    target = 4 * n_sm
    splits = 1 if base >= target else min(n_sg, -(-target // base))
    per = -(-n_sg // splits)
    return mt, per, -(-n_sg // per)


# rows from which a bf16-operand call of any v2 variant, and every v4 call
# (qmv4.dequant_matmul_v4), runs the tensor-core tiles of
# csrc/qmatmul_mma.cuh instead of the decode tiles on a vec-4 weight
# (timed at M = 9, 16, 32 and 64 for v2g, v4, v2m, v2p, v2t and v2s,
# tools/time_v2_kernels.py: PERF.md)
MMA_MIN_ROWS = 9


def _mma_plan(M: int, d_out: int, n_sg: int, n_sm: int, bm_max: int = 128):
    """(rows per block, supergroups per split, splits) of the tensor-core
    tiles: 32, 64 or 128 rows (at most ``bm_max``) by 128 columns, the K
    axis split over supergroups only as far as needed to give every SM a
    block."""
    bm = min(bm_max, 32 if M <= 32 else 64 if M <= 64 else 128)
    base = -(-M // bm) * -(-d_out // 128)
    splits = 1 if base >= n_sm else min(n_sg, -(-n_sm // base))
    per = -(-n_sg // splits)
    return bm, per, -(-n_sg // per)


# the tile code of the tensor-core decode tile of every v2 variant, of v1
# and of v4 (csrc/qmatmul_decode_mma.cuh: all of x's 1-8 rows as the n8 of
# mma.sync), which neither a v2 or v4 CUDA-core tile (1, 2, 4, 8 rows) nor
# a prefill tile (32, 64, 128) uses (v1_kernel's 16-row tile is tile code
# 0 of its entry point, the decode tile tile code 1)
DECODE_MMA_TILE = 16
# Every kernel with a tensor-core decode tile, each with the fewest rows of
# a call on a vec-4 weight it takes there (up to MMA_MIN_ROWS - 1; fewer
# rows run the CUDA-core tiles), read at every call: the v2 variants (with
# bf16 operands), "v1", the v1 format's kernel (a bf16 x; an f32 x stays
# on v1_kernel), and "v4", the v4 format's kernel (ops/qmv4.py; f32 or
# bf16 x). Each was timed against the CUDA-core tile at M = 1, 2 and 3
# (tools/time_v2_kernels.py --variant V, or --format v1 | v4, --m 1,2,3
# --core --decode-min-rows 1, H100: PERF.md):
#   v2g: the 129 calls of one Llama-3-8B step at M = 1 on the CUDA-core
#     tile 5.37-5.39 ms against the decode tile's 5.76-5.81, at M = 2
#     6.02-6.03 against 5.78, at M = 3 (the 4-row tile) 7.03-7.06 against
#     5.79-5.83;
#   v2p: the padded Q6_K head (the group-dot form of the decode mainloop)
#     at M = 1 0.3003-0.3013 against 0.3083-0.3089, at M = 2 0.3045-0.3073
#     against 0.3107-0.3129, at M = 3 0.6116-0.6147 against 0.3105-0.3130;
#   v2h: the 129 calls of a step (its weights in packed bf16 arithmetic) on
#     the decode tile at M = 1 5.61-5.62 against the CUDA-core tile's
#     6.33-6.36, at M = 2 5.62-5.65 against 6.86-6.92;
#   v2t: its 128 projections (the group-sum form) on the decode tile at
#     M = 1 5.38 against the CUDA-core tile's 7.35, at M = 2 5.43 against
#     5.31, at M = 3 5.43 against 6.39: one threshold of 1 loses 2% at two
#     rows;
#   v2m: its 128 projections (the group-dot form at gs 32) on the decode
#     tile at M = 1 5.43-5.45 against the CUDA-core tile's 7.30-7.32, at
#     M = 2 5.41-5.44 against 8.46-8.48, at M = 3 5.41-5.42 against 5.86;
#   v2s: its 128 projections (split halves) at M = 1 5.60-5.61 against the
#     CUDA-core tile's 5.23-5.24, at M = 2 5.57-5.62 against 5.64-5.70, at
#     M = 3 5.57-5.62 against 6.76-6.80;
#   v3: the 129 calls of a step (packed bf16 weights, the xsum term) at
#     M = 1 on the CUDA-core tile 5.41 against the decode tile's 5.82, at
#     M = 2 6.09-6.15 against 5.81-5.86, at M = 3 7.10 against 5.82;
#   v2: the 129 calls of a step (its FMA forms) at M = 1 on the CUDA-core
#     tile 5.49-5.55 against the decode tile's 5.52-5.61, at M = 2
#     6.09-6.17 against 5.54-5.63, at M = 3 7.18 against 5.57;
#   v2f: the 129 calls of a step (v2's FMA forms) at M = 1 on the
#     CUDA-core tile 5.51 against the decode tile's 5.57, at M = 2 6.09
#     against 5.54, at M = 3 7.15 against 5.56;
#   v4: the 129 calls of a step with f32 scales at M = 1 on the CUDA-core
#     tile 9.34-9.36 against the decode tile's 5.76-5.77, at M = 2
#     6.57-6.59 against 5.73-5.77, at M = 3 (its 4-row tile) 10.51 against
#     5.77-5.79;
#   v1: the 129 calls of a step with a bf16 x (the group-dot form) on the
#     decode tile at M = 1 5.27-5.34 against v1_kernel's 5.27-5.33 (a
#     tie), at M = 2 5.32 against 8.76, at M = 3 5.31 against 8.68.
DECODE_MMA_MIN_ROWS = {"v2g": 2, "v2p": 3, "v2h": 1, "v2t": 1, "v2m": 1, "v2s": 2, "v3": 2,
                       "v2": 2, "v2f": 2, "v4": 1, "v1": 1}
# the v2 variants among them
DECODE_MMA_VARIANTS = tuple(v for v in DECODE_MMA_MIN_ROWS if v not in ("v4", "v1"))
# blocks per SM the decode tile's split-K plan fills: two waves of the four
# resident blocks (csrc/qmatmul_decode_mma.cuh; timed against 4 and 12 with
# tools/time_v2_kernels.py --decode-blocks: PERF.md)
DECODE_MMA_BLOCKS_PER_SM = 8


def _decode_mma_plan(d_out: int, n_sg: int, n_sm: int):
    """(DECODE_MMA_TILE, supergroups per split, splits) of the tensor-core
    decode tile: 128 columns a block, the K axis split over supergroups
    into as many splits as keep the grid at DECODE_MMA_BLOCKS_PER_SM
    blocks per SM or fewer."""
    base = -(-d_out // 128)
    splits = max(1, min(n_sg, DECODE_MMA_BLOCKS_PER_SM * n_sm // base))
    per = -(-n_sg // splits)
    return DECODE_MMA_TILE, per, -(-n_sg // per)


def _plan(M: int, d_out: int, n_sg: int, n_sm: int, vec: int, mt_max: int = 32,
          mma: bool = False, bm_max: int = 128, decode_mma: bool = False,
          decode_min_rows: Optional[int] = None):
    """The launch plan (rows per block or tile code, supergroups per
    split, splits): the tensor-core tiles of up to ``bm_max`` rows when
    ``mma`` allows them and the weight takes them (vec 4, M >=
    MMA_MIN_ROWS); the tensor-core decode tile when ``decode_mma`` allows
    it (vec 4, from ``decode_min_rows``, by default v2g's
    DECODE_MMA_MIN_ROWS, to MMA_MIN_ROWS - 1 rows); else the CUDA-core
    tiles of up to
    ``mt_max`` rows."""
    if mma and vec == 4 and M >= MMA_MIN_ROWS:
        return _mma_plan(M, d_out, n_sg, n_sm, bm_max)
    lo = DECODE_MMA_MIN_ROWS["v2g"] if decode_min_rows is None else decode_min_rows
    if decode_mma and vec == 4 and lo <= M < MMA_MIN_ROWS:
        return _decode_mma_plan(d_out, n_sg, n_sm)
    return _launch_plan(M, d_out, n_sg, n_sm, vec, mt_max)


def launch_setup(x: torch.Tensor, rql, mt_max: int = 32, mma: bool = False,
                 bm_max: int = 128, decode_mma: bool = False,
                 decode_min_rows: Optional[int] = None):
    """The shared front of the dequant-matmul kernel wrappers for a CUDA x:
    x as a contiguous f32 or bf16 tensor, the planes validated (and their
    alignment read) on the first call with each weight, the launch plan
    (``_plan``: rows per block up to ``mt_max``, or the tensor-core tiles
    of up to ``bm_max`` where ``mma`` allows them, or the tensor-core
    decode tile from ``decode_min_rows`` rows where ``decode_mma`` does),
    the output and the split-K scratch.
    Returns (x, vec, mt, per, splits, out, part); vec 4 needs
    d_out % 4 == 0 and 16-byte-aligned planes, the tensor-core tiles
    (mt > 8) a 16-byte-aligned x too (copied when it is not)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    x = x.contiguous()
    if rql._checked_on != x.device:
        _check_planes(x, rql)
        rql._vec = 4 if rql.d_out % 4 == 0 and all(
            t.data_ptr() % 16 == 0 for t in rql.planes()) else 1
        rql._checked_on = x.device
    elif x.dim() != 2 or x.shape[1] != rql.d_in_local:
        raise ValueError(f"x {tuple(x.shape)} does not match d_in {rql.d_in_local}")
    M, d_in = x.shape
    mt, per, splits = _plan(M, rql.d_out, d_in // QK_K, _sm_count(x.device.index), rql._vec,
                            mt_max, mma, bm_max, decode_mma, decode_min_rows)
    if mt > 8 and x.data_ptr() % 16:  # the tensor-core tiles: 16-byte copies of x
        x = x.clone()
    out = torch.empty((M, rql.d_out), dtype=torch.float32, device=x.device)
    part = (torch.empty((splits, M, rql.d_out), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    return x, rql._vec, mt, per, splits, out, part


# every v2 entry point: the build (csrc/qmatmul_v2_weight.cuh) or the body
# (csrc/qmatmul_v2m.cu), x, x_bf16, mxu_bf16, the five planes, partials,
# out, 12 ints, the stream
_V2_ARGS = ((ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int)
            + (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 12 + (ctypes.c_void_p,))


def _launch_v2(lib: str, code: int, x: torch.Tensor, rql: RuntimeQuantLinearV2, mxu_dtype,
               mt_max: int, mma: bool = False, bm_max: int = 128, decode_mma: bool = False,
               decode_min_rows: Optional[int] = None):
    """Launch build or body ``code`` of ``csrc/<lib>.cu`` on x's current
    stream (the library is built on first use). Returns (y, rows per
    block or tile code): DECODE_MMA_TILE ran the tensor-core decode tile,
    32 rows or more the tensor-core prefill tiles."""
    if mxu_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mxu_dtype must be torch.bfloat16 or torch.float32, got {mxu_dtype}")
    x, vec, mt, per, splits, out, part = launch_setup(x, rql, mt_max, mma, bm_max, decode_mma,
                                                      decode_min_rows)
    M, d_in = x.shape
    rc = c_function(lib, f"gg_{lib.split('_', 1)[1]}_matmul", _V2_ARGS)(
        code, x.data_ptr(), int(x.dtype == torch.bfloat16), int(mxu_dtype == torch.bfloat16),
        _ptr(rql.qs), _ptr(rql.d_sg), _ptr(rql.dmin_sg), _ptr(rql.sc_q), _ptr(rql.mn_q),
        _ptr(part), out.data_ptr(), M, d_in, rql.d_out, rql.per_byte, rql.group_size,
        int(rql.has_min), rql.shift, rql.d_rep, mt, vec, per, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{lib} launch failed: CUDA error {rc}")
    return out, mt


# the per-weight variants (csrc/qmatmul_v2_weight.cuh), which build every
# weight before the products: variant -> (its source in csrc/, its build
# in that source)
_PER_WEIGHT = {"v2g": ("qmatmul_v2g", 0), "v2": ("qmatmul_v2", 1), "v3": ("qmatmul_v3", 2),
               "v2f": ("qmatmul_v2", 3), "v2h": ("qmatmul_v3", 4), "v2s": ("qmatmul_v2g", 5)}
PER_WEIGHT_VARIANTS = tuple(_PER_WEIGHT)


# the largest row tile of a variant's tensor-core tiles where it is not 128:
# v2t's step sums spill 620-628 bytes at 128 rows and ran one Llama-3-8B
# forward's projections at M = 1024 in 164 ms against 155 at 64
# (tools/time_v2_kernels.py --bm, PERF.md)
MMA_BM_MAX = {"v2t": 64}


def _v2_route(variant: str, mxu_dtype) -> tuple:
    """(mt_max, mma, bm_max, decode_mma, decode_min_rows) of a v2 variant's
    launch plan: CUDA-core tiles of up to 8 rows; from MMA_MIN_ROWS rows
    with bf16 operands the tensor-core tiles of up to bm_max rows (f32
    operands would need TF32, which rounds them); below that, for the
    DECODE_MMA_VARIANTS with bf16 operands, the tensor-core decode tile
    from decode_min_rows rows (the variant's DECODE_MMA_MIN_ROWS, read at
    every call)."""
    bf16 = mxu_dtype == torch.bfloat16
    decode = bf16 and variant in DECODE_MMA_VARIANTS
    return (8, bf16, MMA_BM_MAX.get(variant, 128), decode,
            DECODE_MMA_MIN_ROWS[variant] if decode else None)


def _launch_variant(fn, variant: str, lib: str, code: int, x: torch.Tensor,
                    rql: RuntimeQuantLinearV2, mxu_dtype) -> torch.Tensor:
    """One launch of a v2 variant's kernel (build or body ``code`` of
    ``csrc/<lib>.cu``), counted on its wrapper ``fn`` (``launches``; also
    ``decode_mma_launches`` when it ran the tensor-core decode tile, or
    ``mma_launches`` when it ran the tensor-core prefill tiles)."""
    out, mt = _launch_v2(lib, code, x, rql, mxu_dtype, *_v2_route(variant, mxu_dtype))
    fn.launches += 1
    if mt == DECODE_MMA_TILE:
        fn.decode_mma_launches += 1
    elif mt > 8:  # 32, 64 or 128 rows: the tensor-core prefill tiles
        fn.mma_launches += 1
    return out


def _per_weight(fn, variant: str, x: torch.Tensor, rql: RuntimeQuantLinearV2,
                mxu_dtype) -> torch.Tensor:
    """The shared body of the per-weight wrappers: the plain version for a
    CPU x, else one launch of the variant's kernel, counted on ``fn``."""
    if variant == "v2s" and rql.per_byte != 2:
        raise ValueError("the v2s kernel takes 4-bit codes only "
                         "(dequant_matmul_v2 resolves the variant that fits)")
    if x.device.type == "cpu":
        return dequant_matmul_v2w_reference(x, rql, mxu_dtype, variant)
    return _launch_variant(fn, variant, *_PER_WEIGHT[variant], x, rql, mxu_dtype)


def dequant_matmul_v2g(x: torch.Tensor, rql: RuntimeQuantLinearV2,
                       mxu_dtype=torch.bfloat16) -> torch.Tensor:
    """y (M, d_out) f32 = T(x) @ T(scale * q) - xsum @ off2 through the v2g
    kernel (``csrc/qmatmul_v2g.cu``), T the rounding to ``mxu_dtype`` (bf16,
    the dispatch's, or f32).

    A CUDA ``x`` (f32 or bf16) launches the kernel on the current stream
    and counts one launch (with bf16 operands: from ``MMA_MIN_ROWS`` rows
    the tensor-core tiles, also counted in ``mma_launches``; the variants
    of ``DECODE_MMA_VARIANTS`` below that, from their
    ``DECODE_MMA_MIN_ROWS``, their tensor-core decode tile, also counted in
    ``decode_mma_launches``); a
    CPU ``x``
    runs the plain version. The kernel library is built on first use. The planes are validated, and their
    alignment read, on the first call with each weight; later calls check
    only x. Every v2 variant wrapper below has this contract."""
    return _per_weight(dequant_matmul_v2g, "v2g", x, rql, mxu_dtype)


def dequant_matmul_v2_exact(x: torch.Tensor, rql: RuntimeQuantLinearV2,
                            mxu_dtype=torch.bfloat16) -> torch.Tensor:
    """y = T(x) @ T(scale * (q - shift) - off) through the v2 kernel
    (``csrc/qmatmul_v2.cu``): the bit-exact f32 weight, then rounded; with
    bf16 operands from its ``DECODE_MMA_MIN_ROWS`` to 8 rows on the
    tensor-core decode tile (``V2Mma<kV2>`` through
    ``csrc/qmatmul_decode_mma.cuh``: each weight one f32 FMA from 128 + q,
    and one subtraction for the formats with a min; also counted in
    ``decode_mma_launches``)."""
    return _per_weight(dequant_matmul_v2_exact, "v2", x, rql, mxu_dtype)


def dequant_matmul_v3(x: torch.Tensor, rql: RuntimeQuantLinearV2,
                      mxu_dtype=torch.bfloat16) -> torch.Tensor:
    """y = T(x) @ T(T(q) * T(scale)) - xsum @ off2 through the v3 kernel
    (``csrc/qmatmul_v3.cu``): the scale rounded before the product; with
    bf16 operands from its ``DECODE_MMA_MIN_ROWS`` to 8 rows on the
    tensor-core decode tile (``V2Mma<kV3>`` through
    ``csrc/qmatmul_decode_mma.cuh``: each pair of weights one bf16x2 FMA,
    the xsum term in f32; also counted in ``decode_mma_launches``)."""
    return _per_weight(dequant_matmul_v3, "v3", x, rql, mxu_dtype)


def dequant_matmul_v2f(x: torch.Tensor, rql: RuntimeQuantLinearV2,
                       mxu_dtype=torch.bfloat16) -> torch.Tensor:
    """y = T(x) @ T(scale * q - off2) through the v2f kernel
    (``csrc/qmatmul_v2.cu``): the shift folded into the group offset; with
    bf16 operands from its ``DECODE_MMA_MIN_ROWS`` to 8 rows on the
    tensor-core decode tile (``V2Mma<kV2f>`` through
    ``csrc/qmatmul_decode_mma.cuh``: v2's FMA forms, whose weights are
    v2f's bit for bit; also counted in ``decode_mma_launches``)."""
    return _per_weight(dequant_matmul_v2f, "v2f", x, rql, mxu_dtype)


def dequant_matmul_v2h(x: torch.Tensor, rql: RuntimeQuantLinearV2,
                       mxu_dtype=torch.bfloat16) -> torch.Tensor:
    """y = T(x) @ T(T(T(scale) * T(q)) - T(off2)) through the v2h kernel
    (``csrc/qmatmul_v3.cu``): v2f's affine in the operand type; with bf16
    operands from its ``DECODE_MMA_MIN_ROWS`` to 8 rows on the tensor-core
    decode tile (``V2Mma<kV2h>`` through ``csrc/qmatmul_decode_mma.cuh``,
    also counted in ``decode_mma_launches``)."""
    return _per_weight(dequant_matmul_v2h, "v2h", x, rql, mxu_dtype)


def dequant_matmul_v2s(x: torch.Tensor, rql: RuntimeQuantLinearV2,
                       mxu_dtype=torch.bfloat16) -> torch.Tensor:
    """v2g's function through the v2s kernel (``csrc/qmatmul_v2g.cu``; 4-bit
    codes only): the low- and high-nibble halves summed apart (from
    ``MMA_MIN_ROWS`` rows with bf16 operands on the tensor-core tiles, each
    64-row step's high-nibble products summed before they meet the low
    ones; with bf16 operands from its ``DECODE_MMA_MIN_ROWS`` to 8 rows on
    the tensor-core decode tile, ``V2Mma<kV2s>`` through
    ``csrc/qmatmul_decode_mma.cuh``: each warp's high-nibble slice of a
    step summed apart, then added once; also counted in
    ``decode_mma_launches``)."""
    return _per_weight(dequant_matmul_v2s, "v2s", x, rql, mxu_dtype)


_V1_ARGS = ((ctypes.c_void_p, ctypes.c_int) + (ctypes.c_void_p,) * 5
            + (ctypes.c_int,) * 10 + (ctypes.c_void_p,))


def _launch_v1(x: torch.Tensor, rql: RuntimeQuantLinear, mma: bool = True,
               decode_mma: bool = True):
    """One launch of ``csrc/qmatmul_v1.cu`` on x's current stream (the
    library is built on first use). A bf16 x on a vec-4 weight runs the
    tensor-core tiles of ``csrc/qmatmul_v1_mma.cuh`` (the group dot of raw
    codes, exact products and f32 sums; tile code 1 of the entry point):
    with ``mma`` the prefill tiles from ``MMA_MIN_ROWS`` rows, with
    ``decode_mma`` the decode tile from ``DECODE_MMA_MIN_ROWS["v1"]``
    (read at every call) to 8 rows. Everything else runs v1_kernel's
    CUDA-core tiles of up to 32 rows (an f32 x would have to be rounded to
    bf16). Returns (y, the tile that ran: "decode_mma", "mma" or
    "cuda_core")."""
    bf16 = x.dtype == torch.bfloat16
    lo = DECODE_MMA_MIN_ROWS["v1"]
    x, vec, mt, per, splits, out, part = launch_setup(
        x, rql, mma=mma and bf16, decode_mma=decode_mma and bf16, decode_min_rows=lo)
    M, d_in = x.shape
    # the tiles _plan gave (v1_kernel has a 16-row tile too, under tile code 0)
    tile = ("mma" if mma and bf16 and vec == 4 and M >= MMA_MIN_ROWS else
            "decode_mma" if decode_mma and bf16 and vec == 4 and lo <= M < MMA_MIN_ROWS else
            "cuda_core")
    rc = c_function("qmatmul_v1", "gg_v1_matmul", _V1_ARGS)(
        x.data_ptr(), int(bf16), _ptr(rql.qs), _ptr(rql.scale_t),
        _ptr(rql.offset_t), _ptr(part), out.data_ptr(),
        M, d_in, rql.d_out, rql.per_byte, rql.group_size, int(tile != "cuda_core"), mt, vec,
        per, splits, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qmatmul_v1 launch failed: CUDA error {rc}")
    return out, tile


def dequant_matmul_v1(x: torch.Tensor, rql: RuntimeQuantLinear) -> torch.Tensor:
    """y (M, d_out) f32 = f32(x) @ (scale_t * q - offset_t) through the v1
    kernel (``csrc/qmatmul_v1.cu``); a CPU ``x`` runs the plain version. A
    bf16 x on a vec-4 weight runs the tensor-core tiles: from
    ``MMA_MIN_ROWS`` rows (prefill and perplexity under serving) the
    prefill tiles, also counted in ``mma_launches``; from
    ``DECODE_MMA_MIN_ROWS["v1"]`` to 8 rows (decode steps) the decode
    tile, also counted in ``decode_mma_launches``. An f32 x, fewer rows
    and vec-1 weights run the f32 CUDA-core tiles. Same contract as
    ``dequant_matmul_v2g``."""
    if x.device.type == "cpu":
        return dequant_matmul_v1_reference(x, rql)
    out, tile = _launch_v1(x, rql)
    dequant_matmul_v1.launches += 1
    if tile == "mma":
        dequant_matmul_v1.mma_launches += 1
    elif tile == "decode_mma":
        dequant_matmul_v1.decode_mma_launches += 1
    return out


dequant_matmul_v1.launches = 0
dequant_matmul_v1.mma_launches = 0
dequant_matmul_v1.decode_mma_launches = 0

_GROUP_DOT = {"v2m": (0, 32), "v2t": (1, 32), "v2p": (2, 16)}  # body, group size


def _group_dot(fn, variant: str, x: torch.Tensor, rql: RuntimeQuantLinearV2,
               mxu_dtype) -> torch.Tensor:
    """The shared body of the v2m / v2t / v2p wrappers: the plain version
    for a CPU x, else one launch of the variant's body, counted on ``fn``."""
    body, gs = _GROUP_DOT[variant]
    if rql.group_size != gs:
        raise ValueError(f"the {variant} kernel takes group size {gs}, not {rql.group_size} "
                         "(dequant_matmul_v2 resolves the variant that fits)")
    if x.device.type == "cpu":
        return dequant_matmul_v2m_reference(x, rql, mxu_dtype)
    return _launch_variant(fn, variant, "qmatmul_v2m", body, x, rql, mxu_dtype)


def dequant_matmul_v2m(x: torch.Tensor, rql: RuntimeQuantLinearV2,
                       mxu_dtype=torch.bfloat16) -> torch.Tensor:
    """y = sum_g scale_g * (T(x_g) @ q_g) - xsum @ off2 through the v2m
    kernel (``csrc/qmatmul_v2m.cu``; gs 32: Q4_K, Q5_K): each group's raw
    codes dotted with x, the scale applied to the partial sum at once (from
    ``MMA_MIN_ROWS`` rows with bf16 operands on the tensor-core tiles of
    ``csrc/qmatmul_v2m_mma.cuh``, also counted in ``mma_launches``; with
    bf16 operands from its ``DECODE_MMA_MIN_ROWS`` to 8 rows on the
    tensor-core decode tile, ``GroupDotMma`` at gs 32 through
    ``csrc/qmatmul_decode_mma.cuh``: each k16 slice's partial, half a
    group, scaled into the accumulator by its own FMA; also counted in
    ``decode_mma_launches``)."""
    return _group_dot(dequant_matmul_v2m, "v2m", x, rql, mxu_dtype)


def dequant_matmul_v2t(x: torch.Tensor, rql: RuntimeQuantLinearV2,
                       mxu_dtype=torch.bfloat16) -> torch.Tensor:
    """v2m's function through the v2t kernel (gs 32): a supergroup's
    per-group partial sums first, then their scale-weighted reduction; from
    ``MMA_MIN_ROWS`` rows with bf16 operands on the tensor-core tiles of
    ``csrc/qmatmul_v2m_mma.cuh``, which sum each 64-row step's scaled
    partials before the accumulator; with bf16 operands from its
    ``DECODE_MMA_MIN_ROWS`` to 8 rows the tensor-core decode tile in the
    same order (``GroupSumMma`` through ``csrc/qmatmul_decode_mma.cuh``:
    each warp's two slice partials of a step scaled and summed, then added
    once; also counted in ``decode_mma_launches``)."""
    return _group_dot(dequant_matmul_v2t, "v2t", x, rql, mxu_dtype)


def dequant_matmul_v2p(x: torch.Tensor, rql: RuntimeQuantLinearV2,
                       mxu_dtype=torch.bfloat16) -> torch.Tensor:
    """v2m's function at gs 16 (Q2_K, Q3_K, Q6_K) through the v2p kernel:
    two adjacent groups' partial sums scaled and added together, then
    added to the accumulator (JAX's pair-group dot); from ``MMA_MIN_ROWS``
    rows with bf16 operands v2m's tensor-core tiles at gs 16, each partial
    scaled into the accumulator by its own FMA; with bf16 operands from
    its ``DECODE_MMA_MIN_ROWS`` to 8 rows the tensor-core decode tile in
    the same form (``GroupDotMma`` through ``csrc/qmatmul_decode_mma.cuh``,
    also counted in ``decode_mma_launches``)."""
    return _group_dot(dequant_matmul_v2p, "v2p", x, rql, mxu_dtype)


for _fn in (dequant_matmul_v2g, dequant_matmul_v2_exact, dequant_matmul_v3, dequant_matmul_v2f,
            dequant_matmul_v2h, dequant_matmul_v2s, dequant_matmul_v2m, dequant_matmul_v2t,
            dequant_matmul_v2p):
    _fn.launches = 0

# The kernel variant a v2 weight runs, as in the JAX package (same names,
# same environment variables, default v2g; the gs=16 knob, empty by
# default, overrides it for Q2_K / Q3_K / Q6_K weights, the Q6_K lm_head
# included). dequant_matmul reads both at every call.
PALLAS_V2_VARIANT = os.environ.get("GG_PALLAS_V2_VARIANT", "v2g")
PALLAS_V2_VARIANT_GS16 = os.environ.get("GG_PALLAS_V2_VARIANT_GS16", "")
# variant -> the name of its wrapper in this module (looked up at each call,
# so a test may replace a wrapper)
V2_WRAPPERS = {"v2": "dequant_matmul_v2_exact", "v3": "dequant_matmul_v3",
               "v2f": "dequant_matmul_v2f", "v2h": "dequant_matmul_v2h",
               "v2g": "dequant_matmul_v2g", "v2s": "dequant_matmul_v2s",
               "v2m": "dequant_matmul_v2m", "v2t": "dequant_matmul_v2t",
               "v2p": "dequant_matmul_v2p"}
V2_VARIANTS = tuple(V2_WRAPPERS)
# the per-weight and the group-dot variants; every wrapper runs the
# tensor-core tiles at prefill and counts those launches in ``mma_launches``
MMA_VARIANTS = PER_WEIGHT_VARIANTS
MMA_GROUP_DOT = tuple(_GROUP_DOT)
for _v in MMA_VARIANTS + MMA_GROUP_DOT:
    globals()[V2_WRAPPERS[_v]].mma_launches = 0
for _v in DECODE_MMA_VARIANTS:
    globals()[V2_WRAPPERS[_v]].decode_mma_launches = 0


def _effective_v2_variant(variant: str, *, gs: int, per_byte: int) -> str:
    """The variant that runs for a requested one, by JAX's table: v2s on
    byte-wide codes -> v2g; v2p at gs != 16 -> v2m; v2m at gs 16 -> v2p;
    v2t at gs 16 -> v2g.

    JAX's further rules send v2m / v2t / v2p to v2g when the group-gathered
    x would not tile on 8 TPU sublanes (``((tile_in // gs) * B) % 8`` or
    ``tile_in % 32``). They never fire here: every port kernel needs
    d_in % 256 == 0, so JAX's tile_in is a multiple of 256 and
    tile_in / 32 and tile_in / gs are multiples of 8 at any B."""
    if variant not in V2_VARIANTS:
        raise ValueError(f"unknown v2 kernel variant {variant!r}; one of {V2_VARIANTS}")
    if variant == "v2s" and per_byte != 2:
        return "v2g"
    if variant == "v2p" and gs != 16:
        return "v2m"
    if variant in ("v2m", "v2t") and gs == 16:
        return "v2p" if variant == "v2m" else "v2g"
    return variant


def _requested_v2_variant(rql: RuntimeQuantLinearV2) -> str:
    if rql.group_size == 16 and PALLAS_V2_VARIANT_GS16:
        return PALLAS_V2_VARIANT_GS16
    return PALLAS_V2_VARIANT


def effective_v2_variant_for(rql: RuntimeQuantLinearV2, B: int = 8,
                             variant: Optional[str] = None) -> str:
    """The kernel a dispatch of ``rql`` runs (``variant`` None: the knobs'
    current choice). ``B`` is kept from the JAX signature: the port's
    kernels take every row count, so it changes nothing."""
    del B
    return _effective_v2_variant(variant or _requested_v2_variant(rql),
                                 gs=rql.group_size, per_byte=rql.per_byte)


def dequant_matmul_v2(x: torch.Tensor, rql: RuntimeQuantLinearV2, *,
                      variant: str = "v2", mxu_dtype=torch.bfloat16) -> torch.Tensor:
    """y (M, d_out) f32 = x @ dequant(W)^T through the effective kernel of
    ``variant`` (the counterpart of JAX's ``dequant_matmul_pallas_v2``
    without its TPU tile arguments). ``mxu_dtype`` is the operand type of
    the products: bf16 (the dispatch's) or f32 (JAX's bit-matched test
    mode). A CPU x runs the variant's plain version. An unknown name raises
    ValueError: nothing falls back to another kernel."""
    v = _effective_v2_variant(variant, gs=rql.group_size, per_byte=rql.per_byte)
    return globals()[V2_WRAPPERS[v]](x, rql, mxu_dtype)


def dequant_matmul(x: torch.Tensor, rql) -> torch.Tensor:
    """y (M, d_out) f32 = x @ dequant(W)^T, routed by the weight's format:
    v1 -> the v1 kernel, v2 -> the kernel variant the knobs pick
    (``PALLAS_V2_VARIANT`` / ``_GS16``, v2g by default), v4 -> the v4
    kernel (each takes its plain version for a CPU x).

    The knobs are module attributes read at every call, so setting one
    takes effect at once, in this process. The JAX package bakes the
    variant into its jitted step when that is first traced (its
    ``scripts/engine_ab.py`` runs each variant in a fresh process)."""
    from . import qmv4

    if isinstance(rql, RuntimeQuantLinearV2):
        if PALLAS_V2_VARIANT == "v2g" and not PALLAS_V2_VARIANT_GS16:
            return dequant_matmul_v2g(x, rql, torch.bfloat16)  # the default: nothing to resolve
        return dequant_matmul_v2(x, rql, variant=_requested_v2_variant(rql))
    if isinstance(rql, RuntimeQuantLinear):
        return dequant_matmul_v1(x, rql)
    if isinstance(rql, qmv4.RuntimeQuantLinearV4):
        return qmv4.dequant_matmul_v4(x, rql)
    raise TypeError(f"not a packed weight: {type(rql).__name__}")


def fuse_rql_v2(parts: Sequence) -> Optional[RuntimeQuantLinearV2]:
    """Concatenate v2 packed weights along the output dim (same d_in): one
    kernel launch for q/k/v or gate/up. Exact (every plane is
    per-output-column). None if the parts don't share a layout (mixed
    qtypes, e.g. Q4_K q/k with a Q6_K v in Q4_K_M files)."""
    if not all(isinstance(p, RuntimeQuantLinearV2) for p in parts):
        return None
    p0 = parts[0]
    if not all(
        (p.group_size, p.per_byte, p.shift, p.d_rep, p.has_min, p.d_in)
        == (p0.group_size, p0.per_byte, p0.shift, p0.d_rep, p0.has_min, p0.d_in)
        for p in parts
    ):
        return None

    def cat(attr):
        return torch.cat([getattr(p, attr) for p in parts], dim=1)

    return RuntimeQuantLinearV2(
        cat("qs"), cat("d_sg"),
        cat("dmin_sg") if p0.has_min else None,
        cat("sc_q"), cat("mn_q") if p0.has_min else None,
        p0.d_in, p0.group_size, p0.per_byte, p0.shift, p0.d_rep,
    )


def pad_dout_v2(rql: RuntimeQuantLinearV2, multiple: int = 512) -> RuntimeQuantLinearV2:
    """Zero-pad the output dim to a multiple (zero codes and scales
    dequantize to exactly 0); the consumer slices logits back to the vocab.
    Kept for layout parity with the JAX package, whose lm_head is padded
    the same way."""
    pad = (-rql.d_out) % multiple
    if pad == 0:
        return rql

    def p(a):
        return None if a is None else F.pad(a, (0, pad))

    return RuntimeQuantLinearV2(
        p(rql.qs), p(rql.d_sg), p(rql.dmin_sg), p(rql.sc_q), p(rql.mn_q),
        rql.d_in, rql.group_size, rql.per_byte, rql.shift, rql.d_rep)


# default runtime weight format for new packs, as in the JAX package: "v2"
# (compact scales), "v4" (per-group scale + folded offsets, ops/qmv4.py) or
# "v1" (per-group f32 scale and offset)
RUNTIME_FORMAT = "v2"


def pack_runtime_auto(qweight, params: SuperGroupParams, qtype: GGMLQuantizationType,
                      fmt: Optional[str] = None, device="cuda"):
    """Pack layer codes in ``fmt`` (default ``RUNTIME_FORMAT``); v4 packs
    with f32 scales in the i32 layout, as the JAX package's does."""
    fmt = fmt or RUNTIME_FORMAT
    if fmt == "v4":
        from . import qmv4

        return qmv4.pack_runtime_v4(qweight, params, qtype, device=device)
    if fmt == "v2":
        return pack_runtime_v2(qweight, params, qtype, device=device)
    return pack_runtime(qweight, params, qtype, device=device)


# ---------------------------------------------------------------------------
# Q8 activation-quantized path (llama.cpp vec_dot_q4_K_q8_K semantics)
# ---------------------------------------------------------------------------


def quantize_activations_q8(x: torch.Tensor, sg: int = QK_K):
    """Symmetric int8 per-supergroup activation quantization: (q (B, d_in)
    int8, d (B, n_sg) f32) with q = round(x / d) (half to even), d =
    amax / 127, the Q8_K scheme llama.cpp quantizes activations with
    before its integer dot kernels."""
    B, d_in = x.shape
    xr = x.reshape(B, d_in // sg, sg).float()
    d = xr.abs().amax(dim=-1) / 127.0
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)),
                      torch.zeros_like(d))
    q = torch.clamp(torch.round(xr * inv[:, :, None]), -127, 127).to(torch.int8)
    return q.reshape(B, d_in), d


def q8_matmul(x: torch.Tensor, rql: RuntimeQuantLinearV2) -> torch.Tensor:
    """Integer-dot reference (JAX's ``q8_matmul_xla``): x quantized to Q8
    per supergroup, integer group dots, then the two-level scale fixups,
    sumf = d * d8 * sum(sc * idot) - dmin * d8 * sum(mn * bsum). The group
    dots are taken in f32, where they are exact: every product and partial
    sum is an integer below 2^24 (|x8| <= 127, |code| <= 32, 32 per group),
    and TF32 keeps those operands whole too."""
    B, d_in = x.shape
    gs = rql.group_size
    ng = d_in // gs
    xq, d_x = quantize_activations_q8(x)
    codes = _unpack_codes(rql.qs, rql.per_byte, rql.d_in_local).float() - rql.shift
    xg = xq.reshape(B, ng, gs).float()
    idot = torch.bmm(xg.transpose(0, 1), codes.reshape(ng, gs, rql.d_out))  # (ng, B, d_out)
    scale, off = _group_scales_v2(rql)
    dx_g = d_x.repeat_interleave(QK_K // gs, dim=1)  # (B, ng)
    main = torch.einsum("gbt,gt,bg->bt", idot, scale, dx_g)
    if rql.has_min:
        main = main - (xg.sum(dim=2) * dx_g) @ off
    return main
