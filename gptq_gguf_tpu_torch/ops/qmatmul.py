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
  ``offset_t``. Kernel: ``csrc/qmatmul_v1.cu``, f32 end to end.
* v2 (``RuntimeQuantLinearV2``): ``d_sg`` / ``dmin_sg`` (d_rep * n_sg, d_out)
  f32 super-scale / super-min, each supergroup row replicated ``d_rep`` = 2
  times (a TPU tiling rule the layout keeps so packed weights compare equal
  across the two packages); ``sc_q`` / ``mn_q`` (n_groups, d_out) quantized
  group scales (int8 for the signed types, else uint8) and mins (None for
  the signed types). Kernel: ``csrc/qmatmul_v2g.cu``.

``dequant_matmul`` routes by the weight's class. A CUDA tensor launches that
format's kernel (or raises); a CPU tensor runs the kernel's plain PyTorch
version. The kernels take every shape with d_in % 256 == 0 and any d_out or
M, so there is no other path. ``pack_runtime_auto`` packs in the format
``RUNTIME_FORMAT`` names, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
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


def dequant_matmul_v2g_reference(x: torch.Tensor, rql: RuntimeQuantLinearV2) -> torch.Tensor:
    """Plain PyTorch version of the v2g kernel, on any device:

        y (M, d_out) f32 = bf16(x) @ bf16(scale * q) - xsum @ off2

    with q the raw unsigned code and xsum the f32 group sums of the
    un-rounded x (the JAX kernel's arithmetic; only the sum order of the
    f32 accumulation can differ)."""
    x32 = x.float()
    M, d_in = x32.shape
    gs = rql.group_size
    xsum = x32.reshape(M, d_in // gs, gs).sum(dim=-1)
    scale, off2 = _folded_planes_v2(rql)  # (ng, d_out)
    ng = scale.shape[0]
    q = _unpack_codes(rql.qs, rql.per_byte, d_in).float()
    w = (scale[:, None, :] * q.reshape(ng, gs, rql.d_out)).reshape(d_in, rql.d_out)
    y = x32.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
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


def _launch_plan(M: int, d_out: int, n_sg: int, n_sm: int, vec: int = 4):
    """(rows per block, supergroups per split, splits). Blocks cover 128
    columns at MT <= 8 (four warps split each supergroup) and 512 beyond,
    a quarter of that with vec 1; the K axis is split over supergroups only
    as far as needed to put ~4 blocks on every SM."""
    mt = 1
    while mt < min(M, 32):
        mt *= 2
    if vec == 1:
        mt = 1 if mt == 1 else 8 if mt <= 8 else 32
    cols = (128 if mt <= 8 else 512) * vec // 4
    base = -(-M // mt) * -(-d_out // cols)
    target = 4 * n_sm
    splits = 1 if base >= target else min(n_sg, -(-target // base))
    per = -(-n_sg // splits)
    return mt, per, -(-n_sg // per)


def launch_setup(x: torch.Tensor, rql):
    """The shared front of the dequant-matmul kernel wrappers for a CUDA x:
    x as a contiguous f32 or bf16 tensor, the planes validated (and their
    alignment read) on the first call with each weight, the launch plan,
    the output and the split-K scratch. Returns (x, vec, mt, per, splits,
    out, part); vec 4 needs d_out % 4 == 0 and 16-byte-aligned planes."""
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
    mt, per, splits = _launch_plan(M, rql.d_out, d_in // QK_K, _sm_count(x.device.index),
                                   rql._vec)
    out = torch.empty((M, rql.d_out), dtype=torch.float32, device=x.device)
    part = (torch.empty((splits, M, rql.d_out), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    return x, rql._vec, mt, per, splits, out, part


_V2G_ARGS = ((ctypes.c_void_p, ctypes.c_int) + (ctypes.c_void_p,) * 7
             + (ctypes.c_int,) * 12 + (ctypes.c_void_p,))


def dequant_matmul_v2g(x: torch.Tensor, rql: RuntimeQuantLinearV2) -> torch.Tensor:
    """y (M, d_out) f32 = x @ dequant(W)^T through the v2g kernel.

    A CUDA ``x`` (f32 or bf16) launches ``csrc/qmatmul_v2g.cu`` on the
    current stream and counts one launch; a CPU ``x`` runs the plain
    version. The kernel library is built on first use. The planes are
    validated, and their alignment read, on the first call with each
    weight; later calls check only x."""
    if x.device.type == "cpu":
        return dequant_matmul_v2g_reference(x, rql)
    x, vec, mt, per, splits, out, part = launch_setup(x, rql)
    M, d_in = x.shape
    rc = c_function("qmatmul_v2g", "gg_v2g_matmul", _V2G_ARGS)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), _ptr(rql.qs), _ptr(rql.d_sg),
        _ptr(rql.dmin_sg), _ptr(rql.sc_q), _ptr(rql.mn_q), _ptr(part), out.data_ptr(),
        M, d_in, rql.d_out, rql.per_byte, rql.group_size, int(rql.has_min), rql.shift,
        rql.d_rep, mt, vec, per, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qmatmul_v2g launch failed: CUDA error {rc}")
    dequant_matmul_v2g.launches += 1
    return out


dequant_matmul_v2g.launches = 0

_V1_ARGS = ((ctypes.c_void_p, ctypes.c_int) + (ctypes.c_void_p,) * 5
            + (ctypes.c_int,) * 9 + (ctypes.c_void_p,))


def dequant_matmul_v1(x: torch.Tensor, rql: RuntimeQuantLinear) -> torch.Tensor:
    """y (M, d_out) f32 = f32(x) @ (scale_t * q - offset_t) through the v1
    kernel (``csrc/qmatmul_v1.cu``, f32 on the CUDA cores); a CPU ``x``
    runs the plain version. Same contract as ``dequant_matmul_v2g``."""
    if x.device.type == "cpu":
        return dequant_matmul_v1_reference(x, rql)
    x, vec, mt, per, splits, out, part = launch_setup(x, rql)
    M, d_in = x.shape
    rc = c_function("qmatmul_v1", "gg_v1_matmul", _V1_ARGS)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), _ptr(rql.qs), _ptr(rql.scale_t),
        _ptr(rql.offset_t), _ptr(part), out.data_ptr(),
        M, d_in, rql.d_out, rql.per_byte, rql.group_size, mt, vec, per, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qmatmul_v1 launch failed: CUDA error {rc}")
    dequant_matmul_v1.launches += 1
    return out


dequant_matmul_v1.launches = 0


def dequant_matmul(x: torch.Tensor, rql) -> torch.Tensor:
    """y (M, d_out) f32 = x @ dequant(W)^T, routed by the weight's format:
    v1 -> the v1 kernel, v2 -> v2g, v4 -> the v4 kernel (each takes its
    plain version for a CPU x)."""
    from . import qmv4

    if isinstance(rql, RuntimeQuantLinearV2):
        return dequant_matmul_v2g(x, rql)
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
