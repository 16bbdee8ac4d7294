#!/usr/bin/env python3
"""Time the v2- and v4-format dequant-matmul kernels on the card, for one or
more checkouts of the repository, each in a process of its own.

    python3 tools/time_v2_kernels.py [--variant v2g | --format v4|v4-i8|v4-bf16]
                                     [--m 8] [--reps 50] [ROOT ...]
                                     (default: this checkout)

Roots run in the order given (pass A B B A to compare two trees within one
run). Each root times its wrapper of ``--variant`` (``dequant_matmul_v2g``
by default; the variant must exist in every root given), or with
``--format`` the v4 kernel (``qmv4.dequant_matmul_v4``: f32 scales and the
"i32" layout, the "i8" layout, or bf16 scales), at M bf16 rows (``--m``,
default 8, the B=8 decode step; a comma list such as 9,16,32,64 times each
in turn) over the weights one Llama-3-8B forward reads: the fused q/k/v
(6144 x 4096), o (4096 x 4096), fused gate/up (28672 x 4096) and down (4096
x 14336) at Q4_K, 32 layers each, and the Q6_K lm_head (128512 x 4096
padded in v2, 128256 in v4). The planes are random bytes of the format's
layout made on the card from a seed (the same in every root; their values
do not change the work). Device time per call from CUDA events around each
call, the L2 cache flushed outside them, mean of REPS calls queued behind a
device sleep (so host time between the calls is not counted). Beside each
shape: bf16 ``torch.matmul`` of the same x on the dequantized weight (the
library yardstick, timed the same way), the bound, the larger of the bytes
(planes once, x, y) over 3.35 TB/s and the operations over 989 TFLOP/s
bf16, and for v4 the same weight without its offc plane (the share of the
xsum @ offc term). Prints, per root, the ptxas report (registers, spill
store and load bytes per kernel) of the kernel library it built, then one
JSON line per M: ms per call by shape and ms per forward (4 x 32
projections + the lm_head; at M = 8 the B=8 decode step). Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

SEED = 7
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12   # dense bf16 tensor-core peak
# name, d_out, d_in, per_byte, group size, has_min, shift, calls per step
SHAPES = (("qkv", 6144, 4096, 2, 32, True, 0, 32), ("o", 4096, 4096, 2, 32, True, 0, 32),
          ("gateup", 28672, 4096, 2, 32, True, 0, 32), ("down", 4096, 14336, 2, 32, True, 0, 32),
          ("lm_head", 128512, 4096, 1, 16, False, 32, 1))
V4_HEAD = 128256  # v4 keeps the vocabulary unpadded
FORMATS = {"v4": ("float32", "i32"), "v4-i8": ("float32", "i8"),
           "v4-bf16": ("bfloat16", "i32")}  # --format: scale dtype, code layout


def planes(gen, d_out, d_in, per_byte, gs, has_min, dev):
    """Random v2 planes: codes, f16-valued super-scales (each row twice, as
    the packer lays them out), 6-bit group scales and mins."""
    import torch

    n_sg, ng = d_in // 256, d_in // gs

    def u8(rows, hi):
        return torch.randint(0, hi, (rows, d_out), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.uint8)

    def super_scale():
        s = (torch.rand((n_sg, d_out), generator=gen, device=dev) * 1e-3).half().float()
        return s.repeat_interleave(2, dim=0).contiguous()

    qs = u8(d_in // per_byte, 256 if per_byte == 2 else 64)
    if has_min:
        return qs, super_scale(), super_scale(), u8(ng, 64), u8(ng, 64)
    sc = (torch.randint(-31, 32, (ng, d_out), generator=gen, device=dev,
                        dtype=torch.int32)).to(torch.int8)
    return qs, super_scale(), None, sc, None


def planes_v4(gen, d_out, d_in, per_byte, gs, scale_dtype, dev):
    """Random v4 planes: code bytes (6-bit codes for byte-wide types),
    scales rounded to the scale dtype, f32 folded offsets."""
    import torch

    hi = 256 if per_byte == 2 else 64
    qs = torch.randint(0, hi, (d_in // per_byte, d_out), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    scale = (torch.rand((d_in // gs, d_out), generator=gen, device=dev) * 1e-3)
    offc = torch.rand((d_in // gs, d_out), generator=gen, device=dev) * 1e-3
    return qs, scale.to(getattr(torch, scale_dtype)), offc


def ptxas_report(nvcc_log: str) -> dict:
    """kernel -> [registers, spill store bytes, spill load bytes] from
    nvcc's -Xptxas -v output (names demangled where c++filt is found,
    the anonymous namespace's per-file hash removed either way)."""
    pat = re.compile(r"Compiling entry function '(\S+)' for 'sm_\w+'\n.*?(\d+) bytes spill "
                     r"stores, (\d+) bytes spill loads\n.*?Used (\d+) registers", re.S)
    found = [(m[1], [int(m[4]), int(m[2]), int(m[3])]) for m in pat.finditer(nvcc_log)]
    names = [n for n, _ in found]
    if shutil.which("c++filt") and names:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True).stdout.splitlines()
        names = out if len(out) == len(names) else names
    return {re.sub(r"_GLOBAL__N__\w+?_cu_\w{8}", "ANON", n): r
            for n, (_, r) in zip(names, found)}


def one_root(root: str, variant: str, fmt: str, reps: int, ms: list) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from gptq_gguf_tpu_torch.ops import cuda_build, qmatmul

    dev = torch.device("cuda")
    if fmt:
        from gptq_gguf_tpu_torch.ops import qmv4

        lib = "qmatmul_v4"
        scale_dtype, layout = FORMATS[fmt]
        fn = qmv4.dequant_matmul_v4
    else:
        names = getattr(qmatmul, "V2_WRAPPERS", {"v2g": "dequant_matmul_v2g"})
        lib = getattr(qmatmul, "_PER_WEIGHT", {}).get(variant, ("qmatmul_v2m",))[0]
        fn = getattr(qmatmul, names[variant])
    nvcc_log = cuda_build.build(lib)
    print(json.dumps({"root": root, "library": lib, "ptxas": ptxas_report(nvcc_log or "")
                      if nvcc_log else "cached"}), flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def device_ms(call):
        for _ in range(3):  # the library's first load and launch stay out
            call()
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # the card waits while the host queues every call
        events = []
        for _ in range(reps):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in events) / reps

    for M in ms:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        out, lib_ms, bound, bare = {}, {}, {}, {}
        for name, d_out, d_in, per_byte, gs, has_min, shift, calls in SHAPES:
            if fmt:
                d_out = V4_HEAD if name == "lm_head" else d_out
                qs, scale, offc = planes_v4(gen, d_out, d_in, per_byte, gs, scale_dtype, dev)
                rql = qmv4.RuntimeQuantLinearV4(qs, scale, offc, d_in, gs, per_byte, layout)
                no_off = qmv4.RuntimeQuantLinearV4(qs, scale, None, d_in, gs, per_byte, layout)
                w = qmv4.dequantize_runtime_v4(rql)
            else:
                rql = qmatmul.RuntimeQuantLinearV2(
                    *planes(gen, d_out, d_in, per_byte, gs, has_min, dev), d_in, gs, per_byte,
                    shift, 2)
                w = qmatmul.dequantize_runtime_v2(rql)
            w = w.T.contiguous().to(torch.bfloat16)
            x = (torch.randn((M, d_in), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            out[name] = device_ms(lambda: fn(x, rql))
            if fmt:
                bare[name] = device_ms(lambda: fn(x, no_off))
                del no_off
            lib_ms[name] = device_ms(lambda: torch.matmul(x, w))
            nbytes = rql.bytes_read + x.numel() * 2 + M * d_out * 4
            bound[name] = max(nbytes / HBM_BYTES_PER_S, 2.0 * M * d_in * d_out
                              / BF16_FLOP_PER_S) * 1e3
            del rql, x, w
            torch.cuda.empty_cache()

        def forward(per_call):
            return sum(per_call[s[0]] * s[7] for s in SHAPES)

        rec = {"root": root, "variant": None if fmt else variant, "format": fmt, "M": M,
               "ms_per_call": out, "library_ms_per_call": lib_ms,
               "bound_ms_per_call": bound, "ms_per_forward": forward(out),
               "library_ms_per_forward": forward(lib_ms), "bound_ms_per_forward": forward(bound)}
        if fmt:
            rec.update(no_offc_ms_per_call=bare, no_offc_ms_per_forward=forward(bare))
        print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--variant", default="v2g")
    ap.add_argument("--format", default="", choices=["", *FORMATS],
                    help="time the v4 kernel in this format instead of a v2 variant")
    ap.add_argument("--m", default="8", help="rows of x, or a comma list of row counts")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one_root(args.one, args.variant, args.format, args.reps,
                 [int(m) for m in args.m.split(",")])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_v2_kernels: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    for root in args.roots:
        rc = subprocess.run([sys.executable, __file__, "--one", root, "--variant", args.variant,
                             "--format", args.format, "--m", args.m,
                             "--reps", str(args.reps)]).returncode
        if rc != 0:
            print(f"time_v2_kernels: root {root} failed ({rc})", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
