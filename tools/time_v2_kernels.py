#!/usr/bin/env python3
"""Time the v2- and v4-format dequant-matmul kernels on the card, for one or
more checkouts of the repository, each in a process of its own.

    python3 tools/time_v2_kernels.py [--variant v2g | --format v4|v4-i8|v4-bf16|v1]
                                     [--m 8] [--reps 50] [--bm 32|64|128]
                                     [--core] [--decode-blocks N] [--flush read]
                                     [ROOT ...]   (default: this checkout)

Roots run in the order given (pass A B B A to compare two trees within one
run). Each root times ``qmatmul.dequant_matmul_v2(x, w, variant=...)`` for
``--variant`` (v2g by default), so each shape runs that variant's effective
kernel, as the dispatch would (v2m runs v2p on the gs-16 lm_head, v2t and
v2s run v2g there), and the record names the kernel per shape; or with
``--format`` the v4 kernel (``qmv4.dequant_matmul_v4``: f32 scales and the
"i32" layout, the "i8" layout, or bf16 scales), or with ``--format v1``
the v1 kernel (``qmatmul.dequant_matmul_v1``: f32 scale_t and offset_t;
the library yardstick f32 ``torch.matmul`` with TF32 off, the bound in f32
operations on the CUDA-core tile, bf16 on the tensor-core tiles), at M
bf16 rows (``--m``,
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
xsum @ offc term). ``--bm`` sets the largest rows per block of the
tensor-core tiles (``qmatmul._mma_plan``'s ``bm_max``, in the roots that
have it; over a variant's own cap, ``qmatmul.MMA_BM_MAX``), to time the
tile sizes against each other. Each record names the tile each shape ran
(``tile_per_call``: "decode_mma", the variant's or the format's
tensor-core decode tile; "mma", the tensor-core prefill tiles;
"cuda_core"), read from the wrapper's counters in the roots that have
them. ``--core`` also times, at M <= 8,
the variant's or the format's CUDA-core tile on the same inputs
(``qmatmul._launch_v2``, or ``qmv4._launch_v4`` in the roots that have it,
with the tensor-core tiles ruled out: ``core_ms_per_call``), and with
``--format v1`` at every M v1_kernel's tile (``qmatmul._launch_v1(x, w,
mma=False, decode_mma=False)`` in the roots that have it; roots without
the decode tile take no ``decode_mma``);
``--decode-blocks`` sets the decode tile's split-K target
(``qmatmul.DECODE_MMA_BLOCKS_PER_SM``), ``--decode-min-rows`` the fewest
rows the route gives the decode tile (every entry of the table
``qmatmul.DECODE_MMA_MIN_ROWS``, v4's among them, or in older roots that
constant and ``qmatmul.V2P_DECODE_MMA_MIN_ROWS``, and with ``--format``
``qmv4.DECODE_MMA_MIN_ROWS`` in the roots that have it),
to time the tile at rows the route leaves to the CUDA-core tile, or to
move a threshold.
``--probe``
also times, at the decode tile's rows of v2g, the decode tile's timing probes on the same inputs
(``ops/csrc/qmatmul_v2g_probe.cu``, wrong results by design: probe 1
without the dequantization, probe 2 without it and the planes' copies;
``probe_ms_per_call``), in the roots that have them. ``--flush read``
evicts the L2 by reading 64 MB instead of writing them (a write leaves
dirty lines that each call then writes back while it reads). Prints, per
root, the ptxas report (registers, spill store and load bytes per kernel)
of each kernel library it uses and of those ``--libs`` names (from nvcc's
output kept beside a library built earlier), then one JSON line per M: ms
per call by shape and ms per forward (4 x 32 projections + the lm_head;
at M = 8 the B=8 decode step). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

SEED = 7
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12   # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12     # f32 on the CUDA cores
# name, d_out, d_in, per_byte, group size, has_min, shift, calls per step
SHAPES = (("qkv", 6144, 4096, 2, 32, True, 0, 32), ("o", 4096, 4096, 2, 32, True, 0, 32),
          ("gateup", 28672, 4096, 2, 32, True, 0, 32), ("down", 4096, 14336, 2, 32, True, 0, 32),
          ("lm_head", 128512, 4096, 1, 16, False, 32, 1))
V4_HEAD = 128256  # v4 keeps the vocabulary unpadded
FORMATS = {"v4": ("float32", "i32"), "v4-i8": ("float32", "i8"),
           "v4-bf16": ("bfloat16", "i32"),  # --format: scale dtype, code layout
           "v1": ("float32", "i32")}  # v1: f32 scale_t, offset_t; the v2 code bytes


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


def tile_of(fn, call) -> str:
    """The tile one ``call`` of wrapper ``fn`` ran, from its counters."""
    before = [getattr(fn, k, 0) for k in ("decode_mma_launches", "mma_launches")]
    call()
    after = [getattr(fn, k, 0) for k in ("decode_mma_launches", "mma_launches")]
    return ("decode_mma" if after[0] > before[0] else "mma" if after[1] > before[1]
            else "cuda_core")


def one_root(root: str, variant: str, fmt: str, reps: int, ms: list, bm: int, core: bool,
             decode_blocks: int, flush_mode: str, probe: bool, extra_libs: list,
             decode_min_rows: int) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from gptq_gguf_tpu_torch.ops import cuda_build, qmatmul

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # v1's f32 yardstick stays f32
    v1 = fmt == "v1"
    if fmt:
        from gptq_gguf_tpu_torch.ops import qmv4

        scale_dtype, layout = FORMATS[fmt]
        fn = qmatmul.dequant_matmul_v1 if v1 else qmv4.dequant_matmul_v4
        kernels = dict.fromkeys((s[0] for s in SHAPES), fmt)
        libs = ["qmatmul_v1" if v1 else "qmatmul_v4"]
    else:
        def fn(x, rql):
            return qmatmul.dequant_matmul_v2(x, rql, variant=variant)

        # shape -> the kernel that runs there, and the libraries those need
        kernels = {s[0]: qmatmul._effective_v2_variant(variant, gs=s[4], per_byte=s[3])
                   for s in SHAPES}
        libs = sorted({qmatmul._PER_WEIGHT.get(k, ("qmatmul_v2m",))[0]
                       for k in kernels.values()})
    if bm:
        plan = qmatmul._mma_plan
        qmatmul._mma_plan = lambda M, d_out, n_sg, n_sm, *_: plan(M, d_out, n_sg, n_sm, bm_max=bm)
    if decode_blocks:
        qmatmul.DECODE_MMA_BLOCKS_PER_SM = decode_blocks
    if decode_min_rows:
        if isinstance(qmatmul.DECODE_MMA_MIN_ROWS, dict):  # one threshold per variant
            qmatmul.DECODE_MMA_MIN_ROWS.update(dict.fromkeys(qmatmul.DECODE_MMA_MIN_ROWS,
                                                             decode_min_rows))
        else:  # roots with v2g's threshold and v2p's apart
            qmatmul.DECODE_MMA_MIN_ROWS = decode_min_rows
            if hasattr(qmatmul, "V2P_DECODE_MMA_MIN_ROWS"):
                qmatmul.V2P_DECODE_MMA_MIN_ROWS = decode_min_rows
        if fmt and hasattr(qmv4, "DECODE_MMA_MIN_ROWS"):  # v4's own threshold
            qmv4.DECODE_MMA_MIN_ROWS = decode_min_rows
    probe = (probe and variant == "v2g" and not fmt
             and (cuda_build.CSRC / "qmatmul_v2g_probe.cu").is_file())
    if probe:
        libs.append("qmatmul_v2g_probe")
    libs += [lib for lib in extra_libs if lib not in libs]
    with ThreadPoolExecutor(len(libs)) as ex:  # one nvcc per source, all at once
        logs = list(ex.map(cuda_build.build, libs))
    for lib, nvcc_log in zip(libs, logs):
        saved = cuda_build.library_path(lib).with_suffix(".log")  # a build's kept output
        nvcc_log = nvcc_log or (saved.read_text() if saved.exists() else None)
        print(json.dumps({"root": root, "library": lib, "ptxas": ptxas_report(nvcc_log)
                          if nvcc_log else "cached"}), flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    warm = torch.ones((4096, 4096), device=dev, dtype=torch.bfloat16)
    t_end = time.perf_counter() + 1.0
    while time.perf_counter() < t_end:  # a second of work first: the first shape ran slow
        warm @ warm
        torch.cuda.synchronize()
    del warm

    def device_ms(call):
        for _ in range(3):  # the library's first load and launch stay out
            call()
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # the card waits while the host queues every call
        events = []
        for _ in range(reps):
            if flush_mode == "read":
                flush.amax()
            else:
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
        out, lib_ms, bound, bare, tiles, core_ms = {}, {}, {}, {}, {}, {}
        probe_ms = {1: {}, 2: {}}
        for name, d_out, d_in, per_byte, gs, has_min, shift, calls in SHAPES:
            if v1:  # v1 keeps the vocabulary unpadded too
                d_out = V4_HEAD if name == "lm_head" else d_out
                qs, scale, offc = planes_v4(gen, d_out, d_in, per_byte, gs, scale_dtype, dev)
                rql = qmatmul.RuntimeQuantLinear(qs, scale, offc, d_in, gs, per_byte)
                w = qmatmul.dequantize_runtime(rql)
            elif fmt:
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
            # the library yardstick: v1's function is f32 (TF32 off), the others bf16
            w = w.T.contiguous().to(torch.float32 if v1 else torch.bfloat16)
            x = (torch.randn((M, d_in), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            x_lib = x.float() if v1 else x
            wrapper = (fn if v1 else qmv4.dequant_matmul_v4 if fmt else
                       getattr(qmatmul, qmatmul.V2_WRAPPERS[kernels[name]]))
            tiles[name] = tile_of(wrapper, lambda: fn(x, rql))
            out[name] = device_ms(lambda: fn(x, rql))
            if core and v1 and hasattr(qmatmul, "_launch_v1"):  # v1_kernel at any M
                off = {"mma": False}
                if "decode_mma" in inspect.signature(qmatmul._launch_v1).parameters:
                    off["decode_mma"] = False
                core_ms[name] = device_ms(lambda: qmatmul._launch_v1(x, rql, **off))
            elif core and M <= 8 and fmt and not v1 and hasattr(qmv4, "_launch_v4"):
                core_ms[name] = device_ms(lambda: qmv4._launch_v4(x, rql, False, False))
            elif core and M <= 8 and not fmt:
                lib, code = (qmatmul._PER_WEIGHT.get(kernels[name])
                             or ("qmatmul_v2m", qmatmul._GROUP_DOT[kernels[name]][0]))
                core_ms[name] = device_ms(lambda: qmatmul._launch_v2(
                    lib, code, x, rql, torch.bfloat16, 8))
            if probe and qmatmul._v2_route("v2g", torch.bfloat16)[4] <= M <= 8:
                for level, per_call in probe_ms.items():
                    per_call[name] = device_ms(lambda: qmatmul._launch_v2(
                        "qmatmul_v2g_probe", level, x, rql, torch.bfloat16,
                        *qmatmul._v2_route("v2g", torch.bfloat16)))
            if fmt and not v1:
                bare[name] = device_ms(lambda: fn(x, no_off))
                del no_off
            lib_ms[name] = device_ms(lambda: torch.matmul(x_lib, w))
            nbytes = rql.bytes_read + x.numel() * 2 + M * d_out * 4
            flop_s = F32_FLOP_PER_S if tiles[name] == "cuda_core" and v1 else BF16_FLOP_PER_S
            bound[name] = max(nbytes / HBM_BYTES_PER_S, 2.0 * M * d_in * d_out / flop_s) * 1e3
            del rql, x, x_lib, w
            torch.cuda.empty_cache()

        def forward(per_call):
            return sum(per_call[s[0]] * s[7] for s in SHAPES)

        rec = {"root": root, "variant": None if fmt else variant, "format": fmt, "M": M,
               "bm_max": bm or None, "flush": flush_mode, "kernel_per_call": kernels,
               "tile_per_call": tiles,
               "ms_per_call": out, "library_ms_per_call": lib_ms,
               "bound_ms_per_call": bound, "ms_per_forward": forward(out),
               "library_ms_per_forward": forward(lib_ms), "bound_ms_per_forward": forward(bound)}
        if bare:
            rec.update(no_offc_ms_per_call=bare, no_offc_ms_per_forward=forward(bare))
        if core_ms:
            rec.update(core_ms_per_call=core_ms, decode_blocks=decode_blocks or None,
                       decode_min_rows=decode_min_rows or None)
            if len(core_ms) == len(SHAPES):
                rec["core_ms_per_forward"] = forward(core_ms)
        if probe_ms[1]:
            rec.update(probe_ms_per_call=probe_ms,
                       probe_ms_per_forward={k: forward(v) for k, v in probe_ms.items()})
        print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--variant", default="v2g")
    ap.add_argument("--format", default="", choices=["", *FORMATS],
                    help="time the v4 or v1 kernel in this format instead of a v2 variant")
    ap.add_argument("--m", default="8", help="rows of x, or a comma list of row counts")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--bm", type=int, default=0, choices=[0, 32, 64, 128],
                    help="cap the tensor-core tiles' rows per block (0: the plan's own)")
    ap.add_argument("--core", action="store_true",
                    help="at M <= 8 (v1: any M) also time the CUDA-core tile")
    ap.add_argument("--decode-blocks", type=int, default=0,
                    help="the decode tile's split-K target in blocks per SM (0: the plan's)")
    ap.add_argument("--decode-min-rows", type=int, default=0,
                    help="the fewest rows routed to the decode tile (0: the route's own)")
    ap.add_argument("--probe", action="store_true",
                    help="at the decode tile's rows of v2g also time its timing probes")
    ap.add_argument("--libs", default="",
                    help="comma list of further kernel libraries to build and report ptxas for")
    ap.add_argument("--flush", default="write", choices=["write", "read"],
                    help="evict the L2 between calls by writing or by reading 64 MB")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one_root(args.one, args.variant, args.format, args.reps,
                 [int(m) for m in args.m.split(",")], args.bm, args.core, args.decode_blocks,
                 args.flush, args.probe, [x for x in args.libs.split(",") if x],
                 args.decode_min_rows)
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
                             "--reps", str(args.reps), "--bm", str(args.bm),
                             "--decode-blocks", str(args.decode_blocks), "--flush", args.flush,
                             "--libs", args.libs, "--decode-min-rows", str(args.decode_min_rows)]
                            + ["--core"] * args.core + ["--probe"] * args.probe).returncode
        if rc != 0:
            print(f"time_v2_kernels: root {root} failed ({rc})", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
