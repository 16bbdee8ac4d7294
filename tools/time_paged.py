#!/usr/bin/env python3
"""Time the paged flash-decode kernels on the card, for one or more
checkouts of the repository, each in a process of its own.

    python3 tools/time_paged.py [--reps 50] [--splits N[,...]] [--fills F[,...]]
                                [--no-flush] [--profile] [ROOT ...]   (default: this checkout)

Roots run in the order given (pass A B B A to compare two trees within one
run). Each root times ``paged_flash_decode`` (bf16 pools) and
``paged_flash_decode_q4`` (combined int4 pools) at the Llama-3-8B attention
shape (8 kv heads, 4 query heads each, hd 128, page 64, a pool of 256 pages
made on the card from a seed, as ``chip_smoke.py`` phase 6a makes it) over
B = 8 slots at fill 300, at fill 1900 and at chip_smoke's mixed
PAGED_LENGTHS (0-2047) (``--fills``), through ``chip_smoke.paged_times`` of this
checkout: device ms per call from CUDA events around each call, the L2
cache flushed outside them (``--no-flush`` leaves it warm), beside the plain version, the library
yardstick (one SDPA call on the live K / V already gathered, bf16) and
the bound (the attended positions' bytes over 3.35 TB/s; f32 operations
over 67 TFLOP/s are smaller), and ``stream_ms``: one ``torch.amax`` over a
bf16 buffer of the call's bytes (up to 64 MB), timed the same way, for the
read rate this protocol leaves (the flush is a 64 MB memset whose dirty
lines the next reads write back). ``--splits`` fixes the number of page
ranges per slot in place of the wrapper's plan (0 keeps the plan; a root
without a plan, the design before the split, says so in its record); a
comma list times every setting in turn on the same pools and tables.
``--profile`` adds each call's device µs per kernel from torch.profiler.
Prints, per root, the
ptxas report of the paged library (registers, spills per kernel), then
one JSON line per pool type and setting: ms per call by fill, and per
32-layer decode step. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

TOOL_ROOT = Path(__file__).resolve().parents[1]


def chip_smoke():
    """This checkout's chip_smoke.py (its helpers import the package of
    whichever root is first on sys.path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_for_time_paged",
                                                  TOOL_ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_profile(call, reps: int, flush) -> dict:
    """{device kernel name: mean µs per call} of ``reps`` calls under
    torch.profiler, L2 flushed before each (the flush's own kernel left out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "elementwise" not in e.name \
                and "fill" not in e.name.lower():
            out[e.name[:60]] = out.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / reps
    return out


def one_root(root: str, reps: int, splits: list, fills: list, flush_l2: bool,
             profile: bool) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from gptq_gguf_tpu_torch.ops import cuda_build, paged_attention as pa
    from time_v2_kernels import ptxas_report

    cs = chip_smoke()
    dev = torch.device("cuda")
    own_plan = getattr(pa, "_split_plan", None)

    def set_splits(n_split):
        """Fix n_split page ranges per slot (0: the wrapper's own plan) where
        the root has a plan; returns the setting as the record shows it."""
        if own_plan is None:
            return {"splits": "not in this root"} if n_split else {}
        if not n_split:
            pa._split_plan = own_plan
            return {"splits": "plan"}

        def plan(B, nKV, pps, page, n_sm):
            per = -(-pps // n_split)
            return -(-pps // per), per

        pa._split_plan = plan
        return {"splits": n_split}

    nvcc_log = cuda_build.build("paged_decode")
    saved = cuda_build.library_path("paged_decode").with_suffix(".log")
    nvcc_log = nvcc_log or (saved.read_text() if saved.exists() else None)
    print(json.dumps({"root": root, "library": "paged_decode",
                      "ptxas": ptxas_report(nvcc_log) if nvcc_log else "cached"}), flush=True)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_ if flush_l2 else None
    stream_buf = torch.ones(32 << 20, dtype=torch.bfloat16, device=dev)
    fills = {f: list(cs.PAGED_LENGTHS) if f == "mixed" else [int(f)] * 8 for f in fills}
    for q4 in (False, True):
        gen = torch.Generator(device=dev)
        gen.manual_seed(cs.SEED)
        q = torch.randn((8, cs.N_KV, cs.N_HEAD // cs.N_KV, cs.HD), generator=gen, device=dev)
        kp, vp = cs.paged_pools(q4, dev)
        fn = pa.paged_flash_decode_q4 if q4 else pa.paged_flash_decode
        ref = pa.paged_flash_decode_q4_reference if q4 else pa.paged_flash_decode_reference
        for n_split in splits:
            knobs = set_splits(n_split)
            rng = np.random.default_rng(cs.SEED)  # the same tables for every setting
            recs = {label: cs.paged_times(fn, ref, kp, vp, q, f, q4, rng, flush, reps)
                    for label, f in fills.items()}
            for r in recs.values():  # a plain read of the call's bytes, the same protocol
                n = min(r["bytes"] // 2, stream_buf.numel())
                r["stream_ms"] = cs.cuda_ms(lambda: torch.amax(stream_buf[:n]), reps, flush)
            if profile:
                for label, f in fills.items():
                    ln = torch.as_tensor(f, dtype=torch.int32, device=dev)
                    args = (q, kp, vp, cs.paged_table(rng, f, dev), ln)
                    recs[label]["kernels_us"] = kernel_profile(
                        lambda: fn(*args, scale=cs.HD ** -0.5), reps, flush)
            per_step = {label: {k: r[k] * cs.N_LAYERS for k in ("ms", "library_ms", "bound_ms")}
                        for label, r in recs.items()}
            print(json.dumps({"root": root, "pools": "int4" if q4 else "bf16", **knobs,
                              "per_call": recs, "per_step": per_step}), flush=True)
        del kp, vp
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--splits", default="0",
                    help="page ranges per slot, or a comma list (0: the wrapper's plan)")
    ap.add_argument("--fills", default="300,1900,mixed",
                    help="uniform fills of the 8 slots, or mixed (PAGED_LENGTHS), comma list")
    ap.add_argument("--no-flush", action="store_true", help="leave L2 warm between calls")
    ap.add_argument("--profile", action="store_true",
                    help="also device µs per kernel of each call (torch.profiler)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one_root(args.one, args.reps, [int(n) for n in args.splits.split(",")],
                 args.fills.split(","), not args.no_flush, args.profile)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_paged: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    for root in args.roots:
        rc = subprocess.run([sys.executable, __file__, "--one", root, "--reps", str(args.reps),
                             "--splits", args.splits, "--fills", args.fills]
                            + ["--no-flush"] * args.no_flush
                            + ["--profile"] * args.profile).returncode
        if rc != 0:
            print(f"time_paged: root {root} failed ({rc})", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
