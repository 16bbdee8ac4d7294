#!/usr/bin/env python3
"""Where the time of one B=8 greedy decode step goes, on the card, for the
paged and the contiguous engine at Llama-3-8B width.

    python3 tools/profile_decode_step.py [--fills 300 1900] [--steps 8]
                                         [--format v2|v4|v4-i8] [--root DIR]

Builds chip_smoke.py's 32-layer synthetic Q4_K serving weights (seed 7;
with ``--format v4`` or ``v4-i8`` converted on the card to that runtime
format by chip_smoke.format_params, f32 scales), from the checkout
``--root`` (this one by default: pass a parent tree's directory to
profile its package, in turns with this one),
fills every slot of a fully provisioned cache to a uniform fill (the fill
is reset before each step, so it stays put), and for each engine and fill
reports:
- host ms per step: host clock around STEPS steps ended by a synchronise,
  no profiler attached;
- device busy ms per step: the sum of the card's kernel and copy times
  under torch.profiler, and the idle share: 1 - busy / host ms of the
  unprofiled step, and 1 - busy / window of the profiled one (the window
  runs from the first to the last device activity; the profiler slows
  the host);
- the kernels with the most device time, with launches per step, and the
  sums per family: the paged attention kernels (paged engine), the
  tensor-core decode tile of v2g or v4 (``decode_mma_kernel``), the
  CUDA-core decode tiles (``v2_weight_kernel``, ``v4_kernel``) and the
  split-K reduction; beside them the decode tile's launches per step as
  the format's wrapper counts them (``decode_mma_launches``, in a tree
  that has it).
Needs one CUDA card; fails if the profiler records no device activity.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def step_functions(params, cfg, fill: int, device):
    """{"paged": fn, "contiguous": fn}: one decode step each at ``fill``."""
    import torch

    from gptq_gguf_tpu_torch.serving import engine, model as qmodel, paged

    B, max_len, page = 8, 2048, 64
    lengths = torch.full((B,), fill, dtype=torch.int32, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (B,), dtype=torch.int32, device=device)
    pcache = paged.init_paged_cache(cfg, B, max_len, page, device=device)
    pcache.page_table.copy_(torch.arange(pcache.n_pages, dtype=torch.int32,
                                         device=device).reshape(B, -1))
    ccache = qmodel.init_cache(cfg, B, max_len, device=device)

    def paged_step():
        engine._paged_decode_step(params, cfg, tokens, pcache._replace(lengths=lengths.clone()))

    def contiguous_step():
        engine._decode_step(params, cfg, tokens, ccache._replace(lengths=lengths.clone()), fill)

    return {"paged": paged_step, "contiguous": contiguous_step}


def profile(fn, steps: int):
    """(busy ms per step, idle share, {kernel name: (ms, launches) per step})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    window = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / steps
        by_name[e.name][1] += 1
    return busy / steps, 1.0 - busy / window, {k: (v[0], v[1] / steps) for k, v in
                                               by_name.items()}


# kernel families summed per step: label, a piece of the kernel's name
FAMILIES = (("tensor-core decode tile (v2g, v4)", "decode_mma_kernel"),
            ("CUDA-core decode tiles (v2)", "v2_weight_kernel"),
            ("CUDA-core decode tiles (v4)", "v4_kernel"),
            ("split-K reduction", "reduce_splits_kernel"))


def decode_launches(fn, fmt: str):
    """The format's tensor-core decode-tile launches in one step (None in
    a tree without that tile)."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul, qmv4

    wrapper = qmatmul.dequant_matmul_v2g if fmt == "v2" else qmv4.dequant_matmul_v4
    if not hasattr(wrapper, "decode_mma_launches"):
        return None
    n0 = wrapper.decode_mma_launches
    fn()
    torch.cuda.synchronize()
    return wrapper.decode_mma_launches - n0


def host_ms(fn, steps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / steps * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fills", type=int, nargs="+", default=[300, 1900])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--format", default="v2", choices=["v2", "v4", "v4-i8"],
                    help="the runtime format of the weights (v2: v2g, the default)")
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose package and chip_smoke.py are profiled")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_decode_step: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    params, cfg = chip_smoke.build_8b(np.random.default_rng(chip_smoke.SEED), device)
    if args.format != "v2":
        params = chip_smoke.format_params(params, args.format.replace("-", " "))
        torch.cuda.empty_cache()
    print(f"root {args.root}, format {args.format}", flush=True)
    for fill in args.fills:
        for name, fn in step_functions(params, cfg, fill, device).items():
            wall = host_ms(fn, args.steps)
            busy, idle, kernels = profile(fn, args.steps)
            print(f"{name} fill {fill}: host {wall:.2f} ms/step; device busy {busy:.2f} "
                  f"ms/step (idle share {1 - busy / wall:.3f} of the unprofiled step, "
                  f"{idle:.3f} of the profiled window); "
                  f"{sum(n for _, n in kernels.values()):.0f} device activities per step",
                  flush=True)
            for k, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
                print(f"    {ms:8.3f} ms  x{n:5.0f}  {k[:110]}", flush=True)
            paged = {k: v for k, v in kernels.items() if "::paged_" in k}
            if paged:
                print(f"    paged attention: {sum(ms for ms, _ in paged.values()):.3f} ms per "
                      f"step in {sum(n for _, n in paged.values()):.0f} launches "
                      f"({', '.join(sorted({k.split('<')[0].split('::')[-1] for k in paged}))})",
                      flush=True)
            for label, key in FAMILIES:
                fam = [v for k, v in kernels.items() if key in k]
                if fam:
                    print(f"    {label}: {sum(ms for ms, _ in fam):.3f} ms per step in "
                          f"{sum(n for _, n in fam):.0f} launches", flush=True)
            print(f"    {args.format} decode-tile launches per step (wrapper count): "
                  f"{decode_launches(fn, args.format)}", flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
