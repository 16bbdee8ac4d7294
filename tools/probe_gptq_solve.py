#!/usr/bin/env python3
"""Timing probes of the GPTQ solve kernel: where its time goes.

    python3 tools/probe_gptq_solve.py [--reps 30]

Builds copies of ``ops/csrc/gptq_solve.cu``, each with one part removed or
instrumented by a text edit (into ``ops/csrc/_build/probe/``, which git
ignores), and times each with CUDA events at the block shapes the 8B walk
gives the kernel. The probes' results are wrong by design; only ``full``
and ``count`` compute the kernel's function. The edits match the source's
text exactly, so the probe tracks one version of ``gptq_solve.cu`` (the
one whose breakdown PERF.md gives): after an edit to the kernel, a probe
whose text is gone raises, and its edit has to follow the source.

- ``full``: the source as it is;
- ``empty``: the kernel returns at once (the launch and timing floor);
- ``noloop``: no column loop (loads, staging of U, stores: the skeleton);
- ``noshfl``: the owner's err not broadcast (each lane uses its own);
- ``noredo``: the exact pass never taken (what its range tracking costs);
- ``count``: the source plus a counter of exact passes (printed).

Inputs: w ~ N(0, 0.02), s ~ U(0.002, 0.01), z ~ U(0, 0.05), U the upper
Cholesky factor of a seeded SPD matrix, made on the card from a seed.
The kernel picks its lanes per row by the rows (8 below 16384, 4 from
there), so the shapes reach both instances. Prints the card's name and
power limit, each probe's ptxas registers and spill stores per instance,
then one JSON line per shape: us per call by probe. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

RETRY = "      if (__syncthreads_or(redo)) continue;"
EDITS = {
    "full": [],
    "empty": [("  using S = Shape<L>;\n  constexpr int K = S::K, RW = S::RW, PITCH = S::PITCH;",
               "  if (bs > 0) return;\n  using S = Shape<L>;\n"
               "  constexpr int K = S::K, RW = S::RW, PITCH = S::PITCH;")],
    "noloop": [("for (int ki = 0; ki < K; ++ki) {\n    const float si = s_next",
                "for (int ki = 0; ki < 0; ++ki) {\n    const float si = s_next")],
    "noshfl": [("const float e = __shfl_sync(0xffffffffu, kExact ? __fdiv_rn(a2, d) : "
                "div_fast(a2, d, rd),\n                                  li, L);",
                "const float e = kExact ? __fdiv_rn(a2, d) : div_fast(a2, d, rd);")],
    "noredo": [(RETRY, "      if (__syncthreads_or(false)) continue;")],
    "count": [(RETRY, "      if (__syncthreads_or(redo)) {\n"
                      "        if (threadIdx.x == 0) atomicAdd(&g_redo, 1);\n"
                      "        continue;\n      }"),
              ("namespace {\n", "__device__ int g_redo;\n"
                                "extern \"C\" int probe_redo() {\n  int h = 0;\n"
                                "  cudaMemcpyFromSymbol(&h, g_redo, sizeof h);\n  return h;\n}\n"
                                "namespace {\n")],
}
# (rows, block columns): 8 lanes a row, 8 at a wide block, 4
CASES = ((4096, 128), (4096, 512), (28672, 128))


def build(cuda_build, name: str) -> str:
    """Compile the probe ``name``; returns its ptxas summary."""
    src = (cuda_build.CSRC / "gptq_solve.cu").read_text()
    for old, new in EDITS[name]:
        if old not in src:
            raise RuntimeError(f"probe {name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    out = cuda_build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", f"lib{name}.so", f"{name}.cu"]
    proc = subprocess.run(cmd, cwd=out, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for probe {name}:\n{proc.stdout}{proc.stderr}")
    log = proc.stdout + proc.stderr
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return f"{name}: registers {regs}, spill stores {spills}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_gptq_solve: CUDA is not available", file=sys.stderr)
        return 1
    from gptq_gguf_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    with ThreadPoolExecutor(len(EDITS)) as ex:  # one nvcc per probe, all at once
        for line in ex.map(lambda n: build(cuda_build, n), EDITS):
            print(line, flush=True)
    libs = {n: ctypes.CDLL(str(cuda_build.BUILD_DIR / "probe" / f"lib{n}.so")) for n in EDITS}
    for lib in libs.values():
        lib.gg_gptq_solve_block.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                                            + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    libs["count"].probe_redo.restype = ctypes.c_int
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for d_row, bs in CASES:
        w = torch.randn(d_row, bs, device=dev, generator=gen) * 0.02
        A = torch.randn(bs, 4 * bs, device=dev, generator=gen)
        U = torch.linalg.cholesky(A @ A.T / (4 * bs) + 0.1 * torch.eye(bs, device=dev)).T
        U = U.contiguous()
        s = torch.rand(d_row, bs, device=dev, generator=gen) * 0.008 + 0.002
        z = torch.rand(d_row, bs, device=dev, generator=gen) * 0.05
        q, e = torch.empty_like(w), torch.empty_like(w)
        us = {}
        passes0 = libs["count"].probe_redo()
        for name, lib in libs.items():
            def call():
                rc = lib.gg_gptq_solve_block(w.data_ptr(), U.data_ptr(), s.data_ptr(),
                                             z.data_ptr(), q.data_ptr(), e.data_ptr(), d_row, bs,
                                             0.0, 15.0, 1e-9, stream)
                if rc != 0:
                    raise RuntimeError(f"probe {name}: CUDA error {rc}")

            for _ in range(3):
                call()
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)  # the card waits while the host queues every call
            events = []
            for _ in range(args.reps):
                flush.zero_()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                call()
                b.record()
                events.append((a, b))
            torch.cuda.synchronize()
            us[name] = sum(a.elapsed_time(b) for a, b in events) / args.reps * 1e3
        passes = (libs["count"].probe_redo() - passes0) / (3 + args.reps)
        print(json.dumps({"d_row": d_row, "bs": bs, "lanes": 4 if d_row >= 16384 else 8,
                          "us_per_call": us,
                          "exact_passes_per_call": passes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
