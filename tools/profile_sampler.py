#!/usr/bin/env python3
"""Device and host time of the port's sampler chain on one B=8 step.

    python3 tools/profile_sampler.py [--vocab 128256] [--reps 50]

On a CUDA card: (8, vocab) random f32 logits, eight rows of settings (those
of chip_smoke phase 9a), then for each piece of a sampled decode step
(``count_tokens``, ``_chain``, ``gumbel_noise``, ``sample``,
``count_tokens`` + ``sample_step``) the device ms per call (CUDA events
around 5 calls queued behind a device sleep) and the host ms per call (queued
back to back, one synchronize at the end); the host synchronizations one
step makes (``torch.cuda.set_sync_debug_mode("warn")``); and the device
time per operator of one step from torch.profiler. Prints the card's name
and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", type=int, default=128256)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_sampler: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from gptq_gguf_tpu_torch.serving import sampling

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    V = args.vocab
    rng = np.random.default_rng(0)
    logits = torch.as_tensor(rng.standard_normal((8, V)).astype(np.float32) * 3, device=dev)
    prompts = torch.as_tensor(rng.integers(0, V, size=(8, 65)), device=dev)
    st = cs.slot_states(cs.sampler_rows(), prompts, V, dev)
    toks = prompts[:, -1].to(torch.int32)

    def host_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        t_queue = time.perf_counter() - t
        torch.cuda.synchronize()
        return t_queue / reps * 1e3, (time.perf_counter() - t) / reps * 1e3

    pieces = {
        "count_tokens": lambda: sampling.count_tokens(st, toks),
        "_chain": lambda: sampling._chain(logits, st),
        "gumbel_noise": lambda: sampling.gumbel_noise(st.seeds, st.draws, st.vocab_hash),
        "sample": lambda: sampling.sample(logits, st),
        "step (count_tokens + sample_step)": lambda: (sampling.count_tokens(st, toks),
                                                      sampling.sample_step(logits, st)),
    }
    for name, fn in pieces.items():
        # up to ~100 launches a call: 5 calls stay within the card's launch
        # queue behind the sleep, so the events time the device
        dms = cs.cuda_ms(fn, 5, sleep_cycles=1_000_000_000)
        queue, wall = host_ms(fn, args.reps)
        print(f"{name:>36}: device {dms:.4f} ms, host queueing {queue:.4f} ms, "
              f"back to back {wall:.4f} ms per call", flush=True)

    step = pieces["step (count_tokens + sample_step)"]
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step()
    torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught]
    print(f"host synchronizations in one step: {len(syncs)} {syncs[:3]}", flush=True)

    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            step()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    key = "device_time_total" if hasattr(avg[0], "device_time_total") else "cuda_time_total"
    print(avg.table(sort_by=key, row_limit=15), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
