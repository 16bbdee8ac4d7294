#!/usr/bin/env python3
"""How far the GPTQ block solve's err moves when its roundings are
contracted into fused multiply-adds, by block width, on the CPU.

    python3 tools/gptq_solve_drift.py [--seeds 12] [--bs 64,128,256,512]

The JAX package's Pallas solve kernel, run in interpret mode on the CPU,
gives the err of the plain recurrence with ``s * q - z`` and each update
``w - err * U`` rounded once, as a fused multiply-add: ``contracted_solve``
below, which ``tests/test_torch_gptq.py::test_block_solve_matches_pallas_interpret``
holds equal to it bit for bit. The port's plain version,
``gptq.solve_block_reference``, rounds each product and difference apart.
For each type (Q4_K, Q6_K, Q3_K), block width and seed, on inputs drawn
as that test draws them (64 rows; seed 0 is the test's own draw, with U
factorized by the port instead of JAX), the tool takes the least c for
which every err element satisfies

    |plain - contracted| <= 1e-6 |contracted| + c * 1e-6 * max|contracted|

(the test's tolerance, c its atol coefficient), and prints per type and
width the median and maximum of c over the seeds, and per type the
medians' growth per doubling of the width. A seed whose codes differ
between the two is counted and left out. numpy and the port only; no card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def contracted_solve(w, u, s, z, qmin, qmax, eps):
    """(q, err) of the block solve with ``s * q - z`` and ``w - err * U``
    each rounded once (the f32 product is exact in f64; the f64 sum is
    rounded to f32), every other step as ``solve_block_reference``
    takes it. numpy arrays in, taken as f32; f32 arrays out."""
    w = np.array(w, np.float32)
    u, s, z = (np.asarray(a, np.float32) for a in (u, s, z))
    d_row, bs = w.shape
    q = np.empty_like(w)
    err = np.empty_like(w)
    for i in range(bs):
        col, si, zi = w[:, i].copy(), s[:, i], z[:, i]
        qi = np.clip(np.round((col + zi) / np.maximum(si, np.float32(eps))),
                     qmin, qmax).astype(np.float32)
        wq = (si.astype(np.float64) * qi - zi).astype(np.float32)
        e = (col - wq) / u[i, i]
        w[:, i + 1:] = (w[:, i + 1:] - e[:, None].astype(np.float64) * u[i, i + 1:]
                        ).astype(np.float32)
        q[:, i], err[:, i] = qi, e
    return q, err


def solve_problem(seed: int, bs: int, signed: bool, d_row: int = 64, n: int = 512):
    """w, U, s, z of one block as the test draws them."""
    import torch

    from gptq_gguf_tpu_torch.ops import gptq

    rng = np.random.default_rng(seed)
    rng.normal(size=(16, bs))  # the test's make_problem draws its (unused here) W first
    A = rng.normal(size=(bs, bs)).astype(np.float32) / np.sqrt(bs)
    A += 0.5 * np.eye(bs, dtype=np.float32)
    X = rng.normal(size=(n, bs)).astype(np.float32) @ A
    H = (2.0 * X.T @ X / n).astype(np.float32)
    _, U, _ = gptq.prepare_hessian_inverse(torch.from_numpy(H), torch.ones(1, bs), 1e-2)
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(d_row, bs)) * 0.05).astype(np.float32)
    s = rng.uniform(0.002, 0.01, size=(d_row, bs)).astype(np.float32)
    z = (0 if signed else rng.uniform(0, 0.05, size=(d_row, bs))) * np.ones_like(s)
    return w, U.numpy(), s, z.astype(np.float32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--bs", default="64,128,256,512")
    args = ap.parse_args()
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import KQUANT_SPECS, GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.ops import gptq

    widths = [int(b) for b in args.bs.split(",")]
    for qtype in (T.Q4_K, T.Q6_K, T.Q3_K):
        spec = KQUANT_SPECS[qtype]
        medians = []
        for bs in widths:
            cs, flips = [], 0
            for k in range(args.seeds):
                w, U, s, z = solve_problem(1000 * k + int(qtype), bs, spec.signed)
                qc, ec = contracted_solve(w, U, s, z, spec.qmin, spec.qmax, 1e-9)
                qp, ep = gptq.solve_block_reference(
                    *(torch.from_numpy(a) for a in (w, U, s, z)), spec.qmin, spec.qmax, 1e-9)
                if not np.array_equal(qp.numpy(), qc):
                    flips += 1
                    continue
                gap = np.abs(ep.numpy() - ec) - 1e-6 * np.abs(ec)
                cs.append(gap.clip(0).max() / np.abs(ec).max() * 1e6)
            medians.append(float(np.median(cs)))
            print(f"{qtype.name} bs {bs}: c median {medians[-1]:.3f}, max {max(cs):.3f} "
                  f"over {len(cs)} seeds ({flips} with other codes)", flush=True)
        growth = [b / a for a, b in zip(medians, medians[1:])]
        print(f"{qtype.name}: median c grows by " + ", ".join(f"{g:.2f}" for g in growth)
              + " per doubling", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
