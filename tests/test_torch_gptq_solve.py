"""The GPTQ solve kernel's schedule, replayed in PyTorch f32 on the CPU.

``ops/csrc/gptq_solve.cu`` does not run the plain version's loop as it is
written: it spreads each row over L lanes (lane l holds the panel columns
l + L k in registers), solves 128 columns at a time, pads a last partial
panel with columns that never reach a real one, and brings each panel's
columns up to date left-looking, from the errs of every earlier column,
before it solves them. ``kernel_schedule`` below performs the kernel's IEEE
f32 operations in the kernel's order and layout; it has to equal
``solve_block_reference`` bit for bit, which holds the ordering argument
(every w[r, j] takes its updates err[r, i] * U[i, j] in ascending i, each a
rounded product and a rounded difference) where no card is present. A
control, the same schedule with the left-looking updates in descending
order, must differ."""

import numpy as np
import pytest
import torch

from gptq_gguf_tpu_torch.formats.ggml import KQUANT_SPECS, GGMLQuantizationType as T
from gptq_gguf_tpu_torch.ops import gptq

PANEL = 128


def kernel_schedule(w, u, s, z, qmin, qmax, eps, lanes, descending=False):
    """(q, err) of one block solve in the kernel's order: the panels, the
    lane-interleaved registers, the identity padding. ``descending`` runs the
    left-looking updates in the wrong order (the control)."""
    d_row, bs = w.shape
    n = -(-bs // PANEL) * PANEL
    K = PANEL // lanes
    # the kernel's padding: w 0, s 1, z 0 and U the identity past bs
    wp = torch.zeros(d_row, n)
    sp = torch.ones(d_row, n)
    zp = torch.zeros(d_row, n)
    up = torch.eye(n)
    wp[:, :bs], sp[:, :bs], zp[:, :bs], up[:bs, :bs] = w, s, z, u
    qp, ep = torch.empty(d_row, n), torch.empty(d_row, n)
    lane_col = torch.arange(lanes)[:, None] + lanes * torch.arange(K)[None, :]  # (L, K)

    def column_order(regs):  # (d_row, L, K) registers -> (d_row, PANEL) columns
        return regs.transpose(1, 2).reshape(d_row, PANEL)

    for c0 in range(0, n, PANEL):
        cols = c0 + lane_col
        wr = wp[:, cols].clone()
        starts = list(range(0, c0, PANEL))
        for i0 in reversed(starts) if descending else starts:
            tile = up[i0:i0 + PANEL][:, cols]  # (PANEL, L, K)
            for ii in reversed(range(PANEL)) if descending else range(PANEL):
                wr -= ep[:, i0 + ii, None, None] * tile[ii]
        sr, zr = sp[:, cols].clone(), zp[:, cols]
        ud = up[c0:c0 + PANEL][:, cols]
        for i in range(PANEL):
            ki, li = divmod(i, lanes)
            col, si, zi = wr[:, li, ki].clone(), sr[:, li, ki].clone(), zr[:, li, ki]
            qi = torch.clamp(torch.round((col + zi) / torch.clamp_min(si, eps)), qmin, qmax)
            e = (col - (si * qi - zi)) / up[c0 + i, c0 + i]
            wr[:, :, ki + 1:] -= e[:, None, None] * ud[i, :, ki + 1:]  # every lane
            wr[:, li + 1:, ki] -= e[:, None] * ud[i, li + 1:, ki]  # lanes past the owner
            wr[:, li, ki], sr[:, li, ki] = e, qi  # the owner keeps err and q
        ep[:, c0:c0 + PANEL] = column_order(wr)
        qp[:, c0:c0 + PANEL] = column_order(sr)
    return qp[:, :bs], ep[:, :bs]


def solve_inputs(d_row, bs, qtype, seed):
    """w, U (the upper factor of a seeded SPD matrix's inverse), s, z and
    the type's code range for one block."""
    spec = KQUANT_SPECS[qtype]
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(bs, 4 * bs))
    Hm = torch.from_numpy(A @ A.T / (4 * bs) + 0.1 * np.eye(bs))
    Ur = torch.linalg.cholesky(Hm.flip(0, 1)).flip(0, 1)
    U = torch.linalg.solve_triangular(Ur, torch.eye(bs, dtype=torch.float64), upper=True)
    w = rng.normal(size=(d_row, bs)) * 0.05
    s = rng.uniform(0.002, 0.01, size=(d_row, bs))
    z = np.zeros_like(s) if spec.signed else rng.uniform(0, 0.05, size=(d_row, bs))
    return [torch.as_tensor(a, dtype=torch.float32).contiguous()
            for a in (w, U, s, z)] + [spec.qmin, spec.qmax, 1e-9]


@pytest.mark.parametrize("lanes", [4, 8])
@pytest.mark.parametrize("qtype", [T.Q3_K, T.Q4_K, T.Q6_K], ids=lambda q: q.name)
@pytest.mark.parametrize("bs", [32, 128, 200, 256, 512])
def test_kernel_schedule_equals_plain_bit_for_bit(bs, qtype, lanes):
    args = solve_inputs(24, bs, qtype, bs + int(qtype))
    qk, ek = kernel_schedule(*args, lanes=lanes)
    qp, ep = gptq.solve_block_reference(*args)
    assert torch.equal(qk, qp) and torch.equal(ek, ep)


@pytest.mark.parametrize("qtype", [T.Q3_K, T.Q4_K, T.Q6_K], ids=lambda q: q.name)
def test_kernel_schedule_control_descending_updates_differ(qtype):
    args = solve_inputs(24, 512, qtype, 7)
    _, ep = gptq.solve_block_reference(*args)
    _, ek = kernel_schedule(*args, lanes=8)
    _, ed = kernel_schedule(*args, lanes=8, descending=True)
    assert torch.equal(ek, ep) and not torch.equal(ed, ep)
