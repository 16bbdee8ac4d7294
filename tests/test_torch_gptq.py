"""The port's GPTQ solver against the JAX package on the CPU.

The same seeded numpy weights and Hessians go through
``gptq_gguf_tpu.ops.gptq`` and ``gptq_gguf_tpu_torch.ops.gptq``.
Tolerances: the block solve's err within 1e-6 relative plus
1e-6 * (bs / 128) ** 0.75 of max|err|. The gap is the rounding alone: JAX's
err equals, bit for bit, the plain recurrence with s * q - z and each
update rounded once as a fused multiply-add (the test checks it), while
the port rounds each product apart. That drift grows with the updates a
column takes: its median over 12 seeds grows 1.36-1.67x per doubling of the
block (``tools/gptq_solve_drift.py``), hence the exponent. Whole solves
hold JAX's own bar against the reference: objective within 1%, codes
agreeing in >= 99% (>= 97% under act_order)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptq_gguf_tpu.formats.ggml import GGMLQuantizationType as T
from gptq_gguf_tpu.ops import gptq as jg
from gptq_gguf_tpu.ops import kquant as jk
from gptq_gguf_tpu_torch.formats.ggml import KQUANT_SPECS
from gptq_gguf_tpu_torch.ops import gptq as tg
from gptq_gguf_tpu_torch.ops import kquant as tk

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from gptq_solve_drift import contracted_solve  # noqa: E402


def make_problem(seed, d_row=16, d_col=512, n=2048):
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(d_row, d_col)) * 0.08).astype(np.float32)
    A = rng.normal(size=(d_col, d_col)).astype(np.float32) / np.sqrt(d_col)
    A += 0.5 * np.eye(d_col, dtype=np.float32)
    X = rng.normal(size=(n, d_col)).astype(np.float32) @ A
    return W, X, (2.0 * X.T @ X / n).astype(np.float32)


def objective(W, W_hat, H):
    d = (W - W_hat).astype(np.float64)
    return float(np.trace(d @ H.astype(np.float64) @ d.T))


def test_accumulate_hessian_matches_jax():
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(2, 8, 64)).astype(np.float32) for _ in range(3)]
    Hj, nj = jg.init_hessian(64)
    Ht, nt = tg.init_hessian(64, device="cpu")
    for x in xs:
        Hj, nj = jg.accumulate_hessian(Hj, nj, jnp.asarray(x))
        Ht, nt = tg.accumulate_hessian(Ht, nt, torch.from_numpy(x))
    assert nt == float(nj) == 6
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("qtype,bs", [pytest.param(q, 128, id=q.name)
                                      for q in (T.Q4_K, T.Q6_K, T.Q3_K)]
                         + [pytest.param(q, 256, id=f"{q.name}-bs256")
                            for q in (T.Q4_K, T.Q6_K, T.Q3_K)])
def test_block_solve_matches_pallas_interpret(qtype, bs):
    """The plain block solve against the Pallas kernel in interpret mode,
    whose err is the contracted recurrence's bit for bit."""
    spec = KQUANT_SPECS[qtype]
    rng = np.random.default_rng(int(qtype))
    d_row = 64
    _, _, H = make_problem(int(qtype), d_col=bs, n=512)
    _, U, _ = jg.prepare_hessian_inverse(jnp.asarray(H), jnp.ones((1, bs)), 1e-2)
    U = np.asarray(U)
    w = (rng.normal(size=(d_row, bs)) * 0.05).astype(np.float32)
    s = rng.uniform(0.002, 0.01, size=(d_row, bs)).astype(np.float32)
    z = (0 if spec.signed else rng.uniform(0, 0.05, size=(d_row, bs))) * np.ones_like(s)
    qj, ej = jg._solve_block_pallas(jnp.asarray(w), jnp.asarray(U), jnp.asarray(s),
                                    jnp.asarray(z), qmin=spec.qmin, qmax=spec.qmax,
                                    eps=1e-9, interpret=True)
    qt, et = tg.solve_block(*(torch.from_numpy(np.array(a, np.float32))
                              for a in (w, U, s, z)), spec.qmin, spec.qmax, 1e-9)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(contracted_solve(w, U, s, z, spec.qmin, spec.qmax, 1e-9)[1],
                                  np.asarray(ej))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-6,
                               atol=1e-6 * (bs / 128) ** 0.75 * np.abs(np.asarray(ej)).max())


SOLVES = [(T.Q4_K, {}), (T.Q6_K, {}), (T.Q2_K, {}), (T.Q5_K, {"static_groups": True}),
          (T.Q4_K, {"act_order": True, "static_groups": True}),
          (T.Q6_K, {"act_order": True, "static_groups": True}),
          (T.Q3_K, {"act_order": True, "static_groups": True}),  # forced dynamic
          (T.Q4_K, {"block_size": 64}), (T.Q4_K, {"static_groups": True, "block_size": 0})]


@pytest.mark.parametrize("qtype,kw", SOLVES, ids=[f"{q.name}-{'-'.join(k) or 'default'}"
                                                  for q, k in SOLVES])
def test_gptq_quantize_matrix_matches_jax(qtype, kw):
    W, _, H = make_problem(11 + int(qtype), d_row=32)
    rj = jg.gptq_quantize_matrix(jnp.asarray(W), jnp.asarray(H), qtype, jg.GPTQConfig(**kw))
    rt = tg.gptq_quantize_matrix(W, H, qtype, tg.GPTQConfig(**kw), device="cpu")
    assert rt.qweight.dtype == (torch.int8 if KQUANT_SPECS[qtype].signed else torch.uint8)
    assert tuple(rt.qweight.shape) == W.shape and not rt.issue_non_invertible
    for a, b in zip(rj.params, rt.params):
        assert tuple(b.shape) == np.asarray(a).shape
    obj_j = objective(W, np.asarray(jk.dequantize(rj.qweight, rj.params, qtype)), H)
    obj_t = objective(W, tk.dequantize(rt.qweight, rt.params, qtype).numpy(), H)
    assert abs(obj_t - obj_j) <= 0.01 * obj_j, (obj_t, obj_j)
    agree = (rt.qweight.numpy().astype(np.int16) == np.asarray(rj.qweight).astype(np.int16)).mean()
    assert agree >= (0.97 if kw.get("act_order") and qtype != T.Q3_K else 0.99), agree


@pytest.mark.parametrize("qtype", [T.Q2_K, T.Q4_K, T.Q6_K], ids=lambda q: q.name)
def test_gptq_beats_rtn_on_correlated_data(qtype):
    W, _, H = make_problem(3, d_row=16)
    res = tg.gptq_quantize_matrix(W, H, qtype, device="cpu")
    w_gptq = tk.dequantize(res.qweight, res.params, qtype).numpy()
    w_rtn = tk.dequantize_rtn(torch.from_numpy(W), qtype).numpy()
    assert objective(W, w_gptq, H) < objective(W, w_rtn, H)


def test_identity_hessian_equals_rtn():
    W, _, _ = make_problem(4, d_row=8)
    res = tg.gptq_quantize_matrix(W, np.eye(512, dtype=np.float32), T.Q4_K, device="cpu")
    q, p = tk.quantize_rtn(torch.from_numpy(W), T.Q4_K)
    assert torch.equal(res.qweight, q) and torch.equal(res.params.super_scale, p.super_scale)


def test_singular_hessian_falls_back_to_identity():
    W = (np.random.default_rng(5).normal(size=(4, 256)) * 0.05).astype(np.float32)
    H = np.zeros((256, 256), np.float32)
    H[0, 0] = np.nan  # poison: the factorization is not finite
    for method in ("device", "host"):
        res = tg.gptq_quantize_matrix(W, H, T.Q4_K, factorize=method, device="cpu")
        assert res.issue_non_invertible
        assert torch.isfinite(res.params.super_scale.float()).all()


def test_host_and_device_factorizations_agree():
    _, _, H = make_problem(6, d_col=256)
    W, Hd = tg._mask_and_damp(torch.from_numpy(H), torch.ones(1, 256), 1e-2)
    Ud, bad_d = tg.factorize_hinv_cholesky(Hd, "device")
    Uh, bad_h = tg.factorize_hinv_cholesky(Hd, "host")
    assert not bad_d and not bad_h
    np.testing.assert_allclose(Ud.numpy(), Uh.numpy(), rtol=1e-4, atol=1e-5)
    # H^-1 = U^T U
    np.testing.assert_allclose((Ud.T @ Ud @ Hd).numpy(), np.eye(256), atol=2e-3)
    Uj, _ = jg.factorize_hinv_cholesky(jnp.asarray(Hd.numpy()), "device")
    np.testing.assert_allclose(Ud.numpy(), np.asarray(Uj), rtol=1e-4, atol=1e-5)


def test_mask_and_damp_matches_jax():
    W, _, H = make_problem(7, d_row=8, d_col=256)
    W[:, 3] = 0.0   # a dead column
    H[5, :] = H[:, 5] = 0.0  # a pruned channel
    Wj, Hj = jg._mask_and_damp(jnp.asarray(H), jnp.asarray(W), 1e-2)
    Wt, Ht = tg._mask_and_damp(torch.from_numpy(H), torch.from_numpy(W), 1e-2)
    np.testing.assert_array_equal(Wt.numpy(), np.asarray(Wj))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-6, atol=1e-7)


def test_act_order_without_static_groups_raises():
    W, _, H = make_problem(8, d_row=4, d_col=256)
    with pytest.raises(ValueError, match="static_groups"):
        tg.gptq_quantize_matrix(W, H, T.Q4_K, tg.GPTQConfig(act_order=True), device="cpu")
