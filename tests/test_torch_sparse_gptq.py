"""The port's FastOBQ / FastOBC / OWL solvers and ladders against the JAX
package's, on the CPU.

JAX's solvers are XLA programs; XLA contracts ``wb - err * u`` and ``col -
scale * (q - zero)`` into fused multiply-adds and multiplies by the
reciprocal of the constant maxq, and the port repeats both
(``ops/sparse_gptq.py``). Bounds:
- ``simple_find_params`` and ``_flat_quantize``: bit-equal (both divide);
- the stacked solvers given JAX's own (W_masked, U): codes, scales, zeros,
  dequantized weights and pruned weights bit-equal, at every level of a
  ladder, sym and asym, per channel and per group;
- through the public API each package factorizes its own U (their f32
  Cholesky and triangular solves round differently), so codes and masks are
  held to at least 99.9% equal over 5 seeds, and each level's
  ``relative_layer_error`` within a relative 1e-3 of JAX's (a flip at a
  rounding tie moves the rest of its row, so they are not bit-equal);
- ``owl_*``, ``relative_layer_error``: a relative 1e-5 (f32 sums in
  another order); ``owl_sparsity_distribution`` is the same numpy;
- the ladders and ``estimate-errors`` on a tiny llama: the same files, the
  values as above (the walks' Hessians differ in the order of f32 sums;
  each test says how it holds them).

JAX's ``fast_obq_quantize`` returns its codes in a scrambled order when W
has more than one block (``qblks`` of shape (n_blocks, bs, d_row) swapped
to (bs, n_blocks, d_row) and reshaped to (d_row, d_col)): a fault of the
reference that its ladders never read (they save the dequantized weights).
The port returns codes in column order; the tests unscramble JAX's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptq_gguf_tpu.ops import gptq as jg
from gptq_gguf_tpu.ops import sparse_gptq as js
from gptq_gguf_tpu_torch.ops import sparse_gptq as ts

SEEDS = (0, 1, 2, 3, 4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_problem(seed, d_row=64, d_col=256, n=1024):
    """(W, H) of a correlated input, as tests/test_gptq.py::make_problem."""
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(d_row, d_col)) * 0.08).astype(np.float32)
    A = rng.normal(size=(d_col, d_col)).astype(np.float32) / np.sqrt(d_col)
    A += 0.5 * np.eye(d_col, dtype=np.float32)
    X = rng.normal(size=(n, d_col)).astype(np.float32) @ A
    return W, (2.0 * X.T @ X / n).astype(np.float32)


def unscramble(qj, bs):
    """JAX's codes back in column order (see the module docstring)."""
    qj = np.asarray(qj)
    d_row, d_col = qj.shape
    return np.transpose(qj.reshape(bs, d_col // bs, d_row), (2, 1, 0)).reshape(d_row, d_col)


def rel_err(W, w_hat, H):
    return float(ts.relative_layer_error(torch.as_tensor(W), torch.as_tensor(w_hat),
                                         torch.as_tensor(H)))


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_simple_find_params_and_flat_quantize_bit_equal(bits, sym):
    rng = np.random.default_rng(bits)
    x = (rng.normal(size=(48, 128)) * 0.1).astype(np.float32)
    x[3] = 0.25  # a degenerate row
    pj = js.simple_find_params(jnp.asarray(x), bits, sym)
    pt = ts.simple_find_params(torch.from_numpy(x), bits, sym)
    np.testing.assert_array_equal(pt.scale.numpy(), np.asarray(pj.scale))
    np.testing.assert_array_equal(pt.zero.numpy(), np.asarray(pj.zero))
    qj, wj = js._flat_quantize(jnp.asarray(x), pj.scale[:, None], pj.zero[:, None], 2**bits - 1)
    qt, wt = ts._flat_quantize(torch.from_numpy(x), pt.scale[:, None], pt.zero[:, None],
                               float(2**bits - 1))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


@pytest.mark.parametrize("gs", [256, 128, 64], ids=["per_channel", "g128", "g64"])
@pytest.mark.parametrize("sym", [False, True])
def test_stacked_obq_bit_equal_given_jax_factor(sym, gs):
    """Every bit width's rows in one column loop give JAX's single-level
    programs' results bit for bit, on JAX's (W_masked, U)."""
    W, H = make_problem(7)
    W32, U, _ = jg.prepare_hessian_inverse(jnp.asarray(H), jnp.asarray(W), 1e-2)
    bits = (3, 8)
    d_row = W.shape[0]
    maxq = torch.tensor([2.0 ** b - 1 for b in bits]).repeat_interleave(d_row)
    codes, scale, zero, w_hat = ts._stacked_fast_obq(
        torch.from_numpy(np.array(W32)).repeat(len(bits), 1), torch.from_numpy(np.array(U)),
        maxq, sym, gs, 128)
    for k, b in enumerate(bits):
        rows = slice(k * d_row, (k + 1) * d_row)
        qj, pj, wj = js._fast_obq_single(W32, U, b, sym, gs, 128)
        np.testing.assert_array_equal(codes[rows].numpy(), unscramble(qj, min(128, gs)))
        np.testing.assert_array_equal(scale[rows].numpy(), np.asarray(pj.scale))
        np.testing.assert_array_equal(zero[rows].numpy(), np.asarray(pj.zero))
        np.testing.assert_array_equal(w_hat[rows].numpy(), np.asarray(wj))


def test_stacked_obc_bit_equal_given_jax_factor():
    W, H = make_problem(8)
    W32, U, _ = jg.prepare_hessian_inverse(jnp.asarray(H), jnp.asarray(W), 1e-2)
    sparsities = (0.25, 0.5, 0.7)
    d_row = W.shape[0]
    chunks = [(k * d_row, (k + 1) * d_row, s) for k, s in enumerate(sparsities)]
    stats = []
    w = ts._stacked_fast_obc(torch.from_numpy(np.array(W32)).repeat(3, 1),
                             torch.from_numpy(np.array(U)), chunks, 128, stats)
    for k, s in enumerate(sparsities):
        wj = js._fast_obc_single(W32, U, jnp.float32(s), 128)
        np.testing.assert_array_equal(w[k * d_row:(k + 1) * d_row].numpy(), np.asarray(wj))
    # every block of every level prunes what its threshold says, and those
    # entries stay exactly 0 through the later blocks' updates
    assert len(stats) == 3 * 2
    for ci, blk, k, n_pruned in stats:
        r0, r1, s = chunks[ci]
        n_pruned = int(n_pruned)
        zeros = int((w[r0:r1, blk * 128:(blk + 1) * 128] == 0).sum())
        assert n_pruned >= k == ts._prune_count(d_row * 128, s) and zeros == n_pruned


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("gs", [None, 128], ids=["per_channel", "g128"])
def test_fast_obq_quantize_matches_jax(gs, bits):
    """The public API, each package's own factorization: codes equal on at
    least 99.9% of the level's entries over the 5 seeds, and the level's
    relative error, summed over them, within 1e-3 of JAX's. Over the seeds,
    not per seed: a code that flips at a rounding tie changes its column's
    error by a whole step, which moves the rest of its row (at 8 bits one
    flip in ten seeds took 0.15% of a level and moved its error by 0.16%;
    every other level of ten seeds was bit-equal)."""
    agree, errs = [], []
    for seed in SEEDS:
        W, H = make_problem(seed)
        qj, _, wj = js.fast_obq_quantize(jnp.asarray(W), jnp.asarray(H), [bits],
                                         group_size=gs)[bits]
        qt, pt, wt = ts.fast_obq_quantize(torch.from_numpy(W), torch.from_numpy(H), [bits],
                                          group_size=gs)[bits]
        assert qt.dtype == torch.uint8 and int(qt.max()) <= 2**bits - 1
        assert tuple(pt.scale.shape) == (W.shape[0], W.shape[1] // (gs or W.shape[1]))
        agree.append(qt.numpy() == unscramble(qj, 128))
        errs.append((rel_err(W, wt, H), rel_err(W, np.asarray(wj), H)))
    et, ej = np.sum(errs, axis=0)
    assert np.mean(agree) >= 0.999 and abs(et - ej) <= 1e-3 * ej, (np.mean(agree), errs)


@pytest.mark.parametrize("sparsity", [0.3, 0.5, 0.6])
def test_fast_obc_prune_matches_jax(sparsity):
    """Masks equal on at least 99.9% of entries over the 5 seeds (as FastOBQ's
    codes), each seed's relative error within 1e-3 of JAX's; every level of
    ten seeds was bit-equal when this was written."""
    agree = []
    for seed in SEEDS:
        W, H = make_problem(seed)
        (b,) = js.fast_obc_prune(jnp.asarray(W), jnp.asarray(H), [sparsity])
        (a,) = ts.fast_obc_prune(torch.from_numpy(W), torch.from_numpy(H), [sparsity])
        a, b = a.numpy(), np.asarray(b)
        agree.append((a == 0) == (b == 0))
        assert abs((a == 0).mean() - sparsity) < 0.01
        et, ej = rel_err(W, a, H), rel_err(W, b, H)
        assert abs(et - ej) <= 1e-3 * ej, (seed, et, ej)
    assert np.mean(agree) >= 0.999, np.mean(agree)


def test_ladder_properties():
    """JAX's own checks (tests/test_sparse_gptq.py) on the port: errors
    fall with bits, 4 bits beat flat RTN, OBC beats magnitude pruning."""
    W, H = make_problem(16, d_row=8)
    res = ts.fast_obq_quantize(torch.from_numpy(W), torch.from_numpy(H), [2, 4, 8],
                               group_size=128)
    errs = {b: rel_err(W, w, H) for b, (_, _, w) in res.items()}
    assert errs[8] < errs[4] < errs[2]
    x = torch.from_numpy(W).reshape(8, 2, 128)
    p = ts.simple_find_params(x, 4, sym=False)
    _, wq = ts._flat_quantize(x, p.scale[..., None], p.zero[..., None], 15.0)
    assert errs[4] < rel_err(W, wq.reshape(8, 256), H)
    (w_s,) = ts.fast_obc_prune(torch.from_numpy(W), torch.from_numpy(H), [0.6])
    thr = np.quantile(np.abs(W), 0.6)
    w_mag = np.where(np.abs(W) > thr, W, 0.0).astype(np.float32)
    assert rel_err(W, w_s, H) < rel_err(W, w_mag, H) * 1.05


def test_owl_and_relative_error_match_jax():
    """owl_metric and relative_layer_error within a relative 1e-5. The
    outlier ratio counts entries above m x mean: XLA's f32 square root is
    not always correctly rounded (the metrics differ by an ulp on ~0.3% of
    entries), so an entry within 1e-6 of the threshold may land on either
    side; the counts differ by no more than those entries, and the ratios
    are within 1e-5 where there are none."""
    W, H = make_problem(5)
    mj = js.owl_metric(jnp.asarray(W), jnp.diagonal(jnp.asarray(H)))
    mt = ts.owl_metric(torch.from_numpy(W), torch.diagonal(torch.from_numpy(H)))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-5)
    n = W.size
    for m in (2.0, 3.0, 4.0):
        rj, rt = js.owl_outlier_ratio(mj, m), ts.owl_outlier_ratio(mt, m)
        thr = m * float(mt.mean())
        near = int((np.abs(mt.numpy() - thr) <= 1e-6 * thr).sum())
        assert rt > 0 and abs(rt - rj) * n <= near + 1e-5 * rj * n, (m, rt, rj, near)
        assert rt == float((mt > thr).float().mean())
    ratios = [0.1, 0.3, 0.2, 0.4]
    for r, s, lam in ((ratios, 0.5, 0.08), ([0.2, 0.2], 0.5, 0.08), (ratios, 0.7, 0.1)):
        np.testing.assert_array_equal(ts.owl_sparsity_distribution(r, s, lam),
                                      js.owl_sparsity_distribution(r, s, lam))
    W_hat = W + np.random.default_rng(1).normal(size=W.shape).astype(np.float32) * 0.01
    ej = float(js.relative_layer_error(jnp.asarray(W), jnp.asarray(W_hat), jnp.asarray(H)))
    et = rel_err(W, W_hat, H)
    assert abs(et - ej) <= 1e-5 * ej and rel_err(W, W, H) == 0


# ---------------------------------------------------------------------------
# The ladders and estimate-errors on a tiny llama
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A port-written tiny checkpoint (hidden 256, 2 layers), loaded by both
    packages, and 16 calibration sequences of 64 tokens (more than the
    widths, so each Hessian has full rank)."""
    from gptq_gguf_tpu.models import loader as jloader
    from gptq_gguf_tpu_torch.evals import parity
    from gptq_gguf_tpu_torch.models import loader

    tmp = tmp_path_factory.mktemp("ladder")
    d = parity.make_synthetic_checkpoint(tmp / "ckpt", "tiny", seed=2)
    cfg = loader.load_config(d)
    jcfg = jloader.load_config(d)
    calib = list(np.random.default_rng(3).integers(0, 256, size=(16, 1, 64)))
    return dict(tmp=tmp, ckpt=d, port=(loader.load_params(d, cfg), cfg),
                jax=(jloader.load_params(d, jcfg), jcfg), calib=calib)


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.pth"))


def test_fastobq_ladder_matches_jax(tiny):
    """The same files; over all of them, at most 0.1% of entries differ by
    more than 1e-3 of their file's largest value (a code step, not the f16
    rounding of the f32 solutions). The walks propagate the original
    weights (propagate_bits=None), so both packages' Hessians agree to f32
    rounding: propagating a quantized layer would carry the first layer's
    few flipped codes into the next layer's Hessian."""
    from gptq_gguf_tpu.search import ladder as jladder
    from gptq_gguf_tpu_torch.search import ladder

    tmp = tiny["tmp"]
    kw = dict(bitwidths=(4,), group_size=128, propagate_bits=None)
    jladder.build_fastobq_ladder(*tiny["jax"], tiny["calib"], tmp / "obq_jax", **kw)
    params = ladder.build_fastobq_ladder(*tiny["port"], tiny["calib"], tmp / "obq", device="cpu",
                                         **kw)
    assert torch.equal(params["layers"][1]["down_proj"], tiny["port"][0]["layers"][1]["down_proj"])
    files = _files(tmp / "obq")
    assert files == _files(tmp / "obq_jax") and len(files) == 2 * 7
    steps = []
    for f in files:
        a = torch.load(tmp / "obq" / f, weights_only=True)
        b = torch.load(tmp / "obq_jax" / f, weights_only=True)
        assert a.dtype == b.dtype == torch.float16 and a.shape == b.shape
        a, b = a.float().numpy(), b.float().numpy()
        steps.append((np.abs(a - b) > 1e-3 * np.abs(b).max()).ravel())
    assert np.concatenate(steps).mean() <= 1e-3, np.concatenate(steps).mean()


def test_fastobc_ladder_and_owl_match_jax(tiny):
    """The same files, each level's mask equal on at least 99.9% of entries
    (the walks propagate level 0, as JAX's default); the walk's params hold
    the propagated level (f32; its file is f16 of it). OWL ratios: within
    two entries of the smallest linear of JAX's, per block (1 / (7 x
    numel) a flipped entry: see test_owl_and_relative_error_match_jax)."""
    from gptq_gguf_tpu.search import ladder as jladder
    from gptq_gguf_tpu_torch.search import ladder

    tmp = tiny["tmp"]
    kw = dict(sparsity=0.5, num_levels=1, weights_diff=256 * 64)
    jladder.build_fastobc_ladder(*tiny["jax"], tiny["calib"], tmp / "obc_jax", **kw)
    params = ladder.build_fastobc_ladder(*tiny["port"], tiny["calib"], tmp / "obc", device="cpu",
                                         **kw)
    files = _files(tmp / "obc")
    assert files == _files(tmp / "obc_jax") and any(f.endswith("/-1.pth") for f in files)
    for f in files:
        a = torch.load(tmp / "obc" / f, weights_only=True)
        b = torch.load(tmp / "obc_jax" / f, weights_only=True)
        assert ((a == 0) == (b == 0)).float().mean() >= 0.999, f
    name = "model.layers.1.mlp.up_proj"
    w0 = torch.load(tmp / "obc" / name / "0.pth", weights_only=True)
    assert abs(float((w0 == 0).float().mean()) - 0.5) < 0.01
    assert torch.equal(params["layers"][1]["up_proj"].half(), w0)
    smallest = min(int(np.prod(w.shape)) for w in tiny["port"][0]["layers"][0].values()
                   if w.dim() == 2)
    rj = jladder.compute_owl_outlier_ratios(*tiny["jax"], tiny["calib"], m=3.0)
    rt = ladder.compute_owl_outlier_ratios(*tiny["port"], tiny["calib"], m=3.0, device="cpu")
    assert len(rt) == 2 and all(abs(a - b) <= 2 / (7 * smallest) + 1e-5 * b
                                for a, b in zip(rt, rj)), (rt, rj)


def test_estimate_errors_cli_matches_jax(tiny):
    """Both command lines over one database (the port's FastOBQ ladder at 2
    and 6 bits): the same linears and files, each relative error within
    1e-5 of JAX's; 6 bits below 2 on every linear."""
    from gptq_gguf_tpu.__main__ import main as jmain
    from gptq_gguf_tpu_torch.__main__ import main
    from gptq_gguf_tpu_torch.search import ladder

    tmp = tiny["tmp"]
    db = tmp / "db26"
    ladder.build_fastobq_ladder(*tiny["port"], tiny["calib"], db, bitwidths=(2, 6),
                                propagate_bits=None, device="cpu")
    argv = ["estimate-errors", "--model_name_or_path", str(tiny["ckpt"]), "--db_path", str(db),
            "--calibration_data", "synthetic", "--calibration_tokens", "1024",
            "--calibration_sequence_length", "64"]
    from gptq_gguf_tpu.cli import common as jcommon

    load_tok = jcommon.load_tokenizer
    jcommon.load_tokenizer = lambda args: None  # synthetic data needs none
    try:
        jmain([*argv, "--output_path", str(tmp / "errs_jax.json")])
    finally:
        jcommon.load_tokenizer = load_tok
    main([*argv, "--output_path", str(tmp / "errs.json"), "--device", "cpu"])
    got = json.loads((tmp / "errs.json").read_text())
    want = json.loads((tmp / "errs_jax.json").read_text())
    assert sorted(got) == sorted(want) and len(got) == 14
    for name, errs in got.items():
        assert sorted(errs) == sorted(want[name]) == ["2.pth", "6.pth"]
        assert errs["6.pth"] < errs["2.pth"]
        for f, e in errs.items():
            assert abs(e - want[name][f]) <= 1e-5 * want[name][f], (name, f, e, want[name][f])
