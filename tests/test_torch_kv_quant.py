"""The port's int8 / int4 contiguous KV caches against the JAX package, on the CPU.

Same numpy inputs (from a seed) through both packages, on the dense tiny
Llama of tests/test_torch_paged.py (f32 params, head_dim 64). Tolerances:
- ``_quantize_kv`` (int8) and ``_quantize_kv_q4``: codes and scales bit-equal
  (the same f32 operations, round half to even in both);
- ``init_cache``: JAX's shapes and dtypes, plus the port's drop row;
- ``forward_cached`` logits over a prefill and decode steps, on the short
  path and on the flash path (L >= 2 * FLASH_CHUNK): within LOGIT_TOL of
  max|logit| (2e-3). The K / V written differ from JAX's in their last f32
  bits (other sum orders), so a code may round the other way at a .5
  boundary; one code step moves a score by at most a scale (1/127 or 1/7
  of the entry's or group's largest |value|), which the limit covers, and
  the caches' codes must be at least 99.9% equal;
- engine token streams: equal up to a near-tie (a top-2 gap below
  LOGIT_TOL of max|logit|);
- the port's paged int4 cache against its contiguous int4 cache: the same
  codes, logits within 2e-4 (f32 sum order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptq_gguf_tpu.serving import engine as jengine, model as jmodel
from gptq_gguf_tpu_torch.serving import engine, model as qmodel, paged
from tests.test_torch_paged import _model, _raw, _t

LOGIT_TOL = 2e-3


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantize_kv_bit_equal(kind, dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 2, 128)) * 2).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero entry: scale 0, codes 0 (+8)
    x[1, 2, 1, :40] = 1.5  # ties at the largest |value|
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    jf, tf = ((jmodel._quantize_kv, qmodel._quantize_kv) if kind == "int8"
              else (jmodel._quantize_kv_q4, qmodel._quantize_kv_q4))
    (jq, js), (tq, ts) = jf(jx), tf(tx)
    np.testing.assert_array_equal(_raw(tq), np.asarray(jq))
    np.testing.assert_array_equal(_raw(ts), np.asarray(js))
    assert tq.dtype == (torch.int8 if kind == "int8" else torch.uint8)


@pytest.mark.parametrize("kv_dtype", [None, "bf16", "int8", "int4"])
def test_init_cache_matches_jax(kv_dtype):
    jcfg, _, cfg, _ = _model(hidden=128, heads=2)
    jc = jmodel.init_cache(jcfg, 3, 40, kv_dtype=kv_dtype)
    tc = qmodel.init_cache(cfg, 3, 40, kv_dtype=kv_dtype, device="cpu")
    assert type(tc).__name__ == type(jc).__name__
    assert tc.max_len == 40
    for field in jc._fields:
        jv, tv = getattr(jc, field), getattr(tc, field)
        if field == "lengths":
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            continue
        assert len(tv) == len(jv) == cfg.num_hidden_layers
        for a, b in zip(tv, jv):
            want = list(b.shape)
            want[2] += 1  # the drop row
            assert list(a.shape) == want, field
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            assert not a.any()


def test_init_cache_guards():
    _, _, cfg, _ = _model(hidden=96, heads=3)  # head_dim 32: not a multiple of 64
    with pytest.raises(NotImplementedError, match="int4 KV"):
        qmodel.init_cache(cfg, 1, 8, kv_dtype="int4", device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        qmodel.init_cache(cfg, 1, 8, kv_dtype="fp8", device="cpu")
    qmodel.init_cache(cfg, 1, 8, kv_dtype="int8", device="cpu")


def _logits_close(got, want, what):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * scale, err_msg=what)
    return np.abs(got - want).max() / scale


@pytest.mark.parametrize("max_len", [48, 1024], ids=["short", "flash"])
@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_forward_cached_matches_jax(kv_dtype, max_len):
    """A prefill of 12 tokens into 2 slots (the second right-padded to 9),
    then 4 decode steps, JAX's argmax fed to both."""
    jcfg, jp, cfg, tp = _model(hidden=128, heads=2)
    rng = np.random.default_rng(11)
    ids = rng.integers(0, jcfg.vocab_size, size=(2, 12))
    n_valid = np.asarray([12, 9], np.int32)
    jc = jmodel.init_cache(jcfg, 2, max_len, dtype=jnp.float32, kv_dtype=kv_dtype)
    tc = qmodel.init_cache(cfg, 2, max_len, dtype=torch.float32, kv_dtype=kv_dtype, device="cpu")
    jl, jc = jmodel.forward_cached(jp, jcfg, jnp.asarray(ids), jc, n_valid=jnp.asarray(n_valid))
    tl, tc = qmodel.forward_cached(tp, cfg, _t(ids), tc, n_valid=_t(n_valid))
    worst = [_logits_close(tl.numpy(), np.asarray(jl), "prefill")]
    for step in range(4):
        toks = np.asarray(jl).argmax(-1)[:, None]
        jl, jc = jmodel.forward_cached(jp, jcfg, jnp.asarray(toks), jc)
        tl, tc = qmodel.forward_cached(tp, cfg, _t(toks), tc)
        worst.append(_logits_close(tl.numpy(), np.asarray(jl), f"decode step {step}"))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    for li in range(cfg.num_hidden_layers):
        for got, want in ((tc.k[li], jc.k[li]), (tc.v[li], jc.v[li])):
            assert (got[:, :, :max_len].numpy() == np.asarray(want)).mean() > 0.999
        for got, want in ((tc.k_s[li], jc.k_s[li]), (tc.v_s[li], jc.v_s[li])):
            np.testing.assert_allclose(got[:, :, :max_len].numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-7)
    print(f"{kv_dtype} L={max_len}: max |dlogit| / max|logit| {max(worst):.2e}")


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_engine_streams_match_jax(kv_dtype):
    jcfg, jp, cfg, tp = _model(hidden=128, heads=2, seed=13)
    rng = np.random.default_rng(12)
    reqs = [(rng.integers(0, jcfg.vocab_size, size=int(rng.integers(3, 15))), 7)
            for _ in range(4)]
    kw = dict(num_slots=2, max_len=64, multi_step=4, kv_quantized=kv_dtype)
    je = jengine.ContinuousBatchingEngine(jp, jcfg, **kw)
    te = engine.ContinuousBatchingEngine(tp, cfg, **kw)
    assert isinstance(te.cache, qmodel.KVCacheQ8 if kv_dtype == "int8" else qmodel.KVCacheQ4)
    for p, n in reqs:
        je.submit(p, max_new_tokens=n)
        te.submit(p, max_new_tokens=n)
    jd = {r.uid: r.output for r in je.run_until_done()}
    td = {r.uid: r.output for r in te.run_until_done()}
    for uid, (p, n) in enumerate(reqs, start=1):
        a, b = td[uid], jd[uid]
        assert len(a) == len(b) == n
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is not None:  # a flip must be a near-tie of the port's logits
            ctx = np.concatenate([p, a[:t]]).astype(np.int64)
            cache = qmodel.init_cache(cfg, 1, 64, kv_dtype=kv_dtype, device="cpu")
            logits, _ = qmodel.forward_cached(tp, cfg, _t(ctx)[None], cache)
            top2 = torch.topk(logits[0], 2).values
            assert float(top2[0] - top2[1]) < LOGIT_TOL * float(logits.abs().max())
    # the quantized cache is exercised by prefix reuse and k-step blocks
    # too: generate() in the same dtype gives the engine's tokens
    gen = engine.generate(tp, cfg, [p for p, _ in reqs[:2]], 7, max_len=64,
                          kv_quantized=kv_dtype)
    assert gen == [td[1], td[2]]


def test_paged_int4_matches_contiguous_int4():
    """The same prefill and decode steps through the port's paged int4
    pools (the paged kernel's plain version on the CPU) and its contiguous
    int4 cache: the same codes and scales, logits within 2e-4."""
    _, _, cfg, tp = _model(hidden=128, heads=2, seed=19)
    rng = np.random.default_rng(13)
    B, S, page, max_len = 2, 12, 8, 32
    ids = rng.integers(0, cfg.vocab_size, size=(B, S))
    pc = paged.init_paged_cache(cfg, B, max_len, page, dtype=torch.float32, kv_dtype="int4",
                                device="cpu")
    table = torch.tensor([[2, 0, 3, 1], [5, 7, 4, 6]], dtype=torch.int32)
    pc = pc._replace(page_table=table)
    cc = qmodel.init_cache(cfg, B, max_len, dtype=torch.float32, kv_dtype="int4", device="cpu")
    pl, pc = paged.forward_paged(tp, cfg, _t(ids), pc)
    cl, cc = qmodel.forward_cached(tp, cfg, _t(ids), cc)
    torch.testing.assert_close(pl, cl, rtol=0, atol=2e-4)
    for step in range(page + 2):
        toks = cl.argmax(-1)[:, None]
        pl, pc = paged.forward_paged(tp, cfg, toks, pc)
        cl, cc = qmodel.forward_cached(tp, cfg, toks, cc)
        torch.testing.assert_close(pl, cl, rtol=0, atol=2e-4, msg=f"decode step {step}")
    hd = cfg.head_dim_
    for li in range(cfg.num_hidden_layers):
        codes = paged._gather_slot_kv(pc.k_pages[li], table)[:, :, :S + page + 2]
        assert torch.equal(codes[..., : hd // 2], cc.k[li][:, :, :S + page + 2])
        assert torch.equal(codes[..., hd // 2:], cc.v[li][:, :, :S + page + 2])


def test_generate_int8_first_tokens_match_jax():
    """JAX's generate with its int8 switch (kv_quantized=True) and the
    port's: the same greedy tokens up to a near-tie."""
    jcfg, jp, cfg, tp = _model(hidden=128, heads=2, seed=23)
    prompts = [np.arange(6) + 1, np.arange(3) * 5]
    want = jengine.generate(jp, jcfg, prompts, 6, kv_quantized=True)
    got = engine.generate(tp, cfg, prompts, 6, kv_quantized=True)
    for p, a, b in zip(prompts, got, jax.tree_util.tree_map(int, want)):
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is not None:
            ctx = np.concatenate([p, a[:t]]).astype(np.int64)
            cache = qmodel.init_cache(cfg, 1, 16, kv_dtype="int8", device="cpu")
            logits, _ = qmodel.forward_cached(tp, cfg, _t(ctx)[None], cache)
            top2 = torch.topk(logits[0], 2).values
            assert float(top2[0] - top2[1]) < LOGIT_TOL * float(logits.abs().max())
