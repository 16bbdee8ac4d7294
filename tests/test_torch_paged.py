"""The port's paged serving slice against the JAX package, on the CPU.

Same numpy inputs (from a seed) through both packages. Tolerances:
- int4 KV quantization, pool writes and gathers, pool initialisation:
  bit-equal (the same f32 operations, round half to even in both);
- the decode kernels' plain versions against JAX's kernels in interpret
  mode: 3e-5 in f32 (sums in another order), the JAX tests' own;
- forward_paged against JAX's on a dense tiny model with f32 pools: 2e-4,
  the JAX paged tests' own tolerance (f32 sum order through two layers);
- greedy token streams of the paged engine: equal.
On the CPU the kernels' wrappers run their plain versions; the kernels
themselves are held to those on the card (tests/test_torch_kernel_cuda.py,
chip_smoke.py)."""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptq_gguf_tpu.models import llama as jl
from gptq_gguf_tpu.ops import paged_attention as jpa
from gptq_gguf_tpu.serving import engine as jengine, model as jmodel, paged as jpaged
from gptq_gguf_tpu_torch import __main__ as cli
from gptq_gguf_tpu_torch.models import llama
from gptq_gguf_tpu_torch.ops import paged_attention as pa
from gptq_gguf_tpu_torch.serving import engine, model as qmodel, paged
from tests.test_torch_serving import _first_flip_is_a_tie, gguf  # noqa: F401

CPU = "cpu"


def _raw(a):
    """Exact numpy view of a JAX array or a tensor (bf16 as its bits)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _model(hidden=256, heads=4, kv_heads=2, seed=17):
    """A dense tiny Llama in both packages (f32 params, hd = hidden / heads)."""
    jcfg = jl.LlamaConfig(vocab_size=128, hidden_size=hidden, intermediate_size=256,
                          num_hidden_layers=2, num_attention_heads=heads,
                          num_key_value_heads=kv_heads, max_position_embeddings=4096)
    jp = jl.init_params(jcfg, seed=seed)
    cfg = llama.config_from_reference(jcfg)
    tp = llama.dense_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, device=CPU)
    return jcfg, jp, cfg, tp


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_quantize_kv_q4_bit_equal(dtype):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 5, 2, 128)) * 3).astype(np.float32)
    x[0, 0, 0, :32] = 0.0  # an all-zero group: scale 0, codes 8
    xj = jnp.asarray(x).astype(dtype)
    cj, sj = jmodel._quantize_kv_q4(xj)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16 if dtype == jnp.bfloat16
                                                     else torch.float32)
    ct, st = qmodel._quantize_kv_q4(xt)
    assert ct.dtype == torch.uint8 and ct.shape == (2, 5, 2, 64) and st.shape == (2, 5, 2, 4)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(llama.dequant_kv_q4(ct, st).numpy(),
                                  np.asarray(jl.dequant_kv_q4(cj, sj)))


def _pool_case(kind, rng):
    """Random pools of 6 pages (page 8, 2 kv heads, hd 64), a table with
    unassigned entries, and (B, S) positions some of which land on them."""
    n_pages, nkv, page, hd = 6, 2, 8, 64
    table = np.asarray([[3, 0, -1], [5, -1, -1]], np.int32)
    positions = np.asarray([2, 0])[:, None] + np.arange(12)[None, :]
    if kind == "scales":  # transposed scale pool, positions last
        pool = rng.normal(size=(n_pages, nkv, 2 * hd // 32, page)).astype(np.float32)
        vals = rng.normal(size=(2, 12, nkv, 2 * hd // 32)).astype(np.float32)
    elif kind == "codes":
        pool = rng.integers(0, 256, size=(n_pages, nkv, page, hd), dtype=np.uint8)
        vals = rng.integers(0, 256, size=(2, 12, nkv, hd), dtype=np.uint8)
    else:
        pool = rng.normal(size=(n_pages, nkv, page, hd)).astype(np.float32)
        vals = rng.normal(size=(2, 12, nkv, hd)).astype(np.float32)
    return pool, table, positions, vals


@pytest.mark.parametrize("kind", ["f32", "bf16", "codes", "scales"])
def test_pool_writes_bit_equal(kind):
    pool, table, positions, vals = _pool_case(kind, np.random.default_rng(2))
    jpool = jnp.asarray(pool)
    tpool = _t(np.concatenate([pool, np.zeros_like(pool[:1])]))  # + the drop page
    if kind == "bf16":
        jpool = jpool.astype(jnp.bfloat16)
        tpool = tpool.to(torch.bfloat16)
    jwrite, twrite = ((jpaged._write_paged_t, paged._write_paged_t) if kind == "scales"
                      else (jpaged._write_paged, paged._write_paged))
    want = jwrite(jpool, jnp.asarray(table), jnp.asarray(positions), jnp.asarray(vals))
    got = twrite(tpool, _t(table), _t(positions), _t(vals))
    assert got is tpool  # in place
    np.testing.assert_array_equal(_raw(got[:-1]), _raw(want))
    assert not np.array_equal(_raw(want), _raw(jpool))  # the case does write


def test_gathers_bit_equal():
    rng = np.random.default_rng(3)
    pool, table, _, _ = _pool_case("f32", rng)
    spool, _, _, _ = _pool_case("scales", rng)
    np.testing.assert_array_equal(
        paged._gather_slot_kv(_t(pool), _t(table)).numpy(),
        np.asarray(jpaged._gather_slot_kv(jnp.asarray(pool), jnp.asarray(table))))
    np.testing.assert_array_equal(
        paged._gather_slot_scales_t(_t(spool), _t(table)).numpy(),
        np.asarray(jpaged._gather_slot_scales_t(jnp.asarray(spool), jnp.asarray(table))))


@pytest.mark.parametrize("kv_dtype,n_pages", [(None, None), ("int4", None), ("int4", 5)])
def test_init_paged_cache_matches(kv_dtype, n_pages):
    jcfg, _, cfg, _ = _model()
    jc = jpaged.init_paged_cache(jcfg, 3, 64, 16, n_pages, kv_dtype=kv_dtype)
    tc = paged.init_paged_cache(cfg, 3, 64, 16, n_pages, kv_dtype=kv_dtype, device=CPU)
    assert tc.q4 == jc.q4 and tc.page_size == jc.page_size and tc.max_len == jc.max_len
    assert tc.n_pages == jc.k_pages[0].shape[0]
    for a, b in zip(tc.k_pages + tc.v_pages, jc.k_pages + jc.v_pages):
        assert _raw(a[:-1]).dtype == _raw(b).dtype
        np.testing.assert_array_equal(_raw(a[:-1]), _raw(b))
    np.testing.assert_array_equal(tc.page_table.numpy(), np.asarray(jc.page_table))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


DECODE_CASES = {
    # partial last pages, a page-edge length and -1 entries past the live pages
    "plain": dict(lengths=[5, 63, 170]),
    "window_sinks": dict(lengths=[70, 150, 33], window=48, sinks=True),
    "softcap": dict(lengths=[40, 130, 0], softcap=30.0),
}


def _decode_inputs(rng, lengths, q4, page=32, pps=6, nkv=2, G=4, hd=128):
    B = len(lengths)
    n_pages = B * pps
    q = rng.normal(size=(B, nkv, G, hd)).astype(np.float32)
    table = np.full((B, pps), -1, np.int32)
    order = rng.permutation(n_pages)
    for b, length in enumerate(lengths):
        live = length // page + 1
        table[b, :live] = order[b * pps:b * pps + live]
    if q4:
        k = rng.normal(size=(n_pages, nkv, page, hd)).astype(np.float32) * 0.3
        v = rng.normal(size=(n_pages, nkv, page, hd)).astype(np.float32)
        kq, ks = jmodel._quantize_kv_q4(jnp.asarray(k))
        vq, vs = jmodel._quantize_kv_q4(jnp.asarray(v))
        kp = np.asarray(jnp.concatenate([kq, vq], axis=-1))
        vp = np.asarray(jnp.concatenate([ks, vs], axis=-1).transpose(0, 1, 3, 2))
    else:
        kp = rng.normal(size=(n_pages, nkv, page, hd)).astype(np.float32) * 0.3
        vp = rng.normal(size=(n_pages, nkv, page, hd)).astype(np.float32)
    return q, kp, vp, table, np.asarray(lengths, np.int32)


@functools.lru_cache(maxsize=None)
def _decode_case(case, q4):
    """A DECODE_CASES case's inputs (numpy, from a seed), its keyword
    arguments and the JAX kernel's output in interpret mode."""
    c = DECODE_CASES[case]
    rng = np.random.default_rng(len(case) + 10 * q4)
    q, kp, vp, table, lengths = _decode_inputs(rng, c["lengths"], q4)
    sinks = rng.normal(size=(q.shape[1] * q.shape[2],)).astype(np.float32) \
        if c.get("sinks") else None
    kw = dict(scale=1.0 / np.sqrt(q.shape[-1]), window=c.get("window", 0),
              softcap=c.get("softcap", 0.0))
    jfn = jpa.paged_flash_decode_q4 if q4 else jpa.paged_flash_decode
    want = jfn(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
               jnp.asarray(lengths), interpret=True,
               sinks=None if sinks is None else jnp.asarray(sinks), **kw)
    return (q, kp, vp, table, lengths), sinks, kw, np.asarray(want)


@pytest.mark.parametrize("q4", [False, True], ids=["bf16_kernel", "q4_kernel"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_twins_match_jax_kernels(case, q4):
    (q, kp, vp, table, lengths), sinks, kw, want = _decode_case(case, q4)
    tfn = pa.paged_flash_decode_q4 if q4 else pa.paged_flash_decode
    n0 = tfn.launches
    got = tfn(_t(q), _t(kp), _t(vp), _t(table), _t(lengths),
              sinks=None if sinks is None else _t(sinks), **kw)
    assert tfn.launches == n0  # a CPU tensor runs the plain version
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


# 6 pages of 32 per slot: 1 split; 2 and 3 (every split past the first
# empty for the softcap case's length-0 slot; at 3 the edges 64 and 128
# fall inside window_sinks' windows (22, 70] and (102, 150]); 6, one page
# each
@pytest.mark.parametrize("n_split", [1, 2, 3, 6])
@pytest.mark.parametrize("q4", [False, True], ids=["bf16_kernel", "q4_kernel"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_split_twins_match_jax_kernels(case, q4, n_split):
    """The kernel's two passes (partials per page range, joined in split
    order with the sinks) in plain PyTorch against JAX's kernels."""
    (q, kp, vp, table, lengths), sinks, kw, want = _decode_case(case, q4)
    fn = pa.paged_flash_decode_q4_split_reference if q4 else pa.paged_flash_decode_split_reference
    args = [_t(a) for a in (q, kp, vp, table, lengths)]
    got = fn(*args, n_split=n_split, sinks=None if sinks is None else _t(sinks), **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
    if n_split > 1:  # the first pass really leaves empty splits where the case says
        kp_t, vp_t, table_t = args[1:4]
        k_all, v_all = (pa._gather_q4(kp_t, vp_t, table_t, q.shape[-1]) if q4 else
                        (pa._gather_slot_kv(kp_t, table_t), pa._gather_slot_kv(vp_t, table_t)))
        per = -(-table.shape[1] // n_split)
        m, l, acc = pa._split_partials(args[0], k_all, v_all, args[4], kw["scale"],
                                       kw["window"], kw["softcap"], kp.shape[2], per, n_split)
        empty = (l == 0).all(-1)  # (B, nKV, n_split)
        assert bool((m[empty] == -1e30).all()) and bool((acc[empty] == 0).all())
        own = lengths // (per * kp.shape[2])  # the split holding each slot's query
        assert not any(bool(empty[b, :, own[b]].any()) for b in range(len(lengths)))
        if case == "softcap":
            assert bool(empty[2, :, 1:].all())  # the length-0 slot reads page 0 only
        if case == "window_sinks" and n_split >= 3:  # a window straddles a split edge
            assert bool(((~empty).sum(-1) > 1).any())


@pytest.mark.parametrize("B,nKV,pps,page,n_sm", [
    (8, 8, 32, 64, 132),   # Llama-3-8B at B = 8, a full 2048-position table
    (1, 1, 4, 64, 132), (8, 8, 30, 16, 132), (2, 1, 5, 40, 132), (64, 8, 32, 64, 132),
    (3, 2, 9, 16, 132), (1, 1, 1, 256, 132), (5, 4, 3, 256, 114), (1, 1, 512, 1, 132),
    (1, 1, 2048, 16, 132),  # 32768 positions: MAX_SPLITS bounds the grid
])
def test_split_plan_covers_every_page(B, nKV, pps, page, n_sm):
    """The host's split plan: ints in, ints out (no device tensor to
    read); every page of [0, pps) in exactly one split, none past pps, no
    split under MIN_SPLIT_POSITIONS positions unless the table is smaller,
    at most MAX_SPLITS splits, and enough blocks for SPLIT_BLOCKS_PER_SM
    per SM where pages allow."""
    assert list(inspect.signature(pa._split_plan).parameters) == ["B", "nKV", "pps", "page",
                                                                 "n_sm"]
    n_split, per = pa._split_plan(B, nKV, pps, page, n_sm)
    assert isinstance(n_split, int) and isinstance(per, int) and n_split >= 1 and per >= 1
    pages = [p for s in range(n_split) for p in range(s * per, min((s + 1) * per, pps))]
    assert pages == list(range(pps))
    assert (n_split - 1) * per < pps <= n_split * per
    assert per * page >= min(pa.MIN_SPLIT_POSITIONS, pps * page)
    assert n_split <= pa.MAX_SPLITS
    want = pa.SPLIT_BLOCKS_PER_SM * n_sm
    min_per = max(1, -(-pa.MIN_SPLIT_POSITIONS // page), -(-pps // pa.MAX_SPLITS))
    if per > min_per:  # pages were not the limit: the plan asked for enough blocks
        assert B * nKV * -(-pps // (per - 1)) > want >= B * nKV * (n_split - 1)


@pytest.mark.parametrize("kv_dtype", [None, "int4"], ids=["f32_pools", "int4_pools"])
def test_forward_paged_matches_jax(kv_dtype):
    """Prefill of 12 tokens, then 10 decode steps across a page boundary,
    on scrambled tables; the pools after the steps against JAX's."""
    jcfg, jp, cfg, tp = _model()
    B, S, page, max_len = 2, 12, 8, 32
    rng = np.random.default_rng(4)
    ids = rng.integers(0, jcfg.vocab_size, size=(B, S))
    table = np.asarray([[2, 0, 3, 1], [5, 7, 4, 6]], np.int32)
    jc = jpaged.init_paged_cache(jcfg, B, max_len, page, dtype=jnp.float32, kv_dtype=kv_dtype)
    jc = jc._replace(page_table=jnp.asarray(table))
    tc = paged.paged_cache_from_numpy([np.asarray(a) for a in jc.k_pages],
                                      [np.asarray(a) for a in jc.v_pages], table,
                                      np.zeros(B, np.int32), device=CPU)
    jl_, jc = jpaged.forward_paged(jp, jcfg, jnp.asarray(ids), jc)
    tl, tc = paged.forward_paged(tp, cfg, _t(ids), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl_), rtol=2e-4, atol=2e-4)
    toks = rng.integers(0, jcfg.vocab_size, size=(B, 1))
    for step in range(page + 2):
        jl_, jc = jpaged.forward_paged(jp, jcfg, jnp.asarray(toks), jc)
        tl, tc = paged.forward_paged(tp, cfg, _t(toks), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl_), rtol=2e-4, atol=2e-4,
                                   err_msg=f"decode step {step}")
        toks = np.asarray(jl_).argmax(-1)[:, None]
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    for li in range(cfg.num_hidden_layers):
        got_k, got_v = tc.k_pages[li][:-1].numpy(), tc.v_pages[li][:-1].numpy()
        want_k, want_v = np.asarray(jc.k_pages[li]), np.asarray(jc.v_pages[li])
        if kv_dtype == "int4":
            # codes from K / V that differ in the last f32 bits: a code may
            # round the other way at a .5 boundary, nowhere else
            assert (got_k == want_k).mean() > 0.999
            np.testing.assert_allclose(got_v, want_v, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(got_k, want_k, rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(got_v, want_v, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", ["other_slots", "padded_bucket"])
def test_prefill_writes_only_its_slot(case):
    """A prefill writes its own slot's pages and nothing else: not the
    pages of other slots, not unassigned pages. In "padded_bucket" the
    slot has 3 of 4 pages and the prompt's bucket of 32 runs past them."""
    _, _, cfg, tp = _model(hidden=128, heads=2)
    cache = paged.init_paged_cache(cfg, 3, 32, 8, kv_dtype=None, dtype=torch.float32,
                                   device=CPU)
    gen = torch.Generator().manual_seed(5)
    for pool in cache.k_pages + cache.v_pages:
        pool.copy_(torch.randn(pool.shape, generator=gen))
    own = [4, 9, 1] if case == "padded_bucket" else [4, 9, 1, 6]
    table = torch.full((3, 4), -1, dtype=torch.int32)
    table[0] = torch.tensor([0, 2, 3, 5])
    table[1, :len(own)] = torch.tensor(own)
    table[2, :2] = torch.tensor([7, 8])
    cache = cache._replace(page_table=table, lengths=torch.tensor([5, 0, 7], dtype=torch.int32))
    before = [p.clone() for p in cache.k_pages + cache.v_pages]
    n = 17 if case == "padded_bucket" else 20
    padded, n = engine._pad_prompt(np.arange(n, dtype=np.int64) % cfg.vocab_size, 32)
    assert len(padded) == 32  # padded_bucket: positions 24..31 fall on an unassigned page
    _, _, cache = engine._paged_prefill_slot(tp, cfg, _t(padded)[None], cache, 1, n)
    assert cache.lengths.tolist() == [5, n, 7]
    others = [p for p in range(cache.n_pages) if p not in own]
    for new, old in zip(cache.k_pages + cache.v_pages, before):
        torch.testing.assert_close(new[others], old[others], rtol=0, atol=0)
        assert not torch.equal(new[own], old[own])


def _streams(jcfg, jp, cfg, tp, prompts, max_new, **kw):
    je = jengine.PagedContinuousBatchingEngine(jp, jcfg, **kw)
    te = engine.PagedContinuousBatchingEngine(tp, cfg, device=CPU, **kw)
    for p in prompts:
        je.submit(p, max_new_tokens=max_new)
        te.submit(p, max_new_tokens=max_new)
    jd = {r.uid: r.output for r in je.run_until_done(max_steps=500)}
    td = {r.uid: r.output for r in te.run_until_done(max_steps=500)}
    return jd, td, je, te


@pytest.mark.parametrize("case", ["plain", "oversubscribed", "int4"])
def test_paged_engine_streams_match_jax(case):
    rng = np.random.default_rng(6)
    if case == "int4":
        jcfg, jp, cfg, tp = _model(hidden=128, heads=2, seed=13)
        kw = dict(num_slots=2, max_len=64, page_size=8, kv_quantized="int4")
    else:
        jcfg, jp, cfg, tp = _model(hidden=64, heads=4)
        kw = dict(num_slots=2, max_len=64, page_size=8)
    if case == "oversubscribed":
        # 2 pages per request, 8 pages for 4 slots: admission waits for pages
        kw = dict(num_slots=4, max_len=64, page_size=8, n_pages=8)
        prompts = [rng.integers(0, jcfg.vocab_size, size=(6,)) for _ in range(6)]
        max_new = 10
    else:
        prompts = [rng.integers(0, jcfg.vocab_size, size=(n,)) for n in (5, 9, 6, 7)]
        max_new = 6
    jd, td, je, te = _streams(jcfg, jp, cfg, tp, prompts, max_new, **kw)
    assert sorted(td) == list(range(1, len(prompts) + 1))
    assert td == jd
    assert te.alloc.available == je.alloc.available == te.cache.n_pages  # all returned
    assert all(not pages for pages in te.slot_pages)


def test_paged_engine_cancel_and_pool_limits():
    _, _, cfg, tp = _model(hidden=64, heads=4)
    eng = engine.PagedContinuousBatchingEngine(tp, cfg, num_slots=1, max_len=64, page_size=8,
                                               device=CPU)
    a = eng.submit(np.arange(5), max_new_tokens=20)
    b = eng.submit(np.arange(3), max_new_tokens=4)
    eng.step()  # admits a: ceil(25 / 8) = 4 pages
    assert eng.alloc.available == eng.cache.n_pages - 4
    assert eng.cancel(a) and not eng.cancel(a)
    assert eng.alloc.available == eng.cache.n_pages
    assert int(eng.cache.lengths[0]) == 0 and (eng.cache.page_table[0] == -1).all()
    done = eng.run_until_done()
    assert [r.uid for r in done] == [b] and len(done[0].output) == 4
    small = engine.PagedContinuousBatchingEngine(tp, cfg, num_slots=2, max_len=64,
                                                 page_size=8, n_pages=2, device=CPU)
    small.submit(np.arange(20), max_new_tokens=10)  # needs 4 pages of the 2
    with pytest.raises(RuntimeError, match="page pool too small"):
        small.run_until_done()
    with pytest.raises(ValueError, match="kv_quantized"):
        engine.PagedContinuousBatchingEngine(tp, cfg, kv_quantized="int8", device=CPU)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(np.asarray([], np.int64))


@pytest.mark.parametrize("prompt_len,max_new", [(70, 10), (3, 100), (9, 6)])
def test_paged_admission_covers_the_request(prompt_len, max_new):
    """Admission reserves prompt + budget (the prompt cut to max_len -
    budget): every position a slot writes lies on the pages it was given,
    and its pages never change until it retires."""
    _, _, cfg, tp = _model(hidden=64, heads=4)
    eng = engine.PagedContinuousBatchingEngine(tp, cfg, num_slots=1, max_len=64, page_size=8,
                                               device=CPU)
    eng.submit(np.arange(prompt_len) % cfg.vocab_size, max_new_tokens=max_new)
    eng.step()
    pages = list(eng.slot_pages[0])
    while eng.slot_req[0] is not None:
        assert eng.slot_pages[0] == pages
        assert eng._fill[0] < len(pages) * eng.page_size  # the next write's position
        eng.step()
    assert len(eng.completed[0].output) == min(max_new, 63)
    assert eng.alloc.available == eng.cache.n_pages


def test_fused_gguf_paged_matches_contiguous(gguf):
    """The tiny Q4_K_M GGUF with q/k/v and gate/up fused: the port's paged
    engine gives the contiguous engine's streams (compared up to a near
    tie, as tests/test_torch_serving.py does). The JAX package's
    forward_paged reads the unfused projections and raises KeyError on
    these params."""
    tp, cfg = qmodel.load_gguf_for_serving(gguf, dtype=torch.float32, device=CPU)
    tp = qmodel.fuse_params_for_serving(tp, cfg)
    assert "qkv_proj" in tp["layers"][0] and "gateup_proj" in tp["layers"][0]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, size=int(rng.integers(4, 30))) for _ in range(4)]
    ce = engine.ContinuousBatchingEngine(tp, cfg, num_slots=2, max_len=128, multi_step=1)
    pe = engine.PagedContinuousBatchingEngine(tp, cfg, num_slots=2, max_len=128, page_size=16,
                                              device=CPU)
    for p in prompts:
        ce.submit(p, max_new_tokens=8)
        pe.submit(p, max_new_tokens=8)
    cd = {r.uid: r.output for r in ce.run_until_done()}
    pd = {r.uid: r.output for r in pe.run_until_done()}
    assert sorted(pd) == sorted(cd) == [1, 2, 3, 4]
    for uid, p in enumerate(prompts, start=1):
        a, b = pd[uid], cd[uid]
        assert len(a) == len(b) == 8
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is not None:
            assert _first_flip_is_a_tie(tp, cfg, p, b, t), f"request {uid} step {t}"

    jp, jcfg = jmodel.load_gguf_for_serving(gguf, dtype=jnp.float32)
    jp = jmodel.fuse_params_for_serving(jp, jcfg)
    jc = jpaged.init_paged_cache(jcfg, 1, 32, 16)
    with pytest.raises(KeyError, match="q_proj"):
        jpaged.forward_paged(jp, jcfg, jnp.asarray(prompts[0][None, :4]), jc)


def test_serve_cli_paged_matches_contiguous(gguf, capsys):
    argv = ["serve", "--gguf-file", str(gguf), "--prompt-tokens", "5", "6", "7",
            "--max-new-tokens", "6", "--max-len", "64", "--num-slots", "1", "--device", "cpu"]
    cli.main(argv)
    contiguous = capsys.readouterr().out.strip().splitlines()[-1]
    cli.main(argv + ["--paged", "--page-size", "16"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0].startswith("generated 6 tokens")
    assert printed[-1] == contiguous
