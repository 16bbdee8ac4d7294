"""The port's sampler chain and sampled engines against the JAX package, on the CPU.

Same numpy inputs (from a seed) through both packages. What is held, and how:
- the chain's logit transforms (penalties, temperature, the top-k / top-p /
  min-p masks) on a grid of settings: penalized logits within 1e-6
  (relative; elementwise f32 arithmetic), greedy flags and masks equal,
  except elements whose exclusive cumulative mass (f64) lies within
  TOP_P_EDGE of top_p, where the two packages' f32 softmax and cumsum may
  round to either side (counted and printed);
- ``set_slot``'s prompt counts: bit for bit;
- the random draw: torch cannot replay JAX's threefry streams, so draws are
  held by distribution: 4096 draws of one row against JAX's masked softmax,
  each kept token's frequency within 5 standard deviations (+ 1/N), exactly
  zero draws outside the mask;
- greedy rows with penalties: JAX's argmax, exactly;
- a slot's draws depend on its seed and draw count only: bit for bit across
  slots, batch-mates and block sizes;
- top-k logprobs: values within 1e-5, ids equal up to ties;
- engine streams on the tiny GGUF of tests/test_torch_serving.py, loaded
  dense in both packages (f32 arithmetic in both, fast on the CPU): greedy
  requests with penalties and logprob requests against JAX's engines up to
  a near-tie (a top-2 gap of the penalized logits below LOGIT_TOL of
  max|logit|), logprobs within LP_TOL (3e-2: both caches hold bf16 K/V);
  seeded sampled requests in the port's
  engines: single steps, k-step blocks, alone and batched bit for bit, the
  paged engine up to a near-tie of the noisy scores.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptq_gguf_tpu.serving import engine as jengine, model as jmodel, sampling as jsamp
from gptq_gguf_tpu_torch import __main__ as cli
from gptq_gguf_tpu_torch.serving import engine, model as qmodel, sampling
from gptq_gguf_tpu_torch.serving.sampling import SamplingParams as SP
from tests.test_torch_serving import LOGIT_TOL, gguf  # noqa: F401

V = 256
TOP_P_EDGE = 1e-5
# both packages' caches hold bf16 K/V and sum attention in other orders
LP_TOL = 3e-2
F32_MIN = float(np.finfo(np.float32).min)

ROWS = [
    SP(),
    SP(temperature=0.7),
    SP(temperature=1.0, top_k=5),
    SP(temperature=1.3, top_p=0.9),
    SP(temperature=0.8, top_p=0.5, top_k=40),
    SP(temperature=1.0, min_p=0.05),
    SP(temperature=0.6, top_k=20, top_p=0.95, min_p=0.02),
    SP(repetition_penalty=1.3),
    SP(temperature=0.9, presence_penalty=0.5, frequency_penalty=0.3),
    SP(temperature=1.1, repetition_penalty=1.2, top_k=10),
    SP(temperature=0.5, top_p=0.3, repetition_penalty=0.8, frequency_penalty=-0.2),
    SP(temperature=1.0, top_k=1),
]


def _jsp(sp):
    return jsamp.SamplingParams(**dataclasses.asdict(sp))


def _states(rows, prompts, seeds=None):
    """The same slots in both packages: (JAX state, port state)."""
    B = len(rows)
    js = jsamp.init_state(B, V)
    ts = sampling.init_state(B, V)
    for i, (sp, p) in enumerate(zip(rows, prompts)):
        fb = 1000 + i if seeds is None else seeds[i]
        js = jsamp.set_slot(js, i, _jsp(sp), np.asarray(p), fallback_seed=fb)
        sampling.set_slot(ts, i, sp, torch.as_tensor(p), fallback_seed=fb)
    return js, ts


def _inputs(scale, seed=0, rows=ROWS):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((len(rows), V)) * scale).astype(np.float32)
    # prompts with repeats and ids past V (counted modulo V)
    prompts = [rng.integers(0, 2 * V, size=int(rng.integers(1, 40))) for _ in rows]
    return logits, prompts


def _edge(s: np.ndarray, top_p: float) -> np.ndarray:
    """Elements of one row of scaled logits whose exclusive cumulative mass
    (f64, sorted descending) lies within TOP_P_EDGE of top_p."""
    order = np.argsort(-s, kind="stable")
    e = np.exp(s[order].astype(np.float64) - s.max())
    p = e / e.sum()
    excl = np.cumsum(p) - p
    out = np.zeros(s.shape, bool)
    out[order] = np.abs(excl - top_p) <= TOP_P_EDGE
    return out


@pytest.mark.parametrize("scale,seed", [(1.0, 0), (3.0, 1), (6.0, 2)])
def test_chain_matches_jax(scale, seed):
    logits, prompts = _inputs(scale, seed)
    js, ts = _states(ROWS, prompts)
    jm, jl, jg = (np.asarray(a) for a in jsamp._chain(jnp.asarray(logits), js))
    tm, tl, tg = (a.numpy() for a in sampling._chain(torch.from_numpy(logits), ts))
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tg, jg)
    jkeep, tkeep = jm > F32_MIN, tm > F32_MIN
    edges = 0
    for i, sp in enumerate(ROWS):
        t = 1.0 if sp.is_greedy else sp.temperature
        diff = jkeep[i] != tkeep[i]
        assert not diff[~_edge(tl[i] / t, sp.top_p)].any(), f"row {i}: masks differ"
        edges += int(diff.sum())
        both = jkeep[i] & tkeep[i]
        np.testing.assert_allclose(tm[i][both], jm[i][both], rtol=1e-6, atol=1e-6)
        assert tkeep[i].any()
    print(f"mask elements that differ at the top_p edge: {edges}")


def test_set_slot_counts_and_rows_bit_equal():
    _, prompts = _inputs(1.0, 5)
    js, ts = _states(ROWS, prompts)
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    for name in ("temperature", "top_k", "top_p", "min_p", "presence", "frequency",
                 "repetition"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    # a re-admit resets the row: no count of the previous prompt is left
    sampling.set_slot(ts, 3, ROWS[3], torch.as_tensor(prompts[0]))
    js = jsamp.set_slot(js, 3, _jsp(ROWS[3]), np.asarray(prompts[0]))
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))


def _replicated(ts, row: int, n: int):
    """n copies of one slot, draw counters 0..n-1."""
    st = sampling.SlotSampling(*(t if name == "vocab_hash" else
                                 t[row:row + 1].expand(n, *t.shape[1:]).clone()
                                 for name, t in zip(sampling.SlotSampling._fields, ts)))
    st.draws.copy_(torch.arange(n))
    return st


@pytest.mark.parametrize("row", [2, 3, 6, 9])
def test_draws_follow_jax_masked_softmax(row):
    N = 4096
    logits, prompts = _inputs(2.0, 3)
    js, ts = _states(ROWS, prompts)
    jm = np.asarray(jsamp._chain(jnp.asarray(logits), js)[0])[row].astype(np.float64)
    p = np.where(jm > F32_MIN, np.exp(jm - jm.max()), 0.0)
    p /= p.sum()
    st = _replicated(ts, row, N)
    toks = sampling.sample(torch.from_numpy(logits[row:row + 1]).expand(N, V), st).numpy()
    freq = np.bincount(toks, minlength=V) / N
    assert freq[p == 0].sum() == 0  # exactly no draw outside JAX's mask
    bound = 5 * np.sqrt(p * (1 - p) / N) + 1.0 / N
    assert (np.abs(freq - p) <= bound).all(), np.abs(freq - p).max()
    print(f"row {row}: {int((p > 0).sum())} kept, max |freq - p| {np.abs(freq - p).max():.4f}")


def test_greedy_rows_are_jax_argmax():
    logits, prompts = _inputs(2.0, 4)
    js, ts = _states(ROWS, prompts)
    import jax

    want = np.asarray(jsamp.sample(jnp.asarray(logits), js, jax.random.PRNGKey(0)))
    got = sampling.sample(torch.from_numpy(logits), ts).numpy()
    greedy = np.asarray([sp.is_greedy for sp in ROWS])
    np.testing.assert_array_equal(got[greedy], want[greedy])
    # top_k = 1 at temperature 1 is the penalized argmax too
    np.testing.assert_array_equal(got[-1], logits[-1].argmax())


def test_slot_and_batch_invariance():
    """A request's draws are the same bits whatever its slot and batch-mates;
    sample_slot is its row of sample; sample_step advances every counter."""
    logits, prompts = _inputs(2.0, 6)
    order = [5, 2, 9, 0, 6, 11, 3]  # the same requests, other slots and mates
    seeds = [70 + i for i in range(len(ROWS))]
    _, ta = _states(ROWS, prompts, seeds)
    _, tb = _states([ROWS[i] for i in order], [prompts[i] for i in order],
                    [seeds[i] for i in order])
    for st in (ta, tb):
        st.draws.fill_(3)
    la = torch.from_numpy(logits)
    lb = la[order]
    noise_a = sampling.gumbel_noise(ta.seeds, ta.draws, ta.vocab_hash)
    noise_b = sampling.gumbel_noise(tb.seeds, tb.draws, tb.vocab_hash)
    assert torch.equal(noise_a[order], noise_b)
    ka, kb = sampling.sample(la, ta), sampling.sample(lb, tb)
    assert torch.equal(ka[order], kb)
    for j, i in enumerate(order):
        tok, _ = sampling.sample_slot(lb[j], tb, j)
        assert int(tok) == int(ka[i]) and int(tb.draws[j]) == 4
    toks, st = sampling.sample_step(la, ta)
    assert torch.equal(toks, ka) and st.draws.tolist() == [4] * len(ROWS)
    # a new seed, or the next draw, moves the noise
    assert not torch.equal(sampling.gumbel_noise(ta.seeds + 1, ta.draws, ta.vocab_hash),
                           sampling.gumbel_noise(ta.seeds, ta.draws, ta.vocab_hash))


def test_noise_is_finite_at_the_extreme_bits():
    """The uniform of the smallest and largest hashed bits stays inside
    (0, 1) in f32, so no element's noise is infinite (an infinite noise
    would draw a masked token)."""
    bits = torch.tensor([0, 511, 1 << 31, (1 << 32) - 512, (1 << 32) - 1], dtype=torch.int64)
    u = sampling._uniform(bits)
    assert ((u > 0) & (u < 1)).all()
    assert torch.isfinite(-torch.log(-torch.log(u))).all()
    assert u[0] == u[1] == 2.0 ** -24 and u[-1] == u[-2] == 1 - 2.0 ** -24


def test_topk_logprobs_match_jax():
    rng = np.random.default_rng(8)
    logits = (rng.standard_normal((4, V)) * 3).astype(np.float32)
    logits[1, 10:14] = logits[1].max() + 1.0  # a four-way tie at the top
    chosen = rng.integers(0, V, size=4).astype(np.int32)
    for k in (1, 3, 5):
        jv, ji, jc = (np.asarray(a) for a in
                      jengine._topk_logprobs(jnp.asarray(logits), jnp.asarray(chosen), k))
        tv, ti, tc = (a.numpy() for a in
                      engine._topk_logprobs(torch.from_numpy(logits), torch.from_numpy(chosen), k))
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-5)
        for b in range(4):  # ids equal, or tied with the same value
            for a, j, v in zip(ti[b], ji[b], jv[b]):
                assert a == j or abs(logits[b, a] - logits[b, j]) <= 1e-6, (k, b)


# ---------------------------------------------------------------------------
# Engines on the tiny GGUF
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense(gguf):  # noqa: F811
    jp, jcfg = jmodel.load_gguf_for_serving(gguf, dtype=jnp.float32, dense=True)
    tp, tcfg = qmodel.load_gguf_for_serving(gguf, dtype=torch.float32, device="cpu",
                                            dense=True)
    return jp, jcfg, tp, tcfg


def _scores(params, cfg, prompt, out, t, sp):
    """The port's logits, penalized logits and masked scaled scores (one
    row) before output position t of a request, the noise of its draw t."""
    ctx = np.concatenate([np.asarray(prompt), np.asarray(out[:t], np.int64)]).astype(np.int64)
    cache = qmodel.init_cache(cfg, 1, len(ctx) + 1, dtype=cfg.dtype, device="cpu")
    logits, _ = qmodel.forward_cached(params, cfg, torch.from_numpy(ctx)[None], cache)
    st = sampling.init_state(1, cfg.vocab_size)
    sampling.set_slot(st, 0, sp, torch.from_numpy(ctx))
    masked, pen, _ = sampling._chain(logits, st)
    st.draws.fill_(t)
    noise = sampling.gumbel_noise(st.seeds, st.draws, st.vocab_hash)
    return logits[0], pen[0], masked[0], noise[0]


def _near_tie(params, cfg, prompt, out, t, sp) -> bool:
    """Whether output position t may flip between two runs whose logits
    differ in their last bits: its top-2 gap (the penalized logits for a
    greedy request, raw at the prefill's token; masked + noise, in logit
    units, for a sampled one) is below LOGIT_TOL of max|logit|."""
    logits, pen, masked, noise = _scores(params, cfg, prompt, out, t, sp)
    if sp.is_greedy:
        row = logits if t == 0 else pen
    else:
        row = (masked + noise) * sp.temperature
    top2 = torch.topk(row, 2).values
    return float(top2[0] - top2[1]) < LOGIT_TOL * float(logits.abs().max())


def _compare(a, b, params, cfg, reqs):
    """Streams of the same requests, equal up to the first near-tie."""
    compared = []
    for uid, (p, n, sp) in enumerate(reqs, start=1):
        x, y = a[uid].output, b[uid].output
        assert len(x) == len(y) == n
        t = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v), None)
        compared.append(n if t is None else t)
        if t is not None:
            assert _near_tie(params, cfg, p, x, t, sp), f"request {uid} step {t}"
    return compared


def _run(eng, reqs, logprobs=0):
    for p, n, sp in reqs:
        eng.submit(p, max_new_tokens=n, sampling_params=sp, logprobs=logprobs)
    return {r.uid: r for r in eng.run_until_done(max_steps=500)}


def _engines(kind, jp, jcfg, tp, tcfg):
    if kind == "paged":
        kw = dict(num_slots=2, max_len=64, page_size=8)
        return (jengine.PagedContinuousBatchingEngine(jp, jcfg, **kw),
                engine.PagedContinuousBatchingEngine(tp, tcfg, device="cpu", **kw))
    kw = dict(num_slots=2, max_len=64, multi_step=4)
    return (jengine.ContinuousBatchingEngine(jp, jcfg, **kw),
            engine.ContinuousBatchingEngine(tp, tcfg, **kw))


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_penalized_and_logprob_streams_match_jax(dense, kind):
    """Greedy requests with penalties (the sampled step's argmax path) and
    logprob requests (single steps) in both packages' engines."""
    jp, jcfg, tp, tcfg = dense
    rng = np.random.default_rng(21)
    sps = [SP(repetition_penalty=1.3), SP(presence_penalty=0.8, frequency_penalty=0.4),
           SP(repetition_penalty=0.9, frequency_penalty=0.2), SP()]
    reqs = [(rng.integers(0, V, size=int(rng.integers(4, 20))), 8, sp) for sp in sps]
    je, te = _engines(kind, jp, jcfg, tp, tcfg)
    jd = _run(je, [(p, n, _jsp(sp)) for p, n, sp in reqs], logprobs=3)
    td = _run(te, reqs, logprobs=3)
    compared = _compare(td, jd, tp, tcfg, reqs)
    worst = 0.0
    for uid, n in enumerate(compared, start=1):
        a, b = td[uid].logprob_data, jd[uid].logprob_data
        assert len(a) == len(b) == len(td[uid].output)
        for (ca, ia, va), (cb, ib, vb) in list(zip(a, b))[:n]:
            worst = max(worst, abs(ca - cb), *np.abs(np.subtract(va, vb)))
            # ids equal, but where a value is within 2 LP_TOL of a neighbour
            # (the list's last entry may also tie with the next, unseen one)
            gaps = np.abs(np.diff(va))
            for j in range(len(va) - 1):
                near = min(gaps[j], gaps[j - 1] if j else np.inf)
                assert ia[j] == ib[j] or near <= 2 * LP_TOL, (ia, ib, va)
    assert worst <= LP_TOL, worst
    print(f"{kind}: tokens compared per request {compared}, max |dlogprob| {worst:.2e}")


def test_seeded_streams_across_blocks_slots_and_engines(dense):
    """Seeded sampled requests: single steps, k-step blocks, other slots and
    batch-mates, and alone give the same tokens bit for bit in the
    contiguous engine; the paged engine agrees up to a near-tie."""
    _, _, tp, tcfg = dense
    rng = np.random.default_rng(22)
    sps = [SP(temperature=0.9, top_k=30, seed=5), SP(temperature=1.2, top_p=0.9, seed=6),
           SP(temperature=0.7, min_p=0.05, repetition_penalty=1.2, seed=7)]
    reqs = [(rng.integers(0, V, size=int(rng.integers(4, 20))), 10, sp) for sp in sps]
    mates = [(rng.integers(0, V, size=6), 7, SP(temperature=1.0))] * 2

    def contiguous(rs, k, slots=2):
        return _run(engine.ContinuousBatchingEngine(tp, tcfg, num_slots=slots, max_len=64,
                                                    multi_step=k), rs)

    single = contiguous(reqs, 1)
    for other in (contiguous(reqs, 4), contiguous(list(reversed(reqs)), 4, slots=3)):
        outs = sorted(r.output for r in other.values())
        assert outs == sorted(r.output for r in single.values())
    mixed = contiguous(mates + reqs, 8, slots=3)
    for uid in (1, 2, 3):
        assert mixed[uid + 2].output == single[uid].output
    alone = contiguous(reqs[1:2], 1, slots=1)
    assert alone[1].output == single[2].output
    paged = _run(engine.PagedContinuousBatchingEngine(tp, tcfg, num_slots=2, max_len=64,
                                                      page_size=8, device="cpu"), reqs)
    print("paged vs contiguous, tokens compared:", _compare(paged, single, tp, tcfg, reqs))
    assert len({tuple(r.output) for r in single.values()}) == 3


def test_generate_sampled(dense):
    """generate(temperature > 0, seed): the prefill's token is the argmax,
    a seed repeats its draws and another moves them; a temperature near 0
    is greedy (as JAX's is)."""
    jp, jcfg, tp, tcfg = dense
    prompts = [np.arange(5) + 3, np.arange(9) * 7 % V]
    a = engine.generate(tp, tcfg, prompts, 8, temperature=0.9, seed=3)
    assert a == engine.generate(tp, tcfg, prompts, 8, temperature=0.9, seed=3)
    b = engine.generate(tp, tcfg, prompts, 8, temperature=0.9, seed=4)
    greedy = engine.generate(tp, tcfg, prompts, 8)
    assert a != b and [x[0] for x in a] == [x[0] for x in greedy]
    assert all(0 <= t < V for row in a + b for t in row)
    cold = engine.generate(tp, tcfg, prompts, 8, temperature=1e-4, seed=3)
    jcold = jengine.generate(jp, jcfg, prompts, 8, temperature=1e-4, seed=3)
    for p, x, y in zip(prompts, cold, jcold):
        t = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v), None)
        assert t is None or _near_tie(tp, tcfg, p, x, t, SP())
    assert cold == greedy


def test_serve_cli_benchmark_with_kv_dtype(gguf, capsys):  # noqa: F811
    """``serve --benchmark --kv-dtype int4`` on the tiny GGUF: one JSON line
    with the JAX CLI's keys."""
    cli.main(["serve", "--gguf-file", str(gguf), "--benchmark", "--kv-dtype", "int4",
              "--num-slots", "2", "--max-len", "64", "--benchmark-steps", "2",
              "--benchmark-prompt-len", "8", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(rec) == ["batch", "kv_dtype", "max_len", "ms_per_step", "prefill_s_total",
                           "prompt_len", "tokens_per_s"]
    assert rec["kv_dtype"] == "int4" and rec["batch"] == 2 and rec["tokens_per_s"] > 0
