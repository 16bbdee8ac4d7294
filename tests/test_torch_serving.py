"""The port's serving slice against the JAX package on a tiny Q4_K_M GGUF.

A tiny HF llama (hidden 512, 4 heads of 128, 2 KV heads, intermediate
1024, 2 layers, vocab 256: every d_out is a multiple of 256, so JAX's
dispatch takes its Pallas kernels) is packed to a GGUF and converted with
llama-quantize's Q4_K_M recipe by the JAX package, then loaded by both
loaders, in the default v2 format and (``RUNTIME_FORMAT`` set in both
packages) in v1 and v4. JAX runs its Pallas kernels in interpret mode
(FORCE_PALLAS_INTERPRET), the port its kernels' plain versions: both do
the same arithmetic (v2 and v4 round weights and activations to bf16 the
same way, v1 is f32 throughout), so greedy token streams agree up to
near-ties. The same holds for serving params built from dense weights and
GPTQ artifacts (``quantize_params_for_serving``) in all three formats."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptq_gguf_tpu.formats.ggml import GGMLQuantizationType as T
from gptq_gguf_tpu.ops import qmatmul as jq
from gptq_gguf_tpu.serving import engine as jengine, model as jmodel
from gptq_gguf_tpu_torch import __main__ as cli
from gptq_gguf_tpu_torch.models import llama
from gptq_gguf_tpu_torch.ops import qmatmul, qmv4
from gptq_gguf_tpu_torch.ops.qmatmul import RuntimeQuantLinearV2
from gptq_gguf_tpu_torch.serving import engine, model as qmodel

PLANES = ("qs", "d_sg", "dmin_sg", "sc_q", "mn_q")
INTS = ("d_in", "group_size", "per_byte", "shift", "d_rep")
# (planes, other fields) of each packed format; the classes of the two
# packages share their names
FIELDS = {"RuntimeQuantLinearV2": (PLANES, INTS),
          "RuntimeQuantLinear": (("qs", "scale_t", "offset_t"), ("d_in", "group_size", "per_byte")),
          "RuntimeQuantLinearV4": (("qs", "scale", "offc"),
                                   ("d_in", "group_size", "per_byte", "layout"))}
# logits of the two packages agree to this fraction of max|logit| (see
# test_forward_cached_logits); a greedy step whose top-2 gap is below that
# may legitimately flip, and the streams are compared up to it
LOGIT_TOL = 2e-2


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    from transformers import AutoConfig, AutoModelForCausalLM

    from gptq_gguf_tpu.export import packer
    from gptq_gguf_tpu.quant import recipes
    from tests.test_packer import write_tiny_tokenizer

    tmp = tmp_path_factory.mktemp("torch_serving")
    hf = AutoConfig.for_model(
        model_type="llama", vocab_size=256, hidden_size=512,
        intermediate_size=1024, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=2048,
        torch_dtype="float32", initializer_range=0.1)  # peakier logits than 0.02
    torch.manual_seed(17)
    m = AutoModelForCausalLM.from_config(hf).eval().float()
    d = tmp / "m"
    m.save_pretrained(d, safe_serialization=True)
    write_tiny_tokenizer(d)
    f16 = tmp / "f16.gguf"
    packer.pack_model(d, tmp / "none", f16)
    out = tmp / "q4km.gguf"
    recipes.llama_quantize(f16, out, "Q4_K_M")
    return out


@pytest.fixture(scope="module")
def loaded(gguf):
    jp, jcfg = jmodel.load_gguf_for_serving(gguf, dtype=jnp.float32)
    tp, tcfg = qmodel.load_gguf_for_serving(gguf, dtype=torch.float32, device="cpu")
    return jp, jcfg, tp, tcfg


def _numpy_tree(v):
    """JAX serving params -> the numpy tree params_from_numpy takes."""
    if type(v).__name__ in FIELDS:
        planes, fields = FIELDS[type(v).__name__]
        out = {k: None if getattr(v, k) is None else np.asarray(getattr(v, k))
               for k in planes}
        out.update({k: getattr(v, k) for k in fields})
        return out
    if isinstance(v, dict):
        return {k: _numpy_tree(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_numpy_tree(x) for x in v]
    return np.asarray(v)


def _bits(a):
    """Exact numpy view of a numpy array or a tensor (bf16 as its bits)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_tree_equal(a, b, path="params"):
    """a: port params; b: port params or the numpy tree of JAX params."""
    if type(a).__name__ in FIELDS:
        planes, fields = FIELDS[type(a).__name__]
        assert isinstance(b, dict) or type(b) is type(a), path
        for k in planes:
            x, y = getattr(a, k), b[k] if isinstance(b, dict) else getattr(b, k)
            assert (x is None) == (y is None), f"{path}.{k}"
            if x is not None:
                x, y = _bits(x), _bits(y)
                assert x.dtype == y.dtype, f"{path}.{k}"
                np.testing.assert_array_equal(x, y, err_msg=f"{path}.{k}")
        for k in fields:
            assert getattr(a, k) == (b[k] if isinstance(b, dict) else getattr(b, k))
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        y = b.numpy() if isinstance(b, torch.Tensor) else b
        np.testing.assert_array_equal(a.numpy(), y, err_msg=path)


def test_loaders_agree(loaded):
    jp, jcfg, tp, tcfg = loaded
    assert llama.config_from_reference(jcfg) == tcfg
    assert isinstance(tp["lm_head"], RuntimeQuantLinearV2)
    assert tp["lm_head"].d_out == 512  # vocab padded to a multiple of 512
    _assert_tree_equal(tp, _numpy_tree(jp))  # packed planes byte-equal
    again = qmodel.params_from_numpy(_numpy_tree(jp), tcfg, device="cpu")
    _assert_tree_equal(again, tp)


def test_forward_cached_logits(loaded, monkeypatch):
    """Prefill plus 3 decode steps, the same tokens fed to both. Tolerance
    LOGIT_TOL of max|logit|: the f32 sums run in another order, so an
    activation rounded to bf16 at a kernel input (or a cache entry) moves
    by one bf16 ulp now and then, and the RMSNorms of this random model's
    small residual stream amplify that; argmax must agree wherever the
    top-2 gap exceeds the tolerance."""
    monkeypatch.setattr(jq, "FORCE_PALLAS_INTERPRET", True)
    jp, jcfg, tp, tcfg = loaded
    jp = jmodel.fuse_params_for_serving(jp, jcfg)
    tp = qmodel.fuse_params_for_serving(tp, tcfg)
    assert "gateup_proj" in tp["layers"][0]
    _check_forward_logits(jp, jcfg, tp, tcfg)


@pytest.mark.parametrize("variant,runs", [("v2m", {"v2m", "v2p"}), ("v2", {"v2"}),
                                          ("v2h", {"v2h"}), ("v2s", {"v2s", "v2g"})],
                         ids=["v2m", "v2", "v2h", "v2s"])
def test_forward_cached_logits_under_variant(loaded, monkeypatch, variant, runs):
    """test_forward_cached_logits with PALLAS_V2_VARIANT set in both
    packages: JAX's v2m bodies (v2p on the Q6_K weights), v2 body, v2h
    body or v2s body (v2g on the Q6_K weights) in interpret mode against
    the port's plain versions of the same variants. JAX's eager forward_cached passes the variant to its jitted
    dequant_matmul_pallas_v2 as a static argument, so every call picks up
    the knob (its engine's jitted step would keep the variant of its first
    trace)."""
    monkeypatch.setattr(jq, "FORCE_PALLAS_INTERPRET", True)
    seen = {"jax": set(), "port": set()}
    pallas_v2 = jq.dequant_matmul_pallas_v2

    def jax_spy(x, rql, **kw):
        seen["jax"].add(jq._effective_v2_variant(kw["variant"], gs=rql.group_size,
                                                 per_byte=rql.per_byte,
                                                 tile_in=kw["tile_in"], B=x.shape[0]))
        return pallas_v2(x, rql, **kw)

    monkeypatch.setattr(jq, "dequant_matmul_pallas_v2", jax_spy)
    for v, name in qmatmul.V2_WRAPPERS.items():
        fn = getattr(qmatmul, name)
        monkeypatch.setattr(qmatmul, name, lambda x, rql, mxu=torch.bfloat16, _v=v, _fn=fn:
                            seen["port"].add(_v) or _fn(x, rql, mxu))
    for mod in (jq, qmatmul):
        monkeypatch.setattr(mod, "PALLAS_V2_VARIANT", variant)
    jp, jcfg, tp, tcfg = loaded
    _check_forward_logits(jmodel.fuse_params_for_serving(jp, jcfg), jcfg,
                          qmodel.fuse_params_for_serving(tp, tcfg), tcfg)
    assert seen["jax"] == seen["port"] == runs


def _check_forward_logits(jp, jcfg, tp, tcfg):
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 256, size=(2, 12))
    jc = jmodel.init_cache(jcfg, 2, 64)
    tc = qmodel.init_cache(tcfg, 2, 64, device="cpu")
    for step in range(4):
        jl, jc = jmodel.forward_cached(jp, jcfg, jnp.asarray(ids), jc)
        tl, tc = qmodel.forward_cached(tp, tcfg, torch.from_numpy(ids), tc)
        want = np.asarray(jl)
        got = tl.numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LOGIT_TOL * np.abs(want).max(), err_msg=f"step {step}")
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > LOGIT_TOL * np.abs(want).max()
        np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
        ids = want.argmax(-1)[:, None]


def _first_flip_is_a_tie(params, cfg, prompt, out, t):
    """Top-2 gap of the port's logits at output position t."""
    ctx = np.concatenate([np.asarray(prompt), np.asarray(out[:t])]).astype(np.int64)
    cache = qmodel.init_cache(cfg, 1, len(ctx) + 1, device="cpu")
    logits, _ = qmodel.forward_cached(params, cfg, torch.from_numpy(ctx)[None], cache)
    top2 = torch.topk(logits[0], 2).values
    return float(top2[0] - top2[1]) < LOGIT_TOL * float(logits.abs().max())


@pytest.mark.parametrize("max_len", [128, 1024])  # 1024: the chunked decode path
def test_engine_token_streams_match_jax(loaded, monkeypatch, max_len):
    monkeypatch.setattr(jq, "FORCE_PALLAS_INTERPRET", True)
    jp, jcfg, tp, tcfg = loaded
    _check_engine_streams(jp, jcfg, tp, tcfg, max_len)


def _check_engine_streams(jp, jcfg, tp, tcfg, max_len):
    jp = jmodel.fuse_params_for_serving(jp, jcfg)
    tp = qmodel.fuse_params_for_serving(tp, tcfg)
    rng = np.random.default_rng(max_len)
    reqs = [(rng.integers(0, 256, size=int(rng.integers(4, 40))), int(rng.integers(6, 15)))
            for _ in range(5)]
    je = jengine.ContinuousBatchingEngine(jp, jcfg, num_slots=2, max_len=max_len,
                                          multi_step=4)
    te = engine.ContinuousBatchingEngine(tp, tcfg, num_slots=2, max_len=max_len,
                                         multi_step=4)
    for p, n in reqs:
        je.submit(p, max_new_tokens=n)
        te.submit(p, max_new_tokens=n)
    jd = {r.uid: r.output for r in je.run_until_done()}
    td = {r.uid: r.output for r in te.run_until_done()}
    assert sorted(td) == sorted(jd) == [1, 2, 3, 4, 5]
    compared = []
    for uid, (p, n) in enumerate(reqs, start=1):
        a, b = td[uid], jd[uid]
        assert len(a) == len(b) == n
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        compared.append(n if t is None else t)
        if t is not None:
            assert _first_flip_is_a_tie(tp, tcfg, p, a, t), f"request {uid} step {t}"
            print(f"request {uid}: streams agree up to a near-tie at step {t}; "
                  "compared that far")
    print("tokens compared per request:", compared)


def test_serve_cli_matches_generate(gguf, capsys):
    cli.main(["serve", "--gguf-file", str(gguf), "--prompt-tokens", "5", "6", "7",
              "--max-new-tokens", "6", "--max-len", "64", "--num-slots", "1",
              "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0].startswith("generated 6 tokens")
    tp, tcfg = qmodel.load_gguf_for_serving(gguf, device="cpu")  # bf16, as serve loads
    assert tcfg.dtype == torch.bfloat16
    tp = qmodel.fuse_params_for_serving(tp, tcfg)
    want = engine.generate(tp, tcfg, [np.asarray([5, 6, 7])], max_new_tokens=6,
                           max_len=64)[0]
    assert printed[-1] == str(want)


def _serve(params, cfg, prompts, max_new=8):
    eng = engine.ContinuousBatchingEngine(params, cfg, num_slots=1, max_len=128)
    ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = {r.uid: r.output for r in eng.run_until_done()}
    return [done[i] for i in ids], eng


def test_prefix_reuse_matches_cold(loaded):
    """Turn 2 re-sends turn 1's conversation into the retiring slot: the
    shared KV prefix is reused and the reply equals a cold engine's."""
    _, _, tp, tcfg = loaded
    tp = qmodel.fuse_params_for_serving(tp, tcfg)
    rng = np.random.default_rng(56)
    turn1 = rng.integers(0, 256, size=10)
    [reply1], _ = _serve(tp, tcfg, [turn1])
    turn2 = np.concatenate([turn1, reply1, rng.integers(0, 256, size=4)])
    [cold2], cold = _serve(tp, tcfg, [turn2])
    assert cold.prefix_hits == 0
    [warm1, warm2], warm = _serve(tp, tcfg, [turn1, turn2])
    assert warm.prefix_hits == 1 and warm.prefix_tokens_reused >= len(turn1)
    assert warm1 == reply1 and warm2 == cold2


def test_cancel_frees_the_slot(loaded):
    _, _, tp, tcfg = loaded
    eng = engine.ContinuousBatchingEngine(tp, tcfg, num_slots=1, max_len=64)
    a = eng.submit(np.arange(5), max_new_tokens=20)
    b = eng.submit(np.arange(3), max_new_tokens=4)
    eng.step()  # admits a
    assert eng.cancel(a) and not eng.cancel(a)
    assert int(eng.cache.lengths[0]) == 0 and eng.slot_req[0] is None
    done = eng.run_until_done()
    assert [r.uid for r in done] == [b] and len(done[0].output) == 4


@pytest.fixture(scope="module", params=["v1", "v4"])
def loaded_fmt(request, gguf):
    """The GGUF loaded by both packages with RUNTIME_FORMAT set to v1 / v4."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jq, "RUNTIME_FORMAT", request.param)
        mp.setattr(qmatmul, "RUNTIME_FORMAT", request.param)
        jp, jcfg = jmodel.load_gguf_for_serving(gguf, dtype=jnp.float32)
        tp, tcfg = qmodel.load_gguf_for_serving(gguf, dtype=torch.float32, device="cpu")
    return request.param, jp, jcfg, tp, tcfg


def test_loaders_agree_in_format(loaded_fmt):
    """Planes byte-equal in v1 / v4, the lm_head unpadded (only v2 pads),
    the JAX params carried across, and fusion as in the JAX package: v4
    parts of one type fuse, a Q4_K_M layer's mixed q/k/v stay apart, v1
    never fuses."""
    fmt, jp, jcfg, tp, tcfg = loaded_fmt
    cls = qmatmul.RuntimeQuantLinear if fmt == "v1" else qmv4.RuntimeQuantLinearV4
    assert type(tp["lm_head"]) is cls and tp["lm_head"].d_out == tcfg.vocab_size == 256
    assert all(type(v) is cls for layer in tp["layers"] for k, v in layer.items()
               if k.endswith("_proj"))
    _assert_tree_equal(tp, _numpy_tree(jp))
    _assert_tree_equal(qmodel.params_from_numpy(_numpy_tree(jp), tcfg, device="cpu"), tp)
    jf = jmodel.fuse_params_for_serving(jp, jcfg)
    tf = qmodel.fuse_params_for_serving(tp, tcfg)
    _assert_tree_equal(tf, _numpy_tree(jf))
    fused = [k for layer in tf["layers"] for k in layer if k in ("qkv_proj", "gateup_proj")]
    assert (fused == []) == (fmt == "v1")


def test_forward_cached_logits_in_format(loaded_fmt, monkeypatch):
    """test_forward_cached_logits in v1 / v4: JAX's v1 or v4 Pallas
    kernels in interpret mode against the port's plain versions."""
    monkeypatch.setattr(jq, "FORCE_PALLAS_INTERPRET", True)
    _, jp, jcfg, tp, tcfg = loaded_fmt
    _check_forward_logits(jmodel.fuse_params_for_serving(jp, jcfg), jcfg,
                          qmodel.fuse_params_for_serving(tp, tcfg), tcfg)


def test_engine_token_streams_match_jax_in_format(loaded_fmt, monkeypatch):
    monkeypatch.setattr(jq, "FORCE_PALLAS_INTERPRET", True)
    _, jp, jcfg, tp, tcfg = loaded_fmt
    _check_engine_streams(jp, jcfg, tp, tcfg, 128)


def test_load_gguf_dense(gguf, loaded):
    """dense=True: every tensor a dense array, the K-quant ones equal to
    the packed weights' dequantization, as in the JAX package."""
    jd, _ = jmodel.load_gguf_for_serving(gguf, dtype=jnp.float32, dense=True)
    td, tcfg = qmodel.load_gguf_for_serving(gguf, dtype=torch.float32, device="cpu",
                                            dense=True)
    _assert_tree_equal(td, _numpy_tree(jd))
    tp = loaded[2]
    for key in ("q_proj", "down_proj"):
        np.testing.assert_array_equal(td["layers"][1][key].numpy(),
                                      qmatmul.dequantize_runtime_v2(tp["layers"][1][key]).numpy())
    np.testing.assert_array_equal(td["lm_head"].numpy(),
                                  qmatmul.dequantize_runtime_v2(tp["lm_head"])[:256].numpy())


@pytest.fixture(scope="module")
def artifacts_dir(gguf, tmp_path_factory):
    """RTN artifacts of the tiny checkpoint's block linears (Q4_K, Q6_K for
    down_proj), written by the JAX package."""
    from gptq_gguf_tpu.models import loader as jloader
    from gptq_gguf_tpu.ops import kquant as jk
    from gptq_gguf_tpu.quant import artifacts as jart

    d = gguf.parent / "m"
    cfg = jloader.load_config(d)
    params = jloader.load_params(d, cfg)
    out = tmp_path_factory.mktemp("torch_serving_arts")
    for li, layer in enumerate(params["layers"]):
        for key in llama.BLOCK_LINEAR_KEYS:
            qt = T.Q6_K if key == "down_proj" else T.Q4_K
            q, p = jk.quantize_rtn(layer[key], qt)
            mod = "self_attn" if key[0] in "qkvo" else "mlp"
            jart.save_layer(out, f"model.layers.{li}.{mod}.{key}",
                            jart.LayerArtifact.from_result(qt, q, p))
    return d, out


@pytest.mark.parametrize("fmt", ["v1", "v2", "v4"])
def test_quantize_params_for_serving_matches_jax(artifacts_dir, fmt, monkeypatch):
    """One artifacts dir read by both packages: packed planes byte-equal,
    dense tensors equal; a prefill's logits within LOGIT_TOL of max|logit|
    (JAX's kernels in interpret mode, the port's plain versions)."""
    from gptq_gguf_tpu.models import loader as jloader
    from gptq_gguf_tpu_torch.models import loader

    d, arts = artifacts_dir
    monkeypatch.setattr(jq, "RUNTIME_FORMAT", fmt)
    monkeypatch.setattr(qmatmul, "RUNTIME_FORMAT", fmt)
    jcfg = jloader.load_config(d)
    jp = jmodel.quantize_params_for_serving(jloader.load_params(d, jcfg), jcfg, arts)
    tcfg = loader.load_config(d)
    tp = qmodel.quantize_params_for_serving(loader.load_params(d, tcfg), tcfg, arts,
                                            device="cpu")
    assert type(tp["layers"][0]["down_proj"]).__name__ == {
        "v1": "RuntimeQuantLinear", "v2": "RuntimeQuantLinearV2",
        "v4": "RuntimeQuantLinearV4"}[fmt]
    _assert_tree_equal(tp, _numpy_tree(jp))
    monkeypatch.setattr(jq, "FORCE_PALLAS_INTERPRET", True)
    ids = np.random.default_rng(4).integers(0, 256, size=(1, 10))
    jl, _ = jmodel.forward_cached(jp, jcfg, jnp.asarray(ids),
                                  jmodel.init_cache(jcfg, 1, 32, dtype=jnp.float32))
    tl, _ = qmodel.forward_cached(tp, tcfg, torch.from_numpy(ids),
                                  qmodel.init_cache(tcfg, 1, 32, dtype=torch.float32,
                                                    device="cpu"))
    want = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())


def test_quantize_params_for_serving_refuses_other_blocks(artifacts_dir):
    d, arts = artifacts_dir
    cfg = llama.LlamaConfig(vocab_size=256, hidden_size=512, intermediate_size=1024,
                            num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2)
    params = {"embed_tokens": torch.zeros(256, 512), "norm": torch.ones(512),
              "layers": [{"input_layernorm": torch.ones(512),
                          "experts_gate": torch.zeros(4, 1024, 512)}]}
    with pytest.raises(NotImplementedError, match="experts_gate"):
        qmodel.quantize_params_for_serving(params, cfg, arts, device="cpu")
