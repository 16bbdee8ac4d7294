"""The rest of the port's evals/ and the distillation helpers against the JAX
package, on the CPU.

One port-written tiny checkpoint (``evals/parity.py::
make_synthetic_checkpoint``, the ``tiny`` preset: hidden 256, 2 layers,
vocab 256) is loaded by both packages. Bounds:
- layer drops and compressed weights: the swapped weights bit-equal;
- ``compute_perplexity_layer_per_layer`` and every ``ppl`` option against
  JAX's command line: a relative 1e-4 (the dense bound of
  tests/test_torch_ppl.py: both run an f32 forward, sums in another order);
- lm-eval's scorers: within 1e-3 of JAX's and of an unbatched oracle (JAX's
  tests/test_lmeval.py), greedy flags equal; a sequence above 1024 tokens
  (the dense forward's flash path) scores the same padded or not;
- ``squarehead_loss`` and three ``masked_sgd`` steps against optax: 1e-6,
  pruned weights exactly 0;
- ``parity``: the report's keys equal JAX's, perplexities within 0.01
  nats/token (the two GPTQ walks agree on about 99% of codes, not all;
  measured 0.002).
"""

import importlib
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptq_gguf_tpu.__main__ import main as jmain
from gptq_gguf_tpu.evals import compress as jcompress
from gptq_gguf_tpu.evals import lmeval as jlmeval
from gptq_gguf_tpu.evals import ppl as jppl
from gptq_gguf_tpu.models import loader as jloader
from gptq_gguf_tpu_torch.__main__ import main
from gptq_gguf_tpu_torch.evals import compress, lmeval, parity, ppl
from gptq_gguf_tpu_torch.formats import safetensors
from gptq_gguf_tpu_torch.models import llama, loader
from gptq_gguf_tpu_torch.search import distill

PPL_ARGS = ["--datasets", "synthetic", "--eval_tokens", "256", "--sequence_length", "64"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("evals")
    d = parity.make_synthetic_checkpoint(tmp / "ckpt", "tiny", seed=5)
    cfg = loader.load_config(d)
    jcfg = jloader.load_config(d)
    return dict(tmp=tmp, ckpt=d, port=(loader.load_params(d, cfg), cfg),
                jax=(jloader.load_params(d, jcfg), jcfg))


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t)


def _assert_params_equal(tp, jp):
    for key in ("embed_tokens", "norm"):
        np.testing.assert_array_equal(_np(tp[key]), _np(jp[key]))
    for lt, lj in zip(tp["layers"], jp["layers"]):
        for key in llama.BLOCK_LINEAR_KEYS:
            np.testing.assert_array_equal(_np(lt[key]), _np(lj[key]))


# ---------------------------------------------------------------------------
# compress
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("modes", [["none", "attn"], ["mlp", "attn+mlp"]])
def test_layer_drops_match_jax(tiny, modes, tmp_path):
    (tmp_path / "drops.txt").write_text("\n".join(modes) + "\n\n")
    assert compress.load_drop_config(tmp_path / "drops.txt") == modes == \
        jcompress.load_drop_config(tmp_path / "drops.txt")
    tp = compress.apply_layer_drops(tiny["port"][0], modes)
    jp = jcompress.apply_layer_drops(tiny["jax"][0], modes)
    _assert_params_equal(tp, jp)
    for layer, mode in zip(tp["layers"], modes):
        assert bool(layer["o_proj"].any()) == (mode in ("none", "mlp"))
        assert bool(layer["down_proj"].any()) == (mode in ("none", "attn"))
    assert all(bool(layer["o_proj"].any()) for layer in tiny["port"][0]["layers"])  # input kept
    with pytest.raises(ValueError, match="bad drop mode"):
        compress.apply_layer_drops(tiny["port"][0], ["none", "mlp+attn"])


def _write_db(root, params, levels):
    """A database of f16 files near each linear's weight, one per level."""
    rng = np.random.default_rng(9)
    for name in llama.linear_layer_names(params[1]):
        w = llama.get_linear(params[0], name)
        for level in levels:
            noise = torch.from_numpy(rng.normal(size=w.shape).astype(np.float32)) * 1e-3
            (root / name).mkdir(parents=True, exist_ok=True)
            torch.save((w + noise).half(), root / name / f"{level}.pth")


def test_compressed_weights_match_jax(tiny, tmp_path):
    """Config levels "4" and "4.0" name 4.pth, the database's "4.5-Q4_K"
    its own file; without a config every layer at the default level. The
    swapped weights equal JAX's bit for bit and take the replaced weight's
    dtype."""
    db = tmp_path / "db"
    _write_db(db, tiny["port"], ("4", "0", "4.5-Q4_K"))
    names = llama.linear_layer_names(tiny["port"][1])
    cfg_path = tmp_path / "config.txt"
    cfg_path.write_text("\n".join(f"{n}: {('4', '4.0', '4.5-Q4_K (4.5-Q4_K.pth)')[i % 3]}"
                                  for i, n in enumerate(names)) + "\nno colon here\n")
    for args in ((db, cfg_path), (db, None, "4.5-Q4_K"), (db, None, 0)):
        tp = compress.load_compressed_weights(tiny["port"][0], *args)
        jp = jcompress.load_compressed_weights(tiny["jax"][0], *args)
        _assert_params_equal(tp, jp)
    w = torch.load(db / names[1] / "4.pth", weights_only=True)
    assert torch.equal(llama.get_linear(
        compress.load_compressed_weights(tiny["port"][0], db, cfg_path), names[1]), w.float())
    bf16 = {**tiny["port"][0], "layers": [{k: v.to(torch.bfloat16) for k, v in layer.items()}
                                          for layer in tiny["port"][0]["layers"]]}
    got = compress.load_sparse_weights(bf16, db, None, "0")
    assert got["layers"][0]["q_proj"].dtype == torch.bfloat16
    assert torch.equal(got["layers"][0]["q_proj"],
                       torch.load(db / names[0] / "0.pth", weights_only=True).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# perplexity: block by block, and the ppl command's options
# ---------------------------------------------------------------------------


def test_layer_per_layer_perplexity_matches_jax(tiny):
    rng = np.random.default_rng(4)
    seqs = [rng.integers(0, 256, size=(1, 48)) for _ in range(5)]
    want = jppl.compute_perplexity_layer_per_layer(*tiny["jax"], seqs, batch_size=2)
    got = ppl.compute_perplexity_layer_per_layer(*tiny["port"], seqs, batch_size=2,
                                                 device="cpu")
    plain = ppl.compute_perplexity(*tiny["port"], seqs, batch_size=2)
    assert abs(got - want) / want < 1e-4 and abs(got - plain) / plain < 1e-5, (got, want, plain)


def _ppl(m, argv, out):
    m(["ppl", *argv, *PPL_ARGS, "--output_path", str(out)])
    return json.loads(out.read_text())["synthetic"]


@pytest.mark.parametrize("case", ["config", "default_level", "drops_then_weights",
                                  "memory_efficient"])
def test_ppl_options_match_jax(tiny, tmp_path, case):
    """``ppl --model_name_or_path`` with the options, both command lines:
    within a relative 1e-4; each option moves the perplexity."""
    db = tmp_path / "db"
    _write_db(db, tiny["port"], ("4", "4.5-Q4_K"))
    names = llama.linear_layer_names(tiny["port"][1])
    (tmp_path / "config.txt").write_text("\n".join(f"{n}: 4.0" for n in names[:7]))
    (tmp_path / "drops.txt").write_text("none\nattn+mlp\n")
    argv = {"config": ["--compressed_weights_path", str(db), "--compressed_config_path",
                       str(tmp_path / "config.txt")],
            "default_level": ["--compressed_weights_path", str(db), "--default_level",
                              "4.5-Q4_K"],
            "drops_then_weights": ["--drop_layer_config", str(tmp_path / "drops.txt"),
                                   "--compressed_weights_path", str(db), "--default_level", "4"],
            "memory_efficient": ["--memory_efficient"]}[case]
    argv = ["--model_name_or_path", str(tiny["ckpt"]), *argv]
    want = _ppl(jmain, argv, tmp_path / "jax.json")
    got = _ppl(main, [*argv, "--device", "cpu"], tmp_path / "port.json")
    base = _ppl(main, ["--model_name_or_path", str(tiny["ckpt"]), "--device", "cpu"],
                tmp_path / "base.json")
    assert np.isfinite(got) and abs(got - want) / want < 1e-4, (got, want)
    if case == "memory_efficient":
        assert abs(got - base) / base < 1e-5
    else:
        assert abs(got - base) / base > 1e-4


@pytest.mark.parametrize("flag", [["--memory_efficient"], ["--drop_layer_config", "x.txt"],
                                  ["--compressed_weights_path", "db"]])
def test_ppl_serving_path_refuses_surgery(tiny, tmp_path, flag):
    """--gguf-path serving scores packed weights: with any of the options
    it exits with JAX's message, before reading them."""
    from gptq_gguf_tpu_torch.export import packer

    gguf = tmp_path / "m.gguf"
    packer.pack_model(tiny["ckpt"], None, gguf)
    with pytest.raises(SystemExit, match="cannot combine with --memory_efficient"):
        main(["ppl", "--gguf-file", str(gguf), "--gguf-path", "serving", "--device", "cpu",
              *flag])


# ---------------------------------------------------------------------------
# lm-eval's scorers and adapter
# ---------------------------------------------------------------------------


def _oracle(params, cfg, ctx, cont, max_length=2048):
    """One unpadded forward per request."""
    ids = (list(ctx) + list(cont))[-max_length:]
    nc = min(len(cont), len(ids) - 1)
    logits = llama.forward(params, torch.as_tensor([ids]), cfg)[0].double().numpy()
    lp, greedy = 0.0, True
    start = len(ids) - nc - 1
    for k, tok in enumerate(ids[len(ids) - nc:]):
        row = logits[start + k] - logits[start + k].max()
        lp += float(row[tok] - np.log(np.exp(row).sum()))
        greedy &= int(row.argmax()) == tok
    return lp, greedy


def test_score_continuations_match_jax_and_oracle(tiny):
    rng = np.random.default_rng(47)
    pairs = [(rng.integers(0, 256, int(rng.integers(3, 40))).tolist(),
              rng.integers(0, 256, int(rng.integers(1, 6))).tolist()) for _ in range(9)]
    # the most likely token after a context, so some greedy flags are True
    ctx = pairs[0][0]
    top = int(llama.forward(tiny["port"][0], torch.as_tensor([ctx]), tiny["port"][1])[0, -1]
              .argmax())
    pairs.append((ctx, [top]))
    got = lmeval.score_continuations(*tiny["port"], pairs, max_length=128, batch_size=8)
    want = jlmeval.score_continuations(*tiny["jax"], pairs, max_length=128, batch_size=8)
    assert got[-1][1]
    for (ctx, cont), (lp, greedy), (jlp, jgreedy) in zip(pairs, got, want):
        olp, ogreedy = _oracle(*tiny["port"], ctx, cont, max_length=128)
        assert abs(lp - jlp) < 1e-3 and abs(lp - olp) < 1e-3, (lp, jlp, olp)
        assert greedy == jgreedy == ogreedy


def test_score_rolling_and_long_bucket(tiny):
    """score_rolling of a sequence is minus its summed NLL from
    compute_perplexity (relative 1e-5); a 1100-token request, padded to
    the 2048 bucket (the forward streams KV chunks from 1024 positions on),
    scores as its unpadded forward does; too short a sequence scores 0."""
    params, cfg = tiny["port"]
    rng = np.random.default_rng(5)
    seq = rng.integers(0, 256, 40)
    roll = lmeval.score_rolling(params, cfg, [seq.tolist(), [3]], max_length=2048)
    nll = np.log(ppl.compute_perplexity(params, cfg, [seq[None]])) * (len(seq) - 1)
    assert roll[1] == 0.0 and abs(-roll[0] - nll) <= 1e-5 * nll
    jroll = jlmeval.score_rolling(*tiny["jax"], [seq.tolist()], max_length=2048)
    assert abs(roll[0] - jroll[0]) < 1e-3
    long_ctx, cont = rng.integers(0, 256, 1096).tolist(), rng.integers(0, 256, 4).tolist()
    (lp, greedy), = lmeval.score_continuations(params, cfg, [(long_ctx, cont)], max_length=2048)
    olp, ogreedy = _oracle(params, cfg, long_ctx, cont)
    assert lmeval._bucket(1100) == 2048 and abs(lp - olp) < 1e-3 and greedy == ogreedy


def test_lm_adapter_with_stub_lm_eval(tiny, monkeypatch):
    """The LM subclass drives the batched scorers and generation
    (JAX's tests/test_lmeval.py::test_lm_adapter_with_stub_lm_eval)."""
    params, cfg = tiny["port"]
    stub_api_model = types.ModuleType("lm_eval.api.model")

    class _LM:
        def __init__(self):
            pass

    stub_api_model.LM = _LM
    stub_api = types.ModuleType("lm_eval.api")
    stub_root = types.ModuleType("lm_eval")
    stub_root.api = stub_api
    stub_api.model = stub_api_model
    monkeypatch.setitem(sys.modules, "lm_eval", stub_root)
    monkeypatch.setitem(sys.modules, "lm_eval.api", stub_api)
    monkeypatch.setitem(sys.modules, "lm_eval.api.model", stub_api_model)
    lm2 = importlib.reload(lmeval)
    try:
        assert lm2.HAS_LM_EVAL and lm2.JaxCausalLM is lm2.TorchCausalLM

        class Tok:
            bos_token_id = 1
            eos_token_id = 2

            def __call__(self, text, add_special_tokens=False):
                return {"input_ids": [ord(c) % 256 for c in text]}

            def decode(self, toks):
                return "".join(chr(97 + t % 26) for t in toks)

        class Req:
            def __init__(self, *args):
                self.args = args

        lm = lm2.JaxCausalLM(params, cfg, Tok(), batch_size=2)
        res = lm.loglikelihood([Req("hello wor", "ld"), Req("", "hi")])
        assert len(res) == 2 and all(lp < 0 for lp, _ in res)
        pair = (Tok()("hello wor")["input_ids"], Tok()("ld")["input_ids"])
        want = lmeval.score_continuations(params, cfg, [pair], cfg.max_position_embeddings)
        assert res[0] == want[0]
        assert lm.loglikelihood_rolling([Req("some text here")])[0] < 0
        gen = lm.generate_until([Req("abc", {"until": ["zzz"], "max_gen_toks": 4})])
        assert isinstance(gen[0], str) and len(gen[0]) == 4
    finally:
        monkeypatch.undo()
        importlib.reload(lm2)  # back to the real (absent) lm_eval
    assert not lmeval.HAS_LM_EVAL


def test_lm_eval_cli_needs_lm_eval(tiny):
    with pytest.raises(SystemExit, match=r"lm_eval is not installed \(pip install lm-eval\)"):
        main(["lm-eval", "--model_name_or_path", str(tiny["ckpt"]), "--tasks", "x",
              "--device", "cpu"])
    with pytest.raises(SystemExit, match=r"lm_eval is not installed \(pip install lm-eval\)"):
        jmain(["lm-eval", "--model_name_or_path", str(tiny["ckpt"]), "--tasks", "x"])


# ---------------------------------------------------------------------------
# distillation
# ---------------------------------------------------------------------------


def test_squarehead_and_masked_sgd_match_optax():
    import optax

    from gptq_gguf_tpu.search import distill as jdistill

    rng = np.random.default_rng(2)
    w0 = rng.normal(size=(8, 16)).astype(np.float32)
    w0[rng.random(w0.shape) < 0.5] = 0.0
    x = rng.normal(size=(32, 16)).astype(np.float32)
    target = rng.normal(size=(32, 8)).astype(np.float32)
    s, t = rng.normal(size=(4, 8)).astype(np.float32), rng.normal(size=(4, 8)).astype(np.float32)
    assert abs(float(distill.squarehead_loss(torch.from_numpy(s), torch.from_numpy(t)))
               - float(jdistill.squarehead_loss(jnp.asarray(s), jnp.asarray(t)))) < 1e-6

    jparams = {"w": jnp.asarray(w0)}
    jmasks = jdistill.sparsity_masks(jparams)
    opt = jdistill.masked_sgd(0.1, jmasks)
    state = opt.init(jparams)

    def jloss(p):
        return jdistill.squarehead_loss(jnp.asarray(x) @ p["w"].T, jnp.asarray(target))

    w = torch.from_numpy(w0.copy()).requires_grad_(True)
    masks = distill.sparsity_masks({"w": w.detach()})
    topt = distill.masked_sgd(0.1, [masks["w"]], [w])
    for _ in range(3):
        g = jax.grad(jloss)(jparams)
        upd, state = opt.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        topt.zero_grad()
        distill.squarehead_loss(torch.from_numpy(x) @ w.T, torch.from_numpy(target)).backward()
        topt.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jparams["w"]), atol=1e-6)
    w0 = torch.from_numpy(w0)
    assert bool((w.detach()[w0 == 0] == 0).all()) and bool((w.detach() != w0).any())
    assert distill.build_prompt("Do X", "with Y") == jdistill.build_prompt("Do X", "with Y")
    assert distill.build_prompt("Do X") == jdistill.build_prompt("Do X")
    assert distill.ALPACA_TEMPLATE == jdistill.ALPACA_TEMPLATE


# ---------------------------------------------------------------------------
# parity, the synthetic checkpoint and tied embeddings
# ---------------------------------------------------------------------------


def _layout(d):
    """{name: (dtype, shape)} of every tensor of a checkpoint directory."""
    out = {}
    for f in sorted(d.glob("*.safetensors")):
        header, _ = safetensors.read_header(f)
        out.update({k: (v["dtype"], tuple(v["shape"])) for k, v in header.items()})
    return out


def test_synthetic_checkpoint_matches_jax_layout(tmp_path):
    """The same config values, tensor names, dtypes and shapes as JAX's
    (drawn by transformers there), and the same tokenizer.json."""
    from gptq_gguf_tpu.evals import parity as jparity

    a = parity.make_synthetic_checkpoint(tmp_path / "port", "tiny", seed=3)
    b = jparity.make_synthetic_checkpoint(tmp_path / "jax", "tiny", seed=3)
    assert _layout(a) == _layout(b)
    ca, cb = (json.loads((d / "config.json").read_text()) for d in (a, b))
    for k, v in ca.items():
        if k in cb and k != "transformers_version":
            assert cb[k] == v, k
    assert (a / "tokenizer.json").read_text() == (b / "tokenizer.json").read_text()
    assert loader.load_config(a) == loader.load_config(b)
    ones = [k for k, (_, s) in _layout(a).items() if len(s) == 1]
    for name, t in safetensors.iter_dir(a):
        if name in ones:
            assert bool((t == 1).all())
        else:
            assert abs(float(t.std()) - 0.02) < 0.002, name


def test_parity_cli_matches_jax(tmp_path):
    """``parity --synthetic-shapes tiny`` through the port's command line,
    JAX's on the checkpoint it wrote: the same report keys, no reference row
    (passed null), perplexities within 0.01 nats/token, GGUFs written."""
    main(["parity", "--synthetic-shapes", "tiny", "--calibration_tokens", "256",
          "--sequence_length", "64", "--eval_tokens", "256", "--out_dir", str(tmp_path / "port"),
          "--device", "cpu"])
    ckpt = tmp_path / "port" / "synthetic-checkpoint"
    jmain(["parity", "--model_name_or_path", str(ckpt), "--calibration_data", "synthetic",
           "--calibration_tokens", "256", "--sequence_length", "64", "--eval_tokens", "256",
           "--reference_name", "tiny", "--out_dir", str(tmp_path / "jax")])
    got = json.loads((tmp_path / "port" / "parity_report.json").read_text())
    want = json.loads((tmp_path / "jax" / "parity_report.json").read_text())
    assert sorted(got) == sorted(want) and got["eval_dataset"] == want["eval_dataset"]
    assert got["tolerance"] == want["tolerance"] == parity.PPL_TOLERANCE
    (r,), (jr,) = got["results"], want["results"]
    assert sorted(r) == sorted(jr) and r["bit_width"] == jr["bit_width"] == "Q4_K"
    assert r["passed"] is None and r["reference_ppl"] is None and r["delta"] is None
    assert abs(np.log(r["measured_ppl"]) - np.log(jr["measured_ppl"])) < 0.01
    assert (tmp_path / "port" / "model-Q4_K.gguf").stat().st_size > 0
    assert parity.reference_row("/models/Llama-3.2-1B-Instruct")["Q4_K"] == 12.16
    assert parity.REFERENCE_PPL == __import__("gptq_gguf_tpu.evals.parity",
                                              fromlist=["x"]).REFERENCE_PPL


def test_tied_embeddings_through_loader_walk_and_pack(tiny, tmp_path):
    """A tied checkpoint (the 1B preset's form) loads without lm_head,
    quantizes (embedding RTN too), packs to JAX's bytes from the same
    artifacts (output.weight the f16 embedding, as JAX writes it) and
    scores as JAX scores it."""
    from gptq_gguf_tpu.export import packer as jpacker
    from gptq_gguf_tpu_torch.export import packer
    from gptq_gguf_tpu_torch.formats.gguf import GGUFReader
    from gptq_gguf_tpu_torch.quant import calibrate

    d = parity.make_synthetic_checkpoint(tmp_path / "tied", "tiny", seed=6)
    cfg_json = json.loads((d / "config.json").read_text())
    cfg_json["tie_word_embeddings"] = True
    (d / "config.json").write_text(json.dumps(cfg_json))
    last = sorted(d.glob("*.safetensors"))[-1]
    safetensors.write_safetensors({k: v for k, v in safetensors.iter_file(last)
                                   if k != "lm_head.weight"}, last)
    cfg = loader.load_config(d)
    params = loader.load_params(d, cfg)
    assert cfg.tie_word_embeddings and "lm_head" not in params
    calib = [np.random.default_rng(1).integers(0, 256, size=(1, 64)) for _ in range(2)]
    q = calibrate.quantize_model(params, cfg, calib, save_dir=tmp_path / "layers",
                                 quant_non_block=True, device="cpu")
    assert "lm_head" not in q and not (tmp_path / "layers" / "lm_head").exists()
    packer.pack_model(d, tmp_path / "layers", tmp_path / "port.gguf")
    jpacker.pack_model(d, tmp_path / "layers", tmp_path / "jax.gguf")
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "jax.gguf").read_bytes()
    # llama.cpp needs output.weight: the float embedding (token_embd is its Q6_K artifact)
    r = GGUFReader(tmp_path / "port.gguf")
    emb = llama.get_linear(params, "model.embed_tokens").half().numpy()
    assert r.tensors["output.weight"].ggml_type.name == "F16"
    assert r.tensor_bytes("output.weight").tobytes() == emb.tobytes()
    got = _ppl(main, ["--gguf-file", str(tmp_path / "port.gguf"), "--device", "cpu"],
               tmp_path / "p.json")
    want = _ppl(jmain, ["--gguf-file", str(tmp_path / "port.gguf")], tmp_path / "j.json")
    assert abs(got - want) / want < 1e-4
