"""Checks shared by the gemma / gemma2 and phi3 family tests
(tests/test_torch_gemma.py, tests/test_torch_phi3.py): a tiny HF checkpoint
of one family, built from its config by transformers, through both
packages' loaders, blocks, walks, ``pack``, RTN, serving loaders and
forwards, on the CPU with the same numpy inputs.

Tolerances are those of tests/test_torch_families.py: the block and its
captures within 1e-5 (of max|x| where that passes 1), the full model's
logits within 2e-4 of HF's and JAX's,
the GPTQ objective of each linear within 2% of the JAX walk's, RTN artifacts
and every GGUF byte for byte, serving logits within LOGIT_TOL of max|logit|
with greedy tokens equal up to near-ties, the paged forward within
LOGIT_TOL of the contiguous one, dense perplexity within 1e-4.
"""

import contextlib
import filecmp
import io
import json
import shutil

import jax.numpy as jnp
import numpy as np
import torch

from gptq_gguf_tpu.__main__ import main as jmain
from gptq_gguf_tpu.mapper import splitter as jsplit
from gptq_gguf_tpu.models import llama as jl
from gptq_gguf_tpu.models import loader as jloader
from gptq_gguf_tpu.quant import artifacts as jart
from gptq_gguf_tpu.quant import calibrate as jcal
from gptq_gguf_tpu.quant import recipes as jrecipes
from gptq_gguf_tpu.quant import rtn as jrtn
from gptq_gguf_tpu.serving import model as jmodel
from gptq_gguf_tpu.utils import data as jdata
from gptq_gguf_tpu_torch.__main__ import main
from gptq_gguf_tpu_torch.formats import gguf
from gptq_gguf_tpu_torch.models import llama, loader
from gptq_gguf_tpu_torch.ops import gptq, kquant
from gptq_gguf_tpu_torch.quant import artifacts, calibrate, recipes, rtn
from gptq_gguf_tpu_torch.serving import model as qmodel
from gptq_gguf_tpu_torch.serving import paged
from tests.test_torch_calibrate import CAPTURE, QCFG
from tests.test_torch_mapper import assert_same_tree
from tests.test_torch_serving import LOGIT_TOL, _assert_tree_equal, _numpy_tree
from tests.torch_pack_fixtures import write_bpe

FIELDS = ("q_type", "qweight", "super_group_scale", "super_group_zero", "group_scale_quant",
          "group_zero_quant")


def run(fn, argv):
    """A command line's printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue().strip().splitlines()


def build_checkpoint(root, model_type, vocab, seed, norm_center, **hf_kw):
    """A 2-layer HF model of ``model_type`` built from its config (eager
    attention), its norm weights drawn around ``norm_center`` (gemma's
    norms store w of (1 + w): 0; the others 1), saved as f32 safetensors
    with a BPE tokenizer. Returns (checkpoint dir, the HF model)."""
    from transformers import AutoConfig, AutoModelForCausalLM

    hf = AutoConfig.for_model(model_type=model_type, vocab_size=vocab, num_hidden_layers=2,
                              torch_dtype="float32", initializer_range=0.05,
                              attn_implementation="eager", **hf_kw)
    torch.manual_seed(seed)
    m = AutoModelForCausalLM.from_config(hf).eval().float()
    with torch.no_grad():
        for pname, p in m.named_parameters():
            if "norm" in pname:
                p.copy_(norm_center + 0.3 * torch.randn_like(p))
    d = root / "m"
    m.save_pretrained(d, safe_serialization=True)
    write_bpe(d, vocab)
    return d, m


def walk_both(d, vocab):
    """Both packages' GPTQ walks (block linears Q4_K, embed / head RTN Q6_K)
    on 512 synthetic tokens, and the port's pack of its own artifacts."""
    root = d.parent
    jcfg = jloader.load_config(d)
    jp = jloader.load_params(d, jcfg, host=True)
    calib = jdata.get_data("synthetic", 512, 64, None, vocab_size=vocab)
    jcal.quantize_model(jp, jcfg, calib, quant_config=QCFG, save_dir=root / "jax",
                        quant_non_block=True)
    cfg = llama.config_from_reference(jcfg)
    tp = llama.dense_params_from_numpy(jp, cfg, device="cpu")
    out = calibrate.quantize_model(tp, cfg, calib, quant_config=QCFG, save_dir=root / "port",
                                   quant_non_block=True, device="cpu")
    run(main, ["pack", "--model_dir", str(d), "--quant_dir", str(root / "port"),
               "--outfile", str(root / "port.gguf")])
    return dict(jcfg=jcfg, jp=jp, calib=calib, out=out, gguf=root / "port.gguf")


def check_config_and_params(d, layer_keys):
    """The port's config and host params equal JAX's; every layer holds
    ``layer_keys``."""
    jcfg = jloader.load_config(d)
    cfg = loader.load_config(d)
    assert cfg == llama.config_from_reference(jcfg)
    jp = jloader.load_params(d, jcfg, host=True)
    tp = loader.load_params(d, cfg)
    assert sorted(tp) == sorted(jp)
    for k in tp:
        if k != "layers":
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), err_msg=k)
    for lj, lt in zip(jp["layers"], tp["layers"]):
        assert sorted(lt) == sorted(lj) == sorted(layer_keys)
        for k in lj:
            np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]), err_msg=k)
    return cfg


def check_block_capture(d, vocab, S, layer_idx):
    """One block and its captures against JAX's, on embedded tokens: within
    1e-5 relative, and 1e-5 of the tensor's largest magnitude where that
    passes 1 (f32 sums over rows of 768 round at that scale)."""
    jcfg = jloader.load_config(d)
    cfg = llama.config_from_reference(jcfg)
    jp = jloader.load_params(d, jcfg, host=True)
    tp = llama.dense_params_from_numpy(jp, cfg, device="cpu")
    ids = np.random.default_rng(5).integers(0, vocab, size=(2, S))
    x = np.asarray(jl.embed_forward(jp, jnp.asarray(ids), jcfg))
    pos = np.arange(S)[None, :]
    cj, sj = jl.rope_cos_sin(jcfg, jnp.asarray(pos))
    cj, sj = jnp.broadcast_to(cj, (2, S, cj.shape[-1])), jnp.broadcast_to(sj, (2, S, sj.shape[-1]))
    ct, st = llama.rope_cos_sin(cfg, torch.from_numpy(pos))
    layer = jp["layers"][layer_idx]
    out_j, cap_j = jl.block_capture({k: jnp.asarray(v) for k, v in layer.items()},
                                    jnp.asarray(x), cj, sj, jl.causal_mask(2, S), jcfg, layer_idx)
    out_t, cap_t = llama.block_capture(tp["layers"][layer_idx], torch.from_numpy(x),
                                       ct.expand(2, S, -1), st.expand(2, S, -1),
                                       llama.causal_mask(2, S), cfg, layer_idx)
    assert sorted(cap_t) == sorted(cap_j) == ["down", "gateup", "o", "qkv"]
    for k, want in [("out", np.asarray(out_j))] + [(k, np.asarray(c)) for k, c in cap_j.items()]:
        got = (out_t if k == "out" else cap_t[k]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()),
                                   err_msg=k)
    return out_t


def check_logits(d, m, ids):
    """The port's dense forward against transformers' model and the JAX
    package's forward (2e-4); returns the port's logits."""
    cfg = loader.load_config(d)
    tp = loader.load_params(d, cfg)
    with torch.no_grad():
        want = m(torch.from_numpy(ids)).logits.numpy()
    got = llama.forward(tp, torch.from_numpy(ids), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    jcfg = jloader.load_config(d)
    jp = jloader.load_params(d, jcfg)
    np.testing.assert_allclose(got, np.asarray(jl.forward(jp, jnp.asarray(ids), jcfg)),
                               rtol=2e-4, atol=2e-4)
    return got


def _walk_hessians(jp, jcfg, calib, jax_dir):
    """Per layer and capture, X^T X of the inputs the JAX walk saw: the
    captures of each unquantized block on inputs embedded by its RTN
    embedding and propagated through its quantized earlier blocks."""
    S = calib[0].shape[1]
    cos, sin = jl.rope_cos_sin(jcfg, jnp.arange(S)[None, :])
    emb = {"embed_tokens": jnp.asarray(jart.load_layer(jax_dir, "model.embed_tokens")
                                       .dequantize())}
    xs = [jl.embed_forward(emb, jnp.asarray(b), jcfg) for b in calib]
    out = []
    for li, layer in enumerate(jp["layers"]):
        layer = {k: jnp.asarray(v) for k, v in layer.items()}
        quant = dict(layer)
        for key in llama.BLOCK_LINEAR_KEYS:
            mod = "self_attn" if key[0] in "qkvo" else "mlp"
            quant[key] = jnp.asarray(jart.load_layer(jax_dir, f"model.layers.{li}.{mod}.{key}")
                                     .dequantize())
        hs, new = {}, []
        for x in xs:
            _, caps = jl.block_capture(layer, x, cos, sin, jl.causal_mask(1, S), jcfg, li)
            new.append(jl.block_forward(quant, x, cos, sin, jl.causal_mask(1, S), jcfg, li))
            for k, c in caps.items():
                c = np.asarray(c, np.float64).reshape(-1, c.shape[-1])
                hs[k] = hs.get(k, 0) + c.T @ c
        out.append(hs)
        xs = new
    return out


def check_walk(d, walked, n_artifacts):
    """Both walks write the same artifact names; RTN embed / head the same
    codes; the port's returned params are its artifacts dequantized. GPTQ
    objectives within 2% of the JAX walk's, on the Hessians of the inputs
    the JAX walk saw: the port's artifacts of layer 0 (whose inputs both
    walks share), and the port's solve of every block linear given that
    Hessian. (Past layer 0 each walk sees its own quantized layers' outputs:
    codes that differ in a few tenths of a percent at layer 0 change a
    greedy GPTQ solve at layer 1 by a few percent either way.)"""
    root = d.parent
    names = sorted(jart.list_layers(root / "jax"))
    assert names == sorted(artifacts.list_layers(root / "port")) and len(names) == n_artifacts
    hs = _walk_hessians(walked["jp"], walked["jcfg"], walked["calib"], root / "jax")
    for name in names:
        a = jart.load_layer(root / "jax", name)
        b = jart.load_layer(root / "port", name)
        assert a.q_type == b.q_type
        if "layers" not in name:
            for f in FIELDS[1:]:
                np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=name)
            continue
        li, key = int(name.split(".")[2]), name.split(".")[-1]
        np.testing.assert_array_equal(walked["out"]["layers"][li][key].numpy(), b.dequantize())
        W = np.asarray(walked["jp"]["layers"][li][key], np.float64)
        Hm = hs[li][CAPTURE[key]]
        solved = gptq.gptq_quantize_matrix(torch.from_numpy(W).float(),
                                           torch.from_numpy(Hm).float(), a.q_type, device="cpu")
        cands = [a.dequantize(), kquant.dequantize(solved.qweight, solved.params, a.q_type)
                 .double().numpy()] + ([b.dequantize()] if li == 0 else [])
        obj = [float(np.trace((W - w) @ Hm @ (W - w).T)) for w in cands]
        for o in obj[1:]:
            assert abs(o - obj[0]) <= 0.02 * obj[0], (name, obj)


def check_pack(d, walked):
    """pack of the port's artifacts by both command lines: the same file;
    returns its reader."""
    root = d.parent
    run(jmain, ["pack", "--model_dir", str(d), "--quant_dir", str(root / "port"),
                "--outfile", str(root / "jax-pack.gguf")])
    assert filecmp.cmp(root / "jax-pack.gguf", walked["gguf"], shallow=False)
    return gguf.GGUFReader(walked["gguf"])


def check_f32_pack(d, tmp_path):
    """``pack --outtype f32`` (no artifacts) by both command lines: the same
    file; returns its path."""
    (tmp_path / "none").mkdir(exist_ok=True)
    argv = ["pack", "--model_dir", str(d), "--quant_dir", str(tmp_path / "none"),
            "--outtype", "f32"]
    run(main, [*argv, "--outfile", str(tmp_path / "f32.gguf")])
    run(jmain, [*argv, "--outfile", str(tmp_path / "jax-f32.gguf")])
    assert filecmp.cmp(tmp_path / "f32.gguf", tmp_path / "jax-f32.gguf", shallow=False)
    return tmp_path / "f32.gguf"


def forward_steps(params, cfg, ids, max_len, steps, jp=None, jcfg=None):
    """Prefill ``ids`` then greedy decode through forward_cached (the port;
    JAX's too when ``jp`` is given, fed the same tokens); the logits of each
    step, (port, JAX or None)."""
    B = ids.shape[0]
    tc = qmodel.init_cache(cfg, B, max_len, dtype=torch.float32, device="cpu")
    jc = jmodel.init_cache(jcfg, B, max_len, dtype=jnp.float32) if jp is not None else None
    out = []
    for _ in range(steps):
        tl, tc = qmodel.forward_cached(params, cfg, torch.from_numpy(ids), tc)
        jlog = None
        if jp is not None:
            jlog, jc = jmodel.forward_cached(jp, jcfg, jnp.asarray(ids), jc)
            jlog = np.asarray(jlog)
        out.append((tl.numpy(), jlog))
        ids = (jlog if jlog is not None else tl.numpy()).argmax(-1)[:, None]
    return out


def assert_logits_close(got, want, what):
    """Within LOGIT_TOL of max|want|, greedy tokens equal where the top-2 gap is clear."""
    tol = LOGIT_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > tol
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear], err_msg=what)


def check_served_against_jax(path, max_len, steps=4, vocab=256):
    """Both loaders on one GGUF: the same params (packed planes and norms
    byte-equal), the same fused params, and forward_cached logits of a
    12-token prefill and greedy steps within LOGIT_TOL."""
    jp, jcfg = jmodel.load_gguf_for_serving(path, dtype=jnp.float32)
    tp, tcfg = qmodel.load_gguf_for_serving(path, dtype=torch.float32, device="cpu")
    assert llama.config_from_reference(jcfg) == tcfg
    _assert_tree_equal(tp, _numpy_tree(jp))
    jf, tf = jmodel.fuse_params_for_serving(jp, jcfg), qmodel.fuse_params_for_serving(tp, tcfg)
    _assert_tree_equal(tf, _numpy_tree(jf))
    ids = np.random.default_rng(3).integers(0, vocab, size=(2, 12))
    for step, (got, want) in enumerate(forward_steps(tf, tcfg, ids, max_len, steps, jf, jcfg)):
        assert_logits_close(got, want, f"step {step}")
    return tp, tcfg


def check_engine_streams(jp, jcfg, tp, tcfg, max_len):
    """Five requests through both packages' ContinuousBatchingEngine (2
    slots, blocks of 4 decode steps): the same greedy tokens, where the
    streams part only at a near-tie of the port's logits (top-2 gap under
    LOGIT_TOL of max|logit|), recomputed in a cache of the engine's
    capacity (longrope picks its factors by capacity)."""
    from gptq_gguf_tpu.serving import engine as jengine
    from gptq_gguf_tpu_torch.serving import engine

    jp = jmodel.fuse_params_for_serving(jp, jcfg)
    tp = qmodel.fuse_params_for_serving(tp, tcfg)
    rng = np.random.default_rng(max_len)
    reqs = [(rng.integers(0, 256, size=int(rng.integers(4, 40))), int(rng.integers(6, 15)))
            for _ in range(5)]
    je = jengine.ContinuousBatchingEngine(jp, jcfg, num_slots=2, max_len=max_len, multi_step=4)
    te = engine.ContinuousBatchingEngine(tp, tcfg, num_slots=2, max_len=max_len, multi_step=4)
    for p, n in reqs:
        je.submit(p, max_new_tokens=n)
        te.submit(p, max_new_tokens=n)
    jd = {r.uid: r.output for r in je.run_until_done()}
    td = {r.uid: r.output for r in te.run_until_done()}
    assert sorted(td) == sorted(jd) == [1, 2, 3, 4, 5]
    for uid, (p, n) in enumerate(reqs, start=1):
        a, b = td[uid], jd[uid]
        assert len(a) == len(b) == n
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is not None:
            ctx = np.concatenate([np.asarray(p), np.asarray(a[:t])]).astype(np.int64)
            cache = qmodel.init_cache(tcfg, 1, max_len, device="cpu")
            logits, _ = qmodel.forward_cached(tp, tcfg, torch.from_numpy(ctx)[None], cache)
            top2 = torch.topk(logits[0], 2).values
            assert float(top2[0] - top2[1]) < LOGIT_TOL * float(logits.abs().max()), (uid, t)


def check_paged_against_contiguous(path, table, page, max_len, steps, vocab, kv_dtype=None):
    """Prefill of 12 tokens, then decode steps: the paged forward (f32
    pools, or int4 ones with an int4 contiguous cache; a scrambled table)
    against forward_cached on the served GGUF's fused params, within
    LOGIT_TOL, greedy tokens equal where the top-2 gap is clear."""
    tp, cfg = qmodel.load_gguf_for_serving(path, dtype=torch.float32, device="cpu")
    tp = qmodel.fuse_params_for_serving(tp, cfg)
    B = len(table)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, vocab, size=(B, 12)))
    pc = paged.init_paged_cache(cfg, B, max_len, page, dtype=torch.float32, kv_dtype=kv_dtype,
                                device="cpu")
    pc = pc._replace(page_table=torch.tensor(table, dtype=torch.int32))
    cc = qmodel.init_cache(cfg, B, max_len, dtype=torch.float32, kv_dtype=kv_dtype, device="cpu")
    for step in range(steps):
        lp, pc = paged.forward_paged(tp, cfg, ids, pc)
        lc, cc = qmodel.forward_cached(tp, cfg, ids, cc)
        assert_logits_close(lp.numpy(), lc.numpy(), f"step {step}")
        ids = lc.argmax(-1)[:, None]
    np.testing.assert_array_equal(pc.lengths.numpy(), cc.lengths.numpy())
    return cfg


def check_rtn_route(d, vocab, tmp_path):
    """compute_imatrix within 1e-5, rtn_quantize_model given JAX's
    importance bit for bit, rtn-quantize of both command lines and
    llama-quantize Q4_K_M of the port's f16 pack: the same files."""
    jcfg = jloader.load_config(d)
    jp = jloader.load_params(d, jcfg, host=True)
    cfg = llama.config_from_reference(jcfg)
    tp = llama.dense_params_from_numpy(jp, cfg, device="cpu")
    calib = [np.random.default_rng(18).integers(0, vocab, size=(1, 64)) for _ in range(3)]
    jim = jrtn.compute_imatrix(jp, jcfg, calib, batch_size=2)
    got = rtn.compute_imatrix(tp, cfg, calib, batch_size=2, device="cpu")
    assert list(got) == list(jim) and len(got) == 14
    for k in jim:
        np.testing.assert_allclose(got[k], jim[k], rtol=1e-5, atol=0, err_msg=k)
    jrtn.rtn_quantize_model(jp, jcfg, save_dir=tmp_path / "jax", imatrix=jim)
    rtn.rtn_quantize_model(tp, cfg, save_dir=tmp_path / "port", imatrix=jim, device="cpu")
    names = sorted(jart.list_layers(tmp_path / "jax"))
    assert names == sorted(artifacts.list_layers(tmp_path / "port")) and len(names) == 14
    for n in names:
        a, b = jart.load_layer(tmp_path / "jax", n), artifacts.load_layer(tmp_path / "port", n)
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(b, f)), np.asarray(getattr(a, f)))
    data = ["--calibration_data", "synthetic", "--calibration_tokens", "128",
            "--calibration_sequence_length", "64"]
    for who, fn, dev in (("jax", jmain, []), ("port", main, ["--device", "cpu"])):
        run(fn, ["rtn-quantize", "--model_name_or_path", str(d), *data, "--save_dir",
                 str(tmp_path / f"{who}-rtn"), "--outfile", str(tmp_path / f"{who}-rtn.gguf"),
                 *dev])
    assert filecmp.cmp(tmp_path / "jax-rtn.gguf", tmp_path / "port-rtn.gguf", shallow=False)
    (tmp_path / "none").mkdir()
    run(main, ["pack", "--model_dir", str(d), "--quant_dir", str(tmp_path / "none"),
               "--outfile", str(tmp_path / "f16.gguf")])
    jrecipes.llama_quantize(tmp_path / "f16.gguf", tmp_path / "jax-q4km.gguf", "Q4_K_M")
    recipes.llama_quantize(tmp_path / "f16.gguf", tmp_path / "port-q4km.gguf", "Q4_K_M",
                           device="cpu")
    assert filecmp.cmp(tmp_path / "jax-q4km.gguf", tmp_path / "port-q4km.gguf", shallow=False)
    return tmp_path / "port-q4km.gguf"


def check_commands(d, path, tmp_path, page_size):
    """quantize of the checkpoint, then serve (contiguous and paged) and ppl
    of its GGUF through the port's command line: the same tokens from both
    engines, dense perplexity within 1e-4 of the JAX command's."""
    main(["quantize", "--model_name_or_path", str(d), "--calibration_data", "synthetic",
          "--calibration_tokens", "128", "--calibration_sequence_length", "64", "--save_dir",
          str(tmp_path / "layers"), "--device", "cpu"])
    assert len(artifacts.list_layers(tmp_path / "layers")) == 7 * 2
    serve = ["serve", "--gguf-file", str(path), "--prompt-tokens", "5", "6", "7",
             "--max-new-tokens", "4", "--max-len", "64", "--num-slots", "1", "--device", "cpu"]
    out = run(main, serve)
    assert out[0].startswith("generated 4 tokens") and len(json.loads(out[1])) == 4
    assert run(main, [*serve, "--paged", "--page-size", str(page_size)])[1] == out[1]
    argv = ["ppl", "--gguf-file", str(path), "--gguf-path", "dense", "--datasets", "synthetic",
            "--eval_tokens", "256", "--sequence_length", "64"]
    run(jmain, [*argv, "--output_path", str(tmp_path / "jax.json")])
    run(main, [*argv, "--output_path", str(tmp_path / "port.json"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax.json").read_text())["synthetic"]
    got = json.loads((tmp_path / "port.json").read_text())["synthetic"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    run(main, [*argv[:4], "serving", *argv[5:], "--output_path", str(tmp_path / "s.json"),
               "--device", "cpu"])
    assert np.isfinite(json.loads((tmp_path / "s.json").read_text())["synthetic"])


def check_split_stitch(src, tmp_path):
    """split -> stitch through the command line gives back the file's
    tensors; both HF-layer splits against JAX's."""
    main(["split", "--gguf-file", str(src), "--output-dir", str(tmp_path / "db"),
          "--gguf-layers"])
    assert run(main, ["stitch", "--split-dir", str(tmp_path / "db"),
                      "--validate-only"])[-1] == "configuration valid"
    main(["stitch", "--split-dir", str(tmp_path / "db"), "--output", str(tmp_path / "back.gguf")])
    a, b = gguf.GGUFReader(src), gguf.GGUFReader(tmp_path / "back.gguf")
    assert b.tensor_order == a.tensor_order
    for t in a.tensor_order:
        assert b.tensors[t].ggml_type == a.tensors[t].ggml_type, t
        assert bytes(b.tensor_bytes(t)) == bytes(a.tensor_bytes(t)), t
    main(["split", "--gguf-file", str(src), "--output-dir", str(tmp_path / "port-hf"),
          "--hf-layers"])
    jsplit.split_hf(src, tmp_path / "jax-hf")
    assert_same_tree(tmp_path / "port-hf", tmp_path / "jax-hf", hf=True)
    shutil.rmtree(tmp_path / "db")
