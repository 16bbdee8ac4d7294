"""GGUF-direct perplexity of the port against the JAX package, on the CPU.

The tiny Q4_K_M GGUF of tests/test_torch_serving.py is scored by both
command lines (``ppl --gguf-file``) on the same synthetic tokens (the two
packages' ``get_synthetic`` give equal streams), dense and through the
serving forward in each runtime format. Bounds:
- dense: both packages dequantize to the same f32 weights and run an f32
  forward, differing only in the order of f32 sums: perplexities within a
  relative 1e-4;
- serving: JAX's kernels in interpret mode (FORCE_PALLAS_INTERPRET) against
  the port's plain versions, the same arithmetic per format (one kernel
  call agrees to ~1e-5 of its outputs). The kernels round their input
  activations to bf16, so a sum that lands on the other side of a
  rounding boundary flips one bf16 ulp (2^-8), and this random model's
  RMSNorms amplify such flips to ~1.5% of max|logit| after two layers
  (test_torch_serving.py holds logits to 2e-2): mean NLLs within 0.01
  nats/token (measured: < 0.001 for v1 and v2, 0.004 for v4);
- the port's dense against its serving path: 0.05 nats/token (the JAX
  package's own bound, tests/test_ppl_gguf.py), in every format.
"""

import json

import numpy as np
import pytest
import torch

from gptq_gguf_tpu.ops import qmatmul as jq
from gptq_gguf_tpu_torch import __main__ as cli
from gptq_gguf_tpu_torch.evals import ppl
from gptq_gguf_tpu_torch.models import llama
from gptq_gguf_tpu_torch.ops import qmatmul
from gptq_gguf_tpu_torch.serving import model as qmodel
from gptq_gguf_tpu_torch.utils import data
from tests.test_torch_serving import gguf  # noqa: F401

ARGS = ["--datasets", "synthetic", "--eval_tokens", "256", "--sequence_length", "64"]


def _ppl(main, argv, out):
    main(["ppl", *argv, *ARGS, "--output_path", str(out)])
    return json.loads(out.read_text())["synthetic"]


def test_synthetic_eval_tokens_match_jax():
    from gptq_gguf_tpu.utils import data as jdata

    want = jdata.get_data("synthetic", 256, 64, train=False, vocab_size=256)
    got = data.get_data("synthetic", 256, 64, train=False, vocab_size=256)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path,fmt", [("dense", "v2"), ("serving", "v1"), ("serving", "v2"),
                                      ("serving", "v4")])
def test_ppl_cli_matches_jax(gguf, tmp_path, monkeypatch, path, fmt):  # noqa: F811
    from gptq_gguf_tpu.__main__ import main as jmain

    monkeypatch.setattr(jq, "RUNTIME_FORMAT", fmt)
    monkeypatch.setattr(qmatmul, "RUNTIME_FORMAT", fmt)
    monkeypatch.setattr(jq, "FORCE_PALLAS_INTERPRET", True)
    argv = ["--gguf-file", str(gguf), "--gguf-path", path]
    want = _ppl(jmain, argv, tmp_path / "jax.json")
    got = _ppl(cli.main, [*argv, "--device", "cpu"], tmp_path / "port.json")
    assert np.isfinite(got) and got > 1
    if path == "dense":
        assert abs(got - want) / want < 1e-4, (got, want)
    else:
        assert abs(np.log(got) - np.log(want)) < 0.01, (got, want)


def test_ppl_cli_hf_checkpoint_matches_jax(gguf, tmp_path):  # noqa: F811
    """``ppl --model_name_or_path``: the f32 HF checkpoint behind the GGUF,
    dense f32 forward in both packages: within a relative 1e-4."""
    from gptq_gguf_tpu.__main__ import main as jmain

    argv = ["--model_name_or_path", str(gguf.parent / "m")]
    want = _ppl(jmain, argv, tmp_path / "jax.json")
    got = _ppl(cli.main, [*argv, "--device", "cpu"], tmp_path / "port.json")
    assert abs(got - want) / want < 1e-4, (got, want)


def test_ppl_auto_picks_dense_for_a_small_gguf(gguf, tmp_path, monkeypatch):  # noqa: F811
    calls = []
    load0 = qmodel.load_gguf_for_serving

    def spy(*a, **kw):
        calls.append(kw["dense"])
        return load0(*a, **kw)

    monkeypatch.setattr(qmodel, "load_gguf_for_serving", spy)
    auto = _ppl(cli.main, ["--gguf-file", str(gguf), "--device", "cpu"], tmp_path / "a.json")
    dense = _ppl(cli.main, ["--gguf-file", str(gguf), "--gguf-path", "dense", "--device", "cpu"],
                 tmp_path / "d.json")
    assert calls == [True, True] and auto == dense


@pytest.mark.parametrize("fmt", ["v1", "v2", "v4"])
def test_serving_ppl_close_to_dense(gguf, fmt, monkeypatch):  # noqa: F811
    """The port's serving path (packed weights, the kernels' plain
    versions, bf16 activations as ``serve`` runs them) against its dense
    f32 oracle: within 0.05 nats/token."""
    monkeypatch.setattr(qmatmul, "RUNTIME_FORMAT", fmt)
    rng = np.random.default_rng(11)
    seqs = [rng.integers(0, 256, size=(1, 48)) for _ in range(3)]
    dparams, dcfg = qmodel.load_gguf_for_serving(gguf, dtype=torch.float32, device="cpu",
                                                 dense=True)
    ref = ppl.compute_perplexity(dparams, dcfg, seqs)
    qparams, qcfg = qmodel.load_gguf_for_serving(gguf, device="cpu")
    got = ppl.compute_perplexity(qparams, qcfg, seqs, serving=True, batch_size=2)
    assert np.isfinite(got) and abs(np.log(got) - np.log(ref)) < 0.05


def test_running_mean_weights_batches_by_tokens():
    """compute_perplexity folds each batch's mean NLL into a running mean
    weighted by its shifted-token count (the reference's estimator)."""
    cfg = llama.LlamaConfig(vocab_size=16, hidden_size=8, intermediate_size=8,
                            num_hidden_layers=0, num_attention_heads=1, num_key_value_heads=1)
    emb = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32))
    params = {"embed_tokens": emb, "norm": torch.ones(8), "layers": []}
    seqs = [np.arange(5)[None] % 16, np.arange(3, 12)[None] % 16, np.arange(7)[None] % 16]
    per_batch = [float(ppl._batch_nll(params, torch.as_tensor(s), cfg)) for s in seqs]
    n = [s.shape[1] - 1 for s in seqs]
    want = np.exp(sum(a * b for a, b in zip(per_batch, n)) / sum(n))
    assert ppl.compute_perplexity(params, cfg, seqs) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("flag", ["memory_efficient", "drop_layer_config",
                                  "compressed_weights_path"])
def test_ppl_options_match_jax(gguf, tmp_path, flag):  # noqa: F811
    """The three options that once raised, on the GGUF's dense path through
    both command lines: within a relative 1e-4 (the dense bound). The
    database is ``split_hf`` of the GGUF itself (f16 of its dequantized
    weights), at the level each layer holds. A call with no model exits."""
    from gptq_gguf_tpu.__main__ import main as jmain
    from gptq_gguf_tpu_torch.mapper import splitter

    argv = ["--gguf-file", str(gguf), "--gguf-path", "dense"]
    if flag == "memory_efficient":
        argv += ["--memory_efficient"]
    elif flag == "drop_layer_config":
        (tmp_path / "drops.txt").write_text("attn\nmlp\n")
        argv += ["--drop_layer_config", str(tmp_path / "drops.txt")]
    else:
        db = tmp_path / "db"
        splitter.split_hf(gguf, db)
        lines = [f"{d.name}: {sorted(d.glob('*.pth'))[0].stem}"
                 for d in sorted(db.iterdir()) if d.is_dir()]
        (tmp_path / "config.txt").write_text("\n".join(lines))
        argv += ["--compressed_weights_path", str(db), "--compressed_config_path",
                 str(tmp_path / "config.txt")]
    want = _ppl(jmain, argv, tmp_path / "jax.json")
    got = _ppl(cli.main, [*argv, "--device", "cpu"], tmp_path / "port.json")
    assert np.isfinite(got) and abs(got - want) / want < 1e-4, (got, want)
    with pytest.raises(SystemExit):
        cli.main(["ppl", "--device", "cpu", f"--{flag}", *([] if flag == "memory_efficient"
                                                          else ["x"])])
