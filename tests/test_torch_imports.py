"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points default to the card and raise without one, and chip_smoke.py
refuses to run without a card or outside a checkout."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gptq_gguf_tpu_torch.formats import gguf

REPO = Path(__file__).resolve().parents[1]
PKG = "gptq_gguf_tpu_torch"


def _port_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
        for p in (REPO / PKG).rglob("*.py"))


def test_port_imports_no_jax(tmp_path_factory):
    mods = _port_modules()
    assert f"{PKG}.ops.qmatmul" in mods and f"{PKG}.serving.engine" in mods
    assert f"{PKG}.ops.gptq" in mods and f"{PKG}.quant.calibrate" in mods
    for m in ("ops.paged_attention", "serving.paged", "serving.server", "serving.tokenizer",
              "ops.qmv4", "evals.ppl", "cli.tools", "export.packer", "export.spm"):
        assert f"{PKG}.{m}" in mods
    # the kernel sources ops.qmatmul binds (the v2 variants among them) and
    # every header a source includes
    csrc = REPO / PKG / "ops" / "csrc"
    for src in ("qmatmul_v2g", "qmatmul_v2", "qmatmul_v3", "qmatmul_v2m", "qmatmul_v1"):
        assert (csrc / f"{src}.cu").is_file(), src
    for src in csrc.glob("*.cu*"):
        for header in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (csrc / header).is_file(), (src.name, header)
    # ... and `pack` runs (its lazy imports included) on a tiny llama with a
    # Q4_K artifact and a BPE vocabulary, without JAX, ml_dtypes or the
    # safetensors package
    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.quant import artifacts
    from tests.torch_pack_fixtures import write_bpe, write_safetensors

    tmp = tmp_path_factory.mktemp("pack_alone")
    d = tmp / "m"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(
        model_type="llama", vocab_size=320, hidden_size=256, intermediate_size=256,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1)))
    rng = np.random.default_rng(0)
    write_safetensors(d / "model.safetensors", {
        "model.embed_tokens.weight": rng.normal(size=(320, 256)).astype(np.float32),
        "model.layers.0.self_attn.q_proj.weight": rng.normal(size=(256, 256)).astype(np.float16)})
    write_bpe(d, 320)
    z = np.zeros((256, 1), np.float16)
    artifacts.save_layer(tmp / "layers", "model.layers.0.self_attn.q_proj", artifacts.LayerArtifact(
        T.Q4_K, rng.integers(0, 16, size=(256, 256)).astype(np.uint8), z + 0.01, z,
        np.ones((256, 8), np.uint8), np.zeros((256, 8), np.uint8)))
    pack = ["pack", "--model_dir", str(d), "--quant_dir", str(tmp / "layers"),
            "--outfile", str(tmp / "x.gguf"), "--outtype", "bf16"]
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(REPO / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"importlib.import_module('{PKG}.__main__').main({pack!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'gptq_gguf_tpu', 'ml_dtypes', 'safetensors')]\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert gguf.GGUFReader(tmp / "x.gguf").tensors["blk.0.attn_q.weight"].ggml_type == T.Q4_K


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")


def test_entry_points_default_to_cuda(no_cuda):
    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.models.llama import LlamaConfig
    from gptq_gguf_tpu_torch.ops import qmatmul
    from gptq_gguf_tpu_torch.ops.kquant import SuperGroupParams
    from gptq_gguf_tpu_torch.serving import model as qmodel

    cfg = LlamaConfig(vocab_size=8, hidden_size=256, intermediate_size=256,
                      num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1)
    z = np.zeros((4, 1), np.float16)
    zi = np.zeros((4, 8), np.uint8)
    calls = [
        lambda: qmodel.init_cache(cfg, 1, 8),
        lambda: qmatmul.pack_runtime_v2(np.zeros((4, 256), np.uint8),
                                        SuperGroupParams(z, z, zi, zi), T.Q4_K),
        lambda: qmodel.load_gguf_for_serving(REPO / "missing.gguf"),
        lambda: qmodel.params_from_numpy({"embed_tokens": np.zeros((8, 256))}, cfg),
    ]
    # the quantize path: the walk, one solve, and the command line without --device
    from gptq_gguf_tpu_torch.__main__ import main
    from gptq_gguf_tpu_torch.ops import gptq
    from gptq_gguf_tpu_torch.quant import calibrate

    calls += [
        lambda: calibrate.quantize_model({"layers": []}, cfg, [np.zeros((1, 4), np.int64)]),
        lambda: gptq.gptq_quantize_matrix(np.zeros((4, 256), np.float32),
                                          np.eye(256, dtype=np.float32), T.Q4_K),
        lambda: main(["quantize", "--model_name_or_path", str(REPO / "missing"),
                      "--save_dir", str(REPO / "missing")]),
    ]
    # the paged serving path: its cache, its engine and the HTTP command line
    from gptq_gguf_tpu_torch.serving import engine, paged

    cpu_params = {"embed_tokens": torch.zeros(8, 256)}
    calls += [
        lambda: paged.init_paged_cache(cfg, 1, 64),
        lambda: engine.PagedContinuousBatchingEngine(cpu_params, cfg, max_len=64),
        lambda: main(["serve", "--http", "--paged", "--gguf-file", str(REPO / "missing.gguf")]),
    ]
    # the v1 / v4 formats, serving from artifacts and perplexity
    from gptq_gguf_tpu_torch.ops import qmv4

    calls += [
        lambda: qmatmul.pack_runtime(np.zeros((4, 256), np.uint8),
                                     SuperGroupParams(z, z, zi, zi), T.Q4_K),
        lambda: qmv4.pack_runtime_v4(np.zeros((4, 256), np.uint8),
                                     SuperGroupParams(z, z, zi, zi), T.Q4_K),
        lambda: qmatmul.pack_runtime_auto(np.zeros((4, 256), np.uint8),
                                          SuperGroupParams(z, z, zi, zi), T.Q4_K, fmt="v4"),
        lambda: qmodel.quantize_params_for_serving({"layers": []}, cfg, REPO / "missing"),
        lambda: main(["ppl", "--gguf-file", str(REPO / "missing.gguf")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        qmodel.init_cache(cfg, 1, 8, device="cuda")
    qmodel.init_cache(cfg, 1, 8, device="cpu")  # explicit CPU works


def test_chip_smoke_fails_without_card_or_checkout(no_cuda, tmp_path):
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, shutil.copy(REPO / "chip_smoke.py", tmp_path))):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
