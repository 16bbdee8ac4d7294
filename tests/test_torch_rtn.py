"""The port's RTN route (``quant/rtn.py``), its three commands and the
serving of recipe GGUFs against the JAX package, on the CPU.

``compute_imatrix`` on a tiny llama (JAX's params carried across) holds
the same keys as the JAX package's, each value within IMATRIX_RTOL: the
port accumulates only each Hessian's diagonal, JAX the whole matrix, so
the f32 sums run in another order. Given JAX's importance matrix,
``rtn_quantize_model`` writes JAX's artifacts bit for bit (default types,
a type map, ``quant_non_block``, ``quantizable_regex``) and returns the
same dequantized weights; ``quantization_summary`` gives JAX's dict.

The commands run in-process on the tiny checkpoint of
``tests/torch_pack_fixtures.py`` with synthetic data: ``imatrix`` (.npz
with HF and GGUF keys, and .imatrix) within IMATRIX_RTOL of the JAX
command's; ``llama-quantize --imatrix`` and ``rtn-quantize --imatrix
--outfile --summary`` write the JAX command's GGUF, artifacts and summary
(rtn-quantize given JAX's importance values, so the files compare
exactly). The port's serving loader and ``forward_cached`` on the tiny
Q4_K_M, IQ4_XS and Q4_0 recipe GGUFs hold JAX's logits within the serving
tests' LOGIT_TOL, and ``ppl --gguf-path dense`` of the IQ4_XS file JAX's
perplexity within PPL_RTOL."""

import contextlib
import filecmp
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptq_gguf_tpu.__main__ import main as jmain
from gptq_gguf_tpu.models import llama as jl
from gptq_gguf_tpu.quant import artifacts as jart
from gptq_gguf_tpu.quant import rtn as jrtn
from gptq_gguf_tpu.serving import model as jmodel
from gptq_gguf_tpu_torch.__main__ import main
from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
from gptq_gguf_tpu_torch.formats.gguf import GGUFWriter
from gptq_gguf_tpu_torch.models import llama
from gptq_gguf_tpu_torch.quant import artifacts, rtn
from gptq_gguf_tpu_torch.quant.imatrix_io import load_imatrix
from gptq_gguf_tpu_torch.serving import model as qmodel
from tests.test_torch_serving import _check_forward_logits
from tests.torch_pack_fixtures import _checkpoint

IMATRIX_RTOL = 1e-5  # measured at most 1e-6 (f32 sums in another order)
PPL_RTOL = 1e-4
FIELDS = ("q_type", "qweight", "super_group_scale", "super_group_zero", "group_scale_quant",
          "group_zero_quant")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the whole module, as tests/test_torch_pack.py's
    one_thread: the tests run in parallel workers, and torch's default pool
    of a thread per core in each of them stalls the fit's many small
    operations."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    """A tiny llama's JAX params and their port twin, three calibration
    sequences and JAX's importance matrix of them (batches of 2 and 1)."""
    jcfg = jl.LlamaConfig(vocab_size=128, hidden_size=256, intermediate_size=512,
                          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    jp = jl.init_params(jcfg, seed=3)
    cfg = llama.config_from_reference(jcfg)
    tp = llama.dense_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                                       device="cpu")
    rng = np.random.default_rng(18)
    calib = [rng.integers(0, 128, size=(1, 64)) for _ in range(3)]
    return jcfg, jp, cfg, tp, calib, jrtn.compute_imatrix(jp, jcfg, calib, batch_size=2)


def _assert_imatrix_close(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == np.shape(want[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=IMATRIX_RTOL, atol=0, err_msg=k)


def test_compute_imatrix_matches_jax(tiny):
    jcfg, jp, cfg, tp, calib, jim = tiny
    got = rtn.compute_imatrix(tp, cfg, calib, batch_size=2, device="cpu")
    assert len(got) == 7 * cfg.num_hidden_layers
    _assert_imatrix_close(got, jim)
    assert got["model.layers.1.mlp.down_proj"].shape == (cfg.intermediate_size,)


RTN_CASES = {
    "default": {},
    "type_map": dict(quant_config={"q_proj": "Q2_K", "v_proj": "Q6_K", "o_proj": "Q3_K",
                                   "gate_proj": "Q5_K"}),
    "non_block": dict(quant_config={"embed_tokens": "Q4_K"}, quant_non_block=True),
    "regex": dict(quantizable_regex=r"layers\.1\..*mlp"),
}


@pytest.mark.parametrize("case", list(RTN_CASES))
def test_rtn_quantize_model_matches_jax(tiny, case, tmp_path):
    jcfg, jp, cfg, tp, _, jim = tiny
    kw = RTN_CASES[case]
    want = jrtn.rtn_quantize_model(jp, jcfg, save_dir=tmp_path / "jax", imatrix=jim, **kw)
    got = rtn.rtn_quantize_model(tp, cfg, save_dir=tmp_path / "port", imatrix=jim,
                                 device="cpu", **kw)
    names = sorted(jart.list_layers(tmp_path / "jax"))
    assert names == sorted(artifacts.list_layers(tmp_path / "port"))
    assert len(names) == {"default": 14, "type_map": 14, "non_block": 16, "regex": 3}[case]
    for name in names:
        a = jart.load_layer(tmp_path / "jax", name)
        b = artifacts.load_layer(tmp_path / "port", name)
        for f in FIELDS:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype, (name, f)
            np.testing.assert_array_equal(y, x, err_msg=f"{name} {f}")
    for li, (lj, lt) in enumerate(zip(want["layers"], got["layers"])):
        for k in lj:
            np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]),
                                          err_msg=f"layer {li} {k}")
    for k in ("embed_tokens", "lm_head"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_quantization_summary_matches_jax(tmp_path):
    p = tmp_path / "m.gguf"
    w = GGUFWriter(p)
    w.add_kv("general.architecture", "llama")
    w.add_tensor("a", np.zeros((4, 256), np.float16))
    w.add_tensor("b", np.zeros((2, 256), np.float32))
    w.add_tensor("c", np.zeros((3, 144), np.uint8), raw_dtype=T.Q4_K, raw_shape=(3, 256))
    w.write()
    got = rtn.quantization_summary(p, tmp_path / "port.json")
    want = jrtn.quantization_summary(p, tmp_path / "jax.json")
    assert got == want
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert got["total_elements"] == 4 * 256 + 2 * 256 + 3 * 256
    assert got["types"]["Q4_K"] == {"tensors": 1, "bytes": 3 * 144, "elements": 768}


DATA = ["--calibration_data", "synthetic", "--calibration_tokens", "256",
        "--calibration_sequence_length", "64"]


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """Both packages' commands on the tiny checkpoint: imatrix (.imatrix
    and .npz), the F16 GGUF (the port's pack), llama-quantize Q4_K_M with
    JAX's .imatrix, and the port's IQ4_XS and Q4_0 recipe files."""
    root = tmp_path_factory.mktemp("rtn_cli")
    d, _ = _checkpoint(root, "bpe_f16")
    model = ["--model_name_or_path", str(d)]
    out = {"root": root, "model": d}
    for name, fn, dev in (("jax", jmain, []), ("port", main, ["--device", "cpu"])):
        for ext in ("imatrix", "npz"):
            out[f"{name}.{ext}"] = _run(fn, ["imatrix", *model, *DATA, "--output",
                                             str(root / f"{name}.{ext}"), *dev])
    (root / "none").mkdir()
    _run(main, ["pack", "--model_dir", str(d), "--quant_dir", str(root / "none"), "--outfile",
                str(root / "f16.gguf")])
    for name, fn, dev in (("jax", jmain, []), ("port", main, ["--device", "cpu"])):
        out[f"{name}.q4km"] = _run(fn, [
            "llama-quantize", "--input", str(root / "f16.gguf"), "--output",
            str(root / f"{name}-Q4_K_M.gguf"), "--ftype", "Q4_K_M", "--imatrix",
            str(root / "jax.imatrix"), "--summary", str(root / f"{name}-Q4_K_M.json"),
            "--verbose", *dev])
    for ftype in ("IQ4_XS", "Q4_0"):
        _run(main, ["llama-quantize", "--input", str(root / "f16.gguf"), "--output",
                    str(root / f"port-{ftype}.gguf"), "--ftype", ftype, "--device", "cpu"])
    return out


def test_imatrix_command_matches_jax(cli):
    root = cli["root"]
    want, _, wset = load_imatrix(root / "jax.imatrix")
    got, ncalls, dataset = load_imatrix(root / "port.imatrix")
    _assert_imatrix_close(got, want)
    assert all(k.startswith("blk.") for k in got) and len(got) == 14
    assert dataset == wset == "synthetic" and set(ncalls.values()) == {1}
    assert cli["port.imatrix"] == [line.replace("jax.imatrix", "port.imatrix")
                                   for line in cli["jax.imatrix"]]
    with np.load(root / "jax.npz") as a, np.load(root / "port.npz") as b:
        assert a.files == b.files and len(b.files) == 28
        _assert_imatrix_close({k: b[k] for k in b.files}, {k: a[k] for k in a.files})
        np.testing.assert_array_equal(b["blk.1.ffn_down.weight"],
                                      b["model.layers.1.mlp.down_proj"])
    assert cli["port.npz"][-1] == cli["jax.npz"][-1].replace("jax.npz", "port.npz")


def test_llama_quantize_command_matches_jax(cli):
    root = cli["root"]
    assert filecmp.cmp(root / "jax-Q4_K_M.gguf", root / "port-Q4_K_M.gguf", shallow=False)
    assert cli["port.q4km"] == [line.replace("jax-", "port-") for line in cli["jax.q4km"]]
    assert cli["port.q4km"][-1].endswith("bpw)")
    a = json.loads((root / "jax-Q4_K_M.json").read_text())
    b = json.loads((root / "port-Q4_K_M.json").read_text())
    assert b == {**a, "file": str(root / "port-Q4_K_M.gguf")}
    assert set(b["types"]) == {"Q4_K", "Q6_K", "F32"}


def test_rtn_quantize_command_matches_jax(cli, monkeypatch, tmp_path):
    """rtn-quantize --imatrix --outfile --summary. Each command computes its
    own importance matrix; the port's is held to JAX's above, and here it
    is JAX's own values, so the files compare exactly."""
    root, d = cli["root"], cli["model"]
    with np.load(root / "jax.npz") as z:
        jim = {k: z[k] for k in z.files if k.startswith("model.")}
    seen = {}

    def jax_imatrix(params, cfg, calib, batch_size=1, device="cuda"):
        seen["calib"] = calib
        return jim

    monkeypatch.setattr(rtn, "compute_imatrix", jax_imatrix)
    for name, fn, dev in (("jax", jmain, []), ("port", main, ["--device", "cpu"])):
        lines = _run(fn, ["rtn-quantize", "--model_name_or_path", str(d), *DATA, "--imatrix",
                          "--save_dir", str(tmp_path / f"{name}-layers"), "--outfile",
                          str(tmp_path / f"{name}.gguf"), "--summary",
                          str(tmp_path / f"{name}.json"), *dev])
        assert lines[-1] == f"wrote {tmp_path / f'{name}.gguf'}"
    assert len(seen["calib"]) == 4 and seen["calib"][0].shape == (1, 64)
    assert filecmp.cmp(tmp_path / "jax.gguf", tmp_path / "port.gguf", shallow=False)
    a = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == {
        **a, "file": str(tmp_path / "port.gguf")}
    names = sorted(jart.list_layers(tmp_path / "jax-layers"))
    assert names == sorted(artifacts.list_layers(tmp_path / "port-layers")) and len(names) == 14
    for name in names:
        x = jart.load_layer(tmp_path / "jax-layers", name)
        y = artifacts.load_layer(tmp_path / "port-layers", name)
        assert y.q_type == T.Q4_K
        for f in FIELDS[1:]:
            np.testing.assert_array_equal(getattr(y, f), getattr(x, f), err_msg=f"{name} {f}")


@pytest.mark.parametrize("ftype", ["Q4_K_M", "IQ4_XS", "Q4_0"])
def test_recipe_gguf_serves_like_jax(cli, ftype):
    """The port's loader (the float branch for Q4_0 / IQ4_XS tensors, the
    runtime format for K-quants) and forward_cached against JAX's."""
    path = cli["root"] / f"port-{ftype}.gguf"
    jp, jcfg = jmodel.load_gguf_for_serving(path, dtype=jnp.float32)
    tp, tcfg = qmodel.load_gguf_for_serving(path, dtype=torch.float32, device="cpu")
    assert llama.config_from_reference(jcfg) == tcfg
    q = tp["layers"][0]["q_proj"]
    want = {"Q4_K_M": "RuntimeQuantLinearV2", "IQ4_XS": "Tensor", "Q4_0": "Tensor"}[ftype]
    assert type(q).__name__ == want
    if want == "Tensor":  # dense: the GGUF tensor's dequantization, rope rows undone
        np.testing.assert_array_equal(q.numpy(), np.asarray(jp["layers"][0]["q_proj"]))
    _check_forward_logits(jmodel.fuse_params_for_serving(jp, jcfg), jcfg,
                          qmodel.fuse_params_for_serving(tp, tcfg), tcfg)


def test_ppl_dense_of_iq4_xs_matches_jax(cli):
    path, root = cli["root"] / "port-IQ4_XS.gguf", cli["root"]
    argv = ["ppl", "--gguf-file", str(path), "--gguf-path", "dense", "--datasets", "synthetic",
            "--eval_tokens", "256", "--sequence_length", "64"]
    _run(jmain, [*argv, "--output_path", str(root / "ppl-jax.json")])
    _run(main, [*argv, "--output_path", str(root / "ppl-port.json"), "--device", "cpu"])
    want = json.loads((root / "ppl-jax.json").read_text())["synthetic"]
    got = json.loads((root / "ppl-port.json").read_text())["synthetic"]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=PPL_RTOL)


def test_route_defaults_to_cuda(tiny):
    """Every entry point of the route runs on the card unless asked for the
    CPU, and raises on a host without one (before reading any file)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    from gptq_gguf_tpu_torch.quant import recipes

    _, _, cfg, tp, calib, _ = tiny
    missing = "/nonexistent/m"
    calls = [
        lambda: rtn.compute_imatrix(tp, cfg, calib),
        lambda: rtn.rtn_quantize_model(tp, cfg),
        lambda: recipes.quantize_tensor_blocks(np.zeros((2, 256), np.float32), T.Q4_K),
        lambda: recipes.llama_quantize(missing + ".gguf", missing + "-q.gguf", "Q4_K_M"),
        lambda: main(["imatrix", "--model_name_or_path", missing, "--output", missing]),
        lambda: main(["rtn-quantize", "--model_name_or_path", missing, "--save_dir", missing]),
        lambda: main(["llama-quantize", "--input", missing, "--output", missing,
                      "--ftype", "Q4_K_M"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the host codecs need no device
    assert recipes.quantize_tensor_blocks(np.zeros((2, 256), np.float32), T.Q4_0).shape == (16, 18)
