"""The port's layer database, stitcher, config converter and shard merge
against the JAX package's, on the CPU.

The inputs are GGUFs that the port's ``pack`` writes from seeded K-quant
artifacts of a tiny llama (hidden 256, 2 layers), one per level: Q2_K, Q4_K
and Q6_K (``tests/torch_pack_fixtures.py``; no GPTQ run). Every output is
held to the JAX tool's on the same files: raw ``.pth`` bytes and JSON
byte for byte (the manifests' timestamps aside), the dequantized ``.pth``
tensors with ``torch.equal``. The one departure is the stitched
``general.file_type`` (``mapper/stitcher.py``): a stitched file equals
JAX's in every other byte, and a uniform database stitches back to
``pack``'s file byte for byte.
"""

import contextlib
import filecmp
import io
import json

import pytest
import torch

from gptq_gguf_tpu.__main__ import main as jmain
from gptq_gguf_tpu.mapper import config_converter as jconv
from gptq_gguf_tpu.mapper import db_builder as jdb
from gptq_gguf_tpu.mapper import shards as jshards
from gptq_gguf_tpu.mapper import splitter as jsplit
from gptq_gguf_tpu.mapper import stitcher as jstitch
from gptq_gguf_tpu_torch.__main__ import main
from gptq_gguf_tpu_torch.formats.ggml import FILE_TYPE_IDS, GGMLQuantizationType as T
from gptq_gguf_tpu_torch.mapper import config_converter, db_builder, shards, splitter, stitcher
from tests.torch_pack_fixtures import write_level_ggufs

LEVELS = ("Q2_K", "Q4_K", "Q6_K")
TIMESTAMPS = {"split_timestamp", "created"}


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    """(tmp dir, {level: GGUF}) and both packages' databases of the three;
    one torch thread meanwhile (the search's small forwards), as
    tests/test_torch_pack.py's one_thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("mapper")
    _, files = write_level_ggufs(tmp)
    paths = [files[lv] for lv in LEVELS]
    db_builder.build_ep_database(paths, tmp / "db")
    jdb.build_ep_database(paths, tmp / "jdb")
    yield tmp, files
    torch.set_num_threads(threads)


def _drop_timestamps(obj):
    if isinstance(obj, dict):
        return {k: _drop_timestamps(v) for k, v in obj.items() if k not in TIMESTAMPS}
    return obj


def assert_same_tree(a, b, hf=False):
    """Two databases hold the same files: JSON equal (timestamps aside),
    ``.pth`` bytes equal, or equal torch tensors of one dtype with ``hf``."""
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files
    for rel in files:
        fa, fb = a / rel, b / rel
        if rel.suffix == ".json":
            ja, jb = json.loads(fa.read_text()), json.loads(fb.read_text())
            if TIMESTAMPS & set(json.dumps(ja).split('"')):
                assert _drop_timestamps(ja) == _drop_timestamps(jb), rel
            else:
                assert fa.read_bytes() == fb.read_bytes(), rel
        elif hf and rel.suffix == ".pth":
            ta = torch.load(fa, weights_only=True)
            tb = torch.load(fb, weights_only=True)
            assert ta.dtype == tb.dtype == torch.float16 and torch.equal(ta, tb), rel
        else:
            assert fa.read_bytes() == fb.read_bytes(), rel


@pytest.mark.parametrize("level", LEVELS)
def test_split_gguf_matches_jax(ggufs, tmp_path, level):
    _, files = ggufs
    got = splitter.split_gguf(files[level], tmp_path / "port")
    want = jsplit.split_gguf(files[level], tmp_path / "jax")
    assert _drop_timestamps(got) == _drop_timestamps(want)
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    assert (tmp_path / "port" / "blk.0.attn_q.weight" /
            f"{splitter._bits_prefix(splitter.nominal_bits(level))}-{level}.pth").is_file()


@pytest.mark.parametrize("level", LEVELS)
def test_split_hf_matches_jax(ggufs, tmp_path, level):
    _, files = ggufs
    splitter.split_hf(files[level], tmp_path / "port")
    jsplit.split_hf(files[level], tmp_path / "jax")
    assert_same_tree(tmp_path / "port", tmp_path / "jax", hf=True)
    mapping = json.loads((tmp_path / "port" / "hf_to_gguf_mapping.json").read_text())
    assert len(mapping) == 14 and mapping["model.layers.1.self_attn.k_proj.weight"] == \
        "blk.1.attn_k.weight"


def test_build_db_and_list_bitwidths(ggufs):
    tmp, _ = ggufs
    assert_same_tree(tmp / "db" / "layers-gguf", tmp / "jdb" / "layers-gguf")
    assert_same_tree(tmp / "db" / "layers-hf", tmp / "jdb" / "layers-hf", hf=True)
    got = json.loads((tmp / "db" / "manifest.json").read_text())
    assert _drop_timestamps(got) == _drop_timestamps(
        json.loads((tmp / "jdb" / "manifest.json").read_text()))
    assert [m["inferred_quant_type"] for m in got["models"]] == list(LEVELS)
    for sub in ("layers-gguf", "layers-hf"):
        bws = splitter.list_bitwidths(tmp / "db" / sub)
        assert bws == jsplit.list_bitwidths(tmp / "db" / sub)
        assert bws["blk.0.ffn_down.weight" if sub == "layers-gguf"
                   else "model.layers.0.mlp.down_proj"] == [2.5625, 4.5, 6.5625]
    assert db_builder.infer_qtype_from_filename("m-q6_k.gguf") == "Q6_K"


CONFIGS = {
    "dense": "# search output\n"
             "model.layers.0.self_attn.q_proj: 6.5625 (6.5625-Q6_K.pth)\n"
             "model.layers.0.mlp.down_proj.weight: 4.5 (4.5-Q4_K.pth)\n"
             "model.layers.1.self_attn.v_proj: 2.5625\n"
             "model.layers.x.mlp.up_proj: 4.5\nmodel.embed_tokens: 16\nlm_head: 6.5625\n"
             "model.norm: 32\nrope_freqs: 32\nnot a config line\n",
    "moe": "model.layers.0.mlp.experts.down_proj: 4.5 (4.5-Q4_K.pth)\n"
           "model.layers.0.mlp.gate: 16\nmodel.layers.2.self_attn.q_norm: 32\n"
           "model.layers.1.self_attn.kv_b_proj: 6.5625\nlm_head: 6.5625\n",
}


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_convert_config_matches_jax(tmp_path, kind):
    src = tmp_path / "in.txt"
    src.write_text(CONFIGS[kind])
    got = config_converter.convert_file(str(src), str(tmp_path / "port.txt"), "16")
    want = jconv.convert_file(str(src), str(tmp_path / "jax.txt"), "16")
    assert got == want and config_converter.detect_moe(CONFIGS[kind]) == (kind == "moe")
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


VARIANTS = [{"bitwidth": 4.5, "filename": "4.5-Q4_K.pth", "quant_type": "Q4_K"},
            {"bitwidth": 4.5, "filename": "4.5-Q4_0.pth", "quant_type": "Q4_0"},
            {"bitwidth": 6.5625, "filename": "6.5625-Q6_K.pth", "quant_type": "Q6_K"},
            {"bitwidth": 2.5625, "filename": "2.5625.pth", "quant_type": None}]
MATCH_CASES = {
    "exact_bits_and_type": ("match", 4.5, "Q4_0"),
    "exact_bits": ("match", 4.5, "Q5_K"),
    "closest_of_type": ("match", 3.0, "Q6_K"),
    "closest": ("match", 3.0, None),
    "closest_no_such_type": ("match", 7.0, "IQ4_XS"),
    "parse": ("parse", "a: 4.5 (4.5-Q4_K.pth)\nb: 6.5625 Q6_K\nb2: 3\nc: 3 Q4_K\n"
                       "# a: 2\n\nd: x\ne:\nf: 2.5625 (2.5625.pth)\n"),
}


@pytest.mark.parametrize("case", list(MATCH_CASES))
def test_find_best_match_and_parse_config(tmp_path, case):
    kind, *args = MATCH_CASES[case]
    if kind == "match":
        got = stitcher.find_best_match(VARIANTS, *args)
        assert got == jstitch.find_best_match(VARIANTS, *args)
        return
    path = tmp_path / "cfg.txt"
    path.write_text(args[0])
    avail = {"b": VARIANTS, "b2": VARIANTS}
    got = stitcher.parse_config_file(path, avail)
    want = jstitch.parse_config_file(path, avail)
    assert {k: (v.bitwidth, v.filename, v.quant_type, v.filename_prefix)
            for k, v in got.items()} == {k: (v.bitwidth, v.filename, v.quant_type,
                                             v.filename_prefix) for k, v in want.items()}
    assert got["b2"].filename == "2.5625.pth" and got["c"].filename == "3-Q4_K.pth"


def _stitch_config(path):
    """A mixed config in the stitcher's format, most tensors left to the
    default (Q4_K, the majority type)."""
    path.write_text("blk.0.attn_q.weight: 6.5625 (6.5625-Q6_K.pth)\n"
                    "blk.1.ffn_down.weight: 6.5625 Q6_K\n"
                    "blk.0.attn_v.weight: 2.5625 (2.5625-Q2_K.pth)\n")
    return path


@pytest.mark.parametrize("case", ["valid", "empty_dir", "missing_dir", "missing_file"])
def test_stitcher_validate(ggufs, tmp_path, case):
    tmp, _ = ggufs
    split_dir, cfg = tmp / "db" / "layers-gguf", _stitch_config(tmp_path / "cfg.txt")
    if case == "empty_dir":
        split_dir = tmp_path / "empty"
        split_dir.mkdir()
    elif case == "missing_dir":
        split_dir = tmp_path / "nowhere"
    elif case == "missing_file":
        cfg.write_text("blk.0.attn_q.weight: 5.5 (5.5-Q5_K.pth)\n")
    got = stitcher.GGUFStitcher(split_dir, cfg).validate()
    assert got == jstitch.GGUFStitcher(split_dir, cfg).validate()
    assert bool(got) == (case != "valid")


def assert_equal_but_file_type(port, jax_file, want_id):
    """Two GGUFs equal byte for byte except the general.file_type value,
    which is ``want_id`` in the port's file."""
    a, b = port.read_bytes(), jax_file.read_bytes()
    assert len(a) == len(b)
    key = b"general.file_type"
    at = a.index(key) + len(key) + 4  # the key, then its u32 type, then the u32 value
    assert a[:at] == b[:at] and a[at + 4:] == b[at + 4:]
    assert int.from_bytes(a[at:at + 4], "little") == want_id


def test_stitcher_lists_and_stitches_like_jax(ggufs, tmp_path):
    tmp, files = ggufs
    split_dir, cfg = tmp / "db" / "layers-gguf", _stitch_config(tmp_path / "cfg.txt")
    st, jst = stitcher.GGUFStitcher(split_dir, cfg), jstitch.GGUFStitcher(split_dir, cfg)
    assert st.list_tensors() == jst.list_tensors()
    assert [st.list_tensors()[n]["quant_type"] for n in
            ("blk.0.attn_q.weight", "blk.1.ffn_down.weight", "blk.0.attn_v.weight",
             "blk.0.attn_k.weight", "output_norm.weight")] == ["Q6_K", "Q6_K", "Q2_K", "Q4_K",
                                                                "F32"]
    st.stitch(tmp_path / "port.gguf")
    jst.stitch(tmp_path / "jax.gguf")
    assert_equal_but_file_type(tmp_path / "port.gguf", tmp_path / "jax.gguf",
                               FILE_TYPE_IDS[T.Q4_K])
    assert stitcher.calculate_file_type(st.config) == 15
    assert jstitch.calculate_file_type(jst.config) == 12  # llama.cpp's Q3_K_M
    # each tensor the source GGUF's bytes of the type the config picked
    from gptq_gguf_tpu_torch.formats.gguf import GGUFReader

    out = GGUFReader(tmp_path / "port.gguf")
    src = {lv: GGUFReader(files[lv]) for lv in LEVELS}
    assert out.tensor_order == src["Q4_K"].tensor_order
    for name in out.tensor_order:
        lv = st.config[name].quant_type
        lv = lv if lv in src else "Q4_K"  # the float tensors are the same in every level
        assert bytes(out.tensor_bytes(name)) == bytes(src[lv].tensor_bytes(name)), name


@pytest.mark.parametrize("level", LEVELS)
def test_uniform_round_trip_gives_packs_bytes(ggufs, tmp_path, level):
    """pack -> split -> stitch of one level gives back pack's file, its
    general.file_type included (pack's id for the type)."""
    _, files = ggufs
    splitter.split_gguf(files[level], tmp_path / "db")
    bits = splitter.nominal_bits(level)
    st = stitcher.GGUFStitcher(tmp_path / "db", default_bitwidth=bits, default_quant_type=level)
    assert stitcher.calculate_file_type(st.config) == FILE_TYPE_IDS[T[level]]
    st.stitch(tmp_path / "back.gguf")
    assert filecmp.cmp(tmp_path / "back.gguf", files[level], shallow=False)


@pytest.mark.parametrize("bound", ["tensors", "size"])
def test_merge_after_split_matches_jax_and_source(ggufs, tmp_path, bound):
    _, files = ggufs
    src = files["Q4_K"]
    kw = {"max_tensors": 5} if bound == "tensors" else {"max_size": 40_000}
    got = shards.split_gguf_file(src, tmp_path / "port", **kw)
    want = jshards.split_gguf_file(src, tmp_path / "jax", **kw)
    assert len(got) == len(want) > 2
    for a, b in zip(got, want):
        assert filecmp.cmp(a, b, shallow=False)
    shards.merge_gguf_files(got[0], tmp_path / "port.gguf")
    jshards.merge_gguf_files(got[0], tmp_path / "jax.gguf")
    assert filecmp.cmp(tmp_path / "port.gguf", tmp_path / "jax.gguf", shallow=False)
    assert filecmp.cmp(tmp_path / "port.gguf", src, shallow=False)
    with pytest.raises(ValueError, match="not a sharded"):
        shards.merge_gguf_files(src, tmp_path / "x.gguf")


def _printed(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


CLI = ["split", "stitch", "convert-config", "build-db", "search", "gguf-split"]


@pytest.mark.parametrize("cmd", CLI)
def test_cli_matches_jax(ggufs, tmp_path, cmd, monkeypatch):
    """Each command through the port's ``main`` and the JAX package's, on
    the same inputs: the same files (and the same printed lines)."""
    tmp, files = ggufs
    p, j = tmp_path / "port", tmp_path / "jax"
    if cmd == "split":
        for flag in ("--gguf-layers", "--hf-layers"):
            main(["split", "--gguf-file", str(files["Q6_K"]), "--output-dir", str(p / flag), flag])
            jmain(["split", "--gguf-file", str(files["Q6_K"]), "--output-dir", str(j / flag),
                   flag])
            assert_same_tree(p / flag, j / flag, hf=flag == "--hf-layers")
        argv = ["split", "--gguf-file", "-", "--output-dir", str(tmp / "db" / "layers-gguf"),
                "--list-bitwidths"]
        assert _printed(main, argv) == _printed(jmain, argv)
    elif cmd == "stitch":
        argv = ["stitch", "--split-dir", str(tmp / "db" / "layers-gguf"), "--config",
                str(_stitch_config(tmp_path / "cfg.txt"))]
        for flag in ("--validate-only", "--list-tensors", "--inspect-metadata"):
            assert _printed(main, argv + [flag]) == _printed(jmain, argv + [flag])
        main(argv + ["--output", str(tmp_path / "port.gguf")])
        jmain(argv + ["--output", str(tmp_path / "jax.gguf")])
        assert_equal_but_file_type(tmp_path / "port.gguf", tmp_path / "jax.gguf", 15)
        empty = ["stitch", "--split-dir", str(tmp_path / "empty"), "--validate-only"]
        (tmp_path / "empty").mkdir()
        with pytest.raises(SystemExit):
            main(empty)
    elif cmd == "convert-config":
        (tmp_path / "in.txt").write_text(CONFIGS["dense"])
        for fn, out in ((main, p), (jmain, j)):
            fn(["convert-config", "--input", str(tmp_path / "in.txt"), "--output", str(out),
                "--missing-value", "4.5"])
        assert p.read_bytes() == j.read_bytes()
    elif cmd == "build-db":
        for fn, out in ((main, p), (jmain, j)):
            fn(["build-db", "--models", str(files["Q2_K"]), str(files["Q6_K"]), "--output-dir",
                str(out), "--copy-models", "--skip-hf"])
        assert_same_tree(p, j)
        assert not (p / "layers-hf").exists() and (p / "models" / files["Q2_K"].name).is_file()
    elif cmd == "search":
        from gptq_gguf_tpu.cli import common as jcommon

        monkeypatch.setattr(jcommon, "load_tokenizer", lambda args: None)
        argv = ["search", "--model_name_or_path", str(tmp / "m"), "--target_bitwidth", "5.5",
                "--fitness_fn", "ppl", "--calibration_data", "synthetic",
                "--calibration_tokens", "256", "--calibration_sequence_length", "32",
                "--generations", "2", "--offspring", "3", "--survivors_per_selection", "2", "1",
                "--tokens_per_selection", "64", "128", "--initially_generated", "3",
                "--initial_tokens", "64", "--seed", "3"]
        written = []
        for fn, out, extra in ((main, p, ["--device", "cpu"]), (jmain, j, [])):
            db = out / "layers-hf"
            db.mkdir(parents=True)
            for level in ("Q2_K", "Q6_K"):
                jsplit.split_hf(files[level], db)
            fn(argv + ["--quant_weights_path", str(db)] + extra)
            written.append((db / "evo-ppl-configuration-5.5.txt").read_text())
        assert written[0] == written[1] and len(written[0].splitlines()) == 14
    else:
        for fn, out in ((main, p), (jmain, j)):
            fn(["gguf-split", "--input", str(files["Q4_K"]), "--output", str(out),
                "--split-max-size", "160K"])
            first = sorted(tmp_path.glob(f"{out.name}-*.gguf"))[0]
            fn(["gguf-split", "--merge", "--input", str(first), "--output", f"{out}.gguf"])
        got, want = sorted(tmp_path.glob("port-*.gguf")), sorted(tmp_path.glob("jax-*.gguf"))
        assert len(got) == len(want) > 2
        for a, b in zip(got, want):
            assert filecmp.cmp(a, b, shallow=False)
        assert filecmp.cmp(f"{p}.gguf", files["Q4_K"], shallow=False)
        assert filecmp.cmp(f"{p}.gguf", f"{j}.gguf", shallow=False)
