"""The port's EvoPress search against the JAX package's, on the CPU.

The database is ``split_hf`` of three GGUFs that the port's ``pack``
writes from seeded artifacts of a tiny llama (hidden 256, 2 layers) at
Q2_K, Q4_K and Q6_K (``tests/torch_pack_fixtures.py``); the dense model
is the same checkpoint, loaded by each package. The grouping and the
mutations are held to JAX's exactly, draw for draw from one seed. The
fitness functions run the dense forward in f32 in both packages, with
sums in another order, so they are held within RTOL (1e-4) relative plus
ATOL (1e-6): the forward's f32 rounding is ~1e-6 of each logit. The search
with the ppl fitness makes JAX's choices end to end, which the smallest
relative gap between the fitnesses its selections ranked shows to be more
than twice that tolerance; the sparse-KL search at the same seed ranks two
candidates closer than that, so it is held selection by selection. Then
the pipeline through the port's command line: build-db -> search ->
convert-config -> stitch -> serve.
"""

import copy
import json
import random

import numpy as np
import pytest
import torch

from gptq_gguf_tpu.models import loader as jloader
from gptq_gguf_tpu.search import evopress as jevo
from gptq_gguf_tpu_torch.__main__ import main
from gptq_gguf_tpu_torch.formats.gguf import GGUFReader
from gptq_gguf_tpu_torch.mapper import splitter
from gptq_gguf_tpu_torch.models import llama, loader
from gptq_gguf_tpu_torch.search import evopress
from gptq_gguf_tpu_torch.utils import data
from tests.torch_pack_fixtures import write_level_ggufs

LEVELS = ("Q2_K", "Q4_K", "Q6_K")
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(tmp, checkpoint dir, GGUFs, layers-hf database, port (params, cfg),
    JAX (params, cfg), calibration sequences); one torch thread meanwhile,
    as tests/test_torch_pack.py's one_thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("search")
    d, files = write_level_ggufs(tmp)
    db = tmp / "layers-hf"
    for level in LEVELS:
        splitter.split_hf(files[level], db)
    cfg = loader.load_config(d)
    port = (loader.load_params(d, cfg), cfg)
    jcfg = jloader.load_config(d)
    jax_ = (jloader.load_params(d, jcfg), jcfg)
    calib = data.get_synthetic(256, 32, cfg.vocab_size, seed=5)
    state = random.getstate()
    yield dict(tmp=tmp, ckpt=d, files=files, db=db, port=port, jax=jax_, calib=calib)
    random.setstate(state)
    torch.set_num_threads(threads)


def _models(s):
    return (evopress.SearchModel(*s["port"], s["db"], device="cpu"),
            jevo.SearchModel(*s["jax"], s["db"]))


def _close(a, b):
    return abs(a - b) <= ATOL + RTOL * abs(b)


@pytest.mark.parametrize("rule", ["none", "name", "size"])
def test_scan_and_groups_match_jax(setup, rule):
    model, jmodel = _models(setup)
    avail = evopress.scan_available_bitwidths(setup["db"])
    assert avail == jevo.scan_available_bitwidths(setup["db"])
    assert len(avail) == 14 and [b for b, _ in avail["model.layers.0.mlp.up_proj"]] == \
        [2.5625, 4.5, 6.5625]
    names = sorted(avail, key=evopress.layer_order_fn)
    assert names == sorted(avail, key=jevo.layer_order_fn)
    groups = evopress.group_layers(names, rule, model.numel)
    assert groups == jevo.group_layers(names, rule, jmodel.numel)
    assert len(groups) == {"none": 1, "name": 7, "size": 3}[rule]


def _random_state(groups, avail, rng):
    return [[float(rng.choice([b for b, _ in avail[n]])) for n in names] for names in groups]


@pytest.mark.parametrize("fn", ["repair", "grouped", "ungrouped"])
def test_mutations_draw_for_draw(setup, fn):
    """From random.seed(s) in JAX and random.Random(s) in the port, the same
    state after the call, the same return value, and the generators in the
    same state (so every draw was the same)."""
    model, _ = _models(setup)
    avail = evopress.scan_available_bitwidths(setup["db"])
    names = sorted(avail, key=evopress.layer_order_fn)
    groups = evopress.group_layers(names, "none" if fn == "ungrouped" else "size", model.numel)
    pick = np.random.default_rng(1)
    moved = 0
    for seed in range(24):
        start = _random_state(groups, avail, pick)
        target = sum(int(model.numel(n) * (3.5 + seed % 4 * 0.5)) for n in names)
        args = (target, groups, avail, model.numel)
        rng, mine, theirs = random.Random(seed), copy.deepcopy(start), copy.deepcopy(start)
        random.seed(seed)
        if fn == "repair":
            got = evopress._repair_budget(rng, mine, *args)
            want = jevo._repair_budget(theirs, *args)
        else:
            flips = 1 + seed % 3
            got = getattr(evopress, f"mutate_{fn}")(rng, mine, flips, *args)
            want = getattr(jevo, f"mutate_{fn}")(theirs, flips, *args)
        assert (got, mine) == (want, theirs), seed
        assert rng.getstate() == random.getstate(), seed
        moved += mine != start
    assert moved >= 12


def _state(s):
    """A mixed state over the "size" groups, and the groups and database."""
    model, _ = _models(s)
    avail = evopress.scan_available_bitwidths(s["db"])
    groups = evopress.group_layers(sorted(avail, key=evopress.layer_order_fn), "size",
                                   model.numel)
    return _random_state(groups, avail, np.random.default_rng(3)), groups, avail


@pytest.mark.parametrize("fitness_fn", ["ppl", "kl", "sparse_kl"])
def test_fitness_matches_jax(setup, fitness_fn):
    """Each fitness function on a mixed state: the port's against JAX's on
    JAX's teacher logits, and on its own teacher (torch.topk) too."""
    model, jmodel = _models(setup)
    state, groups, avail = _state(setup)
    calib = setup["calib"][:3]
    teacher = mine = None
    if fitness_fn != "ppl":
        teacher = [np.array(t) if fitness_fn == "kl" else t  # writable copies of JAX's
                   for t in jevo.compute_target_logits(jmodel, calib, fitness_fn, topk=16)]
        mine = evopress.compute_target_logits(model, calib, fitness_fn, topk=16)
    model.load_layers(groups, state, avail)
    jmodel.load_layers(groups, state, avail)
    want = jevo.compute_fitness(jmodel, calib, fitness_fn, teacher)
    got = evopress.compute_fitness(model, calib, fitness_fn, teacher)
    assert np.isfinite(want) and want > 0 and _close(got, want), (got, want)
    if fitness_fn != "ppl":
        own = evopress.compute_fitness(model, calib, fitness_fn, mine)
        assert _close(own, want), (own, want)


def test_target_logits_match_jax(setup):
    """Dense teacher logits within the tolerance; top-k ids equal as sets
    at every position where the k-th and (k+1)-th logits do not tie (within
    the tolerance), values within it."""
    model, jmodel = _models(setup)
    calib, k = setup["calib"][:2], 16
    dense = evopress.compute_target_logits(model, calib, "kl")
    jdense = jevo.compute_target_logits(jmodel, calib, "kl")
    sparse = evopress.compute_target_logits(model, calib, "sparse_kl", topk=k)
    jsparse = jevo.compute_target_logits(jmodel, calib, "sparse_kl", topk=k)
    untied = 0
    for a, b, (v, i), (jv, ji) in zip(dense, jdense, sparse, jsparse):
        assert isinstance(a, np.ndarray) and isinstance(v, torch.Tensor)
        scale = np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale)
        np.testing.assert_allclose(v.numpy(), jv, rtol=RTOL, atol=RTOL * scale)
        top = -np.sort(-b, axis=-1)
        for pos in range(b.shape[1]):
            if top[0, pos, k - 1] - top[0, pos, k] > 2 * RTOL * scale:
                assert set(i[0, pos].tolist()) == set(ji[0, pos].tolist()), pos
                untied += 1
    assert untied >= 60


def _spied_search(module, model, calib, ecfg, teacher, monkeypatch):
    """Run ``module``'s search, recording each selection: its arguments, the
    global ``random`` state before and after it (JAX draws from it), every
    candidate it scored (state and fitness) and its survivors."""
    records = []
    fitness0, selection0 = module.compute_fitness, module.selection

    def fitness(m, *a, **kw):
        f = fitness0(m, *a, **kw)
        records[-1]["scored"].append((copy.deepcopy(m.state), f))
        return f

    def selection(*a, **kw):
        records.append(dict(args=copy.deepcopy(a[3:7] if module is jevo else a[4:8]),
                            before=random.getstate(), scored=[]))
        out = selection0(*a, **kw)
        records[-1].update(keep=copy.deepcopy(out[0]), after=random.getstate())
        return out

    with monkeypatch.context() as mp:
        mp.setattr(module, "compute_fitness", fitness)
        mp.setattr(module, "selection", selection)
        best = module.evo_press_search(model, calib, ecfg, target_logits=teacher,
                                       log=lambda msg: None)
    return best, records


def _deciding_gaps(rec):
    """Relative gaps between adjacent distinct fitnesses a selection ranked
    among its survivors and the first one it dropped."""
    distinct = sorted({json.dumps(st): f for st, f in rec["scored"]}.values())
    n = rec["args"][1] + 1  # num_survive
    return [(b - a) / abs(b) for a, b in zip(distinct[:n], distinct[1:n])]


@pytest.mark.parametrize("fitness_fn,target,compare", [
    ("ppl", 5.0, "end_to_end"), ("sparse_kl", 5.5, "selection_by_selection")])
def test_search_matches_jax(setup, tmp_path, monkeypatch, fitness_fn, target, compare):
    """Both searches from seed 0. Where every ranking's gaps exceed twice
    the tolerance (ppl at this seed: no admissible fitness error can
    reorder it), end to end: every selection scores the same candidates in
    the same order, fitnesses within the tolerance, and keeps the same
    survivors, so every generation's parent, the checkpoint and the best
    state are JAX's. Sparse KL at this seed ranks two candidates closer than
    that, so its selections are held one by one: each of JAX's, given to
    the port with the same candidates and the same generator state, draws
    the same minibatch, scores each candidate within the tolerance and
    keeps survivors that JAX's fitnesses rank first, up to the near-tie."""
    model, jmodel = _models(setup)
    calib = setup["calib"]
    kw = dict(target_bitwidth=target, generations=3, offspring=6,
              survivors_per_selection=(3, 1), tokens_per_selection=(64, 128),
              fitness_fn=fitness_fn, group_rule="size", initially_generated=4,
              initial_tokens=64, kl_topk=16, seed=0)
    teacher = jteacher = None
    if fitness_fn == "sparse_kl":
        teacher = evopress.compute_target_logits(model, calib, fitness_fn, topk=16)
        jteacher = jevo.compute_target_logits(jmodel, calib, fitness_fn, topk=16)
    want, jrecs = _spied_search(jevo, jmodel, calib, jevo.EvoPressConfig(
        **kw, checkpoint_path=str(tmp_path / "jax.json")), jteacher, monkeypatch)
    assert len(jrecs) == (target % 1 != 0) + 2 * 3
    gap = min(g for rec in jrecs for g in _deciding_gaps(rec))
    if compare == "end_to_end":
        assert gap > 2 * RTOL, gap
        got, recs = _spied_search(evopress, model, calib, evopress.EvoPressConfig(
            **kw, checkpoint_path=str(tmp_path / "port.json")), teacher, monkeypatch)
        assert got == want
        for rec, jrec in zip(recs, jrecs):
            assert [st for st, _ in rec["scored"]] == [st for st, _ in jrec["scored"]]
            assert all(_close(f, jf) for (_, f), (_, jf) in zip(rec["scored"], jrec["scored"]))
            assert rec["keep"] == jrec["keep"]
        ck, jck = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
        assert ck["parent"] == jck["parent"] == got[0] and ck["generation"] == 2
        assert _close(ck["train_fitness"], jck["train_fitness"])
        bits = evopress.calculate_total_bits(got[0], got[1], model.numel)
        assert bits <= sum(int(model.numel(n) * target) for g in got[1] for n in g)
        return
    assert gap <= 2 * RTOL, gap  # the near-tie this seed shows
    groups, available = want[1], want[2]
    tied = 0
    for jrec in jrecs:
        rng = random.Random()
        rng.setstate(jrec["before"])
        scored = []
        fitness0 = evopress.compute_fitness

        def fitness(m, *a, **kw):
            scored.append(fitness0(m, *a, **kw))
            return scored[-1]

        candidates, num_survive, _, num_tokens = jrec["args"]
        with monkeypatch.context() as mp:
            mp.setattr(evopress, "compute_fitness", fitness)
            keep, _ = evopress.selection(rng, model, groups, available, candidates, num_survive,
                                         calib, num_tokens, fitness_fn, teacher)
        assert rng.getstate() == jrec["after"]
        jfits = [f for _, f in jrec["scored"]]
        assert all(_close(f, jf) for f, jf in zip(scored, jfits)), (scored, jfits)
        cut = sorted(jfits)[num_survive - 1] * (1 + 2 * RTOL)
        assert all(jfits[candidates.index(st)] <= cut for st in keep)
        if min(_deciding_gaps(jrec), default=1.0) > 2 * RTOL:
            assert keep == jrec["keep"]
        else:
            tied += 1
    assert tied >= 1


def test_pipeline_through_the_port_cli(setup, tmp_path, capsys):
    """build-db -> search (sparse KL, --device cpu) -> convert-config ->
    stitch -> serve, all through the port's command line."""
    s = setup
    db = tmp_path / "db"
    main(["build-db", "--models", *(str(s["files"][lv]) for lv in ("Q4_K", "Q6_K")),
          "--output-dir", str(db)])
    main(["search", "--model_name_or_path", str(s["ckpt"]), "--quant_weights_path",
          str(db / "layers-hf"), "--target_bitwidth", "5.5", "--fitness_fn", "sparse_kl",
          "--calibration_data", "synthetic", "--calibration_tokens", "256",
          "--calibration_sequence_length", "32", "--generations", "2", "--offspring", "4",
          "--survivors_per_selection", "2", "1", "--tokens_per_selection", "64", "128",
          "--initially_generated", "3", "--initial_tokens", "64", "--kl_topk", "16",
          "--device", "cpu"])
    cfg = db / "layers-hf" / "evo-sparse_kl-configuration-5.5.txt"
    chosen = evopress.parse_state_config(cfg)
    assert len(chosen) == 14 and all((db / "layers-hf" / n / f).is_file()
                                     for n, (_, f) in chosen.items())
    main(["convert-config", "--input", str(cfg), "--output", str(tmp_path / "stitch.txt")])
    main(["stitch", "--split-dir", str(db / "layers-gguf"), "--config",
          str(tmp_path / "stitch.txt"), "--output", str(tmp_path / "mixed.gguf")])
    r = GGUFReader(tmp_path / "mixed.gguf")
    for name, (bits, f) in chosen.items():
        li, mod, proj = name.split(".")[2:5]
        gname = {"q_proj": "attn_q", "k_proj": "attn_k", "v_proj": "attn_v",
                 "o_proj": "attn_output", "gate_proj": "ffn_gate", "up_proj": "ffn_up",
                 "down_proj": "ffn_down"}[proj]
        assert r.tensors[f"blk.{li}.{gname}.weight"].ggml_type.name == f.split("-")[1][:-4]
    capsys.readouterr()
    main(["serve", "--gguf-file", str(tmp_path / "mixed.gguf"), "--prompt-tokens", "5", "6",
          "7", "--max-new-tokens", "6", "--max-len", "64", "--num-slots", "1",
          "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0].startswith("generated 6 tokens") and len(json.loads(printed[-1])) == 6


@pytest.mark.parametrize("flags", [["--wandb"], ["--dp", "4"], ["--tp", "2"], ["--multihost"]])
def test_search_refuses_what_is_not_ported(flags):
    """--wandb and the device-mesh flags raise, naming their ROADMAP item."""
    with pytest.raises(NotImplementedError, match="not ported yet .ROADMAP Queue 1"):
        main(["search", "--model_name_or_path", "missing", "--quant_weights_path", "missing",
              "--target_bitwidth", "5", "--device", "cpu", *flags])


@pytest.mark.parametrize("flag", ["--coordinator", "--num_processes", "--process_id"])
def test_search_rejects_multihost_flags(flag, capsys):
    """The multi-host flags of the JAX CLI are not options of the port's
    ``search``: the parser refuses them."""
    with pytest.raises(SystemExit):
        main(["search", "--model_name_or_path", "missing", "--quant_weights_path", "missing",
              "--target_bitwidth", "5", "--device", "cpu", flag, "1"])
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_search_model_loads_each_file_kind(setup, tmp_path, kind):
    """A ``.pth`` variant saved by torch, or holding raw numpy bytes (the
    only files ``scan_available_bitwidths`` lists), swaps in as the same
    weight, in the model's dtype."""
    w = np.random.default_rng(0).normal(size=(128, 256)).astype(np.float16)
    d = tmp_path / "model.layers.0.self_attn.k_proj"
    d.mkdir()
    f = d / "4.5-Q4_K.pth"
    if kind == "torch":
        torch.save(torch.from_numpy(w), f)
    else:
        with open(f, "wb") as fh:
            np.save(fh, w)
    assert evopress.scan_available_bitwidths(tmp_path)[d.name] == [(4.5, f.name)]
    model = evopress.SearchModel(*setup["port"], tmp_path, device="cpu")
    model.load_layers([["model.layers.0.self_attn.k_proj"]], [[4.5]],
                      {"model.layers.0.self_attn.k_proj": [(4.5, f.name)]})
    got = llama.get_linear(model.params, "model.layers.0.self_attn.k_proj")
    assert got.dtype == torch.float32 and torch.equal(got, torch.from_numpy(w).float())
