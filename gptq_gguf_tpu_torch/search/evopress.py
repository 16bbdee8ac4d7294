"""EvoPress evolutionary bit-width search.

Port of ``gptq_gguf_tpu/search/evopress.py`` without its device-mesh path:
a generational loop of budget-preserving bit-width swaps and a staged
selection funnel, each candidate scored by swapping its layers' variants
from the ``layers-hf`` database into the dense Llama and running
``models.llama.forward`` on the params' device (``torch.matmul`` on the
card: the JAX package scores candidates with XLA, outside any Pallas
kernel). Every random draw goes through one ``random.Random(cfg.seed)``
passed down, in the JAX search's order: the same seed makes the same
mutations draw for draw as the JAX search does from the seeded global
``random``. Teacher logits for the KL fitness functions stay on the
device as top-k (``torch.topk``) or come to the host whole (dense ``kl``).
A generation checkpoint is written after each generation when asked for.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import pickle
import random
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..evals import ppl as ppl_mod
from ..models import llama
from ..models.llama import LlamaConfig

State = List[List[float]]  # bit width per [group][layer]


# ---------------------------------------------------------------------------
# The database and the groups
# ---------------------------------------------------------------------------


def scan_available_bitwidths(db_path: Union[str, Path]) -> Dict[str, List[Tuple[float, str]]]:
    """layer -> [(bits, file name)] sorted by bits."""
    out: Dict[str, List[Tuple[float, str]]] = {}
    for layer_dir in sorted(Path(db_path).iterdir()):
        if not layer_dir.is_dir():
            continue
        opts = []
        for f in layer_dir.glob("*.pth"):
            try:
                opts.append((float(f.name.split("-")[0].replace(".pth", "")), f.name))
            except ValueError:
                continue
        if opts:
            opts.sort(key=lambda t: t[0])
            out[layer_dir.name] = opts
    return out


def layer_order_fn(layer_name: str):
    """Sort key: (block index, *components)."""
    parts = layer_name.split(".")
    return (int(parts[2]), *parts[3:])


def group_layers(layer_names: Sequence[str], rule: str,
                 numel_fn: Callable[[str], int]) -> List[List[str]]:
    """One group ("none"), one per projection name ("name") or one per
    weight count ("size"); swaps keep the budget within a group."""
    assert rule in ("none", "name", "size")
    groups: Dict[Any, List[str]] = {}
    for n in layer_names:
        key = 0 if rule == "none" else n.split(".")[-1] if rule == "name" else numel_fn(n)
        groups.setdefault(key, []).append(n)
    return list(groups.values())


class SearchModel:
    """Dense Llama params on one device, whose block linears take the
    database's variants."""

    def __init__(self, params, cfg: LlamaConfig, db_path: Union[str, Path], device="cuda"):
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items() if k != "layers"}
        self.params["layers"] = [{k: v.to(self.device) for k, v in layer.items()}
                                 for layer in params["layers"]]
        self.cfg = cfg
        self.db_path = Path(db_path)
        self.state: Optional[State] = None

    def numel(self, layer_name: str) -> int:
        return llama.get_linear(self.params, layer_name).numel()

    def _load_file(self, layer_name: str, filename: str) -> torch.Tensor:
        path = self.db_path / layer_name / filename
        try:
            return torch.load(path, map_location=self.device, weights_only=True)
        except (pickle.UnpicklingError, RuntimeError):  # a variant saved as raw numpy
            return torch.as_tensor(np.asarray(np.load(path, allow_pickle=False)),
                                   device=self.device)

    def load_layers(self, grouped_layer_names: Sequence[Sequence[str]], new_state: State,
                    available: Dict[str, List[Tuple[float, str]]]) -> None:
        """Swap in the variant of every layer whose bit width changed."""
        if self.state is None:
            self.state = [[None] * len(g) for g in grouped_layer_names]
        for gi, names in enumerate(grouped_layer_names):
            for li, name in enumerate(names):
                new_bw = new_state[gi][li]
                if new_bw == self.state[gi][li]:
                    continue
                filename = next((fn for bw, fn in available[name] if abs(bw - new_bw) < 1e-6),
                                None)
                if filename is None:
                    raise ValueError(f"no file for {name} at {new_bw}")
                old = llama.get_linear(self.params, name)
                w = self._load_file(name, filename).to(old.dtype)
                self.params = llama.set_linear(self.params, name, w)
        self.state = copy.deepcopy(new_state)


# ---------------------------------------------------------------------------
# Budget accounting
# ---------------------------------------------------------------------------


def calculate_total_bits(state: State, groups: Sequence[Sequence[str]], numel_fn) -> float:
    total = 0
    for gi, names in enumerate(groups):
        for li, name in enumerate(names):
            total += numel_fn(name) * state[gi][li]
    return total


def get_next_bitwidth(state: State, target_bits: float, groups: Sequence[Sequence[str]],
                      available: Dict[str, List[Tuple[float, str]]], numel_fn, gi: int,
                      li: int, direction: str = "decrease") -> Optional[float]:
    """The next lower bit width of a layer, or the next higher one that
    keeps the total within ``target_bits``; None where there is none."""
    name = groups[gi][li]
    cur = state[gi][li]
    if direction == "decrease":
        cands = [bw for bw, _ in available[name] if bw < cur]
        return cands[-1] if cands else None
    cands = [bw for bw, _ in available[name] if bw > cur]
    if not cands:
        return None
    cur_total = calculate_total_bits(state, groups, numel_fn)
    numel = numel_fn(name)
    for bw in cands:
        if cur_total + numel * (bw - cur) <= target_bits:
            return bw
    return None


# ---------------------------------------------------------------------------
# Fitness and selection
# ---------------------------------------------------------------------------


def compute_fitness(model: SearchModel, data, fitness_fn, target_logits=None) -> float:
    if fitness_fn == "ppl":
        return ppl_mod.compute_perplexity(model.params, model.cfg, data)
    if fitness_fn == "kl":
        return ppl_mod.compute_kl_div(model.params, model.cfg, data, target_logits)
    if fitness_fn == "sparse_kl":
        return ppl_mod.compute_sparse_kl_div(model.params, model.cfg, data, target_logits)
    raise ValueError(fitness_fn)


def sample_minibatch(rng: random.Random, calibration_data, num_tokens, target_logits=None,
                     fitness_fn="ppl"):
    """Distinct random sequences up to exactly ``num_tokens`` tokens (the
    last one cut), with their teacher logits."""
    minibatch, used_ids, tl_minibatch = [], [], []
    tokens_used = 0
    while tokens_used < num_tokens:
        i = rng.randint(0, len(calibration_data) - 1)
        if i in used_ids:
            continue
        used_ids.append(i)
        sample = np.atleast_2d(np.asarray(calibration_data[i]))
        remaining = num_tokens - tokens_used
        if sample.shape[1] > remaining:
            minibatch.append(sample[:, :remaining])
            if fitness_fn == "kl":
                tl_minibatch.append(target_logits[i][:, :remaining])
            elif fitness_fn == "sparse_kl":
                tl_minibatch.append((target_logits[i][0][:, :remaining],
                                     target_logits[i][1][:, :remaining]))
            tokens_used = num_tokens
        else:
            minibatch.append(sample)
            if fitness_fn in ("kl", "sparse_kl"):
                tl_minibatch.append(target_logits[i])
            tokens_used += sample.shape[1]
    return minibatch, (tl_minibatch or None)


def selection(rng: random.Random, model: SearchModel, groups, available,
              candidates: List[State], num_survive: int, calibration_data, num_tokens: int,
              fitness_fn: str = "ppl", target_logits=None):
    """The ``num_survive`` fittest candidates (lowest score first) on one
    random minibatch, with their scores."""
    minibatch, tl = sample_minibatch(rng, calibration_data, num_tokens, target_logits,
                                     fitness_fn)
    fitnesses = []
    for cand in candidates:
        model.load_layers(groups, cand, available)
        fitnesses.append(compute_fitness(model, minibatch, fitness_fn, tl))
    best = np.argsort(fitnesses)[:num_survive]
    return [candidates[i] for i in best], [fitnesses[i] for i in best]


# ---------------------------------------------------------------------------
# Mutation
# ---------------------------------------------------------------------------


def _pick_group(rng: random.Random, groups) -> int:
    return rng.choices(range(len(groups)), weights=[len(g) for g in groups])[0]


def _ids_where(state, target_bits, groups, available, numel_fn, gi, direction):
    return [i for i in range(len(groups[gi]))
            if get_next_bitwidth(state, target_bits, groups, available, numel_fn, gi, i,
                                 direction) is not None]


def _repair_budget(rng: random.Random, state, target_bits, groups, available, numel_fn,
                   max_iterations=1000):
    """Lower random layers until the total is within ``target_bits``."""
    bits = calculate_total_bits(state, groups, numel_fn)
    it = 0
    while bits > target_bits and it < max_iterations:
        it += 1
        gi = _pick_group(rng, groups)
        decr = _ids_where(state, target_bits, groups, available, numel_fn, gi, "decrease")
        if not decr:
            break
        li = rng.choice(decr)
        state[gi][li] = get_next_bitwidth(state, target_bits, groups, available, numel_fn, gi,
                                          li, "decrease")
        bits = calculate_total_bits(state, groups, numel_fn)
    return bits


def mutate_ungrouped(rng: random.Random, offspring, num_flips, target_bits, groups, available,
                     numel_fn) -> bool:
    """group_rule "none": raise random layers within the budget, lowering
    others first where nothing can rise."""
    _repair_budget(rng, offspring, target_bits, groups, available, numel_fn)
    successful_increases = 0
    decrease_attempts = 0
    for _ in range(num_flips):
        gi = _pick_group(rng, groups)
        incr = _ids_where(offspring, target_bits, groups, available, numel_fn, gi, "increase")
        if not incr:
            for _ in range(3):
                decrease_attempts += 1
                dgi = _pick_group(rng, groups)
                decr = _ids_where(offspring, target_bits, groups, available, numel_fn, dgi,
                                  "decrease")
                if decr:
                    dli = rng.choice(decr)
                    offspring[dgi][dli] = get_next_bitwidth(
                        offspring, target_bits, groups, available, numel_fn, dgi, dli, "decrease")
                    incr = _ids_where(offspring, target_bits, groups, available, numel_fn, gi,
                                      "increase")
                    if incr:
                        break
        if incr:
            li = rng.choice(incr)
            offspring[gi][li] = get_next_bitwidth(offspring, target_bits, groups, available,
                                                  numel_fn, gi, li, "increase")
            successful_increases += 1
    return not (successful_increases == 0 and decrease_attempts > 5)


def mutate_grouped(rng: random.Random, offspring, num_flips, target_bits, groups, available,
                   numel_fn) -> bool:
    """group_rule "name" / "size": swap one step down and one step up
    between two layers of a group (layers of one size)."""
    _repair_budget(rng, offspring, target_bits, groups, available, numel_fn, max_iterations=100)
    successful = 0
    for _ in range(num_flips):
        gi = _pick_group(rng, groups)
        decr = _ids_where(offspring, target_bits, groups, available, numel_fn, gi, "decrease")
        if not decr:
            continue
        decr_id = rng.choice(decr)
        incr = _ids_where(offspring, target_bits, groups, available, numel_fn, gi, "increase")
        if not incr:
            others = [i for i in decr if i != decr_id]
            if others:
                other = rng.choice(others)
                offspring[gi][other] = get_next_bitwidth(
                    offspring, target_bits, groups, available, numel_fn, gi, other, "decrease")
                incr = _ids_where(offspring, target_bits, groups, available, numel_fn, gi,
                                  "increase")
            if not incr:
                continue
        incr_id = rng.choice(incr)
        offspring[gi][decr_id] = get_next_bitwidth(offspring, target_bits, groups, available,
                                                   numel_fn, gi, decr_id, "decrease")
        offspring[gi][incr_id] = get_next_bitwidth(offspring, target_bits, groups, available,
                                                   numel_fn, gi, incr_id, "increase")
        successful += 1
    return successful > 0


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EvoPressConfig:
    target_bitwidth: float = 4.0
    generations: int = 50
    offspring: int = 128
    survivors_per_selection: Tuple[int, ...] = (16, 4, 1)
    tokens_per_selection: Tuple[int, ...] = (2048, 16384, 131072)
    fitness_fn: str = "ppl"  # ppl | kl | sparse_kl
    group_rule: str = "size"
    initially_generated: int = 64
    initial_tokens: int = 16384
    kl_topk: int = 64
    eval_every: int = 10
    seed: int = 0
    checkpoint_path: Optional[str] = None


def write_config(path: Union[str, Path], groups: Sequence[Sequence[str]], state: State,
                 available: Dict[str, List[Tuple[float, str]]]) -> None:
    """``layer: bits (file)`` lines, the stitcher's input after
    ``convert-config``."""
    lines = []
    for names, bws in zip(groups, state):
        for name, bw in zip(names, bws):
            filename = next((fn for b, fn in available[name] if abs(b - bw) < 1e-6), None)
            lines.append(f"{name}: {bw} ({filename})")
    Path(path).write_text("\n".join(lines))


def parse_state_config(path: Union[str, Path]) -> Dict[str, Tuple[float, str]]:
    out = {}
    for line in Path(path).read_text().splitlines():
        if ":" not in line:
            continue
        name, rest = line.split(":", 1)
        parts = rest.strip().split(" ", 1)
        fn = parts[1].strip("()") if len(parts) > 1 else None
        out[name.strip()] = (float(parts[0]), fn)
    return out


def evo_press_search(model: SearchModel, calibration_data, cfg: EvoPressConfig, *,
                     eval_datasets: Optional[Dict[str, Any]] = None, target_logits=None,
                     log: Callable[[str], None] = print
                     ) -> Tuple[State, List[List[str]], Dict[str, List[Tuple[float, str]]]]:
    """Run the generational search; returns (best state, groups, available)."""
    assert len(cfg.survivors_per_selection) == len(cfg.tokens_per_selection)
    assert cfg.survivors_per_selection[-1] == 1
    rng = random.Random(cfg.seed)

    available = scan_available_bitwidths(model.db_path)
    layer_names = sorted(available.keys(), key=layer_order_fn)
    numel_fn = model.numel
    groups = group_layers(layer_names, cfg.group_rule, numel_fn)
    target_bits = sum(int(numel_fn(n) * cfg.target_bitwidth) for g in groups for n in g)
    quantizable = sum(numel_fn(n) for g in groups for n in g)

    def closest(n, bits):
        return min((bw for bw, _ in available[n]), key=lambda x: abs(x - bits))

    if int(cfg.target_bitwidth) == cfg.target_bitwidth:
        parent: State = [[cfg.target_bitwidth
                          if cfg.target_bitwidth in [bw for bw, _ in available[n]]
                          else closest(n, cfg.target_bitwidth) for n in names]
                         for names in groups]
        train_fitness = float("inf")
    else:  # the best of random repairs down from the next whole bit width
        candidates = []
        for _ in range(cfg.initially_generated):
            cand = [[closest(n, math.ceil(cfg.target_bitwidth)) for n in names]
                    for names in groups]
            _repair_budget(rng, cand, target_bits, groups, available, numel_fn)
            candidates.append(cand)
        candidates, fits = selection(rng, model, groups, available, candidates, 1,
                                     calibration_data, cfg.initial_tokens, cfg.fitness_fn,
                                     target_logits)
        parent, train_fitness = candidates[0], fits[0]
    parent_bits = calculate_total_bits(parent, groups, numel_fn)

    for generation in range(cfg.generations):
        log(f"[evopress] gen {generation + 1}/{cfg.generations} "
            f"bits/weight {parent_bits / quantizable:.4f} fitness {train_fitness:.4e}")
        model.load_layers(groups, parent, available)
        if eval_datasets and generation % cfg.eval_every == 0:
            for name, ds in eval_datasets.items():
                log(f"[evopress]   {name} ppl: "
                    f"{ppl_mod.compute_perplexity(model.params, model.cfg, ds):.3f}")

        # offspring, without duplicates
        offspring_list: List[State] = []
        duplicates = 0
        while len(offspring_list) < cfg.offspring:
            off = copy.deepcopy(parent)
            num_flips = min(rng.randint(1, 3), rng.randint(1, 3))
            mutate = mutate_ungrouped if cfg.group_rule == "none" else mutate_grouped
            if not mutate(rng, off, num_flips, target_bits, groups, available, numel_fn):
                continue
            if off in offspring_list or off == parent:
                duplicates += 1
                if duplicates > 10:
                    log(f"[evopress] too many duplicates, {len(offspring_list)} offspring")
                    break
                continue
            duplicates = 0
            offspring_list.append(off)

        # the staged selection funnel; the parent joins the last stage
        for num_survive, num_tokens in zip(cfg.survivors_per_selection, cfg.tokens_per_selection):
            if num_survive == cfg.survivors_per_selection[-1] and parent not in offspring_list:
                offspring_list.append(parent)
            offspring_list, fits = selection(rng, model, groups, available, offspring_list,
                                             num_survive, calibration_data, num_tokens,
                                             cfg.fitness_fn, target_logits)
        train_fitness = fits[0]
        parent = offspring_list[0]
        parent_bits = calculate_total_bits(parent, groups, numel_fn)

        if cfg.checkpoint_path:
            with open(cfg.checkpoint_path, "w") as f:
                json.dump({"generation": generation, "parent": parent,
                           "train_fitness": train_fitness,
                           "groups": [list(g) for g in groups]}, f)

    return parent, [list(g) for g in groups], available


def compute_target_logits(model: SearchModel, calibration_data, fitness_fn: str,
                          topk: int = 64):
    """The teacher's logits of each sequence (the model as it stands):
    ``kl`` the whole (1, S, V) logits as host numpy; ``sparse_kl`` the
    top-k (values, ids) of each position, kept on the model's device."""
    out = []
    with torch.no_grad():
        for sample in calibration_data:
            ids = torch.as_tensor(np.atleast_2d(np.asarray(sample)), device=model.device)
            logits = llama.forward(model.params, ids, model.cfg)
            if fitness_fn == "kl":
                out.append(logits.cpu().numpy())
            else:
                vals, idx = torch.topk(logits, topk, dim=-1)
                out.append((vals, idx))
            del logits
    return out
