#!/usr/bin/env python3
"""Time the GPTQ dynamic refit (``kquant.fit_supergroups``) on the card, for
one or more checkouts of the repository, each in a process of its own.

    python3 tools/time_refit.py [--ordered] [ROOT ...]   (default: this checkout)

Roots run in the order given (pass A B B A to compare two trees within one
run). Each times one refit call at the shapes the default GPTQ solve of a
Llama-3-8B-width layer gives it: a (d_row, 256) column slice of the
residual, for q/k/v (6144 rows), o and down (4096) and gate/up (28672),
at Q4_K and Q6_K. Host clock around each call with the card synchronised
at both ends, since the refit is a string of small eager launches; the
median of REPS calls. Prints, per root, ms per call and seconds per Q4_K
layer (104 refits: 16 each for q/k/v, o and gate/up, 56 for down), and
the share of group codes equal to the first root's. Each call is the
walk's: with ``card_sums=True`` where a tree's fit takes it. ``--ordered``
times the fit's default, the host's order of sums on the card, which the
RTN route runs (a tree without ``card_sums`` has only that one).
Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 7
REPS = 30
ROWS = {"qkv": 6144, "o": 4096, "gateup": 28672}
PER_LAYER = {"qkv": 16, "o": 16, "gateup": 16, "down": 56}  # down reuses o's shape


def one_root(root: str, dump: str, ordered: bool) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import inspect

    import torch

    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.ops import kquant

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    out, codes = {}, {}
    walk = "card_sums" in inspect.signature(kquant.fit_supergroups).parameters and not ordered
    kw = {"card_sums": True} if walk else {}
    for qtype in (T.Q4_K, T.Q6_K):
        for name, rows in ROWS.items():
            # a column slice of a wider residual, as _solve_core passes it
            w = torch.as_tensor(rng.normal(size=(rows, 512)) * 0.02, dtype=torch.float32,
                                device=dev)[:, 256:]
            for _ in range(2):
                p = kquant.fit_supergroups(w, qtype, **kw)
            times = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                p = kquant.fit_supergroups(w, qtype, **kw)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            out[f"{qtype.name} {name}"] = float(np.median(times))
            codes[f"{qtype.name} {name}"] = [t.cpu() for t in p]
    torch.save(codes, dump)
    print(json.dumps({"root": root, "ms_per_call": out, "card_sums": walk}), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        one_root(argv[1], argv[2], argv[3:] == ["--ordered"])
        return 0
    import torch

    ordered = "--ordered" in argv
    argv = [a for a in argv if a != "--ordered"]
    roots = argv or [str(Path(__file__).resolve().parents[1])]
    with tempfile.TemporaryDirectory(prefix="time_refit_") as tmp:
        runs = []
        for i, root in enumerate(roots):
            dump = str(Path(tmp) / f"{i}.pt")
            res = subprocess.run([sys.executable, __file__, "--one", root, dump]
                                 + ["--ordered"] * ordered,
                                 capture_output=True, text=True, check=True)
            rec = json.loads(res.stdout.strip().splitlines()[-1])
            ms = rec["ms_per_call"]
            layer_s = sum(n * ms[f"Q4_K {'o' if k == 'down' else k}"]
                          for k, n in PER_LAYER.items()) / 1e3
            runs.append((root, ms, layer_s, torch.load(dump), rec["card_sums"]))
        first = runs[0][3]
        for root, ms, layer_s, codes, card_sums in runs:
            same = {k: float(np.mean([(a == b).float().mean().item()
                                      for a, b in zip(codes[k], first[k])])) for k in codes}
            print(json.dumps({"root": root, "card_sums": card_sums, "ms_per_call": ms,
                              "refit_s_per_q4k_layer": layer_s,
                              "codes_equal_to_first_root": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
