#!/usr/bin/env python3
"""Build the port's CUDA sources in several checkouts and compare their
ptxas reports kernel by kernel.

    python3 tools/ptxas_diff.py [--libs qmatmul_v3,qmatmul_v2m] ROOT [ROOT ...]

Each ROOT's ``gptq_gguf_tpu_torch/ops/cuda_build.py`` builds each library
(by default every ``ops/csrc/*.cu`` of the first root) as that root would,
one nvcc per (root, library), all at once; a library a root built before is
read from nvcc's output kept beside it. Prints one JSON line per root and
library with its ptxas report (kernel -> [registers, spill store bytes,
spill load bytes], names demangled where c++filt is found, the anonymous
namespace's per-file hash replaced by ANON), then, for every root after the
first, one JSON line per library with the kernels whose numbers differ from
the first root's, the kernels only one of them has, and the count of nvcc's
output lines that differ once that hash is replaced, ptxas's compile times
left out (0: the reports agree line for line). Needs nvcc (no card); each
root needs its own checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from time_v2_kernels import ptxas_report  # noqa: E402

ANON = re.compile(r"_GLOBAL__N__\w+?_cu_\w{8}")


def load_cuda_build(root: str, i: int):
    """The cuda_build module of checkout ``root``, loaded on its own."""
    path = Path(root).resolve() / "gptq_gguf_tpu_torch" / "ops" / "cuda_build.py"
    spec = importlib.util.spec_from_file_location(f"_cuda_build_{i}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nvcc_output(mod, lib: str) -> str:
    """nvcc's output for ``lib`` in the root of ``mod``: of this build, or
    kept beside the library from an earlier one."""
    out = mod.build(lib)
    return out if out is not None else mod.library_path(lib).with_suffix(".log").read_text()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--libs", default="", help="comma list of libraries (default: every source)")
    args = ap.parse_args()
    mods = [load_cuda_build(r, i) for i, r in enumerate(args.roots)]
    libs = ([x for x in args.libs.split(",") if x]
            or sorted(p.stem for p in mods[0].CSRC.glob("*.cu")))
    jobs = [(i, lib) for i in range(len(mods)) for lib in libs]
    with ThreadPoolExecutor(len(jobs)) as ex:
        logs = dict(zip(jobs, ex.map(lambda j: nvcc_output(mods[j[0]], j[1]), jobs)))
    reports = {j: ptxas_report(log) for j, log in logs.items()}
    for (i, lib), rep in reports.items():
        print(json.dumps({"root": args.roots[i], "library": lib, "ptxas": rep}), flush=True)

    def lines(log):  # nvcc's output but ptxas's compile times
        return [ANON.sub("ANON", ln) for ln in log.splitlines() if "Compile time" not in ln]

    for i in range(1, len(mods)):
        for lib in libs:
            a, b = reports[(0, lib)], reports[(i, lib)]
            la, lb = lines(logs[(0, lib)]), lines(logs[(i, lib)])
            pairs = [(x, y) for x, y in zip(la, lb) if x != y]
            print(json.dumps({
                "root": args.roots[i], "against": args.roots[0], "library": lib,
                "kernels": len(b),
                "differ": {k: [a[k], b[k]] for k in a if k in b and a[k] != b[k]},
                "only_here": sorted(set(b) - set(a)), "only_there": sorted(set(a) - set(b)),
                "ptxas_lines": len(lb), "ptxas_lines_differ": len(pairs) + abs(len(la) - len(lb)),
                "first_differing_lines": pairs[:1],
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
