#!/usr/bin/env python3
"""Build one of the port's CUDA sources several times, from one or more
checkouts, with each checkout's own nvcc command, and show what differs.

    python3 tools/nvcc_repeat.py [--source qmatmul_v3] [--times 3] [--absolute]
                                 ROOT [ROOT ...]

Every build runs ``cuda_build._command`` of its ROOT in that root's
``ops/csrc/`` with ``-keep`` into a temporary directory of its own, all
builds at once; ``--absolute`` gives nvcc the source's absolute path and
no ``--orig_src_path_name`` instead, as the port's builds did before.
Prints one JSON line per build: the module id cudafe++ gave the file (the
hash in the anonymous namespace's symbols), an md5 of the PTX cicc wrote,
and the kernels whose ptxas numbers (registers, spill store and load
bytes) differ from the first build's; then one line with the count of
distinct module ids per root, of distinct PTX files, and of nvcc output
lines (ptxas's compile times left out, the module id replaced) that
differ from the first build's. Needs nvcc (no card).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from ptxas_diff import ANON, load_cuda_build  # noqa: E402
from time_v2_kernels import ptxas_report  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--source", default="qmatmul_v3")
    ap.add_argument("--times", type=int, default=3)
    ap.add_argument("--absolute", action="store_true",
                    help="the source's absolute path, and no --orig_src_path_name")
    args = ap.parse_args()
    mods = [load_cuda_build(r, i) for i, r in enumerate(args.roots)]
    jobs = [(i, k) for i in range(len(mods)) for k in range(args.times)]
    with tempfile.TemporaryDirectory(prefix="nvcc_repeat_") as tmp:
        def build(job):
            i, k = job
            keep = Path(tmp) / f"{i}_{k}"
            keep.mkdir()
            mod = mods[i]
            cmd = mod._command(mod._nvcc(), args.source, keep / "lib.so")
            if args.absolute:
                cmd = [a for a in cmd[:-1] if "orig_src_path_name" not in a]
                cmd.remove("-Xcudafe")
                cmd.append(str(mod.CSRC / f"{args.source}.cu"))
            cmd[1:1] = ["-keep", "-keep-dir", str(keep)]
            proc = subprocess.run(cmd, cwd=mod.CSRC, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed in {args.roots[i]}:\n{proc.stdout}")
            module_id = next(keep.glob("*.module_id")).read_text().strip()
            ptx = hashlib.md5(next(keep.glob("*.ptx")).read_bytes()).hexdigest()
            return module_id, ptx, proc.stdout

        with ThreadPoolExecutor(len(jobs)) as ex:
            out = dict(zip(jobs, ex.map(build, jobs)))

    def lines(log):
        return [ANON.sub("ANON", ln) for ln in log.splitlines() if "Compile time" not in ln]

    first = jobs[0]
    rep0, lines0 = ptxas_report(out[first][2]), lines(out[first][2])
    for (i, k), (module_id, ptx, log) in out.items():
        rep = ptxas_report(log)
        print(json.dumps({"root": args.roots[i], "build": k, "module_id": module_id, "ptx_md5": ptx,
                          "kernels": len(rep),
                          "differ": {n: [rep0.get(n), r] for n, r in rep.items()
                                     if rep0.get(n) != r}}), flush=True)
    print(json.dumps({
        "source": args.source, "builds": len(jobs),
        "module_ids_per_root": {args.roots[i]: len({out[(i, k)][0] for k in range(args.times)})
                                for i in range(len(mods))},
        "module_ids": len({v[0] for v in out.values()}),
        "ptx_files": len({v[1] for v in out.values()}),
        "output_lines": len(lines0),
        "output_lines_differ": {f"{args.roots[i]} #{k}": sum(
            a != b for a, b in zip(lines0, lines(out[(i, k)][2])))
            + abs(len(lines0) - len(lines(out[(i, k)][2]))) for i, k in jobs},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
