"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``ops/csrc/_build/lib<name>-<hash>.so`` (a directory git ignores),
keyed on a hash of the source, the shared headers (``ops/csrc/*.cuh``) and
the nvcc command, at first use. What nvcc is given
does not depend on where the tree lies: it runs in ``ops/csrc/`` on the
bare file name, and cudafe++ is told that name as the source's path
(``--orig_src_path_name``), since it hashes that path (made absolute by
nvcc otherwise) into the module id that names every symbol of the
anonymous namespace. cicc's PTX still varies from one run to the next
(its virtual register numbering), which can move a kernel at its register
cap by a few bytes of spills. Nothing here runs at import time: a
CPU-only host has no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _command(nvcc: str, name: str, out) -> list:
    """The nvcc command that builds ``csrc/<name>.cu`` into ``out``, run in
    CSRC: nothing in it but ``out`` depends on where CSRC lies."""
    return [nvcc, *NVCC_FLAGS, "-Xcudafe", f"--orig_src_path_name={name}.cu", "-o", str(out),
            f"{name}.cu"]


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include any header
        key.update(header.read_bytes())
    key.update(" ".join(_command("nvcc", name, "OUT")).encode())  # flags and form
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build(name: str) -> Optional[str]:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns
    nvcc's output (with the ptxas report: registers, spills) when it
    built, None when the library was there; raises with nvcc's output if
    the build fails. The output is also kept beside the library (``.log``)."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(_command(_nvcc(), name, tmp), cwd=CSRC,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return proc.stdout


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
