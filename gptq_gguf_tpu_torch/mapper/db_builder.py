"""The search's layer database, from GGUF files at several quantization
levels.

Copy of ``gptq_gguf_tpu/mapper/db_builder.py``: each model file is split
twice into one shared tree, and a manifest names the files:

  <out>/models/        copies of the inputs (``copy_models``)
  <out>/layers-gguf/<tensor>/<bits>-<QTYPE>.pth (+ metadata)   the stitcher's
  <out>/layers-hf/<hf_layer>/<bits>-<QTYPE>.pth (+ metadata)   the search's
  <out>/manifest.json

A type the splitter does not know is named after the file (``Q6_K`` in
``model-Q6_K.gguf``). Host code: numpy, no card.
"""

from __future__ import annotations

import json
import re
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

from . import splitter

_QTYPE_RE = re.compile(r"(IQ[1-4]_[A-Z]+|Q[2-8]_K_?[SML]?|Q[45]_[01]|Q8_0|F16|BF16|F32)", re.I)


def infer_qtype_from_filename(path: Union[str, Path]) -> Optional[str]:
    m = _QTYPE_RE.search(Path(path).stem)
    return m.group(1).upper() if m else None


def build_ep_database(model_paths: List[Union[str, Path]], out_dir: Union[str, Path], *,
                      copy_models: bool = False, skip_hf: bool = False) -> Dict:
    out_dir = Path(out_dir)
    (out_dir / "models").mkdir(parents=True, exist_ok=True)
    gguf_dir, hf_dir = out_dir / "layers-gguf", out_dir / "layers-hf"
    manifest = {
        "database_info": {"created": time.time(), "num_models": len(model_paths)},
        "models": [],
    }
    for path in model_paths:
        path = Path(path)
        qtype = infer_qtype_from_filename(path)
        splitter.split_gguf(path, gguf_dir, overwrite_bitwidth=qtype)
        if not skip_hf:
            splitter.split_hf(path, hf_dir, overwrite_bitwidth=qtype)
        if copy_models:
            shutil.copy2(path, out_dir / "models" / path.name)
        manifest["models"].append({"file": path.name, "inferred_quant_type": qtype,
                                   "source": str(path)})
    with open(out_dir / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest
