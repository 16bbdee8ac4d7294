"""Open a GGUF given as one file or as a ``-NNNNN-of-NNNNN`` shard set.

Copy of the reading half of ``gptq_gguf_tpu/mapper/shards.py``
(``open_gguf`` and ``GGUFSetReader``); split and merge stay in the JAX
package.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, List, Union

from ..formats.gguf import GGUFReader, GGUFValue

LLM_KV_SPLIT_NO = "split.no"
LLM_KV_SPLIT_COUNT = "split.count"
LLM_KV_SPLIT_TENSORS_COUNT = "split.tensors.count"

_SHARD_RE = re.compile(r"^(.*)-(\d{5})-of-(\d{5})\.gguf$")


def _find_shards(first: Path) -> List[Path]:
    m = _SHARD_RE.match(first.name)
    if not m:
        return [first]
    prefix, _, count = m.groups()
    n = int(count)
    paths = [first.parent / f"{prefix}-{i + 1:05d}-of-{n:05d}.gguf"
             for i in range(n)]
    missing = [p for p in paths if not p.exists()]
    if missing:
        more = f" (and {len(missing) - 1} more)" if len(missing) > 1 else ""
        raise FileNotFoundError(
            f"sharded GGUF set incomplete: missing {missing[0].name}{more}")
    return paths


class GGUFSetReader:
    """GGUFReader-compatible facade over a shard set: metadata from the
    first shard, merged tensor map, per-tensor access routed to the owning
    shard."""

    def __init__(self, paths: List[Path]):
        self.paths = [Path(p) for p in paths]
        self.readers = [GGUFReader(p) for p in self.paths]
        first = self.readers[0]
        self.path = self.paths[0]
        self.version = first.version
        self.alignment = first.alignment
        self.metadata: Dict[str, GGUFValue] = dict(first.metadata)
        for k in (LLM_KV_SPLIT_NO, LLM_KV_SPLIT_COUNT,
                  LLM_KV_SPLIT_TENSORS_COUNT):
            self.metadata.pop(k, None)
        self.tensors = {}
        self.tensor_order: List[str] = []
        self._owner = {}
        for r in self.readers:
            for name in r.tensor_order:
                self.tensors[name] = r.tensors[name]
                self.tensor_order.append(name)
                self._owner[name] = r
        want = first.get(LLM_KV_SPLIT_TENSORS_COUNT)
        if want is not None and want != len(self.tensor_order):
            raise ValueError(
                f"sharded GGUF set has {len(self.tensor_order)} tensors, "
                f"split.tensors.count says {want}")

    def get(self, key: str, default: Any = None) -> Any:
        v = self.metadata.get(key)
        return default if v is None else v.value

    def tensor_bytes(self, name: str):
        return self._owner[name].tensor_bytes(name)

    def tensor_float(self, name: str):
        return self._owner[name].tensor_float(name)

    def close(self) -> None:
        for r in self.readers:
            r.close()


def open_gguf(path: Union[str, Path]):
    """GGUFReader for a plain file; GGUFSetReader when ``path`` names any
    shard of a split set."""
    path = Path(path)
    paths = _find_shards(path)
    if len(paths) == 1:
        r = GGUFReader(path)
        if (r.get(LLM_KV_SPLIT_COUNT) or 1) > 1:
            raise FileNotFoundError(
                f"{path.name} is shard {r.get(LLM_KV_SPLIT_NO)} of a "
                f"{r.get(LLM_KV_SPLIT_COUNT)}-file set but does not follow "
                "the -NNNNN-of-NNNNN naming; rename the set or merge it")
        return r
    return GGUFSetReader(paths)
