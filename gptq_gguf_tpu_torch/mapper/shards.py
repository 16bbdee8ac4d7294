"""Sharded GGUF files: split one, or read a ``-NNNNN-of-NNNNN`` set as one.

Copy of ``gptq_gguf_tpu/mapper/shards.py`` without the merge:
``split_gguf_file`` breaks a GGUF into llama.cpp ``gguf-split`` shards (the
first carries the whole metadata, every shard the ``split.*`` keys), and
``open_gguf`` opens a plain file or any shard of a set (``GGUFSetReader``).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, List, Union

from ..formats.gguf import GGUFReader, GGUFValue, GGUFValueType, GGUFWriter

LLM_KV_SPLIT_NO = "split.no"
LLM_KV_SPLIT_COUNT = "split.count"
LLM_KV_SPLIT_TENSORS_COUNT = "split.tensors.count"

_SHARD_RE = re.compile(r"^(.*)-(\d{5})-of-(\d{5})\.gguf$")


def shard_name(prefix: Union[str, Path], i: int, n: int) -> Path:
    return Path(f"{prefix}-{i + 1:05d}-of-{n:05d}.gguf")


def _plan(reader: GGUFReader, max_tensors: int = 0, max_size: int = 0) -> List[List[str]]:
    """Greedy shard plan over tensor_order (llama.cpp gguf-split: a shard
    closes when either bound would be exceeded)."""
    shards: List[List[str]] = []
    cur: List[str] = []
    cur_bytes = 0
    for name in reader.tensor_order:
        nb = reader.tensors[name].nbytes
        if cur and ((max_tensors and len(cur) >= max_tensors)
                    or (max_size and cur_bytes + nb > max_size)):
            shards.append(cur)
            cur, cur_bytes = [], 0
        cur.append(name)
        cur_bytes += nb
    if cur:
        shards.append(cur)
    return shards


def split_gguf_file(src: Union[str, Path], dst_prefix: Union[str, Path], *,
                    max_tensors: int = 0, max_size: int = 0) -> List[Path]:
    """Split ``src`` into shards named ``<dst_prefix>-NNNNN-of-NNNNN.gguf``;
    ``max_size`` counts tensor payload bytes."""
    if not max_tensors and not max_size:
        raise ValueError("need --split-max-tensors or --split-max-size")
    r = GGUFReader(src)
    plan = _plan(r, max_tensors, max_size)
    n = len(plan)
    if n < 2:
        raise ValueError(f"split would produce {n} shard(s); nothing to do")
    out: List[Path] = []
    for i, names in enumerate(plan):
        path = shard_name(dst_prefix, i, n)
        w = GGUFWriter(path)
        if i == 0:  # the whole metadata rides the first shard only
            for k, v in r.metadata.items():
                w.add_kv(k, v)
        w.add_kv(LLM_KV_SPLIT_NO, GGUFValue(GGUFValueType.UINT16, i))
        w.add_kv(LLM_KV_SPLIT_COUNT, GGUFValue(GGUFValueType.UINT16, n))
        w.add_kv(LLM_KV_SPLIT_TENSORS_COUNT, GGUFValue(GGUFValueType.INT32, len(r.tensor_order)))
        for name in names:
            info = r.tensors[name]
            w.add_tensor(name, r.tensor_bytes(name), raw_dtype=info.ggml_type,
                         raw_shape=info.shape)
        w.write()
        out.append(path)
    r.close()
    return out


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
