"""Calibration data: the synthetic corpus and pre-tokenized files.

Port of the offline part of ``gptq_gguf_tpu/utils/data.py``. Sequences are
returned as a list of (1, S) numpy int arrays. The text datasets
(wikitext2, c4, fineweb_edu) need the ``datasets`` package and the network
and are not ported: asking for one raises.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

TEXT_DATASETS = ("wikitext2", "c4", "fineweb_edu")


def get_synthetic(num_tokens: int, sequence_length: int, vocab_size: int = 32000,
                  seed: int = 0) -> List[np.ndarray]:
    """Deterministic offline pseudo-corpus (a Zipf vocabulary with
    short-range repetition); the same stream as the JAX package's for the
    same arguments."""
    rng = np.random.default_rng(seed)
    n_seq = max(1, num_tokens // sequence_length)
    probs = 1.0 / np.arange(1, vocab_size + 1) ** 1.1
    probs /= probs.sum()
    data = []
    for _ in range(n_seq):
        base = rng.choice(vocab_size, size=sequence_length, p=probs)
        rep = rng.random(sequence_length) < 0.3
        base[1:][rep[1:]] = base[:-1][rep[1:]]
        data.append(base[None, :].astype(np.int64))
    return data


def load_token_file(path: str, num_tokens: int, sequence_length: int) -> List[np.ndarray]:
    """Pre-tokenized file: numpy .npy/.npz rows, or a torch .pt/.pth list of
    token tensors."""
    if path.endswith((".npy", ".npz")):
        arr = np.load(path)
        if isinstance(arr, np.lib.npyio.NpzFile):
            arr = arr[list(arr.keys())[0]]
        data = [arr[i][None, :] for i in range(arr.shape[0])]
    else:
        import torch

        obj = torch.load(path, map_location="cpu", weights_only=True)
        data = [np.asarray(t) for t in obj]
        data = [t if t.ndim == 2 else t[None, :] for t in data]
    data = data[: num_tokens // sequence_length]
    return [t[:, :sequence_length] for t in data]


def get_data(name_or_path: str, num_tokens: int, sequence_length: int, train: bool = True,
             vocab_size: int = 32000, seed: int = 0) -> List[np.ndarray]:
    """A token file or the synthetic corpus; text datasets raise."""
    if os.path.isfile(name_or_path):
        return load_token_file(name_or_path, num_tokens, sequence_length)
    if name_or_path in TEXT_DATASETS:
        raise NotImplementedError(
            f"dataset {name_or_path!r} needs the datasets package and the network; "
            "the port reads token files (.npy/.npz/.pt) and 'synthetic'")
    if name_or_path.startswith("synthetic"):
        return get_synthetic(num_tokens, sequence_length, vocab_size,
                             seed=seed if train else seed + 1)
    raise ValueError(f"Unknown dataset: {name_or_path}")
