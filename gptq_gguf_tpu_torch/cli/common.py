"""Shared CLI plumbing: model and calibration-data loading."""

from __future__ import annotations

import argparse

from ..models.llama import _DTYPES


def add_model_args(p: argparse.ArgumentParser, required: bool = True) -> None:
    p.add_argument("--model_name_or_path", type=str, required=required,
                   help="HF checkpoint directory (config.json + safetensors)")
    p.add_argument("--tokenizer_name", type=str, default=None,
                   help="for text datasets, which the port does not read yet")
    p.add_argument("--dtype", type=str, default="float32", choices=sorted(_DTYPES))


def add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--calibration_data", type=str, default="synthetic",
                   help="synthetic | token file (.npy/.npz/.pt)")
    p.add_argument("--calibration_tokens", type=int, default=2**20)
    p.add_argument("--calibration_sequence_length", type=int, default=None)


def load_model(args):
    """(config, host-staged params) of the checkpoint."""
    from ..models import loader

    cfg = loader.load_config(args.model_name_or_path, dtype=_DTYPES[args.dtype])
    return cfg, loader.load_params(args.model_name_or_path, cfg)


def load_calibration(args, cfg):
    from ..utils.data import get_data

    seq = args.calibration_sequence_length or min(cfg.max_position_embeddings, 4096)
    return get_data(args.calibration_data, args.calibration_tokens, seq,
                    vocab_size=cfg.vocab_size, seed=getattr(args, "seed", 0))
