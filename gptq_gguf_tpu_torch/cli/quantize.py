"""GPTQ quantization subcommand of the port.

    python -m gptq_gguf_tpu_torch quantize \\
      --model_name_or_path /models/Llama-3.2-1B \\
      --calibration_data synthetic --calibration_tokens 262144 \\
      --default_bit_width Q4_K --save_dir out/layers [--device cpu]

Writes one ``<save_dir>/<hf_module_name>/data.npz`` per quantized linear
(the JAX package's artifact layout) and ``stage_timings.json``.
``--eval_perplexity`` then scores the quantized model on 100 sequences of
``--eval_sequence_length`` tokens of the calibration source's evaluation
split (``utils.data.get_data``, train=False).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

from . import common


def build_parser(p: argparse.ArgumentParser) -> None:
    common.add_model_args(p)
    common.add_data_args(p)
    p.add_argument("--quantizable_modules", type=str, default=".*",
                   help="regex for modules to quantize")
    p.add_argument("--quant_non_block_modules", action="store_true")
    p.add_argument("--quant_scale", type=str, default="absmax", choices=["absmax", "mse"])
    p.add_argument("--act_order", action="store_true")
    p.add_argument("--static_groups", action="store_true")
    p.add_argument("--rel_damp", type=float, default=1e-2)
    p.add_argument("--block_size", type=int, default=128)
    p.add_argument("--default_bit_width", type=str, default="Q4_K",
                   choices=["Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K"])
    p.add_argument("--bit_width_configuration", type=str, default=None,
                   help="JSON {module_suffix: Q*_K} map")
    p.add_argument("--rmin", type=float, default=-1.0)
    p.add_argument("--rdelta", type=float, default=0.1)
    p.add_argument("--nstep", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_perplexity", action="store_true")
    p.add_argument("--eval_sequence_length", type=int, default=4096)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--offload-activations", dest="offload_activations",
                   choices=["auto", "on", "off"], default="auto",
                   help="stage calibration activations to host memory between "
                        "blocks (auto: only when the set exceeds 2 GB)")
    p.add_argument("--stage-profile", dest="stage_profile", action="store_true",
                   help="accumulate per-stage wall-clock inside the calibration walk "
                        "(stage_in/capture/factorize_solve/artifact/propagate/unstage) "
                        "into stage_timings.json; synchronises the card at stage ends")
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")


def run(args) -> dict:
    """Quantize; returns the stage timings (also written to the save dir)."""
    from .. import resolve_device
    from ..ops.gptq import GPTQConfig
    from ..ops.kquant import ScaleSearchConfig
    from ..quant import calibrate

    resolve_device(args.device)  # fail before loading anything without a card
    times = {}
    t = time.perf_counter()
    # host-staged: the walk moves one block at a time onto the card
    cfg, params = common.load_model(args)
    times["load_model"] = time.perf_counter() - t
    t = time.perf_counter()
    calib = common.load_calibration(args, cfg)
    times["load_calibration"] = time.perf_counter() - t

    if args.bit_width_configuration:
        with open(args.bit_width_configuration) as f:
            quant_config = json.load(f)
    else:
        quant_config = {k: args.default_bit_width
                        for k in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                                  "down_proj", "up_proj", "embed_tokens", "lm_head")}
    gptq_cfg = GPTQConfig(
        rel_damp=args.rel_damp, block_size=args.block_size, act_order=args.act_order,
        static_groups=args.static_groups or args.act_order,
        scale_cfg=ScaleSearchConfig(quant_scale=args.quant_scale, rmin=args.rmin,
                                    rdelta=args.rdelta, nstep=args.nstep))

    os.makedirs(args.save_dir, exist_ok=True)
    stage_times = {} if args.stage_profile else None
    t = time.perf_counter()
    qparams = calibrate.quantize_model(
        params, cfg, calib, quant_config=quant_config, gptq_cfg=gptq_cfg,
        save_dir=args.save_dir, quant_non_block=args.quant_non_block_modules,
        quantizable_regex=args.quantizable_modules, batch_size=args.batch_size,
        verbose=args.verbose, stage_times=stage_times,
        offload_activations={"auto": None, "on": True, "off": False}[args.offload_activations],
        device=args.device)
    times["quantize"] = time.perf_counter() - t
    print(f"Quantization took {times['quantize']:.1f} s.")
    if stage_times is not None:
        times.update({f"quantize/{k}": v for k, v in stage_times.items()})
        print("stage breakdown:", json.dumps({k: round(v, 2) for k, v in stage_times.items()}))
    if args.eval_perplexity:
        from ..evals.ppl import compute_perplexity
        from ..utils.data import TEXT_DATASETS, get_data

        t = time.perf_counter()
        name = "wikitext2" if args.calibration_data in TEXT_DATASETS else args.calibration_data
        seq = args.eval_sequence_length
        eval_data = get_data(name, 100 * seq, seq, train=False, vocab_size=cfg.vocab_size)
        # onto the card in the dtype each tensor has (the walk's quantized
        # blocks are already there): the forward computes in f32 itself
        dev = resolve_device(args.device)
        qparams = {k: v.to(dev) for k, v in qparams.items() if k != "layers"} | {
            "layers": [{k: v.to(dev) for k, v in layer.items()} for layer in qparams["layers"]]}
        ppl = compute_perplexity(qparams, cfg, eval_data)
        times["eval_perplexity"] = time.perf_counter() - t
        print(f"{name} perplexity: {ppl:.4f}")
    Path(args.save_dir, "stage_timings.json").write_text(json.dumps(times, indent=2))
    if args.verbose:
        for stage, secs in times.items():
            print(f"  {stage}: {secs:.2f}s")
    return times
