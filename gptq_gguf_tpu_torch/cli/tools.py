"""The ``pack`` and ``ppl`` subcommands of the port (after
``gptq_gguf_tpu/cli/tools.py``).

    python -m gptq_gguf_tpu_torch pack --model_dir /models/llama \\
      --quant_dir out/layers --outfile model.gguf [--outtype f16|f32|bf16|q8_0|auto]

writes a K-quant GGUF from an HF llama checkpoint and the artifacts of
``quantize`` (``export/packer.py``), optionally sharded
(``--split-max-tensors`` / ``--split-max-size``). It runs on the host
(numpy) and launches nothing on the card.

    python -m gptq_gguf_tpu_torch ppl --gguf-file model.gguf \\
      --datasets synthetic --eval_tokens 4096 --sequence_length 512 \\
      [--gguf-path auto|dense|serving] [--output_path ppl.json] [--device cpu]

    python -m gptq_gguf_tpu_torch ppl --model_name_or_path /models/llama ...

A GGUF is scored either dense (every tensor dequantized to f32, through
``models.llama.forward``) or through the serving forward with the weights
kept packed (``--gguf-path serving``: every projection and the lm_head run
through the runtime format's kernel). ``auto`` picks dense below 2e9 bytes
of f32 weights. Datasets are ``synthetic`` or pre-tokenized files, so no
tokenizer is read; the text datasets raise in ``utils.data.get_data``.

The layer database, the search and assembly (``mapper/``, ``search/``):

    python -m gptq_gguf_tpu_torch build-db --models m-Q4_K.gguf m-Q6_K.gguf --output-dir db
    python -m gptq_gguf_tpu_torch search --model_name_or_path /models/llama \
      --quant_weights_path db/layers-hf --target_bitwidth 5.5 --fitness_fn sparse_kl \
      --calibration_data synthetic --calibration_tokens 4096 \
      --calibration_sequence_length 512 [--device cpu]
    python -m gptq_gguf_tpu_torch convert-config \
      --input db/layers-hf/evo-sparse_kl-configuration-5.5.txt --output stitch.txt
    python -m gptq_gguf_tpu_torch stitch --split-dir db/layers-gguf --config stitch.txt \
      --output mixed.gguf [--validate-only | --list-tensors | --inspect-metadata]

``build-db`` splits each GGUF into the raw ``layers-gguf`` and the
dequantized ``layers-hf`` databases (``split`` does one of the two for one
file); ``search`` runs EvoPress on the card, each candidate's layers
swapped into the dense model from ``layers-hf``, and writes its config into
that directory; ``convert-config`` renames it to GGUF tensors; ``stitch``
writes the chosen tensors' bytes as one GGUF. ``gguf-split`` shards a GGUF
(``--split-max-tensors`` / ``--split-max-size``) or merges a set
(``--merge``). All but ``search`` are host code and launch nothing.

Stage 1's llama-quantize route (``quant/{rtn,recipes,imatrix_io}.py``):

    python -m gptq_gguf_tpu_torch imatrix --model_name_or_path /models/llama \
      --calibration_data synthetic --calibration_tokens 16384 \
      --calibration_sequence_length 512 --output model.imatrix [--device cpu]
    python -m gptq_gguf_tpu_torch llama-quantize --input model-f16.gguf \
      --output model-Q4_K_M.gguf --ftype Q4_K_M --imatrix model.imatrix [--device cpu]
    python -m gptq_gguf_tpu_torch rtn-quantize --model_name_or_path /models/llama \
      --quant_type Q4_K --imatrix --save_dir out/layers --outfile model.gguf [--device cpu]

``imatrix`` writes each linear's importance vector (an .npz under HF and
GGUF names, or a llama.cpp .imatrix); ``llama-quantize`` requantizes a
float GGUF with a llama.cpp recipe, its K-quant fits on the card and its
packing on the host; ``rtn-quantize`` writes round-to-nearest artifacts
(and with ``--outfile`` the GGUF ``pack`` makes of them).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from . import common


def build_pack(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model_dir", help="HF checkpoint")
    p.add_argument("--quant_dir", default=None, help="calibration artifacts")
    p.add_argument("--outfile")
    p.add_argument("--outtype", default="f16", choices=["f32", "f16", "bf16", "q8_0", "auto"],
                   help="format of the tensors without an artifact ('auto': the 16-bit "
                        "float of the checkpoint's dtype)")
    p.add_argument("--vocab-only", action="store_true", help="write metadata + vocab, no tensors")
    p.add_argument("--metadata", default=None, help="JSON file of extra metadata overrides")
    p.add_argument("--model-name", default=None, help="override general.name")
    p.add_argument("--print-supported-models", action="store_true")
    p.add_argument("--split-max-tensors", type=int, default=0,
                   help="shard the output GGUF every N tensors")
    p.add_argument("--split-max-size", default=None,
                   help="shard the output GGUF at ~SIZE (e.g. 40G)")
    p.add_argument("--mmproj", action="store_true", help="not ported yet")


def _resolve_outtype(args):
    from ..formats import safetensors
    from ..formats.ggml import GGMLQuantizationType as T

    name = args.outtype
    if name == "auto":  # the 16-bit float of the first file's first tensor
        files = sorted(Path(args.model_dir).glob("*.safetensors"))
        name = "f16"
        if files:
            header, _ = safetensors.read_header(files[0])
            if header:
                name = "bf16" if header[min(header)]["dtype"] == "BF16" else "f16"
    return {"f32": T.F32, "f16": T.F16, "bf16": T.BF16, "q8_0": T.Q8_0}[name]


def _size_bytes(text: str) -> int:
    """"40G" / "512M" / "64K" or a plain byte count."""
    units = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}
    sfx = text[-1].upper()
    return int(text[:-1]) * units[sfx] if sfx in units else int(text)


def run_pack(args):
    """Write the GGUF (or its shards); returns the paths written."""
    from ..export import packer

    if args.print_supported_models:
        for mt in packer.SUPPORTED_MODEL_TYPES:
            print(mt)
        return []
    if args.mmproj:
        raise NotImplementedError("pack --mmproj is not ported yet")
    if not args.model_dir or not args.outfile:
        raise SystemExit("--model_dir and --outfile are required")
    if args.quant_dir is None and not args.vocab_only:
        raise SystemExit("--quant_dir is required unless --vocab-only is given")
    extra = {}
    if args.metadata:
        with open(args.metadata) as f:
            extra.update(json.load(f))
    if args.model_name:
        extra["general.name"] = args.model_name
    t0 = time.perf_counter()
    out = packer.pack_model(args.model_dir, args.quant_dir, args.outfile,
                            default_float=_resolve_outtype(args),
                            extra_metadata=extra or None, vocab_only=args.vocab_only)
    written = [out]
    if args.split_max_tensors or args.split_max_size:
        from ..mapper import shards

        prefix = str(out)[:-5] if str(out).endswith(".gguf") else str(out)
        written = shards.split_gguf_file(
            out, prefix, max_tensors=args.split_max_tensors,
            max_size=_size_bytes(args.split_max_size) if args.split_max_size else 0)
        os.unlink(out)
    for path in written:
        print(f"wrote {path}")
    print(f"pack took {time.perf_counter() - t0:.2f} s")
    return written


def build_ppl(p: argparse.ArgumentParser) -> None:
    common.add_model_args(p, required=False)
    p.add_argument("--gguf-file", default=None,
                   help="evaluate a GGUF directly (through the serving loader)")
    p.add_argument("--datasets", nargs="+", default=["synthetic"],
                   help="synthetic | token file (.npy/.npz/.pt)")
    p.add_argument("--sequence_length", type=int, default=None)
    p.add_argument("--eval_tokens", type=int, default=2**17)
    p.add_argument("--gguf-path", default="auto", choices=["auto", "dense", "serving"],
                   help="GGUF scoring path: 'dense' dequantizes every weight to f32, "
                        "'serving' scores through the fused dequant kernels with the "
                        "weights kept packed; 'auto' picks dense below ~2 GB of f32 "
                        "weights")
    p.add_argument("--output_path", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    # options of the JAX CLI that the port does not take yet
    p.add_argument("--compressed_weights_path", default=None, help="not ported yet")
    p.add_argument("--drop_layer_config", default=None, help="not ported yet")
    p.add_argument("--memory_efficient", action="store_true", help="not ported yet")


def run_ppl(args) -> dict:
    """Score each dataset; prints and returns {dataset: perplexity}."""
    from .. import resolve_device
    from ..evals import ppl
    from ..models.llama import _DTYPES
    from ..utils.data import get_data

    for flag in ("compressed_weights_path", "drop_layer_config", "memory_efficient"):
        if getattr(args, flag):
            raise NotImplementedError(f"ppl --{flag} is not ported yet")
    dev = resolve_device(args.device)
    serving_path = False
    if args.gguf_file:
        from ..mapper.shards import open_gguf
        from ..serving import model as qmodel

        mode = args.gguf_path
        if mode == "auto":  # every shard of a split set counts
            n_el = sum(int(np.prod(i.shape)) for i in open_gguf(args.gguf_file).tensors.values())
            mode = "dense" if n_el * 4 < 2e9 else "serving"
        serving_path = mode == "serving"
        params, cfg = qmodel.load_gguf_for_serving(
            args.gguf_file, dtype=_DTYPES[args.dtype], device=dev, dense=not serving_path)
    else:
        if not args.model_name_or_path:
            raise SystemExit("need --model_name_or_path or --gguf-file")
        cfg, host = common.load_model(args)
        params = {k: v.to(dev).float() for k, v in host.items() if k != "layers"}
        params["layers"] = [{k: v.to(dev).float() for k, v in layer.items()}
                            for layer in host["layers"]]
    seq = args.sequence_length or min(cfg.max_position_embeddings, 4096)
    results = {}
    for name in args.datasets:
        data = get_data(name, args.eval_tokens, seq, train=False, vocab_size=cfg.vocab_size)
        results[name] = ppl.compute_perplexity(params, cfg, data, serving=serving_path)
        print(f"{name} perplexity: {results[name]:.3f}")
    if args.output_path:
        with open(args.output_path, "w") as f:
            json.dump(results, f, indent=2)
    return results


def build_split(p: argparse.ArgumentParser) -> None:
    p.add_argument("--gguf-file", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--gguf-layers", action="store_true", help="raw GGML layout")
    p.add_argument("--hf-layers", action="store_true", help="dequantized HF layout")
    p.add_argument("--bitwidth", default=None, help="type name for tensors of an unknown type")
    p.add_argument("--list-bitwidths", action="store_true")


def run_split(args) -> None:
    from ..mapper import splitter

    if args.list_bitwidths:
        for layer, bws in splitter.list_bitwidths(args.output_dir).items():
            print(f"{layer}: {bws}")
        return
    split = splitter.split_hf if args.hf_layers else splitter.split_gguf
    split(args.gguf_file, args.output_dir, overwrite_bitwidth=args.bitwidth)


def build_stitch(p: argparse.ArgumentParser) -> None:
    p.add_argument("--split-dir", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--output", default=None)
    p.add_argument("--default-bitwidth", type=float, default=4.5)
    p.add_argument("--default-quant-type", default="Q4_K")
    p.add_argument("--validate-only", action="store_true")
    p.add_argument("--list-tensors", action="store_true")
    p.add_argument("--inspect-metadata", action="store_true")


def run_stitch(args) -> None:
    from ..mapper.stitcher import GGUFStitcher

    st = GGUFStitcher(args.split_dir, args.config, args.default_bitwidth,
                      args.default_quant_type)
    if args.validate_only:
        problems = st.validate()
        if problems:
            print("\n".join(problems))
            sys.exit(1)
        print("configuration valid")
        return
    if args.list_tensors:
        for name, info in st.list_tensors().items():
            print(f"{name}: {info}")
        return
    if args.inspect_metadata:
        print(json.dumps(st.manifest.get("metadata", {}), indent=2, default=str))
        return
    if not args.output:
        sys.exit("--output required")
    print(f"wrote {st.stitch(args.output)}")


def build_convert_config(p: argparse.ArgumentParser) -> None:
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--missing-value", default="32")
    p.add_argument("--moe", action="store_true", default=None)


def run_convert_config(args) -> None:
    from ..mapper import config_converter

    cfg = config_converter.convert_file(args.input, args.output, args.missing_value, args.moe)
    print(f"wrote {len(cfg)} entries to {args.output}")


def build_build_db(p: argparse.ArgumentParser) -> None:
    p.add_argument("--models", nargs="+", required=True, help=".gguf files")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--copy-models", action="store_true")
    p.add_argument("--skip-hf", action="store_true")


def run_build_db(args) -> None:
    from ..mapper import db_builder

    db_builder.build_ep_database(args.models, args.output_dir, copy_models=args.copy_models,
                                 skip_hf=args.skip_hf)


def build_search(p: argparse.ArgumentParser) -> None:
    common.add_model_args(p)
    common.add_data_args(p)
    p.add_argument("--quant_weights_path", required=True, help="HF-layout database")
    p.add_argument("--target_bitwidth", type=float, required=True)
    p.add_argument("--generations", type=int, default=50)
    p.add_argument("--offspring", type=int, default=128)
    p.add_argument("--survivors_per_selection", type=int, nargs="+", default=[16, 4, 1])
    p.add_argument("--tokens_per_selection", type=int, nargs="+",
                   default=[2048, 16384, 131072])
    p.add_argument("--fitness_fn", default="kl", choices=["ppl", "kl", "sparse_kl"])
    p.add_argument("--group_rule", default="size", choices=["none", "name", "size"])
    p.add_argument("--initially_generated", type=int, default=64)
    p.add_argument("--initial_tokens", type=int, default=16384)
    p.add_argument("--kl_topk", type=int, default=64)
    p.add_argument("--eval_every", type=int, default=10)
    p.add_argument("--eval_datasets", nargs="+", default=None,
                   help="datasets of the periodic perplexity (synthetic | token file)")
    p.add_argument("--eval_tokens", type=int, default=2**17)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    # options of the JAX CLI that the port does not take yet
    p.add_argument("--wandb", action="store_true", help="not ported yet")
    p.add_argument("--dp", type=int, default=None, help="not ported yet")
    p.add_argument("--tp", type=int, default=1, help="not ported yet")
    p.add_argument("--multihost", action="store_true", help="not ported yet")


def run_search(args) -> str:
    """EvoPress on ``--device``; writes the config into the database
    directory and returns its path."""
    from .. import resolve_device
    from ..search import evopress
    from ..utils.data import get_data

    if args.wandb:
        raise NotImplementedError(
            "search --wandb is not ported yet (ROADMAP Queue 1, 'GPTQ leftovers')")
    if args.multihost or args.dp not in (None, 0, 1) or args.tp not in (None, 0, 1):
        raise NotImplementedError("search over a device mesh (--dp / --tp / --multihost) is "
                                  "not ported yet (ROADMAP Queue 1, 'Scale-out')")
    dev = resolve_device(args.device)
    cfg, host = common.load_model(args)
    params = {k: v.float() for k, v in host.items() if k != "layers"}
    params["layers"] = [{k: v.float() for k, v in layer.items()} for layer in host["layers"]]
    del host
    calib = common.load_calibration(args, cfg)
    model = evopress.SearchModel(params, cfg, args.quant_weights_path, device=dev)
    del params

    target_logits = None
    if args.fitness_fn in ("kl", "sparse_kl"):
        if args.fitness_fn == "kl":
            est = sum(np.atleast_2d(np.asarray(c)).size for c in calib) * cfg.vocab_size * 4
            if est > 8e9:
                print(f"[search] WARNING: dense KL teacher cache needs ~{est / 1e9:.0f} GB "
                      "of host memory (seqs x vocab f32); consider --fitness_fn sparse_kl")
        target_logits = evopress.compute_target_logits(model, calib, args.fitness_fn,
                                                       topk=args.kl_topk)
    ecfg = evopress.EvoPressConfig(
        target_bitwidth=args.target_bitwidth, generations=args.generations,
        offspring=args.offspring, survivors_per_selection=tuple(args.survivors_per_selection),
        tokens_per_selection=tuple(args.tokens_per_selection), fitness_fn=args.fitness_fn,
        group_rule=args.group_rule, initially_generated=args.initially_generated,
        initial_tokens=args.initial_tokens, kl_topk=args.kl_topk, eval_every=args.eval_every,
        seed=args.seed, checkpoint_path=args.checkpoint_path)
    eval_datasets = None
    if args.eval_datasets:
        seq = calib[0].shape[-1]
        eval_datasets = {name: get_data(name, args.eval_tokens, seq, train=False,
                                        vocab_size=cfg.vocab_size)
                         for name in args.eval_datasets}
    best, groups, available = evopress.evo_press_search(
        model, calib, ecfg, target_logits=target_logits, eval_datasets=eval_datasets)
    out = os.path.join(args.quant_weights_path,
                       f"evo-{args.fitness_fn}-configuration-{args.target_bitwidth}.txt")
    evopress.write_config(out, groups, best, available)
    print(f"wrote {out}")
    return out


def build_gguf_split(p: argparse.ArgumentParser) -> None:
    p.add_argument("--input", required=True, help="source .gguf (or first shard for --merge)")
    p.add_argument("--output", required=True,
                   help="shard prefix (split) or output .gguf (merge)")
    p.add_argument("--split-max-tensors", type=int, default=0)
    p.add_argument("--split-max-size", default=None,
                   help="e.g. 500M or 2G (approximate, tensor payloads)")
    p.add_argument("--merge", action="store_true", help="reassemble a shard set into one file")


def run_gguf_split(args) -> None:
    from ..mapper import shards

    if args.merge:
        print(f"wrote {shards.merge_gguf_files(args.input, args.output)}")
        return
    out = shards.split_gguf_file(
        args.input, args.output, max_tensors=args.split_max_tensors,
        max_size=_size_bytes(args.split_max_size) if args.split_max_size else 0)
    for o in out:
        print(f"wrote {o}")


# -- stage 1's llama-quantize route: imatrix, rtn-quantize, llama-quantize ----


def build_rtn(p: argparse.ArgumentParser) -> None:
    common.add_model_args(p)
    common.add_data_args(p)
    p.add_argument("--quant_type", default="Q4_K",
                   choices=["Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K"])
    p.add_argument("--imatrix", action="store_true",
                   help="importance-weighted scale fitting from a calibration pass")
    p.add_argument("--pure", action="store_true",
                   help="quantize embeddings / head at the same type too")
    p.add_argument("--save_dir", required=True)
    p.add_argument("--outfile", default=None, help="optionally pack to .gguf")
    p.add_argument("--summary", default=None, help="quantization_summary.json path")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")


def run_rtn(args) -> None:
    """RTN artifacts of every linear (imatrix-weighted with --imatrix),
    optionally packed into a GGUF with its summary."""
    from .. import resolve_device
    from ..quant import rtn

    dev = resolve_device(args.device)
    cfg, params = common.load_model(args)
    imatrix = None
    if args.imatrix:
        calib = common.load_calibration(args, cfg)
        imatrix = rtn.compute_imatrix(params, cfg, calib, batch_size=args.batch_size,
                                      device=dev)
    qt = args.quant_type
    qmap = {k: qt for k in ("q_proj", "k_proj", "v_proj", "o_proj",
                            "gate_proj", "up_proj", "down_proj")}
    if args.pure:
        qmap["embed_tokens"] = qt
        qmap["lm_head"] = qt
    rtn.rtn_quantize_model(params, cfg, qmap, args.save_dir, imatrix=imatrix,
                           quant_non_block=args.pure, device=dev)
    if args.outfile:
        from ..export import packer

        packer.pack_model(args.model_name_or_path, args.save_dir, args.outfile)
        if args.summary:
            rtn.quantization_summary(args.outfile, args.summary)
        print(f"wrote {args.outfile}")


def build_imatrix(p: argparse.ArgumentParser) -> None:
    common.add_model_args(p)
    common.add_data_args(p)
    p.add_argument("--output", required=True,
                   help=".npz of importance vectors, or a llama.cpp-format binary when "
                        "the name ends in .imatrix")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")


def run_imatrix(args) -> None:
    """Importance vectors of every linear: an .npz under HF and GGUF names,
    or a llama.cpp .imatrix under GGUF names."""
    from .. import resolve_device
    from ..export.packer import hf_to_gguf_name
    from ..quant import rtn

    dev = resolve_device(args.device)
    cfg, params = common.load_model(args)
    calib = common.load_calibration(args, cfg)
    im = rtn.compute_imatrix(params, cfg, calib, batch_size=args.batch_size, device=dev)
    out = {}
    for hf_name, vec in im.items():
        out[hf_name] = np.asarray(vec, np.float32)
        gguf_name = hf_to_gguf_name(hf_name + ".weight")
        if gguf_name:
            out[gguf_name] = out[hf_name]
    if str(args.output).endswith(".imatrix"):
        from ..quant.imatrix_io import save_imatrix

        gguf_only = {k: v for k, v in out.items()
                     if k.startswith(("blk.", "output", "token_embd"))}
        save_imatrix(gguf_only, args.output, dataset=str(args.calibration_data))
        print(f"wrote {len(gguf_only)} importance vectors "
              f"(llama.cpp .imatrix) to {args.output}")
    else:
        np.savez(args.output, **out)
        print(f"wrote {len(im)} importance vectors (hf + gguf keys) to {args.output}")


def build_llama_quantize(p: argparse.ArgumentParser) -> None:
    from ..quant.recipes import FTYPE_IDS

    p.add_argument("--input", required=True, help="source .gguf (typically F16)")
    p.add_argument("--output", required=True)
    p.add_argument("--ftype", required=True, choices=sorted(FTYPE_IDS),
                   help="recipe, e.g. Q4_K_M / IQ4_XS")
    p.add_argument("--imatrix", default=None,
                   help=".npz or llama.cpp .imatrix of per-tensor importance vectors "
                        "(GGUF tensor names)")
    p.add_argument("--pure", action="store_true",
                   help="base type for every tensor (llama-quantize --pure)")
    p.add_argument("--summary", default=None, help="quantization_summary.json path")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the K-quant fits run: cuda (default) or cpu")


def run_llama_quantize(args) -> None:
    """Requantize a GGUF with a recipe; prints the output's bits per weight."""
    from .. import resolve_device
    from ..quant import recipes, rtn

    dev = resolve_device(args.device)
    imatrix = None
    if args.imatrix:
        if str(args.imatrix).endswith(".imatrix"):
            from ..quant.imatrix_io import load_imatrix

            imatrix, _, _ = load_imatrix(args.imatrix)
        else:
            with np.load(args.imatrix) as z:
                imatrix = {k: z[k] for k in z.files}
    progress = (lambda name, t: print(f"{name} -> {t}")) if args.verbose else None
    out = recipes.llama_quantize(args.input, args.output, args.ftype, imatrix=imatrix,
                                 pure=args.pure, progress=progress, device=dev)
    summary = rtn.quantization_summary(out, args.summary)
    print(f"wrote {out} ({summary['bits_per_weight']:.3f} bpw)")
