#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / H100 port (gptq_gguf_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without a card or outside a
checkout of the repository. Phases, each raising on failure:

1. device and build: the card's name and power limit; the kernels are
   built from gptq_gguf_tpu_torch/ops/csrc/ (one nvcc per source, all at
   once; meanwhile phase 2's weights are packed on the card and, once the
   solve kernel is built, phase 5's two quantize walks run) and their
   build times printed;
2. kernel against its plain PyTorch version on the card, at every
   projection shape of Llama-3-8B (Q4_K, Q6_K lm_head) at M = 8 (v2g's
   CUDA-core tile, the decode tile's threshold raised for these cases)
   and 128, plus Q2_K / Q3_K / Q5_K and a ragged d_out (the CUDA-core
   tile too): error, kernel / plain /
   library ms, and the bound at the card's published rates; then v2g's
   tensor-core prefill tiles (csrc/qmatmul_v2_mma.cuh) at the same shapes
   at the threshold M (qmatmul.MMA_MIN_ROWS) and M = 1024, each within
   1e-5 of its largest sum of |terms| with a planted control that must
   fail that limit, timed beside the 8-row CUDA-core tile and bf16
   torch.matmul; then v2g's tensor-core decode tile
   (csrc/qmatmul_decode_mma.cuh) at the same shapes at M = 1, 2, 4 and 8,
   plus Q2_K / Q3_K / Q5_K and a ragged d_out at M = 5, held the same way
   (the control: the unrounded weights), beside the CUDA-core tile of the
   same rows, held to the same limit and timed, with a per-step sum at
   M = 8;
3. full-width serving: Llama-3-8B widths, synthetic v2 weights from a seed,
   ContinuousBatchingEngine(num_slots=8, max_len=2048) serving 12 requests;
   checks budgets, token ranges and the kernel's launch count (every
   prefill projection on the tensor-core tiles; every call of a B=8
   decode step on the tensor-core decode tile, the 1-row prefill heads
   on the CUDA-core tile: qmatmul.DECODE_MMA_MIN_ROWS["v2g"]), and prints
   decode tok/s and ms/step (plus a steady B=8 block);
4. consistency: 2 layers at full width, one prefill plus 4 decode steps
   through the kernel and through the plain version, logits compared (the
   prefill's 8 projections on the tensor-core tiles; the one-row head and
   decode steps as routed, and again on the decode tile);
5. GPTQ at full width: the column-block solve kernel against its plain
   version at every Llama-3-8B solve shape (bit-equal); the ``quantize``
   command line on a seeded 2-layer Llama-3-8B-width bf16 checkpoint with
   262144 synthetic calibration tokens, once as a user runs it (14
   artifacts, 416 kernel launches, GPTQ objective at or below RTN's on
   every linear, seconds per layer) and once instrumented (the stage
   breakdown, the refit's and the factorizations' seconds); one whole
   o-projection solve through the kernel and through the plain version;
   the artifacts packed into the v2 serving format and run through v2g;
   after 7e, the ``pack`` command line writes the checkpoint (with a BPE
   tokenizer.json of its 128256 tokens) and its artifacts as a bf16 +
   Q4_K GGUF (seconds, bytes and tensors beside the card's name and power
   limit; host code), read back exactly (each Q4_K tensor unpacks to its
   artifact bit for bit, each float tensor holds the checkpoint's values,
   general.file_type 15), loaded onto the card (each projection's v2
   planes equal 7e's), served by ``serve`` from 16 prompt tokens (v2g
   launches; greedy tokens equal 7e's v2 tokens up to a near-tie, each
   step's top-2 gap printed) and from a text prompt through the GGUF's own
   vocabulary, and scored by ``ppl --gguf-path serving`` (finite); then the
   search and assembly path on the same checkpoint: ``quantize
   --default_bit_width Q6_K`` (16384 tokens, on the solve kernel, its
   launches printed) packed as a second GGUF; ``build-db`` of the Q4_K and
   Q6_K GGUFs (every layers-gguf file its GGUF tensor's bytes, every
   layers-hf tensor its dequantization, q / k rows inverse-permuted, f16:
   exact, host); ``search`` on the card (sparse KL, 5.5 bits, group rule
   size, 4096 tokens in sequences of 512, 4 generations of 8 offspring,
   survivors 2 then 1; a config within budget naming database files and
   holding both types; teacher, per-candidate and per-generation seconds;
   the sparse KL of uniform Q4_K, uniform Q6_K, below it, and the config);
   ``convert-config`` and ``stitch`` (each tensor the bytes of the GGUF
   whose type the config picked, the source's metadata but
   general.file_type and its tensor order; the scored layers-hf tensors
   the stitched tensors' dequantization); ``serve`` of the stitched GGUF
   (its v2 planes equal to those quantize_params_for_serving builds from
   the artifacts the config picked, v2g launches as many as the config
   implies, a prefill's calls on the tensor-core tiles and a B=8 step's on
   the decode tile held call by call with a planted control, greedy tokens
   equal to the plain versions' up to a near-tie); ``gguf-split
   --split-max-tensors 8`` (the first shard serves the same tokens,
   ``--merge`` gives back the file byte for byte); ``ppl --gguf-path
   serving`` (finite); the step's seconds and peak disk use;
6. paged serving at full width (run before phase 5, while the serving
   weights are on the card): both paged flash-decode kernels against their
   plain versions at the 8B attention shape (B=8, 8 kv heads of 4 query
   heads, hd 128, page 64, lengths 0-2047 with -1 past the live pages;
   plain, window, sinks, softcap), timed at fill 300 and 1900 beside their
   byte bound and one SDPA call over the gathered live K/V; 2-layer logits
   paged through the kernels against paged through the plain versions and
   against the contiguous cache, with a planted-fault control (a decode
   attention without its last live chunk) that must fail the same limit;
   PagedContinuousBatchingEngine serving
   phase 3's 12-request mix in bf16, int4 and on an oversubscribed 24-page
   pool (budgets, pages returned, a kernel launch per layer and decode
   step); a steady B=8 step at fill 300 and 1900; HTTP (serve_http on port
   0): 8 concurrent requests equal the engine's direct outputs, one
   streamed; the engine runs on the first PAGED_SERVING_LAYERS = 4 layers;
7. the v1 and v4 runtime formats at full width (after phase 6, on the same
   model: the v2 weights converted on the card, every format's planes held
   to the package's packers first): (a) the v1 kernel and the v4 kernel's
   three bodies (f32 and bf16 scales, i32 and i8 layouts) against their
   plain versions at every 8B projection shape and the unpadded Q6_K
   lm_head at M = 1, 2, 4, 8, the threshold M, 128, 1024 with a bf16 x
   (from the threshold on their tensor-core tiles,
   csrc/qmatmul_v1_mma.cuh and the v4 policy, and from
   qmatmul.DECODE_MMA_MIN_ROWS["v1"] / ["v4"] to 8 rows on their
   tensor-core decode tiles, csrc/qmatmul_decode_mma.cuh, each within
   1e-5 of the largest sum of |terms| with a planted control that must
   fail that limit: v4 the unrounded weights, v1 the weights rounded to
   bf16; beside each v1 tensor-core case and each decode-tile case the
   CUDA-core tile of the same rows, held to the same limit and timed),
   plus Q2_K / Q3_K / Q5_K and ragged d_out with an f32 x (the CUDA-core
   tiles: v1's f32 x stays on v1_kernel at every M) and, for v1, with a
   bf16 x at 9-130 rows (its tiles; 333 columns: vec 1, v1_kernel);
   (b) 2-layer logits kernel vs plain per format, v1's also call by call
   on shared inputs (the plain output handed on; each call within 1e-5
   of its group dot's terms, the weights rounded to bf16 as the control);
   (c) phase 3's 12
   requests served (on the first FORMAT_SERVING_LAYERS = 4 layers) in v1,
   v4 and v4 i8 (33 launches of that format's kernel per forward, none of
   another's; v1's and v4's every prefill projection on the tensor-core
   tiles, v1's and v4's every call of a decode step on their decode tiles)
   between two v2 runs at the same depth; (d) perplexity through
   the serving path on the 32-layer model in v2, v1 and v4 (2 sequences
   of 512 tokens, within 0.05 nats/token of each other; every call on the
   format's tensor-core tiles, each format within 1e-3 nats/token of the
   same model through its plain version); (e)
   after phase 5, its GPTQ artifacts served through
   quantize_params_for_serving in v1, v2 and v4 (dequantization bit-equal
   to the artifacts', greedy tokens);
8. the v2 kernel variants at full width (after phase 7, on phase 3's v2
   weights): (a) the per-weight kernels v2 (bf16 and f32 operands), v3,
   v2f, v2h, v2s (Q4_K) and the group-dot kernels v2m / v2t (Q4_K) and
   v2p (the padded Q6_K lm_head) against their plain versions at every 8B
   projection shape, M = 8 and 128, plus Q2_K / Q3_K / Q5_K and ragged
   d_out with every per-weight variant's f32 mode among them; each case
   within 1e-5 of its largest sum of |terms|, a limit a planted control
   (another variant's rounding) must fail; the tensor-core tiles of v2,
   v3, v2f, v2h and v2s as phase 2 holds v2g's, and those of v2m and v2t
   (Q4_K shapes) and v2p (the head; csrc/qmatmul_v2m_mma.cuh) likewise,
   with small Q2_K / Q3_K / Q5_K and ragged cases at 9 rows or more (v2s:
   Q2_K, Q3_K, ragged Q4_K); v2p's tensor-core decode tile (the group-dot
   form of csrc/qmatmul_decode_mma.cuh) on the head at M = 1, 2, 4 and 8
   and small Q2_K / Q3_K / ragged Q6_K cases, held the same way (control:
   v2g's rounding) beside the CUDA-core tile of the same rows; so are
   v2h's decode tile (V2Mma<kV2h>: every 8B shape and the head; control:
   v2f's f32 affine), and at the four Q4_K projection shapes v2t's (its
   group-sum form; control: v2g's rounding), v2m's (the group-dot form at
   gs 32; control: v2g's rounding) and v2s's (V2Mma<kV2s>, split halves;
   control: the unrounded scale * q) at M = 1, 2, 4 and 8, and v3's
   (V2Mma<kV3>, packed bf16 weights, the xsum term; control: the
   unrounded scale * q), v2's (V2Mma<kV2>, its FMA forms; control: v2g's
   rounding) and v2f's (V2Mma<kV2f>, v2's FMA forms, which give its
   weights; control: v2g's rounding) at every 8B shape and the head, with
   small Q2_K / Q3_K / Q5_K and ragged cases; (b) 2-layer logits under each knob
   setting, one pass in which every matmul call runs the variant's kernel
   and its plain version on the same x (the plain output handed on), each
   call within 8a's limit and the head's logits within 3e-3 of max|logit|,
   a planted control (control_of's plain version in place of the kernel)
   that must fail the per-call limit, and the same pass with every
   decode-tile variant's threshold at one row (every decode step's call
   on a decode tile, v2f's among them); beside it, printed only, the
   kernels end to end against the plain versions end to end and against
   v2g's; (c) phase 3's 12 requests served (on the first
   VARIANT_SERVING_LAYERS = 4 layers) under
   PALLAS_V2_VARIANT = v2, v2m, v2t, v2g with the gs=16 knob at v2p, v3,
   v2f, v2h and v2s, in turns between two v2g runs, each with its exact
   launches per forward (every call of a B=8 step on a decode tile: under
   v2m its projections on v2m's and its head on v2p's, under v2h, v3, v2
   and v2f every call on the variant's, under v2t and v2s the projections on
   the variant's and the head on v2g's); (d) perplexity through the
   serving path under
   v2m, v2, v2t and v2s, within 0.05 nats/token of v2g's (phase 7d); every
   call on the tensor-core tiles (under v2m: v2m's, and v2p's on the head;
   under v2t and v2s: theirs, and v2g's on the head), v2m, v2t and v2s
   within 1e-3 nats/token of the same model through their plain versions;
9. sampled decoding and the int8 / int4 contiguous caches (run after phase
   4, on the first SAMPLED_SERVING_LAYERS = 4 layers of phase 3's model,
   phase 3's mix served greedily at that depth first as the reference): (a) the sampler chain (serving/sampling.py) on
   one B=8 decode step's logits, each row with its own temperature, top-k,
   top-p, min-p, penalties and seed, on the card and on the CPU: penalized
   logits within 1e-6, masks equal but at elements whose exclusive mass
   lies within TOP_P_EDGE of top_p (counted), SAMPLER_STEPS draws of every
   row equal but where the noisy top-2 gap is below NOISY_TIE (counted),
   with the draw counter shifted by one as a planted control that must
   fail; SAMPLER_DRAWS draws of one row within 5 sd of its masked softmax
   and none outside it; the sampler's device ms per B=8 step; (b) phase
   3's 12 requests with mixed settings (mix_sampling) through the
   contiguous engine twice (phase 3's launches per forward, every call of
   a B=8 step on v2g's decode tile; the same tokens both times) and the
   paged engine (4 v2g launches a layer plus the head a forward, one paged-kernel launch a
   layer and step), each seeded request equal to itself served alone and
   on the paged engine up to a near-tie, top_k = 1 at temperature 1 equal
   to the greedy tokens at its depth, ms/step and tok/s; (c) the int8 and int4
   caches: 2-layer logits (a 128-token prefill and 4 decode steps) on the
   card against the CPU plain path (KV_CPU_LIMIT: phase 4's for int8) and
   against the bf16 cache (KV_LOGIT_LIMIT), the contiguous int4 cache against the paged
   int4 kernel (phase 6's limit), the mix served in each (launches, the
   cache's bytes against KV_BYTES, ms/step); (d) a seeded sampled chat with
   n = 2 and logprobs over serve_http: two distinct choices, repeated on a
   second call, each token's logprob the engine's own;
10. stage 1's llama-quantize route (run last, in phase 5's temporary
   directory, on its 2-layer checkpoint): (a) ``imatrix`` of 16384
   synthetic tokens written as a llama.cpp .imatrix (layer 0's q/k/v
   vector within 1e-4 of a float64 host computation of input_layernorm of
   the embedding; the file read back exactly); (b) ``pack --outtype bf16``
   with no artifacts (its tensor bytes); (c) ``llama-quantize --ftype
   Q4_K_M --imatrix`` with every K-quant fit on the card (the recipe's
   type for every tensor, general.file_type, tensor bytes, 5.316 bits per
   weight; seconds of host reads, card fits, host packing and writing),
   ``rtn-quantize --quant_type Q4_K --imatrix`` whose layer-0 artifacts
   pack to the recipe file's tensors byte for byte, quantize_tensor_blocks
   of a Q6_K and a Q4_K tensor equal on the card and the CPU, and each
   linear's imatrix-weighted error of the imatrix fit at most 1.001 times
   a plain fit's; (d) that file served (v2g launches per forward as its
   types imply, a prefill's and a B=8 step's v2g calls held call by call
   with a planted control, greedy tokens against the plain versions' up
   to a near-tie); (e) ``llama-quantize --ftype Q3_K_M --imatrix``
   (Q3_K, Q4_K, Q5_K and Q6_K at 8B widths) checked and served the same way;
11. the qwen3 and qwen2 families (run after phase 10, in the same temporary
   directory): (a) a seeded 1-layer checkpoint of Qwen3-8B's widths (hidden
   4096, 32 heads of 128, 8 KV heads, intermediate 12288, vocab 151936; q /
   k norm weights drawn) through ``quantize`` (GPTQ on the solve kernel,
   16384 tokens, embedding and head RTN at the default Q4_K; 192 solve
   launches), ``pack``
   and ``serve`` (5 v2g calls a forward: q / k / v and gate / up fused, the
   head padded to 152064 rows; the calls of an 8 x 16-token prefill and a
   B=8 step held call by call with the planted control; tokens against the
   plain versions' up to a near-tie), then 4 greedy requests on the
   contiguous and the paged engine (bf16 pool), their tokens equal up to a
   near-tie; (b) a seeded 1-layer checkpoint of Qwen2.5-7B's widths (hidden
   3584, 28 heads, 4 KV heads, intermediate 18944, vocab 152064; q / k / v
   biases drawn) through ``rtn-quantize --outfile`` and ``serve`` the same
   way (6 v2g calls a forward: q / k / v apart, the bf16 head dense), and
   the solve kernel at its block shapes and over one whole 18944-column
   down solve, against its plain version;
12. the rest of evals/ and the search's leftovers (run after phase 11, on
   phase 5's checkpoint, layers-hf database, searched config and GGUFs):
   (a) ``ppl`` with the database's weights swapped in by the searched
   config and at the Q4_K level, each within 0.05 nats/token of the GGUF
   holding the same weights scored dense; layer 1 dropped; block by block
   (``--memory_efficient``) within 1e-3 of plain; (b) ``estimate-errors``
   over the database (Q6_K below Q4_K on all 14 linears; layer 0's o_proj
   against a float64 host computation); (c) the FastOBQ ladder at bits 2-8
   (84 files; errors falling with bits, 4 bits at or below flat RTN, by
   ``estimate-errors``), the FastOBC ladder at sparsity 0.5 (3 levels; every
   block's zeros its threshold's count), the OWL ratios, and the first 256
   rows of layer 0's k_proj through both solvers on the card and the CPU
   from one factor; (d) ``parity`` at
   Q4_K and Q6_K (416 solve-kernel launches each, JAX's report keys), each
   GGUF through ``ppl --gguf-path serving`` (v2g launches as its types
   imply, within 0.05 nats/token of the report); (e) lm-eval's scorers at
   batch 8 and 1 and ``score_rolling`` against ``compute_perplexity``; (f)
   one ``masked_sgd`` step on the pruned layer-0 down_proj.

The second-to-last line is the kernel summary JSON, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import filecmp
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12   # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12     # f32 on the CUDA cores
SEED = 7
V, H, I, N_LAYERS, N_HEAD, N_KV, HD = 128256, 4096, 14336, 32, 32, 8, 128


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, flush=None, sleep_cycles: int = 5_000_000) -> float:
    """Mean device time of fn() over reps calls: CUDA events around each
    call, ``flush`` (L2 eviction) outside them. A device sleep queued first
    (``sleep_cycles``) keeps the card busy while the host queues every
    call, so host overhead between the events is not counted: it must
    outlast the host's queueing of all reps. An event recorded right after
    the sleep shows it did (it is still pending once the last call is
    queued); where it did not, the reading is taken once more behind a
    sleep 16 times as long (a fn that waits for the card itself can never
    be covered, so there is no third try)."""
    import torch

    fn()
    fn()  # warm-up: first-call library setup stays out
    torch.cuda.synchronize()
    while True:
        torch.cuda._sleep(sleep_cycles)
        slept = torch.cuda.Event()
        slept.record()
        events = []
        for _ in range(reps):
            if flush is not None:
                flush()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        covered = not slept.query()
        torch.cuda.synchronize()
        if covered or sleep_cycles > 50_000_000:
            return sum(a.elapsed_time(b) for a, b in events) / reps
        sleep_cycles *= 16


def call_ms(fn, reps: int) -> float:
    """Host wall time per call of back-to-back calls, host overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def synthetic_rql(rng, d_out, d_in, qtype, device):
    """Random codes and two-level scales packed by the port's
    pack_runtime_v2; scales give weights of std ~ 1/sqrt(d_in)."""
    from gptq_gguf_tpu_torch.ops import qmatmul

    return qmatmul.pack_runtime_v2(*synthetic_codes(rng, d_out, d_in, qtype), qtype,
                                   device=device)


def synthetic_codes(rng, d_out, d_in, qtype):
    """(codes, SuperGroupParams) of a random layer, numpy."""
    from gptq_gguf_tpu_torch.formats.ggml import KQUANT_SPECS
    from gptq_gguf_tpu_torch.ops.kquant import SuperGroupParams

    spec = KQUANT_SPECS[qtype]
    n_sg, ng = d_in // 256, d_in // spec.group_size
    q = rng.integers(spec.qmin, spec.qmax + 1, size=(d_out, d_in), dtype=np.int8)
    q_std = (spec.qmax - spec.qmin + 1) / np.sqrt(12.0)
    d = 1.0 / (np.sqrt(d_in) * (spec.scale_maxq / 2) * q_std)
    ss = (d * rng.uniform(0.5, 1.5, (d_out, n_sg))).astype(np.float16)
    if spec.signed:
        sc = rng.integers(-spec.scale_maxq, spec.scale_maxq + 1, (d_out, ng), dtype=np.int8)
        sz = np.zeros_like(ss)
        zq = np.zeros((d_out, ng), np.uint8)
    else:
        sc = rng.integers(1, spec.scale_maxq + 1, (d_out, ng), dtype=np.uint8)
        sz = ss.copy()
        zq = rng.integers(0, spec.scale_maxq + 1, (d_out, ng), dtype=np.uint8)
    return q, SuperGroupParams(ss, sz, sc, zq)


def layer_variant(base, gen, code_bits):
    """A distinct copy of a packed weight: every column's codes XOR-ed with
    a random mask (codes stay in range), every plane in its own memory."""
    import torch

    from gptq_gguf_tpu_torch.ops.qmatmul import RuntimeQuantLinearV2

    hi = 256 if base.per_byte == 2 else 1 << code_bits
    mask = torch.randint(0, hi, (1, base.d_out), generator=gen,
                         device=base.qs.device, dtype=torch.int32).to(torch.uint8)
    clone = lambda t: None if t is None else t.clone()  # noqa: E731
    return RuntimeQuantLinearV2(
        torch.bitwise_xor(base.qs, mask), clone(base.d_sg), clone(base.dmin_sg),
        clone(base.sc_q), clone(base.mn_q), base.d_in, base.group_size,
        base.per_byte, base.shift, base.d_rep)


def card_name_and_power() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phase_device_and_build():
    import torch

    from gptq_gguf_tpu_torch.ops import cuda_build

    log(card_name_and_power())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    def timed_build(name):
        t0 = time.time()
        out = cuda_build.build(name)
        return out, time.time() - t0

    names = ("qmatmul_v2g", "gptq_solve", "paged_decode", "qmatmul_v1", "qmatmul_v4",
             "qmatmul_v2", "qmatmul_v2m", "qmatmul_v3")
    ex = ThreadPoolExecutor(len(names))  # one nvcc per source, all at once
    builds = {name: ex.submit(timed_build, name) for name in names}
    done = set()

    def finish(*only):
        """Wait for the builds named (all by default); log each one's
        seconds and ptxas report once."""
        for name in only or names:
            if name in done:
                continue
            done.add(name)
            nvcc_log, secs = builds[name].result()
            log(f"build: {name} in {secs:.1f} s ({'cached' if nvcc_log is None else 'built'})")
            regs = [int(m) for m in re.findall(r"Used (\d+) registers", nvcc_log or "")]
            spill = sum(int(m) for m in re.findall(r"(\d+) bytes spill", nvcc_log or ""))
            if regs:
                log(f"  ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
                    f"{spill} bytes of spill stores and loads")
        if not only:
            ex.shutdown()

    return finish


def term_magnitude(x, rql) -> float:
    """max over outputs of |bf16(x)| @ |scale*q| + |xsum| @ |off2|: the
    size of the f32 sums both versions accumulate."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul

    M, d_in = x.shape
    gs = rql.group_size
    scale, off2 = qmatmul._folded_planes_v2(rql)
    q = qmatmul._unpack_codes(rql.qs, rql.per_byte, d_in).float()
    wsq = (scale[:, None, :] * q.reshape(-1, gs, rql.d_out)).reshape(d_in, rql.d_out)
    x32 = x.float()
    xsum = x32.reshape(M, -1, gs).sum(dim=-1)
    xb = x32.to(torch.bfloat16).float()
    return ((xb.abs() @ wsq.abs()) + (xsum.abs() @ off2.abs())).max().item()


def kernel_case(name, x, rql, flush):
    """Kernel vs plain version on the same inputs; returns the record."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul

    M, d_in = x.shape
    y_k = qmatmul.dequant_matmul_v2g(x, rql)
    y_p = qmatmul.dequant_matmul_v2g_reference(x, rql)
    torch.cuda.synchronize()
    if not torch.isfinite(y_k).all():
        raise RuntimeError(f"{name}: kernel output is not finite")
    # tolerance: the two differ only in the order of f32 sums, so the error
    # is held to 1e-4 of the largest sum of |terms| of one output
    err = (y_k - y_p).abs().max().item()
    tol = 1e-4 * max(term_magnitude(x, rql), 1e-30)
    if not err <= tol:
        raise RuntimeError(f"{name}: kernel vs plain max|err| {err:.3e} > tol {tol:.3e}")
    w_lib = qmatmul.dequantize_runtime_v2(rql).T.contiguous().to(torch.bfloat16)
    xbf = x.to(torch.bfloat16)
    ms = cuda_ms(lambda: qmatmul.dequant_matmul_v2g(x, rql), 20, flush)
    wall_ms = call_ms(lambda: qmatmul.dequant_matmul_v2g(x, rql), 20)
    plain_ms = cuda_ms(lambda: qmatmul.dequant_matmul_v2g_reference(x, rql), 1, flush)
    library_ms = cuda_ms(lambda: torch.matmul(xbf, w_lib), 20, flush)
    del w_lib
    # bytes: each plane once (one copy of each super-scale row), x, y
    nbytes = rql.bytes_read + x.numel() * x.element_size() + M * rql.d_out * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * M * d_in * rql.d_out / BF16_FLOP_PER_S * 1e3
    rec = dict(name=name, M=M, d_in=d_in, d_out=rql.d_out, max_abs_err=err,
               max_rel_err=err / max(y_p.abs().max().item(), 1e-30), tol=tol,
               ms=ms, call_ms=wall_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, plane_bytes=rql.bytes_read, flops=2.0 * M * d_in * rql.d_out)
    log(f"  {name:>22} M={M:<4} err {err:.3e} (rel {rec['max_rel_err']:.2e}, tol {tol:.2e})"
        f"  kernel {ms:.4f} ms (call {wall_ms:.4f})  plain {plain_ms:.3f} ms"
        f"  library {library_ms:.4f} ms"
        f"  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec


def build_8b(rng, device):
    """Llama-3-8B-width serving params (32 distinct layers), fused."""
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.models.llama import LlamaConfig
    from gptq_gguf_tpu_torch.ops import qmatmul
    from gptq_gguf_tpu_torch.serving import model as qmodel

    cfg = LlamaConfig(vocab_size=V, hidden_size=H, intermediate_size=I,
                      num_hidden_layers=N_LAYERS, num_attention_heads=N_HEAD,
                      num_key_value_heads=N_KV, head_dim=HD, rope_theta=500000.0,
                      max_position_embeddings=2048, dtype=torch.bfloat16)
    base = {
        "input_layernorm": torch.ones(H, dtype=torch.bfloat16, device=device),
        "post_attention_layernorm": torch.ones(H, dtype=torch.bfloat16, device=device),
        "q_proj": synthetic_rql(rng, H, H, T.Q4_K, device),
        "k_proj": synthetic_rql(rng, N_KV * HD, H, T.Q4_K, device),
        "v_proj": synthetic_rql(rng, N_KV * HD, H, T.Q4_K, device),
        "o_proj": synthetic_rql(rng, H, H, T.Q4_K, device),
        "gate_proj": synthetic_rql(rng, I, H, T.Q4_K, device),
        "up_proj": synthetic_rql(rng, I, H, T.Q4_K, device),
        "down_proj": synthetic_rql(rng, H, I, T.Q4_K, device),
    }
    base = qmodel.fuse_layer_projections(base, cfg)
    if "qkv_proj" not in base or "gateup_proj" not in base:
        raise RuntimeError("q/k/v or gate/up did not fuse")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    layers = []
    for _ in range(N_LAYERS):
        layers.append({k: (layer_variant(v, gen, 4)
                           if isinstance(v, qmatmul.RuntimeQuantLinearV2) else v.clone())
                       for k, v in base.items()})
    embed = torch.randn(V, H, generator=gen, device=device).to(torch.bfloat16) * 0.02
    lm_head = qmatmul.pad_dout_v2(synthetic_rql(rng, V, H, T.Q6_K, device))
    params = {"embed_tokens": embed, "layers": layers,
              "norm": torch.ones(H, dtype=torch.bfloat16, device=device),
              "lm_head": lm_head}
    return params, cfg


def step_shapes(params):
    """(name, weight) of the five matmuls of one forward: layer 0's fused
    projections and the padded Q6_K lm_head."""
    l0 = params["layers"][0]
    return [("qkv 4096->6144 Q4_K", l0["qkv_proj"]), ("o 4096->4096 Q4_K", l0["o_proj"]),
            ("gateup 4096->28672 Q4_K", l0["gateup_proj"]),
            ("down 14336->4096 Q4_K", l0["down_proj"]),
            ("lm_head 4096->128512 Q6_K", params["lm_head"])]


def phase_kernels(params, rng, device):
    """v2g's CUDA-core tile (kernel_case) at the five 8B shapes at M = 8 and
    at the small cases, with the decode tile's threshold raised for them
    (the route runs that tile at one row and with f32 operands; the
    decode tile is held in phase_decode_mma_kernels), and its prefill tiles
    at M = 128."""
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.ops import qmatmul

    def core_case(name, x, rql):
        fn = qmatmul.dequant_matmul_v2g
        min_rows = qmatmul.DECODE_MMA_MIN_ROWS["v2g"]
        qmatmul.DECODE_MMA_MIN_ROWS["v2g"] = qmatmul.MMA_MIN_ROWS
        d0, m0 = fn.decode_mma_launches, fn.mma_launches
        try:
            rec = kernel_case(name, x, rql, flush)
        finally:
            qmatmul.DECODE_MMA_MIN_ROWS["v2g"] = min_rows
        if (fn.decode_mma_launches, fn.mma_launches) != (d0, m0):
            raise RuntimeError(f"{name} M={x.shape[0]}: not on the CUDA-core tile")
        return rec

    cases = step_shapes(params)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    recs = []
    for M in (8, 128):
        for name, rql in cases:
            x = (torch.randn(M, rql.d_in_local, device=device) * 0.5).to(torch.bfloat16)
            recs.append(core_case(name, x, rql) if M <= 8 else kernel_case(name, x, rql, flush))
    small = [("Q2_K 1024->768", 768, 1024, T.Q2_K, 8),
             ("Q3_K 1024->768", 768, 1024, T.Q3_K, 8),
             ("Q5_K 1024->768", 768, 1024, T.Q5_K, 8),
             ("ragged Q4_K 2048->1000", 1000, 2048, T.Q4_K, 5),
             ("ragged Q6_K 512->333 f32x", 333, 512, T.Q6_K, 3)]
    for name, d_out, d_in, qt, M in small:
        rql = synthetic_rql(rng, d_out, d_in, qt, device)
        x = torch.randn(M, d_in, device=device)
        if "f32x" not in name:
            x = x.to(torch.bfloat16)
        recs.append(core_case(name, x, rql))
    return recs


def mma_case(name, v, x, rql, flush):
    """variant_case for variant ``v``'s tensor-core tiles (bf16 operands):
    its wrapper must count them (a vec-1 weight, d_out % 4 != 0, must
    not); beside it, the 8-row CUDA-core tile on the same inputs (still
    built: decode steps and f32 operands run it)."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul

    M = x.shape[0]
    fn = getattr(qmatmul, qmatmul.V2_WRAPPERS[v])
    m0 = fn.mma_launches
    rec = variant_case(name, v, "bf16", x, rql, flush)
    if (fn.mma_launches > m0) != (rql.d_out % 4 == 0):
        raise RuntimeError(f"{v} {name} M={M}: tensor-core launches {fn.mma_launches - m0}")
    lib, code = qmatmul._PER_WEIGHT.get(v) or ("qmatmul_v2m", qmatmul._GROUP_DOT[v][0])
    rec["core8_ms"] = cuda_ms(lambda: qmatmul._launch_v2(
        lib, code, x, rql, torch.bfloat16, 8), 3, flush)
    rec["tflop_s"] = rec["flops"] / rec["ms"] / 1e9
    tiles = "tensor-core" if rql.d_out % 4 == 0 else "vec-1 CUDA-core"
    log(f"  {v:>3} {name:>24} M={M:<4} {tiles} {rec['ms']:.4f} ms "
        f"({rec['tflop_s']:.1f} TFLOP/s), 8-row CUDA-core tile "
        f"{rec['core8_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec


# 8a's group-dot cases at prefill rows beyond the 8B shapes: name, d_out,
# d_in, type, M, variant (f32x: x in f32, rounded to bf16 as it is staged;
# 333 columns: vec 1, the CUDA-core tiles at any M)
GROUP_DOT_SMALL = (("Q2_K 1024->768", 768, 1024, "Q2_K", 9, "v2p"),
                   ("Q3_K 1024->768 f32x", 768, 1024, "Q3_K", 130, "v2p"),
                   ("Q5_K 1024->768", 768, 1024, "Q5_K", 64, "v2m"),
                   ("ragged Q4_K 2048->1000", 1000, 2048, "Q4_K", 40, "v2m"),
                   ("ragged Q6_K 512->333", 333, 512, "Q6_K", 9, "v2p"),
                   ("Q5_K 1024->768 f32x", 768, 1024, "Q5_K", 130, "v2t"),
                   ("ragged Q4_K 2048->1000", 1000, 2048, "Q4_K", 9, "v2t"))
# ... and v2s's (4-bit codes)
V2S_SMALL = (("Q2_K 1024->768", 768, 1024, "Q2_K", 130, "v2s"),
             ("Q3_K 1024->768 f32x", 768, 1024, "Q3_K", 9, "v2s"),
             ("ragged Q4_K 2048->1000", 1000, 2048, "Q4_K", 40, "v2s"))


def phase_mma_kernels(params, variants, device, rng=None, small=()):
    """The tensor-core tiles of ``variants`` (bf16 operands; each shape runs
    the variant's effective kernel, as the dispatch does: v2m the v2p
    tiles on the gs-16 lm_head; v2t and v2s would run v2g's there, which
    phase 2 holds already) against their plain versions at every
    Llama-3-8B projection shape and the padded Q6_K lm_head, at the
    threshold M and at M = 1024 (mma_case: within 1e-5 of the largest sum
    of |terms|, with a planted control that must fail that limit); then
    the ``small`` cases (GROUP_DOT_SMALL's layout, weights from ``rng``)."""
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.ops import qmatmul

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device).zero_
    recs = []
    for M in (qmatmul.MMA_MIN_ROWS, 1024):
        for name, rql in step_shapes(params):
            x = (torch.randn(M, rql.d_in_local, device=device) * 0.5).to(torch.bfloat16)
            for v in variants:
                v_eff = qmatmul.effective_v2_variant_for(rql, variant=v)
                if v_eff == v or v_eff not in qmatmul.MMA_VARIANTS:
                    recs.append(mma_case(name, v_eff, x, rql, flush))
            del x
            torch.cuda.empty_cache()
    for name, d_out, d_in, qt, M, v in small:
        rql = synthetic_rql(rng, d_out, d_in, T[qt], device)
        x = torch.randn(M, d_in, device=device)
        if "f32x" not in name:
            x = x.to(torch.bfloat16)
        recs.append(mma_case(name, v, x, rql, flush))
    return recs


# the decode tile's cases beyond the 8B shapes: name, d_out, d_in, type, M
# (f32x: x in f32, rounded to bf16 as it is staged; 1000 columns: d_out %
# 16 != 0, 4-byte copies)
DECODE_SMALL = (("Q2_K 1024->768", 768, 1024, "Q2_K", 5),
                ("Q3_K 1024->768 f32x", 768, 1024, "Q3_K", 5),
                ("Q5_K 1024->768", 768, 1024, "Q5_K", 5),
                ("ragged Q4_K 2048->1000", 1000, 2048, "Q4_K", 5))
DECODE_MS = (1, 2, 4, 8)  # rows of the decode tile's 8B cases


# the planted control of a decode-tile case where it is not control_of's:
# v2h's weight against v2f's f32 affine, bf16(scale * q - off2)
DECODE_CONTROL = {"v2h": ("v2f", "bf16")}


def decode_case(name, x, rql, flush, variant="v2g"):
    """variant_case for the tensor-core decode tile of ``variant`` (v2g,
    v2h, v3, v2, v2f, v2s's split halves, v2t's group-sum form or the
    group-dot form of v2m and v2p; bf16 operands,
    M <= 8; at fewer rows than the variant's threshold,
    qmatmul.DECODE_MMA_MIN_ROWS[variant], where the route takes the
    CUDA-core tile, with that threshold lowered for the case): within 1e-5
    of the largest sum of |terms| of an output, a limit its planted
    control (v2g, v2s: the group-dot plain version, the unrounded scale *
    q; v2t, v2m, v2p, v2, v2f: v2g's plain version, bf16(scale * q); v2h:
    v2f's, the f32 affine rounded once) must fail; every launch of the case counted on
    ``decode_mma_launches`` and none on ``mma_launches``; beside it, the
    CUDA-core tile of the same rows on the same inputs (qmatmul's internal
    route with the tensor-core tiles ruled out), held to the same limit
    and timed."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul

    fn = getattr(qmatmul, qmatmul.V2_WRAPPERS[variant])
    n0, d0, m0 = fn.launches, fn.decode_mma_launches, fn.mma_launches
    rows = qmatmul.DECODE_MMA_MIN_ROWS
    min_rows = rows[variant]  # below it the route's is the CUDA-core tile
    rows[variant] = min(min_rows, x.shape[0])
    try:
        rec = variant_case(name, variant, "bf16", x, rql, flush, DECODE_CONTROL.get(variant))
    finally:
        rows[variant] = min_rows
    n = fn.launches - n0
    if fn.decode_mma_launches - d0 != n or fn.mma_launches != m0 or n == 0:
        raise RuntimeError(f"{variant} decode tile {name} M={x.shape[0]}: {n} launches, "
                           f"{fn.decode_mma_launches - d0} on the decode tile, "
                           f"{fn.mma_launches - m0} on the prefill tiles")
    lib, code = (qmatmul._PER_WEIGHT.get(variant)
                 or ("qmatmul_v2m", qmatmul._GROUP_DOT[variant][0]))

    def core():
        return qmatmul._launch_v2(lib, code, x, rql, torch.bfloat16, 8)

    y_c, mt = core()
    y_p = variant_fns()[variant][1](x, rql, torch.bfloat16)
    torch.cuda.synchronize()
    rec["core_err"] = (y_c - y_p).abs().max().item()
    if mt > 8 or not rec["core_err"] <= rec["tol"]:
        raise RuntimeError(f"CUDA-core tile {name} M={x.shape[0]} (tile {mt}): max|err| "
                           f"{rec['core_err']:.3e} > tol {rec['tol']:.3e}")
    del y_c, y_p
    rec["core_ms"] = cuda_ms(core, 20, flush)
    log(f"  {variant} decode tile {name:>24} M={x.shape[0]}: {rec['ms']:.4f} ms, CUDA-core tile "
        f"{rec['core_ms']:.4f} ms (err {rec['core_err']:.2e}), library {rec['library_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); control {rec['control_err']:.2e} "
        f"> tol {rec['tol']:.2e}")
    return rec


def phase_decode_mma_kernels(params, device, rng):
    """v2g's tensor-core decode tile at every Llama-3-8B projection shape
    and the padded Q6_K lm_head at M = 1, 2, 4 and 8 (decode_case), then
    DECODE_SMALL; prints one B=8 step's sum (4 x 32 projections + the
    head at M = 8)."""
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device).zero_
    recs = []
    for M in DECODE_MS:
        for name, rql in step_shapes(params):
            x = (torch.randn(M, rql.d_in_local, device=device) * 0.5).to(torch.bfloat16)
            recs.append(decode_case(name, x, rql, flush))
            del x
            torch.cuda.empty_cache()
    for name, d_out, d_in, qt, M in DECODE_SMALL:
        rql = synthetic_rql(rng, d_out, d_in, T[qt], device)
        x = torch.randn(M, d_in, device=device)
        if "f32x" not in name:
            x = x.to(torch.bfloat16)
        recs.append(decode_case(name, x, rql, flush))
    step = decode_step(recs, 8)
    log(f"decode tile, one B=8 step (4 x {N_LAYERS} projections + lm_head): "
        f"{step['ms']:.3f} ms, CUDA-core tile {step['core_ms']:.3f} ms, library "
        f"{step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms ({step['bound_by']})")
    return recs


# 8a's v2p decode-tile cases beyond the head: name, d_out, d_in, type, M
# (f32x: x in f32, rounded to bf16 as it is staged; 1000 columns: 4-byte
# copies)
V2P_DECODE_SMALL = (("Q2_K 1024->768", 768, 1024, "Q2_K", 5),
                    ("Q3_K 1024->768 f32x", 768, 1024, "Q3_K", 3),
                    ("ragged Q6_K 2048->1000", 1000, 2048, "Q6_K", 8))


def phase_v2p_decode_kernels(params, device, rng):
    """8a: v2p's tensor-core decode tile (the group-dot form of
    csrc/qmatmul_decode_mma.cuh) on the padded Q6_K lm_head at M = 1, 2, 4
    and 8 (decode_case: 1e-5 limit, v2g's rounding as the planted control,
    the CUDA-core tile beside it), then V2P_DECODE_SMALL."""
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device).zero_
    head = params["lm_head"]
    recs = []
    for M in DECODE_MS:
        x = (torch.randn(M, head.d_in_local, device=device) * 0.5).to(torch.bfloat16)
        recs.append(decode_case("lm_head 4096->128512 Q6_K", x, head, flush, "v2p"))
    for name, d_out, d_in, qt, M in V2P_DECODE_SMALL:
        rql = synthetic_rql(rng, d_out, d_in, T[qt], device)
        x = torch.randn(M, d_in, device=device)
        if "f32x" not in name:
            x = x.to(torch.bfloat16)
        recs.append(decode_case(name, x, rql, flush, "v2p"))
    torch.cuda.empty_cache()
    return recs


# 8a's v2h and v2t decode-tile cases beyond the 8B shapes: name, d_out,
# d_in, type, M, variant (f32x: x in f32, rounded to bf16 as it is staged;
# 1000 columns: 4-byte copies)
V2H_V2T_DECODE_SMALL = (("Q2_K 1024->768", 768, 1024, "Q2_K", 5, "v2h"),
                        ("Q3_K 1024->768 f32x", 768, 1024, "Q3_K", 3, "v2h"),
                        ("ragged Q5_K 2048->1000", 1000, 2048, "Q5_K", 8, "v2h"),
                        ("Q5_K 1024->768", 768, 1024, "Q5_K", 5, "v2t"),
                        ("ragged Q4_K 2048->1000 f32x", 1000, 2048, "Q4_K", 3, "v2t"))
# the same for v2m and v2s, drawn from a generator of their own (SEED):
# drawn from the phases' shared one, they moved 8b's random prompt
V2M_V2S_DECODE_SMALL = (("Q5_K 1024->768", 768, 1024, "Q5_K", 6, "v2m"),
                        ("Q2_K 1024->768", 768, 1024, "Q2_K", 5, "v2s"),
                        ("Q3_K 1024->768 f32x", 768, 1024, "Q3_K", 3, "v2s"),
                        ("ragged Q4_K 2048->1000", 1000, 2048, "Q4_K", 7, "v2s"))
# the same for v3, v2 and v2f, from another generator of their own (SEED)
V3_V2_DECODE_SMALL = (("Q2_K 1024->768", 768, 1024, "Q2_K", 5, "v3"),
                      ("Q3_K 1024->768 f32x", 768, 1024, "Q3_K", 3, "v3"),
                      ("Q5_K 1024->768", 768, 1024, "Q5_K", 6, "v3"),
                      ("ragged Q6_K 2048->1000", 1000, 2048, "Q6_K", 7, "v3"),
                      ("Q2_K 1024->768", 768, 1024, "Q2_K", 6, "v2"),
                      ("Q3_K 1024->768 f32x", 768, 1024, "Q3_K", 2, "v2"),
                      ("Q5_K 1024->768", 768, 1024, "Q5_K", 5, "v2"),
                      ("ragged Q4_K 2048->1000", 1000, 2048, "Q4_K", 8, "v2"),
                      ("Q3_K 1024->768 f32x", 768, 1024, "Q3_K", 5, "v2f"),
                      ("Q5_K 1024->768", 768, 1024, "Q5_K", 2, "v2f"),
                      ("ragged Q6_K 2048->1000", 1000, 2048, "Q6_K", 8, "v2f"))
# the variants whose decode tiles 8a holds at the four Q4_K projection
# shapes, and those of them it holds at the head too (their 8c runs put
# every call of a B=8 step on their decode tiles)
Q4_DECODE_VARIANTS = ("v2h", "v2t", "v2m", "v2s", "v3", "v2", "v2f")
HEAD_DECODE_VARIANTS = ("v2h", "v3", "v2", "v2f")


def phase_v2h_v2t_decode_kernels(params, device, rng):
    """8a: the tensor-core decode tiles of v2h, v3, v2 and v2f (every 8B
    shape and the padded Q6_K head), v2t (its group-sum form), v2m (the
    group-dot form at gs 32) and v2s (split halves), the last three at the
    four Q4_K projection shapes, at M = 1, 2, 4 and 8 (decode_case: 1e-5
    limit, the planted control, the CUDA-core tile beside it), then
    V2H_V2T_DECODE_SMALL, V2M_V2S_DECODE_SMALL and V3_V2_DECODE_SMALL."""
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device).zero_
    recs = []
    for M in DECODE_MS:
        for name, rql in step_shapes(params):
            x = (torch.randn(M, rql.d_in_local, device=device) * 0.5).to(torch.bfloat16)
            for variant in (HEAD_DECODE_VARIANTS if name.startswith("lm_head")
                            else Q4_DECODE_VARIANTS):
                recs.append(decode_case(name, x, rql, flush, variant))
            del x
            torch.cuda.empty_cache()
    for cases, gen in ((V2H_V2T_DECODE_SMALL, rng),
                       (V2M_V2S_DECODE_SMALL, np.random.default_rng(SEED)),
                       (V3_V2_DECODE_SMALL, np.random.default_rng(SEED))):
        for name, d_out, d_in, qt, M, variant in cases:
            rql = synthetic_rql(gen, d_out, d_in, T[qt], device)
            x = torch.randn(M, d_in, device=device)
            if "f32x" not in name:
                x = x.to(torch.bfloat16)
            recs.append(decode_case(name, x, rql, flush, variant))
    return recs


def on_core(vrecs, drecs, variant):
    """8a's records for the summary entry of ``variant``'s CUDA-core tile
    (``qmatmul_<variant>``): its B=8 step's calls at M = 8, which the route
    now gives the decode tile, timed on the CUDA-core tile beside it
    (decode_case's "core_ms", from ``drecs``) in place of its M = 8 bf16
    records in ``vrecs``."""
    def step_shape(r):
        return r["variant"] == variant and r["M"] == 8 and r["name"].split()[0] in STEP

    core = [dict(r, ms=r["core_ms"], mxu="bf16", tile="cuda_core") for r in drecs
            if step_shape(r)]
    return [r for r in vrecs if not (step_shape(r) and r["mxu"] == "bf16")] + core


def variant_decode_summary(variant, source, line, shapes, recs, launches):
    """The summary entry of ``variant``'s tensor-core decode tile: its calls
    of one B=8 decode step (``shapes``: each projection 32 times, the head
    once; M = 8) from 8a's decode_case records, the CUDA-core tile's beside
    them ("core_ms"), M = 1, 2 and 4 under "at_m"; ``launches`` from 8c's
    run under the variant that calls it (every such call of its B=8 decode
    steps); its error the largest of its cases."""
    def at(M):
        per = {r["name"].split()[0]: r for r in recs if r["variant"] == variant and r["M"] == M
               and r["name"].split()[0] in shapes}

        def total(key):
            return sum(per[k][key] * (1 if k == "lm_head" else N_LAYERS) for k in shapes)

        t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = total("flops") / BF16_FLOP_PER_S * 1e3
        return {"ms": total("ms"), "plain_ms": total("plain_ms"),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": total("library_ms"), "core_ms": total("core_ms")}

    calls = sum(1 if k == "lm_head" else N_LAYERS for k in shapes)
    return {"name": f"qmatmul_{variant}_decode_mma", "route": "cuda",
            "source": f"gptq_gguf_tpu_torch/ops/csrc/{source}",
            "replaces": f"gptq_gguf_tpu/ops/qmatmul.py:{line}", "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs if r["variant"] == variant),
            **at(8), "per": f"one B=8 decode step's {variant} calls (bf16 operands): "
                            f"{calls} call{'s' if calls > 1 else ''}",
            "at_m": {M: at(M) for M in DECODE_MS if M != 8}}



def decode_step(recs, M):
    """One Llama-3-8B forward's 129 calls (each projection 32 times, the
    lm_head once) at M rows from the decode tile's records: kernel,
    plain, library and CUDA-core tile ms, and the bound."""
    per = {r["name"].split()[0]: r for r in recs if r["M"] == M and r["name"].split()[0] in STEP}

    def total(key):
        return sum(per[k][key] * (1 if k == "lm_head" else N_LAYERS) for k in STEP)

    t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
    t_ops = total("flops") / BF16_FLOP_PER_S * 1e3
    return {"ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": total("library_ms"), "core_ms": total("core_ms")}


def decode_summary(recs, launches):
    """The summary entry of v2g's tensor-core decode tile: one B=8 decode
    step (M = 8, 129 calls) from phase 2's records, M = 1, 2 and 4 beside
    it; ``launches`` from phase 3's run (every call of its B=8 decode
    steps); its error the largest of all its cases."""
    return {"name": "qmatmul_v2g_decode_mma", "route": "cuda",
            "source": "gptq_gguf_tpu_torch/ops/csrc/qmatmul_decode_mma.cuh",
            "replaces": "gptq_gguf_tpu/ops/qmatmul.py:605", "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs), **decode_step(recs, 8),
            "per": f"one B=8 decode step (v2g, bf16 operands): {4 * N_LAYERS + 1} calls",
            "at_m": {M: decode_step(recs, M) for M in DECODE_MS if M != 8}}


def mma_forward(recs, variant, M, shapes):
    """One Llama-3-8B forward's share of ``shapes`` (each projection 32
    times, the lm_head once) at M rows, from ``variant``'s tensor-core
    records: kernel, plain, library and 8-row CUDA-core tile ms, and the
    bound."""
    per = {r["name"].split()[0]: r for r in recs if r["variant"] == variant and r["M"] == M}

    def total(key):
        return sum(per[k][key] * (1 if k == "lm_head" else N_LAYERS) for k in shapes)

    t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
    t_ops = total("flops") / BF16_FLOP_PER_S * 1e3
    return {"ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": total("library_ms"), "core8_ms": total("core8_ms")}


def mma_summary(recs, launches):
    """The summary entry of the tensor-core tiles: one Llama-3-8B forward
    at M = 1024 (4 x 32 projections and the lm_head, bf16 operands) under
    v2g, from phase 2's records; each variant's forward and the threshold
    M beside it. Its error is the largest of every tensor-core case."""
    from gptq_gguf_tpu_torch.ops import qmatmul

    def forward(variant, M):
        return mma_forward(recs, variant, M, STEP)

    return {"name": "qmatmul_v2_mma", "route": "cuda",
            "source": "gptq_gguf_tpu_torch/ops/csrc/qmatmul_v2_mma.cuh",
            "replaces": "gptq_gguf_tpu/ops/qmatmul.py:605", "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs), **forward("v2g", 1024),
            "per": f"one Llama-3-8B forward at M = 1024 (v2g, bf16 operands): "
                   f"{4 * N_LAYERS + 1} calls",
            "at_min_rows": {"M": qmatmul.MMA_MIN_ROWS, **forward("v2g", qmatmul.MMA_MIN_ROWS)},
            "variants": {v: {M: forward(v, M) for M in (qmatmul.MMA_MIN_ROWS, 1024)}
                         for v in ("v2", "v3", "v2f", "v2h")}}


# the dequant-matmul wrappers: one per format, and the v2 format's variants
MATMUL_KERNELS = ("v2g", "v1", "v4", "v2", "v3", "v2f", "v2h", "v2s", "v2m", "v2t", "v2p")


def matmul_wrappers():
    from gptq_gguf_tpu_torch.ops import qmatmul, qmv4

    return {"v1": qmatmul.dequant_matmul_v1, "v4": qmv4.dequant_matmul_v4,
            **{v: getattr(qmatmul, name) for v, name in qmatmul.V2_WRAPPERS.items()}}


def reset_matmul_counts() -> None:
    """Every dequant-matmul wrapper's launch count to 0 (its tensor-core
    counts too, and the v4 wrapper's counts per JAX body)."""
    fns = matmul_wrappers()
    for fn in fns.values():
        fn.launches = 0
        if hasattr(fn, "mma_launches"):
            fn.mma_launches = 0
        if hasattr(fn, "decode_mma_launches"):
            fn.decode_mma_launches = 0
    for key in ("body_launches", "body_mma_launches", "body_decode_mma_launches"):
        setattr(fns["v4"], key, dict.fromkeys(getattr(fns["v4"], key), 0))


def mma_counts() -> dict:
    """kernel -> tensor-core launches of its wrapper (every v2 variant, v1
    with a bf16 x, and v4: csrc/qmatmul_mma.cuh)."""
    from gptq_gguf_tpu_torch.ops import qmatmul, qmv4

    return {**{v: getattr(qmatmul, qmatmul.V2_WRAPPERS[v]).mma_launches
               for v in qmatmul.MMA_VARIANTS + qmatmul.MMA_GROUP_DOT},
            "v1": qmatmul.dequant_matmul_v1.mma_launches,
            "v4": qmv4.dequant_matmul_v4.mma_launches}


def decode_counts() -> dict:
    """kernel -> launches of its tensor-core decode tile
    (csrc/qmatmul_decode_mma.cuh: the v2 variants of
    qmatmul.DECODE_MMA_VARIANTS, v4 and v1)."""
    from gptq_gguf_tpu_torch.ops import qmatmul, qmv4

    return {**{v: getattr(qmatmul, qmatmul.V2_WRAPPERS[v]).decode_mma_launches
               for v in qmatmul.DECODE_MMA_VARIANTS},
            "v4": qmv4.dequant_matmul_v4.decode_mma_launches,
            "v1": qmatmul.dequant_matmul_v1.decode_mma_launches}


def want_decode(per_forward: dict, shapes, n_layers: int) -> dict:
    """The decode-tile launches a run of forwards with token ``shapes``
    (B, S) should count: every call of a kernel of
    qmatmul.DECODE_MMA_MIN_ROWS (the v2 variants v2g, v2p, v2h, v2t, v2m,
    v2s, v3, v2 and v2f with bf16 operands; v4 on vec-4 weights: every 8B
    one; v1 with a bf16 x on them, which serving passes at every call)
    from its threshold to MMA_MIN_ROWS - 1 rows, the projections at B * S
    rows and the head at B (``per_forward`` names each kernel's calls per
    forward: 4 per layer, the head, or both)."""
    from gptq_gguf_tpu_torch.ops import qmatmul

    out = {}
    for v, lo in qmatmul.DECODE_MMA_MIN_ROWS.items():
        on_tile = range(lo, qmatmul.MMA_MIN_ROWS)
        n = per_forward.get(v, 0)
        proj, head = n >= 4 * n_layers, n in (1, 4 * n_layers + 1)
        out[v] = sum(4 * n_layers * (proj and b * s in on_tile) + (head and b in on_tile)
                     for b, s in shapes)
    return out


def matmul_counts() -> dict:
    fns = matmul_wrappers()
    out = {k: fn.launches for k, fn in fns.items()}
    out.update({f"v4_{b}": n for b, n in fns["v4"].body_launches.items()})
    out.update({f"v4_{b}_mma": n for b, n in fns["v4"].body_mma_launches.items()})
    out.update({f"v4_{b}_decode_mma": n
                for b, n in fns["v4"].body_decode_mma_launches.items()})
    return out


def phase_serving(params, cfg, requests, kernel="v2g", label="v2", per_forward=None,
                  sampling=None, engine_kw=None, steady=True):
    """ContinuousBatchingEngine(num_slots=8, max_len=2048, **engine_kw) on
    ``requests`` (each with its SamplingParams from ``sampling``, or greedy)
    with ``params`` in one runtime format: budgets, token ranges, and every
    packed matmul through ``kernel``'s wrapper (4 per layer + the lm_head
    per forward; or the launches per forward ``per_forward`` names, by
    wrapper) and no other's; every projection of a prefill (16 rows or
    more) on the tensor-core tiles when ``kernel`` has them, and nothing of
    a decode step (8 rows) or a head (each sequence's last row); every
    call of a decode step on the tensor-core decode tile (v2g, v1, v4:
    want_decode); then (``steady``) a steady B=8 decode block. The record
    holds each request's tokens (in request order) and the cache's bytes."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul
    from gptq_gguf_tpu_torch.serving import engine, model as qmodel

    n_fwd = [0]
    rows, shapes = [], []
    decode = {"s": 0.0, "steps": 0}
    fwd0 = qmodel.forward_cached
    scans = {"_decode_steps_scan": engine._decode_steps_scan,
             "_sampled_decode_steps_scan": engine._sampled_decode_steps_scan}

    def counting_forward(*a, **kw):
        n_fwd[0] += 1
        rows.append(a[2].numel())
        shapes.append(tuple(a[2].shape))
        return fwd0(*a, **kw)

    def timed(scan0, k_arg):
        def timed_scan(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = scan0(*a, **kw)
            torch.cuda.synchronize()
            decode["s"] += time.perf_counter() - t
            decode["steps"] += a[k_arg] if len(a) > k_arg else kw["k"]
            return out
        return timed_scan

    eng = engine.ContinuousBatchingEngine(params, cfg, num_slots=8, max_len=2048,
                                          **(engine_kw or {}))
    sampling = sampling or [None] * len(requests)
    order = [eng.submit(p, max_new_tokens=n, sampling_params=sp)
             for (p, n), sp in zip(requests, sampling)]
    uids = set(order)
    qmodel.forward_cached = counting_forward
    engine._decode_steps_scan = timed(scans["_decode_steps_scan"], 4)
    engine._sampled_decode_steps_scan = timed(scans["_sampled_decode_steps_scan"], 5)
    reset_matmul_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        qmodel.forward_cached = fwd0
        for name, fn in scans.items():
            setattr(engine, name, fn)
    counts = matmul_counts()
    mma = mma_counts()
    dmma = decode_counts()
    launches = counts[kernel]
    by_uid = {r.uid: r for r in done}
    if len(done) != 12 or set(by_uid) != uids:
        raise RuntimeError(f"served {len(done)} of 12 requests")
    budgets = {u: r.max_new_tokens for u, r in by_uid.items()}
    for r in done:
        if len(r.output) != budgets[r.uid] or r.finish_reason != "length":
            raise RuntimeError(f"request {r.uid}: {len(r.output)} tokens, "
                               f"budget {budgets[r.uid]}, {r.finish_reason}")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise RuntimeError(f"request {r.uid}: token id out of range")
    per_forward = per_forward or {kernel: 4 * cfg.num_hidden_layers + 1}
    want = {k: per_forward.get(k, 0) * n_fwd[0] for k in MATMUL_KERNELS}
    if launches == 0 or any(counts[k] != want[k] for k in MATMUL_KERNELS):
        raise RuntimeError(f"{label} serving: kernel launches {counts}, want "
                           f"{per_forward} x {n_fwd[0]} forwards")
    n_prefill = sum(r >= qmatmul.MMA_MIN_ROWS for r in rows)
    want_mma = {k: 4 * cfg.num_hidden_layers * n_prefill if k == kernel else 0 for k in mma}
    if mma != want_mma:
        raise RuntimeError(f"{label} serving: tensor-core launches {mma}, want {want_mma} "
                           f"({n_prefill} forwards of {qmatmul.MMA_MIN_ROWS} rows or more)")
    want_dmma = want_decode(per_forward, shapes, cfg.num_hidden_layers)
    if dmma != want_dmma:
        raise RuntimeError(f"{label} serving: decode-tile launches {dmma}, want {want_dmma}")
    if any(dmma.values()):
        lo = qmatmul.DECODE_MMA_MIN_ROWS
        log(f"serving ({label}): {dmma} tensor-core decode-tile launches: every call of "
            + ", ".join(f"{k} of {lo[k]}-{qmatmul.MMA_MIN_ROWS - 1} rows"
                        for k, n in dmma.items() if n))
    if kernel in mma:
        log(f"serving ({label}): {mma[kernel]} tensor-core launches = 4 x "
            f"{cfg.num_hidden_layers} per prefill forward x {n_prefill} (rows "
            f"{min((r for r in rows if r >= qmatmul.MMA_MIN_ROWS), default=0)}-{max(rows)}); none in "
            f"the {len(rows) - n_prefill} forwards of "
            f"{max((r for r in rows if r < qmatmul.MMA_MIN_ROWS), default=0)} rows or fewer")
    gen_tokens = sum(len(r.output) for r in done)
    log(f"serving ({label}): depth {cfg.num_hidden_layers}, 12 requests, {gen_tokens} tokens in "
        f"{wall:.2f} s; {n_fwd[0]} forwards, kernel launches "
        f"{ {k: counts[k] for k in per_forward} } ({per_forward} per forward), "
        f"prefix hits {eng.prefix_hits}")
    log(f"serving decode ({label}): {decode['steps']} block steps in {decode['s']:.3f} s "
        f"= {decode['s'] / max(decode['steps'], 1) * 1e3:.2f} ms/step, "
        f"{(gen_tokens - 12) / decode['s']:.1f} generated tok/s")
    kv_bytes = sum(t.numel() * t.element_size() for bufs in eng.cache[:-1] for t in bufs)
    rec = dict(wall_s=wall, serve_decode_ms_per_step=decode["s"] / max(decode["steps"], 1) * 1e3,
               generated_tok_s=(gen_tokens - 12) / decode["s"], launches=launches,
               mma_launches=mma.get(kernel, 0), decode_mma_launches=dmma,
               prefill_forwards=n_prefill, forwards=n_fwd[0],
               b8_steps=shapes.count((8, 1)), kv_bytes=kv_bytes,
               outputs=[by_uid[u].output for u in order])
    if not steady:
        return counts, rec
    # steady B=8 decode: every slot live at fill ~300, one 32-step block
    tokens = torch.randint(0, cfg.vocab_size, (8,), device=eng.device, dtype=torch.int32)
    cache = eng.cache._replace(lengths=torch.full((8,), 300, dtype=torch.int32,
                                                  device=eng.device))
    engine._decode_steps_scan(params, cfg, tokens, cache, 4, 300)  # warm
    cache = cache._replace(lengths=torch.full((8,), 300, dtype=torch.int32,
                                              device=eng.device))
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, toks, _ = engine._decode_steps_scan(params, cfg, tokens, cache, 32, 300)
    toks.cpu()
    dt = (time.perf_counter() - t) / 32
    log(f"steady decode B=8 ({label}): {dt * 1e3:.2f} ms/step, {8 / dt:.1f} tok/s")
    return counts, dict(rec, decode_ms_per_step=dt * 1e3, decode_tok_s=8 / dt)


def two_layer_logits(params, cfg, prompt, feed, mm, device):
    """Logits of the first 2 layers of ``params``: one prefill of ``prompt``
    (1, S) and one decode step per token of ``feed``, with every packed
    matmul through ``mm`` (a kernel wrapper or a plain version)."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul
    from gptq_gguf_tpu_torch.serving import engine, model as qmodel

    p2 = {**params, "layers": params["layers"][:2]}
    c2 = dataclasses.replace(cfg, num_hidden_layers=2)
    fn0 = qmatmul.dequant_matmul
    qmatmul.dequant_matmul = mm
    try:
        cache = qmodel.init_cache(c2, 1, 2048, device=device)
        _, row, cache = engine._prefill_slot(p2, c2, prompt, cache, 0)
        rows = [row[None]]
        for j in range(feed.shape[0]):  # the same fed tokens on every path
            logits, cache = qmodel.forward_cached(p2, c2, feed[j][None, None], cache)
            rows.append(logits)
        return torch.cat(rows)
    finally:
        qmatmul.dequant_matmul = fn0


def phase_consistency(params, cfg, rng, device):
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul

    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 128)), device=device)

    def run(mm):
        return two_layer_logits(params, cfg, prompt, feed, mm, device)

    def exact_f32(x, rql):  # control: no bf16 rounding of weights or x
        return x.float() @ qmatmul.dequantize_runtime_v2(rql).T

    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4,)), device=device)
    shapes = [(1, 128)] + [(1, 1)] * 4
    reset_matmul_counts()
    lk = run(qmatmul.dequant_matmul_v2g)
    n_mma, dmma = mma_counts()["v2g"], decode_counts()
    want_dmma = want_decode({"v2g": 4 * 2 + 1}, shapes, 2)
    log(f"consistency: {n_mma} tensor-core launches (the 128-row prefill's 4 x 2 "
        f"projections), decode tile {dmma} (its 1-row head and the 4 decode steps: "
        f"the decode tile from {qmatmul.DECODE_MMA_MIN_ROWS['v2g']} rows)")
    if n_mma != 4 * 2:
        raise RuntimeError(f"consistency: {n_mma} tensor-core launches, want 8")
    if dmma != want_dmma:
        raise RuntimeError(f"consistency: decode-tile launches {dmma}, want {want_dmma}")
    # the same with every one-row call on the decode tile too
    min_rows, qmatmul.DECODE_MMA_MIN_ROWS["v2g"] = qmatmul.DECODE_MMA_MIN_ROWS["v2g"], 1
    try:
        reset_matmul_counts()
        ld = run(qmatmul.dequant_matmul_v2g)
        dmma1, want1 = decode_counts(), want_decode({"v2g": 4 * 2 + 1}, shapes, 2)
    finally:
        qmatmul.DECODE_MMA_MIN_ROWS["v2g"] = min_rows
    if dmma1 != want1:
        raise RuntimeError(f"consistency: decode-tile launches {dmma1} from one row, want {want1}")
    lp = run(qmatmul.dequant_matmul_v2g_reference)
    lc = run(exact_f32)
    # tolerance: kernel and plain differ in f32 sum order only; bf16
    # rounding of the activations between layers turns that into rare
    # 1-ulp flips. The limit sits between that error and the control's,
    # which drops the bf16 rounding of the matmul's inputs.
    scale = lp.abs().max().item()
    err = (lk - lp).abs().max().item()
    err_d = (ld - lp).abs().max().item()
    err_c = (lc - lp).abs().max().item()
    tol = 3e-3 * scale
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    log(f"consistency (2 layers, prefill + 4 decode): max|dlogit| kernel {err:.3e} "
        f"(one-row calls on the decode tile: {err_d:.3e}, {dmma1} launches), "
        f"exact-f32 control {err_c:.3e}, tol {tol:.3e} (3e-3 of max|logit| "
        f"{scale:.3e}); argmax agreement {agree:.2f}")
    if not (torch.isfinite(lk).all() and err <= tol and torch.isfinite(ld).all()
            and err_d <= tol):
        raise RuntimeError("kernel and plain logits disagree")
    if not err_c > tol:
        raise RuntimeError("the limit does not tell the exact-f32 control from the plain version")


# ---------------------------------------------------------------------------
# Phase 9: sampled decoding and the int8 / int4 contiguous caches
# ---------------------------------------------------------------------------

SAMPLER_STEPS = 64     # 9a: draws of every row held card against CPU
SAMPLER_DRAWS = 4096   # 9a: draws of one row held to its masked softmax
TOP_P_EDGE = 1e-5      # exclusive mass this close to top_p: card and CPU masks may differ
NOISY_TIE = 1e-4       # a noisy top-2 gap (scaled scores) below which card and CPU may draw apart
F32_MIN = float(np.finfo(np.float32).min)
KV_DTYPES = ("int8", "int4")
# the contiguous cache's bytes at 32 layers, 8 slots, 2049 rows (the drop row
# included), 8 KV heads of 128: bf16 K / V; int8 codes + f32 entry scales;
# int4 codes + f32 group scales
KV_BYTES = {"bf16": 2_148_532_224, "int8": 1_107_836_928, "int4": 671_416_320}
# 2-layer logits of a quantized cache against the bf16 cache, as a fraction
# of max|logit|: the quantization's own error, which the limit states
KV_LOGIT_LIMIT = {"int8": 2e-2, "int4": 1e-1}
# card against the CPU plain path, as a fraction of max|logit|: phase 4's
# 3e-3 (f32 sum order, turned into rare bf16 flips); int4 twice that: a K or
# V value one bf16 ulp apart can round to the next int4 code at a .5
# boundary, a step of a seventh of its group's largest |value| (the codes
# that differ between the two caches are counted and printed)
KV_CPU_LIMIT = {"int8": 3e-3, "int4": 6e-3}
CHAT_TEMPLATE = ("{% for m in messages %}<{{ m['role'] }}>{{ m['content'] }}{% endfor %}"
                 "{% if add_generation_prompt %}<assistant>{% endif %}")


def sampler_rows():
    """9a's eight rows: each its own settings and seed."""
    from gptq_gguf_tpu_torch.serving.sampling import SamplingParams as SP

    return [SP(temperature=0.7, seed=11), SP(temperature=1.0, top_k=50, seed=12),
            SP(temperature=0.9, top_p=0.9, seed=13), SP(temperature=1.2, min_p=0.05, seed=14),
            SP(temperature=0.8, top_k=40, top_p=0.95, min_p=0.02, repetition_penalty=1.2,
               seed=15),
            SP(temperature=1.0, presence_penalty=0.5, frequency_penalty=0.3, seed=16),
            SP(repetition_penalty=1.3), SP(temperature=0.6, top_k=20, seed=17)]


def mix_sampling(n: int):
    """Phase 3's mix with mixed settings, by request index mod 6: greedy;
    seeded temperature with top-k / top-p / min-p; penalties at
    temperature 0; top_k = 1 at temperature 1 (greedy's tokens); seeded
    top-p; unseeded min-p with a penalty (the engine's fallback seed)."""
    from gptq_gguf_tpu_torch.serving.sampling import SamplingParams as SP

    kinds = (lambda i: SP(),
             lambda i: SP(temperature=0.8, top_k=40, top_p=0.95, min_p=0.05, seed=100 + i),
             lambda i: SP(repetition_penalty=1.2, presence_penalty=0.3, frequency_penalty=0.2),
             lambda i: SP(temperature=1.0, top_k=1),
             lambda i: SP(temperature=0.7, top_p=0.9, seed=200 + i),
             lambda i: SP(temperature=1.1, min_p=0.1, repetition_penalty=1.1))
    return [kinds[i % 6](i) for i in range(n)]


def on_device(tensors, device, what: str) -> None:
    """No fallback: every tensor of ``what`` lives on ``device``."""
    if any(t.device.type != device.type for t in tensors):
        raise RuntimeError(f"{what}: a tensor is not on {device.type}")


def slot_states(rows, prompts, vocab: int, device):
    from gptq_gguf_tpu_torch.serving import sampling

    st = sampling.init_state(len(rows), vocab, device=device)
    for i, sp in enumerate(rows):
        sampling.set_slot(st, i, sp, prompts[i].to(device), fallback_seed=i)
    return st


def top_p_edges(s: np.ndarray, top_p: float) -> np.ndarray:
    """Elements of one row of scaled logits whose exclusive cumulative mass
    (f64, sorted descending) lies within TOP_P_EDGE of top_p."""
    order = np.argsort(-s, kind="stable")
    e = np.exp(s[order].astype(np.float64) - s.max())
    p = e / e.sum()
    excl = np.cumsum(p) - p
    out = np.zeros(s.shape, bool)
    out[order] = np.abs(excl - top_p) <= TOP_P_EDGE
    return out


def draw_flips(toks_a, toks_b, noisy_b) -> tuple:
    """(explained, unexplained) token differences: a difference is explained
    when the row's noisy top-2 gap in ``noisy_b`` is below NOISY_TIE."""
    import torch

    diff = (toks_a.cpu() != toks_b.cpu()).nonzero().flatten().tolist()
    top2 = torch.topk(noisy_b.cpu(), 2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    near = sum(gaps[r] < NOISY_TIE for r in diff)
    return near, len(diff) - near


def phase_sampler(params, cfg, rng, device, card: str):
    """9a: the sampler chain on one B=8 decode step's logits, each row with
    its own settings, on the card and on the CPU: penalized logits within
    1e-6, masks equal but at the top_p edge (counted), SAMPLER_STEPS draws
    of every row equal but at noisy near-ties (counted), the draw counter
    shifted by one as a planted control that must fail; SAMPLER_DRAWS
    draws of one row against its masked softmax; the sampler's device ms
    per B=8 step."""
    import torch

    from gptq_gguf_tpu_torch.serving import engine, model as qmodel, sampling

    rows = sampler_rows()
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(8, 64)), device=device)
    cache = qmodel.init_cache(cfg, 8, 512, device=device)
    for b in range(8):
        _, _, cache = engine._prefill_slot(params, cfg, prompts[b:b + 1], cache, b)
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(8,)), dtype=torch.int32,
                           device=device)
    logits, _ = qmodel.forward_cached(params, cfg, feed[:, None], cache, fill_max=64)
    del cache
    ctx = torch.cat([prompts, feed[:, None].long()], 1)
    st = slot_states(rows, ctx, cfg.vocab_size, device)
    on_device(list(st) + [logits], device, "sampler state")
    cpu_logits = logits.cpu()
    cpu_st = slot_states(rows, ctx.cpu(), cfg.vocab_size, torch.device("cpu"))

    m_d, l_d, g_d = sampling._chain(logits, st)
    m_c, l_c, g_c = sampling._chain(cpu_logits, cpu_st)
    pen_err = ((l_d.cpu() - l_c).abs() / l_c.abs().clamp_min(1e-30)).max().item()
    if not pen_err <= 1e-6 or not torch.equal(g_d.cpu(), g_c):
        raise RuntimeError(f"sampler: penalized logits card vs CPU rel err {pen_err:.2e}")
    keep_d, keep_c = m_d.cpu() > F32_MIN, m_c > F32_MIN
    edges, kept = 0, []
    for i, sp in enumerate(rows):
        diff = (keep_d[i] != keep_c[i]).numpy()
        t = 1.0 if sp.is_greedy else sp.temperature
        if diff[~top_p_edges(l_c[i].numpy() / t, sp.top_p)].any():
            raise RuntimeError(f"sampler row {i}: card and CPU masks differ off the top_p edge")
        edges += int(diff.sum())
        kept.append(int(keep_d[i].sum()))

    def noisy(lg, s):
        m, _, _ = sampling._chain(lg, s)
        return m + sampling.gumbel_noise(s.seeds, s.draws, s.vocab_hash)

    near = bad = bad_ctl = 0
    for j in range(SAMPLER_STEPS):
        st.draws.fill_(j)
        cpu_st.draws.fill_(j)
        toks_d = sampling.sample(logits, st)
        toks_c = sampling.sample(cpu_logits, cpu_st)
        n, b = draw_flips(toks_d, toks_c, noisy(cpu_logits, cpu_st))
        near, bad = near + n, bad + b
        cpu_st.draws.fill_(j + 1)  # planted control: the next draw's noise
        bad_ctl += draw_flips(toks_d, sampling.sample(cpu_logits, cpu_st),
                              noisy(cpu_logits, cpu_st))[1]
    n_draws = SAMPLER_STEPS * len(rows)
    log(f"sampler (9a, {card}): {n_draws} draws card vs CPU: {bad} differ off a noisy "
        f"near-tie (< {NOISY_TIE}), {near} at one; masks differ at {edges} top_p-edge "
        f"elements (kept per row {kept}); penalized rel err {pen_err:.2e}; control "
        f"(draw counter + 1): {bad_ctl} differ")
    if bad:
        raise RuntimeError(f"sampler: {bad} card draws differ from the CPU's")
    if not bad_ctl:
        raise RuntimeError("sampler: the shifted draw counter passes the token check")

    # frequencies: SAMPLER_DRAWS draws of row 7 (top_k 20) on the card
    row, chunk = 7, 512
    one = sampling.SlotSampling(*(t if name == "vocab_hash" else
                                  t[row:row + 1].expand(chunk, *t.shape[1:]).clone()
                                  for name, t in zip(sampling.SlotSampling._fields, st)))
    counts = torch.zeros(cfg.vocab_size, dtype=torch.int64, device=device)
    for c in range(SAMPLER_DRAWS // chunk):
        one.draws.copy_(torch.arange(c * chunk, (c + 1) * chunk, device=device))
        toks = sampling.sample(logits[row:row + 1].expand(chunk, -1), one)
        counts += torch.bincount(toks.long(), minlength=cfg.vocab_size)
    m = m_d[row].double().cpu()
    p = torch.where(m > F32_MIN, torch.exp(m - m.max()), torch.zeros_like(m))
    p = (p / p.sum()).numpy()
    freq = counts.cpu().numpy() / SAMPLER_DRAWS
    bound = 5 * np.sqrt(p * (1 - p) / SAMPLER_DRAWS) + 1.0 / SAMPLER_DRAWS
    dev = np.abs(freq - p)
    log(f"sampler (9a): {SAMPLER_DRAWS} draws of row {row} ({int((p > 0).sum())} kept): "
        f"max |freq - p| {dev.max():.4f} (bound 5 sd + 1/N, its least {bound[p > 0].min():.4f}),"
        f" {int(counts.cpu()[torch.from_numpy(p == 0)].sum())} outside the mask")
    if freq[p == 0].sum() != 0 or not (dev <= bound).all():
        raise RuntimeError("sampler: draws do not follow the masked softmax")

    # device and host ms of the sampler's work in one B=8 step: ~100
    # launches a call, so only 5 calls fit the card's launch queue behind
    # the sleep (with more the host blocks and the events time its queueing)
    st2 = slot_states(rows, ctx, cfg.vocab_size, device)
    work = lambda: (sampling.count_tokens(st2, feed), sampling.sample_step(logits, st2))  # noqa: E731
    ms = cuda_ms(work, 5, sleep_cycles=1_000_000_000)
    host_ms = call_ms(work, 20)
    nbytes = logits.numel() * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"sampler (9a, {card}): {ms:.4f} device ms per B=8 step ({host_ms:.4f} host ms), "
        f"bound {bound_ms:.5f} ms ({nbytes} B: the logits read once)")
    return dict(draws=n_draws, near_ties=near, top_p_edges=edges, control_differ=bad_ctl,
                freq_max_dev=float(dev.max()), device_ms=ms, host_ms=host_ms,
                bound_ms=bound_ms, kept=kept)


def stream_gap(params, cfg, prompt, out, t, sp, device) -> float:
    """The top-2 gap, as a fraction of max|logit|, of what decides output
    position t of a request: the raw logits at the prefill's token of a
    greedy request, its penalized logits after; masked + noise (times the
    temperature: logit units) of a sampled one, at its draw t."""
    import torch

    from gptq_gguf_tpu_torch.serving import model as qmodel, sampling

    ids = torch.as_tensor(np.concatenate([np.asarray(prompt), np.asarray(out[:t], np.int64)]),
                          device=device)
    cache = qmodel.init_cache(cfg, 1, ids.numel() + 1, device=device)
    logits, _ = qmodel.forward_cached(params, cfg, ids[None], cache)
    st = sampling.init_state(1, cfg.vocab_size, device=device)
    sampling.set_slot(st, 0, sp, ids)
    st.draws.fill_(t)
    masked, pen, _ = sampling._chain(logits, st)
    if sp.is_greedy:
        row = logits[0] if t == 0 else pen[0]
    else:
        row = (masked + sampling.gumbel_noise(st.seeds, st.draws, st.vocab_hash))[0]
        row = row * sp.temperature
    top2 = torch.topk(row.float(), 2).values
    return float(top2[0] - top2[1]) / float(logits.abs().max())


def same_stream(params, cfg, request, sp, a, b, what, device) -> int:
    """Two runs' tokens of one request: equal, or apart from a first flip
    at a near-tie (stream_gap below NEAR_TIE). Returns tokens compared."""
    t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if len(a) != len(b):
        raise RuntimeError(f"{what}: {len(a)} vs {len(b)} tokens")
    if t is None:
        return len(a)
    gap = stream_gap(params, cfg, request[0], a, t, sp, device)
    log(f"  {what}: first flip at token {t}, top-2 gap {gap:.2e} of max|logit|")
    if not gap < NEAR_TIE:
        raise RuntimeError(f"{what}: tokens differ at {t}, gap {gap:.2e} is no near-tie")
    return t


def paged_sampled(params, cfg, requests, sps, device):
    """The paged engine on the mixed mix: budgets, token ranges, pages back,
    129 v2g launches per forward with every call of a B=8 step on the
    decode tile, one paged-kernel launch per layer and decode step."""
    import torch

    from gptq_gguf_tpu_torch.ops import paged_attention as pa
    from gptq_gguf_tpu_torch.serving import engine, paged

    eng = engine.PagedContinuousBatchingEngine(params, cfg, num_slots=8, max_len=PAGE * PPS,
                                               page_size=PAGE, device=device)
    on_device(list(eng.sampler), device, "paged sampler state")
    order = [eng.submit(p, max_new_tokens=n, sampling_params=sp)
             for (p, n), sp in zip(requests, sps)]
    shapes, decode = [], {"s": 0.0, "steps": 0}
    fwd0 = paged.forward_paged
    steps0 = {k: getattr(engine, k) for k in ("_paged_decode_step", "_paged_sampled_decode_step")}

    def counting(*a, **kw):
        shapes.append(tuple(a[2].shape))
        return fwd0(*a, **kw)

    def timed(fn):
        def step(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            decode["s"] += time.perf_counter() - t
            decode["steps"] += 1
            return out
        return step

    paged.forward_paged = counting
    for k, fn in steps0.items():
        setattr(engine, k, timed(fn))
    reset_matmul_counts()
    pa.paged_flash_decode.launches = pa.paged_flash_decode_q4.launches = 0
    try:
        done = {r.uid: r for r in eng.run_until_done()}
    finally:
        paged.forward_paged = fwd0
        for k, fn in steps0.items():
            setattr(engine, k, fn)
    counts, dmma = matmul_counts(), decode_counts()
    per = 4 * cfg.num_hidden_layers + 1
    want_dmma = want_decode({"v2g": per}, shapes, cfg.num_hidden_layers)
    if counts["v2g"] != per * len(shapes) or dmma != want_dmma:
        raise RuntimeError(f"paged sampled serving: v2g launches {counts['v2g']}, decode tile "
                           f"{dmma}; want {per} x {len(shapes)} forwards, {want_dmma}")
    if pa.paged_flash_decode.launches != cfg.num_hidden_layers * decode["steps"]:
        raise RuntimeError(f"paged sampled serving: {pa.paged_flash_decode.launches} paged "
                           f"kernel launches, {decode['steps']} decode steps")
    if eng.alloc.available != eng.cache.n_pages:
        raise RuntimeError("paged sampled serving: pages not returned")
    outs = [done[u].output for u in order]
    for (p, n), out in zip(requests, outs):
        if len(out) != n or not all(0 <= t < cfg.vocab_size for t in out):
            raise RuntimeError("paged sampled serving: budget or token range")
    ms = decode["s"] / decode["steps"] * 1e3
    gen = sum(map(len, outs))
    log(f"paged sampled serving: {decode['steps']} decode steps at {ms:.2f} ms/step, "
        f"{(gen - len(outs)) / decode['s']:.1f} generated tok/s; v2g {counts['v2g']} launches "
        f"({per} per forward, decode tile {dmma['v2g']}), paged kernel "
        f"{pa.paged_flash_decode.launches}")
    return outs, dict(decode_ms_per_step=ms, generated_tok_s=(gen - len(outs)) / decode["s"],
                      launches=counts["v2g"], decode_mma_launches=dmma["v2g"],
                      paged_launches=pa.paged_flash_decode.launches)


def phase_sampled_serving(params, cfg, requests, greedy, device, card: str):
    """9b: phase 3's 12 requests with mixed settings (mix_sampling) through
    the contiguous engine twice (k-step blocks; phase 3's launches per
    forward, every call of a B=8 step on v2g's decode tile) and the paged
    engine: every request repeats its tokens across the two runs; each
    seeded one equals itself served alone and on the paged engine up to a
    near-tie; top_k = 1 at temperature 1 gives the greedy reference's tokens."""
    from gptq_gguf_tpu_torch.serving import engine

    sps = mix_sampling(len(requests))
    runs = [phase_serving(params, cfg, requests, "v2g", label, sampling=sps, steady=False)[1]
            for label in ("sampled mix", "sampled mix again")]
    a, b = runs[0].pop("outputs"), runs[1].pop("outputs")
    if a != b:
        raise RuntimeError("sampled mix: a request's tokens differ between two runs")
    # greedy in the same call, after the sampled runs (the host-bound step
    # drifts between calls)
    after = phase_serving(params, cfg, requests, "v2g", "greedy after the sampled mix",
                          steady=False)[1]
    if after.pop("outputs") != greedy:
        raise RuntimeError("greedy mix: tokens differ from the greedy reference's")
    seeded = [i for i, sp in enumerate(sps) if sp.seed is not None]
    compared = {}
    for i in seeded:
        eng = engine.ContinuousBatchingEngine(params, cfg, num_slots=8, max_len=2048)
        on_device(list(eng.sampler), device, "sampler state")
        eng.submit(requests[i][0], max_new_tokens=requests[i][1], sampling_params=sps[i])
        alone = eng.run_until_done()[0].output
        compared[f"alone {i}"] = same_stream(params, cfg, requests[i], sps[i], alone, a[i],
                                             f"request {i} alone vs in the mix", device)
        del eng
    for i, sp in enumerate(sps):
        if sp.top_k == 1 and not sp.is_greedy:
            compared[f"top_k=1 {i}"] = same_stream(
                params, cfg, requests[i], sp.__class__(), a[i], greedy[i],
                f"request {i} top_k=1 at T=1 vs the greedy reference", device)
    p_outs, p_rec = paged_sampled(params, cfg, requests, sps, device)
    for i in seeded:
        compared[f"paged {i}"] = same_stream(params, cfg, requests[i], sps[i], p_outs[i], a[i],
                                             f"request {i} paged vs contiguous", device)
    r = runs[0]
    log(f"sampled serving (9b, {card}): {r['serve_decode_ms_per_step']:.2f} / "
        f"{runs[1]['serve_decode_ms_per_step']:.2f} ms per decode step, "
        f"{r['generated_tok_s']:.1f} / {runs[1]['generated_tok_s']:.1f} generated tok/s; "
        f"greedy after them {after['serve_decode_ms_per_step']:.2f} ms, "
        f"{after['generated_tok_s']:.1f} tok/s; tokens compared {compared}")
    return dict(runs=runs, greedy_after=after, paged=p_rec, compared=compared, seeded=seeded)


def params_to(v, dev):
    """Serving params (v2 weights, tensors) copied to ``dev``."""
    from gptq_gguf_tpu_torch.ops.qmatmul import RuntimeQuantLinearV2

    if isinstance(v, RuntimeQuantLinearV2):
        return RuntimeQuantLinearV2(*(None if t is None else t.to(dev)
                                      for t in (v.qs, v.d_sg, v.dmin_sg, v.sc_q, v.mn_q)),
                                    v.d_in, v.group_size, v.per_byte, v.shift, v.d_rep)
    if isinstance(v, dict):
        return {k: params_to(x, dev) for k, x in v.items()}
    if isinstance(v, list):
        return [params_to(x, dev) for x in v]
    return v.to(dev)


def cached_plain_v2g():
    """v2g's plain version (dequant_matmul_v2g_reference's arithmetic) with
    each weight's operand built once: the CPU plain path at 8B widths."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul

    ops = {}

    def mm(x, rql):
        if id(rql) not in ops:
            ops[id(rql)] = (qmatmul._v2_operand(rql, "v2g", torch.bfloat16)[0],
                            qmatmul._folded_planes_v2(rql)[1], rql)
        w, off2, _ = ops[id(rql)]
        x32 = x.float()
        M, d_in = x32.shape
        xsum = x32.reshape(M, d_in // rql.group_size, rql.group_size).sum(dim=-1)
        return x32.to(torch.bfloat16).float() @ w - xsum @ off2

    return mm


def phase_kv_quant(params, cfg, rng, requests, greedy, device, card: str):
    """9c: the int8 and int4 contiguous caches. 2-layer logits (a 128-token
    prefill and 4 decode steps) on the card against the CPU plain path
    (KV_CPU_LIMIT) and against the bf16 cache (KV_LOGIT_LIMIT); the
    contiguous int4 cache against the paged int4 kernel on the same inputs
    (phase 6's limit); phase 3's mix served in int8 and int4 (phase 3's
    launches per forward, the cache's bytes, ms/step)."""
    import torch

    from gptq_gguf_tpu_torch.ops import paged_attention as pa, qmatmul
    from gptq_gguf_tpu_torch.serving import engine, model as qmodel, paged

    p2 = {**params, "layers": params["layers"][:2]}
    c2 = dataclasses.replace(cfg, num_hidden_layers=2)
    prompt = rng.integers(0, cfg.vocab_size, size=(1, 128))
    feed = rng.integers(0, cfg.vocab_size, size=(4,))

    def logits_of(p, kv_dtype, dev, mm=None):
        fn0 = qmatmul.dequant_matmul
        if mm is not None:
            qmatmul.dequant_matmul = mm
        try:
            cache = qmodel.init_cache(c2, 1, 2048, kv_dtype=kv_dtype, device=dev)
            if kv_dtype is not None:
                on_device(list(cache.k) + list(cache.k_s), dev, f"{kv_dtype} cache")
            _, row, cache = engine._prefill_slot(p, c2, torch.as_tensor(prompt, device=dev),
                                                 cache, 0)
            rows = [row[None].float()]
            for tok in feed:
                lg, cache = qmodel.forward_cached(p, c2, torch.full((1, 1), int(tok),
                                                                    device=dev), cache)
                rows.append(lg.float())
            n = prompt.shape[1] + len(feed)
            codes = [b[:, :, :n].cpu() for b in cache.k + cache.v]
            return torch.cat(rows).cpu(), codes
        finally:
            qmatmul.dequant_matmul = fn0

    t = time.time()
    cpu = torch.device("cpu")
    pc = params_to(p2, cpu)
    plain = cached_plain_v2g()
    x = torch.randn(128, H, generator=torch.Generator().manual_seed(SEED)).to(torch.bfloat16)
    w0 = pc["layers"][0]["o_proj"]
    if not torch.equal(plain(x, w0), qmatmul.dequant_matmul_v2g_reference(x, w0)):
        raise RuntimeError("the cached CPU plain path is not v2g's plain version")
    bf16, _ = logits_of(p2, None, device)
    res = {}
    for kvd in KV_DTYPES:
        lk, ck = logits_of(p2, kvd, device)
        lc, cc = logits_of(pc, kvd, cpu, plain)
        scale = lc.abs().max().item()
        err = (lk - lc).abs().max().item()
        err_b = (lk - bf16).abs().max().item()
        agree = (lk.argmax(-1) == bf16.argmax(-1)).float().mean().item()
        n_diff = sum(int((a != b).sum()) for a, b in zip(ck, cc))
        n_codes = sum(a.numel() for a in ck)
        tol = KV_CPU_LIMIT[kvd] * scale
        log(f"kv {kvd} (9c, 2 layers, prefill 128 + 4 decode, {card}): card vs CPU plain "
            f"max|dlogit| {err:.3e} = {err / scale:.2e} of max|logit| (tol {tol:.3e}, "
            f"{KV_CPU_LIMIT[kvd]} of it; {n_diff} of {n_codes} code bytes differ); vs the bf16 "
            f"cache {err_b:.3e} = {err_b / scale:.2e} of max|logit| (limit "
            f"{KV_LOGIT_LIMIT[kvd]}); argmax agreement with bf16 {agree:.2f}")
        if not (torch.isfinite(lk).all() and err <= tol):
            raise RuntimeError(f"kv {kvd}: card and CPU plain logits disagree")
        if not err_b <= KV_LOGIT_LIMIT[kvd] * scale:
            raise RuntimeError(f"kv {kvd}: logits {err_b / scale:.2e} of max|logit| from bf16's")
        res[kvd] = dict(card_vs_cpu=err / scale, vs_bf16=err_b / scale, scale=scale,
                        codes_differ=n_diff, codes=n_codes)
    del pc, plain
    log(f"kv (9c): the CPU plain path and its checks took {time.time() - t:.1f} s")

    # contiguous int4 against the paged int4 kernel, phase 6's inputs' shape
    prompt2 = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 60)), device=device)
    feed2 = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 8)), device=device)
    table = torch.randperm(2 * PPS, device=device).to(torch.int32).reshape(2, PPS)
    pcache = paged.init_paged_cache(c2, 2, PAGE * PPS, PAGE, kv_dtype="int4", device=device)
    pcache = pcache._replace(page_table=table)
    ccache = qmodel.init_cache(c2, 2, PAGE * PPS, kv_dtype="int4", device=device)
    n0 = pa.paged_flash_decode_q4.launches
    pl, pcache = paged.forward_paged(p2, c2, prompt2, pcache)
    cl, ccache = qmodel.forward_cached(p2, c2, prompt2, ccache)
    prow, crow = [pl], [cl]
    for j in range(feed2.shape[1]):
        pl, pcache = paged.forward_paged(p2, c2, feed2[:, j:j + 1], pcache)
        cl, ccache = qmodel.forward_cached(p2, c2, feed2[:, j:j + 1], ccache)
        prow.append(pl)
        crow.append(cl)
    launched = pa.paged_flash_decode_q4.launches - n0
    a, b = torch.stack(prow), torch.stack(crow)
    scale = b.abs().max().item()
    err = (a - b).abs().max().item()
    log(f"kv int4 (9c): contiguous vs the paged int4 kernel ({launched} launches), 2 layers, "
        f"prefill 60 + 8 decode: max|dlogit| {err:.3e}, tol {3e-3 * scale:.3e} (3e-3 of "
        f"max|logit|)")
    if launched != 2 * 8 or not err <= 3e-3 * scale:
        raise RuntimeError("kv int4: the contiguous cache and the paged kernel disagree")
    res["int4_vs_paged"] = err / scale
    del pcache, ccache

    serve = {}
    for kvd in KV_DTYPES:
        _, rec = phase_serving(params, cfg, requests, "v2g", f"kv {kvd}",
                               engine_kw={"kv_quantized": kvd})
        outs = rec.pop("outputs")
        same = sum(x == y for o, g in zip(outs, greedy) for x, y in zip(o, g))
        want = KV_BYTES[kvd] * cfg.num_hidden_layers // N_LAYERS  # the cache of this depth
        if rec["kv_bytes"] != want:
            raise RuntimeError(f"kv {kvd}: {rec['kv_bytes']} B allocated, want {want}")
        log(f"kv {kvd} serving (9c, {card}): {rec['serve_decode_ms_per_step']:.2f} ms per "
            f"decode step, {rec['generated_tok_s']:.1f} generated tok/s, steady B=8 "
            f"{rec['decode_ms_per_step']:.2f} ms; KV {rec['kv_bytes']} B "
            f"(bf16 {KV_BYTES['bf16']}); {same} of {sum(map(len, greedy))} tokens as bf16's")
        serve[kvd] = dict(rec, tokens_as_bf16=same)
    return dict(logits=res, serving=serve)


def phase_sampled_http(params, cfg, device, card: str):
    """9d: a seeded sampled chat with n = 2 and logprobs over serve_http on
    port 0: two distinct choices, the same on a second call, each token's
    logprob the engine's own for the same request run directly."""
    import dataclasses as dc
    import urllib.request

    from gptq_gguf_tpu_torch.serving import engine, server
    from gptq_gguf_tpu_torch.serving.tokenizer import _BYTE_ENC, GGUFTokenizer

    vocab = [_BYTE_ENC[b] for b in range(256)] + [f"<t{i}>" for i in range(256, cfg.vocab_size)]
    tok = server.wrap_gguf_tokenizer(GGUFTokenizer("gpt2", vocab, merges=[],
                                                   chat_template=CHAT_TEMPLATE))
    payload = {"messages": [{"role": "user", "content": "Hello from the card."}], "n": 2,
               "temperature": 0.9, "top_k": 50, "top_p": 0.95, "seed": 1234,
               "max_tokens": 16, "logprobs": True, "top_logprobs": 2}
    prompt = tok(tok.apply_chat_template(payload["messages"], add_generation_prompt=True,
                                         tokenize=False))["input_ids"]
    sp = server._sampling_from_json(payload)
    eng = engine.ContinuousBatchingEngine(params, cfg, num_slots=8, max_len=2048)
    uids = [eng.submit(np.asarray(prompt), 16, sampling_params=dc.replace(sp, seed=1234 + i),
                       logprobs=2) for i in range(2)]
    direct = {r.uid: r for r in eng.run_until_done()}
    direct = [direct[u] for u in uids]
    eng.completed.clear()
    srv, runner = server.serve_http(eng, port=0, block=False, tokenizer=tok)
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def post():
        req = urllib.request.Request(f"{base}/v1/chat/completions",
                                     data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    try:
        t0 = time.perf_counter()
        first = post()
        wall = time.perf_counter() - t0
        again = post()
    finally:
        srv.shutdown()
        runner.stop()
    worst = 0.0
    for reply in (first, again):
        if [c["index"] for c in reply["choices"]] != [0, 1]:
            raise RuntimeError(f"HTTP chat: choices {reply['choices']}")
        for choice, req in zip(reply["choices"], direct):
            content = choice["logprobs"]["content"]
            if ([e["token"] for e in content] != [tok.decode([t]) for t in req.output]
                    or len(content) != 16):
                raise RuntimeError("HTTP chat: a choice's tokens are not the engine's")
            worst = max(worst, *(abs(e["logprob"] - d[0])
                                 for e, d in zip(content, req.logprob_data)))
    if worst > 1e-5:
        raise RuntimeError(f"HTTP chat: logprobs {worst:.2e} from the engine's")
    contents = [c["message"]["content"] for c in first["choices"]]
    if contents[0] == contents[1] or [c["message"]["content"] for c in again["choices"]] != contents:
        raise RuntimeError("HTTP chat: the seeded choices are not distinct and repeatable")
    log(f"sampled HTTP (9d, {card}): chat n=2 seeded, 16 tokens each in {wall:.2f} s; choices "
        f"distinct, repeated on a second call; logprobs within {worst:.1e} of the engine's")
    return dict(wall_s=wall, logprob_max_diff=worst)


def phase_sampling_and_kv(params, cfg, rng, requests, greedy, device):
    """Phase 9 (a)-(d) on phase 3's model."""
    import torch

    card = card_name_and_power()
    t9 = time.time()
    rec = dict(sampler=phase_sampler(params, cfg, rng, device, card))
    rec["serving"] = phase_sampled_serving(params, cfg, requests, greedy, device, card)
    torch.cuda.empty_cache()
    rec["kv"] = phase_kv_quant(params, cfg, rng, requests, greedy, device, card)
    torch.cuda.empty_cache()
    rec["http"] = phase_sampled_http(params, cfg, device, card)
    rec["seconds"] = time.time() - t9
    log(f"phase 9 took {rec['seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# Phase 5: GPTQ at full width
# ---------------------------------------------------------------------------

GPTQ_LAYERS = 2           # depth of the quantized checkpoint (every layer is the same work)
# the command line's documented calibration set: 262144 tokens in sequences
# of its default length, min(max_position_embeddings, 4096); at this size
# the capture takes the flash-attention branch and the activations (4 GiB)
# live in host memory between blocks
CALIB_TOKENS, CALIB_SEQ = 262144, 4096
EVAL_SEQ = 512  # the instrumented quantize run's --eval_sequence_length
BLOCK = 128               # the default GPTQ block
# (name, rows of one block solve, column blocks per 8B layer): q/k/v solved
# row-concatenated, o, gate/up row-concatenated, down over 14336 columns
SOLVE_SHAPES = (("qkv", 6144, 32), ("o", 4096, 32), ("gateup", 28672, 32), ("down", 4096, 112))
# (name, rows, block width) of the wide blocks held beside them: a block of
# 512 and the whole o-projection as one block (--static_groups
# --block_size 0), which the kernel runs 128 columns at a time
WIDE_SOLVES = (("o", 4096, 512), ("o", 4096, 4096))


def solve_cost(d_row: int, bs: int):
    """(bytes, f32 operations) one block solve needs: w, s, z read and q,
    err written once, U's block read once; per row and column i ten
    operations for q and err, two per later column for the update."""
    return 4 * (5 * d_row * bs + bs * bs), d_row * (10 * bs + bs * (bs - 1))


def solve_inputs(rng, U, d_row, qtype, device):
    """One block's w, U and per-column s / z: s / z from a K-quant fit of
    a w-like (d_row, max(256, bs)) draw, U (bs, bs) a diagonal block of a
    real factor."""
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import KQUANT_SPECS
    from gptq_gguf_tpu_torch.ops import kquant

    spec = KQUANT_SPECS[qtype]
    bs = U.shape[0]
    width = max(256, bs)
    x = torch.as_tensor(rng.normal(size=(d_row, width)) * 0.02, dtype=torch.float32,
                        device=device)
    s, z = kquant._expanded_scales(kquant.fit_supergroups(x, qtype), spec, width)
    return (x[:, :bs].contiguous(), U, s[:, :bs].contiguous(), z[:, :bs].contiguous(),
            spec.qmin, spec.qmax, 1e-9)


def solve_factor(rng, device):
    """The upper factor U (H, H) of a seeded SPD Hessian of an H-wide
    layer, factorized as the walk does."""
    import torch

    from gptq_gguf_tpu_torch.ops import gptq

    n = H
    X = torch.as_tensor(rng.normal(size=(2 * n, n)), dtype=torch.float32, device=device)
    X = X @ (torch.eye(n, device=device) + torch.as_tensor(
        rng.normal(size=(n, n)) / np.sqrt(n), dtype=torch.float32, device=device))
    hess = 2.0 * X.T @ X / X.shape[0]
    del X
    _, U_full, bad = gptq.prepare_hessian_inverse(hess, torch.ones(1, n, device=device), 1e-2,
                                                  method="device")
    if bad:
        raise RuntimeError("the seeded Hessian did not factorize")
    return U_full


def u_block(U_full, bs: int):
    """A (bs, bs) diagonal block of U_full: from a quarter in, or from the
    start where bs spans it."""
    n = U_full.shape[0]
    a = n // 4 if bs < n else 0
    return U_full[a:a + bs, a:a + bs].contiguous()


def phase_gptq_kernel(rng, device):
    """The block-solve kernel against its plain version at every 8B solve
    shape, for Q4_K, Q6_K and Q3_K, and at the wide blocks of WIDE_SOLVES
    for Q4_K and Q6_K: codes and err bit-equal."""
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.ops import gptq

    U_full = solve_factor(rng, device)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    recs = []
    cases = [(qtype, name, d_row, BLOCK, per_layer) for qtype in (T.Q4_K, T.Q6_K, T.Q3_K)
             for name, d_row, per_layer in SOLVE_SHAPES
             if qtype == T.Q4_K or name != "down"]  # down: the same kernel shape as o
    cases += [(qtype, name, d_row, bs, 0) for qtype in (T.Q4_K, T.Q6_K)
              for name, d_row, bs in WIDE_SOLVES]
    for qtype, name, d_row, bs, per_layer in cases:
        args = solve_inputs(rng, u_block(U_full, bs), d_row, qtype, device)
        qk, ek = gptq.solve_block(*args)
        qp, ep = gptq.solve_block_reference(*args)
        torch.cuda.synchronize()
        err = max((qk - qp).abs().max().item(), (ek - ep).abs().max().item())
        if not (torch.equal(qk, qp) and torch.equal(ek, ep)):
            raise RuntimeError(f"gptq_solve {name} {qtype.name}: kernel and plain differ "
                               f"(max |diff| {err:.3e})")
        nbytes, ops = solve_cost(d_row, bs)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
        rec = dict(name=name, qtype=qtype.name, d_row=d_row, bs=bs, per_layer=per_layer,
                   max_abs_err=err,
                   ms=cuda_ms(lambda: gptq.solve_block(*args), 20, flush_buf.zero_),
                   call_ms=call_ms(lambda: gptq.solve_block(*args), 20),
                   plain_ms=cuda_ms(lambda: gptq.solve_block_reference(*args), 1,
                                    flush_buf.zero_),
                   bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        recs.append(rec)
        log(f"  gptq_solve {name:>6} {qtype.name} ({d_row}x{bs}) bit-equal; kernel "
            f"{rec['ms']:.4f} ms (call {rec['call_ms']:.4f})  plain {rec['plain_ms']:.2f} ms"
            f"  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: {nbytes} B, {ops:.3e} ops)")
    return recs


def write_checkpoint(path: Path, device) -> None:
    """A seeded Llama-3-8B-width llama checkpoint of GPTQ_LAYERS layers,
    bf16 weights of std 0.02, as config.json plus one safetensors file."""
    import torch

    from gptq_gguf_tpu_torch.formats import safetensors

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(torch.bfloat16).cpu()

    ones = torch.ones(H, dtype=torch.bfloat16)
    t = {"model.embed_tokens.weight": rnd(V, H), "model.norm.weight": ones,
         "lm_head.weight": rnd(V, H)}
    for i in range(GPTQ_LAYERS):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": ones, p + "post_attention_layernorm.weight": ones,
                  p + "self_attn.q_proj.weight": rnd(N_HEAD * HD, H),
                  p + "self_attn.k_proj.weight": rnd(N_KV * HD, H),
                  p + "self_attn.v_proj.weight": rnd(N_KV * HD, H),
                  p + "self_attn.o_proj.weight": rnd(H, N_HEAD * HD),
                  p + "mlp.gate_proj.weight": rnd(I, H), p + "mlp.up_proj.weight": rnd(I, H),
                  p + "mlp.down_proj.weight": rnd(H, I)})
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(dict(
        model_type="llama", vocab_size=V, hidden_size=H, intermediate_size=I,
        num_hidden_layers=GPTQ_LAYERS, num_attention_heads=N_HEAD, num_key_value_heads=N_KV,
        head_dim=HD, rope_theta=500000.0, rms_norm_eps=1e-5, max_position_embeddings=8192,
        tie_word_embeddings=False, torch_dtype="bfloat16")))
    safetensors.write_safetensors(t, path / "model.safetensors")


def h_objective(D, Hm) -> float:
    """tr(D H D^T), summed in f64 (D: (rows, d_col), H: (d_col, d_col))."""
    import torch

    return float(((D @ Hm) * D).sum(dtype=torch.float64))


def quantize_argv(ckpt: Path, save: Path, device, profile: bool):
    """The user's quantize command line; the instrumented run also profiles
    its stages and scores the quantized model (--eval_perplexity, 100
    sequences of EVAL_SEQ tokens)."""
    argv = ["quantize", "--model_name_or_path", str(ckpt), "--calibration_data", "synthetic",
            "--calibration_tokens", str(CALIB_TOKENS), "--calibration_sequence_length",
            str(CALIB_SEQ), "--default_bit_width", "Q4_K", "--save_dir", str(save),
            "--device", str(device)]
    return argv + ["--stage-profile", "--eval_perplexity", "--eval_sequence_length",
                   str(EVAL_SEQ)] if profile else argv


def phase_gptq_quantize(tmp: Path, device):
    """The quantize command line at Llama-3-8B width, 2 layers, twice. The
    first run is the user's (no stage profile, no timers): seconds per
    layer, kernel launches, artifacts, GPTQ against RTN on every linear.
    The second is instrumented: stage breakdown, refit and factorization."""
    import torch

    from gptq_gguf_tpu_torch.__main__ import main as port_main
    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.ops import gptq, kquant
    from gptq_gguf_tpu_torch.quant import artifacts

    t = time.time()
    ckpt = tmp / "ckpt"
    write_checkpoint(ckpt, device)
    log(f"checkpoint: {GPTQ_LAYERS} layers at Llama-3-8B width written in {time.time() - t:.1f} s")
    per_layer_launches = sum(n for _, _, n in SOLVE_SHAPES)

    def run_quantize(save, profile):
        gptq.solve_block.launches = 0
        t = time.perf_counter()
        lines = run_cli(quantize_argv(ckpt, save, device, profile))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = gptq.solve_block.launches
        if launches != per_layer_launches * GPTQ_LAYERS:
            raise RuntimeError(f"{launches} solve-kernel launches, want "
                               f"{per_layer_launches} x {GPTQ_LAYERS}")
        return launches, wall, json.loads((save / "stage_timings.json").read_text()), lines

    # run 1, as a user runs it; each solve's inputs are recorded by
    # reference only (no copy, no wait for the card)
    solves = []
    solve0 = gptq.gptq_quantize_matrix

    def recording_solve(W, Hm, qtype, *a, **kw):
        solves.append((W, Hm, qtype))
        return solve0(W, Hm, qtype, *a, **kw)

    save = tmp / "layers"
    gptq.gptq_quantize_matrix = recording_solve
    try:
        launches, wall, timings, _ = run_quantize(save, profile=False)
    finally:
        gptq.gptq_quantize_matrix = solve0
    s_layer = timings["quantize"] / GPTQ_LAYERS
    log(f"quantize ({CALIB_TOKENS} tokens in sequences of {CALIB_SEQ}): {GPTQ_LAYERS} layers, "
        f"command {wall:.2f} s, walk {timings['quantize']:.2f} s = {s_layer:.2f} s/layer; "
        f"{launches} solve-kernel launches")

    # run 2, instrumented: stage ends synchronised (--stage-profile) and
    # each refit and factorization timed between two synchronisations
    timers = {"refit": 0.0, "factorize": 0.0}
    fit0, fact0 = gptq.kquant.fit_supergroups, gptq.factorize_hinv_cholesky

    def timed(key, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timers[key] += time.perf_counter() - t0
            return out
        return call

    gptq.kquant.fit_supergroups = timed("refit", fit0)
    gptq.factorize_hinv_cholesky = timed("factorize", fact0)
    try:
        _, wall_p, timings_p, lines = run_quantize(tmp / "layers_profiled", profile=True)
    finally:
        gptq.kquant.fit_supergroups, gptq.factorize_hinv_cholesky = fit0, fact0
    stages = {k.split("/", 1)[1]: v for k, v in timings_p.items() if k.startswith("quantize/")}
    log(f"  instrumented run: walk {timings_p['quantize']:.2f} s = "
        f"{timings_p['quantize'] / GPTQ_LAYERS:.2f} s/layer; stages (s): "
        f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}; inside factorize_solve: "
        f"refit {timers['refit']:.3f}, factorize {timers['factorize']:.3f}")
    ppl_q = [float(x.rsplit(":", 1)[1]) for x in lines if x.startswith("synthetic perplexity:")]
    if len(ppl_q) != 1 or not math.isfinite(ppl_q[0]):
        raise RuntimeError(f"quantize --eval_perplexity printed {ppl_q}")
    log(f"  --eval_perplexity: {ppl_q[0]:.4f} on 100 x {EVAL_SEQ} synthetic tokens in "
        f"{timings_p['eval_perplexity']:.2f} s (card {card_name_and_power()})")

    # 14 artifacts with the JAX names, shapes and dtypes
    want = {"q_proj": (N_HEAD * HD, H), "k_proj": (N_KV * HD, H), "v_proj": (N_KV * HD, H),
            "o_proj": (H, N_HEAD * HD), "gate_proj": (I, H), "up_proj": (I, H),
            "down_proj": (H, I)}
    names = sorted(artifacts.list_layers(save))
    expect = sorted(f"model.layers.{i}.{'self_attn' if k[0] in 'qkvo' else 'mlp'}.{k}"
                    for i in range(GPTQ_LAYERS) for k in want)
    if names != expect:
        raise RuntimeError(f"artifacts {names} != {expect}")
    arts = {}
    for name in names:
        art = artifacts.load_layer(save, name)
        d_row, d_col = want[name.split(".")[-1]]
        shapes = {"qweight": ((d_row, d_col), np.uint8),
                  "super_group_scale": ((d_row, d_col // 256), np.float16),
                  "super_group_zero": ((d_row, d_col // 256), np.float16),
                  "group_scale_quant": ((d_row, d_col // 32), np.uint8),
                  "group_zero_quant": ((d_row, d_col // 32), np.uint8)}
        for f, (shape, dt) in shapes.items():
            a = getattr(art, f)
            if a.shape != shape or a.dtype != dt:
                raise RuntimeError(f"{name}.{f}: {a.shape} {a.dtype}, want {shape} {dt}")
        if art.q_type != T.Q4_K:
            raise RuntimeError(f"{name}: {art.q_type}")
        arts[name] = art

    # GPTQ at or below RTN in the H-weighted objective, on every linear
    order = [("q_proj", "k_proj", "v_proj"), ("o_proj",), ("gate_proj", "up_proj"),
             ("down_proj",)]
    if len(solves) != len(order) * GPTQ_LAYERS:
        raise RuntimeError(f"{len(solves)} solves recorded")
    objectives = {}
    for j, (W, Hm, qtype) in enumerate(solves):
        li, keys = j // len(order), order[j % len(order)]
        row = 0
        for key in keys:
            name = f"model.layers.{li}.{'self_attn' if key[0] in 'qkvo' else 'mlp'}.{key}"
            Wk = W[row:row + want[key][0]]
            row += want[key][0]
            w_gptq = arts[name].dequantize(device)
            w_rtn = kquant.dequantize_rtn(Wk, qtype)
            o_g, o_r = h_objective(Wk - w_gptq, Hm), h_objective(Wk - w_rtn, Hm)
            objectives[name] = (o_g, o_r)
            if not o_g <= o_r:
                raise RuntimeError(f"{name}: GPTQ objective {o_g:.6e} above RTN's {o_r:.6e}")
    worst = max(o_g / o_r for o_g, o_r in objectives.values())
    log(f"  GPTQ/RTN objective <= {worst:.4f} on all {len(objectives)} linears")
    record = dict(layers=GPTQ_LAYERS, calibration_tokens=CALIB_TOKENS,
                  sequence_length=CALIB_SEQ, wall_s=wall, s_per_layer=s_layer,
                  launches=launches, instrumented=dict(
                      wall_s=wall_p, s_per_layer=timings_p["quantize"] / GPTQ_LAYERS,
                      stages=stages, refit_s=timers["refit"], factorize_s=timers["factorize"],
                      eval_perplexity=ppl_q[0], eval_perplexity_s=timings_p["eval_perplexity"]),
                  worst_gptq_over_rtn=worst,
                  objectives={k: list(v) for k, v in objectives.items()})
    return launches, record, solves, arts


def phase_gptq_whole_solve(solves, device):
    """gptq_quantize_matrix on layer 0's o-projection with its captured
    Hessian, through the kernel and through the plain version."""
    import torch

    from gptq_gguf_tpu_torch.ops import gptq, kquant

    W, Hm, qtype = solves[1]
    runs = {}
    for label, fn in (("kernel", gptq.solve_block), ("plain", gptq.solve_block_reference)):
        solve0 = gptq.solve_block
        gptq.solve_block = fn
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = gptq.gptq_quantize_matrix(W, Hm, qtype, device=device)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        finally:
            gptq.solve_block = solve0
        obj = h_objective(W - kquant.dequantize(res.qweight, res.params, qtype), Hm)
        runs[label] = (res, secs, obj)
    (rk, sk, ok), (rp, sp, op) = runs["kernel"], runs["plain"]
    agree = (rk.qweight == rp.qweight).float().mean().item()
    rel = abs(ok - op) / op
    log(f"whole o-projection solve ({H}x{N_HEAD * HD}): kernel {sk:.3f} s, plain {sp:.3f} s; codes "
        f"agree {agree:.6f}, objective {ok:.6e} vs {op:.6e} (rel {rel:.2e})")
    if agree < 0.9999 or rel > 1e-4:
        raise RuntimeError("whole solve: kernel and plain disagree")
    return dict(kernel_s=sk, plain_s=sp, code_agreement=agree, objective_rel_diff=rel)


STATIC_CALIB_TOKENS = 16384  # the static-groups run's calibration set: four sequences


def phase_gptq_static_groups(tmp: Path, solves, device):
    """--static_groups --block_size 0: every linear is one block of all its
    columns, which the kernel takes 128 at a time. The command line on the
    2-layer checkpoint (one launch per solve, 14 artifacts), then layer 0's
    o and down projections (4096 and 14336 columns) through
    gptq_quantize_matrix, kernel against plain: codes and params bit-equal."""
    import torch

    from gptq_gguf_tpu_torch.__main__ import main as port_main
    from gptq_gguf_tpu_torch.ops import gptq
    from gptq_gguf_tpu_torch.quant import artifacts

    save = tmp / "layers_static"
    argv = quantize_argv(tmp / "ckpt", save, device, profile=False)
    argv[argv.index("--calibration_tokens") + 1] = str(STATIC_CALIB_TOKENS)
    gptq.solve_block.launches = 0
    t = time.perf_counter()
    port_main(argv + ["--static_groups", "--block_size", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches, n_art = gptq.solve_block.launches, len(artifacts.list_layers(save))
    log(f"quantize --static_groups --block_size 0 ({STATIC_CALIB_TOKENS} tokens): {wall:.2f} s, "
        f"{launches} solve-kernel launches, {n_art} artifacts")
    if launches != 4 * GPTQ_LAYERS or n_art != 7 * GPTQ_LAYERS:
        raise RuntimeError(f"{launches} launches (want {4 * GPTQ_LAYERS}: q/k/v, o, gate/up and "
                           f"down one block each), {n_art} artifacts")
    cfg = gptq.GPTQConfig(static_groups=True, block_size=0)
    rec = dict(wall_s=wall, launches=launches)
    for j, label in ((1, "o"), (3, "down")):
        W, Hm, qtype = solves[j]
        runs = {}
        for route, fn in (("kernel", gptq.solve_block), ("plain", gptq.solve_block_reference)):
            solve0 = gptq.solve_block
            gptq.solve_block = fn
            try:
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = gptq.gptq_quantize_matrix(W, Hm, qtype, cfg, device=device)
                torch.cuda.synchronize()
                runs[route] = (res, time.perf_counter() - t)
            finally:
                gptq.solve_block = solve0
        (rk, sk), (rp, sp) = runs["kernel"], runs["plain"]
        same = torch.equal(rk.qweight, rp.qweight) and all(
            torch.equal(a, b) for a, b in zip(rk.params, rp.params))
        log(f"  whole {label} solve as one block of {W.shape[1]} columns: kernel {sk:.3f} s, "
            f"plain {sp:.3f} s; codes and params bit-equal: {same}")
        if not same:
            raise RuntimeError(f"static groups, block_size 0, {label}: kernel and plain differ")
        rec[label] = dict(columns=W.shape[1], kernel_s=sk, plain_s=sp)
    return rec


def phase_gptq_to_serving(arts, device):
    """Each artifact packed into the v2 serving format: its dequantization
    equals the artifact's bit for bit; one v2g call on the fused gate/up."""
    import torch

    from gptq_gguf_tpu_torch.ops import kquant, qmatmul

    packed = {}
    for name, art in arts.items():
        rql = qmatmul.pack_runtime_v2(art.qweight, art.params(), art.q_type, device=device)
        if not torch.equal(qmatmul.dequantize_runtime_v2(rql), art.dequantize(device)):
            raise RuntimeError(f"{name}: v2 dequantization differs from the artifact's")
        packed[name] = rql
    gateup = qmatmul.fuse_rql_v2([packed["model.layers.0.mlp.gate_proj"],
                                  packed["model.layers.0.mlp.up_proj"]])
    x = (torch.randn(8, H, device=device) * 0.5).to(torch.bfloat16)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    rec = kernel_case(f"GPTQ gate/up {H}->{2 * I}", x, gateup, flush_buf.zero_)
    log(f"serving bridge: {len(packed)} artifacts packed to v2, dequantization bit-equal; "
        f"v2g on the GPTQ gate/up within tolerance")
    return rec

# ---------------------------------------------------------------------------
# Phase 6: paged serving at full width
# ---------------------------------------------------------------------------

PAGE, PPS, POOL_PAGES = 64, 32, 256  # 8 slots x 2048 positions, fully provisioned
PAGED_LENGTHS = (0, 5, 63, 64, 300, 1000, 1500, 2047)
STEADY_FILLS = (300, 1900)   # uniform fills of the timed steps; the first is the summary's
SERVE_MIX = (100, 301, 32, 65)  # phase 3's prompt lengths and budgets, [lo, hi)
HTTP_MIX = (50, 151, 16, 17)


def paged_pools(q4: bool, device):
    """Random K / V pools of POOL_PAGES + 1 pages at the 8B attention shape:
    bf16, or int4 in the combined layout (quantized by the port)."""
    import torch

    from gptq_gguf_tpu_torch.serving import model as qmodel

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    shape = (POOL_PAGES + 1, N_KV, PAGE, HD)
    k = torch.randn(shape, generator=gen, device=device) * 0.3
    v = torch.randn(shape, generator=gen, device=device)
    if not q4:
        return k.to(torch.bfloat16), v.to(torch.bfloat16)
    kq, ks = qmodel._quantize_kv_q4(k)
    vq, vs = qmodel._quantize_kv_q4(v)
    return torch.cat([kq, vq], -1), torch.cat([ks, vs], -1).transpose(2, 3).contiguous()


def paged_table(rng, lengths, device):
    """Each slot's live pages from one permutation of the pool; -1 after."""
    import torch

    order = rng.permutation(POOL_PAGES)
    table = np.full((len(lengths), PPS), -1, np.int32)
    used = 0
    for b, length in enumerate(lengths):
        live = length // PAGE + 1
        table[b, :live] = order[used:used + live]
        used += live
    return torch.as_tensor(table, device=device)


def paged_cost(lengths, q4: bool, window: int = 0):
    """(bytes, f32 operations) one call must spend: each attended position's
    K and V (or codes and group scales) of every kv head read once, the
    table entries of the pages it reads, q and lengths read and the f32
    output written once; ~4 hd operations per (query head, attended
    position): q.k, p.v and the softmax."""
    per_pos = HD + 2 * (HD // 32) * 4 if q4 else 2 * HD * 2
    pages = positions = 0
    for length in lengths:
        lo = max(length - window + 1, 0) if window else 0
        pages += length // PAGE + 1 - lo // PAGE
        positions += length + 1 - lo
    n = len(lengths)
    nbytes = positions * N_KV * per_pos + 2 * n * N_HEAD * HD * 4 + pages * 4 + n * 4
    return nbytes, 4.0 * HD * N_HEAD * positions


def paged_times(fn, ref, kp, vp, q, fills, q4: bool, rng, flush, reps: int = 50):
    """Kernel (``fn``), plain (``ref``) and library ms per call over
    len(fills) slots at those lengths, with the call's bytes and operations
    and its bound. The library yardstick is one SDPA call over the live
    K / V already gathered contiguous (int4 dequantized first) in bf16,
    masked past each slot's length where the lengths differ; the port never
    calls it."""
    import torch
    import torch.nn.functional as F

    from gptq_gguf_tpu_torch.models.llama import dequant_kv_q4
    from gptq_gguf_tpu_torch.ops import paged_attention as pa

    device = q.device
    B = len(fills)
    ln = torch.as_tensor(fills, dtype=torch.int32, device=device)
    tb = paged_table(rng, fills, device)
    qq = q[:B].contiguous()
    args = (qq, kp, vp, tb, ln)
    scale = HD ** -0.5
    ms = cuda_ms(lambda: fn(*args, scale=scale), reps, flush)
    plain_ms = cuda_ms(lambda: ref(*args, scale=scale), 5, flush)
    L = max(fills) + 1
    if q4:
        hd2, ng = HD // 2, HD // 32
        codes = pa._gather_slot_kv(kp, tb)[:, :, :L]
        scl = pa._gather_slot_scales_t(vp, tb)[:, :, :L]
        k_l = dequant_kv_q4(codes[..., :hd2], scl[..., :ng]).to(torch.bfloat16)
        v_l = dequant_kv_q4(codes[..., hd2:], scl[..., ng:]).to(torch.bfloat16)
    else:
        k_l = pa._gather_slot_kv(kp, tb)[:, :, :L].contiguous()
        v_l = pa._gather_slot_kv(vp, tb)[:, :, :L].contiguous()
    q_l = qq.reshape(B, N_HEAD, 1, HD).to(torch.bfloat16)
    mask = None
    if len(set(fills)) > 1:
        mask = (torch.arange(L, device=device)[None, :] <= ln[:, None].long())[:, None, None]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q_l, k_l, v_l, attn_mask=mask, scale=scale, enable_gqa=True), reps, flush)
    nbytes, ops = paged_cost(fills, q4)
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    return dict(fill=fills[0] if mask is None else "mixed", ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bytes=nbytes, ops=ops, bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


def phase_paged_kernels(rng, device):
    """Both paged decode kernels against their plain versions at the 8B
    attention shape, at mixed lengths with -1 past the live pages (plain,
    window 48, sinks, softcap 30), then timed at the uniform STEADY_FILLS."""
    import torch

    from gptq_gguf_tpu_torch.ops import paged_attention as pa

    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    q = torch.randn(len(PAGED_LENGTHS), N_KV, N_HEAD // N_KV, HD, device=device)
    sinks = torch.randn(N_HEAD, device=device)
    scale = HD ** -0.5
    cases = [("plain", {}), ("window 48", {"window": 48}), ("sinks", {"sinks": sinks}),
             ("softcap 30", {"softcap": 30.0})]
    recs = {}
    for q4 in (False, True):
        name = "paged_flash_decode_q4" if q4 else "paged_flash_decode"
        fn = pa.paged_flash_decode_q4 if q4 else pa.paged_flash_decode
        ref = pa.paged_flash_decode_q4_reference if q4 else pa.paged_flash_decode_reference
        kp, vp = paged_pools(q4, device)
        lengths = torch.as_tensor(PAGED_LENGTHS, dtype=torch.int32, device=device)
        table = paged_table(rng, PAGED_LENGTHS, device)
        errs = []
        for label, kw in cases:
            got = fn(q, kp, vp, table, lengths, scale=scale, **kw)
            want = ref(q, kp, vp, table, lengths, scale=scale, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{name} {label}: output is not finite")
            # tolerance: kernel and plain version sum the same f32 terms in
            # another order, with exp / tanh from other libraries
            err = (got - want).abs().max().item()
            tol = 1e-4 * want.abs().max().item()
            log(f"  {name:>22} {label:>10}: max|err| {err:.3e} (tol {tol:.3e}: f32 sums in "
                f"another order)")
            if not err <= tol:
                raise RuntimeError(f"{name} {label}: kernel vs plain {err:.3e} > {tol:.3e}")
            errs.append(err)

        steady = {fill: paged_times(fn, ref, kp, vp, q, [fill] * 8, q4, rng, flush_buf.zero_)
                  for fill in STEADY_FILLS}
        for r in steady.values():
            log(f"  {name:>22} B=8 fill {r['fill']}: kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.3f} ms  library {r['library_ms']:.4f} ms  bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes']} B, {r['ops']:.3e} ops)")
        recs[name] = dict(max_abs_err=max(errs), steady=steady)
        del kp, vp
    return recs


def phase_paged_consistency(params, cfg, rng, device):
    """2 layers at full width: a 60-token prefill and 8 decode steps across
    the page boundary; paged through the kernels against paged through
    their plain versions (bf16 and int4), paged bf16 against the
    contiguous cache."""
    import torch

    from gptq_gguf_tpu_torch.ops import paged_attention as pa
    from gptq_gguf_tpu_torch.serving import model as qmodel, paged

    p2 = {**params, "layers": params["layers"][:2]}
    c2 = dataclasses.replace(cfg, num_hidden_layers=2)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 60)), device=device)
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 8)), device=device)
    table = torch.randperm(2 * PPS, device=device).to(torch.int32).reshape(2, PPS)

    plain_fns = {"paged_flash_decode": pa.paged_flash_decode_reference,
                 "paged_flash_decode_q4": pa.paged_flash_decode_q4_reference}

    def drop_last_chunk(q, kp, vp, table, lengths, **kw):
        """Planted fault: the plain version without the last live chunk of
        32 positions (the kernel's chunk), the query's own among them."""
        return pa.paged_flash_decode_reference(q, kp, vp, table, lengths // 32 * 32 - 1, **kw)

    def run_paged(kv_dtype, swap):
        saved = {k: getattr(pa, k) for k in swap}
        for k, fn in swap.items():
            setattr(pa, k, fn)
        try:
            cache = paged.init_paged_cache(c2, 2, PAGE * PPS, PAGE, kv_dtype=kv_dtype,
                                           device=device)
            cache = cache._replace(page_table=table)
            rows = []
            logits, cache = paged.forward_paged(p2, c2, prompt, cache)
            rows.append(logits)
            for j in range(feed.shape[1]):
                logits, cache = paged.forward_paged(p2, c2, feed[:, j:j + 1], cache)
                rows.append(logits)
            return torch.stack(rows)
        finally:
            for k, fn in saved.items():
                setattr(pa, k, fn)

    def run_contiguous():
        cache = qmodel.init_cache(c2, 2, PAGE * PPS, device=device)
        rows = []
        logits, cache = qmodel.forward_cached(p2, c2, prompt, cache)
        rows.append(logits)
        for j in range(feed.shape[1]):
            logits, cache = qmodel.forward_cached(p2, c2, feed[:, j:j + 1], cache)
            rows.append(logits)
        return torch.stack(rows)

    n0 = pa.paged_flash_decode.launches, pa.paged_flash_decode_q4.launches
    bf16 = run_paged(None, {})
    pairs = {"bf16 kernel vs plain": (bf16, run_paged(None, plain_fns)),
             "int4 kernel vs plain": (run_paged("int4", {}), run_paged("int4", plain_fns)),
             "bf16 paged vs contiguous": (bf16, run_contiguous())}
    launched = (pa.paged_flash_decode.launches - n0[0], pa.paged_flash_decode_q4.launches - n0[1])
    if launched != (2 * 8, 2 * 8):
        raise RuntimeError(f"paged kernel launches {launched}, want 16 of each")
    # the control: a decode attention that skips its last live chunk must
    # come out as not correct under the same limit
    pairs["bf16 kernel vs planted fault (control)"] = (
        bf16, run_paged(None, {"paged_flash_decode": drop_last_chunk}))
    for label, (a, b) in pairs.items():
        # tolerance as phase 4: f32 sum order, turned into rare bf16 flips
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        log(f"paged consistency ({label}, 2 layers, prefill 60 + 8 decode): max|dlogit| "
            f"{err:.3e}, tol {3e-3 * scale:.3e} (3e-3 of max|logit|); argmax agreement "
            f"{agree:.2f}")
        correct = bool(torch.isfinite(a).all()) and err <= 3e-3 * scale
        if correct == label.endswith("(control)"):
            raise RuntimeError(f"paged consistency {label}: "
                               + ("the planted fault passes" if correct else "logits disagree"))


def serve_requests(rng, cfg, n, lo, hi, budget_lo, budget_hi):
    return [(rng.integers(0, cfg.vocab_size, size=int(rng.integers(lo, hi))),
             int(rng.integers(budget_lo, budget_hi))) for _ in range(n)]


def phase_paged_serving(params, cfg, rng, device):
    """PagedContinuousBatchingEngine(num_slots=8, max_len=2048, page 64) at
    full width on phase 3's request mix: bf16, int4, and bf16 on an
    oversubscribed 24-page pool. Returns each run's kernel launches and the
    bf16 engine (idle) for the steady-step and HTTP checks."""
    import torch

    from gptq_gguf_tpu_torch.ops import paged_attention as pa
    from gptq_gguf_tpu_torch.serving import engine

    requests = serve_requests(rng, cfg, 12, *SERVE_MIX)
    step0 = engine._paged_decode_step
    runs, keep = {}, None
    for label, kw in (("bf16", {}), ("int4", {"kv_quantized": "int4"}),
                      ("bf16, 24-page pool", {"n_pages": 24})):
        eng = engine.PagedContinuousBatchingEngine(params, cfg, num_slots=8, max_len=PAGE * PPS,
                                                   page_size=PAGE, device=device, **kw)
        uids = {eng.submit(p, max_new_tokens=n): n for p, n in requests}
        decode = {"s": 0.0, "steps": 0}

        def timed_step(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step0(*a, **k)
            torch.cuda.synchronize()
            decode["s"] += time.perf_counter() - t
            decode["steps"] += 1
            return out

        engine._paged_decode_step = timed_step
        pa.paged_flash_decode.launches = pa.paged_flash_decode_q4.launches = 0
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = eng.run_until_done()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            engine._paged_decode_step = step0
        launches = (pa.paged_flash_decode.launches, pa.paged_flash_decode_q4.launches)
        q4 = "kv_quantized" in kw
        if len(done) != 12 or {r.uid for r in done} != set(uids):
            raise RuntimeError(f"paged {label}: served {len(done)} of 12 requests")
        for r in done:
            if len(r.output) != uids[r.uid] or r.finish_reason != "length":
                raise RuntimeError(f"paged {label} request {r.uid}: {len(r.output)} tokens, "
                                   f"budget {uids[r.uid]}, {r.finish_reason}")
            if not all(0 <= t < cfg.vocab_size for t in r.output):
                raise RuntimeError(f"paged {label} request {r.uid}: token id out of range")
        if eng.alloc.available != eng.cache.n_pages:
            raise RuntimeError(f"paged {label}: {eng.alloc.available} of "
                               f"{eng.cache.n_pages} pages back in the pool")
        want = (0, cfg.num_hidden_layers * decode["steps"]) if q4 else \
            (cfg.num_hidden_layers * decode["steps"], 0)
        if decode["steps"] == 0 or launches != want:
            raise RuntimeError(f"paged {label}: kernel launches {launches}, want {want} "
                               f"({decode['steps']} decode forwards)")
        gen_tokens = sum(len(r.output) for r in done)
        ms = decode["s"] / decode["steps"] * 1e3
        log(f"paged serving ({label}): 12 requests, {gen_tokens} tokens in {wall:.2f} s; "
            f"{decode['steps']} decode steps at {ms:.2f} ms/step, "
            f"{(gen_tokens - 12) / decode['s']:.1f} generated tok/s; "
            f"{max(launches)} paged-kernel launches ({cfg.num_hidden_layers} per step); "
            f"all {eng.cache.n_pages} pages returned")
        runs[label] = dict(wall_s=wall, decode_steps=decode["steps"], decode_ms_per_step=ms,
                           decode_tok_s=(gen_tokens - 12) / decode["s"],
                           launches=max(launches), n_pages=eng.cache.n_pages)
        if keep is None:
            keep = eng
        else:
            del eng
            torch.cuda.empty_cache()
    return runs, keep


def phase_paged_steady(eng, cfg, device):
    """A steady B = 8 decode step of the paged engine with every slot live
    at fill 300 and at fill 1900 (a fully provisioned table), and the bf16
    kernel's device time per step at that fill. Leaves the engine idle."""
    import torch

    from gptq_gguf_tpu_torch.ops import paged_attention as pa
    from gptq_gguf_tpu_torch.serving import engine

    cache = eng.cache
    cache.page_table.copy_(torch.arange(8 * PPS, dtype=torch.int32, device=device).reshape(8, PPS))
    tokens = torch.randint(0, cfg.vocab_size, (8,), device=device, dtype=torch.int32)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    out = {}
    for fill in STEADY_FILLS:
        for warm in (True, False):
            cache = cache._replace(lengths=torch.full((8,), fill, dtype=torch.int32,
                                                      device=device))
            steps = 2 if warm else 16
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(steps):
                tokens, _, cache = engine._paged_decode_step(eng.params, cfg, tokens, cache)
            tokens.tolist()
            dt = (time.perf_counter() - t) / steps
        qk = torch.randn(8, N_KV, N_HEAD // N_KV, HD, device=device)
        ln = torch.full((8,), fill, dtype=torch.int32, device=device)
        k_ms = cuda_ms(lambda: pa.paged_flash_decode(qk, cache.k_pages[0], cache.v_pages[0],
                                                     cache.page_table, ln, scale=HD ** -0.5),
                       50, flush_buf.zero_) * cfg.num_hidden_layers
        log(f"paged steady decode B=8 fill {fill}: {dt * 1e3:.2f} ms/step, {8 / dt:.1f} tok/s; "
            f"paged kernel {k_ms:.4f} ms/step ({cfg.num_hidden_layers} calls)")
        out[fill] = dict(ms_per_step=dt * 1e3, tok_s=8 / dt, kernel_ms_per_step=k_ms)
    eng.cache.page_table.fill_(-1)
    eng.cache.lengths.zero_()
    return out


def phase_paged_http(eng, cfg, rng):
    """serve_http over the paged engine on port 0: 8 concurrent
    /completion requests equal the same prompts run on the engine directly;
    one streamed request's chunks concatenate to its tokens; /health ok."""
    import urllib.request

    from gptq_gguf_tpu_torch.serving import server

    requests = serve_requests(rng, cfg, 8, *HTTP_MIX)
    uids = [eng.submit(p, max_new_tokens=n) for p, n in requests]
    direct = {r.uid: r.output for r in eng.run_until_done()}
    direct = [direct[u] for u in uids]
    eng.completed.clear()
    srv, runner = server.serve_http(eng, port=0, block=False)
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(payload):
        req = urllib.request.Request(f"{base}/completion", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read()

    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(requests)) as ex:
            outs = list(ex.map(lambda pn: json.loads(post({
                "prompt_tokens": pn[0].tolist(), "max_new_tokens": pn[1]}))["tokens"],
                requests))
        wall = time.perf_counter() - t0
        if outs != direct:
            raise RuntimeError("HTTP outputs differ from the engine run directly")
        body = post({"prompt_tokens": requests[0][0].tolist(), "max_new_tokens": requests[0][1],
                     "stream": True}).decode()
        events = [e[len("data: "):] for e in body.split("\n\n") if e]
        chunks = [json.loads(e) for e in events[:-1]]
        streamed = [t for c in chunks for t in c.get("tokens", [])]
        if events[-1] != "[DONE]" or streamed != direct[0]:
            raise RuntimeError("streamed chunks do not concatenate to the request's tokens")
        with urllib.request.urlopen(f"{base}/health", timeout=30) as r:
            health = json.loads(r.read())
        if health["status"] != "ok":
            raise RuntimeError(f"/health: {health}")
    finally:
        srv.shutdown()
        runner.stop()
    log(f"paged HTTP: 8 concurrent /completion requests in {wall:.2f} s equal the engine's "
        f"direct outputs; {len(chunks) - 1} streamed chunks concatenate to the tokens; "
        f"/health ok")
    return dict(wall_s=wall, stream_chunks=len(chunks) - 1)


# ---------------------------------------------------------------------------
# Phase 7: the v1 and v4 formats at full width
# ---------------------------------------------------------------------------

FORMATS = ("v1", "v4", "v4 i8", "v4 bf16")  # 7a: every kernel body, both scale dtypes
FORMAT_MS = (8, 128, 1024)  # decode, a prefill chunk, a perplexity batch (B * S rows)
FORMAT_DECODE_MS = (1, 2, 4)  # the further decode rows (v1's and v4's tensor-core decode tiles)
# 7a's v1 cases on its tensor-core tiles beyond the 8B shapes (bf16 x): name,
# d_out, d_in, type, M (1000 columns: code rows not 16-byte aligned, 4-byte
# copies; 333: vec 1, v1_kernel at any M)
V1_MMA_SMALL = (("Q2_K 1024->768", 768, 1024, "Q2_K", 9),
                ("Q3_K 1024->768", 768, 1024, "Q3_K", 130),
                ("Q5_K 1024->768", 768, 1024, "Q5_K", 64),
                ("ragged Q4_K 2048->1000", 1000, 2048, "Q4_K", 40),
                ("ragged Q6_K 512->333", 333, 512, "Q6_K", 9))
PPL_SEQS, PPL_LEN = 2, 512  # 7d: seeded synthetic sequences scored per format
# one summary entry per TPU kernel body: (name, source, replaces, body, the
# format whose 7a times and 7c serving launches it reports, the shapes of
# one B=8 decode step it runs)
V1_V4_BODIES = (
    ("qmatmul_v1", "qmatmul_v1.cu", "gptq_gguf_tpu/ops/qmatmul.py:157", "v1", "v1",
     ("qkv", "o", "gateup", "down", "lm_head")),
    ("qmatmul_v4_pb2", "qmatmul_v4.cu", "gptq_gguf_tpu/ops/qmv4.py:264", "pb2", "v4",
     ("qkv", "o", "gateup", "down")),
    ("qmatmul_v4_pb2_i8", "qmatmul_v4.cu", "gptq_gguf_tpu/ops/qmv4.py:305", "pb2_i8", "v4 i8",
     ("qkv", "o", "gateup", "down")),
    ("qmatmul_v4_pb1", "qmatmul_v4.cu", "gptq_gguf_tpu/ops/qmv4.py:346", "pb1", "v4",
     ("lm_head",)),
)


def as_format(v2, fmt: str):
    """The weight of a v2 one in another runtime format, on its device.
    "v4" is qmv4.v4_from_v2 (f32 scales, i32 layout: the v2 code bytes,
    per-group planes); "v1" holds the same bytes and planes (its scale_t and
    offset_t equal v4's scale and offc for every K-quant type); "v4 bf16"
    rounds the scales; "v4 i8" biases the high nibbles by -8 and folds the
    x16 and the +8 into the planes, as pack_runtime_v4(layout="i8") does
    (check_format_conversions holds all of them to the packers)."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul, qmv4

    if fmt == "v2":
        return v2
    if fmt == "v4 bf16":
        return qmv4.v4_from_v2(v2, scale_dtype=torch.bfloat16)
    v4 = qmv4.v4_from_v2(v2)
    if fmt == "v4":
        return v4
    if fmt == "v1":
        return qmatmul.RuntimeQuantLinear(v4.qs, v4.scale, v4.offc, v4.d_in, v4.group_size,
                                          v4.per_byte)
    if fmt != "v4 i8":
        raise ValueError(fmt)
    if v4.per_byte == 1:  # 5/6-bit codes are < 128: the same bytes and planes
        return qmv4.RuntimeQuantLinearV4(v4.qs, v4.scale, v4.offc, v4.d_in, v4.group_size,
                                         1, "i8")
    gpsg = 256 // v4.group_size
    gh = gpsg // 2
    sc = v4.scale.reshape(-1, gpsg, v4.d_out).clone()
    of = v4.offc.reshape(-1, gpsg, v4.d_out).clone()
    of[:, gh:] -= 8.0 * sc[:, gh:]
    sc[:, gh:] /= 16.0
    return qmv4.RuntimeQuantLinearV4(v4.qs ^ 0x80, sc.reshape(v4.scale.shape),
                                     of.reshape(v4.offc.shape), v4.d_in, v4.group_size, 2, "i8")


def format_params(params, fmt: str):
    """``params`` with every packed weight in ``fmt`` (the lm_head unpadded:
    only v2 pads its vocab)."""
    from gptq_gguf_tpu_torch.ops import qmatmul

    def conv(v):
        return as_format(v, fmt) if isinstance(v, qmatmul.RuntimeQuantLinearV2) else v

    return {**params, "lm_head": as_format(unpad(params["lm_head"], V), fmt),
            "layers": [{k: conv(v) for k, v in layer.items()} for layer in params["layers"]]}


def unpad(v2, d_out: int):
    """A v2 weight cut back to its first d_out columns (contiguous planes)."""
    from gptq_gguf_tpu_torch.ops.qmatmul import RuntimeQuantLinearV2

    cut = lambda t: None if t is None else t[:, :d_out].contiguous()  # noqa: E731
    return RuntimeQuantLinearV2(cut(v2.qs), cut(v2.d_sg), cut(v2.dmin_sg), cut(v2.sc_q),
                                cut(v2.mn_q), v2.d_in, v2.group_size, v2.per_byte, v2.shift,
                                v2.d_rep)


def check_format_conversions(rng, device):
    """as_format against the package's packers on the same codes, every
    plane bit-equal, for one type of each kernel path; and v1 / v4
    dequantize bit-equal to v2 (one model in every format)."""
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.ops import qmatmul, qmv4

    packers = {
        "v1": qmatmul.pack_runtime,
        "v4": qmv4.pack_runtime_v4,
        "v4 bf16": lambda *a, **k: qmv4.pack_runtime_v4(*a, scale_dtype=torch.bfloat16, **k),
        "v4 i8": lambda *a, **k: qmv4.pack_runtime_v4(*a, layout="i8", **k),
    }
    for qtype in (T.Q4_K, T.Q3_K, T.Q6_K):
        q, p = synthetic_codes(rng, 256, 1024, qtype)
        v2 = qmatmul.pack_runtime_v2(q, p, qtype, device=device)
        w2 = qmatmul.dequantize_runtime_v2(v2)
        for fmt, pack in packers.items():
            got, want = as_format(v2, fmt), pack(q, p, qtype, device=device)
            if getattr(got, "layout", None) != getattr(want, "layout", None):
                raise RuntimeError(f"as_format({fmt}): layout {got.layout}")
            for a, b in zip(got.planes(), want.planes(), strict=True):
                if a.dtype != b.dtype or not torch.equal(a, b):
                    raise RuntimeError(f"as_format({fmt}) {qtype.name}: planes differ from the "
                                       "package's packer")
        for fmt in ("v1", "v4"):
            w = as_format(v2, fmt)
            deq = (qmatmul.dequantize_runtime(w) if fmt == "v1"
                   else qmv4.dequantize_runtime_v4(w))
            if not torch.equal(deq, w2):
                raise RuntimeError(f"{fmt} {qtype.name}: dequantization differs from v2's")
    log("format conversions: planes bit-equal to pack_runtime / pack_runtime_v4 (f32, bf16, "
        "i8) for Q4_K, Q3_K, Q6_K; v1 and v4 dequantize bit-equal to v2")


def format_terms(x, rql) -> float:
    """max over outputs of the sum of |terms| a v1 / v4 product adds up."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul, qmv4

    if isinstance(rql, qmatmul.RuntimeQuantLinear):
        return (x.float().abs() @ qmatmul.dequantize_runtime(rql).T.abs()).max().item()
    ng = rql.scale.shape[0]
    s = rql.scale.to(torch.bfloat16).float()
    w = qmv4._codes_v4(rql).reshape(ng, rql.group_size, rql.d_out) * s[:, None, :]
    mag = x.to(torch.bfloat16).float().abs() @ w.reshape(rql.d_in_local, rql.d_out).abs()
    del w
    if rql.offc is not None:
        mag += qmv4._group_sums(x, rql.group_size).abs() @ rql.offc.abs()
    return mag.max().item()


def v1_group_terms(x, rql) -> float:
    """max over outputs of the sum of |terms| v1's tensor-core tiles add
    up: |x| against |scale_t * q|, and |xsum| against |offset_t|."""
    from gptq_gguf_tpu_torch.ops import qmatmul

    ng, gs = rql.scale_t.shape[0], rql.group_size
    q = qmatmul._unpack_codes(rql.qs, rql.per_byte, rql.d_in_local).float()
    sq = (q.reshape(ng, gs, rql.d_out) * rql.scale_t[:, None, :]).reshape(rql.d_in_local, -1)
    del q
    mag = x.float().abs() @ sq.abs()
    del sq
    xsum = x.float().reshape(x.shape[0], ng, gs).sum(-1)
    return (mag + xsum.abs() @ rql.offset_t.abs()).max().item()


def v1_bf16_weights(x, rql):
    """7a's planted control for a v1 case on the tensor-core tiles: the
    plain version with each weight rounded to bf16 (what a dequantizing
    bf16 tile would compute), which the case's limit must reject."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul

    return x.float() @ qmatmul.dequantize_runtime(rql).to(torch.bfloat16).float().T


def v4_unrounded(x, rql):
    """7a's planted control for a v4 case on the tensor-core tiles: the
    plain version with each weight q * bf16(s) left unrounded (f32), which
    the case's limit must reject."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmv4

    ng = rql.scale.shape[0]
    s = rql.scale.to(torch.bfloat16).float()
    w = qmv4._codes_v4(rql).reshape(ng, rql.group_size, rql.d_out) * s[:, None, :]
    y = x.to(torch.bfloat16).float() @ w.reshape(rql.d_in_local, rql.d_out)
    del w
    if rql.offc is not None:
        y -= qmv4._group_sums(x, rql.group_size) @ rql.offc
    return y


def format_case(name, fmt, x, rql, flush):
    """A v1 / v4 kernel against its plain version on the same inputs, then
    timed: kernel, call, plain, library (torch.matmul on the dequantized
    weight: f32 with TF32 off for v1, bf16 for v4) and the bound (bytes at
    3.35 TB/s, operations at bf16 989 TFLOP/s on the tensor-core tiles, f32
    67 TFLOP/s on v1's CUDA-core tiles). A v4 call on a vec-4 weight must
    run the tensor-core tiles from MMA_MIN_ROWS rows and the tensor-core
    decode tile from qmatmul.DECODE_MMA_MIN_ROWS["v4"] (1) to 8 rows,
    counted on that tile alone, held to 1e-5 with a planted control (v4_unrounded); a
    v1 call with a bf16 x on a vec-4 weight the tensor-core tiles from
    MMA_MIN_ROWS rows and the tensor-core decode tile from
    qmatmul.DECODE_MMA_MIN_ROWS["v1"] (1) to 8 rows, held to 1e-5 of its
    group dot's terms with a planted control (v1_bf16_weights); a v1 call
    with an f32 x v1_kernel at any M. Beside a decode-tile case, and a v1
    tensor-core case, the CUDA-core tile of the same rows (qmv4._launch_v4
    and qmatmul._launch_v1 with the tensor-core tiles ruled out), held to
    the same limit and timed."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul, qmv4

    M, d_in = x.shape
    v1 = isinstance(rql, qmatmul.RuntimeQuantLinear)
    fn, ref = ((qmatmul.dequant_matmul_v1, qmatmul.dequant_matmul_v1_reference) if v1
               else (qmv4.dequant_matmul_v4, qmv4.dequant_matmul_v4_reference))
    vec4 = rql.d_out % 4 == 0
    want_mma = (vec4 and M >= qmatmul.MMA_MIN_ROWS
                and (not v1 or x.dtype == torch.bfloat16))
    want_decode = (vec4 and (not v1 or x.dtype == torch.bfloat16)
                   and qmatmul.DECODE_MMA_MIN_ROWS["v1" if v1 else "v4"] <= M
                   < qmatmul.MMA_MIN_ROWS)
    m0, d0 = getattr(fn, "mma_launches", 0), getattr(fn, "decode_mma_launches", 0)
    y_k = fn(x, rql)
    mma = getattr(fn, "mma_launches", 0) - m0
    decode = getattr(fn, "decode_mma_launches", 0) - d0
    if (mma, decode) != (int(want_mma), int(want_decode)):
        raise RuntimeError(f"{fmt} {name} M={M}: tensor-core launches {mma}, decode-tile "
                           f"launches {decode}; want {int(want_mma)}, {int(want_decode)}")
    tiled = want_mma or want_decode
    y_p = ref(x, rql)
    y_c = (v1_bf16_weights if v1 else v4_unrounded)(x, rql) if tiled else None
    torch.cuda.synchronize()
    if not torch.isfinite(y_k).all():
        raise RuntimeError(f"{fmt} {name}: kernel output is not finite")
    # tolerance: the same products (f32 for v1, bf16 x bf16 for v4; exact
    # bf16 x times raw codes on v1's tiles), f32 sums in another order:
    # 1e-4 of the largest sum of |terms| of an output; 1e-5 on the
    # tensor-core tiles (reordering f32 sums costs ~1e-7 * sqrt(d_in) of
    # it; v1's terms those of its group dot), a limit the planted control
    # (v4: the unrounded weights; v1: the weights rounded to bf16) must fail
    err = (y_k - y_p).abs().max().item()
    terms = v1_group_terms(x, rql) if v1 and tiled else format_terms(x, rql)
    tol = (1e-5 if tiled else 1e-4) * max(terms, 1e-30)
    err_c = (y_k - y_c).abs().max().item() if tiled else None
    del y_k, y_c
    if not err <= tol:
        raise RuntimeError(f"{fmt} {name} M={M}: kernel vs plain max|err| {err:.3e} > {tol:.3e}")
    if tiled and not err_c > tol:
        raise RuntimeError(f"{fmt} {name} M={M}: the limit {tol:.3e} does not reject the "
                           f"planted control ({err_c:.3e})")
    core_err = core_ms = None
    if want_decode or (v1 and want_mma):
        def core():
            if v1:
                return qmatmul._launch_v1(x, rql, mma=False, decode_mma=False)
            return qmv4._launch_v4(x, rql, mma=False, decode_mma=False)

        y_core, tile = core()
        torch.cuda.synchronize()
        core_err = (y_core - y_p).abs().max().item()
        del y_core
        if tile != "cuda_core" or not core_err <= tol:
            raise RuntimeError(f"{fmt} CUDA-core tile {name} M={M} ({tile}): max|err| "
                               f"{core_err:.3e} > tol {tol:.3e}")
        core_ms = cuda_ms(core, 20 if M <= 128 else 5, flush)
    del y_p
    if v1:
        w_lib, x_lib = qmatmul.dequantize_runtime(rql).T.contiguous(), x.float()
    else:
        w_lib = qmv4.dequantize_runtime_v4(rql).T.contiguous().to(torch.bfloat16)
        x_lib = x.to(torch.bfloat16)
    reps = 20 if M <= 128 else 5
    ms = cuda_ms(lambda: fn(x, rql), reps, flush)
    wall_ms = call_ms(lambda: fn(x, rql), reps)
    plain_ms = cuda_ms(lambda: ref(x, rql), 1, flush)
    library_ms = cuda_ms(lambda: torch.matmul(x_lib, w_lib), reps, flush)
    del w_lib, x_lib
    nbytes = rql.bytes_read + x.numel() * x.element_size() + M * rql.d_out * 4
    flops = 2.0 * M * d_in * rql.d_out
    tile = "decode_mma" if want_decode else "mma" if want_mma else "cuda_core"
    rate = F32_FLOP_PER_S if v1 and tile == "cuda_core" else BF16_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    rec = dict(name=name, fmt=fmt, body="v1" if v1 else qmv4.body_of(rql), M=M, d_in=d_in,
               d_out=rql.d_out, max_abs_err=err, tol=tol, tile=tile, mma=bool(want_mma),
               control_err=err_c, core_err=core_err, core_ms=core_ms,
               ms=ms, call_ms=wall_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations", op_rate=rate,
               bytes=nbytes, plane_bytes=rql.bytes_read, flops=flops)
    if v1 and tiled:  # the CUDA-core tile beside it is bound by f32 operations
        rec["core_bound_ms"] = max(t_bytes, flops / F32_FLOP_PER_S * 1e3)
    extra = f", control {err_c:.2e}, {tile}" if tiled else ""
    if core_ms is not None:
        extra += f"; CUDA-core tile {core_ms:.4f} ms (err {core_err:.2e})"
    log(f"  {fmt:>7} {name:>24} M={M:<5} err {err:.3e} (tol {tol:.2e}{extra})  kernel {ms:.4f} ms "
        f"(call {wall_ms:.4f})  plain {plain_ms:.3f} ms  library {library_ms:.4f} ms  bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec


def phase_format_kernels(params, rng, device):
    """7a: the v1 kernel and the three v4 bodies (f32 and bf16 scales)
    against their plain versions at every Llama-3-8B projection shape (Q4_K)
    and the unpadded Q6_K lm_head, at M = 1, 2, 4, 8, the threshold
    (MMA_MIN_ROWS), 128 and 1024 with a bf16 x (v1 and v4 from the
    threshold on their tensor-core tiles, from
    qmatmul.DECODE_MMA_MIN_ROWS["v1"] / ["v4"] to 8 rows on their
    tensor-core decode tiles, the CUDA-core tile beside each); Q2_K / Q3_K
    / Q5_K and ragged d_out at small shapes with an f32 x (v1: v1_kernel),
    and for v1 V1_MMA_SMALL with a bf16 x."""
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.ops import qmatmul

    check_format_conversions(rng, device)
    l0 = params["layers"][0]
    shapes = [("qkv 4096->6144 Q4_K", l0["qkv_proj"]), ("o 4096->4096 Q4_K", l0["o_proj"]),
              ("gateup 4096->28672 Q4_K", l0["gateup_proj"]),
              ("down 14336->4096 Q4_K", l0["down_proj"]),
              ("lm_head 4096->128256 Q6_K", unpad(params["lm_head"], V))]
    small = [("Q2_K 1024->768", 768, 1024, T.Q2_K, 8), ("Q3_K 1024->768", 768, 1024, T.Q3_K, 8),
             ("Q5_K 1024->768", 768, 1024, T.Q5_K, 8),
             ("ragged Q4_K 2048->1000", 1000, 2048, T.Q4_K, 5),
             ("ragged Q6_K 512->333", 333, 512, T.Q6_K, 3)]
    small = [(name, synthetic_rql(rng, d_out, d_in, qt, device), M)
             for name, d_out, d_in, qt, M in small]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device).zero_
    recs = []
    for fmt in FORMATS:
        for name, v2 in shapes:
            rql = as_format(v2, fmt)
            for M in sorted({*FORMAT_MS, *FORMAT_DECODE_MS, qmatmul.MMA_MIN_ROWS}):
                x = (torch.randn(M, rql.d_in_local, device=device) * 0.5).to(torch.bfloat16)
                recs.append(format_case(name, fmt, x, rql, flush))
            del rql
        for name, v2, M in small:
            x = torch.randn(M, v2.d_in_local, device=device)
            recs.append(format_case(name, fmt, x, as_format(v2, fmt), flush))
        if fmt == "v1":  # its tensor-core tiles: a bf16 x from MMA_MIN_ROWS rows
            for name, d_out, d_in, qt, M in V1_MMA_SMALL:
                x = torch.randn(M, d_in, device=device).to(torch.bfloat16)
                recs.append(format_case(name, fmt, x, as_format(
                    synthetic_rql(rng, d_out, d_in, T[qt], device), fmt), flush))
        torch.cuda.empty_cache()
    return recs


def v1_calls(params, cfg, prompt, feed, device) -> dict:
    """7b's per-call check of v1: the 2-layer logits once more, every call
    through the v1 kernel and its plain version on the same x, the plain
    output handed on. Each call with a bf16 x on a vec-4 weight (the
    prefill's projections on the tensor-core tiles, the heads and the
    decode steps on the decode tile) within 7a's limit for those tiles,
    1e-5 of its group dot's terms; any other call within 1e-4 of its
    terms. The same pass with v1_bf16_weights in the kernel's place must
    fail the limit at some tiled call; the kernel's pass counts its
    tensor-core and decode-tile launches as the route gives them."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul

    def shared(calls, control: bool):
        def mm(x, rql):
            y_p = qmatmul.dequant_matmul_v1_reference(x, rql)
            y_k = v1_bf16_weights(x, rql) if control else qmatmul.dequant_matmul_v1(x, rql)
            tiled = x.dtype == torch.bfloat16 and rql.d_out % 4 == 0
            terms = v1_group_terms(x, rql) if tiled else format_terms(x, rql)
            calls.append(dict(M=x.shape[0], tiled=tiled, finite=bool(torch.isfinite(y_k).all()),
                              err=(y_k - y_p).abs().max().item(),
                              tol=(1e-5 if tiled else 1e-4) * max(terms, 1e-30)))
            return y_p
        return mm

    calls, ctrl = [], []
    reset_matmul_counts()
    two_layer_logits(params, cfg, prompt, feed, shared(calls, False), device)
    mma, dmma = mma_counts()["v1"], decode_counts()["v1"]
    two_layer_logits(params, cfg, prompt, feed, shared(ctrl, True), device)
    want = want_decode({"v1": 4 * 2 + 1}, [(1, prompt.shape[1])] + [(1, 1)] * feed.shape[0],
                       2)["v1"]
    bad = [c for c in calls if not (c["finite"] and c["err"] <= c["tol"])]
    rejected = sum(c["err"] > c["tol"] for c in ctrl if c["tiled"])
    worst = max(calls, key=lambda c: c["err"] / c["tol"])
    log(f"v1 per call (2 layers, prefill + 4 decode, shared inputs): {len(calls) - len(bad)} of "
        f"{len(calls)} calls within their limit ({sum(c['tiled'] for c in calls)} tiled, 1e-5 "
        f"of their group dot's terms; worst M={worst['M']}: {worst['err']:.3e} of "
        f"{worst['tol']:.3e}); tensor-core launches {mma}, decode tile {dmma} (want 8, "
        f"{want}); control (v1_bf16_weights) rejected at {rejected} of "
        f"{sum(c['tiled'] for c in ctrl)} tiled calls")
    if bad:
        raise RuntimeError(f"v1: kernel and plain disagree on shared inputs at {len(bad)} calls")
    if (mma, dmma) != (8, want):
        raise RuntimeError(f"v1 per call: tensor-core launches {mma}, decode tile {dmma}; "
                           f"want 8, {want}")
    if rejected == 0:
        raise RuntimeError("v1 per call: the limit does not reject the control")
    return dict(calls=len(calls), worst_err=worst["err"], worst_tol=worst["tol"],
                mma_launches=mma, decode_mma_launches=dmma, control_rejected=rejected)


def phase_format_consistency(fparams, cfg, rng, device):
    """7b: 2 layers at full width, one 128-token prefill and 4 decode steps
    in each format through its kernel and through its plain version, held
    to phase 4's 3e-3 of max|logit|; v1's also call by call (v1_calls);
    the logit differences between the formats' kernel runs are printed
    (they round differently by design)."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul, qmv4

    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 128)), device=device)
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4,)), device=device)
    pairs = {"v2": (qmatmul.dequant_matmul_v2g, None),
             "v1": (qmatmul.dequant_matmul_v1, qmatmul.dequant_matmul_v1_reference),
             "v4": (qmv4.dequant_matmul_v4, qmv4.dequant_matmul_v4_reference)}
    kernel_logits = {}
    for fmt, (fn, ref) in pairs.items():
        lk = two_layer_logits(fparams[fmt], cfg, prompt, feed, fn, device)
        kernel_logits[fmt] = lk
        if ref is None:
            continue
        lp = two_layer_logits(fparams[fmt], cfg, prompt, feed, ref, device)
        scale = lp.abs().max().item()
        err = (lk - lp).abs().max().item()
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        log(f"{fmt} consistency (2 layers, prefill + 4 decode): max|dlogit| kernel vs plain "
            f"{err:.3e}, tol {3e-3 * scale:.3e} (3e-3 of max|logit| {scale:.3e}); argmax "
            f"agreement {agree:.2f}")
        if not (torch.isfinite(lk).all() and err <= 3e-3 * scale):
            raise RuntimeError(f"{fmt}: kernel and plain logits disagree")
        if fmt == "v1":
            v1_calls(fparams[fmt], cfg, prompt, feed, device)
    diffs = {f"{a} vs {b}": (kernel_logits[a] - kernel_logits[b]).abs().max().item()
             for a, b in (("v1", "v2"), ("v4", "v2"), ("v1", "v4"))}
    log("between formats (kernels): " + ", ".join(f"max|dlogit| {k} {v:.3e}"
                                                  for k, v in diffs.items()))
    return diffs


def phase_format_ppl(fparams, cfg, device):
    """7d: compute_perplexity(serving=True) on the 32-layer model in v2, v1
    and v4: PPL_SEQS seeded synthetic sequences of PPL_LEN tokens, every
    projection and the lm_head through the format's kernel at M = PPL_LEN,
    each format within 1e-3 nats/token of the same model through its plain
    version. v2's and v4's every call runs the tensor-core tiles. v1's
    runs them where x is bf16 (qmatmul.dequant_matmul_v1's route): at
    PPL_LEN < 2 * FLASH_CHUNK the cache takes the short attention path,
    whose f32 output (as in the JAX package) makes the residual stream f32
    after the first o-projection, so only each sequence's first q/k/v call
    has a bf16 x; "v1 long" scores v1 again at 2 * FLASH_CHUNK tokens (the
    flash path: bf16 activations throughout), every call on the tiles. The
    tensor-core launches are held to the calls whose x the route gives
    them, counted by dtype in the same run."""
    import torch

    from gptq_gguf_tpu_torch.evals import ppl
    from gptq_gguf_tpu_torch.models import llama
    from gptq_gguf_tpu_torch.ops import qmatmul, qmv4
    from gptq_gguf_tpu_torch.utils.data import get_data

    n_long = 2 * llama.FLASH_CHUNK
    data = {n: get_data("synthetic", PPL_SEQS * n, n, train=False, vocab_size=V)
            for n in (PPL_LEN, n_long)}
    plain_fns = {"v2": qmatmul.dequant_matmul_v2g_reference,
                 "v1": qmatmul.dequant_matmul_v1_reference,
                 "v4": qmv4.dequant_matmul_v4_reference}
    out = {}
    for label, fmt, kernel, n in (("v2", "v2", "v2g", PPL_LEN), ("v1", "v1", "v1", PPL_LEN),
                                  ("v4", "v4", "v4", PPL_LEN), ("v1 long", "v1", "v1", n_long)):
        seqs = data[n]
        ppl.compute_perplexity(fparams[fmt], cfg, seqs[:1], serving=True)  # warm
        dispatch, rows = qmatmul.dequant_matmul, []

        def spy(x, rql):  # each call's rows and dtype, for the route's expected tiles
            rows.append((x.shape[0], x.dtype == torch.bfloat16, rql.d_out % 4 == 0))
            return dispatch(x, rql)

        qmatmul.dequant_matmul = spy
        reset_matmul_counts()
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            value = ppl.compute_perplexity(fparams[fmt], cfg, seqs, serving=True)
            torch.cuda.synchronize()
        finally:
            qmatmul.dequant_matmul = dispatch
        secs = (time.perf_counter() - t) / len(seqs)
        counts, mma = matmul_counts(), mma_counts()
        want = len(seqs) * (4 * cfg.num_hidden_layers + 1)
        if counts[kernel] != want or any(counts[k] for k in MATMUL_KERNELS if k != kernel):
            raise RuntimeError(f"ppl {label}: launches {counts}, want {want} of {kernel}")
        # every projection and the all-position head at M = n on the
        # tensor-core tiles (v2 and v4); v1's where its x is bf16
        on_tiles = sum(m >= qmatmul.MMA_MIN_ROWS and vec4 and (bf16 or fmt != "v1")
                       for m, bf16, vec4 in rows)
        if len(rows) != want or mma != {k: on_tiles if k == kernel else 0 for k in mma}:
            raise RuntimeError(f"ppl {label}: tensor-core launches {mma}, want {on_tiles} of "
                               f"{kernel} ({len(rows)} calls)")
        if label == "v1 long" and on_tiles != want:
            raise RuntimeError(f"ppl {label}: {on_tiles} of {want} calls with a bf16 x")
        if any(decode_counts().values()):
            raise RuntimeError(f"ppl {label}: decode-tile launches {decode_counts()}")
        if not np.isfinite(value):
            raise RuntimeError(f"ppl {label}: {value}")
        n_bf16 = sum(b for _, b, _ in rows)
        out[label] = dict(ppl=value, nll=float(np.log(value)), s_per_seq=secs, tokens=n,
                          launches=counts[kernel], mma_launches=mma.get(kernel, 0),
                          bf16_calls=n_bf16, counts=counts)
        log(f"ppl ({label}, serving path, {len(seqs)} x {n} tokens): {value:.4f} "
            f"({np.log(value):.6f} nats/token), {secs:.3f} s per sequence, {counts[kernel]} "
            f"{kernel} launches ({mma.get(kernel, 0)} on the tensor cores; {n_bf16} calls with "
            f"a bf16 x)")
        fn0 = qmatmul.dequant_matmul  # the same function through the plain version
        qmatmul.dequant_matmul = plain_fns[fmt]
        try:
            plain = float(np.log(ppl.compute_perplexity(fparams[fmt], cfg, seqs, serving=True)))
        finally:
            qmatmul.dequant_matmul = fn0
        d = out[label]["nll"] - plain
        out[label]["plain_nll"] = plain
        log(f"ppl ({label}): kernels {out[label]['nll']:.6f} vs plain version {plain:.6f} "
            f"nats/token: {d:+.3e} (bound 1e-3)")
        if not abs(d) < 1e-3:
            raise RuntimeError(f"ppl {label}: kernels {out[label]['nll']} vs plain {plain}")
    same = [r["nll"] for r in out.values() if r["tokens"] == PPL_LEN]
    spread = max(same) - min(same)
    log(f"ppl across formats: nats/token spread {spread:.3e} (bound 0.05)")
    if not spread < 0.05:
        raise RuntimeError("the formats' perplexities disagree")
    return out


def phase_gptq_formats(ckpt: Path, save: Path, arts, device):
    """7e: the 2-layer GPTQ artifacts served through
    quantize_params_for_serving in v1, v2 and v4: each packed weight
    dequantizes bit-equal to its artifact; a few greedy tokens each."""
    import torch

    from gptq_gguf_tpu_torch.models import loader
    from gptq_gguf_tpu_torch.ops import qmatmul
    from gptq_gguf_tpu_torch.serving import engine, model as qmodel

    cfg = loader.load_config(ckpt, dtype=torch.bfloat16)
    dense = loader.load_params(ckpt, cfg)
    prompt = np.arange(1, 17, dtype=np.int64)
    out = {}
    v2_layers = None
    fmt0 = qmatmul.RUNTIME_FORMAT
    for fmt in ("v1", "v2", "v4"):
        qmatmul.RUNTIME_FORMAT = fmt
        try:
            qp = qmodel.quantize_params_for_serving(dense, cfg, save, device=device)
        finally:
            qmatmul.RUNTIME_FORMAT = fmt0
        for name, art in arts.items():
            li, key = int(name.split(".")[2]), name.split(".")[-1]
            w = qp["layers"][li][key]
            if not torch.equal(qmodel._dequant_any(w), art.dequantize(device)):
                raise RuntimeError(f"{fmt} {name}: dequantization differs from the artifact's")
        if fmt == "v2":
            v2_layers = qp["layers"]  # unfused: the packed GGUF's planes are held to these
        qp = qmodel.fuse_params_for_serving(qp, cfg)
        toks = engine.generate(qp, cfg, [prompt], max_new_tokens=6, max_len=64)[0]
        if len(toks) != 6 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise RuntimeError(f"{fmt}: greedy tokens {toks}")
        out[fmt] = toks
        log(f"GPTQ artifacts served in {fmt} ({type(w).__name__}): {len(arts)} weights "
            f"dequantize bit-equal to their artifacts; greedy tokens {toks}")
        del qp
        torch.cuda.empty_cache()
    return out, v2_layers


PACK_PROMPT = "The quick brown fox jumps over the lazy dog."
NEAR_TIE = 3e-3  # top-2 gap, as a fraction of max|logit|, below which a greedy step may flip


def write_tokenizer(ckpt: Path, n_vocab: Optional[int] = None) -> None:
    """A BPE tokenizer.json of the checkpoint's tokens (V, or ``n_vocab``)
    beside its config.json, of the form tests/test_packer.py's
    write_tiny_tokenizer writes at 256: ids 0-255 the GPT-2 byte alphabet
    (any text encodes, a byte a token), the rest "<tN>", the last an added
    special token."""
    from gptq_gguf_tpu_torch.serving.tokenizer import _BYTE_ENC

    n = n_vocab or V
    vocab = {_BYTE_ENC[b]: b for b in range(256)}
    vocab.update({f"<t{i}>": i for i in range(256, n - 1)})
    tok = {"model": {"type": "BPE", "vocab": vocab, "merges": []},
           "added_tokens": [{"id": n - 1, "content": "<|end_of_text|>", "special": True}]}
    (ckpt / "tokenizer.json").write_text(json.dumps(tok))
    (ckpt / "tokenizer_config.json").write_text(json.dumps({"bos_token_id": 0,
                                                            "eos_token_id": n - 1}))


def run_cli(argv) -> list:
    """The port's command line with argv; its printed lines (also logged)."""
    import contextlib
    import io

    from gptq_gguf_tpu_torch.__main__ import main as port_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_main(argv)
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"  | {line}")
    return lines


def phase_gptq_pack(tmp: Path, arts, v2_layers, greedy_v2, device):
    """5, after 7e: the port's ``pack`` writes the 2-layer GPTQ checkpoint
    and its artifacts as a bf16 + Q4_K GGUF (host code, timed). Read back
    exactly: each Q4_K tensor unpacks to its artifact bit for bit (q / k
    through the inverse rope permutation), each float tensor holds the
    checkpoint's values (bf16 bits for the 2-D ones). Served (v2g
    launches; greedy tokens equal 7e's v2 tokens up to a near-tie), and the
    params serve loaded onto the card hold each projection's v2 planes equal
    to 7e's from the same artifacts; served from a text prompt through the
    GGUF's own vocabulary, and scored."""
    import torch

    from gptq_gguf_tpu_torch.export.packer import hf_to_gguf_name
    from gptq_gguf_tpu_torch.formats import convert, safetensors
    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.formats.gguf import GGUFReader
    from gptq_gguf_tpu_torch.ops.qmatmul import RuntimeQuantLinearV2
    from gptq_gguf_tpu_torch.serving import model as qmodel
    from gptq_gguf_tpu_torch.serving import tokenizer as gtok

    t_step = time.perf_counter()
    ckpt, out = tmp / "ckpt", tmp / "model-Q4_K.gguf"  # the level in the name, for build-db
    write_tokenizer(ckpt)
    t = time.perf_counter()
    run_cli(["pack", "--model_dir", str(ckpt), "--quant_dir", str(tmp / "layers"),
             "--outfile", str(out), "--outtype", "bf16"])
    pack_s = time.perf_counter() - t
    r = GGUFReader(out)
    n_bytes = out.stat().st_size
    log(f"pack: {GPTQ_LAYERS}-layer Llama-3-8B-width GPTQ checkpoint -> {n_bytes} bytes, "
        f"{len(r.tensors)} tensors in {pack_s:.2f} s (host code; card "
        f"{card_name_and_power()})")
    if len(r.tensors) != 3 + 9 * GPTQ_LAYERS or r.get("general.file_type") != 15:
        raise RuntimeError(f"GGUF: {len(r.tensors)} tensors, "
                           f"file_type {r.get('general.file_type')}")
    if len(r.get("tokenizer.ggml.tokens")) != V:
        raise RuntimeError("GGUF vocabulary is not the checkpoint's")
    for name, art in arts.items():
        gname = hf_to_gguf_name(name + ".weight")
        info = r.tensors[gname]
        key = name.split(".")[-1]
        heads = N_HEAD if key == "q_proj" else N_KV
        inv = (np.argsort(convert.gqa_permute_rows(info.shape[0], heads))
               if key in ("q_proj", "k_proj") else np.arange(info.shape[0]))
        got = convert.unpack_layer(np.asarray(r.tensor_bytes(gname)), info.ggml_type, info.shape)
        want = (art.qweight, art.super_group_scale, art.group_scale_quant,
                art.super_group_zero, art.group_zero_quant)
        if info.ggml_type != T.Q4_K or art.q_type != T.Q4_K or any(
                a.dtype != b.dtype or a[inv].tobytes() != np.ascontiguousarray(b).tobytes()
                for a, b in zip(got, want)):
            raise RuntimeError(f"{gname}: does not unpack to its artifact bit for bit")
    header, _ = safetensors.read_header(ckpt / "model.safetensors")
    floats = [n for n in sorted(header)
              if hf_to_gguf_name(n) is not None and n[:-len(".weight")] not in arts]
    for hf_name, t_ckpt in safetensors.iter_file(ckpt / "model.safetensors", floats):
        gname = hf_to_gguf_name(hf_name)
        info = r.tensors[gname]
        if t_ckpt.dim() == 2:
            same = (info.ggml_type == T.BF16 and np.asarray(r.tensor_bytes(gname)).tobytes()
                    == t_ckpt.view(torch.int16).numpy().tobytes())
        else:
            same = info.ggml_type == T.F32 and np.array_equal(r.tensor_float(gname),
                                                              t_ckpt.float().numpy())
        if not same:
            raise RuntimeError(f"{gname}: does not hold the checkpoint's values")
    prompt_ids = gtok.from_gguf(r).encode(PACK_PROMPT)
    del r
    read_s = time.perf_counter() - t - pack_s
    log(f"  read back in {read_s:.1f} s: {len(arts)} Q4_K tensors bit-equal to their artifacts, "
        f"{len(floats)} float tensors equal to the checkpoint's, general.file_type 15, "
        f"{V} tokens")

    # serve loads the GGUF onto the card (load_gguf_for_serving); its params
    # are kept to compare with 7e's
    prompt = np.arange(1, 17, dtype=np.int64)
    kept = {}
    load0 = qmodel.load_gguf_for_serving

    def load_and_keep(*a, **kw):
        kept["params"], kept["cfg"] = load0(*a, **kw)
        return kept["params"], kept["cfg"]

    t = time.perf_counter()
    reset_matmul_counts()
    qmodel.load_gguf_for_serving = load_and_keep
    try:
        lines = run_cli(["serve", "--gguf-file", str(out), "--prompt-tokens", *map(str, prompt),
                         "--max-new-tokens", "6", "--max-len", "64", "--num-slots", "1",
                         "--device", str(device)])
    finally:
        qmodel.load_gguf_for_serving = load0
    launches = matmul_counts()["v2g"]
    serve_s = time.perf_counter() - t
    toks = json.loads(lines[-1])
    if launches <= 0 or len(toks) != 6:
        raise RuntimeError(f"serve: {launches} v2g launches, tokens {toks}")
    params, cfg = kept["params"], kept["cfg"]
    if params["embed_tokens"].device.type != torch.device(device).type:
        raise RuntimeError("serve did not load the GGUF onto the card")
    n_planes = 0
    for li, layer in enumerate(v2_layers):
        for key, w in layer.items():
            if not isinstance(w, RuntimeQuantLinearV2):
                continue
            g = params["layers"][li][key]
            for plane in ("qs", "d_sg", "dmin_sg", "sc_q", "mn_q"):
                a, b = getattr(g, plane), getattr(w, plane)
                if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                    raise RuntimeError(f"layer {li} {key}: GGUF plane {plane} differs from 7e's")
            if (g.d_in, g.group_size, g.per_byte, g.shift, g.d_rep) != (
                    w.d_in, w.group_size, w.per_byte, w.shift, w.d_rep):
                raise RuntimeError(f"layer {li} {key}: GGUF weight's layout differs from 7e's")
            n_planes += 1
    if n_planes != len(arts):
        raise RuntimeError(f"{n_planes} projections compared, want {len(arts)}")
    # each step's top-2 gap of the GGUF model on its own stream (one prefill)
    ids = torch.as_tensor(np.concatenate([prompt, toks[:-1]]), device=device)[None]
    cache = qmodel.init_cache(cfg, 1, 64, device=device)
    with torch.no_grad():
        logits, _ = qmodel.forward_cached(qmodel.fuse_params_for_serving(params, cfg), cfg,
                                          ids, cache, all_logits=True)
    steps = logits[0, len(prompt) - 1:].float()
    top2 = torch.topk(steps, 2, dim=-1).values
    gaps = ((top2[:, 0] - top2[:, 1]) / steps.abs().amax(-1)).tolist()
    del params, cache, logits, kept
    torch.cuda.empty_cache()
    flip = next((i for i, (a, b) in enumerate(zip(toks, greedy_v2)) if a != b), None)
    log(f"  serve in {serve_s:.1f} s (the GGUF loaded onto the card; its {n_planes} "
        f"projections' v2 planes equal 7e's): tokens {toks} (7e's v2: {greedy_v2}), "
        f"{launches} v2g launches; top-2 gap / max|logit| per step {[round(g, 5) for g in gaps]}")
    if flip is not None and not gaps[flip] < NEAR_TIE:
        raise RuntimeError(f"serve: step {flip} differs from 7e's with a top-2 gap of "
                           f"{gaps[flip]:.2e} of max|logit| (near-tie limit {NEAR_TIE})")
    t = time.perf_counter()
    text = run_cli(["serve", "--gguf-file", str(out), "--prompt", PACK_PROMPT,
                    "--max-new-tokens", "6", "--max-len", "64", "--num-slots", "1",
                    "--device", str(device)])
    if not text[0].startswith("generated 6 tokens") or len(prompt_ids) < len(PACK_PROMPT):
        raise RuntimeError(f"serve --prompt: {text}, prompt tokens {prompt_ids}")
    text_s = time.perf_counter() - t
    t = time.perf_counter()
    run_cli(["ppl", "--gguf-file", str(out), "--gguf-path", "serving", "--datasets", "synthetic",
             "--eval_tokens", str(2 * 512), "--sequence_length", "512", "--device", str(device),
             "--output_path", str(tmp / "ppl.json")])
    ppl = json.loads((tmp / "ppl.json").read_text())["synthetic"]
    if not np.isfinite(ppl):
        raise RuntimeError(f"ppl of the packed GGUF: {ppl}")
    ppl_s = time.perf_counter() - t
    step_s = time.perf_counter() - t_step
    log(f"  serve --prompt in {text_s:.1f} s; ppl (serving, 2 x 512 synthetic tokens) "
        f"{ppl:.4f} in {ppl_s:.1f} s; the step took {step_s:.1f} s")
    return out, dict(pack_s=pack_s, bytes=n_bytes, tensors=3 + 9 * GPTQ_LAYERS,
                     v2g_launches=launches, tokens=toks, first_difference=flip, gaps=gaps,
                     text_prompt_tokens=len(prompt_ids), ppl=ppl,
                     seconds=dict(read_back=read_s, serve=serve_s, serve_text=text_s, ppl=ppl_s,
                                  step=step_s))


# the search of phase 5's mixed step: sparse KL against the bf16 checkpoint
# on 4096 synthetic tokens in sequences of 512, a few generations
SEARCH_TOKENS, SEARCH_SEQ, SEARCH_BITS = 4096, 512, 5.5
SEARCH_ARGS = ("--target_bitwidth", str(SEARCH_BITS), "--fitness_fn", "sparse_kl",
               "--group_rule", "size", "--generations", "4", "--offspring", "8",
               "--survivors_per_selection", "2", "1", "--tokens_per_selection", "2048", "4096",
               "--initially_generated", "4", "--initial_tokens", "2048")
LEVEL_BITS = {"Q4_K": 4.5, "Q6_K": 6.5625}
HF_KEYS = {"attn_q": "q_proj", "attn_k": "k_proj", "attn_v": "v_proj", "attn_output": "o_proj",
           "ffn_gate": "gate_proj", "ffn_up": "up_proj", "ffn_down": "down_proj"}


def disk_bytes(root: Path) -> int:
    return sum(p.stat().st_size for p in root.rglob("*") if p.is_file())


def hf_weight(r, name: str):
    """A GGUF block linear as the layer database's HF layout holds it:
    formats.ggml.dequantize, q / k rows back in HF's order, f16."""
    import torch

    from gptq_gguf_tpu_torch.formats import convert, ggml

    info = r.tensors[name]
    w = ggml.dequantize(np.asarray(r.tensor_bytes(name)), info.ggml_type, info.shape)
    comp = name.split(".")[2]
    if comp in ("attn_q", "attn_k"):
        w = w[np.argsort(convert.gqa_permute_rows(info.shape[0],
                                                  N_HEAD if comp == "attn_q" else N_KV))]
    return torch.from_numpy(np.ascontiguousarray(w.astype(np.float16)))


def v2g_per_forward(levels: dict, packed_head: bool = False) -> int:
    """v2g calls of one forward of a mixed model: per layer q/k/v fused
    into one when they share a type (else three), o, gate/up fused when they
    share one (else two), down; and the head when it is packed (a bf16 head
    is dense)."""
    n = int(packed_head)
    for li in range(GPTQ_LAYERS):
        t = {k: levels[f"blk.{li}.{c}.weight"] for c, k in HF_KEYS.items()}
        n += (1 if t["q_proj"] == t["k_proj"] == t["v_proj"] else 3) + 1
        n += (1 if t["gate_proj"] == t["up_proj"] else 2) + 1
    return n


def stitched_calls(params, cfg, rng, device):
    """Every v2g call of a prefill of 8 x 16 tokens (M = 128: the
    tensor-core tiles) and of one B=8 decode step (M = 8: the decode tile)
    through the stitched model, kernel and plain version on the same x,
    the plain output handed on (as 8b does): each within 1e-5 of its
    largest sum of |terms| (PREFILL_TILE_LIMIT on the prefill tiles, 8b's
    limit there), and control_of's plain version in place of the kernel,
    which must fail that limit."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul
    from gptq_gguf_tpu_torch.serving import model as qmodel

    fns = variant_fns()
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(8, 16)), device=device)
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(8, 1)), device=device)

    def shared(calls, control):
        def mm(x, rql):
            y_p = fns["v2g"][1](x, rql, torch.bfloat16)
            if control:
                c_var, c_mxu = control_of("v2g", "bf16")
                y_k = fns[c_var][1](x, rql, mxu_dtype(c_mxu))
            else:
                y_k = fns["v2g"][0](x, rql, torch.bfloat16)
            tile = x.shape[0] >= qmatmul.MMA_MIN_ROWS and rql.d_out % 4 == 0
            terms = max(variant_terms(x, rql, "v2g", "bf16"), 1e-30)
            calls.append(dict(M=x.shape[0], shape=(rql.d_out, rql.d_in), gs=rql.group_size,
                              finite=bool(torch.isfinite(y_k).all()), tile=tile,
                              err=(y_k - y_p).abs().max().item(), tol_1e5=1e-5 * terms,
                              tol=(PREFILL_TILE_LIMIT if tile else 1e-5) * terms))
            return y_p
        return mm

    out = {}
    fn0 = qmatmul.dequant_matmul
    for control in (False, True):
        calls = []
        reset_matmul_counts()
        qmatmul.dequant_matmul = shared(calls, control)
        try:
            cache = qmodel.init_cache(cfg, 8, 64, device=device)
            with torch.no_grad():
                _, cache = qmodel.forward_cached(params, cfg, ids, cache)
                qmodel.forward_cached(params, cfg, feed, cache)
        finally:
            qmatmul.dequant_matmul = fn0
        out[control] = (calls, mma_counts()["v2g"], decode_counts()["v2g"])
    return out


def plain_tokens_and_gaps(fused, cfg, prompt, toks, device):
    """The greedy tokens of ``fused`` from ``prompt`` through v2g's plain
    version (as many as ``toks``), each step's top-2 gap over max|logit| of
    the kernel's own stream ``toks`` (one prefill), and the first step at
    which the two streams differ (None if they agree)."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul
    from gptq_gguf_tpu_torch.serving import engine, model as qmodel

    fn0, plain_v2g = qmatmul.dequant_matmul, variant_fns()["v2g"][1]
    qmatmul.dequant_matmul = lambda x, rql: plain_v2g(x, rql, torch.bfloat16)
    try:
        plain = engine.generate(fused, cfg, [prompt], max_new_tokens=len(toks), max_len=64)[0]
    finally:
        qmatmul.dequant_matmul = fn0
    ids = torch.as_tensor(np.concatenate([prompt, toks[:-1]]), device=device)[None]
    cache = qmodel.init_cache(cfg, 1, 64, device=device)
    with torch.no_grad():
        logits, _ = qmodel.forward_cached(fused, cfg, ids, cache, all_logits=True)
    steps = logits[0, len(prompt) - 1:].float()
    top2 = torch.topk(steps, 2, dim=-1).values
    gaps = ((top2[:, 0] - top2[:, 1]) / steps.abs().amax(-1)).tolist()
    flip = next((i for i, (a, b) in enumerate(zip(toks, plain)) if a != b), None)
    return plain, gaps, flip


def phase_gptq_mixed(tmp: Path, q4_gguf: Path, v2_layers, device):
    """5, after the pack step: a second level, the layer database, the
    search, the stitcher, and the stitched GGUF served. ``quantize
    --default_bit_width Q6_K`` of the 2-layer checkpoint (16384 tokens, on
    the solve kernel) packed as a second GGUF; ``build-db`` of both, every
    layers-gguf file its GGUF tensor's bytes and every layers-hf tensor its
    dequantization (exact, host); ``search`` on the card (sparse KL, 5.5
    bits: a config within budget holding both types), the sparse KL of
    uniform Q4_K, uniform Q6_K and the config on its 4096 tokens;
    ``convert-config`` and ``stitch``: each tensor the bytes of the GGUF
    whose type the config picked, the source's metadata and order, the
    scored layers-hf tensors the dequantization of the stitched ones;
    ``serve`` (v2 planes equal to quantize_params_for_serving's from the
    artifacts the config picked, v2g launches as the config implies,
    tokens equal to the plain versions' up to a near-tie), every v2g call
    of a prefill and a B=8 decode step held call by call; ``gguf-split``,
    ``serve`` from the first shard and ``--merge`` back byte for byte;
    ``ppl --gguf-path serving``. The layers-hf database (with the searched
    config), the stitched GGUF and the Q4_K GGUF stay for phase 12."""
    import torch

    from gptq_gguf_tpu_torch.evals import ppl as ppl_mod
    from gptq_gguf_tpu_torch.formats.gguf import GGUFReader
    from gptq_gguf_tpu_torch.mapper import splitter
    from gptq_gguf_tpu_torch.mapper.stitcher import GGUFStitcher
    from gptq_gguf_tpu_torch.models import loader
    from gptq_gguf_tpu_torch.ops import gptq, qmatmul
    from gptq_gguf_tpu_torch.search import evopress
    from gptq_gguf_tpu_torch.serving import model as qmodel

    t_step = time.perf_counter()
    peak = [0]

    def note_disk():
        peak[0] = max(peak[0], disk_bytes(tmp))

    ckpt, rec, secs = tmp / "ckpt", {}, {}

    # 1. the second level: Q6_K GPTQ on the solve kernel, packed
    save6, q6_gguf = tmp / "layers_q6", tmp / "model-Q6_K.gguf"
    argv = quantize_argv(ckpt, save6, device, profile=False)
    argv[argv.index("--calibration_tokens") + 1] = str(STATIC_CALIB_TOKENS)
    argv[argv.index("--default_bit_width") + 1] = "Q6_K"
    gptq.solve_block.launches = 0
    t = time.perf_counter()
    run_cli(argv)
    torch.cuda.synchronize()
    secs["quantize_q6"] = time.perf_counter() - t
    q6_launches = gptq.solve_block.launches
    want = sum(n for _, _, n in SOLVE_SHAPES) * GPTQ_LAYERS
    log(f"quantize --default_bit_width Q6_K ({STATIC_CALIB_TOKENS} tokens): "
        f"{secs['quantize_q6']:.2f} s, {q6_launches} solve-kernel launches")
    if q6_launches != want:
        raise RuntimeError(f"Q6_K quantize: {q6_launches} solve-kernel launches, want {want}")
    t = time.perf_counter()
    run_cli(["pack", "--model_dir", str(ckpt), "--quant_dir", str(save6), "--outfile",
             str(q6_gguf), "--outtype", "bf16"])
    secs["pack_q6"] = time.perf_counter() - t
    note_disk()

    # 2. build-db, held exactly on the host
    db = tmp / "db"
    t = time.perf_counter()
    run_cli(["build-db", "--models", str(q4_gguf), str(q6_gguf), "--output-dir", str(db)])
    secs["build_db"] = time.perf_counter() - t
    note_disk()
    t = time.perf_counter()
    readers = {"Q4_K": GGUFReader(q4_gguf), "Q6_K": GGUFReader(q6_gguf)}

    def prefix(info):
        qname = info.ggml_type.name
        return f"{splitter._bits_prefix(splitter.nominal_bits(qname))}-{qname}"

    def check_tensor(item):
        """(1, 1 if a block linear's layers-hf tensor was checked too)"""
        level, name = item
        r, info = readers[level], readers[level].tensors[name]
        raw = (db / "layers-gguf" / name / f"{prefix(info)}.pth").read_bytes()
        if raw != r.tensor_bytes(name).tobytes():
            raise RuntimeError(f"layers-gguf {name} ({level}): not the GGUF's bytes")
        if not (name.startswith("blk.") and name.split(".")[2] in HF_KEYS):
            return 1, 0
        hf = splitter.gguf_to_hf_name(name)[:-len(".weight")]
        got = torch.load(db / "layers-hf" / hf / f"{prefix(info)}.pth", weights_only=True)
        if got.dtype != torch.float16 or not torch.equal(got, hf_weight(r, name)):
            raise RuntimeError(f"layers-hf {hf} ({level}): not the dequantization")
        return 1, 1

    with ThreadPoolExecutor(8) as ex:
        counts = np.sum(list(ex.map(check_tensor, [(lv, n) for lv, r in readers.items()
                                                   for n in r.tensor_order])), axis=0)
    secs["build_db_check"] = time.perf_counter() - t
    q6_bytes = q6_gguf.stat().st_size
    log(f"build-db of the Q4_K and Q6_K GGUFs in {secs['build_db']:.1f} s (pack Q6_K "
        f"{secs['pack_q6']:.1f} s, {q6_bytes} bytes): {counts[0]} layers-gguf files equal to "
        f"their GGUF tensors' bytes and {counts[1]} layers-hf tensors equal to their "
        f"dequantization (checked in {secs['build_db_check']:.1f} s)")
    if tuple(counts) != (2 * (3 + 9 * GPTQ_LAYERS), 2 * 7 * GPTQ_LAYERS):
        raise RuntimeError(f"build-db checked {tuple(counts)} files")

    # 3. the search on the card, timed by part
    hf_db, seen, fit_s = db / "layers-hf", {}, []
    search0, teacher0, fitness0 = (evopress.evo_press_search, evopress.compute_target_logits,
                                   evopress.compute_fitness)

    def timed_teacher(*a, **kw):
        t0 = time.perf_counter()
        out = teacher0(*a, **kw)
        torch.cuda.synchronize()
        seen["teacher_s"] = time.perf_counter() - t0
        return out

    def timed_fitness(*a, **kw):
        t0 = time.perf_counter()
        f = fitness0(*a, **kw)  # a float: the card is done
        fit_s.append(time.perf_counter() - t0)
        return f

    def kept_search(model, calib, cfg, **kw):
        log0, stamps = kw.pop("log", print), []

        def stamped(msg):
            stamps.append(time.perf_counter())
            log0(msg)

        t0 = time.perf_counter()
        out = search0(model, calib, cfg, log=stamped, **kw)
        seen.update(model=model, calib=calib, teacher=kw.get("target_logits"), result=out,
                    stamps=[t0] + stamps + [time.perf_counter()])
        return out

    t = time.perf_counter()
    evopress.evo_press_search, evopress.compute_target_logits = kept_search, timed_teacher
    evopress.compute_fitness = timed_fitness
    try:
        run_cli(["search", "--model_name_or_path", str(ckpt), "--quant_weights_path",
                 str(hf_db), *SEARCH_ARGS, "--calibration_data", "synthetic",
                 "--calibration_tokens", str(SEARCH_TOKENS), "--calibration_sequence_length",
                 str(SEARCH_SEQ), "--device", str(device)])
    finally:
        evopress.evo_press_search, evopress.compute_target_logits = search0, teacher0
        evopress.compute_fitness = fitness0
    secs["search"] = time.perf_counter() - t
    best, groups, available = seen["result"]
    model = seen["model"]
    cfg_path = hf_db / f"evo-sparse_kl-configuration-{SEARCH_BITS}.txt"
    chosen = evopress.parse_state_config(cfg_path)
    budget = sum(int(model.numel(n) * SEARCH_BITS) for g in groups for n in g)
    bits = evopress.calculate_total_bits(best, groups, model.numel)
    weights = sum(model.numel(n) for g in groups for n in g)
    types = sorted({f.split("-", 1)[1][:-len(".pth")] for _, f in chosen.values()})
    if bits > budget or types != ["Q4_K", "Q6_K"] or len(chosen) != 7 * GPTQ_LAYERS or any(
            not (hf_db / n / f).is_file() for n, (_, f) in chosen.items()):
        raise RuntimeError(f"search config: {bits} bits of a budget of {budget}, types {types}, "
                           f"{len(chosen)} lines")
    stamps = seen["stamps"]
    gens = [b - a for a, b in zip(stamps[1:], stamps[2:])]
    kl = {}
    for label, state in (("Q4_K", [[4.5] * len(g) for g in groups]),
                         ("Q6_K", [[6.5625] * len(g) for g in groups]), ("searched", best)):
        model.load_layers(groups, state, available)
        kl[label] = ppl_mod.compute_sparse_kl_div(model.params, model.cfg, seen["calib"],
                                                  seen["teacher"])
    log(f"search (sparse KL, {SEARCH_BITS} bits, {SEARCH_TOKENS} tokens in sequences of "
        f"{SEARCH_SEQ}) in {secs['search']:.1f} s: teacher logits {seen['teacher_s']:.2f} s, "
        f"{len(fit_s)} candidates scored in {np.mean(fit_s):.3f} s each (sum "
        f"{sum(fit_s):.1f}), the initial selection {stamps[1] - stamps[0]:.1f} s, "
        f"generations {[round(g, 1) for g in gens]} s; config {bits / weights:.4f} bits/weight "
        f"(budget {budget / weights:.4f}), "
        f"{sum(f.endswith('Q6_K.pth') for _, f in chosen.values())} of {len(chosen)} linears "
        f"at Q6_K; sparse KL on its {SEARCH_TOKENS} tokens: uniform Q4_K {kl['Q4_K']:.5f}, "
        f"uniform Q6_K {kl['Q6_K']:.5f}, searched {kl['searched']:.5f} (card "
        f"{card_name_and_power()})")
    if not kl["Q6_K"] < kl["Q4_K"]:
        raise RuntimeError(f"sparse KL: uniform Q6_K {kl['Q6_K']} not below Q4_K {kl['Q4_K']}")
    rec["search"] = dict(bits_per_weight=bits / weights, budget=budget / weights, kl=kl,
                         teacher_s=seen["teacher_s"], candidates=len(fit_s),
                         candidate_s=float(np.mean(fit_s)), generation_s=gens,
                         q6_linears=sum(f.endswith("Q6_K.pth") for _, f in chosen.values()))
    del model, seen
    torch.cuda.empty_cache()

    # 4. convert-config, stitch: the chosen bytes, the source's metadata and order
    stitch_cfg, mixed = tmp / "stitch.txt", tmp / "mixed.gguf"
    t = time.perf_counter()
    run_cli(["convert-config", "--input", str(cfg_path), "--output", str(stitch_cfg)])
    valid = run_cli(["stitch", "--split-dir", str(db / "layers-gguf"), "--config",
                     str(stitch_cfg), "--validate-only"])
    if valid[-1] != "configuration valid":
        raise RuntimeError(f"stitch --validate-only: {valid}")
    run_cli(["stitch", "--split-dir", str(db / "layers-gguf"), "--config", str(stitch_cfg),
             "--output", str(mixed)])
    secs["stitch"] = time.perf_counter() - t
    note_disk()
    t = time.perf_counter()
    level = {n: c.quant_type for n, c in GGUFStitcher(db / "layers-gguf", stitch_cfg)
             .config.items()}
    r, src = GGUFReader(mixed), readers["Q6_K"]  # the database's metadata is the last split's
    if r.tensor_order != src.tensor_order:
        raise RuntimeError("stitched tensor order is not the source's")
    for name in r.tensor_order:
        if (r.tensor_bytes(name).tobytes()
                != readers.get(level[name], readers["Q4_K"]).tensor_bytes(name).tobytes()):
            raise RuntimeError(f"stitched {name}: not the {level[name]} GGUF's bytes")
    keys = [k for k in src.metadata if k != "general.file_type"]
    if [k for k in r.metadata if k != "general.file_type"] != keys or any(
            r.metadata[k] != src.metadata[k] for k in keys):
        raise RuntimeError("stitched metadata differs from the source's")
    # the scored file is the dequantization of its level's GGUF tensor (the
    # build-db check) and the stitched tensor is that tensor's bytes (above):
    # so the scored model is the served one where the two name one level
    mapping = json.loads((hf_db / "hf_to_gguf_mapping.json").read_text())
    same = [fname.split("-", 1)[1][:-len(".pth")] == level[mapping[hf + ".weight"]]
            for hf, (_, fname) in chosen.items()]
    if not all(same):
        raise RuntimeError("a scored layers-hf tensor is not of the stitched tensor's level")
    secs["stitch_check"] = time.perf_counter() - t
    levels = {n: level[n] for n in r.tensor_order if n.startswith("blk.")
              and n.split(".")[2] in HF_KEYS}
    file_type, stitched_bytes = r.get("general.file_type"), mixed.stat().st_size
    log(f"  convert-config, stitch --validate-only and stitch in {secs['stitch']:.1f} s: "
        f"{len(r.tensors)} tensors ({stitched_bytes} bytes), each the bytes of the GGUF "
        f"its config picked, the source's metadata and order, general.file_type {file_type}; "
        f"the {len(same)} layers-hf tensors the search scored are of the stitched tensors' "
        f"levels, so their dequantization (checked in {secs['stitch_check']:.1f} s)")
    del r, src, readers
    # phase 12 reads the layers-hf database and its config, the stitched and
    # the Q4_K GGUF, and removes them
    shutil.rmtree(db / "layers-gguf")
    q6_gguf.unlink()

    # 5. serve the stitched GGUF
    per_forward = v2g_per_forward(levels)
    prompt = np.arange(1, 17, dtype=np.int64)
    kept, forwards = {}, [0]
    load0, fwd0 = qmodel.load_gguf_for_serving, qmodel.forward_cached

    def load_and_keep(*a, **kw):
        kept["params"], kept["cfg"] = load0(*a, **kw)
        return kept["params"], kept["cfg"]

    def counted_forward(*a, **kw):
        forwards[0] += 1
        return fwd0(*a, **kw)

    serve_argv = ["--prompt-tokens", *map(str, prompt), "--max-new-tokens", "6", "--max-len",
                  "64", "--num-slots", "1", "--device", str(device)]
    t = time.perf_counter()
    reset_matmul_counts()
    qmodel.load_gguf_for_serving, qmodel.forward_cached = load_and_keep, counted_forward
    try:
        lines = run_cli(["serve", "--gguf-file", str(mixed), *serve_argv])
    finally:
        qmodel.load_gguf_for_serving, qmodel.forward_cached = load0, fwd0
    secs["serve"] = time.perf_counter() - t
    launches = matmul_counts()["v2g"]
    toks = json.loads(lines[-1])
    if launches != per_forward * forwards[0] or len(toks) != 6:
        raise RuntimeError(f"serve: {launches} v2g launches over {forwards[0]} forwards, want "
                           f"{per_forward} a forward; tokens {toks}")
    params, cfg = kept.pop("params"), kept.pop("cfg")
    # the planes quantize_params_for_serving builds from the artifacts the config picked
    dense_cfg = loader.load_config(ckpt, dtype=torch.bfloat16)
    dense = loader.load_params(ckpt, dense_cfg)
    q6_layers = qmodel.quantize_params_for_serving(dense, dense_cfg, save6,
                                                   device=device)["layers"]
    del dense
    n_planes = 0
    for li in range(GPTQ_LAYERS):
        for comp, key in HF_KEYS.items():
            want_w = (v2_layers if levels[f"blk.{li}.{comp}.weight"] == "Q4_K"
                      else q6_layers)[li][key]
            g = params["layers"][li][key]
            for plane in ("qs", "d_sg", "dmin_sg", "sc_q", "mn_q"):
                a, b = getattr(g, plane), getattr(want_w, plane)
                if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                    raise RuntimeError(f"layer {li} {key}: stitched plane {plane} differs from "
                                       f"the {levels[f'blk.{li}.{comp}.weight']} artifact's")
            if (g.d_in, g.group_size, g.per_byte, g.shift, g.d_rep) != (
                    want_w.d_in, want_w.group_size, want_w.per_byte, want_w.shift,
                    want_w.d_rep):
                raise RuntimeError(f"layer {li} {key}: layout differs from the artifact's")
            n_planes += 1
    del q6_layers
    fused = qmodel.fuse_params_for_serving(params, cfg)
    # call by call: a prefill on the tensor-core tiles, a B=8 step on the decode tile
    calls = stitched_calls(fused, cfg, np.random.default_rng(SEED), device)
    (kcalls, k_mma, k_dec), (ccalls, _, _) = calls[False], calls[True]
    bad = [c for c in kcalls if not (c["finite"] and c["err"] <= c["tol"])]
    ctrl_bad = sum(not c["err"] <= c["tol"] for c in ccalls)
    q6_shapes = {c["shape"] for c in kcalls if c["gs"] == 16}
    want_q6 = {(w.d_out, w.d_in) for layer in fused["layers"] for w in layer.values()
               if isinstance(w, qmatmul.RuntimeQuantLinearV2) and w.group_size == 16}
    log(f"  stitched model call by call (8 x 16-token prefill, one B=8 step; "
        f"{per_forward} v2g calls a forward): {len(kcalls) - len(bad)} of {len(kcalls)} calls "
        f"within their limit (worst {max(c['err'] / c['tol_1e5'] for c in kcalls):.2f}x of "
        f"1e-5 of the terms; {sum(c['tile'] for c in kcalls)} prefill-tile calls held to "
        f"{PREFILL_TILE_LIMIT:g}), tensor-core launches {k_mma}, decode-tile launches {k_dec}; "
        f"control rejected at {ctrl_bad} of {len(ccalls)} calls; Q6_K shapes "
        f"{sorted(q6_shapes)}")
    if bad or ctrl_bad == 0 or len(kcalls) != 2 * per_forward or k_mma != per_forward \
            or k_dec != per_forward or not want_q6 <= q6_shapes:
        raise RuntimeError(f"stitched model call by call: {len(bad)} calls over the limit, "
                           f"control rejected at {ctrl_bad}, {len(kcalls)} calls, tensor-core "
                           f"{k_mma}, decode tile {k_dec}, Q6_K {q6_shapes} of {want_q6}")
    plain, gaps, flip = plain_tokens_and_gaps(fused, cfg, prompt, toks, device)
    del params, fused
    torch.cuda.empty_cache()
    log(f"  serve in {secs['serve']:.1f} s: tokens {toks} (plain versions: {plain}), "
        f"{launches} v2g launches = {per_forward} x {forwards[0]} forwards; the {n_planes} "
        f"projections' v2 planes equal to the chosen artifacts'; top-2 gap / max|logit| per "
        f"step {[round(g, 5) for g in gaps]}")
    if flip is not None and not gaps[flip] < NEAR_TIE:
        raise RuntimeError(f"serve: step {flip} differs from the plain versions' with a top-2 "
                           f"gap of {gaps[flip]:.2e} of max|logit|")

    # 6. gguf-split, serve from the first shard, --merge back
    t = time.perf_counter()
    shards = [line.split()[-1] for line in run_cli(
        ["gguf-split", "--input", str(mixed), "--output", str(tmp / "mixed-split"),
         "--split-max-tensors", "8"])]
    note_disk()
    shard_toks = json.loads(run_cli(["serve", "--gguf-file", shards[0], *serve_argv])[-1])
    run_cli(["gguf-split", "--merge", "--input", shards[0], "--output",
             str(tmp / "merged.gguf")])
    note_disk()
    merged_same = filecmp.cmp(tmp / "merged.gguf", mixed, shallow=False)
    secs["split_serve_merge"] = time.perf_counter() - t
    log(f"  gguf-split --split-max-tensors 8: {len(shards)} shards; serve from the first: "
        f"{shard_toks}; --merge gives back the stitched file byte for byte: {merged_same} "
        f"({secs['split_serve_merge']:.1f} s)")
    if shard_toks != toks or not merged_same or len(shards) != -(-(3 + 9 * GPTQ_LAYERS) // 8):
        raise RuntimeError(f"split / merge: shard tokens {shard_toks}, merged equal "
                           f"{merged_same}, {len(shards)} shards")
    for p in shards + [tmp / "merged.gguf"]:
        Path(p).unlink()

    # 7. perplexity through the serving path
    t = time.perf_counter()
    run_cli(["ppl", "--gguf-file", str(mixed), "--gguf-path", "serving", "--datasets",
             "synthetic", "--eval_tokens", str(2 * 512), "--sequence_length", "512",
             "--device", str(device), "--output_path", str(tmp / "ppl_mixed.json")])
    ppl = json.loads((tmp / "ppl_mixed.json").read_text())["synthetic"]
    secs["ppl"] = time.perf_counter() - t
    if not np.isfinite(ppl):
        raise RuntimeError(f"ppl of the stitched GGUF: {ppl}")
    secs["step"] = time.perf_counter() - t_step
    log(f"  ppl (serving, 2 x 512 synthetic tokens) {ppl:.4f} in {secs['ppl']:.1f} s; the step "
        f"took {secs['step']:.1f} s, peak disk use {peak[0]} bytes in the temporary directory "
        f"(card {card_name_and_power()})")
    return dict(rec, q6_solve_launches=q6_launches, q6_gguf_bytes=q6_bytes,
                stitched_bytes=stitched_bytes, file_type=file_type,
                v2g_per_forward=per_forward, v2g_launches=launches, tokens=toks,
                plain_tokens=plain, gaps=gaps, first_difference=flip,
                call_by_call=dict(calls=len(kcalls), control_rejected=ctrl_bad,
                                  worst_vs_1e5=max(c["err"] / c["tol_1e5"] for c in kcalls)),
                shards=len(shards), ppl=ppl, peak_disk_bytes=peak[0], seconds=secs)


# ---------------------------------------------------------------------------
# Phase 10: stage 1's llama-quantize route (imatrix, recipes, rtn-quantize)
# ---------------------------------------------------------------------------

IMATRIX_TOKENS, IMATRIX_SEQ = 16384, 512
# the layer-0 q/k/v importance vector against a float64 host computation
# of its input (input_layernorm of the embedding): f32 norms, f32 sums of
# 512 squares and a 32-step f32 EMA, each at most ~1e-6 of the value
IMATRIX_F64_RTOL = 1e-4
# tensor bytes of the 2-layer checkpoint's files: 1,486,880,768 bf16 weights
# plus 20,480 f32 norm values; the two recipes of it
BF16_TENSOR_BYTES = 2_973_843_456
RECIPE_BYTES = {"Q4_K_M": 988_110_848, "Q3_K_M": 858_603_520}
RECIPE_BITS = {"Q4_K_M": 7_904_886_784}  # 5.316 bits over 1,486,901,248 elements
N_ELEMENTS = 1_486_901_248
IMATRIX_HELPS = 1.001  # imatrix fit's weighted error over the plain fit's, at most
GGUF_LINEARS = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up", "ffn_down")


def recipe_levels(r) -> dict:
    """GGUF block linear -> its type name, of a recipe file."""
    return {f"blk.{li}.{c}.weight": r.tensors[f"blk.{li}.{c}.weight"].ggml_type.name
            for li in range(GPTQ_LAYERS) for c in GGUF_LINEARS}


def check_recipe_file(path: Path, ftype: str, t_cli: float, times: dict) -> dict:
    """The types recipe_tensor_type gives every tensor, general.file_type,
    the tensor bytes and the summary's bits per weight."""
    from gptq_gguf_tpu_torch.formats.gguf import GGUFReader
    from gptq_gguf_tpu_torch.quant import recipes, rtn

    r = GGUFReader(path)
    types = {n: r.tensors[n].ggml_type.name for n in r.tensor_order}
    want = {n: recipes.recipe_tensor_type(ftype, n, int(n.split(".")[1]) if n.startswith("blk.")
                                          else 0, GPTQ_LAYERS, N_HEAD // N_KV).name
            if recipes._is_quantizable(n, r.tensors[n].shape) else "F32" for n in r.tensor_order}
    summary = rtn.quantization_summary(path)
    counts = {k: v["tensors"] for k, v in sorted(summary["types"].items())}
    log(f"  llama-quantize --ftype {ftype} --imatrix in {t_cli:.1f} s (host reads "
        f"{times.get('read', 0):.1f} s, card fits {times.get('fit', 0):.1f} s, host packing "
        f"{times.get('pack', 0):.1f} s, writing {times.get('write', 0):.1f} s): "
        f"{summary['tensor_bytes']} tensor bytes, {summary['bits_per_weight']:.4f} bits per "
        f"weight ({summary['tensor_bytes'] * 8} bits over {summary['total_elements']} "
        f"elements), tensors by type {counts}, general.file_type "
        f"{r.get('general.file_type')} (card {card_name_and_power()})")
    if types != want or r.get("general.file_type") != recipes.FTYPE_IDS[ftype]:
        bad = {n: (types[n], want[n]) for n in types if types[n] != want[n]}
        raise RuntimeError(f"{ftype}: types {bad} differ from the recipe's, file_type "
                           f"{r.get('general.file_type')}")
    if summary["tensor_bytes"] != RECIPE_BYTES[ftype] or summary["total_elements"] != N_ELEMENTS:
        raise RuntimeError(f"{ftype}: {summary['tensor_bytes']} tensor bytes, want "
                           f"{RECIPE_BYTES[ftype]}")
    if ftype in RECIPE_BITS and (summary["tensor_bytes"] * 8 != RECIPE_BITS[ftype]
                                 or round(summary["bits_per_weight"], 3) != 5.316):
        raise RuntimeError(f"{ftype}: {summary['bits_per_weight']} bits per weight")
    return dict(seconds=t_cli, stages=dict(times), tensor_bytes=summary["tensor_bytes"],
                bits_per_weight=summary["bits_per_weight"], tensors_by_type=counts)


def llama_quantize_on_card(src: Path, out: Path, ftype: str, imatrix_path: Path, device):
    """``llama-quantize --imatrix`` through the command line, its stages
    timed (recipes.llama_quantize's stage_times) and every K-quant fit
    held to the card; returns (seconds, stages, fits)."""
    import torch

    from gptq_gguf_tpu_torch.ops import kquant
    from gptq_gguf_tpu_torch.quant import recipes

    times, fits = {}, []
    lq0, fit0 = recipes.llama_quantize, kquant.quantize_rtn

    def timed(*a, **kw):
        return lq0(*a, **kw, stage_times=times)

    def on_card(x, *a, **kw):
        fits.append(x.device.type)
        return fit0(x, *a, **kw)

    recipes.llama_quantize, kquant.quantize_rtn = timed, on_card
    t = time.perf_counter()
    try:
        run_cli(["llama-quantize", "--input", str(src), "--output", str(out), "--ftype", ftype,
                 "--imatrix", str(imatrix_path), "--device", str(device)])
    finally:
        recipes.llama_quantize, kquant.quantize_rtn = lq0, fit0
    torch.cuda.synchronize()
    if not fits or set(fits) != {torch.device(device).type}:
        raise RuntimeError(f"{ftype}: K-quant fits ran on {sorted(set(fits))}")
    return time.perf_counter() - t, times, len(fits)


def serve_recipe(path: Path, per_forward: int, tokens: int, device, packed_head: bool = True,
                 keep=None) -> dict:
    """``serve`` of a recipe GGUF from 16 prompt tokens: v2g launches per
    forward as its types imply; every v2g call of an 8 x 16-token prefill
    and of a B=8 decode step held call by call with the planted control
    (stitched_calls: the projections of the prefill on the tensor-core
    tiles, a packed head's 8 rows and every call of the step on the decode
    tile); greedy tokens against the plain versions' up to a near-tie.
    ``keep``: a dict that receives the fused params and config the command
    loaded (else they are freed)."""
    import torch

    from gptq_gguf_tpu_torch.serving import model as qmodel

    prompt = np.arange(1, 17, dtype=np.int64)
    kept, forwards = {}, [0]
    load0, fwd0 = qmodel.load_gguf_for_serving, qmodel.forward_cached

    def load_and_keep(*a, **kw):
        kept["params"], kept["cfg"] = load0(*a, **kw)
        return kept["params"], kept["cfg"]

    def counted_forward(*a, **kw):
        forwards[0] += 1
        return fwd0(*a, **kw)

    t = time.perf_counter()
    reset_matmul_counts()
    qmodel.load_gguf_for_serving, qmodel.forward_cached = load_and_keep, counted_forward
    try:
        lines = run_cli(["serve", "--gguf-file", str(path), "--prompt-tokens",
                         *map(str, prompt), "--max-new-tokens", str(tokens), "--max-len", "64",
                         "--num-slots", "1", "--device", str(device)])
    finally:
        qmodel.load_gguf_for_serving, qmodel.forward_cached = load0, fwd0
    serve_s = time.perf_counter() - t
    launches = matmul_counts()["v2g"]
    toks = json.loads(lines[-1])
    if launches != per_forward * forwards[0] or len(toks) != tokens:
        raise RuntimeError(f"serve {path.name}: {launches} v2g launches over {forwards[0]} "
                           f"forwards, want {per_forward} a forward; tokens {toks}")
    params, cfg = kept.pop("params"), kept.pop("cfg")
    fused = qmodel.fuse_params_for_serving(params, cfg)
    calls = stitched_calls(fused, cfg, np.random.default_rng(SEED), device)
    (kcalls, k_mma, k_dec), (ccalls, _, _) = calls[False], calls[True]
    bad = [c for c in kcalls if not (c["finite"] and c["err"] <= c["tol"])]
    ctrl_bad = sum(not c["err"] <= c["tol"] for c in ccalls)
    shapes = sorted({(c["shape"], c["gs"]) for c in kcalls})
    # a packed head runs at the prefill's 8 last rows: the decode tile
    if bad or ctrl_bad == 0 or len(kcalls) != 2 * per_forward \
            or k_mma != per_forward - packed_head or k_dec != per_forward + packed_head:
        raise RuntimeError(f"{path.name} call by call: {len(bad)} calls over the limit, control "
                           f"rejected at {ctrl_bad}, {len(kcalls)} calls, tensor-core {k_mma}, "
                           f"decode tile {k_dec}")
    plain, gaps, flip = plain_tokens_and_gaps(fused, cfg, prompt, toks, device)
    if keep is not None:
        keep.update(params=fused, cfg=cfg)
    del params, fused
    torch.cuda.empty_cache()
    worst = max(c["err"] / c["tol_1e5"] for c in kcalls)
    log(f"  serve {path.name} in {serve_s:.1f} s: tokens {toks} (plain versions: {plain}), "
        f"{launches} v2g launches = {per_forward} a forward x {forwards[0]}; call by call "
        f"(8 x 16-token prefill, one B=8 step): {len(kcalls)} calls within their limit (worst "
        f"{worst:.2f}x of 1e-5 of the terms), tensor-core launches {k_mma}, decode-tile "
        f"launches {k_dec}, control rejected at {ctrl_bad} of {len(ccalls)} calls; shapes "
        f"(d_out, d_in, group size) {[(*s, g) for s, g in shapes]}; top-2 gap / max|logit| per "
        f"step {[round(g, 5) for g in gaps]} (card {card_name_and_power()})")
    if flip is not None and not gaps[flip] < NEAR_TIE:
        raise RuntimeError(f"serve {path.name}: step {flip} differs from the plain versions' "
                           f"with a top-2 gap of {gaps[flip]:.2e} of max|logit|")
    return dict(seconds=serve_s, v2g_per_forward=per_forward, v2g_launches=launches,
                forwards=forwards[0], tokens=toks, plain_tokens=plain, first_difference=flip,
                gaps=gaps, call_by_call=dict(calls=len(kcalls), mma=k_mma, decode=k_dec,
                                             control_rejected=ctrl_bad, worst_vs_1e5=worst),
                shapes=[[*s, g] for s, g in shapes])


def phase_recipes(tmp: Path, device) -> dict:
    """10, in phase 5's temporary directory, on its 2-layer Llama-3-8B-width
    checkpoint: (a) ``imatrix`` of IMATRIX_TOKENS synthetic tokens as a
    llama.cpp .imatrix (layer 0's q/k/v vector against a float64 host
    computation, the file read back exactly); (b) ``pack --outtype bf16``
    with no artifacts (its tensor bytes); (c) ``llama-quantize --ftype
    Q4_K_M --imatrix`` with the K-quant fits on the card (the recipe's
    types, bytes and bits per weight); ``rtn-quantize --quant_type Q4_K
    --imatrix`` of the checkpoint, layer 0's artifacts packed equal to the
    recipe file's tensors byte for byte; quantize_tensor_blocks of a Q6_K
    and a Q4_K tensor on the card and on the CPU, equal; every linear's
    imatrix-weighted error of the imatrix fit at most IMATRIX_HELPS times
    the plain fit's; (d) the Q4_K_M file served (serve_recipe); (e)
    ``llama-quantize --ftype Q3_K_M --imatrix``, served."""
    import torch

    from gptq_gguf_tpu_torch.export.packer import hf_to_gguf_name
    from gptq_gguf_tpu_torch.formats import convert, ggml, safetensors
    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.formats.gguf import GGUFReader
    from gptq_gguf_tpu_torch.ops import kquant
    from gptq_gguf_tpu_torch.quant import artifacts, recipes, rtn
    from gptq_gguf_tpu_torch.quant.imatrix_io import load_imatrix
    from gptq_gguf_tpu_torch.utils.data import get_data

    t_phase = time.perf_counter()
    ckpt, rec, secs = tmp / "ckpt", {}, {}
    card = card_name_and_power()
    data = ["--calibration_data", "synthetic", "--calibration_tokens", str(IMATRIX_TOKENS),
            "--calibration_sequence_length", str(IMATRIX_SEQ)]

    # (a) the importance vectors, kept in memory as computed
    computed = []
    imatrix0 = rtn.compute_imatrix

    def kept_imatrix(*a, **kw):
        computed.append(imatrix0(*a, **kw))
        return computed[-1]

    im_path = tmp / "model.imatrix"
    rtn.compute_imatrix = kept_imatrix
    t = time.perf_counter()
    try:
        run_cli(["imatrix", "--model_name_or_path", str(ckpt), *data, "--output", str(im_path),
                 "--device", str(device)])
    finally:
        rtn.compute_imatrix = imatrix0
    secs["imatrix"] = time.perf_counter() - t
    loaded, ncalls, dataset = load_imatrix(im_path)
    want_keys = [hf_to_gguf_name(n + ".weight") for n in computed[0]]
    exact = list(loaded) == want_keys and all(
        np.array_equal(loaded[g], computed[0][n]) for g, n in zip(want_keys, computed[0]))
    # layer 0's q/k/v input: input_layernorm of the embedding, in float64
    hdr = {n: t_ for n, t_ in safetensors.iter_file(
        ckpt / "model.safetensors",
        ["model.embed_tokens.weight", "model.layers.0.input_layernorm.weight"])}
    emb = hdr["model.embed_tokens.weight"].double().numpy()
    norm_w = hdr["model.layers.0.input_layernorm.weight"].double().numpy()
    calib = get_data("synthetic", IMATRIX_TOKENS, IMATRIX_SEQ, vocab_size=V)
    acc = np.zeros(H)
    for ids in calib:
        x = emb[ids[0]]
        h = x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-5) * norm_w
        acc += (h * h).sum(0)
    ref = acc / len(calib)
    got = loaded["blk.0.attn_q.weight"]
    rel = float(np.max(np.abs(got - ref) / ref))
    same_qkv = all(np.array_equal(loaded[f"blk.0.{c}.weight"], got) for c in ("attn_k", "attn_v"))
    log(f"imatrix ({IMATRIX_TOKENS} synthetic tokens in sequences of {IMATRIX_SEQ}) in "
        f"{secs['imatrix']:.2f} s: {len(loaded)} vectors (ncall {sorted(set(ncalls.values()))}, "
        f"dataset {dataset!r}), read back exactly: {exact}; layer 0's q/k/v vector within "
        f"{rel:.3e} of the float64 host computation (limit {IMATRIX_F64_RTOL:g}) (card {card})")
    if not exact or len(loaded) != 7 * GPTQ_LAYERS or not same_qkv or not rel <= IMATRIX_F64_RTOL:
        raise RuntimeError(f"imatrix: read back exactly {exact}, {len(loaded)} vectors, q/k/v "
                           f"shared {same_qkv}, layer 0 {rel:.3e} from float64")
    rec["imatrix"] = dict(seconds=secs["imatrix"], vectors=len(loaded), f64_rel=rel)
    del emb, hdr

    # (b) the float GGUF
    (tmp / "no-artifacts").mkdir()
    src = tmp / "model-bf16.gguf"
    t = time.perf_counter()
    run_cli(["pack", "--model_dir", str(ckpt), "--quant_dir", str(tmp / "no-artifacts"),
             "--outfile", str(src), "--outtype", "bf16"])
    secs["pack_bf16"] = time.perf_counter() - t
    f_sum = rtn.quantization_summary(src)
    log(f"  pack --outtype bf16 (no artifacts) in {secs['pack_bf16']:.2f} s: "
        f"{f_sum['tensor_bytes']} tensor bytes, types {sorted(f_sum['types'])} (card {card})")
    if f_sum["tensor_bytes"] != BF16_TENSOR_BYTES or set(f_sum["types"]) != {"BF16", "F32"}:
        raise RuntimeError(f"bf16 GGUF: {f_sum['tensor_bytes']} tensor bytes, types "
                           f"{f_sum['types']}")
    rec["bf16_gguf"] = dict(seconds=secs["pack_bf16"], tensor_bytes=f_sum["tensor_bytes"])

    # (c) the Q4_K_M recipe with the imatrix, its K-quant fits on the card
    q4km = tmp / "model-Q4_K_M.gguf"
    t_cli, times, n_fits = llama_quantize_on_card(src, q4km, "Q4_K_M", im_path, device)
    rec["Q4_K_M"] = dict(check_recipe_file(q4km, "Q4_K_M", t_cli, times), fits=n_fits)
    r = GGUFReader(q4km)
    levels = recipe_levels(r)
    if not (all(levels[f"blk.0.{c}.weight"] == "Q4_K" for c in GGUF_LINEARS)
            and levels["blk.1.attn_v.weight"] == levels["blk.1.ffn_down.weight"] == "Q6_K"):
        raise RuntimeError(f"Q4_K_M levels {levels}")

    # the two routes: rtn-quantize's layer-0 artifacts packed = the recipe's tensors
    rtn_dir = tmp / "rtn-layers"
    computed.clear()
    rtn.compute_imatrix = kept_imatrix
    t = time.perf_counter()
    try:
        run_cli(["rtn-quantize", "--model_name_or_path", str(ckpt), *data, "--quant_type", "Q4_K",
                 "--imatrix", "--save_dir", str(rtn_dir), "--device", str(device)])
    finally:
        rtn.compute_imatrix = imatrix0
    secs["rtn_quantize"] = time.perf_counter() - t
    same_im = all(np.array_equal(computed[0][n], loaded[hf_to_gguf_name(n + ".weight")])
                  for n in computed[0])
    equal = []
    for comp, key in HF_KEYS.items():
        gname = f"blk.0.{comp}.weight"
        mod = "self_attn" if key[0] in "qkvo" else "mlp"
        art = artifacts.load_layer(rtn_dir, f"model.layers.0.{mod}.{key}")
        perm = np.arange(art.qweight.shape[0])
        if comp in ("attn_q", "attn_k"):
            perm = convert.gqa_permute_rows(art.qweight.shape[0],
                                            N_HEAD if comp == "attn_q" else N_KV)
        blocks = convert.pack_layer(art.qweight[perm], art.super_group_scale[perm],
                                    art.group_scale_quant[perm], art.super_group_zero[perm],
                                    art.group_zero_quant[perm], art.q_type)
        equal.append(blocks.tobytes() == np.asarray(r.tensor_bytes(gname)).tobytes())
    log(f"  rtn-quantize --quant_type Q4_K --imatrix in {secs['rtn_quantize']:.1f} s (its "
        f"imatrix equal to the file's: {same_im}): layer 0's {len(equal)} artifacts packed "
        f"(q / k rows permuted) equal to the Q4_K_M file's tensors byte for byte: "
        f"{sum(equal)} of {len(equal)} (card {card})")
    if not same_im or not all(equal):
        raise RuntimeError(f"routes: imatrix equal {same_im}, tensors equal {equal}")
    shutil.rmtree(rtn_dir)

    # card against CPU: the same tensor's blocks from both devices
    device_rec = {}
    for name, qtype in (("blk.1.attn_v.weight", T.Q6_K), ("blk.0.attn_k.weight", T.Q4_K)):
        w = GGUFReader(src).tensor_float(name)
        im = loaded[name]
        t = time.perf_counter()
        on_card = recipes.quantize_tensor_blocks(w, qtype, im, device=device)
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        on_cpu = recipes.quantize_tensor_blocks(w, qtype, im, device="cpu")
        cpu_s = time.perf_counter() - t
        differ = int((on_card != on_cpu).any(axis=1).sum())
        device_rec[name] = dict(differing_superblocks=differ, superblocks=len(on_card),
                                card_s=card_s, cpu_s=cpu_s,
                                recipe_equal=on_card.tobytes() == np.asarray(
                                    r.tensor_bytes(name)).tobytes())
        log(f"  quantize_tensor_blocks {name} ({qtype.name}, {w.shape}) card vs CPU: "
            f"{differ} of {len(on_card)} super-blocks differ (card {card_s:.2f} s, CPU "
            f"{cpu_s:.2f} s); the card's equal to the recipe file's: "
            f"{device_rec[name]['recipe_equal']} (card {card})")
        if differ or not device_rec[name]["recipe_equal"]:
            raise RuntimeError(f"{name}: card and CPU fits differ in {differ} super-blocks")
    rec["card_vs_cpu"] = device_rec

    # the imatrix helps: weighted error of the recipe's fit against a plain fit
    ratios = {}
    t = time.perf_counter()
    for name in levels:
        info = r.tensors[name]
        w = torch.from_numpy(GGUFReader(src).tensor_float(name)).to(device)
        im = torch.from_numpy(loaded[name]).to(device)
        w_im = torch.from_numpy(ggml.dequantize(np.asarray(r.tensor_bytes(name)), info.ggml_type,
                                                info.shape)).to(device)
        q, p = kquant.quantize_rtn(w, info.ggml_type)
        w_plain = kquant.dequantize(q, p, info.ggml_type)

        def werr(y):
            return float((((y - w) ** 2).double().sum(0) * im.double()).sum())

        ratios[name] = werr(w_im) / werr(w_plain)
        del w, w_im, w_plain, q, p
    secs["imatrix_helps"] = time.perf_counter() - t
    worst = max(ratios, key=ratios.get)
    log(f"  imatrix-weighted squared error, imatrix fit over plain fit, per linear: "
        f"{ {n: round(v, 5) for n, v in ratios.items()} } (worst {worst} {ratios[worst]:.5f}, "
        f"limit {IMATRIX_HELPS}; {secs['imatrix_helps']:.1f} s; card {card})")
    if not all(v <= IMATRIX_HELPS for v in ratios.values()):
        raise RuntimeError(f"imatrix fit worse than plain: {ratios}")
    rec["Q4_K_M"]["imatrix_over_plain"] = ratios
    del r
    torch.cuda.empty_cache()

    # (d) serve the Q4_K_M file
    rec["Q4_K_M"]["serve"] = serve_recipe(q4km, v2g_per_forward(levels, packed_head=True), 6,
                                          device)
    q4km.unlink()

    # (e) the Q3_K_M recipe, served
    q3km = tmp / "model-Q3_K_M.gguf"
    t_cli, times, n_fits = llama_quantize_on_card(src, q3km, "Q3_K_M", im_path, device)
    rec["Q3_K_M"] = dict(check_recipe_file(q3km, "Q3_K_M", t_cli, times), fits=n_fits)
    levels3 = recipe_levels(GGUFReader(q3km))
    if not {"Q3_K", "Q4_K", "Q5_K"} <= set(levels3.values()) \
            or levels3["blk.0.attn_v.weight"] != "Q5_K":
        raise RuntimeError(f"Q3_K_M levels {levels3}")
    src.unlink()
    rec["Q3_K_M"]["serve"] = serve_recipe(q3km, v2g_per_forward(levels3, packed_head=True), 8,
                                          device)
    q3km.unlink()
    im_path.unlink()
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 10 took {rec['seconds']:.1f} s (card {card})")
    return rec


# ---------------------------------------------------------------------------
# Phase 11: the qwen3 and qwen2 families, checkpoint to served tokens
# ---------------------------------------------------------------------------

# the published configs (Qwen/Qwen3-8B and Qwen/Qwen2.5-7B config.json),
# their depth cut to FAMILY_LAYERS when written (the layers repeat one
# shape; the embedding and head are the cost)
FAMILY_LAYERS = 1
QWEN3_8B = dict(model_type="qwen3", architectures=["Qwen3ForCausalLM"], vocab_size=151936,
                hidden_size=4096, intermediate_size=12288, num_hidden_layers=36,
                num_attention_heads=32, num_key_value_heads=8, head_dim=128,
                max_position_embeddings=40960, rope_theta=1000000.0, rms_norm_eps=1e-6,
                tie_word_embeddings=False, attention_bias=False, hidden_act="silu")
QWEN25_7B = dict(model_type="qwen2", architectures=["Qwen2ForCausalLM"], vocab_size=152064,
                 hidden_size=3584, intermediate_size=18944, num_hidden_layers=28,
                 num_attention_heads=28, num_key_value_heads=4,
                 max_position_embeddings=131072, rope_theta=1000000.0, rms_norm_eps=1e-6,
                 tie_word_embeddings=False, sliding_window=131072, use_sliding_window=False,
                 max_window_layers=28, hidden_act="silu")
# 11a's calibration set: four sequences of CALIB_SEQ (phase 5's synthetic data)
FAMILY_CALIB_TOKENS = 16384
# v2g calls of one forward, from the fusion rule: qwen3 q/k/v fused (1), o,
# gate/up fused (1), down, and its Q4_K head; qwen2 q/k/v apart (3: its
# biases), o, gate/up, down, its head dense (bf16); phase 5 served 8 (its
# head dense)
FAMILY_V2G_PER_FORWARD = {"qwen3": 4 * FAMILY_LAYERS + 1, "qwen2": 6 * FAMILY_LAYERS}
FAMILY_TOKENS = 6       # greedy tokens of each ``serve``
FAMILY_REQUESTS = 4     # requests on the contiguous and the paged engine


def family_solves_of(hf: dict):
    """(name, rows, column blocks) of a layer's block solves at ``hf``'s
    widths, as phase 5's SOLVE_SHAPES: q/k/v and gate/up row-concatenated
    (Qwen2.5-7B: 3584 + 512 + 512 and 2 x 18944 rows over 28 blocks), o,
    down over intermediate / BLOCK blocks (148)."""
    h, inter = hf["hidden_size"], hf["intermediate_size"]
    nh, nkv = hf["num_attention_heads"], hf["num_key_value_heads"]
    hd = hf.get("head_dim") or h // nh
    return (("qkv", (nh + 2 * nkv) * hd, h // BLOCK), ("o", h, nh * hd // BLOCK),
            ("gateup", 2 * inter, h // BLOCK), ("down", h, inter // BLOCK))


def write_family_checkpoint(path: Path, hf: dict, device) -> None:
    """A seeded checkpoint of ``hf``'s widths and FAMILY_LAYERS layers, bf16
    weights of std 0.02 as write_checkpoint's; qwen2's q / k / v biases
    (std 0.5) and qwen3's q / k norm weights (1 + 0.1 x normal) drawn, so
    that both are exercised."""
    import torch

    from gptq_gguf_tpu_torch.formats import safetensors

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 11)

    def rnd(*shape, std=0.02, mean=0.0):
        return (mean + torch.randn(shape, generator=gen, device=device) * std
                ).to(torch.bfloat16).cpu()

    h, inter, vocab = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    nh, nkv = hf["num_attention_heads"], hf["num_key_value_heads"]
    hd = hf.get("head_dim") or h // nh
    ones = torch.ones(h, dtype=torch.bfloat16)
    t = {"model.embed_tokens.weight": rnd(vocab, h), "model.norm.weight": ones,
         "lm_head.weight": rnd(vocab, h)}
    for i in range(FAMILY_LAYERS):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": ones, p + "post_attention_layernorm.weight": ones,
                  p + "self_attn.q_proj.weight": rnd(nh * hd, h),
                  p + "self_attn.k_proj.weight": rnd(nkv * hd, h),
                  p + "self_attn.v_proj.weight": rnd(nkv * hd, h),
                  p + "self_attn.o_proj.weight": rnd(h, nh * hd),
                  p + "mlp.gate_proj.weight": rnd(inter, h), p + "mlp.up_proj.weight": rnd(inter, h),
                  p + "mlp.down_proj.weight": rnd(h, inter)})
        if hf["model_type"] == "qwen2":
            for k, n in (("q", nh), ("k", nkv), ("v", nkv)):
                t[p + f"self_attn.{k}_proj.bias"] = rnd(n * hd, std=0.5)
        if hf["model_type"] == "qwen3":
            t[p + "self_attn.q_norm.weight"] = rnd(hd, std=0.1, mean=1.0)
            t[p + "self_attn.k_norm.weight"] = rnd(hd, std=0.1, mean=1.0)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(dict(hf, num_hidden_layers=FAMILY_LAYERS,
                                                      torch_dtype="bfloat16")))
    safetensors.write_safetensors(t, path / "model.safetensors")
    write_tokenizer(path, vocab)


def family_engines(params, cfg, rng, device) -> dict:
    """FAMILY_REQUESTS greedy requests on the contiguous engine and on the
    paged engine (bf16 pool): every request's tokens equal, or the first
    difference at a near-tie of the contiguous stream (NEAR_TIE of
    max|logit|); the paged kernel launched once a layer and decode step."""
    import torch

    from gptq_gguf_tpu_torch.ops import paged_attention as pa
    from gptq_gguf_tpu_torch.serving import engine, model as qmodel

    requests = serve_requests(rng, cfg, FAMILY_REQUESTS, 16, 65, 8, 9)
    out, steps = {}, [0]
    step0 = engine._paged_decode_step

    def counted_step(*a, **kw):
        steps[0] += 1
        return step0(*a, **kw)

    for label in ("contiguous", "paged"):
        if label == "paged":
            eng = engine.PagedContinuousBatchingEngine(params, cfg, num_slots=FAMILY_REQUESTS,
                                                       max_len=128, page_size=64, device=device)
        else:
            eng = engine.ContinuousBatchingEngine(params, cfg, num_slots=FAMILY_REQUESTS,
                                                  max_len=128)
        uids = [eng.submit(p, max_new_tokens=n) for p, n in requests]
        pa.paged_flash_decode.launches = 0
        engine._paged_decode_step = counted_step
        t = time.perf_counter()
        try:
            done = {r.uid: r.output for r in eng.run_until_done()}
        finally:
            engine._paged_decode_step = step0
        out[label] = dict(seconds=time.perf_counter() - t,
                          tokens=[list(map(int, done[u])) for u in uids])
        del eng
    launches = pa.paged_flash_decode.launches
    if not steps[0] or launches != cfg.num_hidden_layers * steps[0]:
        raise RuntimeError(f"paged engine: {launches} paged-kernel launches over {steps[0]} "
                           f"decode steps, want {cfg.num_hidden_layers} a step")
    flips = []
    for (prompt, n), a, b in zip(requests, out["contiguous"]["tokens"], out["paged"]["tokens"]):
        if len(a) != n or len(b) != n or not all(0 <= x < cfg.vocab_size for x in a + b):
            raise RuntimeError(f"engines: {len(a)} / {len(b)} tokens of {n}, or out of range")
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            continue
        ids = torch.as_tensor(np.concatenate([prompt, a[:t]]), device=device)[None]
        cache = qmodel.init_cache(cfg, 1, 128, device=device)
        with torch.no_grad():
            logits, _ = qmodel.forward_cached(params, cfg, ids, cache)
        top2 = torch.topk(logits[0].float(), 2).values
        gap = float(top2[0] - top2[1]) / float(logits.abs().max())
        flips.append((t, gap))
        if not gap < NEAR_TIE:
            raise RuntimeError(f"paged and contiguous tokens differ at step {t}, top-2 gap "
                               f"{gap:.2e} of max|logit|")
    log(f"  engines, {FAMILY_REQUESTS} greedy requests: contiguous "
        f"{out['contiguous']['seconds']:.2f} s, paged {out['paged']['seconds']:.2f} s "
        f"({launches} paged-kernel launches over {steps[0]} decode steps); tokens equal"
        + (f" but at near-ties {flips}" if flips else "")
        + f" (card {card_name_and_power()})")
    return dict(out, paged_launches=launches, decode_steps=steps[0], near_tie_flips=flips)


def family_solves(rng, device) -> dict:
    """The solve kernel at Qwen2.5-7B's block shapes against its plain
    version (Q4_K, bit-equal), and the blocked solve of a down projection
    over one 18944-column Hessian factor (148 blocks) through both: codes
    and scales equal. The factor comes from the card (the walk factorizes
    above gptq.HOST_FACTORIZE_THRESHOLD columns on the host, in f64: ~20 s
    at this width, which the check does not need)."""
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import KQUANT_SPECS, GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.ops import gptq, kquant

    U_full = solve_factor(rng, device)
    for name, d_row, _ in family_solves_of(QWEN25_7B):
        args = solve_inputs(rng, u_block(U_full, BLOCK), d_row, T.Q4_K, device)
        qk, ek = gptq.solve_block(*args)
        qp, ep = gptq.solve_block_reference(*args)
        if not (torch.equal(qk, qp) and torch.equal(ek, ep)):
            raise RuntimeError(f"gptq_solve {name} ({d_row} rows) at Qwen2.5-7B width: kernel "
                               "and plain differ")
    del U_full
    h, inter = QWEN25_7B["hidden_size"], QWEN25_7B["intermediate_size"]
    W = torch.as_tensor(rng.normal(size=(h, inter)) * 0.02, dtype=torch.float32, device=device)
    X = torch.as_tensor(rng.normal(size=(2048, inter)), dtype=torch.float32, device=device)
    cfg = gptq.GPTQConfig()
    W32, Hd = gptq._mask_and_damp(2.0 * X.T @ X / X.shape[0], W, cfg.rel_damp)
    del X
    t = time.perf_counter()
    U, bad = gptq.factorize_hinv_cholesky(Hd, "device")
    torch.cuda.synchronize()
    fact_s = time.perf_counter() - t
    spec = KQUANT_SPECS[T.Q4_K]
    cols = torch.arange(inter, device=device)
    runs = {}
    for label, fn in (("kernel", gptq.solve_block), ("plain", gptq.solve_block_reference)):
        solve0 = gptq.solve_block
        gptq.solve_block, launches0 = fn, solve0.launches
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            q, p = gptq._solve_with_init(W32.clone(), U, cols // spec.group_size,
                                         cols // spec.super_group_size, T.Q4_K, cfg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        finally:
            gptq.solve_block = solve0
        runs[label] = (q, p, secs, solve0.launches - launches0)
    (qk, pk, sk, n), (qp, pp, sp, _) = runs["kernel"], runs["plain"]
    equal = torch.equal(qk, qp) and all(torch.equal(a, b) for a, b in zip(pk, pp))
    obj = h_objective(W32 - kquant.dequantize(qk, pk, T.Q4_K), Hd)
    log(f"  solve kernel at Qwen2.5-7B's four block shapes bit-equal to its plain version; "
        f"down ({h}x{inter}) over one {inter}-column factor (device factorization "
        f"{fact_s:.2f} s): {n} launches, kernel {sk:.3f} s, plain {sp:.3f} s, codes and "
        f"scales equal: {equal}, objective {obj:.6e}")
    if bad or n != inter // BLOCK or not equal or not math.isfinite(obj):
        raise RuntimeError("down solve at Qwen2.5-7B width: kernel and plain disagree")
    return dict(kernel_s=sk, plain_s=sp, factorize_s=fact_s, launches=n, equal=equal,
                objective=obj)


def phase_families(tmp: Path, device) -> dict:
    """11: (a) a Qwen3-8B-width checkpoint (FAMILY_LAYERS layers) through
    ``quantize`` (GPTQ on the solve kernel, FAMILY_CALIB_TOKENS tokens,
    embedding and head RTN at the command's default Q4_K), ``pack`` and ``serve`` (v2g launches per
    forward as FAMILY_V2G_PER_FORWARD, the first forwards' calls held call
    by call, tokens against the plain versions'), then the contiguous and
    the paged engine on FAMILY_REQUESTS requests; (b) a Qwen2.5-7B-width
    checkpoint with q / k / v biases through ``rtn-quantize --outfile`` and
    ``serve`` the same way (q / k / v unfused), and the solve kernel at its
    widths (family_solves)."""
    import torch

    from gptq_gguf_tpu_torch.formats.gguf import GGUFReader
    from gptq_gguf_tpu_torch.ops import gptq
    from gptq_gguf_tpu_torch.quant import artifacts

    t_phase = time.perf_counter()
    card = card_name_and_power()
    rec = {}
    rng = np.random.default_rng(SEED + 11)
    for fam, hf in (("qwen3", QWEN3_8B), ("qwen2", QWEN25_7B)):
        secs, r = {}, {}
        ckpt = tmp / fam
        t = time.perf_counter()
        write_family_checkpoint(ckpt, hf, device)
        secs["checkpoint"] = time.perf_counter() - t
        save, gguf = tmp / f"{fam}-layers", tmp / f"{fam}.gguf"
        t = time.perf_counter()
        gptq.solve_block.launches = 0
        if fam == "qwen3":
            run_cli(["quantize", "--model_name_or_path", str(ckpt), "--calibration_data",
                     "synthetic", "--calibration_tokens", str(FAMILY_CALIB_TOKENS),
                     "--calibration_sequence_length", str(CALIB_SEQ), "--default_bit_width",
                     "Q4_K", "--quant_non_block_modules", "--save_dir", str(save),
                     "--device", str(device)])
            secs["quantize"] = time.perf_counter() - t
            t = time.perf_counter()
            run_cli(["pack", "--model_dir", str(ckpt), "--quant_dir", str(save),
                     "--outfile", str(gguf)])
            secs["pack"] = time.perf_counter() - t
            # Qwen3-8B: q/k/v, o and gate/up over 32 blocks each, down over 96
            want = sum(n for _, _, n in family_solves_of(hf)) * FAMILY_LAYERS
        else:
            run_cli(["rtn-quantize", "--model_name_or_path", str(ckpt), "--quant_type", "Q4_K",
                     "--save_dir", str(save), "--outfile", str(gguf), "--device", str(device)])
            secs["rtn_quantize_and_pack"] = time.perf_counter() - t
            want = 0
        r["solve_launches"] = gptq.solve_block.launches
        names = artifacts.list_layers(save)
        n_arts = 7 * FAMILY_LAYERS + 2 * (fam == "qwen3")
        if r["solve_launches"] != want or len(names) != n_arts:
            raise RuntimeError(f"{fam}: {r['solve_launches']} solve launches (want {want}), "
                               f"{len(names)} artifacts (want {n_arts})")
        shutil.rmtree(save)
        shutil.rmtree(ckpt)
        rd = GGUFReader(gguf)
        arch = rd.get("general.architecture")
        extra = f"blk.{FAMILY_LAYERS - 1}." + {"qwen3": "attn_k_norm.weight",
                                               "qwen2": "attn_v.bias"}[fam]
        if arch != fam or extra not in rd.tensors \
                or rd.tensors["output.weight"].ggml_type.name != ("Q4_K" if fam == "qwen3"
                                                                    else "F16"):
            raise RuntimeError(f"{gguf.name}: arch {arch}, head "
                               f"{rd.tensors['output.weight'].ggml_type.name}, tensors "
                               f"{list(rd.tensors)[:12]}")
        r["gguf_bytes"] = gguf.stat().st_size
        del rd
        keep = {}
        r["serve"] = serve_recipe(gguf, FAMILY_V2G_PER_FORWARD[fam], FAMILY_TOKENS, device,
                                  packed_head=fam == "qwen3", keep=keep)
        params, cfg = keep["params"], keep["cfg"]
        layer = params["layers"][0]
        if ("qkv_proj" in layer) != (fam == "qwen3") or "gateup_proj" not in layer \
                or cfg.qk_norm != (fam == "qwen3") or cfg.attention_bias != (fam == "qwen2"):
            raise RuntimeError(f"{fam} serving params: {sorted(layer)}, {cfg}")
        if fam == "qwen3":
            padded = -(-hf["vocab_size"] // 512) * 512  # 151936 -> 152064
            if params["lm_head"].d_out != padded or cfg.vocab_size != hf["vocab_size"]:
                raise RuntimeError(f"qwen3 head d_out {params['lm_head'].d_out}, want {padded}")
            r["engines"] = family_engines(params, cfg, rng, device)
        del params, cfg, keep, layer
        torch.cuda.empty_cache()
        gguf.unlink()
        if fam == "qwen2":
            r["solves"] = family_solves(rng, device)
        secs["all"] = sum(secs.values()) + r["serve"]["seconds"]
        r["seconds"] = secs
        log(f"  {fam}: GGUF {r['gguf_bytes']} bytes; seconds {secs}; v2g calls a forward "
            f"{FAMILY_V2G_PER_FORWARD[fam]} (phase 5: 8); worst call "
            f"{r['serve']['call_by_call']['worst_vs_1e5']:.3f}x of 1e-5 of its terms "
            f"(limit 1x, 10x on the prefill tiles: PREFILL_TILE_LIMIT) (card {card})")
        rec[fam] = r
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 11 took {rec['seconds']:.1f} s (card {card})")
    return rec


# ---------------------------------------------------------------------------
# Phase 12: the rest of evals/ and the search's leftovers
# ---------------------------------------------------------------------------

EVAL_PPL_ARGS = ("--datasets", "synthetic", "--eval_tokens", str(2 * 512), "--sequence_length",
                 "512")
LADDER_TOKENS, LADDER_SEQ = 4096, 512   # the ladders' and estimate-errors' calibration set
LADDER_BITS = (2, 3, 4, 5, 6, 8)        # JAX's default bit widths; the walk propagates 4
# FastOBC at one level each side of 0.5 (3 files a linear): JAX's default of
# four (9 files) would be ~8 GB of f16 files at this width
OBC_SPARSITY, OBC_LEVELS, OWL_LAMBDA = 0.5, 1, 0.08
PARITY_TOKENS, PARITY_EVAL = 16384, 4096
SCORE_PAIRS = 16
K_PROJ_ROWS = 256  # 12c's card / CPU comparison: rows of layer 0's k_proj
# log-probs at batch 8 against batch 1: JAX's own bound between its batched
# scorer and one forward a request (tests/test_lmeval.py); the two differ
# only by the f32 GEMMs' order of sums at another M
SCORE_LIMIT = 1e-3
SCORE_NEAR_TIE = 1e-4  # top-2 gap (logits) below which a greedy flag may flip


def ppl_of(argv, out: Path, args=EVAL_PPL_ARGS) -> float:
    """``ppl`` through the command line; its perplexity."""
    run_cli(["ppl", *argv, *args, "--output_path", str(out)])
    return json.loads(out.read_text())["synthetic"]


def level_stem(qtype: str) -> str:
    """A K-quant's level as the layer database names its files (4.5-Q4_K)."""
    from gptq_gguf_tpu_torch.mapper import splitter

    return f"{splitter._bits_prefix(splitter.nominal_bits(qtype))}-{qtype}"


def evals_compressed(tmp: Path, q4_gguf: Path, device) -> dict:
    """12a: ``ppl`` with phase 5's layers-hf database swapped into the
    checkpoint, by the searched config (its files named per line) and at
    the Q4_K level, each against the GGUF holding the same dequantized
    weights (the stitched one, the uniform Q4_K one) scored dense: within
    0.05 nats/token (f16 files against the GGUF's f32 dequantization);
    layer 1 dropped (attn+mlp): finite and not the undropped value;
    ``--memory_efficient``: within a relative 1e-3 of plain ``ppl``."""
    from gptq_gguf_tpu_torch.search import evopress

    hf_db = tmp / "db" / "layers-hf"
    chosen = evopress.parse_state_config(hf_db / f"evo-sparse_kl-configuration-{SEARCH_BITS}.txt")
    comp_cfg, drops = tmp / "compressed.txt", tmp / "drops.txt"
    # the loader's form of the searched config: one line a linear, its file's level
    comp_cfg.write_text("\n".join(f"{n}: {f[:-len('.pth')]}" for n, (_, f) in chosen.items()))
    drops.write_text("\n".join(["none", "attn+mlp"] + ["none"] * (GPTQ_LAYERS - 2)) + "\n")
    ckpt = ["--model_name_or_path", str(tmp / "ckpt")]
    db = ["--compressed_weights_path", str(hf_db)]
    runs = {"plain": ckpt, "searched config": ckpt + db + ["--compressed_config_path",
                                                            str(comp_cfg)],
            "stitched GGUF, dense": ["--gguf-file", str(tmp / "mixed.gguf"), "--gguf-path",
                                     "dense"],
            "Q4_K level": ckpt + db + ["--default_level", level_stem("Q4_K")],
            "Q4_K GGUF, dense": ["--gguf-file", str(q4_gguf), "--gguf-path", "dense"],
            "layer 1 dropped": ckpt + ["--drop_layer_config", str(drops)],
            "memory efficient": ckpt + ["--memory_efficient"]}
    ppl, secs = {}, {}
    for label, argv in runs.items():
        t = time.perf_counter()
        ppl[label] = ppl_of([*argv, "--device", str(device)], tmp / "ppl12.json")
        secs[label] = time.perf_counter() - t
    log(f"  ppl (2 x 512 synthetic tokens): " + ", ".join(
        f"{k} {v:.4f} ({secs[k]:.1f} s)" for k, v in ppl.items()))
    gaps = {"searched": abs(np.log(ppl["searched config"]) - np.log(ppl["stitched GGUF, dense"])),
            "Q4_K": abs(np.log(ppl["Q4_K level"]) - np.log(ppl["Q4_K GGUF, dense"]))}
    me = abs(ppl["memory efficient"] - ppl["plain"]) / ppl["plain"]
    log(f"  compressed weights against their GGUF: {gaps['searched']:.2e} nats/token (searched "
        f"config), {gaps['Q4_K']:.2e} (Q4_K level); --memory_efficient against plain: "
        f"{me:.2e} relative")
    if not all(np.isfinite(v) for v in ppl.values()) or max(gaps.values()) > 0.05 \
            or me > 1e-3 or ppl["layer 1 dropped"] == ppl["plain"]:
        raise RuntimeError(f"12a: perplexities {ppl}")
    return dict(ppl=ppl, nats_apart=gaps, memory_efficient_rel=me, seconds=secs)


def evals_estimate_errors(tmp: Path, device) -> dict:
    """12b: ``estimate-errors`` over phase 5's layers-hf database: every
    linear both levels, Q6_K below Q4_K on each; layer 0's o_proj at Q4_K
    against a float64 host computation from the same H (relative 1e-4)."""
    from gptq_gguf_tpu_torch.ops import sparse_gptq

    rel0, shapes, o_proj = sparse_gptq.relative_layer_error, [], []

    def recording(W, W_hat, H):
        # layer 0's calls in order: q, k, v, o (two files each); o's first is Q4_K
        shapes.append(tuple(W.shape))
        if len(shapes) == 7:
            o_proj.extend(t.cpu() for t in (W, W_hat, H))
        return rel0(W, W_hat, H)

    out = tmp / "errors.json"
    t = time.perf_counter()
    sparse_gptq.relative_layer_error = recording
    try:
        run_cli(["estimate-errors", "--model_name_or_path", str(tmp / "ckpt"), "--db_path",
                 str(tmp / "db" / "layers-hf"), "--calibration_data", "synthetic",
                 "--calibration_tokens", str(LADDER_TOKENS), "--calibration_sequence_length",
                 str(LADDER_SEQ), "--output_path", str(out), "--device", str(device)])
    finally:
        sparse_gptq.relative_layer_error = rel0
    secs = time.perf_counter() - t
    errs = json.loads(out.read_text())
    q4, q6 = f"{level_stem('Q4_K')}.pth", f"{level_stem('Q6_K')}.pth"
    bad = [n for n, e in errs.items() if sorted(e) != [q4, q6] or not e[q6] < e[q4]]
    if len(errs) != 7 * GPTQ_LAYERS or bad or shapes[2][0] != N_KV * HD:
        raise RuntimeError(f"12b: {len(errs)} linears, not both levels or Q6_K not below Q4_K: "
                           f"{bad}")
    W, W_hat, Hm = (t.double().numpy() for t in o_proj)
    dW = W - W_hat
    ref = float(np.sum(dW * (dW @ Hm)) / np.sum(W * (W @ Hm)))
    got = errs["model.layers.0.self_attn.o_proj"][q4]
    log(f"  estimate-errors in {secs:.1f} s: {len(errs)} linears, Q6_K below Q4_K on each "
        f"(Q4_K {min(e[q4] for e in errs.values()):.3e}-{max(e[q4] for e in errs.values()):.3e}, "
        f"Q6_K {min(e[q6] for e in errs.values()):.3e}-{max(e[q6] for e in errs.values()):.3e}); "
        f"layer 0 o_proj at Q4_K {got:.6e}, float64 on the host {ref:.6e} "
        f"({abs(got - ref) / ref:.1e} relative)")
    if not abs(got - ref) <= 1e-4 * ref:
        raise RuntimeError(f"12b: o_proj error {got} against float64 {ref}")
    return dict(seconds=secs, o_proj_q4=got, o_proj_q4_f64=ref,
                q4_range=[min(e[q4] for e in errs.values()), max(e[q4] for e in errs.values())],
                q6_range=[min(e[q6] for e in errs.values()), max(e[q6] for e in errs.values())])


def evals_ladders(tmp: Path, device):
    """12c: the FastOBQ ladder at LADDER_BITS (propagating 4 bits; 84
    files), ``estimate_layer_errors`` over it with each linear's flat 4-bit RTN
    beside (errors strictly falling with bits, 4 bits at or below RTN), the
    FastOBC ladder at OBC_SPARSITY (3 levels a linear; every block of every
    level holds exactly the zeros its threshold gives: its k plus the
    entries tied with the k-th score), the OWL ratios and distribution,
    and layer 0's k_proj (K_PROJ_ROWS rows) through both solvers on the
    card and on the CPU from one factor (codes and masks equal on at least
    99.9%). Seconds per layer and the ladders' bytes printed, the files
    removed. Returns (record, (dense, pruned) layer-0 down_proj for 12f)."""
    import torch

    from gptq_gguf_tpu_torch.models import llama, loader
    from gptq_gguf_tpu_torch.ops import sparse_gptq
    from gptq_gguf_tpu_torch.search import ladder
    from gptq_gguf_tpu_torch.utils.data import get_synthetic

    rec, secs = {}, {}
    ckpt = tmp / "ckpt"
    cfg = loader.load_config(ckpt)
    params = loader.load_params(ckpt, cfg)
    calib = get_synthetic(LADDER_TOKENS, LADDER_SEQ, cfg.vocab_size)

    # FastOBQ, layer 0's k_proj (W, H) kept for the card / CPU comparison
    obq0, kept, n_obq, solve_s = sparse_gptq.fast_obq_quantize, {}, [0], []

    def keep_k(W, H, bitwidths, **kw):
        n_obq[0] += 1
        if n_obq[0] == 2:  # q, then k
            kept["k"] = (W.float().cpu(), H.cpu())
        t0 = time.perf_counter()
        out = obq0(W, H, bitwidths, **kw)
        torch.cuda.synchronize()
        solve_s.append(time.perf_counter() - t0)
        return out

    obq = tmp / "obq"
    t = time.perf_counter()
    sparse_gptq.fast_obq_quantize = keep_k
    try:
        ladder.build_fastobq_ladder(params, cfg, calib, obq, LADDER_BITS, propagate_bits=4,
                                    device=device)
    finally:
        sparse_gptq.fast_obq_quantize = obq0
    torch.cuda.synchronize()
    secs["fastobq"] = time.perf_counter() - t
    files = sorted(obq.rglob("*.pth"))
    rec["fastobq_bytes"] = disk_bytes(obq)
    if len(files) != 7 * GPTQ_LAYERS * len(LADDER_BITS) or kept["k"][0].shape[0] != N_KV * HD:
        raise RuntimeError(f"12c: {len(files)} FastOBQ files")
    # each linear's flat 4-bit round-to-nearest, scored beside the ladder
    for layer_dir in sorted(p for p in obq.iterdir() if p.is_dir()):
        W = llama.get_linear(params, layer_dir.name).to(device).float()
        p = sparse_gptq.simple_find_params(W, 4, False)
        _, wq = sparse_gptq._flat_quantize(W, p.scale[:, None], p.zero[:, None], 15.0)
        torch.save(wq.half().cpu(), layer_dir / "rtn4.pth")
    t = time.perf_counter()  # the command ran in 12b: here its function, on the loaded model
    errs = ladder.estimate_layer_errors(params, cfg, calib, obq, device=device)
    secs["estimate_errors"] = time.perf_counter() - t
    bad = [n for n, e in errs.items()
           if not all(e[f"{a}.pth"] > e[f"{b}.pth"] for a, b in zip(LADDER_BITS, LADDER_BITS[1:]))
           or not e["4.pth"] <= e["rtn4.pth"]]
    gain = [errs[n]["4.pth"] / errs[n]["rtn4.pth"] for n in errs]
    secs["fastobq_solves"] = sum(solve_s)
    log(f"  FastOBQ ladder ({len(LADDER_BITS)} bit widths, {LADDER_TOKENS} tokens in sequences "
        f"of {LADDER_SEQ}) in {secs['fastobq']:.1f} s ({secs['fastobq'] / GPTQ_LAYERS:.1f} s a "
        f"layer, of which the 7 solves {sum(solve_s) / GPTQ_LAYERS:.1f} s: "
        f"{[round(x, 2) for x in solve_s[:7]]}): {len(files)} files, {rec['fastobq_bytes']} "
        f"bytes; estimate-errors over it in "
        f"{secs['estimate_errors']:.1f} s: errors fall with bits on {len(errs) - len(bad)} of "
        f"{len(errs)} linears, 4-bit error / flat 4-bit RTN's {min(gain):.3f}-{max(gain):.3f}")
    if bad or len(errs) != 7 * GPTQ_LAYERS:
        raise RuntimeError(f"12c: FastOBQ errors not falling with bits or above RTN: {bad}")
    rec["obq_over_rtn_4bit"] = [min(gain), max(gain)]
    shutil.rmtree(obq)

    # FastOBC: every block's zeros against its threshold's count
    obc0, blocks = sparse_gptq.fast_obc_prune, []

    def checked(W, H, sparsities, **kw):
        stats = []
        t0 = time.perf_counter()
        out = obc0(W, H, sparsities, stats=stats, **kw)
        torch.cuda.synchronize()
        solve_s.append(time.perf_counter() - t0)
        if len(solve_s) == 7:  # layer 0's down_proj, level 0: 12f's weight
            levels = ladder.obc_levels(W.numel(), OBC_SPARSITY, OBC_LEVELS, 1 << 20)[0]
            kept["down"] = (W.float(), out[levels.index(0)])
        bs = kw.get("block_size", 128)
        zeros = [(w.view(w.shape[0], -1, bs) == 0).sum(dim=(0, 2)).tolist() for w in out]
        n_le = torch.stack([n for *_, n in stats]).tolist()  # one read a linear
        blocks.extend((zeros[ci][blk], n, k) for (ci, blk, k, _), n in zip(stats, n_le))
        return out

    obc = tmp / "obc"
    solve_s.clear()
    t = time.perf_counter()
    sparse_gptq.fast_obc_prune = checked
    try:
        ladder.build_fastobc_ladder(params, cfg, calib, obc, OBC_SPARSITY, OBC_LEVELS,
                                    device=device)
    finally:
        sparse_gptq.fast_obc_prune = obc0
    torch.cuda.synchronize()
    secs["fastobc"] = time.perf_counter() - t
    secs["fastobc_solves"] = sum(solve_s)
    n_obc = len(list(obc.rglob("*.pth")))
    rec["fastobc_bytes"] = disk_bytes(obc)
    want_files = sum(len(ladder.obc_levels(llama.get_linear(params, n).numel(), OBC_SPARSITY,
                                           OBC_LEVELS, 1 << 20)[0])
                     for n in llama.linear_layer_names(cfg))
    wrong = sum(z != n for z, n, _ in blocks)
    tied = [n - k for _, n, k in blocks if n != k]
    log(f"  FastOBC ladder (sparsity {OBC_SPARSITY}, up to {2 * OBC_LEVELS + 1} levels) in "
        f"{secs['fastobc']:.1f} s ({secs['fastobc'] / GPTQ_LAYERS:.1f} s a layer, the solves "
        f"{sum(solve_s) / GPTQ_LAYERS:.1f} s): {n_obc} "
        f"files, {rec['fastobc_bytes']} bytes; {len(blocks) - wrong} of {len(blocks)} blocks "
        f"hold exactly the zeros their threshold gives, {len(blocks) - len(tied)} exactly k, "
        f"{len(tied)} k plus entries tied with the k-th score (at most {max(tied, default=0)})")
    if wrong or n_obc != want_files:
        raise RuntimeError(f"12c: {n_obc} FastOBC files, {wrong} blocks off their count")
    rec["obc_blocks"], rec["obc_tied_blocks"] = len(blocks), len(tied)
    shutil.rmtree(obc)

    t = time.perf_counter()
    ratios = ladder.compute_owl_outlier_ratios(params, cfg, calib, device=device)
    dist = sparse_gptq.owl_sparsity_distribution(ratios, OBC_SPARSITY, OWL_LAMBDA)
    secs["owl"] = time.perf_counter() - t
    log(f"  OWL in {secs['owl']:.1f} s: outlier ratios {[round(r, 6) for r in ratios]}, "
        f"sparsities {[round(float(x), 6) for x in dist]} (mean {dist.mean():.12f})")
    if not (np.all(np.isfinite(ratios)) and np.all(np.isfinite(dist))
            and abs(dist.mean() - OBC_SPARSITY) < 1e-12):
        raise RuntimeError(f"12c: OWL ratios {ratios}, distribution {dist}")
    rec["owl_ratios"], rec["owl_sparsities"] = ratios, dist.tolist()

    # layer 0's k_proj through both solvers on the card and on the CPU, from
    # one factorization (the card's): f32 Cholesky factors of this
    # ill-conditioned H (4096 tokens over 4096 columns, 1% damping) from
    # cuSOLVER and from LAPACK differ far above f32 rounding, which moves
    # the solutions by more than either solver does (printed beside)
    from gptq_gguf_tpu_torch.ops import gptq

    W, Hk = kept.pop("k")
    levels, sparsities = ladder.obc_levels(W.numel(), OBC_SPARSITY, OBC_LEVELS, 1 << 20)
    W32, U, _ = gptq.prepare_hessian_inverse(Hk.to(device), W.to(device), 1e-2)
    # its first K_PROJ_ROWS rows: rows are independent given U, so these are
    # the whole linear's solve on them (the CPU's eager loop is the cost)
    W, W32 = W[:K_PROJ_ROWS], W32[:K_PROJ_ROWS]
    _, U_cpu, _ = gptq.prepare_hessian_inverse(Hk, W, 1e-2)
    u_gap = float((U.cpu() - U_cpu).abs().max() / U_cpu.abs().max())
    L, rows = len(LADDER_BITS), W.shape[0]
    maxq = torch.tensor([2.0 ** b - 1 for b in LADDER_BITS]).repeat_interleave(rows)
    chunks = [(k * rows, (k + 1) * rows, sp) for k, sp in enumerate(sparsities)]

    def solve(dev):
        w, u = W32.to(dev), U.to(dev)
        codes = sparse_gptq._stacked_fast_obq(w.repeat(L, 1), u, maxq.to(dev), False,
                                              w.shape[1], 128)[0]
        pruned = sparse_gptq._stacked_fast_obc(w.repeat(len(chunks), 1), u, chunks, 128)
        return codes.cpu(), pruned.cpu()

    for key, where in (("card", device), ("cpu", torch.device("cpu"))):
        t = time.perf_counter()
        kept[key] = solve(where)
        torch.cuda.synchronize()
        secs[f"k_proj_{key}"] = time.perf_counter() - t
    (c_card, w_card), (c_cpu, w_cpu) = kept.pop("card"), kept.pop("cpu")
    codes = [float((c_card[k * rows:(k + 1) * rows] == c_cpu[k * rows:(k + 1) * rows])
                   .float().mean()) for k in range(L)]
    masks = [float(((w_card[r0:r1] == 0) == (w_cpu[r0:r1] == 0)).float().mean())
             for r0, r1, _ in chunks]
    own = sparse_gptq.fast_obq_quantize(W, Hk, (4,))[4][0]
    own_agree = float((own == c_card[2 * rows:3 * rows]).float().mean())
    log(f"  layer 0 k_proj (its first {rows} rows x {W.shape[1]}) through both solvers from "
        f"the card's "
        f"factor: card {secs['k_proj_card']:.2f} s, CPU {secs['k_proj_cpu']:.2f} s; codes equal "
        f"{[round(c, 6) for c in codes]} (bits {LADDER_BITS}), masks equal "
        f"{[round(m, 6) for m in masks]} (sparsities {[round(x, 4) for x in sparsities]}); the "
        f"CPU's own factor {u_gap:.1e} of max|U| from the card's, its 4-bit codes "
        f"{own_agree:.4f} equal")
    if min(codes + masks) < 0.999:
        raise RuntimeError(f"12c: card and CPU solvers apart: codes {codes}, masks {masks}")
    rec.update(card_cpu_codes=codes, card_cpu_masks=masks, factor_gap=u_gap,
               own_factor_4bit_codes=own_agree, seconds=secs)
    return rec, kept.pop("down")


def evals_parity(tmp: Path, device) -> dict:
    """12d: ``parity`` at Q4_K and Q6_K on the checkpoint (PARITY_TOKENS
    calibration tokens, one PARITY_EVAL-token sequence): 416 solve-kernel
    launches a bit width, JAX's report keys with no reference row (passed
    null); each GGUF through ``ppl --gguf-path serving`` (a v2g launch per
    K-quant linear and forward: ppl does not fuse, and the f16 head is
    dense; within 0.05 nats/token of the report's perplexity)."""
    import torch

    from gptq_gguf_tpu_torch.formats.gguf import GGUFReader
    from gptq_gguf_tpu_torch.ops import gptq
    from gptq_gguf_tpu_torch.quant import calibrate
    from gptq_gguf_tpu_torch.serving import model as qmodel

    out_dir = tmp / "parity"
    walk0, walks = calibrate.quantize_model, []

    def counted(*a, **kw):
        gptq.solve_block.launches = 0
        t0 = time.perf_counter()
        res = walk0(*a, **kw)
        torch.cuda.synchronize()
        walks.append((gptq.solve_block.launches, time.perf_counter() - t0))
        return res

    t = time.perf_counter()
    calibrate.quantize_model = counted
    try:
        run_cli(["parity", "--model_name_or_path", str(tmp / "ckpt"), "--calibration_data",
                 "synthetic", "--calibration_tokens", str(PARITY_TOKENS), "--eval_tokens",
                 str(PARITY_EVAL), "--bit_widths", "Q4_K", "Q6_K", "--out_dir", str(out_dir),
                 "--device", str(device)])
    finally:
        calibrate.quantize_model = walk0
    parity_s = time.perf_counter() - t
    report = json.loads((out_dir / "parity_report.json").read_text())
    want = sum(n for _, _, n in SOLVE_SHAPES) * GPTQ_LAYERS
    keys = {"bit_width", "measured_ppl", "reference_ppl", "delta", "passed", "gguf_path",
            "seconds"}
    if sorted(report) != ["eval_dataset", "model", "results", "tolerance"] or any(
            set(r) != keys or r["passed"] is not None for r in report["results"]) \
            or [n for n, _ in walks] != [want, want]:
        raise RuntimeError(f"12d: report {report}, solve launches {walks}")
    fwd0, forwards, rec = qmodel.forward_cached, [0], {}

    def counted_forward(*a, **kw):
        forwards[0] += 1
        return fwd0(*a, **kw)

    for r, (launches, walk_s) in zip(report["results"], walks):
        gguf = Path(r["gguf_path"])
        types = {n: i.ggml_type.name for n, i in GGUFReader(gguf).tensors.items()}
        # ppl loads without fusing: every K-quant linear one call, the f16 head dense
        per_forward = sum(t.endswith("_K") for n, t in types.items() if n.startswith("blk."))
        reset_matmul_counts()
        forwards[0] = 0
        t = time.perf_counter()
        qmodel.forward_cached = counted_forward
        try:
            served = ppl_of(["--gguf-file", str(gguf), "--gguf-path", "serving", "--device",
                             str(device)], tmp / "ppl12.json",
                            ("--datasets", "synthetic", "--eval_tokens", str(PARITY_EVAL),
                             "--sequence_length", str(PARITY_EVAL)))
        finally:
            qmodel.forward_cached = fwd0
        serve_s = time.perf_counter() - t
        v2g = matmul_counts()["v2g"]
        apart = abs(np.log(served) - np.log(r["measured_ppl"]))
        log(f"  parity {r['bit_width']}: walk {walk_s:.1f} s ({launches} solve-kernel launches), "
            f"report ppl {r['measured_ppl']:.4f} in {r['seconds']:.1f} s (walk, dense ppl, "
            f"pack); {gguf.name} ({gguf.stat().st_size} bytes, output.weight "
            f"{types['output.weight']}) through ppl --gguf-path serving {served:.4f} in "
            f"{serve_s:.1f} s, {apart:.2e} nats/token apart; v2g launches {v2g} = "
            f"{per_forward} x {forwards[0]} forwards")
        if not np.isfinite(served) or apart > 0.05 or v2g != per_forward * forwards[0] \
                or not forwards[0]:
            raise RuntimeError(f"12d: {r['bit_width']} served {served}, {v2g} v2g launches")
        rec[r["bit_width"]] = dict(report_ppl=r["measured_ppl"], served_ppl=served,
                                   nats_apart=apart, solve_launches=launches, walk_s=walk_s,
                                   report_s=r["seconds"], serve_ppl_s=serve_s,
                                   v2g_launches=v2g, gguf_bytes=gguf.stat().st_size)
    shutil.rmtree(out_dir)
    return dict(rec, parity_s=parity_s, report_keys=sorted(report))


def evals_scorers(tmp: Path, device) -> dict:
    """12e: SCORE_PAIRS seeded (context, continuation) pairs scored at
    batch 8 and at batch 1 (the first 4 continued by their greedy token):
    log-probs within SCORE_LIMIT, greedy flags equal but at a near-tie;
    ``score_rolling`` of one 512-token sequence within a relative 1e-3 of
    its summed NLL from ``compute_perplexity``."""
    import torch

    from gptq_gguf_tpu_torch.evals import lmeval, ppl as ppl_mod
    from gptq_gguf_tpu_torch.models import llama, loader
    from gptq_gguf_tpu_torch.utils.data import get_synthetic

    ckpt = tmp / "ckpt"
    cfg = loader.load_config(ckpt)
    host = loader.load_params(ckpt, cfg)
    params = {k: v.to(device) for k, v in host.items() if k != "layers"}
    params["layers"] = [{k: v.to(device) for k, v in layer.items()} for layer in host["layers"]]
    del host
    rng = np.random.default_rng(SEED + 12)
    pairs = []
    with torch.no_grad():
        for i in range(SCORE_PAIRS):
            ctx = rng.integers(0, cfg.vocab_size, int(rng.integers(16, 120))).tolist()
            cont = rng.integers(0, cfg.vocab_size, int(rng.integers(1, 9))).tolist()
            if i < 4:
                cont = [int(llama.forward(params, torch.as_tensor([ctx], device=device),
                                          cfg)[0, -1].argmax())]
            pairs.append((ctx, cont))
    t = time.perf_counter()
    s8 = lmeval.score_continuations(params, cfg, pairs, cfg.max_position_embeddings, 8)
    t8 = time.perf_counter() - t
    t = time.perf_counter()
    s1 = lmeval.score_continuations(params, cfg, pairs, cfg.max_position_embeddings, 1)
    t1 = time.perf_counter() - t
    lp_gap = max(abs(a[0] - b[0]) for a, b in zip(s8, s1))
    flips = [i for i, (a, b) in enumerate(zip(s8, s1)) if a[1] != b[1]]
    for i in flips:
        ctx, cont = pairs[i]
        with torch.no_grad():
            logits = llama.forward(params, torch.as_tensor([ctx + cont], device=device), cfg)[0]
        top2 = logits[len(ctx) - 1:-1].topk(2, dim=-1).values
        if float((top2[:, 0] - top2[:, 1]).min()) >= SCORE_NEAR_TIE:
            raise RuntimeError(f"12e: pair {i}'s greedy flag differs away from a tie")
    seq = get_synthetic(512, 512, cfg.vocab_size, seed=SEED)[0]
    roll = lmeval.score_rolling(params, cfg, [seq[0].tolist()], cfg.max_position_embeddings)[0]
    nll = float(np.log(ppl_mod.compute_perplexity(params, cfg, [seq]))) * (seq.shape[1] - 1)
    roll_rel = abs(-roll - nll) / nll
    log(f"  lm-eval scorers: {SCORE_PAIRS} pairs at batch 8 in {t8:.2f} s and at batch 1 in "
        f"{t1:.2f} s, log-probs at most {lp_gap:.2e} apart (limit {SCORE_LIMIT:g}), greedy "
        f"{sum(g for _, g in s8)} of {SCORE_PAIRS}, {len(flips)} flags differ (near-ties); "
        f"score_rolling {roll:.4f} against compute_perplexity's summed NLL {-nll:.4f} "
        f"({roll_rel:.1e} relative)")
    if lp_gap > SCORE_LIMIT or roll_rel > 1e-3 or sum(g for _, g in s1) < 2:
        raise RuntimeError(f"12e: log-probs {lp_gap} apart, rolling {roll_rel} relative")
    return dict(pairs=SCORE_PAIRS, logprob_gap=lp_gap, flag_flips=len(flips),
                greedy=sum(g for _, g in s8), rolling_rel=roll_rel, batch8_s=t8, batch1_s=t1)


def evals_distill(dense, pruned, device) -> dict:
    """12f: one ``masked_sgd`` step on the FastOBC-pruned layer-0
    down_proj (level 0 of 12c's ladder, kept from its walk) under
    ``squarehead_loss`` against the dense weight's outputs: the loss
    finite, every pruned weight still exactly 0."""
    import torch

    from gptq_gguf_tpu_torch.search import distill

    name = "model.layers.0.mlp.down_proj"
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    x = torch.randn((512, dense.shape[1]), generator=gen, device=device)
    w = pruned.clone().requires_grad_(True)
    mask = distill.sparsity_masks({"w": pruned})["w"]
    opt = distill.masked_sgd(1e-2, [mask], [w])
    teacher = x @ dense.T
    loss = distill.squarehead_loss(x @ w.T, teacher)
    loss.backward()
    opt.step()
    with torch.no_grad():
        after = float(distill.squarehead_loss(x @ w.T, teacher))
    kept_zero = bool((w.detach()[mask == 0] == 0).all())
    moved = int((w.detach() != pruned).sum())
    log(f"  distillation: one masked_sgd step on the pruned {name} ({int((mask == 0).sum())} "
        f"of {mask.numel()} weights zero): squarehead loss {float(loss.detach()):.6f} -> "
        f"{after:.6f}, "
        f"{moved} weights moved, every pruned weight still 0: {kept_zero}")
    loss = float(loss.detach())
    if not (np.isfinite(loss) and np.isfinite(after) and kept_zero and moved):
        raise RuntimeError(f"12f: loss {loss} -> {after}, pruned kept {kept_zero}")
    return dict(loss=loss, loss_after=after, zeros=int((mask == 0).sum()), moved=moved)


def phase_evals(tmp: Path, q4_gguf: Path, device) -> dict:
    """12: the rest of evals/ and the search's leftovers on phase 5's
    checkpoint, database, searched config and GGUFs (removed at the end):
    (a) evals_compressed, (b) evals_estimate_errors, (c) evals_ladders,
    (d) evals_parity, (e) evals_scorers, (f) evals_distill."""
    import torch

    t_phase = time.perf_counter()
    rec, secs, down = {}, {}, None

    def ladders():
        nonlocal down
        out, down = evals_ladders(tmp, device)
        return out

    for key, step in (("compressed", lambda: evals_compressed(tmp, q4_gguf, device)),
                      ("estimate_errors", lambda: evals_estimate_errors(tmp, device)),
                      ("ladders", ladders),
                      ("parity", lambda: evals_parity(tmp, device)),
                      ("scorers", lambda: evals_scorers(tmp, device)),
                      ("distill", lambda: evals_distill(*down, device))):
        t = time.perf_counter()
        rec[key] = step()
        torch.cuda.empty_cache()
        secs[key] = time.perf_counter() - t
    shutil.rmtree(tmp / "db")
    for p in (tmp / "mixed.gguf", q4_gguf):
        p.unlink()
    secs["phase"] = time.perf_counter() - t_phase
    log(f"phase 12 took {secs['phase']:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items() if k != "phase")
        + f" (card {card_name_and_power()})")
    return dict(rec, seconds=secs)


# ---------------------------------------------------------------------------
# Phase 8: the v2 kernel variants at full width
# ---------------------------------------------------------------------------

# one summary entry per TPU kernel body: (name, source, its line in the JAX
# qmatmul.py, variant, the shapes of one B=8 decode step it runs, the 8c
# run whose launches it reports)
STEP = ("qkv", "o", "gateup", "down", "lm_head")
Q4_SHAPES = STEP[:4]  # the Q4_K projections (the head is Q6_K)
V2_VARIANT_KERNELS = (
    ("qmatmul_v2", "qmatmul_v2.cu", 377, "v2", STEP, "v2"),
    ("qmatmul_v3", "qmatmul_v3.cu", 429, "v3", STEP, "v3"),
    ("qmatmul_v2f", "qmatmul_v2.cu", 496, "v2f", STEP, "v2f"),
    ("qmatmul_v2h", "qmatmul_v3.cu", 551, "v2h", STEP, "v2h"),
    ("qmatmul_v2s", "qmatmul_v2g.cu", 660, "v2s", Q4_SHAPES, "v2s"),
    ("qmatmul_v2m", "qmatmul_v2m.cu", 729, "v2m", Q4_SHAPES, "v2m"),
    ("qmatmul_v2t", "qmatmul_v2m.cu", 789, "v2t", Q4_SHAPES, "v2t"),
    ("qmatmul_v2p", "qmatmul_v2m.cu", 844, "v2p", ("lm_head",), "v2m"),
)

# the decode tiles of the v2 variants that phase 8 holds (v2g's is phase
# 2's): variant, source, the JAX body's line, its shapes in one B=8 step,
# the 8c run whose launches it reports
VARIANT_DECODE_KERNELS = (("v2p", "qmatmul_v2m_mma.cuh", 844, ("lm_head",), "v2m"),
                          ("v2h", "qmatmul_v2_mma.cuh", 551, STEP, "v2h"),
                          ("v2t", "qmatmul_v2m_mma.cuh", 789, Q4_SHAPES, "v2t"),
                          ("v2m", "qmatmul_v2m_mma.cuh", 729, Q4_SHAPES, "v2m"),
                          ("v2s", "qmatmul_v2_mma.cuh", 660, Q4_SHAPES, "v2s"),
                          ("v3", "qmatmul_v2_mma.cuh", 429, STEP, "v3"),
                          ("v2", "qmatmul_v2_mma.cuh", 377, STEP, "v2"),
                          ("v2f", "qmatmul_v2_mma.cuh", 496, STEP, "v2f"))


# the depths of the serving paths beside the main path (phase 3, 32 layers):
# cut to keep chip_smoke inside its time limit beside phases 10-12
VARIANT_SERVING_LAYERS = 4  # 8c's depth (the first 4 of phase 3's 32 layers)
FORMAT_SERVING_LAYERS = 4   # 7c's depth, likewise
SAMPLED_SERVING_LAYERS = 4  # phase 9's depth, likewise
PAGED_SERVING_LAYERS = 4    # 6c-e's depth, likewise


def variant_runs(n_layers: int):
    """8c: (PALLAS_V2_VARIANT, PALLAS_V2_VARIANT_GS16, launches per forward
    by wrapper): Q4_K projections 4 per layer, the Q6_K lm_head once."""
    return (("v2", "", {"v2": 4 * n_layers + 1}),
            ("v2m", "", {"v2m": 4 * n_layers, "v2p": 1}),  # v2m at gs 16 is v2p
            ("v2t", "", {"v2t": 4 * n_layers, "v2g": 1}),  # v2t at gs 16 is v2g
            ("v2g", "v2p", {"v2g": 4 * n_layers, "v2p": 1}),
            ("v3", "", {"v3": 4 * n_layers + 1}),
            ("v2f", "", {"v2f": 4 * n_layers + 1}),
            ("v2h", "", {"v2h": 4 * n_layers + 1}),
            ("v2s", "", {"v2s": 4 * n_layers, "v2g": 1}))  # v2s on byte codes is v2g


def variant_fns():
    """variant -> (kernel wrapper, plain version), both (x, rql, mxu_dtype)."""
    from gptq_gguf_tpu_torch.ops import qmatmul

    def plain(v):
        if v in qmatmul.PER_WEIGHT_VARIANTS:
            return lambda x, rql, dt: qmatmul.dequant_matmul_v2w_reference(x, rql, dt, v)
        return qmatmul.dequant_matmul_v2m_reference

    return {v: (getattr(qmatmul, name), plain(v)) for v, name in qmatmul.V2_WRAPPERS.items()}


def control_of(variant: str, mxu: str):
    """8a's planted control for a case: the plain version of a variant that
    rounds otherwise (variant, mxu), which the case's limit must reject:
    with f32 operands the same variant in bf16; in bf16 the group-dot
    variants against v2g (bf16(scale * q)), v2g / v2s / v3 against the
    group-dot plain version (the unrounded scale * q), v2 / v2f / v2h
    against v2g (the offset out of the rounded weight)."""
    if mxu == "f32":
        return variant, "bf16"
    if variant in ("v2m", "v2t", "v2p", "v2", "v2f", "v2h"):
        return "v2g", "bf16"
    return "v2m", "bf16"


def mxu_dtype(mxu: str):
    import torch

    return torch.bfloat16 if mxu == "bf16" else torch.float32


def variant_terms(x, rql, variant: str, mxu: str) -> float:
    """max over outputs of the sum of |terms| a v2 variant adds up: the x
    as the kernel rounds it against its weights as it builds them (the
    group-dot kernels: the unrounded scale * q), plus |xsum| against
    |off2| for the variants that subtract that term."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul

    dt = mxu_dtype(mxu)
    if variant in qmatmul.PER_WEIGHT_VARIANTS:
        w, corrects = qmatmul._v2_operand(rql, variant, dt)
    else:
        w, corrects = qmatmul._v2_operand(rql, "v2g", torch.float32)
    mag = qmatmul._mxu_round(x.float(), dt).abs() @ w.abs()
    del w
    if corrects:
        _, off2 = qmatmul._folded_planes_v2(rql)
        mag += x.float().reshape(x.shape[0], -1, rql.group_size).sum(-1).abs() @ off2.abs()
    return mag.max().item()


def variant_case(name, variant, mxu, x, rql, flush, control=None):
    """One v2 variant kernel against its plain version on the same inputs,
    then timed: kernel, call, plain, library (torch.matmul on the
    dequantized weight, bf16; f32 with TF32 off for f32 operands) and the
    bound (bytes at 3.35 TB/s; operations at 989 TFLOP/s bf16 or 67 f32).
    ``control`` (variant, mxu) replaces control_of's planted control."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul

    M, d_in = x.shape
    fns = variant_fns()
    fn, ref = fns[variant]
    dt = mxu_dtype(mxu)
    y_k = fn(x, rql, dt)
    y_p = ref(x, rql, dt)
    c_var, c_mxu = control or control_of(variant, mxu)
    y_c = fns[c_var][1](x, rql, mxu_dtype(c_mxu))
    torch.cuda.synchronize()
    if not torch.isfinite(y_k).all():
        raise RuntimeError(f"{variant} {name}: kernel output is not finite")
    # tolerance: the same products (bf16 operands, raw codes or f32), f32
    # sums in another order: 1e-5 of the largest sum of |terms| of an output
    # (reordering f32 sums costs ~1e-7 * sqrt(d_in) of it); a planted
    # control, another variant's rounding, must fail it
    err = (y_k - y_p).abs().max().item()
    err_c = (y_k - y_c).abs().max().item()
    tol = 1e-5 * max(variant_terms(x, rql, variant, mxu), 1e-30)
    del y_k, y_p, y_c
    if not err <= tol:
        raise RuntimeError(f"{variant} {mxu} {name} M={M}: kernel vs plain max|err| "
                           f"{err:.3e} > {tol:.3e}")
    if not err_c > tol:
        raise RuntimeError(f"{variant} {mxu} {name} M={M}: the limit {tol:.3e} does not reject "
                           f"the control ({c_var} {c_mxu}: {err_c:.3e})")
    w_lib = qmatmul.dequantize_runtime_v2(rql).T.contiguous().to(dt)
    x_lib = x.to(dt)
    ms = cuda_ms(lambda: fn(x, rql, dt), 20, flush)
    wall_ms = call_ms(lambda: fn(x, rql, dt), 20)
    plain_ms = cuda_ms(lambda: ref(x, rql, dt), 1, flush)
    library_ms = cuda_ms(lambda: torch.matmul(x_lib, w_lib), 20, flush)
    del w_lib, x_lib
    nbytes = rql.bytes_read + x.numel() * x.element_size() + M * rql.d_out * 4
    flops = 2.0 * M * d_in * rql.d_out
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOP_PER_S if mxu == "bf16" else F32_FLOP_PER_S) * 1e3
    rec = dict(name=name, variant=variant, mxu=mxu, M=M, d_in=d_in, d_out=rql.d_out,
               max_abs_err=err, tol=tol, control=f"{c_var} {c_mxu}", control_err=err_c,
               ms=ms, call_ms=wall_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    log(f"  {variant:>3} {mxu} {name:>24} M={M:<4} err {err:.3e} (tol {tol:.2e}, control "
        f"{c_var} {c_mxu} {err_c:.2e})  kernel "
        f"{ms:.4f} ms (call {wall_ms:.4f})  plain {plain_ms:.3f} ms  library {library_ms:.4f} "
        f"ms  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec


def phase_variant_kernels(params, rng, device):
    """8a: at every 8B projection shape (Q4_K) and the padded Q6_K
    lm_head, M = 8 and 128, each variant that runs there (v2 also with f32
    operands); Q2_K / Q3_K / Q5_K and ragged d_out at small shapes, with
    the f32 operand mode of every per-weight variant among them."""
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T

    q4 = ("v2 bf16", "v2 f32", "v3 bf16", "v2f bf16", "v2h bf16", "v2s bf16", "v2m bf16",
          "v2t bf16")
    q6 = ("v2 bf16", "v2 f32", "v3 bf16", "v2f bf16", "v2h bf16", "v2p bf16")
    shapes = [(name, rql, q6 if name.startswith("lm_head") else q4)
              for name, rql in step_shapes(params)]
    small = [("Q2_K 1024->768", 768, 1024, T.Q2_K, 8,
              ("v2 bf16", "v3 f32", "v2h bf16", "v2s f32", "v2p bf16")),
             ("Q3_K 1024->768", 768, 1024, T.Q3_K, 8,
              ("v2 bf16", "v3 bf16", "v2f f32", "v2s bf16", "v2p bf16")),
             ("Q5_K 1024->768", 768, 1024, T.Q5_K, 8,
              ("v2 bf16", "v2f bf16", "v2h f32", "v2m bf16", "v2t bf16")),
             ("ragged Q4_K 2048->1000", 1000, 2048, T.Q4_K, 5,
              ("v2 f32", "v2g f32", "v2h bf16", "v2s bf16", "v2m bf16", "v2t bf16")),
             ("ragged Q6_K 512->333 f32x", 333, 512, T.Q6_K, 3,
              ("v2 f32", "v3 bf16", "v2f f32", "v2p bf16"))]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device).zero_
    recs = []
    for M in (8, 128):
        for name, rql, runs in shapes:
            x = (torch.randn(M, rql.d_in_local, device=device) * 0.5).to(torch.bfloat16)
            for run in runs:
                recs.append(variant_case(name, *run.split(), x, rql, flush))
            torch.cuda.empty_cache()
    for name, d_out, d_in, qt, M, runs in small:
        rql = synthetic_rql(rng, d_out, d_in, qt, device)
        x = torch.randn(M, d_in, device=device)
        if "f32x" not in name:
            x = x.to(torch.bfloat16)
        for run in runs:
            recs.append(variant_case(name, *run.split(), x, rql, flush))
    return recs


def knobs(variant: str, gs16: str):
    """Set PALLAS_V2_VARIANT and _GS16; returns the previous pair."""
    from gptq_gguf_tpu_torch.ops import qmatmul

    old = qmatmul.PALLAS_V2_VARIANT, qmatmul.PALLAS_V2_VARIANT_GS16
    qmatmul.PALLAS_V2_VARIANT, qmatmul.PALLAS_V2_VARIANT_GS16 = variant, gs16
    return old


# 8b's limit for the prefill's calls on the per-weight tensor-core prefill
# tiles (v2g, v2, v3, v2f, v2h, v2s at 9 rows or more), in units of the
# largest sum of |terms| of an output: phase 2's limit for v2g's kernel at
# these rows. Each of those tiles runs an output's whole K through one
# chain of mma.sync accumulations, whose adds do not round to nearest:
# on 8b's activations the v2g tile read 1.14x the 1e-5 of 8a, the v2 tile
# 0.99x, the split halves of v2s 0.60x, while
# the group-dot tiles (a fresh accumulator per k16 slice) read 0.08x, and
# against the same function in f64 the tile read 1.11x where the f32
# torch.matmul of the plain version read 0.11x (H100: PERF.md)
PREFILL_TILE_LIMIT = 1e-4


def phase_variant_consistency(params, cfg, rng, device):
    """8b: 2 layers at full width, one 128-token prefill and 4 decode steps
    under each knob setting of 8c. The gate is one pass in which every
    packed matmul call runs the effective variant's kernel and its plain
    version on the same x and hands the plain output on, so both see the
    same inputs at every call (a bf16 rounding that flips between layers
    cannot reach the next call): each call within 8a's limit, 1e-5 of the
    largest sum of |terms| of an output, the head's logits also within
    3e-3 of their max|logit|. The prefill's calls on the per-weight
    variants' tensor-core prefill tiles are held to phase 2's limit for
    those tiles, 1e-4 (PREFILL_TILE_LIMIT), and read against 1e-5 as
    well. The same pass with control_of's plain version in place of the
    kernel must fail the per-call limit, and the pass counts the
    tensor-core and decode-tile launches the route gives. The same pass
    again with every decode-tile variant's threshold lowered to one row
    holds the decode steps' calls on the decode tiles call by call, those
    of the variants whose route leaves one row to the CUDA-core tile (v2g,
    v2s, v3, v2, v2f; v2p) among them. Beside it,
    information only: the kernels end to end against the plain versions
    end to end (their difference, argmax agreement), and each setting's
    kernel logits against v2g's (the variants round differently by
    design)."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul

    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 128)), device=device)
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4,)), device=device)
    fns = variant_fns()
    head = params["lm_head"]

    def through(plain: bool):
        def mm(x, rql):
            v = qmatmul.effective_v2_variant_for(rql)
            return fns[v][1 if plain else 0](x, rql, torch.bfloat16)
        return mm

    def shared(calls, control: bool):
        """every call: the kernel (or control_of's plain version) and the
        plain version on the same x, the plain output handed on"""
        def mm(x, rql):
            v = qmatmul.effective_v2_variant_for(rql)
            y_p = fns[v][1](x, rql, torch.bfloat16)
            if control:
                c_var, c_mxu = control_of(v, "bf16")
                y_k = fns[c_var][1](x, rql, mxu_dtype(c_mxu))
            else:
                y_k = fns[v][0](x, rql, torch.bfloat16)
            terms = max(variant_terms(x, rql, v, "bf16"), 1e-30)
            tile = (v in qmatmul.PER_WEIGHT_VARIANTS and x.shape[0] >= qmatmul.MMA_MIN_ROWS
                    and rql.d_out % 4 == 0)
            rec = dict(variant=v, M=x.shape[0], d_out=rql.d_out, prefill_tile=tile,
                       finite=bool(torch.isfinite(y_k).all()),
                       err=(y_k - y_p).abs().max().item(), tol_8a=1e-5 * terms,
                       tol=(PREFILL_TILE_LIMIT if tile else 1e-5) * terms)
            if rql is head:
                rec["logit_tol"] = 3e-3 * y_p.abs().max().item()
            if tile and not control:  # both against the same function in f64
                w, corrects = qmatmul._v2_operand(rql, v, torch.bfloat16)
                y64 = x.to(torch.bfloat16).double() @ w.double()
                del w
                if corrects:
                    y64 -= (x.double().reshape(x.shape[0], -1, rql.group_size).sum(-1)
                            @ qmatmul._folded_planes_v2(rql)[1].double())
                rec["kernel_vs_f64"] = (y_k - y64).abs().max().item()
                rec["plain_vs_f64"] = (y_p - y64).abs().max().item()
                del y64
            calls.append(rec)
            return y_p
        return mm

    def passes(calls):
        return [c for c in calls if c["finite"] and c["err"] <= c["tol"]
                and c["err"] <= c.get("logit_tol", np.inf)]

    out = {}
    base = two_layer_logits(params, cfg, prompt, feed, qmatmul.dequant_matmul_v2g, device)
    for variant, gs16, per_forward in variant_runs(2):
        label = variant + (f" (gs16 {gs16})" if gs16 else "")
        old = knobs(variant, gs16)
        calls, ctrl, dcalls = [], [], []
        rows = qmatmul.DECODE_MMA_MIN_ROWS
        low = dict(rows)
        try:
            reset_matmul_counts()
            two_layer_logits(params, cfg, prompt, feed, shared(calls, False), device)
            mma, dmma = mma_counts(), decode_counts()
            two_layer_logits(params, cfg, prompt, feed, shared(ctrl, True), device)
            lk = two_layer_logits(params, cfg, prompt, feed, through(False), device)
            lp = two_layer_logits(params, cfg, prompt, feed, through(True), device)
            rows.update(dict.fromkeys(qmatmul.DECODE_MMA_VARIANTS, 1))
            reset_matmul_counts()
            two_layer_logits(params, cfg, prompt, feed, shared(dcalls, False), device)
            dmma1 = decode_counts()
            want_dmma1 = want_decode(per_forward, [(1, 128)] + [(1, 1)] * 4, 2)
        finally:
            rows.update(low)
            knobs(*old)
        # the 128-row prefill's 4 x 2 projections on the variant's
        # tensor-core tiles, the 1-row head (v2p under v2m, v2g under v2t
        # and v2s) and the decode steps not; the calls of 1-8 rows on the
        # decode tiles from each variant's threshold
        if mma != {k: 8 if k == variant else 0 for k in mma}:
            raise RuntimeError(f"{label}: tensor-core launches {mma}")
        want_dmma = want_decode(per_forward, [(1, 128)] + [(1, 1)] * 4, 2)
        if dmma != want_dmma:
            raise RuntimeError(f"{label}: decode-tile launches {dmma}, want {want_dmma}")
        if dmma1 != want_dmma1:
            raise RuntimeError(f"{label}: decode-tile launches from one row {dmma1}, want "
                               f"{want_dmma1}")
        one_row = [c for c in dcalls if c["M"] < qmatmul.MMA_MIN_ROWS]
        if len(passes(dcalls)) != len(dcalls):
            raise RuntimeError(f"{label}: kernel and plain disagree on shared inputs with every "
                               f"one-row call on the decode tiles "
                               f"({len(dcalls) - len(passes(dcalls))} of {len(dcalls)} calls)")
        heads = [c for c in calls if "logit_tol" in c]
        worst = max(calls, key=lambda c: c["err"] / c["tol"])
        tiles = [c for c in calls if c["prefill_tile"]]
        worst_8a = max(c["err"] / c["tol_8a"] for c in calls)
        ctrl_bad = len(ctrl) - len(passes(ctrl))
        scale = lp.abs().max().item()
        err = (lk - lp).abs().max().item()
        d_g = (lk - base).abs().max().item()
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        log(f"{label} consistency (2 layers, prefill + 4 decode), every call on shared inputs: "
            f"{len(passes(calls))} of {len(calls)} calls within their limit, 1e-5 of their "
            f"terms ({PREFILL_TILE_LIMIT:g} on the {len(tiles)} per-weight prefill-tile calls; "
            f"worst {worst['variant']} M={worst['M']} d_out={worst['d_out']}: "
            f"{worst['err']:.3e} of {worst['tol']:.3e}; against 1e-5 at every call "
            f"{worst_8a:.2f}x at most, "
            f"{max((c['err'] / c['tol_8a'] for c in calls if not c['prefill_tile']), default=0):.2f}x"
            f" off the prefill tiles; prefill tiles against the same function in f64: kernel "
            f"{max((c['kernel_vs_f64'] / c['tol_8a'] for c in tiles), default=0):.2f}x, plain "
            f"{max((c['plain_vs_f64'] / c['tol_8a'] for c in tiles), default=0):.2f}x of 1e-5); "
            f"head logits {max(c['err'] for c in heads):.3e} against "
            f"3e-3 of max|logit| ({min(c['logit_tol'] for c in heads):.3e}); control "
            f"({', '.join(sorted({'/'.join(control_of(c['variant'], 'bf16')) for c in ctrl}))}) "
            f"rejected at {ctrl_bad} of {len(ctrl)} calls (least "
            f"{min(c['err'] / c['tol'] for c in ctrl):.1f}x the limit); "
            f"tensor-core launches {mma.get(variant, 0)}, decode tile {dmma}")
        log(f"{label} free-running (information): max|dlogit| kernels vs plain end to end "
            f"{err:.3e} (3e-3 of max|logit| {3e-3 * scale:.3e}); argmax agreement {agree:.2f}; "
            f"vs v2g's kernels {d_g:.3e}")
        log(f"{label} consistency, every call of 1-8 rows on the decode tiles (thresholds at "
            f"one row): {len(one_row)} such calls within 1e-5 of their terms (at most "
            f"{max(c['err'] / c['tol'] for c in one_row):.2f}x), decode tile "
            f"{ {k: n for k, n in dmma1.items() if n} }")
        if len(passes(calls)) != len(calls) or not torch.isfinite(lk).all():
            raise RuntimeError(f"{label}: kernel and plain disagree on shared inputs "
                               f"({len(calls) - len(passes(calls))} of {len(calls)} calls)")
        if ctrl_bad == 0:
            raise RuntimeError(f"{label}: the per-call limit does not reject the control")
        out[label] = dict(calls=len(calls), worst_err=worst["err"], worst_tol=worst["tol"],
                          worst_vs_1e5=worst_8a, prefill_tile_calls=len(tiles),
                          prefill_tile_vs_f64={
                              k: max((c[f"{k}_vs_f64"] / c["tol_8a"] for c in tiles), default=0)
                              for k in ("kernel", "plain")},
                          head_logit_err=max(c["err"] for c in heads),
                          head_logit_tol=min(c["logit_tol"] for c in heads),
                          control_rejected=ctrl_bad,
                          control_min_ratio=min(c["err"] / c["tol"] for c in ctrl),
                          one_row_decode=dict(
                              calls=len(one_row), launches=dmma1,
                              worst_vs_1e5=max(c["err"] / c["tol"] for c in one_row)),
                          free_running=dict(kernel_vs_plain=err, tol=3e-3 * scale,
                                            argmax_agreement=agree),
                          vs_v2g=d_g)
    return out


def phase_variant_serving(params, cfg, requests):
    """8c: phase 3's 12 requests under each knob setting, in turns between
    two v2g runs (the host-bound step drifts within a call), each with its
    exact launches per forward, and every call of each B=8 decode step on
    the decode tile of the variant that runs it."""
    from gptq_gguf_tpu_torch.ops import qmatmul

    runs = [("v2g", "", None)] + list(variant_runs(cfg.num_hidden_layers)) + [("v2g", "", None)]
    out = {}
    for i, (variant, gs16, per_forward) in enumerate(runs):
        label = variant + (f"+{gs16}" if gs16 else "")
        if variant == "v2g" and not gs16:
            label += " (before)" if i == 0 else " (after)"
        old = knobs(variant, gs16)
        try:
            counts, rec = phase_serving(params, cfg, requests, variant, label, per_forward)
            rec.pop("outputs")
        finally:
            knobs(*old)
        per_forward = per_forward or {variant: 4 * cfg.num_hidden_layers + 1}
        b8 = {k: n * rec["b8_steps"] for k, n in per_forward.items()
              if k in qmatmul.DECODE_MMA_VARIANTS}
        if not rec["b8_steps"] or any(rec["decode_mma_launches"][k] < n for k, n in b8.items()):
            raise RuntimeError(f"{label} serving: decode-tile launches "
                               f"{rec['decode_mma_launches']}, want at least {b8} "
                               f"({rec['b8_steps']} B=8 steps)")
        log(f"serving ({label}): every call of its {rec['b8_steps']} B=8 steps on the decode "
            f"tile ({b8}; in all {rec['decode_mma_launches']})")
        out[label] = dict(rec, counts=counts)
    ref = [out["v2g (before)"], out["v2g (after)"]]
    for label, rec in out.items():
        log(f"serving ({label}) in turns: {rec['serve_decode_ms_per_step']:.2f} ms per decode "
            f"step (v2g {ref[0]['serve_decode_ms_per_step']:.2f} before, "
            f"{ref[1]['serve_decode_ms_per_step']:.2f} after), steady B=8 "
            f"{rec['decode_ms_per_step']:.2f} ms (v2g {ref[0]['decode_ms_per_step']:.2f} / "
            f"{ref[1]['decode_ms_per_step']:.2f})")
    return out


def phase_variant_ppl(params, cfg, v2g):
    """8d: compute_perplexity(serving=True) on the 32-layer model under v2m,
    v2, v2t and v2s (phase 7d's data); each within 0.05 nats/token of
    v2g's (7d), every call on the tensor-core tiles (under v2m: v2m's, and
    v2p's on the all-position head; under v2t and v2s: theirs, and v2g's
    on the head), and v2m, v2t and v2s within 1e-3 nats/token of the same
    model through their plain versions."""
    import torch

    from gptq_gguf_tpu_torch.evals import ppl
    from gptq_gguf_tpu_torch.ops import qmatmul
    from gptq_gguf_tpu_torch.utils.data import get_data

    data = get_data("synthetic", PPL_SEQS * PPL_LEN, PPL_LEN, train=False, vocab_size=V)
    L = cfg.num_hidden_layers
    fns = variant_fns()
    out = {}
    for variant, want in (("v2m", {"v2m": 4 * L, "v2p": 1}), ("v2", {"v2": 4 * L + 1}),
                          ("v2t", {"v2t": 4 * L, "v2g": 1}), ("v2s", {"v2s": 4 * L, "v2g": 1})):
        old = knobs(variant, "")
        try:
            ppl.compute_perplexity(params, cfg, data[:1], serving=True)  # warm
            reset_matmul_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            value = ppl.compute_perplexity(params, cfg, data, serving=True)
            torch.cuda.synchronize()
            secs = (time.perf_counter() - t) / len(data)
        finally:
            knobs(*old)
        counts, mma = matmul_counts(), mma_counts()
        if any(counts[k] != want.get(k, 0) * len(data) for k in MATMUL_KERNELS):
            raise RuntimeError(f"ppl {variant}: launches {counts}, want {want} per sequence")
        if any(mma[k] != (want.get(k, 0) * len(data)) for k in mma):  # every call
            raise RuntimeError(f"ppl {variant}: tensor-core launches {mma}")
        if any(decode_counts().values()):
            raise RuntimeError(f"ppl {variant}: decode-tile launches {decode_counts()}")
        nll = float(np.log(value))
        out[variant] = dict(ppl=value, nll=nll, s_per_seq=secs, vs_v2g=nll - v2g["nll"],
                            launches={k: counts[k] for k in want},
                            mma_launches={k: mma[k] for k in want if k in mma})
        log(f"ppl ({variant}, serving path, {len(data)} x {PPL_LEN} tokens): {value:.4f} "
            f"({nll:.6f} nats/token, v2g {v2g['nll']:.6f}: {nll - v2g['nll']:+.3e}), "
            f"{secs:.3f} s per sequence (v2g {v2g['s_per_seq']:.3f}), launches "
            f"{out[variant]['launches']}")
        if not (np.isfinite(value) and abs(nll - v2g["nll"]) < 0.05):
            raise RuntimeError(f"ppl {variant}: {nll} nats/token against v2g's {v2g['nll']}")
        if variant != "v2":  # the same functions through the plain versions
            fn0 = qmatmul.dequant_matmul
            qmatmul.dequant_matmul = lambda x, rql: fns[qmatmul.effective_v2_variant_for(
                rql, variant=variant)][1](x, rql, torch.bfloat16)
            try:
                plain = float(np.log(ppl.compute_perplexity(params, cfg, data, serving=True)))
            finally:
                qmatmul.dequant_matmul = fn0
            out[variant]["plain_nll"] = plain
            log(f"ppl ({variant}): kernels {nll:.6f} vs plain version {plain:.6f} nats/token: "
                f"{nll - plain:+.3e} (bound 1e-3)")
            if not abs(nll - plain) < 1e-3:
                raise RuntimeError(f"ppl {variant}: kernels {nll} vs plain {plain}")
    return out


def variant_summary(name, source, replaces, variant, shapes, recs, launches, mma_launches,
                    core_launches=None):
    """The summary entry of one v2 variant kernel: one B=8 decode step (its
    calls among the four projections of every layer and the lm_head, at
    8a's M=8 times with bf16 operands, the dispatch's); its error is the
    largest of all its 8a cases. v2's entry adds its f32 operand mode.
    ``launches`` counts the CUDA-core tiles' launches of 8c's run (the
    calls of v2p, v2h, v2t, v2m, v2s, v3 and v2 at M = 8 are timed on that
    tile: on_core; their tensor-core decode tiles are
    qmatmul_<variant>_decode_mma), ``mma_launches`` its tensor-core tiles'
    (every prefill projection). Where the route gives the calls of 8c's
    run to the tensor-core tiles (Q4_DECODE_VARIANTS; a one-row prefill
    head below a threshold of 2 stays on the CUDA-core tile), ``launches``
    counts them all, as v4's entries do, and
    ``core_launches`` the CUDA-core tile's own (its times are that tile's:
    "tile")."""
    def entry(mxu):
        per = {r["name"].split()[0]: r for r in recs
               if r["variant"] == variant and r["mxu"] == mxu and r["M"] == 8}

        def step(key):
            return sum(per[k][key] * (1 if k == "lm_head" else N_LAYERS) for k in shapes)

        t_bytes = step("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = step("flops") / (BF16_FLOP_PER_S if mxu == "bf16" else F32_FLOP_PER_S) * 1e3
        return {"ms": step("ms"), "plain_ms": step("plain_ms"), "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": step("library_ms"), "bytes": step("bytes")}

    calls = sum(1 if k == "lm_head" else N_LAYERS for k in shapes)
    out = {"name": name, "route": "cuda", "source": f"gptq_gguf_tpu_torch/ops/csrc/{source}",
           "replaces": replaces, "launches": launches, "mma_launches": mma_launches,
           "max_abs_err": max(r["max_abs_err"] for r in recs if r["variant"] == variant),
           **entry("bf16"), "per": f"one B=8 decode step (bf16 operands): {calls} calls"}
    if core_launches is not None:
        out.update(core_launches=core_launches, tile="cuda_core")
    if all(any(r["variant"] == variant and r["mxu"] == "f32" and r["M"] == 8
                   and r["name"].split()[0] == k for r in recs) for k in shapes):
        out["f32"] = entry("f32")
    return out


def variant_launches(rec, variant: str, run: str) -> tuple:
    """(launches, mma_launches[, core_launches]) of ``variant``'s summary
    entry from 8c's run ``run`` (its record ``rec``): the CUDA-core tiles'
    launches, or for the variants of Q4_DECODE_VARIANTS, whose calls there
    run the tensor-core tiles, all of them and the CUDA-core tiles' beside."""
    mma = rec["mma_launches"] if variant == run else 0
    core = rec["counts"][variant] - mma - rec["decode_mma_launches"].get(variant, 0)
    if variant in Q4_DECODE_VARIANTS:
        return rec["counts"][variant], mma, core
    return core, mma


# the tensor-core tiles of the variants 8d scores with (phase 2's v2g and
# 8a's v2 / v3 / v2f / v2h are in mma_summary): summary name, source, the
# JAX body's line, variant, its shapes in one forward, the 8d run whose
# launches it reports
VARIANT_MMA_KERNELS = (
    ("qmatmul_v2m_mma", "qmatmul_v2m_mma.cuh", 729, "v2m", Q4_SHAPES, "v2m"),
    ("qmatmul_v2p_mma", "qmatmul_v2m_mma.cuh", 844, "v2p", ("lm_head",), "v2m"),
    ("qmatmul_v2t_mma", "qmatmul_v2m_mma.cuh", 789, "v2t", Q4_SHAPES, "v2t"),
    ("qmatmul_v2s_mma", "qmatmul_v2_mma.cuh", 660, "v2s", Q4_SHAPES, "v2s"))


def variant_mma_summary(name, source, line, variant, shapes, recs, launches):
    """The summary entry of one variant's tensor-core tiles: their share
    of one Llama-3-8B forward at M = 1024 (8a's times), the threshold M
    beside it; launches from 8d's perplexity run under that variant (v2p's
    under v2m: the all-position head; a serving head sees one row per
    sequence)."""
    from gptq_gguf_tpu_torch.ops import qmatmul

    calls = sum(1 if k == "lm_head" else N_LAYERS for k in shapes)
    return {"name": name, "route": "cuda", "source": f"gptq_gguf_tpu_torch/ops/csrc/{source}",
            "replaces": f"gptq_gguf_tpu/ops/qmatmul.py:{line}", "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs if r["variant"] == variant),
            **mma_forward(recs, variant, 1024, shapes),
            "per": f"one Llama-3-8B forward at M = 1024 (bf16 operands): {calls} calls",
            "at_min_rows": {"M": qmatmul.MMA_MIN_ROWS,
                            **mma_forward(recs, variant, qmatmul.MMA_MIN_ROWS, shapes)}}


def format_step(recs, fmt, shapes, M, ms_key="ms"):
    """One Llama-3-8B forward's share of ``shapes`` (each projection 32
    times, the lm_head once) at M rows from 7a's records in ``fmt``: the
    kernel's ms (``ms_key``: "ms" the route's tile, "core_ms" the
    CUDA-core tile beside a decode-tile case or a v1 tensor-core case),
    plain and library ms, and the bound (each record's operations at the
    rate of the tile it ran; f32 for v1's CUDA-core tile)."""
    per = {r["name"].split()[0]: r for r in recs if r["fmt"] == fmt and r["M"] == M}

    def total(key):
        return sum(per[k][key] * (1 if k == "lm_head" else N_LAYERS) for k in shapes)

    core = ms_key == "core_ms" and fmt == "v1"  # v1_kernel beside the tensor-core tiles
    t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
    t_ops = sum(per[k]["flops"] / (F32_FLOP_PER_S if core else per[k]["op_rate"])
                * (1 if k == "lm_head" else N_LAYERS) for k in shapes) * 1e3
    return {"ms": total(ms_key), "plain_ms": total("plain_ms"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": total("library_ms"), "bytes": total("bytes")}


def format_summary(name, source, replaces, body, fmt, shapes, recs, launches, mma_launches):
    """The summary entry of one v1 / v4 kernel body: one B=8 decode step
    (the four projections of every layer and / or the lm_head, at the M=8
    times of 7a in ``fmt``) on its CUDA-core tile (the route takes the
    decode tile there: qmatmul_v4_decode_mma_*, qmatmul_v1_decode_mma),
    and beside it the same calls at M = 1024 (one 8B forward's share, on
    the tensor-core tiles: qmatmul_v1_mma for v1); ``launches`` the
    body's in 7c (every tile), ``mma_launches`` its tensor-core launches
    in 7c / 7d (v1: and its CUDA-core tile's own, "core_serving" /
    "core_ppl"); its error is the largest of all its 7a cases."""
    calls = sum(1 if k == "lm_head" else N_LAYERS for k in shapes)
    step = format_step(recs, fmt, shapes, 8, "core_ms")
    return {"name": name, "route": "cuda", "source": f"gptq_gguf_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": launches, "mma_launches": mma_launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs if r["body"] == body),
            **step, "tile": "cuda_core",
            "per": f"one B=8 decode step ({fmt}) on the CUDA-core tile: {calls} calls",
            "at_1024": {**format_step(recs, fmt, shapes, 1024), "tile": "mma",
                        "per": f"one Llama-3-8B forward at M = 1024 ({fmt}, bf16 x): "
                               f"{calls} calls"}}


def v1_mma_summary(recs, launches):
    """The summary entry of v1's tensor-core tiles (csrc/qmatmul_v1_mma.cuh):
    one Llama-3-8B forward at M = 1024 with a bf16 x (4 x 32 projections
    and the unpadded head) from 7a's v1 records, v1_kernel's CUDA-core
    tile on the same inputs as "core_ms" (its f32 bound "core_bound_ms"),
    M = 128 and the threshold M under "at_m"; ``launches`` the tiles'
    launches in 7c's v1 serving run (every prefill projection; 7d's under
    "ppl_launches" and, at 1024 tokens, "ppl_long_launches"); its error
    the largest of its tensor-core cases."""
    from gptq_gguf_tpu_torch.ops import qmatmul

    def at(M):
        return {**format_step(recs, "v1", STEP, M),
                "core_ms": format_step(recs, "v1", STEP, M, "core_ms")["ms"],
                "core_bound_ms": format_step(recs, "v1", STEP, M, "core_ms")["bound_ms"]}

    return {"name": "qmatmul_v1_mma", "route": "cuda",
            "source": "gptq_gguf_tpu_torch/ops/csrc/qmatmul_v1_mma.cuh",
            "replaces": "gptq_gguf_tpu/ops/qmatmul.py:157", **launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs
                               if r["body"] == "v1" and r["tile"] == "mma"),
            **at(1024), "tile": "mma",
            "per": f"one Llama-3-8B forward at M = 1024 (v1, bf16 x): {4 * N_LAYERS + 1} calls",
            "at_m": {M: at(M) for M in (qmatmul.MMA_MIN_ROWS, 128)}}


def format_decode_summary(body, fmt, shapes, recs, launches):
    """The summary entry of v4's tensor-core decode tile for one body, or
    of v1's (body "v1"): one B=8 decode step at M = 8 from 7a's records in
    ``fmt`` (the CUDA-core tile's beside it), M = 1, 2 and 4 under "at_m";
    ``launches`` the body's decode-tile launches in 7c; its error the
    largest of its decode-tile cases."""
    calls = sum(1 if k == "lm_head" else N_LAYERS for k in shapes)
    if body == "v1":
        name, source, replaces = ("qmatmul_v1_decode_mma", "qmatmul_v1_mma.cuh",
                                  "gptq_gguf_tpu/ops/qmatmul.py:157")
    else:
        line = {"pb2": 264, "pb2_i8": 305, "pb1": 346}[body]
        name, source, replaces = (f"qmatmul_v4_decode_mma_{body}", "qmatmul_v4.cu",
                                  f"gptq_gguf_tpu/ops/qmv4.py:{line}")
    return {"name": name, "route": "cuda",
            "source": f"gptq_gguf_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs
                               if r["body"] == body and r["tile"] == "decode_mma"),
            **format_step(recs, fmt, shapes, 8), "tile": "decode_mma",
            "core_ms": format_step(recs, fmt, shapes, 8, "core_ms")["ms"],
            "per": f"one B=8 decode step ({fmt}) on the tensor-core decode tile "
                   f"(csrc/qmatmul_decode_mma.cuh): {calls} calls",
            "at_m": {M: {**format_step(recs, fmt, shapes, M),
                         "core_ms": format_step(recs, fmt, shapes, M, "core_ms")["ms"]}
                     for M in FORMAT_DECODE_MS}}


def paged_summary(name, source_line, krec, launches):
    """The summary entry of one paged kernel: one B=8 decode step at the
    first steady fill (300), one call per layer at the times of phase 6a;
    the same at the second (1900) under "at_1900"."""
    n = N_LAYERS

    def at(fill):
        r = krec["steady"][fill]
        return {"ms": r["ms"] * n, "plain_ms": r["plain_ms"] * n, "bound_ms": r["bound_ms"] * n,
                "bound_by": r["bound_by"], "library_ms": r["library_ms"] * n,
                "ms_per_call": r["ms"], "per": f"one B=8 decode step at fill {fill}: {n} calls"}

    return {"name": name, "route": "cuda",
            "source": "gptq_gguf_tpu_torch/ops/csrc/paged_decode.cu",
            "replaces": f"gptq_gguf_tpu/ops/paged_attention.py:{source_line}",
            "launches": launches, "max_abs_err": krec["max_abs_err"], **at(STEADY_FILLS[0]),
            f"at_{STEADY_FILLS[1]}": at(STEADY_FILLS[1])}


def run(device) -> dict:
    """All twelve phases on ``device``; returns the kernel summary."""
    import torch

    t_start = time.time()
    rng = np.random.default_rng(SEED)
    log("== phase 1: device and build")
    finish_build = phase_device_and_build()
    # while nvcc runs: phase 2's weights are packed on the card (no kernel)
    # and, once the solve kernel is built, phase 5's two quantize walks run
    # (they launch no other kernel); their temporary directory lasts to
    # phase 12
    t = time.time()
    params, cfg = build_8b(rng, device)
    log(f"weights: {N_LAYERS} layers + lm_head packed in {time.time() - t:.1f} s")
    tmpdir = tempfile.TemporaryDirectory(prefix="chip_smoke_gptq_")
    finish_build("gptq_solve")
    log("== phase 5 (its quantize walks, while the other kernels build)")
    g_launches, gptq_rec, solves, arts = phase_gptq_quantize(Path(tmpdir.name), device)
    finish_build()
    log(f"phase 1 took {time.time() - t_start:.1f} s (the weights and the walks meanwhile)")
    log("== phase 2: kernel vs plain version")
    recs = phase_kernels(params, rng, device)
    mrecs = phase_mma_kernels(params, ("v2g",), device)
    drecs = phase_decode_mma_kernels(params, device, rng)
    log("== phase 3: full-width serving")
    requests = serve_requests(rng, cfg, 12, *SERVE_MIX)
    counts, serve = phase_serving(params, cfg, requests)
    greedy = serve.pop("outputs")
    # the CUDA-core tiles' own: the one-row heads of the prefills
    launches = counts["v2g"] - serve["mma_launches"] - serve["decode_mma_launches"]["v2g"]
    if launches == 0:
        raise RuntimeError("serving: no launch of v2g's CUDA-core tile")
    log("== phase 4: consistency")
    phase_consistency(params, cfg, rng, device)
    log("== phase 9: sampled decoding and the int8 / int4 caches")
    # at a cut depth (phase 11 keeps chip_smoke inside its limit): its greedy
    # reference is phase 3's mix served again at that depth
    cut9 = dataclasses.replace(cfg, num_hidden_layers=SAMPLED_SERVING_LAYERS)
    p9 = {**params, "layers": params["layers"][:SAMPLED_SERVING_LAYERS]}
    _, g9 = phase_serving(p9, cut9, requests, "v2g", f"greedy, depth {SAMPLED_SERVING_LAYERS}",
                          steady=False)
    sampled = phase_sampling_and_kv(p9, cut9, rng, requests, g9.pop("outputs"), device)
    del p9
    log("== phase 6: paged serving at full width")
    t6 = time.time()
    precs = phase_paged_kernels(rng, device)
    phase_paged_consistency(params, cfg, rng, device)
    # 6c-e at a cut depth, likewise
    cut6 = dataclasses.replace(cfg, num_hidden_layers=PAGED_SERVING_LAYERS)
    paged_runs, paged_eng = phase_paged_serving(
        {**params, "layers": params["layers"][:PAGED_SERVING_LAYERS]}, cut6, rng, device)
    paged_rec = dict(runs=paged_runs, steady=phase_paged_steady(paged_eng, cut6, device),
                     http=phase_paged_http(paged_eng, cut6, rng))
    log(f"phase 6 took {time.time() - t6:.1f} s")
    del paged_eng
    torch.cuda.empty_cache()

    log("== phase 7: v1 and v4 formats at full width")
    t7 = time.time()
    frecs = phase_format_kernels(params, rng, device)
    fparams = {"v2": params, **{f: format_params(params, f) for f in ("v1", "v4", "v4 i8")}}
    cross = phase_format_consistency(fparams, cfg, rng, device)
    fserve = {}
    # 7c at a cut depth (phase 10 keeps chip_smoke inside its limit); v2 at
    # the same depth before and after the others: the host-bound step drifts
    # within a call, so each format is read between two v2 runs
    cut = dataclasses.replace(cfg, num_hidden_layers=FORMAT_SERVING_LAYERS)
    for fmt, kernel in (("v2 before", "v2g"), ("v1", "v1"), ("v4", "v4"), ("v4 i8", "v4"),
                        ("v2", "v2g")):
        fp = fparams[fmt.split()[0] if fmt == "v2 before" else fmt]
        fcounts, rec = phase_serving({**fp, "layers": fp["layers"][:FORMAT_SERVING_LAYERS]}, cut,
                                     requests, kernel, fmt)
        rec.pop("outputs")
        if kernel == "v1":  # phase_serving held every call of 1-8 rows to the decode tile
            b8 = (4 * FORMAT_SERVING_LAYERS + 1) * rec["b8_steps"]
            if not rec["b8_steps"] or rec["decode_mma_launches"]["v1"] < b8:
                raise RuntimeError(f"v1 serving: decode-tile launches "
                                   f"{rec['decode_mma_launches']['v1']}, want at least {b8} "
                                   f"({rec['b8_steps']} B=8 steps)")
            log(f"serving (v1): every call of its {rec['b8_steps']} B=8 steps on the decode "
                f"tile ({b8}; in all {rec['decode_mma_launches']['v1']})")
        if kernel == "v4":
            n = rec["forwards"]
            body = "v4_pb2_i8" if fmt == "v4 i8" else "v4_pb2"
            if fcounts[body] != 4 * FORMAT_SERVING_LAYERS * n or fcounts["v4_pb1"] != n:
                raise RuntimeError(f"{fmt} serving: body launches {fcounts}, {n} forwards")
            # phase_serving held the decode tile's total to every call of
            # 2-8 rows; both bodies among them
            decode = rec["decode_mma_launches"]["v4"]
            if (fcounts[f"{body}_decode_mma"] + fcounts["v4_pb1_decode_mma"] != decode
                    or not fcounts[f"{body}_decode_mma"] or not fcounts["v4_pb1_decode_mma"]):
                raise RuntimeError(f"{fmt} serving: decode-tile launches {fcounts}")
        fserve[fmt] = dict(rec, counts=fcounts)
    base = fserve["v2 before"]
    for fmt in ("v1", "v4", "v4 i8", "v2"):
        rec = fserve[fmt]
        log(f"serving ({fmt}, depth {FORMAT_SERVING_LAYERS}) beside the v2 run before it: "
            f"{rec['serve_decode_ms_per_step']:.2f} vs {base['serve_decode_ms_per_step']:.2f} ms "
            f"per decode step, {rec['generated_tok_s']:.1f} vs {base['generated_tok_s']:.1f} "
            f"generated tok/s; steady B=8 {rec['decode_ms_per_step']:.2f} vs "
            f"{base['decode_ms_per_step']:.2f} ms")
    fppl = phase_format_ppl(fparams, cfg, device)
    log(f"phase 7 took {time.time() - t7:.1f} s")
    del fparams
    torch.cuda.empty_cache()

    log("== phase 8: the v2 kernel variants at full width")
    t8 = time.time()
    vrecs = phase_variant_kernels(params, rng, device)
    vdrecs = phase_v2p_decode_kernels(params, device, rng)
    vdrecs += phase_v2h_v2t_decode_kernels(params, device, rng)
    vcrecs = vrecs
    for variant, *_ in VARIANT_DECODE_KERNELS:
        vcrecs = on_core(vcrecs, vdrecs, variant)
    mrecs += phase_mma_kernels(params, ("v2", "v3", "v2f", "v2h", "v2s"), device, rng,
                               V2S_SMALL)
    gdrecs = phase_mma_kernels(params, ("v2m", "v2t"), device, rng, GROUP_DOT_SMALL)
    vcross = phase_variant_consistency(params, cfg, rng, device)
    # 8c at a cut depth: phase 9's serving runs keep chip_smoke inside its limit
    vserve = phase_variant_serving(
        {**params, "layers": params["layers"][:VARIANT_SERVING_LAYERS]},
        dataclasses.replace(cfg, num_hidden_layers=VARIANT_SERVING_LAYERS), requests)
    vppl = phase_variant_ppl(params, cfg, fppl["v2"])
    log(f"phase 8 took {time.time() - t8:.1f} s")
    del params
    torch.cuda.empty_cache()

    log("== phase 5: GPTQ at full width")
    grecs = phase_gptq_kernel(rng, device)
    with tmpdir as tmp:
        gptq_rec["whole_o_solve"] = phase_gptq_whole_solve(solves, device)
        gptq_rec["static_groups_bs0"] = phase_gptq_static_groups(Path(tmp), solves, device)
        del solves
        phase_gptq_to_serving(arts, device)
        gptq_formats, v2_layers = phase_gptq_formats(Path(tmp) / "ckpt", Path(tmp) / "layers",
                                                     arts, device)
        q4_gguf, gptq_rec["pack"] = phase_gptq_pack(Path(tmp), arts, v2_layers,
                                                    gptq_formats["v2"], device)
        gptq_rec["mixed"] = phase_gptq_mixed(Path(tmp), q4_gguf, v2_layers, device)
        del v2_layers
        log("== phase 10: the llama-quantize route (imatrix, recipes, rtn-quantize)")
        recipes_rec = phase_recipes(Path(tmp), device)
        log("== phase 11: the qwen3 and qwen2 families, checkpoint to served tokens")
        families_rec = phase_families(Path(tmp), device)
        log("== phase 12: the rest of evals/ and the search's leftovers")
        evals_rec = phase_evals(Path(tmp), q4_gguf, device)

    # the kernel's numbers for one decode step at B=8: the four projections
    # of every layer plus the lm_head, at the M=8 shapes measured above
    per_shape = {r["name"].split()[0]: r for r in recs if r["M"] == 8}

    def per_step(key):
        layer = sum(per_shape[k][key] for k in ("qkv", "o", "gateup", "down"))
        return layer * cfg.num_hidden_layers + per_shape["lm_head"][key]

    t_bytes = per_step("bytes") / HBM_BYTES_PER_S * 1e3
    t_ops = per_step("flops") / BF16_FLOP_PER_S * 1e3
    layer_planes = sum(per_shape[k]["plane_bytes"] for k in ("qkv", "o", "gateup", "down"))
    log(f"one B=8 decode step: {int(per_step('bytes'))} bytes read by the kernel "
        f"(planes {int(per_step('plane_bytes'))}, of which {layer_planes} per layer), "
        f"byte bound {t_bytes:.4f} ms, operation bound {t_ops:.4f} ms")
    # the solve kernel's numbers for one 8B-width layer at Q4_K: 208 launches
    # at the shapes measured above
    q4 = [r for r in grecs if r["qtype"] == "Q4_K"]

    def per_layer(key):
        return sum(r[key] * r["per_layer"] for r in q4)

    g_bytes = per_layer("bytes") / HBM_BYTES_PER_S * 1e3
    g_ops = per_layer("ops") / F32_FLOP_PER_S * 1e3
    log(f"one 8B-width layer of GPTQ solves: {int(per_layer('bytes'))} bytes, "
        f"{per_layer('ops'):.4e} f32 operations; kernel {per_layer('ms'):.3f} ms, byte bound "
        f"{g_bytes:.4f} ms, operation bound {g_ops:.4f} ms")
    summary = {"kernels": [{
        "name": "qmatmul_v2g", "route": "cuda",
        "source": "gptq_gguf_tpu_torch/ops/csrc/qmatmul_v2g.cu",
        "replaces": "gptq_gguf_tpu/ops/qmatmul.py:605",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": per_step("library_ms"),
        "per": f"one B=8 decode step on the CUDA-core tile (the route runs it at one "
               f"row and with f32 operands): {4 * cfg.num_hidden_layers + 1} calls",
    }, {
        "name": "gptq_solve", "route": "cuda",
        "source": "gptq_gguf_tpu_torch/ops/csrc/gptq_solve.cu",
        "replaces": "gptq_gguf_tpu/ops/gptq.py:240",
        "launches": g_launches,
        "max_abs_err": max(r["max_abs_err"] for r in grecs),
        "ms": per_layer("ms"), "plain_ms": per_layer("plain_ms"),
        "bound_ms": max(g_bytes, g_ops),
        "bound_by": "bytes" if g_bytes >= g_ops else "operations",
        "library_ms": None,
        "per": f"one Llama-3-8B-width layer at Q4_K: {sum(r['per_layer'] for r in q4)} calls",
        "wide": [{k: r[k] for k in ("qtype", "d_row", "bs", "ms", "plain_ms", "bound_ms")}
                 for r in grecs if r["bs"] != BLOCK],
    }, paged_summary("paged_flash_decode", 70, precs["paged_flash_decode"],
                     paged_runs["bf16"]["launches"]),
        paged_summary("paged_flash_decode_q4", 160, precs["paged_flash_decode_q4"],
                      paged_runs["int4"]["launches"])] + [
        format_summary(name, source, replaces, body, fmt, shapes, frecs,
                       fserve[fmt]["counts"][f"v4_{body}"] if body != "v1"
                       else fserve["v1"]["counts"]["v1"],
                       {"serving": fserve[fmt]["counts"].get(f"v4_{body}_mma", 0),
                        "ppl": fppl[fmt]["counts"].get(f"v4_{body}_mma", 0) if fmt in fppl
                        else None} if body != "v1"
                       else {"serving": fserve["v1"]["mma_launches"],
                             "ppl": fppl["v1"]["mma_launches"],
                             "core_serving": fserve["v1"]["counts"]["v1"]
                             - fserve["v1"]["mma_launches"]
                             - fserve["v1"]["decode_mma_launches"]["v1"],
                             "core_ppl": fppl["v1"]["launches"] - fppl["v1"]["mma_launches"]})
        for name, source, replaces, body, fmt, shapes in V1_V4_BODIES] + [
        v1_mma_summary(frecs, {"launches": fserve["v1"]["mma_launches"],
                               "ppl_launches": fppl["v1"]["mma_launches"],
                               "ppl_long_launches": fppl["v1 long"]["mma_launches"]})] + [
        format_decode_summary(body, fmt, shapes, frecs,
                              fserve[fmt]["counts"][f"v4_{body}_decode_mma"] if body != "v1"
                              else fserve["v1"]["decode_mma_launches"]["v1"])
        for _, _, _, body, fmt, shapes in V1_V4_BODIES] + [
        variant_summary(name, source, f"gptq_gguf_tpu/ops/qmatmul.py:{line}", variant, shapes,
                        vcrecs, *variant_launches(vserve[run], variant, run))
        for name, source, line, variant, shapes, run in V2_VARIANT_KERNELS] + [
        variant_decode_summary(variant, source, line, shapes, vdrecs,
                               vserve[run]["decode_mma_launches"][variant])
        for variant, source, line, shapes, run in VARIANT_DECODE_KERNELS] + [
        mma_summary(mrecs, serve["mma_launches"]),
        decode_summary(drecs, serve["decode_mma_launches"]["v2g"])] + [
        variant_mma_summary(name, source, line, variant, shapes, mrecs + gdrecs,
                            vppl[run]["mma_launches"][variant])
        for name, source, line, variant, shapes, run in VARIANT_MMA_KERNELS],
        "serving": serve, "sampling": sampled, "gptq": gptq_rec, "paged": paged_rec,
        "recipes": recipes_rec, "families": families_rec, "evals": evals_rec,
        "formats": dict(serving=fserve, ppl=fppl, logits_between_formats=cross,
                        gptq_greedy=gptq_formats),
        "variants": dict(serving=vserve, ppl=vppl, logits=vcross),
        "seconds": time.time() - t_start}
    # phase 11's launches beside each kernel's main-path count
    fam = families_rec
    fam_launches = {
        "qmatmul_v2g": {f: fam[f]["serve"]["v2g_launches"] for f in ("qwen3", "qwen2")},
        "gptq_solve": {"qwen3": fam["qwen3"]["solve_launches"],
                       "qwen2_down": fam["qwen2"]["solves"]["launches"]},
        "paged_flash_decode": {"qwen3": fam["qwen3"]["engines"]["paged_launches"]}}
    for k in summary["kernels"]:
        if k["name"] in fam_launches:
            k["families_launches"] = fam_launches[k["name"]]
    # phase 12's: parity's GPTQ walks and its GGUFs scored through serving
    par = evals_rec["parity"]
    for k in summary["kernels"]:
        if k["name"] in ("qmatmul_v2g", "gptq_solve"):
            key = "v2g_launches" if k["name"] == "qmatmul_v2g" else "solve_launches"
            k["evals_launches"] = {bw: par[bw][key] for bw in ("Q4_K", "Q6_K")}
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import gptq_gguf_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    summary = run(torch.device("cuda"))
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
