#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / H100 port (gptq_gguf_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without a card or outside a
checkout of the repository. Phases, each raising on failure:

1. device and build: the card's name and power limit; the kernels are
   built from gptq_gguf_tpu_torch/ops/csrc/ (one nvcc per source, all at
   once) and their build times printed;
2. kernel against its plain PyTorch version on the card, at every
   projection shape of Llama-3-8B (Q4_K, Q6_K lm_head) at M = 8 and 128,
   plus Q2_K / Q3_K / Q5_K and a ragged d_out: error, kernel / plain /
   library ms, and the bound at the card's published rates; then v2g's
   tensor-core prefill tiles (csrc/qmatmul_v2_mma.cuh) at the same shapes
   at the threshold M (qmatmul.MMA_MIN_ROWS) and M = 1024, each within
   1e-5 of its largest sum of |terms| with a planted control that must
   fail that limit, timed beside the 8-row CUDA-core tile and bf16
   torch.matmul;
3. full-width serving: Llama-3-8B widths, synthetic v2 weights from a seed,
   ContinuousBatchingEngine(num_slots=8, max_len=2048) serving 12 requests;
   checks budgets, token ranges and the kernel's launch count (every
   prefill projection on the tensor-core tiles, no decode step), and
   prints decode tok/s and ms/step (plus a steady B=8 block);
4. consistency: 2 layers at full width, one prefill plus 4 decode steps
   through the kernel and through the plain version, logits compared (the
   prefill's 8 projections on the tensor-core tiles);
5. GPTQ at full width: the column-block solve kernel against its plain
   version at every Llama-3-8B solve shape (bit-equal); the ``quantize``
   command line on a seeded 2-layer Llama-3-8B-width bf16 checkpoint with
   262144 synthetic calibration tokens, once as a user runs it (14
   artifacts, 416 kernel launches, GPTQ objective at or below RTN's on
   every linear, seconds per layer) and once instrumented (the stage
   breakdown, the refit's and the factorizations' seconds); one whole
   o-projection solve through the kernel and through the plain version;
   the artifacts packed into the v2 serving format and run through v2g;
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
   pool (budgets, pages returned, 32 kernel launches per decode step); a
   steady B=8 step at fill 300 and 1900; HTTP (serve_http on port 0): 8
   concurrent requests equal the engine's direct outputs, one streamed;
7. the v1 and v4 runtime formats at full width (after phase 6, on the same
   model: the v2 weights converted on the card, every format's planes held
   to the package's packers first): (a) the v1 kernel and the v4 kernel's
   three bodies (f32 and bf16 scales, i32 and i8 layouts) against their
   plain versions at every 8B projection shape and the unpadded Q6_K
   lm_head at M = 8, the threshold M, 128, 1024 (v4 from the threshold on
   its tensor-core tiles, within 1e-5 of the largest sum of |terms| with a
   planted control, unrounded weights, that must fail that limit), plus
   Q2_K / Q3_K / Q5_K and ragged d_out; (b) 2-layer logits kernel vs plain
   per format; (c) phase 3's 12 requests served in v1, v4 and v4 i8 (129
   launches of that format's kernel per forward, none of another's; v4's
   every prefill projection on the tensor-core tiles, no decode step)
   beside phase 3's v2 numbers; (d) perplexity through the serving path on
   the 32-layer model in v2, v1 and v4 (2 sequences of 512 tokens, within
   0.05 nats/token of each other; v2's and v4's every call on the
   tensor-core tiles, each within 1e-3 nats/token of the same model
   through the plain version); (e)
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
   v3, v2f and v2h as phase 2 holds v2g's; (b) 2-layer logits through
   each variant's kernels against its plain versions, and the differences
   between variants; (c) phase 3's 12 requests served under
   PALLAS_V2_VARIANT = v2, v2m, v2t, v2g with the gs=16 knob at v2p, v3,
   v2f, v2h and v2s, in turns between two v2g runs, each with its exact
   launches per forward; (d) perplexity through the serving path under
   v2m and v2, within 0.05 nats/token of v2g's (phase 7d); v2's every call
   on the tensor-core tiles, v2m's none.

The second-to-last line is the kernel summary JSON, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import re
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12   # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12     # f32 on the CUDA cores
SEED = 7
V, H, I, N_LAYERS, N_HEAD, N_KV, HD = 128256, 4096, 14336, 32, 32, 8, 128


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of fn() over reps calls: CUDA events around each
    call, ``flush`` (L2 eviction) outside them. A device sleep queued first
    keeps the card busy while the host queues every call, so host overhead
    between the events is not counted."""
    import torch

    fn()
    fn()  # warm-up: first-call library setup stays out
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
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
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


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


def phase_device_and_build():
    import torch

    from gptq_gguf_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    def timed_build(name):
        t0 = time.time()
        out = cuda_build.build(name)
        return out, time.time() - t0

    names = ("qmatmul_v2g", "gptq_solve", "paged_decode", "qmatmul_v1", "qmatmul_v4",
             "qmatmul_v2", "qmatmul_v2m", "qmatmul_v3")
    with ThreadPoolExecutor(len(names)) as ex:  # one nvcc per source, all at once
        builds = dict(zip(names, ex.map(timed_build, names)))
    for name, (nvcc_log, secs) in builds.items():
        log(f"build: {name} in {secs:.1f} s ({'cached' if nvcc_log is None else 'built'})")
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", nvcc_log or "")]
        spill = sum(int(m) for m in re.findall(r"(\d+) bytes spill", nvcc_log or ""))
        if regs:
            log(f"  ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
                f"{spill} bytes of spill stores and loads")


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
    plain_ms = cuda_ms(lambda: qmatmul.dequant_matmul_v2g_reference(x, rql), 3, flush)
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
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T

    cases = step_shapes(params)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    flush = flush_buf.zero_
    recs = []
    for M in (8, 128):
        for name, rql in cases:
            x = (torch.randn(M, rql.d_in_local, device=device) * 0.5).to(torch.bfloat16)
            recs.append(kernel_case(name, x, rql, flush))
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
        recs.append(kernel_case(name, x, rql, flush))
    return recs


def phase_mma_kernels(params, variants, device):
    """The tensor-core tiles of ``variants`` (bf16 operands) against their
    plain versions at every Llama-3-8B projection shape and the padded Q6_K
    lm_head, at the threshold M and at M = 1024 (variant_case: within 1e-5
    of the largest sum of |terms|, with a planted control that must fail
    that limit); beside each, the 8-row CUDA-core tile at the same M (still
    built: f32 operands and v2s run it) on the same inputs."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device).zero_
    recs = []
    for M in (qmatmul.MMA_MIN_ROWS, 1024):
        for name, rql in step_shapes(params):
            x = (torch.randn(M, rql.d_in_local, device=device) * 0.5).to(torch.bfloat16)
            for v in variants:
                fn = getattr(qmatmul, qmatmul.V2_WRAPPERS[v])
                m0 = fn.mma_launches
                rec = variant_case(name, v, "bf16", x, rql, flush)
                if fn.mma_launches == m0:
                    raise RuntimeError(f"{v} {name} M={M}: not on the tensor-core tiles")
                lib, build = qmatmul._PER_WEIGHT[v]
                rec["core8_ms"] = cuda_ms(lambda: qmatmul._launch_v2(
                    lib, build, x, rql, torch.bfloat16, 8), 3, flush)
                rec["tflop_s"] = rec["flops"] / rec["ms"] / 1e9
                log(f"  {v:>3} {name:>24} M={M:<4} tensor-core {rec['ms']:.4f} ms "
                    f"({rec['tflop_s']:.1f} TFLOP/s), 8-row CUDA-core tile "
                    f"{rec['core8_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, bound "
                    f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
                recs.append(rec)
            del x
            torch.cuda.empty_cache()
    return recs


def mma_summary(recs, launches):
    """The summary entry of the tensor-core tiles: one Llama-3-8B forward
    at M = 1024 (4 x 32 projections and the lm_head, bf16 operands) under
    v2g, from phase 2's records; each variant's forward and the threshold
    M beside it. Its error is the largest of every tensor-core case."""
    from gptq_gguf_tpu_torch.ops import qmatmul

    def forward(variant, M):
        per = {r["name"].split()[0]: r for r in recs if r["variant"] == variant and r["M"] == M}

        def total(key):
            return sum(per[k][key] * (1 if k == "lm_head" else N_LAYERS) for k in STEP)

        t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = total("flops") / BF16_FLOP_PER_S * 1e3
        return {"ms": total("ms"), "plain_ms": total("plain_ms"),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": total("library_ms"), "core8_ms": total("core8_ms")}

    return {"name": "qmatmul_v2_mma", "route": "cuda",
            "source": "gptq_gguf_tpu_torch/ops/csrc/qmatmul_v2_mma.cuh",
            "replaces": "gptq_gguf_tpu/ops/qmatmul.py:605", "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs), **forward("v2g", 1024),
            "per": f"one Llama-3-8B forward at M = 1024 (v2g, bf16 operands): "
                   f"{4 * N_LAYERS + 1} calls",
            "at_min_rows": {"M": qmatmul.MMA_MIN_ROWS, **forward("v2g", qmatmul.MMA_MIN_ROWS)},
            "variants": {v: {M: forward(v, M) for M in (qmatmul.MMA_MIN_ROWS, 1024)}
                         for v in qmatmul.MMA_VARIANTS if v != "v2g"}}


# the dequant-matmul wrappers: one per format, and the v2 format's variants
MATMUL_KERNELS = ("v2g", "v1", "v4", "v2", "v3", "v2f", "v2h", "v2s", "v2m", "v2t", "v2p")


def matmul_wrappers():
    from gptq_gguf_tpu_torch.ops import qmatmul, qmv4

    return {"v1": qmatmul.dequant_matmul_v1, "v4": qmv4.dequant_matmul_v4,
            **{v: getattr(qmatmul, name) for v, name in qmatmul.V2_WRAPPERS.items()}}


def reset_matmul_counts() -> None:
    """Every dequant-matmul wrapper's launch count to 0 (its tensor-core
    count too, and the v4 wrapper's counts per JAX body)."""
    fns = matmul_wrappers()
    for fn in fns.values():
        fn.launches = 0
        if hasattr(fn, "mma_launches"):
            fn.mma_launches = 0
    fns["v4"].body_launches = dict.fromkeys(fns["v4"].body_launches, 0)
    fns["v4"].body_mma_launches = dict.fromkeys(fns["v4"].body_mma_launches, 0)


def mma_counts() -> dict:
    """kernel -> tensor-core launches of its wrapper (the per-weight v2
    builds but v2s, and v4: csrc/qmatmul_mma.cuh)."""
    from gptq_gguf_tpu_torch.ops import qmatmul, qmv4

    return {**{v: getattr(qmatmul, qmatmul.V2_WRAPPERS[v]).mma_launches
               for v in qmatmul.MMA_VARIANTS},
            "v4": qmv4.dequant_matmul_v4.mma_launches}


def matmul_counts() -> dict:
    fns = matmul_wrappers()
    out = {k: fn.launches for k, fn in fns.items()}
    out.update({f"v4_{b}": n for b, n in fns["v4"].body_launches.items()})
    out.update({f"v4_{b}_mma": n for b, n in fns["v4"].body_mma_launches.items()})
    return out


def phase_serving(params, cfg, requests, kernel="v2g", label="v2", per_forward=None):
    """ContinuousBatchingEngine(num_slots=8, max_len=2048) on ``requests``
    with ``params`` in one runtime format: budgets, token ranges, and every
    packed matmul through ``kernel``'s wrapper (4 per layer + the lm_head
    per forward; or the launches per forward ``per_forward`` names, by
    wrapper) and no other's; every projection of a prefill (16 rows or
    more) on the tensor-core tiles when ``kernel`` has them, and nothing of
    a decode step (8 rows) or a head (each sequence's last row); then a
    steady B=8 decode block."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul
    from gptq_gguf_tpu_torch.serving import engine, model as qmodel

    n_fwd = [0]
    rows = []
    decode = {"s": 0.0, "steps": 0}
    fwd0, scan0 = qmodel.forward_cached, engine._decode_steps_scan

    def counting_forward(*a, **kw):
        n_fwd[0] += 1
        rows.append(a[2].numel())
        return fwd0(*a, **kw)

    def timed_scan(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = scan0(*a, **kw)
        torch.cuda.synchronize()
        decode["s"] += time.perf_counter() - t
        decode["steps"] += a[4] if len(a) > 4 else kw["k"]
        return out

    eng = engine.ContinuousBatchingEngine(params, cfg, num_slots=8, max_len=2048)
    uids = {eng.submit(p, max_new_tokens=n) for p, n in requests}
    qmodel.forward_cached, engine._decode_steps_scan = counting_forward, timed_scan
    reset_matmul_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        qmodel.forward_cached, engine._decode_steps_scan = fwd0, scan0
    counts = matmul_counts()
    mma = mma_counts()
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
    log(f"serving decode: {decode['steps']} block steps in {decode['s']:.3f} s "
        f"= {decode['s'] / max(decode['steps'], 1) * 1e3:.2f} ms/step, "
        f"{(gen_tokens - 12) / decode['s']:.1f} generated tok/s")
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
    return counts, dict(wall_s=wall, decode_ms_per_step=dt * 1e3, decode_tok_s=8 / dt,
                        serve_decode_ms_per_step=decode["s"] / max(decode["steps"], 1) * 1e3,
                        generated_tok_s=(gen_tokens - 12) / decode["s"], launches=launches,
                        mma_launches=mma.get(kernel, 0), prefill_forwards=n_prefill,
                        forwards=n_fwd[0])


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
    reset_matmul_counts()
    lk = run(qmatmul.dequant_matmul_v2g)
    n_mma = mma_counts()["v2g"]
    log(f"consistency: {n_mma} tensor-core launches (the 128-row prefill's 4 x 2 "
        f"projections; its 1-row head and the 4 decode steps on the decode tiles)")
    if n_mma != 4 * 2:
        raise RuntimeError(f"consistency: {n_mma} tensor-core launches, want 8")
    lp = run(qmatmul.dequant_matmul_v2g_reference)
    lc = run(exact_f32)
    # tolerance: kernel and plain differ in f32 sum order only; bf16
    # rounding of the activations between layers turns that into rare
    # 1-ulp flips. The limit sits between that error and the control's,
    # which drops the bf16 rounding of the matmul's inputs.
    scale = lp.abs().max().item()
    err = (lk - lp).abs().max().item()
    err_c = (lc - lp).abs().max().item()
    tol = 3e-3 * scale
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    log(f"consistency (2 layers, prefill + 4 decode): max|dlogit| kernel {err:.3e}, "
        f"exact-f32 control {err_c:.3e}, tol {tol:.3e} (3e-3 of max|logit| "
        f"{scale:.3e}); argmax agreement {agree:.2f}")
    if not (torch.isfinite(lk).all() and err <= tol):
        raise RuntimeError("kernel and plain logits disagree")
    if not err_c > tol:
        raise RuntimeError("the limit does not tell the exact-f32 control from the plain version")


# ---------------------------------------------------------------------------
# Phase 5: GPTQ at full width
# ---------------------------------------------------------------------------

GPTQ_LAYERS = 2           # depth of the quantized checkpoint (every layer is the same work)
# the command line's documented calibration set: 262144 tokens in sequences
# of its default length, min(max_position_embeddings, 4096); at this size
# the capture takes the flash-attention branch and the activations (4 GiB)
# live in host memory between blocks
CALIB_TOKENS, CALIB_SEQ = 262144, 4096
BLOCK = 128               # the default GPTQ block
# (name, rows of one block solve, column blocks per 8B layer): q/k/v solved
# row-concatenated, o, gate/up row-concatenated, down over 14336 columns
SOLVE_SHAPES = (("qkv", 6144, 32), ("o", 4096, 32), ("gateup", 28672, 32), ("down", 4096, 112))


def solve_cost(d_row: int, bs: int):
    """(bytes, f32 operations) one block solve needs: w, s, z read and q,
    err written once, U's block read once; per row and column i ten
    operations for q and err, two per later column for the update."""
    return 4 * (5 * d_row * bs + bs * bs), d_row * (10 * bs + bs * (bs - 1))


def solve_inputs(rng, U, d_row, qtype, device):
    """One block's w, U and per-column s / z: s / z from a K-quant fit of
    a w-like (d_row, 256) draw, U a diagonal block of a real factor."""
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import KQUANT_SPECS
    from gptq_gguf_tpu_torch.ops import kquant

    spec = KQUANT_SPECS[qtype]
    x = torch.as_tensor(rng.normal(size=(d_row, 256)) * 0.02, dtype=torch.float32, device=device)
    s, z = kquant._expanded_scales(kquant.fit_supergroups(x, qtype), spec, 256)
    return (x[:, :BLOCK].contiguous(), U, s[:, :BLOCK].contiguous(), z[:, :BLOCK].contiguous(),
            spec.qmin, spec.qmax, 1e-9)


def phase_gptq_kernel(rng, device):
    """The block-solve kernel against its plain version at every 8B solve
    shape, for Q4_K, Q6_K and Q3_K: codes and err bit-equal."""
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.ops import gptq

    # a seeded SPD Hessian of an H-wide layer, factorized as the walk does
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
    U = U_full[n // 4:n // 4 + BLOCK, n // 4:n // 4 + BLOCK].contiguous()
    del U_full, hess
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    recs = []
    for qtype in (T.Q4_K, T.Q6_K, T.Q3_K):
        for name, d_row, per_layer in SOLVE_SHAPES:
            if qtype != T.Q4_K and name == "down":
                continue  # the same kernel shape as o
            args = solve_inputs(rng, U, d_row, qtype, device)
            qk, ek = gptq.solve_block(*args)
            qp, ep = gptq.solve_block_reference(*args)
            torch.cuda.synchronize()
            err = max((qk - qp).abs().max().item(), (ek - ep).abs().max().item())
            if not (torch.equal(qk, qp) and torch.equal(ek, ep)):
                raise RuntimeError(f"gptq_solve {name} {qtype.name}: kernel and plain differ "
                                   f"(max |diff| {err:.3e})")
            nbytes, ops = solve_cost(d_row, BLOCK)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
            rec = dict(name=name, qtype=qtype.name, d_row=d_row, bs=BLOCK, per_layer=per_layer,
                       max_abs_err=err,
                       ms=cuda_ms(lambda: gptq.solve_block(*args), 20, flush_buf.zero_),
                       call_ms=call_ms(lambda: gptq.solve_block(*args), 20),
                       plain_ms=cuda_ms(lambda: gptq.solve_block_reference(*args), 2,
                                        flush_buf.zero_),
                       bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            recs.append(rec)
            log(f"  gptq_solve {name:>6} {qtype.name} ({d_row}x{BLOCK}) bit-equal; kernel "
                f"{rec['ms']:.4f} ms (call {rec['call_ms']:.4f})  plain {rec['plain_ms']:.2f} ms"
                f"  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: {nbytes} B, {ops:.3e} ops)")
    return recs


def write_safetensors(tensors, path) -> None:
    """A minimal safetensors writer (u64 header length, JSON header, raw
    little-endian data), enough for the synthetic checkpoint."""
    import torch

    names = sorted(tensors)
    header, off = {}, 0
    for name in names:
        t = tensors[name]
        nb = t.numel() * t.element_size()
        header[name] = {"dtype": {torch.bfloat16: "BF16", torch.float32: "F32"}[t.dtype],
                        "shape": list(t.shape), "data_offsets": [off, off + nb]}
        off += nb
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            f.write(tensors[name].contiguous().view(torch.uint8).numpy())


def write_checkpoint(path: Path, device) -> None:
    """A seeded Llama-3-8B-width llama checkpoint of GPTQ_LAYERS layers,
    bf16 weights of std 0.02, as config.json plus one safetensors file."""
    import torch

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
    write_safetensors(t, path / "model.safetensors")


def h_objective(D, Hm) -> float:
    """tr(D H D^T), summed in f64 (D: (rows, d_col), H: (d_col, d_col))."""
    import torch

    return float(((D @ Hm) * D).sum(dtype=torch.float64))


def quantize_argv(ckpt: Path, save: Path, device, profile: bool):
    argv = ["quantize", "--model_name_or_path", str(ckpt), "--calibration_data", "synthetic",
            "--calibration_tokens", str(CALIB_TOKENS), "--calibration_sequence_length",
            str(CALIB_SEQ), "--default_bit_width", "Q4_K", "--save_dir", str(save),
            "--device", str(device)]
    return argv + ["--stage-profile"] if profile else argv


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
        port_main(quantize_argv(ckpt, save, device, profile))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = gptq.solve_block.launches
        if launches != per_layer_launches * GPTQ_LAYERS:
            raise RuntimeError(f"{launches} solve-kernel launches, want "
                               f"{per_layer_launches} x {GPTQ_LAYERS}")
        return launches, wall, json.loads((save / "stage_timings.json").read_text())

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
        launches, wall, timings = run_quantize(save, profile=False)
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
        _, wall_p, timings_p = run_quantize(tmp / "layers_profiled", profile=True)
    finally:
        gptq.kquant.fit_supergroups, gptq.factorize_hinv_cholesky = fit0, fact0
    stages = {k.split("/", 1)[1]: v for k, v in timings_p.items() if k.startswith("quantize/")}
    log(f"  instrumented run: walk {timings_p['quantize']:.2f} s = "
        f"{timings_p['quantize'] / GPTQ_LAYERS:.2f} s/layer; stages (s): "
        f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}; inside factorize_solve: "
        f"refit {timers['refit']:.3f}, factorize {timers['factorize']:.3f}")

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
                      stages=stages, refit_s=timers["refit"], factorize_s=timers["factorize"]),
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


def phase_paged_kernels(rng, device):
    """Both paged decode kernels against their plain versions at the 8B
    attention shape, at mixed lengths with -1 past the live pages (plain,
    window 48, sinks, softcap 30), then timed at a uniform fill."""
    import torch
    import torch.nn.functional as F

    from gptq_gguf_tpu_torch.models.llama import dequant_kv_q4
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

        def timed(fill):
            """Kernel, plain and library ms at a uniform fill of B = 8 slots."""
            fills = [fill] * 8
            ln = torch.full((8,), fill, dtype=torch.int32, device=device)
            tb = paged_table(rng, fills, device)
            qq = q[:8].contiguous()
            args = (qq, kp, vp, tb, ln)
            ms = cuda_ms(lambda: fn(*args, scale=scale), 50, flush_buf.zero_)
            plain_ms = cuda_ms(lambda: ref(*args, scale=scale), 5, flush_buf.zero_)
            # yardstick: one SDPA call over the live K / V, already gathered
            # contiguous (int4 dequantized first) in bf16; the port never calls it
            L = fill + 1
            if q4:
                hd2, ng = HD // 2, HD // 32
                codes = pa._gather_slot_kv(kp, tb)[:, :, :L]
                scl = pa._gather_slot_scales_t(vp, tb)[:, :, :L]
                k_l = dequant_kv_q4(codes[..., :hd2], scl[..., :ng]).to(torch.bfloat16)
                v_l = dequant_kv_q4(codes[..., hd2:], scl[..., ng:]).to(torch.bfloat16)
            else:
                k_l = pa._gather_slot_kv(kp, tb)[:, :, :L].contiguous()
                v_l = pa._gather_slot_kv(vp, tb)[:, :, :L].contiguous()
            q_l = qq.reshape(8, N_HEAD, 1, HD).to(torch.bfloat16)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q_l, k_l, v_l, scale=scale, enable_gqa=True), 50, flush_buf.zero_)
            nbytes, ops = paged_cost(fills, q4)
            t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
            return dict(fill=fill, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        bytes=nbytes, ops=ops, bound_ms=max(t_b, t_o),
                        bound_by="bytes" if t_b >= t_o else "operations")

        steady = {fill: timed(fill) for fill in STEADY_FILLS}
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
    3.35 TB/s, operations at f32 67 TFLOP/s for v1, bf16 989 for v4). A v4
    call from MMA_MIN_ROWS rows on a vec-4 weight must run the tensor-core
    tiles, held to 1e-5 with a planted control (v4_unrounded)."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul, qmv4

    M, d_in = x.shape
    v1 = isinstance(rql, qmatmul.RuntimeQuantLinear)
    fn, ref = ((qmatmul.dequant_matmul_v1, qmatmul.dequant_matmul_v1_reference) if v1
               else (qmv4.dequant_matmul_v4, qmv4.dequant_matmul_v4_reference))
    m0 = getattr(fn, "mma_launches", 0)
    y_k = fn(x, rql)
    mma = getattr(fn, "mma_launches", 0) > m0
    if mma != (not v1 and M >= qmatmul.MMA_MIN_ROWS and rql.d_out % 4 == 0):
        raise RuntimeError(f"{fmt} {name} M={M}: tensor-core tiles {mma}")
    y_p = ref(x, rql)
    y_c = v4_unrounded(x, rql) if mma else None
    torch.cuda.synchronize()
    if not torch.isfinite(y_k).all():
        raise RuntimeError(f"{fmt} {name}: kernel output is not finite")
    # tolerance: the same products (f32 for v1, bf16 x bf16 for v4), f32
    # sums in another order: 1e-4 of the largest sum of |terms| of an output;
    # 1e-5 on the tensor-core tiles (reordering f32 sums costs ~1e-7 *
    # sqrt(d_in) of it), a limit the unrounded weights must fail
    err = (y_k - y_p).abs().max().item()
    tol = (1e-5 if mma else 1e-4) * max(format_terms(x, rql), 1e-30)
    err_c = (y_k - y_c).abs().max().item() if mma else None
    del y_k, y_p, y_c
    if not err <= tol:
        raise RuntimeError(f"{fmt} {name} M={M}: kernel vs plain max|err| {err:.3e} > {tol:.3e}")
    if mma and not err_c > tol:
        raise RuntimeError(f"{fmt} {name} M={M}: the limit {tol:.3e} does not reject the "
                           f"unrounded weights ({err_c:.3e})")
    if v1:
        w_lib, x_lib = qmatmul.dequantize_runtime(rql).T.contiguous(), x.float()
    else:
        w_lib = qmv4.dequantize_runtime_v4(rql).T.contiguous().to(torch.bfloat16)
        x_lib = x.to(torch.bfloat16)
    reps = 20 if M <= 128 else 5
    ms = cuda_ms(lambda: fn(x, rql), reps, flush)
    wall_ms = call_ms(lambda: fn(x, rql), reps)
    plain_ms = cuda_ms(lambda: ref(x, rql), 2, flush)
    library_ms = cuda_ms(lambda: torch.matmul(x_lib, w_lib), reps, flush)
    del w_lib, x_lib
    nbytes = rql.bytes_read + x.numel() * x.element_size() + M * rql.d_out * 4
    flops = 2.0 * M * d_in * rql.d_out
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (F32_FLOP_PER_S if v1 else BF16_FLOP_PER_S) * 1e3
    rec = dict(name=name, fmt=fmt, body="v1" if v1 else qmv4.body_of(rql), M=M, d_in=d_in,
               d_out=rql.d_out, max_abs_err=err, tol=tol, mma=mma, control_err=err_c,
               ms=ms, call_ms=wall_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, plane_bytes=rql.bytes_read, flops=flops)
    control = f", control {err_c:.2e}, tensor cores" if mma else ""
    log(f"  {fmt:>7} {name:>24} M={M:<5} err {err:.3e} (tol {tol:.2e}{control})  kernel {ms:.4f} ms "
        f"(call {wall_ms:.4f})  plain {plain_ms:.3f} ms  library {library_ms:.4f} ms  bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec


def phase_format_kernels(params, rng, device):
    """7a: the v1 kernel and the three v4 bodies (f32 and bf16 scales)
    against their plain versions at every Llama-3-8B projection shape (Q4_K)
    and the unpadded Q6_K lm_head, at M = 8, the threshold (MMA_MIN_ROWS),
    128 and 1024 (v4 from the threshold on its tensor-core tiles); Q2_K /
    Q3_K / Q5_K and ragged d_out at small shapes."""
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
            for M in sorted({*FORMAT_MS, qmatmul.MMA_MIN_ROWS}):
                x = (torch.randn(M, rql.d_in_local, device=device) * 0.5).to(torch.bfloat16)
                recs.append(format_case(name, fmt, x, rql, flush))
            del rql
        for name, v2, M in small:
            x = torch.randn(M, v2.d_in_local, device=device)
            recs.append(format_case(name, fmt, x, as_format(v2, fmt), flush))
        torch.cuda.empty_cache()
    return recs


def phase_format_consistency(fparams, cfg, rng, device):
    """7b: 2 layers at full width, one 128-token prefill and 4 decode steps
    in each format through its kernel and through its plain version, held
    to phase 4's 3e-3 of max|logit|; the logit differences between the
    formats' kernel runs are printed (they round differently by design)."""
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
    diffs = {f"{a} vs {b}": (kernel_logits[a] - kernel_logits[b]).abs().max().item()
             for a, b in (("v1", "v2"), ("v4", "v2"), ("v1", "v4"))}
    log("between formats (kernels): " + ", ".join(f"max|dlogit| {k} {v:.3e}"
                                                  for k, v in diffs.items()))
    return diffs


def phase_format_ppl(fparams, cfg, device):
    """7d: compute_perplexity(serving=True) on the 32-layer model in v2, v1
    and v4: PPL_SEQS seeded synthetic sequences of PPL_LEN tokens, every
    projection and the lm_head through the format's kernel at M = PPL_LEN
    (v2's and v4's on the tensor-core tiles, each within 1e-3 nats/token of
    the same model through the plain version)."""
    import torch

    from gptq_gguf_tpu_torch.evals import ppl
    from gptq_gguf_tpu_torch.ops import qmatmul, qmv4
    from gptq_gguf_tpu_torch.utils.data import get_data

    data = get_data("synthetic", PPL_SEQS * PPL_LEN, PPL_LEN, train=False, vocab_size=V)
    out = {}
    for fmt, kernel in (("v2", "v2g"), ("v1", "v1"), ("v4", "v4")):
        ppl.compute_perplexity(fparams[fmt], cfg, data[:1], serving=True)  # warm
        reset_matmul_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        value = ppl.compute_perplexity(fparams[fmt], cfg, data, serving=True)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t) / len(data)
        counts, mma = matmul_counts(), mma_counts()
        want = len(data) * (4 * cfg.num_hidden_layers + 1)
        if counts[kernel] != want or any(counts[k] for k in MATMUL_KERNELS if k != kernel):
            raise RuntimeError(f"ppl {fmt}: launches {counts}, want {want} of {kernel}")
        # every projection and the all-position head at M = PPL_LEN on the
        # tensor-core tiles (v2 and v4)
        if mma != {k: want if k == kernel else 0 for k in mma}:
            raise RuntimeError(f"ppl {fmt}: tensor-core launches {mma}, want {want} of {kernel}")
        if not np.isfinite(value):
            raise RuntimeError(f"ppl {fmt}: {value}")
        out[fmt] = dict(ppl=value, nll=float(np.log(value)), s_per_seq=secs,
                        launches=counts[kernel], mma_launches=mma.get(kernel, 0), counts=counts)
        log(f"ppl ({fmt}, serving path, {len(data)} x {PPL_LEN} tokens): {value:.4f} "
            f"({np.log(value):.6f} nats/token), {secs:.3f} s per sequence, {counts[kernel]} "
            f"{kernel} launches ({mma.get(kernel, 0)} on the tensor cores)")
        plain_fn = {"v2": qmatmul.dequant_matmul_v2g_reference,
                    "v4": qmv4.dequant_matmul_v4_reference}.get(fmt)
        if plain_fn is not None:  # the same function through the plain version
            fn0 = qmatmul.dequant_matmul
            qmatmul.dequant_matmul = plain_fn
            try:
                plain = float(np.log(ppl.compute_perplexity(fparams[fmt], cfg, data,
                                                            serving=True)))
            finally:
                qmatmul.dequant_matmul = fn0
            d = out[fmt]["nll"] - plain
            out[fmt]["plain_nll"] = plain
            log(f"ppl ({fmt}): kernels {out[fmt]['nll']:.6f} vs plain version {plain:.6f} "
                f"nats/token: {d:+.3e} (bound 1e-3)")
            if not abs(d) < 1e-3:
                raise RuntimeError(f"ppl {fmt}: kernels {out[fmt]['nll']} vs plain {plain}")
    spread = max(r["nll"] for r in out.values()) - min(r["nll"] for r in out.values())
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
        qp = qmodel.fuse_params_for_serving(qp, cfg)
        toks = engine.generate(qp, cfg, [prompt], max_new_tokens=6, max_len=64)[0]
        if len(toks) != 6 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise RuntimeError(f"{fmt}: greedy tokens {toks}")
        out[fmt] = toks
        log(f"GPTQ artifacts served in {fmt} ({type(w).__name__}): {len(arts)} weights "
            f"dequantize bit-equal to their artifacts; greedy tokens {toks}")
        del qp
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 8: the v2 kernel variants at full width
# ---------------------------------------------------------------------------

# one summary entry per TPU kernel body: (name, source, its line in the JAX
# qmatmul.py, variant, the shapes of one B=8 decode step it runs, the 8c
# run whose launches it reports)
STEP = ("qkv", "o", "gateup", "down", "lm_head")
V2_VARIANT_KERNELS = (
    ("qmatmul_v2", "qmatmul_v2.cu", 377, "v2", STEP, "v2"),
    ("qmatmul_v3", "qmatmul_v3.cu", 429, "v3", STEP, "v3"),
    ("qmatmul_v2f", "qmatmul_v2.cu", 496, "v2f", STEP, "v2f"),
    ("qmatmul_v2h", "qmatmul_v3.cu", 551, "v2h", STEP, "v2h"),
    ("qmatmul_v2s", "qmatmul_v2g.cu", 660, "v2s", ("qkv", "o", "gateup", "down"), "v2s"),
    ("qmatmul_v2m", "qmatmul_v2m.cu", 729, "v2m", ("qkv", "o", "gateup", "down"), "v2m"),
    ("qmatmul_v2t", "qmatmul_v2m.cu", 789, "v2t", ("qkv", "o", "gateup", "down"), "v2t"),
    ("qmatmul_v2p", "qmatmul_v2m.cu", 844, "v2p", ("lm_head",), "v2m"),
)


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


def variant_case(name, variant, mxu, x, rql, flush):
    """One v2 variant kernel against its plain version on the same inputs,
    then timed: kernel, call, plain, library (torch.matmul on the
    dequantized weight, bf16; f32 with TF32 off for f32 operands) and the
    bound (bytes at 3.35 TB/s; operations at 989 TFLOP/s bf16 or 67 f32)."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul

    M, d_in = x.shape
    fns = variant_fns()
    fn, ref = fns[variant]
    dt = mxu_dtype(mxu)
    y_k = fn(x, rql, dt)
    y_p = ref(x, rql, dt)
    c_var, c_mxu = control_of(variant, mxu)
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
    plain_ms = cuda_ms(lambda: ref(x, rql, dt), 3, flush)
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


def phase_variant_consistency(params, cfg, rng, device):
    """8b: 2 layers at full width, one 128-token prefill and 4 decode steps
    under each knob setting of 8c, through the effective variants' kernels
    and through their plain versions, held to phase 4's 3e-3 of
    max|logit|; the differences of each setting's kernel logits from
    v2g's are printed (the variants round differently by design)."""
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul

    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 128)), device=device)
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4,)), device=device)
    fns = variant_fns()

    def through(plain: bool):
        def mm(x, rql):
            v = qmatmul.effective_v2_variant_for(rql)
            return fns[v][1 if plain else 0](x, rql, torch.bfloat16)
        return mm

    out = {}
    base = two_layer_logits(params, cfg, prompt, feed, qmatmul.dequant_matmul_v2g, device)
    for variant, gs16, _ in variant_runs(2):
        label = variant + (f" (gs16 {gs16})" if gs16 else "")
        old = knobs(variant, gs16)
        try:
            reset_matmul_counts()
            lk = two_layer_logits(params, cfg, prompt, feed, through(False), device)
            mma = mma_counts()
            lp = two_layer_logits(params, cfg, prompt, feed, through(True), device)
        finally:
            knobs(*old)
        # the 128-row prefill's 4 x 2 projections on the tensor-core tiles
        # when the variant has them; the 1-row head and decode steps not
        if mma != {k: 8 if k == variant else 0 for k in mma}:
            raise RuntimeError(f"{label}: tensor-core launches {mma}")
        scale = lp.abs().max().item()
        err = (lk - lp).abs().max().item()
        d_g = (lk - base).abs().max().item()
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        log(f"{label} consistency (2 layers, prefill + 4 decode): max|dlogit| kernel vs plain "
            f"{err:.3e}, tol {3e-3 * scale:.3e} (3e-3 of max|logit| {scale:.3e}); argmax "
            f"agreement {agree:.2f}; vs v2g's kernels {d_g:.3e}; tensor-core launches "
            f"{mma.get(variant, 0)}")
        if not (torch.isfinite(lk).all() and err <= 3e-3 * scale):
            raise RuntimeError(f"{label}: kernel and plain logits disagree")
        out[label] = dict(kernel_vs_plain=err, tol=3e-3 * scale, vs_v2g=d_g)
    return out


def phase_variant_serving(params, cfg, requests):
    """8c: phase 3's 12 requests under each knob setting, in turns between
    two v2g runs (the host-bound step drifts within a call), each with its
    exact launches per forward."""
    runs = [("v2g", "", None)] + list(variant_runs(cfg.num_hidden_layers)) + [("v2g", "", None)]
    out = {}
    for i, (variant, gs16, per_forward) in enumerate(runs):
        label = variant + (f"+{gs16}" if gs16 else "")
        if variant == "v2g" and not gs16:
            label += " (before)" if i == 0 else " (after)"
        old = knobs(variant, gs16)
        try:
            counts, rec = phase_serving(params, cfg, requests, variant, label, per_forward)
        finally:
            knobs(*old)
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
    """8d: compute_perplexity(serving=True) on the 32-layer model under v2m
    and v2 (phase 7d's data); each within 0.05 nats/token of v2g's (7d)."""
    import torch

    from gptq_gguf_tpu_torch.evals import ppl
    from gptq_gguf_tpu_torch.utils.data import get_data

    data = get_data("synthetic", PPL_SEQS * PPL_LEN, PPL_LEN, train=False, vocab_size=V)
    L = cfg.num_hidden_layers
    out = {}
    for variant, want in (("v2m", {"v2m": 4 * L, "v2p": 1}), ("v2", {"v2": 4 * L + 1})):
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
        if any(mma[k] != (want.get(k, 0) * len(data)) for k in mma):  # v2: every call
            raise RuntimeError(f"ppl {variant}: tensor-core launches {mma}")
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
    return out


def variant_summary(name, source, replaces, variant, shapes, recs, launches):
    """The summary entry of one v2 variant kernel: one B=8 decode step (its
    calls among the four projections of every layer and the lm_head, at
    8a's M=8 times with bf16 operands, the dispatch's); its error is the
    largest of all its 8a cases. v2's entry adds its f32 operand mode."""
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
           "replaces": replaces, "launches": launches,
           "max_abs_err": max(r["max_abs_err"] for r in recs if r["variant"] == variant),
           **entry("bf16"), "per": f"one B=8 decode step (bf16 operands): {calls} calls"}
    if all(any(r["variant"] == variant and r["mxu"] == "f32" and r["M"] == 8
                   and r["name"].split()[0] == k for r in recs) for k in shapes):
        out["f32"] = entry("f32")
    return out


def format_summary(name, source, replaces, body, fmt, shapes, recs, launches, mma_launches):
    """The summary entry of one v1 / v4 kernel body: one B=8 decode step
    (the four projections of every layer and / or the lm_head, at the M=8
    times of 7a in ``fmt``), and beside it the same calls at M = 1024 (one
    8B forward's share: v4's on the tensor-core tiles) with their
    tensor-core launches in 7c / 7d; its error is the largest of all its
    7a cases."""
    def at(M):
        per = {r["name"].split()[0]: r for r in recs if r["fmt"] == fmt and r["M"] == M}

        def total(key):
            return sum(per[k][key] * (1 if k == "lm_head" else N_LAYERS) for k in shapes)

        t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = total("flops") / (F32_FLOP_PER_S if fmt == "v1" else BF16_FLOP_PER_S) * 1e3
        return {"ms": total("ms"), "plain_ms": total("plain_ms"),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": total("library_ms"), "bytes": total("bytes")}

    calls = sum(1 if k == "lm_head" else N_LAYERS for k in shapes)
    return {"name": name, "route": "cuda", "source": f"gptq_gguf_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": launches, "mma_launches": mma_launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs if r["body"] == body),
            **at(8), "per": f"one B=8 decode step ({fmt}): {calls} calls",
            "at_1024": {**at(1024), "per": f"one Llama-3-8B forward at M = 1024 ({fmt}): "
                                           f"{calls} calls"}}


def paged_summary(name, source_line, krec, launches):
    """The summary entry of one paged kernel: one B=8 decode step at the
    first steady fill (300), one call per layer at the times of phase 6a."""
    r = krec["steady"][STEADY_FILLS[0]]
    n = N_LAYERS
    return {"name": name, "route": "cuda",
            "source": "gptq_gguf_tpu_torch/ops/csrc/paged_decode.cu",
            "replaces": f"gptq_gguf_tpu/ops/paged_attention.py:{source_line}",
            "launches": launches, "max_abs_err": krec["max_abs_err"],
            "ms": r["ms"] * n, "plain_ms": r["plain_ms"] * n, "bound_ms": r["bound_ms"] * n,
            "bound_by": r["bound_by"], "library_ms": r["library_ms"] * n,
            "per": f"one B=8 decode step at fill {STEADY_FILLS[0]}: {n} calls"}


def run(device) -> dict:
    """All eight phases on ``device``; returns the kernel summary."""
    import torch

    t_start = time.time()
    rng = np.random.default_rng(SEED)
    log("== phase 1: device and build")
    phase_device_and_build()
    log("== phase 2: kernel vs plain version")
    t = time.time()
    params, cfg = build_8b(rng, device)
    log(f"weights: {N_LAYERS} layers + lm_head packed in {time.time() - t:.1f} s")
    recs = phase_kernels(params, rng, device)
    mrecs = phase_mma_kernels(params, ("v2g",), device)
    log("== phase 3: full-width serving")
    requests = serve_requests(rng, cfg, 12, *SERVE_MIX)
    counts, serve = phase_serving(params, cfg, requests)
    launches = counts["v2g"] - serve["mma_launches"]  # the decode tiles' own
    log("== phase 4: consistency")
    phase_consistency(params, cfg, rng, device)
    log("== phase 6: paged serving at full width")
    t6 = time.time()
    precs = phase_paged_kernels(rng, device)
    phase_paged_consistency(params, cfg, rng, device)
    paged_runs, paged_eng = phase_paged_serving(params, cfg, rng, device)
    paged_rec = dict(runs=paged_runs, steady=phase_paged_steady(paged_eng, cfg, device),
                     http=phase_paged_http(paged_eng, cfg, rng))
    log(f"phase 6 took {time.time() - t6:.1f} s")
    del paged_eng
    torch.cuda.empty_cache()

    log("== phase 7: v1 and v4 formats at full width")
    t7 = time.time()
    frecs = phase_format_kernels(params, rng, device)
    fparams = {"v2": params, **{f: format_params(params, f) for f in ("v1", "v4", "v4 i8")}}
    cross = phase_format_consistency(fparams, cfg, rng, device)
    fserve = {}
    # v2 once more after the others: the host-bound step drifts within a
    # call, so each format is read between two v2 runs
    for fmt, kernel in (("v1", "v1"), ("v4", "v4"), ("v4 i8", "v4"), ("v2", "v2g")):
        fcounts, rec = phase_serving(fparams[fmt], cfg, requests, kernel, fmt)
        if kernel == "v4":
            n = rec["forwards"]
            body = "v4_pb2_i8" if fmt == "v4 i8" else "v4_pb2"
            if fcounts[body] != 4 * N_LAYERS * n or fcounts["v4_pb1"] != n:
                raise RuntimeError(f"{fmt} serving: body launches {fcounts}, {n} forwards")
        log(f"serving ({fmt}) beside v2 in this call: {rec['serve_decode_ms_per_step']:.2f} vs "
            f"{serve['serve_decode_ms_per_step']:.2f} ms per decode step, "
            f"{rec['generated_tok_s']:.1f} vs {serve['generated_tok_s']:.1f} generated tok/s; "
            f"steady B=8 {rec['decode_ms_per_step']:.2f} vs {serve['decode_ms_per_step']:.2f} ms")
        fserve[fmt] = dict(rec, counts=fcounts)
    fppl = phase_format_ppl(fparams, cfg, device)
    log(f"phase 7 took {time.time() - t7:.1f} s")
    del fparams
    torch.cuda.empty_cache()

    log("== phase 8: the v2 kernel variants at full width")
    t8 = time.time()
    vrecs = phase_variant_kernels(params, rng, device)
    mrecs += phase_mma_kernels(params, ("v2", "v3", "v2f", "v2h"), device)
    vcross = phase_variant_consistency(params, cfg, rng, device)
    vserve = phase_variant_serving(params, cfg, requests)
    vppl = phase_variant_ppl(params, cfg, fppl["v2"])
    log(f"phase 8 took {time.time() - t8:.1f} s")
    del params
    torch.cuda.empty_cache()

    log("== phase 5: GPTQ at full width")
    grecs = phase_gptq_kernel(rng, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gptq_") as tmp:
        g_launches, gptq_rec, solves, arts = phase_gptq_quantize(Path(tmp), device)
        gptq_rec["whole_o_solve"] = phase_gptq_whole_solve(solves, device)
        del solves
        phase_gptq_to_serving(arts, device)
        gptq_formats = phase_gptq_formats(Path(tmp) / "ckpt", Path(tmp) / "layers", arts,
                                          device)

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
    return {"kernels": [{
        "name": "qmatmul_v2g", "route": "cuda",
        "source": "gptq_gguf_tpu_torch/ops/csrc/qmatmul_v2g.cu",
        "replaces": "gptq_gguf_tpu/ops/qmatmul.py:605",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": per_step("library_ms"),
        "per": f"one B=8 decode step: {4 * cfg.num_hidden_layers + 1} calls",
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
    }, paged_summary("paged_flash_decode", 70, precs["paged_flash_decode"],
                     paged_runs["bf16"]["launches"]),
        paged_summary("paged_flash_decode_q4", 160, precs["paged_flash_decode_q4"],
                      paged_runs["int4"]["launches"])] + [
        format_summary(name, source, replaces, body, fmt, shapes, frecs,
                       fserve[fmt]["counts"]["v1" if body == "v1" else f"v4_{body}"],
                       {"serving": fserve[fmt]["counts"].get(f"v4_{body}_mma", 0),
                        "ppl": fppl[fmt]["counts"].get(f"v4_{body}_mma", 0) if fmt in fppl
                        else None})
        for name, source, replaces, body, fmt, shapes in V1_V4_BODIES] + [
        variant_summary(name, source, f"gptq_gguf_tpu/ops/qmatmul.py:{line}", variant, shapes,
                        vrecs, vserve[run]["counts"][variant]
                        - (vserve[run]["mma_launches"] if variant == run else 0))
        for name, source, line, variant, shapes, run in V2_VARIANT_KERNELS] + [
        mma_summary(mrecs, serve["mma_launches"])],
        "serving": serve, "gptq": gptq_rec, "paged": paged_rec,
        "formats": dict(serving=fserve, ppl=fppl, logits_between_formats=cross,
                        gptq_greedy=gptq_formats),
        "variants": dict(serving=vserve, ppl=vppl, logits=vcross),
        "seconds": time.time() - t_start}


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
