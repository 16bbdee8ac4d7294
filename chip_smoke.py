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
   library ms, and the bound at the card's published rates;
3. full-width serving: Llama-3-8B widths, synthetic v2 weights from a seed,
   ContinuousBatchingEngine(num_slots=8, max_len=2048) serving 12 requests;
   checks budgets, token ranges and the kernel's launch count, and prints
   decode tok/s and ms/step (plus a steady B=8 block);
4. consistency: 2 layers at full width, one prefill plus 4 decode steps
   through the kernel and through the plain version, logits compared;
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
   concurrent requests equal the engine's direct outputs, one streamed.

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
    from gptq_gguf_tpu_torch.formats.ggml import KQUANT_SPECS
    from gptq_gguf_tpu_torch.ops import qmatmul
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
    return qmatmul.pack_runtime_v2(q, SuperGroupParams(ss, sz, sc, zq), qtype,
                                   device=device)


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

    names = ("qmatmul_v2g", "gptq_solve", "paged_decode")
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
    scale, off = qmatmul._group_scales_v2(rql)
    off2 = off + scale * rql.shift
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


def phase_kernels(params, rng, device):
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T

    l0 = params["layers"][0]
    cases = [("qkv 4096->6144 Q4_K", l0["qkv_proj"]),
             ("o 4096->4096 Q4_K", l0["o_proj"]),
             ("gateup 4096->28672 Q4_K", l0["gateup_proj"]),
             ("down 14336->4096 Q4_K", l0["down_proj"]),
             ("lm_head 4096->128512 Q6_K", params["lm_head"])]
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


def phase_serving(params, cfg, rng):
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul
    from gptq_gguf_tpu_torch.serving import engine, model as qmodel

    n_fwd = [0]
    decode = {"s": 0.0, "steps": 0}
    fwd0, scan0 = qmodel.forward_cached, engine._decode_steps_scan

    def counting_forward(*a, **kw):
        n_fwd[0] += 1
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
    uids = set()
    for _ in range(12):
        p = rng.integers(0, cfg.vocab_size, size=int(rng.integers(100, 301)))
        uids.add(eng.submit(p, max_new_tokens=int(rng.integers(32, 65))))
    qmodel.forward_cached, engine._decode_steps_scan = counting_forward, timed_scan
    qmatmul.dequant_matmul_v2g.launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        qmodel.forward_cached, engine._decode_steps_scan = fwd0, scan0
    launches = qmatmul.dequant_matmul_v2g.launches
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
    per_fwd = 4 * cfg.num_hidden_layers + 1
    if launches == 0 or launches != per_fwd * n_fwd[0]:
        raise RuntimeError(f"kernel launches {launches} != {per_fwd} x {n_fwd[0]} forwards")
    gen_tokens = sum(len(r.output) for r in done)
    log(f"serving: depth {cfg.num_hidden_layers}, 12 requests, {gen_tokens} tokens in "
        f"{wall:.2f} s; {n_fwd[0]} forwards, {launches} kernel launches "
        f"({per_fwd} per forward), prefix hits {eng.prefix_hits}")
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
    log(f"steady decode B=8: {dt * 1e3:.2f} ms/step, {8 / dt:.1f} tok/s")
    return launches, dict(wall_s=wall, decode_ms_per_step=dt * 1e3,
                          decode_tok_s=8 / dt)


def phase_consistency(params, cfg, rng, device):
    import torch

    from gptq_gguf_tpu_torch.ops import qmatmul
    from gptq_gguf_tpu_torch.serving import engine, model as qmodel

    p2 = {**params, "layers": params["layers"][:2]}
    c2 = dataclasses.replace(cfg, num_hidden_layers=2)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 128)), device=device)

    def run(mm):
        fn0 = qmatmul.dequant_matmul
        qmatmul.dequant_matmul = mm
        try:
            cache = qmodel.init_cache(c2, 1, 2048, device=device)
            _, row, cache = engine._prefill_slot(p2, c2, prompt, cache, 0)
            rows = [row[None]]
            for j in range(4):  # the same fed tokens on both paths
                logits, cache = qmodel.forward_cached(p2, c2, feed[j][None, None], cache)
                rows.append(logits)
            return torch.cat(rows)
        finally:
            qmatmul.dequant_matmul = fn0

    def exact_f32(x, rql):  # control: no bf16 rounding of weights or x
        return x.float() @ qmatmul.dequantize_runtime_v2(rql).T

    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4,)), device=device)
    lk = run(qmatmul.dequant_matmul_v2g)
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
    """All six phases on ``device``; returns the kernel summary."""
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
    log("== phase 3: full-width serving")
    launches, serve = phase_serving(params, cfg, rng)
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
    del params, paged_eng
    torch.cuda.empty_cache()

    log("== phase 5: GPTQ at full width")
    grecs = phase_gptq_kernel(rng, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gptq_") as tmp:
        g_launches, gptq_rec, solves, arts = phase_gptq_quantize(Path(tmp), device)
        gptq_rec["whole_o_solve"] = phase_gptq_whole_solve(solves, device)
        del solves
        phase_gptq_to_serving(arts, device)

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
                      paged_runs["int4"]["launches"])],
        "serving": serve, "gptq": gptq_rec, "paged": paged_rec,
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
