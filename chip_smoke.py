#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / H100 port (gptq_gguf_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without a card or outside a
checkout of the repository. Phases, each raising on failure:

1. device and build: the card's name and power limit; the v2g kernel is
   built from gptq_gguf_tpu_torch/ops/csrc/ and its build time printed;
2. kernel against its plain PyTorch version on the card, at every
   projection shape of Llama-3-8B (Q4_K, Q6_K lm_head) at M = 8 and 128,
   plus Q2_K / Q3_K / Q5_K and a ragged d_out: error, kernel / plain /
   library ms, and the bound at the card's published rates;
3. full-width serving: Llama-3-8B widths, synthetic v2 weights from a seed,
   ContinuousBatchingEngine(num_slots=8, max_len=2048) serving 12 requests;
   checks budgets, token ranges and the kernel's launch count, and prints
   decode tok/s and ms/step (plus a steady B=8 block);
4. consistency: 2 layers at full width, one prefill plus 4 decode steps
   through the kernel and through the plain version, logits compared.

The second-to-last line is the kernel summary JSON, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12   # dense bf16 tensor-core peak
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
    t0 = time.time()
    nvcc_log = cuda_build.build("qmatmul_v2g")
    log(f"build: qmatmul_v2g in {time.time() - t0:.1f} s "
        f"({'cached' if nvcc_log is None else 'built'})")
    for line in (nvcc_log or "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


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


def run(device) -> dict:
    """All four phases on ``device``; returns the kernel summary."""
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
    }], "serving": serve, "seconds": time.time() - t_start}


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
