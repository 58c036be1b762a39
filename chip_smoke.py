#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit.  It builds every CUDA kernel of the port from ``csrc/``,
holds each against its plain PyTorch version on the card and times it
beside its bound, then drives the port's two paths:

- serving (slice 1): checks the Llama model's two attention paths against
  each other, then serves full-width llama_7b (32 layers, bf16, random
  weights from ``--seed``) through ``ModelServer`` on both generation
  engines;
- training (slice 2): holds the fused resnet50_v1 against the unfused one
  for one step at 64 px, then trains full-width resnet50_v1 (224 px, 1000
  classes, batch 256, SGD as bench.py) fused in fp32, unfused in fp32 and
  unfused in bf16.

Each phase prints one JSON line; any failed phase ends the run with a
non-zero exit code.  The line before the last is the kernel table; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its operations over the peak rate and its bytes over the
# memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# [B, H, S, D] shapes for the flash kernel check.  [4, 32, 1024, 128] is
# the dense engine's decode step in the serving phase (4 slots, prompts up
# to 1000 tokens bucketed to 1024); [4, 32, 2048, 128] is the timed shape.
FLASH_SHAPES = [(1, 32, 16, 128), (4, 32, 512, 128), (4, 32, 1024, 128),
                (4, 32, 2048, 128), (1, 4, 64, 16), (2, 4, 300, 16)]
FLASH_TIMED = (4, 32, 2048, 128)
# Tolerances on max |kernel - plain|.  fp32: the starting 1e-4 on O and lse
# (the two sum in other orders).  bf16: the kernel computes in fp32 from
# the bf16 inputs, as the TPU kernel did, so it is held against the plain
# version evaluated in fp32 on the same values.  O keeps the starting 2e-2
# and, since the kernel's only bf16 step is rounding O to nearest, each
# element must also lie within half a bf16 ulp of the fp32 value:
# |o - ref| <= 2^-8 |ref| + 1e-5 (BF16_O_REL, BF16_O_ABS; the 1e-5 covers
# the fp32 summation order).  lse is fp32 on both sides, so its bound is
# tightened from 1e-2 to 1e-4.
TOL = {"float32": {"o": 1e-4, "lse": 1e-4},
       "bfloat16": {"o": 2e-2, "lse": 1e-4}}
BF16_O_REL = 2.0 ** -8
BF16_O_ABS = 1e-5

# Fused 1x1-conv + BN-statistics kernel: the (K, N) of every bottleneck 1x1
# conv of resnet50_v1, by stage, with its output side at 224 px; the
# kernel's M is batch * side^2.  Checked at batch 32, timed at the largest
# stage-1 shape at batch 256 (the training phase's batch).
FUSED_STAGES = ((56, ((64, 64), (256, 64), (64, 256))),
                (28, ((256, 128), (512, 128), (128, 512), (256, 512))),
                (14, ((512, 256), (1024, 256), (256, 1024), (512, 1024))),
                (7, ((1024, 512), (2048, 512), (512, 2048), (1024, 2048))))
FUSED_CHECK_BATCH = 32
FUSED_RAGGED = (300, 130, 70)
FUSED_TIMED = (256 * 56 * 56, 256, 64)
FUSED_MODES = {"plain": (False, False), "affine": (True, False),
               "affine_relu": (True, True)}
# Gates, each against the plain version evaluated in fp32 on the same
# values: fp32 y within 1e-4 of max |ref| (the two sum K in other orders);
# bf16 y per element within half a bf16 ulp plus the fp32 summation order,
# |y - ref| <= 2^-8 |ref| + 1e-5 (the kernel rounds its fp32 accumulator
# once); the statistics of each column within 1e-5 of its sum of |y| and of
# its sum of y^2 (800k-row sums taken in other orders).
FUSED_TOL = {"y_fp32_rel": 1e-4, "y_bf16_rel": 2.0 ** -8,
             "y_bf16_abs": 1e-5, "stats_rel": 1e-5}

# Training: resnet50_v1 as bench.py trains it (lr 0.1, momentum 0.9, wd
# 1e-4, images uniform in [0, 1), 1000 classes).  The parity step runs at 64
# px, batch 8, fp32.  The fused step and the unfused one differ only in
# rounding (BN cancels the unfused conv bias, set to 0 here), so the loss
# must agree within 1e-4 of itself.  The step's weight updates are
# ill-conditioned at this size: the unfused step in fp32 against the same
# step in fp64 (on the CPU, same weights and batch) moves every 1x1
# weight's update by 1.3-3.4% in norm and up to 27% in its largest element,
# since a ReLU gate that rounding flips changes one of only 32 rows per
# channel at stage 4.  So each fused 1x1 weight's update must lie within
# 10% in norm of the unfused one's; the largest elementwise gap is printed.
TRAIN = dict(batch=256, px=224, classes=1000, warmup=3, steps=10)
PARITY = dict(batch=8, px=64, loss_rel=1e-4, update_rel_norm=0.1)
FUSED_LAUNCHES_PER_STEP = 36

LLAMA_7B = dict(vocab_size=32000, units=4096, hidden=11008, num_heads=32,
                max_length=2048)
PROMPTS = (96, 200, 511, 1000)
NEW_TOKENS = 16


class SmokeFailure(SystemExit):
    def __init__(self, msg):
        super().__init__(f"chip_smoke: FAILED: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean milliseconds of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from mxnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name, path in libs.items():
        log = Path(str(path) + ".log")
        ptxas[name] = [ln.strip() for ln in
                       (log.read_text().splitlines() if log.exists() else [])
                       if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "ok": True, "seconds": seconds,
          "libraries": {n: str(p) for n, p in libs.items()}, "ptxas": ptxas})


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "ok": True, "nvidia_smi": line,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})


def flash_bound_ms(b, h, s, d, causal, dtype_bytes):
    """Least time on the card: causal work is 2*B*H*S^2*D flops (two
    products, half the score matrix), non-causal twice that; bytes are
    q, k, v read once, O written once, lse (fp32) written once."""
    flops = 2.0 * b * h * s * s * d * (1 if causal else 2)
    peak = PEAK_BF16_FLOPS if dtype_bytes == 2 else PEAK_FP32_FLOPS
    nbytes = 4.0 * b * h * s * d * dtype_bytes + 4.0 * b * h * s
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_kernels(torch, seed):
    from mxnet_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = []
    timed = None
    for (b, h, s, d) in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                q, k, v = (torch.randn(b * h, s, d, generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(3))
                scale = 1.0 / math.sqrt(d)
                o, lse = A.flash_fwd(q, k, v, causal, scale)
                ro, rl = A._flash_forward_plain(q.float(), k.float(),
                                                v.float(), causal, scale)
                torch.cuda.synchronize()
                name = str(dtype).replace("torch.", "")
                case = {"shape": [b, h, s, d], "dtype": name,
                        "causal": causal,
                        "o_err": (o.float() - ro).abs().max().item(),
                        "lse_err": (lse - rl).abs().max().item()}
                if dtype == torch.bfloat16:
                    # 1 at the half-ulp bound; above 1 fails the case
                    case["o_half_ulp_ratio"] = ((o.float() - ro).abs() / (
                        BF16_O_REL * ro.abs() + BF16_O_ABS)).max().item()
                    # the plain version in bf16 rounds scores and P to bf16
                    # (the JAX lowering does the same): reported, not gated
                    po, pl = A._flash_forward_plain(q, k, v, causal, scale)
                    case["o_err_vs_plain_bf16"] = (
                        o.float() - po.float()).abs().max().item()
                    case["lse_err_vs_plain_bf16"] = (
                        lse - pl).abs().max().item()
                tol = TOL[name]
                case["ok"] = (case["o_err"] <= tol["o"]
                              and case["lse_err"] <= tol["lse"]
                              and case.get("o_half_ulp_ratio", 0.0) <= 1.0)
                cases.append(case)
                if ((b, h, s, d) == FLASH_TIMED and causal
                        and dtype == torch.bfloat16):
                    timed = (q, k, v, case["o_err"])
                del q, k, v, o, lse, ro, rl
    bad = [c for c in cases if not c["ok"]]
    emit({"phase": "kernels", "ok": not bad, "tolerance": TOL,
          "cases": cases})
    check(not bad, f"flash_fwd disagrees with its plain version: {bad}")

    # timings at the timed shape, causal bf16; the kernel, its plain
    # version and the library call run in turns in this one process
    q, k, v, err = timed
    b, h, s, d = FLASH_TIMED
    scale = 1.0 / math.sqrt(d)
    q4, k4, v4 = (t.view(b, h, s, d) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernel = lambda: A.flash_fwd(q, k, v, True, scale)
    plain = lambda: A._flash_forward_plain(q, k, v, True, scale)
    library = lambda: sdpa(q4, k4, v4, is_causal=True, scale=scale)
    times = {"kernel": [], "plain": [], "library": []}
    for order in (("kernel", "plain", "library"),
                  ("library", "plain", "kernel")):
        for key in order:
            fn = {"kernel": kernel, "plain": plain, "library": library}[key]
            times[key].append(cuda_ms(torch, fn, iters=10))
    bound, bound_by = flash_bound_ms(b, h, s, d, True, 2)
    # the same three at the dense engine's decode shape (not timed in the
    # contract line; kept for the record)
    db, dh, ds, dd = 4, 32, 1024, 128
    qd, kd, vd = (torch.randn(db * dh, ds, dd, generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(3))
    decode_ms = cuda_ms(torch, lambda: A.flash_fwd(qd, kd, vd, True, scale),
                        iters=10)
    decode_sdpa = cuda_ms(torch, lambda: sdpa(
        qd.view(db, dh, ds, dd), kd.view(db, dh, ds, dd),
        vd.view(db, dh, ds, dd), is_causal=True, scale=scale), iters=10)
    result = {"shape": list(FLASH_TIMED), "dtype": "bfloat16",
              "causal": True, "max_abs_err": err,
              "ms": min(times["kernel"]), "plain_ms": min(times["plain"]),
              "library_ms": min(times["library"]), "bound_ms": bound,
              "bound_by": bound_by, "runs_ms": times,
              "decode_shape": [db, dh, ds, dd], "decode_ms": decode_ms,
              "decode_library_ms": decode_sdpa,
              "decode_bound_ms": flash_bound_ms(db, dh, ds, dd, True, 2)[0]}
    emit({"phase": "kernel_timing", "ok": True, "flash_fwd": result})
    return result


def _random_llama(torch, seed, dtype, num_layers):
    from mxnet_tpu_torch.gluon.model_zoo.language import LlamaModel
    from mxnet_tpu_torch.initializer import initialize
    from mxnet_tpu_torch.random import generator
    model = LlamaModel(num_layers=num_layers, dtype=dtype, **LLAMA_7B)
    initialize(model, generator(seed))
    return model.eval().requires_grad_(False)


def _prompts(seed, lengths, vocab=LLAMA_7B["vocab_size"]):
    """Token ids in [1, vocab) from ``seed``, one prompt per length."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, n).tolist() for n in lengths]


def phase_model_parity(torch, seed):
    """LlamaModel.forward (flash kernel) against cache_forward on an empty
    cache (plain paged attention) at llama_7b width with 4 layers, fp32
    (gated) and bf16 (reported beside its noise floor); then exact greedy
    parity of the two engines on a tiny fp32 model."""
    from mxnet_tpu_torch.gluon.model_zoo.language import llama_tiny
    from mxnet_tpu_torch.initializer import initialize
    from mxnet_tpu_torch.random import generator
    from mxnet_tpu_torch.serving import GenerationScheduler, greedy_decode
    model = _random_llama(torch, seed, torch.float32, 4)
    layers, kv_units, _ = model.kv_cache_spec()
    empty = torch.zeros(layers, 1, 16, kv_units, device="cuda")
    zero = torch.zeros(1, dtype=torch.long, device="cuda")
    no_table = torch.zeros(1, 0, dtype=torch.long, device="cuda")
    rows = []
    with torch.no_grad():
        for prompt in _prompts(seed + 1, (96, 511)):
            tok = torch.tensor([prompt], device="cuda")
            dense = model(tok)[0, -1]
            paged = model.cache_forward(tok, zero, zero, no_table, empty,
                                        empty)[0][0, -1]
            tol = 1e-3 * dense.abs().max().item()
            top2 = torch.topk(dense, 2).values
            margin = (top2[0] - top2[1]).item()
            same = int(dense.argmax()) == int(paged.argmax())
            rows.append({"prompt_tokens": len(prompt),
                         "max_abs_diff": (dense - paged).abs().max().item(),
                         "tolerance": tol, "top2_margin": margin,
                         "argmax_equal": same,
                         "ok": bool((dense - paged).abs().max().item() <= tol
                                    and (same or margin < tol))})
    del model, empty
    torch.cuda.empty_cache()
    # the same two prompts through the 4-layer model in bf16: how far the
    # paged path's logits move beside the bf16 noise floor of the dense
    # path itself (reported, not gated)
    model = _random_llama(torch, seed, torch.bfloat16, 4)
    bf16_rows = [_bf16_logit_noise(torch, model, p)
                 for p in _prompts(seed + 1, (96, 511))]
    del model
    torch.cuda.empty_cache()

    tiny = llama_tiny(vocab_size=53, max_length=64)
    initialize(tiny, generator(seed))
    prompts = _prompts(seed + 2, (3, 9, 17, 30), vocab=53)
    want = [greedy_decode(tiny, p, 8, min_bucket=8, max_length=64)
            for p in prompts]
    engines = {}
    for paged in (True, False):
        sched = GenerationScheduler(tiny, max_slots=3, min_bucket=8,
                                    max_length=64, page_tokens=4,
                                    kv_cache=paged)
        futs = [sched.submit(p, max_new_tokens=8) for p in prompts]
        sched.run()
        engines["paged" if paged else "dense"] = [f.result() for f in futs]
    tiny_ok = all(got == want for got in engines.values())
    ok = all(r["ok"] for r in rows) and tiny_ok
    emit({"phase": "model_parity", "ok": ok, "llama_7b_width_4_layers_fp32":
          rows, "llama_7b_width_4_layers_bf16_noise": bf16_rows,
          "tiny_fp32_greedy_equal": tiny_ok})
    check(ok, "model parity failed")


def _bf16_logit_noise(torch, model, prompt):
    """Last-position logits of one prompt three ways on the bf16 model:
    the dense forward on exactly the prompt, the dense forward on the
    prompt padded to its length bucket (the same math; only the matmul
    shapes, hence the rounding, differ), and cache_forward on an empty
    cache.  Sizes how far bf16 rounding alone moves these logits against
    their top-2 margin; reported, not gated."""
    n = len(prompt)
    bucket = 1 << (n - 1).bit_length()
    tok = torch.tensor([prompt], device="cuda")
    padded = torch.zeros(1, bucket, dtype=torch.long, device="cuda")
    padded[0, :n] = tok[0]
    layers, kv_units, _ = model.kv_cache_spec()
    empty = torch.zeros(layers, 1, 16, kv_units, device="cuda",
                        dtype=model.dtype)
    zero = torch.zeros(1, dtype=torch.long, device="cuda")
    no_table = torch.zeros(1, 0, dtype=torch.long, device="cuda")
    with torch.no_grad():
        exact = model(tok)[0, -1].float()
        pad = model(padded)[0, n - 1].float()
        paged = model.cache_forward(tok, zero, zero, no_table, empty,
                                    empty)[0][0, -1].float()
    top2 = torch.topk(exact, 2).values
    return {"prompt_tokens": n, "max_abs_logit": exact.abs().max().item(),
            "top2_margin": (top2[0] - top2[1]).item(),
            "dense_vs_dense_padded": (exact - pad).abs().max().item(),
            "dense_vs_paged": (exact - paged).abs().max().item(),
            "argmax_dense_padded_equal": int(exact.argmax()) == int(pad.argmax()),
            "argmax_paged_equal": int(exact.argmax()) == int(paged.argmax())}


def phase_serving(torch, seed):
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.serving import ModelServer
    t0 = time.perf_counter()
    model = _random_llama(torch, seed, torch.bfloat16, 32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = _prompts(seed + 3, PROMPTS)
    out = {"phase": "serving", "model": "llama_7b", "dtype": "bfloat16",
           "layers": 32, "build_seconds": build_s,
           "weights_gb": sum(p.numel() * p.element_size()
                             for p in model.parameters()) / 1e9}
    tokens = {}
    launches = {}
    with ModelServer() as server:
        server.register_generation("llama_dense", model, max_slots=4,
                                   kv_cache=False)
        server.register_generation("llama", model, max_slots=4,
                                   kv_cache=True, page_tokens=16,
                                   prefix_cache=True)
        for name in ("llama_dense", "llama"):
            torch.cuda.synchronize()
            A.flash_fwd_launches = 0
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            futs = [server.generate_async(name, p, max_new_tokens=NEW_TOKENS,
                                          eos_id=None) for p in prompts]
            tokens[name] = [f.result(timeout=900) for f in futs]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches[name] = A.flash_fwd_launches
            st = server.stats(name)
            out[name] = {"wall_s": wall,
                         "tokens_per_s": len(prompts) * NEW_TOKENS / wall,
                         "steps": st["steps"], "admitted": st["admitted"],
                         "flash_fwd_launches": launches[name],
                         "logit_rows": st["logit_rows"],
                         "nonfinite_rows": st["nonfinite_rows"],
                         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    agree = sum(a == b for x, y in zip(tokens["llama_dense"], tokens["llama"])
                for a, b in zip(x, y))
    out["tokens_agree"] = f"{agree}/{len(prompts) * NEW_TOKENS}"
    out["first_divergence"] = [
        next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
        for x, y in zip(tokens["llama_dense"], tokens["llama"])]
    out["bf16_logit_noise"] = _bf16_logit_noise(torch, model, prompts[0])
    dense = out["llama_dense"]
    # every dense forward (admission prefills + decode steps) runs the
    # kernel once in each of the 32 layers
    forwards = dense["admitted"] + dense["steps"]
    out["launches_per_dense_forward"] = launches["llama_dense"] / forwards
    gates = {
        "16_tokens_each": all(len(t) == NEW_TOKENS for ts in tokens.values()
                              for t in ts),
        "logits_finite": all(out[n]["nonfinite_rows"] == 0
                             and out[n]["logit_rows"] > 0 for n in tokens),
        "dense_launched_flash": launches["llama_dense"] == 32 * forwards > 0,
        "paged_launched_no_flash": launches["llama"] == 0,
    }
    out["gates"] = gates
    out["ok"] = all(gates.values())
    emit(out)
    check(out["ok"], f"serving gates failed: {gates}")
    return launches["llama_dense"]


def fused_bound_ms(m, k, n, dtype_bytes):
    """Least time on the card for y = x @ w with the column statistics:
    2MKN flops for the product and 3MN for the sums, at the fp32 CUDA-core
    peak (bf16 at its tensor-core peak); bytes are x, w read once, y
    written once and the two fp32 [N] statistics written once."""
    flops = 2.0 * m * k * n + 3.0 * m * n
    peak = PEAK_BF16_FLOPS if dtype_bytes == 2 else PEAK_FP32_FLOPS
    nbytes = dtype_bytes * (m * k + k * n + m * n) + 8.0 * n
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _fused_inputs(torch, gen, m, k, n, dtype, affine, w_nk=True):
    """x [M, K] ~ N(0, 1) and w with entries ~ N(0, 1/K), so y is O(1);
    w is the transpose of a contiguous [N, K] (the conv layout the model
    hands the kernel) or, for a direct call, a contiguous [K, N] that the
    wrapper copies to the conv layout; the affine's scale is in
    [0.5, 1.5) and its shift ~ N(0, 0.25)."""
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = torch.randn(n, k, generator=gen, device="cuda") / math.sqrt(k)
    w = (w.to(dtype).t() if w_nk else w.t().contiguous().to(dtype))
    sc = sh = None
    if affine:
        sc = torch.rand(k, generator=gen, device="cuda") + 0.5
        sh = 0.5 * torch.randn(k, generator=gen, device="cuda")
    return x, w, sc, sh


def _fused_case(torch, FC, x, w, sc, sh, relu):
    """Run the kernel and its plain version (fp32, same values) once;
    the errors and whether they pass the gates."""
    y, s1, s2 = FC.fused_matmul_bn_stats(x, w, sc, sh, relu)
    ry, r1, r2 = FC._reference_conv1x1(x.float(), w.float(), sc, sh, relu)
    torch.cuda.synchronize()
    d = (y.float() - ry).abs()
    case = {"max_abs_err": d.max().item(),
            "sum_err_ratio": ((s1 - r1).abs() / ry.abs().sum(0)
                              .clamp_min(1e-30)).max().item() /
            FUSED_TOL["stats_rel"],
            "sumsq_err_ratio": ((s2 - r2).abs() / r2.clamp_min(1e-30))
            .max().item() / FUSED_TOL["stats_rel"]}
    if x.dtype == torch.float32:
        case["y_err_ratio"] = case["max_abs_err"] / (
            FUSED_TOL["y_fp32_rel"] * ry.abs().max().item())
    else:
        # 1 at the half-ulp bound; above 1 fails the case
        case["y_err_ratio"] = (d / (FUSED_TOL["y_bf16_rel"] * ry.abs()
                                    + FUSED_TOL["y_bf16_abs"])).max().item()
    case["ok"] = all(case[r] <= 1.0 for r in
                     ("y_err_ratio", "sum_err_ratio", "sumsq_err_ratio"))
    return case


def phase_fused_kernel(torch, seed):
    """The fused 1x1-conv + BN-statistics kernel against its plain version
    at every resnet50_v1 shape (batch 32) and one ragged shape, fp32 and
    bf16, in its three modes (the model's shapes with w in the conv layout,
    the ragged one as a direct call's contiguous [K, N]); then the timings
    at FUSED_TIMED, fp32, in the mode the model runs (no affine, w in the
    conv layout)."""
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = [(FUSED_CHECK_BATCH * side * side, k, n)
              for side, kns in FUSED_STAGES for k, n in kns]
    cases = []
    for (m, k, n) in shapes + [FUSED_RAGGED]:
        w_nk = (m, k, n) != FUSED_RAGGED
        for dtype in (torch.float32, torch.bfloat16):
            for mode, (affine, relu) in FUSED_MODES.items():
                x, w, sc, sh = _fused_inputs(torch, gen, m, k, n, dtype,
                                             affine, w_nk)
                case = _fused_case(torch, FC, x, w, sc, sh, relu)
                case.update(shape=[m, k, n], mode=mode,
                            dtype=str(dtype).replace("torch.", ""),
                            w_layout="nk" if w_nk else "kn")
                cases.append(case)
                del x, w, sc, sh
    bad = [c for c in cases if not c["ok"]]
    emit({"phase": "fused_kernel", "ok": not bad, "tolerance": FUSED_TOL,
          "cases": len(cases),
          "worst": {r: max(c[r] for c in cases) for r in
                    ("y_err_ratio", "sum_err_ratio", "sumsq_err_ratio")},
          "failed": bad})
    check(not bad, f"fused_conv_bn_stats disagrees with its plain version: "
          f"{bad}")

    m, k, n = FUSED_TIMED
    x, w, _, _ = _fused_inputs(torch, gen, m, k, n, torch.float32, False)
    timed = _fused_case(torch, FC, x, w, None, None, False)
    check(timed["ok"], f"fused_conv_bn_stats at {FUSED_TIMED}: {timed}")
    fns = {"kernel": lambda: FC.fused_matmul_bn_stats(x, w),
           "plain": lambda: FC._reference_conv1x1(x, w, None, None, False),
           "library": lambda: torch.matmul(x, w)}
    times = {key: [] for key in fns}
    for order in (("kernel", "plain", "library"),
                  ("library", "plain", "kernel")):
        for key in order:
            times[key].append(cuda_ms(torch, fns[key], iters=10))
    bound, bound_by = fused_bound_ms(m, k, n, 4)
    result = {"shape": list(FUSED_TIMED), "dtype": "float32",
              "mode": "plain", "max_abs_err": timed["max_abs_err"],
              "ms": min(times["kernel"]), "plain_ms": min(times["plain"]),
              "library_ms": min(times["library"]), "bound_ms": bound,
              "bound_by": bound_by, "runs_ms": times,
              "tf32": _tf32(torch)}
    emit({"phase": "fused_kernel_timing", "ok": True,
          "fused_conv_bn_stats": result})
    return result


def _tf32(torch):
    return {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}


def _resnet50(torch, fused, seed, dtype=None):
    """resnet50_v1 on the card (1000 classes), weights from ``seed``;
    converted to ``dtype`` with amp.convert_block when given."""
    from mxnet_tpu_torch.contrib.amp import convert_block
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.initializer import initialize
    from mxnet_tpu_torch.random import generator
    os.environ["MXNET_TPU_FUSE_CONV_BN"] = str(int(fused))
    net = resnet50_v1(classes=TRAIN["classes"], device="cuda")
    initialize(net, generator(seed, "cuda"))
    if dtype is not None:
        convert_block(net, dtype)
    return net


def _train_step(net, batch):
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.executor import CompiledTrainStep
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    return CompiledTrainStep(net, SoftmaxCrossEntropyLoss(),
                             optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9, wd=1e-4),
                             batch_size=batch)


def _images(torch, seed, batch, px, classes, dtype=None):
    """A batch of images uniform in [0, 1) and labels, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(batch, 3, px, px, generator=gen, device="cuda")
    y = torch.randint(0, classes, (batch,), generator=gen, device="cuda")
    return (x if dtype is None else x.to(dtype)), y.float()


def phase_resnet_parity(torch, seed):
    """One training step of resnet50_v1 fused and unfused from the same
    weights (the unfused 1x1 conv biases, which BN cancels, at 0) at 64 px,
    batch 8, fp32 with TF32 off: the losses and every fused 1x1 weight's
    update against its unfused counterpart's."""
    from mxnet_tpu_torch.gluon.contrib.nn import FusedConv1x1BN
    from mxnet_tpu_torch.gluon.nn import Conv2D
    unfused = _resnet50(torch, False, seed)
    fused = _resnet50(torch, True, seed)
    src = unfused.state_dict()
    biases = {f"{name}.bias" for name, mod in unfused.named_modules()
              if isinstance(mod, Conv2D) and mod.bias is not None
              and mod.weight.shape[2:] == (1, 1)}
    for key in biases:
        src[key].zero_()
    pairs = list(zip(fused.state_dict(), [k for k in src if k not in biases]))
    check(len(pairs) == len(src) - len(biases) == len(fused.state_dict())
          and all(src[u].shape == v.shape for (f, u), v in
                  zip(pairs, fused.state_dict().values())),
          "fused and unfused resnet50_v1 do not pair up")
    fused.load_state_dict({f: src[u] for f, u in pairs})
    fused_weights = {f"{name}.weight" for name, mod in fused.named_modules()
                     if isinstance(mod, FusedConv1x1BN)}
    w_pairs = [(f, u) for f, u in pairs if f in fused_weights]
    before = {f: src[u].clone() for f, u in w_pairs}
    x, y = _images(torch, seed + 5, PARITY["batch"], PARITY["px"],
                   TRAIN["classes"])
    loss_f = _train_step(fused, PARITY["batch"])(x, y).item()
    loss_u = _train_step(unfused, PARITY["batch"])(x, y).item()
    fsd, usd = fused.state_dict(), unfused.state_dict()
    worst_norm = worst_max = 0.0
    for f, u in w_pairs:
        du = usd[u] - before[f]
        gap = fsd[f] - before[f] - du
        worst_norm = max(worst_norm, (gap.norm() / du.norm()).item())
        worst_max = max(worst_max, (gap.abs().max() / du.abs().max()).item())
    loss_rel = abs(loss_f - loss_u) / abs(loss_u)
    ok = (math.isfinite(loss_f) and loss_rel <= PARITY["loss_rel"]
          and worst_norm <= PARITY["update_rel_norm"]
          and len(w_pairs) == FUSED_LAUNCHES_PER_STEP)
    emit({"phase": "resnet_parity", "ok": ok, "px": PARITY["px"],
          "batch": PARITY["batch"], "loss_fused": loss_f,
          "loss_unfused": loss_u, "loss_rel_diff": loss_rel,
          "fused_weights": len(w_pairs),
          "worst_update_rel_diff_norm": worst_norm,
          "worst_update_rel_diff_max": worst_max,
          "tolerance": {k: PARITY[k] for k in ("loss_rel",
                                               "update_rel_norm")},
          "tf32": _tf32(torch)})
    check(ok, "fused and unfused resnet50_v1 steps disagree")


def _train_run(torch, seed, name, fused, dtype):
    """``TRAIN["warmup"]`` + ``TRAIN["steps"]`` steps of full-width
    resnet50_v1 with the launch counts set to 0 just before and read just
    after; images per second from the host clock over the timed steps,
    ending in a ``loss.item()``."""
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    torch.cuda.empty_cache()
    bf16 = dtype == "bfloat16"
    net = _resnet50(torch, fused, seed, dtype)
    step = _train_step(net, TRAIN["batch"])
    x, y = _images(torch, seed + 7, TRAIN["batch"], TRAIN["px"],
                   TRAIN["classes"], torch.bfloat16 if bf16 else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FC.fused_conv_bn_launches = 0
    A.flash_fwd_launches = 0
    first = step(x, y).item()
    for _ in range(TRAIN["warmup"] - 1):
        step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN["steps"]):
        loss = step(x, y)
    last = loss.item()
    wall = time.perf_counter() - t0
    launches = FC.fused_conv_bn_launches
    flash = A.flash_fwd_launches
    steps = TRAIN["warmup"] + TRAIN["steps"]
    out = {"run": name, "fused": fused, "dtype": dtype or "float32",
           "batch": TRAIN["batch"], "px": TRAIN["px"], "steps": steps,
           "timed_steps": TRAIN["steps"],
           "imgs_per_sec": TRAIN["batch"] * TRAIN["steps"] / wall,
           "step_ms": 1e3 * wall / TRAIN["steps"], "first_loss": first,
           "last_loss": last,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "tf32": _tf32(torch), "fused_conv_bn_launches": launches,
           "flash_fwd_launches": flash}
    want = FUSED_LAUNCHES_PER_STEP * steps if fused else 0
    out["gates"] = {"losses_finite": math.isfinite(first)
                    and math.isfinite(last),
                    "launches": launches == want and flash == 0}
    out["ok"] = all(out["gates"].values())
    emit(out)
    check(out["ok"], f"training run {name} failed: {out['gates']}")
    del net, step, x, y
    return out


def phase_training(torch, seed):
    """Full-width resnet50_v1 training: (a) fused fp32, (b) unfused fp32,
    (c) unfused bf16 (bench.py's main configuration); TF32 off."""
    runs = [_train_run(torch, seed, "a_fused_fp32", True, None),
            _train_run(torch, seed, "b_unfused_fp32", False, None),
            _train_run(torch, seed, "c_unfused_bf16", False, "bfloat16")]
    emit({"phase": "training", "ok": True,
          "fused_over_unfused_step_ms": runs[0]["step_ms"]
          / runs[1]["step_ms"]})
    return runs[0]["fused_conv_bn_launches"]


def _kernel_line(name, source, replaces, launches, timing):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import mxnet_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SmokeFailure(f"the port is not beside this script ({e})")
    phase_build()
    phase_device(torch)
    timing = phase_kernels(torch, args.seed)
    fused = phase_fused_kernel(torch, args.seed)
    phase_model_parity(torch, args.seed)
    launches = phase_serving(torch, args.seed)
    phase_resnet_parity(torch, args.seed)
    fused_launches = phase_training(torch, args.seed)
    emit({"kernels": [_kernel_line(
        "flash_fwd", "mxnet_tpu_torch/csrc/flash_fwd.cu",
        "mxnet_tpu/ops/attention.py:51", launches, timing), _kernel_line(
        "fused_conv_bn_stats", "mxnet_tpu_torch/csrc/fused_conv_bn.cu",
        "mxnet_tpu/ops/fused_conv_bn.py:48", fused_launches, fused)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
