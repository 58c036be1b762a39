#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit.  It builds every CUDA kernel of the port from ``csrc/``,
holds each against its plain PyTorch version on the card and times it
beside its bound, then drives the port's paths:

- serving (slice 1): checks the Llama model's two attention paths against
  each other, then serves full-width llama_7b (32 layers, bf16, random
  weights from ``--seed``) through ``ModelServer`` on both generation
  engines;
- training (slice 2): holds the fused resnet50_v1 against the unfused one
  for one step at 64 px, then trains full-width resnet50_v1 (224 px, 1000
  classes, batch 256, SGD as bench.py) fused in fp32, unfused in fp32 and
  unfused in bf16;
- runtime kernels (slice 3): compiles CUDA C with ``mx.rtc.CudaModule``
  (NVRTC) and holds each kernel, launched on ``mx.gpu(0)`` NDArrays,
  against its ``mx.rtc.PallasModule`` twin on CPU copies; then runs
  llama_7b's FFN (bf16, 8192 tokens) for 3 + 10 imperative training steps
  through ``mx.nd`` and ``mx.autograd``, its SwiGLU an
  ``autograd.Function`` over two rtc kernels, held against plain torch
  autograd;
- BERT pretraining (slice 6): holds the fp32 tensor-core flash forward
  (three TF32 products per product) at BERT-base's attention shape against
  its plain version and its autograd Function's backward against plain
  autograd, and times it beside the CUDA-core kernel, SDPA and the
  ``flash_attention`` call the model makes;
  holds two Adam steps of the small BERT on the card against the same
  steps on the CPU; then trains full-width BERT-base (seq 128, batch 64,
  Adam, as bench.py) in fp32 and in bf16 through ``amp.convert_block``;
- the Gluon training loop (slice 8): ``train_mnist.py``'s net with
  deferred init trained 20 steps on ``mx.gpu(0)``, then full-width
  resnet50_v1 (fused fp32, batch 256) through ``net.initialize``,
  ``gluon.Trainer``, an ``NDArrayIter`` on the card and ``mx.metric``:
  its first 2 steps held against ``CompiledTrainStep`` from the same
  weights, then 3 + 10 timed steps beside ``CompiledTrainStep``'s.

Each phase prints one JSON line; any failed phase ends the run with a
non-zero exit code.  ``--only a,b`` runs only the named phases (build,
device, flash, flash_timing, fused, fused_timing, model_parity, serving,
resnet_parity, training, gluon_training, rtc_kernels, rtc_ffn, bert_flash,
bert_parity, bert_training), for a short call while a kernel is brought
up; ``--only build,gluon_training`` runs just the Gluon loop.  The line before the last is the kernel table; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.  ``--only build,flash`` is the short first call after a change
to a flash kernel: it builds the libraries, launches each FLASH_SHAPES case
once, holds it against the plain version and stops (add ``bert_flash`` for
the fp32 kernel at BERT's shape); ``--only build,fused`` does the same for
the fused 1x1-conv + BN-statistics kernels.
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
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# [B, H, S, D] shapes for the flash kernel check.  [4, 32, 1024, 128] is
# the dense engine's decode step in the serving phase (4 slots, prompts up
# to 1000 tokens bucketed to 1024); [4, 32, 2048, 128] is the timed shape.
# Every case runs on the kernel _flash_variant picks, which the launch
# counts confirm: bf16 on the tensor-core kernel when D % 8 == 0 (D = 64, a
# ragged 130-row tail, D = 40 padded to 64), fp32 on the three-TF32-product
# tensor-core kernel when D % 4 == 0 (all but D = 30; D = 36 and 40 padded
# to 64, ragged 100-, 130- and 300-row tails), and the CUDA-core kernel for
# the rest (bf16 D = 36 and 30, fp32 D = 30).
FLASH_SHAPES = [(1, 32, 16, 128), (4, 32, 512, 128), (4, 32, 1024, 128),
                (4, 32, 2048, 128), (1, 4, 64, 16), (2, 4, 300, 16),
                (2, 8, 384, 64), (1, 4, 130, 128), (1, 4, 100, 40),
                (1, 4, 64, 36), (1, 4, 64, 30)]
FLASH_TIMED = (4, 32, 2048, 128)
FLASH_DECODE = (4, 32, 1024, 128)
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
# conv of resnet50_v1, by stage, with its output side at 224 px (the
# stride sits on the first 1x1 and on the downsample of a stage's first
# block) and its launches in one training step, 36 in all; the kernel's M
# is batch * side^2.  Checked at batch 32; timed at batch 256 (the training
# phase's batch) at every shape, FUSED_TIMED in full detail.  All of them
# take the tensor-core kernel; the ragged shape (K % 4 != 0) takes the
# CUDA-core one.
FUSED_STAGES = (
    (56, ((64, 64, 1), (256, 64, 2), (64, 256, 4))),
    (28, ((256, 128, 1), (512, 128, 3), (128, 512, 4), (256, 512, 1))),
    (14, ((512, 256, 1), (1024, 256, 5), (256, 1024, 6), (512, 1024, 1))),
    (7, ((1024, 512, 1), (2048, 512, 2), (512, 2048, 3), (1024, 2048, 1))))
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
    """Mean milliseconds of ``fn`` over ``iters`` calls, by CUDA events.
    The card first spins for about a millisecond, so the host queues the
    calls ahead of it and a call shorter than its own launch still times
    as device work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
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
                       if "registers" in ln or "spill" in ln
                       or "C75" in ln]
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


def flash_bound_ms(b, h, s, d, causal, dtype_bytes, ops_factor=1.0,
                   peak=None):
    """Least time on the card: causal work is 2*B*H*S^2*D flops (two
    products, half the score matrix), non-causal twice that, times
    ``ops_factor`` (1.5 for the split-P kernel's own three products, 3 for
    the three TF32 products of the fp32 tensor-core kernel) at ``peak``
    (by default bf16's tensor-core peak for bf16, the CUDA cores' fp32 peak
    for fp32); bytes are q, k, v read once, O written once, lse (fp32)
    written once."""
    flops = 2.0 * b * h * s * s * d * (1 if causal else 2) * ops_factor
    if peak is None:
        peak = PEAK_BF16_FLOPS if dtype_bytes == 2 else PEAK_FP32_FLOPS
    nbytes = 4.0 * b * h * s * d * dtype_bytes + 4.0 * b * h * s
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_kernels(torch, seed):
    """Every FLASH_SHAPES case, fp32 and bf16, causal and not, once on the
    kernel _flash_variant picks, against the plain version in fp32."""
    from mxnet_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = []
    for (b, h, s, d) in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                q, k, v = (torch.randn(b * h, s, d, generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(3))
                scale = 1.0 / math.sqrt(d)
                before = (A.flash_fwd_wgmma_launches,
                          A.flash_fwd_tf32_launches)
                o, lse = A.flash_fwd(q, k, v, causal, scale)
                ran_wgmma = A.flash_fwd_wgmma_launches - before[0] == 1
                ran_tf32 = A.flash_fwd_tf32_launches - before[1] == 1
                ro, rl = A._flash_forward_plain(q.float(), k.float(),
                                                v.float(), causal, scale)
                torch.cuda.synchronize()
                name = str(dtype).replace("torch.", "")
                variant = A._flash_variant(dtype, d)
                case = {"shape": [b, h, s, d], "dtype": name,
                        "causal": causal, "variant": variant,
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
                if dtype == torch.float32:
                    want = "tf32" if d % 4 == 0 else "simt"
                else:
                    want = "wgmma" if d % 8 == 0 else "simt"
                case["ok"] = (case["o_err"] <= tol["o"]
                              and case["lse_err"] <= tol["lse"]
                              and case.get("o_half_ulp_ratio", 0.0) <= 1.0
                              and variant == want
                              and ran_wgmma == (variant == "wgmma")
                              and ran_tf32 == (variant == "tf32"))
                cases.append(case)
                del q, k, v, o, lse, ro, rl
    bad = [c for c in cases if not c["ok"]]
    emit({"phase": "kernels", "ok": not bad, "tolerance": TOL,
          "cases": cases})
    check(not bad, f"flash_fwd disagrees with its plain version: {bad}")


def _in_turns(torch, fns, iters=10):
    """Each function timed twice, in the order given and then reversed, in
    this one process; the lower of the two is kept."""
    times = {key: [] for key in fns}
    for order in (list(fns), list(fns)[::-1]):
        for key in order:
            times[key].append(cuda_ms(torch, fns[key], iters=iters))
    return {key: min(t) for key, t in times.items()}, times


def phase_flash_timing(torch, seed):
    """The tensor-core kernel, its plain version and SDPA in turns at the
    timed shape and at the dense engine's decode shape (causal bf16), with
    the CUDA-core kernel at the timed shape as the earlier figure."""
    from mxnet_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"dtype": "bfloat16", "causal": True,
           "variant": A._flash_variant(torch.bfloat16, FLASH_TIMED[3])}
    for key, (b, h, s, d) in (("timed", FLASH_TIMED),
                              ("decode", FLASH_DECODE)):
        q, k, v = (torch.randn(b * h, s, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        o, _ = A.flash_fwd(q, k, v, True, scale)
        ro, _ = A._flash_forward_plain(q.float(), k.float(), v.float(),
                                       True, scale)
        err = (o.float() - ro).abs().max().item()
        del o, ro
        q4, k4, v4 = (t.view(b, h, s, d) for t in (q, k, v))
        fns = {"kernel": lambda: A.flash_fwd(q, k, v, True, scale),
               "plain": lambda: A._flash_forward_plain(q, k, v, True, scale),
               "library": lambda: sdpa(q4, k4, v4, is_causal=True,
                                       scale=scale)}
        if key == "timed":
            fns["simt_kernel"] = lambda: A._flash_fwd_cuda(
                q, k, v, True, scale, variant="simt")
        best, runs = _in_turns(torch, fns)
        bound, bound_by = flash_bound_ms(b, h, s, d, True, 2)
        out[key] = {"shape": [b, h, s, d], "max_abs_err": err,
                    "ms": best["kernel"], "plain_ms": best["plain"],
                    "library_ms": best["library"], "bound_ms": bound,
                    "bound_by": bound_by,
                    # the kernel's own ceiling: split P costs a third product
                    "split_p_bound_ms": flash_bound_ms(b, h, s, d, True, 2,
                                                       1.5)[0],
                    "runs_ms": runs}
        if key == "timed":
            out[key]["simt_ms"] = best["simt_kernel"]
        del q, k, v, q4, k4, v4
    emit({"phase": "kernel_timing", "ok": True, "flash_fwd": out})
    return out["timed"]


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
    wgmma = {}
    with ModelServer() as server:
        server.register_generation("llama_dense", model, max_slots=4,
                                   kv_cache=False)
        server.register_generation("llama", model, max_slots=4,
                                   kv_cache=True, page_tokens=16,
                                   prefix_cache=True)
        for name in ("llama_dense", "llama"):
            torch.cuda.synchronize()
            A.flash_fwd_launches = A.flash_fwd_wgmma_launches = 0
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            futs = [server.generate_async(name, p, max_new_tokens=NEW_TOKENS,
                                          eos_id=None) for p in prompts]
            tokens[name] = [f.result(timeout=900) for f in futs]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches[name] = A.flash_fwd_launches
            wgmma[name] = A.flash_fwd_wgmma_launches
            st = server.stats(name)
            out[name] = {"wall_s": wall,
                         "tokens_per_s": len(prompts) * NEW_TOKENS / wall,
                         "steps": st["steps"], "admitted": st["admitted"],
                         "flash_fwd_launches": launches[name],
                         "flash_fwd_wgmma_launches": wgmma[name],
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
    # tensor-core kernel once in each of the 32 layers, and no other kernel
    forwards = dense["admitted"] + dense["steps"]
    out["launches_per_dense_forward"] = wgmma["llama_dense"] / forwards
    gates = {
        "16_tokens_each": all(len(t) == NEW_TOKENS for ts in tokens.values()
                              for t in ts),
        "logits_finite": all(out[n]["nonfinite_rows"] == 0
                             and out[n]["logit_rows"] > 0 for n in tokens),
        "dense_launched_flash": (wgmma["llama_dense"] == 32 * forwards > 0
                                 and launches["llama_dense"]
                                 == wgmma["llama_dense"]),
        "paged_launched_no_flash": launches["llama"] == 0,
    }
    out["gates"] = gates
    out["ok"] = all(gates.values())
    emit(out)
    check(out["ok"], f"serving gates failed: {gates}")
    return wgmma["llama_dense"]


def _fused_bytes(m, k, n, dtype_bytes):
    """x, w read once, y written once, the two fp32 [N] statistics written
    once."""
    return dtype_bytes * (m * k + k * n + m * n) + 8.0 * n


def fused_bound_ms(m, k, n, dtype_bytes):
    """Least time on the card for y = x @ w with the column statistics as
    the tensor-core kernel computes it: fp32 keeps fp32 through three TF32
    products (3 * 2MKN flops), bf16 inputs need one; at the TF32
    tensor-core peak, or the bytes at the memory rate if longer."""
    flops = (3 if dtype_bytes == 4 else 1) * 2.0 * m * k * n
    t_ops = flops / PEAK_TF32_FLOPS
    t_bytes = _fused_bytes(m, k, n, dtype_bytes) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def fused_cuda_core_bound_ms(m, k, n):
    """The same function in fp32 on the CUDA cores: 2MKN flops for the
    product and 3MN for the sums at the fp32 peak, or the bytes (the bound
    of the CUDA-core kernel, reported beside the tensor-core one)."""
    t_ops = (2.0 * m * k * n + 3.0 * m * n) / PEAK_FP32_FLOPS
    return 1e3 * max(t_ops, _fused_bytes(m, k, n, 4) / PEAK_BYTES)


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
    the errors, the kernel variant that ran (by the launch counts) and
    whether they pass the gates."""
    before = (FC.fused_conv_bn_launches, FC.fused_conv_bn_wgmma_launches)
    y, s1, s2 = FC.fused_matmul_bn_stats(x, w, sc, sh, relu)
    ran = (FC.fused_conv_bn_launches - before[0],
           FC.fused_conv_bn_wgmma_launches - before[1])
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
    case["variant"] = {(1, 1): "wgmma", (1, 0): "simt"}.get(ran, str(ran))
    case["ok"] = all(case[r] <= 1.0 for r in
                     ("y_err_ratio", "sum_err_ratio", "sumsq_err_ratio"))
    return case


def phase_fused_kernel(torch, seed):
    """The fused 1x1-conv + BN-statistics kernel against its plain version
    at every resnet50_v1 shape (batch 32) and one ragged shape, fp32 and
    bf16, in its three modes (the model's shapes with w in the conv layout,
    the ragged one as a direct call's contiguous [K, N]).  Each case must
    also have run on the expected kernel: the tensor cores for the model's
    shapes, the CUDA cores for the ragged one, as _fused_variant says and
    as the launch counts show."""
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = [(FUSED_CHECK_BATCH * side * side, k, n)
              for side, kns in FUSED_STAGES for k, n, _ in kns]
    cases = []
    for (m, k, n) in shapes + [FUSED_RAGGED]:
        w_nk = (m, k, n) != FUSED_RAGGED
        want = "wgmma" if w_nk else "simt"
        for dtype in (torch.float32, torch.bfloat16):
            for mode, (affine, relu) in FUSED_MODES.items():
                x, w, sc, sh = _fused_inputs(torch, gen, m, k, n, dtype,
                                             affine, w_nk)
                case = _fused_case(torch, FC, x, w, sc, sh, relu)
                case.update(shape=[m, k, n], mode=mode,
                            dtype=str(dtype).replace("torch.", ""),
                            w_layout="nk" if w_nk else "kn")
                case["ok"] = (case["ok"] and case["variant"] == want
                              and FC._fused_variant(dtype, m, k, n) == want)
                cases.append(case)
                del x, w, sc, sh
    bad = [c for c in cases if not c["ok"]]
    emit({"phase": "fused_kernel", "ok": not bad, "tolerance": FUSED_TOL,
          "cases": len(cases),
          "variants": {v: sum(c["variant"] == v for c in cases)
                       for v in ("wgmma", "simt")},
          "worst": {r: max(c[r] for c in cases) for r in
                    ("y_err_ratio", "sum_err_ratio", "sumsq_err_ratio")},
          "failed": bad})
    check(not bad, f"fused_conv_bn_stats disagrees with its plain version "
          f"or ran on the wrong kernel: {bad}")


def phase_fused_timing(torch, seed):
    """At each of the 15 shapes at batch 256, fp32, TF32 off, in the mode
    the model runs (no affine, w in the conv layout): the tensor-core
    kernel checked once against the gates, then timed in turns with the
    CUDA-core kernel (the earlier figure) and torch.matmul (y alone),
    beside the bound; the sums over one training step's 36 launches.  At
    FUSED_TIMED the plain version is timed too, for the kernels line."""
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    check(sum(c for _, kns in FUSED_STAGES for _, _, c in kns)
          == FUSED_LAUNCHES_PER_STEP,
          "FUSED_STAGES does not add up to one step's launches")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    batch = TRAIN["batch"]
    shapes, step = [], {"ms": 0.0, "simt_ms": 0.0, "library_ms": 0.0,
                        "bound_ms": 0.0, "bound_cuda_cores_ms": 0.0}
    timed = None
    for side, kns in FUSED_STAGES:
        for k, n, per_step in kns:
            m = batch * side * side
            x, w, _, _ = _fused_inputs(torch, gen, m, k, n, torch.float32,
                                       False)
            case = _fused_case(torch, FC, x, w, None, None, False)
            check(case["ok"] and case["variant"] == "wgmma",
                  f"fused_conv_bn_stats at {(m, k, n)}: {case}")
            fns = {"kernel": lambda: FC.fused_matmul_bn_stats(x, w),
                   "simt": lambda: FC._fused_cuda(x, w, None, None, False,
                                                  variant="simt"),
                   "library": lambda: torch.matmul(x, w)}
            if (m, k, n) == FUSED_TIMED:
                fns["plain"] = lambda: FC._reference_conv1x1(
                    x, w, None, None, False)
            best, runs = _in_turns(torch, fns)
            bound, bound_by = fused_bound_ms(m, k, n, 4)
            row = {"shape": [m, k, n], "launches_per_step": per_step,
                   "variant": case["variant"],
                   "max_abs_err": case["max_abs_err"],
                   "y_err_ratio": case["y_err_ratio"],
                   "ms": best["kernel"], "simt_ms": best["simt"],
                   "library_ms": best["library"], "bound_ms": bound,
                   "bound_by": bound_by,
                   "bound_cuda_cores_ms": fused_cuda_core_bound_ms(m, k, n),
                   "runs_ms": runs}
            for key in step:
                step[key] += row["launches_per_step"] * row[key]
            if (m, k, n) == FUSED_TIMED:
                timed = dict(row, dtype="float32", mode="plain",
                             plain_ms=best["plain"], tf32=_tf32(torch))
            shapes.append(row)
            del x, w
            torch.cuda.empty_cache()
    check(timed is not None, f"FUSED_TIMED {FUSED_TIMED} is not a step shape")
    emit({"phase": "fused_kernel_timing", "ok": True, "tf32": _tf32(torch),
          "launches_per_step": FUSED_LAUNCHES_PER_STEP,
          "step_sum": step, "shapes": shapes})
    return timed


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
    FC.fused_conv_bn_wgmma_launches = 0
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
    wgmma = FC.fused_conv_bn_wgmma_launches
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
           "fused_conv_bn_wgmma_launches": wgmma,
           "flash_fwd_launches": flash}
    want = FUSED_LAUNCHES_PER_STEP * steps if fused else 0
    out["gates"] = {"losses_finite": math.isfinite(first)
                    and math.isfinite(last),
                    "launches": launches == want and wgmma == want
                    and flash == 0}
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


# ---------------------------------------------------------------------------
# slice 8: the Gluon training loop
# ---------------------------------------------------------------------------
# The canonical loop, record() -> loss.backward() -> trainer.step(batch),
# over an NDArrayIter, with mx.metric.Accuracy updated every step.  First
# train_mnist.py's net (no input widths: deferred init materialises every
# parameter on the card at the first forward) on its synthetic data, with
# its learning rate; the mean loss of the last 5 of 20 steps must lie below
# that of the first 5.  Then full-width resnet50_v1 as the training phase
# runs it (fused fp32, TF32 off, SGD as bench.py), initialised with Xavier
# through net.initialize: its first 2 steps are held against
# CompiledTrainStep from the same weights on the same batches, each step
# from the same state (every parameter, moving statistic and momentum
# within STEP_REL of its tensor's largest |value| plus STEP_ABS, the
# tolerance the CPU tests hold the port's steps to; on the CPU the two
# loops agree bit for bit, since a batch of 256 makes the mean's head
# gradient a power of two, and on the card they differ only where cuDNN
# and the max-pool backward sum in a run-dependent order), then it
# trains 3 + 10 steps with the launch counts set to 0 just before and read
# just after (36 tensor-core fused launches per step), and CompiledTrainStep
# runs the same 3 + 10 steps after it, timed the same way.
GLUON = dict(mnist_batch=64, mnist_steps=20, mnist_lr=0.01, batch=256,
             px=224, classes=1000, batches=2, parity_steps=2, warmup=3,
             steps=10, step_rel=1e-3, step_abs=1e-6)


def _gluon_mnist(torch, seed):
    """train_mnist.py's net and data through the Gluon loop on mx.gpu(0)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    mx.random.seed(seed)
    net = gluon.nn.Sequential()
    net.add(gluon.nn.Conv2D(32, 3, padding=1, activation="relu"),
            gluon.nn.MaxPool2D(2),
            gluon.nn.Conv2D(64, 3, padding=1, activation="relu"),
            gluon.nn.MaxPool2D(2),
            gluon.nn.Flatten(),
            gluon.nn.Dense(128, activation="relu"),
            gluon.nn.Dense(10))
    net.initialize(ctx=mx.gpu(0))
    deferred = sum(p.shape is None or 0 in p.shape
                   for p in net.collect_params().values())
    rng = np.random.RandomState(seed)
    x = rng.rand(2048, 1, 28, 28).astype("float32")
    y = ((x.mean(axis=(1, 2, 3)) * 10).astype("int64") % 10).astype(
        "float32")
    it = mx.io.NDArrayIter(x[:1792], y[:1792], GLUON["mnist_batch"],
                           shuffle=True)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": GLUON["mnist_lr"],
                             "momentum": 0.9})
    metric = mx.metric.Accuracy()
    losses = []
    for _, batch in zip(range(GLUON["mnist_steps"]), it):
        data, label = batch.data[0], batch.label[0]
        with autograd.record():
            out = net(data)
            loss = loss_fn(out, label)
        loss.backward()
        trainer.step(GLUON["mnist_batch"])
        metric.update([label], [out])
        losses.append(float(loss.mean().asscalar()))
    on_card = all(p.data().context == mx.gpu(0) and p.data()._data.is_cuda
                  for p in net.collect_params().values())
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    out = {"steps": len(losses), "deferred_params": deferred,
           "params_on_card": on_card, "first5_mean_loss": first,
           "last5_mean_loss": last, "accuracy": float(metric.get()[1]),
           "shapes": {k: list(p.shape)
                      for k, p in net.collect_params().items()}}
    out["gates"] = {"deferred_then_on_card": deferred == 4 and on_card,
                    "loss_falls": math.isfinite(last) and last < first}
    return out


def _state_gap(got, ref):
    """The largest ``max|got - ref| / (max|ref| + STEP_ABS/STEP_REL)``
    over matching tensors, with its name."""
    worst = (0.0, "")
    for name, r in ref.items():
        bound = r.abs().max().item() + GLUON["step_abs"] / GLUON["step_rel"]
        worst = max(worst, ((got[name] - r).abs().max().item() / bound,
                            name))
    return worst


def _gluon_resnet(torch, seed):
    """resnet50_v1 (fused fp32, 1000 classes) built on mx.gpu(0) and
    initialised through the Gluon API, with its Trainer and metric;
    returns ``(net, trainer, metric, step)``, ``step(data, label)`` one
    step of the canonical loop (the loss NDArray, not synchronised)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    os.environ["MXNET_TPU_FUSE_CONV_BN"] = "1"
    mx.random.seed(seed)
    net = resnet50_v1(classes=GLUON["classes"], ctx=mx.gpu(0))
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2))
    net.hybridize()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 1e-4})
    metric = mx.metric.Accuracy()

    def step(data, label):
        with autograd.record():
            out = net(data)
            loss = loss_fn(out, label)
        loss.backward()
        trainer.step(data.shape[0])
        metric.update([label], [out])
        return loss

    return net, trainer, metric, step


def phase_gluon_training(torch, seed):
    """The Gluon training loop on the card (see the comment above)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    mnist = _gluon_mnist(torch, seed)
    emit({"phase": "gluon_mnist", "ok": all(mnist["gates"].values()),
          **mnist})
    check(all(mnist["gates"].values()),
          f"train_mnist.py's loop on the card failed: {mnist['gates']}")

    torch.cuda.empty_cache()
    net, trainer, metric, gluon_step = _gluon_resnet(torch, seed)
    ref = resnet50_v1(classes=GLUON["classes"], ctx=mx.gpu(0))
    ref.load_state_dict(net.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    n = GLUON["batch"] * GLUON["batches"]
    x = torch.rand(n, 3, GLUON["px"], GLUON["px"], generator=gen,
                   device="cuda")
    y = torch.randint(0, GLUON["classes"], (n,), generator=gen,
                      device="cuda").float()
    it = mx.io.NDArrayIter(mx.nd.NDArray(x), mx.nd.NDArray(y),
                           GLUON["batch"])
    del x, y

    def next_batch():
        try:
            batch = it.next()
        except StopIteration:
            it.reset()
            batch = it.next()
        return batch.data[0], batch.label[0]

    compiled = _train_step(ref, GLUON["batch"])
    learnable = [i for i, p in enumerate(net.collect_params().values())
                 if p.grad_req != "null"]
    parity = []
    for k in range(GLUON["parity_steps"]):
        if k:
            # each step from the same state, as the CPU tests run it: the
            # card's nondeterministic sums (cuDNN, max-pool backward) grow
            # through a second step in either loop
            ref.load_state_dict(net.state_dict())
            for i, mom in zip(learnable, compiled._states):
                mom.copy_(trainer._updaters[0].states[i])
        data, label = next_batch()
        gl = float(gluon_step(data, label).mean().asscalar())
        cl = compiled(data._data, label._data).item()
        state = _state_gap(net.state_dict(), ref.state_dict())
        moms = {str(i): trainer._updaters[0].states[i] for i in learnable}
        mom = _state_gap(moms, {str(i): m for i, m in
                                       zip(learnable, compiled._states)})
        parity.append({"step": k + 1, "loss_gluon": gl, "loss_compiled": cl,
                       "worst_state": state, "worst_momentum": mom,
                       "bitwise_equal_tensors": sum(
                           torch.equal(a, b) for a, b in zip(
                               net.state_dict().values(),
                               ref.state_dict().values()))})
    parity_ok = all(math.isfinite(p["loss_gluon"])
                    and p["worst_state"][0] <= GLUON["step_rel"]
                    and p["worst_momentum"][0] <= GLUON["step_rel"]
                    for p in parity)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FC.fused_conv_bn_launches = 0
    FC.fused_conv_bn_wgmma_launches = 0
    first = float(gluon_step(*next_batch()).mean().asscalar())
    for _ in range(GLUON["warmup"] - 1):
        gluon_step(*next_batch())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GLUON["steps"]):
        loss = gluon_step(*next_batch())
    last = float(loss.mean().asscalar())
    wall = time.perf_counter() - t0
    launches = FC.fused_conv_bn_launches
    wgmma = FC.fused_conv_bn_wgmma_launches
    peak = torch.cuda.max_memory_allocated() / 1e9

    batches = [next_batch() for _ in range(GLUON["batches"])]
    for i in range(GLUON["warmup"]):
        data, label = batches[i % len(batches)]
        compiled(data._data, label._data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(GLUON["steps"]):
        data, label = batches[i % len(batches)]
        closs = compiled(data._data, label._data)
    closs.item()
    compiled_wall = time.perf_counter() - t0

    steps = GLUON["warmup"] + GLUON["steps"]
    want = FUSED_LAUNCHES_PER_STEP * steps
    out = {"phase": "gluon_training", "model": "resnet50_v1", "fused": True,
           "dtype": "float32", "batch": GLUON["batch"], "px": GLUON["px"],
           "steps": steps, "timed_steps": GLUON["steps"],
           "step_ms": 1e3 * wall / GLUON["steps"],
           "imgs_per_sec": GLUON["batch"] * GLUON["steps"] / wall,
           "compiled_step_ms": 1e3 * compiled_wall / GLUON["steps"],
           "compiled_imgs_per_sec":
               GLUON["batch"] * GLUON["steps"] / compiled_wall,
           "first_loss": first, "last_loss": last,
           "accuracy": float(metric.get()[1]), "peak_mem_gb": peak,
           "fused_conv_bn_launches": launches,
           "fused_conv_bn_wgmma_launches": wgmma, "parity": parity,
           "tolerance": {k: GLUON[k] for k in ("step_rel", "step_abs")},
           "tf32": _tf32(torch)}
    out["gates"] = {"launches": launches == want and wgmma == want,
                    "parity_with_compiled_train_step": parity_ok,
                    "losses_finite": math.isfinite(first)
                    and math.isfinite(last)}
    out["ok"] = all(out["gates"].values())
    emit(out)
    check(out["ok"], f"gluon_training failed: {out['gates']}")
    del net, ref, it, trainer, compiled, batches
    return launches


# ---------------------------------------------------------------------------
# slice 3: mx.nd / mx.autograd / mx.rtc.CudaModule
# ---------------------------------------------------------------------------
# Each rtc kernel below is user code, as an MXNet user writes it for
# mx.rtc.CudaModule, beside its plain twin for mx.rtc.PallasModule (the JAX
# package's rtc test sources, in torch).  Gates against the twin run on CPU
# copies of the same inputs: int32 equal bit for bit; float32 within 1 ulp
# of the magnitude of the terms (NVRTC may contract a*x+y into an FMA,
# which rounds once where the twin rounds twice); bf16 outputs, computed in
# fp32 and rounded once, against the twin's fp32 result on the same values:
# |k - ref| <= 2^-8 |ref| (half a bf16 ulp) + 2^-20 * terms (the fp32
# evaluation order and expf against torch's exp).
RTC_SOURCES = {
    "axpy": r'''
extern "C" __global__ void axpy(const float *x, const float *y, float *o,
                                const float a, const int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) o[i] = a * x[i] + y[i];
}''',
    "double2d": r'''
extern "C" __global__ void double2d(const float *x, float *o, const int rows,
                                    const int cols) {
    int c = blockIdx.x * blockDim.x + threadIdx.x;
    int r = blockIdx.y * blockDim.y + threadIdx.y;
    if (r < rows && c < cols) {
        long long i = (long long)r * cols + c;
        o[i] = x[i] * 2.0f;
    }
}''',
    "split": r'''
extern "C" __global__ void split(const float *x, float *a, float *b,
                                 const int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) { a[i] = x[i] * 2.0f; b[i] = x[i] + 1.0f; }
}''',
    "inc": r'''
extern "C" __global__ void inc(const int *x, int *o, const int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) o[i] = x[i] + 1;
}''',
    "scaled": r'''
extern "C" __global__ void scaled(const float *x, const float a, float *o,
                                  const int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) o[i] = a * x[i];
}''',
    # one row per block, staged through dynamic shared memory (cols * 4
    # bytes, above the 48 KB that needs no opt-in)
    "reverse_rows": r'''
extern "C" __global__ void reverse_rows(const float *x, float *o,
                                        const int cols) {
    extern __shared__ float row[];
    const float *src = x + (long long)blockIdx.x * cols;
    float *dst = o + (long long)blockIdx.x * cols;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) row[c] = src[c];
    __syncthreads();
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
        dst[c] = row[cols - 1 - c];
}''',
    # a bf16 scalar (passed as its 16 bits) and an int64 count
    "axpy_bf16": r'''
#include <cuda_bf16.h>
extern "C" __global__ void axpy_bf16(const __nv_bfloat16 *x,
                                     const __nv_bfloat16 *y,
                                     __nv_bfloat16 *o, const __nv_bfloat16 a,
                                     const long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n)
        o[i] = __float2bfloat16(__bfloat162float(a) * __bfloat162float(x[i])
                                + __bfloat162float(y[i]));
}''',
}
RTC_SIGNATURES = {
    "axpy": "const float *x, const float *y, float *o, const float a, "
            "const int n",
    "double2d": "const float *x, float *o, const int rows, const int cols",
    "split": "const float *x, float *a, float *b, const int n",
    "inc": "const int32_t *x, int32_t *o, const int n",
    "scaled": "const float *x, const float a, float *o, const int n",
    "reverse_rows": "const float *x, float *o, const int cols",
    "axpy_bf16": "const bfloat16 *x, const bfloat16 *y, bfloat16 *o, "
                 "const bfloat16 a, const int64_t n",
}
# The SwiGLU pair of llama_7b's FFN (gluon/model_zoo/language/llama.py:
# 146-160, h = silu(g) * u): each thread takes 8 bf16 values in one 16-byte
# load per operand where the pointers allow, computes in fp32 and rounds
# once.  Bound by bytes: forward reads g, u and writes h; backward reads g,
# u, dh and writes dg, du.
SWIGLU_SOURCE = r'''
#include <cuda_bf16.h>

__device__ __forceinline__ float ld(const __nv_bfloat16 v) {
    return __bfloat162float(v);
}

__device__ __forceinline__ void fwd1(float g, float u, __nv_bfloat16 *h) {
    *h = __float2bfloat16(g / (1.0f + expf(-g)) * u);
}

__device__ __forceinline__ void bwd1(float g, float u, float dh,
                                     __nv_bfloat16 *dg, __nv_bfloat16 *du) {
    float s = 1.0f / (1.0f + expf(-g));
    *dg = __float2bfloat16(dh * u * s * (1.0f + g * (1.0f - s)));
    *du = __float2bfloat16(dh * g * s);
}

__device__ __forceinline__ bool aligned16(const void *p) {
    return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0;
}

extern "C" __global__ void swiglu_fwd(const __nv_bfloat16 *__restrict__ g,
                                      const __nv_bfloat16 *__restrict__ u,
                                      __nv_bfloat16 *__restrict__ h,
                                      const long long n) {
    const bool vec = aligned16(g) && aligned16(u) && aligned16(h);
    const long long stride = 8LL * gridDim.x * blockDim.x;
    for (long long i = 8LL * (blockIdx.x * (long long)blockDim.x + threadIdx.x);
         i < n; i += stride) {
        if (vec && i + 8 <= n) {
            uint4 gv = *reinterpret_cast<const uint4 *>(g + i);
            uint4 uv = *reinterpret_cast<const uint4 *>(u + i);
            uint4 hv;
            const __nv_bfloat16 *gp = reinterpret_cast<const __nv_bfloat16 *>(&gv);
            const __nv_bfloat16 *up = reinterpret_cast<const __nv_bfloat16 *>(&uv);
            __nv_bfloat16 *hp = reinterpret_cast<__nv_bfloat16 *>(&hv);
#pragma unroll
            for (int k = 0; k < 8; ++k) fwd1(ld(gp[k]), ld(up[k]), hp + k);
            *reinterpret_cast<uint4 *>(h + i) = hv;
        } else {
            for (long long j = i; j < n && j < i + 8; ++j)
                fwd1(ld(g[j]), ld(u[j]), h + j);
        }
    }
}

extern "C" __global__ void swiglu_bwd(const __nv_bfloat16 *__restrict__ g,
                                      const __nv_bfloat16 *__restrict__ u,
                                      const __nv_bfloat16 *__restrict__ dh,
                                      __nv_bfloat16 *__restrict__ dg,
                                      __nv_bfloat16 *__restrict__ du,
                                      const long long n) {
    const bool vec = aligned16(g) && aligned16(u) && aligned16(dh)
        && aligned16(dg) && aligned16(du);
    const long long stride = 8LL * gridDim.x * blockDim.x;
    for (long long i = 8LL * (blockIdx.x * (long long)blockDim.x + threadIdx.x);
         i < n; i += stride) {
        if (vec && i + 8 <= n) {
            uint4 gv = *reinterpret_cast<const uint4 *>(g + i);
            uint4 uv = *reinterpret_cast<const uint4 *>(u + i);
            uint4 hv = *reinterpret_cast<const uint4 *>(dh + i);
            uint4 dgv, duv;
            const __nv_bfloat16 *gp = reinterpret_cast<const __nv_bfloat16 *>(&gv);
            const __nv_bfloat16 *up = reinterpret_cast<const __nv_bfloat16 *>(&uv);
            const __nv_bfloat16 *hp = reinterpret_cast<const __nv_bfloat16 *>(&hv);
            __nv_bfloat16 *gop = reinterpret_cast<__nv_bfloat16 *>(&dgv);
            __nv_bfloat16 *uop = reinterpret_cast<__nv_bfloat16 *>(&duv);
#pragma unroll
            for (int k = 0; k < 8; ++k)
                bwd1(ld(gp[k]), ld(up[k]), ld(hp[k]), gop + k, uop + k);
            *reinterpret_cast<uint4 *>(dg + i) = dgv;
            *reinterpret_cast<uint4 *>(du + i) = duv;
        } else {
            for (long long j = i; j < n && j < i + 8; ++j)
                bwd1(ld(g[j]), ld(u[j]), ld(dh[j]), dg + j, du + j);
        }
    }
}
'''
SWIGLU_SIGNATURES = {
    "swiglu_fwd": "const bfloat16 *g, const bfloat16 *u, bfloat16 *h, "
                  "const int64_t n",
    "swiglu_bwd": "const bfloat16 *g, const bfloat16 *u, const bfloat16 *dh, "
                  "bfloat16 *dg, bfloat16 *du, const int64_t n",
}
SWIGLU_BLOCK = 256
# The twins for mx.rtc.PallasModule: the JAX package's rtc test sources
# (tests/test_misc_components.py:232-265, 372; tests/test_surface_probe_r6.py:
# 117-157) and the same Pallas-style form for the others, whose bf16
# outputs are written in fp32 here (float* in their signatures).
TWIN_SOURCE = '''
def axpy(x_ref, y_ref, o_ref, a):
    o_ref[...] = a * x_ref[...] + y_ref[...]

def double(x_ref, o_ref):
    o_ref[...] = x_ref[...] * 2.0

def split(x_ref, a_ref, b_ref):
    a_ref[...] = x_ref[...] * 2.0
    b_ref[...] = x_ref[...] + 1.0

def inc(x_ref, o_ref):
    o_ref[...] = x_ref[...] + 1

def scaled(x_ref, a, o_ref):
    o_ref[...] = a * x_ref[...]

def reverse_rows(x_ref, o_ref):
    o_ref[...] = torch.flip(x_ref[...], dims=[-1])

def axpy_bf16(x_ref, y_ref, o_ref, a):
    o_ref[...] = a * x_ref[...].float() + y_ref[...].float()

def swiglu_fwd(g_ref, u_ref, h_ref):
    g = g_ref[...].float()
    h_ref[...] = g * torch.sigmoid(g) * u_ref[...].float()

def swiglu_bwd(g_ref, u_ref, dh_ref, dg_ref, du_ref):
    g, u, dh = g_ref[...].float(), u_ref[...].float(), dh_ref[...].float()
    s = torch.sigmoid(g)
    dg_ref[...] = dh * u * s * (1.0 + g * (1.0 - s))
    du_ref[...] = dh * g * s
'''
TWIN_SIGNATURES = {
    "axpy": "const float *x, const float *y, float *o, const float a",
    "double": "const float *x, float *o",
    "split": "const float *x, float *a, float *b",
    "inc": "const int32_t *x, int32_t *o",
    "scaled": "const float *x, const float a, float *o",
    "reverse_rows": "const float *x, float *o",
    "axpy_bf16": "const bfloat16 *x, const bfloat16 *y, float *o, "
                 "const bfloat16 a",
    "swiglu_fwd": "const bfloat16 *g, const bfloat16 *u, float *h",
    "swiglu_bwd": "const bfloat16 *g, const bfloat16 *u, const bfloat16 *dh, "
                  "float *dg, float *du",
}
RTC_SIZES = (1, 7, 1000, 65537, (1 << 20) + 5)
RTC_2D = ((6, 5), (300, 257), (2048, 4099))
RTC_SMEM_COLS = (25000, 58000)   # 100,000 and 232,000 bytes of shared memory
RTC_SWIGLU_SIZES = (1, 7, 8, 1000, 65543, (1 << 20) + 3)
RTC_BF16_ABS = 2.0 ** -20
FFN = dict(units=4096, hidden=11008, batch=4, seq=2048, warmup=3, steps=10,
           loss_rel=5e-3, grad_rel_norm=2e-2)
# flops per element of each SwiGLU kernel, for its operation bound (exp
# counted as one): forward 1 exp, 1 add, 1 div, 1 mul; backward 1 exp,
# 1 add, 1 div and 8 mul/add
SWIGLU_FLOPS = {"swiglu_fwd": 4, "swiglu_bwd": 11}


def _rtc_module(mx, source, exports, compile_s):
    mod = mx.rtc.CudaModule(source, exports=exports)
    compile_s[",".join(exports)] = mod.compile_seconds
    return mod


def _ulp(torch, x):
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def _rtc_case(torch, mx, name, kernel, twin, args, grid, block, twin_grid,
              twin_block, kind, terms=None, shared_mem=0):
    """Launch ``kernel`` on the card and ``twin`` (PallasModule) on CPU
    copies of the same arrays; compare every output."""
    outs = kernel.launch(args, mx.gpu(0), grid, block, shared_mem)
    outs = outs if isinstance(outs, list) else [outs]
    torch.cuda.synchronize()
    # the twins take no trailing counts; their bf16 outputs are fp32
    twin_args = []
    for (_, dtype, kind_), a in zip(twin._spec, args):
        if kind_ != "scalar":
            a = a.copyto(mx.cpu())
            if a._data.dtype != dtype:
                a = a.astype(str(dtype).replace("torch.", ""))
        twin_args.append(a)
    refs = twin.launch(twin_args, mx.cpu(), twin_grid, twin_block)
    refs = refs if isinstance(refs, list) else [refs]
    worst = err = 0.0
    for o, r in zip(outs, refs):
        k = o._data.detach().cpu()
        ref = r._data
        if kind == "int32":
            ratio = float((k != ref).any())
        elif kind == "float32":
            scale = ref.abs() if terms is None else terms(twin_args)
            ratio = ((k - ref).abs() / _ulp(torch, scale).clamp_min(
                1e-45)).max().item()
        else:
            scale = ref.abs() if terms is None else terms(twin_args)
            tol = 2.0 ** -8 * ref.abs() + RTC_BF16_ABS * scale
            ratio = ((k.float() - ref).abs() / tol.clamp_min(1e-30)).max().item()
        worst = max(worst, ratio)
        err = max(err, (k.float() - ref.float()).abs().max().item())
    return {"kernel": name, "ok": worst <= 1.0, "err_ratio": worst,
            "max_abs_err": err}


def phase_rtc_kernels(torch, seed):
    """Every rtc kernel of this path compiled with CudaModule and launched
    on mx.gpu(0) NDArrays at ragged sizes, each held against its
    PallasModule twin on CPU copies."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    compile_s = {}
    mods = {name: _rtc_module(mx, src, [name], compile_s)
            for name, src in RTC_SOURCES.items()}
    mods["swiglu"] = _rtc_module(mx, SWIGLU_SOURCE, list(SWIGLU_SIGNATURES),
                                 compile_s)
    kern = {name: mods[name].get_kernel(name, sig)
            for name, sig in RTC_SIGNATURES.items()}
    kern.update({name: mods["swiglu"].get_kernel(name, sig)
                 for name, sig in SWIGLU_SIGNATURES.items()})
    twins = mx.rtc.PallasModule(TWIN_SOURCE)
    twin = {name: twins.get_kernel(name, sig)
            for name, sig in TWIN_SIGNATURES.items()}
    gpu = mx.gpu(0)

    def arr(*shape, dtype=torch.float32, ints=False):
        if ints:
            t = torch.randint(-2 ** 30, 2 ** 30, shape, generator=gen,
                              device="cuda", dtype=torch.int32)
        else:
            t = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
        return nd.array(t, ctx=gpu)

    def out(*shape, dtype="float32"):
        return nd.full(shape, float("nan") if dtype != "int32" else -1,
                       ctx=gpu, dtype=dtype)

    def lin(n):
        return ((n + 255) // 256, 1, 1), (256, 1, 1)

    whole = ((1, 1, 1), (0, 0, 0))
    cases = []
    for n in RTC_SIZES:
        x, y = arr(n), arr(n)
        g, b = lin(n)
        cases.append(_rtc_case(torch, mx, "axpy", kern["axpy"], twin["axpy"],
                               [x, y, out(n), 1.7, n], g, b, *whole, "float32",
                               terms=lambda a: (1.7 * a[0]._data).abs()
                               + a[1]._data.abs()))
        cases.append(_rtc_case(torch, mx, "split", kern["split"],
                               twin["split"], [x, out(n), out(n), n], g, b,
                               *whole, "float32",
                               terms=lambda a: a[0]._data.abs() + 1.0))
        cases.append(_rtc_case(torch, mx, "inc", kern["inc"], twin["inc"],
                               [arr(n, ints=True), out(n, dtype="int32"), n],
                               g, b, *whole, "int32"))
        cases.append(_rtc_case(torch, mx, "scaled", kern["scaled"],
                               twin["scaled"], [x, -3.25, out(n), n], g, b,
                               *whole, "float32"))
        cases.append(_rtc_case(torch, mx, "axpy_bf16", kern["axpy_bf16"],
                               twin["axpy_bf16"],
                               [arr(n, dtype=torch.bfloat16),
                                arr(n, dtype=torch.bfloat16),
                                out(n, dtype="bfloat16"), 0.7, n], g, b,
                               *whole, "bf16",
                               terms=lambda a: (0.69921875 * a[0]._data.float()).abs()
                               + a[1]._data.float().abs()))
    for rows, cols in RTC_2D:
        # the CUDA kernel walks a 2-D grid of 16x16 blocks; the twin, the
        # JAX test's tiled form, two row blocks of a Pallas grid
        cases.append(_rtc_case(
            torch, mx, "double2d", kern["double2d"], twin["double"],
            [arr(rows, cols), out(rows, cols), rows, cols],
            ((cols + 15) // 16, (rows + 15) // 16, 1), (16, 16, 1),
            (2, 1, 1), (rows // 2, 0, 0), "float32"))
    for cols in RTC_SMEM_COLS:
        cases.append(_rtc_case(
            torch, mx, "reverse_rows", kern["reverse_rows"],
            twin["reverse_rows"], [arr(3, cols), out(3, cols), cols],
            (3, 1, 1), (1024, 1, 1), *whole, "float32",
            shared_mem=4 * cols))
    for n in RTC_SWIGLU_SIZES:
        g_, u_ = arr(n, dtype=torch.bfloat16), arr(n, dtype=torch.bfloat16)
        grid = (max(1, -(-n // (8 * SWIGLU_BLOCK))), 1, 1)
        block = (SWIGLU_BLOCK, 1, 1)
        cases.append(_rtc_case(
            torch, mx, "swiglu_fwd", kern["swiglu_fwd"], twin["swiglu_fwd"],
            [g_, u_, out(n, dtype="bfloat16"), n], grid, block, *whole, "bf16",
            terms=lambda a: (a[0]._data.float() * a[1]._data.float()).abs()))
        cases.append(_rtc_case(
            torch, mx, "swiglu_bwd", kern["swiglu_bwd"], twin["swiglu_bwd"],
            [g_, u_, arr(n, dtype=torch.bfloat16), out(n, dtype="bfloat16"),
             out(n, dtype="bfloat16"), n], grid, block, *whole, "bf16",
            terms=lambda a: ((a[0]._data.float().abs() + 1.0) ** 2
                             * (a[1]._data.float() * a[2]._data.float()).abs()
                             + (a[0]._data.float() * a[2]._data.float()).abs())))
    # a strided input is read from a dense copy; a misaligned view takes
    # the kernel's scalar path
    n = 4099
    base = arr(2 * n + 1, dtype=torch.bfloat16)
    gs, us = base[1:n + 1], base[n + 1:]
    cases.append(_rtc_case(
        torch, mx, "swiglu_fwd_offset_views", kern["swiglu_fwd"],
        twin["swiglu_fwd"], [gs, us, out(n, dtype="bfloat16"), n],
        (3, 1, 1), (SWIGLU_BLOCK, 1, 1), *whole, "bf16",
        terms=lambda a: (a[0]._data.float() * a[1]._data.float()).abs()))
    refused = _rtc_refusals(mx, nd, kern, gpu)
    # does this NVRTC resolve cuda_bf16.h from its built-in headers, without
    # the toolkit's include directory that CudaModule passes?
    from mxnet_tpu_torch import _cuda_driver
    try:
        _cuda_driver.compile_cubin(RTC_SOURCES["axpy_bf16"],
                                   ["--gpu-architecture=sm_90a"])
        builtin_bf16 = True
    except mx.MXNetError:
        builtin_bf16 = False
    bad = [c for c in cases if not c["ok"]]
    worst = {}
    for c in cases:
        worst[c["kernel"]] = max(worst.get(c["kernel"], 0.0), c["err_ratio"])
    emit({"phase": "rtc_kernels", "ok": not bad and all(refused.values()),
          "cases": len(cases), "worst_err_ratio": worst,
          "compile_seconds": compile_s, "refusals": refused, "failed": bad,
          "nvrtc_version": _cuda_driver.nvrtc_version(),
          "nvrtc_builtin_cuda_bf16_h": builtin_bf16,
          "nvrtc_log": {k: m.log for k, m in mods.items() if m.log.strip()}})
    check(not bad, f"rtc kernels disagree with their PallasModule twins: {bad}")
    check(all(refused.values()), f"rtc launch checks: {refused}")
    return ({name: kern[name] for name in SWIGLU_SIGNATURES},
            {name: twin[name] for name in SWIGLU_SIGNATURES})


def _rtc_refusals(mx, nd, kern, gpu):
    """Launches the card would refuse, and a CPU context, raise before
    anything runs."""
    x, o = nd.zeros((8,), ctx=gpu), nd.zeros((8,), ctx=gpu)
    attempts = {
        "threads_over_1024": lambda: kern["scaled"].launch(
            [x, 1.0, o, 8], gpu, (1, 1, 1), (2048, 1, 1)),
        "shared_mem_over_227kb": lambda: kern["reverse_rows"].launch(
            [x, o, 8], gpu, (1, 1, 1), (32, 1, 1), 232449),
        "cpu_context": lambda: kern["scaled"].launch(
            [x, 1.0, o, 8], mx.cpu(), (1, 1, 1), (32, 1, 1)),
        "wrong_dtype": lambda: kern["inc"].launch(
            [x, o, 8], gpu, (1, 1, 1), (32, 1, 1)),
    }
    result = {}
    for name, fn in attempts.items():
        before = kern["scaled"].launches + kern["reverse_rows"].launches
        try:
            fn()
            result[name] = False
        except (ValueError, TypeError, mx.MXNetError):
            result[name] = (kern["scaled"].launches
                            + kern["reverse_rows"].launches) == before
    return result


def _swiglu_function(mx, nd, kernels):
    """SwiGLU as an mx.autograd.Function over the two rtc kernels: one
    forward and one backward launch per call."""
    fwd, bwd = kernels["swiglu_fwd"], kernels["swiglu_bwd"]

    def grid(n):
        return (max(1, -(-n // (8 * SWIGLU_BLOCK))), 1, 1)

    class SwiGLU(mx.autograd.Function):
        def forward(self, g, u):
            h = nd.empty(g.shape, ctx=g.context, dtype="bfloat16")
            fwd.launch([g, u, h, g.size], g.context, grid(g.size),
                       (SWIGLU_BLOCK, 1, 1))
            self.save_for_backward(g, u)
            return h

        def backward(self, dh):
            g, u = self.saved_tensors
            dg = nd.empty(g.shape, ctx=g.context, dtype="bfloat16")
            du = nd.empty(g.shape, ctx=g.context, dtype="bfloat16")
            bwd.launch([g, u, dh, dg, du, g.size], g.context, grid(g.size),
                       (SWIGLU_BLOCK, 1, 1))
            return dg, du

    return SwiGLU


def swiglu_bound_ms(name, n):
    """Bytes: forward reads g, u and writes h, backward reads g, u, dh and
    writes dg, du (2 bytes each); operations at the fp32 CUDA-core peak."""
    nbytes = 2.0 * n * (3 if name == "swiglu_fwd" else 5)
    t_ops = SWIGLU_FLOPS[name] * n / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_rtc_ffn(torch, seed, kernels, twins):
    """One imperative training step of llama_7b's FFN on NDArrays, bf16:
    g = x w1^T, u = x w3^T, h = SwiGLU(g, u) (the rtc kernels), y = h w2^T,
    loss = mean(y^2), backward; held against the same step in plain torch
    autograd, then 3 + 10 timed steps with the launch counts gated."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    torch.cuda.empty_cache()
    gpu = mx.gpu(0)
    t_rows, units, hidden = FFN["batch"] * FFN["seq"], FFN["units"], FFN["hidden"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    x_t = torch.randn(t_rows, units, generator=gen, device="cuda").bfloat16()
    w_t = [(torch.randn(o, i, generator=gen, device="cuda") / math.sqrt(i))
           .bfloat16() for o, i in ((hidden, units), (hidden, units),
                                    (units, hidden))]
    x = nd.array(x_t, ctx=gpu)
    w1, w3, w2 = (nd.array(w, ctx=gpu) for w in w_t)
    for w in (w1, w3, w2):
        w.attach_grad()
    swiglu = _swiglu_function(mx, nd, kernels)

    def step():
        with autograd.record():
            g = nd.dot(x, w1, transpose_b=True)
            u = nd.dot(x, w3, transpose_b=True)
            h = swiglu()(g, u)
            y = nd.dot(h, w2, transpose_b=True)
            loss = (y * y).mean()
        loss.backward()
        return loss

    # the same step in plain torch autograd
    ref_w = [w.clone().requires_grad_(True) for w in w_t]
    g_r = x_t @ ref_w[0].t()
    u_r = x_t @ ref_w[1].t()
    y_r = (g_r * torch.sigmoid(g_r) * u_r) @ ref_w[2].t()
    loss_r = (y_r * y_r).mean()
    loss_r.backward()
    del g_r, u_r, y_r

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    loss = step()
    first = float(loss)
    grads = {n: w.grad._data.float() for n, w in
             (("w1", w1), ("w3", w3), ("w2", w2))}
    rel = {n: ((g - r.grad.float()).norm() / r.grad.float().norm()).item()
           for (n, g), r in zip(grads.items(), ref_w)}
    ref_loss = loss_r.item()
    loss_rel = abs(first - ref_loss) / abs(ref_loss)
    del grads
    for _ in range(FFN["warmup"] - 1):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FFN["steps"]):
        loss = step()
    last = float(loss)
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    steps = FFN["warmup"] + FFN["steps"]
    out = {"phase": "rtc_ffn", "model": "llama_7b FFN", "dtype": "bfloat16",
           "tokens": t_rows, "units": units, "hidden": hidden,
           "steps": steps, "timed_steps": FFN["steps"],
           "step_ms": 1e3 * wall / FFN["steps"],
           "tokens_per_s": t_rows * FFN["steps"] / wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss": first, "ref_loss": ref_loss, "last_loss": last,
           "loss_rel_diff": loss_rel, "grad_rel_norm_diff": rel,
           "tolerance": {k: FFN[k] for k in ("loss_rel", "grad_rel_norm")},
           "launches": launches}
    out["gates"] = {
        "finite": math.isfinite(first) and math.isfinite(last),
        "loss": loss_rel <= FFN["loss_rel"],
        "grads": all(r <= FFN["grad_rel_norm"] for r in rel.values()),
        "one_launch_each_per_step": all(v == steps for v in launches.values()),
    }
    out["ok"] = all(out["gates"].values())

    # kernel timings at this shape, beside the library's SwiGLU
    n = t_rows * hidden
    g_t = torch.randn(t_rows, hidden, generator=gen, device="cuda").bfloat16()
    u_t = torch.randn(t_rows, hidden, generator=gen, device="cuda").bfloat16()
    dh_t = torch.randn(t_rows, hidden, generator=gen, device="cuda").bfloat16()
    g, u, dh = (nd.array(t, ctx=gpu) for t in (g_t, u_t, dh_t))
    h = nd.empty((t_rows, hidden), ctx=gpu, dtype="bfloat16")
    dg = nd.empty((t_rows, hidden), ctx=gpu, dtype="bfloat16")
    du = nd.empty((t_rows, hidden), ctx=gpu, dtype="bfloat16")
    grid = (-(-n // (8 * SWIGLU_BLOCK)), 1, 1)
    block = (SWIGLU_BLOCK, 1, 1)
    gl, ul = (t.clone().requires_grad_(True) for t in (g_t, u_t))
    hl = torch.nn.functional.silu(gl) * ul
    # the plain version: the twins' own Python source (what PallasModule
    # runs on the CPU), called here on the card tensors as whole-array refs
    plain = {"torch": torch}
    exec(TWIN_SOURCE, plain)  # noqa: S102 — the twins, defined above
    h32, dg32, du32 = (torch.empty(t_rows, hidden, device="cuda")
                       for _ in range(3))
    fns = {
        "swiglu_fwd": (lambda: kernels["swiglu_fwd"].launch(
            [g, u, h, n], gpu, grid, block),
            lambda: plain["swiglu_fwd"](g_t, u_t, h32),
            lambda: torch.nn.functional.silu(g_t) * u_t),
        "swiglu_bwd": (lambda: kernels["swiglu_bwd"].launch(
            [g, u, dh, dg, du, n], gpu, grid, block),
            lambda: plain["swiglu_bwd"](g_t, u_t, dh_t, dg32, du32),
            lambda: torch.autograd.grad(hl, (gl, ul), dh_t,
                                        retain_graph=True)),
    }
    timing = {}
    for name, (kern_fn, plain_fn, lib_fn) in fns.items():
        runs = {"kernel": [], "plain": [], "library": []}
        for order in (("kernel", "plain", "library"),
                      ("library", "plain", "kernel")):
            for key in order:
                fn = {"kernel": kern_fn, "plain": plain_fn,
                      "library": lib_fn}[key]
                runs[key].append(cuda_ms(torch, fn, iters=20))
        bound, bound_by = swiglu_bound_ms(name, n)
        timing[name] = {"ms": min(runs["kernel"]),
                        "plain_ms": min(runs["plain"]),
                        "library_ms": min(runs["library"]), "bound_ms": bound,
                        "bound_by": bound_by, "runs_ms": runs,
                        "launches": launches[name]}
    # each kernel against its plain version (the PallasModule twin, on CPU
    # copies) at this shape, gated as in phase_rtc_kernels; and how far the
    # library's bf16 step-by-step SwiGLU lies from it (reported)
    terms = {"swiglu_fwd": lambda a: (a[0]._data.float()
                                      * a[1]._data.float()).abs(),
             "swiglu_bwd": lambda a: ((a[0]._data.float().abs() + 1.0) ** 2
                                      * (a[1]._data.float()
                                         * a[2]._data.float()).abs()
                                      + (a[0]._data.float()
                                         * a[2]._data.float()).abs())}
    for name, args in (("swiglu_fwd", [g, u, h, n]),
                       ("swiglu_bwd", [g, u, dh, dg, du, n])):
        case = _rtc_case(torch, mx, name, kernels[name], twins[name], args,
                         grid, block, (1, 1, 1), (0, 0, 0), "bf16",
                         terms=terms[name])
        timing[name].update(max_abs_err=case["max_abs_err"],
                            err_ratio=case["err_ratio"])
        out["gates"][f"{name}_vs_plain"] = case["ok"]
    dgl, dul = torch.autograd.grad(hl, (gl, ul), dh_t)
    timing["swiglu_fwd"]["library_max_abs_diff"] = (
        h._data.float() - hl.detach().float()).abs().max().item()
    timing["swiglu_bwd"]["library_max_abs_diff"] = max(
        (dg._data.float() - dgl.float()).abs().max().item(),
        (du._data.float() - dul.float()).abs().max().item())
    out["ok"] = all(out["gates"].values())
    out["kernel_timing"] = timing
    emit(out)
    check(out["ok"], f"rtc FFN step failed: {out['gates']}")
    return timing


# ---------------------------------------------------------------------------
# slice 6: the BERT-base pretraining step (bench.py:158-192)
# ---------------------------------------------------------------------------
# bench.py's full BERT run: BERT-base (12 layers, 768 units, 3072 hidden, 12
# heads, vocab 30522, max_length 512, dropout 0.1), seq 128, batch 64
# (BENCH_BERT_BATCH), Adam lr 1e-4, MLM loss only, token_types zeros.  Its
# attention runs fp32 in both runs: under amp.convert_block LayerNorm's fp32
# gamma promotes every activation from embed_ln on, so both take the fp32
# tensor-core flash kernel (D = 64), 12 launches per step.  BERT_FLASH is
# that call's [B, H, S, D].
BERT = dict(vocab_size=30522, max_length=512, batch=64, seq=128, lr=1e-4,
            warmup=3, steps=10)
BERT_FLASH = (64, 12, 128, 64)
# The small config of bench.py:168-170, dropout 0: two steps on the card
# against the same two steps on the CPU from the same weights, fp32, TF32
# off.  Bounds as tests/test_torch_bert.py states them: losses within 1e-5
# of themselves; parameters within 2·lr per step, absolute (Adam's first
# step moves a weight by ±lr whatever its gradient's size, so a near-zero
# gradient rounded to the other sign costs 2·lr); the gradient of the first
# layer's q, k and v within 1e-4 of its largest |value|.
BERT_SMALL = dict(vocab_size=1000, units=64, hidden_size=128, num_layers=2,
                  num_heads=4, max_length=32, dropout=0.0)
BERT_PARITY = dict(batch=8, seq=32, steps=2, loss_rel=1e-5, grad_rel=1e-4)
# The Function's backward against plain autograd through the dense
# attention_reference: within 1e-4 of each gradient's largest |value| (the
# kernel's O, held to 1e-4, enters delta = sum(dO * O)).
BERT_BWD_REL = 1e-4


def phase_bert_flash(torch, seed):
    """The fp32 tensor-core flash forward at BERT-base's shape, non-causal,
    against its plain version; the autograd Function's backward on the card
    against plain autograd of attention_reference; then timed in turns
    beside the CUDA-core kernel, the plain version, SDPA (fp32) and
    ``flash_attention`` on the packed [B, S, H*D] tensors the model passes
    (the kernel plus the wrapper's copies between the two layouts)."""
    from mxnet_tpu_torch.ops import attention as A
    b, h, s, d = BERT_FLASH
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    q, k, v, do = (torch.randn(b * h, s, d, generator=gen, device="cuda")
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    variant = A._flash_variant(torch.float32, d)
    before = A.flash_fwd_tf32_launches
    o, lse = A.flash_fwd(q, k, v, False, scale)
    ran_tf32 = A.flash_fwd_tf32_launches - before == 1
    ro, rl = A._flash_forward_plain(q, k, v, False, scale)
    o_err = (o - ro).abs().max().item()
    lse_err = (lse - rl).abs().max().item()
    packed = [t.view(b, h, s, d).transpose(1, 2).reshape(b, s, h * d)
              for t in (q, k, v)]
    wrapped = A.flash_attention(*packed, num_heads=h)
    wrapper_diff = (wrapped.view(b, s, h, d).transpose(1, 2).reshape(
        b * h, s, d) - o).abs().max().item()
    del o, lse, ro, rl, wrapped
    leaves = [t.view(b, h, s, d).clone().requires_grad_() for t in (q, k, v)]
    out = A.flash_attention(*leaves)
    grad_fn = type(out.grad_fn).__name__
    out.backward(do.view(b, h, s, d))
    plain = [t.view(b, h, s, d).clone().requires_grad_() for t in (q, k, v)]
    A.attention_reference(*plain).backward(do.view(b, h, s, d))
    bwd = {f"d{n}": ((x.grad - y.grad).abs().max()
                     / y.grad.abs().max()).item()
           for n, x, y in zip("qkv", leaves, plain)}
    del leaves, plain, out
    q4, k4, v4 = (t.view(b, h, s, d) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    best, runs = _in_turns(torch, {
        "kernel": lambda: A.flash_fwd(q, k, v, False, scale),
        "simt_kernel": lambda: A._flash_fwd_cuda(q, k, v, False, scale,
                                                 variant="simt"),
        "plain": lambda: A._flash_forward_plain(q, k, v, False, scale),
        "library": lambda: sdpa(q4, k4, v4, scale=scale),
        "wrapper": lambda: A.flash_attention(*packed, num_heads=h)})
    # the function's bound (bytes, with the products at the TF32 peak)
    # and the kernel's own ceiling for its three TF32 products
    bound, bound_by = flash_bound_ms(b, h, s, d, False, 4, ops_factor=3,
                                     peak=PEAK_TF32_FLOPS)
    tf32x3_ops_ms = 1e3 * 4.0 * b * h * s * s * d * 3 / PEAK_TF32_FLOPS
    tol = TOL["float32"]
    out = {"phase": "bert_flash", "shape": [b, h, s, d], "dtype": "float32",
           "causal": False, "variant": variant, "ran_tf32": ran_tf32,
           "o_err": o_err, "lse_err": lse_err, "grad_fn": grad_fn,
           "bwd_rel_err": bwd, "tolerance": {**tol, "bwd_rel": BERT_BWD_REL},
           "max_abs_err": max(o_err, lse_err), "ms": best["kernel"],
           "simt_ms": best["simt_kernel"], "plain_ms": best["plain"],
           "library_ms": best["library"], "wrapper_ms": best["wrapper"],
           "wrapper_over_kernel_ms": best["wrapper"] - best["kernel"],
           "wrapper_max_abs_diff": wrapper_diff,
           "bound_ms": bound, "bound_by": bound_by,
           "tf32x3_ops_ms": tf32x3_ops_ms,
           "cuda_core_ops_ms": flash_bound_ms(b, h, s, d, False, 4)[0],
           "runs_ms": runs, "tf32": _tf32(torch)}
    out["ok"] = (variant == "tf32" and ran_tf32 and o_err <= tol["o"]
                 and lse_err <= tol["lse"] and wrapper_diff == 0.0
                 and grad_fn == "_FlashFunctionBackward"
                 and max(bwd.values()) <= BERT_BWD_REL)
    emit(out)
    check(out["ok"], "flash_fwd at BERT's shape disagrees with its plain "
          "version, or its backward with plain autograd")
    del q, k, v, do, q4, k4, v4, packed
    return out


def _bert_loss(vocab):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    ce = SoftmaxCrossEntropyLoss()

    def mlm_loss(out, y):
        mlm, _nsp = out
        return ce(mlm.reshape(-1, vocab), y.reshape(-1))
    return mlm_loss


def _bert_step(net, vocab, batch):
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.executor import CompiledTrainStep
    return CompiledTrainStep(net, _bert_loss(vocab),
                             optimizer.create("adam", learning_rate=BERT["lr"]),
                             batch_size=batch)


def _bert_batch(torch, seed, vocab, batch, seq, device):
    """Random tokens and labels from ``seed``, token types zeros."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, vocab, (batch, seq), generator=gen,
                           device=device)
    labels = torch.randint(0, vocab, (batch, seq), generator=gen,
                           device=device).float()
    return (tokens, torch.zeros_like(tokens)), labels


def phase_bert_parity(torch, seed):
    """Two steps of the small BERT on the card (flash kernel) against the
    same two steps on the CPU (plain versions) from the same weights, fp32:
    the losses, the first layer's q, k and v gradients of step 1 (C2: they
    exist on the card) and every parameter after step 2."""
    from mxnet_tpu_torch.gluon.model_zoo.language import BERTForPretraining
    from mxnet_tpu_torch.initializer import initialize
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.random import generator
    nets, losses, qkv_grads = {}, {}, {}
    src = initialize(BERTForPretraining(device="cpu", **BERT_SMALL),
                     generator(seed, "cpu")).state_dict()
    x, y = _bert_batch(torch, seed + 3, BERT_SMALL["vocab_size"],
                       BERT_PARITY["batch"], BERT_PARITY["seq"], "cpu")
    launches = {}
    for dev in ("cuda", "cpu"):
        net = BERTForPretraining(device=dev, **BERT_SMALL)
        net.load_state_dict(src)
        grads = []

        def keep(mod, inp, out, grads=grads):
            if out.requires_grad and not grads:
                out.register_hook(lambda g: grads.append(g.detach().cpu()))
        hook = net.bert.encoder.cells[0].attention.qkv.register_forward_hook(
            keep)
        step = _bert_step(net, BERT_SMALL["vocab_size"], BERT_PARITY["batch"])
        A.flash_fwd_launches = A.flash_fwd_wgmma_launches = 0
        A.flash_fwd_tf32_launches = 0
        losses[dev] = [step(tuple(t.to(dev) for t in x), y.to(dev)).item()
                       for _ in range(BERT_PARITY["steps"])]
        launches[dev] = (A.flash_fwd_launches, A.flash_fwd_wgmma_launches,
                         A.flash_fwd_tf32_launches)
        hook.remove()
        nets[dev], qkv_grads[dev] = net, grads
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["cuda"], losses["cpu"]))
    card, host = qkv_grads["cuda"], qkv_grads["cpu"]
    qkv_rel = {}
    if card and host:
        for name, g, r in zip("qkv", card[0].chunk(3, -1),
                              host[0].chunk(3, -1)):
            qkv_rel[name] = ((g - r).abs().max() / r.abs().max()).item()
    qkv_present = len(qkv_rel) == 3 and all(
        c.abs().max().item() > 0 for c in card[0].chunk(3, -1))
    atol = 2 * BERT["lr"] * BERT_PARITY["steps"]
    worst = max((nets["cuda"].state_dict()[k].cpu() - v).abs().max().item()
                for k, v in nets["cpu"].state_dict().items())
    want = BERT_SMALL["num_layers"] * BERT_PARITY["steps"]
    out = {"phase": "bert_parity", "config": BERT_SMALL, **BERT_PARITY,
           "losses": losses, "loss_rel_diff": loss_rel,
           "qkv_grad_rel_diff": qkv_rel, "worst_param_abs_diff": worst,
           "param_atol": atol, "flash_launches": launches["cuda"],
           "tf32": _tf32(torch)}
    out["gates"] = {
        "losses": all(math.isfinite(v) for v in losses["cuda"])
        and loss_rel <= BERT_PARITY["loss_rel"],
        "qkv_grads_on_card": qkv_present
        and max(qkv_rel.values()) <= BERT_PARITY["grad_rel"],
        "params": worst <= atol,
        "launches": launches["cuda"] == (want, 0, want)
        and launches["cpu"] == (0, 0, 0)}
    out["ok"] = all(out["gates"].values())
    emit(out)
    check(out["ok"], f"small BERT on the card disagrees with the CPU: "
          f"{out['gates']}")


def _bert_base(torch, seed, dtype):
    """Full-width BERT-base on the card as bench.py builds it (weights from
    ``seed``, dropout 0.1 drawing from ``seed + 1``, converted to bf16
    with amp.convert_block unless ``dtype`` is float32), its Adam step and
    its batch: ``(net, step, x, y)``."""
    from mxnet_tpu_torch.contrib.amp import convert_block
    from mxnet_tpu_torch.gluon.model_zoo.language import BERTForPretraining
    from mxnet_tpu_torch.initializer import initialize
    from mxnet_tpu_torch.random import generator
    vocab = BERT["vocab_size"]
    net = BERTForPretraining(vocab_size=vocab, max_length=BERT["max_length"],
                             generator=generator(seed + 1, "cuda"),
                             device="cuda")
    initialize(net, generator(seed, "cuda"))
    if dtype != "float32":
        convert_block(net, dtype)
    step = _bert_step(net, vocab, BERT["batch"])
    x, y = _bert_batch(torch, seed + 7, vocab, BERT["batch"], BERT["seq"],
                       "cuda")
    return net, step, x, y


def _bert_run(torch, seed, dtype):
    """``BERT["warmup"]`` + ``BERT["steps"]`` steps of full-width
    BERT-base as bench.py builds it, with the flash launch counts set to 0
    just before and read just after; samples per second from the host
    clock over the timed steps, ending in a ``loss.item()``."""
    from mxnet_tpu_torch.ops import attention as A
    torch.cuda.empty_cache()
    net, step, x, y = _bert_base(torch, seed, dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.flash_fwd_launches = A.flash_fwd_wgmma_launches = 0
    A.flash_fwd_tf32_launches = 0
    first = step(x, y).item()
    for _ in range(BERT["warmup"] - 1):
        step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BERT["steps"]):
        loss = step(x, y)
    last = loss.item()
    wall = time.perf_counter() - t0
    launches, wgmma = A.flash_fwd_launches, A.flash_fwd_wgmma_launches
    tf32 = A.flash_fwd_tf32_launches
    steps = BERT["warmup"] + BERT["steps"]
    layers = len(net.bert.encoder.cells)
    out = {"run": f"bert_{dtype}", "dtype": dtype, "batch": BERT["batch"],
           "seq": BERT["seq"], "layers": layers, "steps": steps,
           "timed_steps": BERT["steps"],
           "samples_per_sec": BERT["batch"] * BERT["steps"] / wall,
           "step_ms": 1e3 * wall / BERT["steps"], "first_loss": first,
           "last_loss": last,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "tf32": _tf32(torch), "flash_fwd_launches": launches,
           "flash_fwd_tf32_launches": tf32,
           "flash_fwd_wgmma_launches": wgmma}
    out["gates"] = {"losses_finite": math.isfinite(first)
                    and math.isfinite(last),
                    "launches": launches == tf32 == layers * steps == 156
                    and wgmma == 0}
    out["ok"] = all(out["gates"].values())
    emit(out)
    check(out["ok"], f"BERT run {dtype} failed: {out['gates']}")
    del net, step, x, y
    return out


def phase_bert_training(torch, seed):
    """Full-width BERT-base pretraining steps, fp32 then bf16 through
    amp.convert_block; TF32 off.  Returns the fp32 tensor-core flash
    kernel's launches in both runs."""
    runs = [_bert_run(torch, seed, "float32"),
            _bert_run(torch, seed, "bfloat16")]
    emit({"phase": "bert_training", "ok": True,
          "bf16_over_fp32_step_ms": runs[1]["step_ms"] / runs[0]["step_ms"]})
    return sum(r["flash_fwd_tf32_launches"] for r in runs)


def _rtc_kernel_line(name, timing):
    """A row of the kernels line for an rtc kernel: CUDA C compiled at run
    time by NVRTC through mx.rtc.CudaModule; its source is SWIGLU_SOURCE in
    this script (user code)."""
    t = timing[name]
    return {"name": f"rtc_{name}", "route": "cuda", "compiler": "nvrtc",
            "source": "chip_smoke.py", "replaces": "mxnet_tpu/rtc.py:88",
            "launches": t["launches"], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


def _kernel_line(name, source, replaces, launches, timing):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"]}


PHASES = ("build", "device", "flash", "flash_timing", "fused",
          "fused_timing", "model_parity", "serving",
          "resnet_parity", "training", "gluon_training", "rtc_kernels",
          "rtc_ffn", "bert_flash", "bert_parity", "bert_training")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", default=",".join(PHASES),
                        help="comma-separated phases to run (default: all)")
    args = parser.parse_args(argv)
    only = set(args.only.split(","))
    check(only <= set(PHASES), f"unknown phases {sorted(only - set(PHASES))}")
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import mxnet_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SmokeFailure(f"the port is not beside this script ({e})")
    lines = []
    if "build" in only:
        phase_build()
    phase_device(torch)
    if "flash" in only:
        phase_kernels(torch, args.seed)
    if "flash_timing" in only:
        timing = phase_flash_timing(torch, args.seed)
    if "fused" in only:
        phase_fused_kernel(torch, args.seed)
    if "fused_timing" in only:
        fused = phase_fused_timing(torch, args.seed)
    if "model_parity" in only:
        phase_model_parity(torch, args.seed)
    if "serving" in only:
        launches = phase_serving(torch, args.seed)
        if "flash_timing" in only:
            lines.append(_kernel_line(
                "flash_fwd", "mxnet_tpu_torch/csrc/flash_fwd_wgmma.cu",
                "mxnet_tpu/ops/attention.py:51", launches, timing))
    if "resnet_parity" in only:
        phase_resnet_parity(torch, args.seed)
    by_path = {}
    if "training" in only:
        by_path["training"] = phase_training(torch, args.seed)
    if "gluon_training" in only:
        by_path["gluon_training"] = phase_gluon_training(torch, args.seed)
    if by_path and "fused_timing" in only:
        # launches: this slice's path (the Gluon loop) when it ran
        line = _kernel_line(
            "fused_conv_bn_stats",
            "mxnet_tpu_torch/csrc/fused_conv_bn_wgmma.cu",
            "mxnet_tpu/ops/fused_conv_bn.py:48",
            by_path.get("gluon_training", by_path.get("training")), fused)
        line["launches_by_path"] = by_path
        lines.append(line)
    if "rtc_kernels" in only or "rtc_ffn" in only:
        kernels, twins = phase_rtc_kernels(torch, args.seed)
    if "rtc_ffn" in only:
        ffn = phase_rtc_ffn(torch, args.seed, kernels, twins)
        lines += [_rtc_kernel_line(name, ffn) for name in SWIGLU_SIGNATURES]
    if "bert_flash" in only:
        bert_timing = phase_bert_flash(torch, args.seed)
    if "bert_parity" in only:
        phase_bert_parity(torch, args.seed)
    if "bert_training" in only:
        launches = phase_bert_training(torch, args.seed)
        if "bert_flash" in only:
            line = _kernel_line("flash_fwd_bert",
                                "mxnet_tpu_torch/csrc/flash_fwd_tf32.cu",
                                "mxnet_tpu/ops/attention.py:51", launches,
                                bert_timing)
            line["shape"], line["dtype"] = BERT_FLASH, "float32"
            line["simt_ms"] = bert_timing["simt_ms"]
            lines.append(line)
    emit({"kernels": lines})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
