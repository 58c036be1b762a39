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
- export -> import -> serve (slice 9): full-width BERT-base (fp32,
  random weights) served from its block through ``ModelServer.register``
  under 24 concurrent requests, every answer held against a solo forward
  on the card and one against the CPU, the fp32 tensor-core flash kernel's
  launches gated at 12 per forward (``serving_bert``); full-width
  resnet50_v1 exported, rebuilt with ``InferenceEngine.from_export`` and
  served the same way (``serving_resnet_export``).
- the symbolic training loop (slice 10): a BERT-base encoder classifier
  (the port's Gluon blocks called on ``mx.sym.var``, fp32) trained
  through ``Module.fit`` over the ``'device'`` kvstore for 2 epochs, then
  scored and predicted, the fp32 tensor-core flash kernel's launches
  gated at 12 per forward; epoch 0 again with the ``'local'`` and no
  kvstore, a resumed run from a checkpoint with its optimizer states,
  3 batches against ``gluon.Trainer`` on the same block, and one
  forward_backward on the card against the CPU (``module_fit``).
- the distributed kvstore (slice 11): ``tools/launch.py -n 2`` starts
  two ranks of this script (``--dist-worker``) on the one card over gloo
  (NCCL refuses two ranks on one card), each training ``module_fit``'s
  encoder classifier on ``mx.gpu(0)``: ``Module.fit`` over ``dist_sync``
  on its half of the rows, the ranks' weights held equal bit for bit
  after every step; the same batches on both ranks against a one-process
  ``'device'`` run with ``rescale_grad`` doubled, bit for bit; then
  ``gluon.Trainer`` over ``dist_sync`` with the bucketed push and with
  one collective per key (``dist_training``).
- hybridize() and the Executor as CUDA graphs (slice 12): a small
  hybridized block with Dropout and BatchNorm, a bound symbol and an
  engine over the block hold the graphs' semantics against eager runs
  (fresh masks per replay, moving statistics, held outputs, set_data and
  a rebinding cast, gradients; ``graph_semantics``); the serving phases
  hold every rung's graph against the eager block and print the execute
  stage per rung, eager against graph, the device's busy share and the
  graph pool; ``gluon_training`` replays the resnet50_v1 record entry and
  holds its moving statistics against the un-hybridized copy;
  ``module_fit`` and ``dist_training`` run the Executor's graphs, with as
  many captures as misses.
- the training step as one CUDA graph (slice 13): a small Dense,
  BatchNorm and Dropout net through ``CompiledTrainStep``'s graph beside
  an eager twin under a learning-rate schedule and Adam (each replay its
  own lr and step count, fresh masks, moving statistics, the optimizer's
  counts, one capture per signature, a rebinding cast, K = 4 steps of
  ``MultiStepTrainStep`` against 4 single steps, ``remat``;
  ``train_step_graphs``); ``training`` and ``bert_training`` run every
  resnet50_v1 and BERT-base configuration through the graph, hold its
  first 2 steps against the eager twin, and print step ms, busy share and
  peak memory eager against graph.

Each phase prints one JSON line; any failed phase ends the run with a
non-zero exit code.  ``--only a,b`` runs only the named phases (build,
device, graph_semantics, train_step_graphs, flash, flash_timing, fused,
fused_timing, model_parity, serving,
resnet_parity, training, gluon_training, serving_bert,
serving_resnet_export, module_fit, dist_training, rtc_kernels, rtc_ffn,
bert_flash, bert_parity, bert_training), for a short call while a kernel
is brought up; ``--only build,gluon_training`` runs just the Gluon loop,
``--only build,train_step_graphs`` the training step's graph semantics
(``--only build,train_step_graphs,training,bert_training`` this slice
with its full-width runs), ``--only
build,serving_bert,serving_resnet_export`` the serving phases,
``--only build,module_fit`` the Module loop and ``--only
build,dist_training`` the two-rank job.  The line before the last is the kernel table; the
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
import gc
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


def _step_tensors(step):
    """A CompiledTrainStep's tensors by name: the net's state dict and
    every optimizer state."""
    from mxnet_tpu_torch.executor import _leaves
    out = dict(step._net.state_dict())
    for i, state in enumerate(step._states):
        for j, t in enumerate(_leaves(state)):
            out[f"opt{i}.{j}"] = t
    return out


def _snapshot(step):
    """CPU copies of :func:`_step_tensors`."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in _step_tensors(step).items()}


def _restore(torch, step, snap, count):
    """Write ``snap`` back into the step's tensors (in place) and set its
    step count to ``count``."""
    with torch.no_grad():
        for k, t in _step_tensors(step).items():
            t.copy_(snap[k])
    step._num_update = count


def _gap(torch, got, ref):
    """Tensors equal bit for bit, and the worst ``max|got - ref| /
    max|ref|`` over the others, with its name."""
    equal, worst = 0, (0.0, "")
    for name, r in ref.items():
        g = got[name]
        if torch.equal(g, r):
            equal += 1
            continue
        d = (g.float() - r.float()).abs().max().item()
        m = r.float().abs().max().item()
        worst = max(worst, (d / m if m else math.inf, name))
    return {"bitwise_equal": equal, "tensors": len(ref), "worst_rel": worst}


# Slice 13: CompiledTrainStep is one CUDA graph per signature on the card.
# Each training configuration runs four times, one after the other so that
# no two share the card's memory.  First the parity pair, with
# torch.use_deterministic_algorithms on (cuDNN's deterministic
# algorithms: with the defaults two eager runs of the fused resnet50_v1
# step on an H100 80GB HBM3 at 700 W already differ by 1.05e-4 of a
# momentum's largest |value|): the
# graph's first 2 steps (its first step is the signature's eager call,
# then the capture, then a replay), and a twin built the same way through
# the step's eager path (``_eager``), each of its 2 steps from the state
# the graph's step started from.  The twin must give the graph's state
# (parameters, buffers, optimizer states) bit for bit, else within
# SERVE["card_rel"] of each tensor's largest |value|, where cuBLAS picks
# another algorithm under capture.  Then the timed pair with the default
# algorithms: warmup + steps through the graph with the launch counters
# set to 0 just before and read just after, and the same steps eagerly;
# each then traced for its busy share over STEP_GRAPH["busy_steps"] more.
STEP_GRAPH = dict(parity_steps=2, busy_steps=5)


def _free(torch):
    """Collect what the last run left (a hybridized block and its CachedOp
    refer to each other) and give the cached memory back to the card, so
    that the next run's peak is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def _parity_pair(torch, build):
    """The graph's first STEP_GRAPH["parity_steps"] steps against the
    eager twin's, deterministic algorithms on."""
    n_par = STEP_GRAPH["parity_steps"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _free(torch)
        net, step, xs, y = build()
        snaps, losses = [], []
        for _ in range(n_par):
            losses.append(step(xs, y).item())
            snaps.append(_snapshot(step))
        del net, step, xs, y
        _free(torch)
        net, twin, xs, y = build()
        parity = []
        for k in range(n_par):
            if k:
                _restore(torch, twin, snaps[k - 1], k)
            eager_loss = twin._eager(xs, y).item()
            parity.append({"step": k + 1, "loss_graph": losses[k],
                           "loss_eager": eager_loss,
                           **_gap(torch, _snapshot(twin), snaps[k])})
        del net, twin, xs, y
    finally:
        torch.use_deterministic_algorithms(False)
        _free(torch)
    return parity


def _timed(torch, fn, warmup, steps):
    """``warmup`` + ``steps`` calls of ``fn``; ms per timed step, the first
    and last losses."""
    first = fn().item()
    for _ in range(warmup - 1):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = fn()
    last = loss.item()
    wall = time.perf_counter() - t0
    return {"step_ms": 1e3 * wall / steps, "first_loss": first,
            "last_loss": last}


def _graph_and_eager(torch, build, warmup, steps, reset, read):
    """``build()`` -> ``(net, step, xs, y)``.  Returns ``(graph, eager,
    parity, launches)``: ``launches`` is ``read()`` after the graph's
    ``warmup`` + ``steps`` steps, counted from ``reset()`` just before."""
    parity = _parity_pair(torch, build)
    net, step, xs, y = build()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    graph = _timed(torch, lambda: step(xs, y), warmup, steps)
    launches = read()
    graph.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 pool_gb=_pool_bytes(torch, step._pool) / 1e9,
                 misses=step._misses, captures=step._captures,
                 replays=step._replays)
    graph["busy"] = _busy_share(torch, lambda: step(xs, y),
                                STEP_GRAPH["busy_steps"])
    del net, step, xs, y
    _free(torch)

    net, twin, xs, y = build()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager = _timed(torch, lambda: twin._eager(xs, y), warmup, steps)
    eager["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    eager["busy"] = _busy_share(torch, lambda: twin._eager(xs, y),
                                STEP_GRAPH["busy_steps"])
    del net, twin, xs, y
    _free(torch)
    return graph, eager, parity, launches


def _graph_gates(graph, parity, steps):
    """The gates every configuration holds through the graph: one miss,
    one capture, a replay for every later step, the first 2 steps as the
    eager twin's."""
    return {"one_capture": graph["misses"] == graph["captures"] == 1
            and graph["replays"] == steps - 1,
            "parity_with_eager": all(
                math.isfinite(p["loss_graph"])
                and p["worst_rel"][0] <= SERVE["card_rel"] for p in parity)}


def _train_run(torch, seed, name, fused, dtype):
    """Full-width resnet50_v1 through CompiledTrainStep's graph and its
    eager twin (``_graph_and_eager``), ``TRAIN["warmup"]`` +
    ``TRAIN["steps"]`` steps each; images per second from the host clock
    over the timed steps, ending in a ``loss.item()``."""
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    bf16 = dtype == "bfloat16"

    def build():
        net = _resnet50(torch, fused, seed, dtype)
        x, y = _images(torch, seed + 7, TRAIN["batch"], TRAIN["px"],
                       TRAIN["classes"], torch.bfloat16 if bf16 else None)
        return net, _train_step(net, TRAIN["batch"]), (x,), y

    def reset():
        FC.fused_conv_bn_launches = FC.fused_conv_bn_wgmma_launches = 0
        A.flash_fwd_launches = 0

    def read():
        return {"fused_conv_bn_launches": FC.fused_conv_bn_launches,
                "fused_conv_bn_wgmma_launches":
                    FC.fused_conv_bn_wgmma_launches,
                "flash_fwd_launches": A.flash_fwd_launches}

    graph, eager, parity, launches = _graph_and_eager(
        torch, build, TRAIN["warmup"], TRAIN["steps"], reset, read)
    steps = TRAIN["warmup"] + TRAIN["steps"]
    out = {"run": name, "fused": fused, "dtype": dtype or "float32",
           "batch": TRAIN["batch"], "px": TRAIN["px"], "steps": steps,
           "timed_steps": TRAIN["steps"], "through": "cuda_graph",
           "imgs_per_sec": 1e3 * TRAIN["batch"] / graph["step_ms"],
           "step_ms": graph["step_ms"], "eager_step_ms": eager["step_ms"],
           "first_loss": graph["first_loss"],
           "last_loss": graph["last_loss"],
           "peak_mem_gb": graph["peak_mem_gb"], "graph": graph,
           "eager": eager, "parity": parity,
           "tolerance": {"card_rel": SERVE["card_rel"]},
           "tf32": _tf32(torch), **launches}
    want = FUSED_LAUNCHES_PER_STEP * steps if fused else 0
    out["gates"] = {"losses_finite": math.isfinite(graph["first_loss"])
                    and math.isfinite(graph["last_loss"]),
                    "launches": launches["fused_conv_bn_launches"] == want
                    and launches["fused_conv_bn_wgmma_launches"] == want
                    and launches["flash_fwd_launches"] == 0,
                    **_graph_gates(graph, parity, steps)}
    out["ok"] = all(out["gates"].values())
    emit(out)
    check(out["ok"], f"training run {name} failed: {out['gates']}")
    return out


def phase_training(torch, seed):
    """Full-width resnet50_v1 training through CompiledTrainStep's CUDA
    graph, each run beside its eager twin: (a) fused fp32, (b) unfused
    fp32, (c) unfused bf16 (bench.py's main configuration); TF32 off."""
    runs = [_train_run(torch, seed, "a_fused_fp32", True, None),
            _train_run(torch, seed, "b_unfused_fp32", False, None),
            _train_run(torch, seed, "c_unfused_bf16", False, "bfloat16")]
    emit({"phase": "training", "ok": True,
          "fused_over_unfused_step_ms": runs[0]["step_ms"]
          / runs[1]["step_ms"],
          "graph_over_eager_step_ms": {
              r["run"]: r["step_ms"] / r["eager_step_ms"] for r in runs}})
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
# runs the same 3 + 10 steps after it, timed the same way.  Since slice 13
# CompiledTrainStep is one CUDA graph on the card: the loop is held
# against the graph's steps (its first call eager, the rest replays).
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

    learnable = [i for i, p in enumerate(net.collect_params().values())
                 if p.grad_req != "null"]

    def host_state():
        """The Gluon net's tensors and momenta, copied to the host."""
        moms = trainer._updaters[0].states if trainer._updaters else {}
        return ({k: v.detach().cpu().clone()
                 for k, v in net.state_dict().items()},
                [moms[i].detach().cpu().clone() if i in moms else None
                 for i in learnable])

    # the Gluon side of the comparisons: its steps with their start and
    # end states on the host (the two loops' graph pools, 38-45 GB each
    # at batch 256 on an H100 80GB HBM3, do not fit on the card together,
    # so CompiledTrainStep runs after the Gluon net is freed, from the
    # same states)
    records = []
    for k in range(GLUON["parity_steps"]):
        data, label = next_batch()
        pre = host_state()
        gl = float(gluon_step(data, label).mean().asscalar())
        records.append((data, label, pre, gl, host_state()))

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
    op = net._cached_op
    graphs = {"misses": op._misses, "hits": op._hits,
              "captures": op._captures, "replays": op._replays,
              "pool_gb": _pool_bytes(torch, op._pool) / 1e9}

    # the moving statistics after the timed steps: one more step of the
    # hybridized net, held below against the un-hybridized copy's
    data, label = next_batch()
    stats_pre = host_state()
    gluon_step(data, label)
    stats_post = host_state()[0]
    batches = [next_batch() for _ in range(GLUON["batches"])]
    accuracy = float(metric.get()[1])
    del net, trainer, metric, gluon_step, op, it, loss
    _free(torch)

    compiled = _train_step(ref, GLUON["batch"])

    def load(state):
        sd, moms = state
        ref.load_state_dict(sd)
        with torch.no_grad():
            for mom, m in zip(compiled._states, moms):
                if m is None:
                    mom.zero_()
                else:
                    mom.copy_(m)

    def cpu(sd):
        return {k: v.detach().cpu() for k, v in sd.items()}

    parity = []
    for k, (data, label, pre, gl, (post_sd, post_moms)) in \
            enumerate(records):
        # each step from the same state, as the CPU tests run it: the
        # card's nondeterministic sums (cuDNN) grow through a second step
        # in either loop
        load(pre)
        cl = compiled(data._data, label._data).item()
        got = cpu(ref.state_dict())
        state = _state_gap(got, post_sd)
        mom = _state_gap({str(i): m.cpu() for i, m in
                          zip(learnable, compiled._states)},
                         {str(i): m for i, m in zip(learnable, post_moms)})
        parity.append({"step": k + 1, "loss_gluon": gl, "loss_compiled": cl,
                       "worst_state": state, "worst_momentum": mom,
                       "bitwise_equal_tensors": sum(
                           torch.equal(got[n], post_sd[n])
                           for n in post_sd)})
    parity_ok = all(math.isfinite(p["loss_gluon"])
                    and p["worst_state"][0] <= GLUON["step_rel"]
                    and p["worst_momentum"][0] <= GLUON["step_rel"]
                    for p in parity)

    load(stats_pre)
    compiled(data._data, label._data)
    running = [k for k in stats_post if "running" in k]
    got = cpu(ref.state_dict())
    stats_gap = _state_gap({k: got[k] for k in running},
                           {k: stats_post[k] for k in running})

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
           "accuracy": accuracy, "peak_mem_gb": peak,
           "fused_conv_bn_launches": launches,
           "fused_conv_bn_wgmma_launches": wgmma, "parity": parity,
           "graphs": graphs, "moving_stats_gap_after_timed": stats_gap,
           # CompiledTrainStep, held against above, is itself a CUDA graph
           # (slice 13): its first call eager, then one capture, replays
           "compiled_train_step": {
               "through": "cuda_graph", "misses": compiled._misses,
               "captures": compiled._captures,
               "replays": compiled._replays,
               "pool_gb": _pool_bytes(torch, compiled._pool) / 1e9},
           "tolerance": {k: GLUON[k] for k in ("step_rel", "step_abs")},
           "tf32": _tf32(torch)}
    out["gates"] = {"launches": launches == want and wgmma == want,
                    "parity_with_compiled_train_step": parity_ok,
                    "record_entry_replayed": graphs["misses"] ==
                    graphs["captures"] == 1
                    and graphs["replays"] >= GLUON["steps"],
                    "compiled_step_replayed": compiled._misses
                    == compiled._captures == 1
                    and compiled._replays >= GLUON["steps"],
                    "moving_stats_as_eager":
                    stats_gap[0] <= GLUON["step_rel"],
                    "losses_finite": math.isfinite(first)
                    and math.isfinite(last)}
    out["ok"] = all(out["gates"].values())
    emit(out)
    check(out["ok"], f"gluon_training failed: {out['gates']}")
    del ref, compiled, batches, records
    _free(torch)
    return launches


# ---------------------------------------------------------------------------
# slice 9: export -> import -> serve
# ---------------------------------------------------------------------------
# Both models are served through ModelServer.register (ladder 1/2/4/8, 20
# ms batching window) and take examples/serving/serve_resnet.py's traffic:
# 24 concurrent requests of 1-3 rows from RandomState(seed), released
# together through a barrier.  Gates: every answer within 1e-4 of its
# largest |value| plus 1e-6 of a solo forward of the same block on the card
# (the rungs sum in other orders than a solo batch); one request within
# 1e-3 plus 1e-6 of the port's plain versions on the CPU from the same
# weights (the kernel and cuDNN against the plain versions, through 12
# layers); the cache holds the ladder's 4 entries, all made at warmup.
# Timing: ms per batch of 8 through engine.predict against the block called
# directly, 3 warm-up then 20 timed batches, synchronised at the end.
SERVE = dict(max_batch=8, max_wait_us=20000, requests=24, rows=(1, 3),
             card_rel=1e-4, cpu_rel=1e-3, abs=1e-6, warm=3, timed=20)
# BERT-base (bert_12_768_12: vocab 30522, 768 units, 12 layers, 12 heads,
# fp32, TF32 off, mx.init.Normal(0.02) from --seed), seq 128: 12 launches
# of the fp32 tensor-core flash kernel per forward, at [b, 12, 128, 64]
SERVE_BERT = dict(seq=128, heads=12, head_dim=64)
SERVE_RESNET = dict(px=224, classes=1000)


def _rows_gate(got, ref, rel):
    """(max |got - ref|, its bound rel * max |ref| + SERVE["abs"])."""
    g, r = got.asnumpy(), ref.asnumpy()
    import numpy as np
    return (float(np.abs(g - r).max()),
            rel * float(np.abs(r).max()) + SERVE["abs"])


def _traffic(server, name, reqs):
    """Every request from a thread of its own, released together; returns
    (answers, wall seconds from the release to the last answer)."""
    import threading
    client = server.client()
    gate = threading.Barrier(len(reqs) + 1)
    answers, errors = [None] * len(reqs), []

    def call(i):
        gate.wait()
        try:
            answers[i] = client.predict(name, reqs[i])
        except Exception as e:  # noqa: BLE001 - reported as a gate
            errors.append(f"{i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    check(not errors, f"{name}: requests failed: {errors}")
    return answers, time.perf_counter() - t0


def _batch_ms(torch, fn):
    """ms per call of ``fn`` over SERVE["timed"] calls after
    SERVE["warm"], synchronised at the end."""
    for _ in range(SERVE["warm"]):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE["timed"]):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / SERVE["timed"]


def _serving_report(server, name, eng, reqs, wall, warm_stats):
    """The phase line's serving figures and the cache gate."""
    snap = server.stats(name)
    cache = snap["compile_cache"]
    rows = sum(len(r) for r in reqs)
    out = {"requests": snap["requests"], "rows": rows,
           "batches": snap["batches"], "wall_s": wall,
           "rows_per_s": rows / wall,
           "latency_ms_p50": snap["latency_us_p50"] / 1e3,
           "latency_ms_p95": snap["latency_us_p95"] / 1e3,
           "batch_occupancy": snap["batch_occupancy"],
           "bucket_use": snap["bucket_use"],
           "batch_stage_ms_mean": snap["batch_stage_ms_mean"],
           "batch_stage_ms_max": snap["batch_stage_ms_max"],
           "cache": {k: cache[k] for k in ("entries", "hits", "misses")},
           "cache_after_warmup": {k: warm_stats[k]
                                  for k in ("entries", "hits", "misses")},
           "ladder": list(eng.ladder)}
    out["captures"] = eng._op._captures
    out["cache_ok"] = (warm_stats["entries"] == warm_stats["misses"] == 4
                       and warm_stats["hits"] == 0
                       and eng._op._captures == 4
                       and cache["entries"] == cache["misses"] == 4
                       and cache["hits"] == snap["batches"]
                       and snap["requests"] == len(reqs))
    return out


def _pool_bytes(torch, pool):
    """Bytes the caching allocator holds in a graph memory pool (its
    segments, which it keeps while the pool's graphs live: the pool's
    peak)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def _busy_share(torch, fn, n):
    """``fn`` called ``n`` times under ``torch.profiler``: wall ms per
    call, device ms per call (the CUDA kernels' self time, graph replays'
    kernels included) and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"calls": n, "wall_ms_per_call": wall_ms / n,
            "device_ms_per_call": busy_ms / n,
            "busy_share": busy_ms / wall_ms if kernels else None,
            "kernel_launches_per_call": sum(e.count for e in kernels) / n}


def _graph_rungs(torch, eng, block, make):
    """Each rung of ``eng`` against the eager ``block`` on the same rows
    (``make(b)``, an NDArray of b rows on the card): the worst
    ``_rows_gate`` and whether every output is bit for bit the eager one,
    then ms per batch through the rung's graph (execute stage) and through
    the eager block, the clone of the top rung's outputs timed alone, the
    graph pool's bytes and the busy share over 20 batches of the top
    rung, eager against graph."""
    rungs = {}
    for b in eng.ladder:
        x = make(b)
        got, ref = eng.predict(x), block(x)
        got = got if isinstance(got, (list, tuple)) else [got]
        ref = ref if isinstance(ref, (list, tuple)) else [ref]
        gates = [_rows_gate(g, r, SERVE["card_rel"])
                 for g, r in zip(got, ref)]
        rungs[b] = {"worst": max(gates, key=lambda e: e[0] / e[1]),
                    "ok": all(e <= bound for e, bound in gates),
                    "bitwise": all(torch.equal(g._data, r._data)
                                   for g, r in zip(got, ref)),
                    "graph_ms": _batch_ms(torch, lambda: eng.predict(x)),
                    "eager_ms": _batch_ms(torch, lambda: block(x))}
    top = eng.ladder[-1]
    entry = next(e.predict for e in eng._op._cache.values()
                 if e.predict is not None
                 and e.predict.static_in[0].shape[0] == top)
    x = make(top)
    return {"rungs": rungs,
            "clone_ms_top_rung": cuda_ms(
                torch, lambda: [o.clone() for o in entry.outs], iters=20),
            "graph_pool_gb": _pool_bytes(torch, eng._op._pool) / 1e9,
            "busy_eager": _busy_share(torch, lambda: block(x),
                                      SERVE["timed"]),
            "busy_graph": _busy_share(torch, lambda: eng.predict(x),
                                      SERVE["timed"])}


def _serve_requests(seed, feat, make):
    """SERVE["requests"] requests of 1-3 rows of ``feat`` from
    RandomState(seed), each drawn by ``make(rng, shape)``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    lo, hi = SERVE["rows"]
    return [make(rng, (int(rng.randint(lo, hi + 1)),) + tuple(feat))
            for _ in range(SERVE["requests"])]


def _flash_at(torch, seed, batches):
    """The fp32 tensor-core flash kernel at each [b, 12, 128, 64] the
    served BERT gives it, once against its plain version, then timed
    beside it and SDPA with the bound."""
    from mxnet_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    h, s, d = SERVE_BERT["heads"], SERVE_BERT["seq"], SERVE_BERT["head_dim"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    for b in batches:
        q, k, v = (torch.randn(b * h, s, d, generator=gen, device="cuda")
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        before = A.flash_fwd_tf32_launches
        o, lse = A.flash_fwd(q, k, v, False, scale)
        ran = A.flash_fwd_tf32_launches - before == 1
        ro, rl = A._flash_forward_plain(q, k, v, False, scale)
        err = max((o - ro).abs().max().item(), (lse - rl).abs().max().item())
        q4, k4, v4 = (t.view(b, h, s, d) for t in (q, k, v))
        best, _ = _in_turns(torch, {
            "kernel": lambda: A.flash_fwd(q, k, v, False, scale),
            "plain": lambda: A._flash_forward_plain(q, k, v, False, scale),
            "library": lambda: sdpa(q4, k4, v4, scale=scale)})
        bound, bound_by = flash_bound_ms(b, h, s, d, False, 4, ops_factor=3,
                                         peak=PEAK_TF32_FLOPS)
        cases.append({"shape": [b, h, s, d], "ran_tf32": ran,
                      "max_abs_err": err, "ms": best["kernel"],
                      "plain_ms": best["plain"],
                      "library_ms": best["library"], "bound_ms": bound,
                      "bound_by": bound_by,
                      "ok": ran and err <= TOL["float32"]["o"]})
    return cases


def phase_serving_bert(torch, seed):
    """Full-width BERT-base served from its block (see SERVE); returns the
    fp32 tensor-core flash kernel's launches on this path."""
    import tempfile

    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.language import bert_12_768_12
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.serving import ModelServer
    torch.cuda.empty_cache()
    kernels = _flash_at(torch, seed, (1, 2, 4, 8))
    mx.random.seed(seed)
    net = bert_12_768_12(ctx=mx.gpu(0))
    net.initialize(mx.init.Normal(0.02))
    layers = len(net.encoder.cells)
    vocab = net.word_embed._input_dim
    units = net._units
    forwards = [0]

    def count(block, args):
        # a capture runs the forward without launching: not counted; a
        # replay launches without a forward: counted by the engine
        if not torch.cuda.is_current_stream_capturing():
            forwards[0] += 1
    hook = net.register_forward_pre_hook(count)
    reqs = _serve_requests(seed, (SERVE_BERT["seq"],),
                           lambda rng, shape: rng.randint(
                               0, vocab, shape).astype(np.int32))

    # the main path: register (warmup over the ladder), traffic, stop
    A.flash_fwd_launches = A.flash_fwd_wgmma_launches = 0
    A.flash_fwd_tf32_launches = 0
    server = ModelServer()
    eng = server.register("bert", net, max_batch=SERVE["max_batch"],
                          max_wait_us=SERVE["max_wait_us"],
                          input_spec=[((SERVE_BERT["seq"],), "int32")])
    warm = eng.cache_stats
    answers, wall = _traffic(server, "bert", reqs)
    report = _serving_report(server, "bert", eng, reqs, wall, warm)
    # an id past the vocabulary: its row comes back NaN (the JAX package's
    # jnp.take), no device-side assert reaches the card, and the server
    # answers the requests after it
    bad = reqs[0].copy()
    bad[0, 5] = vocab
    bad_out = server.predict("bert", bad)[0]._data
    later = [server.predict("bert", x) for x in reqs[1:3]]
    torch.cuda.synchronize()
    server.stop()
    bad_gate = {
        "bad_row_nan": bool(torch.isnan(bad_out[0]).any().item()),
        "other_rows_finite": bool(torch.isfinite(bad_out[1:]).all().item()),
        "later_answers": [_rows_gate(g, r, SERVE["card_rel"])
                          for got, ref in zip(later, answers[1:3])
                          for g, r in zip(got, ref)]}
    served = {"flash_fwd": A.flash_fwd_launches,
              "tf32": A.flash_fwd_tf32_launches,
              "wgmma": A.flash_fwd_wgmma_launches,
              "eager_forwards": forwards[0], "replays": eng._op._replays,
              "forwards": forwards[0] + eng._op._replays}

    # gates: solo forwards of the same block on the card, one request on
    # the CPU through the plain versions from the same weights
    worst_card = []
    for x, got in zip(reqs, answers):
        ref = net(mx.nd.array(x, ctx=mx.gpu(0), dtype="int32"))
        worst_card.append([_rows_gate(g, r, SERVE["card_rel"])
                           for g, r in zip(got, ref)])
    solo_forwards = forwards[0] - served["eager_forwards"]
    hook.detach()
    i2 = next(i for i, x in enumerate(reqs) if len(x) == 2)
    with tempfile.TemporaryDirectory() as tmp:
        net.save_parameters(f"{tmp}/bert.params")
        cpu_net = bert_12_768_12(ctx=mx.cpu())
        cpu_net.load_parameters(f"{tmp}/bert.params")
    cpu_ref = cpu_net(mx.nd.array(reqs[i2], ctx=mx.cpu(), dtype="int32"))
    cpu_gate = [_rows_gate(g.as_in_context(mx.cpu()), r, SERVE["cpu_rel"])
                for g, r in zip(answers[i2], cpu_ref)]
    del cpu_net, cpu_ref

    x8 = mx.nd.array(np.concatenate(reqs)[:SERVE["max_batch"]],
                     ctx=mx.gpu(0), dtype="int32")
    engine_ms = _batch_ms(torch, lambda: eng.predict(x8))
    block_ms = _batch_ms(torch, lambda: net(x8))
    rows = np.concatenate(reqs)
    graphs = _graph_rungs(torch, eng, net, lambda b: mx.nd.array(
        rows[:b], ctx=mx.gpu(0), dtype="int32"))
    out = {"phase": "serving_bert", "model": "bert_12_768_12",
           "layers": layers, "units": units, "seq": SERVE_BERT["seq"],
           "dtype": "float32", **SERVE, **report,
           "engine_ms_per_batch8": engine_ms,
           "block_ms_per_batch8": block_ms,
           "flash_launches": served, "forwards_served": served["forwards"],
           "solo_forwards": solo_forwards,
           "card_worst": max((e / b, e) for r in worst_card for e, b in r),
           "cpu_err_bound": cpu_gate, "flash_at_serving_shapes": kernels,
           "out_of_vocab_request": bad_gate, "graphs": graphs,
           "tf32": _tf32(torch)}
    out["gates"] = {
        "answers_match_solo_forward": all(e <= b for r in worst_card
                                          for e, b in r),
        "rungs_match_eager_block": all(r["ok"] for r in
                                       graphs["rungs"].values()),
        "out_of_vocab_id": bad_gate["bad_row_nan"]
        and bad_gate["other_rows_finite"]
        and all(e <= b for e, b in bad_gate["later_answers"]),
        "one_request_matches_cpu": all(e <= b for e, b in cpu_gate),
        "shapes": all(g[0].shape == (len(x), SERVE_BERT["seq"], units)
                      and g[1].shape == (len(x), units)
                      for x, g in zip(reqs, answers)),
        "flash_launches": served["tf32"] == layers * served["forwards"]
        and served["flash_fwd"] == served["tf32"]
        and served["wgmma"] == 0 and served["forwards"] > 0,
        "cache": report["cache_ok"],
        "multi_request_batches": any(int(k) >= 2 for k in
                                     report["batch_occupancy"]),
        "kernel_at_serving_shapes": all(c["ok"] for c in kernels)}
    out["ok"] = all(out["gates"].values())
    emit(out)
    check(out["ok"], f"serving_bert failed: {out['gates']}")
    del net, eng, answers
    return served["tf32"]


def phase_serving_resnet_export(torch, seed):
    """Full-width resnet50_v1 exported, rebuilt from its files with
    InferenceEngine.from_export and served (see SERVE)."""
    import tempfile

    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.serving import InferenceEngine, ModelServer
    torch.cuda.empty_cache()
    os.environ["MXNET_TPU_FUSE_CONV_BN"] = "0"
    mx.random.seed(seed)
    net = resnet50_v1(classes=SERVE_RESNET["classes"], ctx=mx.gpu(0))
    net.initialize(mx.init.Xavier())
    feat = (3, SERVE_RESNET["px"], SERVE_RESNET["px"])
    net(mx.nd.zeros((1,) + feat, ctx=mx.gpu(0)))   # captures the signature
    reqs = _serve_requests(seed, feat, lambda rng, shape: rng.rand(
        *shape).astype(np.float32))
    with tempfile.TemporaryDirectory() as tmp:
        prefix = f"{tmp}/resnet50_v1"
        net.export(prefix)
        with open(f"{prefix}-symbol.json") as f:
            graph = json.load(f)
        eng = InferenceEngine.from_export(prefix,
                                          max_batch=SERVE["max_batch"])
        cpu_eng = InferenceEngine.from_export(prefix, max_batch=4,
                                              ctx=mx.cpu())
    server = ModelServer()
    server.register("resnet", engine=eng, max_wait_us=SERVE["max_wait_us"])
    warm = eng.cache_stats
    answers, wall = _traffic(server, "resnet", reqs)
    report = _serving_report(server, "resnet", eng, reqs, wall, warm)
    server.stop()

    worst_card = [_rows_gate(got, net(mx.nd.array(x, ctx=mx.gpu(0))),
                             SERVE["card_rel"])
                  for x, got in zip(reqs, answers)]
    cpu_ref = cpu_eng.predict(reqs[0])
    cpu_gate = _rows_gate(answers[0].as_in_context(mx.cpu()), cpu_ref,
                          SERVE["cpu_rel"])
    x8 = mx.nd.array(np.concatenate(reqs)[:SERVE["max_batch"]],
                     ctx=mx.gpu(0))
    engine_ms = _batch_ms(torch, lambda: eng.predict(x8))
    symbol_block_ms = _batch_ms(torch, lambda: eng.block(x8))
    block_ms = _batch_ms(torch, lambda: net(x8))
    rows = np.concatenate(reqs)
    graphs = _graph_rungs(torch, eng, eng.block._eager_forward,
                          lambda b: mx.nd.array(rows[:b], ctx=mx.gpu(0)))
    out = {"phase": "serving_resnet_export", "model": "resnet50_v1",
           "fused": False, "dtype": "float32", "px": SERVE_RESNET["px"],
           "graph_nodes": len(graph["nodes"]),
           "graph_ops": sorted({n["op"] for n in graph["nodes"]}),
           "input_spec": eng.input_spec, **SERVE, **report,
           "engine_ms_per_batch8": engine_ms,
           "symbol_block_ms_per_batch8": symbol_block_ms,
           "block_ms_per_batch8": block_ms,
           "card_worst": max((e / b, e) for e, b in worst_card),
           "cpu_err_bound": cpu_gate, "graphs": graphs,
           "tf32": _tf32(torch)}
    out["gates"] = {
        "answers_match_solo_forward": all(e <= b for e, b in worst_card),
        "rungs_match_eager_block": all(r["ok"] for r in
                                       graphs["rungs"].values()),
        "one_request_matches_cpu": cpu_gate[0] <= cpu_gate[1],
        "shapes": all(g.shape == (len(x), SERVE_RESNET["classes"])
                      for x, g in zip(reqs, answers)),
        "spec_from_sidecar": eng.input_spec == [(feat, "float32")],
        "cache": report["cache_ok"],
        "multi_request_batches": any(int(k) >= 2 for k in
                                     report["batch_occupancy"])}
    out["ok"] = all(out["gates"].values())
    emit(out)
    check(out["ok"], f"serving_resnet_export failed: {out['gates']}")
    del net, eng, cpu_eng, answers


# ---------------------------------------------------------------------------
# slice 10: the symbolic training loop (Module.fit over the kvstore)
# ---------------------------------------------------------------------------
# A BERT-base encoder classifier (bert_training's widths, its MLM head
# replaced by a 2-class head) built by calling the port's Gluon blocks on
# mx.sym.var("data"), fp32, TF32 off, trained through Module.fit over an
# NDArrayIter on the card: 384 rows of 128 token ids (float32) and 0/1
# labels from RandomState(seed), batch 64, 6 batches per epoch, SGD with
# momentum.  Gates: every parameter after the first epoch equal, within
# 1e-6 of its largest |value| plus 1e-7, across the 'device', 'local' and
# no kvstore (the same arithmetic; expected bit for bit); the resumed run
# (checkpoint and optimizer states after epoch 0) within 1e-4 plus 1e-6 of
# the uninterrupted one (Embedding's backward may add in another order on
# the card); 3 batches of Module against the same block trained through
# gluon.Trainer within 1e-4 plus 1e-6 (losses and parameters: the graph's
# registry ops against the layers' tensor forwards); one forward_backward
# at batch 8 on the card against the port's plain versions on the CPU from
# the same checkpoint within 1e-3 plus 1e-6 (outputs, the word embedding's
# and layer 0's QKV gradients: the kernel and cuBLAS against the plain
# versions through 12 layers).
MODULE = dict(vocab=30522, units=768, hidden=3072, heads=12, layers=12,
              seq=128, rows=384, batch=64, epochs=2, lr=0.01, momentum=0.9,
              speedometer=3, gluon_steps=3, gluon_timed=6, card_batch=8,
              kv_rel=1e-6, kv_abs=1e-7, resume_rel=1e-4, resume_abs=1e-6,
              gluon_rel=1e-4, gluon_abs=1e-6, cpu_rel=1e-3, cpu_abs=1e-6)


def _encoder_classifier(mx, device):
    """``(block, symbol)``: the encoder classifier of MODULE as a
    HybridBlock of the port's layers, and its graph under a
    SoftmaxOutput."""
    from mxnet_tpu_torch.gluon import HybridBlock, nn
    from mxnet_tpu_torch.gluon.model_zoo.language.transformer import \
        TransformerEncoder
    m = MODULE
    units = m["units"]

    class EncoderClassifier(HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.word_embed = nn.Embedding(m["vocab"], units,
                                               prefix="word_embed_")
                self.pos_weight = self.params.get(
                    "pos_weight", shape=(1, m["seq"], units))
                self.ln = nn.LayerNorm(epsilon=1e-12, in_channels=units,
                                       prefix="ln_")
                self.encoder = TransformerEncoder(
                    m["layers"], units, m["hidden"], m["heads"], dropout=0.0,
                    activation="gelu", prefix="enc_", device=device)
                self.pooler = nn.Dense(units, activation="tanh",
                                       in_units=units, prefix="pooler_")
                self.head = nn.Dense(2, in_units=units, prefix="head_")

        def hybrid_forward(self, F, x, pos_weight):
            h = self.encoder(self.ln(F.broadcast_add(self.word_embed(x),
                                                     pos_weight)))
            cls = F.reshape(F.slice_axis(h, axis=1, begin=0, end=1),
                            shape=(-1, units))
            return self.head(self.pooler(cls))

    net = EncoderClassifier(prefix="cls_")
    sym = mx.sym.SoftmaxOutput(net(mx.sym.var("data")),
                               mx.sym.var("softmax_label"), name="softmax")
    return net, sym


def _param_gap(got, ref, rel, abs_):
    """``(worst max|got - ref| / (rel·max|ref| + abs), its name, the
    largest max|got - ref|, every tensor bitwise equal)`` over ``ref``'s
    names; NDArrays or tensors."""
    def raw(x):
        return x._data if hasattr(x, "_data") else x
    worst, name, gap, equal = 0.0, "", 0.0, True
    for k, r in ref.items():
        r, g = raw(r), raw(got[k]).to(raw(r).device)
        d = (g - r).abs().max().item()
        ratio = d / (rel * r.abs().max().item() + abs_)
        if ratio >= worst:
            worst, name = ratio, k
        gap = max(gap, d)
        equal = equal and bool((g == r).all().item())
    return worst, name, gap, equal


def phase_module_fit(torch, seed):
    """The symbolic training loop on the card (see MODULE); returns the
    fp32 tensor-core flash kernel's launches on its main path (run A)."""
    import statistics
    import tempfile

    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ops import attention as A
    m = MODULE
    gpu = mx.gpu(0)
    torch.cuda.empty_cache()
    forwards, steps = [0], []

    class Module(mx.module.Module):
        """A Module on the card that counts its forwards and marks the
        start of each step (its forward_backward)."""

        def forward(self, data_batch, is_train=None):
            forwards[0] += 1
            super().forward(data_batch, is_train)

        def forward_backward(self, data_batch):
            self._t0 = time.perf_counter()
            super().forward_backward(data_batch)

    def step_end(param):
        """Batch-end callback: the step's time, forward_backward to here
        (update and update_metric included), ending in a synchronize."""
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - param.locals["self"]._t0)

    mx.random.seed(seed)
    net, sym = _encoder_classifier(mx, "cuda")
    rng = np.random.RandomState(seed)
    x = rng.randint(0, m["vocab"], (m["rows"], m["seq"])).astype(np.float32)
    y = rng.randint(0, 2, m["rows"]).astype(np.float32)
    it = mx.io.NDArrayIter(mx.nd.array(x, ctx=gpu), mx.nd.array(y, ctx=gpu),
                           batch_size=m["batch"])
    opt = {"learning_rate": m["lr"], "momentum": m["momentum"],
           "rescale_grad": 1.0 / m["batch"]}
    fit = dict(optimizer="sgd", optimizer_params=opt)
    batches_per_epoch = m["rows"] // m["batch"]
    tmp = tempfile.mkdtemp(prefix="module_fit_")
    try:
        # run A, the main path: fit 2 epochs, score, predict
        mod = Module(sym, context=gpu)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(mx.init.Xavier())
        init = mod.get_params()[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.flash_fwd_launches = A.flash_fwd_wgmma_launches = 0
        A.flash_fwd_tf32_launches = 0
        fwd0 = forwards[0]
        mod.fit(it, num_epoch=m["epochs"], kvstore="device",
                batch_end_callback=[step_end,
                                    mx.callback.Speedometer(
                                        m["batch"], m["speedometer"])],
                epoch_end_callback=mx.callback.do_checkpoint(f"{tmp}/a"),
                **fit)
        peak_fit = torch.cuda.max_memory_allocated() / 1e9
        score = mod.score(it, "acc")
        pred = mod.predict(it)
        torch.cuda.synchronize()
        main = {"flash_fwd": A.flash_fwd_launches,
                "tf32": A.flash_fwd_tf32_launches,
                "wgmma": A.flash_fwd_wgmma_launches,
                "forwards": forwards[0] - fwd0}
        graphs = {"misses": mod._exec._misses, "hits": mod._exec._hits,
                  "captures": mod._exec._captures,
                  "pool_gb": _pool_bytes(torch, mod._exec._pool) / 1e9}
        step_ms = 1e3 * statistics.median(steps)
        final = mod.get_params()[0]
        it.reset()
        mod.forward_backward(it.next())
        update_ms = cuda_ms(torch, mod.update, iters=5)
        del mod
        torch.cuda.empty_cache()

        # kvstore: epoch 0 again from run A's start with 'local' (run B,
        # which checkpoints with its optimizer states) and with none
        epoch0 = mx.model.load_params(f"{tmp}/a", 1)[0]
        kv_gaps = {}
        for kv in ("local", None):
            mod = Module(sym, context=gpu)
            mod.fit(it, num_epoch=1, kvstore=kv, arg_params=init,
                    aux_params={}, **fit)
            kv_gaps[str(kv)] = _param_gap(mod.get_params()[0], epoch0,
                                          m["kv_rel"], m["kv_abs"])
            if kv == "local":
                mod.save_checkpoint(f"{tmp}/b", 1, save_optimizer_states=True)
            del mod
        # resume: a new module from run B's checkpoint fits epoch 1
        rsym, rarg, raux = mx.model.load_checkpoint(f"{tmp}/b", 1)
        mod = Module(rsym, context=gpu)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params=rarg, aux_params=raux)
        mod.init_optimizer(kvstore="device", **fit)
        mod.load_optimizer_states(f"{tmp}/b-0001.states")
        mod.fit(it, begin_epoch=1, num_epoch=m["epochs"], kvstore="device",
                **fit)
        resume = _param_gap(mod.get_params()[0], final, m["resume_rel"],
                            m["resume_abs"])
        del mod, rarg
        torch.cuda.empty_cache()

        # Module against gluon.Trainer on the same block, 3 batches
        it.reset()
        batches = [it.next() for _ in range(m["gluon_steps"])]
        mod = Module(sym, context=gpu)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params=init, aux_params={})
        mod.init_optimizer(kvstore="device", **fit)
        mod_losses = []
        for b in batches:
            mod.forward_backward(b)
            p = mod.get_outputs()[0]._data
            mod_losses.append(-p.gather(1, b.label[0]._data.long()[:, None])
                              .log().mean().item())
            mod.update()
        mod_params = mod.get_params()[0]
        del mod
        net.initialize(ctx=gpu)
        params = net.collect_params()
        for name, p in params.items():
            p.set_data(init[name])
        gluon_forwards = [0]
        hook = net.register_forward_pre_hook(
            lambda block, args: gluon_forwards.__setitem__(
                0, gluon_forwards[0] + 1))
        trainer = gluon.Trainer(params, "sgd", {"learning_rate": m["lr"],
                                                "momentum": m["momentum"]})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

        def gluon_step(b):
            with autograd.record():
                loss = loss_fn(net(b.data[0]), b.label[0])
            loss.backward()
            trainer.step(m["batch"])
            return loss

        gluon_losses = [float(gluon_step(b).mean().asscalar())
                        for b in batches]
        gluon_gap = _param_gap({k: p.data() for k, p in params.items()},
                               mod_params, m["gluon_rel"], m["gluon_abs"])
        loss_gap = max(abs(a - b) / (m["gluon_rel"] * abs(b) + m["gluon_abs"])
                       for a, b in zip(gluon_losses, mod_losses))
        gluon_times = []
        for i in range(m["gluon_timed"]):
            t0 = time.perf_counter()
            gluon_step(batches[i % len(batches)])
            torch.cuda.synchronize()
            gluon_times.append(time.perf_counter() - t0)
        hook.detach()
        del trainer, mod_params
        torch.cuda.empty_cache()

        # the card against the CPU: one forward_backward at batch 8 from
        # the same checkpoint
        mx.model.save_checkpoint(f"{tmp}/c", 0, sym, final, {})
        del final
        xs = mx.nd.array(x[:m["card_batch"]], ctx=mx.cpu())
        ys = mx.nd.array(y[:m["card_batch"]], ctx=mx.cpu())
        sides = []
        for ctx, cls in ((gpu, Module), (mx.cpu(), mx.module.Module)):
            with ctx:
                csym, carg, caux = mx.model.load_checkpoint(f"{tmp}/c", 0)
            cmod = cls(csym, context=ctx)
            cmod.bind([("data", (m["card_batch"], m["seq"]))],
                      [("softmax_label", (m["card_batch"],))])
            cmod.init_params(arg_params=carg, aux_params=caux)
            cmod.forward_backward(mx.io.DataBatch([xs], [ys]))
            g = cmod._exec.grad_dict
            sides.append({
                "output": cmod.get_outputs()[0].as_in_context(mx.cpu()),
                "word_embed": g["cls_word_embed_weight"].as_in_context(
                    mx.cpu()),
                "qkv0": g["cls_enc_layer0_attn_qkv_weight"].as_in_context(
                    mx.cpu())})
            del cmod, carg
        cpu_gap = _param_gap(sides[0], sides[1], m["cpu_rel"], m["cpu_abs"])
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()

    layers = m["layers"]
    phase = {"tf32": A.flash_fwd_tf32_launches,
             "other": A.flash_fwd_launches - A.flash_fwd_tf32_launches,
             "wgmma": A.flash_fwd_wgmma_launches,
             "module_forwards": forwards[0] - fwd0,
             "gluon_forwards": gluon_forwards[0]}
    out = {"phase": "module_fit", "model": "bert_base_encoder_classifier",
           "layers": layers, "units": m["units"], "seq": m["seq"],
           "batch": m["batch"], "rows": m["rows"], "epochs": m["epochs"],
           "dtype": "float32", "optimizer": "sgd", **opt,
           "step_ms": step_ms, "samples_per_sec": m["batch"] / step_ms * 1e3,
           "steps_ms": [1e3 * s for s in steps],
           "update_ms": update_ms,
           "gluon_step_ms": 1e3 * statistics.median(gluon_times),
           "peak_mem_gb_fit": peak_fit,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "executor_graphs": graphs,
           "score": score, "predict_shape": list(pred.shape),
           "main_path": main, "phase_launches": phase,
           "kvstore_gaps": kv_gaps, "resume_gap": resume,
           "gluon_loss": gluon_losses, "module_loss": mod_losses,
           "gluon_param_gap": gluon_gap, "gluon_loss_gap": loss_gap,
           "card_cpu_gap": cpu_gap,
           "tolerance": {k: m[k] for k in m if k.endswith(("_rel", "_abs"))},
           "tf32": _tf32(torch)}
    out["gates"] = {
        "main_path_launches": main["tf32"] == layers * main["forwards"]
        and main["flash_fwd"] == main["tf32"] and main["wgmma"] == 0
        and main["forwards"] == (m["epochs"] + 2) * batches_per_epoch
        and len(steps) == m["epochs"] * batches_per_epoch,
        "phase_launches": phase["tf32"] == layers * (
            phase["module_forwards"] + phase["gluon_forwards"])
        and phase["other"] == 0 and phase["wgmma"] == 0,
        "captures_equal_misses": graphs["captures"] == graphs["misses"]
        == 2,
        "kvstores_agree": all(g[0] <= 1.0 for g in kv_gaps.values()),
        "resume": resume[0] <= 1.0,
        "module_matches_gluon": gluon_gap[0] <= 1.0 and loss_gap <= 1.0,
        "card_matches_cpu": cpu_gap[0] <= 1.0,
        "predict": list(pred.shape) == [m["rows"], 2]
        and bool(torch.isfinite(pred._data).all().item()),
        "losses_finite": all(math.isfinite(v) for v in
                             gluon_losses + mod_losses)}
    out["ok"] = all(out["gates"].values())
    emit(out)
    check(out["ok"], f"module_fit failed: {out['gates']}")
    del net, it, pred
    return main["tf32"]


# ---------------------------------------------------------------------------
# slice 11: the distributed kvstore
# ---------------------------------------------------------------------------
# Two ranks on the one card, over gloo (NCCL refuses two ranks on one
# card), each training module_fit's full-width BERT-base encoder
# classifier (MODULE; fp32, TF32 off) on mx.gpu(0) under tools/launch.py.
DIST = dict(ranks=2, batches=3, timeout_s=420)


def _dist_digests(torch, tensors, weights):
    """One int64 per tensor: its fp32 bits weighted by position (mod
    65521), summed; equal digests on every rank mean equal bits there."""
    out = []
    for t in tensors:
        bits = t.detach().contiguous().view(-1).view(torch.int32).long()
        w = weights.get(bits.numel())
        if w is None:
            w = weights[bits.numel()] = torch.arange(
                bits.numel(), device=bits.device) % 65521 + 1
        out.append((bits * w).sum())
    return torch.stack(out).cpu()


def _dist_runs(torch, mx, seed):
    """This rank's part of dist_training: run A (Module.fit over dist_sync
    on rows r::2, then the same batches on every rank against a
    one-process 'device' run), run B (gluon.Trainer over dist_sync with
    the default bucket cap, then MXNET_KVSTORE_BUCKET_KB=0)."""
    import statistics

    import numpy as np
    import torch.distributed as dist
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.kvstore.bucketing import (bucket_capacity_bytes,
                                                   partition_bucket_indices)
    from mxnet_tpu_torch.ops import attention as A
    m = MODULE
    rank, world = mx.distributed.process_index(), mx.distributed.process_count()
    gpu, B, nb = mx.gpu(0), m["batch"], DIST["batches"]
    weights = {}

    def agree(tensors):
        """The ranks hold equal bits: one all_reduce of the digests."""
        d = _dist_digests(torch, tensors, weights)
        total = d.clone()
        dist.all_reduce(total)
        return bool(torch.equal(total, d * world))

    forwards, steps, updates, agreed = [0], [], [], []

    class Module(mx.module.Module):
        """Counts forwards; times each step and its update()."""

        def forward(self, data_batch, is_train=None):
            forwards[0] += 1
            super().forward(data_batch, is_train)

        def forward_backward(self, data_batch):
            self._t0 = time.perf_counter()
            super().forward_backward(data_batch)

        def update(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().update()
            torch.cuda.synchronize()
            updates.append(1e3 * (time.perf_counter() - t0))

    net, sym = _encoder_classifier(mx, "cuda")
    rng = np.random.RandomState(seed)
    x = rng.randint(0, m["vocab"], (m["rows"], m["seq"])).astype(np.float32)
    y = rng.randint(0, 2, m["rows"]).astype(np.float32)
    mine = (x[rank::world][:nb * B], y[rank::world][:nb * B])
    same = (x[:nb * B], y[:nb * B])

    def module_run(data, kvstore, rescale, init_seed, arg_params=None):
        it = mx.io.NDArrayIter(mx.nd.array(data[0], ctx=gpu),
                               mx.nd.array(data[1], ctx=gpu), batch_size=B)
        mod = Module(sym, context=gpu)
        mod.bind(it.provide_data, it.provide_label)
        mx.random.seed(init_seed)
        mod.init_params(mx.init.Xavier(), arg_params=arg_params,
                        aux_params={} if arg_params else None)
        opt = {"learning_rate": m["lr"], "momentum": m["momentum"],
               "rescale_grad": rescale}
        mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                           optimizer_params=opt)
        init = mod.get_params()[0]
        names = mod._param_names

        def step_end(param):
            torch.cuda.synchronize()
            steps.append(1e3 * (time.perf_counter() - mod._t0))
            if kvstore != "device":
                agreed.append(agree([mod._exec.arg_dict[n]._data
                                     for n in names]))

        mod.fit(it, num_epoch=1, kvstore=kvstore, optimizer="sgd",
                optimizer_params=opt, batch_end_callback=step_end)
        return mod, init

    out = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "cards": torch.cuda.device_count()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # run A, the main path: Module.fit over dist_sync, rank r on rows r::2
    # from rank-divergent Xavier draws (kv.init sends rank 0's)
    A.flash_fwd_launches = A.flash_fwd_wgmma_launches = 0
    A.flash_fwd_tf32_launches = 0
    mod, _ = module_run(mine, "dist_sync", 1.0 / B, seed + rank)
    torch.cuda.synchronize()
    out["module"] = {"flash": {"tf32": A.flash_fwd_tf32_launches,
                               "all": A.flash_fwd_launches,
                               "wgmma": A.flash_fwd_wgmma_launches,
                               "forwards": forwards[0]},
                     "step_ms": list(steps), "update_ms": list(updates),
                     "ranks_agree": list(agreed),
                     "rounds": dict(mod._kvstore._rounds_completed),
                     "graphs": {"misses": mod._exec._misses,
                                "captures": mod._exec._captures,
                                "pool_gb": _pool_bytes(torch, 
                                    mod._exec._pool) / 1e9}}
    del mod
    # run A(b): the same batches on every rank; against one process with
    # 'device' and rescale_grad doubled from the same weights (g + g = 2g
    # and the scalings by 1/64 and 2/64 are exact)
    agreed.clear()
    mod, init = module_run(same, "dist_sync", 1.0 / B, seed + rank)
    out["module_same"] = {"ranks_agree": list(agreed)}
    dist_params = mod.get_params()[0]
    del mod
    if rank == 0:
        dev, _ = module_run(same, "device", 2.0 / B, seed, arg_params=init)
        gap = _param_gap(dev.get_params()[0], dist_params, 1e-6, 0.0)
        out["module_same"]["device_gap"] = list(gap)
        del dev
    del dist_params, init
    torch.cuda.empty_cache()

    # run B: gluon.Trainer over dist_sync, bucketed then one key at a time
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    gforwards = [0]
    hook = net.register_forward_pre_hook(
        lambda block, args: gforwards.__setitem__(0, gforwards[0] + 1))
    batches = [(mx.nd.array(mine[0][i * B:(i + 1) * B], ctx=gpu),
                mx.nd.array(mine[1][i * B:(i + 1) * B], ctx=gpu))
               for i in range(nb)]
    runs, finals = {}, {}
    for cap in ("4096", "0"):
        os.environ["MXNET_KVSTORE_BUCKET_KB"] = cap
        mx.random.seed(seed + 100 + rank)
        net.initialize(mx.init.Xavier(), ctx=gpu, force_reinit=True)
        params = net.collect_params()
        trainer = gluon.Trainer(params, "sgd", {"learning_rate": m["lr"],
                                                "momentum": m["momentum"]},
                                kvstore="dist_sync")
        allreduce_ms, step_ms, staged, issued, ok = [], [], [], [], []
        inner = trainer.allreduce_grads

        def timed_allreduce(inner=inner, allreduce_ms=allreduce_ms):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inner()
            torch.cuda.synchronize()
            allreduce_ms.append(1e3 * (time.perf_counter() - t0))

        trainer.allreduce_grads = timed_allreduce
        for xb, yb in batches:
            kv = trainer._kvstore
            before = (kv.keys_staged, kv.buckets_issued) if kv else (0, 0)
            t0 = time.perf_counter()
            with autograd.record():
                loss = loss_fn(net(xb), yb)
            loss.backward()
            trainer.step(B)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            kv = trainer._kvstore
            staged.append(kv.keys_staged - before[0])
            issued.append(kv.buckets_issued - before[1])
            ok.append(agree([p.data()._data for p in params.values()]))
        sizes = [p.data()._data.numel() * 4 for p in params.values()]
        runs[cap] = {"step_ms": step_ms, "allreduce_grads_ms": allreduce_ms,
                     "keys_staged": staged, "buckets_issued": issued,
                     "keys": len(sizes), "bytes": sum(sizes),
                     "expected_buckets": len(partition_bucket_indices(
                         sizes, ["float32"] * len(sizes),
                         bucket_capacity_bytes())) if cap != "0" else 0,
                     "rounds": dict(kv._rounds_completed),
                     "ranks_agree": ok, "loss": float(loss.mean().asscalar())}
        finals[cap] = [p.data()._data.clone() for p in params.values()]
        del trainer, kv
    del os.environ["MXNET_KVSTORE_BUCKET_KB"]
    hook.detach()
    out["trainer"] = runs
    out["trainer_bucketed_equals_per_key"] = all(
        bool(torch.equal(a, b)) for a, b in zip(finals["4096"], finals["0"]))
    out["flash_phase"] = {"tf32": A.flash_fwd_tf32_launches,
                          "all": A.flash_fwd_launches,
                          "wgmma": A.flash_fwd_wgmma_launches,
                          "forwards": forwards[0] + gforwards[0]}
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["module_step_ms_median"] = statistics.median(out["module"]["step_ms"])
    return out


def dist_worker(seed, out_dir):
    """A rank of dist_training (``chip_smoke.py --dist-worker``, started by
    tools/launch.py): writes its figures to ``out_dir/rank<r>.json`` and
    prints ``[rank r] dist_training OK``; any failure exits non-zero."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mx.distributed.initialize(backend="gloo")
    try:
        out = _dist_runs(torch, mx, seed)
    finally:
        mx.distributed.finalize()
    Path(out_dir, f"rank{out['rank']}.json").write_text(json.dumps(out))
    print(f"[rank {out['rank']}] dist_training OK", flush=True)


def phase_dist_training(torch, seed):
    """Two gloo ranks on the card under tools/launch.py (see DIST);
    returns the fp32 tensor-core flash kernel's launches on each rank's
    main path (run A)."""
    import shutil
    import signal
    import tempfile
    root = Path(__file__).resolve().parent
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n = DIST["ranks"]
    out_dir = tempfile.mkdtemp(prefix="dist_training_")
    cmd = [sys.executable, str(root / "tools" / "launch.py"), "-n", str(n),
           sys.executable, str(Path(__file__).resolve()), "--dist-worker",
           "--seed", str(seed), "--dist-out", out_dir]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=root,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=DIST["timeout_s"])
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        shutil.rmtree(out_dir, ignore_errors=True)
        raise SmokeFailure(f"dist_training: no end in {DIST['timeout_s']} s")
    wall = time.perf_counter() - t0
    try:
        ranks = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
                 for r in range(n) if Path(out_dir, f"rank{r}.json").exists()]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    check(proc.returncode == 0 and len(ranks) == n and all(
        f"[rank {r}] dist_training OK" in stdout for r in range(n)),
        f"dist_training: launcher rc {proc.returncode}, {len(ranks)} of {n} "
        f"ranks reported\n{stdout[-2000:]}\n{stderr[-6000:]}")
    layers = MODULE["layers"]
    r0 = ranks[0]
    bucketed, per_key = r0["trainer"]["4096"], r0["trainer"]["0"]
    out = {"phase": "dist_training", "model": "bert_base_encoder_classifier",
           "layers": layers, "units": MODULE["units"], "seq": MODULE["seq"],
           "batch_per_rank": MODULE["batch"], "batches": DIST["batches"],
           "dtype": "float32", "backend": r0["backend"], "world": n,
           "ranks_per_card": n / r0["cards"], "wall_s": wall,
           "module_step_ms": [r["module"]["step_ms"] for r in ranks],
           "module_update_ms": [r["module"]["update_ms"] for r in ranks],
           "trainer_step_ms": {cap: [r["trainer"][cap]["step_ms"]
                                     for r in ranks] for cap in ("4096", "0")},
           "allreduce_grads_ms": {cap: [r["trainer"][cap][
               "allreduce_grads_ms"] for r in ranks] for cap in ("4096", "0")},
           "keys_staged_per_step": bucketed["keys_staged"],
           "buckets_per_step": bucketed["buckets_issued"],
           "expected_buckets": bucketed["expected_buckets"],
           "keys": bucketed["keys"], "grad_bytes": bucketed["bytes"],
           "rounds": {"module": r0["module"]["rounds"],
                      "trainer_bucketed": bucketed["rounds"],
                      "trainer_per_key": per_key["rounds"]},
           "device_gap": r0["module_same"].get("device_gap"),
           "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
           "flash_main_path": [r["module"]["flash"] for r in ranks],
           "flash_phase": [r["flash_phase"] for r in ranks],
           "executor_graphs": [r["module"]["graphs"] for r in ranks],
           "losses": [r["trainer"]["4096"]["loss"] for r in ranks]}
    nkeys = bucketed["keys"]
    out["gates"] = {
        "backend_gloo": all(r["backend"] == "gloo" for r in ranks),
        "ranks_agree_every_step": all(
            all(r["module"]["ranks_agree"]) and
            len(r["module"]["ranks_agree"]) == DIST["batches"] and
            all(r["module_same"]["ranks_agree"]) and
            all(all(t["ranks_agree"]) and len(t["ranks_agree"]) ==
                DIST["batches"] for t in r["trainer"].values())
            for r in ranks),
        "same_batches_match_device_run": out["device_gap"] is not None
        and out["device_gap"][3] is True,
        "bucketed": all(
            r["trainer"]["4096"]["buckets_issued"] ==
            [r["trainer"]["4096"]["expected_buckets"]] * DIST["batches"]
            and r["trainer"]["4096"]["keys_staged"] ==
            [nkeys] * DIST["batches"]
            and r["trainer"]["0"]["buckets_issued"] == [0] * DIST["batches"]
            and r["trainer"]["0"]["rounds"].get("allreduce") ==
            nkeys * DIST["batches"] for r in ranks),
        "bucketed_equals_per_key": all(r["trainer_bucketed_equals_per_key"]
                                       for r in ranks),
        "flash_launches": all(
            f["tf32"] == layers * f["forwards"] and f["all"] == f["tf32"]
            and f["wgmma"] == 0 and f["forwards"] > 0
            for r in ranks for f in (r["module"]["flash"], r["flash_phase"]))
        and all(r["module"]["flash"]["forwards"] == DIST["batches"]
                for r in ranks),
        "captures_equal_misses": all(
            g["captures"] == g["misses"] > 0 for g in out["executor_graphs"]),
        "losses_finite": all(math.isfinite(v) for v in out["losses"])}
    out["ok"] = all(out["gates"].values())
    emit(out)
    check(out["ok"], f"dist_training failed: {out['gates']}")
    return [r["module"]["flash"]["tf32"] for r in ranks]


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
    """Full-width BERT-base as bench.py builds it, through
    CompiledTrainStep's graph and its eager twin (``_graph_and_eager``),
    ``BERT["warmup"]`` + ``BERT["steps"]`` steps each, the flash launch
    counts set to 0 just before the graph's steps and read just after;
    samples per second from the host clock over the timed steps, ending
    in a ``loss.item()``."""
    from mxnet_tpu_torch.ops import attention as A

    cells = []

    def build():
        net, step, x, y = _bert_base(torch, seed, dtype)
        cells[:] = [len(net.bert.encoder.cells)]
        return net, step, x, y

    def reset():
        A.flash_fwd_launches = A.flash_fwd_wgmma_launches = 0
        A.flash_fwd_tf32_launches = 0

    def read():
        return {"flash_fwd_launches": A.flash_fwd_launches,
                "flash_fwd_tf32_launches": A.flash_fwd_tf32_launches,
                "flash_fwd_wgmma_launches": A.flash_fwd_wgmma_launches}

    graph, eager, parity, launches = _graph_and_eager(
        torch, build, BERT["warmup"], BERT["steps"], reset, read)
    steps = BERT["warmup"] + BERT["steps"]
    layers = cells[0]
    out = {"run": f"bert_{dtype}", "dtype": dtype, "batch": BERT["batch"],
           "seq": BERT["seq"], "layers": layers, "steps": steps,
           "timed_steps": BERT["steps"], "through": "cuda_graph",
           "samples_per_sec": 1e3 * BERT["batch"] / graph["step_ms"],
           "step_ms": graph["step_ms"], "eager_step_ms": eager["step_ms"],
           "first_loss": graph["first_loss"],
           "last_loss": graph["last_loss"],
           "peak_mem_gb": graph["peak_mem_gb"], "graph": graph,
           "eager": eager, "parity": parity,
           "tolerance": {"card_rel": SERVE["card_rel"]},
           "tf32": _tf32(torch), **launches}
    out["gates"] = {"losses_finite": math.isfinite(graph["first_loss"])
                    and math.isfinite(graph["last_loss"]),
                    "launches": launches["flash_fwd_launches"]
                    == launches["flash_fwd_tf32_launches"]
                    == layers * steps == 156
                    and launches["flash_fwd_wgmma_launches"] == 0,
                    **_graph_gates(graph, parity, steps)}
    out["ok"] = all(out["gates"].values())
    emit(out)
    check(out["ok"], f"BERT run {dtype} failed: {out['gates']}")
    return out


def phase_bert_training(torch, seed):
    """Full-width BERT-base pretraining steps through CompiledTrainStep's
    CUDA graph, each run beside its eager twin, fp32 then bf16 through
    amp.convert_block; TF32 off.  Returns the fp32 tensor-core flash
    kernel's launches in both graph runs."""
    runs = [_bert_run(torch, seed, "float32"),
            _bert_run(torch, seed, "bfloat16")]
    emit({"phase": "bert_training", "ok": True,
          "bf16_over_fp32_step_ms": runs[1]["step_ms"] / runs[0]["step_ms"],
          "graph_over_eager_step_ms": {
              r["run"]: r["step_ms"] / r["eager_step_ms"] for r in runs}})
    return sum(r["flash_fwd_tf32_launches"] for r in runs)


# ---------------------------------------------------------------------------
# slice 12: hybridize() and the Executor as CUDA graphs
# ---------------------------------------------------------------------------
# A small block (Dense 64 -> 256, BatchNorm, Dropout(0.5); fp32, TF32 off)
# hybridized on the card beside an eager copy with the same weights.  Three
# recorded calls (the first eager, then two replays of the record entry's
# forward graph) must draw three different masks, each keeping 50% of the
# 16384 outputs within 4 standard deviations (4·sqrt(0.25/16384) = 1.6%);
# the moving statistics must advance at every call and stay within
# GRAPH["rel"] of the eager copy's (the batch statistics do not depend on
# the mask); an output held from a replay must be unchanged by the next
# one; set_data on a weight must replay without a capture, and a cast that
# rebinds the weights (fp16 and back) must capture exactly once.  The same
# block without Dropout checks the backward graph's gradients against the
# eager copy's; a bound symbol (FullyConnected, BatchNorm, SoftmaxOutput)
# checks the Executor's graphs against the same executor on the CPU
# within 1e-4 of each tensor's largest |value| plus 1e-6 (write, add and
# null gradients, the moving statistics in place); and an
# InferenceEngine over the block checks each rung's graph against the
# eager block.
GRAPH = dict(batch=64, units_in=64, units=256, rate=0.5, calls=3, rel=1e-5,
             exec_batch=32, exec_classes=10, exec_steps=3, exec_rel=1e-4,
             exec_abs=1e-6)


def _graph_block(mx, dropout):
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential(prefix="gs_")
    with net.name_scope():
        net.add(nn.Dense(GRAPH["units"], in_units=GRAPH["units_in"]),
                nn.BatchNorm(in_channels=GRAPH["units"]))
        if dropout:
            net.add(nn.Dropout(GRAPH["rate"]))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    return net


def _graph_twin(mx, net, dropout):
    """An un-hybridized copy of ``net`` with its weights."""
    twin = _graph_block(mx, dropout)
    for (_, p), (_, q) in zip(sorted(net.collect_params().items()),
                              sorted(twin.collect_params().items())):
        q.set_data(p.data())
    return twin


def _rel_gap(a, b):
    a, b = (x._data if hasattr(x, "_data") else x for x in (a, b))
    return ((a - b).abs().max() / (b.abs().max() + 1e-12)).item()


def _graph_executor(torch, mx, seed):
    """The Executor's graphs on the card against the same executor on the
    CPU, grad_req write/add/null, 3 training steps and a predict."""
    import numpy as np
    g = GRAPH
    rng = np.random.RandomState(seed)
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = mx.sym.BatchNorm(net, name="bn", fix_gamma=False)
    net = mx.sym.FullyConnected(mx.sym.Activation(net, act_type="relu"),
                                num_hidden=g["exec_classes"], name="fc2")
    sym = mx.sym.SoftmaxOutput(net, mx.sym.var("softmax_label"),
                               name="softmax")
    shapes = {"data": (g["exec_batch"], 16),
              "softmax_label": (g["exec_batch"],)}
    req = {"data": "null", "softmax_label": "null", "fc1_weight": "write",
           "fc1_bias": "add", "bn_gamma": "write", "bn_beta": "null",
           "fc2_weight": "write", "fc2_bias": "write"}
    sides = {}
    for name, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        ex = sym.simple_bind(ctx=ctx, grad_req=req, **shapes)
        r = np.random.RandomState(seed)
        for k, a in ex.arg_dict.items():
            if k not in shapes:
                a[:] = r.randn(*a.shape).astype(np.float32) * 0.1
        ex.aux_dict["bn_moving_var"][:] = np.ones(32, np.float32)
        sides[name] = ex
    card, cpu = sides["card"], sides["cpu"]
    aux_ptr = card.aux_dict["bn_moving_mean"]._data.data_ptr()
    def gap(got, ref):
        # max |got - ref| over its bound (fc1's bias takes a gradient of
        # rounding noise: BatchNorm removes it from the output)
        got, ref = got.as_in_context(mx.cpu())._data, ref._data
        return ((got - ref).abs().max()
                / (g["exec_rel"] * ref.abs().max() + g["exec_abs"])).item()

    gaps = []
    for step in range(g["exec_steps"]):
        x = rng.randn(*shapes["data"]).astype(np.float32)
        y = rng.randint(0, g["exec_classes"], shapes["softmax_label"])
        for ex in (card, cpu):
            ex.forward(is_train=True, data=x, softmax_label=y)
            ex.backward()
        step_gaps = {"output": gap(card.outputs[0], cpu.outputs[0])}
        step_gaps.update((k, gap(card.grad_dict[k], cpu.grad_dict[k]))
                         for k in req if req[k] != "null")
        step_gaps.update((k, gap(card.aux_dict[k], cpu.aux_dict[k]))
                         for k in card.aux_dict)
        gaps.append(step_gaps)
        for ex in (card, cpu):   # an SGD step through the bound arrays
            for k in req:
                if req[k] != "null":
                    ex.arg_dict[k][:] = ex.arg_dict[k] - 0.1 * ex.grad_dict[k]
    x = rng.randn(*shapes["data"]).astype(np.float32)
    pred = [ex.forward(is_train=False, data=x)[0] for ex in (card, cpu)]
    gaps.append({"predict": gap(*pred)})
    bad = False
    try:
        card.backward()
    except mx.MXNetError:
        bad = True
    return {"steps": g["exec_steps"],
            "worst_gap": max(v for s in gaps for v in s.values()),
            "gaps": gaps, "misses": card._misses, "hits": card._hits,
            "captures": card._captures,
            "aux_in_place": card.aux_dict["bn_moving_mean"]._data.data_ptr()
            == aux_ptr, "backward_without_forward_raises": bad}


def phase_graph_semantics(torch, seed):
    """CUDA-graph semantics of a hybridized block, the Executor and the
    engine on the card (see GRAPH)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.serving import InferenceEngine
    g = GRAPH
    gpu = mx.gpu(0)
    mx.random.seed(seed)
    rng = np.random.RandomState(seed)

    def batch():
        return mx.nd.array(rng.randn(g["batch"], g["units_in"]).astype(
            np.float32), ctx=gpu)

    net = _graph_block(mx, True)
    twin = _graph_twin(mx, net, True)
    net.hybridize(static_alloc=True, static_shape=True)
    stats = [[b[1]._reg_params[n].data() for n in ("running_mean",
                                                   "running_var")]
             for b in (net, twin)]
    masks, keep, stat_gaps, advanced, outs = [], [], [], [], []
    before = [s._data.clone() for s in stats[0]]
    for _ in range(g["calls"]):
        x = batch()
        with autograd.record():
            out = net(x)
            twin(x)
            loss = out.sum()
        loss.backward()
        outs.append((out, out._data.clone()))
        m = out._data != 0
        masks.append(m)
        keep.append(m.float().mean().item())
        stat_gaps.append(max(_rel_gap(a, b) for a, b in zip(*stats)))
        advanced.append(all(not torch.equal(s._data, b)
                            for s, b in zip(stats[0], before)))
        before = [s._data.clone() for s in stats[0]]
    sigma4 = 4 * math.sqrt(0.25 / masks[0].numel())
    held = all(torch.equal(o._data, c) for o, c in outs)
    op = net._cached_op
    record_misses, record_captures = op._misses, op._captures

    # predict: an output held from a replay, set_data, a cast that rebinds
    x1, x2 = batch(), batch()
    net(x2)
    p1 = net(x1)
    p1_copy = p1._data.clone()
    net(x2)
    predict_held = torch.equal(p1._data, p1_copy)
    captures = op._captures
    for b in (net, twin):
        w = b[0]._reg_params["weight"]
        w.set_data(w.data() * 0.5)
    set_data_gap = _rel_gap(net(x1), twin(x1))
    set_data_captures = op._captures - captures
    for b in (net, twin):
        b.cast("float16")
        b.cast("float32")
    cast_gap = _rel_gap(net(x1), twin(x1))
    net(x2)
    cast_captures = op._captures - captures - set_data_captures

    # the backward graph, without Dropout: gradients against the eager copy
    nb = _graph_block(mx, False)
    tb = _graph_twin(mx, nb, False)
    nb.hybridize()
    grad_gaps = []
    for _ in range(g["calls"]):
        x = batch()
        for b in (nb, tb):
            with autograd.record():
                loss = (b(x) ** 2).mean()
            loss.backward()
        grad_gaps.append(max(_rel_gap(p.grad(), q.grad()) for p, q in zip(
            nb.collect_params().values(), tb.collect_params().values())
            if p.grad_req != "null"))

    # the engine: one graph per rung, each against the eager block
    eng = InferenceEngine(nb, input_spec=[((g["units_in"],), "float32")],
                          max_batch=8)
    eng.warmup()
    warm = dict(eng.cache_stats)
    rung_gaps = {}
    for b in eng.ladder:
        xb = mx.nd.array(rng.randn(b, g["units_in"]).astype(np.float32),
                         ctx=gpu)
        rung_gaps[b] = _rel_gap(eng.predict(xb), nb._eager_forward(xb))
    ex = _graph_executor(torch, mx, seed)

    out = {"phase": "graph_semantics", "batch": g["batch"],
           "keep_fraction": keep, "keep_4sigma": sigma4,
           "masks_differ": [not torch.equal(masks[i], masks[i + 1])
                            for i in range(len(masks) - 1)],
           "stat_gaps": stat_gaps, "stats_advanced": advanced,
           "record_misses": record_misses,
           "record_captures": record_captures,
           "set_data_captures": set_data_captures,
           "set_data_gap": set_data_gap, "cast_captures": cast_captures,
           "cast_gap": cast_gap, "grad_gaps": grad_gaps,
           "engine_cache": {k: warm[k] for k in ("entries", "misses",
                                                  "hits")},
           "engine_captures": eng._op._captures, "rung_gaps": rung_gaps,
           "executor": ex, "tolerance": {
               k: g[k] for k in ("rel", "exec_rel", "exec_abs")}}
    out["gates"] = {
        "masks_differ": all(out["masks_differ"])
        and not torch.equal(masks[0], masks[-1]),
        "masks_keep_half": all(abs(k - (1 - g["rate"])) <= sigma4
                               for k in keep),
        "stats_advance_as_eager": all(advanced)
        and max(stat_gaps) <= g["rel"],
        "held_outputs_unchanged": held and predict_held,
        "record_entry_captured_once": record_misses == 1
        and record_captures == 1,
        "set_data_no_capture": set_data_captures == 0
        and set_data_gap <= g["rel"],
        "cast_captures_once": cast_captures == 1 and cast_gap <= g["rel"],
        "backward_graph_grads": max(grad_gaps) <= g["rel"],
        "engine_rungs": warm["misses"] == warm["entries"] == 4
        and eng._op._captures == 4
        and max(rung_gaps.values()) <= g["rel"],
        "executor": ex["worst_gap"] <= 1.0
        and ex["misses"] == ex["captures"] == 2 and ex["aux_in_place"]
        and ex["backward_without_forward_raises"]}
    out["ok"] = all(out["gates"].values())
    emit(out)
    check(out["ok"], f"graph_semantics failed: {out['gates']}")


# ---------------------------------------------------------------------------
# slice 13: CompiledTrainStep as one CUDA graph
# ---------------------------------------------------------------------------
# A small net (Dense 64 -> 256, BatchNorm, Dropout(0.5) on its own
# generator, Dense 256 -> 10; fp32, TF32 off) through CompiledTrainStep's
# graph beside a twin from the same weights and generator seed that runs
# the step's eager path, over TSG["steps"] batches of 64: SGD (momentum,
# wd) under FactorScheduler(step=1, factor=0.7), so every step has its
# own lr, and Adam, whose bias correction reads every step's count.  After
# each step every tensor (parameters, moving statistics, optimizer
# states) must be the twin's bit for bit, else within TSG["rel"] of its
# largest |value|; the moving statistics must move at every step; the
# dropout generator must end where the twin's does; and a third copy
# whose dropout stream restarts at every step (the same mask each step,
# what a replay without the generator registered would draw) must end
# far from the graph (more than 100 x TSG["rel"]): each replay drew fresh
# masks.  The optimizer's counts must equal the twin's.  One capture for
# the first batch size, one more for a second (batch 32), one more after
# a rebinding cast (fp16 and back, on both copies).  MultiStepTrainStep
# at K = 4 must equal 4 single steps (both through graphs) bit for bit;
# remat=True must equal remat=False within TSG["rel"] over 3 steps, or
# raise MXNetError naming its ROADMAP item.
TSG = dict(batch=64, batch2=32, units_in=64, units=256, classes=10,
           rate=0.5, steps=5, k=4, remat_steps=3, rel=1e-5)


def _tsg_net(seed):
    """The small net on the card, weights from ``seed``, its Dropout
    drawing from a generator seeded ``seed + 1``."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.initializer import initialize
    from mxnet_tpu_torch.random import generator
    net = nn.HybridSequential(prefix="tsg_")
    with net.name_scope():
        net.add(nn.Dense(TSG["units"], in_units=TSG["units_in"],
                         device="cuda"),
                nn.BatchNorm(in_channels=TSG["units"], device="cuda"),
                nn.Dropout(TSG["rate"], generator=generator(seed + 1,
                                                            "cuda")),
                nn.Dense(TSG["classes"], in_units=TSG["units"],
                         device="cuda"))
    initialize(net, generator(seed, "cuda"))
    return net


def _tsg_step(net, opt_name, cls=None, **kwargs):
    from mxnet_tpu_torch import lr_scheduler, optimizer
    from mxnet_tpu_torch.executor import CompiledTrainStep
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    if opt_name == "sgd":
        opt = optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, wd=1e-4,
            lr_scheduler=lr_scheduler.FactorScheduler(step=1, factor=0.7))
    else:
        opt = optimizer.create("adam", learning_rate=0.01)
    return (cls or CompiledTrainStep)(net, SoftmaxCrossEntropyLoss(), opt,
                                      **kwargs)


def phase_train_step_graphs(torch, seed):
    """CompiledTrainStep's CUDA-graph semantics on the card (see TSG)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.executor import MultiStepTrainStep, stack_batches
    g = TSG
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)

    def batch(n):
        x = torch.randn(n, g["units_in"], generator=gen, device="cuda")
        y = torch.randint(0, g["classes"], (n,), generator=gen,
                          device="cuda").float()
        return x, y

    batches = [batch(g["batch"]) for _ in range(g["steps"])]
    x2, y2 = batch(g["batch2"])
    ok_rel = lambda gap: gap["worst_rel"][0] <= g["rel"]
    runs = {}
    for opt_name in ("sgd", "adam"):
        net, twin, stale = (_tsg_net(seed) for _ in range(3))
        step = _tsg_step(net, opt_name)
        ref = _tsg_step(twin, opt_name)
        old = _tsg_step(stale, opt_name)
        gaps, moved, lrs = [], [], []
        for x, y in batches:
            before = net[1].running_mean.clone()
            lrs.append(step._lr_at(0))
            step(x, y)
            ref._eager((x,), y)
            stale[2].generator.manual_seed(seed + 1)
            old._eager((x,), y)
            moved.append(not torch.equal(net[1].running_mean, before))
            gaps.append(_gap(torch, _snapshot(step), _snapshot(ref)))
        stale_gap = _gap(torch, _snapshot(step), _snapshot(old))
        same_stream = torch.equal(net[2].generator.get_state(),
                                  twin[2].generator.get_state())
        counts = (step._opt.num_update == ref._opt.num_update
                  and step._opt._index_update_count
                  == ref._opt._index_update_count)
        first = (step._misses, step._captures, step._replays)
        step(x2, y2)
        ref._eager((x2,), y2)
        batch2_gap = _gap(torch, _snapshot(step), _snapshot(ref))
        second = (step._misses, step._captures)
        for b in (net, twin):
            b.cast("float16")
            b.cast("float32")
        x, y = batches[0]
        step(x, y)
        ref._eager((x,), y)
        cast_gap = _gap(torch, _snapshot(step), _snapshot(ref))
        runs[opt_name] = {
            "lrs": lrs, "gaps": gaps, "stats_moved": moved,
            "stale_mask_gap": stale_gap, "stream_as_eager": same_stream,
            "counts_as_eager": counts, "num_update": step._opt.num_update,
            "misses_captures_replays": first,
            "after_batch2": second, "batch2_gap": batch2_gap,
            "cast_captures": step._captures - second[1],
            "cast_gap": cast_gap}
        del net, twin, stale, step, ref, old

    # MultiStepTrainStep at K = 4 against 4 single steps, both as graphs
    nets = [_tsg_net(seed) for _ in range(2)]
    multi = _tsg_step(nets[0], "adam", MultiStepTrainStep)
    single = _tsg_step(nets[1], "adam")
    sx, sy = stack_batches(batches[:g["k"]])
    losses = multi(sx, sy)
    ref_losses = torch.stack([single(x, y) for x, y in batches[:g["k"]]])
    multi_gap = _gap(torch, _snapshot(multi), _snapshot(single))
    multistep = {"k": g["k"], "losses_equal": torch.equal(losses, ref_losses),
                 "gap": multi_gap, "captures": multi._captures,
                 "replays": multi._replays}
    del nets, multi, single

    # remat=True against remat=False
    nets = [_tsg_net(seed) for _ in range(2)]
    plain = _tsg_step(nets[0], "adam")
    try:
        rm = _tsg_step(nets[1], "adam", remat=True)
        for x, y in batches[:g["remat_steps"]]:
            plain(x, y)
            rm(x, y)
        remat = {"raised": None,
                 "gap": _gap(torch, _snapshot(rm), _snapshot(plain)),
                 "captures": rm._captures}
    except mx.MXNetError as e:
        remat = {"raised": str(e)[:300]}
    del nets, plain

    out = {"phase": "train_step_graphs", "batch": g["batch"],
           "runs": runs, "multistep": multistep, "remat": remat,
           "tolerance": {"rel": g["rel"]}, "tf32": _tf32(torch)}
    gates = {}
    for name, r in runs.items():
        gates[name] = {
            "each_step_as_eager": all(ok_rel(gp) for gp in r["gaps"]),
            "lr_per_step": name != "sgd" or len(set(r["lrs"])) == g["steps"],
            "stats_move": all(r["stats_moved"]),
            "fresh_masks": r["stream_as_eager"]
            and r["stale_mask_gap"]["worst_rel"][0] > 100 * g["rel"],
            "counts_as_eager": r["counts_as_eager"],
            "one_capture_per_signature":
            r["misses_captures_replays"] == (1, 1, g["steps"] - 1)
            and r["after_batch2"] == (2, 2) and ok_rel(r["batch2_gap"]),
            "cast_captures_again": r["cast_captures"] == 1
            and ok_rel(r["cast_gap"])}
    gates["multistep_bitwise"] = multistep["losses_equal"] and \
        multi_gap["bitwise_equal"] == multi_gap["tensors"] and \
        multistep["captures"] == 1
    gates["remat"] = (ok_rel(remat["gap"]) and remat["captures"] == 1
                      if remat["raised"] is None
                      else "ROADMAP" in remat["raised"])
    out["gates"] = gates
    out["ok"] = all(v if isinstance(v, bool) else all(v.values())
                    for v in gates.values())
    emit(out)
    check(out["ok"], f"train_step_graphs failed: {gates}")


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


PHASES = ("build", "device", "graph_semantics", "train_step_graphs",
          "flash", "flash_timing",
          "fused",
          "fused_timing", "model_parity", "serving",
          "resnet_parity", "training", "gluon_training", "serving_bert",
          "serving_resnet_export", "module_fit", "dist_training",
          "rtc_kernels", "rtc_ffn", "bert_flash", "bert_parity",
          "bert_training")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", default=",".join(PHASES),
                        help="comma-separated phases to run (default: all)")
    parser.add_argument("--dist-worker", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--dist-out", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.dist_worker:
        return dist_worker(args.seed, args.dist_out)
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
    if "graph_semantics" in only:
        phase_graph_semantics(torch, args.seed)
    if "train_step_graphs" in only:
        phase_train_step_graphs(torch, args.seed)
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
        # launches: this slice's path (CompiledTrainStep's graph) when it
        # ran, else the Gluon loop's
        line = _kernel_line(
            "fused_conv_bn_stats",
            "mxnet_tpu_torch/csrc/fused_conv_bn_wgmma.cu",
            "mxnet_tpu/ops/fused_conv_bn.py:48",
            by_path.get("training", by_path.get("gluon_training")), fused)
        line["launches_by_path"] = by_path
        lines.append(line)
    bert_paths = {}
    if "serving_bert" in only:
        bert_paths["serving_bert"] = phase_serving_bert(torch, args.seed)
    if "serving_resnet_export" in only:
        phase_serving_resnet_export(torch, args.seed)
    if "module_fit" in only:
        bert_paths["module_fit"] = phase_module_fit(torch, args.seed)
    if "dist_training" in only:
        bert_paths["dist_training"] = phase_dist_training(torch, args.seed)
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
        bert_paths["bert_training"] = phase_bert_training(torch, args.seed)
    if bert_paths and "bert_flash" in only:
        # launches: this slice's path (bert_training, through
        # CompiledTrainStep's graph) when it ran, else the latest earlier
        # slice's
        main_path = next((bert_paths[k] for k in ("bert_training",
                                                   "module_fit",
                                                   "serving_bert")
                          if k in bert_paths),
                         bert_paths.get("dist_training", [0])[0])
        line = _kernel_line("flash_fwd_bert",
                            "mxnet_tpu_torch/csrc/flash_fwd_tf32.cu",
                            "mxnet_tpu/ops/attention.py:51", main_path,
                            bert_timing)
        line["launches_by_path"] = bert_paths
        line["shape"], line["dtype"] = BERT_FLASH, "float32"
        line["simt_ms"] = bert_timing["simt_ms"]
        lines.append(line)
    emit({"kernels": lines})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
