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
- serving over HTTP (slice 14): one ``ModelServer`` serves the full-width
  BERT-base of ``serving_bert`` and the llama_7b of ``serving`` (dense
  engine, and a paged twin on the same weights) through ``start_http``,
  driven through ``Client(url)`` and raw urllib: every rung's answer over
  the socket bit for bit the in-process one, 24 concurrent requests from
  8 threads within ``SERVE["card_rel"]``, ``/generate`` and SSE tokens
  equal to in-process ``generate``, the flash launches over the HTTP
  traffic alone (12 fp32 tensor-core per BERT forward, 32 bf16 ``wgmma``
  per llama forward, no other variant); a fault plan on the ``execute``
  site opens the BERT breaker (500s, ``/ping`` DEGRADED, 503 with
  ``retry_after_s``) while llama serves, a probe after the cooldown closes
  it; a dropped SSE connection cancels its request; ``/metrics`` parses
  as Prometheus 0.0.4 and OpenMetrics with the request counters equal to
  the requests sent; ``/goodput``'s buckets reconcile with the wall; the
  memory ledger names the page pool and host buffers; ``stop()`` answers
  every accepted request while ``/ping`` reads DRAINING.  It prints rows/s
  and p50/p99 over the socket beside in process, JSON ms per request and
  tokens/s, each with the card's name and power limit
  (``serving_http``).
- training that survives faults (slice 15): full-width BERT-base (fp32,
  seq 128, batch 64, Adam, dropout 0.1) through ``CompiledTrainStep``'s
  graph, one net whose initial weights and random streams are written
  back before each run: two health-off runs (bit for bit?), a copy /
  2 replays / restore / 2 replays probe of the random streams, health
  watchpoints at ``every=1`` against off (the state, the first grad norm
  against an eager autograd pass, 12 fp32 tensor-core flash launches per
  forward), step ms off / ``every=16`` / ``every=1`` with the pool bytes,
  ``FaultTolerantStep`` under transient ``execute`` faults, an
  ``AsyncCheckpointer`` every 4 steps with a resume into a BERT-base from
  another seed, a truncated and a manifest-less checkpoint, a
  ``NumericsFaultPlan`` on encoder layer 6's ``ffn2`` (``bwd:nan`` and
  ``fwd:inf`` raised and localized, ``bwd:nan`` skipped), and the goodput
  records' reconciliation (``resilient_training``); ``dist_training``
  ends with two divergence-checksum rounds, the second after rank 1
  moved one weight by one ulp.
- the input pipeline (slice 16): full-width resnet50_v1 (fused fp32,
  batch 256, CompiledTrainStep's graph) fed from a RecordIO file of 1024
  JPEGs written from the seed, through ``ImageRecordIter`` (the native
  reader, 4 decode threads, random crop and mirror) and
  ``DevicePrefetchIter`` (a pinned ring, copies on a side CUDA stream):
  every staged batch equal to its host batch, one unshuffled epoch bit for
  bit against a twin fed the same host batches with a plain ``.to()``,
  4 epochs with the fused kernel's 36 launches per step counted, the
  goodput ledger's ``input_wait`` against ``stats()``, the copies' stream
  against the step's under ``torch.profiler``, and step ms fed by the
  prefetcher, synchronously and from a resident batch
  (``input_pipeline``); ``module_fit`` adds a fit over a host
  ``NDArrayIter`` with ``prefetch_to_device=True``, bit for bit against
  the fit over the on-card iterator; the deterministic Embedding backward
  (``csrc/embedding_bwd.cu``, C12) is held against its plain version at
  BERT-base's shapes and run twice for the same bits
  (``embedding_bwd``), and ``resilient_training``'s baseline pair runs
  with the default algorithms, bit for bit.
- speculative decoding and generation warmup (slice 17): both generation
  engines run through the port's ``CachedOp``, so ``serving`` and
  ``serving_http`` warm them (``register_generation(warmup=True)``: each
  signature's CUDA graph captured before traffic) and gate that the
  traffic replays them with no new entry; ``speculative`` holds
  speculation (4 draft tokens a round) to plain paged decode at llama_7b's
  width with 4 layers in fp32, token for token or at a near-tie, with the
  target as its own draft and with a random 1-layer one, then serves the
  ``serving`` phase's llama_7b behind ``ModelServer`` unwarmed, warmed
  plain, speculative with itself as draft and with a TinyLlama-1.1B-shaped
  draft: the warmup's captures, seconds and graph pool, tokens/s,
  acceptance and agreement with plain paged, warmed tokens bit for bit
  the unwarmed ones, and a ``torch.profiler`` trace of 16 warmed decode
  steps (busy share, device ms by GEMM, elementwise and other).
- the fleet (slice 18, ``fleet``): (a) llama_7b at its full width and 8
  of its 32 layers (the depth cut since slice 23) behind a
  ``fleet.Router`` over in-process ModelServers sharing its weights: one mixed replica, then one prefill and two decode replicas
  (each paged and warmed for its role), the 4 prompts, then the longest
  alone; tokens/s,
  first-token ms, each K/V handoff's bytes and the ms of its gather,
  encode, wire (both JSON hops, the Router's included), decode and pool
  write, the prefix-routed count, and no new CachedOp entry on any
  replica; tokens held to the mixed replica's under the bf16 noise.
  (b) llama_7b's width at 4 layers in fp32 through the Router:
  disaggregation, prefix affinity, migration with a snapshot (the serving
  replica stopped) and without (a ``relay`` fault), a hedged first token,
  ``rolling_restart`` under load and a client's disconnect, every stream
  token for token one scheduler's greedy decode.  (c)
  ``tools/chaos_torch.py`` over two ``tools/serve_torch.py`` children of
  (b)'s model, 2 seeded SIGKILLs with the supervisor armed.  (d)
  ``serving_bert``'s BERT-base behind two replicas' ``/predict`` and
  (a)'s llama_7b's dense engine behind two replicas' ``/generate``,
  through the Router: the flash kernels' launches on that path, each held
  against its plain version.
- the vision zoo and the Estimator (slice 19): ``vision_zoo`` builds 8
  zoo models through ``get_model`` at their published widths (1000
  classes, 224 px, Inception 299 px), holds each hybridized forward at
  batch 32 to the eager one and its export, imported, to the block, and
  trains 5 at batch 64 through ``CompiledTrainStep``'s graph beside
  their eager twins; ``estimator`` runs ``Estimator.fit`` on fused
  resnet50_v1 (batch 256) over a ``DataLoader`` with prefetch, health,
  handlers and two injected faults, at ``steps_per_call`` 1 and 2, each
  bit for bit a bare ``CompiledTrainStep`` loop, with 36 fused launches
  a step.
- every optimizer (slice 20, ``optimizers``): full-width BERT-base (fp32)
  with LAMB and with AdamW, and fused resnet50_v1 (batch 256) with LARS,
  through ``CompiledTrainStep``'s graph for 3 + 5 steps, each bit for bit
  its eager twin after every step, with 12 fp32 tensor-core flash
  launches a forward, 2 Embedding backward launches a BERT step and 36
  conv-BN launches a ResNet step; step ms beside Adam on the same BERT
  and SGD with momentum on the same ResNet; then all 17 registered
  optimizers (and SGD and NAG under ``multi_precision`` on fp16) on a
  small Dense/BatchNorm net, 4 graph steps bit for bit their eager twin,
  SGLD's replays drawing fresh N(0, lr) noise.
- the rest of the ops and the fused RNN layers (slice 21, ``ops_rnn``):
  every op the slice registered but the samplers on the card against the
  same op on the CPU, forward and gradient (the ordering ops over
  llama_7b's logits in fp32 and bf16, ``masked_softmax`` at BERT-base's
  scores, ``rope`` at llama_7b's width, ``_backward_gather_nd`` with
  duplicates twice for the same bits), the fused LSTM's cuDNN calls fed
  from the packed parameters without a copy, the samplers' moments over
  10^6 draws, fresh draws on every graph replay, ``boolean_mask``
  refused under capture; then Zaremba et al.'s large LSTM language model
  (2 x 1500, vocabulary 10000, [35, 20] windows, dropout 0.65) through
  the Gluon loop eagerly and hybridized, bit for bit at dropout 0, the
  loss falling at 0.65, with the Embedding backward kernel's launches
  counted (``embedding_bwd`` holds the kernel to its plain version at
  the encoder's [35, 20] ids into [10000, 1500] too); and unfused
  resnet50_v1 (batch 64) forward and a graph step under
  ``MXNET_TPU_CONV_LAYOUT`` NCHW and NHWC, TF32 off and on.
- NDArray and autograd, the rest (slice 22, ``ndarray_rest``): an image
  user's fine-tune loop, ``mx.image.ImageIter`` over 512 JPEGs through
  ``CreateAugmenter`` into full-width fused resnet50_v1 (batch 256)
  under a ``CustomOp`` softmax head (``mx.nd.Custom``), its first 2 steps
  held against a twin with ``SoftmaxCrossEntropyLoss`` and 36 fused
  launches a step; a WGAN-GP critic step (``autograd.grad(...,
  create_graph=True)``) on dcgan.py's discriminator against the CPU; every
  linalg, image, control-flow and index op on the card against the CPU,
  the control flow also captured in a hybridized block; a DLPack write
  alias; and the host cost of ``get_symbol``'s op notes on the LSTM LM's
  eager window.
- AMP and the kernel registry (slice 23, ``amp``): full-width BERT-base
  (batch 64, seq 128, Adam) through MXNet's AMP loop under
  ``amp.init("float16")`` (``init_trainer``, ``scale_loss``,
  ``Trainer.step``) on the flash kernel's fp16 route, 12 launches a
  forward, held to a twin of the same size on the card that runs the
  plain versions (registered through the kernel registry at priority
  99): the loss-scale and skip sequence, the losses, and the first
  update's gradients, whose limit two perturbed twins bracket; the same
  model under ``amp.init("bfloat16")`` through ``CompiledTrainStep``'s
  graph, bit for bit its eager twin, on the bf16 wgmma route; full-width
  fused resnet50_v1 (224 px, batch 256) through the AMP loop under fp16,
  36 conv-BN launches a step on fp32 inputs, the convolutions in fp16,
  held the same way to a full-size twin on the card, with the 4 steps'
  update gap beside a perturbed twin's and an fp32 pair's; then the
  kernel registry on the card (a user kernel claiming only the fp16
  calls, ``MXNET_KERNEL_BACKEND=torch`` refused on a CUDA tensor) and the
  config layer's card values.  Each step ms beside the same model's fp32
  step.

Each phase prints one JSON line; any failed phase ends the run with a
non-zero exit code.  ``--only a,b`` runs only the named phases (build,
device, graph_semantics, train_step_graphs, flash (or kernels),
flash_timing, fused, fused_timing, model_parity, serving,
resnet_parity, training, gluon_training, input_pipeline, vision_zoo,
estimator, optimizers, ops_rnn, ndarray_rest, amp, serving_bert,
serving_http, speculative, fleet, serving_resnet_export, module_fit,
dist_training, rtc_kernels, rtc_ffn, bert_flash, bert_parity,
bert_training, embedding_bwd, resilient_training), for a short call while
a kernel is brought up; ``--only build,amp,kernels,flash_timing`` runs
slice 23 (the fp16 flash cases, the amp phase and the fp16 route's
kernel line; add ``fused_timing`` for B1's line);
``--only build,ndarray_rest,fused_timing``
runs slice 22 with its kernel line; ``--only build,ops_rnn`` runs slice 21 (add
``embedding_bwd`` for the kernel line whose launches it counts);
``--only build,serving_bert,fleet`` runs
slice 18 (``fleet`` builds its 8-layer llama_7b, and BERT-base when
``serving_bert`` did not run); ``--only build,optimizers`` runs slice 20 (add ``bert_flash``,
``fused_timing`` and ``embedding_bwd`` for the kernel lines whose
launches it counts); ``--only build,vision_zoo,estimator`` runs slice 19 (add
``fused_timing`` for the kernel line); ``--only build,serving,speculative`` runs slice 17
(``speculative`` needs ``serving``, whose llama_7b it reuses); ``--only
build,input_pipeline,module_fit`` runs slice 16; ``--only
build,gluon_training`` runs just the Gluon loop,
``--only build,train_step_graphs`` the training step's graph semantics
(``--only build,train_step_graphs,training,bert_training`` this slice
with its full-width runs), ``--only
build,serving_bert,serving_resnet_export`` the serving phases,
``--only build,serving,serving_bert,serving_http`` the HTTP slice,
``--only build,module_fit`` the Module loop, ``--only
build,dist_training`` the two-rank job and ``--only
build,resilient_training,dist_training`` slice 15.  The line before the last is the kernel table; the
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
import contextlib
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
                (1, 4, 64, 36), (1, 4, 64, 30), (64, 12, 128, 64)]
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
       "bfloat16": {"o": 2e-2, "lse": 1e-4},
       "float16": {"o": 2e-2, "lse": 1e-4}}
BF16_O_REL = 2.0 ** -8
BF16_O_ABS = 1e-5
# fp16 (amp.init("float16"), the wgmma kernel's fp16 route and the CUDA
# cores for D % 8 != 0) is held the same way, to half an fp16 ulp:
# |o - ref| <= 2^-11 |ref| + 1e-5.  Every FLASH_SHAPES case runs in fp16 too:
# [64, 12, 128, 64] non-causal is BERT-base's attention under amp,
# [4, 32, 2048, 128] causal the timed shape, D = 36 and 30 the CUDA cores.
HALF_O_REL = {"bfloat16": BF16_O_REL, "float16": 2.0 ** -11}
FP16_BERT = (64, 12, 128, 64)

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
# once), fp16 y likewise within half an fp16 ulp, 2^-11 |ref| + 1e-5; the
# statistics of each column within 1e-5 of its sum of |y| and of its sum of
# y^2 (800k-row sums taken in other orders).  fp16 runs at every shape and
# mode too (slice 24), and once with a column past 65504: y must be inf
# exactly where the plain version's rounding is, the statistics finite.
FUSED_TOL = {"y_fp32_rel": 1e-4, "y_bf16_rel": 2.0 ** -8,
             "y_fp16_rel": 2.0 ** -11, "y_bf16_abs": 1e-5, "stats_rel": 1e-5}

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
# Speculative decoding (slice 17), 4 draft tokens a round.  The exact gate
# runs llama_7b's width at 4 layers in fp32 with TF32 off, where plain paged
# decode and speculation may part only at a near-tie: the plain run's top-2
# margin at the first divergence must be below near_tie_rel of its largest
# |logit| (fp32 products of [4, 5] and [4, 1] rows round apart by ~1e-6 of
# it after 4 layers).  The full-width runs trace trace_steps warmed decode
# steps of the plain paged engine.
SPEC = dict(spec_tokens=4, exact_layers=4, near_tie_rel=1e-4, trace_steps=16)
# The draft of the full-width run: TinyLlama-1.1B's published geometry
# (TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T, config.json:
# vocab 32000, hidden 2048, intermediate 5632, 22 layers, 32 heads, 4 KV
# heads, untied head, 2048 positions), random weights from the seed.
TINYLLAMA = dict(vocab_size=32000, units=2048, hidden=5632, num_layers=22,
                 num_heads=32, num_kv_heads=4, tie_embeddings=False,
                 max_length=2048)


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


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device(torch):
    line = _card()
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
    """Every FLASH_SHAPES case, fp32, bf16 and fp16, causal and not, once
    on the kernel _flash_variant picks, against the plain version in
    fp32."""
    from mxnet_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = []
    for (b, h, s, d) in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for causal in (False, True):
                q, k, v = (torch.randn(b * h, s, d, generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(3))
                scale = 1.0 / math.sqrt(d)
                before = (A.flash_fwd_wgmma_launches,
                          A.flash_fwd_tf32_launches,
                          A.flash_fwd_wgmma_fp16_launches)
                o, lse = A.flash_fwd(q, k, v, causal, scale)
                # the wgmma kernel counts bf16 and fp16 apart
                ran_wgmma = (A.flash_fwd_wgmma_launches - before[0]
                             + A.flash_fwd_wgmma_fp16_launches - before[2]
                             == 1)
                ran_own_count = (
                    (A.flash_fwd_wgmma_fp16_launches - before[2] == 1)
                    == (dtype == torch.float16 and ran_wgmma))
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
                if dtype != torch.float32:
                    # 1 at the half-ulp bound; above 1 fails the case
                    case["o_half_ulp_ratio"] = ((o.float() - ro).abs() / (
                        HALF_O_REL[name] * ro.abs() + BF16_O_ABS)
                        ).max().item()
                if dtype == torch.bfloat16:
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
                              and ran_own_count
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
    the CUDA-core kernel at the timed shape as the earlier figure; then
    the kernel's fp16 route the same way at BERT-base's shape under amp
    (non-causal) and at the timed shape.  Returns the bf16 timed figures
    and the fp16 ones at BERT-base's shape."""
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
    fp16 = {}
    for key, (b, h, s, d), causal in (("bert", FP16_BERT, False),
                                      ("timed", FLASH_TIMED, True)):
        q, k, v = (torch.randn(b * h, s, d, generator=gen, device="cuda",
                               dtype=torch.float16) for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        o, _ = A.flash_fwd(q, k, v, causal, scale)
        ro, _ = A._flash_forward_plain(q.float(), k.float(), v.float(),
                                       causal, scale)
        err = (o.float() - ro).abs().max().item()
        del o, ro
        q4, k4, v4 = (t.view(b, h, s, d) for t in (q, k, v))
        fns = {"kernel": lambda: A.flash_fwd(q, k, v, causal, scale),
               "plain": lambda: A._flash_forward_plain(q, k, v, causal,
                                                       scale),
               "library": lambda: sdpa(q4, k4, v4, is_causal=causal,
                                       scale=scale)}
        best, runs = _in_turns(torch, fns)
        bound, bound_by = flash_bound_ms(b, h, s, d, causal, 2)
        fp16[key] = {"shape": [b, h, s, d], "causal": causal,
                     "variant": A._flash_variant(torch.float16, d),
                     "max_abs_err": err, "ms": best["kernel"],
                     "plain_ms": best["plain"],
                     "library_ms": best["library"], "bound_ms": bound,
                     "bound_by": bound_by,
                     "split_p_bound_ms": flash_bound_ms(
                         b, h, s, d, causal, 2, 1.5)[0],
                     "runs_ms": runs}
        del q, k, v, q4, k4, v4
    out["float16"] = fp16
    emit({"phase": "kernel_timing", "ok": True, "flash_fwd": out})
    return out["timed"], fp16["bert"]


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


def _gen_graphs(torch, sched):
    """The generation scheduler's CachedOp entries (target or dense, and
    the draft's), their captures and replays, and their graph pools' GB."""
    ops = ([sched._target._op] + ([sched._draft._op] if sched._draft else [])
           if sched.paged else [sched._op])
    return {"entries": sum(len(op._cache) for op in ops),
            "captures": sum(op._captures for op in ops),
            "replays": sum(op._replays for op in ops),
            "pool_gb": sum(_pool_bytes(torch, op._pool) for op in ops
                           if op._pool is not None) / 1e9}


def phase_serving(torch, seed):
    """llama_7b (bf16, 32 layers) on both generation engines behind
    ModelServer, each warmed over prompts up to max(PROMPTS) first (its
    CUDA graphs captured), then 4 prompts of 16 tokens through replays.
    Returns (wgmma launches of the dense run, the model, wgmma launches per
    dense forward)."""
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
    warm = {}
    with ModelServer() as server:
        for name, paged in (("llama_dense", {"kv_cache": False}),
                            ("llama", {"kv_cache": True, "page_tokens": 16,
                                       "prefix_cache": True})):
            t = time.perf_counter()
            sched = server.register_generation(
                name, model, max_slots=4, warmup=True,
                warmup_prompt_len=max(PROMPTS), **paged)
            torch.cuda.synchronize()
            warm[name] = {"seconds": time.perf_counter() - t,
                          **_gen_graphs(torch, sched)}
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
                         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "warmup": warm[name],
                         "graphs_after": _gen_graphs(
                             torch, server._generators[name].scheduler)}
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
        # every signature was captured at warmup; the traffic replayed it
        "warmed_no_new_entries": all(
            out[n]["graphs_after"]["entries"] == warm[n]["entries"]
            == warm[n]["captures"] == out[n]["graphs_after"]["captures"]
            and out[n]["graphs_after"]["replays"] > 0 for n in tokens),
    }
    out["gates"] = gates
    out["ok"] = all(gates.values())
    emit(out)
    del server, sched
    gc.collect()
    torch.cuda.empty_cache()
    check(out["ok"], f"serving gates failed: {gates}")
    return wgmma["llama_dense"], model, out["launches_per_dense_forward"]


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
        rel = FUSED_TOL["y_fp16_rel" if x.dtype == torch.float16
                        else "y_bf16_rel"]
        case["y_err_ratio"] = (d / (rel * ry.abs()
                                    + FUSED_TOL["y_bf16_abs"])).max().item()
    case["variant"] = {(1, 1): "wgmma", (1, 0): "simt"}.get(ran, str(ran))
    case["ok"] = all(case[r] <= 1.0 for r in
                     ("y_err_ratio", "sum_err_ratio", "sumsq_err_ratio"))
    return case


def _fused_overflow_case(torch, FC, gen):
    """fp16 at FUSED_TIMED with one column of w scaled by 2^17 so most of
    its y passes 65504: y inf exactly where the plain version's single
    rounding puts it, finite y within half an fp16 ulp plus 1e-5 of its
    column's RMS (the fp32 summation order, at the column's scale), the
    statistics (of the fp32 accumulator) finite and within their
    gates."""
    m, k, n = FUSED_TIMED
    x, w, _, _ = _fused_inputs(torch, gen, m, k, n, torch.float16, False)
    w = w.t().contiguous()
    w[5] = w[5] * 131072.0
    w = w.t()
    y, s1, s2 = FC.fused_matmul_bn_stats(x, w)
    ry, r1, r2 = FC._reference_conv1x1(x.float(), w.float(), None, None,
                                       False)
    ref16 = ry.half()
    finite = torch.isfinite(ref16)
    # the fp32 summation-order slack scales with each column's size: the
    # scaled column's terms are ~1e4, and its sums cancel to O(1) values
    scale = ry.square().mean(dim=0).sqrt()
    ratio = torch.where(finite, (y.float() - ry).abs() / (
        FUSED_TOL["y_fp16_rel"] * ry.abs()
        + FUSED_TOL["y_bf16_abs"] * scale[None, :]), torch.zeros_like(ry))
    at = divmod(int(ratio.argmax()), n)
    out = {"shape": [m, k, n], "dtype": "float16", "mode": "overflow",
           "inf_count": int((~finite).sum()),
           "inf_match": bool(torch.equal(torch.isinf(y), ~finite)),
           "stats_finite": bool(torch.isfinite(s1).all()
                                and torch.isfinite(s2).all()),
           "y_err_ratio": ratio.max().item(),
           "worst_at": {"row": at[0], "col": at[1],
                        "y": float(y[at]), "ref": float(ry[at])},
           "sum_err_ratio": ((s1 - r1).abs() / ry.abs().sum(0)).max().item()
           / FUSED_TOL["stats_rel"],
           "sumsq_err_ratio": ((s2 - r2).abs() / r2).max().item()
           / FUSED_TOL["stats_rel"]}
    out["ok"] = (out["inf_count"] > 0 and out["inf_match"]
                 and out["stats_finite"] and max(
                     out[r] for r in ("y_err_ratio", "sum_err_ratio",
                                      "sumsq_err_ratio")) <= 1.0)
    return out


def phase_fused_kernel(torch, seed):
    """The fused 1x1-conv + BN-statistics kernel against its plain version
    at every resnet50_v1 shape (batch 32) and one ragged shape, fp32, bf16
    and fp16, in its three modes (the model's shapes with w in the conv
    layout, the ragged one as a direct call's contiguous [K, N]); fp16 also
    at FUSED_TIMED, and there with y past fp16's range.  Each case must
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
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
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
    x, w, _, _ = _fused_inputs(torch, gen, *FUSED_TIMED, torch.float16, False)
    case = _fused_case(torch, FC, x, w, None, None, False)
    case.update(shape=list(FUSED_TIMED), mode="plain", dtype="float16",
                w_layout="nk")
    case["ok"] = case["ok"] and case["variant"] == "wgmma"
    cases.append(case)
    del x, w
    overflow = _fused_overflow_case(torch, FC, gen)
    torch.cuda.empty_cache()
    bad = [c for c in cases if not c["ok"]] + (
        [] if overflow["ok"] else [overflow])
    emit({"phase": "fused_kernel", "ok": not bad, "tolerance": FUSED_TOL,
          "cases": len(cases),
          "variants": {v: sum(c["variant"] == v for c in cases)
                       for v in ("wgmma", "simt")},
          "worst": {r: max(c[r] for c in cases) for r in
                    ("y_err_ratio", "sum_err_ratio", "sumsq_err_ratio")},
          "worst_fp16": {r: max(c[r] for c in cases
                                if c["dtype"] == "float16")
                         for r in ("y_err_ratio", "sum_err_ratio",
                                   "sumsq_err_ratio")},
          "fp16_overflow": overflow, "failed": bad})
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
    timed_fp16 = _fused_timing_fp16(torch, FC, gen)
    emit({"phase": "fused_kernel_timing", "ok": True, "tf32": _tf32(torch),
          "launches_per_step": FUSED_LAUNCHES_PER_STEP,
          "step_sum": step, "shapes": shapes, "fp16": timed_fp16})
    return timed, timed_fp16


def _fused_timing_fp16(torch, FC, gen):
    """The fp16 route (row 2b) at FUSED_TIMED: checked once against the
    half-ulp gates, then timed in turns with its plain version (fp32 math
    on the fp16 values, y rounded once) and torch.matmul in fp16 (y
    alone); its bound is the bytes of fp16 x, w and y at the memory rate
    (its one TF32 product is 3x shorter)."""
    m, k, n = FUSED_TIMED
    x, w, _, _ = _fused_inputs(torch, gen, m, k, n, torch.float16, False)
    case = _fused_case(torch, FC, x, w, None, None, False)
    check(case["ok"] and case["variant"] == "wgmma",
          f"fused_conv_bn_stats fp16 at {FUSED_TIMED}: {case}")
    best, runs = _in_turns(torch, {
        "kernel": lambda: FC.fused_matmul_bn_stats(x, w),
        "plain": lambda: FC._reference_conv1x1(x, w, None, None, False),
        "library": lambda: torch.matmul(x, w)})
    bound, bound_by = fused_bound_ms(m, k, n, 2)
    del x, w
    torch.cuda.empty_cache()
    return {"shape": [m, k, n], "dtype": "float16", "mode": "plain",
            "variant": case["variant"], "max_abs_err": case["max_abs_err"],
            "y_err_ratio": case["y_err_ratio"], "ms": best["kernel"],
            "plain_ms": best["plain"], "library_ms": best["library"],
            "bound_ms": bound, "bound_by": bound_by, "runs_ms": runs}


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


def _graph_run(torch, build, warmup, steps, reset, read, busy=True):
    """``warmup`` + ``steps`` steps of a fresh ``build()`` through the
    graph: ``(graph, launches)``, ``launches`` being ``read()`` after the
    steps, counted from ``reset()`` just before; ``busy`` adds the traced
    busy share."""
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
    if busy:
        graph["busy"] = _busy_share(torch, lambda: step(xs, y),
                                    STEP_GRAPH["busy_steps"])
    del net, step, xs, y
    _free(torch)
    return graph, launches


def _graph_and_eager(torch, build, warmup, steps, reset, read):
    """``build()`` -> ``(net, step, xs, y)``.  Returns ``(graph, eager,
    parity, launches)``: the parity pair, ``_graph_run``, then the same
    steps through the eager twin, timed and traced."""
    parity = _parity_pair(torch, build)
    graph, launches = _graph_run(torch, build, warmup, steps, reset, read)
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
    fp32 tensor-core flash kernel's launches on this path, and the block
    (serving_http serves it again)."""
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
    del eng, answers
    return served["tf32"], net


# HTTP serving (slice 14): full-width BERT-base and llama_7b behind one
# ModelServer's socket.  Breaker threshold 2, cooldown 2 s for the fault
# script; SSE_DROP is the long request whose client walks away.
HTTP = dict(threads=8, breaker_threshold=2, breaker_cooldown_s=2.0,
            drain_requests=32, drop_new_tokens=256, goodput_rel=1e-6)


def _pooled(reqs, fn, threads):
    """``fn(req)`` for every request from ``threads`` threads pulling from
    one list, released together: (answers, per-request seconds, wall
    seconds)."""
    import threading
    answers, lat = [None] * len(reqs), [0.0] * len(reqs)
    errors, nxt, lock = [], [0], threading.Lock()
    gate = threading.Barrier(threads + 1)

    def worker():
        gate.wait()
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(reqs):
                return
            t = time.perf_counter()
            try:
                answers[i] = fn(reqs[i])
            except Exception as e:  # noqa: BLE001 - reported as a gate
                errors.append(f"{i}: {type(e).__name__}: {e}")
            lat[i] = time.perf_counter() - t

    ts = [threading.Thread(target=worker) for _ in range(threads)]
    for t in ts:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in ts:
        t.join()
    check(not errors, f"requests failed: {errors}")
    return answers, lat, time.perf_counter() - t0


def _latency_line(lat, rows, wall):
    import numpy as np
    ms = np.asarray(lat) * 1e3
    return {"requests": len(lat), "rows": rows, "wall_s": wall,
            "rows_per_s": rows / wall,
            "latency_ms_p50": float(np.percentile(ms, 50)),
            "latency_ms_p99": float(np.percentile(ms, 99))}


def _http(url, path, body=None, accept=None):
    """(status, headers, text) of one raw urllib request."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url + path, method="POST" if body is not None else "GET",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 **({"Accept": accept} if accept else {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read().decode()


def _prometheus_ok(text, openmetrics):
    """Every line of a text exposition parses: comments, or ``name{labels}
    value`` with an optional OpenMetrics exemplar; OpenMetrics ends in
    ``# EOF``.  Returns {sample: value}."""
    import re
    sample = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|'
        r'\\.)*",?)*\})? (\S+)( # \{[^}]*\} \S+ \S+)?$')
    lines = text.rstrip("\n").split("\n")
    if openmetrics:
        check(lines[-1] == "# EOF", "OpenMetrics body does not end in # EOF")
        lines = lines[:-1]
    out = {}
    for ln in lines:
        if ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            continue
        m = sample.match(ln)
        check(m is not None, f"unparsable metrics line: {ln[:120]!r}")
        check(openmetrics or m.group(4) is None,
              f"exemplar in a 0.0.4 body: {ln[:120]!r}")
        float(m.group(3).replace("+Inf", "inf").replace("-Inf", "-inf"))
        out[m.group(1) + (m.group(2) or "")] = m.group(3)
    return out


def _bucket_ms(model):
    """The serving goodput ledger's request-ms of ``model`` by bucket, so
    far (the registry's counters)."""
    from mxnet_tpu_torch.observability import metrics
    fam = metrics.registry().get("mxnet_tpu_goodput_serving_seconds_total")
    out = {}
    for key, v in fam.sample_dict().items():
        if f'model="{model}"' in key:
            out[key.split('bucket="')[1].split('"')[0]] = 1e3 * v
    return out


def _per_request(after, before, n):
    return {b: (after[b] - before.get(b, 0.0)) / n for b in sorted(after)}


def _drop_sse(url, name, prompt, max_new):
    """Open an SSE stream on a raw socket, read one token event, reset
    the connection; returns that event."""
    import socket
    import struct
    host, port = url[len("http://"):].split(":")
    body = json.dumps({"prompt": prompt, "max_new_tokens": max_new,
                       "eos_id": None, "stream": True}).encode()
    s = socket.create_connection((host, int(port)), timeout=600)
    s.sendall(f"POST /generate/{name} HTTP/1.1\r\nHost: x\r\n"
              f"Content-Type: application/json\r\nContent-Length: "
              f"{len(body)}\r\n\r\n".encode() + body)
    buf = b""
    while b"data:" not in buf or b"\n" not in buf.split(b"data:", 1)[1]:
        chunk = s.recv(65536)
        check(chunk, "the server closed the stream before a token")
        buf += chunk
    s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    s.close()
    return json.loads(buf.split(b"data:", 1)[1].split(b"\n", 1)[0])


def phase_serving_http(torch, seed, llama=None, bert=None):
    """One ModelServer serves full-width BERT-base (fp32, seq 128, SERVE's
    ladder) and llama_7b (bf16, 32 layers, dense engine; a paged twin on
    the same weights) over ``start_http``; everything goes through
    ``Client(url)`` and raw urllib.  ``llama`` and ``bert`` are the
    models the serving and serving_bert phases built (built here when
    those phases did not run).  Returns (tf32 launches, wgmma launches)
    over the HTTP traffic."""
    import threading

    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import resilience
    from mxnet_tpu_torch.observability import tracing
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.serving import ModelServer
    from mxnet_tpu_torch.serving.server import Client
    card = _card()
    torch.cuda.empty_cache()
    if llama is None:
        llama = _random_llama(torch, seed, torch.bfloat16, 32)
    if bert is None:
        from mxnet_tpu_torch.gluon.model_zoo.language import bert_12_768_12
        mx.random.seed(seed)
        bert = bert_12_768_12(ctx=mx.gpu(0))
        bert.initialize(mx.init.Normal(0.02))
    layers = len(bert.encoder.cells)
    vocab = bert.word_embed._input_dim
    eager = [0]

    def count(block, args):
        if not torch.cuda.is_current_stream_capturing():
            eager[0] += 1
    hook = bert.register_forward_pre_hook(count)
    seq = SERVE_BERT["seq"]
    reqs = _serve_requests(seed + 41, (seq,), lambda rng, shape: rng.randint(
        0, vocab, shape).astype(np.int32))
    rng = np.random.RandomState(seed + 43)
    rungs = {b: rng.randint(0, vocab, (b, seq)).astype(np.int32)
             for b in (1, 2, 4, 8)}
    prompts = _prompts(seed + 47, PROMPTS)
    breaker = resilience.CircuitBreaker(
        failure_threshold=HTTP["breaker_threshold"],
        cooldown=HTTP["breaker_cooldown_s"], name="serving:bert_http")
    server = ModelServer()
    eng = server.register("bert_http", bert, max_batch=SERVE["max_batch"],
                          max_wait_us=SERVE["max_wait_us"],
                          input_spec=[((seq,), "int32")], breaker=breaker)
    # the dense engine warmed over the prompts (its graphs captured); the
    # paged twin serves one request and captures on the step loop's thread
    dense = server.register_generation("llama_http", llama, max_slots=4,
                                       kv_cache=False, warmup=True,
                                       warmup_prompt_len=max(PROMPTS))
    paged = server.register_generation("llama_paged_http", llama,
                                       max_slots=4, kv_cache=True,
                                       page_tokens=16, warmup=False)
    url = f"http://127.0.0.1:{server.start_http(port=0)}"
    client = Client(url)
    sent = {"bert_http": 0, "llama_http": 0, "llama_paged_http": 0}
    out = {"phase": "serving_http", "card": card, "bert": "bert_12_768_12",
           "llama": "llama_7b bf16 32 layers", "url": url, **HTTP}
    try:
        # -- in process first: the references and the same traffic timed
        ref_rungs = {b: [o.asnumpy() for o in server.predict("bert_http", x)]
                     for b, x in rungs.items()}
        solo = [[o.asnumpy() for o in server.predict("bert_http", x)]
                for x in reqs]
        b0 = _bucket_ms("bert_http")
        _, lat, wall = _pooled(reqs, lambda x: server.predict(
            "bert_http", x)[0].asnumpy(), HTTP["threads"])
        rows = sum(len(x) for x in reqs)
        out["bert_in_process"] = _latency_line(lat, rows, wall)
        out["bert_in_process"]["goodput_ms_per_request"] = _per_request(
            _bucket_ms("bert_http"), b0, len(reqs))
        t = time.perf_counter()
        ref_tokens = [server.generate("llama_http", p,
                                      max_new_tokens=NEW_TOKENS, eos_id=None)
                      for p in prompts]
        gen_s = time.perf_counter() - t
        sent["bert_http"] += len(rungs) + 2 * len(reqs)
        sent["llama_http"] += len(prompts)
        out["llama_in_process"] = {
            "tokens_per_s": len(prompts) * NEW_TOKENS / gen_s,
            "wall_s": gen_s}

        # -- the HTTP traffic alone, its kernel launches counted
        torch.cuda.synchronize()
        A.flash_fwd_launches = A.flash_fwd_wgmma_launches = 0
        A.flash_fwd_tf32_launches = 0
        replays0, eager0 = eng._op._replays, eager[0]
        fwd0 = dense.admitted + dense.steps
        http_rungs = {b: client.predict("bert_http", [x.tolist()])
                      for b, x in rungs.items()}
        b0 = _bucket_ms("bert_http")
        answers, lat, wall = _pooled(
            reqs, lambda x: client.predict("bert_http", [x.tolist()]),
            HTTP["threads"])
        sent["bert_http"] += len(rungs) + len(reqs)
        out["bert_http"] = _latency_line(lat, rows, wall)
        out["bert_http"]["goodput_ms_per_request"] = _per_request(
            _bucket_ms("bert_http"), b0, len(reqs))
        t = time.perf_counter()
        http_tokens = [client.generate("llama_http", p,
                                       max_new_tokens=NEW_TOKENS,
                                       eos_id=None) for p in prompts]
        out["llama_http"] = {"tokens_per_s": len(prompts) * NEW_TOKENS
                             / (time.perf_counter() - t)}
        t = time.perf_counter()
        sse_tokens = [list(client.generate_stream(
            "llama_http", p, max_new_tokens=NEW_TOKENS, eos_id=None))
            for p in prompts]
        out["llama_sse"] = {"tokens_per_s": len(prompts) * NEW_TOKENS
                            / (time.perf_counter() - t)}
        paged_tokens = client.generate("llama_paged_http", prompts[0],
                                       max_new_tokens=NEW_TOKENS, eos_id=None)
        sent["llama_http"] += 2 * len(prompts)
        sent["llama_paged_http"] += 1
        torch.cuda.synchronize()
        bert_fwd = eng._op._replays - replays0 + eager[0] - eager0
        llama_fwd = dense.admitted + dense.steps - fwd0
        launches = {"flash_fwd": A.flash_fwd_launches,
                    "tf32": A.flash_fwd_tf32_launches,
                    "wgmma": A.flash_fwd_wgmma_launches,
                    "bert_forwards": bert_fwd, "llama_forwards": llama_fwd}
        out["launches"] = launches

        # JSON: what the server's encode and the client's decode cost
        enc, dec, size = [], [], []
        for a in answers:
            t = time.perf_counter()
            text = json.dumps({"outputs": a})
            t1 = time.perf_counter()
            json.loads(text)
            dec.append(time.perf_counter() - t1)
            enc.append(t1 - t)
            size.append(len(text))
        out["json_per_request"] = {
            "encode_ms_mean": 1e3 * float(np.mean(enc)),
            "decode_ms_mean": 1e3 * float(np.mean(dec)),
            "mb_mean": float(np.mean(size)) / 1e6,
            "rows_mean": rows / len(reqs)}
        out["socket_ms_per_rung"] = {}
        for b, x in rungs.items():
            t = time.perf_counter()
            server.predict("bert_http", x)[0].asnumpy()
            t_in = time.perf_counter() - t
            t = time.perf_counter()
            client.predict("bert_http", [x.tolist()])
            t_http = time.perf_counter() - t
            out["socket_ms_per_rung"][b] = {"in_process_ms": 1e3 * t_in,
                                            "http_ms": 1e3 * t_http,
                                            "cost_ms": 1e3 * (t_http - t_in)}
        sent["bert_http"] += 2 * len(rungs)

        gates = {
            "solo_bitwise": all(
                np.array_equal(np.asarray(h, np.float32), r)
                for b in rungs for h, r in zip(http_rungs[b], ref_rungs[b])),
            "concurrent_within_card_rel": all(
                float(np.abs(np.asarray(h, np.float32) - r).max())
                <= SERVE["card_rel"] * float(np.abs(r).max()) + SERVE["abs"]
                for a, s in zip(answers, solo) for h, r in zip(a, s)),
            "shapes": all(np.asarray(a[0]).shape == (len(x), seq, bert._units)
                          and np.asarray(a[1]).shape == (len(x), bert._units)
                          for a, x in zip(answers, reqs)),
            "generate_tokens_equal": http_tokens == ref_tokens,
            "sse_tokens_equal": sse_tokens == ref_tokens,
            "paged_16_tokens": len(paged_tokens) == NEW_TOKENS,
            "tf32_12_per_bert_forward":
                launches["tf32"] == layers * bert_fwd and bert_fwd > 0,
            "wgmma_32_per_llama_forward":
                launches["wgmma"] == llama.kv_cache_spec()[0] * llama_fwd
                and llama_fwd > 0,
            "no_other_variant": launches["flash_fwd"]
                == launches["tf32"] + launches["wgmma"]}

        # -- resilience: the execute site fails; the breaker opens
        x1 = [rungs[1].tolist()]
        seqp = [json.loads(_http(url, "/ping")[2])["status"]]
        with resilience.FaultPlan(
                {"execute": ["fatal"] * HTTP["breaker_threshold"]}):
            fails = [_http(url, "/predict/bert_http", {"inputs": x1})[0]
                     for _ in range(HTTP["breaker_threshold"])]
        seqp.append(json.loads(_http(url, "/ping")[2])["status"])
        code, headers, body = _http(url, "/predict/bert_http",
                                    {"inputs": x1})
        shed = (code, json.loads(body).get("retry_after_s"),
                headers.get("Retry-After"))
        other = client.generate("llama_http", prompts[0], max_new_tokens=2,
                                eos_id=None)
        sent["llama_http"] += 1
        time.sleep(HTTP["breaker_cooldown_s"] + 0.2)
        seqp.append(json.loads(_http(url, "/ping")[2])["status"])
        probe = _http(url, "/predict/bert_http", {"inputs": x1})[0]
        sent["bert_http"] += 1
        seqp.append(json.loads(_http(url, "/ping")[2])["status"])
        out["breaker"] = {"ping": seqp, "failed": fails, "shed": shed,
                          "probe": probe, "open_events": breaker.open_events}
        gates["breaker_degraded_then_serving"] = (
            fails == [500] * HTTP["breaker_threshold"]
            and seqp == ["SERVING", "DEGRADED", "DEGRADED", "SERVING"]
            and shed[0] == 503 and shed[1] is not None and probe == 200
            and other == ref_tokens[0][:2])

        # -- a client that drops its SSE stream cancels its request
        before = dense.cancelled
        first = _drop_sse(url, "llama_http", prompts[0],
                          HTTP["drop_new_tokens"])
        t = time.perf_counter()
        while dense.cancelled == before and time.perf_counter() - t < 120:
            time.sleep(0.01)
        while server._generators["llama_http"].in_flight() and \
                time.perf_counter() - t < 120:
            time.sleep(0.01)
        out["dropped_stream"] = {
            "first_event": first, "cancelled": dense.cancelled - before,
            "active_after": sum(s is not None for s in dense._slots),
            "seconds_to_cancel": time.perf_counter() - t}
        gates["dropped_stream_cancelled"] = (
            dense.cancelled - before == 1 and "token" in first
            and out["dropped_stream"]["active_after"] == 0)

        # -- telemetry
        code, headers, plain = _http(url, "/metrics")
        samples = _prometheus_ok(plain, False)
        code2, headers2, om = _http(url, "/metrics",
                                    accept="application/openmetrics-text")
        _prometheus_ok(om, True)
        counted = {m: float(samples.get(
            f'mxnet_tpu_serving_requests_total{{model="{m}"}}', "nan"))
            for m in sent}
        gp = json.loads(_http(url, "/goodput")[2])
        bucket_sum = {m: 0.0 for m in sent}
        for key, v in gp["serving"]["totals"]["bucket_seconds"].items():
            for m in sent:
                if f'model="{m}"' in key:
                    bucket_sum[m] += v
        walls = {m: float(samples[
            f'mxnet_tpu_goodput_serving_wall_seconds_total{{model="{m}"}}'])
            for m in sent}
        last = gp["serving"]["last_request"]
        mem = gp["memory"]["components"]
        tails = gp["tail"]["traces"]
        doc = tracing.export_chrome_trace(tails[-1]["trace_id"]) if tails \
            else {"traceEvents": []}
        exemplar = client.stats("bert_http")["p99_exemplar"]
        out["telemetry"] = {
            "metrics_types": [headers.get("Content-Type"),
                              headers2.get("Content-Type")],
            "requests_counted": counted, "requests_sent": sent,
            "bucket_seconds": bucket_sum, "wall_seconds": walls,
            "last_request_buckets": last["buckets"],
            "memory_components": {k: v for k, v in mem.items()
                                  if k.startswith("serving:")},
            "retained_traces": len(tails),
            "exported_spans": sorted({e["name"] for e in
                                      doc["traceEvents"]}),
            "p99_exemplar": exemplar}
        gates["metrics_parse"] = code == code2 == 200 and \
            "version=0.0.4" in headers.get("Content-Type", "")
        gates["request_counters"] = all(counted[m] == sent[m] for m in sent)
        gates["goodput_reconciles"] = all(
            abs(bucket_sum[m] - walls[m]) <= HTTP["goodput_rel"] * walls[m]
            and walls[m] > 0 for m in sent) and abs(
            sum(last["buckets"].values()) - last["wall_seconds"]) \
            <= HTTP["goodput_rel"] * last["wall_seconds"]
        gates["memory_ledger"] = (
            "serving:kv_pages:llama_paged_http" in mem
            and "serving:host_buffers:bert_http" in mem
            and mem["serving:kv_pages:llama_paged_http"] > 0)
        gates["trace_exported"] = bool(doc["traceEvents"]) and (
            exemplar is None or tracing.retained_trace(
                exemplar["trace_id"]) is not None)

        # -- stop() drains: /ping reads DRAINING while accepted work runs
        futs = [server.predict_async("bert_http", reqs[i % len(reqs)])
                for i in range(HTTP["drain_requests"])]
        stopper = threading.Thread(target=server.stop)
        stopper.start()
        pings = []
        while stopper.is_alive():
            try:
                c, _, b = _http(url, "/ping")
                pings.append((c, json.loads(b)))
            except OSError:
                break
        stopper.join()
        done = [f.result(timeout=600) for f in futs]
        draining = [p for c, p in pings if c == 503
                    and p.get("status") == "DRAINING"]
        out["drain"] = {"pings": len(pings), "draining_seen": len(draining),
                        "max_in_flight": max((p["in_flight"]
                                              for p in draining), default=0),
                        "answered": len(done)}
        gates["drain"] = (len(done) == HTTP["drain_requests"]
                          and any(p["in_flight"] > 0 for p in draining))
    finally:
        server.stop()
        hook.detach()
    out["llama_graphs"] = {"llama_http": _gen_graphs(torch, dense),
                           "llama_paged_http": _gen_graphs(torch, paged)}
    gates["llama_replayed_captures"] = all(
        g["captures"] == g["entries"] and g["replays"] > 0
        for g in out["llama_graphs"].values())
    out["gates"] = gates
    out["ok"] = all(gates.values())
    emit(out)
    for key in ("bert_in_process", "bert_http", "llama_in_process",
                "llama_http", "llama_sse", "json_per_request",
                "socket_ms_per_rung"):
        print(f"serving_http {key} [{card}]: {json.dumps(out[key])}",
              flush=True)
    check(out["ok"], f"serving_http failed: {gates}")
    return launches["tf32"], launches["wgmma"]


def _gen_tokens(sched, prompts):
    """Every prompt's NEW_TOKENS greedy tokens through ``sched``'s own
    step loop (no eos)."""
    futs = [sched.submit(p, max_new_tokens=NEW_TOKENS, eos_id=None)
            for p in prompts]
    sched.run()
    return [f.result(timeout=0) for f in futs]


def _last_logits(torch, model, tokens):
    """The last position's logits of ``tokens`` (fp32), by cache_forward
    over an empty cache."""
    layers, kv_units, _ = model.kv_cache_spec()
    empty = torch.zeros(layers, 1, 16, kv_units, device="cuda",
                        dtype=model.dtype)
    zero = torch.zeros(1, dtype=torch.long, device="cuda")
    no_table = torch.zeros(1, 0, dtype=torch.long, device="cuda")
    with torch.no_grad():
        return model.cache_forward(torch.tensor([tokens], device="cuda"),
                                   zero, zero, no_table, empty,
                                   empty)[0][0, -1].float()


def _divergences(torch, model, prompts, got, want):
    """Per prompt: None where ``got`` equals ``want``, else the first step
    where they part with ``want``'s top-2 margin and largest |logit|
    there."""
    out = []
    for p, g, w in zip(prompts, got, want):
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            out.append(None)
            continue
        row = _last_logits(torch, model, list(p) + w[:j])
        top2 = torch.topk(row, 2).values
        out.append({"step": j, "top2_margin": (top2[0] - top2[1]).item(),
                    "max_abs_logit": row.abs().max().item()})
    return out


def _agree(got, want):
    return sum(a == b for x, y in zip(got, want) for a, b in zip(x, y))


def _spec_exact(torch, seed, prompts):
    """(a) llama_7b's width at SPEC["exact_layers"] layers, fp32, TF32 off:
    plain paged against speculation with the target as its own draft
    (whole rounds accepted, then the 2-token catch-up) and with a random
    1-layer draft of the same width (rejections)."""
    from mxnet_tpu_torch.serving import GenerationScheduler
    fp32 = _random_llama(torch, seed, torch.float32, SPEC["exact_layers"])
    draft1 = _random_llama(torch, seed + 5, torch.float32, 1)
    kw = dict(max_slots=4, kv_cache=True, page_tokens=16, prefix_cache=True)
    plain = _gen_tokens(GenerationScheduler(fp32, name="spec_exact_plain",
                                            **kw), prompts)
    out, gates = {}, {}
    for run, draft in (("self", fp32), ("draft_1_layer", draft1)):
        sched = GenerationScheduler(fp32, draft_model=draft,
                                    spec_tokens=SPEC["spec_tokens"],
                                    name=f"spec_exact_{run}", **kw)
        got = _gen_tokens(sched, prompts)
        snap = sched.stats_snapshot()
        div = _divergences(torch, fp32, prompts, got, plain)
        chunks = {sig[0][0][0][1] for sig in
                  sched._draft.cache_stats["signatures"]}
        out[run] = {"tokens_agree": f"{_agree(got, plain)}/"
                    f"{len(prompts) * NEW_TOKENS}", "divergences": div,
                    "acceptance": snap["spec_acceptance"],
                    "steps": snap["steps"], "draft_chunk_widths":
                    sorted(chunks),
                    "pools_active": [snap["page_pool"]["active"],
                                     snap["draft_page_pool"]["active"]]}
        gates[f"{run}_identity_or_near_tie"] = all(
            d is None or d["top2_margin"]
            < SPEC["near_tie_rel"] * d["max_abs_logit"] for d in div) and \
            all(len(g) == NEW_TOKENS for g in got)
        gates[f"{run}_acceptance_in_0_1"] = \
            0.0 <= snap["spec_acceptance"] <= 1.0
        gates[f"{run}_pools_drained"] = out[run]["pools_active"] == [0, 0]
        del sched
    gates["self_catch_up_2_tokens"] = 2 in out["self"]["draft_chunk_widths"]
    gates["draft_1_layer_rejections"] = out["draft_1_layer"]["acceptance"] < 1
    del fp32, draft1
    gc.collect()
    torch.cuda.empty_cache()
    return out, gates


def _kernel_family(name):
    n = name.lower()
    if any(k in n for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                            "splitk")):
        return "gemm"
    if "elementwise" in n and "index" not in n:
        return "elementwise"
    return "other"


def _decode_trace(torch, sched, prompts):
    """SPEC["trace_steps"] warmed decode steps of the paged engine, 4
    active slots: their wall ms untraced, then under torch.profiler the
    busy share, device ms per step by family (GEMM, elementwise, other),
    the kernels that take most and the host's CUDA runtime calls (count
    and ms per step by name)."""
    steps = SPEC["trace_steps"]
    entries = len(sched._target._op._cache)

    def decode(trace):
        futs = [sched.submit(p, max_new_tokens=steps + 2, eos_id=None)
                for p in prompts]
        sched.step()                   # the prefills and one decode step

        def run():
            for _ in range(steps):
                sched.step()
        if trace:
            got = _trace_events(torch, run, runtime=True)
        else:
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            got = 1e3 * (time.perf_counter() - t)
        sched.run()
        return got, [len(f.result(timeout=0)) for f in futs]
    untraced_ms, _ = decode(False)
    (wall_ms, events), tokens = decode(True)
    gpu = [e for e in events if not e["cat"].startswith("cuda_")]
    calls = {}
    for e in events:
        if e["cat"].startswith("cuda_"):
            n, ms = calls.get(e["name"], (0, 0.0))
            calls[e["name"]] = (n + 1, ms + e["dur"] / 1e3)
    kernels = [e for e in gpu if e["cat"] == "kernel"]
    fam, top = {"gemm": 0.0, "elementwise": 0.0, "other": 0.0}, {}
    for e in kernels:
        fam[_kernel_family(e["name"])] += e["dur"] / 1e3
        ms, n = top.get(e["name"], (0.0, 0))
        top[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    busy = _union_ms([(e["ts"], e["ts"] + e["dur"]) for e in gpu])
    return {"steps": steps, "wall_ms_per_step_untraced": untraced_ms / steps,
            "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy / steps, "busy_share": busy / wall_ms,
            "kernels_per_step": len(kernels) / steps,
            "ms_per_step_by_family": {k: v / steps for k, v in fam.items()},
            "top_kernels_ms_per_step": [
                (name[:80], ms / steps, n // steps) for name, (ms, n) in
                sorted(top.items(), key=lambda kv: -kv[1][0])[:8]],
            "runtime_calls_per_step": {
                name: (n / steps, ms / steps) for name, (n, ms) in
                sorted(calls.items(), key=lambda kv: -kv[1][1])[:6]},
            "new_entries": len(sched._target._op._cache) - entries,
            "tokens": tokens}


def _spec_serve(torch, run, model, draft, prompts, warm):
    """``prompts`` through ModelServer.register_generation (the paged
    engine; speculative with ``draft``), warmed first when ``warm``:
    (figures, tokens, the scheduler)."""
    from mxnet_tpu_torch.serving import ModelServer
    name = f"spec_{run}"
    server = ModelServer()
    try:
        t = time.perf_counter()
        sched = server.register_generation(
            name, model, max_slots=4, kv_cache=True, page_tokens=16,
            prefix_cache=True, draft_model=draft,
            spec_tokens=SPEC["spec_tokens"] if draft is not None else None,
            warmup=warm, warmup_prompt_len=max(PROMPTS))
        torch.cuda.synchronize()
        out = {"warmup_s": time.perf_counter() - t,
               "warm": _gen_graphs(torch, sched)}
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        # queue all four, then wake the step loop once: it admits them in
        # one step, so every run batches them alike (in bf16 another batch
        # composition rounds apart, and warmed and unwarmed are compared
        # token for token)
        gen = server._generators[name]
        futs = [gen.scheduler.submit(p, max_new_tokens=NEW_TOKENS,
                                     eos_id=None) for p in prompts]
        gen.wake.set()
        tokens = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        st = server.stats(name)
    finally:
        server.stop()
    out.update({"wall_s": wall,
                "tokens_per_s": len(prompts) * NEW_TOKENS / wall,
                "steps": st["steps"], "acceptance": st.get("spec_acceptance"),
                "logit_rows": st["logit_rows"],
                "nonfinite_rows": st["nonfinite_rows"],
                "pools_active": [st["page_pool"]["active"],
                                 st.get("draft_page_pool", {}).get("active",
                                                                   0)],
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "after": _gen_graphs(torch, sched)})
    return out, tokens, sched


def phase_speculative(torch, seed, model, dense_per_forward):
    """Speculative decoding and warmup (slice 17).  (a) The exact gate
    (``_spec_exact``).  (b) The serving phase's llama_7b (bf16, 32 layers)
    behind ModelServer on the paged engine with the serving phase's 4
    prompts: unwarmed (captures on the step loop's thread), then warmed
    plain, speculative with the target as its own draft and speculative
    with a TinyLlama-1.1B draft; tokens/s, acceptance, agreement with plain
    paged, the warmup's captures, seconds and graph pool, no new entry
    under traffic, warmed tokens bit for bit the unwarmed ones; a trace of
    warmed decode steps.  ``dense_per_forward`` is the serving phase's
    flash launches per dense forward, through replays."""
    from mxnet_tpu_torch.gluon.model_zoo.language import LlamaModel
    from mxnet_tpu_torch.initializer import initialize
    from mxnet_tpu_torch.random import generator
    card = _card()
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    prompts = _prompts(seed + 3, PROMPTS)
    exact, gates = _spec_exact(torch, seed, prompts)
    out = {"phase": "speculative", "card": card, "spec_tokens":
           SPEC["spec_tokens"], "exact_fp32_4_layers": exact,
           "near_tie_rel": SPEC["near_tie_rel"]}
    tiny = LlamaModel(dtype=torch.bfloat16, **TINYLLAMA)
    initialize(tiny, generator(seed + 7))
    tiny.eval().requires_grad_(False)
    runs, tokens = {}, {}
    for run, draft, warm in (("plain_cold", None, False),
                             ("plain", None, True),
                             ("self", model, True),
                             ("tinyllama", tiny, True)):
        runs[run], tokens[run], sched = _spec_serve(torch, run, model, draft,
                                                    prompts, warm)
        if run == "plain":
            runs[run]["trace"] = _decode_trace(torch, sched, prompts)
        del sched
        gc.collect()
        torch.cuda.empty_cache()
    for run in ("self", "tinyllama"):
        runs[run]["tokens_agree_with_plain"] = (
            f"{_agree(tokens[run], tokens['plain'])}/"
            f"{len(prompts) * NEW_TOKENS}")
        runs[run]["divergences"] = _divergences(torch, model, prompts,
                                                tokens[run], tokens["plain"])
    del tiny
    gc.collect()
    torch.cuda.empty_cache()
    out["bf16_logit_noise"] = _bf16_logit_noise(torch, model, prompts[0])
    out["full_width_bf16"] = runs
    out["dense_flash_per_forward"] = dense_per_forward
    warmed = ("plain", "self", "tinyllama")
    gates.update({
        "warm_no_new_entries": all(
            runs[r]["after"]["entries"] == runs[r]["warm"]["entries"]
            == runs[r]["warm"]["captures"] > 0 for r in warmed)
        and runs["plain"]["trace"]["new_entries"] == 0,
        "warmed_equal_unwarmed": tokens["plain"] == tokens["plain_cold"],
        "cold_captured_in_traffic": runs["plain_cold"]["warm"]["entries"] == 0
        and runs["plain_cold"]["after"]["captures"]
        == runs["plain_cold"]["after"]["entries"] > 0,
        "16_tokens_each": all(len(t) == NEW_TOKENS for ts in tokens.values()
                              for t in ts),
        "logits_finite": all(r["nonfinite_rows"] == 0 and r["logit_rows"] > 0
                             for r in runs.values()),
        "acceptance_in_0_1": all(0.0 <= runs[r]["acceptance"] <= 1.0
                                 for r in ("self", "tinyllama")),
        "pools_drained": all(r["pools_active"] == [0, 0]
                             for r in runs.values()),
        "dense_32_flash_per_forward_through_replays":
            dense_per_forward == 32,
    })
    out["gates"] = gates
    out["seconds"] = time.perf_counter() - t0
    out["ok"] = all(gates.values())
    emit(out)
    for run in ("plain_cold",) + warmed:
        r = runs[run]
        print(f"speculative {run} [{card}]: " + json.dumps(
            {k: r[k] for k in ("tokens_per_s", "acceptance", "warmup_s",
                               "steps", "peak_mem_gb")}
            | {"captures": r["warm"]["captures"],
               "pool_gb": r["warm"]["pool_gb"]}), flush=True)
    print(f"speculative decode trace [{card}]: "
          f"{json.dumps(runs['plain']['trace'])}", flush=True)
    check(out["ok"], f"speculative gates failed: {gates}")


# The fleet (slice 18).  (a) llama_7b at its full width and FLEET["layers"]
# of its 32 layers (bf16, one weight copy; the depth was cut from 32 to 8
# so the whole script keeps inside its limit) behind a Router: first one mixed replica, then one
# prefill and two decode replicas, each paged (16-token pages, 4 slots) and
# warmed for its role; the serving phase's 4 prompts, 16 new tokens each,
# FLEET["rounds"] times on the mixed replica (its second round finds the
# prompts in its prefix cache) and FLEET["disagg_rounds"] times on the
# disaggregated fleet, then the longest prompt alone, which finds its
# prompt in the prefill replica's prefix cache and is routed by it.  Every
# round and the lone stream are held to the mixed replica's first round.
# The disaggregated fleet runs one round: its K/V handoffs cross HTTP as
# JSON (73-106 s a round of 1 GB handoffs on an H100 host), and at two
# rounds the whole script took 1120.4 s there, against the 1200 s it must
# end within.  (b) llama_7b's width at
# 4 layers, fp32, TF32 off, 2 slots,
# max_length 256: prompts of a 64-token system prefix and suffixes of
# 16-130 tokens, 24 new tokens each, through disaggregation, prefix
# affinity, migration (a snapshot and a stop; no snapshot and a ``relay``
# fault), a hedge, a rolling restart and a client's disconnect; a slowed
# replica sleeps ``step_delay_s`` (``hedge_delay_s`` for the hedge) before
# each step.  (c) tools/chaos_torch.py: two tools/serve_torch.py children of
# (b)'s model (max_length 128), 16 streams of 24 tokens 30 ms apart (so a
# kill finds streams in flight), 2 seeded SIGKILLs.
# (d) BERT-base behind two replicas' /predict and (a)'s llama_7b's dense
# engine behind two replicas' /generate, through the Router: one bf16
# wgmma flash launch per layer per forward.
FLEET = dict(layers=8, slots=4, page_tokens=16, rounds=2, disagg_rounds=1,
             exact_system=64, exact_suffixes=(16, 40, 90, 130),
             exact_new=24, exact_slots=2, exact_max_length=256,
             migrate_prompt=100, step_delay_s=0.05, hedge_delay_s=1.0,
             snapshot_tokens=4, relay_fault_after=4,
             chaos=dict(requests=16, max_new=24, kills=2, slots=2,
                        max_length=128, interarrival_s=0.03,
                        kill_wait_s=240, timeout_s=900),
             bert_requests=8)


class _Probe:
    """Times the stages of each K/V handoff, keyed by the prompt's length:
    the prefill replica's gather and encode, the wire between the end of
    its /prefill and the start of the decode replica's /generate (the two
    JSON hops, the Router's parse and re-serialisation included), and the
    decode replica's decode and pool write.  Patches the port's functions
    for the ``with`` block."""

    def __init__(self, torch):
        import threading
        from mxnet_tpu_torch.serving import generation, paged_cache, server
        self.torch = torch
        self.lock = threading.Lock()
        self.events = []
        self.patches = [
            (paged_cache.PagePool, "gather", self._timed(
                paged_cache.PagePool.gather, "gather_ms",
                lambda a: len(a[1]))),
            (server, "encode_kv", self._timed(
                server.encode_kv, "encode_ms", lambda a: a[0].shape[1])),
            (server, "decode_kv", self._timed(
                server.decode_kv, "decode_ms",
                lambda a: len(a[0]["prompt"]) if a[0].get("kv") else None)),
            (generation.GenerationScheduler, "_prefill_external",
             self._timed(generation.GenerationScheduler._prefill_external,
                         "write_ms", lambda a: len(a[1].prompt), sync=True)),
            (server.ModelServer, "handle_prefill", self._stamp(
                server.ModelServer.handle_prefill, "prefill_end", False)),
            (server.ModelServer, "handle_generate_stream", self._stamp(
                server.ModelServer.handle_generate_stream, "generate_start",
                True))]
        self.saved = []

    def _record(self, tokens, key, value):
        if tokens is not None:
            with self.lock:
                self.events.append((tokens, key, value))

    def _timed(self, fn, key, tokens_of, sync=False):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                self.torch.cuda.synchronize()
            self._record(tokens_of(a), key, 1e3 * (time.perf_counter() - t))
            return out
        return wrapper

    def _stamp(self, fn, key, at_start):
        def wrapper(srv, name, payload, *a, **kw):
            tokens = len(payload.get("prompt") or [])
            if at_start:
                if payload.get("kv") is not None:
                    self._record(tokens, key, time.perf_counter())
                return fn(srv, name, payload, *a, **kw)
            out = fn(srv, name, payload, *a, **kw)
            self._record(tokens, key, time.perf_counter())
            return out
        return wrapper

    def __enter__(self):
        for owner, name, fn in self.patches:
            self.saved.append((owner, name, owner.__dict__[name]))
            setattr(owner, name, fn)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)

    def take(self):
        """Per prompt length: each stage's ms, and the wire's."""
        with self.lock:
            events, self.events = self.events, []
        out = {}
        for tokens, key, value in events:
            out.setdefault(tokens, {})[key] = value
        for row in out.values():
            if "prefill_end" in row and "generate_start" in row:
                row["wire_ms"] = 1e3 * (row.pop("generate_start")
                                        - row.pop("prefill_end"))
        return out


def _fleet_streams(url, name, prompts, max_new):
    """Every prompt streamed through ``url`` at once, a thread each:
    (tokens, first-token ms, wall s)."""
    import threading
    from mxnet_tpu_torch.serving.server import Client
    toks, first, errors = [None] * len(prompts), [0.0] * len(prompts), []

    def one(i):
        t = time.perf_counter()
        try:
            got = []
            for tok in Client(url).generate_stream(
                    name, prompts[i], max_new_tokens=max_new, eos_id=None):
                if not got:
                    first[i] = 1e3 * (time.perf_counter() - t)
                got.append(tok)
            toks[i] = got
        except Exception as e:  # noqa: BLE001 - reported as a gate
            errors.append(f"{i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"fleet streams failed: {errors}")
    return toks, first, time.perf_counter() - t0


def _fleet_replica(model, tag, role, warm_len, **kw):
    """A warmed paged scheduler of ``model`` behind a ModelServer of
    ``role`` on a free port: (server, scheduler, url, warmup s)."""
    from mxnet_tpu_torch.serving import GenerationScheduler, ModelServer
    sched = GenerationScheduler(model, name=f"fleet_{tag}", **kw)
    srv = ModelServer(role=role)
    t = time.perf_counter()
    srv.register_generation("llama", None, scheduler=sched, warmup=True,
                            warmup_prompt_len=warm_len)
    warm_s = time.perf_counter() - t
    return srv, sched, f"http://127.0.0.1:{srv.start_http()}", warm_s


def _fleet_cell(torch, model, prompts, roles, n_rounds):
    """(a)'s traffic, ``n_rounds`` times, through a Router over fresh
    replicas of ``roles``: per round tokens/s, first-token ms and the
    handoffs; per replica its warmup, entries made by live traffic and
    peak memory.  With a prefill replica, the longest prompt then runs
    alone.  Returns the report, each round's tokens and the lone run's
    (None without a prefill replica)."""
    from mxnet_tpu_torch.fleet import Router
    kw = dict(max_slots=FLEET["slots"], kv_cache=True,
              page_tokens=FLEET["page_tokens"], prefix_cache=True)
    reps = []
    for i, role in enumerate(roles):
        srv, sched, url, warm_s = _fleet_replica(
            model, f"{role}{i}", role, max(PROMPTS), **kw)
        reps.append({"srv": srv, "sched": sched, "url": url, "role": role,
                     "warm_s": warm_s, "warm": _gen_graphs(torch, sched)})
    router = Router([(r["url"], r["role"]) for r in reps], poll_s=999)
    host, port = router.start_http("127.0.0.1", 0)
    routed = _fleet_counter("mxnet_tpu_fleet_prefix_routed_total",
                            model="llama")
    rounds, tokens = [], []
    torch.cuda.reset_peak_memory_stats()
    with _Probe(torch) as probe:
        for _ in range(n_rounds):
            got, first, wall = _fleet_streams(f"http://{host}:{port}",
                                              "llama", prompts, NEW_TOKENS)
            tokens.append(got)
            handoffs = probe.take()
            rounds.append({
                "wall_s": wall,
                "tokens_per_s": len(prompts) * NEW_TOKENS / wall,
                "first_token_ms": first,
                "handoffs": {n: dict(h, bytes=2 * 4 * model.kv_cache_spec()[0]
                                     * n * model.kv_cache_spec()[1])
                             for n, h in sorted(handoffs.items())}})
            router.refresh()   # the digests the round registered
        solo = solo_tokens = None
        if "prefill" in roles:
            # the longest prompt alone: each stage without the others'
            # handoffs contending for the interpreter
            solo_tokens, first, wall = _fleet_streams(f"http://{host}:{port}",
                                            "llama", prompts[-1:],
                                            NEW_TOKENS)
            solo = {"prompt_tokens": len(prompts[-1]), "wall_s": wall,
                    "first_token_ms": first[0],
                    **probe.take()[len(prompts[-1])]}
    router.stop()
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = {"rounds": rounds, "peak_mem_gb": peak, "solo_handoff": solo,
           "prefix_routed": _fleet_counter(
               "mxnet_tpu_fleet_prefix_routed_total", model="llama") - routed,
           "replicas": []}
    for r in reps:
        r["srv"].stop(timeout=120)
        after = _gen_graphs(torch, r["sched"])
        out["replicas"].append({
            "role": r["role"], "warmup_s": r["warm_s"], "warm": r["warm"],
            "new_entries": after["entries"] - r["warm"]["entries"],
            "new_captures": after["captures"] - r["warm"]["captures"],
            "kv_pool_gb": (r["sched"]._target.pool.k.nbytes
                           + r["sched"]._target.pool.v.nbytes) / 1e9,
            "admitted": r["sched"].admitted})
    del reps, router
    gc.collect()
    torch.cuda.empty_cache()
    return out, tokens, solo_tokens


def _fleet_counter(name, **labels):
    from mxnet_tpu_torch.observability import metrics
    fam = metrics.registry().get(name)
    return fam.labels(**labels).value if fam is not None else 0.0


def _fleet_disagg(torch, model, prompts):
    """(a): the mixed replica, then prefill:1,decode:2, the same traffic;
    every later round, and the lone run of the longest prompt, held to the
    mixed replica's first round."""
    n_disagg = FLEET["disagg_rounds"]
    mixed, mixed_tokens, _ = _fleet_cell(torch, model, prompts, ("mixed",),
                                         FLEET["rounds"])
    disagg, disagg_tokens, solo = _fleet_cell(
        torch, model, prompts, ("prefill", "decode", "decode"), n_disagg)
    noise = _bf16_logit_noise(torch, model, prompts[0])
    floor = max(noise["dense_vs_dense_padded"], noise["dense_vs_paged"])
    div = [_divergences(torch, model, prompts, got, mixed_tokens[0])
           for got in mixed_tokens[1:] + disagg_tokens]
    div.append(_divergences(torch, model, prompts[-1:], solo,
                            mixed_tokens[0][-1:]))
    out = {"mixed": mixed, "disaggregated": disagg,
           "tokens_agree_with_mixed": [
               f"{_agree(got, mixed_tokens[0])}/{len(prompts) * NEW_TOKENS}"
               for got in mixed_tokens[1:] + disagg_tokens]
           + [f"{_agree(solo, mixed_tokens[0][-1:])}/{NEW_TOKENS}"],
           "divergences": div, "bf16_noise": floor}
    handoffs = [h for r in disagg["rounds"] for h in r["handoffs"].values()]
    gates = {
        "a_all_complete": all(len(t) == NEW_TOKENS
                              for ts in mixed_tokens + disagg_tokens + [solo]
                              for t in ts),
        "a_no_new_entries": all(r["new_entries"] == 0 == r["new_captures"]
                                for c in (mixed, disagg)
                                for r in c["replicas"]),
        "a_handoff_per_request": len(handoffs) == n_disagg * len(prompts)
        and all(set(h) == {"gather_ms", "encode_ms", "wire_ms", "decode_ms",
                           "write_ms", "bytes"} for h in handoffs),
        "a_identity_or_near_tie": all(
            d is None or d["top2_margin"] < floor for ds in div for d in ds),
        "a_prefix_routed": disagg["prefix_routed"] > 0,
        "a_decode_replicas_served": sum(
            r["admitted"] for r in disagg["replicas"]
            if r["role"] == "decode") == n_disagg * len(prompts) + 1}
    return out, gates


class _ExactReplica:
    """A replica of (b): a warmed scheduler behind a ModelServer on a
    fixed port.  ``delay`` seconds of sleep precede each step;
    ``restart()`` stops the server and serves the same scheduler again on
    the same port, its CUDA graphs kept, so nothing captures under
    traffic."""

    def __init__(self, model, tag, role):
        from mxnet_tpu_torch.serving import GenerationScheduler
        self.role, self.delay, self.port = role, 0.0, 0
        self.sched = GenerationScheduler(
            model, name=f"fleet_exact_{tag}", max_slots=FLEET["exact_slots"],
            kv_cache=True, page_tokens=FLEET["page_tokens"],
            prefix_cache=True, max_length=FLEET["exact_max_length"])
        # the whole length ladder: a re-prefill of prompt + known tokens
        # after a migration reaches past the prompts
        self.sched.warmup(max_prompt_len=FLEET["exact_max_length"] - 1,
                          max_new_tokens=1, role=role)
        self.entries = len(self.sched._target._op._cache)
        step = self.sched.step

        def slowed():
            if self.delay:
                time.sleep(self.delay)
            return step()
        self.sched.step = slowed
        self.start()

    def start(self):
        from mxnet_tpu_torch.serving import ModelServer
        self.srv = ModelServer(role=self.role)
        self.srv.register_generation("lm", None, scheduler=self.sched,
                                     warmup=False)
        self.port = self.srv.start_http("127.0.0.1", self.port)
        self.url = f"http://127.0.0.1:{self.port}"

    def restart(self):
        self.srv.stop(timeout=60)
        self.start()

    def active_pages(self):
        return self.sched.stats_snapshot()["page_pool"]["active"]

    def settle(self, delay):
        """Set the step delay once nothing is pending or active (an
        abandoned leg left by a migration included) and a step begun
        under the old delay has had time to end."""
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and (
                self.sched._pending
                or any(s is not None for s in self.sched._slots)):
            time.sleep(0.02)
        time.sleep(2 * max(self.delay, FLEET["step_delay_s"]))
        self.delay = delay


def _stream_events(router, prompt, max_new, rid=None):
    """(tokens, events) of one stream through ``router`` in process."""
    payload = {"prompt": prompt, "max_new_tokens": max_new, "eos_id": None}
    if rid:
        payload["rid"] = rid
    code, events = router.route_generate_stream("lm", payload)
    check(code == 200, f"stream refused: {code} {events}")
    events = list(events)
    return [e["token"] for e in events if "token" in e], events


def _clean(events):
    """No error event, and the done event repeats the relayed tokens."""
    toks = [e["token"] for e in events if "token" in e]
    return (not any("error" in e for e in events)
            and events[-1] == {"done": True, "tokens": toks})


def _fleet_exact(torch, seed):
    """(b): every stream token for token one scheduler's greedy decode."""
    import threading
    from collections import deque
    from mxnet_tpu_torch.fleet import Router
    from mxnet_tpu_torch.resilience import FaultPlan
    from mxnet_tpu_torch.serving import GenerationScheduler
    fp32 = _random_llama(torch, seed, torch.float32, 4)
    system = _prompts(seed + 11, (FLEET["exact_system"],))[0]
    prompts = [system + s for s in _prompts(seed + 12,
                                            FLEET["exact_suffixes"])]
    solo = _prompts(seed + 13, (FLEET["migrate_prompt"],) * 4)
    new = FLEET["exact_new"]
    oracle = GenerationScheduler(
        fp32, name="fleet_exact_oracle", max_slots=FLEET["exact_slots"],
        kv_cache=True, page_tokens=FLEET["page_tokens"], prefix_cache=True,
        max_length=FLEET["exact_max_length"])
    want = {}
    for p in prompts + solo:
        fut = oracle.submit(p, max_new_tokens=new, eos_id=None)
        oracle.run()
        want[tuple(p)] = fut.result(timeout=0)
    del oracle
    t0 = time.perf_counter()
    a, b = (_ExactReplica(fp32, tag, "mixed") for tag in ("a", "b"))
    pre, dec = (_ExactReplica(fp32, role, role)
                for role in ("prefill", "decode"))
    warm_s = time.perf_counter() - t0
    out, gates, same, missed = {"warmup_s": warm_s}, {}, [], []

    def hold(p, toks, events=None):
        same.append(toks == want[tuple(p)]
                    and (events is None or _clean(events)))
        if toks != want[tuple(p)] and toks is not None:
            missed.append((p, toks))
        return same[-1]

    # disaggregation, blocking and streamed
    router = Router([(pre.url, "prefill"), (dec.url, "decode")], poll_s=999)
    for p in prompts:
        code, body = router.route_generate(
            "lm", {"prompt": p, "max_new_tokens": new, "eos_id": None})
        hold(p, body.get("tokens") if code == 200 else None)
    toks, events = _stream_events(router, prompts[0], new)
    gates["b_disaggregated"] = hold(prompts[0], toks, events) and all(same)
    # prefix affinity: the second prompt of the system prefix follows
    router = Router([a.url, b.url], poll_s=999)
    admitted = [a.sched.admitted, b.sched.admitted]
    routed = _fleet_counter("mxnet_tpu_fleet_prefix_routed_total",
                            model="lm")
    code, body = router.route_generate(
        "lm", {"prompt": prompts[1], "max_new_tokens": new, "eos_id": None})
    hold(prompts[1], body.get("tokens"))
    first = a if a.sched.admitted > admitted[0] else b
    hits = first.sched.stats_snapshot()["page_pool"]["prefix_hits"]
    router.refresh()
    code, body = router.route_generate(
        "lm", {"prompt": prompts[2], "max_new_tokens": new, "eos_id": None})
    hold(prompts[2], body.get("tokens"))
    gates["b_prefix_affinity"] = (
        first.sched.admitted == admitted[(first is b)] + 2
        and first.sched.stats_snapshot()["page_pool"]["prefix_hits"]
        >= hits + FLEET["exact_system"] // FLEET["page_tokens"]
        and _fleet_counter("mxnet_tpu_fleet_prefix_routed_total",
                           model="lm") > routed)
    # migration with snapshots, by stopping the serving replica
    router = Router([a.url, b.url], poll_s=999,
                    snapshot_tokens=FLEET["snapshot_tokens"])
    router.replicas[1].in_flight = 1          # a serves first
    a.settle(FLEET["step_delay_s"])
    code, events = router.route_generate_stream(
        "lm", {"prompt": solo[0], "max_new_tokens": new, "eos_id": None})
    it, head = iter(events), []
    while sum("token" in e for e in head) < 2 * FLEET["snapshot_tokens"]:
        head.append(next(it))
    stopper = threading.Thread(target=a.srv.stop, kwargs={"timeout": 60})
    stopper.start()
    events = head + list(it)
    stopper.join(120)
    entries_b = len(b.sched._target._op._cache)
    gates["b_migrate_snapshot_stop"] = hold(
        solo[0], [e["token"] for e in events if "token" in e], events) \
        and router.migrations == 1 and router.replicas[0].status == "DEAD"
    out["migrate_snapshot"] = {"migrations": router.migrations,
                               "snapshot_tokens": FLEET["snapshot_tokens"]}
    a.start()
    # migration without a snapshot, by a relay fault
    router = Router([a.url, b.url], poll_s=999, snapshot_tokens=0)
    router.replicas[1].in_flight = 1
    with FaultPlan({"relay": [f"ok*{FLEET['relay_fault_after']}",
                              "unavailable"]}) as plan:
        toks, events = _stream_events(router, solo[1], new)
    gates["b_migrate_relay_fault"] = hold(solo[1], toks, events) \
        and router.migrations == 1 \
        and plan.triggered[-1] == ("relay", "unavailable")
    # a hedged first token
    a.settle(FLEET["hedge_delay_s"])
    b.settle(0.0)
    router = Router([a.url, b.url], poll_s=999, hedge_pctl=99)
    router._ft_samples["lm"] = deque([0.01] * 32, maxlen=512)
    router.replicas[1].in_flight = 5          # the slow a is the primary
    cancelled = a.sched.cancelled
    toks, events = _stream_events(router, solo[2], new)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not (
            a.sched.cancelled > cancelled and a.active_pages() == 0):
        time.sleep(0.05)
    out["hedge"] = {"won": router.hedges_won, "lost": router.hedges_lost,
                    "loser_cancelled": a.sched.cancelled - cancelled,
                    "loser_active_pages": a.active_pages(),
                    "identical": toks == want[tuple(solo[2])]}
    gates["b_hedge"] = hold(solo[2], toks, events) \
        and router.hedges_won == 1 and a.sched.cancelled > cancelled \
        and a.active_pages() == 0
    # a rolling restart under load
    a.settle(FLEET["step_delay_s"])
    b.settle(FLEET["step_delay_s"])
    router = Router([a.url, b.url], poll_s=999)
    results = [None] * 3

    def run(k):
        results[k] = _stream_events(router, prompts[k + 1], new)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and len(router._jobs) < 2:
        time.sleep(0.02)
    report = router.rolling_restart(
        lambda i, rep: (a, b)[i].restart(), ready_timeout=120,
        drain_timeout=60, evac_timeout=60)
    for t in threads:
        t.join(300)
    gates["b_rolling_restart"] = all(
        r is not None and hold(prompts[k + 1], *r)
        for k, r in enumerate(results)) \
        and sum(r["migrated_streams"] for r in report) >= 1 \
        and all(_ping(rep.url) == "SERVING" for rep in (a, b))
    out["rolling_restart"] = report
    # a client walks away: the Router cancels upstream
    a.settle(FLEET["step_delay_s"])
    router = Router([a.url], poll_s=999)
    host, port = router.start_http("127.0.0.1", 0)
    cancelled = a.sched.cancelled
    _drop_sse(f"http://{host}:{port}", "lm", solo[3], new)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not (
            a.sched.cancelled > cancelled and a.active_pages() == 0):
        time.sleep(0.05)
    router.stop()
    gates["b_cancel"] = a.sched.cancelled > cancelled \
        and a.active_pages() == 0 and router.cancelled == 1
    a.delay = b.delay = 0.0
    gates["b_all_streams_identical"] = all(same)
    gates["b_no_new_entries"] = all(
        len(r.sched._target._op._cache) == r.entries
        for r in (a, b, pre, dec)) and entries_b == b.entries
    out.update({"streams": len(same), "identical": sum(same),
                "divergences": _divergences(
                    torch, fp32, [p for p, _ in missed],
                    [t for _, t in missed],
                    [want[tuple(p)] for p, _ in missed])})
    for r in (a, b, pre, dec):
        r.srv.stop(timeout=60)
    del a, b, pre, dec, fp32, router
    gc.collect()
    torch.cuda.empty_cache()
    return out, gates


def _ping(url):
    import urllib.request
    try:
        with urllib.request.urlopen(url + "/ping", timeout=10) as r:
            return json.loads(r.read()).get("status")
    except Exception:  # noqa: BLE001 - down
        return None


def _fleet_chaos(seed):
    """(c): tools/chaos_torch.py in its own session (killed as a group at
    its limit): its JSON report."""
    import signal
    c = FLEET["chaos"]
    cmd = [sys.executable, str(Path(__file__).resolve().parent / "tools"
                               / "chaos_torch.py"),
           "--device", "cuda", "--llm", "lm=llama_7b", "--layers", "4",
           "--dtype", "float32", "--seed", str(seed),
           "--max-length", str(c["max_length"]),
           "--slots", str(c["slots"]), "--requests", str(c["requests"]),
           "--max-new", str(c["max_new"]), "--kills", str(c["kills"]),
           "--interarrival-s", str(c["interarrival_s"]),
           "--kill-wait-s", str(c["kill_wait_s"]), "--json"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=c["timeout_s"])
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SmokeFailure(f"chaos_torch.py passed its {c['timeout_s']} s")
    lines = stdout.strip().splitlines()
    check(lines, f"chaos_torch.py printed nothing (rc {proc.returncode}): "
          f"{stderr[-2000:]}")
    report = json.loads(lines[-1])
    report["rc"] = proc.returncode
    return report


def _fleet_kernels(torch, seed, llama, bert, prompts):
    """(d): the flash kernels on the fleet path, each held against its
    plain version at the path's shape, then BERT-base behind two
    replicas' /predict and llama_7b's dense engine behind two replicas'
    /generate, through the Router; launches counted over the traffic,
    which replays the warmed graphs only."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.fleet import Router
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.serving import GenerationScheduler, ModelServer
    from mxnet_tpu_torch.serving.server import Client
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    b, h, s, d = FLASH_DECODE
    q, k, v = (torch.randn(b * h, s, d, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    before = A.flash_fwd_wgmma_launches
    o, lse = A.flash_fwd(q, k, v, True, 1.0 / math.sqrt(d))
    ran = A.flash_fwd_wgmma_launches - before == 1
    ro, rl = A._flash_forward_plain(q.float(), k.float(), v.float(), True,
                                    1.0 / math.sqrt(d))
    ratio = ((o.float() - ro).abs() / (BF16_O_REL * ro.abs()
                                       + BF16_O_ABS)).max().item()
    wgmma_case = {"shape": list(FLASH_DECODE), "ran_wgmma": ran,
                  "o_half_ulp_ratio": ratio,
                  "lse_err": (lse - rl).abs().max().item()}
    wgmma_case["ok"] = ran and ratio <= 1.0 \
        and wgmma_case["lse_err"] <= TOL["bfloat16"]["lse"]
    del q, k, v, o, lse, ro, rl
    tf32_case = _flash_at(torch, seed, (SERVE["max_batch"],))[0]
    out = {"wgmma_at_dense_shape": wgmma_case,
           "tf32_at_bert_shape": tf32_case}

    # BERT-base behind two replicas' /predict
    servers, engines = [], []
    for i in range(2):
        srv = ModelServer()
        engines.append(srv.register(
            "bert", bert, max_batch=SERVE["max_batch"],
            max_wait_us=SERVE["max_wait_us"],
            input_spec=[((SERVE_BERT["seq"],), "int32")]))
        servers.append((srv, f"http://127.0.0.1:{srv.start_http()}"))
    router = Router([u for _, u in servers], poll_s=999)
    host, port = router.start_http("127.0.0.1", 0)
    vocab = bert.word_embed._input_dim
    reqs = _serve_requests(seed + 5, (SERVE_BERT["seq"],),
                           lambda rng, shape: rng.randint(
                               0, vocab, shape).astype(np.int32))
    reqs = reqs[:FLEET["bert_requests"]]
    replays = [e._op._replays for e in engines]
    A.flash_fwd_launches = A.flash_fwd_wgmma_launches = 0
    A.flash_fwd_tf32_launches = 0
    client = Client(f"http://{host}:{port}")
    answers, lat, wall = _pooled(reqs, lambda x: client.predict(
        "bert", [x.tolist()]), 4)
    for srv, _ in servers:
        srv.stop()
    router.stop()
    forwards = sum(e._op._replays - r for e, r in zip(engines, replays))
    tf32 = {"flash_fwd": A.flash_fwd_launches,
            "tf32": A.flash_fwd_tf32_launches,
            "wgmma": A.flash_fwd_wgmma_launches, "replays": forwards}
    worst, shapes = 0.0, True
    for x, got in zip(reqs, answers):
        ref = bert(mx.nd.array(x, ctx=mx.gpu(0), dtype="int32"))
        for g, r in zip(got, ref):
            g, r = np.asarray(g, np.float32), r.asnumpy()
            shapes = shapes and g.shape == r.shape and r.shape[0] == len(x)
            err = float(np.abs(g - r).max())
            worst = max(worst, err / (SERVE["card_rel"] * float(
                np.abs(r).max()) + SERVE["abs"]))
    out["bert"] = {"requests": len(reqs), "launches": tf32,
                   "worst_err_over_bound": worst,
                   "balanced": [e._op._replays > r
                                for e, r in zip(engines, replays)],
                   **_latency_line(lat, sum(len(x) for x in reqs), wall)}
    del servers, engines, answers

    # llama_7b's dense engine behind two replicas' /generate
    servers, scheds = [], []
    for i in range(2):
        srv = ModelServer()
        scheds.append(srv.register_generation(
            "llama_dense", None, warmup=True,
            warmup_prompt_len=max(PROMPTS),
            scheduler=GenerationScheduler(llama, kv_cache=False,
                                          max_slots=FLEET["slots"],
                                          name=f"fleet_dense{i}")))
        servers.append((srv, f"http://127.0.0.1:{srv.start_http()}"))
    router = Router([u for _, u in servers], poll_s=999)
    host, port = router.start_http("127.0.0.1", 0)
    replays = [s._op._replays for s in scheds]
    warm_entries = [len(s._op._cache) for s in scheds]
    torch.cuda.synchronize()
    A.flash_fwd_launches = A.flash_fwd_wgmma_launches = 0
    A.flash_fwd_tf32_launches = 0
    client = Client(f"http://{host}:{port}")
    routed, lat, wall = _pooled(prompts, lambda p: client.generate(
        "llama_dense", p, max_new_tokens=NEW_TOKENS, eos_id=None),
        len(prompts))
    torch.cuda.synchronize()
    forwards = sum(s._op._replays - r for s, r in zip(scheds, replays))
    wgmma = {"flash_fwd": A.flash_fwd_launches,
             "wgmma": A.flash_fwd_wgmma_launches,
             "tf32": A.flash_fwd_tf32_launches, "replays": forwards}
    router.stop()
    # the same prompts on one replica in process, against the routed ones
    direct = [servers[0][0].generate("llama_dense", p, NEW_TOKENS,
                                     eos_id=None) for p in prompts]
    for srv, _ in servers:
        srv.stop()
    noise = _bf16_logit_noise(torch, llama, prompts[0])
    floor = max(noise["dense_vs_dense_padded"], noise["dense_vs_paged"])
    div = _divergences(torch, llama, prompts, routed, direct)
    out["llama_dense"] = {
        "launches": wgmma, "tokens_per_s": len(prompts) * NEW_TOKENS / wall,
        "wall_s": wall, "tokens_agree_with_direct":
        f"{_agree(routed, direct)}/{len(prompts) * NEW_TOKENS}",
        "divergences": div, "bf16_noise": floor,
        "new_entries": [len(s._op._cache) - e
                        for s, e in zip(scheds, warm_entries)]}
    gates = {
        "d_kernels_match_plain": wgmma_case["ok"] and tf32_case["ok"],
        "d_bert_answers": worst <= 1.0 and shapes,
        "d_no_new_entries": out["llama_dense"]["new_entries"] == [0, 0],
        "d_bert_tf32_launches": tf32["tf32"] == 12 * tf32["replays"] > 0
        and tf32["flash_fwd"] == tf32["tf32"] and tf32["wgmma"] == 0,
        "d_dense_wgmma_launches": wgmma["wgmma"]
        == FLEET["layers"] * wgmma["replays"] > 0
        and wgmma["flash_fwd"] == wgmma["wgmma"] and wgmma["tf32"] == 0,
        "d_dense_tokens": all(len(t) == NEW_TOKENS for t in routed) and all(
            x is None or x["top2_margin"] < floor for x in div)}
    del servers, scheds
    gc.collect()
    torch.cuda.empty_cache()
    return out, gates, tf32["tf32"], wgmma["wgmma"]


def phase_fleet_models(torch, seed, bert=None):
    """The fleet phase's parts on llama_7b at FLEET["layers"] layers and
    the serving phase's BERT-base: (a) and (d).  Returns (partial line,
    gates, bf16 wgmma launches, fp32 tf32 launches) for phase_fleet."""
    import mxnet_tpu_torch as mx
    card = _card()
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    llama = _random_llama(torch, seed, torch.bfloat16, FLEET["layers"])
    if bert is None:
        from mxnet_tpu_torch.gluon.model_zoo.language import bert_12_768_12
        mx.random.seed(seed)
        bert = bert_12_768_12(ctx=mx.gpu(0))
        bert.initialize(mx.init.Normal(0.02))
    prompts = _prompts(seed + 3, PROMPTS)
    disagg, gates = _fleet_disagg(torch, llama, prompts)
    kernels, kgates, tf32, wgmma = _fleet_kernels(torch, seed, llama, bert,
                                                  prompts)
    gates.update(kgates)
    line = {"phase": "fleet", "card": card, "llama_layers": FLEET["layers"],
            "a_disaggregated_llama_7b_bf16": disagg, "d_kernels": kernels,
            "models_seconds": time.perf_counter() - t0}
    return line, gates, wgmma, tf32


def phase_fleet(torch, seed, line, gates):
    """The fleet (slice 18): (b) and (c) after phase_fleet_models's (a)
    and (d) freed their models; emits the phase's one line."""
    t0 = time.perf_counter()
    exact, egates = _fleet_exact(torch, seed)
    gates.update(egates)
    chaos = _fleet_chaos(seed)
    gates.update({
        "c_chaos_ok": chaos.get("ok") is True and chaos["rc"] == 0,
        "c_zero_failed": chaos.get("chaos_failed") == 0
        and chaos.get("baseline_failed") == 0,
        "c_parity": chaos.get("chaos_parity_diverged") == 0,
        "c_respawned": chaos.get("supervisor_restarts", 0)
        >= len(chaos.get("kills_done", [])) >= 1})
    line.update({"b_exact_fp32_4_layers": exact, "c_chaos": chaos,
                 "gates": gates,
                 "seconds": line.pop("models_seconds")
                 + time.perf_counter() - t0})
    line["ok"] = all(gates.values())
    emit(line)
    a = line["a_disaggregated_llama_7b_bf16"]
    for cell in ("mixed", "disaggregated"):
        c = a[cell]
        print(f"fleet {cell} [{line['card']}]: " + json.dumps(
            {"tokens_per_s": [r["tokens_per_s"] for r in c["rounds"]],
             "first_token_ms": [r["first_token_ms"] for r in c["rounds"]],
             "peak_mem_gb": c["peak_mem_gb"]}), flush=True)
    check(line["ok"], f"fleet gates failed: "
          f"{[k for k, v in gates.items() if not v]}")


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
    from mxnet_tpu_torch.ops import embedding as EMB
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
        # prefetch (run P): epoch 0 again from run A's start over a host
        # NDArrayIter (CPU arrays) through fit(prefetch_to_device=True),
        # which stages each batch onto the card from a pinned ring on a
        # side stream; its parameters must be run A's after epoch 0 bit
        # for bit (the Embedding backward is deterministic on the card)
        host_it = mx.io.NDArrayIter(mx.nd.array(x, ctx=mx.cpu()),
                                    mx.nd.array(y, ctx=mx.cpu()),
                                    batch_size=m["batch"])
        steps_pf = []

        def step_end_pf(param):
            torch.cuda.synchronize()
            steps_pf.append(time.perf_counter() - param.locals["self"]._t0)

        fl0 = (A.flash_fwd_launches, A.flash_fwd_tf32_launches,
               A.flash_fwd_wgmma_launches, forwards[0],
               EMB.embedding_bwd_launches)
        mod = Module(sym, context=gpu)
        mod.fit(host_it, num_epoch=1, kvstore="device", arg_params=init,
                aux_params={}, batch_end_callback=step_end_pf,
                prefetch_to_device=True, **fit)
        torch.cuda.synchronize()
        pf_params = mod.get_params()[0]
        prefetch = {
            "flash_fwd": A.flash_fwd_launches - fl0[0],
            "tf32": A.flash_fwd_tf32_launches - fl0[1],
            "wgmma": A.flash_fwd_wgmma_launches - fl0[2],
            "forwards": forwards[0] - fl0[3],
            "embedding_bwd": EMB.embedding_bwd_launches - fl0[4],
            "step_ms": 1e3 * statistics.median(steps_pf),
            "steps": len(steps_pf),
            "bitwise_equal": sum(torch.equal(v._data.cpu(),
                                             epoch0[k]._data.cpu())
                                 for k, v in pf_params.items()),
            "params": len(epoch0),
            "gap": _param_gap(pf_params, epoch0, m["kv_rel"], m["kv_abs"])}
        del mod, pf_params, host_it
        torch.cuda.empty_cache()
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
           "prefetch": prefetch,
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
        "prefetch_bitwise": prefetch["bitwise_equal"] == prefetch["params"]
        and prefetch["steps"] == batches_per_epoch,
        "prefetch_launches": prefetch["tf32"] == layers * prefetch["forwards"]
        and prefetch["flash_fwd"] == prefetch["tf32"]
        and prefetch["wgmma"] == 0
        and prefetch["forwards"] == batches_per_epoch
        # one per step, and one in the first step's warm-up backward,
        # which the Executor runs before it captures and throws away
        and prefetch["embedding_bwd"] == batches_per_epoch + 1,
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
    return main["tf32"], prefetch["tf32"], prefetch["embedding_bwd"]


# ---------------------------------------------------------------------------
# slice 16: the input pipeline
# ---------------------------------------------------------------------------
# Full-width resnet50_v1 (fused fp32, bench.py's step: 224 px, batch 256,
# SGD lr 0.1, momentum 0.9, wd 1e-4, CompiledTrainStep's graph) fed from a
# RecordIO file on local disk through ImageRecordIter (native reader, 4
# decode threads, random crop and mirror, ImageNet mean/std) and
# DevicePrefetchIter(ctx=mx.gpu(0)).  The file is written from the seed
# into a temporary directory and deleted after the phase: 1024 JPEG
# records (quality 90) of 256x256x3 images (a random 32x32 image scaled up
# bilinearly, plus uniform noise in [-8, 8]) with labels in [0, 1000).
# Pillow imports on the card's machine (PIL 12.2.0), so the records are
# JPEGs through pack_img.
#
# The twin gate runs with torch's deterministic algorithms (cuDNN's
# deterministic choices, as the training phases' parity pairs): one
# unshuffled epoch through the prefetcher, the host batches kept aside as
# they leave ImageRecordIter (so the random crops and flips are the ones
# staged), then a twin from the same weights fed those host batches with a
# plain synchronous .to(device): the parameters, buffers and momenta must
# agree bit for bit.  Each staged batch must equal its host batch bit for
# bit on INPUT["sample_rows"] rows.  The main path runs with the default
# algorithms: INPUT["epochs"] epochs of INPUT["batches"] batches (reset()
# between epochs), the fused kernel's launches counted over all of them,
# epochs 2..epochs-1 timed and the last traced with torch.profiler (the
# device's busy share, and the streams of the host-to-device copies
# against those of the step's kernels).
INPUT = dict(records=1024, side=256, px=224, batch=256, batches=4, epochs=4,
             classes=1000, quality=90, threads=4, sample_rows=8,
             mean=(123.68, 116.779, 103.939), std=(58.393, 57.12, 57.375),
             big_copy_bytes=1 << 20, goodput_abs=1e-5)


def _write_image_records(seed, path_rec, path_idx):
    """INPUT["records"] JPEG records from ``seed`` (see INPUT)."""
    import numpy as np
    from PIL import Image

    from mxnet_tpu_torch import recordio
    rng = np.random.RandomState(seed)
    side = INPUT["side"]
    w = recordio.MXIndexedRecordIO(path_idx, path_rec, "w")
    for i in range(INPUT["records"]):
        small = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
        big = np.asarray(Image.fromarray(small).resize((side, side),
                                                       Image.BILINEAR))
        img = np.clip(big.astype(np.int16)
                      + rng.randint(-8, 9, big.shape), 0, 255)
        label = float(rng.randint(0, INPUT["classes"]))
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, label, i, 0),
                                         img.astype(np.uint8),
                                         quality=INPUT["quality"]))
    w.close()


class _KeepHost:
    """A DataIter over ``inner`` that keeps a copy of each host batch it
    hands out (before the prefetcher stages it)."""

    def __init__(self, inner, keep):
        self._inner, self._keep = inner, keep
        self.batch_size = inner.batch_size

    def next(self):
        b = self._inner.next()
        if self._keep is not None:
            self._keep.append((b.data[0]._data.clone(),
                               b.label[0]._data.clone()))
        return b

    def reset(self):
        self._inner.reset()

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label


def _trace_events(torch, fn, runtime=False):
    """``fn()`` under torch.profiler: (wall ms, the device's events: its
    kernels, copies and sets; with ``runtime``, the host's CUDA runtime
    calls too)."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.load(open(f.name))["traceEvents"]
    cats = ("kernel", "gpu_memcpy", "gpu_memset") + (
        ("cuda_runtime",) if runtime else ())
    return wall_ms, [e for e in events if e.get("cat") in cats and "dur" in e]


def _union_ms(spans):
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _trace_gpu(torch, fn):
    """``fn()`` under torch.profiler: (wall ms, the device's busy share of
    it (union of kernels, copies and sets), the kernels' alone, the
    streams of kernels, the streams and bytes of host-to-device copies)."""
    wall_ms, gpu = _trace_events(torch, fn)
    kernels = [e for e in gpu if e["cat"] == "kernel"]
    h2d = [e for e in gpu if e["cat"] == "gpu_memcpy"
           and "HtoD" in e.get("name", "")]
    return {"wall_ms": wall_ms,
            "busy_share": _union_ms([(e["ts"], e["ts"] + e["dur"])
                                     for e in gpu]) / wall_ms,
            "kernel_share": _union_ms([(e["ts"], e["ts"] + e["dur"])
                                       for e in kernels]) / wall_ms,
            "kernel_streams": sorted({e["args"].get("stream")
                                      for e in kernels}),
            "h2d": [(e["args"].get("stream"), e["args"].get("bytes", 0),
                     e["dur"]) for e in h2d]}


def phase_input_pipeline(torch, seed):
    """Full-width resnet50_v1 fed from a RecordIO file through
    DevicePrefetchIter (see INPUT); returns the fused kernel's launches on
    the main path."""
    import itertools
    import shutil
    import statistics
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.io import native
    from mxnet_tpu_torch.io.io import _M_PREFETCH_SECONDS
    from mxnet_tpu_torch.observability import goodput, metrics
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    t_phase = time.perf_counter()
    inp = INPUT
    check(native.available(), "input_pipeline: the native recordio reader "
          "did not build")
    _free(torch)
    tmp = tempfile.mkdtemp(prefix="input_pipeline_")
    out = {"phase": "input_pipeline", "model": "resnet50_v1", "fused": True,
           "dtype": "float32", "batch": inp["batch"], "px": inp["px"],
           "records": inp["records"], "record_side": inp["side"],
           "jpeg_quality": inp["quality"], "decode_threads": inp["threads"],
           "card": _card(), "tf32": _tf32(torch)}
    gates = {}
    try:
        rec, idx = f"{tmp}/train.rec", f"{tmp}/train.idx"
        t0 = time.perf_counter()
        _write_image_records(seed, rec, idx)
        out["write_s"] = time.perf_counter() - t0
        out["file_mb"] = os.path.getsize(rec) / 1e6
        mean = dict(zip(("mean_r", "mean_g", "mean_b"), inp["mean"]))
        std = dict(zip(("std_r", "std_g", "std_b"), inp["std"]))

        def records(keep=None):
            it = mx.io.ImageRecordIter(
                path_imgrec=rec, path_imgidx=idx,
                data_shape=(3, inp["px"], inp["px"]),
                batch_size=inp["batch"], shuffle=False, rand_crop=True,
                rand_mirror=True, preprocess_threads=inp["threads"],
                seed=seed, **mean, **std)
            return it, _KeepHost(it, keep)

        def build():
            net = _resnet50(torch, True, seed)
            return net, _train_step(net, inp["batch"])

        # 1. the twin gate, deterministic algorithms on
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            kept, staged_equal = [], []
            reader, src = records(kept)
            net, step = build()
            with mx.io.DevicePrefetchIter(src, ctx=mx.gpu(0)) as pf:
                for i, b in enumerate(pf):
                    x, y = b.data[0]._data, b.label[0]._data
                    step(x, y)
                    rows = torch.linspace(0, inp["batch"] - 1,
                                          inp["sample_rows"]).long()
                    staged_equal.append(
                        torch.equal(x[rows.cuda()].cpu(), kept[i][0][rows])
                        and torch.equal(y.cpu(), kept[i][1]))
            reader.close()
            fed = _snapshot(step)
            del net, step
            _free(torch)
            net, twin = build()
            for hx, hy in kept:
                twin(hx.to("cuda"), hy.to("cuda"))
            twin_gap = _gap(torch, _snapshot(twin), fed)
            del net, twin, fed
            _free(torch)
        finally:
            torch.use_deterministic_algorithms(False)
        out["twin"] = {"batches": len(kept), **twin_gap}
        gates["staged_equals_host"] = (len(staged_equal) == inp["batches"]
                                       and all(staged_equal))
        gates["twin_bitwise"] = (len(kept) == inp["batches"]
                                 and twin_gap["bitwise_equal"]
                                 == twin_gap["tensors"])

        # 2. the main path, default algorithms
        reader, src = records()
        net, step = build()
        pf = mx.io.DevicePrefetchIter(src, ctx=mx.gpu(0))
        wait0 = goodput.train().totals()["buckets"].get("input_wait", 0.0)
        put = metrics.registry().get("mxnet_tpu_io_device_put_seconds")
        h0 = (_M_PREFETCH_SECONDS.count, _M_PREFETCH_SECONDS.sum,
              put.count, put.sum)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        FC.fused_conv_bn_launches = FC.fused_conv_bn_wgmma_launches = 0
        losses, epoch_ms, steps = [], [], 0

        def epoch():
            nonlocal steps
            pf.reset()
            t0 = time.perf_counter()
            n = 0
            for b in pf:
                loss = step(b.data[0]._data, b.label[0]._data)
                n += 1
            losses.append(loss.item())
            steps += n
            return 1e3 * (time.perf_counter() - t0) / n

        for e in range(inp["epochs"] - 1):
            epoch_ms.append(epoch())
        trace = _trace_gpu(torch, lambda: epoch_ms.append(epoch()))
        launches = {"fused_conv_bn_launches": FC.fused_conv_bn_launches,
                    "fused_conv_bn_wgmma_launches":
                        FC.fused_conv_bn_wgmma_launches}
        stats = pf.stats()
        pf.close()
        pf._loop._thread.join(timeout=60)
        reader.close()
        wait = (goodput.train().totals()["buckets"].get("input_wait", 0.0)
                - wait0)
        n_host = _M_PREFETCH_SECONDS.count - h0[0]
        out["main"] = {
            "epochs": inp["epochs"], "steps": steps,
            "step_ms_prefetch": statistics.mean(epoch_ms[1:-1]),
            "epoch_step_ms": epoch_ms, "losses": losses,
            "stats": stats, "input_wait_s": wait,
            "host_ms_per_batch": 1e3 * (_M_PREFETCH_SECONDS.sum - h0[1])
            / max(n_host, 1),
            "stage_host_ms_per_batch": 1e3 * (put.sum - h0[3])
            / max(put.count - h0[2], 1),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "pinned_mb": stats["pinned_bytes"] / 1e6, **launches}
        big = [h for h in trace["h2d"] if h[1] >= inp["big_copy_bytes"]]
        out["trace"] = {
            "wall_ms": trace["wall_ms"], "busy_share": trace["busy_share"],
            "kernel_share": trace["kernel_share"],
            "kernel_streams": trace["kernel_streams"],
            "h2d_streams": sorted({h[0] for h in big}),
            "h2d_copies": len(big),
            "h2d_ms_mean_traced": (statistics.mean(h[2] for h in big) / 1e3
                                   if big else None)}
        want = FUSED_LAUNCHES_PER_STEP * steps
        gates["launches"] = (steps == inp["epochs"] * inp["batches"]
                             and launches["fused_conv_bn_launches"] == want
                             and launches["fused_conv_bn_wgmma_launches"]
                             == want)
        gates["input_wait_matches_stats"] = (
            abs(wait - stats["wait_seconds"]) <= inp["goodput_abs"])
        gates["copies_on_side_stream"] = bool(big) and not (
            set(out["trace"]["h2d_streams"]) & set(trace["kernel_streams"]))
        gates["losses_finite"] = all(math.isfinite(v) for v in losses)

        # 3. the same step fed the kept host batches synchronously, then
        # one batch resident on the card; and one batch's copy alone
        hx, hy = kept[0]
        cycle = itertools.cycle(kept)
        sync_ms = _timed(torch, lambda: step(*[t.to("cuda") for t in
                                               next(cycle)]),
                         2, 2 * len(kept))["step_ms"]
        dx, dy = hx.to("cuda"), hy.to("cuda")
        resident_ms = _timed(torch, lambda: step(dx, dy), 2,
                             2 * len(kept))["step_ms"]
        pinned = hx.pin_memory()
        out["step_ms"] = {"prefetch": out["main"]["step_ms_prefetch"],
                          "sync_to_device": sync_ms, "resident": resident_ms}
        out["h2d_ms"] = {
            "pinned": cuda_ms(torch, lambda: dx.copy_(pinned,
                                                      non_blocking=True), 5),
            "pageable": cuda_ms(torch, lambda: dx.copy_(hx), 5),
            "batch_mb": hx.numel() * hx.element_size() / 1e6}
        del net, step, dx, dy, pinned, kept, pf
        _free(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["gates"] = gates
    out["seconds"] = time.perf_counter() - t_phase
    out["ok"] = all(gates.values())
    emit(out)
    check(out["ok"], f"input_pipeline failed: "
          f"{[k for k, v in gates.items() if not v]}")
    return out["main"]["fused_conv_bn_launches"]


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
    # divergence checksums over the trained weights: a round that agrees,
    # then rank 1 moves one weight by one ulp and rank 0's round names it
    kv = mx.kv.create("dist_sync")
    named = {p.name: p.data()._data for p in net.collect_params().values()}
    t0 = time.perf_counter()
    first = kv.divergence_round(named)
    round_s = time.perf_counter() - t0
    key = next(iter(named))
    if rank == 1:
        with torch.no_grad():
            flat = named[key].view(-1)
            flat[0] = torch.nextafter(flat[0], torch.tensor(
                math.inf, device=flat.device))
    second = kv.divergence_round(named)
    out["divergence"] = {"key": key, "first_agree": first["agree"],
                         "second_diverging": second["diverging"],
                         "rounds": kv._rounds_completed.get(
                             "divergence_checksum", 0),
                         "round_s": round_s, "keys": len(named)}
    del kv, named
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
           "losses": [r["trainer"]["4096"]["loss"] for r in ranks],
           "divergence": [r["divergence"] for r in ranks]}
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
        "divergence_named": all(r["divergence"]["first_agree"]
                                and r["divergence"]["rounds"] == 2
                                for r in ranks)
        and r0["divergence"]["second_diverging"] == [
            {"rank": 1, "key": r0["divergence"]["key"], "scope": "process"}],
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


# The Embedding backward (csrc/embedding_bwd.cu, C12): BERT-base's two
# tables at its step's ids ([64, 128]: random token ids into word_embed
# [30522, 768], all-zero token types into token_type_embed [2, 768], one
# segment of 8192 rows), a bf16 case with 1000 ids, some out of range,
# into [1000, 96], and the LSTM language model's encoder (ops_rnn): a
# [35, 20] window of Zipf-distributed ids into [10000, 1500].  The kernel against the plain version (zeros().index_add_
# in fp32, on the card): fp32 within 1e-5 of the plain table's largest
# |value| (the two add up to 8192 rows in other orders); bf16 per element
# within half a bf16 ulp of the plain fp32 sum plus that order term (the
# kernel rounds its fp32 sum once).  Two launches on the same inputs must
# give the same bits.  Timed beside the plain version and F.embedding's
# backward (aten::embedding_dense_backward, the library call).
EMB_CASES = (("word_embed", 30522, 768, (64, 128), "random", "float32"),
             ("token_type_embed", 2, 768, (64, 128), "zeros", "float32"),
             ("ragged_bf16", 1000, 96, (1000,), "out_of_range", "bfloat16"),
             ("lm_encoder", 10000, 1500, (35, 20), "zipf", "float32"))
EMB_TOL = dict(fp32_rel=1e-5, bf16_rel=2.0 ** -8)
EMBEDDINGS_PER_BERT_STEP = 2


def phase_embedding_bwd(torch, seed):
    """C12's kernel at its paths' shapes (see EMB_CASES); returns each
    case's timing for the kernel line."""
    from mxnet_tpu_torch.ops import embedding as EMB
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    cases = {}
    for name, vocab, d, shape, kind, dtype in EMB_CASES:
        dt = getattr(torch, dtype)
        if kind == "random":
            ids = torch.randint(0, vocab, shape, generator=gen, device="cuda")
        elif kind == "zeros":
            ids = torch.zeros(shape, dtype=torch.int64, device="cuda")
        elif kind == "zipf":
            p = torch.arange(1, vocab + 1, dtype=torch.float64,
                             device="cuda") ** -LSTM_LM["zipf"]
            ids = torch.multinomial(p, math.prod(shape), replacement=True,
                                    generator=gen).reshape(shape)
        else:
            ids = torch.randint(-vocab - 200, vocab + 200, shape,
                                generator=gen, device="cuda")
        dy = torch.randn(*shape, d, generator=gen, device="cuda").to(dt)
        got = EMB.embedding_backward(ids, dy, vocab)
        again = EMB.embedding_backward(ids, dy, vocab)
        ref32 = EMB._reference_embedding_bwd(ids, dy.float(), vocab)
        err = (got.float() - ref32).abs()
        scale = ref32.abs().max().item()
        if dtype == "float32":
            ok_close = err.max().item() <= EMB_TOL["fp32_rel"] * scale
        else:
            ok_close = bool((err <= EMB_TOL["bf16_rel"] * ref32.abs()
                             + EMB_TOL["fp32_rel"] * scale).all())
        # the library call takes valid ids only (an id outside [0, V)
        # faults on the card): invalid ids read row 0 with a zero gradient
        idx = torch.where(ids < 0, ids + vocab, ids)
        ok = (idx >= 0) & (idx < vocab)
        lib_ids = torch.where(ok, idx, 0)
        lib_dy = dy * ok.unsqueeze(-1).to(dt)
        lib = torch.ops.aten.embedding_dense_backward
        lib_a = lib(lib_dy, lib_ids, vocab, -1, False)
        lib_b = lib(lib_dy, lib_ids, vocab, -1, False)
        n = ids.numel()
        nbytes = (n * d * dy.element_size() + n * 8
                  + vocab * d * dy.element_size())
        t_bytes, t_ops = nbytes / PEAK_BYTES, n * d / PEAK_FP32_FLOPS
        row = {"vocab": vocab, "d": d, "ids": list(shape), "dtype": dtype,
               "segments": int(torch.unique(ids[(ids >= -vocab)
                                                & (ids < vocab)]).numel()),
               "max_abs_err": err.max().item(), "max_abs_ref": scale,
               "close": ok_close, "bitwise_rerun": torch.equal(got, again),
               "library_bitwise_rerun": torch.equal(lib_a, lib_b),
               "ms": cuda_ms(torch, lambda: EMB.embedding_backward(
                   ids, dy, vocab), 20),
               "plain_ms": cuda_ms(torch, lambda: EMB._reference_embedding_bwd(
                   ids, dy, vocab), 20),
               "library_ms": cuda_ms(torch, lambda: lib(
                   lib_dy, lib_ids, vocab, -1, False), 20),
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        cases[name] = row
        del ids, dy, got, again, ref32, err, lib_a, lib_b, lib_ids, lib_dy
    gates = {f"{k}_close": v["close"] for k, v in cases.items()}
    gates.update((f"{k}_bitwise", v["bitwise_rerun"]) for k, v in
                 cases.items())
    out = {"phase": "embedding_bwd", "cases": cases, "tolerance": EMB_TOL,
           "card": _card(), "gates": gates, "ok": all(gates.values())}
    emit(out)
    check(out["ok"], f"embedding_bwd failed: "
          f"{[k for k, v in gates.items() if not v]}")
    return cases


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


def _bert_step(net, vocab, batch, opt=None):
    """BERT's CompiledTrainStep under ``opt`` (default Adam, lr 1e-4)."""
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.executor import CompiledTrainStep
    if opt is None:
        opt = optimizer.create("adam", learning_rate=BERT["lr"])
    return CompiledTrainStep(net, _bert_loss(vocab), opt, batch_size=batch)


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


def _bert_base(torch, seed, dtype, opt=None):
    """Full-width BERT-base on the card as bench.py builds it (weights from
    ``seed``, dropout 0.1 drawing from ``seed + 1``, converted to bf16
    with amp.convert_block unless ``dtype`` is float32), its step (Adam,
    or ``opt``) and its batch: ``(net, step, x, y)``."""
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
    step = _bert_step(net, vocab, BERT["batch"], opt)
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
# slice 23: AMP (op-level autocast, dynamic loss scaling) and the kernel
# registry on the card
# ---------------------------------------------------------------------------
# (a) Full-width BERT-base (bert_training's batch 64 and seq 128, Adam lr
# 1e-4, dropout 0.1) through MXNet's AMP loop under amp.init("float16"):
# amp.init_trainer, record, scale_loss on the mean loss, backward,
# Trainer.step(1), 4 steps, then the same loop in fp32 for the step-time
# comparison.  (On the sum over the batch, the loss of MXNet's image
# loop, every step overflowed at the scales 2^15 down to 2^11 in both
# models, so no update ran.)  Its twin: the same loop from the same
# weights, dropout stream and batches with the plain versions in place of
# the kernels, registered through the kernel registry at priority 99 (the
# twin's launches must be 0), on the card: the chip host's CPU did not
# finish an fp16 twin of 8 rows within 800 s.  Gates: the loss-scale and
# skip sequences equal, each step's loss within loss_rel of the twin's,
# and the gradients of the first step that updates (unscaled, all
# parameters as one vector) within bert_grad_rel of the twin's in norm.
# That limit is held by witnesses in the same run: the twin with the
# plain version's output perturbed by fixed noise at witness_factors
# times the kernel's tolerance (TWIN_TOL: O by half an fp16 ulp, lse by
# 1e-4), each gap printed; at the tolerance it must pass the limit, and
# at fault_factor times it fail it.  On an H100: 1.59e-3 apart, 1.70e-3
# at 1x the tolerance, 5.96e-3 at 10x, 5.82e-2 at 100x, 0.609 at 1000x.  The parameters
# after 4 steps are printed, not gated: Adam moves a weight by about ±lr
# whatever its gradient's size, so any rounding apart can cost 2·lr.
# (b) The same model under amp.init("bfloat16") through
# CompiledTrainStep's graph for bf16_steps steps, bit for bit its eager
# twin (deterministic algorithms), on the bf16 wgmma route.  (c)
# Full-width fused resnet50_v1 (224 px, batch 256, SGD as bench.py,
# hybridized) through the AMP loop on the mean loss under
# amp.init("float16") for 4 steps (the stem convolution's fp16 weight
# gradient overflows at 2^15 and 2^14: two skips, then updates), then
# fp32; its twin with the plain conv-BN version the same way.  Gates: the
# scale and skip sequences equal, each step's loss within resnet_loss_rel
# of the twin's, the first update's gradients within resnet_grad_rel of
# the twin's, a limit held by witnesses as in (a) (B1's y perturbed by
# 1e-4 and its statistics by 1e-5 relative, times witness_factors), the
# same limit on a kernel/twin pair with the centred variance
# (MXNET_TPU_FAST_VARIANCE=0), and the whole model's change over the 4
# steps (every parameter and running statistic, as one vector) no
# further from the twin's, in norm, than update_factor times the
# tolerance witness's.  The main run is repeated (on an H100 bit for
# bit), and the fp32 timing run has a twin too.  On an H100 the first
# update's gradients are 0.365 apart, 0.486 at 1x the tolerance and 1.38
# at 100x; the fp32 pair 0.026 apart at its first step; every tensor's
# gradient the same fraction apart (its share of the gap is its share of
# the norm), so the gap enters above every layer, not beside one kernel;
# the centred variance changes none of it (0.351).  Single tensors' updates are ill-conditioned (see
# PARITY: a BatchNorm gamma's two-update change 0.88 of its norm apart, a
# zero-initialised beta 1.0 of its largest |value|), so the worst is
# printed, not gated.  (d) The kernel registry and the config layer on
# the card.
AMP = dict(steps=4, timed=3, bf16_steps=3, loss_rel=1e-3,
           resnet_loss_rel=1e-2, bert_grad_rel=1e-2, resnet_grad_rel=0.75,
           fault_factor=100.0, witness_factors=(1.0, 100.0),
           update_factor=2.0)
# each kernel's tolerance against its plain version, as its checks hold
# it: the fp16 flash route's O within half an fp16 ulp, its lse within
# 1e-4; B1's fp32 y within 1e-4 and its statistics within 1e-5
TWIN_TOL = dict(flash_o_rel=HALF_O_REL["float16"],
                flash_lse=TOL["float16"]["lse"],
                b1_y_rel=FUSED_TOL["y_fp32_rel"],
                b1_stats_rel=FUSED_TOL["stats_rel"])


def _progress(msg):
    print(f"amp: {msg}", flush=True)


def _pseudo_noise(torch, t):
    """Fixed noise in (-1, 1) of ``t``'s shape, from its element index
    alone (no generator, so a CUDA graph may capture it)."""
    i = torch.arange(t.numel(), device=t.device, dtype=torch.float32)
    return torch.frac(torch.sin(i * 12.9898) * 43758.5453).view(t.shape)


@contextlib.contextmanager
def _plain_twin(torch, scale=0.0):
    """The plain versions registered as priority-99 kernels of
    ``flash_attention`` and ``conv1x1_bn_stats`` on the card, for a
    twin's run; removed after.  ``scale`` > 0 perturbs their outputs at
    ``scale`` times each kernel's tolerance (TWIN_TOL), by fixed noise:
    a witness of what a kernel error of that size does to the run."""
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    from mxnet_tpu_torch.ops import kernels

    def shake(t, rel=0.0, absolute=0.0):
        n = _pseudo_noise(torch, t)
        return (t.float() * (1 + scale * rel * n)
                + scale * absolute * n).to(t.dtype)

    def flash(q, k, v, causal, sm_scale, **_):
        o, lse = A._flash_forward_plain(q, k, v, causal, sm_scale)
        if scale:
            o, lse = (shake(o, rel=TWIN_TOL["flash_o_rel"]),
                      shake(lse, absolute=TWIN_TOL["flash_lse"]))
        return o, lse

    def conv(x, w, in_scale, in_shift, relu_in, **_):
        out = FC._reference_conv1x1(x, w, in_scale, in_shift, relu_in)
        if scale:
            y, s1, s2 = out
            out = (shake(y, rel=TWIN_TOL["b1_y_rel"]),
                   shake(s1, rel=TWIN_TOL["b1_stats_rel"]),
                   shake(s2, rel=TWIN_TOL["b1_stats_rel"]))
        return out

    for op, fn in (("flash_attention", flash), ("conv1x1_bn_stats", conv)):
        kernels.register_kernel(op, platform="cuda", priority=99,
                                name="plain_twin")(fn)
    try:
        yield
    finally:
        for op in ("flash_attention", "conv1x1_bn_stats"):
            kernels._KERNELS[op] = [e for e in kernels._KERNELS[op]
                                    if e.name != "plain_twin"]


def _amp_loop(torch, net, batches, target, opt, opt_params, loss_of,
              count, grads=None):
    """MXNet's AMP training loop on ``net`` (NDArrays): under
    ``amp.init(target)`` with ``amp.init_trainer`` and ``scale_loss``, or
    plain fp32 when ``target`` is None.  Per step: the mean loss, the loss
    scale after it, whether it skipped, and host ms (synchronised).  A
    list ``grads`` receives the gradients of the first step that updated,
    unscaled, as one fp32 vector."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.contrib import amp
    if target:
        amp.init(target)
    try:
        trainer = gluon.Trainer(net.collect_params(), opt, dict(opt_params))
        if target:
            amp.init_trainer(trainer)
        live = [p for p in net.collect_params().values()
                if p.grad_req != "null"]
        steps = []
        for x, y in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scale = 1.0
            with autograd.record():
                loss = loss_of(net, x, y)
            if target:
                scale = trainer._amp_loss_scaler.loss_scale
                with amp.scale_loss(loss, trainer) as scaled:
                    autograd.backward(scaled)
            else:
                loss.backward()
            seen = (torch.cat([p.grad()._data.float().reshape(-1)
                               for p in live]) / scale
                    if grads is not None and not grads else None)
            trainer.step(count)
            mean = float(loss.mean().asscalar())
            ms = 1e3 * (time.perf_counter() - t0)
            row = {"loss": mean, "ms": ms}
            if target:
                row["loss_scale"] = trainer._amp_loss_scaler.loss_scale
                row["skipped"] = row["loss_scale"] < scale
            if seen is not None and not row.get("skipped"):
                grads.append(seen)
            steps.append(row)
        return steps
    finally:
        if target:
            amp.deinit()


def _first_update(steps):
    """How many steps run up to and including the first that updated."""
    return next(i for i, s in enumerate(steps) if not s["skipped"]) + 1


def _vector_gap(got, ref):
    """||got - ref|| / ||ref|| over one run's gradient vector."""
    return ((got - ref).norm() / ref.norm()).item()


def _gap_by_tensor(got, ref, segments, top=4):
    """The tensors of a gradient vector that carry most of ||got - ref||:
    per tensor, its share of ||got - ref||², its share of ||ref||² and
    its own relative gap.  ``segments`` is [(name, size)] in order."""
    rows, off = [], 0
    gap2, ref2 = (got - ref).norm().item() ** 2, ref.norm().item() ** 2
    for name, size in segments:
        d = (got[off:off + size] - ref[off:off + size]).norm().item()
        r = ref[off:off + size].norm().item()
        rows.append({"tensor": name, "gap_share": d * d / gap2 if gap2 else 0,
                     "norm_share": r * r / ref2 if ref2 else 0,
                     "rel": d / r if r else math.inf})
        off += size
    return sorted(rows, key=lambda row: -row["gap_share"])[:top]


def _amp_bert(seed, dropout):
    """Full-width BERT-base on the card, weights from ``seed``, its
    dropout stream from ``seed + 1``."""
    from mxnet_tpu_torch.gluon.model_zoo.language import BERTForPretraining
    from mxnet_tpu_torch.initializer import initialize
    from mxnet_tpu_torch.random import generator
    net = BERTForPretraining(vocab_size=BERT["vocab_size"],
                             max_length=BERT["max_length"], dropout=dropout,
                             generator=generator(seed + 1, "cuda"),
                             device="cuda")
    initialize(net, generator(seed, "cuda"))
    return net


def _amp_bert_batches(torch, seed):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import NDArray
    out = []
    for i in range(AMP["steps"]):
        (tok, typ), y = _bert_batch(torch, seed + 40 + i, BERT["vocab_size"],
                                    BERT["batch"], BERT["seq"], "cuda")
        out.append(((NDArray(tok.int(), mx.gpu(0)),
                     NDArray(typ.int(), mx.gpu(0))), NDArray(y, mx.gpu(0))))
    return out


def _amp_bert_loss(net, x, y):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    mlm, _nsp = net(*x)
    return SoftmaxCrossEntropyLoss()(mlm.reshape((-1, BERT["vocab_size"])),
                                     y.reshape((-1,))).mean()


def _seq_gates(main, twin):
    return ([s["loss_scale"] for s in main] == [s["loss_scale"] for s in twin]
            and [s["skipped"] for s in main] == [s["skipped"] for s in twin])


def _flash_counts():
    from mxnet_tpu_torch.ops import attention as A
    return {"flash_fwd": A.flash_fwd_launches,
            "fp16_wgmma": A.flash_fwd_wgmma_fp16_launches,
            "bf16_wgmma": A.flash_fwd_wgmma_launches,
            "tf32": A.flash_fwd_tf32_launches}


def _zero_flash_counts():
    from mxnet_tpu_torch.ops import attention as A
    A.flash_fwd_launches = A.flash_fwd_wgmma_launches = 0
    A.flash_fwd_wgmma_fp16_launches = A.flash_fwd_tf32_launches = 0


def _amp_bert_fp16(torch, seed):
    """(a): the main run with its launches, its twin, the two perturbed
    twins (their first update only), the fp32 timing."""
    opt = {"learning_rate": BERT["lr"]}
    batches = _amp_bert_batches(torch, seed)
    net = _amp_bert(seed, 0.1)
    layers = len(net.bert.encoder.cells)
    grads = {"main": []}
    torch.cuda.synchronize()
    _zero_flash_counts()
    fp16 = _amp_loop(torch, net, batches, "float16", "adam", opt,
                     _amp_bert_loss, 1, grads["main"])
    torch.cuda.synchronize()
    launches = _flash_counts()
    _progress(f"(a) fp16 main run {[round(r['ms'], 1) for r in fp16]} ms")
    main_state = {k: v.detach().float().clone()
                  for k, v in net.state_dict().items()}
    del net
    _free(torch)
    twin_net = _amp_bert(seed, 0.1)
    grads["twin"] = []
    _zero_flash_counts()
    with _plain_twin(torch):
        twin = _amp_loop(torch, twin_net, batches, "float16", "adam", opt,
                         _amp_bert_loss, 1, grads["twin"])
    torch.cuda.synchronize()
    twin_launches = _flash_counts()
    worst = max((main_state[k] - v.detach().float()).abs().max().item()
                for k, v in twin_net.state_dict().items())
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(fp16, twin))
    del twin_net, main_state
    _free(torch)
    first = _first_update(twin)
    witness = {}
    for factor in AMP["witness_factors"]:
        wnet = _amp_bert(seed, 0.1)
        grads[factor] = []
        with _plain_twin(torch, factor):
            witness[factor] = _amp_loop(torch, wnet, batches[:first],
                                        "float16", "adam", opt,
                                        _amp_bert_loss, 1, grads[factor])
        del wnet
        _free(torch)
    gaps = {k: _vector_gap(g[0], grads["twin"][0]) if g else math.nan
            for k, g in grads.items() if k != "twin"}
    del grads
    _free(torch)
    _progress(f"(a) twins done, step-{first} gradient gaps {gaps}")
    net = _amp_bert(seed, 0.1)
    fp32 = _amp_loop(torch, net, batches[:AMP["timed"] + 1], None, "adam",
                     opt, _amp_bert_loss, 1)
    del net, batches
    _free(torch)
    _progress(f"(a) fp32 run {[round(r['ms'], 1) for r in fp32]} ms")
    limit = AMP["bert_grad_rel"]
    out = {"main": fp16, "fp32": fp32, "launches": launches, "twin": twin,
           "twin_launches": twin_launches, "twin_loss_rel": loss_rel,
           "twin_worst_param_abs": worst, "grad_step": first,
           "twin_grad_rel": gaps["main"],
           "witness_grad_rel": {str(f): gaps[f]
                                for f in AMP["witness_factors"]},
           "ms_fp16": _median([s["ms"] for s in fp16[1:]]),
           "ms_fp32": _median([s["ms"] for s in fp32[1:]])}
    gates = {
        "a_fp16_launches": launches["fp16_wgmma"] == layers * AMP["steps"]
        == launches["flash_fwd"] and launches["bf16_wgmma"] == 0
        and launches["tf32"] == 0,
        "a_twin_ran_plain": twin_launches["flash_fwd"] == 0,
        "a_losses_finite": all(math.isfinite(s["loss"]) for s in fp16),
        "a_twin_scale_and_skips": _seq_gates(fp16, twin),
        "a_twin_losses": loss_rel <= AMP["loss_rel"],
        "a_twin_grads": gaps["main"] <= limit,
        "a_grad_witnesses": _witnesses_bracket(gaps, witness, twin[:first],
                                               limit)}
    return out, gates


def _witnesses_bracket(gaps, witness, twin, limit):
    """The gradient limit lets an error at the kernel's tolerance through
    and stops one at fault_factor times it: the twin perturbed at the
    tolerance takes the twin's scale and skip steps with its gap within
    the limit, and the one at fault_factor times it leaves those steps or
    its gap exceeds the limit."""
    fault = AMP["fault_factor"]
    return (_seq_gates(witness[1.0], twin) and gaps[1.0] <= limit
            and (not _seq_gates(witness[fault], twin)
                 or gaps[fault] > limit))


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def _amp_bert_bf16_graph(torch, seed):
    """(b): CompiledTrainStep's graph under amp.init("bfloat16") against
    its eager twin, bit for bit, with the launches of each."""
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.ops import attention as A
    n = AMP["bf16_steps"]
    counts = {}

    def reset():
        A.flash_fwd_launches = A.flash_fwd_wgmma_launches = 0
        A.flash_fwd_wgmma_fp16_launches = A.flash_fwd_tf32_launches = 0

    def read():
        return {"flash_fwd": A.flash_fwd_launches,
                "bf16_wgmma": A.flash_fwd_wgmma_launches,
                "fp16_wgmma": A.flash_fwd_wgmma_fp16_launches,
                "tf32": A.flash_fwd_tf32_launches}

    amp.init("bfloat16")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _free(torch)
        net, step, xs, y = _bert_base(torch, seed, "float32")
        snaps, losses, ms = [], [], []
        reset()
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(xs, y).item())
            ms.append(1e3 * (time.perf_counter() - t0))
            snaps.append(_snapshot(step))
        counts["graph"] = read()
        captures = step._captures
        del net, step
        _free(torch)
        net, twin, xs, y = _bert_base(torch, seed, "float32")
        parity = []
        reset()
        for k in range(n):
            if k:
                _restore(torch, twin, snaps[k - 1], k)
            eager_loss = twin._eager(xs, y).item()
            parity.append({"step": k + 1, "loss_graph": losses[k],
                           "loss_eager": eager_loss,
                           **_gap(torch, _snapshot(twin), snaps[k])})
        counts["eager"] = read()
        del net, twin, xs, y
    finally:
        torch.use_deterministic_algorithms(False)
        amp.deinit()
        _free(torch)
    out = {"steps": n, "losses": losses, "ms": ms, "captures": captures,
           "parity": parity, "launches": counts}
    gates = {
        "b_bit_for_bit": all(p["bitwise_equal"] == p["tensors"]
                             and p["loss_graph"] == p["loss_eager"]
                             for p in parity),
        "b_one_capture": captures == 1,
        "b_bf16_launches": all(
            c["bf16_wgmma"] == c["flash_fwd"] == 12 * n and c["tf32"] == 0
            and c["fp16_wgmma"] == 0 for c in counts.values()),
        "b_losses_finite": all(math.isfinite(v) for v in losses)}
    return out, gates


def _amp_resnet_loss(net, x, y):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    return SoftmaxCrossEntropyLoss()(net(x), y).mean()


def _amp_resnet_batches(torch, seed):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import NDArray
    out = []
    for i in range(AMP["steps"]):
        x, y = _images(torch, seed + 60 + i, TRAIN["batch"], TRAIN["px"],
                       TRAIN["classes"])
        out.append((NDArray(x, mx.gpu(0)), NDArray(y, mx.gpu(0))))
    return out


def _amp_resnet_fp16(torch, seed):
    """(c): fused resnet50_v1 through the AMP loop: launches and their
    input dtypes (a registry probe that never claims), the convolutions'
    dtypes, the twin, the repeat, the perturbed twins and the fp32 pair
    (the timing run and its twin)."""
    import mxnet_tpu_torch.contrib.amp.amp as amp_mod
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    from mxnet_tpu_torch.ops import kernels
    sgd = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    batches = _amp_resnet_batches(torch, seed)
    net = _resnet50(torch, True, seed)
    start = {k: v.detach().float().clone()
             for k, v in net.state_dict().items() if v.is_floating_point()}
    net.hybridize()
    b1_dtypes, conv_dtypes = set(), set()

    def probe(dtype, **_):
        b1_dtypes.add(dtype)
        return False

    kernels.register_kernel("conv1x1_bn_stats", platform="cuda",
                            priority=99, predicate=probe,
                            name="dtype_probe")(lambda *a, **k: None)
    orig = amp_mod.autocast_arrays

    def record(op, raws, snap=None):
        out = orig(op, raws) if snap is None else orig(op, raws, snap)
        if op == "Convolution":
            conv_dtypes.update(str(t.dtype) for t in out[:2])
        return out
    amp_mod.autocast_arrays = record
    grads = {"main": []}
    torch.cuda.synchronize()
    FC.fused_conv_bn_launches = FC.fused_conv_bn_wgmma_launches = 0
    try:
        fp16 = _amp_loop(torch, net, batches, "float16", "sgd", sgd,
                         _amp_resnet_loss, 1, grads["main"])
        torch.cuda.synchronize()
        captures = net._cached_op._captures
    finally:
        amp_mod.autocast_arrays = orig
        kernels._KERNELS["conv1x1_bn_stats"] = [
            e for e in kernels._KERNELS["conv1x1_bn_stats"]
            if e.name != "dtype_probe"]
    launches = {"fused_conv_bn": FC.fused_conv_bn_launches,
                "wgmma": FC.fused_conv_bn_wgmma_launches}
    _progress(f"(c) fp16 main run {[round(r['ms'], 1) for r in fp16]} ms")
    deltas = {"main": {k: v.detach().float() - start[k]
                       for k, v in net.state_dict().items() if k in start}}
    segments = [(k, p.data()._data.numel())
                for k, p in net.collect_params().items()
                if p.grad_req != "null"]
    del net
    _free(torch)
    first = _first_update(fp16)
    # name: (amp target, kernels' stand-in (None: the kernels), steps,
    # variance); the twin, the main run repeated (the card's own
    # run-to-run spread), the twin perturbed at witness_factors times the
    # kernel's tolerance, fp32 without AMP with the kernels and with the
    # twin, and the kernels and the twin with the centred variance
    runs = {"main": fp16}
    plan = {"twin": ("float16", 0.0, AMP["steps"], "1"),
            "repeat": ("float16", None, AMP["steps"], "1"),
            **{f: ("float16", f, AMP["steps"] if f == 1.0 else first, "1")
               for f in AMP["witness_factors"]},
            "fp32": (None, None, AMP["timed"] + 1, "1"),
            "fp32_twin": (None, 0.0, AMP["timed"] + 1, "1"),
            "centred": ("float16", None, AMP["steps"], "0"),
            "centred_twin": ("float16", 0.0, AMP["steps"], "0")}
    twin_launches = None
    for name, (target, scale, steps, one_pass) in plan.items():
        rnet = _resnet50(torch, True, seed)
        rnet.hybridize()
        FC.fused_conv_bn_launches = 0
        grads[name] = []
        prev = os.environ.get("MXNET_TPU_FAST_VARIANCE")
        os.environ["MXNET_TPU_FAST_VARIANCE"] = one_pass
        try:
            with (_plain_twin(torch, scale) if scale is not None
                  else contextlib.nullcontext()):
                runs[name] = _amp_loop(torch, rnet, batches[:steps], target,
                                       "sgd", sgd, _amp_resnet_loss, 1,
                                       grads[name])
        finally:
            if prev is None:
                os.environ.pop("MXNET_TPU_FAST_VARIANCE")
            else:
                os.environ["MXNET_TPU_FAST_VARIANCE"] = prev
        torch.cuda.synchronize()
        if name == "twin":
            twin_launches = FC.fused_conv_bn_launches
        deltas[name] = {k: v.detach().float() - start[k]
                        for k, v in rnet.state_dict().items() if k in start}
        del rnet
        _free(torch)
        _progress(f"(c) {name} run "
                  f"{[round(r['ms'], 1) for r in runs[name]]} ms")
    twin, fp32 = runs["twin"], runs["fp32"]

    def update_gap(name, ref="twin"):
        worst, gap2, ref2 = (0.0, ""), 0.0, 0.0
        for k, want in deltas[ref].items():
            got, r = deltas[name][k].norm().item(), want.norm().item()
            gap = (deltas[name][k] - want).norm().item()
            gap2, ref2 = gap2 + gap * gap, ref2 + r * r
            worst = max(worst, (gap / r if r else (0.0 if got == 0
                                                    else math.inf), k))
        return (math.sqrt(gap2 / ref2) if ref2 else math.sqrt(gap2)), worst

    update_rel, worst = update_gap("main")
    spread_rel, _ = update_gap("repeat", "main")
    perturbed_rel, _ = update_gap(1.0)
    fp32_rel, _ = update_gap("fp32", "fp32_twin")
    centred_rel, _ = update_gap("centred", "centred_twin")
    gaps = {k: _vector_gap(grads[k][0], grads[ref][0])
            if grads[k] and grads[ref] else math.nan
            for k, ref in (("main", "twin"), ("repeat", "main"),
                           ("fp32", "fp32_twin"), ("centred", "centred_twin"),
                           *((f, "twin") for f in AMP["witness_factors"]))}
    by_tensor = {f"{k}_vs_{ref}": _gap_by_tensor(grads[k][0], grads[ref][0],
                                                 segments)
                 for k, ref in (("main", "twin"), ("fp32", "fp32_twin"),
                                (1.0, "twin"))
                 if grads[k] and grads[ref]}
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(fp16, twin))
    del deltas, start, grads
    _free(torch)
    _progress(f"(c) twins done, step-{first} gradient gaps {gaps}")
    limit = AMP["resnet_grad_rel"]
    out = {"main": fp16, "fp32": fp32, "launches": launches,
           "captures": captures, "b1_input_dtypes": sorted(b1_dtypes),
           "conv_input_dtypes": sorted(conv_dtypes), "twin": twin,
           "twin_launches": twin_launches, "twin_loss_rel": loss_rel,
           "grad_step": first,
           "grad_rel": {str(k): v for k, v in gaps.items()},
           "grad_gap_by_tensor": by_tensor,
           "twin_update_rel": update_rel, "repeat_update_rel": spread_rel,
           "perturbed_update_rel": perturbed_rel,
           "fp32_twin_update_rel": fp32_rel,
           "centred_twin_update_rel": centred_rel,
           "repeat": runs["repeat"], "perturbed": runs[1.0],
           "twin_worst_tensor_update_rel": worst,
           "ms_fp16": _median([s["ms"] for s in fp16[1:]]),
           "ms_fp32": _median([s["ms"] for s in fp32[1:]])}
    gates = {
        # every forward, a skipped step's too, and the one capture of the
        # hybridized net's record entry
        "c_b1_launches": launches["fused_conv_bn"] == launches["wgmma"]
        == FUSED_LAUNCHES_PER_STEP * (AMP["steps"] + captures)
        and captures == 1,
        "c_b1_fp32_inputs": b1_dtypes == {"float32"},
        "c_convs_fp16": conv_dtypes == {"torch.float16"},
        "c_losses_finite": all(math.isfinite(s["loss"]) for s in fp16),
        "c_twin_ran_plain": twin_launches == 0,
        "c_twin_scale_and_skips": _seq_gates(fp16, twin),
        "c_twin_losses": loss_rel <= AMP["resnet_loss_rel"],
        "c_repeat_scale_and_skips": _seq_gates(fp16, runs["repeat"]),
        "c_twin_grads": gaps["main"] <= limit,
        "c_centred_twin": _seq_gates(runs["centred"], runs["centred_twin"])
        and gaps["centred"] <= limit,
        "c_grad_witnesses": _witnesses_bracket(
            gaps, {f: runs[f][:first] for f in AMP["witness_factors"]},
            twin[:first], limit),
        # four steps drift apart no further than twice what an error at
        # the kernel's tolerance drives them apart
        "c_twin_updates": update_rel
        <= AMP["update_factor"] * perturbed_rel}
    return out, gates


def _amp_registry(torch):
    """(d): the registry and the config layer on the card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import util
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.ops import kernels
    names = kernels.list_kernels()
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h, s, d = BERT_FLASH
    claimed = []

    def user_kernel(q, k, v, causal, sm_scale, **_):
        claimed.append(str(q.dtype))
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=sm_scale), None

    calls = {}
    kernels.register_kernel(
        "flash_attention", platform="cuda", priority=99, name="user_fp16",
        predicate=lambda dtype, **_: dtype == "float16")(user_kernel)
    try:
        for dtype in (torch.float16, torch.bfloat16):
            q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda",
                                   dtype=dtype) for _ in range(3))
            before = (A.flash_fwd_wgmma_fp16_launches,
                      A.flash_fwd_wgmma_launches)
            with torch.no_grad():
                o = A.flash_attention(q, k, v)
            ref, _ = A._flash_forward_plain(q.float(), k.float(), v.float(),
                                            False, 1.0 / math.sqrt(d))
            calls[str(dtype)] = {
                "fp16_wgmma": A.flash_fwd_wgmma_fp16_launches - before[0],
                "bf16_wgmma": A.flash_fwd_wgmma_launches - before[1],
                "max_abs_err": (o.float() - ref).abs().max().item()}
    finally:
        kernels._KERNELS["flash_attention"] = [
            e for e in kernels._KERNELS["flash_attention"]
            if e.name != "user_fp16"]
    removed = "user_fp16" not in kernels.list_kernels()["flash_attention"]
    os.environ["MXNET_KERNEL_BACKEND"] = "torch"
    try:
        q = torch.zeros(1, 1, 8, 8, device="cuda")
        A.flash_attention(q, q, q)
        refused = False
    except MXNetError:
        refused = True
    finally:
        os.environ.pop("MXNET_KERNEL_BACKEND")
    free, total = mx.gpu_memory_info(0)
    pinned = mx.nd.ones((4, 4), ctx=mx.cpu_pinned())
    cc = util.get_cuda_compute_capability(mx.gpu(0))
    major, minor = torch.cuda.get_device_capability(0)
    out = {"kernels": names, "user_kernel_claimed": claimed, "calls": calls,
           "plain_on_card_refused": refused, "gpu_memory_info": [free, total],
           "pinned": pinned._data.is_pinned(), "compute_capability": cc,
           "gpu_count": util.get_gpu_count()}
    gates = {
        "d_list_kernels": "cuda_flash_fwd" in names.get("flash_attention", [])
        and "cuda_mm_bn_stats" in names.get("conv1x1_bn_stats", []),
        "d_user_kernel_claims_fp16_only": claimed == ["torch.float16"]
        and calls["torch.float16"]["fp16_wgmma"] == 0
        and calls["torch.bfloat16"]["bf16_wgmma"] == 1 and removed
        and all(c["max_abs_err"] <= 2e-2 for c in calls.values()),
        "d_torch_backend_refused_on_card": refused,
        "d_card_values": 0 < free <= total
        == torch.cuda.mem_get_info(0)[1]
        and out["pinned"] and cc == 10 * major + minor
        and out["gpu_count"] == torch.cuda.device_count()}
    return out, gates


def phase_amp(torch, seed):
    """Slice 23 (see AMP): returns the fp16 route's launches in (a), the
    bf16 wgmma route's in (b)'s graph run and B1's in (c)."""
    t0 = time.perf_counter()
    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    secs = {}
    bert, gates = _amp_bert_fp16(torch, seed)
    secs["a"] = time.perf_counter() - t0
    _progress(f"(a) {secs['a']:.1f} s")
    bf16, g = _amp_bert_bf16_graph(torch, seed)
    gates.update(g)
    secs["b"] = time.perf_counter() - t0 - sum(secs.values())
    _progress(f"(b) {secs['b']:.1f} s")
    resnet, g = _amp_resnet_fp16(torch, seed)
    gates.update(g)
    secs["c"] = time.perf_counter() - t0 - sum(secs.values())
    registry, g = _amp_registry(torch)
    gates.update(g)
    secs["d"] = time.perf_counter() - t0 - sum(secs.values())
    out = {"phase": "amp", "card": card, "config": AMP, "tf32": _tf32(torch),
           "a_bert_fp16": bert, "b_bert_bf16_graph": bf16,
           "c_resnet_fp16": resnet, "d_registry": registry,
           "gates": gates, "part_seconds": secs,
           "seconds": time.perf_counter() - t0}
    out["ok"] = all(gates.values())
    emit(out)
    print(f"amp timing [{card}]: " + json.dumps({
        "bert_base_ms_per_step": {"fp16_amp": bert["ms_fp16"],
                                  "fp32": bert["ms_fp32"]},
        "bert_base_bf16_graph_ms": bf16["ms"],
        "resnet50_v1_fused_ms_per_step": {"fp16_amp": resnet["ms_fp16"],
                                          "fp32": resnet["ms_fp32"]},
        "loss_scales": {"bert": [s["loss_scale"] for s in bert["main"]],
                        "resnet": [s["loss_scale"]
                                   for s in resnet["main"]]}}), flush=True)
    check(out["ok"], f"amp gates failed: "
          f"{[k for k, v in gates.items() if not v]}")
    return (bert["launches"]["fp16_wgmma"],
            bf16["launches"]["graph"]["bf16_wgmma"],
            resnet["launches"]["fused_conv_bn"])


# ---------------------------------------------------------------------------
# slice 24: the device mesh, sequence- and expert-parallel training
# ---------------------------------------------------------------------------
# Every Llama here is LlamaModel at llama_7b's widths (LLAMA_7B: vocab
# 32000, units 4096, hidden 11008, 32 heads) cut to MESH["layers"] of its
# 32 layers, fp32, TF32 off, random weights from the seed.  Mesh positions
# are torch.device("cuda") repeated: one card holds every position, so the
# phase shows semantics, shapes and memory and measures no interconnect.
#  (a) sp = 4, S = 8192, batch 1: ring and Ulysses logits against flash on
#      the same weights, max |diff| within seq_rel of max |flash logit|
#      (the flash kernel's three TF32 products against fp32 einsums, summed
#      in other orders over 2 layers); at S = 2048 each parameter's
#      gradient of one loss within grad_rel of the flash model's largest
#      |gradient| of that tensor; 3 Adam steps of CompiledTrainStep(mesh=)
#      per mode on one batch, the loss falling; per forward 2(n - 1)
#      ppermutes a layer (ring: the port drops the JAX body's last
#      rotation) and 4 all_to_alls a layer (Ulysses).
#  (b) dp = 2 x ep = 4, 4 experts top-2 (Mixtral-style MoE FFN; about
#      0.99 B parameters), batch 2, S = 2048: 3 Adam steps against the same
#      model and data with no mesh, each step's loss within loss_rel (the
#      JAX package's own test holds 2e-4, tests/test_llama.py:248); 2
#      all_to_alls a layer per forward and one pmean a step.
#  (c) fused resnet50_v1, batch 64, 224 px, dp = 2, 3 SGD steps (momentum
#      0.9, wd 1e-4, lr resnet_lr) against the unmeshed step; 36 B1
#      launches per forward per position, and 2 psums (the statistics) per
#      fused layer.  The first loss (before any update) within resnet_rel.
#      The later ones cannot be held to that: this random-init net's
#      gradients move by 2.6e-2 under its kernel's 1e-6-level rounding
#      (PR 23), and the mesh changes the statistics' summation order (at
#      the training phase's lr 0.1 the two runs' step-2 losses parted by
#      1.0%, at lr 1e-3 by 8.3e-4).  So a witness run, unmeshed, takes
#      every B1 launch's statistics times (1 + 2^-23 fixed noise), a
#      rounding-sized change, and the largest gap of the meshed losses
#      must lie within resnet_rel, or within witness_factor times the
#      witness's largest gap, of the unmeshed ones.
#  (d) fused resnet50_v1 converted by amp.convert_hybrid_block(net,
#      "float16"): each of its 36 fused blocks on fp16 input of its own
#      shape at batch 64, recorded forward and backward (one fp16 B1 launch
#      each, finite gradients); the whole network's forward then stops at
#      the first convolution after a fused block with the JAX package's
#      dtype mismatch (a fused block returns fp32; ROADMAP C, reference
#      caveats).
# B0 at (a)'s shape, [1, 32, 8192, 128] causal fp32, is checked against
# its plain version and timed beside it and SDPA (fp32).
MESH = dict(layers=2, sp=4, seq=8192, grad_seq=2048, steps=3, lr=1e-4,
            moe_batch=2, moe_seq=2048, experts=4, top_k=2, aux_weight=0.01,
            resnet_batch=64, resnet_lr=1e-3, seq_rel=1e-4, grad_rel=1e-4,
            loss_rel=2e-4, resnet_rel=1e-4, witness_factor=4.0,
            budget_s=120.0)
MESH_FLASH = (1, 32, 8192, 128)


def _mesh_devices(torch, n):
    return [torch.device("cuda")] * n


def _mesh_llama(torch, seed, **kw):
    from mxnet_tpu_torch.gluon.model_zoo.language import LlamaModel
    from mxnet_tpu_torch.initializer import initialize
    from mxnet_tpu_torch.random import generator
    model = LlamaModel(num_layers=MESH["layers"], **{**LLAMA_7B, **kw})
    return initialize(model, generator(seed))


def _mesh_lm_loss(moe):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    ce = SoftmaxCrossEntropyLoss()
    vocab = LLAMA_7B["vocab_size"]

    def loss(out, y):
        if moe:
            logits, aux = out
            return ce(logits.reshape(-1, vocab), y.reshape(-1)) \
                + MESH["aux_weight"] * aux
        return ce(out.reshape(-1, vocab), y.reshape(-1))
    return loss


def _mesh_tokens(torch, seed, batch, seq):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, LLAMA_7B["vocab_size"], (batch, seq),
                           generator=gen, device="cuda")
    return tokens, torch.roll(tokens, -1, dims=1).float()


def _peak_gb(torch):
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def _mesh_free(torch):
    """_free, and the peak counter restarted for the next run."""
    _free(torch)
    torch.cuda.reset_peak_memory_stats()


def _mesh_flash_timing(torch, seed):
    """B0's fp32 route at [1, 32, 8192, 128] causal: checked once against
    its plain version, then timed in turns with it and SDPA fp32.  The
    bound is the function's operations (2·S²·D per head, causal) at the
    TF32 tensor-core peak, or its bytes; beside it the kernel's own three
    TF32 products and the same operations on the fp32 CUDA cores."""
    from mxnet_tpu_torch.ops import attention as A
    b, h, s, d = MESH_FLASH
    gen = torch.Generator(device="cuda").manual_seed(seed + 24)
    q, k, v = (torch.randn(b * h, s, d, generator=gen, device="cuda")
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    before = A.flash_fwd_tf32_launches
    o, lse = A.flash_fwd(q, k, v, True, scale)
    ran_tf32 = A.flash_fwd_tf32_launches - before == 1
    ro, rl = A._flash_forward_plain(q, k, v, True, scale)
    o_err = (o - ro).abs().max().item()
    lse_err = (lse - rl).abs().max().item()
    del o, lse, ro, rl
    torch.cuda.empty_cache()
    q4, k4, v4 = (t.view(b, h, s, d) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    best, runs = _in_turns(torch, {
        "kernel": lambda: A.flash_fwd(q, k, v, True, scale),
        "plain": lambda: A._flash_forward_plain(q, k, v, True, scale),
        "library": lambda: sdpa(q4, k4, v4, is_causal=True, scale=scale)},
        iters=5)
    bound, bound_by = flash_bound_ms(b, h, s, d, True, 4,
                                     peak=PEAK_TF32_FLOPS)
    tol = TOL["float32"]
    out = {"shape": [b, h, s, d], "dtype": "float32", "causal": True,
           "variant": A._flash_variant(torch.float32, d), "ran_tf32": ran_tf32,
           "o_err": o_err, "lse_err": lse_err, "tolerance": tol,
           "max_abs_err": max(o_err, lse_err), "ms": best["kernel"],
           "plain_ms": best["plain"], "library_ms": best["library"],
           "bound_ms": bound, "bound_by": bound_by,
           "tf32x3_ops_ms": flash_bound_ms(b, h, s, d, True, 4, ops_factor=3,
                                           peak=PEAK_TF32_FLOPS)[0],
           "cuda_core_ops_ms": flash_bound_ms(b, h, s, d, True, 4)[0],
           "runs_ms": runs}
    out["ok"] = (ran_tf32 and o_err <= tol["o"] and lse_err <= tol["lse"])
    del q, k, v, q4, k4, v4
    _mesh_free(torch)
    return out


def _grad_gaps(ref, got, names):
    return {n: ((g - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
            for n, r, g in zip(names, ref, got)}


def _mesh_seq(torch, seed):
    """(a): ring and Ulysses against flash, then 3 meshed steps each."""
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.executor import CompiledTrainStep
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.parallel import DeviceMesh, collectives as C
    n, s, layers = MESH["sp"], MESH["seq"], MESH["layers"]
    mesh = DeviceMesh({"sp": n}, devices=_mesh_devices(torch, n))
    tokens, labels = _mesh_tokens(torch, seed + 1, 1, s)
    models = {"flash": _mesh_llama(torch, seed, max_length=s)}
    for mode in ("ring", "ulysses"):
        models[mode] = _mesh_llama(torch, seed + 99, max_length=s,
                                   attention=mode, mesh=mesh)
        models[mode].load_state_dict(models["flash"].state_dict())
    want = {"ring": ("ppermute", layers * 2 * (n - 1)),
            "ulysses": ("all_to_all", layers * 4)}
    out = {"forward": {}, "grads": {}, "train": {}}
    launches = {"flash": 0, "flash_tf32": 0}
    with torch.no_grad():
        f0, t0 = A.flash_fwd_launches, A.flash_fwd_tf32_launches
        ref = models["flash"](tokens)
        launches = {"flash": A.flash_fwd_launches - f0,
                    "flash_tf32": A.flash_fwd_tf32_launches - t0}
        scale = ref.abs().max().item()
        for mode in ("ring", "ulysses"):
            C.reset_collective_counts()
            got = models[mode](tokens)
            counts = C.collective_counts()
            name, per = want[mode]
            out["forward"][mode] = {
                "max_abs_diff": (got - ref).abs().max().item(),
                "rel": (got - ref).abs().max().item() / scale,
                "collectives": counts, "want": {name: per},
                "ok": (got - ref).abs().max().item()
                <= MESH["seq_rel"] * scale and counts[name] == per}
            del got
    del ref
    # gradients of one loss at S = grad_seq
    gs = MESH["grad_seq"]
    loss_fn = _mesh_lm_loss(False)
    grads = {}
    for mode, model in models.items():
        params = [p for p in model.parameters() if p.requires_grad]
        loss = loss_fn(model(tokens[:, :gs]), labels[:, :gs]).mean()
        grads[mode] = torch.autograd.grad(loss, params)
        del loss
    names = [k for k, p in models["flash"].named_parameters()
             if p.requires_grad]
    for mode in ("ring", "ulysses"):
        gaps = _grad_gaps(grads["flash"], grads[mode], names)
        worst = max(gaps, key=gaps.get)
        out["grads"][mode] = {"worst": worst, "rel": gaps[worst],
                              "ok": gaps[worst] <= MESH["grad_rel"]}
    del grads, models["flash"]
    _mesh_free(torch)
    # 3 meshed steps per mode, one model at a time
    for mode in ("ring", "ulysses"):
        model = models.pop(mode)
        step = CompiledTrainStep(model, loss_fn, optimizer.create(
            "adam", learning_rate=MESH["lr"]), batch_size=1, mesh=mesh)
        C.reset_collective_counts()
        t0 = time.perf_counter()
        losses = [float(step(tokens, labels)) for _ in range(MESH["steps"])]
        out["train"][mode] = {
            "losses": losses, "seconds": time.perf_counter() - t0,
            "collectives": C.collective_counts(),
            "peak_mem_gb": _peak_gb(torch),
            "ok": losses[-1] < losses[0] and all(map(math.isfinite, losses))}
        del step, model
        _mesh_free(torch)
    out["launches"] = launches
    out["ok"] = (all(v["ok"] for part in ("forward", "grads", "train")
                     for v in out[part].values())
                 and launches["flash_tf32"] == layers)
    return out


def _mesh_experts(torch, seed):
    """(b): the MoE model over dp x ep against no mesh."""
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.executor import CompiledTrainStep
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.parallel import DeviceMesh, collectives as C
    axes = {"dp": 2, "ep": 4}
    mesh = DeviceMesh(axes, devices=_mesh_devices(torch, 8))
    tokens, labels = _mesh_tokens(torch, seed + 2, MESH["moe_batch"],
                                  MESH["moe_seq"])
    runs = {}
    for name, m in (("mesh", mesh), ("single", None)):
        model = _mesh_llama(torch, seed + 3, moe_experts=MESH["experts"],
                            moe_top_k=MESH["top_k"])
        params = sum(p.numel() for p in model.parameters())
        step = CompiledTrainStep(model, _mesh_lm_loss(True), optimizer.create(
            "adam", learning_rate=MESH["lr"]),
            batch_size=MESH["moe_batch"], mesh=m)
        C.reset_collective_counts()
        f0 = A.flash_fwd_tf32_launches
        t0 = time.perf_counter()
        losses = [float(step(tokens, labels)) for _ in range(MESH["steps"])]
        runs[name] = {"losses": losses, "seconds": time.perf_counter() - t0,
                      "collectives": C.collective_counts(),
                      "flash_tf32_launches": A.flash_fwd_tf32_launches - f0,
                      "parameters": params, "peak_mem_gb": _peak_gb(torch)}
        if m is not None:
            runs[name]["expert_spec"] = list(
                step.param_specs["layers.0.ffn.expert_w1"])
        del step, model
        _mesh_free(torch)
    rel = [abs(a - b) / abs(b) for a, b in zip(runs["mesh"]["losses"],
                                               runs["single"]["losses"])]
    steps, layers = MESH["steps"], MESH["layers"]
    got = runs["mesh"]["collectives"]
    want = {"all_to_all": 2 * layers * steps, "pmean": steps}
    ok = (max(rel) <= MESH["loss_rel"]
          and all(got[k] == v for k, v in want.items())
          and runs["single"]["collectives"]["all_to_all"] == 0
          and all(r["flash_tf32_launches"] == layers * steps
                  for r in runs.values())
          and runs["single"]["losses"][-1] < runs["single"]["losses"][0])
    return {"runs": runs, "loss_rel": rel, "want": want, "ok": ok,
            "launches": runs["mesh"]["flash_tf32_launches"]}


@contextlib.contextmanager
def _stats_witness(torch):
    """B1's CUDA route registered again at priority 99 with its statistics
    times (1 + 2^-23 fixed noise) on the way out; removed after."""
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    from mxnet_tpu_torch.ops import kernels

    def nudged(x, w, in_scale, in_shift, relu_in, **_):
        y, s1, s2 = FC._fused_cuda(x, w, in_scale, in_shift, relu_in)
        return (y, s1 * (1 + 2.0 ** -23 * _pseudo_noise(torch, s1)),
                s2 * (1 + 2.0 ** -23 * _pseudo_noise(torch, s2)))

    kernels.register_kernel("conv1x1_bn_stats", platform="cuda",
                            priority=99, name="stats_witness")(nudged)
    try:
        yield
    finally:
        kernels._KERNELS["conv1x1_bn_stats"] = [
            e for e in kernels._KERNELS["conv1x1_bn_stats"]
            if e.name != "stats_witness"]


def _mesh_resnet(torch, seed):
    """(c): fused resnet50_v1 under dp = 2 against no mesh."""
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.executor import CompiledTrainStep
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    from mxnet_tpu_torch.parallel import DeviceMesh, collectives as C
    batch, steps = MESH["resnet_batch"], MESH["steps"]
    x, y = _images(torch, seed + 4, batch, TRAIN["px"], TRAIN["classes"])
    mesh = DeviceMesh({"dp": 2}, devices=_mesh_devices(torch, 2))
    runs = {}
    for name, m in (("mesh", mesh), ("single", None), ("witness", None)):
        net = _resnet50(torch, True, seed + 5)
        step = CompiledTrainStep(
            net, SoftmaxCrossEntropyLoss(), optimizer.create(
                "sgd", learning_rate=MESH["resnet_lr"], momentum=0.9,
                wd=1e-4),
            batch_size=batch, mesh=m)
        C.reset_collective_counts()
        FC.fused_conv_bn_launches = FC.fused_conv_bn_wgmma_launches = 0
        with (_stats_witness(torch) if name == "witness"
              else contextlib.nullcontext()):
            losses = [float(step(x, y)) for _ in range(steps)]
        torch.cuda.synchronize()
        runs[name] = {"losses": losses,
                      "launches": FC.fused_conv_bn_launches,
                      "wgmma_launches": FC.fused_conv_bn_wgmma_launches,
                      "collectives": C.collective_counts(),
                      "peak_mem_gb": _peak_gb(torch)}
        del step, net
        _mesh_free(torch)
    single = runs["single"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(runs["mesh"]["losses"],
                                               single)]
    witness = [abs(a - b) / abs(b) for a, b in zip(runs["witness"]["losses"],
                                                   single)]
    per_fwd = FUSED_LAUNCHES_PER_STEP
    ok = (rel[0] <= MESH["resnet_rel"]
          and max(rel) <= max(MESH["resnet_rel"],
                              MESH["witness_factor"] * max(witness))
          and runs["mesh"]["launches"] == per_fwd * 2 * steps
          and runs["single"]["launches"] == per_fwd * steps
          and runs["mesh"]["collectives"]["psum"] == 2 * per_fwd * steps)
    return {"runs": runs, "loss_rel": rel, "witness_rel": witness, "ok": ok,
            "launches_per_forward_per_position":
            runs["mesh"]["launches"] / (2 * steps),
            "launches": runs["mesh"]["launches"]}


def _mesh_fp16_blocks(torch, seed):
    """(d): every fused block of the fp16-converted resnet50_v1 on fp16
    input of its shape, then the whole network's forward."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.contrib.nn import FusedConv1x1BN
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    batch = MESH["resnet_batch"]
    net = _resnet50(torch, True, seed + 6)
    blocks = [mod for mod in net.modules() if isinstance(mod, FusedConv1x1BN)]
    shapes = {}
    hooks = [blk.register_forward_pre_hook(
        lambda mod, args: shapes.setdefault(id(mod), tuple(args[0].shape)))
        for blk in blocks]
    x, y = _images(torch, seed + 7, batch, TRAIN["px"], TRAIN["classes"])
    with torch.no_grad():
        net.eval()(x)
    for hk in hooks:
        hk.remove()
    amp.convert_hybrid_block(net, "float16")
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    FC.fused_conv_bn_launches = FC.fused_conv_bn_fp16_launches = 0
    rows, finite = [], True
    for blk in blocks:
        xin = torch.rand(shapes[id(blk)], generator=gen,
                         device="cuda").half().requires_grad_()
        out = blk.train()(xin)
        out.float().square().mean().backward()
        finite = finite and bool(torch.isfinite(xin.grad).all()) and bool(
            torch.isfinite(blk.weight.grad).all())
        rows.append({"input": list(shapes[id(blk)]),
                     "out_dtype": str(out.dtype).replace("torch.", "")})
        blk.weight.grad = None
        del xin, out
    torch.cuda.synchronize()
    launches = {"fp16": FC.fused_conv_bn_fp16_launches,
                "all": FC.fused_conv_bn_launches}
    FC.fused_conv_bn_fp16_launches = 0
    err = None
    try:
        net.train()(x.half())
    except MXNetError as e:   # the kernel refused fp16 (fault C14)
        err = ("MXNetError", str(e))
    except RuntimeError as e:
        err = ("RuntimeError", str(e))
    torch.cuda.synchronize()
    whole = {"error": err, "fp16_launches_before_it":
             FC.fused_conv_bn_fp16_launches,
             "peak_mem_gb": _peak_gb(torch)}
    del net, blocks, x, y
    _mesh_free(torch)
    ok = (launches["fp16"] == len(rows) == FUSED_LAUNCHES_PER_STEP
          and finite and err is not None and err[0] == "RuntimeError"
          and "float" in err[1].lower()
          and whole["fp16_launches_before_it"] >= 1)
    return {"blocks": len(rows), "launches": launches,
            "grads_finite": finite, "whole_network": whole,
            "first_blocks": rows[:2], "ok": ok}


def phase_mesh(torch, seed):
    """Slice 24 (see MESH): returns B0's fp32 launches on (a) and (b), B1's
    on (c) and its fp16 launches on (d), and B0's timing at (a)'s shape."""
    from mxnet_tpu_torch.parallel import collectives as C
    t0 = time.perf_counter()
    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _mesh_free(torch)
    secs, parts = {}, {}
    for key, fn in (("flash_timing", _mesh_flash_timing),
                    ("a_sequence", _mesh_seq), ("b_experts", _mesh_experts),
                    ("c_resnet_dp", _mesh_resnet),
                    ("d_resnet_fp16", _mesh_fp16_blocks)):
        t1 = time.perf_counter()
        parts[key] = fn(torch, seed)
        secs[key] = time.perf_counter() - t1
        print(f"mesh: {key} {secs[key]:.1f} s ok={parts[key]['ok']}",
              flush=True)
    seconds = time.perf_counter() - t0
    out = {"phase": "mesh", "card": card, "config": MESH,
           "tf32": _tf32(torch), **parts, "part_seconds": secs,
           "seconds": seconds, "budget_s": MESH["budget_s"],
           "collective_names": sorted(C.collective_counts())}
    out["ok"] = all(p["ok"] for p in parts.values())
    emit(out)
    print(f"mesh [{card}]: " + json.dumps({
        "peak_mem_gb": {
            "a_ring_train": parts["a_sequence"]["train"]["ring"][
                "peak_mem_gb"],
            "a_ulysses_train": parts["a_sequence"]["train"]["ulysses"][
                "peak_mem_gb"],
            "b_moe_mesh": parts["b_experts"]["runs"]["mesh"]["peak_mem_gb"],
            "b_moe_single": parts["b_experts"]["runs"]["single"][
                "peak_mem_gb"],
            "c_resnet_mesh": parts["c_resnet_dp"]["runs"]["mesh"][
                "peak_mem_gb"],
            "d_fp16": parts["d_resnet_fp16"]["whole_network"]["peak_mem_gb"]},
        "collectives": {
            "a_forward": {m: v["collectives"] for m, v in
                          parts["a_sequence"]["forward"].items()},
            "b_mesh_3_steps": parts["b_experts"]["runs"]["mesh"][
                "collectives"],
            "c_mesh_3_steps": parts["c_resnet_dp"]["runs"]["mesh"][
                "collectives"]},
        "seconds": seconds}), flush=True)
    check(out["ok"], "mesh gates failed: " + str(
        [k for k, p in parts.items() if not p["ok"]]))
    return ({"mesh_sequence": parts["a_sequence"]["launches"]["flash_tf32"],
             "mesh_experts": parts["b_experts"]["launches"]},
            parts["c_resnet_dp"]["launches"],
            parts["d_resnet_fp16"]["launches"]["fp16"],
            parts["flash_timing"])


# ---------------------------------------------------------------------------
# slice 15: training that survives faults
# ---------------------------------------------------------------------------
# Full-width BERT-base as bert_training builds it (fp32, TF32 off, seq 128,
# batch 64, Adam lr 1e-4, dropout 0.1 from the net's own generator, seed
# 0), one net reused: before each run its initial weights and the random
# streams the step's graphs register are written back, and each run takes
# a fresh CompiledTrainStep (fresh Adam slots).  RESIL["steps"] batches of
# their own, the same in every run.  Gates, each held bit for bit when the
# two health-off baselines agree bit for bit, else to their spread:
#   baseline     two health-off runs; equal losses and state?
#   probe        the random streams under graphs: copy, 2 replays, restore,
#                2 replays, equal losses (FaultTolerantStep's copy/restore)
#   watchpoints  health every=1 (log) ends where the off run ends; its
#                first grad_norm within RESIL["norm_rel"] of the norm of an
#                eager autograd pass's gradients from the same state; on
#                a graph replay (the third call), grad_norm, param_norm and
#                update_ratio within RESIL["norm_rel"] of an eager pass
#                from the pre-step copy and of the parameters the replay
#                left; non-finite counts 0; 12 tf32 flash launches per forward
#                and no other variant; step ms off / every=16 / every=1 and
#                the pool bytes off against on, over 3 + 16 steps
#   replay       FaultTolerantStep with transient execute faults at call 5
#                (the inner ladder exhausted): one replay, the off run's
#                state, no new capture
#   checkpoints  AsyncCheckpointer(every=4): durable steps 0, 4, 8, 12; a
#                BERT-base from another seed, warmed one step, restored from
#                step 8 by load_elastic_checkpoint and fed steps 9-12 ends
#                at the off run's state; a truncated copy of a file raises
#                CheckpointCorruptError naming it; a manifest-less step-
#                directory is never chosen
#   numerics     after 2 clean steps, a NumericsFaultPlan on encoder layer
#                6's ffn2 makes a new graph: bwd:nan raises NumericsError
#                with first_bwd that block, fwd:inf with first_fwd that
#                block, bwd:nan under skip restores the world and the
#                optimizer's counts and the next clean step proceeds
#   goodput      every step record's buckets sum to its wall within 1e-6 s
RESIL = dict(steps=12, every=4, fault_call=5, layer=6, timed=16, warmup=3,
             norm_rel=1e-5, goodput_abs=1e-6)


def _resil_tensors(step):
    """The step's world as device copies: the net's state dict, then every
    optimizer state."""
    return {k: v.detach().clone() for k, v in _step_tensors(step).items()}


def _resil_gap(got, ref):
    """``(bit for bit, worst max|got - ref| / max|ref|, its name)``."""
    worst, name = 0.0, ""
    for k, r in ref.items():
        g = got[k]
        if g.shape != r.shape or not bool((g == r).all()):
            m = r.float().abs().max().item()
            d = (g.float() - r.float()).abs().max().item()
            rel = d / m if m else math.inf
            if not math.isfinite(d) or rel > worst:
                worst, name = (rel if math.isfinite(d) else math.inf), k
    return worst == 0.0 and name == "", worst, name


def phase_resilient_training(torch, seed):
    """Training that survives faults on full-width BERT-base (see RESIL);
    returns the fp32 tensor-core flash kernel's launches over the
    health-on run (the main path)."""
    import shutil
    import tempfile

    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.cached_op import generators_of
    from mxnet_tpu_torch.checkpoint import (MANIFEST_NAME,
                                            CheckpointCorruptError)
    from mxnet_tpu_torch.executor import CompiledTrainStep
    from mxnet_tpu_torch.observability import goodput, health, metrics
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.ops import embedding as EMB
    from mxnet_tpu_torch import resilience
    from mxnet_tpu_torch.resilience import (FaultPlan, FaultTolerantStep,
                                            RetryPolicy)
    from mxnet_tpu_torch.resilience.elastic import (AsyncCheckpointer,
                                                    latest_checkpoint,
                                                    load_elastic_checkpoint)
    t_phase = time.perf_counter()
    _free(torch)
    vocab, n = BERT["vocab_size"], RESIL["steps"]
    net, step, _, _ = _bert_base(torch, seed, "float32")
    del step
    layers = len(net.bert.encoder.cells)
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    gens = generators_of(net, "cuda")
    gen0 = [g.get_state() for g in gens]
    total = n + RESIL["timed"] + RESIL["warmup"]
    data = [_bert_batch(torch, seed + 100 + i, vocab, BERT["batch"],
                        BERT["seq"], "cuda") for i in range(total)]

    def reset():
        with torch.no_grad():
            for k, v in net.state_dict().items():
                v.copy_(init[k])
        for g, s in zip(gens, gen0):
            g.set_state(s)

    def new_step(health_cfg=None):
        return CompiledTrainStep(
            net, _bert_loss(vocab),
            optimizer.create("adam", learning_rate=BERT["lr"]),
            batch_size=BERT["batch"], health=health_cfg)

    def run(health_cfg=None, wrap=None, before=None, after_each=None):
        """``n`` steps from the initial state: (losses, final world,
        step)."""
        reset()
        step = new_step(health_cfg)
        call = wrap(step) if wrap else step
        if before:
            before(step)
        losses = []
        for i in range(n):
            losses.append(call(*data[i]))
            if after_each:
                after_each(step)
        losses = [v.item() for v in losses]
        return losses, _resil_tensors(step), step

    out = {"phase": "resilient_training", "model": "bert_base_pretraining",
           "layers": layers, "batch": BERT["batch"], "seq": BERT["seq"],
           "steps": n, "dtype": "float32", "tf32": _tf32(torch),
           "card": _card()}
    gates = {}

    def pair():
        """Two health-off runs: (losses, world, bit for bit, spread, worst
        tensor, largest loss gap)."""
        losses, world, s = run()
        del s
        _free(torch)
        losses2, world2, s = run()
        del s
        _free(torch)
        same, spread, worst = _resil_gap(world2, world)
        gap = max(abs(a - b) for a, b in zip(losses2, losses))
        return losses, world, same and losses2 == losses, spread, worst, gap

    def unstable_grads():
        """The parameters whose gradient differs between two eager passes
        from the same state and random streams, in the net's order."""
        out_ = []
        for _ in range(2):
            reset()
            net.train()
            loss = _bert_loss(vocab)(net(*data[0][0]), data[0][1]).mean()
            names = [k for k, p in net.named_parameters() if p.requires_grad]
            grads = torch.autograd.grad(
                loss, [p for p in net.parameters() if p.requires_grad],
                allow_unused=True)
            out_.append(grads)
            del loss
        bad = [(k, type(net.get_submodule(k.rsplit(".", 1)[0])).__name__)
               for k, a, b in zip(names, *out_)
               if a is not None and not torch.equal(a, b)]
        del out_
        return bad

    # 1. baseline, the default algorithms (Embedding's backward is the
    # deterministic csrc/embedding_bwd.cu): two health-off runs, and the
    # parameters whose gradients two eager passes disagree on.  Every later
    # gate holds its run to this pair: bit for bit while the pair agrees bit
    # for bit, else within its spread.
    base_losses, base, bitwise, spread, worst, gap = pair()
    bad = unstable_grads()
    out["baseline"] = {
        "deterministic_algorithms": False, "bitwise": bitwise,
        "spread": spread, "worst_tensor": worst, "losses": base_losses,
        "loss_gap": gap, "unstable_grads": len(bad),
        "nearest_loss": bad[-1] if bad else None,
        "farthest_from_loss": bad[0] if bad else None}
    gates["baseline_bitwise"] = bitwise and not bad
    tol = 0.0 if bitwise else spread
    out["tolerance"] = {"state_rel": tol, "norm_rel": RESIL["norm_rel"],
                        "goodput_abs_s": RESIL["goodput_abs"]}

    def held(world, losses=None):
        """The baseline gate: bit for bit (losses too, when given) while
        the baselines agree bit for bit, else within their spread."""
        ok, rel, name = _resil_gap(world, base)
        if bitwise:
            ok = ok and (losses is None or losses == base_losses)
        else:
            ok = rel <= tol
        return ok, rel, name

    # step ms with the default algorithms: off, armed without a fetch,
    # every=16, every=1, over warmup + timed steps; then the two costs of
    # a fetch alone (the healthy host copy, the stats' copy) and the
    # watchpoints' reductions alone, eagerly on the step's tensors
    fetch = metrics.registry().get("mxnet_tpu_health_fetch_seconds")
    timing = {}
    for label, cfg in (("off", None), ("armed_no_fetch", {"every": 10 ** 9}),
                       ("every16", {"every": 16}), ("every1", {"every": 1})):
        reset()
        s = new_step(cfg)
        for i in range(RESIL["warmup"]):
            s(*data[n + i])
        torch.cuda.synchronize()
        c0, f0 = fetch.count, fetch.sum
        t0 = time.perf_counter()
        for i in range(RESIL["timed"]):
            loss = s(*data[n + RESIL["warmup"] + i])
        loss.item()
        wall = time.perf_counter() - t0
        fetches = fetch.count - c0
        timing[label] = {
            "step_ms": 1e3 * wall / RESIL["timed"],
            "fetches": fetches,
            "fetch_ms": 1e3 * (fetch.sum - f0) / fetches if fetches else None,
            "pool_gb": _pool_bytes(torch, s._pool) / 1e9}
        if label == "every1":
            learn = list(s._learnable)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = [p.detach().to("cpu", copy=True) for p in learn]
            timing["healthy_copy_ms"] = 1e3 * (time.perf_counter() - t0)
            del host
            grads = [torch.randn_like(p) for p in learn]
            old = [p.detach().clone() for p in learn]
            timing["stats_ms"] = cuda_ms(torch, lambda: health.graph_stats(
                grads, old, learn, loss), 5)
            del grads, old, learn
        del s, loss
        _free(torch)
    for label in ("armed_no_fetch", "every16", "every1"):
        timing[f"{label}_over_off"] = (timing[label]["step_ms"]
                                       / timing["off"]["step_ms"])
    out["timing"] = timing

    # 2. the random streams under graphs: copy, 2 replays, restore, 2
    reset()
    s = new_step()
    for i in range(2):
        s(*data[i])
    ft = FaultTolerantStep(s)
    snap = ft._capture()
    first = [s(*data[2 + i]).item() for i in range(2)]
    ft._restore(snap)
    again = [s(*data[2 + i]).item() for i in range(2)]
    out["rng_probe"] = {"losses": first, "after_restore": again,
                        "captures": s._captures}
    gates["rng_probe"] = first == again and s._captures == 1
    del snap, ft, s
    _free(torch)

    # 3. watchpoints: health every=1, launches counted over the whole run
    A.flash_fwd_launches = A.flash_fwd_wgmma_launches = 0
    A.flash_fwd_tf32_launches = EMB.embedding_bwd_launches = 0
    n_rec = len(goodput.train().records())
    h_losses, h_world, hs = run({"every": 1, "action": "log"})
    launches = {"tf32": A.flash_fwd_tf32_launches,
                "all": A.flash_fwd_launches,
                "wgmma": A.flash_fwd_wgmma_launches, "forwards": n,
                "embedding_bwd": EMB.embedding_bwd_launches}
    records = goodput.train().records()[-n:]
    led = health.ledger().last_step
    ok, rel, name = held(h_world, h_losses)
    del h_world
    gates["health_on_equals_off"] = ok
    out["watchpoints"] = {"state_rel": rel, "worst_tensor": name,
                          "last": {k: led[k] for k in
                                   ("step", "grad_norm", "param_norm",
                                    "update_ratio", "loss")},
                          "nonfinite": sum(v["nonfinite"] for v in
                                           led["per_param"].values())}
    del hs
    _free(torch)
    # the first step's grad norm against an eager autograd pass
    reset()
    hs = new_step({"every": 1, "action": "log"})
    hs(*data[0])
    first_norm = health.ledger().last_step["grad_norm"]
    del hs
    _free(torch)
    reset()
    net.train()
    loss = _bert_loss(vocab)(net(*data[0][0]), data[0][1]).mean()
    learn = [p for p in net.parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, learn, allow_unused=True)
    eager_norm = math.sqrt(sum(float((g.double() ** 2).sum())
                               for g in grads if g is not None))
    del loss, grads
    out["watchpoints"].update(first_grad_norm=first_norm,
                              eager_grad_norm=eager_norm)
    gates["grad_norm"] = (abs(first_norm - eager_norm)
                          <= RESIL["norm_rel"] * eager_norm)
    # the stats the captured graph outputs on a replay (the third call,
    # the second replay) against reductions taken outside it: the
    # gradients of an eager autograd pass from the pre-step copy (the
    # random streams rewound), and the parameters the replay left
    # against those before it
    reset()
    hs = new_step({"every": 1, "action": "log"})
    hft = FaultTolerantStep(hs)
    for i in range(2):
        hs(*data[i])
    snap = hft._capture()
    replays0 = hs._replays
    hs(*data[2])
    led = health.ledger().last_step
    graph_stats = {k: led[k] for k in ("grad_norm", "param_norm",
                                       "update_ratio")}
    replayed = hs._replays == replays0 + 1 and hs._captures == 1
    learn = list(hs._learnable)
    after = [p.detach().clone() for p in learn]
    hft._restore(snap)
    del snap
    net.train()
    loss = _bert_loss(vocab)(net(*data[2][0]), data[2][1]).mean()
    grads = torch.autograd.grad(loss, learn, allow_unused=True)

    def norm(ts):
        return math.sqrt(sum(float((t.detach().double() ** 2).sum())
                             for t in ts if t is not None))
    pnorm = norm(after)
    eager_stats = {"grad_norm": norm(grads), "param_norm": pnorm,
                   "update_ratio": norm(a.double() - p.double()
                                        for a, p in zip(after, learn))
                   / pnorm}
    del loss, grads, after, learn, hs, hft
    _free(torch)
    rels = {k: abs(graph_stats[k] - v) / abs(v)
            for k, v in eager_stats.items()}
    out["watchpoints"].update(replay_stats=graph_stats,
                              replay_eager=eager_stats, replay_rel=rels,
                              replay_was_graph=replayed)
    gates["replay_stats"] = replayed and all(
        r <= RESIL["norm_rel"] for r in rels.values())
    gates["nonfinite_zero"] = out["watchpoints"]["nonfinite"] == 0
    gates["launches"] = (launches["tf32"] == layers * n == launches["all"]
                         and launches["wgmma"] == 0
                         and launches["embedding_bwd"]
                         == EMBEDDINGS_PER_BERT_STEP * n)
    out["flash_launches"] = launches
    # 4. replay: transient execute faults at call fault_call exhaust the
    # inner ladder; FaultTolerantStep restores its copy and replays
    attempts = RetryPolicy().max_attempts
    os.environ["MXNET_TPU_RETRY_BACKOFF"] = "0.01"
    resilience.reset_backend_state()
    replays0 = resilience.counters.replays
    captures = []
    # the first call is the compile site (its eager run and the capture),
    # so the execute site's entries start at call 2
    plan = {"execute": ["ok"] * (RESIL["fault_call"] - 2)
            + ["unavailable"] * attempts}
    try:
        with FaultPlan(plan) as fp:
            r_losses, r_world, rs = run(
                wrap=FaultTolerantStep,
                after_each=lambda st: captures.append(st._captures))
            pending = fp.pending("execute")
        replays = resilience.counters.replays - replays0
    finally:
        del os.environ["MXNET_TPU_RETRY_BACKOFF"]
        resilience.reset_backend_state()
    ok, rel, name = held(r_world, r_losses)
    out["replay"] = {"replays": replays, "captures_after_each": captures,
                     "state_rel": rel, "worst_tensor": name,
                     "faults_left": pending}
    gates["replay"] = (ok and replays == 1 and pending == 0
                       and set(captures) == {1})
    del r_world, rs
    _free(torch)

    # 5. async checkpoints every 4 steps, a resume, a torn and a corrupt one
    ck_dir = tempfile.mkdtemp(prefix="resilient_training_")
    try:
        ck = AsyncCheckpointer(ck_dir, every=RESIL["every"])

        def cadence(st):
            if ck.due(st._num_update):
                ck.save(st)
        try:
            c_losses, c_world, cs = run(before=ck.save, after_each=cadence)
            ck.wait()
        finally:
            ck.close()
        ok, rel, name = held(c_world, c_losses)
        del c_world, cs
        _free(torch)
        dirs = sorted(d for d in os.listdir(ck_dir) if d.startswith("step-"))
        out["checkpoints"] = {
            "dirs": dirs, "waits_s": list(ck.waits),
            "writes": list(ck.writes),
            "state_rel": rel, "disk_free_gb":
                shutil.disk_usage(ck_dir).free / 1e9}
        gates["checkpoints"] = ok and dirs == [
            f"step-{i:08d}" for i in range(0, n + 1, RESIL["every"])]
        # resume: BERT-base from another seed, warmed, restored from step 8
        other, fresh, _, _ = _bert_base(torch, seed + 1000, "float32")
        fresh(*data[0])
        ptrs = [t.data_ptr() for t in fresh._learnable]
        resume_at = n - RESIL["every"]
        t0 = time.perf_counter()
        meta = load_elastic_checkpoint(
            os.path.join(ck_dir, f"step-{resume_at:08d}"), fresh)
        load_s = time.perf_counter() - t0
        for i in range(resume_at, n):
            fresh(*data[i])
        world = _resil_tensors(fresh)
        ok, rel, name = held(world)
        out["resume"] = {"from_step": meta["step"], "load_s": load_s,
                         "state_rel": rel, "worst_tensor": name,
                         "captures": fresh._captures,
                         "addresses_kept": ptrs == [
                             t.data_ptr() for t in fresh._learnable]}
        gates["resume"] = (ok and fresh._captures == 1
                           and out["resume"]["addresses_kept"]
                           and meta["step"] == resume_at)
        del world, fresh, other
        _free(torch)
        # a truncated copy of one file, and a manifest-less directory
        torn = os.path.join(ck_dir, "torn")
        shutil.copytree(os.path.join(ck_dir, f"step-{RESIL['every']:08d}"),
                        torn)
        victim = os.path.join(torn, "params", "p0.bin")
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
        try:
            from mxnet_tpu_torch.checkpoint import verify_manifest
            verify_manifest(torn, required=True)
            named = None
        except CheckpointCorruptError as e:
            named = str(e)
        os.makedirs(os.path.join(ck_dir, f"step-{n + 99:08d}"))
        with open(os.path.join(ck_dir, f"step-{n + 99:08d}", "x.bin"),
                  "wb") as f:
            f.write(b"0")
        latest = latest_checkpoint(ck_dir)
        out["corrupt"] = {"error": named, "latest": latest[1]}
        gates["corrupt_named"] = named is not None and "p0.bin" in named
        gates["manifestless_skipped"] = latest[1] == n and not os.path.exists(
            os.path.join(ck_dir, f"step-{n + 99:08d}", MANIFEST_NAME))
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)

    # 6. numerics: a fault plan on encoder layer 6's ffn2
    target = next(health._block_name(b) for b in health._leaf_blocks(net)
                  if health._block_name(b).endswith(
                      f"enc_layer{RESIL['layer']}_ffn_ffn2"))
    numerics = {"block": target}
    for label, spec, action in (("bwd_raise", "bwd:nan", "raise"),
                                ("fwd_raise", "fwd:inf", "raise"),
                                ("bwd_skip", "bwd:nan", "skip")):
        reset()
        s = new_step({"every": 1, "action": action})
        for i in range(2):
            s(*data[i])
        o = s._opt
        before = _resil_tensors(s)
        counts = (s._num_update, o.num_update, dict(o._index_update_count))
        err = None
        with health.NumericsFaultPlan(net, {target: spec}):
            try:
                s(*data[2])
            except health.NumericsError as e:
                err = e
        trip = health.ledger().trips[-1]
        row = {"raised": err is not None,
               "first_fwd": trip.get("first_fwd"),
               "first_bwd": trip.get("first_bwd"),
               "localize_ms": 1e3 * trip.get("localization", {}).get(
                   "seconds", float("nan")),
               "captures": s._captures}
        if action == "skip":
            same = _resil_gap(_resil_tensors(s), before)[0]
            now = (s._num_update, o.num_update, dict(o._index_update_count))
            nxt = s(*data[2]).item()
            row.update(world_restored=same, counts_restored=now == counts,
                       next_loss=nxt, next_step=s._num_update)
            gates["skip"] = (same and now == counts and math.isfinite(nxt)
                             and s._num_update == counts[0] + 1
                             and err is None)
        else:
            key = "first_bwd" if spec.startswith("bwd") else "first_fwd"
            gates[label] = (err is not None
                            and err.detail.get(key) == target)
        numerics[label] = row
        del before, s, err
        _free(torch)
    out["numerics"] = numerics
    # 7. goodput: every step record of the health-on run, and the rest
    recs = [r for r in goodput.train().records()
            if r["kind"] == "train_step"]
    worst = max(abs(sum(r["buckets"].values()) - r["wall_seconds"])
                for r in recs)
    means = {}
    for r in records:
        for b, v in r["buckets"].items():
            means[b] = means.get(b, 0.0) + 1e3 * v / len(records)
    out["goodput"] = {"records": len(recs), "worst_residual_s": worst,
                      "health_run_bucket_ms_mean": means,
                      "health_run_wall_ms_mean": 1e3 * sum(
                          r["wall_seconds"] for r in records) / len(records),
                      "records_before_health_run": n_rec}
    gates["goodput_reconciles"] = worst <= RESIL["goodput_abs"]
    del base, init, data, net
    _free(torch)
    out["gates"] = gates
    out["seconds"] = time.perf_counter() - t_phase
    out["ok"] = all(gates.values())
    emit(out)
    check(out["ok"], f"resilient_training failed: "
          f"{[k for k, v in gates.items() if not v]}")
    return launches["tf32"], launches["embedding_bwd"]


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


# ---------------------------------------------------------------------------
# slice 19: the vision model zoo and the Estimator
# ---------------------------------------------------------------------------
# vision_zoo: each model built through get_model at its published widths
# (1000 classes, 224 px, Inception 299 px), weights from the seed (the
# port's initialize over the model's initializers), fp32, TF32 off.  The
# forward models: the eager forward at batch 32 (eval mode), the
# hybridized forward (its first call eager, the capture, then replays of
# the CachedOp's CUDA graph) equal to it bit for bit, and export ->
# SymbolBlock.imports against the block within ZOO["export_rel"] of the
# largest |value|.  The training models: CompiledTrainStep (SGD, momentum
# 0.9, wd 1e-4) at batch 64, as the training phase runs resnet50_v1 but
# for the timed eager run and the traced busy shares (`chip_profile.py
# --model zoo` traces these steps): the parity pair under deterministic
# algorithms (the graph's first 2 steps against the eager twin's), then
# 3 + 10 graph steps.  Dropout layers draw from one generator of seed +
# 1.  Each model is freed before the next is built.
ZOO = dict(classes=1000, px=224, inception_px=299, fwd_batch=32,
           train_batch=64, warmup=3, steps=10, export_rel=1e-5, fwd_timed=5)
ZOO_FORWARD = ("resnet50_v2", "mobilenet1_0", "mobilenet_v2_1_0",
               "densenet121", "inception_v3", "vgg16_bn", "squeezenet1_1",
               "alexnet")
ZOO_TRAIN = ("resnet50_v2", "mobilenet_v2_1_0", "densenet121",
             "inception_v3", "vgg16_bn")


def _zoo_px(name):
    return ZOO["inception_px"] if name.startswith("inception") else ZOO["px"]


def _zoo_net(torch, name, seed):
    """``name`` from get_model on the card: a first forward allocates the
    widths that wait for the input, then every tensor is drawn from
    ``seed``; its Dropout layers draw from a generator of ``seed + 1``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.initializer import initialize
    from mxnet_tpu_torch.random import generator
    px = _zoo_px(name)
    net = get_model(name, classes=ZOO["classes"], ctx=mx.gpu(0))
    net(mx.nd.zeros((1, 3, px, px), ctx=mx.gpu(0)))
    initialize(net, generator(seed, "cuda"))
    gen = generator(seed + 1, "cuda")
    for m in net.modules():
        if type(m).__name__ == "Dropout":
            m.generator = gen
    return net


def _rel_max(torch, got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def _zoo_forward(torch, name, seed, tmp):
    """The eager forward at batch 32, the hybridized forward's replays
    against it, and export -> imports against the block."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.block import SymbolBlock
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    t0 = time.perf_counter()
    net = _zoo_net(torch, name, seed)
    px = _zoo_px(name)
    x, _ = _images(torch, seed + 3, ZOO["fwd_batch"], px, ZOO["classes"])
    xn = NDArray(x, mx.gpu(0))
    ref = net(xn)._data.clone()
    eager_ms = cuda_ms(torch, lambda: net(xn), ZOO["fwd_timed"])
    net.hybridize()
    net(xn)
    graph_out = net(xn)._data.clone()
    graph_ms = cuda_ms(torch, lambda: net(xn), ZOO["fwd_timed"])
    op = net._cached_op
    stats = {"misses": op._misses, "captures": op._captures,
             "replays": op._replays}
    path = f"{tmp}/{name}"
    net.export(path)
    imported = SymbolBlock.imports(f"{path}-symbol.json", ["data"],
                                   f"{path}-0000.params", ctx=mx.gpu(0))
    imp = imported(xn)._data
    out = {"model": name, "px": px, "batch": ZOO["fwd_batch"],
           "params_m": sum(p.numel() for p in net.parameters()) / 1e6,
           "eager_ms": eager_ms, "graph_ms": graph_ms,
           "graph_rel": _rel_max(torch, graph_out, ref),
           "graph_bitwise": torch.equal(graph_out, ref),
           "export_rel": _rel_max(torch, imp, ref),
           "seconds": time.perf_counter() - t0, **stats}
    out["gates"] = {
        "finite": bool(torch.isfinite(ref).all()),
        "shape": tuple(ref.shape) == (ZOO["fwd_batch"], ZOO["classes"]),
        "graph_equals_eager": out["graph_bitwise"],
        "one_capture": stats["misses"] == stats["captures"] == 1
        and stats["replays"] == 1 + ZOO["fwd_timed"] + 2,
        "export_imports": out["export_rel"] <= ZOO["export_rel"]}
    del net, imported, op, x, xn
    _free(torch)
    return out


def _zoo_train(torch, name, seed):
    """``name`` through CompiledTrainStep's graph, its first 2 steps held
    to the eager twin's."""
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    batch = ZOO["train_batch"]

    def build():
        net = _zoo_net(torch, name, seed)
        x, y = _images(torch, seed + 7, batch, _zoo_px(name),
                       ZOO["classes"])
        return net, _train_step(net, batch), (x,), y

    def reset():
        FC.fused_conv_bn_launches = FC.fused_conv_bn_wgmma_launches = 0
        A.flash_fwd_launches = 0

    def read():
        return {"fused_conv_bn_launches": FC.fused_conv_bn_launches,
                "flash_fwd_launches": A.flash_fwd_launches}

    t0 = time.perf_counter()
    parity = _parity_pair(torch, build)
    graph, launches = _graph_run(torch, build, ZOO["warmup"], ZOO["steps"],
                                 reset, read, busy=False)
    steps = ZOO["warmup"] + ZOO["steps"]
    out = {"model": name, "batch": batch, "px": _zoo_px(name),
           "steps": steps, "step_ms": graph["step_ms"],
           "samples_per_sec": 1e3 * batch / graph["step_ms"],
           "peak_mem_gb": graph["peak_mem_gb"], "pool_gb": graph["pool_gb"],
           "first_loss": graph["first_loss"], "last_loss": graph["last_loss"],
           "parity": parity, "seconds": time.perf_counter() - t0,
           **launches}
    out["gates"] = {"losses_finite": math.isfinite(graph["first_loss"])
                    and math.isfinite(graph["last_loss"]),
                    "no_hand_written_kernel": not any(launches.values()),
                    **_graph_gates(graph, parity, steps)}
    return out


def phase_vision_zoo(torch, seed):
    """The zoo at published widths on the card (see ZOO)."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="vision_zoo_")
    try:
        forward = [_zoo_forward(torch, name, seed, tmp)
                   for name in ZOO_FORWARD]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    training = [_zoo_train(torch, name, seed) for name in ZOO_TRAIN]
    failed = [(r["model"], k) for r in forward + training
              for k, v in r["gates"].items() if not v]
    out = {"phase": "vision_zoo", "ok": not failed, "card": _card(),
           "tf32": _tf32(torch), "tolerance": {
               "card_rel": SERVE["card_rel"],
               "export_rel": ZOO["export_rel"]},
           "forward": forward, "training": training, "failed": failed,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    check(out["ok"], f"vision_zoo failed: {failed}")


# estimator: Estimator.fit on full-width resnet50_v1, fused fp32 (36
# FusedConv1x1BN layers), batch 256 at 224 px, TF32 off, SGD as bench.py
# through a gluon.Trainer: one epoch over a DataLoader of ESTIMATOR
# ["batches"] seeded host batches, prefetch_to_device=True, health=True,
# resume_on_fault=2 with two transient faults at the step's execute site
# (the inner retry ladder, MXNET_TPU_RETRY_MAX=2, exhausted once, so
# FaultTolerantStep replays one call), a ValidationHandler over
# ESTIMATOR["val_batches"] batches, a CheckpointHandler whose files are
# loaded back, an EarlyStoppingHandler and a LoggingHandler; once with
# steps_per_call=1, once with 2 (MultiStepTrainStep for both).
# Deterministic algorithms are on, so each run's parameters, moving
# statistics and momenta must equal bit for bit those of a hand-written
# CompiledTrainStep loop (health armed) over the same batches, staged on
# the card beforehand, from the same weights.  The fused kernel launches
# 36 times a training step (the validation forwards fold BN into a plain
# product).  Step ms is the median, over
# the steps past the first ESTIMATOR["warm"], of the host clock between
# synchronised batch ends (per step of a group), against the bare loop's,
# synchronised the same way.  The fit's goodput window leaves the event
# handlers' time unattributed; the Clock handler below synchronises, so
# most of a step's device time lands in its waits, which it times.  What
# stays unattributed beyond those waits (the other handlers: the
# checkpoint write, validation, logging) must be at most
# ESTIMATOR["unattributed_max"] of the window's wall.
ESTIMATOR = dict(batch=256, px=224, classes=1000, batches=16, val_batches=2,
                 warm=4, fault_at=6, unattributed_max=0.35)


def _estimator_host_data(torch, seed, n):
    """``n`` batches of images uniform in [0, 1) and labels, on the host."""
    gen = torch.Generator().manual_seed(seed)
    e = ESTIMATOR
    x = torch.rand(n * e["batch"], 3, e["px"], e["px"], generator=gen)
    y = torch.randint(0, e["classes"], (n * e["batch"],), generator=gen)
    return x.numpy(), y.float().numpy()


def _estimator_run(torch, seed, k, x, y, val, twin_snap, tmp):
    """One Estimator.fit at steps_per_call ``k``; its report and gates."""
    import statistics

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch import resilience as rs
    from mxnet_tpu_torch.gluon.contrib import estimator as E
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    e = ESTIMATOR
    net = _resnet50(torch, True, seed)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 1e-4})
    est = E.Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                      trainer=trainer, context=mx.gpu(0))
    loader = gluon.data.DataLoader(gluon.data.ArrayDataset(x, y),
                                   batch_size=e["batch"])
    clock, waits = [], []

    class Clock(E.BatchEnd):
        def batch_end(self, estimator, *a, **kw):
            t = time.perf_counter()
            torch.cuda.synchronize()
            now = time.perf_counter()
            waits.append(now - t)
            clock.append((now, kw.get("num_batches", 1)))

    prefix = f"r50_k{k}"
    ckpt = E.CheckpointHandler(tmp, model_prefix=prefix, max_checkpoints=1)
    early = E.EarlyStoppingHandler(est.train_loss_metric, patience=2)
    handlers = [Clock(), ckpt, early, E.LoggingHandler(log_interval=4),
                E.ValidationHandler(val, est.evaluate)]
    os.environ["MXNET_TPU_RETRY_MAX"] = "2"
    os.environ["MXNET_TPU_RETRY_BACKOFF"] = "0.001"
    rs.reset_backend_state()
    plan = rs.FaultPlan({"execute": ["ok"] * (e["fault_at"] - 1)
                         + ["unavailable"] * 2})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FC.fused_conv_bn_launches = FC.fused_conv_bn_wgmma_launches = 0
    t0 = time.perf_counter()
    with plan:
        est.fit(loader, epochs=1, event_handlers=handlers,
                prefetch_to_device=True, health=True, resume_on_fault=2,
                steps_per_call=k)
    wall = time.perf_counter() - t0
    launches = {"fused_conv_bn_launches": FC.fused_conv_bn_launches,
                "fused_conv_bn_wgmma_launches":
                    FC.fused_conv_bn_wgmma_launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    replays, faults = rs.counters.replays, rs.counters.faults_injected
    del os.environ["MXNET_TPU_RETRY_MAX"], os.environ["MXNET_TPU_RETRY_BACKOFF"]
    rs.reset_backend_state()
    step = est._fused_steps[(k, True)]
    gap = _gap(torch, _snapshot(step), twin_snap)
    # the checkpoint, loaded back into a net from another seed
    path = f"{tmp}/{prefix}-epoch1.params"
    other = _resnet50(torch, True, seed + 99)
    other.load_parameters(path, ctx=mx.gpu(0))
    loaded = all(torch.equal(a, b) for a, b in
                 zip(other.state_dict().values(), net.state_dict().values()))
    gluon.Trainer(other.collect_params(), "sgd",
                  {"learning_rate": 0.1}).load_states(
        path.replace(".params", ".states"))
    # ms per step of each batch-end event past the warm steps; the median
    # leaves out the call the fault replayed
    first = e["warm"] // k
    per_step = [1e3 * (t - clock[i - 1][0]) / n
                for i, (t, n) in enumerate(clock) if i >= first]
    est_ms = statistics.median(per_step)
    window = est.last_goodput
    out = {"steps_per_call": k, "steps": e["batches"],
           "val_batches": e["val_batches"], "wall_s": wall,
           "step_ms": est_ms, "step_ms_each": per_step,
           "samples_per_sec": 1e3 * e["batch"] / est_ms,
           "peak_mem_gb": peak, "captures": step._captures,
           "misses": step._misses, "replays": step._replays,
           "fault_replays": replays, "faults_injected": faults,
           "goodput": {"wall_s": window["wall_seconds"],
                       "buckets": window["buckets"],
                       "unattributed_s": window["unattributed_seconds"],
                       "clock_waits_s": sum(waits)},
           "input_wait_s": window["buckets"].get("input_wait", 0.0),
           "early_stopping": {"stopped_epoch": early.stopped_epoch,
                              "best": early.best},
           "checkpoint_files": sorted(os.listdir(tmp)),
           "twin": gap, **launches}
    # the validation forwards fold BN into the weight and run a plain
    # product (with_stats=False), as the JAX op does: no launch
    want = FUSED_LAUNCHES_PER_STEP * e["batches"]
    out["gates"] = {
        "launches": launches["fused_conv_bn_launches"] == want
        and launches["fused_conv_bn_wgmma_launches"] == want,
        "bitwise_with_bare_loop": gap["bitwise_equal"] == gap["tensors"],
        "one_capture": step._misses == step._captures == 1,
        "fault_replayed": replays == 1 and faults == 2,
        "checkpoint_loads": loaded,
        "goodput_attributes_steps": window["unattributed_seconds"]
        - sum(waits) <= e["unattributed_max"] * window["wall_seconds"]}
    del est, net, other, step, trainer, loader
    _free(torch)
    return out, launches["fused_conv_bn_launches"]


def phase_estimator(torch, seed):
    """Estimator.fit on fused resnet50_v1 at full width (see ESTIMATOR);
    returns the fused kernel's launches over both runs."""
    import shutil
    import statistics
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.executor import CompiledTrainStep
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.observability.health import HealthConfig
    t_phase = time.perf_counter()
    e = ESTIMATOR
    _free(torch)
    t0 = time.perf_counter()
    x, y = _estimator_host_data(torch, seed + 11, e["batches"])
    vx, vy = _estimator_host_data(torch, seed + 12, e["val_batches"])
    data_s = time.perf_counter() - t0
    b = e["batch"]
    val = [(NDArray(torch.from_numpy(vx[i * b:(i + 1) * b]).cuda(),
                    mx.gpu(0)),
            NDArray(torch.from_numpy(vy[i * b:(i + 1) * b]).cuda(),
                    mx.gpu(0))) for i in range(e["val_batches"])]
    tmp = tempfile.mkdtemp(prefix="estimator_")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        # the bare loop: the same batches staged on the card first
        net = _resnet50(torch, True, seed)
        bare = CompiledTrainStep(net, SoftmaxCrossEntropyLoss(),
                                 optimizer.create("sgd", learning_rate=0.1,
                                                  momentum=0.9, wd=1e-4),
                                 health=HealthConfig())
        staged = [(torch.from_numpy(x[i * b:(i + 1) * b]).cuda(),
                   torch.from_numpy(y[i * b:(i + 1) * b]).cuda())
                  for i in range(e["batches"])]
        torch.cuda.synchronize()
        ticks = []
        for sx, sy in staged:
            bare(sx, sy)
            torch.cuda.synchronize()
            ticks.append(time.perf_counter())
        bare_ms = statistics.median(
            1e3 * (b1 - b0) for b0, b1 in zip(ticks[e["warm"] - 1:-1],
                                              ticks[e["warm"]:]))
        twin_snap = _snapshot(bare)
        bare_peak = torch.cuda.max_memory_allocated() / 1e9
        del net, bare, staged
        _free(torch)
        runs, launches = [], 0
        for k in (1, 2):
            run, n = _estimator_run(torch, seed, k, x, y, val, twin_snap,
                                    tmp)
            runs.append(run)
            launches += n
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    for run in runs:
        run["step_ms_over_bare"] = run["step_ms"] / bare_ms
    failed = [(r["steps_per_call"], g) for r in runs
              for g, v in r["gates"].items() if not v]
    out = {"phase": "estimator", "ok": not failed, "model": "resnet50_v1",
           "fused": True, "dtype": "float32", "batch": b, "px": e["px"],
           "card": _card(), "tf32": _tf32(torch),
           "deterministic_algorithms": True, "host_data_s": data_s,
           "bare_step_ms": bare_ms, "bare_peak_mem_gb": bare_peak,
           "runs": runs, "failed": failed,
           "launches_per_step": FUSED_LAUNCHES_PER_STEP,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    check(out["ok"], f"estimator failed: {failed}")
    return launches


# ---------------------------------------------------------------------------
# slice 20: every optimizer through CompiledTrainStep's graph
# ---------------------------------------------------------------------------
# The large-batch recipes, and the host scalars a CUDA graph would freeze.
# (a) BERT-base pretraining as bert_training builds it (fp32, TF32 off, seq
# 128, batch 64, dropout 0.1 from the net's own generator) with LAMB (lr
# 1e-4, wd 0.01, bias correction), then AdamW (lr 1e-4, wd 0.01); (b)
# fused fp32 resnet50_v1 at batch 256 with LARS (momentum 0.9, eta 0.001,
# wd 1e-4, lr 0.1).  Each through the graph for 3 + 5 steps, then an eager
# twin built the same way (``_eager``) for the same steps, deterministic
# algorithms on: after every step the twin's parameters, buffers and
# optimizer states bit for bit the graph's.  Launches over the graph's
# steps, counted from 0 just before them: 12 fp32 tensor-core flash
# launches per BERT forward and no other variant, 2 Embedding backward
# launches per BERT step, 36 tensor-core conv-BN launches per ResNet step.
# Step ms are device time between CUDA events around each graph step
# (the first, eager and captured, left out), beside Adam (lr 1e-4, wd
# 0.01) on the same BERT and SGD with momentum (bench.py's) on the same
# ResNet, run the same way in the same call.  (c) every registered
# optimizer on a small Dense/BatchNorm net with a spare parameter the loss
# never reaches (its gradient is 0, so an SGLD step moves it by the noise
# alone), built from the registry with mx.optimizer.create: 4 graph steps
# (an eager call and capture, then 3 replays) against 4 eager steps of a
# twin, bit for bit after each; SGD and NAG also with multi_precision on
# an fp16 Dense net; LBSGD under a FactorScheduler.  SGLD's two replays
# must draw different noise, each with variance lr within
# OPTIM["noise_var_rel"] (2**16 draws: the standard error is 0.55% of lr).
OPTIM = dict(warmup=3, steps=5, bert_lr=1e-4, bert_wd=0.01,
             lars=dict(learning_rate=0.1, momentum=0.9, eta=0.001, wd=1e-4),
             small_steps=4, small_batch=64, small_in=64, small_units=256,
             small_out=10, spare=1 << 16, noise_var_rel=0.05)
SMALL_OPTS = {
    "sgd": dict(momentum=0.9), "nag": dict(momentum=0.9),
    "signum": dict(momentum=0.9, wd_lh=1e-4), "ftml": {},
    "dcasgd": dict(momentum=0.9), "sgld": dict(wd=0.0), "adam": {},
    "adamw": {}, "adagrad": {}, "adadelta": {},
    "rmsprop": dict(centered=True, clip_weights=2.0), "ftrl": {},
    "adamax": {}, "nadam": {}, "lars": dict(momentum=0.9, eta=0.01),
    "lbsgd": dict(momentum=0.9, warmup_epochs=1, updates_per_epoch=4,
                  batch_scale=4),
    "lamb": {}}


def _opt_trajectory(torch, build, steps, reset, read, twin=True):
    """``build()`` -> ``(net, step, xs, y)``.  Deterministic algorithms on:
    the graph's ``steps`` calls, a device copy of its world after each
    (``_resil_tensors``), then (with ``twin``) a twin built the same way
    run through ``_eager`` and held to each copy (``_resil_gap``).
    Returns the gaps, the graph's losses, device ms per call (CUDA events
    around it), its counts and ``read()`` after its steps, counted from
    ``reset()``."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _free(torch)
        net, step, xs, y = build()
        snaps, losses, events = [], [], []
        reset()
        for _ in range(steps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            losses.append(step(xs, y))
            e1.record()
            events.append((e0, e1))
            if twin:
                snaps.append(_resil_tensors(step))
        torch.cuda.synchronize()
        launches = read()
        counts = {"misses": step._misses, "captures": step._captures,
                  "replays": step._replays}
        ms = [a.elapsed_time(b) for a, b in events]
        losses = [float(v) for v in losses]
        del net, step, xs, y
        _free(torch)
        gaps = []
        if twin:
            net, eager, xs, y = build()
            for k in range(steps):
                eager._eager(xs, y)
                ok, rel, name = _resil_gap(_resil_tensors(eager), snaps[k])
                gaps.append({"step": k + 1, "bitwise": ok, "worst_rel": rel,
                             "worst": name})
            del net, eager, xs, y, snaps
    finally:
        torch.use_deterministic_algorithms(False)
        _free(torch)
    return {"gaps": gaps, "losses": losses, "ms": ms, "counts": counts,
            "launches": launches}


def _opt_run_line(name, run, steps, launches_ok):
    """A run's JSON fields and gates: every step bit for bit, one miss
    and one capture, a replay for every later step, finite losses, the
    launch gate."""
    timed = run["ms"][OPTIM["warmup"]:] or run["ms"][1:]
    gates = {"one_capture": run["counts"]["misses"]
             == run["counts"]["captures"] == 1
             and run["counts"]["replays"] == steps - 1,
             "losses_finite": all(math.isfinite(v) for v in run["losses"]),
             "launches": launches_ok}
    if run["gaps"]:
        gates["bitwise_every_step"] = all(g["bitwise"] for g in run["gaps"])
    return {"run": name, "steps": steps, "step_ms": sum(timed) / len(timed),
            "first_loss": run["losses"][0], "last_loss": run["losses"][-1],
            "worst_rel": max((g["worst_rel"] for g in run["gaps"]),
                             default=None),
            "gaps": run["gaps"], "launches": run["launches"],
            **run["counts"], "gates": gates}


def _opt_bert(torch, seed, opt_name, twin=True):
    """Full-width BERT-base (fp32) with ``opt_name`` at lr 1e-4, wd 0.01,
    through ``_opt_trajectory`` (without the twin's gaps when ``twin`` is
    False: the Adam baseline is timed only)."""
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.ops import embedding as EMB
    steps = OPTIM["warmup"] + OPTIM["steps"]
    cells = []

    def build():
        opt = optimizer.create(opt_name, learning_rate=OPTIM["bert_lr"],
                               wd=OPTIM["bert_wd"])
        net, step, x, y = _bert_base(torch, seed, "float32", opt)
        cells[:] = [len(net.bert.encoder.cells)]
        return net, step, x, y

    def reset():
        A.flash_fwd_launches = A.flash_fwd_wgmma_launches = 0
        A.flash_fwd_tf32_launches = EMB.embedding_bwd_launches = 0

    def read():
        return {"flash_fwd_launches": A.flash_fwd_launches,
                "flash_fwd_tf32_launches": A.flash_fwd_tf32_launches,
                "flash_fwd_wgmma_launches": A.flash_fwd_wgmma_launches,
                "embedding_bwd_launches": EMB.embedding_bwd_launches}

    run = _opt_trajectory(torch, build, steps, reset, read, twin)
    n = run["launches"]
    ok = (n["flash_fwd_launches"] == n["flash_fwd_tf32_launches"]
          == cells[0] * steps == 12 * steps
          and n["flash_fwd_wgmma_launches"] == 0
          and n["embedding_bwd_launches"]
          == EMBEDDINGS_PER_BERT_STEP * steps)
    return _opt_run_line(f"bert_{opt_name}", run, steps, ok)


def _opt_resnet(torch, seed, opt_name, twin=True):
    """Full-width fused fp32 resnet50_v1 (batch 256) with LARS
    (OPTIM["lars"]) or bench.py's SGD, through ``_opt_trajectory``."""
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.executor import CompiledTrainStep
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    steps = OPTIM["warmup"] + OPTIM["steps"]

    def build():
        net = _resnet50(torch, True, seed)
        x, y = _images(torch, seed + 7, TRAIN["batch"], TRAIN["px"],
                       TRAIN["classes"])
        if opt_name == "lars":
            opt = optimizer.create("lars", **OPTIM["lars"])
            step = CompiledTrainStep(net, SoftmaxCrossEntropyLoss(), opt,
                                     batch_size=TRAIN["batch"])
        else:
            step = _train_step(net, TRAIN["batch"])
        return net, step, (x,), y

    def reset():
        FC.fused_conv_bn_launches = FC.fused_conv_bn_wgmma_launches = 0

    def read():
        return {"fused_conv_bn_launches": FC.fused_conv_bn_launches,
                "fused_conv_bn_wgmma_launches":
                    FC.fused_conv_bn_wgmma_launches}

    run = _opt_trajectory(torch, build, steps, reset, read, twin)
    n = run["launches"]
    ok = (n["fused_conv_bn_launches"] == n["fused_conv_bn_wgmma_launches"]
          == FUSED_LAUNCHES_PER_STEP * steps)
    return _opt_run_line(f"resnet50_{opt_name}", run, steps, ok)


def _opt_small(torch, seed, name, mp=False):
    """(c): ``name`` from the registry on the small net (fp16 Dense layers
    under ``multi_precision`` when ``mp``), 4 graph steps against its
    eager twin; for SGLD the spare parameter's noise of two replays."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import lr_scheduler
    from mxnet_tpu_torch.executor import CompiledTrainStep
    from mxnet_tpu_torch.gluon import loss, nn
    from mxnet_tpu_torch.initializer import initialize
    from mxnet_tpu_torch.random import generator
    o = OPTIM
    dtype = torch.float16 if mp else torch.float32

    class Spare(torch.nn.Module):
        def __init__(self, body):
            super().__init__()
            self.body = body
            self.spare = torch.nn.Parameter(torch.zeros(
                o["spare"], device="cuda", dtype=dtype))

        def forward(self, x):
            return self.body(x)

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    x = torch.randn(o["small_batch"], o["small_in"], generator=gen,
                    device="cuda").to(dtype)
    y = torch.randn(o["small_batch"], o["small_out"], generator=gen,
                    device="cuda").to(dtype)

    def build():
        mx.random.seed(seed)
        body = nn.HybridSequential(prefix="opt_")
        with body.name_scope():
            layers = [nn.Dense(o["small_units"], in_units=o["small_in"],
                               device="cuda")]
            if not mp:
                layers.append(nn.BatchNorm(in_channels=o["small_units"],
                                           device="cuda"))
            layers += [nn.Activation("relu"),
                       nn.Dense(o["small_out"], in_units=o["small_units"],
                                device="cuda")]
            body.add(*layers)
        initialize(body, generator(seed, "cuda"))
        if mp:
            body.cast("float16")
        kw = {"learning_rate": 0.01, "wd": 1e-4, **SMALL_OPTS[name]}
        if name == "lbsgd":
            kw["lr_scheduler"] = lr_scheduler.FactorScheduler(1, 0.7)
        opt = mx.optimizer.create(name, multi_precision=mp, **kw)
        net = Spare(body)
        return net, CompiledTrainStep(net, loss.L2Loss(), opt), (x,), y

    steps = o["small_steps"]
    run = _opt_trajectory(torch, build, steps, lambda: None, lambda: {})
    line = _opt_run_line(f"{name}{'_mp_fp16' if mp else ''}", run, steps,
                         True)
    del line["gaps"], line["launches"]
    if name == "sgld":
        # the spare parameter after each of the graph's steps: steps 2 and
        # 3 are replays, so their differences are two replays' noise
        net, step, xs, yy = build()
        spares = []
        for _ in range(3):
            step(xs, yy)
            spares.append(net.spare.detach().double().clone())
        noise = [spares[1] - spares[0], spares[2] - spares[1]]
        var = [float(n.var()) for n in noise]
        line["noise_var"] = var
        line["gates"]["fresh_noise"] = (
            step._replays == 2 and not torch.equal(noise[0], noise[1])
            and all(abs(v - 0.01) <= o["noise_var_rel"] * 0.01
                    for v in var))
        del net, step
        _free(torch)
    line["ok"] = all(line["gates"].values())
    return line


def phase_optimizers(torch, seed):
    """Every optimizer through CompiledTrainStep's CUDA graph (see OPTIM);
    returns the launches over the main path's graph steps: BERT-base under
    LAMB and AdamW (flash, Embedding backward), resnet50_v1 under LARS
    (conv-BN)."""
    t0 = time.perf_counter()
    bert = [_opt_bert(torch, seed, "lamb"), _opt_bert(torch, seed, "adamw"),
            _opt_bert(torch, seed, "adam", twin=False)]
    resnet = [_opt_resnet(torch, seed, "lars"),
              _opt_resnet(torch, seed, "sgd", twin=False)]
    for line in bert + resnet:
        line["ok"] = all(line["gates"].values())
        emit({"phase": "optimizers", **line})
    small = [_opt_small(torch, seed, name) for name in SMALL_OPTS]
    small += [_opt_small(torch, seed, name, mp=True) for name in
              ("sgd", "nag")]
    adam_ms, sgd_ms = bert[2]["step_ms"], resnet[1]["step_ms"]
    out = {"phase": "optimizers", "card": _card(),
           "deterministic_algorithms": True, "tf32": _tf32(torch),
           "bert_step_ms": {r["run"]: r["step_ms"] for r in bert},
           "lamb_over_adam": bert[0]["step_ms"] / adam_ms,
           "adamw_over_adam": bert[1]["step_ms"] / adam_ms,
           "resnet_step_ms": {r["run"]: r["step_ms"] for r in resnet},
           "lars_over_sgd": resnet[0]["step_ms"] / sgd_ms,
           "small": small,
           "seconds": time.perf_counter() - t0}
    out["gates"] = {r["run"]: r["ok"] for r in bert + resnet + small}
    out["gates"]["within_120_s"] = out["seconds"] <= 120.0
    out["ok"] = all(out["gates"].values())
    emit(out)
    check(out["ok"], f"optimizers failed: "
          f"{[k for k, v in out['gates'].items() if not v]}")
    flash = sum(r["launches"]["flash_fwd_tf32_launches"] for r in bert[:2])
    emb = sum(r["launches"]["embedding_bwd_launches"] for r in bert[:2])
    return resnet[0]["launches"]["fused_conv_bn_launches"], flash, emb


# ---------------------------------------------------------------------------
# Slice 21: the rest of the ops and the Gluon fused RNN layers (ops_rnn).
#
# (a) Every op the slice registered but the samplers, on CUDA NDArrays
# against the same op on CPU copies of the inputs (the port's plain form),
# forward and, for a differentiable op, the gradients of a seeded weighted
# sum of its float outputs: floats within OPS_TOL[dtype] (the RNN's
# RNN_TOL) of each tensor's largest |value| (cuDNN's TF32 off for the
# comparison), -inf where the CPU has -inf, indices and integers exactly
# (ties included: both devices sort stably).  The ordering ops run over llama_7b's logits [4, 32000] in
# fp32 and bf16, masked_softmax at BERT-base's scores [64, 12, 128, 128],
# rope at llama_7b's [4, 2048, 4096] with 32 heads, _backward_gather_nd
# over 65536 rows with duplicate indices (launched twice on the card: the
# same bits).  The fused RNN layer's cuDNN calls are recorded: each takes
# its weight space inside the packed parameter vector (no copy).  The
# samplers: mean and variance of OPS_DRAWS draws against the
# distribution's; two replays of a hybridized block that draws normals
# differ; a hybridized boolean_mask raises MXNetError at its capture.
# (b) The large word-level LSTM language model of Zaremba, Sutskever and
# Vinyals 2014, "Recurrent Neural Network Regularization", §4.1, as
# MXNet's example/gluon/word_language_model builds and trains it
# (untied): Xavier weights from the seed and Zipf-distributed token ids
# from the seed, [35, 20] TNC windows, the state carried and detached
# between them, SoftmaxCrossEntropyLoss, the summed loss's gradient
# clipped at clip·bptt·batch (clip_global_norm) and SGD at lr 1 stepping
# by bptt·batch.  At dropout 0, 3 windows of a hybridized twin (CUDA
# graphs) against the eager net from the same weights, bit for bit,
# under deterministic algorithms; then the main path at dropout 0.65,
# with the launch counters zeroed just before: LSTM_LM["windows"] eager
# windows from the initial weights, then the same net, its initial
# weights written back, hybridized over the same windows; the loss falls
# over each run.  (c) unfused resnet50_v1 (fp32, batch 64) forward and a
# graph training step under MXNET_TPU_CONV_LAYOUT=NCHW and NHWC, each
# timed with TF32 off and on: the forward outputs (TF32 off) within
# LAYOUT["rel"] of the largest |logit|.
OPS_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -9}
# The fused RNN's outputs and gradients pass through every step of the
# sequence, both directions and both layers, and cuDNN adds the gates'
# products in another order than the CPU's kernels: its fp32 tolerance is
# 1e-4 (an rnn_tanh gradient differed by 1.26e-5 of its largest |value|
# on an H100 80GB HBM3, 700 W, TF32 off).
RNN_TOL = 1e-4
OPS_DRAWS = 1_000_000
LSTM_LM = dict(vocab=10000, emb=1500, hidden=1500, layers=2, bptt=35,
               batch=20, dropout=0.65, lr=1.0, clip=10.0, windows=8,
               parity_windows=3, zipf=1.1)
# rel: the NHWC-against-NCHW tolerance of tests/test_torch_ops_nn_rest.py
LAYOUT = dict(batch=64, px=224, rel=1e-5, timed=3)


def _sweep_cases(torch, seed):
    """``(names, inputs, params, grad)``: every name of the case runs on
    the same CPU tensors (a canonical op and its other names)."""
    g = torch.Generator().manual_seed(seed)

    def rn(*s, dtype=torch.float32, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(dtype)

    def ri(hi, *s):
        return torch.randint(0, hi, s, generator=g).to(torch.float32)

    logits = rn(4, 32000)
    cases = []
    for lg in (logits, logits.to(torch.bfloat16)):
        cases += [(("topk",), [lg], dict(k=10, ret_typ="both"), False),
                  (("topk",), [lg], dict(k=5, is_ascend=True), False),
                  (("topk",), [lg], dict(k=3, ret_typ="mask"), False),
                  (("sort",), [lg], dict(is_ascend=False), False),
                  (("argsort",), [lg], dict(is_ascend=False), False),
                  (("argmax",), [lg], dict(axis=1), False),
                  (("argmin",), [lg], dict(axis=1), False),
                  (("argmax_channel",), [lg], {}, False)]
    ties = ri(4, 3, 9)
    idx = torch.tensor([[0, 2, 0, 1], [1, 0, 1, 2]], dtype=torch.float32)
    rows = torch.randint(0, 512, (2, 65536), generator=g)
    rows[0] %= 64
    lens = torch.tensor([2.0, 5.0, 1.0])
    mask = (torch.rand(64, 12, 128, 128, generator=g) > 0.3).float()
    ang = torch.outer(torch.arange(2048.0), 1.0 / 10000 ** (
        torch.arange(64.0) / 128))
    k = 5                    # the bilinear kernel of scale 3: 2·3 − 3 % 2
    f = math.ceil(k / 2)
    w1 = 1 - (torch.arange(float(k)) / f - (2 * f - 1 - f % 2) / (2 * f)
              ).abs()
    bilinear = torch.outer(w1, w1).expand(2, 1, k, k).contiguous()
    rnn = []
    for mode, (t, n, i, h) in (("lstm", (7, 3, 5, 8)), ("gru", (6, 2, 7, 5)),
                               ("rnn_tanh", (5, 4, 3, 6)),
                               ("rnn_relu", (5, 3, 4, 3))):
        from mxnet_tpu_torch.ops.nn import rnn_param_shapes
        n_par = sum(math.prod(q) for q in rnn_param_shapes(mode, i, h, 2, 2))
        ins = [rn(t, n, i), rn(n_par, scale=0.3), rn(4, n, h, scale=0.5)]
        ins += [rn(4, n, h, scale=0.5)] * (mode == "lstm")
        rnn.append((("RNN",), ins, dict(state_size=h, num_layers=2,
                                        mode=mode, bidirectional=True),
                    True))
    cases += [
        (("flip", "reverse"), [rn(2, 3, 4)], dict(axis=1), True),
        (("tile",), [rn(2, 3)], dict(reps=(2, 1, 3)), True),
        (("repeat",), [rn(2, 3)], dict(repeats=2, axis=1), True),
        (("broadcast_axis", "broadcast_axes"), [rn(2, 1, 3)],
         dict(axis=1, size=4), True),
        (("slice_like",), [rn(4, 5), rn(2, 3)], {}, True),
        (("split_v2", "_split_v2"), [rn(6, 4)],
         dict(indices_or_sections=(1, 3)), True),
        (("depth_to_space",), [rn(2, 8, 3, 3)], dict(block_size=2), True),
        (("space_to_depth",), [rn(2, 2, 4, 6)], dict(block_size=2), True),
        (("diag",), [rn(4, 5)], dict(k=1), True),
        (("khatri_rao",), [rn(2, 3), rn(4, 3)], {}, True),
        (("shape_array",), [rn(2, 3, 4)], {}, False),
        (("size_array",), [rn(2, 3, 4)], {}, False),
        (("sort",), [ties], {}, False),
        (("argsort",), [ties], dict(is_ascend=False), False),
        (("topk",), [ties], dict(k=4), False),
        (("batch_take",), [rn(4, 5), torch.tensor([0.0, 4, 2, 1])], {},
         True),
        (("gather_nd",), [rn(3, 3, 2), idx], {}, True),
        (("scatter_nd",), [rn(4, 2), idx], dict(shape=(3, 3, 2)), True),
        (("_scatter_set_nd",), [rn(3, 3), rn(4), idx], dict(shape=(3, 3)),
         True),
        (("_backward_gather_nd",), [rn(65536, 128), rows.float()],
         dict(shape=(64, 512, 128)), False),
        (("boolean_mask", "_contrib_boolean_mask"),
         [rn(5, 3), torch.tensor([1.0, 0, 1, 1, 0])], {}, True),
        (("SequenceMask", "sequence_mask"), [rn(5, 3, 2), lens],
         dict(use_sequence_length=True), True),
        (("SequenceLast", "sequence_last"), [rn(5, 3, 2), lens],
         dict(use_sequence_length=True), True),
        (("SequenceReverse", "sequence_reverse"), [rn(5, 3, 2), lens],
         dict(use_sequence_length=True), True),
        (("_eye", "_npi_eye"), [], dict(N=3, M=5, k=1), False),
        (("_linspace", "_npi_linspace"), [], dict(start=-1, stop=2, num=7),
         False),
        (("_zeros_without_dtype", "_npi_zeros"), [], dict(shape=(2, 3)),
         False),
        (("_npi_ones",), [], dict(shape=(2, 3)), False),
        (("_npi_full",), [], dict(shape=(2, 3), value=2.5), False),
        (("_npi_arange",), [], dict(start=1, stop=7, step=2), False),
        (("softmin",), [rn(3, 5)], dict(axis=1), True),
        (("SoftmaxActivation",), [rn(2, 3, 2, 2)], dict(mode="channel"),
         True),
        (("LRN",), [rn(2, 6, 3, 3)], dict(nsize=3), True),
        (("softmax_cross_entropy",), [rn(4, 5), ri(5, 4)], {}, True),
        (("masked_softmax",), [rn(64, 12, 128, 128), mask], {}, True),
        (("masked_log_softmax",), [rn(3, 7), ri(2, 3, 7)], {}, True),
        (("ROIPooling",), [rn(2, 3, 8, 8), torch.tensor(
            [[0.0, 0, 0, 7, 7], [1, 2, 1, 5, 6]])],
         dict(pooled_size=(2, 3), spatial_scale=1.0), False),
        (("im2col",), [rn(2, 3, 6, 5)],
         dict(kernel=(3, 3), stride=(2, 1), dilate=(1, 2), pad=(1, 1)),
         True),
        (("CuDNNBatchNorm",), [rn(4, 3, 2, 2), rn(3), rn(3),
                               torch.zeros(3), torch.ones(3)],
         dict(fix_gamma=False), True),
        (("rope",), [rn(4, 2048, 4096), torch.cos(ang), torch.sin(ang)],
         dict(num_heads=32), True),
        *rnn,
        (("equal", "_equal", "not_equal", "_not_equal", "greater",
          "_greater", "greater_equal", "_greater_equal", "less", "lesser",
          "_lesser", "less_equal", "lesser_equal", "_lesser_equal",
          "logical_and", "_logical_and", "logical_or", "_logical_or",
          "logical_xor", "_logical_xor"), [ri(3, 3, 4), ri(3, 1, 4)], {},
         False),
        (("mod", "_mod"), [rn(3, 4), ri(3, 1, 4) + 1], {}, True),
        (("_hypot", "_grad_add"), [rn(3, 4), rn(1, 4)], {}, True),
        (("_scatter_plus_scalar", "_scatter_minus_scalar"), [rn(3, 4)],
         dict(scalar=2.5), True),
        (("_np_copy", "_npx_relu", "_npx_sigmoid", "cast_storage"),
         [rn(3, 4)], {}, True),
        (("UpSampling", "upsampling"), [rn(1, 2, 4, 4), rn(1, 3, 2, 2)],
         dict(scale=2, num_args=2), True),
        (("UpSampling",), [rn(1, 2, 3, 3), bilinear],
         dict(scale=3, sample_type="bilinear", num_filter=2), True),
        (("col2im",), [rn(2, 27, 9)], dict(output_size=(5, 6),
                                           kernel=(3, 3), stride=(2, 2),
                                           pad=(1, 1)), True),
        (("_histogram", "histogram"), [rn(50)], dict(bin_cnt=7), False),
        (("arange_like", "_contrib_arange_like", "_npx_arange_like"),
         [rn(4, 3)], dict(axis=0, repeat=2), False),
        (("amp_cast",), [rn(2, 3)], dict(dtype="float16"), True),
        (("amp_multicast",), [rn(2, 3, dtype=torch.float16), rn(2, 3)],
         dict(num_outputs=2), True),
        (("_square_sum", "square_sum"), [rn(3, 4)], dict(axis=1), True),
        (("_sparse_retain",), [rn(5, 2), torch.tensor([0.0, 3, 3])], {},
         False),
        (("_contrib_getnnz",), [ri(3, 4, 5)], dict(axis=1), False),
        (("_identity_with_attr_like_rhs",), [rn(2, 3), rn(2, 3)], {}, True),
        (("IdentityAttachKLSparseReg",), [torch.rand(6, 4, generator=g)],
         dict(sparseness_target=0.2, penalty=0.01), True),
        (("_rnn_param_concat",), [rn(6), rn(4)], dict(num_args=2), True),
        (("_npi_identity",), [], dict(shape=(4, 4)), False),
        (("_npi_indices",), [], dict(dimensions=(2, 3)), False),
        (("_npx_reshape",), [rn(2, 3, 4)], dict(newshape=(-2, -1)), True),
        (("_npx_constraint_check",), [ri(2, 5) + 1], {}, False),
        (("_npi_share_memory",), [rn(2), rn(2)], {}, False),
    ]
    return cases


def _on_device(torch, mx, name, inputs, params, grad, ctx):
    """``mx.nd.<name>`` on ``ctx``: the outputs and, with ``grad``, the
    float inputs' gradients of a seeded weighted sum of the float
    outputs, as CPU tensors."""
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.ops.registry import get
    dev = ctx.torch_device()
    nds = [NDArray(t.to(dev, copy=True), ctx) for t in inputs]
    if get(name).nin == 0:
        params = dict(params, ctx=ctx)
    wrt = [x for x in nds if grad and x._data.is_floating_point()]
    for x in wrt:
        x.attach_grad()
    with mx.autograd.record():
        outs = getattr(mx.nd, name)(*nds, **params)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        head = None
        for i, o in enumerate(outs):
            if not wrt or not o._data.is_floating_point():
                continue
            w = torch.rand(o.shape, generator=torch.Generator().manual_seed(
                i)).to(dev)
            term = (o.astype("float32") * NDArray(w, ctx)).sum()
            head = term if head is None else head + term
    if head is not None:
        head.backward()
    grads = [x.grad._data for x in wrt] if head is not None else []
    return [t.detach().cpu() for t in [o._data for o in outs] + grads]


def _tensor_gap(torch, got, ref, tol=None):
    """``None`` when ``got`` (the card) holds to ``ref`` (the CPU), else
    why not; floats within ``tol`` (by default OPS_TOL of the dtype) of
    ``ref``'s largest finite |value|."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return f"{tuple(got.shape)} {got.dtype} != {tuple(ref.shape)} " \
               f"{ref.dtype}"
    if not ref.is_floating_point():
        return None if torch.equal(got, ref) else "values differ"
    g, r = got.double(), ref.double()
    if not torch.equal(torch.isinf(g) & (g < 0), torch.isinf(r) & (r < 0)) \
            or not torch.equal(torch.isnan(g), torch.isnan(r)):
        return "inf/nan pattern differs"
    fin = torch.isfinite(r)
    if not fin.any():
        return None
    scale = max(r[fin].abs().max().item(), 1e-30)
    err = (g[fin] - r[fin]).abs().max().item() / scale
    tol = tol or OPS_TOL[str(ref.dtype).split(".")[-1]]
    return None if err <= tol else f"rel err {err:.3g} > {tol}"


def _ops_sweep(torch, mx, seed):
    """Part (a)'s CPU/card sweep."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    bad, names, worst = {}, [], 0.0
    try:
        for names_, inputs, params, grad in _sweep_cases(torch, seed):
            for name in names_:
                ref = _on_device(torch, mx, name, inputs, params, grad,
                                 mx.cpu())
                got = _on_device(torch, mx, name, inputs, params, grad,
                                 mx.gpu(0))
                names.append(name)
                why = None if len(got) == len(ref) else "output count"
                tol = RNN_TOL if name == "RNN" else None
                for k, (a, b) in enumerate(zip(got, ref)):
                    gap = _tensor_gap(torch, a, b, tol)
                    why = why or (gap and f"tensor {k}: {gap}")
                    if why is None and b.is_floating_point():
                        fin = torch.isfinite(b)
                        if fin.any():
                            worst = max(worst, ((a.double() - b.double())[
                                fin].abs().max() / b.double()[fin].abs()
                                .max().clamp_min(1e-30)).item())
                if why:
                    bad[f"{name}{tuple(params.items())[:3]}"] = why
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return {"cases": len(names), "names": len(set(names)),
            "worst_rel_err": worst, "failed": bad}


def _repeat_bits(torch, mx, seed):
    """_backward_gather_nd with duplicates and gather_nd's gradient (both
    csrc/embedding_bwd.cu on the card), each launched twice: the same
    bits."""
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    g = torch.Generator(device="cuda").manual_seed(seed)
    gpu = mx.gpu(0)
    data = NDArray(torch.randn(65536, 128, generator=g, device="cuda"), gpu)
    rows = torch.randint(0, 512, (2, 65536), generator=g, device="cuda")
    rows[0] %= 64
    idx = NDArray(rows.float(), gpu)
    a = mx.nd._backward_gather_nd(data, idx, shape=(64, 512, 128))
    b = mx.nd._backward_gather_nd(data, idx, shape=(64, 512, 128))
    table = NDArray(torch.randn(64, 512, 128, generator=g, device="cuda"),
                    gpu)
    grads = []
    for _ in range(2):
        table.attach_grad()
        with mx.autograd.record():
            out = mx.nd.gather_nd(table, idx)
        out.backward(data)
        grads.append(table.grad._data.clone())
    return {"backward_gather_nd": torch.equal(a._data, b._data),
            "gather_nd_grad": torch.equal(grads[0], grads[1]),
            "duplicates": int(65536 - torch.unique(
                rows[0] * 512 + rows[1]).numel())}


def _rnn_no_copy(torch, mx):
    """The fused layer's cuDNN calls on the card: each call's weight space
    is a slice of one packed vector, and cuDNN returns that buffer itself
    (no weight copy); one call per layer and direction.  Also reports
    whether cuDNN's layout of a whole multi-layer network is the packed
    order (why the op calls it per layer and direction)."""
    from mxnet_tpu_torch import gluon
    layer = gluon.rnn.LSTM(64, num_layers=2, bidirectional=True,
                           input_size=32)
    layer.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    calls, real = [], torch._cudnn_rnn

    def recording(*args):
        out = real(*args)
        calls.append((args[3].untyped_storage().data_ptr(),
                      args[3].data_ptr(), out[4].data_ptr()))
        return out
    torch._cudnn_rnn = recording
    try:
        with mx.autograd.record():
            out = layer(mx.nd.ones((7, 3, 32), ctx=mx.gpu(0)))
        out.backward()
    finally:
        torch._cudnn_rnn = real
    # cuDNN's layout of a whole 2-layer network: is it the packed order
    # (per layer and direction wx, wh, bx, bh)?  If not, the whole vector
    # could not be its weight space without a copy
    whole = torch.nn.LSTM(32, 64, 2, bidirectional=True).to("cuda")
    whole.flatten_parameters()
    ws = whole._flat_weights
    offsets = [(w.data_ptr() - ws[0].data_ptr()) // 4 for w in ws]
    packed = [sum(v.numel() for v in ws[:i]) for i in range(len(ws))]
    return {"cudnn_calls": len(calls),
            "one_vector": len({c[0] for c in calls}) == 1,
            "buffer_returned": all(c[1] == c[2] for c in calls),
            "cudnn_multilayer_layout_is_packed": offsets == packed}


def _var_rel(name):
    """The variance tolerance: 3%, 5% for the heavy-tailed gamma and
    negative binomials (over 5 standard errors of the sample variance at
    OPS_DRAWS / 2 draws)."""
    return 0.05 if "binomial" in name or "gamma" in name else 0.03


def _moments(torch, x, mean, var, var_rel):
    x = x.double().reshape(-1)
    se = math.sqrt(var / x.numel())
    m, v = x.mean().item(), x.var(unbiased=False).item()
    return {"mean": m, "var": v, "want": [mean, var],
            "ok": abs(m - mean) <= 6 * se and abs(v - var) <= var_rel * var}


def _random_checks(torch, mx, seed):
    """The samplers on the card: moments of OPS_DRAWS draws; the
    categorical draws' frequencies; shuffle is a permutation; a
    hybridized block's graph draws fresh normals on every replay; a
    hybridized boolean_mask raises MXNetError at its capture."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.base import MXNetError
    mx.random.seed(seed)
    gpu, n = mx.gpu(0), OPS_DRAWS
    out = {}
    for name, kw, mean, var in (
            ("uniform", dict(low=-1.0, high=3.0), 1.0, 16 / 12),
            ("normal", dict(loc=2.0, scale=0.5), 2.0, 0.25),
            ("gamma", dict(alpha=2.0, beta=1.5), 3.0, 4.5),
            ("exponential", dict(scale=2.0), 2.0, 4.0),
            ("poisson", dict(lam=3.0), 3.0, 3.0),
            ("negative_binomial", dict(k=3, p=0.4), 4.5, 11.25),
            ("generalized_negative_binomial", dict(mu=2.0, alpha=0.5), 2.0,
             4.0),
            ("randint", dict(low=-2, high=5), 1.0, 4.0)):
        a = getattr(mx.nd.random, name)(shape=(n,), ctx=gpu, **kw)
        out[name] = _moments(torch, a._data, mean, var, _var_rel(name))
    p2 = mx.nd.array([1.0, 4.0], ctx=gpu)
    for name, params, mean, var in (
            ("sample_uniform", [mx.nd.array([0.0, -2.0], ctx=gpu), p2],
             [0.5, 1.0], [1 / 12, 3.0]),
            ("sample_normal", [mx.nd.array([1.0, -3.0], ctx=gpu), p2],
             [1.0, -3.0], [1.0, 16.0]),
            ("sample_gamma", [mx.nd.array([2.0, 0.5], ctx=gpu), p2],
             [2.0, 2.0], [2.0, 8.0]),
            ("sample_exponential", [p2], [1.0, 0.25], [1.0, 1 / 16]),
            ("sample_poisson", [p2], [1.0, 4.0], [1.0, 4.0]),
            ("sample_negative_binomial",
             [mx.nd.array([2.0, 5.0], ctx=gpu),
              mx.nd.array([0.5, 0.8], ctx=gpu)], [2.0, 1.25], [4.0, 1.5625]),
            ("sample_generalized_negative_binomial",
             [mx.nd.array([2.0, 1.0], ctx=gpu),
              mx.nd.array([0.5, 0.25], ctx=gpu)], [2.0, 1.0], [4.0, 1.25])):
        a = getattr(mx.nd, name)(*params, shape=(n // 2,))
        rows = [_moments(torch, a._data[i], mean[i], var[i], _var_rel(name))
                for i in range(2)]
        out[name] = {"rows": rows, "ok": all(r["ok"] for r in rows)}
    probs = torch.tensor([0.1, 0.2, 0.7])
    d = mx.nd.random.multinomial(mx.nd.array(probs.numpy(), ctx=gpu),
                                 shape=(n,))
    freq = torch.bincount(d._data.long(), minlength=3).double().cpu() / n
    se = (probs.double() * (1 - probs.double()) / n).sqrt()
    out["multinomial"] = {"freq": freq.tolist(),
                          "ok": bool(((freq - probs).abs() <= 6 * se).all())}
    z = mx.nd._sample_unique_zipfian(range_max=1000, shape=(n,), ctx=gpu)
    k = torch.arange(1000, dtype=torch.float64)
    pz = torch.log((k + 2) / (k + 1)) / math.log(1001)
    pz[-1] += 1 - pz.sum()
    mean = (k * pz).sum().item()
    out["_sample_unique_zipfian"] = _moments(
        torch, z._data, mean, ((k - mean) ** 2 * pz).sum().item(), 0.03)
    perm = mx.nd.random.shuffle(mx.nd.array(torch.arange(1000.0).numpy(),
                                            ctx=gpu))._data
    out["shuffle"] = {"ok": torch.equal(perm.sort().values,
                                        torch.arange(1000.0,
                                                     device="cuda"))}

    class _Draw(gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x + F.random.normal(shape=x.shape, ctx=x.context)

    class _Mask(gluon.HybridBlock):
        def hybrid_forward(self, F, x, m):
            return F.boolean_mask(x, m)

    draw = _Draw()
    draw.hybridize()
    x = mx.nd.zeros((4096,), ctx=gpu)
    first, r1, r2 = (draw(x)._data.clone() for _ in range(3))
    op = draw._cached_op
    out["replays_fresh"] = {
        "ok": op._captures == 1 and op._replays == 2
        and not torch.equal(r1, r2) and not torch.equal(first, r1),
        "captures": op._captures, "replays": op._replays,
        "replay_std": r2.std().item()}
    masked = _Mask()
    masked.hybridize()
    try:
        masked(x, mx.nd.ones((4096,), ctx=gpu))
        out["boolean_mask_capture"] = {"ok": False, "raised": None}
    except MXNetError as e:
        out["boolean_mask_capture"] = {"ok": "boolean_mask" in str(e),
                                       "raised": str(e)[:200]}
    return out


def _word_lm(mx, dropout):
    """Zaremba et al.'s large LSTM language model (LSTM_LM) on the card,
    as a Gluon HybridBlock: Embedding, Dropout, the fused LSTM, Dropout,
    Dense over the vocabulary (untied)."""
    from mxnet_tpu_torch import gluon
    c = LSTM_LM

    class WordLM(gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="lm_")
            with self.name_scope():
                self.encoder = gluon.nn.Embedding(c["vocab"], c["emb"])
                self.drop = gluon.nn.Dropout(dropout)
                self.rnn = gluon.rnn.LSTM(c["hidden"],
                                          num_layers=c["layers"],
                                          dropout=dropout,
                                          input_size=c["emb"])
                self.decoder = gluon.nn.Dense(c["vocab"], flatten=False,
                                              in_units=c["hidden"])

        def hybrid_forward(self, F, x, h, cell):
            out, (h, cell) = self.rnn(self.drop(self.encoder(x)), [h, cell])
            return self.decoder(self.drop(out)), h, cell

    net = WordLM()
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    return net


def _lm_windows(mx, seed, count):
    """``count`` (input, target) windows [bptt, batch] of Zipf-distributed
    token ids from ``seed``, batchified as the example does (one stream cut
    into ``batch`` columns), int32 on the card."""
    import numpy as np
    c = LSTM_LM
    rng = np.random.RandomState(seed)
    p = np.arange(1, c["vocab"] + 1, dtype=np.float64) ** -c["zipf"]
    stream = rng.choice(c["vocab"], size=c["batch"] * (count * c["bptt"] + 1),
                        p=p / p.sum())
    cols = stream.reshape(c["batch"], -1).T
    return [(mx.nd.array(cols[i * c["bptt"]:(i + 1) * c["bptt"]],
                         ctx=mx.gpu(0), dtype="int32"),
             mx.nd.array(cols[i * c["bptt"] + 1:(i + 1) * c["bptt"] + 1],
                         ctx=mx.gpu(0), dtype="int32"))
            for i in range(count)]


class _LMLoop:
    """The example's training loop over one net: its Trainer, its loss and
    the carried state."""

    def __init__(self, mx, net):
        from mxnet_tpu_torch import gluon
        c = LSTM_LM
        self.mx, self.net = mx, net
        self.params = list(net.collect_params().values())
        self.trainer = gluon.Trainer(net.collect_params(), "sgd",
                                     {"learning_rate": c["lr"]})
        self.loss = gluon.loss.SoftmaxCrossEntropyLoss()
        self.state = net.rnn.begin_state(c["batch"], ctx=mx.gpu(0))

    def window(self, x, y):
        """One window; the mean loss per token."""
        mx, c = self.mx, LSTM_LM
        with mx.autograd.record():
            out, h, cell = self.net(x, *self.state)
            loss = self.loss(out.reshape((-1, c["vocab"])), y.reshape((-1,)))
        loss.backward()
        # as the example: the summed loss's gradient clipped at
        # clip·tokens, each step by the window's tokens (the mean loss's
        # gradient, clipped at clip)
        tokens = c["bptt"] * c["batch"]
        mx.gluon.utils.clip_global_norm([p.grad() for p in self.params],
                                        c["clip"] * tokens)
        self.trainer.step(tokens)
        self.state = [h.detach(), cell.detach()]
        return float(loss.mean().asscalar())


def _lm_parity(torch, mx, seed):
    """At dropout 0: LSTM_LM["parity_windows"] windows of a hybridized
    twin (its CachedOp's CUDA graphs) against the eager net from the same
    weights, deterministic algorithms on: the losses and every parameter
    bit for bit after each window."""
    import warnings
    n = LSTM_LM["parity_windows"]
    windows = _lm_windows(mx, seed + 1, n)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mx.random.seed(seed)
            eager = _LMLoop(mx, _word_lm(mx, 0.0))
            graph_net = _word_lm(mx, 0.0)
            for p, q in zip(graph_net.collect_params().values(),
                            eager.params):
                p.set_data(q.data())
            graph_net.hybridize()
            graph = _LMLoop(mx, graph_net)
            rows = []
            for x, y in windows:
                le = eager.window(x, y)
                lg = graph.window(x, y)
                same = sum(torch.equal(p._tensor(), q._tensor())
                           for p, q in zip(graph.params, eager.params))
                rows.append({"loss_eager": le, "loss_graph": lg,
                             "params_equal": same,
                             "params": len(eager.params)})
            op = graph_net._cached_op
            out = {"windows": rows, "captures": op._captures,
                   "replays": op._replays,
                   "warnings": sorted({str(w.message)[:100]
                                       for w in caught})}
        out["ok"] = (op._captures == 1 and op._replays == n - 1 and all(
            r["loss_eager"] == r["loss_graph"]
            and r["params_equal"] == r["params"] for r in rows))
        del eager, graph, graph_net
    finally:
        torch.use_deterministic_algorithms(False)
        _free(torch)
    return out


def _lm_run(torch, mx, loop, windows):
    """The windows through ``loop``: losses, ms per window after the
    first, tokens/s, peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [loop.window(*windows[0])]
    t0 = time.perf_counter()
    for x, y in windows[1:]:
        losses.append(loop.window(x, y))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (len(windows) - 1)
    tokens = LSTM_LM["bptt"] * LSTM_LM["batch"]
    return {"losses": losses, "loss_falls": losses[-1] < losses[0]
            and all(math.isfinite(v) for v in losses),
            "step_ms": 1e3 * step_s, "tokens_per_s": tokens / step_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _lm_main(torch, mx, seed):
    """The main path at dropout 0.65: the eager Gluon loop from the
    initial weights, then the same net hybridized from them again over the
    same windows; the Embedding backward's launches over both, counted
    from zero just before."""
    from mxnet_tpu_torch.ops import embedding as EMB
    windows = _lm_windows(mx, seed + 2, LSTM_LM["windows"])
    mx.random.seed(seed)
    net = _word_lm(mx, LSTM_LM["dropout"])
    start = [p.data().copy() for p in net.collect_params().values()]
    EMB.embedding_bwd_launches = 0
    eager = _lm_run(torch, mx, _LMLoop(mx, net), windows)
    eager_launches = EMB.embedding_bwd_launches
    for p, v in zip(net.collect_params().values(), start):
        p.set_data(v)
    net.hybridize()
    graph = _lm_run(torch, mx, _LMLoop(mx, net), windows)
    launches = EMB.embedding_bwd_launches
    graph.update(captures=net._cached_op._captures,
                 replays=net._cached_op._replays)
    del net, start
    _free(torch)
    return {"eager": eager, "graph": graph,
            "embedding_bwd_launches": {"eager": eager_launches,
                                       "total": launches}}, launches


def _conv_layout(torch, seed):
    """Part (c): unfused resnet50_v1 under both conv layouts: the logits
    with TF32 off, then forward and graph-step ms with TF32 off (the
    script's setting) and on (cuDNN's tensor cores, where NHWC is
    cuDNN's native layout)."""
    c = LAYOUT
    before = os.environ.get("MXNET_TPU_CONV_LAYOUT")
    net = _resnet50(torch, False, seed)
    state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    x, y = _images(torch, seed + 21, c["batch"], c["px"], TRAIN["classes"])
    first_conv = next(m for m in net.modules()
                      if type(m).__name__ == "Conv2D")
    seen = []
    hook = first_conv.register_forward_hook(
        lambda mod, args, out: seen.append(out.is_contiguous(
            memory_format=torch.channels_last)))
    runs, tf32 = {}, _tf32(torch)
    try:
        for layout in ("NCHW", "NHWC"):
            os.environ["MXNET_TPU_CONV_LAYOUT"] = layout
            run = runs[layout] = {}
            for on in (False, True):
                torch.backends.cuda.matmul.allow_tf32 = on
                torch.backends.cudnn.allow_tf32 = on
                net.load_state_dict(state)
                net.eval()
                with torch.no_grad():
                    if not on:
                        run["logits"] = net(x).float()
                        run["channels_last"] = seen[-1]
                    fwd_ms = cuda_ms(torch, lambda: net(x), c["timed"])
                net.train()
                step = _train_step(net, c["batch"])
                loss = step(x, y).item()
                step_ms = cuda_ms(torch, lambda: step(x, y), c["timed"],
                                  warmup=1)
                run["tf32_on" if on else "tf32_off"] = {
                    "forward_ms": fwd_ms, "graph_step_ms": step_ms,
                    "first_loss": loss, "captures": step._captures}
                del step
                _free(torch)
    finally:
        hook.detach()
        torch.backends.cuda.matmul.allow_tf32 = tf32["matmul"]
        torch.backends.cudnn.allow_tf32 = tf32["cudnn"]
        if before is None:
            os.environ.pop("MXNET_TPU_CONV_LAYOUT", None)
        else:
            os.environ["MXNET_TPU_CONV_LAYOUT"] = before
    ref, got = runs["NCHW"].pop("logits"), runs["NHWC"].pop("logits")
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    del net
    _free(torch)
    steps = [r[k] for r in runs.values() for k in ("tf32_off", "tf32_on")]
    return {"batch": c["batch"], "px": c["px"], "runs": runs,
            "logits_rel_err": rel, "tolerance": c["rel"],
            "ok": rel <= c["rel"] and runs["NHWC"]["channels_last"]
            and not runs["NCHW"]["channels_last"]
            and all(r["captures"] == 1 and math.isfinite(r["first_loss"])
                    for r in steps)}


def phase_ops_rnn(torch, seed):
    """Slice 21 (see above); returns the Embedding backward's launches on
    the main path (the language model, eager and through the graph)."""
    import mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    sweep = _ops_sweep(torch, mx, seed)
    bits = _repeat_bits(torch, mx, seed)
    no_copy = _rnn_no_copy(torch, mx)
    rand = _random_checks(torch, mx, seed)
    t_ops = time.perf_counter() - t0
    parity = _lm_parity(torch, mx, seed)
    lm, launches = _lm_main(torch, mx, seed)
    t_lm = time.perf_counter() - t0 - t_ops
    layout = _conv_layout(torch, seed)
    n = LSTM_LM["windows"]
    out = {"phase": "ops_rnn", "card": _card(), "tf32": _tf32(torch),
           "sweep": sweep, "same_bits": bits, "rnn_weights": no_copy,
           "random": rand, "lm_config": LSTM_LM, "lm_parity": parity,
           "lm": lm, "conv_layout": layout,
           "seconds": {"ops": t_ops, "lm": t_lm,
                       "total": time.perf_counter() - t0}}
    out["gates"] = {
        # the slice's 106 registry names that are not samplers
        "sweep_agrees": not sweep["failed"] and sweep["names"] == 106,
        "same_bits_twice": bits["backward_gather_nd"]
        and bits["gather_nd_grad"] and bits["duplicates"] > 0,
        "rnn_weights_not_copied": no_copy["cudnn_calls"] == 4
        and no_copy["one_vector"] and no_copy["buffer_returned"],
        "sampler_moments": all(v["ok"] for k, v in rand.items()
                               if k not in ("replays_fresh",
                                            "boolean_mask_capture")),
        "replays_draw_fresh": rand["replays_fresh"]["ok"],
        "boolean_mask_raises_under_capture":
            rand["boolean_mask_capture"]["ok"],
        "lm_graph_bitwise_eager": parity["ok"],
        "lm_loss_falls": lm["eager"]["loss_falls"]
        and lm["graph"]["loss_falls"],
        "lm_one_capture": lm["graph"]["captures"] == 1
        and lm["graph"]["replays"] == n - 1,
        "embedding_bwd_launched": launches >= 2 * n,
        "conv_layouts_agree": layout["ok"],
        "within_90_s": out["seconds"]["total"] <= 90.0}
    out["ok"] = all(out["gates"].values())
    emit(out)
    check(out["ok"], f"ops_rnn failed: "
          f"{[k for k, v in out['gates'].items() if not v]}")
    return launches


# ---------------------------------------------------------------------------
# Slice 22: NDArray and autograd, the rest (ndarray_rest).
#
# (a) fine_tune, the main path: an MXNet 1.x image user's fine-tune loop.
# NDREST["images"] JPEGs of 256 x 256 x 3 (quality 90, drawn from the seed
# as input_pipeline's records are) with labels in [0, 1000), listed in a
# tab-separated .lst; mx.image.ImageIter (batch 256, 3 x 224 x 224,
# shuffled) through mx.image.CreateAugmenter (random crop and mirror,
# brightness, contrast and saturation 0.4, PCA noise 0.1, INPUT's mean and
# std given as arrays): decoded on the host, augmented on the card; fused
# resnet50_v1 (fp32, hybridized, 1000 classes) through gluon.Trainer (SGD,
# lr 0.1, momentum 0.9, wd 1e-4); the loss head a user CustomOp softmax
# (forward softmax, backward p - onehot(label), need_top_grad=False, as
# MXNet's example/numpy-ops/custom_softmax.py writes it) called as
# mx.nd.Custom under record(); 2 epochs of 2 batches with reset() between,
# deterministic algorithms on, TF32 off.  Gates: the head's gradient at the
# first step's logits within NDREST["head_rel"] of its largest |value| of
# SoftmaxCrossEntropyLoss's (summed); each of the first 2 steps held
# against a twin step with that built-in loss (run after the main path,
# from the main path's weights and momenta before the step, on its batch):
# every parameter and moving statistic within NDREST["step_rel"]
# (_state_gap's measure).  One step from the same state, as
# gluon_training's pairs: a second step run on amplifies the heads'
# rounding (2.4e-7 of the head's gradient on an H100) through BatchNorm;
# chained, the two heads' runs differed by 7e-2 of a parameter after 2
# steps on the CPU at batch 16.  The Custom op's outputs and input
# gradients on the card; at least 36 fused conv-BN launches a step; a
# finite loss.  Host ms per
# ImageIter batch (synchronised) and step ms are printed.
# (b) grad_penalty: the DCGAN discriminator of MXNet's
# example/gluon/dc_gan/dcgan.py at its published width (ndf 64, 64 x 64
# RGB, batch 64), its last convolution giving one score where the
# example's gives two classes, Normal(0.02) weights from the seed, as a
# WGAN-GP critic (Gulrajani et al. 2017: lambda 10, Adam at lr 1e-4 with
# betas 0.5 and 0.9): autograd.grad(D(x_hat), x_hat, create_graph=True)
# on interpolates, lambda·(||g||_2 - 1)² added to D(fake) - D(real),
# backward, trainer.step.  The first step's penalty within
# NDREST["gp_rel"] of the port's own run on the CPU from the same weights
# and inputs.  The parameter gradients of a gradient penalty are
# ill-conditioned, so they are held against a plain float64 replica of the
# step on the CPU (torch functional): each tensor's largest gap, over its
# largest |value|, within NDREST["gp_fp64_factor"] times the CPU's own
# fp32 run's gap from that replica (on an H100 80GB HBM3 at 700 W the
# card was 5.2e-3 from float64, the CPU's fp32 run 1.15e-2).  The card's
# gap from the CPU's fp32 run is printed only.  3 steps with a finite
# loss.
# (c) sweep: every op the slice registered, on the card against the CPU
# (_on_device: forward and the gradients of a seeded weighted sum): the
# linalg names at [8, 32, 32] within NDREST["linalg_rel"] (cuSOLVER against
# LAPACK, gradients through a solve), the antialiased resize within
# NDREST["resize_rel"] (its backward adds taps with atomics on the card:
# 1.86e-5 on an H100 80GB HBM3 at 700 W), gelqf, syevd and svd by their
# invariants and sign-free heads; the image ops on a 256 x 256 image and
# an NHWC batch of 8 at fixed factors, the random flips by membership; the
# control-flow and index ops; and the three control-flow ops in one
# hybridized block, captured as a CUDA graph, against the eager call.
# (d) dlpack: what a to_dlpack_for_write capsule's consumer writes through
# torch.utils.dlpack, the NDArray holds.
# (e) notes: the host cost of the op notes that ndarray.invoke keeps under
# record() for autograd.get_symbol, with the notes and without them
# (note_op a no-op) in alternating rounds, on the LSTM LM's eager window
# (_LMLoop) and on an 8-layer MLP (width 512, batch 64) written in mx.nd
# registry ops; the notes a step takes and the host µs each, timed from
# inside.
NDREST = dict(images=512, side=256, quality=90, batch=256, px=224,
              classes=1000, epochs=2, brightness=0.4, contrast=0.4,
              saturation=0.4, pca_noise=0.1, head_rel=1e-6, step_rel=1e-4,
              linalg_rel=1e-4, resize_rel=1e-4, gp_rel=1e-3,
              gp_fp64_factor=2.0, notes_rounds=4,
              notes_mlp=dict(layers=8, width=512, batch=64),
              budget_s=90.0,
              gp=dict(ndf=64, px=64, batch=64, lam=10.0, lr=1e-4,
                      beta1=0.5, beta2=0.9, steps=3))
_HEAD_SEEN = {}


def _write_jpegs(seed, root):
    """NDREST["images"] JPEG files in ``root`` and their .lst (index,
    label, file name); returns the .lst's path."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(seed)
    side = NDREST["side"]
    lines = []
    for i in range(NDREST["images"]):
        small = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
        big = np.asarray(Image.fromarray(small).resize((side, side),
                                                       Image.BILINEAR))
        img = np.clip(big.astype(np.int16)
                      + rng.randint(-8, 9, big.shape), 0, 255)
        name = f"img{i:04d}.jpg"
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(root, name), quality=NDREST["quality"])
        label = float(rng.randint(0, NDREST["classes"]))
        lines.append(f"{i}\t{label}\t{name}\n")
    lst = os.path.join(root, "train.lst")
    with open(lst, "w") as f:
        f.writelines(lines)
    return lst


def _register_softmax(mx):
    """The user softmax head of MXNet's custom_softmax.py example."""
    if "ndrest_softmax" in mx.operator._PROPS:
        return

    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            e = (x - x.max(axis=1, keepdims=True)).exp()
            self.assign(out_data[0], req[0],
                        e / e.sum(axis=1, keepdims=True))
            _HEAD_SEEN["out_on_card"] = out_data[0]._data.is_cuda

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            p = out_data[0]
            self.assign(in_grad[0], req[0],
                        p - mx.nd.one_hot(in_data[1], p.shape[1]))
            _HEAD_SEEN["grad_on_card"] = in_grad[0]._data.is_cuda

    @mx.operator.register("ndrest_softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()


def _ndrest_resnet(torch, mx, seed):
    """Fused resnet50_v1 (fp32, 1000 classes) on the card, hybridized,
    with its SGD Trainer; weights from ``seed``."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    os.environ["MXNET_TPU_FUSE_CONV_BN"] = "1"
    mx.random.seed(seed)
    net = resnet50_v1(classes=NDREST["classes"], ctx=mx.gpu(0))
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2))
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 1e-4})
    return net, trainer


def _host_state(net, trainer):
    """The net's tensors and the optimizer's momenta, on the host."""
    moms = trainer._updaters[0].states
    return ({k: v.detach().cpu().clone() for k, v in
             net.state_dict().items()},
            {i: m.detach().cpu().clone() for i, m in moms.items()
             if m is not None})


def _load_state(torch, net, trainer, state):
    sd, moms = state
    net.load_state_dict({k: v.cuda() for k, v in sd.items()})
    with torch.no_grad():
        for i, m in trainer._updaters[0].states.items():
            if m is not None:
                m.copy_(moms[i].cuda() if i in moms else torch.zeros_like(m))


def _fine_tune(torch, mx, seed):
    """Part (a) (see above)."""
    import random
    import shutil
    import tempfile

    import numpy as np
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.ops import fused_conv_bn as FC
    n = NDREST
    tmp = tempfile.mkdtemp(prefix="ndarray_rest_")
    try:
        t0 = time.perf_counter()
        lst = _write_jpegs(seed, tmp)
        write_s = time.perf_counter() - t0
        _register_softmax(mx)
        random.seed(seed)
        augs = mx.image.CreateAugmenter(
            (3, n["px"], n["px"]), rand_crop=True, rand_mirror=True,
            brightness=n["brightness"], contrast=n["contrast"],
            saturation=n["saturation"], pca_noise=n["pca_noise"],
            mean=np.array(INPUT["mean"]), std=np.array(INPUT["std"]))
        it = mx.image.ImageIter(batch_size=n["batch"],
                                data_shape=(3, n["px"], n["px"]),
                                path_imglist=lst, path_root=tmp,
                                shuffle=True, seed=seed, aug_list=augs)
        net, trainer = _ndrest_resnet(torch, mx, seed)
        _HEAD_SEEN.clear()
        torch.cuda.synchronize()
        FC.fused_conv_bn_launches = FC.fused_conv_bn_wgmma_launches = 0
        iter_ms, step_ms, losses, kept = [], [], [], []
        logits = None
        t_run = time.perf_counter()
        for epoch in range(n["epochs"]):
            if epoch:
                it.reset()
            while True:
                t = time.perf_counter()
                try:
                    batch = it.next()
                except StopIteration:
                    break
                torch.cuda.synchronize()
                iter_ms.append(1e3 * (time.perf_counter() - t))
                data, label = batch.data[0], batch.label[0]
                pre = _host_state(net, trainer) if len(kept) < 2 else None
                t = time.perf_counter()
                with autograd.record():
                    out = net(data)
                    p = mx.nd.Custom(out, label, op_type="ndrest_softmax")
                p.backward()
                trainer.step(n["batch"])
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t))
                prob = p._data.detach().gather(1, label._data.long()[:, None])
                losses.append(-torch.log(prob.clamp_min(1e-30)).mean().item())
                if pre is not None:
                    kept.append((data._data.clone(), label._data.clone(),
                                 pre, _host_state(net, trainer)[0]))
                    if len(kept) == 1:
                        logits = out._data.detach().clone()
        run_s = time.perf_counter() - t_run
        launches = FC.fused_conv_bn_launches
        wgmma = FC.fused_conv_bn_wgmma_launches
        steps = len(step_ms)
        op = net._cached_op
        graphs = {"misses": op._misses, "captures": op._captures,
                  "replays": op._replays}
        on_card = dict(_HEAD_SEEN)
        del net, trainer, op, out, p, batch, data, label, it
        _free(torch)

        # the head's gradient at the first step's logits, against the
        # built-in loss's
        y0 = NDArray(kept[0][1])
        z1, z2 = NDArray(logits.clone()), NDArray(logits.clone())
        z1.attach_grad()
        z2.attach_grad()
        with autograd.record():
            pc = mx.nd.Custom(z1, y0, op_type="ndrest_softmax")
        pc.backward()
        with autograd.record():
            lc = gluon.loss.SoftmaxCrossEntropyLoss()(z2, y0)
        lc.backward()
        g_ref = z2.grad._data
        head_gap = ((z1.grad._data - g_ref).abs().max()
                    / g_ref.abs().max()).item()

        # the twin: each of the first 2 steps with the built-in loss, from
        # the main path's weights and momenta before it, on its batch
        twin, trainer = _ndrest_resnet(torch, mx, seed)
        sce = gluon.loss.SoftmaxCrossEntropyLoss()
        twin_gap = []
        for data, label, pre, post in kept:
            _load_state(torch, twin, trainer, pre)
            with autograd.record():
                loss = sce(twin(NDArray(data)), NDArray(label))
            loss.backward()
            trainer.step(n["batch"])
            twin_gap.append(_state_gap(_host_state(twin, trainer)[0], post))
        del twin, trainer, loss, kept, logits
        _free(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = FUSED_LAUNCHES_PER_STEP * steps
    out = {"images": n["images"], "write_jpegs_s": write_s,
           "steps": steps, "run_s": run_s,
           "imageiter_ms_per_batch": iter_ms, "step_ms": step_ms,
           "losses": losses, "head_grad_gap": head_gap,
           "twin_state_gap": twin_gap, "custom_on_card": on_card,
           "fused_conv_bn_launches": launches,
           "fused_conv_bn_wgmma_launches": wgmma, "graphs": graphs}
    out["gates"] = {
        "head_matches_softmax_ce": head_gap <= n["head_rel"],
        "twin_first_2_steps": len(twin_gap) == 2
        and all(g[0] <= n["step_rel"] for g in twin_gap),
        "custom_on_card": on_card.get("out_on_card") is True
        and on_card.get("grad_on_card") is True,
        "launches": steps == 2 * n["epochs"] and launches >= want
        and wgmma >= want,
        "loss_finite": all(math.isfinite(v) for v in losses)}
    return out, launches


def _dcgan_critic(mx, ctx, seed):
    """dcgan.py's netD (ndf from NDREST["gp"]), one score out."""
    from mxnet_tpu_torch.gluon import nn
    ndf = NDREST["gp"]["ndf"]
    net = nn.Sequential()
    with net.name_scope():
        net.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False), nn.LeakyReLU(0.2))
        for k in (2, 4, 8):
            net.add(nn.Conv2D(ndf * k, 4, 2, 1, use_bias=False),
                    nn.BatchNorm(), nn.LeakyReLU(0.2))
        net.add(nn.Conv2D(1, 4, 1, 0, use_bias=False))
    mx.random.seed(seed)
    net.initialize(mx.init.Normal(0.02), ctx=ctx)
    return net


def _gp_step(mx, net, trainer, real, fake, eps):
    """One WGAN-GP critic step; (penalty, loss, parameter gradients)."""
    from mxnet_tpu_torch import autograd
    g = NDREST["gp"]
    xhat = eps * real + (1 - eps) * fake
    xhat.attach_grad()
    with autograd.record():
        d_real, d_fake, d_hat = net(real), net(fake), net(xhat)
        (grad,) = autograd.grad(d_hat, [xhat], create_graph=True,
                                retain_graph=True)
        norm = ((grad.reshape((g["batch"], -1)) ** 2).sum(axis=1)
                + 1e-12).sqrt()
        pen = g["lam"] * ((norm - 1) ** 2).mean()
        loss = d_fake.mean() - d_real.mean() + pen
    loss.backward()
    grads = [p.grad()._data.detach().cpu().clone()
             for p in net.collect_params().values() if p.grad_req != "null"]
    trainer.step(1)
    return pen.asscalar().item(), loss.asscalar().item(), grads


def _critic_fp64(torch, params, real, fake, eps):
    """The critic's WGAN-GP step in float64 on the CPU, in plain torch
    (``params``: the critic's learnable tensors in ``collect_params``
    order): (penalty, the parameters' gradients)."""
    import torch.nn.functional as F
    g = NDREST["gp"]
    p = [t.double().requires_grad_() for t in params]

    def critic(x):
        h = F.leaky_relu(F.conv2d(x, p[0], stride=2, padding=1), 0.2)
        for i in (1, 4, 7):
            h = F.conv2d(h, p[i], stride=2, padding=1)
            m = h.mean((0, 2, 3), keepdim=True)
            v = ((h - m) ** 2).mean((0, 2, 3), keepdim=True)
            h = ((h - m) * torch.rsqrt(v + 1e-5) * p[i + 1].view(1, -1, 1, 1)
                 + p[i + 2].view(1, -1, 1, 1))
            h = F.leaky_relu(h, 0.2)
        return F.conv2d(h, p[10])

    real, fake, eps = real.double(), fake.double(), eps.double()
    xhat = (eps * real + (1 - eps) * fake).requires_grad_()
    (grad,) = torch.autograd.grad(critic(xhat).sum(), xhat, create_graph=True)
    norm = ((grad.reshape(g["batch"], -1) ** 2).sum(1) + 1e-12).sqrt()
    pen = g["lam"] * ((norm - 1) ** 2).mean()
    loss = critic(fake).mean() - critic(real).mean() + pen
    return pen.item(), list(torch.autograd.grad(loss, p))


def _grad_gap(got, ref):
    """The largest per-tensor ``max|got - ref| / max|ref|``."""
    return max(((a.double() - b.double()).abs().max()
                / b.double().abs().max().clamp_min(1e-30)).item()
               for a, b in zip(got, ref))


def _grad_penalty(torch, mx, seed):
    """Part (b) (see above)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    g = NDREST["gp"]
    gen = torch.Generator().manual_seed(seed + 7)
    shape = (g["steps"], g["batch"], 3, g["px"], g["px"])
    real = torch.rand(shape, generator=gen) * 2 - 1
    fake = torch.rand(shape, generator=gen) * 2 - 1
    eps = torch.rand(shape[:2] + (1, 1, 1), generator=gen)
    runs = {}
    for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        dev = ctx.torch_device()
        net = _dcgan_critic(mx, ctx, seed)
        net(NDArray(real[0, :1].to(dev), ctx))  # finishes deferred init
        if "card" in runs:
            net.load_state_dict({k: v.to(dev) for k, v in
                                 runs["card"]["start"].items()})
        start = {k: v.detach().cpu().clone()
                 for k, v in net.state_dict().items()}
        weights = [q.data()._data.detach().cpu().clone()
                   for q in net.collect_params().values()
                   if q.grad_req != "null"]
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": g["lr"],
                                 "beta1": g["beta1"], "beta2": g["beta2"]})
        steps = g["steps"] if where == "card" else 1
        t0 = time.perf_counter()
        rec = [_gp_step(mx, net, trainer, NDArray(real[i].to(dev), ctx),
                        NDArray(fake[i].to(dev), ctx),
                        NDArray(eps[i].to(dev), ctx)) for i in range(steps)]
        runs[where] = {
            "start": start, "rec": rec,
            "s": time.perf_counter() - t0}
        del net, trainer
    t0 = time.perf_counter()
    pen64, grads64 = _critic_fp64(torch, weights, real[0], fake[0], eps[0])
    fp64_s = time.perf_counter() - t0
    card, cpu = runs["card"]["rec"], runs["cpu"]["rec"][0]
    pen_gap = abs(card[0][0] - cpu[0]) / max(abs(cpu[0]), 1e-30)
    grad_gap = _grad_gap(card[0][2], cpu[2])
    fp64_gaps = {"card_penalty": abs(card[0][0] - pen64) / abs(pen64),
                 "card_grads": _grad_gap(card[0][2], grads64),
                 "cpu_grads": _grad_gap(cpu[2], grads64)}
    out = {"ndf": g["ndf"], "batch": g["batch"], "px": g["px"],
           "lambda": g["lam"], "penalty": [r[0] for r in card],
           "loss": [r[1] for r in card], "cpu_penalty": cpu[0],
           "penalty_gap": pen_gap, "param_grad_gap": grad_gap,
           "param_grad_gap_each": [
               _grad_gap([a], [b]) for a, b in zip(card[0][2], cpu[2])],
           "against_fp64": fp64_gaps, "card_s": runs["card"]["s"],
           "cpu_s": runs["cpu"]["s"], "fp64_s": fp64_s}
    out["gates"] = {
        "penalty_as_cpu": pen_gap <= NDREST["gp_rel"],
        "grads_as_fp64": fp64_gaps["card_grads"]
        <= NDREST["gp_fp64_factor"] * fp64_gaps["cpu_grads"],
        "loss_finite": len(card) == g["steps"]
        and all(math.isfinite(r[1]) for r in card)}
    return out


def _rest_cases(torch, seed):
    """``(names, inputs, params, grad, tol)`` of the sweep (part (c))."""
    from mxnet_tpu_torch.ops.registry import get
    gen = torch.Generator().manual_seed(seed + 22)

    def rn(*s):
        return torch.randn(*s, generator=gen)

    def names(op):
        o = get(op)
        return (o.name,) + tuple(o.aliases)

    def spd(b, k):
        m = rn(b, k, k)
        return m @ m.transpose(-1, -2) + k * torch.eye(k)

    def lower(b, k):
        return torch.tril(rn(b, k, k)) + 3 * torch.eye(k)

    lt = NDREST["linalg_rel"]
    b, k = 8, 32
    cases = [
        (names("_linalg_gemm"), [rn(b, k, k), rn(b, k, k), rn(b, k, k)],
         dict(alpha=0.5, beta=2.0, transpose_b=True), True, lt),
        (names("_linalg_gemm2"), [rn(b, k, k), rn(b, k, k)],
         dict(transpose_a=True), True, lt),
        (names("_linalg_potrf"), [spd(b, k)], {}, True, lt),
        (names("_linalg_potri"), [lower(b, k)], {}, True, lt),
        (names("_linalg_trsm"), [lower(b, k), rn(b, k, k)],
         dict(alpha=2.0), True, lt),
        (names("_linalg_trsm"), [lower(b, k), rn(b, k, k)],
         dict(rightside=True, transpose=True), True, lt),
        (names("_linalg_trmm"), [rn(b, k, k), rn(b, k, k)],
         dict(lower=False), True, lt),
        (names("_linalg_syrk"), [rn(b, k, k)], dict(transpose=True), True,
         lt),
        (names("_linalg_sumlogdiag"), [spd(b, k)], {}, True, lt),
        (names("_linalg_extractdiag"), [rn(b, k, k)], dict(offset=1), True,
         lt),
        (names("_linalg_makediag"), [rn(b, k)], dict(offset=-1), True, lt),
        (names("_linalg_extracttrian"), [rn(b, k, k)], {}, True, lt),
        (names("_linalg_maketrian"), [rn(b, k * (k + 1) // 2)], {}, True,
         lt),
        (names("_linalg_inverse"), [spd(b, k)], {}, True, lt),
        (names("_linalg_det"), [spd(b, 4) / 4], {}, True, lt),
        (names("_linalg_slogdet"), [spd(b, k)], {}, True, lt),
    ]
    img = torch.rand(256, 256, 3, generator=gen) * 255
    batch = torch.rand(8, 256, 256, 3, generator=gen) * 255
    u8 = img.to(torch.uint8)
    for x in (img, batch):
        w, h = x.shape[-2], x.shape[-3]
        cases += [
            (("_image_resize",), [x], dict(size=(224, 224)), True,
             NDREST["resize_rel"]),
            (("_image_resize",), [x], dict(size=(300, 200), interp=0),
             True, NDREST["resize_rel"]),
            (("_image_crop",), [x], dict(x0=16, y0=8, width=224,
                                         height=224), True, None),
            (("_image_random_crop",), [x], dict(width=w, height=h), True,
             None),
            (("_image_to_tensor",), [x], {}, True, None),
            (("_image_flip_left_right",), [x], {}, True, None),
            (("_image_flip_top_bottom",), [x], {}, True, None),
            (("_image_random_brightness",), [x],
             dict(min_factor=0.7, max_factor=0.7), True, None),
            (("_image_random_contrast",), [x],
             dict(min_factor=1.3, max_factor=1.3), True, None),
            (("_image_random_saturation",), [x],
             dict(min_factor=0.6, max_factor=0.6), True, None),
            (("_image_random_hue",), [x],
             dict(min_factor=0.2, max_factor=0.2), True, None),
            (("_image_random_lighting",), [x], dict(alpha_std=0.0), True,
             None),
            (("_image_swap_axis",), [x], {}, True, None)]
    cases += [
        (("_image_normalize",), [img.permute(2, 0, 1) / 255],
         dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)), True,
         None),
        (("_image_crop",), [u8], dict(x0=5, y0=9, width=200, height=120),
         False, None),
        (("_image_flip_left_right", "_image_swap_axis"), [u8], {}, False,
         None),
        (names("_contrib_index_copy"), [rn(64, 16), torch.tensor(
            [3.0, 17.0, 40.0]), rn(3, 16)], {}, True, None),
        (names("_contrib_index_array"), [rn(4, 5, 6)], dict(axes=(2, 0)),
         False, None),
        (names("_contrib_quadratic"), [rn(64, 16)], dict(a=2.0, b=-1.0,
                                                        c=0.5), True, None),
        (("_foreach",), [rn(6, 32), rn(32)],
         dict(body=lambda x, s: ([x * 2 + s[0]], [s[0] * 0.5 + x]),
              n_states=1, n_outputs=1, n_data=1), True, None),
        (("_while_loop",), [torch.zeros(1), rn(32)],
         dict(cond=lambda i, x: i.sum() < 3,
              func=lambda i, x: ([x * x], [i + 1, x * 1.5]),
              max_iterations=5), True, None),
        (("_cond",), [rn(32), rn(32)],
         dict(pred=lambda a, c: a.sum() > c.sum(),
              then_func=lambda a, c: a * c, else_func=lambda a, c: a - c),
         True, None),
        (("_cond",), [rn(32) - 10, rn(32)],
         dict(pred=lambda a, c: a.sum() > c.sum(),
              then_func=lambda a, c: a * c, else_func=lambda a, c: a - c),
         True, None),
    ]
    return cases


def _sign_free(torch, mx, seed):
    """gelqf, syevd and svd on the card: their invariants, their eigen-
    and singular values against the CPU, and the gradients of heads a
    sign flip leaves alone (the outputs squared, weighted) against the
    CPU's."""
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.ops.registry import get
    gen = torch.Generator().manual_seed(seed + 23)
    a = torch.randn(8, 32, 48, generator=gen)
    m = torch.randn(8, 32, 32, generator=gen)
    inputs = {"_linalg_gelqf": a, "_linalg_syevd": m @ m.transpose(-1, -2)
              + 32 * torch.eye(32), "svd": a}
    tol = NDREST["linalg_rel"]
    worst, bad, names = 0.0, {}, []

    def run(name, x, ctx):
        dev = ctx.torch_device()
        v = NDArray(x.to(dev, copy=True), ctx)
        v.attach_grad()
        with mx.autograd.record():
            outs = list(getattr(mx.nd, name)(v))
            head = None
            for i, o in enumerate(outs):
                w = torch.rand(o.shape, generator=torch.Generator()
                               .manual_seed(i)).to(dev)
                t = (o * o * NDArray(w, ctx)).sum()
                head = t if head is None else head + t
        head.backward()
        return [o._data.detach().cpu() for o in outs], v.grad._data.cpu()

    for op, x in inputs.items():
        for name in (get(op).name,) + tuple(get(op).aliases):
            names.append(name)
            got, g_card = run(name, x, mx.gpu(0))
            ref, g_cpu = run(name, x, mx.cpu())
            if op == "_linalg_gelqf":
                lo, q = got
                rebuilt, ortho = lo @ q, q @ q.transpose(-1, -2)
                values = None
            elif op == "_linalg_syevd":
                u, w = got
                rebuilt = u.transpose(-1, -2) @ (w[..., None] * u)
                ortho, values = u @ u.transpose(-1, -2), (w, ref[1])
            else:
                u, s, vt = got
                rebuilt = u @ (s[..., None] * vt)
                ortho, values = vt @ vt.transpose(-1, -2), (s, ref[1])
            eye = torch.eye(ortho.shape[-1]).expand(ortho.shape)
            gaps = [(rebuilt - x).abs().max() / x.abs().max(),
                    (ortho - eye).abs().max(),
                    (g_card - g_cpu).abs().max() / g_cpu.abs().max()]
            if values is not None:
                gaps.append((values[0] - values[1]).abs().max()
                            / values[1].abs().max())
            gap = max(float(v) for v in gaps)
            worst = max(worst, gap)
            if gap > tol:
                bad[name] = gap
    return names, worst, bad


def _loops_block(mx):
    """A HybridBlock class whose forward calls the three fused
    control-flow ops (made here: the port is imported inside main)."""

    class Loops(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            outs, (i, acc) = F.contrib.while_loop(
                lambda i_, a_: i_.sum() < 3,
                lambda i_, a_: (a_ * x, [i_ + 1, a_ + x]),
                [F.zeros((1,)), F.zeros_like(x)], max_iterations=5)
            scan, _ = F.contrib.foreach(
                lambda r, s: (r * 2 + s[0], [s[0] + r]), outs,
                [F.zeros_like(x)])
            pick = F.contrib.cond(lambda a: a.sum() > 0, lambda a: a * 3,
                                  lambda a: a - 1, [acc])
            return scan.sum(axis=0) + pick + i
    return Loops


def _rest_sweep(torch, mx, seed):
    """Part (c)."""
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    bad, names, worst = {}, [], 0.0
    for names_, inputs, params, grad, tol in _rest_cases(torch, seed):
        for name in names_:
            ref = _on_device(torch, mx, name, inputs, params, grad, mx.cpu())
            got = _on_device(torch, mx, name, inputs, params, grad,
                             mx.gpu(0))
            names.append(name)
            why = None if len(got) == len(ref) else "output count"
            for k, (a, b) in enumerate(zip(got, ref)):
                gap = _tensor_gap(torch, a, b, tol)
                why = why or (gap and f"tensor {k}: {gap}")
                if why is None and b.is_floating_point() and b.numel():
                    worst = max(worst, ((a.double() - b.double()).abs().max()
                                        / b.double().abs().max()
                                        .clamp_min(1e-30)).item())
            if why:
                bad[f"{name}{tuple(params.items())[:2]}"] = why
    lin_names, lin_worst, lin_bad = _sign_free(torch, mx, seed)
    names += lin_names
    bad.update(lin_bad)
    # the random flips: each output is the image or its flip
    x = NDArray(torch.rand(8, 64, 64, 3, device="cuda"), mx.gpu(0))
    flips = {True: 0, False: 0}
    for _ in range(16):
        for op, ax in (("random_flip_left_right", 2),
                       ("random_flip_top_bottom", 1)):
            y = getattr(mx.nd.image, op)(x)._data
            same = torch.equal(y, x._data)
            flipped = torch.equal(y, torch.flip(x._data, dims=(ax,)))
            if not (same or flipped):
                bad[op] = "neither the image nor its flip"
            flips[flipped] += 1
    names += ["_image_random_flip_left_right", "_image_random_flip_top_bottom"]
    # the fused control-flow ops in a captured hybridized block
    loops = _loops_block(mx)
    v = torch.randn(4096, generator=torch.Generator().manual_seed(seed))
    eager = loops()(NDArray(v.cuda(), mx.gpu(0)))._data.cpu()
    with mx.cpu():
        cpu = loops()(NDArray(v.clone(), mx.cpu()))._data
    net = loops()
    net.hybridize()
    calls = [net(NDArray(v.cuda(), mx.gpu(0)))._data.cpu() for _ in range(3)]
    op = net._cached_op
    graph = {"captures": op._captures, "replays": op._replays,
             "equal_eager": all(torch.equal(c, eager) for c in calls),
             "cpu_gap": _tensor_gap(torch, eager, cpu)}
    if not (graph["equal_eager"] and graph["captures"] == 1
            and graph["replays"] >= 2 and graph["cpu_gap"] is None):
        bad["hybridized_control_flow"] = graph
    return {"cases": len(names), "names": len(set(names)),
            "worst_rel_err": max(worst, lin_worst), "flips": flips,
            "graph": graph, "failed": bad}


def _dlpack_write(torch, mx):
    """Part (d)."""
    from torch.utils import dlpack
    x = mx.nd.ones((1024,), ctx=mx.gpu(0))
    writer = dlpack.from_dlpack(mx.nd.to_dlpack_for_write(x))
    writer.mul_(3.0)
    torch.cuda.synchronize()
    seen = float(x.asnumpy().sum())
    return {"seen": seen, "ok": seen == 3.0 * 1024
            and writer.data_ptr() == x._data.data_ptr()}


def _notes_on_off(torch, mx, run, rounds):
    """``run()`` (one synchronised recorded step, its loss returned)
    ``rounds`` times with ``autograd.note_op`` as it is and with a no-op
    in its place, in alternating order, after one warm-up; then once with
    ``note_op`` timed from inside.  Host ms per step of each mode, the
    notes a step takes and the host µs each."""
    from mxnet_tpu_torch import autograd as AG
    real = AG.note_op
    spent = [0.0, 0]

    def timed(*args):
        t = time.perf_counter()
        real(*args)
        spent[0] += time.perf_counter() - t
        spent[1] += 1

    ms = {"notes": [], "no_notes": []}
    losses = [run()]
    try:
        for r in range(rounds):
            for mode in (("notes", "no_notes") if r % 2 == 0
                         else ("no_notes", "notes")):
                AG.note_op = real if mode == "notes" else (lambda *a: None)
                t = time.perf_counter()
                losses.append(run())
                ms[mode].append(1e3 * (time.perf_counter() - t))
        AG.note_op = timed
        losses.append(run())
    finally:
        AG.note_op = real
    out = {"step_ms": ms,
           "median_ms": {k: sorted(v)[len(v) // 2] for k, v in ms.items()},
           "notes_per_step": spent[1],
           "note_us": 1e6 * spent[0] / max(spent[1], 1),
           "note_ms_per_step": 1e3 * spent[0]}
    out["note_share_of_step"] = (out["note_ms_per_step"]
                                 / out["median_ms"]["notes"])
    out["ok"] = spent[1] > 0 and all(math.isfinite(v) for v in losses)
    return out


def _note_cost(torch, mx, seed):
    """Part (e): what ``get_symbol``'s op notes cost a recorded eager
    step, on two steps: the LSTM LM's eager Gluon window (dropout as the
    main path's; its layers run torch code, so few registry ops) and an
    MLP written in ``mx.nd`` registry ops (NDREST["notes_mlp"]: every op
    dispatched through ``invoke``), each through :func:`_notes_on_off`."""
    c = NDREST
    windows = _lm_windows(mx, seed + 3, c["notes_rounds"])
    mx.random.seed(seed)
    loop = _LMLoop(mx, _word_lm(mx, LSTM_LM["dropout"]))
    k = [0]

    def lm_step():
        x, y = windows[k[0] % len(windows)]
        k[0] += 1
        return loop.window(x, y)

    lm = _notes_on_off(torch, mx, lm_step, 2 * c["notes_rounds"])
    del loop, windows
    _free(torch)

    m = c["notes_mlp"]
    ctx = mx.gpu(0)
    dev = ctx.torch_device()
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    ws = []
    for i in range(m["layers"]):
        w = mx.nd.NDArray(torch.randn(m["width"], m["width"], generator=gen,
                                      device=dev) * m["width"] ** -0.5,
                          ctx)
        b = mx.nd.zeros((m["width"],), ctx=ctx)
        w.attach_grad()
        b.attach_grad()
        ws.append((w, b))
    x = mx.nd.NDArray(torch.randn(m["batch"], m["width"], generator=gen,
                                  device=dev), ctx)
    label = mx.nd.NDArray(torch.randint(0, m["width"], (m["batch"],),
                                        generator=gen, device=dev)
                          .float(), ctx)

    def mlp_step():
        with mx.autograd.record():
            h = x
            for w, b in ws:
                h = mx.nd.relu(mx.nd.FullyConnected(
                    h, w, b, num_hidden=m["width"]))
            p = mx.nd.log_softmax(h, axis=-1)
            loss = -mx.nd.pick(p, label, axis=-1).mean()
        loss.backward()
        return float(loss.asscalar())

    mlp = _notes_on_off(torch, mx, mlp_step, 2 * c["notes_rounds"])
    del ws, x, label
    _free(torch)
    return {"lm_window": lm, "nd_mlp": dict(mlp, **m),
            "ok": lm["ok"] and mlp["ok"]}


def phase_ndarray_rest(torch, seed):
    """Slice 22 (see above); returns the fused conv-BN launches of the
    main path (the fine-tune loop)."""
    import mxnet_tpu_torch as mx
    import warnings
    t0 = time.perf_counter()
    # warn_only: an op with no deterministic version warns (listed in the
    # line) where it would raise
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fine, launches = _fine_tune(torch, mx, seed)
    finally:
        torch.use_deterministic_algorithms(False)
    fine["nondeterministic_warnings"] = sorted(
        {str(w.message)[:160] for w in caught
         if "deterministic" in str(w.message)})
    t_fine = time.perf_counter() - t0
    gp = _grad_penalty(torch, mx, seed)
    t_gp = time.perf_counter() - t0 - t_fine
    sweep = _rest_sweep(torch, mx, seed)
    t_sweep = time.perf_counter() - t0 - t_fine - t_gp
    dl = _dlpack_write(torch, mx)
    t1 = time.perf_counter()
    notes = _note_cost(torch, mx, seed)
    t_notes = time.perf_counter() - t1
    out = {"phase": "ndarray_rest", "card": _card(), "tf32": _tf32(torch),
           "deterministic_algorithms_in_fine_tune": True,
           "config": {k: v for k, v in NDREST.items()},
           "fine_tune": fine, "grad_penalty": gp, "sweep": sweep,
           "dlpack": dl, "notes": notes,
           "seconds": {"fine_tune": t_fine, "grad_penalty": t_gp,
                       "sweep": t_sweep, "notes": t_notes,
                       "total": time.perf_counter() - t0}}
    out["gates"] = {
        **{f"fine_tune_{k}": v for k, v in fine["gates"].items()},
        **{f"grad_penalty_{k}": v for k, v in gp["gates"].items()},
        # 39 linalg names, 15 image ops, 3 control-flow ops, 6 index ops
        "sweep_agrees": not sweep["failed"] and sweep["names"] == 63,
        "dlpack_write_aliases": dl["ok"],
        "notes_kept": notes["ok"],
        "within_90_s": out["seconds"]["total"] <= NDREST["budget_s"]}
    out["ok"] = all(out["gates"].values())
    emit(out)
    check(out["ok"], f"ndarray_rest failed: "
          f"{[k for k, v in out['gates'].items() if not v]}")
    return launches


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
          "flash", "kernels", "flash_timing",
          "fused",
          "fused_timing", "model_parity", "serving",
          "resnet_parity", "training", "gluon_training", "input_pipeline",
          "vision_zoo", "estimator", "optimizers", "ops_rnn",
          "ndarray_rest", "amp", "mesh", "serving_bert",
          "serving_http", "speculative", "fleet", "serving_resnet_export",
          "module_fit",
          "dist_training",
          "rtc_kernels", "rtc_ffn", "bert_flash", "bert_parity",
          "bert_training", "embedding_bwd", "resilient_training")


def main(argv=None):
    t_script = time.perf_counter()
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
    check("speculative" not in only or "serving" in only,
          "speculative reuses serving's llama_7b: run it with serving")
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
    if "flash" in only or "kernels" in only:
        phase_kernels(torch, args.seed)
    if "flash_timing" in only:
        timing, timing_fp16 = phase_flash_timing(torch, args.seed)
    if "fused" in only:
        phase_fused_kernel(torch, args.seed)
    if "fused_timing" in only:
        fused, fused_fp16 = phase_fused_timing(torch, args.seed)
    if "model_parity" in only:
        phase_model_parity(torch, args.seed)
    if "resnet_parity" in only:
        phase_resnet_parity(torch, args.seed)
    by_path = {}
    if "training" in only:
        by_path["training"] = phase_training(torch, args.seed)
    if "gluon_training" in only:
        by_path["gluon_training"] = phase_gluon_training(torch, args.seed)
    if "input_pipeline" in only:
        by_path["input_pipeline"] = phase_input_pipeline(torch, args.seed)
    if "vision_zoo" in only:
        phase_vision_zoo(torch, args.seed)
    if "estimator" in only:
        by_path = {"estimator": phase_estimator(torch, args.seed),
                   **by_path}
    opt_bert = None
    if "optimizers" in only:
        opt_fused, *opt_bert = phase_optimizers(torch, args.seed)
        by_path = {"optimizers": opt_fused, **by_path}
    ops_rnn_emb = None
    if "ops_rnn" in only:
        ops_rnn_emb = phase_ops_rnn(torch, args.seed)
    if "ndarray_rest" in only:
        by_path = {"ndarray_rest": phase_ndarray_rest(torch, args.seed),
                   **by_path}
    wgmma_paths, fp16_paths = {}, {}
    if "amp" in only:
        fp16_paths["amp"], wgmma_paths["amp"], amp_b1 = phase_amp(
            torch, args.seed)
        by_path = {"amp": amp_b1, **by_path}
    mesh_b0 = fp16_b1 = None
    if "mesh" in only:
        mesh_b0, mesh_b1, fp16_b1, mesh_flash = phase_mesh(torch, args.seed)
        by_path = {"mesh": mesh_b1, **by_path}
    if by_path and "fused_timing" in only:
        # launches: the latest slice's path that ran (fused resnet50_v1
        # under a dp = 2 mesh, under amp.init("float16"), the ImageIter
        # fine-tune loop under a CustomOp head, LARS through
        # CompiledTrainStep's graph, Estimator.fit, the input pipeline,
        # then the graph on a resident batch, then the Gluon loop)
        line = _kernel_line(
            "fused_conv_bn_stats",
            "mxnet_tpu_torch/csrc/fused_conv_bn_wgmma.cu",
            "mxnet_tpu/ops/fused_conv_bn.py:48",
            next(by_path[k] for k in ("mesh", "amp", "ndarray_rest",
                                      "optimizers",
                                      "estimator",
                                      "input_pipeline", "training",
                                      "gluon_training")
                 if k in by_path),
            fused)
        line["launches_by_path"] = by_path
        lines.append(line)
    if fp16_b1 is not None and "fused_timing" in only:
        # the fp16 route (slice 24, row 2b): every fused block of the
        # fp16-converted resnet50_v1, timed at FUSED_TIMED
        line = _kernel_line("fused_conv_bn_stats_fp16",
                            "mxnet_tpu_torch/csrc/fused_conv_bn_wgmma.cu",
                            "mxnet_tpu/ops/fused_conv_bn.py:48", fp16_b1,
                            fused_fp16)
        line["launches_by_path"] = {"mesh": fp16_b1}
        line["shape"], line["dtype"] = list(FUSED_TIMED), "float16"
        lines.append(line)
    if mesh_b0 is not None:
        # B0's fp32 route on the sequence- and expert-parallel path (slice
        # 24), timed at (a)'s shape [1, 32, 8192, 128] causal
        line = _kernel_line("flash_fwd_tf32_llama",
                            "mxnet_tpu_torch/csrc/flash_fwd_tf32.cu",
                            "mxnet_tpu/ops/attention.py:51",
                            sum(mesh_b0.values()), mesh_flash)
        line["launches_by_path"] = mesh_b0
        line["shape"], line["dtype"] = list(MESH_FLASH), "float32"
        line["causal"] = True
        lines.append(line)
    # llama_7b and BERT-base stay alive from their serving phases to the
    # HTTP phase, which serves them again
    bert_paths, llama, bert = {}, None, None
    emb_paths = {}
    if ops_rnn_emb is not None:
        emb_paths["ops_rnn"] = ops_rnn_emb
    if opt_bert is not None:
        bert_paths["optimizers"], emb_paths["optimizers"] = opt_bert
    if "serving" in only:
        wgmma_paths["serving"], llama, dense_per_forward = phase_serving(
            torch, args.seed)
    if "serving_bert" in only:
        bert_paths["serving_bert"], bert = phase_serving_bert(torch,
                                                              args.seed)
    if "serving_http" in only:
        bert_paths["serving_http"], wgmma_paths["serving_http"] = \
            phase_serving_http(torch, args.seed, llama, bert)
    if "speculative" in only:
        phase_speculative(torch, args.seed, llama, dense_per_forward)
    if "fleet" in only:
        fleet_line, fleet_gates, wgmma_paths["fleet"], bert_paths["fleet"] = \
            phase_fleet_models(torch, args.seed, bert)
    del llama, bert
    gc.collect()
    torch.cuda.empty_cache()
    if "fleet" in only:
        phase_fleet(torch, args.seed, fleet_line, fleet_gates)
    if wgmma_paths and "flash_timing" in only:
        # launches: the latest slice's path that ran (BERT-base under
        # amp.init("bfloat16") through CompiledTrainStep's graph, llama_7b's
        # dense replicas behind the fleet Router, then POST /generate on
        # one server), else slice 1's in-process serving
        line = _kernel_line(
            "flash_fwd", "mxnet_tpu_torch/csrc/flash_fwd_wgmma.cu",
            "mxnet_tpu/ops/attention.py:51",
            next(wgmma_paths[k] for k in ("amp", "fleet", "serving_http",
                                          "serving")
                 if k in wgmma_paths), timing)
        line["launches_by_path"] = wgmma_paths
        lines.insert(0, line)
    if fp16_paths and "flash_timing" in only:
        # the fp16 route (slice 23): BERT-base under amp.init("float16"),
        # timed at its attention shape
        line = _kernel_line(
            "flash_fwd_fp16", "mxnet_tpu_torch/csrc/flash_fwd_wgmma.cu",
            "mxnet_tpu/ops/attention.py:51", fp16_paths["amp"], timing_fp16)
        line["launches_by_path"] = fp16_paths
        line["shape"], line["dtype"] = list(FP16_BERT), "float16"
        lines.insert(1, line)
    if "serving_resnet_export" in only:
        phase_serving_resnet_export(torch, args.seed)
    if "module_fit" in only:
        (bert_paths["module_fit"], bert_paths["module_fit_prefetch"],
         emb_paths["module_fit_prefetch"]) = phase_module_fit(torch,
                                                              args.seed)
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
    if "embedding_bwd" in only:
        emb_timing = phase_embedding_bwd(torch, args.seed)
    if "resilient_training" in only:
        bert_paths["resilient_training"], emb_paths["resilient_training"] = \
            phase_resilient_training(torch, args.seed)
    if bert_paths and "bert_flash" in only:
        # launches: the latest slice's path that ran (BERT-base under
        # LAMB and AdamW through the graph, then the fleet, ...)
        main_path = next((bert_paths[k] for k in ("optimizers", "fleet",
                                                   "module_fit_prefetch",
                                                   "resilient_training",
                                                   "serving_http",
                                                   "bert_training",
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
    if emb_paths and "embedding_bwd" in only:
        # the port's own kernel (C12); it replaces no TPU kernel, so
        # "replaces" names the JAX package's op whose gradient it computes.
        # Timed at the shape of the latest slice's path that ran: the
        # language model's encoder, else BERT-base's word embedding
        case = "lm_encoder" if "ops_rnn" in emb_paths else "word_embed"
        line = _kernel_line("embedding_bwd",
                            "mxnet_tpu_torch/csrc/embedding_bwd.cu",
                            "mxnet_tpu/ops/nn.py:486",
                            next(emb_paths[k] for k in (
                                "ops_rnn", "optimizers",
                                "resilient_training", "module_fit_prefetch")
                                if k in emb_paths), emb_timing[case])
        line["launches_by_path"], line["case"] = emb_paths, case
        lines.append(line)
    emit({"script_seconds": time.perf_counter() - t_script,
          "phases": sorted(only)})
    emit({"kernels": lines})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
