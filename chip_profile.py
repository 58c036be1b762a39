#!/usr/bin/env python3
"""Where the time of the port's training steps goes, on one NVIDIA H100.

    python3 chip_profile.py [--model resnet|bert|gluon] [--seed N] [--steps N]

Run from the root of a checkout on a machine with one CUDA card (after or
instead of ``chip_smoke.py``; it builds the kernels it needs the same way).
For each of ``chip_smoke.py``'s three training runs (a) fused fp32, (b)
unfused fp32 and (c) unfused bf16 (full-width resnet50_v1, 224 px, batch
256, TF32 off) it takes 3 warm-up steps, then traces ``--steps`` steps with
``torch.profiler`` and prints one JSON line: device time per step by kernel
family (the fused kernel, cuDNN convolutions, cuBLAS matrix products,
reductions, elementwise passes, pooling, other), the device's idle share of
the traced wall time, and the ten kernels that took longest.  With
``--model bert`` it does the same for ``chip_smoke.py``'s two BERT-base
runs (seq 128, batch 64, Adam; fp32, and bf16 through
``amp.convert_block``), where the flash forward kernel is a family of its
own.  With ``--model gluon`` it traces the fused fp32 resnet50_v1 trained
through the Gluon loop of ``chip_smoke.py``'s ``gluon_training`` phase
(``record()`` -> ``backward()`` -> ``Trainer.step`` with the metric
update), then the same model through ``CompiledTrainStep``.  Since slice 13
``CompiledTrainStep`` is one CUDA graph per signature: its traced steps are
replays.  The last line names the card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

# Kernel families, first match wins, by kernel name.
FAMILIES = (
    ("fused_conv_bn", re.compile(r"mm_bn_stats")),
    ("flash_fwd", re.compile(r"flash_fwd")),
    # cuBLAS names some fp32 GEMMs sm80_xmma_gemm_*: "xmma" alone is no conv
    ("conv_cudnn", re.compile(r"conv|cudnn|implicit|fprop|dgrad|wgrad",
                              re.I)),
    ("matmul_cublas", re.compile(r"gemm|cutlass|sm90_|ampere_|cublas", re.I)),
    ("pooling", re.compile(r"pool", re.I)),
    ("reduce", re.compile(r"reduce", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled|copy|fill",
                               re.I)),
)


def family(name):
    for fam, pattern in FAMILIES:
        if pattern.search(name):
            return fam
    return "other"


def resnet_run(torch, smoke, seed, fused, dtype):
    net = smoke._resnet50(torch, fused, seed, dtype)
    step = smoke._train_step(net, smoke.TRAIN["batch"])
    x, y = smoke._images(torch, seed + 7, smoke.TRAIN["batch"],
                         smoke.TRAIN["px"], smoke.TRAIN["classes"],
                         torch.bfloat16 if dtype else None)
    return step, x, y, smoke.TRAIN["warmup"]


def bert_run(torch, smoke, seed, dtype):
    _net, step, x, y = smoke._bert_base(torch, seed, dtype or "float32")
    return step, x, y, smoke.BERT["warmup"]


def gluon_runs(torch, smoke, seed):
    """The Gluon loop, then CompiledTrainStep, on the same model."""
    import mxnet_tpu_torch as mx
    _net, _trainer, _metric, step = smoke._gluon_resnet(torch, seed)
    x, y = smoke._images(torch, seed + 7, smoke.GLUON["batch"],
                         smoke.GLUON["px"], smoke.GLUON["classes"])
    yield (lambda data, label: step(data, label).mean(), mx.nd.NDArray(x),
           mx.nd.NDArray(y), smoke.GLUON["warmup"])
    # the record entry's graph pool and the step's do not fit on the card
    # together at batch 256
    _net.hybridize(False)
    torch.cuda.empty_cache()
    yield (smoke._train_step(_net, smoke.GLUON["batch"]), x, y,
           smoke.GLUON["warmup"])


def profile_run(torch, name, dtype, steps, step, x, y, warmup):
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        step(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step(x, y)
        loss.item()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    by_family, top = {}, []
    for e in kernels:
        ms = e.self_device_time_total / 1e3 / steps
        fam = family(e.key)
        by_family[fam] = by_family.get(fam, 0.0) + ms
        top.append((ms, e.count // steps, e.key[:90]))
    busy = sum(by_family.values())
    top.sort(reverse=True)
    return {"run": name, "dtype": dtype or "float32",
            "traced_steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy * steps / wall_ms,
            "ms_per_step_by_family": dict(sorted(
                by_family.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"ms_per_step": ms, "launches_per_step": n,
                             "name": k} for ms, n, k in top[:10]],
            "kernel_events": len(kernels)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("resnet", "bert", "gluon"),
                        default="resnet")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=2)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: CUDA is not available")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke as smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.model == "resnet":
        runs = [(name, dtype, lambda f=fused, d=dtype: resnet_run(
                    torch, smoke, args.seed, f, d))
                for name, fused, dtype in (("a_fused_fp32", True, None),
                                           ("b_unfused_fp32", False, None),
                                           ("c_unfused_bf16", False,
                                            "bfloat16"))]
    elif args.model == "bert":
        runs = [(f"bert_{dtype or 'float32'}", dtype,
                 lambda d=dtype: bert_run(torch, smoke, args.seed, d))
                for dtype in (None, "bfloat16")]
    else:
        gluon = gluon_runs(torch, smoke, args.seed)
        runs = [(name, None, lambda: next(gluon))
                for name in ("gluon_trainer_fused_fp32",
                             "compiled_step_fused_fp32")]
    for name, dtype, build in runs:
        torch.cuda.empty_cache()
        step, x, y, warmup = build()
        out = profile_run(torch, name, dtype, args.steps, step, x, y, warmup)
        print(json.dumps(out), flush=True)
        del step, x, y
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
