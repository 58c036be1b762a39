#!/usr/bin/env python3
"""Compare variants of a tensor-core flash kernel on one CUDA card.

    python3 chip_flash_variants.py [--kernel wgmma|tf32] [VARIANT.cu ...]

Each argument is a copy of ``mxnet_tpu_torch/csrc/flash_fwd_wgmma.cu``
(``--kernel wgmma``, the default: bf16) or of
``mxnet_tpu_torch/csrc/flash_fwd_tf32.cu`` (``--kernel tf32``: fp32) with
one change (keep copies under ``build/``, which git ignores; they find
``hopper.cuh`` in ``csrc/``).  The script builds the package's source and
every variant with the package's ``nvcc`` flags, one process each, all
started together, and prints per source the ``-Xptxas -v`` lines
(registers, spills, and C75xx notes such as "wgmma serialized").  It then
launches each through ctypes on the same inputs: it holds each at the
kernel's check shapes to chip_smoke.py's gate against the fp32 plain
version (bf16: half a bf16 ulp on O, 1e-4 on lse; fp32: 1e-4 on both), and
times each beside SDPA (and, for fp32, the CUDA-core kernel) in three turns
(in order, reversed, in order): bf16 at [4, 32, 2048, 128] causal,
[4, 32, 1024, 128] causal and [4, 32, 2048, 128] non-causal; fp32 at
BERT-base's [64, 12, 128, 64], [8, 12, 512, 64] and [4, 32, 2048, 128]
causal.  One JSON line per result; without CUDA it exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKS = [(1, 4, 130, 128, True), (2, 8, 384, 64, False),
          (4, 32, 2048, 128, True), (1, 4, 100, 40, True),
          (4, 32, 1024, 128, False)]
TIMED = [(4, 32, 2048, 128, True), (4, 32, 1024, 128, True),
         (4, 32, 2048, 128, False)]
# fp32: BERT-base's attention, ragged S and D, and the longest causal case
CHECKS_TF32 = [(64, 12, 128, 64, False), (4, 32, 2048, 128, True),
               (2, 4, 300, 16, True), (1, 4, 130, 128, False),
               (1, 4, 100, 40, True), (2, 3, 257, 96, False)]
TIMED_TF32 = [(64, 12, 128, 64, False), (8, 12, 512, 64, False),
              (4, 32, 2048, 128, True)]


def emit(obj):
    print(json.dumps(obj), flush=True)


def build(sources, out_dir, nvcc_flags, include, symbol):
    """Compile every source in parallel; a ctypes function ``symbol`` per
    source that built, and the ptxas lines of each."""
    procs = []
    for i, src in enumerate(sources):
        lib = out_dir / f"variant{i}.so"
        procs.append((src, lib, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *nvcc_flags, "-I", str(include),
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for src, lib, proc in procs:
        log, _ = proc.communicate()
        notes = [ln.strip() for ln in log.splitlines()
                 if any(k in ln for k in ("C75", "spill", "Used", "error"))]
        emit({"source": str(src), "built": proc.returncode == 0,
              "ptxas": notes})
        if proc.returncode == 0:
            fn = getattr(ctypes.CDLL(str(lib)), symbol)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[str(src)] = fn
    return fns


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("wgmma", "tf32"),
                        default="wgmma")
    parser.add_argument("variants", nargs="*", type=Path)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_flash_variants: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import BF16_O_ABS, BF16_O_REL, TOL, cuda_ms
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import attention as A
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    symbol = f"flash_fwd_{args.kernel}"
    fp32 = args.kernel == "tf32"
    dtype = torch.float32 if fp32 else torch.bfloat16
    sources = [_build.CSRC / f"{symbol}.cu", *args.variants]
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(sources, Path(tmp), _build.NVCC_FLAGS, _build.CSRC,
                    symbol)

        def run(fn, q, k, v, causal):
            bh, sq, d = q.shape
            o = torch.empty_like(q)
            lse = torch.empty(bh, sq, device="cuda")
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), bh, sq, k.shape[1], d, int(causal),
                     1.0 / math.sqrt(d),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed with error {err}")
            return o, lse

        gen = torch.Generator(device="cuda").manual_seed(0)
        for name, fn in fns.items():
            worst_o = worst_lse = 0.0
            for b, h, s, d, causal in CHECKS_TF32 if fp32 else CHECKS:
                q, k, v = (torch.randn(b * h, s, d, generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(3))
                o, lse = run(fn, q, k, v, causal)
                ro, rl = A._flash_forward_plain(q.float(), k.float(),
                                                v.float(), causal,
                                                1.0 / math.sqrt(d))
                err = (o.float() - ro).abs()
                if not fp32:  # in half bf16 ulps
                    err = err / (BF16_O_REL * ro.abs() + BF16_O_ABS)
                worst_o = max(worst_o, err.max().item())
                worst_lse = max(worst_lse, (lse - rl).abs().max().item())
            if fp32:
                emit({"source": name, "o_err": worst_o, "lse_err": worst_lse,
                      "ok": worst_o <= TOL["float32"]["o"]
                      and worst_lse <= TOL["float32"]["lse"]})
            else:
                emit({"source": name, "o_half_ulp_ratio": worst_o,
                      "lse_err": worst_lse,
                      "ok": worst_o <= 1.0 and worst_lse <= 1e-4})

        sdpa = torch.nn.functional.scaled_dot_product_attention
        for b, h, s, d, causal in TIMED_TF32 if fp32 else TIMED:
            q, k, v = (torch.randn(b * h, s, d, generator=gen, device="cuda",
                                   dtype=dtype) for _ in range(3))
            q4, k4, v4 = (t.view(b, h, s, d) for t in (q, k, v))
            calls = {name: (lambda fn=fn: run(fn, q, k, v, causal))
                     for name, fn in fns.items()}
            calls["sdpa"] = lambda: sdpa(q4, k4, v4, is_causal=causal,
                                         scale=1.0 / math.sqrt(d))
            if fp32:
                calls["simt"] = lambda: A._flash_fwd_cuda(
                    q, k, v, causal, 1.0 / math.sqrt(d), variant="simt")
            runs = {name: [] for name in calls}
            for order in (list(calls), list(calls)[::-1], list(calls)):
                for name in order:
                    runs[name].append(cuda_ms(torch, calls[name], iters=20,
                                              warmup=3))
            emit({"shape": [b, h, s, d], "causal": causal, "runs_ms": runs})


if __name__ == "__main__":
    main()
