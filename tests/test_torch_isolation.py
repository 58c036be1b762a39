"""The port stands alone: importing ``mxnet_tpu_torch`` (and the chip smoke
script) loads no JAX module and nothing of the JAX package, and no source
file of the port imports either.  Importing it loads no ``triton`` and no
CUDA library (NVRTC, the driver): those load at a kernel's first use."""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^(jax|jaxlib)(\.|$)|^mxnet_tpu(\.|$)")
IMPORT = re.compile(r"^\s*(from|import)\s+(jax\w*|mxnet_tpu)(\.|\s|,|$)",
                    re.MULTILINE)

_PROBE = """
import sys
before = set(sys.modules)
import mxnet_tpu_torch, mxnet_tpu_torch.serving, chip_smoke
import mxnet_tpu_torch.ndarray, mxnet_tpu_torch.autograd, mxnet_tpu_torch.rtc
import mxnet_tpu_torch.gluon, mxnet_tpu_torch.metric, mxnet_tpu_torch.io
import mxnet_tpu_torch.lr_scheduler, mxnet_tpu_torch.symbol
import mxnet_tpu_torch.cached_op, mxnet_tpu_torch.serving.engine
import mxnet_tpu_torch.serving.batcher, mxnet_tpu_torch.error
import mxnet_tpu_torch.module, mxnet_tpu_torch.kvstore
import mxnet_tpu_torch.model, mxnet_tpu_torch.callback
import mxnet_tpu_torch.distributed, mxnet_tpu_torch.parallel.collectives
import mxnet_tpu_torch.kvstore.bucketing
import mxnet_tpu_torch.kvstore.gradient_compression
print("\\n".join(sorted(set(sys.modules) - before)))
maps = open("/proc/self/maps").read()
print("LIBS", len(mxnet_tpu_torch._cuda_driver._libs),
      int("libnvrtc" in maps), int("libcuda.so" in maps))
"""


def test_import_loads_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    for name in ("mxnet_tpu_torch", "torch", "mxnet_tpu_torch.ndarray",
                 "mxnet_tpu_torch.autograd", "mxnet_tpu_torch.rtc",
                 "mxnet_tpu_torch.gluon", "mxnet_tpu_torch.metric",
                 "mxnet_tpu_torch.io", "mxnet_tpu_torch.lr_scheduler",
                 "mxnet_tpu_torch.symbol", "mxnet_tpu_torch.symbol.symbol",
                 "mxnet_tpu_torch.cached_op",
                 "mxnet_tpu_torch.serving.engine",
                 "mxnet_tpu_torch.serving.batcher",
                 "mxnet_tpu_torch.module", "mxnet_tpu_torch.module.module",
                 "mxnet_tpu_torch.module.base_module",
                 "mxnet_tpu_torch.module.bucketing_module",
                 "mxnet_tpu_torch.kvstore", "mxnet_tpu_torch.kvstore.base",
                 "mxnet_tpu_torch.model", "mxnet_tpu_torch.callback",
                 "mxnet_tpu_torch.distributed",
                 "mxnet_tpu_torch.parallel.collectives",
                 "mxnet_tpu_torch.kvstore.bucketing",
                 "mxnet_tpu_torch.kvstore.gradient_compression"):
        assert name in loaded
    bad = [m for m in loaded if FORBIDDEN.search(m) or m.startswith("triton")]
    assert not bad, bad
    assert proc.stdout.split("LIBS")[1].split() == ["0", "0", "0"]


def test_sources_import_no_jax_and_no_jax_package():
    files = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_flash_variants.py"]
    assert len(files) > 10
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in IMPORT.finditer(f.read_text())]
    assert not hits, hits
