"""The port stands alone: importing ``mxnet_tpu_torch`` (and the chip smoke
script, and the port's launchers ``tools/serve_torch.py`` and
``tools/chaos_torch.py``) loads no JAX module and nothing of the JAX
package, and no source file of the port or of those launchers imports
either.  Importing it loads no ``triton`` and no
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
import mxnet_tpu_torch.kvstore.gradient_compression, mxnet_tpu_torch._graphs
import mxnet_tpu_torch.resilience, mxnet_tpu_torch.observability
import mxnet_tpu_torch.profiler, mxnet_tpu_torch.serving.server
import mxnet_tpu_torch.checkpoint, mxnet_tpu_torch.resilience.training
import mxnet_tpu_torch.resilience.elastic
import mxnet_tpu_torch.observability.health
import mxnet_tpu_torch.io.device_prefetch, mxnet_tpu_torch.io.native
import mxnet_tpu_torch.recordio, mxnet_tpu_torch.gluon.data
import mxnet_tpu_torch.gluon.data.vision, mxnet_tpu_torch.rnn
import mxnet_tpu_torch.ops.embedding
import mxnet_tpu_torch.fleet, mxnet_tpu_torch.fleet.router
import mxnet_tpu_torch.fleet.manager
import mxnet_tpu_torch.gluon.model_zoo.vision, mxnet_tpu_torch.gluon.loss
import mxnet_tpu_torch.gluon.model_zoo.model_store
import mxnet_tpu_torch.gluon.contrib.estimator
import mxnet_tpu_torch.image, mxnet_tpu_torch.operator
import mxnet_tpu_torch.ndarray.contrib, mxnet_tpu_torch.ndarray.linalg
import mxnet_tpu_torch.ndarray.image, mxnet_tpu_torch.ndarray.utils
import mxnet_tpu_torch.ndarray._internal, mxnet_tpu_torch.symbol.contrib
import mxnet_tpu_torch.symbol.linalg, mxnet_tpu_torch.ops.linalg
import mxnet_tpu_torch.ops.control_flow, mxnet_tpu_torch.ops.image
import mxnet_tpu_torch.ops.contrib_ops
import mxnet_tpu_torch.parallel.mesh, mxnet_tpu_torch.parallel.rules
import mxnet_tpu_torch.parallel.pipeline
import mxnet_tpu_torch.parallel.ring_attention, mxnet_tpu_torch.ops.moe
import mxnet_tpu_torch.kvstore.sharded
sys.path.insert(0, "tools")
import serve_torch, chaos_torch
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
                 "mxnet_tpu_torch.kvstore.gradient_compression",
                 "mxnet_tpu_torch._graphs", "mxnet_tpu_torch.resilience",
                 "mxnet_tpu_torch.resilience.policy",
                 "mxnet_tpu_torch.resilience.faults",
                 "mxnet_tpu_torch.observability",
                 "mxnet_tpu_torch.observability.metrics",
                 "mxnet_tpu_torch.observability.tracing",
                 "mxnet_tpu_torch.observability.flight_recorder",
                 "mxnet_tpu_torch.observability.goodput",
                 "mxnet_tpu_torch.observability.memory",
                 "mxnet_tpu_torch.observability.health",
                 "mxnet_tpu_torch.profiler",
                 "mxnet_tpu_torch.serving.server",
                 "mxnet_tpu_torch.checkpoint",
                 "mxnet_tpu_torch.resilience.training",
                 "mxnet_tpu_torch.resilience.elastic",
                 "mxnet_tpu_torch.io.io", "mxnet_tpu_torch.io.device_prefetch",
                 "mxnet_tpu_torch.io.native", "mxnet_tpu_torch.recordio",
                 "mxnet_tpu_torch.gluon.data",
                 "mxnet_tpu_torch.gluon.data.dataset",
                 "mxnet_tpu_torch.gluon.data.sampler",
                 "mxnet_tpu_torch.gluon.data.dataloader",
                 "mxnet_tpu_torch.gluon.data.vision",
                 "mxnet_tpu_torch.gluon.data.vision.datasets",
                 "mxnet_tpu_torch.gluon.data.vision.transforms",
                 "mxnet_tpu_torch.rnn", "mxnet_tpu_torch.rnn.io",
                 "mxnet_tpu_torch.ops.embedding",
                 "mxnet_tpu_torch.serving.generation",
                 "mxnet_tpu_torch.serving.paged_cache",
                 "mxnet_tpu_torch.gluon.model_zoo.language.llama",
                 "mxnet_tpu_torch.fleet", "mxnet_tpu_torch.fleet.router",
                 "mxnet_tpu_torch.fleet.manager",
                 "mxnet_tpu_torch.gluon.loss",
                 "mxnet_tpu_torch.gluon.model_zoo.model_store",
                 "mxnet_tpu_torch.gluon.model_zoo.vision.mobilenet",
                 "mxnet_tpu_torch.gluon.model_zoo.vision.densenet",
                 "mxnet_tpu_torch.gluon.model_zoo.vision.inception",
                 "mxnet_tpu_torch.gluon.model_zoo.vision.vgg",
                 "mxnet_tpu_torch.gluon.model_zoo.vision.alexnet",
                 "mxnet_tpu_torch.gluon.model_zoo.vision.squeezenet",
                 "mxnet_tpu_torch.gluon.contrib.estimator.estimator",
                 "mxnet_tpu_torch.gluon.contrib.estimator.event_handler",
                 "mxnet_tpu_torch.image", "mxnet_tpu_torch.operator",
                 "mxnet_tpu_torch.ndarray.contrib",
                 "mxnet_tpu_torch.ndarray.linalg",
                 "mxnet_tpu_torch.ndarray.image",
                 "mxnet_tpu_torch.ndarray.utils",
                 "mxnet_tpu_torch.ndarray._internal",
                 "mxnet_tpu_torch.symbol.contrib",
                 "mxnet_tpu_torch.symbol.linalg",
                 "mxnet_tpu_torch.ops.linalg",
                 "mxnet_tpu_torch.ops.control_flow",
                 "mxnet_tpu_torch.ops.image",
                 "mxnet_tpu_torch.ops.contrib_ops",
                 "mxnet_tpu_torch.parallel.mesh",
                 "mxnet_tpu_torch.parallel.rules",
                 "mxnet_tpu_torch.parallel.pipeline",
                 "mxnet_tpu_torch.parallel.ring_attention",
                 "mxnet_tpu_torch.ops.moe",
                 "mxnet_tpu_torch.kvstore.sharded",
                 "serve_torch", "chaos_torch"):
        assert name in loaded
    bad = [m for m in loaded if FORBIDDEN.search(m) or m.startswith("triton")]
    assert not bad, bad
    assert proc.stdout.split("LIBS")[1].split() == ["0", "0", "0"]


def test_sources_import_no_jax_and_no_jax_package():
    files = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_flash_variants.py",
              ROOT / "tools" / "serve_torch.py",
              ROOT / "tools" / "chaos_torch.py"]
    assert len(files) > 10
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in IMPORT.finditer(f.read_text())]
    assert not hits, hits


def test_native_sources_are_the_ports_own():
    """The port builds its kernels and its recordio reader from its own
    ``csrc/``: every source there includes nothing of the JAX package, and
    no file of the port reads under the JAX package's ``src/recordio/``."""
    csrc = ROOT / "mxnet_tpu_torch" / "csrc"
    for name in ("embedding_bwd.cu", "recordio_core.cc"):
        assert (csrc / name).exists(), name
    sources = sorted(csrc.glob("*.c*"))
    includes = [f"{f.name}: {m}" for f in sources
                for m in re.findall(r'#\s*include\s+"([^"]+)"', f.read_text())
                if not (csrc / m).exists()]
    assert not includes, includes
    files = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py"))
    reads = [str(f.relative_to(ROOT)) for f in files
             if re.search(r"(?<![A-Za-z])src[/\\]recordio|[\"']src[\"']\s*,\s*[\"']recordio",
                          f.read_text())]
    assert not reads, reads
