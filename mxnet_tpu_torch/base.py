"""Base utilities of the port: the framework error, the typed environment
flags, the dtype machinery with its 64-bit width policy, and the
shape-bucket helper.

Counterpart of ``mxnet_tpu/base.py``, reduced to what this package uses.
Every runtime flag is declared once in a typed registry and read live
through ``env.<NAME>``, with the same names and defaults as the JAX
package.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict

import numpy as _np
import torch

__all__ = ["MXNetError", "ServerClosedError", "RequestCancelledError",
           "TShape", "EnvRegistry", "env", "row_bucket", "attr_truthy", "dtype_torch",
           "dtype_name", "numpy_dtype", "BFLOAT16", "narrow_source"]


class MXNetError(RuntimeError):
    """Framework-level error (name kept for API parity with MXNet)."""


class ServerClosedError(MXNetError):
    """The serving frontend shut down while this request was still queued
    or running; the request did not finish."""


class RequestCancelledError(MXNetError):
    """The request was cancelled on purpose; its KV pages were freed
    immediately.  Not transient: retrying would be wrong."""


class TShape(tuple):
    """Shape tuple where -1 (or None) marks an unknown dimension
    (``mxnet_tpu/base.py:76``; the reference's ``include/mxnet/tuple.h``
    encodes unknown dims as -1, and partial shape inference relies on
    it)."""

    def __new__(cls, dims=None):
        if dims is None:
            return super().__new__(cls, ())
        return super().__new__(cls, (int(d) if d is not None else -1
                                     for d in dims))

    @property
    def ndim_known(self) -> bool:
        return True  # a constructed shape always knows its ndim

    @property
    def is_known(self) -> bool:
        return all(d >= 0 for d in self)

    @property
    def size(self) -> int:
        if not self.is_known:
            raise MXNetError(f"shape {tuple(self)} has unknown dims")
        n = 1
        for d in self:
            n *= d
        return n

    def merge(self, other: "TShape") -> "TShape":
        """Unify two partially known shapes; raise on a conflict."""
        if len(self) != len(other):
            raise MXNetError(f"shape mismatch {tuple(self)} vs "
                             f"{tuple(other)}")
        out = []
        for a, b in zip(self, other):
            if a < 0:
                out.append(b)
            elif b < 0 or a == b:
                out.append(a)
            else:
                raise MXNetError(f"shape mismatch {tuple(self)} vs "
                                 f"{tuple(other)}")
        return TShape(out)


class EnvFlag:
    def __init__(self, name: str, default, typ: Callable, doc: str):
        self.name, self.default, self.typ, self.doc = name, default, typ, doc

    def read(self):
        raw = os.environ.get(self.name)
        if raw is None:
            return self.default
        if self.typ is bool:
            return raw not in ("0", "false", "False", "")
        return self.typ(raw)


class EnvRegistry:
    """Declare-once runtime flags; ``env.MXNET_SERVING_KV_CACHE`` etc. read
    live from ``os.environ``."""

    def __init__(self):
        self._flags: Dict[str, EnvFlag] = {}

    def declare(self, name: str, default, typ=str, doc: str = "") -> None:
        self._flags[name] = EnvFlag(name, default, typ, doc)

    def __getattr__(self, name: str):
        flags = object.__getattribute__(self, "_flags")
        if name in flags:
            return flags[name].read()
        raise AttributeError(name)

    def __contains__(self, name: str) -> bool:
        return name in self._flags

    def names(self):
        """Every declared flag name, sorted."""
        return sorted(self._flags)

    def doc(self) -> str:
        """One line per flag: its name, default and doc."""
        return "\n".join(f"{f.name} (default {f.default!r}): {f.doc}"
                         for f in self._flags.values())


env = EnvRegistry()
env.declare("MXNET_SERVING_KV_CACHE", True, bool,
            "Paged KV-cache decode for the GenerationScheduler when the "
            "model has cache_forward; 0 forces the dense no-cache engine.")
env.declare("MXNET_SERVING_PAGE_TOKENS", 16, int,
            "Tokens per KV-cache page.  Read at GenerationScheduler "
            "construction.")
env.declare("MXNET_SERVING_KV_PAGES", 0, int,
            "Physical pages in each model's KV page pool (page 0 is a "
            "reserved scratch page).  0 = auto-size: 1 + max_slots * "
            "ceil(max_length / page_tokens).")
env.declare("MXNET_SERVING_PREFIX_CACHE", True, bool,
            "Content-hash completed KV-cache pages so a later request with "
            "the same prompt prefix maps the same physical pages; 0 "
            "disables sharing.")
env.declare("MXNET_SERVING_SPEC_TOKENS", 4, int,
            "Draft tokens proposed per speculative-decoding step when a "
            "GenerationScheduler has a draft model: the draft proposes N "
            "tokens, the target verifies them in one batched forward "
            "against the same paged cache, and greedy accept/rollback "
            "keeps output token-identical to target-only greedy decode.  "
            "0 disables speculation even when a draft model is given.")
env.declare("MXNET_TPU_FAST_VARIANCE", 1, int,
            "Norm layers compute the variance one-pass as E[x^2]-E[x]^2, "
            "clamped at 0.  For activations with |mean| >> std the "
            "subtraction cancels; set 0 for the centred E[(x-mean)^2].")
env.declare("MXNET_TPU_FUSE_CONV_BN", 0, int,
            "1 = the model-zoo ResNet bottlenecks build their 1x1 conv+BN "
            "pairs as FusedConv1x1BN (the CUDA matmul with a BN-statistics "
            "epilogue, ops/fused_conv_bn.py) instead of Conv2D+BatchNorm.  "
            "Read when the block is constructed.")
env.declare("MXNET_TPU_CONV_LAYOUT", "auto", str,
            "Internal layout of 2-D convolutions: 'NHWC' runs them on "
            "channels_last tensors (cuDNN's NHWC kernels, no transposes "
            "between adjacent convolutions); 'NCHW' and 'auto' keep the "
            "contiguous layout.  The API layout stays NCHW either way.  "
            "Read at each call, so a CUDA graph keeps the layout of its "
            "capture.")
env.declare("MXNET_TPU_RECOMPILE_WARN", 16, int,
            "CachedOp cache misses after which (misses > 2x hits) a "
            "recompile-storm warning fires once per op: the signature-churn "
            "failure mode where every request pays a capture.  0 disables "
            "(mxnet_tpu/base.py:480).")


# -- the kvstore (mxnet_tpu/base.py:184, :200, :336-365)
env.declare("MXNET_UPDATE_ON_KVSTORE", True, bool,
            "gluon.Trainer runs the optimizer inside the kvstore when one "
            "is engaged (the Trainer's update_on_kvstore=None).")
env.declare("MXNET_ASYNC_SYNC_INTERVAL", 16, int,
            "dist_async: pushes per key between cross-process averaging "
            "rounds of its stored value.")
env.declare("MXNET_KVSTORE_TIMEOUT", 0.0, float,
            "Seconds a dist kvstore collective (push all-reduce, init "
            "broadcast, async average, barrier, divergence round) may block "
            "before raising RankFailureError naming the stuck collective; "
            "also the process group's timeout.  0 disables the bound (a "
            "dead peer then blocks until torch.distributed's own timeout).")
env.declare("MXNET_KVSTORE_BUCKET_KB", 4096, int,
            "Bucket capacity in KiB for a multi-key dense push: keys are "
            "concatenated into dtype-grouped flat buckets of at most this "
            "size and each bucket is reduced once (the results equal the "
            "per-key path bit for bit).  0 = one reduction per key.")
env.declare("MXNET_KVSTORE_SHARD", False, bool,
            "ZeRO-style optimizer-state sharding for dense kvstore training "
            "(kvstore/sharded.py): each fusion bucket's gradient is reduce-"
            "scattered over the dp axis, the optimizer updates only the "
            "position's 1/N shard (per-position optimizer state drops ~Nx), "
            "and updated params all-gather back, bitwise-identical to "
            "replicated training.  Trainer(optimizer_state_sharding=) and "
            "CompiledTrainStep(shard_optimizer_state=) override per "
            "instance.")
env.declare("MXNET_KVSTORE_OVERLAP", True, bool,
            "Issue a bucket's all-reduce (async) the moment it fills, while "
            "later keys are still staged; off, every bucket waits for the "
            "end-of-push flush, which issues them in priority order.")


# -- the training step (mxnet_tpu/base.py:373)
env.declare("MXNET_TPU_STEPS_PER_CALL", 1, int,
            "K for MultiStepTrainStep: training steps one call takes from a "
            "super-batch with a leading K axis.  On the card they are K "
            "replays of the step's one CUDA graph, each with its own "
            "learning rate and step count; the results equal K single "
            "steps bit for bit.")


env.declare("MXNET_SERVING_MAX_QUEUE", 256, int,
            "Admission bound on a DynamicBatcher's queue (pending requests); "
            "submissions beyond it are shed with OverloadedError.")
env.declare("MXNET_SERVING_DEADLINE_MS", 0, int,
            "Default per-request serving deadline in milliseconds; a request "
            "still queued past it fails with DeadlineExceededError instead "
            "of occupying the batch.  0 = no default deadline.")
env.declare("MXNET_SERVING_WARMUP", True, bool,
            "ModelServer.register runs the model's whole bucket ladder, and "
            "register_generation the scheduler's prefill, decode and "
            "draft/verify ladders, before they take traffic (on the card: "
            "captures each signature's CUDA graph), so no live request "
            "pays a capture.  0 = first-seen signatures capture inside "
            "live request latency.")


# -- the fleet (mxnet_tpu/base.py:421-467; fleet/)
env.declare("MXNET_FLEET_POLL_S", 2.0, float,
            "Router control-plane poll cadence in seconds: how often the "
            "fleet Router refreshes each replica's /fleet/state (health, "
            "in-flight load, prefix-page digest).  A replica that fails its "
            "poll is marked DEAD and excluded from routing until a later "
            "poll succeeds.")
env.declare("MXNET_FLEET_PREFIX_ROUTING", True, bool,
            "Prefix-cache-aware routing at the fleet Router: hash the "
            "request's prompt pages with the paged-KV chain hash and route "
            "to the replica whose advertised prefix set has the longest "
            "match, so a shared system prompt keeps landing on warm pages. "
            "0 falls back to pure least-loaded balancing.")
env.declare("MXNET_FLEET_PREFIX_DIGEST_CAP", 512, int,
            "Maximum chain hashes a replica advertises in its /fleet/state "
            "prefix digest (most recently registered win).  Bounds the "
            "control-plane payload on replicas with very large prefix "
            "caches.")
env.declare("MXNET_FLEET_REROUTES", 2, int,
            "Re-route attempts the Router makes for one request after its "
            "chosen replica dies or reports DRAINING (each attempt picks a "
            "different live replica); exhausted attempts surface 503.")
env.declare("MXNET_FLEET_DEAD_AFTER", 2, int,
            "Consecutive control-plane poll failures before the Router (or "
            "the ReplicaManager supervisor) declares a replica DEAD.  Damps "
            "flapping: one slow /fleet/state poll leaves the replica's "
            "last-known state intact; data-plane connection failures still "
            "mark it DEAD immediately (a refused request is definitive).")
env.declare("MXNET_FLEET_MIGRATE_SNAPSHOT_TOKENS", 32, int,
            "Cadence (in generated tokens) at which the Router snapshots a "
            "live streaming request's KV pages via POST /export, so a "
            "migration after replica death resumes from imported pages "
            "instead of re-running prefill over prompt + generated tokens. "
            "0 disables snapshots; migration then always re-prefills (still "
            "token-identical: greedy decode is deterministic).")
env.declare("MXNET_FLEET_HEDGE_PCTL", 99.0, float,
            "Hedged-request trigger percentile: when a streaming request's "
            "queue + first-token latency crosses this percentile of the "
            "per-model first-token distribution (observed at the Router, "
            "minimum sample count applies), a secondary request launches on "
            "the next-best replica; first token wins and the loser is "
            "cancelled (its pages free immediately).  0 disables hedging.")
env.declare("MXNET_FLEET_SUPERVISE_S", 1.0, float,
            "ReplicaManager supervisor poll cadence in seconds: how often "
            "the supervisor checks each replica process for death (or a "
            "DEGRADED /ping) and schedules crash-loop respawns with "
            "exponential backoff.  A respawned replica warms its CUDA "
            "graph family before it answers /ping and re-advertises its "
            "prefix digests before the Router sends it traffic.")


# -- the distributed job (mxnet_tpu/base.py:571-579; read by distributed.py)
env.declare("MXNET_DIST_COORDINATOR", "", str,
            "host:port of rank 0 for the multi-process process group "
            "(reference DMLC_PS_ROOT_URI; set by tools/launch.py).")
env.declare("MXNET_DIST_NUM_PROCESSES", 1, int,
            "Process count of the distributed job (reference "
            "DMLC_NUM_WORKER).")
env.declare("MXNET_DIST_PROCESS_ID", 0, int,
            "This process's rank (reference DMLC_WORKER_ID).")
env.declare("MXNET_DIST_LOCAL_RANK", 0, int,
            "Rank within the host, for device pinning in multi-process "
            "runs.")


# -- resilience (mxnet_tpu/base.py:286-307; resilience/)
env.declare("MXNET_TPU_RETRY_MAX", 3, int,
            "Attempts (including the first) for transient backend errors "
            "(UNAVAILABLE / DEADLINE_EXCEEDED / connection refused) at the "
            "compile (graph capture) and execute (replay) sites.  A CUDA "
            "error is never transient: the context is broken for good.")
env.declare("MXNET_TPU_RETRY_BACKOFF", 0.5, float,
            "Base backoff delay in seconds between backend retries "
            "(decorrelated jitter grows it toward RetryPolicy.max_delay).")
env.declare("MXNET_TPU_BREAKER_THRESHOLD", 5, int,
            "Consecutive transient backend failures that trip the circuit "
            "breaker from closed to open.")
env.declare("MXNET_TPU_BREAKER_COOLDOWN", 30.0, float,
            "Seconds an open breaker denies calls before letting a "
            "half-open probe through.")
env.declare("MXNET_TPU_DEGRADE_TO_CPU", False, bool,
            "The JAX package's opt-in fallback to the CPU platform when the "
            "backend breaker is open.  The port never falls back to the "
            "CPU: with this set, backend_call raises MXNetError instead.")
env.declare("MXNET_TPU_FAULT_PLAN", "", str,
            "JSON fault plan ({site: [kind, ...]}) armed process-wide for "
            "chaos runs and subprocess workers; see resilience/faults.py. "
            "Sites: compile/execute/allreduce/decode/http/... .")
env.declare("MXNET_TPU_ELASTIC_DIR", "", str,
            "Directory for async elastic-training checkpoints "
            "(resilience/elastic.py).  Each cadence point publishes "
            "<dir>/step-NNNNNNNN via temp-dir + integrity manifest + atomic "
            "rename, so a torn write is never loadable.  The default of "
            "AsyncCheckpointer(directory=).")
env.declare("MXNET_TPU_ELASTIC_CKPT_STEPS", 8, int,
            "Async elastic checkpoint cadence in training steps: once a "
            "full window has elapsed the train thread takes device copies "
            "of the step's state on a side stream and a worker thread "
            "writes them off the critical path.  A crash between cadence "
            "points loses at most one window of steps (a cadence point "
            "waits for a still-in-flight write instead of skipping).  0 "
            "disables cadence saves.")
env.declare("MXNET_TPU_ELASTIC_MAX_REFORMS", 2, int,
            "Mesh reformations an elastic job may perform before a rank "
            "failure becomes fatal (each reformation halves-or-less the dp "
            "world; unlimited retries would grind a disintegrating fleet "
            "to dp=1 silently).")
env.declare("MXNET_TPU_ELASTIC_MIN_DP", 1, int,
            "Smallest data-parallel world an elastic reformation may "
            "continue on; fewer survivors than this fails the job instead "
            "of limping (throughput below this is worse than a restart).")


# -- observability (mxnet_tpu/base.py:469-545; observability/)
env.declare("MXNET_TPU_FLIGHT_CAPACITY", 512, int,
            "Bounded size of the flight recorder's in-memory ring of recent "
            "spans/logs/metric snapshots (always on; one deque append per "
            "record).  Read once at recorder construction.")
env.declare("MXNET_TPU_FLIGHT_DIR", "", str,
            "Directory for crash flight-recorder JSON artifacts, written "
            "when resilience raises BackendUnavailableError or a fault site "
            "fires fatal.  '' (default) keeps the recorder in memory only.")
env.declare("MXNET_TPU_TRACE_RETAIN_PCT", 99.0, float,
            "Tail-based trace retention percentile: a completed request "
            "keeps its full span slice only when its wall time reaches this "
            "percentile of its own latency histogram (threshold = the lower "
            "edge of the quantile's bucket).  <= 0 retains every offered "
            "trace (subject to the caps).")
env.declare("MXNET_TPU_TRACE_RETAIN_CAP", 64, int,
            "Maximum retained trace slices (oldest evicted beyond it).  0 "
            "disables promotion entirely.")
env.declare("MXNET_TPU_TRACE_PENDING_CAP", 256, int,
            "Maximum in-flight traces buffering spans while their request "
            "is still running (LRU-evicted beyond it; 512 spans per "
            "trace).  0 disables span buffering and tail retention.")
env.declare("MXNET_TPU_GOODPUT_RECORDS", 128, int,
            "Recent per-step / per-request goodput attribution records each "
            "ledger keeps in memory for the /goodput route and the flight-"
            "recorder post-mortem.  Read once at ledger construction.")
env.declare("MXNET_TPU_HEALTH", False, bool,
            "Arm the health sentinel (observability/health.py): in-graph "
            "numerics watchpoints on CompiledTrainStep (per-parameter "
            "grad/param/update sums of squares and non-finite counts, "
            "computed inside the step's CUDA graph and fetched every "
            "MXNET_TPU_HEALTH_EVERY steps) and the serving decode-path "
            "non-finite logit sentinel (each decode step's logits copied "
            "to the host and swept for NaN/Inf).  Off by default: the "
            "step's graph is then exactly the watchpoint-free one and the "
            "decode path copies only the sampled rows.  "
            "CompiledTrainStep(health=...) overrides per step.")
env.declare("MXNET_TPU_HEALTH_EVERY", 16, int,
            "Watchpoint fetch cadence in training steps: the stats are "
            "outputs of every step, but the device->host fetch and the "
            "sentinel/spike evaluation run once per window (threshold-"
            "based, so a K-step call crossing a boundary fetches once).  "
            "1 = every step.")
env.declare("MXNET_TPU_HEALTH_ACTION", "log", str,
            "Response when the sentinel trips or a spike fires: 'log' "
            "(warn + count), 'dump' (write a flight-recorder post-mortem), "
            "'raise' (typed NumericsError naming the first faulting layer "
            "or the diverging rank), 'skip' (CompiledTrainStep only: "
            "restore the pre-step copy of parameters, buffers, optimizer "
            "states and counts, and drop the step; copies the step's "
            "world every call and forces the cadence to 1).  On the "
            "serving sentinel 'skip' acts as 'log'.")
env.declare("MXNET_TPU_HEALTH_WINDOW", 64, int,
            "Rolling window (observations) for the loss / grad-norm "
            "z-score spike detectors.")
env.declare("MXNET_TPU_HEALTH_ZSCORE", 6.0, float,
            "Spike threshold in standard deviations over the rolling "
            "window: value > mean + zscore*std flags an anomaly "
            "(mxnet_tpu_health_spikes_total).")
env.declare("MXNET_TPU_HEALTH_CHECKSUM_EVERY", 0, int,
            "Cross-rank divergence-checksum cadence in training steps: "
            "every window each parameter's bytes fold into a sha256 "
            "digest, compared across processes; a mismatch names the "
            "diverging rank and keys.  0 = off (a round copies every "
            "parameter to the host).")


# -- the input pipeline (io/device_prefetch.py) --
env.declare("MXNET_IO_DEVICE_QUEUE", 2, int,
            "Batches a DevicePrefetchIter stages onto the card ahead of the "
            "training loop (host assembly on a background thread, copies on "
            "a side CUDA stream from a pinned ring).  Each staged batch "
            "holds its device memory, so this bounds the input pipeline's "
            "share of the card; 2 double-buffers the copies against the "
            "step.")
env.declare("MXNET_TPU_NO_NATIVE", False, bool,
            "1 = do not build or load the native recordio reader "
            "(io/native.py); recordio reads through its Python reader.")
env.declare("MXNET_HOME", "", str,
            "Root of the local model store (gluon/model_zoo/model_store.py "
            "keeps its files under <root>/models; default: ~/.mxnet).")


def attr_truthy(v) -> bool:
    """Truth of an op attribute that survives symbol-JSON round trips,
    where attrs can arrive as repr strings (``'False'``, ``'0'``): a plain
    ``bool()`` would read ``'False'`` as true."""
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1")
    return bool(v)


def row_bucket(n: int, minimum: int = 16) -> int:
    """Next power of two >= ``n``, floor ``minimum`` (the length ladder of
    the generation scheduler)."""
    return 1 << max((int(minimum) - 1).bit_length(), (int(n) - 1).bit_length())


env.declare("MXNET_SAFE_ACCUMULATION", True, bool,
            "Accumulate reductions in fp32.")


# -- engine, profiler, kernels and start-up (mxnet_tpu/base.py:178-254,
# :554-566).  The names, defaults and the reference's meaning are the JAX
# package's; where the port has no such mechanism the doc says so.
env.declare("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice", str,
            "Engine flavor: NaiveEngine forces synchronous execution at "
            "every op.  (compat) The port runs PyTorch's eager dispatch on "
            "CUDA streams; the flag is read by nothing.")
env.declare("MXNET_EXEC_BULK_EXEC_TRAIN", True, bool,
            "Bulk-execute trace segments in training.  (compat) A step on "
            "the card is one CUDA graph (CompiledTrainStep) whatever it "
            "says.")
env.declare("MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN", 15, int,
            "Max ops per bulked segment.  (compat) Read by nothing.")
env.declare("MXNET_ENFORCE_DETERMINISM", False, bool,
            "Force deterministic kernels.  (compat) As in the JAX package "
            "it switches nothing: call "
            "torch.use_deterministic_algorithms(True) for that.")
env.declare("MXNET_KVSTORE_BIGARRAY_BOUND", 1000000, int,
            "Shard arrays larger than this.  (compat) The port's stores "
            "bucket by MXNET_KVSTORE_BUCKET_KB instead.")
env.declare("MXNET_KVSTORE_USETREE", False, bool,
            "(compat) tree reduce; torch.distributed picks the topology.")
env.declare("MXNET_PROFILER_AUTOSTART", False, bool,
            "Start profiler at import.  (compat) Read by nothing, as in "
            "the JAX package.")
env.declare("MXNET_PROFILER_MODE", 0, int,
            "Profiler mode bitmask.  (compat) Read by nothing.")
env.declare("MXNET_CPU_WORKER_NTHREADS", 1, int,
            "(compat) host worker threads for data pipeline.")
env.declare("MXNET_GPU_MEM_POOL_TYPE", "Round", str,
            "(compat) device allocator policy; PyTorch's caching allocator "
            "(PYTORCH_CUDA_ALLOC_CONF) decides on the card.")
env.declare("MXNET_FLASH_BLOCK_Q", 128, int,
            "Flash-attention Q block rows of the JAX package's Pallas "
            "kernel.  Not read by the port's CUDA kernels, whose tiles are "
            "fixed (128 query rows on the tensor cores, 64 on the CUDA "
            "cores).")
env.declare("MXNET_FLASH_BLOCK_K", 128, int,
            "Flash-attention K/V block rows of the JAX package's Pallas "
            "kernel.  Not read by the port's CUDA kernels, whose tiles are "
            "fixed (128 keys on the tensor cores, 64 on the CUDA cores).")
env.declare("MXNET_SERVING_HOST_PACK", True, bool,
            "DynamicBatcher host-side staging: pack a batch's request rows "
            "into one preallocated reusable host buffer per input (one "
            "device transfer per packed batch), and split results from one "
            "bulk device fetch per output.  The port's batcher always "
            "packs (its rung graphs read one static input buffer); the "
            "JAX package's per-request plane (0) is not ported.")
env.declare("MXNET_KERNEL_BACKEND", "auto", str,
            "Kernel dispatch of the ops with hand-written kernels "
            "(flash_attention, conv1x1_bn_stats; ops/kernels.py): 'auto' "
            "picks by the call's tensor device (CUDA kernels on the card, "
            "the plain PyTorch version on the CPU); 'cuda' forces the "
            "hand-written CUDA route (a CPU tensor raises); 'xla', 'torch' "
            "and 'interpret' mean the plain version on CPU tensors and "
            "raise MXNetError on a CUDA tensor: nothing puts the plain "
            "version on the card.")
env.declare("MXNET_TPU_PROBE_TIMEOUT", 180.0, float,
            "Seconds the JAX package's subprocess device probe may take.  "
            "No effect on the card: the port finds its device through "
            "torch.cuda and never falls back to the CPU.")
env.declare("MXNET_TPU_PROBE_RETRIES", 2, int,
            "Attempts for the JAX package's subprocess device probe.  No "
            "effect on the card.")
env.declare("MXNET_TPU_INIT_RETRIES", 3, int,
            "Attempts for the JAX package's first-touch backend init.  No "
            "effect on the card: a missing card raises at once.")
env.declare("MXNET_TPU_INIT_BACKOFF", 5.0, float,
            "Base backoff seconds between the JAX package's backend init "
            "retries.  No effect on the card.")
env.declare("MXNET_DEFAULT_DTYPE", "float32", str,
            "Default dtype for created arrays.")


# ---------------------------------------------------------------------------
# dtypes.  The JAX package names dtypes as numpy does and runs with JAX's
# x64 mode off, so a 64-bit request yields 32 bits there; the port keeps
# that width policy (``_NARROW``) so that both packages make the same
# arrays from the same source.
# ---------------------------------------------------------------------------
_DTYPE_ALIASES: Dict[Any, torch.dtype] = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    float: torch.float32, int: torch.int32, bool: torch.bool,
}
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.complex128: torch.complex64}
_INT32 = (-(2 ** 31), 2 ** 31 - 1)


def _bfloat16_numpy():
    """numpy's bfloat16 when ``ml_dtypes`` is installed (the JAX package's
    bfloat16 is that dtype), else the name."""
    try:
        import ml_dtypes
    except ImportError:
        return "bfloat16"
    return _np.dtype(ml_dtypes.bfloat16)


BFLOAT16 = _bfloat16_numpy()


def dtype_torch(dtype, narrow: bool = True):
    """A user dtype spec (name, numpy dtype or type, Python type, torch
    dtype; ``None`` stays ``None``) as a torch dtype, with 64-bit types
    narrowed to 32 bits unless ``narrow`` is False."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        dt = dtype
    elif dtype in _DTYPE_ALIASES:
        dt = _DTYPE_ALIASES[dtype]
    else:
        name = str(dtype) if str(dtype) == "bfloat16" else _np.dtype(dtype).name
        try:
            dt = _DTYPE_ALIASES[name] if name in _DTYPE_ALIASES else getattr(
                torch, name)
        except AttributeError:
            raise TypeError(f"unsupported dtype {dtype!r}") from None
    return _NARROW.get(dt, dt) if narrow else dt


def dtype_name(dtype) -> str:
    """The numpy-style name of a dtype spec (``"bfloat16"`` included)."""
    return str(dtype_torch(dtype, narrow=False)).replace("torch.", "")


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype (``BFLOAT16`` for bfloat16)."""
    if dtype == torch.bfloat16:
        return BFLOAT16
    return _np.dtype(dtype_name(dtype))


def narrow_source(a: _np.ndarray) -> _np.ndarray:
    """The 64-bit width policy of ``mxnet_tpu/ndarray/ndarray.py:618-649``
    on a numpy array: float64 becomes float32, and int64 becomes int32 when
    every value fits, else it raises (the JAX package, with x64 off, would
    otherwise truncate)."""
    if a.dtype == _np.int64:
        if a.size and (a.min() < _INT32[0] or a.max() > _INT32[1]):
            raise ValueError(
                f"int64 value out of int32 range (min {a.min()}, max "
                f"{a.max()}): arrays hold 32-bit integers, as the JAX "
                "package does with x64 disabled")
        return a.astype(_np.int32)
    if a.dtype == _np.float64:
        return a.astype(_np.float32)
    if a.dtype == _np.complex128:
        return a.astype(_np.complex64)
    return a
