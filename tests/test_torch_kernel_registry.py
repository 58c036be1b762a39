"""Port parity: the kernel registry (``mxnet_tpu_torch.ops.kernels``)
against ``mxnet_tpu.ops.kernels``, on CPU tensors.

The JAX package's registry cases (``tests/test_attention.py:165-183``) run
in both packages: a user kernel registered for ``flash_attention`` at
priority 99 claims the call and gives its output, and
``MXNET_KERNEL_BACKEND=xla`` bypasses every registered kernel.  Then the
port's own rules: the platform is the call's tensor device, the CUDA
routes are registered at priority 10 and claim only ``"cuda"`` calls, a
predicate selects the calls a user kernel takes, and every backend value
on CPU tensors (``auto``, ``xla``, ``torch``, ``interpret`` the plain
version; ``cuda`` refused) and on a ``"cuda"`` call (the plain backends
refused: no plain version on the card).  Outputs agree within 2e-6 of the
JAX package's (fp32, summed in other orders).
"""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.ops import kernels as jkernels

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import fused_conv_bn as tfused
from mxnet_tpu_torch.ops import kernels as tkernels

ATOL = 2e-6


@contextlib.contextmanager
def _registered(kernels, op, name, impl, **kw):
    """``impl`` registered for ``op`` while the block runs, removed
    after."""
    kernels.register_kernel(op, name=name, **kw)(impl)
    try:
        yield
    finally:
        kernels._KERNELS[op] = [e for e in kernels._KERNELS[op]
                                if e.name != name]


def _qkv(shape=(1, 2, 32, 8), seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * 0.3).astype(dtype) for _ in range(3)]


def test_kernel_registry_injection_matches_jax():
    """A probe at priority 99 claims flash_attention in both packages; the
    probe's output (the reference attention) is the op's output."""
    q, k, v = _qkv()
    calls = {"jax": [], "port": []}

    def jprobe(q, k, v, causal, sm_scale, **kw):
        calls["jax"].append(1)
        return jattn.attention_reference(q, k, v, causal, sm_scale), None

    def tprobe(q, k, v, causal, sm_scale, **kw):
        calls["port"].append(1)
        return tattn.attention_reference(q, k, v, causal, sm_scale), None

    with _registered(jkernels, "flash_attention", "probe", jprobe,
                     platform="any", priority=99), \
            _registered(tkernels, "flash_attention", "probe", tprobe,
                        platform="any", priority=99):
        assert tkernels.list_kernels()["flash_attention"][0] == "probe"
        ref = jmx.nd.flash_attention(*(jmx.nd.array(a) for a in (q, k, v)))
        out = tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert calls["jax"] and calls["port"] == calls["jax"]
    np.testing.assert_allclose(out.numpy(), ref.asnumpy(), atol=ATOL)
    assert "probe" not in tkernels.list_kernels()["flash_attention"]


def test_forcing_xla_bypasses_every_kernel_in_both(monkeypatch):
    monkeypatch.setenv("MXNET_KERNEL_BACKEND", "xla")
    assert jkernels.lookup_kernel("flash_attention") is None
    assert tkernels.lookup_kernel("flash_attention", platform="cpu") is None


def test_port_kernels_are_registered_at_priority_10_for_cuda():
    names = tkernels.list_kernels()
    assert names["flash_attention"][-1] == "cuda_flash_fwd"
    assert names["conv1x1_bn_stats"][-1] == "cuda_mm_bn_stats"
    for op in ("flash_attention", "conv1x1_bn_stats"):
        entry = tkernels._KERNELS[op][-1]
        assert (entry.priority, entry.platform) == (10, "cuda")
        # no registered kernel claims a CPU call: the op's plain version
        assert tkernels.lookup_kernel(op, platform="cpu") is None
    assert tkernels.lookup_kernel("flash_attention",
                                  platform="cuda") is tattn._cuda_impl
    assert tkernels.lookup_kernel("conv1x1_bn_stats",
                                  platform="cuda") is tfused._fused_cuda


def test_current_platform_is_the_tensor_device():
    assert tkernels.current_platform(torch.zeros(1)) == "cpu"
    assert tkernels.current_platform(torch.empty(1, device="meta")) == "meta"
    prev = tmx.set_default_context(tmx.cpu())
    try:
        assert tkernels.current_platform() == "cpu"
    finally:
        tmx.set_default_context(prev)
    with tmx.gpu(0):
        assert tkernels.current_platform() == "cuda"


@pytest.mark.parametrize("backend", ["auto", "xla", "torch", "interpret"])
def test_backends_on_cpu_tensors_run_the_plain_version(backend, monkeypatch):
    """Each value runs the plain version on CPU tensors: the op equals the
    JAX package's reference lowering (its ``xla`` backend)."""
    monkeypatch.setenv("MXNET_KERNEL_BACKEND", backend)
    q, k, v = _qkv(seed=1)
    out = tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=True)
    monkeypatch.setenv("MXNET_KERNEL_BACKEND", "xla")
    ref = jmx.nd.flash_attention(*(jmx.nd.array(a) for a in (q, k, v)),
                                 causal=True)
    np.testing.assert_allclose(out.numpy(), ref.asnumpy(), atol=ATOL)


@pytest.mark.parametrize("backend", ["xla", "torch", "interpret"])
def test_plain_backends_refuse_a_cuda_call(backend, monkeypatch):
    """No switch puts the plain version on the card."""
    monkeypatch.setenv("MXNET_KERNEL_BACKEND", backend)
    for op in ("flash_attention", "conv1x1_bn_stats"):
        with pytest.raises(MXNetError):
            tkernels.lookup_kernel(op, platform="cuda")


def test_cuda_backend_forces_the_cuda_route(monkeypatch):
    """``cuda`` keeps only the ``"cuda"`` entries (a user kernel on "any"
    does not claim) and refuses a CPU call."""
    monkeypatch.setenv("MXNET_KERNEL_BACKEND", "cuda")
    with _registered(tkernels, "flash_attention", "anywhere",
                     lambda *a, **k: None, platform="any", priority=50):
        assert tkernels.lookup_kernel("flash_attention",
                                      platform="cuda") is tattn._cuda_impl
    q = torch.zeros(1, 1, 8, 8)
    with pytest.raises(MXNetError):
        tattn.flash_attention(q, q, q)
    with pytest.raises(MXNetError):
        tfused.fused_matmul_bn_stats(torch.zeros(4, 8), torch.zeros(8, 2))


def test_unknown_backend_raises(monkeypatch):
    monkeypatch.setenv("MXNET_KERNEL_BACKEND", "pallas_maybe")
    with pytest.raises(MXNetError):
        tkernels.lookup_kernel("flash_attention", platform="cpu")


def test_predicate_selects_the_calls_a_user_kernel_takes():
    """A float16-only kernel claims the fp16 call and not the fp32 one,
    which runs the plain version; both agree with the JAX package."""
    seen = []

    def half_only(q, k, v, causal, sm_scale, **kw):
        seen.append(q.dtype)
        return tattn._flash_forward_plain(q, k, v, causal, sm_scale)

    with _registered(tkernels, "flash_attention", "half_only", half_only,
                     platform="cpu", priority=99,
                     predicate=lambda dtype, **kw: dtype == "float16"):
        for dtype in (np.float32, np.float16):
            q, k, v = _qkv(seed=2, dtype=dtype)
            out = tattn.flash_attention(*(torch.from_numpy(a)
                                          for a in (q, k, v)))
            ref = jmx.nd.flash_attention(*(jmx.nd.array(a)
                                           for a in (q, k, v))).asnumpy()
            atol = ATOL if dtype == np.float32 else \
                2.0 ** -8 * np.abs(ref.astype(np.float32)).max()
            np.testing.assert_allclose(out.float().numpy(),
                                       ref.astype(np.float32), atol=atol)
    assert seen == [torch.float16]


def test_meta_tensors_take_the_plain_shapes():
    """Shape inference on ``meta`` tensors never reaches a kernel."""
    def boom(*a, **k):
        raise AssertionError("a kernel ran on meta tensors")

    with _registered(tkernels, "flash_attention", "boom", boom,
                     platform="any", priority=99):
        m = torch.empty(1, 2, 16, 8, device="meta")
        out = tattn.flash_attention(m, m, m)
    assert out.device.type == "meta" and out.shape == (1, 2, 16, 8)


def test_user_kernel_without_lse_refuses_the_backward():
    """A kernel that gives no lse serves the forward; the backward, which
    needs lse, raises."""
    def no_lse(q, k, v, causal, sm_scale, **kw):
        return tattn.attention_reference(q, k, v, causal, sm_scale), None

    with _registered(tkernels, "flash_attention", "no_lse", no_lse,
                     platform="any", priority=99):
        q = torch.randn(1, 1, 8, 4, requires_grad=True)
        out = tattn.flash_attention(q, q, q)
        with pytest.raises(MXNetError):
            out.sum().backward()


def test_conv1x1_bn_stats_through_the_registry_matches_jax():
    """The fused op's function: a user kernel claims it on the CPU, and
    without one the plain version equals the JAX package's reference."""
    from mxnet_tpu.ops import fused_conv_bn as jfused
    rng = np.random.RandomState(3)
    x = rng.randn(16, 8).astype(np.float32)
    w = rng.randn(8, 4).astype(np.float32)
    ref = jfused._reference_conv1x1(jnp.asarray(x), jnp.asarray(w), None,
                                    None, False)
    got = tfused.fused_matmul_bn_stats(torch.from_numpy(x),
                                       torch.from_numpy(w))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
    calls = []

    def probe(x, w, in_scale, in_shift, relu_in, **kw):
        calls.append(kw.get("platform"))
        return tfused._reference_conv1x1(x, w, in_scale, in_shift, relu_in)

    with _registered(tkernels, "conv1x1_bn_stats", "probe", probe,
                     platform="cpu", priority=99):
        tfused.fused_matmul_bn_stats(torch.from_numpy(x),
                                     torch.from_numpy(w))
    assert len(calls) == 1
