"""Port parity: mxnet_tpu_torch.ops.attention against mxnet_tpu.ops.attention.

The same numpy inputs (seeded) go through the JAX functions, on the CPU,
and through the port's CPU path, which is the plain version of the CUDA
flash kernel.  Tolerance: float32, summed in other orders by XLA and
PyTorch; 2e-6 absolute on outputs of magnitude ~1, as the JAX package's own
attention tests use, and 1e-5 on lse (magnitude up to ~6).
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import attention as jattn
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import attention as tattn

ATOL_O = 2e-6
ATOL_LSE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool; one thread keeps
    this file from crowding the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(shape, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * scale).astype(np.float32) for _ in range(3)]


def _jax_with_lse(q, k, v, causal):
    sm = 1.0 / np.sqrt(q.shape[-1])
    o, lse = jattn._forward_with_lse(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, sm)
    return np.asarray(o), np.asarray(lse)


def _port_with_lse(q, k, v, causal):
    sm = 1.0 / np.sqrt(q.shape[-1])
    o, lse = tattn._flash_forward_plain(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), causal, sm)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_xla_path(causal):
    q, k, v = _qkv((2, 2, 96, 32), seed=0)
    jo, jl = _jax_with_lse(q, k, v, causal)
    to, tl = _port_with_lse(q, k, v, causal)
    np.testing.assert_allclose(to, jo, atol=ATOL_O)
    np.testing.assert_allclose(tl, jl, atol=ATOL_LSE)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_pallas_kernel_interpret(causal, monkeypatch):
    """The JAX side runs the Pallas flash kernel in interpret mode (blocks
    of 128 over S=256), the port side its plain version."""
    monkeypatch.setenv("MXNET_KERNEL_BACKEND", "interpret")
    q, k, v = _qkv((2, 2, 256, 64), seed=1)
    jo, jl = _jax_with_lse(q, k, v, causal)
    to, tl = _port_with_lse(q, k, v, causal)
    np.testing.assert_allclose(to, jo, atol=ATOL_O)
    np.testing.assert_allclose(tl, jl, atol=ATOL_LSE)


@pytest.mark.parametrize("seq", [64, 300])
def test_flash_attention_packed_layout(seq):
    """Packed [B, S, H*D] causal attention, including a ragged S=300 that
    the JAX dispatch sends to its dense lowering."""
    b, h, d = 2, 4, 16
    q, k, v = _qkv((b, seq, h * d), seed=2)
    ref = mx.nd.flash_attention(mx.nd.array(q), mx.nd.array(k),
                                mx.nd.array(v), num_heads=h,
                                causal=True).asnumpy()
    out = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), num_heads=h, causal=True)
    assert out.shape == (b, seq, h * d)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL_O)


def test_flash_attention_bhsd_layout_matches_reference():
    q, k, v = _qkv((1, 3, 40, 24), seed=3)
    ref = np.asarray(jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        sm_scale=0.3))
    out = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True, sm_scale=0.3)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL_O)
    port_ref = tattn.attention_reference(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(v), causal=True,
                                         sm_scale=0.3)
    np.testing.assert_allclose(port_ref.numpy(), ref, atol=ATOL_O)


@pytest.mark.parametrize("packed", [True, False])
def test_rope_matches_jax(packed):
    rng = np.random.RandomState(4)
    b, h, s, d = 2, 3, 10, 8
    shape = (b, s, h * d) if packed else (b, h, s, d)
    x = rng.randn(*shape).astype(np.float32)
    cos = rng.randn(s, d // 2).astype(np.float32)
    sin = rng.randn(s, d // 2).astype(np.float32)
    heads = h if packed else None
    ref = np.asarray(jattn.rope(jnp.asarray(x), jnp.asarray(cos),
                                jnp.asarray(sin), num_heads=heads))
    out = tattn.rope(torch.from_numpy(x), torch.from_numpy(cos),
                     torch.from_numpy(sin), num_heads=heads)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


def test_cpu_tensors_never_launch_the_kernel(monkeypatch):
    monkeypatch.setattr(tattn, "flash_fwd_launches", 0)
    monkeypatch.setattr(tattn, "flash_fwd_tf32_launches", 0)
    q, k, v = (torch.from_numpy(a) for a in _qkv((4, 32, 16), seed=5))
    out, lse = tattn.flash_fwd(q, k, v, True, 0.25)
    assert out.shape == (4, 32, 16) and lse.shape == (4, 32)
    assert lse.dtype == torch.float32
    assert tattn.flash_fwd_launches == tattn.flash_fwd_tf32_launches == 0


def test_no_fallback_on_other_devices():
    """A tensor on a device that is neither the CPU nor CUDA gets an
    error, never the plain version; a ``meta`` tensor (shapes only, for
    symbol shape inference) gets the plain version's shapes."""
    q = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(MXNetError, match="no kernel"):
        tattn.flash_fwd(q, q, q, False, 0.25)
    m = torch.empty(2, 8, 16, device="meta")
    out, lse = tattn.flash_fwd(m, m, m, False, 0.25)
    assert (out.device.type, out.shape, lse.shape) == (
        "meta", (2, 8, 16), (2, 8))


@pytest.mark.parametrize("bad", ["float16", "noncontiguous", "head_dim_256",
                                 "rank4", "k_shape"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """The CUDA wrapper validates before it builds or launches anything."""
    q = k = v = torch.zeros(2, 8, 16)
    if bad == "float16":
        q = k = v = q.half()
    elif bad == "noncontiguous":
        k = torch.zeros(2, 16, 8).transpose(1, 2)
    elif bad == "head_dim_256":
        q = k = v = torch.zeros(2, 8, 256)
    elif bad == "rank4":
        q = k = v = torch.zeros(1, 2, 8, 16)
    else:
        k = torch.zeros(3, 8, 16)
    with pytest.raises(MXNetError):
        tattn._flash_fwd_cuda(q, k, v, True, 0.25)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 16, "wgmma"), (torch.bfloat16, 40, "wgmma"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 36, "simt"), (torch.bfloat16, 100, "simt"),
    (torch.float32, 64, "tf32"), (torch.float32, 128, "tf32"),
    (torch.float32, 36, "tf32"), (torch.float32, 30, "simt")])
def test_flash_variant_by_dtype_and_head_dim(dtype, d, want):
    """Where TMA's 16-byte rows describe the rows, the tensor cores: fp32
    with D a multiple of 4 takes the three-TF32-product kernel, bf16 with D
    a multiple of 8 the bf16 one; any other D takes the CUDA-core kernel."""
    assert tattn._flash_variant(dtype, d) == want


@pytest.mark.parametrize("bad", ["wgmma_fp32", "wgmma_d36", "misaligned",
                                 "unknown", "tf32_bf16", "tf32_d30",
                                 "tf32_misaligned"])
def test_wrapper_refuses_a_variant_the_inputs_do_not_fit(bad):
    """Validated before anything is built or launched."""
    q = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
    variant = "wgmma"
    if bad == "wgmma_fp32":
        q = q.float()
    elif bad == "wgmma_d36":
        q = torch.zeros(2, 8, 36, dtype=torch.bfloat16)
    elif bad == "misaligned":
        q = torch.zeros(2 * 8 * 16 + 1, dtype=torch.bfloat16)[1:].view(
            2, 8, 16)
        variant = None
    elif bad == "unknown":
        variant = "fp8"
    elif bad == "tf32_bf16":
        variant = "tf32"
    elif bad == "tf32_d30":
        q = torch.zeros(2, 8, 30)
        variant = "tf32"
    else:
        # fp32 D = 16 would take the TF32 kernel, but q is 4 bytes off
        q = torch.zeros(2 * 8 * 16 + 1)[1:].view(2, 8, 16)
        assert tattn._flash_variant(q.dtype, 16) == "tf32"
        variant = None
    with pytest.raises(MXNetError):
        tattn._flash_fwd_cuda(q, q, q, True, 0.25, variant=variant)


# chip_smoke.py's bf16 gate: each O element within half a bf16 ulp of the
# plain version evaluated in fp32 on the same bf16 values.
BF16_O_REL = 2.0 ** -8
BF16_O_ABS = 1e-5


def _emulate_tensor_core_kernel(q, k, v, causal, sm_scale, split_p):
    """The tensor-core kernel's algorithm in torch on fp32 tensors holding
    bf16 values: 128-row query and key tiles, S = q k^T in fp32, base-2
    online softmax in fp32 with -1e30 masks, P split into bf16 hi and lo
    (or rounded to bf16 alone), O accumulated in fp32 and rounded once to
    bf16; lse = m ln 2 + log l."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale_log2 = sm_scale * 1.4426950408889634
    out = torch.empty(bh, sq, d)
    lse = torch.empty(bh, sq)
    bf = lambda x: x.bfloat16().float()
    for q0 in range(0, sq, 128):
        rows = torch.arange(q0, min(q0 + 128, sq))
        qt = q[:, rows]
        acc = torch.zeros(bh, len(rows), d)
        m = torch.full((bh, len(rows), 1), -1e30)
        l = torch.zeros(bh, len(rows), 1)
        k_end = min(sk, q0 + 128) if causal else sk
        for k0 in range(0, k_end, 128):
            cols = torch.arange(k0, min(k0 + 128, sk))
            x = torch.matmul(qt, k[:, cols].transpose(1, 2)) * scale_log2
            if causal:
                x = x.masked_fill(cols[None, :] > rows[:, None], -1e30)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            vt = v[:, cols]
            if split_p:
                hi = bf(p)
                pv = torch.matmul(hi, vt) + torch.matmul(bf(p - hi), vt)
            else:
                pv = torch.matmul(bf(p), vt)
            acc = acc * alpha + pv
            m = m_new
        out[:, rows] = bf(acc / l)
        lse[:, rows] = (m * 0.6931471805599453 + torch.log(l)).squeeze(-1)
    return out, lse


def _half_ulp_ratio(o, ref):
    return ((o - ref).abs() / (BF16_O_REL * ref.abs() + BF16_O_ABS)).max()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 300, 16), (2, 256, 64), (2, 384, 128)])
def test_split_p_keeps_the_half_ulp_gate(shape, causal):
    """P = bf16 hi + bf16 lo meets chip_smoke.py's half-ulp bound against the
    fp32 plain version, lse within 1e-4; P rounded to bf16 alone, the
    textbook tensor-core kernel, misses the same bound."""
    rng = np.random.RandomState(sum(shape) + causal)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .bfloat16().float() for _ in range(3))
    sm = 1.0 / np.sqrt(shape[-1])
    ref_o, ref_lse = tattn._flash_forward_plain(q, k, v, causal, sm)
    o, lse = _emulate_tensor_core_kernel(q, k, v, causal, sm, split_p=True)
    assert _half_ulp_ratio(o, ref_o) <= 1.0
    assert (lse - ref_lse).abs().max() <= 1e-4
    o_bf16_p, _ = _emulate_tensor_core_kernel(q, k, v, causal, sm,
                                              split_p=False)
    assert _half_ulp_ratio(o_bf16_p, ref_o) > 1.0


# ---------------------------------------------------------------------------
# The fp32 tensor-core kernel (csrc/flash_fwd_tf32.cu): its arithmetic on the
# CPU, held to chip_smoke.py's fp32 gates (1e-4 on O and on lse) against the
# plain version and the JAX package's reference.
# ---------------------------------------------------------------------------
TF32_GATE = 1e-4


def _tf32_rna(a):
    """cvt.rna.tf32.f32: the low 13 mantissa bits rounded half away from
    zero, then dropped."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(a):
    hi = _tf32_rna(a)
    return hi, _tf32_rna(a - hi)


def _add_truncated(acc, part):
    """acc + part (exact in fp64) rounded toward zero to fp32: how the
    tensor core adds into its fp32 accumulator."""
    exact = acc.double() + part
    near = exact.float()
    over = near.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(near, torch.zeros_like(near)),
                       near)


def _tc_product(a, b, products):
    """a @ b as the kernel issues it: a k8 step at a time, each step's
    three TF32 products (a_lo b_hi, a_hi b_lo, a_hi b_hi; or a_hi b_hi
    alone when products == 1) exact, added into a fresh fp32 accumulator
    one wgmma at a time with truncation."""
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    if products == 3:
        terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))
    else:
        terms = ((a_hi, b_hi),)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            acc = _add_truncated(acc, torch.matmul(
                x[..., k0:k0 + 8].double(), y[..., k0:k0 + 8, :].double()))
    return acc


def _emulate_tf32_kernel(q, k, v, causal, sm_scale, products=3):
    """The kernel's algorithm on fp32 CPU tensors [BH, S, D]: D zero-padded
    to 64 or 128, key tiles of 64 or 32 keys; S = Q K^T and each tile's P V
    through _tc_product (S accumulates over all of D, each P V starts a fresh
    accumulator); base-2 online softmax in fp32 with -1e30 masks; O =
    alpha O + PV rounded once; lse = m ln 2 + log l.  The rows are not cut
    into query tiles: a key tile is fully masked for a row that the kernel's
    causal skip keeps from it (and for every row above it, which is not run
    here), and would leave its m, l and O exactly as they are."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    dp = 64 if d <= 64 else 128
    bk = 64 if dp == 64 else 32
    pad = lambda t: torch.nn.functional.pad(t, (0, dp - d))
    q, k, v = pad(q), pad(k), pad(v)
    scale_log2 = torch.tensor(sm_scale * 1.4426950408889634,
                              dtype=torch.float32)
    rows = torch.arange(sq)[:, None]
    acc = torch.zeros(bh, sq, dp)
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros(bh, sq, 1)
    for k0 in range(0, sk, bk):
        r = slice(min(k0, sq) if causal else 0, sq)
        kt, vt = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        x = _tc_product(q[:, r], kt.transpose(1, 2), products) * scale_log2
        cols = torch.arange(k0, k0 + kt.shape[1])[None, :]
        if causal:
            x = x.masked_fill(cols > rows[r], -1e30)
        m_new = torch.maximum(m[:, r], x.amax(-1, keepdim=True))
        alpha = torch.exp2(m[:, r] - m_new)
        p = torch.exp2(x - m_new)
        l[:, r] = l[:, r] * alpha + p.sum(-1, keepdim=True)
        pv = _tc_product(p, vt, products)
        acc[:, r] = (acc[:, r].double() * alpha.double()
                     + pv.double()).float()
        m[:, r] = m_new
    out = (acc / l)[..., :d]
    lse = (m * 0.6931471805599453 + torch.log(l)).squeeze(-1)
    return out, lse


def _jax_reference(q, k, v, causal, sm_scale):
    """The JAX package on the CPU: O from attention_reference, lse from
    its XLA forward."""
    qj, kj, vj = (jnp.asarray(t.numpy()) for t in (q, k, v))
    o = jattn.attention_reference(qj[None], kj[None], vj[None], causal,
                                  sm_scale)[0]
    _, lse = jattn._forward_with_lse(qj[None], kj[None], vj[None], causal,
                                     sm_scale)
    return torch.from_numpy(np.array(o)), torch.from_numpy(
        np.array(lse)[0])


def _worst(got, refs):
    o, lse = got
    return max(max((o - ro).abs().max().item(),
                   (lse - rl).abs().max().item()) for ro, rl in refs)


@pytest.mark.parametrize("shape,causal", [
    ((4, 128, 64), False), ((4, 128, 64), True), ((2, 300, 36), False),
    ((2, 300, 36), True), ((2, 2048, 128), True)])
def test_three_tf32_products_keep_the_fp32_flash_gate(shape, causal):
    """q, k, v ~ N(0, 1) as chip_smoke.py draws them, at BERT-base's head
    (D 64, S 128), a ragged S = 300 with D = 36 (padded to 64), and
    FLASH_SHAPES' longest fp32 case (S 2048, D 128, causal, two heads):
    three TF32 products per product keep O and lse within 1e-4 of the plain
    version and of the JAX package's reference; one TF32 product, the
    textbook tensor-core kernel, misses the same gate."""
    rng = np.random.RandomState(sum(shape) + causal)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               for _ in range(3))
    sm = 1.0 / np.sqrt(shape[-1])
    refs = [tattn._flash_forward_plain(q, k, v, causal, sm),
            _jax_reference(q, k, v, causal, sm)]
    three = _worst(_emulate_tf32_kernel(q, k, v, causal, sm), refs)
    assert three <= TF32_GATE / 4, three
    one = _worst(_emulate_tf32_kernel(q, k, v, causal, sm, products=1), refs)
    assert one > TF32_GATE, one


def test_tf32_emulation_rounds_as_the_card_does():
    """rna rounds the low 13 bits half away from zero; the accumulator
    truncates toward zero."""
    ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    a = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2 ** -20,
                      -(1.0 + ulp / 2), 1.0 + ulp * 0.75])
    assert _tf32_rna(a).tolist() == [1.0, 1.0 + ulp, 1.0, -(1.0 + ulp),
                                     1.0 + ulp]
    acc = torch.tensor([1.0, -1.0])
    tiny = torch.tensor([2.0 ** -30, -(2.0 ** -30)], dtype=torch.float64)
    assert _add_truncated(acc, tiny).tolist() == [1.0, -1.0]
    assert _add_truncated(acc, -tiny).tolist() == [
        1.0 - 2.0 ** -24, -(1.0 - 2.0 ** -24)]


# ---------------------------------------------------------------------------
# The backward: _FlashFunction against jax.vjp of the JAX flash_attention,
# whose custom_vjp is the blockwise _flash_bwd.  Both sum the same fp32
# products in other orders: dq, dk and dv within 1e-5 of each one's largest
# |value| (BWD_REL).
# ---------------------------------------------------------------------------
BWD_REL = 1e-5


def _rel_close(got, ref, rel, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = rel * float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _jax_vjp(q, k, v, do, heads, causal, valid=None):
    import jax

    def f(q_, k_, v_):
        if valid is None:
            return jattn.flash_attention(q_, k_, v_, num_heads=heads,
                                         causal=causal)
        return jattn.flash_attention(q_, k_, v_, jnp.asarray(valid),
                                     num_heads=heads, causal=causal)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_vjp(q, k, v, do, heads, causal, valid=None):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    if valid is None:
        out = tattn.flash_attention(tq, tk, tv, num_heads=heads,
                                    causal=causal)
    else:
        out = tattn.flash_attention(tq, tk, tv, torch.from_numpy(valid),
                                    num_heads=heads, causal=causal)
    out.backward(torch.from_numpy(do))
    return out, [out, tq.grad, tk.grad, tv.grad]


def _layout(shape, packed):
    b, h, s, d = shape
    return (b, s, h * d) if packed else shape


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 4, 200, 16), (1, 2, 256, 64)])
def test_flash_backward_matches_jax_blockwise_vjp(shape, causal, packed):
    """S = 200 leaves a ragged second K block of 72 keys; S = 256 two full
    blocks of 128."""
    rng = np.random.RandomState(sum(shape) + 2 * causal + packed)
    q, k, v, do = (rng.randn(*_layout(shape, packed)).astype(np.float32)
                   for _ in range(4))
    heads = shape[1] if packed else None
    ref = _jax_vjp(q, k, v, do, heads, causal)
    _, got = _port_vjp(q, k, v, do, heads, causal)
    for name, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
        _rel_close(g, r, BWD_REL, name)


@pytest.mark.parametrize("causal", [False, True])
def test_masked_dense_path_matches_jax(causal):
    """key_valid_len given: the dense masked path, output and gradients,
    against the JAX package's (valid lengths 5, 32 and 17 of 32 keys)."""
    rng = np.random.RandomState(7 + causal)
    b, h, s, d = 3, 2, 32, 8
    q, k, v, do = (rng.randn(b, s, h * d).astype(np.float32)
                   for _ in range(4))
    valid = np.array([5, 32, 17], np.int32)
    ref = _jax_vjp(q, k, v, do, h, causal, valid)
    _, got = _port_vjp(q, k, v, do, h, causal, valid)
    for name, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
        _rel_close(g, r, BWD_REL, name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_has_the_function_grad_fn_on_cpu(causal):
    """q, k and v that require grad give an output whose grad_fn is the
    Function's, and its gradients equal plain autograd through
    attention_reference (the dense softmax) within BWD_REL."""
    rng = np.random.RandomState(11)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 3, 150, 32)
                                    .astype(np.float32)) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tattn.flash_attention(*leaves, causal=causal)
    assert type(out.grad_fn).__name__ == "_FlashFunctionBackward"
    out.backward(do)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.attention_reference(*plain, causal=causal).backward(do)
    for name, a, b in zip("qkv", leaves, plain):
        _rel_close(a.grad, b.grad.numpy(), BWD_REL, f"d{name}")


def test_flash_backward_returns_each_input_dtype():
    """bf16 inputs: the backward runs in fp32 and casts back to bf16, as
    the JAX package's does."""
    rng = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 40, 16).astype(np.float32))
               .bfloat16().requires_grad_() for _ in range(3))
    out = tattn.flash_attention(q, k, v, causal=True)
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16
    assert all(t.grad.dtype == torch.bfloat16 for t in (q, k, v))
