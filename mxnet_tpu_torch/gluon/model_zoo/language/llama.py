"""Llama-family decoder in PyTorch.

Counterpart of ``mxnet_tpu/gluon/model_zoo/language/llama.py``: the same
modules, parameter layout and numerics.  Gluon's ``Dense`` weight is
already ``[out, in]``, so each becomes ``nn.Linear(bias=False)`` with the
same weight; ``Embedding`` becomes ``nn.Embedding``.  Attention goes
through :func:`~mxnet_tpu_torch.ops.flash_attention` (the CUDA flash kernel
on the card), and the paged-KV :meth:`LlamaModel.cache_forward` attends
with plain tensor ops, as the JAX package does.  The RoPE tables are built
in numpy exactly as there, so both packages hold the same bits.

Ring/Ulysses sequence parallelism and MoE blocks wait for later slices.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from ....context import resolve_device
from ....initializer import Constant
from ....ops import flash_attention, rope

__all__ = ["RMSNorm", "LlamaAttention", "LlamaFFN", "LlamaBlock", "LlamaModel",
           "llama_tiny", "llama_7b"]

_MASK = -1e30


class RMSNorm(nn.Module):
    """Root-mean-square norm (no mean subtraction, no bias)."""

    def __init__(self, units, epsilon=1e-5, device=None, dtype=None):
        super().__init__()
        self.eps = epsilon
        self.weight = nn.Parameter(torch.ones(units, device=device,
                                              dtype=dtype))

    def forward(self, x):
        ms = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(ms + self.eps) * self.weight


class LlamaAttention(nn.Module):
    """Causal self-attention with RoPE through the flash op.

    ``num_kv_heads < num_heads`` is grouped-query attention: K/V project to
    ``num_kv_heads`` heads, each serving a contiguous group of query heads,
    and are expanded before the kernel."""

    def __init__(self, units, num_heads, num_kv_heads=None, device=None,
                 dtype=None):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} % heads {num_heads} != 0")
        self.units = units
        self.num_heads = num_heads
        self.num_kv = num_heads if num_kv_heads is None else num_kv_heads
        if self.num_kv <= 0 or num_heads % self.num_kv:
            raise ValueError(f"num_kv_heads must be a positive divisor of "
                             f"num_heads {num_heads}, got {num_kv_heads}")
        kv_units = (units // num_heads) * self.num_kv
        kw = dict(bias=False, device=device, dtype=dtype)
        self.wq = nn.Linear(units, units, **kw)
        self.wk = nn.Linear(units, kv_units, **kw)
        self.wv = nn.Linear(units, kv_units, **kw)
        self.wo = nn.Linear(units, units, **kw)

    def _expand_kv(self, t):
        """[B, S, H_kv*D] -> [B, S, H*D], each KV head repeated over its
        query group (no-op when H_kv == H)."""
        if self.num_kv == self.num_heads:
            return t
        b, s, _ = t.shape
        d = self.units // self.num_heads
        rep = self.num_heads // self.num_kv
        t = t.reshape(b, s, self.num_kv, 1, d).expand(b, s, self.num_kv, rep, d)
        return t.reshape(b, s, self.num_heads * d)

    def forward(self, x, cos, sin):
        q = rope(self.wq(x), cos, sin, num_heads=self.num_heads)
        k = rope(self.wk(x), cos, sin, num_heads=self.num_kv)
        v = self.wv(x)
        out = flash_attention(q, self._expand_kv(k), self._expand_kv(v),
                              num_heads=self.num_heads, causal=True)
        return self.wo(out)


def _rope_rotate(x, cos, sin):
    """RoPE with per-row position tables: x [B, C, H, D], cos/sin
    [B, C, D/2] gathered at each token's absolute position.  The same pair
    rotation as :func:`rope`, so cached decode reproduces the dense path."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _expand_kv_heads(t, num_heads):
    """[B, S, H_kv, D] -> [B, S, H, D] with the same head order as
    :meth:`LlamaAttention._expand_kv`."""
    b, s, hkv, d = t.shape
    if hkv == num_heads:
        return t
    rep = num_heads // hkv
    return t[:, :, :, None, :].expand(b, s, hkv, rep, d).reshape(
        b, s, num_heads, d)


class LlamaFFN(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, units, hidden, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.w1 = nn.Linear(units, hidden, **kw)
        self.w3 = nn.Linear(units, hidden, **kw)
        self.w2 = nn.Linear(hidden, units, **kw)

    def forward(self, x):
        g = self.w1(x)
        return self.w2(g * torch.sigmoid(g) * self.w3(x))


class LlamaBlock(nn.Module):
    def __init__(self, units, num_heads, hidden, num_kv_heads=None,
                 layer_norm_eps=1e-5, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn_norm = RMSNorm(units, layer_norm_eps, **kw)
        self.attn = LlamaAttention(units, num_heads, num_kv_heads, **kw)
        self.ffn_norm = RMSNorm(units, layer_norm_eps, **kw)
        self.ffn = LlamaFFN(units, hidden, **kw)

    def forward(self, x, cos, sin):
        x = x + self.attn(self.attn_norm(x), cos, sin)
        return x + self.ffn(self.ffn_norm(x))


class LlamaModel(nn.Module):
    """Decoder-only LM: tokens ``[B, S]`` -> logits ``[B, S, vocab]``
    (causal).  Built on ``device`` (default ``cuda``; raises without CUDA)
    with weights in ``dtype``; the RoPE tables stay float32.  Weights hold
    PyTorch's default values until :func:`~mxnet_tpu_torch.initializer.
    initialize` or a state dict fills them."""

    def __init__(self, vocab_size=32000, units=4096, hidden=11008,
                 num_layers=32, num_heads=32, max_length=2048,
                 tie_embeddings=True, rope_theta=10000.0, num_kv_heads=None,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.units = units
        self.tie = tie_embeddings
        self.tok_embed = nn.Embedding(vocab_size, units, **kw)
        self.layers = nn.ModuleList(
            LlamaBlock(units, num_heads, hidden, num_kv_heads, **kw)
            for _ in range(num_layers))
        self.norm = RMSNorm(units, **kw)
        if not tie_embeddings:
            self.lm_head = nn.Linear(units, vocab_size, bias=False, **kw)
        # one RoPE table pair for the whole stack, float64 inverse
        # frequencies and float32 angles as in the JAX package
        half = (units // num_heads) // 2
        inv = 1.0 / (rope_theta ** (np.arange(half) / half))
        ang = np.outer(np.arange(max_length), inv).astype(np.float32)
        for name, table in (("rope_cos", np.cos(ang)), ("rope_sin", np.sin(ang))):
            buf = torch.empty(max_length, half, dtype=torch.float32, device=dev)
            Constant(table)(buf)
            self.register_buffer(name, buf)

    @property
    def device(self) -> torch.device:
        return self.rope_cos.device

    @property
    def dtype(self) -> torch.dtype:
        return self.tok_embed.weight.dtype

    def _logits(self, x):
        x = self.norm(x)
        if self.tie:
            return torch.matmul(x, self.tok_embed.weight.t())
        return self.lm_head(x)

    def forward(self, tokens):
        s = tokens.shape[1]
        cos, sin = self.rope_cos[:s], self.rope_sin[:s]
        x = self.tok_embed(tokens)
        for blk in self.layers:
            x = blk(x, cos, sin)
        return self._logits(x)

    # ------------------------------------------------------------- KV cache
    def kv_cache_spec(self):
        """(num_layers, kv_units, max_length): the geometry the serving page
        pool sizes itself from.  K/V are cached post-RoPE at
        ``num_kv_heads`` heads."""
        attn = self.layers[0].attn
        d = self.units // attn.num_heads
        return len(self.layers), attn.num_kv * d, int(self.rope_cos.shape[0])

    def cache_forward(self, tokens, positions, cache_lens, page_table,
                      k_pool, v_pool):
        """Cache-aware chunk forward behind paged-KV serving (prefill,
        single-token decode and prefix-hit suffix prefill).

        Per batch row ``b``: ``tokens`` [B, C] — C consecutive tokens whose
        K/V are not cached yet; ``positions`` [B] — absolute position of
        ``tokens[b, 0]``; ``cache_lens`` [B] — valid cached tokens (window
        entries at or past it are masked); ``page_table`` [B, P] — physical
        page ids covering the cached prefix, padded with the scratch page 0;
        ``k_pool``/``v_pool`` [layers, pages, page_tokens, kv_units].
        All are tensors on the model's device.

        Returns ``(logits [B, C, vocab], k_new [layers, B, C, kv_units],
        v_new)``: the chunk's post-RoPE K/V, which the caller writes into
        the pools.  For real rows the window + causal mask reproduces the
        dense causal forward's support, and the softmax follows the flash
        op's plain formula (fp32 scores, -1e30 mask)."""
        b, c = tokens.shape
        dev = tokens.device
        w = int(page_table.shape[1]) * int(k_pool.shape[2])
        attn0 = self.layers[0].attn
        h, hkv = attn0.num_heads, attn0.num_kv
        d = self.units // h
        max_len = int(self.rope_cos.shape[0])
        steps = torch.arange(c, device=dev)
        pos_grid = (positions.long()[:, None] + steps[None, :]).clamp(
            0, max_len - 1)                                        # [B, C]
        cos, sin = self.rope_cos[pos_grid], self.rope_sin[pos_grid]
        win_valid = (torch.arange(w, device=dev)[None, :]
                     < cache_lens.long()[:, None])                 # [B, W]
        causal = steps[:, None] >= steps[None, :]                  # [C, C]
        valid = torch.cat([win_valid[:, None, :].expand(b, c, w),
                           causal[None].expand(b, c, c)], dim=2)[:, None]
        sm_scale = 1.0 / math.sqrt(d)
        table = page_table.long()

        x = self.tok_embed(tokens)
        k_out, v_out = [], []
        for li, blk in enumerate(self.layers):
            a = blk.attn
            xa = blk.attn_norm(x)
            q = _rope_rotate(a.wq(xa).reshape(b, c, h, d), cos, sin)
            k = _rope_rotate(a.wk(xa).reshape(b, c, hkv, d), cos, sin)
            v = a.wv(xa).reshape(b, c, hkv, d)
            k_out.append(k.reshape(b, c, hkv * d))
            v_out.append(v.reshape(b, c, hkv * d))
            # paged window gather: [B, P, T, kv] -> [B, W, hkv, d]
            kw = k_pool[li][table].reshape(b, w, hkv, d)
            vw = v_pool[li][table].reshape(b, w, hkv, d)
            keys = _expand_kv_heads(torch.cat([kw, k], dim=1), h)
            vals = _expand_kv_heads(torch.cat([vw, v], dim=1), h)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, keys, vals))
            s = torch.matmul(qt, kt.transpose(-1, -2)).float() * sm_scale
            s = s.masked_fill(~valid, _MASK)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(dim=-1, keepdim=True)
            out = torch.matmul((p / l).to(qt.dtype), vt)
            x = x + a.wo(out.transpose(1, 2).reshape(b, c, h * d))
            x = x + blk.ffn(blk.ffn_norm(x))
        return self._logits(x), torch.stack(k_out), torch.stack(v_out)


def llama_tiny(vocab_size=256, **kwargs):
    """Test-scale config (2 layers, 64 units)."""
    kw = dict(units=64, hidden=128, num_layers=2, num_heads=4, max_length=128)
    kw.update(kwargs)
    return LlamaModel(vocab_size=vocab_size, **kw)


def llama_7b(**kwargs):
    """Llama-7B geometry."""
    return LlamaModel(vocab_size=32000, units=4096, hidden=11008,
                      num_layers=32, num_heads=32, **kwargs)
