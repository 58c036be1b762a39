"""2-bit gradient compression with an error-feedback residual
(counterpart of ``mxnet_tpu/kvstore/gradient_compression.py``; reference
``src/kvstore/gradient_compression.{h,cc}``, ``kTwoBit``).

Each element of ``residual + grad`` is quantized to -threshold, 0 or
+threshold; what the quantization dropped stays in the key's residual and
is added to its next gradient.  Sixteen 2-bit codes pack into one 32-bit
word (0 -> 0, 1 -> +threshold, 2 -> -threshold, code ``i`` at bits
``2i``).  Torch has few ``uint32`` ops, so the words are packed in int64
and kept as int32 with the same bits: ``packed.numpy().view(np.uint32)``
reads them as the JAX package's ``uint32`` words.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["GradientCompression"]

_CODES_PER_WORD = 16


def _shifts(device) -> torch.Tensor:
    return torch.arange(_CODES_PER_WORD, dtype=torch.int64, device=device) * 2


def _quantize_2bit(grad: torch.Tensor, residual: torch.Tensor,
                   threshold: float):
    """``(packed int32 [ceil(n / 16)], new residual)``."""
    t = torch.tensor(threshold, dtype=grad.dtype, device=grad.device)
    acc = residual + grad
    pos, neg = acc >= t, acc <= -t
    q = torch.where(pos, t, torch.where(neg, -t, torch.zeros_like(t)))
    codes = torch.where(pos, 1, torch.where(neg, 2, 0)).to(torch.int64)
    codes = codes.reshape(-1)
    pad = (-codes.numel()) % _CODES_PER_WORD
    codes = torch.nn.functional.pad(codes, (0, pad)).reshape(
        -1, _CODES_PER_WORD)
    words = (codes << _shifts(grad.device)).sum(1)     # disjoint bits: sum == or
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32), acc - q


def _dequantize_2bit(packed: torch.Tensor, threshold: float, n: int,
                     dtype: torch.dtype) -> torch.Tensor:
    words = packed.to(torch.int64) & 0xFFFFFFFF
    codes = ((words[:, None] >> _shifts(packed.device)) & 0x3).reshape(-1)[:n]
    t = torch.tensor(threshold, dtype=dtype, device=packed.device)
    return torch.where(codes == 1, t,
                       torch.where(codes == 2, -t, torch.zeros_like(t)))


class GradientCompression:
    """Per-key stateful compressor.  Keys are opaque: the bucketed push
    compresses each bucket's flat buffer once under the bucket's layout,
    which is elementwise the per-key trajectory while the layout holds; a
    residual whose shape no longer fits restarts at zero."""

    def __init__(self, type: str = "2bit", threshold: float = 0.5):
        if type != "2bit":
            raise ValueError(f"unsupported compression type {type!r} "
                             "(the reference has kTwoBit only)")
        self.type = type
        self.threshold = float(threshold)
        self._residuals: Dict = {}

    def get_params(self):
        return {"type": self.type, "threshold": self.threshold}

    def reset(self, key=None):
        """Drop the residuals (of one key, or all when ``key`` is None)."""
        if key is None:
            self._residuals.clear()
        else:
            self._residuals.pop(key, None)

    def compress(self, key, grad: torch.Tensor) -> Tuple[torch.Tensor, tuple]:
        res = self._residuals.get(key)
        if res is None or res.shape != grad.shape:
            res = torch.zeros_like(grad)
        packed, self._residuals[key] = _quantize_2bit(grad, res,
                                                      self.threshold)
        return packed, (tuple(grad.shape), grad.dtype)

    def decompress(self, packed: torch.Tensor, meta: tuple) -> torch.Tensor:
        shape, dtype = meta
        n = 1
        for s in shape:
            n *= int(s)
        return _dequantize_2bit(packed, self.threshold, n, dtype).reshape(shape)

    def roundtrip(self, key, grad: torch.Tensor) -> torch.Tensor:
        return self.decompress(*self.compress(key, grad))
