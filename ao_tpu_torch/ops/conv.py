"""Convolutions over plain or quantized weights.

PyTorch port of ``conv2d`` and ``conv_transpose2d`` of ``ao_tpu/ops/conv.py``.
The layout is the reference's: NHWC activations, HWIO weights. A
``QuantizedArray`` weight is dequantized to the activation's dtype first,
then ``torch.nn.functional.conv2d`` does the work, as XLA's convolution does
it in the reference. ``conv3d`` and ``quantize_conv_weight`` come with the
intx slice of the port (``quantize_conv_weight`` builds ``IntxArray``s).

``conv_transpose2d`` is ``jax.lax.conv_transpose`` with HWIO weights and no
``transpose_kernel``: a convolution over the input dilated by the stride,
with the kernel as it is (not flipped) and padding from JAX's rule. That is
not ``torch.nn.functional.conv_transpose2d``'s convention (the gradient of
a convolution: the kernel flipped, its in and out channels swapped), so the
port builds the dilated convolution itself.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ao_tpu_torch.quantization.qarrays.base import QuantizedArray

Padding = Union[str, Sequence[Tuple[int, int]]]


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: output ceil(size / s), the
    extra row (if any) at the end."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _weight(w, x: torch.Tensor) -> torch.Tensor:
    if isinstance(w, QuantizedArray):
        w = w.dequantize(x.dtype)
    return w.to(x.dtype)


def _conv_nhwc(x, w, stride, pads) -> torch.Tensor:
    """NHWC x, HWIO w, explicit (lo, hi) pads per spatial dim."""
    (ph0, ph1), (pw0, pw1) = pads
    xc = F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d(x: torch.Tensor, w, stride: Union[int, Tuple[int, int]] = 1,
           padding: Padding = "SAME", bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, H, W, C_in); w (KH, KW, C_in, C_out) plain or QuantizedArray."""
    w = _weight(w, x)
    stride = _pair(stride)
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        pads = (_same_pads(x.shape[1], kh, stride[0]), _same_pads(x.shape[2], kw, stride[1]))
    elif padding == "VALID":
        pads = ((0, 0), (0, 0))
    else:
        pads = tuple(tuple(p) for p in padding)
    y = _conv_nhwc(x, w, stride, pads)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _transpose_pads(k: int, s: int, padding: str) -> Tuple[int, int]:
    """jax.lax's padding of a transposed convolution (``_conv_transpose_padding``)."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"padding must be SAME, VALID or explicit pairs, got {padding!r}")
    return pad_a, pad_len - pad_a


def conv_transpose2d(x: torch.Tensor, w, stride: Union[int, Tuple[int, int]] = 2,
                     padding: Padding = "SAME",
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transposed conv (upsampling), ``jax.lax.conv_transpose``'s convention;
    x (N, H, W, C_in), w (KH, KW, C_in, C_out)."""
    w = _weight(w, x)
    sh, sw = _pair(stride)
    n, h, wd, c = x.shape
    # the input dilated by the stride: s - 1 zeros between neighbours
    xd = x.new_zeros((n, (h - 1) * sh + 1, (wd - 1) * sw + 1, c))
    xd[:, ::sh, ::sw] = x
    if isinstance(padding, str):
        pads = (_transpose_pads(w.shape[0], sh, padding), _transpose_pads(w.shape[1], sw, padding))
    else:
        pads = tuple(tuple(p) for p in padding)
    y = _conv_nhwc(xd, w, (1, 1), pads)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
