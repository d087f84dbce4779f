"""Int8 weight quantization for the serving decode path (w8a8 dynamic).

Counterpart of ``long_context_attention_tpu/ops/wquant.py``: decode weights
are stored int8 with per-output-channel fp32 scales, activations are
quantized per row (absmax / 127) on the fly, the product runs int8 x int8
with int32 sums, and the result is rescaled in fp32. The JAX package leaves
this product to XLA (no Pallas kernel); the port uses PyTorch's int8 matrix
product (``torch._int_mm``), which sums exactly in int32 on the CPU and the
card alike.

On the card ``torch._int_mm`` takes only more than 16 rows and inner and
outer sizes divisible by 8. :func:`quantize_weight` therefore keeps the
weight in a zero-padded buffer (``QTensor.padded``; ``q`` is a view of its
logical part) and :func:`qdot` pads the activation rows per call, on every
device alike. Zero padding adds nothing to the int32 sums, so the result is
unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["QTensor", "qdot", "quantize_weight", "quantize_decode_params"]


@dataclasses.dataclass
class QTensor:
    """An int8 weight with per-output-channel fp32 scales.

    ``q``: (..., in, out) int8; ``scale``: (..., out) fp32, so that the
    logical weight is ``q * scale[..., None, :]``. ``padded``: the
    (..., in8, out8) zero-padded, column-major buffer that ``q`` is a view
    of (sizes rounded up to multiples of 8). :meth:`unbind` splits the
    leading (layer) axis of all three together, as a tensor's does."""

    q: torch.Tensor
    scale: torch.Tensor
    padded: torch.Tensor

    def unbind(self):
        return [QTensor(*t) for t in zip(self.q.unbind(), self.scale.unbind(),
                                         self.padded.unbind())]


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def quantize_weight(w: torch.Tensor) -> QTensor:
    """(..., in, out) float -> QTensor, absmax per output channel."""
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=-2), min=1e-8) / 127.0
    q = torch.round(wf / s[..., None, :]).to(torch.int8)
    *lead, n_in, n_out = q.shape
    # column-major (in, out): cuBLASLt's int8 product on the H100 runs 6-10x
    # faster with this layout than with a row-major weight at decode shapes
    buf = torch.zeros((*lead, _up8(n_out), _up8(n_in)), dtype=torch.int8,
                      device=w.device).transpose(-1, -2)
    buf[..., :n_in, :n_out] = q
    return QTensor(q=buf[..., :n_in, :n_out], scale=s, padded=buf)


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain weight, or dynamic w8a8 for a QTensor: per-row
    activation quantization, int8 x int8 -> int32 product, fp32 rescale.
    Returns x's dtype."""
    if not isinstance(w, QTensor):
        return x @ w
    shape = x.shape
    n_in, n_out = w.q.shape[-2:]
    x2 = x.reshape(-1, n_in).float()
    xs = torch.clamp(x2.abs().amax(dim=-1, keepdim=True), min=1e-6) / 127.0
    x8 = torch.round(x2 / xs).to(torch.int8)
    m = x8.shape[0]
    xp = torch.zeros((max(32, _up8(m)), w.padded.shape[-2]),
                     dtype=torch.int8, device=x.device)
    xp[:m, :n_in] = x8
    y = torch._int_mm(xp, w.padded)[:m, :n_out]
    y = y.float() * xs * w.scale
    return y.reshape(*shape[:-1], n_out).to(x.dtype)


_DECODE_WEIGHT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_decode_params(params):
    """Quantize the per-layer matmul weights and lm_head of a llama params
    dict to QTensors for decode; embedding and norms stay as they are. The
    input dict is not modified. An MoE model's params raise (its experts
    stay bf16, as in the JAX package)."""
    if "router" in params["layers"]:
        raise ValueError("int8 decode weights: the MoE experts stay bf16 "
                         "(weight_dtype='bfloat16')")
    out = dict(params)
    layers = dict(params["layers"])
    for k in _DECODE_WEIGHT_KEYS:
        if k in layers:
            layers[k] = quantize_weight(layers[k])
    out["layers"] = layers
    if "lm_head" in out:
        out["lm_head"] = quantize_weight(out["lm_head"])
    return out
