"""Weight-only int8 serving (counterpart of the serving half of
``paddle_tpu/quantization/__init__.py``: ``Int8Linear`` and its
``_int8_linear_fwd``).

``Int8Linear.from_linear`` turns an ``nn.Linear`` into per-output-channel
int8 weights: the scale of output channel j is ``max(|w[j, :]|, 1e-8)``
over the input dimension (the JAX package keeps ``[in, out]`` weights and
takes the max over axis 0; this is the same channel), the weight
``clip(round(w / scale * 127), -127, 127)`` with round half to even, all
from the weight upcast to fp32. The forward quantizes the activation per
token from its live row max in fp32, takes the int8 x int8 product with
int32 sums, and applies ``acc * (s_tok / 127) * w_scale`` in that order,
then the bias in fp32, then casts back to the input's type: the JAX
op's arithmetic, operation for operation.

The product runs on the card through ``torch._int_mm`` (cuBLASLt's int8
GEMM): the JAX package computes it in XLA outside any Pallas kernel, so
this is a library call, not a port of a kernel. Its rules on CUDA: more
than 16 rows, inner and output widths multiples of 8, the second operand
column-major. The weight stays ``[out, in]`` row-major, the layout
``nn.Linear`` keeps, so ``qweight.t()`` is that column-major operand; the
rows are zero-padded up to a multiple of 8 and at least 32. A width the
call refuses raises: nothing falls back to a float product on the card.
On the CPU the product is the plain version: the int8 values in fp64,
whose sums of at most 2^53 are exact, so it equals the int32 sums.

Not ported yet (ROADMAP Queue 1, item 7): ``QuantConfig``, ``QAT``,
``PTQ``, ``AbsmaxObserver`` and ``quant_dequant`` (fake-quant training and
calibration).
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["Int8Linear", "int8_matmul"]

QMAX = 127.0
# torch._int_mm on CUDA needs more than 16 rows
MIN_ROWS = 32


def int8_matmul(xq: torch.Tensor, qweight: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] int8 @ qweight [N, K] int8 ^ T`` with int32 sums, as an
    fp32 ``[M, N]``: ``torch._int_mm`` on the card (rows zero-padded to a
    multiple of 8, at least ``MIN_ROWS``), the exact plain product on the
    CPU."""
    if xq.device.type == "cpu":
        return (xq.double() @ qweight.double().t()).float()
    m = xq.shape[0]
    rows = max(MIN_ROWS, -(-m // 8) * 8)
    if rows != m:
        xq = torch.cat([xq, xq.new_zeros(rows - m, xq.shape[1])])
    return torch._int_mm(xq, qweight.t())[:m].float()


class Int8Linear(nn.Module):
    """Serving-form Linear: int8 weights (buffer ``qweight [out, in]``)
    with per-output-channel fp32 scales (buffer ``w_scale [out]``, already
    divided by 127), int8 activations quantized per token at run time, and
    the original bias (an fp32 add before the cast back)."""

    def __init__(self, qweight: torch.Tensor, w_scale: torch.Tensor,
                 bias=None):
        super().__init__()
        if qweight.dtype != torch.int8 or qweight.dim() != 2:
            raise TypeError(f"Int8Linear: qweight must be a 2-D int8 tensor, "
                            f"got {qweight.dtype} {tuple(qweight.shape)}")
        self.out_features, self.in_features = qweight.shape
        self.register_buffer("qweight", qweight)
        self.register_buffer("w_scale", w_scale.float())
        self.bias = bias

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear: nn.Linear) -> "Int8Linear":
        """Weight-only conversion of ``linear`` (no calibration): the int8
        weight and its scales on the linear's device; the bias is the
        linear's own parameter."""
        w = linear.weight.float()
        scale = w.abs().amax(dim=1).clamp_min(1e-8)
        q = torch.round(w / scale[:, None] * QMAX).clamp(-QMAX, QMAX)
        return cls(q.to(torch.int8), scale / QMAX, linear.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float().reshape(-1, self.in_features)
        s_tok = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
        xq = torch.round(xf * (QMAX / s_tok)).clamp(-QMAX, QMAX) \
            .to(torch.int8)
        acc = int8_matmul(xq, self.qweight)
        out = acc * (s_tok / QMAX) * self.w_scale
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(x.dtype).reshape(*x.shape[:-1], self.out_features)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bias={self.bias is not None}")
