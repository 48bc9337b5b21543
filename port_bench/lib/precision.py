"""Emulated precisions for the reference and its controls.

Every matrix product of a block of PyTorch code can be computed from
operands rounded to a narrower type, with f32 accumulation, by running the
block under `RoundedProducts(rounding)`: a dispatch mode that rounds the
two operands of each aten mm/bmm/addmm/baddbmm. It sits below autograd, so
the products of backward passes (and of second-order backward passes) are
rounded too, as a card computing in that type would round them. The same
code runs on the CPU (the tests) and on the card, with TF32 switched off so
that an f32 product is an f32 product.

    tf32   10-bit mantissa, round to nearest even (the tensor cores' TF32)
    bf16   7-bit mantissa, round to nearest even
    fp8    float8 e4m3 with one scale a tensor (its amax onto 448)
"""
import torch
from torch.utils._python_dispatch import TorchDispatchMode

FP8_MAX = 448.0


def tf32(x):
    """x (f32) rounded to TF32's 10-bit mantissa, nearest even."""
    i = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((i >> 13) & 1)
    r = ((i + bias) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def fp8(x):
    """x rounded to float8 e4m3 under one scale for the whole tensor."""
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


ROUNDINGS = {'tf32': tf32, 'bf16': bf16, 'fp8': fp8}

_OPERANDS = {
    torch.ops.aten.mm.default: (0, 1),
    torch.ops.aten.bmm.default: (0, 1),
    torch.ops.aten.addmm.default: (1, 2),
    torch.ops.aten.baddbmm.default: (1, 2),
}


class RoundedProducts(TorchDispatchMode):
    """Rounds the f32 operands of every matrix product run under it."""

    def __init__(self, rounding):
        super().__init__()
        self.rounding = (ROUNDINGS[rounding] if isinstance(rounding, str)
                         else rounding)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        where = _OPERANDS.get(func)
        if where is not None:
            args = list(args)
            for i in where:
                if args[i].dtype == torch.float32:
                    args[i] = self.rounding(args[i])
        return func(*args, **kwargs)


def exact_f32():
    """Switches TF32 off for f32 products and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
