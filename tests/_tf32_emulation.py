"""TF32 as the port's f32 kernels feed it to the tensor cores
(``csrc/mma.cuh``'s ``split_tf32`` and ``mma_tf32x3``), emulated on the
CPU by integer arithmetic on the f32 bit pattern: the rounding, the
tensor core's read of an operand, and a product of one or three TF32
matrix products."""

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest with ties away from zero, 10 mantissa bits kept, by integer
    arithmetic on the f32 bit pattern (adding half of the dropped 13 bits'
    unit carries into the kept ones), as the kernel's ``split_tf32``."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` as the tensor core reads a TF32 operand: its top 19 bits
    (the low 13 cleared)."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b in f32 from TF32 operands: one product of the rounded
    operands, or three of the split ones as the f32 kernel takes them (hi
    = TF32(x), lo = x - hi read by the tensor core; lo * hi + hi * lo +
    hi * hi, ``mma_tf32x3``).  A product of two TF32 values is exact in
    f32, so only the sums round, as in the tensor core's f32 accumulator."""
    ah, bh = tf32(a), tf32(b)
    if products == 1:
        return ah @ bh
    al, bl = tf32_read(a - ah), tf32_read(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh
