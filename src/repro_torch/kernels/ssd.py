"""Mamba2 SSD chunk: the wrapper of the CUDA kernel in ``csrc/ssd.cu``
and its plain version.

The within-chunk part of the JAX package's ``kernels/ssd.py``
(``ssd_chunk_call``), per (batch, chunk, head): the decay-masked
"attention" ``y_diag`` and the chunk states.  Unlike the reference's
kernel, it takes the model's layout, x (b, s, h, p), dt (b, s, h), B and
C (b, s, g, n), through strides (the last axis contiguous; x, B and C
four elements aligned), and each head
reads its group's B and C rows, so neither the chunked transposes nor the
repeat over heads is copied.  s must be a multiple of the chunk q.
Outputs: y_diag (b, nc, q, h, p) f32, sequence-major as the model's
tensors are, and states (b, nc, h, p, n) f32.
"""

from __future__ import annotations

import torch

from . import _build, ref

_CODES = {torch.float32: _build.F32, torch.bfloat16: _build.BF16}


def _chunked(t: torch.Tensor, q: int) -> torch.Tensor:
    """(b, s, ...) -> (b, s // q, q, ...)."""
    return t.reshape(t.shape[0], t.shape[1] // q, q, *t.shape[2:])


def ssd_chunk_plain(x, dt, A, B, C, chunk: int):
    """The kernel's function in plain PyTorch, in the order of operations
    of the reference's ``_ssd_chunk_kernel`` (f32 throughout)."""
    h, g = x.shape[2], B.shape[2]
    q, rep = chunk, h // g
    xf = _chunked(x.float(), q)                               # (b, nc, q, h, p)
    dtf = _chunked(dt.float(), q)                             # (b, nc, q, h)
    Bf = _chunked(B.float(), q)                               # (b, nc, q, g, n)
    Cf = _chunked(C.float(), q)
    dA_cs = torch.cumsum(dtf * A.float(), dim=2)
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]   # (b, nc, i, j, h)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    seg = torch.where(causal[None, None, :, :, None], seg, ref.NEG_INF)
    cb = torch.einsum("bcign,bcjgn->bcijg", Cf, Bf).repeat_interleave(rep, dim=4)
    scores = cb * torch.exp(seg)
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xf * dtf[..., None])
    decay_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)        # (b, nc, q, h)
    bw = Bf.repeat_interleave(rep, dim=3) * (decay_end * dtf)[..., None]
    states = torch.einsum("bcqhp,bcqhn->bchpn", xf, bw)
    return y, states


def _check(x, dt, A, B, C, chunk, with_data: bool = True):
    b, s, h, p = x.shape
    if B.ndim != 4 or B.shape != C.shape or B.shape[:2] != (b, s):
        raise ValueError(f"ssd_chunk: x {tuple(x.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}")
    g, n = B.shape[2], B.shape[3]
    if dt.shape != (b, s, h) or A.shape != (h,):
        raise ValueError(f"ssd_chunk: dt {tuple(dt.shape)}, A {tuple(A.shape)} "
                         f"for x {tuple(x.shape)}")
    if h % g:
        raise ValueError(f"ssd_chunk: {h} heads over {g} groups")
    if chunk <= 0 or s % chunk:
        raise ValueError(f"ssd_chunk: chunk {chunk} must divide the length {s}")
    if x.dtype not in _CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_chunk: x, B, C bf16 or f32, one dtype, got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_chunk: dt and A f32, got {dt.dtype}, {A.dtype}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"ssd_chunk: {name} on {t.device}")
    for name, t in (("x", x), ("B", B), ("C", C), ("A", A)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_chunk: {name}'s last axis is not contiguous")
    for name, t in (("x", x), ("B", B), ("C", C)):    # read 4 elements at a time
        if any(st % 4 for st in t.stride()[:3]) or (
                with_data and t.data_ptr() % (4 * t.element_size())):
            raise ValueError(f"ssd_chunk: {name} is not 4-element aligned")


def ssd_chunk_call(x, dt, A, B, C, chunk: int, *, heads_per_block: int = 0):
    """x: (b, s, h, p) bf16/f32; dt: (b, s, h) f32; A: (h,) f32; B/C:
    (b, s, g, n) in x's dtype, s a multiple of ``chunk`` -> (y_diag
    (b, nc, q, h, p) f32, states (b, nc, h, p, n) f32).

    bf16 runs on the tensor cores, one block per (batch, chunk) and run
    of at most ``heads_per_block`` heads of one group (0: the kernel picks
    the runs by wave count; at most 32, and as many as a block's shared
    memory holds); f32 runs one block per head and takes only 0.  On the
    card it raises ``NoBackwardError`` under autograd when an input
    requires grad (the kernel has no backward)."""
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, A, B, C, chunk)
    _build.refuse_autograd("ssd_chunk", x, dt, A, B, C)
    fake = _build.shape_only(x)
    _check(x, dt, A, B, C, chunk, with_data=not fake)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = s // chunk
    y = torch.empty((b, nc, chunk, h, p), dtype=torch.float32, device=x.device)
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=x.device)
    if fake:
        _build.count_shape_only(ssd_chunk_call, "ssd_chunk", x=x, dt=dt, A=A, B=B, C=C,
                                y=y, states=states, chunk=chunk)
        return y, states
    lib = _build.library()
    err = lib.ssd_chunk_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        _CODES[x.dtype], y.data_ptr(), states.data_ptr(),
        b, s, h, g, p, n, chunk,
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        B.stride(0), B.stride(1), B.stride(2),
        C.stride(0), C.stride(1), C.stride(2),
        heads_per_block, _build.stream_handle(x.device))
    # the launcher refuses a chunk, head dim or state its block cannot hold
    _build.check(err, f"ssd_chunk (chunk {chunk}, head dim {p}, state {n})")
    ssd_chunk_call.launches += 1
    return y, states


ssd_chunk_call.launches = 0
ssd_chunk_call.fake_launches = 0
