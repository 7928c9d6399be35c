"""Mamba2 (SSD) block: projections, causal conv, chunked SSD, gated norm.

The counterpart of the JAX package's ``models/ssm.py``.  The in-projection
is split as there (z, x, B/C, dt), and the conv runs over the x channels
and the B/C channels as one depthwise stack.  Under tensor parallelism
the inner dim (z, x, the conv over x, the gated norm) and the SSM heads
(dt, dt_bias, A_log, D_skip) are sharded over the TP group; the B/C
projection and its conv are replicated (g * n channels, small); out_proj
is row-parallel.  The gated norm normalizes each rank's d_inner / tp
channels, as the reference's does (ROADMAP R18).  Decode carries an
``SSMState``: the last W - 1 conv inputs [local x channels, B/C
channels], kept in bf16 whatever the model's dtype (as the reference
keeps them), the (h_local, p, n) SSM state in f32 and the token count.

Serving runs the chunked SSD through the ``ssd_chunk`` kernel
(``ops.ssd_chunked``); training (``train=True``) runs the plain chunked
SSD under autograd (``ref.ssd_chunked``, in a ``ssd_plain`` profiler
range), as the reference trains: its SSD kernel has no VJP (ROADMAP
R15).  The conv is plain PyTorch on both paths (the reference has no
conv kernel).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.parallel.sharding import Runtime, copy_to_tp, reduce_from_tp, tp_entry_group
from . import layers


class SSMState(NamedTuple):
    conv: torch.Tensor     # stacked (L, B, W-1, ch) bf16, or one layer's (B, W-1, ch)
    ssm: torch.Tensor      # (L, B, H, P, N) f32, or one layer's (B, H, P, N)
    length: torch.Tensor   # (L,) int32, or one layer's (): tokens seen

    def layer(self, i: int) -> "SSMState":
        """Views of layer ``i`` of a stacked state."""
        return SSMState(self.conv[i], self.ssm[i], self.length[i])


def init_ssm(gen: torch.Generator, cfg: ModelConfig, tp: int, dtype) -> dict:
    """The reference's SSM params, leaf for leaf: dt_bias, A_log and
    D_skip in f32, the rest in the model's dtype."""
    D = cfg.d_model
    di, hd, ns, g = cfg.d_inner, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    h = di // hd
    dev = gen.device
    cscale = 1.0 / math.sqrt(cfg.conv_width)

    def conv_w(ch):
        w = torch.randn((ch, cfg.conv_width), generator=gen, dtype=torch.float32,
                        device=dev)
        return (w * cscale).to(dtype)

    return {
        "w_z": layers.init_dense(gen, D, di, dtype),
        "w_x": layers.init_dense(gen, D, di, dtype),
        "w_bc": layers.init_dense(gen, D, 2 * g * ns, dtype),
        "w_dt": layers.init_dense(gen, D, h, dtype),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=dev)),
        "D_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "conv_w_x": conv_w(di),
        "conv_b_x": torch.zeros((di,), dtype=dtype, device=dev),
        "conv_w_bc": conv_w(2 * g * ns),
        "conv_b_bc": torch.zeros((2 * g * ns,), dtype=dtype, device=dev),
        "norm_scale": torch.ones((di,), dtype=dtype, device=dev),
        "w_out": layers.init_dense(gen, di, D, dtype),
    }


def _split_conv_channels(cfg: ModelConfig, tp: int) -> tuple[int, int]:
    """(local inner channels d_inner / tp, g * n replicated B (or C)
    channels); ``cfg.ssm_heads(tp)`` asserts the heads split evenly."""
    cfg.ssm_heads(tp)
    return cfg.d_inner // tp, cfg.ssm_groups * cfg.ssm_state


def _dims(cfg: ModelConfig, tp: int):
    """(local d_inner, g * n, local heads, head dim, n, g) at TP ``tp``."""
    di_l, gn = _split_conv_channels(cfg, tp)
    hd = cfg.ssm_head_dim
    return di_l, gn, di_l // hd, hd, cfg.ssm_state, cfg.ssm_groups


def _conv_params(p):
    w = torch.cat([p["conv_w_x"], p["conv_w_bc"]], dim=0)
    b = torch.cat([p["conv_b_x"], p["conv_b_bc"]], dim=0)
    return w, b


def _gated_proj(p, y: torch.Tensor, z: torch.Tensor, x_dtype) -> torch.Tensor:
    """norm(y * silu(z)) in f32 (Mamba2's gated RMSNorm), then out_proj:
    this rank's partial sum."""
    y = y.float() * F.silu(z.float())
    y = layers.apply_norm({"scale": p["norm_scale"]}, y, "rmsnorm").to(x_dtype)
    return y @ p["w_out"]


def _gated_out(p, y: torch.Tensor, z: torch.Tensor, x_dtype, rt: Runtime):
    """``_gated_proj`` summed over the TP group."""
    return reduce_from_tp(_gated_proj(p, y, z, x_dtype), rt.tp_group)


def apply_ssm(p, x: torch.Tensor, cfg: ModelConfig, rt: Runtime, *,
              chunk: int = 128, train: bool = False, last: bool = False):
    """x: (B, S, D) -> ((B, S, D), the state after the S tokens).  The
    state starts at zero, as every caller of the reference starts it.
    S % chunk != 0 pads x, dt, B and C with zeros to the chunk.  The
    input enters the TP region through ``tp_entry_group`` (none under
    sequence parallelism, whose gather carries the reduction).
    ``train`` takes the plain SSD, differentiable; otherwise the SSD goes
    through the kernel, which refuses autograd.  ``last``: the output is
    the layer's last sum (``reduce_from_tp``)."""
    Bsz, S, _ = x.shape
    x = copy_to_tp(x, tp_entry_group(rt))
    di, gn, h, hd, ns, g = _dims(cfg, rt.tp)

    z = x @ p["w_z"]                                   # (B, S, di)
    xs = x @ p["w_x"]
    bc = x @ p["w_bc"]                                 # (B, S, 2gn)
    dt_raw = x @ p["w_dt"]                             # (B, S, h)

    conv_in = torch.cat([xs, bc], dim=-1)              # (B, S, di + 2gn)
    conv_w, conv_b = _conv_params(p)
    conv = ops.causal_conv1d(conv_in, conv_w, conv_b)     # plain, differentiable
    conv = F.silu(conv.float()).to(conv_in.dtype)
    xs = conv[..., :di].reshape(Bsz, S, h, hd)         # views of conv
    Bmat = conv[..., di:di + gn].reshape(Bsz, S, g, ns)
    Cmat = conv[..., di + gn:].reshape(Bsz, S, g, ns)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    pad = (-S) % chunk
    if pad:
        xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt_p = F.pad(dt, (0, 0, 0, pad))
        B_p = F.pad(Bmat, (0, 0, 0, 0, 0, pad))
        C_p = F.pad(Cmat, (0, 0, 0, 0, 0, pad))
    else:
        xs_p, dt_p, B_p, C_p = xs, dt, Bmat, Cmat
    if train:       # the plain SSD under autograd: the kernel has no backward
        with torch.profiler.record_function("ssd_plain"):
            y, h_last = ref.ssd_chunked(xs_p, dt_p, A, B_p, C_p, chunk)
    else:
        y, h_last = ops.ssd_chunked(xs_p, dt_p, A, B_p, C_p, chunk)
    y = y[:, :S] + xs * p["D_skip"][None, None, :, None].to(y.dtype)
    y = y.reshape(Bsz, S, di)
    out = (reduce_from_tp(_gated_proj(p, y, z, x.dtype), rt.tp_group, last=True) if last
           else _gated_out(p, y, z, x.dtype, rt))
    W = cfg.conv_width
    state = SSMState(conv=conv_in[:, -(W - 1):].to(torch.bfloat16), ssm=h_last,
                     length=torch.tensor(S, dtype=torch.int32, device=x.device))
    return out, state


def apply_ssm_decode(p, x: torch.Tensor, cfg: ModelConfig, rt: Runtime,
                     state: SSMState):
    """One token, x: (B, 1, D) -> ((B, 1, D), state).  ``state`` (one
    layer's views) is updated in place and returned: the conv window
    shifts by one, the SSM state takes one step, the length advances."""
    Bsz = x.shape[0]
    x = copy_to_tp(x, rt.tp_group)
    di, gn, h, hd, ns, g = _dims(cfg, rt.tp)
    xt = x[:, 0]                                       # (B, D)

    z = xt @ p["w_z"]
    xs = xt @ p["w_x"]
    bc = xt @ p["w_bc"]
    dt_raw = xt @ p["w_dt"]

    conv_w, conv_b = _conv_params(p)
    conv_in = torch.cat([xs, bc], dim=-1)              # (B, ch)
    hist = torch.cat([state.conv.to(conv_in.dtype), conv_in[:, None]], dim=1)
    conv = torch.einsum("bwc,cw->bc", hist.float(), conv_w.float()) + conv_b.float()
    conv = F.silu(conv).to(conv_in.dtype)
    xs_t = conv[:, :di].reshape(Bsz, h, hd)
    B_t = conv[:, di:di + gn].reshape(Bsz, g, ns)
    C_t = conv[:, di + gn:].reshape(Bsz, g, ns)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    y, new_ssm = ref.ssd_decode_step(state.ssm, xs_t, dt, A, B_t, C_t)
    y = y + xs_t * p["D_skip"][None, :, None].to(y.dtype)
    out = _gated_out(p, y.reshape(Bsz, di), z, x.dtype, rt)
    state.conv.copy_(hist[:, 1:])
    state.ssm.copy_(new_ssm)
    state.length.add_(1)
    return out[:, None], state


def make_ssm_state(cfg: ModelConfig, n_layers: int, batch: int, tp: int,
                   device) -> SSMState:
    """An empty state stacked over layers: (L, B, W-1, ch) bf16 with ch
    the local x channels then the B/C channels, (L, B, h_local, p, n) f32
    and (L,) int32, the layout the transfer moves."""
    di, gn = _split_conv_channels(cfg, tp)
    ch = di + 2 * gn
    return SSMState(
        conv=torch.zeros((n_layers, batch, cfg.conv_width - 1, ch),
                         dtype=torch.bfloat16, device=device),
        ssm=torch.zeros((n_layers, batch, di // cfg.ssm_head_dim,
                         cfg.ssm_head_dim, cfg.ssm_state),
                        dtype=torch.float32, device=device),
        length=torch.zeros((n_layers,), dtype=torch.int32, device=device))
