"""Mixture-of-Experts layer with the reference's two sharding strategies
(the JAX package's ``models/moe.py``, function for function).

* ``ep`` (n_experts >= tp, e.g. qwen3-moe's 128 experts): expert
  parallelism.  Each TP rank holds E/tp experts; tokens are packed into
  per-expert capacity buckets and exchanged with one All2All each way
  through the schedule IR (``collectives.hier_all_to_all``, the paper's
  §5 AllToAllH carrying the Table-2 MoE traffic).
  ``Runtime.moe_a2a_mode`` picks the decomposition (``flat_a2a`` /
  ``hier_a2a``) and ``Runtime.moe_cluster_weights`` the skew-aware
  per-cluster expert capacity (``cluster_capacities``).

* ``etp`` (n_experts < tp, e.g. mixtral's 8 experts at TP 16):
  expert-tensor parallelism.  Every rank holds a 1/tp slice of every
  expert's FFN and computes all locally routed tokens against it; one sum
  over the TP group combines.

Routing: top-k softmax gating with capacity dropping (GShard) and the
Switch load-balance auxiliary loss.  Dropped tokens pass through on the
residual stream.  No kernel of the reference's runs here: routing,
packing and the expert FFN are plain PyTorch in both packages.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives, topology
from repro_torch.parallel.sharding import (Runtime, copy_to_tp, gather_sp, reduce_from_tp,
                                           tp_entry_group)
from . import layers


def strategy(cfg: ModelConfig, tp: int) -> str:
    return "ep" if cfg.n_experts >= tp else "etp"


def init_moe(gen: torch.Generator, cfg: ModelConfig, tp: int, dtype) -> dict:
    """Global expert banks (E, D, dff), drawn in f32 one bank at a time
    and cast; the router (D, E) stays f32.  The sharding rules
    (``model._tp_dim``) shard the expert dim for ``ep`` or d_ff for
    ``etp``; this init is strategy-agnostic."""
    E, D, dff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(dff)

    def bank(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        return (w * scale).to(dtype)

    return {"router": layers.init_dense(gen, D, E, torch.float32),
            "w_gate": bank((E, D, dff), s_in),
            "w_up": bank((E, D, dff), s_in),
            "w_down": bank((E, dff, D), s_out)}


def _route(p, x2d: torch.Tensor, cfg: ModelConfig):
    """x2d (T, D) -> top-k weights (T, k), ids (T, k) and the aux loss."""
    with torch.profiler.record_function("moe_route"):
        logits = x2d.float() @ p["router"]
        probs = torch.softmax(logits, dim=-1)
        w, ids = torch.topk(probs, cfg.top_k, dim=-1)
        w = w / w.sum(dim=-1, keepdim=True)                  # renormalize
        # Switch load-balance loss: E * sum_e f_e * P_e
        E = cfg.n_experts
        me = probs.mean(dim=0)
        fe = F.one_hot(ids[:, 0], E).float().mean(dim=0)
        aux = E * (fe * me).sum()
    return w, ids, aux


def _expert_ffn(w_gate, w_up, w_down, xs: torch.Tensor) -> torch.Tensor:
    """Batched expert FFN: xs (E_l, C, D) -> (E_l, C, D)."""
    with torch.profiler.record_function("moe_experts"):
        h = F.silu(torch.bmm(xs, w_gate)) * torch.bmm(xs, w_up)
        return torch.bmm(h, w_down)


def _capacity(T: int, k: int, E: int, factor: float) -> int:
    return max(8, int(math.ceil(T * k / E * factor / 8.0)) * 8)


def cluster_capacities(T: int, k: int, E: int, factor: float,
                       weights) -> tuple[int, ...]:
    """Skew-aware per-cluster expert capacity: the even budget
    ``n_clusters * _capacity(...)`` redistributed by the per-cluster
    compute weights (largest-remainder split, an 8-slot floor)."""
    base = _capacity(T, k, E, factor)
    caps = topology.integer_split(base * len(tuple(weights)), weights, floor=8)
    return tuple(int(c) for c in caps)


def _pack(x2d: torch.Tensor, ids: torch.Tensor, w: torch.Tensor, E: int, C: int,
          cap: torch.Tensor | None = None):
    """Scatter tokens into per-expert capacity buckets: buf (E, C, D) and
    the route (ids, slot, keep, w) of the combine.  A token's slot is its
    occupancy index in its expert (a one-hot cumsum, t-major, scanned
    along the token dim laid innermost); slots at or above the capacity
    (``cap[e]`` per expert if given, else C) drop.  The scatter runs once
    per routing slot, out of place, so autograd carries it; kept tokens
    land on distinct (expert, slot) cells, and dropped ones on an extra
    expert row that is cut off, so each step writes without accumulating
    and the buffer equals the reference's sum into zeros."""
    with torch.profiler.record_function("moe_pack"):
        T, k = ids.shape
        flat_e = ids.reshape(-1)                              # (T*k,) t-major
        occupancy = torch.cumsum(F.one_hot(flat_e, E).T.contiguous(), dim=1)
        slot = (occupancy.gather(0, flat_e[None])[0] - 1).reshape(T, k)
        keep = slot < (C if cap is None else cap[ids])
        slot_c = torch.where(keep, slot, 0)
        row = torch.where(keep, ids, E)                       # dropped -> row E
        buf = x2d.new_zeros((E + 1, C, x2d.shape[1]))
        for j in range(k):
            buf = buf.index_put((row[:, j], slot_c[:, j]), x2d)
    return buf[:E], (ids, slot_c, keep, w)


def _combine(out_buf: torch.Tensor, route, T: int, k: int, dtype) -> torch.Tensor:
    """Gather each token's k expert outputs, weight them in ``out_buf``'s
    dtype and sum there, cast to ``dtype`` at the end."""
    with torch.profiler.record_function("moe_combine"):
        ids, slot_c, keep, w = route
        out = out_buf.new_zeros((T, out_buf.shape[-1]))
        for j in range(k):
            picked = torch.where(keep[:, j, None], out_buf[ids[:, j], slot_c[:, j]], 0)
            out = out + picked * w[:, j, None].to(picked.dtype)
        return out.to(dtype)


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig, rt: Runtime, last: bool = False):
    """x (B, S, D) -> (out (B, S, D), aux loss f32 scalar).  ``last``: the
    output is the layer's last sum (``reduce_from_tp``)."""
    B, S, D = x.shape
    x = copy_to_tp(x, tp_entry_group(rt))
    x2d = x.reshape(-1, D)
    T = x2d.shape[0]
    w, ids, aux = _route(p, x2d, cfg)
    E, k = cfg.n_experts, cfg.top_k
    tp = rt.tp

    if strategy(cfg, tp) == "etp" or rt.tp_group is None or tp == 1:
        # etp: the expert outputs are 1/tp partial sums, so the combine
        # weights multiply partials; their cotangent needs the TP sum that
        # copy_to_tp's backward gives
        w = copy_to_tp(w, rt.tp_group)
        C = _capacity(T, k, E, rt.moe_capacity_factor)
        buf, route = _pack(x2d, ids, w, E, C)
        out_buf = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], buf)
        out = _combine(out_buf, route, T, k, x.dtype)
        out = reduce_from_tp(out, rt.tp_group, last)         # sum 1/tp FFN slices
        return out.reshape(B, S, D), aux

    # --- ep: All2All dispatch over the TP group --------------------------
    # x (and so the routing) is replicated over the TP group; each rank
    # owns a disjoint 1/tp slice of the tokens, so no expert computes a
    # token twice.  The closing all-gather rebuilds the token range (its
    # backward reduce-scatters the cotangent back).
    if E % tp:
        raise ValueError(
            f"MoE expert parallelism needs the tensor-parallel size to "
            f"divide the expert count: n_experts={E} % tp={tp} "
            f"(axis 'model') = {E % tp}; pick a tp that divides "
            f"{E} or drop below n_experts to select the etp strategy")
    if rt.moe_a2a_pod_group is not None:
        # the buffers below are laid out per TP rank: an exchange that also
        # crosses pods would need E to split over pods x tp
        raise NotImplementedError("the ep exchange over a pod group (moe_a2a_pod_group)")
    el = E // tp                                             # local experts
    pad_t = (-T) % tp
    if pad_t:  # tiny decode batches: pad with weight-0 tokens
        x2d = torch.cat([x2d, x2d.new_zeros((pad_t, D))])
        ids = torch.cat([ids, ids.new_zeros((pad_t, k))])
        w = torch.cat([w, w.new_zeros((pad_t, k))])
    T_loc = (T + pad_t) // tp
    col = rt.tp_rank
    x_loc = x2d.narrow(0, col * T_loc, T_loc)
    ids_loc = ids.narrow(0, col * T_loc, T_loc)
    w_loc = w.narrow(0, col * T_loc, T_loc)
    if rt.moe_cluster_weights:
        # skew-aware per-cluster capacity: rank col's experts live on
        # cluster col * n_cl / tp; tokens above its capacity drop through
        # the pack mask while the buffer stays padded to the largest
        # capacity (the same a2a shapes on every rank)
        caps = cluster_capacities(T_loc, k, E, rt.moe_capacity_factor,
                                  rt.moe_cluster_weights)
        n_cl = len(caps)
        C = max(caps)
        cap_e = torch.tensor([caps[(e // el) * n_cl // tp] for e in range(E)],
                             dtype=torch.int64, device=x.device)
        buf, route = _pack(x_loc, ids_loc, w_loc, E, C, cap=cap_e)
    else:
        C = _capacity(T_loc, k, E, rt.moe_capacity_factor)
        buf, route = _pack(x_loc, ids_loc, w_loc, E, C)     # (E, C, D)
    # dispatch through the schedule IR, tiled on the expert dim (E = tp *
    # el): block i, the buckets of rank i's experts, lands on rank i.  On a
    # one-cluster ep group (moe_a2a_pod_group None) every mode is the one
    # native exchange over the TP group
    a2a_cfg = collectives.CommConfig(mode=rt.moe_a2a_mode, pod_group=rt.moe_a2a_pod_group,
                                     intra_group=rt.tp_group, n_chunks=1, compression=None)
    recv = collectives.hier_all_to_all(buf, a2a_cfg, 0, 0).reshape(tp, el, C, D)
    # recv[src] = src's buckets for my experts: fold sources into capacity
    xs = recv.transpose(0, 1).reshape(el, tp * C, D)
    out_loc = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], xs)
    out_loc = out_loc.reshape(el, tp, C, D).transpose(0, 1)   # (tp, el, C, D)
    out_buf = collectives.hier_all_to_all(out_loc.reshape(E, C, D), a2a_cfg, 0, 0)
    out = _combine(out_buf, route, T_loc, k, x.dtype)         # (T_loc, D)
    out = gather_sp(out, rt.tp_group, dim=0)                  # (T + pad_t, D)
    if pad_t:
        out = out[:T]
    return out.reshape(B, S, D), aux
