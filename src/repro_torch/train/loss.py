"""Vocab-sharded cross-entropy and greedy sampling (Megatron-style), the
JAX package's ``train/loss.py``.

The LM head gives logits sharded over the TP group on the vocabulary;
rank r holds columns [r * Vl, (r + 1) * Vl).  The softmax statistics meet
in one max and two sums of (B, S) values over the group instead of ever
materializing the full logits.  Padded columns (the vocabulary rounded
up for an even split) are masked to -1e30 out of the logsumexp, and
labels outside the vocabulary are masked out of the mean.  At a TP group
of one (``None``) every collective is skipped.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import Runtime, psum


def _masked(logits: torch.Tensor, rt: Runtime, vocab_size: int):
    """(logits with the padded columns at -1e30, this shard's first id)."""
    vl = logits.shape[-1]
    off = rt.tp_rank * vl
    gid = off + torch.arange(vl, device=logits.device)
    return torch.where(gid < vocab_size, logits, -1e30), off


def _all_reduce(x: torch.Tensor, rt: Runtime, op) -> torch.Tensor:
    """``x`` reduced over the TP group, outside autograd (the max of the
    softmax shift and the argmax carry no gradient)."""
    if rt.tp_group is not None:
        x = x.detach().clone()
        dist.all_reduce(x, op=op, group=rt.tp_group)
    return x


def sharded_xent(logits: torch.Tensor, labels: torch.Tensor, rt: Runtime,
                 vocab_size: int, z_loss: float = 0.0):
    """logits (B, S, Vl) f32 vocab-sharded, labels (B, S) global ids ->
    (mean loss over the valid tokens, metrics {"nll_sum", "n_tok",
    "mean_logp"}).  ``z_loss`` adds ``z_loss * lse^2`` per valid token.  The
    sums over the group are the reference's raw psums, whose backward sums
    too (``sharding.psum``)."""
    vl = logits.shape[-1]
    logits, off = _masked(logits, rt, vocab_size)
    gmax = _all_reduce(logits.amax(dim=-1).detach(), rt, dist.ReduceOp.MAX)
    sumexp = psum(torch.exp(logits - gmax[..., None]).sum(dim=-1), rt.tp_group)
    lse = torch.log(sumexp) + gmax
    local = labels - off
    in_shard = (local >= 0) & (local < vl)
    picked = logits.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
    picked = psum(torch.where(in_shard, picked, 0.0), rt.tp_group)
    tok_mask = (labels >= 0) & (labels < vocab_size)
    nll = torch.where(tok_mask, lse - picked, 0.0)
    if z_loss:
        nll = nll + torch.where(tok_mask, z_loss * lse * lse, 0.0)
    n_tok = tok_mask.sum().clamp(min=1)
    loss = nll.sum() / n_tok
    metrics = {"nll_sum": nll.sum(), "n_tok": n_tok,
               "mean_logp": torch.where(tok_mask, picked - lse, 0.0).sum() / n_tok}
    return loss, metrics


def sharded_argmax(logits: torch.Tensor, rt: Runtime, vocab_size: int) -> torch.Tensor:
    """(B, S, Vl) vocab-sharded logits -> (B, S) token ids.  Padded columns
    are masked; ties go to the smallest id, within a shard (argmax returns
    the first maximum) and across shards (the smallest id among the
    shards that hold the maximum)."""
    logits, off = _masked(logits, rt, vocab_size)
    local_max, local_arg = logits.max(dim=-1)
    local_arg = local_arg + off
    if rt.tp_group is None:
        return local_arg
    gmax = _all_reduce(local_max, rt, dist.ReduceOp.MAX)
    cand = torch.where(local_max >= gmax, local_arg, 2 ** 30)
    return _all_reduce(cand, rt, dist.ReduceOp.MIN)
