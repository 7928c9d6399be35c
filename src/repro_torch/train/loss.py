"""Cross-entropy over the vocabulary and greedy sampling.

The counterpart of the JAX package's ``train/loss.py`` at a tensor-
parallel group of one: the logits hold the whole (padded) vocabulary,
padded columns are masked to -1e30 out of the logsumexp, and labels
outside the vocabulary are masked out of the mean.  A larger TP group
raises: vocab-sharded statistics come with tensor parallelism.
"""

from __future__ import annotations

import torch

from repro_torch.parallel.sharding import Runtime, group_size


def _single_tp(rt: Runtime, what: str) -> None:
    if group_size(rt.tp_group) != 1:
        raise NotImplementedError(f"vocab-sharded {what} over a TP group "
                                  "larger than one is not ported yet")


def sharded_xent(logits: torch.Tensor, labels: torch.Tensor, rt: Runtime,
                 vocab_size: int):
    """logits (B, S, V) f32, labels (B, S) ids -> (mean loss over the
    valid tokens, metrics {"nll_sum", "n_tok", "mean_logp"})."""
    _single_tp(rt, "cross-entropy")
    V = logits.shape[-1]
    gid = torch.arange(V, device=logits.device)
    logits = torch.where(gid < vocab_size, logits, -1e30)
    gmax = logits.amax(dim=-1).detach()
    sumexp = torch.exp(logits - gmax[..., None]).sum(dim=-1)
    lse = torch.log(sumexp) + gmax
    in_range = (labels >= 0) & (labels < V)
    picked = logits.gather(-1, labels.clamp(0, V - 1)[..., None])[..., 0]
    picked = torch.where(in_range, picked, 0.0)
    tok_mask = (labels >= 0) & (labels < vocab_size)
    nll = torch.where(tok_mask, lse - picked, 0.0)
    n_tok = tok_mask.sum().clamp(min=1)
    loss = nll.sum() / n_tok
    metrics = {"nll_sum": nll.sum(), "n_tok": n_tok,
               "mean_logp": torch.where(tok_mask, picked - lse, 0.0).sum() / n_tok}
    return loss, metrics


def sharded_argmax(logits: torch.Tensor, rt: Runtime, vocab_size: int) -> torch.Tensor:
    """(B, S, V) logits -> (B, S) token ids.  Padded vocab columns are
    masked to -1e30; ties go to the smallest id (argmax returns the
    first maximum)."""
    _single_tp(rt, "argmax")
    gid = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(gid < vocab_size, logits, -1e30)
    return logits.argmax(dim=-1)
