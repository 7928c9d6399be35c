"""Greedy sampling over the vocabulary.  The vocab-sharded cross-entropy
of the training path is not ported yet."""

from __future__ import annotations

import torch

from repro_torch.parallel.sharding import Runtime, group_size


def sharded_argmax(logits: torch.Tensor, rt: Runtime, vocab_size: int) -> torch.Tensor:
    """(B, S, V) logits -> (B, S) token ids.  Padded vocab columns are
    masked to -1e30; ties go to the smallest id (argmax returns the
    first maximum)."""
    if group_size(rt.tp_group) != 1:
        raise NotImplementedError("vocab-sharded argmax over a TP group "
                                  "larger than one is not ported yet")
    gid = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(gid < vocab_size, logits, -1e30)
    return logits.argmax(dim=-1)
