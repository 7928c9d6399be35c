"""How far int8 on the wire moves disaggregated decoding, cache leaf by leaf.

Prefill one batch with the weights and prompt that
``disaggregated.run`` draws for the same ``--seed``.  Then let each cache
leaf that the int8 transfer quantizes (a float leaf of at least 1024
values) cross alone as int8, and then all of them together, which is the
served transfer.  For each variant it reports:
- the leaf's relative RMS error after the round trip;
- the first decode step's relative RMS logit error and argmax flips
  against the raw transfer;
- the agreement of the ``--gen`` decoded tokens with raw decoding (the
  prefill's own token is left out: every variant shares it).

It prints one JSON line per variant, then a summary line with the raw
first-step logits' RMS and median top-1/top-2 margin.  Every token
choice and every logit statistic reads the real vocabulary only: the
padded columns of the LM head are masked, as the served path masks them.

    python -m repro_torch.serve.int8_sensitivity --arch mamba2-2.7b   # on the GPU
    python -m repro_torch.serve.int8_sensitivity --smoke --device cpu
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import quant
from repro_torch.models.model import Model, resolve_device
from repro_torch.serve.serve_step import make_kv_transfer, make_serve_steps
from repro_torch.train.loss import sharded_argmax


def _first_step(model, decode, tok, caches, gen: int):
    """The first decode step's logits over the real vocabulary (B, V),
    then the greedy tokens of ``gen`` steps (B, gen); ``caches`` is
    consumed."""
    logits, caches = model.apply_decode(tok, caches)
    toks = [sharded_argmax(logits, model.rt, model.cfg.vocab_size)]
    logits = logits[..., :model.cfg.vocab_size]
    for _ in range(gen - 1):
        t, caches = decode(toks[-1], caches)
        toks.append(t)
    return logits[:, 0], torch.cat(toks, dim=1)


def _rel_rms(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.float() - ref.float()).norm() / ref.float().norm()).item()


def run(arch: str = "qwen2.5-3b", *, smoke: bool = False, batch: int = 4,
        prompt_len: int = 1024, gen: int = 16, seed: int = 0,
        device="cuda") -> dict:
    """Measure every variant; returns ``{"variants": {name: result},
    "raw_logit_rms": .., "raw_top2_margin_median": ..}``, a variant named
    by its leaves joined with "+"."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch, smoke=smoke)
    model = Model(cfg, device=device).init(seed)
    gen_tok = torch.Generator(device="cpu").manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen_tok).to(device)
    prefill, decode = make_serve_steps(model)
    transfer = make_kv_transfer(model)
    transfer_q = make_kv_transfer(model, compress="int8")

    tok, caches = prefill(prompt)
    names = type(caches)._fields
    raw_logits, raw_toks = _first_step(model, decode, tok, transfer(caches), gen)
    top2 = raw_logits.topk(2, dim=-1).values
    leaves = [n for n, a in zip(names, caches)
              if a.is_floating_point() and a.numel() >= quant.BLOCK]
    variants = {}
    for variant in [[n] for n in leaves] + [leaves]:
        raw, q = transfer(caches), transfer_q(caches)
        moved = type(caches)(*(q[i] if n in variant else raw[i]
                               for i, n in enumerate(names)))
        del raw, q
        leaf_err = {n: _rel_rms(moved[names.index(n)], caches[names.index(n)])
                    for n in variant}
        logits, toks = _first_step(model, decode, tok, moved, gen)
        variants["+".join(variant)] = {
            "leaf_rel_rms_err": leaf_err,
            "first_step_logit_rel_rms_err": _rel_rms(logits, raw_logits),
            "first_step_flips": int((sharded_argmax(logits, model.rt, cfg.vocab_size)
                                     != sharded_argmax(raw_logits, model.rt,
                                                       cfg.vocab_size)).sum()),
            "decoded_token_agreement": (toks == raw_toks).float().mean().item()}
    return {"arch": cfg.name, "device": str(device), "batch": batch,
            "prompt_len": prompt_len, "gen": gen, "variants": variants,
            "raw_logit_rms": raw_logits.pow(2).mean().sqrt().item(),
            "raw_top2_margin_median": (top2[:, 0] - top2[:, 1]).median().item()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", help="the arch's small config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    res = run(args.arch, smoke=args.smoke, batch=args.batch,
              prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
              device=args.device)
    for name, v in res.pop("variants").items():
        print(json.dumps({"arch": res["arch"], "int8_on": name, **v}))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
