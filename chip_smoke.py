"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py                       # every phase, then the result
    python3 chip_smoke.py --phases encdec_vlm   # a slice's phases (moe, ssm,
                                                # runtime, encdec_vlm, padding,
                                                # pp, dryrun, examples) or phases
                                                # by name, in the same order,
                                                # each timed; no result line

1. Environment: the card's name and power limit, torch and CUDA
   versions, and the time the kernels took to build from csrc/.
2. Each CUDA kernel of the serving paths against its plain PyTorch
   version on the card, at the serving shapes: the int8 codec bit-equal
   (amax_block, quant_scaled and dequant_int8 also at ragged sizes and on
   views at every element offset 0-7, which take their scalar variant),
   flash attention within 3e-2 (bf16, on the tensor cores) and 2e-3 (f32,
   on the CUDA cores) of its plain output's largest magnitude, and no
   more than that absolute, at every head size it takes (without a mask
   and with a ragged key tile, the bound must also reject the output over
   the whole tiles only), the SSD chunk
   within 1e-4 of its plain output's largest magnitude (bf16 on the
   tensor cores, f32 on the CUDA cores; at the JAX suite's SSD shapes, at
   p = 100 / n = 16, also as column slices of one conv output, at the
   shapes that test the bf16 kernel's runs of heads, at mamba2-2.7b's
   prefill shape in bf16 and f32, and as the model hands them over at a
   mamba2-2.7b TP-2 rank's 40 heads and at hymba-1.5b's 32 heads of
   p 100, n 16 over 4 x 2048 tokens; flash also at hymba-1.5b's 25 Q / 5
   KV heads of 64, window 1024 over 2048 tokens, timed beside SDPA with
   the window as a boolean mask).  Each kernel is timed with CUDA events beside
   its bound, its plain version and, for flash attention and dequant_int8,
   one PyTorch call computing the same function (timed only; the port
   never calls it; a codec's yardstick counts only if it is bit-equal to
   the kernel, NaN in the same places); flash attention and the SSD chunk
   in bf16 and f32 inputs; quant_int8 and dequant_int8 at the KV leaf
   also by their device time from torch.profiler, and dequant_int8 from
   int8 to f32 at mamba2-2.7b's SSM state.
3. Smoke-size models on the card against the same models on the CPU:
   qwen2.5-3b, mamba2-2.7b and hymba-1.5b prefill and decode (f32, logits
   within 1e-3, equal tokens; hymba launches flash and the SSD chunk once
   per layer each), 3 hier + int8 training steps of the smoke mamba2 and
   hymba (losses within 1e-4), and 3 qwen training steps for each gradient sync of
   TRAIN_RUNS (hier, hier_pipelined, hier_zero1, hier_overlap and fsdp
   with int8 on the pod hop, hier_border_rs with bf16) through the same
   process groups (gloo for the CPU, NCCL for the card), losses within
   1e-4, and parameters within 1e-4 for the syncs before hier_overlap;
   hier_overlap and fsdp are held instead to the CPU's sync on the card's
   own gradients, bit-equal, and hier_overlap's hook executor to its sync
   after the backward, bit-equal (int8 AdamW parameters are reported:
   one rounding apart moves a value by up to lr); hier_zero1's f32 master
   and moments are bootstrapped from the same parameters on each side.
   Then the planned path of phase 5 (b) on the smoke model: its plan's
   hier_overlap on the per-leaf path, losses within 1e-4, the sync
   bit-equal to the CPU's on the card's gradients.
4. The serving paths at full width, random weights from a seed: qwen2.5-3b
   (36 layers) and mamba2-2.7b (64 layers) each prefill 4 requests of
   1024 tokens, hymba-1.5b (32 layers) 4 of 2048 (its window of 1024
   shorter than the prompt), move the cache (KV, conv + SSM state, or
   both) raw and int8 on the wire, and decode 16 tokens greedily from
   each.  The launch counters, per phase, must show every kernel on each
   path: flash attention and/or ssd_chunk once per layer per prefill,
   quant/dequant once per codec leaf per int8 transfer (2, or 4 for
   hymba), nothing per decode step, and every dequant_int8 launch in its
   vector variant.  Then, per model, a profile of one prefill and four
   decode steps.  Then tensor parallelism, TP ranks as processes that
   share the card through a gloo group (NCCL refuses two ranks of one
   communicator on one device; the kernels are built before the spawn,
   and the ranks load them): (a) qwen2.5-3b served at TP 2 (36 layers,
   the TP-1 draw with its vocabulary padded by zero rows), (b) at TP 4
   and 4 layers (2 KV heads over 4 ranks: the per-Q-head gather, a
   4-head cache, flash at 4 Q / 4 KV), each rank checked as the TP-1
   path is (launches per phase, the raw transfer exact, its cache shard
   shape), and the prefill logits within tp_logit_tol of the TP-1 run's
   at the same depth; TTFT, decode, peak memory and agreement printed per
   rank, labelled one-card gloo; (c) the f32 smoke model trained at TP 2,
   hier + int8, 3 steps on the card and on the CPU in the same world:
   losses and grad norms within 1e-4, the codec and pack kernels once per
   step on each rank's segment; then the SSM families: mamba2-2.7b served
   at TP 2 (SSM_TP_DEPTH = 16 of its 64 layers, to keep the script within
   ~10 minutes; 40 heads per rank), checked as TP 1 is,
   and in f32 against TP 1 with the gated norm over the same two channel
   groups (each rank takes it over its own channels, so TP 2 is another
   function than TP 1, ROADMAP R18; the bf16 difference from TP 1 is
   printed), logits within SSM_TP_F32_TOL, and the smoke
   mamba2 and hymba trained at TP 2 as (c) (their ranks share the loss;
   each rank's B/C copy takes its own gradient, R16, so not the norm).
   Flash is also checked at the TP paths' local heads (8 Q / 1 KV and
   4 Q / 4 KV at 4 x 1024).
5. The training paths at full width: ``repro_torch.launch.train.run``
   trains qwen2.5-3b on 4 x 1024 tokens for 4 steps in a world of one,
   through real pod and data groups of one member, once per gradient sync
   of TRAIN_RUNS.  Every step must launch pack_slots once for its one bf16
   gradient segment, amax_block, quant_scaled and dequant_int8 once per
   pod-hop chunk with int8 (hier, hier_zero1: 1, hier_pipelined: 4) and not
   with bf16 (mamba2-2.7b, 64 layers, on 4 x 1024 and hymba-1.5b, 32
   layers, on 4 x 2048 train 4 hier + int8 steps too: two wire segments,
   bf16 and the f32 per-head leaves, so 2 packs and 2 of each codec
   kernel per step, no ssd_chunk and no flash (both train through their
   plain versions; ``--phases ssm`` also profiles a step of each, with
   the plain SSD's and the conv's ranges)); hier_overlap all four once per bucket of its partition_tree
   (38 for qwen2.5-3b under the 64 MiB cap), synced inside the backward;
   fsdp (nothing sharded over a data group of one) the codec once per
   leaf (14) and pack_slots once per per-layer leaf (12), which it syncs
   as its (L, ...) stack; and no flash attention, every amax_block, quant_scaled and
   dequant_int8 launch in its vector variant, with finite loss and grad
   norm and the finite gate open.  hier_zero1 quantizes the gradient
   segment cast to f32 and decodes it into f32 (the f32 master's shard);
   its bootstrap packs the parameters once, before the steps.  Each run's
   peak memory is printed beside the card's.  Then the planned paths, 3
   steps each: (a) ``run(plan="auto", skew="auto", plan_cache=...)`` as a
   user runs it on one card (the plan for ``tpu_multipod(1, 1)``: one
   bucket, no pod axis, the per-leaf path; no codec or pack launch), and a
   second launch on the same cache file, which must hit; (b) the plan the
   launcher makes for PLAN_WORLD (2 pods x 4 ranks), run in the world of
   one: hier_overlap on the per-leaf path, each bucket launching the codec
   once per chunk if it resolves to int8 (the embed bucket: 32 chunks),
   no pack_slots.  The per-leaf path's codec launches are reported as
   vector or scalar, not held to the vector variant.
6. The shared-scale codec at the gradient segment's size (more than 2^31
   elements): bit-equal to the plain versions chunk by chunk, edge cases
   (ragged, all-zero block, scale <= 0, .5 ties, +-127 s, NaN and +-inf
   blocks and scales, for both int8 codecs) bit-equal, and
   amax / quant_scaled / the int32 -> bf16 decode timed beside their bounds
   and, for amax and the decode, one PyTorch call (vector_norm(ord=inf),
   torch.mul into a bf16 out), if bit-equal; then the same on hier_zero1's
   f32 segment: amax / quant_scaled on f32 input and the int32 -> f32
   decode, in their vector variant.
7. Slot packing on the qwen2.5-3b gradient layout (one bf16 segment of
   more than 2^31 values) and at small sizes (f32 and bf16 leaves, list
   leaves, ragged leaves, an all-zero block; for fused_pack_quant also
   trees with more than 32 spans in a block, null spans in mid-block,
   unaligned sources and a table of more than 1024 rows): pack_slots
   bit-equal to its plain version, fused_pack_quant bit-equal to its plain
   version and to pack -> quant_int8; then the conformance check of the
   reference
   (OK-F: fused pack+quantize equals the composition) as a path of its
   own at the full layout; each timed beside its bound, and pack_slots
   against torch.cat in PACK_ROUNDS interleaved rounds, each sample
   printed, the medians compared.
8. Where the time goes: one training step per gradient sync under
   torch.profiler, qwen2.5-3b at full width and PROFILE_LAYERS of its 36
   layers, device time by kernel group and the device's idle
   share of the wall time (the serving profiles are part of phase 4);
   hier_zero1's bootstrap runs before the profiled window; the planned
   path (b) is profiled too, for its codec's device time.  For
   hier_overlap, how many bucket syncs (device-side grad_sync spans)
   began before the backward's last kernel, and the device time from the
   first bucket's codec kernel to that kernel's end.  Then one
   optimizer update per sync timed apart, free of the profiler's
   attribution of kernels to ranges.

9. MoE (qwen3-moe-30b-a3b: 48 layers, 128 experts top-8, d_model 2048,
   32 Q / 4 KV heads of dim 64), run where each phase of the script
   reaches it: (a) first on the emptied card, served at full width and
   depth (60.16 GB of bf16 weights drawn one bank at a time) through
   ``disaggregated.run`` and checked as the other serving paths (48
   flash launches per prefill, none per decode step, the codec twice per
   int8 transfer, the raw transfer exact), with finite logits, the peak
   under the card's memory, TTFT and decode beside their bounds, then a
   profile of one prefill and one decode step by MoE range (routing,
   pack, expert matmuls, combine) and the tokens each layer dropped at
   capacity; flash is also checked and timed at its prefill heads (32 Q
   / 4 KV, and 16 Q / 2 KV per TP-2 rank); (b) the f32 smoke MoE models
   (qwen3-moe, and mixtral with its window of 32) with phase 3's checks,
   training held on losses and aux (int8 AdamW parameters reported);
   (c) with phase 5, qwen3-moe cut to MOE_LAYERS layers trained with
   hier + int8 (two wire segments: bf16, and the f32 routers); (d) with
   phase 4's TP ranks, the smoke MoE trained at TP 2 by expert
   parallelism against the CPU, and qwen3-moe at MOE_LAYERS layers served
   at TP 2 (expert parallelism, the All2All over the TP group) against
   TP 1 at capacity factor MOE_TP_FACTOR (no token can drop), the
   last-token logits within ``tp_logit_tol`` plus MOE_FLIP_TOL per router
   flip at the token.
10. Runtime robustness, after the planned paths: (a) qwen2.5-3b at full
   width and CHAOS_LAYERS layers trained with hier + int8 under the
   collective guard and seed
   CHAOS_SEED's chaos plan for CHAOS_STEPS steps: each fault class that
   fires is logged, the transient costs one retry, the hang is caught and
   charged to rank 0, no other guard event, every loss finite, and the
   guard's host milliseconds per step printed, split into the CRC32 and
   the finiteness check; a NaN block through the int8 codec decodes on
   the card as on the CPU (ROADMAP R20); (b) checkpoint and resume at
   CKPT_LAYERS layers: save_async, save and restore timed, with the
   state's GB, the resumed losses bit-equal to an uninterrupted run's;
   (c) four ranks as 2 pods x 2 data on the card over gloo, hier_zero1 +
   int8 at ELASTIC_LAYERS layers: pod 1 lost before step ELASTIC_FAIL,
   the ZeRO-1 state carried through the slot map (the identity here: the
   data group keeps its 2 ranks), each survivor's losses
   bit-equal to a survivor run restored from the failure step's
   checkpoint; the re-plan, the failover's parts, the survivors' step, and
   per rank the launches and peak memory printed.  Phases (b) and (c)
   check the free disk first.  Their launches are the kernels line's
   paths ``train_chaos``, ``train_resume`` and ``train_elastic``.  The
   three phases' seconds are printed.
11. The encoder-decoder and VLM families: (a) right after the MoE
   serving phase, on the emptied card, chameleon-34b served at full width
   and all 48 layers (34.29 B parameters, 68.59 GB of bf16 weights drawn
   one leaf at a time; 64 Q / 8 KV heads of 128 with QK-norm), then
   whisper-tiny (4 encoder and 4 decoder layers, d_model 384, 6 heads):
   4 x 1024-token prompts (and 4 x 1500 frame embeddings from the stub
   audio frontend for whisper), 16 greedy steps, disaggregated, the cache
   raw and int8 on the wire, checked as the other serving paths: flash
   once per decoder layer per prefill (whisper: also once per encoder
   layer and once per cross-attention, 12 per prefill, the encoder and
   the cross-attention without a mask over 1500 keys), the codec twice
   per int8 transfer (whisper: four times, its cross cache's k and v
   too), nothing per decode step; the layers served and the peak memory
   printed; (b) with phase 5, whisper-tiny trained at full width (4 x 1024
   tokens, 4 x 1500 frames) and chameleon-34b at VLM_TRAIN_LAYERS of its
   48 layers, 4 hier + int8 steps each, launches per step as qwen's hier
   row (no flash: training attention is plain).  Phase 2 checks and times
   flash at the four new shapes (whisper's encoder, cross-attention and
   decoder, chameleon's prefill) and phase 3 holds both smoke models on the
   card against the CPU, whisper with 130 frames.
12. Head padding under tensor parallelism and GPipe, after the SSM
   families' TP phases (``--phases padding``, ``--phases pp``):
   hymba-1.5b served at TP 8 at full width and all 32 layers (25 Q heads
   padded to 32, its 5 KV heads replicated and gathered per Q head: 4 Q /
   4 KV and 4 SSM heads a rank), 8 spawned ranks on the card over gloo,
   4 x 2048 tokens, the cache raw and int8, PAD_GEN greedy tokens, each rank
   checked as the TP-1 path is (32 flash and 32 ssd_chunk launches per
   prefill, 4 of each codec kernel per transfer, none in decode, its
   cache shard at the padded local heads); then the same 8-rank world in
   f32 at PAD_F32_LAYERS layers, the tree drawn on the CPU and copied to
   the card: last-token logits within PAD_F32_TOL of the CPU's largest,
   equal greedy tokens (the padded heads draw another tree than TP 1, and
   TP 8 maps Q to KV heads otherwise, ROADMAP R23, so TP 1 is no
   oracle); whisper-tiny served at TP 4 (6 heads padded to 8, 2 Q / 2 KV
   a rank) through the int8 transfer; the smoke hymba trained at TP 8
   against the CPU (hier + int8, losses within 1e-4); and GPipe over a
   pod group of 2 (``parallel/pipeline.py``, two ranks over gloo, the
   handoff through the host) against one process computing every layer,
   in f32, as the reference's ``check_pipeline_pp.py`` holds its own:
   loss within rtol 1e-5, both stages' gradients within rtol 2e-4, atol
   2e-5.  Phase 2 checks and times flash at a hymba TP-8 rank (4 Q / 4
   KV, window 1024) and a whisper TP-4 rank (encoder, cross, decoder),
   the SSD chunk at a hymba TP-8 rank's 4 heads, and the codec at those
   ranks' KV leaves.

13. The dry run (``--phases dryrun``, which runs the hier + int8 training
   phase first), each cell a subprocess of its own (one fake world per
   process), the three started together after phase 2's kernel timings
   (they trace on host cores, so they run beside the phases on the card)
   and held right after the training phases: (a) the cell
   function under ``lower_cell`` in a fake world of one, qwen2.5-3b at 4 x
   1024 with hier + int8 traced on the card's path, shapes only: its
   predicted peak within DRYRUN_PEAK_TOL of the hier + int8 phase's
   measured peak, its shape-only kernel calls equal to that phase's
   launches per step, nothing launched; (b) ``python -m
   repro_torch.launch.dryrun`` for qwen2.5-3b ``train_4k`` on the 512-rank
   multi-pod mesh with ``--plan auto``; (c) the same for qwen3-moe-30b-a3b
   ``prefill_32k``, one shape-only flash call a layer.  Each cell's
   seconds, peak, FLOPs and collective bytes are printed; its roofline
   prices the H100 with assumed link rates, an estimate, not a
   measurement.
14. The examples (``--phases examples``), their processes one after
   another in a thread of their own, started with EXAMPLES_FROM and run
   beside the host-bound TP phases that follow it, their phases held
   before the 8-rank TP phases (alone, nothing runs beside them):
   ``examples/torch_quickstart.py`` on 8 spawned ranks as 2 pods x 2
   data x 2 model over gloo on the card, then on the CPU (every synced
   buffer, the int8 sync's included, bit-equal to the CPU's, every line
   equal, the flat sum within 1e-5 of the host's, the int8 sync launches
   amax_block, quant_scaled and dequant_int8 once a rank);
   ``examples/torch_train_lm.py --hundred-m --steps 300`` as a process
   of its own, first (one pack_slots a step, the loss falls; step ms,
   tokens/s and peak printed), then at its phase one step of its model
   profiled with nothing beside it (idle share);
   ``examples/torch_serve_disaggregated.py`` on the 8 ranks in bf16 at
   EXAMPLE_PROMPT tokens, then in f32 on the card and on the CPU in one
   world: per rank flash once per layer per prefill, the codec once per
   int8 leaf per int8 transfer, nothing in decode, and the card's tokens
   equal to the CPU's on every path (the bf16 rank's flash and codec
   shapes are among phase 2's cases).

Any failed check raises, and the script exits non-zero without printing
its result line.  The last line is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import dataclasses
import gc
import importlib
import json
import math
import os
import pathlib
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import collectives, compression, overlap, packing  # noqa: E402
from repro_torch.data.pipeline import DataConfig, synth_batch  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.mesh import runtime_for_groups, spawn_world, survivor_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import ssm as ssm_model  # noqa: E402
from repro_torch.parallel import pipeline  # noqa: E402
from repro_torch.parallel.sharding import reduce_from_tp  # noqa: E402
from repro_torch.runtime import guard as guard_lib  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.serve import disaggregated  # noqa: E402
from repro_torch.serve.serve_step import make_serve_steps  # noqa: E402
from repro_torch.train import loss as loss_lib  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import train_step  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainConfig, load_state, make_train_step, state_like, state_shardings, zero_bootstrap)

# NVIDIA H100 SXM data sheet, dense rates without sparsity
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-3}

ARCH = "qwen2.5-3b"
SSM_ARCH = "mamba2-2.7b"
HYBRID_ARCH = "hymba-1.5b"
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_SMOKE_ARCHS = (MOE_ARCH, "mixtral-8x7b")    # mixtral's smoke: a window of 32
ENCDEC_ARCH = "whisper-tiny"
VLM_ARCH = "chameleon-34b"
# the kernels each serving path launches once per layer per prefill
# (whisper's flash: once per encoder layer, and twice per decoder layer,
# self- and cross-attention: prefill_launches)
PATH_KERNELS = {ARCH: ("flash_attention_bhsd",), SSM_ARCH: ("ssd_chunk",),
                HYBRID_ARCH: ("flash_attention_bhsd", "ssd_chunk"),
                MOE_ARCH: ("flash_attention_bhsd",), "mixtral-8x7b": ("flash_attention_bhsd",),
                ENCDEC_ARCH: ("flash_attention_bhsd",), VLM_ARCH: ("flash_attention_bhsd",)}
BATCH, PROMPT, GEN = 4, 1024, 16
ENC_FRAMES = 1500       # whisper-tiny's encoder frames per request (its enc_seq)
# hymba serves and trains 4 x 2048 tokens, so that its 1024-token window is
# shorter than the prompt (flash's window branch, the ring cache)
HYBRID_SEQ = 2048
# head padding under TP: hymba-1.5b served at TP 8 (25 -> 32 Q heads, its 5
# KV heads replicated and gathered per Q head), then the same world in f32
# at PAD_F32_LAYERS layers on the card and on the CPU (PAD_F32_PROMPT
# tokens, longer than the 1024-token window); whisper-tiny served at TP 4
# (6 -> 8 heads, 2 Q / 2 KV a rank)
PAD_SERVE = {HYBRID_ARCH: 8, ENCDEC_ARCH: 4}
# greedy tokens of the padded serving phases: a decode step of hymba-1.5b on
# 8 one-card gloo ranks took 2.84 s (97 collectives a step, each a CUDA
# tensor staged through the host while 8 processes share the card), so its
# 3 x 16 steps would take ~136 s of the script's budget; it decodes 4
PAD_GEN = {HYBRID_ARCH: 4, ENCDEC_ARCH: GEN}
PAD_F32_LAYERS, PAD_F32_PROMPT, PAD_F32_GEN = 4, 1280, 4
PAD_F32_TOL = 1e-3      # of the CPU's largest logit
# GPipe over a pod group of 2 (2 ranks on the card over gloo) against one
# process computing every layer: layers, width, MLP width, microbatches,
# rows per microbatch, sequence
PP_L, PP_D, PP_FF, PP_M, PP_BM, PP_S = 4, 1024, 4096, 4, 4, 256
# the parameters of the full-width models (the reference's tree; for the SSM
# families ModelConfig.param_count() plus the norms, conv biases and per-head
# leaves)
FULL_PARAMS = {ARCH: 3_085_938_688, SSM_ARCH: 2_702_640_640, HYBRID_ARCH: 1_588_950_592,
               ENCDEC_ARCH: 49_085_952, VLM_ARCH: 34_293_424_128}
# the smoke configs held on the card against the CPU, with what they change:
# chameleon's smoke heads of 8 are below the flash kernel's smallest head
# size (16), so its check runs them at 16 (8 Q / 2 KV heads of 16 over
# d_model 64)
SMALL_OVERRIDES = {VLM_ARCH: {"d_head": 16}}
# chameleon-34b trains at this depth (about 2.46 B parameters, below
# qwen2.5-3b's 3.09 B, which trains on one card); it serves at all 48
VLM_TRAIN_LAYERS = 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 4
# (gradient sync, pod-hop codec) of the training paths
TRAIN_RUNS = [("hier", "int8"), ("hier_pipelined", "int8"), ("hier_border_rs", "bf16"),
              ("hier_zero1", "int8"), ("hier_overlap", "int8"), ("fsdp", "int8")]
PACK_ROUNDS = 6       # interleaved rounds of pack_slots against torch.cat
PLANNED_STEPS = 3
# the cluster (pods, ranks per pod) the planned path with kernels is priced
# for: the plan the launcher would make there, run in the world of one
PLAN_WORLD = (2, 4)
# the syncs whose small-model check holds the sync itself bit-equal to the
# CPU's on the same gradients (check_sync_parity) in place of parameters
SYNC_PARITY_MODES = ("hier_overlap", "fsdp")
# the serve example's prompt on the card: from FLASH_MIN_Q (128) tokens
# the prefill takes the flash kernel, and each rank's k and v leaf holds
# 2 x 1 x 128 x 1 x 16 = 4096 values, over the codec's 1024-value block;
# at the reference's 16 tokens neither runs (the CPU tests run that size)
EXAMPLE_PROMPT = 128
# a serve example rank's k or v leaf (the smoke qwen2.5-3b at TP 2):
# (layers, batch, tokens, KV heads, head size)
EXAMPLE_KV_LEAF = (2, 1, EXAMPLE_PROMPT, 1, 16)


def grad_layout(cfg) -> dict[str, int]:
    """The gradient layout of ``cfg``'s parameters, from their shapes alone
    (drawn under FakeTensorMode, nothing allocated): hier_overlap's buckets
    under the default cap, the leaves, the list leaves (per-layer
    parameters, each one stacked (L, ...) leaf) and the packed segments
    (one per wire dtype: bf16, and f32 for an MoE model's routers)."""
    with FakeTensorMode():
        model = Model(cfg, device="cpu").init(0)
        leaves = model.train_leaves()
        buckets = overlap.partition_tree(model.param_tree(), TrainConfig().bucket_cap_mb << 20)
        segments = len({part.dtype for leaf in leaves for part in packing.leaf_parts(leaf)})
    return {"buckets": len(buckets), "leaves": len(leaves), "segments": segments,
            "list_leaves": sum(isinstance(leaf, list) for leaf in leaves)}


def train_kernels(mode: str, codec: str | None, cfg) -> dict[str, int]:
    """Launches per training step of ``cfg``'s model in a world of one.
    The packed syncs pack each gradient segment (one per wire dtype) and
    run the shared-scale codec once per segment and pod-hop chunk;
    hier_overlap packs and codes each bucket; fsdp (nothing sharded in a
    world of one) syncs leaf by leaf, packing each list leaf into its
    stack."""
    layout = grad_layout(cfg)
    chunks = TrainConfig().n_chunks if mode == "hier_pipelined" else 1
    packs, syncs = layout["segments"], layout["segments"] * chunks
    if mode == "hier_overlap":
        packs = syncs = layout["buckets"]
    elif mode == "fsdp":
        packs, syncs = layout["list_leaves"], layout["leaves"]
    n = syncs if codec == "int8" else 0
    return {"pack_slots": packs, "amax_block": n, "quant_scaled": n, "dequant_int8": n,
            "quant_int8": 0, "fused_pack_quant": 0, "flash_attention_bhsd": 0,
            "ssd_chunk": 0}


def bootstrap_kernels(mode: str) -> dict[str, int]:
    """Launches before the steps: hier_zero1 packs the parameters once for
    its f32 master."""
    return {"pack_slots": 1} if mode == "hier_zero1" else {}


def planned_kernels(planned, cfg) -> dict[str, int]:
    """Launches per training step of a planned per-leaf sync of ``cfg``'s
    model in a world of one (a pod group of one member where the plan has
    a pod axis): each buffer the sync re-flattens resolves its schedule by
    its size, as ``BoundPlan.config_for`` does, and runs the codec once
    per pod-hop chunk if that is int8; nothing is packed.  hier_overlap
    re-flattens each bucket of its partition_tree into f32, the others
    each dtype's leaves in their dtype."""
    check(not planned.packed, f"planned path packed: {planned}")
    with FakeTensorMode():
        model = Model(cfg, device="cpu").init(0)
        if planned.mode == "hier_overlap":
            tree = model.param_tree()
            specs = overlap.partition_tree(tree, TrainConfig().bucket_cap_mb << 20)
            metas = overlap._bucket_pieces(tree, specs)[2]
            sizes = [4 * sum(size for _, _, size in bm) for bm in metas]
        else:
            by_dtype: dict = {}
            for leaf in model.train_leaves():
                for part in packing.leaf_parts(leaf):
                    by_dtype[part.dtype] = (by_dtype.get(part.dtype, 0)
                                            + part.numel() * part.element_size())
            sizes = list(by_dtype.values())
    n = 0
    for nbytes in sizes:
        c = planned.plan.bucket_for(nbytes).candidate
        if c.compression == "int8" and planned.plan.pod_axis is not None:
            n += c.n_chunks if c.mode == "hier_pipelined" else 1
    return {"pack_slots": 0, "amax_block": n, "quant_scaled": n, "dequant_int8": n,
            "quant_int8": 0, "fused_pack_quant": 0, "flash_attention_bhsd": 0,
            "ssd_chunk": 0}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time per call of ``fn`` from torch.profiler: the time its
    kernels ran, without the host's pace.  The mean is taken over the
    kernels the profiler recorded (it may drop one now and then), times
    the kernels per call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0
           and not ev.is_user_annotation]
    count = sum(ev.count for ev in evs)
    check(count > 0, "the profiler recorded no kernel")
    per_call = max(1, round(count / iters))
    return sum(ev.self_device_time_total for ev in evs) / count * per_call / 1e3


def rate_tbs(row: dict) -> float:
    """The bytes of a bytes-bound row's bound moved in its measured time, TB/s."""
    return PEAK_BYTES_PER_S * row["bound_ms"] / row["ms"] / 1e12


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaN (of any payload) in the same places."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = a.isnan()
    return bool(torch.equal(nan, b.isnan())
                and torch.equal(a.view(_INT_VIEW[a.dtype])[~nan],
                                b.view(_INT_VIEW[b.dtype])[~nan]))


def mul_decode(q: torch.Tensor, s: torch.Tensor, dtype) -> tuple:
    """dequant_int8's one-call library version for a whole-block payload:
    torch.mul(q, s) rounded into a ``dtype`` out; returns (out, the call)."""
    nb = q.shape[0]
    out = torch.empty(q.shape, dtype=dtype, device=q.device)

    def call():
        torch.mul(q, s.view(nb, 1), out=out)
    call()
    return out.view(-1), call


def yardstick(fn, bit_equal: bool, what: str, iters: int) -> float | None:
    """``fn``'s time if it is bit-equal to the kernel (else None, said)."""
    if not bit_equal:
        print(f"[time] {what}: not bit-equal to the kernel, so no yardstick")
        return None
    return time_ms(fn, iters)


def check_library_nan(dev) -> dict[str, bool]:
    """Whether the one-call library versions of amax_block and dequant_int8
    agree with the kernels bit for bit on blocks holding NaN, +-inf and
    +-0 (values, and scales for the decode)."""
    nan, inf = float("nan"), float("inf")
    x = torch.randn(4 * 1024, device=dev)
    x[5], x[1024 + 7], x[2048 + 9], x[3072 + 1], x[3072 + 2] = nan, inf, -inf, nan, -0.0
    agree = {}
    xb = x.to(torch.bfloat16)
    lib = torch.linalg.vector_norm(xb.view(4, 1024), ord=inf, dim=1, dtype=torch.float32)
    agree["amax_block"] = bits_equal(lib, quant.amax_block_call(xb))
    s = torch.tensor([0.5, nan, inf, -0.25], device=dev)
    ok = True
    for qdt in (torch.int8, torch.int32):
        q = torch.randint(-127, 128, (4, 1024), device=dev).to(qdt)
        q[:, :3] = 0
        for dt in (torch.bfloat16, torch.float32):
            ok &= bits_equal(mul_decode(q, s, dt)[0], quant.dequant_int8_call(q, s, 4096, dt))
    agree["dequant_int8"] = ok
    print(f"[check] one-call library versions bit-equal to the kernels with NaN, +-inf, "
          f"+-0: {agree}")
    return agree


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def check_codec(dev, gen, agree: dict[str, bool]) -> dict:
    cfg = get_config(ARCH)
    leaf = (cfg.n_layers, BATCH, PROMPT, cfg.n_kv_heads, cfg.head_dim)
    x = torch.randn(leaf, device=dev, generator=gen).to(torch.bfloat16)
    ragged = torch.randn(37 * 1024 + 5, device=dev, generator=gen) * 50
    ragged[1024:2048] = 0                                   # an all-zero block
    example = torch.randn(EXAMPLE_KV_LEAF, device=dev, generator=gen)
    cases = [("kv leaf bf16", x), ("ragged f32 with a zero block", ragged),
             ("ragged bf16", ragged.to(torch.bfloat16)),
             ("serve example rank's kv leaf bf16", example.to(torch.bfloat16)),
             ("serve example rank's kv leaf f32", example)]
    for name, t in cases:
        q, s = quant.quant_int8_call(t)
        pq, ps = quant.quant_int8_plain(t)
        check(torch.equal(q, pq) and torch.equal(s, ps), f"quant_int8 {name}")
        for qq, gain, label in ((q, None, "int8"), (q.int() * 5, 0.125, "int32+gain")):
            got = quant.dequant_int8_call(qq, s, t.numel(), t.dtype, gain)
            want = quant.dequant_int8_plain(qq, s, t.numel(), t.dtype, gain)
            check(torch.equal(got, want), f"dequant_int8 {name} {label}")
        print(f"[check] quant/dequant {name} ({t.numel()} elements): bit-equal")
    check(bool((quant.quant_int8_call(ragged)[1][1] == 1.0).item()),
          "all-zero block scale")

    n = x.numel()
    q, s = quant.quant_int8_call(x)
    nb = q.shape[0]
    check(n == nb * 1024, f"the KV leaf {n} is not whole blocks")
    lib_out, lib_call = mul_decode(q, s, torch.bfloat16)
    lib_equal = agree["dequant_int8"] and torch.equal(
        lib_out, quant.dequant_int8_call(q, s, n, torch.bfloat16))
    iters = 50
    quant_row = {
        "name": "quant_int8", "route": "cuda", "source": "src/repro_torch/csrc/quant.cu",
        "replaces": "src/repro/kernels/quant.py:72",
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: quant.quant_int8_call(x), iters),
        "device_ms": device_ms(lambda: quant.quant_int8_call(x)),
        "plain_ms": time_ms(lambda: quant.quant_int8_plain(x), iters // 5),
        # read the bf16 leaf once, write q and s once
        "bound_ms": (2 * n + nb * 1024 + 4 * nb) / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
    }
    dequant_row = {
        "name": "dequant_int8", "route": "cuda", "source": "src/repro_torch/csrc/quant.cu",
        "replaces": "src/repro/kernels/quant.py:172",
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: quant.dequant_int8_call(q, s, n, torch.bfloat16), iters),
        "device_ms": device_ms(lambda: quant.dequant_int8_call(q, s, n, torch.bfloat16)),
        "plain_ms": time_ms(lambda: quant.dequant_int8_plain(q, s, n, torch.bfloat16),
                            iters // 5),
        "bound_ms": (nb * 1024 + 4 * nb + 2 * n) / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": yardstick(lib_call, lib_equal, "torch.mul int8 -> bf16", iters),
        "library_device_ms": device_ms(lib_call) if lib_equal else None,
    }
    del lib_out, lib_call
    # the KV leaves a padded TP rank moves: a hymba-1.5b TP-8 rank's (its
    # window, 4 gathered heads) and a whisper-tiny TP-4 rank's cross leaf
    # (1500 frames, 2 heads)
    for key, (arch, tp, window) in (("hymba_tp8_kv_leaf", (HYBRID_ARCH, 8, 1024)),
                                    ("whisper_tp4_cross_leaf", (ENCDEC_ARCH, 4, ENC_FRAMES))):
        pcfg = get_config(arch)
        kl = pcfg.local_q_heads(tp) if pcfg.kv_replicated(tp) else pcfg.padded_kv_heads(tp) // tp
        t = torch.randn(pcfg.n_layers, BATCH, window, kl, pcfg.head_dim, device=dev,
                        generator=gen).to(torch.bfloat16)
        q, s = quant.quant_int8_call(t)
        pq, ps = quant.quant_int8_plain(t)
        n, nb = t.numel(), q.shape[0]
        check(torch.equal(q, pq) and torch.equal(s, ps) and n == nb * 1024,
              f"quant_int8 at the {key}")
        out = quant.dequant_int8_call(q, s, n, torch.bfloat16)
        check(torch.equal(out, quant.dequant_int8_plain(q, s, n, torch.bfloat16)),
              f"dequant_int8 at the {key}")
        lib_out, lib_call = mul_decode(q, s, torch.bfloat16)
        lib_equal = agree["dequant_int8"] and torch.equal(lib_out, out)
        quant_row[key] = {
            "shape": list(t.shape), "max_abs_err": 0.0,
            "ms": time_ms(lambda: quant.quant_int8_call(t), iters),
            "device_ms": device_ms(lambda: quant.quant_int8_call(t)),
            "plain_ms": time_ms(lambda: quant.quant_int8_plain(t), iters // 5),
            "bound_ms": (2 * n + nb * 1024 + 4 * nb) / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None}
        dequant_row[key] = {
            "shape": list(t.shape), "max_abs_err": 0.0,
            "ms": time_ms(lambda: quant.dequant_int8_call(q, s, n, torch.bfloat16), iters),
            "device_ms": device_ms(lambda: quant.dequant_int8_call(q, s, n, torch.bfloat16)),
            "plain_ms": time_ms(lambda: quant.dequant_int8_plain(q, s, n, torch.bfloat16),
                                iters // 5),
            "bound_ms": (nb * 1024 + 4 * nb + 2 * n) / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": yardstick(lib_call, lib_equal, "torch.mul int8 -> bf16", iters)}
        for name, row in (("quant_int8", quant_row[key]), ("dequant_int8", dequant_row[key])):
            lib_ms = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
            print(f"[time] {name} at the {key} {tuple(t.shape)}: {row['ms']:.4f} ms, device "
                  f"{row['device_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms (bytes), plain "
                  f"{row['plain_ms']:.4f} ms, library {lib_ms} ms")
        del t, q, s, out, lib_out, lib_call
    # the decode of mamba2-2.7b's f32 SSM state, int8 -> f32
    scfg = get_config(SSM_ARCH)
    ssm = torch.randn(scfg.n_layers, BATCH, scfg.d_inner // scfg.ssm_head_dim,
                      scfg.ssm_head_dim, scfg.ssm_state, device=dev, generator=gen)
    q, s = quant.quant_int8_call(ssm)
    n, nb = ssm.numel(), q.shape[0]
    check(n == nb * 1024, f"the SSM state {n} is not whole blocks")
    out = quant.dequant_int8_call(q, s, n, torch.float32)
    check(torch.equal(out, quant.dequant_int8_plain(q, s, n, torch.float32)),
          "dequant_int8 int8 -> f32 at the SSM state")
    lib_out, lib_call = mul_decode(q, s, torch.float32)
    lib_equal = agree["dequant_int8"] and torch.equal(lib_out, out)
    dequant_row["ssm_state_f32"] = {
        "ms": time_ms(lambda: quant.dequant_int8_call(q, s, n, torch.float32), iters // 5),
        "device_ms": device_ms(lambda: quant.dequant_int8_call(q, s, n, torch.float32)),
        "plain_ms": time_ms(lambda: quant.dequant_int8_plain(q, s, n, torch.float32), 5),
        # read the int8 blocks and the scales, write the f32 values
        "bound_ms": (nb * 1024 + 4 * nb + 4 * n) / PEAK_BYTES_PER_S * 1e3,
        "library_ms": yardstick(lib_call, lib_equal, "torch.mul int8 -> f32", iters // 5)}
    return {"quant_int8": quant_row, "dequant_int8": dequant_row}


# ragged sizes around the 1024-value block and the 8192-value tile, and one
# of more tiles than the vector kernels' grid has CTAs (the grid stride)
VIEW_SIZES = [1, 7, 1023, 1024, 1025, 8191, 3 * 1024 + 13, 12 * 2 ** 20 + 333]


def _at_offset(t: torch.Tensor, off: int) -> torch.Tensor:
    """``t``'s values as a view ``off`` elements into a new buffer."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    check(buf.data_ptr() % quant.VECTOR_ALIGN == 0, "buffer alignment")
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


def check_codec_views(dev, gen) -> None:
    """amax_block, quant_scaled and dequant_int8 at ragged sizes and on
    views at every element offset 0-7, bit-equal to their plain versions,
    with NaN and +-inf values and 0, NaN, inf and negative scales; each
    launch takes the variant its base's alignment calls for."""
    nan, inf = float("nan"), float("inf")
    n_vector = n_scalar = 0
    for n in VIEW_SIZES:
        nb = -(-n // 1024)
        scale = torch.rand(nb, device=dev, generator=gen) * 0.05 + 1e-3
        scale[::5], scale[1::7], scale[2::11], scale[3::13] = 0.0, nan, inf, -1.0
        xs = torch.randn(n, device=dev, generator=gen) * 3
        xs[::997], xs[1::1499], xs[2::1789] = nan, inf, -inf
        # NaN and +-inf in a few blocks only, so most block maxima stay finite
        xa = torch.randn(n, device=dev, generator=gen) * 3
        i = torch.arange(n, device=dev)
        xa[i % 5003 == 17], xa[i % 7919 == 100], xa[i % 6007 == 2000] = nan, inf, -inf
        qs = {torch.int8: torch.randint(-127, 128, (nb, 1024), device=dev, generator=gen),
              torch.int32: torch.randint(-1016, 1017, (nb, 1024), device=dev, generator=gen)}
        for off in range(8):
            for dt in (torch.float32, torch.bfloat16):
                xv = _at_offset(xs.to(dt), off)
                vector = off * xv.element_size() % 16 == 0
                fn = quant.quant_scaled_call
                before = fn.launches, fn.vector_launches
                check(torch.equal(fn(xv, scale), quant.quant_scaled_plain(xv, scale)),
                      f"quant_scaled n={n} offset {off} {dt}")
                check((fn.launches, fn.vector_launches) == (before[0] + 1, before[1] + vector),
                      f"quant_scaled n={n} offset {off} {dt}: variant")
                n_vector, n_scalar = n_vector + vector, n_scalar + (not vector)
                xv = _at_offset(xa.to(dt), off)
                fn = quant.amax_block_call
                before = fn.launches, fn.vector_launches
                check(bits_equal(fn(xv), quant.amax_block_plain(xv)),
                      f"amax_block n={n} offset {off} {dt}")
                check((fn.launches, fn.vector_launches) == (before[0] + 1, before[1] + vector),
                      f"amax_block n={n} offset {off} {dt}: variant")
                n_vector, n_scalar = n_vector + vector, n_scalar + (not vector)
            for qdt, q in qs.items():
                qv = _at_offset(q.to(qdt), off)
                vector = off * qv.element_size() % 16 == 0
                for dt in (torch.float32, torch.bfloat16):
                    for gain in (None, 0.37):
                        fn = quant.dequant_int8_call
                        before = fn.launches, fn.vector_launches
                        check(bits_equal(fn(qv, scale, n, dt, gain),
                                         quant.dequant_int8_plain(qv, scale, n, dt, gain)),
                              f"dequant_int8 n={n} offset {off} {qdt} -> {dt} gain {gain}")
                        check((fn.launches, fn.vector_launches)
                              == (before[0] + 1, before[1] + vector),
                              f"dequant_int8 n={n} offset {off} {qdt}: variant")
                        n_vector, n_scalar = n_vector + vector, n_scalar + (not vector)
    print(f"[check] amax_block, quant_scaled and dequant_int8 at sizes {VIEW_SIZES} on views "
          f"at offsets 0-7 (f32/bf16 in; int8/int32 -> f32/bf16 out, gain or none; NaN, +-inf "
          f"values, "
          f"0/NaN/inf/negative scales): bit-equal; {n_vector} launches took the vector "
          f"variant and {n_scalar} the scalar one, as the bases' alignment calls for")


FLASH_CASES = [
    # (B, H, K, Sq, Skv, dh, causal, window, q_offset, valid_kv, dtype)
    (BATCH, 16, 2, PROMPT, PROMPT, 128, True, None, 0, None, torch.bfloat16),
    (BATCH, 16, 2, PROMPT, PROMPT, 128, True, None, 0, None, torch.float32),
    (2, 8, 2, 130, 130, 128, True, 64, 0, None, torch.float32),
    (2, 16, 2, 128, 512, 128, True, None, 300, 420, torch.bfloat16),
    (2, 8, 2, 256, 256, 64, True, None, 0, None, torch.bfloat16),
    (1, 4, 1, 192, 192, 80, False, None, 0, None, torch.float32),
    # bf16 on the tensor cores at the other head sizes, ragged lengths off
    # the 64-row and 64-key tiles, a window, H/K = 8
    (2, 8, 1, 130, 200, 16, True, None, 70, 190, torch.bfloat16),
    (2, 8, 2, 130, 130, 64, True, 64, 0, None, torch.bfloat16),
    (1, 4, 1, 192, 192, 80, False, None, 0, None, torch.bfloat16),
    (2, 16, 2, 200, 200, 128, True, 100, 0, None, torch.bfloat16),
    # the TP paths' local heads at the qwen2.5-3b serving shape: TP 2 (8 Q /
    # 1 KV) and TP 4 (4 Q / 4 KV after the replicated-KV gather)
    (BATCH, 8, 1, PROMPT, PROMPT, 128, True, None, 0, None, torch.bfloat16),
    (BATCH, 4, 4, PROMPT, PROMPT, 128, True, None, 0, None, torch.bfloat16),
    # qwen3-moe-30b-a3b's prefill at head dim 64: TP 1 (32 Q / 4 KV) and each
    # rank of TP 2 (16 Q / 2 KV)
    (BATCH, 32, 4, PROMPT, PROMPT, 64, True, None, 0, None, torch.bfloat16),
    (BATCH, 16, 2, PROMPT, PROMPT, 64, True, None, 0, None, torch.bfloat16),
    # hymba-1.5b's prefill: 25 Q / 5 KV heads of 64, the 1024-token window
    # shorter than the 2048-token prompt
    (BATCH, 25, 5, HYBRID_SEQ, HYBRID_SEQ, 64, True, 1024, 0, None, torch.bfloat16),
    # whisper-tiny's prefill, 6 heads of 64: the encoder over 1500 frames and
    # the cross-attention of 1024 tokens over them (no mask; 1500 keys are
    # 23 x 64 + 28), the decoder's causal self-attention; chameleon-34b's
    # prefill, 64 Q / 8 KV heads of 128
    (BATCH, 6, 6, ENC_FRAMES, ENC_FRAMES, 64, False, None, 0, None, torch.bfloat16),
    (BATCH, 6, 6, PROMPT, ENC_FRAMES, 64, False, None, 0, None, torch.bfloat16),
    (BATCH, 6, 6, PROMPT, PROMPT, 64, True, None, 0, None, torch.bfloat16),
    (BATCH, 64, 8, PROMPT, PROMPT, 128, True, None, 0, None, torch.bfloat16),
    # head padding under TP: a hymba-1.5b TP-8 rank (4 of the 32 padded Q
    # heads, the 5 replicated KV heads gathered to one per Q head), in bf16
    # and at the f32 check's prompt, and a whisper-tiny TP-4 rank (2 Q / 2
    # KV of the 8 padded heads): its encoder, cross-attention and decoder
    (BATCH, 4, 4, HYBRID_SEQ, HYBRID_SEQ, 64, True, 1024, 0, None, torch.bfloat16),
    (1, 4, 4, PAD_F32_PROMPT, PAD_F32_PROMPT, 64, True, 1024, 0, None, torch.float32),
    (BATCH, 2, 2, ENC_FRAMES, ENC_FRAMES, 64, False, None, 0, None, torch.bfloat16),
    (BATCH, 2, 2, PROMPT, ENC_FRAMES, 64, False, None, 0, None, torch.bfloat16),
    (BATCH, 2, 2, PROMPT, PROMPT, 64, True, None, 0, None, torch.bfloat16),
    # a serve example rank (the smoke qwen2.5-3b at TP 2: 2 Q / 1 KV heads
    # of 16, one request of EXAMPLE_PROMPT tokens), bf16 and f32
    (1, 2, 1, EXAMPLE_PROMPT, EXAMPLE_PROMPT, 16, True, None, 0, None, torch.bfloat16),
    (1, 2, 1, EXAMPLE_PROMPT, EXAMPLE_PROMPT, 16, True, None, 0, None, torch.float32),
]
# the timed flash cases: (H, K, dh, dtype, Sq, Skv, causal, window) -> the
# row's key for its numbers (the first two are the row's own, bf16, and its
# "f32" entry) and the shape's name
FLASH_TIMED = {
    (16, 2, 128, torch.bfloat16, PROMPT, PROMPT, True, None): (None, "qwen2.5-3b prefill shape"),
    (16, 2, 128, torch.float32, PROMPT, PROMPT, True, None): ("f32", "qwen2.5-3b prefill shape"),
    (32, 4, 64, torch.bfloat16, PROMPT, PROMPT, True, None): (
        "qwen3_moe_tp1", "qwen3-moe-30b-a3b prefill shape at TP 1 (32 Q / 4 KV, dh 64)"),
    (16, 2, 64, torch.bfloat16, PROMPT, PROMPT, True, None): (
        "qwen3_moe_tp2", "qwen3-moe-30b-a3b prefill shape at TP 2 (16 Q / 2 KV, dh 64)"),
    (25, 5, 64, torch.bfloat16, HYBRID_SEQ, HYBRID_SEQ, True, 1024): (
        "hymba", f"hymba-1.5b prefill shape (25 Q / 5 KV, dh 64, {HYBRID_SEQ} tokens, "
                 f"window 1024)"),
    (6, 6, 64, torch.bfloat16, ENC_FRAMES, ENC_FRAMES, False, None): (
        "whisper_encoder", f"whisper-tiny encoder shape (6 heads, dh 64, {ENC_FRAMES} frames, "
                           f"no mask)"),
    (6, 6, 64, torch.bfloat16, PROMPT, ENC_FRAMES, False, None): (
        "whisper_cross", f"whisper-tiny cross-attention shape ({PROMPT} x {ENC_FRAMES}, "
                         f"6 heads, dh 64, no mask)"),
    (6, 6, 64, torch.bfloat16, PROMPT, PROMPT, True, None): (
        "whisper_decoder", f"whisper-tiny decoder self-attention shape ({PROMPT} tokens, "
                           f"6 heads, dh 64, causal)"),
    (64, 8, 128, torch.bfloat16, PROMPT, PROMPT, True, None): (
        "chameleon", "chameleon-34b prefill shape (64 Q / 8 KV, dh 128, causal)"),
    (4, 4, 64, torch.bfloat16, HYBRID_SEQ, HYBRID_SEQ, True, 1024): (
        "hymba_tp8", f"hymba-1.5b TP-8 rank's prefill shape (4 Q / 4 gathered KV, dh 64, "
                     f"{HYBRID_SEQ} tokens, window 1024)"),
    (2, 2, 64, torch.bfloat16, ENC_FRAMES, ENC_FRAMES, False, None): (
        "whisper_tp4_encoder", f"whisper-tiny TP-4 rank's encoder shape (2 of 8 padded heads, "
                               f"dh 64, {ENC_FRAMES} frames, no mask)"),
    (2, 2, 64, torch.bfloat16, PROMPT, ENC_FRAMES, False, None): (
        "whisper_tp4_cross", f"whisper-tiny TP-4 rank's cross-attention shape ({PROMPT} x "
                             f"{ENC_FRAMES}, 2 heads, no mask)"),
    (2, 2, 64, torch.bfloat16, PROMPT, PROMPT, True, None): (
        "whisper_tp4_decoder", f"whisper-tiny TP-4 rank's decoder self-attention shape "
                               f"({PROMPT} tokens, 2 heads, causal)")}


def flash_bound_ms(B, H, K, Sq, dh, q_offset, valid_kv, causal,
                   dtype, window: int | None = None) -> tuple[float, str]:
    """Least time for the work these inputs need: 4 flops per (q, k) pair
    and head dim over the unmasked pairs (causal, and inside the window),
    against reading q, k, v and writing o once."""
    def keys(i):
        hi = min(valid_kv, q_offset + i + 1) if causal else valid_kv
        lo = 0 if window is None else max(0, q_offset + i + 1 - window)
        return max(0, hi - lo)

    pairs = sum(keys(i) for i in range(Sq))
    flops = 4.0 * B * H * dh * pairs
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * B * dh * (2 * H * Sq + 2 * K * valid_kv)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_flash(dev, gen, smi: str) -> dict:
    main = {}
    for B, H, K, Sq, Skv, dh, causal, window, off, valid, dt in FLASH_CASES:
        q = torch.randn(B, H, Sq, dh, device=dev, generator=gen).to(dt)
        k = torch.randn(B, K, Skv, dh, device=dev, generator=gen).to(dt)
        v = torch.randn(B, K, Skv, dh, device=dev, generator=gen).to(dt)
        kw = dict(causal=causal, window=window, q_offset=off, valid_kv=valid)
        got = fa.flash_attention_bhsd(q, k, v, **kw)
        want = fa.flash_attention_bhsd_plain(q, k, v, **kw)
        err = (got.float() - want.float()).abs().max().item()
        # TOL of the output's largest magnitude, at most TOL: without a mask
        # over many keys each output is a mean of many values, small
        tol = TOL[dt] * min(1.0, want.float().abs().max().item())
        check(err <= tol, f"flash {B, H, K, Sq, Skv, dh, kw, dt}: err {err}, tol {tol}")
        tail = ""
        if Skv % 64 and not causal and valid is None:
            # the bound must see a kernel that drops the keys past the last
            # whole 64-key tile
            cut = Skv // 64 * 64
            lost = fa.flash_attention_bhsd(q, k[:, :, :cut], v[:, :, :cut], **kw)
            lost_err = (lost.float() - want.float()).abs().max().item()
            check(lost_err > tol, f"flash {B, H, K, Sq, Skv, dh, kw, dt}: the output over "
                                  f"{cut} keys errs by {lost_err}, within tol {tol}")
            tail = f"; over the first {cut} keys only it would err by {lost_err:.3g}"
        print(f"[check] flash B={B} H={H} K={K} Sq={Sq} Skv={Skv} dh={dh} "
              f"{kw} {dt}: max abs err {err:.3g} (tol {tol:.3g}){tail}")
        timed = (H, K, dh, dt, Sq, Skv, causal, window)
        if B == BATCH and off == 0 and timed in FLASH_TIMED:
            main[timed] = err, (q, k, v)
    timing = {}
    for (H, K, dh, dt, Sq, Skv, causal, window), (err, (q, k, v)) in main.items():
        bound, by = flash_bound_ms(BATCH, H, K, Sq, dh, 0, Skv, causal, dt, window)
        key, shape = FLASH_TIMED[(H, K, dh, dt, Sq, Skv, causal, window)]
        if window is None:
            library = lambda: F.scaled_dot_product_attention(   # noqa: E731
                q, k, v, is_causal=causal, enable_gqa=True)
        else:       # the causal window as a boolean mask
            pos = torch.arange(Sq, device=q.device)
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            library = lambda: F.scaled_dot_product_attention(   # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
        timing[key] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: fa.flash_attention_bhsd(q, k, v, causal=causal,
                                                          window=window), 20),
            "plain_ms": time_ms(lambda: fa.flash_attention_bhsd_plain(q, k, v, causal=causal,
                                                                      window=window), 5),
            "bound_ms": bound, "bound_by": by, "library_ms": time_ms(library, 20)}
        t = timing[key]
        print(f"[time] [{smi}] flash_attention_bhsd {shape}, {dt}: "
              f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({by}), plain "
              f"{t['plain_ms']:.4f} ms, F.scaled_dot_product_attention"
              f"{' with the window mask' if window else f' (is_causal={causal})'} "
              f"{t['library_ms']:.4f} ms")
    own = timing.pop(None)
    return {"flash_attention_bhsd": {
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:85", **own, **timing}}


SSD_CASES = [
    # (b, s, h, p, g, n, chunk, dtype, view): tests/test_kernels.py:46-52,
    # G = 2 with H = 8 (h // (H / G) is not h % G), p = 100 and n = 16 (a
    # shape check), the bf16 cases the tensor-core kernel's grid has to get
    # right (6 heads over 2 groups: runs of heads that do not divide the
    # group; G = 2, H = 8; q = 96; p = 100 and n = 16 as column slices of one
    # conv output, rows 8-byte aligned only), then the mamba2-2.7b prefill
    (2, 256, 4, 32, 1, 64, 64, torch.float32, False),
    (1, 128, 2, 64, 2, 32, 32, torch.float32, False),
    (1, 128, 8, 32, 2, 32, 32, torch.float32, False),
    (1, 256, 8, 64, 1, 128, 128, torch.float32, False),
    (2, 128, 4, 32, 1, 64, 64, torch.bfloat16, False),
    (2, 256, 4, 100, 1, 16, 128, torch.bfloat16, False),
    (1, 256, 6, 64, 2, 64, 64, torch.bfloat16, False),
    (1, 128, 8, 32, 2, 32, 32, torch.bfloat16, False),
    (1, 192, 4, 64, 1, 64, 96, torch.bfloat16, False),
    (2, 256, 4, 100, 1, 16, 128, torch.bfloat16, True),
    (BATCH, PROMPT, 80, 64, 1, 128, 128, torch.bfloat16, False),
    (BATCH, PROMPT, 80, 64, 1, 128, 128, torch.float32, False),
    # as the model hands them over (column slices of the conv output): a
    # mamba2-2.7b TP-2 rank's prefill (40 of the 80 heads) and hymba-1.5b's
    # prefill (32 heads of p 100, n 16, 4 x 2048 tokens)
    (BATCH, PROMPT, 40, 64, 1, 128, 128, torch.bfloat16, True),
    (BATCH, HYBRID_SEQ, 32, 100, 1, 16, 128, torch.bfloat16, True),
    # a hymba-1.5b TP-8 rank's 4 heads (d_inner 3200 / 8 channels), in bf16
    # and in f32 at the f32 check's prompt
    (BATCH, HYBRID_SEQ, 4, 100, 1, 16, 128, torch.bfloat16, True),
    (1, PAD_F32_PROMPT, 4, 100, 1, 16, 128, torch.float32, True),
]
# the timed SSD cases beside the row's own: (s, h, p) -> the row's key
SSD_TIMED = {(PROMPT, 40, 64): "mamba2_tp2", (HYBRID_SEQ, 32, 100): "hymba",
             (HYBRID_SEQ, 4, 100): "hymba_tp8"}
SSD_TOL = 1e-4      # of the plain output's largest magnitude


def ssd_inputs(dev, gen, b, s, h, p, g, n, dt, view=False):
    """x, dt, A, B, C; with ``view``, x, B and C are column slices of one
    (b, s, h p + 2 g n) tensor, as the model hands over its conv output."""
    if view:
        conv = torch.randn(b, s, h * p + 2 * g * n, device=dev, generator=gen).to(dt)
        x = conv[..., :h * p].unflatten(-1, (h, p))
        Bm = conv[..., h * p:h * p + g * n].unflatten(-1, (g, n))
        Cm = conv[..., h * p + g * n:].unflatten(-1, (g, n))
    else:
        x = torch.randn(b, s, h, p, device=dev, generator=gen).to(dt)
        Bm = Cm = None
    dtv = torch.rand(b, s, h, device=dev, generator=gen) * 0.19 + 0.01
    A = -(torch.rand(h, device=dev, generator=gen) * 3.5 + 0.5)
    if not view:
        Bm = torch.randn(b, s, g, n, device=dev, generator=gen).to(dt)
        Cm = torch.randn(b, s, g, n, device=dev, generator=gen).to(dt)
    return x, dtv, A, Bm, Cm


def ssd_bound_ms(b, s, h, p, g, n, q, dt) -> tuple[float, str]:
    """x, dt, A, B and C read once, y_diag and states written once in f32,
    against the products the function needs at the peak rate of the input
    type: C B^T once per (b, chunk, group) and scores x once per head,
    each over the causal half (j <= i), and x^T (B w) once per head."""
    elem = torch.finfo(dt).bits // 8
    nc = s // q
    nbytes = (elem * b * s * (h * p + 2 * g * n) + 4 * b * s * h + 4 * h
              + 4 * b * s * h * p + 4 * b * nc * h * p * n)
    pairs = q * (q + 1) // 2
    flops = 2.0 * b * nc * (g * pairs * n + h * (pairs * p + q * p * n))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dt]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def check_ssd(dev, gen, smi: str) -> dict:
    row, timed = {}, {}
    for b, s, h, p, g, n, q, dt, view in SSD_CASES:
        args = ssd_inputs(dev, gen, b, s, h, p, g, n, dt, view)
        got = ssd.ssd_chunk_call(*args, q)
        want = ssd.ssd_chunk_plain(*args, q)
        errs = [(a - w).abs().max().item() for a, w in zip(got, want)]
        mags = [w.abs().max().item() for w in want]
        for what, err, mag in zip(("y_diag", "states"), errs, mags):
            check(err <= SSD_TOL * mag, f"ssd_chunk {b, s, h, p, g, n, q, dt} {what}: "
                                        f"err {err} against |max| {mag}")
        print(f"[check] ssd_chunk (b, s, h, p, g, n) = {(b, s, h, p, g, n)}, q {q}, {dt}"
              f"{', conv slices' if view else ''}: "
              f"max abs err y_diag {errs[0]:.3g} (|y| <= {mags[0]:.3g}), states "
              f"{errs[1]:.3g} (<= {mags[1]:.3g}); tol {SSD_TOL} of the largest")
        if b != BATCH:
            continue
        timing = {"max_abs_err": max(errs),
                  "ms": time_ms(lambda: ssd.ssd_chunk_call(*args, q), 20),
                  "plain_ms": time_ms(lambda: ssd.ssd_chunk_plain(*args, q), 5)}
        timing["bound_ms"], timing["bound_by"] = ssd_bound_ms(b, s, h, p, g, n, q, dt)
        key = SSD_TIMED.get((s, h, p))
        shape = {None: "mamba2-2.7b prefill shape", "mamba2_tp2": "mamba2-2.7b TP-2 rank's "
                 "prefill shape (40 heads)", "hymba": "hymba-1.5b prefill shape (32 heads, p "
                 "100, n 16, 4 x 2048)", "hymba_tp8": "hymba-1.5b TP-8 rank's prefill shape "
                 "(4 heads, p 100, n 16, 4 x 2048)"}[key]
        print(f"[time] [{smi}] ssd_chunk {shape}, {dt}: "
              f"{timing['ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms "
              f"({timing['bound_by']}), plain {timing['plain_ms']:.4f} ms")
        if key is not None:
            timed[key] = timing
        elif dt == torch.bfloat16:
            row = {"name": "ssd_chunk", "route": "cuda", "source": "src/repro_torch/csrc/ssd.cu",
                   "replaces": "src/repro/kernels/ssd.py:59", **timing,
                   "library_ms": None}       # no one PyTorch call computes it
        else:
            row["f32"] = timing
    return {"ssd_chunk": {**row, **timed}}


# ---------------------------------------------------------------------------
# 3. a small model on the card against the CPU
# ---------------------------------------------------------------------------

def prefill_launches(cfg, kernel: str) -> int:
    """Launches of ``kernel`` per prefill of a path in PATH_KERNELS (prompt
    and frames of at least FLASH_MIN_Q): once per layer; an
    encoder-decoder model's flash also once per encoder layer and once per
    cross-attention."""
    if kernel == "flash_attention_bhsd" and cfg.n_enc_layers:
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def check_small_model(dev, arch: str) -> None:
    """Prefill + 4 decode steps of the f32 smoke model; the path's kernels
    launch once per layer each in the prefill (whisper's flash also per
    encoder layer and cross-attention, over 130 frames) and never in
    decode."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32,
                              **SMALL_OVERRIDES.get(arch, {}))
    cpu = Model(cfg, device="cpu").init(0)
    gpu = copy.deepcopy(cpu).to(dev)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 130), generator=gen)
    frames = (torch.randn(2, max(cfg.enc_seq, 130), cfg.d_model, generator=gen)
              if cfg.n_enc_layers else None)
    kernels = PATH_KERNELS[arch]
    per = [prefill_launches(cfg, k) for k in kernels]

    def launched():
        return [ops.launch_counts()[k] for k in kernels]

    before = launched()
    lc, cc = cpu.apply_prefill(toks, frames, max_len=136)
    lg, cg = gpu.apply_prefill(toks.to(dev), None if frames is None else frames.to(dev),
                               max_len=136)
    check(launched() == [n + m for n, m in zip(before, per)], f"small {kernels} launches")
    err = (lg.cpu() - lc).abs().max().item()
    check(err < 1e-3, f"small prefill logits differ by {err}")
    tok = lc.argmax(-1)
    check(torch.equal(lg.argmax(-1).cpu(), tok), "small prefill tokens")
    for _ in range(4):
        lc, cc = cpu.apply_decode(tok, cc)
        lg, cg = gpu.apply_decode(tok.to(dev), cg)
        err = max(err, (lg.cpu() - lc).abs().max().item())
        check(torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)), "small decode tokens")
        tok = lc.argmax(-1)
    check(err < 1e-3, f"small decode logits differ by {err}")
    check(launched() == [n + m for n, m in zip(before, per)], f"decode launched {kernels}")
    note = f" {SMALL_OVERRIDES[arch]}" if arch in SMALL_OVERRIDES else ""
    print(f"[check] {cfg.name} f32{note} on the card vs the CPU: prefill + 4 decode "
          f"steps, max logit diff {err:.3g}, greedy tokens equal, {' and '.join(kernels)} "
          f"launched {per} times (prefill only)")


def check_small_training(dev, rt, mode: str, codec: str | None, planned=None,
                         arch: str = ARCH) -> None:
    """3 steps of a smoke f32 model on the card and on the CPU, from the
    same parameters and batches, through the same groups: losses (and an
    MoE model's aux) within 1e-4.  With ``planned``
    (``launch.train.make_plan``'s result) the plan's path."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    cpu = Model(cfg, rt, device="cpu").init(0)
    gpu = copy.deepcopy(cpu, {id(rt): rt}).to(dev)
    opt_cfg = opt_lib.OptConfig(lr=1e-3, warmup_steps=1)
    if planned is None:
        tcfg = TrainConfig(comm_mode=mode, dcn_compression=codec, opt=opt_cfg)
        want = train_kernels(mode, codec, cfg)
    else:
        tcfg = TrainConfig(comm_mode=planned.mode, dcn_compression=codec, plan=planned.plan,
                           packed=planned.packed, cluster_weights=planned.cluster_weights,
                           opt=opt_cfg)
        want = planned_kernels(planned, cfg)
    runs, aux_runs = [], []
    for model in (cpu, gpu):
        step_fn, _ = make_train_step(model, tcfg)
        if mode == "hier_zero1":
            opt = zero_bootstrap(model, tcfg)
        else:
            opt = opt_lib.adam_init(opt_lib.flat_params(model.train_leaves())[0])
        dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=64)
        losses, auxes = [], []
        for i in range(3):
            b = {k: torch.from_numpy(v).long().to(model.device)
                 for k, v in synth_batch(dcfg, i).items()}
            before = ops.launch_counts()
            m = step_fn(opt, b)
            after = ops.launch_counts()
            if model is gpu:
                launched = {k: after[k] - before[k] for k in want}
                check(launched == want, f"small training {mode} launches {launched}")
            check(not m["gated"], "small training: finite gate tripped")
            losses.append(m["loss"])
            auxes.append(m["aux"])
        runs.append(losses)
        aux_runs.append(auxes)
    err = max(abs(a - b) / abs(b) for a, b in zip(runs[1], runs[0]))
    check(err < 1e-4, f"small training losses {runs}")
    if cfg.family == "moe":
        aux_err = max(abs(a - b) / abs(b) for a, b in zip(aux_runs[1], aux_runs[0]))
        check(aux_err < 1e-4 and min(aux_runs[1]) > 0, f"small training aux {aux_runs}")
    perr = max((torch.stack(g) if isinstance(g, list) else g).cpu().sub(
        torch.stack(c) if isinstance(c, list) else c).abs().max().item()
        for g, c in zip(gpu.train_leaves(), cpu.train_leaves()))
    if mode in SYNC_PARITY_MODES:
        held = check_sync_parity(gpu, rt, mode, tcfg)
        params = f"max param diff {perr:.3g} (reported; {held})"
    elif cfg.family in ("moe", "ssm", "hybrid"):
        # one int8 rounding apart moves an AdamW parameter by up to lr:
        # the losses (and an MoE run's aux) are what these runs are held to
        params = f"max param diff {perr:.3g} (reported)"
    else:
        check(perr < 1e-4, f"small training params differ by {perr}")
        params = f"max param diff {perr:.3g} (tol 1e-4)"
    what = f"{mode} + {codec}" + ("" if planned is None else " as planned, per leaf")
    aux = (f", aux {[f'{a:.6f}' for a in aux_runs[1]]} (within 1e-4 of the CPU's)"
           if cfg.family == "moe" else "")
    print(f"[check] {cfg.name} f32 training, {what}, 3 steps on the card vs "
          f"the CPU: losses {[f'{l:.6f}' for l in runs[1]]}, max relative loss diff "
          f"{err:.3g} (tol 1e-4){aux}, {params}, launches per step {want}")


def check_sync_parity(gpu, rt, mode: str, tcfg: TrainConfig) -> str:
    """A new gradient sync on the card against the same sync on the CPU,
    on the same gradients: one batch's raw gradients of the card model,
    synced on the card and, copied, on the CPU, bit-equal.  For
    hier_overlap also the hook executor inside the card's backward
    against the sync after it, bit-equal.  (Parameters after three int8
    AdamW steps are reported, not held: Adam turns one int8 rounding that
    the card's and the CPU's gradients take apart into a step of up to
    lr on that value.)"""
    cfg = gpu.cfg
    ccfg = tcfg.comm_config(rt)
    leaves = gpu.train_leaves()
    params, _ = opt_lib.flat_params(leaves)
    b = {k: torch.from_numpy(v).long().to(gpu.device) for k, v in synth_batch(
        DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=64), 7).items()}

    def backward():
        with torch.enable_grad():
            lval, _ = loss_lib.sharded_xent(gpu.apply_train(b["tokens"])[0], b["labels"], rt,
                                            cfg.vocab_size)
            return torch.autograd.grad(lval, params)

    for p in params:
        p.requires_grad_(True)
    raw = backward()
    card, host = [g.clone() for g in raw], [g.cpu() for g in raw]
    if mode == "hier_overlap":
        tree = gpu.param_tree()
        for grads in (card, host):
            by_id = dict(zip(map(id, params), grads))
            overlap.tree_hier_psum_overlap(_map_tree(tree, lambda t: by_id[id(t)]), ccfg,
                                           packed=tcfg.packed)
        sync = overlap.BucketSync(tree, ccfg, packed=tcfg.packed)
        with sync.attached():
            inside = backward()
        check(all(bits_equal(a, c) for a, c in zip(inside, card)),
              "hier_overlap: the hook executor differs from the sync after the backward")
        synced = (card, host)
    else:
        synced = []
        for grads in (card, host):
            it = iter(grads)
            synced.append([train_step.fsdp_sync([next(it) for _ in leaf]
                                                if isinstance(leaf, list) else next(it),
                                                False, ccfg, rt) for leaf in leaves])
    check(all(bits_equal(a.cpu(), c) for a, c in zip(*synced)),
          f"{mode}: the card's sync differs from the CPU's on the same gradients")
    return ("sync bit-equal to the CPU's on the card's gradients"
            + (", hook executor bit-equal to the sync after the backward"
               if mode == "hier_overlap" else ""))


def _map_tree(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, list):
        return [_map_tree(t, fn) for t in tree]
    return {k: _map_tree(v, fn) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# 6. the shared-scale codec at the gradient segment's size
# ---------------------------------------------------------------------------

def _chunks(n: int, step: int = 1 << 28):
    for c0 in range(0, n, step):
        yield c0, min(n, c0 + step)


def check_shared_codec(dev, gen, n: int, agree: dict[str, bool]) -> tuple[dict, dict]:
    """Edge cases at small sizes, then one buffer of ``n`` > 2^31 bf16
    values (the gradient segment) compared chunk by chunk with the plain
    versions, and timed.  Returns the rows of rows 4-5 and the int32
    decode's numbers."""
    B = quant.BLOCK
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn(37 * B + 5, device=dev, generator=gen) * 50).to(dt)
        x[B:2 * B] = 0                                       # an all-zero block
        a = quant.amax_block_call(x)
        check(torch.equal(a, quant.amax_block_plain(x)), f"amax_block {dt}")
        scale = a / 127
        scale[3], scale[4] = 0.0, -1.0                       # s <= 0 divides as 1
        q = quant.quant_scaled_call(x, scale)
        check(torch.equal(q, quant.quant_scaled_plain(x, scale)), f"quant_scaled {dt}")
    k = torch.arange(4 * B, device=dev) % 300 - 150
    x = (k + 0.5) * 0.25                                     # exact .5 ties
    x[2 * B:] = torch.where(k[2 * B:] % 2 == 0, 127 * 0.25, -200 * 0.25)
    scale = torch.full((4,), 0.25, device=dev)
    q = quant.quant_scaled_call(x, scale)
    check(torch.equal(q, quant.quant_scaled_plain(x, scale)), "quant_scaled ties")
    check(bool(q[2:].abs().eq(127).all()), "quant_scaled clipping at +-127")
    nan, inf = float("nan"), float("inf")
    x = torch.randn(4 * B + 9, device=dev, generator=gen)
    x[5], x[B + 7], x[2 * B + 9], x[3 * B + 1], x[3 * B + 2] = nan, inf, -inf, nan, inf
    for dt in (torch.float32, torch.bfloat16):
        xt = x.to(dt)
        a = quant.amax_block_call(xt)
        check(bits_equal(a, quant.amax_block_plain(xt)), f"amax_block NaN/inf {dt}")
        check(bool(a[[0, 3]].isnan().all() and a[[1, 2]].isinf().all()),
              f"amax_block propagates NaN {dt}")
        for scale in (a / 127, torch.tensor([1.0, inf, 0.5, nan, 2.0], device=dev)):
            check(torch.equal(quant.quant_scaled_call(xt, scale),
                              quant.quant_scaled_plain(xt, scale)),
                  f"quant_scaled NaN/inf {dt}")
        q, s = quant.quant_int8_call(xt)
        pq, ps = quant.quant_int8_plain(xt)
        check(torch.equal(q, pq) and bits_equal(s, ps), f"quant_int8 NaN/inf {dt}")
    print("[check] amax_block / quant_scaled, f32 and bf16, ragged with an all-zero "
          "block, scales <= 0, .5 ties, +-127 s, NaN and +-inf blocks and scales "
          "(quant_int8 too): bit-equal, NaN in the same places")

    check(n > 2 ** 31, f"gradient segment {n} is not above 2^31")
    x = torch.empty(n, dtype=torch.bfloat16, device=dev)
    for c0, c1 in _chunks(n):
        x[c0:c1] = torch.randn(c1 - c0, device=dev, generator=gen) * 1e-3
    x[B:2 * B] = 0
    nb = n // B
    check(n == nb * B, f"the gradient segment {n} is not whole blocks")
    before = quant.amax_block_call.vector_launches, quant.quant_scaled_call.vector_launches
    a = quant.amax_block_call(x)
    scale = compression._shared_scale(a.clone(), None)
    q = quant.quant_scaled_call(x, scale)
    check((quant.amax_block_call.vector_launches, quant.quant_scaled_call.vector_launches)
          == (before[0] + 1, before[1] + 1), "amax_block, quant_scaled: vector variant")
    for c0, c1 in _chunks(n):
        b0, b1 = c0 // B, -(-c1 // B)
        check(torch.equal(a[b0:b1], quant.amax_block_plain(x[c0:c1])),
              f"amax_block at [{c0}, {c1})")
        check(torch.equal(q[b0:b1], quant.quant_scaled_plain(x[c0:c1], scale[b0:b1])),
              f"quant_scaled at [{c0}, {c1})")

    def norm():
        return torch.linalg.vector_norm(x.view(nb, B), ord=float("inf"), dim=1,
                                        dtype=torch.float32)
    amax_equal = agree["amax_block"] and torch.equal(norm(), a)
    rows = {
        "amax_block": {
            "name": "amax_block", "route": "cuda", "source": "src/repro_torch/csrc/quant.cu",
            "replaces": "src/repro/kernels/quant.py:90", "max_abs_err": 0.0,
            "ms": time_ms(lambda: quant.amax_block_call(x), 10),
            "plain_ms": time_ms(lambda: quant.amax_block_plain(x), 1, warmup=1),
            # read the bf16 segment once, write nb floats
            "bound_ms": (2 * n + 4 * nb) / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": yardstick(norm, amax_equal, "vector_norm(ord=inf)", 10)},
        "quant_scaled": {
            "name": "quant_scaled", "route": "cuda", "source": "src/repro_torch/csrc/quant.cu",
            "replaces": "src/repro/kernels/quant.py:107", "max_abs_err": 0.0,
            "ms": time_ms(lambda: quant.quant_scaled_call(x, scale), 10),
            "plain_ms": time_ms(lambda: quant.quant_scaled_plain(x, scale), 1, warmup=1),
            # read the segment and the scales once, write the int8 blocks
            "bound_ms": (2 * n + 4 * nb + nb * B) / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None},
    }
    del x
    free_memory()
    q32 = q.to(torch.int32)                    # the int32 ring sum of a pod of one
    del q
    free_memory()
    before = quant.dequant_int8_call.vector_launches
    out = quant.dequant_int8_call(q32, scale, n, torch.bfloat16)
    check(quant.dequant_int8_call.vector_launches == before + 1, "dequant_int8: vector variant")
    for c0, c1 in _chunks(n):
        b0, b1 = c0 // B, -(-c1 // B)
        want = quant.dequant_int8_plain(q32[b0:b1], scale[b0:b1], c1 - c0, torch.bfloat16)
        check(torch.equal(out[c0:c1], want), f"dequant int32 -> bf16 at [{c0}, {c1})")
    lib_out, lib_call = mul_decode(q32, scale, torch.bfloat16)
    lib_equal = agree["dequant_int8"] and torch.equal(lib_out, out)
    del out, lib_out
    free_memory()
    deq = {"ms": time_ms(lambda: quant.dequant_int8_call(q32, scale, n, torch.bfloat16), 10),
           "plain_ms": time_ms(lambda: quant.dequant_int8_plain(q32, scale, n, torch.bfloat16),
                               1, warmup=1),
           # read the int32 blocks and the scales, write the bf16 values
           "bound_ms": (4 * nb * B + 4 * nb + 2 * n) / PEAK_BYTES_PER_S * 1e3,
           "library_ms": yardstick(lib_call, lib_equal, "torch.mul int32 -> bf16", 10)}
    del lib_call
    print(f"[check] gradient segment of {n} bf16 values (> 2^31), in chunks of 2^28: "
          f"amax_block, quant_scaled and the int32 -> bf16 decode bit-equal, all three "
          f"in their vector variant; library versions bit-equal: "
          f"vector_norm {amax_equal}, torch.mul {lib_equal}")
    return rows, deq


def check_shared_codec_f32(dev, gen, n: int, agree: dict[str, bool]) -> dict:
    """hier_zero1's codec input: one f32 buffer of ``n`` > 2^31 values (the
    gradient segment cast to f32), through amax_block and quant_scaled and
    the int32 -> f32 decode, each in its vector variant, compared chunk by
    chunk with the plain versions and timed beside its bound (amax_block
    and the decode also beside one PyTorch call, if bit-equal)."""
    B = quant.BLOCK
    nb = n // B
    check(n == nb * B, f"the gradient segment {n} is not whole blocks")
    x = torch.empty(n, dtype=torch.float32, device=dev)
    for c0, c1 in _chunks(n):
        x[c0:c1] = torch.randn(c1 - c0, device=dev, generator=gen) * 1e-3
    x[B:2 * B] = 0
    before = ops.vector_launch_counts()
    a = quant.amax_block_call(x)
    scale = compression._shared_scale(a.clone(), None)
    q = quant.quant_scaled_call(x, scale)
    after = ops.vector_launch_counts()
    check(all(after[k] == before[k] + 1 for k in ("amax_block", "quant_scaled")),
          "amax_block, quant_scaled on f32: vector variant")
    for c0, c1 in _chunks(n):
        b0, b1 = c0 // B, -(-c1 // B)
        check(torch.equal(a[b0:b1], quant.amax_block_plain(x[c0:c1])),
              f"amax_block f32 at [{c0}, {c1})")
        check(torch.equal(q[b0:b1], quant.quant_scaled_plain(x[c0:c1], scale[b0:b1])),
              f"quant_scaled f32 at [{c0}, {c1})")

    def norm():
        return torch.linalg.vector_norm(x.view(nb, B), ord=float("inf"), dim=1)
    amax_equal = agree["amax_block"] and torch.equal(norm(), a)
    out = {
        # read the f32 segment once, write nb floats
        "amax_block": {"ms": time_ms(lambda: quant.amax_block_call(x), 10),
                       "bound_ms": (4 * n + 4 * nb) / PEAK_BYTES_PER_S * 1e3,
                       "library_ms": yardstick(norm, amax_equal,
                                               "vector_norm(ord=inf), f32", 10)},
        # read the segment and the scales once, write the int8 blocks
        "quant_scaled": {"ms": time_ms(lambda: quant.quant_scaled_call(x, scale), 10),
                         "bound_ms": (4 * n + 4 * nb + nb * B) / PEAK_BYTES_PER_S * 1e3,
                         "library_ms": None},
    }
    del x
    free_memory()
    q32 = q.to(torch.int32)
    del q
    free_memory()
    before = quant.dequant_int8_call.vector_launches
    dec = quant.dequant_int8_call(q32, scale, n, torch.float32)
    check(quant.dequant_int8_call.vector_launches == before + 1,
          "dequant_int8 int32 -> f32: vector variant")
    for c0, c1 in _chunks(n):
        b0, b1 = c0 // B, -(-c1 // B)
        want = quant.dequant_int8_plain(q32[b0:b1], scale[b0:b1], c1 - c0, torch.float32)
        check(torch.equal(dec[c0:c1], want), f"dequant int32 -> f32 at [{c0}, {c1})")
    lib_out, lib_call = mul_decode(q32, scale, torch.float32)
    lib_equal = agree["dequant_int8"] and torch.equal(lib_out, dec)
    del dec, lib_out
    free_memory()
    # read the int32 blocks and the scales, write the f32 values
    out["dequant_int8"] = {
        "ms": time_ms(lambda: quant.dequant_int8_call(q32, scale, n, torch.float32), 10),
        "bound_ms": (4 * nb * B + 4 * nb + 4 * n) / PEAK_BYTES_PER_S * 1e3,
        "library_ms": yardstick(lib_call, lib_equal, "torch.mul int32 -> f32", 10)}
    del lib_call, q32
    free_memory()
    print(f"[check] hier_zero1's f32 gradient segment of {n} values (> 2^31), in chunks "
          f"of 2^28: amax_block and quant_scaled on f32 and the int32 -> f32 decode "
          f"bit-equal, all three in their vector variant; library versions bit-equal: "
          f"vector_norm {amax_equal}, torch.mul {lib_equal}")
    return out


# ---------------------------------------------------------------------------
# 7. slot packing, alone and fused with the int8 codec
# ---------------------------------------------------------------------------

def _small_tree(dev, gen, dtypes) -> list:
    """Leaves taking ``dtypes`` in turn: a 16-byte-aligned leaf, a list leaf
    of three ragged layers, ragged leaves, a scalar and an all-zero leaf."""
    def r(*shape):
        return torch.randn(shape, device=dev, generator=gen) * 3

    made = [r(64, 32), [r(129) for _ in range(3)], r(5), r(2048), r(), r(37, 11),
            torch.zeros(2048 + 257, device=dev)]
    return [[p.to(dtypes[i % len(dtypes)]) for p in x] if isinstance(x, list)
            else x.to(dtypes[i % len(dtypes)]) for i, x in enumerate(made)]


def _stress_trees(dev, gen) -> dict:
    """Piece lists that drive every branch of fused_pack_quant's table walk:
    name -> (pieces, padded)."""
    def leaf(n, dt):
        return (torch.randn(n, device=dev, generator=gen) * 3).to(dt)

    def sizes(lo, hi, k):
        return torch.randint(lo, hi, (k,), device=dev, generator=gen).tolist()

    def back_to_back(lengths, dtypes, gaps=None):
        pieces, pos = [], 0
        for i, n in enumerate(lengths):
            pos += gaps[i] if gaps else 0
            pieces.append((pos, leaf(n, dtypes[i % len(dtypes)])))
            pos += n
        return pieces, -(-(pos + 1) // quant.BLOCK) * quant.BLOCK

    f32, bf16 = torch.float32, torch.bfloat16
    odd = leaf(3 + 4096, bf16)[3:]                # a source 6 bytes off 16
    return {
        # more than 32 spans in block 0, offsets not multiples of 8, words
        # straddling two spans, bf16 and f32 in turns
        "40 small leaves, bf16/f32": back_to_back(sizes(1, 26, 40), (bf16, f32)),
        # null spans in mid-block (300-517, 717-2100) and whole null blocks
        "gaps": ([(0, leaf(300, bf16)), (517, leaf(200, f32)), (2100, leaf(5000, bf16))],
                 10240),
        # blocks inside one span: 16-byte words where the source allows
        # them (offsets 0, 4096, 12296, 16396), values where it does not
        # (the unaligned source at 8192, the bf16 leaf at 20501)
        "aligned and unaligned words": ([(0, leaf(4096, bf16)), (4096, leaf(4096, f32)),
                                         (8192, odd), (12296, leaf(4096, bf16)),
                                         (16396, leaf(4096, f32)), (20501, leaf(3000, bf16))],
                                        24576),
        # a table of more than 1024 rows: three search rounds
        "1100 leaves with gaps": back_to_back(sizes(1, 3000, 1100), (bf16, f32, f32),
                                              sizes(0, 4, 1100)),
    }


def check_pack_small(dev, gen) -> None:
    f32, bf16 = torch.float32, torch.bfloat16
    for dtypes in ((f32,), (bf16,), (f32, bf16)):
        leaves = _small_tree(dev, gen, dtypes)
        layout = packing.plan_layout(packing.tree_metas(leaves), world=4, n_chunks=4,
                                     block=quant.BLOCK)
        got = packing.pack(layout, leaves)
        for name, pieces in packing.segment_pieces(layout, leaves).items():
            padded = layout.segment(name).padded
            buf = got[name]
            check(torch.equal(buf, quant.pack_slots_plain(pieces, padded, buf.dtype)),
                  f"pack_slots {name} segment of {dtypes}")
            other = bf16 if buf.dtype == f32 else f32           # a cast as it copies
            check(torch.equal(quant.pack_slots_call(pieces, padded, other),
                              quant.pack_slots_plain(pieces, padded, other)),
                  f"pack_slots {name} into {other}")
            fq, fs = quant.fused_pack_quant_call(pieces, padded)
            pq, ps = quant.fused_pack_quant_plain(pieces, padded)
            cq, cs = quant.quant_int8_call(buf)
            check(torch.equal(fq, pq) and torch.equal(fs, ps),
                  f"fused_pack_quant {name} of {dtypes} against plain")
            check(torch.equal(fq, cq) and torch.equal(fs, cs),
                  f"fused_pack_quant {name} of {dtypes} against pack -> quant_int8")
    print("[check] pack_slots and fused_pack_quant, f32, bf16 and mixed trees (list "
          "leaves, ragged leaves, a scalar, an all-zero leaf, casts both ways): "
          "bit-equal to the plain versions and to pack -> quant_int8")
    rows = {}
    for name, (pieces, padded) in _stress_trees(dev, gen).items():
        fq, fs = quant.fused_pack_quant_call(pieces, padded)
        pq, ps = quant.fused_pack_quant_plain(pieces, padded)
        cq, cs = quant.quant_int8_call(quant.pack_slots_call(pieces, padded))
        check(torch.equal(fq, pq) and torch.equal(fs, ps), f"fused_pack_quant {name} against plain")
        check(torch.equal(fq, cq) and torch.equal(fs, cs),
              f"fused_pack_quant {name} against pack -> quant_int8")
        rows[name] = quant._span_table(pieces, padded, "fused_pack_quant")[0].shape[0]
    check(max(rows.values()) > 1024, f"table rows {rows}")
    print(f"[check] fused_pack_quant on stress trees (table rows {rows}): bit-equal to the "
          f"plain version and to pack -> quant_int8")


def check_pack(dev, gen, rt, smi: str) -> tuple[dict, dict]:
    """Small cases, then the qwen2.5-3b gradient layout (the parameters of
    a full-width model stand for its gradients): the conformance path with
    its launch counts set to 0 just before it and read just after, the
    kernels against their plain versions, and the timings."""
    check_pack_small(dev, gen)
    model = Model(get_config(ARCH), rt, dev).init(0)
    leaves = model.train_leaves()
    layout = collectives.comm_layout(leaves, collectives.CommConfig(compression="int8"),
                                     world=1)
    check(len(layout.segments) == 1, f"segments {layout.segments}")
    seg = layout.segments[0]
    pieces = packing.segment_pieces(layout, leaves)[seg.dtype]
    n, padded, nb = seg.used, seg.padded, seg.padded // quant.BLOCK
    check(padded > 2 ** 31 and seg.dtype == "bfloat16", f"segment {seg}")

    # the reference's OK-F conformance row: fused pack+quantize == pack -> quant
    ops.reset_launch_counts()
    buf = packing.pack(layout, leaves)[seg.dtype]
    cq, cs = quant.quant_int8_call(buf)
    fq, fs = quant.fused_pack_quant_call(pieces, padded)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(torch.equal(fq, cq) and torch.equal(fs, cs), "OK-F: fused != pack -> quant_int8")
    want = {k: 0 for k in counts}
    want.update(pack_slots=1, quant_int8=1, fused_pack_quant=1)
    check(counts == want, f"conformance launches {counts}")
    del cq, cs
    check(torch.equal(buf, quant.pack_slots_plain(pieces, padded, torch.bfloat16)),
          "pack_slots at the gradient layout")
    del buf
    free_memory()
    pq, ps = quant.fused_pack_quant_plain(pieces, padded)
    check(torch.equal(fq, pq) and torch.equal(fs, ps), "fused_pack_quant at the gradient layout")
    del pq, ps, fq, fs
    free_memory()
    print(f"[check] conformance (OK-F) at the qwen2.5-3b gradient layout, {len(pieces)} "
          f"parameter tensors, {n} bf16 values padded to {padded} (> 2^31): fused "
          f"pack+quantize == pack -> quant_int8, and both kernels == their plain "
          f"versions, bit for bit; launches {want}")

    parts = [p.reshape(-1) for _, p in pieces]
    parts.append(torch.zeros(padded - n, dtype=torch.bfloat16, device=dev))
    rows = {
        "pack_slots": {
            "name": "pack_slots", "route": "cuda", "source": "src/repro_torch/csrc/pack.cu",
            "replaces": "src/repro/kernels/quant.py:137", "max_abs_err": 0.0,
            "ms": time_ms(lambda: quant.pack_slots_call(pieces, padded, torch.bfloat16), 10),
            "plain_ms": time_ms(lambda: quant.pack_slots_plain(pieces, padded, torch.bfloat16),
                                3, warmup=1),
            # read every parameter tensor once, write the padded segment once
            "bound_ms": (2 * n + 2 * padded) / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": time_ms(lambda: torch.cat(parts), 10)},
        "fused_pack_quant": {
            "name": "fused_pack_quant", "route": "cuda", "source": "src/repro_torch/csrc/pack.cu",
            "replaces": "src/repro/kernels/quant.py:158", "max_abs_err": 0.0,
            "ms": time_ms(lambda: quant.fused_pack_quant_call(pieces, padded), 10),
            "plain_ms": time_ms(lambda: quant.fused_pack_quant_plain(pieces, padded), 1,
                                warmup=1),
            # read every parameter tensor once, write the int8 blocks and scales
            "bound_ms": (2 * n + padded + 4 * nb) / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None},
    }
    rows["pack_slots"]["interleaved"] = pack_against_cat(pieces, parts, padded, smi)
    del model, leaves, pieces, parts
    free_memory()
    return rows, counts


def pack_against_cat(pieces, parts, padded: int, smi: str) -> dict:
    """pack_slots and torch.cat on the same gradient layout in PACK_ROUNDS
    rounds, taking turns at going first, each sample timed as the row's
    ``ms`` is; every sample printed."""
    calls = {"pack_slots": lambda: quant.pack_slots_call(pieces, padded, torch.bfloat16),
             "torch.cat": lambda: torch.cat(parts)}
    samples = {name: [] for name in calls}
    for i in range(PACK_ROUNDS):
        for name in (list(calls) if i % 2 == 0 else list(calls)[::-1]):
            samples[name].append(time_ms(calls[name], 10))
            print(f"[time] [{smi}] pack_slots vs torch.cat, round {i}: {name} "
                  f"{samples[name][-1]:.4f} ms")
    med = {name: statistics.median(ms) for name, ms in samples.items()}
    print(f"[time] [{smi}] pack_slots vs torch.cat over {PACK_ROUNDS} interleaved rounds: "
          f"medians pack_slots {med['pack_slots']:.4f} ms, torch.cat "
          f"{med['torch.cat']:.4f} ms ({med['pack_slots'] / med['torch.cat'] - 1:+.1%})")
    return {"samples_ms": samples, "median_ms": med}


# ---------------------------------------------------------------------------
# 8. where the time goes
# ---------------------------------------------------------------------------

MATMUL_KEYS = ("gemm", "nvjet", "xmma", "cutlass", "cublas", "splitk")
# the f32 flash_attention_kernel and the bf16 flash_attention_mma_kernel;
# the f32 ssd_chunk_kernel and the bf16 ssd_chunk_mma_kernel
SERVE_GROUPS = (("flash_attention", ("flash_attention",)),
                ("ssd_chunk", ("ssd_chunk_kernel", "ssd_chunk_mma_kernel")),
                ("matmul", MATMUL_KEYS),
                ("int8 codec", ("quant_int8_kernel", "dequant_int8")))
SERVE_RANGES = ("ssd_inter_chunk", "causal_conv1d")
TRAIN_GROUPS = (("codec", ("amax_block", "quant_scaled", "dequant_int8")),
                ("pack", ("pack_slots_kernel",)),
                ("matmul", MATMUL_KEYS))
TRAIN_RANGES = ("grad_sync", "grad_norm", "optimizer")


def _name_group(name: str, name_groups) -> str | None:
    return next((g for g, keys in name_groups if any(k in name.lower() for k in keys)),
                None)


def _in_range(ev, ranges) -> str | None:
    while ev is not None:
        if ev.name in ranges:
            return ev.name
        ev = ev.cpu_parent
    return None


def _breakdown(prof, name_groups, ranges,
               range_first: bool = False) -> tuple[dict, dict, float, int, list]:
    """Device time by group: kernels matching ``name_groups`` by name; the
    rest by the record_function range (of ``ranges``) their launching op
    ran in; everything else as "other".  With ``range_first`` a kernel
    launched inside a range counts for the range whatever its name (the
    MoE's expert matmuls against the other matmuls).  The kernels that the
    ctypes wrappers launch have no launching aten op, so device time and
    names come from the device events, and the ranges only from the
    kernels an aten op launched.  Also the host time spent inside each
    range."""
    groups = {g: 0.0 for g, _ in name_groups}
    busy, n_kernels, top = 0.0, 0, []
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        # a record_function range also shows as a device-side span
        if (us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.is_user_annotation):
            continue
        busy += us / 1e3
        n_kernels += ev.count
        top.append((us / 1e3, ev.count, ev.key[:70]))
        g = _name_group(ev.key, name_groups)
        if g is not None:
            groups[g] += us / 1e3
    for g in ranges:
        groups[g] = 0.0
    host = {g: 0.0 for g in ranges}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        if ev.name in ranges:
            host[ev.name] += ev.cpu_time_total / 1e3
        rng = _in_range(ev, ranges)
        for kern in ev.kernels:
            named = _name_group(kern.name, name_groups)
            if rng is not None and named is None:
                groups[rng] += kern.duration / 1e3
            elif rng is not None and range_first:
                groups[rng] += kern.duration / 1e3
                groups[named] -= kern.duration / 1e3
    groups["other"] = busy - sum(groups.values())
    return groups, host, busy, n_kernels, sorted(top, reverse=True)[:6]


def _report(prof, wall_ms: float, label: str, smi: str, name_groups, ranges,
            range_first: bool = False) -> dict:
    groups, host, busy, n_kernels, top = _breakdown(prof, name_groups, ranges, range_first)
    idle = 1.0 - busy / wall_ms
    shares = ", ".join(f"{g} {ms:.3f} ms ({ms / busy:.1%})"
                       for g, ms in sorted(groups.items(), key=lambda t: -t[1]) if ms > 0)
    hosts = ", ".join(f"host time in {g} {ms:.3f} ms" for g, ms in host.items())
    print(f"[profile] [{smi}] {label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {idle:.1%}, {n_kernels} kernels; {shares}"
          + (f"; {hosts}" if hosts else ""))
    for ms, count, name in top:
        print(f"[profile]   {ms:9.3f} ms  x{count:<5d} {name}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": idle,
            "groups_ms": groups, "kernels": n_kernels, "host_ms": host}


def check_vector_launches(counts: dict[str, int], path: str) -> None:
    """Every launch on a main path of a kernel that has a vector variant
    (amax_block, quant_scaled, dequant_int8) took it."""
    vector = ops.vector_launch_counts()
    check(all(vector[k] == counts[k] for k in vector),
          f"{path}: vector launches {vector} of {counts}")


def serve_full_width(dev, smi: str, arch: str, prompt_len: int = PROMPT) -> tuple[dict, dict]:
    """A serving main path; the launch counts are set to 0 just before it
    and read just after, and each phase's launches are checked."""
    ops.reset_launch_counts()
    res = disaggregated.run(arch, batch=BATCH, prompt_len=prompt_len, gen=GEN, device=dev)
    counts = ops.launch_counts()
    cfg = get_config(arch)
    phases = res["launches"]
    # the leaves of at least 1024 values cross as int8 (k and v, conv and
    # ssm, all four for hymba, self and cross k and v for whisper); the
    # lengths travel raw
    leaves = 4 if cfg.family in ("hybrid", "encdec") else 2
    expect = {"prefill": {k: prefill_launches(cfg, k) * res["prefills"]
                          for k in PATH_KERNELS[arch]},
              "int8_transfer": {"quant_int8": leaves * res["int8_transfers"],
                                "dequant_int8": leaves * res["int8_transfers"]},
              "raw_transfer": {}, "decode": {}}
    for phase, want in expect.items():
        got = {k: n for k, n in phases[phase].items() if n}
        check(got == want, f"{arch} {phase} launches {got}, expected {want}")
    check(counts == {k: sum(p[k] for p in phases.values()) for k in counts},
          f"{arch} launches {counts} against the phases {phases}")
    check_vector_launches(counts, arch)
    shapes = res["cache_shapes"]
    ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    ssm_shapes = {"conv": [cfg.n_layers, BATCH, cfg.conv_width - 1, ch],
                  "ssm": [cfg.n_layers, BATCH, cfg.ssm_heads(), cfg.ssm_head_dim, cfg.ssm_state],
                  "length": [cfg.n_layers]}
    window = min(prompt_len, cfg.sliding_window or prompt_len)
    leaf = [cfg.n_layers, BATCH, window, cfg.n_kv_heads, cfg.head_dim]
    kv_shapes = {"k": leaf, "v": leaf, "length": [cfg.n_layers]}
    cross = [cfg.n_layers, BATCH, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim]
    cross_shapes = {"k": cross, "v": cross, "length": [cfg.n_layers]}
    want_shapes = {"ssm": ssm_shapes,
                   "hybrid": {**{f"kv.{k}": v for k, v in kv_shapes.items()},
                              **{f"ssm.{k}": v for k, v in ssm_shapes.items()}},
                   "encdec": {**{f"kv.{k}": v for k, v in kv_shapes.items()},
                              **{f"cross.{k}": v for k, v in cross_shapes.items()}},
                   }.get(cfg.family, kv_shapes)
    check(shapes == want_shapes, f"{arch} cache {shapes}, expected {want_shapes}")
    check(res["cache_finite"], f"{arch}: non-finite cache")
    tokens = torch.tensor(res["tokens"])
    check(tokens.shape == (BATCH, GEN + 1), f"tokens {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "token ids")
    check(res["raw_transfer_exact"], f"{arch}: the raw transfer changed the generation")
    check(bool(torch.isfinite(res["prefill_logits"]).all()), f"{arch}: non-finite logits")
    check(arch == MOE_ARCH or res["params"] == FULL_PARAMS[arch],
          f"{arch} params {res['params']}")
    if cfg.family in ("ssm", "hybrid", "encdec", "vlm"):
        total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
        check(res["peak_mem_gb"] < total_gb, f"{arch} peak {res['peak_mem_gb']} GB")
    frames = f" and {cfg.enc_seq} frames" if cfg.n_enc_layers else ""
    print(f"[serve] [{smi}] {res['arch']} ({res['params'] / 1e9:.3f} B params, bf16, "
          f"{res['layers']} of {cfg.n_layers} layers), {BATCH} x {prompt_len}-token prompts"
          f"{frames}: TTFT "
          f"{res['ttft_ms']:.2f} ms, decode {res['decode_ms_per_step']:.2f} ms/step, int8 "
          f"transfer of {res['cache_bytes']} cache bytes {res['int8_transfer_ms']:.2f} ms, "
          f"peak memory {res['peak_mem_gb']:.2f} GB, int8 token agreement "
          f"{res['int8_token_agreement']:.4f}, raw transfer exact")
    print(f"[serve] {res['arch']} kernel launches {counts}: by phase {phases} "
          f"({res['prefills']} prefills, {res['int8_transfers']} int8 transfers, "
          f"{res['decode_steps']} decode steps)")
    return res, counts


def profile_serving(dev, smi: str, arch: str, prompt_len: int = PROMPT) -> dict:
    """One prefill and four decode steps under torch.profiler (after a
    warm-up) on one full-width model (whisper's prefill with its frames)."""
    cfg = get_config(arch)
    model = Model(cfg, device=dev).init(0)
    prefill, decode = make_serve_steps(model)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, prompt_len), generator=gen).to(dev)
    frames = (torch.randn(BATCH, cfg.enc_seq, cfg.d_model, generator=gen).to(dev)
              if cfg.n_enc_layers else None)
    tok, caches = prefill(prompt, frames)                 # warm-up
    decode(tok, caches)
    out = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, caches = prefill(prompt, frames)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out["prefill"] = _report(prof, wall, f"{cfg.name} prefill {BATCH}x{prompt_len}", smi,
                             SERVE_GROUPS, SERVE_RANGES)
    steps = 4
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, caches = decode(tok, caches)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out["decode"] = _report(prof, wall, f"{cfg.name} {steps} decode steps", smi,
                            SERVE_GROUPS, SERVE_RANGES)
    return out


# ---------------------------------------------------------------------------
# MoE: qwen3-moe-30b-a3b served at full width (a), trained at MOE_LAYERS (c)
# ---------------------------------------------------------------------------

MOE_GROUPS = (("flash_attention", ("flash_attention",)), ("matmul", MATMUL_KEYS),
              ("int8 codec", ("quant_int8_kernel", "dequant_int8")))
# the MoE layer's record_function ranges: they take their kernels whatever
# the name (the expert bmm's from the matmul group)
MOE_RANGES = ("moe_experts", "moe_pack", "moe_combine", "moe_route")
MOE_LAYERS = 4        # the depth of phases (c) and (d)
# the capacity factor of phase (d): E / k makes every expert's capacity
# T * k / E * factor at least T (at TP 1; T / tp per rank at TP 2), so no
# token can drop on either side.  check_moe's 4.0 dropped 9212 routed
# slots at TP 2 on the random weights, whose routing collapses onto few
# experts with depth
MOE_TP_FACTOR = 16.0
MOE_FLIP_TOL = 0.5    # share of the largest logit one router flip at a token may move


def moe_bounds(cfg, batch: int, prompt: int) -> dict:
    """Least times of one prefill and one decode step on the card (bf16 peak,
    memory rate): the prefill's operations, every expert over its
    capacity-padded buffer, the attention projections, causal attention
    and the router; a decode step reads every expert's weights once (at
    capacity 8 all E experts run)."""
    T = batch * prompt
    E, k, D, F = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.moe_d_ff
    dh, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    experts = 2 * 3 * E * moe._capacity(T, k, E, 1.25) * D * F
    proj = 2 * T * (2 * D * H * dh + 2 * D * K * dh)
    attn = 2 * 2 * batch * H * prompt * prompt * dh / 2
    router = 2 * T * D * E
    flops = cfg.n_layers * (experts + proj + attn + router)
    weights = cfg.n_layers * 3 * E * D * F * 2
    return {"prefill_tflop": flops / 1e12,
            "prefill_bound_ms": flops / PEAK_FLOPS[torch.bfloat16] * 1e3,
            "experts_gflop_per_layer": experts / 1e9,
            "parts_tflop": {name: cfg.n_layers * f / 1e12 for name, f in (
                ("experts", experts), ("projections", proj), ("attention", attn),
                ("router", router))},
            "decode_expert_gb": weights / 1e9,
            "decode_bound_ms": weights / PEAK_BYTES_PER_S * 1e3}


class MoeTrace:
    """While in use, wraps the MoE layer's ``_route`` and ``_pack``: the ids
    routed by the first ``n`` ``_route`` calls (one prefill's layers) and,
    per ``_pack`` call, the tokens dropped at capacity (device scalars,
    read once at the end)."""

    def __init__(self, n: int):
        self.n, self.ids, self.drops = n, [], []

    def __enter__(self):
        self._route, self._pack = moe._route, moe._pack

        def route(*args, **kw):
            out = self._route(*args, **kw)
            if len(self.ids) < self.n:
                self.ids.append(out[1].detach().clone())
            return out

        def pack(*args, **kw):
            buf, r = self._pack(*args, **kw)
            self.drops.append((~r[2]).sum())
            return buf, r

        moe._route, moe._pack = route, pack
        return self

    def __exit__(self, *exc):
        moe._route, moe._pack = self._route, self._pack

    def result(self) -> dict:
        return {"route_ids": [i.cpu() for i in self.ids],
                "drops": [int(d) for d in self.drops]}


def serve_moe(dev, smi: str) -> tuple[dict, dict]:
    """Phase (a): qwen3-moe-30b-a3b served at full width and depth (48
    layers, 128 experts top-8, 60.16 GB of bf16 weights) through
    ``disaggregated.run``, checked as the other serving paths are (48 flash
    launches per prefill, none in decode, the codec twice per int8
    transfer, the raw transfer exact), with finite logits and the peak
    under the card's memory; its times beside their bounds."""
    cfg = get_config(MOE_ARCH)
    res, counts = serve_full_width(dev, smi, MOE_ARCH)
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    check(res["params"] == cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model,
          f"qwen3-moe params {res['params']}")
    check(bool(torch.isfinite(res["prefill_logits"]).all()), "qwen3-moe: non-finite logits")
    check(res["peak_mem_gb"] < total_gb, f"qwen3-moe peak {res['peak_mem_gb']} of {total_gb} GB")
    b = moe_bounds(cfg, BATCH, PROMPT)
    print(f"[moe] [{smi}] {MOE_ARCH} TP 1, {BATCH} x {PROMPT}: TTFT {res['ttft_ms']:.2f} ms "
          f"against the bound {b['prefill_bound_ms']:.2f} ms ({b['prefill_tflop']:.2f} TFLOP at "
          f"989 TFLOP/s: {', '.join(f'{k} {v:.2f}' for k, v in b['parts_tflop'].items())}); "
          f"decode {res['decode_ms_per_step']:.2f} ms/step against {b['decode_bound_ms']:.2f} "
          f"ms ({b['decode_expert_gb']:.2f} GB of expert weights at 3.35 TB/s); peak "
          f"{res['peak_mem_gb']:.3f} GB of {total_gb:.3f} GB")
    res["bounds"] = b
    return res, counts


def profile_moe(dev, smi: str) -> dict:
    """One prefill and one decode step of qwen3-moe-30b-a3b under
    torch.profiler, after a warm-up prefill and decode step that count the
    tokens each layer dropped at capacity: device time by expert matmuls,
    pack, combine, routing, flash, other matmuls and the rest, and the
    idle share."""
    cfg = get_config(MOE_ARCH)
    model = Model(cfg, device=dev).init(0)
    prefill, decode = make_serve_steps(model)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    with MoeTrace(0) as trace:
        tok, caches = prefill(prompt)
        decode(tok, caches)
    drops = trace.result()["drops"]
    check(len(drops) == 2 * cfg.n_layers, f"{len(drops)} MoE layers ran")
    out = {"prefill_drops": drops[:cfg.n_layers], "decode_drops": drops[cfg.n_layers:]}
    C = moe._capacity(BATCH * PROMPT, cfg.top_k, cfg.n_experts, 1.25)
    print(f"[moe] {MOE_ARCH} tokens dropped at capacity per layer (of {BATCH * PROMPT} x "
          f"{cfg.top_k} routed, capacity {C} per expert): prefill {out['prefill_drops']}, "
          f"sum {sum(out['prefill_drops'])}; decode step {out['decode_drops']}")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, caches = prefill(prompt)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out["prefill"] = _report(prof, wall, f"{cfg.name} prefill {BATCH}x{PROMPT}", smi,
                             MOE_GROUPS, MOE_RANGES, range_first=True)
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(tok, caches)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out["decode"] = _report(prof, wall, f"{cfg.name} 1 decode step", smi, MOE_GROUPS,
                            MOE_RANGES, range_first=True)
    return out


def train_moe(dev, smi: str) -> dict:
    """Phase (c): qwen3-moe-30b-a3b cut to MOE_LAYERS layers, trained with
    hier + int8 on 4 x 1024 tokens; launches per step as qwen's hier row
    (pack_slots and the codec once each), finite losses, aux > 0."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    ops.reset_launch_counts()
    res = train_launch.run(MOE_ARCH, layers=MOE_LAYERS, steps=TRAIN_STEPS, mode="hier",
                           compression="int8", global_batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                           device=dev, log=lambda line: print(f"[train] {line}"))
    counts = ops.launch_counts()
    want = train_kernels("hier", "int8", cfg)
    check(counts == {k: n * TRAIN_STEPS for k, n in want.items()},
          f"qwen3-moe training launches {counts} over {TRAIN_STEPS} steps")
    check_vector_launches(counts, "train_moe")
    for rec in res["records"]:
        launched = {k: rec["launches"][k] for k in want}
        check(launched == want, f"qwen3-moe step {rec['step']} launches {launched}")
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["gnorm"]) and rec["aux"] > 0,
              f"qwen3-moe step {rec['step']}: {rec}")
        check(not rec["gated"], f"qwen3-moe step {rec['step']}: the finite gate tripped")
    check(res["params"] == cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model,
          f"qwen3-moe {MOE_LAYERS}-layer params {res['params']}")
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    check(res["peak_mem_gb"] < total_gb, f"peak {res['peak_mem_gb']} GB of {total_gb} GB")
    print(f"[moe] [{smi}] {MOE_ARCH} at {MOE_LAYERS} layers ({res['params']} params, bf16), "
          f"hier + int8, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: step {res['step_ms']:.3f} ms "
          f"(median of steps 1-{TRAIN_STEPS - 1}), {res['tokens_per_s']:.1f} tokens/s, peak "
          f"{res['peak_mem_gb']:.3f} GB of {total_gb:.3f} GB, losses "
          f"{[r['loss'] for r in res['records']]}, aux {[r['aux'] for r in res['records']]}; "
          f"launches per step {want}")
    res["counts"] = counts
    return res


def router_flips(ids_a: list, ids_b: list) -> torch.Tensor:
    """Per token, the number of layers whose routed expert set differs
    between two runs of one prompt."""
    flips = torch.zeros(ids_a[0].shape[0], dtype=torch.long)
    for a, b in zip(ids_a, ids_b):
        flips += (a.sort(-1).values != b.sort(-1).values).any(-1).long()
    return flips


def serve_moe_tp(dev, smi: str) -> tuple[dict[str, int], dict]:
    """Phase (d), serving: qwen3-moe-30b-a3b at MOE_LAYERS layers served
    at TP 2 (expert parallelism: 64 experts and 16 Q / 2 KV heads per rank;
    two spawned ranks on the one card through gloo) against TP 1 at the
    same depth and seed, capacity factor MOE_TP_FACTOR on both sides, so
    that no token can drop and both compute one function.  Each rank is
    checked as the TP-1 path is; the prefill logits of each prompt's last
    token within ``tp_logit_tol`` of the largest TP-1 logit plus
    MOE_FLIP_TOL per router flip at that token (its top-8 set differing
    from TP 1's in a layer) and MOE_FLIP_TOL x sqrt(flips elsewhere in its
    prompt) / PROMPT for what attention carries from the other tokens."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    with MoeTrace(MOE_LAYERS) as trace:
        ref = disaggregated.run(MOE_ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                                device=dev, layers=MOE_LAYERS,
                                moe_capacity_factor=MOE_TP_FACTOR)
    ref.update(trace.result())
    free_memory()
    ranks = _spawn_tp("moe_serve", 2)
    label = f"qwen3-moe TP 2 ep ({MOE_LAYERS} layers)"
    total = dict.fromkeys(ranks[0]["counts"], 0)
    for r, res in enumerate(ranks):
        phases = res["launches"]
        expect = {"prefill": {"flash_attention_bhsd": MOE_LAYERS * res["prefills"]},
                  "int8_transfer": {"quant_int8": 2 * res["int8_transfers"],
                                    "dequant_int8": 2 * res["int8_transfers"]},
                  "raw_transfer": {}, "decode": {}}
        for phase, want in expect.items():
            got = {k: n for k, n in phases[phase].items() if n}
            check(got == want, f"{label} rank {r} {phase} launches {got}, expected {want}")
        check(res["counts"] == {k: sum(p[k] for p in phases.values()) for k in res["counts"]},
              f"{label} rank {r}: launches {res['counts']} against the phases {phases}")
        leaf = [MOE_LAYERS, BATCH, PROMPT, cfg.n_kv_heads // 2, cfg.head_dim]
        check(res["cache_shapes"]["k"] == leaf == res["cache_shapes"]["v"],
              f"{label} rank {r} cache {res['cache_shapes']}")
        check(res["raw_transfer_exact"] and res["cache_finite"],
              f"{label} rank {r}: raw transfer exact {res['raw_transfer_exact']}")
        check(torch.equal(torch.tensor(res["tokens"]), torch.tensor(ranks[0]["tokens"])),
              f"{label}: rank {r} generated other tokens than rank 0")
        check(sum(res["drops"]) == 0, f"{label} rank {r} dropped {sum(res['drops'])} tokens")
        for k, n in res["counts"].items():
            total[k] += n
    check(sum(ref["drops"]) == 0, f"qwen3-moe TP 1 dropped {sum(ref['drops'])} tokens")
    flips = router_flips(ref["route_ids"], ranks[0]["route_ids"]).view(BATCH, PROMPT)
    logits = torch.cat([res["prefill_logits"] for res in ranks], dim=-1)[:, :cfg.vocab_size]
    want = ref["prefill_logits"]
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    scale = want.abs().max().item()
    diffs, tols = [], []
    for b in range(BATCH):
        last = flips[b, -1].item()
        tol = (tp_logit_tol(MOE_LAYERS, 2) + MOE_FLIP_TOL * last
               + MOE_FLIP_TOL * math.sqrt(flips[b, :-1].sum().item()) / PROMPT)
        diffs.append((logits[b] - want[b]).abs().max().item())
        tols.append(tol)
        check(diffs[-1] <= tol * scale, f"{label}: prompt {b} logits differ by {diffs[-1]} "
              f"(tol {tol} x {scale}; {last} flips at its last token)")
    tokens, ref_tokens = torch.tensor(ranks[0]["tokens"]), torch.tensor(ref["tokens"])
    greedy = (tokens == ref_tokens).float().mean().item()
    print(f"[moe] {label} against TP 1 at the same depth and seed, capacity factor "
          f"{MOE_TP_FACTOR}, no token dropped on either side: router flips (token, layer) "
          f"{int(flips.sum())} of {BATCH * PROMPT * MOE_LAYERS}, at the last tokens "
          f"{flips[:, -1].tolist()}; last-token logit max abs diff per prompt "
          f"{[f'{d:.4g}' for d in diffs]} against tol {[f'{t:.4g}' for t in tols]} x the "
          f"largest TP-1 logit {scale:.4g}; greedy agreement over {GEN + 1} tokens {greedy:.4f}")
    print(f"[moe] [{smi}] TP 1 ({MOE_LAYERS} layers, factor {MOE_TP_FACTOR}): TTFT "
          f"{ref['ttft_ms']:.2f} ms, decode {ref['decode_ms_per_step']:.2f} ms/step")
    for r, res in enumerate(ranks):
        print(f"[moe] [{smi}] {label} rank {r}, gloo on one card: TTFT {res['ttft_ms']:.2f} "
              f"ms, decode {res['decode_ms_per_step']:.2f} ms/step, peak memory "
              f"{res['peak_mem_gb']:.3f} GB, int8 token agreement "
              f"{res['int8_token_agreement']:.4f}, raw transfer exact")
    summary = {"logit_max_abs_diff": diffs, "logit_tol": tols, "logit_scale": scale,
               "router_flips": int(flips.sum()), "last_token_flips": flips[:, -1].tolist(),
               "greedy_agreement": greedy,
               "tp1": {k: ref[k] for k in ("ttft_ms", "decode_ms_per_step", "peak_mem_gb")},
               "ranks": [{k: res[k] for k in ("ttft_ms", "decode_ms_per_step", "peak_mem_gb")}
                         for res in ranks]}
    return total, summary


def attention_ms(dev, cfg) -> float:
    """Device time of one layer's training attention, forward + backward,
    at the training shape; a layer runs its forward twice (once more in
    the checkpoint's recompute)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    p = {k: v.requires_grad_(True)
         for k, v in attention.init_attention(gen, cfg, 1, cfg.dtype).items()}
    x = (torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, device=dev, generator=gen)
         .to(cfg.dtype).requires_grad_(True))
    rt = runtime_for_groups()
    dy = torch.randn_like(x)

    def fwd_bwd():
        torch.autograd.backward(attention.attention_train(p, x, cfg, rt), dy)

    with torch.no_grad():
        fwd = time_ms(lambda: attention.attention_train(p, x, cfg, rt), 5)
    return fwd + time_ms(fwd_bwd, 5)


# an SSM's training ranges: the plain SSD and the conv, forward and the
# checkpoint's recompute (their backward kernels run outside the ranges)
SSM_TRAIN_RANGES = TRAIN_RANGES + ("ssd_plain", "causal_conv1d")


def profile_training(dev, rt, smi: str, mode: str, codec: str | None,
                     with_attention: bool, planned=None, arch: str = ARCH,
                     seq: int = TRAIN_SEQ, layers: int | None = None,
                     batch: int = TRAIN_BATCH) -> dict:
    """One full-width training step of ``arch`` (``layers`` cuts the depth)
    at ``batch`` x ``seq`` tokens under torch.profiler, after one warm-up step: device time by kernel
    group (the codec kernels, the pack, matmul, the rest of the gradient
    sync, the gradient norm, the optimizer, an SSM's plain SSD and conv,
    everything else) and the device's idle share; then one optimizer
    update timed apart (``optimizer_ms``).  With ``planned`` the plan's
    path."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    ranges = SSM_TRAIN_RANGES if cfg.family in ("ssm", "hybrid") else TRAIN_RANGES
    model = Model(cfg, rt, dev)
    ocfg = opt_lib.OptConfig(warmup_steps=20)
    tcfg = (TrainConfig(comm_mode=mode, dcn_compression=codec, opt=ocfg) if planned is None
            else TrainConfig(comm_mode=planned.mode, dcn_compression=codec, plan=planned.plan,
                             packed=planned.packed, cluster_weights=planned.cluster_weights,
                             opt=ocfg))
    step_fn, init_fn = make_train_step(model, tcfg)
    opt = init_fn(0)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=batch, seq_len=seq)
    b = {k: torch.from_numpy(v).long().to(dev) for k, v in synth_batch(dcfg, 0).items()}
    step_fn(opt, b)                                       # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(opt, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    what = f"{mode} + {codec}" + ("" if planned is None else " as planned, per leaf")
    out = _report(prof, wall, f"{cfg.name} training step {batch}x{seq}, {what}",
                  smi, TRAIN_GROUPS, ranges)
    if mode == "hier_overlap" and planned is None:
        out["overlap"] = ov = overlap_timeline(prof)
        print(f"[time] [{smi}] hier_overlap's profiled step: {ov['syncs_begun_before']} of "
              f"{ov['syncs']} bucket syncs began before the backward's last kernel "
              f"({ov['last_backward_kernel']}); device time from the first bucket's codec "
              f"kernel to that kernel's end {ov['overlap_ms']:.3f} ms")
    out["optimizer_timed_apart"] = optimizer_ms(model, opt, opt_lib.OptConfig())
    print(f"[profile] [{smi}] {mode}'s optimizer update, timed apart: device time "
          f"{out['optimizer_timed_apart']['device_ms']:.3f} ms, event-timed "
          f"{out['optimizer_timed_apart']['ms']:.3f} ms")
    del model, opt, step_fn, init_fn
    free_memory()
    if not with_attention:
        return out
    out["attention_ms_timed_apart"] = attn = attention_ms(dev, cfg) * cfg.n_layers
    print(f"[profile] [{smi}] training attention, timed apart ({cfg.n_layers} layers x "
          f"(forward + forward/backward)): {attn:.3f} ms, inside matmul and other")
    return out


def overlap_timeline(prof) -> dict:
    """hier_overlap on the device timeline of one profiled step (one
    stream): each bucket's sync is a device-side ``grad_sync`` span; the
    backward's last kernel is the last kernel outside every such span
    that ran before the ``grad_norm`` range.  How many syncs began before
    it, and the device time from the first codec kernel (bucket 0's
    amax_block) to its end."""
    evs = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in evs
                   if ev.is_user_annotation and ev.name == "grad_sync")
    norm = [ev.time_range.start for ev in evs if ev.is_user_annotation and ev.name == "grad_norm"]
    check(bool(spans) and bool(norm), "no device-side grad_sync or grad_norm span in the profile")
    kernels = sorted((ev for ev in evs if not ev.is_user_annotation
                      and ev.time_range.start < min(norm)), key=lambda ev: ev.time_range.start)
    compute = [ev for ev in kernels
               if not any(s <= ev.time_range.start <= e for s, e in spans)]
    codec = [ev for ev in kernels if "amax_block" in ev.name]
    check(bool(compute) and bool(codec), "no backward or codec kernel before grad_norm")
    last, first = compute[-1], codec[0]
    return {"syncs": len(spans),
            "syncs_begun_before": sum(s < last.time_range.start for s, _ in spans),
            "last_backward_kernel": last.name[:60],
            "overlap_ms": (last.time_range.end - first.time_range.start) / 1e3}


def optimizer_ms(model, opt, ocfg) -> dict[str, float]:
    """One update of the live optimizer state outside the step: the
    profile's ``optimizer`` range without the profiler's attribution of
    kernels to ranges.  ``device_ms`` sums its kernels' device time;
    ``ms`` spans it with CUDA events, so it also holds the gaps a slower
    host leaves.  The moments (ZeRO-1) or the parameters stand in for the
    gradients."""
    if isinstance(opt, opt_lib.ZeroState):
        def update():
            opt_lib.zero_update(opt.mu, opt, ocfg, 0.5)
    else:
        params, decay = opt_lib.flat_params(model.train_leaves())

        def update():
            opt_lib.adam_update(params, opt, params, decay, ocfg, 0.5)
    return {"device_ms": device_ms(update, iters=3), "ms": time_ms(update, 3, warmup=1)}


def train_full_width(dev, smi: str, mode: str, codec: str | None, arch: str = ARCH,
                     seq: int = TRAIN_SEQ, layers: int | None = None) -> dict:
    """A training main path; the launch counts are set to 0 just before
    it and read just after.  mamba2-2.7b and hymba-1.5b have two wire
    segments (bf16, and f32 for dt_bias, A_log and D_skip), and train
    their SSD and attention through the plain versions: no ssd_chunk and
    no flash launch; whisper-tiny's encoder and cross-attention train
    through the plain attention too.  ``layers`` cuts the depth (its
    parameters then ``param_count()`` plus the 2 L + 1 RMS norm scales, a
    rule for the dense and VLM families)."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    ops.reset_launch_counts()
    res = train_launch.run(arch, steps=TRAIN_STEPS, mode=mode, compression=codec,
                           global_batch=TRAIN_BATCH, seq=seq, device=dev, layers=layers,
                           log=lambda line: print(f"[train] {line}"))
    counts = ops.launch_counts()
    want = train_kernels(mode, codec, cfg)
    boot = bootstrap_kernels(mode)
    check(counts == {k: n * TRAIN_STEPS + boot.get(k, 0) for k, n in want.items()},
          f"{mode} launches {counts} over {TRAIN_STEPS} steps and the bootstrap {boot}")
    check_vector_launches(counts, mode)
    for rec in res["records"]:
        launched = {k: rec["launches"][k] for k in want}
        check(launched == want, f"{mode} step {rec['step']} launches {launched}")
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["gnorm"]),
              f"step {rec['step']}: loss {rec['loss']}, grad norm {rec['gnorm']}")
        check(not rec["gated"], f"step {rec['step']}: the finite gate tripped")
    want_params = (FULL_PARAMS[arch] if layers is None
                   else cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model)
    check(res["params"] == want_params, f"params {res['params']}, expected {want_params}")
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    check(res["peak_mem_gb"] < total_gb, f"peak {res['peak_mem_gb']} GB of {total_gb} GB")
    losses = [r["loss"] for r in res["records"]]
    frames = f" and {TRAIN_BATCH} x {cfg.enc_seq} frames" if cfg.n_enc_layers else ""
    print(f"[train] [{smi}] {res['arch']} ({res['params']} params, bf16, {cfg.n_layers} "
          f"layers), {mode} + {codec} over a pod and a data group of one, {TRAIN_BATCH} x "
          f"{seq} tokens{frames}: "
          f"step {res['step_ms']:.3f} ms (median of steps 1-{TRAIN_STEPS - 1}), "
          f"{res['tokens_per_s']:.1f} tokens/s, peak memory {res['peak_mem_gb']:.3f} GB of "
          f"the card's {total_gb:.3f} GB, losses {losses}; launches per step {want}, "
          f"before the steps {boot}")
    res["counts"] = counts
    return res


def train_planned(dev, smi: str, planned, steps: int, label: str, **run_kw) -> dict:
    """A planned training main path through ``run``: the launch counts
    are set to 0 just before it and read just after; every step launches
    what ``planned_kernels`` expects, and the plan run is ``planned``'s."""
    cfg = get_config(ARCH)
    want = planned_kernels(planned, cfg)
    ops.reset_launch_counts()
    res = train_launch.run(ARCH, steps=steps, global_batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                           device=dev, log=lambda line: print(f"[train] {line}"), **run_kw)
    counts = ops.launch_counts()
    vector = ops.vector_launch_counts()
    check(res["plan"] == planned.plan.summary(), f"{label}: ran another plan")
    check((res["mode"], res["packed"]) == (planned.mode, planned.packed),
          f"{label}: mode {res['mode']}, packed {res['packed']}")
    check(counts == {k: n * steps for k, n in want.items()},
          f"{label} launches {counts} over {steps} steps")
    for rec in res["records"]:
        launched = {k: rec["launches"][k] for k in want}
        check(launched == want, f"{label} step {rec['step']} launches {launched}")
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["gnorm"]),
              f"step {rec['step']}: loss {rec['loss']}, grad norm {rec['gnorm']}")
        check(not rec["gated"], f"step {rec['step']}: the finite gate tripped")
    check(res["params"] == 3_085_938_688, f"params {res['params']}")
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    check(res["peak_mem_gb"] < total_gb, f"peak {res['peak_mem_gb']} GB of {total_gb} GB")
    # the per-leaf path re-flattens its buffers without the packed layout's
    # alignment: report which codec launches took the vector variant
    split = {k: f"{vector[k]} vector, {counts[k] - vector[k]} scalar" for k in vector}
    cands = sorted({(b["mode"], b["n_chunks"], b["compression"])
                    for b in res["plan"]["buckets"]}, key=str)
    print(f"[train] [{smi}] {label}: {res['arch']} planned for {res['plan']['n_clusters']} "
          f"cluster(s) -> {res['mode']}, packed {res['packed']}, bucket schedules {cands}; "
          f"step {res['step_ms']:.3f} ms ("
          + (f"median of steps 1-{steps - 1}" if steps > 1 else "its one step")
          + f"), {res['tokens_per_s']:.1f} tokens/s, peak memory {res['peak_mem_gb']:.3f} GB of "
          f"{total_gb:.3f} GB, losses {[r['loss'] for r in res['records']]}; launches per "
          f"step {want}; codec launches {split}; plan cache {res['plan_cache']}")
    res["counts"] = counts
    res["vector"] = vector
    return res


def train_planned_paths(dev, smi: str) -> tuple[dict, dict]:
    """(a) The entry point as a user runs it on one card: --plan auto
    --skew auto on a cache file, then a second launch on that file, which
    must hit.  (b) The plan the launcher makes for PLAN_WORLD, run in the
    world of one (``plan_world``): the per-leaf hier_overlap sync with
    int8 on its largest bucket."""
    cfg = get_config(ARCH)
    quiet = dict(log=lambda line: None, global_batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    entry = train_launch.make_plan(cfg, 1, 1, "hier", None, plan="auto", skew="auto", **quiet)
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(plan="auto", skew="auto", plan_cache=str(pathlib.Path(tmp) / "plans.pkl"))
        a = train_planned(dev, smi, entry, PLANNED_STEPS, "(a) --plan auto --skew auto", **kw)
        free_memory()
        again = train_planned(dev, smi, entry, 1, "(a) second launch on the cache", **kw)
        free_memory()
    check(a["plan_cache"]["misses"] > 0, f"first launch: plan cache {a['plan_cache']}")
    check(again["plan_cache"]["hits"] > 0 == again["plan_cache"]["misses"],
          f"second launch: plan cache {again['plan_cache']}")
    check(sum(a["counts"].values()) == 0, f"(a) launched {a['counts']}")
    pods, per_pod = PLAN_WORLD
    kernels = train_launch.make_plan(cfg, pods, pods * per_pod, "hier", "int8", plan="auto",
                                     **quiet)
    check((kernels.mode, kernels.packed) == ("hier_overlap", False),
          f"(b) planned {kernels.mode}, packed {kernels.packed}")
    check(any((b.candidate.mode, b.candidate.n_chunks, b.candidate.compression)
              == ("hier_pipelined", 32, "int8") for b in kernels.plan.buckets),
          "(b) no bucket on hier_pipelined with 32 chunks and int8")
    b = train_planned(dev, smi, kernels, PLANNED_STEPS,
                      f"(b) the plan for {pods} pods x {per_pod} ranks",
                      mode="hier", compression="int8", plan="auto", plan_world=PLAN_WORLD)
    check(b["counts"]["amax_block"] > 0, "(b) launched no codec kernel")
    return a, b


# ---------------------------------------------------------------------------
# Tensor parallelism: ranks as processes sharing the one card over gloo
# ---------------------------------------------------------------------------

TP_DEPTH = 4          # phase (b)'s layers: TP 4, replicated KV
TP_TRAIN_STEPS = 3
# mamba2-2.7b at TP 2: 16 of its 64 layers, so that the script stays within
# ~10 minutes (at 64 layers the whole run took 940.7 s on a slow host)
SSM_TP_DEPTH = 16
# the f32 smoke models trained at TP 2 (and hymba's at TP 8, its heads
# padded): job -> (arch, TP size)
# the TP-8 job's grad norms, card against CPU (train_tp)
TP8_NORM_TOL = 1e-3
TP_TRAIN_JOBS = {"train": (ARCH, 2), "moe_train": (MOE_ARCH, 2), "ssm_train": (SSM_ARCH, 2),
                 "hybrid_train": (HYBRID_ARCH, 2), "hybrid_train8": (HYBRID_ARCH, 8)}


def tp_logit_tol(layers: int, tp: int) -> float:
    """The bound on the prefill logits of TP ``tp`` against TP 1 (bf16), as
    a share of the largest TP-1 logit.  Each row-parallel sublayer (two a
    layer) rounds its ``tp`` partial sums to bf16 and adds them in bf16,
    2 tp - 1 roundings of relative 2^-9 where TP 1 rounds once: about 2 tp
    per sublayer between the two.  Over the 2 x layers sublayers they add
    like a random walk to sqrt(4 layers tp) 2^-9 of an activation (3.3% at 36
    layers and TP 2, 1.6% at 4 layers and TP 4).  The largest logit lies
    ~4.5 sigma out of the logits' spread and the largest error of 4 x
    151936 ~4.9 sigma out of the errors', so the expected largest
    difference is ~1.09 x that share; the bound is 1.7 x it, 2^-4 at 36
    layers and TP 2."""
    return 2 ** -4 * math.sqrt(layers * tp / (36 * 2))


# mamba2-2.7b's TP-2 logits in f32 against TP 1 with the gated norm over the
# same two channel groups (the function TP 2 computes, ROADMAP R18), as a
# share of the largest logit.  Each layer's out_proj sums its 5120 products
# in another order at TP 2: ~2^-24 sqrt(5120) = 4.3e-6 of its output.  The
# random model grows such a difference through its 64 layers: at d_model
# 512, f32, TP 2 lay 7.2e-4 of the largest logit from the grouped TP 1
# (``tools/ssm_tp_norm.py``, on the CPU); at full width the per-layer part
# is sqrt(5) larger (K 5120 against 1024), 1.6e-3, and the bound takes 12x
# that for the card's GEMMs, which split K otherwise (at 64 layers the
# card read 1.848e-3 of 4.262; SSM_TP_DEPTH's 16 layers grow less).  R18
# alone moves the logits by O(1) of the largest (1.77 of 1.33 at d_model
# 256, f32; 5.575 of 4.262 on the card at 64 layers).
SSM_TP_F32_TOL = 2e-2


@contextlib.contextmanager
def grouped_gated_norm(groups: int):
    """TP 1's Mamba2 gated norm taken over ``groups`` equal channel groups,
    as each of ``groups`` TP ranks takes it over its own channels (ROADMAP
    R18): the function the reference computes at TP ``groups``."""
    def gated_out(p, y, z, x_dtype, rt):
        y = y.float() * F.silu(z.float())
        parts = [model_layers.apply_norm({"scale": sc}, part, "rmsnorm")
                 for part, sc in zip(y.chunk(groups, -1), p["norm_scale"].chunk(groups, -1))]
        return reduce_from_tp(torch.cat(parts, -1).to(x_dtype) @ p["w_out"], rt.tp_group)

    plain, ssm_model._gated_out = ssm_model._gated_out, gated_out
    try:
        yield
    finally:
        ssm_model._gated_out = plain


def ssm_f32_logits(dev, rt) -> torch.Tensor:
    """Last-token prefill logits (B, this rank's vocabulary) of mamba2-2.7b
    in f32 at SSM_TP_DEPTH layers, on the serving path's prompt."""
    cfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=SSM_TP_DEPTH, dtype=torch.float32)
    model = Model(cfg, rt, dev).init(0)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),   # disaggregated.run's, seed 0
                           generator=torch.Generator().manual_seed(1)).to(dev)
    logits = model.apply_prefill(prompt)[0][:, -1].cpu()
    del model
    free_memory()
    return logits


def _tp_rank(rank: int, world: int, job: str, out_dir: str, device: str = "cuda") -> dict:
    """One TP rank (a process of its own, on the one card, gloo; started
    by ``spawn_world``): runs ``job`` and returns what it measured;
    ``out_dir`` is a directory the ranks share."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    train_launch.init_world(dev, "gloo")
    try:
        ops.reset_launch_counts()
        if job in TP_TRAIN_JOBS:
            out = _tp_train(dev, world, TP_TRAIN_JOBS[job][0])
        elif job == "pp":
            out = _pp_rank(dev)
        elif job in PAD_SERVE:
            arch = job
            out = disaggregated.run(arch, batch=BATCH, gen=PAD_GEN[arch], device=dev, tp=world,
                                    prompt_len=HYBRID_SEQ if arch == HYBRID_ARCH else PROMPT)
        elif job == "elastic":
            out = _elastic_rank(dev, rank, out_dir)
        elif job == "ssm_serve":
            out = disaggregated.run(SSM_ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                                    device=dev, tp=world, layers=SSM_TP_DEPTH)
        elif job == "moe_serve":
            with MoeTrace(MOE_LAYERS) as trace:
                out = disaggregated.run(MOE_ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                                        device=dev, tp=world, layers=MOE_LAYERS,
                                        moe_capacity_factor=MOE_TP_FACTOR)
            out.update(trace.result())
        else:
            out = disaggregated.run(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN, device=dev,
                                    tp=world, layers=TP_DEPTH if job == "serve4" else None)
        out["counts"], out["vector"] = ops.launch_counts(), ops.vector_launch_counts()
        if job == "ssm_serve":      # after the main path's counts: the f32 function
            free_memory()
            out["logits_f32"] = ssm_f32_logits(
                dev, runtime_for_groups(pods=1, data_per_pod=1, tp=world))
        if job == HYBRID_ARCH:      # after the main path's counts: card against CPU
            free_memory()
            out["f32"] = padded_f32_serve(dev, world)
        return out
    finally:
        dist.destroy_process_group()


def _tp_train(dev, tp: int, arch: str) -> dict:
    """hier + int8 on ``arch``'s f32 smoke model at TP ``tp`` (one replica:
    pod and data groups of one; an MoE model by expert parallelism),
    TP_TRAIN_STEPS steps on the CPU and then on the card from the same
    parameters and batches; the card's launches per step."""
    rt = runtime_for_groups(pods=1, data_per_pod=1, tp=tp)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    cpu = Model(cfg, rt, device="cpu").init(0)
    gpu = copy.deepcopy(cpu, {id(rt): rt}).to(dev)
    tcfg = TrainConfig(comm_mode="hier", dcn_compression="int8",
                       opt=opt_lib.OptConfig(lr=1e-3, warmup_steps=1))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=64)
    out = {"want": train_kernels("hier", "int8", cfg)}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        step_fn, _ = make_train_step(model, tcfg)
        opt = opt_lib.adam_init(opt_lib.flat_params(model.train_leaves())[0])
        metrics, launches = [], []
        if model is gpu:
            ops.reset_launch_counts()
        for i in range(TP_TRAIN_STEPS):
            b = {k: torch.from_numpy(v).long().to(model.device)
                 for k, v in synth_batch(dcfg, i).items()}
            before = ops.launch_counts()
            m = step_fn(opt, b)
            after = ops.launch_counts()
            launches.append({k: after[k] - before[k] for k in after})
            metrics.append((m["loss"], m["grad_norm"], m["gated"]))
        out[name] = {"metrics": metrics, "launches": launches}
    return out


def _spawn_tp(job: str, world: int) -> list[dict]:
    """``world`` TP ranks of ``job`` as processes on the one card; each
    rank's results.  Every process is joined or killed before it returns."""
    with tempfile.TemporaryDirectory() as tmp:
        return spawn_world(_tp_rank, world, world, job, tmp, timeout=600)


def serve_tp(smi: str, tp: int, ref: dict) -> tuple[dict[str, int], dict]:
    """Phase (a) (TP 2, 36 layers) or (b) (TP 4, TP_DEPTH layers): the
    server's TP ranks, each checked as the TP-1 path is (launches per
    phase, the raw transfer exact, cache shapes at the local heads, vector
    launches), then held together against ``ref``, the TP-1 run of the
    same depth and seed: prefill logits within ``tp_logit_tol`` of the
    largest TP-1 logit.  Returns the launches summed over the ranks and
    what was measured."""
    cfg = get_config(ARCH)
    job = "serve2" if tp == 2 else "serve4"
    ranks = _spawn_tp(job, tp)
    depth = ranks[0]["layers"]
    kl = cfg.local_q_heads(tp) if cfg.kv_replicated(tp) else cfg.padded_kv_heads(tp) // tp
    label = f"TP {tp} ({depth} layers)"
    total = dict.fromkeys(ranks[0]["counts"], 0)
    for r, res in enumerate(ranks):
        phases = res["launches"]
        expect = {"prefill": {"flash_attention_bhsd": depth * res["prefills"]},
                  "int8_transfer": {"quant_int8": 2 * res["int8_transfers"],
                                    "dequant_int8": 2 * res["int8_transfers"]},
                  "raw_transfer": {}, "decode": {}}
        for phase, want in expect.items():
            got = {k: n for k, n in phases[phase].items() if n}
            check(got == want, f"{label} rank {r} {phase} launches {got}, expected {want}")
        check(res["counts"] == {k: sum(p[k] for p in phases.values()) for k in res["counts"]},
              f"{label} rank {r}: launches {res['counts']} against the phases {phases}")
        check(all(res["vector"][k] == res["counts"][k] for k in res["vector"]),
              f"{label} rank {r}: vector launches {res['vector']} of {res['counts']}")
        leaf = [depth, BATCH, PROMPT, kl, cfg.head_dim]
        check(res["cache_shapes"]["k"] == leaf == res["cache_shapes"]["v"],
              f"{label} rank {r} cache {res['cache_shapes']}")
        check(res["raw_transfer_exact"] and res["cache_finite"],
              f"{label} rank {r}: raw transfer exact {res['raw_transfer_exact']}, cache "
              f"finite {res['cache_finite']}")
        check(torch.equal(torch.tensor(res["tokens"]), torch.tensor(ranks[0]["tokens"])),
              f"{label}: rank {r} generated other tokens than rank 0")
        for k, n in res["counts"].items():
            total[k] += n
    logits = torch.cat([res["prefill_logits"] for res in ranks], dim=-1)[:, :cfg.vocab_size]
    want = ref["prefill_logits"]
    diff = (logits - want).abs()
    scale = want.abs().max().item()
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    tol = tp_logit_tol(depth, tp)
    check(diff.max().item() <= tol * scale,
          f"{label}: prefill logits differ from TP 1 by {diff.max().item()} (scale {scale})")
    tokens, ref_tokens = torch.tensor(ranks[0]["tokens"]), torch.tensor(ref["tokens"])
    first = (tokens[:, 0] == ref_tokens[:, 0]).float().mean().item()
    greedy = (tokens == ref_tokens).float().mean().item()
    print(f"[tp] {label} against TP 1 at the same depth and seed: prefill logits max abs "
          f"diff {diff.max().item():.4g}, mean {diff.mean().item():.4g} (tol {tol:.4g} x "
          f"the largest TP-1 logit {scale:.4g} = {tol * scale:.4g}); first-token "
          f"agreement {first:.4f}, greedy agreement over {GEN + 1} tokens {greedy:.4f}")
    for r, res in enumerate(ranks):
        print(f"[tp] [{smi}] {label} rank {r}, gloo TP group on one card: TTFT "
              f"{res['ttft_ms']:.2f} ms, decode {res['decode_ms_per_step']:.2f} ms/step, int8 "
              f"transfer of its {res['cache_bytes']} cache bytes {res['int8_transfer_ms']:.2f} "
              f"ms, peak memory {res['peak_mem_gb']:.3f} GB, int8 token agreement "
              f"{res['int8_token_agreement']:.4f}, raw transfer exact; launches by phase "
              f"{ {p: {k: n for k, n in c.items() if n} for p, c in res['launches'].items()} }")
    summary = {"logit_max_abs_diff": diff.max().item(), "logit_scale": scale,
               "logit_tol": tol,
               "first_token_agreement": first, "greedy_agreement": greedy,
               "ranks": [{k: res[k] for k in ("ttft_ms", "decode_ms_per_step",
                                              "int8_transfer_ms", "peak_mem_gb")}
                         for res in ranks]}
    return total, summary


def serve_ssm_tp(dev, smi: str) -> tuple[dict[str, int], dict]:
    """mamba2-2.7b at TP 2 (SSM_TP_DEPTH layers; 40 heads and 2560 + 256
    conv channels per rank), two spawned ranks on the one card through
    gloo.  The served bf16 path through ``disaggregated.run``, each rank
    checked as the TP-1 path is (ssd_chunk once per layer per prefill, the
    codec twice per int8 transfer, nothing in decode, the raw transfer
    exact, its cache shard's shapes).  Then the function in f32: each
    rank's prefill logits within SSM_TP_F32_TOL of TP 1's with the gated
    norm over the same two channel groups (``grouped_gated_norm``, R18),
    from the same seed.  How far the f32 TP-2 logits lie from plain TP 1
    (R18) is printed."""
    cfg = get_config(SSM_ARCH)
    tp = 2
    cfg32 = dataclasses.replace(cfg, n_layers=SSM_TP_DEPTH, dtype=torch.float32)
    model = Model(cfg32, runtime_for_groups(), dev).init(0)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    plain32 = model.apply_prefill(prompt)[0][:, -1, :cfg.vocab_size].cpu()
    with grouped_gated_norm(tp):
        grouped32 = model.apply_prefill(prompt)[0][:, -1, :cfg.vocab_size].cpu()
    del model
    free_memory()
    ranks = _spawn_tp("ssm_serve", tp)
    depth = ranks[0]["layers"]
    check(depth == SSM_TP_DEPTH, f"TP 2 depth {depth}")
    label = f"mamba2-2.7b TP {tp} ({depth} layers)"
    di_l, gn = cfg.d_inner // tp, cfg.ssm_groups * cfg.ssm_state
    want_shapes = {"conv": [depth, BATCH, cfg.conv_width - 1, di_l + 2 * gn],
                   "ssm": [depth, BATCH, cfg.ssm_heads() // tp, cfg.ssm_head_dim,
                           cfg.ssm_state], "length": [depth]}
    total = dict.fromkeys(ranks[0]["counts"], 0)
    for r, res in enumerate(ranks):
        phases = res["launches"]
        expect = {"prefill": {"ssd_chunk": depth * res["prefills"]},
                  "int8_transfer": {"quant_int8": 2 * res["int8_transfers"],
                                    "dequant_int8": 2 * res["int8_transfers"]},
                  "raw_transfer": {}, "decode": {}}
        for phase, want in expect.items():
            got = {k: n for k, n in phases[phase].items() if n}
            check(got == want, f"{label} rank {r} {phase} launches {got}, expected {want}")
        check(res["counts"] == {k: sum(p[k] for p in phases.values()) for k in res["counts"]},
              f"{label} rank {r}: launches {res['counts']} against the phases {phases}")
        check(all(res["vector"][k] == res["counts"][k] for k in res["vector"]),
              f"{label} rank {r}: vector launches {res['vector']} of {res['counts']}")
        check(res["cache_shapes"] == want_shapes, f"{label} rank {r} cache {res['cache_shapes']}")
        check(res["raw_transfer_exact"] and res["cache_finite"],
              f"{label} rank {r}: raw transfer exact {res['raw_transfer_exact']}, cache "
              f"finite {res['cache_finite']}")
        check(torch.equal(torch.tensor(res["tokens"]), torch.tensor(ranks[0]["tokens"])),
              f"{label}: rank {r} generated other tokens than rank 0")
        for k, n in res["counts"].items():
            total[k] += n
    logits32 = torch.cat([res["logits_f32"] for res in ranks], dim=-1)[:, :cfg.vocab_size]
    check(bool(torch.isfinite(logits32).all()), f"{label}: non-finite f32 logits")
    scale32 = grouped32.abs().max().item()
    diff32 = (logits32 - grouped32).abs().max().item()
    check(diff32 <= SSM_TP_F32_TOL * scale32,
          f"{label}, f32: logits differ from TP 1 with 2 norm groups by {diff32} (largest "
          f"{scale32})")
    r18 = (logits32 - plain32).abs().max().item()
    logits = torch.cat([res["prefill_logits"] for res in ranks], dim=-1)[:, :cfg.vocab_size]
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    print(f"[tp] {label}, f32 from the same seed: prefill logits {diff32:.4g} from TP 1 with "
          f"the gated norm over the same 2 channel groups (tol {SSM_TP_F32_TOL} x the largest "
          f"{scale32:.4g} = {SSM_TP_F32_TOL * scale32:.4g}), and {r18:.4g} from plain TP 1 "
          f"(ROADMAP R18, not held)")
    for r, res in enumerate(ranks):
        print(f"[tp] [{smi}] {label} rank {r}, gloo TP group on one card: TTFT "
              f"{res['ttft_ms']:.2f} ms, decode {res['decode_ms_per_step']:.2f} ms/step, int8 "
              f"transfer of its {res['cache_bytes']} cache bytes {res['int8_transfer_ms']:.2f} "
              f"ms, peak memory {res['peak_mem_gb']:.3f} GB, int8 token agreement "
              f"{res['int8_token_agreement']:.4f}, raw transfer exact")
    summary = {"f32_logit_diff_grouped": diff32, "f32_logit_scale": scale32,
               "f32_tol": SSM_TP_F32_TOL, "f32_logit_diff_plain": r18, "layers": depth,
               "ranks": [{k: res[k] for k in ("ttft_ms", "decode_ms_per_step",
                                              "int8_transfer_ms", "peak_mem_gb")}
                         for res in ranks]}
    return total, summary


def train_tp(smi: str, arch: str = ARCH, tp: int = 2) -> dict[str, int]:
    """Phase (c) (and the MoE phase (d) with ``arch`` MOE_ARCH, and the SSM
    families with SSM_ARCH and HYBRID_ARCH, hymba's also at ``tp`` 8, its
    heads padded): hier + int8 on the f32 smoke model at TP ``tp``, on the
    card and on the CPU in the same world:
    losses and grad norms within 1e-4 (relative), the finite gate open,
    and the codec and pack kernels launched per step on each rank's own
    gradient segment.  The dense ranks report one replica's metrics;
    under expert parallelism each rank's router copy takes its own
    gradient (ROADMAP R14), and an SSM's B/C projection and conv do too
    (R16), so there the ranks share the loss but not the grad norm, and
    the card against the CPU is held per rank.  At TP 8 the grad norms are
    held within TP8_NORM_TOL: each rank's int8 segment is an eighth as
    long, and one block whose rounding falls the other way between the
    card's and the CPU's f32 gradients moves the synced norm by up to an
    int8 step of that block's largest value (2.4e-4 of the norm at the
    third step on the card, where the losses agreed to 1e-7)."""
    ranks = _spawn_tp({v: k for k, v in TP_TRAIN_JOBS.items()}[arch, tp], tp)
    # a replicated leaf whose gradient no TP sum covers steps apart per rank:
    # the MoE router under ep (ROADMAP R14), the SSM's B/C projection and
    # conv (R16); each rank's loss, a sum over the TP group, stays one value
    drift = get_config(arch).family in ("moe", "ssm", "hybrid")
    norm_tol = 1e-4 if tp == 2 else TP8_NORM_TOL
    total = dict.fromkeys(ranks[0]["counts"], 0)
    for r, res in enumerate(ranks):
        want = res["want"]
        for i, launched in enumerate(res["gpu"]["launches"]):
            got = {k: launched[k] for k in want}
            check(got == want, f"TP {tp} training rank {r} step {i} launches {got}")
        check(not any(launched[k] for launched in res["cpu"]["launches"] for k in launched),
              f"TP {tp} training rank {r}: the CPU steps launched kernels")
        for (gl, gn, gg), (cl, cn, cg) in zip(res["gpu"]["metrics"], res["cpu"]["metrics"]):
            check(not (gg or cg), f"TP {tp} training rank {r}: the finite gate tripped")
            check(abs(gl - cl) / abs(cl) < 1e-4 and abs(gn - cn) / abs(cn) < norm_tol,
                  f"TP {tp} training rank {r}: card {gl, gn} against CPU {cl, cn}")
        check(arch == MOE_ARCH or all(
            abs(a - b) <= 1e-6 * abs(b) for m, m0 in zip(res["gpu"]["metrics"],
                                                         ranks[0]["gpu"]["metrics"])
            for a, b in zip(m[:1] if drift else m[:2], m0[:2])),
              f"TP {tp} training: rank {r}'s metrics differ from rank 0's")
        for k, n in res["counts"].items():
            total[k] += n
    gm, cm = ranks[0]["gpu"]["metrics"], ranks[0]["cpu"]["metrics"]
    errs = [max(abs(g[j] - c[j]) / abs(c[j]) for g, c in zip(gm, cm)) for j in (0, 1)]
    print(f"[tp] [{smi}] TP {tp} training, f32 smoke {arch}, hier + int8, {TP_TRAIN_STEPS} "
          f"steps, gloo TP group on one card: losses {[f'{m[0]:.6f}' for m in gm]}, grad "
          f"norms {[f'{m[1]:.6f}' for m in gm]}, max relative diff from the CPU's {tp}-rank "
          f"run: losses {errs[0]:.3g} (tol 1e-4), grad norms {errs[1]:.3g} (tol {norm_tol}); "
          f"launches per step and rank {ranks[0]['want']}")
    return total


# ---------------------------------------------------------------------------
# Head padding under TP, and GPipe over the pod group
# ---------------------------------------------------------------------------

def padded_f32_serve(dev, tp: int) -> dict:
    """This rank's part of hymba-1.5b at PAD_F32_LAYERS layers in f32 at TP
    ``tp``: the tree drawn on the CPU and copied to the card, then on each
    the last-token prefill logits (this rank's vocabulary shard) of one
    PAD_F32_PROMPT-token prompt and PAD_F32_GEN greedy decode steps.  The
    CPU side runs one thread a rank (the ranks share the host)."""
    rt = runtime_for_groups(pods=1, data_per_pod=1, tp=tp)
    cfg = dataclasses.replace(get_config(HYBRID_ARCH), n_layers=PAD_F32_LAYERS,
                              dtype=torch.float32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu = Model(cfg, rt, device="cpu").init(0)
        gpu = copy.deepcopy(cpu, {id(rt): rt}).to(dev)
        prompt = torch.randint(0, cfg.vocab_size, (1, PAD_F32_PROMPT),
                               generator=torch.Generator().manual_seed(2))
        out = {}
        for name, model in (("gpu", gpu), ("cpu", cpu)):
            _, decode = make_serve_steps(model)
            logits, caches = model.apply_prefill(prompt.to(model.device))
            tok = loss_lib.sharded_argmax(logits, rt, cfg.vocab_size)
            toks = [tok]
            for _ in range(PAD_F32_GEN):
                tok, caches = decode(tok, caches)
                toks.append(tok)
            out[name] = {"logits": logits[:, -1].cpu(), "tokens": torch.cat(toks, 1).cpu()}
            del caches
        del cpu, gpu
        free_memory()
        return out
    finally:
        torch.set_num_threads(threads)


def _cache_shapes(cfg, tp: int, prompt: int) -> dict[str, list[int]]:
    """A TP rank's cache leaves (hybrid or encoder-decoder) at full depth:
    the local KV heads (the gathered Q heads where KV is replicated), the
    local conv channels and SSM heads, the cross cache's frames."""
    kl = cfg.local_q_heads(tp) if cfg.kv_replicated(tp) else cfg.padded_kv_heads(tp) // tp
    L, window = cfg.n_layers, min(prompt, cfg.sliding_window or prompt)
    kv = [L, BATCH, window, kl, cfg.head_dim]
    shapes = {"kv.k": kv, "kv.v": kv, "kv.length": [L]}
    if cfg.family == "hybrid":
        ch = cfg.d_inner // tp + 2 * cfg.ssm_groups * cfg.ssm_state
        shapes.update({"ssm.conv": [L, BATCH, cfg.conv_width - 1, ch],
                       "ssm.ssm": [L, BATCH, cfg.ssm_heads() // tp, cfg.ssm_head_dim,
                                   cfg.ssm_state], "ssm.length": [L]})
    else:
        cross = [L, BATCH, cfg.enc_seq, kl, cfg.head_dim]
        shapes.update({"cross.k": cross, "cross.v": cross, "cross.length": [L]})
    return shapes


def serve_padded(smi: str, arch: str) -> tuple[dict[str, int], dict]:
    """hymba-1.5b at TP 8 (4 x 2048 tokens) or whisper-tiny at TP 4 (4 x
    1024 tokens, 4 x 1500 frames), full width and depth, one spawned rank
    a TP index on the card over gloo, each through ``disaggregated.run``
    and checked as the TP-1 path is: flash (and ssd_chunk) once per layer
    per prefill (whisper's flash 12 times), the codec 4 times per int8
    transfer, nothing per decode step, its cache shard at the padded local
    heads, the raw transfer exact, every rank the same tokens.  The padded
    heads draw another tree than TP 1 (and hymba's TP 8 maps Q to KV
    heads otherwise, R23), so TP 1 is no oracle: for hymba the same TP-8
    world is held in f32 at PAD_F32_LAYERS layers on the card against the
    CPU, the last-token logits within PAD_F32_TOL of the CPU's largest and
    the greedy tokens equal.  Returns the launches summed over the ranks
    and what was measured."""
    cfg, tp = get_config(arch), PAD_SERVE[arch]
    prompt = HYBRID_SEQ if arch == HYBRID_ARCH else PROMPT
    ranks = _spawn_tp(arch, tp)
    label = (f"{arch} TP {tp} ({cfg.padded_heads(tp)} Q / {cfg.padded_kv_heads(tp)} KV heads "
             f"from {cfg.n_heads} / {cfg.n_kv_heads})")
    want_shapes = _cache_shapes(cfg, tp, prompt)
    total = dict.fromkeys(ranks[0]["counts"], 0)
    for r, res in enumerate(ranks):
        check(res["layers"] == cfg.n_layers, f"{label}: depth {res['layers']}")
        phases = res["launches"]
        expect = {"prefill": {k: prefill_launches(cfg, k) * res["prefills"]
                              for k in PATH_KERNELS[arch]},
                  "int8_transfer": {"quant_int8": 4 * res["int8_transfers"],
                                    "dequant_int8": 4 * res["int8_transfers"]},
                  "raw_transfer": {}, "decode": {}}
        for phase, want in expect.items():
            got = {k: n for k, n in phases[phase].items() if n}
            check(got == want, f"{label} rank {r} {phase} launches {got}, expected {want}")
        check(res["counts"] == {k: sum(p[k] for p in phases.values()) for k in res["counts"]},
              f"{label} rank {r}: launches {res['counts']} against the phases {phases}")
        check(all(res["vector"][k] == res["counts"][k] for k in res["vector"]),
              f"{label} rank {r}: vector launches {res['vector']} of {res['counts']}")
        check(res["cache_shapes"] == want_shapes,
              f"{label} rank {r} cache {res['cache_shapes']}, expected {want_shapes}")
        check(res["raw_transfer_exact"] and res["cache_finite"],
              f"{label} rank {r}: raw transfer exact {res['raw_transfer_exact']}, cache "
              f"finite {res['cache_finite']}")
        check(bool(torch.isfinite(res["prefill_logits"]).all()), f"{label}: non-finite logits")
        check(torch.equal(torch.tensor(res["tokens"]), torch.tensor(ranks[0]["tokens"])),
              f"{label}: rank {r} generated other tokens than rank 0")
        for k, n in res["counts"].items():
            total[k] += n
    summary = {"tp": tp, "layers": cfg.n_layers, "prompt": prompt,
               "ranks": [{k: res[k] for k in ("ttft_ms", "decode_ms_per_step",
                                              "int8_transfer_ms", "peak_mem_gb", "cache_bytes",
                                              "int8_token_agreement")} for res in ranks]}
    if arch == HYBRID_ARCH:
        logits = {side: torch.cat([res["f32"][side]["logits"] for res in ranks],
                                  dim=-1)[:, :cfg.vocab_size] for side in ("gpu", "cpu")}
        check(all(bool(torch.isfinite(x).all()) for x in logits.values()),
              f"{label}, f32: non-finite logits")
        scale = logits["cpu"].abs().max().item()
        diff = (logits["gpu"] - logits["cpu"]).abs().max().item()
        toks = {side: ranks[0]["f32"][side]["tokens"] for side in ("gpu", "cpu")}
        check(diff <= PAD_F32_TOL * scale,
              f"{label}, f32 at {PAD_F32_LAYERS} layers: card logits {diff} from the CPU's "
              f"(largest {scale})")
        check(torch.equal(toks["gpu"], toks["cpu"]),
              f"{label}, f32: card tokens {toks['gpu'].tolist()} against the CPU's "
              f"{toks['cpu'].tolist()}")
        print(f"[pad] {label}, f32 at {PAD_F32_LAYERS} layers, 1 x {PAD_F32_PROMPT} tokens, "
              f"card against the CPU in the same {tp}-rank world: last-token logits max abs "
              f"diff {diff:.4g} (tol {PAD_F32_TOL} x the largest {scale:.4g}), "
              f"{PAD_F32_GEN + 1} greedy tokens equal")
        summary["f32"] = {"logit_max_abs_diff": diff, "logit_scale": scale,
                          "tol": PAD_F32_TOL, "layers": PAD_F32_LAYERS,
                          "prompt": PAD_F32_PROMPT, "tokens_equal": True}
    for r, res in enumerate(ranks):
        print(f"[pad] [{smi}] {label} rank {r}, gloo TP group on one card, {BATCH} x {prompt} "
              f"tokens, {PAD_GEN[arch]} greedy: TTFT {res['ttft_ms']:.2f} ms, decode {res['decode_ms_per_step']:.2f} "
              f"ms/step, int8 transfer of its {res['cache_bytes']} cache bytes "
              f"{res['int8_transfer_ms']:.2f} ms, peak memory {res['peak_mem_gb']:.3f} GB, "
              f"int8 token agreement {res['int8_token_agreement']:.4f}, raw transfer exact; "
              f"launches by phase "
              f"{ {p: {k: n for k, n in c.items() if n} for p, c in res['launches'].items()} }")
    return total, summary


def pp_inputs(dev) -> tuple[torch.Tensor, ...]:
    """The pipeline check's f32 weights (PP_L, PP_D, PP_FF) and (PP_L, PP_FF,
    PP_D), microbatches x and targets y (PP_M, PP_BM, PP_S, PP_D), drawn on
    the CPU from a seed and moved to ``dev``."""
    g = torch.Generator().manual_seed(3)
    w1 = torch.randn(PP_L, PP_D, PP_FF, generator=g) / math.sqrt(PP_D)
    w2 = torch.randn(PP_L, PP_FF, PP_D, generator=g) / math.sqrt(PP_FF)
    x = torch.randn(PP_M, PP_BM, PP_S, PP_D, generator=g)
    y = torch.randn(PP_M, PP_BM, PP_S, PP_D, generator=g)
    return tuple(t.to(dev) for t in (w1, w2, x, y))


def _pp_layer(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    return x + torch.tanh(x @ w1) @ w2


def _pp_rank(dev) -> dict:
    """One stage of the 2-stage GPipe (a pod group of 2, no TP or data
    group): its layers' loss and gradients, and the step's wall time."""
    rt = runtime_for_groups(pods=2, data_per_pod=1, tp=1)
    stage_id = dist.get_rank(rt.pod_group)
    w1, w2, x, y = pp_inputs(dev)
    mine = slice(stage_id * PP_L // 2, (stage_id + 1) * PP_L // 2)
    times = []
    for _ in range(3):      # the first builds; the last two are timed
        a, b = (w[mine].clone().requires_grad_() for w in (w1, w2))

        def stage(xm):
            for i in range(PP_L // 2):
                xm = _pp_layer(xm, a[i], b[i])
            return xm

        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        per = torch.mean((pipeline.gpipe_apply(stage, x, rt, n_stages=2) - y) ** 2)
        loss = pipeline.pp_loss_mask(per, rt, n_stages=2)
        loss.backward()
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"stage": stage_id, "loss": loss.item(), "g1": a.grad.cpu(), "g2": b.grad.cpu(),
            "ms": times[1:]}


def check_pp(dev, smi: str) -> dict:
    """GPipe over a pod group of 2 (``repro_torch.parallel.pipeline``), the
    analog of the reference's ``tests/mdscripts/check_pipeline_pp.py``:
    two spawned ranks on the card over gloo, each a stage of PP_L / 2
    tanh-MLP layers (PP_D wide, PP_FF inner) over PP_M microbatches, the
    stage handoff a shift through the host; against one process computing
    every layer on the card, in f32: the loss within rtol 1e-5 and both
    stages' gradients within rtol 2e-4, atol 2e-5."""
    ranks = sorted(_spawn_tp("pp", 2), key=lambda res: res["stage"])
    w1, w2, x, y = pp_inputs(dev)
    for _ in range(2):      # the first builds; the second is timed
        w1.grad = w2.grad = None
        w1.requires_grad_()
        w2.requires_grad_()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = x
        for i in range(PP_L):
            out = _pp_layer(out, w1[i], w2[i])
        loss = torch.mean((out - y) ** 2)
        loss.backward()
        torch.cuda.synchronize(dev)
        one_ms = (time.perf_counter() - t0) * 1e3
    errs = []
    for res in ranks:
        mine = slice(res["stage"] * PP_L // 2, (res["stage"] + 1) * PP_L // 2)
        check(abs(res["loss"] - loss.item()) <= 1e-5 * abs(loss.item()),
              f"PP stage {res['stage']}: loss {res['loss']} against {loss.item()}")
        for name, got, want in (("w1", res["g1"], w1.grad[mine]), ("w2", res["g2"], w2.grad[mine])):
            want = want.cpu()
            err = (got - want).abs()
            check(bool((err <= 2e-5 + 2e-4 * want.abs()).all()),
                  f"PP stage {res['stage']} {name} gradient: max abs err {err.max().item()}")
            errs.append(err.max().item())
    print(f"[pp] [{smi}] GPipe over a pod group of 2 (gloo, the handoff through the host), "
          f"{PP_L} layers of {PP_D} x {PP_FF}, {PP_M} microbatches of {PP_BM} x {PP_S}, f32: "
          f"loss {ranks[0]['loss']:.7f} against one process's {loss.item():.7f} (rtol 1e-5), "
          f"gradients of both stages max abs err {max(errs):.3g} (rtol 2e-4, atol 2e-5); "
          f"step {[f'{t:.2f}' for t in ranks[0]['ms']]} ms against one process's "
          f"{one_ms:.2f} ms")
    return {"loss": ranks[0]["loss"], "ref_loss": loss.item(), "grad_max_abs_err": max(errs),
            "step_ms": ranks[0]["ms"], "one_process_ms": one_ms}


# ---------------------------------------------------------------------------
# Runtime robustness: the guard and the chaos engine, checkpoints, elastic
# ---------------------------------------------------------------------------

CHAOS_SEED, CHAOS_STEPS = 8, 12   # seed 8 in 12 steps: the hang at step 9, after the
#                                   guard's 5-step calibration
# phase (a)'s depth, 8 of qwen2.5-3b's 36 layers: at full width the guard's
# CRC of every parameter took 8.1 s a step and the phase 122 s, and the
# script grew past 1070 s of its 1200 with the padded TP phases
CHAOS_LAYERS = 8
# phase 8's depth: its seven profiled steps took 13.9-34.2 s each at 36
# layers, and the whole script 1199.3 s of its 1200 on a slow host (PR 31)
PROFILE_LAYERS = 12
CKPT_LAYERS = 4                   # phase (b)'s depth
# phase (c)'s depth: 2 of the issue's 4 layers.  At 4 the four ranks ran
# the machine's 96 GiB of host memory out (gloo stages every CUDA
# collective through host buffers, and the files of the sandbox's disk are
# held in its memory)
ELASTIC_LAYERS = 2
ELASTIC_FAIL, ELASTIC_STEPS = 2, 4  # pod 1 is lost before step 2; 2 survivor steps


def _median(xs) -> float:
    return statistics.median(xs) if xs else float("nan")


def check_nan_on_int8_wire(dev, rt) -> None:
    """ROADMAP R20 on the card: a NaN block through the shared-scale int8
    codec (amax_block keeps the NaN; the scale rule maps it to 1) decodes
    bit-equal to the CPU's, finite."""
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(1 << 20, generator=gen) * 1e-2).to(torch.bfloat16)
    x[0] = float("nan")
    got = compression.compressed_psum(x.to(dev), rt.pod_group, "int8").cpu()
    want = compression.compressed_psum(x.clone(), rt.pod_group, "int8")
    check(bits_equal(got, want) and bool(torch.isfinite(got).all()),
          "R20: the NaN block on the int8 wire decodes otherwise on the card than on the CPU")


def train_chaos(dev, smi: str) -> dict:
    """Phase (a): qwen2.5-3b at full width and CHAOS_LAYERS layers, hier +
    int8 in a world of one,
    ``run(guard=True, chaos=CHAOS_SEED)`` for CHAOS_STEPS steps, the launch
    counts set to 0 just before and read just after.  Each fault class
    that fires is logged (one cluster: no link feed, so the degraded link
    does not); the transient costs one retry; the hang is detected at its
    step and attributed to rank 0; no other guard event; every loss
    finite; the NaN step's payload is silenced by the int8 codec's scale
    rule (R20), so its gate stays open.  The guard's host milliseconds per
    step are printed, split into the CRC and the finiteness check
    (ROADMAP fact 4: every parameter is copied to the host each step)."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=CHAOS_LAYERS)
    spent: dict[str, list] = {"crc": [], "nonfinite": []}
    real = guard_lib.payload_checksum, guard_lib.nonfinite_leaves

    def clocked(key, fn):
        def run_timed(tree):
            t0 = time.perf_counter()
            out = fn(tree)
            spent[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run_timed

    guard_lib.payload_checksum = clocked("crc", real[0])
    guard_lib.nonfinite_leaves = clocked("nonfinite", real[1])
    lines: list[str] = []
    try:
        ops.reset_launch_counts()
        res = train_launch.run(ARCH, steps=CHAOS_STEPS, mode="hier", compression="int8",
                               global_batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=dev, guard=True,
                               chaos=CHAOS_SEED, layers=CHAOS_LAYERS, log=lines.append)
        counts = ops.launch_counts()
    finally:
        guard_lib.payload_checksum, guard_lib.nonfinite_leaves = real
    for line in lines:
        if not line.startswith("{"):
            print(f"[chaos] {line}")
    want = train_kernels("hier", "int8", cfg)
    check(counts == {k: n * CHAOS_STEPS for k, n in want.items()},
          f"chaos launches {counts} over {CHAOS_STEPS} steps")
    check_vector_launches(counts, "train_chaos")
    events = {e["kind"]: e["step"] for e in res["chaos"]["plan"]["events"]}
    injected = {i["kind"] for i in res["chaos"]["injected"]}
    check(injected == {"transient", "hang", "nan_payload", "bitflip"},
          f"chaos: injected {injected}")
    report = res["guard"]
    check(report["counts"] == {"transient_retry": 1, "hang": 1},
          f"chaos: guard events {report['counts']}")
    by_kind = {e["kind"]: e for e in report["events"]}
    check(by_kind["transient_retry"]["step"] == events["transient"]
          and by_kind["transient_retry"]["measured"] == 1.0, "chaos: the transient's retry")
    check(by_kind["hang"]["step"] == events["hang"] and by_kind["hang"]["attribution"] == "rank 0",
          f"chaos: hang {by_kind['hang']}")
    recs = {r["step"]: r for r in res["records"]}
    check([r["step"] for r in res["records"]] == list(range(CHAOS_STEPS)), "chaos: steps")
    for r in res["records"]:
        check(math.isfinite(r["loss"]) and math.isfinite(r["gnorm"]) and not r["gated"],
              f"chaos step {r['step']}: loss {r['loss']}, grad norm {r['gnorm']}, "
              f"gated {r['gated']}")
        check({k: r["launches"][k] for k in want} == want, f"chaos step {r['step']} launches")
    clean = [r["ms_per_step"] for s, r in recs.items() if s and s not in events.values()]
    guard_ms = [r["guard_ms"] for r in res["records"]]
    n_bytes = res["params"] * 2
    print(f"[chaos] [{smi}] {ARCH} ({CHAOS_LAYERS} layers, {res['params']} params), hier + "
          f"int8, seed {CHAOS_SEED}, "
          f"{CHAOS_STEPS} steps: faults {events}; guard events {report['counts']} "
          f"(deadline {report['deadline_s']:.3f} s); step {_median(clean):.3f} ms (median of "
          f"the fault-free steps 1-{CHAOS_STEPS - 1}); guard host ms per step median "
          f"{_median(guard_ms):.1f} (min {min(guard_ms):.1f}, max {max(guard_ms):.1f}): CRC32 "
          f"over {n_bytes / 1e9:.3f} GB of bf16 parameters {_median(spent['crc']):.1f} ms, "
          f"finiteness check {_median(spent['nonfinite']):.1f} ms (medians of "
          f"{len(spent['crc'])}); NaN step {events['nan_payload']}: loss "
          f"{recs[events['nan_payload']]['loss']:.6f}, grad norm "
          f"{recs[events['nan_payload']]['gnorm']:.6f}, gate open (R20); losses "
          f"{[r['loss'] for r in res['records']]}")
    res["counts"] = counts
    res["guard_split_ms"] = {k: _median(v) for k, v in spent.items()}
    return res


def _state_gb(layers: int) -> float:
    """The checkpointed state of qwen2.5-3b at ``layers`` layers with Adam:
    bf16 parameters and two f32 moments, 10 bytes a parameter."""
    with FakeTensorMode():
        model = Model(dataclasses.replace(get_config(ARCH), n_layers=layers),
                      device="cpu").init(0)
        n = sum(p.numel() for p in model.parameters())
    return n * 10 / 1e9


def _disk_check(directory: str, need_gb: float, what: str) -> None:
    free = shutil.disk_usage(directory).free / 1e9
    print(f"[ckpt] {what}: {free:.1f} GB free under {directory}, {need_gb:.1f} GB needed")
    check(free >= need_gb, f"{what}: {free:.1f} GB free under {directory}, {need_gb:.1f} GB "
          f"needed for the checkpoints")


def train_resume(dev, smi: str) -> dict:
    """Phase (b): qwen2.5-3b at full width and CKPT_LAYERS layers, hier +
    int8 in a world of one: 4 steps with ``save_async`` at step 2 and the
    final ``save`` at 4, then a resumed launch (``restore``) for steps 4-5,
    whose losses must be bit-equal to an uninterrupted 6-step run's.  The
    launch counts of the resumed launch are set to 0 just before it and
    read just after.  Writes in a temporary directory it removes."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=CKPT_LAYERS)
    gb = _state_gb(CKPT_LAYERS)
    with tempfile.TemporaryDirectory() as d:
        _disk_check(d, 3.5 * gb, "phase (b)")
        kw = dict(layers=CKPT_LAYERS, mode="hier", compression="int8",
                  global_batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=dev, log=lambda line: None)
        first = train_launch.run(ARCH, steps=4, ckpt_dir=d, ckpt_every=2, **kw)
        free_memory()
        ops.reset_launch_counts()
        resumed = train_launch.run(ARCH, steps=6, ckpt_dir=d, resume=True, **kw)
        counts = ops.launch_counts()
        free_memory()
    whole = train_launch.run(ARCH, steps=6, **kw)
    free_memory()
    want = train_kernels("hier", "int8", cfg)
    check(resumed["resumed_from"] == 4 and [r["step"] for r in resumed["records"]] == [4, 5],
          f"resume: from {resumed['resumed_from']}, steps {resumed['records']}")
    check(counts == {k: 2 * n for k, n in want.items()}, f"resume launches {counts}")
    got = [r["loss"] for r in resumed["records"]]
    ref = [r["loss"] for r in whole["records"][4:]]
    check(got == ref, f"resumed losses {got} against the uninterrupted run's {ref}")
    check(first["checkpoints"] == [2, 4] and resumed["checkpoints"] == [6],
          f"checkpoints {first['checkpoints']}, {resumed['checkpoints']}")
    op = {(o["op"], o["step"]): o for o in first["checkpoint_ops"] + resumed["checkpoint_ops"]}
    print(f"[ckpt] [{smi}] {ARCH} at {CKPT_LAYERS} layers (hier + int8, Adam, "
          f"{op[('save', 4)]['gb']:.3f} GB of state): save_async at step 2 "
          f"{op[('save_async', 2)]['ms']:.1f} ms on the training thread, save at step 4 "
          f"{op[('save', 4)]['ms']:.1f} ms, restore {op[('restore', 4)]['ms']:.1f} ms, final "
          f"save at step 6 {op[('save', 6)]['ms']:.1f} ms; resumed losses {got} bit-equal to "
          f"the uninterrupted run's; step {resumed['step_ms']:.3f} ms")
    resumed["counts"] = counts
    return {"resumed": resumed, "ops": first["checkpoint_ops"] + resumed["checkpoint_ops"],
            "counts": counts, "losses": got}


def _elastic_rank(dev, rank: int, out_dir: str) -> dict:
    """One rank of phase (c): 2 pods x 2 data, hier_zero1 + int8 at
    ELASTIC_LAYERS layers.  A launch of ELASTIC_FAIL steps writes the
    checkpoint of the failure step.  A second launch (its launch counts set
    to 0 just before it and read just after) takes the same steps, as
    training is deterministic here, loses pod 1 before step ELASTIC_FAIL,
    and the survivors train to ELASTIC_STEPS.  Then the survivors'
    reference: a run on the same survivor groups restored from the failure
    step's checkpoint."""
    d = os.path.join(out_dir, "ck")
    lines: list[str] = []
    kw = dict(layers=ELASTIC_LAYERS, pods=2, mode="hier_zero1", compression="int8",
              global_batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=dev, log=lines.append)
    before = train_launch.run(ARCH, steps=ELASTIC_FAIL, ckpt_dir=d, **kw)["losses"]
    free_memory()
    ops.reset_launch_counts()
    res = train_launch.run(ARCH, steps=ELASTIC_STEPS, elastic=True,
                           inject_pod_failure=ELASTIC_FAIL, **kw)
    counts = ops.launch_counts()
    free_memory()
    # (``_tp_rank`` overwrites "counts" with the process's, the reference run's included)
    out = {"path_counts": counts, "records": res["records"], "losses": res["losses"],
           "before": before,
           "survivor_step_ms": _median([r["ms_per_step"] for r in res["records"]
                                        if r["step"] > ELASTIC_FAIL]),
           "alive": res["alive"], "peak_mem_gb": res["peak_mem_gb"], "step_ms": res["step_ms"],
           "failover": res["failover"], "elastic": res["elastic"],
           "checkpoint_ops": res["checkpoint_ops"],
           "lines": [line for line in lines if line.startswith("[elastic]")]}
    new_rt, _ = survivor_mesh(2, 2, 1, 1)
    if new_rt is not None:
        cfg = dataclasses.replace(get_config(ARCH), n_layers=ELASTIC_LAYERS)
        model = Model(cfg, new_rt, dev).init(0)
        tcfg = TrainConfig(comm_mode="hier_zero1", dcn_compression="int8",
                           opt=opt_lib.OptConfig(lr=3e-3, warmup_steps=20))
        step_fn, _ = make_train_step(model, tcfg)
        zero_like = train_launch._zero_like(model, tcfg)
        _, state, _ = CheckpointManager(d).restore(
            state_like(model, zero_like, tcfg), step=ELASTIC_FAIL,
            shardings=state_shardings(model, zero_like, tcfg))
        opt = load_state(model, state, tcfg, sliced=True)
        del state
        rows = train_launch.dp_rows(rank, TRAIN_BATCH, 1, 2, 1)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
        out["ref_losses"] = [step_fn(opt, {k: torch.from_numpy(v[rows]).long().to(dev)
                                           for k, v in synth_batch(dcfg, i).items()})["loss"]
                             for i in range(ELASTIC_FAIL, ELASTIC_STEPS)]
    dist.barrier()
    out["host_peak_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    return out


def train_elastic(smi: str) -> dict[str, int]:
    """Phase (c): four ranks as 2 pods x 2 data on the one card over gloo
    (as the TP phases share it).  Each survivor's losses after the pod
    failure are bit-equal to the survivor run restored from the failure
    step's checkpoint; the ZeRO-1 state crossed through the slot map,
    which is the identity here (the data group stays at 2 ranks, so the
    old and new layouts are equal): what runs on the card is its gather
    and placement through gloo.  A remap that moves slots is held on the
    CPU only (tests/test_torch_elastic.py, leg B: 4 ranks to 2).
    Prints the re-plan latency, the failover's parts (the state gather,
    the survivor cut, the remap) and the survivors' step ms, and per rank
    the launch counts and the peak memory.  Returns the launches summed
    over the ranks."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=ELASTIC_LAYERS)
    # one checkpoint of ZeRO-1's state: 14 bytes a parameter (bf16, and the
    # f32 master and moments) against _state_gb's 10
    _disk_check(tempfile.gettempdir(), 1.4 * _state_gb(ELASTIC_LAYERS) + 1.0, "phase (c)")
    ranks = _spawn_tp("elastic", 4)
    per_step = train_kernels("hier_zero1", None, cfg)     # no pod hop on the survivors
    total = dict.fromkeys(ranks[0]["path_counts"], 0)
    for r, res in enumerate(ranks):
        alive = r < 2
        check(res["alive"] == alive, f"elastic rank {r}: alive {res['alive']}")
        fo = res["failover"]
        check(fo["remap_path"] == "slot_map" if alive else "remap_path" not in fo,
              f"elastic rank {r}: failover {fo}")
        # ELASTIC_FAIL steps on 2 pods (the int8 pod hop), then the survivors'
        # steps with no pod group (no codec), and the bootstrap's pack
        before = train_kernels("hier_zero1", "int8", cfg)
        after = ELASTIC_STEPS - ELASTIC_FAIL if alive else 0
        boot = bootstrap_kernels("hier_zero1")
        want = {k: before[k] * ELASTIC_FAIL + n * after + boot.get(k, 0)
                for k, n in per_step.items()}
        check(res["path_counts"] == want,
              f"elastic rank {r}: launches {res['path_counts']}, want {want}; per step "
              f"{[(x['step'], x['launches']['pack_slots']) for x in res['records']]}")
        check(res["losses"][:ELASTIC_FAIL] == res["before"],
              f"elastic rank {r}: the steps before the failure {res['losses']} against the "
              f"checkpointing launch's {res['before']}")
        if alive:
            check(res["losses"][ELASTIC_FAIL:] == res["ref_losses"],
                  f"elastic rank {r}: losses {res['losses']} against the survivor run "
                  f"restored from step {ELASTIC_FAIL}: {res['ref_losses']}")
            check(all(math.isfinite(x) for x in res["losses"]), "elastic: non-finite loss")
        for k, n in res["path_counts"].items():
            total[k] += n
    rep = ranks[0]["elastic"][0]
    fo = ranks[0]["failover"]
    print(f"[elastic] [{smi}] {ARCH} at {ELASTIC_LAYERS} layers, hier_zero1 + int8, 2 pods x "
          f"2 data on one card over gloo, pod 1 lost before step {ELASTIC_FAIL}: re-plan "
          f"{fo['replan_ms']:.1f} ms ({rep['old_fingerprint']} -> {rep['new_fingerprint']}, "
          f"plan {rep['plan_mode']} validated via {rep['validated_via']}), parameter gather "
          f"{fo['gather_ms']:.1f} ms, survivor cut {fo['cut_ms']:.1f} ms, ZeRO-1 state "
          f"gathered, remapped ({fo['remap_path']}) and placed {fo['remap_ms']:.1f} ms, "
          f"failover total {fo['total_ms']:.1f} ms; survivors' step "
          f"{ranks[0]['survivor_step_ms']:.3f} / {ranks[1]['survivor_step_ms']:.3f} ms (median "
          f"of steps {list(range(ELASTIC_FAIL + 1, ELASTIC_STEPS))}); "
          f"losses {ranks[0]['losses']} bit-equal to the restored survivor run")
    for r, res in enumerate(ranks):
        print(f"[elastic] [{smi}] rank {r}: launches {res['path_counts']}, peak memory "
              f"{res['peak_mem_gb']:.3f} GB on the card, {res['host_peak_gb']:.1f} GB of host "
              f"memory at most, {'survivor' if r < 2 else 'lost pod'}; "
              + "; ".join(res["lines"][:1]))
    return total


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 13. The dry run, shapes only
# ---------------------------------------------------------------------------

DRYRUN_PEAK_TOL = 0.10      # the predicted peak against the measured one
# the first phases, whose kernel times the kernels line reports: the dry
# run's cells start after them (a cell's fake CUDA tensors open a CUDA
# context on the card, and the SSD chunk's time read 0.1569 ms instead of
# 0.1278 when they started beside it; PR 31)
KERNEL_TIMING_PHASES = ("codec", "flash", "ssd")
DRYRUN_TIMEOUT = 300        # seconds from their start within which the cells end
# (a): the cell function under lower_cell, in a fake world of one
DRYRUN_WORLD_OF_ONE = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_world
arch, seq, batch, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
one = {"pod": 1, "data": 1, "model": 1}
cell = dryrun.trace_cell(get_config(arch), ShapeConfig("world_of_one", "train", seq, batch),
                         make_fake_world(one), one, comm_mode="hier", compression="int8",
                         device="cuda")
cell.update(status="ok", fake_launches=ops.fake_launch_counts(), launches=ops.launch_counts())
json.dump(cell, open(out, "w"))
"""


class DryrunCells:
    """The dry run's three cells, each in a subprocess of its own (one fake
    world per process), started together early in the run: they trace on
    host cores (each opens a CUDA context and allocates nothing more), so
    they run beside the phases on the card, and the dryrun phase reads
    them (``dryrun_cells``).  (a) qwen2.5-3b in a world
    of one at the training phase's 4 x 1024 with hier + int8, traced on
    the card's path; (b) qwen2.5-3b ``train_4k`` on the 512-rank multi-pod
    mesh with ``--plan auto``; (c) qwen3-moe-30b-a3b ``prefill_32k``
    there."""

    def __init__(self):
        root = pathlib.Path(__file__).resolve().parent
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        cli = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "multi"]
        cells = {"world_of_one": [sys.executable, "-c", DRYRUN_WORLD_OF_ONE, ARCH,
                                  str(TRAIN_SEQ), str(TRAIN_BATCH)],
                 "train_4k_multi": cli + ["--arch", ARCH, "--shape", "train_4k", "--plan",
                                          "auto", "--out"],
                 "moe_prefill_32k_multi": cli + ["--arch", MOE_ARCH, "--shape", "prefill_32k",
                                                 "--out"]}
        self.tmp = tempfile.TemporaryDirectory()
        self.procs, self.logs, self.took, self.waiters = {}, {}, {}, {}
        self.t0 = time.perf_counter()
        for name, cmd in cells.items():
            self.logs[name] = open(os.path.join(self.tmp.name, f"{name}.log"), "w")
            self.procs[name] = subprocess.Popen(
                cmd + [os.path.join(self.tmp.name, f"{name}.json")], env=env,
                stdout=self.logs[name], stderr=subprocess.STDOUT)
            self.waiters[name] = threading.Thread(target=self._wait, args=(name,), daemon=True)
            self.waiters[name].start()

    def _wait(self, name: str) -> None:
        self.procs[name].wait()
        self.took[name] = time.perf_counter() - self.t0

    def results(self) -> tuple[dict, dict]:
        """Each cell's JSON and its seconds from the start, once every cell
        has ended (within DRYRUN_TIMEOUT of the start)."""
        for name, waiter in self.waiters.items():
            waiter.join(timeout=max(0.0, DRYRUN_TIMEOUT - (time.perf_counter() - self.t0)))
            check(not waiter.is_alive(), f"dry-run cell {name} past {DRYRUN_TIMEOUT} s")
        res = {}
        for name, proc in self.procs.items():
            self.logs[name].flush()
            log = pathlib.Path(self.tmp.name, f"{name}.log").read_text()
            check(proc.returncode == 0, f"dry run {name} exited {proc.returncode}: {log[-3000:]}")
            res[name] = json.loads(pathlib.Path(self.tmp.name, f"{name}.json").read_text())
            check(res[name]["status"] == "ok", f"dry run {name}: {res[name]}")
        return res, dict(self.took)

    def close(self) -> None:
        """Stop every cell still running and remove their files."""
        for name, proc in self.procs.items():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            self.logs[name].close()
        self.tmp.cleanup()


def dryrun_cells(smi: str, train_hier: dict, cells: DryrunCells) -> dict:
    """The dry run's three cells (``DryrunCells``), held: (a)'s predicted
    peak within DRYRUN_PEAK_TOL of ``train_hier``'s measured
    ``max_memory_allocated``, its shape-only calls equal to that phase's
    launches per step, nothing launched; (b) ``status: ok`` with its plan;
    (c) one shape-only flash call a layer.  Each cell's seconds, peak,
    FLOPs and collective bytes are printed."""
    res, took = cells.results()
    one, multi, moe_cell = res["world_of_one"], res["train_4k_multi"], res["moe_prefill_32k_multi"]
    # (a) against the training phase it mirrors
    want = train_kernels("hier", "int8", get_config(ARCH))
    check(one["fake_launches"] == want, f"dry run shape-only calls {one['fake_launches']}, "
                                        f"the card's launches per step {want}")
    check(all(rec["launches"] == want for rec in train_hier["records"]),
          f"training launches per step {[rec['launches'] for rec in train_hier['records']]}")
    check(set(one["launches"].values()) == {0}, f"the dry run launched {one['launches']}")
    predicted, measured = one["memory"]["peak_bytes"] / 1e9, train_hier["peak_mem_gb"]
    gap = predicted / measured - 1
    check(abs(gap) <= DRYRUN_PEAK_TOL, f"dry run peak {predicted:.3f} GB against the measured "
                                       f"{measured:.3f} GB ({gap:+.1%})")
    check(multi["n_chips"] == 512 and "plan" in multi, f"train_4k multi: {multi.keys()}")
    layers = get_config(MOE_ARCH).n_layers
    calls = moe_cell["kernels"].get("flash_attention", {}).get("calls")
    check(calls == layers, f"{MOE_ARCH} prefill_32k: {calls} shape-only flash calls, "
                           f"{layers} layers")
    out = {}
    for name, cell in res.items():
        coll = cell["collectives"]
        out[name] = {"seconds": took[name], "trace_s": cell["trace_s"],
                     "peak_gb": cell["memory"]["peak_bytes"] / 1e9, "flops": cell["flops"],
                     "bytes": cell["bytes"],
                     "wire_bytes": sum(v["wire_bytes"] for v in coll.values()),
                     "ici_bytes": cell["roofline"]["ici_bytes"],
                     "dcn_bytes": cell["roofline"]["dcn_bytes"],
                     "kernels": {k: v["calls"] for k, v in cell["kernels"].items()},
                     "step_s": cell["roofline"]["step_s"],
                     "bottleneck": cell["roofline"]["bottleneck"]}
        print(f"[dryrun] [{smi}] {name}: ended {took[name]:.1f} s after its start "
              f"({cell['trace_s']} s traced), peak "
              f"{out[name]['peak_gb']:.3f} GB a rank, {cell['flops']:.4e} FLOP a rank, "
              f"collectives {out[name]['wire_bytes']:.4e} B on the wire ({out[name]['ici_bytes']:.4e} "
              f"in a cluster, {out[name]['dcn_bytes']:.4e} across), shape-only calls "
              f"{out[name]['kernels']}; roofline {out[name]['bottleneck']}-bound, "
              f"{out[name]['step_s'] * 1e3:.3f} ms a step (H100 peaks, assumed links)")
    print(f"[dryrun] [{smi}] world of one, hier + int8, {TRAIN_BATCH} x {TRAIN_SEQ}: predicted "
          f"peak {predicted:.3f} GB against the training phase's measured {measured:.3f} GB "
          f"({gap:+.2%}); shape-only calls {one['fake_launches']} equal its launches per step")
    out["peak_gap"] = gap
    return out


# ---------------------------------------------------------------------------
# 14. The examples
# ---------------------------------------------------------------------------

EXAMPLES = pathlib.Path(__file__).resolve().parent / "examples"
TRAIN_LM_STEPS = 300        # the reference's full-size deliverable: --hundred-m --steps 300
TRAIN_LM_TIMEOUT = 600      # seconds within which its process ends
# the examples' processes start with this phase: the TP phases from here
# on wait on gloo and the host and leave the card mostly idle
EXAMPLES_FROM = "serve_tp2"


def _example(name: str):
    """The example module ``examples/<name>.py``, imported by name so that
    the ranks it spawns import it too (a spawned process takes sys.path)."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(name)


def _summed(per_rank) -> dict[str, int]:
    """Every kernel's launches summed over the ranks' dicts."""
    out = dict.fromkeys(ops.KERNELS, 0)
    for launches in per_rank:
        for k, n in launches.items():
            out[k] += n
    return out


def _timed(fn, *args, **kwargs):
    """fn(*args, **kwargs) and its seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def _serve_f32_rank(rank: int, prompt_len: int) -> dict:
    """One rank of the serve example's world in f32: the smoke model drawn
    on the CPU from the example's seed and copied to the card, then the
    example's steps (``disaggregate``) on the card and on the CPU."""
    ex = _example("torch_serve_disaggregated")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    train_launch.init_world(dev, "gloo")
    try:
        cfg = ex.smoke_config(f32=True)
        rt = ex.world_runtime()
        cpu = Model(cfg, rt, device="cpu").init(0)
        gpu = copy.deepcopy(cpu, {id(rt): rt}).to(dev)
        prompt = ex.prompt_tokens(cfg, prompt_len)[ex.my_rows(rank)]
        return {"gpu": ex.disaggregate(gpu, prompt), "cpu": ex.disaggregate(cpu, prompt)}
    finally:
        dist.destroy_process_group()


def _train_lm_process() -> tuple:
    """``examples/torch_train_lm.py --hundred-m --steps 300`` as a process
    of its own (its world of one on the card): the finished process and
    its seconds."""
    cfg = _example("torch_train_lm").make_config(True)
    with tempfile.TemporaryDirectory() as tmp:
        _disk_check(tmp, 3 * cfg.param_count() * 10 / 1e9, "train_lm")
        return _timed(
            subprocess.run,
            [sys.executable, str(EXAMPLES / "torch_train_lm.py"), "--hundred-m", "--steps",
             str(TRAIN_LM_STEPS), "--device", "cuda", "--ckpt-dir", tmp],
            env=dict(os.environ, PYTHONPATH=str(EXAMPLES.parent / "src")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=TRAIN_LM_TIMEOUT)


def _quickstart_worlds() -> tuple:
    """The quickstart's 8 ranks on the card (``run("cuda")``), then on the
    CPU, each with its seconds."""
    ex = _example("torch_quickstart")
    return _timed(ex.run, "cuda"), _timed(ex.run, "cpu")


def _serve_worlds() -> tuple:
    """The serve example's 8 ranks on the card at EXAMPLE_PROMPT tokens
    (bf16; ``run("cuda")``), then its steps in f32 on the card and on the
    CPU in one world (``_serve_f32_rank``), each with its seconds."""
    ex = _example("torch_serve_disaggregated")
    return (_timed(ex.run, "cuda", EXAMPLE_PROMPT),
            _timed(spawn_world, _serve_f32_rank, ex.PODS * ex.DATA * ex.TP, EXAMPLE_PROMPT))


class ExampleRuns:
    """The examples' processes, started with the phase EXAMPLES_FROM and
    run one after another in a thread of their own: train_lm first, then
    the quickstart's worlds, then the serve example's.  In the full run
    they run beside the TP phases that follow EXAMPLES_FROM (gloo on the
    host, the card mostly idle), and the example phases, placed after
    those and before the 8-rank TP phases and every timed or profiled
    phase after them, wait for them; alone (``--phases examples``) nothing
    runs beside them."""

    def __init__(self):
        self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self.jobs = {name: self.pool.submit(fn) for name, fn in (
            ("train_lm", _train_lm_process), ("quickstart", _quickstart_worlds),
            ("serve", _serve_worlds))}

    def result(self, name: str):
        """The job's result once it has ended (each bounds its own time)."""
        return self.jobs[name].result()

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


def example_quickstart(run: "Run") -> dict[str, int]:
    """``examples/torch_quickstart.py`` on 8 spawned gloo ranks on the
    card (``run("cuda")``), its lines printed, and the same world on the
    CPU (``run("cpu")``): every synced buffer on the card bit-equal to the
    CPU's (the int8 sync's too: the codec kernels against their plain
    versions), every line equal to the CPU's, flat and hier agree, the
    flat sum within 1e-5 of the host's largest, and the int8 sync
    launches amax_block, quant_scaled and dequant_int8 once a rank and no
    sync anything else."""
    ex = _example("torch_quickstart")
    (res, took), (cpu, took_cpu) = run.examples.result("quickstart")
    for line in res["lines"]:
        print(line)
    for name in ex.SYNCS:
        got, want = res["synced"][name], cpu["synced"][name]
        check(torch.equal(got, want), f"quickstart {name}: the card's buffer "
              f"{(got - want).abs().max().item():.3e} off the CPU's")
    check(res["lines"] == cpu["lines"], f"quickstart lines {res['lines'][:3]} against the "
                                        f"CPU's {cpu['lines'][:3]}")
    check(res["lines"][:2] == ["flat == hier: True", "flat == hier_pipelined: True"],
          f"quickstart: {res['lines'][:2]}")
    codec = {"amax_block": 1, "quant_scaled": 1, "dequant_int8": 1}
    want = {"flat": {}, "hier": {}, "hier_pipelined": {}, "int8": codec}
    for rank, launches in enumerate(res["launches"]):
        check(launches == want, f"quickstart rank {rank} launches {launches}, expected {want}")
    g = ex.gradients().astype(np.float64)
    host = sum(np.split(g, ex.PODS * ex.DATA))
    err = float(np.abs(res["synced"]["flat"].double().numpy() - host).max() / np.abs(host).max())
    check(err <= 1e-5, f"quickstart flat sum {err:.3e} off the host's")
    print(f"[example] [{run.smi}] quickstart, 8 gloo ranks on the card: {took:.1f} s (on the "
          f"CPU {took_cpu:.1f} s); the four synced buffers bit-equal to the CPU world's, int8 "
          f"included; the flat sum {err:.3e} of its largest off the host's; launches a rank "
          f"{res['launches'][0]}")
    return _summed(r["int8"] for r in res["launches"])


def example_train_lm(run: "Run") -> dict:
    """``examples/torch_train_lm.py --hundred-m --steps 300`` (a process
    of its own, its world of one on the card): every step launches one
    pack_slots (the one bf16 gradient segment of a hier step; no codec)
    and nothing else, and the loss falls; the step ms, tokens/s and peak
    from its summary line.  Then, with nothing beside it, one step of the
    same model and batch profiled in this process: its device time and
    idle share."""
    ex = _example("torch_train_lm")
    proc, took = run.examples.result("train_lm")
    check(proc.returncode == 0, f"train_lm exited {proc.returncode}: {proc.stdout[-3000:]}")
    lines = proc.stdout.splitlines()
    print("\n".join(line for line in lines if not line.startswith("{")))
    records = [json.loads(line) for line in lines if line.startswith("{")]
    steps, summary = [rec for rec in records if "step" in rec], records[-1]
    losses = summary["losses"]
    want = dict.fromkeys(ops.KERNELS, 0) | {"pack_slots": 1}
    check(len(steps) == len(losses) == TRAIN_LM_STEPS, f"train_lm: {len(steps)} steps")
    check(all(rec["launches"] == want for rec in steps),
          f"train_lm launches per step {[rec['launches'] for rec in steps[:3]]}, expected {want}")
    check(losses[-1] < losses[0] and all(math.isfinite(x) for x in losses),
          f"train_lm losses {losses[0]} -> {losses[-1]}")
    ms = sorted(rec["ms_per_step"] for rec in steps[1:])
    print(f"[example] [{run.smi}] train_lm {summary['arch']} ({summary['params']} params, "
          f"bf16), {summary['global_batch']} x {summary['seq']} tokens, {TRAIN_LM_STEPS} hier "
          f"steps in a world of one: {took:.1f} s, step {summary['step_ms']:.2f} ms (median "
          f"of steps 1-{TRAIN_LM_STEPS - 1}; from {ms[0]:.2f} to {ms[-1]:.2f}, quartiles "
          f"{ms[len(ms) // 4]:.2f} and {ms[3 * len(ms) // 4]:.2f}), "
          f"{summary['tokens_per_s']:.1f} tokens/s, peak {summary['peak_mem_gb']:.3f} GB, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches per step {want}")
    cfg = ex.make_config(True)
    ex.register(cfg)
    profile = profile_training(run.dev, run.rt, run.smi, "hier", None, with_attention=False,
                               arch=cfg.name, seq=summary["seq"],
                               batch=summary["global_batch"])
    return {"counts": {k: n * TRAIN_LM_STEPS for k, n in want.items()}, "seconds": took,
            "losses": [losses[0], losses[-1]], "profile": profile,
            **{k: summary[k] for k in ("step_ms", "tokens_per_s", "peak_mem_gb", "params")}}


def example_serve(run: "Run") -> dict[str, int]:
    """``examples/torch_serve_disaggregated.py`` on 8 spawned gloo ranks
    on the card at EXAMPLE_PROMPT tokens (bf16; ``run("cuda")``), its
    lines printed, and its steps in f32 on the card and on the CPU in one
    world: per rank flash once per layer per prefill, quant_int8 and
    dequant_int8 once per int8 leaf (k, v) per int8 transfer, nothing in
    decode or the raw transfer; the card's f32 tokens equal the CPU's on
    every path.  (The bf16 world's flash and codec shapes are held against
    their plain versions in the codec and flash phases.)"""
    ex = _example("torch_serve_disaggregated")
    (res, took), (ranks, took_f32) = run.examples.result("serve")
    ex.report(res)
    check(res["same"], "serve example: the disaggregated generation left same-pod's")
    layers = ex.smoke_config().n_layers
    codec = {"quant_int8": 2, "dequant_int8": 2}
    want = {"prefill": {"flash_attention_bhsd": layers}, "transfer": {},
            "transfer_int8": codec, "decode": {}}
    for name, per_rank in (("bf16", res["launches"]),
                           ("f32", [r["gpu"]["launches"] for r in ranks])):
        for rank, launches in enumerate(per_rank):
            check(launches == want, f"serve example {name} rank {rank}: {launches}, "
                                    f"expected {want}")
    check(res["int8_leaves"] == ["k", "v"], f"int8 leaves {res['int8_leaves']}")
    gpu, cpu = ex.gather([r["gpu"] for r in ranks]), ex.gather([r["cpu"] for r in ranks])
    for path, tokens in gpu.items():
        check(np.array_equal(tokens, cpu[path]),
              f"serve example {path}: the card's f32 tokens {tokens.tolist()} against the "
              f"CPU's {cpu[path].tolist()}")
    agree = float(np.mean(ex.swap_halves(gpu["same_pod"]) == gpu["int8"]))
    print(f"[example] [{run.smi}] serve_disaggregated, 8 gloo ranks on the card, "
          f"{EXAMPLE_PROMPT}-token prompts: bf16 {took:.1f} s (int8 agreement "
          f"{res['int8_agreement']:.4f}); f32 on the card and the CPU {took_f32:.1f} s, tokens "
          f"equal on every path (int8 agreement {agree:.4f}); launches a rank "
          f"{res['launches'][0]}")
    return _summed(p for r in res["launches"] for p in r.values())


class Run:
    """What the phases of one run share: the card, the generator, the
    kernels line's rows, each phase's result and seconds, and the
    runtimes of the world of one (built by the first phase that needs
    them)."""

    def __init__(self, dev, smi: str):
        self.dev, self.smi = dev, smi
        self.gen = torch.Generator(device=dev).manual_seed(0)
        self.rows: dict = {}
        self.out: dict = {}
        self.seconds: dict[str, float] = {}
        self.rt = self.rt_fsdp = None
        self.dryrun: DryrunCells | None = None
        self.examples: ExampleRuns | None = None
        self._agree = self._planned = None

    def __getitem__(self, name: str):
        if name not in self.out:
            raise RuntimeError(f"phase {name!r} must run first")
        return self.out[name]

    def agree(self) -> dict[str, bool]:
        if self._agree is None:
            self._agree = check_library_nan(self.dev)
        return self._agree

    def planned(self):
        """The plan the launcher makes for PLAN_WORLD."""
        if self._planned is None:
            pods, per_pod = PLAN_WORLD
            self._planned = train_launch.make_plan(
                get_config(ARCH), pods, pods * per_pod, "hier", "int8", plan="auto",
                global_batch=TRAIN_BATCH, seq=TRAIN_SEQ, log=lambda line: None)
        return self._planned

    def rt_for(self, mode: str):
        return self.rt_fsdp if mode == "fsdp" else self.rt


def _rows(run: Run, rows: dict) -> None:
    run.rows.update(rows)


def _codec(run: Run) -> None:
    _rows(run, check_codec(run.dev, run.gen, run.agree()))
    check_codec_views(run.dev, run.gen)


def _shared_codec(run: Run) -> None:
    n = _segment(run)
    codec_rows, run.out["shared_codec_int32"] = check_shared_codec(run.dev, run.gen, n,
                                                                  run.agree())
    _rows(run, codec_rows)


def _segment(run: Run) -> int:
    """hier's one bf16 gradient segment, aligned as the codec takes it."""
    return packing.aligned_size(run["train:hier"]["params"], packing.comm_alignment(1, 4, 1024))


def _pack(run: Run) -> dict:
    pack_rows, counts = check_pack(run.dev, run.gen, run.rt, run.smi)
    _rows(run, pack_rows)
    return counts


SERVED = ((ARCH, PROMPT), (SSM_ARCH, PROMPT), (HYBRID_ARCH, HYBRID_SEQ))
SSM_TRAINED = ((SSM_ARCH, TRAIN_SEQ), (HYBRID_ARCH, HYBRID_SEQ))
EV_TRAINED = ((ENCDEC_ARCH, None), (VLM_ARCH, VLM_TRAIN_LAYERS))


def phase_table() -> list[tuple]:
    """Every phase of the full run, in its order: (name, needs the world of
    one, frees the card after, only when named, fn(run)).  The full run
    (no ``--phases``) runs all but the last kind."""
    t = [("codec", False, False, False, _codec),
         ("flash", False, False, False,
          lambda r: _rows(r, check_flash(r.dev, r.gen, r.smi))),
         ("ssd", False, True, False, lambda r: _rows(r, check_ssd(r.dev, r.gen, r.smi))),
         # MoE phase (a) on the emptied card: 60.16 GB of weights
         ("serve_moe", False, True, False, lambda r: serve_moe(r.dev, r.smi)),
         ("profile_moe", False, True, False, lambda r: profile_moe(r.dev, r.smi))]
    # phase 11 (a): chameleon-34b on the emptied card (68.59 GB of
    # weights), then whisper-tiny
    for arch in (VLM_ARCH, ENCDEC_ARCH):
        t += [(f"serve:{arch}", False, True, False,
               lambda r, a=arch: serve_full_width(r.dev, r.smi, a)),
              (f"profile_serving:{arch}", False, True, False,
               lambda r, a=arch: profile_serving(r.dev, r.smi, a))]
    t += [(f"small_model:{arch}", False, False, False,
           lambda r, a=arch: check_small_model(r.dev, a))
          for arch in (ARCH, SSM_ARCH, HYBRID_ARCH) + MOE_SMOKE_ARCHS + (ENCDEC_ARCH, VLM_ARCH)]
    # the world of one from here on: gloo for the CPU, NCCL for the card
    t += [(f"small_training:{mode}", True, False, False,
           lambda r, m=mode, c=codec: check_small_training(r.dev, r.rt_for(m), m, c))
          for mode, codec in TRAIN_RUNS]
    t += [(f"small_training:{arch}", True, False, False,       # and MoE phase (b)
           lambda r, a=arch: check_small_training(r.dev, r.rt, "hier", "int8", arch=a))
          for arch in MOE_SMOKE_ARCHS + (SSM_ARCH, HYBRID_ARCH)]
    t.append(("small_training:planned", True, False, False,
              lambda r: check_small_training(r.dev, r.rt, r.planned().mode, "int8",
                                             r.planned())))
    for arch, prompt in SERVED:
        t += [(f"serve:{arch}", True, True, False,
               lambda r, a=arch, p=prompt: serve_full_width(r.dev, r.smi, a, p)),
              (f"profile_serving:{arch}", True, True, False,
               lambda r, a=arch, p=prompt: profile_serving(r.dev, r.smi, a, p))]
    # tensor parallelism: (a) TP 2 at full depth against the TP-1 run
    # above, (b) TP 4 against TP 1 at TP_DEPTH layers, (c) TP 2 training;
    # then mamba2-2.7b served at TP 2 against its TP-1 run, the smoke
    # mamba2 and hymba trained at TP 2, and MoE phase (d): expert
    # parallelism, two ranks on the one card
    t += [("serve_depth", True, True, False,
           lambda r: disaggregated.run(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                                       device=r.dev, layers=TP_DEPTH)),
          ("serve_tp2", True, False, False, lambda r: serve_tp(r.smi, 2, r[f"serve:{ARCH}"][0])),
          ("serve_tp4", True, False, False, lambda r: serve_tp(r.smi, 4, r["serve_depth"])),
          (f"train_tp:{ARCH}", True, False, False, lambda r: train_tp(r.smi)),
          ("serve_ssm_tp", True, False, False, lambda r: serve_ssm_tp(r.dev, r.smi))]
    t += [(f"train_tp:{arch}", True, False, False, lambda r, a=arch: train_tp(r.smi, a))
          for arch in (SSM_ARCH, HYBRID_ARCH)]
    # phase 14: the examples (examples/torch_*.py), whose processes ran
    # since EXAMPLES_FROM (ExampleRuns): the quickstart and the serve
    # example on 8 spawned gloo ranks sharing the card, train_lm in a
    # process of its own; held here, before the 8-rank TP phases
    t += [("example:quickstart", False, False, False, example_quickstart),
          ("example:serve_disaggregated", False, False, False, example_serve),
          ("example:train_lm", True, True, False, example_train_lm)]
    # head padding under TP: hymba-1.5b served at TP 8 (and in f32, card
    # against CPU), whisper-tiny at TP 4, the smoke hymba trained at TP 8;
    # then GPipe over a pod group of 2
    t += [(f"serve_tp{tp}:{arch}", True, True, False, lambda r, a=arch: serve_padded(r.smi, a))
          for arch, tp in PAD_SERVE.items()]
    t += [(f"train_tp8:{HYBRID_ARCH}", True, False, False,
           lambda r: train_tp(r.smi, HYBRID_ARCH, 8)),
          ("pp", True, True, False, lambda r: check_pp(r.dev, r.smi))]
    t += [("serve_moe_tp", True, True, False, lambda r: serve_moe_tp(r.dev, r.smi)),
          (f"train_tp:{MOE_ARCH}", True, False, False, lambda r: train_tp(r.smi, MOE_ARCH))]
    t += [(f"train:{mode}", True, True, False,
           lambda r, m=mode, c=codec: train_full_width(r.dev, r.smi, m, c))
          for mode, codec in TRAIN_RUNS]
    # phase 13: the dry run, held against the hier + int8 run just above
    t.append(("dryrun", False, True, False,
              lambda r: dryrun_cells(r.smi, r["train:hier"], r.dryrun)))
    t.append(("train_moe", True, True, False, lambda r: train_moe(r.dev, r.smi)))   # MoE (c)
    t += [(f"train:{arch}", True, True, False,
           lambda r, a=arch, q=seq: train_full_width(r.dev, r.smi, "hier", "int8", a, q))
          for arch, seq in SSM_TRAINED]
    t += [(f"train:{arch}", True, True, False,                  # phase 11 (b)
           lambda r, a=arch, n=layers: train_full_width(r.dev, r.smi, "hier", "int8", a,
                                                        layers=n))
          for arch, layers in EV_TRAINED]
    # runtime robustness: (a) the guard and the chaos engine at full
    # width, (b) checkpoint and resume, (c) elastic re-planning on four
    # ranks
    t += [("planned_paths", True, True, False, lambda r: train_planned_paths(r.dev, r.smi)),
          ("chaos", True, True, False, lambda r: train_chaos(r.dev, r.smi)),
          ("nan_on_int8_wire", True, False, False,
           lambda r: check_nan_on_int8_wire(r.dev, r.rt)),
          ("resume", True, True, False, lambda r: train_resume(r.dev, r.smi)),
          ("elastic", True, False, False, lambda r: train_elastic(r.smi)),
          ("shared_codec", True, True, False, _shared_codec),
          ("shared_codec_f32", True, True, False,
           lambda r: check_shared_codec_f32(r.dev, r.gen, _segment(r), r.agree())),
          ("pack", True, True, False, _pack)]
    t += [(f"profile_training:{mode}", True, False, False,
           lambda r, m=mode, c=codec: profile_training(r.dev, r.rt_for(m), r.smi, m, c,
                                                       layers=PROFILE_LAYERS,
                                                       with_attention=m == "hier"))
          for mode, codec in TRAIN_RUNS]
    t.append(("profile_training:planned", True, False, False,
              lambda r: profile_training(r.dev, r.rt, r.smi, r.planned().mode, "int8",
                                         layers=PROFILE_LAYERS,
                                         with_attention=False, planned=r.planned())))
    # only when named: a profiled training step of each SSM family, with
    # the plain SSD's and the conv's ranges
    t += [(f"profile_training:{arch}", True, True, True,
           lambda r, a=arch, q=seq: profile_training(r.dev, r.rt, r.smi, "hier", "int8",
                                                     with_attention=False, arch=a, seq=q))
          for arch, seq in SSM_TRAINED]
    return t


# the phases of one slice, for ``--phases NAME``; each runs in the full
# run's order
SLICES = {
    "moe": ("flash", "serve_moe", "profile_moe")
    + tuple(f"{p}:{a}" for p in ("small_model", "small_training") for a in MOE_SMOKE_ARCHS)
    + ("serve_moe_tp", f"train_tp:{MOE_ARCH}", "train_moe"),
    "ssm": ("flash", "ssd") + tuple(
        f"{p}:{a}" for p in ("small_model", "small_training", "serve", "profile_serving",
                             "train_tp", "train", "profile_training")
        for a in (SSM_ARCH, HYBRID_ARCH)) + ("serve_ssm_tp",),
    "runtime": ("chaos", "nan_on_int8_wire", "resume", "elastic"),
    "padding": ("codec", "flash", "ssd") + tuple(f"serve_tp{tp}:{a}" for a, tp in PAD_SERVE.items())
    + (f"train_tp8:{HYBRID_ARCH}",),
    "pp": ("pp",),
    "dryrun": ("train:hier", "dryrun"),
    "examples": ("example:quickstart", "example:train_lm", "example:serve_disaggregated"),
    "encdec_vlm": ("flash",) + tuple(
        f"{p}:{a}" for p in ("serve", "profile_serving", "small_model", "train")
        for a in (ENCDEC_ARCH, VLM_ARCH)),
}


def run_phases(run: Run, names: set[str] | None) -> None:
    """Run the phases named (all but the named-only ones for ``None``) in
    the table's order, each timed; the world of one starts before the
    first phase that needs it and ends after the last, the dry run's
    cells, when its phase is among them, start before the first phase
    past KERNEL_TIMING_PHASES, and the examples' processes, when theirs
    are, before the first phase from EXAMPLES_FROM on.  A failed phase
    raises."""
    world = False
    table = phase_table()
    order = {row[0]: i for i, row in enumerate(table)}
    rows = [row for row in table
            if not ((names is None and row[3]) or (names is not None and row[0] not in names))]
    dryrun = any(row[0] == "dryrun" for row in rows)
    examples = any(row[0].startswith("example:") for row in rows)
    try:
        for name, needs_world, frees, named_only, fn in rows:
            if dryrun and run.dryrun is None and name not in KERNEL_TIMING_PHASES:
                run.dryrun = DryrunCells()
            if examples and run.examples is None and order[name] >= order[EXAMPLES_FROM]:
                run.examples = ExampleRuns()
            if needs_world and not world:
                train_launch.init_world(run.dev)
                world = True
                run.rt = runtime_for_groups(pods=1, data_per_pod=1)
                # fsdp's runtime: the data group of one is also the FSDP group
                run.rt_fsdp = runtime_for_groups(pods=1, data_per_pod=1, fsdp=True)
            t0 = time.perf_counter()
            run.out[name] = fn(run)
            if frees:
                free_memory()
            run.seconds[name] = time.perf_counter() - t0
            print(f"[phase] {name}: {run.seconds[name]:.1f} s", flush=True)
    finally:
        if run.dryrun is not None:
            run.dryrun.close()
        if run.examples is not None:
            run.examples.close()
        if world:
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", nargs="+", metavar="NAME",
                    help="run only these phases or slices (" + ", ".join(SLICES)
                    + "), in the full run's order, and print no result")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    names = None
    if args.phases:
        known = {row[0] for row in phase_table()}
        names = {n for a in args.phases for n in SLICES.get(a, (a,))}
        if names - known:
            ap.error(f"unknown phases {sorted(names - known)}; known: {sorted(known)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = card()
    print(f"[env] {smi}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"python {sys.version.split()[0]}")
    lib = _build.library()
    print(f"[build] [{smi}] {len(_build.sources())} sources -> {lib.path.name} in "
          f"{lib.build_seconds:.1f} s (one nvcc per source, in parallel, sm_90a)")
    run = Run(dev, smi)
    run_phases(run, names)
    if names is not None:
        print(f"[time] chip_smoke --phases {' '.join(args.phases)}: "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    report(run)
    print(f"[time] chip_smoke: {time.perf_counter() - t_start:.1f} s from start to result")
    print(smi)
    print(json.dumps({"kernels": list(run.rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def report(run: Run) -> None:
    """The full run's lines: the runtime phases' seconds, peak memory by
    gradient sync, each kernel's times and launches by path, and one JSON
    object of the paths' numbers."""
    smi, rows, out = run.smi, run.rows, run.out
    took = (run.seconds["chaos"] + run.seconds["nan_on_int8_wire"], run.seconds["resume"],
            run.seconds["elastic"])
    print(f"[time] [{smi}] runtime phases: (a) {took[0]:.1f} s, (b) {took[1]:.1f} s, "
          f"(c) {took[2]:.1f} s, together {sum(took):.1f} s")
    train = {mode: out[f"train:{mode}"] for mode, _ in TRAIN_RUNS}
    peaks = ", ".join(f"{m} {r['peak_mem_gb']:.3f} GB" for m, r in train.items())
    print(f"[train] [{smi}] peak memory by gradient sync: {peaks}")
    n_segment = _segment(run)
    deq, f32 = out["shared_codec_int32"], out["shared_codec_f32"]
    serve = {arch: out[f"serve:{arch}"][0] for arch, _ in SERVED}
    serve_counts = {arch: out[f"serve:{arch}"][1] for arch, _ in SERVED}
    serve_profile = {arch: out[f"profile_serving:{arch}"] for arch, _ in SERVED}
    moe_serve, moe_counts = out["serve_moe"]
    moe_profile, moe_train = out["profile_moe"], out["train_moe"]
    ev_serve = {arch: out[f"serve:{arch}"][0] for arch in (VLM_ARCH, ENCDEC_ARCH)}
    ev_counts = {arch: out[f"serve:{arch}"][1] for arch in (VLM_ARCH, ENCDEC_ARCH)}
    ev_profile = {arch: out[f"profile_serving:{arch}"] for arch in (VLM_ARCH, ENCDEC_ARCH)}
    ev_train = {arch: out[f"train:{arch}"] for arch, _ in EV_TRAINED}
    ssm_train = {arch: out[f"train:{arch}"] for arch, _ in SSM_TRAINED}
    planned_entry, planned_run = out["planned_paths"]
    chaos, resume = out["chaos"], out["resume"]
    tp_counts, tp_serve = {}, {}
    for tp in (2, 4):
        tp_counts[f"serve_tp{tp}"], tp_serve[f"tp{tp}"] = out[f"serve_tp{tp}"]
    tp_counts["train_tp2"] = out[f"train_tp:{ARCH}"]
    tp_counts["serve_mamba2_tp2"], ssm_tp = out["serve_ssm_tp"]
    tp_counts["train_mamba2_tp2"] = out[f"train_tp:{SSM_ARCH}"]
    tp_counts["train_hymba_tp2"] = out[f"train_tp:{HYBRID_ARCH}"]
    pad = {}
    for arch, tp in PAD_SERVE.items():
        tp_counts[f"serve_{arch.split('-')[0]}_tp{tp}"], pad[arch] = out[f"serve_tp{tp}:{arch}"]
    tp_counts["train_hymba_tp8"] = out[f"train_tp8:{HYBRID_ARCH}"]
    tp_counts["serve_moe_tp2"], moe_tp = out["serve_moe_tp"]
    tp_counts["train_moe_tp2"] = out[f"train_tp:{MOE_ARCH}"]
    train_profile = {mode: out[f"profile_training:{mode}"] for mode, _ in TRAIN_RUNS}
    train_profile["planned"] = out["profile_training:planned"]

    rows["dequant_int8"]["int32_grad_segment"] = deq
    rows["amax_block"]["f32_grad_segment"] = f32["amax_block"]
    rows["quant_scaled"]["f32_grad_segment"] = f32["quant_scaled"]
    rows["dequant_int8"]["int32_f32_grad_segment"] = f32["dequant_int8"]
    paths = {"serve": serve_counts[ARCH], "serve_mamba2": serve_counts[SSM_ARCH],
             "serve_hymba": serve_counts[HYBRID_ARCH],
             "train_mamba2": ssm_train[SSM_ARCH]["counts"],
             "train_hymba": ssm_train[HYBRID_ARCH]["counts"],
             "serve_moe": moe_counts, "train_moe": moe_train["counts"],
             "serve_whisper": ev_counts[ENCDEC_ARCH], "serve_chameleon": ev_counts[VLM_ARCH],
             "train_whisper": ev_train[ENCDEC_ARCH]["counts"],
             "train_chameleon": ev_train[VLM_ARCH]["counts"],
             **{f"train_{mode}": res["counts"] for mode, res in train.items()},
             "train_planned_entry": planned_entry["counts"],
             "train_planned": planned_run["counts"], "conformance": out["pack"],
             "train_chaos": chaos["counts"], "train_resume": resume["counts"],
             "train_elastic": out["elastic"],
             "example_quickstart": out["example:quickstart"],
             "example_train_lm": out["example:train_lm"]["counts"],
             "example_serve": out["example:serve_disaggregated"],
             **tp_counts}
    for name, row in rows.items():
        row["paths"] = {path: counts[name] for path, counts in paths.items()}
        row["launches"] = sum(row["paths"].values())
        check(row["launches"] > 0, f"{name} launched on no path")
        lib_ms = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        rate = (f" = {rate_tbs(row):.3f} TB/s against {PEAK_BYTES_PER_S / 1e12} TB/s"
                if row["bound_by"] == "bytes" else "")
        dev_ms = f", device time {row['device_ms']:.4f} ms" if "device_ms" in row else ""
        print(f"[time] [{smi}] {name}: {row['ms']:.4f} ms{dev_ms}, bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']}){rate}, plain {row['plain_ms']:.4f} ms, library "
              f"{lib_ms} ms, launches {row['paths']}")
    ssm = rows["dequant_int8"]["ssm_state_f32"]
    lib_ms = "-" if ssm["library_ms"] is None else f"{ssm['library_ms']:.4f}"
    print(f"[time] [{smi}] dequant_int8 int8 -> f32, mamba2-2.7b SSM state: {ssm['ms']:.4f} ms, "
          f"device time {ssm['device_ms']:.4f} ms, bound {ssm['bound_ms']:.4f} ms (bytes) = "
          f"{rate_tbs(ssm):.3f} TB/s against {PEAK_BYTES_PER_S / 1e12} TB/s, plain "
          f"{ssm['plain_ms']:.4f} ms, library (torch.mul) {lib_ms} ms")
    lib_ms = "-" if deq["library_ms"] is None else f"{deq['library_ms']:.4f}"
    print(f"[time] [{smi}] dequant_int8 int32 -> bf16, {n_segment} values: "
          f"{deq['ms']:.4f} ms, bound {deq['bound_ms']:.4f} ms (bytes) = "
          f"{rate_tbs(deq):.3f} TB/s against {PEAK_BYTES_PER_S / 1e12} TB/s, "
          f"plain {deq['plain_ms']:.4f} ms, library (torch.mul) {lib_ms} ms")
    for name, what in (("amax_block", "f32 input"), ("quant_scaled", "f32 input"),
                       ("dequant_int8", "int32 -> f32")):
        row = f32[name]
        lib_ms = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        print(f"[time] [{smi}] {name} {what}, hier_zero1's {n_segment}-value segment: "
              f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms (bytes) = "
              f"{rate_tbs(row):.3f} TB/s against {PEAK_BYTES_PER_S / 1e12} TB/s, "
              f"library {lib_ms} ms")
    print(json.dumps({"serve": {arch: {k: res[k] for k in (
        "ttft_ms", "decode_ms_per_step", "int8_transfer_ms", "peak_mem_gb",
        "int8_token_agreement", "cache_bytes", "params")} for arch, res in serve.items()},
        "serve_profile": serve_profile,
        "train": {mode: {k: res[k] for k in ("compression", "step_ms", "tokens_per_s",
                                              "peak_mem_gb", "global_batch", "seq", "params")}
                  for mode, res in train.items()},
        "train_losses": {mode: [r["loss"] for r in res["records"]]
                         for mode, res in train.items()},
        "train_planned": {name: {k: res[k] for k in (
            "mode", "packed", "step_ms", "tokens_per_s", "peak_mem_gb", "plan_cache",
            "vector")} | {"launches": res["counts"],
                          "losses": [r["loss"] for r in res["records"]]}
            for name, res in (("entry", planned_entry), ("plan_world", planned_run))},
        "train_profile": train_profile, "serve_tp_gloo_one_card": tp_serve,
        "moe": {"serve": {k: moe_serve[k] for k in (
                    "ttft_ms", "decode_ms_per_step", "int8_transfer_ms", "peak_mem_gb",
                    "int8_token_agreement", "cache_bytes", "params", "bounds")},
                "profile": moe_profile,
                "train": {k: moe_train[k] for k in ("step_ms", "tokens_per_s", "peak_mem_gb",
                                                     "params")}
                | {"losses": [r["loss"] for r in moe_train["records"]],
                   "aux": [r["aux"] for r in moe_train["records"]]},
                "tp2_gloo_one_card": moe_tp},
        "ssm": {"mamba2_tp2_gloo_one_card": ssm_tp,
                "train": {arch: {k: res[k] for k in ("step_ms", "tokens_per_s", "peak_mem_gb",
                                                     "params", "seq")}
                          | {"losses": [r["loss"] for r in res["records"]],
                             "grad_norms": [r["gnorm"] for r in res["records"]]}
                          for arch, res in ssm_train.items()}},
        "encdec_vlm": {
            "serve": {arch: {k: res[k] for k in (
                "ttft_ms", "decode_ms_per_step", "int8_transfer_ms", "peak_mem_gb",
                "int8_token_agreement", "cache_bytes", "params", "layers")}
                for arch, res in ev_serve.items()},
            "serve_profile": ev_profile,
            "train": {arch: {k: res[k] for k in ("step_ms", "tokens_per_s", "peak_mem_gb",
                                                 "params", "seq")}
                      | {"layers": get_config(arch).n_layers if layers is None else layers,
                         "losses": [r["loss"] for r in res["records"]],
                         "grad_norms": [r["gnorm"] for r in res["records"]]}
                      for (arch, layers), res in zip(EV_TRAINED, ev_train.values())}},
        "padding": pad, "pp": out["pp"], "dryrun": out["dryrun"],
        "examples": {"train_lm": {k: v for k, v in out["example:train_lm"].items()
                                  if k != "counts"}},
        "runtime": {"chaos": {"guard": chaos["guard"], "guard_split_ms": chaos["guard_split_ms"],
                              "guard_ms": [r["guard_ms"] for r in chaos["records"]],
                              "step_ms": chaos["step_ms"],
                              "losses": [r["loss"] for r in chaos["records"]]},
                    "checkpoint": {"ops": resume["ops"], "losses": resume["losses"]}},
        "card": smi}))


if __name__ == "__main__":
    sys.exit(main())
