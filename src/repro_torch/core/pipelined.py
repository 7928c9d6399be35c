"""Pipelined collective execution (paper §4.3.2, Fig. 9): the counterpart
of the JAX package's ``core/pipelined.py``.

The schedule IR's ``ChunkLoop`` models the 3-phase software pipeline

    iter i:  RS_intra(chunk i)  |  C2C(chunk i-1)  |  AG_intra(chunk i-2)

and ``execute_chunk_loop`` runs it as the reference does: the intra
ReduceScatter and AllGather run once on the whole payload, and only the
pod hop and its wire codec are cut into ``n_chunks`` pieces of the
post-ReduceScatter shard.  The loop peels the fill and the drain, so
exactly k pod reductions run for k chunks, in the reference's order:
compress(i) is issued before the transfer of chunk i-1, and each
reduced chunk is written back in place at its shard offset (the
reference's ``dynamic_update_slice``), so no second shard-sized buffer
exists.  With int8 each chunk is encoded on its own, its ragged tail
padded to a whole block, as the reference's ``int8_encode`` pads it.

Every call is issued on the current stream in host order, on every rank
alike (``int8_encode`` holds a collective, the MAX of the block scales
over the pod group), so the result is that of the sequential order.
Nothing here overlaps compress(i) with transfer(i-1) on the card yet.

The mechanism-faithful ring variant (``use_ring=True``) replaces the
pod group's all-reduce with the explicit reduce ring of
``primitives.c2c_red_ring`` (the codec is not applied, as in the
reference).  ``pipelined_all_gather`` is AllGatherH with the pod ring
cut per pod shard (Fig. 9's AllGather).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import compression, primitives
from . import schedule as schedule_ir


def execute_chunk_loop(step: schedule_ir.ChunkLoop, flat: torch.Tensor, cfg,
                       weight: torch.Tensor | None = None) -> torch.Tensor:
    """ChunkLoop interpreter of the schedule IR: run the AllReduceH body
    (ReduceScatter -> c2cRed -> AllGather) chunk-pipelined.  ``weight``
    is the deferred cluster weight (the schedule's ``Scale`` step),
    applied on each chunk at the C2C stage or folded into the codec."""
    kinds = {type(s) for s in step.body}
    if not {schedule_ir.IntraReduceScatter, schedule_ir.C2CRed,
            schedule_ir.IntraAllGather} <= kinds:
        raise NotImplementedError(
            f"chunk-pipelined execution only implements the AllReduceH "
            f"body; got {sorted(k.__name__ for k in kinds)}")
    if any(isinstance(s, schedule_ir.C2CRed) and s.scatter for s in step.body):
        raise NotImplementedError(
            "the border-communicator exchange is not chunk-pipelined")
    return pipelined_hier_psum(flat, cfg, weight=weight)


def _codec_stages(cfg, dtype: torch.dtype, chunk_n: int, use_ring: bool,
                  weight: torch.Tensor | None):
    """(encode, transfer) with transfer(encode(chunk)) the pod reduction of
    ``chunk``: encode is the local compress stage (with the shared-scale
    MAX over the pod group for int8), transfer moves the encoded chunk
    over the pod group and decodes it into ``dtype``."""
    pod = cfg.pod_group

    def weighted(shard):
        if weight is None:
            return shard
        return shard * weight.to(device=shard.device, dtype=shard.dtype)

    if use_ring:
        def transfer(enc):
            return primitives.c2c_red_ring(enc, pod)
        return weighted, transfer
    if cfg.compression == "int8":
        def encode(shard):
            return compression.int8_encode(shard, pod, weight=weight)

        def transfer(enc):
            q, scale = enc
            return compression.int8_transfer(q, scale, pod, chunk_n, dtype)
        return encode, transfer
    if cfg.compression == "bf16":
        def encode(shard):
            return weighted(shard).to(torch.bfloat16)

        def transfer(enc):
            return primitives.c2c_red(enc, pod).to(dtype)
        return encode, transfer
    if cfg.compression is not None:
        raise ValueError(f"unknown codec {cfg.compression!r}")

    def transfer(enc):
        return primitives.c2c_red(enc, pod)
    return weighted, transfer


def _write(dst: torch.Tensor, value: torch.Tensor) -> None:
    """dst[:] = value, unless the pod reduction already ran in place (the
    same storage at the same offset: a test that reads no address, so a
    traced step's tensors with no data take it too)."""
    same = (value.untyped_storage()._cdata == dst.untyped_storage()._cdata
            and value.storage_offset() == dst.storage_offset())
    if not same:
        dst.copy_(value)


def pipelined_hier_psum(flat: torch.Tensor, cfg, use_ring: bool = False,
                        weight: torch.Tensor | None = None) -> torch.Tensor:
    """AllReduceH on a 1-D tensor, the pod hop chunked and pipelined.
    ``flat`` is consumed and its length is a multiple of the intra group's
    size; the result has its length.  Packed buffers are aligned to
    ``intra * n_chunks``, so the chunk split never pads them."""
    if flat.dim() != 1:
        raise ValueError(f"pipelined_hier_psum: a 1-D tensor, got {tuple(flat.shape)}")
    intra, pod = cfg.intra_group, cfg.pod_group
    if pod is None:
        # hier_psum runs a pipeline of one cluster as one intra all-reduce
        # through the "flat" seam; nothing else reaches here without pods
        raise ValueError("pipelined_hier_psum: no pod group to pipeline against")
    k = max(1, int(cfg.n_chunks))
    n = flat.numel()
    pad = (-n) % (k * primitives.axis_size(intra))
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    rs = primitives.hom_reduce_scatter(flat, intra)
    del flat
    chunk = rs.numel() // k
    encode, raw_transfer = _codec_stages(cfg, rs.dtype, chunk, use_ring, weight)

    def transfer(enc):
        return raw_transfer(primitives.apply_inject(enc, "chunk_c2c"))

    chunks = rs.view(k, chunk)
    enc = encode(chunks[0])
    for i in range(1, k):
        nxt = encode(chunks[i])                    # compress(i)
        _write(chunks[i - 1], transfer(enc))       # C2C(i-1), at its shard offset
        enc = nxt
    _write(chunks[k - 1], transfer(enc))           # drain: C2C of chunk k-1
    del enc
    return primitives.hom_all_gather(rs, intra)[:n]


def pipelined_all_gather(x: torch.Tensor, cfg) -> torch.Tensor:
    """AllGatherH with the pod ring cut per pod shard, so that the intra
    Bcast of pod shard j can overlap the hop of pod shard j+1 (Fig. 9's
    AllGather).  Returns every rank's ``x`` concatenated along dim 0 in
    rank order (pod-major)."""
    if x.dim() < 1:
        raise ValueError("pipelined_all_gather: x needs a leading dim")
    pod, intra = cfg.pod_group, cfg.intra_group
    if pod is None:
        return primitives.hom_all_gather(x, intra)
    n = primitives.axis_size(pod)
    my = dist.get_rank(pod)
    gathered, cur = [], x
    for j in range(n):
        nxt = primitives.shift([cur], pod)[0] if j < n - 1 else None   # hop (shard j+1)
        gathered.append(primitives.hom_all_gather(cur, intra))          # Bcast (shard j)
        cur = nxt
    # slot j holds pod (my - j) % n: realign to absolute order
    return torch.cat([gathered[(my - i) % n] for i in range(n)])
