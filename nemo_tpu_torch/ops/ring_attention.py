"""Ring attention for context parallelism (CP): the counterpart of
nemo_tpu/ops/ring_attention.py's `ring_flash_attention` (120) and its
zig-zag helpers (99-117).

The sequence of a batch is cut into `cp` shards of Tl = S / cp tokens, one
a rank. Each rank keeps its query shard and passes its key/value shard
around the ring: at each of the cp steps it runs the positions flash kernel
(`ops/flash_attention.py:flash_attention_positions`, K11) of its queries
against the K/V shard in hand, merges the step's (o, lse) into its running
one exactly (a logaddexp of the lse and the two weights, ring_attention.py:
159-163), and hands the shard on. Zig-zag balancing gives rank r the chunks
(r, 2cp-1-r) of 2cp, so that every rank has the same causal work; the
positions carry the global order, so the masks stay right.

The ring is written once, over a transport that holds some of the ranks in
this process, each tensor with a leading dim of those ranks:

- `ProcessGroupRing(group)`: one rank a process (the users' path, one
  process a card over a `torch.distributed` group, NCCL on cards and gloo
  on the CPU); `shift` sends to rank + 1 and receives from rank - 1.
- `LocalRing(cp)`: all cp ranks in one process; `shift` rolls the leading
  dim by one. On one card it does exactly the per-rank work of cp cards
  (the same kernel shapes, steps and merges), as `shard_map` over virtual
  devices does for the JAX package's tests.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from nemo_tpu_torch.ops.flash_attention import (_device, flash_pos_dkv, flash_pos_dq,
                                                pos_tile_ranges, positions_forward, row_delta)


def zigzag_chunk_ids(cp: int) -> np.ndarray:
    """[cp, 2]: rank r gets chunks (r, 2cp-1-r) of 2cp (ring_attention.py:99)."""
    return np.stack([np.arange(cp), 2 * cp - 1 - np.arange(cp)], axis=1)


def zigzag_order(S: int, cp: int) -> np.ndarray:
    """[S] int: the global positions of a sequence of S tokens in zig-zag
    order, whose contiguous cp shards are the ranks' chunk pairs."""
    clen = S // (2 * cp)
    return np.concatenate([np.arange(i * clen, (i + 1) * clen)
                           for i in zigzag_chunk_ids(cp).reshape(-1)])


def zigzag_shard(x: torch.Tensor, cp: int, seq_axis: int = 1) -> torch.Tensor:
    """A global sequence reordered so that contiguous cp shards are the
    zig-zag chunk pairs (ring_attention.py:105)."""
    chunks = torch.chunk(x, 2 * cp, dim=seq_axis)
    return torch.cat([chunks[i] for i in zigzag_chunk_ids(cp).reshape(-1)], dim=seq_axis)


def zigzag_unshard(x: torch.Tensor, cp: int, seq_axis: int = 1) -> torch.Tensor:
    """The inverse of `zigzag_shard` (ring_attention.py:113)."""
    chunks = torch.chunk(x, 2 * cp, dim=seq_axis)
    inv = np.argsort(zigzag_chunk_ids(cp).reshape(-1))
    return torch.cat([chunks[i] for i in inv], dim=seq_axis)


class LocalRing:
    """All `size` ranks of a ring in this process: `rank` 0 is the first
    held, `held` = size, and `shift` rolls the leading (rank) dim by one, so
    that rank r receives what rank r - 1 held."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"LocalRing: size {size} < 1")
        self.size, self.rank, self.held = size, 0, size

    def shift(self, *tensors: torch.Tensor):
        return [torch.roll(t, 1, 0) for t in tensors]


class ProcessGroupRing:
    """One rank of a ring over a `torch.distributed` process group: `held`
    = 1, and `shift` sends each tensor to rank + 1 and receives rank - 1's
    with one `batch_isend_irecv` (NCCL on cards, gloo on the CPU). The
    group must already be initialised."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.held = 1
        self._next = dist.get_global_rank(group, (self.rank + 1) % self.size)
        self._prev = dist.get_global_rank(group, (self.rank - 1) % self.size)

    def shift(self, *tensors: torch.Tensor):
        if self.size == 1:
            return list(tensors)
        sends = [t.contiguous() for t in tensors]
        outs = [torch.empty_like(t) for t in sends]
        ops = []
        for t, o in zip(sends, outs):
            ops.append(dist.P2POp(dist.isend, t, self._next, self.group))
            ops.append(dist.P2POp(dist.irecv, o, self._prev, self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return outs


def _merge(o, lse, o_i, lse_i):
    """Merge a ring step's (o_i, lse_i) into the running (o fp32 [B, T, H,
    dh], lse [B, H, T]) in place, as ring_attention.py:159-163 does."""
    lse_new = torch.logaddexp(lse, lse_i)
    w_prev = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_i - lse_new).transpose(1, 2)[..., None]
    o.mul_(w_prev).add_(o_i.float() * w_new)
    lse.copy_(lse_new)


class RingFlashAttention(torch.autograd.Function):
    """The whole ring as one autograd Function.

    Forward: cp steps of K11 per held rank (`positions_forward`), each
    merged into the running (o, lse); the K/V shards, their positions and
    their tile ranges are passed on between steps. Saved: q, k, v, the
    positions, the output and the final lse, not the cp steps' partials.

    Backward: the K/V shards go round the ring again, now with their dk/dv
    partials (fp32), so that after cp shifts each partial has reached the
    rank that owns the shard. Each step runs K12 and K13 with the FINAL lse
    and delta = rowsum(dO∘O): a step's probabilities against the final lse,
    exp(s − lse), are exp(s − lse_i)·exp(lse_i − lse), the step's own
    probabilities times its merge weight, so this is the function that JAX's
    autodiff of the scan computes (through the merges and each step's lse
    cotangent), taken in FlashAttention-2's form: no per-step o, lse or K/V
    copies are kept."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, ring, scale, causal, window, qranges):
        R = q.shape[0]
        kb, vb = k.transpose(2, 3), v.transpose(2, 3)  # [R, B, Tl, G, dh]: the kernels' layout
        qpos = qpos.to(torch.int32)
        if qranges is None:
            qranges = torch.stack([pos_tile_ranges(p) for p in qpos])
        o = lse = None
        shard = (kb, vb, qpos, qranges)
        for step in range(ring.size):
            k_i, v_i, kpos_i, kr_i = shard
            outs = [positions_forward(q[r], k_i[r].transpose(1, 2),
                                      v_i[r].transpose(1, 2), qpos[r], kpos_i[r], scale, causal,
                                      window, (qranges[r], kr_i[r])) for r in range(R)]
            if step == 0:  # the merge into (0, -1e30) gives the first step's values exactly
                o = torch.stack([x.float() for x, _ in outs])
                lse = torch.stack([x for _, x in outs])
            else:
                for r, (o_i, lse_i) in enumerate(outs):
                    _merge(o[r], lse[r], o_i, lse_i)
            if step + 1 < ring.size:
                shard = ring.shift(*shard)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, qpos, qranges, o, lse)
        ctx.ring, ctx.args = ring, (scale, causal, window)
        return o.transpose(2, 3)

    @staticmethod
    def backward(ctx, do):
        q, k, v, qpos, qranges, o, lse = ctx.saved_tensors
        ring, (scale, causal, window) = ctx.ring, ctx.args
        R = q.shape[0]
        do = do.to(q.dtype)
        delta = row_delta(o.transpose(2, 3), do)  # [R, B, H, Tl]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kb, vb = k.transpose(2, 3), v.transpose(2, 3)
        dkb = torch.zeros(kb.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros_like(dkb)
        shard = (kb, vb, qpos, qranges, dkb, dvb)
        for step in range(ring.size):
            k_i, v_i, kpos_i, kr_i, dk_i, dv_i = shard
            for r in range(R):
                args = (q[r], k_i[r].transpose(1, 2), v_i[r].transpose(1, 2), qpos[r],
                        kpos_i[r], scale, causal, window, lse[r], delta[r], do[r])
                ranges = (qranges[r], kr_i[r])
                dq[r] += flash_pos_dq(*args, ranges=ranges)
                dk, dv = flash_pos_dkv(*args, ranges=ranges)
                dk_i[r] += dk.transpose(1, 2)
                dv_i[r] += dv.transpose(1, 2)
            if step + 1 < ring.size:
                shard = ring.shift(*shard)
            else:  # the partials' last hop home
                dk_i, dv_i = ring.shift(dk_i, dv_i)
        return (dq.to(q.dtype), dk_i.transpose(2, 3).to(k.dtype),
                dv_i.transpose(2, 3).to(v.dtype), None, None, None, None, None, None)


def ring_flash_attention(
    q: torch.Tensor,  # [R, B, H, Tl, dh]: the query shards of the R ranks this process holds
    k: torch.Tensor,  # [R, B, G, Tl, dh]
    v: torch.Tensor,  # [R, B, G, Tl, dh]
    qpos: torch.Tensor,  # [R, Tl] integer global positions of each rank's rows
    ring,  # LocalRing or ProcessGroupRing, with ring.held == R
    *,
    scale: float,
    causal: bool = True,
    window: Optional[int] = None,
    qranges: Optional[torch.Tensor] = None,  # [R, Tl / 64, 2] tile ranges of qpos (pre-pass)
) -> torch.Tensor:
    """→ o [R, B, H, Tl, dh] in q's dtype, differentiable in q, k and v: the
    counterpart of nemo_tpu/ops/ring_attention.py:ring_flash_attention (120)
    inside `shard_map` over the cp axis, each rank's K/V positions those of
    its queries. CPU tensors take the positions kernel's plain version;
    CUDA tensors launch K11 (forward) and K12, K13 (backward), once a held
    rank a ring step, or raise."""
    if q.dim() != 5 or q.shape[0] != ring.held or qpos.shape != (ring.held, q.shape[3]):
        raise ValueError(f"ring_flash_attention: q must be [{ring.held}, B, H, Tl, dh] and "
                         f"qpos [{ring.held}, Tl]")
    _device("ring_flash_attention", q)
    return RingFlashAttention.apply(q, k, v, qpos, ring, float(scale), bool(causal), window,
                                    qranges)
