"""Flash attention on the card: the rel-pos form of the Conformer (K1, K3,
K4), the causal GQA form of the LLM (K5, K6, K7), its form over packed rows
with segment ids (K8, K9, K10) and its form with explicit positions (K11,
K12, K13), each with its plain version.

**Rel-pos form.** Counterpart of nemo_tpu/ops/flash_attention.py:flash_attention
(`_fwd_kernel`, and through its custom_vjp `_dq_kernel` and `_dkv_kernel`) as
nemo_tpu/ops/attention.py:_relpos_flash calls it: non-causal attention with
the Transformer-XL rel-pos term and key padding,

    s[i, j] = scale * (qu_i . k_j + qv_i . p_{(T-1)-i+j}),  masked for j >= len_b,

returning o [B, H, T, dh] and lse [B, H, T] (fp32). The CUDA kernels are
`csrc/relpos_flash.cu` (K1) and `csrc/relpos_flash_bwd.cu` (K3, K4); their
notes give the designs and what bounds them.

`relpos_flash_attention` is differentiable (`RelposFlashAttention`): its
backward is `relpos_flash_attention_backward`, which launches K3 and K4 for
CUDA tensors and runs `relpos_flash_attention_backward_plain` for CPU tensors.
Padded query rows (i >= len_b) hold values that callers must not read as
results.

**Causal GQA form.** `flash_attention(q, k, v, scale, causal, window)` is the
counterpart of the same JAX function as nemo_tpu/models/llm/gpt.py:642 calls
it: q [B, H, T, dh], k and v [B, G, T, dh] (head h reads kv head h*G/H), a
causal and an optional sliding-window mask, dh 64, 96 (Phi-3-mini) or 128. It is
differentiable (`FlashAttention`): the forward is K5 (`csrc/flash_fwd.cu`),
the backward K6 (dq) and K7 (dk, dv summed over each group's heads;
`csrc/flash_bwd.cu`); CPU tensors take `flash_attention_plain` and
`flash_attention_backward_plain`.

**Packed form.** `flash_attention_packed(q, k, v, segments, scale, causal,
window)` is the counterpart of nemo_tpu/ops/flash_attention.py:
flash_attention_packed (1123) as gpt.py:648 calls it for packed SFT batches:
the causal GQA form restricted to (query, key) pairs whose segment ids
(`segments` [B, T], 0 = padding) are equal and nonzero. A padding row keeps
no key: o = 0 and lse = -1e30. It is differentiable
(`FlashAttentionPacked`): the forward is K8 (`csrc/flash_fwd.cu`, K5's kernel
with segments on), the backward K9 (`flash_seg_dq`) and K10 (`flash_seg_dkv`,
`csrc/flash_bwd.cu`); CPU tensors take `flash_attention_packed_plain` and
`flash_attention_packed_backward_plain`.

**Positions form.** `flash_attention_positions(q, k, v, qpos, kpos, scale,
causal, window)` is the counterpart of nemo_tpu/ops/flash_attention.py:
flash_attention_positions (733), the inner step of ring attention: Tq rows
against Tkv keys, pair (i, j) kept where kpos[j] <= qpos[i] (causal) and
kpos[j] > qpos[i] - window, with qpos [Tq] and kpos [Tkv] shared by the
batch. It returns (o, lse); a row that keeps no key gets o = 0 and lse =
-1e30. It is differentiable in q, k and v through both outputs
(`FlashAttentionPositions`): the forward is K11 (`csrc/flash_fwd.cu`, K5's
kernel with positions on), the backward K12 (`flash_pos_dq`) and K13
(`flash_pos_dkv`, `csrc/flash_bwd.cu`) with delta' = rowsum(dO∘O) − g_lse;
CPU tensors take `flash_attention_positions_plain` and
`flash_attention_positions_backward_plain`. `flash_attention(q_offset != 0)`
runs through it.

Every wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain version only for CPU tensors; each counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] raw q·p scores → [B, H, T, T] with
    out[..., i, j] = x[..., i, T-1-i+j] (relative distance i-j)."""
    B, H, T, L = x.shape
    x = torch.nn.functional.pad(x, (1, 0))  # [B, H, T, 2T]
    x = x.reshape(B, H, 2 * T, T)[:, :, 1:, :].reshape(B, H, T, L)
    return x[:, :, :, :T]


def rel_unshift(x: torch.Tensor) -> torch.Tensor:
    """The adjoint of `rel_shift`: [B, H, T, T] → [B, H, T, 2T-1] with
    out[..., i, T-1-i+j] = x[..., i, j] and zeros elsewhere."""
    B, H, T, _ = x.shape
    i = torch.arange(T, device=x.device)
    idx = (T - 1 - i[:, None] + i[None, :]).expand(B, H, T, T)
    return x.new_zeros(B, H, T, 2 * T - 1).scatter_(-1, idx, x)


def _scores(qu, qv, k, p, lengths, scale) -> torch.Tensor:
    """Masked fp32 scores [B, H, T, T]."""
    f32 = torch.float32
    T = qu.shape[2]
    ac = torch.einsum("bhid,bhjd->bhij", qu.to(f32), k.to(f32))
    bd = rel_shift(torch.einsum("bhid,hrd->bhir", qv.to(f32), p.to(f32)))
    s = (ac + bd) * scale
    keep = torch.arange(T, device=qu.device)[None, :] < lengths.to(qu.device)[:, None]
    return torch.where(keep[:, None, None, :], s, torch.full_like(s, NEG_INF))


def relpos_flash_attention_plain(
    qu: torch.Tensor, qv: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    p: torch.Tensor, lengths: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: the same function, computed with dense
    [B, H, T, T] scores in fp32. Shapes as `relpos_flash_attention`."""
    s = _scores(qu, qv, k, p, lengths, scale)
    lse = torch.logsumexp(s, dim=-1)
    probs = torch.exp(s - lse[..., None])
    o = torch.einsum("bhij,bhjd->bhid", probs, v.to(torch.float32))
    return o.to(qu.dtype), lse


def row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """δ = rowsum(dO ∘ O) in fp32 [B, H, T], from the stored output, as
    nemo_tpu/ops/flash_attention.py:_flash_backward computes it outside its
    kernels."""
    return (do.to(torch.float32) * o.to(torch.float32)).sum(-1)


def _backward_plain(qu, qv, k, v, p, lengths, scale, lse, delta, do):
    f32 = torch.float32
    probs = torch.exp(_scores(qu, qv, k, p, lengths, scale) - lse[..., None])  # 0 on masked keys
    dprobs = torch.einsum("bhid,bhjd->bhij", do.to(f32), v.to(f32))
    ds = probs * (dprobs - delta[..., None]) * scale
    band = rel_unshift(ds)  # [B, H, T, 2T-1]: dS at each score's rel-pos row
    dqu = torch.einsum("bhij,bhjd->bhid", ds, k.to(f32))
    dqv = torch.einsum("bhir,hrd->bhid", band, p.to(f32))
    dk = torch.einsum("bhij,bhid->bhjd", ds, qu.to(f32))
    dv = torch.einsum("bhij,bhid->bhjd", probs, do.to(f32))
    dp = torch.einsum("bhir,bhid->hrd", band, qv.to(f32))
    return (dqu.to(qu.dtype), dqv.to(qv.dtype), dk.to(k.dtype), dv.to(v.dtype), dp.to(p.dtype))


def relpos_flash_attention_backward_plain(
    qu: torch.Tensor, qv: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
    lengths: torch.Tensor, scale: float, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K3 and K4: (dqu, dqv, dk, dv, dp), the dense
    FlashAttention-2 backward in fp32 (shapes of the inputs):

        δ = rowsum(dO∘O);  P = exp(s − lse), 0 on masked keys
        dS = P∘(dO·vᵀ − δ)·scale
        dqu = dS·k;  dk = dSᵀ·qu;  dv = Pᵀ·dO
        dqv_i = Σ_j dS_ij p_{T−1−i+j};  dp_r = Σ_{b,i,j: T−1−i+j=r} dS_ij qv_i

    It differs from the bf16 kernels (and from the JAX kernels,
    flash_attention.py:248,291,299) in one place: those round P and dS to the
    input dtype before each product; here every product is fp32."""
    return _backward_plain(qu, qv, k, v, p, lengths, scale, lse, row_delta(o, do), do)


def _check(what: str, qu, qv, k, v, p, lengths) -> None:
    B, H, T, dh = qu.shape
    dtype = qu.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {dtype} not supported")
    if dh not in (64, 128):
        raise ValueError(f"{what}: head dim {dh} is neither 64 nor 128")
    for name, t in (("qv", qv), ("k", k), ("v", v)):
        if t.shape != qu.shape or t.dtype != dtype or t.device != qu.device:
            raise ValueError(f"{what}: {name} does not match qu")
    if p.shape != (H, 2 * T - 1, dh) or p.dtype != dtype or p.device != qu.device:
        raise ValueError(f"{what}: p must be [{H}, {2 * T - 1}, {dh}] {dtype}")
    if lengths.shape != (B,):
        raise ValueError(f"{what}: lengths must be [B]")


def _bthd(what: str, tensors):
    """[B, H, T, dh] views → contiguous [B, T, H, dh] (no copy for a view of
    the Linear outputs); bf16 tensors must be 16-byte aligned."""
    out = [t.transpose(1, 2).contiguous() for t in tensors]
    if out[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in out):
        raise ValueError(f"{what}: bf16 tensors must be 16-byte aligned")
    return out


def _p_rhd(what: str, p: torch.Tensor) -> torch.Tensor:
    p_rhd = p.transpose(0, 1).contiguous()
    if p_rhd.dtype == torch.bfloat16 and p_rhd.data_ptr() % 16:
        raise ValueError(f"{what}: bf16 tensors must be 16-byte aligned")
    return p_rhd


def _device(what: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def _k1_launch(qu, qv, k, v, p, lengths, scale):
    """K1 → (o [B, T, H, dh], lse [B, H, T] fp32)."""
    what = "relpos_flash_attention"
    _check(what, qu, qv, k, v, p, lengths)
    B, H, T, dh = qu.shape
    dtype = qu.dtype
    bthd = _bthd(what, (qu, qv, k, v))
    p_rhd = _p_rhd(what, p)
    lens = lengths.to(device=qu.device, dtype=torch.int32).contiguous()
    o = torch.empty((B, T, H, dh), dtype=dtype, device=qu.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=qu.device)
    err = _lib().relpos_flash_fwd(
        _DTYPES[dtype], *(t.data_ptr() for t in bthd), p_rhd.data_ptr(), lens.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, H, T, dh, float(scale),
        torch.cuda.current_stream(qu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"relpos_flash_attention: CUDA error {err} at launch")
    relpos_flash_attention.launches += 1
    return o, lse


class RelposFlashAttention(torch.autograd.Function):
    """K1 with its backward. Forward: o and lse (lse is not differentiable);
    backward: `relpos_flash_attention_backward` (K3 + K4 on the card, the
    plain backward on the CPU). Works in [B, T, H, dh] for o."""

    @staticmethod
    def forward(ctx, qu, qv, k, v, p, lengths, scale):
        if _device("relpos_flash_attention", qu) == "cpu":
            o, lse = relpos_flash_attention_plain(qu, qv, k, v, p, lengths, scale)
            o = o.transpose(1, 2).contiguous()
        else:
            o, lse = _k1_launch(qu, qv, k, v, p, lengths, scale)
        ctx.save_for_backward(qu, qv, k, v, p, lengths, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qu, qv, k, v, p, lengths, o, lse = ctx.saved_tensors
        grads = relpos_flash_attention_backward(
            qu, qv, k, v, p, lengths, ctx.scale, o.transpose(1, 2), lse,
            do.to(qu.dtype).transpose(1, 2))
        return (*grads, None, None)


def relpos_flash_attention(
    qu: torch.Tensor,  # [B, H, T, dh] = q + pos_bias_u
    qv: torch.Tensor,  # [B, H, T, dh] = q + pos_bias_v
    k: torch.Tensor,  # [B, H, T, dh]
    v: torch.Tensor,  # [B, H, T, dh]
    p: torch.Tensor,  # [H, 2T-1, dh] projected rel-pos table (positions T-1 .. -(T-1))
    lengths: torch.Tensor,  # [B] int valid keys per row (>= 1)
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (o [B, H, T, dh] in qu's dtype, lse [B, H, T] fp32), differentiable
    in qu, qv, k, v and p.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (fp32, or bf16 at 16-byte aligned addresses; dh 64 or 128) or raise. The
    kernel reads qu/qv/k/v in the [B, T, H, dh] layout (a view of the Linear
    outputs needs no copy) and writes o in that layout too."""
    o, lse = RelposFlashAttention.apply(qu, qv, k, v, p, lengths, scale)
    return o.transpose(1, 2), lse


relpos_flash_attention.launches = 0


def relpos_flash_dq(qu, qv, k, v, p, lengths, scale, lse, delta, do):
    """K3 → (dqu, dqv) [B, H, T, dh]; `delta` is `row_delta(o, do)`. Inputs
    as `relpos_flash_attention`, plus lse and delta [B, H, T] fp32 and do
    [B, H, T, dh] in qu's dtype. CPU tensors take the plain backward."""
    if _device("relpos_flash_dq", qu) == "cpu":
        return _backward_plain(qu, qv, k, v, p, lengths, scale, lse, delta, do)[:2]
    outs = _bwd_launch("relpos_flash_bwd_dq", qu, qv, k, v, p, lengths, scale, lse, delta, do,
                       n_out=2)
    relpos_flash_dq.launches += 1
    return tuple(t.transpose(1, 2) for t in outs)


relpos_flash_dq.launches = 0


def relpos_flash_dkv(qu, qv, k, v, p, lengths, scale, lse, delta, do):
    """K4 → (dk, dv [B, H, T, dh], dp [H, 2T-1, dh]); arguments as
    `relpos_flash_dq`. dp is summed over the batch in fp32 across blocks (in
    bf16 by TMA reductions, plus atomics for the one chunk a (b, h) that
    starts before p's first row, where T is no multiple of 64; in fp32 by
    atomics), so its last bits change from run to run; dk and dv do not. CPU
    tensors take the plain backward."""
    if _device("relpos_flash_dkv", qu) == "cpu":
        return _backward_plain(qu, qv, k, v, p, lengths, scale, lse, delta, do)[2:]
    dk, dv, dp32 = _bwd_launch("relpos_flash_bwd_dkv", qu, qv, k, v, p, lengths, scale, lse,
                               delta, do, n_out=3)
    relpos_flash_dkv.launches += 1
    return dk.transpose(1, 2), dv.transpose(1, 2), dp32.to(p.dtype).transpose(0, 1)


relpos_flash_dkv.launches = 0


def _bwd_launch(fn: str, qu, qv, k, v, p, lengths, scale, lse, delta, do, n_out: int):
    """Launch K3 (n_out 2: dqu, dqv [B, T, H, dh]) or K4 (n_out 3: dk, dv
    [B, T, H, dh] and dp [2T-1, H, dh] fp32)."""
    _check(fn, qu, qv, k, v, p, lengths)
    B, H, T, dh = qu.shape
    dtype = qu.dtype
    if do.shape != qu.shape or do.dtype != dtype:
        raise ValueError(f"{fn}: do must match qu")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, T) or t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be [B, H, T] float32")
    bthd = _bthd(fn, (qu, qv, k, v, do))
    p_rhd = _p_rhd(fn, p)
    lens = lengths.to(device=qu.device, dtype=torch.int32).contiguous()
    outs = [torch.empty((B, T, H, dh), dtype=dtype, device=qu.device) for _ in range(2)]
    if n_out == 3:  # dp, summed into across blocks
        outs.append(torch.zeros((2 * T - 1, H, dh), dtype=torch.float32, device=qu.device))
    err = getattr(_lib("relpos_flash_bwd"), fn)(
        _DTYPES[dtype], *(t.data_ptr() for t in bthd[:4]), p_rhd.data_ptr(), bthd[4].data_ptr(),
        lse.contiguous().data_ptr(), delta.contiguous().data_ptr(), lens.data_ptr(),
        *(t.data_ptr() for t in outs), B, H, T, dh, float(scale),
        torch.cuda.current_stream(qu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
    return outs


def relpos_flash_attention_backward(
    qu: torch.Tensor, qv: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
    lengths: torch.Tensor, scale: float, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """(dqu, dqv, dk, dv, dp) of `relpos_flash_attention` for the output
    cotangent do: K3 and K4 for CUDA tensors, the plain backward for CPU
    tensors."""
    if _device("relpos_flash_attention_backward", qu) == "cpu":
        return relpos_flash_attention_backward_plain(qu, qv, k, v, p, lengths, scale, o, lse, do)
    delta = row_delta(o, do)
    args = (qu, qv, k, v, p, lengths, scale, lse, delta, do)
    return (*relpos_flash_dq(*args), *relpos_flash_dkv(*args))


def _lib(name: str = "relpos_flash") -> ctypes.CDLL:
    """The forward (K1, `relpos_flash`) or backward (K3 + K4,
    `relpos_flash_bwd`) kernel library, with its C signatures set."""
    from nemo_tpu_torch.csrc.loader import library

    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = library(name)
    if name == "relpos_flash":
        sigs = {"relpos_flash_fwd": [ci] + [vp] * 8}
    else:  # dtype, 5 inputs, p, do, lse, delta, lengths, outputs
        sigs = {"relpos_flash_bwd_dq": [ci] + [vp] * 11, "relpos_flash_bwd_dkv": [ci] + [vp] * 12}
    for fn_name, head in sigs.items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = head + [ci, ci, ci, ci, ctypes.c_float, vp]
            fn.restype = ci
    return lib


def relpos_kernel_shape(kernel: str, head_dim: int) -> dict:
    """The launch shape of the bf16 K1 (`kernel` "fwd"), K3 ("dq") or K4
    ("dkv") at head_dim 64 or 128, from its library on the card: threads a
    block, consumer warpgroups, blocks a cluster, dynamic shared-memory bytes, and
    `cudaFuncGetAttributes`' registers a thread (at launch, before setmaxnreg
    moves them between warpgroups) and local-memory bytes a thread (spills)."""
    name, fn = {"fwd": ("relpos_flash", "relpos_flash_fwd_shape"),
                "dq": ("relpos_flash_bwd", "relpos_flash_bwd_dq_shape"),
                "dkv": ("relpos_flash_bwd", "relpos_flash_bwd_dkv_shape")}[kernel]
    out = (ctypes.c_int * 6)()
    err = getattr(_lib(name), fn)(ctypes.c_int(head_dim), out)
    if err != 0:
        raise RuntimeError(f"relpos_kernel_shape({kernel!r}, {head_dim}): CUDA error {err}")
    keys = ("threads", "warpgroups", "cluster", "shared_bytes", "registers", "local_bytes")
    return dict(zip(keys, out))


# --------------------------------------------------------------------------
# causal GQA flash attention: K5 (forward), K6 (dq), K7 (dk, dv)
# --------------------------------------------------------------------------


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float, causal: bool,
                window, segments=None, qpos=None, kpos=None) -> torch.Tensor:
    """Masked fp32 scores [B, G, H/G, Tq, Tk] of q [B, H, Tq, dh] against k
    [B, G, Tk, dh], as nemo_tpu/ops/flash_attention.py:_xla_reference builds
    them; with `segments` [B, T] also masked to pairs of equal nonzero ids
    (_seg_mask); with `qpos` [Tq] and `kpos` [Tk] the causal and window
    masks compare those positions (_pos_mask) instead of 0 .. T-1."""
    B, H, Tq, dh = q.shape
    G, Tk = k.shape[1], k.shape[2]
    qg = q.reshape(B, G, H // G, Tq, dh).float()
    s = torch.einsum("bgrid,bgjd->bgrij", qg, k.float()) * scale
    qpos = (torch.arange(Tq, device=q.device) if qpos is None else qpos.to(q.device))[:, None]
    kpos = (torch.arange(Tk, device=q.device) if kpos is None else kpos.to(q.device))[None, :]
    keep = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    if segments is not None:
        seg = segments.to(q.device)
        keep = (keep & (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0))[:, None, None]
    return s.masked_fill(~keep, NEG_INF)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                          causal: bool = True, window=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5, the counterpart of `_xla_reference`
    (flash_attention.py:410): dense fp32 GQA scores, the causal and window
    mask at -1e30, softmax, then (o [B, H, T, dh] in q's dtype, lse [B, H, T]
    fp32). Shapes as `flash_attention`."""
    B, H, T, dh = q.shape
    s = _gqa_scores(q, k, scale, causal, window)
    lse = torch.logsumexp(s, dim=-1)
    probs = torch.exp(s - lse[..., None])
    o = torch.einsum("bgrij,bgjd->bgrid", probs, v.float())
    return o.reshape(B, H, T, dh).to(q.dtype), lse.reshape(B, H, T)


def _flash_backward_plain(q, k, v, scale, causal, window, lse, delta, do, segments=None,
                          qpos=None, kpos=None):
    B, H, T, dh = q.shape
    G = k.shape[1]
    rows = (B, G, H // G, T)
    lse_r = lse.reshape(rows)[..., None]
    # 0 on masked pairs
    probs = torch.exp(_gqa_scores(q, k, scale, causal, window, segments, qpos, kpos) - lse_r)
    if segments is not None or qpos is not None:
        # a row that keeps no key (lse = -1e30) keeps no pair, not exp(0)
        probs = probs.masked_fill(lse_r <= NEG_INF / 2, 0.0)
    dog = do.reshape(*rows, dh).float()
    dprobs = torch.einsum("bgrid,bgjd->bgrij", dog, v.float())
    ds = probs * (dprobs - delta.reshape(rows)[..., None]) * scale
    dq = torch.einsum("bgrij,bgjd->bgrid", ds, k.float()).reshape(B, H, T, dh)
    dk = torch.einsum("bgrij,bgrid->bgjd", ds, q.reshape(*rows, dh).float())
    dv = torch.einsum("bgrij,bgrid->bgjd", probs, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, causal: bool, window,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6 and K7: (dq, dk, dv), the dense
    FlashAttention-2 backward in fp32 (flash_attention.py:318), dk and dv
    summed over the query heads of each kv group:

        δ = rowsum(dO∘O);  P = exp(s − lse), 0 on masked pairs
        dS = P∘(dO·vᵀ − δ)·scale;  dq = dS·k;  dk = Σ_group dSᵀ·q;  dv = Σ_group Pᵀ·dO

    The bf16 kernels (and the JAX kernels, flash_attention.py:248,291,299)
    round P and dS to the input dtype before each product; here every
    product is fp32."""
    return _flash_backward_plain(q, k, v, scale, causal, window, lse, row_delta(o, do), do)


def _flash_check(what: str, q, k, v, window, same_length: bool = True) -> None:
    """What the kernels take: fp32 or bf16; q [B, H, T, dh] and k, v
    [B, G, T, dh] (any Tkv with `same_length` False) on one device, G
    dividing H, dh 64, 96 or 128, window >= 1."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {q.dtype} not supported")
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be [B, H, T, dh]")
    B, H, T, dh = q.shape
    if dh not in (64, 96, 128):
        raise ValueError(f"{what}: head dim {dh} not in (64, 96, 128)")
    Tk = T if same_length else "Tkv"
    if (k.dim() != 4 or (k.shape[0], k.shape[3]) != (B, dh) or H % k.shape[1]
            or (same_length and k.shape[2] != T)):
        raise ValueError(f"{what}: k must be [{B}, G, {Tk}, {dh}] with G dividing {H}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != k.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: {name} does not match k and q")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window {window} < 1")


def _k5_launch(q, k, v, scale, causal, window):
    """K5 → (o [B, T, H, dh], lse [B, H, T] fp32)."""
    what = "flash_attention"
    _flash_check(what, q, k, v, window)
    B, H, T, dh = q.shape
    qt, kt, vt = _bthd(what, (q, k, v))
    o = torch.empty((B, T, H, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    err = _flash_lib("flash_fwd").flash_fwd(
        _DTYPES[q.dtype], qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, H, k.shape[1], T, dh, float(scale), int(causal), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
    flash_attention.launches += 1
    return o, lse


class FlashAttention(torch.autograd.Function):
    """K5 with its backward. Forward: o [B, T, H, dh] and lse (not
    differentiable); backward: `flash_attention_backward` (K6 + K7 on the
    card, the plain backward on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        if _device("flash_attention", q) == "cpu":
            o, lse = flash_attention_plain(q, k, v, scale, causal, window)
            o = o.transpose(1, 2).contiguous()
        else:
            o, lse = _k5_launch(q, k, v, scale, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, causal, window)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        grads = flash_attention_backward(q, k, v, *ctx.args, o.transpose(1, 2), lse,
                                         do.to(q.dtype).transpose(1, 2))
        return (*grads, None, None, None)


def flash_attention(
    q: torch.Tensor,  # [B, H, T, dh]
    k: torch.Tensor,  # [B, G, T, dh], G dividing H
    v: torch.Tensor,  # [B, G, T, dh]
    scale: float,
    causal: bool = True,
    window=None,  # sliding window: key j is seen by query i only if j > i - window
    q_offset: int = 0,
) -> torch.Tensor:
    """→ o [B, H, T, dh] in q's dtype, differentiable in q, k and v: the
    counterpart of nemo_tpu/ops/flash_attention.py:flash_attention (430).

    CPU tensors take the plain version; CUDA tensors launch K5 (fp32, or bf16
    at 16-byte aligned addresses; dh 64, 96 or 128) or raise. The kernel reads
    q/k/v in the [B, T, heads, dh] layout (a view of the Linear outputs needs
    no copy) and writes o in that layout too. With `q_offset` != 0 (the
    queries placed after a prefix of keys: q [B, H, Tq, dh] against k, v
    [B, G, Tkv, dh]) it is `flash_attention_positions` with qpos = q_offset +
    0 .. Tq-1 and kpos = 0 .. Tkv-1, the mask of _mask_block with its offset
    (K11-K13 on the card; Tq and Tkv multiples of 64 there)."""
    if q_offset:
        qpos = torch.arange(q.shape[2], dtype=torch.int32, device=q.device) + int(q_offset)
        kpos = torch.arange(k.shape[2], dtype=torch.int32, device=q.device)
        o, _ = flash_attention_positions(q, k, v, qpos, kpos, scale, causal, window)
        return o
    o, _ = FlashAttention.apply(q, k, v, float(scale), bool(causal), window)
    return o.transpose(1, 2)


flash_attention.launches = 0


def flash_dq(q, k, v, scale, causal, window, lse, delta, do):
    """K6 → dq [B, H, T, dh]; `delta` is `row_delta(o, do)`. Inputs as
    `flash_attention`, plus lse and delta [B, H, T] fp32 and do [B, H, T, dh]
    in q's dtype. CPU tensors take the plain backward."""
    if _device("flash_dq", q) == "cpu":
        return _flash_backward_plain(q, k, v, scale, causal, window, lse, delta, do)[0]
    (dq,) = _flash_bwd_launch("flash_bwd_dq", q, k, v, scale, causal, window, lse, delta, do)
    flash_dq.launches += 1
    return dq.transpose(1, 2)


flash_dq.launches = 0


def flash_dkv(q, k, v, scale, causal, window, lse, delta, do):
    """K7 → (dk, dv) [B, G, T, dh], each summed over the H/G query heads of
    its kv head; arguments as `flash_dq`. CPU tensors take the plain
    backward."""
    if _device("flash_dkv", q) == "cpu":
        return _flash_backward_plain(q, k, v, scale, causal, window, lse, delta, do)[1:]
    dk, dv = _flash_bwd_launch("flash_bwd_dkv", q, k, v, scale, causal, window, lse, delta, do)
    flash_dkv.launches += 1
    return dk.transpose(1, 2), dv.transpose(1, 2)


flash_dkv.launches = 0


def _flash_bwd_launch(fn: str, q, k, v, scale, causal, window, lse, delta, do, segments=None,
                      ranges=None):
    """Launch K6 or K9 (→ dq [B, T, H, dh]), K7 or K10 (→ dk, dv [B, T, G,
    dh]); K9 and K10 (`flash_seg_bwd_*`) take the segments and their tile
    ranges (computed here where not given)."""
    _flash_check(fn, q, k, v, window)
    B, H, T, dh = q.shape
    G = k.shape[1]
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{fn}: do must match q")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, T) or t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be [B, H, T] float32")
    qt, kt, vt, dot = _bthd(fn, (q, k, v, do))
    lse_c, delta_c = lse.contiguous(), delta.contiguous()
    seg_ptrs = []
    if fn.startswith("flash_seg"):
        seg = _seg_check(fn, q, segments)
        ranges = _ranges_check(fn, q, seg_tile_ranges(seg) if ranges is None else ranges)
        seg_ptrs = [seg.data_ptr(), ranges.data_ptr()]
    dq_side = fn.endswith("_dq")
    outs = [torch.empty((B, T, H if dq_side else G, dh), dtype=q.dtype, device=q.device)
            for _ in range(1 if dq_side else 2)]
    err = getattr(_flash_lib("flash_bwd"), fn)(
        _DTYPES[q.dtype], qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), dot.data_ptr(),
        lse_c.data_ptr(), delta_c.data_ptr(), *seg_ptrs, *(t.data_ptr() for t in outs), B, H, G,
        T, dh, float(scale), int(causal), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
    return outs


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, causal: bool, window,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` for the output cotangent do: K6 and
    K7 for CUDA tensors, the plain backward for CPU tensors."""
    if _device("flash_attention_backward", q) == "cpu":
        return flash_attention_backward_plain(q, k, v, scale, causal, window, o, lse, do)
    args = (q, k, v, scale, causal, window, lse, row_delta(o, do), do)
    return (flash_dq(*args), *flash_dkv(*args))


def _flash_lib(name: str) -> ctypes.CDLL:
    """The K5, K8 + K11 (`flash_fwd`) or K6, K7, K9, K10, K12 + K13
    (`flash_bwd`) kernel library, with its C signatures set."""
    from nemo_tpu_torch.csrc.loader import library

    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = library(name)
    # dtype, tensors, B, H, G, T, head_dim, scale, causal, window, stream
    n_ptrs = {"flash_fwd": 5, "flash_bwd_dq": 7, "flash_bwd_dkv": 8,
              "flash_seg_fwd": 7, "flash_seg_bwd_dq": 9, "flash_seg_bwd_dkv": 10,
              "flash_pos_fwd": 9, "flash_pos_bwd_dq": 11, "flash_pos_bwd_dkv": 12}
    fns = {"flash_fwd": ("flash_fwd", "flash_seg_fwd", "flash_pos_fwd"),
           "flash_bwd": ("flash_bwd_dq", "flash_bwd_dkv", "flash_seg_bwd_dq", "flash_seg_bwd_dkv",
                         "flash_pos_bwd_dq", "flash_pos_bwd_dkv")}
    for fn_name in fns[name]:
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:  # B, H, G, T (Tq and Tkv for positions), head_dim
            n_ints = 6 if fn_name.startswith("flash_pos") else 5
            fn.argtypes = ([ci] + [vp] * n_ptrs[fn_name] + [ci] * n_ints
                           + [ctypes.c_float, ci, ci, vp])
            fn.restype = ci
    return lib


# --------------------------------------------------------------------------
# packed rows: K8 (forward), K9 (dq), K10 (dk, dv)
# --------------------------------------------------------------------------


def flash_attention_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 segments: torch.Tensor, scale: float, causal: bool = True,
                                 window=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K8 (the function of
    flash_attention.py:_fwd_seg_kernel): dense fp32 GQA scores masked to
    causal (window) pairs of equal nonzero segment ids, a softmax whose max is
    floored at -5e29, then (o [B, H, T, dh] in q's dtype, lse [B, H, T] fp32).
    A padding row gets o = 0 and lse = -1e30. Shapes as
    `flash_attention_packed`."""
    B, H, T, dh = q.shape
    s = _gqa_scores(q, k, scale, causal, window, segments)
    m = s.amax(-1, keepdim=True)
    m_safe = m.clamp_min(NEG_INF / 2)
    probs = torch.exp(s - m_safe)
    denom = probs.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bgrij,bgjd->bgrid", probs / denom, v.float())
    lse = torch.where(m <= NEG_INF / 2, torch.full_like(m, NEG_INF), m_safe + denom.log())
    return o.reshape(B, H, T, dh).to(q.dtype), lse.reshape(B, H, T)


def flash_attention_packed_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, segments: torch.Tensor, scale: float,
    causal: bool, window, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K9 and K10: `flash_attention_backward_plain`
    with the segment mask and P = where(lse > -5e29, exp(s - lse), 0)
    (flash_attention.py:899,945), so padding rows and keys get zero
    gradients."""
    return _flash_backward_plain(q, k, v, scale, causal, window, lse, row_delta(o, do), do,
                                 segments)


def _seg_check(what: str, q, segments) -> torch.Tensor:
    """segments [B, T] of integers on q's device → contiguous int32."""
    B, _, T, _ = q.shape
    if segments.shape != (B, T) or segments.dtype.is_floating_point or segments.is_complex():
        raise ValueError(f"{what}: segments must be [{B}, {T}] integers")
    if segments.device != q.device:
        raise ValueError(f"{what}: segments must be on {q.device}")
    return segments.to(torch.int32).contiguous()


def _ranges_check(what: str, q, ranges) -> torch.Tensor:
    """Tile ranges [B, ceil(T / 64), 2] int32 on q's device → contiguous."""
    B, _, T, _ = q.shape
    if (ranges.shape != (B, -(-T // 64), 2) or ranges.dtype != torch.int32
            or ranges.device != q.device):
        raise ValueError(f"{what}: ranges must be [{B}, ceil({T} / 64), 2] int32 on {q.device}")
    return ranges.contiguous()


def seg_tile_ranges(segments: torch.Tensor) -> torch.Tensor:
    """[B, T] int32 segment ids → [B, ceil(T / 64), 2] int32, the [min, max]
    id of each 64-row tile: the pre-pass from which K8-K10 skip tile pairs
    whose ranges do not overlap (_seg_overlap)."""
    B, T = segments.shape
    n = -(-T // 64)
    pad = n * 64 - T
    lo = torch.nn.functional.pad(segments, (0, pad), value=2**31 - 1).view(B, n, 64).amin(-1)
    hi = torch.nn.functional.pad(segments, (0, pad), value=-2**31).view(B, n, 64).amax(-1)
    return torch.stack((lo, hi), -1).to(torch.int32).contiguous()


def _k8_launch(q, k, v, seg, ranges, scale, causal, window):
    """K8 → (o [B, T, H, dh], lse [B, H, T] fp32); seg [B, T] int32 and its
    tile ranges on the card."""
    what = "flash_attention_packed"
    _flash_check(what, q, k, v, window)
    B, H, T, dh = q.shape
    qt, kt, vt = _bthd(what, (q, k, v))
    ranges = _ranges_check(what, q, ranges)
    o = torch.empty((B, T, H, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    err = _flash_lib("flash_fwd").flash_seg_fwd(
        _DTYPES[q.dtype], qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), seg.data_ptr(),
        ranges.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H, k.shape[1], T, dh, float(scale),
        int(causal), int(window or 0), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
    flash_attention_packed.launches += 1
    return o, lse


class FlashAttentionPacked(torch.autograd.Function):
    """K8 with its backward. Forward: o [B, T, H, dh] and lse (not
    differentiable); backward: `flash_attention_packed_backward` (K9 + K10 on
    the card, the plain backward on the CPU). The segment ids and their tile
    ranges are computed once (where the caller has not) and kept for the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, segments, scale, causal, window, ranges):
        what = "flash_attention_packed"
        seg = _seg_check(what, q, segments)
        if _device(what, q) == "cpu":
            o, lse = flash_attention_packed_plain(q, k, v, seg, scale, causal, window)
            o, ranges = o.transpose(1, 2).contiguous(), None
        else:
            ranges = seg_tile_ranges(seg) if ranges is None else ranges
            o, lse = _k8_launch(q, k, v, seg, ranges, scale, causal, window)
        ctx.save_for_backward(q, k, v, o, lse, seg, ranges)
        ctx.args = (scale, causal, window)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, seg, ranges = ctx.saved_tensors
        grads = flash_attention_packed_backward(q, k, v, seg, *ctx.args, o.transpose(1, 2), lse,
                                                do.to(q.dtype).transpose(1, 2), ranges=ranges)
        return (*grads, None, None, None, None, None)


def flash_attention_packed(
    q: torch.Tensor,  # [B, H, T, dh]
    k: torch.Tensor,  # [B, G, T, dh], G dividing H
    v: torch.Tensor,  # [B, G, T, dh]
    segments: torch.Tensor,  # [B, T] integer segment ids, 0 = padding
    scale: float,
    causal: bool = True,
    window=None,  # sliding window: key j is seen by query i only if j > i - window
    ranges=None,  # seg_tile_ranges(segments), for callers that reuse one batch's ids
) -> torch.Tensor:
    """→ o [B, H, T, dh] in q's dtype, differentiable in q, k and v: the
    counterpart of nemo_tpu/ops/flash_attention.py:flash_attention_packed
    (1123). Query i sees key j only where segments[b, i] == segments[b, j] > 0
    (and the causal and window masks allow it); a padding row gives 0.

    CPU tensors take the plain version; CUDA tensors launch K8 (fp32, or bf16
    at 16-byte aligned addresses; dh 64, 96 or 128) or raise. Layouts as
    `flash_attention`."""
    o, _ = FlashAttentionPacked.apply(q, k, v, segments, float(scale), bool(causal), window,
                                      ranges)
    return o.transpose(1, 2)


flash_attention_packed.launches = 0


def flash_seg_dq(q, k, v, segments, scale, causal, window, lse, delta, do, ranges=None):
    """K9 → dq [B, H, T, dh]; `delta` is `row_delta(o, do)`. Inputs as
    `flash_attention_packed`, plus lse and delta [B, H, T] fp32, do [B, H, T,
    dh] in q's dtype and optionally the tile ranges of the segments
    (`seg_tile_ranges`). CPU tensors take the plain backward."""
    if _device("flash_seg_dq", q) == "cpu":
        return _flash_backward_plain(q, k, v, scale, causal, window, lse, delta, do, segments)[0]
    (dq,) = _flash_bwd_launch("flash_seg_bwd_dq", q, k, v, scale, causal, window, lse, delta, do,
                              segments, ranges)
    flash_seg_dq.launches += 1
    return dq.transpose(1, 2)


flash_seg_dq.launches = 0


def flash_seg_dkv(q, k, v, segments, scale, causal, window, lse, delta, do, ranges=None):
    """K10 → (dk, dv) [B, G, T, dh], each summed over the H/G query heads of
    its kv head; arguments as `flash_seg_dq`. CPU tensors take the plain
    backward."""
    if _device("flash_seg_dkv", q) == "cpu":
        return _flash_backward_plain(q, k, v, scale, causal, window, lse, delta, do,
                                     segments)[1:]
    dk, dv = _flash_bwd_launch("flash_seg_bwd_dkv", q, k, v, scale, causal, window, lse, delta,
                               do, segments, ranges)
    flash_seg_dkv.launches += 1
    return dk.transpose(1, 2), dv.transpose(1, 2)


flash_seg_dkv.launches = 0


def flash_attention_packed_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, segments: torch.Tensor, scale: float,
    causal: bool, window, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, ranges=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention_packed` for the output cotangent do:
    K9 and K10 for CUDA tensors, the plain backward for CPU tensors."""
    if _device("flash_attention_packed_backward", q) == "cpu":
        return flash_attention_packed_backward_plain(q, k, v, segments, scale, causal, window,
                                                     o, lse, do)
    args = (q, k, v, segments, scale, causal, window, lse, row_delta(o, do), do)
    return (flash_seg_dq(*args, ranges=ranges), *flash_seg_dkv(*args, ranges=ranges))


# --------------------------------------------------------------------------
# explicit positions: K11 (forward), K12 (dq), K13 (dk, dv)
# --------------------------------------------------------------------------


def flash_attention_positions_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    qpos: torch.Tensor, kpos: torch.Tensor, scale: float,
                                    causal: bool = True, window=None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K11, the counterpart of
    nemo_tpu/ops/flash_attention.py:xla_attention_positions (766): dense fp32
    GQA scores masked by positions at -1e30, a softmax whose max is floored
    at -5e29, then (o [B, H, Tq, dh] in q's dtype, lse [B, H, Tq] fp32). A
    row that keeps no key gets o = 0 and lse = -1e30. Shapes as
    `flash_attention_positions`."""
    B, H, Tq, dh = q.shape
    s = _gqa_scores(q, k, scale, causal, window, qpos=qpos, kpos=kpos)
    m = s.amax(-1, keepdim=True)
    m_safe = m.clamp_min(NEG_INF / 2)
    probs = torch.exp(s - m_safe)
    denom = probs.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bgrij,bgjd->bgrid", probs / denom, v.float())
    lse = torch.where(m <= NEG_INF / 2, torch.full_like(m, NEG_INF), m_safe + denom.log())
    return o.reshape(B, H, Tq, dh).to(q.dtype), lse.reshape(B, H, Tq)


def flash_attention_positions_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, qpos: torch.Tensor, kpos: torch.Tensor,
    scale: float, causal: bool, window, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    dlse=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K12 and K13: (dq, dk, dv) for the cotangents
    do of o and `dlse` of lse (None: 0), `flash_attention_backward_plain`
    with the position mask, delta' = rowsum(dO∘O) − dlse
    (_flash_backward_pos, flash_attention.py:672-675) and P = where(lse >
    -5e29, exp(s − lse), 0), so a row that keeps no key gets dq = 0."""
    return _flash_backward_plain(q, k, v, scale, causal, window, lse, pos_delta(o, do, dlse), do,
                                 qpos=qpos, kpos=kpos)


def pos_delta(o: torch.Tensor, do: torch.Tensor, dlse=None) -> torch.Tensor:
    """delta' = rowsum(dO ∘ O) − g_lse in fp32 [B, H, Tq]: the lse cotangent
    folded into the backward's row term (flash_attention.py:672-675)."""
    delta = row_delta(o, do)
    return delta if dlse is None else delta - dlse.float()


def pos_tile_ranges(pos: torch.Tensor) -> torch.Tensor:
    """[T] int32 positions → [ceil(T / 64), 2] int32, the [min, max] position
    of each 64 rows: the pre-pass from which K11-K13 skip tile pairs that
    keep no pair (_pos_active)."""
    return seg_tile_ranges(pos.reshape(1, -1))[0]


def _pos_check(what: str, q, k, v, qpos, kpos, window):
    """What the kernels take: `_flash_check`'s shapes with any Tkv, Tq and
    Tkv multiples of 64, qpos [Tq] and kpos [Tkv] integers on q's device.
    → (qpos, kpos) as contiguous int32."""
    _flash_check(what, q, k, v, window, same_length=False)
    Tq, Tkv = q.shape[2], k.shape[2]
    for name, pos, n in (("qpos", qpos, Tq), ("kpos", kpos, Tkv)):
        if pos.shape != (n,) or pos.dtype.is_floating_point or pos.is_complex():
            raise ValueError(f"{what}: {name} must be [{n}] integers")
        if pos.device != q.device:
            raise ValueError(f"{what}: {name} must be on {q.device}")
    if Tq % 64 or Tkv % 64:
        raise ValueError(f"{what}: Tq {Tq} and Tkv {Tkv} must be multiples of 64 on the card")
    return qpos.to(torch.int32).contiguous(), kpos.to(torch.int32).contiguous()


def _pos_ranges(what: str, qpos, kpos, ranges):
    """The tile ranges (qrange, krange) of the positions: `ranges` where the
    caller gives them (checked), else computed here."""
    if ranges is None:
        return pos_tile_ranges(qpos), pos_tile_ranges(kpos)
    out = []
    for pos, r in zip((qpos, kpos), ranges):
        if r.shape != (-(-pos.shape[0] // 64), 2) or r.dtype != torch.int32 or (
                r.device != pos.device):
            raise ValueError(f"{what}: ranges must be [ceil(T / 64), 2] int32 on {pos.device}")
        out.append(r.contiguous())
    return tuple(out)


def _k11_launch(q, k, v, qpos, kpos, scale, causal, window, ranges=None):
    """K11 → (o [B, Tq, H, dh], lse [B, H, Tq] fp32)."""
    what = "flash_attention_positions"
    qpos, kpos = _pos_check(what, q, k, v, qpos, kpos, window)
    qr, kr = _pos_ranges(what, qpos, kpos, ranges)
    B, H, Tq, dh = q.shape
    G, Tkv = k.shape[1], k.shape[2]
    qt, kt, vt = _bthd(what, (q, k, v))
    o = torch.empty((B, Tq, H, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    err = _flash_lib("flash_fwd").flash_pos_fwd(
        _DTYPES[q.dtype], qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), qr.data_ptr(), kr.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H, G,
        Tq, Tkv, dh, float(scale), int(causal), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
    flash_attention_positions.launches += 1
    return o, lse


def positions_forward(q, k, v, qpos, kpos, scale, causal, window, ranges=None):
    """(o [B, Tq, H, dh], lse [B, H, Tq]) of `flash_attention_positions`
    without autograd: K11 for CUDA tensors, the plain version for CPU
    tensors (o then a view in the kernel's layout)."""
    if _device("flash_attention_positions", q) == "cpu":
        o, lse = flash_attention_positions_plain(q, k, v, qpos, kpos, scale, causal, window)
        return o.transpose(1, 2), lse
    return _k11_launch(q, k, v, qpos, kpos, scale, causal, window, ranges)


class FlashAttentionPositions(torch.autograd.Function):
    """K11 with its backward. Forward: o [B, Tq, H, dh] and lse [B, H, Tq],
    both differentiable; backward: `flash_attention_positions_backward`
    (K12 + K13 on the card, the plain backward on the CPU) with the lse
    cotangent folded into delta'."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, scale, causal, window):
        o, lse = positions_forward(q, k, v, qpos, kpos, scale, causal, window)
        o = o.contiguous()
        ctx.save_for_backward(q, k, v, qpos, kpos, o, lse)
        ctx.args = (scale, causal, window)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, qpos, kpos, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.to(q.dtype)
        grads = flash_attention_positions_backward(
            q, k, v, qpos, kpos, *ctx.args, o.transpose(1, 2), lse, do.transpose(1, 2), dlse)
        return (*grads, None, None, None, None, None)


def flash_attention_positions(
    q: torch.Tensor,  # [B, H, Tq, dh]
    k: torch.Tensor,  # [B, G, Tkv, dh], G dividing H
    v: torch.Tensor,  # [B, G, Tkv, dh]
    qpos: torch.Tensor,  # [Tq] integer positions of the query rows
    kpos: torch.Tensor,  # [Tkv] integer positions of the keys
    scale: float,
    causal: bool = True,
    window=None,  # sliding window: key j is seen by query i only if kpos[j] > qpos[i] - window
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (o [B, H, Tq, dh] in q's dtype, lse [B, H, Tq] fp32), both
    differentiable in q, k and v: the counterpart of
    nemo_tpu/ops/flash_attention.py:flash_attention_positions (733), whose
    lse is [B, H, Tq, 1]. A row that keeps no key gets o = 0 and lse = -1e30.

    CPU tensors take the plain version; CUDA tensors launch K11 (fp32, or
    bf16 at 16-byte aligned addresses; dh 64, 96 or 128; Tq and Tkv multiples of
    64) or raise. Layouts as `flash_attention`."""
    o, lse = FlashAttentionPositions.apply(q, k, v, qpos, kpos, float(scale), bool(causal),
                                           window)
    return o.transpose(1, 2), lse


flash_attention_positions.launches = 0


def _pos_bwd_launch(fn: str, q, k, v, qpos, kpos, scale, causal, window, lse, delta, do,
                    ranges=None):
    """Launch K12 (→ dq [B, Tq, H, dh]) or K13 (→ dk, dv [B, Tkv, G, dh])."""
    qpos, kpos = _pos_check(fn, q, k, v, qpos, kpos, window)
    qr, kr = _pos_ranges(fn, qpos, kpos, ranges)
    B, H, Tq, dh = q.shape
    G, Tkv = k.shape[1], k.shape[2]
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{fn}: do must match q")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Tq) or t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be [B, H, Tq] float32")
    qt, kt, vt, dot = _bthd(fn, (q, k, v, do))
    lse_c, delta_c = lse.contiguous(), delta.contiguous()
    dq_side = fn.endswith("_dq")
    outs = [torch.empty((B, Tq, H, dh) if dq_side else (B, Tkv, G, dh), dtype=q.dtype,
                        device=q.device) for _ in range(1 if dq_side else 2)]
    err = getattr(_flash_lib("flash_bwd"), fn)(
        _DTYPES[q.dtype], qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), dot.data_ptr(),
        lse_c.data_ptr(), delta_c.data_ptr(), qpos.data_ptr(), kpos.data_ptr(), qr.data_ptr(),
        kr.data_ptr(), *(t.data_ptr() for t in outs), B, H, G, Tq, Tkv, dh, float(scale),
        int(causal), int(window or 0), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
    return outs


def flash_pos_dq(q, k, v, qpos, kpos, scale, causal, window, lse, delta, do, ranges=None):
    """K12 → dq [B, H, Tq, dh]; `delta` is `pos_delta(o, do, dlse)`. Inputs
    as `flash_attention_positions`, plus lse and delta [B, H, Tq] fp32, do
    [B, H, Tq, dh] in q's dtype and optionally the positions' tile ranges.
    CPU tensors take the plain backward."""
    if _device("flash_pos_dq", q) == "cpu":
        return _flash_backward_plain(q, k, v, scale, causal, window, lse, delta, do,
                                     qpos=qpos, kpos=kpos)[0]
    (dq,) = _pos_bwd_launch("flash_pos_bwd_dq", q, k, v, qpos, kpos, scale, causal, window, lse,
                            delta, do, ranges)
    flash_pos_dq.launches += 1
    return dq.transpose(1, 2)


flash_pos_dq.launches = 0


def flash_pos_dkv(q, k, v, qpos, kpos, scale, causal, window, lse, delta, do, ranges=None):
    """K13 → (dk, dv) [B, G, Tkv, dh], each summed over the H/G query heads
    of its kv head; arguments as `flash_pos_dq`. CPU tensors take the plain
    backward."""
    if _device("flash_pos_dkv", q) == "cpu":
        return _flash_backward_plain(q, k, v, scale, causal, window, lse, delta, do,
                                     qpos=qpos, kpos=kpos)[1:]
    dk, dv = _pos_bwd_launch("flash_pos_bwd_dkv", q, k, v, qpos, kpos, scale, causal, window,
                             lse, delta, do, ranges)
    flash_pos_dkv.launches += 1
    return dk.transpose(1, 2), dv.transpose(1, 2)


flash_pos_dkv.launches = 0


def flash_attention_positions_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, qpos: torch.Tensor, kpos: torch.Tensor,
    scale: float, causal: bool, window, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    dlse=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention_positions` for the cotangents do of o
    and dlse of lse (None: 0): K12 and K13 for CUDA tensors, the plain
    backward for CPU tensors."""
    if _device("flash_attention_positions_backward", q) == "cpu":
        return flash_attention_positions_backward_plain(q, k, v, qpos, kpos, scale, causal,
                                                        window, o, lse, do, dlse)
    args = (q, k, v, qpos, kpos, scale, causal, window, lse, pos_delta(o, do, dlse), do)
    return (flash_pos_dq(*args), *flash_pos_dkv(*args))
