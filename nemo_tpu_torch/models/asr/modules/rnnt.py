"""RNNT prediction network, joint network and greedy decoders (counterpart of
nemo_tpu/models/asr/modules/rnnt.py).

Parameter names mirror the JAX tree: `prediction.embed.embedding` [V, H],
`prediction.rnn.lstm{i}.{ii,if,ig,io}` (Linear, no bias: flax's input
kernels) and `.{hi,hf,hg,ho}` (Linear with bias: the hidden kernels), and
`joint.{enc_proj,pred_proj,out_proj}`. The LSTM is flax's
`OptimizedLSTMCell` (gates i, f, g, o; c' = f c + i g, h' = o tanh c'), not
`torch.nn.LSTM`, whose gate layout and biases differ. Its eight kernels are
concatenated once a forward or a decode (`PredictionNetwork.fused`), so a
step is one product. The prediction net and the joint hold fp32 parameters
and compute in fp32, as flax promotes a bf16 encoder output to its fp32
Dense parameters.

The decoders take the JAX functions' arguments: `joint_logits_fn(enc_t,
pred_out)`, `pred_step_fn(token, state)` (token −1 is SOS), the state as a
tuple of per-layer (c, h), and return (tokens [B, T·max_symbols] int32
padded with −1, counts [B] int32).
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

State = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
_GATES = "ifog"  # the fused kernel's gate order: the three sigmoid gates first
_ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid}
CHECK_EVERY = 16  # label-looping loops between the host's reads of the loop's condition


class Embed(nn.Module):
    """flax nn.Embed's parameter, `embedding` [num, features]."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, features))


class OptimizedLSTMCell(nn.Module):
    """flax's OptimizedLSTMCell: children `ii`, `if`, `ig`, `io` (input
    kernels, no bias) and `hi`, `hf`, `hg`, `ho` (hidden kernels with bias)."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        for c in "ifgo":
            self.add_module(f"i{c}", nn.Linear(in_features, hidden, bias=False))
            self.add_module(f"h{c}", nn.Linear(hidden, hidden))

    def fused(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(kernel [in + H, 4H], bias [4H]) of the gates in the order i, f,
        o, g: [x, h] @ kernel + bias is every gate's pre-activation."""
        w = torch.cat([torch.cat([self._modules[f"i{c}"].weight, self._modules[f"h{c}"].weight],
                                 1) for c in _GATES], 0)
        return w.t().contiguous(), torch.cat([self._modules[f"h{c}"].bias for c in _GATES])

    @staticmethod
    def step(x: torch.Tensor, carry: Tuple[torch.Tensor, torch.Tensor],
             weights: Tuple[torch.Tensor, torch.Tensor]):
        """One step: ((c', h'), h') from x [B, in], carry (c, h) [B, H]."""
        c, h = carry
        H = h.shape[-1]
        z = torch.addmm(weights[1], torch.cat([x, h], 1), weights[0])
        sig = torch.sigmoid(z[:, :3 * H])
        g = torch.tanh(z[:, 3 * H:])
        c = torch.addcmul(sig[:, H:2 * H] * c, sig[:, :H], g)
        h = sig[:, 2 * H:] * torch.tanh(c)
        return (c, h), h


class _PredStep(nn.Module):
    """One prediction-net step through all LSTM layers (`lstm{i}`)."""

    def __init__(self, hidden: int, layers: int):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"lstm{i}", OptimizedLSTMCell(hidden, hidden))

    def fused(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [getattr(self, f"lstm{i}").fused() for i in range(self.layers)]

    def forward(self, carry: State, x: torch.Tensor, weights) -> Tuple[State, torch.Tensor]:
        new_carry = []
        h = x
        for i in range(self.layers):
            state, h = OptimizedLSTMCell.step(h, carry[i], weights[i])
            new_carry.append(state)
        return tuple(new_carry), h


class PredictionNetwork(nn.Module):
    """Embedding (token −1, SOS, embeds as zeros) → LSTM stack."""

    def __init__(self, vocab_size: int, pred_hidden: int, pred_rnn_layers: int = 1):
        super().__init__()
        self.pred_hidden, self.pred_rnn_layers = pred_hidden, pred_rnn_layers
        self.embed = Embed(vocab_size, pred_hidden)
        self.rnn = _PredStep(pred_hidden, pred_rnn_layers)

    def fused(self):
        """What a step reads, built once a forward or a decode: the
        embedding table with a zero row appended for SOS (token −1 indexes
        it as −1 mod (V + 1)), and each LSTM layer's fused kernel and bias."""
        emb = self.embed.embedding
        return torch.cat([emb, emb.new_zeros(1, emb.shape[1])]), self.rnn.fused()

    def _embed_tokens(self, tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens.long().remainder(table.shape[0]), table)

    def initial_state(self, batch: int, device=None) -> State:
        zeros = torch.zeros(batch, self.pred_hidden, device=device)
        return tuple((zeros, zeros) for _ in range(self.pred_rnn_layers))

    def forward(self, targets: torch.Tensor) -> torch.Tensor:
        """targets [B, U] → prediction outputs [B, U+1, H] (row 0: SOS)."""
        B, U = targets.shape
        table, weights = self.fused()
        tokens = torch.cat([targets.new_full((B, 1), -1), targets], 1)
        x = self._embed_tokens(tokens, table)
        carry = self.initial_state(B, targets.device)
        out = []
        for u in range(U + 1):
            carry, h = self.rnn(carry, x[:, u], weights)
            out.append(h)
        return torch.stack(out, 1)

    def step(self, token: torch.Tensor, state: State, fused=None) -> Tuple[torch.Tensor, State]:
        """One decode step: token [B] (−1: SOS) and state → ([B, H], state).
        `fused` is `self.fused()`, built once by a caller that steps many
        times."""
        table, weights = self.fused() if fused is None else fused
        new_state, out = self.rnn(state, self._embed_tokens(token, table), weights)
        return out, new_state


class RNNTJoint(nn.Module):
    """act(enc_proj(enc) + pred_proj(pred)) → out_proj: V + 1 logits, blank
    last (index V). With `num_durations` > 0 it is the TDT joint: a second
    head `dur_proj` over the same hidden gives the duration logits, and the
    joint returns (token logits, duration logits). The multiblank joint
    (`num_big_blanks`) is not ported."""

    def __init__(self, num_classes: int, enc_hidden: int, pred_hidden: int,
                 joint_hidden: int = 640, activation: str = "relu", num_durations: int = 0,
                 num_big_blanks: int = 0):
        super().__init__()
        if num_big_blanks > 0:
            raise NotImplementedError("the multiblank joint is not ported "
                                      "(ROADMAP.md A5, what is left of RNNT)")
        self.num_classes = num_classes
        self.act = _ACTIVATIONS[activation]
        self.enc_proj = nn.Linear(enc_hidden, joint_hidden)
        self.pred_proj = nn.Linear(pred_hidden, joint_hidden)
        self.out_proj = nn.Linear(joint_hidden, num_classes + 1)
        if num_durations > 0:
            self.dur_proj = nn.Linear(joint_hidden, num_durations)
        self.num_durations = num_durations

    def forward(self, enc: torch.Tensor, pred: torch.Tensor):
        """enc [..., H_e], pred [..., H_p] broadcastable ([B, T, 1, H] and
        [B, 1, U+1, H] in training, [B, H] and [B, H] in decode) → [..., V+1]
        (TDT: and the duration logits [..., D])."""
        return self.from_projected(self.project_enc(enc), self.project_pred(pred))

    def project_enc(self, enc: torch.Tensor) -> torch.Tensor:
        """enc_proj, the input promoted to the weights' type as flax promotes
        it (a bf16 encoder output meets fp32 weights in fp32)."""
        return self.enc_proj(enc.to(torch.promote_types(enc.dtype, self.enc_proj.weight.dtype)))

    def project_pred(self, pred: torch.Tensor) -> torch.Tensor:
        return self.pred_proj(pred.to(torch.promote_types(pred.dtype,
                                                           self.pred_proj.weight.dtype)))

    def from_projected(self, e: torch.Tensor, p: torch.Tensor):
        """The logits from projected encoder and prediction outputs (TDT: the
        token and the duration logits)."""
        h = self.act(e + p)
        if self.num_durations:
            return self.out_proj(h), self.dur_proj(h)
        return self.out_proj(h)

    def fused_log_probs(self, enc: torch.Tensor, pred: torch.Tensor, targets: torch.Tensor,
                        chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
        """enc [B, T, H_e], pred [B, U+1, H_p], targets [B, U] → (lp_blank,
        lp_label) [B, T, U+1] fp32, the two planes the RNNT loss reads, from
        chunks of `chunk` frames: only one chunk's [B, chunk, U+1, V+1]
        logits exist at a time, in the backward too (each chunk is
        recomputed there, as JAX's `jax.checkpoint` body is)."""
        B, T, _ = enc.shape
        e, p = self.project_enc(enc), self.project_pred(pred)
        tgt = torch.cat([targets, targets.new_zeros(B, 1)], 1).long()
        ckpt = torch.is_grad_enabled() and (e.requires_grad or p.requires_grad)
        planes = []
        for s in range(0, T, chunk):
            args = (e[:, s:s + chunk], p, tgt)
            planes.append(torch.utils.checkpoint.checkpoint(
                self._chunk_log_probs, *args, use_reentrant=False) if ckpt
                else self._chunk_log_probs(*args))
        return torch.cat([b for b, _ in planes], 1), torch.cat([lab for _, lab in planes], 1)

    def _chunk_log_probs(self, e_c: torch.Tensor, p: torch.Tensor, tgt: torch.Tensor):
        B, c = e_c.shape[:2]
        logits = self.from_projected(e_c[:, :, None], p[:, None]).float()
        lse = torch.logsumexp(logits, -1)
        gold = logits.gather(3, tgt[:, None, :, None].expand(B, c, -1, 1))[..., 0]
        return logits[..., self.num_classes] - lse, gold - lse


def init_flax_defaults(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the distributions of flax's default initialisers:
    lecun-normal (truncated normal, variance 1/fan_in) Dense and LSTM input
    kernels, orthogonal LSTM hidden kernels, zero biases, and nn.Embed's
    normal of variance 1/features."""
    for name, mod in module.named_modules():
        if isinstance(mod, Embed):
            nn.init.normal_(mod.embedding, 0.0, 1.0 / math.sqrt(mod.embedding.shape[1]),
                            generator=generator)
        elif isinstance(mod, nn.Linear):
            if name.rsplit(".", 1)[-1] in ("hi", "hf", "hg", "ho"):  # an LSTM hidden kernel
                nn.init.orthogonal_(mod.weight, generator=generator)
            else:
                _lecun_normal(mod.weight, generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)


def _lecun_normal(weight: torch.Tensor, generator: torch.Generator) -> None:
    """jax.nn.initializers.lecun_normal of a Linear weight [out, in]: a
    normal truncated at ±2 standard deviations, scaled to variance 1/in."""
    std = 1.0 / math.sqrt(weight.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def _select(mask: torch.Tensor, new, old):
    """where(mask[:, None], new, old) over a tensor or nested tuples of them."""
    if isinstance(new, torch.Tensor):
        return torch.where(mask[:, None], new, old)
    return tuple(_select(mask, n, o) for n, o in zip(new, old))


def rnnt_greedy_decode(joint_logits_fn: Callable, pred_step_fn: Callable, initial_state,
                       enc: torch.Tensor, enc_len: torch.Tensor, blank: int,
                       max_symbols: int = 10) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Batched greedy transducer decode, frame by frame: at each frame up to
    `max_symbols` joint evaluations for the whole batch, a row emitting until
    its first blank. The symbol loop of a frame ends once no row is active
    (the remaining JAX iterations change nothing). Returns (tokens, counts,
    the number of joint evaluations)."""
    B, T, _ = enc.shape
    max_total = T * max_symbols
    rows = torch.arange(B, device=enc.device)
    enc_len = enc_len.to(enc.device).long()
    buf = torch.full((B, max_total + 1), -1, dtype=torch.long, device=enc.device)
    counts = torch.zeros(B, dtype=torch.long, device=enc.device)
    pred_out, state = pred_step_fn(torch.full((B,), -1, dtype=torch.long, device=enc.device),
                                   initial_state)
    it = 0
    for t in range(T):
        enc_t = enc[:, t]
        active = t < enc_len
        for _ in range(max_symbols):
            if not bool(active.any()):
                break
            it += 1
            k = joint_logits_fn(enc_t, pred_out).argmax(-1)
            emit = active & (k != blank)
            # a row that does not emit writes the spare last column
            buf[rows, torch.where(emit, counts, max_total)] = k
            counts += emit
            new_out, new_state = pred_step_fn(torch.where(emit, k, 0), state)
            pred_out = torch.where(emit[:, None], new_out, pred_out)
            state = _select(emit, new_state, state)
            active = emit
    return buf[:, :max_total].int(), counts.int(), it


def rnnt_greedy_decode_label_looping(joint_logits_fn: Callable, pred_step_fn: Callable,
                                     initial_state, enc: torch.Tensor, enc_len: torch.Tensor,
                                     blank: int, max_symbols: int = 10
                                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Label-looping batched greedy decode: one joint evaluation a loop for
    the whole batch; a row whose argmax is blank (or that has emitted
    `max_symbols` at this frame) advances its frame, an emitting row
    advances the prediction net, whose new state only the emitting rows
    take. Token-exact with `rnnt_greedy_decode`.

    JAX's loop runs while any row has frames left, at most T (max_symbols +
    1) + 1 times. Here the host reads that condition every `CHECK_EVERY`
    loops (each read waits for the card): a loop after every row is done
    writes nothing, so the tokens are the same, and the cap is the same.
    Returns (tokens, counts, the number of loops run)."""
    B, T, _ = enc.shape
    max_total = T * max_symbols
    dev = enc.device
    frames = enc.reshape(B * T, -1)
    first = torch.arange(B, device=dev) * T  # row b's frame t is frames[first[b] + t]
    enc_len = enc_len.to(dev).long()
    buf = torch.full((B, max_total + 1), -1, dtype=torch.long, device=dev)
    t = torch.zeros(B, dtype=torch.long, device=dev)
    counts = torch.zeros_like(t)
    sym_count = torch.zeros_like(t)
    pred_out, state = pred_step_fn(torch.full((B,), -1, dtype=torch.long, device=dev),
                                   initial_state)
    iters_cap = T * (max_symbols + 1) + 1
    it = 0
    while it < iters_cap:
        if it % CHECK_EVERY == 0 and not bool((t < enc_len).any()):
            break
        k = joint_logits_fn(frames.index_select(0, first + t.clamp(max=T - 1)),
                            pred_out).argmax(-1)
        active = t < enc_len
        emit = active & (k != blank) & (sym_count < max_symbols)
        advance = active ^ emit  # active and blank (or forced blank)
        # a row that does not emit writes the spare last column
        buf.scatter_(1, torch.where(emit, counts, max_total)[:, None], k[:, None])
        counts += emit
        new_out, new_state = pred_step_fn(torch.where(emit, k, 0), state)
        pred_out = torch.where(emit[:, None], new_out, pred_out)
        state = _select(emit, new_state, state)
        t += advance
        sym_count.add_(emit).masked_fill_(advance, 0)
        it += 1
    return buf[:, :max_total].int(), counts.int(), it

