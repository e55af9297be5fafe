"""Autoregressive generation and continuous batching (counterpart of
nemo_tpu/models/llm/generate.py).

    engine = ContinuousBatchingEngine(cfg, params, max_slots=8, max_len=1024,
                                      cache_dtype=torch.int8)
    tok = engine.prefill_slot(0, prompt_ids)
    toks, emitted, active = engine.decode_steps(feed, active, n_steps=64)

`params` is the JAX package's parameter tree (nested dicts of numpy arrays or
tensors, scanned or unrolled; an int8_ptq tree from `ops/quant.py:
ptq_params_for_serving` with `cfg.quantization="int8_ptq"`), carried into a
`GPTModel` on the card unless `device="cpu"` is given. The engines hold the
KV cache as `gpt.init_kv_caches` makes it ([L, slots, T, G, D], bf16, fp32
or int8 with per-token scales) and the model writes it in place.

- `GenerationEngine` (generate.py:57): left-padded batch generate, one
  cache write index for every row (an int) and `kv_valid` masking the
  padding; the loop of forwards runs on the card and the tokens are read
  back once.
- `ContinuousBatchingEngine` (174): a slot pool; `prefill_slot` admits a
  request (chunked prefill in the largest prefill bucket, a registered
  prefix's KV copied in, prompts cut to `max_len - 1`); `decode_step` steps
  every slot once with per-slot write rows and `kv_valid` (the model's
  write-then-attend route); `decode_steps` runs N steps in a loop that
  keeps the tokens, write rows and active flags on the card (the model's
  attend-then-write route, `gpt._decode_attention`), flips a slot off at
  its EOS or at `max_len - 1` with `torch.where`, and reads back once. The
  pool grows along time in KV-length buckets (`_grow_pool`); a write that
  would overrun it raises.
- Sampling (`_sample`, `_temp_sample`): greedy is argmax, as in JAX;
  temperature, top-k and top-p filter the logits as JAX does and draw by
  the Gumbel argmax from a `torch.Generator` seeded by `seed` (JAX draws
  with threefry, which this cannot reproduce). The full-vocabulary sort
  runs only where some row filters.

Sharded serving (`mesh`, `mesh_cfg`) is not ported (ROADMAP A8) and raises,
as do JAX's relay-hiding `begin_decode_steps` / `finish_decode_steps`,
which are left out, and `SpeculativeEngine`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from nemo_tpu_torch.core.device import resolve_device
from nemo_tpu_torch.interop.jax_params import load_jax_variables
from nemo_tpu_torch.models.llm.config import GPTConfig
from nemo_tpu_torch.models.llm.gpt import GPTModel, cache_map, init_kv_caches


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Reference parity: CommonInferenceParams (llm.generate)."""

    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 0.0  # 0 = disabled
    greedy: bool = True
    max_new_tokens: int = 64
    eos_id: int = -1  # -1 = never stop early


def _refuse_mesh(mesh, mesh_cfg) -> None:
    if mesh is not None or mesh_cfg is not None:
        raise NotImplementedError("sharded serving (mesh, mesh_cfg) is not ported (ROADMAP A8)")


def serving_model(cfg: GPTConfig, params, device: torch.device) -> GPTModel:
    """A GPTModel on `device` holding the JAX-layout `params`, for inference."""
    with torch.device("meta"):
        model = GPTModel(cfg)
    model.to_empty(device=device)
    load_jax_variables(model, {"params": params})
    return model.eval().requires_grad_(False)


def _gumbel_argmax(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """A categorical draw from each row of `logits` [B, V], as
    jax.random.categorical draws it (argmax of logits + Gumbel noise)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u.clamp_min_(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _sample(logits: torch.Tensor, gen: torch.Generator, p: SamplingParams) -> torch.Tensor:
    """[B, V] → [B] token ids (generate.py:39)."""
    if p.greedy:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(p.temperature, 1e-6)
    if p.top_k > 0:
        kth = torch.topk(logits, p.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -1e30, logits)
    if p.top_p > 0.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
        cut = (cum < p.top_p).sum(-1, keepdim=True).clamp_max(logits.shape[-1] - 1)
        logits = torch.where(logits < srt.gather(-1, cut), -1e30, logits)
    return _gumbel_argmax(logits, gen)


def _filter_logits(scaled: torch.Tensor, k: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rows of `scaled` [B, V] with per-row top-k `k` and top-p `p` [B] (0
    disables either): the logits below the row's cutoff set to -1e30 (the
    `masked` tensor of generate.py:636-651)."""
    V = scaled.shape[-1]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = srt.gather(-1, (k - 1).clamp(0, V - 1)[:, None])
    kth = torch.where(k[:, None] > 0, kth, -torch.inf)
    cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
    cut = (cum < p[:, None]).sum(-1, keepdim=True).clamp(0, V - 1)
    cutoff = torch.where(p[:, None] > 0, srt.gather(-1, cut), -torch.inf)
    return torch.where(scaled < torch.maximum(kth, cutoff), -1e30, scaled)


def _temp_sample(logits: torch.Tensor, gen: torch.Generator, temperature, top_k=0,
                 top_p=0.0) -> torch.Tensor:
    """Greedy where a row's temperature is 0, else a draw from its logits
    over the temperature, top-k/top-p filtered where set (generate.py:620).
    `temperature`, `top_k` and `top_p` are host scalars or per-row [B]
    arrays (each slot keeps its own request's sampling). The branches are
    taken on the host: no draw where every row is greedy, no sort where no
    row filters."""
    B = logits.shape[0]
    t = np.broadcast_to(np.asarray(temperature, np.float32), (B,))
    greedy = torch.argmax(logits, dim=-1)
    if not (t > 0).any():
        return greedy
    k = np.broadcast_to(np.asarray(top_k, np.int64), (B,))
    p = np.broadcast_to(np.asarray(top_p, np.float32), (B,))
    dev = logits.device
    t_rows = torch.tensor(t, device=dev)
    scaled = logits / torch.clamp_min(t_rows[:, None], 1e-6)
    if (k > 0).any() or (p > 0).any():
        scaled = _filter_logits(scaled, torch.tensor(k, device=dev), torch.tensor(p, device=dev))
    return torch.where(t_rows > 0, _gumbel_argmax(scaled, gen), greedy)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _pow2_len(n: int) -> int:
    return max(8, int(2 ** np.ceil(np.log2(n))))


class GenerationEngine:
    """Batch generation (generate.py:57): left-padded prompts share one cache
    write index; the prompt's forward fills the cache, then one forward a
    token. `cache_dtype` is the KV cache's (torch.int8: quantised)."""

    def __init__(self, cfg: GPTConfig, params, cache_dtype: torch.dtype = torch.bfloat16,
                 mesh=None, mesh_cfg=None, device: Union[str, torch.device, None] = None):
        _refuse_mesh(mesh, mesh_cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = serving_model(cfg, params, self.device)
        self.cache_dtype = cache_dtype

    @torch.no_grad()
    def generate_tokens(self, prompt_ids: Sequence[Sequence[int]],
                        sampling: SamplingParams = SamplingParams(),
                        seed: int = 0) -> List[List[int]]:
        B, dev, n_new = len(prompt_ids), self.device, sampling.max_new_tokens
        S = _pow2_len(max(len(p) for p in prompt_ids))
        tokens = np.zeros((B, S), np.int64)
        plen = np.zeros(B, np.int64)
        for b, p in enumerate(prompt_ids):
            tokens[b, S - len(p):] = p  # left padding
            plen[b] = len(p)
        pad = torch.from_numpy(S - plen).to(dev)
        slots = torch.arange(S, device=dev)[None, :]
        kv_valid = torch.zeros(B, S + n_new, dtype=torch.bool, device=dev)
        kv_valid[:, :S] = slots >= pad[:, None]
        caches = init_kv_caches(self.cfg, B, S + n_new, self.cache_dtype, dev)
        logits, _ = self.model(torch.from_numpy(tokens).to(dev),
                               torch.clamp_min(slots - pad[:, None], 0), kv_caches=caches,
                               decode_index=0, kv_valid=kv_valid)
        prev = logits[:, -1]
        gen = _generator(dev, seed)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        out = []
        for i in range(n_new):
            tok = torch.where(done, 0, _sample(prev, gen, sampling))
            out.append(torch.where(done, -1, tok))
            if i == n_new - 1:
                break  # the last token's forward would feed nothing
            kv_valid[:, S + i] = ~done
            logits, _ = self.model(tok[:, None], (S + i - pad)[:, None], kv_caches=caches,
                                   decode_index=S + i, kv_valid=kv_valid)
            prev = logits[:, 0]
            done = done | (tok == sampling.eos_id)
        out = torch.stack(out, 1).cpu().numpy() if out else np.zeros((B, 0), np.int64)
        results = []
        for b in range(B):
            ids = [int(t) for t in out[b] if t >= 0]
            if sampling.eos_id >= 0 and sampling.eos_id in ids:
                ids = ids[: ids.index(sampling.eos_id)]
            results.append(ids)
        return results


class ContinuousBatchingEngine:
    """Continuous batching on a fixed slot pool (generate.py:174): a shared
    KV pool [L, slots, T, ...]; a request is prefilled into one slot, then
    one forward steps every slot with its own write row. Requests join and
    leave without touching other slots. The pool's time axis starts at the
    smallest of `kv_len_buckets` (powers of two from 128 below `max_len`,
    and `max_len`) and grows a bucket at a time."""

    def __init__(self, cfg: GPTConfig, params, *, max_slots: int = 4, max_len: int = 512,
                 prefill_buckets: Sequence[int] = (32, 64, 128),
                 cache_dtype: torch.dtype = torch.bfloat16, max_prefixes: int = 8,
                 kv_len_buckets: Optional[Sequence[int]] = None, mesh=None, mesh_cfg=None,
                 device: Union[str, torch.device, None] = None):
        _refuse_mesh(mesh, mesh_cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = serving_model(cfg, params, self.device)
        self.max_slots = max_slots
        self.max_len = max_len
        self.buckets = sorted(prefill_buckets)
        if kv_len_buckets is None:
            kv_len_buckets = []
            b = 128
            while b < max_len:
                kv_len_buckets.append(b)
                b *= 2
        self.kv_len_buckets = sorted(set(list(kv_len_buckets) + [max_len]))
        self.alloc_len = self.kv_len_buckets[0]
        self.cache_dtype = cache_dtype
        self.caches = init_kv_caches(cfg, max_slots, self.alloc_len, cache_dtype, self.device)
        self.cur_len = np.zeros(max_slots, np.int64)  # the next write row of each slot
        # prefix cache: tuple(prefix ids) → (its KV [L, 1, P, ...] pair, P); LRU
        self._prefix_store: dict = {}
        self._max_prefixes = max_prefixes

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _bucket_for(self, need: int) -> int:
        for b in self.kv_len_buckets:
            if b >= need:
                return b
        if need > self.max_len:
            # a chunk whose padded bucket runs past max_len: one overflow
            # bucket of the largest prefill chunk absorbs it (generate.py:373)
            return self.max_len + self.buckets[-1]
        return self.max_len

    def _grow_pool(self, new_len: int) -> None:
        """Pad the pool's time axis to `new_len` (at most max_len + the
        largest prefill bucket): one pool-sized copy a bucket crossing."""
        new_len = min(new_len, self.max_len + self.buckets[-1])
        if new_len <= self.alloc_len:
            return

        def grow(c):
            z = c.new_zeros(c.shape[:2] + (new_len - c.shape[2],) + c.shape[3:])
            return torch.cat([c, z], dim=2)

        self.caches = cache_map(grow, self.caches)
        self.alloc_len = new_len

    @torch.no_grad()
    def register_prefix(self, prefix_ids: Sequence[int]) -> None:
        """Prefill a shared prompt prefix once and keep its KV; a later
        admission whose prompt starts with it skips those tokens
        (generate.py:407). At most `max_prefixes` are kept, the least
        recently used dropped first."""
        key = tuple(int(t) for t in prefix_ids)
        if not key or len(key) > self.max_len:
            raise ValueError("prefix must be 1..max_len tokens")
        if key in self._prefix_store:
            return
        P, dev = len(key), self.device
        Tpad = _pow2_len(P)
        toks = torch.zeros(1, Tpad, dtype=torch.long)
        toks[0, :P] = torch.tensor(key)
        caches = init_kv_caches(self.cfg, 1, Tpad, self.cache_dtype, dev)
        pos = torch.arange(Tpad, device=dev)
        self.model(toks.to(dev), pos[None, :], kv_caches=caches, decode_index=0,
                   kv_valid=(pos < P)[None, :])
        while len(self._prefix_store) >= self._max_prefixes:
            self._prefix_store.pop(next(iter(self._prefix_store)))  # LRU
        self._prefix_store[key] = (cache_map(lambda c: c[:, :, :P].clone(), caches), P)

    def _match_prefix(self, ids) -> int:
        """The length of the longest stored prefix of `ids` that leaves at
        least one token to prefill."""
        best = ()
        for key in self._prefix_store:
            if len(best) < len(key) < len(ids) and tuple(ids[: len(key)]) == key:
                best = key
        return len(best)

    @torch.no_grad()
    def prefill_slot(self, slot: int, prompt_ids: Sequence[int], temperature: float = 0.0,
                     seed: int = 0, top_k: int = 0, top_p: float = 0.0) -> int:
        """Admit a request into `slot`; returns its first generated token.
        A prompt of `max_len` tokens or more keeps its last max_len - 1. A
        stored prefix's KV is copied in and its tokens skipped; the rest
        runs in chunks of at most the largest prefill bucket, each padded to
        its bucket (generate.py:455)."""
        ids = [int(t) for t in prompt_ids]
        if len(ids) >= self.max_len:
            ids = ids[-(self.max_len - 1):]
        self._grow_pool(self._bucket_for(len(ids) + 1))
        start = self._match_prefix(ids)
        if start:
            key = tuple(ids[:start])
            kv = self._prefix_store.pop(key)
            self._prefix_store[key] = kv  # LRU touch
            for dst, src in zip(_tensors(self.caches), _tensors(kv[0])):
                dst[:, slot:slot + 1, :start].copy_(src)
        dev, tok, rest = self.device, None, ids[start:]
        while rest:
            piece, rest = rest[:self.buckets[-1]], rest[self.buckets[-1]:]
            Sb = self._bucket(len(piece))
            # the write covers [start, start + Sb), bucket padding included:
            # the pool must span it (generate.py:492-497)
            self._grow_pool(self._bucket_for(start + Sb))
            toks = torch.zeros(1, Sb, dtype=torch.long)
            toks[0, :len(piece)] = torch.tensor(piece)
            view = cache_map(lambda c: c[:, slot:slot + 1], self.caches)
            logits, _ = self.model(
                toks.to(dev), (start + torch.arange(Sb, device=dev))[None, :], kv_caches=view,
                decode_index=start,
                kv_valid=(torch.arange(self.alloc_len, device=dev) < start + len(piece))[None])
            tok = _temp_sample(logits[:, len(piece) - 1], _generator(dev, seed), temperature,
                               top_k, top_p)[0]
            start += len(piece)
        self.cur_len[slot] = start
        return int(tok)

    @torch.no_grad()
    def decode_step(self, feed_tokens: np.ndarray, active: np.ndarray, temperature=0.0,
                    seed: int = 0, top_k=0, top_p=0.0) -> np.ndarray:
        """feed_tokens [slots] (each slot's last token; 0 where free):
        advances the active slots one token and returns the next tokens
        [slots] (generate.py:514). `temperature`, `top_k` and `top_p` are
        scalars or per-slot [slots] arrays."""
        self._grow_pool(self._bucket_for(int(self.cur_len.max()) + 2))
        dev = self.device
        cl = torch.from_numpy(self.cur_len).to(dev)
        feed = torch.as_tensor(np.asarray(feed_tokens, np.int64)).to(dev)
        logits, _ = self.model(
            feed[:, None], cl[:, None], kv_caches=self.caches, decode_index=cl,
            kv_valid=torch.arange(self.alloc_len, device=dev)[None, :] <= cl[:, None])
        nxt = _temp_sample(logits[:, 0], _generator(dev, seed), temperature, top_k, top_p)
        self.cur_len = np.where(active, self.cur_len + 1, self.cur_len)
        return nxt.cpu().numpy()

    @torch.no_grad()
    def decode_steps(self, feed_tokens: np.ndarray, active: np.ndarray, n_steps: int = 8,
                     temperature=0.0, seed: int = 0, top_k=0, top_p=0.0, eos_id=-1):
        """Advance the active slots `n_steps` tokens (generate.py:598). The
        tokens, write rows and active flags stay on the card; a slot stops at
        its `eos_id` (a scalar or [slots]; -1 never) or at row max_len - 1
        and repeats its last token with emitted False. Returns (tokens
        [n_steps, slots], emitted [n_steps, slots] bool, active [slots]
        bool), read back once; `cur_len` follows the card's rows."""
        self._grow_pool(self._bucket_for(int(self.cur_len.max()) + n_steps + 1))
        dev, S = self.device, self.max_slots
        tok = torch.as_tensor(np.asarray(feed_tokens, np.int64)).to(dev)
        cl = torch.from_numpy(self.cur_len).to(dev)
        act = torch.as_tensor(np.asarray(active, bool)).to(dev)
        eos = torch.as_tensor(np.broadcast_to(np.asarray(eos_id, np.int64), (S,)).copy()).to(dev)
        gen = _generator(dev, seed)
        toks, emitted = [], []
        for _ in range(n_steps):
            logits, _ = self.model(tok[:, None], cl[:, None], kv_caches=self.caches,
                                   decode_index=cl)
            nxt = torch.where(act, _temp_sample(logits[:, 0], gen, temperature, top_k, top_p),
                              tok)
            cl = torch.where(act, cl + 1, cl)
            toks.append(nxt)
            emitted.append(act)
            act = act & (nxt != eos) & (cl < self.max_len - 1)
            tok = nxt
        out = torch.cat([torch.stack(toks).view(-1), torch.stack(emitted).view(-1).long(), cl,
                         act.long()]).cpu().numpy()
        n = n_steps * S
        self.cur_len = out[2 * n:2 * n + S].astype(np.int64)
        return (out[:n].reshape(n_steps, S), out[n:2 * n].reshape(n_steps, S).astype(bool),
                out[2 * n + S:].astype(bool))

    def free_slot(self, slot: int) -> None:
        self.cur_len[slot] = 0


def _tensors(caches) -> List[torch.Tensor]:
    """The tensors of a cache pair in a fixed order (k side, then v side)."""
    return [t for side in caches for t in (side.values() if isinstance(side, dict) else (side,))]


def generate(cfg: GPTConfig, params, tokenizer, prompts: Sequence[str],
             sampling: SamplingParams = SamplingParams(), seed: int = 0,
             device: Union[str, torch.device, None] = None) -> List[str]:
    """Text-level batch generation (generate.py:863)."""
    engine = GenerationEngine(cfg, params, device=device)
    ids = [tokenizer.text_to_ids(p) for p in prompts]
    return [tokenizer.ids_to_text(o) for o in engine.generate_tokens(ids, sampling, seed)]
