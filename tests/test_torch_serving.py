"""The serving layer of the PyTorch port (the KV cache and decode routes of
nemo_tpu_torch/models/llm/gpt.py, ops/quant.py, models/llm/generate.py,
llm/api.py:ptq and the int8 leaves of interop/jax_params.py) against the
JAX package, on the CPU.

One JAX model, `tiny_test` (2 layers, hidden 64, 4 heads over 2, vocab 128,
fp32), with weights drawn once from a numpy seed, serves every test. Greedy
tokens must equal JAX's exactly: the batch engine with fp32, bf16 and int8
caches; the continuous engine (single steps, multi-step decode, chunked
prefill and a cached prefix) with bf16 and int8 caches. Logits are held to
JAX's within 1e-5 with fp32 weights and caches, within 1e-4 with bf16 or int8
caches (the same roundings on both sides, summed in another order); int8
cache entries and PTQ weights byte for byte. The engines' own invariants
(JAX's tests/test_continuous_batching.py) are held on the port.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nemo_tpu.models.llm import generate as jax_generate  # noqa: E402
from nemo_tpu.models.llm import gpt as jax_gpt  # noqa: E402
from nemo_tpu.models.llm.config import tiny_test as jax_tiny  # noqa: E402
from nemo_tpu.ops import quant as jax_quant  # noqa: E402
from nemo_tpu_torch.interop.jax_params import export_jax_variables, load_jax_variables  # noqa: E402,E501
from nemo_tpu_torch.llm.api import ptq  # noqa: E402
from nemo_tpu_torch.models.llm import generate  # noqa: E402
from nemo_tpu_torch.models.llm import gpt  # noqa: E402
from nemo_tpu_torch.models.llm.config import tiny_test  # noqa: E402
from nemo_tpu_torch.models.llm.train import GPTTrainModule  # noqa: E402
from nemo_tpu_torch.ops import quant  # noqa: E402

CACHES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _seeded_params(cfg, seed=0):
    """The JAX model's parameter tree with values from numpy: normal(0.02)
    kernels and embedding, RMSNorm scales 1 + 0.1 cos (off 1, so that a
    misplaced scale shows)."""
    abstract = jax.eval_shape(lambda r: nn.meta.unbox(jax_gpt.GPTModel(cfg).init(
        r, jnp.zeros((1, 8), jnp.int32))["params"]), jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def leaf(path, spec):
        if path[-1].key == "scale":
            return (1 + 0.1 * np.cos(np.arange(np.prod(spec.shape)))).reshape(spec.shape)
        return rng.normal(0.0, 0.02, spec.shape)

    return jax.tree_util.tree_map_with_path(lambda p, s: leaf(p, s).astype(np.float32), abstract)


@pytest.fixture(scope="module")
def params():
    return _seeded_params(jax_tiny())


def _prompts(seed, lengths, high=100):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, high, n)) for n in lengths]


def _port_engine(params, cache="bfloat16", **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_buckets", (8, 16))
    return generate.ContinuousBatchingEngine(tiny_test(), params, cache_dtype=CACHES[cache][1],
                                             device="cpu", **kw)


# --------------------------------------------------------------------------
# the model with a cache, and the int8 pieces
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_prefill_and_decode_logits_and_caches_match_jax(params, cache):
    """Prefill of 2 left-padded prompts (an int write index, kv_valid), then
    three decode steps by each route: a [B] index with kv_valid (write, then
    attend) and without (attend, then write: `_decode_attention`). Logits
    within 1e-4 of JAX's; the caches within 1e-6 (bf16), int8 entries equal
    and scales within 1e-6 relative."""
    cfg, jcache, pcache = jax_tiny(), *CACHES[cache]
    jmodel = jax_gpt.GPTModel(cfg)
    port = generate.serving_model(tiny_test(), params, torch.device("cpu"))
    rng = np.random.RandomState(1)
    B, S, T = 2, 8, 16
    tokens = rng.randint(1, 128, (B, S)).astype(np.int32)
    pad = np.array([3, 0])
    positions = np.maximum(np.arange(S)[None] - pad[:, None], 0).astype(np.int32)
    kv_valid = np.zeros((B, T), bool)
    kv_valid[:, :S] = np.arange(S)[None] >= pad[:, None]
    jc = jax_gpt.init_kv_caches(cfg, B, T, jcache)
    pc = gpt.init_kv_caches(tiny_test(), B, T, pcache)
    want, jc = jmodel.apply({"params": params}, jnp.asarray(tokens), jnp.asarray(positions),
                            kv_caches=jc, decode_index=0, kv_valid=jnp.asarray(kv_valid))
    with torch.no_grad():
        got, pc = port(torch.from_numpy(tokens).long(), torch.from_numpy(positions).long(),
                       kv_caches=pc, decode_index=0, kv_valid=torch.from_numpy(kv_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    cl = np.array([S, S])
    for step, with_valid in enumerate([True, False, True, False]):
        tok = rng.randint(1, 128, (B, 1)).astype(np.int32)
        pos = (cl - pad)[:, None].astype(np.int32)
        valid = np.arange(T)[None] <= cl[:, None] if with_valid else None
        want, jc = jmodel.apply({"params": params}, jnp.asarray(tok), jnp.asarray(pos),
                                kv_caches=jc, decode_index=jnp.asarray(cl, jnp.int32),
                                kv_valid=None if valid is None else jnp.asarray(valid))
        with torch.no_grad():
            got, pc = port(torch.from_numpy(tok).long(), torch.from_numpy(pos).long(),
                           kv_caches=pc, decode_index=torch.from_numpy(cl),
                           kv_valid=None if valid is None else torch.from_numpy(valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0,
                                   err_msg=f"step {step}")
        cl = cl + 1
    for j, p in zip(jax.tree.leaves(jc), _leaves(pc)):
        j = np.asarray(j)
        if j.dtype == np.int8:
            assert np.array_equal(p.numpy(), j)
        else:
            np.testing.assert_allclose(p.float().numpy(), j.astype(np.float32), rtol=1e-6,
                                       atol=1e-6)


def _leaves(caches):
    """The tensors of a port cache pair in jax.tree.leaves' order (dict keys
    sorted: "q" before "s")."""
    return [t for side in caches
            for t in ([side[k] for k in sorted(side)] if isinstance(side, dict) else [side])]


def test_quantize_kv_matches_jax_byte_for_byte():
    """`_quantize_kv` of random k/v rows, of rows with exact halves after
    scaling (round half to even) and of a zero row: int8 equal, scales equal."""
    rng = np.random.RandomState(2)
    x = rng.normal(0, 3, (2, 5, 3, 16)).astype(np.float32)
    x[0, 0, 0] = [127.0, 2.5, -3.5, 0.5, 1.5, -0.5, 126.5, -126.5] * 2  # scale 1: exact halves
    x[1, 1, 1] = 0.0
    for dtype in (np.float32, jnp.bfloat16):
        xj = jnp.asarray(x).astype(dtype)
        qj, sj = jax_gpt._quantize_kv(xj)
        qp, sp = gpt._quantize_kv(torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
            torch.float32 if dtype == np.float32 else torch.bfloat16))
        assert qp[0, 0, 0, :4].tolist() == [127, 2, -4, 0]  # half to even
        assert qp.dtype == torch.int8 and np.array_equal(qp.numpy(), np.asarray(qj))
        assert np.array_equal(sp.numpy(), np.asarray(sj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_dense_int8_ptq_matches_jax(dtype):
    """QuantDense int8_ptq (x @ qkernel, then × scale, in the compute dtype)
    over split axes (contract (4, 8) → features (16,)), fp32 and bf16: the
    port's output equals JAX's within 1e-6 (fp32) or one bf16 step (2**-7
    relative)."""
    rng = np.random.RandomState(3)
    x = rng.normal(0, 1, (3, 5, 4, 8)).astype(np.float32)
    qk = rng.randint(-127, 128, (4, 8, 16)).astype(np.int8)
    sc = rng.uniform(0.001, 0.01, (1, 1, 16)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    mod = jax_quant.QuantDense(features=16, mode="int8_ptq", axis=(-2, -1), dtype=jdt)
    want = np.asarray(mod.apply({"params": {"qkernel": qk, "scale": sc}},
                                jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    port = quant.QuantDense((4, 8), (16,))
    with torch.no_grad():
        port.qkernel.copy_(torch.from_numpy(qk.reshape(32, 16)))
        port.scale.copy_(torch.from_numpy(sc.reshape(16)))
    xp = torch.from_numpy(np.array(jnp.asarray(x).astype(jdt).astype(jnp.float32)))
    got = port(xp.reshape(3, 5, 32).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else dict(atol=1e-3, rtol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), want.reshape(3, 5, 16), **tol)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_ptq_and_converter_match_jax_both_ways(params, scan_layers):
    """The port's `ptq(algorithm="int8_serve")` of an fp32 tree (scanned and
    unrolled) equals JAX's: the same tree, int8 leaves equal, scales equal to
    fp32 rounding (1e-7 relative), other leaves equal; the int8 tree loads
    into the port's int8_ptq model and exports back unchanged (int8 kept
    int8), and a missing or an extra key raises. Weight-only
    `quantize_params_int8` and `dequantize_params` match JAX's too."""
    cfg = jax_tiny(scan_layers=scan_layers, share_embeddings_and_output_weights=False)
    src = _seeded_params(cfg, seed=4)
    jcfg, want = jax_quant.ptq_params_for_serving(cfg, src)
    pcfg, got = ptq(tiny_test(scan_layers=scan_layers, share_embeddings_and_output_weights=False),
                    src, algorithm="int8_serve")
    assert pcfg == dataclasses.replace(tiny_test(scan_layers=scan_layers,
                                                 share_embeddings_and_output_weights=False),
                                       quantization="int8_ptq")
    want = jax.device_get(want)
    assert jax.tree.structure(want) == jax.tree.structure(jax.tree.map(np.asarray, got))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        assert g.dtype == {np.dtype(np.int8): torch.int8,
                           np.dtype(np.float32): torch.float32}[w.dtype], path
        if w.dtype == np.int8:
            assert np.array_equal(g.numpy(), w), path
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-7, atol=0, err_msg=str(path))
    assert any(p[-1].key == "qkernel" for p, _ in jax.tree_util.tree_leaves_with_path(want))
    assert "qkernel" in want["lm_head"]  # the untied head is int8-resident

    with torch.device("meta"):
        model = gpt.GPTModel(pcfg)
    model.to_empty(device="cpu")
    load_jax_variables(model, {"params": want})
    back = export_jax_variables(model)["params"]
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    extra = {**want, "bogus": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="does not take"):
        load_jax_variables(model, {"params": extra})
    with pytest.raises(KeyError, match="missing"):
        load_jax_variables(model, {"params": {k: v for k, v in want.items() if k != "lm_head"}})

    wq = jax.device_get(jax_quant.quantize_params_int8(src))
    pq = quant.quantize_params_int8(src)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(wq), jax.tree.leaves(pq)):
        assert np.array_equal(g.numpy(), w) if w.dtype == np.int8 else np.allclose(
            g.numpy(), w, rtol=1e-7, atol=0), path
    for w, g in zip(jax.tree.leaves(jax_quant.dequantize_params(wq, jnp.float32)),
                    jax.tree.leaves(quant.dequantize_params(pq, torch.float32))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-7, atol=0)


def test_int8_ptq_model_logits_match_jax(params):
    """The int8_ptq model (tied head on the embedding, every projection a
    QuantDense) from the port's own `ptq`: logits within 1e-5 of JAX's on the
    tree JAX's `ptq` makes, and the training module refuses it, as JAX's
    (train.py:91-94)."""
    cfg_q, jparams = jax_quant.ptq_params_for_serving(jax_tiny(), params)
    pcfg, pparams = ptq(tiny_test(), params, algorithm="int8_serve")
    tokens = np.random.RandomState(5).randint(0, 128, (2, 12)).astype(np.int32)
    want = np.asarray(jax_gpt.GPTModel(cfg_q).apply({"params": jparams}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = generate.serving_model(pcfg, pparams, torch.device("cpu"))(
            torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="int8_ptq"):
        GPTTrainModule(pcfg, device="cpu")


def test_temp_sample_filter_matches_jax(monkeypatch):
    """`_temp_sample`'s filtered logits (per-row temperature, top-k, top-p)
    equal JAX's `masked` tensor exactly; each sampled token lies in its row's
    kept set; greedy rows are argmax."""
    rng = np.random.RandomState(6)
    logits = (rng.randn(6, 50) * 3).astype(np.float32)
    temps = np.array([1.0, 1.0, 0.0, 0.7, 1.3, 1.0], np.float32)
    top_k = np.array([1, 0, 0, 5, 3, 0], np.int32)
    top_p = np.array([0.0, 0.3, 0.0, 0.9, 0.5, 0.0], np.float32)
    seen = []
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, x, axis=-1: seen.append(np.asarray(x)) or jnp.argmax(x, axis))
    jax_generate._temp_sample(jnp.asarray(logits), jax.random.PRNGKey(0), temps, top_k, top_p)
    want = seen[-1]
    scaled = torch.from_numpy(logits) / torch.clamp_min(torch.from_numpy(temps)[:, None], 1e-6)
    got = generate._filter_logits(scaled, torch.from_numpy(top_k).long(),
                                  torch.from_numpy(top_p))
    assert np.array_equal(got.numpy(), want)
    kept = want > -1e29
    for seed in range(8):
        tok = generate._temp_sample(torch.from_numpy(logits), generate._generator(
            torch.device("cpu"), seed), temps, top_k, top_p).numpy()
        assert all(kept[r, t] for r, t in enumerate(tok) if temps[r] > 0)
        assert tok[2] == logits[2].argmax() and tok[0] == logits[0].argmax()


# --------------------------------------------------------------------------
# the engines against JAX's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_batch_engine_matches_jax(params, cache):
    """GenerationEngine (left-padded prompts, kv_valid): greedy tokens equal
    JAX's, with an EOS cut on one row."""
    prompts = _prompts(0, (5, 9, 3))
    sp = dict(greedy=True, max_new_tokens=6)
    want = jax_generate.GenerationEngine(jax_tiny(), params, cache_dtype=CACHES[cache][0]
                                         ).generate_tokens(prompts, jax_generate.SamplingParams(**sp))
    port = generate.GenerationEngine(tiny_test(), params, cache_dtype=CACHES[cache][1],
                                     device="cpu")
    assert port.generate_tokens(prompts, generate.SamplingParams(**sp)) == want
    eos = want[1][3]
    cut = port.generate_tokens(prompts, generate.SamplingParams(eos_id=eos, **sp))
    assert cut[1] == want[1][:want[1].index(eos)]


def _drive(eng):
    """Register a prefix, admit three prompts (one on the prefix, one of 20
    tokens in chunks of 16 and 4, one short), 4 single steps, 6 multi-step
    tokens: every token and the write rows."""
    prompts = _prompts(8, (14, 20, 3))
    prefix = prompts[0][:9]
    eng.register_prefix(prefix)
    feed = np.zeros(4, np.int32)
    for s, p in enumerate(prompts):
        feed[s] = eng.prefill_slot(s, p)
    active = np.array([True, True, True, False])
    out = [list(feed)]
    for i in range(4):
        feed = np.asarray(eng.decode_step(feed, active, seed=i)).astype(np.int32)
        out.append(list(feed))
    toks, emitted, act = eng.decode_steps(feed, active, n_steps=6)
    out += [list(r) for r in np.asarray(toks)]
    assert np.asarray(emitted)[:, :3].all() and np.asarray(act)[:3].all()
    return out, [int(c) for c in eng.cur_len]


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_continuous_engine_matches_jax(params, cache):
    """ContinuousBatchingEngine, bf16 and int8 pools: a cached prefix,
    chunked prefill, single steps (write, then attend) and multi-step decode
    (attend, then write): the greedy tokens and write rows equal JAX's."""
    kw = dict(max_slots=4, max_len=64, prefill_buckets=(8, 16))
    want = _drive(jax_generate.ContinuousBatchingEngine(jax_tiny(), params,
                                                        cache_dtype=CACHES[cache][0], **kw))
    got = _drive(_port_engine(params, cache, **kw))
    assert got == want


# --------------------------------------------------------------------------
# the engine's own invariants (tests/test_continuous_batching.py)
# --------------------------------------------------------------------------


def _run_continuous(params, prompts, max_new, stagger=False, cache="bfloat16"):
    eng = _port_engine(params, cache)
    outs = {i: [] for i in range(len(prompts))}
    slots, feed, pending = {}, np.zeros(4, np.int64), list(enumerate(prompts))
    while pending or slots:
        while pending and len(slots) < 4:
            i, p = pending.pop(0)
            s = min(set(range(4)) - set(slots))
            feed[s] = eng.prefill_slot(s, p)
            slots[s] = i
            outs[i].append(int(feed[s]))
            if stagger:
                break
        active = np.asarray([s in slots for s in range(4)])
        nxt = eng.decode_step(feed, active)
        for s in list(slots):
            i = slots[s]
            if len(outs[i]) >= max_new:
                del slots[s]
                eng.free_slot(s)
                feed[s] = 0
                continue
            feed[s] = nxt[s]
            outs[i].append(int(nxt[s]))
    return [outs[i][:max_new] for i in range(len(prompts))]


def test_continuous_matches_batch_engine_and_staggered_admission(params):
    """(test_continuous_batching.py:80, :215) the continuous engine equals
    the batch engine (fp32 cache), and requests admitted one an iteration
    equal requests admitted together."""
    prompts = _prompts(0, (5, 9, 3))
    ref = generate.GenerationEngine(tiny_test(), params, cache_dtype=torch.float32,
                                    device="cpu").generate_tokens(
        prompts, generate.SamplingParams(max_new_tokens=6))
    assert _run_continuous(params, prompts, 6) == ref
    assert _run_continuous(params, prompts[:2], 5, stagger=True) == _run_continuous(
        params, prompts[:2], 5)


def test_decode_steps_match_single_steps_and_eos_freezes(params):
    """(:91, :124) decode_steps gives decode_step's tokens and write rows; a
    slot whose EOS is sampled stops (emitted False, its row frozen) while
    the other runs on."""
    prompts = _prompts(5, (5, 9))

    def admit():
        eng = _port_engine(params, max_slots=2)
        return eng, np.array([eng.prefill_slot(s, p) for s, p in enumerate(prompts)])

    e1, feed = admit()
    active = np.ones(2, bool)
    single, cur = [], feed
    for i in range(6):
        cur = e1.decode_step(cur, active, seed=i)
        single.append(list(cur))
    e2, feed2 = admit()
    toks, emitted, act = e2.decode_steps(feed2, active, n_steps=6)
    assert emitted.all() and act.all()
    assert [list(r) for r in toks] == single and list(e2.cur_len) == list(e1.cur_len)

    e3, feed3 = admit()
    before = e3.cur_len.copy()
    toks, emitted, act = e3.decode_steps(feed3, active, n_steps=5,
                                         eos_id=np.array([single[0][0], -1]))
    assert toks[0, 0] == single[0][0] and emitted[0, 0] and not emitted[1:, 0].any()
    assert (toks[1:, 0] == toks[0, 0]).all()  # the frozen slot repeats its token
    assert emitted[:, 1].all() and act[1] and not act[0]
    assert e3.cur_len[0] == before[0] + 1 and e3.cur_len[1] == before[1] + 5


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_kv_bucketing_is_exact(params, cache):
    """(:154) a pool grown bucket by bucket, across a crossing mid-stream,
    gives the tokens of a full-size pool."""
    prompts = _prompts(7, (5, 9))

    def drive(kvb, split):
        eng = _port_engine(params, cache, max_slots=2, kv_len_buckets=kvb)
        feed = np.array([eng.prefill_slot(s, p) for s, p in enumerate(prompts)])
        out = []
        for n in split:
            toks, emitted, _ = eng.decode_steps(feed, np.ones(2, bool), n_steps=n)
            assert emitted.all()
            out += [list(r) for r in toks]
            feed = toks[-1].copy()
        return out, eng.alloc_len

    full, n_full = drive((64,), (8,))
    crossing, n_crossing = drive((8, 16, 32), (4, 4))
    assert crossing == full and n_full == 64 and n_crossing == 32


def test_chunked_prefill_and_prefix_cache_are_exact_with_an_lru(params):
    """(:347, :372) a 20-token prompt in chunks of 8, 8, 4 equals one chunk of
    32; a registered prefix gives the tokens of a plain prefill; the store
    keeps the `max_prefixes` most recently used."""
    prompt = _prompts(11, (20,), high=128)[0]

    def run(buckets, prefix=None, max_prefixes=8):
        eng = _port_engine(params, max_slots=2, prefill_buckets=buckets,
                           max_prefixes=max_prefixes)
        if prefix:
            eng.register_prefix(prefix)
        feed = np.array([eng.prefill_slot(0, prompt), 0])
        assert eng.cur_len[0] == len(prompt)
        toks = [int(feed[0])]
        for _ in range(6):
            feed = eng.decode_step(feed, np.array([True, False]))
            toks.append(int(feed[0]))
        return eng, toks

    _, single = run((32,))
    assert run((8,))[1] == single
    eng, cached = run((8, 16), prefix=prompt[:8], max_prefixes=2)
    assert cached == single
    eng.register_prefix(prompt[:4])
    eng.register_prefix([5, 6, 7])
    assert len(eng._prefix_store) == 2 and tuple(prompt[:8]) not in eng._prefix_store


def test_int8_cache_generation_with_a_prefix(params):
    """(:408, :424) the int8 pool with a cached prefix gives the first token
    of a plain prefill and keeps slots apart; int8-cache batch generation
    keeps the shapes of the fp32 cache's."""
    prefix = [7, 8, 9, 10]
    eng = _port_engine(params, "int8", max_slots=2, prefill_buckets=(8,))
    eng.register_prefix(prefix)
    t0 = eng.prefill_slot(0, prefix + [11, 12])
    t1 = eng.prefill_slot(1, [3, 4, 5])
    feed = np.array([t0, t1])
    for i in range(4):
        feed = eng.decode_step(feed, np.ones(2, bool), seed=i)
    assert feed.shape == (2,)
    assert _port_engine(params, "int8", max_slots=2, prefill_buckets=(8,)).prefill_slot(
        0, prefix + [11, 12]) == t0
    prompts = _prompts(2, (5, 9))
    sp = generate.SamplingParams(max_new_tokens=6)
    ref, q = (generate.GenerationEngine(tiny_test(), params, cache_dtype=dt, device="cpu")
              .generate_tokens(prompts, sp) for dt in (torch.float32, torch.int8))
    assert [len(o) for o in q] == [len(o) for o in ref] == [6, 6]


@pytest.mark.parametrize("sampled", [dict(temperature=0.0), dict(temperature=1.0, top_k=1),
                                     dict(temperature=1.0, top_p=1e-6)])
def test_a_slot_is_not_moved_by_a_sampled_neighbour(params, sampled):
    """(:259, :292, :316) a greedy slot (temperature 0, or top-k 1, or a tiny
    top-p) decodes the same with and without a temperature-1 neighbour."""
    p_a, p_b = _prompts(3, (6, 6), high=128)

    def run(pair):
        eng = _port_engine(params, prefill_buckets=(8,))
        vec = {k: np.zeros(4, np.float32 if k != "top_k" else np.int64) for k in sampled}
        temps = np.zeros(4, np.float32)
        for k, v in sampled.items():
            vec[k][0] = v
        temps[0] = sampled["temperature"]
        feed = np.zeros(4, np.int64)
        feed[0] = eng.prefill_slot(0, p_a, seed=0, **sampled)
        out = [int(feed[0])]
        active = np.array([True, False, False, False])
        if pair:
            temps[1] = 1.0
            feed[1] = eng.prefill_slot(1, p_b, temperature=1.0, seed=0)
            active[1] = True
        for step in range(8):
            nxt = eng.decode_step(feed, active, temps, seed=step,
                                  **{k: v for k, v in vec.items() if k != "temperature"})
            feed = np.where(active, nxt, feed)
            out.append(int(nxt[0]))
        return out

    assert run(False) == run(True)


def test_unaligned_prefix_chunk_write_does_not_overrun(params):
    """(:502) a 106-token prefix leaves the last chunk's write unaligned; the
    pool grows to span its padded bucket, so the tokens equal a plain
    prefill's, and a write past the cache raises instead of clamping."""
    prompt = _prompts(11, (112,))[0]

    def run(register):
        eng = _port_engine(params, "float32", max_slots=2, max_len=512,
                           prefill_buckets=(32, 64, 128))
        if register:
            eng.register_prefix(prompt[:106])
        t = eng.prefill_slot(0, prompt)
        toks, _, _ = eng.decode_steps(np.array([t, 0]), np.array([True, False]), n_steps=4)
        return [t] + [int(x) for x in toks[:, 0]]

    assert run(True) == run(False)
    c = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="overruns"):
        gpt._cache_write(c, torch.ones(1, 4, 2, 4), 6)


def test_sharded_serving_raises(params):
    """mesh / mesh_cfg (sharded serving, ROADMAP A8) raise."""
    with pytest.raises(NotImplementedError, match="A8"):
        _port_engine(params, mesh_cfg=object())
    with pytest.raises(NotImplementedError, match="A8"):
        generate.GenerationEngine(tiny_test(), params, mesh=object(), device="cpu")
