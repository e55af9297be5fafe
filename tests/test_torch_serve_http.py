"""The port's OpenAI-compatible server (nemo_tpu_torch/serve/openai_server.py)
against the JAX package's, on the CPU, over HTTP on an ephemeral port.

One JAX model, `tiny_test` (fp32, weights drawn once from a numpy seed),
serves every test; the port's server runs it on the CPU with a byte
tokenizer (as tests/test_serve.py's). Greedy completions must equal JAX's
`LLMServer.submit` exactly; `score`'s log-probabilities JAX's within 1e-5.
The routes, streaming, batching of concurrent requests and automatic prefix
caching are held as tests/test_serve.py and test_continuous_batching.py hold
JAX's; the SSM engine, the VLM sidecar and sharded serving raise.
"""

import http.client
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from nemo_tpu.models.llm.config import tiny_test as jax_tiny  # noqa: E402
from nemo_tpu.serve.openai_server import LLMServer as JaxLLMServer  # noqa: E402
from nemo_tpu_torch.models.llm.config import tiny_test  # noqa: E402
from nemo_tpu_torch.models.llm.generate import SamplingParams  # noqa: E402
from nemo_tpu_torch.serve.openai_server import LLMServer  # noqa: E402
from test_torch_serving import _seeded_params  # noqa: E402

SYS = "You are a terse assistant. Answer in one word. " * 2
PROMPTS = ["hello world", SYS + "Q: color of sky?", SYS + "Q: color of grass?"]


class ByteTok:
    def text_to_ids(self, t):
        return [b % 120 for b in t.encode()] or [1]

    def ids_to_text(self, ids):
        return bytes(max(32, min(126, i + 32)) for i in ids).decode(errors="replace")


@pytest.fixture(scope="module")
def params():
    return _seeded_params(jax_tiny(), seed=1)


@pytest.fixture(scope="module")
def server(params):
    srv = LLMServer(tiny_test(), params, ByteTok(), max_slots=4, max_len=128, device="cpu")
    srv.serve(port=0, blocking=False)
    yield srv
    srv.shutdown()
    assert not srv._worker.is_alive()


@pytest.fixture(scope="module")
def jax_answers(params):
    """JAX's LLMServer (worker thread only, no HTTP): greedy completions of
    PROMPTS (4 tokens) and the score of the first."""
    srv = JaxLLMServer(jax_tiny(), params, ByteTok(), max_slots=4, max_len=128)
    srv._worker.start()
    try:
        sp = SamplingParams(max_new_tokens=4)
        return [srv.submit(p, sp) for p in PROMPTS], srv.score(PROMPTS[0])
    finally:
        srv.shutdown()


def _post(srv, path, payload, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
    conn.request("POST", path, raw if raw is not None else json.dumps(payload),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, r.read()


def test_completions_equal_jax_and_score(server, jax_answers):
    """/v1/completions (greedy, 4 tokens) equals JAX's server for each
    prompt; the scoring form (logprobs, max_tokens 0) gives JAX's token
    log-probabilities within 1e-5."""
    texts, (ids, lp) = jax_answers
    for prompt, want in zip(PROMPTS, texts):
        status, body = _post(server, "/v1/completions", {"prompt": prompt, "max_tokens": 4})
        out = json.loads(body)
        assert status == 200 and out["object"] == "text_completion"
        assert out["choices"][0]["text"] == want
    status, body = _post(server, "/v1/completions", {"prompt": PROMPTS[0], "max_tokens": 0,
                                                     "logprobs": 1, "echo": True})
    got = json.loads(body)["choices"][0]
    assert status == 200 and got["text"] == PROMPTS[0] and got["logprobs"]["tokens"] == ids
    assert got["logprobs"]["token_logprobs"][0] is None and lp[0] is None
    np.testing.assert_allclose(got["logprobs"]["token_logprobs"][1:], lp[1:], atol=1e-5, rtol=0)


def test_chat_completions_and_streaming(server):
    """/v1/chat/completions, plain and with `stream` (server-sent events):
    the streamed pieces join to the plain answer, then [DONE]."""
    msg = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4}
    status, body = _post(server, "/v1/chat/completions", msg)
    out = json.loads(body)
    assert status == 200 and out["choices"][0]["message"]["role"] == "assistant"
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
    conn.request("POST", "/v1/chat/completions", json.dumps({**msg, "stream": True}),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 200 and "text/event-stream" in r.getheader("Content-Type", "")
    events = [e for e in r.read().decode().split("\n\n") if e.startswith("data: ")]
    assert events[-1] == "data: [DONE]"
    deltas = [json.loads(e[6:])["choices"][0]["delta"]["content"] for e in events[:-1]]
    assert len(deltas) == 4 and "".join(deltas) == out["choices"][0]["message"]["content"]


def test_models_health_and_bad_requests(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    conn.request("GET", "/v1/models")
    assert json.loads(conn.getresponse().read())["data"][0]["id"] == "nemo-tpu-llm"
    conn.request("GET", "/health")
    assert json.loads(conn.getresponse().read())["status"] == "ok"
    assert _post(server, "/v1/completions", None, raw=b"{not json")[0] == 400
    assert _post(server, "/v1/nothing", {})[0] == 404
    image = {"messages": [{"role": "user", "content": [{"type": "image_url",
                                                        "image_url": "data:,"}]}]}
    assert _post(server, "/v1/chat/completions", image)[0] == 501  # no VLM sidecar


def test_concurrent_requests_are_batched_and_prefix_cached(server, jax_answers):
    """Four concurrent requests all answer, each equal to its answer alone;
    two prompts sharing a 16+-token prefix register it, and the second
    answer on the cached prefix equals JAX's."""
    texts, _ = jax_answers
    results = {}

    def call(i):
        results[i] = _post(server, "/v1/completions",
                           {"prompt": PROMPTS[i % 3], "max_tokens": 4})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    for i, (status, body) in results.items():
        assert status == 200 and json.loads(body)["choices"][0]["text"] == texts[i % 3]
    sp = SamplingParams(max_new_tokens=4)
    assert server.submit(PROMPTS[1], sp) == texts[1]
    ids = ByteTok().text_to_ids(SYS)
    assert any(len(k) >= len(ids) and k[:len(ids)] == tuple(ids)
               for k in server.engine._prefix_store)
    assert server.submit(PROMPTS[2], sp) == texts[2]


def test_quantized_server_and_decode_chunk(params):
    """quantize_weights and quantize_kv_cache serve an int8-resident engine;
    decode_chunk 4 streams the tokens of decode_chunk 1 (budget-capped
    chunks, no overshoot)."""
    outs = {}
    for chunk in (1, 4):
        srv = LLMServer(tiny_test(), params, ByteTok(), max_slots=2, max_len=64,
                        quantize_weights=True, quantize_kv_cache=True, decode_chunk=chunk,
                        device="cpu")
        assert srv.engine.cfg.quantization == "int8_ptq"
        assert srv.engine.caches[0]["q"].dtype == torch.int8
        srv._worker.start()
        try:
            outs[chunk] = srv.submit("hello world", SamplingParams(max_new_tokens=7))
        finally:
            srv.shutdown()
    assert outs[1] == outs[4] and len(outs[1]) == 7


def test_unported_servers_raise(params):
    """The SSM engine, the VLM sidecar and sharded serving raise."""
    with pytest.raises(NotImplementedError, match="SSM"):
        LLMServer(object(), params, ByteTok(), device="cpu")
    with pytest.raises(NotImplementedError, match="VLM"):
        LLMServer(tiny_test(), params, ByteTok(), vlm={}, device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        LLMServer(tiny_test(), params, ByteTok(), mesh_cfg=object(), device="cpu")
