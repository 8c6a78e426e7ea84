"""The port's server-mode rollout (``rollout/server.py``) and API reward
client against the JAX package's, on the CPU.

One JAX init feeds both servers through ``params_from_numpy`` (f32, 2
layers, D=32, vocab 300, an untied lm head: with the tied one, greedy
decoding of random weights repeats the prompt's last token whatever the
weights). Greedy tokens must be equal and logprobs agree
within 1e-5 (summation order only); HTTP responses must be equal as JSON.
The port's differences by design are held here too: params are read after
the queue is polled, so a request submitted after ``update_params`` returns
is served by the new params, and an exception in the serving thread reaches
every pending future and every later ``submit``.
"""

import dataclasses
import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.algorithms.rewards import api_reward as japi
from rlinf_tpu.data.tokenizers import ByteTokenizer as JTokenizer
from rlinf_tpu.models.llm import LLMConfig as JConfig
from rlinf_tpu.models.llm import SamplingParams as JSampling
from rlinf_tpu.models.llm import generate as jgenerate
from rlinf_tpu.models.llm import init_params as jinit_params
from rlinf_tpu.rollout import server as jserver
from rlinf_tpu.rollout.continuous_engine import ContinuousBatchingEngine as JEngine
from rlinf_tpu_torch.algorithms.rewards import api_reward as tapi
from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.models.llm.sampler import SamplingParams
from rlinf_tpu_torch.rollout import server as tserver
from rlinf_tpu_torch.rollout.continuous_engine import ContinuousBatchingEngine

torch.set_num_threads(2)

JCFG = JConfig(vocab_size=300, hidden_size=32, intermediate_size=64, num_layers=2,
               num_heads=2, num_kv_heads=2, max_seq_len=256, dtype="float32",
               qkv_bias=False, rope_theta=1e4, tie_word_embeddings=False)
TCFG = LLMConfig(**dataclasses.asdict(JCFG))
SP = dict(max_new_tokens=8, greedy=True, eos_token_id=-1, pad_token_id=0)
ENGINE = dict(num_slots=3, max_seq_len=64, prompt_bucket=16, decode_chunk=4)
LP_TOL = 1e-5


def _port_params(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, device="cpu")


def _port_engine(**kw):
    return ContinuousBatchingEngine(TCFG, SamplingParams(**SP), device="cpu", **{**ENGINE, **kw})


@pytest.fixture(scope="module")
def servers():
    jp = jinit_params(JCFG, jax.random.PRNGKey(0))
    js = jserver.GenerationServer(JEngine(JCFG, JSampling(**SP), **ENGINE), jp, seed=0)
    ts = tserver.GenerationServer(_port_engine(), _port_params(jp), seed=0)
    js.start()
    ts.start()
    yield jp, js, ts
    js.stop()
    ts.stop()


def _static_greedy(params, prompt):
    out = jgenerate(params, JCFG, jax.random.PRNGKey(0), jnp.asarray([prompt], jnp.int32),
                    jnp.ones((1, len(prompt)), bool), JSampling(**SP))
    return [int(t) for t in np.asarray(out.response_ids)[0, :int(out.response_lengths[0])]]


def test_greedy_tokens_match_jax_generate_and_server(servers):
    """7 prompts through 3 slots (slot reuse): tokens equal the JAX static
    ``generate`` and the JAX server's; logprobs within 1e-5 of the JAX
    server's."""
    jp, js, ts = servers
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, 300, size=rng.integers(3, 15)))) for _ in range(7)]
    tf = [ts.submit(p) for p in prompts]
    jf = [js.submit(p) for p in prompts]
    for p, t, j in zip(prompts, tf, jf):
        got, want = t.result(timeout=300), j.result(timeout=300)
        assert got["tokens"] == [int(x) for x in want["tokens"]] == _static_greedy(jp, p)
        np.testing.assert_allclose(got["logprobs"], want["logprobs"], atol=LP_TOL)


@pytest.mark.parametrize("budget", [1, 3, 8, 20])
def test_per_request_budget(servers, budget):
    """A request's budget caps its tokens (at most the engine's 8), as in
    the JAX server."""
    _, js, ts = servers
    got = ts.generate([5, 6, 7], max_new_tokens=budget)["tokens"]
    want = js.generate([5, 6, 7], max_new_tokens=budget)["tokens"]
    assert len(got) == min(budget, SP["max_new_tokens"])
    assert got == [int(x) for x in want]


def test_weight_swap_cannot_race():
    """The client updates the params and submits at the very moment the
    serving loop polls its queue (injected into ``get_nowait``): the
    request is still prefilled and decoded with the new params, and its
    tokens equal the JAX ``generate`` on them."""
    jp = jinit_params(JCFG, jax.random.PRNGKey(0))
    new_jp = jinit_params(JCFG, jax.random.PRNGKey(1))
    server = tserver.GenerationServer(_port_engine(), _port_params(jp), seed=0)
    prompt = [9, 8, 7, 6]
    assert _static_greedy(new_jp, prompt) != _static_greedy(jp, prompt)
    q = server._queue
    real_get, armed, futures = q.get_nowait, threading.Event(), []

    def get_nowait():
        if armed.is_set():
            armed.clear()
            server.update_params(_port_params(new_jp))
            futures.append(server.submit(prompt))
        return real_get()

    q.get_nowait = get_nowait
    server.start()
    try:
        assert server.generate([1, 2, 3])["tokens"] == _static_greedy(jp, [1, 2, 3])
        armed.set()
        while not futures:
            threading.Event().wait(0.01)
        assert futures[0].result(timeout=300)["tokens"] == _static_greedy(new_jp, prompt)
    finally:
        server.stop()


def test_render_chat_matches_jax():
    for msgs in ([], [{"role": "user", "content": "yo"}],
                 [{"role": "system", "content": "be brief"}, {"content": "2+2?"},
                  {"role": "assistant"}, {"role": "user", "content": "ünï"}]):
        assert tserver._render_chat(msgs) == jserver._render_chat(msgs)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _http_stack(mod, gen_server, tokenizer):
    http = mod.OpenAIHTTPServer(gen_server, tokenizer)
    http.start()
    router = mod.RouterServer([http.url])
    router.start()
    return http, router


def test_openai_http_and_router_match_jax(servers):
    """The same JSON bodies to /v1/completions and /v1/chat/completions
    through each package's RouterServer -> OpenAIHTTPServer give equal
    responses; /health answers on both servers and routers."""
    _, js, ts = servers
    stacks = {"jax": _http_stack(jserver, js, JTokenizer()),
              "torch": _http_stack(tserver, ts, ByteTokenizer())}
    try:
        bodies = [("/v1/completions", {"prompt": "hi", "max_tokens": 4}),
                  ("/v1/completions", {"prompt": "The answer is"}),
                  ("/v1/chat/completions",
                   {"messages": [{"role": "user", "content": "yo"}], "max_tokens": 2}),
                  ("/v1/chat/completions",
                   {"messages": [{"role": "system", "content": "s"},
                                 {"role": "user", "content": "q"}]})]
        for path, body in bodies:
            got = _post(stacks["torch"][1].url + path, body)
            want = _post(stacks["jax"][1].url + path, body)
            assert got == want, (path, body)
            n = body.get("max_tokens", SP["max_new_tokens"])
            assert got["usage"]["completion_tokens"] == n
        assert _get(stacks["torch"][1].url + "/health") == {"status": "ok", "backends": 1}
        health = _get(stacks["torch"][0].url + "/health")
        assert health["status"] == "ok" and health["served"] >= len(bodies)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(stacks["torch"][1].url + "/v1/nothing", {})
        assert e.value.code == 502    # the backend's 404, seen through the router
    finally:
        for http, router in stacks.values():
            router.stop()
            http.stop()


class _FailingEngine(ContinuousBatchingEngine):
    """Raises in its second decode chunk."""

    calls = 0

    def decode_and_harvest(self, *a):
        self.calls += 1
        if self.calls == 2:
            raise RuntimeError("kernel launch failed")
        return super().decode_and_harvest(*a)


def test_serving_thread_error_reaches_every_future():
    """An exception in ``decode_and_harvest`` fails the in-flight and the
    queued requests (5 requests, 3 slots) and every later submit with that
    exception; the thread ends."""
    jp = jinit_params(JCFG, jax.random.PRNGKey(0))
    eng = _FailingEngine(TCFG, SamplingParams(**SP), device="cpu", **ENGINE)
    server = tserver.GenerationServer(eng, _port_params(jp))
    futures = [server.submit([3, 4, 5 + i]) for i in range(5)]
    server.start()
    for f in futures:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            f.result(timeout=60)
    server._thread.join(timeout=60)
    assert not server._thread.is_alive()
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        server.submit([1, 2]).result(timeout=1)
    server.stop()


def test_stop_fails_inflight_and_queued_requests():
    """``stop()`` while a decode chunk runs: the in-flight request (1 slot)
    and the 2 queued ones fail with "server stopped", as later submits do."""
    jp = jinit_params(JCFG, jax.random.PRNGKey(0))
    eng = _port_engine(num_slots=1)
    entered, go = threading.Event(), threading.Event()
    real = eng.decode_and_harvest

    def blocked(*a):
        entered.set()
        go.wait(60)
        return real(*a)

    eng.decode_and_harvest = blocked
    server = tserver.GenerationServer(eng, _port_params(jp))
    futures = [server.submit([3, 4, 5 + i]) for i in range(3)]
    server.start()
    assert entered.wait(60)
    stopper = threading.Thread(target=server.stop)
    stopper.start()
    while not server._stop.is_set():
        threading.Event().wait(0.01)
    go.set()
    stopper.join(60)
    for f in futures:
        with pytest.raises(RuntimeError, match="server stopped"):
            f.result(timeout=1)
    with pytest.raises(RuntimeError, match="server stopped"):
        server.submit([1]).result(timeout=1)


# ---------------------------------------------------------------------------
# API reward client
# ---------------------------------------------------------------------------


class _Judge(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        text = json.loads(self.rfile.read(n))["messages"][-1]["content"]
        score = 1.0 if "good" in text else 0.0
        resp = json.dumps({"choices": [{"message": {
            "role": "assistant", "content": f"Verdict. Score: {score}"}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(resp)))
        self.end_headers()
        self.wfile.write(resp)


def test_api_reward_client_against_a_stub_judge():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Judge)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        payloads = [[{"role": "user", "content": c}]
                    for c in ("this is good", "this is bad", "also good stuff")]
        got = tapi.APIRewardClient(url).score_batch(payloads)
        assert got == japi.APIRewardClient(url).score_batch(payloads) == [1.0, 0.0, 1.0]
        assert tapi.APIRewardClient(url).score_batch([]) == []
    finally:
        httpd.shutdown()
        httpd.server_close()
    with pytest.raises(RuntimeError, match="API reward request failed"):
        tapi.APIRewardClient(url, max_retries=0, timeout=2).score_one([])


@pytest.mark.parametrize("text", ["on a 0-1 scale: 0.75", "no numbers", "-3 then 7",
                                  "Score: 10.", "1.5.2"])
def test_score_parser_and_data_url_match_jax(text):
    assert tapi.default_score_parser(text) == japi.default_score_parser(text)
    frame = text.encode()
    assert tapi.frame_to_data_url(frame) == japi.frame_to_data_url(frame)
    assert tapi.frame_to_data_url(frame, "image/jpeg") == japi.frame_to_data_url(
        frame, "image/jpeg")


def test_api_reward_client_against_the_ports_own_server(servers):
    """Each package's client scores 4 chat payloads against its own
    package's OpenAI server: equal scores (the judge's replies are the
    greedy texts of the same params)."""
    _, js, ts = servers
    payloads = [[{"role": "user", "content": f"rate answer {i}"}] for i in range(4)]
    scores = {}
    for name, mod, api, gen, tok in (("jax", jserver, japi, js, JTokenizer()),
                                     ("torch", tserver, tapi, ts, ByteTokenizer())):
        http = mod.OpenAIHTTPServer(gen, tok)
        http.start()
        try:
            scores[name] = api.APIRewardClient(http.url, max_workers=4).score_batch(
                payloads, max_tokens=6)
        finally:
            http.stop()
    assert scores["torch"] == scores["jax"] and len(scores["torch"]) == 4


def test_the_serving_thread_runs_in_inference_mode():
    """Grad mode is thread-local and the pool-core calls are not decorated:
    the serving thread enters inference mode itself, so no decode chunk
    records an autograd graph, even over params that require grad."""
    jp = jinit_params(JCFG, jax.random.PRNGKey(0))
    params = _port_params(jp)
    for t in (params["embed"], params["final_norm"]):
        t.requires_grad_(True)
    eng = _port_engine()
    seen = []
    real = eng.decode_and_harvest

    def watched(pool, *a):
        seen.append(torch.is_inference_mode_enabled())
        out = real(pool, *a)
        seen.append(pool.kv_layers[0][0].requires_grad)
        return out

    eng.decode_and_harvest = watched
    server = tserver.GenerationServer(eng, params)
    server.start()
    try:
        assert len(server.generate([4, 5, 6])["tokens"]) == SP["max_new_tokens"]
    finally:
        server.stop()
    assert seen and seen[0::2] == [True] * (len(seen) // 2) and not any(seen[1::2])
    assert not torch.is_inference_mode_enabled()
