"""The port's HTTP server over its paged and contiguous engines, on the CPU.

A dense tiny Llama (the JAX package's init_params, carried into the port)
is served on port 0; every reply is held to the same engine run directly:
token streams equal. The tokenizer endpoints use the port's copy of the
GGUF tokenizer, held to the JAX package's on the same vocab."""

import concurrent.futures
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from gptq_gguf_tpu.models import llama as jl
from gptq_gguf_tpu.serving.tokenizer import GGUFTokenizer as JaxTokenizer
from gptq_gguf_tpu_torch.models import llama
from gptq_gguf_tpu_torch.serving import engine, server
from gptq_gguf_tpu_torch.serving.tokenizer import _BYTE_ENC, GGUFTokenizer

RNG = np.random.default_rng(71)
VOCAB = 320


def _tok_args():
    """A byte-level BPE vocab: the 256 byte symbols plus a few merges."""
    tokens = [_BYTE_ENC[b] for b in range(256)] + ["he", "ll", "hell", "hello", "Ġw", "Ġwor"]
    merges = ["h e", "l l", "he ll", "hell o", "Ġ w", "Ġw o", "Ġwo r"]
    return dict(model="gpt2", tokens=tokens, merges=merges, eos_id=5,
                chat_template="{% for m in messages %}<{{ m['role'] }}>{{ m['content'] }}"
                              "{% endfor %}{% if add_generation_prompt %}<assistant>{% endif %}")


def _model():
    jcfg = jl.LlamaConfig(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
                          num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2)
    cfg = llama.config_from_reference(jcfg)
    params = llama.dense_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jl.init_params(jcfg, seed=29)), cfg, device="cpu")
    return params, cfg


def _engine(kind, params, cfg):
    if kind == "paged":
        return engine.PagedContinuousBatchingEngine(params, cfg, num_slots=2, max_len=64,
                                                    page_size=16, device="cpu")
    return engine.ContinuousBatchingEngine(params, cfg, num_slots=2, max_len=64)


@pytest.fixture(scope="module", params=["paged", "contiguous"])
def http_server(request):
    params, cfg = _model()
    tok = server.wrap_gguf_tokenizer(GGUFTokenizer(**_tok_args()))
    srv, runner = server.serve_http(_engine(request.param, params, cfg), port=0, block=False,
                                    tokenizer=tok)
    yield request.param, params, cfg, srv.server_address
    srv.shutdown()
    runner.stop()


def _url(addr, path):
    return f"http://{addr[0]}:{addr[1]}{path}"


def _post(addr, path, payload, raw=False):
    req = urllib.request.Request(_url(addr, path), data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        body = r.read()
    return body if raw else json.loads(body)


def _status(addr, path, payload):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(addr, path, payload)
    return e.value.code, json.loads(e.value.read())


def _direct(kind, params, cfg, prompts, max_new):
    eng = _engine(kind, params, cfg)
    uids = [eng.submit(np.asarray(p), max_new_tokens=max_new) for p in prompts]
    done = {r.uid: r.output for r in eng.run_until_done()}
    return [done[u] for u in uids]


def test_health_and_models(http_server):
    _, _, _, addr = http_server
    with urllib.request.urlopen(_url(addr, "/health"), timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(_url(addr, "/v1/models"), timeout=30) as r:
        assert json.loads(r.read())["data"][0]["object"] == "model"


def test_completion_matches_engine(http_server):
    kind, params, cfg, addr = http_server
    prompt = RNG.integers(0, VOCAB, size=(6,)).tolist()
    out = _post(addr, "/completion", {"prompt_tokens": prompt, "max_new_tokens": 5})
    assert out["tokens"] == _direct(kind, params, cfg, [prompt], 5)[0]
    assert out["finish_reason"] in ("length", "stop") and out["latency_s"] >= 0


def test_concurrent_requests(http_server):
    kind, params, cfg, addr = http_server
    prompts = [RNG.integers(0, VOCAB, size=(n,)).tolist() for n in (4, 6, 5, 9)]
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
        outs = list(ex.map(lambda p: _post(addr, "/completion",
                                           {"prompt_tokens": p, "max_new_tokens": 4}), prompts))
    assert [o["tokens"] for o in outs] == _direct(kind, params, cfg, prompts, 4)


def test_bad_requests_answer_400(http_server):
    _, _, _, addr = http_server
    assert _status(addr, "/completion", {})[0] == 400
    assert _status(addr, "/v1/embeddings", {"input": "hi"})[0] == 400
    image = {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,AA=="}}]}]}
    assert _status(addr, "/v1/chat/completions", image)[0] == 400


@pytest.mark.parametrize("path,payload", [
    ("/completion", {"prompt_tokens": [1, 2, 3], "temperature": 0.8}),
    ("/completion", {"prompt_tokens": [1, 2, 3], "repetition_penalty": 1.3}),
    ("/completion", {"prompt_tokens": [1, 2, 3], "logprobs": 2}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello"}],
                              "top_p": 0.9, "temperature": 1.0}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello"}], "n": 2}),
])
def test_unported_requests_answer_501(http_server, path, payload):
    _, _, _, addr = http_server
    code, body = _status(addr, path, payload)
    assert code == 501 and "not ported yet" in body["error"]


def test_stream_chunks_concatenate(http_server):
    kind, params, cfg, addr = http_server
    prompt = RNG.integers(0, VOCAB, size=(7,)).tolist()
    body = _post(addr, "/completion", {"prompt_tokens": prompt, "max_new_tokens": 6,
                                       "stream": True}, raw=True).decode()
    events = [line[len("data: "):] for line in body.split("\n\n") if line]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    tokens = [t for c in chunks for t in c.get("tokens", [])]
    assert tokens == _direct(kind, params, cfg, [prompt], 6)[0]
    assert chunks[-1]["finish_reason"] in ("length", "stop")


def test_text_endpoints_match_jax_tokenizer(http_server):
    _, _, _, addr = http_server
    jtok = JaxTokenizer(**_tok_args())
    text = "hello world, hello"
    ids = _post(addr, "/tokenize", {"content": text})["tokens"]
    assert ids == jtok.encode(text)
    assert _post(addr, "/detokenize", {"tokens": ids})["content"] == jtok.decode(ids) == text
    out = _post(addr, "/completion", {"prompt": text, "max_new_tokens": 3})
    assert len(out["tokens"]) == 3 and out["text"] == jtok.decode(out["tokens"])
    chat = _post(addr, "/v1/chat/completions",
                 {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 3})
    assert chat["choices"][0]["message"]["role"] == "assistant"
    assert chat["usage"]["prompt_tokens"] == len(jtok.encode("<user>hello<assistant>"))


class _FailingEngine:
    """An engine whose step fails as a CUDA fault would."""

    eos = None

    def __init__(self):
        self.slot_req, self.queue, self.completed, self._uid = [None], [], [], 0

    def submit(self, prompt, max_new_tokens, sampling_params=None):
        self._uid += 1
        self.queue.append(self._uid)
        return self._uid

    def step(self):
        if self.queue:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return 0


@pytest.mark.parametrize("stream", [False, True])
def test_engine_failure_ends_requests_with_500(stream):
    srv, runner = server.serve_http(_FailingEngine(), port=0, block=False)
    try:
        addr = srv.server_address
        code, body = _status(addr, "/completion", {"prompt_tokens": [1, 2], "stream": stream,
                                                   "timeout_s": 30})
        assert code == 500 and "illegal memory access" in body["error"]
        assert _status(addr, "/completion", {"prompt_tokens": [1]})[0] == 500  # stopped
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(_url(addr, "/health"), timeout=30)
        assert e.value.code == 500
    finally:
        srv.shutdown()
        runner.stop()
