"""The port's HTTP server over its paged and contiguous engines, on the CPU.

A dense tiny Llama (the JAX package's init_params, carried into the port)
is served on port 0; every reply is held to the same engine run directly:
token streams equal. The tokenizer endpoints use the port's copy of the
GGUF tokenizer, held to the JAX package's on the same vocab. Sampled,
penalized, logprob and n > 1 requests are served (deterministic ones equal
the engine run directly with the same settings)."""

import concurrent.futures
import dataclasses
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


def _direct(kind, params, cfg, prompts, max_new, sampling=None, logprobs=0):
    """The requests run on a fresh engine: their token lists, or their
    Requests when ``sampling`` (one SamplingParams for all, or a list) or
    ``logprobs`` is given."""
    eng = _engine(kind, params, cfg)
    sps = sampling if isinstance(sampling, list) else [sampling] * len(prompts)
    uids = [eng.submit(np.asarray(p), max_new_tokens=max_new, sampling_params=sp,
                       logprobs=logprobs) for p, sp in zip(prompts, sps)]
    done = {r.uid: r for r in eng.run_until_done()}
    if sampling is None and not logprobs:
        return [done[u].output for u in uids]
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
def test_sampled_requests_answer_200(http_server, path, payload):
    """The requests the greedy-only server refused (sampling, penalties,
    logprobs, n > 1) are served; the deterministic ones equal the engine
    run directly with the same settings."""
    kind, params, cfg, addr = http_server
    out = _post(addr, path, payload)
    if path == "/completion":
        toks = out["tokens"]
        assert toks and all(0 <= t < VOCAB for t in toks) and out["finish_reason"] == "length"
        sp = server._sampling_from_json(payload)
        if sp is None or sp.is_greedy:  # deterministic: the engine's own tokens
            assert toks == _direct(kind, params, cfg, [payload["prompt_tokens"]], 64, sp,
                                   logprobs=payload.get("logprobs", 0))[0].output
        if "logprobs" in payload:  # JAX's shape: one entry per token, top-n dicts
            lp = out["logprobs"]
            assert len(lp["token_logprobs"]) == len(lp["top"]) == len(toks)
            for chosen, top, t in zip(lp["token_logprobs"], lp["top"], toks):
                assert [sorted(d) for d in top] == [["id", "logprob"]] * 2
                assert chosen == top[0]["logprob"] >= top[1]["logprob"]
                assert top[0]["id"] == t  # greedy: the chosen token is the top one
    else:
        choices = out["choices"]
        assert [c["index"] for c in choices] == list(range(payload.get("n", 1)))
        for c in choices:
            assert c["message"]["role"] == "assistant" and isinstance(c["message"]["content"], str)
            assert c["finish_reason"] in ("length", "stop")
        assert out["usage"]["completion_tokens"] > 0


def test_chat_n_seeded_choices_and_logprobs(http_server):
    """A seeded sampled chat with n = 2 and logprobs: the two choices
    differ (seeds s and s + 1), a second call repeats both, and each
    token's logprob is the engine's own for the same request."""
    kind, params, cfg, addr = http_server
    payload = {"messages": [{"role": "user", "content": "hello"}], "n": 2, "temperature": 1.0,
               "top_k": 40, "seed": 11, "max_tokens": 8, "logprobs": True, "top_logprobs": 3}
    first = _post(addr, "/v1/chat/completions", payload)
    again = _post(addr, "/v1/chat/completions", payload)
    jtok = JaxTokenizer(**_tok_args())
    prompt = jtok.encode("<user>hello<assistant>")
    sp = server._sampling_from_json(payload)
    direct = _direct(kind, params, cfg, [prompt, prompt], 8,
                     [dataclasses.replace(sp, seed=11), dataclasses.replace(sp, seed=12)],
                     logprobs=3)
    # the contiguous engine may reuse a slot's KV prefix (an earlier chat's),
    # which moves logits in their last bits: logprobs are held to 1e-5
    for reply in (first, again):
        assert [c["index"] for c in reply["choices"]] == [0, 1]
        for choice, req in zip(reply["choices"], direct):
            assert choice["message"]["content"] == jtok.decode(req.output)
            content = choice["logprobs"]["content"]
            assert len(content) == len(req.output) == len(req.logprob_data) == 8
            assert [e["token"] for e in content] == [jtok.decode([t]) for t in req.output]
            for e, (chosen, ids, vals) in zip(content, req.logprob_data):
                assert abs(e["logprob"] - chosen) <= 1e-5
                assert [t["token"] for t in e["top_logprobs"]] == [jtok.decode([i]) for i in ids]
                np.testing.assert_allclose([t["logprob"] for t in e["top_logprobs"]], vals,
                                           rtol=0, atol=1e-5)
    assert direct[0].output != direct[1].output  # seeds 11 and 12 draw apart


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

    def submit(self, prompt, max_new_tokens, sampling_params=None, logprobs=0):
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
