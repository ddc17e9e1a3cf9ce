"""The port's ``ModelServer`` + ``TextGenerator`` against the reference's,
each on its own engine over the same ``tiny()`` weights (f32, greedy, the
port's with ``"device": "cpu"``).

The same HTTP requests go to both servers: OpenAI completions (plain,
streamed, ``n``, ``stop``), chat completions (plain and streamed), V1
``:predict`` and V2 ``infer``. Bodies must be equal once ids and timestamps
are dropped (these routes carry none today). A stream's chunk boundaries
follow the server's 20 ms poll, so streams are compared by what a client
rebuilds from them: the chunks' object and model fields, each choice's text
joined, and the closing ``[DONE]``.

The reference builds its engine without warmup (each shape compiles at
first use); the port's warms, so its capture gauge stays 0. The helpers
here are shared with ``test_torch_trace.py`` and ``test_torch_traffic.py``.
torch and both packages are imported inside the functions.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

WAIT_S = 120
#: the engine config both servers share: paged pool with chunked admission
#: (the fused prefill+decode path), prefix cache off in both (a prefix hit
#: changes the summation order, and a near-tie could then flip a token)
BASE = {"tokenizer": "bytes", "num_slots": 4, "decode_chunk": 2,
        "block_size": 16, "prefill_budget": 16, "prefix_cache": False,
        "max_new_tokens": 8}


def tiny_weights():
    """(reference tiny cfg, its params as numpy)."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from kubeflow_tpu.models import llama as ref

    cfg = ref.tiny()
    params = ref.Llama(cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    return cfg, jax.tree.map(np.asarray, nn.meta.unbox(params))


def register_both(weights, key: str) -> tuple[str, str]:
    """The weights under ``key`` in both packages' ``mem://`` registries:
    (reference ref, port ref)."""
    import torch

    from kubeflow_tpu.serving import storage as ref_storage
    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.serving import storage

    torch.set_num_threads(1)
    cfg, params = weights
    pcfg = llama.tiny()
    return (ref_storage.register_mem(key, (cfg, params)),
            storage.register_mem(key, (pcfg, convert.state_dict_from_jax(
                params, pcfg))))


def start_server(port: bool, params_ref: str, name: str = "m", **extra):
    """A started ModelServer of one package with a TextGenerator over
    ``params_ref``; ``extra`` overrides ``BASE``."""
    if port:
        from kubeflow_tpu_torch.serving.server import ModelServer
        from kubeflow_tpu_torch.serving.text import TextGenerator
        config = {**BASE, "device": "cpu"}
    else:
        from kubeflow_tpu.serving.server import ModelServer
        from kubeflow_tpu.serving.text import TextGenerator
        config = {**BASE, "warmup_groups": []}
    config.update(params_ref=params_ref, **extra)
    srv = ModelServer()
    srv.register(TextGenerator(name, config))
    return srv.start()


def post(url: str, payload: dict, headers=None):
    """(status, headers, raw body) of a JSON POST."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def get(url: str, headers=None) -> str:
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return r.read().decode()


def strip_volatile(body):
    """A JSON body without ids and timestamps."""
    if isinstance(body, dict):
        return {k: strip_volatile(v) for k, v in body.items()
                if k not in ("id", "created")}
    if isinstance(body, list):
        return [strip_volatile(v) for v in body]
    return body


def rebuild_stream(raw: str) -> dict:
    """What a client rebuilds from an SSE body: the chunks' (object,
    model) pairs, each choice's joined text (``delta.content`` for chat)
    and whether the stream ended with ``[DONE]``."""
    events = [ln[len("data: "):] for ln in raw.split("\n")
              if ln.startswith("data: ")]
    done = bool(events) and events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events if e != "[DONE]"]
    texts: dict[int, str] = {}
    for c in chunks:
        for ch in c["choices"]:
            piece = ch["delta"]["content"] if "delta" in ch else ch["text"]
            texts[ch["index"]] = texts.get(ch["index"], "") + piece
    return {"kinds": sorted({(c["object"], c["model"]) for c in chunks}),
            "texts": texts, "done": done, "nonempty": bool(chunks)}


@pytest.fixture(scope="module")
def servers():
    """(reference server, port server) over the same weights."""
    ref_key, port_key = register_both(tiny_weights(), "torch-text-server")
    ref = start_server(False, ref_key)
    try:
        port = start_server(True, port_key)
    except BaseException:
        ref.stop()
        raise
    yield ref, port
    port.stop()
    ref.stop()


def _both(servers, path, payload):
    return [post(s.url + path, payload) for s in servers]


CHAT = [{"role": "system", "content": "be brief"},
        {"role": "user", "content": "hi there"}]

#: name -> (path, payload, streamed?)
REQUESTS = {
    "completion": ("/openai/v1/completions",
                   {"model": "m", "prompt": "hello world", "max_tokens": 8},
                   False),
    "completion_batch": ("/openai/v1/completions",
                         {"model": "m", "prompt": ["x", "a longer prompt"],
                          "max_tokens": 6}, False),
    "n_2": ("/openai/v1/completions",
            {"model": "m", "prompt": "abc", "max_tokens": 5, "n": 2},
            False),
    "stream": ("/openai/v1/completions",
               {"model": "m", "prompt": "stream me", "max_tokens": 8,
                "stream": True}, True),
    "stream_n_2": ("/openai/v1/completions",
                   {"model": "m", "prompt": "two streams", "max_tokens": 6,
                    "n": 2, "stream": True}, True),
    "chat": ("/openai/v1/chat/completions",
             {"model": "m", "messages": CHAT, "max_tokens": 6}, False),
    "chat_stream": ("/openai/v1/chat/completions",
                    {"model": "m", "messages": CHAT, "max_tokens": 6,
                     "stream": True}, True),
    "v1_predict": ("/v1/models/m:predict",
                   {"instances": ["hi", {"prompt": "ab", "max_tokens": 3}]},
                   False),
    "v2_infer": ("/v2/models/m/infer",
                 {"inputs": [{"name": "text", "shape": [2],
                              "datatype": "BYTES", "data": ["p", "qr"]}]},
                 False),
}


@pytest.mark.parametrize("kind", list(REQUESTS))
def test_bodies_match_reference(servers, kind):
    path, payload, streamed = REQUESTS[kind]
    (rc, rh, rbody), (pc, ph, pbody) = _both(servers, path, payload)
    assert rc == pc == 200, (rbody, pbody)
    if streamed:
        assert ph["Content-Type"] == rh["Content-Type"] == \
            "text/event-stream"
        want, got = rebuild_stream(rbody), rebuild_stream(pbody)
        assert want["nonempty"] and want["done"]
        assert got == want
        # a stream rebuilds exactly the blocking completion
        blocking = dict(payload, stream=False)
        out = json.loads(post(servers[1].url + path, blocking)[2])
        texts = {c["index"]: (c["message"]["content"] if "message" in c
                              else c["text"]) for c in out["choices"]}
        assert got["texts"] == {i: t for i, t in texts.items() if t}
    else:
        assert strip_volatile(json.loads(pbody)) == \
            strip_volatile(json.loads(rbody))


@pytest.mark.parametrize("streamed", [False, True],
                         ids=["blocking", "stream"])
def test_stop_string_matches_reference(servers, streamed):
    """``stop`` cuts at the first occurrence of a string the greedy text is
    known to hold (its third character, read from the reference)."""
    path = "/openai/v1/completions"
    base = {"model": "m", "prompt": "ab", "max_tokens": 8}
    text = json.loads(post(servers[0].url + path, base)[2])[
        "choices"][0]["text"]
    assert len(text) >= 3
    payload = dict(base, stop=text[2], stream=streamed)
    (rc, _, rbody), (pc, _, pbody) = _both(servers, path, payload)
    assert rc == pc == 200
    if streamed:
        got = rebuild_stream(pbody)
        assert got == rebuild_stream(rbody)
        assert got["texts"][0] == text.split(text[2])[0]
    else:
        got = json.loads(pbody)
        assert got == json.loads(rbody)
        assert got["choices"][0]["finish_reason"] == "stop"
        assert got["choices"][0]["text"] == text.split(text[2])[0]


def test_model_metadata_and_health(servers):
    ref, port = servers
    for srv in servers:
        assert json.loads(get(srv.url + "/v2/health/ready")) == \
            {"ready": True}
        assert json.loads(get(srv.url + "/v1/models/m")) == \
            {"name": "m", "ready": True}
    meta = json.loads(get(port.url + "/v2/models/m"))
    assert meta["platform"] == "kubeflow-tpu-torch" and meta["ready"]
    code, _, _ = post(port.url + "/openai/v1/completions",
                      {"model": "ghost", "prompt": "q"})
    assert code == 404


def test_port_engine_captured_nothing_after_warmup(servers):
    """Every request above ran on shapes the port's warmup captured."""
    stats = servers[1].models()["m"].engine.stats()
    assert stats["graph_captures_total"] == 0
    assert stats["tokens_emitted"] > 0
    # /metrics exports engine stats of plain Python numbers only: a
    # tensor or a numpy scalar would be dropped from the scrape silently
    assert all(type(v) in (int, float, bool) for v in stats.values()
               if not isinstance(v, (list, dict, str)))


def test_load_refuses_a_missing_card():
    """Without ``"device"`` the engine goes on the CUDA card; with no card
    ``load`` raises instead of running on the CPU."""
    import torch

    from kubeflow_tpu_torch.serving.text import TextGenerator

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: load() would use it")
    _, port_key = register_both(tiny_weights(), "torch-text-nocard")
    tg = TextGenerator("m", {**BASE, "params_ref": port_key})
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.start()
    assert not tg.ready


def test_prebuilt_gang_engine_is_refused():
    """A serving gang's rank-0 ``GangEngine`` is a ``ContinuousEngine``,
    which ``engine=`` takes; anything that is not a serving engine is
    refused with a ``TypeError`` naming the engines."""
    from kubeflow_tpu_torch.serving.continuous import ContinuousEngine
    from kubeflow_tpu_torch.serving.gang import GangEngine
    from kubeflow_tpu_torch.serving.text import TextGenerator

    assert issubclass(GangEngine, ContinuousEngine)
    with pytest.raises(TypeError, match="GangEngine"):
        TextGenerator("m", {}, engine=object()).load()


def test_chip_smoke_http_phase_runs_on_the_cpu():
    """``chip_smoke.http_serve`` (the card's ``http_serve`` phase) at a tiny
    size on the CPU: every greedy text equal to the engine's own, a
    preemption with the victim's text unchanged, /metrics and /traces, 0
    captures after warmup, 0 leaked blocks, and the MoE model behind the
    same server (no kernel launches on the CPU)."""
    import torch

    import chip_smoke
    from kubeflow_tpu_torch.models import llama

    torch.set_num_threads(1)
    # four layers: slow enough on the CPU that the low class is still
    # decoding when the high request arrives
    cfg = llama.tiny(max_seq_len=256, num_layers=4)
    model = llama.Llama(cfg, device="cpu")
    model.init_weights(0)
    moe_cfg = llama.tiny(max_seq_len=256, moe_experts=4, moe_top_k=2,
                         moe_dispatch="ragged")
    moe = llama.Llama(moe_cfg, device="cpu")
    moe.init_weights(1)
    out = chip_smoke.http_serve(
        cfg, model, moe_cfg, moe, device="cpu",
        sizes=dict(chip_smoke.HTTP, completions=4, streams=2),
        kernels=False)
    assert out["preempt"]["preemptions"] >= 1
    assert out["preempt"]["victims_traced"] >= 1
    assert out["clean"]["captures_after_warmup"] == [0]
    assert out["clean"]["blocks_leaked"] == 0
    assert set(out["http_breakdown_ms"]) >= {
        "accept", "replica.door", "engine.queue", "engine.prefill",
        "engine.decode", "respond", "total"}
    assert out["moe"]["gmm_under_http"] is None
