"""OpenAI-compatible routes (counterpart of localai_tpu/api/openai_routes.py):
/v1/chat/completions and /v1/completions, streamed (SSE) and not, with
the same response fields, plus /v1/models and /readyz. ``"echo": true``
on a non-streamed request returns the rendered prompt followed by the
text, as the JAX backend's ``Predict`` does; a streamed request carries
the text alone, as its ``PredictStream`` does.

Chat prompts render with the JAX package's default chat-message template
(templates/prompts.py DEFAULT_CHAT_MESSAGE, "{Role}: {Content}", messages
joined by "\\n", as api/chatflow.py does), written in plain Python; model
YAML templates and jinja come with a later slice. A chat request whose
``tools`` / ``functions`` survive its ``tool_choice`` is refused with a
400 (tool calls need grammar), never answered in free text; "none" is
served. ``priority`` picks the request's scheduling class. The request
id of the first choice (or prompt) is the correlation id the server took
from ``X-Correlation-ID`` or minted (api/app.py); later ones add "-c<i>"
(chat) or "-p<i>" (completions), as in the JAX routes.
"""

from __future__ import annotations

import contextlib
import secrets
import threading
import time
import uuid

from localai_tpu_torch.api.app import ApiError, App, Response
from localai_tpu_torch.backend import runner

_OVERRIDE_KEYS = ("temperature", "top_k", "top_p", "min_p", "seed",
                  "presence_penalty", "frequency_penalty", "repeat_penalty",
                  "typical_p", "mirostat", "logit_bias", "ignore_eos",
                  "grammar",
                  # the scheduling class (high | normal | low); the engine
                  # maps an unknown value to the model's default
                  "priority")


def _overrides_from(body: dict) -> dict:
    o = {k: body[k] for k in _OVERRIDE_KEYS if body.get(k) is not None}
    mt = body.get("max_tokens") or body.get("max_completion_tokens")
    if mt:
        o["max_tokens"] = mt
    stop = body.get("stop")
    if stop:
        o["stop"] = [stop] if isinstance(stop, str) else list(stop)
    return o


def _functions_from(body: dict) -> list:
    """The functions a chat request declares (``functions``, or the
    function entries of ``tools``) that survive its ``tool_choice`` /
    ``function_call``: "none" declares them but forbids calling them, as
    in the JAX route."""
    tools = body.get("tools") or []
    functions = body.get("functions") or [
        t.get("function") for t in tools
        if isinstance(t, dict) and t.get("type") == "function"]
    if (body.get("tool_choice") or body.get("function_call")) == "none":
        return []
    return functions


def _usage(prompt_tokens: int, completion_tokens: int) -> dict:
    return {"prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens}


def render_chat(messages: list) -> str:
    """The default chat template: "{role}: {content}" per message (just
    the content when a message has no role), joined by newlines."""
    out = []
    for m in messages:
        content = m.get("content")
        if isinstance(content, list):
            texts = []
            for part in content:
                if part.get("type", "text") != "text":
                    raise ApiError(f"content part {part.get('type')!r} is not "
                                   f"supported by this model")
                texts.append(part.get("text", ""))
            content = "\n".join(texts)
        content = content or ""
        role = m.get("role", "user")
        s = f"{role}: {content}" if role else content
        if s:
            out.append(s)
    return "\n".join(out)


def _collect(lm, req) -> dict:
    """Run one request to completion: text, usage counts, finish reason."""
    texts, pt, ct, finish = [], len(req.prompt_ids), 0, "stop"
    with contextlib.closing(runner.stream(lm, req)) as events:
        for ev in events:
            texts.append(ev.text)
            pt, ct = ev.prompt_tokens, ev.completion_tokens
            finish = ev.finish_reason or finish
    return {"text": "".join(texts), "prompt_tokens": pt,
            "completion_tokens": ct, "finish_reason": finish}


def _fan_out(lm, reqs: list) -> list:
    """Run several requests concurrently (each in its own engine slot)."""
    results = [None] * len(reqs)
    errors = []

    def work(i):
        try:
            results[i] = _collect(lm, reqs[i])
        except Exception as e:   # re-raised on the handler thread below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in range(1, len(reqs))]
    for t in threads:
        t.start()
    work(0)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def readyz(app: App, query: dict = None) -> Response:
    return Response({"status": "ok", "models": {
        name: {"slots": lm.engine.ecfg.num_slots,
               "active_slots": lm.engine.num_active,
               "queued": lm.engine.metrics()["queued"]}
        for name, lm in app.models.items()}})


def list_models(app: App, query: dict = None) -> Response:
    return Response({"object": "list", "data": [
        {"id": name, "object": "model", "created": int(app.started_at),
         "owned_by": "localai-tpu-torch", "ready": True}
        for name in sorted(app.models)]})


def chat_completions(app: App, body: dict, rid: str = "") -> Response:
    model, lm = app.resolve(body)
    messages = body.get("messages") or []
    if not messages:
        raise ApiError("messages is required")
    prompt = render_chat(messages)
    overrides = _overrides_from(body)
    functions = _functions_from(body)
    if functions:
        # tool calls need grammar-constrained decoding, which the port
        # does not serve yet: build_request refuses them (400)
        overrides["functions"] = functions
    created = int(time.time())
    cmpl_id = f"chatcmpl-{secrets.token_hex(12)}"
    rid = rid or uuid.uuid4().hex

    if body.get("stream"):
        req = runner.build_request(lm, prompt, overrides, rid)

        def gen():
            usage = [len(req.prompt_ids), 0]
            finish = "stop"
            sent_role = False
            with contextlib.closing(runner.stream(lm, req)) as events:
                for ev in events:
                    if not sent_role:
                        yield {"id": cmpl_id, "object": "chat.completion.chunk",
                               "created": created, "model": model,
                               "choices": [{"index": 0,
                                            "delta": {"role": "assistant",
                                                      "content": ""},
                                            "finish_reason": None}]}
                        sent_role = True
                    usage = [ev.prompt_tokens, ev.completion_tokens]
                    finish = ev.finish_reason or finish
                    if ev.text:
                        yield {"id": cmpl_id, "object": "chat.completion.chunk",
                               "created": created, "model": model,
                               "choices": [{"index": 0,
                                            "delta": {"content": ev.text},
                                            "finish_reason": None}]}
            yield {"id": cmpl_id, "object": "chat.completion.chunk",
                   "created": created, "model": model,
                   "choices": [{"index": 0, "delta": {},
                                "finish_reason": finish}],
                   "usage": _usage(*usage)}

        return Response(stream=gen())

    n = int(body.get("n") or 1)
    reqs = []
    for i in range(n):
        o = dict(overrides)
        if i and o.get("seed") is not None:
            o["seed"] = int(o["seed"]) + i      # n distinct samples
        reqs.append(runner.build_request(lm, prompt, o,
                                         f"{rid}-c{i}" if i else rid))
    results = _fan_out(lm, reqs)
    echo = prompt if body.get("echo") else ""
    choices = [{"index": i,
                "message": {"role": "assistant", "content": echo + r["text"]},
                "finish_reason": r["finish_reason"]}
               for i, r in enumerate(results)]
    return Response({
        "id": cmpl_id, "object": "chat.completion", "created": created,
        "model": model, "choices": choices,
        "usage": _usage(results[0]["prompt_tokens"],
                        sum(r["completion_tokens"] for r in results))})


def completions(app: App, body: dict, rid: str = "") -> Response:
    model, lm = app.resolve(body)
    overrides = _overrides_from(body)
    prompts = body.get("prompt", "")
    if isinstance(prompts, str):
        prompts = [prompts]
    created = int(time.time())
    cmpl_id = f"cmpl-{secrets.token_hex(12)}"
    rid = rid or uuid.uuid4().hex

    if body.get("stream"):
        req = runner.build_request(lm, prompts[0], overrides, rid)

        def gen():
            usage = [len(req.prompt_ids), 0]
            finish = "stop"
            with contextlib.closing(runner.stream(lm, req)) as events:
                for ev in events:
                    usage = [ev.prompt_tokens, ev.completion_tokens]
                    finish = ev.finish_reason or finish
                    if ev.text:
                        yield {"id": cmpl_id, "object": "text_completion",
                               "created": created, "model": model,
                               "choices": [{"index": 0, "text": ev.text,
                                            "finish_reason": None}]}
            yield {"id": cmpl_id, "object": "text_completion",
                   "created": created, "model": model,
                   "choices": [{"index": 0, "text": "",
                                "finish_reason": finish}],
                   "usage": _usage(*usage)}

        return Response(stream=gen())

    reqs = [runner.build_request(lm, p, overrides, f"{rid}-p{i}" if i else rid)
            for i, p in enumerate(prompts)]
    results = _fan_out(lm, reqs)
    return Response({
        "id": cmpl_id, "object": "text_completion", "created": created,
        "model": model,
        "choices": [{"index": i,
                     "text": (p if body.get("echo") else "") + r["text"],
                     "finish_reason": r["finish_reason"]}
                    for i, (p, r) in enumerate(zip(prompts, results))],
        "usage": _usage(sum(r["prompt_tokens"] for r in results),
                        sum(r["completion_tokens"] for r in results))})
