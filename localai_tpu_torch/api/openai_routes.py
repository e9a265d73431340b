"""OpenAI-compatible routes (counterpart of localai_tpu/api/openai_routes.py):
/v1/chat/completions and /v1/completions, streamed (SSE) and not, with
the same response fields, plus /v1/models and /readyz. ``"echo": true``
on a non-streamed request returns the rendered prompt followed by the
text, as the JAX backend's ``Predict`` does; a streamed request carries
the text alone, as its ``PredictStream`` does.

Chat prompts render with the JAX package's default chat-message template
(templates/prompts.py DEFAULT_CHAT_MESSAGE, "{Role}: {Content}", messages
joined by "\\n", as api/chatflow.py does), written in plain Python; model
YAML templates and jinja come with a later slice (the JAX default model
config has no template either, so declared functions do not enter the
prompt on either side). TOOL CALLS (the JAX route): a chat request whose
``tools`` / ``functions`` survive its ``tool_choice`` ("none" drops them:
a plain chat) and that brings no ``grammar`` of its own decodes under the
grammar ``grammar_for_functions`` builds from them (one call, or an array
with ``parallel_tool_calls``; a dict ``tool_choice`` forces its name).
The answer parses the calls out of the text (functions/parse.py, the
default FunctionsConfig): non-streamed, ``message.tool_calls`` with
content null and finish "tool_calls"; streamed, the text is buffered and
sent as ONE ``tool_calls`` delta before the final chunk, whose finish is
"tool_calls" (text that holds no call goes out as one content delta).
``priority`` picks the request's scheduling class. The request
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
from localai_tpu_torch.functions import parse as fparse
from localai_tpu_torch.functions.grammars import json_schema

# the tool-call keys and parsing rules of the JAX default model config
FUNCTIONS = fparse.FunctionsConfig()

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


def _tool_grammar(body: dict, functions: list) -> str:
    """The grammar that forces a tool call (the JAX route's): built from
    ``functions`` unless the request brings its own ``grammar``; a dict
    ``tool_choice`` / ``function_call`` narrows it to the named function,
    ``parallel_tool_calls`` makes it an array of calls. "" when there is
    nothing to force."""
    if not functions or body.get("grammar"):
        return ""
    choice = body.get("tool_choice") or body.get("function_call")
    force_name = None
    if isinstance(choice, dict):
        force_name = ((choice.get("function") or {}).get("name")
                      or choice.get("name"))
    return json_schema.grammar_for_functions(
        functions, force_name=force_name,
        parallel_calls=bool(body.get("parallel_tool_calls", False)),
        name_key=FUNCTIONS.function_name_key,
        arguments_key=FUNCTIONS.function_arguments_key)


def _tool_calls(calls: list, indexed: bool = False) -> list:
    """Parsed calls as OpenAI ``tool_calls`` entries (streamed deltas carry
    an ``index``)."""
    return [{**({"index": i} if indexed else {}),
             "id": f"call_{secrets.token_hex(8)}", "type": "function",
             "function": {"name": c.name, "arguments": c.arguments}}
            for i, c in enumerate(calls)]


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
    grammar = _tool_grammar(body, functions)
    if grammar:
        overrides["grammar"] = grammar
    created = int(time.time())
    cmpl_id = f"chatcmpl-{secrets.token_hex(12)}"
    rid = rid or uuid.uuid4().hex

    if body.get("stream"):
        req = runner.build_request(lm, prompt, overrides, rid)

        def chunk(delta: dict, finish=None) -> dict:
            return {"id": cmpl_id, "object": "chat.completion.chunk",
                    "created": created, "model": model,
                    "choices": [{"index": 0, "delta": delta,
                                 "finish_reason": finish}]}

        def gen():
            usage = [len(req.prompt_ids), 0]
            finish = "stop"
            sent_role = False
            # under a forced tool grammar the whole output IS the call
            # JSON: buffer it and send a tool_calls delta instead
            collected = [] if grammar else None
            with contextlib.closing(runner.stream(lm, req)) as events:
                for ev in events:
                    if not sent_role:
                        yield chunk({"role": "assistant", "content": ""})
                        sent_role = True
                    usage = [ev.prompt_tokens, ev.completion_tokens]
                    finish = ev.finish_reason or finish
                    if ev.text and collected is not None:
                        collected.append(ev.text)
                    elif ev.text:
                        yield chunk({"content": ev.text})
            if collected is not None:
                calls = fparse.parse_function_calls("".join(collected),
                                                    FUNCTIONS)
                if calls:
                    finish = "tool_calls"
                    yield chunk({"tool_calls": _tool_calls(calls, indexed=True)})
                elif collected:
                    yield chunk({"content": "".join(collected)})
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
    choices = []
    for i, r in enumerate(results):
        message = {"role": "assistant", "content": echo + r["text"]}
        finish = r["finish_reason"]
        calls = (fparse.parse_function_calls(r["text"], FUNCTIONS)
                 if functions else [])
        if calls:
            message = {"role": "assistant", "content": None,
                       "tool_calls": _tool_calls(calls)}
            finish = "tool_calls"
        choices.append({"index": i, "message": message,
                        "finish_reason": finish})
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
