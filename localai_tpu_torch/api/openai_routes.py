"""OpenAI-compatible routes (counterpart of localai_tpu/api/openai_routes.py):
/v1/chat/completions, /v1/completions and /v1/edits, streamed (SSE) and
not (edits: not), with the same response fields, plus /v1/models (the
configured and the loaded models), /v1/tokenize (the JAX localai route:
``{"model", "content"}`` -> ``{"tokens"}``, the ids the model's
tokenizer gives with its special tokens) and /readyz.

Every route renders through the request's model config (api/app.py
resolves it; ``run --model`` serves a default config): chat through its
``chat_message`` / ``chat`` templates (api/chatflow.py; the default
"{Role}: {Content}" per message, joined by "\\n", without them),
completions through its ``completion`` template and edits through its
``edit`` template ("{instruction}\\n\\n{input}" without). The config's
``parameters`` stand under the request's overrides and its stopwords
are the stop sequences when the request gives none
(capabilities.predict_overrides). A non-streamed answer goes through
``finetune_response`` (cutstrings, extract_regex, trimspace,
trimsuffix), after ``"echo": true`` put the rendered prompt before the
text, as the JAX backend's ``Predict`` and ``Capabilities.inference``
do; a streamed one carries the raw text, as the JAX stream does. The
chat prompt's build is a "build_prompt" span of the HTTP layer's tracer
unless the config's ``trace`` option is off. Image,
audio and video content parts get the JAX route's 400s (multimodal
serving is a later slice).

TOOL CALLS (the JAX route): a chat request whose ``tools`` /
``functions`` survive its ``tool_choice`` ("none" drops them: a plain
chat) and that brings no ``grammar`` of its own decodes under the
grammar ``grammar_for_functions`` builds from them with the config's
``function_name_key`` / ``function_arguments_key`` (one call, or an
array with ``parallel_tool_calls``; a dict ``tool_choice`` forces its
name). The answer parses the calls out of the text with the config's
FunctionsConfig (functions/parse.py): non-streamed, ``message.tool_calls``
with content null and finish "tool_calls"; streamed, the text is
buffered and sent as ONE ``tool_calls`` delta before the final chunk,
whose finish is "tool_calls" (text that holds no call goes out as one
content delta). ``priority`` picks the request's scheduling class. The
request id of the first choice (or prompt) is the correlation id the
server took from ``X-Correlation-ID`` or minted (api/app.py); later ones
add "-c<i>" (chat) or "-p<i>" (completions), as in the JAX routes.
"""

from __future__ import annotations

import contextlib
import secrets
import threading
import time
import uuid

from localai_tpu_torch.api.app import ApiError, App, Response
from localai_tpu_torch.api.chatflow import build_chat_prompt
from localai_tpu_torch.backend import runner
from localai_tpu_torch.capabilities import finetune_response, trace_enabled
from localai_tpu_torch.functions import parse as fparse
from localai_tpu_torch.functions.grammars import json_schema
from localai_tpu_torch.services.tracing import frontend_tracer
from localai_tpu_torch.templates import prompts as T

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


def _tool_grammar(body: dict, functions: list, fcfg) -> str:
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
        name_key=fcfg.function_name_key,
        arguments_key=fcfg.function_arguments_key)


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


def _chat_prompt(mc, messages: list, functions: list) -> str:
    """The rendered chat prompt; a request with media parts gets the JAX
    route's 400s."""
    prompt, images, audios, videos = build_chat_prompt(mc, messages, None,
                                                       functions or None)
    if audios:
        raise ApiError("audio content parts are not supported on chat "
                       "completions; use /v1/audio/transcriptions for speech "
                       "input")
    if images or videos:
        raise ApiError("this model has no vision projector (mmproj); "
                       "image/video content parts cannot be used")
    return prompt


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
         "owned_by": "localai-tpu-torch", "ready": name in app.models}
        for name in sorted(set(app.caps.configs) | set(app.models))]})


def chat_completions(app: App, body: dict, rid: str = "") -> Response:
    model, mc, lm = app.resolve(body)
    messages = body.get("messages") or []
    if not messages:
        raise ApiError("messages is required")
    overrides = _overrides_from(body)
    functions = _functions_from(body)
    rid = rid or uuid.uuid4().hex
    t_route = time.monotonic()
    prompt = _chat_prompt(mc, messages, functions)
    tr = frontend_tracer()
    if tr.enabled and trace_enabled(mc):
        tr.record("build_prompt", "route", t_route, time.monotonic(), rid=rid,
                  args={"model": model})
    grammar = _tool_grammar(body, functions, mc.function)
    if grammar:
        overrides["grammar"] = grammar
    created = int(time.time())
    cmpl_id = f"chatcmpl-{secrets.token_hex(12)}"

    if body.get("stream"):
        req = runner.build_request(lm, prompt, overrides, rid, mc=mc)

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
                                                    mc.function)
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
                                         f"{rid}-c{i}" if i else rid, mc=mc))
    results = _fan_out(lm, reqs)
    choices = []
    for i, r in enumerate(results):
        text = finetune_response(mc, r["text"], prompt, bool(body.get("echo")))
        message = {"role": "assistant", "content": text}
        finish = r["finish_reason"]
        calls = (fparse.parse_function_calls(text, mc.function)
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
    model, mc, lm = app.resolve(body)
    overrides = _overrides_from(body)
    prompts = body.get("prompt", "")
    if isinstance(prompts, str):
        prompts = [prompts]
    if mc.template.completion:
        prompts = [T.render_completion(mc.template.completion, p,
                                       mc.system_prompt) for p in prompts]
    created = int(time.time())
    cmpl_id = f"cmpl-{secrets.token_hex(12)}"
    rid = rid or uuid.uuid4().hex

    if body.get("stream"):
        req = runner.build_request(lm, prompts[0], overrides, rid, mc=mc)

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

    reqs = [runner.build_request(lm, p, overrides, f"{rid}-p{i}" if i else rid,
                                 mc=mc)
            for i, p in enumerate(prompts)]
    results = _fan_out(lm, reqs)
    return Response({
        "id": cmpl_id, "object": "text_completion", "created": created,
        "model": model,
        "choices": [{"index": i,
                     "text": finetune_response(mc, r["text"], p,
                                               bool(body.get("echo"))),
                     "finish_reason": r["finish_reason"]}
                    for i, (p, r) in enumerate(zip(prompts, results))],
        "usage": _usage(sum(r["prompt_tokens"] for r in results),
                        sum(r["completion_tokens"] for r in results))})


def edits(app: App, body: dict, rid: str = "") -> Response:
    """/v1/edits (the JAX route): the config's edit template over the
    instruction and the input, one answer, post-processed."""
    model, mc, lm = app.resolve(body)
    instruction = body.get("instruction", "")
    inp = body.get("input", "")
    if mc.template.edit:
        prompt = T.render_edit(mc.template.edit, instruction, inp)
    else:
        prompt = f"{instruction}\n\n{inp}"
    req = runner.build_request(lm, prompt, _overrides_from(body),
                               rid or uuid.uuid4().hex, mc=mc)
    r = _collect(lm, req)
    return Response({
        "object": "edit", "created": int(time.time()), "model": model,
        "choices": [{"index": 0, "text": finetune_response(
            mc, r["text"], prompt, bool(body.get("echo")))}],
        "usage": _usage(r["prompt_tokens"], r["completion_tokens"])})


def tokenize(app: App, body: dict, rid: str = "") -> Response:
    """/v1/tokenize (the JAX localai route): the model is required."""
    if not body.get("model"):
        raise ApiError("model is required")
    _model, _mc, lm = app.resolve(body)
    return Response({"tokens": lm.tokenizer.encode(body.get("content", ""))})
