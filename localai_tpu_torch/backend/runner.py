"""In-process model loader and request path (the counterpart of
localai_tpu/backend/runner.py's tpu-llm servicer, without the gRPC
process split, which comes with a later slice).

``load_model`` turns a model dir (HF config.json + safetensors, or a
config.json-only dir with explicit random weights) or a GGUF checkpoint
(a ``.gguf`` path, or a dir holding one: config, rope scaling and
tokenizer read from the file, engine/gguf.py) plus serving knobs into a
started Engine; ``lora_adapter`` / ``lora_scale`` merge a PEFT adapter
into the weights at load (engine/lora.py; ``lora_base`` is carried and
unused, as in the JAX runner); ``quantization``, ``kv_cache_dtype``,
``kv_layout`` and the host tier's ``kv_offload``, ``kv_host_pool_mb`` and
``kv_host_store`` take the JAX package's names and values. ``build_request``
maps OpenAI-style request overrides onto a GenRequest with the JAX
package's defaults (temperature 0.8, top_k 40, top_p 0.95, max_tokens
256, repeat_last_n 64, mirostat tau 5 / eta 0.1) and its runner's rules,
every sampling knob of the JAX sampler included: typical_p, the repeat /
presence / frequency penalties, mirostat and logit_bias, the request's
``priority`` and its ``grammar`` (GBNF; the chat route builds one from
declared tools, api/openai_routes.py): a grammar that does not parse
fails its request at admission with the JAX engine's GrammarError, which
``stream`` raises as a 500, as the JAX server answers it. The lifecycle and
scheduler knobs (max_queued_requests, max_queue_wait_ms,
request_timeout_ms, dispatch_stall_ms, preempt, priority_weights,
max_preemptions, resume_reserve_pages, priority, priority_aging_ms) are
``load_model`` options under their JAX names; ``stream`` turns the
engine's shed / timeout / stall events into the 429 / 504 / 503 errors of
services/errors.py. Speculation takes the JAX options and parsing:
``draft`` (auto | model | ngram | 0 / off / none / false), ``n_draft`` (0
turns it off) and ``spec_ngram``; ``draft_model`` (the JAX option) loads
a second, smaller llama-family model as the drafter (safetensors or
GGUF), which draft "auto" then resolves to (``load_draft``). ``emitter`` (on
by default; 0 / false / off / no = inline emission) is the JAX option.
The observability options take the JAX names, defaults and checks:
``trace`` (on; the off words turn it off), ``trace_ring_size``,
``slow_request_ms``, ``stall_dump_dir``, ``event_log``,
``event_log_max_mb`` (non-negative ints where they are counts),
``peak_tflops`` (a number >= 0) and ``kv_audit`` (off | on | strict).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, Optional

import torch

from localai_tpu_torch import resolve_device
from localai_tpu_torch.engine import gguf, weights
from localai_tpu_torch.engine.gguf_tokenizer import from_gguf
from localai_tpu_torch.engine.engine import (
    DRAFT_MODES, KV_LAYOUTS, Engine, EngineConfig, GenRequest, StreamEvent)
from localai_tpu_torch.engine.sampling import SamplingParamsHost
from localai_tpu_torch.engine.tokenizer import load_tokenizer
from localai_tpu_torch.models.llama import LlamaConfig
from localai_tpu_torch.services.errors import (
    BackendUnavailableError, DeadlineExceededError, OverloadedError)

DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "float32": torch.float32, "f32": torch.float32}

# Accepted kv_cache_dtype names: a copy of the JAX package's
# config/model_config.py::KV_CACHE_DTYPES, mapped as its backend/runner.py
# maps them; None = not ported yet (no kernel of the port takes fp16)
KV_CACHE_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                   "float16": None, "f16": None,
                   "float32": torch.float32, "f32": torch.float32,
                   "int8": torch.int8, "q8_0": torch.int8}

# on/off option values (kv_offload, preempt; the JAX runner's option
# parsing: only the off words turn one off)
_OFF = ("0", "false", "off", "no")
_ON = ("", "1", "true", "on", "yes")

# the engine's lifecycle failure kinds -> the errors the HTTP layer
# renders as 429 / 504 / 503, with the retry-after hint the JAX server
# gives when the engine's is 0 (its runner's _EVENT_STATUS mapping, then
# services/errors.py::wrap_backend_error)
_EVENT_ERRORS = {"shed": (OverloadedError, 1.0),
                 "timeout": (DeadlineExceededError, 0.0),
                 "stall": (BackendUnavailableError, 1.0)}


@dataclasses.dataclass
class LoadedModel:
    name: str
    model_dir: str
    cfg: LlamaConfig
    tokenizer: object
    engine: Engine
    quantization: str = ""


def kv_cache_dtype_of(name: str, model_dtype: torch.dtype):
    """The cache dtype for a ``kv_cache_dtype`` name ("" = the model dtype).
    Unknown names raise ValueError; configurations the port's kernels do
    not take (fp16, or a float cache in another dtype than the model's)
    raise NotImplementedError."""
    if not name:
        return model_dtype
    key = name.lower()
    if key not in KV_CACHE_DTYPES:
        raise ValueError(f"unknown kv_cache_dtype {name!r} "
                         f"(one of {sorted(KV_CACHE_DTYPES)})")
    dt = KV_CACHE_DTYPES[key]
    if dt is None:
        raise NotImplementedError(
            f"kv_cache_dtype {name!r} is not ported: the port's kernels take "
            f"float32, bfloat16 or int8 caches")
    if dt != torch.int8 and dt != model_dtype:
        raise NotImplementedError(
            f"kv_cache_dtype {name!r} with model dtype {model_dtype}: the "
            f"port's kernels take a float cache in the model's dtype")
    return dt


def bool_option(value, name: str = "kv_offload") -> bool:
    """An on/off option (``kv_offload``, ``preempt``, ``emitter``): a bool, or
    0/false/off/no (off) and 1/true/on/yes or empty (on); anything else
    raises ValueError."""
    if isinstance(value, bool):
        return value
    key = str(value).strip().lower()
    if key in _OFF or key in _ON:
        return key not in _OFF
    raise ValueError(f"{name} {value!r}: expected one of "
                     f"{'|'.join(_ON[1:] + _OFF)}")


kv_offload_of = bool_option


def host_store_path(model_dir: str, path: str) -> str:
    """The ``kv_host_store`` option as a path: a relative one lands under
    ``<model dir>/prompt_cache/`` (created), as in the JAX runner; "" =
    no persistence."""
    if not path:
        return ""
    if not os.path.isabs(path):
        base = os.path.join(model_dir, "prompt_cache")
        os.makedirs(base, exist_ok=True)
        path = os.path.join(base, path)
    return path


def spec_options(draft="auto", n_draft=4, spec_ngram=3) -> dict:
    """The speculation options as the JAX runner parses them: ``draft``
    lower-cased and stripped, ``n_draft`` an int (0 turns speculation
    off), ``spec_ngram`` an int; an unknown draft word or a value that is
    not an int raises ValueError (EngineConfig.check refuses the rest)."""
    d = str(draft if draft is not None else "auto").strip().lower() or "auto"
    if d not in DRAFT_MODES:
        raise ValueError(f"draft {draft!r}: expected one of "
                         f"{'|'.join(DRAFT_MODES)}")
    try:
        return {"draft": d, "n_draft": int(str(n_draft).strip()),
                "spec_ngram": int(str(spec_ngram).strip())}
    except ValueError:
        raise ValueError(f"n_draft {n_draft!r} / spec_ngram {spec_ngram!r}: "
                         f"expected ints") from None


# the observability options given as numbers (the JAX option parsing:
# ints for the counts, a float for the peak)
_OBS_NUMBERS = {"trace_ring_size": int, "slow_request_ms": int,
                "event_log_max_mb": int, "peak_tflops": float}


def observability_options(**opts) -> dict:
    """The numeric observability options as the JAX runner parses them
    (str or number -> int / float); a value that does not parse raises
    ValueError (EngineConfig.check refuses negative ones)."""
    out = {}
    for name, value in opts.items():
        cast = _OBS_NUMBERS[name]
        try:
            out[name] = cast(str(value).strip())
        except ValueError:
            raise ValueError(f"{name} {value!r}: expected "
                             f"{'an int' if cast is int else 'a number'}"
                             ) from None
    return out


def model_base(model_dir: str) -> str:
    """The dir a model's relative paths (``draft_model``,
    ``kv_host_store``) start from: the model dir, or the dir of a
    ``.gguf`` file named directly."""
    return model_dir if os.path.isdir(model_dir) else os.path.dirname(model_dir)


def gguf_config(path: str, dtype: torch.dtype) -> LlamaConfig:
    """A GGUF file's LlamaConfig (engine/gguf.py::config_from_gguf) in
    ``dtype``."""
    return dataclasses.replace(gguf.config_from_gguf(gguf.open_gguf(path)),
                               dtype=dtype)


def draft_config(model_dir: str, draft_model: str, dtype: torch.dtype,
                 random_weights: Optional[int]) -> tuple:
    """The ``draft_model`` dir (relative to the model's dir, or absolute)
    and its LlamaConfig in the target's dtype, checked before any weight
    is read: a GGUF dir's config comes from the file (as the JAX runner
    reads it); a missing dir, or one with no safetensors, no GGUF and no
    ``random_weights``, raises FileNotFoundError. Nothing falls back to
    n-gram speculation."""
    ddir = draft_model
    if not os.path.isabs(ddir):
        ddir = os.path.join(model_base(model_dir), ddir)
    if not os.path.isdir(ddir):
        raise FileNotFoundError(f"draft_model {draft_model!r}: no dir {ddir}")
    path = weights.find_gguf(ddir)
    if path is not None:
        return ddir, gguf_config(path, dtype)
    if not weights.has_weights(ddir) and random_weights is None:
        raise FileNotFoundError(
            f"draft_model {draft_model!r}: no .safetensors in {ddir}; pass "
            f"random_weights=SEED to serve random weights")
    with open(os.path.join(ddir, "config.json")) as f:
        return ddir, LlamaConfig.from_hf_config(json.load(f), dtype=dtype)


def load_draft(ddir: str, dcfg: LlamaConfig, quantization: str,
               random_weights: Optional[int], device, vocab_size: int) -> tuple:
    """The draft model's weights (``draft_config`` checked the dir): read
    with numpy from its GGUF file or its safetensors with the target's
    ``quantization``, or, for a config-only dir with ``random_weights``
    (the target's seed), random from a seed of its own (the target's +
    1). A vocabulary other than the target's raises ValueError. Returns
    (LlamaConfig, params)."""
    if dcfg.vocab_size != vocab_size:
        raise ValueError(f"draft model {ddir}: vocabulary {dcfg.vocab_size}, "
                         f"the target's is {vocab_size}")
    if weights.find_gguf(ddir) is not None or weights.has_weights(ddir):
        dparams = weights.load_llama_params(ddir, dcfg, device=device,
                                            quantize=quantization)
    elif random_weights is not None:
        dparams = weights.random_params(dcfg, int(random_weights) + 1,
                                        device=device, quantize=quantization)
    return dcfg, dparams


def load_model(model_dir: str, name: str = "", *, num_slots: int = 8,
               context_size: int = 2048, dtype: str = "bfloat16",
               random_weights: Optional[int] = None, device="cuda",
               kv_cache_dtype: str = "", kv_layout: str = "auto",
               quantization: str = "", kv_offload=True,
               kv_host_pool_mb: int = 256, kv_host_store: str = "",
               draft="auto", n_draft=4, spec_ngram=3, draft_model: str = "",
               tokenizer: str = "", lora_adapter: str = "",
               lora_base: str = "", lora_scale: float = 0.0,
               **engine_knobs) -> LoadedModel:
    """Load a model dir (or a GGUF file) into a started Engine on
    ``device``.

    ``random_weights`` (a seed) serves random weights for a dir that holds
    only config.json; without it such a dir is an error, so an incomplete
    checkpoint is never served as noise. ``quantization`` ("" | int8 |
    int4: weight-only matmul weights, ops/quant.py; ``dtype="int8"`` is
    the JAX package's alias for int8 weights with bfloat16 compute),
    ``kv_cache_dtype`` ("" = the model dtype; int8 / q8_0 = int8 rows with
    scales) and ``kv_layout`` (auto | paged | contiguous) are checked
    before any weight is loaded: an unknown quantization raises
    ValueError (serving dense weights instead would fake the memory
    saving); int8 KV with the contiguous layout raises
    NotImplementedError. The host tier: ``kv_offload`` (``bool_option``:
    0 / false / off / no turn it off), ``kv_host_pool_mb`` (>= 1) and
    ``kv_host_store`` (``host_store_path``). ``engine_knobs`` are
    EngineConfig fields with the JAX engine's names (prefill_chunk,
    decode_burst, pipeline_depth, prefill_packed_fuse, kv_prefetch_ahead,
    the lifecycle, scheduler and observability knobs, ...; ``preempt``,
    ``emitter`` and ``trace`` parsed as ``kv_offload``, the numeric
    observability knobs by ``observability_options``), checked before
    loading too (``EngineConfig.check``).
    Speculation: ``draft`` / ``n_draft`` / ``spec_ngram`` (``spec_options``);
    ``draft_model``'s dir is checked before loading (``draft_config``) and
    its weights loaded after the target's (``load_draft``).
    ``tokenizer``: a dir whose tokenizer files stand for the model dir's
    (the JAX ``tokenizer`` field). A tokenizer.json the port cannot read
    raises before any weight is loaded.
    A GGUF checkpoint (``weights.find_gguf``: a ``.gguf`` path, or the one
    ``*.gguf`` of a dir without safetensors) gives the config, its rope
    scaling included, and, unless ``tokenizer`` is given, the tokenizer
    (``from_gguf``); its tensors are dequantized on the host and take the
    path of any other leaf (cast, or ``quantization``).
    ``lora_adapter``: a PEFT adapter dir (absolute, or relative to the
    working directory; ``capabilities.model_options`` resolves a config's
    against the models path, as the JAX runner does), merged into the
    weights with scale ``(lora_scale or 1.0) * lora_alpha / r`` before any
    cast or quantization; a dir without the adapter's safetensors raises
    FileNotFoundError before any weight is read. ``lora_base`` is
    accepted and unused, as in the JAX runner.
    A GPTQ / AWQ dir with no quantization loads as int8."""
    dev = resolve_device(device)
    if dtype == "int8":
        dtype, quantization = "bfloat16", quantization or "int8"
    weights.check_quantize(quantization)
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r}: expected one of {sorted(DTYPES)}")
    if kv_layout not in KV_LAYOUTS:
        raise ValueError(f"kv_layout {kv_layout!r}: expected one of "
                         f"{'|'.join(KV_LAYOUTS)}")
    cache_dtype = kv_cache_dtype_of(kv_cache_dtype, DTYPES[dtype])
    if cache_dtype == torch.int8 and kv_layout == "contiguous":
        raise NotImplementedError(
            "kv_cache_dtype int8 with kv_layout contiguous is not ported; "
            "use kv_layout paged (or auto) for an int8 cache")
    engine_knobs.update(spec_options(draft, n_draft, spec_ngram))
    for opt in ("preempt", "emitter", "trace"):
        if opt in engine_knobs:
            engine_knobs[opt] = bool_option(engine_knobs[opt], opt)
    engine_knobs.update(observability_options(**{
        k: engine_knobs.pop(k) for k in _OBS_NUMBERS if k in engine_knobs}))
    # engine knobs are checked here too, before any weight is loaded
    # (an unknown prefill_packed_fuse, a pipeline_depth below 1, a
    # priority outside high | normal | low)
    ecfg = EngineConfig(num_slots=num_slots, max_context=context_size,
                        cache_dtype=cache_dtype, kv_layout=kv_layout,
                        kv_offload=bool_option(kv_offload),
                        kv_host_pool_mb=kv_host_pool_mb, **engine_knobs)
    ecfg.check()
    base = model_base(model_dir)
    ecfg.kv_host_store_path = host_store_path(base, kv_host_store)
    draft_dir = (draft_config(model_dir, draft_model, DTYPES[dtype],
                              random_weights) if draft_model else None)
    lora = {"lora_adapter": lora_adapter, "lora_scale": lora_scale or 1.0}
    gguf_path = weights.find_gguf(model_dir)
    if gguf_path is not None:
        cfg = gguf_config(gguf_path, DTYPES[dtype])
        tok = load_tokenizer(tokenizer) if tokenizer else from_gguf(gguf_path)
    else:
        tok = load_tokenizer(tokenizer or model_dir)
        with open(os.path.join(model_dir, "config.json")) as f:
            hf = json.load(f)
        cfg = LlamaConfig.from_hf_config(hf, dtype=DTYPES[dtype])
    if gguf_path is not None or weights.has_weights(model_dir):
        params = weights.load_llama_params(model_dir, cfg, device=dev,
                                           quantize=quantization, **lora)
    elif random_weights is not None:
        params = weights.random_params(cfg, int(random_weights), device=dev,
                                       quantize=quantization, **lora)
    else:
        raise FileNotFoundError(
            f"no .safetensors or .gguf in {model_dir}; pass random_weights=SEED "
            f"(CLI: --random-weights SEED) to serve random weights")
    draft_pair = None
    if draft_dir is not None:
        draft_pair = load_draft(*draft_dir, quantization, random_weights, dev,
                                cfg.vocab_size)
    engine = Engine(cfg, params, tok, ecfg, device=dev, draft=draft_pair).start()
    quantized = isinstance(params.get("embed"), dict)
    return LoadedModel(name or os.path.basename(os.path.normpath(model_dir)),
                       model_dir, cfg, tok, engine,
                       quantization=(quantization or "int8") if quantized else "")


def build_request(lm: LoadedModel, prompt: str, overrides: dict,
                  request_id: str = "", mc=None) -> GenRequest:
    """OpenAI-style overrides -> GenRequest (the JAX runner's mapping).
    With a model config ``mc``, its defaults stand under the overrides
    (capabilities.predict_overrides: parameters, max_tokens, stopwords).
    The prompt is encoded as HF's ``encode`` does it, special tokens
    included (the JAX runner's ``tokenizer.encode(prompt)``)."""
    if mc is not None:
        from localai_tpu_torch.capabilities import predict_overrides

        overrides = predict_overrides(mc, overrides)
    o = overrides or {}

    def num(key, default, cast=float):
        return cast(o[key]) if o.get(key) is not None else default

    typical_p = num("typical_p", 1.0)
    repeat_penalty = num("repeat_penalty", 1.0)
    sp = SamplingParamsHost(
        temperature=num("temperature", 0.8), top_k=num("top_k", 40, int),
        top_p=num("top_p", 0.95), min_p=num("min_p", 0.0),
        typical_p=typical_p if typical_p > 0 else 1.0,
        repeat_penalty=repeat_penalty if repeat_penalty > 0 else 1.0,
        # llama.cpp: -1 = the whole window, 0 = the default 64
        repeat_last_n=num("repeat_last_n", 64, int) or 64,
        presence_penalty=num("presence_penalty", 0.0),
        frequency_penalty=num("frequency_penalty", 0.0),
        mirostat=num("mirostat", 0, int),
        mirostat_tau=num("mirostat_tau", 0.0) or 5.0,
        mirostat_eta=num("mirostat_eta", 0.0) or 0.1,
        seed=num("seed", -1, int),
        logit_bias={int(k): float(v)
                    for k, v in (o.get("logit_bias") or {}).items()})
    stop = o.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    return GenRequest(
        prompt_ids=lm.tokenizer.encode(prompt), params=sp,
        max_new_tokens=int(o.get("max_tokens") or 256),
        stop_sequences=list(stop), ignore_eos=bool(o.get("ignore_eos", False)),
        request_id=request_id, priority=str(o.get("priority") or ""),
        grammar=str(o.get("grammar") or ""))


def stream(lm: LoadedModel, req: GenRequest) -> Iterator[StreamEvent]:
    """Events of one request. An engine-side error raises: a lifecycle
    refusal (``error_kind`` shed / timeout / stall) as the matching
    services/errors.py error (429 with the retry-after hint / 504 / 503),
    anything else as RuntimeError. Closed before the engine ended the
    request (its consumer went away), it cancels the request, so the slot
    does not decode on to max_tokens (the JAX backend's PredictStream
    cancels the same way)."""
    ended = False
    try:
        for ev in lm.engine.generate(req):
            ended = bool(ev.error or ev.finish_reason)
            if ev.error:
                if ev.error_kind in _EVENT_ERRORS:
                    err, retry_s = _EVENT_ERRORS[ev.error_kind]
                    raise err(ev.error, retry_after_s=ev.retry_after_s or retry_s)
                raise RuntimeError(ev.error)
            yield ev
        ended = True
    finally:
        if not ended:
            lm.engine.cancel(req.request_id)
