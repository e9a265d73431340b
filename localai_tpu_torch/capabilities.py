"""The glue between the HTTP routes and the models a models dir
configures (the counterpart of localai_tpu/capabilities.py, the parts
the chat, completion, edit and tokenize routes need).

``finetune_response`` and ``trace_enabled`` are copies.
``model_options`` maps a model config onto ``runner.load_model``'s
arguments (the JAX ``build_model_options``: the model dir under the
models path (a dir, or a ``.gguf`` file), context_size, num_slots,
dtype, kv_cache_dtype, quantization, prefill_buckets, decode_burst,
draft_model, the tokenizer dir, lora_adapter (relative to the models
path, as the JAX runner resolves it), lora_base and lora_scale, and the
``options`` k=v knobs typed as the engine's fields);
``predict_overrides`` is the JAX ``build_predict_options`` mapping (the
config's ``parameters`` under the request's overrides, ``max_tokens``,
the stopwords as stop sequences), which ``runner.build_request`` applies
when it is given the config.

``Capabilities`` holds the scanned configs and loads a model at its
first request (``resolve`` / ``load``, the JAX ``resolve`` / ``_load``);
an unknown name resolves to an on-the-fly default config for a model
dir of that name, but the name of a config the scan skipped (a template
outside the port's renderer's subset among them) answers with its
error, never with a default config. A config that sets something of a module the port
has not yet raises NotImplementedError before any weight is read,
naming the slice that brings it (``unported_settings``): nothing is
dropped without a word.
"""

from __future__ import annotations

import dataclasses
import inspect
import logging
import os
import re
import threading
import typing
from typing import Callable, Optional

from localai_tpu_torch.config.model_config import ModelConfig

log = logging.getLogger(__name__)

# where each setting of an unported module lands (ROADMAP.md Queue 1)
_LATER = {
    "mesh": "item 12 (tensor parallelism)",
    "mmproj": "item 10 (multimodal LLaVA)",
    "diffusion": "item 13 (diffusion)",
    "tts": "item 13 (TTS)",
    "embeddings": "item 13 (embeddings)",
    "backend": "item 13 (other families and capabilities)",
    "prompt_cache": "item 7 (the on-disk prompt cache)",
    "window": "item 6 (long context)",
    "slo": "item 9 (the SLO engine)",
    "scale_out": "item 11 (scale-out)",
    "download": "no queued item (nothing is downloaded)",
}

# option keys -> the module that reads them, for the ones the port lacks
_UNPORTED_OPTIONS = (
    (re.compile(r"slo_.*"), "slo"),
    (re.compile(r"(engines|autoscale.*|weight_prefetch|disagg|cluster_.*"
                r"|kv_peers|kv_serve|kv_stream_.*|kv_host_id)"), "scale_out"),
    (re.compile(r"(kv_window_pages|kv_sink_pages|kv_window_policy|ga_n|ga_w)"),
     "window"),
    (re.compile(r"comm_overlap"), "mesh"),
    (re.compile(r"(controlnet|num_frames|fps|motion)"), "diffusion"),
)

# the llama-family text backend under its JAX name ("" = greedy)
LLM_BACKENDS = ("", "tpu-llm")

# load_model's keyword arguments that the config's own fields or the
# server set, never an option
_NOT_OPTIONS = ("num_slots", "context_size", "dtype", "device", "tokenizer",
                "lora_adapter", "lora_base", "lora_scale")


def finetune_response(mc: ModelConfig, prediction: str, prompt: str = "",
                      echo: bool = False) -> str:
    """Post-process model output (the JAX Finetune copy)."""
    if echo:
        prediction = prompt + prediction
    for c in mc.cutstrings:
        prediction = re.sub(c, "", prediction)
    for r in mc.extract_regex:
        m = re.search(r, prediction)
        if m:
            prediction = m.group(0)
    for t in mc.trimspace:
        # strip the token as a PREFIX once, then surrounding whitespace
        prediction = prediction.removeprefix(t).strip()
    for t in mc.trimsuffix:
        prediction = prediction.removesuffix(t).strip()
    return prediction


def trace_enabled(mc: ModelConfig) -> bool:
    """Is request tracing on for this model (the ``trace`` option)?"""
    for o in mc.options or []:
        s = str(o)
        if s.startswith("trace="):
            return s.split("=", 1)[1].strip().lower() not in (
                "0", "false", "off", "no")
    return True


def option_pairs(mc: ModelConfig) -> list:
    """The config's ``options`` as (key, value) pairs (entries without
    "=" are skipped, as the JAX runner's parse skips them)."""
    out = []
    for o in mc.options or []:
        s = str(o)
        if "=" in s:
            k, v = (p.strip() for p in s.split("=", 1))
            out.append((k, v))
    return out


def unported_settings(mc: ModelConfig) -> list:
    """What the config sets that the port cannot serve yet, each with the
    slice that brings it ([] = servable)."""
    out = []

    def later(what: str, module: str):
        out.append(f"{what}: not ported yet (ROADMAP Queue 1 {_LATER[module]})")

    if (mc.backend or "") not in LLM_BACKENDS:
        later(f"backend {mc.backend!r}", "backend")
    if any(int(v or 0) > 1 for k, v in (mc.mesh or {}).items()
           if k in ("tp", "dp")) or set(mc.mesh or {}) - {"tp", "dp"}:
        later(f"mesh {mc.mesh!r}", "mesh")
    if mc.mmproj:
        later("mmproj", "mmproj")
    if mc.scheduler or mc.controlnet:
        later("scheduler / controlnet", "diffusion")
    if mc.audio_path:
        later("audio_path", "tts")
    if mc.embeddings:
        later("embeddings", "embeddings")
    if mc.prompt_cache_path or mc.prompt_cache_ro or mc.prompt_cache_all:
        later("prompt_cache_path / _ro / _all", "prompt_cache")
    if mc.group_attn_n > 1:
        later("group_attn_n (self-extend)", "window")
    if mc.download_files:
        later("download_files", "download")
    for k, v in option_pairs(mc):
        for rx, module in _UNPORTED_OPTIONS:
            if rx.fullmatch(k):
                later(f"option {k}={v}", module)
        if k == "prefill_packed" and v.lower() in ("0", "false", "off", "no"):
            out.append(f"option prefill_packed={v}: the port always packs "
                       f"prefill (per-slot bucketed prefill is not ported)")
    return out


def _loader_options() -> dict:
    """load_model's own option names besides the EngineConfig fields, each
    with the type of its annotation (str where it has none: load_model
    parses those; random_weights=SEED serves random weights, as the CLI's
    --random-weights)."""
    from localai_tpu_torch.backend.runner import load_model

    hints = typing.get_type_hints(load_model)
    out = {}
    for p in inspect.signature(load_model).parameters.values():
        if p.kind is p.KEYWORD_ONLY and p.name not in _NOT_OPTIONS:
            t = hints.get(p.name, str)
            out[p.name] = next((a for a in typing.get_args(t)
                                if a is not type(None)), t)
    return out


def _engine_fields() -> dict:
    from localai_tpu_torch.engine.engine import EngineConfig

    return {f.name: type(f.default) for f in dataclasses.fields(EngineConfig)
            if f.default is not dataclasses.MISSING}


def model_options(mc: ModelConfig, models_path: str,
                  context_size: int = 2048) -> dict:
    """ModelConfig -> ``runner.load_model`` keyword arguments (the JAX
    build_model_options mapping). An option the port does not know
    raises ValueError (the engine would not read it)."""
    model_dir = mc.model or mc.name
    kw = dict(model_dir=os.path.join(models_path, model_dir), name=mc.name,
              context_size=mc.context_size or context_size,
              num_slots=mc.num_slots, dtype=mc.dtype,
              kv_cache_dtype=mc.kv_cache_dtype,
              quantization=mc.quantization, draft_model=mc.draft_model)
    if mc.tokenizer:
        kw["tokenizer"] = (mc.tokenizer if os.path.isabs(mc.tokenizer)
                           else os.path.join(models_path, mc.tokenizer))
    if mc.lora_adapter:
        kw["lora_adapter"] = (mc.lora_adapter if os.path.isabs(mc.lora_adapter)
                              else os.path.join(models_path, mc.lora_adapter))
    if mc.lora_base or mc.lora_scale:
        kw.update(lora_base=mc.lora_base, lora_scale=mc.lora_scale)
    if mc.prefill_buckets:
        kw["prefill_buckets"] = tuple(int(b) for b in mc.prefill_buckets)
    if mc.decode_burst > 0:
        kw["decode_burst"] = mc.decode_burst
    from localai_tpu_torch.backend.runner import bool_option

    fields = {**_engine_fields(), **_loader_options()}
    for k, v in option_pairs(mc):
        if k == "prefill_packed":
            continue        # on: the port always packs (off is refused)
        cast = fields.get(k)
        if k in ("num_slots", "max_context", "cache_dtype",
                 "prefill_buckets", "kv_host_store_path") or cast is None:
            raise ValueError(f"model {mc.name}: option {k}={v} is not a knob "
                             f"of the port's engine")
        if cast is bool:
            kw[k] = bool_option(v, k)
        elif cast is str:
            kw[k] = v                  # parsed by load_model / the engine
        else:
            kw[k] = cast(v)
    return kw


def predict_overrides(mc: ModelConfig, overrides: Optional[dict]) -> dict:
    """The request's overrides over the config's defaults (the JAX
    build_predict_options mapping): every sampling knob from
    ``sampling_host``, max_tokens (request, then config, then 256), the
    request's stop sequences or the config's stopwords."""
    o = dict(overrides or {})
    sp = mc.sampling_host(overrides)
    for f in dataclasses.fields(sp):
        o[f.name] = getattr(sp, f.name)
    o["max_tokens"] = int(o.get("max_tokens") or mc.parameters.max_tokens
                          or 256)
    o["stop"] = list(o.get("stop") or mc.stopwords or [])
    return o


class Capabilities:
    """The configs of a models dir and the models loaded for them (name ->
    runner.LoadedModel), each loaded at its first request. ``load_model``
    is ``runner.load_model`` with the server's fixed arguments (device)
    bound; ``skipped`` the configs the scan skipped (name -> error,
    ``scan_models_dir``'s)."""

    def __init__(self, models_path: str, configs: dict,
                 load_model: Callable, context_size: int = 2048,
                 loaded: Optional[dict] = None,
                 skipped: Optional[dict] = None):
        self.models_path = models_path
        self.configs = dict(configs)
        self.skipped = dict(skipped or {})
        self.load_model = load_model
        self.context_size = context_size
        self.loaded = dict(loaded or {})
        self._lock = threading.Lock()

    def resolve(self, model_name: str) -> ModelConfig:
        mc = self.configs.get(model_name)
        if mc is None and model_name in self.skipped:
            raise RuntimeError(f"model {model_name}: its config was skipped "
                               f"at scan: {self.skipped[model_name]}")
        if mc is None:
            # an on-the-fly config for a model dir of that name
            mc = ModelConfig(name=model_name)
            mc.model = model_name
        return mc

    def load(self, mc: ModelConfig):
        """The loaded model of ``mc`` (loaded now if it is not yet; one
        load at a time)."""
        lm = self.loaded.get(mc.name)
        if lm is not None:
            return lm
        with self._lock:
            lm = self.loaded.get(mc.name)
            if lm is None:
                problems = unported_settings(mc)
                if problems:
                    raise NotImplementedError(
                        f"model {mc.name}: " + "; ".join(problems))
                from localai_tpu_torch.engine.weights import find_gguf

                kw = model_options(mc, self.models_path, self.context_size)
                if not (os.path.isdir(kw["model_dir"])
                        or find_gguf(kw["model_dir"])):
                    raise FileNotFoundError(
                        f"model {mc.name}: no model dir {kw['model_dir']}")
                log.info("loading model %s from %s", mc.name, kw["model_dir"])
                lm = self.load_model(kw.pop("model_dir"), **kw)
                self.loaded[mc.name] = lm
        return lm

    def shutdown(self):
        for lm in self.loaded.values():
            lm.engine.shutdown()
        self.loaded.clear()
