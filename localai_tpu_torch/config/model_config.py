"""Per-model YAML configuration (a copy of
localai_tpu/config/model_config.py, read with config/yaml_lite.py: the
card's machine has no ``yaml``).

The model name, backend selection, sampling parameter defaults, prompt
templates, context and cache knobs, the function-calling config (ONE
``FunctionsConfig``: functions/parse.py's, which the tool-call parser
reads), the response post-processing (cutstrings, extract_regex,
trimspace, trimsuffix) and the usecase flags used for routing, with the
JAX validation. Fields of modules the port has not yet (the mesh, LoRA,
mmproj, the diffusion and TTS fields, self-extend, the prompt cache, and
option knobs such as the SLO objectives) are read and validated as in
JAX; loading a model whose config sets one of them raises, naming the
slice that brings it (capabilities.py::unported_settings).
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Any, Optional

from localai_tpu_torch.config import yaml_lite as yaml
from localai_tpu_torch.functions.parse import FunctionsConfig

# diffusion schedulers implemented by models/sd.py (single source of
# truth for YAML validation, the HTTP route, and the sampler itself —
# importable without pulling in jax)
SCHEDULERS = ("ddim", "euler", "euler_a", "dpmpp_2m")

# Accepted kv_cache_dtype names — the SINGLE source of truth; the backend
# (backend/runner.py) maps these to jnp dtypes and asserts it covers
# exactly this set, so the YAML validator and the runner can't drift.
KV_CACHE_DTYPES = ("bfloat16", "bf16", "float16", "f16", "float32", "f32",
                   "int8", "q8_0")


class Usecase(enum.Flag):
    """Routing flags (reference: backend_config.go:432-548)."""
    NONE = 0
    CHAT = enum.auto()
    COMPLETION = enum.auto()
    EDIT = enum.auto()
    EMBEDDINGS = enum.auto()
    IMAGE = enum.auto()
    TTS = enum.auto()
    TRANSCRIPT = enum.auto()
    RERANK = enum.auto()
    SOUND_GENERATION = enum.auto()
    TOKENIZE = enum.auto()
    VISION = enum.auto()
    ANY = (CHAT | COMPLETION | EDIT | EMBEDDINGS | IMAGE | TTS | TRANSCRIPT
           | RERANK | SOUND_GENERATION | TOKENIZE | VISION)


@dataclasses.dataclass
class PredictionParams:
    """Sampling defaults (reference: core/schema/prediction.go)."""
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    min_p: Optional[float] = None
    typical_p: Optional[float] = None
    max_tokens: Optional[int] = None
    repeat_penalty: Optional[float] = None
    repeat_last_n: Optional[int] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    mirostat: Optional[int] = None
    mirostat_tau: Optional[float] = None
    mirostat_eta: Optional[float] = None
    seed: Optional[int] = None
    echo: bool = False
    n: int = 1
    logit_bias: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TemplateConfig:
    """Prompt templates (reference: backend_config.go TemplateConfig)."""
    chat: str = ""
    chat_message: str = ""
    completion: str = ""
    edit: str = ""
    function: str = ""
    use_tokenizer_template: bool = False
    join_chat_messages_by_character: Optional[str] = None
    multimodal: str = ""


@dataclasses.dataclass
class ModelConfig:
    name: str = ""
    backend: str = ""                 # "" => greedy autodetect
    description: str = ""
    usage: str = ""
    parameters: PredictionParams = dataclasses.field(default_factory=PredictionParams)
    model: str = ""                   # weights path / HF repo / URL
    tokenizer: str = ""               # defaults to model dir
    context_size: Optional[int] = None
    embeddings: bool = False
    stopwords: list = dataclasses.field(default_factory=list)
    template: TemplateConfig = dataclasses.field(default_factory=TemplateConfig)
    function: FunctionsConfig = dataclasses.field(default_factory=FunctionsConfig)
    system_prompt: str = ""
    # response post-processing (reference: Finetune, core/backend/llm.go:179-227)
    cutstrings: list = dataclasses.field(default_factory=list)
    extract_regex: list = dataclasses.field(default_factory=list)
    trimspace: list = dataclasses.field(default_factory=list)
    trimsuffix: list = dataclasses.field(default_factory=list)
    # TPU-native knobs (replace gpu_layers/tensor_split/low_vram/...)
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"
    # "" | int8 (weight-only per-channel) | int4 (weight-only group-128
    # for layer matmuls, embed/lm_head int8 — llama-family only)
    quantization: str = ""
    num_slots: int = 8                # reference: LLAMACPP_PARALLEL slots
    # free-form "k=v" strings forwarded on the backend options wire
    # (reference: BackendConfig.Options, backend_config.go) — e.g. the
    # video knobs num_frames=14,fps=7,motion=1.0, or the paged-KV knobs
    # kv_layout=paged|contiguous, kv_page_size=N, kv_pool_pages=N,
    # kv_prefix_cache=0|1 (cross-release prefix cache, default on),
    # kv_prefix_cache_min_rows=N (reuse threshold, default 16),
    # kv_offload=0|1 (host-RAM page offload tier, default on),
    # kv_host_pool_mb=N (host tier byte budget), kv_host_store=path
    # (persist offloaded chains across restarts), the long-context
    # window knobs kv_window_pages=N (bounded on-device working set,
    # 0 = off), kv_sink_pages=N (attention-sink head pages pinned on
    # device), kv_window_policy=demote|drop (cold middle pages demote
    # to host or drop) and kv_prefetch_ahead=N (decode-time restore
    # pipeline depth, 0 = off), or the ragged
    # packed-prefill knobs prefill_packed=0|1 (default on; 0 restores
    # per-slot bucketed prefill), prefill_token_budget=N (max packed
    # prompt tokens per scheduler tick, 0 = engine auto) and
    # prefill_packed_fuse=auto|0|1|split (fuse the packed step with the
    # decode burst; 1 = one monolithic program, split = early-emit
    # back-to-back pair, auto = split everywhere) and
    # comm_overlap=auto|0|1 (TokenWeave-style halved-pack overlap of
    # per-layer collectives with compute; auto = meshed backends only,
    # bit-exact either way), or the
    # observability knobs trace=0|1 (request-lifecycle span tracer,
    # default on), trace_ring_size=N (retained spans, default 4096) and
    # slow_request_ms=N (log a span decomposition when TTFT or e2e
    # exceeds N ms; 0 = off), or the system-observability knobs
    # event_log=path|stderr|off (structured JSON-lines event sink for the
    # backend process; the ring at /debug/events works regardless) and
    # peak_tflops=N (override the device peak used for MFU — needed on
    # CPU/unknown device kinds where the built-in table reports 0), or
    # the per-class SLO objectives slo_ttft_ms= / slo_itl_ms=
    # / slo_queue_wait_ms= with value "500" (all classes), "250:1000:5000"
    # (high:normal:low) or "high=250:low=5000" (named subset) and
    # slo_error_budget=F (allowed violation fraction, default 0.01), or
    # the speculative-decoding knobs draft=auto|model|ngram|0
    # (auto = draft model when loaded, else n-gram self-speculation;
    # 0 disables), n_draft=N (proposal depth per round, 0 disables) and
    # spec_ngram=N (lookup n-gram length, default 3), or the replica-pool
    # knob engines=N (N>1 serves the model from N engine
    # replicas behind prefix-affinity routing, sharing ONE host KV tier;
    # requires preempt=1 — pause/resume is the migration primitive.
    # engines=1, the default, builds a plain single Engine bit-for-bit),
    # or the autoscaling knobs autoscale=0|1 (default 0; 1
    # runs the SLO-driven replica autoscaler on the pool housekeeping
    # cadence — requires preempt=1), autoscale_min=N / autoscale_max=N
    # (replica bounds; max 0 = twice the configured engines),
    # autoscale_burn_out=F / autoscale_burn_in=F (short-window SLO burn
    # thresholds for scale-out / scale-in), autoscale_dwell_ms=N /
    # autoscale_cooldown_ms=N (hysteresis brakes) and weight_prefetch=0|1
    # (default 0; 1 streams weight loads leaf-at-a-time and warms the
    # predicted-next gallery model's checkpoint bytes ahead of its first
    # request).
    # The known knobs are value-validated in validate() so a typo fails
    # at config scan instead of silently running the default.
    options: list = dataclasses.field(default_factory=list)
    mesh: dict = dataclasses.field(default_factory=dict)  # {dp: 1, tp: 8, ...}
    prefill_buckets: list = dataclasses.field(default_factory=list)
    # decode tokens per burst dispatch (0 = engine default). Trades
    # per-dispatch overhead against finish-detection latency: smaller
    # bursts admit/release slots sooner (r5 on the serving chip, 8B-int8
    # at 32 slots: burst 8 beat 16 on BOTH throughput and TTFT)
    decode_burst: int = 0
    max_batch_prefill: int = 1
    # capability routing
    known_usecases: Optional[list] = None
    # download source for `model` when it is a URL/hf repo
    download_files: list = dataclasses.field(default_factory=list)
    # multimodal
    mmproj: str = ""
    # diffusion (reference: diffusers backend SchedulerType + img2img,
    # backend.py:169-357): default scheduler for this model
    # (one of SCHEDULERS below; models/sd.py implements them)
    scheduler: str = ""
    # ControlNet dir (diffusers ControlNetModel layout), absolute or
    # relative to the pipeline dir (reference: diffusers backend
    # controlnet attach, backend.py:297-314)
    controlnet: str = ""
    # voice clone: reference audio for tone-color conditioning
    # (reference: ModelOptions.AudioPath, vall-e-x/backend.py:61-68)
    audio_path: str = ""
    # speculative decoding (future)
    draft_model: str = ""
    # LoRA (reference: backend.proto LoraAdapter/LoraBase/LoraScale)
    lora_adapter: str = ""
    lora_base: str = ""
    lora_scale: float = 0.0           # 0 = default 1.0
    # prompt-cache persistence (reference: PromptCachePath/RO/All,
    # options.go:182-191): KV rows + tokens survive restarts on disk
    prompt_cache_path: str = ""
    prompt_cache_ro: bool = False
    prompt_cache_all: bool = False
    # self-extend / group attention (reference: ga_n/ga_w slot state,
    # grpc-server.cpp:209-213): >1 compresses RoPE positions of completed
    # ga_w windows by group_attn_n, extending usable context past the
    # model's training window
    group_attn_n: int = 1
    group_attn_w: int = 512

    def validate(self) -> list:
        problems = []
        if not self.name:
            problems.append("model config missing 'name'")
        if self.context_size is not None and self.context_size <= 0:
            problems.append(f"context_size must be positive, got {self.context_size}")
        if self.num_slots <= 0:
            problems.append(f"num_slots must be positive, got {self.num_slots}")
        if self.scheduler and self.scheduler not in SCHEDULERS:
            problems.append(f"unknown scheduler {self.scheduler!r}")
        if self.kv_cache_dtype.lower() not in KV_CACHE_DTYPES:
            problems.append(
                f"unknown kv_cache_dtype {self.kv_cache_dtype!r}")
        if self.decode_burst < 0:
            problems.append(
                f"decode_burst must be >= 0 (0 = engine default), "
                f"got {self.decode_burst}")
        if self.group_attn_n < 1:
            problems.append(
                f"group_attn_n must be >= 1, got {self.group_attn_n}")
        elif self.group_attn_n > 1:
            if self.group_attn_w <= 0:
                problems.append(
                    f"group_attn_w must be positive, got {self.group_attn_w}")
            elif self.group_attn_w % self.group_attn_n != 0:
                # a non-divisible window makes adjacent compressed blocks
                # share a boundary RoPE position
                problems.append(
                    f"group_attn_w ({self.group_attn_w}) must be divisible "
                    f"by group_attn_n ({self.group_attn_n})")
        bool_vals = ("0", "1", "true", "false", "on", "off", "yes", "no")
        for o in self.options or []:
            s = str(o)
            if "=" not in s:
                continue
            k, v = (p.strip() for p in s.split("=", 1))
            if k == "kv_layout" and v not in ("auto", "paged", "contiguous"):
                problems.append(
                    f"kv_layout must be auto|paged|contiguous, got {v!r}")
            elif k in ("kv_page_size", "kv_pool_pages",
                       "kv_prefix_cache_min_rows",
                       "kv_host_pool_mb",
                       "prefill_token_budget",
                       "trace_ring_size",
                       "slow_request_ms",
                       # fault-tolerant lifecycle knobs;
                       # explicit 0 disables the respective bound
                       "max_queued_requests",
                       "max_queue_wait_ms",
                       "request_timeout_ms",
                       "dispatch_stall_ms",
                       # event-log rotation bound; 0 disables
                       "event_log_max_mb",
                       # priority scheduler; 0 disables the
                       # respective guard (aging / reserve / preemption cap)
                       "max_preemptions",
                       "resume_reserve_pages",
                       "priority_aging_ms",
                       # speculative decoding; explicit
                       # n_draft=0 disables speculation
                       "n_draft",
                       # long-context serving tier; 0 = window
                       # off / prefetch off, sink defaults to 1 page
                       "kv_window_pages",
                       "kv_sink_pages",
                       "kv_prefetch_ahead",
                       # autoscaling; autoscale_max=0 = auto
                       # (twice the configured engines)
                       "autoscale_max",
                       "autoscale_dwell_ms",
                       "autoscale_cooldown_ms",
                       # federated KV stream timing: peer cooldown / negative-cache TTL /
                       # connect timeout, all in ms
                       "kv_stream_cooldown_ms",
                       "kv_stream_negcache_ms",
                       "kv_stream_connect_timeout_ms",
                       # cluster control plane: heartbeat
                       # cadence, failure-detector windows, per-op
                       # deadline + retry schedule
                       "cluster_heartbeat_ms",
                       "cluster_suspect_ms",
                       "cluster_dead_ms",
                       "cluster_rpc_timeout_ms",
                       "cluster_rpc_retries",
                       "cluster_rpc_backoff_ms") and not v.isdigit():
                problems.append(
                    f"{k} must be a non-negative integer "
                    f"(0 = engine default), got {v!r}")
            elif k in ("kv_prefix_cache", "kv_offload",
                       "prefill_packed", "trace",
                       # dedicated emission worker; 0 restores
                       # the in-loop path
                       "emitter",
                       # preemptive scheduler; 0 restores
                       # strict-FIFO admission bit-for-bit
                       "preempt",
                       # SLO-driven autoscaling + predictive weight
                       # prefetch; both default off
                       "autoscale",
                       "weight_prefetch") and v.lower() not in bool_vals:
                problems.append(
                    f"{k} must be one of {bool_vals}, got {v!r}")
            elif k == "priority" and v.lower() not in ("high", "normal",
                                                       "low"):
                problems.append(
                    f"priority must be high|normal|low, got {v!r}")
            elif k == "priority_weights":
                try:
                    from localai_tpu_torch.engine.scheduler import (
                        parse_priority_weights)

                    parse_priority_weights(v)
                except ValueError as e:
                    problems.append(str(e))
            elif k == "prefill_packed_fuse" and v not in ("auto", "0", "1",
                                                          "split"):
                problems.append(
                    f"prefill_packed_fuse must be auto|0|1|split, got {v!r}")
            elif k == "comm_overlap" and v not in ("auto", "0", "1"):
                problems.append(
                    f"comm_overlap must be auto|0|1, got {v!r}")
            elif k == "kv_audit" and v not in ("off", "on", "strict"):
                problems.append(
                    f"kv_audit must be off|on|strict, got {v!r}")
            elif k == "kv_window_policy" and v not in ("demote", "drop"):
                problems.append(
                    f"kv_window_policy must be demote|drop, got {v!r}")
            elif k == "draft" and v.lower() not in (
                    "auto", "model", "ngram", "0", "off", "none", "false"):
                problems.append(
                    f"draft must be auto|model|ngram|0, got {v!r}")
            elif k == "spec_ngram" and not (v.isdigit() and int(v) > 0):
                problems.append(
                    f"spec_ngram must be a positive integer, got {v!r}")
            elif k == "engines" and not (v.isdigit() and int(v) > 0):
                problems.append(
                    f"engines must be a positive integer, got {v!r}")
            elif k == "autoscale_min" and not (v.isdigit() and int(v) > 0):
                problems.append(
                    f"autoscale_min must be a positive integer, got {v!r}")
            elif k in ("autoscale_burn_out", "autoscale_burn_in"):
                try:
                    if float(v) <= 0:
                        problems.append(
                            f"{k} must be > 0, got {v!r}")
                except ValueError:
                    problems.append(f"{k} must be a number, got {v!r}")
            elif k == "disagg" and v not in ("both", "prefill", "decode"):
                # prefill/decode disaggregation role
                problems.append(
                    f"disagg must be both|prefill|decode, got {v!r}")
            elif k == "cluster_mode" and v not in ("inproc", "process"):
                # cluster host placement
                problems.append(
                    f"cluster_mode must be inproc|process, got {v!r}")
            elif k == "kv_peers":
                # peer wire addresses, |-separated (the options wire
                # splits on commas): host:port[|host:port...]
                for a in v.split("|"):
                    a = a.strip()
                    h, _, p = a.rpartition(":")
                    if not h or not p.isdigit():
                        problems.append(
                            f"kv_peers entries must be host:port, got {a!r}")
                        break
            elif k == "kv_serve":
                # "1" (ephemeral port) or an explicit bind host:port
                if v.lower() not in ("0", "1", "false", "true", "off",
                                     "on", "no", "yes"):
                    h, _, p = v.rpartition(":")
                    if not h or not p.isdigit():
                        problems.append(
                            f"kv_serve must be 0|1|host:port, got {v!r}")
            elif k == "peak_tflops":
                try:
                    if float(v) < 0:
                        problems.append(
                            f"peak_tflops must be >= 0, got {v!r}")
                except ValueError:
                    problems.append(
                        f"peak_tflops must be a number, got {v!r}")
            elif k in ("slo_ttft_ms", "slo_itl_ms", "slo_queue_wait_ms"):
                # per-class SLO objectives: same fail-at-scan
                # contract as priority_weights — the parser IS the
                # validator
                try:
                    from localai_tpu_torch.services.sysobs import (
                        parse_slo_classes)

                    parse_slo_classes(v)
                except ValueError as e:
                    problems.append(str(e))
            elif k == "slo_error_budget":
                try:
                    if not 0 < float(v) <= 1:
                        problems.append(
                            f"slo_error_budget must be in (0, 1], got {v!r}")
                except ValueError:
                    problems.append(
                        f"slo_error_budget must be a number, got {v!r}")
        # cross-knob: the replica pool migrates via pause/resume, so a
        # pool without the preemptive scheduler could never rebalance or
        # crash-recover — fail at scan, not at model load
        opts = {}
        for o in self.options or []:
            s = str(o)
            if "=" in s:
                k, v = (p.strip() for p in s.split("=", 1))
                opts[k] = v
        if (opts.get("engines", "1").isdigit()
                and int(opts.get("engines", "1")) > 1
                and opts.get("preempt", "1").lower() in
                ("0", "false", "off", "no")):
            problems.append("engines>1 requires preempt=1 (pause/resume "
                            "is the pool's migration primitive)")
        # cross-knob: the autoscaler's scale-in drains via
        # the same pause/resume migration path
        if opts.get("autoscale", "0").lower() in ("1", "true", "on",
                                                  "yes"):
            if opts.get("preempt", "1").lower() in ("0", "false", "off",
                                                    "no"):
                problems.append("autoscale=1 requires preempt=1 (scale-in "
                                "drains via pause/resume migration)")
        amin, amax = opts.get("autoscale_min", ""), opts.get(
            "autoscale_max", "")
        if (amin.isdigit() and amax.isdigit() and int(amax) > 0
                and int(amin) > int(amax)):
            problems.append(f"autoscale_min ({amin}) must be <= "
                            f"autoscale_max ({amax})")
        # cross-knob: the failure-detector ladder only works
        # if the SUSPECT window opens strictly before the DEAD one — a
        # slow host must be able to sit in SUSPECT without dying
        sus, ded = opts.get("cluster_suspect_ms", ""), opts.get(
            "cluster_dead_ms", "")
        if (sus.isdigit() and ded.isdigit()
                and int(sus) >= int(ded) and int(ded) > 0):
            problems.append(f"cluster_suspect_ms ({sus}) must be < "
                            f"cluster_dead_ms ({ded})")
        # cross-knob: a disaggregated role ejects/splices via
        # the same pause/resume primitive, and ships chains through the
        # host tier — both must be armed
        if opts.get("disagg", "both") != "both":
            if opts.get("preempt", "1").lower() in ("0", "false", "off",
                                                    "no"):
                problems.append("disagg=prefill|decode requires preempt=1 "
                                "(pause/resume is the handoff primitive)")
            if opts.get("kv_offload", "1").lower() in ("0", "false", "off",
                                                       "no"):
                problems.append("disagg=prefill|decode requires "
                                "kv_offload=1 (chains ship via the host "
                                "tier)")
        return problems

    def usecases(self) -> Usecase:
        if self.known_usecases:
            u = Usecase.NONE
            for name in self.known_usecases:
                u |= Usecase[name.upper()]
            return u
        # heuristics mirroring reference GuessUsecases (backend_config.go:432)
        u = Usecase.CHAT | Usecase.COMPLETION | Usecase.EDIT | Usecase.TOKENIZE
        if self.embeddings:
            u |= Usecase.EMBEDDINGS
        if self.mmproj:
            u |= Usecase.VISION
        name = (self.backend or "").lower()
        if "diffus" in name or "image" in name:
            u = Usecase.IMAGE
        if "tts" in name or "bark" in name or "coqui" in name:
            u = Usecase.TTS
        if "whisper" in name:
            u = Usecase.TRANSCRIPT
        if "rerank" in name:
            u = Usecase.RERANK
        if self.embeddings and "bert" in name:
            u = Usecase.EMBEDDINGS | Usecase.TOKENIZE
        return u

    def sampling_host(self, request_overrides: Optional[dict] = None):
        """Merge config defaults + request overrides into engine params."""
        from localai_tpu_torch.engine.sampling import SamplingParamsHost

        p = self.parameters
        merged = {
            "temperature": p.temperature if p.temperature is not None else 0.8,
            "top_k": p.top_k if p.top_k is not None else 40,
            "top_p": p.top_p if p.top_p is not None else 0.95,
            "min_p": p.min_p if p.min_p is not None else 0.0,
            "typical_p": p.typical_p if p.typical_p is not None else 1.0,
            "repeat_penalty": p.repeat_penalty if p.repeat_penalty is not None else 1.0,
            "repeat_last_n": p.repeat_last_n if p.repeat_last_n is not None else 64,
            "presence_penalty": p.presence_penalty or 0.0,
            "frequency_penalty": p.frequency_penalty or 0.0,
            "mirostat": p.mirostat or 0,
            "mirostat_tau": p.mirostat_tau if p.mirostat_tau is not None else 5.0,
            "mirostat_eta": p.mirostat_eta if p.mirostat_eta is not None else 0.1,
            "seed": p.seed if p.seed is not None else -1,
            "logit_bias": dict(p.logit_bias or {}),
        }
        for k, v in (request_overrides or {}).items():
            if v is not None and k in merged:
                merged[k] = v
        return SamplingParamsHost(**merged)


def _build(data: dict) -> ModelConfig:
    data = dict(data)
    params = data.pop("parameters", {}) or {}
    # reference keeps model under parameters.model
    model = params.pop("model", "") or data.pop("model", "")
    tmpl = data.pop("template", {}) or {}
    func = data.pop("function", {}) or {}
    known_params = {f.name for f in dataclasses.fields(PredictionParams)}
    known_tmpl = {f.name for f in dataclasses.fields(TemplateConfig)}
    known_func = {f.name for f in dataclasses.fields(FunctionsConfig)}
    known_top = {f.name for f in dataclasses.fields(ModelConfig)}
    mc = ModelConfig(
        parameters=PredictionParams(**{k: v for k, v in params.items() if k in known_params}),
        template=TemplateConfig(**{k: v for k, v in tmpl.items() if k in known_tmpl}),
        function=FunctionsConfig(**{k: v for k, v in func.items() if k in known_func}),
        **{k: v for k, v in data.items() if k in known_top
           and k not in ("parameters", "template", "function")},
    )
    mc.model = model
    return mc


def load_model_config(path: str) -> ModelConfig:
    with open(path) as f:
        data = yaml.safe_load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: expected a mapping")
    mc = _build(data)
    if not mc.name:
        mc.name = os.path.splitext(os.path.basename(path))[0]
    return mc


def load_multi_config(path: str) -> list:
    """Single file with a list of model configs (reference:
    LoadMultipleBackendConfigsSingleFile)."""
    with open(path) as f:
        data = yaml.safe_load(f)
    if not isinstance(data, list):
        raise ValueError(f"{path}: expected a list of model configs")
    return [_build(d) for d in data]


def scan_models_dir(models_path: str,
                    skipped: Optional[dict] = None) -> dict:
    """Scan for per-model .yaml files (reference: LoadBackendConfigsFromPath).
    A broken config is logged and skipped; ``skipped``, where given, gets
    its name (the file's stem when its YAML gives none) -> the error, so
    that a request for that name answers with it."""
    configs = {}
    if not os.path.isdir(models_path):
        return configs
    for fn in sorted(os.listdir(models_path)):
        if not fn.endswith((".yaml", ".yml")) or fn.startswith("."):
            continue
        name = os.path.splitext(fn)[0]
        try:
            mc = load_model_config(os.path.join(models_path, fn))
            name = mc.name
            problems = mc.validate()
            if problems:
                raise ValueError("; ".join(problems))
            # fill missing chat templates/stopwords from the checkpoint
            # family (reference: guessDefaultsFromFile, guesser.go:145)
            from localai_tpu_torch.config.guesser import guess_defaults

            guess_defaults(mc, models_path)
            # the port's renderer compiles every template now: one outside
            # its subset skips the config here, never renders other text
            from localai_tpu_torch.templates.prompts import check

            check(mc)
            configs[mc.name] = mc
        except Exception as e:  # mirror reference: log and skip broken configs
            import logging
            logging.getLogger(__name__).warning("skipping %s: %s", fn, e)
            if skipped is not None:
                skipped[name] = f"{fn}: {e}"
    return configs
