"""Command line (counterpart of localai_tpu/cli.py):

    python -m localai_tpu_torch run --models-path DIR \\
        [--address 127.0.0.1:8080] [--context-size 2048] \\
        [--load-to-memory NAME ...] [--device cuda]

serves every model a ``*.yaml`` file in DIR configures (the JAX server's
front door: config/model_config.py::scan_models_dir, the guessed family
templates, each model loaded at its first request; an unknown name is a
model dir of that name under DIR with a default config; the serving knobs
of a model are its config's fields and ``options``, ``random_weights=SEED``
included: a flag of the ``--model`` form given here is refused), and

    python -m localai_tpu_torch run --model DIR|FILE.gguf --name NAME \\
        --address 127.0.0.1:8080 [--num-slots 8] [--context-size 2048] \\
        [--dtype bfloat16] [--quantization int8|int4] \\
        [--kv-cache-dtype int8] [--kv-layout contiguous] \\
        [--kv-page-size 64] [--prefill-chunk 512] [--decode-burst 16] \\
        [--pipeline-depth 2] [--prefill-packed-fuse auto] \\
        [--kv-offload 1] [--kv-host-pool-mb 256] [--kv-host-store PATH] \\
        [--max-queued-requests 256] [--max-queue-wait-ms 0] \\
        [--request-timeout-ms 0] [--dispatch-stall-ms 30000] \\
        [--preempt 1] [--priority-weights 4:2:1] [--max-preemptions 2] \\
        [--resume-reserve-pages 0] [--priority normal] \\
        [--priority-aging-ms 4000] \\
        [--draft auto] [--draft-model DIR] [--n-draft 4] \\
        [--spec-ngram 3] [--emitter 1] \\
        [--trace 1] [--trace-ring-size 4096] [--slow-request-ms 0] \\
        [--stall-dump-dir DIR] [--event-log PATH|stderr|off] \\
        [--event-log-max-mb 64] [--peak-tflops 0] [--kv-audit on] \\
        [--random-weights SEED] [--device cuda]

serves one model, set up by the flags, under a default model config (a
GGUF checkpoint, named directly or as the one ``*.gguf`` of a dir, gives
its config and tokenizer; a LoRA adapter comes only through a model
YAML's ``lora_adapter``, as in the JAX CLI).
Either serves the OpenAI-compatible HTTP routes, and /metrics and
/debug/{trace,state,events,kv}, until interrupted.
"""

from __future__ import annotations

import argparse
import functools
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="localai_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="serve models over HTTP")
    src = r.add_mutually_exclusive_group(required=True)
    src.add_argument("--models-path", default="",
                     help="a dir of model YAML configs (and model dirs)")
    src.add_argument("--model", default="", help="one model dir (config.json "
                     "+ safetensors, or config.json only with "
                     "--random-weights) or GGUF file (or a dir holding one)")
    r.add_argument("--load-to-memory", action="append", default=[],
                   metavar="NAME", help="with --models-path: load this model "
                   "at start rather than at its first request")
    r.add_argument("--name", default="", help="served model name")
    r.add_argument("--address", default="127.0.0.1:8080", help="host:port")
    r.add_argument("--num-slots", type=int, default=8)
    r.add_argument("--context-size", type=int, default=2048)
    r.add_argument("--dtype", default="bfloat16")
    r.add_argument("--quantization", default="",
                   help="weight-only matmul weights: int8 (per output "
                        "channel) | int4 (groups of up to 128 rows; embed "
                        "and lm_head stay int8); default: dense")
    r.add_argument("--kv-cache-dtype", default="",
                   help="KV cache dtype (default: the model dtype); int8 / "
                        "q8_0 = int8 rows with per-row scales")
    r.add_argument("--kv-layout", default="auto",
                   help="auto (= paged) | paged | contiguous")
    r.add_argument("--kv-page-size", type=int, default=64)
    r.add_argument("--prefill-chunk", type=int, default=512,
                   help="max prompt tokens per slot per prefill tick")
    r.add_argument("--decode-burst", type=int, default=16,
                   help="decode steps per host sync")
    r.add_argument("--pipeline-depth", type=int, default=2,
                   help="decode bursts in flight (1 waits for every burst)")
    r.add_argument("--prefill-packed-fuse", default="auto",
                   help="auto (= split) | split | 1 | 0: chain a decode "
                        "burst behind a pack with final segments")
    r.add_argument("--kv-offload", default="1",
                   help="the host tier of prefix reuse: 1 (default) | 0 "
                        "(also true/false, on/off, yes/no)")
    r.add_argument("--kv-host-pool-mb", type=int, default=256,
                   help="the host tier's budget in MiB (>= 1)")
    r.add_argument("--kv-host-store", default="",
                   help="save the host tier here at shutdown and load it at "
                        "start; a relative path lands under "
                        "<model>/prompt_cache/")
    # the request lifecycle and the priority scheduler (the JAX names and
    # defaults; engine/engine.py::EngineConfig)
    r.add_argument("--max-queued-requests", type=int, default=256,
                   help="shed (429) beyond this many queued requests; 0 = "
                        "unbounded")
    r.add_argument("--max-queue-wait-ms", type=int, default=0,
                   help="shed queued requests older than this; 0 = off")
    r.add_argument("--request-timeout-ms", type=int, default=0,
                   help="per-request deadline (504); 0 = off")
    r.add_argument("--dispatch-stall-ms", type=int, default=30000,
                   help="abort (503) the requests of a pack or burst whose "
                        "results are this late; 0 = wait for ever")
    r.add_argument("--preempt", default="1",
                   help="the preemptive priority scheduler: 1 (default) | 0 "
                        "(strict FIFO)")
    r.add_argument("--priority-weights", default="4:2:1",
                   help="high:normal:low shares of the prefill budget")
    r.add_argument("--max-preemptions", type=int, default=2)
    r.add_argument("--resume-reserve-pages", type=int, default=0,
                   help="pages held back from fresh admissions while "
                        "preempted requests wait; 0 = autosized")
    r.add_argument("--priority", default="normal",
                   help="the class of a request that names none: high | "
                        "normal | low")
    r.add_argument("--priority-aging-ms", type=int, default=4000,
                   help="queued work older than this ranks one class higher; "
                        "0 = off")
    # speculation (the JAX names and defaults)
    r.add_argument("--draft", default="auto",
                   help="auto (the draft model when --draft-model is given, "
                        "else ngram: prompt-lookup self-speculation) | ngram "
                        "| model (off without --draft-model) | 0 / off")
    r.add_argument("--draft-model", default="",
                   help="a smaller llama-family model dir (config.json + "
                        "safetensors, or a GGUF file; relative to --model) "
                        "that proposes "
                        "the speculative tokens; with --random-weights a "
                        "config-only dir gets random weights (seed + 1)")
    r.add_argument("--n-draft", type=int, default=4,
                   help="proposals per speculative round; 0 = off")
    r.add_argument("--spec-ngram", type=int, default=3,
                   help="the n-gram length prompt lookup matches")
    r.add_argument("--emitter", default="1",
                   help="1: detokenization, stop sequences and stream writes "
                        "on the emitter thread; 0: inline on the engine thread")
    # observability (the JAX names and defaults)
    r.add_argument("--trace", default="1",
                   help="the request span tracer: 1 (default) | 0")
    r.add_argument("--trace-ring-size", type=int, default=4096,
                   help="spans kept in the ring")
    r.add_argument("--slow-request-ms", type=int, default=0,
                   help="log a request whose TTFT or end-to-end time exceeds "
                        "this; 0 = off")
    r.add_argument("--stall-dump-dir", default="",
                   help="where stall span-ring dumps and flight dumps land "
                        "(default: the temp dir)")
    r.add_argument("--event-log", default="",
                   help="the event log's sink: a path | stderr | off (the "
                        "ring at /debug/events is kept either way)")
    r.add_argument("--event-log-max-mb", type=int, default=64,
                   help="rotate the event-log file at this size; 0 = never")
    r.add_argument("--peak-tflops", type=float, default=0.0,
                   help="the card's peak TFLOP/s for MFU; 0 = by card name")
    r.add_argument("--kv-audit", default="on",
                   help="the KV lifecycle auditor: on (report) | strict "
                        "(raise) | off")
    r.add_argument("--random-weights", type=int, default=None, metavar="SEED",
                   help="serve random weights from SEED for a config-only dir")
    r.add_argument("--device", default="cuda")
    return p


# what ``run --models-path`` reads; every other flag is the --model form's
_MODELS_PATH_FLAGS = ("cmd", "models_path", "load_to_memory", "address",
                      "context_size", "device")


def model_form_error(args) -> str:
    """The error for the flags of the ``--model`` form that ``args`` sets
    (each differs from its default) beside ``--models-path``, which would
    not read them ("" when there are none)."""
    if not args.models_path:
        return ""
    defaults = vars(build_parser().parse_args(["run", "--models-path", "-"]))
    stray = ["--" + k.replace("_", "-") for k, v in sorted(vars(args).items())
             if k not in _MODELS_PATH_FLAGS and v != defaults.get(k)]
    return stray and (f"{', '.join(stray)}: flags of the --model form; with "
                      f"--models-path set them in each model's YAML (its "
                      f"fields or options)") or ""


def build_app(args):
    """The App that ``run`` serves (``--models-path``: the scanned configs,
    models loaded on demand; ``--model``: the one model, loaded now). A
    flag of the ``--model`` form beside ``--models-path`` raises
    ValueError: a model's settings are its YAML's there."""
    from localai_tpu_torch.api.app import App
    from localai_tpu_torch.backend.runner import load_model

    if args.models_path:
        from localai_tpu_torch.capabilities import Capabilities
        from localai_tpu_torch.config.model_config import scan_models_dir

        err = model_form_error(args)
        if err:
            raise ValueError(err)
        skipped = {}
        configs = scan_models_dir(args.models_path, skipped)
        caps = Capabilities(args.models_path, configs,
                            functools.partial(load_model, device=args.device),
                            context_size=args.context_size, skipped=skipped)
        for name in args.load_to_memory:
            caps.load(caps.resolve(name))
        return App(caps=caps)
    lm = load_model(args.model, args.name, num_slots=args.num_slots,
                    context_size=args.context_size, dtype=args.dtype,
                    random_weights=args.random_weights, device=args.device,
                    quantization=args.quantization,
                    kv_cache_dtype=args.kv_cache_dtype, kv_layout=args.kv_layout,
                    kv_page_size=args.kv_page_size,
                    prefill_chunk=args.prefill_chunk,
                    decode_burst=args.decode_burst,
                    pipeline_depth=args.pipeline_depth,
                    prefill_packed_fuse=args.prefill_packed_fuse,
                    kv_offload=args.kv_offload,
                    kv_host_pool_mb=args.kv_host_pool_mb,
                    kv_host_store=args.kv_host_store,
                    max_queued_requests=args.max_queued_requests,
                    max_queue_wait_ms=args.max_queue_wait_ms,
                    request_timeout_ms=args.request_timeout_ms,
                    dispatch_stall_ms=args.dispatch_stall_ms,
                    preempt=args.preempt,
                    priority_weights=args.priority_weights,
                    max_preemptions=args.max_preemptions,
                    resume_reserve_pages=args.resume_reserve_pages,
                    priority=args.priority,
                    priority_aging_ms=args.priority_aging_ms,
                    emitter=args.emitter,
                    trace=args.trace, trace_ring_size=args.trace_ring_size,
                    slow_request_ms=args.slow_request_ms,
                    stall_dump_dir=args.stall_dump_dir,
                    event_log=args.event_log,
                    event_log_max_mb=args.event_log_max_mb,
                    peak_tflops=args.peak_tflops, kv_audit=args.kv_audit,
                    draft=args.draft, n_draft=args.n_draft,
                    spec_ngram=args.spec_ngram, draft_model=args.draft_model)
    return App({lm.name: lm})


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    err = model_form_error(args)
    if err:
        p.error(err)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    from localai_tpu_torch.api.app import make_server

    host, _, port = args.address.rpartition(":")
    app = build_app(args)
    server = make_server(app, host or "127.0.0.1", int(port))
    logging.getLogger(__name__).info(
        "serving %s on http://%s:%d",
        ", ".join(sorted(set(app.caps.configs) | set(app.models))),
        *server.server_address[:2])
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        app.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
