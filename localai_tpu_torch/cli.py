"""Command line (counterpart of localai_tpu/cli.py):

    python -m localai_tpu_torch run --model DIR --name NAME \\
        --address 127.0.0.1:8080 [--num-slots 8] [--context-size 2048] \\
        [--dtype bfloat16] [--quantization int8|int4] \\
        [--kv-cache-dtype int8] [--kv-layout contiguous] \\
        [--kv-page-size 64] [--prefill-chunk 512] [--decode-burst 16] \\
        [--pipeline-depth 2] [--prefill-packed-fuse auto] \\
        [--kv-offload 1] [--kv-host-pool-mb 256] [--kv-host-store PATH] \\
        [--random-weights SEED] [--device cuda]

serves one model over the OpenAI-compatible HTTP routes until
interrupted.
"""

from __future__ import annotations

import argparse
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="localai_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="serve one model over HTTP")
    r.add_argument("--model", required=True, help="model dir (config.json + "
                   "safetensors, or config.json only with --random-weights)")
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
    r.add_argument("--random-weights", type=int, default=None, metavar="SEED",
                   help="serve random weights from SEED for a config-only dir")
    r.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    from localai_tpu_torch.api.app import App, make_server
    from localai_tpu_torch.backend.runner import load_model

    host, _, port = args.address.rpartition(":")
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
                    kv_host_store=args.kv_host_store)
    app = App({lm.name: lm})
    server = make_server(app, host or "127.0.0.1", int(port))
    logging.getLogger(__name__).info("serving %s on http://%s:%d", lm.name,
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
