"""Where bf16 W8's / W4's device time goes: the tensor-core kernel of
csrc/quant_matmul.cu timed with one piece of its tile loop cut out at a
time, at ab_time's W8 / W4 shapes (w_gate, wk and lm_head at decode M = 8,
w_gate at a 512-token pack), in one process on one card.

    python -m localai_tpu_torch.ops.kernels.ablate_quant [--rounds 6] [--iters 30]

Variants (the source with one piece removed):

  nowiden    raw tiles are not widened (the products read stale bf16 tiles)
  nowgmma    the products are not issued (the widening still runs)
  copyonly   neither: the loop only stages the tiles (its cp.async stream,
             the waits and the barriers)

Their outputs are wrong by design; only the times mean something. Full
minus a variant is what that piece costs on the critical path; the pieces
overlap, so the differences need not add up. Each round times every
variant once (mean of ``--iters`` launches, L2 flushed before each);
prints the medians as one JSON line with the card's name and power limit.
A variant whose cut no longer matches the source raises.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import statistics
import subprocess

import torch

from localai_tpu_torch.ops.kernels import ab_time, build

_SRC = os.path.join(build.CSRC, "quant_matmul.cu")
_WIDEN = "    widen(t, st);\n"
_WGMMA = ("      wgmma_ss_ta<TN>(acc, smem_desc(a + ks * 16 * 128, kTileK * 128, 1024),\n"
          "                      smem_desc(b + ks * 32, 16, 1024), 1);\n")
_TOUCH = "      acc[ks] += 1.f;\n"   # keeps the accumulators live


def variants(src: str) -> dict:
    out = {"full": src,
           "nowiden": src.replace(_WIDEN, ""),
           "nowgmma": src.replace(_WGMMA, _TOUCH),
           "copyonly": src.replace(_WIDEN, "").replace(_WGMMA, _TOUCH)}
    for name, text in out.items():
        if name != "full" and text == src:
            raise ValueError(f"ablate_quant: variant {name} no longer matches the source")
    return out


def _build(name: str, text: str) -> dict:
    d = os.path.join(build.BUILD_DIR, "ablate_quant", name)
    os.makedirs(d, exist_ok=True)
    for fn in os.listdir(build.CSRC):
        if fn.endswith(".cuh"):
            shutil.copy(os.path.join(build.CSRC, fn), d)
    src = os.path.join(d, "quant_matmul.cu")
    with open(src, "w") as f:
        f.write(text)
    out = os.path.join(d, "libquant_matmul.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
                   check=True, capture_output=True, text=True)
    return ab_time.bind(out, build.SIGNATURES["quant_matmul"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ablate_quant")
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--iters", type=int, default=30)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_quant: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with open(_SRC) as f:
        texts = variants(f.read())
    with concurrent.futures.ThreadPoolExecutor(len(texts)) as pool:   # one nvcc each
        futs = {name: pool.submit(_build, name, text) for name, text in texts.items()}
        fns = {name: {"quant_matmul": f.result()} for name, f in futs.items()}
    inp = ab_time.quant_inputs(torch.Generator(device="cuda").manual_seed(1234))
    calls = {name: ab_time.quant_calls(f, True, inp) for name, f in fns.items()}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    summary = {}
    for label, *_rest in ab_time.QUANT_CASES:
        sides = {name: c[label] for name, c in calls.items()}
        for call in sides.values():          # warm-up
            for _ in range(3):
                call()
        torch.cuda.synchronize()
        times = {name: [] for name in sides}
        for _ in range(args.rounds):
            for name, call in sides.items():
                times[name].append(ab_time.mean_ms(call, args.iters, flush))
        summary[label] = {name: statistics.median(v) for name, v in times.items()}
        print(f"{card}: {label} median ms {summary[label]}", flush=True)
    print(json.dumps({"card": card, "rounds": args.rounds, "iters": args.iters,
                      "median_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
