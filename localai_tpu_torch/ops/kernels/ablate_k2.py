"""Where K2's device time goes: the tensor-core body of
csrc/ragged_prefill.cu timed with one piece of its tile loop cut out at a
time, at ab_time's shapes (K2 and K2-int8 on a 476-token chunk over 1024
committed rows, K2 on a fresh 512-token pack), in one process on one card.

    python -m localai_tpu_torch.ops.kernels.ablate_k2 [--rounds 6] [--iters 50]

Variants (the source with one piece removed):

  noload     tiles after the first two are not copied (later tiles compute
             on stale shared memory)
  nosoftmax  the register softmax (P is the raw scores)
  nopv       the O += P V product
  nos        the S = Q K^T product
  nowiden    int8 tiles are not widened to bf16

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

_SRC = os.path.join(build.CSRC, "ragged_prefill.cu")


def _cut(src: str, start: str, end: str, new: str) -> str:
    """``src`` with [start, end) replaced by ``new``."""
    i = src.index(start)
    return src[:i] + new + src[src.index(end, i):]


def variants(src: str) -> dict:
    out = {
        "full": src,
        "noload": src.replace("    if (t + 2 < T) {\n      issue(pi, pj, t + 2, pf);",
                              "    if (false) {\n      issue(pi, pj, t + 2, pf);"),
        "nosoftmax": _cut(src, "    const float cs = scaled ? 1.f : c2;\n",
                          "    // P as the register A operand",
                          "    float alpha[2] = {1.f, 1.f};\n"),
        "nopv": src.replace(
            "      wgmma_rs<HDP>(o, pa[kb], smem_desc(vd + kb * 16 * 128, KT * 128, 1024));",
            "      o[kb] += __uint_as_float(pa[kb][0]);"),
        "nos": _cut(src, "    wgmma_fence();\n#pragma unroll\n    for (int ks = 0;",
                    "    wgmma_commit();\n    // tile t + 2",
                    "    for (int x = 0; x < KT / 2; ++x) s[x] = __int_as_float(x + tid);\n"),
        "nowiden": _cut(src, "        for (int u = tid; u < KT * C::CH; u += kThreads) {",
                        "        fence_proxy_async();\n        __syncthreads();\n      }\n    }",
                        ""),
    }
    for name, text in out.items():
        if name != "full" and text == src:
            raise ValueError(f"ablate_k2: variant {name} no longer matches the source")
    return out


def _build(name: str, text: str) -> dict:
    d = os.path.join(build.BUILD_DIR, "ablate", name)
    os.makedirs(d, exist_ok=True)
    for fn in os.listdir(build.CSRC):
        if fn.endswith(".cuh"):
            shutil.copy(os.path.join(build.CSRC, fn), d)
    src = os.path.join(d, "ragged_prefill.cu")
    with open(src, "w") as f:
        f.write(text)
    out = os.path.join(d, "libragged_prefill.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
                   check=True, capture_output=True, text=True)
    return ab_time.bind(out, build.SIGNATURES["ragged_prefill"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ablate_k2")
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_k2: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with open(_SRC) as f:
        texts = variants(f.read())
    with concurrent.futures.ThreadPoolExecutor(len(texts)) as pool:   # one nvcc each
        futs = {name: pool.submit(_build, name, text) for name, text in texts.items()}
        fns = {name: {"ragged_prefill": f.result()} for name, f in futs.items()}
    inp = ab_time.make_inputs(torch.Generator(device="cuda").manual_seed(1234))
    calls = {name: ab_time.prefill_calls(f, inp) for name, f in fns.items()}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    summary = {}
    for kernel in ("K2", "K2-int8", "K2 fresh"):
        sides = {name: c[kernel] for name, c in calls.items()}
        for call in sides.values():          # warm-up
            for _ in range(3):
                call()
        torch.cuda.synchronize()
        times = {name: [] for name in sides}
        for _ in range(args.rounds):
            for name, call in sides.items():
                times[name].append(ab_time.mean_ms(call, args.iters, flush))
        summary[kernel] = {name: statistics.median(v) for name, v in times.items()}
        print(f"{card}: {kernel} median ms {summary[kernel]}", flush=True)
    print(json.dumps({"card": card, "rounds": args.rounds, "iters": args.iters,
                      "median_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
