"""A/B device time of the K1, K2 and K2-int8 kernels: this checkout's
sources against another checkout's, in one process on one card.

    python -m localai_tpu_torch.ops.kernels.ab_time --other DIR \\
        [--rounds 10] [--iters 50]

DIR is the root of another checkout (e.g. the parent commit unpacked with
``git archive``) whose csrc/ exports the same C launchers
``paged_decode_attention_launch`` (K1), ``ragged_prefill_attention_launch``
(K2) and ``ragged_prefill_attention_quant_launch`` (K2-int8). Both
libraries are built with this checkout's nvcc flags and called on the SAME
inputs at chip_smoke.py's serving shapes (bf16, Llama-3.1-8B heads: K1 over
8 slots with lengths 48/48/48/1516 and four idle slots; K2 and K2-int8 on a
476-token chunk over 1024 committed rows, bf16 or int8 pages; "K2 fresh"
on a fresh 512-token pack, mp = 0, the shape most of K2's serving launches
take). Each round times A, B, B,
A (mean of ``--iters`` launches each, L2 flushed before every launch,
CUDA events), so drift in clocks or power hits both sides alike. Prints
every round, then one JSON line with the medians and the spread
(interquartile range) per side, the number of rounds A won, and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import statistics
import subprocess

import torch

from localai_tpu_torch.ops.kernels import build

KV, G, HD, PG, MP, S = 8, 4, 128, 64, 64, 8
N_PAGES = S * MP
DECODE_LENGTHS = [48, 48, 48, 1516, 0, 0, 0, 0]
PREFILL_SEG = (0, 1024, 476)        # slot, committed rows, chunk tokens
FRESH_N = 512                        # a fresh pack: one 512-token segment


def bind(path: str, name: str) -> dict:
    """{launcher name: bound C function} of the library at ``path``, built
    from a ``name``.cu."""
    lib = ctypes.CDLL(path)
    fns = {}
    for fn_name, argtypes in build.SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[fn_name] = fn
    return fns


def _build(root: str, name: str, tag: str) -> dict:
    """The launchers of ``root``'s ``name``.cu, built with this checkout's
    flags."""
    src = os.path.join(root, "localai_tpu_torch", "ops", "kernels", "csrc",
                       f"{name}.cu")
    out_dir = os.path.join(build.BUILD_DIR, "ab", tag)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
                   check=True, capture_output=True, text=True)
    return bind(out, name)


def make_inputs(gen):
    from localai_tpu_torch.ops.kvcache import quantize

    dt = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    perm = torch.randperm(N_PAGES, generator=gen, device="cuda").to(torch.int32)

    def table(rows):
        ptab = torch.full((S, MP), N_PAGES, dtype=torch.int32, device="cuda")
        nxt = 0
        for s, r in enumerate(rows):
            n = -(-r // PG)
            ptab[s, :n] = perm[nxt:nxt + n]
            nxt += n
        return ptab

    pk, pv = randn(N_PAGES, PG, KV, HD), randn(N_PAGES, PG, KV, HD)
    (qk, sk), (qv, sv) = quantize(pk.float()), quantize(pv.float())
    dec = dict(q=randn(S, KV * G, HD), nk=randn(S, KV, HD), nv=randn(S, KV, HD),
               ptab=table(DECODE_LENGTHS),
               lens=torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda"))
    slot, start, n = PREFILL_SEG
    rows = [0] * S
    rows[slot] = start + n
    tabs = torch.zeros((4, S), dtype=torch.int32)
    tabs[0] = S
    tabs[:, 0] = torch.tensor([slot, start, 0, n])
    pre = dict(q=randn(n, KV * G, HD), ck=randn(n, KV, HD), cv=randn(n, KV, HD),
               ptab=table(rows), tabs=[t.cuda() for t in tabs],
               int8=(qk, sk, qv, sv))
    ftabs = torch.zeros((4, S), dtype=torch.int32)
    ftabs[0] = S
    ftabs[:, 0] = torch.tensor([0, 0, 0, FRESH_N])
    fresh = dict(q=randn(FRESH_N, KV * G, HD), ck=randn(FRESH_N, KV, HD),
                 cv=randn(FRESH_N, KV, HD), tabs=[t.cuda() for t in ftabs])
    return pk, pv, dec, pre, fresh


def make_calls(fns, pk, pv, dec, pre, fresh):
    """{kernel: {side: zero-argument launch}} for K1, K2, K2-int8 and K2
    on a fresh pack."""
    stream = torch.cuda.current_stream().cuda_stream
    out1 = torch.empty_like(dec["q"])
    out2 = torch.empty_like(pre["q"])
    out3 = torch.empty_like(fresh["q"])
    n = pre["q"].shape[0]

    def k1(fn):
        return lambda: build.check(fn(
            dec["q"].data_ptr(), dec["nk"].data_ptr(), dec["nv"].data_ptr(),
            pk.data_ptr(), pv.data_ptr(), dec["ptab"].data_ptr(),
            dec["lens"].data_ptr(), out1.data_ptr(), S, KV, G, HD, N_PAGES, PG,
            MP, 1, stream), "K1")

    def k2(fn):
        t = pre["tabs"]
        return lambda: build.check(fn(
            pre["q"].data_ptr(), pre["ck"].data_ptr(), pre["cv"].data_ptr(),
            pk.data_ptr(), pv.data_ptr(), pre["ptab"].data_ptr(), t[0].data_ptr(),
            t[1].data_ptr(), t[2].data_ptr(), t[3].data_ptr(), out2.data_ptr(),
            n, KV, G, HD, N_PAGES, PG, MP, S, S, 1, stream), "K2")

    def k2_int8(fn):
        t = pre["tabs"]
        qk, sk, qv, sv = pre["int8"]
        return lambda: build.check(fn(
            pre["q"].data_ptr(), pre["ck"].data_ptr(), pre["cv"].data_ptr(),
            qk.data_ptr(), sk.data_ptr(), qv.data_ptr(), sv.data_ptr(),
            pre["ptab"].data_ptr(), t[0].data_ptr(), t[1].data_ptr(),
            t[2].data_ptr(), t[3].data_ptr(), out2.data_ptr(),
            n, KV, G, HD, N_PAGES, PG, MP, S, S, 1, stream), "K2-int8")

    def k2_fresh(fn):      # mp = 0: the pool and the table are not read
        t = fresh["tabs"]
        return lambda: build.check(fn(
            fresh["q"].data_ptr(), fresh["ck"].data_ptr(), fresh["cv"].data_ptr(),
            None, None, None, t[0].data_ptr(), t[1].data_ptr(), t[2].data_ptr(),
            t[3].data_ptr(), out3.data_ptr(), FRESH_N, KV, G, HD, 0, 0, 0, S, S, 1,
            stream), "K2 fresh")

    rp = "ragged_prefill"
    return {"K1": {side: k1(f["paged_decode"]["paged_decode_attention_launch"])
                   for side, f in fns.items()},
            "K2": {side: k2(f[rp]["ragged_prefill_attention_launch"])
                   for side, f in fns.items()},
            "K2-int8": {side: k2_int8(f[rp]["ragged_prefill_attention_quant_launch"])
                        for side, f in fns.items()},
            "K2 fresh": {side: k2_fresh(f[rp]["ragged_prefill_attention_launch"])
                         for side, f in fns.items()}}


def mean_ms(call, iters: int, flush) -> float:
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def _iqr(xs):
    q = statistics.quantiles(xs, n=4)
    return q[2] - q[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ab_time")
    p.add_argument("--other", required=True, help="root of the B checkout")
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_time: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    roots = {"A": here, "B": os.path.abspath(args.other)}
    names = ("paged_decode", "ragged_prefill")
    with concurrent.futures.ThreadPoolExecutor(4) as pool:   # one nvcc each
        futs = {(side, name): pool.submit(_build, root, name, side)
                for side, root in roots.items() for name in names}
        fns = {side: {name: futs[side, name].result() for name in names}
               for side in roots}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    calls = make_calls(fns, *make_inputs(gen))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times = {k: {"A": [], "B": []} for k in calls}
    a_faster = {k: 0 for k in calls}       # rounds whose two A runs beat the two B runs
    for kernel, sides in calls.items():
        for call in sides.values():          # warm-up
            for _ in range(3):
                call()
        torch.cuda.synchronize()
        for r in range(args.rounds):
            row = {}
            for side in ("A", "B", "B", "A"):
                ms = mean_ms(sides[side], args.iters, flush)
                times[kernel][side].append(ms)
                row.setdefault(side, []).append(ms)
            a_faster[kernel] += sum(row["A"]) < sum(row["B"])
            print(f"{card}: {kernel} round {r}: A {row['A']} B {row['B']}",
                  flush=True)
    summary = {k: {**{side: {"median_ms": statistics.median(v), "iqr_ms": _iqr(v),
                             "n": len(v)} for side, v in t.items()},
                   "rounds_a_faster": a_faster[k]}
               for k, t in times.items()}
    print(json.dumps({"card": card, "A": here, "B": os.path.abspath(args.other),
                      "rounds": args.rounds, "iters": args.iters,
                      "kernels": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
