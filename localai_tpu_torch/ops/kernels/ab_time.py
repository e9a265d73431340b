"""A/B device time of the decode kernels K1, K3, K4, K5, the prefill
kernels K2, K2-int8 and the weight-only products W8, W4: this checkout's
sources against another checkout's, in one process on one card.

    python -m localai_tpu_torch.ops.kernels.ab_time --other DIR \\
        [--rounds 10] [--iters 50] [--split-rows 64[,128,256]] [--only K1,W8]

DIR is the root of another checkout (e.g. the parent commit unpacked with
``git archive``) whose csrc/ exports the same C launchers. Its decode
launchers may predate the split-K workspace: when its paged_decode.cu
takes no ``split_rows``, they are bound with ``PARENT_SIGNATURES`` (no
workspace, no split size). Both sides' libraries are built with this
checkout's nvcc flags and called on the SAME inputs (bf16, Llama-3.1-8B
heads: KV 8, G 4, hd 128, page 64, 8 slots of 4096 rows):

  * every decode kernel at six shapes: "serving", chip_smoke.py's decode
    (lengths 48/48/48/1516 and four idle slots); "long", one slot of 4095
    rows and seven idle; "full", 8 x 4095 rows (134 MB read per call);
    two short contexts: "short", one chat of 100 rows and seven idle
    slots, and "early", eight chats of 128 rows each; "idle", every slot
    at length 0 (the fixed cost of a call: no split works and the combine
    returns the current token's v).
    K1 reads a shuffled page pool, K3 its int8 quantization, K4 the same
    bytes as a contiguous [8, 4096] cache, K5 that cache as a one-layer
    stacked cache with the layer index on the device;
  * K2 and K2-int8 on a 476-token chunk over 1024 committed rows (bf16 or
    int8 pages); "K2 fresh" on a fresh 512-token pack (mp = 0);
  * W8 (int8) and W4 (int4, g 128) on bf16 x at Llama-3.1-8B widths:
    w_gate [4096, 14336], wk [4096, 1024] and (W8) lm_head [4096, 128256]
    at decode M = 8, w_gate at a 512-token pack. A side whose
    quant_matmul.cu has the tensor-core launcher runs it with this
    checkout's ``tc_plan``; an older side runs what its wrapper ran for
    bf16 x: the CUDA-core skinny kernel (M <= 16, ``skinny_k_chunk``) or
    its dequantize kernel into a scratch + torch.matmul (M > 16).

With several ``--split-rows`` values this checkout's decode kernels run
once per value (sides "A@64", "A@128", ...), which is how SPLIT_ROWS was
chosen. Each round times the sides in order and then in reverse (A, B, B,
A for two sides), each the mean of ``--iters`` launches with the L2
flushed and ~0.5 ms of GPU sleep before every launch (so the host has
queued the launch before the start event fires), CUDA events around it.
Prints every round, then one JSON line with the medians and the spread
(interquartile range) per side, the number of rounds each A side won
against B, and the card's name and power limit.
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
from localai_tpu_torch.ops.paged_attention import SPLIT_ROWS, n_splits

KV, G, HD, PG, MP, S = 8, 4, 128, 64, 64, 8
N_PAGES = S * MP
C = MP * PG
DECODE_SHAPES = {"serving": [48, 48, 48, 1516, 0, 0, 0, 0],
                 "long": [C - 1] + [0] * (S - 1),
                 "full": [C - 1] * S,
                 "short": [100] + [0] * (S - 1),
                 "early": [128] * S,
                 "idle": [0] * S}
PREFILL_SEG = (0, 1024, 476)        # slot, committed rows, chunk tokens
FRESH_N = 512                        # a fresh pack: one 512-token segment
SLEEP_CYCLES = 1_000_000             # ~0.5 ms at the H100's clocks

_P, _I = ctypes.c_void_p, ctypes.c_int
# W8 / W4 cases: (label, bits, (K, N), M)
QUANT_CASES = [(f"W{b} {name} M={m}", b, shape, m)
               for b in (8, 4)
               for name, shape, m in (("w_gate", (4096, 14336), 8),
                                      ("wk", (4096, 1024), 8),
                                      ("lm_head", (4096, 128256), 8),
                                      ("w_gate", (4096, 14336), 512))
               if not (b == 4 and name == "lm_head")]

# the decode launchers of a checkout from before the split-K workspace,
# and the W8 / W4 launchers of one from before the tensor-core kernel
PARENT_SIGNATURES = {
    "paged_decode": {
        "paged_decode_attention_launch": [_P] * 8 + [_I] * 8 + [_P],
        "paged_decode_attention_quant_launch": [_P] * 10 + [_I] * 8 + [_P],
    },
    "contig_decode": {
        "contig_decode_attention_launch": [_P] * 7 + [_I] * 6 + [_P],
        "contig_decode_attention_full_launch": [_P] * 8 + [_I] * 8 + [_P],
    },
    "quant_matmul": {
        "quant_matmul_skinny_launch": [_P] * 5 + [_I] * 7 + [_P],
        "quant_dequant_launch": [_P] * 3 + [_I] * 5 + [_P],
    },
}
NAMES = ("paged_decode", "ragged_prefill", "contig_decode", "quant_matmul")


def _src(root: str, name: str) -> str:
    return os.path.join(root, "localai_tpu_torch", "ops", "kernels", "csrc",
                        f"{name}.cu")


def splits_decode(root: str) -> bool:
    """Whether ``root``'s decode launchers take the split-K workspace."""
    with open(_src(root, "paged_decode")) as f:
        return "split_rows" in f.read()


def has_tc_quant(root: str) -> bool:
    """Whether ``root``'s quant_matmul.cu has the tensor-core launcher."""
    with open(_src(root, "quant_matmul")) as f:
        return "quant_matmul_tc_launch" in f.read()


def bind(path: str, signatures: dict) -> dict:
    """{launcher name: bound C function} of the library at ``path``."""
    lib = ctypes.CDLL(path)
    fns = {}
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[fn_name] = fn
    return fns


def _build(root: str, name: str, tag: str, split: bool) -> dict:
    """The launchers of ``root``'s ``name``.cu, built with this checkout's
    flags."""
    out_dir = os.path.join(build.BUILD_DIR, "ab", tag)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", out,
                    _src(root, name)], check=True, capture_output=True, text=True)
    new = has_tc_quant(root) if name == "quant_matmul" else split
    sigs = build.SIGNATURES if new else PARENT_SIGNATURES
    return bind(out, sigs.get(name, build.SIGNATURES[name]))


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
    dec = {shape: dict(ptab=table(lengths), lens=torch.tensor(
        lengths, dtype=torch.int32, device="cuda"))
        for shape, lengths in DECODE_SHAPES.items()}
    dec_qkv = dict(q=randn(S, KV * G, HD), nk=randn(S, KV, HD), nv=randn(S, KV, HD))
    slot, start, n = PREFILL_SEG
    rows = [0] * S
    rows[slot] = start + n
    tabs = torch.zeros((4, S), dtype=torch.int32)
    tabs[0] = S
    tabs[:, 0] = torch.tensor([slot, start, 0, n])
    pre = dict(q=randn(n, KV * G, HD), ck=randn(n, KV, HD), cv=randn(n, KV, HD),
               ptab=table(rows), tabs=[t.cuda() for t in tabs])
    ftabs = torch.zeros((4, S), dtype=torch.int32)
    ftabs[0] = S
    ftabs[:, 0] = torch.tensor([0, 0, 0, FRESH_N])
    fresh = dict(q=randn(FRESH_N, KV * G, HD), ck=randn(FRESH_N, KV, HD),
                 cv=randn(FRESH_N, KV, HD), tabs=[t.cuda() for t in ftabs])
    return dict(pools=(pk, pv), int8=(qk, sk, qv, sv), dec=dec, qkv=dec_qkv,
                pre=pre, fresh=fresh)


def decode_calls(fns, split, inp, shape):
    """{kernel: zero-argument launch} of K1, K3, K4 and K5 at ``shape``
    for one side: ``fns`` its launchers, ``split`` its split size (None:
    the launchers take no workspace)."""
    stream = torch.cuda.current_stream().cuda_stream
    pk, pv = inp["pools"]
    qk, sk, qv, sv = inp["int8"]
    t = inp["qkv"]
    d = inp["dec"][shape]
    out = torch.empty_like(t["q"])
    ck, cv = pk.view(S, C, KV, HD), pv.view(S, C, KV, HD)   # the same bytes, contiguous
    layer = torch.zeros(1, dtype=torch.int32, device="cuda")
    head = [t["q"].data_ptr(), t["nk"].data_ptr(), t["nv"].data_ptr()]
    if split is not None:
        ws = torch.empty(S * KV * n_splits(C, split) * G * (HD + 2),
                         dtype=torch.float32, device="cuda")

    def call(fn, ptrs, ints, label):
        if split is None:
            args = head + ptrs + [out.data_ptr()] + ints + [1, stream]
        else:
            args = (head + ptrs + [out.data_ptr(), ws.data_ptr()] + ints
                    + [split, 1, stream])
        return lambda: build.check(fn(*args), label)

    pd, cd = fns["paged_decode"], fns["contig_decode"]
    geo = [S, KV, G, HD]
    return {
        "K1": call(pd["paged_decode_attention_launch"],
                   [pk.data_ptr(), pv.data_ptr(), d["ptab"].data_ptr(),
                    d["lens"].data_ptr()], geo + [N_PAGES, PG, MP], "K1"),
        "K3": call(pd["paged_decode_attention_quant_launch"],
                   [qk.data_ptr(), sk.data_ptr(), qv.data_ptr(), sv.data_ptr(),
                    d["ptab"].data_ptr(), d["lens"].data_ptr()],
                   geo + [N_PAGES, PG, MP], "K3"),
        "K4": call(cd["contig_decode_attention_launch"],
                   [ck.data_ptr(), cv.data_ptr(), d["lens"].data_ptr()],
                   geo + [C], "K4"),
        "K5": call(cd["contig_decode_attention_full_launch"],
                   [ck.data_ptr(), cv.data_ptr(), d["lens"].data_ptr(),
                    layer.data_ptr()], geo + [C, S, 1], "K5"),
    }


def prefill_calls(fns, inp):
    """{kernel: zero-argument launch} of K2, K2-int8 and K2 on a fresh
    pack for one side."""
    stream = torch.cuda.current_stream().cuda_stream
    pk, pv = inp["pools"]
    qk, sk, qv, sv = inp["int8"]
    pre, fresh = inp["pre"], inp["fresh"]
    out2 = torch.empty_like(pre["q"])
    out3 = torch.empty_like(fresh["q"])
    n = pre["q"].shape[0]
    t, ft = pre["tabs"], fresh["tabs"]
    rp = fns["ragged_prefill"]
    k2, k2q = (rp["ragged_prefill_attention_launch"],
               rp["ragged_prefill_attention_quant_launch"])
    head = [pre["q"].data_ptr(), pre["ck"].data_ptr(), pre["cv"].data_ptr()]
    tabs = [pre["ptab"].data_ptr()] + [x.data_ptr() for x in t] + [out2.data_ptr()]
    ints = [n, KV, G, HD, N_PAGES, PG, MP, S, S, 1, stream]
    fresh_args = ([fresh["q"].data_ptr(), fresh["ck"].data_ptr(),
                   fresh["cv"].data_ptr(), None, None, None]
                  + [x.data_ptr() for x in ft]
                  + [out3.data_ptr(), FRESH_N, KV, G, HD, 0, 0, 0, S, S, 1, stream])
    return {
        "K2": lambda: build.check(k2(*head, pk.data_ptr(), pv.data_ptr(), *tabs,
                                     *ints), "K2"),
        "K2-int8": lambda: build.check(k2q(*head, qk.data_ptr(), sk.data_ptr(),
                                           qv.data_ptr(), sv.data_ptr(), *tabs,
                                           *ints), "K2-int8"),
        "K2 fresh": lambda: build.check(k2(*fresh_args), "K2 fresh"),
    }


def quant_inputs(gen):
    """bf16 x per (shape, M) and a {q, s} leaf per (bits, shape), quantized
    from normal / sqrt(K) weights (the model's init)."""
    from localai_tpu_torch.ops.quant import quantize_weight, quantize_weight_int4

    leaves, xs = {}, {}
    for _label, bits, (K, N), M in QUANT_CASES:
        if (bits, K, N) not in leaves:
            w = torch.randn((K, N), generator=gen, device="cuda").div_(K ** 0.5)
            leaves[bits, K, N] = (quantize_weight(w) if bits == 8
                                  else quantize_weight_int4(w, group=128))
            del w
        if (K, M) not in xs:
            xs[K, M] = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    return leaves, xs


def quant_calls(fns, tc: bool, inp):
    """{case: zero-argument launch} of W8 / W4 for one side (``tc``: its
    library has the tensor-core launcher)."""
    from localai_tpu_torch.ops.quant import (SKINNY_M, _sm_count, skinny_k_chunk,
                                             tc_plan)

    leaves, xs = inp
    qm = fns["quant_matmul"]
    stream = torch.cuda.current_stream().cuda_stream
    sms = _sm_count(torch.device("cuda"))
    calls = {}
    for label, bits, (K, N), M in QUANT_CASES:
        leaf, x = leaves[bits, K, N], xs[K, M]
        q, s = leaf["q"], leaf["s"]
        group = K // s.shape[0] if bits == 4 else 0
        out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
        head = [x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr()]
        if tc or M <= SKINNY_M:
            if tc:
                tile, chunk, n_split = tc_plan(M, K, N, sms)
                fn, tail = qm["quant_matmul_tc_launch"], [tile, chunk]
            else:
                chunk = skinny_k_chunk(K, N, sms)
                n_split = -(-K // chunk)
                fn, tail = qm["quant_matmul_skinny_launch"], [chunk, 1]
            ws = torch.empty(n_split * M * N if n_split > 1 else 1,
                             dtype=torch.float32, device="cuda")
            args = head + [ws.data_ptr(), M, K, N, group, bits] + tail + [stream]
            calls[label] = (lambda fn=fn, args=args, label=label, keep=ws:
                            build.check(fn(*args), label))
        else:
            wd = torch.empty((K, N), dtype=torch.bfloat16, device="cuda")
            deq = qm["quant_dequant_launch"]
            args = [q.data_ptr(), s.data_ptr(), wd.data_ptr(), K, N, group, bits,
                    1, stream]

            def call(deq=deq, args=args, label=label, x=x, wd=wd, out=out):
                build.check(deq(*args), label)
                torch.matmul(x, wd, out=out)
            calls[label] = call
    return calls


def mean_ms(call, iters: int, flush) -> float:
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
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
    p.add_argument("--split-rows", default=str(SPLIT_ROWS),
                   help="comma-separated split sizes for this checkout's "
                        "decode kernels (default: SPLIT_ROWS)")
    p.add_argument("--only", default="",
                   help="comma-separated kernel-name prefixes to time "
                        "(e.g. K1,K4; default: all)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_time: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    roots = {"A": here, "B": os.path.abspath(args.other)}
    split_new = {side: splits_decode(root) for side, root in roots.items()}
    with concurrent.futures.ThreadPoolExecutor(6) as pool:   # one nvcc each
        futs = {(side, name): pool.submit(_build, root, name, side, split_new[side])
                for side, root in roots.items() for name in NAMES}
        fns = {side: {name: futs[side, name].result() for name in NAMES}
               for side in roots}
    splits = [int(x) for x in args.split_rows.split(",")]
    a_sides = {("A" if len(splits) == 1 else f"A@{n}"): n for n in splits}
    inp = make_inputs(torch.Generator(device="cuda").manual_seed(1234))
    calls = {}
    for shape in DECODE_SHAPES:
        sides = {side: decode_calls(fns["A"], n, inp, shape)
                 for side, n in a_sides.items()}
        sides["B"] = decode_calls(fns["B"], SPLIT_ROWS if split_new["B"] else None,
                                  inp, shape)
        for k in ("K1", "K3", "K4", "K5"):
            calls[f"{k} {shape}"] = {side: c[k] for side, c in sides.items()}
    pre = {side: prefill_calls(fns[side], inp) for side in roots}
    for k in ("K2", "K2-int8", "K2 fresh"):
        calls[k] = {side: c[k] for side, c in pre.items()}
    qin = quant_inputs(torch.Generator(device="cuda").manual_seed(1234))
    quant = {side: quant_calls(fns[side], has_tc_quant(root), qin)
             for side, root in roots.items()}
    for label, *_rest in QUANT_CASES:
        calls[label] = {side: c[label] for side, c in quant.items()}
    only = [x for x in args.only.split(",") if x]
    calls = {k: v for k, v in calls.items()
             if not only or any(k.startswith(x) for x in only)}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times = {k: {side: [] for side in v} for k, v in calls.items()}
    won = {k: {side: 0 for side in v if side != "B"} for k, v in calls.items()}
    for kernel, sides in calls.items():
        for call in sides.values():          # warm-up
            for _ in range(3):
                call()
        torch.cuda.synchronize()
        order = list(sides) + list(reversed(sides))
        for r in range(args.rounds):
            row = {}
            for side in order:
                ms = mean_ms(sides[side], args.iters, flush)
                times[kernel][side].append(ms)
                row.setdefault(side, []).append(ms)
            for side in won[kernel]:           # its two runs beat B's two runs
                won[kernel][side] += sum(row[side]) < sum(row["B"])
            print(f"{card}: {kernel} round {r}: " + " ".join(
                f"{side} {v}" for side, v in row.items()), flush=True)
    summary = {k: {**{side: {"median_ms": statistics.median(v), "iqr_ms": _iqr(v),
                             "n": len(v)} for side, v in t.items()},
                   "rounds_won_against_B": won[k]}
               for k, t in times.items()}
    print(json.dumps({"card": card, "A": here, "B": os.path.abspath(args.other),
                      "split_rows": a_sides, "rounds": args.rounds,
                      "iters": args.iters, "kernels": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
