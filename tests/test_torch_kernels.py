"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card (``cuda`` marker; skips without a GPU: the kernels
have no CPU mode).

This file imports neither jax nor the JAX package, so it also runs on the
machine with the card, where JAX is not installed — there without the
repository's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Cases at Llama-3.1-8B head shapes (KV 8, G 4, hd 128, page 64): K1 and
K3 (int8 pages) with decode lengths 0, 1, 63, 64, 65, long and C - 1, on a
shuffled page pool; K2 and K2-int8 with fresh, continued (mid-page) and
pad segments and pad tokens; K4 (contiguous) and K5 (stacked cache,
layer index on the device, a poisoned scratch slot past S) with the same
lengths up to C. The split-K decode kernels (K1, K3, K4, K5) also at the
split edges of ops/paged_attention.py::SPLIT_ROWS, on an all-idle batch,
over a head-shape grid (G 1/2/4/8 x hd 32/64/128/256), and across calls
that reuse one workspace from the caching allocator (once NaN-poisoned),
captured in a CUDA graph and replayed (again after the lengths changed
on the device), and at 8192 rows per slot. W8 / W4 (weight-only int8 /
int4 products): bfloat16 on the tensor-core kernel at every token tile
and its edges (M 1 ... 512, one 64 x 128 tile alone against
torch.matmul), float32 on the CUDA-core skinny kernel (M <= 16) and the
dequantize route above, at int4 groups 128 and 86, a tied table used
transposed, and run twice for equal bits (decode and a prefill pack).
Tolerances: float32 1e-4 absolute (summation order);
bfloat16 2e-2 absolute and relative (bf16 rounding of the plain version's
scores, probabilities and output, plus order). Int8 cases compare the
kernel and the plain version on the SAME int8 rows, so the same
tolerances hold.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import pytest
import torch

KV, G, HD, PG, MP, S = 8, 4, 128, 64, 16, 8
N_PAGES = S * MP


def _tol(dtype):
    return (dict(atol=1e-4, rtol=0) if dtype == torch.float32
            else dict(atol=2e-2, rtol=2e-2))


def _pool(gen, dtype):
    shape = (N_PAGES, PG, KV, HD)
    pk = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    pv = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(N_PAGES, generator=gen, device="cuda").to(torch.int32)
    return pk, pv, perm


def _quant_pool(gen):
    """int8 pages and float32 scales (K and V) from unit normals."""
    from localai_tpu_torch.ops.kvcache import quantize

    shape = (N_PAGES, PG, KV, HD)
    qk, sk = quantize(torch.randn(shape, generator=gen, device="cuda"))
    qv, sv = quantize(torch.randn(shape, generator=gen, device="cuda"))
    return qk, sk, qv, sv


def _ptab(perm, rows):
    ptab = torch.full((S, MP), N_PAGES, dtype=torch.int32, device="cuda")
    nxt = 0
    for s, r in enumerate(rows):
        n = -(-r // PG)
        ptab[s, :n] = perm[nxt:nxt + n]
        nxt += n
    return ptab


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_paged_decode_matches_plain(card, dtype):
    from localai_tpu_torch.ops.kernels import LAUNCHES
    from localai_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_plain)

    gen = torch.Generator(device="cuda").manual_seed(0)
    lengths = [0, 1, 63, 64, 65, 300, 777, MP * PG - 1]
    pk, pv, perm = _pool(gen, dtype)
    ptab = _ptab(perm, lengths)
    q = torch.randn((S, KV * G, HD), generator=gen, device="cuda").to(dtype)
    nk = torch.randn((S, KV, HD), generator=gen, device="cuda").to(dtype)
    nv = torch.randn((S, KV, HD), generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = LAUNCHES["paged_decode_attention"]
    got = paged_decode_attention(q, nk, nv, pk, pv, ptab, lens, G)
    assert LAUNCHES["paged_decode_attention"] == before + 1
    ref = paged_decode_plain(q, nk, nv, pk, pv, ptab, lens, G)
    torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_int8_paged_decode_matches_plain(card, dtype):
    from localai_tpu_torch.ops.kernels import LAUNCHES
    from localai_tpu_torch.ops.paged_attention import (
        paged_decode_attention_quant, paged_decode_quant_plain)

    gen = torch.Generator(device="cuda").manual_seed(2)
    lengths = [0, 1, 63, 64, 65, 300, 777, MP * PG - 1]
    qk, sk, qv, sv = _quant_pool(gen)
    perm = torch.randperm(N_PAGES, generator=gen, device="cuda").to(torch.int32)
    ptab = _ptab(perm, lengths)
    q = torch.randn((S, KV * G, HD), generator=gen, device="cuda").to(dtype)
    nk = torch.randn((S, KV, HD), generator=gen, device="cuda").to(dtype)
    nv = torch.randn((S, KV, HD), generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    args = (q, nk, nv, qk, sk, qv, sv, ptab, lens, G)
    before = LAUNCHES["paged_decode_attention_quant"]
    got = paged_decode_attention_quant(*args)
    assert LAUNCHES["paged_decode_attention_quant"] == before + 1
    ref = paged_decode_quant_plain(*args)
    torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))


def _k2_args(kind, dtype, seed):
    segs = {"fresh": [(0, 0, 50), (1, 0, 40), (2, 0, 38)],
            "continued": [(3, 512, 60), (4, 70, 50), (5, 0, 18)],
            "pad": [(6, 130, 40), (7, 0, 50)]}[kind]
    N = 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = [0] * S
    for slot, start, n in segs:
        rows[slot] = start + n
    perm = torch.randperm(N_PAGES, generator=gen, device="cuda").to(torch.int32)
    ptab = _ptab(perm, rows)
    tabs = torch.zeros((4, S), dtype=torch.int32)
    tabs[0] = S                                   # pad segments: sentinel slot
    real = torch.zeros(N, dtype=torch.bool)
    off = 0
    for b, (slot, start, n) in enumerate(segs):
        tabs[:, b] = torch.tensor([slot, start, off, n])
        real[off:off + n] = True
        off += n
    q = torch.randn((N, KV * G, HD), generator=gen, device="cuda").to(dtype)
    ck = torch.randn((N, KV, HD), generator=gen, device="cuda").to(dtype)
    cv = torch.randn((N, KV, HD), generator=gen, device="cuda").to(dtype)
    return gen, q, ck, cv, ptab, [t.cuda() for t in tabs], real.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["fresh", "continued", "pad"])
def test_k2_int8_ragged_prefill_matches_plain(card, dtype, kind):
    """K2-int8 (continued packs over int8 pages); a fresh pack over the same
    int8 cache runs K2 without reading it."""
    from localai_tpu_torch.ops.kernels import LAUNCHES
    from localai_tpu_torch.ops.ragged_prefill import (
        ragged_prefill_attention_paged, ragged_prefill_plain)

    gen, q, ck, cv, ptab, tabs, real = _k2_args(kind, dtype, 3)
    qk, sk, qv, sv = _quant_pool(gen)
    continued = kind != "fresh"
    name = "ragged_prefill_attention_int8" if continued else "ragged_prefill_attention"
    before = LAUNCHES[name]
    got = ragged_prefill_attention_paged(q, ck, cv, qk, qv, ptab, *tabs, G,
                                         scales_k=sk, scales_v=sv,
                                         continued=continued)
    assert LAUNCHES[name] == before + 1
    ref = ragged_prefill_plain(q, ck, cv, qk, qv, ptab, *tabs, G,
                               scales_k=sk, scales_v=sv, continued=continued)
    torch.testing.assert_close(got.float()[real], ref.float()[real],
                               **_tol(dtype))
    assert (got[~real] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_k5_contiguous_decode_match_plain(card, dtype):
    from localai_tpu_torch.ops.decode_attention import (
        contig_decode_plain, decode_attention_append_contig,
        decode_attention_append_full, full_decode_plain)
    from localai_tpu_torch.ops.kernels import LAUNCHES

    C, L, li = MP * PG, 3, 2
    gen = torch.Generator(device="cuda").manual_seed(4)
    lengths = [0, 1, 63, 64, 65, 300, 777, C]
    ck = torch.randn((L, S + 1, C, KV, HD), generator=gen, device="cuda").to(dtype)
    cv = torch.randn((L, S + 1, C, KV, HD), generator=gen, device="cuda").to(dtype)
    ck[:, S] = 1e4                                # the scratch slot is never read
    cv[:, S] = -1e4
    q = torch.randn((S, KV * G, HD), generator=gen, device="cuda").to(dtype)
    nk = torch.randn((S, KV, HD), generator=gen, device="cuda").to(dtype)
    nv = torch.randn((S, KV, HD), generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = dict(LAUNCHES)
    got4 = decode_attention_append_contig(q, nk, nv, ck[li, :S], cv[li, :S],
                                          lens, G)
    layer = torch.tensor([li], dtype=torch.int32, device="cuda")
    got5 = decode_attention_append_full(q, nk, nv, ck, cv, lens, layer, G)
    assert LAUNCHES["decode_attention_append_contig"] == \
        before["decode_attention_append_contig"] + 1
    assert LAUNCHES["decode_attention_append_full"] == \
        before["decode_attention_append_full"] + 1
    ref = contig_decode_plain(q, nk, nv, ck[li, :S], cv[li, :S], lens, G)
    torch.testing.assert_close(got4.float(), ref.float(), **_tol(dtype))
    torch.testing.assert_close(got5.float(), ref.float(), **_tol(dtype))
    torch.testing.assert_close(
        full_decode_plain(q, nk, nv, ck, cv, lens, layer, G).float(),
        ref.float(), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["fresh", "continued", "pad"])
def test_k2_ragged_prefill_matches_plain(card, dtype, kind):
    from localai_tpu_torch.ops.ragged_prefill import (
        ragged_prefill_attention_paged, ragged_prefill_plain)

    segs = {"fresh": [(0, 0, 50), (1, 0, 40), (2, 0, 38)],
            "continued": [(3, 512, 60), (4, 70, 50), (5, 0, 18)],
            "pad": [(6, 130, 40), (7, 0, 50)]}[kind]
    N = 128
    gen = torch.Generator(device="cuda").manual_seed(1)
    pk, pv, perm = _pool(gen, dtype)
    rows = [0] * S
    for slot, start, n in segs:
        rows[slot] = start + n
    ptab = _ptab(perm, rows)
    tabs = torch.zeros((4, S), dtype=torch.int32)
    tabs[0] = S                                   # pad segments: sentinel slot
    real = torch.zeros(N, dtype=torch.bool)
    off = 0
    for b, (slot, start, n) in enumerate(segs):
        tabs[:, b] = torch.tensor([slot, start, off, n])
        real[off:off + n] = True
        off += n
    q = torch.randn((N, KV * G, HD), generator=gen, device="cuda").to(dtype)
    ck = torch.randn((N, KV, HD), generator=gen, device="cuda").to(dtype)
    cv = torch.randn((N, KV, HD), generator=gen, device="cuda").to(dtype)
    args = (q, ck, cv, pk, pv, ptab, *(t.cuda() for t in tabs))
    got = ragged_prefill_attention_paged(*args, G)
    ref = ragged_prefill_plain(*args, G)
    real = real.cuda()
    torch.testing.assert_close(got.float()[real], ref.float()[real],
                               **_tol(dtype))
    assert (got[~real] == 0).all()              # pad tokens: zeros on the card


# The tensor-core body of K2 / K2-int8 (bfloat16) and the CUDA-core body
# (float32) over the head shapes kernel_supports admits: G 1, 4, 7 and 64
# (7 leaves a masked pad row in every 64-row tile), hd 32, 64, 128 and 256
# (32-key tiles), committed lengths 1, 63, 64 and 65 around the 64-row key
# tile, a fresh segment, pad tokens and a pack whose length is no multiple
# of any query tile; KV 2 keeps the pools small.
GRID_SEGS = [(0, 1, 37), (1, 63, 20), (2, 64, 1), (3, 65, 70), (4, 0, 9)]
GRID_N = 141


def _grid_args(G_, hd, dtype, seed, segs, quant=False, kv=2, pg=PG, mp=MP,
               n_pages=N_PAGES, ptab=None):
    """(args, kwargs, real) for the K2 wrapper: q [GRID_N, kv*G_, hd], pack
    k/v, a shuffled float or int8 pool (or ``ptab``'s), the table and the
    segment tables of ``segs`` [(slot, start, length)]."""
    from localai_tpu_torch.ops.kvcache import quantize

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (n_pages, pg, kv, hd)
    pk = torch.randn(shape, generator=gen, device="cuda")
    pv = torch.randn(shape, generator=gen, device="cuda")
    kw = {}
    if quant:
        (pk, sk), (pv, sv) = quantize(pk), quantize(pv)
        kw = {"scales_k": sk, "scales_v": sv}
    else:
        pk, pv = pk.to(dtype), pv.to(dtype)
    if ptab is None:
        perm = torch.randperm(n_pages, generator=gen, device="cuda").to(torch.int32)
        ptab = torch.full((S, mp), n_pages, dtype=torch.int32, device="cuda")
        nxt = 0
        for slot, start, n in segs:
            k = -(-(start + n) // pg)
            ptab[slot, :k] = perm[nxt:nxt + k]
            nxt += k
    tabs = torch.zeros((4, S), dtype=torch.int32)
    tabs[0] = S
    real = torch.zeros(GRID_N, dtype=torch.bool)
    off = 0
    for b, (slot, start, n) in enumerate(segs):
        tabs[:, b] = torch.tensor([slot, start, off, n])
        real[off:off + n] = True
        off += n
    q = torch.randn((GRID_N, kv * G_, hd), generator=gen, device="cuda").to(dtype)
    ck = torch.randn((GRID_N, kv, hd), generator=gen, device="cuda").to(dtype)
    cv = torch.randn((GRID_N, kv, hd), generator=gen, device="cuda").to(dtype)
    args = (q, ck, cv, pk, pv, ptab, *(t.cuda() for t in tabs))
    return args, kw, real.cuda()


def _check_k2(args, kw, real, G_, dtype, continued):
    from localai_tpu_torch.ops.kernels import LAUNCHES
    from localai_tpu_torch.ops.ragged_prefill import (
        ragged_prefill_attention_paged, ragged_prefill_plain)

    name = ("ragged_prefill_attention_int8" if kw and continued
            else "ragged_prefill_attention")
    before = LAUNCHES[name]
    got = ragged_prefill_attention_paged(*args, G_, **kw, continued=continued)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    ref = ragged_prefill_plain(*args, G_, **kw, continued=continued)
    torch.testing.assert_close(got.float()[real], ref.float()[real],
                               **_tol(dtype))
    assert (got[~real] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("G_", [1, 4, 7, 64])
@pytest.mark.parametrize("kind", ["fresh", "continued"])
@pytest.mark.parametrize("quant", [False, True])
def test_k2_head_shape_grid_matches_plain(card, dtype, hd, G_, kind, quant):
    segs = GRID_SEGS if kind == "continued" else [
        (s, 0, n) for s, _start, n in GRID_SEGS]
    args, kw, real = _grid_args(G_, hd, dtype, 10 + hd + G_, segs, quant=quant)
    _check_k2(args, kw, real, G_, dtype, kind == "continued")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_k2_contiguous_identity_table_matches_plain(card, dtype, hd):
    """The contiguous layout's K2: one page of C = 4096 rows per slot over
    the identity table, committed lengths up to 4000."""
    C = 4096
    itab = torch.arange(S, dtype=torch.int32, device="cuda")[:, None]
    segs = [(0, 1, 37), (1, 4000, 20), (2, 64, 1), (3, 2049, 70), (4, 0, 9)]
    args, kw, real = _grid_args(4, hd, dtype, 5, segs, pg=C, mp=1, n_pages=S,
                                ptab=itab)
    _check_k2(args, kw, real, 4, dtype, True)


# ---------- the split-K decode kernels K1, K3, K4, K5 ----------

_DECODE_NAME = {"K1": "paged_decode_attention",
                "K3": "paged_decode_attention_quant",
                "K4": "decode_attention_append_contig",
                "K5": "decode_attention_append_full"}


def _decode_calls(kernel, G_, hd, dtype, lengths, seed, kv=KV, C=MP * PG, lens=None):
    """(kernel call, plain call) of one decode kernel on seeded inputs
    over ``lengths``: a shuffled page pool with C rows of table per slot
    (K1; K3 over int8 pages), a contiguous [S, C] cache (K4), or the
    stacked [2, S + 1, C] cache at layer 1 with a poisoned scratch slot
    (K5). ``lens``: a device int32 tensor the calls read the lengths from
    (filled with ``lengths``), so a caller can change them between calls."""
    from localai_tpu_torch.ops.decode_attention import (
        contig_decode_plain, decode_attention_append_contig,
        decode_attention_append_full, full_decode_plain)
    from localai_tpu_torch.ops.kvcache import quantize
    from localai_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_quant, paged_decode_plain,
        paged_decode_quant_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = len(lengths)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, nk, nv = (randn(n, kv * G_, hd).to(dtype), randn(n, kv, hd).to(dtype),
                 randn(n, kv, hd).to(dtype))
    if lens is None:
        lens = torch.empty(n, dtype=torch.int32, device="cuda")
    lens.copy_(torch.tensor(lengths, dtype=torch.int32))
    if kernel in ("K1", "K3"):
        mp = -(-C // PG)
        n_pages = n * mp
        pk, pv = randn(n_pages, PG, kv, hd), randn(n_pages, PG, kv, hd)
        perm = torch.randperm(n_pages, generator=gen, device="cuda").to(torch.int32)
        ptab = torch.full((n, mp), n_pages, dtype=torch.int32, device="cuda")
        nxt = 0
        for s, r in enumerate(lengths):
            k = -(-r // PG)
            ptab[s, :k] = perm[nxt:nxt + k]
            nxt += k
        if kernel == "K1":
            a = (q, nk, nv, pk.to(dtype), pv.to(dtype), ptab, lens, G_)
            return (lambda: paged_decode_attention(*a)), (lambda: paged_decode_plain(*a))
        (qk, sk), (qv, sv) = quantize(pk), quantize(pv)
        a = (q, nk, nv, qk, sk, qv, sv, ptab, lens, G_)
        return ((lambda: paged_decode_attention_quant(*a)),
                (lambda: paged_decode_quant_plain(*a)))
    if kernel == "K4":
        a = (q, nk, nv, randn(n, C, kv, hd).to(dtype), randn(n, C, kv, hd).to(dtype),
             lens, G_)
        return ((lambda: decode_attention_append_contig(*a)),
                (lambda: contig_decode_plain(*a)))
    ck, cv = randn(2, n + 1, C, kv, hd).to(dtype), randn(2, n + 1, C, kv, hd).to(dtype)
    ck[:, n] = 1e4                                # the scratch slot is never read
    cv[:, n] = -1e4
    layer = torch.tensor([1], dtype=torch.int32, device="cuda")
    a = (q, nk, nv, ck, cv, lens, layer, G_)
    return (lambda: decode_attention_append_full(*a)), (lambda: full_decode_plain(*a))


def _check_decode(kernel, calls, dtype):
    """One launch of the kernel (counted once), held to its plain version;
    returns the kernel's output."""
    from localai_tpu_torch.ops.kernels import LAUNCHES

    fn, plain = calls
    name = _DECODE_NAME[kernel]
    before = LAUNCHES[name]
    got = fn()
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), plain().float(), **_tol(dtype))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["K1", "K3", "K4", "K5"])
def test_decode_split_edges_match_plain(card, kernel, dtype):
    """Lengths at the split edges (0, SPLIT_ROWS - 1, SPLIT_ROWS,
    SPLIT_ROWS + 1, a multiple of it minus one), C - 1 and C, at
    Llama-3.1-8B heads."""
    from localai_tpu_torch.ops.paged_attention import SPLIT_ROWS as SR

    C = MP * PG
    lengths = [0, 1, SR - 1, SR, SR + 1, 3 * SR - 1, C - 1, C]
    _check_decode(kernel, _decode_calls(kernel, G, HD, dtype, lengths, 21), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["K1", "K3", "K4", "K5"])
def test_decode_all_idle_batch_returns_current_value(card, kernel, dtype):
    """Every slot idle (length 0): no split works, and the combine returns
    each head's current-token v exactly, as the plain version does."""
    calls = _decode_calls(kernel, G, HD, dtype, [0] * S, 22)
    got = _check_decode(kernel, calls, dtype)
    torch.testing.assert_close(got, calls[1](), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("G_", [1, 2, 4, 8])
@pytest.mark.parametrize("kernel", ["K1", "K3", "K4", "K5"])
def test_decode_head_shape_grid_matches_plain(card, kernel, G_, hd, dtype):
    from localai_tpu_torch.ops.paged_attention import SPLIT_ROWS as SR

    C = 512
    lengths = [0, 1, SR - 1, SR + 1, 300, C - 1]
    _check_decode(kernel, _decode_calls(kernel, G_, hd, dtype, lengths,
                                        30 + G_ + hd, kv=2, C=C), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K3", "K4", "K5"])
def test_decode_workspace_reuse_reads_no_stale_partial(card, kernel):
    """Calls with shorter lengths after a long one get the same size of
    workspace from the caching allocator, once after a NaN-filled block of
    that size was freed: the combine reads only its own call's splits."""
    from localai_tpu_torch.ops.paged_attention import SPLIT_ROWS as SR
    from localai_tpu_torch.ops.paged_attention import decode_workspace

    C, dt = MP * PG, torch.float32
    _check_decode(kernel, _decode_calls(kernel, G, HD, dt, [C - 1] * S, 40), dt)
    short = [SR + 1, 1, 0, SR, 2 * SR - 1, 0, 5, SR - 1]
    calls = _decode_calls(kernel, G, HD, dt, short, 41)
    _check_decode(kernel, calls, dt)
    q = torch.empty((S, KV * G, HD), device="cuda")
    poison = decode_workspace(q, KV, G, C).fill_(float("nan"))
    del poison
    _check_decode(kernel, calls, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K3", "K4", "K5"])
def test_decode_call_replays_in_a_cuda_graph(card, kernel):
    """One wrapper call captured in a CUDA graph (workspace from the graph's
    pool, the combine a programmatic dependent of the split kernel) and
    replayed gives the plain version's output; replayed again after the
    lengths changed on the device (the split grid comes from shapes alone,
    the working splits from the lengths the kernel reads), it gives the
    plain version's output at the new lengths."""
    from localai_tpu_torch.ops.paged_attention import SPLIT_ROWS as SR

    dt = torch.bfloat16
    lens = torch.empty(S, dtype=torch.int32, device="cuda")
    fn, plain = _decode_calls(kernel, G, HD, dt, [0, 1, SR + 1, 300, 0, 700, 5, 3 * SR],
                              50, lens=lens)
    fn()                                          # build, load, set attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), plain().float(), **_tol(dt))
    lens.copy_(torch.tensor([0, 0, SR, 299, 0, 1, 0, 2 * SR + 3], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), plain().float(), **_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["K1", "K3", "K4", "K5"])
def test_decode_long_context_matches_plain(card, kernel, dtype):
    """8192 rows per slot at Llama-3.1-8B heads: 128 splits per slot, a
    z extent of the split grid twice the serving one."""
    C = 8192
    lengths = [C - 1, 4100, 0, 65, C, 1, 6000, 64]
    _check_decode(kernel, _decode_calls(kernel, G, HD, dtype, lengths, 60, C=C), dtype)


# ---------- W8 / W4: weight-only int8 / int4 products ----------

def _quant_operands(M, K, N, bits, dtype, seed, group=128):
    """x [M, K] unit normals and a {q, s} leaf quantized from normal /
    sqrt(K) weights (the model's init), on the card."""
    from localai_tpu_torch.ops.quant import quantize_weight, quantize_weight_int4

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
    leaf = (quantize_weight_int4(w, group=group) if bits == 4
            else quantize_weight(w))
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    return x, leaf


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 3, 8, 9, 15, 16, 17, 64, 65, 256, 476, 512])
@pytest.mark.parametrize("K,N,group", [(4096, 1024, 128), (1024, 4096, 128),
                                       (11008, 1024, 86), (256, 2064, 64)])
def test_quant_matmul_matches_plain(card, dtype, bits, M, K, N, group):
    """Every route: bfloat16 on the tensor-core kernel at each token tile
    (8, 16, 64, 128, 256) and across its edges, float32 on the skinny
    kernel (M <= 16, split-K) or dequantize + matmul; int8 and int4 at g
    128 and at the g pick_int4_group gives 11008 rows at tp 8 (86, not a
    divisor of the 64-row tile), a last column tile of 16 columns
    (2064)."""
    from localai_tpu_torch.ops.kernels import LAUNCHES
    from localai_tpu_torch.ops.quant import is_grouped, quant_matmul, quant_matmul_plain

    x, leaf = _quant_operands(M, K, N, bits, dtype, seed=M + K + N, group=group)
    assert is_grouped(leaf) == (bits == 4)
    name = "quant_matmul_int4" if bits == 4 else "quant_matmul_int8"
    n0 = LAUNCHES[name]
    got = quant_matmul(x, leaf)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == n0 + 1
    assert got.dtype == dtype and tuple(got.shape) == (M, N)
    torch.testing.assert_close(got.float(), quant_matmul_plain(x, leaf).float(),
                               **(dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32
                                  else dict(atol=2e-2, rtol=2e-2)))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_skinny_is_deterministic(card, bits):
    """The split-K partials are summed in a fixed order (no atomics): two
    calls give the same bits (decode: M = 8, 8 splits of w_down)."""
    from localai_tpu_torch.ops.quant import quant_matmul, tc_plan

    x, leaf = _quant_operands(8, 14336, 4096, bits, torch.bfloat16, seed=5)
    assert tc_plan(8, 14336, 4096, 132)[2] > 1
    a = quant_matmul(x, leaf)
    b = quant_matmul(x, leaf)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_wide_is_deterministic(card, bits):
    """The same for a prefill pack (M = 512, token tile 256, w_down split
    in two): two calls give the same bits."""
    from localai_tpu_torch.ops.quant import quant_matmul, tc_plan

    x, leaf = _quant_operands(512, 14336, 4096, bits, torch.bfloat16, seed=6)
    assert tc_plan(512, 14336, 4096, 132)[2] > 1
    a = quant_matmul(x, leaf)
    b = quant_matmul(x, leaf)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [8, 16, 64, 128, 256])
def test_quant_matmul_one_tile_matches_matmul(card, bits, M):
    """One block, one 64-row tile (K 64, N 128): the wgmma operands' layout
    (the widened weight tile MN-major through the transpose bit, x
    K-major) against torch.matmul on the dequantized weight, at each
    token tile. Integer-valued x and a weight of small integers times
    powers of two make every product and sum exact in float32."""
    from localai_tpu_torch.ops.quant import mat, pack_int4, quant_matmul

    gen = torch.Generator(device="cuda").manual_seed(M + bits)
    K, N = 64, 128
    lim = 7 if bits == 4 else 127
    qv = torch.randint(-lim, lim + 1, (K, N), generator=gen, device="cuda",
                       dtype=torch.int8)
    if bits == 4:
        s = 2.0 ** torch.randint(-4, 1, (K // 16, 1, N), generator=gen, device="cuda")
        leaf = {"q": pack_int4(qv), "s": s.float()}
    else:
        s = 2.0 ** torch.randint(-8, -5, (1, N), generator=gen, device="cuda")
        leaf = {"q": qv, "s": s.float()}
    x = torch.randint(-3, 4, (M, K), generator=gen, device="cuda").to(torch.bfloat16)
    got = quant_matmul(x, leaf)
    ref = (x.float() @ mat(leaf, torch.float32)).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 8, 40])
def test_quant_matmul_tied_table_matches_plain(card, dtype, M):
    """A tied int8 embedding table [V, D] used transposed (its scale along
    D, the contraction axis)."""
    from localai_tpu_torch.ops.quant import quant_matmul, quant_matmul_plain

    x, table = _quant_operands(M, 2048, 512, 8, dtype, seed=M)   # [V, D]
    x = x[:, :512].contiguous()
    got = quant_matmul(x, table, transposed=True)
    torch.testing.assert_close(
        got.float(), quant_matmul_plain(x, table, transposed=True).float(),
        **(dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2)))


@pytest.mark.cuda
def test_quant_matmul_refuses_what_the_kernels_do_not_take(card):
    from localai_tpu_torch.ops.quant import quant_matmul, quantize_weight

    x = torch.randn(4, 64, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        quant_matmul(x, quantize_weight(torch.randn(64, 40, device="cuda")))
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul(x.t().contiguous().t(), quantize_weight(
            torch.randn(64, 32, device="cuda")))
    with pytest.raises(TypeError, match="dtype"):
        quant_matmul(x.half(), quantize_weight(torch.randn(64, 32, device="cuda")))
