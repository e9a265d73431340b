"""Weight-only quantization: the {q, s} contract of the JAX package's
localai_tpu/ops/quant.py (a copy, not an import), and ``quant_matmul``,
the product of activations with such a weight.

Layouts (weights are [..., in, out], as every projection of the port):
  * int8: {"q": int8 [..., in, out], "s": float32 [..., 1, out]}:
    per-out-channel symmetric, s = max|w| / 127 over the contraction axis;
  * int4: {"q": uint8 [..., in, out / 2], "s": float32 [..., in/g, 1, out]}:
    group-wise symmetric over [-8, 7], s = max|w| / 7 per group of g rows.
    PyTorch has no int4 storage its ops take, so ``q`` packs two signed
    nibbles per byte ALONG OUT: byte j of a row holds column 2j in its
    low nibble (bits 0-3) and column 2j + 1 in its high nibble (bits
    4-7), each two's complement. ``pack_int4`` / ``unpack_int4`` convert
    from / to int8 values; an odd ``out`` is refused at quantize time.
The two forms are told apart by scale rank (grouped scales carry one
more axis), as in the JAX package. Quantization runs in float32 with the
JAX package's arithmetic (the max, the division by 127 or 7, the 1e-12
clamp, ``round(w / s)`` half to even), so its results are bit-identical.

``quant_matmul(x, w)`` is ``x @ mat(w, x.dtype)``, the JAX package's
einsum over ``mat`` (XLA fused the dequantize into the product). On CPU
tensors it runs exactly that, its plain version. On CUDA tensors it runs
the hand-written kernels of ops/kernels/csrc/quant_matmul.cu, W8 (int8)
or W4 (int4), or raises. The route is chosen by x's dtype and the
weight's orientation, never by a fallback:
  * bfloat16 x, a [K, N] weight (every projection and an untied lm_head),
    any M: ONE tensor-core kernel (wgmma) that stages the raw int8 / int4
    tiles, widens them to bf16(q * s) in shared memory and multiplies
    them there; no dense copy of the weight. ``tc_plan`` picks its token
    tile and splits K over blocks for small grids; the partials are
    summed by a second kernel in a fixed order (no atomics, so a greedy
    stream does not change between runs). A call it does not take (K not
    a multiple of 8, an int4 group under 16) raises;
  * float32 x: M <= SKINNY_M rows through the CUDA-core skinny kernel
    (split-K, the same fixed-order combine), more rows dequantize the
    weight into one reused scratch and multiply it with ``torch.matmul``
    (float32 stays off the TF32 tensor cores);
  * a tied embedding table used transposed (``transposed=True``), either
    dtype: the dequantize + ``torch.matmul`` route.
A dense weight is a plain ``x @ w``.
"""

from __future__ import annotations

import torch

from localai_tpu_torch.ops.kernels import LAUNCHES, build

# float32 x: rows up to which the CUDA-core skinny kernel runs (decode:
# num_slots; a prefill pack's unembed: its segments); more go the
# dequantize path
SKINNY_M = 16
# the skinny kernel's tiling (csrc/quant_matmul.cu): output columns per
# block, and the most contraction rows one block stages
TILE_N = 512
MAX_K_CHUNK = 1024
# the tensor-core kernel's tiling (csrc/quant_matmul.cu, tensor_core::):
# weight columns per block, contraction rows per stage, the token tiles it
# is built for, the fewest contraction rows a split takes, the smallest
# int4 group (a stage stages the scale rows its 64 rows span)
TC_TILE_N = 128
TC_TILE_K = 64
TC_TOKEN_TILES = (8, 16, 64, 128, 256)
TC_MIN_K_CHUNK = 256
TC_MIN_GROUP = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def quantize_weight(w: torch.Tensor) -> dict:
    """[..., in, out] float weight -> {"q": int8, "s": float32 per-out-
    channel scale [..., 1, out]}. The scale reduces ONLY the contraction
    (second-to-last) axis, so a stacked [L, in, out] leaf keeps per-layer
    scales and quantizing it one layer slice at a time gives the same
    bytes."""
    w32 = w.to(torch.float32)
    s = w32.abs().amax(dim=-2, keepdim=True) / 127.0
    s = s.clamp_min(1e-12)
    q = torch.round(w32 / s).clamp_(-127, 127).to(torch.int8)
    return {"q": q, "s": s}


def pick_int4_group(cin: int, group: int = 128, shard_divisor: int = 1):
    """Largest group size <= ``group`` dividing ``cin`` whose group count
    divides ``shard_divisor``; None when no group >= 16 qualifies (the
    caller falls back to int8). E.g. 11008 with tp 8 -> 86."""
    for g in range(min(group, cin), 15, -1):
        if cin % g == 0 and (cin // g) % shard_divisor == 0:
            return g
    return None


def quantize_weight_int4(w: torch.Tensor, group: int = 128,
                         shard_divisor: int = 1) -> dict:
    """[..., in, out] float weight -> {"q": packed uint8 [..., in, out/2],
    "s": float32 group scale [..., in/g, 1, out]}, g =
    pick_int4_group(in, group, shard_divisor); per-channel int8 when no
    group qualifies (tiny models)."""
    w32 = w.to(torch.float32)
    cin, out = w32.shape[-2], w32.shape[-1]
    g = pick_int4_group(cin, group, shard_divisor)
    if g is None:
        return quantize_weight(w32)
    if out % 2:
        raise ValueError(f"int4 packs two columns per byte: out {out} is odd")
    lead = w32.shape[:-2]
    wg = w32.reshape(*lead, cin // g, g, out)
    s = wg.abs().amax(dim=-2, keepdim=True) / 7.0
    s = s.clamp_min(1e-12)
    qv = torch.round(wg / s).clamp_(-8, 7).to(torch.int8)
    return {"q": pack_int4(qv.reshape(w32.shape)), "s": s}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], [..., out] (out even) -> uint8 [..., out/2]:
    column 2j in the low nibble of byte j, column 2j + 1 in the high."""
    if q.shape[-1] % 2:
        raise ValueError(f"int4 packs two columns per byte: out {q.shape[-1]} is odd")
    v = q.to(torch.int16) & 0xF
    return (v[..., 0::2] | (v[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., out/2] -> int8 [..., out] (the inverse of pack_int4)."""
    v = p.to(torch.int16)
    lo = ((v & 0xF) ^ 8) - 8
    hi = ((v >> 4) ^ 8) - 8
    return torch.stack((lo, hi), dim=-1).reshape(*p.shape[:-1], -1).to(torch.int8)


def is_grouped(w) -> bool:
    """True for a group-scaled (int4) {q, s} leaf."""
    return isinstance(w, dict) and w["s"].dim() == w["q"].dim() + 1


def mat(w, dtype):
    """Dequantize a weight leaf to ``dtype`` (pass-through for dense): the
    float32 product q * s, rounded once."""
    if not isinstance(w, dict):
        return w
    q, s = w["q"], w["s"]
    if is_grouped(w):
        q = unpack_int4(q)
        shape = q.shape
        G = s.shape[-3]
        wd = q.reshape(*shape[:-2], G, shape[-2] // G, shape[-1])
        return (wd.to(torch.float32) * s).reshape(shape).to(dtype)
    return (q.to(torch.float32) * s).to(dtype)


def quant_matmul_plain(x, w, transposed: bool = False):
    """The plain PyTorch version of W8 / W4 (any device): ``x @ mat(w)``,
    or ``x @ mat(w).T`` for a weight stored [out, in] (a tied embedding
    table, whose int8 scale lies along the contraction axis)."""
    wd = mat(w, x.dtype)
    return x @ (wd.T if transposed else wd)


def quant_matmul(x, w, transposed: bool = False):
    """x [M, K] @ w [K, N] (``transposed``: w stored [N, K]) for a dense,
    int8 or int4 weight leaf; the output has x's dtype. See the module
    doc for the routing."""
    if not isinstance(w, dict):
        return x @ (w.T if transposed else w)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w, transposed)
    grouped = is_grouped(w)
    name = "quant_matmul_int4" if grouped else "quant_matmul_int8"
    q, s = w["q"], w["s"]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    rows, cols = q.shape[-2], q.shape[-1] * (2 if grouped else 1)  # as stored
    K, N = (cols, rows) if transposed else (rows, cols)
    code = _check_args(name, x, q, s, grouped, K, transposed)
    M = x.shape[0]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bits = 4 if grouped else 8
    group = rows // s.shape[-3] if grouped else 0
    if x.dtype == torch.bfloat16 and not transposed:     # tensor cores
        tile, chunk, n_split = tc_plan(M, K, N, _sm_count(x.device))
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
        ws = torch.empty(n_split * M * N if n_split > 1 else 1,
                         dtype=torch.float32, device=x.device)
        err = build.launcher("quant_matmul", "quant_matmul_tc_launch")(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
            ws.data_ptr(), M, K, N, group, bits, tile, chunk, stream)
        build.check(err, name)
    elif M <= SKINNY_M and not transposed:               # float32, CUDA cores
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
        chunk = skinny_k_chunk(K, N, _sm_count(x.device))
        n_split = -(-K // chunk)
        ws = torch.empty(n_split * M * N if n_split > 1 else 1,
                         dtype=torch.float32, device=x.device)
        err = build.launcher("quant_matmul", "quant_matmul_skinny_launch")(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
            ws.data_ptr(), M, K, N, group, bits, chunk, code, stream)
        build.check(err, name)
    else:                           # float32 wide, or the transposed table
        wd = dequant_scratch(rows * cols, x.dtype, x.device)[:rows * cols]
        err = build.launcher("quant_matmul", "quant_dequant_launch")(
            q.data_ptr(), s.data_ptr(), wd.data_ptr(), rows, cols, group,
            bits, code, stream)
        build.check(err, name)
        wd = wd.view(rows, cols)
        out = x @ (wd.T if transposed else wd)
    LAUNCHES[name] += 1
    return out


def tc_token_tile(M: int) -> int:
    """The tensor-core kernel's token tile for M rows of x: the smallest
    of TC_TOKEN_TILES that holds M; past 256 rows the one of 128 and 256
    that pads M least (256 on a tie)."""
    for t in TC_TOKEN_TILES:
        if M <= t:
            return t
    return min((256, 128), key=lambda t: -(-M // t) * t)


def tc_blocks_per_sm(tile: int) -> int:
    """Blocks of the tensor-core kernel an SM holds at a token tile (its
    __launch_bounds__ and shared memory: two up to 64 tokens, one above)."""
    return 2 if tile <= 64 else 1


def tc_plan(M: int, K: int, N: int, sms: int) -> tuple:
    """(token tile, k_chunk, n_split) of the tensor-core kernel: the grid is
    column tiles (N / TC_TILE_N) x token tiles x splits of K. K is split
    only while the grid stays within one wave (``sms`` x blocks per SM)
    and every split keeps TC_MIN_K_CHUNK rows; a grid whose tiles alone
    fill a wave is not split. k_chunk is a multiple of TC_TILE_K. The plan
    depends on the shapes and the SM count only, never on the data."""
    tile = tc_token_tile(M)
    tiles = -(-N // TC_TILE_N) * -(-M // tile)
    wave = sms * tc_blocks_per_sm(tile)
    splits = max(1, min(wave // tiles, K // TC_MIN_K_CHUNK))
    k_tiles = -(-K // TC_TILE_K)
    chunk = -(-k_tiles // splits) * TC_TILE_K
    return tile, chunk, -(-K // chunk)


def skinny_k_chunk(K: int, N: int, sms: int) -> int:
    """Contraction rows per block of the skinny kernel: the most splits of
    K that keep the ceil(N / TILE_N) column tiles x splits within two
    blocks per SM (the 8-row kernel's registers allow two; a second,
    partial wave would cost nearly a full block's time), at least 64 rows
    (16 per warp) and at most MAX_K_CHUNK (the block stages its rows of x
    in shared memory), a multiple of 16."""
    tiles = -(-N // TILE_N)
    splits = max(1, 2 * sms // tiles)
    chunk = max(64, -(-K // splits))
    return min(MAX_K_CHUNK, -(-chunk // 16) * 16)


_SMS: dict = {}
_SCRATCH: dict = {}
_CAPTURED: list = []     # scratch buffers a captured graph writes into


def _sm_count(dev) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def dequant_scratch(numel: int, dtype, dev) -> torch.Tensor:
    """The one reused buffer the dequantize route (float32 x with more than
    SKINNY_M rows, a transposed table) writes into, per device and dtype,
    grown to the largest weight seen (the JAX package's fused dequantize
    needs none; here it costs one weight's dense copy). Kernels
    run in stream order, so the next dequantize waits for the product
    that reads the last one.

    Under CUDA graph capture the buffer must already be large enough (the
    warm-up steps before capture grow it): one allocated inside a capture
    would come from the graph's private pool, so growing it there raises.
    A buffer a capture used is kept alive even once a larger one replaces
    it, since the graph writes into it at every replay."""
    key = (dev.index, dtype)
    buf = _SCRATCH.get(key)
    capturing = dev.type == "cuda" and torch.cuda.is_current_stream_capturing()
    if buf is None or buf.numel() < numel:
        if capturing:
            raise RuntimeError(
                f"dequant_scratch: {numel} elements of {dtype} needed under "
                f"CUDA graph capture, {0 if buf is None else buf.numel()} "
                f"allocated: run the captured step eagerly first")
        _SCRATCH.pop(key, None)
        buf = _SCRATCH[key] = torch.empty(numel, dtype=dtype, device=dev)
    if capturing and not any(b is buf for b in _CAPTURED):
        _CAPTURED.append(buf)
    return buf


def _check_args(name, x, q, s, grouped, K, transposed):
    """What W8 / W4 take: x [M, K] float32 or bfloat16, q int8 [K, N] or
    packed uint8 [K, N/2] (int4), s float32 [1, N] or [K/g, 1, N], all
    contiguous on x's device; N a multiple of 16 (16-byte rows of int8
    columns, 8-byte rows of int4 ones) and 16-byte aligned leaves; for
    the tensor-core kernel (bf16 x, not transposed) also K a multiple of
    8, x 16-byte aligned and an int4 group of at least TC_MIN_GROUP rows.
    Returns x's dtype code."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x dtype {x.dtype} not supported "
                        f"(float32 or bfloat16)")
    want_q = torch.uint8 if grouped else torch.int8
    if q.dtype != want_q or s.dtype != torch.float32:
        raise TypeError(f"{name}: q {q.dtype} / s {s.dtype}, expected "
                        f"{want_q} / torch.float32")
    for k, t in (("x", x), ("q", q), ("s", s)):
        if t.device != x.device:
            raise ValueError(f"{name}: {k} on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    if x.dim() != 2 or x.shape[1] != K or q.dim() != 2:
        raise ValueError(f"{name}: x{tuple(x.shape)} does not match the "
                         f"weight q{tuple(q.shape)}")
    rows, cols = q.shape[0], q.shape[1] * (2 if grouped else 1)
    if grouped:
        if s.dim() != 3 or s.shape[1] != 1 or s.shape[2] != cols \
                or rows % s.shape[0]:
            raise ValueError(f"{name}: scale {tuple(s.shape)} does not match "
                             f"q{tuple(q.shape)}")
        if transposed:
            raise ValueError(f"{name}: a transposed weight is int8 only "
                             f"(embedding tables stay int8)")
    elif tuple(s.shape) != (1, cols):
        raise ValueError(f"{name}: scale {tuple(s.shape)} does not match "
                         f"q{tuple(q.shape)}")
    if cols % 16:
        raise ValueError(f"{name}: out {cols} must be a multiple of 16")
    if x.dtype == torch.bfloat16 and not transposed:   # the tensor-core kernel
        if K % 8 or x.data_ptr() % 16:
            raise ValueError(f"{name}: in {K} must be a multiple of 8 and x "
                             f"16-byte aligned (16-byte copies of bf16 rows)")
        if grouped and rows // s.shape[0] < TC_MIN_GROUP:
            raise ValueError(f"{name}: int4 group {rows // s.shape[0]} under "
                             f"{TC_MIN_GROUP}")
    for k, t in (("q", q), ("s", s)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {k} must be 16-byte aligned")
    return _DTYPE_CODE[x.dtype]
