"""GGUF checkpoint ingestion (a copy of localai_tpu/engine/gguf.py, in
numpy): header and metadata parse, block dequantization, and the mapping
onto the port's stacked llama parameter layout.

GGUF is the format LocalAI users pull (an ``ollama://`` or gallery
model is one ``.gguf`` blob). The port dequantizes its tensors into dense
arrays at LOAD time, as the JAX package does; engine/weights.py then
casts each leaf to the model dtype, or re-quantizes it to the port's
weight-only int8 / int4 (``quantization``), so llama.cpp's block formats
are a storage format here, not a compute format.

Tensor types read: F32, F16, BF16, Q8_0, Q4_0, Q4_1, Q5_0, Q5_1, Q4_K,
Q5_K, Q6_K (the ollama-default and *_K_M gallery quants). Any other type
raises ValueError naming it; nothing falls back.

``config_from_gguf`` reads the llama architecture's metadata into a
LlamaConfig with the JAX package's rules, its gaps included: rope
scaling is read for ``linear`` and ``yarn`` only, and a Llama-3
``rope_freqs`` tensor is not read.

``iter_llama_tensors`` yields one stacked leaf at a time (float16 by
default, the JAX loader's host dtype), so peak host memory is one leaf;
the layers of a stacked leaf, and the block ranges of a big tensor (an
embedding table), are dequantized on a few threads (numpy releases the
GIL in its loops), which changes no value.

``write_gguf`` writes a GGUF v3 file (F32 / F16 / Q8_0 / Q4_0 encoders,
byte for byte the JAX writer's output, its block loops vectorized and a
big tensor's chunks encoded on threads): how the tests and chip_smoke.py
make their own checkpoints.
"""

from __future__ import annotations

import functools
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Any, BinaryIO

import numpy as np

GGUF_MAGIC = b"GGUF"

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL, _T_STR, \
    _T_ARR, _T_U64, _T_I64, _T_F64 = range(13)

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_BOOL: "<?",
    _T_U64: "<Q", _T_I64: "<q", _T_F64: "<d",
}

# ggml tensor types (ggml.h enum ggml_type)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0, GGML_Q8_1 = 8, 9
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K, GGML_Q8_K = 10, 11, 12, 13, 14, 15
GGML_BF16 = 30

# type -> (block_elems, block_bytes)
_BLOCK = {
    GGML_F32: (1, 4), GGML_F16: (1, 2), GGML_BF16: (1, 2),
    GGML_Q4_0: (32, 18), GGML_Q4_1: (32, 20),
    GGML_Q5_0: (32, 22), GGML_Q5_1: (32, 24),
    GGML_Q8_0: (32, 34),
    GGML_Q4_K: (256, 144), GGML_Q5_K: (256, 176), GGML_Q6_K: (256, 210),
}

_TYPE_NAMES = {v: k[5:] for k, v in globals().items() if k.startswith("GGML_")}

# threads that dequantize the layers of one stacked leaf, or the block
# ranges of one tensor of at least _SPLIT_ELEMS elements
_THREADS = max(1, min(8, os.cpu_count() or 1))
_SPLIT_ELEMS = 1 << 26


def _read_str(f: BinaryIO) -> str:
    n = struct.unpack("<Q", f.read(8))[0]
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype == _T_STR:
        return _read_str(f)
    if vtype == _T_ARR:
        etype, n = struct.unpack("<IQ", f.read(12))
        if etype in _SCALAR_FMT:
            fmt = _SCALAR_FMT[etype]
            size = struct.calcsize(fmt)
            raw = f.read(size * n)
            return [struct.unpack_from(fmt, raw, i * size)[0] for i in range(n)]
        return [_read_value(f, etype) for _ in range(n)]
    fmt = _SCALAR_FMT[vtype]
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]


class GGUFFile:
    """Parsed GGUF header: ``metadata`` dict + ``tensors`` name->info, with
    lazy per-tensor dequantization from a memory map."""

    def __init__(self, path: str):
        self.path = path
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, dict] = {}
        with open(path, "rb") as f:
            if f.read(4) != GGUF_MAGIC:
                raise ValueError(f"{path}: not a GGUF file")
            self.version = struct.unpack("<I", f.read(4))[0]
            if self.version < 2:
                raise ValueError(f"GGUF v{self.version} unsupported (need >= 2)")
            n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
            for _ in range(n_kv):
                key = _read_str(f)
                vtype = struct.unpack("<I", f.read(4))[0]
                self.metadata[key] = _read_value(f, vtype)
            for _ in range(n_tensors):
                name = _read_str(f)
                n_dims = struct.unpack("<I", f.read(4))[0]
                dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
                ttype, offset = struct.unpack("<IQ", f.read(12))
                self.tensors[name] = {
                    "dims": dims,  # ggml order: dims[0] fastest-varying
                    "type": ttype,
                    "offset": offset,
                }
            align = int(self.metadata.get("general.alignment", 32))
            pos = f.tell()
            self.data_start = (pos + align - 1) // align * align
        self._mmap = np.memmap(path, dtype=np.uint8, mode="r")

    def tensor(self, name: str, dtype=np.float32) -> np.ndarray:
        """Dequantize a tensor, shaped in ROW-MAJOR numpy order (ggml dims
        reversed): a ggml [in, out] matrix comes back [out, in], the
        orientation of HF ``*.weight`` tensors. ``dtype=np.float16``
        halves host memory during load (quantized sources carry <= f16
        precision anyway)."""
        info = self.tensors[name]
        dims = info["dims"]
        ttype = info["type"]
        if ttype not in _BLOCK:
            raise ValueError(
                f"{name}: unsupported GGML type {ttype} "
                f"({_TYPE_NAMES.get(ttype, '?')})")
        n_elems = int(np.prod(dims))
        be, bb = _BLOCK[ttype]
        nbytes = n_elems // be * bb
        start = self.data_start + info["offset"]
        raw = np.asarray(self._mmap[start:start + nbytes])
        shape = tuple(reversed(dims))
        if n_elems < _SPLIT_ELEMS:
            flat = _dequantize(raw, ttype, n_elems)
            if dtype is not np.float32:
                flat = flat.astype(dtype)
            return flat.reshape(shape)
        # a big tensor (an embedding table): whole blocks on each thread
        out = np.empty(n_elems, dtype)
        nblk = n_elems // be
        per = -(-nblk // _THREADS)

        def part(k):
            b0, b1 = k * per, min(nblk, (k + 1) * per)
            out[b0 * be:b1 * be] = _dequantize(raw[b0 * bb:b1 * bb], ttype,
                                               (b1 - b0) * be)

        with ThreadPoolExecutor(_THREADS) as ex:
            list(ex.map(part, range(-(-nblk // per))))
        return out.reshape(shape)


@functools.lru_cache(maxsize=4)
def open_gguf(path: str) -> GGUFFile:
    """Shared parsed-header cache: config, weights and tokenizer all read
    the same file during one load, so the (vocabulary-sized) metadata is
    parsed once, not three times."""
    return GGUFFile(path)


def _f16(raw_u8: np.ndarray) -> np.ndarray:
    return raw_u8.view(np.float16).astype(np.float32)


def _dequantize(raw: np.ndarray, ttype: int, n: int) -> np.ndarray:
    """raw uint8 buffer -> float32 [n]. Layouts follow ggml-quants.c."""
    if ttype == GGML_F32:
        return np.asarray(raw.view(np.float32)[:n])
    if ttype == GGML_F16:
        return _f16(raw)[:n]
    if ttype == GGML_BF16:
        out = np.zeros(n, np.float32)
        out.view(np.uint32)[:] = raw.view(np.uint16)[:n].astype(np.uint32) << 16
        return out
    if ttype == GGML_Q8_0:
        # block: f16 d; int8 qs[32]
        blocks = raw.reshape(-1, 34)
        d = _f16(blocks[:, :2].reshape(-1))[:, None]
        q = blocks[:, 2:].view(np.int8).astype(np.float32)
        return (d * q).reshape(-1)[:n]
    if ttype == GGML_Q4_0:
        # block: f16 d; u8 qs[16] (elem i in low nibble, i+16 in high)
        blocks = raw.reshape(-1, 18)
        d = _f16(blocks[:, :2].reshape(-1))[:, None]
        qs = blocks[:, 2:]
        lo = (qs & 0x0F).astype(np.int8) - 8
        hi = (qs >> 4).astype(np.int8) - 8
        q = np.concatenate([lo, hi], axis=1).astype(np.float32)
        return (d * q).reshape(-1)[:n]
    if ttype == GGML_Q4_1:
        # block: f16 d, m; u8 qs[16]
        blocks = raw.reshape(-1, 20)
        d = _f16(blocks[:, :2].reshape(-1))[:, None]
        m = _f16(blocks[:, 2:4].reshape(-1))[:, None]
        qs = blocks[:, 4:]
        lo = (qs & 0x0F).astype(np.float32)
        hi = (qs >> 4).astype(np.float32)
        q = np.concatenate([lo, hi], axis=1)
        return (d * q + m).reshape(-1)[:n]
    if ttype in (GGML_Q5_0, GGML_Q5_1):
        # block: f16 d (,f16 m); u32 qh; u8 qs[16]; the 5th bit from qh
        bb = 22 if ttype == GGML_Q5_0 else 24
        blocks = raw.reshape(-1, bb)
        d = _f16(blocks[:, :2].reshape(-1))[:, None]
        off = 2
        if ttype == GGML_Q5_1:
            m = _f16(blocks[:, 2:4].reshape(-1))[:, None]
            off = 4
        qh = blocks[:, off:off + 4].copy().view(np.uint32).reshape(-1, 1)
        qs = blocks[:, off + 4:]
        shifts = np.arange(32, dtype=np.uint32)
        h = ((qh >> shifts) & 1).astype(np.uint8)          # [B, 32]
        lo = (qs & 0x0F)
        hi = (qs >> 4)
        q4 = np.concatenate([lo, hi], axis=1)              # [B, 32]
        q = (q4 | (h << 4)).astype(np.float32)
        if ttype == GGML_Q5_0:
            return (d * (q - 16.0)).reshape(-1)[:n]
        return (d * q + m).reshape(-1)[:n]
    if ttype == GGML_Q4_K:
        # super-block of 256: f16 d, dmin; u8 scales[12] (6-bit packed,
        # 8 sub-blocks of 32); u8 qs[128]
        blocks = raw.reshape(-1, 144)
        d = _f16(blocks[:, :2].reshape(-1))
        dmin = _f16(blocks[:, 2:4].reshape(-1))
        sc, mn = _unpack_k_scales(blocks[:, 4:16])          # [B, 8] each
        qs = blocks[:, 16:]                                 # [B, 128]
        # pairs of sub-blocks share 32 bytes: low nibbles sb 2j, high 2j+1
        q = np.empty((blocks.shape[0], 256), np.float32)
        for j in range(4):
            chunk = qs[:, j * 32:(j + 1) * 32]
            q[:, (2 * j) * 32:(2 * j + 1) * 32] = (chunk & 0x0F)
            q[:, (2 * j + 1) * 32:(2 * j + 2) * 32] = (chunk >> 4)
        scale = (d[:, None] * sc).repeat(32, axis=1)
        minv = (dmin[:, None] * mn).repeat(32, axis=1)
        return (scale * q - minv).reshape(-1)[:n]
    if ttype == GGML_Q5_K:
        # f16 d, dmin; scales[12]; u8 qh[32]; u8 qs[128]
        blocks = raw.reshape(-1, 176)
        d = _f16(blocks[:, :2].reshape(-1))
        dmin = _f16(blocks[:, 2:4].reshape(-1))
        sc, mn = _unpack_k_scales(blocks[:, 4:16])
        qh = blocks[:, 16:48]                               # [B, 32]
        qs = blocks[:, 48:]                                 # [B, 128]
        q = np.empty((blocks.shape[0], 256), np.float32)
        for j in range(4):
            chunk = qs[:, j * 32:(j + 1) * 32]
            hbit_lo = (qh >> (2 * j)) & 1
            hbit_hi = (qh >> (2 * j + 1)) & 1
            q[:, (2 * j) * 32:(2 * j + 1) * 32] = (chunk & 0x0F) | (hbit_lo << 4)
            q[:, (2 * j + 1) * 32:(2 * j + 2) * 32] = (chunk >> 4) | (hbit_hi << 4)
        scale = (d[:, None] * sc).repeat(32, axis=1)
        minv = (dmin[:, None] * mn).repeat(32, axis=1)
        return (scale * q - minv).reshape(-1)[:n]
    if ttype == GGML_Q6_K:
        # u8 ql[128]; u8 qh[64]; i8 scales[16]; f16 d; 16 sub-blocks of 16
        blocks = raw.reshape(-1, 210)
        ql = blocks[:, :128]
        qh = blocks[:, 128:192]
        scales = blocks[:, 192:208].view(np.int8).astype(np.float32)
        d = _f16(blocks[:, 208:210].reshape(-1))[:, None]
        B = blocks.shape[0]
        q = np.empty((B, 256), np.float32)
        # layout per ggml-quants.c dequantize_row_q6_K: two halves of 128
        for half in range(2):
            lq = ql[:, half * 64:(half + 1) * 64]
            hq = qh[:, half * 32:(half + 1) * 32]
            base = half * 128
            q[:, base + 0:base + 32] = ((lq[:, :32] & 0x0F) | ((hq & 0x03) << 4)).astype(np.int8) - 32
            q[:, base + 32:base + 64] = ((lq[:, 32:] & 0x0F) | (((hq >> 2) & 0x03) << 4)).astype(np.int8) - 32
            q[:, base + 64:base + 96] = ((lq[:, :32] >> 4) | (((hq >> 4) & 0x03) << 4)).astype(np.int8) - 32
            q[:, base + 96:base + 128] = ((lq[:, 32:] >> 4) | (((hq >> 6) & 0x03) << 4)).astype(np.int8) - 32
        scale = (d * scales).repeat(16, axis=1)
        return (scale * q).reshape(-1)[:n]
    raise ValueError(f"unsupported GGML type {ttype} ({_TYPE_NAMES.get(ttype, '?')})")


def _unpack_k_scales(sc12: np.ndarray):
    """Unpack the 12-byte 6-bit scale/min table of Q4_K/Q5_K.

    Sub-blocks 0-3: scale = q[j] & 63, min = q[j+4] & 63.
    Sub-blocks 4-7: scale = (q[j+4] & 0xF) | ((q[j-4] >> 6) << 4),
                    min   = (q[j+4] >> 4)  | ((q[j]   >> 6) << 4).
    (ggml-quants.c get_scale_min_k4.)
    """
    q = sc12.astype(np.uint8)
    B = q.shape[0]
    sc = np.empty((B, 8), np.float32)
    mn = np.empty((B, 8), np.float32)
    for j in range(4):
        sc[:, j] = (q[:, j] & 63)
        mn[:, j] = (q[:, j + 4] & 63)
    for j in range(4, 8):
        sc[:, j] = (q[:, j + 4] & 0x0F) | ((q[:, j - 4] >> 6) << 4)
        mn[:, j] = (q[:, j + 4] >> 4) | ((q[:, j] >> 6) << 4)
    return sc, mn


# ---------- llama mapping ----------

def config_from_gguf(g: "GGUFFile | str"):
    """A LlamaConfig from GGUF metadata (the keys of the GGUF spec's llama
    architecture section; the JAX package's rules, model dtype left at
    its default for the caller to replace)."""
    from localai_tpu_torch.models.llama import LlamaConfig

    if isinstance(g, str):
        g = GGUFFile(g)
    md = g.metadata
    arch = md.get("general.architecture", "llama")
    pre = arch + "."

    def get(key, default=None):
        return md.get(pre + key, default)

    n_heads = int(get("attention.head_count", 32))
    vocab = g.tensors["token_embd.weight"]["dims"][1]
    hidden = int(get("embedding_length", g.tensors["token_embd.weight"]["dims"][0]))
    rs_type = "none"
    factor = float(get("rope.scaling.factor", 1.0) or 1.0)
    st = get("rope.scaling.type")
    if st in ("linear", "yarn"):
        rs_type = st
    return LlamaConfig(
        vocab_size=int(vocab),
        hidden_size=hidden,
        intermediate_size=int(get("feed_forward_length", 4 * hidden)),
        num_layers=int(get("block_count", 32)),
        num_heads=n_heads,
        num_kv_heads=int(get("attention.head_count_kv", n_heads)),
        head_dim=int(get("rope.dimension_count", hidden // n_heads)),
        rope_theta=float(get("rope.freq_base", 10000.0)),
        rope_scaling_type=rs_type,
        rope_scaling_factor=factor,
        rope_original_max_position=int(
            get("rope.scaling.original_context_length",
                get("context_length", 8192))),
        rms_norm_eps=float(get("attention.layer_norm_rms_epsilon", 1e-5)),
        max_position_embeddings=int(get("context_length", 4096)),
        tie_word_embeddings="output.weight" not in g.tensors,
    )


def _unpermute(w: np.ndarray, n_heads: int) -> np.ndarray:
    """GGUF stores llama wq/wk rows in the interleaved (Meta) rope layout
    (llama.cpp's converter permutes HF weights); the port's rope is HF
    rotate_half, so apply the inverse permutation. w: [out, in]."""
    out, inn = w.shape
    return (w.reshape(n_heads, out // n_heads // 2, 2, inn)
            .swapaxes(1, 2)
            .reshape(out, inn))


def iter_llama_tensors(g: GGUFFile, cfg, dtype=np.float16):
    """Yield (leaf path, host array) one stacked leaf at a time, in the
    port's layout (layers stacked on axis 0, projections [in, out]), so
    the caller places each leaf on the device and frees the host copy
    before the next is dequantized."""
    L = cfg.num_layers

    def stack(fmt, permute_heads=0):
        def one(i):
            m = g.tensor(fmt.format(i=i), dtype)
            if permute_heads:
                m = _unpermute(m, permute_heads)
            return np.ascontiguousarray(m.T)

        with ThreadPoolExecutor(_THREADS) as ex:
            return np.stack(list(ex.map(one, range(L))))

    def stack_vec(fmt):
        return np.stack([g.tensor(fmt.format(i=i), dtype) for i in range(L)])

    yield ("embed",), g.tensor("token_embd.weight", dtype)
    yield ("layers", "attn_norm"), stack_vec("blk.{i}.attn_norm.weight")
    yield ("layers", "wq"), stack("blk.{i}.attn_q.weight",
                                  permute_heads=cfg.num_heads)
    yield ("layers", "wk"), stack("blk.{i}.attn_k.weight",
                                  permute_heads=cfg.num_kv_heads)
    yield ("layers", "wv"), stack("blk.{i}.attn_v.weight")
    yield ("layers", "wo"), stack("blk.{i}.attn_output.weight")
    yield ("layers", "mlp_norm"), stack_vec("blk.{i}.ffn_norm.weight")
    yield ("layers", "w_gate"), stack("blk.{i}.ffn_gate.weight")
    yield ("layers", "w_up"), stack("blk.{i}.ffn_up.weight")
    yield ("layers", "w_down"), stack("blk.{i}.ffn_down.weight")
    yield ("final_norm",), g.tensor("output_norm.weight", dtype)
    if "output.weight" in g.tensors:
        yield ("lm_head",), np.ascontiguousarray(
            g.tensor("output.weight", dtype).T)


# ---------- writer ----------

# blocks encoded per chunk, the chunks of a big tensor on _THREADS threads
# (bounds the float32 temporaries)
_ENC_CHUNK = 1 << 20


def _enc_q8_0(blocks: np.ndarray) -> bytes:
    d = np.maximum(np.abs(blocks).max(axis=1), 1e-12) / 127.0
    q = np.clip(np.rint(blocks / d[:, None]), -127, 127).astype(np.int8)
    out = np.empty(blocks.shape[0], dtype=[("d", "<f2"), ("q", "i1", (32,))])
    out["d"] = d.astype(np.float16)
    out["q"] = q
    return out.tobytes()


def _enc_q4_0(blocks: np.ndarray) -> bytes:
    amax_idx = np.argmax(np.abs(blocks), axis=1)
    maxv = blocks[np.arange(blocks.shape[0]), amax_idx]
    d = np.where(maxv == 0, 1e-12, maxv / -8.0)
    q = np.clip(np.rint(blocks / d[:, None] + 8.0), 0, 15).astype(np.uint8)
    packed = (q[:, :16] | (q[:, 16:] << 4)).astype(np.uint8)
    out = np.empty(blocks.shape[0], dtype=[("d", "<f2"), ("q", "u1", (16,))])
    out["d"] = d.astype(np.float16)
    out["q"] = packed
    return out.tobytes()


_ENCODERS = {GGML_Q8_0: _enc_q8_0, GGML_Q4_0: _enc_q4_0}


def write_gguf(path: str, metadata: dict, tensors: dict,
               tensor_types: dict = None):
    """Write a GGUF v3 file (float32 / float16 / Q8_0 / Q4_0 encoders) —
    the tiny-checkpoint path for offline tests and a general exporter."""
    tensor_types = tensor_types or {}
    align = 32

    def enc_str(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    def enc_value(v) -> bytes:
        if isinstance(v, bool):
            return struct.pack("<I?", _T_BOOL, v)
        if isinstance(v, int):
            return struct.pack("<Iq", _T_I64, v) if v < 0 else struct.pack("<IQ", _T_U64, v)
        if isinstance(v, float):
            return struct.pack("<If", _T_F32, v)
        if isinstance(v, str):
            return struct.pack("<I", _T_STR) + enc_str(v)
        if isinstance(v, (list, tuple)):
            if all(isinstance(x, str) for x in v):
                body = b"".join(enc_str(x) for x in v)
                return struct.pack("<IIQ", _T_ARR, _T_STR, len(v)) + body
            if all(isinstance(x, int) for x in v):
                body = np.asarray(v, np.int64).astype("<i4").tobytes()
                return struct.pack("<IIQ", _T_ARR, _T_I32, len(v)) + body
            body = np.asarray(v, np.float64).astype("<f4").tobytes()
            return struct.pack("<IIQ", _T_ARR, _T_F32, len(v)) + body
        raise TypeError(f"unsupported metadata value {type(v)}")

    def encode_tensor(arr: np.ndarray, ttype: int) -> bytes:
        flat = np.asarray(arr, np.float32).reshape(-1)
        if ttype == GGML_F32:
            return flat.tobytes()
        if ttype == GGML_F16:
            return flat.astype(np.float16).tobytes()
        enc = _ENCODERS.get(ttype)
        if enc is None:
            raise ValueError(f"no encoder for GGML type {ttype}")
        blocks = flat.reshape(-1, 32)
        chunks = [blocks[i:i + _ENC_CHUNK]
                  for i in range(0, blocks.shape[0], _ENC_CHUNK)]
        if len(chunks) == 1:
            return enc(chunks[0])
        with ThreadPoolExecutor(_THREADS) as ex:
            return b"".join(ex.map(enc, chunks))

    infos = []
    blobs = []
    offset = 0
    for name, arr in tensors.items():
        ttype = tensor_types.get(name, GGML_F32)
        blob = encode_tensor(arr, ttype)
        dims = tuple(reversed(np.asarray(arr).shape))
        infos.append((name, dims, ttype, offset))
        blobs.append(blob)
        offset += len(blob)
        offset = (offset + align - 1) // align * align

    with open(path, "wb") as f:
        f.write(GGUF_MAGIC)
        f.write(struct.pack("<I", 3))
        f.write(struct.pack("<QQ", len(tensors), len(metadata)))
        for k, v in metadata.items():
            f.write(enc_str(k))
            f.write(enc_value(v))
        for name, dims, ttype, off in infos:
            f.write(enc_str(name))
            f.write(struct.pack("<I", len(dims)))
            f.write(struct.pack(f"<{len(dims)}Q", *dims))
            f.write(struct.pack("<IQ", ttype, off))
        pos = f.tell()
        f.write(b"\x00" * ((pos + align - 1) // align * align - pos))
        for i, blob in enumerate(blobs):
            f.write(blob)
            pos = f.tell()
            if i + 1 < len(blobs):
                f.write(b"\x00" * ((pos + align - 1) // align * align - pos))
