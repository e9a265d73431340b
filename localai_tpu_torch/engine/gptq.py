"""GPTQ / AWQ quantized-safetensors ingestion (a copy of the JAX package's
localai_tpu/engine/gptq.py, in numpy).

The packed 2/4/8-bit linears are unpacked on the host into dense float32
[in, out] and then take the path every other checkpoint takes
(engine/weights.py): by default re-quantized to the port's weight-only
per-out-channel int8 {q, s} (ops/quant.py), so a quantized checkpoint
keeps its memory intent on the card.

Formats (load-bearing conventions):
- **GPTQ** (AutoGPTQ v1 / HF ``quant_method: "gptq"``): ``qweight`` int32
  [in/pack, out] packed along the INPUT axis, value k of each int32 at
  bit offset k*bits; ``qzeros`` int32 [groups, out/pack] packed along the
  OUTPUT axis; ``scales`` f16 [groups, out]; optional ``g_idx`` int32
  [in] (act-order / desc_act). Dequant:
  ``W[i,o] = scales[g(i),o] * (wq[i,o] - (zeros[g(i),o] + 1))``, the v1
  "+1" zero-point offset.
- **AWQ** (AutoAWQ / HF ``quant_method: "awq"``): ``qweight`` int32
  [in, out/pack] packed along the OUTPUT axis with the interleaved column
  order [0, 2, 4, 6, 1, 3, 5, 7] per int32; ``qzeros`` [groups, out/pack]
  in the same order; ``scales`` f16 [groups, out]; no +1 offset, no g_idx
  (sequential groups).

pack = 32 // bits; bits in {2, 4, 8} (3-bit does not divide 32 and is
refused).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np

_AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


class QuantMeta:
    def __init__(self, method: str, bits: int, group_size: int,
                 desc_act: bool = False, sym: bool = False):
        if bits not in (2, 4, 8):
            raise ValueError(
                f"{method} bits={bits} unsupported (must divide 32: 2/4/8)")
        self.method = method
        self.bits = bits
        self.group_size = group_size
        self.desc_act = desc_act
        self.sym = sym

    def __repr__(self):
        return (f"QuantMeta({self.method}, bits={self.bits}, "
                f"group_size={self.group_size}, desc_act={self.desc_act})")


def detect(model_dir: str) -> Optional[QuantMeta]:
    """QuantMeta if the checkpoint dir is GPTQ/AWQ-quantized, else None:
    ``quantize_config.json`` (AutoGPTQ) first, then
    ``config.json:quantization_config`` (HF transformers)."""
    qc = os.path.join(model_dir, "quantize_config.json")
    d = None
    method = "gptq"
    if os.path.isfile(qc):
        with open(qc) as f:
            d = json.load(f)
        method = (d.get("quant_method") or d.get("checkpoint_format")
                  or "gptq").lower()
    else:
        cfgp = os.path.join(model_dir, "config.json")
        if os.path.isfile(cfgp):
            with open(cfgp) as f:
                d = json.load(f).get("quantization_config")
            if d is not None:
                method = (d.get("quant_method") or "gptq").lower()
    if d is None:
        return None
    if method not in ("gptq", "awq"):
        raise ValueError(f"unsupported quant_method {method!r} "
                         "(gptq/awq are ingestible)")
    return QuantMeta(
        method, int(d.get("bits", 4)), int(d.get("group_size", 128)),
        bool(d.get("desc_act", False)), bool(d.get("sym", False)))


def _unpack_rows(packed: np.ndarray, bits: int) -> np.ndarray:
    """int32 [R, C] -> [R*pack, C]: value k of each int32 sits at bit
    offset k*bits and expands DOWN the row axis."""
    pack = 32 // bits
    shifts = (np.arange(pack, dtype=np.uint32) * bits)[None, :, None]
    vals = (packed.astype(np.uint32)[:, None, :] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(packed.shape[0] * pack, packed.shape[1])


def _unpack_cols(packed: np.ndarray, bits: int) -> np.ndarray:
    """int32 [R, C] -> [R, C*pack]: value k expands ALONG the column axis."""
    pack = 32 // bits
    shifts = (np.arange(pack, dtype=np.uint32) * bits)[None, None, :]
    vals = (packed.astype(np.uint32)[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(packed.shape[0], packed.shape[1] * pack)


def _awq_deinterleave(cols: np.ndarray, bits: int) -> np.ndarray:
    """Undo AWQ's per-int32 column interleave: unpacked position k within
    each block of ``pack`` columns holds logical column _AWQ_ORDER[k]."""
    if 32 // bits != 8:
        return cols  # the interleave is defined for 4-bit (pack=8) only
    idx = np.arange(cols.shape[1])
    inv = np.empty(8, np.int64)
    for k, col in enumerate(_AWQ_ORDER):
        inv[col] = k
    return cols[:, (idx // 8) * 8 + inv[idx % 8]]


def dequant_linear(get: Callable[[str], np.ndarray], prefix: str,
                   meta: QuantMeta) -> np.ndarray:
    """Dequantize one quantized Linear to dense float32 **[in, out]**.
    ``get(name)`` fetches raw tensors as numpy; ``prefix`` is the module
    path (e.g. "model.layers.3.self_attn.q_proj")."""
    qweight = np.asarray(get(prefix + ".qweight"))
    qzeros = np.asarray(get(prefix + ".qzeros"))
    scales = np.asarray(get(prefix + ".scales"), np.float32)   # [G, out]
    if meta.method == "awq":
        wq = _awq_deinterleave(_unpack_cols(qweight, meta.bits), meta.bits)
        zeros = _awq_deinterleave(_unpack_cols(qzeros, meta.bits),
                                  meta.bits).astype(np.float32)
    else:
        wq = _unpack_rows(qweight, meta.bits)                  # [in, out]
        zeros = _unpack_cols(qzeros, meta.bits).astype(np.float32) + 1.0
    n_in = wq.shape[0]
    G = scales.shape[0]
    if meta.method == "gptq" and meta.desc_act:
        g_idx = np.asarray(get(prefix + ".g_idx"), np.int64)   # [in]
    else:
        gs = meta.group_size if meta.group_size > 0 else n_in
        g_idx = np.minimum(np.arange(n_in) // gs, G - 1)
    return scales[g_idx] * (wq.astype(np.float32) - zeros[g_idx])
