"""Llama weights -> the port's parameter dict (counterpart of
localai_tpu/engine/weights.py).

Three sources, one layout (models/llama.py: layers stacked on axis 0,
projections [in, out]):

  * ``load_llama_params``: the checkpoint a model dir (or path) names, as
    the JAX package's ``_host_leaf_source`` reads it: a GGUF file
    (``find_gguf``: the path itself, or the one ``*.gguf`` of a dir with no
    safetensors), dequantized on the host by engine/gguf.py; or HF
    safetensors read with numpy alone — the 8-byte header length, the
    JSON header, then ``np.frombuffer`` over a memory map; bf16 goes
    through a uint16 view. HF names map to leaves as in the JAX package.
  * ``random_params``: random weights from a seed, generated on the target
    device (an 8B in bf16 never exists densely on the host). For a
    config.json-only dir, and only when the caller asks for it.
  * ``from_jax_params``: the JAX package's parameter pytree (leaves as
    numpy arrays) — how the tests feed both packages the same weights.

``quantize`` ("" | "int8" | "int4") stores the matmul weights as
weight-only {q, s} leaves (ops/quant.py), with the semantics of the JAX
package's ``_make_put``: int8 for every matmul weight, int4 for the
layer matmuls only (embed / lm_head stay int8), norms untouched. A
stacked leaf is quantized one layer slice at a time, in float32, on the
device: the scale reduces only the contraction axis (and its groups), so
the slices give the stacked result's bytes and no stacked float32 copy
exists. A GPTQ / AWQ checkpoint (engine/gptq.py) is dequantized on the
host as it is read and, with no explicit ``quantize``, loads as int8.

``lora_adapter`` (engine/lora.py) merges a PEFT adapter into the layer
leaves it targets as they are placed, before any cast or quantization,
with the semantics of the JAX ``_make_put``: each layer slice is taken
to float32 on the device and ``scale * (B @ A).T`` (computed in numpy,
as the JAX adapter computes it) is added, in every source above.
"""

from __future__ import annotations

import glob
import json
import math
import os
import struct
from typing import Optional

import numpy as np
import torch

from localai_tpu_torch import resolve_device
from localai_tpu_torch.engine import gptq
from localai_tpu_torch.engine.lora import maybe_adapter
from localai_tpu_torch.models.llama import QUANT_NAMES
from localai_tpu_torch.ops.quant import (pack_int4, quantize_weight,
                                         quantize_weight_int4)

QUANTIZATIONS = ("", "int8", "int4")

_ST_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16,
              "I32": np.int32, "I64": np.int64}


def read_safetensors_header(path: str) -> tuple:
    """(header dict, byte offset of the data section)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


class SafetensorsFile:
    """Read-only numpy view of one .safetensors file."""

    def __init__(self, path: str):
        self.path = path
        self.header, self._base = read_safetensors_header(path)
        self.header.pop("__metadata__", None)
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")

    def keys(self):
        return self.header.keys()

    def get(self, name: str) -> torch.Tensor:
        """The tensor as a CPU torch tensor in its stored dtype."""
        meta = self.header[name]
        dt = _ST_DTYPES.get(meta["dtype"])
        if dt is None:
            raise NotImplementedError(f"safetensors dtype {meta['dtype']}")
        b, e = meta["data_offsets"]
        raw = self._mm[self._base + b:self._base + e]
        arr = np.frombuffer(raw, dtype=dt).reshape(meta["shape"])
        t = torch.from_numpy(arr.copy())
        return t.view(torch.bfloat16) if meta["dtype"] == "BF16" else t


def open_checkpoint(model_dir: str) -> dict:
    """name -> SafetensorsFile across every shard in the dir."""
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    out = {}
    for f in files:
        st = SafetensorsFile(f)
        for name in st.keys():
            out[name] = st
    return out


def has_weights(model_dir: str) -> bool:
    return bool(glob.glob(os.path.join(model_dir, "*.safetensors")))


def find_gguf(model_dir: str) -> Optional[str]:
    """Path to the GGUF file a model dir/path refers to, if any: either the
    path itself or the single *.gguf inside a directory with no safetensors
    (the shape an ``ollama://`` / gallery pull produces)."""
    if model_dir.endswith(".gguf") and os.path.isfile(model_dir):
        return model_dir
    if os.path.isdir(model_dir):
        ggufs = sorted(glob.glob(os.path.join(model_dir, "*.gguf")))
        sts = glob.glob(os.path.join(model_dir, "*.safetensors"))
        if len(ggufs) == 1 and not sts:
            return ggufs[0]
    return None


def _gguf_leaves(path: str, cfg):
    """(spec_path, CPU tensor) per leaf of a GGUF file: engine/gguf.py's
    float16 host arrays, one stacked leaf at a time."""
    from localai_tpu_torch.engine import gguf as gguflib

    for spec_path, arr in gguflib.iter_llama_tensors(gguflib.open_gguf(path),
                                                     cfg):
        yield spec_path, torch.from_numpy(arr)


def _host_leaves(tensors: dict, cfg, qmeta=None):
    """(spec_path, CPU tensor) per leaf, HF names -> the stacked layout
    (the mapping of the JAX package's _host_leaf_source); GPTQ / AWQ
    packed linears (``qmeta``) are dequantized to float32 [in, out]."""
    L = cfg.num_layers

    def get(name):
        return tensors[name].get(name)

    def linear_t(name: str):
        base = name[:-len(".weight")]
        if qmeta is not None and base + ".qweight" in tensors:
            return torch.from_numpy(gptq.dequant_linear(
                lambda n: get(n).numpy(), base, qmeta))
        return get(name).T

    def stack(fmt: str, transpose: bool = False):
        return torch.stack([linear_t(fmt.format(i=i)) if transpose
                            else get(fmt.format(i=i)) for i in range(L)])

    p = "model.layers.{i}."
    yield ("embed",), get("model.embed_tokens.weight")
    yield ("layers", "attn_norm"), stack(p + "input_layernorm.weight")
    yield ("layers", "wq"), stack(p + "self_attn.q_proj.weight", True)
    yield ("layers", "wk"), stack(p + "self_attn.k_proj.weight", True)
    yield ("layers", "wv"), stack(p + "self_attn.v_proj.weight", True)
    yield ("layers", "wo"), stack(p + "self_attn.o_proj.weight", True)
    yield ("layers", "mlp_norm"), stack(p + "post_attention_layernorm.weight")
    yield ("layers", "w_gate"), stack(p + "mlp.gate_proj.weight", True)
    yield ("layers", "w_up"), stack(p + "mlp.up_proj.weight", True)
    yield ("layers", "w_down"), stack(p + "mlp.down_proj.weight", True)
    yield ("final_norm",), get("model.norm.weight")
    if not cfg.tie_word_embeddings:
        yield ("lm_head",), linear_t("lm_head.weight")


def check_quantize(quantize: str):
    if quantize not in QUANTIZATIONS:
        raise ValueError(f"quantization {quantize!r}: expected one of "
                         f"{'|'.join(q or '(none)' for q in QUANTIZATIONS)}")


def _quantizer(path: tuple, quantize: str):
    """The JAX package's _make_put rule: int4 on ("layers", ...) leaves
    only, int8 elsewhere; None for a leaf that stays dense."""
    if not quantize or path[-1] not in QUANT_NAMES:
        return None
    if quantize == "int4" and path[0] == "layers":
        return quantize_weight_int4
    return quantize_weight


def _quantize_slices(slices, n: int, fn) -> dict:
    """Quantize ``n`` float32 layer slices one at a time into a stacked
    {q, s} leaf (the slices' leaf shapes agree)."""
    out = None
    for i, w in enumerate(slices):
        leaf = fn(w)
        if out is None:
            out = {k: torch.empty((n, *v.shape), dtype=v.dtype, device=v.device)
                   for k, v in leaf.items()}
        for k, v in leaf.items():
            out[k][i].copy_(v)
    return out


def _cast_slices(slices, shape: tuple, dtype, device) -> torch.Tensor:
    """``shape[0]`` float32 layer slices cast one at a time into a stacked
    leaf of ``dtype``."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for v, w in zip(out, slices):
        v.copy_(w)
    return out


def _merged(slices, adapter, name: str):
    """The float32 layer slices of leaf ``name`` with the adapter's delta
    added where it has one (a new tensor: no slice is written in place)."""
    for i, w in enumerate(slices):
        d = adapter.layer_delta(name, i)
        yield w if d is None else w + torch.from_numpy(d).to(w.device)


def _place(t, path: tuple, device, dtype, quantize: str, adapter=None):
    """One host leaf -> its device leaf: {q, s} leaves as they are, matmul
    weights quantized when asked, the rest cast to ``dtype``. A stacked
    leaf that is quantized or that the adapter targets goes slice by
    slice, in float32 on the device (the adapter's delta added first)."""
    if isinstance(t, dict):
        return {k: v.to(device).contiguous() for k, v in t.items()}
    fn = _quantizer(path, quantize)
    merge = (adapter is not None and path[0] == "layers"
             and adapter.targets_leaf(path[-1], t.shape[0]))
    if fn is None and not merge:
        return t.to(device=device, dtype=dtype).contiguous()
    if path[0] == "layers":
        slices = (t[i].to(device=device, dtype=torch.float32)
                  for i in range(t.shape[0]))
        if merge:
            slices = _merged(slices, adapter, path[-1])
        if fn is None:
            return _cast_slices(slices, tuple(t.shape), dtype, device)
        return _quantize_slices(slices, t.shape[0], fn)
    return fn(t.to(device=device, dtype=torch.float32))


def _assemble(leaves, device, dtype, quantize: str = "", adapter=None) -> dict:
    params: dict = {"layers": {}}
    for path, t in leaves:
        node = params
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = _place(t, path, device, dtype, quantize, adapter)
    return params


def load_llama_params(model_dir: str, cfg, device="cuda", dtype=None,
                      quantize: str = "", lora_adapter: str = "",
                      lora_scale: float = 1.0) -> dict:
    """The checkpoint ``model_dir`` names (a GGUF file or a dir holding
    one, or HF llama/mistral safetensors) -> parameter dict on ``device``;
    a GPTQ / AWQ dir with no explicit ``quantize`` loads as int8, as in
    the JAX package (its memory intent survives the load).
    ``lora_adapter`` (a PEFT adapter dir) is merged as the leaves are
    placed (engine/lora.py)."""
    check_quantize(quantize)
    adapter = maybe_adapter(lora_adapter, lora_scale)
    path = find_gguf(model_dir)
    if path is not None:
        leaves = _gguf_leaves(path, cfg)
    else:
        qmeta = gptq.detect(model_dir)
        if qmeta is not None and not quantize:
            quantize = "int8"
        leaves = _host_leaves(open_checkpoint(model_dir), cfg, qmeta)
    return _assemble(leaves, resolve_device(device), dtype or cfg.dtype,
                     quantize, adapter)


def random_params(cfg, seed: int, device="cuda", dtype=None,
                  quantize: str = "", lora_adapter: str = "",
                  lora_scale: float = 1.0) -> dict:
    """Random weights from ``seed``, generated on ``device``: normal /
    sqrt(fan_in) per projection (the JAX package's init), ones for the
    norms. Each layer slice is drawn in float32 and cast into the stacked
    leaf, or quantized from that float32 draw (``quantize``), so peak
    extra memory is one layer's largest projection and a quantized 8B is
    never dense on the card; the draws do not depend on ``quantize``.
    ``lora_adapter`` is merged into each float32 slice it targets before
    the cast or quantization, as the JAX package merges it into its
    random leaves."""
    check_quantize(quantize)
    adapter = maybe_adapter(lora_adapter, lora_scale)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    hd = cfg.head_dim_
    L, D, F = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, KV, V = cfg.num_heads, cfg.num_kv_heads, cfg.vocab_size

    def draw(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).mul_(scale)

    def mk(path, shape, fan_in):
        scale = 1.0 / math.sqrt(fan_in)
        fn = _quantizer(path, quantize)
        if len(shape) == 3:
            slices = (draw(shape[1:], scale) for _ in range(shape[0]))
            if adapter is not None and adapter.targets_leaf(path[-1], shape[0]):
                slices = _merged(slices, adapter, path[-1])
            if fn is not None:
                return _quantize_slices(slices, shape[0], fn)
            return _cast_slices(slices, shape, dtype, dev)
        if fn is not None:
            return fn(draw(shape, scale))
        return draw(shape, scale).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def layer(name, shape, fan_in):
        return mk(("layers", name), (L, *shape), fan_in)

    params = {
        "embed": mk(("embed",), (V, D), D),
        "layers": {
            "attn_norm": ones((L, D)),
            "wq": layer("wq", (D, H * hd), D),
            "wk": layer("wk", (D, KV * hd), D),
            "wv": layer("wv", (D, KV * hd), D),
            "wo": layer("wo", (H * hd, D), H * hd),
            "mlp_norm": ones((L, D)),
            "w_gate": layer("w_gate", (D, F), D),
            "w_up": layer("w_up", (D, F), D),
            "w_down": layer("w_down", (F, D), F),
        },
        "final_norm": ones((D,)),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = mk(("lm_head",), (D, V), D)
    return params


def from_jax_params(np_params: dict, cfg, device="cuda", dtype=None) -> dict:
    """The JAX parameter pytree (numpy leaves, layers stacked on axis 0,
    projections [in, out]; localai_tpu/models/llama.py::init_params) ->
    the port's parameter dict. The layouts are identical, so this is a
    per-leaf copy and cast; {q, s} leaves (quantize_params) pass through,
    an int4 ``q`` (given as int8 values: the card's machine has no
    ml_dtypes) packed two per byte."""
    def conv(v):
        if not isinstance(v, dict):
            return torch.from_numpy(np.array(v, dtype=np.float32))
        q = torch.from_numpy(np.asarray(v["q"]).astype(np.int8))
        s = torch.from_numpy(np.array(v["s"], dtype=np.float32))
        return {"q": pack_int4(q) if s.dim() == q.dim() + 1 else q, "s": s}

    def leaves():
        for k, v in np_params.items():
            if k == "layers":
                for lk, lv in v.items():
                    yield ("layers", lk), conv(lv)
            else:
                yield (k,), conv(v)

    return _assemble(leaves(), resolve_device(device), dtype or cfg.dtype)
