"""LoRA adapters merged into the weights at load (a copy of
localai_tpu/engine/lora.py; the adapter's safetensors read with the
port's numpy reader, engine/weights.py::SafetensorsFile).

The low-rank update ``W += scale * (B @ A)`` is merged into each stacked
leaf as the checkpoint streams onto the device, before any cast or
re-quantization: no extra memory on the card and no extra products per
step. It applies to safetensors, GGUF and random weights alike.

Adapter layout: HF PEFT, ``adapter_config.json`` (r, lora_alpha,
target_modules) + ``adapter_model.safetensors`` with tensors named
``...layers.{i}.self_attn.q_proj.lora_A.weight`` ([r, in]) and
``....lora_B.weight`` ([out, r]). The effective scale is
``lora_scale * lora_alpha / r`` (PEFT semantics; lora_scale is the
user's knob, 0 = 1.0).
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np

# the port's stacked-leaf name -> HF module suffix
_LEAF_TO_MODULE = {
    "wq": "self_attn.q_proj",
    "wk": "self_attn.k_proj",
    "wv": "self_attn.v_proj",
    "wo": "self_attn.o_proj",
    "w_gate": "mlp.gate_proj",
    "w_up": "mlp.up_proj",
    "w_down": "mlp.down_proj",
}

_NAME_RE = re.compile(
    r"layers\.(\d+)\.(self_attn\.[qkvo]_proj|mlp\.(?:gate|up|down)_proj)"
    r"\.lora_(A|B)\.weight$")


class LoraAdapter:
    """Parsed adapter: per-(layer, module) A/B matrices + effective scale."""

    def __init__(self, path: str, scale: float = 1.0):
        from localai_tpu_torch.engine.weights import SafetensorsFile

        cfg_path = os.path.join(path, "adapter_config.json")
        cfg = {}
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
        r = float(cfg.get("r", 8))
        alpha = float(cfg.get("lora_alpha", r))
        self.scale = (scale or 1.0) * alpha / max(r, 1.0)

        st = None
        for name in ("adapter_model.safetensors", "adapter.safetensors"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                st = p
                break
        if st is None:
            raise FileNotFoundError(
                f"{path}: no adapter_model.safetensors found")
        # (module, layer) -> {"A": [r, in], "B": [out, r]}
        self.mats: dict = {}
        f = SafetensorsFile(st)
        for name in f.keys():
            m = _NAME_RE.search(name)
            if not m:
                continue
            li, module, ab = int(m.group(1)), m.group(2), m.group(3)
            self.mats.setdefault((module, li), {})[ab] = \
                f.get(name).float().numpy()

    def targets_leaf(self, leaf_name: str, num_layers: int) -> bool:
        module = _LEAF_TO_MODULE.get(leaf_name)
        if module is None:
            return False
        return any((module, i) in self.mats for i in range(num_layers))

    def layer_delta(self, leaf_name: str, i: int) -> Optional[np.ndarray]:
        """``scale * (B @ A).T`` for layer ``i`` of the leaf, float32 [in,
        out] (the addend of the JAX ``apply_to_leaf``, computed as it
        computes it; engine/weights.py adds it to each float32 layer
        slice), or None when the adapter has no pair there."""
        ab = self.mats.get((_LEAF_TO_MODULE[leaf_name], i))
        if not ab or "A" not in ab or "B" not in ab:
            return None
        A = np.asarray(ab["A"], np.float32)     # [r, in]
        B = np.asarray(ab["B"], np.float32)     # [out, r]
        # the leaf is [in, out] (the transposed HF weight): delta = (B@A).T
        return (B @ A).T * self.scale


def maybe_adapter(path: str, scale: float = 1.0) -> Optional[LoraAdapter]:
    if not path:
        return None
    return LoraAdapter(path, scale)
