"""Rotary position embeddings (counterpart of localai_tpu/ops/rope.py).

HF "rotate_half" convention, so HF checkpoints load unmodified. The
scaling families are the JAX package's: none, linear, llama3 (Llama-3.1)
and yarn, whose attention temperature (``mscale``) scales sin and cos; the
self-extend delta rotation comes with the long-context slice.

The inverse-frequency table is built once per (rope parameters, device)
and kept on the device (``inv_freq``): building it from numpy is a
host-to-device copy, which a captured CUDA graph cannot hold, so the
decode step only looks it up.
"""

from __future__ import annotations

import numpy as np
import torch


def _base_inv_freq(cfg) -> np.ndarray:
    hd = cfg.head_dim_
    return 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))


def _scaled_inv_freq(cfg) -> np.ndarray:
    """Inverse frequencies with the configured scaling applied (float64)."""
    inv_freq = _base_inv_freq(cfg)
    t = cfg.rope_scaling_type
    if t in ("none", "default") or cfg.rope_scaling_factor == 1.0 and t != "llama3":
        return inv_freq
    if t == "linear":
        return inv_freq / cfg.rope_scaling_factor
    if t == "llama3":
        # Llama-3.1 frequency-dependent NTK scaling
        low_wl = cfg.rope_original_max_position / cfg.rope_low_freq_factor
        high_wl = cfg.rope_original_max_position / cfg.rope_high_freq_factor
        wavelen = 2 * np.pi / inv_freq
        scaled = inv_freq / cfg.rope_scaling_factor
        smooth = (cfg.rope_original_max_position / wavelen - cfg.rope_low_freq_factor) / (
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor
        )
        smooth = np.clip(smooth, 0.0, 1.0)
        mid = (1 - smooth) * scaled + smooth * inv_freq
        return np.where(wavelen < high_wl, inv_freq,
                        np.where(wavelen > low_wl, scaled, mid))
    if t == "yarn":
        # YaRN: interpolate low-freq dims, keep high-freq dims (beta ramp)
        hd = cfg.head_dim_
        factor = cfg.rope_scaling_factor
        beta_fast, beta_slow = 32.0, 1.0
        orig = cfg.rope_original_max_position

        def correction_dim(num_rot):
            return hd * np.log(orig / (num_rot * 2 * np.pi)) / (2 * np.log(cfg.rope_theta))

        low = np.floor(correction_dim(beta_fast))
        high = np.ceil(correction_dim(beta_slow))
        low, high = max(low, 0), min(high, hd - 1)
        ramp = np.clip((np.arange(hd // 2, dtype=np.float64) - low) / max(high - low, 1e-3), 0, 1)
        mask = 1 - ramp
        return inv_freq / factor * (1 - mask) + inv_freq * mask
    raise ValueError(f"unknown rope scaling type: {t}")


def yarn_mscale(cfg) -> float:
    """yarn's attention temperature (1.0 for every other family): sin and
    cos are scaled by it, so q . k carries its square."""
    if cfg.rope_scaling_type == "yarn" and cfg.rope_scaling_factor > 1.0:
        return float(0.1 * np.log(cfg.rope_scaling_factor) + 1.0)
    return 1.0


_INV_FREQ: dict = {}


def inv_freq(cfg, device) -> torch.Tensor:
    """The float32 inverse frequencies [head_dim / 2] of ``cfg`` on
    ``device``, built at the first call for these rope parameters and
    device and shared afterwards (read-only)."""
    key = (cfg.head_dim_, cfg.rope_theta, cfg.rope_scaling_type,
           cfg.rope_scaling_factor, cfg.rope_low_freq_factor,
           cfg.rope_high_freq_factor, cfg.rope_original_max_position,
           str(torch.device(device)))
    table = _INV_FREQ.get(key)
    if table is None:
        table = _INV_FREQ[key] = torch.tensor(
            _scaled_inv_freq(cfg), dtype=torch.float32, device=device)
    return table


def rope_frequencies(cfg, positions: torch.Tensor):
    """positions [B, T] int -> (sin, cos) each [B, T, head_dim] float32,
    times yarn's ``mscale`` (a constant, so a captured graph holds it)."""
    freqs = (positions.to(torch.float32)[..., None]
             * inv_freq(cfg, positions.device))                 # [B, T, hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    mscale = yarn_mscale(cfg)
    if mscale == 1.0:
        return torch.sin(emb), torch.cos(emb)
    return torch.sin(emb) * mscale, torch.cos(emb) * mscale


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, hd]; sin/cos [B, T, hd]. Rotation in float32."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    half = xf.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    out = xf * cos[:, :, None, :] + rotated * sin[:, :, None, :]
    return out.to(dtype)
