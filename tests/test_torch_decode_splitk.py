"""A CPU model of the split-K (flash-decoding) arithmetic of the decode
kernels K1, K3, K4 and K5 (ops/kernels/csrc/decode_attention.cuh),
against the JAX package's localai_tpu/ops/attention.py::
decode_attention_append and the port's plain version.

The model cuts each slot's committed rows [0, length) into pieces of the
kernels' own split size (ops/paged_attention.py::SPLIT_ROWS, or the other
sizes the card may pick), computes each piece's running max m, sum l and
unnormalised acc (int8 rows: key scale on the score, value scale on the
probability, not on l), merges the pieces with the log-sum-exp rescale and
folds in the current token's own key/value as the combine kernel does. A
slot of length 0 has no piece: its output is the current token's v.

Inputs are made from a seed with numpy and fed to both packages in
float32. Tolerance: 2e-4 absolute / 2e-3 relative (ROADMAP's parity
contract for float32 attention summed in another order).
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.ops.attention import decode_attention_append as jax_decode
from localai_tpu_torch.ops.attention import decode_attention_append
from localai_tpu_torch.ops.paged_attention import (
    SPLIT_ROWS, decode_workspace, n_splits)

ATOL, RTOL = 2e-4, 2e-3
S, KV = 8, 2


def splitk_decode(q, new_k, new_v, cache_k, cache_v, lengths, q_per_kv: int,
                  split_rows: int = SPLIT_ROWS):
    """q, new_k, new_v: [S, {H|KV|KV}, hd]; cache_k/v: [S, C, KV, hd] rows
    (float, or int8 {"q","s"} with [S, C, KV] scales) holding [0,
    lengths[s]). The split kernel's partials, then the combine, in f32."""
    (ck, sk), (cv, sv) = (
        (c["q"], c["s"]) if isinstance(c, dict) else (c, None)
        for c in (cache_k, cache_v))
    Sn, H, hd = q.shape
    C, kv = ck.shape[1], ck.shape[2]
    qg = q.float().reshape(Sn, kv, q_per_kv, hd) * (1.0 / math.sqrt(hd))
    out = torch.empty(Sn, kv, q_per_kv, hd)
    for s in range(Sn):
        length = min(max(int(lengths[s]), 0), C)
        parts = []
        for k in range(-(-length // split_rows)):           # the working splits
            r0, r1 = k * split_rows, min(length, (k + 1) * split_rows)
            sc = torch.einsum("kgd,nkd->kgn", qg[s], ck[s, r0:r1].float())
            if sk is not None:
                sc = sc * sk[s, r0:r1].T[:, None, :]
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            ll = p.sum(-1)
            if sv is not None:
                p = p * sv[s, r0:r1].T[:, None, :]
            parts.append((m, ll, torch.einsum("kgn,nkd->kgd", p,
                                              cv[s, r0:r1].float())))
        self_sc = torch.einsum("kgd,kd->kg", qg[s], new_k[s].float())
        mx = self_sc
        for m, _l, _a in parts:
            mx = torch.maximum(mx, m)
        w = torch.exp(self_sc - mx)
        den, acc = w, w[..., None] * new_v[s].float()[:, None, :]
        for m, ll, a in parts:
            w = torch.exp(m - mx)
            den = den + ll * w
            acc = acc + w[..., None] * a
        out[s] = acc / den[..., None]
    return out.reshape(Sn, H, hd).to(q.dtype)


def _case(kind, G, hd, split_rows, seed):
    """Seeded numpy inputs: C = 2 * split_rows + 40 rows per slot (the last
    split partial), lengths 0, 1 and around the split edges up to C - 1 and
    C; float rows, or int8 rows with positive f32 scales."""
    rng = np.random.default_rng(seed)
    C = 2 * split_rows + 40
    lengths = np.array([0, 1, split_rows - 1, split_rows, split_rows + 1,
                        2 * split_rows, C - 1, C], np.int32)
    q = rng.normal(size=(S, KV * G, hd)).astype(np.float32)
    nk = rng.normal(size=(S, KV, hd)).astype(np.float32)
    nv = rng.normal(size=(S, KV, hd)).astype(np.float32)
    if kind == "float":
        ck = rng.normal(size=(S, C, KV, hd)).astype(np.float32)
        cv = rng.normal(size=(S, C, KV, hd)).astype(np.float32)
    else:
        def rows():
            return {"q": rng.integers(-127, 128, size=(S, C, KV, hd)).astype(np.int8),
                    "s": rng.uniform(0.004, 0.02, size=(S, C, KV)).astype(np.float32)}
        ck, cv = rows(), rows()
    return q, nk, nv, ck, cv, lengths


def _torch(a):
    if isinstance(a, dict):
        return {k: torch.from_numpy(v) for k, v in a.items()}
    return torch.from_numpy(a)


def _jax(a):
    if isinstance(a, dict):
        return {k: jnp.asarray(v) for k, v in a.items()}
    return jnp.asarray(a)


@pytest.mark.parametrize("split_rows", sorted({SPLIT_ROWS, 64, 128, 256}))
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("kind", ["float", "int8"])
def test_splitk_model_matches_jax_and_plain(kind, G, hd, split_rows):
    args = _case(kind, G, hd, split_rows, seed=G * 1000 + hd + split_rows)
    got = splitk_decode(*map(_torch, args), G, split_rows=split_rows)
    ref = np.asarray(jax_decode(*map(_jax, args), G))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    plain = decode_attention_append(*map(_torch, args), G)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=RTOL)
    # an idle slot's output is the current token's v, exactly
    nv = args[2]
    np.testing.assert_array_equal(got[0].reshape(KV, G, hd).numpy(),
                                  np.repeat(nv[0][:, None, :], G, axis=1))


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_splitk_merge_equals_one_split(kind):
    """Merging the pieces gives the one-piece softmax up to f32 rounding:
    the split size changes the summation order only."""
    args = tuple(map(_torch, _case(kind, 4, 64, SPLIT_ROWS, seed=7)))
    C = args[3]["q"].shape[1] if kind == "int8" else args[3].shape[1]
    whole = splitk_decode(*args, 4, split_rows=C)
    torch.testing.assert_close(splitk_decode(*args, 4), whole, atol=1e-5,
                               rtol=1e-5)


def test_split_rule_and_workspace_come_from_shapes():
    """SPLIT_ROWS is a whole number of the kernels' 32-row tiles and of the
    64-row serving page; n_split and the workspace follow from shapes
    alone (the launchers compute the same n_split)."""
    assert SPLIT_ROWS > 0 and SPLIT_ROWS % 32 == 0 and SPLIT_ROWS % 64 == 0
    assert n_splits(4096) == -(-4096 // SPLIT_ROWS)
    assert [n_splits(r, 64) for r in (1, 63, 64, 65, 4096)] == [1, 1, 1, 2, 64]
    q = torch.zeros(8, 8 * 4, 128)
    ws = decode_workspace(q, 8, 4, 4096)
    assert ws.dtype == torch.float32 and ws.device == q.device
    assert ws.numel() == 8 * 8 * n_splits(4096) * 4 * (128 + 2)
