"""The tensor-core route of W8 / W4 (ops/quant.py, csrc/quant_matmul.cu's
tensor_core kernel) on the CPU: its pure-Python plan, and a CPU model of
its arithmetic.

  * ``tc_plan``: the token tile holds M (past 256 rows it pads least); a
    split grid stays within one wave of the H100's 132 SMs at every
    Llama-3.1-8B projection shape, and a grid whose tiles alone fill a
    wave is not split; the splits cover K exactly in whole 64-row tiles;
    the plan is a function of the shapes and the SM count only;
  * what the bf16 route accepts: int4 at g 86 (llama-2's 11008 rows at tp
    8, a group that does not divide the 64-row tile), and it refuses K not
    a multiple of 8 and an int4 group under 16 instead of falling back;
  * the kernel's walk, modelled in float32 on the CPU: per split, per
    64-row tile, W4's scale rows staged as the kernel stages them (at most
    TC_MAX_GROUPS rows from the tile's first group, zeros past K), each
    weight widened to bf16(q * s) with its group looked up per row, f32
    sums, splits summed in order. It must equal the plain version's
    weights bit for bit and its product within bf16 tolerance.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import inspect

import numpy as np
import pytest
import torch

from localai_tpu_torch.ops import quant

SMS = 132                     # NVIDIA H100 SXM
SHAPES_8B = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024),
             "w_gate_up": (4096, 14336), "w_down": (14336, 4096),
             "lm_head": (4096, 128256)}
MS = (1, 8, 9, 15, 16, 17, 64, 65, 256, 476, 512)
TC_MAX_GROUPS = (quant.TC_TILE_K - 1) // quant.TC_MIN_GROUP + 2   # csrc kMaxGroups


def _grid(M, K, N, plan):
    tile, _chunk, n_split = plan
    return -(-N // quant.TC_TILE_N) * -(-M // tile) * n_split


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("shape", sorted(SHAPES_8B))
def test_tc_plan_fills_at_most_one_wave(shape, M):
    K, N = SHAPES_8B[shape]
    plan = quant.tc_plan(M, K, N, SMS)
    tile, chunk, n_split = plan
    wave = SMS * quant.tc_blocks_per_sm(tile)
    tiles = _grid(M, K, N, (tile, chunk, 1))
    assert chunk % quant.TC_TILE_K == 0
    assert (n_split - 1) * chunk < K <= n_split * chunk
    if n_split > 1:
        assert _grid(M, K, N, plan) <= wave
        assert chunk >= quant.TC_MIN_K_CHUNK
    if tiles >= wave:
        assert n_split == 1
    if M <= 16 and shape != "lm_head":
        # decode: every layer projection runs in one wave that reaches
        # (nearly) every SM
        assert 0.9 * SMS <= _grid(M, K, N, plan) <= wave


def test_tc_token_tile_covers_m():
    for M in range(1, 1100):
        t = quant.tc_token_tile(M)
        assert t in quant.TC_TOKEN_TILES
        if M <= 256:
            assert t >= M and all(u < M for u in quant.TC_TOKEN_TILES if u < t)
        else:
            assert -(-M // t) * t <= -(-M // 256) * 256
            assert -(-M // t) * t <= -(-M // 128) * 128
    assert [quant.tc_token_tile(m) for m in (8, 9, 16, 17, 65, 476, 512)] == \
        [8, 16, 16, 64, 128, 256, 256]


def test_tc_plan_depends_on_shapes_and_sm_count_only():
    assert list(inspect.signature(quant.tc_plan).parameters) == ["M", "K", "N", "sms"]
    for sms in (1, 8, 66, 132, 144):
        for M in MS:
            K, N = SHAPES_8B["wq_wo"]
            a, b = quant.tc_plan(M, K, N, sms), quant.tc_plan(M, K, N, sms)
            assert a == b
            if a[2] > 1:
                assert _grid(M, K, N, a) <= sms * quant.tc_blocks_per_sm(a[0])


def _leaf(K, N, bits, group, seed):
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (K, N)).astype(np.float32)) / K ** 0.5
    return (quant.quantize_weight_int4(w, group=group) if bits == 4
            else quant.quantize_weight(w))


def test_bf16_route_takes_g86_and_refuses_what_it_cannot():
    x = torch.zeros((8, 11008), dtype=torch.bfloat16)
    leaf = _leaf(11008, 64, 4, 86, 0)
    assert 11008 // leaf["s"].shape[0] == 86
    quant._check_args("quant_matmul_int4", x, leaf["q"], leaf["s"], True, 11008, False)
    # g 8, under TC_MIN_GROUP (quantize_weight_int4 never picks it; a
    # checkpoint could carry it)
    small = {"q": quant.pack_int4(torch.zeros((64, 32), dtype=torch.int8)),
             "s": torch.ones((8, 1, 32))}
    assert quant.is_grouped(small)
    with pytest.raises(ValueError, match="group 8 under 16"):
        quant._check_args("quant_matmul_int4", torch.zeros((2, 64), dtype=torch.bfloat16),
                          small["q"], small["s"], True, 64, False)
    # float32 x keeps the CUDA-core route, which takes g 8
    quant._check_args("quant_matmul_int4", torch.zeros((2, 64)), small["q"], small["s"],
                      True, 64, False)
    odd = _leaf(36, 32, 8, 128, 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        quant._check_args("quant_matmul_int8", torch.zeros((2, 36), dtype=torch.bfloat16),
                          odd["q"], odd["s"], False, 36, False)


def _tc_model(x, leaf, plan):
    """The tensor-core kernel's arithmetic on the CPU (module doc). Returns
    (y in bf16, the widened [K, N] weight it multiplied)."""
    tile, chunk, n_split = plan
    K, M = x.shape[1], x.shape[0]
    grouped = quant.is_grouped(leaf)
    q = quant.unpack_int4(leaf["q"]) if grouped else leaf["q"]
    N = q.shape[1]
    s = leaf["s"].reshape(-1, N)                   # [1, N] or [K/g, N]
    g = K // s.shape[0] if grouped else 0
    widened = torch.empty((K, N), dtype=torch.bfloat16)
    parts = []
    for split in range(n_split):
        k0, k_end = split * chunk, min(K, (split + 1) * chunk)
        acc = torch.zeros((M, N), dtype=torch.float32)
        for kt in range(k0, k_end, quant.TC_TILE_K):
            rows = torch.arange(kt, kt + quant.TC_TILE_K)
            live = rows < k_end
            if grouped:
                g0 = kt // g
                n_g = (min(kt + quant.TC_TILE_K, k_end) - 1) // g - g0 + 1
                assert n_g <= TC_MAX_GROUPS
                staged = torch.zeros((TC_MAX_GROUPS, N))
                staged[:n_g] = s[g0:g0 + n_g]
                rel = rows // g - g0
                assert int(rel.max()) < TC_MAX_GROUPS
                sc = staged[rel]
            else:
                sc = s.expand(quant.TC_TILE_K, N)
            qt = torch.zeros((quant.TC_TILE_K, N), dtype=torch.float32)
            qt[live] = q[rows[live]].to(torch.float32)
            wt = (qt * sc).to(torch.bfloat16)
            widened[rows[live]] = wt[live]
            xt = torch.zeros((M, quant.TC_TILE_K), dtype=torch.float32)
            xt[:, live] = x[:, rows[live]].to(torch.float32)
            acc += xt @ wt.to(torch.float32)
        parts.append(acc)
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y.to(torch.bfloat16), widened


@pytest.mark.parametrize("bits,K,N,group", [
    (8, 1024, 256, 128), (4, 1024, 256, 128), (4, 11008, 128, 86),
    (8, 256, 2064, 64), (4, 256, 2064, 64), (4, 1000, 48, 40)])
@pytest.mark.parametrize("M", [1, 8, 17])
def test_tc_model_matches_plain(bits, K, N, group, M):
    leaf = _leaf(K, N, bits, group, K + N + M)
    x = torch.from_numpy(np.random.default_rng(M).standard_normal(
        (M, K)).astype(np.float32)).to(torch.bfloat16)
    plan = quant.tc_plan(M, K, N, SMS)
    y, widened = _tc_model(x, leaf, plan)
    assert torch.equal(widened, quant.mat(leaf, torch.bfloat16))
    ref = quant.quant_matmul_plain(x, leaf)
    assert ref.dtype == torch.bfloat16 and ref.shape == (M, N)
    torch.testing.assert_close(y.float(), ref.float(), atol=2e-2, rtol=2e-2)
    # the CPU route of the wrapper is the plain version
    assert torch.equal(quant.quant_matmul(x, leaf), ref)
