"""Prefix reuse with int8 KV pages and with the contiguous layout, on the
CPU, over the tiny f32 checkpoint: the request script of
tests/test_torch_prefix_cache.py (a conversation across all three tiers,
unrelated traffic, a shared prefix, a divergence) on the port with
``kv_prefix_cache`` on and off and on the JAX Engine cold and with reuse.

  * int8 KV (``kv_cache_dtype: int8``): greedy tokens byte-identical
    across the three, ``reused_prompt_tokens`` per request equal to the
    JAX Engine's; tier-2 clones and tier-3 splices carry the scales.
  * contiguous: tier 1 only (the rows stay in the slot's block, as in the
    JAX engine); the same byte gate, and the reused rows equal the JAX
    Engine's, which also reuses only the slot's own rows there. The
    shared-prefix request is submitted once b has finished, on both
    engines, so it always finds b's rows in b's free slot (submitted while
    b decodes, a loaded host could let b finish first on one engine only);
    a request sharing the prefix of one admitted in the same pass, which
    still decodes, reuses nothing.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_prefix_cache import (jax_engine, port_engine,  # noqa: F401
                                           run_script, tiny)

LAYOUTS = {
    "int8": ({"cache_dtype": torch.int8}, {"cache_dtype": jnp.int8}),
    "contig": ({"kv_layout": "contiguous"},
               {"cache_dtype": jnp.float32, "layout": "contiguous"}),
}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def scripted(request, tiny):  # noqa: F811
    tk, jk = LAYOUTS[request.param]
    out = {"layout": request.param}
    for name, make in (("port", lambda: port_engine(tiny, True, **tk)),
                       ("port_cold", lambda: port_engine(tiny, False, **tk)),
                       ("jax_cold", lambda: jax_engine(tiny, False, **jk)),
                       ("jax", lambda: jax_engine(tiny, True, **jk))):
        e = make()
        try:
            out[name] = run_script(e, b_first=request.param == "contig")
            out[name + "_metrics"] = e.metrics()
        finally:
            e.shutdown()
    return out


def test_greedy_tokens_identical_with_and_without_reuse_and_jax_cold(scripted):
    port = [ids for ids, _r in scripted["port"]]
    assert port == [ids for ids, _r in scripted["port_cold"]]
    assert port == [ids for ids, _r in scripted["jax_cold"]]


def test_reused_prompt_tokens_match_jax(scripted):
    got = [r for _ids, r in scripted["port"]]
    assert got == [r for _ids, r in scripted["jax"]]
    assert [r for _i, r in scripted["port_cold"]] == [0] * len(got)
    m = scripted["port_metrics"]
    assert m["prompt_tokens_reused"] == sum(got)
    if scripted["layout"] == "int8":
        # the paged script's tiers: 1, 3, 2, 1, 3
        assert [got[i] for i in (2, 7, 9, 10, 11)] == [44, 48, 40, 20, 63]
        assert m["prefix_cache"]["hits"] == 2
        assert m["prefix_cache"]["cow_clones"] >= 3
    else:
        # tier 1 only: turn 2, the shared prefix (in b's slot, b done) and
        # the divergence reuse their slot's rows; turn 3 (its slot
        # overwritten) and the shared prefix of a request still decoding
        # reuse none
        assert got[2] == 44 and got[10] == 20
        assert got[7] == 0 and got[9] == 40 and got[13] == 0
        assert "prefix_cache" not in m
