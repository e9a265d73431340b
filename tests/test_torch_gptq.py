"""The PyTorch port's GPTQ / AWQ ingestion (localai_tpu_torch/engine/
gptq.py, a numpy copy) against the JAX package's, on the CPU.

Synthetic checkpoints come from the test-only packers of
tests/test_gptq.py (the on-disk conventions of engine/gptq.py's doc).
What is pinned: ``dequant_linear`` equals the JAX one exactly on GPTQ
(2/4/8 bits, sequential groups and an act-order ``g_idx``) and AWQ
tensors; ``detect`` reads the same metadata; a synthetic GPTQ checkpoint
dir loads through the port's ``load_llama_params`` to the same int8
{q, s} (no explicit quantization: int8, as in the JAX package) and int4
{q, s} as the JAX loader's, and serves a request.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import gptq as jgptq
from localai_tpu.engine import weights as jweights
from localai_tpu_torch.engine import gptq as tgptq
from localai_tpu_torch.engine import weights as tweights
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import quant as tquant
from tests.test_gptq import _write_gptq_checkpoint, pack_awq, pack_gptq


def _getter(tensors):
    return lambda name: tensors[name]


@pytest.mark.parametrize("bits,desc_act", [(2, False), (4, False), (8, False),
                                           (4, True)])
def test_gptq_dequant_matches_jax(bits, desc_act):
    rng = np.random.default_rng(bits)
    W = rng.standard_normal((32, 48)).astype(np.float32)        # [out, in]
    g_idx = rng.integers(0, 4, size=48) if desc_act else None
    t, expected = pack_gptq(W, bits=bits, group_size=8, g_idx=g_idx)
    get = _getter({f"m.{k}": v for k, v in t.items()})
    jm = jgptq.QuantMeta("gptq", bits, 8, desc_act=desc_act)
    tm = tgptq.QuantMeta("gptq", bits, 8, desc_act=desc_act)
    got = tgptq.dequant_linear(get, "m", tm)
    assert got.shape == (48, 32) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jgptq.dequant_linear(get, "m", jm))
    np.testing.assert_allclose(got, expected, rtol=2e-3, atol=1e-4)


def test_awq_dequant_matches_jax():
    rng = np.random.default_rng(9)
    W = rng.standard_normal((16, 32)).astype(np.float32)
    t, expected = pack_awq(W, bits=4, group_size=16)
    get = _getter({f"m.{k}": v for k, v in t.items()})
    got = tgptq.dequant_linear(get, "m", tgptq.QuantMeta("awq", 4, 16))
    np.testing.assert_array_equal(
        got, jgptq.dequant_linear(get, "m", jgptq.QuantMeta("awq", 4, 16)))
    np.testing.assert_allclose(got, expected, rtol=2e-3, atol=1e-4)


def test_detect_matches_jax(tmp_path):
    d = str(tmp_path)
    assert tgptq.detect(d) is None
    for cfg, qc in (({"model_type": "llama"}, None),
                    ({"quantization_config": {"quant_method": "awq", "bits": 4,
                                              "group_size": 64}}, None),
                    ({"model_type": "llama"},
                     {"bits": 8, "group_size": 32, "desc_act": True})):
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(cfg, f)
        if qc is not None:
            with open(os.path.join(d, "quantize_config.json"), "w") as f:
                json.dump(qc, f)
        j, t = jgptq.detect(d), tgptq.detect(d)
        assert repr(t) == repr(j)
    with open(os.path.join(d, "quantize_config.json"), "w") as f:
        json.dump({"quant_method": "bitsandbytes", "bits": 4}, f)
    with pytest.raises(ValueError, match="bitsandbytes"):
        tgptq.detect(d)
    with pytest.raises(ValueError, match="bits=3"):
        tgptq.QuantMeta("gptq", 3, 128)


@pytest.mark.parametrize("quantize", ["", "int4"])
def test_gptq_checkpoint_loads_like_jax(tmp_path, quantize):
    """No quantization: the GPTQ dir loads as int8, leaf for leaf the
    JAX loader's {q, s}; int4 re-quantizes the layer matmuls to groups.
    Dense leaves (norms) stay dense."""
    ckpt = str(tmp_path / "gptq-tiny")
    jcfg, _expected = _write_gptq_checkpoint(ckpt)
    with open(os.path.join(ckpt, "config.json")) as f:
        tcfg = tllama.LlamaConfig.from_hf_config(json.load(f), dtype=torch.float32)
    jp = jweights.load_llama_params(ckpt, jcfg, dtype=jnp.float32,
                                    quantize=quantize)
    tp = tweights.load_llama_params(ckpt, tcfg, device="cpu", quantize=quantize)
    for path in (("layers", "wq"), ("layers", "wv"), ("layers", "w_down"),
                 ("embed",), ("lm_head",)):
        j, t = jp, tp
        for k in path:
            j, t = j[k], t[k]
        assert isinstance(t, dict), path
        assert tquant.is_grouped(t) == (quantize == "int4" and path[0] == "layers")
        q = tquant.unpack_int4(t["q"]) if tquant.is_grouped(t) else t["q"]
        np.testing.assert_array_equal(q.numpy(), np.asarray(j["q"]).astype(np.int8),
                                      err_msg=str(path))
        np.testing.assert_allclose(t["s"].numpy(), np.asarray(j["s"]), rtol=1e-6,
                                   err_msg=str(path))
    assert not isinstance(tp["layers"]["attn_norm"], dict)


def test_gptq_checkpoint_serves_through_load_model(tmp_path):
    from localai_tpu_torch.backend.runner import load_model
    from localai_tpu_torch.engine import engine as teng
    from localai_tpu_torch.engine import sampling as tsamp

    ckpt = str(tmp_path / "gptq-serve")
    _write_gptq_checkpoint(ckpt)
    lm = load_model(ckpt, "g", num_slots=2, context_size=64, dtype="float32",
                    device="cpu", kv_page_size=16)
    try:
        assert lm.quantization == "int8"
        assert lm.engine.params["layers"]["wq"]["q"].dtype == torch.int8
        _text, evs = lm.engine.generate_text(teng.GenRequest(
            prompt_ids=list(range(2, 20)), max_new_tokens=3, ignore_eos=True,
            params=tsamp.SamplingParamsHost(temperature=0.0)))
        assert evs[-1].completion_tokens == 3 and not evs[-1].error
    finally:
        lm.engine.shutdown()
