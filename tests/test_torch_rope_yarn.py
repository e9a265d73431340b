"""yarn rope scaling in the port (localai_tpu_torch/ops/rope.py: the yarn
branch of ``_scaled_inv_freq`` and the attention temperature ``mscale``
on sin and cos) against the JAX package's localai_tpu/ops/rope.py, on
the CPU:

  * ``_scaled_inv_freq`` equal (float64, bit for bit) and sin / cos within
    the ``_close`` tolerances of tests/test_torch_parity.py, at factor 1
    (no scaling) and 4, head_dim 64 and 128, positions past the original
    context;
  * a tiny f32 model with yarn (factor 4 over an original context of 32,
    so the ramp interpolates the low frequencies at these widths), from
    config.json (``LlamaConfig.from_hf_config``, equal fields) and from
    GGUF metadata: prefill logits within the tolerances, and greedy tokens
    through both engines byte-identical, prompts reaching past the
    original context.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import engine as jeng
from localai_tpu.engine import gguf as jgguf
from localai_tpu.engine import weights as jweights
from localai_tpu.models import llama as jllama
from localai_tpu.ops import rope as jrope
from localai_tpu_torch.backend import runner
from localai_tpu_torch.engine import engine as teng
from localai_tpu_torch.engine import weights as tweights
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import rope as trope
from tests.test_torch_engine import _Tok
from tests.test_torch_gguf import (ENGINE, _drain, _fields, _submit,
                                   port_knobs, write_model_gguf)
from tests.test_torch_parity import _close

YARN = {"type": "yarn", "factor": 4.0, "original_max_position_embeddings": 32}
HF = {"vocab_size": 258, "hidden_size": 64, "intermediate_size": 128,
      "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
      "rms_norm_eps": 1e-5, "max_position_embeddings": 128, "rope_theta": 10000.0,
      "rope_scaling": YARN}


@pytest.mark.parametrize("hd", (64, 128))
@pytest.mark.parametrize("factor", (1.0, 4.0))
def test_yarn_inv_freq_and_sin_cos_equal_jax(factor, hd):
    kw = dict(hidden_size=hd * 4, num_heads=4, head_dim=hd, rope_theta=500000.0,
              rope_scaling_type="yarn", rope_scaling_factor=factor,
              rope_original_max_position=8192)
    jc, tc = jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)
    np.testing.assert_array_equal(trope._scaled_inv_freq(tc),
                                  jrope._scaled_inv_freq(jc))
    if factor > 1.0:
        assert not np.array_equal(trope._scaled_inv_freq(tc),
                                  trope._base_inv_freq(tc))
    assert trope.yarn_mscale(tc) == (1.0 if factor == 1.0
                                     else 0.1 * np.log(factor) + 1.0)
    pos = np.arange(0, 40000, 97, dtype=np.int32)[None]
    js, jcos = jrope.rope_frequencies(jc, jnp.asarray(pos))
    ts, tcos = trope.rope_frequencies(tc, torch.from_numpy(pos))
    _close(ts.numpy(), np.asarray(js), what="sin")
    _close(tcos.numpy(), np.asarray(jcos), what="cos")


def _models(seed: int = 0):
    jcfg = jllama.LlamaConfig.from_hf_config(HF, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(HF, dtype=torch.float32)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = tweights.from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def test_yarn_model_logits_equal_jax():
    jcfg, jp, tcfg, tp = _models()
    assert _fields(tcfg) == _fields(jcfg)
    assert tcfg.rope_scaling_type == "yarn" and tcfg.rope_original_max_position == 32
    rng = np.random.default_rng(1)
    N = 80                                  # past the original context of 32
    ids = rng.integers(2, 258, size=N).astype(np.int32)
    ck, cv = jllama.init_cache(jcfg, 1, 128, np.float32)
    want, _, _ = jllama.prefill(jp, jcfg, ids[None], np.array([N], np.int32),
                                ck, cv, np.array([0], np.int32),
                                np.array([0], np.int32))
    tck, tcv = tllama.init_cache(tcfg, 1, 128, 16, device="cpu")
    t = lambda a, dt=torch.int32: torch.tensor(a, dtype=dt)  # noqa: E731
    got = tllama.ragged_prefill(tp, tcfg, t(ids.tolist(), torch.int64),
                                t(list(range(N))), t([0]), t([0]), t([0]), t([N]),
                                t([0] * N), tck, tcv, continued=False)
    _close(got[0].numpy(), np.asarray(want)[0], what="yarn logits")
    # without the yarn scaling the logits move
    plain = dataclasses.replace(tcfg, rope_scaling_type="none")
    tck, tcv = tllama.init_cache(plain, 1, 128, 16, device="cpu")
    other = tllama.ragged_prefill(tp, plain, t(ids.tolist(), torch.int64),
                                  t(list(range(N))), t([0]), t([0]), t([0]),
                                  t([N]), t([0] * N), tck, tcv, continued=False)
    assert np.abs(other[0].numpy() - got[0].numpy()).max() > 1e-3


@pytest.mark.parametrize("source", ("config.json", "gguf"))
def test_yarn_greedy_tokens_equal_the_jax_engine(tmp_path, source):
    # prompts from seed 4: seed 3's first prompt reaches a near-tie at its
    # seventh token (a top-2 logit gap of 7e-4), where the JAX Engine's
    # paged decode picks the runner-up and JAX's own contiguous decode_step,
    # like the port's (they agree to 2e-6), picks the top
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, 258, size=n).tolist() for n in (20, 45, 70)]
    if source == "config.json":
        jcfg, jp, tcfg, tp = _models()
        je = jeng.Engine(jcfg, jp, _Tok(), jeng.EngineConfig(**ENGINE, draft="0"))
        e = teng.Engine(tcfg, tp, _Tok(), teng.EngineConfig(**ENGINE, draft="0"),
                        device="cpu")
    else:
        path = str(tmp_path / "yarn.gguf")
        write_model_gguf(path, dict(vocab_size=258, hidden_size=64,
                                    intermediate_size=128, num_layers=2,
                                    num_heads=4, num_kv_heads=2,
                                    max_position_embeddings=128),
                         0, scaling="yarn", factor=4.0, orig=32)
        jcfg = dataclasses.replace(jgguf.config_from_gguf(path), dtype=jnp.float32)
        je = jeng.Engine(jcfg, jweights.load_llama_params(path, jcfg,
                                                          dtype=jnp.float32),
                         _Tok(), jeng.EngineConfig(**ENGINE, draft="0"))
        lm = runner.load_model(path, "yarn", **port_knobs(draft="0"))
        e = lm.engine
        assert lm.cfg.rope_scaling_type == "yarn"
        assert _fields(lm.cfg) == _fields(jcfg)
    je.start()
    try:
        want = [_drain(_submit(je, p, 24)) for p in prompts]
    finally:
        je.shutdown()
    if source == "config.json":
        e.start()
    try:
        got = [_drain(_submit(e, p, 24)) for p in prompts]
    finally:
        e.shutdown()
    assert got == want
