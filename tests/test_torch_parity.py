"""Torch-parity oracles for the flagship model families (VERDICT r3 #3).

Each test builds a tiny-random HF checkpoint with the installed torch
``transformers`` (the numerical oracle), saves it in the real published
layout, loads it through this framework's own config+weight loaders, and
compares outputs at fp32 — end-to-end through the actual serving entry
points (prefill/decode_step/encode), not reimplementations.

Reference backends being mirrored:
  llama   -> backend/cpp/llama/grpc-server.cpp (the main LLM engine)
  whisper -> backend/go/transcribe/whisper (AudioTranscription)
  bert    -> backend/go/llm/bert (embeddings), backend/python/rerankers
  CLIP    -> grpc-server.cpp LLaVA vision tower (:1157-1180)

Tolerances: fp32 compute on both sides; 2e-4 absolute / 2e-3 relative
catches real math divergences (RoPE layout, GQA grouping, gelu variant,
mel filterbank) while riding out accumulation-order noise.
"""

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import os

import numpy as np
import pytest

# oracle parity is thorough but slow; keep tier-1 (-m 'not slow') fast
pytestmark = pytest.mark.slow

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from localai_tpu.engine import weights  # noqa: E402
from localai_tpu.models import bert as jbert  # noqa: E402
from localai_tpu.models import llama as jllama  # noqa: E402
from localai_tpu.models import vision as jvision  # noqa: E402
from localai_tpu.models import whisper as jwhisper  # noqa: E402


def _close(ours, ref, atol=2e-4, rtol=2e-3, what=""):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol, err_msg=what)


# ---------------------------------------------------------------- llama

def _tiny_torch_llama(tmp, rope_scaling=None, theta=10000.0):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    tcfg = LlamaConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=theta,
        tie_word_embeddings=False, rope_scaling=rope_scaling,
        attention_bias=False,
    )
    model = LlamaForCausalLM(tcfg).eval()
    d = os.path.join(tmp, "llama")
    model.save_pretrained(d, safe_serialization=True)
    return d, model


def _load_ours_llama(d):
    cfg = jllama.LlamaConfig.from_json(os.path.join(d, "config.json"),
                                       dtype=jnp.float32)
    params = weights.load_llama_params(d, cfg, dtype=jnp.float32)
    return cfg, params


def _llama_parity(d, model, n_prompt=9, n_decode=6):
    cfg, params = _load_ours_llama(d)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 96, size=n_prompt).astype(np.int32)

    with torch.no_grad():
        ref = model(torch.tensor(ids[None].astype(np.int64))).logits[0].numpy()

    ck, cv = jllama.init_cache(cfg, 1, 64, jnp.float32)
    ours, ck, cv = jllama.prefill(
        params, cfg, ids[None], np.array([n_prompt], np.int32), ck, cv,
        np.array([0], np.int32), np.array([0], np.int32),
        return_all_logits=True)
    _close(ours[0, :n_prompt], ref, what="prefill logits (all positions)")

    # greedy decode continuation through the cached decode_step path
    cur = np.array([int(np.argmax(ref[-1]))], np.int32)
    tids = list(ids) + [int(cur[0])]
    lengths = np.array([n_prompt], np.int32)
    for step in range(n_decode):
        logits, ck, cv = jllama.decode_step(params, cfg, cur, lengths, ck, cv)
        with torch.no_grad():
            tref = model(torch.tensor(np.asarray(tids)[None].astype(np.int64))
                         ).logits[0, -1].numpy()
        _close(logits[0], tref, what=f"decode_step logits @ step {step}")
        cur = np.array([int(np.argmax(tref))], np.int32)
        tids.append(int(cur[0]))
        lengths = lengths + 1


def test_llama_logits_parity(tmp_path):
    d, model = _tiny_torch_llama(str(tmp_path))
    _llama_parity(d, model)


def test_llama_rope_linear_scaling_parity(tmp_path):
    d, model = _tiny_torch_llama(
        str(tmp_path),
        rope_scaling={"rope_type": "linear", "factor": 2.0})
    _llama_parity(d, model, n_prompt=12)


def test_llama_rope_llama3_parity(tmp_path):
    d, model = _tiny_torch_llama(
        str(tmp_path),
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 32},
        theta=50000.0)
    _llama_parity(d, model, n_prompt=12)


# --------------------------------------------------------------- whisper

def _tiny_torch_whisper(tmp):
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    torch.manual_seed(0)
    tcfg = WhisperConfig(
        vocab_size=120, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64, num_mel_bins=16,
        max_source_positions=1500, max_target_positions=64,
        decoder_start_token_id=1, pad_token_id=0, bos_token_id=1,
        eos_token_id=2,
    )
    model = WhisperForConditionalGeneration(tcfg).eval()
    d = os.path.join(tmp, "whisper")
    model.save_pretrained(d, safe_serialization=True)
    return d, model


def test_whisper_encoder_decoder_parity(tmp_path):
    d, model = _tiny_torch_whisper(str(tmp_path))
    cfg = jwhisper.WhisperConfig.from_json(os.path.join(d, "config.json"),
                                           dtype=jnp.float32)
    params = jwhisper.load_hf_params(d, cfg)

    rng = np.random.default_rng(1)
    mel = rng.normal(size=(1, 16, 3000)).astype(np.float32)
    with torch.no_grad():
        tenc = model.model.encoder(torch.tensor(mel)).last_hidden_state.numpy()
    enc = np.asarray(jwhisper.encode(params, cfg, mel))
    _close(enc, tenc, what="whisper encoder states")

    # decoder: step-by-step with self-attn cache vs torch full forward
    dec_ids = np.array([1, 7, 23, 50], np.int64)
    with torch.no_grad():
        tlogits = model(input_features=torch.tensor(mel),
                        decoder_input_ids=torch.tensor(dec_ids[None])
                        ).logits[0].numpy()
    xk, xv = jwhisper.cross_kv(params, cfg, jnp.asarray(tenc))
    L, D = cfg.decoder_layers, cfg.d_model
    ckd = jnp.zeros((L, 1, 64, D), jnp.float32)
    cvd = jnp.zeros((L, 1, 64, D), jnp.float32)
    for t, tok in enumerate(dec_ids):
        logits, ckd, cvd = jwhisper.decode_step(
            params, cfg, np.array([tok], np.int32), np.int32(t), xk, xv,
            ckd, cvd)
        _close(logits[0], tlogits[t], what=f"whisper decoder logits @ {t}")


def test_whisper_log_mel_matches_feature_extractor():
    from transformers import WhisperFeatureExtractor

    rng = np.random.default_rng(2)
    audio = (rng.normal(size=16000 * 3) * 0.1).astype(np.float32)
    fe = WhisperFeatureExtractor(feature_size=16)
    ref = fe(audio, sampling_rate=16000, return_tensors="np",
             padding="max_length")["input_features"][0]
    ours = jwhisper.log_mel(audio, 16)
    _close(ours, ref, atol=2e-3, rtol=2e-2, what="log-mel features")


# ------------------------------------------------------------------ bert

def _tiny_torch_bert_cfg():
    from transformers import BertConfig

    return BertConfig(
        vocab_size=60, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, type_vocab_size=2,
    )


def test_bert_hidden_state_parity(tmp_path):
    from transformers import BertModel

    torch.manual_seed(0)
    model = BertModel(_tiny_torch_bert_cfg()).eval()
    d = os.path.join(str(tmp_path), "bert")
    model.save_pretrained(d, safe_serialization=True)

    cfg = jbert.BertConfig.from_json(os.path.join(d, "config.json"),
                                     dtype=jnp.float32)
    params = jbert.load_hf_params(d, cfg)

    tokens = np.array([[2, 11, 35, 7, 0, 0], [5, 9, 0, 0, 0, 0]], np.int32)
    mask = (tokens > 0).astype(np.int32)
    with torch.no_grad():
        ref = model(torch.tensor(tokens.astype(np.int64)),
                    attention_mask=torch.tensor(mask.astype(np.int64))
                    ).last_hidden_state.numpy()
    ours = np.asarray(jbert.encode(params, cfg, tokens, mask))
    # only non-padding positions are meaningful
    for b in range(2):
        n = int(mask[b].sum())
        _close(ours[b, :n], ref[b, :n], what=f"bert hidden states row {b}")


def test_bert_cross_encoder_parity(tmp_path):
    from transformers import BertForSequenceClassification

    torch.manual_seed(0)
    model = BertForSequenceClassification(
        _tiny_torch_bert_cfg(), ).eval()
    model.config.num_labels = 1
    # rebuild with 1 label head
    cfg_t = _tiny_torch_bert_cfg()
    cfg_t.num_labels = 1
    model = BertForSequenceClassification(cfg_t).eval()
    d = os.path.join(str(tmp_path), "rerank")
    model.save_pretrained(d, safe_serialization=True)

    cfg = jbert.BertConfig.from_json(os.path.join(d, "config.json"),
                                     dtype=jnp.float32)
    params = jbert.load_hf_cross_params(d, cfg)
    tokens = np.array([[2, 11, 35, 7, 9, 3]], np.int32)
    mask = np.ones_like(tokens)
    type_ids = np.array([[0, 0, 0, 1, 1, 1]], np.int32)
    with torch.no_grad():
        ref = model(torch.tensor(tokens.astype(np.int64)),
                    attention_mask=torch.tensor(mask.astype(np.int64)),
                    token_type_ids=torch.tensor(type_ids.astype(np.int64))
                    ).logits[0, 0].item()
    ours = float(np.asarray(jbert.cross_score(params, cfg, tokens, mask,
                                              type_ids))[0])
    assert abs(ours - ref) < 2e-4, (ours, ref)


# -------------------------------------------------------------- CLIP ViT

def test_clip_vit_llava_features_parity(tmp_path):
    from safetensors.torch import save_file
    from transformers import CLIPVisionConfig, CLIPVisionModel

    torch.manual_seed(0)
    tcfg = CLIPVisionConfig(
        image_size=28, patch_size=14, hidden_size=16, intermediate_size=32,
        num_hidden_layers=3, num_attention_heads=2, projection_dim=24,
    )
    model = CLIPVisionModel(tcfg).eval()

    # LLaVA-style projector (2-layer gelu MLP) on top of the penultimate
    # layer's patch features
    torch.manual_seed(1)
    lin1 = torch.nn.Linear(16, 24)
    lin2 = torch.nn.Linear(24, 24)

    d = os.path.join(str(tmp_path), "clip")
    os.makedirs(d)
    sd = {f"vision_model.{k}": v for k, v in model.vision_model.state_dict().items()}
    sd["multi_modal_projector.linear_1.weight"] = lin1.weight.detach()
    sd["multi_modal_projector.linear_1.bias"] = lin1.bias.detach()
    sd["multi_modal_projector.linear_2.weight"] = lin2.weight.detach()
    sd["multi_modal_projector.linear_2.bias"] = lin2.bias.detach()
    save_file(sd, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"vision_config": tcfg.to_dict(), "proj_dim": 24}, f)

    cfg = jvision.VisionConfig.from_json(os.path.join(d, "config.json"),
                                         dtype=jnp.float32)
    params = jvision.load_params(d, cfg)

    rng = np.random.default_rng(3)
    pixels = rng.normal(size=(1, 3, 28, 28)).astype(np.float32)
    with torch.no_grad():
        hs = model(torch.tensor(pixels), output_hidden_states=True
                   ).hidden_states
        feats = hs[-2][:, 1:, :]           # penultimate layer, CLS dropped
        ref = lin2(torch.nn.functional.gelu(lin1(feats))).numpy()
    ours = np.asarray(jvision.encode(params, cfg, pixels))
    _close(ours, ref, what="LLaVA projected patch features")
