"""Checkpoint-family guesser: default chat templates + stopwords (a copy
of localai_tpu/config/guesser.py).

Identifies the chat-template family of an HF checkpoint dir (llama3,
chatml, mistral, gemma, phi3, deepseek2) from its tokenizer_config.json's
chat_template markers, then config.json's model_type, and fills in that
family's templates and stopwords where the model YAML sets none.
"""

from __future__ import annotations

import json
import logging
import os

log = logging.getLogger(__name__)

# family -> (chat_message template, chat template, stopwords)
FAMILIES = {
    "llama3": (
        "<|start_header_id|>{{ Role }}<|end_header_id|>\n\n{{ Content }}<|eot_id|>",
        "<|begin_of_text|>{{ Input }}<|start_header_id|>assistant<|end_header_id|>\n\n",
        ["<|eot_id|>", "<|end_of_text|>"],
    ),
    "chatml": (
        "<|im_start|>{{ Role }}\n{{ Content }}<|im_end|>",
        "{{ Input }}\n<|im_start|>assistant\n",
        ["<|im_end|>"],
    ),
    "mistral": (
        "{% if Role == 'user' %}[INST] {{ Content }} [/INST]{% else %}{{ Content }}</s>{% endif %}",
        "<s>{{ Input }}",
        ["</s>"],
    ),
    "gemma": (
        "<start_of_turn>{% if Role == 'assistant' %}model{% else %}{{ Role }}{% endif %}\n{{ Content }}<end_of_turn>",
        "{{ Input }}\n<start_of_turn>model\n",
        ["<end_of_turn>"],
    ),
    "phi3": (
        "<|{{ Role }}|>\n{{ Content }}<|end|>",
        "{{ Input }}\n<|assistant|>\n",
        ["<|end|>", "<|endoftext|>"],
    ),
    "deepseek2": (
        "{% if Role == 'user' %}User: {{ Content }}\n{% else %}Assistant: {{ Content }}<|end_of_sentence|>{% endif %}",
        "{{ Input }}Assistant:",
        ["<|end_of_sentence|>"],
    ),
}

_MARKERS = (
    ("<|start_header_id|>", "llama3"),
    ("<|im_start|>", "chatml"),
    ("<start_of_turn>", "gemma"),
    ("<|end_of_sentence|>", "deepseek2"),
    ("<|assistant|>", "phi3"),
    ("[INST]", "mistral"),
)


def identify_family(model_dir: str):
    """Best-effort family id for an HF checkpoint dir (None = unknown)."""
    tok_cfg = {}
    cfg = {}
    for name, target in (("tokenizer_config.json", tok_cfg),
                         ("config.json", cfg)):
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            try:
                with open(path) as f:
                    target.update(json.load(f))
            except Exception:
                pass
    template = tok_cfg.get("chat_template") or ""
    if isinstance(template, list):  # HF allows named template lists
        template = " ".join(str(t) for t in template)
    for marker, family in _MARKERS:
        if marker in template:
            return family
    mt = (cfg.get("model_type") or "").lower()
    if mt in ("qwen2", "qwen"):  # qwen ships ChatML
        return "chatml"
    if mt == "gemma":
        return "gemma"
    if mt == "phi3":
        return "phi3"
    if mt == "mistral":
        return "mistral"
    if mt == "llama":
        # llama-3 marks itself via vocab size / eos token naming
        eos = str(tok_cfg.get("eos_token", ""))
        if cfg.get("vocab_size", 0) >= 128000 or "eot_id" in eos:
            return "llama3"
    return None


def guess_defaults(mc, models_path: str) -> bool:
    """Fill missing chat templates + stopwords on a ModelConfig from the
    checkpoint family. Returns True if anything was set (reference:
    guessDefaultsFromFile, guesser.go:145-203)."""
    if mc.template.chat and mc.template.chat_message:
        return False
    model_dir = mc.model or mc.name
    if not os.path.isabs(model_dir):
        model_dir = os.path.join(models_path, model_dir)
    if not os.path.isdir(model_dir):
        return False
    family = identify_family(model_dir)
    if family is None:
        return False
    chat_message, chat, stopwords = FAMILIES[family]
    changed = False
    if not mc.template.chat_message:
        mc.template.chat_message = chat_message
        changed = True
    if not mc.template.chat:
        mc.template.chat = chat
        changed = True
    if not mc.stopwords:
        mc.stopwords = list(stopwords)
        changed = True
    if changed:
        log.info("guessed %s chat template for model %s", family, mc.name)
    return changed
