"""Prompt templating (a copy of localai_tpu/templates/prompts.py over
templates/jinja_lite.py: the card's machine has no ``jinja2``).

Per-message templates (``render_chat_message``), the outer chat template
(``render_chat_prompt``), completion and edit templates, and the
multimodal placeholders, with the JAX signatures and values. Compiled
templates are cached per source. ``check`` compiles a model config's
templates, so one outside the renderer's subset fails when the config is
loaded. ``apply_tokenizer_template`` (a tokenizer's own chat template) is
not ported: the JAX route never reaches it (it passes no tokenizer to
``build_chat_prompt``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from localai_tpu_torch.templates.jinja_lite import Template

_cache: dict = {}


def render(template: str, **values) -> str:
    tpl = _cache.get(template)
    if tpl is None:
        tpl = Template(template)
        if len(_cache) < 512:
            _cache[template] = tpl
    return tpl.render(**values)


@dataclasses.dataclass
class ChatMessageData:
    """Per-message template inputs (reference: chat.go:311-397)."""
    system_prompt: str = ""
    role: str = ""
    role_name: str = ""
    content: str = ""
    function_call: Any = None
    function_name: str = ""
    last_message: bool = False
    index: int = 0


DEFAULT_CHAT_MESSAGE = "{% if Role %}{{ Role }}: {% endif %}{{ Content }}"


def render_chat_message(template: str, msg: ChatMessageData) -> str:
    return render(
        template,
        SystemPrompt=msg.system_prompt,
        Role=msg.role,
        RoleName=msg.role_name,
        Content=msg.content,
        FunctionCall=msg.function_call,
        FunctionName=msg.function_name,
        LastMessage=msg.last_message,
        MessageIndex=msg.index,
        # lowercase aliases
        role=msg.role, content=msg.content,
    )


def render_chat_prompt(template: str, joined_messages: str, system_prompt: str = "",
                       functions: Optional[list] = None, suppressed: bool = False) -> str:
    return render(
        template,
        Input=joined_messages,
        SystemPrompt=system_prompt,
        Functions=functions or [],
        SuppressSystemPrompt=suppressed,
        input=joined_messages,
    )


def render_completion(template: str, prompt: str, system_prompt: str = "") -> str:
    return render(template, Input=prompt, SystemPrompt=system_prompt, input=prompt)


def render_edit(template: str, instruction: str, prompt: str) -> str:
    return render(template, Instruction=instruction, Input=prompt,
                  instruction=instruction, input=prompt)


def multimodal_placeholders(template: str, text: str, n_images: int = 0,
                            n_audios: int = 0, n_videos: int = 0,
                            img_offset: int = 0, audio_offset: int = 0,
                            vid_offset: int = 0) -> str:
    """Inject [img-N]/[audio-N]/[vid-N] placeholders before the text
    (reference: pkg/templates/multimodal.go:24-26 default template).

    N is GLOBAL across the whole chat (offsets = media count in earlier
    messages): the backend resolves [vid-N] against one request-wide
    media list, so per-message numbering would alias every message's
    first video onto index 0."""
    imgs = "".join(f"[img-{i}]"
                   for i in range(img_offset, img_offset + n_images))
    auds = "".join(f"[audio-{i}]"
                   for i in range(audio_offset, audio_offset + n_audios))
    vids = "".join(f"[vid-{i}]"
                   for i in range(vid_offset, vid_offset + n_videos))
    if template:
        return render(template, Text=text, ImagesCount=n_images, AudiosCount=n_audios,
                      VideosCount=n_videos, Images=imgs, Audios=auds, Videos=vids)
    out = auds + imgs + vids
    if out and text:
        out += "\n"
    return out + text


def check(mc) -> None:
    """Compile every template of a model config (TemplateError on one
    outside the subset)."""
    t = mc.template
    for src in (t.chat, t.chat_message, t.completion, t.edit, t.function,
                t.multimodal):
        if src and src not in _cache:
            tpl = Template(src)
            if len(_cache) < 512:
                _cache[src] = tpl
