"""Chat request -> prompt assembly (a copy of localai_tpu/api/chatflow.py).

``flatten_content`` turns OpenAI content parts into text plus the media
lists; ``build_chat_prompt`` renders each message through the model
config's ``chat_message`` template (the default "{Role}: {Content}"
without one), joins them, and renders the outer ``chat`` template. Media
parts only number their [img-N] / [audio-N] / [vid-N] placeholders: the
chat route answers a request that carries any with the JAX route's 400s,
since multimodal serving is a later slice (ROADMAP Queue 1 item 10), so
a media URL is never fetched (the JAX copy fetches http(s) URLs).
"""

from __future__ import annotations

from typing import Optional

from localai_tpu_torch.config.model_config import ModelConfig
from localai_tpu_torch.templates import prompts as T


def _media(url: str) -> str:
    """A data: URI's base64 payload; any other URL as it stands."""
    if url.startswith("data:"):
        _, _, payload = url.partition("base64,")
        if not payload:
            raise ValueError("unsupported data URI (expected base64)")
        return payload
    if url.startswith(("http://", "https://")):
        return url
    raise ValueError(f"unsupported media URL scheme: {url[:32]}")


def flatten_content(message: dict) -> tuple:
    """OpenAI content parts -> (text, images[], audios[], videos[])."""
    content = message.get("content")
    if content is None:
        return "", [], [], []
    if isinstance(content, str):
        return content, [], [], []
    texts, images, audios, videos = [], [], [], []
    for part in content:
        ptype = part.get("type", "text")
        if ptype == "text":
            texts.append(part.get("text", ""))
        elif ptype == "image_url":
            images.append(_media(part["image_url"]["url"]))
        elif ptype in ("audio_url", "input_audio"):
            url = part.get("audio_url", {}).get("url") or part.get("input_audio", {}).get("data", "")
            audios.append(_media(url) if url.startswith(("data:", "http")) else url)
        elif ptype == "video_url":
            videos.append(_media(part["video_url"]["url"]))
    return "\n".join(texts), images, audios, videos


def build_chat_prompt(mc: ModelConfig, messages: list, tokenizer=None,
                      functions: Optional[list] = None) -> tuple:
    """Returns (prompt_text, images, audios, videos). ``tokenizer`` is
    the JAX signature's; the tokenizer-template branch is not ported
    (the JAX route passes None), so a config with
    ``use_tokenizer_template`` renders its own templates here too, as it
    does on the JAX route."""
    all_images, all_audios, all_videos = [], [], []
    norm_msgs = []
    for m in messages:
        text, imgs, auds, vids = flatten_content(m)
        if imgs or auds or vids:
            text = T.multimodal_placeholders(
                mc.template.multimodal, text,
                n_images=len(imgs), n_audios=len(auds), n_videos=len(vids),
                img_offset=len(all_images), audio_offset=len(all_audios),
                vid_offset=len(all_videos),
            )
        all_images += imgs
        all_audios += auds
        all_videos += vids
        norm_msgs.append({"role": m.get("role", "user"), "content": text,
                          "tool_calls": m.get("tool_calls"),
                          "name": m.get("name")})

    if mc.template.use_tokenizer_template and tokenizer is not None:
        raise NotImplementedError(
            "use_tokenizer_template with a tokenizer: the tokenizer's own "
            "chat template is not ported")

    system_prompt = mc.system_prompt
    rendered = []
    msg_tpl = mc.template.chat_message or T.DEFAULT_CHAT_MESSAGE
    for i, m in enumerate(norm_msgs):
        data = T.ChatMessageData(
            system_prompt=system_prompt,
            role=m["role"], role_name=m["role"], content=m["content"] or "",
            function_call=m.get("tool_calls"),
            last_message=(i == len(norm_msgs) - 1),
            index=i,
        )
        s = T.render_chat_message(msg_tpl, data)
        if s:
            rendered.append(s)
    joiner = mc.template.join_chat_messages_by_character
    joined = (joiner if joiner is not None else "\n").join(rendered)

    if mc.template.chat:
        prompt = T.render_chat_prompt(mc.template.chat, joined, system_prompt,
                                      functions=functions)
    else:
        prompt = joined
    return prompt, all_images, all_audios, all_videos
