"""MOSS-TTS prompt processors: chat template -> (T, n_vq + 1) token rows.

A copy of mlx_audio_tpu/tts/models/moss_tts/processor.py, host side in
NumPy: `apply_delay_pattern` and `apply_de_delay_pattern`, the delay
processor, the legacy local one and the v1.5 one. Each conversation
renders to a text token stream where every audio span is <audio_start> +
per-frame slot tokens (+ a delay tail) + <audio_end>, aligned column-wise
with the (optionally delay-shifted) codec codes. Held to the JAX
package's by tests/test_torch_moss_tts.py.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .config import ModelConfig
from .text import normalize_tts_text

AUDIO_PLACEHOLDER = "<|audio|>"

USER_MESSAGE_FIELDS = ("text", "reference", "instruction", "tokens",
                       "quality", "sound_event", "ambient_sound", "language",
                       "scene")


def apply_delay_pattern(codes: np.ndarray, pad_code: int) -> np.ndarray:
    """(frames, n_vq) -> (frames + n_vq - 1, n_vq): channel c shifted down c
    rows, PAD elsewhere (ref processor.py:117-129)."""
    codes = np.asarray(codes)
    if codes.ndim != 2:
        raise ValueError(f"Expected codes [frames, n_vq], got {codes.shape}")
    frames, n_vq = codes.shape
    out = np.full((frames + n_vq - 1, n_vq), int(pad_code),
                  dtype=codes.dtype)
    for c in range(n_vq):
        out[c:c + frames, c] = codes[:, c]
    return out


def apply_de_delay_pattern(delay_codes: np.ndarray) -> np.ndarray:
    """(frames, n_vq) delayed -> (frames - n_vq + 1, n_vq) aligned."""
    delay_codes = np.asarray(delay_codes)
    if delay_codes.ndim != 2:
        raise ValueError(
            f"Expected delay_codes [frames, n_vq], got {delay_codes.shape}")
    total, n_vq = delay_codes.shape
    out_len = total - n_vq + 1
    if out_len <= 0:
        return np.zeros((0, n_vq), dtype=delay_codes.dtype)
    rows = np.arange(out_len)[:, None] + np.arange(n_vq)[None, :]
    return delay_codes[rows, np.arange(n_vq)[None, :]]


def _render_user_content(text=None, reference=None, instruction=None,
                         tokens=None, quality=None, sound_event=None,
                         ambient_sound=None, language=None, scene=None,
                         include_scene=False
                         ) -> Tuple[str, List[np.ndarray]]:
    """Fill the <user_inst> template; returns (content, audio_codes_list)."""
    audio_codes: List[np.ndarray] = []
    if reference is None:
        ref_str = "None"
    elif isinstance(reference, list):
        parts = []
        for i, item in enumerate(reference):
            if item is None:
                parts.append(f"[S{i + 1}]: None")
            else:
                parts.append(f"[S{i + 1}]:\n{AUDIO_PLACEHOLDER}")
                audio_codes.append(np.asarray(item))
        ref_str = "\n".join(parts)
    else:
        raise TypeError("reference must be a list when it is not None")

    fields = [("Reference(s)", ref_str), ("Instruction", str(instruction)),
              ("Tokens", str(tokens)), ("Quality", str(quality)),
              ("Sound Event", str(sound_event)),
              ("Ambient Sound", str(ambient_sound)),
              ("Language", str(language))]
    if include_scene:
        fields.append(("Scene", str(scene)))
    fields.append(("Text", str(text)))
    content = ("<user_inst>\n"
               + "\n".join(f"- {label}:\n{value}" for label, value in fields)
               + "\n</user_inst>")
    return content, audio_codes


class MossTTSDelayProcessor:
    """Delay-pattern prompt builder (ref processor.py:148)."""

    def __init__(self, tokenizer, model_config: ModelConfig, *,
                 use_delay_pattern: bool = True,
                 append_audio_start_for_generation: bool = False):
        self.tokenizer = tokenizer
        self.config = model_config
        self.use_delay_pattern = bool(use_delay_pattern)
        self.append_audio_start_for_generation = \
            bool(append_audio_start_for_generation)
        self.include_scene = (not model_config.is_local_transformer
                              and int(model_config.n_vq) == 16)

    # -- message builders --------------------------------------------------

    def _token_str(self, token_id: int) -> str:
        tok = self.tokenizer.convert_ids_to_tokens(int(token_id))
        if isinstance(tok, list):
            return tok[0] if tok else ""
        return str(tok)

    def build_user_message(self, text=None, reference=None, instruction=None,
                           tokens=None, quality=None, sound_event=None,
                           ambient_sound=None, language=None, scene=None
                           ) -> Dict[str, Any]:
        if reference is not None and not isinstance(reference, list):
            reference = [reference]
        content, codes = _render_user_content(
            text=normalize_tts_text(text), reference=reference,
            instruction=instruction, tokens=tokens, quality=quality,
            sound_event=sound_event, ambient_sound=ambient_sound,
            language=language, scene=scene, include_scene=self.include_scene)
        return {"role": "user", "content": content,
                "audio_codes_list": codes}

    @staticmethod
    def build_assistant_message(audio_codes_list: List[Any],
                                content: str = AUDIO_PLACEHOLDER
                                ) -> Dict[str, Any]:
        return {"role": "assistant", "content": content,
                "audio_codes_list": list(audio_codes_list)}

    def _normalize_message(self, message) -> Dict[str, Any]:
        if not isinstance(message, dict):
            raise TypeError("Each message must be a dict")
        if "role" not in message:
            raise ValueError("Message dict must include a role field")
        if "content" in message and "audio_codes_list" in message:
            return message
        role = message["role"]
        if role == "user":
            return self.build_user_message(
                **{k: message.get(k) for k in USER_MESSAGE_FIELDS})
        if role == "assistant":
            return self.build_assistant_message(
                message.get("audio_codes_list", []),
                content=message.get("content", AUDIO_PLACEHOLDER))
        raise ValueError(f"Unsupported role: {role}")

    # -- rendering ----------------------------------------------------------

    @staticmethod
    def apply_chat_template(role: str, content: str,
                            add_generation_prompt: bool) -> str:
        rendered = f"<|im_start|>{role}\n{content}<|im_end|>\n"
        if add_generation_prompt:
            rendered += "<|im_start|>assistant\n"
        return rendered

    def _audio_block(self, length: int, gen_slot: str, delay_slot: str) -> str:
        start = self._token_str(self.config.audio_start_token_id)
        end = self._token_str(self.config.audio_end_token_id)
        if length < 0:
            raise ValueError(f"length must be >= 0, got {length}")
        if length == 0:
            return f"{start}{end}"
        if delay_slot:
            return (f"{start}{gen_slot * length}"
                    f"{delay_slot * (self.config.n_vq - 1)}{end}")
        return f"{start}{gen_slot * length}{end}"

    def _normalize_codes(self, audio_codes_list) -> List[np.ndarray]:
        n_vq = int(self.config.n_vq)
        out = []
        for codes in audio_codes_list:
            codes = np.asarray(codes)
            if codes.ndim != 2:
                raise ValueError(
                    f"Expected codes [frames, n_vq], got {codes.shape}")
            if codes.shape[1] < n_vq and codes.shape[0] >= n_vq:
                codes = codes.T
            if codes.shape[1] < n_vq:
                raise ValueError(f"audio codes channels ({codes.shape[1]}) "
                                 f"< model n_vq ({n_vq})")
            out.append(codes[:, :n_vq].astype(np.int32))
        return out

    @staticmethod
    def _merge_adjacent_placeholders(content: str, codes: List[np.ndarray]
                                     ) -> Tuple[str, List[np.ndarray]]:
        matches = list(re.finditer(re.escape(AUDIO_PLACEHOLDER), content))
        if len(matches) <= 1:
            return content, codes
        if len(matches) != len(codes):
            raise ValueError("Audio placeholders do not match audio codes")
        merged_codes, parts = [], []
        last, i = 0, 0
        while i < len(matches):
            j = i
            while (j + 1 < len(matches)
                   and content[matches[j].end():matches[j + 1].start()]
                   .strip() == ""):
                j += 1
            parts.append(content[last:matches[i].start()])
            parts.append(AUDIO_PLACEHOLDER)
            last = matches[j].end()
            merged_codes.append(
                codes[i] if j == i
                else np.concatenate(codes[i:j + 1], axis=0))
            i = j + 1
        parts.append(content[last:])
        return "".join(parts), merged_codes

    def _unified_codes(self, role: str, content: str,
                       audio_codes_list: List[np.ndarray],
                       truncation: bool) -> np.ndarray:
        cfg = self.config
        if role == "user":
            gen_slot = self._token_str(cfg.audio_user_slot_token_id)
            delay_slot = gen_slot
            truncation = False
        else:
            gen_slot = self._token_str(cfg.audio_assistant_gen_slot_token_id)
            delay_slot = self._token_str(
                cfg.audio_assistant_delay_slot_token_id)

        n_vq = int(cfg.n_vq)
        codes_list = self._normalize_codes(audio_codes_list)
        if len(codes_list) > 1 and AUDIO_PLACEHOLDER in content:
            content, codes_list = self._merge_adjacent_placeholders(
                content, codes_list)
        lengths = [int(c.shape[0]) for c in codes_list]
        if content.count(AUDIO_PLACEHOLDER) != len(lengths):
            raise ValueError(
                "Audio placeholders do not match audio code lengths")
        it = iter(lengths)
        content = re.sub(
            re.escape(AUDIO_PLACEHOLDER),
            lambda _m: self._audio_block(
                next(it), gen_slot,
                delay_slot if self.use_delay_pattern else ""),
            content)
        text_ids = np.asarray(self.tokenizer.encode(content), np.int32)

        starts = np.flatnonzero(text_ids == cfg.audio_start_token_id)
        ends = np.flatnonzero(text_ids == cfg.audio_end_token_id)
        if len(starts) != len(codes_list) or len(ends) != len(codes_list):
            raise ValueError(
                "Audio placeholders do not match the provided audio codes")

        if not codes_list:
            audio_rows = np.full((len(text_ids), n_vq), cfg.audio_pad_code,
                                 np.int32)
        else:
            sections = []
            prefix = 0
            for s, e, codes in zip(starts, ends, codes_list):
                if self.use_delay_pattern:
                    codes = apply_delay_pattern(codes, cfg.audio_pad_code)
                sections.append(np.full((int(s) - prefix + 1, n_vq),
                                        cfg.audio_pad_code, np.int32))
                sections.append(codes.astype(np.int32))
                prefix = int(e)
            if truncation and self.use_delay_pattern:
                sections[-1] = sections[-1][:-(n_vq - 1)]
            elif not truncation:
                sections.append(np.full((len(text_ids) - int(ends[-1]), n_vq),
                                        cfg.audio_pad_code, np.int32))
            audio_rows = np.concatenate(sections, axis=0)

        if len(text_ids) != len(audio_rows):
            text_ids = text_ids[:len(audio_rows)]
        return np.concatenate([text_ids[:, None], audio_rows], axis=1)

    def __call__(self, conversations, *, mode: str = "generation",
                 apply_chat_template: bool = True) -> Dict[str, np.ndarray]:
        if mode not in {"generation", "continuation"}:
            raise ValueError("mode must be generation or continuation")
        if isinstance(conversations, dict):
            conversations = [conversations]
        truncation = mode == "continuation"
        rows_list = []
        for conv in conversations:
            if isinstance(conv, dict):
                conv = [conv]
            conv = [self._normalize_message(m) for m in conv]
            if (mode == "generation") ^ (len(conv) % 2 != 0):
                raise ValueError("Invalid conversation length for mode")
            if (mode == "generation") ^ (conv[-1]["role"] == "user"):
                raise ValueError("Invalid final role for mode")
            unified = []
            for i, msg in enumerate(conv):
                content = str(msg["content"])
                if apply_chat_template:
                    content = self.apply_chat_template(
                        msg["role"], content,
                        mode == "generation" and i == len(conv) - 1)
                unified.append(self._unified_codes(
                    msg["role"], content,
                    [np.asarray(c) for c in msg.get("audio_codes_list", [])],
                    truncation))
            rows = np.concatenate(unified, axis=0)
            if self.append_audio_start_for_generation and mode == "generation":
                extra = np.full((1, rows.shape[1]),
                                self.config.audio_pad_code, np.int32)
                extra[0, 0] = self.config.audio_start_token_id
                rows = np.concatenate([rows, extra], axis=0)
            rows_list.append(rows)
        return self._pad(rows_list)

    def _pad(self, rows_list: List[np.ndarray]) -> Dict[str, np.ndarray]:
        cfg = self.config
        max_len = max(r.shape[0] for r in rows_list)
        padded, masks = [], []
        for rows in rows_list:
            n_pad = max_len - rows.shape[0]
            if n_pad > 0:
                pad = np.full((n_pad, cfg.n_vq + 1), cfg.audio_pad_code,
                              np.int32)
                pad[:, 0] = cfg.pad_token_id
                rows = np.concatenate([pad, rows], axis=0)
            padded.append(rows)
            masks.append(np.concatenate([np.zeros(n_pad, bool),
                                         np.ones(max_len - n_pad, bool)]))
        return {"input_ids": np.stack(padded),
                "attention_mask": np.stack(masks)}


class MossTTSLocalProcessor(MossTTSDelayProcessor):
    """Legacy local-transformer prompts: no delay pattern, trailing
    <audio_start> row appended for generation (ref processor.py:525-540)."""

    def __init__(self, tokenizer, model_config: ModelConfig):
        super().__init__(tokenizer, model_config, use_delay_pattern=False,
                         append_audio_start_for_generation=True)


class MossTTSLocalV15Processor:
    """v1.5 local-transformer prompt builder (ref processor.py:636+):
    row-aligned token ids built directly (no string re-tokenization of the
    audio spans)."""

    def __init__(self, tokenizer, model_config: ModelConfig):
        self.tokenizer = tokenizer
        self.config = model_config

    def _encode(self, text: str) -> List[int]:
        try:
            return [int(t) for t in
                    self.tokenizer.encode(text, add_special_tokens=False)]
        except TypeError:
            return [int(t) for t in self.tokenizer.encode(text)]

    def _text_rows(self, ids: Sequence[int]) -> np.ndarray:
        cfg = self.config
        rows = np.full((len(ids), cfg.n_vq + 1), cfg.audio_pad_token_id,
                       np.int32)
        if len(ids):
            rows[:, 0] = np.asarray(list(ids), np.int32)
        return rows

    def _audio_rows(self, codes: np.ndarray, slot_id: int) -> np.ndarray:
        cfg = self.config
        codes = np.asarray(codes, np.int32)
        rows = np.full((codes.shape[0], cfg.n_vq + 1),
                       cfg.audio_pad_token_id, np.int32)
        rows[:, 0] = int(slot_id)
        c = min(codes.shape[1], cfg.n_vq)
        rows[:, 1:1 + c] = codes[:, :c]
        return rows

    def build_user_message(self, text=None, **kwargs) -> Dict[str, Any]:
        return {"role": "user", "text": normalize_tts_text(text),
                "reference": kwargs.get("reference"),
                "instruction": kwargs.get("instruction")}

    @staticmethod
    def build_assistant_message(audio_codes_list, content=AUDIO_PLACEHOLDER):
        return {"role": "assistant", "audio_codes_list": list(audio_codes_list),
                "content": content}

    def __call__(self, conversations, *, mode: str = "generation",
                 apply_chat_template: bool = True) -> Dict[str, np.ndarray]:
        if isinstance(conversations, dict):
            conversations = [conversations]
        cfg = self.config
        rows_list = []
        for conv in conversations:
            if isinstance(conv, dict):
                conv = [conv]
            user = conv[0]
            reference = user.get("reference")
            ref_codes = None
            if reference:
                ref_list = reference if isinstance(reference, list) \
                    else [reference]
                valid = [np.asarray(r) for r in ref_list if r is not None]
                if valid:
                    ref_codes = np.concatenate(valid, axis=0)
            content, _ = _render_user_content(
                text=user.get("text"), reference=None,
                instruction=user.get("instruction"))
            # split the template at the Reference(s) value ("None") so codec
            # rows can be spliced in
            sections = []
            if ref_codes is None:
                ids = self._encode(
                    f"<|im_start|>user\n{content}<|im_end|>\n"
                    "<|im_start|>assistant\n")
                sections.append(self._text_rows(ids))
            else:
                head, _, tail = content.partition("- Reference(s):\nNone")
                pre = self._encode(f"<|im_start|>user\n{head}"
                                   "- Reference(s):\n")
                post = self._encode(f"{tail}<|im_end|>\n"
                                    "<|im_start|>assistant\n")
                sections.append(self._text_rows(
                    pre + [cfg.audio_start_token_id]))
                sections.append(self._audio_rows(
                    ref_codes, cfg.audio_user_slot_token_id))
                sections.append(self._text_rows(
                    [cfg.audio_end_token_id] + post))
            sections.append(self._text_rows([cfg.audio_start_token_id]))
            if len(conv) > 1 and conv[-1].get("audio_codes_list"):
                cont = np.concatenate(
                    [np.asarray(c) for c in conv[-1]["audio_codes_list"]],
                    axis=0)
                sections.append(self._audio_rows(
                    cont, cfg.audio_assistant_slot_token_id))
            rows_list.append(np.concatenate(sections, axis=0))

        max_len = max(r.shape[0] for r in rows_list)
        padded, masks = [], []
        for rows in rows_list:
            n_pad = max_len - rows.shape[0]
            if n_pad > 0:
                pad = np.full((n_pad, cfg.n_vq + 1), cfg.audio_pad_token_id,
                              np.int32)
                pad[:, 0] = cfg.pad_token_id
                rows = np.concatenate([pad, rows], axis=0)
            padded.append(rows)
            masks.append(np.concatenate([np.zeros(n_pad, bool),
                                         np.ones(max_len - n_pad, bool)]))
        return {"input_ids": np.stack(padded),
                "attention_mask": np.stack(masks)}


__all__ = ["AUDIO_PLACEHOLDER", "apply_delay_pattern",
           "apply_de_delay_pattern", "MossTTSDelayProcessor",
           "MossTTSLocalProcessor", "MossTTSLocalV15Processor"]
