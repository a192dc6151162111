"""Qwen3-ForcedAligner: word-level timestamps from one forward pass.

Counterpart of mlx_audio_tpu/stt/models/qwen3_asr/forced_aligner.py:
`ForceAlignProcessor` (:35-204: the language tokenizers, the LIS repair of
non-monotonic timestamps, the prompt with its <timestamp> pairs, the
parse), host code copied; `ForcedAlignItem`, `ForcedAlignResult`,
`ForcedAlignerConfig` (:207-254); and `ForcedAlignerModel`: Qwen3-ASR's
audio tower and LM with a `classify_num`-way head `lm_head`, one forward
over the prompt bucket (`_align_fn` :291-317: causal, the padded prompt
masked) whose argmax at each <timestamp> position, times
`timestamp_segment_time` ms, is a word's start or end (`generate`
:319-371).

Departures: the result carries the language it was aligned in
(`ForcedAlignResult.language`), so the STT CLI and the server's
verbose_json write it; `post_load_hook` raises on tokenizer files that
fail to load (JAX's swallows the error).
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ....nn import Linear
from .config import ModelConfig as AsrModelConfig
from .qwen3_asr import Model as AsrModel

PROMPT_BUCKETS = (128, 256, 512, 1024, 2048, 4096)


class ForceAlignProcessor:
    """Text tokenization + timestamp parsing (reference :15-298)."""

    def __init__(self):
        self.ko_tokenizer = None
        self._nagisa = None

    @staticmethod
    def is_kept_char(ch: str) -> bool:
        if ch == "'":
            return True
        cat = unicodedata.category(ch)
        return cat.startswith("L") or cat.startswith("N")

    def clean_token(self, token: str) -> str:
        return "".join(ch for ch in token if self.is_kept_char(ch))

    @staticmethod
    def is_cjk_char(ch: str) -> bool:
        code = ord(ch)
        return (0x4E00 <= code <= 0x9FFF or 0x3400 <= code <= 0x4DBF
                or 0x20000 <= code <= 0x2A6DF or 0x2A700 <= code <= 0x2B73F
                or 0x2B740 <= code <= 0x2B81F or 0x2B820 <= code <= 0x2CEAF
                or 0xF900 <= code <= 0xFAFF)

    def tokenize_chinese_mixed(self, text: str) -> List[str]:
        tokens: List[str] = []
        latin: List[str] = []

        def flush():
            if latin:
                cleaned = self.clean_token("".join(latin))
                if cleaned:
                    tokens.append(cleaned)
                latin.clear()

        for ch in text:
            if self.is_cjk_char(ch):
                flush()
                tokens.append(ch)
            elif self.is_kept_char(ch):
                latin.append(ch)
            else:
                flush()
        flush()
        return tokens

    def tokenize_japanese(self, text: str) -> List[str]:
        if self._nagisa is None:
            try:
                import nagisa

                self._nagisa = nagisa
            except ImportError:
                raise ImportError("Japanese tokenization requires nagisa")
        return [self.clean_token(w)
                for w in self._nagisa.tagging(text).words
                if self.clean_token(w)]

    def tokenize_korean(self, text: str) -> List[str]:
        if self.ko_tokenizer is None:
            try:
                from soynlp.tokenizer import LTokenizer

                self.ko_tokenizer = LTokenizer()
            except ImportError:
                raise ImportError("Korean tokenization requires soynlp")
        return [self.clean_token(w)
                for w in self.ko_tokenizer.tokenize(text)
                if self.clean_token(w)]

    def split_segment_with_chinese(self, seg: str) -> List[str]:
        tokens: List[str] = []
        buf: List[str] = []
        for ch in seg:
            if self.is_cjk_char(ch):
                if buf:
                    tokens.append("".join(buf))
                    buf = []
                tokens.append(ch)
            else:
                buf.append(ch)
        if buf:
            tokens.append("".join(buf))
        return tokens

    def tokenize_space_lang(self, text: str) -> List[str]:
        tokens: List[str] = []
        for seg in text.split():
            cleaned = self.clean_token(seg)
            if cleaned:
                tokens.extend(self.split_segment_with_chinese(cleaned))
        return tokens

    def fix_timestamp(self, data) -> List[int]:
        """Repair non-monotonic timestamps: keep the longest increasing
        subsequence; fill <=2-wide anomalies from the nearest valid
        neighbor, interpolate larger runs (reference :147-244)."""
        data = list(np.asarray(data).reshape(-1))
        n = len(data)
        if n == 0:
            return []
        dp = [1] * n
        parent = [-1] * n
        for i in range(1, n):
            for j in range(i):
                if data[j] <= data[i] and dp[j] + 1 > dp[i]:
                    dp[i] = dp[j] + 1
                    parent[i] = j
        idx = dp.index(max(dp))
        is_normal = [False] * n
        while idx != -1:
            is_normal[idx] = True
            idx = parent[idx]
        result = list(data)
        i = 0
        while i < n:
            if is_normal[i]:
                i += 1
                continue
            j = i
            while j < n and not is_normal[j]:
                j += 1
            left = next((result[k] for k in range(i - 1, -1, -1)
                         if is_normal[k]), None)
            right = next((result[k] for k in range(j, n)
                          if is_normal[k]), None)
            if j - i <= 2:
                for k in range(i, j):
                    if left is None:
                        result[k] = right
                    elif right is None:
                        result[k] = left
                    else:
                        result[k] = left if (k - (i - 1)) <= (j - k) \
                            else right
            else:
                if left is not None and right is not None:
                    step = (right - left) / (j - i + 1)
                    for k in range(i, j):
                        result[k] = left + step * (k - i + 1)
                else:
                    fill = left if left is not None else right
                    for k in range(i, j):
                        result[k] = fill
            i = j
        return [int(r) for r in result]

    def encode_timestamp(self, text: str, language: str
                         ) -> Tuple[List[str], str]:
        language = language.lower()
        if language == "japanese":
            words = self.tokenize_japanese(text)
        elif language == "korean":
            words = self.tokenize_korean(text)
        elif language == "chinese":
            words = self.tokenize_chinese_mixed(text)
        else:
            words = self.tokenize_space_lang(text)
        input_text = "<timestamp><timestamp>".join(words) \
            + "<timestamp><timestamp>"
        input_text = "<|audio_start|><|audio_pad|><|audio_end|>" + input_text
        return words, input_text

    def parse_timestamp(self, words: List[str], timestamp
                        ) -> List[Dict[str, Any]]:
        fixed = self.fix_timestamp(timestamp)
        return [{"text": w, "start_time": fixed[2 * i],
                 "end_time": fixed[2 * i + 1]}
                for i, w in enumerate(words)]


@dataclass(frozen=True)
class ForcedAlignItem:
    text: str
    start_time: float
    end_time: float


@dataclass
class ForcedAlignResult:
    items: List[ForcedAlignItem]
    language: Optional[str] = None

    @property
    def text(self) -> str:
        return " ".join(it.text for it in self.items)

    @property
    def segments(self) -> List[Dict[str, Any]]:
        return [{"text": it.text, "start": it.start_time,
                 "end": it.end_time} for it in self.items]

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        return self.items[idx]


@dataclass
class ForcedAlignerConfig(AsrModelConfig):
    model_type: str = "qwen3_forced_aligner"
    timestamp_token_id: int = 151705
    timestamp_segment_time: float = 80.0
    classify_num: int = 5000

    @classmethod
    def from_dict(cls, params: Dict[str, Any]) -> "ForcedAlignerConfig":
        params = dict(params)
        thinker = params.get("thinker_config", {})
        for k in ("timestamp_token_id", "timestamp_segment_time",
                  "classify_num"):
            if k in thinker:
                params.setdefault(k, thinker[k])
        cfg = super(ForcedAlignerConfig, cls).from_dict(params)
        cfg.model_type = "qwen3_forced_aligner"
        return cfg


def align_bucket(n: int) -> int:
    return next((b for b in PROMPT_BUCKETS if n <= b),
                ((n + 4095) // 4096) * 4096)


class ForcedAlignerModel(AsrModel):
    """Alignment = one forward; timestamps read at <timestamp> positions
    (reference ForcedAlignerModel :449-570). On `device`: the card by
    default; without CUDA the constructor raises unless given
    `device="cpu"`."""

    def __init__(self, config=None, device="cuda", **kwargs):
        if config is None:
            config = ForcedAlignerConfig.from_dict(kwargs) if kwargs \
                else ForcedAlignerConfig()
        elif isinstance(config, dict):
            config = ForcedAlignerConfig.from_dict(config)
        super().__init__(config, device=device)
        with torch.device(self.device):
            self.lm_head = Linear(config.text_config.hidden_size,
                                  config.classify_num, bias=False)
        self.lm_head.requires_grad_(False)
        self.aligner_processor = ForceAlignProcessor()

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """As Qwen3-ASR's, keeping `lm_head.weight` (the timestamp head)."""
        head = weights.get("lm_head.weight",
                           weights.get("thinker.lm_head.weight"))
        out = super().sanitize(weights)
        if head is not None:
            out["lm_head.weight"] = np.asarray(head)
        return out

    # ------------------------------------------------------------ forward

    @torch.inference_mode()
    def align_logits(self, embeds: torch.Tensor, n: int) -> torch.Tensor:
        """The prompt embeddings (1, bucket, D), n of them real -> the
        timestamp head's logits (1, bucket, classify_num): causal, the
        padded rows masked as keys."""
        bucket = embeds.shape[1]
        pad = torch.zeros(1, bucket, device=embeds.device)
        pad[:, n:] = float("-inf")
        hidden, _ = self._lm_forward(embeds, None, 0, pad)
        return self.lm_head(hidden)

    # ----------------------------------------------------------- generate

    def generate(self, audio, text: Union[str, List[str]] = "",
                 language: Union[str, List[str]] = "English", **kwargs):
        """Align transcript(s) to audio -> ForcedAlignResult(s)
        (reference generate :637-760)."""
        if self._tokenizer is None:
            raise RuntimeError("tokenizer not initialized; load the model "
                               "from a checkpoint directory")
        single = not isinstance(audio, list)
        audios = [audio] if single else audio
        texts = [text] if isinstance(text, str) else text
        langs = [language] if isinstance(language, str) else language
        if len(langs) == 1 and len(audios) > 1:
            langs = langs * len(audios)
        if not (len(audios) == len(texts) == len(langs)):
            raise ValueError("audio/text/language batch size mismatch")

        results = []
        for a, txt, lang in zip(audios, texts, langs):
            if isinstance(a, (str, Path)):
                from ....utils import load_audio

                a = load_audio(str(a), sample_rate=self.sample_rate)
            feats, n_audio = self.encode(np.asarray(a, np.float32))
            words, aligner_text = self.aligner_processor.encode_timestamp(
                txt, lang)
            aligner_text = aligner_text.replace(
                "<|audio_pad|>", "<|audio_pad|>" * n_audio)
            ids = list(self._tokenizer.encode(aligner_text,
                                              add_special_tokens=False))
            n = len(ids)
            pb = align_bucket(n)
            logits = self.align_logits(self.prompt_embeds(ids, feats, pb), n)
            out_ids = logits[0, :n].argmax(dim=-1).cpu().numpy()
            ts_mask = np.asarray(ids) == self.config.timestamp_token_id
            ts_ms = out_ids[ts_mask] * self.config.timestamp_segment_time
            parsed = self.aligner_processor.parse_timestamp(words, ts_ms)
            results.append(ForcedAlignResult(items=[
                ForcedAlignItem(text=str(d["text"]),
                                start_time=round(d["start_time"] / 1000.0,
                                                 3),
                                end_time=round(d["end_time"] / 1000.0, 3))
                for d in parsed], language=lang))
        return results[0] if single else results

    def get_supported_languages(self) -> Optional[List[str]]:
        if self.config.support_languages:
            return sorted({str(x).lower()
                           for x in self.config.support_languages})
        return None


Model = ForcedAlignerModel
ModelConfig = ForcedAlignerConfig

__all__ = ["Model", "ModelConfig", "ForcedAlignerModel",
           "ForcedAlignerConfig", "ForceAlignProcessor", "ForcedAlignItem",
           "ForcedAlignResult", "align_bucket"]
