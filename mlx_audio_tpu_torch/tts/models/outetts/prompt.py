"""OuteTTS prompt construction and audio-token extraction (host code).

The port's copy of mlx_audio_tpu/tts/models/outetts/prompt.py:
`SpecialTokens` (the literal vocabulary strings the checkpoints were
trained with), `normalize_text`, and `PromptProcessor` with its c1/c2
token-id maps, per-word code blocks, CJK-aware speaker-text merging, the
completion prompt and `extract_audio_from_tokens`. It imports nothing of
JAX; tests/test_torch_outetts.py holds it to the JAX package's.
"""

from __future__ import annotations

import re
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class SpecialTokens:
    bos: str = "<|im_start|>"
    eos: str = "<|im_end|>"
    c1: str = "<|c1_{}|>"
    c2: str = "<|c2_{}|>"
    text_start: str = "<|text_start|>"
    text_end: str = "<|text_end|>"
    audio_start: str = "<|audio_start|>"
    audio_end: str = "<|audio_end|>"
    time: str = "<|t_{:.2f}|>"
    code: str = "<|code|>"
    energy: str = "<|energy_{}|>"
    spectral_centroid: str = "<|spectral_centroid_{}|>"
    pitch: str = "<|pitch_{}|>"
    word_start: str = "<|word_start|>"
    word_end: str = "<|word_end|>"
    features: str = "<|features|>"
    global_features_start: str = "<|global_features_start|>"
    global_features_end: str = "<|global_features_end|>"

    def to_dict(self) -> Dict[str, str]:
        return asdict(self)


def normalize_text(text: str) -> str:
    text = re.sub(r"\s+", " ", text).replace("…", "...")
    text = text.strip()
    text = re.sub(r"[“”]", '"', text)
    text = re.sub(r"[‘’]", "'", text)
    text = re.sub(r"[–—]", "-", text)
    return re.sub(r"[\x00-\x1F\x7F-\x9F]", "", text)


class PromptProcessor:
    def __init__(self, tokenizer):
        self.st = SpecialTokens()
        self.tokenizer = tokenizer
        self.c1: Dict[int, int] = {}
        self.c2: Dict[int, int] = {}
        if tokenizer is not None:
            for i in range(1025):
                self.c1[self._tok_id(self.st.c1.format(i))] = i
                self.c2[self._tok_id(self.st.c2.format(i))] = i

    def _tok_id(self, s: str) -> int:
        return self.tokenizer.encode(s, add_special_tokens=False)[0]

    # prompt assembly ---------------------------------------------------

    def _features(self, f: dict) -> List[str]:
        return [f"<|{k}_{f.get(k, 0)}|>"
                for k in ("energy", "spectral_centroid", "pitch")]

    def create_codes(self, words: List[dict]) -> str:
        out = []
        for w in words:
            body = (w["word"] + self.st.features
                    + self.st.time.format(w["duration"]))
            body += "".join(self._features(w.get("features", {})))
            pairs = [self.st.c1.format(a) + self.st.c2.format(b)
                     for a, b in zip(w["c1"], w["c2"])]
            body += self.st.code + "".join(pairs)
            out.append(self.st.word_start + body + self.st.word_end)
        return "\n".join(out)

    @staticmethod
    def _separator_for(text: str) -> str:
        cjk = any("぀" <= c <= "ヿ" or "一" <= c <= "鿿"
                  for c in text)
        return "。" if cjk else ". "

    def merge_speaker_text(self, input_text: str, speaker_text: str
                           ) -> Tuple[str, str]:
        speaker_text = speaker_text.strip()
        sep = self._separator_for(speaker_text)
        ends = ["。", "？", "！", "?", "!"] if sep == "。" else [".", "?", "!"]
        rs = ""
        if speaker_text:
            if speaker_text[-1] not in ends:
                rs = sep
            elif sep != "。":
                rs = " "
        return speaker_text + rs + input_text.strip(), rs.strip()

    def get_completion_prompt(self, text: str,
                              speaker: Optional[dict] = None) -> str:
        text = normalize_text(text)
        codes = None
        if speaker is not None:
            text, sep = self.merge_speaker_text(text, speaker["text"])
            words = [dict(w) for w in speaker["words"]]
            words[-1]["word"] += sep
            codes = self.create_codes(words)
        prompt = (f"{self.st.bos}\n{self.st.text_start}{text}"
                  f"{self.st.text_end}\n{self.st.audio_start}\n")
        if codes is not None:
            prompt += codes + "\n" + self.st.word_start
        return prompt

    # extraction --------------------------------------------------------

    def extract_audio_from_tokens(self, tokens: List[int]
                                  ) -> List[List[int]]:
        cb1 = [self.c1[t] for t in tokens if t in self.c1]
        cb2 = [self.c2[t] for t in tokens if t in self.c2]
        n = min(len(cb1), len(cb2))
        return [cb1[:n], cb2[:n]]
