"""OuteTTS: a llama token-TTS over a 2-codebook DAC (Llama-OuteTTS-1.0-1B).

Counterpart of mlx_audio_tpu/tts/models/outetts/outetts.py: `ModelConfig`
(:46-50), the sentence chunks (`chunk_text`, :87-100), speaker JSON voices
(`load_speaker`), the decode (`_stepper`, `_decode_tokens`, :107-206),
`generate` with its streaming (:208-249), `_codes_to_audio` (:251-259),
`sanitize` and `post_load_hook` (:280-312). The prompt is
`prompt.PromptProcessor`'s, a copy of the JAX package's.

The model is Orpheus's (`tts/models/llama/orpheus.py`), whose stepper it
runs with OuteTTS's constants: prompt buckets from 256, a 64-token
repetition window that takes the masked token (-1 once stopped), the
penalty (1.1) always applied, and top-k 40, top-p 0.9 and min-p 0.05
draws at temperature 0.4. The decode runs as eager chunks of up to CHUNK
steps with every piece of state on the device and one read a chunk; the
last chunk runs only the steps left, where the JAX chunk runs all 32 and
writes past bucket + max_tokens (`dynamic_update_slice` clamps), tokens it
then drops, so the kept tokens are the same. A q8 checkpoint runs every
LM linear on kernel K2 (`utils.bind_checkpoint`).

A stream decodes all the codes so far at each interval of
streaming_interval x 137.5 tokens and yields the samples past those
yielded, as the JAX package does: the DAC is not causal, so this is what
makes the streamed audio equal the JAX package's.

Departures from the JAX package:

* draws come from a `torch.Generator` seeded per segment (seed + segment
  index), so only greedy decoding compares with JAX token for token;
* a c1 or c2 code past the DAC's codebook (the maps hold codes 0-1,024,
  the published codebooks 1,024 entries) is clamped into it, where JAX's
  `jnp.take` fills the gather with NaN;
* `post_load_hook` raises when the directory's tokenizer or its `codec/`
  DAC fails to load, where JAX's swallows the error and `generate` fails
  later; the DAC is held in f32 outside the module tree (`set_codec`);
* text without a tokenizer raises ValueError.
"""

from __future__ import annotations

import json
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..base import local_tokenizer
from ..llama.orpheus import Model as OrpheusModel
from ..llama.orpheus import ModelConfig as OrpheusConfig
from .prompt import PromptProcessor, normalize_text

CHUNK = 32
PROMPT_BUCKETS = (256, 512, 1024, 2048, 4096)
REP_WINDOW = 64
TOKENS_PER_SECOND = 137.5


@dataclass
class ModelConfig(OrpheusConfig):
    model_type: str = "outetts"
    tokenizer_name: str = ""
    sample_rate: int = 24000


class Model(OrpheusModel):
    """OuteTTS: text -> llama AR decode of c1/c2 code tokens -> DAC audio,
    on `device` (the card by default; without CUDA the constructor raises
    unless given `device="cpu"`)."""

    prompt_buckets = PROMPT_BUCKETS
    rep_window = REP_WINDOW

    def __init__(self, config=None, device="cuda"):
        if config is None:
            config = ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config, device=device)
        self._prompt_proc: Optional[PromptProcessor] = None

    def _require_codec(self):
        if self.codec is None:
            raise RuntimeError("no DAC codec bound (model.set_codec)")
        return self.codec

    # ------------------------------------------------------------ prompts

    def _processor(self) -> PromptProcessor:
        if self.tokenizer is None:
            raise ValueError(
                "outetts needs its HF tokenizer, and the model directory "
                "holds none (or set model.tokenizer)")
        if self._prompt_proc is None or \
                self._prompt_proc.tokenizer is not self.tokenizer:
            self._prompt_proc = PromptProcessor(self.tokenizer)
        return self._prompt_proc

    @staticmethod
    def chunk_text(text: str, max_words: int = 30) -> List[str]:
        sentences = [s.strip() for s in
                     re.split(r"[.!?。！？︕︖]+", text) if s.strip()]
        chunks, cur, n = [], [], 0
        for s in sentences:
            words = s.split()
            if n + len(words) > max_words and cur:
                chunks.append(" ".join(cur))
                cur, n = [], 0
            cur.extend(words)
            n += len(words)
        if cur:
            chunks.append(" ".join(cur))
        return chunks or [normalize_text(text)]

    def load_speaker(self, path: str) -> dict:
        return json.loads(Path(path).read_text())

    # ------------------------------------------------------------- decode

    def stop_ids(self):
        """The ids of <|audio_end|> and <|im_end|> (where each is one
        token) and the tokenizer's EOS."""
        tok = self.tokenizer
        st = self._processor().st
        stops = set()
        for s in (st.audio_end, st.eos):
            ids = tok.encode(s, add_special_tokens=False)
            if len(ids) == 1:
                stops.add(int(ids[0]))
        if getattr(tok, "eos_token_id", None) is not None:
            stops.add(int(tok.eos_token_id))
        return tuple(sorted(stops))

    def code_tokens(self, tokens: List[int]) -> int:
        """How many of `tokens` are c1 or c2 codes."""
        proc = self._processor()
        return sum(t in proc.c1 or t in proc.c2 for t in tokens)

    def _decode_tokens(self, prompt_ids: np.ndarray, max_tokens: int,
                       temperature: float, top_p: float, top_k: int,
                       min_p: float, rep_pen: float, seed: int):
        """The stepper's token lists, one a chunk (the JAX package's
        argument order)."""
        return super()._decode_tokens(prompt_ids, max_tokens, temperature,
                                      top_p, top_k, rep_pen, seed,
                                      min_p=min_p)

    # ----------------------------------------------------------- generate

    def generate(self, text: str, voice: Optional[str] = None,
                 temperature: float = 0.4, top_p: float = 0.9,
                 max_tokens: int = 1200, verbose: bool = False,
                 ref_audio=None, stream: bool = False,
                 streaming_interval: float = 2.0, seed: int = 0, **kwargs):
        """Yield GenerationResults, one a `chunk_text` segment (seed +
        segment index); with `stream`, one every streaming_interval x 137.5
        tokens (at least 1), each the samples past those yielded of a DAC
        decode of every code so far. A `voice` ending in .json is a
        speaker file. Knobs: `top_k` (40), `min_p` (0.05) and
        `repetition_penalty` (1.1) in kwargs."""
        proc = self._processor()
        speaker = None
        if voice is not None and voice.endswith(".json"):
            speaker = self.load_speaker(voice)
        top_k = int(kwargs.get("top_k", 40))
        min_p = float(kwargs.get("min_p", 0.05))
        rep_pen = float(kwargs.get("repetition_penalty", 1.1))
        interval_tokens = max(1, int(streaming_interval * TOKENS_PER_SECOND))

        for seg_idx, segment in enumerate(self.chunk_text(text)):
            prompt = proc.get_completion_prompt(segment, speaker)
            ids = np.asarray(self.tokenizer.encode(
                prompt, add_special_tokens=False), np.int32)
            t0 = time.perf_counter()
            yielded_tokens = yielded_frames = 0
            final_tokens: List[int] = []
            for generated in self._decode_tokens(
                    ids, max_tokens, temperature, top_p, top_k, min_p,
                    rep_pen, seed + seg_idx):
                final_tokens = generated
                if stream and (len(generated) - yielded_tokens
                               >= interval_tokens):
                    audio = self._codes_to_audio(generated)
                    if audio is not None and len(audio) > yielded_frames:
                        yield self._result(audio[yielded_frames:], t0,
                                           len(generated) - yielded_tokens,
                                           seg_idx)
                        yielded_tokens = len(generated)
                        yielded_frames = len(audio)
                        t0 = time.perf_counter()
            audio = self._codes_to_audio(final_tokens)
            if audio is not None and len(audio) > yielded_frames:
                yield self._result(audio[yielded_frames:], t0,
                                   len(final_tokens) - yielded_tokens,
                                   seg_idx)

    def _codes_to_audio(self, tokens: List[int]) -> Optional[np.ndarray]:
        """The c1/c2 codes of `tokens` through the DAC -> samples, or None
        without a code pair."""
        codes = self._processor().extract_audio_from_tokens(tokens)
        if not codes[0]:
            return None
        codec = self._require_codec()
        size = codec.config.codebook_size
        c = torch.as_tensor(np.clip(np.asarray(codes, np.int64), 0,
                                    size - 1)[None], device=codec.device)
        audio = codec.decode(codec.from_codes(c))
        return audio.reshape(-1).float().cpu().numpy()

    # ------------------------------------------------------------ loading

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (None without tokenizer files or
        `transformers`) and the DAC of its `codec/` subfolder
        (`codec.utils.load_model`, on the model's device, f32); a tokenizer
        or codec that fails to load raises."""
        from ....codec.utils import load_model as load_codec

        model_path = Path(model_path)
        model.tokenizer = local_tokenizer(model_path)
        if (model_path / "codec").exists():
            model.set_codec(load_codec(
                model_path / "codec", device=model.device,
                model_remapping={"dac": "descript", "descript": "descript"}))
        return model


__all__ = ["Model", "ModelConfig", "CHUNK", "PROMPT_BUCKETS", "REP_WINDOW"]
