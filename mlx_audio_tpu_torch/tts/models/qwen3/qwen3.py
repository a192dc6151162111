"""Qwen3 token-TTS (VyvoTTS): a Qwen3 LM emitting SNAC-interleaved codes.

Counterpart of mlx_audio_tpu/tts/models/qwen3/qwen3.py: the special ids
(:40-50), `parse_output` (:90-98; its `interleave_snac_codes` and
`deinterleave_snac_codes`, :57-87, are Orpheus's code helpers, shared in
`codec/models/snac/codes.py`), and `Model` (:101-307): the prompt
(`prepare_zeroprompt`, `prepare_input_ids`), `_decode_snac`, `generate`
whole and streamed, `sanitize` and `post_load_hook`. The LM is MOSS-TTS's
Qwen3 LM (`model.embed_tokens`, `model.layers.N`, `model.norm`, and
`lm_head` unless tied) under the shared decode stepper
`stt.models.qwen3_lm` (the repetition penalty over the last 20 tokens on
the device), over the port's SNAC (`codec/models/snac`).

A streamed request emits, every streaming_interval x 137.5 tokens (at
least 7), the samples past those already sent of the SNAC decode of every
code so far, as the JAX package does; here each emission is yielded once
its decode chunk has been read, where JAX's collects them until the
request's decode ends.

Departures from the JAX package:

* draws come from a `torch.Generator` seeded per segment (seed + segment
  index): only greedy decoding compares with JAX token for token;
* `generate` raises when no SNAC is bound (`set_codec`, or the model
  directory's `snac/` or `codec/` subfolder, which `post_load_hook` binds),
  where JAX's `_decode_snac` returns silence; each code is clamped into
  its codebook (JAX's SNAC gathers a code outside it as NaN audio);
* `post_load_hook` raises on tokenizer files or a codec that fail to
  load, where JAX's swallows the tokenizer's error and binds no codec.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Generator, List, Optional, Union

import numpy as np
import torch

from ....codec.models.snac.codes import flat_codes_to_layers, \
    layers_to_flat_codes
from ....model import TorchModel, check_device
from ....nn import Linear
from ....stt.models.qwen3_lm import iter_decode, make_decode_fns, \
    prompt_bucket
from ..base import GenerationResult, format_duration, local_tokenizer, \
    peak_memory_gb
from ..moss_tts.config import Qwen3LMConfig
from ..moss_tts.moss_tts import Qwen3LM, lm_logits, qwen3_lm_forward

TOKENIZER_LENGTH = 151669
START_OF_TEXT = 151643
END_OF_TEXT = 151645
START_OF_SPEECH = TOKENIZER_LENGTH + 1
END_OF_SPEECH = TOKENIZER_LENGTH + 2
START_OF_HUMAN = TOKENIZER_LENGTH + 3
END_OF_HUMAN = TOKENIZER_LENGTH + 4
START_OF_AI = TOKENIZER_LENGTH + 5
END_OF_AI = TOKENIZER_LENGTH + 6
PAD_TOKEN = TOKENIZER_LENGTH + 7
AUDIO_TOKENS_START = TOKENIZER_LENGTH + 10
TOKENS_PER_SECOND = 137.5


@dataclass
class ModelConfig(Qwen3LMConfig):
    pass


def parse_output(ids: List[int]) -> List[int]:
    """Crop after the last START_OF_SPEECH, drop END_OF_SPEECH, trim to a
    multiple of 7, rebase to SNAC ids (ref parse_output :117-160)."""
    starts = [i for i, t in enumerate(ids) if t == START_OF_SPEECH]
    if starts:
        ids = ids[starts[-1] + 1:]
    ids = [t for t in ids if t != END_OF_SPEECH]
    ids = ids[:(len(ids) // 7) * 7]
    return [t - AUDIO_TOKENS_START for t in ids]


class Model(TorchModel):
    """VyvoTTS (Qwen3 + SNAC) on `device`: the card by default; without
    CUDA the constructor raises unless given `device="cpu"`."""

    SAMPLE_RATE = 24000

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = ModelConfig.from_dict(kwargs) if kwargs else \
                ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        with torch.device(device):
            self.model = Qwen3LM(config)
            if not config.tie_word_embeddings:
                self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                      bias=False)
        self.tokenizer = None
        self.__dict__["_codec"] = None
        self._fns: dict = {}
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return self.SAMPLE_RATE

    @property
    def codec(self):
        return self.__dict__["_codec"]

    snac = codec

    def set_codec(self, codec) -> "Model":
        """Bind a SNAC (kept out of the module tree, so `astype` and
        `state_dict` leave it alone)."""
        self.__dict__["_codec"] = codec
        return self

    def _require_codec(self):
        if self.codec is None:
            raise RuntimeError("VyvoTTS needs its SNAC codec: bind one with "
                               "model.set_codec, or load a directory with "
                               "a snac/ subfolder")
        return self.codec

    def sanitize(self, weights):
        out = {}
        for k, v in weights.items():
            if k.endswith("rotary_emb.inv_freq"):
                continue
            if k == "lm_head.weight" and self.config.tie_word_embeddings:
                continue
            out[k] = v
        return out

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (None without tokenizer files or
        `transformers`) and the SNAC of its `snac/` or `codec/` subfolder
        (on the model's device, f32); either failing to load raises."""
        from ....codec.utils import load_model as load_codec

        model_path = Path(model_path)
        model.tokenizer = local_tokenizer(model_path)
        for sub in ("snac", "codec"):
            if (model_path / sub).exists():
                model.set_codec(load_codec(model_path / sub,
                                           device=model.device,
                                           model_remapping={"snac": "snac"}))
                break
        return model

    # ------------------------------------------------------------ decode

    def _forward(self, embeds, caches, offset, pad_mask):
        return qwen3_lm_forward(self.model, embeds, caches, offset, pad_mask)

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return lm_logits(self, hidden)

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed_tokens(ids)

    # ------------------------------------------------------------ prompt

    def _encode_text(self, text: str) -> List[int]:
        if self.tokenizer is None:
            raise RuntimeError("tokenizer not initialized")
        return list(self.tokenizer.encode(text))

    def prepare_zeroprompt(self, ref_audio: np.ndarray, ref_text: str
                           ) -> List[int]:
        layers = self._require_codec().encode(
            np.asarray(ref_audio, np.float32)[None, None])
        audio_ids = (layers_to_flat_codes(layers)
                     + AUDIO_TOKENS_START).tolist()
        return ([START_OF_HUMAN] + self._encode_text(ref_text)
                + [END_OF_TEXT, END_OF_HUMAN, START_OF_AI, START_OF_SPEECH]
                + audio_ids + [END_OF_SPEECH, END_OF_AI])

    def prepare_input_ids(self, prompt: str, voice: Optional[str] = None,
                          zeroprompt: Optional[List[int]] = None
                          ) -> List[int]:
        if voice is not None and zeroprompt is None:
            prompt = f"{voice}: {prompt}"
        ids = ([START_OF_HUMAN] + self._encode_text(prompt)
               + [END_OF_TEXT, END_OF_HUMAN])
        return (zeroprompt or []) + ids

    # ---------------------------------------------------------- generate

    def _decode_snac(self, code_list: List[int]) -> np.ndarray:
        """Flat SNAC ids (7 a frame) -> audio, each code clamped into its
        codebook."""
        if not code_list:
            return np.zeros((0,), np.float32)
        codec = self._require_codec()
        size = codec.config.codebook_size
        layers = [np.clip(x, 0, size - 1)
                  for x in flat_codes_to_layers(code_list)]
        audio = codec.decode(layers)
        return audio.reshape(-1).float().cpu().numpy()

    def _fns_for(self, bucket: int, max_new: int, temperature: float,
                 top_p: float, top_k: int, rep: float, rep_ctx: int):
        key = ("lm", bucket, max_new, temperature, top_p, top_k, rep,
               rep_ctx)
        fns = self._fns.get(key)
        if fns is None:
            cfg = self.config
            fns = make_decode_fns(
                text_config=cfg, embed_fn=self._embed,
                logits_fn=self._logits, forward_fn=self._forward,
                make_caches=lambda cols: self.model.make_caches(cfg, 1,
                                                                cols),
                bucket=bucket, max_new=max_new, temperature=temperature,
                top_p=top_p, top_k=top_k, eos_ids=(END_OF_SPEECH,),
                repetition_penalty=rep, repetition_context_size=rep_ctx)
            self._fns = {key: fns}
        return fns

    @torch.inference_mode()
    def _prompt_embeds(self, ids: List[int], bucket: int) -> torch.Tensor:
        padded = torch.zeros(1, bucket, dtype=torch.long)
        padded[0, :len(ids)] = torch.as_tensor(ids, dtype=torch.long)
        return self._embed(padded.to(self.device))

    def generate(self, text: str, voice: Optional[str] = None,
                 temperature: float = 0.6, top_p: float = 0.8,
                 split_pattern: str = "\n", max_tokens: int = 1200,
                 ref_audio=None, ref_text: Optional[str] = None,
                 stream: bool = False, streaming_interval: float = 2.0,
                 seed: int = 0, verbose: bool = False, **kwargs
                 ) -> Generator[GenerationResult, None, None]:
        """Yield one GenerationResult a `split_pattern` segment (seed +
        segment index), or with `stream` one every streaming_interval x
        137.5 tokens and a final one. ref_audio with ref_text clones a
        voice through the zeroprompt. Knobs in kwargs: `top_k` (0),
        `repetition_penalty` (1.3), `repetition_context_size` (20).
        `last_run` holds the last segment's decode (see
        `qwen3_lm.iter_decode`) and how many of its tokens are SNAC codes
        (`code_tokens`)."""
        if self.tokenizer is None:
            raise RuntimeError("tokenizer not initialized")
        self._require_codec()
        if isinstance(ref_audio, (str, Path)):
            from ....utils import load_audio

            ref_audio = load_audio(ref_audio, sample_rate=self.sample_rate)
        zeroprompt = None
        if ref_audio is not None and ref_text is not None:
            zeroprompt = self.prepare_zeroprompt(ref_audio, ref_text)

        prompts = [p for p in text.replace("\\n", "\n").replace("\\t", "\t")
                   .split(split_pattern) if p.strip()]
        rep = float(kwargs.get("repetition_penalty", 1.3))
        rep_ctx = int(kwargs.get("repetition_context_size", 20))
        top_k = int(kwargs.get("top_k", 0) or 0)
        interval_toks = max(int(streaming_interval * TOKENS_PER_SECOND), 7)

        for seg_idx, seg in enumerate(prompts):
            t0 = time.perf_counter()
            ids = self.prepare_input_ids(seg, voice, zeroprompt)
            n = len(ids)
            pb = prompt_bucket(n)
            fns = self._fns_for(pb, max(max_tokens, 512), temperature,
                                top_p, top_k, rep, rep_ctx)
            emitted = {"samples": 0, "tokens": 0}
            tokens: List[int] = []
            run: dict = {}
            for new in iter_decode(fns, self._prompt_embeds(ids, pb), n,
                                   max_tokens=max_tokens,
                                   seed=seed + seg_idx, run=run):
                for tok in new:
                    tokens.append(tok)
                    if not stream or len(tokens) % interval_toks:
                        continue
                    audio = self._decode_snac(parse_output(ids + tokens))
                    if len(audio) > emitted["samples"]:
                        yield self._result(
                            audio[emitted["samples"]:], seg_idx,
                            len(tokens) - emitted["tokens"], t0,
                            streaming=True)
                        emitted["samples"] = len(audio)
                        emitted["tokens"] = len(tokens)
            run["code_tokens"] = sum(
                AUDIO_TOKENS_START <= t < AUDIO_TOKENS_START + 7 * 4096
                for t in tokens)
            self.last_run = run
            audio = self._decode_snac(parse_output(ids + tokens))
            if len(audio) > emitted["samples"]:
                yield self._result(audio[emitted["samples"]:], seg_idx,
                                   len(tokens) - emitted["tokens"], t0,
                                   final=True)

    def stream_generate(self, text: str, voice: Optional[str] = None,
                        **kwargs):
        """`generate` with stream=True."""
        kwargs["stream"] = True
        yield from self.generate(text, voice=voice, **kwargs)

    def _result(self, audio, seg, n_tokens, t0, streaming=False,
                final=False) -> GenerationResult:
        dt = max(time.perf_counter() - t0, 1e-6)
        dur = len(audio) / self.sample_rate
        return GenerationResult(
            audio=np.asarray(audio), samples=len(audio),
            sample_rate=self.sample_rate, segment_idx=seg,
            token_count=n_tokens, audio_duration=format_duration(dur),
            real_time_factor=round(dur / dt, 3),
            prompt={"tokens": n_tokens,
                    "tokens-per-sec": round(n_tokens / dt, 2)},
            audio_samples={"samples": len(audio),
                           "samples-per-sec": round(len(audio) / dt, 2)},
            processing_time_seconds=dt, peak_memory_usage=peak_memory_gb(),
            is_streaming_chunk=streaming, is_final_chunk=final)


__all__ = ["Model", "ModelConfig", "parse_output", "START_OF_SPEECH",
           "END_OF_SPEECH", "AUDIO_TOKENS_START", "TOKENS_PER_SECOND"]
