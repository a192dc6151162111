"""Orpheus token-TTS over SNAC (model_type "llama"; `orpheus` and `svara`
route here too).

Counterpart of mlx_audio_tpu/tts/models/llama/orpheus.py: the special ids
and constants (:40-53), `flat_codes_to_layers` / `layers_to_flat_codes`
(:57-86, in `codec/models/snac/codes.py`, shared with VyvoTTS),
`ModelConfig` (:89-93), the prompt methods `_encode_text`,
`encode_audio_to_codes`, `prepare_zeroprompt`, `prepare_input_ids`,
`parse_codes` (:118-163), the decode (`_stepper`, `_decode_tokens`,
:167-254), `generate` and `stream_generate` (:258-328), `_clip_codes`,
`_decode_audio_stream`, `_result`, `sanitize` and `post_load_hook`
(:330-399). The model is the port's llama backbone (`llama.Model`), so its
parameters are the JAX tree's: `model.embed_tokens`, `model.layers.N.*`,
`model.norm`, and `lm_head` unless the embeddings are tied.

The prompt is [SOH] text [EOT EOH], a "voice: " prefix before the text,
and a zeroprompt ([SOH] ref_text [EOT EOH] [SOA SOS] codes [EOS_SPEECH
EOA]) in front for cloning. Generated SNAC codes follow the last SOS, seven
a frame, each slot k offset by k x 4096 past CODE_OFFSET.

The decode, which the JAX package runs as a `lax.scan` of CHUNK tokens,
runs here as eager chunks of up to CHUNK steps with every piece of state on
the device: the prefill over the prompt's bucket into f32 caches of
bucket + ceil(max_tokens / CHUNK) x CHUNK columns under an additive pad
mask, then a step per token: the repetition penalty over the last
REP_WINDOW tokens (padded with -1), the draw, the stop on EOS_SPEECH or
the tokenizer's EOS, tokens from the stop on masked to -1, the next logits.
The host reads the chunk's tokens and the stop flag once a chunk. OuteTTS
(`tts/models/outetts`) subclasses this `Model` and runs the same stepper
with its own `prompt_buckets`, `rep_window`, `stop_ids` and `code_tokens`.

Departures from the JAX package:

* draws come from a `torch.Generator` seeded per segment (seed + segment
  index), so only greedy decoding (temperature 0) compares with JAX token
  for token; the last chunk runs only the steps left, where JAX runs a
  whole chunk and drops the rest;
* `post_load_hook` raises when the directory's tokenizer or its `snac/`
  (or `codec/`) codec fails to load, where JAX's swallows the error and
  `generate` fails later; the codec is held in f32 outside the module tree
  (`set_codec`), whatever the model's dtype;
* text without a tokenizer raises ValueError.

The backbone rotates by Llama-3's scaled frequencies where the config's
`rope_scaling` names llama3, as Orpheus-3B's (Llama-3.2) does; the JAX
package drops the field and rotates by the plain ones
(`llama.llama_inv_freq`).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ....codec.models.snac.codes import flat_codes_to_layers, \
    layers_to_flat_codes
from ....ops.sampling import apply_repetition_penalty, sample
from ..base import GenerationResult, format_duration, local_tokenizer, \
    peak_memory_gb
from .llama import Model as BackboneModel
from .llama import ModelConfig as LlamaConfig
from .llama import decode_step, init_caches, llama_forward, \
    logits_from_hidden

# Orpheus special token ids
SOH = 128259          # start of human turn
EOT = 128009          # end of text
EOH = 128260          # end of human turn
SOA = 128261          # start of audio
SOS = 128257          # start of speech codes
EOS_SPEECH = 128258   # end of speech codes
EOA = 128262          # end of audio
CODE_OFFSET = 128266  # first SNAC code token id

CHUNK = 32
PROMPT_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
REP_WINDOW = 20
TOKENS_PER_SECOND = 137.5


@dataclass
class ModelConfig(LlamaConfig):
    model_type: str = "llama"
    tokenizer_name: str = ""
    sample_rate: int = 24000


class Model(BackboneModel):
    """Orpheus: text -> llama AR decode of SNAC codes -> SNAC audio, on
    `device` (the card by default; without CUDA the constructor raises
    unless given `device="cpu"`)."""

    # the stepper's constants (OuteTTS's subclass sets its own)
    prompt_buckets = PROMPT_BUCKETS
    rep_window = REP_WINDOW

    def __init__(self, config=None, device="cuda"):
        if config is None:
            config = ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config, device=device)
        self.tokenizer = None
        self.__dict__["_codec"] = None
        self.last_run: dict = {}

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def codec(self):
        return self.__dict__["_codec"]

    def set_codec(self, codec) -> "Model":
        """Bind a SNAC (kept out of the module tree, so `astype` and
        `state_dict` leave it alone)."""
        self.__dict__["_codec"] = codec
        return self

    def _require_codec(self):
        if self.codec is None:
            raise RuntimeError("no SNAC codec bound (model.set_codec)")
        return self.codec

    # ------------------------------------------------------------ prompts

    def _encode_text(self, text: str) -> List[int]:
        if self.tokenizer is None:
            raise ValueError(
                "orpheus/llama TTS needs its HF tokenizer, and the model "
                "directory holds none (or set model.tokenizer)")
        return list(self.tokenizer.encode(text))

    def encode_audio_to_codes(self, audio) -> np.ndarray:
        """A reference waveform -> its flat offset codes."""
        layers = self._require_codec().encode(
            np.asarray(audio, np.float32)[None, None])
        return layers_to_flat_codes(layers)

    def prepare_zeroprompt(self, ref_audio, ref_text: str) -> List[int]:
        """[SOH] ref_text [EOT EOH] [SOA SOS] codes [EOS_SPEECH EOA]."""
        codes = (self.encode_audio_to_codes(ref_audio) + CODE_OFFSET).tolist()
        return ([SOH] + self._encode_text(ref_text) + [EOT, EOH]
                + [SOA, SOS] + codes + [EOS_SPEECH, EOA])

    def prepare_input_ids(self, prompt: str, voice: Optional[str] = None,
                          zeroprompt: Optional[List[int]] = None
                          ) -> np.ndarray:
        """[zeroprompt] [SOH] ["voice: "]text [EOT EOH] (the voice prefix
        only without a zeroprompt)."""
        if voice is not None and zeroprompt is None:
            prompt = f"{voice}: {prompt}"
        ids = [SOH] + self._encode_text(prompt) + [EOT, EOH]
        if zeroprompt is not None:
            ids = list(zeroprompt) + ids
        return np.asarray(ids, np.int32)

    @staticmethod
    def parse_codes(token_ids) -> np.ndarray:
        """Tokens -> flat offset codes: the tokens after the last SOS,
        EOS_SPEECH dropped, trimmed to whole 7-token frames, less
        CODE_OFFSET."""
        arr = np.asarray(token_ids, np.int64)
        sos = np.flatnonzero(arr == SOS)
        if len(sos):
            arr = arr[sos[-1] + 1:]
        arr = arr[arr != EOS_SPEECH]
        arr = arr[: (len(arr) // 7) * 7]
        return arr - CODE_OFFSET

    # ------------------------------------------------------------- decode

    def stop_ids(self) -> Tuple[int, ...]:
        stops = {EOS_SPEECH}
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is not None:
            stops.add(int(eos))
        return tuple(sorted(stops))

    @torch.no_grad()
    def prefill(self, prompt_ids: np.ndarray, max_tokens: int):
        """The prompt, right-padded to its bucket, into f32 caches of
        bucket + ceil(max_tokens / CHUNK) x CHUNK columns under an additive
        pad mask. -> (logits of the last prompt row (1, V) f32, caches,
        the bucket)."""
        n = len(prompt_ids)
        bucket = next((b for b in self.prompt_buckets if n <= b),
                      ((n + 511) // 512) * 512)
        cap = bucket + -(-max_tokens // CHUNK) * CHUNK
        dev = self.device
        prompt = torch.zeros(1, bucket, dtype=torch.long)
        prompt[0, :n] = torch.as_tensor(np.asarray(prompt_ids),
                                        dtype=torch.long)
        caches = init_caches(self.config, 1, cap, torch.float32, dev)
        pad = torch.zeros(1, cap, device=dev)
        pad[:, n:] = float("-inf")
        hidden, _ = llama_forward(self, prompt.to(dev), caches=caches,
                                  offset=0, mask=pad)
        logits = logits_from_hidden(self, hidden[:, n - 1:n])[:, 0]
        return logits.float(), caches, bucket

    @torch.no_grad()
    def chunk(self, state: dict, n: int, sampler, stops: torch.Tensor,
              rep_pen: float) -> torch.Tensor:
        """n eager steps from `state` (logits, caches, history, done, t;
        advanced in place). -> (1, n + 1) int64 on the device: the n tokens
        (-1 from the stop on) and the stop flag, for one read."""
        toks = []
        for _ in range(n):
            lg = apply_repetition_penalty(state["logits"], state["history"],
                                          rep_pen)
            nxt = sampler(lg)
            state["done"] = state["done"] | (nxt[:, None] == stops).any(-1)
            out = torch.where(state["done"], -1, nxt)
            state["history"] = torch.cat([state["history"][:, 1:],
                                          out[:, None]], dim=1)
            logits, _ = decode_step(self, nxt[:, None], state["caches"],
                                    state["t"])
            state["logits"] = logits.float()
            state["t"] += 1
            toks.append(out)
        return torch.cat([torch.stack(toks, dim=1),
                          state["done"][:, None].long()], dim=1)

    def code_tokens(self, tokens: List[int]) -> int:
        """How many of `tokens` are SNAC codes."""
        return sum(CODE_OFFSET <= t < CODE_OFFSET + 7 * 4096 for t in tokens)

    def _decode_tokens(self, prompt_ids: np.ndarray, max_tokens: int,
                       temperature: float, top_p: float, top_k: int,
                       rep_pen: float, seed: int, min_p: float = 0.0):
        """Yields the generated tokens so far, a list, once a chunk.
        `last_run` holds the prompt's length and bucket, the chunks and
        steps run, the tokens kept, how many of them are codes
        (`code_tokens`), and each chunk's wall ms up to its read (the
        first's with the prefill)."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        stops = torch.tensor(self.stop_ids(), device=dev)

        def sampler(logits):
            return sample(logits, temperature, top_k=top_k, top_p=top_p,
                          generator=gen, min_p=min_p)

        t_start = time.perf_counter()
        logits, caches, bucket = self.prefill(prompt_ids, max_tokens)
        state = {"logits": logits, "caches": caches,
                 "history": torch.full((1, self.rep_window), -1,
                                       dtype=torch.long, device=dev),
                 "done": torch.zeros(1, dtype=torch.bool, device=dev),
                 "t": len(prompt_ids)}
        generated: List[int] = []
        chunk_ms: List[float] = []
        steps = codes = 0
        t_last = t_start
        while steps < max_tokens:
            n = min(CHUNK, max_tokens - steps)
            read = self.chunk(state, n, sampler, stops, rep_pen)[0].tolist()
            now = time.perf_counter()
            chunk_ms.append((now - t_last) * 1e3)
            t_last = now
            steps += n
            new = [t for t in read[:n] if t >= 0]
            generated.extend(new)
            codes += self.code_tokens(new)
            self.last_run = {"prompt_len": len(prompt_ids),
                             "prompt_bucket": bucket,
                             "chunks": len(chunk_ms), "steps": steps,
                             "tokens": len(generated), "code_tokens": codes,
                             "chunk_ms": chunk_ms}
            yield list(generated)
            if read[n]:
                break

    # ----------------------------------------------------------- generate

    def generate(self, text: str, voice: Optional[str] = None,
                 temperature: float = 0.6, top_p: float = 0.8,
                 split_pattern: str = "\n", max_tokens: int = 1200,
                 verbose: bool = False, ref_audio=None,
                 ref_text: Optional[str] = None, stream: bool = False,
                 streaming_interval: float = 2.0, seed: int = 0, **kwargs):
        """Yield GenerationResults, one a `split_pattern` segment (seed +
        segment index); with `stream`, one every streaming_interval x 137.5
        tokens (at least 7), each the new whole frames through SNAC's
        `decode_stream` with 8 latent frames of context. ref_audio with
        ref_text clones a voice through the zeroprompt. Knobs: `top_k`
        (0) and `repetition_penalty` (1.3) in kwargs."""
        if ref_audio is not None and not isinstance(ref_audio, np.ndarray):
            from ....utils import load_audio

            ref_audio = load_audio(ref_audio, sample_rate=self.sample_rate)
        prompt_text = text.replace("\\n", "\n").replace("\\t", "\t")
        prompts = [p for p in re.split(re.escape(split_pattern), prompt_text)
                   if p.strip()] or [prompt_text]
        zeroprompt = None
        if ref_audio is not None and ref_text is not None:
            zeroprompt = self.prepare_zeroprompt(np.asarray(ref_audio),
                                                 ref_text)
        top_k = int(kwargs.get("top_k", 0) or 0)
        rep_pen = float(kwargs.get("repetition_penalty", 1.3))
        interval_tokens = max(7, int(streaming_interval * TOKENS_PER_SECOND))

        for seg_idx, segment in enumerate(prompts):
            input_ids = self.prepare_input_ids(segment, voice, zeroprompt)
            prompt_list = input_ids.tolist()
            t0 = time.perf_counter()
            yielded_tokens = consumed_codes = 0
            context = None
            final_tokens: List[int] = []
            for generated in self._decode_tokens(
                    input_ids, max_tokens, temperature, top_p, top_k,
                    rep_pen, seed + seg_idx):
                final_tokens = generated
                if stream and (len(generated) - yielded_tokens
                               >= interval_tokens):
                    new = self.parse_codes(prompt_list + generated)[
                        consumed_codes:]
                    if len(new) >= 7:
                        audio, context = self._decode_audio_stream(new,
                                                                   context)
                        if len(audio) > 0:
                            yield self._result(
                                audio, t0, len(generated) - yielded_tokens,
                                seg_idx)
                            yielded_tokens = len(generated)
                            consumed_codes += (len(new) // 7) * 7
                            t0 = time.perf_counter()
            codes = self.parse_codes(prompt_list + final_tokens)
            if stream:
                new = codes[consumed_codes:]
                if len(new) >= 7:
                    audio, _ = self._decode_audio_stream(new, context)
                    if len(audio) > 0:
                        yield self._result(
                            audio, t0, len(final_tokens) - yielded_tokens,
                            seg_idx)
            elif len(codes) >= 7:
                codec = self._require_codec()
                layers = flat_codes_to_layers(self._clip_codes(codes))
                audio = codec.decode(layers).reshape(-1).float().cpu().numpy()
                yield self._result(audio, t0, len(final_tokens), seg_idx)

    def stream_generate(self, text: str, voice: Optional[str] = None,
                        **kwargs):
        """`generate` with stream=True."""
        kwargs["stream"] = True
        yield from self.generate(text, voice=voice, **kwargs)

    def _clip_codes(self, codes: np.ndarray) -> np.ndarray:
        """Each slot's code clamped into the codebook (a random or
        degenerate draw may fall outside it)."""
        size = (self.codec.config.codebook_size if self.codec is not None
                else 4096)
        frames = codes.reshape(-1, 7)
        slots = np.arange(7) * 4096
        return (np.clip(frames - slots, 0, size - 1) + slots).reshape(-1)

    def _decode_audio_stream(self, new_codes: np.ndarray, context
                             ) -> Tuple[np.ndarray, object]:
        codec = self._require_codec()
        new_codes = new_codes[: (len(new_codes) // 7) * 7]
        layers = flat_codes_to_layers(self._clip_codes(new_codes))
        audio, context = codec.decode_stream(layers, context,
                                             context_frames=8)
        return audio.reshape(-1).float().cpu().numpy(), context

    def _result(self, audio: np.ndarray, t0: float, token_count: int,
                seg_idx: int) -> GenerationResult:
        dt = time.perf_counter() - t0
        dur = len(audio) / self.sample_rate
        return GenerationResult(
            audio=audio, samples=len(audio), sample_rate=self.sample_rate,
            segment_idx=seg_idx, token_count=token_count,
            audio_duration=format_duration(dur),
            real_time_factor=round(dur / dt, 2) if dt else 0.0,
            prompt={"tokens": token_count,
                    "tokens-per-sec": round(token_count / dt, 2)
                    if dt else 0.0},
            audio_samples={"samples": len(audio),
                           "samples-per-sec": round(len(audio) / dt, 2)
                           if dt else 0.0},
            processing_time_seconds=dt, peak_memory_usage=peak_memory_gb())

    # ------------------------------------------------------------ loading

    def sanitize(self, weights):
        """HF names -> this tree: rotary buffers dropped, `model.model.*`
        and `model.lm_head` lose one `model.`, bare layer names gain it."""
        out = {}
        for k, v in weights.items():
            if k.endswith("rotary_emb.inv_freq"):
                continue
            if k.startswith("model.model.") or k.startswith("model.lm_head"):
                k = k[len("model."):]
            elif not k.startswith("model.") and not k.startswith("lm_head"):
                k = "model." + k
            out[k] = v
        return out

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (None without tokenizer files or
        `transformers`) and the SNAC of its `snac/` or `codec/` subfolder
        (`codec.utils.load_model`, on the model's device, f32); a tokenizer
        or codec that fails to load raises."""
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


__all__ = ["Model", "ModelConfig", "flat_codes_to_layers",
           "layers_to_flat_codes", "SOH", "EOT", "EOH", "SOA", "SOS",
           "EOS_SPEECH", "EOA", "CODE_OFFSET", "CHUNK", "PROMPT_BUCKETS",
           "REP_WINDOW", "TOKENS_PER_SECOND"]
