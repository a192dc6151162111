"""VibeVoice-ASR: long-form diarized transcription (JSON segments) from two
causal sigma-VAE tokenizer encoders and a Qwen2.5 LM on the llama
backbone.

Counterpart of mlx_audio_tpu/stt/models/vibevoice_asr/vibevoice_asr.py:

* the configs (`TokenizerConfig`, `ModelConfig`, :80-126);
* the tokenizer encoders, acoustic and semantic (`_causal_conv` :185-194,
  `tokenizer_encode` :196-223): a causal conv stem, stages of depthwise
  mixer blocks with RMSNorms, layer scales and GELU FFNs, a causal
  downsampling conv between stages (x3,200 in all at the default ratios),
  a causal head conv; their connectors (:225-228) and
  `speech_token_count` (:231-238);
* `_normalize_audio` and `_preprocess_audio` (:264-292: -25 dBFS, the
  59-minute cap), `encode_speech` (:294-318), the ChatML prompt over
  Qwen2.5's repurposed special tokens (:320-350), `generate` with its
  repetition penalty over the last 100 tokens and `stream_transcribe`
  (:351-519), `parse_transcription` (:520-563, host code, copied),
  `sanitize` and `post_load_hook` (:565-627).

Departures (besides `llm_stt`'s):

* the encoders run the samples' own length, not SAMPLE_BUCKETS of them (a
  TPU workaround). The pyramid is causal, so every row but the last equals
  JAX's, and the last too where the length is a multiple of the hop; else
  a later stage's strided conv reads past the earlier stage's rows, which
  the unpadded run pads with zeros and JAX's bucket fills with the earlier
  stage's output on zero samples. Each block's FFN runs FFN_ROWS rows at a
  time, so a stage tensor, not its 4x FFN, sets the peak memory (ten
  minutes at 24 kHz are 14.4 M rows, 1.8 GB a 32-channel f32 stage
  tensor);
* the stream decodes greedily in chunks of DEC_CHUNK steps with one read
  a chunk, then yields each token's text, where JAX's yields a token a
  step against caches of bucket + 1 columns;
* `sanitize` reads each conv weight's layout (torch, MLX or WIO) from the
  model's own shapes, where JAX's transposes every 3-D conv weight of a
  checkpoint with `model.` names and none of any other;
* `post_load_hook` reads only the model directory's tokenizer files and
  raises when they fail to load, where JAX's swallows any error.
"""

from __future__ import annotations

import json
import math
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, convs_to_wio, holder
from ....nn import Conv1d, Linear, RMSNorm, gelu
from ....tts.models.base import local_tokenizer
from ....tts.models.llama.llama import Model as LlamaLM
from ....tts.models.llama.llama import ModelConfig as LlamaConfig
from ...models.base import STTOutput
from ..llm_stt import (GREEDY, decode_fns, decode_tokens, sampling_knobs,
                       splice_embeds)
from ..qwen3_lm import iter_decode

SAMPLE_RATE = 24000
MAX_DURATION_SECONDS = 59 * 60
REP_CONTEXT = 100
EOS_IDS = (151643, 151645)
# Qwen2.5's repurposed special tokens
SPEECH_START_ID = 151646   # <|object_ref_start|>
SPEECH_END_ID = 151647     # <|object_ref_end|>
SPEECH_PAD_ID = 151648     # <|box_start|>
# rows of a block's FFN at a time
FFN_ROWS = 1 << 21

CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "{{'<|im_start|>' + message['role'] + '\\n' + "
    "message['content'] + '<|im_end|>' + '\\n'}}"
    "{% endfor %}"
    "{% if add_generation_prompt %}"
    "{{ '<|im_start|>assistant\\n' }}{% endif %}")


@dataclass
class TokenizerConfig(BaseModelArgs):
    channels: int = 1
    vae_dim: int = 64
    encoder_n_filters: int = 32
    encoder_ratios: List[int] = field(
        default_factory=lambda: [8, 5, 5, 4, 2, 2])
    encoder_depths: str = "3-3-3-3-3-3-8"
    layernorm_eps: float = 1e-5
    conv_bias: bool = True
    layer_scale_init_value: float = 1e-6
    mixer_kernel: int = 7

    @property
    def depths(self) -> List[int]:
        if isinstance(self.encoder_depths, str):
            return [int(d) for d in self.encoder_depths.split("-")]
        return list(self.encoder_depths)

    @property
    def rev_ratios(self) -> List[int]:
        return list(reversed(self.encoder_ratios))


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "vibevoice_asr"
    acoustic_tokenizer_config: Optional[dict] = None
    semantic_tokenizer_config: Optional[dict] = None
    decoder_config: Optional[dict] = None
    acoustic_vae_dim: int = 64
    semantic_vae_dim: int = 128
    model_path: str = ""

    def __post_init__(self):
        self.acoustic = TokenizerConfig.from_dict(
            self.acoustic_tokenizer_config or {})
        self.semantic = TokenizerConfig.from_dict(
            dict({"vae_dim": 128}, **(self.semantic_tokenizer_config
                                      or {})))
        dec = dict(self.decoder_config or {})
        dec.setdefault("attention_bias", True)       # Qwen2.5
        dec.setdefault("rope_theta", 1000000.0)
        self.text = LlamaConfig.from_dict(dec)
        self.acoustic_vae_dim = self.acoustic.vae_dim
        self.semantic_vae_dim = self.semantic.vae_dim


# ------------------------------------------------------------ the encoders


class Block(nn.Module):
    """One mixer block: `norm`, the depthwise causal `mixer.conv.conv`,
    the layer scale `gamma`, `ffn_norm`, `ffn.linear1` / `linear2` and
    `ffn_gamma` (both scales `layer_scale_init_value` at init)."""

    def __init__(self, dim: int, cfg: TokenizerConfig):
        super().__init__()
        self.norm = RMSNorm(dim, cfg.layernorm_eps)
        self.ffn_norm = RMSNorm(dim, cfg.layernorm_eps)
        self.mixer = holder(conv=holder(conv=Conv1d(
            dim, dim, cfg.mixer_kernel, bias=cfg.conv_bias, groups=dim)))
        self.ffn = holder(linear1=Linear(dim, 4 * dim, bias=False),
                          linear2=Linear(4 * dim, dim, bias=False))
        self.gamma = nn.Parameter(torch.empty(dim))
        self.ffn_gamma = nn.Parameter(torch.empty(dim))
        self.init_fill = {"gamma": cfg.layer_scale_init_value,
                          "ffn_gamma": cfg.layer_scale_init_value}


class TokenizerEncoder(nn.Module):
    """init_tokenizer_encoder's tree: `downsample_layers.N.conv`,
    `stages.I.J` (`Block`s) and `head.conv`."""

    def __init__(self, cfg: TokenizerConfig):
        super().__init__()
        nf, b = cfg.encoder_n_filters, cfg.conv_bias
        self.downsample_layers = nn.ModuleList(
            [holder(conv=Conv1d(cfg.channels, nf, 7, bias=b))]
            + [holder(conv=Conv1d(nf * 2 ** i, nf * 2 ** (i + 1), 2 * r,
                                  bias=b))
               for i, r in enumerate(cfg.rev_ratios)])
        self.stages = nn.ModuleList(
            nn.ModuleList(Block(nf * 2 ** i, cfg) for _ in range(d))
            for i, d in enumerate(cfg.depths))
        self.head = holder(conv=Conv1d(nf * 2 ** len(cfg.rev_ratios),
                                       cfg.vae_dim, 7, bias=b))


def causal_conv(conv: Conv1d, x: torch.Tensor, kernel: int,
                stride: int = 1) -> torch.Tensor:
    """Causal SConv1d on (B, T, C): left pad (K-1)-(S-1), right pad to
    align the stride; output length ceil(T / S)."""
    pt = (kernel - 1) - (stride - 1)
    length = x.shape[1]
    n_frames = (length - kernel + pt) / stride + 1
    extra = int((math.ceil(n_frames) - 1) * stride + kernel - pt - length)
    return conv(x, stride=stride, padding=(pt, max(extra, 0)))


def tokenizer_encode(enc: TokenizerEncoder, cfg: TokenizerConfig,
                     audio: torch.Tensor) -> torch.Tensor:
    """(B, T) samples -> (B, ceil(T / hop), vae_dim), causal throughout."""
    x = audio[..., None]
    ratios = cfg.rev_ratios
    km = cfg.mixer_kernel
    for i, stage in enumerate(enc.stages):
        conv = enc.downsample_layers[i].conv
        x = causal_conv(conv, x, 7) if i == 0 else causal_conv(
            conv, x, 2 * ratios[i - 1], ratios[i - 1])
        for blk in stage:
            h = causal_conv(blk.mixer.conv.conv, blk.norm(x), km)
            x = x + blk.gamma.to(x.dtype) * h
            for a in range(0, x.shape[1], FFN_ROWS):
                xs = x[:, a:a + FFN_ROWS]
                f = blk.ffn.linear2(gelu(blk.ffn.linear1(blk.ffn_norm(xs))))
                x[:, a:a + FFN_ROWS] = xs + blk.ffn_gamma.to(x.dtype) * f
    return causal_conv(enc.head.conv, x, 7)


def connector_forward(p, x: torch.Tensor) -> torch.Tensor:
    return p.fc2(p.norm(p.fc1(x)))


def speech_token_count(n_samples: int, ratios: List[int]) -> int:
    """Output frames of the causal encoders for n_samples (ceil a stage)."""
    n = n_samples
    for r in ratios:
        n = math.ceil(n / r)
    return n


# ------------------------------------------------------------------ model


class Model(TorchModel):
    """VibeVoice-ASR on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = ModelConfig.from_dict(kwargs) if kwargs else \
                ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        h = config.text.hidden_size

        def connector(in_dim):
            return holder(fc1=Linear(in_dim, h), norm=RMSNorm(h, 1e-6),
                          fc2=Linear(h, h))

        with torch.device(device):
            self.acoustic_tokenizer = holder(
                encoder=TokenizerEncoder(config.acoustic))
            self.semantic_tokenizer = holder(
                encoder=TokenizerEncoder(config.semantic))
            self.acoustic_connector = connector(config.acoustic.vae_dim)
            self.semantic_connector = connector(config.semantic.vae_dim)
        self.language_model = LlamaLM(config.text, device=device)
        self.tokenizer = None
        self._speech_start_id = SPEECH_START_ID
        self._speech_end_id = SPEECH_END_ID
        self._speech_pad_id = SPEECH_PAD_ID
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return SAMPLE_RATE

    @property
    def dtype(self) -> torch.dtype:
        return self.language_model.model.norm.weight.dtype

    # --------------------------------------------------------------- audio

    @staticmethod
    def _normalize_audio(audio: np.ndarray, target_dB_FS: float = -25.0,
                         eps: float = 1e-6) -> np.ndarray:
        rms = np.sqrt(np.mean(audio ** 2))
        scalar = 10 ** (target_dB_FS / 20) / (rms + eps)
        audio = audio * scalar
        mx = np.max(np.abs(audio))
        if mx > 1.0:
            audio = audio / (mx + eps)
        return audio

    def _preprocess_audio(self, audio, sampling_rate=None) -> np.ndarray:
        """A path is read at 24 kHz as it is; an array is resampled to 24
        kHz from `sampling_rate` and normalised to -25 dBFS. Both are cut
        to 59 minutes."""
        from ....utils import load_audio, resample_audio

        if isinstance(audio, (str, Path)):
            wav = load_audio(str(audio), SAMPLE_RATE)
        else:
            if isinstance(audio, torch.Tensor):
                audio = audio.detach().float().cpu().numpy()
            wav = np.asarray(audio, np.float32).reshape(-1)
            if sampling_rate is not None and sampling_rate != SAMPLE_RATE:
                wav = resample_audio(wav, sampling_rate, SAMPLE_RATE)
            wav = self._normalize_audio(wav)
        max_samples = MAX_DURATION_SECONDS * SAMPLE_RATE
        if wav.shape[-1] > max_samples:
            print(f"[WARNING] audio exceeds 59 min; trimming "
                  f"({wav.shape[-1] / SAMPLE_RATE / 60:.1f} min)")
            wav = wav[:max_samples]
        return np.asarray(wav, np.float32)

    @torch.inference_mode()
    def encode_speech(self, wav) -> torch.Tensor:
        """(T,) 24-kHz samples -> (speech_token_count, hidden): the two
        encoders through their connectors, summed."""
        cfg = self.config
        x = torch.as_tensor(np.asarray(wav, np.float32)).to(
            self.device, self.dtype)[None]
        n_tok = speech_token_count(x.shape[1], cfg.acoustic.encoder_ratios)
        ac = tokenizer_encode(self.acoustic_tokenizer.encoder, cfg.acoustic,
                              x)[:, :n_tok]
        se = tokenizer_encode(self.semantic_tokenizer.encoder, cfg.semantic,
                              x)[:, :n_tok]
        return (connector_forward(self.acoustic_connector, ac)
                + connector_forward(self.semantic_connector, se))[0]

    # -------------------------------------------------------------- prompt

    def _build_prompt_ids(self, n_speech: int, audio_duration: float,
                          context: Optional[str]) -> List[int]:
        system_prompt = ("You are a helpful assistant that transcribes "
                         "audio input into text output in JSON format.")
        keys = ", ".join(["Start time", "End time", "Speaker ID",
                          "Content"])
        if context and context.strip():
            suffix = (f"This is a {audio_duration:.2f} seconds audio, "
                      f"with extra info: {context.strip()}\n\n"
                      f"Please transcribe it with these keys: {keys}")
        else:
            suffix = (f"This is a {audio_duration:.2f} seconds audio, "
                      f"please transcribe it with these keys: {keys}")
        tok = self.tokenizer
        if tok is not None:
            content = ("<|object_ref_start|>" + "<|box_start|>" * n_speech
                       + "<|object_ref_end|>\n" + suffix)
            text = tok.apply_chat_template(
                [{"role": "system", "content": system_prompt},
                 {"role": "user", "content": content}], tokenize=False,
                add_generation_prompt=True)
            return list(tok.encode(text))
        return ([self._speech_start_id] + [self._speech_pad_id] * n_speech
                + [self._speech_end_id])

    def _prepare(self, audio, context, sampling_rate
                 ) -> Tuple[List[int], torch.Tensor]:
        t0 = time.perf_counter()
        wav = self._preprocess_audio(audio, sampling_rate)
        feats = self.encode_speech(wav)
        ids = self._build_prompt_ids(feats.shape[0],
                                     wav.shape[-1] / SAMPLE_RATE, context)
        with torch.inference_mode():
            embeds = splice_embeds(self.language_model, ids, feats,
                                   audio_id=self._speech_pad_id)
        self.last_run = {"audio_tokens": feats.shape[0],
                         "encode_ms": (time.perf_counter() - t0) * 1e3}
        return ids, embeds

    # -------------------------------------------------------------- decode

    def generate(self, audio, *, context: Optional[str] = None,
                 sampling_rate: Optional[int] = None,
                 max_tokens: int = 8192,
                 repetition_penalty: Optional[float] = 1.0,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, min_p: float = 0.0,
                 repetition_context_size: int = 20,
                 min_tokens_to_keep: int = 1, seed: int = 0,
                 verbose: bool = False, **kwargs) -> STTOutput:
        t0 = time.time()
        ids, embeds = self._prepare(audio, context, sampling_rate)
        n = len(ids)
        fns = decode_fns(self.language_model, n, max_tokens, sampling_knobs(
            temperature, top_k, top_p, min_p, repetition_penalty,
            repetition_context_size, min_tokens_to_keep), EOS_IDS,
            min_context=REP_CONTEXT)
        generated = decode_tokens(iter_decode(
            fns, embeds, n, max_tokens=max_tokens, seed=seed,
            run=self.last_run))
        text = (self.tokenizer.decode(generated, skip_special_tokens=True)
                if self.tokenizer is not None
                else " ".join(map(str, generated)))
        segments = self.parse_transcription(text)
        dt = time.time() - t0
        if verbose:
            print(text)
        return STTOutput(
            text=text.strip(), segments=segments, prompt_tokens=n,
            generation_tokens=len(generated),
            total_tokens=n + len(generated), total_time=dt,
            prompt_tps=n / dt if dt > 0 else 0.0,
            generation_tps=len(generated) / dt if dt > 0 else 0.0)

    __call__ = generate

    def stream_transcribe(self, audio, *, context: Optional[str] = None,
                          sampling_rate: Optional[int] = None,
                          max_tokens: int = 8192, **kwargs
                          ) -> Generator[str, None, None]:
        """Each greedy token's text, in order."""
        ids, embeds = self._prepare(audio, context, sampling_rate)
        n = len(ids)
        fns = decode_fns(self.language_model, n, max_tokens, GREEDY, EOS_IDS)
        for new in iter_decode(fns, embeds, n, max_tokens=max_tokens,
                               run=self.last_run):
            for tok in new:
                yield (self.tokenizer.decode([tok])
                       if self.tokenizer is not None else str(tok))

    # ------------------------------------------------------------- parsing

    @staticmethod
    def parse_transcription(text: str) -> List[Dict[str, Any]]:
        """Parse the model's structured JSON output into segments."""
        try:
            if "```json" in text:
                s = text.find("```json") + 7
                e = text.find("```", s)
                json_str = text[s:e].strip()
            else:
                s = text.find("[")
                if s == -1:
                    s = text.find("{")
                if s != -1:
                    depth = 0
                    e = s
                    for i in range(s, len(text)):
                        if text[i] in "[{":
                            depth += 1
                        elif text[i] in "]}":
                            depth -= 1
                            if depth == 0:
                                e = i + 1
                                break
                    json_str = text[s:e]
                else:
                    json_str = text
            result = json.loads(json_str)
            if isinstance(result, dict):
                result = [result]
            key_map = {"Start time": "start", "Start": "start",
                       "End time": "end", "End": "end",
                       "Speaker ID": "speaker_id",
                       "Speaker": "speaker_id", "Content": "text"}
            segments = []
            for item in result:
                if isinstance(item, dict):
                    seg = {nk: item[ok] for ok, nk in key_map.items()
                           if ok in item}
                    if seg:
                        segments.append(seg)
            return segments
        except Exception:
            return []

    # ------------------------------------------------------------- loading

    def model_quant_predicate(self, path: str, leaf) -> bool:
        return path.startswith("language_model")

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """HF names onto the tree's (the `model.` prefix off, the acoustic
        decoder and position ids dropped, the nested conv names shortened,
        the LM's under `language_model.model.`); conv weights to WIO from
        the layout their shapes show."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for k, v in weights.items():
            if k.startswith("model."):
                k = k[6:]
            if "acoustic_tokenizer.decoder" in k or "position_ids" in k \
                    or "fix_std" in k:
                continue
            if ".downsample_layers." in k:
                k = re.sub(r"\.downsample_layers\.(\d+)\.0\.conv\.conv\.",
                           r".downsample_layers.\1.conv.", k)
            elif ".head.conv.conv." in k:
                k = k.replace(".head.conv.conv.", ".head.conv.")
            elif ".mixer.conv.conv.conv." in k:
                k = k.replace(".mixer.conv.conv.conv.",
                              ".mixer.conv.conv.")
            if k.startswith("language_model.layers."):
                k = "language_model.model." + k[len("language_model."):]
            elif k.startswith("language_model.embed_tokens"):
                k = ("language_model.model.embed_tokens"
                     + k[len("language_model.embed_tokens"):])
            elif k.startswith("language_model.norm"):
                k = ("language_model.model.norm"
                     + k[len("language_model.norm"):])
            if k.startswith("lm_head."):
                k = "language_model." + k
            out[k] = v if isinstance(v, np.ndarray) else np.asarray(v)
        return convs_to_wio(out, shapes, lambda k, v: "conv" in k.lower()
                            and "weight" in k and v.ndim == 3)

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer with the ChatML template and the
        speech token ids it names (no tokenizer without tokenizer files or
        `transformers`); tokenizer files that fail to load raise."""
        tok = local_tokenizer(Path(model_path), trust_remote_code=True)
        model.tokenizer = tok
        if tok is not None:
            tok.chat_template = CHAT_TEMPLATE
            model._speech_start_id = tok.convert_tokens_to_ids(
                "<|object_ref_start|>")
            model._speech_end_id = tok.convert_tokens_to_ids(
                "<|object_ref_end|>")
            model._speech_pad_id = tok.convert_tokens_to_ids("<|box_start|>")
        return model


__all__ = ["Model", "ModelConfig", "TokenizerConfig", "TokenizerEncoder",
           "tokenizer_encode", "speech_token_count", "causal_conv",
           "SAMPLE_RATE", "EOS_IDS", "FFN_ROWS"]
