"""GLM-ASR: a Whisper encoder with interleaved partial RoPE, a merge
adapter and a llama decoder.

Counterpart of mlx_audio_tpu/stt/models/glmasr/glmasr.py:

* the configs (`WhisperConfig`, `LlamaConfig`, `ModelConfig`, :57-121) and
  the llama backbone's config (`_backbone_cfg`);
* `encode_audio` (:159-205): conv1 and stride-2 conv2 with GELU, learned
  positions or the interleaved RoPE over the first head_dim / 2 dims of
  each head, the pre-norm layers, the encoder's LayerNorm, then
  `merge_factor` frames stacked into one row through the adapting MLP;
* `_mel` (Whisper's slaney log-mel, the trailing frame dropped), `encode`,
  `_transcribe_chunk`, `generate` and `stream_transcribe` (:226-437), on
  the port's `split_audio_into_chunks` and `StreamingResult` (30-s chunks
  by default);
* `sanitize` and `post_load_hook` (:447-472).

Departures (besides `llm_stt`'s):

* the encoder runs the mel's own frames, not a bucket of them: JAX pads
  the mel to MEL_BUCKETS and masks the padded keys, but its stride-2 conv
  reads the first padded frame's conv1 output (GELU of the bias, not
  zero) for an odd frame count, so its last encoder frame, and through
  attention every row, departs from the unpadded run; for an even count
  the two agree;
* `sanitize` reads each conv weight's layout (torch, MLX or WIO) from the
  model's own shapes, where JAX's transposes a weight whose last axis is 3;
* `post_load_hook` reads only the model directory's tokenizer files and
  raises when they fail to load, where JAX's swallows any error.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch

from ....base import BaseModelArgs
from ....dsp import log_mel_spectrogram
from ....model import TorchModel, check_device, convs_to_wio, holder
from ....nn import Embedding, LayerNorm, Linear, gelu
from ....ops.attention import attention
from ....ops.rope import apply_rotary_interleaved, rope_cis, rope_freqs
from ....tts.models.base import local_tokenizer
from ....tts.models.llama.llama import Model as LlamaLM
from ....tts.models.llama.llama import ModelConfig as LlamaBackboneConfig
from ...models.base import STTOutput
from ..llm_stt import (WhisperTower, as_audio, decode_fns, decode_tokens,
                       sampling_knobs, splice_embeds)
from ..qwen3_asr.qwen3_asr import StreamingResult, split_audio_into_chunks
from ..qwen3_lm import iter_decode


@dataclass
class WhisperConfig(BaseModelArgs):
    model_type: str = "whisper"
    d_model: int = 1280
    encoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    encoder_layers: int = 32
    num_mel_bins: int = 128
    max_source_positions: int = 1500
    scale_embedding: bool = False
    rope_traditional: bool = True


@dataclass
class LlamaConfig(BaseModelArgs):
    model_type: str = "llama"
    vocab_size: int = 59264
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 4
    head_dim: Optional[int] = None
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    pad_token_id: int = 59260
    eos_token_id: List[int] = field(
        default_factory=lambda: [59246, 59253, 59255])


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "glmasr"
    whisper_config: Optional[Dict] = None
    lm_config: Optional[Dict] = None
    adapter_type: str = "mlp"
    merge_factor: int = 4
    use_rope: bool = True
    max_whisper_length: int = 1500
    sample_rate: int = 16000
    model_path: str = ""

    def __post_init__(self):
        if not isinstance(self.whisper_config, WhisperConfig):
            self.whisper_config = WhisperConfig.from_dict(
                self.whisper_config or {})
        if not isinstance(self.lm_config, LlamaConfig):
            self.lm_config = LlamaConfig.from_dict(self.lm_config or {})


def backbone_config(c: LlamaConfig) -> LlamaBackboneConfig:
    return LlamaBackboneConfig(
        hidden_size=c.hidden_size, num_hidden_layers=c.num_hidden_layers,
        intermediate_size=c.intermediate_size,
        num_attention_heads=c.num_attention_heads,
        num_key_value_heads=c.num_key_value_heads,
        vocab_size=c.vocab_size, rms_norm_eps=c.rms_norm_eps,
        rope_theta=c.rope_theta, head_dim=c.head_dim,
        attention_bias=c.attention_bias,
        tie_word_embeddings=c.tie_word_embeddings)


def encode_audio(enc, cfg: ModelConfig, mel: torch.Tensor,
                 n_merged: int) -> torch.Tensor:
    """(1, T, n_mels) mel -> (1, n_merged, lm_hidden) audio embeddings."""
    w = cfg.whisper_config
    wh = enc.whisper
    x = gelu(wh.conv1(mel, padding=1))
    x = gelu(wh.conv2(x, stride=2, padding=1))
    b, t, d = x.shape
    if not cfg.use_rope:
        x = x + wh.embed_positions.weight[:t].to(x.dtype)[None]
    nh = w.encoder_attention_heads
    hd = d // nh
    cis = None
    if cfg.use_rope:
        cis = rope_cis(torch.arange(t, device=x.device)[None],
                       rope_freqs(hd // 2, 10000.0).to(x.device))
    for blk in wh.layers:
        h = blk.self_attn_layer_norm(x)
        a = blk.self_attn
        q = a.q_proj(h).reshape(b, t, nh, hd)
        k = a.k_proj(h).reshape(b, t, nh, hd)
        v = a.v_proj(h).reshape(b, t, nh, hd)
        if cis is not None:
            q = apply_rotary_interleaved(q, cis)
            k = apply_rotary_interleaved(k, cis)
        x = x + a.out_proj(attention(q, k, v).reshape(b, t, d))
        x = x + blk.fc2(gelu(blk.fc1(blk.final_layer_norm(x))))
    x = enc.layer_norm(x)
    mf = cfg.merge_factor
    merged = x[:, :n_merged * mf].reshape(b, n_merged, mf * d)
    return enc.adapting.fc2(gelu(enc.adapting.fc1(merged)))


class Model(TorchModel):
    """GLM-ASR on `device`: the card by default; without CUDA the
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
        w = config.whisper_config
        lm_h = config.lm_config.hidden_size
        d = w.d_model
        with torch.device(device):
            self.audio_encoder = holder(
                whisper=WhisperTower(w, final_norm=False),
                layer_norm=LayerNorm(d),
                proj=Linear(d, lm_h),       # kept for weight parity
                adapting=holder(fc1=Linear(d * config.merge_factor, 2 * lm_h),
                                fc2=Linear(2 * lm_h, lm_h)),
                audio_bos_eos_token=Embedding(2, lm_h))
        self.language_model = LlamaLM(backbone_config(config.lm_config),
                                      device=device)
        self._tokenizer = None
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def dtype(self) -> torch.dtype:
        return self.language_model.model.norm.weight.dtype

    # -------------------------------------------------------------- encode

    def _mel(self, audio) -> torch.Tensor:
        """Whisper's log-mel on the slaney filterbank, (frames, n_mels) on
        the model's device, the trailing frame dropped."""
        mel = log_mel_spectrogram(
            np.asarray(audio, np.float32), n_fft=400, hop_length=160,
            n_mels=self.config.whisper_config.num_mel_bins,
            sample_rate=16000, log_base="log10_whisper", mel_norm="slaney",
            mel_scale="slaney", device=self.device)
        return mel[:-1]

    def merged_count(self, n_frames: int) -> int:
        """Merged encoder rows of n_frames mel frames."""
        cfg = self.config
        enc_len = (n_frames - 1) // 2 + 1
        mf = cfg.merge_factor
        return min((enc_len - mf) // mf + 1, cfg.max_whisper_length // mf)

    @torch.inference_mode()
    def encode_mel(self, mel) -> Tuple[torch.Tensor, int]:
        """(frames, n_mels) -> ((1, n_merged, lm_hidden), n_merged), the
        first 2 x max_whisper_length frames."""
        mel = torch.as_tensor(mel, dtype=torch.float32).to(self.device)
        n = min(mel.shape[0], self.config.max_whisper_length * 2)
        n_merged = self.merged_count(n)
        out = encode_audio(self.audio_encoder, self.config,
                           mel[None, :n].to(self.dtype), n_merged)
        return out, n_merged

    def encode(self, audio) -> Tuple[torch.Tensor, int]:
        """Audio -> ((1, n_merged, lm_hidden) embeddings, n_merged)."""
        return self.encode_mel(self._mel(audio))

    # -------------------------------------------------------------- decode

    def _prompt(self, n_audio: int) -> Tuple[List[int], int]:
        head = list(self._tokenizer.encode("<|user|>\n<|begin_of_audio|>"))
        tail = list(self._tokenizer.encode(
            "<|end_of_audio|>\nPlease transcribe this audio into "
            "text<|assistant|>\n"))
        return head + [0] * n_audio + tail, len(head)

    def _transcribe_chunk(self, audio: np.ndarray, max_tokens: int,
                          sampling, seed: int) -> Tuple[List[int], int]:
        """One audio chunk -> (token ids, prompt length)."""
        if isinstance(sampling, float):
            sampling = sampling_knobs(sampling)
        t0 = time.perf_counter()
        feats, n_audio = self.encode(audio)
        ids, start = self._prompt(n_audio)
        n = len(ids)
        with torch.inference_mode():
            embeds = splice_embeds(self.language_model, ids, feats[0],
                                   positions=range(start, start + n_audio))
        fns = decode_fns(self.language_model, n, max_tokens, sampling,
                         tuple(self.config.lm_config.eos_token_id))
        self.last_run = {"audio_tokens": n_audio,
                         "encode_ms": (time.perf_counter() - t0) * 1e3}
        out = decode_tokens(iter_decode(fns, embeds, n,
                                        max_tokens=max_tokens, seed=seed,
                                        run=self.last_run))
        return out[:max_tokens], n

    def _require_tokenizer(self):
        if self._tokenizer is None:
            raise RuntimeError("glmasr needs its HF tokenizer (place "
                               "tokenizer files in the model directory)")

    def generate(self, audio, *, max_tokens: int = 128,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, min_p: float = 0.0,
                 repetition_penalty: float = 1.0,
                 repetition_context_size: int = 20,
                 min_tokens_to_keep: int = 1,
                 chunk_duration: float = 30.0,
                 min_chunk_duration: float = 1.0, verbose: bool = False,
                 stream: bool = False, seed: int = 0, **kwargs):
        sampling = sampling_knobs(temperature, top_k, top_p, min_p,
                                  repetition_penalty,
                                  repetition_context_size,
                                  min_tokens_to_keep)
        if stream:
            return self.stream_transcribe(
                audio, max_tokens=max_tokens, temperature=sampling,
                chunk_duration=chunk_duration, seed=seed)
        self._require_tokenizer()
        t0 = time.time()
        audio_np = as_audio(audio, 16000)
        chunks = split_audio_into_chunks(audio_np, self.sample_rate,
                                         chunk_duration, min_chunk_duration)
        texts, segments = [], []
        p_tok = g_tok = 0
        for wav, off in chunks:
            toks, n_prompt = self._transcribe_chunk(wav, max_tokens,
                                                    sampling, seed)
            text = self._tokenizer.decode(toks, skip_special_tokens=True)
            texts.append(text)
            p_tok += n_prompt
            g_tok += len(toks)
            segments.append({"text": text, "start": off,
                             "end": off + len(wav) / self.sample_rate})
        dt = time.time() - t0
        if verbose:
            print(" ".join(texts))
        return STTOutput(
            text=" ".join(texts), segments=segments, language="en",
            prompt_tokens=p_tok, generation_tokens=g_tok,
            total_tokens=p_tok + g_tok, total_time=dt,
            prompt_tps=p_tok / dt if dt > 0 else 0,
            generation_tps=g_tok / dt if dt > 0 else 0)

    def stream_transcribe(self, audio, *, max_tokens: int = 128,
                          temperature=0.0, chunk_duration: float = 30.0,
                          min_chunk_duration: float = 1.0, seed: int = 0,
                          **kwargs) -> Generator[StreamingResult, None,
                                                 None]:
        """Each audio chunk's text, then a marker (final at the last)."""
        self._require_tokenizer()
        audio_np = as_audio(audio, 16000)
        chunks = split_audio_into_chunks(audio_np, self.sample_rate,
                                         chunk_duration, min_chunk_duration)
        sampling = temperature if isinstance(temperature, tuple) else \
            sampling_knobs(temperature)
        p_tok = g_tok = 0
        for ci, (wav, off) in enumerate(chunks):
            dur = len(wav) / self.sample_rate
            toks, n_prompt = self._transcribe_chunk(wav, max_tokens,
                                                    sampling, seed)
            p_tok += n_prompt
            g_tok += len(toks)
            text = self._tokenizer.decode(toks, skip_special_tokens=True)
            if text:
                yield StreamingResult(text=text, is_final=False,
                                      start_time=off, end_time=off + dur,
                                      language="en")
            yield StreamingResult(
                text="", is_final=(ci == len(chunks) - 1),
                start_time=off, end_time=off + dur, language="en",
                prompt_tokens=p_tok, generation_tokens=g_tok)

    # ------------------------------------------------------------- loading

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """The adapter's `adapting.{0,2}` as fc1 and fc2, the LM's `model.`
        and `lm_head.` under `language_model.`, conv weights to WIO from the
        layout their shapes show."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for k, v in weights.items():
            v = v if isinstance(v, np.ndarray) else np.asarray(v)
            if "audio_encoder.adapting.0." in k:
                k = k.replace(".adapting.0.", ".adapting.fc1.")
            elif "audio_encoder.adapting.2." in k:
                k = k.replace(".adapting.2.", ".adapting.fc2.")
            if k.startswith(("model.", "lm_head.")):
                k = "language_model." + k
            out[k] = v
        return convs_to_wio(out, shapes, lambda k, v: "conv" in k
                            and k.endswith("weight") and v.ndim == 3)

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (None without tokenizer files or
        `transformers`); tokenizer files that fail to load raise."""
        model._tokenizer = local_tokenizer(Path(model_path),
                                           trust_remote_code=True)
        return model


__all__ = ["Model", "ModelConfig", "WhisperConfig", "LlamaConfig",
           "encode_audio", "backbone_config"]
