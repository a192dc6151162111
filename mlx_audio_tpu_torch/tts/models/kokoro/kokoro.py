"""Kokoro-82M: non-autoregressive TTS (PL-BERT -> prosody -> ISTFTNet).

Counterpart of mlx_audio_tpu/tts/models/kokoro/kokoro.py, with its design:

* Two stages over bucketed static shapes (TOKEN_BUCKETS, FRAME_BUCKETS):
  the frontend (ALBERT -> duration encoder -> durations, text encoder) and
  the acoustic stage (alignment matmul -> F0/N -> ISTFTNet decode). The
  host reads one scalar between them, the total frame count, to pick the
  frame bucket. Validity masks make a padded run equal a tight one, which
  later CUDA-graph work needs (one graph per bucket).
* dtype policy (kokoro.py:84-94, 276-290): the decoder runs in
  `compute_dtype` (bf16 by default) and is cast once, when weights are
  bound; the prosody LSTMs, the instance-norm statistics, the NSF phase
  integral and the ISTFT stay f32; the waveform leaves the acoustic stage in
  `transfer_dtype` (f16, clamped to +-65504) and the public output is f32.

Besides the frame-count read, the masked LSTMs read their lengths on the
host (nn/recurrent.py): once per LSTM call.
"""

from __future__ import annotations

import math
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ....base import BaseModelArgs
from ....model import TorchModel, check_device
from ....nn import Linear
from ..base import GenerationResult, format_duration, peak_memory_gb
from .albert import Albert, AlbertModelArgs
from .istftnet import AdaINResBlock1, Decoder, fold_weight_norm
from .modules import (ProsodyPredictor, TextEncoder, build_alignment,
                      f0n_train, predict_durations)


@dataclass
class IstftNetConfig:
    resblock_kernel_sizes: tuple = (3, 7, 11)
    upsample_rates: tuple = (10, 6)
    upsample_initial_channel: int = 512
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_kernel_sizes: tuple = (20, 12)
    gen_istft_n_fft: int = 20
    gen_istft_hop_size: int = 5


@dataclass
class ModelConfig(BaseModelArgs):
    istftnet: dict = field(default_factory=dict)
    dim_in: int = 64
    dropout: float = 0.2
    hidden_dim: int = 512
    max_conv_dim: int = 512
    max_dur: int = 50
    multispeaker: bool = True
    n_layer: int = 3
    n_mels: int = 80
    n_token: int = 178
    style_dim: int = 128
    text_encoder_kernel_size: int = 5
    plbert: dict = field(default_factory=dict)
    vocab: Dict[str, int] = field(default_factory=dict)
    sample_rate: int = 24000
    model_path: str = ""
    decoder_bottleneck: int = 1024
    decoder_res_dim: int = 64
    # decoder compute dtype, fixed when the model is built
    compute_dtype: str = "bfloat16"
    # dtype of the waveform as the acoustic stage returns it
    transfer_dtype: str = "float16"


TOKEN_BUCKETS = (32, 64, 128, 256, 512)
FRAME_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class Model(TorchModel):
    """Kokoro TTS model (language-blind; G2P lives in pipeline.py).

    Parameters are built on `device` (the card by default; without CUDA
    the constructor raises unless given `device="cpu"`); call
    `init_params(seed)` for seeded random weights, `load_jax_params` to
    carry over the JAX package's, or `bind` for a sanitized torch-layout
    checkpoint. Each of the three also lays out K1's weights for the
    kernel once (`_cast_decoder`)."""

    REPO_ID = "prince-canuma/Kokoro-82M"

    def __init__(self, config: ModelConfig, repo_id: Optional[str] = None,
                 device="cuda"):
        device = check_device(device)
        super().__init__(config)
        self.repo_id = repo_id
        self.vocab = config.vocab
        plbert = dict(config.plbert)
        plbert.pop("vocab_size", None)
        self.albert_cfg = AlbertModelArgs(vocab_size=config.n_token, **plbert)
        self.istft_cfg = IstftNetConfig(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in config.istftnet.items()})
        self.context_length = self.albert_cfg.max_position_embeddings
        # 2x prosody upsample * prod(upsample_rates) * istft hop (600 for
        # the published 24 kHz checkpoint)
        self.samples_per_frame = (
            2 * math.prod(int(r) for r in self.istft_cfg.upsample_rates)
            * int(self.istft_cfg.gen_istft_hop_size))
        self._pipelines: Dict[str, object] = {}

        self.bert = Albert(self.albert_cfg)
        self.bert_encoder = Linear(self.albert_cfg.hidden_size, config.hidden_dim)
        self.predictor = ProsodyPredictor(config.style_dim, config.hidden_dim,
                                          config.n_layer, config.max_dur)
        self.text_encoder = TextEncoder(config.hidden_dim,
                                        config.text_encoder_kernel_size,
                                        config.n_layer, config.n_token)
        self.decoder = Decoder(config.hidden_dim, config.style_dim,
                               config.n_mels, self.istft_cfg,
                               bottleneck_dim=config.decoder_bottleneck,
                               res_dim=config.decoder_res_dim)
        self.requires_grad_(False)
        self.eval()
        self.to(device)
        self._cast_decoder()

    # ------------------------------------------------------------------
    # Params
    # ------------------------------------------------------------------

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.config.compute_dtype)

    def _cast_decoder(self) -> "Model":
        """Cast the decoder to the compute dtype, then lay out K1's operands
        for it (once per weight load, not per call)."""
        self.decoder.to(self.compute_dtype)
        for m in self.decoder.modules():
            if isinstance(m, AdaINResBlock1):
                m.pack_kernel_weights()
        return self

    def bind(self, state) -> "Model":
        super().bind(state)
        return self._cast_decoder()

    def init_params(self, seed: int = 0) -> "Model":
        super().init_params(seed)
        return self._cast_decoder()

    def sanitize(self, weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Map the published torch-layout checkpoint onto this model's names
        (kokoro.py:173-231, without the JAX layout changes):

        * drop position_ids; `.gamma`/`.beta` -> LayerNorm weight/bias
        * weight-norm (g, v) pairs folded into `.weight`
        * snake alphas (1, C, 1) -> (C,)
        Conv, transposed-conv and LSTM tensors keep their torch layout and
        names."""
        out: Dict[str, np.ndarray] = {}
        for key, w in weights.items():
            if "position_ids" in key or key.endswith("weight_g"):
                continue
            if key.endswith("weight_v"):
                base = key[: -len(".weight_v")]
                g = weights.get(base + ".weight_g")
                out[base + ".weight"] = (fold_weight_norm(g, w) if g is not None
                                         else w)
            elif key.endswith(".gamma"):
                out[key[: -len(".gamma")] + ".weight"] = w
            elif key.endswith(".beta"):
                out[key[: -len(".beta")] + ".bias"] = w
            elif ("alpha1" in key or "alpha2" in key) and np.ndim(w) == 3:
                out[key] = np.reshape(w, (-1,))
            else:
                out[key] = w
        return out

    # ------------------------------------------------------------------
    # Stages
    # ------------------------------------------------------------------

    def _run_frontend(self, ids, valid, ref_s, speed: float):
        """ids (B, L), valid (B, L) bool, ref_s (B, 256) ->
        (d (B, L, Dh+S), t_en (B, L, Dh), pred_dur (B, L), total frames ())."""
        cfg = self.config
        s = ref_s[:, cfg.style_dim:]
        bert_out, _ = self.bert(ids, valid.long())
        d_en = self.bert_encoder(bert_out)
        d = self.predictor.text_encoder(d_en, s, valid)
        pred_dur = predict_durations(self.predictor, d, valid, speed)
        t_en = self.text_encoder(ids, valid)
        return d, t_en, pred_dur, pred_dur.sum()

    def _run_acoustic(self, d, t_en, pred_dur, ref_s, num_frames: int,
                      generator: Optional[torch.Generator] = None):
        """Alignment -> prosody -> decode at the static frame count
        `num_frames`. Returns (audio (B, samples) in transfer_dtype,
        total frames (B,)). `generator=None` is the deterministic path."""
        cfg = self.config
        s = ref_s[:, cfg.style_dim:]
        style = ref_s[:, : cfg.style_dim]
        total = pred_dur.sum(-1)
        frame_valid = (torch.arange(num_frames, device=pred_dur.device)[None, :]
                       < total[:, None])
        aln = build_alignment(pred_dur, num_frames)
        en = torch.einsum("blf,blc->bfc", aln, d)
        f0, n = f0n_train(self.predictor, en, s, frame_valid)
        asr = torch.einsum("blf,blc->bfc", aln, t_en)
        cdt = self.compute_dtype
        audio = self.decoder(asr.to(cdt), f0, n, style.to(cdt), frame_valid,
                             generator=generator)
        tdt = getattr(torch, cfg.transfer_dtype)
        if tdt == torch.float16:
            # random weights can emit audio far outside f16's range: clip
            # to the finite range rather than overflow to inf
            audio = audio.clamp(-65504.0, 65504.0)
        return audio.to(tdt), total

    # ------------------------------------------------------------------
    # Public surface
    # ------------------------------------------------------------------

    @property
    def sample_rate(self):
        return self.config.sample_rate

    def phonemes_to_ids(self, phonemes: str):
        ids = [self.vocab.get(p) for p in phonemes]
        return [i for i in ids if i is not None]

    @torch.inference_mode()
    def __call__(self, phonemes: str, ref_s, speed: float = 1.0,
                 deterministic_noise: bool = False, seed: int = 0,
                 tight: bool = False):
        """Synthesize one phoneme string -> (float32 audio (samples,),
        pred_dur (1, L)). ref_s: (1, 256) or (256,) style+speaker vector."""
        input_ids = self.phonemes_to_ids(phonemes)
        if len(input_ids) + 2 > self.context_length:
            raise ValueError(f"{len(input_ids)} phonemes exceed the context "
                             f"of {self.context_length - 2}")
        ids_list = [0, *input_ids, 0]
        n = len(ids_list)
        lb = n if tight else _bucket(n, TOKEN_BUCKETS)
        ids = torch.zeros((1, lb), dtype=torch.long)
        ids[0, :n] = torch.tensor(ids_list)
        valid = torch.zeros((1, lb), dtype=torch.bool)
        valid[0, :n] = True

        dev = self.device
        ref_s = torch.as_tensor(ref_s, dtype=torch.float32, device=dev)
        if ref_s.ndim == 1:
            ref_s = ref_s[None]
        d, t_en, pred_dur, total_dev = self._run_frontend(
            ids.to(dev), valid.to(dev), ref_s, speed)
        total_frames = int(total_dev.item())  # the host sync on frame count
        if total_frames > FRAME_BUCKETS[-1] and not tight:
            warnings.warn(
                f"Kokoro segment predicts {total_frames} frames "
                f"(> max bucket {FRAME_BUCKETS[-1]}); clamping to "
                f"{FRAME_BUCKETS[-1] / 12.5:.0f}s of audio: split the text "
                f"into shorter segments (split_pattern).")
            total_frames = FRAME_BUCKETS[-1]
        fb = total_frames if tight else _bucket(total_frames, FRAME_BUCKETS)
        gen = (None if deterministic_noise
               else torch.Generator(device=dev).manual_seed(seed))
        audio, _ = self._run_acoustic(d, t_en, pred_dur, ref_s, fb, gen)
        samples = total_frames * self.samples_per_frame
        return audio[0, :samples].float().cpu().numpy(), pred_dur

    def generate(self, text: str, voice: Optional[str] = None,
                 speed: float = 1.0, lang_code: str = "a",
                 split_pattern: str = r"\n+", **kwargs):
        """Streaming generator of GenerationResult per text segment."""
        from .pipeline import KokoroPipeline

        if lang_code not in self._pipelines:
            self._pipelines[lang_code] = KokoroPipeline(
                model=self,
                repo_id=self.repo_id or self.config.model_path or self.REPO_ID,
                lang_code=lang_code)
        pipeline = self._pipelines[lang_code]
        if voice is None:
            voice = "af_heart"

        start = time.perf_counter()
        for segment_idx, (_, phonemes, audio) in enumerate(
                pipeline(text, voice=voice, speed=speed,
                         split_pattern=split_pattern)):
            now = time.perf_counter()
            seg_time = now - start
            start = now
            samples = int(audio.shape[0])
            if samples == 0:
                raise RuntimeError("No audio generated")
            token_count = len(phonemes) if phonemes else 0
            sr = self.config.sample_rate
            dur_s = samples / sr
            yield GenerationResult(
                audio=audio,
                samples=samples,
                sample_rate=sr,
                segment_idx=segment_idx,
                token_count=token_count,
                audio_duration=format_duration(dur_s),
                real_time_factor=round(seg_time / dur_s, 2) if dur_s > 0 else 0,
                prompt={"tokens": token_count,
                        "tokens-per-sec": round(token_count / seg_time, 2)
                        if seg_time > 0 else 0},
                audio_samples={"samples": samples,
                               "samples-per-sec": round(samples / seg_time, 2)
                               if seg_time > 0 else 0},
                processing_time_seconds=seg_time,
                peak_memory_usage=peak_memory_gb(),
            )
