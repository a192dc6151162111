"""Sortformer: NVIDIA NeMo's streaming speaker diarizer (up to 4
speakers), with its speaker cache.

Counterpart of mlx_audio_tpu/vad/models/sortformer/sortformer.py:

* `extract_mel_features` (:60; NeMo's filterbank: pre-emphasis, a Hann
  window of 400 centred in 512, constant-padded STFT on the port's
  `dsp.stft`, slaney mels, natural log with a 2^-24 guard, per-feature
  normalisation with Bessel's variance) and `trim_silence` (:94, copied);
* `pre_encode` (:218), the dw-striding conv2d subsampling by 8 with the
  NCHW flatten order; the FastConformer with Transformer-XL relative
  attention (`_rel_pos_emb` :242, copied; `_rel_shift` :254,
  `_fc_attention` :261, `fc_encode` :281), the BART-style post-norm
  transformer with learned positions (`tf_encode` :323) and the sigmoid
  speaker head (`sortformer_forward` :352), on the model's device;
* `preds_to_segments` (:391), the streaming state and the speaker-cache
  compressions (the v1 highest-activity one and the v2.1 AOSC one,
  :423-533), all host numpy, copied;
* `generate` (:594), `streaming_step` (:640), `_maybe_compress` (:680),
  `generate_stream` (:719) and `sanitize` (:772).

The FastConformer is Sortformer's own: its parameter names (`q_proj`,
`relative_k_proj`, `bias_u`, `conv.norm`) and its input scaling differ
from the shared `stt/models/parakeet/conformer.py`, whose `_rel_shift` it
reuses (`tests/test_torch_sortformer.py` pins the reuse). Every frame it
is given is valid: JAX's validity masks (`lengths`, the -1e4 key bias, the
masked depthwise input) serve its padded buckets, which the port does not
run.

Departures:
* The JAX package runs one jitted program per mel-frame bucket (`_bucket`
  :51, `_fwd` :549) on zero-padded mel. Where the frame count is no
  multiple of 8, a stride-2 conv of its subsampling reads past the end of
  its input: a row the previous conv computed from the last frames and the
  padding, where an unpadded run reads zero padding. The last valid
  embedding changes and attention carries that into every row, so its
  bucketed rows are not its own forward on the unpadded mel. The port runs
  the frames the audio has: `generate` and `streaming_step` equal JAX's
  `sortformer_forward` (and `pre_encode`) on the unpadded input.
* `sanitize` reads each conv's layout (torch, MLX or the JAX tree's) from
  this model's own shapes, where JAX's guesses: a conv2d is taken for
  torch's when its two last axes are equal and its first is larger (an
  MLX (O, kh, kw, I) depthwise weight (C, 3, 3, 1) is then transposed to
  (3, 1, 3, C)), a pointwise or depthwise conv1d when its first axis is
  the larger.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....model import (TorchModel, check_device, conv2d_to_hwio,
                       convs_to_wio)
from ....nn import BatchNorm, Conv1d, Conv2d, Embedding, LayerNorm, Linear
from ....stt.models.parakeet.conformer import _rel_shift
from .config import (FCEncoderConfig, ModelConfig, ProcessorConfig,
                     TFEncoderConfig)

_LOG_GUARD = 2.0 ** -24
_NORM_CONSTANT = 1e-5


# ------------------------------------------------------------ features

def extract_mel_features(waveform: np.ndarray, proc: ProcessorConfig,
                         normalize: bool = True, device=None) -> np.ndarray:
    """(samples,) -> (frames, n_mels), NeMo FilterbankFeatures semantics;
    the STFT and the mel product on `device` (the CPU by default)."""
    from ....dsp import filters_on, stft

    x = np.asarray(waveform, np.float32).reshape(-1)
    x = np.concatenate([x[:1], x[1:] - proc.preemphasis * x[:-1]])

    # torch.hann_window (periodic) == np.hanning(N+1)[:-1]
    win = np.hanning(proc.win_length + 1)[:-1].astype(np.float32)
    if proc.win_length < proc.n_fft:
        left = (proc.n_fft - proc.win_length) // 2
        right = proc.n_fft - proc.win_length - left
        win = np.concatenate([np.zeros(left, np.float32), win,
                              np.zeros(right, np.float32)])

    dev = torch.device("cpu") if device is None else torch.device(device)
    spec = stft(torch.from_numpy(x).to(dev), n_fft=proc.n_fft,
                hop_length=proc.hop_length, win_length=proc.n_fft,
                window=torch.from_numpy(win), center=True,
                pad_mode="constant")
    power = spec.real ** 2 + spec.imag ** 2             # (T, F)
    fb = filters_on(dev, proc.sampling_rate, proc.n_fft, proc.feature_size,
                    "slaney", "slaney")
    mel = np.log((power @ fb).cpu().numpy() + _LOG_GUARD)   # (T, E)
    if normalize:
        mean = mel.mean(axis=0, keepdims=True)
        var = ((mel - mean) ** 2).sum(axis=0, keepdims=True) \
            / max(mel.shape[0] - 1, 1)
        mel = (mel - mean) / (np.sqrt(var) + _NORM_CONSTANT)
    return mel.astype(np.float32)


def trim_silence(waveform: np.ndarray, sample_rate: int,
                 frame_ms: int = 30, energy_ratio: float = 0.01,
                 min_speech_sec: float = 0.5) -> Tuple[np.ndarray, int]:
    """Energy-based leading/trailing silence trim (reference :1908-1967)."""
    frame_len = int(sample_rate * frame_ms / 1000)
    min_frames = max(3, int(min_speech_sec * 1000 / frame_ms))
    n = len(waveform) // frame_len
    if n < min_frames * 2:
        return waveform, 0
    frames = waveform[: n * frame_len].reshape(n, frame_len)
    energy = np.sqrt((frames ** 2).mean(axis=1))
    speech = energy > energy.max() * energy_ratio
    start = 0
    for i in range(n - min_frames + 1):
        if speech[i: i + min_frames].all():
            start = i
            break
    end = n
    for i in range(n - 1, min_frames - 2, -1):
        if speech[i - min_frames + 1: i + 1].all():
            end = i + 1
            break
    s, e = start * frame_len, min(end * frame_len, len(waveform))
    if s == 0 and e == len(waveform):
        return waveform, 0
    return waveform[s:e], s



# ------------------------------------------------------- parameter tree

def _mlp(d: int, hidden: int) -> nn.Module:
    m = nn.Module()
    m.linear1 = Linear(d, hidden)
    m.linear2 = Linear(hidden, d)
    return m


class FCAttention(nn.Module):
    init_fill = {"bias_u": 0.0, "bias_v": 0.0}

    def __init__(self, fc: FCEncoderConfig):
        super().__init__()
        d, b = fc.hidden_size, fc.attention_bias
        self.q_proj = Linear(d, d, bias=b)
        self.k_proj = Linear(d, d, bias=b)
        self.v_proj = Linear(d, d, bias=b)
        self.o_proj = Linear(d, d, bias=b)
        self.relative_k_proj = Linear(d, d, bias=False)
        hd = d // fc.num_attention_heads
        self.bias_u = nn.Parameter(torch.empty(fc.num_attention_heads, hd))
        self.bias_v = nn.Parameter(torch.empty(fc.num_attention_heads, hd))


class FCLayer(nn.Module):
    def __init__(self, fc: FCEncoderConfig):
        super().__init__()
        d = fc.hidden_size
        self.norm_feed_forward1 = LayerNorm(d)
        self.feed_forward1 = _mlp(d, fc.intermediate_size)
        self.norm_self_att = LayerNorm(d)
        self.self_attn = FCAttention(fc)
        self.norm_conv = LayerNorm(d)
        self.conv = nn.Module()
        self.conv.pointwise_conv1 = Conv1d(d, 2 * d, 1)
        self.conv.depthwise_conv = Conv1d(d, d, fc.conv_kernel_size,
                                          groups=d)
        self.conv.norm = BatchNorm(d)
        self.conv.pointwise_conv2 = Conv1d(d, d, 1)
        self.norm_feed_forward2 = LayerNorm(d)
        self.feed_forward2 = _mlp(d, fc.intermediate_size)
        self.norm_out = LayerNorm(d)


class TFLayer(nn.Module):
    def __init__(self, tf: TFEncoderConfig):
        super().__init__()
        d = tf.d_model
        self.self_attn = nn.Module()
        self.self_attn.q_proj = Linear(d, d)
        self.self_attn.k_proj = Linear(d, d, bias=tf.k_proj_bias)
        self.self_attn.v_proj = Linear(d, d)
        self.self_attn.out_proj = Linear(d, d)
        self.self_attn_layer_norm = LayerNorm(d, tf.layer_norm_eps)
        self.fc1 = Linear(d, tf.encoder_ffn_dim)
        self.fc2 = Linear(tf.encoder_ffn_dim, d)
        self.final_layer_norm = LayerNorm(d, tf.layer_norm_eps)


# -------------------------------------------------------------- forward

def _rel_pos_emb(t: int, d: int) -> np.ndarray:
    """(2T-1, d) Transformer-XL positions T-1 .. -(T-1), in f32 as the JAX
    package computes them."""
    pos = np.arange(t - 1, -t, -1, dtype=np.float32)
    div = np.exp(np.arange(0, d, 2, dtype=np.float32)
                 * (-math.log(10000.0) / d))
    ang = pos[:, None] * div[None, :]
    pe = np.zeros((len(pos), d), np.float32)
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return pe


def _pointwise(conv: Conv1d, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


# ---------------------------------------------------------------- output

@dataclass
class DiarizationSegment:
    start: float
    end: float
    speaker: int


@dataclass
class DiarizationOutput:
    segments: List[DiarizationSegment]
    speaker_probs: Optional[np.ndarray] = None
    num_speakers: int = 0
    total_time: float = 0.0

    @property
    def text(self) -> str:
        return "\n".join(
            f"SPEAKER audio 1 {s.start:.3f} {s.end - s.start:.3f} <NA> "
            f"<NA> speaker_{s.speaker} <NA> <NA>" for s in self.segments)


def preds_to_segments(preds: np.ndarray, frame_duration: float,
                      threshold: float = 0.5, min_duration: float = 0.0,
                      merge_gap: float = 0.0) -> List[DiarizationSegment]:
    segments = []
    for spk in range(preds.shape[1]):
        activity = preds[:, spk] > threshold
        if not activity.any():
            continue
        padded = np.concatenate([[False], activity, [False]])
        changes = padded[1:].astype(int) - padded[:-1].astype(int)
        starts = np.where(changes == 1)[0]
        ends = np.where(changes == -1)[0]
        segs = [DiarizationSegment(s * frame_duration, e * frame_duration,
                                   spk)
                for s, e in zip(starts, ends)
                if (e - s) * frame_duration >= min_duration]
        if merge_gap > 0 and len(segs) > 1:
            merged = [segs[0]]
            for seg in segs[1:]:
                if seg.start - merged[-1].end <= merge_gap:
                    merged[-1] = DiarizationSegment(
                        merged[-1].start, seg.end, spk)
                else:
                    merged.append(seg)
            segs = merged
        segments.extend(segs)
    return sorted(segments, key=lambda s: (s.start, s.speaker))


@dataclass
class StreamingState:
    spkcache: np.ndarray          # (1, n, emb)
    spkcache_preds: np.ndarray    # (1, n, spk)
    fifo: np.ndarray
    fifo_preds: np.ndarray
    frames_processed: int = 0
    # AOSC silence profile (v2.1)
    mean_sil_emb: Optional[np.ndarray] = None   # (1, emb)
    n_sil_frames: float = 0.0


# ---------------------------------------------------------------------------
# AOSC (Arrival-Order Speaker Cache) compression — v2.1
# (reference sortformer.py:1505-1799; pure numpy host logic between
# compiled steps — the arrays are tiny (<=400 frames))
# ---------------------------------------------------------------------------

def _log_pred_scores(preds: np.ndarray, threshold: float) -> np.ndarray:
    """Per-frame per-speaker LLR scores: high when speaker k is
    confidently active alone."""
    lp = np.log(np.clip(preds, threshold, None))
    l1p = np.log(np.clip(1.0 - preds, threshold, None))
    return lp - l1p + l1p.sum(axis=2, keepdims=True) - math.log(0.5)


def _disable_low_scores(preds: np.ndarray, scores: np.ndarray,
                        min_pos: int) -> np.ndarray:
    scores = np.where(preds > 0.5, scores, -np.inf)
    is_pos = scores > 0
    has_enough = is_pos.sum(axis=1, keepdims=True) >= min_pos
    kill = (~is_pos) & (preds > 0.5) & has_enough
    return np.where(kill, -np.inf, scores)


def _boost_topk_scores(scores: np.ndarray, n_boost: int,
                       scale: float = 1.0) -> np.ndarray:
    if n_boost <= 0:
        return scores
    b, n, s = scores.shape
    k = min(n_boost, n)
    boost = -scale * math.log(0.5)
    out = scores.copy()
    for spk in range(s):
        flat = scores[:, :, spk]
        idx = np.argpartition(-flat, k - 1, axis=1)[:, :k]
        finite = np.isfinite(np.take_along_axis(flat, idx, axis=1))
        for bi in range(b):
            out[bi, idx[bi][finite[bi]], spk] += boost
    return out


def _aosc_topk_indices(scores: np.ndarray, spkcache_len: int,
                       sil_per_spk: int, max_index: int):
    b, n, s = scores.shape
    n_no_sil = n - sil_per_spk
    flat = np.transpose(scores, (0, 2, 1)).reshape(b, -1)
    k = min(spkcache_len, flat.shape[1])
    idx = np.argpartition(-flat, k - 1, axis=1)[:, :k]
    vals = np.take_along_axis(flat, idx, axis=1)
    idx = np.where(vals > -np.inf, idx, max_index)
    idx = np.sort(idx, axis=1)
    disabled = idx == max_index
    idx = idx % n
    disabled = disabled | (idx >= n_no_sil)
    idx = np.where(disabled, 0, idx)
    return idx, disabled


def _silence_profile(mean_sil: np.ndarray, n_sil: float, embs: np.ndarray,
                     preds: np.ndarray, thr: float):
    is_sil = preds.sum(axis=2) < thr                   # (1, n)
    count = float(is_sil.sum())
    sil_sum = (embs * is_sil[..., None]).sum(axis=1)   # (1, emb)
    total = mean_sil * n_sil + sil_sum
    n2 = n_sil + count
    return total / max(n2, 1.0), n2


def compress_spkcache_aosc(embs: np.ndarray, preds: np.ndarray,
                           mean_sil_emb: np.ndarray, mc) -> tuple:
    """Keep the most informative frames per speaker (v2.1 AOSC)."""
    n_spk = mc.num_speakers
    sil_per_spk = mc.spkcache_sil_frames_per_spk
    per_spk = mc.spkcache_len // n_spk - sil_per_spk
    scores = _log_pred_scores(preds, mc.pred_score_threshold)
    scores = _disable_low_scores(
        preds, scores, math.floor(per_spk * mc.min_pos_scores_rate))
    if mc.scores_boost_latest > 0 and scores.shape[1] > mc.spkcache_len:
        scores[:, mc.spkcache_len:, :] = np.where(
            np.isfinite(scores[:, mc.spkcache_len:, :]),
            scores[:, mc.spkcache_len:, :] + mc.scores_boost_latest,
            scores[:, mc.spkcache_len:, :])
    scores = _boost_topk_scores(
        scores, math.floor(per_spk * mc.strong_boost_rate), 2.0)
    scores = _boost_topk_scores(
        scores, math.floor(per_spk * mc.weak_boost_rate), 1.0)
    if sil_per_spk > 0:
        pad = np.full((scores.shape[0], sil_per_spk, n_spk), np.inf)
        scores = np.concatenate([scores, pad], axis=1)
    idx, disabled = _aosc_topk_indices(scores, mc.spkcache_len,
                                       sil_per_spk, mc.max_index)
    g_embs = np.take_along_axis(
        embs, idx[..., None].repeat(embs.shape[2], -1), axis=1)
    g_embs = np.where(disabled[..., None], mean_sil_emb[:, None, :],
                      g_embs)
    g_preds = np.take_along_axis(
        preds, idx[..., None].repeat(preds.shape[2], -1), axis=1)
    g_preds = np.where(disabled[..., None], 0.0, g_preds)
    return g_embs, g_preds


class Model(TorchModel):
    """Sortformer on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`. Its parameters carry
    the JAX tree's names. `last_run` holds the frames and the encoder's ms
    of the last `generate`, or the steps and compressions of the last
    `generate_stream`."""

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
            self._build(config)
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    def _build(self, cfg: ModelConfig) -> None:
        fc, tf, mc = (cfg.fc_encoder_config, cfg.tf_encoder_config,
                      cfg.modules_config)
        cc, ksz = fc.subsampling_conv_channels, fc.subsampling_conv_kernel_size
        sub = nn.Module()
        sub.layers_0 = Conv2d(1, cc, ksz)
        sub.layers_2 = Conv2d(cc, cc, ksz, groups=cc)
        sub.layers_3 = Conv2d(cc, cc, 1)
        sub.layers_5 = Conv2d(cc, cc, ksz, groups=cc)
        sub.layers_6 = Conv2d(cc, cc, 1)
        sub.linear = Linear(cc * math.ceil(fc.num_mel_bins / 8),
                            fc.hidden_size)
        self.fc_encoder = nn.Module()
        self.fc_encoder.subsampling = sub
        self.fc_encoder.layers = nn.ModuleList(
            FCLayer(fc) for _ in range(fc.num_hidden_layers))
        self.tf_encoder = nn.Module()
        self.tf_encoder.embed_positions = Embedding(tf.max_source_positions,
                                                    tf.d_model)
        self.tf_encoder.layers = nn.ModuleList(
            TFLayer(tf) for _ in range(tf.encoder_layers))
        sm = nn.Module()
        sm.encoder_proj = Linear(mc.fc_d_model, mc.tf_d_model)
        sm.first_hidden_to_hidden = Linear(mc.tf_d_model, mc.tf_d_model)
        sm.single_hidden_to_spks = Linear(mc.tf_d_model, mc.num_speakers)
        sm.hidden_to_spks = Linear(2 * mc.tf_d_model, mc.num_speakers)
        self.sortformer_modules = sm

    def pre_encode(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, E) mel -> (B, T//8, hidden)."""
        fc = self.config.fc_encoder_config
        sub = self.fc_encoder.subsampling
        pad = (fc.subsampling_conv_kernel_size - 1) // 2
        x = mel[:, None]                                  # NCHW, H=T, W=mels
        x = F.relu(sub.layers_0(x, stride=2, padding=pad))
        x = sub.layers_2(x, stride=2, padding=pad)
        x = F.relu(sub.layers_3(x))
        x = sub.layers_5(x, stride=2, padding=pad)
        x = F.relu(sub.layers_6(x))
        b, c, t, f = x.shape
        # flatten in NCHW order: (b, t, c, f) -> c*f (reference :192-195)
        return sub.linear(x.permute(0, 2, 1, 3).reshape(b, t, c * f))

    def _fc_attention(self, a: FCAttention, x: torch.Tensor,
                      pos_emb: torch.Tensor) -> torch.Tensor:
        fc = self.config.fc_encoder_config
        b, t, d = x.shape
        h = fc.num_attention_heads
        hd = d // h
        q = a.q_proj(x).view(b, t, h, hd)
        k = a.k_proj(x).view(b, t, h, hd)
        v = a.v_proj(x).view(b, t, h, hd)
        pe = a.relative_k_proj(pos_emb).view(-1, h, hd)
        ac = torch.einsum("bthd,bshd->bhts", q + a.bias_u.to(x.dtype), k)
        bd = _rel_shift(torch.einsum("bthd,phd->bhtp",
                                     q + a.bias_v.to(x.dtype), pe))
        scores = (ac.float() + bd.float()) / math.sqrt(hd)
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhts,bshd->bthd", attn, v).reshape(b, t, d)
        return a.o_proj(out)

    def fc_encode(self, x: torch.Tensor) -> torch.Tensor:
        """Conformer layers over pre-encoded (B, T, hidden)."""
        fc = self.config.fc_encoder_config
        if fc.scale_input:
            x = x * (fc.hidden_size ** 0.5)
        b, t, d = x.shape
        pos_emb = torch.from_numpy(_rel_pos_emb(t, d)).to(x.device, x.dtype)
        for lp in self.fc_encoder.layers:
            f1 = lp.feed_forward1
            x = x + 0.5 * f1.linear2(F.silu(f1.linear1(
                lp.norm_feed_forward1(x))))
            x = x + self._fc_attention(lp.self_attn, lp.norm_self_att(x),
                                       pos_emb)
            c = lp.conv
            h = F.glu(_pointwise(c.pointwise_conv1, lp.norm_conv(x)), dim=-1)
            h = c.depthwise_conv(h, padding=(fc.conv_kernel_size - 1) // 2)
            h = F.silu(c.norm(h))
            x = x + _pointwise(c.pointwise_conv2, h)
            f2 = lp.feed_forward2
            x = x + 0.5 * f2.linear2(F.silu(f2.linear1(
                lp.norm_feed_forward2(x))))
            x = lp.norm_out(x)
        return x

    def tf_encode(self, x: torch.Tensor) -> torch.Tensor:
        """BART-style post-LN transformer with learned positions."""
        tf = self.config.tf_encoder_config
        b, t, d = x.shape
        pos = torch.clamp(torch.arange(t, device=x.device),
                          max=tf.max_source_positions - 1)
        x = x + self.tf_encoder.embed_positions(pos).to(x.dtype)[None]
        h_n = tf.encoder_attention_heads
        hd = d // h_n
        for lp in self.tf_encoder.layers:
            a = lp.self_attn
            q, k, v = (p(x).view(b, t, h_n, hd)
                       for p in (a.q_proj, a.k_proj, a.v_proj))
            scores = torch.einsum("bthd,bshd->bhts", q, k).float() \
                * (hd ** -0.5)
            attn = torch.softmax(scores, dim=-1).to(x.dtype)
            o = torch.einsum("bhts,bshd->bthd", attn, v).reshape(b, t, d)
            x = lp.self_attn_layer_norm(x + a.out_proj(o))
            x = lp.final_layer_norm(x + lp.fc2(F.relu(lp.fc1(x))))
        return x

    def encode_embs(self, embs: torch.Tensor) -> torch.Tensor:
        """Pre-encoded (B, T, hidden) -> (B, T, n_spk) sigmoid preds, f32."""
        sm = self.sortformer_modules
        x = self.tf_encode(sm.encoder_proj(self.fc_encode(embs)))
        x = F.relu(sm.first_hidden_to_hidden(F.relu(x)))
        return torch.sigmoid(sm.single_hidden_to_spks(x).float())

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T_mel, E) -> (B, T_diar, n_spk) sigmoid preds, every frame
        valid: `sortformer_forward` on the frames given."""
        return self.encode_embs(self.pre_encode(mel))

    # --------------------------------------------------------- offline

    @property
    def frame_duration(self) -> float:
        proc = self.config.processor_config
        return (proc.hop_length
                * self.config.fc_encoder_config.subsampling_factor) \
            / proc.sampling_rate

    def _mel_on_device(self, mel: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(mel, np.float32),
                               device=self.device).to(self._dtype)

    @property
    def _dtype(self) -> torch.dtype:
        return self.fc_encoder.subsampling.linear.weight.dtype

    @torch.inference_mode()
    def predict(self, mel: np.ndarray) -> np.ndarray:
        """(T_mel, E) features -> (T_diar, n_spk) speaker probabilities of
        every frame, f32 numpy: the forward on the frames given."""
        return self.forward(self._mel_on_device(mel)[None])[0].cpu().numpy()

    def generate(self, audio, *, sample_rate: int = 16000,
                 threshold: float = 0.5, min_duration: float = 0.0,
                 merge_gap: float = 0.0, verbose: bool = False
                 ) -> DiarizationOutput:
        t0 = time.time()
        proc = self.config.processor_config
        wav = self._load_audio(audio, sample_rate)
        wav, trim_off = trim_silence(wav, proc.sampling_rate)
        trim_sec = trim_off / proc.sampling_rate
        wav = wav / (np.abs(wav).max() + 1e-3)

        mel = extract_mel_features(wav, proc, device=self.device)
        t1 = time.perf_counter()
        preds = self.predict(mel)
        self.last_run = {"mel_frames": int(mel.shape[0]),
                         "frames": int(preds.shape[0]),
                         "forward_ms": (time.perf_counter() - t1) * 1e3}
        segments = preds_to_segments(preds, self.frame_duration, threshold,
                                     min_duration, merge_gap)
        if trim_off:
            segments = [DiarizationSegment(s.start + trim_sec,
                                           s.end + trim_sec, s.speaker)
                        for s in segments]
        speakers = {s.speaker for s in segments}
        return DiarizationOutput(segments=segments, speaker_probs=preds,
                                 num_speakers=len(speakers),
                                 total_time=time.time() - t0)

    __call__ = generate

    # -------------------------------------------------------- streaming

    def init_streaming_state(self) -> StreamingState:
        emb = self.config.fc_encoder_config.hidden_size
        spk = self.config.modules_config.num_speakers
        z = np.zeros((1, 0, emb), np.float32)
        zp = np.zeros((1, 0, spk), np.float32)
        return StreamingState(z.copy(), zp.copy(), z.copy(), zp.copy())

    @torch.inference_mode()
    def streaming_step(self, chunk_mel: np.ndarray,
                       state: StreamingState
                       ) -> Tuple[np.ndarray, StreamingState]:
        """(T_mel, E) chunk features -> (chunk preds, new state)."""
        chunk_embs = self.pre_encode(self._mel_on_device(chunk_mel)[None]) \
            .float().cpu().numpy()

        allb = np.concatenate([state.spkcache, state.fifo, chunk_embs],
                              axis=1)
        all_preds = self.encode_embs(self._mel_on_device(allb)) \
            .cpu().numpy()
        c0 = state.spkcache.shape[1]
        f0 = state.fifo.shape[1]
        chunk_preds = all_preds[:, c0 + f0:]
        new = StreamingState(
            spkcache=state.spkcache,
            spkcache_preds=all_preds[:, :c0]
            if c0 else state.spkcache_preds,
            fifo=np.concatenate([state.fifo, chunk_embs], axis=1),
            fifo_preds=np.concatenate(
                [all_preds[:, c0: c0 + f0] if f0 else state.fifo_preds,
                 chunk_preds], axis=1),
            frames_processed=state.frames_processed
            + chunk_preds.shape[1],
            mean_sil_emb=state.mean_sil_emb,
            n_sil_frames=state.n_sil_frames)
        new = self._maybe_compress(new)
        return chunk_preds[0], new

    def _maybe_compress(self, state: StreamingState) -> StreamingState:
        mc = self.config.modules_config
        fifo_max = max(mc.fifo_len, mc.chunk_len)
        if state.fifo.shape[1] <= fifo_max:
            return state
        pop = state.fifo.shape[1] - fifo_max
        if mc.use_aosc:
            # v2.1 transfers FIFO overflow in update-period batches and
            # maintains the running silence profile (reference :1429-1503)
            pop = min(pop, mc.spkcache_update_period)
        popped = state.fifo[:, :pop]
        popped_preds = state.fifo_preds[:, :pop]
        mean_sil = state.mean_sil_emb
        n_sil = state.n_sil_frames
        if mc.use_aosc:
            if mean_sil is None:
                mean_sil = np.zeros((1, state.fifo.shape[2]), np.float32)
            mean_sil, n_sil = _silence_profile(
                mean_sil, n_sil, popped, popped_preds, mc.sil_threshold)
        cache = np.concatenate([state.spkcache, popped], 1)
        cache_preds = np.concatenate([state.spkcache_preds, popped_preds],
                                     1)
        if cache.shape[1] > mc.spkcache_len:
            self.last_run["compressions"] = \
                self.last_run.get("compressions", 0) + 1
            if mc.use_aosc:
                cache, cache_preds = compress_spkcache_aosc(
                    cache, cache_preds,
                    mean_sil if mean_sil is not None else
                    np.zeros((1, cache.shape[2]), np.float32), mc)
            else:
                # v1: keep frames with the highest total speaker activity
                scores = np.log(np.clip(cache_preds[0], 1e-7, 1.0)).sum(-1)
                top = np.sort(np.argsort(-scores)[: mc.spkcache_len])
                cache = cache[:, top]
                cache_preds = cache_preds[:, top]
        return StreamingState(cache, cache_preds, state.fifo[:, pop:],
                              state.fifo_preds[:, pop:],
                              state.frames_processed,
                              mean_sil_emb=mean_sil, n_sil_frames=n_sil)

    def generate_stream(self, audio, *, sample_rate: int = 16000,
                        threshold: float = 0.5,
                        chunk_seconds: float = 15.0):
        """Yield (chunk_preds, frame_offset) per chunk; final yield is the
        assembled DiarizationOutput. The chunk is the config's `chunk_len`
        diarization frames; `chunk_seconds` is accepted and unused, as in
        the JAX package."""
        proc = self.config.processor_config
        wav = self._load_audio(audio, sample_rate)
        if self.config.modules_config.use_aosc:
            # v2.1 skips silence trimming + peak norm (reference :1117-1131)
            mel = extract_mel_features(wav, proc, normalize=False,
                                       device=self.device)
        else:
            wav, _ = trim_silence(wav, proc.sampling_rate)
            wav = wav / (np.abs(wav).max() + 1e-3)
            mel = extract_mel_features(wav, proc, device=self.device)

        mc = self.config.modules_config
        chunk_frames = mc.chunk_len * mc.subsampling_factor
        state = self.init_streaming_state()
        self.last_run = {"steps": 0, "compressions": 0}
        all_preds = []
        for i in range(0, mel.shape[0], chunk_frames):
            chunk = mel[i: i + chunk_frames]
            if chunk.shape[0] < mc.subsampling_factor:
                break
            preds, state = self.streaming_step(chunk, state)
            self.last_run["steps"] += 1
            all_preds.append(preds)
            yield preds, state.frames_processed - preds.shape[0]
        self.last_run["spkcache"] = int(state.spkcache.shape[1])
        preds = np.concatenate(all_preds, axis=0) if all_preds else \
            np.zeros((0, mc.num_speakers))
        segs = preds_to_segments(preds, self.frame_duration, threshold)
        yield DiarizationOutput(
            segments=segs, speaker_probs=preds,
            num_speakers=len({s.speaker for s in segs}))

    # ---------------------------------------------------------- loading

    @staticmethod
    def _load_audio(audio, sample_rate: int) -> np.ndarray:
        if isinstance(audio, str):
            from ....audio_io import read
            wav, sr = read(audio)
            if wav.ndim > 1:
                wav = wav.mean(axis=1)
            sample_rate = sr
        else:
            wav = np.asarray(audio, np.float32).reshape(-1)
        if sample_rate != 16000:
            from ....utils import resample_audio
            wav = np.asarray(resample_audio(wav, sample_rate, 16000))
        return wav.astype(np.float32)

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """A NeMo checkpoint's names -> the JAX tree's
        (`subsampling.layers.N` -> `layers_N`, batch norms' step counters
        dropped); each conv weight read into the JAX tree's layout (HWIO,
        WIO) from the layout its shape shows against this model's
        (`convs_to_wio`, `conv2d_to_hwio`)."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for k, v in weights.items():
            if "num_batches_tracked" in k:
                continue
            k = k.replace("subsampling.layers.", "subsampling.layers_")
            out[k] = np.asarray(v)
        for k, v in out.items():
            if k in shapes and np.ndim(v) == 4:
                out[k] = conv2d_to_hwio(k, v, shapes[k])
        return convs_to_wio(out, shapes, lambda k, v: np.ndim(v) == 3 and (
            "pointwise_conv" in k or "depthwise_conv" in k))


__all__ = ["Model", "ModelConfig", "DiarizationOutput",
           "DiarizationSegment", "StreamingState", "extract_mel_features",
           "preds_to_segments", "trim_silence", "compress_spkcache_aosc"]
