"""SenseVoice-Small: non-autoregressive multilingual CTC ASR with rich
tags (language, emotion, audio event).

Counterpart of mlx_audio_tpu/stt/models/sensevoice/sensevoice.py:

* the front end (`apply_lfr` :98-113, `parse_am_mvn` :116-129, the
  CMVN): the port's Kaldi fbank at int16 scale, LFR 7/6, `(x + shift) *
  scale`, on the model's device;
* the SANM encoder (`_init_sanm_layer`, `_sinusoidal_positions`,
  `_sanm_attention`, `_sanm_layer`, `sensevoice_forward` :134-264):
  positions from 1 with JAX's `half - 1` divisor, fused q/k/v, the FSMN
  memory on v (zero-padded, shifted by `sanm_shift`) added to the
  attention's output, `encoders0` without a residual when its input
  width differs, 49 + 20 blocks with `after_norm` and `tp_norm`, the CTC
  log-softmax; `SANMEncoder` is Fun-ASR-Nano's audio encoder too;
* `generate` (:319-363): the four query rows [language, event, emotion,
  text norm] from `embed`, the rich tags from rows 0-2, the CTC collapse
  over rows 4 on; `sanitize` and `post_load_hook` (:367-400).

Departures from the JAX package:

* the encoder runs the frames the audio has; JAX pads them to a
  `FRAME_BUCKETS` length under a mask (a compile-count workaround), and
  its masked result on the valid rows is the unpadded one
  (`test_torch_sensevoice.py::test_unpadded_run_equals_jax_bucketed`);
* a bf16 model's attention scores and softmax run in f32, as JAX's do
  once its f32 mask bias is added; the probabilities meet v in f32;
* `post_load_hook` raises where the directory's tokenizer files are
  present but none loads (a BPE model without sentencepiece and no
  `tokens.json`); JAX's leaves no tokenizer and prints ids.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, convs_to_wio
from ....nn import Conv1d, Embedding, LayerNorm, Linear
from ...models.base import STTOutput

LID_DICT = {"auto": 0, "zh": 3, "en": 4, "yue": 7, "ja": 11, "ko": 12,
            "nospeech": 13}
TEXTNORM_DICT = {"withitn": 14, "woitn": 15}
LID_MAP = {24884: "zh", 24885: "en", 24888: "yue", 24892: "ja",
           24896: "ko", 24992: "nospeech"}
EMO_MAP = {25001: "happy", 25002: "sad", 25003: "angry", 25004: "neutral",
           25005: "fearful", 25006: "disgusted", 25007: "surprised",
           25008: "other", 25009: "unk"}
EVENT_MAP = {24993: "Speech", 24995: "BGM", 24997: "Laughter",
             24999: "Applause"}
BPE_MODEL = "chn_jpn_yue_eng_ko_spectok.bpe.model"


@dataclass
class EncoderConfig(BaseModelArgs):
    output_size: int = 512
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 50
    tp_blocks: int = 20
    kernel_size: int = 11
    sanm_shift: int = 0
    normalize_before: bool = True

    @classmethod
    def from_dict(cls, params: dict) -> "EncoderConfig":
        if "sanm_shfit" in params and "sanm_shift" not in params:
            params = dict(params, sanm_shift=params["sanm_shfit"])
        return super().from_dict(params)


@dataclass
class FrontendConfig(BaseModelArgs):
    fs: int = 16000
    window: str = "hamming"
    n_mels: int = 80
    frame_length: int = 25
    frame_shift: int = 10
    lfr_m: int = 7
    lfr_n: int = 6


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "sensevoice"
    vocab_size: int = 25055
    input_size: int = 560
    encoder_conf: Optional[EncoderConfig] = None
    frontend_conf: Optional[FrontendConfig] = None
    cmvn_means: Optional[List[float]] = None
    cmvn_istd: Optional[List[float]] = None
    model_path: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.encoder_conf, dict):
            self.encoder_conf = EncoderConfig.from_dict(self.encoder_conf)
        if self.encoder_conf is None:
            self.encoder_conf = EncoderConfig()
        if isinstance(self.frontend_conf, dict):
            self.frontend_conf = FrontendConfig.from_dict(
                self.frontend_conf)
        if self.frontend_conf is None:
            self.frontend_conf = FrontendConfig()


# ----------------------------------------------------------- frontend

def apply_lfr(feats: np.ndarray, lfr_m: int = 7, lfr_n: int = 6
              ) -> np.ndarray:
    """Stack lfr_m frames every lfr_n with edge replication on both
    sides."""
    t, d = feats.shape
    t_out = math.ceil(t / lfr_n)
    left = (lfr_m - 1) // 2
    if left:
        feats = np.concatenate([np.tile(feats[:1], (left, 1)), feats], 0)
    need = (t_out - 1) * lfr_n + lfr_m
    if need > feats.shape[0]:
        feats = np.concatenate(
            [feats, np.tile(feats[-1:], (need - feats.shape[0], 1))], 0)
    idx = np.arange(t_out)[:, None] * lfr_n + np.arange(lfr_m)[None, :]
    return feats[idx].reshape(t_out, lfr_m * d).astype(np.float32)


def parse_am_mvn(path: Union[str, Path]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    text = Path(path).read_text()
    shift = re.search(r"<AddShift>.*?<LearnRateCoef>\s+\d+\s+\[(.*?)\]",
                      text, re.DOTALL)
    scale = re.search(r"<Rescale>.*?<LearnRateCoef>\s+\d+\s+\[(.*?)\]",
                      text, re.DOTALL)
    if not shift or not scale:
        raise ValueError(f"cannot parse am.mvn: {path}")
    return (np.array([float(x) for x in shift.group(1).split()],
                     np.float32),
            np.array([float(x) for x in scale.group(1).split()],
                     np.float32))


def kaldi_lfr_features(audio, fc: FrontendConfig, device,
                       cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None
                       ) -> np.ndarray:
    """Audio in [-1, 1] -> Kaldi fbank at int16 scale (no dither, on
    `device`) -> LFR -> CMVN, as f32 numpy (T, lfr_m * n_mels)."""
    from ....dsp import compute_fbank_kaldi

    fbank = compute_fbank_kaldi(
        np.asarray(audio, np.float32).reshape(-1) * 32768.0,
        sample_rate=fc.fs, win_len=int(fc.fs * fc.frame_length / 1000),
        win_inc=int(fc.fs * fc.frame_shift / 1000), num_mels=fc.n_mels,
        win_type=fc.window, dither=0.0, device=device).cpu().numpy()
    feats = apply_lfr(fbank, fc.lfr_m, fc.lfr_n)
    if cmvn is not None and len(cmvn[0]) == feats.shape[1]:
        feats = (feats + cmvn[0]) * cmvn[1]
    return feats


# -------------------------------------------------------------- encoder

def sinusoidal_positions(t: int, dim: int, device) -> torch.Tensor:
    """Positions 1..T, half sin / half cos, with the JAX package's
    `half - 1` divisor (f32)."""
    pos = torch.arange(1, t + 1, dtype=torch.float32, device=device)
    half = dim // 2
    inv = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / (half - 1)))
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class SANMAttention(nn.Module):
    def __init__(self, in_size: int, size: int, kernel: int):
        super().__init__()
        self.linear_q_k_v = Linear(in_size, 3 * size)
        self.linear_out = Linear(size, size)
        self.fsmn_block = Conv1d(size, size, kernel, bias=False,
                                 groups=size)


class FeedForward(nn.Module):
    def __init__(self, size: int, units: int):
        super().__init__()
        self.w_1 = Linear(size, units)
        self.w_2 = Linear(units, size)


class SANMLayer(nn.Module):
    def __init__(self, in_size: int, cfg: EncoderConfig):
        super().__init__()
        self.in_size = in_size
        self.cfg = cfg
        size = cfg.output_size
        self.self_attn = SANMAttention(in_size, size, cfg.kernel_size)
        self.feed_forward = FeedForward(size, cfg.linear_units)
        self.norm1 = LayerNorm(in_size)
        self.norm2 = LayerNorm(size)

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        size, heads = cfg.output_size, cfg.attention_heads
        hd = size // heads
        p = self.self_attn
        q, k, v = p.linear_q_k_v(x).chunk(3, dim=-1)
        kernel = p.fsmn_block.weight.shape[-1]
        lp = (kernel - 1) // 2 + cfg.sanm_shift
        fsmn = p.fsmn_block(v, padding=(lp, kernel - 1 - lp)) + v
        q = (q * hd ** -0.5).reshape(b, t, heads, hd).transpose(1, 2)
        k = k.reshape(b, t, heads, hd).transpose(1, 2)
        vh = v.reshape(b, t, heads, hd).transpose(1, 2)
        attn = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1)
        out = (attn @ vh.float()).transpose(1, 2).reshape(b, t, size)
        return p.linear_out(out.to(x.dtype)) + fsmn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.attention(self.norm1(x))
        x = x + attn if self.in_size == self.cfg.output_size else attn
        ff = self.feed_forward
        return x + ff.w_2(F.relu(ff.w_1(self.norm2(x))))


class SANMEncoder(nn.Module):
    """`encoders0.0`, `encoders.N`, `after_norm`, `tp_encoders.N`,
    `tp_norm` (the JAX tree's `encoder`, Fun-ASR-Nano's
    `audio_encoder`)."""

    def __init__(self, input_size: int, cfg: EncoderConfig):
        super().__init__()
        self.input_size = input_size
        self.cfg = cfg
        self.encoders0 = nn.ModuleList([SANMLayer(input_size, cfg)])
        self.encoders = nn.ModuleList(SANMLayer(cfg.output_size, cfg)
                                      for _ in range(cfg.num_blocks - 1))
        self.after_norm = LayerNorm(cfg.output_size)
        self.tp_encoders = nn.ModuleList(SANMLayer(cfg.output_size, cfg)
                                         for _ in range(cfg.tp_blocks))
        self.tp_norm = LayerNorm(cfg.output_size)

    def forward(self, speech: torch.Tensor) -> torch.Tensor:
        """(B, T, input_size) -> (B, T, output_size), every row valid."""
        t = speech.shape[1]
        pos = sinusoidal_positions(t, self.input_size, speech.device)
        x = (speech.float() * self.cfg.output_size ** 0.5 + pos[None]).to(
            speech.dtype)
        for layer in self.encoders0:
            x = layer(x)
        for layer in self.encoders:
            x = layer(x)
        x = self.after_norm(x)
        for layer in self.tp_encoders:
            x = layer(x)
        return self.tp_norm(x)


def sanm_sanitize(model: nn.Module, weights: Dict) -> Dict[str, np.ndarray]:
    """The SANM memory convs' weights read into WIO from the layout their
    shape shows against `model`'s (torch (C, 1, K), MLX (C, K, 1) or WIO
    (K, 1, C)); the rest as they are."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out = {k: np.asarray(v) for k, v in weights.items()}
    return convs_to_wio(out, shapes, lambda k, v: k.endswith(
        "fsmn_block.weight") and np.ndim(v) == 3)


# ---------------------------------------------------------------- model

class Model(TorchModel):
    """SenseVoice on `device`: the card by default; without CUDA the
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
        enc = config.encoder_conf
        with torch.device(device):
            self.encoder = SANMEncoder(config.input_size, enc)
            self.ctc_lo = Linear(enc.output_size, config.vocab_size)
            self.embed = Embedding(16, config.input_size)
        self.blank_id = 0
        self._cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._tokenizer = None
        self._token_list: Optional[List[str]] = None
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return self.config.frontend_conf.fs

    @property
    def dtype(self) -> torch.dtype:
        return self.ctc_lo.weight.dtype

    # frontend ---------------------------------------------------------

    def _extract_features(self, audio: np.ndarray) -> np.ndarray:
        return kaldi_lfr_features(audio, self.config.frontend_conf,
                                  self.device, self._cmvn)

    def _build_speech(self, feats: np.ndarray, language: str,
                      use_itn: bool) -> torch.Tensor:
        """The four query rows [language, 1, 2, text norm] of `embed`
        before the features -> (T + 4, input_size) on the device."""
        lid = LID_DICT.get(language, 0)
        textnorm = TEXTNORM_DICT["withitn" if use_itn else "woitn"]
        prefix = self.embed.weight[[lid, 1, 2, textnorm]]
        feats = torch.as_tensor(feats, device=self.device)
        return torch.cat([prefix.float(), feats.float()], dim=0)

    @torch.inference_mode()
    def log_probs(self, speech: torch.Tensor) -> torch.Tensor:
        """(T, input_size) query rows and features -> (T, vocab) f32 CTC
        log-probabilities."""
        x = self.encoder(speech[None].to(self.dtype))
        return torch.log_softmax(self.ctc_lo(x).float(), dim=-1)[0]

    # decode -----------------------------------------------------------

    def _decode_tokens(self, ids: List[int]) -> str:
        if self._tokenizer is not None:
            return self._tokenizer.decode(ids)
        if self._token_list is not None:
            return "".join(self._token_list[t] for t in ids
                           if 0 <= t < len(self._token_list)) \
                .replace("▁", " ").strip()
        return " ".join(str(t) for t in ids)

    def transcribe_ids(self, audio, *, language: str = "auto",
                       use_itn: bool = False) -> Tuple[List[int], dict]:
        """Audio -> (CTC ids, rich tags); the frames and times land in
        `last_run`."""
        import time

        from ...models.llm_stt import as_audio

        t0 = time.perf_counter()
        audio = as_audio(audio, self.sample_rate)
        feats = self._extract_features(audio)
        speech = self._build_speech(feats, language, use_itn)
        lp = self.log_probs(speech)
        heads = lp[:3].argmax(-1).tolist()
        pred = lp[4:].argmax(-1)
        keep = torch.ones_like(pred, dtype=torch.bool)
        keep[1:] = pred[1:] != pred[:-1]
        ids = pred[keep]
        ids = ids[ids != self.blank_id].tolist()
        rich = {"language": LID_MAP.get(heads[0], "unknown"),
                "emotion": EMO_MAP.get(heads[1], f"token_{heads[1]}"),
                "event": EVENT_MAP.get(heads[2], f"token_{heads[2]}")}
        self.last_run = {"frames": speech.shape[0],
                         "ms": (time.perf_counter() - t0) * 1e3}
        return ids, rich

    def generate(self, audio, *, language: str = "auto",
                 use_itn: bool = False, verbose: bool = False,
                 **kwargs) -> STTOutput:
        ids, rich = self.transcribe_ids(audio, language=language,
                                        use_itn=use_itn)
        text = self._decode_tokens(ids)
        if verbose:
            print(f"Language: {rich['language']}\n"
                  f"Emotion: {rich['emotion']}\nEvent: {rich['event']}\n"
                  f"Text: {text}")
        return STTOutput(text=text, language=rich["language"],
                         segments=[{"text": text, **rich}])

    __call__ = generate

    # loading -----------------------------------------------------------

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """`ctc.ctc_lo.` -> `ctc_lo.`, the memory convs to WIO (from the
        layout their shape shows); `load_jax_params` takes it from
        there."""
        return sanm_sanitize(self, {k.replace("ctc.ctc_lo.", "ctc_lo."): v
                                    for k, v in weights.items()})

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """CMVN from `am.mvn` (else the config's), and the tokenizer: the
        BPE model through sentencepiece where it is installed, else a
        `tokens.json` piece list; tokenizer files of which none loads
        raise."""
        model_path = Path(model_path)
        mvn = model_path / "am.mvn"
        if mvn.exists():
            model._cmvn = parse_am_mvn(mvn)
        elif model.config.cmvn_means is not None:
            model._cmvn = (np.asarray(model.config.cmvn_means, np.float32),
                           np.asarray(model.config.cmvn_istd, np.float32))
        bpe = model_path / BPE_MODEL
        tokens = model_path / "tokens.json"
        if bpe.exists():
            try:
                import sentencepiece as spm
            except ImportError:
                if not tokens.exists():
                    raise RuntimeError(
                        f"{bpe} needs sentencepiece, which is not "
                        f"installed, and {model_path} has no tokens.json")
            else:
                sp = spm.SentencePieceProcessor()
                sp.Load(str(bpe))
                model._tokenizer = sp
        if model._tokenizer is None and tokens.exists():
            model._token_list = json.loads(tokens.read_text())
        return model


SenseVoiceSmall = Model

__all__ = ["Model", "SenseVoiceSmall", "ModelConfig", "EncoderConfig",
           "FrontendConfig", "SANMEncoder", "SANMLayer", "apply_lfr",
           "parse_am_mvn", "kaldi_lfr_features", "sinusoidal_positions",
           "sanm_sanitize"]
