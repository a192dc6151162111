"""FSMN-VAD: FunASR's streaming voice-activity detector.

Counterpart of mlx_audio_tpu/vad/models/fsmn/fsmn.py:

* the encoder (`init_encoder`, `encoder_forward` :41-90): in and out
  affine pairs, FSMN blocks (a bias-free down-projection, the causal
  depthwise memory conv left-padded by (lorder - 1) * lstride with its
  residual, an up-projection and ReLU), a softmax over the pdfs; run on
  the model's device;
* the host code, copied: `load_cmvn`, `apply_lfr`, `extract_features`
  (on the port's `dsp.compute_fbank_kaldi` at int16 scale, no dither),
  `_WindowDetector`, `_VadSession` (the windowed hangover machine giving
  [[start_ms, end_ms]] segments) and `compute_decibel` (:92-313);
* `detect`, `create_session`, `sanitize` and `post_load_hook`
  (:316-408).

Departure: `sanitize` reads the memory conv's layout (torch (O, 1, K),
MLX (O, K, 1) or WIO) from the model's own shapes, where JAX's takes any
weight whose last axis differs from its first for torch's.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....model import TorchModel, check_device, convs_to_wio
from ....nn import Conv1d, Linear
from .config import FSMNEncoderConfig, ModelConfig


# ------------------------------------------------------------- encoder

class FSMNBlock(nn.Module):
    def __init__(self, cfg: FSMNEncoderConfig):
        super().__init__()
        self.linear = Linear(cfg.linear_dim, cfg.proj_dim, bias=False)
        self.fsmn_block = nn.Module()
        self.fsmn_block.conv_left = Conv1d(cfg.proj_dim, cfg.proj_dim,
                                           cfg.lorder, bias=False,
                                           groups=cfg.proj_dim)
        self.affine = Linear(cfg.proj_dim, cfg.linear_dim)


class Encoder(nn.Module):
    def __init__(self, cfg: FSMNEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.in_linear1 = Linear(cfg.input_dim, cfg.input_affine_dim)
        self.in_linear2 = Linear(cfg.input_affine_dim, cfg.linear_dim)
        self.fsmn = nn.ModuleList(FSMNBlock(cfg)
                                  for _ in range(cfg.fsmn_layers))
        self.out_linear1 = Linear(cfg.linear_dim, cfg.output_affine_dim)
        self.out_linear2 = Linear(cfg.output_affine_dim, cfg.output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, input_dim) -> (B, T, output_dim) softmax posteriors."""
        cfg = self.cfg
        x = F.relu(self.in_linear2(self.in_linear1(x)))
        pad = (cfg.lorder - 1) * cfg.lstride
        for blk in self.fsmn:
            h = blk.linear(x)
            h = h + blk.fsmn_block.conv_left(h, padding=(pad, 0),
                                             dilation=cfg.lstride)
            x = F.relu(blk.affine(h))
        return torch.softmax(self.out_linear2(self.out_linear1(x)), dim=-1)


# ------------------------------------------------------------ frontend

def load_cmvn(path: Union[str, Path]) -> Tuple[np.ndarray, np.ndarray]:
    """Kaldi-Nnet `am.mvn`: <AddShift> [...] <Rescale> [...] pairs."""
    text = Path(path).read_text()
    shift = re.search(r"<AddShift>.*?\[(.*?)\]", text, re.DOTALL)
    scale = re.search(r"<Rescale>.*?\[(.*?)\]", text, re.DOTALL)
    if not shift or not scale:
        raise ValueError(f"cannot parse CMVN file: {path}")
    return (np.array([float(v) for v in shift.group(1).split()], np.float32),
            np.array([float(v) for v in scale.group(1).split()], np.float32))


def apply_lfr(feats: np.ndarray, lfr_m: int = 5, lfr_n: int = 1
              ) -> np.ndarray:
    """Low-frame-rate stacking: lfr_m frames concatenated every lfr_n,
    the first frame repeated (lfr_m-1)//2 times on the left, the last on
    the right."""
    T, D = feats.shape
    left = (lfr_m - 1) // 2
    if left:
        feats = np.concatenate([np.tile(feats[:1], (left, 1)), feats], 0)
    Tp = feats.shape[0]
    T_out = (Tp + lfr_n - 1) // lfr_n
    need = (T_out - 1) * lfr_n + lfr_m
    if need > Tp:
        feats = np.concatenate(
            [feats, np.tile(feats[-1:], (need - Tp, 1))], 0)
    idx = (np.arange(T_out)[:, None] * lfr_n) + np.arange(lfr_m)[None, :]
    return feats[idx].reshape(T_out, lfr_m * D).astype(np.float32)


def extract_features(waveform: np.ndarray, cfg: ModelConfig,
                     cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                     device=None) -> np.ndarray:
    """waveform -> Kaldi fbank (int16 scale, no dither, on `device`) ->
    LFR -> CMVN."""
    from ....dsp import compute_fbank_kaldi
    sr = cfg.sample_rate
    fbank = compute_fbank_kaldi(
        waveform.astype(np.float32) * 32768.0, sample_rate=sr,
        win_len=sr * cfg.frame_length // 1000,
        win_inc=sr * cfg.frame_shift // 1000, num_mels=cfg.n_mels,
        win_type="hamming", dither=0.0, device=device).cpu().numpy()
    feats = apply_lfr(fbank, cfg.lfr_m, cfg.lfr_n)
    if cmvn is not None and len(cmvn[0]) == feats.shape[1]:
        feats = (feats + cmvn[0]) * cmvn[1]
    return feats


# ----------------------------------------------------- segment tracking

@dataclass
class _Segment:
    start_frame: int
    end_frame: int          # exclusive: end_ms = end_frame * frame_ms
    closed: bool = False
    emitted: bool = False


class _WindowDetector:
    """Sliding majority window (FunASR's WindowDetector)."""

    def __init__(self, window_ms: int, sil2speech_ms: int,
                 speech2sil_ms: int, frame_ms: int):
        self.size = window_ms // frame_ms
        self.sil2speech = sil2speech_ms // frame_ms
        self.speech2sil = speech2sil_ms // frame_ms
        self.reset()

    def reset(self):
        self.buf = [0] * self.size
        self.pos = 0
        self.total = 0
        self.in_speech = False

    def step(self, is_speech: bool) -> str:
        """-> one of sil2speech / speech2sil / sil / speech."""
        v = 1 if is_speech else 0
        self.total += v - self.buf[self.pos]
        self.buf[self.pos] = v
        self.pos = (self.pos + 1) % self.size
        if not self.in_speech and self.total >= self.sil2speech:
            self.in_speech = True
            return "sil2speech"
        if self.in_speech and self.total <= self.speech2sil:
            self.in_speech = False
            return "speech2sil"
        return "speech" if self.in_speech else "sil"


class _VadSession:
    """Streaming FunASR-style detection over accumulated frame scores:
    frame decibels and sil-pdf scores through the windowed hangover
    machine; segments are [[start_ms, end_ms]] with start-lookback and
    end-lookahead trimming."""

    def __init__(self, cfg: ModelConfig,
                 decibel_thres: float = -100.0,
                 snr_thres: float = -100.0,
                 max_single_segment_time: int = 60000,
                 lookback_time_start_point: int = 200,
                 lookahead_time_end_point: int = 100,
                 noise_frames_for_snr: int = 100):
        self.cfg = cfg
        self.frame_ms = cfg.frame_in_ms
        self.window = _WindowDetector(cfg.window_size_ms,
                                      cfg.sil_to_speech_time_thres,
                                      cfg.speech_to_sil_time_thres,
                                      self.frame_ms)
        self.decibel_thres = decibel_thres
        self.snr_thres = snr_thres
        self.max_seg_frames = max_single_segment_time // self.frame_ms
        self.lookback = lookback_time_start_point // self.frame_ms
        self.lookahead = lookahead_time_end_point // self.frame_ms
        self.end_sil_frames = max(
            0, (cfg.max_end_silence_time - cfg.speech_to_sil_time_thres)
            // self.frame_ms)
        self.noise_n = noise_frames_for_snr

        self.scores: List[float] = []       # sil-pdf prob per frame
        self.decibel: List[float] = []
        self.segments: List[_Segment] = []
        self.cur: Optional[_Segment] = None
        self.frames_done = 0
        self.silence_run = 0
        self.noise_avg_db = -100.0

    def _frame_is_speech(self, t: int) -> bool:
        db = self.decibel[t] if t < len(self.decibel) else -100.0
        if db < self.decibel_thres:
            return False
        sil = min(max(self.scores[t], 1e-7), 1.0 - 1e-7)
        speech = 1.0 - sil
        if speech >= sil + self.cfg.speech_noise_thres:
            return db - self.noise_avg_db >= self.snr_thres
        # silence frame: update the running noise level
        if self.noise_avg_db < -99.9:
            self.noise_avg_db = db
        else:
            self.noise_avg_db = (db + self.noise_avg_db *
                                 (self.noise_n - 1)) / self.noise_n
        return False

    def _open(self, start_frame: int, cur: int) -> None:
        seg = _Segment(max(0, start_frame), cur + 1)
        self.segments.append(seg)
        self.cur = seg

    def _close(self, end_frame: int) -> None:
        if self.cur is not None:
            self.cur.end_frame = max(self.cur.start_frame + 1, end_frame + 1)
            self.cur.closed = True
            self.cur = None
        self.window.reset()
        self.silence_run = 0

    def _step_frame(self, t: int, is_final: bool) -> None:
        speech = self._frame_is_speech(t)
        change = self.window.step(speech)

        if change == "sil2speech":
            self.silence_run = 0
            if self.cur is None:
                latency = self.window.size + self.lookback
                self._open(t - latency, t)
            else:
                self.cur.end_frame = t + 1
        elif change in ("speech", "speech2sil"):
            self.silence_run = 0
            if self.cur is not None:
                if t - self.cur.start_frame + 1 > self.max_seg_frames:
                    self._close(t)
                else:
                    self.cur.end_frame = t + 1
        else:  # sil
            self.silence_run += 1
            if self.cur is not None and \
                    self.silence_run >= self.end_sil_frames:
                look = max(0, self.end_sil_frames - self.lookahead - 1)
                self._close(t - look)

        if is_final and self.cur is not None:
            self._close(t)

    def feed(self, scores: np.ndarray, decibel: np.ndarray,
             is_final: bool) -> List[List[int]]:
        """scores (T,) sil-pdf prob; decibel (T,). Returns newly completed
        [[start_ms, end_ms]] segments."""
        self.scores.extend(np.asarray(scores, np.float64).tolist())
        self.decibel.extend(np.asarray(decibel, np.float64).tolist())
        n = len(self.scores)
        for t in range(self.frames_done, n):
            self._step_frame(t, is_final and t == n - 1)
        self.frames_done = n

        done = []
        for seg in self.segments:
            if seg.closed and not seg.emitted:
                seg.emitted = True
                done.append([seg.start_frame * self.frame_ms,
                             seg.end_frame * self.frame_ms])
        return done


def compute_decibel(waveform: np.ndarray, sample_rate: int,
                    frame_length_ms: int, frame_shift_ms: int) -> np.ndarray:
    """Per-frame 10*log10 energy."""
    flen = sample_rate * frame_length_ms // 1000
    fshift = sample_rate * frame_shift_ms // 1000
    n = (len(waveform) - flen) // fshift + 1
    if n <= 0:
        return np.zeros((0,), np.float32)
    idx = np.arange(n)[:, None] * fshift + np.arange(flen)[None, :]
    frames = waveform[idx]
    return 10.0 * np.log10((frames * frames).sum(axis=1) + 1e-6)


# --------------------------------------------------------------- model

class Model(TorchModel):
    """FSMN-VAD on `device`: the card by default; without CUDA the
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
        with torch.device(device):
            self.encoder = Encoder(config.encoder)
        self._cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.requires_grad_(False)
        self.eval()

    @torch.inference_mode()
    def scores(self, features: np.ndarray) -> np.ndarray:
        """(T, input_dim) features -> (T, output_dim) pdf posteriors."""
        x = torch.as_tensor(np.asarray(features, np.float32),
                            device=self.device)
        return self.encoder(x[None].to(self.encoder.in_linear1.weight.dtype)
                            )[0].float().cpu().numpy()

    def _sil_scores(self, scores: np.ndarray) -> np.ndarray:
        ids = np.asarray(self.config.sil_pdf_ids, np.int64)
        return scores[:, ids].sum(axis=1)

    def detect(self, audio: Union[str, np.ndarray],
               sample_rate: int = 16000) -> List[List[int]]:
        """audio -> [[start_ms, end_ms], ...] speech segments."""
        cfg = self.config
        if isinstance(audio, str):
            from ....audio_io import read as audio_read
            from ....utils import resample_audio
            waveform, sr = audio_read(audio)
            if waveform.ndim > 1:
                waveform = waveform.mean(axis=-1)
            if sr != cfg.sample_rate:
                waveform = resample_audio(waveform, sr, cfg.sample_rate)
            waveform = np.asarray(waveform, np.float32)
        else:
            waveform = np.asarray(audio, np.float32)

        feats = extract_features(waveform, cfg, self._cmvn, self.device)
        if feats.shape[0] == 0:
            return []
        sil = self._sil_scores(self.scores(feats))
        db = compute_decibel(waveform * 32768.0, cfg.sample_rate,
                             cfg.frame_length, cfg.frame_in_ms)
        n = min(len(sil), len(db)) if len(db) else len(sil)
        db = db[:n] if len(db) else np.full((len(sil),), 0.0, np.float32)
        session = _VadSession(cfg)
        return session.feed(sil[:len(db)], db, is_final=True)

    def create_session(self) -> _VadSession:
        """Streaming session; feed (sil_scores, decibels) chunks."""
        return _VadSession(self.config)

    __call__ = detect

    # loading ---------------------------------------------------------

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """Checkpoint names -> the JAX tree's (`encoder.` prefixed), the
        memory convs' weights read into WIO from the layout their shape
        shows against this model's."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for k, v in weights.items():
            if not k.startswith("encoder."):
                k = f"encoder.{k}"
            out[k] = np.asarray(v)
        return convs_to_wio(out, shapes, lambda k, v: k.endswith(
            "fsmn_block.conv_left.weight") and np.ndim(v) == 3)

    @staticmethod
    def post_load_hook(model: "Model", model_path: Path) -> "Model":
        """Pick up CMVN stats shipped beside the weights."""
        model_path = Path(model_path)
        cmvn_json = model_path / "cmvn.json"
        cmvn_mvn = model_path / "am.mvn"
        if cmvn_json.exists():
            d = json.loads(cmvn_json.read_text())
            model._cmvn = (np.asarray(d["shift"], np.float32),
                           np.asarray(d["scale"], np.float32))
        elif cmvn_mvn.exists():
            model._cmvn = load_cmvn(cmvn_mvn)
        return model


__all__ = ["FSMNEncoderConfig", "ModelConfig", "Model", "Encoder",
           "extract_features", "apply_lfr", "load_cmvn", "compute_decibel"]
