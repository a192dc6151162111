"""Silero VAD: dual-rate (16 kHz / 8 kHz) voice-activity detector.

Counterpart of mlx_audio_tpu/vad/models/silero_vad/silero_vad.py: the
branch net (`_branch_step` :95-126: reflect pad, the STFT conv and its
magnitude, four encoder convs, an LSTM cell carried across chunks, the
final conv and its mean), the streaming `feed` (:187) with its state,
`predict_proba` (:220), `get_speech_timestamps` (:250) and `generate`
(:271) with the hysteresis timestamp logic.

Where the JAX package runs the offline path as one `lax.scan` over the
chunks, here the convolutions, which do not depend on the carried state,
run once over every chunk's window as one batch; then the LSTM cell steps
through the chunks in a Python loop of device launches, and the final
conv runs once more over all of them. The probabilities are read once,
after the loop. `feed` runs the same pieces on one window. The state is
plain tensors on the model's device, so a caller may feed from any
thread.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device
from ....nn import Conv1d, LSTMCell

HIDDEN = 128


@dataclass
class BranchConfig(BaseModelArgs):
    sample_rate: int = 16000
    filter_length: int = 256
    hop_length: int = 128
    pad: int = 64
    cutoff: int = 129
    context_size: int = 64
    chunk_size: int = 512


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "silero_vad"
    architecture: str = "silero_vad"
    dtype: str = "float32"
    threshold: float = 0.5
    min_speech_duration_ms: int = 250
    min_silence_duration_ms: int = 100
    speech_pad_ms: int = 30
    branch_16k: Optional[BranchConfig] = None
    branch_8k: Optional[BranchConfig] = None
    model_path: str = ""

    def __post_init__(self):
        if isinstance(self.branch_16k, dict):
            self.branch_16k = BranchConfig.from_dict(self.branch_16k)
        if self.branch_16k is None:
            self.branch_16k = BranchConfig()
        if isinstance(self.branch_8k, dict):
            self.branch_8k = BranchConfig.from_dict(self.branch_8k)
        if self.branch_8k is None:
            self.branch_8k = BranchConfig(
                sample_rate=8000, filter_length=128, hop_length=64, pad=32,
                cutoff=65, context_size=32, chunk_size=256)


@dataclass
class SileroVADState:
    state: Optional[Tuple[torch.Tensor, torch.Tensor]]  # (h, c), (B, 128)
    context: torch.Tensor                               # (B, context_size)
    sample_rate: int


@dataclass
class VADOutput:
    timestamps: List[dict]
    probabilities: np.ndarray
    sample_rate: int


class Branch(nn.Module):
    """One sample rate's network (the JAX package's `init_branch` tree)."""

    def __init__(self, cfg: BranchConfig):
        super().__init__()
        self.cfg = cfg
        self.stft_conv = Conv1d(1, cfg.cutoff * 2, cfg.filter_length,
                                bias=False)
        self.conv1 = Conv1d(cfg.cutoff, 128, 3)
        self.conv2 = Conv1d(128, 64, 3)
        self.conv3 = Conv1d(64, 64, 3)
        self.conv4 = Conv1d(64, 128, 3)
        self.lstm = LSTMCell(128, HIDDEN)
        self.final_conv = Conv1d(128, 1, 1)

    def encode(self, windows: torch.Tensor) -> torch.Tensor:
        """Windows (N, context + chunk) -> LSTM inputs (N, T', 128)."""
        cfg = self.cfg
        tail = windows[:, -cfg.pad - 1:-1].flip(-1)   # reflect-pad right
        x = torch.cat([windows, tail], dim=-1)[..., None]
        x = self.stft_conv(x, stride=cfg.hop_length)
        real, imag = x[..., :cfg.cutoff], x[..., cfg.cutoff:]
        x = torch.sqrt(real * real + imag * imag)
        x = F.relu(self.conv1(x, padding=1))
        x = F.relu(self.conv2(x, stride=2, padding=1))
        x = F.relu(self.conv3(x, stride=2, padding=1))
        return F.relu(self.conv4(x, padding=1))

    def recur(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """The cell over the frames of x (B, T', 128) from (h, c) ->
        (hidden states (B, T', 128), h, c)."""
        hs = []
        for t in range(x.shape[1]):
            h, c = self.lstm(x[:, t], (h, c))
            hs.append(h)
        return torch.stack(hs, dim=1), h, c

    def head(self, hs: torch.Tensor) -> torch.Tensor:
        """Hidden states (N, T', 128) -> speech probability (N,)."""
        y = torch.sigmoid(self.final_conv(F.relu(hs)))
        return y[..., 0].mean(-1)


class Model(TorchModel):
    """Silero VAD (the engine behind the server's turn detection) on
    `device`: the card by default; without CUDA the constructor raises
    unless given `device="cpu"`."""

    def __init__(self, config: ModelConfig, device="cuda"):
        device = check_device(device)
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        with torch.device(device):
            self.branch_16k = Branch(config.branch_16k)
            self.branch_8k = Branch(config.branch_8k)
        self.requires_grad_(False)
        self.eval()

    def sanitize(self, weights):
        """Map checkpoint conv / LSTM names and layouts onto the JAX tree's
        (conv WIO, LSTM without the `_l0` suffix); `load_jax_params` takes
        it from there. A conv weight's layout, torch (O, I, W) or mlx
        (O, W, I), is told by this model's own shape for it: the JAX
        package's `sanitize` guesses it from I <= W, which misreads the
        encoder convs of either layout (their I exceeds W)."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for k, w in weights.items():
            w = np.asarray(w)
            if k.endswith(".weight") and w.ndim == 3:
                o, i, width = shapes.get(k, (None,) * 3)
                if w.shape == (o, i, width):        # torch (O, I, W)
                    out[k] = np.transpose(w, (2, 1, 0))
                elif w.shape == (o, width, i):      # mlx (O, W, I)
                    out[k] = np.transpose(w, (1, 2, 0))
                else:
                    raise ValueError(f"{k}: shape {w.shape} is neither "
                                     f"{(o, i, width)} nor {(o, width, i)}")
            elif "lstm" in k and (".weight_ih" in k or ".weight_hh" in k
                                  or ".bias_ih" in k or ".bias_hh" in k):
                out[k.replace("_l0", "")] = w
            elif k.endswith(("Wx", "Wh")):
                out[k.replace(".Wx", ".weight_ih")
                    .replace(".Wh", ".weight_hh")] = w
            else:
                out[k] = w
        return out

    def _branch(self, sample_rate: int) -> Branch:
        if sample_rate == 16000:
            return self.branch_16k
        if sample_rate == 8000:
            return self.branch_8k
        raise ValueError(f"Unsupported sample rate: {sample_rate}")

    # -- streaming ---------------------------------------------------------

    def initial_state(self, batch_size: int = 1,
                      sample_rate: int = 16000) -> SileroVADState:
        cfg = self._branch(sample_rate).cfg
        return SileroVADState(
            state=None,
            context=torch.zeros(batch_size, cfg.context_size,
                                device=self.device),
            sample_rate=sample_rate)

    reset_state = initial_state

    @torch.inference_mode()
    def feed(self, chunk, state: Optional[SileroVADState] = None,
             sample_rate: int = 16000) -> Tuple[torch.Tensor, SileroVADState]:
        """One streaming chunk (B?, chunk_size) -> (probability (B, 1) on
        the device, new state). Nothing is read to the host."""
        branch = self._branch(sample_rate)
        cfg = branch.cfg
        chunk = torch.as_tensor(np.asarray(chunk, np.float32)
                                if not isinstance(chunk, torch.Tensor)
                                else chunk, dtype=torch.float32,
                                device=self.device)
        if chunk.ndim == 1:
            chunk = chunk[None, :]
        if chunk.shape[-1] != cfg.chunk_size:
            raise ValueError(
                f"Expected {cfg.chunk_size} samples at {sample_rate} Hz, got "
                f"{chunk.shape[-1]}")
        if state is None:
            state = self.initial_state(chunk.shape[0], sample_rate)
        if state.sample_rate != sample_rate:
            raise ValueError(
                f"Streaming state is for {state.sample_rate} Hz, got "
                f"{sample_rate} Hz")
        b = chunk.shape[0]
        h, c = state.state if state.state is not None else (
            torch.zeros(b, HIDDEN, device=self.device),
            torch.zeros(b, HIDDEN, device=self.device))
        window = torch.cat([state.context, chunk], dim=-1)
        hs, h, c = branch.recur(branch.encode(window), h, c)
        prob = branch.head(hs)
        new_state = SileroVADState(
            state=(h, c), context=chunk[:, -cfg.context_size:],
            sample_rate=sample_rate)
        return prob[:, None], new_state

    # -- offline -----------------------------------------------------------

    @torch.inference_mode()
    def predict_proba(self, audio, sample_rate: Optional[int] = None
                      ) -> np.ndarray:
        """Per-chunk speech probabilities (n_chunks,) of a mono waveform:
        the convolutions over every chunk's window at once, the cell
        through the chunks on the device, one read at the end."""
        audio, sr = self._prepare(audio, sample_rate)
        branch = self._branch(sr)
        cfg = branch.cfg
        n = len(audio)
        n_chunks = max(1, -(-n // cfg.chunk_size))
        padded = np.zeros(cfg.context_size + n_chunks * cfg.chunk_size,
                          np.float32)
        padded[cfg.context_size:cfg.context_size + n] = audio
        # window i: the context_size samples before chunk i (zeros before
        # the first), then chunk i
        windows = torch.from_numpy(padded).to(self.device).unfold(
            0, cfg.context_size + cfg.chunk_size, cfg.chunk_size)
        x = branch.encode(windows)                        # (N, T', 128)
        h = torch.zeros(1, HIDDEN, device=self.device)
        c = torch.zeros(1, HIDDEN, device=self.device)
        hs = []
        for i in range(n_chunks):
            hi, h, c = branch.recur(x[i:i + 1], h, c)
            hs.append(hi)
        return branch.head(torch.cat(hs)).cpu().numpy()

    predict = predict_proba

    def get_speech_timestamps(
        self,
        audio,
        sample_rate: Optional[int] = None,
        threshold: Optional[float] = None,
        min_speech_duration_ms: Optional[int] = None,
        min_silence_duration_ms: Optional[int] = None,
        speech_pad_ms: Optional[int] = None,
        return_seconds: bool = False,
    ) -> List[dict]:
        audio_arr, sr = self._prepare(audio, sample_rate)
        probs = self.predict_proba(audio_arr, sr)
        return _probs_to_timestamps(
            probs, len(audio_arr), sr,
            threshold if threshold is not None else self.config.threshold,
            min_speech_duration_ms or self.config.min_speech_duration_ms,
            min_silence_duration_ms or self.config.min_silence_duration_ms,
            speech_pad_ms or self.config.speech_pad_ms,
            return_seconds,
        )

    def generate(self, audio, sample_rate: Optional[int] = None,
                 **kwargs) -> VADOutput:
        audio_arr, sr = self._prepare(audio, sample_rate)
        probs = self.predict_proba(audio_arr, sr)
        stamps = _probs_to_timestamps(
            probs, len(audio_arr), sr,
            kwargs.get("threshold", self.config.threshold),
            kwargs.get("min_speech_duration_ms",
                       self.config.min_speech_duration_ms),
            kwargs.get("min_silence_duration_ms",
                       self.config.min_silence_duration_ms),
            kwargs.get("speech_pad_ms", self.config.speech_pad_ms),
            kwargs.get("return_seconds", True),
        )
        return VADOutput(timestamps=stamps, probabilities=probs,
                         sample_rate=sr)

    def _prepare(self, audio, sample_rate):
        if isinstance(audio, str) or hasattr(audio, "__fspath__"):
            from ....utils import load_audio

            sr = sample_rate or 16000
            return load_audio(audio, sample_rate=sr), sr
        return np.asarray(audio, np.float32), sample_rate or 16000


def _probs_to_timestamps(probs, audio_len, sample_rate, threshold,
                         min_speech_ms, min_silence_ms, speech_pad_ms,
                         return_seconds) -> List[dict]:
    """Hysteresis speech-segment extraction (the JAX package's, host
    numpy)."""
    probs = np.asarray(probs).reshape(-1)
    chunk_size = 512 if sample_rate == 16000 else 256
    min_speech = sample_rate * min_speech_ms / 1000
    min_silence = sample_rate * min_silence_ms / 1000
    pad = int(sample_rate * speech_pad_ms / 1000)
    neg_threshold = max(threshold - 0.15, 0.01)

    speeches = []
    triggered = False
    cur_start = 0
    temp_end = 0
    for idx, prob in enumerate(probs.tolist()):
        at = idx * chunk_size
        if prob >= threshold and not triggered:
            triggered, cur_start, temp_end = True, at, 0
            continue
        if triggered and prob >= threshold:
            temp_end = 0
            continue
        if triggered and prob < neg_threshold:
            if temp_end == 0:
                temp_end = at
            if at - temp_end >= min_silence:
                if temp_end - cur_start >= min_speech:
                    speeches.append({"start": cur_start, "end": temp_end})
                triggered, temp_end = False, 0
    if triggered:
        end = min(audio_len, len(probs) * chunk_size)
        if end - cur_start >= min_speech:
            speeches.append({"start": cur_start, "end": end})

    padded = []
    for sp in speeches:
        start = max(0, sp["start"] - pad)
        end = min(audio_len, sp["end"] + pad)
        if padded and start <= padded[-1]["end"]:
            padded[-1]["end"] = max(padded[-1]["end"], end)
        else:
            padded.append({"start": start, "end": end})
    if return_seconds:
        return [{"start": round(s["start"] / sample_rate, 3),
                 "end": round(s["end"] / sample_rate, 3)} for s in padded]
    return padded
