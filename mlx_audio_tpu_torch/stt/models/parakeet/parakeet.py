"""Parakeet STT: a FastConformer encoder with TDT, RNN-T or CTC decoding.

Counterpart of mlx_audio_tpu/stt/models/parakeet/parakeet.py:

* `log_mel` (:36-46): the NeMo-style front end, a 512-sample periodic Hann
  window and hop 160, ln(mel + 1e-6), normalized per mel bin over the
  window's frames (ddof 0, std + 1e-5), through the port's
  `dsp.log_mel_spectrogram` on the model's device;
* `PredictArgs`, `JointArgs` and `ModelConfig` (:49-126), with `from_dict`
  for the HF `parakeet_ctc` schema (:78-111);
* the parameter tree of `init_params` (:134-164) as `nn.Module`s named
  after its leaves (`encoder`, the shared `conformer.Conformer`;
  `decoder.{embed, lstm.N}`, `joint.{enc_proj, pred_proj, out}`;
  `ctc_decoder.conv`), so `model.load_jax_params` fills it;
* the prediction network (:262-280), a single-step stacked LSTM with gates
  in i, f, g, o order, and the joint (:282-286);
* `decode_tdt` for TDT and RNN-T (:288-329) through the greedy loop of
  `transducer.py` (state on the device, one read a chunk of joint steps,
  `enc_proj` hoisted over the window), and `decode_ctc` (:331-343): the
  argmax on the device, one read, the collapse on the host;
* `_detokenize`, `_decode_window`, `transcribe_chunked` (windows stepping
  by chunk - overlap, merged by the port's `nemo` alignment) and
  `generate` (:345-455);
* `sanitize` for HF `ParakeetForCTC` / `ParakeetEncoder` names (:166-245),
  to the JAX tree's names and layouts, as numpy. Its permutation of the
  subsampling linear's columns is the port conformer's flatten, (F', C)
  with C fastest.

Departures: `decoding="tdt_ctc"` (or any mode but tdt, rnnt and ctc)
raises a ValueError when the config is built; JAX builds only the CTC head
for it and then decodes by TDT, which fails with KeyError 'decoder'. A
bf16 model computes in bf16, with f32 softmax and batch-norm statistics.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....dsp import log_mel_spectrogram
from ....model import TorchModel, check_device, holder
from ....nn import Conv1d, Embedding, Linear, LSTMCell, linear
from ....utils import load_audio
from ..base import STTOutput
from .conformer import Conformer, ConformerArgs, conformer_forward
from .transducer import greedy_transducer, initial_state, lstm_step

SAMPLE_RATE = 16000
HOP = 160
DECODINGS = ("tdt", "rnnt", "ctc")
# tokens the TDT / RNN-T loop may emit on one frame before it must advance
MAX_SYMBOLS_PER_FRAME = 8


def log_mel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """NeMo-style preprocessor: (..., samples) -> (..., frames, n_mels), a
    25-ms hop-10-ms natural-log mel normalized per mel bin over the
    frames."""
    mel = log_mel_spectrogram(audio, n_fft=512, hop_length=HOP,
                              n_mels=n_mels, sample_rate=SAMPLE_RATE,
                              log_base="ln", log_floor_mode="add")
    mean = mel.mean(dim=-2, keepdim=True)
    std = mel.std(dim=-2, keepdim=True, unbiased=False) + 1e-5
    return (mel - mean) / std


@dataclass
class PredictArgs:
    pred_hidden: int = 640
    pred_rnn_layers: int = 2
    vocab_size: int = 1024


@dataclass
class JointArgs:
    joint_hidden: int = 640
    encoder_hidden: int = 512
    pred_hidden: int = 640
    num_classes: int = 1030  # vocab + blank (+ durations for TDT)
    num_extra_outputs: int = 0  # TDT duration heads


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "parakeet"
    decoding: str = "tdt"  # tdt | rnnt | ctc
    encoder: dict = field(default_factory=dict)
    prediction: dict = field(default_factory=dict)
    joint: dict = field(default_factory=dict)
    vocab_size: int = 1024
    durations: List[int] = field(default_factory=lambda: [0, 1, 2, 3, 4])
    vocabulary: Optional[List[str]] = None
    model_path: str = ""

    @classmethod
    def from_dict(cls, config: dict):
        """Accept the HF transformers ParakeetCTC schema (model_type
        "parakeet_ctc": a nested encoder_config with hidden_size /
        num_mel_bins names) alongside the native NeMo-style schema."""
        if isinstance(config, dict) and isinstance(
                config.get("encoder_config"), dict) and \
                "hidden_size" in config["encoder_config"]:
            e = config["encoder_config"]
            d_model = e.get("hidden_size", 1024)
            d_ff = e.get("intermediate_size", 4 * d_model)
            if d_ff % d_model:
                raise ValueError(
                    "parakeet: intermediate_size must be a multiple of "
                    f"hidden_size (got {d_ff} / {d_model})")
            # HF vocab_size includes the CTC blank (HF ParakeetCTCConfig:
            # vocab_size=1025 = 1024 tokens + blank)
            vocab = config.get("vocab_size", 1025) - 1
            return cls(
                model_type="parakeet",
                decoding="ctc",
                encoder=dict(
                    feat_in=e.get("num_mel_bins", 80),
                    n_layers=e.get("num_hidden_layers", 24),
                    d_model=d_model,
                    n_heads=e.get("num_attention_heads", 8),
                    ff_expansion_factor=d_ff // d_model,
                    subsampling_factor=e.get("subsampling_factor", 8),
                    conv_kernel_size=e.get("conv_kernel_size", 9),
                    subsampling_conv_channels=e.get(
                        "subsampling_conv_channels", 256),
                    use_bias=e.get("attention_bias", True),
                    xscaling=e.get("scale_input", True)),
                vocab_size=vocab)
        return super().from_dict(config)

    def __post_init__(self):
        if self.decoding not in DECODINGS:
            raise ValueError(
                f"parakeet: decoding {self.decoding!r} is not supported "
                f"(supported: {', '.join(DECODINGS)}); the JAX package "
                f"builds only the CTC head for 'tdt_ctc' and then fails "
                f"decoding it by TDT")
        enc = {k: v for k, v in (self.encoder or {}).items()
               if k in ConformerArgs.__dataclass_fields__}
        self.encoder_args = ConformerArgs(**enc)
        pred = {k: v for k, v in (self.prediction or {}).items()
                if k in PredictArgs.__dataclass_fields__}
        self.pred_args = PredictArgs(**{**pred,
                                        "vocab_size": self.vocab_size})
        joint = {k: v for k, v in (self.joint or {}).items()
                 if k in JointArgs.__dataclass_fields__}
        self.joint_args = JointArgs(**{
            "encoder_hidden": self.encoder_args.d_model,
            "pred_hidden": self.pred_args.pred_hidden, **joint})


class Model(TorchModel):
    """Parakeet on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`."""

    def __init__(self, config: Union[ModelConfig, dict], device="cuda"):
        device = check_device(device)
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        self.enc_args = config.encoder_args
        with torch.device(device):
            self.encoder = Conformer(self.enc_args)
            if config.decoding in ("tdt", "rnnt"):
                pa, ja = config.pred_args, config.joint_args
                self.decoder = holder(
                    embed=Embedding(pa.vocab_size + 1, pa.pred_hidden),
                    lstm=nn.ModuleList(
                        LSTMCell(pa.pred_hidden, pa.pred_hidden)
                        for _ in range(pa.pred_rnn_layers)))
                self.joint = holder(
                    enc_proj=Linear(ja.encoder_hidden, ja.joint_hidden),
                    pred_proj=Linear(ja.pred_hidden, ja.joint_hidden),
                    out=Linear(ja.joint_hidden, ja.num_classes))
            else:
                self.ctc_decoder = holder(conv=Conv1d(
                    self.enc_args.d_model, config.vocab_size + 1, 1))
        self.requires_grad_(False)
        self.eval()
        self.last_run: dict = {}

    @property
    def sample_rate(self) -> int:
        return SAMPLE_RATE

    @property
    def dtype(self) -> torch.dtype:
        """The floating dtype of the parameters: the compute dtype."""
        return self.encoder.pre_encode.out.weight.dtype

    # -- loading -------------------------------------------------------------

    def sanitize(self, weights: dict) -> dict:
        """HF transformers ParakeetForCTC / ParakeetEncoder checkpoints
        (nvidia/parakeet-ctc-* HF layout) -> the JAX tree's names and
        layouts, as numpy; native-layout trees pass through unchanged."""
        if not any(".subsampling." in k or "ctc_head." in k
                   for k in weights):
            return weights
        a = self.enc_args
        # the feature axis after the strided conv stack (k=3, p=1)
        f_out = a.feat_in
        for _ in range(int(np.log2(a.subsampling_factor))):
            f_out = (f_out - 1) // 2 + 1
        ch = a.subsampling_conv_channels

        def conv2d_w(w):                 # torch OIHW -> HWIO
            return np.transpose(np.asarray(w), (2, 3, 1, 0))

        def conv1d_w(w):                 # torch (O, I, K) -> (K, I, O)
            return np.transpose(np.asarray(w), (2, 1, 0))

        attn_names = {"q_proj": "linear_q", "k_proj": "linear_k",
                      "v_proj": "linear_v", "o_proj": "linear_out",
                      "relative_k_proj": "linear_pos",
                      "bias_u": "pos_bias_u", "bias_v": "pos_bias_v"}
        out = {}
        for k, w in weights.items():
            w = np.asarray(w)
            if k.startswith("model."):
                k = k[len("model."):]
            if not k.startswith(("encoder.", "ctc_head.")):
                k = "encoder." + k       # bare ParakeetEncoder layout
            if k.endswith("num_batches_tracked"):
                continue
            if k.startswith("ctc_head."):
                nk = k.replace("ctc_head.", "ctc_decoder.conv.")
                out[nk] = conv1d_w(w) if k.endswith("weight") else w
                continue
            if ".subsampling.linear." in k:
                nk = "encoder.pre_encode.out." + k.rsplit(".", 1)[1]
                if k.endswith("weight"):
                    # HF flattens (B, C, T, F) -> (B, T, C*F); the port's
                    # conformer flattens (F', C), C fastest
                    w = w.reshape(-1, ch, f_out)
                    w = np.transpose(w, (0, 2, 1)).reshape(w.shape[0], -1)
                out[nk] = w
                continue
            m = re.match(r"encoder\.subsampling\.layers\.(\d+)\.(\w+)", k)
            if m:
                i, leaf = int(m.group(1)), m.group(2)
                if i == 0:
                    name = "00_conv"
                elif i % 3 == 2:         # depthwise of stage (i+1)/3
                    name = f"{2 * ((i + 1) // 3) - 1:02d}_dw"
                else:                    # pointwise of stage i/3
                    name = f"{2 * (i // 3):02d}_pw"
                out[f"encoder.pre_encode.layers.{name}.{leaf}"] = \
                    conv2d_w(w) if leaf == "weight" else w
                continue
            if ".self_attn." in k:
                head, _, tail = k.rpartition(".self_attn.")
                for hf, ours in attn_names.items():
                    if tail.startswith(hf):
                        tail = tail.replace(hf, ours, 1)
                        break
                out[f"{head}.self_attn.{tail}"] = w
                continue
            if ".conv.norm." in k:
                out[k.replace(".conv.norm.", ".conv.batch_norm.")] = w
                continue
            if ".conv." in k and k.endswith("weight") and \
                    ("pointwise_conv" in k or "depthwise_conv" in k):
                out[k] = conv1d_w(w)
                continue
            out[k] = w
        return out

    # -- encoder -------------------------------------------------------------

    @torch.inference_mode()
    def encode(self, audio) -> torch.Tensor:
        """Samples (T,) or (1, T) -> the encoder output (1, T', d)."""
        audio = torch.as_tensor(np.asarray(audio, np.float32),
                                device=self.device)
        if audio.ndim == 1:
            audio = audio[None]
        mel = log_mel(audio, self.enc_args.feat_in)
        return conformer_forward(self.encoder, self.enc_args,
                                 mel.to(self.dtype))

    # -- decoders ------------------------------------------------------------

    def _predict(self, token: torch.Tensor, h, c):
        """One prediction-network step: token (1,) -> (its output through
        the joint's pred_proj (1, J), h, c)."""
        x = self.decoder.embed(token)
        out, h, c = lstm_step(self.decoder.lstm, x, h, c)
        return self.joint.pred_proj(out), h, c

    def _joint(self, enc_t: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """The joint over `enc_t` already through `enc_proj` and `pred`
        already through `pred_proj`."""
        return self.joint.out(F.relu(enc_t + pred))

    @torch.inference_mode()
    def decode_tdt(self, enc: torch.Tensor,
                   max_symbols_per_frame: int = MAX_SYMBOLS_PER_FRAME):
        """Greedy token-and-duration (or RNN-T) transducer decode of enc
        (1, T', d) -> (tokens, frames); `last_run` holds the joint steps,
        chunks and reads."""
        c = self.config
        assert enc.shape[0] == 1
        pa = c.pred_args
        state = initial_state(self._predict, c.vocab_size,
                              pa.pred_rnn_layers, pa.pred_hidden,
                              enc.dtype, enc.device)
        tokens, frames, _, run = greedy_transducer(
            self._predict, self._joint, self.joint.enc_proj(enc[0]),
            enc.shape[1], state, c.vocab_size, max_symbols_per_frame,
            c.durations if c.decoding == "tdt" else None)
        self.last_run = run
        return tokens, frames

    @torch.inference_mode()
    def decode_ctc(self, enc: torch.Tensor):
        """Greedy CTC: argmax -> collapse repeats -> drop blanks."""
        conv = self.ctc_decoder.conv
        ids = linear(enc, conv.weight[:, :, 0], conv.bias).argmax(-1)[0]
        ids = ids.cpu().numpy()
        self.last_run = {"reads": 1}
        blank = self.config.vocab_size
        tokens, frames = [], []
        prev = -1
        for t, i in enumerate(ids):
            if i != blank and i != prev:
                tokens.append(int(i))
                frames.append(t)
            prev = int(i)
        return tokens, frames

    def _detokenize(self, tokens: List[int]) -> str:
        vocab = self.config.vocabulary
        if vocab:
            return "".join(vocab[t] for t in tokens
                           if 0 <= t < len(vocab)).replace("▁", " ").strip()
        return " ".join(str(t) for t in tokens)

    # -- public --------------------------------------------------------------

    def _seconds_per_frame(self) -> float:
        return HOP * self.enc_args.subsampling_factor / SAMPLE_RATE

    def _decode(self, audio: np.ndarray):
        enc = self.encode(audio)
        if self.config.decoding == "ctc":
            return self.decode_ctc(enc)
        return self.decode_tdt(enc)

    def _decode_window(self, audio: np.ndarray, t_offset: float):
        """Decode one audio window -> list[AlignedToken] at absolute
        time."""
        from ..nemo import AlignedToken

        tokens, frames = self._decode(audio)
        spf = self._seconds_per_frame()
        vocab = self.config.vocabulary
        out = []
        for tok, f in zip(tokens, frames):
            text = (vocab[tok].replace("▁", " ")
                    if vocab and 0 <= tok < len(vocab) else str(tok))
            out.append(AlignedToken(
                id=tok, text=text, start=t_offset + f * spf, duration=spf))
        return out

    def transcribe_chunked(self, audio: np.ndarray,
                           chunk_duration: float = 120.0,
                           overlap_duration: float = 15.0,
                           chunk_callback=None):
        """Long audio: overlapping windows merged by token alignment ->
        an `AlignedResult`. `last_run` sums the windows' joint steps,
        chunks and reads, and counts the windows."""
        from ..nemo import (merge_longest_common_subsequence,
                            merge_longest_contiguous, sentences_to_result,
                            tokens_to_sentences)

        chunk = int(chunk_duration * SAMPLE_RATE)
        overlap = int(overlap_duration * SAMPLE_RATE)
        if overlap >= chunk:
            raise ValueError("overlap_duration must be < chunk_duration")
        merged = []
        total = {"windows": 0}
        for start in range(0, max(len(audio), 1), chunk - overlap):
            end = min(start + chunk, len(audio))
            piece = self._decode_window(audio[start:end], start / SAMPLE_RATE)
            total["windows"] += 1
            for k, v in self.last_run.items():
                total[k] = total.get(k, 0) + v
            if chunk_callback is not None:
                chunk_callback(end, len(audio))
            if not merged:
                merged = piece
            else:
                try:
                    merged = merge_longest_contiguous(
                        merged, piece, overlap_duration=overlap_duration)
                except RuntimeError:
                    merged = merge_longest_common_subsequence(
                        merged, piece, overlap_duration=overlap_duration)
            if end >= len(audio):
                break
        self.last_run = total
        return sentences_to_result(tokens_to_sentences(merged))

    def generate(self, audio, chunk_duration=None, overlap_duration=15.0,
                 chunk_callback=None, **kwargs) -> STTOutput:
        """Transcribe `audio` (a path, or 16-kHz samples). With
        `chunk_duration` shorter than the audio, in overlapping windows
        (`transcribe_chunked`); segments are sentences then, tokens
        otherwise."""
        t0 = time.time()
        if isinstance(audio, (str, Path)):
            audio = load_audio(str(audio), sample_rate=SAMPLE_RATE)
        audio = np.asarray(audio)
        long_audio = (chunk_duration is not None
                      and len(audio) > chunk_duration * SAMPLE_RATE)
        if long_audio:
            result = self.transcribe_chunked(
                audio, chunk_duration=chunk_duration,
                overlap_duration=overlap_duration,
                chunk_callback=chunk_callback)
            segments = [{"start": round(s.start, 2), "end": round(s.end, 2),
                         "text": s.text.strip()} for s in result.sentences]
            n_tokens = sum(len(s.tokens) for s in result.sentences)
            wall = time.time() - t0
            return STTOutput(
                text=result.text, segments=segments, language="en",
                generation_tokens=n_tokens, total_time=wall,
                generation_tps=n_tokens / wall if wall else 0.0)
        tokens, frames = self._decode(audio)
        self.last_run["windows"] = 1
        spf = self._seconds_per_frame()
        segments = [{"start": round(f * spf, 2),
                     "end": round((f + 1) * spf, 2),
                     "text": self._detokenize([t])}
                    for t, f in zip(tokens, frames)]
        wall = time.time() - t0
        return STTOutput(
            text=self._detokenize(tokens), segments=segments,
            language="en", generation_tokens=len(tokens),
            total_time=wall,
            generation_tps=len(tokens) / wall if wall else 0.0)


__all__ = ["Model", "ModelConfig", "PredictArgs", "JointArgs", "log_mel",
           "SAMPLE_RATE", "HOP"]
