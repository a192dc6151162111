"""Nemotron ASR: a cache-aware streaming FastConformer-RNNT with language
prompts.

Counterpart of mlx_audio_tpu/stt/models/nemotron_asr/nemotron_asr.py:

* the configs (:57-147), `is_lang_tag`, `decode_pieces` and
  `detected_language` (:150-179), copied;
* `nemo_log_mel` (:182-199): pre-emphasis, numpy's symmetric Hann window of
  win_length centred in n_fft, a constant-padded centred STFT (the port's
  `dsp.stft`, `spec_abs`), slaney filters, log(x + 2^-24), no
  normalization; on the model's device;
* the parameter tree of `init_nemotron` (:202-301) as `nn.Module`s named
  after its leaves, so `model.load_jax_params` fills it;
* the encoder (`encode`, :320-389): the causal dw-striding subsampling (each
  3x3 stride-2 conv padded 2 + 1 on both axes; which conv is strided, which
  depthwise and which 1x1 is this module's own structure), the flatten of
  (C, F) with F fastest, `subsampled_length`'s own formula (:313-318), the
  chunked-limited attention mask (:304-310), blocks with a layer-norm conv
  module and a causal depthwise conv (the port conformer's `FeedForward`
  and `rel_pos_attention`), and the language one-hot through the
  `prompt_kernel` MLP;
* the greedy RNN-T (:412-465) through the loop of `parakeet/transducer.py`:
  blank-as-pad (the blank's embedding is zero), the decoder state kept
  across a blank, `max_symbols` a frame; the state on the device, one read
  a chunk of joint steps;
* `generate` and `stream_generate` with the decoder state carried across
  30-s chunks (:507-616), `_sentences` and `sanitize` (:618-672).

A padded frame's attention row may have no key under the chunked-limited
mask (every key of its chunk and the chunks it sees is padding), and its
softmax is then NaN, as JAX's is: the attention output is zeroed there
with `torch.where` (NaN * 0 stays NaN), and every padded frame is zeroed
again after each block, as JAX does. Valid frames never read a padded key.
A bf16 model computes in bf16, with f32 softmax and a mel in f32.

Departure: `generate` and `stream_generate` count a chunk's encoder frames
with the config's own number of subsampling stages. JAX's call
`subsampled_length(n)` (:536, :603) takes its default of three stages, so
at a subsampling factor other than 8 (tests/test_nemotron_asr.py's 4) it
decodes only the first subsampled_length(n, 3) frames of each chunk. At
the published factor of 8 the two agree.
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....dsp import mel_filters, spec_abs, stft
from ....model import TorchModel, check_device, holder
from ....nn import Conv1d, Conv2d, Embedding, LayerNorm, Linear, LSTMCell
from ....utils import load_audio
from ..base import STTOutput
from ..parakeet.conformer import ConformerArgs as _PkArgs
from ..parakeet.conformer import (FeedForward, RelPositionAttention,
                                  _pointwise, _pos_table, rel_pos_attention)
from ..parakeet.transducer import greedy_transducer, initial_state, lstm_step

MEL_BUCKETS = (256, 512, 1024, 2048, 3072)

_LANG_TAG_RE = re.compile(r"^<[a-z]{2,3}-[A-Za-z]{2,4}>$")
_OTHER_SPECIAL = {"<unk>", "<pad>", "<s>", "</s>"}


# --------------------------------------------------------------- configs

@dataclass
class PreprocessArgs(BaseModelArgs):
    sample_rate: int = 16000
    features: int = 128
    n_fft: int = 512
    window_size: float = 0.025
    window_stride: float = 0.01
    window: str = "hann"
    preemph: float = 0.97
    normalize: str = "NA"
    log_zero_guard_value: float = 2.0 ** -24

    @property
    def win_length(self) -> int:
        return int(self.window_size * self.sample_rate)

    @property
    def hop_length(self) -> int:
        return int(self.window_stride * self.sample_rate)


@dataclass
class ConformerArgs(BaseModelArgs):
    feat_in: int = 128
    n_layers: int = 24
    d_model: int = 1024
    n_heads: int = 8
    ff_expansion_factor: int = 4
    subsampling_factor: int = 8
    subsampling_conv_channels: int = 256
    conv_kernel_size: int = 9
    causal_downsampling: bool = True
    conv_context_size: object = "causal"
    conv_norm_type: str = "layer_norm"
    att_context_style: str = "chunked_limited"
    att_context_size: List[List[int]] = field(
        default_factory=lambda: [[56, 13]])
    pos_emb_max_len: int = 5000
    use_bias: bool = False
    xscaling: bool = False


@dataclass
class PromptArgs(BaseModelArgs):
    num_prompts: int = 128
    prompt_hidden: int = 2048
    prompt_dictionary: Dict[str, int] = field(default_factory=dict)


@dataclass
class PredictArgs(BaseModelArgs):
    pred_hidden: int = 640
    pred_rnn_layers: int = 2
    vocab_size: int = 13087
    blank_as_pad: bool = True


@dataclass
class JointArgs(BaseModelArgs):
    joint_hidden: int = 640
    activation: str = "relu"
    encoder_hidden: int = 1024
    pred_hidden: int = 640
    num_classes: int = 13087


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "nemotron_asr"
    preprocessor: Optional[Dict] = None
    encoder: Optional[Dict] = None
    prompt: Optional[Dict] = None
    decoder: Optional[Dict] = None
    joint: Optional[Dict] = None
    vocabulary: List[str] = field(default_factory=list)
    default_language: str = "auto"
    default_att_context_size: List[int] = field(
        default_factory=lambda: [56, 13])
    max_symbols: int = 10
    model_path: str = ""

    def __post_init__(self):
        for name, cls in (("preprocessor", PreprocessArgs),
                          ("encoder", ConformerArgs),
                          ("prompt", PromptArgs),
                          ("decoder", PredictArgs),
                          ("joint", JointArgs)):
            v = getattr(self, name)
            if not isinstance(v, cls):
                setattr(self, name, cls.from_dict(v or {}))


# ------------------------------------------------------------- tokenizer

def is_lang_tag(piece: str) -> bool:
    return bool(_LANG_TAG_RE.match(piece))


def is_special_piece(piece: str) -> bool:
    return piece in _OTHER_SPECIAL or is_lang_tag(piece)


def decode_pieces(tokens: List[int], vocabulary: List[str],
                  strip_lang_tags: bool = True) -> str:
    parts = []
    for t in tokens:
        if t < 0 or t >= len(vocabulary):
            continue
        piece = vocabulary[t]
        if piece in _OTHER_SPECIAL or (strip_lang_tags
                                       and is_lang_tag(piece)):
            continue
        parts.append(piece.replace("▁", " "))
    return "".join(parts)


def detected_language(tokens: List[int],
                      vocabulary: List[str]) -> Optional[str]:
    for t in tokens:
        if 0 <= t < len(vocabulary) and is_lang_tag(vocabulary[t]):
            return vocabulary[t][1:-1]
    return None


# ------------------------------------------------------------------ mel

def nemo_log_mel(audio, pp: PreprocessArgs) -> torch.Tensor:
    """(T,) samples -> (frames, features) f32, on the samples' device (the
    CPU for numpy): NeMo's AudioToMelSpectrogramPreprocessor at inference
    (no dither, normalize NA)."""
    x = torch.as_tensor(audio, dtype=torch.float32)
    if pp.preemph:
        x = torch.cat([x[:1], x[1:] - pp.preemph * x[:-1]])
    win = np.hanning(pp.win_length).astype(np.float32)
    left = (pp.n_fft - pp.win_length) // 2
    win = np.pad(win, (left, pp.n_fft - pp.win_length - left))
    spec = stft(x, n_fft=pp.n_fft, hop_length=pp.hop_length,
                win_length=pp.n_fft, window=win, center=True,
                pad_mode="constant")
    power = spec_abs(spec) ** 2
    fb = mel_filters(pp.sample_rate, pp.n_fft, pp.features, norm="slaney",
                     mel_scale="slaney").to(x.device)
    return torch.log(power @ fb.T + pp.log_zero_guard_value)


# --------------------------------------------------------------- encoder

def chunked_limited_mask(t: int, left: int, right: int) -> np.ndarray:
    """Boolean (T, T) visibility for NeMo chunked_limited attention."""
    chunk = right + 1
    left_chunks = left // chunk if left >= 0 else 10 ** 8
    ci = np.arange(t) // chunk
    diff = ci[:, None] - ci[None, :]
    return (diff >= 0) & (diff <= left_chunks)


def subsampled_length(n: int, n_stages: int = 3) -> int:
    """Mel frames -> encoder frames: each causal stage (pad 2 + 1, k3 s2)
    keeps n // 2 + 1."""
    for _ in range(n_stages):
        n = n // 2 + 1
    return n


def _n_stages(a: ConformerArgs) -> int:
    return int(math.log2(a.subsampling_factor))


class Subsampling(nn.Module):
    """The causal dw-striding stack: `conv.0` a 3x3 stride-2 conv, then per
    further stage `conv.<i>` a depthwise 3x3 stride-2 conv and `conv.<i+1>`
    a pointwise conv (i = 2, 5, ...); `out` over the flattened (C, F)."""

    def __init__(self, a: ConformerArgs):
        super().__init__()
        ch = a.subsampling_conv_channels
        convs, self.kinds = {"0": Conv2d(1, ch, 3)}, [("0", "conv")]
        idx = 2
        for _ in range(_n_stages(a) - 1):
            convs[str(idx)] = Conv2d(ch, ch, 3, groups=ch)
            convs[str(idx + 1)] = Conv2d(ch, ch, 1)
            self.kinds += [(str(idx), "dw"), (str(idx + 1), "pw")]
            idx += 3
        self.conv = nn.ModuleDict(convs)
        freq = a.feat_in
        for _ in range(_n_stages(a)):
            freq = freq // 2 + 1
        self.out = Linear(ch * freq, a.d_model)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, T, F) -> (B, T', d_model)."""
        x = mel[:, None]                               # (B, 1, T, F)
        for key, kind in self.kinds:
            conv = self.conv[key]
            if kind == "pw":
                x = F.relu(conv(x))
                continue
            x = conv(F.pad(x, (2, 1, 2, 1)), stride=2)  # causal pad 2 + 1
            if kind == "conv":
                x = F.relu(x)
        b, c, t, f = x.shape
        return self.out(x.permute(0, 2, 1, 3).reshape(b, t, c * f))


class ConvModule(nn.Module):
    def __init__(self, a: ConformerArgs):
        super().__init__()
        d = a.d_model
        self.pointwise_conv1 = Conv1d(d, 2 * d, 1, bias=a.use_bias)
        self.depthwise_conv = Conv1d(d, d, a.conv_kernel_size,
                                     bias=a.use_bias, groups=d)
        self.batch_norm = LayerNorm(d)                  # NeMo's naming
        self.pointwise_conv2 = Conv1d(d, d, 1, bias=a.use_bias)


class Block(nn.Module):
    def __init__(self, a: ConformerArgs):
        super().__init__()
        d, ffd = a.d_model, a.d_model * a.ff_expansion_factor
        self.norm_feed_forward1 = LayerNorm(d)
        self.feed_forward1 = FeedForward(d, ffd, a.use_bias)
        self.norm_self_att = LayerNorm(d)
        self.self_attn = RelPositionAttention(d, a.n_heads, a.use_bias)
        self.norm_conv = LayerNorm(d)
        self.conv = ConvModule(a)
        self.norm_feed_forward2 = LayerNorm(d)
        self.feed_forward2 = FeedForward(d, ffd, a.use_bias)
        self.norm_out = LayerNorm(d)


class Encoder(nn.Module):
    def __init__(self, a: ConformerArgs):
        super().__init__()
        self.pre_encode = Subsampling(a)
        self.layers = nn.ModuleList(Block(a) for _ in range(a.n_layers))


class PredictCell(LSTMCell):
    """The prediction network's LSTM cell: one bias (`bias_ih`, zeros at
    init), as the converted checkpoint sums the two. The fused CUDA cell
    takes both biases or neither, so the step passes zeros for the
    second."""

    init_fill = {"bias_ih": 0.0}

    def __init__(self, hidden: int):
        super().__init__(hidden, hidden, bias=False)
        self.bias_ih = nn.Parameter(torch.empty(4 * hidden))
        self._zero: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor, hx):
        zero = self._zero
        if zero is None or zero.dtype != x.dtype or zero.device != x.device:
            zero = self._zero = torch.zeros(self.bias_ih.shape,
                                            dtype=x.dtype, device=x.device)
        return torch.lstm_cell(x, hx, self.weight_ih, self.weight_hh,
                               self.bias_ih, zero)


# ---------------------------------------------------------------- model

class Model(TorchModel):
    """Nemotron ASR on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda"):
        device = check_device(device)
        if config is None:
            config = ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        a, pd, j = config.encoder, config.decoder, config.joint
        with torch.device(device):
            self.encoder = Encoder(a)
            self.prompt_kernel = nn.ModuleDict({
                "0": Linear(a.d_model + config.prompt.num_prompts,
                            config.prompt.prompt_hidden),
                "2": Linear(config.prompt.prompt_hidden, a.d_model)})
            vocab = pd.vocab_size + (1 if pd.blank_as_pad else 0)
            self.decoder = holder(prediction=holder(
                embed=Embedding(vocab, pd.pred_hidden),
                dec_rnn=holder(lstm=nn.ModuleList(
                    PredictCell(pd.pred_hidden)
                    for _ in range(pd.pred_rnn_layers)))))
            self.joint = holder(
                enc=Linear(j.encoder_hidden, j.joint_hidden),
                pred=Linear(j.pred_hidden, j.joint_hidden),
                joint_net=nn.ModuleDict({"2": Linear(j.joint_hidden,
                                                     j.num_classes + 1)}))
        self.requires_grad_(False)
        self.eval()
        self.last_run: Dict[str, int] = {}

    @property
    def sample_rate(self) -> int:
        return self.config.preprocessor.sample_rate

    @property
    def dtype(self) -> torch.dtype:
        """The floating dtype of the parameters: the compute dtype."""
        return self.encoder.pre_encode.out.weight.dtype

    def _prompt_index(self, language: Optional[str]) -> int:
        d = self.config.prompt.prompt_dictionary
        lang = language or self.config.default_language
        if lang in d:
            return d[lang]
        if self.config.default_language in d:
            return d[self.config.default_language]
        return 0

    # ------------------------------------------------------------ encoder

    @torch.inference_mode()
    def encode(self, mel: torch.Tensor, n_valid: int,
               att_context: Tuple[int, int], prompt_idx: int
               ) -> torch.Tensor:
        """(1, T_bucket, F) mel, its first `n_valid` frames real -> (1, T',
        d_model) prompted encoder output; padded frames come out zero."""
        cfg = self.config
        a = cfg.encoder
        x = self.encoder.pre_encode(mel.to(self.dtype))
        if a.xscaling:
            x = x * (a.d_model ** 0.5)
        t, dev = x.shape[1], x.device
        pos_emb = _pos_table(t, a.d_model, dev, x.dtype)
        valid = torch.arange(t, device=dev) < subsampled_length(
            n_valid, _n_stages(a))
        allow = valid[None, None, None, :]
        if a.att_context_style == "chunked_limited":
            allow = allow & torch.from_numpy(chunked_limited_mask(
                t, att_context[0], att_context[1])).to(dev)[None, None]
        vmask = valid[None, :, None]
        x = torch.where(vmask, x, 0.0)
        pa = _PkArgs(d_model=a.d_model, n_heads=a.n_heads)
        kcs = a.conv_kernel_size
        pad = (kcs - 1, 0) if a.conv_context_size == "causal" else \
            (int(a.conv_context_size[0]), int(a.conv_context_size[1]))
        for blk in self.encoder.layers:
            x = x + 0.5 * blk.feed_forward1(blk.norm_feed_forward1(x))
            att = rel_pos_attention(blk.self_attn, pa, blk.norm_self_att(x),
                                    pos_emb, allow)
            x = x + torch.where(vmask, att, 0.0)
            c = blk.conv
            h = F.glu(_pointwise(c.pointwise_conv1, blk.norm_conv(x)), dim=-1)
            h = F.silu(c.batch_norm(c.depthwise_conv(h, padding=pad)))
            x = x + _pointwise(c.pointwise_conv2, h)
            x = x + 0.5 * blk.feed_forward2(blk.norm_feed_forward2(x))
            x = torch.where(vmask, blk.norm_out(x), 0.0)
        one_hot = F.one_hot(torch.tensor(prompt_idx, device=dev),
                            cfg.prompt.num_prompts).to(x.dtype)
        h = torch.cat([x, one_hot.expand(x.shape[0], t, -1)], dim=-1)
        h = F.relu(self.prompt_kernel["0"](h))
        return self.prompt_kernel["2"](h)

    # ------------------------------------------------------ greedy RNN-T

    def _predict(self, token: torch.Tensor, h, c):
        """One prediction-network step on token (1,): the blank's embedding
        is zero (blank-as-pad). -> (output through the joint's `pred` (1,
        J), h, c)."""
        p = self.decoder.prediction
        blank = self.config.decoder.vocab_size
        emb = p.embed(token.clamp(max=p.embed.weight.shape[0] - 1))
        emb = torch.where((token == blank)[:, None], 0.0, emb)
        out, h, c = lstm_step(p.dec_rnn.lstm, emb, h, c)
        return self.joint.pred(out), h, c

    def _joint(self, enc_t: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        return self.joint.joint_net["2"](F.relu(enc_t + pred))

    def initial_state(self):
        """The decoder state before any token (a stream's start)."""
        pd = self.config.decoder
        return initial_state(self._predict, pd.vocab_size,
                             pd.pred_rnn_layers, pd.pred_hidden, self.dtype,
                             self.device)

    @torch.inference_mode()
    def greedy_rnnt(self, feats: torch.Tensor, n_frames: int, state):
        """Greedy RNN-T over the first `n_frames` of feats (1, T, d) from
        `state` -> (tokens, frames, the state after, run counts)."""
        pd = self.config.decoder
        return greedy_transducer(
            self._predict, self._joint, self.joint.enc(feats[0]), n_frames,
            state, pd.vocab_size, self.config.max_symbols)

    # ----------------------------------------------------------- generate

    def _chunks(self, audio: np.ndarray, language: Optional[str],
                att_context, chunk_duration: Optional[float]):
        """Decode `audio` chunk by chunk with the decoder state carried ->
        yields (tokens, absolute frames) per chunk; `last_run` counts the
        audio chunks and sums their joint steps, loop chunks and reads."""
        cfg = self.config
        pp = cfg.preprocessor
        att = tuple(att_context or cfg.default_att_context_size)
        mel = nemo_log_mel(torch.from_numpy(audio).to(self.device), pp)
        chunk_frames = (int(chunk_duration * pp.sample_rate / pp.hop_length)
                        if chunk_duration else mel.shape[0])
        prompt_idx = self._prompt_index(language)
        state = self.initial_state()
        run = {"audio_chunks": 0}
        self.last_run = run
        base = 0
        for s0 in range(0, mel.shape[0], chunk_frames):
            seg = mel[s0:s0 + chunk_frames]
            n = seg.shape[0]
            b = next((x for x in MEL_BUCKETS if n <= x),
                     ((n + 511) // 512) * 512)
            padded = torch.zeros(1, b, seg.shape[1], device=self.device)
            padded[0, :n] = seg
            feats = self.encode(padded, n, att, prompt_idx)
            n_frames = subsampled_length(n, _n_stages(cfg.encoder))
            toks, frames, state, r = self.greedy_rnnt(feats, n_frames, state)
            run["audio_chunks"] += 1
            for k, v in r.items():
                run[k] = run.get(k, 0) + v
            yield toks, [f + base for f in frames]
            base += n_frames

    def _frame_sec(self) -> float:
        cfg = self.config
        return (cfg.encoder.subsampling_factor * cfg.preprocessor.hop_length
                / cfg.preprocessor.sample_rate)

    def generate(self, audio, *, language: Optional[str] = None,
                 att_context_size=None, chunk_duration: float = 30.0,
                 verbose: bool = False, **kwargs) -> STTOutput:
        """Transcribe `audio` (a path, or samples at the preprocessor's
        rate) in chunks of `chunk_duration` seconds, the decoder state
        carried across them."""
        t0 = time.time()
        tokens: List[int] = []
        times: List[int] = []
        for toks, frames in self._chunks(self._load(audio), language,
                                         att_context_size, chunk_duration):
            tokens += toks
            times += frames
        vocab = self.config.vocabulary
        text = decode_pieces(tokens, vocab)
        lang = detected_language(tokens, vocab) or language
        segments = self._sentences(tokens, times, self._frame_sec())
        dt = time.time() - t0
        if verbose:
            print(text.strip())
        return STTOutput(text=text.strip(), segments=segments,
                         language=lang, generation_tokens=len(tokens),
                         total_tokens=len(tokens), total_time=dt,
                         generation_tps=len(tokens) / dt if dt else 0)

    def stream_generate(self, audio, *, language: Optional[str] = None,
                        chunk_duration: float = 30.0,
                        att_context_size=None, **kwargs
                        ) -> Generator[STTOutput, None, None]:
        """Yield a cumulative STTOutput per audio chunk; the decoder state
        is carried across chunks."""
        vocab = self.config.vocabulary
        tokens: List[int] = []
        times: List[int] = []
        for toks, frames in self._chunks(self._load(audio), language,
                                         att_context_size, chunk_duration):
            tokens += toks
            times += frames
            yield STTOutput(
                text=decode_pieces(tokens, vocab).strip(),
                segments=self._sentences(tokens, times, self._frame_sec()),
                language=detected_language(tokens, vocab) or language)

    def _sentences(self, tokens: List[int], times: List[int],
                   frame_sec: float) -> List[dict]:
        vocab = self.config.vocabulary
        segs, cur, start = [], [], None
        for t, tm in zip(tokens, times):
            if t < 0 or t >= len(vocab) or is_special_piece(vocab[t]):
                continue
            piece = vocab[t].replace("▁", " ")
            if start is None:
                start = tm * frame_sec
            cur.append(piece)
            if piece.strip().endswith((".", "!", "?")):
                segs.append({"text": "".join(cur).strip(), "start": start,
                             "end": (tm + 1) * frame_sec})
                cur, start = [], None
        if cur:
            segs.append({"text": "".join(cur).strip(), "start": start,
                         "end": (times[-1] + 1) * frame_sec
                         if times else 0.0})
        return segs

    def _load(self, audio) -> np.ndarray:
        x = audio[0] if isinstance(audio, list) else audio
        if isinstance(x, (str, Path)):
            x = load_audio(str(x), self.sample_rate)
        return np.asarray(x, np.float32).reshape(-1)

    # ------------------------------------------------------------ loading

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """The converted layout (MLX conv2d (O,H,W,I) -> HWIO, conv1d
        (O,K,I) -> WIO, LSTM Wx/Wh/bias -> weight_ih/hh/bias_ih) onto the
        JAX tree's names and layouts, as numpy; the JAX tree's own passes
        through."""
        out = {}
        for k, v in weights.items():
            v = np.asarray(v)
            if ".dec_rnn.lstm." in k:
                k = k.replace(".Wx", ".weight_ih") \
                     .replace(".Wh", ".weight_hh")
                if k.endswith(".bias"):
                    k = k[:-5] + ".bias_ih"
            if k.endswith(".weight") and v.ndim == 4 \
                    and v.shape[1] in (1, 3) and v.shape[0] not in (1, 3):
                v = np.transpose(v, (1, 2, 3, 0))   # (O,H,W,I) -> HWIO
            elif k.endswith(".weight") and v.ndim == 3 and "conv" in k \
                    and v.shape[0] not in (1,
                                           self.config.encoder
                                           .conv_kernel_size):
                v = np.transpose(v, (1, 2, 0))      # (O,K,I) -> WIO
            out[k] = v
        return out


__all__ = ["Model", "ModelConfig", "PreprocessArgs", "ConformerArgs",
           "PromptArgs", "PredictArgs", "JointArgs", "nemo_log_mel",
           "decode_pieces", "detected_language", "chunked_limited_mask",
           "subsampled_length", "MEL_BUCKETS"]
