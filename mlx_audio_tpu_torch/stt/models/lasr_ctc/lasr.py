"""LASR-CTC: a RoPE conformer encoder and a CTC head.

Counterpart of mlx_audio_tpu/stt/models/lasr_ctc/lasr.py:

* the configs (`LasrEncoderConfig`, `ModelConfig`, :48-93: the residual
  weights, `rope_theta` read from `rope_parameters`);
* `lasr_forward` (:185-238): the subsampler (a ReLU dense layer, two
  stride-2 convs without padding, a dense layer), neox-half RoPE
  (`_rope_half` :159), conformer blocks with weighted residuals (two
  half-weighted SiLU FFNs, attention, the GLU conv module of `_conv_module`
  :171 with its batch norm), each block's `norm_out`, `out_norm` and the
  CTC head;
* `generate` (:257-300): the Whisper log-mel, the argmax collapsed on the
  host (repeats, then blanks); `sanitize` and `post_load_hook` (:309-335).

Departures from the JAX package:

* the encoder runs the mel frames the audio has. JAX pads them to a
  `MEL_BUCKETS` length (a compile-count workaround) with no mask, so its
  attention and depthwise convs also read the padding's rows, and its
  logits on the valid frames differ from the unpadded run's (a JAX fault:
  `tests/test_torch_lasr_ctc.py::test_unpadded_run_departs_from_jax_bucket`).
  At a length that is a bucket the two agree;
* `sanitize` reads each conv weight's layout (torch, MLX or the JAX
  tree's WIO) from the model's own shapes, where JAX's transposes a
  weight whose first axis is at least its last;
* `post_load_hook` reads only the directory's tokenizer files and raises
  when they fail to load, where JAX's swallows any error and leaves none.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, convs_to_wio, holder
from ....nn import BatchNorm, Conv1d, LayerNorm, Linear
from ....ops.attention import attention
from ....ops.rope import apply_rope, rope_freqs
from ....tts.models.base import local_tokenizer
from ...models.base import STTOutput
from ..llm_stt import as_audio
from ..whisper.audio import SAMPLE_RATE, log_mel_spectrogram


@dataclass
class LasrEncoderConfig(BaseModelArgs):
    hidden_size: int = 512
    num_hidden_layers: int = 17
    num_attention_heads: int = 8
    num_key_value_heads: int = 8
    intermediate_size: int = 2048
    conv_kernel_size: int = 32
    convolution_bias: bool = False
    num_mel_bins: int = 128
    subsampling_conv_channels: int = 256
    subsampling_conv_kernel_size: int = 5
    subsampling_conv_stride: int = 2
    layer_norm_eps: float = 1e-6
    attention_bias: bool = False
    rope_theta: float = 10000.0
    conv_residual_weights: Optional[List[float]] = None
    feed_forward_residual_weights: Optional[List[float]] = None
    rope_parameters: Optional[dict] = None

    def __post_init__(self):
        if self.conv_residual_weights is None:
            self.conv_residual_weights = [2.0, 1.0]
        if self.feed_forward_residual_weights is None:
            self.feed_forward_residual_weights = [1.5, 0.5]
        if self.rope_parameters and "rope_theta" in self.rope_parameters:
            self.rope_theta = self.rope_parameters["rope_theta"]

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "lasr"
    vocab_size: int = 512
    encoder_config: Optional[dict] = None
    pad_token_id: int = 0
    model_path: str = ""

    def __post_init__(self):
        self.encoder = LasrEncoderConfig.from_dict(self.encoder_config or {})


def _ff(e: LasrEncoderConfig) -> nn.Module:
    return holder(linear1=Linear(e.hidden_size, e.intermediate_size,
                                 bias=e.attention_bias),
                  linear2=Linear(e.intermediate_size, e.hidden_size,
                                 bias=e.attention_bias))


def _layer(e: LasrEncoderConfig) -> nn.Module:
    d, ab, cb = e.hidden_size, e.attention_bias, e.convolution_bias
    ln = lambda: LayerNorm(d, e.layer_norm_eps)  # noqa: E731
    return holder(
        feed_forward1=_ff(e),
        self_attn=holder(q_proj=Linear(d, d, bias=ab),
                         k_proj=Linear(d, d, bias=ab),
                         v_proj=Linear(d, d, bias=ab),
                         o_proj=Linear(d, d, bias=ab)),
        conv=holder(pointwise_conv1=Conv1d(d, 2 * d, 1, bias=cb),
                    depthwise_conv=Conv1d(d, d, e.conv_kernel_size, bias=cb,
                                          groups=d),
                    norm=BatchNorm(d),
                    pointwise_conv2=Conv1d(d, d, 1, bias=cb)),
        feed_forward2=_ff(e), norm_feed_forward1=ln(), norm_self_att=ln(),
        norm_conv=ln(), norm_feed_forward2=ln(), norm_out=ln())


def _ff_forward(p, x: torch.Tensor) -> torch.Tensor:
    return p.linear2(F.silu(p.linear1(x)))


def _conv_module(p, x: torch.Tensor) -> torch.Tensor:
    """Pointwise conv, GLU, depthwise conv over (K-1)//2 left and the
    rest right of zero padding, batch norm, SiLU, pointwise conv."""
    a, b = p.pointwise_conv1(x).chunk(2, dim=-1)
    h = a * torch.sigmoid(b)
    k = p.depthwise_conv.weight.shape[-1]
    h = p.depthwise_conv(h, padding=((k - 1) // 2, k - 1 - (k - 1) // 2))
    return p.pointwise_conv2(F.silu(p.norm(h)))


def lasr_forward(model: "Model", mel: torch.Tensor) -> torch.Tensor:
    """(B, T, n_mels) -> CTC logits (B, T', vocab) (`lasr_forward`)."""
    e = model.config.encoder
    enc = model.encoder
    s = enc.subsampler
    stride = e.subsampling_conv_stride
    x = F.relu(s.dense_0(mel))
    x = F.relu(s.conv_0(x, stride=stride))
    x = F.relu(s.conv_1(x, stride=stride))
    x = s.dense_1(x)
    b, t, d = x.shape
    h, hd = e.num_attention_heads, e.head_dim
    pos = torch.arange(t, device=x.device)
    inv = rope_freqs(hd, e.rope_theta).to(x.device)
    (wf0, wf1), (wc0, wc1) = (e.feed_forward_residual_weights,
                              e.conv_residual_weights)
    for lp in enc.layers:
        x = wf0 * x + wf1 * _ff_forward(lp.feed_forward1,
                                        lp.norm_feed_forward1(x))
        hn = lp.norm_self_att(x)
        sa = lp.self_attn
        q = apply_rope(sa.q_proj(hn).reshape(b, t, h, hd), pos, inv)
        k = apply_rope(sa.k_proj(hn).reshape(b, t, h, hd), pos, inv)
        v = sa.v_proj(hn).reshape(b, t, h, hd)
        x = x + sa.o_proj(attention(q, k, v).reshape(b, t, d))
        x = wc0 * x + wc1 * _conv_module(lp.conv, lp.norm_conv(x))
        x = wf0 * x + wf1 * _ff_forward(lp.feed_forward2,
                                        lp.norm_feed_forward2(x))
        x = lp.norm_out(x)
    return model.ctc_head(enc.out_norm(x))


def ctc_collapse(tokens: torch.Tensor, blank: int) -> List[int]:
    """Greedy CTC: adjacent repeats dropped, then blanks."""
    keep = torch.ones_like(tokens, dtype=torch.bool)
    keep[1:] = tokens[1:] != tokens[:-1]
    toks = tokens[keep]
    return toks[toks != blank].tolist()


class Model(TorchModel):
    """LASR-CTC on `device`: the card by default; without CUDA the
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
        e = config.encoder
        d, ch, ks = (e.hidden_size, e.subsampling_conv_channels,
                     e.subsampling_conv_kernel_size)
        with torch.device(device):
            self.encoder = holder(
                subsampler=holder(dense_0=Linear(e.num_mel_bins, d),
                                  conv_0=Conv1d(d, d, ks),
                                  conv_1=Conv1d(d, ch, ks),
                                  dense_1=Linear(ch, d)),
                layers=nn.ModuleList(_layer(e)
                                     for _ in range(e.num_hidden_layers)),
                out_norm=LayerNorm(d, e.layer_norm_eps))
            self.ctc_head = Linear(d, config.vocab_size)
        self._tokenizer = None
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return SAMPLE_RATE

    @property
    def dtype(self) -> torch.dtype:
        return self.ctc_head.weight.dtype

    def _sub_len(self, t: int) -> int:
        e = self.config.encoder
        k, s = e.subsampling_conv_kernel_size, e.subsampling_conv_stride
        for _ in range(2):
            t = (t - k) // s + 1
        return max(t, 0)

    @torch.inference_mode()
    def logits(self, mel) -> torch.Tensor:
        """(T, n_mels) log-mel -> (T', vocab) f32 CTC logits."""
        mel = torch.as_tensor(mel).to(self.device, self.dtype)
        return lasr_forward(self, mel[None])[0].float()

    def transcribe_ids(self, audio) -> List[int]:
        """Audio -> the collapsed CTC ids; frames and ms in `last_run`."""
        t0 = time.perf_counter()
        wav = as_audio(audio, SAMPLE_RATE)
        mel = log_mel_spectrogram(wav, n_mels=self.config.encoder
                                  .num_mel_bins, device=self.device)
        e = self.config.encoder
        t = mel.shape[0]
        need = (e.subsampling_conv_kernel_size - 1) * (
            e.subsampling_conv_stride + 1) + 1
        if t < need:                    # too short for the two convs
            mel = F.pad(mel, (0, 0, 0, need - t))
        tokens = self.logits(mel)[:max(self._sub_len(t), 1)].argmax(-1)
        ids = ctc_collapse(tokens, self.config.pad_token_id)
        self.last_run = {"frames": int(mel.shape[0]),
                         "ms": (time.perf_counter() - t0) * 1e3}
        return ids

    def generate(self, audio, *, verbose: bool = False,
                 **kwargs) -> STTOutput:
        t0 = time.time()
        wav = as_audio(audio, SAMPLE_RATE)
        ids = self.transcribe_ids(wav)
        text = (self._tokenizer.decode(ids, skip_special_tokens=True)
                if self._tokenizer is not None
                else " ".join(map(str, ids))).strip()
        dt = time.time() - t0
        if verbose:
            print(text)
        return STTOutput(
            text=text, language="en",
            segments=[{"text": text, "start": 0.0,
                       "end": len(wav) / SAMPLE_RATE}],
            prompt_tokens=0, generation_tokens=len(ids),
            total_tokens=len(ids), total_time=dt, prompt_tps=0.0,
            generation_tps=len(ids) / dt if dt else 0.0)

    __call__ = generate

    # ------------------------------------------------------------ loading

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """RoPE tables and step counters dropped, an HF conv1x1 CTC head
        made a linear, conv weights to WIO from the layout their shape
        shows; `load_jax_params` takes it from there."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for k, v in weights.items():
            if "rotary_emb.inv_freq" in k or "num_batches_tracked" in k:
                continue
            v = np.asarray(v)
            if k.endswith("ctc_head.weight") and v.ndim == 3:
                v = v[..., 0]
            out[k] = v
        return convs_to_wio(out, shapes, lambda k, v: np.ndim(v) == 3
                            and "conv" in k and k.endswith("weight"))

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (None without tokenizer files or
        `transformers`); tokenizer files that fail to load raise."""
        model._tokenizer = local_tokenizer(Path(model_path))
        return model


__all__ = ["Model", "ModelConfig", "LasrEncoderConfig", "lasr_forward",
           "ctc_collapse"]
