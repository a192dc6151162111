"""FireRedASR2-AED: a conformer encoder and a transformer decoder with
beam search.

Counterpart of mlx_audio_tpu/stt/models/fireredasr2/fireredasr2.py:

* the config (:54-90) and `sub_lengths` (:281);
* the encoder (`encoder_forward` :243-278): the right-context pad of 6
  frames and two stride-2 3x3 conv2d with ReLU, the ESPnet relative
  positions (`_rel_pe` :177-187), macaron conformer blocks with SiLU FFNs
  (:190-194), relative-position attention with a LayerNorm on each of q,
  k and v (`_mhsa` :204-224) and FireRed's own `_rel_shift` (:197-201,
  keeping t2 // 2 + 1 columns), the conv module whose `batch_norm` key is
  a LayerNorm (:227-240);
* the decoder step (`dec_step` :355-385: sinusoidal positions, self
  attention over f32 caches, cross attention, exact-GELU MLP) and the
  beam search (`beam_search` :387-447): beam 3 by default, softmax
  smoothing 1.25, the EOS penalty, finished beams frozen with one EOS
  candidate, reindexed caches and confidences, `max_decode =
  min(sub_len(bucket), 448)`; then the GNMT length penalty's ranking
  (:481-495);
* the features (`_extract_fbank` :305-318: the Kaldi fbank at int16
  scale, the CMVN of `cmvn.json`), `sanitize` and `post_load_hook`
  (`cmvn.json`, `dict.txt`).

Departures from the JAX package:

* the encoder runs the features' own frames; JAX pads them to a
  `MEL_BUCKETS` length and masks the padded keys and the conv module's
  padded rows (`pos_mask`), and its masked result on the valid rows is
  the unpadded one (`test_torch_fireredasr2.py::
  test_encoder_unpadded_equals_jax_bucketed`); the decoder's cross
  attention then needs no mask. The bucket still sets max_decode, so
  the beam's length cap is JAX's;
* the beam search runs eagerly, a step at a time, with the decoder's
  caches reindexed by each step's surviving beams, and the cross K and V
  computed once for one row and shared by the beams (JAX computes them
  for each beam); the loop stops when every beam has finished, as JAX's
  `while_loop` does;
* `sanitize` reads each conv weight's layout (torch, MLX or the JAX
  tree's) from the model's own shapes, where JAX's transposes every 3-D
  and 4-D conv weight as torch's.
"""

from __future__ import annotations

import json
import math
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, convs_to_wio, holder
from ....nn import Conv1d, Conv2d, Embedding, LayerNorm, Linear, gelu
from ...models.base import STTOutput
from ..qwen3_asr.qwen3_asr import _to_jax_conv2d

MEL_BUCKETS = (128, 256, 512, 1024, 2048)
INF = 1e10


def _bucket(n, buckets=MEL_BUCKETS):
    for b in buckets:
        if n <= b:
            return b
    return ((n + 511) // 512) * 512


@dataclass
class EncoderConfig(BaseModelArgs):
    n_layers: int = 16
    n_head: int = 20
    d_model: int = 1280
    kernel_size: int = 33
    pe_maxlen: int = 5000


@dataclass
class DecoderConfig(BaseModelArgs):
    n_layers: int = 16
    n_head: int = 20
    d_model: int = 1280
    pe_maxlen: int = 5000


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "fireredasr2"
    idim: int = 80
    odim: int = 8667
    d_model: int = 1280
    sos_id: int = 3
    eos_id: int = 4
    pad_id: int = 2
    blank_id: int = 0
    encoder: Optional[dict] = None
    decoder: Optional[dict] = None
    model_path: str = ""

    def __post_init__(self):
        self.enc = EncoderConfig.from_dict(self.encoder or {})
        self.dec = DecoderConfig.from_dict(self.decoder or {})


def sub_lengths(t):
    """Mel frames -> conformer frames (pad 6, two valid k3/s2 convs)."""
    t = t + 6
    for _ in range(2):
        t = (t - 3) // 2 + 1
    return t


def _rel_pe(t: int, dm: int) -> np.ndarray:
    """ESPnet's relative positions t-1 .. -(t-1): (1, 2t - 1, dm) f32."""
    pos = np.arange(t, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dm, 2, dtype=np.float32)
                 * -(math.log(10000.0) / dm))
    pe_pos = np.zeros((t, dm), np.float32)
    pe_pos[:, 0::2] = np.sin(pos * div)
    pe_pos[:, 1::2] = np.cos(pos * div)
    pe_neg = np.zeros((t, dm), np.float32)
    pe_neg[:, 0::2] = np.sin(-pos * div)
    pe_neg[:, 1::2] = np.cos(-pos * div)
    return np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)[None]


def _dec_pe(maxlen: int, dm: int) -> np.ndarray:
    pos = np.arange(maxlen, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dm, 2, dtype=np.float32)
                 * -(math.log(10000.0) / dm))
    pe = np.zeros((maxlen, dm), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(n, h, t1, t2) -> (n, h, t1, t2 // 2 + 1): row i keeps relative
    positions i - j (FireRed's shift, not NeMo's)."""
    n, h, t1, t2 = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(n, h, t2 + 1, t1)[:, :, 1:].reshape(n, h, t1, t2)
    return x[..., :t2 // 2 + 1]


# ----------------------------------------------------------------- encoder

class FFN(nn.Module):
    def __init__(self, dm: int):
        super().__init__()
        self.net_0 = LayerNorm(dm)
        self.net_1 = Linear(dm, 4 * dm)
        self.net_4 = Linear(4 * dm, dm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net_4(F.silu(self.net_1(self.net_0(x)))) + x


class RelMHSA(nn.Module):
    init_fill = {"pos_bias_u": 0.0, "pos_bias_v": 0.0}

    def __init__(self, dm: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        for name in ("w_qs", "w_ks", "w_vs", "fc", "linear_pos"):
            setattr(self, name, Linear(dm, dm, bias=False))
        for name in ("layer_norm_q", "layer_norm_k", "layer_norm_v"):
            setattr(self, name, LayerNorm(dm))
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, dm // n_head))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, dm // n_head))

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        n, t, dm = x.shape
        h = self.n_head
        dk = dm // h
        q = self.w_qs(self.layer_norm_q(x)).reshape(n, t, h, dk)
        k = self.w_ks(self.layer_norm_k(x)).reshape(n, t, h, dk)
        v = self.w_vs(self.layer_norm_v(x)).reshape(n, t, h, dk)
        p = self.linear_pos(pos).reshape(1, -1, h, dk).transpose(1, 2)
        qu = (q + self.pos_bias_u.to(x.dtype)).transpose(1, 2)
        qv = (q + self.pos_bias_v.to(x.dtype)).transpose(1, 2)
        ac = qu @ k.permute(0, 2, 3, 1)
        bd = _rel_shift(qv @ p.transpose(-1, -2))
        w = torch.softmax(((ac + bd) / math.sqrt(dk)).float(), dim=-1)
        o = (w.to(x.dtype) @ v.transpose(1, 2)).transpose(1, 2)
        return self.fc(o.reshape(n, t, dm)) + x


class ConvModule(nn.Module):
    def __init__(self, dm: int, kernel: int):
        super().__init__()
        self.kernel = kernel
        self.pre_layer_norm = LayerNorm(dm)
        self.pointwise_conv1 = Conv1d(dm, 4 * dm, 1, bias=False)
        self.depthwise_conv = Conv1d(2 * dm, 2 * dm, kernel, bias=False,
                                     groups=2 * dm)
        self.batch_norm = LayerNorm(2 * dm)
        self.pointwise_conv2 = Conv1d(2 * dm, dm, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.pointwise_conv1(self.pre_layer_norm(x)).chunk(2, dim=-1)
        h = self.depthwise_conv(a * torch.sigmoid(b),
                                padding=(self.kernel - 1) // 2)
        return self.pointwise_conv2(F.silu(self.batch_norm(h))) + x


class ConformerLayer(nn.Module):
    def __init__(self, e: EncoderConfig):
        super().__init__()
        self.ffn1 = FFN(e.d_model)
        self.mhsa = RelMHSA(e.d_model, e.n_head)
        self.conv = ConvModule(e.d_model, e.kernel_size)
        self.ffn2 = FFN(e.d_model)
        self.layer_norm = LayerNorm(e.d_model)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        h = 0.5 * x + 0.5 * self.ffn1(x)
        h = self.conv(self.mhsa(h, pos))
        h = 0.5 * h + 0.5 * self.ffn2(h)
        return self.layer_norm(h)


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        e = cfg.enc
        sub_dim = ((cfg.idim - 1) // 2 - 1) // 2
        self.d_model = e.d_model
        self.input_preprocessor = holder(
            conv1=Conv2d(1, 32, 3), conv2=Conv2d(32, 32, 3),
            out=Linear(32 * sub_dim, e.d_model))
        self.layer_stack = nn.ModuleList(ConformerLayer(e)
                                         for _ in range(e.n_layers))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, T, idim) fbank, every frame valid -> (B, sub_lengths(T),
        d_model)."""
        ip = self.input_preprocessor
        x = F.pad(feats, (0, 0, 0, 6))[:, None]           # (B, 1, T+6, F)
        x = F.relu(ip.conv2(F.relu(ip.conv1(x, stride=2)), stride=2))
        n, c, t, dsub = x.shape
        x = ip.out(x.permute(0, 2, 1, 3).reshape(n, t, c * dsub))
        pos = torch.from_numpy(_rel_pe(t, self.d_model)).to(x.device,
                                                            x.dtype)
        for layer in self.layer_stack:
            x = layer(x, pos)
        return x


# ----------------------------------------------------------------- decoder

class DecAttn(nn.Module):
    def __init__(self, dm: int):
        super().__init__()
        self.w_qs = Linear(dm, dm)
        self.w_ks = Linear(dm, dm, bias=False)
        self.w_vs = Linear(dm, dm)
        self.fc = Linear(dm, dm)


class DecoderLayer(nn.Module):
    def __init__(self, dm: int):
        super().__init__()
        self.self_attn_norm = LayerNorm(dm)
        self.self_attn = DecAttn(dm)
        self.cross_attn_norm = LayerNorm(dm)
        self.cross_attn = DecAttn(dm)
        self.mlp_norm = LayerNorm(dm)
        self.mlp = holder(w_1=Linear(dm, 4 * dm), w_2=Linear(4 * dm, dm))


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.dec
        self.cfg = d
        self.tgt_word_emb = Embedding(cfg.odim, d.d_model)
        self.layer_stack = nn.ModuleList(DecoderLayer(d.d_model)
                                         for _ in range(d.n_layers))
        self.layer_norm_out = LayerNorm(d.d_model)
        self.tgt_word_prj = Linear(d.d_model, cfg.odim, bias=False)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> torch.Tensor:
    """q (B, h, 1, dk) against k, v (b, h, S, dk), b 1 or B; f32 softmax
    -> (B, h, 1, dk) in q's dtype."""
    s = (q * q.shape[-1] ** -0.5) @ k.transpose(-1, -2)
    return torch.softmax(s.float(), dim=-1).to(q.dtype) @ v


class BeamSearch:
    """One utterance's beam search over `model`'s decoder on `enc_out`
    (1, S, dm): `run()` -> (ys (beam, max_decode + 1), scores (beam,),
    conf (beam, max_decode), steps run); `step_ms` holds each step's wall
    ms, from one stop check (a read of the device) to the next."""

    def __init__(self, model: "Model", enc_out: torch.Tensor, beam: int,
                 max_decode: int, smoothing: float, eos_penalty: float):
        dec = model.decoder
        d = dec.cfg
        self.model, self.dec = model, dec
        self.h, self.dk = d.n_head, d.d_model // d.n_head
        self.beam, self.max_decode = beam, max_decode
        self.smoothing, self.eos_penalty = smoothing, eos_penalty
        dev, dt = enc_out.device, enc_out.dtype
        self.scale = math.sqrt(d.d_model)
        self.pe = torch.from_numpy(_dec_pe(max_decode + 1, d.d_model)).to(
            dev, dt)
        # the cross K and V, once for the one encoder row the beams share
        self.ckv = []
        for lp in dec.layer_stack:
            ca = lp.cross_attn
            self.ckv.append(tuple(
                lin(enc_out).reshape(1, -1, self.h, self.dk).transpose(1, 2)
                for lin in (ca.w_ks, ca.w_vs)))
        shape = (beam, self.h, max_decode + 1, self.dk)
        self.k = [torch.zeros(shape, device=dev) for _ in dec.layer_stack]
        self.v = [torch.zeros(shape, device=dev) for _ in dec.layer_stack]

    def step(self, tokens: torch.Tensor, t: int) -> torch.Tensor:
        """tokens (beam,) at position t -> logits (beam, odim)."""
        dec, b, h, dk = self.dec, self.beam, self.h, self.dk
        x = dec.tgt_word_emb(tokens[:, None]) * self.scale + self.pe[t]
        for i, lp in enumerate(dec.layer_stack):
            a = lp.self_attn
            hn = lp.self_attn_norm(x)
            q, k, v = (lin(hn).reshape(b, 1, h, dk).transpose(1, 2)
                       for lin in (a.w_qs, a.w_ks, a.w_vs))
            self.k[i][:, :, t:t + 1] = k.float()
            self.v[i][:, :, t:t + 1] = v.float()
            o = _attend(q.float(), self.k[i][:, :, :t + 1],
                        self.v[i][:, :, :t + 1]).to(x.dtype)
            x = x + a.fc(o.transpose(1, 2).reshape(b, 1, h * dk))
            ca = lp.cross_attn
            q = ca.w_qs(lp.cross_attn_norm(x)).reshape(b, 1, h, dk) \
                .transpose(1, 2)
            o = _attend(q, *self.ckv[i])
            x = x + ca.fc(o.transpose(1, 2).reshape(b, 1, h * dk))
            x = x + lp.mlp.w_2(gelu(lp.mlp.w_1(lp.mlp_norm(x))))
        return dec.tgt_word_prj(dec.layer_norm_out(x))[:, 0]

    @torch.inference_mode()
    def run(self):
        cfg = self.model.config
        beam, eos, dev = self.beam, cfg.eos_id, self.pe.device
        ys = torch.full((beam, self.max_decode + 1), eos, dtype=torch.long,
                        device=dev)
        ys[:, 0] = cfg.sos_id
        scores = torch.tensor([0.0] + [-INF] * (beam - 1), device=dev)
        finished = torch.zeros(beam, dtype=torch.bool, device=dev)
        conf = torch.zeros(beam, self.max_decode, device=dev)
        frozen_v = torch.full((beam, beam), -INF, device=dev)
        frozen_v[:, 0] = 0.0
        t = 0
        self.step_ms = []
        t_last = time.perf_counter()
        while t < self.max_decode and not bool(finished.all()):
            if t:
                now = time.perf_counter()
                self.step_ms.append((now - t_last) * 1e3)
                t_last = now
            logits = self.step(ys[:, t], t)
            lp_tok = torch.log(torch.softmax(
                logits.float() / self.smoothing, dim=-1) + 1e-10)
            if self.eos_penalty != 1.0:
                lp_tok[:, eos] *= self.eos_penalty
            topv, topi = torch.topk(lp_tok, beam, dim=-1)
            topv = torch.where(finished[:, None], frozen_v, topv)
            topi = torch.where(finished[:, None], eos, topi)
            best_v, best_i = torch.topk((scores[:, None] + topv).reshape(-1),
                                        beam)
            src = best_i // beam
            tok = topi.reshape(-1)[best_i]
            ys = ys[src]
            ys[:, t + 1] = tok
            self.k = [c[src] for c in self.k]
            self.v = [c[src] for c in self.v]
            conf = conf[src]
            conf[:, t] = torch.exp(topv.reshape(-1)[best_i])
            finished = finished[src] | (tok == eos)
            scores = best_v
            t += 1
        return ys, scores, conf, t


# ------------------------------------------------------------------- model

class Model(TorchModel):
    """FireRedASR2-AED on `device`: the card by default; without CUDA the
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
            self.encoder = Encoder(config)
            self.decoder = Decoder(config)
        self._tokenizer: Optional[List[str]] = None
        self._cmvn = None
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return 16000

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.tgt_word_prj.weight.dtype

    def _extract_fbank(self, audio) -> np.ndarray:
        from ....dsp import compute_fbank_kaldi

        wav = np.asarray(audio, np.float32).reshape(-1)
        if np.abs(wav).max() <= 1.0:
            wav = wav * 32768.0
        feats = compute_fbank_kaldi(
            wav, sample_rate=16000, win_len=400, win_inc=160,
            num_mels=self.config.idim, snip_edges=True, dither=0.0,
            device=self.device).cpu().numpy()
        if self._cmvn is not None:
            means, istd = self._cmvn
            feats = (feats - means) * istd
        return feats.astype(np.float32)

    @torch.inference_mode()
    def encode(self, feats) -> torch.Tensor:
        """(T, idim) features -> (1, sub_lengths(T), d_model)."""
        x = torch.as_tensor(np.asarray(feats, np.float32),
                            device=self.device)[None]
        return self.encoder(x.to(self.dtype))

    def _sub_len(self, t: int) -> int:
        return max(int(sub_lengths(t)), 1)

    def generate(self, audio, *, beam_size: int = 3,
                 softmax_smoothing: float = 1.25,
                 length_penalty: float = 0.6, eos_penalty: float = 1.0,
                 max_len: int = 0, verbose: bool = False, **kwargs
                 ) -> STTOutput:
        from ...models.llm_stt import as_audio

        t0 = time.time()
        feats = self._extract_fbank(as_audio(audio, 16000))
        t = feats.shape[0]
        # the length cap depends on the mel bucket only, as in JAX
        max_decode = max_len if max_len > 0 else min(
            self._sub_len(_bucket(t)), 448)
        t1 = time.perf_counter()
        enc_out = self.encode(feats)
        enc_ms = (time.perf_counter() - t1) * 1e3
        search = BeamSearch(self, enc_out, beam_size, max_decode,
                            softmax_smoothing, eos_penalty)
        ys, scores, conf, steps = search.run()
        ys, scores, conf = (a.cpu().numpy() for a in (ys, scores, conf))
        self.last_run = {"frames": t, "enc_frames": enc_out.shape[1],
                         "encode_ms": enc_ms, "steps": steps,
                         "max_decode": max_decode, "ys": ys,
                         "scores": scores, "step_ms": search.step_ms}

        # GNMT length penalty ranking (the SOS token counted too)
        lens = 1.0 + (ys[:, 1:] != self.config.eos_id).sum(axis=1).astype(
            np.float32)
        if length_penalty > 0:
            penalty = ((5.0 + lens) / 6.0) ** length_penalty
            final = scores / np.maximum(penalty, 1e-6)
        else:
            final = scores
        best = int(np.argmax(final))
        seq = ys[best, 1:]
        eos_pos = np.where(seq == self.config.eos_id)[0]
        seq = seq[: eos_pos[0]] if len(eos_pos) else seq
        text = self._detokenize(seq.tolist())
        confidence = float(conf[best, : len(seq)].mean()) if len(seq) \
            else 0.0
        dt = time.time() - t0
        if verbose:
            print(text)
        return STTOutput(
            text=text, language="zh",
            segments=[{"text": text, "confidence": round(confidence, 3)}],
            prompt_tokens=0, generation_tokens=int(len(seq)),
            total_tokens=int(len(seq)), total_time=round(dt, 3),
            prompt_tps=0.0, generation_tps=len(seq) / dt if dt else 0.0)

    __call__ = generate

    def _detokenize(self, ids: List[int]) -> str:
        if self._tokenizer is None:
            return " ".join(map(str, ids))
        toks = [self._tokenizer[i] for i in ids
                if 0 <= i < len(self._tokenizer)]
        text = "".join(toks).replace("▁", " ").strip()
        return re.sub(r"(<blank>)|(<sil>)", "", text).lower()

    # ------------------------------------------------------------ loading

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """FireRed's names -> the JAX tree's (`conv.0.` / `conv.2.` ->
        `conv1.` / `conv2.`, `net.N.` -> `net_N.`), each conv weight read
        into WIO or HWIO from the layout its shape shows against this
        model's, and a missing `tgt_word_prj` tied to the embedding."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for k, v in weights.items():
            v = np.asarray(v)
            k = k.replace("input_preprocessor.conv.0.",
                          "input_preprocessor.conv1.")
            k = k.replace("input_preprocessor.conv.2.",
                          "input_preprocessor.conv2.")
            k = re.sub(r"\.net\.(\d+)\.", r".net_\1.", k)
            if "input_preprocessor.conv" in k and k.endswith("weight") \
                    and v.ndim == 4 and k in shapes:
                v = _to_jax_conv2d(k, v, shapes[k])
            out[k] = v
        out = convs_to_wio(out, shapes, lambda k, v: np.ndim(v) == 3 and (
            "pointwise_conv" in k or "depthwise_conv" in k)
            and k.endswith("weight"))
        if "decoder.tgt_word_prj.weight" not in out \
                and "decoder.tgt_word_emb.weight" in out:
            out["decoder.tgt_word_prj.weight"] = \
                out["decoder.tgt_word_emb.weight"]
        return out

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The CMVN of `cmvn.json` and the `dict.txt` token list."""
        model_path = Path(model_path)
        cmvn = model_path / "cmvn.json"
        if cmvn.exists():
            data = json.loads(cmvn.read_text())
            model._cmvn = (np.asarray(data["means"], np.float32),
                           np.asarray(data["istd"], np.float32))
        dict_path = model_path / "dict.txt"
        if dict_path.exists():
            id2word = []
            for line in dict_path.read_text(encoding="utf8").splitlines():
                toks = line.strip().split()
                word = toks[0] if toks else " "
                id2word.append(" " if word == "<space>" else word)
            model._tokenizer = id2word
        return model


__all__ = ["Model", "ModelConfig", "EncoderConfig", "DecoderConfig",
           "BeamSearch", "sub_lengths", "MEL_BUCKETS"]
