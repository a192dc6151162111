"""Mel-Band-RoFormer vocal source separation.

Counterpart of mlx_audio_tpu/sts/models/mel_roformer/model.py:

* `BandLayout` (:55-92): the band gather and scatter tables from the
  binarized Slaney filterbank, host-side, copied to the device once;
* `mel_roformer_forward` (:139-219): the STFT, the stereo complex-as-
  channels interleave, the band split (a per-band F.normalize RMSNorm over
  each band's true entries, then a projection), depth x the dual-axis
  RoFormer (time then frequency; interleaved-pair RoPE, per-head sigmoid
  gates, an RMSNorm-first GELU FFN), the per-band MLP + GLU mask
  estimator, the overlap-averaged scatter merge, the complex multiply and
  the COLA-normalized iSTFT;
* `Model.separate` (:302-336): fixed 8-s chunks at 50% overlap, the
  overlaps averaged; a mono input is upmixed;
* `sanitize` (:337-452): a ZFTurbo torch checkpoint (to_qkv packing,
  Sequential indices, `.gamma` names, dropped rotary freqs) padded and
  stacked into the ragged-band layout.

The stacked ragged bands of the JAX package suit the card as they suit
the TPU: every per-band weight is zero-padded to the widest band and
stacked, so each per-band stage is one batched product over the 60 bands
(`torch.einsum`) in place of 60 small ones; the padded lanes stay inert
(zeroed inputs, norms over true entries, GLU halves re-packed [value |
gate] at load). The scatter merge is one `index_add_` over the flattened
(band, slot) table with a dummy overflow bin. Attention is
`F.scaled_dot_product_attention` (no mask; the JAX package's softmax of
scaled scores).

The STFT, the complex multiply and the iSTFT run in f32 (the port's `dsp`,
whose DFT is float64) whatever the parameters' dtype; the network runs in
the parameters' dtype (`model.astype(torch.bfloat16)`), under
`exact_f32()`: an f32 model's products take no TF32, whatever the process
set.

Departure from the JAX package: `Model.generate(audio)` is `separate` on a
file path (read at its channels and resampled to the model's rate) or an
array, so that the STS CLI can run the family; the JAX model has no
`generate`, and its CLI fails on it. The result's `audio` is its
`vocals`.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....dsp import istft as dsp_istft
from ....dsp import mel_filters, stft as dsp_stft
from ....model import TorchModel, check_device, holder, leaves
from ....ops.rope import apply_rotary_interleaved, rope_cis
from .config import MelRoFormerConfig


@dataclass
class MelRoFormerResult:
    vocals: np.ndarray                  # (2, samples)
    sample_rate: int
    duration_seconds: float
    processing_time_seconds: float

    @property
    def audio(self) -> np.ndarray:
        return self.vocals


# ----------------------------------------------------- band structure

class BandLayout:
    """Static per-band gather/scatter tables (host-side numpy, from the
    binarized Slaney filterbank)."""

    def __init__(self, cfg: MelRoFormerConfig):
        fb = mel_filters(sample_rate=cfg.sample_rate, n_fft=cfg.n_fft,
                         n_mels=cfg.num_bands, mel_scale="slaney").numpy()
        fb = np.array(fb, np.float32, copy=True)
        fb[0, 0] = 1.0
        fb[-1, -1] = 1.0
        fb = fb > 0

        f2 = cfg.freq_bins * 2
        cac, counts = [], np.zeros(f2, np.float32)
        for i in range(cfg.num_bands):
            bins = np.where(fb[i])[0]
            if bins.size == 0:
                bins = np.array([i])
            idx = np.stack([bins * 2, bins * 2 + 1], 1).reshape(-1)
            cac.append(idx)
            counts[idx] += 1

        self.num_bands = cfg.num_bands
        self.n_per_band = np.array([len(i) for i in cac], np.int32)
        self.max_n = int(self.n_per_band.max())
        self.band_dims = (self.n_per_band * 2).tolist()
        self.max_bd = 2 * self.max_n
        # padded gather table; invalid slots point at f2 (dummy row)
        tbl = np.full((cfg.num_bands, self.max_n), f2, np.int64)
        for i, idx in enumerate(cac):
            tbl[i, : len(idx)] = idx
        self.gather_idx = tbl
        self.valid = (np.arange(self.max_n)[None, :]
                      < self.n_per_band[:, None])
        self.counts = np.maximum(counts, 1.0).astype(np.float32)
        self.f2 = f2


def _rms_normalize(x: torch.Tensor, scale, gamma: torch.Tensor
                   ) -> torch.Tensor:
    """ZFTurbo RMSNorm: F.normalize(x, dim=-1) * sqrt(dim) * gamma, with
    torch's max(||x||, 1e-12) clamp."""
    return F.normalize(x, dim=-1, eps=1e-12) * (scale * gamma.to(x.dtype))


# ------------------------------------------------------------- layers

def _attention_block(p: nn.Module, x: torch.Tensor, cfg: MelRoFormerConfig,
                     cis: torch.Tensor) -> torch.Tensor:
    """(N, T, D) gated RoPE attention."""
    n, t, _ = x.shape
    h = _rms_normalize(x, cfg.dim ** 0.5, p.norm_gamma)
    heads, hd = cfg.heads, cfg.dim_head
    dt = x.dtype
    q = F.linear(h, p.q_w.to(dt)).reshape(n, t, heads, hd)
    k = F.linear(h, p.k_w.to(dt)).reshape(n, t, heads, hd)
    v = F.linear(h, p.v_w.to(dt)).reshape(n, t, heads, hd)
    q = apply_rotary_interleaved(q, cis)
    k = apply_rotary_interleaved(k, cis)
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2)).transpose(1, 2)
    gates = torch.sigmoid(F.linear(h, p.gates_w.to(dt), p.gates_b.to(dt)))
    o = o * gates[..., None]
    return F.linear(o.reshape(n, t, heads * hd), p.out_w.to(dt))


def _ffn_block(p: nn.Module, x: torch.Tensor,
               cfg: MelRoFormerConfig) -> torch.Tensor:
    dt = x.dtype
    h = _rms_normalize(x, cfg.dim ** 0.5, p.norm_gamma)
    h = F.gelu(F.linear(h, p.fc1_w.to(dt), p.fc1_b.to(dt)))
    return F.linear(h, p.fc2_w.to(dt), p.fc2_b.to(dt))


def _transformer(p: nn.Module, x: torch.Tensor, cfg: MelRoFormerConfig,
                 cis: torch.Tensor) -> torch.Tensor:
    x = x + _attention_block(p.attn, x, cfg, cis)
    x = x + _ffn_block(p.ff, x, cfg)
    return _rms_normalize(x, cfg.dim ** 0.5, p.norm_gamma)


# ------------------------------------------------------------ pipeline

def _window(n_fft: int) -> np.ndarray:
    return np.hanning(n_fft + 1)[:-1].astype(np.float32)


def band_split(model: "Model", repr_ri: torch.Tensor) -> torch.Tensor:
    """The band split: the interleaved spectrum's (real, imag) pairs (B, T,
    F2, 2) gathered into the stacked bands (padded lanes zero), each band
    RMS-normalised over its true entries and projected -> (B, T, Nb, dim)
    in the parameters' dtype."""
    b, t = repr_ri.shape[:2]
    dt = model.dtype
    padded = F.pad(repr_ri, (0, 0, 0, 1))                 # dummy row F2
    g = padded[:, :, model.gather_idx, :]                 # (B,T,Nb,max_n,2)
    g = g * model.valid[None, None, :, :, None]
    x = g.reshape(b, t, model.num_bands, model.max_bd).to(dt)
    bs = model.band_split
    x = _rms_normalize(x, model.band_scale.to(dt)[:, None], bs.norm_gamma)
    return torch.einsum("btnd,ndo->btno", x, bs.proj_w.to(dt)) \
        + bs.proj_b.to(dt)


def mask_estimator(model: "Model", x: torch.Tensor) -> torch.Tensor:
    """The stacked per-band MLP and GLU: (B, T, Nb, dim) -> the f32 mask
    (B, T, Nb, max_bd), its padded lanes zero."""
    cfg, mbd, dt = model.config, model.max_bd, model.dtype
    me = model.mask_est
    h = torch.tanh(torch.einsum("btnd,ndh->btnh", x, me.w0.to(dt))
                   + me.b0.to(dt))
    for j in range(cfg.mask_estimator_depth - 1):
        h = torch.tanh(torch.einsum("btnh,nhk->btnk", h,
                                    getattr(me, f"wm{j}").to(dt))
                       + getattr(me, f"bm{j}").to(dt))
    out = (torch.einsum("btnh,nho->btno", h, me.wf.to(dt))
           + me.bf.to(dt)).float()
    value, gate = out[..., :mbd], out[..., mbd:]
    return value * torch.sigmoid(gate) * model.valid_bd[None, None]


def mel_roformer_forward(model: "Model", audio: torch.Tensor) -> torch.Tensor:
    """audio (B, 2, S) f32 on the model's device -> separated (B, 2, S)
    f32."""
    cfg = model.config
    b, _, s = audio.shape
    window = _window(cfg.n_fft)
    spec = dsp_stft(audio, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                    window=window)                       # (B, 2, T, F) cplx
    t_frames, f = spec.shape[2], spec.shape[3]
    # stereo CaC interleave: cac[2k] = L bin k, cac[2k+1] = R bin k
    cac = torch.stack([spec[:, 0], spec[:, 1]], dim=-1).reshape(
        b, t_frames, f * 2)                               # (B, T, F2)
    repr_ri = torch.view_as_real(cac)                     # (B, T, F2, 2)

    nb = model.num_bands
    x = band_split(model, repr_ri)
    d = cfg.dim
    cis_t = rope_cis(torch.arange(t_frames, device=x.device), model.inv_freq)
    cis_f = rope_cis(torch.arange(nb, device=x.device), model.inv_freq)
    for lp in model.layers:
        xt = x.transpose(1, 2).reshape(b * nb, t_frames, d)
        xt = _transformer(lp.time, xt, cfg, cis_t)
        x = xt.reshape(b, nb, t_frames, d).transpose(1, 2)
        xf = x.reshape(b * t_frames, nb, d)
        xf = _transformer(lp.freq, xf, cfg, cis_f)
        x = xf.reshape(b, t_frames, nb, d)

    mask = mask_estimator(model, x)

    # scatter merge with overlap averaging -> (B, T, F2, 2)
    pairs = mask.reshape(b, t_frames, nb * model.max_n, 2)
    full = torch.zeros(b, t_frames, model.f2 + 1, 2, device=x.device)
    full.index_add_(2, model.flat_idx, pairs)
    full = full[:, :, :model.f2] / model.counts[None, None, :, None]

    sep = cac * torch.view_as_complex(full.contiguous())  # (B, T, F2)
    sep = sep.reshape(b, t_frames, f, 2).permute(0, 3, 1, 2)  # (B, 2, T, F)
    wave = dsp_istft(sep.reshape(b * 2, t_frames, f),
                     hop_length=cfg.hop_length, win_length=cfg.n_fft,
                     window=window, center=True, length=None,
                     normalized=True)
    n = wave.shape[-1]
    wave = F.pad(wave, (0, s - n)) if n < s else wave[..., :s]
    return wave.reshape(b, 2, s)


# --------------------------------------------------------------- model

class Model(TorchModel):
    """Mel-Band-RoFormer on `device`: the card by default; without CUDA
    the constructor raises unless given `device="cpu"`."""

    def __init__(self, config: MelRoFormerConfig = None, device="cuda",
                 **kwargs):
        device = check_device(device)
        if config is None:
            config = MelRoFormerConfig.from_dict(kwargs) if kwargs else \
                MelRoFormerConfig()
        elif isinstance(config, dict):
            config = MelRoFormerConfig.from_dict(config)
        super().__init__(config)
        cfg = config
        self.layout = lay = BandLayout(cfg)
        self.num_bands, self.max_n, self.max_bd, self.f2 = (
            lay.num_bands, lay.max_n, lay.max_bd, lay.f2)
        nb, mbd, d, inner, hdim = (lay.num_bands, lay.max_bd, cfg.dim,
                                   cfg.dim_inner, cfg.mlp_hidden)

        def tf():
            m = leaves(norm_gamma=(d,))
            m.attn = leaves(norm_gamma=(d,), q_w=(inner, d), k_w=(inner, d),
                             v_w=(inner, d), gates_w=(cfg.heads, d),
                             gates_b=(cfg.heads,), out_w=(d, inner))
            m.ff = leaves(norm_gamma=(d,), fc1_w=(cfg.ff_dim, d),
                           fc1_b=(cfg.ff_dim,), fc2_w=(d, cfg.ff_dim),
                           fc2_b=(d,))
            return m

        with torch.device(device):
            self.band_split = leaves(norm_gamma=(nb, mbd),
                                      proj_w=(nb, mbd, d), proj_b=(nb, d))
            self.layers = nn.ModuleList(holder(time=tf(), freq=tf())
                                        for _ in range(cfg.depth))
            mask = {"w0": (nb, d, hdim), "b0": (nb, hdim),
                    "wf": (nb, hdim, 2 * mbd), "bf": (nb, 2 * mbd)}
            for j in range(cfg.mask_estimator_depth - 1):
                mask[f"wm{j}"] = (nb, hdim, hdim)
                mask[f"bm{j}"] = (nb, hdim)
            self.mask_est = leaves(**mask)
        for name, value in (
                ("gather_idx", torch.from_numpy(lay.gather_idx)),
                ("flat_idx", torch.from_numpy(lay.gather_idx.reshape(-1))),
                ("valid", torch.from_numpy(lay.valid)),
                ("valid_bd", torch.from_numpy(np.repeat(lay.valid, 2, -1))),
                ("counts", torch.from_numpy(lay.counts)),
                ("band_scale", torch.sqrt(torch.tensor(lay.band_dims,
                                                       dtype=torch.float32))),
                ("inv_freq", 1.0 / (10000.0 ** (
                    torch.arange(cfg.dim_head // 2, dtype=torch.float32)
                    / (cfg.dim_head // 2))))):
            self.register_buffer(name, value.to(device), persistent=False)
        self.requires_grad_(False)
        self.eval()

    @property
    def dtype(self) -> torch.dtype:
        return self.band_split.proj_w.dtype

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @torch.no_grad()
    def init_params(self, seed: int = 0,
                    on_device: bool = False) -> "Model":
        """Random weights from `seed` with the JAX package's init: norm
        gammas 1 (the band split's on true lanes only), biases 0, the
        transformers' weights uniform +-1/sqrt(in), the stacked band-split
        and mask-estimator weights uniform +-0.05. Drawn on the CPU in f32
        from one generator in parameter order unless `on_device`."""
        gens: Dict[torch.device, torch.Generator] = {}
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "norm_gamma":
                p.fill_(1.0)
                if name.startswith("band_split."):
                    p.mul_(self.valid_bd.to(p.dtype))
                continue
            if leaf.endswith("_b") or leaf in ("b0", "bf", "proj_b") \
                    or re.fullmatch(r"bm\d+", leaf):
                p.zero_()
                continue
            scale = (0.05 if name.startswith(("band_split.", "mask_est."))
                     else p.shape[-1] ** -0.5)
            dev, dtype = ((p.device, p.dtype) if on_device
                          else (torch.device("cpu"), torch.float32))
            g = gens.get(dev)
            if g is None:
                g = gens[dev] = torch.Generator(device=dev).manual_seed(seed)
            p.copy_(torch.empty(p.shape, device=dev, dtype=dtype).uniform_(
                -scale, scale, generator=g))
        return self

    # inference --------------------------------------------------------

    @torch.inference_mode()
    def forward(self, audio) -> torch.Tensor:
        """audio (B, 2, samples) -> separated vocals, same shape, f32 on
        the model's device."""
        from ....codec.models.mimi import exact_f32

        x = torch.as_tensor(np.asarray(audio, np.float32)
                            if not isinstance(audio, torch.Tensor) else audio)
        with exact_f32():
            return mel_roformer_forward(self, x.to(self.device,
                                                   torch.float32))

    def separate(self, audio, sample_rate: Optional[int] = None
                 ) -> MelRoFormerResult:
        """Full-track separation with 50%-overlapped fixed-size chunks
        (chunk_size / num_overlap; overlap regions averaged). One host read
        a chunk."""
        t0 = time.time()
        cfg = self.config
        x = np.asarray(audio, np.float32)
        if x.ndim == 1:
            x = np.stack([x, x])
        if x.shape[0] != 2 and x.shape[1] == 2:
            x = x.T
        s = x.shape[1]
        chunk = cfg.chunk_size
        hop = chunk // cfg.num_overlap
        out = np.zeros_like(x)
        weight = np.zeros(s, np.float32)
        starts = list(range(0, max(s - chunk, 0) + 1, hop)) or [0]
        if starts[-1] + chunk < s:
            starts.append(s - chunk)
        for st in starts:
            seg = np.zeros((1, 2, chunk), np.float32)
            n = min(chunk, s - st)
            seg[0, :, :n] = x[:, st: st + n]
            y = self(seg)[0].cpu().numpy()
            out[:, st: st + n] += y[:, :n]
            weight[st: st + n] += 1.0
        out /= np.maximum(weight, 1.0)
        return MelRoFormerResult(
            vocals=out, sample_rate=cfg.sample_rate,
            duration_seconds=s / cfg.sample_rate,
            processing_time_seconds=time.time() - t0)

    def generate(self, audio, **kwargs) -> MelRoFormerResult:
        """`separate` on an array (channels first or last, or mono) or an
        audio file, read at its channels and resampled to the model's
        rate."""
        if isinstance(audio, (str, Path)):
            from ....audio_io import read
            from ....utils import resample_audio

            data, sr = read(str(audio), dtype="float32")
            data = data.T if data.ndim > 1 else data
            if sr != self.config.sample_rate:
                data = (np.stack([resample_audio(ch, sr,
                                                 self.config.sample_rate)
                                  for ch in data]) if data.ndim > 1 else
                        resample_audio(data, sr, self.config.sample_rate))
            audio = data
        return self.separate(audio)

    # loading -----------------------------------------------------------

    def sanitize(self, weights: Dict) -> Dict:
        """A ZFTurbo torch checkpoint -> the stacked ragged-band layout, as
        numpy (the JAX package's :337-452); an already converted one passes
        through."""
        if "band_split.norm_gamma" in weights:
            return weights
        cfg, lay = self.config, self.layout
        nb, mbd = lay.num_bands, lay.max_bd

        src: Dict[str, np.ndarray] = {}
        for k, v in weights.items():
            if k.endswith("rotary_embed.freqs"):
                continue
            k = re.sub(r"\.gamma$", ".g", k)
            src[k] = np.asarray(v, np.float32)

        out: Dict[str, np.ndarray] = {}

        def stacked(maker, shape):
            buf = np.zeros(shape, np.float32)
            for i in range(nb):
                maker(i, buf)
            return buf

        def mk_gamma(i, buf):
            buf[i, : lay.band_dims[i]] = src[
                f"band_split.to_features.{i}.0.g"]
        out["band_split.norm_gamma"] = stacked(mk_gamma, (nb, mbd))

        def mk_pw(i, buf):
            w = src[f"band_split.to_features.{i}.1.weight"]  # (dim, bd)
            buf[i, : w.shape[1], :] = w.T
        out["band_split.proj_w"] = stacked(mk_pw, (nb, mbd, cfg.dim))

        def mk_pb(i, buf):
            buf[i] = src[f"band_split.to_features.{i}.1.bias"]
        out["band_split.proj_b"] = stacked(mk_pb, (nb, cfg.dim))

        # transformers: layers.{d}.{0|1}.(layers.0.{0|1}|norm).*
        for d in range(cfg.depth):
            for axis, name in ((0, "time"), (1, "freq")):
                base = f"layers.{d}.{axis}"
                pre = f"layers.{d}.{name}"
                attn = f"{base}.layers.0.0"
                qkv = src[f"{attn}.to_qkv.weight"]
                third = qkv.shape[0] // 3
                out[f"{pre}.attn.q_w"] = qkv[:third]
                out[f"{pre}.attn.k_w"] = qkv[third:2 * third]
                out[f"{pre}.attn.v_w"] = qkv[2 * third:]
                out[f"{pre}.attn.norm_gamma"] = src[f"{attn}.norm.g"]
                out[f"{pre}.attn.gates_w"] = src[f"{attn}.to_gates.weight"]
                out[f"{pre}.attn.gates_b"] = src[f"{attn}.to_gates.bias"]
                out[f"{pre}.attn.out_w"] = src.get(
                    f"{attn}.to_out.0.weight", src.get(f"{attn}.to_out.weight"))
                ff = f"{base}.layers.0.1.net"
                out[f"{pre}.ff.norm_gamma"] = src[f"{ff}.0.g"]
                out[f"{pre}.ff.fc1_w"] = src[f"{ff}.1.weight"]
                out[f"{pre}.ff.fc1_b"] = src[f"{ff}.1.bias"]
                out[f"{pre}.ff.fc2_w"] = src[f"{ff}.4.weight"]
                out[f"{pre}.ff.fc2_b"] = src[f"{ff}.4.bias"]
                out[f"{pre}.norm_gamma"] = src[f"{base}.norm.g"]

        # mask estimator (torch Sequential indices 0, 2, ..., final)
        hdim = cfg.mlp_hidden
        depth = cfg.mask_estimator_depth

        def key_for(i, j):
            return f"mask_estimators.0.to_freqs.{i}.0.{2 * j}"

        def mk_w0(i, buf):
            buf[i] = src[f"{key_for(i, 0)}.weight"].T
        out["mask_est.w0"] = stacked(mk_w0, (nb, cfg.dim, hdim))

        def mk_b0(i, buf):
            buf[i] = src[f"{key_for(i, 0)}.bias"]
        out["mask_est.b0"] = stacked(mk_b0, (nb, hdim))

        for j in range(depth - 1):
            def mk_wm(i, buf, j=j):
                buf[i] = src[f"{key_for(i, j + 1)}.weight"].T
            out[f"mask_est.wm{j}"] = stacked(mk_wm, (nb, hdim, hdim))

            def mk_bm(i, buf, j=j):
                buf[i] = src[f"{key_for(i, j + 1)}.bias"]
            out[f"mask_est.bm{j}"] = stacked(mk_bm, (nb, hdim))

        def mk_wf(i, buf):
            w = src[f"{key_for(i, depth)}.weight"]      # (2*bd, hidden)
            bd = lay.band_dims[i]
            buf[i, :, :bd] = w[:bd].T                    # value half
            buf[i, :, mbd: mbd + bd] = w[bd:].T          # gate half
        out["mask_est.wf"] = stacked(mk_wf, (nb, hdim, 2 * mbd))

        def mk_bf(i, buf):
            bvec = src[f"{key_for(i, depth)}.bias"]
            bd = lay.band_dims[i]
            buf[i, :bd] = bvec[:bd]
            buf[i, mbd: mbd + bd] = bvec[bd:]
        out["mask_est.bf"] = stacked(mk_bf, (nb, 2 * mbd))

        return out


MelRoFormer = Model

__all__ = ["Model", "MelRoFormer", "MelRoFormerConfig", "MelRoFormerResult",
           "BandLayout", "band_split", "mask_estimator",
           "mel_roformer_forward"]
