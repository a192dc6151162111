"""DACVAE: the continuous-latent VAE audio codec under SAM-Audio (and
irodori_tts).

Counterpart of mlx_audio_tpu/codec/models/dacvae/dacvae.py: `ModelConfig`
(:38; hop = the product of `encoder_rates`), the f32 `snake` (:57, x + 1 /
(alpha + 1e-9) sin^2(alpha x) in f32, cast back), the residual unit
(`_res_unit` :64), `dacvae_encode` (:132: conv_in, the encoder blocks,
snake, conv_out, and the mean half of `quantizer_in_proj`), `dacvae_decode`
(:151: `quantizer_out_proj`, conv_in, each block's snake, transposed conv
of padding (stride + 1) // 2 and three residual units, snake, conv_out,
tanh), `Model.encode` (:207, padded to the hop) and `Model.decode` (:218;
the chunked path drops `4 * hop` samples of overlap at each seam) and
`sanitize` (:248-290). On channel-last (B, T, C) tensors; parameter names
are the JAX tree's, so `model.load_jax_params` binds that tree (and undoes
its pre-flipped transposed kernels). The convs are cuDNN's: the JAX DACVAE
calls no kernel of the repository (its snake has no AdaIN and no mask, so
it is not K1).

Departures from the JAX package, in `sanitize`:
* each conv's layout is read from its shape against this model's own:
  torch (O, I, K) or MLX (O, K, I) for a conv, torch (I, O, K) or MLX
  (O, K, I) for a transposed one, or the JAX tree's WIO (pre-flipped for a
  transposed conv); a shape that fits more than one takes the layout the
  checkpoint's other convs show. JAX's takes every conv for MLX's (O, K,
  I) and so misreads a torch checkpoint;
* the weight-norm fold keeps the axis that is torch's dim 0 in the layout
  read (JAX's: axis 0, or 2 for `block_1`, right for MLX's layouts only);
* every key is converted on its own: JAX's returns the whole tree
  untouched when any key looks converted (an `encoder.blocks.*snake_alpha`
  name), so a checkpoint that mixes the two forms passes unconverted;
* snake alphas are flattened to (C,): JAX's keeps a checkpoint's (1, C, 1)
  and then broadcasts it against (B, T, C) in the encoder's block snakes
  and the decoder's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device
from ....nn import Conv1d, ConvTranspose1d

DROP_PREFIXES = ("decoder.wm_model.",)
DROP_INNER = (".block_2.", ".block_3.", ".block_6.", ".block_7.",
              ".block_10.", ".block_11.")
# the checkpoint's names -> the JAX tree's (dacvae.py:261-266)
RENAMES = ((".alpha", "_alpha"), (".snake.", ".snake_"),
           (".snake_out.", ".snake_out_"), (".block_0.", ".block_0_"),
           (".act1.", ".act1_"), (".act2.", ".act2_"))


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "dacvae"
    encoder_dim: int = 64
    encoder_rates: List[int] = field(default_factory=lambda: [2, 8, 10, 12])
    latent_dim: int = 1024
    decoder_dim: int = 1536
    decoder_rates: List[int] = field(default_factory=lambda: [12, 10, 8, 2])
    codebook_dim: int = 128
    sample_rate: int = 48000
    mean: float = 0.0
    std: float = 1.0

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.encoder_rates))


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x + 1 / (alpha + 1e-9) sin^2(alpha x), computed in f32 and cast back
    to x's dtype; alpha (C,)."""
    x32, a32 = x.float(), alpha.float().reshape(-1)
    return (x32 + (1.0 / (a32 + 1e-9)) * torch.sin(a32 * x32) ** 2
            ).to(x.dtype)


class ResUnit(nn.Module):
    """{act1_alpha, conv1 (k = 7, dilated), act2_alpha, conv2 (1x1)}."""

    init_fill = {"act1_alpha": 1.0, "act2_alpha": 1.0}

    def __init__(self, dim: int, kernel: int = 7):
        super().__init__()
        self.act1_alpha = nn.Parameter(torch.ones(dim))
        self.conv1 = Conv1d(dim, dim, kernel)
        self.act2_alpha = nn.Parameter(torch.ones(dim))
        self.conv2 = Conv1d(dim, dim, 1)

    def forward(self, x: torch.Tensor, dilation: int) -> torch.Tensor:
        k = self.conv1.weight.shape[-1]
        y = self.conv1(snake(x, self.act1_alpha),
                       padding=(k - 1) * dilation // 2, dilation=dilation)
        return x + self.conv2(snake(y, self.act2_alpha))


class EncoderBlock(nn.Module):
    init_fill = {"snake_alpha": 1.0}

    def __init__(self, dim: int, stride: int):
        super().__init__()
        half = dim // 2
        self.res1, self.res2, self.res3 = (ResUnit(half) for _ in range(3))
        self.snake_alpha = nn.Parameter(torch.ones(half))
        self.conv = Conv1d(half, dim, 2 * stride)


class DecoderBlock(nn.Module):
    init_fill = {"block_0_alpha": 1.0}

    def __init__(self, in_dim: int, out_dim: int, stride: int):
        super().__init__()
        self.block_0_alpha = nn.Parameter(torch.ones(in_dim))
        self.block_1 = ConvTranspose1d(in_dim, out_dim, 2 * stride)
        self.block_4, self.block_5, self.block_8 = (
            ResUnit(out_dim) for _ in range(3))


class Encoder(nn.Module):
    init_fill = {"snake_out_alpha": 1.0}

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.conv_in = Conv1d(1, cfg.encoder_dim, 7)
        blocks, dim = {}, cfg.encoder_dim
        for i, stride in enumerate(cfg.encoder_rates):
            dim *= 2
            blocks[str(i)] = EncoderBlock(dim, stride)
        self.blocks = nn.ModuleDict(blocks)
        self.snake_out_alpha = nn.Parameter(torch.ones(dim))
        self.conv_out = Conv1d(dim, cfg.latent_dim, 3)


class Decoder(nn.Module):
    init_fill = {"snake_out_alpha": 1.0}

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        ch = cfg.decoder_dim
        self.conv_in = Conv1d(cfg.latent_dim, ch, 7)
        self.blocks = nn.ModuleDict({
            str(i): DecoderBlock(ch // 2 ** i, ch // 2 ** (i + 1), stride)
            for i, stride in enumerate(cfg.decoder_rates)})
        final = ch // 2 ** len(cfg.decoder_rates)
        self.snake_out_alpha = nn.Parameter(torch.ones(final))
        self.conv_out = Conv1d(final, 1, 7)


def dacvae_encode(m: "Model", wav: torch.Tensor) -> torch.Tensor:
    """(B, T, 1) -> (B, codebook_dim, frames) VAE means (T a multiple of
    the hop)."""
    cfg, enc = m.config, m.encoder
    x = enc.conv_in(wav, padding=3)
    for i, stride in enumerate(cfg.encoder_rates):
        b = enc.blocks[str(i)]
        x = b.res3(b.res2(b.res1(x, 1), 3), 9)
        x = b.conv(snake(x, b.snake_alpha), stride=stride,
                   padding=math.ceil(stride / 2))
    z = enc.conv_out(snake(x, enc.snake_out_alpha), padding=1)
    mean = m.quantizer_in_proj(z)[..., :cfg.codebook_dim]
    return mean.transpose(1, 2)


def dacvae_decode(m: "Model", frames: torch.Tensor) -> torch.Tensor:
    """(B, frames, codebook_dim) -> (B, frames * hop, 1) in [-1, 1]."""
    cfg, dec = m.config, m.decoder
    x = dec.conv_in(m.quantizer_out_proj(frames), padding=3)
    for i, stride in enumerate(cfg.decoder_rates):
        b = dec.blocks[str(i)]
        x = b.block_1(snake(x, b.block_0_alpha), stride=stride,
                      padding=(stride + 1) // 2)
        x = b.block_8(b.block_5(b.block_4(x, 1), 3), 9)
    return torch.tanh(dec.conv_out(snake(x, dec.snake_out_alpha), padding=3))


# -- checkpoint layouts ------------------------------------------------------

def _layouts(shape, torch_shape, transposed: bool) -> Dict[str, tuple]:
    """{layout: (its shape, the axis torch's dim 0 sits on)} for a conv
    weight of `torch_shape` (torch (O, I, K), or (I, O, K) when
    `transposed`): torch's, MLX's (O, K, I) and the JAX tree's WIO (K, I,
    O), those whose shape is `shape`."""
    if transposed:
        i, o, k = torch_shape
        cands = {"torch": ((i, o, k), 0), "mlx": ((o, k, i), 2),
                 "wio": ((k, i, o), 1)}
    else:
        o, i, k = torch_shape
        cands = {"torch": ((o, i, k), 0), "mlx": ((o, k, i), 0),
                 "wio": ((k, i, o), 2)}
    return {name: c for name, c in cands.items() if c[0] == tuple(shape)}


def _to_jax(w: np.ndarray, layout: str, transposed: bool) -> np.ndarray:
    """A conv weight in `layout` -> the JAX tree's WIO (pre-flipped for a
    transposed conv)."""
    if layout == "wio":
        return w
    if not transposed:
        return np.transpose(w, (2, 1, 0) if layout == "torch" else (1, 2, 0))
    w = np.transpose(w, (2, 0, 1) if layout == "torch" else (1, 2, 0))
    return np.ascontiguousarray(np.flip(w, axis=0))


class Model(TorchModel):
    """The DACVAE codec on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = ModelConfig.from_dict(kwargs) if kwargs else ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        c = config
        with torch.device(device):
            self.encoder = Encoder(c)
            self.quantizer_in_proj = Conv1d(c.latent_dim, 2 * c.codebook_dim, 1)
            self.quantizer_out_proj = Conv1d(c.codebook_dim, c.latent_dim, 1)
            self.decoder = Decoder(c)
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def hop_length(self) -> int:
        return self.config.hop_length

    def _dtype(self) -> torch.dtype:
        return self.encoder.conv_in.weight.dtype

    @torch.no_grad()
    def encode(self, waveform) -> torch.Tensor:
        """(B, T, 1) or (T,) audio -> (B, codebook_dim, frames), T padded
        with zeros to a multiple of the hop."""
        wav = torch.as_tensor(waveform, device=self.device).float()
        if wav.ndim == 1:
            wav = wav[None, :, None]
        pad = (-wav.shape[1]) % self.hop_length
        if pad:
            wav = torch.nn.functional.pad(wav, (0, 0, 0, pad))
        return dacvae_encode(self, wav.to(self._dtype()))

    @torch.no_grad()
    def decode(self, encoded_frames,
               chunk_size: Optional[int] = None) -> torch.Tensor:
        """(B, codebook_dim, frames) -> (B, frames * hop, 1). With
        `chunk_size`, chunks of that many frames overlapping by 4, the
        first 4 * hop samples of each chunk after the first dropped."""
        f = torch.as_tensor(encoded_frames, device=self.device).float()
        f = f.transpose(1, 2).to(self._dtype())
        if chunk_size is None:
            return dacvae_decode(self, f)
        overlap, hop, total = 4, self.hop_length, f.shape[1]
        outs, start = [], 0
        while start < total:
            end = min(start + chunk_size, total)
            out = dacvae_decode(self, f[:, start:end])
            outs.append(out[:, overlap * hop:] if start > 0 else out)
            if end >= total:
                break
            start = end - overlap
        return torch.cat(outs, dim=1)

    # -- loading -----------------------------------------------------------

    def sanitize(self, weights: Dict) -> Dict:
        """A DACVAE checkpoint -> the JAX tree (`load_jax_params`'s input):
        the watermark branch and decoder blocks 2, 3, 6, 7, 10 and 11
        dropped, names mapped, weight-norm pairs folded, each conv read from
        the layout its shape shows into WIO (transposed ones pre-flipped),
        alphas flattened. See the module's departures."""
        own = {n: (tuple(p.shape), isinstance(
            self.get_submodule(n.rsplit(".", 1)[0]), ConvTranspose1d))
            for n, p in self.named_parameters() if n.endswith(".weight")
            and p.ndim == 3}
        out, pairs = {}, {}
        for k, v in weights.items():
            if k.startswith(DROP_PREFIXES) or any(d in k for d in DROP_INNER):
                continue
            for a, b in RENAMES:
                k = k.replace(a, b)
            for suffix in (".weight_g", ".weight_v"):
                if k.endswith(suffix):
                    pairs.setdefault(k[:-len(suffix)], {})[suffix] = v
                    break
            else:
                out[k] = np.asarray(v)
        convs = {}
        for base, pair in pairs.items():
            if ".weight_v" not in pair:
                raise ValueError(f"{base}: weight_g without weight_v")
            convs[base + ".weight"] = np.asarray(pair[".weight_v"],
                                                 np.float32)
        convs.update({k: v for k, v in out.items() if k in own})
        fits = {k: _layouts(v.shape, *own[k]) for k, v in convs.items()
                if k in own}
        for k, f in fits.items():
            if not f:
                raise ValueError(f"{k}: shape {convs[k].shape} fits no "
                                 f"layout of this model's {own[k][0]}")
        seen = {next(iter(f)) for f in fits.values() if len(f) == 1}
        for k, v in convs.items():
            if k not in own:
                out[k] = v
                continue
            f = fits[k]
            if len(f) > 1:
                common = seen & set(f)
                if len(seen) != 1 or not common:
                    raise ValueError(
                        f"{k}: shape {v.shape} fits the {' and '.join(f)} "
                        f"layouts, and the checkpoint's other convs show "
                        f"{sorted(seen) or 'none'}")
                f = {name: f[name] for name in common}
            layout, (_, keep) = next(iter(f.items()))
            g = pairs.get(k[:-len(".weight")], {}).get(".weight_g")
            if g is not None:       # w = g v / ||v||, torch's dim 0 kept
                axes = tuple(i for i in range(3) if i != keep)
                norm = np.sqrt((v * v).sum(axis=axes, keepdims=True))
                g = np.asarray(g, np.float32).reshape(
                    [-1 if i == keep else 1 for i in range(3)])
                v = g * v / np.maximum(norm, 1e-12)
            out[k] = _to_jax(v, layout, own[k][1])
        for k in [k for k in out if k.endswith("_alpha")]:
            out[k] = np.asarray(out[k]).reshape(-1)
        return out


DACVAE = Model

__all__ = ["Model", "DACVAE", "ModelConfig", "dacvae_encode",
           "dacvae_decode", "snake"]
