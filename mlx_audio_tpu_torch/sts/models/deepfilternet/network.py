"""DeepFilterNet 2/3 network.

Counterpart of mlx_audio_tpu/sts/models/deepfilternet/network.py: the
grouped linear (:20-34), inference batch norm, the GRU (`_gru_cell`
:62-83, here `nn.GRU`, cuDNN on the card) and the squeezed GRU (grouped
linear in and out around the GRU layers), the causal conv blocks (:170-
209), the depthwise conv-transpose block (:212-245), the encoder (:251-
299), the ERB decoder (:304-402) and the DF decoder (:407-455), and
`deep_filter` (:469-488).

The modules' names are the JAX tree's ("enc.erb_conv1.1.weight"), so one
flat name space serves both packages; `model.load_jax_params` converts the
HWIO conv kernels to torch's OIHW. The conv-transpose blocks' kernel is
held, as in the JAX tree, as the forward conv over the F-dilated input
(pre-flipped); here it runs as `F.conv_transpose2d` with the kernel
flipped back, which is the same product.

The JAX package's activations are (B, T, F, C); here the conv stacks run
channel-first, (B, C, T, F), the layout cuDNN takes, and the tensors are
permuted only where the JAX code flattens (F, C) into one feature axis (the
embedding and the DF coefficients), so the flattened order is JAX's.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ....nn import GRU, BatchNorm, Conv2d, GroupedLinear, Linear
from .config import DeepFilterNetConfig


def _d(**children: nn.Module) -> nn.ModuleDict:
    return nn.ModuleDict(children)


# ------------------------------------------------------------ helpers

def batch_norm(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Inference batch norm over the channels of (B, C, T, F)."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, training=False, eps=bn.eps)


def squeezed_gru(in_size: int, hidden: int, out_size: Optional[int],
                 num_layers: int, groups: int) -> nn.ModuleDict:
    m = _d(linear_in=_d(**{"0": GroupedLinear(in_size, hidden, groups)}),
           gru_layers=_d(**{str(i): GRU(hidden, hidden)
                            for i in range(num_layers)}))
    if out_size is not None:
        m["linear_out"] = _d(**{"0": GroupedLinear(hidden, out_size,
                                                   groups)})
    return m


def apply_squeezed_gru(p: nn.ModuleDict, x: torch.Tensor,
                       states: Optional[List[torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(B, T, I) -> (B, T, out), threading each GRU layer's (B, H) state."""
    x = torch.relu(p["linear_in"]["0"](x))
    new_states = []
    for i, gru in enumerate(p["gru_layers"].values()):
        x, h = gru(x, None if states is None else states[i])
        new_states.append(h)
    if "linear_out" in p:
        x = torch.relu(p["linear_out"]["0"](x))
    return x, new_states


# ---------------------------------------------------------- conv block

def conv_block(in_ch: int, out_ch: int, kernel, separable: bool
               ) -> nn.ModuleDict:
    """The JAX package's `init_conv_block` (the reference Encoder's
    Sequential indices): a grouped conv, then a 1x1 conv where the block is
    separable, then batch norm."""
    groups = math.gcd(in_ch, out_ch) if separable else 1
    sep = separable and groups > 1 and max(kernel) > 1
    m = _d(**{"1": Conv2d(in_ch, out_ch, tuple(kernel), bias=False,
                          groups=groups)})
    if sep:
        m["2"] = Conv2d(out_ch, out_ch, 1, bias=False)
        m["3"] = BatchNorm(out_ch)
    else:
        m["2"] = BatchNorm(out_ch)
    return m


def apply_conv_block(p: nn.ModuleDict, x: torch.Tensor, fstride: int = 1,
                     relu: bool = True, causal_pad: bool = True
                     ) -> torch.Tensor:
    """x (B, C, T, F); causal T pad (kt - 1 on the left, or none when
    `causal_pad` is off: the streamer's valid conv over real history),
    'same' F pad, F stride."""
    conv = p["1"]
    kt, kf = conv.weight.shape[2:]
    x = F.pad(x, (kf // 2, kf // 2, kt - 1 if causal_pad else 0, 0))
    y = F.conv2d(x, conv.weight.to(x.dtype), stride=(1, fstride),
                 groups=conv.groups)
    if "3" in p:
        y = batch_norm(p["3"], F.conv2d(y, p["2"].weight.to(y.dtype)))
    else:
        y = batch_norm(p["2"], y)
    return torch.relu(y) if relu else y


def conv_transpose_block(ch: int, kernel) -> nn.ModuleDict:
    """torch ConvTranspose2d(ch, ch, kernel, stride=(1, fstride),
    padding=(kt - 1, kf // 2), output_padding=(0, kf // 2)), depthwise,
    then a 1x1 conv and batch norm."""
    return _d(**{"0": Conv2d(ch, ch, tuple(kernel), bias=False, groups=ch),
                 "1": Conv2d(ch, ch, 1, bias=False), "2": BatchNorm(ch)})


def apply_conv_transpose_block(p: nn.ModuleDict, x: torch.Tensor,
                               fstride: int = 2) -> torch.Tensor:
    w = p["0"].weight
    kt, kf = w.shape[2:]
    y = F.conv_transpose2d(x, w.flip(2, 3).to(x.dtype), stride=(1, fstride),
                           padding=(kt - 1, kf // 2),
                           output_padding=(0, kf // 2), groups=x.shape[1])
    y = F.conv2d(y, p["1"].weight.to(y.dtype))
    return batch_norm(p["2"], y)


# -------------------------------------------------------------- encoder

def encoder(p: DeepFilterNetConfig) -> nn.ModuleDict:
    emb_in = p.conv_ch * p.nb_erb // 4
    emb_out = p.emb_hidden_dim if p.enc_concat else emb_in
    c = p.conv_ch
    return _d(
        erb_conv0=conv_block(1, c, p.conv_kernel_inp, False),
        erb_conv1=conv_block(c, c, p.conv_kernel, True),
        erb_conv2=conv_block(c, c, p.conv_kernel, True),
        erb_conv3=conv_block(c, c, p.conv_kernel, True),
        df_conv0=conv_block(2, c, p.conv_kernel_inp, True),
        df_conv1=conv_block(c, c, p.conv_kernel, True),
        df_fc_emb=_d(**{"0": GroupedLinear(c * p.nb_df // 2, emb_in,
                                           p.enc_linear_groups)}),
        emb_gru=squeezed_gru(emb_in * 2 if p.enc_concat else emb_in,
                             p.emb_hidden_dim,
                             None if p.enc_concat else emb_out, 1,
                             p.linear_groups),
        lsnr_fc=_d(**{"0": Linear(emb_out, 1)}))


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, F) -> (B, T, F * C), F major as the JAX reshape."""
    b, _, t, _ = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, t, -1)


def embed(enc: nn.ModuleDict, p: DeepFilterNetConfig, e3: torch.Tensor,
          c1: torch.Tensor, gru_states=None):
    """The embedding and lsnr from the encoder's last conv outputs."""
    cemb = torch.relu(enc["df_fc_emb"]["0"](_flat(c1)))
    emb = _flat(e3)
    emb = torch.cat([emb, cemb], -1) if p.enc_concat else emb + cemb
    emb, new_states = apply_squeezed_gru(enc["emb_gru"], emb, gru_states)
    lsnr = torch.sigmoid(enc["lsnr_fc"]["0"](emb)) \
        * (p.lsnr_max - p.lsnr_min) + p.lsnr_min
    return emb, lsnr, new_states


def encoder_forward(enc: nn.ModuleDict, p: DeepFilterNetConfig,
                    feat_erb: torch.Tensor, feat_spec: torch.Tensor,
                    gru_states=None):
    """feat_erb (B, 1, T, E), feat_spec (B, 2, T, D) -> skips, emb, c0,
    lsnr and the GRU states."""
    e0 = apply_conv_block(enc["erb_conv0"], feat_erb)
    e1 = apply_conv_block(enc["erb_conv1"], e0, fstride=2)
    e2 = apply_conv_block(enc["erb_conv2"], e1, fstride=2)
    e3 = apply_conv_block(enc["erb_conv3"], e2)
    c0 = apply_conv_block(enc["df_conv0"], feat_spec)
    c1 = apply_conv_block(enc["df_conv1"], c0, fstride=2)
    emb, lsnr, new_states = embed(enc, p, e3, c1, gru_states)
    return e0, e1, e2, e3, emb, c0, lsnr, new_states


# ---------------------------------------------------------- erb decoder

def erb_decoder(p: DeepFilterNetConfig) -> nn.ModuleDict:
    emb_in = p.emb_hidden_dim if p.enc_concat else p.conv_ch * p.nb_erb // 4
    c = p.conv_ch

    def pathway():
        return _d(**{"0": Conv2d(c, c, 1, bias=False, groups=c),
                     "1": BatchNorm(c)})

    return _d(
        emb_gru=squeezed_gru(emb_in, p.emb_hidden_dim,
                             p.conv_ch * p.nb_erb // 4,
                             max(1, p.emb_num_layers - 1), p.linear_groups),
        conv3p=pathway(), conv2p=pathway(), conv1p=pathway(),
        conv0p=pathway(),
        convt3=_d(**{"0": Conv2d(c, c, tuple(p.convt_kernel), bias=False,
                                 groups=c),
                     "1": Conv2d(c, c, 1, bias=False), "2": BatchNorm(c)}),
        convt2=conv_transpose_block(c, p.convt_kernel),
        convt1=conv_transpose_block(c, p.convt_kernel),
        conv0_out=_d(**{"0": Conv2d(c, 1, tuple(p.convt_kernel), bias=False),
                        "1": BatchNorm(1)}))


def _pathway(lp: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x, lp["0"].weight.to(x.dtype), groups=x.shape[1])
    return torch.relu(batch_norm(lp["1"], y))


def _causal_conv(w: torch.Tensor, x: torch.Tensor, groups: int = 1):
    kt, kf = w.shape[2:]
    x = F.pad(x, (kf // 2, kf // 2, kt - 1, 0))
    return F.conv2d(x, w.to(x.dtype), groups=groups)


def erb_decoder_forward(dec: nn.ModuleDict, p: DeepFilterNetConfig,
                        emb: torch.Tensor, e3: torch.Tensor,
                        e2: torch.Tensor, e1: torch.Tensor,
                        e0: torch.Tensor, gru_states=None):
    """-> the ERB mask (B, T, E) and the GRU states."""
    b, t = emb.shape[:2]
    f8 = e3.shape[3]
    emb, new_states = apply_squeezed_gru(dec["emb_gru"], emb, gru_states)
    emb = emb.reshape(b, t, f8, -1).permute(0, 3, 1, 2)

    d3 = _pathway(dec["conv3p"], e3) + emb
    ct = dec["convt3"]
    d3 = _causal_conv(ct["0"].weight, d3, groups=d3.shape[1])
    d3 = torch.relu(batch_norm(ct["2"], F.conv2d(d3, ct["1"].weight.to(
        d3.dtype))))
    d2 = _pathway(dec["conv2p"], e2) + d3
    d2 = torch.relu(apply_conv_transpose_block(dec["convt2"], d2))
    d1 = _pathway(dec["conv1p"], e1) + d2
    d1 = torch.relu(apply_conv_transpose_block(dec["convt1"], d1))
    d0 = _pathway(dec["conv0p"], e0) + d1
    out = dec["conv0_out"]
    m = torch.sigmoid(batch_norm(out["1"], _causal_conv(out["0"].weight,
                                                        d0)))
    return m[:, 0], new_states


# ----------------------------------------------------------- df decoder

def df_decoder(p: DeepFilterNetConfig) -> nn.ModuleDict:
    emb_in = p.emb_hidden_dim if p.enc_concat else p.conv_ch * p.nb_erb // 4
    out_ch = p.df_order * 2
    d = _d(
        df_convp=_d(**{"1": Conv2d(p.conv_ch, out_ch,
                                   (p.df_pathway_kernel_size_t, 1),
                                   bias=False,
                                   groups=math.gcd(p.conv_ch, out_ch)),
                       "2": Conv2d(out_ch, out_ch, 1, bias=False),
                       "3": BatchNorm(out_ch)}),
        df_gru=squeezed_gru(emb_in, p.df_hidden_dim, None, p.df_num_layers,
                            8),
        df_out=_d(**{"0": GroupedLinear(p.df_hidden_dim, p.nb_df * out_ch,
                                        p.linear_groups)}),
        df_fc_a=_d(**{"0": Linear(p.df_hidden_dim, 1)}))
    if p.df_gru_skip == "groupedlinear":
        d["df_skip"] = GroupedLinear(emb_in, p.df_hidden_dim,
                                     p.linear_groups)
    return d


def df_coefs(dec: nn.ModuleDict, p: DeepFilterNetConfig, emb: torch.Tensor,
             c0: torch.Tensor, gru_states=None, causal_pad: bool = True):
    """emb (B, T, H), c0 (B, C, T', D) with T' = T (offline) or T plus the
    pathway's history (the streamer, `causal_pad` off) -> DF coefficients
    (B, T, D, order * 2) and the GRU states."""
    b, t = emb.shape[:2]
    c, new_states = apply_squeezed_gru(dec["df_gru"], emb, gru_states)
    if "df_skip" in dec:
        c = c + dec["df_skip"](emb)
    cp = dec["df_convp"]
    w = cp["1"].weight
    kt = w.shape[2]
    if causal_pad:
        c0 = F.pad(c0, (0, 0, kt - 1, 0))
    y = F.conv2d(c0, w.to(c0.dtype), groups=cp["1"].groups)
    y = F.conv2d(y, cp["2"].weight.to(y.dtype))
    c0p = torch.relu(batch_norm(cp["3"], y)).permute(0, 2, 3, 1)
    c_out = torch.tanh(dec["df_out"]["0"](c))
    return c_out.reshape(b, t, p.nb_df, p.df_order * 2) + c0p, new_states


# ---------------------------------------------------------------- DfNet

def deep_filter(spec: torch.Tensor, coefs: torch.Tensor, nb_df: int,
                df_order: int, history: int = 0) -> torch.Tensor:
    """spec complex (B, history + T, F) (the first `history` frames real
    past, else zeros are padded in); coefs (B, T, D, order * 2) -> the
    first nb_df bins filtered, complex (B, T, nb_df):
    y[t] = sum_k spec[t - (order - 1) + k] * coef[t, k]."""
    b, t = coefs.shape[:2]
    low = spec[:, :, :nb_df]
    if history == 0:
        low = F.pad(low, (0, 0, df_order - 1, 0))
    win = low.unfold(1, df_order, 1)[:, -t:]             # (B, T, D, order)
    co = torch.view_as_complex(coefs.float().reshape(
        b, t, nb_df, df_order, 2).contiguous())
    return (win * co).sum(-1)


def dfnet_forward(model, p: DeepFilterNetConfig, spec: torch.Tensor,
                  feat_erb: torch.Tensor, feat_spec: torch.Tensor):
    """spec complex (B, T, F); feat_erb (B, T, E); feat_spec complex
    (B, T, D) -> the enhanced spectrum, complex (B, T, F)."""
    e0, e1, e2, e3, emb, c0, _, _ = encoder_forward(
        model.enc, p, feat_erb[:, None],
        torch.view_as_real(feat_spec).permute(0, 3, 1, 2))
    m, _ = erb_decoder_forward(model.erb_dec, p, emb, e3, e2, e1, e0)
    spec_m = spec * (m @ model.mask.erb_inv_fb.to(m.dtype))
    coefs, _ = df_coefs(model.df_dec, p, emb, c0)
    if p.enc_concat:        # DeepFilterNet2: filter the masked spectrum
        low = deep_filter(spec_m, coefs, p.nb_df, p.df_order)
    else:                   # DeepFilterNet3: filter the noisy spectrum
        low = deep_filter(spec, coefs, p.nb_df, p.df_order)
    return torch.cat([low, spec_m[:, :, p.nb_df:]], dim=2)
