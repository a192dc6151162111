"""MegaASR's audio-quality router: a small conv + transformer classifier
over an 80-bin log-mel that says whether audio is degraded.

Counterpart of mlx_audio_tpu/stt/models/mega_asr/router.py: `log_mel80`
(:21-30) on the port's `dsp.stft`, `spec_abs` and slaney mel filters;
`load_router_params` (:33-93: the converted checkpoint's convs from MLX
(O, K, I) to the JAX tree's WIO, the fused qkv `in_proj` split, each batch
norm's running statistics folded into a scale and a shift at load);
`router_logits` (:135-167) and `AudioQualityRouter` (:170-202). The
parameters are the JAX tree's, bound by `model.load_jax_params`.

The mel is zero-padded to the JAX package's time buckets (TIME_BUCKETS x
4 frames) before the convs, as there: the second conv's last valid output
reads one frame of the first conv's output past the audio, which the
padding makes the bucket's (a tight run at the audio's own length would
read zero there and give another probability).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ....dsp import mel_filters, spec_abs, stft
from ....model import TorchModel, check_device, leaves, load_jax_params
from ....nn import Conv1d, LayerNorm, Linear, gelu
from ....ops.attention import attention

TIME_BUCKETS = (64, 128, 256, 512, 850)
N_HEADS = 4


def log_mel80(audio) -> torch.Tensor:
    """(T,) -> (frames, 80): slaney mel, log10, (x+4)/4 (router.py:13-47),
    on the audio's device (the CPU for numpy)."""
    win = np.hanning(401)[:-1].astype(np.float32)
    spec = stft(audio, n_fft=400, hop_length=160, win_length=400,
                window=win, center=True, pad_mode="reflect")
    power = spec_abs(spec) ** 2.0
    fb = mel_filters(16000, 400, 80, f_min=0.0, f_max=8000.0,
                     norm="slaney", mel_scale="slaney").to(power.device)
    mel = power @ fb.T
    return (torch.log10(torch.clamp(mel, min=1e-10)) + 4.0) / 4.0


def load_router_params(weights: Mapping[str, np.ndarray]) -> Dict[str,
                                                                  np.ndarray]:
    """A converted router.safetensors mapping -> the JAX tree, flat: conv
    weights from MLX (O, K, I) to WIO (K, I, O), the fused in_proj qkv
    split, the batch norms' running statistics folded."""
    w = {k: np.asarray(v, np.float32) for k, v in weights.items()}
    out: Dict[str, np.ndarray] = {}

    def conv(name, i):
        out[f"{name}.weight"] = w[f"frontend.conv.{i}.weight"].transpose(
            1, 2, 0)
        out[f"{name}.bias"] = w[f"frontend.conv.{i}.bias"]

    def bn(name, i, eps=1e-5):
        scale = w[f"frontend.conv.{i}.weight"] / np.sqrt(
            w[f"frontend.conv.{i}.running_var"] + eps)
        out[f"{name}.scale"] = scale
        out[f"{name}.shift"] = w[f"frontend.conv.{i}.bias"] \
            - w[f"frontend.conv.{i}.running_mean"] * scale

    conv("conv1", 0)
    bn("bn1", 1)
    conv("conv2", 4)
    bn("bn2", 5)
    out["pe"] = w["pos_encoder.pe"]
    n_layers = len({k.split(".")[2] for k in w
                    if k.startswith("transformer.layers.")})
    for i in range(n_layers):
        pre, dst = f"transformer.layers.{i}", f"layers.{i}"
        qkv_w = np.split(w[f"{pre}.self_attn.in_proj_weight"], 3, 0)
        qkv_b = np.split(w[f"{pre}.self_attn.in_proj_bias"], 3, 0)
        for n, wt, b in zip(("q_proj", "k_proj", "v_proj"), qkv_w, qkv_b):
            out[f"{dst}.self_attn.{n}.weight"] = wt
            out[f"{dst}.self_attn.{n}.bias"] = b
        for src, name in (("self_attn.out_proj", "self_attn.out_proj"),
                          ("linear1", "linear1"), ("linear2", "linear2"),
                          ("norm1", "norm1"), ("norm2", "norm2")):
            for leaf in ("weight", "bias"):
                out[f"{dst}.{name}.{leaf}"] = w[f"{pre}.{src}.{leaf}"]
    for src, name in (("transformer.norm", "norm"),
                      ("pooling.query", "pooling"), ("classifier.0", "fc1"),
                      ("classifier.3", "fc2")):
        for leaf in ("weight", "bias"):
            out[f"{name}.{leaf}"] = w[f"{src}.{leaf}"]
    return out


class _Layer(nn.Module):
    def __init__(self, d: int, ff: int):
        super().__init__()
        self.self_attn = nn.Module()
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, n, Linear(d, d))
        self.linear1 = Linear(d, ff)
        self.linear2 = Linear(ff, d)
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)


class AudioQualityRouter(TorchModel):
    """The router on `device` (the card by default), built from the JAX
    tree `params` (flat, numpy: `load_router_params`'s output or the JAX
    package's `init_router_params` flattened), whose shapes give its
    dims."""

    def __init__(self, params: Mapping[str, np.ndarray], device="cuda"):
        device = check_device(device)
        shapes = {k: np.shape(v) for k, v in params.items()}
        n_mels, hidden = shapes["conv1.weight"][1:]
        d = shapes["conv2.weight"][2]
        ff = shapes["layers.0.linear1.weight"][0]
        cls_h = shapes["fc1.weight"][0]
        n_layers = len({k.split(".")[1] for k in shapes
                        if k.startswith("layers.")})
        super().__init__({"n_mels": n_mels, "d_model": d,
                          "num_layers": n_layers})
        with torch.device(device):
            self.conv1 = Conv1d(n_mels, hidden, 3)
            self.bn1 = leaves(scale=(hidden,), shift=(hidden,))
            self.conv2 = Conv1d(hidden, d, 3)
            self.bn2 = leaves(scale=(d,), shift=(d,))
            self.pe = nn.Parameter(torch.empty(shapes["pe"]))
            self.layers = nn.ModuleList(_Layer(d, ff)
                                        for _ in range(n_layers))
            self.norm = LayerNorm(d)
            self.pooling = Linear(d, 1)
            self.fc1 = Linear(d, cls_h)
            self.fc2 = Linear(cls_h, 2)
        self.requires_grad_(False)
        self.eval()
        load_jax_params(self, params)

    @classmethod
    def from_converted(cls, weights: Mapping, device="cuda"
                       ) -> "AudioQualityRouter":
        return cls(load_router_params(weights), device=device)

    @torch.inference_mode()
    def logits(self, mel: torch.Tensor, n_valid: int) -> torch.Tensor:
        """(1, T_bucket, n_mels) mel + valid frame count -> (2,) logits
        (router_logits)."""
        x = gelu(self.conv1(mel, stride=2, padding=1) * self.bn1.scale
                 + self.bn1.shift)
        x = gelu(self.conv2(x, stride=2, padding=1) * self.bn2.scale
                 + self.bn2.shift)
        t = x.shape[1]
        x = x + self.pe[:, :t]
        valid = torch.arange(t, device=x.device) < n_valid
        amask = torch.zeros(t, device=x.device).masked_fill(
            ~valid, float("-inf"))[None, None, None, :]
        hd = x.shape[-1] // N_HEADS
        for blk in self.layers:
            h = blk.norm1(x)
            a = blk.self_attn
            q = a.q_proj(h).reshape(1, t, N_HEADS, hd)
            k = a.k_proj(h).reshape(1, t, N_HEADS, hd)
            v = a.v_proj(h).reshape(1, t, N_HEADS, hd)
            o = attention(q, k, v, mask=amask).reshape(1, t, -1)
            x = x + a.out_proj(o)
            h = blk.norm2(x)
            x = x + blk.linear2(gelu(blk.linear1(h)))
        x = self.norm(x)
        w = self.pooling(x)[..., 0].masked_fill(~valid[None], float("-inf"))
        w = torch.softmax(w, dim=-1)
        pooled = (w[..., None] * x).sum(dim=1)
        return self.fc2(gelu(self.fc1(pooled)))[0]

    def degraded_prob(self, audio) -> float:
        mel = log_mel80(torch.as_tensor(
            np.asarray(audio, np.float32).reshape(-1), device=self.device))
        max_len = self.pe.shape[1]
        n_out = min((mel.shape[0] + 3) // 4, max_len)   # two stride-2 convs
        frames = min(mel.shape[0], max_len * 4)
        b = next((x for x in TIME_BUCKETS if frames <= x * 4), max_len * 4)
        padded = torch.zeros(1, b * 4, mel.shape[1], device=self.device)
        padded[0, :frames] = mel[:frames]
        logits = self.logits(padded, n_out).double().cpu().numpy()
        e = np.exp(logits - logits.max())
        return float((e / e.sum())[1])

    def route(self, audio) -> Dict:
        p = self.degraded_prob(audio)
        return {"degraded_prob": p, "use_lora": p >= 0.5}


__all__ = ["AudioQualityRouter", "log_mel80", "load_router_params",
           "TIME_BUCKETS"]
