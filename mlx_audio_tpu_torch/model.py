"""Model base class and the JAX -> torch parameter bridge.

Counterpart of mlx_audio_tpu/model.py (`FunctionalModel`). There a model is
a config, pure apply functions and a params pytree; here it is an
`nn.Module` whose parameter names follow the JAX tree's dotted paths
(`decoder.generator.resblocks.0.convs1.0.weight`), so one flat name space
serves both packages. The exceptions are the LSTMs, which keep torch's
`weight_ih_l0[_reverse]` names (the published checkpoint's) in place of the
JAX tree's `forward`/`backward` sub-trees.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from .nn import BiLSTM, Conv1d, ConvTranspose1d, Embedding, LayerNorm, Linear


def _tensor(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    arr = np.asarray(v)
    if arr.dtype.kind in "fV":          # f16/f32/f64 and ml_dtypes bfloat16
        arr = np.asarray(v, dtype=np.float32)
    return torch.from_numpy(np.array(arr))  # a writable copy


class TorchModel(nn.Module):
    """Base for model families: a config plus parameters in nn.Modules."""

    def __init__(self, config):
        super().__init__()
        self.config = config

    def bind(self, state: Mapping[str, Any]) -> "TorchModel":
        """Copy a flat {name: array} of torch-layout weights into the
        parameters, name for name; every parameter must be present, and no
        name may be left over."""
        self.load_state_dict({k: _tensor(v) for k, v in state.items()},
                             strict=True)
        return self

    @torch.no_grad()
    def init_params(self, seed: int = 0) -> "TorchModel":
        """Random weights from `seed`, with the JAX package's init
        distributions (nn/layers.py, nn/recurrent.py): uniform
        +-1/sqrt(fan_in) kernels, zero biases, N(0, 0.02) embeddings, unit
        norms. Drawn on the CPU from one torch.Generator in module order, so
        a seed gives the same weights on every device."""
        g = torch.Generator().manual_seed(seed)

        def uniform(p, bound):
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))

        for m in self.modules():
            if isinstance(m, Linear):
                uniform(m.weight, m.in_features ** -0.5)
            elif isinstance(m, Conv1d):
                uniform(m.weight, (m.weight.shape[1] * m.weight.shape[2]) ** -0.5)
            elif isinstance(m, ConvTranspose1d):
                i_ch, _, width = m.weight.shape
                uniform(m.weight, (i_ch // m.groups * width) ** -0.5)
            elif isinstance(m, Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.02)
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
            elif isinstance(m, BiLSTM):
                for p in m.parameters():
                    uniform(p, m.hidden_size ** -0.5)
            if isinstance(m, (Linear, Conv1d, ConvTranspose1d)) and m.bias is not None:
                m.bias.fill_(0.0)
        return self

    def astype(self, dtype) -> "TorchModel":
        """Cast floating-point parameters to dtype."""
        return self.to(dtype)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def _conv_transpose_from_jax(w: np.ndarray, groups: int) -> np.ndarray:
    """Inverse of mlx_audio_tpu.nn.layers.convert_torch_conv_transpose_weight:
    the pre-flipped forward kernel (W, I/g, O) -> torch (I, O/g, W)."""
    width, i_g, o = w.shape
    w = np.flip(w, axis=0).reshape(width, i_g, groups, o // groups)
    return np.transpose(w, (2, 1, 3, 0)).reshape(groups * i_g, o // groups, width)


def load_jax_params(model: TorchModel, flat: Mapping[str, Any]) -> TorchModel:
    """Fill `model` from the JAX package's parameter tree, given flat
    ({dotted name: numpy array}, e.g. `mlx_audio_tpu.utils.flatten(params)`).

    All layout conversion between the two packages sits here:
      * Conv1d:          WIO (k, I/g, O)          -> (O, I/g, k)
      * ConvTranspose1d: pre-flipped (W, I/g, O)  -> torch (I, O/g, W)
      * BiLSTM:          {forward,backward}.{weight_ih,weight_hh,bias_ih,bias_hh}
                         -> weight_ih_l0[_reverse], ...  (gate order i,f,g,o)
      * everything else (linear (out,in), embeddings, norms, snake alphas)
        is copied as is.
    Raises if a parameter is missing or a JAX leaf is left over."""
    state: Dict[str, np.ndarray] = {}
    used = set()

    def take(key: str) -> np.ndarray:
        used.add(key)
        return np.asarray(flat[key], dtype=np.float32)

    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, BiLSTM):
            for direction, suffix in (("forward", ""), ("backward", "_reverse")):
                for leaf in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                    state[f"{pre}{leaf}_l0{suffix}"] = take(f"{pre}{direction}.{leaf}")
        elif isinstance(m, ConvTranspose1d):
            state[pre + "weight"] = _conv_transpose_from_jax(
                take(pre + "weight"), m.groups)
            if m.bias is not None:
                state[pre + "bias"] = take(pre + "bias")
        elif isinstance(m, Conv1d):
            state[pre + "weight"] = np.transpose(take(pre + "weight"), (2, 1, 0))
            if m.bias is not None:
                state[pre + "bias"] = take(pre + "bias")
        else:
            for pname, p in m.named_parameters(recurse=False):
                state[pre + pname] = take(pre + pname).reshape(p.shape)
    left = sorted(set(flat) - used)
    if left:
        raise ValueError(f"JAX parameters with no torch counterpart: {left[:20]}")
    return model.bind(state)
