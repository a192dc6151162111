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

from .nn import (GRU, LSTM, BatchNorm, BiLSTM, Conv1d, Conv2d,
                 ConvTranspose1d, Embedding, FpQuantizedLinear, GroupedLinear,
                 Int8Linear, LayerNorm, Linear, LSTMCell, QuantizedLinear,
                 RMSNorm, StackedTable)

# the modules whose buffers are parameters of the JAX tree
_BUFFERED = (QuantizedLinear, Int8Linear, FpQuantizedLinear, BatchNorm)


def _tensor(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    arr = np.asarray(v)
    if arr.dtype.kind in "fV":          # f16/f32/f64 and ml_dtypes bfloat16
        arr = np.asarray(v, dtype=np.float32)
    return torch.from_numpy(np.array(arr))  # a writable copy


def check_device(device) -> torch.device:
    """`device` as a torch.device. The port's entry points default to the
    card and never fall back to the CPU: a CUDA device on a machine
    without CUDA raises here, before any parameter is built."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: CUDA is not available. The port runs "
            f"on the GPU by default; pass device=\"cpu\" to run on the CPU.")
    return dev


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
    def init_params(self, seed: int = 0,
                    on_device: bool = False) -> "TorchModel":
        """Random weights from `seed`, with the JAX package's init
        distributions (nn/layers.py, nn/recurrent.py): uniform
        +-1/sqrt(fan_in) kernels, zero biases, N(0, 0.02) embeddings, unit
        norms, batch norms at weight 1, bias 0, mean 0 and variance 1, and
        the constants a module names in `init_fill`. By default
        drawn on the CPU in f32 from one torch.Generator in module order, so
        a seed gives the same weights on every device. `on_device` draws
        each tensor on its own device in its own dtype from a generator
        there instead (a full-size model then never has an f32 copy on the
        host); the numbers then depend on the device."""
        gens: Dict[torch.device, torch.Generator] = {}

        def draw(p, kind, scale):
            dev, dtype = ((p.device, p.dtype) if on_device
                          else (torch.device("cpu"), torch.float32))
            g = gens.get(dev)
            if g is None:
                g = gens[dev] = torch.Generator(device=dev).manual_seed(seed)
            if kind == "normal":
                t = torch.randn(p.shape, generator=g, device=dev,
                                dtype=dtype) * scale
            else:
                t = torch.empty(p.shape, device=dev, dtype=dtype).uniform_(
                    -scale, scale, generator=g)
            p.copy_(t)

        for m in self.modules():
            if isinstance(m, Linear):
                draw(m.weight, "uniform", m.in_features ** -0.5)
            elif isinstance(m, Conv1d):
                draw(m.weight, "uniform",
                     (m.weight.shape[1] * m.weight.shape[2]) ** -0.5)
            elif isinstance(m, Conv2d):
                _, i_g, kh, kw = m.weight.shape
                draw(m.weight, "uniform", (i_g * kh * kw) ** -0.5)
            elif isinstance(m, ConvTranspose1d):
                i_ch, _, width = m.weight.shape
                draw(m.weight, "uniform", (i_ch // m.groups * width) ** -0.5)
            elif isinstance(m, (Embedding, StackedTable)):
                draw(m.weight, "normal", 0.02)
            elif isinstance(m, (LayerNorm, BatchNorm)):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
                if isinstance(m, BatchNorm):
                    m.running_mean.fill_(0.0)
                    m.running_var.fill_(1.0)
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
            elif isinstance(m, (BiLSTM, LSTMCell, LSTM, GRU)):
                for p in m.parameters():
                    draw(p, "uniform", m.hidden_size ** -0.5)
            elif isinstance(m, GroupedLinear):
                draw(m.weight, "uniform", m.weight.shape[1] ** -0.5)
            if isinstance(m, (Linear, Conv1d, Conv2d, ConvTranspose1d)) \
                    and m.bias is not None:
                m.bias.fill_(0.0)
            for name, value in getattr(m, "init_fill", {}).items():
                getattr(m, name).fill_(value)
        return self

    def astype(self, dtype) -> "TorchModel":
        """Cast floating-point parameters to dtype. Buffers keep theirs: a
        quantized linear's codes stay uint8 and its scales f32, a batch
        norm's running statistics f32."""
        for p in self.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)
        return self

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


_CONV1D_READS = {"torch": (2, 1, 0), "mlx": (1, 2, 0), "wio": None}


def _conv1d_layouts(w_shape, torch_shape) -> list:
    """The layouts (torch (O, I/g, K), MLX (O, K, I/g), the JAX tree's WIO
    (K, I/g, O)) whose shape for a conv1d of `torch_shape` is `w_shape`."""
    o, i, k = torch_shape
    shapes = {"torch": (o, i, k), "mlx": (o, k, i), "wio": (k, i, o)}
    return [name for name, s in shapes.items() if s == tuple(w_shape)]


def convs_to_wio(weights: Mapping[str, Any], shapes: Mapping[str, tuple],
                 is_conv) -> Dict[str, Any]:
    """`weights` with each conv1d weight (`is_conv(name, array)`, of a
    name in `shapes`, the model's own torch shapes) read into WIO from the
    layout its shape shows: torch (O, I/g, K), MLX (O, K, I/g) or WIO. A
    shape that fits more than one (O == K, say) takes the one layout the
    checkpoint's other conv weights show; a shape that fits none, or a
    checkpoint whose unambiguous convs show no single layout, raises."""
    convs = {k: _conv1d_layouts(np.shape(v), shapes[k])
             for k, v in weights.items() if k in shapes and is_conv(k, v)}
    for k, fits in convs.items():
        if not fits:
            o, i, kk = shapes[k]
            raise ValueError(
                f"{k}: shape {tuple(np.shape(weights[k]))} is none of "
                f"torch's {(o, i, kk)}, MLX's {(o, kk, i)} or WIO "
                f"{(kk, i, o)}")
    seen = {fits[0] for fits in convs.values() if len(fits) == 1}
    out = dict(weights)
    for k, fits in convs.items():
        if len(fits) > 1:
            if len(seen) != 1 or next(iter(seen)) not in fits:
                raise ValueError(
                    f"{k}: shape {tuple(np.shape(weights[k]))} fits the "
                    f"{' and '.join(fits)} layouts, and the checkpoint's "
                    f"other conv weights show {sorted(seen) or 'none'}")
            fits = list(seen)
        axes = _CONV1D_READS[fits[0]]
        if axes is not None:
            out[k] = np.transpose(np.asarray(out[k]), axes)
    return out


def conv2d_to_hwio(name: str, w: np.ndarray, torch_shape) -> np.ndarray:
    """A conv2d weight read into HWIO from the layout its shape shows:
    torch (O, I/g, kh, kw), MLX (O, kh, kw, I/g) or HWIO (kh, kw, I/g, O).
    A shape that fits more than one layout with different readings, or
    none, raises."""
    o, i, kh, kw = torch_shape
    reads = {"torch": ((o, i, kh, kw), (2, 3, 1, 0)),
             "mlx": ((o, kh, kw, i), (1, 2, 3, 0)),
             "hwio": ((kh, kw, i, o), (0, 1, 2, 3))}
    fits = {axes for shape, axes in reads.values() if shape == w.shape}
    outs = {np.transpose(w, axes).tobytes() for axes in fits}
    if len(outs) != 1:
        raise ValueError(
            f"{name}: shape {w.shape} is "
            + ("none" if not fits else "more than one")
            + f" of torch's {(o, i, kh, kw)}, MLX's {(o, kh, kw, i)} or "
            f"HWIO {(kh, kw, i, o)}")
    return np.transpose(w, next(iter(fits)))


def _unstack(model: TorchModel, flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Split the leading layer axis of the JAX tree's stacked layer leaves
    (`model.JAX_STACKED` prefixes) into per-layer names: `p.k` (L, ...) ->
    `p.0.k`, `p.1.k`, ..."""
    out = dict(flat)
    for prefix in getattr(model, "JAX_STACKED", ()):
        for key in [k for k in out if k.startswith(prefix + ".")]:
            arr = np.asarray(out.pop(key))
            rest = key[len(prefix) + 1:]
            for i in range(arr.shape[0]):
                out[f"{prefix}.{i}.{rest}"] = arr[i]
    return out


def holder(**children: nn.Module) -> nn.Module:
    """An nn.Module with `children` under their names: a node of the JAX
    tree that has parameters below it and no computation of its own."""
    m = nn.Module()
    for name, child in children.items():
        setattr(m, name, child)
    return m


def leaves(**shapes) -> nn.Module:
    """An nn.Module whose parameters are raw leaves of the JAX tree, named
    as there and shaped `shapes[name]` (uninitialised)."""
    m = nn.Module()
    for name, shape in shapes.items():
        setattr(m, name, nn.Parameter(torch.empty(shape)))
    return m


def replace_module(model: nn.Module, name: str, new: nn.Module) -> None:
    parent, _, child = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, child, new)


def swap_quantized_linears(model: nn.Module, flat: Mapping[str, Any]) -> None:
    """Replace each `Linear` of `model` whose leaf in the flat tree `flat`
    holds quantized codes by an empty module of that leaf's shapes, which a
    bind then fills: {w_q, scales, biases[, bias]} a QuantizedLinear (the
    group size from the shapes), {w_i8, scale[, bias]} (W8A8) an
    Int8Linear, {w_fp4 | w_fp8, scales[, bias]} an FpQuantizedLinear."""
    for name, m in list(model.named_modules()):
        if not isinstance(m, Linear):
            continue
        bias = m.bias is not None
        if f"{name}.w_q" in flat:
            out_f, in_f = np.shape(flat[f"{name}.w_q"])
            q = QuantizedLinear(in_f, out_f,
                                in_f // np.shape(flat[f"{name}.scales"])[1],
                                bias=bias)
        elif f"{name}.w_i8" in flat:
            q = Int8Linear(m.in_features, np.shape(flat[f"{name}.w_i8"])[0],
                           bias=bias)
        else:
            codes = next((c for c in ("w_fp4", "w_fp8")
                          if f"{name}.{c}" in flat), None)
            if codes is None:
                continue
            out_f, in_f = np.shape(flat[f"{name}.{codes}"])
            q = FpQuantizedLinear(
                in_f, out_f, in_f // np.shape(flat[f"{name}.scales"])[1],
                codes, bias=bias)
        if q.in_features != m.in_features:
            raise ValueError(f"{name}: quantized codes of {q.in_features} "
                             f"inputs for a linear of {m.in_features}")
        replace_module(model, name, q.to(m.weight.device))


def jax_params(model: TorchModel) -> Dict[str, torch.Tensor]:
    """The inverse of `load_jax_params`: the model's parameters (and the
    buffers of its quantized linears and batch norms) as the JAX package's
    flat tree, in its layouts (WIO and HWIO convs, pre-flipped transposed
    convs, LSTM `forward`/`backward` sub-trees, `JAX_STACKED` layers
    stacked again), on the model's device. What the convert CLI writes."""
    out: Dict[str, torch.Tensor] = {}
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        own = dict(m.named_parameters(recurse=False))
        if isinstance(m, BiLSTM):
            for direction, suffix in (("forward", ""), ("backward", "_reverse")):
                for leaf in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                    out[f"{pre}{direction}.{leaf}"] = own[f"{leaf}_l0{suffix}"]
            continue
        if isinstance(m, (GRU, LSTM)):
            for leaf in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                out[pre + leaf] = own[f"{leaf}_l0"]
            continue
        if isinstance(m, ConvTranspose1d):
            w = m.weight
            i_ch, o_g, width = w.shape
            g = m.groups
            own["weight"] = w.reshape(g, i_ch // g, o_g, width).permute(
                3, 1, 0, 2).reshape(width, i_ch // g, g * o_g).flip(0)
        elif isinstance(m, Conv1d):
            own["weight"] = m.weight.permute(2, 1, 0)
        elif isinstance(m, Conv2d):
            own["weight"] = m.weight.permute(2, 3, 1, 0)
        if isinstance(m, _BUFFERED):
            own.update((k, b) for k, b in m.named_buffers(recurse=False)
                       if b is not None)
        out.update((pre + k, v.detach()) for k, v in own.items()
                   if v is not None)
    for prefix in getattr(model, "JAX_STACKED", ()):
        groups: Dict[str, Dict[int, torch.Tensor]] = {}
        head = prefix + "."
        for key in [k for k in out if k.startswith(head)]:
            idx, rest = key[len(head):].split(".", 1)
            groups.setdefault(rest, {})[int(idx)] = out.pop(key)
        for rest, layers in groups.items():
            out[f"{prefix}.{rest}"] = torch.stack(
                [layers[i] for i in sorted(layers)])
    return out


def load_jax_params(model: TorchModel, flat: Mapping[str, Any]) -> TorchModel:
    """Fill `model` from the JAX package's parameter tree, given flat
    ({dotted name: numpy array}, e.g. `mlx_audio_tpu.utils.flatten(params)`).

    All layout conversion between the two packages sits here:
      * Conv1d:          WIO (k, I/g, O)          -> (O, I/g, k)
      * Conv2d:          HWIO (kh, kw, I/g, O)    -> OIHW (O, I/g, kh, kw)
      * ConvTranspose1d: pre-flipped (W, I/g, O)  -> torch (I, O/g, W)
      * BiLSTM:          {forward,backward}.{weight_ih,weight_hh,bias_ih,bias_hh}
                         -> weight_ih_l0[_reverse], ...  (gate order i,f,g,o)
      * GRU:             {weight_ih,weight_hh,bias_ih,bias_hh} -> weight_ih_l0,
                         ...  (gate order r,z,n)
      * LSTM (one layer): the same leaf names -> weight_ih_l0, ...  (gate
                         order i,f,g,o)
      * stacked layers:  leaves under `model.JAX_STACKED` prefixes lose their
                         leading L axis to per-layer modules
      * quantized:       a Linear whose JAX leaf holds quantized codes
                         becomes the module that takes them
                         (`swap_quantized_linears`)
      * buffers:         a quantized linear's codes, scales and biases and a
                         BatchNorm's running_mean/running_var are taken too
      * everything else (linear (out,in), embeddings, norms, snake alphas,
        stacked tables) is copied as is.
    Raises if a parameter is missing or a JAX leaf is left over."""
    flat = _unstack(model, flat)
    swap_quantized_linears(model, flat)
    state: Dict[str, np.ndarray] = {}
    used = set()

    def take(key: str) -> np.ndarray:
        used.add(key)
        arr = np.asarray(flat[key])
        if arr.dtype.kind in "fV":      # floats (and ml_dtypes bfloat16)
            return np.asarray(arr, dtype=np.float32)
        return arr                      # quantized codes stay (u)int8

    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, BiLSTM):
            for direction, suffix in (("forward", ""), ("backward", "_reverse")):
                for leaf in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                    state[f"{pre}{leaf}_l0{suffix}"] = take(f"{pre}{direction}.{leaf}")
        elif isinstance(m, (GRU, LSTM)):
            for leaf in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                state[f"{pre}{leaf}_l0"] = take(f"{pre}{leaf}")
        elif isinstance(m, ConvTranspose1d):
            state[pre + "weight"] = _conv_transpose_from_jax(
                take(pre + "weight"), m.groups)
            if m.bias is not None:
                state[pre + "bias"] = take(pre + "bias")
        elif isinstance(m, (Conv1d, Conv2d)):
            state[pre + "weight"] = np.transpose(
                take(pre + "weight"),
                (2, 1, 0) if isinstance(m, Conv1d) else (3, 2, 0, 1))
            if m.bias is not None:
                state[pre + "bias"] = take(pre + "bias")
        else:
            if isinstance(m, _BUFFERED):
                for bname, _ in m.named_buffers(recurse=False):
                    state[pre + bname] = take(pre + bname)
            for pname, p in m.named_parameters(recurse=False):
                state[pre + pname] = take(pre + pname).reshape(p.shape)
    left = sorted(set(flat) - used)
    if left:
        raise ValueError(f"JAX parameters with no torch counterpart: {left[:20]}")
    return model.bind(state)
