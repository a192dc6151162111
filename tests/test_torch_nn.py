"""Parity of the PyTorch port's layers, ops and DSP helpers with the JAX
package, on the CPU at float32.

Inputs and JAX parameters come from fixed seeds; the JAX parameters reach
the torch modules through the port's bridge (`model.load_jax_params`), so
every case also checks a layout conversion.

Tolerance: both sides compute in f32 and differ only in summation order;
the values here are O(1), so ATOL = 2e-4 (the repo's torch-parity
precedent, tests/test_torch_parity.py:19) with RTOL = 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ATOL = 2e-4
RTOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want):
    np.testing.assert_allclose(_np(got) if isinstance(got, torch.Tensor)
                               else np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _port(module_name: str, module, jax_params: dict):
    """Wrap `module` as attribute `module_name` of a model and fill it from
    the JAX params through the bridge."""
    from mlx_audio_tpu.utils import flatten
    from mlx_audio_tpu_torch.model import TorchModel, load_jax_params

    holder = TorchModel(config=None)
    holder.add_module(module_name, module.requires_grad_(False))
    flat = {k: np.asarray(v) for k, v in
            flatten({module_name: jax_params}).items()}
    load_jax_params(holder, flat)
    return module


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# linear / embedding / layer norm / leaky relu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["linear", "embedding", "layer_norm",
                                "layer_norm_no_affine", "leaky_relu"])
def test_dense_ops(op):
    from mlx_audio_tpu import nn as jnn
    from mlx_audio_tpu_torch import nn as tnn

    key = jax.random.PRNGKey(0)
    x = _x((2, 5, 12))
    if op == "linear":
        p = jnn.init_linear(key, 12, 7)
        p["bias"] = jnp.asarray(_x((7,), 1))
        want = jnn.apply_linear(p, jnp.asarray(x))
        got = _port("fc", tnn.Linear(12, 7), p)(torch.from_numpy(x))
    elif op == "embedding":
        ids = np.random.RandomState(2).randint(0, 30, (2, 9))
        p = jnn.init_embedding(key, 30, 8)
        want = jnn.apply_embedding(p, jnp.asarray(ids))
        got = _port("emb", tnn.Embedding(30, 8), p)(torch.from_numpy(ids))
    elif op == "layer_norm":
        p = {"weight": jnp.asarray(_x((12,), 3)), "bias": jnp.asarray(_x((12,), 4))}
        want = jnn.apply_layer_norm(p, jnp.asarray(x), eps=1e-12)
        got = _port("ln", tnn.LayerNorm(12, eps=1e-12), p)(torch.from_numpy(x))
    elif op == "layer_norm_no_affine":
        want = jnn.apply_layer_norm(None, jnp.asarray(x))
        got = tnn.layer_norm(torch.from_numpy(x))
    else:
        want = jnn.leaky_relu(jnp.asarray(x), 0.2)
        got = tnn.leaky_relu(torch.from_numpy(x), 0.2)
    _close(got, want)


# ---------------------------------------------------------------------------
# conv1d / conv_transpose1d
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride,padding,dilation,groups", [
    (1, 1, 1, 1),          # 'same' k=3
    (2, 1, 1, 1),          # F0_conv / N_conv: stride 2
    (1, 3, 3, 1),          # dilated
    (1, (2, 0), 1, 1),     # asymmetric padding
    (5, 3, 1, 1),          # noise_convs: stride_f0 with (s+1)//2 padding
    (1, 1, 1, 2),          # grouped
])
def test_conv1d(stride, padding, dilation, groups):
    from mlx_audio_tpu import nn as jnn
    from mlx_audio_tpu_torch import nn as tnn

    cin, cout, k = 8, 6, 3 if stride != 5 else 10
    p = jnn.init_conv1d(jax.random.PRNGKey(1), cin, cout, k, groups=groups)
    p["bias"] = jnp.asarray(_x((cout,), 5))
    x = _x((2, 41, cin))
    want = jnn.apply_conv1d(p, jnp.asarray(x), stride=stride, padding=padding,
                            dilation=dilation, groups=groups)
    conv = _port("conv", tnn.Conv1d(cin, cout, k, groups=groups), p)
    got = conv(torch.from_numpy(x), stride=stride, padding=padding,
               dilation=dilation)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("cin,cout,k,stride,padding,groups", [
    (6, 4, 3, 2, 1, 1),      # stride 2
    (6, 6, 3, 2, 1, 6),      # depthwise: AdainResBlk1d `pool`
    (8, 4, 20, 10, 5, 1),    # generator ups, stage 0 of the published config
    (8, 4, 12, 6, 3, 1),     # generator ups, stage 1
])
def test_conv_transpose1d(cin, cout, k, stride, padding, groups):
    from mlx_audio_tpu import nn as jnn
    from mlx_audio_tpu_torch import nn as tnn

    p = jnn.init_conv_transpose1d(jax.random.PRNGKey(2), cin, cout, k,
                                  groups=groups)
    p["bias"] = jnp.asarray(_x((cout,), 6))
    x = _x((2, 13, cin))
    want = jnn.apply_conv_transpose1d(p, jnp.asarray(x), stride=stride,
                                      padding=padding, groups=groups)
    tconv = _port("up", tnn.ConvTranspose1d(cin, cout, k, groups=groups), p)
    got = tconv(torch.from_numpy(x), stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    _close(got, want)


# ---------------------------------------------------------------------------
# masked bidirectional LSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lengths", [None, (11, 6), (3, 11)])
def test_bidirectional_lstm(lengths):
    """Valid steps match JAX's masked scan. Padded steps differ by design
    (JAX carries h through them, packing emits zeros); masking them, as
    every caller does, makes the two equal."""
    from mlx_audio_tpu import nn as jnn
    from mlx_audio_tpu_torch import nn as tnn

    ks = jax.random.split(jax.random.PRNGKey(3), 2)
    p = {"forward": jnn.init_lstm(ks[0], 10, 7),
         "backward": jnn.init_lstm(ks[1], 10, 7)}
    x = _x((2, 11, 10))
    mask = None
    if lengths is not None:
        mask = np.arange(11)[None, :] < np.asarray(lengths)[:, None]
    want = np.asarray(jnn.apply_lstm(p, jnp.asarray(x), bidirectional=True,
                                     mask=None if mask is None
                                     else jnp.asarray(mask)))
    lstm = _port("lstm", tnn.BiLSTM(10, 7), p)
    got = _np(lstm(torch.from_numpy(x),
                   None if mask is None else torch.from_numpy(mask)))
    assert got.shape == want.shape
    if mask is None:
        _close(got, want)
        return
    for b, n in enumerate(lengths):
        _close(got[b, :n], want[b, :n])
    m = mask[..., None]
    _close(np.where(m, got, 0.0), np.where(m, want, 0.0))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_attention(masked):
    from mlx_audio_tpu.ops.attention import attention as jattention
    from mlx_audio_tpu_torch.ops.attention import attention

    q, k, v = (_x((2, 9, 3, 8), s) for s in (7, 8, 9))
    mask = None
    if masked:
        valid = (np.arange(9)[None, :] < np.asarray([9, 5])[:, None])
        mask = ((1.0 - valid[:, None, None, :].astype(np.float32))
                * -10000.0).astype(np.float32)
    want = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      mask=None if mask is None else jnp.asarray(mask))
    got = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v),
                    mask=None if mask is None else torch.from_numpy(mask))
    _close(got, want)


# ---------------------------------------------------------------------------
# interpolate1d
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,mode,scale,size", [
    (7, "nearest", 300.0, None),       # f0 curve -> audio rate (published)
    (7, "nearest", 48.0, None),        # f0 curve -> audio rate (tiny config)
    (2100, "linear", 1.0 / 300, None),  # NSF rad downsample, istftnet.py:348
    (2101, "linear", 1.0 / 300, None),  # ... with a ragged length
    (672, "linear", 1.0 / 48, None),
    (7, "linear", 300.0, None),         # phase re-upsample
    (10, "linear", None, 23),
])
def test_interpolate1d(t, mode, scale, size):
    from mlx_audio_tpu.ops.interpolate import interpolate1d as jinterp
    from mlx_audio_tpu_torch.ops.interpolate import interpolate1d

    x = _x((2, t, 3), 10)
    want = jinterp(jnp.asarray(x), scale_factor=scale, size=size, mode=mode)
    got = interpolate1d(torch.from_numpy(x), scale_factor=scale, size=size,
                        mode=mode)
    assert tuple(got.shape) == want.shape
    _close(got, want)


# ---------------------------------------------------------------------------
# DSP helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    "stft_frames_rdft", "irfft_pair_20", "irfft_pair_12", "irfft_pair_fft",
    "overlap_add_20_5", "overlap_add_12_3", "overlap_add_12_5",
    "window_envelope", "windows"])
def test_dsp(case):
    from mlx_audio_tpu import dsp as jd
    from mlx_audio_tpu_torch import dsp as td

    rng = np.random.RandomState(11)
    if case == "stft_frames_rdft":
        x = rng.randn(2, 97).astype(np.float32)
        w = jd._window_np("hann", 20, False)
        jf = jd.frame_signal(jd._pad_center(jnp.asarray(x), 10, "reflect"), 20, 5)
        tf = td.frame_signal(td._pad_center(torch.from_numpy(x), 10, "reflect"),
                             20, 5)
        _close(tf, jf)
        jre, jim = jd.rdft_pair(jf * jnp.asarray(w), 20)
        tre, tim = td.rdft_pair(tf * torch.from_numpy(w), 20)
        _close(tre, jre)
        _close(tim, jim)
    elif case.startswith("irfft_pair"):
        n = {"irfft_pair_20": 20, "irfft_pair_12": 12,
             "irfft_pair_fft": 300}[case]
        re, im = (rng.randn(2, 5, n // 2 + 1).astype(np.float32)
                  for _ in range(2))
        want = jd.irfft_pair(jnp.asarray(re), jnp.asarray(im), n=n)
        _close(td.irfft_pair(torch.from_numpy(re), torch.from_numpy(im), n=n),
               want)
    elif case.startswith("overlap_add"):
        win, hop = (int(v) for v in case.split("_")[-2:])
        fr = rng.randn(2, 9, win).astype(np.float32)
        _close(td.overlap_add(torch.from_numpy(fr), hop, win),
               jd.overlap_add(jnp.asarray(fr), hop, win))
    elif case == "window_envelope":
        key = tuple(jd._window_np("hann", 20, True).tolist())
        np.testing.assert_array_equal(td._window_envelope_np(key, 37, 5, 20, False),
                                      jd._window_envelope_np(key, 37, 5, 20, False))
    else:
        for kind in ("hann", "hamming", "blackman", "bartlett", "povey"):
            for periodic in (False, True):
                np.testing.assert_array_equal(td._window_np(kind, 20, periodic),
                                              jd._window_np(kind, 20, periodic))
