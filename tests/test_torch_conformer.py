"""The port's FastConformer encoder against the JAX package, on the CPU at
f32: the layers it brings (Conv2d, BatchNorm), the dw-striding subsampling
with its (F', C) flatten, `_rel_shift`, the relative-position attention,
one block, and `conformer_forward` with ragged lengths.

Both packages run one weight set: the JAX tree's random parameters
(`init_conformer`, with the batch norms' statistics and the position biases
drawn too, so they are not trivial), loaded into the port with
`model.load_jax_params`. Tensors agree within ATOL = 2e-4, the repo's f32
precedent (tests/test_torch_parity.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mlx_audio_tpu.stt.models.parakeet import conformer as jc  # noqa: E402
from mlx_audio_tpu.utils import flatten  # noqa: E402

ATOL = 2e-4

# tests/test_cohere_asr.py's encoder; a 4x stack on odd mel widths without
# biases; and one with xscaling and a wider kernel
CONFIGS = {
    "cohere_tiny": dict(feat_in=20, n_layers=2, d_model=32, n_heads=4,
                        ff_expansion_factor=2, subsampling_factor=8,
                        subsampling_conv_channels=8, conv_kernel_size=9),
    "sub4_nobias": dict(feat_in=23, n_layers=1, d_model=24, n_heads=2,
                        ff_expansion_factor=4, subsampling_factor=4,
                        subsampling_conv_channels=6, conv_kernel_size=5,
                        use_bias=False),
    "xscaling": dict(feat_in=16, n_layers=2, d_model=16, n_heads=2,
                     ff_expansion_factor=2, subsampling_factor=8,
                     subsampling_conv_channels=4, conv_kernel_size=15,
                     xscaling=True),
}


def _randomize(tree, key):
    """Every leaf of `tree` redrawn (batch-norm variances positive), so
    zero-initialized biases and statistics take part in the comparison."""
    flat = flatten(tree)
    keys = jax.random.split(key, len(flat))
    out = {}
    for (name, v), k in zip(sorted(flat.items()), keys):
        r = jax.random.normal(k, v.shape) * 0.3
        out[name] = (jnp.abs(r) + 0.5) if name.endswith("running_var") else r
    from mlx_audio_tpu.utils import unflatten
    return unflatten(out)


def encoder_pair(name: str):
    """(ConformerArgs, JAX params, port module) with one weight set."""
    from mlx_audio_tpu_torch.model import TorchModel, load_jax_params
    from mlx_audio_tpu_torch.stt.models.parakeet import conformer as pc

    a = jc.ConformerArgs(**CONFIGS[name])
    params = _randomize(jc.init_conformer(jax.random.PRNGKey(0), a),
                        jax.random.PRNGKey(1))

    class Holder(TorchModel):
        def __init__(self):
            super().__init__(a)
            self.encoder = pc.Conformer(pc.ConformerArgs(**CONFIGS[name]))
            self.requires_grad_(False)

    pm = load_jax_params(Holder(), {f"encoder.{k}": np.asarray(v)
                                    for k, v in flatten(params).items()})
    return a, params, pm.encoder


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
    return np.asarray(x, np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return encoder_pair(request.param)


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("groups,stride,padding", [(1, 2, 1), (4, 2, 1),
                                                   (1, 1, 0), (2, 1, 1)])
def test_conv2d_matches_jax(groups, stride, padding):
    """The port's Conv2d (OIHW, channel-first) against apply_conv2d (HWIO,
    NHWC), its weight carried across by load_jax_params."""
    from mlx_audio_tpu.nn.layers import apply_conv2d, init_conv2d
    from mlx_audio_tpu_torch.model import TorchModel, load_jax_params
    from mlx_audio_tpu_torch.nn import Conv2d

    p = init_conv2d(jax.random.PRNGKey(2), 4, 8, 3, groups=groups)
    p["bias"] = jax.random.normal(jax.random.PRNGKey(3), (8,))
    x = np.random.RandomState(0).randn(2, 11, 9, 4).astype(np.float32)
    want = apply_conv2d(p, jnp.asarray(x), stride=stride, padding=padding,
                        groups=groups)

    class Holder(TorchModel):
        def __init__(self):
            super().__init__(None)
            self.conv = Conv2d(4, 8, 3, groups=groups)

    m = load_jax_params(Holder(), {f"conv.{k}": np.asarray(v)
                                   for k, v in p.items()})
    got = m.conv(torch.from_numpy(x).permute(0, 3, 1, 2), stride=stride,
                 padding=padding).permute(0, 2, 3, 1)
    _close(got, want)


def test_batch_norm_matches_jax_and_keeps_f32_statistics():
    from mlx_audio_tpu.codec.models.ecapa_tdnn.ecapa_tdnn import (
        apply_batch_norm)
    from mlx_audio_tpu_torch.model import TorchModel, load_jax_params
    from mlx_audio_tpu_torch.nn import BatchNorm

    rng = np.random.RandomState(1)
    p = {"weight": rng.randn(6), "bias": rng.randn(6),
         "running_mean": rng.randn(6), "running_var": rng.rand(6) + 0.1}
    x = rng.randn(2, 5, 6).astype(np.float32)
    want = apply_batch_norm({k: jnp.asarray(v, jnp.float32)
                             for k, v in p.items()}, jnp.asarray(x))

    class Holder(TorchModel):
        def __init__(self):
            super().__init__(None)
            self.bn = BatchNorm(6)

    m = load_jax_params(Holder(), {f"bn.{k}": v for k, v in p.items()})
    _close(m.bn(torch.from_numpy(x)), want)
    m.astype(torch.bfloat16)
    assert m.bn.weight.dtype == torch.bfloat16
    assert m.bn.running_mean.dtype == m.bn.running_var.dtype == torch.float32
    y = m.bn(torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    _close(y, want, atol=0.1)


def test_init_params_fills_the_conformer_like_jax():
    """init_params: BatchNorm at (1, 0, 0, 1), zero position biases, Conv2d
    kernels within +-1/sqrt(I/g*kh*kw)."""
    from mlx_audio_tpu_torch.model import TorchModel
    from mlx_audio_tpu_torch.stt.models.parakeet import conformer as pc

    a = pc.ConformerArgs(**CONFIGS["cohere_tiny"])

    class Holder(TorchModel):
        def __init__(self):
            super().__init__(a)
            self.encoder = pc.Conformer(a)

    enc = Holder().init_params(seed=0).encoder
    bn = enc.layers[0].conv.batch_norm
    assert (bn.weight == 1).all() and (bn.bias == 0).all()
    assert (bn.running_mean == 0).all() and (bn.running_var == 1).all()
    attn = enc.layers[1].self_attn
    assert (attn.pos_bias_u == 0).all() and (attn.pos_bias_v == 0).all()
    for key, conv in enc.pre_encode.layers.items():
        _, i_g, kh, kw = conv.weight.shape
        bound = (i_g * kh * kw) ** -0.5
        assert conv.weight.abs().max() <= bound and conv.weight.std() > 0
        assert (conv.bias == 0).all(), key


# -------------------------------------------------------------- pieces


def test_rel_pos_encoding_is_the_jax_table():
    from mlx_audio_tpu_torch.stt.models.parakeet.conformer import (
        rel_pos_encoding)

    for t, d in ((1, 8), (7, 16), (33, 32)):
        np.testing.assert_array_equal(rel_pos_encoding(t, d),
                                      jc.rel_pos_encoding(t, d))


@pytest.mark.parametrize("t", [1, 2, 5, 16])
def test_rel_shift_matches_jax(t):
    from mlx_audio_tpu_torch.stt.models.parakeet.conformer import _rel_shift

    x = np.random.RandomState(t).randn(2, 3, t, 2 * t - 1).astype(np.float32)
    np.testing.assert_array_equal(_rel_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(jc._rel_shift(jnp.asarray(x))))


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_subsampled_length_matches_jax(factor):
    from mlx_audio_tpu_torch.stt.models.parakeet import conformer as pc

    a = jc.ConformerArgs(subsampling_factor=factor)
    n = np.arange(0, 400, 7)
    got = pc.subsampled_length(pc.ConformerArgs(subsampling_factor=factor),
                               torch.from_numpy(n))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jc.subsampled_length(a, n)))
    assert [pc.subsampled_length(a, int(v)) for v in n] == got.tolist()


def test_subsampling_matches_jax(pair):
    """The strided conv stack run channel-first, flattened as JAX's
    (F', C) with C fastest before `out`: with channels and mel bins
    flattened in another order, `out` would read a permuted input and only
    this comparison would show it."""
    from mlx_audio_tpu_torch.stt.models.parakeet.conformer import subsample

    a, params, enc = pair
    mel = np.random.RandomState(0).randn(2, 67, a.feat_in).astype(np.float32)
    want = jc.apply_subsampling(params["pre_encode"], a, jnp.asarray(mel))
    _close(subsample(enc.pre_encode, torch.from_numpy(mel)), want)


@pytest.mark.parametrize("masked", [False, True])
def test_rel_pos_attention_matches_jax(pair, masked):
    from mlx_audio_tpu_torch.stt.models.parakeet import conformer as pc

    a, params, enc = pair
    t = 9
    x = np.random.RandomState(2).randn(2, t, a.d_model).astype(np.float32)
    pos = jc.rel_pos_encoding(t, a.d_model)
    valid = np.arange(t)[None, :] < np.array([[t], [5]])
    mask = valid[:, None, None, :] if masked else None
    want = jc._rel_pos_attention(params["layers"]["0"]["self_attn"], a,
                                 jnp.asarray(x), jnp.asarray(pos),
                                 None if mask is None else jnp.asarray(mask))
    got = pc.rel_pos_attention(enc.layers[0].self_attn, a, torch.from_numpy(x),
                               torch.from_numpy(pos),
                               None if mask is None else torch.from_numpy(mask))
    _close(got, want)


def test_block_matches_jax(pair):
    from mlx_audio_tpu_torch.stt.models.parakeet import conformer as pc

    a, params, enc = pair
    t = 12
    x = np.random.RandomState(3).randn(2, t, a.d_model).astype(np.float32)
    pos = jc.rel_pos_encoding(t, a.d_model)
    mask = (np.arange(t)[None, :] < np.array([[t], [7]]))[:, None, None, :]
    want = jc.conformer_block(params["layers"]["0"], a, jnp.asarray(x),
                              jnp.asarray(pos), mask=jnp.asarray(mask))
    got = pc.conformer_block(enc.layers[0], a, torch.from_numpy(x),
                             torch.from_numpy(pos), torch.from_numpy(mask))
    _close(got, want)


def test_forward_without_lengths_matches_jax(pair):
    from mlx_audio_tpu_torch.stt.models.parakeet import conformer as pc

    a, params, enc = pair
    mel = np.random.RandomState(4).randn(2, 96, a.feat_in).astype(np.float32)
    want = jc.conformer_forward(params, a, jnp.asarray(mel))
    _close(pc.conformer_forward(enc, a, torch.from_numpy(mel)), want)


def test_forward_ragged_lengths_matches_jax(pair):
    """Valid frames equal JAX's; padded frames are zero in both. The row
    of length 0 is zero here, where JAX's is NaN (no key in its mask)."""
    from mlx_audio_tpu_torch.stt.models.parakeet import conformer as pc

    a, params, enc = pair
    mel = np.random.RandomState(5).randn(4, 128, a.feat_in).astype(np.float32)
    lens = np.array([128, 91, 9, 0])
    want = np.asarray(jc.conformer_forward(params, a, jnp.asarray(mel),
                                           lengths=jnp.asarray(lens)))
    got = pc.conformer_forward(enc, a, torch.from_numpy(mel),
                               torch.from_numpy(lens)).numpy()
    _close(got[:3], want[:3])
    n = np.asarray(jc.subsampled_length(a, lens))
    for r in range(3):
        assert not got[r, n[r]:].any()
    assert np.isnan(want[3]).all()
    assert np.isfinite(got).all() and not got[3].any()
