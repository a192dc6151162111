"""DACVAE of the PyTorch port against the JAX package, on the CPU: the
cases of tests/test_dacvae.py (encode, the pad to the hop, decode, the
chunked decode, `sanitize`'s weight-norm fold and dropped branches), each
held to the JAX package's on one weight set; the departures of `sanitize`
pinned (layouts read from shapes, a mixed tree converted key by key,
alphas flattened); the codec loader on a tiny directory.

Config: tests/test_dacvae.py's `_tiny` (hop 8); one parameter set drawn
with numpy over JAX's shapes (`test_torch_mimi.numpy_params`), biases and
snake alphas drawn too so that they count. ATOL = 2e-4
(f32, summation order; tests/test_torch_parity.py:19).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
CFG = dict(encoder_dim=8, encoder_rates=[2, 4], latent_dim=32,
           decoder_dim=32, decoder_rates=[4, 2], codebook_dim=8,
           sample_rate=16000)
TRANSPOSED = "block_1.weight"


def draw_tree(init, seed: int) -> dict:
    """A flat JAX tree drawn with numpy: `numpy_params`, then the biases
    N(0, 0.1) and the snake alphas U(0.5, 1.5)."""
    flat = flat_numpy(numpy_params(init, seed))
    rs = np.random.RandomState(seed + 1)
    for k in flat:
        if k.endswith(".bias"):
            flat[k] = (rs.randn(*flat[k].shape) * 0.1).astype(np.float32)
        elif k.endswith("_alpha") and "embed" not in k:
            flat[k] = (0.5 + rs.rand(*flat[k].shape)).astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def pair():
    import jax.numpy as jnp

    from mlx_audio_tpu.codec.models.dacvae import Model as JModel
    from mlx_audio_tpu.codec.models.dacvae import ModelConfig as JConfig
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.codec.models.dacvae import Model, ModelConfig
    from mlx_audio_tpu_torch.model import load_jax_params

    jm = JModel(JConfig(**CFG))
    flat = draw_tree(jm.init_params, 0)
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    pm = load_jax_params(Model(ModelConfig(**CFG), device="cpu"), flat)
    return jm, pm, flat


@pytest.mark.parametrize("n", [800, 805])
def test_encode_matches_jax(pair, n):
    """(1, n, 1) audio -> (1, 8, ceil(n / 8)) VAE means, padded to the hop,
    within ATOL of JAX's."""
    jm, pm, _ = pair
    wav = np.random.RandomState(n).randn(1, n, 1).astype(np.float32)
    want = np.asarray(jm.encode(wav))
    got = pm.encode(wav).numpy()
    assert got.shape == want.shape == (1, 8, -(-n // 8))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(pm.encode(wav[0, :, 0]).numpy(), want,
                               atol=ATOL)


@pytest.mark.parametrize("chunk", [None, 16, 32])
def test_decode_matches_jax(pair, chunk):
    """(1, 8, 64) latents -> (1, 512, 1) in [-1, 1], whole and in chunks
    (4 frames of overlap dropped at each seam), within ATOL of JAX's."""
    jm, pm, _ = pair
    z = np.random.RandomState(2).randn(1, 8, 64).astype(np.float32)
    want = np.asarray(jm.decode(z, chunk_size=chunk))
    got = pm.decode(z, chunk_size=chunk).numpy()
    assert got.shape == want.shape == (1, 64 * 8, 1)
    assert np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_bf16_decode_is_close(pair):
    """A bf16 copy decodes within 5e-2 of f32 (the snake in f32)."""
    _, pm, flat = pair
    from mlx_audio_tpu_torch.codec.models.dacvae import Model, ModelConfig
    from mlx_audio_tpu_torch.model import load_jax_params

    bf = load_jax_params(Model(ModelConfig(**CFG), device="cpu"), flat)
    bf.astype(torch.bfloat16)
    z = np.random.RandomState(3).randn(1, 8, 20).astype(np.float32)
    got = bf.decode(z)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), pm.decode(z).numpy(),
                               atol=5e-2)


# -- checkpoints ----------------------------------------------------------


def checkpoint(flat: dict, layout: str, weight_norm: bool = True,
               extra: bool = True) -> dict:
    """The tree as a reference checkpoint names it, its convs in `layout`
    (torch (O, I, K) and (I, O, K), or MLX (O, K, I)), each as a
    weight-norm pair (v = 3 w, g = ||w|| over every axis but torch's
    dim 0), alphas (1, C, 1), plus the watermark branch and the
    dropped decoder blocks."""
    out = {}
    for k, v in flat.items():
        name = k.replace("_alpha", ".alpha")
        if k.endswith("_alpha"):
            out[name] = v.reshape(1, -1, 1)
            continue
        if not (k.endswith(".weight") and v.ndim == 3):
            out[name] = v
            continue
        t = k.endswith(TRANSPOSED)
        if t:       # pre-flipped (K, I, O) -> torch (I, O, K), MLX (O, K, I)
            v = np.flip(v, axis=0)
            w = np.transpose(v, (1, 2, 0) if layout == "torch" else (2, 0, 1))
            keep = 2 if layout == "mlx" else 0
        else:       # WIO (K, I, O) -> torch (O, I, K), MLX (O, K, I)
            w = np.transpose(v, (2, 1, 0) if layout == "torch" else (2, 0, 1))
            keep = 0
        w = np.ascontiguousarray(w)
        if not weight_norm:
            out[name] = w
            continue
        axes = tuple(i for i in range(3) if i != keep)
        vv = 3.0 * w
        out[name[:-len(".weight")] + ".weight_v"] = vv
        out[name[:-len(".weight")] + ".weight_g"] = np.sqrt(
            (w * w).sum(axis=axes, keepdims=True))
    if extra:
        out["decoder.wm_model.msg_processor.weight"] = np.ones((4, 4))
        out["decoder.blocks.0.block_3.weight"] = np.ones((2, 2, 2))
        out["decoder.blocks.1.block_11.alpha"] = np.ones((1, 8, 1))
    return out


def _assert_tree(got: dict, flat: dict):
    assert set(got) == set(flat)
    for k in flat:
        np.testing.assert_allclose(np.asarray(got[k]).reshape(flat[k].shape),
                                   flat[k], atol=1e-5, err_msg=k)


def test_sanitize_mlx_checkpoint_equals_jax(pair):
    """An MLX-layout weight-norm checkpoint (JAX's expected input): both
    packages fold and transpose it to the tree, drop the watermark branch
    and blocks 2, 3, 6, 7, 10 and 11; the port's alphas are (C,), JAX's
    keep the checkpoint's (1, C, 1)."""
    jm, pm, flat = pair
    ck = checkpoint(flat, "mlx")
    got = pm.sanitize(ck)
    want = {k: np.asarray(v) for k, v in jm.sanitize(ck).items()}
    _assert_tree(got, flat)
    _assert_tree(want, flat)
    alpha = "encoder.blocks.0.snake_alpha"
    assert got[alpha].shape == flat[alpha].shape == (8,)
    assert want[alpha].shape == (1, 8, 1)


def test_sanitize_reads_torch_layout_where_jax_misreads(pair):
    """A departure: a torch-layout checkpoint ((O, I, K) convs, (I, O, K)
    transposed ones) binds in the port; JAX's sanitize takes every conv for
    MLX's (O, K, I) and gives kernels of other shapes."""
    jm, pm, flat = pair
    ck = checkpoint(flat, "torch")
    _assert_tree(pm.sanitize(ck), flat)
    want = jm.sanitize(ck)
    key = "encoder.conv_in.weight"          # WIO (7, 1, 8)
    assert np.asarray(want[key]).shape != flat[key].shape


def test_sanitize_converts_a_mixed_tree_key_by_key(pair):
    """A departure: JAX returns a tree untouched once any key is named as
    converted (`encoder.blocks.*snake_alpha`), so a checkpoint mixing the
    two forms keeps its weight-norm pairs; the port converts each key."""
    jm, pm, flat = pair
    ck = checkpoint(flat, "mlx", extra=False)
    ck["encoder.blocks.0.snake_alpha"] = ck.pop("encoder.blocks.0.snake.alpha")
    assert any(k.endswith(".weight_v") for k in jm.sanitize(ck))
    _assert_tree(pm.sanitize(ck), flat)


def test_sanitize_passes_the_tree_and_plain_convs(pair):
    """The converted tree itself, and a checkpoint of plain (not
    weight-normed) MLX or torch convs, sanitize to the tree."""
    _, pm, flat = pair
    _assert_tree(pm.sanitize(dict(flat)), flat)
    for layout in ("mlx", "torch"):
        _assert_tree(pm.sanitize(checkpoint(flat, layout, weight_norm=False)),
                     flat)


def test_sanitize_rejects_a_shape_of_no_layout(pair):
    _, pm, flat = pair
    bad = dict(flat)
    bad["encoder.conv_in.weight"] = np.zeros((5, 5, 5), np.float32)
    with pytest.raises(ValueError, match="encoder.conv_in.weight"):
        pm.sanitize(bad)


def test_codec_loader_reads_a_directory(pair, tmp_path):
    """A directory of config.json (model_type dacvae) and a torch-layout
    weight-norm checkpoint loads through the codec loader, strictly, and
    decodes as JAX does from the tree."""
    from mlx_audio_tpu_torch.codec.utils import load_model

    jm, _, flat = pair
    (tmp_path / "config.json").write_text(json.dumps(
        dict(CFG, model_type="dacvae")))
    np.savez(tmp_path / "model.npz", **checkpoint(flat, "torch"))
    m = load_model(tmp_path, device="cpu")
    z = np.random.RandomState(4).randn(1, 8, 12).astype(np.float32)
    np.testing.assert_allclose(m.decode(z).numpy(), np.asarray(jm.decode(z)),
                               atol=ATOL)


def test_defaults_to_the_card():
    from mlx_audio_tpu_torch.codec.models.dacvae import Model

    if torch.cuda.is_available():
        assert Model(CFG).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(CFG)
