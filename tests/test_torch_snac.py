"""The SNAC codec of the PyTorch port against the JAX package, on the CPU:
tests/test_codecs.py::TestSNAC and tests/test_orpheus.py::TestSnacStream.
Encode codes equal; decode and `decode_stream` without the noise blocks,
and with them when the port is handed JAX's draws (jax.random.PRNGKey(0),
as JAX's decode draws them) through its `_noise` seam; `sanitize` from
both torch weight-norm forms gives JAX's tree; the codec loader.

Config: tests/test_orpheus.py's tiny SNAC (encoder 16, rates [2, 2],
decoder 32, strides [4, 2, 1], depthwise), one parameter set drawn with
numpy over JAX's shapes (`test_torch_mimi.numpy_params`). Audio at
ATOL = 2e-4 (f32, summation order); codes exactly.
"""

import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
TINY = dict(sampling_rate=24000, encoder_dim=16, encoder_rates=[2, 2],
            decoder_dim=32, decoder_rates=[2, 2], attn_window_size=None,
            codebook_size=4096, codebook_dim=8, vq_strides=[4, 2, 1],
            noise=True, depthwise=True)


def jax_noise(generator, stage, shape):
    return torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), shape)))


def make_pair(noise: bool = True, seed: int = 0):
    from mlx_audio_tpu.codec.models.snac import SNAC as JSNAC
    from mlx_audio_tpu_torch.codec.models.snac import SNAC
    from mlx_audio_tpu_torch.model import load_jax_params

    cfg = dict(TINY, noise=noise)
    js = JSNAC(dict(cfg))
    js.bind(numpy_params(js.init_params, seed))
    ps = load_jax_params(SNAC(cfg, device="cpu"), flat_numpy(js.params))
    ps._noise = jax_noise
    return js, ps


@pytest.fixture(scope="module")
def pair():
    return make_pair(noise=True)


@pytest.fixture(scope="module")
def quiet_pair():
    return make_pair(noise=False)


def _codes(rng, frames):
    return [rng.randint(0, 4096, (1, frames * k)) for k in (1, 2, 4)]


def test_encode_codes_equal_jax(pair):
    js, ps = pair
    audio = np.random.RandomState(0).randn(1, 1, 700).astype(np.float32)
    jc, pc = js.encode(audio), ps.encode(audio)
    assert [tuple(c.shape) for c in pc] == [(1, 44), (1, 88), (1, 176)]
    for a, b in zip(jc, pc):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("which", ["noise off", "JAX's noise"])
def test_decode_matches_jax(pair, quiet_pair, which):
    js, ps = quiet_pair if which == "noise off" else pair
    codes = _codes(np.random.RandomState(1), 6)
    ja = np.asarray(js.decode([jnp.asarray(c) for c in codes]))
    pa = ps.decode(codes).numpy()
    assert pa.shape == ja.shape == (1, 6 * 16, 1)
    np.testing.assert_allclose(pa, ja, atol=ATOL)


def test_seeded_noise_is_repeatable():
    """Without the seam the port draws its own noise from a generator seeded
    on every decode: two decodes agree, and the noise is on."""
    from mlx_audio_tpu_torch.codec.models.snac import SNAC

    s = SNAC(TINY, device="cpu").init_params(0)
    codes = _codes(np.random.RandomState(2), 4)
    a, b = s.decode(codes).numpy(), s.decode(codes).numpy()
    np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        for blk in ("2", "3"):
            s.decoder[blk].block["2"].linear.weight.zero_()
    assert np.abs(s.decode(codes).numpy() - a).max() > 0


@pytest.mark.parametrize("which", ["noise off", "JAX's noise"])
def test_decode_stream_matches_jax(pair, quiet_pair, which):
    """Two streamed halves: the first decodes alone, the second with its
    per-level context; both equal JAX's, and (noise off) add up to the
    offline length."""
    js, ps = quiet_pair if which == "noise off" else pair
    full = _codes(np.random.RandomState(1), 8)
    c1 = [full[0][:, :4], full[1][:, :8], full[2][:, :16]]
    c2 = [full[0][:, 4:], full[1][:, 8:], full[2][:, 16:]]
    j1, jctx = js.decode_stream([jnp.asarray(x) for x in c1])
    j2, jctx2 = js.decode_stream([jnp.asarray(x) for x in c2], jctx,
                                 context_frames=8)
    p1, pctx = ps.decode_stream(c1)
    p2, pctx2 = ps.decode_stream(c2, pctx, context_frames=8)
    np.testing.assert_allclose(p1.numpy(), np.asarray(j1), atol=ATOL)
    np.testing.assert_allclose(p2.numpy(), np.asarray(j2), atol=ATOL)
    for a, b in zip(jctx2, pctx2):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert p1.shape[1] + p2.shape[1] == ps.decode(full).shape[1]


def torch_checkpoint(flat: dict, form: str) -> dict:
    """The JAX tree as a torch SNAC checkpoint: kernels in torch's layouts
    (upsamplers (I, O, W)), weight norm as `weight_g`/`weight_v` or as
    `parametrizations.weight.original0/1`, alphas (1, C, 1)."""
    out = {}
    for k, v in flat.items():
        if k.endswith(".weight") and v.ndim == 3:
            base = k[:-len(".weight")]
            if re.search(r"decoder\.\d+\.block\.1$", base):
                w = np.flip(v, 0).transpose(1, 2, 0)
            else:
                w = v.transpose(2, 1, 0)
            w = np.ascontiguousarray(w * 3.0)
            g = np.sqrt((w.astype(np.float64) ** 2).sum(
                axis=(1, 2), keepdims=True)).astype(np.float32) / 3.0
            if form == "weight_g":
                out[base + ".weight_g"], out[base + ".weight_v"] = g, w
            else:
                p = base + ".parametrizations.weight."
                out[p + "original0"], out[p + "original1"] = g, w
        elif k.endswith("alpha"):
            out[k] = v.reshape(1, -1, 1)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("form", ["weight_g", "parametrizations"])
def test_sanitize_equals_jax(pair, form):
    """Both weight-norm forms fold to JAX's tree (the decoder's upsamplers
    found by the anchored pattern, not a residual unit's inner
    `block.1`), which binds to the same decode."""
    from mlx_audio_tpu_torch.codec.models.snac import SNAC
    from mlx_audio_tpu_torch.model import load_jax_params

    js, _ = pair
    ckpt = torch_checkpoint(flat_numpy(js.params), form)
    ref = {k: np.asarray(v) for k, v in js.sanitize(
        {k: jnp.asarray(v) for k, v in ckpt.items()}).items()}
    ps = SNAC(TINY, device="cpu")
    got = ps.sanitize(ckpt)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6, err_msg=k)
    for k, v in flat_numpy(js.params).items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)
    load_jax_params(ps, got)


def test_codec_loader_is_local_and_strict(pair, tmp_path):
    from safetensors.numpy import save_file

    from mlx_audio_tpu_torch.codec.utils import load_model

    js, ps = pair
    d = tmp_path / "snac"
    d.mkdir()
    ckpt = torch_checkpoint(flat_numpy(js.params), "weight_g")
    save_file(ckpt, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(dict(TINY, model_type="snac")))
    loaded = load_model(d, device="cpu")
    loaded._noise = jax_noise
    codes = _codes(np.random.RandomState(3), 4)
    np.testing.assert_allclose(loaded.decode(codes).numpy(),
                               ps.decode(codes).numpy(), atol=1e-5)
    with pytest.raises(FileNotFoundError, match="never downloads"):
        load_model(tmp_path / "missing", device="cpu")
    del ckpt["quantizer.0.codebook.weight"]
    save_file(ckpt, str(d / "model.safetensors"))
    with pytest.raises(KeyError, match="quantizer.0.codebook.weight"):
        load_model(d, device="cpu")


def test_published_24khz_shape_contract():
    """hubertsiuzdak/snac_24khz's settings (tests/test_codecs.py::TestSNAC):
    120,000 samples encode to levels of 59, 118 and 236 codes and decode
    to the hop-padded 120,832 samples."""
    from mlx_audio_tpu_torch.codec.models.snac import SNAC

    s = SNAC(dict(sampling_rate=24000, encoder_dim=48,
                  encoder_rates=[2, 4, 8, 8], decoder_dim=1024,
                  decoder_rates=[8, 8, 4, 2], attn_window_size=None,
                  codebook_size=4096, codebook_dim=8, vq_strides=[4, 2, 1],
                  noise=True, depthwise=True), device="cpu").init_params(0)
    assert s.hop_length == 512
    codes = s.encode(np.zeros((1, 1, 120_000), np.float32))
    assert [tuple(c.shape) for c in codes] == [(1, 59), (1, 118), (1, 236)]
    rec = s.decode(codes)
    assert tuple(rec.shape) == (1, 120_832, 1)
    assert torch.isfinite(rec).all()
