"""MossFormer2-SE of the PyTorch port against the JAX package, on the CPU:
the cases of tests/test_mossformer2_se.py (the FLASH block with and
without group padding, the gated FSMN, the masknet's ReLU mask, `enhance`
whole, on sliding windows and chunked, the `generate` surface,
`sanitize`), each held to the JAX package's on one weight set; the dither
pinned (fed JAX's draws through the `_noise` seam, and two calls on the
same audio equal); the loaders and the STS CLI on a tiny directory.

Config: tests/test_mossformer2_se.py's `_cfg` (8 kHz, 256-sample frames,
20 mels, in 60, d32, 129 bins, 2 blocks, groups of 16, qk 64, FSMN inner
16 and lorder 3, 2-s one-time decode, 1-s windows and chunks); one
parameter set drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`; the zero-initialised FSMN memory convs
drawn too, so that they act), the JAX side jitted. Blocks and masks at
ATOL = 2e-4 (f32, summation order; tests/test_torch_parity.py:19);
enhanced audio at 2e-4 of its peak (the port's STFT runs in float64,
JAX's in f32, at int16 scale).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
CFG = dict(sample_rate=8000, win_len=256, win_inc=128, fft_len=256,
           num_mels=20, in_channels=60, out_channels=32,
           out_channels_final=129, num_blocks=2, group_size=16,
           query_key_dim=64, fsmn_inner=16, fsmn_lorder=3,
           one_time_decode_length=2, decode_window=1, chunk_seconds=1.0,
           auto_chunk_threshold=8.0)


def jax_noise(shape):
    """JAX's dither draws for a chunk: normal(PRNGKey(0), shape)."""
    import jax

    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(0), tuple(shape))))


@pytest.fixture(scope="module")
def pair():
    from mlx_audio_tpu.sts.models.mossformer2_se import Model as JModel
    from mlx_audio_tpu.sts.models.mossformer2_se import \
        MossFormer2SEConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.sts.models.mossformer2_se import Model, ModelConfig

    jm = JModel(JConfig.from_dict(CFG))
    jm.bind(numpy_params(jm.init_params, 0))
    pm = load_jax_params(Model(ModelConfig.from_dict(CFG), device="cpu"),
                         flat_numpy(jm.params))
    pm._noise = jax_noise
    return jm, pm


def _flat_sub(params, prefix):
    return {k[len(prefix):]: v for k, v in flat_numpy(params).items()
            if k.startswith(prefix)}


def _bind(module, flat):
    from mlx_audio_tpu_torch.model import TorchModel, load_jax_params

    holder = TorchModel(None)
    holder.m = module
    load_jax_params(holder, {"m." + k: v for k, v in flat.items()})
    return module


@pytest.mark.parametrize("n", [21, 16])
def test_flash_block_matches_jax(pair, n):
    """The FLASH block at a length the group size divides and one it
    does not (padded groups)."""
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.sts.models.mossformer2_se.mossformer2_se import \
        _flash_block

    jm, pm = pair
    p = jm.params["mdl"]["intra_mdl"]["mossformerM"]["layers"]["0"]
    x = np.random.RandomState(n).randn(2, n, 32).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: _flash_block(p, x, 16))(
        p, jnp.asarray(x)))
    got = pm.mdl.intra_mdl.mossformerM.layers[0](torch.from_numpy(x))
    assert got.shape == (2, n, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_gated_fsmn_matches_jax(pair):
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.sts.models.mossformer2_se.mossformer2_se import \
        _gated_fsmn_block

    jm, pm = pair
    p = jm.params["mdl"]["intra_mdl"]["mossformerM"]["fsmn"]["1"]
    x = np.random.RandomState(2).randn(1, 10, 32).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: _gated_fsmn_block(p, x, 3))(
        p, jnp.asarray(x)))
    got = pm.mdl.intra_mdl.mossformerM.fsmn[1](torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert float(np.abs(p["gated_fsmn"]["fsmn"]["conv1"]["weight"]).max()) \
        > 0      # the memory conv acts


def test_masknet_matches_jax(pair):
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.sts.models.mossformer2_se.mossformer2_se import \
        masknet_forward as jax_masknet
    from mlx_audio_tpu_torch.sts.models.mossformer2_se.mossformer2_se \
        import masknet_forward

    jm, pm = pair
    feats = np.random.RandomState(0).randn(1, 30, 60).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, f: jax_masknet(p, jm.config, f))(
        jm.params, jnp.asarray(feats)))
    got = masknet_forward(pm, torch.from_numpy(feats)).numpy()
    assert got.shape == (1, 30, 129) and got.min() >= 0.0
    np.testing.assert_allclose(got, want, atol=ATOL)


def _close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("n,chunked,chunks", [(4000, None, 1),
                                              (20000, None, 3),
                                              (18000, True, 3)],
                         ids=["whole", "windows", "chunked"])
def test_enhance_matches_jax(pair, n, chunked, chunks):
    """`enhance` fed JAX's dither draws: whole (4,000 samples), on sliding
    1-s windows past the 2-s one-time length (20,000) and chunked (18,000
    in 1-s chunks with 0.25 overlap): the audio within 2e-4 of its
    peak."""
    jm, pm = pair
    audio = (np.random.RandomState(n).randn(n) * 0.1).astype(np.float32)
    got = pm.enhance(audio, chunked=chunked)
    _close(got, np.asarray(jm.enhance(audio, chunked=chunked)))
    assert got.shape == (n,) and pm.last_run["chunks"] == chunks


def test_dither_is_deterministic_and_seeded_per_chunk(pair):
    """Two calls on the same audio give the same output, as JAX's fixed
    key does; the default draws (a CPU generator seeded 0 a chunk) are
    not JAX's but are the same on every call."""
    from mlx_audio_tpu_torch.sts.models.mossformer2_se import Model

    _, pm = pair
    audio = (np.random.RandomState(5).randn(3000) * 0.1).astype(np.float32)
    a = pm.enhance(audio)
    np.testing.assert_array_equal(a, pm.enhance(audio))
    own = Model(CFG, device="cpu")
    own.load_state_dict(pm.state_dict())
    b = own.enhance(audio)
    np.testing.assert_array_equal(b, own.enhance(audio))
    assert not np.array_equal(a, b)
    shape = (22, 256)
    assert torch.equal(own._noise(shape), own._noise(shape))


def test_generate_surface(pair):
    jm, pm = pair
    audio = (np.random.RandomState(3).randn(2000) * 0.1).astype(np.float32)
    res = pm.generate(audio)
    assert res["sample_rate"] == 8000 and res["audio"].shape == (2000,)
    assert res["processing_time_seconds"] > 0
    _close(res["audio"], np.asarray(jm.generate(audio)["audio"]))


def test_sanitize_matches_jax(pair):
    jm, pm = pair
    rs = np.random.RandomState(4)
    w = {"model.mossformer.conv1d_encoder.weight": rs.randn(32, 60, 1),
         "model.mossformer.mdl.intra_mdl.mossformerM.fsmn.0."
         "gated_fsmn.fsmn.conv1.weight": rs.randn(16, 1, 5, 1),
         "model.mossformer.mdl.intra_mdl.mossformerM.layers.0."
         "to_hidden.conv_module.weight": rs.randn(128, 1, 17),
         "mossformer.output.weight": rs.randn(32, 32, 1),
         "mossformer.prelu.weight": rs.randn(1)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    got, want = pm.sanitize(w), jm.sanitize(w)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["conv1d_encoder.weight"].shape == (32, 60)
    again = pm.sanitize(got)
    for k in got:
        np.testing.assert_array_equal(again[k], got[k])


def write_dir(pm, d):
    """The published layout: `model.mossformer.` names, torch's 1x1 and
    depthwise conv layouts."""
    from mlx_audio_tpu_torch.model import jax_params

    ckpt = {}
    for k, v in jax_params(pm).items():
        v = v.numpy()
        if k.endswith("conv_module.weight"):
            v = np.transpose(v, (2, 1, 0))
        elif k.endswith("fsmn.conv1.weight"):
            v = np.transpose(v, (3, 2, 0, 1))
        elif k.endswith("weight") and v.ndim == 2 and "norm" not in k:
            v = v[..., None]
        ckpt["model.mossformer." + k] = v
    d.mkdir()
    np.savez(d / "model.npz", **ckpt)
    (d / "config.json").write_text(json.dumps(dict(
        CFG, model_type="mossformer2_se")))


def test_loaders_and_cli_route_a_tiny_directory(pair, tmp_path,
                                                monkeypatch):
    """A published-layout directory through `sts.utils.load_model`, the
    top-level router and the STS CLI (`generate` with the enhancement
    output written as a WAV)."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.sts import generate as sts_generate
    from mlx_audio_tpu_torch.sts import utils
    from mlx_audio_tpu_torch.sts.models.mossformer2_se import Model

    jm, pm = pair
    d = tmp_path / "MossFormer2_SE_48K-tiny"
    write_dir(pm, d)
    assert "mossformer2_se" in utils.PORTED
    audio = (np.random.RandomState(6).randn(4000) * 0.1).astype(np.float32)
    want = pm.enhance(audio)
    for loaded in (utils.load_model(d, device="cpu"),
                   mlx_audio_tpu_torch.load_model(d, device="cpu")):
        assert isinstance(loaded, Model)
        for k, v in pm.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), k
        loaded._noise = jax_noise
        np.testing.assert_array_equal(loaded.enhance(audio), want)
    wav = tmp_path / "in.wav"
    audio_io.write(wav, audio, 8000)
    x, _ = audio_io.read(str(wav), dtype="float32")
    real = utils.load_model

    def load_cpu(path, **kw):
        m = real(path, device="cpu", **kw)
        m._noise = jax_noise
        return m

    monkeypatch.setattr(utils, "load_model", load_cpu)
    out = tmp_path / "out.wav"
    sts_generate.main(["--model", str(d), "--audio", str(wav),
                       "--output-path", str(out)])
    y, sr = audio_io.read(str(out), dtype="float32")
    assert sr == 8000 and y.shape == (4000,)
    np.testing.assert_allclose(y, np.clip(pm.enhance(x), -1, 1),
                               atol=2 / 32768)
