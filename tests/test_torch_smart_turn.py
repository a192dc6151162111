"""Smart Turn of the PyTorch port against the JAX package, on the CPU: the
cases of tests/test_smart_turn.py (the encoder, the probability, the HF
mel layout, `predict_endpoint` from audio at 16 kHz and at another rate,
the fixed frame count, `sanitize`), each held to the JAX package's on one
weight set; the departure pinned (the layouts read from shapes); the
loaders on a tiny directory of HF names.

Config: tests/test_smart_turn.py's `_tiny` (20 mels, d16, 2 heads, 2
layers, FFN 32, 1-s window); one parameter set drawn with numpy over JAX's
shapes (`test_torch_mimi.numpy_params`), the biases drawn too so that
they count; the JAX side jitted. ATOL = 2e-4 (f32, summation order;
tests/test_torch_parity.py:19).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
CFG = dict(encoder_config=dict(num_mel_bins=20, max_source_positions=50,
                               d_model=16, encoder_attention_heads=2,
                               encoder_layers=2, encoder_ffn_dim=32),
           processor_config=dict(max_audio_seconds=1, n_mels=20))


@pytest.fixture(scope="module")
def pair():
    import jax.numpy as jnp

    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu.vad.models.smart_turn import Model as JModel
    from mlx_audio_tpu.vad.models.smart_turn import ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.vad.models.smart_turn import Model, ModelConfig

    jm = JModel(JConfig.from_dict(CFG))
    flat = flat_numpy(numpy_params(jm.init_params, 0))
    rs = np.random.RandomState(1)
    for k in [k for k in flat if k.endswith(".bias")]:
        flat[k] = (rs.randn(*flat[k].shape) * 0.1).astype(np.float32)
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    pm = load_jax_params(Model(ModelConfig.from_dict(CFG), device="cpu"),
                         flat)
    return jm, pm, flat


def _audio(seed, n):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def test_encoder_matches_jax(pair):
    """The encoder (GELU stem, learned positions, pre-norm layers) on a
    (1, 100, 20) mel -> (1, 50, 16), within ATOL of `encoder_forward`."""
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.vad.models.smart_turn.smart_turn import encoder_forward

    jm, pm, _ = pair
    mel = np.random.RandomState(0).randn(1, 100, 20).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, m: encoder_forward(
        p, jm.config.encoder_config, m))(jm.params["encoder"],
                                         jnp.asarray(mel)))
    with torch.inference_mode():
        got = pm.encoder(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (1, 50, 16)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_probability_and_hf_layout_match_jax(pair):
    """The (B, 1) probability of a batch of two, and of HF's (n_mels,
    frames) layout, equal JAX's within ATOL and lie in [0, 1]."""
    import jax.numpy as jnp

    jm, pm, _ = pair
    mel = np.random.RandomState(2).randn(2, 100, 20).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(mel)))
    got = pm(mel).numpy()
    assert got.shape == (2, 1) and ((0 <= got) & (got <= 1)).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(pm(mel[0].T).numpy(), want[:1], atol=ATOL)


@pytest.mark.parametrize("seconds,rate", [(0.5, 16000), (1.5, 16000),
                                          (0.5, 8000)])
def test_predict_endpoint_matches_jax(pair, seconds, rate):
    """From audio: the last second kept or left-padded, normalised, the
    whisper log-mel's last frame dropped, the frame count fixed; 8 kHz
    resampled by np.interp. Features and probability within ATOL of JAX,
    the decision equal; a threshold of 1 or -1 forces it."""
    jm, pm, _ = pair
    audio = _audio(3, int(seconds * rate))
    sr = None if rate == 16000 else rate
    want_mel = np.asarray(jm.prepare_input_features(audio, sr))
    got_mel = pm.prepare_input_features(audio, sr).numpy()
    pc = pm.config.processor_config
    assert got_mel.shape == want_mel.shape == (
        pc.max_audio_seconds * pc.sampling_rate // pc.hop_length, 20)
    np.testing.assert_allclose(got_mel, want_mel, atol=ATOL)
    got = pm.predict_endpoint(audio, sample_rate=sr)
    want = jm.predict_endpoint(audio, sample_rate=sr)
    assert abs(got.probability - want.probability) < ATOL
    assert got.prediction == want.prediction
    assert pm.predict_endpoint(audio, sr, threshold=1.0).prediction == 0
    assert pm.predict_endpoint(audio, sr, threshold=-1.0).prediction == 1


def _hf_names(flat):
    """The JAX tree as an HF/pipecat checkpoint names it: `inner.`
    prefixed, the indexed Sequentials, torch conv layouts."""
    out = {}
    for k, v in flat.items():
        for i in ("0", "2"):
            k = k.replace(f"pool_attention_{i}.", f"pool_attention.{i}.")
        for i in ("0", "1", "4", "6"):
            k = k.replace(f"classifier_{i}.", f"classifier.{i}.")
        if k in ("encoder.conv1.weight", "encoder.conv2.weight"):
            v = np.transpose(v, (2, 1, 0))
        out["inner." + k] = v
    return out


def test_sanitize_hf_layout_equals_jax(pair):
    """HF names and torch conv layouts (plus an ONNX helper constant and
    an ONNX (in, out) linear) sanitize to the JAX tree in both packages,
    leaf for leaf."""
    jm, pm, flat = pair
    hf = _hf_names(flat)
    hf["val_helper_const"] = np.ones(4, np.float32)
    hf["inner.pool_attention.0.weight"] = flat["pool_attention_0.weight"].T
    got = pm.sanitize(hf)
    want = {k: np.asarray(v) for k, v in jm.sanitize(hf).items()}
    assert set(got) == set(want) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)


def test_sanitize_reads_mlx_convs_where_jax_misreads(pair):
    """A departure from a JAX fault: an MLX stem conv (O, 3, I) = (16, 3,
    20) has a first axis other than 3, so JAX transposes it as torch's to
    (20, 3, 16), which is no WIO kernel of this model. The port reads the
    layout from its own shapes."""
    jm, pm, flat = pair
    w = flat["encoder.conv1.weight"]                    # WIO (3, 20, 16)
    mlx = np.transpose(w, (2, 0, 1))                    # (16, 3, 20)
    assert np.asarray(jm.sanitize({"encoder.conv1.weight": mlx})[
        "encoder.conv1.weight"]).shape == (20, 3, 16)
    np.testing.assert_array_equal(
        pm.sanitize({"encoder.conv1.weight": mlx})["encoder.conv1.weight"],
        w)


def test_routed_from_a_directory(pair, tmp_path):
    """A directory of config.json (model_type smart_turn) and HF-named
    weights loads through the top-level router and the VAD loader as Smart
    Turn, with JAX's probabilities."""
    import jax.numpy as jnp

    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.vad.models.smart_turn import Model
    from mlx_audio_tpu_torch.vad.utils import load_model

    jm, _, flat = pair
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "smart_turn", **CFG}))
    np.savez(tmp_path / "model.npz", **_hf_names(flat))
    mel = np.random.RandomState(4).randn(1, 100, 20).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(mel)))
    for m in (mlx_audio_tpu_torch.load_model(tmp_path, device="cpu"),
              load_model(tmp_path, device="cpu")):
        assert type(m) is Model
        np.testing.assert_allclose(m(mel).numpy(), want, atol=ATOL)


def test_defaults_to_the_card():
    """The default device is the card: without CUDA it raises before any
    parameter is built."""
    from mlx_audio_tpu_torch.vad.models.smart_turn import Model

    if torch.cuda.is_available():
        assert Model(CFG).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(CFG)
