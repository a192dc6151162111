"""ECAPA-TDNN language ID of the PyTorch port against the JAX package, on
the CPU: the ECAPA backbone (`codec/models/ecapa_tdnn`, with and without
the global context), SpeechBrain's log-mel front end, the LID model's
log-probabilities and tests/test_model_families.py::TestLidEcapa's top-k
`predict`, each held to the JAX package's; then `lid.utils.load_model`
and the top-level router on a tiny ECAPA directory, the LID registry
against the JAX package's.

Config: TestLidEcapa's (channels 32, embedding 16, attention 8, Res2Net
scale 4, SE 8, a 16-wide classifier over 5 languages); one parameter set
drawn with numpy over JAX's shapes (`test_torch_mimi.numpy_params`; the
batch norms' running statistics 1, as every 1-D leaf). The JAX side runs
jitted. Log-mel within 1e-3 dB (the port's DFT in float64, JAX's in
float32); embeddings, log-probabilities and probabilities at ATOL = 2e-4
(f32, summation order); top-k labels equal.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
CFG = dict(channels=32, embedding_dim=16, attention_channels=8,
           res2net_scale=4, se_channels=8, classifier_hidden_dim=16,
           num_classes=5,
           id2label={"0": "en: English", "1": "fr: French",
                     "2": "de: German", "3": "es: Spanish",
                     "4": "zh: Chinese"})
AUDIO = np.random.RandomState(0).randn(16000).astype(np.float32) * 0.1


@pytest.fixture(scope="module")
def pair():
    from mlx_audio_tpu.lid.models.ecapa_tdnn import Model as JModel
    from mlx_audio_tpu.lid.models.ecapa_tdnn import ModelConfig as JConfig
    from mlx_audio_tpu_torch.lid.models.ecapa_tdnn import Model, ModelConfig
    from mlx_audio_tpu_torch.model import load_jax_params

    jm = JModel(JConfig(**CFG))
    jm.bind(numpy_params(jm.init_params, 0))
    pm = load_jax_params(Model(ModelConfig(**CFG), device="cpu"),
                         flat_numpy(jm.params))
    return jm, pm


@pytest.mark.parametrize("global_context", [False, True])
def test_backbone_equals_jax(global_context):
    from mlx_audio_tpu.codec.models.ecapa_tdnn import EcapaTdnnConfig as JC
    from mlx_audio_tpu.codec.models.ecapa_tdnn import (ecapa_backbone as
                                                       jax_backbone)
    from mlx_audio_tpu.codec.models.ecapa_tdnn import init_ecapa_backbone
    from mlx_audio_tpu_torch.codec.models.ecapa_tdnn import (
        EcapaBackbone, EcapaTdnnConfig, ecapa_backbone)
    from mlx_audio_tpu_torch.model import TorchModel, load_jax_params

    kw = dict(input_size=12, channels=32, embed_dim=16, attention_channels=8,
              res2net_scale=4, se_channels=8, global_context=global_context)
    params = numpy_params(lambda k: init_ecapa_backbone(k, JC(**kw)), 1)
    p = TorchModel(None)
    p.b = EcapaBackbone(EcapaTdnnConfig(**kw)).requires_grad_(False)
    load_jax_params(p, {f"b.{k}": v for k, v in flat_numpy(params).items()})
    x = np.random.RandomState(2).randn(2, 40, 12).astype(np.float32)
    want = jax.jit(lambda q, x: jax_backbone(q, JC(**kw), x))(
        params, jnp.asarray(x))
    got = ecapa_backbone(p.b, EcapaTdnnConfig(**kw), torch.from_numpy(x))
    assert tuple(got.shape) == (2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n", [16000, 12345])
def test_log_mel_equals_jax(n):
    from mlx_audio_tpu.lid.models.ecapa_tdnn.ecapa_tdnn import \
        compute_mel_spectrogram as jax_mel
    from mlx_audio_tpu_torch.lid.models.ecapa_tdnn.ecapa_tdnn import \
        compute_mel_spectrogram

    audio = np.random.RandomState(n).randn(n).astype(np.float32) * 0.1
    got = compute_mel_spectrogram(audio).numpy()
    want = np.asarray(jax.jit(jax_mel)(audio))
    assert got.shape == want.shape == (1, 1 + n // 160, 60)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_log_probabilities_equal_jax(pair):
    import copy

    jm, pm = pair

    def log_probs(params, mel):
        m = copy.copy(jm)
        m.params = params
        return m(mel)

    mel = np.random.RandomState(3).randn(2, 50, 60).astype(np.float32)
    want = jax.jit(log_probs)(jm.params, jnp.asarray(mel))
    got = pm(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("k", [3, 5])
def test_predict_top_k_equals_jax(pair, k):
    """TestLidEcapa's predict: the labels (codes before the colon) and
    their order equal JAX's, the probabilities within ATOL."""
    jm, pm = pair
    got = pm.predict(AUDIO, top_k=k)
    want = jm.predict(AUDIO, top_k=k)
    assert [g[0] for g in got] == [w[0] for w in want] and len(got) == k
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               atol=ATOL)
    assert all(isinstance(lab, str) and 0 <= p <= 1 for lab, p in got)
    assert got[0][1] >= got[-1][1]
    assert pm.generate(AUDIO, top_k=k) == got


def write_ecapa_dir(jm, path):
    """config.json (model_type "ecapa_tdnn") and the JAX tree in npz, as
    the JAX package binds an ECAPA checkpoint."""
    path.mkdir()
    (path / "config.json").write_text(json.dumps(dict(
        CFG, model_type="ecapa_tdnn")))
    np.savez(path / "model.npz", **flat_numpy(jm.params))


def test_lid_loader_and_router_load_an_ecapa_directory(pair, tmp_path):
    """`lid.utils.load_model` and the top-level `load_model` (category
    "lid", from the model_type) on one directory: both predict as the JAX
    package's `lid.utils.load_model` does."""
    jm, pm = pair
    from mlx_audio_tpu.lid.utils import load_model as jax_load
    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.lid.utils import load_model as lid_load

    d = tmp_path / "voxlingua107-ecapa"
    write_ecapa_dir(jm, d)
    want = jax_load(d).predict(AUDIO, top_k=3)
    for m in (lid_load(d, device="cpu"), load_model(d, device="cpu")):
        assert type(m).__module__.endswith("lid.models.ecapa_tdnn.ecapa_tdnn")
        got = m.predict(AUDIO, top_k=3)
        assert [g[0] for g in got] == [w[0] for w in want]
        np.testing.assert_allclose([g[1] for g in got],
                                   [w[1] for w in want], atol=ATOL)


def test_lid_registry_and_unported_family(tmp_path):
    """The LID registry is the JAX package's and every family is ported; a
    family the registry lacks is named."""
    from mlx_audio_tpu.lid.utils import MODEL_REMAPPING as JAX_LID
    from mlx_audio_tpu_torch.lid.utils import (MODEL_REMAPPING, PORTED,
                                               load_model)

    assert MODEL_REMAPPING == JAX_LID
    assert set(PORTED) == set(JAX_LID.values())
    d = tmp_path / "x"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"model_type": "bark"}))
    with pytest.raises(ValueError, match="LID model type 'bark'.*not ported"):
        load_model(d, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_model(tmp_path / "missing", device="cpu")
