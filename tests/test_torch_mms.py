"""MMS speech recognition and wav2vec2 language ID (MMS-LID) of the
PyTorch port against the JAX package, on the CPU: the cases of
tests/test_wav2vec2.py::TestMMS and ::TestLID (an HF CTC head and an HF
sequence classifier, here HF-named checkpoints through both packages'
sanitize; `ctc_collapse`, `generate` with a vocabulary, top-k ordering),
each held to the JAX package's: CTC ids
equal, probabilities within ATOL with equal top-k labels; the loaders (a
directory with an adapter and vocab.json through `stt.utils.load_model`;
an MMS-LID directory through the top-level router); and the port's strict
adapter merge (a departure).

Configs: tests/test_wav2vec2.py's `generate_with_vocab` tiny wav2vec2,
and the same with the stable layer norm and adapters of 4, as MMS-1b-all
has; one parameter set drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`). The JAX
package runs its own jitted forwards. Probabilities at ATOL = 2e-4 (f32,
summation order).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
SMALL = dict(vocab_size=6, hidden_size=16, num_hidden_layers=1,
             num_attention_heads=2, intermediate_size=32, conv_dim=(8, 8),
             conv_stride=(5, 2), conv_kernel=(10, 3),
             num_feat_extract_layers=2, num_conv_pos_embeddings=8,
             num_conv_pos_embedding_groups=4)
STABLE = dict(SMALL, do_stable_layer_norm=True, feat_extract_norm="layer",
              adapter_attn_dim=4, num_hidden_layers=2)
LABELS = {"0": "en", "1": "fr", "2": "de"}
AUDIO = np.random.RandomState(0).randn(4000).astype(np.float32)


def mms_pair(cfg, seed=0):
    from mlx_audio_tpu.stt.models.mms import Model as JModel
    from mlx_audio_tpu.stt.models.wav2vec import ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.mms import Model, ModelConfig

    jm = JModel(JConfig(**cfg))
    jm.bind(numpy_params(jm.init_params, seed))
    pm = load_jax_params(Model(ModelConfig(**cfg), device="cpu"),
                         flat_numpy(jm.params))
    return jm, pm


def lid_pair(cfg, seed=0):
    from mlx_audio_tpu.lid.models.wav2vec2 import Model as JModel
    from mlx_audio_tpu.lid.models.wav2vec2 import ModelConfig as JConfig
    from mlx_audio_tpu_torch.lid.models.wav2vec2 import Model, ModelConfig
    from mlx_audio_tpu_torch.model import load_jax_params

    jm = JModel(JConfig(**cfg))
    jm.bind(numpy_params(jm.init_params, seed))
    pm = load_jax_params(Model(ModelConfig(**cfg), device="cpu"),
                         flat_numpy(jm.params))
    return jm, pm


def lid_cfg(base=SMALL):
    cfg = dict(base, classifier_proj_size=8, id2label=dict(LABELS))
    cfg.pop("vocab_size")
    return cfg


# ---------------------------------------------------------------------------
# MMS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ids,length", [
    ([0, 3, 3, 0, 4, 4, 4, 2, 0, 0], 10), ([0, 3, 3, 0, 4, 4, 4, 2, 0, 0], 4),
    ([], 0), ([5, 5, 5], 3), ([1, 0, 1, 0, 1], 5)])
def test_ctc_collapse_equals_jax(ids, length):
    from mlx_audio_tpu.stt.models.mms import ctc_collapse as jax_collapse
    from mlx_audio_tpu_torch.stt.models.mms import ctc_collapse

    ids = np.asarray(ids, np.int64)
    assert ctc_collapse(ids, length) == jax_collapse(ids, length)


@pytest.mark.parametrize("cfg", [SMALL, STABLE], ids=["post-norm",
                                                      "stable+adapters"])
def test_ctc_ids_and_text_equal_jax(cfg):
    """Over two lengths (their buckets 16,000 and 48,000 samples): CTC ids
    equal; with a vocabulary, the text."""
    jm, pm = mms_pair(cfg)
    for n in (4000, 20000):
        audio = np.random.RandomState(n).randn(n).astype(np.float32)
        assert pm.transcribe_ids(audio) == jm.transcribe_ids(audio)
    assert pm.last_run["bucket"] == 48000
    vocab = {1: "a", 2: "b", 3: "|", 4: "c", 5: "d"}
    jm._vocab = pm._vocab = vocab
    out = pm.generate(AUDIO)
    assert out.text == jm.generate(AUDIO).text and out.total_time > 0


def hf_state(pm) -> dict:
    """The port model's weights as an HF checkpoint: torch layouts, the
    positional conv's weight as a weight-norm pair over its kernel axis
    (torch >= 2.1's parametrization form), and the training-only
    `masked_spec_embed`."""
    out = {k: v.numpy() for k, v in pm.state_dict().items()}
    w = out.pop("wav2vec2.encoder.pos_conv_embed.conv.weight")
    g = np.sqrt((w * w).sum(axis=(0, 1), keepdims=True))
    base = "wav2vec2.encoder.pos_conv_embed.conv.parametrizations.weight"
    out[base + ".original0"], out[base + ".original1"] = g, 2.0 * w
    out["wav2vec2.masked_spec_embed"] = np.zeros(pm.config.hidden_size,
                                                 np.float32)
    return out


def _jax_bound(jm, weights):
    import jax.numpy as jnp

    from mlx_audio_tpu.utils import unflatten

    jm.bind(unflatten({k: jnp.asarray(v) for k, v in
                       jm.sanitize(weights).items()}))
    return jm


@pytest.mark.parametrize("cfg", [SMALL, STABLE], ids=["post-norm",
                                                      "stable+adapters"])
def test_hf_checkpoint_sanitizes_as_jax(cfg):
    """An HF-named `Wav2Vec2ForCTC` checkpoint (a weight-norm pair, a
    training-only tensor) through both packages' sanitize: the CTC ids
    equal."""
    from mlx_audio_tpu.stt.models.mms import Model as JModel
    from mlx_audio_tpu.stt.models.wav2vec import ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.mms import Model, ModelConfig

    _, src = mms_pair(cfg, seed=3)
    hf = hf_state(src)
    pm = load_jax_params(Model(ModelConfig(**cfg), device="cpu"),
                         src.sanitize(hf))
    jm = _jax_bound(JModel(JConfig(**cfg)), hf)
    assert pm.transcribe_ids(AUDIO) == jm.transcribe_ids(AUDIO) == \
        src.transcribe_ids(AUDIO)


def _adapter(pm, seed: int) -> dict:
    """A language adapter under HF names: each layer's adapter_layer and
    the lm_head, drawn from `seed`."""
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*v.shape).astype(np.float32) * 0.1
            for k, v in pm.state_dict().items()
            if ".adapter_layer." in k or k.startswith("lm_head.")}


def write_mms_dir(pm, path, adapter: dict):
    """config.json, the weights and an `adapter.eng.safetensors` (HF
    names, safetensors), and a per-language vocab.json."""
    from safetensors.numpy import save_file

    path.mkdir()
    cfg = {k: (list(v) if isinstance(v, tuple) else v)
           for k, v in vars(pm.config).items()}
    (path / "config.json").write_text(json.dumps(dict(cfg,
                                                      model_type="wav2vec2")))
    save_file({k: v.numpy() for k, v in pm.state_dict().items()},
              str(path / "model.safetensors"))
    save_file({k.replace("wav2vec2.", "", 1): v for k, v in adapter.items()},
              str(path / "adapter.eng.safetensors"))
    (path / "vocab.json").write_text(json.dumps({
        "fra": {"<pad>": 0, "x": 1}, "eng": {"<pad>": 0, "a": 1, "b": 2,
                                             "|": 3, "c": 4, "d": 5}}))


def test_loader_merges_the_adapter_and_reads_vocab_as_jax(tmp_path):
    """`stt.utils.load_model` on an "mms-1b-all" directory: the adapter's
    weights are the model's, the "eng" vocabulary read; text equal to the
    JAX package's loaded from the same directory."""
    from mlx_audio_tpu.stt.utils import load_model as jax_load
    from mlx_audio_tpu_torch.stt.utils import load_model

    _, pm = mms_pair(STABLE)
    adapter = _adapter(pm, 5)
    write_mms_dir(pm, tmp_path / "mms-1b-all", adapter)
    m = load_model(tmp_path / "mms-1b-all", device="cpu")
    assert type(m).__module__.endswith("mms.mms")
    own = m.state_dict()
    for k, v in adapter.items():
        np.testing.assert_array_equal(own[k].numpy(), v)
    assert m._vocab[3] == "|" and len(m._vocab) == 6
    jm = jax_load(tmp_path / "mms-1b-all")
    assert m.generate(AUDIO).text == jm.generate(AUDIO).text


def test_adapter_merge_is_strict(tmp_path):
    """The departure: an adapter key the model lacks raises, naming it;
    JAX's merge drops it and loads the rest."""
    from mlx_audio_tpu.stt.models.mms import Model as JModel
    from mlx_audio_tpu.stt.utils import load_model as jax_load
    from mlx_audio_tpu_torch.stt.models.mms import Model

    jm, pm = mms_pair(STABLE)
    bad = dict(_adapter(pm, 6))
    bad["wav2vec2.encoder.layers.9.adapter_layer.linear_1.weight"] = \
        np.zeros((4, 16), np.float32)
    write_mms_dir(pm, tmp_path / "mms-bad", {})
    from safetensors.numpy import save_file
    save_file(bad, str(tmp_path / "mms-bad" / "adapter.eng.safetensors"))
    with pytest.raises(ValueError, match="layers.9.adapter_layer"):
        Model.post_load_hook(pm, tmp_path / "mms-bad")
    with pytest.raises(ValueError, match="shape"):
        pm.merge_adapter({"lm_head.weight": np.zeros((3, 16), np.float32)})
    JModel.post_load_hook(jax_load(tmp_path / "mms-bad"),
                          tmp_path / "mms-bad")


# ---------------------------------------------------------------------------
# wav2vec2 LID
# ---------------------------------------------------------------------------


def _assert_preds(got, want, k):
    assert [g[0] for g in got] == [w[0] for w in want] and len(got) == k
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               atol=ATOL)


@pytest.mark.parametrize("cfg", [SMALL, STABLE], ids=["post-norm",
                                                      "stable+adapters"])
def test_lid_probabilities_equal_jax(cfg):
    jm, pm = lid_pair(lid_cfg(cfg))
    for n, k in ((4000, 3), (20000, 2)):
        audio = np.random.RandomState(n).randn(n).astype(np.float32)
        got = pm.predict(audio, top_k=k)
        _assert_preds(got, jm.predict(audio, top_k=k), k)
        assert got[0][1] >= got[-1][1]
        assert all(p[0] in LABELS.values() for p in got)


def test_lid_hf_checkpoint_sanitizes_as_jax():
    """An HF-named `Wav2Vec2ForSequenceClassification` checkpoint through
    both packages' sanitize: the top-k and its probabilities equal."""
    from mlx_audio_tpu.lid.models.wav2vec2 import Model as JModel
    from mlx_audio_tpu.lid.models.wav2vec2 import ModelConfig as JConfig
    from mlx_audio_tpu_torch.lid.models.wav2vec2 import Model, ModelConfig
    from mlx_audio_tpu_torch.model import load_jax_params

    cfg = lid_cfg(STABLE)
    _, src = lid_pair(cfg, seed=4)
    hf = hf_state(src)
    pm = load_jax_params(Model(ModelConfig(**cfg), device="cpu"),
                         src.sanitize(hf))
    jm = _jax_bound(JModel(JConfig(**cfg)), hf)
    _assert_preds(pm.predict(AUDIO, top_k=3), jm.predict(AUDIO, top_k=3), 3)


def test_mms_lid_directory_routes_to_lid(tmp_path):
    """An "mms-lid-256" directory of model_type wav2vec2 (HF names): the
    top-level router sends it to the LID loader, as JAX's
    `get_model_category` does, and its top-k equals JAX's."""
    from mlx_audio_tpu.lid.utils import load_model as jax_load
    from mlx_audio_tpu_torch import load_model

    jm, pm = lid_pair(lid_cfg(STABLE))
    d = tmp_path / "mms-lid-256"
    d.mkdir()
    cfg = {k: (list(v) if isinstance(v, tuple) else v)
           for k, v in vars(pm.config).items()}
    (d / "config.json").write_text(json.dumps(dict(cfg,
                                                   model_type="wav2vec2")))
    np.savez(d / "model.npz", **{k: v.numpy()
                                 for k, v in pm.state_dict().items()})
    m = load_model(d, device="cpu")
    assert type(m).__module__.endswith("lid.models.wav2vec2.wav2vec2")
    _assert_preds(m.predict(AUDIO, top_k=3),
                  jax_load(d).predict(AUDIO, top_k=3), 3)
