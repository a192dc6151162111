"""The port's `load_model` router (`mlx_audio_tpu_torch/utils.py`) against
the JAX package's (`mlx_audio_tpu/utils.py:246-481`), on the CPU: the
category registries equal JAX's for every ported family, the name parts
and the category guessed as JAX guesses them, a `qwen3tts` config and a
directory named only by its family (Kokoro, Parakeet, Canary) reaching
their loaders, a wav2vec2 checkpoint routed by its name (MMS to STT,
MMS-LID to LID), and the port's own errors (local paths only; a family it
lacks, or a category that is none, named).
Nothing here is numeric.
"""

import json

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
NAMES = ["Kokoro-82M", "prince-canuma/Kokoro-82M",
         "Qwen3-TTS-12Hz-1.7B-Base", "Qwen3-TTS-12Hz-0.6B-CustomVoice-8bit",
         "whisper-large-v3-turbo", "Voxtral-Mini-3B-Realtime-2602",
         "cohere-transcribe-03-2026", "higgs-audio-v2-generation-3B-base",
         "kugelaudio-0-open", "VibeVoice-Realtime-0.5B", "silero-vad",
         "silero_vad", "mel-band-roformer-vocals", "ecapa-tdnn-lid",
         "sortformer-4spk", "bark-small", "my_dir", "tts-tiny", "stt-x",
         "parakeet-tdt-0.6b-v2", "canary-1b-flash", "smart-turn-v3",
         "sesame/csm-1b", "canopylabs/orpheus-3b-0.1-ft",
         "orpheus-3b-0.1-ft-4bit", "svara-tts-v1", "Qwen3-ASR-0.6B-8bit",
         "Qwen3-ForcedAligner-0.6B", "mega-asr-v1", "VyvoTTS-v0-Qwen3-0.6B",
         "Voxtral-Mini-3B-2507", "Qwen2-Audio-7B-Instruct-4bit",
         "GLM-ASR-Nano-2512", "granite-speech-3.3-2b", "VibeVoice-ASR"]

MODEL_TYPES = [None, "kokoro", "qwen3_tts", "qwen3tts", "whisper",
               "voxtral_realtime", "cohere_asr", "higgs_audio", "kugelaudio",
               "vibevoice_streaming", "silero_vad", "mel_band_roformer",
               "ecapa_tdnn", "sortformer", "bark", "llama", "csm", "sesame",
               "orpheus", "svara", "tada", "qwen3_asr", "qwen3_omni_moe",
               "qwen3_forced_aligner", "forced_aligner", "mega_asr",
               "qwen3", "vyvo", "vyvotts", "voxtral", "qwen2_audio",
               "qwen2audio", "glmasr", "glm_asr", "granite_speech", "granite",
               "vibevoice_asr", "vibevoiceasr", "nonsense"]


@pytest.mark.parametrize("category", ["tts", "stt", "sts", "lid", "vad"])
def test_remappings_equal_jax_for_every_ported_family(category):
    """Every JAX registry key whose family the port has maps the same in
    the port's registry; the port's registries are JAX's, whole."""
    import importlib

    jax_map = importlib.import_module(
        f"mlx_audio_tpu.{category}.utils").MODEL_REMAPPING
    port = importlib.import_module(f"mlx_audio_tpu_torch.{category}.utils")
    ported = {k: v for k, v in jax_map.items() if v in port.PORTED}
    assert ported and all(port.MODEL_REMAPPING[k] == v
                          for k, v in ported.items())
    assert port.MODEL_REMAPPING == jax_map
    assert set(port.PORTED) <= set(jax_map.values())


def test_unported_category_registries_equal_jax():
    """Every category of the JAX package has a loader in the port, `lid`
    the last; the router reads each category's registry from its loader,
    JAX's whole (LID's and STS's here)."""
    from mlx_audio_tpu.lid.utils import MODEL_REMAPPING as LID
    from mlx_audio_tpu.sts.utils import MODEL_REMAPPING as STS
    from mlx_audio_tpu.utils import _CATEGORIES
    from mlx_audio_tpu_torch import utils
    from mlx_audio_tpu_torch.lid.utils import MODEL_REMAPPING as PORT_LID
    from mlx_audio_tpu_torch.sts.utils import MODEL_REMAPPING

    assert utils.CATEGORIES == ("tts", "stt", "sts", "lid", "vad")
    assert set(utils.CATEGORIES) == set(_CATEGORIES)
    assert not hasattr(utils, "UNPORTED_REMAPPING")
    assert utils.category_remapping("lid") == PORT_LID == LID
    assert MODEL_REMAPPING == STS


@pytest.mark.parametrize("name", NAMES)
def test_name_parts_equal_jax(name):
    from pathlib import Path

    from mlx_audio_tpu.utils import get_model_name_parts as jax_parts
    from mlx_audio_tpu_torch.utils import get_model_name_parts

    assert get_model_name_parts(name) == jax_parts(name)
    assert get_model_name_parts(Path("/x") / name.split("/")[-1]) == \
        jax_parts(Path("/x") / name.split("/")[-1])


def _registered(model_type):
    """The one category whose JAX registry names `model_type`; None where
    none does, or two do (`voxtral`: TTS and STT; `wav2vec2`: STT and
    LID)."""
    import importlib

    named = [c for c in ("tts", "stt", "sts", "lid", "vad")
             if model_type in (remap := importlib.import_module(
                 f"mlx_audio_tpu.{c}.utils").MODEL_REMAPPING)
             or model_type in remap.values()]
    return named[0] if len(named) == 1 else None


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_category_equals_jax(model_type):
    """Over every name above: the category JAX's `get_model_category`
    finds, except that a model_type one registry alone names decides (the
    port's departure)."""
    from mlx_audio_tpu.utils import get_model_category as jax_category
    from mlx_audio_tpu.utils import get_model_name_parts
    from mlx_audio_tpu_torch.utils import get_model_category

    for name in NAMES:
        parts = get_model_name_parts(name)
        want = _registered(model_type) or jax_category(model_type, parts)
        assert get_model_category(model_type, parts) == want, \
            (model_type, name)


def test_model_type_outranks_the_directory_name():
    """A Voxtral Realtime checkpoint in a directory named for it: JAX's
    `get_model_category` lets the name part "voxtral" (a TTS key) win and
    sends it to the TTS loader; the port's goes by the model_type."""
    from mlx_audio_tpu.utils import get_model_category as jax_category
    from mlx_audio_tpu.utils import get_model_name_parts
    from mlx_audio_tpu_torch.utils import get_model_category

    parts = get_model_name_parts("Voxtral-Mini-3B-Realtime-2602")
    assert jax_category("voxtral_realtime", parts) == "tts"
    assert get_model_category("voxtral_realtime", parts) == "stt"
    assert get_model_category(None, parts) == jax_category(None, parts)


def _config_only(path, **config):
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(config))
    return path


@pytest.mark.parametrize("how", ["model_type", "directory name"])
def test_qwen3tts_reaches_the_qwen3_loader(tmp_path, monkeypatch, how):
    """A config-only directory whose model_type is JAX's alias "qwen3tts",
    or whose config has no model_type and whose name starts with the
    family, reaches the Qwen3-TTS loader through the router (before this,
    the port raised "not ported" for the alias and read only "kokoro" from
    a directory name). As in the JAX package, the first name part that
    names a family wins: "Qwen3-TTS-12Hz-..." alone would name "qwen3"."""
    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.tts import utils

    seen = []
    monkeypatch.setattr(utils, "_load_qwen3_tts",
                        lambda path, config, device: seen.append(path) or
                        "qwen3")
    if how == "model_type":
        d = _config_only(tmp_path / "ckpt", model_type="qwen3tts")
    else:
        d = _config_only(tmp_path / "qwen3_tts-12hz-tiny")
    assert load_model(d, device="cpu") == "qwen3"
    assert seen == [d]


def test_directory_named_only_by_its_family_loads(tmp_path):
    """A Kokoro checkpoint whose config.json has no model_type, in a
    directory named "kokoro-82m", loads through the router with no
    category given, and gives the model it was written from."""
    import dataclasses

    import torch

    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.tts.models.kokoro import Model, ModelConfig
    from tiny_configs import tiny_kokoro_config

    cfg = dataclasses.asdict(tiny_kokoro_config())
    model = Model(ModelConfig.from_dict(cfg), device="cpu").init_params(1)
    d = _config_only(tmp_path / "kokoro-82m", **cfg)
    np.savez(d / "model.npz", **{k: v.numpy() for k, v in
                                 model.state_dict().items()})
    loaded = load_model(d, device="cpu")
    assert type(loaded) is Model
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


@pytest.mark.parametrize("model_type,category,family", [
    ("qwen3_asr", "stt", "qwen3_asr"), ("qwen3_omni_moe", "stt", "qwen3_asr"),
    ("qwen3_forced_aligner", "stt", "qwen3_forced_aligner"),
    ("forced_aligner", "stt", "qwen3_forced_aligner"),
    ("mega_asr", "stt", "mega_asr"), ("qwen3", "tts", "qwen3"),
    ("vyvo", "tts", "qwen3"), ("vyvotts", "tts", "qwen3")])
def test_qwen3_lm_families_reach_their_loaders(tmp_path, model_type,
                                               category, family):
    """A config-only directory of each Qwen3 LM family's types is a
    checkpoint of JAX's category and family, ported now: it reaches its
    loader, which finds no weights."""
    import importlib

    from mlx_audio_tpu.utils import get_model_category as jax_category
    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.utils import resolve_family

    loader = importlib.import_module(f"mlx_audio_tpu_torch.{category}.utils")
    d = _config_only(tmp_path / "ckpt", model_type=model_type)
    assert jax_category(model_type, []) == category
    assert resolve_family(model_type, [], loader.MODEL_REMAPPING) == family
    assert family in loader.PORTED
    with pytest.raises(FileNotFoundError, match="No weight files"):
        load_model(d, device="cpu")


@pytest.mark.parametrize("model_type,family", [
    ("qwen2_audio", "qwen2_audio"), ("qwen2audio", "qwen2_audio"),
    ("glmasr", "glmasr"), ("glm_asr", "glmasr"),
    ("granite_speech", "granite_speech"), ("granite", "granite_speech"),
    ("vibevoice_asr", "vibevoice_asr"), ("vibevoiceasr", "vibevoice_asr")])
def test_llm_stt_families_reach_their_loaders(tmp_path, model_type, family):
    """A config-only directory of each LLM-decoder STT family's types is an
    STT checkpoint of that family in JAX's router, ported now: it reaches
    the STT loader, which finds no weights."""
    from mlx_audio_tpu.utils import get_model_category as jax_category
    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.stt import utils as stt_utils
    from mlx_audio_tpu_torch.utils import resolve_family

    d = _config_only(tmp_path / "ckpt", model_type=model_type)
    assert jax_category(model_type, []) == "stt"
    assert resolve_family(model_type, [],
                          stt_utils.MODEL_REMAPPING) == family
    assert family in stt_utils.PORTED
    with pytest.raises(FileNotFoundError, match="No weight files"):
        load_model(d, device="cpu")


def test_voxtral_type_is_tts_in_the_router_and_stt_in_its_loader(tmp_path):
    """model_type "voxtral" is a TTS key too (Voxtral TTS), which JAX's
    router reads first: the top-level router sends it to the TTS loader,
    where it is Voxtral-4B-TTS (ported now), which finds no weights, as
    JAX's loader does; the STT loader takes it as offline Voxtral."""
    from mlx_audio_tpu.utils import get_model_category as jax_category
    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.stt import utils as stt_utils
    from mlx_audio_tpu_torch.tts import utils as tts_utils

    d = _config_only(tmp_path / "ckpt", model_type="voxtral")
    assert jax_category("voxtral", []) == "tts"
    assert tts_utils.MODEL_REMAPPING["voxtral"] == "voxtral_tts" \
        and "voxtral_tts" in tts_utils.PORTED
    with pytest.raises(FileNotFoundError, match="No weight files"):
        load_model(d, device="cpu")
    assert "voxtral" in stt_utils.PORTED
    with pytest.raises(FileNotFoundError, match="No weight files"):
        stt_utils.load_model(d, device="cpu")


@pytest.mark.parametrize("name,family", [
    ("parakeet-tdt-0.6b-v2", "parakeet"), ("canary-1b-flash", "canary"),
    ("canary-1b-v2", "canary")])
def test_nemo_directories_reach_their_stt_loaders(tmp_path, monkeypatch,
                                                  name, family):
    """A config-only directory named for Parakeet or Canary, with no
    model_type, is an STT checkpoint of that family (the JAX package's
    routing) and reaches its loader, which finds no weights; before the
    families were ported the router raised "not ported"."""
    from mlx_audio_tpu.utils import get_model_category as jax_category
    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.stt import utils as stt_utils
    from mlx_audio_tpu_torch.utils import get_model_name_parts

    d = _config_only(tmp_path / name)
    parts = get_model_name_parts(d)
    assert jax_category(None, parts) == "stt"
    assert stt_utils.model_family({}, d) == family in stt_utils.PORTED
    with pytest.raises(FileNotFoundError, match="No weight files"):
        load_model(d, device="cpu")


@pytest.mark.parametrize("how", ["llama", "orpheus", "svara",
                                 "directory name"])
def test_llama_types_reach_the_orpheus_loader(tmp_path, monkeypatch, how):
    """model_type llama, orpheus or svara (JAX's registry: all the llama
    family), or a directory named for Orpheus with no model_type, reach the
    TTS loader's llama family (the Orpheus token-TTS)."""
    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.tts import utils

    seen = []
    monkeypatch.setattr(utils, "load_weights", lambda path: {})
    monkeypatch.setattr(utils, "_load_family",
                        lambda family, path, config, device, weights:
                        seen.append(family) or family)
    if how == "directory name":
        d = _config_only(tmp_path / "orpheus-3b-0.1-ft")
    else:
        d = _config_only(tmp_path / "ckpt", model_type=how)
    assert load_model(d, device="cpu") == "llama"
    assert seen == ["llama"]


def test_llama_with_acoustic_dim_is_tada(tmp_path, monkeypatch):
    """JAX's rule (mlx_audio_tpu/utils.py:339-341): a `llama` config that
    carries `acoustic_dim` is TADA. On a config-only directory the port's
    loader reaches TADA and fails for want of weights, as JAX's loader
    does."""
    from mlx_audio_tpu.utils import get_model_category as jax_category
    from mlx_audio_tpu.utils import load_model as jax_load
    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.tts import utils as tts_utils
    from mlx_audio_tpu_torch.utils import get_model_category

    d = _config_only(tmp_path / "ckpt", model_type="llama", acoustic_dim=64)
    assert get_model_category("llama", []) == jax_category("llama", []) \
        == "tts"
    with pytest.raises(FileNotFoundError, match="No weight files"):
        load_model(d, device="cpu")
    with pytest.raises(FileNotFoundError, match="No weight files"):
        jax_load(str(d))
    seen = []
    monkeypatch.setattr(tts_utils, "load_weights", lambda path: {})
    monkeypatch.setattr(tts_utils, "_load_family",
                        lambda family, *a: seen.append(family))
    load_model(d, device="cpu")
    assert seen == ["tada"]


def _write_ecapa(path):
    """A tiny ECAPA LID directory (config.json, the JAX tree in npz) from
    seeded port weights."""
    from mlx_audio_tpu_torch.lid.models.ecapa_tdnn import Model
    from mlx_audio_tpu_torch.model import jax_params

    cfg = dict(model_type="ecapa_tdnn", channels=16, embedding_dim=8,
               attention_channels=4, res2net_scale=4, se_channels=4,
               classifier_hidden_dim=8, num_classes=3)
    m = Model(cfg, device="cpu").init_params(seed=0)
    path.mkdir()
    (path / "config.json").write_text(json.dumps(cfg))
    np.savez(path / "model.npz",
             **{k: v.numpy() for k, v in jax_params(m).items()})
    return path


@pytest.mark.parametrize("name,want", [
    ("mms-lid-256", "lid"), ("facebook/mms-lid-4017", "lid"),
    ("mms-1b-all", "stt"), ("mms-1b-fl102", "stt")])
def test_wav2vec2_checkpoint_routes_by_its_name(name, want):
    """model_type `wav2vec2` is a key of both the STT registry (MMS) and
    the LID one (MMS-LID), so it does not decide alone: the name parts
    decide by JAX's precedence, as the JAX package's `get_model_category`
    does."""
    from mlx_audio_tpu.utils import get_model_category as jax_category
    from mlx_audio_tpu.utils import get_model_name_parts
    from mlx_audio_tpu_torch.utils import get_model_category

    parts = get_model_name_parts(name)
    assert get_model_category("wav2vec2", parts) == \
        jax_category("wav2vec2", parts) == want


def test_unported_category_and_family_are_named(tmp_path):
    from mlx_audio_tpu_torch import load_model

    tts = _config_only(tmp_path / "a", model_type="zonos2")
    with pytest.raises(ValueError, match="'zonos2'.*not ported"):
        load_model(tts, device="cpu")
    lid = _write_ecapa(tmp_path / "b")
    assert type(load_model(lid, device="cpu")).__module__.endswith(
        "lid.models.ecapa_tdnn.ecapa_tdnn")
    bark = _config_only(tmp_path / "c", model_type="bark")
    with pytest.raises(ValueError, match="'bark'.*not ported"):
        load_model(bark, device="cpu")
    dia = _config_only(tmp_path / "d", model_type="dia")
    with pytest.raises(ValueError, match="'dia'.*not ported"):
        load_model(dia, device="cpu")
    with pytest.raises(ValueError, match="category"):
        load_model(_config_only(tmp_path / "e", model_type="nonsense"),
                   device="cpu")
    # an explicit category whose loader lacks the family; one that is no
    # category
    with pytest.raises(ValueError, match="LID model type 'bark'.*not ported"):
        load_model(bark, category="lid", device="cpu")
    with pytest.raises(ValueError, match="Unknown model category 'foo'"):
        load_model(bark, category="foo", device="cpu")
    # an explicit category the port has, whose loader lacks the family
    with pytest.raises(ValueError, match="STS model type 'bark'.*not ported"):
        load_model(bark, category="sts", device="cpu")


def test_paths_are_local_only(tmp_path):
    """The JAX package downloads a name it cannot find locally; the port
    raises, saying it never downloads."""
    from mlx_audio_tpu_torch import load_model

    for name in ("prince-canuma/Kokoro-82M", str(tmp_path / "missing")):
        with pytest.raises(FileNotFoundError, match="never downloads"):
            load_model(name, device="cpu")
