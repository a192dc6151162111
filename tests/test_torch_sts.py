"""The port's STS task layer on the CPU: the `load_model` router and the STS
loader on each ported family (Moshi, Mel-Band-RoFormer, DeepFilterNet; a
checkpoint directory as `chip_smoke.py` writes it), their registry and
model-type inference against the JAX package's, an unported STS family
named in the error, a loaded Moshi asking for its Mimi as JAX's does, the
STS CLI's WAV against in-process `generate` (and the keyword arguments it
passes on), and a Mel-Band-RoFormer separation through `AudioServer`.

Models: `chip_smoke`'s small configs (tests/test_moshi.py's,
tests/test_mel_roformer.py's and tests/test_deepfilternet.py's) at seeded
weights. Loaded parameters must equal the written ones; WAVs equal.
"""

import asyncio
import base64
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import chip_smoke  # noqa: E402

FAMILIES = {
    "moshi": ("moshi-tiny", chip_smoke._moshi_small,
              chip_smoke.write_moshi_checkpoint),
    "mel_roformer": ("mel-band-roformer-tiny", chip_smoke._mel_small,
                     chip_smoke.write_mel_checkpoint),
    "deepfilternet": ("deepfilternet-tiny", chip_smoke._dfn_small,
                      chip_smoke.write_dfn_checkpoint),
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Each family's tiny model and its checkpoint directory."""
    root = tmp_path_factory.mktemp("sts")
    out = {}
    for family, (name, make, write) in FAMILIES.items():
        model = make("cpu")
        write(model, root / name)
        out[family] = (model, root / name)
    return out


def test_registry_and_inference_equal_jax():
    from mlx_audio_tpu.sts import utils as jutils
    from mlx_audio_tpu_torch.sts import utils

    assert utils.MODEL_REMAPPING == jutils.MODEL_REMAPPING
    assert set(utils.PORTED) <= set(jutils.MODEL_REMAPPING.values())
    configs = [{"model_type": "sam_audio"}, {"audio_encoder_args": {}},
               {"dep_q": 8, "dim": 4096}, {"depformer": {}},
               {"df_order": 5}, {"erb_bands": 32},
               {"model_type": "mossformer2_se"}, {"model_type": "x"}, {}]
    for c in configs:
        assert utils.infer_model_type_from_config(c) == \
            jutils.infer_model_type_from_config(c)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_router_loads_each_family(checkpoints, family):
    """`load_model` finds the STS category and the family (from the
    config's model_type), loads on the CPU when asked, strictly, and gives
    back the written parameters."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.sts import utils
    from mlx_audio_tpu_torch.utils import get_model_category, load_config

    model, path = checkpoints[family]
    cfg = load_config(path)
    assert get_model_category(cfg["model_type"], []) == "sts"
    assert utils.model_family(cfg, path) == family
    loaded = mlx_audio_tpu_torch.load_model(path, device="cpu")
    assert type(loaded) is type(model) and loaded.device.type == "cpu"
    state = loaded.state_dict()
    assert set(state) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(state[k], v), k
    assert type(utils.load_model(path, device="cpu")) is type(model)


def test_raw_kyutai_config_is_inferred_as_moshi(tmp_path):
    """A kyutai config.json has no model_type: the STS loader infers Moshi
    from its `dep_q` (the JAX loader's rule) and reads the raw schema; the
    router finds the category from the directory's name."""
    import numpy as np

    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.sts import utils
    from mlx_audio_tpu_torch.sts.models.moshi import Model, ModelConfig

    raw = dict(dim=32, num_heads=4, num_layers=2, context=16,
               max_period=10000.0, depformer_dim=16, depformer_num_heads=2,
               depformer_num_layers=1, depformer_dim_feedforward=32, dep_q=4,
               text_card=63, card=64, n_q=8, delays=[0] + [0, 1, 1, 1] * 2)
    model = Model(ModelConfig.from_dict(raw), device="cpu").init_params(2)
    assert model.lm.config.transformer.gating_hidden == 88
    d = tmp_path / "moshi-raw"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(raw))
    np.savez(d / "model.npz", **{k: v.numpy() for k, v in
                                 model.lm.state_dict().items()})
    assert utils.model_family(raw, d) == "moshi"
    for loaded in (utils.load_model(d, device="cpu"),
                   mlx_audio_tpu_torch.load_model(d, device="cpu")):
        assert type(loaded) is Model and loaded.config.mimi_num_codebooks == 4
        for k, v in model.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), k


@pytest.mark.parametrize("model_type,family", [
    ("sam_audio", "sam_audio"), ("lfm_audio", "lfm_audio"),
    ("mossformer2", "mossformer2_se"), ("zonos2", "zonos2")])
def test_unported_sts_family_is_named(tmp_path, model_type, family):
    """No STS family is left unported: SAM-Audio, MossFormer2 and
    LFM2-Audio resolve to `sam_audio`, `mossformer2_se` and `lfm_audio`,
    and a config-only directory reaches that loader, which finds no
    weights. A family the port still lacks (zonos2, a TTS family) is
    named through the router."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.sts import utils

    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"model_type": model_type}))
    if family in utils.PORTED:
        assert utils.model_family({"model_type": model_type}, d) == family
        with pytest.raises(FileNotFoundError, match="No weight files"):
            mlx_audio_tpu_torch.load_model(d, device="cpu")
        return
    with pytest.raises(ValueError, match=f"'{family}'.*not ported"):
        mlx_audio_tpu_torch.load_model(d, device="cpu")


def test_loaded_moshi_asks_for_a_mimi(checkpoints):
    """JAX binds no Mimi at load (no post_load_hook): generate raises its
    message until `model.mimi` is set, then runs."""
    import mlx_audio_tpu_torch

    model, path = checkpoints["moshi"]
    loaded = mlx_audio_tpu_torch.load_model(path, device="cpu")
    audio = np.zeros(240, np.float32)
    with pytest.raises(ValueError, match="Bind a Mimi codec to model.mimi"):
        loaded.generate(audio)
    loaded.mimi = model.mimi
    out = loaded.generate(audio, text_temp=0.0, audio_temp=0.0)
    assert out.token_count == 10 and out.samples == 9 * 24


def _cli(monkeypatch, argv):
    from mlx_audio_tpu_torch.sts import generate, utils

    real = utils.load_model
    monkeypatch.setattr(utils, "load_model",
                        lambda path, **kw: real(path, **{**kw,
                                                         "device": "cpu"}))
    generate.main(argv)


@pytest.mark.parametrize("family,channels,sr", [
    ("deepfilternet", 1, 16000), ("mel_roformer", 2, 8000)])
def test_cli_writes_generates_wav(checkpoints, tmp_path, monkeypatch,
                                  family, channels, sr):
    """`python -m mlx_audio_tpu_torch.sts.generate --model <dir> --audio
    in.wav --output-path out.wav` writes the WAV of in-process generate()
    (Mel-Band-RoFormer's stereo stem as a stereo file)."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch import audio_io

    _, path = checkpoints[family]
    audio = chip_smoke._clip_audio(7, 0.5, sr, channels=channels)
    wav, out = tmp_path / "in.wav", tmp_path / "out.wav"
    audio_io.write(wav, audio.T if channels == 2 else audio, sr)
    _cli(monkeypatch, ["--model", str(path), "--audio", str(wav),
                       "--output-path", str(out), "--no-verbose"])
    res = mlx_audio_tpu_torch.load_model(path, device="cpu").generate(
        str(wav))
    res = np.asarray(getattr(res, "audio", res))
    buf = io.BytesIO()
    audio_io.write(buf, res.T if res.ndim == 2 else res, sr)
    assert out.read_bytes() == buf.getvalue()
    got, got_sr = audio_io.read(out, dtype="float32")
    assert got_sr == sr and (got.ndim == 2) == (channels == 2)


def test_cli_passes_on_only_what_generate_takes(monkeypatch, tmp_path):
    """As the JAX CLI: None values dropped, keywords filtered by the
    signature of `generate` unless it takes **kwargs."""
    from mlx_audio_tpu_torch.sts.generate import generate_sts

    seen = {}

    class Fixed:
        sample_rate = 8000

        def generate(self, audio, stream=None):
            seen.update(stream=stream)
            return np.zeros(80, np.float32)

    generate_sts("m", "a.wav", str(tmp_path / "o.wav"), model=Fixed(),
                 verbose=False, stream=True, chunk=3, version=None)
    assert seen == {"stream": True}
    assert (tmp_path / "o.wav").is_file()


def test_separation_through_the_server(checkpoints):
    """POST /v1/audio/separations with a Mel-Band-RoFormer directory: 200,
    the target equal to separate() of the same WAV and the residual the
    input less it; a directory of a family the port lacks (zonos2)
    answers 404 with the STS loader's message."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.server import AudioServer

    _, path = checkpoints["mel_roformer"]
    stereo = chip_smoke._clip_audio(8, 0.4, 8000, channels=2)
    buf = io.BytesIO()
    audio_io.write(buf, stereo.T, 8000)
    wav = buf.getvalue()
    unported = path.parent / "zonos2-tiny"
    unported.mkdir(exist_ok=True)
    (unported / "config.json").write_text(json.dumps(
        {"model_type": "zonos2"}))

    async def go():
        server = AudioServer(device="cpu")
        try:
            ok = await server.separate({"model": str(path)}, wav)
            missing = await server.separate({"model": str(unported)}, wav)
            return ok, missing
        finally:
            server.close()

    ok, missing = asyncio.run(go())
    assert ok.status == 200 and ok.json["sample_rate"] == 8000
    x, _ = audio_io.read(io.BytesIO(wav), dtype="float32")
    want = mlx_audio_tpu_torch.load_model(path, device="cpu").separate(x.T)
    out = io.BytesIO()
    audio_io.write(out, want.vocals.T, 8000)
    target, _ = audio_io.read(io.BytesIO(base64.b64decode(
        ok.json["target"])), dtype="float32")
    want_t, _ = audio_io.read(io.BytesIO(out.getvalue()), dtype="float32")
    np.testing.assert_array_equal(target, want_t)
    residual, _ = audio_io.read(io.BytesIO(base64.b64decode(
        ok.json["residual"])), dtype="float32")
    np.testing.assert_allclose(residual, x - want.vocals.T, atol=1e-4)
    assert missing.status == 404
    assert "'zonos2'" in missing.json["error"] \
        and "not ported" in missing.json["error"]
