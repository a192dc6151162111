"""The port's TTS CLI (`python -m mlx_audio_tpu_torch.tts.generate`) on the
CPU: tests/test_cli_flags.py::TestTTSFlags case for case, its flag
surface held to the JAX CLI's, and `generate_audio` on a tiny Kokoro
checkpoint written to disk, whose files equal the in-process model's
audio as 16-bit WAV (the same model, the same seeded noise); then
`--ref_audio/--ref_text` voice cloning on a tiny Qwen3-TTS checkpoint.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401


class TestTTSFlags:
    def test_model_specific_knobs(self):
        from mlx_audio_tpu_torch.tts.generate import parse_args

        a = parse_args([
            "--model", "m", "--text", "t", "--cfg_scale", "2.0",
            "--steps", "8", "--instruct", "warm voice",
            "--exaggeration", "0.4", "--gender", "female", "--pitch", "1.2",
            "--sigma", "0.5", "--use_zero_spk_emb", "--min_p", "0.05",
            "--stg_scale", "1.0", "--stg_block", "2",
            "--rescale_scale", "0.3", "--ddpm_steps", "30",
            "--gen_duration", "5.0", "--duration_multiplier", "1.1",
            "--prompt", "p", "--stream", "--save",
        ])
        assert a.cfg_scale == 2.0 and a.steps == 8
        assert a.instruct == "warm voice" and a.exaggeration == 0.4
        assert a.gender == "female" and a.pitch == 1.2
        assert a.sigma == 0.5 and a.use_zero_spk_emb
        assert a.min_p == 0.05 and a.stg_scale == 1.0 and a.stg_block == 2
        assert a.rescale_scale == 0.3 and a.ddpm_steps == 30
        assert a.gen_duration == 5.0 and a.duration_multiplier == 1.1
        assert a.prompt == "p" and a.stream and a.save
        assert a.device == "cuda"

    def test_unknown_knob_is_filtered_not_fatal(self, tmp_path):
        from mlx_audio_tpu_torch.tts.generate import generate_audio

        class FakeResult:
            audio = np.zeros(16, np.float32)
            sample_rate = 24000
            segment_idx = 0
            samples = 16
            audio_duration = "0.0s"
            prompt = {"tokens": 1, "tokens-per-sec": 1.0}
            audio_samples = {"samples": 16, "samples-per-sec": 1.0}
            real_time_factor = 0.0
            processing_time_seconds = 0.0
            peak_memory_usage = 0.0

        seen = {}

        class FakeModel:
            sample_rate = 24000

            def generate(self, text, voice=None, speed=1.0, lang_code="a",
                         temperature=0.7):
                seen.update(temperature=temperature)
                yield FakeResult()

        generate_audio("hi", model=FakeModel(), verbose=False,
                       output_path=str(tmp_path), cfg_scale=3.0,
                       gender="male", temperature=0.5)
        assert seen == {"temperature": 0.5}
        assert (tmp_path / "audio_000.wav").is_file()

    def test_flags_equal_the_jax_cli(self):
        """Every flag of the JAX CLI, with its default; the port adds
        --device."""
        from mlx_audio_tpu.tts.generate import parse_args as jax_args
        from mlx_audio_tpu_torch.tts.generate import parse_args

        want = vars(jax_args(["--text", "t"]))
        got = vars(parse_args(["--text", "t"]))
        assert got.pop("device") == "cuda"
        assert got == want


def test_cli_on_a_disk_checkpoint_writes_the_models_audio(tmp_path,
                                                          monkeypatch):
    """main() with --device cpu on a tiny Kokoro checkpoint: one WAV per
    segment, joined with --join_audio, each the in-process model's audio
    for that segment (written as 16-bit PCM)."""
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.tts.generate import main
    from mlx_audio_tpu_torch.tts.utils import load_model
    from test_torch_server import write_kokoro_checkpoint

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    write_kokoro_checkpoint(ckpt)
    text = "Hello world.\nA second line."
    main(["--model", str(ckpt), "--text", text, "--voice", "af_heart",
          "--output_path", str(tmp_path / "out"), "--device", "cpu",
          "--no-verbose"])
    main(["--model", str(ckpt), "--text", text, "--voice", "af_heart",
          "--output_path", str(tmp_path / "out"), "--device", "cpu",
          "--join_audio", "--file_prefix", "joined", "--no-verbose"])
    model = load_model(ckpt, device="cpu")
    want = [r.audio for r in model.generate(text, voice="af_heart")]
    files = sorted((tmp_path / "out").glob("audio_*.wav"))
    assert [f.name for f in files] == ["audio_000.wav", "audio_001.wav"]
    for f, audio in zip(files, want):
        got, sr = audio_io.read(str(f), dtype="float32")
        assert sr == 24000 and len(got) == len(audio)
        np.testing.assert_allclose(got, np.clip(audio, -1, 1), atol=2 / 32768)
    joined, _ = audio_io.read(str(tmp_path / "out" / "joined.wav"),
                              dtype="float32")
    np.testing.assert_allclose(joined, np.clip(np.concatenate(want), -1, 1),
                               atol=2 / 32768)


def test_cli_clones_a_voice_from_ref_audio(tmp_path, monkeypatch):
    """main() with --ref_audio (a WAV) and --ref_text on a tiny Qwen3-TTS
    checkpoint that holds the reference and speaker encoders: the WAV it
    writes is the in-process model's ICL audio for the same clip."""
    from chip_smoke import _qwen3_clone_small
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.tts.generate import main
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import qwen3_tts
    from mlx_audio_tpu_torch.tts.utils import load_model
    from mlx_audio_tpu_torch.utils import load_audio
    from test_qwen3_tts_icl import FakeTokenizer
    from test_torch_qwen3_tts_icl import write_cloning_checkpoint

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    write_cloning_checkpoint(_qwen3_clone_small("cpu"), ckpt)
    ref = (np.random.RandomState(6).randn(2400) * 0.3).astype(np.float32)
    audio_io.write(str(tmp_path / "ref.wav"), ref, 24000)
    monkeypatch.setattr(qwen3_tts, "local_tokenizer",
                        lambda path: FakeTokenizer())
    main(["--model", str(ckpt), "--text", "hi there", "--ref_audio",
          str(tmp_path / "ref.wav"), "--ref_text", "reference words",
          "--temperature", "0", "--max_tokens", "6", "--output_path",
          str(tmp_path / "out"), "--device", "cpu", "--no-verbose"])
    model = load_model(ckpt, device="cpu")
    (want,) = model.generate(
        "hi there", ref_audio=load_audio(str(tmp_path / "ref.wav"),
                                         sample_rate=24000),
        ref_text="reference words", temperature=0.0, max_tokens=6,
        top_p=0.9, top_k=50, repetition_penalty=1.0)
    assert model.last_run["ref_frames"] > 0
    got, sr = audio_io.read(str(tmp_path / "out" / "audio_000.wav"),
                            dtype="float32")
    assert sr == 24000 and len(got) == len(want.audio) > 0
    np.testing.assert_allclose(got, np.clip(want.audio, -1, 1),
                               atol=2 / 32768)
