"""The PyTorch port stands without JAX and builds nothing at import.

The port imports neither jax nor anything of the JAX package
`mlx_audio_tpu`, not even its jax-free host code (it keeps its own copies):
a static check reads every import of its sources, and the runtime checks
run in a fresh interpreter, so nothing the test process has already
imported (the test suite imports jax) can hide an import. Its entry points
build on the card by default and raise without CUDA.
"""

import ast
import glob
import inspect
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's sources: its package, chip_smoke.py, the test fixtures it
# loads and its profiling tools
PORT_SOURCES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "mlx_audio_tpu_torch", "**", "*.py"),
              recursive=True)
    + [os.path.join(REPO, "chip_smoke.py"),
       os.path.join(REPO, "tests", "torch_tts_fixtures.py"),
       os.path.join(REPO, "tools", "profile_torch_qwen3_tts.py"),
       os.path.join(REPO, "tools", "profile_torch_whisper.py"),
       os.path.join(REPO, "tools", "profile_torch_voxtral.py"),
       os.path.join(REPO, "tools", "profile_torch_cohere.py"),
       os.path.join(REPO, "tools", "kugel_chunk_sweep.py")])
# modules of the port's fresh-interpreter runs that must stay unimported
FORBIDDEN = """sorted(m for m in sys.modules if m in ("jax", "mlx_audio_tpu")
                or m.startswith(("jax.", "mlx_audio_tpu.")))"""


def _forbidden(module: str) -> bool:
    return (module in ("jax", "mlx_audio_tpu")
            or module.startswith(("jax.", "mlx_audio_tpu.")))


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_source_imports_nothing_of_jax(path):
    """No import statement of the port names jax or the JAX package."""
    tree = ast.parse(open(os.path.join(REPO, path), encoding="utf-8").read())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            if _forbidden(node.args[0].value):
                bad.append(node.args[0].value)
    assert not bad, f"{path} imports {bad}"


def _run(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_tiny_synth_without_jax():
    """Import the port, synthesize on the CPU at a tiny size, and find no
    jax in sys.modules."""
    out = _run("""
        import sys
        import numpy as np
        from mlx_audio_tpu_torch.tts.models.kokoro import Model, ModelConfig

        cfg = ModelConfig(
            istftnet=dict(resblock_kernel_sizes=[3], upsample_rates=[4, 4],
                          upsample_initial_channel=16,
                          resblock_dilation_sizes=[[1, 3, 5]],
                          upsample_kernel_sizes=[8, 8], gen_istft_n_fft=12,
                          gen_istft_hop_size=3),
            dim_in=16, hidden_dim=32, n_layer=2, n_mels=20, n_token=40,
            style_dim=16, decoder_bottleneck=24, decoder_res_dim=8,
            plbert=dict(num_hidden_layers=2, num_attention_heads=2,
                        hidden_size=24, intermediate_size=32,
                        max_position_embeddings=128, embedding_size=12),
            vocab={c: i + 1 for i, c in enumerate("abcdefgh ")})
        model = Model(cfg, device="cpu").init_params(seed=0)
        audio, dur = model("abc def", np.zeros((1, 32), np.float32),
                           deterministic_noise=True)
        assert audio.shape == (int(dur.sum()) * model.samples_per_frame,)
        assert np.isfinite(audio).all()
        print("jax" in sys.modules, %s)
    """ % FORBIDDEN)
    assert out.strip() == "False []", out


def test_tiny_higgs_generate_without_jax():
    """Higgs Audio v2 on the CPU at a tiny size with a bound tiny codec:
    a greedy smart-voice request, a voice clone from audio (the codec's
    encode through the wav2vec2/HuBERT branch) and the W8A8 layout, with no
    jax in sys.modules."""
    out = _run("""
        import sys
        import numpy as np
        from chip_smoke import HIGGS_SMALL, HiggsTok
        from mlx_audio_tpu_torch.codec.models.higgs_audio import Model as Codec
        from mlx_audio_tpu_torch.tts.models.higgs_audio import Model
        from mlx_audio_tpu_torch.utils import apply_quantization

        cfg = dict(HIGGS_SMALL)
        cfg["text_config"] = dict(cfg["text_config"], hidden_size=64,
                                  intermediate_size=128)
        model = Model(cfg, device="cpu").init_params(seed=0)
        model.tokenizer = HiggsTok()
        model.codec = Codec(dict(
            codebook_size=64, codebook_dim=4, dac_num_codebooks=4,
            dac_encoder_ratios=[2, 3], dac_encoder_hidden=4,
            dac_decoder_hidden=16, latent_dim=24, fusion_dim=8,
            downsample_factor=20, semantic_model_config=dict(
                hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=32, conv_dim=[16, 16], conv_kernel=[10, 8],
                conv_stride=[5, 4], num_feat_extract_layers=2)),
            device="cpu").init_params(seed=1)
        r = next(model.generate("hello", temperature=0.0, max_new_frames=16))
        assert r.samples == r.token_count * 6 > 0
        assert np.isfinite(r.audio).all()
        ref = np.random.RandomState(0).randn(4800).astype(np.float32) * 0.1
        r = next(model.generate("clone", ref_audio=ref, temperature=0.0,
                                max_new_frames=16))
        assert np.isfinite(r.audio).all()
        apply_quantization(model, {"quantization": {
            "bits": 8, "group_size": 64, "mxu_int8": True}},
            model.model_quant_predicate)
        r = next(model.generate("hello", temperature=0.7, max_new_frames=16))
        assert np.isfinite(r.audio).all()
        print("jax" in sys.modules, %s)
    """ % FORBIDDEN)
    assert out.strip() == "False []", out


def test_tiny_qwen3_tts_generate_without_jax():
    """Qwen3-TTS on the CPU at a tiny size, quantized to 8 bits: seeded
    weights, text ids -> audio, streamed, and one continuous-batching
    session step, with no jax in sys.modules."""
    out = _run("""
        import sys
        import numpy as np
        from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model, ModelConfig
        from mlx_audio_tpu_torch.utils import apply_quantization

        cfg = ModelConfig(
            talker_config=dict(
                vocab_size=300, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=8, num_code_groups=4,
                text_hidden_size=48, text_vocab_size=500,
                codec_eos_token_id=280, codec_think_id=284,
                codec_nothink_id=285, codec_think_bos_id=286,
                codec_think_eos_id=287, codec_pad_id=278, codec_bos_id=279,
                code_predictor_config=dict(
                    vocab_size=256, hidden_size=32, intermediate_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=8, num_code_groups=4)),
            tokenizer_config=dict(decoder_config=dict(
                latent_dim=32, codebook_dim=16, codebook_size=256,
                decoder_dim=64, hidden_size=24, intermediate_size=48,
                head_dim=8, num_attention_heads=3, num_hidden_layers=2,
                num_key_value_heads=3, num_quantizers=4,
                num_semantic_quantizers=1, sliding_window=16,
                upsample_rates=[4, 3], upsampling_ratios=[2, 2])),
            tts_bos_token_id=497, tts_eos_token_id=498, tts_pad_token_id=499)
        model = Model(cfg, device="cpu").init_params(seed=0)
        apply_quantization(model, {"quantization": {"bits": 8,
                                                    "group_size": 16}},
                           model.model_quant_predicate)
        (r,) = model.generate(text_ids=np.arange(10, 30)[None],
                              temperature=0.9, max_tokens=12, seed=0)
        assert r.samples == r.token_count * model.total_upsample > 0
        assert np.isfinite(r.audio).all()
        chunks = list(model.generate(text_ids=np.arange(10, 30)[None],
                                     temperature=0.9, max_tokens=12,
                                     stream=True, streaming_interval=0.4))
        assert chunks[-1].is_final_chunk
        assert sum(c.samples for c in chunks) %% model.total_upsample == 0
        from mlx_audio_tpu_torch.server_inference import InferenceRequest
        from mlx_audio_tpu_torch.tts.continuous import TTSBatchOptions
        assert model.supports_tts_continuous_batch()
        sess = model.create_tts_batch_session(TTSBatchOptions(
            max_batch_size=2, max_tokens=12, streaming_interval=0.4))
        sess.submit(InferenceRequest(
            endpoint_kind="tts", model_name="m", payload=None,
            normalized_kwargs={"text_ids": np.arange(10, 30)[None]}))
        sess.step()
        assert sess.t > 0 and len(sess.codes[0]) > 0
        print("jax" in sys.modules, %s)
    """ % FORBIDDEN)
    assert out.strip() == "False []", out


def test_tiny_whisper_generate_and_cli_without_jax(tmp_path):
    """Whisper on the CPU at a tiny size from seeded weights: a WAV through
    `generate` with word timestamps, the streaming session, and a
    checkpoint directory (HF names, npz, written by chip_smoke.py's
    writer) through the STT CLI in a second fresh interpreter, with no jax
    in either's sys.modules."""
    out = _run("""
        import json, sys
        from pathlib import Path
        import numpy as np
        from mlx_audio_tpu_torch import audio_io
        from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions

        dims = ModelDimensions(n_mels=80, n_audio_ctx=100, n_audio_state=32,
                               n_audio_head=2, n_audio_layer=2, n_vocab=51865,
                               n_text_ctx=64, n_text_state=32, n_text_head=2,
                               n_text_layer=2)
        model = Model(dims, device="cpu").init_params(seed=0)
        tmp = Path(%r)
        audio_io.write(tmp / "a.wav", (np.random.RandomState(0).randn(48000)
                                       * 0.05).astype(np.float32), 16000)
        out = model.generate(str(tmp / "a.wav"), language="en",
                             temperature=0.0, word_timestamps=True)
        assert out.segments and all("words" in s for s in out.segments)
        streamed = list(model.generate_streaming(str(tmp / "a.wav")))
        assert streamed
        from chip_smoke import write_whisper_checkpoint

        write_whisper_checkpoint(model, tmp / "whisper-tiny")
        (tmp / "want.json").write_text(json.dumps(model.generate(
            str(tmp / "a.wav"), language="en", temperature=0.0).text))
        print("jax" in sys.modules, %s)
    """ % (str(tmp_path), FORBIDDEN))
    assert out.strip() == "False []", out
    # the CLI loads on the card by default: here it is pointed at the CPU
    out = _run("""
        import json, sys
        from pathlib import Path
        import mlx_audio_tpu_torch.stt.utils as stt_utils
        from mlx_audio_tpu_torch.stt import generate

        real = stt_utils.load_model
        stt_utils.load_model = lambda p: real(p, device="cpu")
        tmp = Path(%r)
        generate.main(["--model", str(tmp / "whisper-tiny"), "--audio",
                       str(tmp / "a.wav"), "--format", "json",
                       "--output-path", str(tmp / "out"), "--language", "en",
                       "--no-verbose"])
        got = json.loads((tmp / "out" / "transcription.json").read_text())
        assert got["text"] == json.loads((tmp / "want.json").read_text())
        assert got["segments"]
        print("jax" in sys.modules, %s)
    """ % (str(tmp_path), FORBIDDEN))
    assert out.strip() == "False []", out


def test_tiny_voxtral_generate_and_cli_without_jax(tmp_path):
    """Voxtral Realtime on the CPU at a tiny size from seeded weights:
    offline `generate` (whole and streamed), a live session, and a
    checkpoint directory (consolidated names, npz, tekken.json, written by
    chip_smoke.py's writer) through `load_model` and the STT CLI in a second
    fresh interpreter, with no jax in either's sys.modules."""
    out = _run("""
        import json, sys
        from pathlib import Path
        import numpy as np
        from mlx_audio_tpu_torch import audio_io
        from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
            Model, ModelConfig, TekkenTokenizer)
        from chip_smoke import VOXTRAL_SMALL, write_voxtral_checkpoint

        model = Model(ModelConfig.from_dict(VOXTRAL_SMALL),
                      device="cpu").init_params(seed=0)
        tmp = Path(%r)
        write_voxtral_checkpoint(model, tmp / "voxtral-tiny")
        model._tokenizer = TekkenTokenizer(str(tmp / "voxtral-tiny"
                                               / "tekken.json"))
        audio = (np.random.RandomState(0).randn(24000) * 0.1).astype(
            np.float32)
        audio_io.write(tmp / "a.wav", audio, 16000)
        out = model.generate(str(tmp / "a.wav"))
        assert out.text and "".join(model.generate(
            str(tmp / "a.wav"), stream=True)).strip() == out.text
        sess = model.create_streaming_session()
        sess.feed(audio)
        sess.close()
        while not sess.done:
            sess.step(max_decode_tokens=8)
        assert sess.text.strip() == out.text
        (tmp / "want.json").write_text(json.dumps(out.text))
        print("jax" in sys.modules, %s)
    """ % (str(tmp_path), FORBIDDEN))
    assert out.strip() == "False []", out
    out = _run("""
        import json, sys
        from pathlib import Path
        import mlx_audio_tpu_torch.stt.utils as stt_utils
        from mlx_audio_tpu_torch.stt import generate

        real = stt_utils.load_model
        stt_utils.load_model = lambda p: real(p, device="cpu")
        tmp = Path(%r)
        generate.main(["--model", str(tmp / "voxtral-tiny"), "--audio",
                       str(tmp / "a.wav"), "--format", "json",
                       "--output-path", str(tmp / "out"), "--no-verbose"])
        got = json.loads((tmp / "out" / "transcription.json").read_text())
        assert got["text"] == json.loads((tmp / "want.json").read_text())
        print("jax" in sys.modules, %s)
    """ % (str(tmp_path), FORBIDDEN))
    assert out.strip() == "False []", out


def test_tiny_cohere_generate_and_cli_without_jax(tmp_path):
    """Cohere ASR on the CPU at a tiny size from seeded weights: `generate`
    and `transcribe`, and a checkpoint directory (NeMo names, npz,
    tokens.json, written by chip_smoke.py's writer) through `load_model`
    and the STT CLI in a second fresh interpreter, with no jax in either's
    sys.modules."""
    out = _run("""
        import json, sys
        from pathlib import Path
        import numpy as np
        from mlx_audio_tpu_torch import audio_io
        from chip_smoke import _cohere_small, write_cohere_checkpoint

        model = _cohere_small("cpu")
        tmp = Path(%r)
        write_cohere_checkpoint(model, tmp / "cohere-tiny")
        audio = (np.random.RandomState(0).randn(16000 * 3) * 0.5).astype(
            np.float32)
        audio_io.write(tmp / "a.wav", audio, 16000)
        out = model.generate(str(tmp / "a.wav"), max_tokens=12)
        assert out.text and len(out.segments) == 2
        assert model.transcribe(language="en", audio_files=[tmp / "a.wav"],
                                max_tokens=12) == [out.text]
        (tmp / "want.json").write_text(json.dumps(out.text))
        print("jax" in sys.modules, %s)
    """ % (str(tmp_path), FORBIDDEN))
    assert out.strip() == "False []", out
    out = _run("""
        import json, sys
        from pathlib import Path
        import mlx_audio_tpu_torch.stt.utils as stt_utils
        from mlx_audio_tpu_torch.stt import generate

        real = stt_utils.load_model
        stt_utils.load_model = lambda p: real(p, device="cpu")
        tmp = Path(%r)
        generate.main(["--model", str(tmp / "cohere-tiny"), "--audio",
                       str(tmp / "a.wav"), "--format", "json",
                       "--output-path", str(tmp / "out"), "--no-verbose",
                       "--max-tokens", "12"])
        got = json.loads((tmp / "out" / "transcription.json").read_text())
        assert got["text"] == json.loads((tmp / "want.json").read_text())
        print("jax" in sys.modules, %s)
    """ % (str(tmp_path), FORBIDDEN))
    assert out.strip() == "False []", out


def test_tiny_kugelaudio_and_vibevoice_generate_without_jax():
    """KugelAudio on the CPU at a tiny size (tests/test_kugelaudio.py's
    config, the lanes' forced-diffusion bias): a generate() at cfg_scale
    3.0 and one on the W8A8 LM; then VibeVoice's with its EOS classifier
    biased off; no jax in sys.modules."""
    out = _run("""
        import sys
        import numpy as np
        sys.path.insert(0, "tests")
        from torch_tts_fixtures import (force_diffusion, kugel_small,
                                        vibevoice_small)
        from mlx_audio_tpu_torch.nn import Int8Linear
        from mlx_audio_tpu_torch.utils import apply_quantization

        model = force_diffusion(kugel_small("cpu"))
        r = next(model.generate("hello there", cfg_scale=3.0, max_tokens=6,
                                ddpm_steps=4, seed=1))
        assert r.samples == 6 * 4 and np.isfinite(r.audio).all()
        apply_quantization(model, {"quantization": {
            "bits": 8, "group_size": 32, "mxu_int8": True}},
            model.model_quant_predicate)
        assert isinstance(model.language_model.model.layers[0].mlp.up_proj,
                          Int8Linear)
        r = next(model.generate("hello there", cfg_scale=3.0, max_tokens=4,
                                ddpm_steps=4, seed=1))
        assert r.samples == 4 * 4 and np.isfinite(r.audio).all()
        vv = vibevoice_small("cpu")
        r = next(vv.generate("hello there", max_tokens=6, seed=1))
        assert r.samples == 6 * 4 and np.isfinite(r.audio).all()
        print("jax" in sys.modules, %s)
    """ % FORBIDDEN)
    assert out.strip() == "False []", out


def test_every_module_imports_without_building():
    """Every module of the port imports on a machine without nvcc; the CUDA
    kernels are built only when first launched."""
    out = _run("""
        import importlib, pkgutil, sys
        import mlx_audio_tpu_torch as pkg

        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        from mlx_audio_tpu_torch.ops import cuda_build
        from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
        from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
        assert cuda_build._LOADED == {} and snake_conv_kernel._lib is None
        assert qmm_kernel._lib is None
        assert snake_conv_kernel.launches == 0 and qmm_kernel.launches == 0
        print(len(names), "jax" in sys.modules, not %s)
    """ % FORBIDDEN)
    n, has_jax, clean = out.split()
    assert int(n) >= 15 and has_jax == "False" and clean == "True", out


G2P_TEXTS = [
    "Hello world.",
    "",
    "   ",
    "The 7B model costs $2.5M, not $1,200.",
    "It's 10:30 am on Jan. 5th, 2024!",
    "Dr. Smith lives at 221B Baker St.",
    "Call 555-1234 or mail me@example.com today.",
    "3.14 is roughly pi; 1/2 is a half.",
    "Chapter IV covers the 1990s.",
    "Wait... what?! (Really?)",
    "50% of 1,200 people said \"no\" - twice.",
    "I'm sure you'll see the U.S.A. in 2030.",
]


@pytest.mark.parametrize("text", G2P_TEXTS)
def test_g2p_copy_matches_the_jax_package(text):
    """The port's copy of the built-in G2P (and the text normalisation it
    runs) gives the JAX package's phonemes."""
    from mlx_audio_tpu.tts.g2p import g2p as jax_g2p
    from mlx_audio_tpu_torch.tts.g2p import g2p

    assert g2p(text) == jax_g2p(text)


def _entry_points():
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.stt import utils as stt_utils
    from mlx_audio_tpu_torch.stt.models import (cohere_asr, voxtral_realtime,
                                                whisper)
    from mlx_audio_tpu_torch.tts import utils
    from mlx_audio_tpu_torch.tts.models import (kokoro, kugelaudio, llama,
                                                qwen3_tts, vibevoice)

    return {
        "kokoro.Model": (kokoro.Model.__init__,
                         lambda p: kokoro.Model(kokoro.ModelConfig())),
        "qwen3_tts.Model": (qwen3_tts.Model.__init__,
                            lambda p: qwen3_tts.Model(qwen3_tts.ModelConfig())),
        "whisper.Model": (whisper.Model.__init__,
                          lambda p: whisper.Model(whisper.ModelDimensions())),
        "voxtral_realtime.Model": (
            voxtral_realtime.Model.__init__,
            lambda p: voxtral_realtime.Model(voxtral_realtime.ModelConfig())),
        "cohere_asr.Model": (cohere_asr.Model.__init__,
                             lambda p: cohere_asr.Model(cohere_asr.ModelConfig())),
        "llama.Model": (llama.Model.__init__,
                        lambda p: llama.Model(llama.ModelConfig())),
        "kugelaudio.Model": (kugelaudio.Model.__init__,
                             lambda p: kugelaudio.Model(
                                 kugelaudio.ModelConfig())),
        "vibevoice.Model": (vibevoice.Model.__init__,
                            lambda p: vibevoice.Model(vibevoice.ModelConfig())),
        "tts.utils.load_model": (utils.load_model,
                                 lambda p: utils.load_model(p)),
        "stt.utils.load_model": (stt_utils.load_model,
                                 lambda p: stt_utils.load_model(p)),
        "mlx_audio_tpu_torch.load_model": (
            mlx_audio_tpu_torch.load_model,
            lambda p: mlx_audio_tpu_torch.load_model(p)),
    }


@pytest.mark.parametrize("name", ["kokoro.Model", "qwen3_tts.Model",
                                  "whisper.Model", "voxtral_realtime.Model",
                                  "cohere_asr.Model", "llama.Model",
                                  "kugelaudio.Model", "vibevoice.Model",
                                  "tts.utils.load_model",
                                  "stt.utils.load_model",
                                  "mlx_audio_tpu_torch.load_model"])
def test_entry_point_defaults_to_cuda_and_raises_without_it(name, tmp_path,
                                                            monkeypatch):
    """Each entry point defaults to device="cuda"; on a machine without
    CUDA it raises, naming device="cpu", before building anything (the
    model directory given here does not even exist)."""
    import torch

    fn, call = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call(tmp_path / "missing")
