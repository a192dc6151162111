"""The PyTorch port stands without JAX and builds nothing at import.

The port imports neither jax nor anything of the JAX package
`mlx_audio_tpu`, not even its jax-free host code (it keeps its own copies):
a static check reads every import of its sources, and the runtime checks
run in fresh processes forked from a clean interpreter (`_run`), so
nothing the test process has already imported (the test suite imports
jax) can hide an import. Its entry points
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


# The fresh-interpreter runs share one module-scoped child, a zygote: it
# starts once, imports torch and numpy (nothing of the port, jax or the JAX
# package), and forks a process per run, which executes the run's code as
# __main__ with its own stdout and stderr, so each run starts from the
# zygote's clean state and no run sees another's imports or patches. The
# runs use one torch thread each (OMP_NUM_THREADS=1 in the zygote's
# environment, before torch is imported): the suite runs six workers on
# the box's cores, and a run of the default thread count would contend
# with them. With one thread the zygote runs no other thread, which a fork
# needs; it checks that before serving.
ZYGOTE = r"""
import json, os, signal, sys, time, traceback
import numpy, torch

if os.path.isdir("/proc/self/task") and len(os.listdir("/proc/self/task")) > 1:
    raise SystemExit("the zygote runs more than one thread: no fork")
for line in sys.stdin:
    job = json.loads(line)
    pid = os.fork()
    if pid == 0:
        for fd, path in ((1, job["out"]), (2, job["err"])):
            os.dup2(os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC), fd)
        sys.stdout = os.fdopen(1, "w")
        sys.stderr = os.fdopen(2, "w")
        rc = 0
        try:
            exec(compile(job["code"], "<run>", "exec"),
                 {"__name__": "__main__"})
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else (e.code is not None)
        except BaseException:
            traceback.print_exc()
            rc = 1
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    end = time.monotonic() + job["timeout"]
    while True:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            rc = os.waitstatus_to_exitcode(status)
            break
        if time.monotonic() > end:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
            rc = "timeout"
            break
        time.sleep(0.02)
    print(json.dumps(rc), flush=True)
"""
_zygote = None


@pytest.fixture(autouse=True, scope="module")
def _stop_zygote():
    yield
    global _zygote
    if _zygote is not None:
        _zygote.stdin.close()
        _zygote.wait(timeout=60)
        _zygote = None


def _run(code: str, timeout: int = 300) -> str:
    """Run `code` in a fresh process forked from the zygote (cwd the
    repository); -> its stdout. A run that fails or outlasts `timeout`
    fails the test with its stderr."""
    import json
    import tempfile

    global _zygote
    if _zygote is None:
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        _zygote = subprocess.Popen([sys.executable, "-c", ZYGOTE], cwd=REPO,
                                   env=env, stdin=subprocess.PIPE,
                                   stdout=subprocess.PIPE, text=True)
    with tempfile.TemporaryDirectory() as tmp:
        out, err = os.path.join(tmp, "out"), os.path.join(tmp, "err")
        _zygote.stdin.write(json.dumps({"code": textwrap.dedent(code),
                                        "out": out, "err": err,
                                        "timeout": timeout}) + "\n")
        _zygote.stdin.flush()
        rc = json.loads(_zygote.stdout.readline())
        stdout = open(out).read() if os.path.exists(out) else ""
        stderr = open(err).read() if os.path.exists(err) else ""
    assert rc == 0, f"rc {rc}: {stderr[-3000:]}"
    return stdout


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


def test_tiny_voice_cloning_generate_without_jax():
    """Voice cloning on the CPU at a tiny size, with no jax in sys.modules:
    a Qwen3-TTS ICL request (the Mimi reference encoder and the ECAPA
    x-vector), an x-vector-only one, and a Sesame request cloning a
    reference segment through a Mimi codec, whole and streamed."""
    out = _run("""
        import sys
        import numpy as np
        from chip_smoke import (MIMI_SMALL, SESAME_SMALL, CharTok,
                                _qwen3_clone_small)
        from mlx_audio_tpu_torch.codec import Mimi
        from mlx_audio_tpu_torch.tts.models.sesame import Model

        ref = (np.random.RandomState(0).randn(2400) * 0.3).astype(np.float32)
        qwen3 = _qwen3_clone_small("cpu")
        (r,) = qwen3.generate("hi there", ref_audio=ref,
                              ref_text="reference words", temperature=0.0,
                              max_tokens=6)
        assert qwen3.last_run["ref_frames"] == 100
        assert r.samples == 6 * qwen3.total_upsample
        (x,) = qwen3.generate("hi there", ref_audio=ref, temperature=0.0,
                              max_tokens=6)
        assert np.isfinite(r.audio).all() and np.isfinite(x.audio).all()
        sesame = Model(SESAME_SMALL, device="cpu").init_params(seed=0)
        sesame.tokenizer = CharTok()
        sesame.set_codec(Mimi(dict(MIMI_SMALL, quantizer_bins=40),
                              device="cpu").init_params(seed=1))
        kw = dict(ref_audio=ref[:1200], ref_text="a reference",
                  temperature=0.0, max_audio_length_ms=800)
        (whole,) = sesame.generate("hello", **kw)
        parts = list(sesame.generate("hello", stream=True,
                                     streaming_interval=0.2, **kw))
        streamed = np.concatenate([p.audio for p in parts])
        assert whole.prompt["codes"].shape == (10, 4)
        assert np.abs(streamed - whole.audio).max() < 1e-5
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


def test_tiny_parakeet_canary_nemotron_generate_without_jax(tmp_path):
    """The NeMo ASR families on the CPU at a tiny size from seeded weights
    (chip_smoke.py's small configs): a Parakeet TDT generate, whole and in
    overlapping windows, a Parakeet checkpoint directory through
    `load_model`, a Canary and a Nemotron generate, with no jax in
    sys.modules."""
    out = _run("""
        import sys
        from pathlib import Path
        import numpy as np
        import mlx_audio_tpu_torch
        from chip_smoke import (_canary_small, _nemotron_small,
                                _parakeet_small, write_parakeet_checkpoint)

        audio = (np.random.RandomState(0).randn(48000) * 0.1).astype(
            np.float32)
        model = _parakeet_small("tdt", "cpu")
        whole = model.generate(audio[:16000])
        assert whole.text and len(whole.segments) == whole.generation_tokens
        long = model.generate(audio, chunk_duration=1.5, overlap_duration=0.5)
        assert long.text and model.last_run["windows"] == 3
        path = Path(%r) / "parakeet-tdt-tiny"
        write_parakeet_checkpoint(model, path)
        loaded = mlx_audio_tpu_torch.load_model(path, device="cpu")
        assert loaded.generate(audio[:16000]).text == whole.text
        assert _canary_small("cpu").generate(audio[:16000],
                                             max_tokens=8).text
        assert _nemotron_small("cpu").generate(audio[:16000]).text
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


def test_tiny_orpheus_and_convert_without_jax(tmp_path):
    """Orpheus on the CPU at a tiny size (the full 156,938-id vocabulary,
    a stand-in tokenizer, a tiny SNAC): a greedy generate whole and
    streamed; then the convert CLI on it in 4 bits, reloaded through
    `load_model`; no jax in sys.modules."""
    out = _run("""
        import json, sys
        from pathlib import Path
        import numpy as np
        import torch
        from mlx_audio_tpu_torch.codec.models.snac import SNAC
        from mlx_audio_tpu_torch.convert import convert
        from mlx_audio_tpu_torch.model import jax_params
        from mlx_audio_tpu_torch.nn import QuantizedLinear
        from mlx_audio_tpu_torch.tts.models.llama import Model, orpheus
        from mlx_audio_tpu_torch.tts.utils import load_model

        class Tok:
            eos_token_id = 128001
            def encode(self, text):
                return [ord(c) %% 100 + 10 for c in text]

        cfg = dict(model_type="llama", hidden_size=64, num_hidden_layers=1,
                   intermediate_size=128, num_attention_heads=4,
                   num_key_value_heads=2, vocab_size=128266 + 7 * 4096)
        m = Model(cfg, device="cpu").init_params(0)
        m.tokenizer = Tok()
        m.set_codec(SNAC(dict(encoder_dim=16, encoder_rates=[2, 2],
                              decoder_dim=32, decoder_rates=[2, 2],
                              vq_strides=[4, 2, 1], attn_window_size=None),
                         device="cpu").init_params(1))
        (r,) = m.generate("hi", temperature=0.0, max_tokens=21)
        assert r.samples > 0 and np.isfinite(r.audio).all()
        chunks = list(m.generate("hi", temperature=0.0, max_tokens=21,
                                 stream=True, streaming_interval=0.05))
        assert sum(c.samples for c in chunks) > 0
        src = Path(%r) / "src"
        src.mkdir()
        from safetensors.torch import save_file
        save_file(jax_params(m), str(src / "model.safetensors"))
        (src / "config.json").write_text(json.dumps(
            dict(cfg, converted_by="mlx_audio_tpu.convert")))
        out = convert(str(src), str(Path(%r) / "q4"), quantize=True,
                      q_bits=4, device="cpu")
        q = load_model(out, device="cpu")
        assert sum(isinstance(x, QuantizedLinear) for x in q.modules()) == 8
        print("jax" in sys.modules, %s)
    """ % (str(tmp_path), str(tmp_path), FORBIDDEN))
    assert out.strip().splitlines()[-1] == "False []", out


QWEN3_LM_SOURCES = (
    "mlx_audio_tpu_torch/stt/models/qwen3_lm.py",
    "mlx_audio_tpu_torch/stt/models/qwen3_asr/qwen3_asr.py",
    "mlx_audio_tpu_torch/stt/models/qwen3_asr/forced_aligner.py",
    "mlx_audio_tpu_torch/stt/models/qwen3_forced_aligner/__init__.py",
    "mlx_audio_tpu_torch/stt/models/mega_asr/router.py",
    "mlx_audio_tpu_torch/stt/models/mega_asr/lora.py",
    "mlx_audio_tpu_torch/stt/models/mega_asr/mega_asr.py",
    "mlx_audio_tpu_torch/tts/models/moss_tts/moss_tts.py",
    "mlx_audio_tpu_torch/tts/models/qwen3/qwen3.py")


def test_qwen3_lm_families_are_checked_statically():
    """The Qwen3 LM families' modules are among the sources whose imports
    `test_source_imports_nothing_of_jax` checks."""
    assert set(QWEN3_LM_SOURCES) <= set(PORT_SOURCES)


def test_tiny_qwen3_lm_families_without_jax(tmp_path):
    """Qwen3-ASR on the CPU at a tiny size, in f32 and on an affine-q8 LM
    (group 16), a greedy generate whole and streamed; the forced aligner
    and MegaASR (its router and a LoRA toggle) on the same stack; VyvoTTS
    over a tiny SNAC, whole and streamed; no jax in sys.modules."""
    out = _run("""
        import sys
        import numpy as np
        import torch
        from mlx_audio_tpu_torch.codec.models.snac import SNAC
        from mlx_audio_tpu_torch.nn import QuantizedLinear
        from mlx_audio_tpu_torch.stt.models import (mega_asr, qwen3_asr,
                                                    qwen3_forced_aligner)
        from mlx_audio_tpu_torch.tts.models import qwen3
        from mlx_audio_tpu_torch.utils import apply_quantization

        class Tok:
            eos_token_id = 3
            def encode(self, text, add_special_tokens=False):
                out = [7, 8] + [5] * text.count("<|audio_pad|>")
                return out + [9] * text.count("<timestamp>") + [10]
            def decode(self, toks, skip_special_tokens=True):
                return " ".join(str(t) for t in toks)

        cfg = dict(audio_token_id=5, timestamp_token_id=9, classify_num=40,
                   audio_config=dict(num_mel_bins=16, encoder_layers=1,
                                     encoder_attention_heads=2,
                                     encoder_ffn_dim=32, d_model=16,
                                     downsample_hidden_size=4,
                                     output_dim=16),
                   text_config=dict(vocab_size=64, hidden_size=16,
                                    intermediate_size=32,
                                    num_hidden_layers=1,
                                    num_attention_heads=2,
                                    num_key_value_heads=2, head_dim=8))
        audio = np.random.RandomState(0).randn(16000).astype(np.float32)
        m = qwen3_asr.Model(cfg, device="cpu").init_params(0)
        m._tokenizer = Tok()
        dense = m.generate(audio, language="English", max_tokens=16).text
        apply_quantization(m.model, {"quantization": {"bits": 8,
                                                      "group_size": 16}})
        assert sum(isinstance(x, QuantizedLinear)
                   for x in m.modules()) == 7
        out = m.generate(audio, language="English", max_tokens=16)
        parts = list(m.generate(audio, language="English", max_tokens=16,
                                stream=True))
        assert parts[-1].is_final and out.generation_tokens <= 16
        a = qwen3_forced_aligner.Model(cfg, device="cpu").init_params(0)
        a._tokenizer = Tok()
        res = a.generate(audio, text="one two", language="English")
        assert [it.text for it in res] == ["one", "two"]
        g = mega_asr.Model(cfg, device="cpu").init_params(0)
        g._tokenizer = Tok()
        q = g.model.layers[0].self_attn.q_proj.weight.clone()
        g.set_lora({"model.layers.0.self_attn.q_proj": {
            "A": np.ones((2, 16), np.float32),
            "B": np.ones((16, 2), np.float32), "scaling": 0.5}})
        g._set_lora(True)
        assert not torch.equal(g.model.layers[0].self_attn.q_proj.weight, q)
        g._set_lora(False)
        assert torch.equal(g.model.layers[0].self_attn.q_proj.weight, q)
        v = qwen3.Model(dict(vocab_size=151679 + 7 * 4096, hidden_size=32,
                             intermediate_size=64, num_hidden_layers=1,
                             num_attention_heads=4, num_key_value_heads=2,
                             head_dim=8, tie_word_embeddings=True),
                        device="cpu").init_params(0)
        v.tokenizer = Tok()
        v.set_codec(SNAC(dict(encoder_dim=16, encoder_rates=[2, 2],
                              decoder_dim=32, decoder_rates=[2, 2],
                              vq_strides=[4, 2, 1], attn_window_size=None),
                         device="cpu").init_params(1))
        (r,) = v.generate("hi", temperature=0.0, max_tokens=28)
        chunks = list(v.generate("hi", temperature=0.0, max_tokens=28,
                                 stream=True, streaming_interval=0.06))
        assert r.samples > 0 and np.isfinite(r.audio).all()
        assert sum(c.samples for c in chunks) > 0
        print("jax" in sys.modules, %s)
    """ % FORBIDDEN)
    assert out.strip().splitlines()[-1] == "False []", out


LLM_STT_SOURCES = (
    "mlx_audio_tpu_torch/stt/models/llm_stt.py",
    "mlx_audio_tpu_torch/stt/models/voxtral/voxtral.py",
    "mlx_audio_tpu_torch/stt/models/voxtral/__init__.py",
    "mlx_audio_tpu_torch/stt/models/qwen2_audio/qwen2_audio.py",
    "mlx_audio_tpu_torch/stt/models/qwen2_audio/__init__.py",
    "mlx_audio_tpu_torch/stt/models/glmasr/glmasr.py",
    "mlx_audio_tpu_torch/stt/models/glmasr/__init__.py",
    "mlx_audio_tpu_torch/stt/models/granite_speech/granite_speech.py",
    "mlx_audio_tpu_torch/stt/models/granite_speech/__init__.py",
    "mlx_audio_tpu_torch/stt/models/vibevoice_asr/vibevoice_asr.py",
    "mlx_audio_tpu_torch/stt/models/vibevoice_asr/__init__.py")


def test_llm_stt_families_are_checked_statically():
    """The LLM-decoder STT families' modules are among the sources whose
    imports `test_source_imports_nothing_of_jax` checks."""
    assert set(LLM_STT_SOURCES) <= set(PORT_SOURCES)


def test_tiny_llm_stt_families_without_jax(tmp_path):
    """Offline Voxtral from an MLX-packed q8 directory through
    `stt.utils.load_model` (its linears on QuantizedLinear), Qwen2-Audio on
    an affine 4-bit LM, GLM-ASR, Granite Speech (whole and streamed) and
    VibeVoice-ASR, each a greedy generate on the CPU at a tiny size from
    seed 0 with a stand-in tokenizer; no jax in sys.modules."""
    out = _run("""
        import sys
        from pathlib import Path
        import numpy as np
        from chip_smoke import write_llm_stt_checkpoint, write_mistral_tekken
        from mlx_audio_tpu_torch.nn import QuantizedLinear
        from mlx_audio_tpu_torch.stt.models import (glmasr, granite_speech,
                                                    qwen2_audio,
                                                    vibevoice_asr, voxtral)
        from mlx_audio_tpu_torch.stt.utils import load_model
        from mlx_audio_tpu_torch.utils import apply_quantization

        class Tok:
            eos_token_id = 3
            chat_template = None
            def encode(self, text, **kw):
                return [7 + ord(c) %% 40 for c in text[:30]]
            def decode(self, toks, skip_special_tokens=True):
                return " ".join(str(t) for t in toks)

        lm = dict(hidden_size=32, num_hidden_layers=1, intermediate_size=64,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=8,
                  vocab_size=256)
        tower = dict(d_model=32, encoder_layers=1, encoder_attention_heads=4,
                     encoder_ffn_dim=64, num_mel_bins=32)
        audio = (np.random.RandomState(0).randn(16000) * 0.1).astype(
            np.float32)
        v = voxtral.Model(dict(audio_config=dict(tower, intermediate_size=128),
                               text_config=lm), device="cpu").init_params(0)
        d = Path(%r) / "voxtral-q8"
        write_llm_stt_checkpoint(v, d, bits=8, group_size=32)
        write_mistral_tekken(d / "tekken.json", 40, 256)
        v = load_model(d, device="cpu")
        assert sum(isinstance(x, QuantizedLinear) for x in v.modules()) == 10
        assert v.generate(audio, max_tokens=8).generation_tokens <= 8
        q = qwen2_audio.Model(dict(audio_config=tower, text_config=lm),
                              device="cpu").init_params(0)
        apply_quantization(q, {"quantization": {"bits": 4, "group_size": 32}},
                           q.model_quant_predicate)
        q._tokenizer = Tok()
        assert q.generate(audio, max_tokens=8).generation_tokens <= 8
        g = glmasr.Model(dict(merge_factor=2, whisper_config=dict(
            d_model=16, encoder_attention_heads=2, encoder_ffn_dim=32,
            encoder_layers=1, num_mel_bins=16), lm_config=dict(
            lm, eos_token_id=[3])), device="cpu").init_params(0)
        g._tokenizer = Tok()
        assert g.generate(audio, max_tokens=8).generation_tokens <= 8
        gr = granite_speech.Model(dict(
            encoder_config=dict(input_dim=20, num_layers=2, hidden_dim=32,
                                num_heads=4, dim_head=8, output_dim=10,
                                context_size=8, max_pos_emb=16,
                                conv_kernel_size=5),
            projector_config=dict(hidden_size=32, num_hidden_layers=1,
                                  num_attention_heads=4,
                                  intermediate_size=64,
                                  encoder_hidden_size=32),
            text_config=dict(lm, embedding_multiplier=12.0,
                             residual_multiplier=0.22, logits_scaling=8.0),
            audio_token_index=250), device="cpu").init_params(0)
        out = gr.generate(audio, max_tokens=8)
        parts = list(gr.generate(audio, max_tokens=8, stream=True))
        assert parts[-1].is_final and len(parts) - 1 == out.generation_tokens
        vv = vibevoice_asr.Model(dict(
            acoustic_tokenizer_config=dict(vae_dim=8, encoder_n_filters=4,
                                           encoder_ratios=[4, 2],
                                           encoder_depths="1-1-2"),
            semantic_tokenizer_config=dict(vae_dim=12, encoder_n_filters=4,
                                           encoder_ratios=[4, 2],
                                           encoder_depths="1-1-2"),
            decoder_config=lm), device="cpu").init_params(0)
        assert vv.generate(audio[:4000], max_tokens=8).generation_tokens <= 8
        print("jax" in sys.modules, %s)
    """ % (str(tmp_path), FORBIDDEN))
    assert out.strip().splitlines()[-1] == "False []", out


OUTETTS_LID_SOURCES = (
    "mlx_audio_tpu_torch/codec/models/descript/dac.py",
    "mlx_audio_tpu_torch/codec/models/encodec/encodec.py",
    "mlx_audio_tpu_torch/codec/models/ecapa_tdnn/ecapa_tdnn.py",
    "mlx_audio_tpu_torch/tts/models/outetts/outetts.py",
    "mlx_audio_tpu_torch/tts/models/outetts/prompt.py",
    "mlx_audio_tpu_torch/tts/models/pocket_tts/pocket_tts.py",
    "mlx_audio_tpu_torch/stt/models/mms/mms.py",
    "mlx_audio_tpu_torch/lid/utils.py",
    "mlx_audio_tpu_torch/lid/models/wav2vec2/wav2vec2.py",
    "mlx_audio_tpu_torch/lid/models/ecapa_tdnn/ecapa_tdnn.py")


def test_outetts_pocket_mms_lid_are_checked_statically():
    """The modules of OuteTTS, the DAC, EnCodec, Pocket-TTS, MMS and the
    LID families are among the sources whose imports
    `test_source_imports_nothing_of_jax` checks."""
    assert set(OUTETTS_LID_SOURCES) <= set(PORT_SOURCES)


def test_tiny_outetts_generate_and_ecapa_predict_without_jax():
    """A tiny OuteTTS over a tiny DAC, a greedy generate whole and
    streamed, and an ECAPA LID `predict`, on the CPU from seeded weights;
    no jax in sys.modules."""
    out = _run("""
        import sys
        import numpy as np
        from mlx_audio_tpu_torch.codec.models.descript import DAC
        from mlx_audio_tpu_torch.lid.models import ecapa_tdnn
        from mlx_audio_tpu_torch.tts.models import outetts

        class Tok:
            eos_token_id = 2
            def encode(self, text, add_special_tokens=False):
                if text.startswith("<|c1_"):
                    return [100 + int(text[5:-2])]
                if text.startswith("<|c2_"):
                    return [1200 + int(text[5:-2])]
                return [3 + ord(c) %% 90 for c in text]

        m = outetts.Model(dict(hidden_size=32, num_hidden_layers=1,
                               intermediate_size=64, num_attention_heads=4,
                               num_key_value_heads=2, vocab_size=2300),
                          device="cpu").init_params(0)
        m.tokenizer = Tok()
        m.set_codec(DAC(dict(encoder_dim=8, encoder_rates=[2, 2],
                             decoder_dim=32, decoder_rates=[2, 2],
                             n_codebooks=2, codebook_size=1024,
                             codebook_dim=4, sample_rate=24000),
                        device="cpu").init_params(1))
        res = list(m.generate("hi there", temperature=0.0, max_tokens=40))
        parts = list(m.generate("hi there", temperature=0.0, max_tokens=40,
                                stream=True, streaming_interval=0.1))
        assert m.last_run["steps"] <= 40
        assert all(np.isfinite(r.audio).all() for r in res + parts)
        lid = ecapa_tdnn.Model(dict(channels=16, embedding_dim=8,
                                    attention_channels=4, res2net_scale=4,
                                    se_channels=4, classifier_hidden_dim=8,
                                    num_classes=3),
                               device="cpu").init_params(0)
        preds = lid.predict(np.random.RandomState(0).randn(8000) * 0.1,
                            top_k=2)
        assert len(preds) == 2 and preds[0][1] >= preds[1][1]
        print("jax" in sys.modules, %s)
    """ % FORBIDDEN)
    assert out.strip().splitlines()[-1] == "False []", out


KALDI_FAMILY_SOURCES = (
    "mlx_audio_tpu_torch/dsp.py",
    "mlx_audio_tpu_torch/vad/models/fsmn/fsmn.py",
    "mlx_audio_tpu_torch/vad/models/fsmn/config.py",
    "mlx_audio_tpu_torch/stt/models/sensevoice/sensevoice.py",
    "mlx_audio_tpu_torch/stt/models/fun_asr_nano/fun_asr_nano.py",
    "mlx_audio_tpu_torch/stt/models/fireredasr2/fireredasr2.py",
    "mlx_audio_tpu_torch/sts/models/mossformer2_se/mossformer2_se.py")


def test_kaldi_families_are_checked_statically():
    """The Kaldi DSP and the modules of FSMN VAD, SenseVoice,
    Fun-ASR-Nano, FireRedASR2 and MossFormer2-SE are among the sources
    whose imports `test_source_imports_nothing_of_jax` checks."""
    assert set(KALDI_FAMILY_SOURCES) <= set(PORT_SOURCES)


def test_tiny_sensevoice_generate_and_fsmn_detect_without_jax():
    """A tiny SenseVoice `generate` (rich tags and CTC text) and an FSMN
    VAD `detect`, on the CPU from seeded weights; no jax in
    sys.modules."""
    out = _run("""
        import sys
        import numpy as np
        from mlx_audio_tpu_torch.stt.models import sensevoice
        from mlx_audio_tpu_torch.vad.models import fsmn

        m = sensevoice.Model(dict(
            vocab_size=64, input_size=40,
            encoder_conf=dict(output_size=16, attention_heads=2,
                              linear_units=32, num_blocks=2, tp_blocks=1,
                              kernel_size=5),
            frontend_conf=dict(n_mels=8, lfr_m=5, lfr_n=3)),
            device="cpu").init_params(0)
        m._token_list = [f"t{i}" for i in range(64)]
        audio = np.random.RandomState(0).randn(16000).astype(np.float32) * 0.1
        out = m.generate(audio)
        assert isinstance(out.text, str) and out.segments[0]["emotion"]
        vad = fsmn.Model(dict(encoder=dict(
            input_dim=40, input_affine_dim=16, fsmn_layers=2, linear_dim=24,
            proj_dim=8, lorder=4, output_affine_dim=16, output_dim=12),
            n_mels=8), device="cpu").init_params(0)
        segs = vad.detect(audio)
        assert all(0 <= a < b for a, b in segs)
        print("jax" in sys.modules, %s)
    """ % FORBIDDEN)
    assert out.strip().splitlines()[-1] == "False []", out


LAST_STT_SOURCES = (
    "mlx_audio_tpu_torch/stt/models/lasr_ctc/lasr.py",
    "mlx_audio_tpu_torch/stt/models/moonshine/moonshine.py",
    "mlx_audio_tpu_torch/stt/models/moss_transcribe_diarize/"
    "moss_transcribe_diarize.py",
    "mlx_audio_tpu_torch/stt/models/higgs_audio_3/higgs_audio_3.py",
    "mlx_audio_tpu_torch/stt/models/granite_speech_nar/"
    "granite_speech_nar.py",
    "mlx_audio_tpu_torch/stt/models/moss_music/moss_music.py")


@pytest.mark.parametrize("path", LAST_STT_SOURCES)
def test_last_stt_families_are_checked_statically(path):
    """LASR-CTC, Moonshine, MOSS-Transcribe-Diarize, Higgs Audio v3,
    Granite Speech NAR and MOSS-Music are among the sources whose imports
    `test_source_imports_nothing_of_jax` checks."""
    assert path in PORT_SOURCES


def test_tiny_moonshine_and_moss_diarize_cli_without_jax(tmp_path):
    """A tiny Moonshine and a tiny MOSS-Transcribe-Diarize on the CPU from
    seed 0: each written as a checkpoint directory and transcribed by
    `generate`, then the same WAV through the STT CLI with --stream in a
    second fresh interpreter (MOSS-Transcribe-Diarize streams; Moonshine's
    `generate` ignores `stream` and gives one result) giving the same
    text; no jax in either's sys.modules."""
    out = _run("""
        import json, sys
        from pathlib import Path
        import numpy as np
        from mlx_audio_tpu_torch import audio_io
        from mlx_audio_tpu_torch.stt.models import (moonshine,
                                                    moss_transcribe_diarize)

        class Tok:
            eos_token_id = 5
            def encode(self, s, **kw):
                return [10 + ord(c) %% 80 for c in s]
            def decode(self, ids, **kw):
                return "".join(chr(97 + i %% 26) for i in ids)

        tmp = Path(%r)
        x = (np.random.RandomState(0).randn(24000) * 0.1).astype(np.float32)
        audio_io.write(tmp / "a.wav", x, 16000)
        cfgs = {"moonshine": dict(
                    model_type="moonshine", vocab_size=64, hidden_size=32,
                    intermediate_size=64, encoder_num_hidden_layers=1,
                    decoder_num_hidden_layers=1,
                    encoder_num_attention_heads=4,
                    decoder_num_attention_heads=4),
                "moss": dict(
                    model_type="moss_transcribe_diarize", text_config=dict(
                        vocab_size=1000, hidden_size=32,
                        intermediate_size=64, num_hidden_layers=1,
                        num_attention_heads=4, num_key_value_heads=2,
                        head_dim=8),
                    audio_config=dict(num_mel_bins=80, d_model=32,
                                      encoder_layers=1,
                                      encoder_attention_heads=4,
                                      encoder_ffn_dim=64),
                    audio_token_id=999)}
        want = {}
        for name, mod in (("moonshine", moonshine),
                          ("moss", moss_transcribe_diarize)):
            m = mod.Model(cfgs[name], device="cpu").init_params(0)
            d = tmp / name
            d.mkdir()
            np.savez(d / "model.npz", **{k: v.numpy() for k, v in
                                         m.state_dict().items()})
            (d / "config.json").write_text(json.dumps(cfgs[name]))
            if name == "moss":
                m._tokenizer = Tok()
            want[name] = m.generate(str(tmp / "a.wav"), max_tokens=8).text
        assert all(want.values())
        (tmp / "want.json").write_text(json.dumps(want))
        print("jax" in sys.modules, %s)
    """ % (str(tmp_path), FORBIDDEN))
    assert out.strip() == "False []", out
    out = _run("""
        import json, sys
        from pathlib import Path
        import mlx_audio_tpu_torch.stt.utils as stt_utils
        from mlx_audio_tpu_torch.stt import generate

        class Tok:
            eos_token_id = 5
            def encode(self, s, **kw):
                return [10 + ord(c) %% 80 for c in s]
            def decode(self, ids, **kw):
                return "".join(chr(97 + i %% 26) for i in ids)

        real = stt_utils.load_model

        def load(p):
            m = real(p, device="cpu")
            if m._tokenizer is None and type(m).__module__.endswith(
                    "moss_transcribe_diarize"):
                m._tokenizer = Tok()
            return m

        stt_utils.load_model = load
        tmp = Path(%r)
        want = json.loads((tmp / "want.json").read_text())
        for name, extra in (("moonshine", ["--stream"]),
                            ("moss", ["--stream"])):
            generate.main(["--model", str(tmp / name), "--audio",
                           str(tmp / "a.wav"), "--format", "json",
                           "--max-tokens", "8", "--output-path",
                           str(tmp / ("out-" + name)), "--no-verbose"]
                          + extra)
            got = json.loads((tmp / ("out-" + name)
                              / "transcription.json").read_text())
            assert got["text"].strip() == want[name], (got, want)
        print("jax" in sys.modules, %s)
    """ % (str(tmp_path), FORBIDDEN))
    assert out.strip() == "False []", out


def test_tiny_sts_generate_and_cli_without_jax(tmp_path):
    """The STS families on the CPU at a tiny size from seeded weights
    (chip_smoke.py's small configs): a greedy Moshi generate through its
    tiny Mimi and on an affine-q8 LM, a Mel-Band-RoFormer separation and a
    DeepFilterNet enhancement offline and streamed; a DeepFilterNet
    checkpoint directory through `load_model` and the STS CLI in this
    interpreter; no jax in sys.modules."""
    out = _run("""
        import sys
        from pathlib import Path
        import numpy as np
        import mlx_audio_tpu_torch
        from mlx_audio_tpu_torch import audio_io
        from mlx_audio_tpu_torch.sts import generate, utils
        from mlx_audio_tpu_torch.utils import apply_quantization
        from chip_smoke import (MOSHI_Q8_SMALL, _clip_audio, _dfn_small,
                                _mel_small, _moshi_small, moshi_k2_per_step,
                                write_dfn_checkpoint)

        moshi = _moshi_small("cpu")
        r = moshi.generate(np.zeros(240, np.float32), text_temp=0.0,
                           audio_temp=0.0)
        assert r.token_count == 10 and np.isfinite(r.audio).all()
        q8 = _moshi_small("cpu", cfg=MOSHI_Q8_SMALL)
        apply_quantization(q8.lm, {"quantization": {"bits": 8,
                                                    "group_size": 64}})
        assert moshi_k2_per_step(q8.lm) == 2 * 4 + 4 * (1 * 4 + 2) + 1
        assert q8.generate(np.zeros(120, np.float32)).token_count == 5
        sep = _mel_small("cpu").separate(_clip_audio(1, 0.4, 8000, 2))
        assert sep.vocals.shape == (2, 3200)
        dfn = _dfn_small("cpu")
        noisy = _clip_audio(2, 0.5, 16000)
        assert dfn.enhance_array(noisy).shape == noisy.shape
        s = dfn.create_streamer(8)
        assert s.process_chunk(noisy).size and s.flush().size
        path = Path(%r) / "deepfilternet-tiny"
        write_dfn_checkpoint(dfn, path)
        assert mlx_audio_tpu_torch.load_model(path, device="cpu") \
            .generate(noisy).shape == noisy.shape
        real = utils.load_model
        utils.load_model = lambda p, **kw: real(p, **dict(kw, device="cpu"))
        audio_io.write(path / "in.wav", noisy, 16000)
        generate.main(["--model", str(path), "--audio", str(path / "in.wav"),
                       "--output-path", str(path / "out.wav"),
                       "--no-verbose"])
        assert audio_io.read(path / "out.wav")[0].shape == noisy.shape
        print("jax" in sys.modules, %s)
    """ % (str(tmp_path), FORBIDDEN))
    assert out.strip() == "False []", out


SLICE7A_SOURCES = (
    "mlx_audio_tpu_torch/vad/models/smart_turn/smart_turn.py",
    "mlx_audio_tpu_torch/vad/models/sortformer/sortformer.py",
    "mlx_audio_tpu_torch/sts/models/lfm_audio/lfm2.py",
    "mlx_audio_tpu_torch/sts/models/lfm_audio/detokenizer.py",
    "mlx_audio_tpu_torch/sts/models/lfm_audio/processor.py",
    "mlx_audio_tpu_torch/sts/models/lfm_audio/lfm_audio.py")


@pytest.mark.parametrize("path", SLICE7A_SOURCES)
def test_slice7a_families_are_checked_statically(path):
    """Smart Turn, Sortformer and LFM2-Audio are among the sources whose
    imports `test_source_imports_nothing_of_jax` checks."""
    assert path in PORT_SOURCES


def test_tiny_smart_turn_sortformer_lfm_audio_without_jax(tmp_path):
    """The three families on the CPU at a tiny size from seeded weights
    (chip_smoke.py's small configs), with no jax in sys.modules: a Smart
    Turn and a Sortformer directory through the VAD loader (an endpoint
    prediction at 8 kHz; a diarization, and an AOSC stream that compresses
    its speaker cache), and a q8 LFM2-Audio directory through the STS
    loader (every linear quantized, run on K2's plain version here), whose
    chat request gives text and audio through the tiny detokenizer."""
    out = _run("""
        import sys
        from pathlib import Path
        import numpy as np
        import mlx_audio_tpu_torch
        from mlx_audio_tpu_torch.nn import Linear, QuantizedLinear
        from mlx_audio_tpu_torch.vad import utils as vad_utils
        from chip_smoke import (LFM_SMALL, SMART_TURN_SMALL,
                                SORTFORMER_SMALL, _clip_audio, _lfm_out,
                                _lfm_ready, _slice7a_small,
                                write_slice7a_checkpoint)

        tmp = Path(%r)
        audio = _clip_audio(3, 2.0, 16000)
        for kind, cfg in (("smart_turn", SMART_TURN_SMALL),
                          ("sortformer", SORTFORMER_SMALL)):
            write_slice7a_checkpoint(_slice7a_small(kind, "cpu"),
                                     tmp / kind, dict(cfg, model_type=kind))
        turn = vad_utils.load_model(tmp / "smart_turn", device="cpu")
        r = turn.predict_endpoint(audio[::2], sample_rate=8000)
        assert 0.0 <= r.probability <= 1.0
        diar = mlx_audio_tpu_torch.load_model(tmp / "sortformer",
                                              device="cpu")
        assert diar.generate(audio).speaker_probs.shape[1] == 3
        mc = diar.config.modules_config
        mc.use_aosc, mc.spkcache_len, mc.spkcache_update_period = True, 12, 8
        mc.spkcache_sil_frames_per_spk = 1
        final = list(diar.generate_stream(audio))[-1]
        assert diar.last_run["compressions"] >= 1
        assert np.isfinite(final.speaker_probs).all()
        write_slice7a_checkpoint(
            _slice7a_small("lfm_audio", "cpu"), tmp / "lfm",
            dict(LFM_SMALL, model_type="lfm_audio"),
            {"quantization": {"group_size": 16, "bits": 8}})
        lfm = mlx_audio_tpu_torch.load_model(tmp / "lfm", device="cpu")
        assert not any(isinstance(m, Linear) for m in lfm.modules())
        assert any(isinstance(m, QuantizedLinear) for m in lfm.modules())
        _lfm_ready(lfm, _slice7a_small("detokenizer", "cpu"))
        tokens, wav = _lfm_out(lfm, audio)
        assert {m for _, m in tokens} == {1, 3}, tokens
        assert wav.size and np.isfinite(wav).all()
        print("jax" in sys.modules, %s)
    """ % (str(tmp_path), FORBIDDEN))
    assert out.strip() == "False []", out


SLICE7B_SOURCES = (
    "mlx_audio_tpu_torch/codec/models/dacvae/dacvae.py",
    "mlx_audio_tpu_torch/sts/models/sam_audio/t5.py",
    "mlx_audio_tpu_torch/sts/models/sam_audio/dit.py",
    "mlx_audio_tpu_torch/sts/models/sam_audio/model.py",
    "mlx_audio_tpu_torch/sts/voice_pipeline.py",
    "mlx_audio_tpu_torch/sts/audio_player.py",
    "mlx_audio_tpu_torch/tts/audio_player.py",
    "mlx_audio_tpu_torch/stt/eval/wer.py",
    "mlx_audio_tpu_torch/stt/eval/normalize.py",
    "mlx_audio_tpu_torch/stt/eval/manifest.py",
    "mlx_audio_tpu_torch/stt/eval/runner.py",
    "mlx_audio_tpu_torch/stt/eval/cli.py")


@pytest.mark.parametrize("path", SLICE7B_SOURCES)
def test_slice7b_modules_are_checked_statically(path):
    """DACVAE, SAM-Audio, the voice pipeline, the audio players and the
    WER eval are among the sources whose imports
    `test_source_imports_nothing_of_jax` checks."""
    assert path in PORT_SOURCES


def test_tiny_sam_audio_pipeline_and_eval_without_jax(tmp_path):
    """On the CPU at a tiny size, with no jax in sys.modules: a q8
    SAM-Audio directory (chip_smoke.py's small config, group 16) through
    the STS loader separating 64 frames, its DACVAE through the codec
    loader; a voice-pipeline turn (a scripted VAD, a tiny llama's greedy
    reply, a scripted TTS) through the audio player; the WER eval CLI on a
    one-row manifest with a tiny Whisper directory."""
    out = _run("""
        import contextlib, io, json, sys
        from pathlib import Path
        import numpy as np
        import mlx_audio_tpu_torch
        from mlx_audio_tpu_torch.codec.utils import load_model as codec_load
        from mlx_audio_tpu_torch.nn import QuantizedLinear
        from mlx_audio_tpu_torch.sts.voice_pipeline import (
            LocalLLMResponseEngine, VadConfig, VoicePipeline)
        from mlx_audio_tpu_torch.stt.eval.__main__ import main as eval_main
        from mlx_audio_tpu_torch.tts.models.llama import BackboneModel
        from chip_smoke import (SAM_SMALL, SamTok, WordTok, _sam_small,
                                whisper_eval_small, write_sam_checkpoint,
                                write_whisper_checkpoint)

        tmp = Path(%r)
        write_sam_checkpoint(_sam_small("cpu"), tmp / "sam",  SAM_SMALL,
                             {"quantization": {"group_size": 16, "bits": 8}})
        sam = mlx_audio_tpu_torch.load_model(tmp / "sam", device="cpu")
        assert sum(isinstance(m, QuantizedLinear) for m in sam.modules()) == 44
        sam.tokenizer = SamTok()
        res = sam.separate(np.random.RandomState(0).randn(512) * 0.1,
                           ["rain"], ode_opt={"step_size": 0.5})
        assert res.target[0].shape == (512, 1)
        assert np.isfinite(res.target[0]).all()
        with np.load(tmp / "sam" / "model.npz") as tree:
            (tmp / "codec").mkdir()
            np.savez(tmp / "codec" / "model.npz",
                     **{k[12:]: tree[k] for k in tree.files
                        if k.startswith("audio_codec.")})
        (tmp / "codec" / "config.json").write_text(json.dumps(
            dict(SAM_SMALL["audio_codec"], model_type="dacvae")))
        codec = codec_load(tmp / "codec", device="cpu")
        assert codec.decode(np.zeros((1, 8, 4), np.float32)).shape == (1, 32, 1)

        class Vad:
            def __init__(self):
                self.i = 0
            def feed(self, frame, state):
                self.i += 1
                return np.asarray([[0.9 if 2 < self.i < 12 else 0.0]]), state

        class Stt:
            def generate(self, audio):
                class Out:
                    text = "hello there"
                return Out()

        class Tts:
            sample_rate = 16000
            def generate(self, text, **kw):
                class R:
                    audio = np.ones(2400, np.float32) * 0.1
                yield R()

        lm = BackboneModel(dict(hidden_size=32, num_hidden_layers=2,
                                intermediate_size=64, num_attention_heads=4,
                                num_key_value_heads=2, vocab_size=1100,
                                head_dim=8), device="cpu").init_params(seed=7)
        events = []
        pipe = VoicePipeline(
            vad_model=Vad(), stt_model=Stt(), tts_model=Tts(),
            llm_engine=LocalLLMResponseEngine(lm, tokenizer=WordTok(),
                                              max_tokens=8, temperature=0.0),
            on_event=lambda k, d: events.append(k),
            vad_config=VadConfig(min_silence_ms=300))
        pipe.feed_audio(np.full(512 * 42, 0.1, np.float32))
        assert "response" in events and len(pipe.fetch_speech()) == 2400
        pipe.shutdown()

        write_whisper_checkpoint(whisper_eval_small("cpu"), tmp / "whisper")
        from mlx_audio_tpu_torch import audio_io
        audio_io.write(str(tmp / "a.wav"),
                       np.random.RandomState(1).randn(16000) * 0.1, 16000)
        (tmp / "m.jsonl").write_text(json.dumps(
            {"id": "a", "audio": "a.wav", "text": "one two"}) + "\\n")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            eval_main(["--manifest", str(tmp / "m.jsonl"), "--model",
                       str(tmp / "whisper"), "--output-dir", str(tmp / "o"),
                       "--device", "cpu", "--gen-kwargs",
                       '{"temperature": 0.0, "return_timestamps": false}'])
        assert json.loads(printed.getvalue())["num_samples"] == 1
        print("jax" in sys.modules, %s)
    """ % (str(tmp_path), FORBIDDEN))
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


SLICE8A_SOURCES = (
    "mlx_audio_tpu_torch/tts/models/kitten_tts/kitten_tts.py",
    "mlx_audio_tpu_torch/tts/models/soprano/soprano.py",
    "mlx_audio_tpu_torch/tts/models/soprano/text.py",
    "mlx_audio_tpu_torch/tts/models/voxtral_tts/voxtral_tts.py",
    "mlx_audio_tpu_torch/tts/models/voxtral_tts/text_preprocess.py",
    "mlx_audio_tpu_torch/tts/models/omnivoice/omnivoice.py",
    "mlx_audio_tpu_torch/tts/models/omnivoice/duration.py",
    "mlx_audio_tpu_torch/tts/models/omnivoice/utils.py")


@pytest.mark.parametrize("path", SLICE8A_SOURCES)
def test_slice8a_modules_are_checked_statically(path):
    """KittenTTS, Soprano, Voxtral-4B-TTS and OmniVoice, the pure-Python
    text copies among them, are among the sources whose imports
    `test_source_imports_nothing_of_jax` checks."""
    assert path in PORT_SOURCES


@pytest.mark.parametrize("name,text", [
    ("soprano.text.clean_text", "Dr. Smith paid $5.50 on the 3rd!!"),
    ("soprano.text.clean_text", "21 items"),
    ("voxtral_tts.text_preprocess.sanitize_tts_input_text_for_demo",
     "# Title\n- a [x](http://u)"),
    ("voxtral_tts.text_preprocess.verbalize_currency", "$1.50"),
    ("voxtral_tts.text_preprocess.verbalize_number", "1985"),
    ("omnivoice.omnivoice.combine_text", "你 好"),
    ("omnivoice.duration.RuleDurationEstimator", "你好世界" * 8)])
def test_slice8a_text_copies_equal_jax(name, text):
    """The slice's pure-Python copies give their originals' outputs on the
    JAX tests' strings (tests/test_soprano.py, test_voxtral_tts.py,
    test_omnivoice.py)."""
    import importlib

    mod, attr = name.rsplit(".", 1)
    got, want = (getattr(importlib.import_module(
        f"{pkg}.tts.models.{mod}"), attr)
        for pkg in ("mlx_audio_tpu_torch", "mlx_audio_tpu"))
    if attr == "RuleDurationEstimator":
        got = got().estimate_duration(text, "Nice to meet you.", 25)
        want = want().estimate_duration(text, "Nice to meet you.", 25)
        assert got == want > 0
    else:
        assert got(text) == want(text)


def test_tiny_slice8a_families_without_jax(tmp_path):
    """On the CPU at a tiny size, with no jax in sys.modules: chip_smoke.py
    phase 62's small KittenTTS, Soprano, q8 Voxtral-TTS (group 16) and
    OmniVoice (its Higgs codec in audio_tokenizer/) through the top-level
    `load_model` on written directories, each generating finite audio."""
    out = _run("""
        import json, sys
        from pathlib import Path
        import numpy as np
        import mlx_audio_tpu_torch
        from mlx_audio_tpu_torch.codec.models.higgs_audio import Model as Codec
        from mlx_audio_tpu_torch.nn import QuantizedLinear
        from mlx_audio_tpu_torch.tts.models import (kitten_tts, omnivoice,
                                                    soprano, voxtral_tts)
        from chip_smoke import (HIGGS_CODEC_SMALL, KITTEN_SMALL, OMNI_SMALL,
                                SOPRANO_SMALL, VOXTRAL_TTS_SMALL, OmniTok,
                                SopranoTok, SpeechTok,
                                write_slice8a_checkpoint)

        tmp = Path(%r)
        load = lambda d: mlx_audio_tpu_torch.load_model(d, device="cpu")
        for name, mod, cfg, kind, kw in (
                ("kitten", kitten_tts, KITTEN_SMALL, "kitten",
                 {"torch_layout": True}),
                ("soprano", soprano, SOPRANO_SMALL, "soprano", {}),
                ("vox", voxtral_tts, VOXTRAL_TTS_SMALL, "voxtral_tts",
                 {"quantization": {"quantization": {"group_size": 16,
                                                    "bits": 8}}}),
                ("omni", omnivoice, OMNI_SMALL, "omnivoice", {})):
            write_slice8a_checkpoint(mod.Model(cfg, device="cpu")
                                     .init_params(seed=0), tmp / name, cfg,
                                     kind, **kw)
        np.savez(tmp / "kitten" / "voices.npz",
                 carol=np.ones((1, 32), np.float32) * 0.1)
        (tmp / "omni" / "audio_tokenizer").mkdir()
        (tmp / "omni" / "audio_tokenizer" / "config.json").write_text(
            json.dumps(HIGGS_CODEC_SMALL))
        np.savez(tmp / "omni" / "audio_tokenizer" / "model.npz",
                 **{k: v.numpy() for k, v in Codec(
                     HIGGS_CODEC_SMALL, device="cpu").init_params(
                     seed=1).state_dict().items()})
        out = []
        kit = load(tmp / "kitten")
        out += list(kit.generate("Hello world.", voice="carol"))
        sop = load(tmp / "soprano")
        sop._tokenizer, sop._stop_token_id = SopranoTok(), None
        out += list(sop.generate("A long enough sentence to speak aloud.",
                                 max_tokens=8, temperature=0.0))
        vox = load(tmp / "vox")
        assert any(isinstance(m, QuantizedLinear) for m in vox.modules())
        vox.tokenizer = SpeechTok()
        out += list(vox.generate("hello there", max_tokens=6))
        omni = load(tmp / "omni")
        omni.text_tokenizer = OmniTok()
        out += list(omni.generate("hello", duration_s=0.4, num_steps=2))
        assert all(r.audio.size and np.isfinite(r.audio).all() for r in out)
        print(len(out), "jax" in sys.modules, %s)
    """ % (str(tmp_path), FORBIDDEN))
    assert out.strip() == "4 False []", out


SLICE8B_SOURCES = (
    "mlx_audio_tpu_torch/tts/models/tada/tada.py",
    "mlx_audio_tpu_torch/tts/models/tada/codec.py",
    "mlx_audio_tpu_torch/tts/models/moss_tts/moss_tts.py",
    "mlx_audio_tpu_torch/tts/models/moss_tts/config.py",
    "mlx_audio_tpu_torch/tts/models/moss_tts/processor.py",
    "mlx_audio_tpu_torch/tts/models/moss_tts/text.py",
    "mlx_audio_tpu_torch/tts/models/moss_tts_delay/__init__.py",
    "mlx_audio_tpu_torch/tts/models/moss_tts_local/__init__.py",
    "mlx_audio_tpu_torch/tts/models/moss_tts_nano/gpt2.py")


@pytest.mark.parametrize("path", SLICE8B_SOURCES)
def test_slice8b_modules_are_checked_statically(path):
    """TADA, MOSS-TTS with its aliases and the GPT-2 local head, the
    pure-Python host copies among them (`moss_tts/text.py`,
    `processor.py`, TADA's text, gray-code and alignment helpers), are
    among the sources whose imports `test_source_imports_nothing_of_jax`
    checks."""
    assert path in PORT_SOURCES


@pytest.mark.parametrize("name,text", [
    ("tada.tada.normalize_text", 'he said: "yes" -- ok…'),
    ("tada.tada.normalize_text", "hi there"),
    ("moss_tts.text.normalize_tts_text", "hello world"),
    ("moss_tts.text.normalize_tts_text", "# T\n- see https://a.b/c ok!!"),
    ("moss_tts.text.normalize_tts_text", "【标题】你好 world")])
def test_slice8b_text_copies_equal_jax(name, text):
    """The slice's text copies give their originals' outputs on the JAX
    tests' strings (tests/test_tada.py, tests/test_moss_tts.py)."""
    import importlib

    mod, attr = name.rsplit(".", 1)
    got, want = (getattr(importlib.import_module(
        f"{pkg}.tts.models.{mod}"), attr)
        for pkg in ("mlx_audio_tpu_torch", "mlx_audio_tpu"))
    assert got(text) == want(text)


@pytest.mark.parametrize("layout", ["delay", "v15", "legacy"])
def test_slice8b_processor_copies_equal_jax(layout):
    """The MOSS-TTS processor copies build JAX's rows for the JAX tests'
    prompts (a text-only prompt, a cloned one, a continuation), and the
    TADA gray code and alignment copies JAX's values."""
    import numpy as np
    from test_moss_tts import LANG, CharTok

    from mlx_audio_tpu.tts.models import moss_tts as jm
    from mlx_audio_tpu.tts.models.tada import tada as jt
    from mlx_audio_tpu_torch.tts.models import moss_tts as pm
    from mlx_audio_tpu_torch.tts.models.tada import tada as pt

    extra = {"delay": dict(model_type="moss_tts_delay"),
             "v15": dict(model_type="moss_tts_local",
                         audio_codebook_sizes=[24] * 4,
                         gpt2_config=dict(n_embd=32, n_head=4, n_inner=64)),
             "legacy": dict(model_type="moss_tts",
                            additional_mlp_ffn_hidden_size=48,
                            local_ffn_hidden_size=48, local_hidden_size=32,
                            local_num_layers=1)}[layout]
    cfg = dict(language_config=LANG, n_vq=4, audio_vocab_size=24, **extra)
    ref = np.random.RandomState(0).randint(0, 24, size=(6, 4))
    rows = []
    for pkg in (pm, jm):
        c = pkg.ModelConfig.from_dict(cfg)
        proc = {"delay": pkg.MossTTSDelayProcessor,
                "v15": pkg.MossTTSLocalV15Processor,
                "legacy": pkg.MossTTSLocalProcessor}[layout](CharTok(), c)
        rows.append([proc([[proc.build_user_message(text="hello world")]]),
                     proc([[proc.build_user_message(text="hi",
                                                    reference=[ref])]]),
                     proc([[proc.build_user_message(text="hi"),
                            proc.build_assistant_message([ref])]],
                          mode="continuation")])
    for a, b in zip(*rows):
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_array_equal(a["attention_mask"],
                                      b["attention_mask"])
    for n in (0, 5, 255):
        assert pt.int_to_gray_bits(n, 8) == jt.int_to_gray_bits(n, 8)
    logits = np.random.RandomState(1).randn(50, 30).astype(np.float32)
    for x, y in zip(pt.align_text_tokens(logits, np.array([3, 7, 11]),
                                         24000, 24000),
                    jt.align_text_tokens(logits, np.array([3, 7, 11]),
                                         24000, 24000)):
        np.testing.assert_array_equal(x, y)


def test_chip_smoke_defines_each_module_name_once():
    """chip_smoke.py defines each module-level name once: a phase's config
    of the same name as an earlier phase's (MOSS-TTS's and MossFormer2's
    small configs) would replace it for every phase."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py"),
                          encoding="utf-8").read())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [n.id for t in node.targets for n in ast.walk(t)
                      if isinstance(n, ast.Name)]
    twice = sorted({n for n in names if names.count(n) > 1})
    assert not twice, f"defined more than once: {twice}"


def test_tiny_tada_and_moss_tts_without_jax(tmp_path):
    """On the CPU at a tiny size, with no jax in sys.modules: chip_smoke.py
    phase 67's small TADA and delay MOSS-TTS (a q8 directory at group 16)
    through the top-level `load_model` on written directories, TADA
    generating finite audio, MOSS-TTS a continuation of 6 frames through
    the stand-in codec."""
    out = _run("""
        import sys
        from pathlib import Path
        import numpy as np
        import mlx_audio_tpu_torch
        from mlx_audio_tpu_torch.nn import QuantizedLinear
        from mlx_audio_tpu_torch.tts.models import moss_tts, tada
        from chip_smoke import (MOSS_TTS_SMALL, TADA_SMALL, MossCodec, MossTok,
                                TadaTok, write_slice8b_checkpoint)

        tmp = Path(%r)
        load = lambda d: mlx_audio_tpu_torch.load_model(d, device="cpu")
        write_slice8b_checkpoint(tada.Model(TADA_SMALL, device="cpu")
                                 .init_params(seed=0), tmp / "tada",
                                 TADA_SMALL, "tada")
        write_slice8b_checkpoint(
            moss_tts.Model(MOSS_TTS_SMALL["delay"], device="cpu").init_params(
                seed=0), tmp / "moss", MOSS_TTS_SMALL["delay"],
            "moss_tts_delay", {"quantization": {"group_size": 16,
                                                "bits": 8}})
        t = load(tmp / "tada")
        t._tokenizer = TadaTok(small=True)
        out = list(t.generate("hi there", max_tokens=12,
                              num_flow_matching_steps=4))
        m = load(tmp / "moss")
        assert isinstance(m.audio_lm_heads, QuantizedLinear)
        m.tokenizer, m.audio_tokenizer = MossTok(), MossCodec()
        out += list(m.generate("hello", mode="continuation", max_tokens=6,
                               prompt_audio_codes=np.ones((4, 4), np.int64),
                               text_temperature=0.0, audio_temperature=0.0))
        assert out[0].audio.size and m.last_run["frames"] == 6
        assert all(np.isfinite(r.audio).all() for r in out)
        print(len(out), "jax" in sys.modules, %s)
    """ % (str(tmp_path), FORBIDDEN))
    assert out.strip() == "2 False []", out


def _entry_points():
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch import convert, server
    from mlx_audio_tpu_torch.codec import utils as codec_utils
    from mlx_audio_tpu_torch.codec.models import mimi, snac
    from mlx_audio_tpu_torch.sts import utils as sts_utils
    from mlx_audio_tpu_torch.sts.models import (deepfilternet, mel_roformer,
                                                moshi)
    from mlx_audio_tpu_torch.stt import utils as stt_utils
    from mlx_audio_tpu_torch.stt.models import (canary, cohere_asr,
                                                nemotron_asr, parakeet,
                                                voxtral_realtime, whisper)
    from mlx_audio_tpu_torch.tts import generate, utils
    from mlx_audio_tpu_torch.tts.models import (kokoro, kugelaudio, llama,
                                                qwen3_tts, sesame, vibevoice)
    from mlx_audio_tpu_torch.stt.models import (mega_asr, qwen3_asr,
                                                qwen3_forced_aligner)
    from mlx_audio_tpu_torch.tts.models import qwen3
    from mlx_audio_tpu_torch.stt.models import (glmasr, granite_speech,
                                                qwen2_audio, vibevoice_asr,
                                                voxtral)
    from mlx_audio_tpu_torch.vad import utils as vad_utils
    from mlx_audio_tpu_torch.vad.models import silero_vad
    from mlx_audio_tpu_torch.codec.models import descript, encodec
    from mlx_audio_tpu_torch.lid import utils as lid_utils
    from mlx_audio_tpu_torch.lid.models import ecapa_tdnn
    from mlx_audio_tpu_torch.lid.models import wav2vec2 as lid_wav2vec2
    from mlx_audio_tpu_torch.stt.models import mms
    from mlx_audio_tpu_torch.tts.models import outetts, pocket_tts
    from mlx_audio_tpu_torch.stt.models import (fireredasr2, fun_asr_nano,
                                                sensevoice)
    from mlx_audio_tpu_torch.sts.models import mossformer2_se
    from mlx_audio_tpu_torch.vad.models import fsmn
    from mlx_audio_tpu_torch.stt.models import (granite_speech_nar,
                                                higgs_audio_3, lasr_ctc,
                                                moonshine, moss_music,
                                                moss_transcribe_diarize)

    from mlx_audio_tpu_torch.sts.models import lfm_audio
    from mlx_audio_tpu_torch.vad.models import smart_turn, sortformer
    from mlx_audio_tpu_torch.codec.models import dacvae
    from mlx_audio_tpu_torch.sts.models import sam_audio
    from mlx_audio_tpu_torch.stt.eval import runner

    last_stt = {f"{m.__name__.rsplit('.', 1)[-1]}.Model": (
        m.Model.__init__, lambda p, m=m: m.Model(m.ModelConfig()))
        for m in (lasr_ctc, moonshine, moss_transcribe_diarize,
                  higgs_audio_3, granite_speech_nar, moss_music, smart_turn,
                  sortformer, lfm_audio)}
    last_stt["lfm_audio.LFM2AudioDetokenizer"] = (
        lfm_audio.LFM2AudioDetokenizer.__init__,
        lambda p: lfm_audio.LFM2AudioDetokenizer())
    last_stt["lfm_audio.LFM2AudioProcessor.from_pretrained"] = (
        lfm_audio.LFM2AudioProcessor.from_pretrained,
        lambda p: lfm_audio.LFM2AudioProcessor.from_pretrained(
            str(p), config=lfm_audio.ModelConfig()))
    last_stt["sam_audio.Model"] = (sam_audio.Model.__init__,
                                   lambda p: sam_audio.Model())
    last_stt["dacvae.Model"] = (dacvae.Model.__init__, lambda p: dacvae.Model())
    from mlx_audio_tpu_torch.tts.models import (kitten_tts, omnivoice, soprano,
                                                voxtral_tts)

    for m in (soprano, voxtral_tts, omnivoice):
        last_stt[f"{m.__name__.rsplit('.', 1)[-1]}.Model"] = (
            m.Model.__init__, lambda p, m=m: m.Model(m.ModelConfig()))
    from mlx_audio_tpu_torch.tts.models import (moss_tts, moss_tts_delay,
                                                moss_tts_local, tada)

    for m in (tada, moss_tts, moss_tts_delay, moss_tts_local):
        last_stt[f"{m.__name__.rsplit('.', 1)[-1]}.Model"] = (
            m.Model.__init__, lambda p, m=m: m.Model(m.ModelConfig()))
    last_stt["kitten_tts.Model"] = (
        kitten_tts.Model.__init__,
        lambda p: kitten_tts.Model(kitten_tts.ModelConfig()))
    last_stt["stt.eval.run_stt_wer_eval"] = (
        runner.run_stt_wer_eval,
        lambda p: runner.run_stt_wer_eval(str(p), [], p.parent / "out",
                                          dataset_name="t"))
    return last_stt | {
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
        "parakeet.Model": (parakeet.Model.__init__,
                           lambda p: parakeet.Model(parakeet.ModelConfig())),
        "canary.Model": (canary.Model.__init__,
                         lambda p: canary.Model(canary.ModelConfig())),
        "nemotron_asr.Model": (
            nemotron_asr.Model.__init__,
            lambda p: nemotron_asr.Model(nemotron_asr.ModelConfig())),
        "llama.Model": (llama.Model.__init__,
                        lambda p: llama.Model(llama.ModelConfig())),
        "kugelaudio.Model": (kugelaudio.Model.__init__,
                             lambda p: kugelaudio.Model(
                                 kugelaudio.ModelConfig())),
        "vibevoice.Model": (vibevoice.Model.__init__,
                            lambda p: vibevoice.Model(vibevoice.ModelConfig())),
        "mimi.Mimi": (mimi.Mimi.__init__, lambda p: mimi.Mimi()),
        "mimi.Mimi.from_pretrained": (mimi.Mimi.from_pretrained,
                                      lambda p: mimi.Mimi.from_pretrained(p)),
        "sesame.Model": (sesame.Model.__init__,
                         lambda p: sesame.Model(sesame.ModelConfig())),
        "tts.utils.load_model": (utils.load_model,
                                 lambda p: utils.load_model(p)),
        "stt.utils.load_model": (stt_utils.load_model,
                                 lambda p: stt_utils.load_model(p)),
        "mlx_audio_tpu_torch.load_model": (
            mlx_audio_tpu_torch.load_model,
            lambda p: mlx_audio_tpu_torch.load_model(p)),
        "silero_vad.Model": (silero_vad.Model.__init__,
                             lambda p: silero_vad.Model(
                                 silero_vad.ModelConfig())),
        "vad.utils.load_model": (vad_utils.load_model,
                                 lambda p: vad_utils.load_model(p)),
        "server.ModelProvider": (server.ModelProvider.__init__,
                                 lambda p: server.ModelProvider()),
        "server.AudioServer": (server.AudioServer.__init__,
                               lambda p: server.AudioServer()),
        "tts.generate.generate_audio": (
            generate.generate_audio,
            lambda p: generate.generate_audio("hi", model_path=str(p))),
        "moshi.Model": (moshi.Model.__init__,
                        lambda p: moshi.Model(moshi.ModelConfig())),
        "mel_roformer.Model": (mel_roformer.Model.__init__,
                               lambda p: mel_roformer.Model(
                                   mel_roformer.MelRoFormerConfig())),
        "deepfilternet.Model": (deepfilternet.Model.__init__,
                                lambda p: deepfilternet.Model(
                                    deepfilternet.DeepFilterNetConfig())),
        "sts.utils.load_model": (sts_utils.load_model,
                                 lambda p: sts_utils.load_model(p)),
        "llama.BackboneModel": (llama.BackboneModel.__init__,
                                lambda p: llama.BackboneModel(
                                    llama.BackboneConfig())),
        "snac.SNAC": (snac.SNAC.__init__, lambda p: snac.SNAC()),
        "codec.utils.load_model": (codec_utils.load_model,
                                   lambda p: codec_utils.load_model(p)),
        "convert.convert": (convert.convert,
                            lambda p: convert.convert(str(p))),
        "qwen3_asr.Model": (qwen3_asr.Model.__init__,
                            lambda p: qwen3_asr.Model(qwen3_asr.ModelConfig())),
        "qwen3_forced_aligner.Model": (
            qwen3_forced_aligner.Model.__init__,
            lambda p: qwen3_forced_aligner.Model(
                qwen3_forced_aligner.ModelConfig())),
        "mega_asr.Model": (mega_asr.Model.__init__,
                           lambda p: mega_asr.Model(mega_asr.ModelConfig())),
        "mega_asr.AudioQualityRouter": (
            mega_asr.AudioQualityRouter.__init__,
            lambda p: mega_asr.AudioQualityRouter({})),
        "qwen3.Model": (qwen3.Model.__init__,
                        lambda p: qwen3.Model(qwen3.ModelConfig())),
        "voxtral.Model": (voxtral.Model.__init__,
                          lambda p: voxtral.Model(voxtral.ModelConfig())),
        "qwen2_audio.Model": (qwen2_audio.Model.__init__,
                              lambda p: qwen2_audio.Model(
                                  qwen2_audio.ModelConfig())),
        "glmasr.Model": (glmasr.Model.__init__,
                         lambda p: glmasr.Model(glmasr.ModelConfig())),
        "granite_speech.Model": (granite_speech.Model.__init__,
                                 lambda p: granite_speech.Model(
                                     granite_speech.ModelConfig())),
        "vibevoice_asr.Model": (vibevoice_asr.Model.__init__,
                                lambda p: vibevoice_asr.Model(
                                    vibevoice_asr.ModelConfig())),
        "descript.DAC": (descript.DAC.__init__, lambda p: descript.DAC()),
        "encodec.Encodec": (encodec.Encodec.__init__,
                            lambda p: encodec.Encodec()),
        "outetts.Model": (outetts.Model.__init__,
                          lambda p: outetts.Model(outetts.ModelConfig())),
        "pocket_tts.Model": (pocket_tts.Model.__init__,
                             lambda p: pocket_tts.Model(
                                 pocket_tts.ModelConfig())),
        "mms.Model": (mms.Model.__init__,
                      lambda p: mms.Model(mms.ModelConfig())),
        "lid.wav2vec2.Model": (lid_wav2vec2.Model.__init__,
                               lambda p: lid_wav2vec2.Model(
                                   lid_wav2vec2.ModelConfig())),
        "lid.ecapa_tdnn.Model": (ecapa_tdnn.Model.__init__,
                                 lambda p: ecapa_tdnn.Model(
                                     ecapa_tdnn.ModelConfig())),
        "lid.utils.load_model": (lid_utils.load_model,
                                 lambda p: lid_utils.load_model(p)),
        "fsmn.Model": (fsmn.Model.__init__,
                       lambda p: fsmn.Model(fsmn.ModelConfig())),
        "sensevoice.Model": (sensevoice.Model.__init__,
                             lambda p: sensevoice.Model(
                                 sensevoice.ModelConfig())),
        "fun_asr_nano.Model": (fun_asr_nano.Model.__init__,
                               lambda p: fun_asr_nano.Model(
                                   fun_asr_nano.ModelConfig())),
        "fireredasr2.Model": (fireredasr2.Model.__init__,
                              lambda p: fireredasr2.Model(
                                  fireredasr2.ModelConfig())),
        "mossformer2_se.Model": (mossformer2_se.Model.__init__,
                                 lambda p: mossformer2_se.Model(
                                     mossformer2_se.ModelConfig())),
    }


@pytest.mark.parametrize("name", ["kokoro.Model", "qwen3_tts.Model",
                                  "whisper.Model", "voxtral_realtime.Model",
                                  "cohere_asr.Model", "parakeet.Model",
                                  "canary.Model", "nemotron_asr.Model",
                                  "llama.Model",
                                  "kugelaudio.Model", "vibevoice.Model",
                                  "mimi.Mimi", "mimi.Mimi.from_pretrained",
                                  "sesame.Model",
                                  "tts.utils.load_model",
                                  "stt.utils.load_model",
                                  "mlx_audio_tpu_torch.load_model",
                                  "silero_vad.Model", "vad.utils.load_model",
                                  "server.ModelProvider",
                                  "server.AudioServer",
                                  "tts.generate.generate_audio",
                                  "moshi.Model", "mel_roformer.Model",
                                  "deepfilternet.Model",
                                  "sts.utils.load_model",
                                  "llama.BackboneModel", "snac.SNAC",
                                  "codec.utils.load_model",
                                  "convert.convert", "qwen3_asr.Model",
                                  "qwen3_forced_aligner.Model",
                                  "mega_asr.Model",
                                  "mega_asr.AudioQualityRouter",
                                  "qwen3.Model", "voxtral.Model",
                                  "qwen2_audio.Model", "glmasr.Model",
                                  "granite_speech.Model",
                                  "vibevoice_asr.Model", "descript.DAC",
                                  "encodec.Encodec", "outetts.Model",
                                  "pocket_tts.Model", "mms.Model",
                                  "lid.wav2vec2.Model",
                                  "lid.ecapa_tdnn.Model",
                                  "lid.utils.load_model", "fsmn.Model",
                                  "sensevoice.Model", "fun_asr_nano.Model",
                                  "fireredasr2.Model",
                                  "mossformer2_se.Model", "lasr_ctc.Model",
                                  "moonshine.Model",
                                  "moss_transcribe_diarize.Model",
                                  "higgs_audio_3.Model",
                                  "granite_speech_nar.Model",
                                  "moss_music.Model", "smart_turn.Model",
                                  "sortformer.Model", "lfm_audio.Model",
                                  "lfm_audio.LFM2AudioDetokenizer",
                                  "lfm_audio.LFM2AudioProcessor."
                                  "from_pretrained", "sam_audio.Model",
                                  "dacvae.Model",
                                  "stt.eval.run_stt_wer_eval",
                                  "kitten_tts.Model", "soprano.Model",
                                  "voxtral_tts.Model", "omnivoice.Model",
                                  "tada.Model", "moss_tts.Model",
                                  "moss_tts_delay.Model",
                                  "moss_tts_local.Model"])
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


def test_server_core_runs_without_aiohttp_or_jax():
    """The server's request core in a fresh interpreter on the CPU: a
    speech request to a fake model, a transcription, and a /v1/realtime
    session with server_vad over the port's Silero, called directly. Neither
    aiohttp, jax nor mlx_audio_tpu is imported."""
    out = _run("""
        import asyncio, base64, sys
        import numpy as np
        from mlx_audio_tpu_torch.server import AudioServer
        from mlx_audio_tpu_torch.stt.models.base import STTOutput
        from mlx_audio_tpu_torch.vad.models.silero_vad import (Model,
                                                               ModelConfig)

        class Result:
            audio = np.full(480, 0.25, np.float32)
            sample_rate = 24000

        class TTS:
            def generate(self, text, **kw):
                yield Result()

        class STT:
            def generate(self, audio, **kw):
                return STTOutput(text=f"{len(audio)} samples")

        async def go():
            server = AudioServer(device="cpu")
            vad = Model(ModelConfig(), device="cpu").init_params(0)
            server.provider._models.update(tts=TTS(), stt=STT(), vad=vad)
            sent = []

            async def send(event):
                sent.append(event["type"])

            reply = await server.speech({"model": "tts", "input": "hi",
                                         "response_format": "pcm"})
            body = await reply.read()
            reply = await server.transcribe({"model": "stt"}, None)
            assert reply.status == 400
            import os
            os.environ["MLX_AUDIO_VAD_MODEL"] = "vad"
            session = await server.open_realtime("stt", send)
            pcm = (np.random.RandomState(0).randn(16000) * 3000).astype("<i2")
            await session.on_event({"type": "input_audio_buffer.append",
                                    "audio": base64.b64encode(
                                        pcm.tobytes()).decode()})
            await session.on_event({"type": "input_audio_buffer.commit"})
            server.close()
            return len(body), sent

        n, sent = asyncio.run(go())
        assert n == 960 and sent[0] == "session.created", (n, sent)
        assert sent[-1].endswith("transcription.completed"), sent
        print(sorted(m for m in sys.modules if m.split(".")[0] == "aiohttp"),
              %s)
    """ % FORBIDDEN)
    assert out.strip() == "[] []", out


def test_tts_cli_runs_without_jax(tmp_path):
    """python -m mlx_audio_tpu_torch.tts.generate --device cpu on a tiny
    Kokoro checkpoint (npz, torch's names) in a fresh interpreter: it
    writes the WAV, and neither jax nor mlx_audio_tpu is imported."""
    ckpt = tmp_path / "kokoro-tiny"
    _run("""
        import dataclasses, json, pathlib
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
            vocab={c: i + 1 for i, c in enumerate("abcdefghijklmnopqrstuvwxyz ")},
            compute_dtype="float32", transfer_dtype="float32")
        model = Model(cfg, device="cpu").init_params(seed=0)
        d = pathlib.Path(%r)
        (d / "voices").mkdir(parents=True)
        np.savez(d / "model.npz", **{k: v.numpy() for k, v in
                                     model.state_dict().items()})
        (d / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
        np.save(d / "voices" / "af_test.npy",
                np.random.RandomState(0).randn(510, 1, 32).astype(np.float32))
    """ % str(ckpt))
    out = _run("""
        import runpy, sys
        sys.argv = ["generate", "--model", %r, "--text", "hello there",
                    "--voice", "af_test", "--output_path", %r,
                    "--device", "cpu", "--no-verbose"]
        runpy.run_module("mlx_audio_tpu_torch.tts.generate",
                         run_name="__main__")
        print(%s)
    """ % (str(ckpt), str(tmp_path / "out"), FORBIDDEN))
    assert out.strip() == "[]", out
    assert (tmp_path / "out" / "audio_000.wav").stat().st_size > 44


def test_ui_copy_equals_the_jax_package():
    """The port's studio UI files are the JAX package's, byte for byte."""
    jax_dir = os.path.join(REPO, "mlx_audio_tpu", "ui", "static")
    port_dir = os.path.join(REPO, "mlx_audio_tpu_torch", "ui", "static")
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir)) and "index.html" in names
    for name in names:
        with open(os.path.join(jax_dir, name), "rb") as a, \
                open(os.path.join(port_dir, name), "rb") as b:
            assert a.read() == b.read(), name
