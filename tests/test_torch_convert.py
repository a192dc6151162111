"""The PyTorch port's convert CLI (`mlx_audio_tpu_torch.convert`) against
tests/test_convert.py and the JAX package's CLI, on the CPU: convert and
reload, quantized fidelity, the dequantize round trip, the exclusive
flags, domain detection; a directory converted by the JAX package loads in
the port with JAX's logits, and one converted by the port loads in the
JAX package with the port's; and the port's departures (local paths only,
no upload, no revision).

Models are tiny and seeded: tests/tiny_configs.py's Kokoro (the JAX
test's), a 2-layer llama (Orpheus) at d64. Logits across packages at
ATOL = 2e-4 (f32, summation order).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tiny_configs import tiny_kokoro_config  # noqa: E402
from test_torch_prequantized import no_hf_tokenizer  # noqa: E402,F401

ATOL = 2e-4
LLAMA = dict(model_type="llama", hidden_size=64, num_hidden_layers=2,
             intermediate_size=128, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, vocab_size=128)


def _write(path, flat, config):
    from safetensors.torch import save_file

    path.mkdir(parents=True, exist_ok=True)
    save_file({k: v.contiguous() for k, v in flat.items()},
              str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(config))
    return path


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A tiny Kokoro as the convert CLI writes one: the JAX tree
    (`model.jax_params`), marked converted."""
    from mlx_audio_tpu_torch.model import jax_params
    from mlx_audio_tpu_torch.tts.models.kokoro import Model, ModelConfig

    cfg = dict(dataclasses.asdict(tiny_kokoro_config()), model_type="kokoro",
               converted_by="mlx_audio_tpu.convert")
    m = Model(ModelConfig.from_dict(cfg), device="cpu").init_params(0)
    return _write(tmp_path_factory.mktemp("kokoro") / "src",
                  {k: v.float() for k, v in jax_params(m).items()}, cfg)


REF_S = np.random.RandomState(0).randn(1, 32).astype(np.float32)


def _synth(model, text="hɛlO"):
    audio, _ = model(text, REF_S, deterministic_noise=True)
    return np.asarray(audio)


def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def test_convert_and_reload(ckpt_dir, tmp_path):
    from mlx_audio_tpu_torch.convert import convert
    from mlx_audio_tpu_torch.tts.utils import load_model

    out = convert(str(ckpt_dir), mlx_path=str(tmp_path / "out"),
                  dtype="float32", device="cpu")
    assert (out / "model.safetensors").exists()
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["converted_by"] == "mlx_audio_tpu.convert"
    from safetensors import safe_open

    with safe_open(str(out / "model.safetensors"), framework="pt") as f:
        assert f.metadata() == {"format": "mlx_audio_tpu", "domain": "tts"}
    a = _synth(load_model(out, device="cpu"))
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, _synth(load_model(ckpt_dir, device="cpu")),
                               atol=1e-5)


def test_quantized_convert_fidelity(ckpt_dir, tmp_path):
    from mlx_audio_tpu_torch.convert import convert
    from mlx_audio_tpu_torch.nn import Embedding, QuantizedLinear
    from mlx_audio_tpu_torch.tts.utils import load_model

    out = convert(str(ckpt_dir), mlx_path=str(tmp_path / "q8"),
                  dtype="float32", quantize=True, q_bits=8, q_group_size=16,
                  device="cpu")
    mq = load_model(out, device="cpu")
    assert sum(isinstance(m, QuantizedLinear) for m in mq.modules()) > 10
    assert isinstance(mq.bert.embeddings.word_embeddings, Embedding)
    aq = _synth(mq, "hɛlO wɜɹld")
    ad = _synth(load_model(ckpt_dir, device="cpu"), "hɛlO wɜɹld")
    assert _rel(aq, ad) < 0.5


def test_dequantize_roundtrip(ckpt_dir, tmp_path):
    """quantize, then --dequantize: dense weights come back, the config's
    quantization block goes, and the audio stays that of the quantized
    model."""
    from mlx_audio_tpu_torch.convert import convert
    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.tts.utils import load_model

    q = convert(str(ckpt_dir), mlx_path=str(tmp_path / "q"),
                dtype="float32", quantize=True, q_bits=8, q_group_size=16,
                device="cpu")
    d = convert(str(q), mlx_path=str(tmp_path / "dq"), dtype="float32",
                dequantize=True, device="cpu")
    assert "quantization" not in json.loads((d / "config.json").read_text())
    md = load_model(d, device="cpu")
    assert not any(isinstance(m, QuantizedLinear) for m in md.modules())
    assert _rel(_synth(load_model(q, device="cpu")), _synth(md)) < 1e-2


def test_quantize_dequantize_exclusive(ckpt_dir, tmp_path):
    from mlx_audio_tpu_torch.convert import convert

    with pytest.raises(ValueError, match="mutually exclusive"):
        convert(str(ckpt_dir), mlx_path=str(tmp_path / "x"), quantize=True,
                dequantize=True, device="cpu")


@pytest.mark.parametrize("config,domain", [
    ({"model_type": "kokoro"}, "tts"), ({"model_type": "whisper"}, "stt"),
    ({"model_type": "moshi"}, "sts"), ({"model_type": "snac"}, "codec"),
    ({"model_type": "silero_vad"}, "vad"),
    ({"talker_config": {}}, "tts"), ({"n_audio_ctx": 1500}, "stt")])
def test_domain_detection_equals_jax(ckpt_dir, config, domain):
    from mlx_audio_tpu.convert import detect_model_domain as jax_detect
    from mlx_audio_tpu_torch.convert import Domain, detect_model_domain

    assert detect_model_domain(config, ckpt_dir) == Domain(domain)
    assert jax_detect(config, ckpt_dir).value == domain


def test_unknown_domain_raises(ckpt_dir):
    from mlx_audio_tpu_torch.convert import detect_model_domain

    with pytest.raises(ValueError, match="--domain"):
        detect_model_domain({"model_type": "zzz"}, ckpt_dir / "unknowable")


# ---------------------------------------------------------------------------
# one converted directory, both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llama_src(tmp_path_factory):
    """A tiny llama in the JAX tree's layout (JAX's init at seed 0), marked
    converted, and its JAX model."""
    from mlx_audio_tpu.tts.models.llama import Model, ModelConfig
    from mlx_audio_tpu.utils import flatten

    jm = Model(ModelConfig.from_dict(LLAMA)).init_and_bind(
        jax.random.PRNGKey(0))
    flat = {k: torch.from_numpy(np.array(v))
            for k, v in flatten(jm.params).items()}
    d = _write(tmp_path_factory.mktemp("llama") / "src", flat,
               dict(LLAMA, converted_by="mlx_audio_tpu.convert"))
    return d


TOKS = np.random.RandomState(0).randint(0, 128, (1, 8))


def jax_logits(path):
    from mlx_audio_tpu.tts.models.llama.llama import (llama_forward,
                                                      logits_from_hidden)
    from mlx_audio_tpu.tts.utils import load_model

    m = load_model(path, model_type="llama")
    return np.asarray(jax.jit(lambda p: logits_from_hidden(
        p, m.config, llama_forward(p, m.config, jnp.asarray(TOKS))[0]))(
            m.params))


def port_logits(path):
    from mlx_audio_tpu_torch.tts.models.llama import (llama_forward,
                                                      logits_from_hidden)
    from mlx_audio_tpu_torch.tts.utils import load_model

    m = load_model(path, device="cpu")
    return logits_from_hidden(m, llama_forward(
        m, torch.from_numpy(TOKS))[0]).numpy()


@pytest.mark.parametrize("kw", [{}, {"quantize": True, "q_bits": 4},
                                {"quantize": True, "q_mode": "nvfp4"},
                                {"quantize": True,
                                 "quant_predicate": "mixed_3_6"}],
                         ids=["dense", "q4", "nvfp4", "mixed_3_6"])
def test_converted_directories_load_in_both_packages(llama_src, tmp_path,
                                                     kw):
    """The JAX package's output loads in the port with JAX's logits, and
    the port's output in the JAX package with the port's; the two CLIs
    write the same keys and codes."""
    from mlx_audio_tpu.convert import convert as jax_convert
    from mlx_audio_tpu_torch.convert import convert
    from mlx_audio_tpu_torch.utils import load_weights

    jdir = jax_convert(str(llama_src), mlx_path=str(tmp_path / "jax"),
                       dtype="float32", domain="tts", **kw)
    pdir = convert(str(llama_src), mlx_path=str(tmp_path / "port"),
                   dtype="float32", domain="tts", device="cpu", **kw)
    jw, pw = load_weights(jdir), load_weights(pdir)
    assert set(jw) == set(pw)
    for k in jw:
        if jw[k].dtype == np.uint8:
            np.testing.assert_array_equal(pw[k], jw[k], err_msg=k)
    np.testing.assert_allclose(port_logits(jdir), jax_logits(jdir),
                               atol=ATOL)
    np.testing.assert_allclose(jax_logits(pdir), port_logits(pdir),
                               atol=ATOL)


def test_cli_main_writes_a_bf16_directory(llama_src, tmp_path):
    """`python -m mlx_audio_tpu_torch.convert` (its `main`) at the default
    dtype: bfloat16 floats on disk, loaded back in f32."""
    from safetensors import safe_open

    from mlx_audio_tpu_torch.convert import main

    out = tmp_path / "bf16"
    main(["--hf-path", str(llama_src), "--mlx-path", str(out), "-q",
          "--q-bits", "8", "--device", "cpu"])
    with safe_open(str(out / "model.safetensors"), framework="pt") as f:
        assert f.get_tensor("model.norm.weight").dtype == torch.bfloat16
        assert f.get_tensor("model.layers.0.mlp.up_proj.w_q").dtype \
            == torch.uint8
    assert np.isfinite(port_logits(out)).all()


# ---------------------------------------------------------------------------
# departures
# ---------------------------------------------------------------------------


def test_paths_are_local_only(tmp_path):
    from mlx_audio_tpu_torch.convert import convert

    with pytest.raises(FileNotFoundError, match="never downloads"):
        convert(str(tmp_path / "org-model"), mlx_path=str(tmp_path / "o"),
                device="cpu")


@pytest.mark.parametrize("kw,match", [
    ({"upload_repo": "me/model"}, "never uploads"),
    ({"revision": "main"}, "never downloads")])
def test_upload_and_revision_are_refused(llama_src, tmp_path, kw, match):
    from mlx_audio_tpu_torch.convert import convert, main

    with pytest.raises(ValueError, match=match):
        convert(str(llama_src), mlx_path=str(tmp_path / "o"), device="cpu",
                **kw)
    flag = "--upload-repo" if "upload_repo" in kw else "--revision"
    with pytest.raises(ValueError, match=match):
        main(["--hf-path", str(llama_src), "--mlx-path",
              str(tmp_path / "o"), flag, list(kw.values())[0], "--device",
              "cpu"])
    assert not (tmp_path / "o").exists()
