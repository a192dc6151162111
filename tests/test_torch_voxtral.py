"""Offline Voxtral of the PyTorch port against the JAX package, on the CPU:
the Tekken tokenizer, the audio tower, the 30-s chunking (one whole chunk,
a ragged one, and 45 s: a whole chunk and a ragged one) and the
projector, the prompt, greedy `generate`, `sanitize` on a torch-layout and
an MLX-layout checkpoint, an MLX-packed 8-bit directory through both
packages' loaders, and a bf16 model; then the port's own rules (a seeded
sampled run and its filters, the device).

Config: tests/test_voxtral.py's `tiny_cfg` and its `make_tekken`; one
parameter tree drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`), bound into both packages. The JAX
package runs its own jitted tower and decode. Tower rows and audio
embeddings at ATOL = 2e-4 (f32, summation order); greedy tokens and text
equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
MAX_TOKENS = 24


CFG = dict(
    audio_config=dict(d_model=32, encoder_layers=2,
                      encoder_attention_heads=4, encoder_ffn_dim=64,
                      num_mel_bins=32, max_source_positions=1500,
                      intermediate_size=128),
    text_config=dict(hidden_size=32, num_hidden_layers=2,
                     intermediate_size=64, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=8,
                     vocab_size=1200, rope_theta=1e8),
    audio_token_id=24)


def make_pair(tekken, cfg=CFG, seed=0):
    """(JAX model, port model) from one numpy-drawn tree, each with its
    package's TekkenEncoder over `tekken`."""
    import mlx_audio_tpu.stt.models.voxtral.voxtral as jv
    import mlx_audio_tpu_torch.stt.models.voxtral as pv
    from mlx_audio_tpu_torch.model import load_jax_params

    jm = jv.Model(jv.ModelConfig.from_dict(cfg))
    jm.bind(numpy_params(jm.init_params, seed))
    pm = load_jax_params(pv.Model(pv.ModelConfig.from_dict(cfg),
                                  device="cpu"), flat_numpy(jm.params))
    jm._tekken = jv.TekkenEncoder(tekken)
    pm._tekken = pv.TekkenEncoder(tekken)
    return jm, pm


@pytest.fixture(scope="module")
def tekken(tmp_path_factory):
    from test_voxtral import make_tekken

    return make_tekken(tmp_path_factory.mktemp("tekken"))


@pytest.fixture(scope="module")
def pair(tekken):
    return make_pair(tekken)


def _audio(seed: int, seconds: float) -> np.ndarray:
    return (np.random.RandomState(seed).randn(int(16000 * seconds)) * 0.1
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# tokenizer, tower, embeddings
# ---------------------------------------------------------------------------


def test_tekken_encoder_equals_jax(tekken, tmp_path):
    """The copy encodes, decodes and names its specials as JAX's, on the
    JAX tests' tekken.json and on chip_smoke's."""
    from chip_smoke import write_mistral_tekken
    from mlx_audio_tpu.stt.models.voxtral.voxtral import TekkenEncoder as J
    from mlx_audio_tpu_torch.stt.models.voxtral import TekkenEncoder as P

    write_mistral_tekken(tmp_path / "tekken.json", 40, 1200)
    for path in (tekken, str(tmp_path / "tekken.json")):
        j, p = J(path), P(path)
        for text in ("lang:en hello world", "héllo <7> ünïcode", ""):
            assert p.encode_text(text) == j.encode_text(text)
        ids = list(range(0, 1200, 7))
        assert p.decode(ids) == j.decode(ids)
        assert p.special == j.special and p.eos_ids == j.eos_ids
        for name in ("<s>", "[AUDIO]", "[TRANSCRIBE]", "[/INST]", "nope"):
            assert p.special_id(name) == j.special_id(name)


def test_tower_equals_jax(pair):
    """(1, 100, n_mels) through the tower, JAX's jitted."""
    import jax

    from mlx_audio_tpu.stt.models.voxtral.voxtral import audio_tower_forward

    jm, pm = pair
    mel = np.random.RandomState(0).randn(1, 100, 32).astype(np.float32)
    want = jax.jit(lambda p, m: audio_tower_forward(
        p["audio_tower"], jm.config.audio_config, m))(jm.params, mel)
    got = pm.encode_mels(torch.from_numpy(mel))
    assert got.shape == (1, 50, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("seconds", [1.0, 30.0, 45.0])
def test_audio_embeds_equal_jax(pair, seconds):
    """One ragged chunk, one whole chunk, and a whole chunk then a ragged
    one (its log-mel zero-filled to 3,000 frames): 375 rows a chunk."""
    jm, pm = pair
    audio = _audio(int(seconds), seconds)
    want = np.asarray(jm.get_audio_embeds(audio))
    got = pm.get_audio_embeds(audio)
    assert got.shape == want.shape == (375 * int(np.ceil(seconds / 30)), 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_ragged_chunk_is_zero_filled_in_log_mel_space(pair):
    """The last chunk's log-mel is the chunk's own, then zeros (not the
    log-mel of silence), as JAX's get_audio_embeds fills it."""
    from mlx_audio_tpu_torch.stt.models.whisper.audio import \
        log_mel_spectrogram

    _, pm = pair
    audio = _audio(3, 31.0)
    mels = pm.chunk_mels(audio)
    assert mels.shape == (2, 3000, 32)
    own = log_mel_spectrogram(audio[480000:], n_mels=32)
    assert own.shape[0] == 100
    np.testing.assert_array_equal(mels[1, :100].numpy(), own.numpy())
    assert not mels[1, 100:].any()


def test_prompt_equals_jax(pair):
    jm, pm = pair
    for n, lang in ((5, "en"), (375, "fr")):
        assert pm._build_prompt_ids(n, lang) == jm._build_prompt_ids(n, lang)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs(pair):
    jm, _ = pair
    runs = {}
    for seconds in (2.0, 31.0):
        audio = _audio(10 + int(seconds), seconds)
        runs[seconds] = (audio, jm.generate(audio, language="en",
                                            max_tokens=MAX_TOKENS))
    return runs


@pytest.mark.parametrize("seconds", [2.0, 31.0])
def test_greedy_generate_equals_jax(pair, jax_runs, seconds):
    _, pm = pair
    audio, want = jax_runs[seconds]
    got = pm.generate(audio, language="en", max_tokens=MAX_TOKENS)
    assert want.generation_tokens > 0
    assert got.text == want.text
    assert (got.prompt_tokens, got.generation_tokens, got.language,
            got.segments) == (want.prompt_tokens, want.generation_tokens,
                              want.language, want.segments)
    run = pm.last_run
    assert run["tokens"] == got.generation_tokens
    assert run["audio_tokens"] == 375 * (1 + (seconds > 30))


def test_sampled_run_is_seeded_and_keeps_the_rules(pair, jax_runs):
    """A seed repeats its text; top-k 1 and min-p 1 leave only the argmax,
    so they decode JAX's greedy text."""
    _, pm = pair
    audio, want = jax_runs[2.0]
    kw = dict(language="en", max_tokens=MAX_TOKENS, temperature=1.0)
    a = pm.generate(audio, seed=3, **kw).text
    assert pm.generate(audio, seed=3, **kw).text == a
    for rule in (dict(top_k=1), dict(min_p=1.0)):
        assert pm.generate(audio, seed=5, **kw, **rule).text == want.text


def test_bf16_model_runs_against_f32_caches(pair):
    from mlx_audio_tpu_torch.model import jax_params, load_jax_params
    from mlx_audio_tpu_torch.stt.models.voxtral import Model, ModelConfig

    _, pm = pair
    m = load_jax_params(Model(ModelConfig.from_dict(CFG), device="cpu"),
                        {k: v.numpy() for k, v in jax_params(pm).items()})
    m.astype(torch.bfloat16)
    m._tekken = pm._tekken
    emb = m.get_audio_embeds(_audio(1, 1.0))
    assert emb.dtype == torch.bfloat16 and torch.isfinite(emb).all()
    out = m.generate(_audio(1, 1.0), max_tokens=8)
    assert isinstance(out.text, str) and out.generation_tokens <= 8


def test_default_device_is_the_card():
    from mlx_audio_tpu_torch.stt.models.voxtral import Model, ModelConfig

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(ModelConfig.from_dict(CFG))


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["torch", "mlx"])
def test_sanitize_reads_each_conv_layout(pair, tmp_path, layout):
    """A torch-layout and an MLX-layout checkpoint of one model bind to the
    same weights; JAX's sanitize reads the torch one right and misreads
    the MLX one's conv1 (O, K, I) = (32, 3, 32), whose first axis is not
    the longer, as WIO."""
    from chip_smoke import write_llm_stt_checkpoint
    from mlx_audio_tpu.stt.models.voxtral.voxtral import Model as JModel
    from mlx_audio_tpu_torch.stt.utils import load_model
    from mlx_audio_tpu_torch.utils import load_weights

    jm, pm = pair
    write_llm_stt_checkpoint(pm, tmp_path / layout, conv=layout)
    got = load_model(tmp_path / layout, device="cpu")
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(got.state_dict()[k].numpy(),
                                      v.numpy(), err_msg=k)
    raw = load_weights(tmp_path / layout)
    jax_conv1 = np.asarray(JModel.sanitize(jm, raw)
                           ["audio_tower.conv1.weight"])
    want = np.asarray(jm.params["audio_tower"]["conv1"]["weight"])
    if layout == "torch":
        np.testing.assert_array_equal(jax_conv1, want)
    else:
        assert jax_conv1.shape != want.shape or not np.array_equal(
            jax_conv1, want)
    bad = {"audio_tower.conv1.weight": np.zeros((32, 32, 5), np.float32)}
    with pytest.raises(ValueError, match="conv1"):
        pm.sanitize(bad)


def test_packed_q8_directory_generates_as_jax(pair, tekken, tmp_path):
    """An MLX-packed 8-bit checkpoint (group 32: the projector and every
    LM linear and the token table packed, the tower dense, as
    `model_quant_predicate` says) through both packages' STT loaders: the
    packed linears on the port's QuantizedLinear (K2 on the card); greedy
    text equal to JAX's, the audio embeddings within ATOL."""
    import shutil

    from chip_smoke import write_llm_stt_checkpoint
    from mlx_audio_tpu.stt.utils import load_model as jax_load
    from mlx_audio_tpu_torch.nn import Embedding, Linear, QuantizedLinear
    from mlx_audio_tpu_torch.stt.models.voxtral import Model
    from mlx_audio_tpu_torch.stt.utils import load_model

    _, src = make_pair(tekken, seed=1)
    d = tmp_path / "voxtral-q8"
    write_llm_stt_checkpoint(src, d, bits=8, group_size=32)
    shutil.copy(tekken, d / "tekken.json")
    pm = load_model(d, device="cpu")
    jm = jax_load(str(d))
    assert isinstance(pm, Model) and pm._tekken is not None
    held = [n for n, m in pm.named_modules() if isinstance(m, QuantizedLinear)]
    assert len(held) == 2 + 7 * 2 + 1                # projector, LM, head
    assert all(not n.startswith("audio_tower") for n in held)
    assert isinstance(pm.audio_tower.layers[0].fc1, Linear)
    assert isinstance(pm.language_model.model.embed_tokens, Embedding)
    audio = _audio(7, 2.0)
    want = jm.generate(audio, max_tokens=MAX_TOKENS)
    got = pm.generate(audio, max_tokens=MAX_TOKENS)
    assert got.text == want.text and got.generation_tokens > 0
    np.testing.assert_allclose(pm.get_audio_embeds(audio).numpy(),
                               np.asarray(jm.get_audio_embeds(audio)),
                               atol=ATOL)
