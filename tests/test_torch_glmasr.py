"""GLM-ASR of the PyTorch port against the JAX package, on the CPU: the
slaney log-mel, the encoder and adapter with RoPE and with learned
positions (an even frame count against JAX's `encode`; an odd one against
JAX's `encode_audio` on the unpadded mel, where JAX's bucketed `encode`
departs), the merged counts, greedy `generate` over one and several
chunks, `stream_transcribe`, the repetition penalty, `sanitize` (HF names
in torch and MLX conv layouts, and the JAX tree); then the port's own
rules (a seeded sampled run and its filters, the tokenizer checks).

Config: tests/test_glmasr.py's `_cfg` and its `_FakeTok`; one parameter
tree drawn with numpy over JAX's shapes (`test_torch_mimi.numpy_params`),
bound into both packages. The JAX package runs its own jitted encoder and
decode. Encoder rows at ATOL = 2e-4 (f32, summation order); the log-mel
at 1e-5; greedy tokens and text equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402
from test_torch_voxtral import one_torch_thread  # noqa: E402,F401

ATOL = 2e-4
MAX_TOKENS = 24


def cfg(use_rope=True) -> dict:
    return dict(
        model_type="glmasr", merge_factor=2, use_rope=use_rope,
        max_whisper_length=1500,
        whisper_config=dict(d_model=16, encoder_attention_heads=2,
                            encoder_ffn_dim=32, encoder_layers=1,
                            num_mel_bins=16),
        lm_config=dict(vocab_size=64, hidden_size=16,
                       intermediate_size=32, num_hidden_layers=1,
                       num_attention_heads=2, num_key_value_heads=2,
                       head_dim=8, tie_word_embeddings=False,
                       eos_token_id=[3]))


def fake_tok():
    from test_glmasr import _FakeTok

    return _FakeTok()


def make_pair(use_rope=True, seed=0, tok=True):
    import mlx_audio_tpu.stt.models.glmasr as jg
    import mlx_audio_tpu_torch.stt.models.glmasr as pg
    from mlx_audio_tpu_torch.model import load_jax_params

    jm = jg.Model(jg.ModelConfig.from_dict(cfg(use_rope)))
    jm.bind(numpy_params(jm.init_params, seed))
    pm = load_jax_params(pg.Model(pg.ModelConfig.from_dict(cfg(use_rope)),
                                  device="cpu"), flat_numpy(jm.params))
    if tok:
        jm._tokenizer, pm._tokenizer = fake_tok(), fake_tok()
    return jm, pm


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _audio(seed: int, seconds: float) -> np.ndarray:
    return (np.random.RandomState(seed).randn(int(16000 * seconds)) * 0.1
            ).astype(np.float32)


def _tight(jm, mel: np.ndarray, n_merged: int) -> np.ndarray:
    """JAX's encode_audio on the unpadded mel, jitted."""
    import jax

    from mlx_audio_tpu.stt.models.glmasr.glmasr import encode_audio

    n = mel.shape[0]
    return np.asarray(jax.jit(lambda p, m: encode_audio(
        p["audio_encoder"], jm.config, m, n, n_merged))(jm.params, mel[None]))


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------


def test_mel_and_counts_equal_jax(pair):
    jm, pm = pair
    audio = _audio(0, 1.3)
    np.testing.assert_allclose(pm._mel(audio).numpy(),
                               np.asarray(jm._mel(audio)), atol=1e-5)
    for n in (4, 5, 99, 100, 101, 2999, 3000, 4000):
        enc = (min(n, 3000) - 1) // 2 + 1
        assert pm.merged_count(min(n, 3000)) == min((enc - 2) // 2 + 1, 750)


@pytest.mark.parametrize("use_rope", [True, False])
def test_encode_equals_jax_at_an_even_frame_count(use_rope):
    """100 mel frames: JAX's bucketed `encode` and the unpadded run agree."""
    jm, pm = make_pair(use_rope)
    audio = _audio(1, 1.0)
    want, n_want = jm.encode(audio)
    got, n = pm.encode(audio)
    assert n == n_want == 25 and got.shape == (1, 25, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("samples", [16160, 12000])
def test_odd_frame_count_runs_unpadded(pair, samples):
    """101 and 75 mel frames: the port equals JAX's encoder on the
    unpadded mel; JAX's `encode` pads to a bucket, and its stride-2 conv
    then reads the first padded frame's conv1 output (GELU of the bias),
    so every row departs."""
    jm, pm = pair
    audio = _audio(2, samples / 16000)
    mel = np.asarray(jm._mel(audio))
    assert mel.shape[0] % 2 == 1
    got, n = pm.encode(audio)
    tight = _tight(jm, mel, n)
    np.testing.assert_allclose(got.numpy(), tight, atol=ATOL)
    padded, _ = jm.encode(audio)
    assert np.abs(np.asarray(padded) - tight).max() > 10 * ATOL


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs(pair):
    jm, _ = pair
    audio = _audio(3, 2.0)
    long = _audio(8, 5.0)
    kw = dict(max_tokens=MAX_TOKENS)
    return {"audio": audio, "long": long,
            "greedy": jm.generate(audio, **kw),
            "chunks": jm.generate(long, chunk_duration=2.0, **kw),
            "stream": list(jm.stream_transcribe(long, chunk_duration=2.0,
                                                **kw)),
            "rep": jm.generate(audio, repetition_penalty=1.5, **kw)}


def test_long_audio_chunks_have_even_frame_counts(pair, jax_runs):
    """The chunks of the 5-s clip at chunk_duration 2 each have an even
    mel frame count, so JAX's bucketed encoder is exact on them and the
    decodes below compare token for token."""
    from mlx_audio_tpu_torch.stt.models.qwen3_asr.qwen3_asr import \
        split_audio_into_chunks

    _, pm = pair
    chunks = split_audio_into_chunks(jax_runs["long"], 16000, 2.0, 1.0)
    assert len(chunks) == 2
    assert all(pm._mel(w).shape[0] % 2 == 0 for w, _ in chunks)


@pytest.mark.parametrize("run", ["greedy", "chunks", "rep"])
def test_greedy_generate_equals_jax(pair, jax_runs, run):
    _, pm = pair
    want = jax_runs[run]
    audio = jax_runs["long" if run == "chunks" else "audio"]
    kw = dict(max_tokens=MAX_TOKENS)
    if run == "chunks":
        kw["chunk_duration"] = 2.0
    if run == "rep":
        kw["repetition_penalty"] = 1.5
    got = pm.generate(audio, **kw)
    assert want.generation_tokens > 0
    assert got.text == want.text
    assert (got.prompt_tokens, got.generation_tokens, got.language,
            got.segments) == (want.prompt_tokens, want.generation_tokens,
                              want.language, want.segments)


def test_stream_transcribe_equals_jax(pair, jax_runs):
    _, pm = pair
    got = list(pm.stream_transcribe(jax_runs["long"], chunk_duration=2.0,
                                    max_tokens=MAX_TOKENS))
    assert [vars(r) for r in got] == [vars(r) for r in jax_runs["stream"]]
    assert got[-1].is_final
    streamed = list(pm.generate(jax_runs["long"], chunk_duration=2.0,
                                max_tokens=MAX_TOKENS, stream=True))
    assert [vars(r) for r in streamed] == [vars(r) for r in got]


def test_sampled_run_is_seeded_and_keeps_the_rules(pair, jax_runs):
    _, pm = pair
    kw = dict(max_tokens=MAX_TOKENS, temperature=1.0)
    a = pm.generate(jax_runs["audio"], seed=3, **kw).text
    assert pm.generate(jax_runs["audio"], seed=3, **kw).text == a
    for rule in (dict(top_k=1), dict(min_p=1.0), dict(top_p=1e-6)):
        assert pm.generate(jax_runs["audio"], seed=5, **kw, **rule).text \
            == jax_runs["greedy"].text


def test_text_without_a_tokenizer_raises():
    _, pm = make_pair(tok=False)
    with pytest.raises(RuntimeError, match="tokenizer"):
        pm.generate(np.zeros(8000, np.float32))
    with pytest.raises(RuntimeError, match="tokenizer"):
        next(pm.generate(np.zeros(8000, np.float32), stream=True))


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def _hf_names(state: dict) -> dict:
    """The port's (the JAX tree's) names as an HF GLM-ASR checkpoint holds
    them: `adapting.{0,2}`, the LM at the root."""
    out = {}
    for k, v in state.items():
        k = k.replace(".adapting.fc1.", ".adapting.0.").replace(
            ".adapting.fc2.", ".adapting.2.")
        if k.startswith("language_model."):
            k = k[len("language_model."):]
        out[k] = v
    return out


def test_sanitize_equals_jax_on_its_remaps(pair):
    jm, pm = pair
    rs = np.random.RandomState(5)
    raw = {"audio_encoder.adapting.0.weight": rs.randn(32, 32),
           "audio_encoder.adapting.2.bias": rs.randn(16),
           "model.layers.0.self_attn.q_proj.weight": rs.randn(16, 16),
           "lm_head.weight": rs.randn(64, 16),
           "audio_encoder.whisper.conv1.weight": rs.randn(16, 16, 3)}
    raw = {k: v.astype(np.float32) for k, v in raw.items()}
    got, want = pm.sanitize(dict(raw)), jm.sanitize(dict(raw))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    flat = flat_numpy(jm.params)
    again = pm.sanitize(flat)
    assert set(again) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(again[k], flat[k])


@pytest.mark.parametrize("layout", ["torch", "mlx"])
def test_checkpoint_binds_from_each_conv_layout(pair, tmp_path, layout):
    """HF names with torch and with MLX conv layouts bind to the same
    weights through `load_model`; greedy text equal to JAX's model."""
    from safetensors.numpy import save_file

    from chip_smoke import write_llm_stt_checkpoint
    from mlx_audio_tpu_torch.stt.models.glmasr import Model
    from mlx_audio_tpu_torch.stt.utils import load_model
    from mlx_audio_tpu_torch.utils import load_weights

    jm, pm = pair
    d = tmp_path / layout
    write_llm_stt_checkpoint(pm, d, conv=layout)
    save_file(_hf_names(load_weights(d)), str(d / "model.safetensors"))
    got = load_model(d, device="cpu")
    assert isinstance(got, Model) and got._tokenizer is None
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(got.state_dict()[k].numpy(),
                                      v.numpy(), err_msg=k)


def test_post_load_hook_reads_only_the_local_directory(tmp_path,
                                                      monkeypatch):
    """No tokenizer files: no tokenizer; files that fail to load raise,
    where JAX's hook swallows the error; the code in the directory is
    trusted, as JAX's hook trusts it."""
    import sys
    import types

    from mlx_audio_tpu_torch.stt.models.glmasr import Model, ModelConfig

    m = Model(ModelConfig.from_dict(cfg()), device="cpu")
    assert Model.post_load_hook(m, tmp_path)._tokenizer is None
    seen = {}

    def broken(path, **kw):
        seen.update(kw)
        raise OSError(f"cannot read the tokenizer in {path}")

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=broken)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    (tmp_path / "tokenizer.json").write_text("{not json")
    with pytest.raises(OSError, match="tokenizer"):
        Model.post_load_hook(m, tmp_path)
    assert seen == {"trust_remote_code": True}
