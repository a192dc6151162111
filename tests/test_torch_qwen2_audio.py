"""Qwen2-Audio of the PyTorch port against the JAX package, on the CPU: the
config and the sinusoids, the tower with its 2x pool (an odd frame count
too) and projector on 1 s and 30 s, the cut at 30 s, the prompt with and
without a tokenizer, greedy `generate` (with the repetition penalty too),
`sanitize` on a torch-layout and an MLX-layout checkpoint and without a
position table, an MLX-packed 4-bit directory through both packages'
loaders; then the port's own rules (a seeded sampled run and its filters,
the tokenizer hook, the device).

Config: tests/test_qwen2_audio.py's `tiny_cfg` and its `FakeTok`; one
parameter tree drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`), bound into both packages. The JAX
package runs its own jitted tower and decode. Audio embeddings at ATOL =
2e-4 (f32, summation order); greedy tokens and text equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402
from test_torch_voxtral import one_torch_thread  # noqa: E402,F401
from test_torch_prequantized import no_hf_tokenizer  # noqa: E402,F401

ATOL = 2e-4
MAX_TOKENS = 24

CFG = dict(
    audio_config=dict(d_model=32, encoder_layers=2,
                      encoder_attention_heads=4, encoder_ffn_dim=64,
                      num_mel_bins=32, max_source_positions=1500),
    text_config=dict(hidden_size=32, num_hidden_layers=2,
                     intermediate_size=64, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=8,
                     vocab_size=600, rope_theta=10000.0),
    audio_token_id=590, audio_bos_token_id=591, audio_eos_token_id=592)


def fake_tok():
    from test_qwen2_audio import FakeTok

    return FakeTok()


def make_pair(cfg=CFG, seed=0, tok=True):
    import mlx_audio_tpu.stt.models.qwen2_audio as jq
    import mlx_audio_tpu_torch.stt.models.qwen2_audio as pq
    from mlx_audio_tpu_torch.model import load_jax_params

    jm = jq.Model(jq.ModelConfig.from_dict(cfg))
    jm.bind(numpy_params(jm.init_params, seed))
    pm = load_jax_params(pq.Model(pq.ModelConfig.from_dict(cfg),
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


def test_config_and_sinusoids_equal_jax():
    from mlx_audio_tpu.stt.models.qwen2_audio import qwen2_audio as jq
    from mlx_audio_tpu_torch.stt.models.qwen2_audio import qwen2_audio as pq

    assert pq.sinusoids(1501, 32).tobytes() == jq.sinusoids(1501, 32) \
        .tobytes()
    for cfg in (CFG, {}, {"text_config": {"attention_bias": False}}):
        p, j = pq.ModelConfig.from_dict(cfg), jq.ModelConfig.from_dict(cfg)
        # the port's llama config adds `rope_scaling` (None here)
        assert {k: vars(p.text)[k] for k in vars(j.text)} == vars(j.text)
        assert p.text.rope_scaling is None
        assert vars(p.audio) == vars(j.audio)
    assert pq.ModelConfig().text.attention_bias
    m = pq.Model(pq.ModelConfig.from_dict(CFG), device="cpu").init_params(0)
    np.testing.assert_array_equal(
        m.audio_tower.embed_positions.weight.numpy(), pq.sinusoids(1501, 32))


@pytest.mark.parametrize("seconds", [1.0, 30.0])
def test_audio_embeds_equal_jax(pair, seconds):
    """750 pooled rows for any input up to 30 s."""
    jm, pm = pair
    audio = _audio(int(seconds), seconds)
    want, n_want = jm.get_audio_embeds(audio)
    got, n = pm.get_audio_embeds(audio)
    assert n == n_want == 750 and got.shape == (750, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_hears_only_the_first_30_seconds(pair):
    """40 s give the embeddings of their first 30 s, in both packages."""
    jm, pm = pair
    audio = _audio(5, 40.0)
    got, _ = pm.get_audio_embeds(audio)
    head, _ = pm.get_audio_embeds(audio[:480000])
    np.testing.assert_array_equal(got.numpy(), head.numpy())
    want, _ = jm.get_audio_embeds(audio)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_pool_drops_an_odd_last_frame(pair):
    """102 mel frames -> 51 conv frames -> 25 pooled rows: the 51st is
    dropped before the norm, as JAX's jitted tower does."""
    jm, pm = pair
    jm.get_audio_embeds(_audio(0, 1.0))
    tower = jm._jit_cache["tower"]
    mel = np.random.RandomState(1).randn(1, 102, 32).astype(np.float32)
    want = np.asarray(tower(jm.params, mel))
    got = pm.encode_mels(torch.from_numpy(mel))
    assert got.shape == want.shape == (1, 25, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_prompt_equals_jax(pair):
    jm, pm = pair
    for n, prompt in ((5, None), (750, "Say it in French.")):
        assert pm._build_prompt_ids(n, prompt) == \
            jm._build_prompt_ids(n, prompt)
    j0, p0 = make_pair(tok=False)
    assert p0._build_prompt_ids(4, None) == j0._build_prompt_ids(4, None) \
        == [591, 590, 590, 590, 590, 592]
    assert p0._eos_ids() == j0._eos_ids() == (151643, 151645)
    assert pm._eos_ids() == jm._eos_ids() == (599,)


@pytest.fixture(scope="module")
def jax_runs(pair):
    jm, _ = pair
    audio = _audio(2, 2.0)
    kw = dict(max_tokens=MAX_TOKENS)
    return audio, {"greedy": jm.generate(audio, **kw),
                   "rep": jm.generate(audio, repetition_penalty=1.5, **kw)}


@pytest.mark.parametrize("run", ["greedy", "rep"])
def test_greedy_generate_equals_jax(pair, jax_runs, run):
    _, pm = pair
    audio, runs = jax_runs
    want = runs[run]
    got = pm.generate(audio, max_tokens=MAX_TOKENS,
                      repetition_penalty=1.5 if run == "rep" else 1.0)
    assert want.generation_tokens > 0
    assert got.text == want.text
    assert (got.prompt_tokens, got.generation_tokens, got.language,
            got.segments) == (want.prompt_tokens, want.generation_tokens,
                              want.language, want.segments)
    assert pm.last_run["audio_tokens"] == 750


def test_sampled_run_is_seeded_and_keeps_the_rules(pair, jax_runs):
    _, pm = pair
    audio, runs = jax_runs
    kw = dict(max_tokens=MAX_TOKENS, temperature=1.0)
    a = pm.generate(audio, seed=3, **kw).text
    assert pm.generate(audio, seed=3, **kw).text == a
    for rule in (dict(top_k=1), dict(min_p=1.0), dict(top_p=1e-6)):
        assert pm.generate(audio, seed=5, **kw, **rule).text == \
            runs["greedy"].text


def test_default_device_is_the_card():
    from mlx_audio_tpu_torch.stt.models.qwen2_audio import Model, ModelConfig

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
    same weights; JAX's sanitize transposes a 3-D conv weight only when
    its first axis is the longer, so it reads the MLX one's conv1
    (32, 3, 32) as WIO."""
    from chip_smoke import write_llm_stt_checkpoint
    from mlx_audio_tpu_torch.stt.utils import load_model
    from mlx_audio_tpu_torch.utils import load_weights

    jm, pm = pair
    write_llm_stt_checkpoint(pm, tmp_path / layout, conv=layout)
    got = load_model(tmp_path / layout, device="cpu")
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(got.state_dict()[k].numpy(),
                                      v.numpy(), err_msg=k)
    raw = load_weights(tmp_path / layout)
    jax_conv1 = np.asarray(jm.sanitize(raw)["audio_tower.conv1.weight"])
    want = np.asarray(jm.params["audio_tower"]["conv1"]["weight"])
    assert np.array_equal(jax_conv1, want) == (layout == "torch")


def test_sanitize_fills_a_missing_position_table(pair):
    jm, pm = pair
    raw = {"audio_tower.layer_norm.weight": np.ones(32, np.float32)}
    got, want = pm.sanitize(dict(raw)), jm.sanitize(dict(raw))
    assert set(got) == set(want)
    np.testing.assert_array_equal(
        got["audio_tower.embed_positions.weight"],
        np.asarray(want["audio_tower.embed_positions.weight"]))
    renamed = pm.sanitize({"audio_tower.embed_positions": np.zeros((3, 2))})
    assert set(renamed) == {"audio_tower.embed_positions.weight"}


def test_packed_4bit_directory_generates_as_jax(tmp_path, no_hf_tokenizer):
    """An MLX-packed 4-bit checkpoint (group 32: the projector and every
    LM linear and the token table packed, the tower dense) through both
    packages' STT loaders; greedy text equal to JAX's."""
    from chip_smoke import write_llm_stt_checkpoint
    from mlx_audio_tpu.stt.utils import load_model as jax_load
    from mlx_audio_tpu_torch.nn import Embedding, QuantizedLinear
    from mlx_audio_tpu_torch.stt.models.qwen2_audio import Model
    from mlx_audio_tpu_torch.stt.utils import load_model

    _, src = make_pair(seed=1)
    d = tmp_path / "qwen2-audio-4bit"
    write_llm_stt_checkpoint(src, d, bits=4, group_size=32)
    pm = load_model(d, device="cpu")
    jm = jax_load(str(d))
    assert isinstance(pm, Model) and pm._tokenizer is None
    held = [n for n, m in pm.named_modules() if isinstance(m, QuantizedLinear)]
    assert len(held) == 1 + 7 * 2 + 1
    assert all(not n.startswith("audio_tower") for n in held)
    assert pm.language_model.model.layers[0].self_attn.q_proj.bias is not None
    assert isinstance(pm.language_model.model.embed_tokens, Embedding)
    jm._tokenizer, pm._tokenizer = fake_tok(), fake_tok()
    audio = _audio(7, 2.0)
    want = jm.generate(audio, max_tokens=MAX_TOKENS)
    got = pm.generate(audio, max_tokens=MAX_TOKENS)
    assert got.text == want.text and got.generation_tokens > 0


def test_post_load_hook_reads_only_the_local_directory(tmp_path,
                                                      monkeypatch):
    """No tokenizer files: no tokenizer; tokenizer files that fail to load
    raise at load, where JAX's hook swallows the error."""
    import sys
    import types

    from mlx_audio_tpu_torch.stt.models.qwen2_audio import Model, ModelConfig

    m = Model(ModelConfig.from_dict(CFG), device="cpu")
    assert Model.post_load_hook(m, tmp_path)._tokenizer is None

    def broken(path, **kw):
        raise OSError(f"cannot read the tokenizer in {path}")

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=broken)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    (tmp_path / "tokenizer.json").write_text("{not json")
    with pytest.raises(OSError, match="tokenizer"):
        Model.post_load_hook(m, tmp_path)
