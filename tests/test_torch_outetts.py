"""OuteTTS (a llama token-TTS over a 2-codebook DAC) of the PyTorch port
against the JAX package, on the CPU: the cases of tests/test_outetts.py
(the prompt, chunk_text, max_tokens, the stop token, sanitize), each held
to the JAX package's: the prompt copy's outputs equal, greedy tokens
equal token for token, the DAC audio of `generate` whole and streamed
within ATOL; then the port's own rules (a code past the codebook clamped,
a strict `post_load_hook`) and its loader (a directory with its `codec/`
DAC through the top-level `load_model`).

Config: tests/test_outetts.py's tiny llama (2 layers at d32, 6,000 ids)
and its FakeTok (the c1/c2 codes at ids 1,000-2,024 and 3,000-4,024, their
head rows scaled by CODE_SCALE so that random weights emit codes); a
tiny DAC (tests/test_codecs.py::TestDAC's at 24 kHz with two codebooks of
1,025, so that every code the maps hold decodes in both packages). One
parameter set each, drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`); the JAX package runs its own jitted
stepper. Tokens equal; audio at ATOL = 2e-4 (f32, summation order).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_outetts import FakeTok  # noqa: E402
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
CFG = dict(hidden_size=32, num_hidden_layers=2, intermediate_size=64,
           num_attention_heads=4, num_key_value_heads=2, vocab_size=6000,
           rope_theta=10000.0)
DAC_CFG = dict(encoder_dim=16, encoder_rates=[2, 4], latent_dim=32,
               decoder_dim=64, decoder_rates=[4, 2], n_codebooks=2,
               codebook_size=1025, codebook_dim=4, sample_rate=24000)
# the head's c1 and c2 rows scaled, so that greedy decoding emits code pairs
CODE_SCALE = 4.0
TEXTS = ["hello world", "a\n\tb…  “x” – ‘y’ — z\x07", "  spaced   out  ",
         "Short. Then a second sentence! And a third?"]


def dac_pair(cfg=DAC_CFG, seed=1):
    from mlx_audio_tpu.codec.models.descript import DAC as JDAC
    from mlx_audio_tpu_torch.codec.models.descript import DAC
    from mlx_audio_tpu_torch.model import load_jax_params

    jd = JDAC(dict(cfg))
    jd.bind(numpy_params(jd.init_params, seed))
    pd = load_jax_params(DAC(dict(cfg), device="cpu"), flat_numpy(jd.params))
    jd.decode = jax.jit(jd.decode)
    jd.from_codes = jax.jit(jd.from_codes)
    return jd, pd


@pytest.fixture(scope="module")
def models():
    """(JAX OuteTTS, port OuteTTS) on one weight set, each with FakeTok
    and the tiny DAC pair bound."""
    from mlx_audio_tpu.tts.models.outetts import Model as JModel
    from mlx_audio_tpu.tts.models.outetts import ModelConfig as JConfig
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.tts.models.outetts import Model, ModelConfig

    jm = JModel(JConfig(**CFG))
    flat = flat_numpy(numpy_params(jm.init_params, 0))
    head = flat["lm_head.weight"].copy()
    head[1000:2025] *= CODE_SCALE
    head[3000:4025] *= CODE_SCALE
    flat["lm_head.weight"] = head
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    pm = load_jax_params(Model(ModelConfig(**CFG), device="cpu"), flat)
    jd, pd = dac_pair()
    jm._tokenizer, pm.tokenizer = FakeTok(), FakeTok()
    jm._codec = jd
    pm.set_codec(pd)
    return jm, pm


def _ids(pm, text="hello world"):
    return np.asarray(pm.tokenizer.encode(
        pm._processor().get_completion_prompt(text)), np.int32)


# ---------------------------------------------------------------------------
# the prompt copy
# ---------------------------------------------------------------------------


def test_special_tokens_and_code_maps_equal_jax():
    from mlx_audio_tpu.tts.models.outetts import prompt as jp
    from mlx_audio_tpu_torch.tts.models.outetts import prompt as pp

    assert pp.SpecialTokens().to_dict() == jp.SpecialTokens().to_dict()
    a, b = pp.PromptProcessor(FakeTok()), jp.PromptProcessor(FakeTok())
    assert a.c1 == b.c1 and a.c2 == b.c2 and len(a.c1) == 1025


@pytest.mark.parametrize("text", TEXTS + ["続き", "mixed 日本語 text."])
def test_prompt_copy_equals_jax(text):
    """normalize_text, the plain completion prompt, and the prompt with a
    speaker (Latin and CJK speaker text, merged with their separators)."""
    from mlx_audio_tpu.tts.models.outetts import prompt as jp
    from mlx_audio_tpu_torch.tts.models.outetts import prompt as pp

    assert pp.normalize_text(text) == jp.normalize_text(text)
    a, b = pp.PromptProcessor(FakeTok()), jp.PromptProcessor(FakeTok())
    assert a.get_completion_prompt(text) == b.get_completion_prompt(text)
    for spk_text in ("hi there", "こんにちは", "Done."):
        speaker = {"text": spk_text,
                   "words": [{"word": "hi", "duration": 0.21,
                              "features": {"energy": 3},
                              "c1": [1, 2], "c2": [3, 4]},
                             {"word": "there", "duration": 0.4,
                              "features": {}, "c1": [5], "c2": [6]}]}
        assert a.get_completion_prompt(text, speaker) == \
            b.get_completion_prompt(text, speaker)
        assert a.merge_speaker_text(text, spk_text) == \
            b.merge_speaker_text(text, spk_text)


def test_extract_audio_equals_jax():
    from mlx_audio_tpu.tts.models.outetts import prompt as jp
    from mlx_audio_tpu_torch.tts.models.outetts import prompt as pp

    rng = np.random.RandomState(0)
    a, b = pp.PromptProcessor(FakeTok()), jp.PromptProcessor(FakeTok())
    for _ in range(5):
        toks = rng.randint(0, 5000, 60).tolist()
        assert a.extract_audio_from_tokens(toks) == \
            b.extract_audio_from_tokens(toks)
    assert a.extract_audio_from_tokens(
        [42, 1007, 3009, 99, 1008, 3010, 1011]) == [[7, 8], [9, 10]]


@pytest.mark.parametrize("text", TEXTS + [". ".join(["word " * 12] * 5)])
def test_chunk_text_equals_jax(text):
    from mlx_audio_tpu.tts.models.outetts import Model as JModel
    from mlx_audio_tpu_torch.tts.models.outetts import Model

    assert Model.chunk_text(text, max_words=30) == \
        JModel.chunk_text(text, max_words=30)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _tokens(m, ids, n, temperature=0.0, seed=0, top_k=40, min_p=0.05,
            rep=1.1):
    *_, toks = m._decode_tokens(ids, n, temperature, 0.9, top_k, min_p, rep,
                                seed)
    return toks


def test_greedy_tokens_equal_jax(models):
    """40 greedy tokens: a whole chunk of 32, then only the 8 steps left
    (the JAX chunk runs 32 and drops 24)."""
    jm, pm = models
    ids = _ids(pm)
    assert _tokens(pm, ids, 40) == _tokens(jm, ids, 40)
    run = pm.last_run
    assert (run["prompt_bucket"], run["chunks"], run["steps"]) == (256, 2, 40)
    assert run["code_tokens"] == sum(
        1000 <= t <= 2024 or 3000 <= t <= 4024 for t in _tokens(pm, ids, 40))


def test_decode_respects_max_tokens(models):
    jm, pm = models
    ids = _ids(pm, "test")
    outs = list(pm._decode_tokens(ids, 16, 1.0, 1.0, 0, 0.0, 1.0, 0))
    assert len(outs) == 1 and len(outs[-1]) <= 16
    assert pm.last_run["steps"] == 16


def test_stop_token_ends_generation_as_jax(models):
    """With <|audio_end|> the id greedy decoding emits fifth, both packages
    stop there: the stop and everything after it dropped."""
    jm, pm = models
    ids = _ids(pm, "x")
    free = _tokens(pm, ids, 24)
    stop = free[4]
    tok = FakeTok()
    tok.specials["<|audio_end|>"] = stop
    saved = jm._tokenizer, pm.tokenizer, jm._prompt_proc
    try:
        jm._tokenizer, pm.tokenizer, jm._prompt_proc = tok, tok, None
        assert stop in pm.stop_ids()
        got = _tokens(pm, ids, 24)
        assert got == _tokens(jm, ids, 24) == free[:free.index(stop)]
        assert pm.last_run["chunks"] == 1
    finally:
        jm._tokenizer, pm.tokenizer, jm._prompt_proc = saved


def test_generate_audio_equals_jax(models):
    """Whole: one result a chunk_text segment, its DAC audio."""
    jm, pm = models
    kw = dict(max_tokens=40, temperature=0.0, seed=3)
    jr = list(jm.generate("hello there. and more", **kw))
    pr = list(pm.generate("hello there. and more", **kw))
    assert len(pr) == len(jr) >= 1
    for a, b in zip(pr, jr):
        assert a.samples == b.samples > 0 and a.sample_rate == 24000
        assert a.segment_idx == b.segment_idx
        np.testing.assert_allclose(a.audio, np.asarray(b.audio), atol=ATOL)


def test_streamed_audio_equals_jax(models):
    """Streamed every 0.1 x 137.5 = 13 tokens: each interval decodes every
    code so far and yields the samples past those yielded, as JAX's."""
    jm, pm = models
    kw = dict(max_tokens=48, temperature=0.0, stream=True,
              streaming_interval=0.1)
    jr = list(jm.generate("stream me", **kw))
    pr = list(pm.generate("stream me", **kw))
    assert [r.samples for r in pr] == [r.samples for r in jr]
    assert len(pr) >= 2
    np.testing.assert_allclose(np.concatenate([r.audio for r in pr]),
                               np.concatenate([np.asarray(r.audio)
                                               for r in jr]), atol=ATOL)


# ---------------------------------------------------------------------------
# the port's own rules and its loader
# ---------------------------------------------------------------------------


def test_sanitize_prefix_handling_equals_jax():
    from mlx_audio_tpu.tts.models.outetts import Model as JModel
    from mlx_audio_tpu.tts.models.outetts import ModelConfig as JConfig
    from mlx_audio_tpu_torch.tts.models.outetts import Model, ModelConfig

    small = dict(hidden_size=8, num_hidden_layers=1, intermediate_size=16,
                 num_attention_heads=2, num_key_value_heads=2, vocab_size=32)
    w = {"model.model.layers.0.self_attn.q_proj.weight": np.ones((2, 2)),
         "model.lm_head.weight": np.ones((2, 2)),
         "embed_tokens.weight": np.ones((2, 2))}
    got = Model(ModelConfig(**small), device="cpu").sanitize(w)
    assert sorted(got) == sorted(JModel(JConfig(**small)).sanitize(w))
    assert "model.layers.0.self_attn.q_proj.weight" in got
    assert "lm_head.weight" in got and "model.embed_tokens.weight" in got


def test_a_code_past_the_codebook_is_clamped(models):
    """The departure: with the published 1,024-entry codebooks, the code
    1,024 (the maps hold 0-1,024) decodes as 1,023 in the port; JAX's
    gather fills it with NaN."""
    jm, pm = models
    from mlx_audio_tpu.codec.models.descript import DAC as JDAC

    jd, pd = dac_pair(dict(DAC_CFG, codebook_size=1024), seed=2)
    saved = pm.codec
    try:
        pm.set_codec(pd)
        toks = [1000 + 1024, 3000 + 5, 1000 + 3, 3000 + 1024]
        got = pm._codes_to_audio(toks)
        want = pd.decode(pd.from_codes(np.array([[[1023, 3], [5, 1023]]])))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want.reshape(-1).numpy(), atol=1e-6)
        z = JDAC.from_codes(jd, jnp.asarray([[[1024, 3], [5, 1024]]]))
        assert np.isnan(np.asarray(z)).any()
    finally:
        pm.set_codec(saved)


def write_outetts_dir(pm, pd, path):
    """A checkpoint directory: config.json (model_type "outetts"), the
    LM's weights in npz under HF names, and `codec/` with the DAC's
    config.json and torch-layout weights."""
    path.mkdir()
    (path / "config.json").write_text(json.dumps(dict(CFG,
                                                      model_type="outetts")))
    np.savez(path / "model.npz", **{k: v.numpy() for k, v in
                                    pm.state_dict().items()})
    (path / "codec").mkdir()
    (path / "codec" / "config.json").write_text(json.dumps(dict(
        DAC_CFG, model_type="dac")))
    np.savez(path / "codec" / "model.npz",
             **{k: v.numpy() for k, v in pd.state_dict().items()})


def test_load_model_binds_lm_and_codec(models, tmp_path):
    """The top-level router sends model_type "outetts" to the TTS loader;
    the hook binds `codec/`'s DAC (tokenizer None without tokenizer
    files) and the loaded model decodes as the JAX package's."""
    jm, pm = models
    from mlx_audio_tpu_torch import load_model

    write_outetts_dir(pm, pm.codec, tmp_path / "outetts-tiny")
    m = load_model(tmp_path / "outetts-tiny", device="cpu")
    assert type(m).__module__.endswith("outetts.outetts")
    assert m.tokenizer is None and type(m.codec).__name__ == "DAC"
    m.tokenizer = FakeTok()
    ids = _ids(m)
    assert _tokens(m, ids, 20) == _tokens(jm, ids, 20)
    (r,) = list(m.generate("hi", max_tokens=30, temperature=0.0))
    (j,) = list(jm.generate("hi", max_tokens=30, temperature=0.0))
    np.testing.assert_allclose(r.audio, np.asarray(j.audio), atol=ATOL)


def test_post_load_hook_raises_where_the_codec_fails(models, tmp_path):
    """JAX's hook swallows a codec that fails to load (`_codec` None, and
    `generate` fails later); the port's raises."""
    jm, pm = models
    from mlx_audio_tpu_torch.tts.models.outetts import Model

    write_outetts_dir(pm, pm.codec, tmp_path / "d")
    (tmp_path / "d" / "codec" / "model.npz").unlink()
    with pytest.raises(FileNotFoundError, match="No weight files"):
        Model.post_load_hook(pm, tmp_path / "d")
    with pytest.raises(ValueError, match="tokenizer"):
        pm.tokenizer, saved = None, pm.tokenizer
        try:
            list(pm.generate("hi", max_tokens=4))
        finally:
            pm.tokenizer = saved
