"""Pocket-TTS of the PyTorch port against the JAX package, on the CPU: the
cases of tests/test_pocket_tts.py (the text helpers, the voice-prompt
state reused across sentences, streaming chunks, `frames_after_eos`, seed
determinism), each held to the JAX package's: the frames at temperature 0
(the latents the Mimi decodes) and the audio within ATOL, sampled frames
equal when the port is handed JAX's draws; then the port's own rules (the
tanh GELU, the cache's cap raising before the prefill) and its loading
(`sanitize`, the tokens.json tokenizer, `tts.utils.load_model`).

Config: tests/test_pocket_tts.py's `tiny_cfg` (a 2-layer flow LM at d32, a
flow net of 2 x 32, a 64-bin LUT, a one-layer Mimi at 12.5 Hz) and its
CharTokenizer; one parameter set drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`), which draws every bias zero: the Mimi's
transposed-conv biases, which the port's stream keeps on its first frames
and JAX's loses, are zero, so the streamed audio compares from its first
frame. `out_eos`'s bias is set to -100 (the logit far below the -4.0
threshold; EOS never fires) but where a test moves the threshold past it.
The JAX package runs its own jitted steps. The frame loop feeds each latent
back, and on these random weights the two packages' f32 rounding
differences grow about tenfold every five frames past the 40th (1e-7 at
frame 40, 3e-4 at frame 60), so the port's frames take JAX's previous
latent (`_compare`); one run of 8 frames runs free. Frames and audio
at ATOL = 2e-4 (f32, summation order).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_pocket_tts import CharTokenizer, tiny_cfg  # noqa: E402
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
EOS_BIAS = -100.0
REF = np.random.RandomState(2).randn(4000).astype(np.float32)
TEXTS = ["hello there", "one two three four five six", "lower case start",
         "Ends with punctuation!", "First sentence is right here now. "
         "Second one follows it closely. And a third, short."]


def port_cfg():
    from mlx_audio_tpu_torch.tts.models.pocket_tts import ModelConfig

    j = tiny_cfg()
    return ModelConfig.from_dict(dict(flow_lm=j.flow_lm, mimi=j.mimi))


@pytest.fixture(scope="module")
def models():
    """(JAX Pocket-TTS, port Pocket-TTS) on one weight set, CharTokenizer
    on both; each records its frames' latents (`latents`) and the latents
    its Mimi decodes (`frames`); the port's frame takes `forced[i - 1]`
    for the previous latent where `forced` is set."""
    from mlx_audio_tpu.tts.models.pocket_tts import Model as JModel
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.tts.models.pocket_tts import Model

    jm = JModel(tiny_cfg())
    flat = flat_numpy(numpy_params(jm.init_params, 0))
    flat["flow_lm.out_eos.bias"] = np.full_like(flat["flow_lm.out_eos.bias"],
                                                EOS_BIAS)
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    pm = load_jax_params(Model(port_cfg(), device="cpu"), flat)
    jm.tokenizer, pm.tokenizer = CharTokenizer(), CharTokenizer()
    record_port(pm)
    jm.latents, jm.frames = [], []
    make_frame = jm._frame_fn

    def frame_fn(*knobs):
        step = make_frame(*knobs)

        def frame(*args):
            out = step(*args)
            jm.latents.append(np.asarray(out[0]))
            return out
        return frame

    jm._frame_fn = frame_fn
    mimi = jm.mimi_model()
    mimi.encode_to_latent = jax.jit(mimi.encode_to_latent)
    dec = jax.jit(lambda st, lat: mimi.decode_latent_step(st, lat))

    def jax_dec(st, lat):
        jm.frames.append(np.asarray(lat))
        return dec(st, lat)

    jm._jit_cache["latent_decode"] = jax_dec
    return jm, pm


def record_port(pm):
    pm.latents, pm.frames, pm.forced = [], [], None
    frame, decode = pm.frame, pm.mimi.decode_latent_step

    def forced_frame(caches, offset, prev, gen):
        if prev is not None and pm.forced is not None:
            prev = torch.from_numpy(pm.forced[len(pm.latents) - 1].copy())
        latent, is_eos = frame(caches, offset, prev, gen)
        pm.latents.append(latent.numpy().copy())
        return latent, is_eos

    def record(st, lat):
        pm.frames.append(lat.numpy().copy())
        return decode(st, lat)

    pm.frame, pm.mimi.decode_latent_step = forced_frame, record


def _run(m, text, forced=None, **kw):
    """`generate` -> (results, the frames' latents, the latents its Mimi
    decoded)."""
    m.latents.clear()
    m.frames.clear()
    m.forced = forced
    res = list(m.generate(text, ref_audio=REF, **kw))
    return res, list(m.latents), list(m.frames)


def _compare(pm, jm, text, **kw):
    """JAX's run, then the port's fed JAX's previous latent each frame:
    every frame's latent and Mimi input, and the audio, within ATOL. ->
    the port's run."""
    want = _run(jm, text, **kw)
    got = _run(pm, text, forced=want[1], **kw)
    assert_same(got, want)
    return got


def assert_same(got, want):
    (pr, pl, pf), (jr, jl, jf) = got, want
    assert len(pl) == len(jl) and len(pf) == len(jf)
    assert [r.samples for r in pr] == [r.samples for r in jr]
    for x, y in zip(pl + pf, jl + jf):
        np.testing.assert_allclose(x, y, atol=ATOL)
    if pr:
        np.testing.assert_allclose(
            np.concatenate([r.audio for r in pr]),
            np.concatenate([np.asarray(r.audio) for r in jr]), atol=ATOL)


# ---------------------------------------------------------------------------
# text helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", TEXTS)
def test_text_helpers_equal_jax(text):
    from mlx_audio_tpu.tts.models.pocket_tts import pocket_tts as jp
    from mlx_audio_tpu_torch.tts.models.pocket_tts import pocket_tts as pp

    assert pp.prepare_text_prompt(text) == jp.prepare_text_prompt(text)
    tok = CharTokenizer()
    for limit in (50, 20):
        assert pp.split_into_best_sentences(tok, text, limit) == \
            jp.split_into_best_sentences(tok, text, limit)
    with pytest.raises(ValueError, match="empty"):
        pp.prepare_text_prompt("   ")


# ---------------------------------------------------------------------------
# the voice prompt and the frames
# ---------------------------------------------------------------------------


def test_voice_prompt_and_its_state_equal_jax(models):
    jm, pm = models
    np.testing.assert_allclose(pm.encode_voice_prompt(REF).numpy(),
                               np.asarray(jm.encode_voice_prompt(REF)),
                               atol=ATOL)
    ps, js = (pm.get_state_for_audio_prompt(REF),
              jm.get_state_for_audio_prompt(REF))
    assert ps["prompt_frames"] == js["prompt_frames"] >= 1
    assert ps["offset"] == js["offset"] == ps["prompt_frames"]


def test_free_running_frames_equal_jax(models):
    """EOS on the first frame and 8 frames after it, at temperature 0, each
    port frame fed its own previous latent: every frame and the audio."""
    jm, pm = models
    try:
        kw = dict(temperature=0.0, frames_after_eos=8, eos_threshold=-1000.0)
        got = _run(pm, "hello world test", **kw)
        assert_same(got, _run(jm, "hello world test", **kw))
        assert len(got[2]) == 8
    finally:
        for m in (jm, pm):
            m.eos_threshold = -4.0


def test_frames_at_temperature_zero_equal_jax(models):
    """One sentence at temperature 0 (zero noise), run to max_gen (62
    frames), each frame fed JAX's previous latent."""
    jm, pm = models
    got = _compare(pm, jm, "hello world test", temperature=0.0)
    assert len(got[1]) == pm.last_run["max_gen"] == 62
    assert pm.last_run["eos_step"] is None


def test_state_reused_across_sentences_equals_jax(models):
    """Three sentences packed into two chunks of at most 50 tokens: each
    chunk starts back at the prompt's offset of one voice state."""
    jm, pm = models
    from mlx_audio_tpu_torch.tts.models.pocket_tts.pocket_tts import \
        split_into_best_sentences

    assert len(split_into_best_sentences(CharTokenizer(), TEXTS[-1])) == 2
    _compare(pm, jm, TEXTS[-1], temperature=0.0)


def test_streaming_chunks_equal_jax(models):
    jm, pm = models
    res = _compare(pm, jm, "hello streaming world", temperature=0.0,
                   stream=True, streaming_interval=0.1)[0]
    assert len(res) >= 2 and all(r.is_streaming_chunk for r in res)


def test_frames_after_eos_equal_jax(models):
    """With the threshold moved below the EOS logit, EOS fires on the
    first frame: `frames_after_eos` frames follow it, as in JAX."""
    jm, pm = models
    try:
        for fae in (0, 4):
            got = _compare(pm, jm, "hi there friend", temperature=0.0,
                           frames_after_eos=fae, eos_threshold=-1000.0)
            assert len(got[2]) == fae and pm.last_run["eos_step"] == 0
    finally:
        for m in (jm, pm):
            m.eos_threshold = -4.0


def jax_draws(seed: int):
    """JAX's frame noise, one draw a call: PRNGKey(seed) split each frame
    (pocket_tts.py:481-484)."""
    key = [jax.random.PRNGKey(seed)]

    def draws(generator, shape):
        key[0], k = jax.random.split(key[0])
        return torch.from_numpy(np.array(jax.random.normal(k, shape)))

    return draws


def test_seeded_draws(models):
    """At temperature 0.7 the port's own draws repeat under one seed and
    differ under another; handed JAX's draws, its frames are JAX's."""
    jm, pm = models
    try:
        a = _run(pm, "same seed", seed=7, temperature=0.7)[1]
        b = _run(pm, "same seed", seed=7, temperature=0.7)[1]
        c = _run(pm, "same seed", seed=8, temperature=0.7)[1]
        np.testing.assert_array_equal(np.stack(a), np.stack(b))
        assert not np.allclose(np.stack(a), np.stack(c))
        pm._draws = jax_draws(7)
        _compare(pm, jm, "same seed", seed=7, temperature=0.7)
    finally:
        del pm._draws
        for m in (jm, pm):
            m.temp = 0.7


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------


def test_gelu_is_tanhs_as_jax(models):
    """`jax.nn.gelu`'s default, which the JAX transformer calls, is the
    tanh form, not the exact one; the port's transformer equals JAX's."""
    jm, pm = models
    from mlx_audio_tpu.ops.kvcache import KVCache
    from mlx_audio_tpu.tts.models.pocket_tts.pocket_tts import \
        streaming_transformer as jax_tf
    from mlx_audio_tpu_torch.tts.models.pocket_tts.pocket_tts import \
        streaming_transformer

    x = np.random.RandomState(0).randn(1, 5, 32).astype(np.float32)
    t = torch.from_numpy(x)
    jg = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(
        torch.nn.functional.gelu(t, approximate="tanh").numpy(), jg,
        atol=1e-6)
    assert np.abs(torch.nn.functional.gelu(t).numpy() - jg).max() > 1e-4
    f = jm.config.flow_cfg
    caches = [KVCache.init(1, 16, f.num_heads, f.dim // f.num_heads,
                           jnp.float32) for _ in range(f.num_layers)]
    want, _ = jax.jit(lambda p, x: jax_tf(p, f, x, caches, 3))(
        jm.params["flow_lm"]["transformer"], jnp.asarray(x))
    got = streaming_transformer(pm.flow_lm.transformer, f, t,
                                pm._init_caches(), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_the_caches_cap_raises_before_the_prefill(models, monkeypatch):
    """A voice prompt past 512 frames, and prompt + text + max_gen frames
    past the cache's 1,024 columns, raise, naming the cap, with nothing
    written past the prompt."""
    jm, pm = models
    dim = pm.config.flow_cfg.dim
    monkeypatch.setattr(pm, "encode_voice_prompt",
                        lambda audio: torch.zeros(1, 513, dim))
    with pytest.raises(ValueError, match="at most 512"):
        pm.get_state_for_audio_prompt(REF)
    cond = torch.randn(1, 500, dim, generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(pm, "encode_voice_prompt", lambda audio: cond)
    state = pm.get_state_for_audio_prompt(REF)
    with pytest.raises(ValueError, match="1024 columns"):
        list(pm.generate_audio_stream(state, "word " * 30))
    assert state["caches"].k[:, :, 500:].abs().max() == 0
    assert state["caches"].k[:, :, :500].abs().max() > 0


def test_sanitize_names_equal_jax(models):
    """A checkpoint in the port's names (kyutai's): the flow LM's and the
    speaker projection's names kept, the Mimi's through its sanitize, as
    JAX names them; it binds back to the model."""
    jm, pm = models
    from mlx_audio_tpu_torch.tts.models.pocket_tts import Model

    state = {k: v.numpy() for k, v in pm.state_dict().items()}
    state["model.speaker_proj_weight"] = state.pop("speaker_proj_weight")
    got = pm.sanitize(state)
    want = jm.sanitize(state)
    assert sorted(got) == sorted(want)
    again = Model(port_cfg(), device="cpu").bind(got)
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(again.state_dict()[k].numpy(),
                                      v.numpy())


def test_load_model_with_a_piece_tokenizer(models, tmp_path):
    """`tts.utils.load_model` on a directory (model_type "pocket_tts", the
    port's names in npz, a tokens.json piece list): the loaded model's
    frames equal the JAX package's, its tokenizer encodes as JAX's."""
    jm, pm = models
    from mlx_audio_tpu.tts.models.pocket_tts.pocket_tts import \
        _PieceTokenizer as JPieces
    from mlx_audio_tpu_torch.tts.utils import load_model

    j = tiny_cfg()
    (tmp_path / "config.json").write_text(json.dumps(dict(
        model_type="pocket_tts", flow_lm=j.flow_lm, mimi=j.mimi)))
    np.savez(tmp_path / "model.npz", **{k: v.numpy() for k, v in
                                        pm.state_dict().items()})
    pieces = ["<unk>", "▁he", "llo", "▁wor", "ld", "▁", "h", "e", "."]
    (tmp_path / "tokens.json").write_text(json.dumps(pieces))
    m = load_model(tmp_path, device="cpu")
    for text in ("hello world.", "he wor ld"):
        assert m.tokenizer.encode(text) == JPieces(pieces).encode(text)
        assert m.tokenizer.decode([1, 2]) == JPieces(pieces).decode([1, 2])
    m.tokenizer = CharTokenizer()
    record_port(m)
    want = _run(jm, "hello world test", temperature=0.0)
    assert_same(_run(m, "hello world test", forced=want[1], temperature=0.0),
                want)
