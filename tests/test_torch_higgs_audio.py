"""Higgs Audio v2 text -> audio in the PyTorch port against the JAX package,
on the CPU at float32.

Config: `tests/test_higgs_audio_v2.py::tiny_cfg` (2 dual-FFN layers at d32,
llama3 RoPE scaling, 4 codebooks of 64), and for W8A8 a variant whose
widths are multiples of 64 (d64, FFN 128). The JAX model's random
parameters reach the port through `model.load_jax_params`; a test that
changes them (EOS rows of `audio_lm_head` scaled or zeroed) changes the
one shared tree before both packages take it.

Tolerances: hidden states and logits 2e-4 absolute (summation order only,
the repo's torch-parity precedent); audio 1e-4 relative (values ~1e-3 under
random weights). Greedy frames must be equal.

The departures the port makes from the JAX package are pinned here: the KV
cache holds the whole request (JAX's is capped at 2,048 columns and
overwrites its last one), and codes cross to the codec in the codec's
(T, K) layout.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_higgs_audio_v2 import FakeTok, tiny_cfg  # noqa: E402

ATOL = 2e-4
AUDIO_REL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def _np(t):
    return t.detach().float().cpu().numpy()


def _q8_cfg():
    from mlx_audio_tpu.tts.models.higgs_audio import ModelConfig

    d = dataclasses.asdict(tiny_cfg())
    d["text_config"].update(hidden_size=64, intermediate_size=128)
    return ModelConfig.from_dict(d)


_JAX = {}


def _jax_model(variant="tiny", eos_scale=None):
    """(JAX model, flat numpy params): 'tiny', or 'q8' (the d64 variant in
    W8A8: affine 8-bit codes, group 64, then tree_to_i8_layout). eos_scale
    multiplies the EOS rows of audio_lm_head (0 suppresses EOS)."""
    key = (variant, eos_scale)
    if key not in _JAX:
        from mlx_audio_tpu.tts.models.higgs_audio import Model
        from mlx_audio_tpu.utils import flatten

        cfg = _q8_cfg() if variant == "q8" else tiny_cfg()
        jm = Model(cfg).init_and_bind()
        jm.tokenizer = FakeTok()
        if eos_scale is not None:
            head = jm.params["audio_decoder_proj"]["audio_lm_head"]
            w = np.array(head["weight"])
            w[np.arange(cfg.audio_num_codebooks) * cfg.stride
              + cfg.audio_stream_eos_id] *= eos_scale
            head["weight"] = jnp.asarray(w)
        if variant == "q8":
            from mlx_audio_tpu.ops.quant import (maybe_quantize_tree,
                                                 tree_to_i8_layout)

            jm.params = tree_to_i8_layout(maybe_quantize_tree(
                jm.params, group_size=64, bits=8,
                predicate=lambda p, w: jm.model_quant_predicate(p, w)))
        _JAX[key] = (jm, {k: np.asarray(v)
                          for k, v in flatten(jm.params).items()})
    return _JAX[key]


def _port(variant="tiny", eos_scale=None):
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.tts.models.higgs_audio import Model

    jm, flat = _jax_model(variant, eos_scale)
    pm = load_jax_params(Model(dataclasses.asdict(jm.config), device="cpu"),
                         flat)
    pm.tokenizer = FakeTok()
    return pm


def _frames(gen):
    return np.concatenate(list(gen), axis=0)


# ---------------------------------------------------------------------------
# backbone
# ---------------------------------------------------------------------------


def test_llama3_inv_freq_matches_jax():
    from mlx_audio_tpu.ops.rope import rope_freqs_llama3 as jfreqs
    from mlx_audio_tpu_torch.ops.rope import rope_freqs_llama3

    for args in ((8, 500000.0), (128, 500000.0),
                 (64, 10000.0, 4.0, 1.0, 2.0, 2048)):
        want = np.asarray(jfreqs(*args))
        got = rope_freqs_llama3(*args)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mask", ["mixed", "text", "audio"])
def test_higgs_forward_matches_jax(mask):
    from mlx_audio_tpu.tts.models.higgs_audio.higgs_audio import \
        higgs_forward as jforward
    from mlx_audio_tpu_torch.tts.models.higgs_audio.higgs_audio import \
        higgs_forward

    jm, _ = _jax_model()
    pm = _port()
    x = np.random.RandomState(0).randn(1, 9, 32).astype(np.float32)
    m = {"mixed": np.array([[0, 0, 1, 1, 1, 0, 1, 0, 0]], bool),
         "text": np.zeros((1, 9), bool), "audio": np.ones((1, 9), bool)}[mask]
    want, _ = jforward(jm.params, jm.config, jnp.asarray(x), jnp.asarray(m),
                       None, 0)
    got, _ = higgs_forward(pm, torch.from_numpy(x), torch.from_numpy(m))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_prefill_into_caches_matches_jax():
    """The cached prefill (causal over the cache's columns, pad rows masked
    past plen) and the first decode step (audio path only)."""
    from mlx_audio_tpu.ops.kvcache import KVCache as JCache
    from mlx_audio_tpu.tts.models.higgs_audio.higgs_audio import \
        higgs_forward as jforward
    from mlx_audio_tpu_torch.ops.kvcache import KVCache
    from mlx_audio_tpu_torch.tts.models.higgs_audio.higgs_audio import \
        higgs_forward

    jm, _ = _jax_model()
    pm = _port()
    t = jm.config.text
    rs = np.random.RandomState(1)
    x = rs.randn(1, 16, 32).astype(np.float32)
    m = np.zeros((1, 16), bool)
    m[0, 3:9] = True
    plen, cache_len = 12, 40
    pad = np.where(np.arange(cache_len) < plen, 0.0,
                   -np.inf)[None, None, None, :].astype(np.float32)
    jc = [JCache.init(1, cache_len, t.num_key_value_heads, t.head_dim,
                      jnp.float32) for _ in range(t.num_hidden_layers)]
    want, jc = jforward(jm.params, jm.config, jnp.asarray(x), jnp.asarray(m),
                        jc, 0, pad_mask=jnp.asarray(pad))
    pc = KVCache.init(1, cache_len, t.num_key_value_heads, t.head_dim,
                      torch.float32, n_layers=t.num_hidden_layers)
    got, pc = higgs_forward(pm, torch.from_numpy(x), torch.from_numpy(m), pc,
                            0, pad_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(_np(got)[:, :plen], np.asarray(want)[:, :plen],
                               atol=ATOL)
    step = rs.randn(1, 1, 32).astype(np.float32)
    want, _ = jforward(jm.params, jm.config, jnp.asarray(step),
                       jnp.ones((1, 1), bool), jc, plen)
    got, _ = higgs_forward(pm, torch.from_numpy(step), None, pc, plen)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_delay_pattern_matches_jax():
    from mlx_audio_tpu.tts.models.higgs_audio import higgs_audio as jh
    from mlx_audio_tpu_torch.tts.models.higgs_audio import higgs_audio as ph

    codes = np.random.RandomState(2).randint(0, 64, (4, 7)).astype(np.int32)
    d = ph.apply_delay_pattern(codes, 64, 65)
    np.testing.assert_array_equal(d, jh.apply_delay_pattern(codes, 64, 65))
    np.testing.assert_array_equal(ph.revert_delay_pattern(d), codes)
    np.testing.assert_array_equal(ph.revert_delay_pattern(d[:, :2]),
                                  jh.revert_delay_pattern(d[:, :2]))


# ---------------------------------------------------------------------------
# the frame loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eos_scale", [None, 2.0, 3.0, 0.0],
                         ids=["random", "eos-late", "eos-in-ramp",
                              "eos-suppressed"])
def test_generate_frames_greedy_matches_jax(eos_scale):
    """Greedy frames equal. eos-late samples EOS after the ramp-in (frame
    ~33, the ramp-out then runs), eos-in-ramp during it (frame 2),
    eos-suppressed never (the loop runs every chunk)."""
    jm, _ = _jax_model(eos_scale=eos_scale)
    pm = _port(eos_scale=eos_scale)
    want = _frames(jm.generate_frames(*jm.build_prompt("hello world"),
                                      max_new_frames=48, temperature=0.0))
    got = _frames(pm.generate_frames(*pm.build_prompt("hello world"),
                                     max_new_frames=48, temperature=0.0))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    eos = jm.config.audio_stream_eos_id
    if eos_scale in (2.0, 3.0):
        assert len(got) < 49 and (got[-1] == eos).all()
    if eos_scale == 0.0:
        assert len(got) == 49 and not (got == eos).any()
    assert pm.last_run["chunks"] == -(-(len(got) - 1) // 16)


def _frame_rules_transcription(tok, greedy, state, K, bos, eos, win_len,
                               max_repeat):
    """tts/models/higgs_audio/higgs_audio.py:456-477 transcribed to numpy."""
    num_delay, num_remaining, done, window = state
    if win_len > 0:
        win = window[:, -win_len:]
        count = np.sum(win == tok[:, None], axis=1)
        tok = np.where(count >= max_repeat, greedy, tok)
    idx = np.arange(K)
    ramping = num_delay + 1 < K
    tok = np.where(ramping & (idx > num_delay), bos, tok)
    num_delay = num_delay + 1 if ramping else num_delay
    started = num_remaining >= 0
    tok = np.where(started & (idx < K - num_remaining), eos, tok)
    eos_mask = tok == eos
    any_eos = eos_mask.any()
    last_eos = (K - 1) - np.argmax(eos_mask[::-1])
    tok = np.where((not started) & any_eos & (idx < last_eos), eos, tok)
    new_remaining = (num_remaining - 1 if started
                     else (K - last_eos - 1 if any_eos else -1))
    done = done | (started & (num_remaining <= 0))
    window = np.concatenate([window[:, 1:], tok[:, None]], axis=1)
    return tok, (num_delay, new_remaining, done, window)


@pytest.mark.parametrize("case", ["ras", "eos-late", "eos-early",
                                  "eos-first-book"])
def test_frame_rules_match_transcription(case):
    """frame_rules on chosen drawn and greedy tokens against the JAX rule
    code transcribed: RAS fallback (a drawn token repeated in the window),
    ramp-in, ramp-out from an EOS drawn in the last, a middle or the first
    codebook, and `done`."""
    from mlx_audio_tpu_torch.tts.models.higgs_audio.higgs_audio import (
        frame_rules, initial_state)

    K, bos, eos = 4, 64, 65
    rs = np.random.RandomState(["ras", "eos-late", "eos-early",
                                "eos-first-book"].index(case))
    eos_at = {"ras": None, "eos-late": (9, 3), "eos-early": (2, 1),
              "eos-first-book": (6, 0)}[case]
    state = initial_state(K, bos, "cpu")
    ref = (0, -1, False, np.full((K, 8), bos, np.int64))
    saw_ras = saw_done = False
    for step in range(16):
        drawn = rs.randint(0, 3 if case == "ras" else 64, K)
        greedy = rs.randint(0, 64, K)
        if eos_at and step == eos_at[0]:
            drawn[eos_at[1]] = eos
        want, ref = _frame_rules_transcription(drawn, greedy, ref, K, bos,
                                               eos, 7, 2)
        got, state = frame_rules(torch.from_numpy(drawn),
                                 torch.from_numpy(greedy), state, bos=bos,
                                 eos=eos, ras_win_len=7, ras_max_repeat=2)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(state.num_delay) == ref[0]
        assert int(state.num_remaining) == ref[1]
        assert bool(state.done) == bool(ref[2])
        np.testing.assert_array_equal(state.ras_window.numpy(), ref[3])
        saw_ras |= bool((want == greedy).any() and (want != drawn).any())
        saw_done |= bool(ref[2])
    if case == "ras":
        assert saw_ras
    else:
        assert saw_done


def test_sampled_generate_is_seeded_and_runs_ras():
    """temperature > 0 draws from the seed's torch.Generator: the same seed
    gives the same frames, another seed others (the JAX package's key
    stream differs, so sampling is not compared with it)."""
    pm = _port()
    emb, mask = pm.build_prompt("sampled")
    runs = [_frames(pm.generate_frames(emb, mask, max_new_frames=24,
                                       temperature=0.9, top_p=0.9, seed=s))
            for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].shape != runs[2].shape or (runs[0] != runs[2]).any()


# ---------------------------------------------------------------------------
# the KV-cache departure
# ---------------------------------------------------------------------------


def test_long_prompt_cache_holds_the_request():
    """A 2,040-token prompt (bucket 2,048) and 64 greedy frames with EOS
    suppressed need 2,132 columns. The port's frames equal JAX's own
    prefill and chunk functions run on a 4,096-column cache; JAX's
    generate_frames caps its cache at 2,048 and differs."""
    from mlx_audio_tpu.tts.models.higgs_audio.higgs_audio import CHUNK_FRAMES

    jm, _ = _jax_model(eos_scale=0.0)
    pm = _port(eos_scale=0.0)
    rs = np.random.RandomState(5)
    emb = (rs.randn(1, 2040, 32) * 0.5).astype(np.float32)
    mask = np.zeros((1, 2040), bool)
    mask[0, 100:400] = True
    got = _frames(pm.generate_frames(torch.from_numpy(emb),
                                     torch.from_numpy(mask),
                                     max_new_frames=64, temperature=0.0))
    assert pm.last_run["cache_len"] == 4096
    pf = jm._prefill_fn(2048, 4096)
    st = jm._chunk_fn(CHUNK_FRAMES, 0.0, 0.95, 0, 7, 2, 0)
    carry, frame0 = pf(jm.params, jnp.pad(jnp.asarray(emb),
                                          ((0, 0), (0, 8), (0, 0))),
                       jnp.pad(jnp.asarray(mask), ((0, 0), (0, 8))),
                       jnp.int32(2040), jax.random.PRNGKey(0))
    want = [np.asarray(frame0)[None]]
    for _ in range(4):
        carry, frames, _ = st(jm.params, carry)
        want.append(np.asarray(frames))
    np.testing.assert_array_equal(got, np.concatenate(want))
    capped = _frames(jm.generate_frames(jnp.asarray(emb), jnp.asarray(mask),
                                        max_new_frames=64, temperature=0.0))
    assert capped.shape == got.shape and (capped != got).any()


def test_oversize_prompt_and_request_raise_before_prefill(monkeypatch):
    from mlx_audio_tpu_torch.tts.models.higgs_audio.higgs_audio import (
        cache_length, prompt_bucket)

    pm = _port()

    def no_prefill(*a, **k):
        raise AssertionError("prefill ran")

    monkeypatch.setattr(pm, "prefill", no_prefill)
    with pytest.raises(ValueError, match="prompt"):
        next(pm.generate_frames(torch.zeros(1, 2049, 32),
                                torch.zeros(1, 2049, dtype=torch.bool)))
    with pytest.raises(ValueError, match="KV columns"):
        next(pm.generate_frames(torch.zeros(1, 2040, 32),
                                torch.zeros(1, 2040, dtype=torch.bool),
                                max_new_frames=2100))
    # where JAX's sizing suffices, it is JAX's: the lane's 480-token prompt
    # and 250 frames (bench.py:428-432) get bucket 512 and 1,024 columns
    assert (prompt_bucket(480), cache_length(512, 250, 8)) == (512, 1024)
    assert cache_length(2048, 900, 8) == 4096


# ---------------------------------------------------------------------------
# the request
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("voice", ["smart", "clone"])
def test_build_prompt_matches_jax(voice):
    jm, _ = _jax_model()
    pm = _port()
    kw = {}
    if voice == "clone":
        kw = dict(ref_codes=np.random.RandomState(6).randint(
            0, 64, (4, 11)).astype(np.int32), ref_text="reference words")
    we, wm = jm.build_prompt("target text", **kw)
    ge, gm = pm.build_prompt("target text", **kw)
    np.testing.assert_allclose(_np(ge), np.asarray(we), atol=ATOL)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert gm.any() == (voice == "clone")


def _tiny_codecs():
    """One tiny Higgs codec with the TTS config's books (4) and codebook
    size (64), in both packages from one JAX tree."""
    from mlx_audio_tpu.codec.models.higgs_audio import Model as JCodec
    from mlx_audio_tpu.codec.models.higgs_audio import ModelConfig
    from mlx_audio_tpu.utils import flatten
    from mlx_audio_tpu_torch.codec.models.higgs_audio import Model as PCodec
    from mlx_audio_tpu_torch.model import load_jax_params

    cfg = ModelConfig.from_dict(dict(
        codebook_size=64, codebook_dim=4, dac_num_codebooks=4,
        dac_encoder_ratios=[2, 3], dac_encoder_hidden=4,
        dac_decoder_hidden=16, latent_dim=24, fusion_dim=8,
        downsample_factor=20))
    jc = JCodec(cfg).init_and_bind(jax.random.PRNGKey(7))
    pc = load_jax_params(PCodec(dataclasses.asdict(cfg), device="cpu"),
                         {k: np.asarray(v)
                          for k, v in flatten(jc.params).items()})
    return jc, pc


def test_generate_audio_through_codec_matches_jax():
    """Whole generate(): the port's audio through its codec equals the JAX
    package's codes decoded by its codec in (T, K), with the same fades.
    JAX's own generate hands its codec (1, K, T), which gives K frames of
    audio: the port's departure."""
    jc, pc = _tiny_codecs()
    jm, _ = _jax_model(eos_scale=2.0)
    pm = _port(eos_scale=2.0)
    pm.codec = pc
    got = next(pm.generate("hello world", temperature=0.0,
                           max_new_frames=48))
    jm.codec = None
    ref = next(jm.generate("hello world", temperature=0.0,
                           max_new_frames=48))
    codes = ref.prompt["codes"]
    np.testing.assert_array_equal(got.prompt["codes"], codes)
    audio = np.asarray(jc.decode(codes.T), np.float32).copy()
    n_in, n_out = int(30.0 * 24), int(15.0 * 24)
    if audio.size > n_in:
        audio[:n_in] *= np.linspace(0.0, 1.0, n_in, dtype=np.float32)
    if audio.size > n_out:
        audio[-n_out:] *= np.linspace(1.0, 0.0, n_out, dtype=np.float32)
    assert got.samples == codes.shape[1] * 6 == len(audio)
    assert _rel(got.audio, audio) < AUDIO_REL
    assert got.is_final_chunk and got.real_time_factor > 0
    jm.codec = jc
    assert next(jm.generate("hello world", temperature=0.0,
                            max_new_frames=48)).samples == 4 * 6


class _JaxFakeCodec:
    """tests/test_higgs_audio_v2.py's FakeCodec, decode taking (1, K, T)
    as the JAX model hands it; encode returns `codes` (K, T) itself, which
    the JAX model's reshape to (K, -1) leaves as they are."""

    def __init__(self, codes):
        self.codes = codes

    def encode(self, audio):
        return self.codes

    def decode(self, codes):
        c = np.asarray(codes)[0]
        return np.repeat(c.sum(axis=0).astype(np.float32) / 240.0, 16)


class _PortFakeCodec:
    """The same codec in the codec's own layouts: encode -> (T, K), decode
    takes (T, K)."""

    def __init__(self, codes):
        self.codes = codes

    def encode(self, audio):
        return self.codes.T

    def decode(self, codes):
        c = np.asarray(codes).T
        return np.repeat(c.sum(axis=0).astype(np.float32) / 240.0, 16)


def test_stream_overlap_add_matches_jax():
    codes = np.zeros((4, 2), np.int32)
    jm, _ = _jax_model(eos_scale=0.0)
    pm = _port(eos_scale=0.0)
    jm.codec, pm.codec = _JaxFakeCodec(codes), _PortFakeCodec(codes)
    kw = dict(temperature=0.0, max_new_frames=40, stream=True,
              overlap_ms=5.0, streaming_interval=0.24, seed=3)
    want = list(jm.generate("streaming test sentence", **kw))
    got = list(pm.generate("streaming test sentence", **kw))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.audio, np.asarray(w.audio), atol=1e-6)
        assert (g.segment_idx, g.token_count, g.is_final_chunk) == \
            (w.segment_idx, w.token_count, w.is_final_chunk)
    assert got[-1].is_final_chunk and got[0].is_streaming_chunk


def test_server_reference_cache_matches_jax():
    """prepare_reference encodes once and every request is a voice clone
    of it; the port reads the codec's (T, K) codes as (K, T)."""
    from mlx_audio_tpu.tts.models.higgs_audio import HiggsAudioServer as JS
    from mlx_audio_tpu_torch.tts.models.higgs_audio import HiggsAudioServer

    codes = np.random.RandomState(8).randint(0, 64, (4, 9)).astype(np.int32)
    jm, _ = _jax_model()
    pm = _port()
    jm.codec, pm.codec = _JaxFakeCodec(codes), _PortFakeCodec(codes)
    js, ps = JS(jm), HiggsAudioServer(pm)
    ref = np.random.RandomState(4).randn(5760).astype(np.float32)
    js.prepare_reference(ref, "ref text")
    ps.prepare_reference(ref, "ref text")
    np.testing.assert_array_equal(ps._reference[0], codes)
    want = js.generate("served text", temperature=0.0, max_new_frames=24)
    got = ps.generate("served text", temperature=0.0, max_new_frames=24)
    np.testing.assert_array_equal(got.prompt["codes"], want.prompt["codes"])
    np.testing.assert_allclose(got.audio, np.asarray(want.audio), atol=1e-6)
    chunks = list(ps.generate_stream_overlap_add(
        "short", temperature=0.0, max_new_frames=24))
    assert chunks and chunks[-1].is_final_chunk
    ps.clear_reference()
    assert ps._reference is None
    smart = ps.generate("served text", temperature=0.0, max_new_frames=8)
    assert smart.sample_rate == 24000


def test_references_alias_and_clone_from_audio():
    """`references=[{"audio", "text"}]` is the first reference's ref_audio
    and ref_text; audio goes through the codec's encode."""
    codes = np.random.RandomState(9).randint(0, 64, (4, 5)).astype(np.int32)
    pm = _port()
    pm.codec = _PortFakeCodec(codes)
    ref = np.zeros(1920, np.float32)
    a = next(pm.generate("t", references=[{"audio": ref, "text": "r"}],
                         temperature=0.0, max_new_frames=8))
    b = next(pm.generate("t", ref_codes=codes, ref_text="r",
                         temperature=0.0, max_new_frames=8))
    np.testing.assert_array_equal(a.prompt["codes"], b.prompt["codes"])
    with pytest.raises(RuntimeError, match="codec"):
        pm.codec = None
        pm.build_prompt("t", ref_audio=ref)


# ---------------------------------------------------------------------------
# W8A8, loading and devices
# ---------------------------------------------------------------------------


def test_w8a8_model_frames_match_jax():
    """The d64 variant quantized to affine 8 bits and converted to W8A8 in
    the JAX package, carried over: every quantized linear is an Int8Linear
    (the audio head stays dense) and the greedy frames are JAX's."""
    from mlx_audio_tpu_torch.nn import Int8Linear, Linear

    jm, _ = _jax_model("q8")
    pm = _port("q8")
    lay = pm.layers[0]
    assert isinstance(lay.self_attn.q_proj, Int8Linear)
    assert isinstance(lay.audio_mlp.down_proj, Int8Linear)
    assert isinstance(pm.audio_decoder_proj.audio_lm_head, Linear)
    want = _frames(jm.generate_frames(*jm.build_prompt("quantized"),
                                      max_new_frames=32, temperature=0.0))
    got = _frames(pm.generate_frames(*pm.build_prompt("quantized"),
                                     max_new_frames=32, temperature=0.0))
    np.testing.assert_array_equal(got, want)


def test_quant_predicate_and_apply_quantization():
    """The audio head and codebook embeddings stay dense; with mxu_int8 the
    rest becomes W8A8 and equals the JAX package's apply_quantization."""
    from mlx_audio_tpu.utils import apply_quantization as japply
    from mlx_audio_tpu.utils import flatten
    from mlx_audio_tpu_torch.nn import Int8Linear, Linear
    from mlx_audio_tpu_torch.utils import apply_quantization

    jm, flat = _jax_model()
    pm = _port()
    for path, want in (("layers.0.mlp.gate_proj", True),
                       ("audio_decoder_proj.audio_lm_head", False),
                       ("audio_codebook_embeddings", False),
                       ("audio_decoder_proj.text_lm_head", True)):
        assert pm.model_quant_predicate(path, None) is want
        assert jm.model_quant_predicate(path, None) is want
    conf = {"quantization": {"bits": 8, "group_size": 16, "mxu_int8": True}}
    apply_quantization(pm, conf, pm.model_quant_predicate)
    jp = flatten(japply(jm.params, conf,
                        model_quant_predicate=jm.model_quant_predicate))
    assert isinstance(pm.layers[1].mlp.up_proj, Int8Linear)
    assert isinstance(pm.audio_decoder_proj.text_lm_head, Int8Linear)
    assert isinstance(pm.audio_decoder_proj.audio_lm_head, Linear)
    state = pm.state_dict()
    w8 = [k for k in jp if k.endswith(".w_i8")]
    assert len(w8) == 2 * (4 + 2 * 3) + 1
    for k in w8:
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(jp[k]))
        s = k[:-len("w_i8")] + "scale"
        np.testing.assert_allclose(state[s].numpy(), np.asarray(jp[s]),
                                   rtol=1e-7)


def _write_checkpoint(jm, flat, path, tie: bool, extra=None):
    path.mkdir(parents=True, exist_ok=True)
    weights = dict(flat)
    if tie:
        del weights["audio_decoder_proj.text_lm_head.weight"]
    weights["layers.0.self_attn.rotary_emb.inv_freq"] = np.ones(4, np.float32)
    np.savez(path / "model.npz", **weights)
    cfg = dataclasses.asdict(jm.config)
    cfg.pop("model_path")
    cfg.update(extra or {})
    (path / "config.json").write_text(json.dumps(cfg))


@pytest.mark.parametrize("quant", [None, "w8a8"])
def test_load_model_matches_jax(tmp_path, quant):
    """load_model on one tiny checkpoint (no text head: tied to
    embed_tokens; a stray rotary buffer) in both packages gives equal greedy
    frames, dense and with the W8A8 quantization entry."""
    from mlx_audio_tpu.utils import load_model as jload
    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.nn import Int8Linear

    variant = "tiny" if quant is None else "q8base"
    if variant == "q8base":
        from mlx_audio_tpu.tts.models.higgs_audio import Model
        from mlx_audio_tpu.utils import flatten

        jm = Model(_q8_cfg()).init_and_bind()
        flat = {k: np.asarray(v) for k, v in flatten(jm.params).items()}
    else:
        jm, flat = _jax_model()
    extra = None if quant is None else {"quantization": {
        "bits": 8, "group_size": 64, "mxu_int8": True}}
    _write_checkpoint(jm, flat, tmp_path, tie=True, extra=extra)
    jl = jload(str(tmp_path))
    pl = load_model(tmp_path, device="cpu")
    assert pl.tokenizer is None
    if quant is None:
        np.testing.assert_array_equal(
            pl.audio_decoder_proj.text_lm_head.weight.numpy(),
            flat["embed_tokens.weight"])
    else:
        assert isinstance(pl.layers[0].mlp.gate_proj, Int8Linear)
        assert isinstance(pl.audio_decoder_proj.text_lm_head, Int8Linear)
    rs = np.random.RandomState(10)
    d = jm.config.text.hidden_size
    emb = (rs.randn(1, 20, d) * 0.5).astype(np.float32)
    mask = np.zeros((1, 20), bool)
    want = _frames(jl.generate_frames(jnp.asarray(emb), jnp.asarray(mask),
                                      max_new_frames=20, temperature=0.0))
    got = _frames(pl.generate_frames(torch.from_numpy(emb),
                                     torch.from_numpy(mask),
                                     max_new_frames=20, temperature=0.0))
    np.testing.assert_array_equal(got, want)


def test_post_load_hook_reads_the_tokenizer(tmp_path):
    """A directory with tokenizer files gets the HF tokenizer (when
    transformers is installed); a broken tokenizer file raises."""
    pytest.importorskip("transformers")
    from mlx_audio_tpu_torch.tts.models.higgs_audio import Model

    pm = _port()
    assert Model.post_load_hook(pm, tmp_path).tokenizer is None
    (tmp_path / "tokenizer.json").write_text("{not json")
    with pytest.raises(Exception):
        Model.post_load_hook(pm, tmp_path)


def test_entry_points_default_to_cuda(tmp_path):
    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.codec.models.higgs_audio import Model as Codec
    from mlx_audio_tpu_torch.stt.models.wav2vec import Wav2Vec2Model
    from mlx_audio_tpu_torch.tts.models.higgs_audio import Model

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults do not raise")
    jm, flat = _jax_model()
    _write_checkpoint(jm, flat, tmp_path, tie=False)
    for make in (lambda: Model(dataclasses.asdict(jm.config)),
                 lambda: Codec(), lambda: Wav2Vec2Model({}),
                 lambda: load_model(tmp_path)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.mark.parametrize("model_type", ["higgs", "higgs_audio_v3"])
def test_unported_higgs_family_raises(tmp_path, model_type):
    from mlx_audio_tpu_torch import load_model

    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": model_type}))
    with pytest.raises(ValueError, match="higgs_audio_v3"):
        load_model(tmp_path, device="cpu")
