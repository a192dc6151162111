"""Whisper in the PyTorch port against the JAX package, on the CPU at f32.

The config is `tests/test_whisper.py::DIMS` (a 2-layer, 32-wide model with
the real 51,865-token vocabulary, so its 2-s windows use the real special
ids). One JAX parameter tree (`init_and_bind()`, key 0) reaches the port
through `model.load_jax_params`; the same seeded numpy inputs go through
both packages.

Tolerances: layer outputs 2e-4 absolute (the repo's torch-parity
precedent, tests/test_torch_parity.py:19; summation order only);
`detect_language_probs` 1e-5; `avg_logprob` and `no_speech_prob` 1e-4;
word times 1e-4. Greedy and beam tokens, segments and texts must be equal:
f32 random weights leave no ties between candidates, so `torch.topk` and
`lax.top_k` (which may order equal scores differently) pick the same
beams. Draws at a temperature differ between the packages' random streams,
so sampling and best-of are held to their rules and to their own seed.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_whisper import DIMS  # noqa: E402

ATOL = 2e-4
PROB_TOL = 1e-5
LP_TOL = 1e-4
TIME_TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model) with the same parameters."""
    from mlx_audio_tpu.stt.models.whisper import Model as JaxModel
    from mlx_audio_tpu.utils import flatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions

    jm = JaxModel(DIMS).init_and_bind()
    flat = {k: np.asarray(v) for k, v in flatten(jm.params).items()}
    dims = ModelDimensions(**dataclasses.asdict(DIMS))
    return jm, load_jax_params(Model(dims, device="cpu"), flat)


@pytest.fixture(scope="module")
def mel():
    return np.random.RandomState(0).randn(1, 200, 80).astype(np.float32) * 0.1


def _noise(seconds, seed=1):
    return (np.random.RandomState(seed).randn(int(16000 * seconds))
            * 0.05).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_parameter_names_are_the_jax_tree(pair):
    from mlx_audio_tpu.utils import flatten

    jm, pm = pair
    assert set(pm.state_dict()) == set(flatten(jm.params))


def test_encoder_and_cross_kv_match_jax(pair, mel):
    from mlx_audio_tpu.stt.models.whisper import whisper as jw
    from mlx_audio_tpu_torch.stt.models.whisper import whisper as pw

    jm, pm = pair
    jf = jw.encoder_forward(jm.params, jm.dims, jnp.asarray(mel))
    pf = pw.encoder_forward(pm, torch.from_numpy(mel))
    assert pf.shape == (1, 100, 32)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), atol=ATOL, rtol=0)
    for (jk, jv), (pk, pv) in zip(jw.cross_kv(jm.params, jm.dims, jf),
                                  pw.cross_kv(pm, pf)):
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=ATOL,
                                   rtol=0)


def test_decoder_forward_prefill_and_cached_steps_match_jax(pair, mel):
    """A right-padded prompt bucket prefilled into the n_text_ctx cache
    under its mask, then three cached steps; and the cache-less causal
    forward. Logits within ATOL at each."""
    from mlx_audio_tpu.ops.kvcache import KVCache as JaxKVCache
    from mlx_audio_tpu.stt.models.whisper import whisper as jw
    from mlx_audio_tpu_torch.ops.kvcache import KVCache
    from mlx_audio_tpu_torch.stt.models.whisper import whisper as pw

    jm, pm = pair
    d, n_ctx, layers = DIMS.n_text_state, DIMS.n_text_ctx, DIMS.n_text_layer
    jf = jw.encoder_forward(jm.params, jm.dims, jnp.asarray(mel))
    jckv = jw.cross_kv(jm.params, jm.dims, jf)
    pckv = pw.cross_kv(pm, pw.encoder_forward(pm, torch.from_numpy(mel)))
    prompt = np.array([[50258, 50259, 50360, 50364, 0, 0, 0, 0]])
    plen, pb = 4, 8
    mask = np.where(np.arange(n_ctx)[None] <= np.arange(pb)[:, None], 0.0,
                    -np.inf).astype(np.float32)[None, None]
    pos = np.arange(pb)[None]
    jc = [JaxKVCache.init(1, n_ctx, 1, d, jnp.float32) for _ in range(layers)]
    pc = KVCache.init(1, n_ctx, 1, d, torch.float32, "cpu", n_layers=layers)
    jl, jc = jw.decoder_forward(jm.params, jm.dims, jnp.asarray(prompt),
                                jnp.asarray(pos), jckv, jc, 0,
                                jnp.asarray(mask))
    pl, pc = pw.decoder_forward(pm, torch.from_numpy(prompt),
                                torch.from_numpy(pos), pckv, pc, 0,
                                torch.from_numpy(mask))
    np.testing.assert_allclose(pl.numpy()[:, :plen], np.asarray(jl)[:, :plen],
                               atol=ATOL, rtol=0)
    for step, tok in enumerate([1000, 50400, 7]):
        cur = plen + step
        smask = np.where(np.arange(n_ctx) <= cur, 0.0, -np.inf).astype(
            np.float32).reshape(1, 1, 1, n_ctx)
        t = np.array([[tok]])
        p = np.array([[cur]])
        jl, jc = jw.decoder_forward(jm.params, jm.dims, jnp.asarray(t),
                                    jnp.asarray(p), jckv, jc, cur,
                                    jnp.asarray(smask))
        pl, pc = pw.decoder_forward(pm, torch.from_numpy(t),
                                    torch.from_numpy(p), pckv, pc, cur,
                                    torch.from_numpy(smask))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
    toks = np.array([[50258, 50259, 50360, 1000, 50400, 7]])
    jl, _ = jw.decoder_forward(jm.params, jm.dims, jnp.asarray(toks),
                               jnp.arange(6)[None], jckv, None, 0, None)
    pl, _ = pw.decoder_forward(pm, torch.from_numpy(toks),
                               torch.arange(6)[None], pckv, None, 0, None)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_decoder_forward_with_cross_qk_matches_jax(pair, mel):
    from mlx_audio_tpu.stt.models.whisper import whisper as jw
    from mlx_audio_tpu_torch.stt.models.whisper import whisper as pw

    jm, pm = pair
    toks = np.array([[50258, 50259, 50360, 50364, 1000, 2000, 50257]])
    jf = jw.encoder_forward(jm.params, jm.dims, jnp.asarray(mel))
    jl, jq = jw.decoder_forward_with_cross_qk(
        jm.params, jm.dims, jnp.asarray(toks),
        jw.cross_kv(jm.params, jm.dims, jf))
    pckv = pw.cross_kv(pm, pw.encoder_forward(pm, torch.from_numpy(mel)))
    pl, pq = pw.decoder_forward_with_cross_qk(pm, torch.from_numpy(toks),
                                              pckv)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert len(pq) == len(jq) == DIMS.n_text_layer
    for a, b in zip(pq, jq):
        assert a.shape == (1, DIMS.n_text_head, 7, 100)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)


def test_detect_language_matches_jax(pair, mel):
    jm, pm = pair
    want = np.asarray(jm.detect_language_probs(mel))
    got = pm.detect_language_probs(mel).numpy()
    np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)
    assert pm.detect_language(mel)[0] == jm.detect_language(mel)[0]


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _tasks(pair, **kw):
    from mlx_audio_tpu.stt.models.whisper.decoding import (
        DecodingOptions as JaxOptions, DecodingTask as JaxTask)
    from mlx_audio_tpu_torch.stt.models.whisper.decoding import (
        DecodingOptions, DecodingTask)

    jm, pm = pair
    kw.setdefault("language", "en")
    kw.setdefault("sample_len", 16)
    return JaxTask(jm, JaxOptions(**kw)), DecodingTask(pm, DecodingOptions(**kw))


def _same_result(got, want):
    assert got.tokens == want.tokens
    assert got.text == want.text
    assert abs(got.avg_logprob - want.avg_logprob) <= LP_TOL
    assert abs(got.no_speech_prob - want.no_speech_prob) <= LP_TOL


@pytest.mark.parametrize("case", ["timestamps", "no_timestamps", "prompt",
                                  "prefix"])
def test_greedy_decoding_matches_jax(pair, mel, case):
    kw = {"no_timestamps": dict(without_timestamps=True),
          "prefix": dict(prefix=[500, 600])}.get(case, {})
    prompt = [100, 200, 300, 400, 500] if case == "prompt" else []
    jt, pt = _tasks(pair, **kw)
    want = jt.run(mel, prompt, temperature=0.0)
    got = pt.run(mel, prompt, temperature=0.0)
    assert len(got.tokens) > 0
    _same_result(got, want)


def test_beam_search_matches_jax(pair, mel):
    """Beam 1 is greedy; beam 5 keeps JAX's tokens (f32 random weights: no
    ties among the flattened candidates)."""
    _, greedy = _tasks(pair, sample_len=10)
    _, beam1 = _tasks(pair, sample_len=10, beam_size=1)
    assert beam1.run(mel, [], 0.0).tokens == greedy.run(mel, [], 0.0).tokens
    jt, pt = _tasks(pair, sample_len=10, beam_size=5)
    want = jt.run(mel, [], temperature=0.0)
    got = pt.run(mel, [], temperature=0.0)
    _same_result(got, want)
    assert pt.n_group == 5


def _assert_timestamp_rules(tokens, tok):
    assert tokens[0] >= tok.timestamp_begin
    for a, b, c in zip(tokens, tokens[1:], tokens[2:]):
        if a >= tok.timestamp_begin and b >= tok.timestamp_begin:
            assert c < tok.timestamp_begin
    ts = [t for t in tokens if t >= tok.timestamp_begin]
    assert ts == sorted(ts)


@pytest.mark.parametrize("kw", [dict(temperature=0.6),
                                dict(temperature=0.6, best_of=3)])
def test_sampling_keeps_the_rules_and_its_seed(pair, mel, kw):
    _, pt = _tasks(pair, **kw)
    r1 = pt.run(mel, [], temperature=0.6)
    r2 = pt.run(mel, [], temperature=0.6)
    assert r1.tokens == r2.tokens and len(r1.tokens) > 0
    assert r1.avg_logprob == r2.avg_logprob and np.isfinite(r1.avg_logprob)
    _assert_timestamp_rules(r1.tokens, pt.tokenizer)
    banned = set(pt.suppress) | {pt.tokenizer.no_timestamps}
    assert not (set(r1.tokens) & banned)
    greedy = _tasks(pair)[1].run(mel, [], temperature=0.0)
    assert r1.tokens != greedy.tokens


def test_loop_stops_one_step_after_eot(pair, mel):
    """The loop reads step i-1's finished flag before launching step i+1:
    with EOT sampled at step s it runs s + 2 steps at most, and keeps the
    tokens before EOT."""
    from mlx_audio_tpu_torch.stt.models.whisper.decoding import (
        STEPS_AFTER_EOT)

    jt, pt = _tasks(pair, without_timestamps=True, sample_len=30)
    plain = pt.run(mel, [], temperature=0.0)
    assert pt.last_steps == 30 and len(plain.tokens) == 30
    eot = pt.tokenizer.eot
    make = pt._make_filters
    for stop_at in (0, 4, 27, 28):
        def forced(device, stop_at=stop_at):
            f = make(device)

            def apply(logits, n_sampled, *args):
                out = f(logits, n_sampled, *args)
                if n_sampled == stop_at:
                    out = torch.full_like(out, float("-inf"))
                    out[:, eot] = 0.0
                return out
            return apply
        pt._make_filters = forced
        try:
            r = pt.run(mel, [], temperature=0.0)
        finally:
            del pt._make_filters
        assert r.tokens == plain.tokens[:stop_at]
        assert pt.last_steps == min(stop_at + 1 + STEPS_AFTER_EOT, 30)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------


def _same_output(got, want, words=False):
    assert got.text == want.text and got.language == want.language
    assert len(got.segments) == len(want.segments) > 0
    for g, w in zip(got.segments, want.segments):
        for k in ("seek", "tokens", "text", "temperature"):
            assert g[k] == w[k], k
        for k in ("start", "end"):
            assert abs(g[k] - w[k]) <= TIME_TOL, k
        assert abs(g["avg_logprob"] - w["avg_logprob"]) <= LP_TOL
        if words:
            assert [x["word"] for x in g["words"]] == \
                [x["word"] for x in w["words"]]
            for a, b in zip(g["words"], w["words"]):
                assert abs(a["start"] - b["start"]) <= TIME_TOL
                assert abs(a["end"] - b["end"]) <= TIME_TOL
                assert abs(a["probability"] - b["probability"]) <= LP_TOL
    assert got.generation_tokens == want.generation_tokens
    assert got.prompt_tokens == want.prompt_tokens


@pytest.mark.parametrize("case", ["plain", "words", "clip", "hallucination",
                                  "initial_prompt"])
def test_generate_matches_jax(pair, case):
    """7 s of noise: several 2-s windows of the tiny model, conditioned on
    the previous text."""
    jm, pm = pair
    kw = dict(language="en", temperature=0.0)
    kw.update({"words": dict(word_timestamps=True),
               "clip": dict(clip_timestamps="0,2.5,4,6"),
               "hallucination": dict(word_timestamps=True,
                                     hallucination_silence_threshold=1.0),
               "initial_prompt": dict(initial_prompt="hello there",
                                      return_timestamps=False,
                                      sample_len=12)}.get(case, {}))
    audio = _noise(7.0)
    want = jm.generate(audio, **kw)
    got = pm.generate(audio, **kw)
    _same_output(got, want, words=kw.get("word_timestamps", False))
    if case == "clip":
        assert all(s["start"] >= 0.0 for s in got.segments)


def test_generate_reads_a_wav_path(pair, tmp_path):
    from mlx_audio_tpu_torch import audio_io

    jm, pm = pair
    path = tmp_path / "x.wav"
    audio_io.write(path, _noise(3.0, seed=4), 16000)
    want = jm.generate(str(path), language="en", temperature=0.0)
    got = pm.generate(str(path), language="en", temperature=0.0)
    _same_output(got, want)


def test_language_detection_in_generate(pair):
    jm, pm = pair
    audio = _noise(2.5, seed=5)
    got = pm.generate(audio, temperature=0.0, sample_len=6)
    want = jm.generate(audio, temperature=0.0, sample_len=6)
    assert got.language == want.language
    _same_output(got, want)


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------


def _events(model, audio):
    sess = model.create_streaming_session(language="en")
    out = []
    for off in range(0, len(audio), 16000):
        sess.feed(audio[off: off + 16000])
        out += [(e.kind, e.text) for e in sess.step()]
    sess.close()
    while not sess.done:
        out += [(e.kind, e.text) for e in sess.step()]
    return out, sess.text


def test_streaming_session_events_match_jax(pair):
    jm, pm = pair
    audio = _noise(5.0, seed=6)
    got, got_text = _events(pm, audio)
    want, want_text = _events(jm, audio)
    assert got == want and got_text == want_text
    assert got[-1][0] == "final"
    assert pm.create_streaming_session().input_sample_rate == 16000


def test_generate_stream_yields_the_streaming_deltas(pair):
    """generate(stream=True) yields every text delta of the streaming
    session (those generate_streaming yields while feeding, then the one
    closing commits), which together make its final text."""
    jm, pm = pair
    audio = _noise(5.0, seed=6)
    streamed = list(pm.generate_streaming(audio))
    want = list(jm.generate_streaming(audio))
    assert [s.text for s in streamed] == [s.text for s in want]
    deltas = list(pm.generate(audio, stream=True, language="en"))
    assert [d.text for d in deltas[:len(streamed) - 1]] == \
        [s.text for s in streamed[:-1]]
    assert "".join(d.text for d in deltas) == streamed[-1].text
    assert all(d.language == "en" for d in deltas)


# ---------------------------------------------------------------------------
# weights, options, devices
# ---------------------------------------------------------------------------


HF_NAMES = [
    (".attn.query.", ".self_attn.q_proj."), (".attn.key.", ".self_attn.k_proj."),
    (".attn.value.", ".self_attn.v_proj."), (".attn.out.", ".self_attn.out_proj."),
    (".cross_attn.query.", ".encoder_attn.q_proj."),
    (".cross_attn.key.", ".encoder_attn.k_proj."),
    (".cross_attn.value.", ".encoder_attn.v_proj."),
    (".cross_attn.out.", ".encoder_attn.out_proj."),
    (".attn_ln.", ".self_attn_layer_norm."),
    (".cross_attn_ln.", ".encoder_attn_layer_norm."),
    (".mlp_ln.", ".final_layer_norm."), (".mlp1.", ".fc1."),
    (".mlp2.", ".fc2."), (".blocks.", ".layers.")]


def checkpoint_trees(flat):
    """(HF-named, OpenAI/mlx-named) checkpoints of a JAX Whisper tree (flat
    {name: array}) in their torch layouts: stem convs (O, I, 3) for HF,
    (O, 3, I) for mlx; the HF one with its encoder positions and
    `proj_out`, which sanitize drops."""
    hf, mlx = {}, {}
    for k, v in flat.items():
        if k.endswith(("conv1.weight", "conv2.weight")):
            mlx[k] = np.transpose(v, (2, 0, 1))       # WIO -> (O, 3, I)
            v = np.transpose(v, (2, 1, 0))            # WIO -> (O, I, 3)
        else:
            mlx[k] = v
        h = k.replace("encoder.ln_post.", "encoder.layer_norm.").replace(
            "decoder.ln.", "decoder.layer_norm.").replace(
            "decoder.token_embedding.", "decoder.embed_tokens.").replace(
            "decoder.positional_embedding", "decoder.embed_positions.weight")
        for a, b in HF_NAMES:
            h = h.replace(a, b)
        hf["model." + h] = v
    d = flat["encoder.ln_post.weight"].shape[0]
    hf["model.encoder.embed_positions.weight"] = np.zeros((4, d), np.float32)
    hf["proj_out.weight"] = flat["decoder.token_embedding.weight"]
    return hf, mlx


def _flat(pair):
    from mlx_audio_tpu.utils import flatten

    return {k: np.asarray(v) for k, v in flatten(pair[0].params).items()}


@pytest.mark.parametrize("layout", ["hf", "mlx"])
def test_sanitize_matches_jax_and_loads(pair, mel, layout):
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions

    jm, pm = pair
    tree = dict(zip(("hf", "mlx"), checkpoint_trees(_flat(pair))))[layout]
    want = jm.sanitize({k: jnp.asarray(v) for k, v in tree.items()})
    got = pm.sanitize(tree)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    fresh = load_jax_params(Model(ModelDimensions(**dataclasses.asdict(DIMS)),
                                  device="cpu"), got)
    np.testing.assert_array_equal(fresh.embed_audio(mel).numpy(),
                                  pm.embed_audio(mel).numpy())


def test_dims_from_hf_config():
    from mlx_audio_tpu.stt.models.whisper import ModelDimensions as JaxDims
    from mlx_audio_tpu_torch.stt.models.whisper import ModelDimensions

    cfg = {"d_model": 384, "encoder_layers": 4, "decoder_layers": 4,
           "encoder_attention_heads": 6, "decoder_attention_heads": 6,
           "num_mel_bins": 80, "vocab_size": 51865,
           "max_source_positions": 1500, "max_target_positions": 448}
    assert dataclasses.asdict(ModelDimensions.from_dict(cfg)) == \
        dataclasses.asdict(JaxDims.from_dict(cfg))
    assert dataclasses.asdict(ModelDimensions.from_dict(
        dataclasses.asdict(DIMS))) == dataclasses.asdict(DIMS)


@pytest.mark.parametrize("kw", [dict(beam_size=3, best_of=3),
                                dict(best_of=3, temperature=0.0),
                                dict(patience=2.0),
                                dict(length_penalty=1.5)])
def test_option_validation_matches_jax(pair, kw):
    from mlx_audio_tpu.stt.models.whisper.decoding import (
        DecodingOptions as JaxOptions, DecodingTask as JaxTask)
    from mlx_audio_tpu_torch.stt.models.whisper.decoding import (
        DecodingOptions, DecodingTask)

    jm, pm = pair
    with pytest.raises(ValueError) as want:
        JaxTask(jm, JaxOptions(**kw))
    with pytest.raises(ValueError) as got:
        DecodingTask(pm, DecodingOptions(**kw))
    assert str(got.value) == str(want.value)


def test_init_params_draws_every_parameter():
    from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions

    dims = ModelDimensions(**dataclasses.asdict(DIMS))
    a = Model(dims, device="cpu").init_params(seed=0)
    b = Model(dims, device="cpu").init_params(seed=0)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.isfinite(p).all(), name
        assert torch.equal(p, q), name
    pe = a.decoder.positional_embedding
    assert 0.005 < float(pe.std()) < 0.02
    a.astype(torch.bfloat16)
    assert a.dtype == torch.bfloat16
    feats = a.embed_audio(np.zeros((1, 200, 80), np.float32))
    assert feats.dtype == torch.bfloat16 and torch.isfinite(feats).all()


def test_model_defaults_to_cuda_and_raises_without_it(monkeypatch):
    import inspect

    from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions

    assert inspect.signature(Model.__init__).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Model(ModelDimensions(**dataclasses.asdict(DIMS)))
