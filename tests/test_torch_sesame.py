"""Sesame CSM in the PyTorch port against the JAX package, on the CPU at
float32: the prompt rows, greedy frames (prefill, the backbone step and
the 31-step depth decoder, here 3), cloning from a reference segment
through the Mimi encoder, audio whole and streamed through Mimi, the
torchtune and HF `CsmForConditionalGeneration` layouts (the embedded
codec, an untied depth-decoder table), `load_model` of a checkpoint
directory through the router, and the port's departures. Mirrors
tests/test_sesame_cloning.py and tests/test_model_families.py::TestSesame
on their config.

One weight set, drawn with numpy over JAX's parameter shapes
(test_torch_mimi.numpy_params), reaches the port through
`load_jax_params`. Greedy frames are equal; audio within 2e-4 absolute and
1e-4 relative to its largest value. Sampled runs are checked for shape
and range only (the two packages' random streams differ).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_sesame_cloning import FakeTok  # noqa: E402
from test_torch_mimi import (MIMI_CFG, flat_numpy, jax_mimi,  # noqa: E402
                             jit_mimi, numpy_params, port_mimi)

ATOL = 2e-4
AUDIO_REL = 1e-4
CFG = dict(
    text_vocab_size=128, audio_vocab_size=40, audio_num_codebooks=4,
    backbone_config=dict(hidden_size=32, num_hidden_layers=2,
                         intermediate_size=64, num_attention_heads=4,
                         num_key_value_heads=2, head_dim=8),
    depth_decoder_config=dict(hidden_size=24, num_hidden_layers=1,
                              intermediate_size=48, num_attention_heads=4,
                              num_key_value_heads=2, head_dim=8))
MIMI = dict(MIMI_CFG, quantizer_bins=40)
REF_AUDIO = np.random.RandomState(0).randn(24 * 50).astype(np.float32) * 0.1


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def _jax(cfg=CFG, mimi_cfg=MIMI, params=None):
    from mlx_audio_tpu.tts.models.sesame import Model, ModelConfig

    jm = Model(ModelConfig(**cfg))
    jm.bind(numpy_params(jm.init_params, 0) if params is None else params)
    jm.tokenizer = FakeTok()
    jm._mimi = jax_mimi(mimi_cfg, 1)
    return jm


def _port(jm, cfg=CFG, mimi_cfg=MIMI):
    from mlx_audio_tpu_torch.tts.models.sesame import (Model, ModelConfig,
                                                       load_jax_params)

    pm = load_jax_params(Model(ModelConfig(**cfg), device="cpu"),
                         flat_numpy(jm.params))
    pm.tokenizer = FakeTok()
    pm.set_codec(port_mimi(jm._mimi, mimi_cfg))
    return pm


@pytest.fixture(scope="module")
def pair():
    jm = _jax()
    return jm, _port(jm)


def _gen(model, **kw):
    kw.setdefault("temperature", 0.0)
    kw.setdefault("max_audio_length_ms", 1600)
    return list(model.generate(**kw))


# ---------------------------------------------------------------------------
# prompt assembly (tests/test_sesame_cloning.py::TestPromptAssembly)
# ---------------------------------------------------------------------------


def test_segment_rows_order(pair):
    """Text rows, then audio rows and an all-zero EOS frame; the rows equal
    JAX's (the reference's Mimi codes included)."""
    from mlx_audio_tpu_torch.tts.models.sesame import Segment

    jm, pm = pair
    seg = Segment(speaker=0, text="hi", audio=REF_AUDIO)
    rows, mask = pm._segment_rows(seg, add_eos=True)
    n_text = len(pm._tokenize_text_segment("hi", 0))
    assert mask[:n_text, -1].all() and not mask[:n_text, :-1].any()
    assert mask[n_text:, :-1].all() and not mask[n_text:, -1].any()
    assert (rows[-1, :-1] == 0).all()
    jrows, jmask = jm._segment_rows(seg, add_eos=True)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(mask, jmask)


def test_voice_match_skips_eos(pair):
    from mlx_audio_tpu_torch.tts.models.sesame import Segment

    _, pm = pair
    seg = Segment(speaker=0, text="hi", audio=REF_AUDIO)
    with_eos, _ = pm._segment_rows(seg, add_eos=True)
    without, _ = pm._segment_rows(seg, add_eos=False)
    assert len(with_eos) == len(without) + 1


def test_default_voice_prompt_missing(pair):
    _, pm = pair
    with pytest.raises(ValueError, match="voice preset"):
        pm.default_speaker_prompt("conversational_a")


def test_default_voice_prompt_local(pair, tmp_path):
    from mlx_audio_tpu_torch.audio_io import write as wav_write

    _, pm = pair
    prompts = tmp_path / "prompts"
    prompts.mkdir()
    wav_write(str(prompts / "zoe.wav"), REF_AUDIO, 24000)
    (prompts / "zoe.txt").write_text("a preset transcript")
    old = pm.config.model_path
    pm.config.model_path = str(tmp_path)
    try:
        ctx = pm.default_speaker_prompt("zoe")
        # `voice` reaches it through generate
        out = _gen(pm, text="hello", voice="zoe", max_audio_length_ms=240)
    finally:
        pm.config.model_path = old
    assert len(ctx) == 1 and ctx[0].text == "a preset transcript"
    assert ctx[0].audio is not None and len(ctx[0].audio) > 0
    assert out[0].samples > 0


def test_prompt_layout(pair):
    _, pm = pair
    tokens, mask = pm.build_prompt(np.asarray([1, 2, 3]),
                                   np.zeros((2, 4), np.int32))
    assert tokens.shape == (1, 5, 5)
    assert mask[0, 0, :4].all() and not mask[0, 0, 4]
    assert mask[0, 2, 4] and not mask[0, 2, :4].any()


# ---------------------------------------------------------------------------
# generation against JAX
# ---------------------------------------------------------------------------


def test_greedy_frames_and_audio_equal_jax(pair):
    """text_ids: the prefill over its bucket, greedy frames equal, Mimi
    audio within tolerance (tests/test_model_families.py's greedy case)."""
    jm, pm = pair
    ids = np.arange(5, 15)
    (jr,) = _gen(jm, text_ids=ids)
    (pr,) = _gen(pm, text_ids=ids)
    assert pr.prompt["codes"].shape == (20, 4)
    np.testing.assert_array_equal(pr.prompt["codes"], jr.prompt["codes"])
    np.testing.assert_allclose(pr.audio, np.asarray(jr.audio), atol=ATOL)
    assert _rel(pr.audio, np.asarray(jr.audio)) < AUDIO_REL
    assert pm.last_run["frames"] == 20
    (again,) = _gen(pm, text_ids=ids)
    np.testing.assert_array_equal(again.prompt["codes"], pr.prompt["codes"])


def test_prefill_hidden_matches_jax(pair):
    """The backbone over a padded prompt bucket under the pad mask: the
    first frame and the next embed equal JAX's."""
    jm, pm = pair
    tokens, mask = pm.build_prompt(np.arange(3, 20), np.random.RandomState(
        1).randint(0, 40, (5, 4)))
    prefill = jm._prefill_fn(0.0, 50)
    pb = 32
    jt = np.pad(tokens, ((0, 0), (0, pb - tokens.shape[1]), (0, 0)))
    jmask = np.pad(mask, ((0, 0), (0, pb - mask.shape[1]), (0, 0)))
    carry, jframe, _ = prefill(jm.params, jnp.asarray(jt), jnp.asarray(jmask),
                               jnp.int32(tokens.shape[1]),
                               jax.random.PRNGKey(0))
    pcarry, frame = pm.prefill(tokens, mask, pm._sampler(0.0, 50, 0))
    np.testing.assert_array_equal(frame.numpy(), np.asarray(jframe))
    np.testing.assert_allclose(pcarry.embed.numpy(), np.asarray(carry[1]),
                               atol=ATOL)
    assert pcarry.pos == tokens.shape[1]


def test_ref_audio_generate_matches_jax(pair):
    """Cloning a reference segment with voice_match: the merged text over
    the reference's codes (no EOS frame); frames and audio equal JAX's."""
    jm, pm = pair
    kw = dict(text="hello there", ref_audio=REF_AUDIO,
              ref_text="a reference", voice_match=True)
    (jr,) = _gen(jm, **kw)
    (pr,) = _gen(pm, **kw)
    assert pr.samples > 0 and np.isfinite(pr.audio).all()
    np.testing.assert_array_equal(pr.prompt["codes"], jr.prompt["codes"])
    np.testing.assert_allclose(pr.audio, np.asarray(jr.audio), atol=ATOL)
    assert pr.prompt["tokens"] == jr.prompt["tokens"]


def test_voice_match_changes_prompt(pair):
    """Unmatched: the reference segment with its EOS frame, then the
    prompt's text rows: another prompt, other frames (JAX's)."""
    jm, pm = pair
    kw = dict(text="same words", ref_audio=REF_AUDIO, ref_text="ref")
    (a,) = _gen(pm, voice_match=True, **kw)
    (b,) = _gen(pm, voice_match=False, **kw)
    ca, cb = a.prompt["codes"], b.prompt["codes"]
    assert a.prompt["tokens"] != b.prompt["tokens"]
    assert ca.shape != cb.shape or not np.array_equal(ca, cb)
    (jb,) = _gen(jm, voice_match=False, **kw)
    np.testing.assert_array_equal(cb, jb.prompt["codes"])


def test_split_pattern_segments(pair):
    _, pm = pair
    outs = _gen(pm, text="one\ntwo", max_audio_length_ms=800,
                voice_match=False)
    assert [r.segment_idx for r in outs] == [0, 1]


def test_stream_equals_offline_and_jax(pair):
    """Mimi's decoder is causal: the streamed chunks joined equal the
    offline decode, and JAX's streamed chunks."""
    jm, pm = pair
    kw = dict(text="stream me please", max_audio_length_ms=2400,
              voice_match=False, seed=7)
    (off,) = _gen(pm, **kw)
    st = _gen(pm, stream=True, streaming_interval=0.2, **kw)
    jst = _gen(jm, stream=True, streaming_interval=0.2, **kw)
    assert len(st) == len(jst) >= 2
    stream_audio = np.concatenate([r.audio for r in st])
    assert len(stream_audio) == len(off.audio) > 0
    np.testing.assert_allclose(stream_audio, off.audio, atol=1e-5)
    np.testing.assert_allclose(
        stream_audio, np.concatenate([np.asarray(r.audio) for r in jst]),
        atol=ATOL)
    # interval chunks are streaming chunks; a trailing partial one is
    # final (none when the frames end on an interval), as JAX's
    assert all(r.is_streaming_chunk or r.is_final_chunk for r in st)
    assert [(r.is_streaming_chunk, r.is_final_chunk) for r in st] == \
        [(r.is_streaming_chunk, r.is_final_chunk) for r in jst]


def test_sampled_frames_in_range(pair):
    _, pm = pair
    (r,) = _gen(pm, text_ids=np.arange(5, 20), temperature=0.8,
                max_audio_length_ms=2000)
    codes = r.prompt["codes"]
    assert codes.ndim == 2 and codes.shape[1] == 4
    assert (codes < 40).all() and (codes >= 0).all()


def test_voice_clone_context_changes_output(pair):
    _, pm = pair
    ctx = np.random.RandomState(0).randint(0, 40, (6, 4))
    (r1,) = _gen(pm, text_ids=np.arange(5, 15), context_frames=ctx)
    (r2,) = _gen(pm, text_ids=np.arange(5, 15))
    assert (r1.prompt["codes"].shape != r2.prompt["codes"].shape or
            (r1.prompt["codes"] != r2.prompt["codes"]).any())


def test_eos_on_codebook_zero_ends_the_request():
    """Codebook 0's EOS row made large: generation stops at the frame that
    samples it, as JAX's (the frame itself not kept); the chunk runs
    STEPS_AFTER_EOS frames past it."""
    from mlx_audio_tpu_torch.tts.models.sesame.sesame import STEPS_AFTER_EOS

    from mlx_audio_tpu.tts.models.sesame import Model, ModelConfig

    params = numpy_params(Model(ModelConfig(**CFG)).init_params, 0)
    w = np.asarray(params["codebook0_head"]["weight"]).copy()
    w[0] *= 2.3              # EOS at the seventh frame of seed 0's weights
    params["codebook0_head"]["weight"] = jnp.asarray(w)
    jm = _jax(params=params)
    pm = _port(jm)
    (jr,) = _gen(jm, text_ids=np.arange(5, 15), max_audio_length_ms=4000)
    (pr,) = _gen(pm, text_ids=np.arange(5, 15), max_audio_length_ms=4000)
    n = len(pr.prompt["codes"])
    assert n == 6
    np.testing.assert_array_equal(pr.prompt["codes"], jr.prompt["codes"])
    assert pm.last_run["frames"] == n
    calls = []
    chunk = pm.chunk

    def counting(carry, k, sampler):
        frames, fins = chunk(carry, k, sampler)
        calls.append(len(frames))
        return frames, fins

    pm.chunk = counting
    try:
        _gen(pm, text_ids=np.arange(5, 15), max_audio_length_ms=4000)
    finally:
        del pm.chunk
    # the first frame, the kept ones, the EOS frame, STEPS_AFTER_EOS more
    assert 1 + sum(calls) == n + 1 + STEPS_AFTER_EOS


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _torchtune_names(flat: dict) -> dict:
    inv = {}
    for k, w in flat.items():
        tk = (k.replace(".self_attn.", ".attn.")
               .replace(".o_proj.", ".output_proj.")
               .replace(".mlp.gate_proj.", ".mlp.w1.")
               .replace(".mlp.down_proj.", ".mlp.w2.")
               .replace(".mlp.up_proj.", ".mlp.w3.")
               .replace(".input_layernorm.weight", ".sa_norm.scale")
               .replace(".post_attention_layernorm.weight", ".mlp_norm.scale"))
        if tk in ("backbone.norm.weight", "decoder.norm.weight"):
            tk = tk.replace(".weight", ".scale")
        inv["model." + tk] = np.asarray(w)
    return inv


def test_torchtune_sanitize_roundtrip(pair):
    """torchtune names (attn/output_proj, mlp.w1/w2/w3, sa_norm/mlp_norm
    `scale`) map onto this tree exactly: the same frames."""
    from mlx_audio_tpu_torch.tts.models.sesame import Model, ModelConfig

    _, pm = pair
    flat = {k: v.numpy() for k, v in pm.state_dict().items()}
    flat["model.backbone.layers.0.attn.rotary_emb.inv_freq"] = np.ones(4)
    m2 = Model(ModelConfig(**CFG), device="cpu")
    m2.bind(m2.sanitize(_torchtune_names(flat)))
    m2.tokenizer = FakeTok()
    for k, v in pm.state_dict().items():
        assert torch.equal(m2.state_dict()[k], v), k
    (a,) = _gen(pm, text_ids=np.arange(5, 15))
    (b,) = _gen(m2, text_ids=np.arange(5, 15))
    np.testing.assert_array_equal(a.prompt["codes"], b.prompt["codes"])


def hf_csm_state(pm, untied: bool = False) -> dict:
    """The port Sesame under HF `CsmForConditionalGeneration` names with its
    Mimi as codec_model.* (HF MimiModel names); `untied` adds a
    depth-decoder table of its own."""
    from test_torch_mimi import hf_mimi_state

    out = {}
    for k, v in pm.state_dict().items():
        v = v.numpy()
        if k == "audio_embeddings.weight":
            out["backbone_model.embed_tokens.embed_audio_tokens.weight"] = v
        elif k == "text_embeddings.weight":
            out["embed_text_tokens.weight"] = v
        elif k == "codebook0_head.weight":
            out["lm_head.weight"] = v
        elif k == "projection.weight":
            out["depth_decoder.model.inputs_embeds_projector.weight"] = v
        elif k == "audio_head":
            out["depth_decoder.codebooks_head.weight"] = v
        elif k.startswith("decoder."):
            out["depth_decoder.model." + k[len("decoder."):]] = v
        elif k.startswith("backbone."):
            out["backbone_model." + k[len("backbone."):]] = v
        else:
            raise AssertionError(k)
    out["depth_decoder.model.layers.0.self_attn.rotary_emb.inv_freq"] = \
        np.ones(4, np.float32)
    if untied:
        out["depth_decoder.model.embed_tokens.weight"] = (
            np.random.RandomState(9).randn(
                *pm.audio_embeddings.weight.shape) * 0.02).astype(np.float32)
    out.update({"codec_model." + k: v
                for k, v in hf_mimi_state(pm._mimi).items()})
    return out


def test_hf_layout_builds_the_codec_and_an_untied_table(pair):
    """HF names: the embedded codec_model.* becomes the model's Mimi in
    post_load_hook; an untied depth-decoder table is used in the depth
    loop in place of the backbone's audio table, as JAX's
    `decoder_audio_embeddings` (the same frames)."""
    from mlx_audio_tpu.codec.models.mimi import Mimi as JMimi
    from mlx_audio_tpu.codec.models.mimi import MimiConfig as JCfg
    from mlx_audio_tpu.tts.models.sesame import Model as JModel
    from mlx_audio_tpu.tts.models.sesame import ModelConfig as JModelConfig
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.tts.models.sesame import Model, ModelConfig

    _, pm = pair
    hf = hf_csm_state(pm, untied=True)
    cfg = dict(CFG, codec_config=MIMI)
    m2 = Model(ModelConfig(**cfg), device="cpu")
    m2.bind(m2.sanitize(hf))
    Model.post_load_hook(m2, "/nonexistent")
    assert m2._mimi is not None and "decoder_audio_embeddings" in \
        dict(m2.named_children())
    m2.tokenizer = FakeTok()
    jm = JModel(JModelConfig(**cfg))
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in jm.sanitize(hf).items()
                       if "codec_model" not in k}))
    jm.tokenizer = FakeTok()
    jm._mimi = JMimi(JCfg(**MIMI))
    jm._mimi.bind(unflatten({k: jnp.asarray(v) for k, v in
                             jm._mimi.sanitize(jm._hf_codec_weights).items()}))
    jit_mimi(jm._mimi)
    (a,) = _gen(m2, text_ids=np.arange(5, 15))
    (b,) = _gen(jm, text_ids=np.arange(5, 15))
    (c,) = _gen(pm, text_ids=np.arange(5, 15))
    np.testing.assert_array_equal(a.prompt["codes"], b.prompt["codes"])
    assert not np.array_equal(a.prompt["codes"], c.prompt["codes"])
    np.testing.assert_allclose(a.audio, np.asarray(b.audio), atol=ATOL)


def test_load_model_of_a_csm_directory(pair, tmp_path):
    """An HF csm checkpoint directory (config.json with model_type "csm",
    its codec_config, HF names in npz) through the `load_model` router with
    no category: the Sesame model, its codec built, the same audio."""
    import json

    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.tts.models.sesame import Model

    _, pm = pair
    np.savez(tmp_path / "model.npz", **hf_csm_state(pm))
    bb = CFG["backbone_config"]
    (tmp_path / "config.json").write_text(json.dumps(dict(
        model_type="csm", num_codebooks=4, vocab_size=40, text_vocab_size=128,
        depth_decoder_config=CFG["depth_decoder_config"],
        codec_config={"model_type": "mimi", "hidden_size": 32,
                      "num_filters": 4, "upsampling_ratios": [4, 3],
                      "kernel_size": 7, "num_attention_heads": 4,
                      "num_hidden_layers": 2, "sliding_window": 16,
                      "intermediate_size": 64, "num_quantizers": 4,
                      "codebook_size": 40,
                      "vector_quantization_hidden_dimension": 16,
                      "frame_rate": 1000.0}, **bb)))
    loaded = load_model(tmp_path, device="cpu")
    assert type(loaded) is Model and loaded._mimi is not None
    loaded.tokenizer = FakeTok()
    (a,) = _gen(loaded, text_ids=np.arange(5, 15))
    (b,) = _gen(pm, text_ids=np.arange(5, 15))
    np.testing.assert_array_equal(a.prompt["codes"], b.prompt["codes"])
    np.testing.assert_allclose(a.audio, b.audio, atol=1e-6)


def test_default_device_is_the_card():
    from mlx_audio_tpu_torch.tts.models.sesame import Model

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(dict(CFG))


# ---------------------------------------------------------------------------
# departures
# ---------------------------------------------------------------------------


def test_prompt_too_long_raises_for_text_ids(pair):
    """The cache check applies to text_ids too (JAX's text_ids path skips it
    and writes past its 2,048-column cache)."""
    from mlx_audio_tpu_torch.tts.models.sesame.sesame import MAX_CACHE_LEN

    _, pm = pair
    with pytest.raises(ValueError, match="Inputs too long"):
        _gen(pm, text_ids=np.arange(MAX_CACHE_LEN - 10) % 100,
             max_audio_length_ms=1600)


def test_codes_past_the_codebooks_are_clamped():
    """An audio vocabulary wider than Mimi's codebooks (CSM: 2,051 against
    2,048): sampled codes past the codebooks decode as the last row, as
    JAX's gather clamps them; the audio equals JAX's."""
    from mlx_audio_tpu.tts.models.sesame import Model, ModelConfig

    cfg = dict(CFG, audio_vocab_size=44)
    params = numpy_params(Model(ModelConfig(**cfg)).init_params, 0)
    head = np.asarray(params["audio_head"]).copy()
    head[:, :, 40:] += 0.5                 # favour the codes past 39
    params["audio_head"] = jnp.asarray(head)
    jm = _jax(cfg, params=params)
    pm = _port(jm, cfg)
    (jr,) = _gen(jm, text_ids=np.arange(5, 15))
    (pr,) = _gen(pm, text_ids=np.arange(5, 15))
    np.testing.assert_array_equal(pr.prompt["codes"], jr.prompt["codes"])
    assert (pr.prompt["codes"] >= 40).any()
    np.testing.assert_allclose(pr.audio, np.asarray(jr.audio), atol=ATOL)
