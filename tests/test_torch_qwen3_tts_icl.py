"""Qwen3-TTS voice cloning in the PyTorch port against the JAX package, on
the CPU at float32: the ECAPA speaker encoder and its `speaker_mel`, the
Mimi reference encoder (`encode_ref_audio`), the ICL prompt, greedy ICL
audio whole and streamed, the x-vector path, `sanitize`'s encoder and
speaker branches, and the two departures from the JAX package. Mirrors the
cloning cases of tests/test_qwen3_tts_icl.py on its configs
(TINY_ENCODER_CFG, TINY_SPK_CFG, FakeTokenizer), the tts special ids moved
inside the tiny text vocabulary as in tests/test_torch_qwen3_tts.py.

One weight set, drawn with numpy over JAX's parameter shapes
(test_torch_mimi.numpy_params), reaches the port through
`load_jax_params`. Tolerances: f32 tensors 2e-4 absolute; `speaker_mel`
1e-5; audio 1e-4 relative to its largest value. Codes and greedy frames
are equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_qwen3_tts_icl import (TINY_ENCODER_CFG,  # noqa: E402
                                FakeTokenizer, tiny_cfg)
from test_torch_mimi import flat_numpy, jit_mimi, numpy_params  # noqa: E402

ATOL = 2e-4
AUDIO_REL = 1e-4
MEL_ATOL = 1e-5
TTS_IDS = dict(tts_bos_token_id=497, tts_eos_token_id=498,
               tts_pad_token_id=499)
# a reference of 84 frames (the tiny encoder runs at 1 kHz, 24 samples a
# frame) and 8 generated frames: JAX's float cut keeps one reference sample
# there (int(84 / 92 * 4416) = 4031, not 84 x 48 = 4032)
REF_FRAMES, GEN_FRAMES = 84, 8
REF = (np.random.RandomState(1).randn(REF_FRAMES * 24) * 0.5).astype(
    np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def _np(t):
    return t.detach().float().cpu().numpy()


def _jax_params(jm):
    from mlx_audio_tpu.codec.models.mimi.mimi import Mimi as JMimi
    from mlx_audio_tpu.tts.models.qwen3_tts.speaker_encoder import \
        init_speaker_encoder
    from mlx_audio_tpu.tts.models.qwen3_tts.speech_tokenizer import \
        encoder_mimi_config

    p = numpy_params(jm.init_params, 0)
    p["speech_tokenizer"]["encoder"] = numpy_params(
        JMimi(encoder_mimi_config(TINY_ENCODER_CFG)).init_params, 1)
    p["speaker_encoder"] = numpy_params(
        lambda k: init_speaker_encoder(k, jm.config.speaker_encoder_config),
        2)
    return p


def _port(jm, params, ref_encoder=True, speaker_encoder=True):
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import (Model, ModelConfig,
                                                          load_jax_params)

    pm = Model(ModelConfig.from_dict(dataclasses.asdict(jm.config)),
               device="cpu")
    if ref_encoder:
        pm.attach_ref_encoder()
    if speaker_encoder:
        pm.attach_speaker_encoder()
    names = set(pm.state_dict())
    # the port's reference encoder has no decode path: JAX's Mimi tree
    # does, and its decode weights stay behind
    flat = {k: v for k, v in flat_numpy(params).items()
            if k in names or not k.startswith(("speech_tokenizer.encoder.",
                                               "speaker_encoder."))}
    load_jax_params(pm, flat)
    pm.tokenizer = FakeTokenizer()
    return pm


@pytest.fixture(scope="module")
def models():
    """(JAX model, its params, port model) with both encoders attached."""
    from mlx_audio_tpu.codec.models.mimi.mimi import Mimi as JMimi
    from mlx_audio_tpu.tts.models.qwen3_tts import Model as JM
    from mlx_audio_tpu.tts.models.qwen3_tts.speech_tokenizer import \
        encoder_mimi_config

    jm = JM(tiny_cfg(**TTS_IDS))
    params = _jax_params(jm)
    jm.bind(params)
    jm.tokenizer = FakeTokenizer()
    enc = JMimi(encoder_mimi_config(TINY_ENCODER_CFG))
    enc.bind(params["speech_tokenizer"]["encoder"])
    jm._jit_cache["ref_encoder"] = jit_mimi(enc)
    return jm, params, _port(jm, params)


@pytest.fixture(scope="module")
def icl_whole(models):
    """JAX's and the port's greedy ICL request of GEN_FRAMES frames on REF
    (one run each, shared by the tests below)."""
    jm, _, pm = models
    kw = dict(ref_audio=REF, ref_text="reference words", temperature=0.0,
              max_tokens=GEN_FRAMES)
    (jr,) = list(jm.generate("hi there", **kw))
    (pr,) = list(pm.generate("hi there", **kw))
    return np.asarray(jr.audio), pr.audio, dict(pm.last_run)


# ---------------------------------------------------------------------------
# the speaker encoder (TestSpeakerEncoder)
# ---------------------------------------------------------------------------


def test_speaker_mel_matches_jax():
    from mlx_audio_tpu.tts.models.qwen3_tts.speaker_encoder import \
        speaker_mel as jmel
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.speaker_encoder import \
        speaker_mel

    audio = (np.random.RandomState(1).randn(24000) * 0.3).astype(np.float32)
    want = np.asarray(jmel(audio))
    got = _np(speaker_mel(audio))
    assert got.shape == want.shape and got.shape[0] == 1 and \
        got.shape[2] == 128
    np.testing.assert_allclose(got, want, atol=MEL_ATOL)


def test_speaker_encoder_forward_matches_jax(models):
    from mlx_audio_tpu.tts.models.qwen3_tts.speaker_encoder import \
        speaker_encoder_forward

    jm, params, pm = models
    cfg = jm.config.speaker_encoder_config
    mels = np.random.RandomState(0).randn(2, 50, cfg.mel_dim).astype(
        np.float32)
    want = np.asarray(speaker_encoder_forward(params["speaker_encoder"], cfg,
                                              jnp.asarray(mels)))
    got = _np(pm.speaker_encoder(torch.from_numpy(mels)))
    assert got.shape == (2, cfg.enc_dim) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_extract_speaker_embedding_matches_jax(models):
    jm, _, pm = models
    audio = np.random.RandomState(2).randn(4800).astype(np.float32)
    want = np.asarray(jm.extract_speaker_embedding(audio))
    got = _np(pm.extract_speaker_embedding(audio))
    assert got.shape == (1, pm.config.speaker_encoder_config.enc_dim)
    np.testing.assert_allclose(got, want, atol=ATOL)


# ---------------------------------------------------------------------------
# the reference encoder (TestRefEncoder)
# ---------------------------------------------------------------------------


def test_encode_ref_audio_codes_equal_jax(models):
    jm, _, pm = models
    audio = np.random.RandomState(0).randn(24 * 100).astype(np.float32)
    want = np.asarray(jm.encode_ref_audio(audio))
    got = pm.encode_ref_audio(audio)
    assert got.shape == (1, 4, 100) and got.dtype == torch.int64
    assert (got >= 0).all() and (got < 64).all()
    np.testing.assert_array_equal(got.numpy(), want)


def test_reference_encoders_stay_f32(models):
    """astype leaves the reference encoder and the ECAPA in f32."""
    import copy

    _, _, pm = models
    m = copy.deepcopy(pm).astype(torch.bfloat16)
    assert m.talker.model.codec_embedding.weight.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in
               m.speech_tokenizer.encoder.parameters())
    assert all(p.dtype == torch.float32 for p in
               m.speaker_encoder.parameters())


# ---------------------------------------------------------------------------
# the ICL prompt and generation (TestICL)
# ---------------------------------------------------------------------------


def test_prepare_icl_inputs_layout_and_values(models):
    """The layout (role, prefix with the x-vector, text + EOS, BOS and the
    reference frames) and the embeddings, equal to JAX's."""
    jm, _, pm = models
    ref = np.random.RandomState(0).randn(2400).astype(np.float32)
    je, jt, jp, jc = jm.prepare_icl_inputs("hello world", ref,
                                           "reference words")
    embeds, trailing, pad, ref_codes = pm.prepare_icl_inputs(
        "hello world", ref, "reference words")
    d = pm.tcfg.hidden_size
    assert embeds.ndim == 3 and embeds.shape[2] == d
    assert trailing.shape == (1, 1, d) and torch.equal(trailing, pad)
    ref_len = ref_codes.shape[-1]
    # role 3 + prefix 5 (with the x-vector) + ref and target text ids
    # (FakeTokenizer: one a character) + EOS + BOS + the reference frames
    n_ref = len("<|im_start|>assistant\nreference words<|im_end|>\n") - 5
    n_text = len("<|im_start|>assistant\nhello world<|im_end|>\n"
                 "<|im_start|>assistant\n") - 8
    assert embeds.shape[1] == 3 + 5 + n_ref + n_text + 1 + 1 + ref_len
    np.testing.assert_array_equal(ref_codes.numpy(), np.asarray(jc))
    np.testing.assert_allclose(_np(embeds), np.asarray(je), atol=ATOL)
    np.testing.assert_allclose(_np(trailing), np.asarray(jt), atol=ATOL)


def test_generate_icl_whole_against_jax_and_the_trim(models, icl_whole):
    """Greedy ICL: [reference; generated] decoded and the reference cut.
    The port cuts exactly 84 x 48 samples; JAX's float cut keeps one
    reference sample at this (84, 8) pair: JAX's audio is the port's with
    that sample in front, the rest equal."""
    ja, pa, run = icl_whole
    up = 48
    assert run["ref_frames"] == REF_FRAMES and len(pa) == GEN_FRAMES * up
    total = (REF_FRAMES + GEN_FRAMES) * up
    assert int(REF_FRAMES / (REF_FRAMES + GEN_FRAMES) * total) == \
        REF_FRAMES * up - 1
    assert len(ja) == len(pa) + 1
    np.testing.assert_allclose(pa, ja[1:], atol=ATOL)
    assert _rel(pa, ja[1:]) < AUDIO_REL and np.isfinite(pa).all()


def test_generate_icl_codes_equal_jax(models, icl_whole):
    """The [reference; generated] codes the port hands its codec, decoded
    by JAX's own codec and cut JAX's way, give JAX's audio."""
    from mlx_audio_tpu.tts.models.qwen3_tts.speech_tokenizer import \
        decode_full

    jm, _, pm = models
    ja, _, _ = icl_whole
    seen = []
    hook = pm.speech_tokenizer.decoder.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].clone()))
    try:
        list(pm.generate("hi there", ref_audio=REF, ref_text="reference words",
                         temperature=0.0, max_tokens=GEN_FRAMES))
    finally:
        hook.remove()
    (codes,) = seen
    assert codes.shape == (1, 4, REF_FRAMES + GEN_FRAMES)
    decode = jax.jit(lambda p, c: decode_full(p, jm.dcfg, c))
    audio = np.asarray(decode(jm.params["speech_tokenizer"]["decoder"],
                              jnp.asarray(codes.numpy()))[0])
    cut = int(REF_FRAMES / codes.shape[-1] * len(audio))
    np.testing.assert_allclose(audio[cut:], ja, atol=1e-6)


def test_generate_icl_streamed_matches_jax(models):
    """The streamed ICL request decodes the generated codes only, as JAX's
    does: the same chunks' audio."""
    jm, _, pm = models
    kw = dict(ref_audio=REF, ref_text="reference words", temperature=0.0,
              max_tokens=GEN_FRAMES, stream=True, streaming_interval=0.4)
    jr = list(jm.generate("hi there", **kw))
    pr = list(pm.generate("hi there", **kw))
    assert pr[-1].is_final_chunk
    ja = np.concatenate([np.asarray(r.audio) for r in jr])
    pa = np.concatenate([r.audio for r in pr])
    assert len(pa) == len(ja) == GEN_FRAMES * 48
    np.testing.assert_allclose(pa, ja, atol=ATOL)
    assert _rel(pa, ja) < AUDIO_REL
    assert pm.last_run["ref_frames"] == REF_FRAMES


def test_icl_ref_cache_reused(models):
    """A second request on the same clip and ref_text reuses its entry."""
    _, _, pm = models
    ref = np.random.RandomState(3).randn(2400).astype(np.float32)

    def entries():
        return [k for k in pm._icl_cache if k[1] == "same ref"]

    pm.prepare_icl_inputs("one", ref, "same ref")
    n_before = len(entries())
    encode = pm.encode_ref_audio
    pm.encode_ref_audio = None          # a cache miss would call it
    try:
        pm.prepare_icl_inputs("two", ref, "same ref")
    finally:
        pm.encode_ref_audio = encode
    assert n_before == len(entries()) == 1


def test_icl_cache_key_does_not_collide(models):
    """Two clips of the same length and sum (±0.25 square waves of periods
    24 and 48: every partial sum is exact). JAX's key (ref_text, size,
    sum) hands the second the first's codes; the port's digest gives the
    second its own."""
    jm, _, pm = models
    n = 2400
    a = np.where(np.arange(n) % 24 < 12, 0.25, -0.25).astype(np.float32)
    b = np.where(np.arange(n) % 48 < 24, 0.25, -0.25).astype(np.float32)
    assert a.size == b.size and float(a.sum()) == float(b.sum())
    own_a, own_b = (pm.encode_ref_audio(x).numpy() for x in (a, b))
    assert not np.array_equal(own_a, own_b)
    *_, ja = jm.prepare_icl_inputs("text", a, "square")
    *_, jb = jm.prepare_icl_inputs("text", b, "square")
    np.testing.assert_array_equal(np.asarray(jb), own_a)   # JAX: a's codes
    *_, pa = pm.prepare_icl_inputs("text", a, "square")
    *_, pb = pm.prepare_icl_inputs("text", b, "square")
    np.testing.assert_array_equal(pa.numpy(), own_a)
    np.testing.assert_array_equal(pb.numpy(), own_b)


def test_ref_audio_without_ref_text_uses_the_xvector(models):
    """ref_audio alone: the x-vector in the speaker slot, the prompt cache
    bypassed; audio equal to JAX's."""
    jm, _, pm = models
    ref = np.random.RandomState(4).randn(2400).astype(np.float32)
    kw = dict(ref_audio=ref, temperature=0.0, max_tokens=GEN_FRAMES)
    (jr,) = list(jm.generate("hello", **kw))
    n_cached = len(pm._prompt_cache)
    (pr,) = list(pm.generate("hello", **kw))
    assert len(pm._prompt_cache) == n_cached
    assert pm.last_run["ref_frames"] == 0
    np.testing.assert_allclose(pr.audio, np.asarray(jr.audio), atol=ATOL)
    assert _rel(pr.audio, np.asarray(jr.audio)) < AUDIO_REL
    base, _, _ = pm.prepare_inputs(text="hello")
    xvec, _, _ = pm.prepare_inputs(text="hello", ref_audio=ref)
    assert xvec.shape[1] == base.shape[1] + 1


def test_ref_audio_without_speaker_encoder_raises(models):
    jm, params, _ = models
    pm = _port(jm, params, speaker_encoder=False)
    with pytest.raises(ValueError, match="speaker encoder"):
        list(pm.generate("hello", ref_audio=np.zeros(2400, np.float32),
                         max_tokens=4))
    pm = _port(jm, params, ref_encoder=False, speaker_encoder=False)
    with pytest.raises(ValueError, match="no speech-tokenizer encoder"):
        list(pm.generate("hello", ref_audio=np.zeros(2400, np.float32),
                         ref_text="words", max_tokens=4))


def test_split_pattern_forwards_the_reference(models):
    """Each segment of a split text clones the same reference."""
    _, _, pm = models
    out = list(pm.generate("one\ntwo", ref_audio=REF,
                           ref_text="reference words", temperature=0.0,
                           max_tokens=2))
    assert [r.segment_idx for r in out] == [0, 1]
    assert pm.last_run["ref_frames"] == REF_FRAMES


# ---------------------------------------------------------------------------
# checkpoints (TestEncoderSanitize)
# ---------------------------------------------------------------------------


HF_ENCODER_KEYS = {
    "encoder.encoder.layers.0.conv.weight": (4, 1, 3),
    "encoder.encoder.layers.0.conv.bias": (4,),
    "encoder.encoder.layers.1.block.1.conv.weight": (2, 4, 3),
    "encoder.encoder.layers.1.block.3.conv.weight": (4, 2, 1),
    "encoder.encoder.layers.3.conv.weight": (8, 4, 8),
    "encoder.encoder_transformer.layers.0.self_attn.q_proj.weight": (16, 16),
    "encoder.encoder_transformer.layers.0.self_attn.k_proj.weight": (16, 16),
    "encoder.encoder_transformer.layers.0.self_attn.v_proj.weight": (16, 16),
    "encoder.encoder_transformer.layers.0.self_attn.o_proj.weight": (16, 16),
    "encoder.encoder_transformer.layers.0.mlp.fc1.weight": (32, 16),
    "encoder.encoder_transformer.layers.0.input_layernorm.weight": (16,),
    "encoder.encoder_transformer.layers.0.self_attn_layer_scale.scale":
        (16,),
    "encoder.downsample.conv.weight": (16, 16, 4),
    "encoder.quantizer.semantic_residual_vector_quantizer."
    "input_proj.weight": (8, 16, 1),
    "encoder.quantizer.acoustic_residual_vector_quantizer.vq."
    "layers.0.codebook.cluster_usage": (64,),
    "encoder.quantizer.acoustic_residual_vector_quantizer.vq."
    "layers.0.codebook.embed_sum": (64, 8),
}


def test_hf_encoder_keys_map_to_mimi_tree(models):
    """Reference-named encoder checkpoint keys land on real leaves of the
    port's reference encoder, the names JAX's mapping gives."""
    from mlx_audio_tpu.tts.models.qwen3_tts import Model as JM

    _, _, pm = models
    hf = {k: np.ones(s, np.float32) for k, s in HF_ENCODER_KEYS.items()}
    out = pm._sanitize_ref_encoder(hf)
    assert out, "no keys mapped"
    valid = set(pm.state_dict())
    for k in out:
        assert k in valid, f"mapped key not in the encoder's tree: {k}"
    assert set(out) == set(JM._sanitize_ref_encoder(hf))
    # the same keys behind the loader's speech_tokenizer. prefix
    assert set(pm._sanitize_ref_encoder(
        {f"speech_tokenizer.{k}": v for k, v in hf.items()})) == set(out)


def hf_qwen3_encoder_state(pm) -> dict:
    """The port's reference encoder under the published HF names
    (`encoder.*`, the Mimi names of test_torch_mimi.hf_mimi_state behind
    `encoder.`; the codebooks under `vq.layers`)."""
    from test_torch_mimi import hf_mimi_state

    return {"encoder." + k.replace("_vector_quantizer.layers.",
                                   "_vector_quantizer.vq.layers."): v
            for k, v in hf_mimi_state(pm.speech_tokenizer.encoder).items()}


def write_cloning_checkpoint(pm, path) -> None:
    """A Qwen3-TTS checkpoint directory that clones: config.json (without
    the tokenizer's encoder_config), the talker, codec decoder and speaker
    encoder under the port's names (npz), and speech_tokenizer/ holding the
    reference encoder under HF names with its config.json's
    encoder_config."""
    import json

    state = {k: v.numpy() for k, v in pm.state_dict().items()
             if not k.startswith("speech_tokenizer.encoder.")}
    np.savez(path / "model.npz", **state)
    cfg = dataclasses.asdict(pm.config)
    enc_cfg = cfg["tokenizer_config"].pop("encoder_config")
    (path / "config.json").write_text(json.dumps(cfg))
    (path / "speech_tokenizer").mkdir()
    np.savez(path / "speech_tokenizer" / "model.npz",
             **hf_qwen3_encoder_state(pm))
    (path / "speech_tokenizer" / "config.json").write_text(
        json.dumps({"encoder_config": enc_cfg}))


def test_sanitize_and_load_a_cloning_checkpoint(models, tmp_path,
                                                 monkeypatch):
    """A checkpoint directory (`write_cloning_checkpoint`): `load_model`
    attaches both encoders (the reference encoder at the encoder_config of
    speech_tokenizer/config.json), and its ICL audio is the in-process
    model's."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import qwen3_tts
    from mlx_audio_tpu_torch.tts.utils import load_model

    _, _, pm = models
    write_cloning_checkpoint(pm, tmp_path)
    monkeypatch.setattr(qwen3_tts, "local_tokenizer",
                        lambda path: FakeTokenizer())
    loaded = load_model(tmp_path, device="cpu")
    assert loaded.has_ref_encoder and loaded.has_speaker_encoder
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, atol=1e-6,
                                   rtol=1e-6)
    kw = dict(ref_audio=REF, ref_text="reference words", temperature=0.0,
              max_tokens=3)
    (a,), (b,) = (list(m.generate("hi", **kw)) for m in (loaded, pm))
    np.testing.assert_allclose(a.audio, b.audio, atol=1e-6)
