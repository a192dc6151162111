"""VyvoTTS (the Qwen3 token-TTS over SNAC) of the PyTorch port against the
JAX package, on the CPU: the SNAC interleave, `parse_output`, the prompts
and the zeroprompt, greedy `generate` whole, streamed and by segments
(tokens and audio), `sanitize`; then the port's rules (a seeded sampled
run, a codec is needed, a strict `post_load_hook`) and the loader.

Config: tests/test_bailingmm_qwen3.py's TestVyvo model (a 2-layer Qwen3
LM at d32, tied) with the vocabulary widened to hold every SNAC code id
(180,352), the code and START_OF_SPEECH rows of the table scaled 4x so
that random weights draw codes; tests/test_torch_snac.py's tiny SNAC pair
(the port's fed JAX's noise); one parameter tree drawn with numpy over
JAX's shapes. Random weights draw codes outside their slot's codebook,
which JAX's SNAC gathers as NaN and the port clamps: the JAX side's codes
are clamped the same way before its SNAC (`clamped`). Audio at ATOL =
2e-4 (f32, summation order); tokens equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402

from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402
from test_torch_prequantized import no_hf_tokenizer  # noqa: E402,F401
from test_torch_snac import make_pair as snac_pair  # noqa: E402

ATOL = 2e-4
VOCAB = 151679 + 7 * 4096
CFG = dict(vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, head_dim=8, tie_word_embeddings=True)
CODE_SCALE = 4.0
KW = dict(voice="zoe", temperature=0.0, max_tokens=40)
# two whole frames and a part: the segments and the loader's run
SHORT = dict(KW, max_tokens=16)


class CharTok:
    """tests/test_bailingmm_qwen3.py::CharTok."""

    def encode(self, s, **kwargs):
        return [10 + (ord(c) % 200) for c in s]


@pytest.fixture(scope="module")
def models():
    """(JAX VyvoTTS, port VyvoTTS) on one weight set, the code rows
    scaled, each with CharTok and the tiny SNAC pair bound."""
    from mlx_audio_tpu.tts.models.qwen3 import Model as JModel
    from mlx_audio_tpu.tts.models.qwen3 import ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.tts.models.qwen3 import Model, ModelConfig
    from mlx_audio_tpu_torch.tts.models.qwen3 import qwen3 as pq

    jm = JModel(JConfig.from_dict(CFG))
    flat = flat_numpy(numpy_params(jm.init_params, 0))
    table = flat["model.embed_tokens.weight"] = np.array(
        flat["model.embed_tokens.weight"])
    table[pq.AUDIO_TOKENS_START:] *= CODE_SCALE
    table[pq.START_OF_SPEECH] *= CODE_SCALE
    from mlx_audio_tpu.utils import unflatten

    jm.bind(unflatten(flat))
    pm = load_jax_params(Model(ModelConfig.from_dict(CFG), device="cpu"),
                         flat)
    js, ps = snac_pair(noise=True, seed=1)
    # one XLA program per shape, not one per op (eager JAX on this CPU)
    js.decode, js.encode = jax.jit(js.decode), jax.jit(js.encode)
    jm.tokenizer = pm.tokenizer = CharTok()
    jm.snac = js
    pm.set_codec(ps)
    jm._decode_snac = clamped(jm)
    return jm, pm


def clamped(jm):
    """JAX's `_decode_snac` on the codes clamped into the codebook, as the
    port clamps them (JAX's SNAC gathers an out-of-range code as NaN)."""
    from mlx_audio_tpu.tts.models.qwen3 import qwen3 as jq

    decode = jm._decode_snac

    def run(code_list):
        layers = [[min(max(c, 0), 4095) for c in x]
                  for x in jq.deinterleave_snac_codes(code_list)]
        return decode(jq.interleave_snac_codes(*layers))

    return run


# ---------------------------------------------------------------------------
# codes and prompts
# ---------------------------------------------------------------------------


def test_codes_and_constants_equal_jax():
    """VyvoTTS's interleave and deinterleave are the shared SNAC code
    helpers (`codec/models/snac/codes.py`)."""
    from mlx_audio_tpu.tts.models.qwen3 import qwen3 as jq
    from mlx_audio_tpu_torch.codec.models.snac.codes import (
        flat_codes_to_layers, layers_to_flat_codes)
    from mlx_audio_tpu_torch.tts.models.qwen3 import qwen3 as pq

    rs = np.random.RandomState(0)
    l1, l2, l3 = (rs.randint(0, 4096, n).tolist() for n in (3, 6, 12))
    flat = layers_to_flat_codes([l1, l2, l3]).tolist()
    assert flat == jq.interleave_snac_codes(l1, l2, l3)
    layers = tuple(x[0].tolist() for x in flat_codes_to_layers(flat))
    assert layers == (l1, l2, l3)
    assert layers == jq.deinterleave_snac_codes(flat)
    codes = [pq.AUDIO_TOKENS_START + i for i in range(15)]
    for ids in ([5, pq.START_OF_SPEECH] + codes + [pq.END_OF_SPEECH],
                codes[:9], [pq.START_OF_SPEECH] * 2 + codes, []):
        assert pq.parse_output(ids) == jq.parse_output(ids)
    assert (pq.START_OF_SPEECH, pq.END_OF_SPEECH, pq.START_OF_HUMAN,
            pq.END_OF_HUMAN, pq.START_OF_AI, pq.END_OF_AI, pq.PAD_TOKEN,
            pq.AUDIO_TOKENS_START, pq.END_OF_TEXT) == (
        jq.START_OF_SPEECH, jq.END_OF_SPEECH, jq.START_OF_HUMAN,
        jq.END_OF_HUMAN, jq.START_OF_AI, jq.END_OF_AI, jq.PAD_TOKEN,
        jq.AUDIO_TOKENS_START, jq.END_OF_TEXT)


def test_prompts_equal_jax(models):
    jm, pm = models
    for voice in (None, "zoe"):
        assert pm.prepare_input_ids("hi there", voice) == \
            jm.prepare_input_ids("hi there", voice)
    ref = (np.random.RandomState(0).randn(16 * 28) * 0.1).astype(np.float32)
    zp = pm.prepare_zeroprompt(ref, "ref")
    assert zp == jm.prepare_zeroprompt(ref, "ref")
    assert pm.prepare_input_ids("hi", "zoe", zp)[:len(zp)] == zp


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------


def _audio(results):
    return [np.asarray(r.audio) for r in results]


@pytest.fixture(scope="module")
def jax_results(models):
    jm, _ = models
    return {"whole": list(jm.generate("hello world", **KW)),
            "stream": list(jm.generate("hello world", stream=True,
                                       streaming_interval=0.1, **KW)),
            "segments": list(jm.generate("hello\nworld again", **SHORT))}


def test_greedy_generate_equals_jax(models, jax_results):
    _, pm = models
    got = list(pm.generate("hello world", **KW))
    want = jax_results["whole"]
    assert len(got) == len(want) == 1
    assert got[0].token_count == want[0].token_count
    assert pm.last_run["tokens"] == got[0].token_count
    assert got[0].samples == want[0].samples > 0 and got[0].is_final_chunk
    np.testing.assert_allclose(got[0].audio, _audio(want)[0], atol=ATOL)


def test_streamed_generate_equals_jax(models, jax_results):
    """Every 13 tokens the new samples of the decode so far, then the
    rest: the same chunks as JAX's, yielded as their decode chunk is
    read."""
    _, pm = models
    got = list(pm.generate("hello world", stream=True,
                           streaming_interval=0.1, **KW))
    want = jax_results["stream"]
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert (g.token_count, g.samples, g.is_streaming_chunk,
                g.is_final_chunk) == (w.token_count, w.samples,
                                      w.is_streaming_chunk, w.is_final_chunk)
        np.testing.assert_allclose(g.audio, np.asarray(w.audio), atol=ATOL)


def test_segments_equal_jax(models, jax_results):
    _, pm = models
    got = list(pm.generate("hello\nworld again", **SHORT))
    want = jax_results["segments"]
    assert [r.segment_idx for r in got] == [r.segment_idx for r in want] \
        == [0, 1]
    for g, w in zip(got, want):
        assert g.token_count == w.token_count
        np.testing.assert_allclose(g.audio, np.asarray(w.audio), atol=ATOL)


def test_sampled_run_is_seeded(models):
    _, pm = models
    kw = dict(voice="zoe", max_tokens=16, temperature=0.9, top_p=1.0)
    a = list(pm.generate("hello", seed=2, **kw))
    b = list(pm.generate("hello", seed=2, **kw))
    assert [r.token_count for r in a] == [r.token_count for r in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.audio, y.audio)


def test_generate_needs_a_codec_and_a_tokenizer():
    from mlx_audio_tpu_torch.tts.models.qwen3 import Model, ModelConfig

    m = Model(ModelConfig.from_dict(dict(CFG, vocab_size=300)),
              device="cpu").init_params(0)
    with pytest.raises(RuntimeError, match="tokenizer"):
        next(m.generate("hi"))
    m.tokenizer = CharTok()
    with pytest.raises(RuntimeError, match="SNAC"):
        next(m.generate("hi"))


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def test_sanitize_equals_jax(models):
    jm, pm = models
    rs = np.random.RandomState(1)
    raw = {"model.layers.0.self_attn.q_proj.weight":
               rs.randn(32, 32).astype(np.float32),
           "model.layers.0.self_attn.rotary_emb.inv_freq": np.ones(4, "f"),
           "lm_head.weight": rs.randn(8, 32).astype(np.float32)}
    got, want = pm.sanitize(dict(raw)), jm.sanitize(dict(raw))
    assert set(got) == set(want) == {
        "model.layers.0.self_attn.q_proj.weight"}


def test_load_model_binds_the_snac_and_generates(models, tmp_path):
    """The `load_model` router on a VyvoTTS directory: the model, the SNAC
    of its snac/ subfolder; the same greedy tokens and audio (the codec's
    noise fed the same draws). A codec that fails to load raises."""
    from chip_smoke import write_vyvo_checkpoint
    from mlx_audio_tpu_torch.tts.models.qwen3 import Model
    from mlx_audio_tpu_torch.utils import load_model

    _, pm = models
    d = tmp_path / "vyvotts"
    write_vyvo_checkpoint(pm, d)
    m = load_model(d, device="cpu")
    assert isinstance(m, Model) and m.codec is not None
    assert m.tokenizer is None
    m.tokenizer = CharTok()
    m.codec._noise = pm.codec._noise
    (got,) = list(m.generate("hello world", **SHORT))
    (want,) = list(pm.generate("hello world", **SHORT))
    assert got.token_count == want.token_count
    np.testing.assert_allclose(got.audio, want.audio, atol=ATOL)
    (d / "snac" / "config.json").write_text("{}")
    with pytest.raises(Exception):
        load_model(d, device="cpu")
