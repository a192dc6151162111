"""MOSS-Transcribe-Diarize of the PyTorch port against the JAX package, on
the CPU: the cases of tests/test_moss_stt.py's TestDiarize (the encoder's
token count, time markers, `generate`, the stream's max_tokens, segment
parsing, a mismatched splice), each held to the JAX package's on one
weight set; the departures pinned (the shared stepper's kept tokens over
two decode chunks, the repetition penalty within a chunk, the stream's
`prompt_tokens`, the layouts read from shapes, the tokenizer hook that
raises); an MLX-packed q8 directory through both packages' loaders; and
the loaders on a tiny HF-named directory.

Config: tests/test_moss_stt.py's `diarize` (a 2-layer d32 Qwen3 LM of 4
heads and 2 KV heads of 8, 1,000 ids, tied; a 2-layer d32 Whisper encoder
of 80 mels; audio id 999, merge 4) and its `CharTok`, digit ids 20-29;
one parameter set drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`), the JAX encoder jitted as the JAX
package jits it. Audio rows at ATOL = 2e-4 (f32, summation order;
tests/test_torch_parity.py:19); greedy tokens, text and segments equal.
"""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402
from test_torch_prequantized import packed_leaf  # noqa: E402

ATOL = 2e-4
CFG = dict(text_config=dict(vocab_size=1000, hidden_size=32,
                            intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2,
                            head_dim=8),
           audio_config=dict(num_mel_bins=80, d_model=32, encoder_layers=2,
                             encoder_attention_heads=4, encoder_ffn_dim=64,
                             max_source_positions=1500),
           audio_token_id=999, audio_merge_size=4)
DIGITS = {d: 20 + int(d) for d in "0123456789"}
Q8_GROUP = 32


class CharTok:
    eos_token_id = 5

    def encode(self, s, **kwargs):
        return [10 + (ord(c) % 80) for c in s]

    def decode(self, ids, **kwargs):
        return "".join(chr(97 + i % 26) for i in ids)


@pytest.fixture(autouse=True)
def no_hf_tokenizer(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)


def with_tok(m):
    m._tokenizer = CharTok()
    m._digit_token_ids = dict(DIGITS)
    return m


@pytest.fixture(scope="module")
def pair():
    from mlx_audio_tpu.stt.models.moss_transcribe_diarize import \
        Model as JModel
    from mlx_audio_tpu.stt.models.moss_transcribe_diarize import \
        ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.moss_transcribe_diarize import (
        Model, ModelConfig)

    jm = JModel(JConfig.from_dict(CFG))
    jm.bind(numpy_params(jm.init_params, 0))
    pm = load_jax_params(Model(ModelConfig.from_dict(CFG), device="cpu"),
                         flat_numpy(jm.params))
    return with_tok(jm), with_tok(pm)


def audio(seed, n, scale=0.1):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


def test_encode_audio_matches_jax(pair):
    """35 s -> two 30-s chunks, 375 + 63 merged rows (a whole chunk's rows
    and a partial one's, cut and merged), and 2 s -> one chunk, 200
    encoder frames -> 25 rows (JAX's test): each within ATOL of JAX's."""
    jm, pm = pair
    for x, n, dur in ((audio(5, 560000), 438, 35.0),
                      (audio(6, 32000), 25, 2.0)):
        got, k, d = pm.encode_audio(x)
        want, kj, dj = jm.encode_audio(x)
        assert (k, d) == (kj, dj) == (n, dur)
        assert got.shape == want.shape == (n, 32)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_time_markers_and_prompt_are_jax_s(pair):
    """The audio spans with and without markers, and the ChatML prompt."""
    jm, pm = pair
    span = pm._audio_span_ids(100)
    assert [t for t in span if 20 <= t <= 29] == [25] and \
        span.count(999) == 100
    for n in (0, 7, 100, 313):
        assert pm._audio_span_ids(n) == jm._audio_span_ids(n)
        assert pm._build_prompt(n, "hi") == jm._build_prompt(n, "hi")
    pm.enable_time_marker = jm.enable_time_marker = False
    try:
        assert pm._audio_span_ids(100) == jm._audio_span_ids(100) == \
            [999] * 100
    finally:
        pm.enable_time_marker = jm.enable_time_marker = True


@pytest.mark.parametrize("kw", [dict(max_tokens=40),
                                dict(max_tokens=20, repetition_penalty=1.3)],
                         ids=["two-chunks", "penalty"])
def test_greedy_generate_equals_jax(pair, kw):
    """`generate` greedy over 40 tokens (two of JAX's 32-step chunks), and
    with a repetition penalty inside one chunk (where JAX's per-chunk
    history and the port's running one agree): text, segments and counts
    equal JAX's."""
    jm, pm = pair
    x = audio(1, 24000)
    got, want = pm.generate(x, **kw), jm.generate(x, **kw)
    assert got.text == want.text and got.text
    assert got.segments == want.segments
    assert (got.prompt_tokens, got.generation_tokens) == \
        (want.prompt_tokens, want.generation_tokens)


def test_stream_stops_at_max_tokens(pair):
    """The stream yields a result a token, then a final one, and stops at
    max_tokens: 4 (inside JAX's first 32-step chunk) and 40 (into its
    second). Each piece's text, is_final, times and count equal JAX's
    `_stream`; the text is the whole request's. A departure: each result
    carries the prompt's length, where JAX's leaves `prompt_tokens` 0."""
    jm, pm = pair
    x = audio(1, 24000)
    for n in (4, 40):
        got = list(pm.generate(x, max_tokens=n, stream=True))
        want = list(jm.generate(x, max_tokens=n, stream=True))
        assert [(r.text, r.is_final, r.start_time, r.end_time,
                 r.generation_tokens) for r in got] == \
            [(r.text, r.is_final, r.start_time, r.end_time,
              r.generation_tokens) for r in want]
        assert got[-1].is_final and len(got) == n + 1
        assert [r.generation_tokens for r in got] == \
            list(range(1, n + 1)) + [n]
        whole = pm.generate(x, max_tokens=n)
        assert "".join(r.text for r in got).strip() == whole.text
        assert {r.prompt_tokens for r in got} == {whole.prompt_tokens}
        assert {r.prompt_tokens for r in want} == {0}


def test_segment_parsing_is_jax_s(pair):
    jm, pm = pair
    for text in ("[0.0][S01] hello [2.5][2.5][S02] hi [4.0]",
                 "[3.0][S01] backwards [1.0] no tags", "plain text",
                 "[1][S03]  [2][2][S04] x [2.5]"):
        assert pm._parse_segments(text, 4.0) == \
            jm._parse_segments(text, 4.0)
    segs = pm._parse_segments("[0.0][S01] hello [2.5][2.5][S02] hi [4.0]",
                              4.0)
    assert [s["speaker_id"] for s in segs] == ["S01", "S02"]


def test_mismatched_audio_raises(pair):
    _, pm = pair
    with pytest.raises(ValueError, match="do not match"):
        pm._decode([999, 999], torch.zeros(1, 32), 4, (0.0, 0, 1.0, 0.0,
                                                       1.0, 20, 1))


def test_sanitize_reads_layouts_from_shapes(pair):
    """HF names (`vq_adwaptor.layers.0/2/3`, torch conv layouts, a tied
    `lm_head`) give JAX's arrays; the MLX conv layout the same."""
    jm, pm = pair
    rs = np.random.RandomState(3)
    w = {"model.vq_adwaptor.layers.0.weight": rs.randn(32, 128),
         "model.vq_adaptor.layers.2.bias": rs.randn(32),
         "model.vq_adaptor.layers.3.weight": rs.randn(32),
         "model.vq_adaptor.layers.1.weight": rs.randn(4),
         "model.whisper_encoder.conv1.weight": rs.randn(32, 80, 3),
         "model.whisper_encoder.conv2.weight": rs.randn(32, 32, 3),
         "lm_head.weight": rs.randn(1000, 32)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    got, want = pm.sanitize(w), jm.sanitize(w)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    mlx = {k: (np.transpose(v, (0, 2, 1)) if v.ndim == 3 else v)
           for k, v in w.items()}
    for k, v in pm.sanitize(mlx).items():
        np.testing.assert_array_equal(v, got[k])


def hf_state(pm):
    """The model under HF names, torch conv layouts."""
    state = {k: v.numpy() for k, v in pm.state_dict().items()}
    for i, name in ((0, "fc1"), (2, "fc2"), (3, "norm")):
        for leaf in ("weight", "bias"):
            state[f"model.vq_adaptor.layers.{i}.{leaf}"] = state.pop(
                f"model.vq_adaptor.{name}.{leaf}")
    return state


def write_dir(path, state, **extra):
    path.mkdir()
    np.savez(path / "model.npz", **state)
    (path / "config.json").write_text(json.dumps(dict(
        CFG, model_type="moss_transcribe_diarize", **extra)))


def test_q8_packed_directory_runs_every_lm_linear_quantized(pair, tmp_path):
    """An MLX-packed q8 directory (every 2-D `model.language_model` weight
    packed, the table too) through `stt.utils.load_model` and the JAX
    package's loader: 7 x 2 quantized LM linears (K2 on the card), the
    encoder and adaptor dense, the tied table an Embedding; the greedy
    text, segments and counts of `generate` equal to JAX's q8 model's."""
    from mlx_audio_tpu.stt.utils import load_model as jax_load
    from mlx_audio_tpu_torch.nn import Embedding, QuantizedLinear
    from mlx_audio_tpu_torch.stt.utils import load_model

    _, pm = pair
    ckpt = {}
    for k, v in hf_state(pm).items():
        if k.startswith("model.language_model") and v.ndim == 2:
            for part, arr in packed_leaf(v, 8, Q8_GROUP).items():
                ckpt[k[:-len("weight")] + part] = arr
        else:
            ckpt[k] = v
    d = tmp_path / "moss-transcribe-diarize-q8"
    write_dir(d, ckpt, quantization={"group_size": Q8_GROUP, "bits": 8})
    q8, jq = with_tok(load_model(d, device="cpu")), with_tok(jax_load(str(d)))
    held = [n for n, m in q8.named_modules()
            if isinstance(m, QuantizedLinear)]
    assert len(held) == 14 and all(n.startswith("model.language_model")
                                   for n in held)
    assert isinstance(q8.model.language_model.embed_tokens, Embedding)
    x = audio(6, 16000)
    got, want = q8.generate(x, max_tokens=8), jq.generate(x, max_tokens=8)
    assert got.text == want.text and got.generation_tokens == 8
    assert got.segments == want.segments
    assert got.prompt_tokens == want.prompt_tokens


def test_loaders_route_a_tiny_directory(pair, tmp_path):
    """An HF-named dense directory through `stt.utils.load_model` and the
    top-level router, with a processor_config.json: equal weights and
    greedy text; the marker settings read."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.stt.models.moss_transcribe_diarize import Model
    from mlx_audio_tpu_torch.stt.utils import load_model

    _, pm = pair
    d = tmp_path / "MOSS-Transcribe-Diarize-tiny"
    write_dir(d, hf_state(pm))
    (d / "processor_config.json").write_text(json.dumps(
        {"time_marker_every_seconds": 2, "enable_time_marker": False}))
    x = audio(7, 20000)
    want = pm.generate(x, max_tokens=6).text
    for loaded in (load_model(d, device="cpu"),
                   mlx_audio_tpu_torch.load_model(d, device="cpu")):
        assert isinstance(loaded, Model) and loaded._tokenizer is None
        assert loaded.time_marker_every_seconds == 2 and \
            not loaded.enable_time_marker
        for k, v in pm.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), k
        loaded = with_tok(loaded)
        loaded.enable_time_marker = True
        loaded.time_marker_every_seconds = 5
        assert loaded.generate(x, max_tokens=6).text == want


def test_tokenizer_hook_raises_on_files_that_fail(tmp_path, monkeypatch):
    """A departure: tokenizer files that fail to load raise (JAX's hook
    swallows the error and leaves None); without them there is none."""
    import types

    from mlx_audio_tpu_torch.stt.models.moss_transcribe_diarize import Model

    m = Model(CFG, device="cpu")
    assert Model.post_load_hook(m, tmp_path)._tokenizer is None

    def broken(path, **kw):
        raise OSError(f"cannot read the tokenizer in {path}")

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=broken)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    (tmp_path / "tokenizer.json").write_text("{broken")
    with pytest.raises(OSError, match="tokenizer"):
        Model.post_load_hook(m, tmp_path)
