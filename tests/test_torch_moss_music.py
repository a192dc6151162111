"""MOSS-Music of the PyTorch port against the JAX package, on the CPU: the
cases of tests/test_moss_stt.py's TestMusic (the downsampled length, the
encoder and its deepstack captures, `generate` with audio and text alone,
structured segments, `<think>` stripping, the registry), each held to the
JAX package's on one weight set; the departures pinned (the shared
stepper with its deepstack prefill hook, the conv2d layouts read from
shapes, the tokenizer hook that raises); the stream against JAX's; the
quantization predicate, and an MLX-packed q8 directory of the linears it
passes through both packages' loaders; and the loaders on a tiny
HF-named directory.

Config: tests/test_moss_stt.py's `music` (a 128-mel d32 encoder of 4
layers and 4 heads, stem width 8, n_window 50, captures after layers 1, 2
and 3, two injected; a 2-layer d32 Qwen3 LM of 4 heads and 2 KV heads of
8, 1,000 ids, untied; adapter width 48; audio ids 999/998/997, EOS 5) and
its `CharTok`, digit ids 20-29; one parameter set drawn with numpy over
JAX's shapes (`test_torch_mimi.numpy_params`), the JAX encoder jitted as
the JAX package jits it. Rows at ATOL = 2e-4 (f32, summation order;
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
CFG = dict(audio_config=dict(d_model=32, output_dim=32, num_mel_bins=128,
                             encoder_layers=4, encoder_attention_heads=4,
                             encoder_ffn_dim=64, downsample_hidden_size=8,
                             n_window=50,
                             deepstack_encoder_layer_indexes=[1, 2, 3]),
           language_config=dict(vocab_size=1000, hidden_size=32,
                                intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=4, num_key_value_heads=2,
                                head_dim=8, tie_word_embeddings=False),
           adapter_hidden_size=48, deepstack_num_inject_layers=2,
           audio_token_id=999, audio_start_id=998, audio_end_id=997,
           eos_token_id=5)
DIGITS = {d: 20 + int(d) for d in "0123456789"}
Q8_GROUP = 16  # divides the adapter's 48


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


def make_pair(cfg):
    from mlx_audio_tpu.stt.models.moss_music import Model as JModel
    from mlx_audio_tpu.stt.models.moss_music import ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.moss_music import Model, ModelConfig

    jm = JModel(JConfig.from_dict(cfg))
    jm.bind(numpy_params(jm.init_params, 0))
    pm = load_jax_params(Model(ModelConfig.from_dict(cfg), device="cpu"),
                         flat_numpy(jm.params))
    return with_tok(jm), with_tok(pm)


@pytest.fixture(scope="module")
def pair():
    return make_pair(CFG)


def audio(seed, n, scale=0.1):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


def test_helpers_are_jax_s():
    from mlx_audio_tpu.stt.models.moss_music import moss_music as J
    from mlx_audio_tpu_torch.stt.models.moss_music import moss_music as P

    assert P.conv3_downsample_len(400) == 50
    assert P.conv3_downsample_len(1) == 1
    assert [P.conv3_downsample_len(n) for n in range(1, 500)] == \
        [J.conv3_downsample_len(n) for n in range(1, 500)]
    np.testing.assert_array_equal(P.sinusoids(30, 16), J.sinusoids(30, 16))


@pytest.mark.parametrize("out_dim", [32, 16])
def test_encode_audio_and_deepstack_match_jax(pair, out_dim):
    """3 s -> 300 mel frames -> three 100-frame chunks of 13 rows: the
    adapted rows and the two merged captures (capped by the injected
    layers) within ATOL of JAX's; with an `out_proj` (output 16) too."""
    jm, pm = pair if out_dim == 32 else make_pair(dict(
        CFG, audio_config=dict(CFG["audio_config"], output_dim=out_dim)))
    x = audio(0, 48000)
    got, ds, n, dur = pm.encode_audio(x)
    want, jds, jn, jdur = jm.encode_audio(x)
    assert (n, dur) == (jn, jdur) == (39, 3.0) and len(ds) == len(jds) == 2
    assert hasattr(pm.audio_encoder, "out_proj") == (out_dim != 32)
    for g, w in zip([got] + ds, [want] + jds):
        assert g.shape == w.shape == (39, 32)
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


@pytest.mark.parametrize("kw", [dict(max_tokens=40),
                                dict(max_tokens=6, prompt="describe",
                                     enable_time_marker=False)],
                         ids=["two-chunks", "no-markers"])
def test_greedy_generate_with_audio_equals_jax(pair, kw):
    """`generate` greedy with audio (the deepstack rows added at the
    prefill): over 40 tokens (two of JAX's 32-step chunks), and without
    time markers: text, segments and counts equal JAX's."""
    jm, pm = pair
    x = audio(0, 48000)
    got, want = pm.generate(x, **kw), jm.generate(x, **kw)
    assert got.text == want.text and got.text
    assert got.segments == want.segments
    assert (got.prompt_tokens, got.generation_tokens) == \
        (want.prompt_tokens, want.generation_tokens)


def test_deepstack_reaches_the_prefill_only(pair):
    """The deepstack features move the first logits (a prefill without
    them differs), and the decode steps add nothing: the prefill hook
    sees offset 0 once."""
    from mlx_audio_tpu_torch.stt.models.qwen3_lm import qwen3_decode_fns
    from mlx_audio_tpu_torch.tts.models.moss_tts import moss_tts

    _, pm = pair
    ids, feats, ds, _ = pm._prepare(audio(2, 16000), None, None)
    embeds, full = pm.prompt_embeds(ids, feats, ds)
    greedy = (0.0, 0, 1.0, 0.0, 1.0, 20, 1)
    calls = []
    orig = moss_tts.qwen3_lm_forward

    def spy(lm, e, c, o, m=None, deepstack=None):
        calls.append((o, deepstack is not None))
        return orig(lm, e, c, o, m, deepstack=deepstack)

    moss_tts.qwen3_lm_forward = spy
    try:
        with_ds = qwen3_decode_fns(pm.language_model, pm.config
                                   .language_config, pm.lm_head, len(ids),
                                   4, greedy, (5,), deepstack=full)
        state = with_ds.start(embeds, len(ids), 4)
        with_ds.chunk(state)
        bare = qwen3_decode_fns(pm.language_model, pm.config.language_config,
                                pm.lm_head, len(ids), 4, greedy, (5,))
        plain = bare.prefill(embeds, len(ids))[0]
    finally:
        moss_tts.qwen3_lm_forward = orig
    assert calls[0] == (0, True) and all(not d for _, d in calls[1:4])
    assert len(calls) == 5
    lg = with_ds.prefill(embeds, len(ids))[0]
    assert float((lg - plain).abs().max()) > 1e-3


def test_text_only_generate_and_stream_equal_jax(pair):
    """Text alone (no audio rows, no deepstack) as JAX's, and the stream
    over 3 s of audio: a result a token, then a final one, stopped at
    max_tokens; each piece's text, is_final, times and counts equal JAX's
    `_stream`; the text is the whole request's."""
    jm, pm = pair
    kw = dict(prompt="describe", max_tokens=4)
    got, want = pm.generate(None, **kw), jm.generate(None, **kw)
    assert got.text == want.text and got.generation_tokens <= 4
    x = audio(0, 48000)
    res = list(pm.generate(x, max_tokens=5, stream=True))
    jres = list(jm.generate(x, max_tokens=5, stream=True))
    key = lambda r: (r.text, r.is_final, r.start_time, r.end_time,
                     r.prompt_tokens, r.generation_tokens)
    assert [key(r) for r in res] == [key(r) for r in jres]
    assert res[-1].is_final and len(res) == 6
    assert [r.generation_tokens for r in res] == [1, 2, 3, 4, 5, 5]
    assert "".join(r.text for r in res) == pm.generate(
        x, max_tokens=5, strip_thinking=False).text


@pytest.mark.parametrize("text", [
    "[0:05 - 0:12] guitar intro\n[0:12] drums enter",
    "0:01 - 0:04: verse\n0:04: chorus", "(12.5s) solo (1:02:03) outro",
    "no markers at all", "[00:10-00:05] backwards", "【3】 bracket"])
def test_structured_segments_are_jax_s(pair, text):
    jm, pm = pair
    for dur in (20.0, None):
        assert pm.parse_structured_segments(text, audio_duration=dur,
                                            total_time=1.5) == \
            jm.parse_structured_segments(text, audio_duration=dur,
                                         total_time=1.5)
    for t in ("<think>reasoning</think>final", "<think>open", "plain"):
        assert pm._strip_thinking(t) == jm._strip_thinking(t)


def hf_state(pm):
    """HF names: the encoder's attention projections beside the layer's
    other leaves, torch conv layouts, the positions' timescales."""
    import re

    state = {}
    for k, v in pm.state_dict().items():
        k = re.sub(r"(audio_encoder\.layers\.\d+)\.self_attn\.", r"\1.", k)
        state[k] = v.numpy()
    state["audio_encoder.embed_positions.inv_timescales"] = np.ones(
        16, np.float32)
    return state


def write_dir(path, state, **extra):
    path.mkdir()
    np.savez(path / "model.npz", **state)
    (path / "config.json").write_text(json.dumps(dict(
        CFG, model_type="moss_music", **extra)))


def test_sanitize_reads_layouts_from_shapes(pair):
    """HF names and torch layouts give JAX's arrays, but for the 3x3
    convs between stem channels: JAX's guess from the axes' sizes leaves
    a torch (8, 8, 3, 3) weight as it is (a JAX fault: the published
    480-wide stem's too), where the port reads it as torch's and gives
    HWIO. MLX layouts give the port's same arrays."""
    jm, pm = pair
    w = hf_state(pm)
    got, want = pm.sanitize(w), jm.sanitize(w)
    assert sorted(got) == sorted(want)
    for k in got:
        if k in ("audio_encoder.conv2.weight", "audio_encoder.conv3.weight"):
            np.testing.assert_array_equal(np.asarray(want[k]), w[k])
            np.testing.assert_array_equal(got[k],
                                          np.transpose(w[k], (2, 3, 1, 0)))
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    mlx = {k: (np.transpose(v, (0, 2, 3, 1)) if v.ndim == 4 else v)
           for k, v in w.items()}
    for k, v in pm.sanitize(mlx).items():
        np.testing.assert_array_equal(v, got[k])


def test_quant_predicate_is_jax_s(pair):
    """`model_quant_predicate` passes every linear but the encoder's, as
    JAX's: a dense model quantized by it holds 24 quantized linears (the
    LM's 7 x 2, the head, the adapter's and the mergers' 3 x 3)."""
    import copy

    from mlx_audio_tpu_torch.nn import Linear, QuantizedLinear
    from mlx_audio_tpu_torch.utils import apply_quantization

    jm, pm = pair
    names = [n for n, m in pm.named_modules() if isinstance(m, Linear)]
    assert [pm.model_quant_predicate(n, None) for n in names] == \
        [jm.model_quant_predicate(n, None) for n in names]
    q = apply_quantization(copy.deepcopy(pm), {"quantization": {
        "group_size": Q8_GROUP, "bits": 8}}, pm.model_quant_predicate)
    held = [n for n, m in q.named_modules() if isinstance(m, QuantizedLinear)]
    assert len(held) == 24 and not any(n.startswith("audio_encoder")
                                       for n in held)


def test_q8_packed_directory_runs_every_lm_linear_quantized(pair, tmp_path):
    """An MLX-packed q8 directory (every linear that
    `model_quant_predicate` passes packed: the LM's, the head's, the
    adapter's and the mergers'; the 3x3 stem convs in HWIO, the layout
    JAX's sanitize leaves alone) through `stt.utils.load_model` and the
    JAX package's loader: 24 quantized linears (K2 on the card), the
    encoder dense, the table an Embedding; `generate`'s greedy text,
    segments and counts equal to JAX's q8 model's."""
    from mlx_audio_tpu.stt.utils import load_model as jax_load
    from mlx_audio_tpu_torch.nn import Embedding, Linear, QuantizedLinear
    from mlx_audio_tpu_torch.stt.utils import load_model

    _, pm = pair
    packed = {f"{n}.weight" for n, m in pm.named_modules()
              if isinstance(m, Linear) and pm.model_quant_predicate(n, None)}
    ckpt = {}
    for k, v in pm.state_dict().items():
        v = v.numpy()
        if k in ("audio_encoder.conv2.weight", "audio_encoder.conv3.weight"):
            ckpt[k] = np.transpose(v, (2, 3, 1, 0))  # HWIO, which JAX reads
        elif k in packed:
            for part, arr in packed_leaf(v, 8, Q8_GROUP).items():
                ckpt[k[:-len("weight")] + part] = arr
        else:
            ckpt[k] = v
    d = tmp_path / "MOSS-Music-tiny-q8"
    write_dir(d, ckpt, quantization={"group_size": Q8_GROUP, "bits": 8})
    q8, jq = with_tok(load_model(d, device="cpu")), with_tok(
        jax_load(str(d)))
    held = [n for n, m in q8.named_modules()
            if isinstance(m, QuantizedLinear)]
    assert len(packed) == len(held) == 24
    assert {f"{n}.weight" for n in held} == packed
    assert sum(n.startswith("language_model") for n in held) == 14
    assert isinstance(q8.language_model.embed_tokens, Embedding)
    x = audio(6, 16000)
    got, want = q8.generate(x, max_tokens=8), jq.generate(x, max_tokens=8)
    assert got.text == want.text and got.generation_tokens == 8
    assert got.segments == want.segments
    assert got.prompt_tokens == want.prompt_tokens


def test_loaders_route_a_tiny_directory(pair, tmp_path):
    """An HF-named dense directory through `stt.utils.load_model` and the
    top-level router: equal weights and greedy text; the registry."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.stt.models.moss_music import Model
    from mlx_audio_tpu_torch.stt.utils import MODEL_REMAPPING, load_model

    _, pm = pair
    assert MODEL_REMAPPING["moss_music"] == "moss_music"
    d = tmp_path / "MOSS-Music-tiny"
    write_dir(d, hf_state(pm))
    x = audio(7, 20000)
    want = pm.generate(x, max_tokens=6).text
    for loaded in (load_model(d, device="cpu"),
                   mlx_audio_tpu_torch.load_model(d, device="cpu")):
        assert isinstance(loaded, Model) and loaded._tokenizer is None
        for k, v in pm.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), k
        assert with_tok(loaded).generate(x, max_tokens=6).text == want


def test_tokenizer_hook_raises_on_files_that_fail(tmp_path, monkeypatch):
    """A departure: tokenizer files that fail to load raise (JAX's hook
    swallows the error and leaves None); without them there is none."""
    import types

    from mlx_audio_tpu_torch.stt.models.moss_music import Model

    m = Model(CFG, device="cpu")
    assert Model.post_load_hook(m, tmp_path)._tokenizer is None
    seen = []

    def broken(path, **kw):
        seen.append(kw)
        raise OSError(f"cannot read the tokenizer in {path}")

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=broken)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    (tmp_path / "tokenizer.json").write_text("{broken")
    with pytest.raises(OSError, match="tokenizer"):
        Model.post_load_hook(m, tmp_path)
    assert seen == [{"use_fast": False}]
