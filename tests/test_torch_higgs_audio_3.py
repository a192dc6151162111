"""Higgs Audio v3 STT of the PyTorch port against the JAX package, on the
CPU: the cases of tests/test_higgs3_granite_nar.py's TestHiggs3Chunking
and TestHiggs3 (the splits, the features' downsampling, `generate`,
`parse_output`), each held to the JAX package's on one weight set; the
departures pinned (the VAD read only from a local Silero, raising without
one; the layouts read from shapes; the tokenizer hook that raises); an
MLX-packed q8 directory through both packages' loaders; and the loaders on
a tiny HF-named directory.

Config: tests/test_higgs3_granite_nar.py's `higgs3` (an 80-mel d32 tower of
2 layers, a 2-layer d32 Qwen3 LM of 4 heads and 2 KV heads of 8, 1,000
ids, temporal downsample 2, 1-s chunks, vad_cut off) and its tokenizer;
one parameter set drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`), the JAX tower jitted as the JAX package
jits it. Features at ATOL = 2e-4 (f32, summation order;
tests/test_torch_parity.py:19); chunk ranges, greedy tokens and text
equal.
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
CFG = dict(audio_encoder_config=dict(num_mel_bins=80, d_model=32,
                                     encoder_layers=2,
                                     encoder_attention_heads=4,
                                     encoder_ffn_dim=64,
                                     max_source_positions=1500),
           text_config=dict(vocab_size=1000, hidden_size=32,
                            intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2,
                            head_dim=8),
           projector_temporal_downsample=2, chunk_size_seconds=1.0,
           vad_cut=False)
Q8_GROUP = 32


class Tok:
    def encode(self, s, **k):
        return [10 + (ord(c) % 80) for c in s]

    def decode(self, ids, **k):
        return "".join(chr(97 + i % 26) for i in ids)


@pytest.fixture(autouse=True)
def no_hf_tokenizer(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.delenv("MLX_AUDIO_VAD_MODEL", raising=False)


def make_pair(cfg):
    from mlx_audio_tpu.stt.models.higgs_audio_3 import Model as JModel
    from mlx_audio_tpu.stt.models.higgs_audio_3 import ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.higgs_audio_3 import (Model,
                                                              ModelConfig)

    jm = JModel(JConfig.from_dict(cfg))
    jm.bind(numpy_params(jm.init_params, 0))
    pm = load_jax_params(Model(ModelConfig.from_dict(cfg), device="cpu"),
                         flat_numpy(jm.params))
    jm._tokenizer = pm._tokenizer = Tok()
    return jm, pm


@pytest.fixture(scope="module")
def pair():
    return make_pair(CFG)


def audio(seed, n, scale=0.1):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


@pytest.mark.parametrize("cuts,split", [
    (None, False), ([(2, 6), (10, 18)], False), ([(2, 6), (10, 18)], True),
    ("raise", False), ([], False)])
def test_chunk_ranges_are_jax_s(cuts, split):
    """`split_long` and `vad_chunk_ranges` (plain, VAD spans stretched to
    the gaps, split_vads, a backend that raises, no spans) as JAX's."""
    from mlx_audio_tpu.stt.models.higgs_audio_3 import higgs_audio_3 as J
    from mlx_audio_tpu_torch.stt.models.higgs_audio_3 import \
        higgs_audio_3 as P

    def backend(w):
        if cuts == "raise":
            raise RuntimeError("vad down")
        return cuts

    be = None if cuts is None else backend
    assert P.split_long(0, 10, 4) == J.split_long(0, 10, 4) == \
        [(0, 4), (4, 8), (8, 10)]
    assert P.vad_chunk_ranges(np.zeros(20), 8, be, split) == \
        J.vad_chunk_ranges(np.zeros(20), 8, be, split)


def test_features_match_jax(pair):
    """2 s in 1-s chunks -> two chunks of 13 rows (100 mel frames, /2 conv,
    /2 pool, /2 temporal), each within ATOL of JAX's; 2.5 s -> three
    chunks padded to the longest."""
    jm, pm = pair
    for n, chunks in ((32000, 2), (40000, 3)):
        x = audio(n, n)
        got, k = pm.get_audio_features(x)
        want, kj = jm.get_audio_features(x)
        assert k == kj == chunks
        assert all(g.shape == (13, 32) for g in got)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


@pytest.mark.parametrize("kw", [dict(max_tokens=10),
                                dict(max_tokens=6, prompt="say it")])
def test_greedy_generate_equals_jax(pair, kw):
    """`generate` greedy: text and counts equal JAX's (its prompt bucket
    and shared stepper), with the default prompt and another."""
    jm, pm = pair
    x = audio(1, 32000)
    got, want = pm.generate(x, **kw), jm.generate(x, **kw)
    assert got.text == want.text and got.text
    assert (got.prompt_tokens, got.generation_tokens) == \
        (want.prompt_tokens, want.generation_tokens)
    assert pm.last_run["steps"] == kw["max_tokens"]


def test_parse_output_is_jax_s(pair):
    jm, pm = pair
    for text in ("<think>x</think>hello <|im_end|>", "<think>unfinished",
                 "a <|endoftext|>b", "plain"):
        assert pm.parse_output(text) == jm.parse_output(text)


def write_silero(path):
    """A Silero directory of the port's seeded weights; -> the JAX model
    bound to the same weights."""
    import jax.numpy as jnp
    from safetensors.numpy import save_file

    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu.vad.models.silero_vad import Model as JSilero
    from mlx_audio_tpu.vad.models.silero_vad import \
        ModelConfig as JSileroConfig
    from mlx_audio_tpu_torch.model import jax_params
    from mlx_audio_tpu_torch.vad.models.silero_vad import Model, ModelConfig

    pv = Model(ModelConfig(), device="cpu").init_params(seed=0)
    path.mkdir()
    save_file({k: v.numpy() for k, v in pv.state_dict().items()},
              str(path / "model.safetensors"))
    jv = JSilero(JSileroConfig())
    jv.bind(unflatten({k: jnp.asarray(v.numpy())
                       for k, v in jax_params(pv).items()}))
    return jv


class FakeVad:
    """A Silero stand-in: fixed speech spans; records its call's knobs."""

    def __init__(self, spans):
        self.spans, self.calls = spans, []

    def get_speech_timestamps(self, audio, **kw):
        self.calls.append(kw)
        return [{"start": s, "end": e} for s, e in self.spans]


def test_vad_cut_reads_a_local_silero_or_raises(tmp_path, monkeypatch):
    """A departure: with vad_cut on and no Silero given, `generate` raises
    naming Silero and vad_cut=False (JAX's downloads one). A set model's
    spans (asked with JAX's knobs) cut the chunks as JAX's
    `vad_chunk_ranges` does, and the text is JAX's with those spans; a
    local Silero directory (`vad=`, or MLX_AUDIO_VAD_MODEL) loads the
    port's Silero, whose chunks and text are JAX's with the same
    Silero's."""
    from mlx_audio_tpu.stt.models.higgs_audio_3 import higgs_audio_3 as J
    from mlx_audio_tpu_torch.stt.models.higgs_audio_3 import \
        higgs_audio_3 as P
    from mlx_audio_tpu_torch.vad.models.silero_vad import Model as Silero
    from test_torch_vad import _speechy

    jm, pm = make_pair(dict(CFG, vad_cut=True))
    x = _speechy(40000, 3)
    with pytest.raises(RuntimeError, match="Silero.*vad_cut=False"):
        pm.generate(x, max_tokens=4)
    spans = [(4000, 12000), (20000, 30000)]
    fake = FakeVad(spans)
    pm.set_vad_model(fake)
    jm._vad_backend = lambda w: spans
    want = J.vad_chunk_ranges(x, 16000, lambda w: spans)
    assert want == [(0, 12000), (12000, 28000), (28000, 40000)]
    assert P.vad_chunk_ranges(x, 16000, pm._vad_backend(None)) == want
    assert pm.generate(x, max_tokens=6).text == \
        jm.generate(x, max_tokens=6).text
    assert fake.calls[-1] == dict(
        sample_rate=16000, threshold=0.5, min_speech_duration_ms=250,
        min_silence_duration_ms=100, speech_pad_ms=30, return_seconds=False)
    d = tmp_path / "silero_vad"
    jv = write_silero(d)

    def jax_backend(w):
        ts = jv.get_speech_timestamps(
            np.asarray(w, np.float32), sample_rate=16000, threshold=0.5,
            min_speech_duration_ms=250, min_silence_duration_ms=100,
            speech_pad_ms=30, return_seconds=False)
        return [(int(t["start"]), int(t["end"])) for t in ts
                if t["end"] > t["start"]]

    pm._vad_model = None
    assert P.vad_chunk_ranges(x, 16000, pm._vad_backend(str(d))) == \
        J.vad_chunk_ranges(x, 16000, jax_backend)
    assert isinstance(pm._vad_model, Silero)
    text = pm.generate(x, max_tokens=6).text
    jm._vad_backend = jax_backend
    assert text == jm.generate(x, max_tokens=6).text
    pm._vad_model = None
    assert pm.generate(x, max_tokens=6, vad=str(d)).text == text
    pm._vad_model = None
    monkeypatch.setenv("MLX_AUDIO_VAD_MODEL", str(d))
    assert pm.generate(x, max_tokens=6).text == text
    assert isinstance(pm._vad_model, Silero)


def test_sanitize_reads_layouts_from_shapes(pair):
    """HF names (`model.`, bare LM names, the text head) and torch conv
    layouts give JAX's arrays; the MLX conv layout the same."""
    jm, pm = pair
    rs = np.random.RandomState(3)
    w = {"audio_decoder_proj.text_lm_head.weight": rs.randn(1000, 32),
         "model.layers.0.mlp.up_proj.weight": rs.randn(64, 32),
         "norm.weight": rs.randn(32),
         "audio_tower.conv1.weight": rs.randn(32, 80, 3),
         "audio_encoder_proj.temporal.weight": rs.randn(32, 1, 3)}
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
    state = {k: v.numpy() for k, v in pm.state_dict().items()}
    out = {"audio_decoder_proj.text_lm_head.weight":
           state.pop("lm_head.weight")}
    for k, v in state.items():
        out["model." + k[len("language_model."):]
            if k.startswith("language_model.") else k] = v
    return out


def write_dir(path, state, **extra):
    path.mkdir()
    np.savez(path / "model.npz", **state)
    (path / "config.json").write_text(json.dumps(dict(
        CFG, model_type="higgs_audio_3", **extra)))


def test_q8_packed_directory_runs_every_lm_linear_quantized(pair, tmp_path):
    """An MLX-packed q8 directory (MLX's names, which are the sanitized
    ones: the LM's and the head's 2-D weights packed) through
    `stt.utils.load_model` and the JAX package's loader:
    7 x 2 + 1 quantized linears (K2 on the card), the tower and projector
    dense, the table an Embedding; `generate`'s greedy text and counts
    equal to JAX's q8 model's."""
    from mlx_audio_tpu.stt.utils import load_model as jax_load
    from mlx_audio_tpu_torch.nn import Embedding, QuantizedLinear
    from mlx_audio_tpu_torch.stt.utils import load_model

    _, pm = pair
    ckpt = {}
    for k, v in pm.state_dict().items():
        v = v.numpy()
        if k.startswith(("language_model.", "lm_head.")) and v.ndim == 2:
            for part, arr in packed_leaf(v, 8, Q8_GROUP).items():
                ckpt[k[:-len("weight")] + part] = arr
        else:
            ckpt[k] = v
    d = tmp_path / "higgs-audio-v3-stt-q8"
    write_dir(d, ckpt, quantization={"group_size": Q8_GROUP, "bits": 8})
    q8, jq = load_model(d, device="cpu"), jax_load(str(d))
    q8._tokenizer = jq._tokenizer = Tok()
    held = [n for n, m in q8.named_modules()
            if isinstance(m, QuantizedLinear)]
    assert len(held) == 15 and "lm_head" in held
    assert isinstance(q8.language_model.embed_tokens, Embedding)
    x = audio(6, 16000)
    got, want = q8.generate(x, max_tokens=8), jq.generate(x, max_tokens=8)
    assert got.text == want.text and got.text
    assert (got.prompt_tokens, got.generation_tokens) == \
        (want.prompt_tokens, want.generation_tokens)


def test_loaders_route_a_tiny_directory(pair, tmp_path):
    """An HF-named dense directory through `stt.utils.load_model` and the
    top-level router: equal weights and greedy text."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.stt.models.higgs_audio_3 import Model
    from mlx_audio_tpu_torch.stt.utils import load_model

    _, pm = pair
    d = tmp_path / "higgs-audio-v3-stt-tiny"
    write_dir(d, hf_state(pm))
    x = audio(7, 20000)
    want = pm.generate(x, max_tokens=6).text
    for loaded in (load_model(d, device="cpu"),
                   mlx_audio_tpu_torch.load_model(d, device="cpu")):
        assert isinstance(loaded, Model) and loaded._tokenizer is None
        for k, v in pm.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), k
        loaded._tokenizer = Tok()
        assert loaded.generate(x, max_tokens=6).text == want


def test_tokenizer_hook_raises_on_files_that_fail(tmp_path, monkeypatch):
    """A departure: tokenizer files that fail to load raise (JAX's hook
    swallows the error and leaves None); without them there is none."""
    import types

    from mlx_audio_tpu_torch.stt.models.higgs_audio_3 import Model

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
