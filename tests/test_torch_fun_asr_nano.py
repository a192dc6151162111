"""Fun-ASR-Nano of the PyTorch port against the JAX package, on the CPU:
the cases of tests/test_fun_asr_nano.py (fake token length, LFR features,
the encoder and adaptor and their pad invariance, the prompt helpers,
`generate` end to end and deterministic, `sanitize`), each held to the
JAX package's on one weight set; the departures pinned (the unpadded
tower against JAX's bucketed one, the raising tokenizer hook); an
MLX-packed q8 directory through both packages' loaders (every LM linear
on the quantized path, the tied table dense, the head one dense product,
greedy tokens equal); and the loaders on a tiny dense directory.

Config: tests/test_fun_asr_nano.py's `tiny_cfg` (input 24 = LFR 3 x 8
mels, a d32 SANM encoder of 2 + 1 blocks, a one-block d32 adaptor at
downsample 2, a 2-layer Qwen3 LM of d32, 4 heads and 2 KV heads of 8, 200
ids, tied), its `FakeTok`; q8 at group 32 widens nothing (every LM input
width, 32 and 64, is a multiple of it). One parameter set drawn with
numpy over JAX's shapes (`test_torch_mimi.numpy_params`), the JAX side
jitted. Features and tower rows at ATOL = 2e-4 (f32, summation order;
tests/test_torch_parity.py:19); greedy tokens equal (neither EOS id is in
a 200-id vocabulary, so every decode runs to max_tokens).
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
CFG = dict(
    input_size=24,
    frontend_conf=dict(n_mels=8, lfr_m=3, lfr_n=2),
    audio_encoder_conf=dict(output_size=32, attention_heads=4,
                            linear_units=64, num_blocks=2, tp_blocks=1,
                            kernel_size=5),
    audio_adaptor_conf=dict(downsample_rate=2, ffn_dim=48, llm_dim=32,
                            encoder_dim=32, n_layer=1, attention_heads=4),
    llm_config=dict(vocab_size=200, hidden_size=32, intermediate_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=8,
                    tie_word_embeddings=True),
    default_max_tokens=8)
Q8_GROUP = 32


class FakeTok:
    def encode(self, text):
        return [ord(c) % 150 + 5 for c in text][:30]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


@pytest.fixture(autouse=True)
def no_hf_tokenizer(monkeypatch):
    """The JAX hook tries `transformers` on any directory; blocked, it
    fails at once to the same None tokenizer (test_torch_prequantized)."""
    monkeypatch.setitem(sys.modules, "transformers", None)


@pytest.fixture(scope="module")
def pair():
    from mlx_audio_tpu.stt.models.fun_asr_nano import Model as JModel
    from mlx_audio_tpu.stt.models.fun_asr_nano import ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.fun_asr_nano import Model, ModelConfig

    jm = JModel(JConfig.from_dict(CFG))
    jm.bind(numpy_params(jm.init_params, 0))
    pm = load_jax_params(Model(ModelConfig.from_dict(CFG), device="cpu"),
                         flat_numpy(jm.params))
    jm._tokenizer = pm._tokenizer = FakeTok()
    return jm, pm


def audio(seed, n, scale=0.1):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


def test_fake_token_length_and_features_match_jax(pair):
    from mlx_audio_tpu.stt.models.fun_asr_nano.fun_asr_nano import \
        fake_token_length as jax_len
    from mlx_audio_tpu_torch.stt.models.fun_asr_nano.fun_asr_nano import \
        fake_token_length

    assert fake_token_length(1) == 1 and fake_token_length(100) == 13
    assert [fake_token_length(n) for n in range(1, 300)] == \
        [jax_len(n) for n in range(1, 300)]
    jm, pm = pair
    x = audio(0, 3200, 1.0)
    got, want = pm._extract_features(x), jm._extract_features(x)
    assert got[1:] == want[1:] and got[0].shape[1] == 24
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)


def test_tower_unpadded_equals_jax_bucketed(pair):
    """A departure: the port runs the encoder and adaptor on the frames
    the audio has; JAX pads them to ENC_BUCKETS under a mask. Its valid
    adaptor rows equal the port's (tests/test_fun_asr_nano.py's pad
    invariance), for an odd and an even frame count."""
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.stt.models.fun_asr_nano.fun_asr_nano import (
        adaptor_forward, encoder_forward)

    jm, pm = pair
    fn = jax.jit(lambda p, s, n: adaptor_forward(
        p, jm.config, encoder_forward(p, jm.config, s, n), n))
    for n in (11, 20):
        x = np.random.RandomState(n).randn(n, 24).astype(np.float32)
        buf = np.zeros((1, 128, 24), np.float32)
        buf[0, :n] = x
        want = np.asarray(fn(jm.params, jnp.asarray(buf),
                             jnp.asarray([n])))[0, :(n + 1) // 2]
        got = pm.get_audio_embeds(x).numpy()
        assert got.shape == want.shape == ((n + 1) // 2, 32)
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_prompt_helpers_are_jax_s(pair):
    jm, pm = pair
    for args in ((None, None, True), (["OpenAI", "TPU"], "中文", False),
                 ([], "英文", True)):
        assert pm._prompt_text(*args) == jm._prompt_text(*args)
    assert pm._prompt_text(None, None, True) == "语音转写："
    for lang in ("EN", "auto", "zh_CN", "yue", None, "Klingon"):
        assert pm._map_language(lang) == jm._map_language(lang)
    for bad in ("xx", "de"):
        with pytest.raises(ValueError, match="Unsupported ISO"):
            pm._map_language(bad)
    with pytest.raises(ValueError):
        pm._resolve_hotwords(["a"], "b")
    assert pm._resolve_hotwords(None, " ctx ") == ["ctx"]
    assert pm._resolve_hotwords([" a ", ""], None) == ["a"]
    for kw in (dict(language=None, hotwords=None, itn=True),
               dict(language="en", hotwords=["x"], itn=False)):
        assert pm._build_prompt_ids(4, **kw) == jm._build_prompt_ids(4, **kw)
    ids, beg = pm._build_prompt_ids(4, language=None, hotwords=None, itn=True)
    assert ids[beg:beg + 4] == [0, 0, 0, 0]


@pytest.mark.parametrize("kw", [dict(max_tokens=8),
                                dict(max_tokens=6, language="en",
                                     hotwords=["TPU"], itn=False)],
                         ids=["plain", "hotwords"])
def test_greedy_generate_equals_jax(pair, kw):
    """`generate` end to end, greedy: the tokens (the text of FakeTok's
    ids), prompt and generation counts and the segment equal JAX's."""
    jm, pm = pair
    x = audio(3, 16000)
    got, want = pm.generate(x, **kw), jm.generate(x, **kw)
    assert got.text == want.text and got.text
    assert (got.prompt_tokens, got.generation_tokens) == \
        (want.prompt_tokens, want.generation_tokens)
    assert got.generation_tokens == kw["max_tokens"]
    assert got.segments[0]["start"] == 0.0 and \
        got.segments[0]["end"] == want.segments[0]["end"]
    assert pm.last_run["steps"] == kw["max_tokens"]


def test_sampled_generate_is_deterministic(pair):
    """tests/test_fun_asr_nano.py's determinism, and a seeded draw: the
    same seed gives the same tokens (the port's draws come from a
    torch.Generator, so only greedy decoding compares with JAX)."""
    _, pm = pair
    x = audio(4, 8000)
    assert pm.generate(x, max_tokens=5).text == \
        pm.generate(x, max_tokens=5).text
    kw = dict(max_tokens=6, temperature=0.8, top_k=20, seed=3)
    assert pm.generate(x, **kw).text == pm.generate(x, **kw).text


def test_chunked_generate_splices_each_chunk(pair):
    """Audio past chunk_duration is cut by Qwen3-ASR's splitter: the
    first chunk spends the whole budget (no EOS id is in the vocabulary),
    as in JAX; the second chunk alone gives JAX's greedy tokens."""
    from mlx_audio_tpu_torch.stt.models.qwen3_asr.qwen3_asr import \
        split_audio_into_chunks

    jm, pm = pair
    x = audio(5, 40000)
    kw = dict(max_tokens=10, chunk_duration=1.5)
    got, want = pm.generate(x, **kw), jm.generate(x, **kw)
    assert len(got.segments) == len(want.segments) == 1
    assert got.text == want.text and got.generation_tokens == 10
    chunks = split_audio_into_chunks(x, 16000, 1.5)
    assert len(chunks) == 2
    greedy = (0.0, 0, 1.0, 0.0, 1.0, 20, 1)
    kw = dict(max_tokens=7, language=None, hotwords=None, itn=True,
              sampling=greedy)
    text, n, toks = pm._transcribe_chunk(chunks[1][0], seed=0, **kw)
    assert (text, n, len(toks)) == jm._transcribe_chunk(chunks[1][0], **kw)


def test_sanitize_matches_jax(pair):
    jm, pm = pair
    w = {"module.audio_encoder.encoders.0.self_attn.fsmn_block.weight":
         np.arange(160, dtype=np.float32).reshape(32, 1, 5),
         "llm.lm_head.weight": np.zeros((200, 32), np.float32),
         "module.llm.model.norm.weight": np.ones(32, np.float32)}
    got, want = pm.sanitize(w), jm.sanitize(w)
    assert sorted(got) == sorted(want)
    assert "llm.lm_head.weight" not in got
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def write_packed(pm, path, bits=8):
    """The model as an MLX-packed checkpoint: every `llm.model` linear
    packed at `bits` (group Q8_GROUP), the token table packed too, the
    encoder and adaptor dense, conv weights in torch's layout."""
    from mlx_audio_tpu_torch.model import jax_params

    flat = {k: v.numpy() for k, v in jax_params(pm).items()}
    ckpt = {}
    for k, v in flat.items():
        if k.startswith("llm.model") and k.endswith(".weight") \
                and v.ndim == 2:
            for part, arr in packed_leaf(v, bits, Q8_GROUP).items():
                ckpt[k[:-len("weight")] + part] = arr
        elif k.endswith("fsmn_block.weight"):
            ckpt[k] = np.transpose(v, (2, 1, 0))
        else:
            ckpt[k] = v
    path.mkdir()
    np.savez(path / "model.npz", **ckpt)
    (path / "config.json").write_text(json.dumps(dict(
        CFG, model_type="fun_asr_nano",
        quantization={"group_size": Q8_GROUP, "bits": bits})))


def test_q8_packed_directory_runs_every_lm_linear_quantized(pair, tmp_path):
    """An MLX-packed q8 directory through `stt.utils.load_model` and the
    JAX package's loader: 7 x 2 quantized LM linears (K2 on the card),
    the tied table an Embedding (dense), each decode forward one
    quantized product a linear and none for the head, and greedy tokens
    equal to JAX's q8 model's."""
    from mlx_audio_tpu.stt.utils import load_model as jax_load
    from mlx_audio_tpu_torch.nn import Embedding, QuantizedLinear
    from mlx_audio_tpu_torch.stt.utils import load_model

    _, pm = pair
    d = tmp_path / "fun-asr-nano-q8"
    write_packed(pm, d)
    q8 = load_model(d, device="cpu")
    jq = jax_load(str(d))
    q8._tokenizer = jq._tokenizer = FakeTok()
    held = [n for n, m in q8.named_modules() if isinstance(m,
                                                           QuantizedLinear)]
    assert len(held) == 14 and all(n.startswith("llm.model.layers")
                                   for n in held)
    assert isinstance(q8.llm.model.embed_tokens, Embedding)
    assert not hasattr(q8.llm, "lm_head")
    calls = []
    orig = QuantizedLinear.forward

    def count(self, x):
        calls.append(x.shape[-2])
        return orig(self, x)

    QuantizedLinear.forward = count
    try:
        x = audio(6, 8000)
        got = q8.generate(x, max_tokens=6)
    finally:
        QuantizedLinear.forward = orig
    # a prefill over the prompt, then one forward per kept token but the
    # last: 14 products each, one row each in the steps
    forwards = 1 + q8.last_run["forwards"]
    assert len(calls) == 14 * forwards and q8.last_run["forwards"] == 5
    assert calls[14:] == [1] * (14 * 5)
    assert got.text == jq.generate(x, max_tokens=6).text


def test_loaders_route_a_tiny_directory(pair, tmp_path):
    """A dense checkpoint in the published names (`module.` prefix, torch
    conv layouts, the tied head written out) through `stt.utils` and the
    top-level router: equal weights and greedy text."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.model import jax_params
    from mlx_audio_tpu_torch.stt.models.fun_asr_nano import Model
    from mlx_audio_tpu_torch.stt.utils import load_model

    jm, pm = pair
    flat = {k: v.numpy() for k, v in jax_params(pm).items()}
    ckpt = {"module." + k: (np.transpose(v, (2, 1, 0))
                            if k.endswith("fsmn_block.weight") else v)
            for k, v in flat.items()}
    ckpt["llm.lm_head.weight"] = flat["llm.model.embed_tokens.weight"]
    d = tmp_path / "Fun-ASR-Nano-tiny"
    d.mkdir()
    np.savez(d / "model.npz", **ckpt)
    (d / "config.json").write_text(json.dumps(dict(
        CFG, model_type="fun_asr_nano")))
    x = audio(7, 8000)
    want = pm.generate(x, max_tokens=5).text
    for loaded in (load_model(d, device="cpu"),
                   mlx_audio_tpu_torch.load_model(d, device="cpu")):
        assert isinstance(loaded, Model) and loaded._tokenizer is None
        for k, v in pm.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), k
        loaded._tokenizer = FakeTok()
        assert loaded.generate(x, max_tokens=5).text == want


def test_tokenizer_hook_raises_on_files_that_fail(tmp_path, monkeypatch):
    """A departure: tokenizer files that fail to load raise (JAX's hook
    swallows the error and leaves None); without tokenizer files there is
    none, as in JAX. The tokenizer is read from the `Qwen3-0.6B`
    subfolder where there is one."""
    import types

    from mlx_audio_tpu_torch.stt.models.fun_asr_nano import Model

    m = Model(CFG, device="cpu")
    assert Model.post_load_hook(m, tmp_path)._tokenizer is None
    seen = []

    def broken(path, **kw):
        seen.append((path, kw))
        raise OSError(f"cannot read the tokenizer in {path}")

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=broken)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    sub = tmp_path / "Qwen3-0.6B"
    sub.mkdir()
    (sub / "tokenizer.json").write_text("{broken")
    with pytest.raises(OSError, match="tokenizer"):
        Model.post_load_hook(m, tmp_path)
    assert seen == [(str(sub), {"trust_remote_code": True})]
