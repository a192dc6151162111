"""Qwen3-ASR of the PyTorch port against the JAX package, on the CPU: the
config's `thinker_config` flattening, the lengths and the long-audio split,
the audio tower on 100 and 337 mel frames (a ragged last chunk, two
windows), window isolation, the prompt splice, greedy `generate` and
`stream_transcribe`, the repetition penalty, `sanitize`, an MLX-packed
8-bit checkpoint loaded by both packages, and a bf16 model; then the
port's own rules (a seeded sampled run and its filters, the tokenizer
checks).

Configs: tests/test_qwen3_asr.py's `_cfg` and its `_FakeTok` for the
model; its HF-parity tower (2 layers, d32, n_window_infer 200) for the
tower; one parameter tree drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`), bound into both packages. The JAX
package runs its own jitted encoder and decode. Features at ATOL = 2e-4
(f32, summation order); greedy tokens and text equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402
from test_torch_prequantized import no_hf_tokenizer  # noqa: E402,F401

ATOL = 2e-4

CFG = dict(
    model_type="qwen3_asr", audio_token_id=5,
    audio_config=dict(num_mel_bins=16, encoder_layers=1,
                      encoder_attention_heads=2, encoder_ffn_dim=32,
                      d_model=16, downsample_hidden_size=4, output_dim=16),
    text_config=dict(vocab_size=64, hidden_size=16, intermediate_size=32,
                     num_hidden_layers=1, num_attention_heads=2,
                     num_key_value_heads=2, head_dim=8,
                     tie_word_embeddings=True))
TOWER_CFG = dict(
    model_type="qwen3_asr",
    audio_config=dict(num_mel_bins=32, encoder_layers=2,
                      encoder_attention_heads=4, encoder_ffn_dim=64,
                      d_model=32, downsample_hidden_size=16, output_dim=40,
                      n_window=50, n_window_infer=200),
    text_config=dict(vocab_size=32, hidden_size=16, intermediate_size=32,
                     num_hidden_layers=1, num_attention_heads=2,
                     num_key_value_heads=2, head_dim=8,
                     tie_word_embeddings=True))
# every linear's input a multiple of the group (32), for the packed case
Q8_CFG = dict(
    model_type="qwen3_asr", audio_token_id=5,
    audio_config=dict(num_mel_bins=32, encoder_layers=1,
                      encoder_attention_heads=4, encoder_ffn_dim=64,
                      d_model=32, downsample_hidden_size=8, output_dim=32),
    text_config=dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=8,
                     tie_word_embeddings=True))
MAX_TOKENS = 64


class FakeTok:
    """tests/test_qwen3_asr.py::_FakeTok."""

    eos_token_id = 3
    unk_token_id = 0

    def encode(self, text, add_special_tokens=False):
        n_audio = text.count("<|audio_pad|>")
        prefix = [11] if "<asr_text>" in text else []
        return [7, 8] + [5] * n_audio + [9, 10] + prefix

    def decode(self, toks, skip_special_tokens=True):
        return " ".join(str(t) for t in toks)

    def convert_tokens_to_ids(self, s):
        return 3 if s == "<|im_end|>" else 4


def make_pair(cfg: dict, seed: int = 0, jax_module=None, port_module=None):
    """(JAX model, port model) from one numpy-drawn tree, each with
    FakeTok."""
    import mlx_audio_tpu.stt.models.qwen3_asr as jq
    import mlx_audio_tpu_torch.stt.models.qwen3_asr as pq
    from mlx_audio_tpu_torch.model import load_jax_params

    jq, pq = jax_module or jq, port_module or pq
    jm = jq.Model(jq.ModelConfig.from_dict(cfg))
    jm.bind(numpy_params(jm.init_params, seed))
    pm = load_jax_params(pq.Model(pq.ModelConfig.from_dict(cfg),
                                  device="cpu"), flat_numpy(jm.params))
    jm._tokenizer = pm._tokenizer = FakeTok()
    return jm, pm


@pytest.fixture(scope="module")
def pair():
    return make_pair(CFG)


@pytest.fixture(scope="module")
def tower_pair():
    return make_pair(TOWER_CFG)


def _audio(seed: int, seconds: float) -> np.ndarray:
    return (np.random.RandomState(seed).randn(int(16000 * seconds)) * 0.1
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# config, lengths, chunks
# ---------------------------------------------------------------------------


def test_config_flattens_the_thinker_config_as_jax():
    from mlx_audio_tpu.stt.models.qwen3_asr import ModelConfig as JConfig
    from mlx_audio_tpu_torch.stt.models.qwen3_asr import ModelConfig

    raw = {"model_type": "qwen3_asr", "support_languages": ["English"],
           "thinker_config": {"audio_config": {"d_model": 64},
                              "text_config": {"hidden_size": 96},
                              "audio_token_id": 9,
                              "audio_start_token_id": 7}}
    for cfg in (raw, {}):
        p, j = ModelConfig.from_dict(dict(cfg)), JConfig.from_dict(dict(cfg))
        assert vars(p.audio_config) == vars(j.audio_config)
        assert vars(p.text_config) == vars(j.text_config)
        assert (p.audio_token_id, p.audio_start_token_id,
                p.audio_end_token_id, p.support_languages) == (
            j.audio_token_id, j.audio_start_token_id, j.audio_end_token_id,
            j.support_languages)
    assert ModelConfig.from_dict(raw).audio_config.d_model == 64


def test_lengths_and_chunks_equal_jax():
    from mlx_audio_tpu.stt.models.qwen3_asr import qwen3_asr as jq
    from mlx_audio_tpu_torch.stt.models.qwen3_asr import qwen3_asr as pq

    for n in list(range(0, 420)) + [1000, 3000, 12345]:
        assert pq.feat_out_len(n) == jq.feat_out_len(n), n
    rs = np.random.RandomState(4)
    wav = rs.randn(16000 * 30).astype(np.float32)
    wav[16000 * 9:16000 * 11] *= 0.001
    for args in ((wav, 16000, 10.0), (wav[:100], 16000),
                 (wav[:16000 * 3], 16000, 1.0)):
        got, want = pq.split_audio_into_chunks(*args), \
            jq.split_audio_into_chunks(*args)
        assert [o for _, o in got] == [o for _, o in want]
        for (a, _), (b, _) in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert pq.PROMPT_BUCKETS == jq.PROMPT_BUCKETS
    assert pq.DEC_CHUNK == jq.DEC_CHUNK
    assert pq._sin_pos(13, 16).tobytes() == jq._sin_pos(13, 16).tobytes()


# ---------------------------------------------------------------------------
# the audio tower
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_frames", [100, 337])
def test_tower_features_equal_jax(tower_pair, n_frames):
    """A whole chunk, and three whole chunks and a ragged one (44 frames
    in windows of 26)."""
    jm, pm = tower_pair
    mel = np.random.RandomState(n_frames).randn(32, n_frames).astype(
        np.float32)
    want, n_want = jm.encode_features(mel)
    got, n_got = pm.encode_features(mel)
    assert n_got == n_want == want.shape[0] == got.shape[0]
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_windows_are_isolated(tower_pair):
    """Block attention and per-chunk positions: the first window's
    features do not change when the audio goes on."""
    _, pm = tower_pair
    mel = np.random.RandomState(1).randn(32, 500).astype(np.float32)
    long, _ = pm.encode_features(mel)
    short, n = pm.encode_features(mel[:, :200])          # one whole window
    assert n == 26
    np.testing.assert_allclose(long[:26].numpy(), short.numpy(), atol=1e-5)


def test_encode_from_audio_equals_jax(pair):
    """The Whisper log-mel in front: 2 s of audio, 199 frames."""
    jm, pm = pair
    audio = _audio(0, 2.0)
    want, n_want = jm.encode(audio)
    got, n = pm.encode(audio)
    assert n == n_want == 26
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_splice_replaces_the_audio_pad_rows(pair):
    """Each <|audio_pad|> row of the prompt's embeddings is the next
    encoder row; the rest are the token table's rows."""
    jm, pm = pair
    feats, n_audio = pm.encode(_audio(0, 1.0))
    ids = pm._build_prompt(n_audio, "English", None)
    embeds = pm.prompt_embeds(ids, feats, 256)[0].numpy()
    table = np.asarray(jm.params["model"]["embed_tokens"]["weight"])
    pos = [i for i, t in enumerate(ids) if t == 5]
    assert len(pos) == n_audio == 13
    np.testing.assert_array_equal(embeds[pos], feats.numpy())
    rest = [i for i in range(256) if i not in pos]
    want = table[np.asarray(ids + [0] * (256 - len(ids)))[rest]]
    np.testing.assert_array_equal(embeds[rest], want)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs(pair):
    """The JAX package's greedy generate (language given and detected) and
    stream_transcribe on one clip, max_tokens 64."""
    jm, _ = pair
    audio = _audio(2, 1.5)
    kw = dict(max_tokens=MAX_TOKENS)
    return audio, {
        "English": jm.generate(audio, language="English", **kw),
        None: jm.generate(audio, **kw),
        "stream": list(jm.stream_transcribe(audio, language="English",
                                            **kw)),
        "rep": jm.generate(audio, language="English",
                           repetition_penalty=1.5, **kw)}


@pytest.mark.parametrize("language", ["English", None])
def test_greedy_generate_equals_jax(pair, jax_runs, language):
    _, pm = pair
    audio, runs = jax_runs
    want = runs[language]
    got = pm.generate(audio, language=language, max_tokens=MAX_TOKENS)
    assert got.text == want.text
    assert (got.prompt_tokens, got.generation_tokens, got.language,
            got.segments) == (want.prompt_tokens, want.generation_tokens,
                              want.language, want.segments)
    run = pm.last_run
    assert run["tokens"] == got.generation_tokens
    assert run["steps"] <= min(got.generation_tokens + 2, MAX_TOKENS)


def test_repetition_penalty_carries_its_history(pair, jax_runs):
    """The penalty over the last 20 drawn tokens: JAX's first chunk of 32
    tokens; past it (to 40) the history carries on (JAX's Qwen3-ASR chunk
    starts a new, empty history every 32 tokens), as a step-by-step greedy
    reference over whole forwards gives."""
    from mlx_audio_tpu_torch.ops.sampling import apply_repetition_penalty

    _, pm = pair
    audio, runs = jax_runs
    got = pm.generate(audio, language="English", max_tokens=40,
                      repetition_penalty=1.5)
    toks = [int(t) for t in got.text.split()]
    want = [int(t) for t in runs["rep"].text.split()]
    assert len(toks) > 32 and toks[:32] == want[:32]
    feats, n_audio = pm.encode(audio)
    ids = pm._build_prompt(n_audio, "English", None)
    seq = []
    with torch.inference_mode():
        for _ in range(len(toks)):
            emb = pm.prompt_embeds(ids + seq, feats, len(ids) + len(seq))
            hidden, _ = pm._lm_forward(emb, None, 0, None)
            lg = pm.logits(hidden[:, -1]).float()
            hist = torch.tensor([([-1] * 20 + seq)[-20:]])
            seq.append(int(apply_repetition_penalty(lg, hist, 1.5).argmax()))
    assert seq == toks


def test_stream_transcribe_equals_jax(pair, jax_runs):
    _, pm = pair
    audio, runs = jax_runs
    got = list(pm.stream_transcribe(audio, language="English",
                                    max_tokens=MAX_TOKENS))
    assert [vars(r) for r in got] == [vars(r) for r in runs["stream"]]
    assert got[-1].is_final
    streamed = list(pm.generate(audio, language="English",
                                max_tokens=MAX_TOKENS, stream=True))
    assert [vars(r) for r in streamed] == [vars(r) for r in got]


def test_sampled_run_is_seeded_and_keeps_the_rules(pair, jax_runs):
    """Draws come from a torch.Generator: a seed repeats its text; top-k 1,
    min-p 1 and a tiny top-p leave only the argmax, so they decode JAX's
    greedy text."""
    _, pm = pair
    audio, runs = jax_runs
    n = 12
    kw = dict(language="English", max_tokens=n, temperature=1.0)
    a = pm.generate(audio, seed=3, **kw).text
    assert pm.generate(audio, seed=3, **kw).text == a
    greedy = " ".join(runs["English"].text.split()[:n])
    for rule in (dict(top_k=1), dict(min_p=1.0), dict(top_p=1e-6)):
        assert pm.generate(audio, seed=5, **kw, **rule).text == greedy, rule


def test_decode_stops_one_step_after_eos(pair, monkeypatch):
    """An EOS drawn at step 3: the kept tokens are the three before it,
    and the loop has run at most one step more."""
    from mlx_audio_tpu_torch.stt.models import qwen3_lm

    _, pm = pair
    real = qwen3_lm.make_sampler

    def forced(**kw):
        inner = real(**kw)
        calls = []

        def sampler(logits, history=None, generator=None):
            calls.append(1)
            tok = inner(logits, history, generator)
            return torch.full_like(tok, 3) if len(calls) == 4 else \
                torch.full_like(tok, 20)

        return sampler

    monkeypatch.setattr(qwen3_lm, "make_sampler", forced)
    pm._fns = {}
    out = pm.generate(_audio(2, 1.5), language="English",
                      max_tokens=MAX_TOKENS)
    pm._fns = {}
    assert out.text == "20 20 20"
    assert pm.last_run["steps"] == 5 and pm.last_run["chunks"] == 1


def test_text_without_a_tokenizer_raises():
    from mlx_audio_tpu_torch.stt.models.qwen3_asr import Model, ModelConfig

    m = Model(ModelConfig.from_dict(CFG), device="cpu").init_params(0)
    with pytest.raises(RuntimeError, match="tokenizer"):
        m.generate(np.zeros(16000, np.float32))
    with pytest.raises(RuntimeError, match="tokenizer"):
        next(m.generate(np.zeros(16000, np.float32), stream=True))


def test_bf16_model_runs_against_f32_caches(pair):
    _, pm = pair
    from mlx_audio_tpu_torch.model import load_jax_params, jax_params
    from mlx_audio_tpu_torch.stt.models.qwen3_asr import Model, ModelConfig

    m = load_jax_params(Model(ModelConfig.from_dict(CFG), device="cpu"),
                        {k: v.numpy() for k, v in jax_params(pm).items()})
    m.astype(torch.bfloat16)
    m._tokenizer = FakeTok()
    out = m.generate(_audio(2, 1.5), language="English", max_tokens=8)
    feats, _ = m.encode(_audio(2, 1.5))
    assert feats.dtype == torch.bfloat16 and torch.isfinite(feats).all()
    assert isinstance(out.text, str) and out.generation_tokens <= 8


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def test_sanitize_equals_jax_and_reads_each_conv_layout(pair):
    jm, pm = pair
    rs = np.random.RandomState(3)
    oihw = rs.randn(4, 1, 3, 3).astype(np.float32)
    raw = {"thinker.audio_tower.conv2d1.weight": oihw,
           "thinker.model.layers.0.self_attn.q_proj.weight":
               rs.randn(16, 16).astype(np.float32),
           "lm_head.weight": rs.randn(64, 16).astype(np.float32)}
    got, want = pm.sanitize(dict(raw)), jm.sanitize(dict(raw))
    assert set(got) == set(want)
    assert "lm_head.weight" not in got
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    hwio = got["audio_tower.conv2d1.weight"]
    assert hwio.shape == (3, 3, 1, 4)
    # the JAX tree's HWIO and MLX's OHWI give the same HWIO here; JAX's
    # sanitize takes an OHWI weight as HWIO
    for layout in (hwio, np.transpose(oihw, (0, 2, 3, 1))):
        out = pm.sanitize({"audio_tower.conv2d1.weight": layout})
        np.testing.assert_array_equal(out["audio_tower.conv2d1.weight"],
                                      hwio)
    with pytest.raises(ValueError, match="conv2d1"):
        pm.sanitize({"audio_tower.conv2d1.weight": np.zeros((2, 3, 3, 3))})
    # the JAX tree itself passes through (a converted directory)
    from mlx_audio_tpu.utils import flatten

    flat = {k: np.asarray(v) for k, v in flatten(jm.params).items()}
    again = pm.sanitize(flat)
    assert set(again) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(again[k], flat[k])


def test_packed_q8_directory_generates_as_jax(tmp_path):
    """An MLX-packed 8-bit checkpoint (HF `thinker.` names, torch conv
    layouts, every linear and the token table packed at group 32;
    `chip_smoke.write_asr_checkpoint`) through both packages' STT loaders:
    every linear on the port's QuantizedLinear (K2 on the card), the token
    table dense; the greedy text equal to JAX's."""
    from chip_smoke import write_asr_checkpoint
    from mlx_audio_tpu.stt.utils import load_model as jax_load
    from mlx_audio_tpu_torch.nn import Embedding, QuantizedLinear
    from mlx_audio_tpu_torch.stt.utils import load_model

    _, src = make_pair(Q8_CFG, seed=1)
    write_asr_checkpoint(src, tmp_path / "q8", bits=8, group_size=32)
    pm = load_model(tmp_path / "q8", device="cpu")
    jm = jax_load(str(tmp_path / "q8"))
    jm._tokenizer = pm._tokenizer = FakeTok()
    # the tower's conv_out, six a layer, proj1 and proj2; seven an LM layer
    held = sum(isinstance(m, QuantizedLinear) for m in pm.modules())
    assert held == (1 + 6 + 2) + 7 * 2
    assert isinstance(pm.model.embed_tokens, Embedding)
    audio = _audio(7, 1.5)
    want = jm.generate(audio, language="English", max_tokens=MAX_TOKENS)
    got = pm.generate(audio, language="English", max_tokens=MAX_TOKENS)
    assert got.text == want.text
    jf, _ = jm.encode(audio)
    pf, _ = pm.encode(audio)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), atol=ATOL)


def test_post_load_hook_reads_only_the_local_directory(tmp_path,
                                                      monkeypatch):
    """No tokenizer files: no tokenizer (generate then raises); tokenizer
    files that fail to load raise at load, where JAX's hook swallows the
    error."""
    import sys
    import types

    from mlx_audio_tpu_torch.stt.models.qwen3_asr import Model, ModelConfig

    m = Model(ModelConfig.from_dict(CFG), device="cpu")
    assert Model.post_load_hook(m, tmp_path)._tokenizer is None

    def broken(path, **kw):
        raise OSError(f"cannot read the tokenizer in {path}")

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=broken)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    (tmp_path / "tokenizer.json").write_text("{not json")
    with pytest.raises(OSError, match="tokenizer"):
        Model.post_load_hook(m, tmp_path)
