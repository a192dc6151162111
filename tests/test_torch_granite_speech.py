"""Granite Speech of the PyTorch port against the JAX package, on the CPU:
the stacked log-mel features, the conformer encoder (whole blocks, and an
unpadded run against JAX's masked bucket, as
tests/test_granite_speech.py::test_pad_masking_matches_unpadded holds
JAX's), the block attention's padded columns, the Q-former projector, the
audio features, the prompt, greedy `generate` (with the repetition
penalty too) and the stream, `sanitize` on torch-layout and MLX-layout
checkpoints, an MLX-packed 8-bit LM through both packages' loaders; then
the port's own rules (a seeded sampled run and its filters, the tokenizer
hook).

Config: tests/test_granite_speech.py's `tiny_cfg` (Granite multipliers on
the LM) and its `_Tok2`; one parameter tree drawn with numpy over JAX's
shapes (`test_torch_mimi.numpy_params`), bound into both packages. The
JAX package runs its own jitted encoder, projector and decode; here its
`encoder_forward` and `projector_forward` are jitted. Encoder and
projector rows at ATOL = 2e-4 (f32, summation order); features at 1e-4
(a log10 of f32 powers); greedy tokens and text equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402
from test_torch_voxtral import one_torch_thread  # noqa: E402,F401

ATOL = 2e-4
MAX_TOKENS = 24

CFG = dict(
    encoder_config=dict(input_dim=20, num_layers=2, hidden_dim=32,
                        feedforward_mult=2, num_heads=4, dim_head=8,
                        output_dim=10, context_size=8, max_pos_emb=16,
                        conv_kernel_size=5, conv_expansion_factor=2),
    projector_config=dict(hidden_size=32, num_hidden_layers=1,
                          num_attention_heads=4, intermediate_size=64,
                          encoder_hidden_size=32),
    text_config=dict(model_type="granite", vocab_size=120,
                     hidden_size=32, intermediate_size=64,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, rope_theta=10000.0,
                     attention_multiplier=0.125,
                     embedding_multiplier=12.0,
                     residual_multiplier=0.22, logits_scaling=8.0),
    audio_token_index=110, downsample_rate=5, window_size=15)


def tok2():
    from test_granite_speech import _Tok2

    return _Tok2()


def make_pair(seed=0, tok=True):
    import mlx_audio_tpu.stt.models.granite_speech as jg
    import mlx_audio_tpu_torch.stt.models.granite_speech as pg
    from mlx_audio_tpu_torch.model import load_jax_params

    jm = jg.Model(jg.ModelConfig.from_dict(CFG))
    jm.bind(numpy_params(jm.init_params, seed))
    pm = load_jax_params(pg.Model(pg.ModelConfig.from_dict(CFG),
                                  device="cpu"), flat_numpy(jm.params))
    if tok:
        jm._tokenizer, pm._tokenizer = tok2(), tok2()
    return jm, pm


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def jitted(pair):
    """JAX's encoder_forward (with and without a valid count) and
    projector_forward, jitted."""
    import jax

    from mlx_audio_tpu.stt.models.granite_speech.granite_speech import (
        encoder_forward, projector_forward)

    jm, _ = pair
    return (jax.jit(lambda p, x: encoder_forward(p, jm.config, x)),
            jax.jit(lambda p, x, n: encoder_forward(p, jm.config, x, n)),
            jax.jit(lambda p, x: projector_forward(p, jm.config, x)))


def _audio(seed: int, seconds: float) -> np.ndarray:
    return (np.random.RandomState(seed).randn(int(16000 * seconds)) * 0.1
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# encoder and projector
# ---------------------------------------------------------------------------


def test_encoder_equals_jax_on_whole_blocks(pair, jitted):
    """(1, 16, 20): two context blocks, the mid-layer CTC softmax fed back
    after layer 1."""
    jm, pm = pair
    from mlx_audio_tpu_torch.stt.models.granite_speech.granite_speech \
        import encoder_forward

    x = np.random.RandomState(0).randn(1, 16, 20).astype(np.float32)
    want = np.asarray(jitted[0](jm.params, x))
    with torch.inference_mode():
        got = encoder_forward(pm.encoder, pm.config.enc, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("n", [8, 13, 5])
def test_unpadded_encoder_equals_jax_masked_bucket(pair, jitted, n):
    """n frames run as they are against JAX's 16- or 24-frame bucket with
    `valid_frames` n: the valid rows agree (the last block partial; at 5
    frames JAX's second block is all padding)."""
    from mlx_audio_tpu_torch.stt.models.granite_speech.granite_speech \
        import encoder_forward

    jm, pm = pair
    x = np.random.RandomState(n).randn(1, n, 20).astype(np.float32)
    bucket = np.zeros((1, 16, 20), np.float32)
    bucket[:, :n] = x
    want = np.asarray(jitted[1](jm.params, bucket, np.int32(n)))[:, :n]
    with torch.inference_mode():
        got = encoder_forward(pm.encoder, pm.config.enc, torch.from_numpy(x))
    assert got.shape == (1, n, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_a_block_of_padding_alone_is_uniform_not_nan(pair):
    """Key columns past n_valid take -1e9: a block whose keys are all
    padding gets uniform weights, and finite rows."""
    from mlx_audio_tpu_torch.stt.models.granite_speech.granite_speech \
        import block_attention

    _, pm = pair
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 16, 32).astype(
        np.float32))
    p = pm.encoder.layers[0].attn
    with torch.inference_mode():
        out = block_attention(p, pm.config.enc, x, n_valid=5)
        v = p.to_kv(p.pre_norm(x)).chunk(2, dim=-1)[1][:, 8:]
        uniform = p.to_out(v.reshape(1, 8, 4, 8).mean(dim=1, keepdim=True)
                           .expand(1, 8, 4, 8).reshape(1, 8, 32))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out[:, 8:].numpy(), uniform.numpy(),
                               atol=1e-5)


def test_projector_equals_jax(pair, jitted):
    from mlx_audio_tpu_torch.stt.models.granite_speech.granite_speech \
        import projector_forward

    jm, pm = pair
    enc = np.random.RandomState(3).randn(1, 30, 32).astype(np.float32)
    want = np.asarray(jitted[2](jm.params, enc))
    with torch.inference_mode():
        got = projector_forward(pm.projector, pm.config, torch.from_numpy(enc))
    assert got.shape == (1, 6, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("seconds", [0.25, 2.0])
def test_audio_features_equal_jax(pair, seconds):
    """26 frames (13 stacked rows, one window) and 201 frames (the odd
    last one dropped: 100 rows, seven windows, 21 tokens; JAX's encoder
    bucket of 200 against the port's 100 rows)."""
    jm, pm = pair
    audio = _audio(int(seconds * 4), seconds)
    jf, jn = jm._extract_features(audio)
    pf, pn = pm._extract_features(audio)
    assert pn == jn and pf.shape == jf.shape
    np.testing.assert_allclose(pf.numpy(), jf, atol=1e-4)
    want = jm.get_audio_features(jf)
    got = pm.get_audio_features(jf)
    assert got.shape == want.shape == (jn, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs(pair):
    jm, _ = pair
    audio = _audio(5, 0.5)
    kw = dict(max_tokens=MAX_TOKENS)
    return audio, {
        "greedy": jm.generate(audio, **kw),
        "rep": jm.generate(audio, repetition_penalty=1.5, **kw),
        "fr": jm.generate(audio, language="fr", **kw),
        "stream": list(jm.generate(audio, stream=True, **kw))}


def test_prompt_equals_jax(pair):
    jm, pm = pair
    for n, prompt in ((3, None), (21, "Say it.")):
        assert pm._build_prompt_ids(n, prompt) == \
            jm._build_prompt_ids(n, prompt)
    j0, p0 = make_pair(tok=False)
    assert p0._build_prompt_ids(3, None) == j0._build_prompt_ids(3, None)
    assert p0._eos_ids() == j0._eos_ids() == (0,)


@pytest.mark.parametrize("run", ["greedy", "rep", "fr"])
def test_greedy_generate_equals_jax(pair, jax_runs, run):
    _, pm = pair
    audio, runs = jax_runs
    kw = {"rep": dict(repetition_penalty=1.5), "fr": dict(language="fr"),
          "greedy": {}}[run]
    got = pm.generate(audio, max_tokens=MAX_TOKENS, **kw)
    want = runs[run]
    assert want.generation_tokens > 0
    assert got.text == want.text
    assert (got.prompt_tokens, got.generation_tokens, got.segments) == (
        want.prompt_tokens, want.generation_tokens, want.segments)


def test_stream_equals_jax_and_offline(pair, jax_runs):
    _, pm = pair
    audio, runs = jax_runs
    got = list(pm.generate(audio, max_tokens=MAX_TOKENS, stream=True))
    assert [vars(r) for r in got] == [vars(r) for r in runs["stream"]]
    assert got[-1].is_final
    assert " ".join(r.text for r in got[:-1]) == runs["greedy"].text


def test_sampled_run_is_seeded_and_keeps_the_rules(pair, jax_runs):
    _, pm = pair
    audio, runs = jax_runs
    kw = dict(max_tokens=MAX_TOKENS, temperature=1.0)
    a = pm.generate(audio, seed=3, **kw).text
    assert pm.generate(audio, seed=3, **kw).text == a
    for rule in (dict(top_k=1), dict(min_p=1.0), dict(top_p=1e-6)):
        assert pm.generate(audio, seed=5, **kw, **rule).text == \
            runs["greedy"].text


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["torch", "mlx"])
def test_sanitize_reads_each_conv_layout(pair, tmp_path, layout):
    """A torch-layout and an MLX-layout checkpoint (with a batch norm's
    step counter) bind to the same weights; the depthwise conv (64, 1, 5)
    and the pointwise ones read from their shapes."""
    from safetensors.numpy import save_file

    from chip_smoke import write_llm_stt_checkpoint
    from mlx_audio_tpu_torch.stt.models.granite_speech import Model
    from mlx_audio_tpu_torch.stt.utils import load_model
    from mlx_audio_tpu_torch.utils import load_weights

    jm, pm = pair
    d = tmp_path / layout
    write_llm_stt_checkpoint(pm, d, conv=layout)
    w = load_weights(d)
    w["encoder.layers.0.conv.batch_norm.num_batches_tracked"] = np.zeros(
        (), np.int64)
    save_file(w, str(d / "model.safetensors"))
    got = load_model(d, device="cpu")
    assert isinstance(got, Model)
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(got.state_dict()[k].numpy(),
                                      v.numpy(), err_msg=k)
    if layout == "torch":
        raw = {k: v for k, v in w.items() if "conv" in k}
        want = jm.sanitize(dict(raw))
        got_s = pm.sanitize(dict(raw))
        assert set(got_s) == set(want)
        for k in got_s:
            np.testing.assert_array_equal(got_s[k], np.asarray(want[k]))


def test_packed_q8_lm_generates_as_jax(pair, tmp_path):
    """The LM's linears and token table MLX-packed at 8 bits (group 32),
    the encoder and projector dense, the convs in the JAX tree's layout
    (JAX's sanitize leaves a quantized checkpoint's convs as they are),
    through both packages' STT loaders: greedy text equal to JAX's."""
    import sys

    from chip_smoke import write_llm_stt_checkpoint
    from mlx_audio_tpu.stt.utils import load_model as jax_load
    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.stt.utils import load_model

    _, src = make_pair(seed=1)
    d = tmp_path / "granite-q8"
    write_llm_stt_checkpoint(src, d, bits=8, group_size=32, conv="jax")
    pm = load_model(d, device="cpu")
    blocked = sys.modules.get("transformers", "absent")
    sys.modules["transformers"] = None
    try:
        jm = jax_load(str(d))
    finally:
        if blocked == "absent":
            del sys.modules["transformers"]
        else:
            sys.modules["transformers"] = blocked
    held = [n for n, m in pm.named_modules() if isinstance(m, QuantizedLinear)]
    assert len(held) == 7 * 2 + 1 and all(
        n.startswith("language_model") for n in held)
    jm._tokenizer, pm._tokenizer = tok2(), tok2()
    audio = _audio(7, 0.5)
    want = jm.generate(audio, max_tokens=MAX_TOKENS)
    got = pm.generate(audio, max_tokens=MAX_TOKENS)
    assert got.text == want.text and got.generation_tokens > 0


def test_post_load_hook_reads_only_the_local_directory(tmp_path,
                                                      monkeypatch):
    import sys
    import types

    from mlx_audio_tpu_torch.stt.models.granite_speech import (Model,
                                                               ModelConfig)

    m = Model(ModelConfig.from_dict(CFG), device="cpu")
    assert Model.post_load_hook(m, tmp_path)._tokenizer is None

    def broken(path, **kw):
        raise OSError(f"cannot read the tokenizer in {path}")

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=broken)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    (tmp_path / "tokenizer_config.json").write_text("{not json")
    with pytest.raises(OSError, match="tokenizer"):
        Model.post_load_hook(m, tmp_path)
