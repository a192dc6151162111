"""VibeVoice-ASR of the PyTorch port against the JAX package, on the CPU:
the causal tokenizer encoders (the true length against JAX's bucket, its
valid rows; the FFN in row slices), the speech features, the audio
preprocessing, the prompt, greedy `generate` (with the repetition penalty
over its 100-token history too) and the stream, the JSON parser,
`sanitize` on HF-named torch-layout and MLX-layout checkpoints, an
MLX-packed 8-bit LM through both packages' loaders; then the port's own
rules (a seeded sampled run and its filters, the tokenizer hook).

Config: tests/test_vibevoice_asr.py's `tiny_cfg` and its `FakeTok`; one
parameter tree drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`), bound into both packages. The JAX
package runs its own jitted encoders and decode; here its
`tokenizer_encode` is jitted. Encoder rows and features at ATOL = 2e-4
(f32, summation order); greedy tokens and text equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402
from test_torch_voxtral import one_torch_thread  # noqa: E402,F401

ATOL = 2e-4
MAX_TOKENS = 24

TOK = dict(vae_dim=8, encoder_n_filters=4, encoder_ratios=[4, 2],
           encoder_depths="1-1-2")
CFG = dict(acoustic_tokenizer_config=dict(TOK),
           semantic_tokenizer_config=dict(TOK, vae_dim=12),
           decoder_config=dict(vocab_size=151700, hidden_size=32,
                               intermediate_size=64, num_hidden_layers=2,
                               num_attention_heads=4,
                               num_key_value_heads=2))


def fake_tok():
    from test_vibevoice_asr import FakeTok

    return FakeTok()


def make_pair(seed=0, tok=True):
    import mlx_audio_tpu.stt.models.vibevoice_asr as jv
    import mlx_audio_tpu_torch.stt.models.vibevoice_asr as pv
    from mlx_audio_tpu_torch.model import load_jax_params

    jm = jv.Model(jv.ModelConfig.from_dict(CFG))
    jm.bind(numpy_params(jm.init_params, seed))
    pm = load_jax_params(pv.Model(pv.ModelConfig.from_dict(CFG),
                                  device="cpu"), flat_numpy(jm.params))
    if tok:
        jm.tokenizer, pm.tokenizer = fake_tok(), fake_tok()
    return jm, pm


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _wav(seed: int, n: int) -> np.ndarray:
    return (np.random.RandomState(seed).randn(n) * 0.1).astype(np.float32)


def _jax_encode(jm, which: str, wav: np.ndarray) -> np.ndarray:
    import jax

    from mlx_audio_tpu.stt.models.vibevoice_asr.vibevoice_asr import \
        tokenizer_encode

    cfg = getattr(jm.config, which)
    return np.asarray(jax.jit(lambda p, a: tokenizer_encode(
        p[f"{which}_tokenizer"]["encoder"], cfg, a))(jm.params, wav[None]))


def _port_encode(pm, which: str, wav: np.ndarray) -> np.ndarray:
    from mlx_audio_tpu_torch.stt.models.vibevoice_asr.vibevoice_asr import \
        tokenizer_encode

    with torch.inference_mode():
        return tokenizer_encode(
            getattr(pm, f"{which}_tokenizer").encoder,
            getattr(pm.config, which), torch.from_numpy(wav)[None]).numpy()


# ---------------------------------------------------------------------------
# the encoders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["acoustic", "semantic"])
def test_tokenizer_encoder_equals_jax(pair, which):
    """100 samples: ceil(100 / 8) = 13 rows."""
    jm, pm = pair
    wav = _wav(0, 100)
    want = _jax_encode(jm, which, wav)
    got = _port_encode(pm, which, wav)
    assert got.shape == want.shape == (
        1, 13, getattr(pm.config, which).vae_dim)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n", [64, 61])
def test_true_length_against_jax_bucket(pair, n):
    """n samples run as they are equal JAX's encoder on the same n; against
    JAX's zero-padded 128 the first speech_token_count - 1 rows agree (the
    pyramid is causal), and the last does too where n is a multiple of the
    hop (8). At 61 it departs: the second stage's strided conv reads past
    the first stage's 16 rows, which the unpadded run pads with zeros and
    JAX's bucket fills with the first stage's output on zero samples."""
    from mlx_audio_tpu_torch.stt.models.vibevoice_asr.vibevoice_asr import \
        speech_token_count

    jm, pm = pair
    wav = _wav(1, n)
    padded = np.zeros(128, np.float32)
    padded[:n] = wav
    k = speech_token_count(n, [4, 2])
    got = _port_encode(pm, "acoustic", wav)
    assert got.shape[1] == k
    np.testing.assert_allclose(got, _jax_encode(jm, "acoustic", wav),
                               atol=ATOL)
    bucket = _jax_encode(jm, "acoustic", padded)[:, :k]
    np.testing.assert_allclose(got[:, :-1], bucket[:, :-1], atol=ATOL)
    last = np.abs(got[:, -1] - bucket[:, -1]).max()
    assert (last < ATOL) == (n % 8 == 0), last


def test_ffn_row_slices_do_not_change_the_result(pair, monkeypatch):
    from mlx_audio_tpu_torch.stt.models.vibevoice_asr import vibevoice_asr

    _, pm = pair
    wav = _wav(2, 300)
    whole = _port_encode(pm, "semantic", wav)
    monkeypatch.setattr(vibevoice_asr, "FFN_ROWS", 7)
    np.testing.assert_allclose(_port_encode(pm, "semantic", wav), whole,
                               atol=1e-6)


@pytest.mark.parametrize("n", [200, 30000])
def test_speech_features_equal_jax(pair, n):
    """JAX pads to SAMPLE_BUCKETS (24,000 and 48,000 here)."""
    jm, pm = pair
    wav = _wav(3, n)
    want = np.asarray(jm.encode_speech(wav))
    got = pm.encode_speech(wav)
    assert got.shape == want.shape == (-(-n // 8), 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_preprocess_equals_jax(pair, tmp_path):
    """-25 dBFS normalisation and a resample from 16 kHz; a WAV path read
    at 24 kHz without normalisation."""
    from mlx_audio_tpu_torch import audio_io

    jm, pm = pair
    wav = _wav(4, 1600) * 30
    for sr in (None, 16000):
        np.testing.assert_allclose(pm._preprocess_audio(wav, sr),
                                   jm._preprocess_audio(wav, sr), atol=1e-6)
    path = tmp_path / "a.wav"
    audio_io.write(path, wav / 40, 24000)
    np.testing.assert_allclose(pm._preprocess_audio(str(path)),
                               jm._preprocess_audio(str(path)), atol=1e-6)


# ---------------------------------------------------------------------------
# prompt and decoding
# ---------------------------------------------------------------------------


def test_prompt_equals_jax(pair):
    jm, pm = pair
    for args in ((5, 1.23, None), (2, 1.0, "two speakers")):
        assert pm._build_prompt_ids(*args) == jm._build_prompt_ids(*args)
    j0, p0 = make_pair(tok=False)
    assert p0._build_prompt_ids(3, 0.5, None) == \
        j0._build_prompt_ids(3, 0.5, None)


@pytest.fixture(scope="module")
def jax_runs(pair):
    jm, _ = pair
    wav = _wav(5, 400)
    kw = dict(max_tokens=MAX_TOKENS)
    return wav, {"greedy": jm.generate(wav, **kw),
                 "rep": jm.generate(wav, repetition_penalty=1.3, **kw),
                 "stream": list(jm.stream_transcribe(wav, max_tokens=8))}


@pytest.mark.parametrize("run", ["greedy", "rep"])
def test_greedy_generate_equals_jax(pair, jax_runs, run):
    _, pm = pair
    wav, runs = jax_runs
    got = pm.generate(wav, max_tokens=MAX_TOKENS,
                      repetition_penalty=1.3 if run == "rep" else 1.0)
    want = runs[run]
    assert want.generation_tokens > 0
    assert got.text == want.text
    assert (got.prompt_tokens, got.generation_tokens, got.segments) == (
        want.prompt_tokens, want.generation_tokens, want.segments)
    assert pm.last_run["audio_tokens"] == 50


def test_repetition_history_is_100_tokens(pair):
    from mlx_audio_tpu_torch.stt.models.llm_stt import decode_fns

    _, pm = pair
    fns = decode_fns(pm.language_model, 10, 4, (0.0, 0, 1.0, 0.0, 1.3, 20,
                                                1), (1,), min_context=100)
    assert fns.use_rep and fns.rep_ctx == 100


def test_stream_equals_jax(pair, jax_runs):
    _, pm = pair
    wav, runs = jax_runs
    got = list(pm.stream_transcribe(wav, max_tokens=8))
    assert got == runs["stream"] and len(got) == 8


def test_sampled_run_is_seeded_and_keeps_the_rules(pair, jax_runs):
    _, pm = pair
    wav, runs = jax_runs
    kw = dict(max_tokens=MAX_TOKENS, temperature=1.0)
    a = pm.generate(wav, seed=3, **kw).text
    assert pm.generate(wav, seed=3, **kw).text == a
    for rule in (dict(top_k=1), dict(min_p=1.0), dict(top_p=1e-6)):
        assert pm.generate(wav, seed=5, **kw, **rule).text == \
            runs["greedy"].text


@pytest.mark.parametrize("text", [
    '```json\n[{"Start time": 0.0, "End time": 1.5, "Speaker ID": 1, '
    '"Content": "hi"}]\n```',
    'prefix {"Start": 1, "End": 2, "Content": "x"} suffix',
    "no json here", '[{"Speaker": 2}, 5, {"nothing": 1}]'])
def test_parse_transcription_equals_jax(text):
    from mlx_audio_tpu.stt.models.vibevoice_asr import Model as J
    from mlx_audio_tpu_torch.stt.models.vibevoice_asr import Model as P

    assert P.parse_transcription(text) == J.parse_transcription(text)


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def _hf_names(state: dict) -> dict:
    """The tree's names as the HF checkpoint holds them."""
    import re

    out = {}
    for k, v in state.items():
        k = re.sub(r"\.downsample_layers\.(\d+)\.conv\.",
                   r".downsample_layers.\1.0.conv.conv.", k)
        k = k.replace(".head.conv.", ".head.conv.conv.")
        k = k.replace(".mixer.conv.conv.", ".mixer.conv.conv.conv.")
        k = k.replace("language_model.model.", "language_model.")
        k = k.replace("language_model.lm_head.", "lm_head.")
        out["model." + k] = v
    return out


@pytest.mark.parametrize("layout", ["torch", "mlx"])
def test_hf_checkpoint_binds_from_each_conv_layout(pair, tmp_path, layout):
    """HF names (the acoustic decoder's weights beside them, dropped) with
    torch and with MLX conv layouts bind to the same weights; on the torch
    one JAX's sanitize gives the same tree."""
    from safetensors.numpy import save_file

    from chip_smoke import write_llm_stt_checkpoint
    from mlx_audio_tpu_torch.stt.utils import load_model
    from mlx_audio_tpu_torch.utils import load_weights

    jm, pm = pair
    d = tmp_path / layout
    write_llm_stt_checkpoint(pm, d, conv=layout)
    w = _hf_names(load_weights(d))
    w["model.acoustic_tokenizer.decoder.x.weight"] = np.zeros(
        (2, 2, 2), np.float32)
    save_file(w, str(d / "model.safetensors"))
    got = load_model(d, device="cpu")
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(got.state_dict()[k].numpy(),
                                      v.numpy(), err_msg=k)
    if layout == "torch":
        mine, want = pm.sanitize(dict(w)), jm.sanitize(dict(w))
        assert set(mine) == set(want)
        for k in mine:
            np.testing.assert_array_equal(mine[k], np.asarray(want[k]))


def test_packed_q8_lm_generates_as_jax(tmp_path):
    """The LM's linears and token table MLX-packed at 8 bits (group 32),
    the encoders and connectors dense, the convs in the JAX tree's layout
    (JAX's sanitize leaves a checkpoint without `model.` names as it is),
    through both packages' STT loaders: greedy text equal to JAX's."""
    import sys

    from chip_smoke import write_llm_stt_checkpoint
    from mlx_audio_tpu.stt.utils import load_model as jax_load
    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.stt.utils import load_model

    _, src = make_pair(seed=1)
    d = tmp_path / "vibevoice-asr-q8"
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
    jm.tokenizer, pm.tokenizer = fake_tok(), fake_tok()
    wav = _wav(7, 400)
    want = jm.generate(wav, max_tokens=MAX_TOKENS)
    got = pm.generate(wav, max_tokens=MAX_TOKENS)
    assert got.text == want.text and got.generation_tokens > 0


def test_post_load_hook_sets_the_template_and_raises(tmp_path, monkeypatch):
    """No tokenizer files: no tokenizer and the default speech ids; a
    tokenizer gets the ChatML template and the ids it names; files that
    fail to load raise, where JAX's hook swallows the error."""
    import sys
    import types

    from mlx_audio_tpu_torch.stt.models.vibevoice_asr import (Model,
                                                              ModelConfig)

    m = Model(ModelConfig.from_dict(CFG), device="cpu")
    assert Model.post_load_hook(m, tmp_path).tokenizer is None
    assert m._speech_pad_id == 151648

    class Tok:
        def convert_tokens_to_ids(self, s):
            return {"<|object_ref_start|>": 7, "<|object_ref_end|>": 8,
                    "<|box_start|>": 9}[s]

    calls = []

    def load(path, **kw):
        calls.append(kw)
        if calls[1:]:
            raise OSError(f"cannot read the tokenizer in {path}")
        return Tok()

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=load)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    (tmp_path / "tokenizer.json").write_text("{}")
    Model.post_load_hook(m, tmp_path)
    assert (m._speech_start_id, m._speech_end_id, m._speech_pad_id) == \
        (7, 8, 9)
    assert "<|im_start|>" in m.tokenizer.chat_template
    with pytest.raises(OSError, match="tokenizer"):
        Model.post_load_hook(m, tmp_path)
    assert calls == [{"trust_remote_code": True}] * 2
