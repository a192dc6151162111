"""Qwen3-ForcedAligner of the PyTorch port against the JAX package, on the
CPU: the processor (the language tokenizers, the prompt with its
<timestamp> pairs, the LIS repair of non-monotonic timestamps, the parse),
the config, the one alignment forward, `generate` on one clip and on a
batch, `sanitize`, the loader; then the port's rules (a tokenizer is
needed; the result names its language).

Config: tests/test_forced_aligner.py's `tiny_cfg` and `FakeTok`, one
parameter tree drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`), bound into both packages; the JAX
package runs its own jitted encoder and forward. Logits at ATOL = 2e-4
(f32, summation order); words and timestamps equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402
from test_torch_prequantized import no_hf_tokenizer  # noqa: E402,F401

ATOL = 2e-4
CFG = dict(
    audio_config=dict(d_model=32, encoder_attention_heads=4,
                      encoder_layers=2, encoder_ffn_dim=64,
                      num_mel_bins=32, output_dim=32, n_window=50,
                      n_window_infer=400, conv_chunksize=500),
    text_config=dict(hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2,
                     head_dim=8, intermediate_size=64, vocab_size=400,
                     rope_theta=10000.0),
    audio_token_id=398, timestamp_token_id=397,
    timestamp_segment_time=80.0, classify_num=50)
TEXT = "hello world, it's the aligner again"


class FakeTok:
    """tests/test_forced_aligner.py::FakeTok."""

    def encode(self, text, add_special_tokens=False):
        out = []
        i = 0
        specials = {"<|audio_start|>": 396, "<|audio_pad|>": 398,
                    "<|audio_end|>": 395, "<timestamp>": 397}
        while i < len(text):
            for s, tid in specials.items():
                if text.startswith(s, i):
                    out.append(tid)
                    i += len(s)
                    break
            else:
                out.append(ord(text[i]) % 390)
                i += 1
        return out


@pytest.fixture(scope="module")
def pair():
    from mlx_audio_tpu.stt.models.qwen3_forced_aligner import Model as JModel
    from mlx_audio_tpu.stt.models.qwen3_forced_aligner import \
        ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.qwen3_forced_aligner import (
        Model, ModelConfig)

    jm = JModel(JConfig.from_dict(CFG))
    jm.bind(numpy_params(jm.init_params, 0))
    pm = load_jax_params(Model(ModelConfig.from_dict(CFG), device="cpu"),
                         flat_numpy(jm.params))
    jm._tokenizer = pm._tokenizer = FakeTok()
    return jm, pm


def _audio(seed: int, n: int) -> np.ndarray:
    return (np.random.RandomState(seed).randn(n) * 0.1).astype(np.float32)


# ---------------------------------------------------------------------------
# the processor and the config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text,language", [
    ("Hello, world! it's me", "English"), ("你好world再见", "Chinese"),
    ("abc你def  x-y 42", "English"), (TEXT, "French"), ("", "English")])
def test_processor_prompt_equals_jax(text, language):
    from mlx_audio_tpu.stt.models.qwen3_forced_aligner import \
        ForceAlignProcessor as JProc
    from mlx_audio_tpu_torch.stt.models.qwen3_forced_aligner import \
        ForceAlignProcessor

    assert ForceAlignProcessor().encode_timestamp(text, language) == \
        JProc().encode_timestamp(text, language)


def test_timestamp_repair_and_parse_equal_jax():
    """Monotonic, one-off and run anomalies, and random sequences."""
    from mlx_audio_tpu.stt.models.qwen3_forced_aligner import \
        ForceAlignProcessor as JProc
    from mlx_audio_tpu_torch.stt.models.qwen3_forced_aligner import \
        ForceAlignProcessor

    p, j = ForceAlignProcessor(), JProc()
    rs = np.random.RandomState(0)
    cases = [[0, 80, 160, 240], [0, 80, 10, 240, 320], [0, 5, 3, 1, 400],
             [400, 0, 0, 0], [], [7]]
    cases += [list(rs.randint(0, 50, n) * 80) for n in range(2, 24)]
    for c in cases:
        assert p.fix_timestamp(c) == j.fix_timestamp(c), c
    words = ["a", "b", "c"]
    ts = np.asarray([0, 80, 400, 160, 240, 320])
    assert p.parse_timestamp(words, ts) == j.parse_timestamp(words, ts)


def test_config_reads_the_thinker_config_as_jax():
    from mlx_audio_tpu.stt.models.qwen3_forced_aligner import \
        ModelConfig as JConfig
    from mlx_audio_tpu_torch.stt.models.qwen3_forced_aligner import \
        ModelConfig

    raw = {"model_type": "qwen3_forced_aligner",
           "thinker_config": {"timestamp_token_id": 11,
                              "timestamp_segment_time": 40.0,
                              "classify_num": 77, "audio_token_id": 12,
                              "text_config": {"hidden_size": 64}}}
    for cfg in (raw, {}):
        p, j = ModelConfig.from_dict(cfg), JConfig.from_dict(cfg)
        for k in ("model_type", "timestamp_token_id",
                  "timestamp_segment_time", "classify_num",
                  "audio_token_id"):
            assert getattr(p, k) == getattr(j, k), k
        assert vars(p.text_config) == vars(j.text_config)


# ---------------------------------------------------------------------------
# alignment
# ---------------------------------------------------------------------------


def test_align_logits_equal_jax(pair):
    """One forward over the prompt bucket: causal, the padded prompt rows
    masked as keys."""
    import jax.numpy as jnp

    jm, pm = pair
    feats, n_audio = pm.encode(_audio(0, 16000))
    words, text = pm.aligner_processor.encode_timestamp(TEXT, "English")
    ids = FakeTok().encode(text.replace("<|audio_pad|>",
                                        "<|audio_pad|>" * n_audio))
    n = len(ids)
    from mlx_audio_tpu_torch.stt.models.qwen3_asr.forced_aligner import \
        align_bucket

    pb = align_bucket(n)
    embeds = pm.prompt_embeds(ids, feats, pb)
    got = pm.align_logits(embeds, n)[0, :n].numpy()
    want = np.asarray(jm._align_fn(pb)(jm.params, jnp.asarray(
        embeds.numpy()), jnp.asarray([n])))[0, :n]
    np.testing.assert_allclose(got, want, atol=ATOL)


def _items(res):
    return [(it.text, it.start_time, it.end_time) for it in res]


def test_generate_timestamps_equal_jax(pair):
    jm, pm = pair
    audio = _audio(1, 16000)
    want = jm.generate(audio, text=TEXT, language="English")
    got = pm.generate(audio, text=TEXT, language="English")
    assert _items(got) == _items(want)
    assert [it.text for it in got] == ["hello", "world", "it's", "the",
                                       "aligner", "again"]
    assert got.segments == want.segments and got.text == want.text
    assert got.language == "English"
    for it in got:
        assert 0.0 <= it.start_time <= it.end_time


def test_batch_generate_equals_jax(pair):
    jm, pm = pair
    a, b = _audio(2, 8000), _audio(3, 12000)
    kw = dict(text=["one two", "three"], language="English")
    want = jm.generate([a, b], **kw)
    got = pm.generate([a, b], **kw)
    assert [_items(r) for r in got] == [_items(r) for r in want]
    assert [len(r) for r in got] == [2, 1]
    with pytest.raises(ValueError, match="batch size"):
        pm.generate([a, b], text=["one"], language=["English", "French"])


def test_generate_needs_a_tokenizer():
    from mlx_audio_tpu_torch.stt.models.qwen3_forced_aligner import (
        Model, ModelConfig)

    m = Model(ModelConfig.from_dict(CFG), device="cpu")
    with pytest.raises(RuntimeError, match="tokenizer"):
        m.generate(_audio(0, 16000), text="hi")


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def test_sanitize_keeps_the_timestamp_head(pair):
    jm, pm = pair
    rs = np.random.RandomState(4)
    raw = {"thinker.lm_head.weight": rs.randn(50, 32).astype(np.float32),
           "thinker.audio_tower.conv2d1.weight":
               rs.randn(480, 1, 3, 3).astype(np.float32)}
    got, want = pm.sanitize(dict(raw)), jm.sanitize(dict(raw))
    assert set(got) == set(want) == {"lm_head.weight",
                                     "audio_tower.conv2d1.weight"}
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_load_model_aligns_as_the_model_it_was_written_from(pair, tmp_path):
    """A dense directory (HF names, torch layouts) through the `load_model`
    router: the aligner, with the same timestamps."""
    from chip_smoke import write_asr_checkpoint
    from mlx_audio_tpu_torch.stt.models.qwen3_forced_aligner import Model
    from mlx_audio_tpu_torch.utils import load_model

    _, pm = pair
    d = tmp_path / "qwen3-forced-aligner"
    write_asr_checkpoint(pm, d)
    m = load_model(d, device="cpu")
    assert isinstance(m, Model) and m._tokenizer is None
    m._tokenizer = FakeTok()
    audio = _audio(1, 16000)
    assert _items(m.generate(audio, text=TEXT)) == _items(
        pm.generate(audio, text=TEXT))
