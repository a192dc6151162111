"""SenseVoice of the PyTorch port against the JAX package, on the CPU: the
cases of tests/test_sensevoice.py (LFR, am.mvn, normalised log-probs,
bucket invariance, `generate` with a token list and the language query,
`sanitize`), each held to the JAX package's on one weight set; the
departures pinned (the unpadded run against JAX's bucketed one, f32
scores in a bf16 model, the tokenizer hook that raises); and the loaders
(`stt.utils` and the top-level router on a tiny directory).

Config: tests/test_sensevoice.py's `_cfg` (vocabulary 64, input 40, d16
with 2 heads, 2 + 1 blocks, kernel 5, n_mels 8, LFR 5/3), with
`sanm_shift` 0 and 2; one parameter set drawn with numpy over JAX's
shapes (`test_torch_mimi.numpy_params`), the JAX side jitted. Log-probs
at ATOL = 2e-4 (f32, summation order; tests/test_torch_parity.py:19); CTC
ids and rich tags equal.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4


def cfg(shift=0):
    return dict(vocab_size=64, input_size=40,
                encoder_conf=dict(output_size=16, attention_heads=2,
                                  linear_units=32, num_blocks=2, tp_blocks=1,
                                  kernel_size=5, sanm_shfit=shift),
                frontend_conf=dict(n_mels=8, lfr_m=5, lfr_n=3))


def sv_pair(c, seed=0):
    from mlx_audio_tpu.stt.models.sensevoice import Model as JModel
    from mlx_audio_tpu.stt.models.sensevoice import ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.sensevoice import Model, ModelConfig

    jm = JModel(JConfig.from_dict(c))
    jm.bind(numpy_params(jm.init_params, seed))
    pm = load_jax_params(Model(ModelConfig.from_dict(c), device="cpu"),
                         flat_numpy(jm.params))
    return jm, pm


@pytest.fixture(scope="module")
def pair():
    return sv_pair(cfg())


def jax_forward(jm, speech, n):
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.stt.models.sensevoice.sensevoice import \
        sensevoice_forward

    return np.asarray(jax.jit(lambda p, s, ln: sensevoice_forward(
        p, jm.config, s, ln))(jm.params, jnp.asarray(speech),
                              jnp.asarray([n])))


def test_lfr_and_am_mvn_are_jax_s(tmp_path):
    from mlx_audio_tpu.stt.models.sensevoice import sensevoice as J
    from mlx_audio_tpu_torch.stt.models.sensevoice import sensevoice as P

    f = np.arange(40, dtype=np.float32).reshape(10, 4)
    out = P.apply_lfr(f, lfr_m=7, lfr_n=6)
    assert out.shape == (2, 28)
    np.testing.assert_array_equal(out[0, 12:16], f[0])
    np.testing.assert_array_equal(out[0, 16:20], f[1])
    for m, n in ((7, 6), (5, 3), (1, 1)):
        np.testing.assert_array_equal(P.apply_lfr(f, m, n),
                                      J.apply_lfr(f, m, n))
    p = tmp_path / "am.mvn"
    p.write_text("<Nnet>\n<AddShift> 3 3\n<LearnRateCoef> 0 [ -1 -2 -3 ]\n"
                 "<Rescale> 3 3\n<LearnRateCoef> 0 [ 0.5 0.5 0.5 ]\n"
                 "</Nnet>\n")
    for a, b in zip(P.parse_am_mvn(p), J.parse_am_mvn(p)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shift", [0, 2])
def test_log_probs_match_jax(shift):
    """The encoder and CTC head on 20 rows (a shifted memory too):
    log-probs within ATOL of JAX's, each row normalised."""
    jm, pm = sv_pair(cfg(shift), seed=shift)
    speech = np.random.RandomState(0).randn(20, 40).astype(np.float32)
    got = pm.log_probs(torch.from_numpy(speech)).numpy()
    want = jax_forward(jm, speech[None], 20)[0]
    assert got.shape == (20, 64)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-4)


def test_unpadded_run_equals_jax_bucketed(pair):
    """A departure: the port runs the frames the audio has; JAX's
    FRAME_BUCKETS pad under a mask. On the valid rows the two agree
    (tests/test_sensevoice.py's bucket invariance)."""
    from mlx_audio_tpu.stt.models.sensevoice.sensevoice import \
        FRAME_BUCKETS

    jm, pm = pair
    speech = np.random.RandomState(1).randn(12, 40).astype(np.float32)
    padded = np.zeros((1, FRAME_BUCKETS[0], 40), np.float32)
    padded[0, :12] = speech
    want = jax_forward(jm, padded, 12)[0, :12]
    np.testing.assert_allclose(
        pm.log_probs(torch.from_numpy(speech)).numpy(), want, atol=ATOL)


def test_bf16_scores_stay_f32(pair):
    """A departure made to keep JAX's numerics: in a bf16 model the
    attention's scores and softmax run in f32 (JAX's f32 mask bias
    promotes them), so the probabilities sum to 1 in f32 and every output
    is finite; bf16 log-probs stay within 0.1 of f32's."""
    import copy

    _, pm = pair
    speech = torch.from_numpy(
        np.random.RandomState(2).randn(30, 40).astype(np.float32))
    want = pm.log_probs(speech)
    bf = copy.deepcopy(pm).astype(torch.bfloat16)
    layer = bf.encoder.encoders[0]
    seen = {}
    orig = torch.softmax

    def spy(x, dim):
        seen.setdefault("dtype", x.dtype)
        return orig(x, dim=dim)

    torch.softmax = spy
    try:
        x = layer.norm1(torch.randn(1, 30, 16).to(torch.bfloat16))
        out = layer.attention(x)
    finally:
        torch.softmax = orig
    assert seen["dtype"] == torch.float32 and out.dtype == torch.bfloat16
    got = bf.log_probs(speech)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) < 0.1


@pytest.mark.parametrize("language,use_itn", [("auto", False), ("en", True)])
def test_generate_ids_text_and_tags_equal_jax(pair, language, use_itn):
    """`generate` end to end with a token list (tests/test_sensevoice.py's
    TestGenerate): the text, the language and the rich tags equal JAX's
    for each query."""
    jm, pm = pair
    tokens = [f"tok{i}" if i else "<blank>" for i in range(64)]
    jm._token_list = pm._token_list = tokens
    audio = (0.1 * np.random.RandomState(2).randn(16000)).astype(np.float32)
    got = pm.generate(audio, language=language, use_itn=use_itn)
    want = jm.generate(audio, language=language, use_itn=use_itn)
    assert got.text == want.text and got.language == want.language
    assert got.segments == want.segments
    assert {"text", "language", "emotion", "event"} <= set(got.segments[0])
    assert pm.last_run["frames"] == 4 + 33
    ids, rich = pm.transcribe_ids(audio, language=language, use_itn=use_itn)
    assert ids and rich == {k: got.segments[0][k]
                            for k in ("language", "emotion", "event")}


def test_features_match_jax(pair, tmp_path):
    """The fbank -> LFR -> CMVN front end against JAX's, with an am.mvn."""
    jm, pm = pair
    from mlx_audio_tpu.stt.models.sensevoice.sensevoice import parse_am_mvn

    rs = np.random.RandomState(3)
    cmvn = ((rs.randn(40) * 5).astype(np.float32),
            (rs.rand(40) + 0.5).astype(np.float32))
    audio = (0.1 * rs.randn(8000)).astype(np.float32)
    for c in (None, cmvn):
        jm._cmvn = pm._cmvn = c
        np.testing.assert_allclose(pm._extract_features(audio),
                                   jm._extract_features(audio), atol=ATOL)
    jm._cmvn = pm._cmvn = None
    assert parse_am_mvn


def test_sanitize_layouts_match_jax(pair):
    jm, pm = pair
    w = {"ctc.ctc_lo.weight": np.ones((64, 16), np.float32),
         "encoder.encoders.0.self_attn.fsmn_block.weight":
             np.arange(80, dtype=np.float32).reshape(16, 1, 5)}
    got, want = pm.sanitize(w), jm.sanitize(w)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    again = pm.sanitize(got)           # a converted checkpoint passes
    for k in got:
        np.testing.assert_array_equal(again[k], got[k])


def write_dir(pm, d, c, extra=None):
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(c, model_type="sensevoice")))
    state = {k: v.numpy() for k, v in pm.state_dict().items()}
    state["ctc.ctc_lo.weight"] = state.pop("ctc_lo.weight")
    state["ctc.ctc_lo.bias"] = state.pop("ctc_lo.bias")
    np.savez(d / "model.npz", **state)
    for name, text in (extra or {}).items():
        (d / name).write_text(text)


def test_loaders_route_a_tiny_directory(pair, tmp_path):
    """A FunASR-named directory (torch layouts, `ctc.ctc_lo.`, am.mvn,
    tokens.json) through `stt.utils.load_model` and the top-level router:
    the weights, the CMVN and the token list, and `generate` equal to the
    JAX model's with the same front end."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.stt.models.sensevoice import Model
    from mlx_audio_tpu_torch.stt.utils import PORTED, load_model

    jm, pm = pair
    tokens = [f"t{i}" for i in range(64)]
    mvn = ("<Nnet>\n<AddShift> 40 40\n<LearnRateCoef> 0 [" + " -1" * 40
           + " ]\n<Rescale> 40 40\n<LearnRateCoef> 0 [" + " 0.1" * 40
           + " ]\n</Nnet>\n")
    d = tmp_path / "SenseVoiceSmall-tiny"
    write_dir(pm, d, cfg(), {"am.mvn": mvn, "tokens.json": json.dumps(tokens)})
    assert "sensevoice" in PORTED
    audio = (0.1 * np.random.RandomState(4).randn(8000)).astype(np.float32)
    jm._token_list = tokens
    jm._cmvn = (np.full(40, -1, np.float32), np.full(40, 0.1, np.float32))
    want = jm.generate(audio).text
    jm._cmvn = None
    for loaded in (load_model(d, device="cpu"),
                   mlx_audio_tpu_torch.load_model(d, device="cpu")):
        assert isinstance(loaded, Model) and loaded._token_list == tokens
        for k, v in pm.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), k
        assert loaded.generate(audio).text == want


def test_tokenizer_hook_raises_where_no_tokenizer_loads(pair, tmp_path):
    """A departure: a BPE model that cannot load (no sentencepiece here,
    or a broken file) without a tokens.json raises; JAX's hook leaves no
    tokenizer. Without tokenizer files there is none, as in JAX."""
    from mlx_audio_tpu_torch.stt.models.sensevoice import Model
    from mlx_audio_tpu_torch.stt.models.sensevoice.sensevoice import \
        BPE_MODEL

    (tmp_path / BPE_MODEL).write_bytes(b"not a model")
    m = Model(cfg(), device="cpu")
    with pytest.raises(Exception):
        Model.post_load_hook(m, tmp_path)
    (tmp_path / BPE_MODEL).unlink()
    assert Model.post_load_hook(m, tmp_path)._tokenizer is None
