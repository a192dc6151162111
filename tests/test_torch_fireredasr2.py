"""FireRedASR2-AED of the PyTorch port against the JAX package, on the
CPU: the cases of tests/test_fireredasr2.py (subsampling and shape, the
relative positions, pad masking, the beam search deterministic, beam 1
and 3, the EOS penalty and max_len, confidences, `sanitize`, the
detokenizer), each held to the JAX package's on one weight set; the
departure pinned (the unpadded encoder against JAX's bucketed one); the
loaders on a tiny directory with its `cmvn.json` and `dict.txt`.

Config: tests/test_fireredasr2.py's `tiny_cfg` (idim 32, 50 ids, d32
with 4 heads, 2 + 2 layers, conv kernel 9); one parameter set drawn with
numpy over JAX's shapes (`test_torch_mimi.numpy_params`), the JAX side
jitted. The encoder at ATOL = 2e-4 (f32, summation order;
tests/test_torch_parity.py:19); beam tokens and the ranking equal, beam
scores within 1e-3 (sums of up to 32 f32 log-probs).

EOS is biased so that beams end at different lengths (5, 6 and 12 steps
at beam 3) and the GNMT length penalty decides the ranking: the output
norm's bias is 4 x EOS's projection row, which adds about 1.3 to its
logit. The beam scores then sit 3 or more apart, and no candidate is near
a tie. On a tie both sides would keep the lower index first
(`jax.lax.top_k` by its contract, `torch.topk` on the CPU in practice);
the comparisons here do not depend on it.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
CFG = dict(idim=32, odim=50, d_model=32, sos_id=3, eos_id=4,
           encoder=dict(n_layers=2, n_head=4, d_model=32, kernel_size=9),
           decoder=dict(n_layers=2, n_head=4, d_model=32))
EOS_BIAS = 4.0


def fr_pair(eos_bias=0.0, seed=0):
    import jax.numpy as jnp

    from mlx_audio_tpu.stt.models.fireredasr2 import Model as JModel
    from mlx_audio_tpu.stt.models.fireredasr2 import ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.fireredasr2 import Model, ModelConfig

    jm = JModel(JConfig.from_dict(CFG))
    p = numpy_params(jm.init_params, seed)
    w = np.asarray(p["decoder"]["tgt_word_prj"]["weight"])
    p["decoder"]["layer_norm_out"]["bias"] = jnp.asarray(w[4] * eos_bias)
    jm.bind(p)
    pm = load_jax_params(Model(ModelConfig.from_dict(CFG), device="cpu"),
                         flat_numpy(jm.params))
    return jm, pm


@pytest.fixture(scope="module")
def pair():
    return fr_pair(EOS_BIAS)


def jax_encoder(jm, mel, valid=None):
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.stt.models.fireredasr2.fireredasr2 import \
        encoder_forward

    return np.asarray(jax.jit(lambda p, x, v: encoder_forward(
        p, jm.config, x, v))(jm.params, jnp.asarray(mel),
                             None if valid is None else jnp.asarray(valid)))


def audio(seed, n=8000):
    return (np.random.RandomState(seed).randn(n) * 0.1).astype(np.float32)


def test_encoder_subsampling_and_shape_match_jax(pair):
    from mlx_audio_tpu_torch.stt.models.fireredasr2.fireredasr2 import \
        sub_lengths

    jm, pm = pair
    mel = np.random.RandomState(0).randn(100, 32).astype(np.float32)
    got = pm.encode(mel).numpy()
    assert got.shape == (1, sub_lengths(100), 32) == (1, 25, 32)
    np.testing.assert_allclose(got, jax_encoder(jm, mel[None]), atol=ATOL)


def test_rel_pe_and_rel_shift_are_jax_s():
    """The relative positions (the centre row is position 0) and
    FireRed's shift, which keeps t2 // 2 + 1 columns."""
    import jax.numpy as jnp

    from mlx_audio_tpu.stt.models.fireredasr2 import fireredasr2 as J
    from mlx_audio_tpu_torch.stt.models.fireredasr2 import fireredasr2 as P

    pe = P._rel_pe(5, 8)[0]
    assert pe.shape == (9, 8)
    np.testing.assert_allclose(pe[4, 0::2], 0.0, atol=1e-7)
    np.testing.assert_allclose(pe[4, 1::2], 1.0, atol=1e-7)
    np.testing.assert_array_equal(P._rel_pe(7, 16), J._rel_pe(7, 16))
    x = np.random.RandomState(1).randn(2, 3, 6, 11).astype(np.float32)
    got = P._rel_shift(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, 6, 6)
    np.testing.assert_array_equal(got, np.asarray(J._rel_shift(
        jnp.asarray(x))))


def test_encoder_unpadded_equals_jax_bucketed(pair):
    """A departure: the port runs the features' own frames; JAX pads them
    to MEL_BUCKETS and masks (keys and the conv module's rows). On the
    valid rows the two agree (tests/test_fireredasr2.py's pad masking)."""
    from mlx_audio_tpu_torch.stt.models.fireredasr2.fireredasr2 import \
        sub_lengths

    jm, pm = pair
    mel = np.random.RandomState(1).randn(60, 32).astype(np.float32)
    padded = np.zeros((1, 128, 32), np.float32)
    padded[0, :60] = mel
    n = sub_lengths(60)
    want = jax_encoder(jm, padded, np.asarray([60], np.int32))[:, :n]
    np.testing.assert_allclose(pm.encode(mel).numpy(), want, atol=ATOL)


def _jax_beam(jm, feats, beam, max_decode, smoothing=1.25, eos_pen=1.0):
    import jax.numpy as jnp

    from mlx_audio_tpu.stt.models.fireredasr2.fireredasr2 import _bucket

    t = feats.shape[0]
    tb = _bucket(t)
    pad = np.zeros((1, tb, feats.shape[1]), np.float32)
    pad[0, :t] = feats
    enc_fn, beam_fn = jm._beam_fns(tb, beam, max_decode, smoothing, eos_pen)
    enc = enc_fn(jm.params, jnp.asarray(pad), jnp.asarray([t], jnp.int32))
    ys, scores, conf, steps = beam_fn(jm.params, enc,
                                      jnp.int32(jm._sub_len(t)))
    return np.asarray(ys), np.asarray(scores), np.asarray(conf), int(steps)


@pytest.mark.parametrize("beam", [1, 3])
def test_beam_tokens_scores_and_ranking_equal_jax(pair, beam):
    """Greedy (beam 1) and beam 3 on the same features: every
    hypothesis's tokens, the steps run, the scores (1e-3) and the
    confidences equal JAX's; then `generate`'s text, length and
    confidence, chosen by the length penalty's ranking."""
    jm, pm = pair
    x = audio(2)
    feats = pm._extract_fbank(x)
    np.testing.assert_allclose(feats, jm._extract_fbank(x), atol=ATOL)
    out = pm.generate(x, beam_size=beam)
    run = pm.last_run
    ys, scores, conf, steps = _jax_beam(jm, feats, beam, run["max_decode"])
    np.testing.assert_array_equal(run["ys"], ys)
    assert run["steps"] == steps
    np.testing.assert_allclose(run["scores"], scores, atol=1e-3)
    want = jm.generate(x, beam_size=beam)
    assert (out.text, out.generation_tokens) == (want.text,
                                                 want.generation_tokens)
    assert out.segments == want.segments
    lens = sorted(int((r[1:] != 4).sum()) for r in ys)
    assert lens == ([12] if beam == 1 else [5, 6, 12])
    assert 0.0 <= out.segments[0]["confidence"] <= 1.0


def test_generate_deterministic_and_knobs_equal_jax(pair):
    """tests/test_fireredasr2.py's determinism, beam 2, the EOS penalty
    with max_len, and length_penalty 0 (the raw score's ranking): each
    equal to JAX's."""
    jm, pm = pair
    x = audio(3)
    a = pm.generate(x, beam_size=2)
    assert a.text == pm.generate(x, beam_size=2).text
    for kw in (dict(beam_size=2), dict(beam_size=2, max_len=5,
                                       eos_penalty=2.0),
               dict(beam_size=3, length_penalty=0.0),
               dict(beam_size=3, softmax_smoothing=1.0)):
        got, want = pm.generate(x, **kw), jm.generate(x, **kw)
        assert (got.text, got.generation_tokens, got.segments) == \
            (want.text, want.generation_tokens, want.segments), kw
    assert pm.generate(x, beam_size=2, max_len=5).generation_tokens <= 5


def test_unbiased_beam_runs_to_the_bucket_cap_as_jax():
    """Without the bias no beam stops: every one runs to max_decode,
    min(sub_lengths(bucket), 448), the bucket of 51 frames being 128."""
    jm, pm = fr_pair()
    x = audio(4)
    got, want = pm.generate(x, beam_size=3), jm.generate(x, beam_size=3)
    assert got.text == want.text
    assert pm.last_run["max_decode"] == 32 == pm.last_run["steps"]


def test_sanitize_matches_jax_and_reads_layouts(pair):
    jm, pm = pair
    rs = np.random.RandomState(5)
    w = {"encoder.input_preprocessor.conv.0.weight":
         rs.randn(32, 1, 3, 3).astype(np.float32),
         "encoder.input_preprocessor.conv.2.weight":
         rs.randn(32, 32, 3, 3).astype(np.float32),
         "encoder.layer_stack.0.ffn1.net.1.weight":
         rs.randn(128, 32).astype(np.float32),
         "encoder.layer_stack.0.conv.depthwise_conv.weight":
         rs.randn(64, 1, 9).astype(np.float32),
         "encoder.layer_stack.0.conv.pointwise_conv1.weight":
         rs.randn(128, 32, 1).astype(np.float32),
         "decoder.tgt_word_emb.weight": rs.randn(50, 32).astype(np.float32)}
    got, want = pm.sanitize(w), jm.sanitize(w)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["encoder.input_preprocessor.conv1.weight"].shape == (3, 3, 1,
                                                                      32)
    # the JAX tree's own layouts pass unchanged (JAX's would transpose)
    again = pm.sanitize(got)
    for k in got:
        np.testing.assert_array_equal(again[k], got[k])


def test_detokenize_is_jax_s(pair):
    jm, pm = pair
    toks = ["<blank>", "▁he", "llo", "<sil>", " ", "WORLD"]
    jm._tokenizer = pm._tokenizer = toks
    try:
        assert pm._detokenize([1, 2, 4, 5, 0, 3]) == "hello world" == \
            jm._detokenize([1, 2, 4, 5, 0, 3])
    finally:
        jm._tokenizer = pm._tokenizer = None
    assert pm._detokenize([7, 8]) == "7 8"


def test_loaders_route_a_tiny_directory(pair, tmp_path):
    """FireRed's names and torch layouts (`conv.0.`, `net.1.`, no
    `tgt_word_prj`: tied to the embedding), `cmvn.json` and `dict.txt`
    through `stt.utils.load_model` and the top-level router: the text of
    JAX's model loaded from the same directory."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu.stt.utils import load_model as jax_load
    from mlx_audio_tpu_torch.model import jax_params
    from mlx_audio_tpu_torch.stt.models.fireredasr2 import Model
    from mlx_audio_tpu_torch.stt.utils import PORTED, load_model

    _, pm = pair
    ckpt = {}
    for k, v in jax_params(pm).items():
        v = v.numpy()
        if k == "decoder.tgt_word_prj.weight":
            continue
        if k.endswith("weight") and v.ndim == 4:
            v = np.transpose(v, (3, 2, 0, 1))
        elif k.endswith("weight") and v.ndim == 3:
            v = np.transpose(v, (2, 1, 0))
        k = k.replace("preprocessor.conv1.", "preprocessor.conv.0.") \
            .replace("preprocessor.conv2.", "preprocessor.conv.2.")
        ckpt[k.replace(".net_", ".net.")] = v
    d = tmp_path / "FireRedASR2-AED-tiny"
    d.mkdir()
    np.savez(d / "model.npz", **ckpt)
    (d / "config.json").write_text(json.dumps(dict(CFG,
                                                   model_type="fireredasr2")))
    rs = np.random.RandomState(6)
    (d / "cmvn.json").write_text(json.dumps({
        "means": (rs.randn(32) * 2).tolist(),
        "istd": (rs.rand(32) + 0.5).tolist()}))
    (d / "dict.txt").write_text("\n".join(
        ["<blank> 0", "<sil> 1", "<space> 2"]
        + [f"w{i} {i}" for i in range(3, 50)]), encoding="utf8")
    assert "fireredasr2" in PORTED
    jm = jax_load(str(d))
    x = audio(7)
    want = jm.generate(x, beam_size=3).text
    for loaded in (load_model(d, device="cpu"),
                   mlx_audio_tpu_torch.load_model(d, device="cpu")):
        assert isinstance(loaded, Model) and loaded._tokenizer[2] == " "
        assert torch.equal(loaded.decoder.tgt_word_prj.weight,
                           loaded.decoder.tgt_word_emb.weight)
        assert loaded.generate(x, beam_size=3).text == want
