"""The Higgs Audio v2 tokenizer and the wav2vec2/HuBERT backbone in the
PyTorch port against the JAX package, on the CPU at float32.

Config: `tests/test_higgs_codec.py::_cfg` (3 books of 16, ratios 2 x 3,
decoder hidden 16, a 1-layer HuBERT of width 16). The JAX model's random
parameters reach the port through `model.load_jax_params`.

Tolerances: decoded audio and latents 1e-4 relative (values ~1e-2 under
random weights, and the decoder sums convolutions over 50 channels in
another order); hidden states 2e-4 absolute; codes equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_higgs_codec import _cfg  # noqa: E402

ATOL = 2e-4
REL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def _np(t):
    return t.detach().float().cpu().numpy()


_MODELS = {}


def _pair(with_semantic=True):
    """(JAX codec, port codec) from one seeded JAX tree."""
    if with_semantic not in _MODELS:
        from mlx_audio_tpu.codec.models.higgs_audio import Model as JM
        from mlx_audio_tpu.utils import flatten
        from mlx_audio_tpu_torch.codec.models.higgs_audio import Model as PM
        from mlx_audio_tpu_torch.model import load_jax_params

        cfg = _cfg(with_semantic=with_semantic)
        jm = JM(cfg).init_and_bind(jax.random.PRNGKey(3))
        flat = {k: np.asarray(v) for k, v in flatten(jm.params).items()}
        pm = load_jax_params(PM(dataclasses.asdict(cfg), device="cpu"), flat)
        _MODELS[with_semantic] = (jm, pm)
    return _MODELS[with_semantic]


def _codes(t, seed=0):
    return np.random.RandomState(seed).randint(0, 16, (1, t, 3)).astype(
        np.int32)


def test_rvq_matches_jax():
    from mlx_audio_tpu.codec.models.higgs_audio.higgs_audio import \
        rvq_decode as jdec
    from mlx_audio_tpu.codec.models.higgs_audio.higgs_audio import \
        rvq_encode as jenc
    from mlx_audio_tpu_torch.codec.models.higgs_audio.higgs_audio import (
        rvq_decode, rvq_encode)

    jm, pm = _pair(False)
    codes = _codes(10)
    want = jdec(jm.params["quantizer"], jnp.asarray(codes), 3)
    got = rvq_decode(pm.quantizer, torch.from_numpy(codes), 3)
    assert _rel(_np(got), np.asarray(want)) < REL
    z = np.random.RandomState(1).randn(1, 10, 24).astype(np.float32)
    want = jenc(jm.params["quantizer"], jnp.asarray(z), 3)
    got = rvq_encode(pm.quantizer, torch.from_numpy(z), 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_acoustic_decode_matches_jax():
    from mlx_audio_tpu.codec.models.higgs_audio.higgs_audio import \
        acoustic_decode as jdec
    from mlx_audio_tpu_torch.codec.models.higgs_audio.higgs_audio import \
        acoustic_decode

    jm, pm = _pair(False)
    z = np.random.RandomState(2).randn(2, 7, 8).astype(np.float32)
    want = np.asarray(jdec(jm.params["acoustic_decoder"], jm.config,
                           jnp.asarray(z)))
    got = _np(acoustic_decode(pm.acoustic_decoder, pm.config,
                              torch.from_numpy(z)))
    assert got.shape == want.shape == (2, 7 * 6, 1)
    assert _rel(got, want) < REL


@pytest.mark.parametrize("t", [1, 9, 20])
def test_decode_matches_jax(t):
    """Model.decode: (T, K) codes -> T * hop samples, at the exact length."""
    jm, pm = _pair(False)
    codes = _codes(t, seed=t)[0]
    want = jm.decode(codes)
    got = pm.decode(codes)
    assert got.shape == want.shape == (t * 6,) and got.dtype == np.float32
    assert _rel(got, want) < REL
    np.testing.assert_array_equal(pm.decode(codes[None]), got)


def test_encode_codes_match_jax():
    jm, pm = _pair(True)
    wav = (np.random.RandomState(3).randn(12000) * 0.1).astype(np.float32)
    want = jm.encode(wav)
    got = pm.encode(wav)
    assert got.dtype == np.int32 and got.shape[1] == 3
    np.testing.assert_array_equal(got, want)


def test_encode_without_semantic_raises():
    _, pm = _pair(False)
    with pytest.raises(RuntimeError, match="semantic"):
        pm.encode(np.zeros(2400, np.float32))


def _w2v_pair(variant):
    from mlx_audio_tpu.stt.models.wav2vec import ModelConfig as JC
    from mlx_audio_tpu.stt.models.wav2vec import init_wav2vec2
    from mlx_audio_tpu.utils import flatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.wav2vec import Wav2Vec2Model

    kw = dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=32, conv_dim=(8, 8, 8),
              conv_stride=(5, 2, 2), conv_kernel=(10, 3, 3),
              num_feat_extract_layers=3, num_conv_pos_embeddings=16,
              num_conv_pos_embedding_groups=4)
    if variant == "stable":
        kw.update(feat_extract_norm="layer", do_stable_layer_norm=True,
                  conv_bias=True, adapter_attn_dim=8,
                  num_conv_pos_embeddings=7, layer_norm_eps=1e-6)
    cfg = JC(**kw)
    params = init_wav2vec2(jax.random.PRNGKey(4), cfg)
    pm = load_jax_params(Wav2Vec2Model(dataclasses.asdict(cfg), device="cpu"),
                         {k: np.asarray(v)
                          for k, v in flatten(params).items()})
    return cfg, params, pm


@pytest.mark.parametrize("variant", ["group", "stable"])
def test_wav2vec2_forward_matches_jax(variant):
    """A padded batch of two rows (lengths 1,600 and 1,100): hidden states,
    frame counts and every collected layer."""
    from mlx_audio_tpu.stt.models.wav2vec import wav2vec2_forward as jfwd
    from mlx_audio_tpu_torch.stt.models.wav2vec import wav2vec2_forward

    cfg, params, pm = _w2v_pair(variant)
    wave = (np.random.RandomState(5).randn(2, 1600) * 0.1).astype(np.float32)
    n = np.array([1600, 1100])
    wave[1, 1100:] = 0.0
    wx, wn, wh = jfwd(params, cfg, jnp.asarray(wave), jnp.asarray(n),
                      collect_hidden=True)
    gx, gn, gh = wav2vec2_forward(pm, torch.from_numpy(wave),
                                  torch.from_numpy(n), collect_hidden=True)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    np.testing.assert_allclose(_np(gx), np.asarray(wx), atol=ATOL)
    assert len(gh) == len(wh) == cfg.num_hidden_layers + 1
    for g, w in zip(gh, wh):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATOL)


def test_hubert_hidden_mean_matches_jax():
    from mlx_audio_tpu.codec.models.higgs_audio.higgs_audio import \
        hubert_hidden_mean as jmean
    from mlx_audio_tpu_torch.codec.models.higgs_audio.higgs_audio import \
        hubert_hidden_mean

    cfg, params, pm = _w2v_pair("group")
    wave = (np.random.RandomState(6).randn(2, 2000) * 0.1).astype(np.float32)
    n = np.array([2000, 1500])
    want = jmean(params, cfg, jnp.asarray(wave), jnp.asarray(n))
    got = hubert_hidden_mean(pm, pm.config, torch.from_numpy(wave),
                             torch.from_numpy(n))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def _torch_checkpoint(pm):
    """The published checkpoint's form of a port codec's weights: codebook
    `embed`, snake alphas (1, C, 1), HuBERT's positional conv as a
    weight-norm pair, and the tensors sanitize drops."""
    out = {}
    for k, v in pm.state_dict().items():
        v = v.numpy().copy()
        if k.endswith(".codebook.weight"):
            k = k[: -len("weight")] + "embed"
            out[k[: -len("embed")] + "embed_avg"] = v
            out[k[: -len("embed")] + "cluster_size"] = v[:, 0]
        if k.endswith(".alpha"):
            v = v.reshape(1, -1, 1)
        if k == "semantic_model.encoder.pos_conv_embed.conv.weight":
            norm = np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
            out[k[: -len("weight")] + "weight_g"] = norm
            k = k[: -len("weight")] + "weight_v"
        out[k] = v
    out.update({"decoder_semantic.conv.weight": np.ones((4, 4, 3)),
                "fc1.weight": np.ones((4, 4)),
                "semantic_model.masked_spec_embed": np.ones(16),
                "unrelated.weight": np.ones(2)})
    return out


@pytest.mark.parametrize("with_semantic", [False, True])
def test_sanitize_matches_jax_after_layout(with_semantic):
    """The port's sanitize of a torch-layout checkpoint binds to the same
    model as the JAX package's sanitize carried over by load_jax_params
    (the port's one layout step)."""
    from mlx_audio_tpu_torch.codec.models.higgs_audio import Model as PM
    from mlx_audio_tpu_torch.model import load_jax_params

    jm, pm = _pair(with_semantic)
    ckpt = _torch_checkpoint(pm)
    cfg = dataclasses.asdict(jm.config)
    jflat = {k: np.asarray(v) for k, v in jm.sanitize(ckpt).items()}
    via_jax = load_jax_params(PM(cfg, device="cpu"), jflat).state_dict()
    mine = PM(cfg, device="cpu").bind(pm.sanitize(ckpt)).state_dict()
    assert set(mine) == set(via_jax) == set(pm.state_dict())
    for k in mine:
        np.testing.assert_allclose(mine[k].numpy(), via_jax[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    wav = (np.random.RandomState(7).randn(2400) * 0.1).astype(np.float32)
    if with_semantic:
        np.testing.assert_array_equal(
            PM(cfg, device="cpu").bind(pm.sanitize(ckpt)).encode(wav),
            jm.encode(wav))


def test_sanitize_rejects_another_layout():
    _, pm = _pair(False)
    with pytest.raises(ValueError, match="acoustic_encoder.conv1.weight"):
        pm.sanitize({"acoustic_encoder.conv1.weight": np.ones((7, 1, 4))})
    assert pm._expected_kernel("acoustic_decoder.block.1.conv_t1.weight") \
        == 6


def test_decode_in_bf16_is_close_to_f32():
    """The bf16 codec (the lane's, bench.py:463-464) against f32 on one
    weight set: relative Frobenius under 2e-2."""
    from mlx_audio_tpu_torch.codec.models.higgs_audio import Model as PM

    _, pm = _pair(False)
    half = PM(dataclasses.asdict(pm.config), device="cpu")
    half.load_state_dict(pm.state_dict())
    half.astype(torch.bfloat16)
    codes = _codes(16, seed=8)[0]
    a, b = pm.decode(codes), half.decode(codes)
    assert np.linalg.norm(b - a) / np.linalg.norm(a) < 2e-2
