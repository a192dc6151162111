"""The port's Parakeet against the JAX package, on the CPU at f32: the
cases of tests/test_parakeet.py on the port, then the front end, the
encoder, the joint, TDT, RNN-T and CTC tokens and frames, the forced
advance after `max_symbols` tokens on a frame, the greedy loop's chunking,
the HF `parakeet_ctc` schema and `sanitize`, and the departure: a
`tdt_ctc` config raises when it is built.

Both packages run one weight set: the JAX model's random parameters
(tests/test_parakeet.py's tiny `ENC`) loaded into the port with
`model.load_jax_params`. Tensors agree within ATOL = 2e-4, the repo's f32
precedent (tests/test_torch_parity.py); tokens and frames are equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from mlx_audio_tpu.stt.models.parakeet import Model as JModel  # noqa: E402
from mlx_audio_tpu.stt.models.parakeet import ModelConfig as JConfig  # noqa: E402
from mlx_audio_tpu.utils import flatten  # noqa: E402
from test_parakeet import ENC, VOCAB  # noqa: E402

ATOL = 2e-4
SR = 16000


def config(decoding="tdt", **over):
    """tests/test_parakeet.py's tiny config for `decoding` (CTC has no
    prediction network or joint; RNN-T's joint has no duration outputs)."""
    kw = dict(decoding=decoding, encoder=ENC, vocab_size=40,
              vocabulary=VOCAB)
    if decoding != "ctc":
        kw.update(prediction=dict(pred_hidden=32, pred_rnn_layers=1),
                  joint=dict(joint_hidden=32,
                             num_classes=46 if decoding == "tdt" else 41),
                  durations=[0, 1, 2, 3, 4])
    kw.update(over)
    return kw


def model_pair(decoding="tdt", **over):
    """(JAX model, port model on the CPU) with the JAX model's random
    parameters in both."""
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.parakeet import Model, ModelConfig

    jm = JModel(JConfig(**config(decoding, **over))).init_and_bind()
    pm = Model(ModelConfig(**config(decoding, **over)), device="cpu")
    load_jax_params(pm, {k: np.asarray(v)
                         for k, v in flatten(jm.params).items()})
    return jm, pm


_PAIRS = {}


def pair(decoding):
    if decoding not in _PAIRS:
        _PAIRS[decoding] = model_pair(decoding)
    return _PAIRS[decoding]


@pytest.fixture(scope="module")
def tdt():
    return pair("tdt")[1]


def noise(seed, seconds, scale=0.1):
    return (np.random.RandomState(seed).randn(int(SR * seconds))
            * scale).astype(np.float32)


# ------------------------------------------- tests/test_parakeet.py cases


class TestEncoder:
    def test_subsampling_rate(self, tdt):
        enc = tdt.encode(np.random.RandomState(0).randn(16000)
                         .astype(np.float32))
        # 1 s -> ~100 mel frames -> /4 subsampling
        assert enc.shape[0] == 1 and enc.shape[2] == 64
        assert 23 <= enc.shape[1] <= 27

    def test_rel_shift_alignment(self):
        from mlx_audio_tpu_torch.stt.models.parakeet.conformer import \
            _rel_shift

        t = 4
        x = torch.arange(2 * t - 1, dtype=torch.float32).expand(1, 1, t,
                                                                 2 * t - 1)
        out = _rel_shift(x)[0, 0]
        for i in range(t):
            for j in range(t):
                assert out[i, j] == (t - 1) - i + j


class TestDecoders:
    def test_tdt_generate(self, tdt):
        out = tdt.generate(noise(0, 2.0))
        assert isinstance(out.text, str)
        assert out.generation_tokens == len(out.segments)
        for seg in out.segments:
            assert seg["end"] > seg["start"] >= 0

    def test_tdt_deterministic(self, tdt):
        audio = noise(1, 1.0)
        assert tdt.generate(audio).text == tdt.generate(audio).text

    def test_ctc_collapse(self):
        _, m = pair("ctc")
        out = m.generate(noise(2, 1.0))
        toks = [seg["text"] for seg in out.segments]
        assert all(len(t) <= 1 for t in toks)
        assert isinstance(out.text, str)


# ------------------------------------------------------- against JAX


@pytest.mark.parametrize("seconds", [0.3, 1.0, 2.7])
def test_log_mel_matches_jax(seconds):
    from mlx_audio_tpu.stt.models.parakeet.parakeet import log_mel as jlog
    from mlx_audio_tpu_torch.stt.models.parakeet.parakeet import log_mel

    x = noise(int(seconds * 10), seconds, 0.5)
    want = np.asarray(jlog(jnp.asarray(x)[None], 80))
    got = log_mel(torch.from_numpy(x)[None], 80).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_encoder_and_joint_match_jax():
    jm, pm = pair("tdt")
    audio = noise(3, 1.5)
    want = np.asarray(jm.encode(audio))
    enc = pm.encode(audio)
    np.testing.assert_allclose(enc.numpy(), want, atol=ATOL, rtol=0)
    states = [(jnp.zeros((1, 32)), jnp.zeros((1, 32)))]
    jpred, _ = jm._predict_step(jnp.asarray([7], jnp.int32), states)
    zeros = [torch.zeros(1, 32)]
    with torch.no_grad():
        pred, _, _ = pm._predict(torch.tensor([7]), zeros, zeros)
        got = pm._joint(pm.joint.enc_proj(enc[0]), pred)
    want = np.asarray(jm._joint(jnp.asarray(want[0]), jpred))
    assert got.shape == want.shape == (enc.shape[1], 46)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("decoding", ["tdt", "rnnt", "ctc"])
@pytest.mark.parametrize("seed,seconds", [(4, 0.8), (5, 1.7)])
def test_tokens_and_frames_match_jax(decoding, seed, seconds):
    jm, pm = pair(decoding)
    audio = noise(seed, seconds)
    jenc = jm.encode(audio)
    enc = pm.encode(audio)
    fn = "decode_ctc" if decoding == "ctc" else "decode_tdt"
    want = getattr(jm, fn)(jenc)
    got = getattr(pm, fn)(enc)
    assert got == want and len(got[0]) > 0
    jo, po = jm.generate(audio), pm.generate(audio)
    assert (po.text, po.segments, po.generation_tokens) == \
        (jo.text, jo.segments, jo.generation_tokens)


def test_max_symbols_forces_an_advance():
    """A joint biased to a non-blank token of duration 0 emits it on every
    step: the 8th token on a frame moves the loop on one frame, in both
    packages."""
    jm, pm = model_pair("tdt")
    bias = np.zeros(46, np.float32)
    bias[3], bias[41] = 50.0, 50.0        # token 3, duration index 0 (d = 0)
    jm.params["joint"]["out"]["bias"] = jnp.asarray(bias)
    with torch.no_grad():
        pm.joint.out.bias.copy_(torch.from_numpy(bias))
    audio = noise(6, 0.5)
    want = jm.decode_tdt(jm.encode(audio))
    got = pm.decode_tdt(pm.encode(audio))
    n_frames = pm.encode(audio).shape[1]
    assert got == want
    assert got[0] == [3] * 8 * n_frames
    assert got[1] == [f for f in range(n_frames) for _ in range(8)]


@pytest.mark.parametrize("chunk", [1, 3, 32])
def test_loop_chunking_gives_the_same_tokens(chunk, monkeypatch):
    """However many joint steps a chunk runs between reads, the tokens and
    frames are the same (steps past the end change nothing)."""
    from mlx_audio_tpu_torch.stt.models.parakeet import transducer

    _, pm = pair("rnnt")
    enc = pm.encode(noise(7, 1.0))
    want = pm.decode_tdt(enc)
    steps = pm.last_run["joint_steps"]
    monkeypatch.setattr(transducer, "JOINT_CHUNK", chunk)
    assert pm.decode_tdt(enc) == want
    run = pm.last_run
    assert run["joint_steps"] == steps
    assert run["chunks"] <= -(-steps // chunk) + 2


def test_chunked_windows_match_jax():
    """`transcribe_chunked` over four windows (1.5 s, 0.5 s overlap) and
    `generate(chunk_duration=...)`: the merged AlignedResult (sentences,
    tokens with their starts and durations) equal to JAX's."""
    jm, pm = pair("tdt")
    audio = noise(8, 3.8)
    kw = dict(chunk_duration=1.5, overlap_duration=0.5)
    want = jm.transcribe_chunked(audio, **kw)
    got = pm.transcribe_chunked(audio, **kw)
    assert pm.last_run["windows"] >= 3
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.sentences
    jo, po = jm.generate(audio, **kw), pm.generate(audio, **kw)
    assert (po.text, po.segments) == (jo.text, jo.segments)


# ----------------------------------------------- HF schema and sanitize


HF_CONFIG = {"model_type": "parakeet_ctc", "vocab_size": 41,
             "encoder_config": {
                 "hidden_size": 64, "intermediate_size": 128,
                 "num_mel_bins": 80, "num_hidden_layers": 2,
                 "num_attention_heads": 4, "subsampling_factor": 4,
                 "conv_kernel_size": 9, "subsampling_conv_channels": 16,
                 "attention_bias": True, "scale_input": False}}
HF_ATTN = {"linear_q": "q_proj", "linear_k": "k_proj", "linear_v": "v_proj",
           "linear_out": "o_proj", "linear_pos": "relative_k_proj",
           "pos_bias_u": "bias_u", "pos_bias_v": "bias_v"}
HF_SUB = {"00_conv": 0, "01_dw": 2, "02_pw": 3}


def hf_state(flat, ch=16, f_out=20):
    """The JAX tree of a CTC model under HF ParakeetForCTC names in torch
    layouts (what `sanitize` maps back)."""
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if k.startswith("ctc_decoder.conv."):
            out[k.replace("ctc_decoder.conv.", "ctc_head.")] = (
                np.transpose(v, (2, 1, 0)) if v.ndim == 3 else v)
            continue
        if k.startswith("encoder.pre_encode.out."):
            leaf = k.rsplit(".", 1)[1]
            if leaf == "weight":            # (F', C) C fastest -> (C, F')
                v = v.reshape(v.shape[0], f_out, ch).transpose(0, 2, 1) \
                    .reshape(v.shape[0], -1)
            out[f"encoder.subsampling.linear.{leaf}"] = v
            continue
        if k.startswith("encoder.pre_encode.layers."):
            name, leaf = k.split(".")[3:5]
            out[f"encoder.subsampling.layers.{HF_SUB[name]}.{leaf}"] = (
                np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v)
            continue
        for ours, hf in HF_ATTN.items():
            k = k.replace(f".self_attn.{ours}", f".self_attn.{hf}")
        k = k.replace(".conv.batch_norm.", ".conv.norm.")
        if v.ndim == 3:
            v = np.transpose(v, (2, 1, 0))
        out["model." + k] = v
    out["model.encoder.layers.0.conv.norm.num_batches_tracked"] = np.zeros(
        (), np.int64)
    return out


def test_hf_schema_and_sanitize_match_jax(tmp_path):
    """The HF parakeet_ctc config builds the JAX package's config; an HF
    state (names, torch layouts, the subsampling linear's (C, F') columns)
    sanitizes to the JAX package's tree; `load_model` of a directory of it
    transcribes as the JAX model does."""
    import json

    from mlx_audio_tpu_torch.stt.models.parakeet import ModelConfig
    from mlx_audio_tpu_torch.stt.utils import load_model

    jcfg, pcfg = JConfig.from_dict(HF_CONFIG), ModelConfig.from_dict(
        HF_CONFIG)
    assert (pcfg.decoding, pcfg.vocab_size, vars(pcfg.encoder_args)) == \
        (jcfg.decoding, jcfg.vocab_size, vars(jcfg.encoder_args))
    jm = JModel(jcfg).init_and_bind()
    flat = {k: np.asarray(v) for k, v in flatten(jm.params).items()}
    state = hf_state(flat)
    want = {k: np.asarray(v) for k, v in jm.sanitize(dict(state)).items()}
    d = tmp_path / "parakeet-ctc-tiny"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(HF_CONFIG))
    np.savez(d / "model.npz", **state)
    pm = load_model(d, device="cpu")
    got = pm.sanitize(dict(state))
    assert sorted(got) == sorted(want) == sorted(flat)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
    audio = noise(9, 1.2)
    assert pm.generate(audio).text == jm.generate(audio).text
    assert pm.sanitize(flat) is flat            # native trees pass through


# ----------------------------------------------------------- departure


def test_tdt_ctc_raises_when_built():
    """JAX builds only the CTC head for decoding "tdt_ctc" and then decodes
    by TDT, which reads the missing prediction network (KeyError
    'decoder'); the port refuses the mode when the config is built."""
    from mlx_audio_tpu_torch.stt.models.parakeet import Model, ModelConfig

    kw = {**config("ctc"), "decoding": "tdt_ctc"}
    jm = JModel(JConfig(**kw)).init_and_bind()
    assert "decoder" not in jm.params and "ctc_decoder" in jm.params
    with pytest.raises(KeyError, match="decoder"):
        jm.generate(noise(10, 0.5))
    with pytest.raises(ValueError, match="tdt_ctc"):
        ModelConfig(**kw)
    with pytest.raises(ValueError, match="tdt_ctc"):
        Model(kw, device="cpu")
