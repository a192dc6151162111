"""Sortformer of the PyTorch port against the JAX package, on the CPU: the
cases of tests/test_sortformer.py (the mel features and the silence
trim, the forward's probabilities, segments, `generate`, the streaming
state through the v1 and the AOSC speaker-cache compressions,
`sanitize`), each held to the JAX package's on one weight set; the
departures pinned (the unpadded run against JAX's bucket, the layouts
read from shapes); the loader on a tiny directory of NeMo names.

Config: tests/test_sortformer.py's `_cfg` (16 mels, a FastConformer d16
of one layer, a transformer d8 of one layer, 3 speakers, chunk 8, speaker
cache 16; the AOSC variant's cache 12, update period 8, one silence frame
a speaker); one parameter set drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`), the biases and the batch norm's
statistics drawn too; the JAX side jitted. JAX's bucketing is switched
off (`_bucket` the identity) where a test compares a whole `generate` or
stream, so that both run the frames the audio has; the bucket's own
effect is pinned by `test_unpadded_run_departs_from_jax_bucket`.
Probabilities at ATOL = 2e-4 (f32, summation order;
tests/test_torch_parity.py:19); mel features at 2e-4 (the port's STFT in
float64, JAX's in f32); the AOSC compression's numpy outputs exact.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
CFG = dict(
    fc_encoder_config=dict(hidden_size=16, num_hidden_layers=1,
                           num_attention_heads=2, intermediate_size=32,
                           num_mel_bins=16, conv_kernel_size=5,
                           subsampling_conv_channels=4),
    tf_encoder_config=dict(d_model=8, encoder_layers=1,
                           encoder_attention_heads=2, encoder_ffn_dim=16,
                           max_source_positions=256),
    modules_config=dict(num_speakers=3, fc_d_model=16, tf_d_model=8,
                        chunk_len=8, spkcache_len=16),
    processor_config=dict(feature_size=16))
AOSC = dict(use_aosc=True, spkcache_len=12, spkcache_update_period=8,
            spkcache_sil_frames_per_spk=1)


def _cfg(aosc=False):
    cfg = json.loads(json.dumps(CFG))
    if aosc:
        cfg["modules_config"].update(AOSC)
    return cfg


def _pair(cfg):
    import jax.numpy as jnp

    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu.vad.models.sortformer import Model as JModel
    from mlx_audio_tpu.vad.models.sortformer import ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.vad.models.sortformer import Model, ModelConfig

    jm = JModel(JConfig.from_dict(cfg))
    flat = flat_numpy(numpy_params(jm.init_params, 0))
    rs = np.random.RandomState(1)
    for k in [k for k in flat if k.endswith(".bias")]:
        flat[k] = (rs.randn(*flat[k].shape) * 0.1).astype(np.float32)
    for k in [k for k in flat if k.endswith("norm.running_mean")]:
        flat[k] = (rs.randn(*flat[k].shape) * 0.1).astype(np.float32)
        flat[k.replace("mean", "var")] = rs.uniform(
            0.5, 1.5, flat[k].shape).astype(np.float32)
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    pm = load_jax_params(Model(ModelConfig.from_dict(cfg), device="cpu"),
                         flat)
    return jm, pm, flat


@pytest.fixture(scope="module")
def pair():
    return _pair(_cfg())


@pytest.fixture(scope="module")
def aosc_pair():
    return _pair(_cfg(aosc=True))


@pytest.fixture
def unbucketed(monkeypatch):
    """JAX's programs on the frames the audio has."""
    from mlx_audio_tpu.vad.models.sortformer import sortformer

    monkeypatch.setattr(sortformer, "_bucket", lambda n: n)


def jax_forward(jm, mel, n):
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.vad.models.sortformer.sortformer import (
        sortformer_forward)

    preds, frames = jax.jit(lambda p, m, k: sortformer_forward(
        p, jm.config, m, k))(jm.params, jnp.asarray(mel), jnp.asarray(n))
    return np.asarray(preds), np.asarray(frames)


def _speech(seconds, sr=16000):
    t = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)


@pytest.mark.parametrize("normalize", [True, False])
def test_mel_features_match_jax(normalize):
    """NeMo's features (pre-emphasis, the 400-in-512 Hann window, constant
    padding, slaney mels, log guard, Bessel normalisation) within 2e-4 of
    JAX's on 1 s of noise; normalised, per-feature mean 0 and std 1."""
    from mlx_audio_tpu.vad.models.sortformer.config import (
        ProcessorConfig as JProc)
    from mlx_audio_tpu.vad.models.sortformer.sortformer import (
        extract_mel_features as jax_mel)
    from mlx_audio_tpu_torch.vad.models.sortformer.config import (
        ProcessorConfig)
    from mlx_audio_tpu_torch.vad.models.sortformer.sortformer import (
        extract_mel_features)

    wav = np.random.RandomState(0).randn(16000).astype(np.float32)
    got = extract_mel_features(wav, ProcessorConfig(feature_size=16),
                               normalize)
    want = jax_mel(wav, JProc(feature_size=16), normalize)
    assert got.shape == want.shape and got.shape[1] == 16
    np.testing.assert_allclose(got, want, atol=ATOL)
    if normalize:
        np.testing.assert_allclose(got.mean(0), 0.0, atol=1e-3)


@pytest.mark.parametrize("kind", ["padded", "speech", "short"])
def test_trim_silence_equals_jax(kind):
    """The energy trim: a tone between two silent seconds loses most of
    the leading one; pure speech keeps all but the sub-frame remainder;
    too short a clip is kept whole. Offsets and samples equal JAX's."""
    from mlx_audio_tpu.vad.models.sortformer.sortformer import (
        trim_silence as jax_trim)
    from mlx_audio_tpu_torch.vad.models.sortformer.sortformer import (
        trim_silence)

    sr = 16000
    wav = {"padded": np.concatenate([np.zeros(sr, np.float32),
                                     _speech(1.0), np.zeros(sr, np.float32)]),
           "speech": _speech(2.0), "short": _speech(0.1)}[kind]
    got, off = trim_silence(wav, sr)
    want, joff = jax_trim(wav, sr)
    assert off == joff and np.array_equal(got, want)
    if kind == "padded":
        assert off >= sr - 2000 and len(got) < len(wav)


def test_forward_probabilities_match_jax(pair):
    """48 mel frames -> 6 diarization frames of 3 speakers in [0, 1],
    within ATOL of JAX's `sortformer_forward` at the tight length."""
    jm, pm, _ = pair
    mel = np.random.RandomState(1).randn(1, 48, 16).astype(np.float32)
    want, n = jax_forward(jm, mel, [48])
    got = pm.predict(mel[0])
    assert got.shape == (int(n[0]), 3) == (6, 3)
    assert ((got >= 0) & (got <= 1)).all()
    np.testing.assert_allclose(got, want[0, :6], atol=ATOL)


def test_unpadded_run_departs_from_jax_bucket(pair):
    """A departure from a JAX fault: JAX's `generate` runs 50 frames in the
    64-frame bucket. 50 is no multiple of 8, so a stride-2 conv of the
    subsampling reads past the end of its input: in the bucket it reads a
    row the previous conv computed from the last mel rows and the pad,
    where the tight run reads zero padding. The last valid embedding
    differs, and attention reads it from every other row. The port runs
    the 50 frames: its embeddings and probabilities equal JAX's on the
    unpadded mel, not its bucket's."""
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.vad.models.sortformer.sortformer import pre_encode

    jm, pm, _ = pair
    mel = np.random.RandomState(3).randn(1, 50, 16).astype(np.float32)
    padded = np.zeros((1, 64, 16), np.float32)
    padded[:, :50] = mel
    run = jax.jit(lambda p, m: pre_encode(p["fc_encoder"],
                                          jm.config.fc_encoder_config, m,
                                          jnp.asarray([50]))[0][:, :7])

    tight = np.asarray(run(jm.params, jnp.asarray(mel)))
    bucket = np.asarray(run(jm.params, jnp.asarray(padded)))
    with torch.inference_mode():
        got = pm.pre_encode(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, tight, atol=ATOL)
    assert np.abs(bucket - tight)[0, 6].max() > 2 * ATOL
    np.testing.assert_array_equal(bucket[0, :6], tight[0, :6])
    want, _ = jax_forward(jm, mel, [50])
    np.testing.assert_allclose(pm.predict(mel[0]), want[0, :7], atol=ATOL)


def test_segments_equal_jax():
    """Thresholding, the minimum duration and the merge gap on fixed
    probabilities: the same segments as JAX's."""
    from mlx_audio_tpu.vad.models.sortformer.sortformer import (
        preds_to_segments as jax_segments)
    from mlx_audio_tpu_torch.vad.models.sortformer.sortformer import (
        preds_to_segments)

    preds = np.zeros((20, 2), np.float32)
    preds[2:6, 0] = preds[8:12, 0] = 0.9
    preds[5:15, 1] = 0.8
    preds[17:18, 1] = 0.9
    for kw in ({}, {"merge_gap": 0.3}, {"min_duration": 0.2}):
        got = [(s.start, s.end, s.speaker)
               for s in preds_to_segments(preds, 0.08, 0.5, **kw)]
        want = [(s.start, s.end, s.speaker)
                for s in jax_segments(preds, 0.08, 0.5, **kw)]
        assert got == want and got
    assert len([s for s in preds_to_segments(preds, 0.08, 0.5,
                                             merge_gap=0.3)
                if s.speaker == 0]) == 1


def test_generate_equals_jax(pair, unbucketed):
    """`generate` on 2 s of a modulated tone between silences: the trim,
    the peak normalisation, the features, the forward, the segments
    shifted by the trim, and the RTTM text, against JAX's."""
    jm, pm, _ = pair
    sr = 16000
    wav = np.concatenate([np.zeros(sr // 2, np.float32), _speech(2.0),
                          np.zeros(sr // 2, np.float32)])
    got, want = pm.generate(wav, threshold=0.3), jm.generate(wav,
                                                             threshold=0.3)
    np.testing.assert_allclose(got.speaker_probs, want.speaker_probs,
                               atol=ATOL)
    assert [(s.start, s.end, s.speaker) for s in got.segments] == \
        [(s.start, s.end, s.speaker) for s in want.segments]
    assert got.num_speakers == want.num_speakers and got.text == want.text
    assert pm.last_run["frames"] == got.speaker_probs.shape[0]


def _stream(model, seed, steps):
    rng = np.random.RandomState(seed)
    state = model.init_streaming_state()
    out = []
    for _ in range(steps):
        preds, state = model.streaming_step(
            rng.randn(64, 16).astype(np.float32), state)
        out.append(preds)
    return out, state


def _assert_states_close(got, want):
    for name in ("spkcache", "spkcache_preds", "fifo", "fifo_preds"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=name)
    assert got.frames_processed == want.frames_processed


def test_streaming_state_through_v1_compression(pair, unbucketed):
    """Four 64-frame chunks (8 frames each): the FIFO fills, overflows
    into the speaker cache, and the cache is cut to its 16 frames of
    highest activity (v1). Each step's probabilities and the state equal
    JAX's."""
    jm, pm, _ = pair
    got, gs = _stream(pm, 2, 4)
    want, ws = _stream(jm, 2, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    _assert_states_close(gs, ws)
    mc = pm.config.modules_config
    assert gs.spkcache.shape[1] == mc.spkcache_len
    assert pm.last_run.get("compressions", 0) >= 1


def test_streaming_state_through_aosc_compression(aosc_pair, unbucketed):
    """Five chunks with AOSC (v2.1): overflow moved in update-period
    batches, the running silence profile kept, the cache compressed to its
    12 frames. Probabilities and state against JAX's, the silence profile
    too."""
    jm, pm, _ = aosc_pair
    got, gs = _stream(pm, 5, 5)
    want, ws = _stream(jm, 5, 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    _assert_states_close(gs, ws)
    assert gs.spkcache.shape[1] <= 12 and gs.n_sil_frames == ws.n_sil_frames
    np.testing.assert_allclose(gs.mean_sil_emb, ws.mean_sil_emb, atol=ATOL)


def test_aosc_host_functions_equal_jax_exactly():
    """The AOSC numpy (the LLR scores, the low-score cut, the strong and
    weak top-k boosts, the silence padding, the sorted gather) and the
    silence profile, on the JAX test's inputs and on drawn ones: outputs
    equal JAX's exactly."""
    from mlx_audio_tpu.vad.models.sortformer.config import (
        ModulesConfig as JMC)
    from mlx_audio_tpu.vad.models.sortformer.sortformer import (
        _silence_profile as jax_profile)
    from mlx_audio_tpu.vad.models.sortformer.sortformer import (
        compress_spkcache_aosc as jax_compress)
    from mlx_audio_tpu_torch.vad.models.sortformer.config import ModulesConfig
    from mlx_audio_tpu_torch.vad.models.sortformer.sortformer import (
        _silence_profile, compress_spkcache_aosc)

    kw = dict(num_speakers=3, use_aosc=True, spkcache_len=12,
              spkcache_sil_frames_per_spk=1)
    rng = np.random.RandomState(0)
    n = 40
    embs = rng.randn(1, n, 16).astype(np.float32)
    preds = np.full((1, n, 3), 0.01, np.float32)
    preds[0, 0:10, 0] = 0.95
    preds[0, 10:20, 1] = 0.95
    drawn = rng.uniform(0, 1, (1, n, 3)).astype(np.float32)
    mean_sil = rng.randn(1, 16).astype(np.float32)
    for p in (preds, drawn):
        got = compress_spkcache_aosc(embs, p, mean_sil, ModulesConfig(**kw))
        want = jax_compress(embs, p, mean_sil, JMC(**kw))
        for g, w in zip(got, want):
            assert g.shape == w.shape and np.array_equal(g, w)
        got = _silence_profile(mean_sil, 3.0, embs, p, 0.1)
        want = jax_profile(mean_sil, 3.0, embs, p, 0.1)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def test_generate_stream_equals_jax(aosc_pair, unbucketed):
    """`generate_stream` over 3 s of noise with AOSC (no trim, no peak
    normalisation): the chunks' probabilities and offsets, then the
    assembled output, against JAX's."""
    jm, pm, _ = aosc_pair
    wav = (0.2 * np.random.RandomState(6).randn(3 * 16000)).astype(
        np.float32)
    got = list(pm.generate_stream(wav))
    want = list(jm.generate_stream(wav))
    assert len(got) == len(want) >= 2
    for (g, go), (w, wo) in zip(got[:-1], want[:-1]):
        assert go == wo
        np.testing.assert_allclose(g, w, atol=ATOL)
    np.testing.assert_allclose(got[-1].speaker_probs,
                               want[-1].speaker_probs, atol=ATOL)
    assert pm.last_run["steps"] == len(got) - 1


def _nemo_names(flat):
    """The JAX tree as a NeMo checkpoint names it: `subsampling.layers.N`,
    torch conv layouts, batch norms' step counters."""
    out = {}
    for k, v in flat.items():
        if np.ndim(v) == 4:
            v = np.transpose(v, (3, 2, 0, 1))
        elif np.ndim(v) == 3 and "conv" in k:
            v = np.transpose(v, (2, 1, 0))
        out[k.replace("subsampling.layers_", "subsampling.layers.")] = v
        if k.endswith("norm.running_var"):
            out[k.replace("running_var", "num_batches_tracked")] = \
                np.zeros((), np.int64)
    return out


def test_sanitize_nemo_layout_equals_jax(pair):
    """NeMo names and torch layouts sanitize to the JAX tree in both
    packages, leaf for leaf; the port's output sanitizes to itself."""
    jm, pm, flat = pair
    nemo = _nemo_names(flat)
    got = pm.sanitize(nemo)
    want = {k: np.asarray(v) for k, v in jm.sanitize(nemo).items()}
    assert set(got) == set(want) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
    again = pm.sanitize(got)
    assert all(np.array_equal(again[k], flat[k]) for k in flat)


def test_sanitize_reads_mlx_convs_where_jax_misreads(pair):
    """A departure from a JAX fault: JAX takes a conv2d for torch's only
    when its two last axes are equal and its first is larger, and a conv1d
    when its first axis is the larger. So an MLX depthwise conv2d (O, kh,
    kw, I) = (4, 3, 3, 1) is left as it is, and an MLX pointwise conv1d
    (O, 1, I) = (32, 1, 16) becomes (16, 1, 32): neither is this model's
    HWIO (3, 3, 1, 4) or WIO (1, 16, 32) kernel. The port reads each from
    its own shapes."""
    jm, pm, flat = pair
    dw = "fc_encoder.subsampling.layers_2.weight"
    pw = "fc_encoder.layers.0.conv.pointwise_conv1.weight"
    mlx = {dw: np.transpose(flat[dw], (3, 0, 1, 2)),
           pw: np.transpose(flat[pw], (2, 0, 1))}
    jax_out = jm.sanitize(mlx)
    assert np.shape(jax_out[dw]) == (4, 3, 3, 1)
    assert np.shape(jax_out[pw]) == (16, 1, 32)
    got = pm.sanitize(mlx)
    for k in (dw, pw):
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)


def test_routed_from_a_directory(pair, tmp_path):
    """A directory of config.json (model_type sortformer) and NeMo-named
    weights loads through the top-level router as Sortformer, with the
    forward of the bound tree."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.vad.models.sortformer import Model

    _, pm, flat = pair
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "sortformer", **CFG}))
    np.savez(tmp_path / "model.npz", **_nemo_names(flat))
    m = mlx_audio_tpu_torch.load_model(tmp_path, device="cpu")
    assert type(m) is Model
    mel = np.random.RandomState(7).randn(40, 16).astype(np.float32)
    np.testing.assert_array_equal(m.predict(mel), pm.predict(mel))


def test_reuses_the_shared_rel_shift():
    """The FastConformer's relative shift is the shared conformer's
    `_rel_shift`, which computes JAX's Sortformer `_rel_shift` cut to T
    columns."""
    import jax.numpy as jnp

    from mlx_audio_tpu.vad.models.sortformer.sortformer import (
        _rel_shift as jax_shift)
    from mlx_audio_tpu_torch.vad.models.sortformer import sortformer

    x = np.random.RandomState(8).randn(1, 2, 5, 9).astype(np.float32)
    want = np.asarray(jax_shift(jnp.asarray(x)))[..., :5]
    np.testing.assert_array_equal(
        sortformer._rel_shift(torch.from_numpy(x)).numpy(), want)
