"""FSMN VAD of the PyTorch port against the JAX package, on the CPU: the
cases of tests/test_fsmn.py (the encoder's softmax, its causal memory and
prefix consistency, the LFR front end, CMVN, decibels, the segment state
machine offline and streamed, `detect` end to end, `sanitize`), each held
to the JAX package's on one weight set, and the loaders (`vad.utils` and
the top-level router on a tiny directory with its `am.mvn`).

Config: tests/test_fsmn.py's (n_mels 8, LFR 5/1, two FSMN layers of
proj 8, lorder 4, 12 pdfs); one parameter set drawn with numpy over JAX's
shapes (`test_torch_mimi.numpy_params`), the JAX side jitted. Posteriors
and features at ATOL = 2e-4 (f32, summation order;
tests/test_torch_parity.py:19); segments equal. For `detect` the output
layer is scaled by 8, so that the sil-pdf scores sit far from the
decision thresholds and a difference in the last bits cannot flip a frame.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
ENC = dict(input_dim=40, input_affine_dim=16, fsmn_layers=2, linear_dim=24,
           proj_dim=8, lorder=4, output_affine_dim=16, output_dim=12)
CFG = dict(encoder=ENC, n_mels=8, lfr_m=5, lfr_n=1)


def fsmn_pair(seed=0, out_scale=1.0):
    from mlx_audio_tpu.vad.models.fsmn import Model as JModel
    from mlx_audio_tpu.vad.models.fsmn import ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.vad.models.fsmn import Model, ModelConfig

    jm = JModel(JConfig.from_dict(CFG))
    params = numpy_params(jm.init_params, seed)
    w = params["encoder"]["out_linear2"]["weight"]
    params["encoder"]["out_linear2"]["weight"] = w * out_scale
    jm.bind(params)
    pm = load_jax_params(Model(ModelConfig.from_dict(CFG), device="cpu"),
                         flat_numpy(jm.params))
    return jm, pm


@pytest.fixture(scope="module")
def pair():
    return fsmn_pair()


def _speechy(n, seed):
    """Seeded noise with loud and quiet stretches of 0.2-0.6 s."""
    rs = np.random.RandomState(seed)
    out, loud = [], False
    while sum(len(o) for o in out) < n:
        k = rs.randint(3200, 9600)
        out.append(rs.randn(k) * (0.3 if loud else 0.002))
        loud = not loud
    return np.concatenate(out)[:n].astype(np.float32)


def test_encoder_matches_jax_and_is_a_softmax(pair):
    jm, pm = pair
    x = np.random.RandomState(0).randn(30, 40).astype(np.float32)
    got, want = pm.scores(x), jm.scores(x)
    assert got.shape == (30, 12)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_encoder_is_causal_and_prefix_consistent(pair):
    """Future frames change no past posterior; a prefix's posteriors are
    the whole sequence's (tests/test_fsmn.py's causal and streaming
    cases)."""
    _, pm = pair
    x = np.random.RandomState(1).randn(25, 40).astype(np.float32)
    x2 = x.copy()
    x2[15:] += 10.0
    full = pm.scores(x)
    np.testing.assert_allclose(pm.scores(x2)[:15], full[:15], atol=1e-5)
    np.testing.assert_allclose(pm.scores(x[:10]), full[:10], atol=1e-5)


def test_frontend_host_code_is_jax_s():
    """apply_lfr, load_cmvn and compute_decibel give the JAX package's
    arrays (the host code is copied)."""
    from mlx_audio_tpu.vad.models.fsmn import fsmn as J
    from mlx_audio_tpu_torch.vad.models.fsmn import fsmn as P

    f = np.random.RandomState(2).randn(7, 3).astype(np.float32)
    for m, n in ((5, 1), (3, 1), (7, 6)):
        np.testing.assert_array_equal(P.apply_lfr(f, m, n),
                                      J.apply_lfr(f, m, n))
    wav = np.random.RandomState(3).randn(8000).astype(np.float32)
    np.testing.assert_array_equal(P.compute_decibel(wav, 16000, 25, 10),
                                  J.compute_decibel(wav, 16000, 25, 10))
    assert P.compute_decibel(wav[:100], 16000, 25, 10).shape == (0,)


def test_extract_features_match_jax(tmp_path):
    """Kaldi fbank at int16 scale -> LFR -> CMVN, against JAX's."""
    from mlx_audio_tpu.vad.models.fsmn import ModelConfig as JConfig
    from mlx_audio_tpu.vad.models.fsmn.fsmn import \
        extract_features as jax_features
    from mlx_audio_tpu_torch.vad.models.fsmn import ModelConfig
    from mlx_audio_tpu_torch.vad.models.fsmn.fsmn import (extract_features,
                                                          load_cmvn)

    mvn = tmp_path / "am.mvn"
    rs = np.random.RandomState(4)
    shift = " ".join(f"{v:.4f}" for v in rs.randn(40) * 3)
    scale = " ".join(f"{v:.4f}" for v in rs.rand(40) + 0.5)
    mvn.write_text(f"<Nnet>\n<AddShift> 40 40\n<LearnRateCoef> 0 [ {shift} ]"
                   f"\n<Rescale> 40 40\n<LearnRateCoef> 0 [ {scale} ]\n"
                   f"</Nnet>\n")
    cmvn = load_cmvn(mvn)
    wav = (rs.randn(16000) * 0.1).astype(np.float32)
    for c in (None, cmvn):
        got = extract_features(wav, ModelConfig.from_dict(CFG), c)
        want = jax_features(wav, JConfig.from_dict(CFG), c)
        assert got.shape == want.shape == (100, 40)
        np.testing.assert_allclose(got, want, atol=ATOL)


SIL_BLOCKS = {
    "one": [(50, 0.99), (100, 0.01), (100, 0.99)],
    "two": [(50, 0.99), (80, 0.01), (120, 0.99), (80, 0.01), (100, 0.99)],
    "silence": [(300, 0.99)],
    "open_at_end": [(40, 0.99), (100, 0.01)],
    "long": [(20, 0.99), (6200, 0.01), (30, 0.99)],
}


@pytest.mark.parametrize("case", sorted(SIL_BLOCKS))
def test_session_segments_equal_jax(case):
    """The state machine over crafted sil scores (tests/test_fsmn.py's
    TestStateMachine cases, and a segment past max_single_segment_time),
    offline and fed in 37-frame pieces: segments equal JAX's."""
    from mlx_audio_tpu.vad.models.fsmn import ModelConfig as JConfig
    from mlx_audio_tpu.vad.models.fsmn.fsmn import _VadSession as JSession
    from mlx_audio_tpu_torch.vad.models.fsmn import ModelConfig
    from mlx_audio_tpu_torch.vad.models.fsmn.fsmn import _VadSession

    sil = np.concatenate([np.full(n, v) for n, v in SIL_BLOCKS[case]])
    sil = np.clip(sil + 0.02 * np.random.RandomState(0).randn(len(sil)),
                  0.001, 0.999)
    db = np.full(len(sil), -25.0)
    want = JSession(JConfig.from_dict(CFG)).feed(sil, db, is_final=True)
    assert _VadSession(ModelConfig.from_dict(CFG)).feed(
        sil, db, is_final=True) == want
    s = _VadSession(ModelConfig.from_dict(CFG))
    got = []
    for i in range(0, len(sil), 37):
        got += s.feed(sil[i:i + 37], db[i:i + 37],
                      is_final=i + 37 >= len(sil))
    assert got == want
    assert (case == "silence") == (want == [])


def test_detect_equals_jax_and_streams_the_same():
    """`detect` end to end on loud and quiet stretches: segments equal
    JAX's; the same scores fed to `create_session` in pieces give them
    too."""
    jm, pm = fsmn_pair(seed=1, out_scale=8.0)
    wav = _speechy(48000, 5)
    want = jm.detect(wav)
    assert pm.detect(wav) == want and want
    from mlx_audio_tpu_torch.vad.models.fsmn.fsmn import (compute_decibel,
                                                          extract_features)

    cfg = pm.config
    sil = pm._sil_scores(pm.scores(extract_features(wav, cfg)))
    db = compute_decibel(wav * 32768.0, 16000, cfg.frame_length,
                         cfg.frame_in_ms)
    n = min(len(sil), len(db))
    assert n == len(db) < len(sil)
    s = pm.create_session()
    got = []
    for i in range(0, n, 50):
        got += s.feed(sil[i:min(i + 50, n)], db[i:min(i + 50, n)],
                      is_final=i + 50 >= n)
    assert got == want


def test_sanitize_matches_jax_and_reads_layouts(pair):
    """The `encoder.` prefix and the memory conv to WIO as JAX's sanitize
    gives for a torch checkpoint; an MLX (O, K, 1) layout too, which JAX's
    shape test would take for torch's (a departure)."""
    jm, pm = pair
    w = {"in_linear1.weight": np.ones((16, 40), np.float32),
         "fsmn.0.fsmn_block.conv_left.weight":
             np.arange(32, dtype=np.float32).reshape(8, 1, 4)}
    got, want = pm.sanitize(w), jm.sanitize(w)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    mlx = pm.sanitize({"fsmn.0.fsmn_block.conv_left.weight":
                       np.transpose(w["fsmn.0.fsmn_block.conv_left.weight"],
                                    (0, 2, 1))})
    np.testing.assert_array_equal(
        mlx["encoder.fsmn.0.fsmn_block.conv_left.weight"],
        got["encoder.fsmn.0.fsmn_block.conv_left.weight"])


def test_loaders_route_a_tiny_directory(tmp_path):
    """A directory (config.json, torch-layout npz without the `encoder.`
    prefix, `am.mvn`) through `vad.utils.load_model` and the top-level
    router: the model's weights and CMVN, and `detect` equal to the
    in-memory model's with the same CMVN."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.vad.models.fsmn import Model
    from mlx_audio_tpu_torch.vad.utils import PORTED, load_model

    _, pm = fsmn_pair(seed=1, out_scale=8.0)
    d = tmp_path / "fsmn-vad-tiny"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(CFG, model_type="fsmn")))
    np.savez(d / "model.npz", **{k[len("encoder."):]: v.numpy()
                                 for k, v in pm.state_dict().items()})
    (d / "am.mvn").write_text(
        "<Nnet>\n<AddShift> 40 40\n<LearnRateCoef> 0 [ " + " 0.5" * 40
        + " ]\n<Rescale> 40 40\n<LearnRateCoef> 0 [ " + " 0.9" * 40
        + " ]\n</Nnet>\n")
    assert "fsmn" in PORTED
    wav = _speechy(32000, 6)
    pm._cmvn = (np.full(40, 0.5, np.float32), np.full(40, 0.9, np.float32))
    for loaded in (load_model(d, device="cpu"),
                   mlx_audio_tpu_torch.load_model(d, device="cpu")):
        assert isinstance(loaded, Model)
        for k, v in pm.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), k
        np.testing.assert_array_equal(loaded._cmvn[1], pm._cmvn[1])
        assert loaded.detect(wav) == pm.detect(wav)
