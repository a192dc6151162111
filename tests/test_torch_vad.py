"""The PyTorch port's Silero VAD and realtime turn detection on the CPU,
case for case against tests/test_vad.py, then held to the JAX package on
one seeded weight set: the port's model filled from the JAX model's
random parameters (`load_jax_params`), the same seeded numpy audio through
both.

Tolerance: probabilities within ATOL = 2e-4 of JAX's (f32 on both sides,
summation order only; tests/test_torch_parity.py:19), streaming against
offline within 1e-5 as tests/test_vad.py. The turn detector is a pure
state machine: the same probabilities must give the same events.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_vad import _FakeVad  # noqa: E402

ATOL = 2e-4


@pytest.fixture(scope="module")
def jax_vad():
    from mlx_audio_tpu.vad.models.silero_vad import Model, ModelConfig

    return Model(ModelConfig()).init_and_bind()


@pytest.fixture(scope="module")
def vad(jax_vad):
    from mlx_audio_tpu.utils import flatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.vad.models.silero_vad import Model, ModelConfig

    flat = {k: np.asarray(v) for k, v in flatten(jax_vad.params).items()}
    return load_jax_params(Model(ModelConfig(), device="cpu"), flat)


def _speechy(n, seed):
    """Seeded noise with loud stretches, so that probabilities move."""
    rs = np.random.RandomState(seed)
    env = np.repeat(rs.rand(n // 512 + 1) > 0.5, 512)[:n] * 0.9 + 0.05
    return (rs.randn(n) * env).astype(np.float32)


class TestSileroModel:
    def test_feed_shapes_and_state(self, vad):
        chunk = np.random.RandomState(0).randn(512).astype(np.float32) * 0.1
        prob, state = vad.feed(chunk)
        assert prob.shape == (1, 1)
        assert 0.0 <= float(prob[0, 0]) <= 1.0
        prob2, state2 = vad.feed(chunk, state)
        assert state2.context.shape == (1, 64)

    def test_streaming_matches_offline(self, vad):
        audio = np.random.RandomState(1).randn(512 * 5).astype(np.float32) * 0.3
        offline = vad.predict_proba(audio, 16000)
        state = None
        streamed = []
        for i in range(5):
            p, state = vad.feed(audio[i * 512:(i + 1) * 512], state)
            streamed.append(float(p[0, 0]))
        np.testing.assert_allclose(offline, streamed, atol=1e-5)

    def test_8k_branch(self, vad):
        prob, state = vad.feed(np.zeros(256, np.float32), sample_rate=8000)
        assert prob.shape == (1, 1)
        with pytest.raises(ValueError):
            vad.feed(np.zeros(256, np.float32), state, sample_rate=16000)
        with pytest.raises(ValueError):
            vad.feed(np.zeros(441, np.float32), sample_rate=44100)

    def test_wrong_chunk_size_raises(self, vad):
        with pytest.raises(ValueError):
            vad.feed(np.zeros(100, np.float32))

    def test_generate_output(self, vad):
        audio = np.random.RandomState(2).randn(16000).astype(np.float32) * 0.1
        out = vad.generate(audio, 16000)
        assert out.sample_rate == 16000
        assert out.probabilities.shape[0] == 32


class TestTimestampExtraction:
    def test_hysteresis_logic(self):
        from mlx_audio_tpu_torch.vad.models.silero_vad.silero_vad import (
            _probs_to_timestamps)

        probs = np.zeros(20)
        probs[3:11] = 0.9
        out = _probs_to_timestamps(probs, 20 * 512, 16000, 0.5, 250, 100, 0,
                                   False)
        assert len(out) == 1 and out[0]["start"] == 3 * 512
        probs2 = np.zeros(20)
        probs2[5] = 0.9
        assert _probs_to_timestamps(probs2, 20 * 512, 16000, 0.5, 250, 100,
                                    0, False) == []

    def test_padding_merges_segments(self):
        from mlx_audio_tpu_torch.vad.models.silero_vad.silero_vad import (
            _probs_to_timestamps)

        probs = np.zeros(40)
        probs[2:12] = 0.9
        probs[14:24] = 0.9
        out = _probs_to_timestamps(probs, 40 * 512, 16000, 0.5, 100, 50, 100,
                                   False)
        assert len(out) == 1

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_timestamps_match_jax(self, seed):
        from mlx_audio_tpu.vad.models.silero_vad.silero_vad import (
            _probs_to_timestamps as jax_stamps)
        from mlx_audio_tpu_torch.vad.models.silero_vad.silero_vad import (
            _probs_to_timestamps)

        probs = np.random.RandomState(seed).rand(80)
        for sr in (16000, 8000):
            for secs in (False, True):
                args = (probs, 80 * 512, sr, 0.5, 100, 50, 30, secs)
                assert _probs_to_timestamps(*args) == jax_stamps(*args)


class TestMatchesJax:
    @pytest.mark.parametrize("sr,n", [(16000, 512 * 40 + 77),
                                      (8000, 256 * 40 + 31)])
    def test_offline_probabilities(self, jax_vad, vad, sr, n):
        audio = _speechy(n, 3)
        want = np.asarray(jax_vad.predict_proba(audio, sr))
        got = vad.predict_proba(audio, sr)
        assert got.shape == want.shape == (-(-n // (512 if sr == 16000
                                                    else 256)),)
        np.testing.assert_allclose(got, want, atol=ATOL)

    @pytest.mark.parametrize("sr,chunk", [(16000, 512), (8000, 256)])
    def test_streamed_probabilities_batched(self, jax_vad, vad, sr, chunk):
        """feed over 12 chunks of a 2-row batch, state carried: JAX's
        probabilities, and the offline ones of each row."""
        audio = np.stack([_speechy(chunk * 12, 4), _speechy(chunk * 12, 5)])
        sj = sp = None
        got, want = [], []
        for i in range(12):
            piece = audio[:, i * chunk:(i + 1) * chunk]
            pj, sj = jax_vad.feed(piece, sj, sample_rate=sr)
            pp, sp = vad.feed(piece, sp, sample_rate=sr)
            want.append(np.asarray(pj)[:, 0])
            got.append(pp.numpy()[:, 0])
        np.testing.assert_allclose(got, want, atol=ATOL)
        for row in range(2):
            np.testing.assert_allclose(
                np.asarray(got)[:, row], vad.predict_proba(audio[row], sr),
                atol=1e-5)

    def test_generate_matches_jax(self, jax_vad, vad):
        audio = _speechy(16000 * 3, 6)
        want = jax_vad.generate(audio, 16000, threshold=0.45)
        got = vad.generate(audio, 16000, threshold=0.45)
        np.testing.assert_allclose(got.probabilities, want.probabilities,
                                   atol=ATOL)
        assert got.timestamps == _stamps_from(want.probabilities, audio)
        assert vad.get_speech_timestamps(audio, 16000) == \
            jax_vad.get_speech_timestamps(audio, 16000)

    @pytest.mark.parametrize("layout", ["torch", "mlx"])
    def test_checkpoint_loads_through_the_router(self, jax_vad, vad,
                                                 tmp_path, layout):
        """A Silero checkpoint in torch layout (conv (O, I, W), LSTM `_l0`
        names) or mlx layout (conv (O, W, I)), with no config.json, in a
        directory named for its family: `load_model` routes it to the VAD
        loader, and it gives the probabilities of the model it was written
        from (the JAX tree's, through `load_jax_params`)."""
        from mlx_audio_tpu.utils import flatten
        from mlx_audio_tpu_torch import load_model

        ckpt = {}
        for k, v in flatten(jax_vad.params).items():
            v = np.asarray(v)
            if k.endswith(".weight") and v.ndim == 3:       # WIO
                v = np.ascontiguousarray(np.transpose(
                    v, (2, 1, 0) if layout == "torch" else (2, 0, 1)))
            elif ".lstm." in k and layout == "torch":
                k = k + "_l0"
            ckpt[k] = v
        d = tmp_path / "silero-vad"
        d.mkdir()
        np.savez(d / "model.npz", **ckpt)
        loaded = load_model(d, device="cpu")
        assert type(loaded).__module__.endswith("silero_vad")
        audio = _speechy(512 * 9, 7)
        np.testing.assert_allclose(loaded.predict_proba(audio),
                                   vad.predict_proba(audio), atol=1e-6)
        np.testing.assert_allclose(loaded.predict_proba(audio),
                                   np.asarray(jax_vad.predict_proba(audio)),
                                   atol=ATOL)

    def test_jax_sanitize_misreads_the_encoder_convs(self, jax_vad, vad):
        """The departure the port's `sanitize` makes: the JAX package's
        guesses a conv's layout from I <= W, so a torch-layout conv1
        (O, I, W) = (128, 129, 3) does not come out WIO (3, 129, 128)."""
        w = np.zeros((128, 129, 3), np.float32)
        key = "branch_16k.conv1.weight"
        assert jax_vad.sanitize({key: w})[key].shape != (3, 129, 128)
        assert vad.sanitize({key: w})[key].shape == (3, 129, 128)


def _stamps_from(probs, audio):
    from mlx_audio_tpu.vad.models.silero_vad.silero_vad import (
        _probs_to_timestamps)

    return _probs_to_timestamps(probs, len(audio), 16000, 0.45, 250, 100, 30,
                                True)


class TestTurnDetector:
    def _cfg(self):
        from mlx_audio_tpu_torch.realtime_vad import ServerVadConfig

        return ServerVadConfig(threshold=0.5, prefix_padding_ms=300,
                               silence_duration_ms=500)

    def test_start_stop_cycle(self):
        from mlx_audio_tpu_torch.realtime_vad import TurnDetector, TurnEventKind

        det = TurnDetector(self._cfg())
        events = []
        for p in [0.1, 0.2, 0.9, 0.9, 0.9]:
            events += det.push(p, 32.0)
        assert [e.kind for e in events] == [TurnEventKind.SPEECH_STARTED]
        assert det.in_speech
        for _ in range(16):
            events += det.push(0.1, 32.0)
        assert events[-1].kind == TurnEventKind.SPEECH_STOPPED
        assert not det.in_speech

    def test_prefix_padding_applied(self):
        from mlx_audio_tpu_torch.realtime_vad import TurnDetector

        det = TurnDetector(self._cfg())
        for _ in range(20):
            det.push(0.0, 32.0)
        ev = det.push(0.9, 32.0)
        assert ev[0].audio_ms == 21 * 32 - 32 - 300

    def test_silence_resets_on_speech(self):
        from mlx_audio_tpu_torch.realtime_vad import TurnDetector

        det = TurnDetector(self._cfg())
        det.push(0.9, 32.0)
        for _ in range(10):
            det.push(0.1, 32.0)
        assert det.in_speech
        det.push(0.9, 32.0)
        for _ in range(10):
            det.push(0.1, 32.0)
        assert det.in_speech

    def test_parse_turn_detection(self):
        from mlx_audio_tpu_torch.realtime_vad import (TurnDetectionError,
                                                      parse_turn_detection)

        assert parse_turn_detection(None) is None
        cfg = parse_turn_detection({"type": "server_vad", "threshold": 0.7})
        assert cfg.threshold == 0.7
        assert cfg.to_dict()["type"] == "server_vad"
        with pytest.raises(TurnDetectionError):
            parse_turn_detection({"type": "semantic_vad"})
        with pytest.raises(TurnDetectionError):
            parse_turn_detection({"type": "bogus"})

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_events_match_jax(self, seed):
        """The same probabilities (runs of speech and silence) under the
        same config give the JAX detector's events."""
        from mlx_audio_tpu.realtime_vad import ServerVadConfig as JCfg
        from mlx_audio_tpu.realtime_vad import TurnDetector as JDet
        from mlx_audio_tpu_torch.realtime_vad import (ServerVadConfig,
                                                      TurnDetector)

        rs = np.random.RandomState(seed)
        probs = np.repeat(rs.rand(40), rs.randint(1, 30, 40))
        kw = dict(threshold=0.3 + 0.1 * seed, prefix_padding_ms=100 * seed,
                  silence_duration_ms=200 + 100 * seed)
        jd, pd = JDet(JCfg(**kw)), TurnDetector(ServerVadConfig(**kw))
        want = [(e.kind.value, e.audio_ms) for p in probs
                for e in jd.push(float(p), 32.0)]
        got = [(e.kind.value, e.audio_ms) for p in probs
               for e in pd.push(float(p), 32.0)]
        assert got == want and len(got) >= 2


class TestStreamingVad:
    def test_frame_buffering_and_events(self):
        from mlx_audio_tpu_torch.realtime_vad import (ServerVadConfig,
                                                      StreamingVad,
                                                      TurnEventKind)

        probs = [0.1] * 3 + [0.9] * 5 + [0.0] * 30
        sv = StreamingVad(_FakeVad(probs), ServerVadConfig())
        events = []
        audio = np.zeros(512 * 38, np.float32)
        for off in range(0, len(audio), 700):
            events += sv.process(audio[off: off + 700])
        assert [e.kind for e in events] == [TurnEventKind.SPEECH_STARTED,
                                            TurnEventKind.SPEECH_STOPPED]

    def test_silero_events_match_jax(self, jax_vad, vad):
        """StreamingVad over each package's Silero (one weight set), fed
        the same audio in uneven pieces: the same events at the same
        times."""
        from mlx_audio_tpu.realtime_vad import ServerVadConfig as JCfg
        from mlx_audio_tpu.realtime_vad import StreamingVad as JSV
        from mlx_audio_tpu_torch.realtime_vad import (ServerVadConfig,
                                                      StreamingVad)

        probs = vad.predict_proba(_speechy(512 * 60, 8))
        threshold = float(np.median(probs))   # random weights: put the
        kw = dict(threshold=threshold, prefix_padding_ms=64,  # threshold
                  silence_duration_ms=96)                     # mid-range
        js, ps = JSV(jax_vad, JCfg(**kw)), StreamingVad(vad,
                                                        ServerVadConfig(**kw))
        audio = _speechy(512 * 60, 8)
        want, got = [], []
        for off in range(0, len(audio), 900):
            piece = audio[off:off + 900]
            want += [(e.kind.value, e.audio_ms) for e in js.process(piece)]
            got += [(e.kind.value, e.audio_ms) for e in ps.process(piece)]
        assert got == want and got
