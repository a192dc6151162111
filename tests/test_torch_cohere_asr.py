"""The port's Cohere ASR against the JAX package, on the CPU at f32: the
front end and the chunkers, the Canary decoder (prefill and step logits),
the encoder over a ragged batch, the greedy tokens and text of
`_transcribe_segments`, `generate` and `transcribe`, the VAD path, the
errors, the loaders, and the departures: a row of length 0 is finite and
finished from the start, and a batch whose rows reach EOS stops.

Both packages run one weight set: the JAX model's random parameters
(tests/test_cohere_asr.py's tiny config) loaded into the port with
`model.load_jax_params`. Tensors agree within ATOL = 2e-4, the repo's f32
precedent (tests/test_torch_parity.py); tokens and text are equal.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlx_audio_tpu.stt.models.cohere_asr import cohere_asr as jca  # noqa: E402
from mlx_audio_tpu.utils import flatten  # noqa: E402
from test_cohere_asr import FakeTokenizer, tiny_config  # noqa: E402

ATOL = 2e-4
SR = 16000


def config_dict(**over):
    """tests/test_cohere_asr.py's tiny config as a plain dict."""
    import dataclasses

    return json.loads(json.dumps(dataclasses.asdict(tiny_config(**over))))


def model_pair(**over):
    """(JAX model, port model on the CPU) with the JAX model's random
    parameters in both, and the fake tokenizer in both."""
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.cohere_asr import Model, ModelConfig

    jm = jca.Model(tiny_config(**over)).init_and_bind()
    pm = Model(ModelConfig.from_dict(config_dict(**over)), device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in
                         flatten(jm.params).items()})
    jm._tokenizer = FakeTokenizer()
    pm._tokenizer = FakeTokenizer()
    return jm, pm


@pytest.fixture(scope="module")
def pair():
    return model_pair()


def noise(seed: int, seconds: float, scale: float = 1.0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(int(SR * seconds))
            * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


# ------------------------------------------------------ front end, chunks


@pytest.mark.parametrize("seconds", [0.0, 0.005, 0.25, 1.3])
def test_log_mel_matches_jax(pair, seconds):
    jm, pm = pair
    x = noise(int(seconds * 100), seconds)
    (want, n_want), (got, n_got) = jm._log_mel(x), pm._log_mel(x)
    assert n_got == n_want and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", range(4))
def test_energy_chunks_match_jax(case):
    from mlx_audio_tpu_torch.stt.models.cohere_asr import cohere_asr as pca

    x = noise(case, 3 + 2 * case, 0.1)
    x[int(1.7 * SR):int(1.8 * SR)] = 0.0
    args = [(x, SR, 2.0, 0.5, 160), (x, SR, 35.0, 5.0, 1600),
            (x[:900], SR, 0.05, 0.01, 160), (x, SR, 1.0, 0.9, 4000)][case]
    assert pca.split_audio_chunks_energy(*args) == \
        jca.split_audio_chunks_energy(*args)
    assert pca._quietest_split(x, 100, 9000, 160) == \
        jca._quietest_split(x, 100, 9000, 160)


@pytest.mark.parametrize("texts,lang", [(["a", " b ", ""], "en"),
                                        (["a", "b"], "ja"), ([], "zh"),
                                        (["  x", "y  "], "fr")])
def test_join_chunk_texts_matches_jax(texts, lang):
    from mlx_audio_tpu_torch.stt.models.cohere_asr import cohere_asr as pca

    assert pca.join_chunk_texts(texts, lang) == \
        jca.join_chunk_texts(texts, lang)


class FakeVad:
    """tests/test_cohere_asr.py:144-150's VAD (speech at the start and the
    end), or seeded random probabilities."""

    def __init__(self, seed=None):
        self.seed = seed

    def predict_proba(self, audio, sr):
        n = len(audio) // 512
        if self.seed is not None:
            return np.random.RandomState(self.seed).rand(n).astype(np.float32)
        p = np.zeros(n, np.float32)
        p[: n // 3] = 0.9
        p[2 * n // 3:] = 0.9
        return p


@pytest.mark.parametrize("seed,gap,cap", [(None, 0.5, 30.0), (None, 4.0, 2.0),
                                          (3, 0.3, 30.0), (5, 1.0, 1.0)])
def test_segment_with_silero_matches_jax(seed, gap, cap):
    from mlx_audio_tpu_torch.stt.models.cohere_asr import cohere_asr as pca

    x = np.zeros(10 * SR, np.float32)
    kw = dict(merge_gap_s=gap, max_chunk_s=cap)
    got = pca.segment_with_silero(x, FakeVad(seed), SR, **kw)
    assert got == jca.segment_with_silero(x, FakeVad(seed), SR, **kw)
    assert got and got[-1][1] <= len(x)


# ---------------------------------------------------------------- decoder


def _encoded(jm, rows=2, seed=0):
    """A JAX encoder output (B, 32, d) and its mask (row 1 ragged)."""
    enc, mask = jm._fns(256, rows, 9, 8)[0](
        jm.params, jnp.asarray(np.random.RandomState(seed).randn(
            rows, 256, 20).astype(np.float32)),
        jnp.asarray(np.array([256, 100] + [60] * (rows - 2), np.int32)))
    return np.array(enc), np.array(mask)


def test_decoder_prefill_and_step_logits_match_jax(pair):
    from mlx_audio_tpu.ops.kvcache import KVCache as JaxKVCache
    from mlx_audio_tpu.stt.models.canary import canary as jcn
    from mlx_audio_tpu_torch.ops.kvcache import KVCache
    from mlx_audio_tpu_torch.stt.models.canary import canary as pcn

    jm, pm = pair
    dec = jm.config.transf_decoder.inner()
    enc, mask = _encoded(jm)
    hd = dec.hidden_size // dec.num_attention_heads
    prompt = np.array([[0, 1, 2, 3, 3, 5, 7, 8, 9]] * 2, np.int32)
    jpos = jnp.asarray(jcn._fixed_positions(dec.max_sequence_length,
                                            dec.hidden_size))
    jcaches = [JaxKVCache.init(2, 16, dec.num_attention_heads, hd,
                               dtype=jnp.float32)
               for _ in range(dec.num_layers)]
    jckv = jcn.cross_kv(jm.params["decoder"], dec, jnp.asarray(enc))
    want, jcaches = jcn.decoder_forward(
        jm.params["decoder"], dec, jnp.asarray(prompt), jnp.asarray(mask),
        jcaches, jckv, jnp.int32(0), jpos)

    caches = KVCache.init(2, 16, dec.num_attention_heads, hd,
                          dtype=torch.float32, n_layers=dec.num_layers)
    ckv = pcn.cross_kv(pm.decoder, pm.dec_cfg, torch.from_numpy(enc))
    ebias = pcn.encoder_bias(torch.from_numpy(mask))
    with torch.inference_mode():
        h = pcn.decoder_forward(pm.decoder, pm.dec_cfg,
                                torch.from_numpy(prompt).long(), ebias, caches,
                                ckv, 0, pm.pos_table)
        _close(pcn.logits(pm.decoder, h), want)
        for i, tok in enumerate((17, 4)):
            ids = np.full((2, 1), tok, np.int32)
            want, jcaches = jcn.decoder_forward(
                jm.params["decoder"], dec, jnp.asarray(ids),
                jnp.asarray(mask), jcaches, jckv, jnp.int32(9 + i), jpos)
            h = pcn.decoder_forward(pm.decoder, pm.dec_cfg,
                                    torch.from_numpy(ids).long(), ebias,
                                    caches, ckv, 9 + i, pm.pos_table)
            _close(pcn.logits(pm.decoder, h), want)
    assert caches.k.dtype == torch.float32
    for i in range(dec.num_layers):
        _close(caches.k[i, :, :11], jcaches[i].k[:, :11])


def test_fixed_positions_are_jax_table():
    from mlx_audio_tpu.stt.models.canary import canary as jcn
    from mlx_audio_tpu_torch.stt.models.canary import canary as pcn

    np.testing.assert_array_equal(pcn._fixed_positions(64, 24),
                                  jcn._fixed_positions(64, 24))


def test_piece_list_tokenizer_matches_jax():
    from mlx_audio_tpu.stt.models.canary import CanaryTokenizer as JaxTok
    from mlx_audio_tpu_torch.stt.models.canary import CanaryTokenizer

    pieces = ["<|startofcontext|>", "<|startoftranscript|>",
              "<|emo:undefined|>", "<|en|>", "<|fr|>", "<|pnc|>",
              "<|nopnc|>", "<|noitn|>", "<|notimestamp|>", "<|nodiarize|>",
              "<|endoftext|>", "▁hello", "▁wor", "ld", "!"]
    got, want = CanaryTokenizer(piece_list=pieces), JaxTok(piece_list=pieces)
    for ids in ([11, 12, 13, 14], [12, 99, -1, 13], []):
        assert got.decode(ids) == want.decode(ids)
    assert got.eos_id == want.eos_id == 10
    assert got.build_prompt_tokens("fr", "en", False) == \
        want.build_prompt_tokens("fr", "en", False)
    with pytest.raises(RuntimeError):
        got.encode("hi")


# ---------------------------------------------------------------- encoder


def test_encode_valid_rows_match_jax(pair):
    jm, pm = pair
    feats = np.random.RandomState(1).randn(3, 512, 20).astype(np.float32)
    lens = np.array([512, 300, 37], np.int32)
    want, wmask = jm._fns(512, 3, 9, 8)[0](jm.params, jnp.asarray(feats),
                                           jnp.asarray(lens))
    got, mask = pm.encode(torch.from_numpy(feats),
                          torch.from_numpy(lens.astype(np.int64)))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    m = np.asarray(wmask)[..., None]
    _close(got.numpy() * m, np.asarray(want) * m)


def test_zero_length_row_is_finite_and_done(pair):
    """JAX's encoder row of length 0 is NaN; the port's is finite, and the
    decode starts it finished: all EOS, while the real row decodes JAX's
    tokens."""
    jm, pm = pair
    feats = np.random.RandomState(2).randn(2, 256, 20).astype(np.float32)
    lens = np.array([200, 0], np.int32)
    jenc, jmask = jm._fns(256, 2, 9, 8)[0](jm.params, jnp.asarray(feats),
                                           jnp.asarray(lens))
    assert np.isnan(np.asarray(jenc)[1]).all()
    enc, mask = pm.encode(torch.from_numpy(feats),
                          torch.from_numpy(lens.astype(np.int64)))
    assert torch.isfinite(enc).all() and not mask[1].any()
    prompt = pm._prompt_tokens("en", True)
    eos = pm._tokenizer.eos_id
    toks, steps = pm.decode(enc, mask, prompt, 8, eos)
    assert (toks[1] == eos).all()
    want = np.asarray(jm._fns(256, 2, 9, 8)[1](
        jm.params, jenc, jmask, jnp.asarray(np.tile(np.array(prompt,
                                                             np.int32),
                                                    (2, 1))),
        jnp.int32(eos)))
    np.testing.assert_array_equal(toks[0].numpy(), want[0])
    assert (want[1] != eos).all()          # JAX's NaN row never finishes


@pytest.mark.parametrize("rows", [[200], [200, 150], [200, 0, 0]])
def test_batch_stops_once_its_real_rows_reach_eos(rows):
    """With EOS forced through the head's bias every real row finishes at
    step 0 and a length-0 row is finished from the start: the loop stops
    within 2 steps (one step late), and every token is EOS."""
    _, pm = model_pair()
    eos = pm._tokenizer.eos_id
    with torch.no_grad():
        pm.decoder.output_proj.bias[eos] = 1e4
    feats = torch.from_numpy(np.random.RandomState(3).randn(
        len(rows), 256, 20).astype(np.float32))
    enc, mask = pm.encode(feats, torch.tensor(rows))
    toks, steps = pm.decode(enc, mask, pm._prompt_tokens("en", True), 32,
                            eos)
    assert steps <= 2 and (toks == eos).all()
    texts, counts, _ = pm._transcribe_segments(
        [noise(4, 1.0), noise(5, 0.5)], "en", True, 2, 32)
    assert texts == ["", ""] and counts == [0, 0]
    assert pm.last_run["decode_steps"] <= 2


# ---------------------------------------------------------- transcription


@pytest.mark.parametrize("batch_size,max_tokens", [(2, 6), (1, 6), (3, 12),
                                                   (8, 5)])
def test_transcribe_segments_matches_jax(pair, batch_size, max_tokens):
    """Texts and counts equal JAX's, whose trailing batch is padded (and
    its padded rows NaN); the port runs each batch at its real rows."""
    jm, pm = pair
    segs = [noise(10 + i, s) for i, s in enumerate((0.5, 0.25, 1.1, 0.7,
                                                    0.3))]
    want = jm._transcribe_segments(segs, "en", True, batch_size, max_tokens)
    got = pm._transcribe_segments(segs, "en", True, batch_size, max_tokens)
    assert got == want
    assert pm.last_run["batches"] == -(-len(segs) // batch_size)


@pytest.mark.parametrize("seconds,max_tokens", [(0.5, 8), (5.0, 6),
                                                (5.0, 40), (3.3, 200)])
def test_generate_matches_jax(pair, seconds, max_tokens):
    jm, pm = pair
    x = noise(int(seconds * 10), seconds)
    want = jm.generate(x, language="en", max_tokens=max_tokens)
    got = pm.generate(x, language="en", max_tokens=max_tokens)
    assert got.text == want.text and got.segments == want.segments
    assert (got.generation_tokens, got.prompt_tokens, got.language) == \
        (want.generation_tokens, want.prompt_tokens, want.language)
    assert got.text and got.total_time > 0


def test_generate_with_options_matches_jax(pair, tmp_path):
    """nopnc, another batch size, an 8-kHz array (resampled) and a WAV
    path give JAX's results."""
    from mlx_audio_tpu_torch import audio_io

    jm, pm = pair
    x8k = noise(21, 1.5)[:12000]
    kw = dict(language="en", punctuation=False, batch_size=1, max_tokens=5)
    want = jm.generate(x8k, sample_rate=8000, **kw)
    got = pm.generate(x8k, sample_rate=8000, **kw)
    assert (got.text, got.segments) == (want.text, want.segments)
    audio_io.write(tmp_path / "a.wav", noise(22, 2.4, 0.3), SR)
    want = jm.generate(str(tmp_path / "a.wav"), max_tokens=7)
    got = pm.generate(tmp_path / "a.wav", max_tokens=7)
    assert (got.text, got.segments) == (want.text, want.segments)


def test_transcribe_matches_jax(pair, tmp_path):
    from mlx_audio_tpu_torch import audio_io

    jm, pm = pair
    arrays = [noise(30, 0.5), noise(31, 4.0), noise(32, 0.3)]
    kw = dict(language="en", max_tokens=6)
    want = jm.transcribe(audio_arrays=arrays, sample_rates=[SR, SR, SR], **kw)
    got = pm.transcribe(audio_arrays=arrays, sample_rates=[SR, SR, SR], **kw)
    assert got == want and len(got) == 3 and all(got)
    paths = []
    for i, a in enumerate(arrays[:2]):
        paths.append(tmp_path / f"{i}.wav")
        audio_io.write(paths[-1], a, SR)
    assert pm.transcribe(audio_files=paths, **kw) == \
        jm.transcribe(audio_files=[str(p) for p in paths], **kw)
    assert pm.transcribe(audio_arrays=[], sample_rates=[], **kw) == []


def test_vad_segments_match_jax(pair):
    jm, pm = pair
    x = noise(40, 3.0, 0.2)
    jm.set_vad_model(FakeVad(7))
    pm.set_vad_model(FakeVad(7))
    kw = dict(language="en", max_tokens=4, vad=True, vad_merge_gap_s=0.2,
              vad_max_chunk_s=1.0)
    want, got = jm.generate(x, **kw), pm.generate(x, **kw)
    assert (got.text, got.segments) == (want.text, want.segments)
    assert len(got.segments) > 1
    pm.set_vad_model(None)


def test_bf16_model_keeps_f32_statistics_and_runs(pair):
    """A bf16 model computes in bf16 with f32 batch-norm statistics and
    f32 self-attention caches; its encoder rows stay near the f32 ones."""
    _, pm = pair
    from mlx_audio_tpu_torch.stt.models.cohere_asr import Model

    bm = Model(pm.config, device="cpu")
    bm.load_state_dict(pm.state_dict())
    bm.astype(torch.bfloat16)
    bm._tokenizer = pm._tokenizer
    bn = bm.encoder.layers[0].conv.batch_norm
    assert bn.running_var.dtype == torch.float32 and bm.dtype == torch.bfloat16
    feats = torch.from_numpy(np.random.RandomState(6).randn(
        2, 256, 20).astype(np.float32))
    lens = torch.tensor([256, 0])
    enc, _ = bm.encode(feats, lens)
    ref, _ = pm.encode(feats, lens)
    assert enc.dtype == torch.bfloat16 and torch.isfinite(enc).all()
    rel = float(torch.linalg.norm(enc.float()[0] - ref[0])
                / torch.linalg.norm(ref[0]))
    assert rel < 5e-2
    out = bm.generate(noise(7, 1.0), max_tokens=4)
    assert out.generation_tokens == 4


# ------------------------------------------------------------------ errors


def test_errors_like_jax(pair):
    _, pm = pair
    with pytest.raises(ValueError, match="Unsupported language"):
        pm.generate(np.zeros(100, np.float32), language="xx")
    with pytest.raises(NotImplementedError):
        pm.generate(np.zeros(100, np.float32), stream=True)
    with pytest.raises(ValueError, match="exactly one"):
        pm.transcribe(language="en")
    with pytest.raises(ValueError, match="sample_rates"):
        pm.transcribe(language="en", audio_arrays=[np.zeros(10)])
    with pytest.raises(ValueError, match="mono"):
        pm.generate(np.zeros((2, 3, 4), np.float32))
    with pytest.raises(ValueError, match="unknown vad backend"):
        pm.generate(np.zeros(100, np.float32), vad="webrtc")


def test_vad_without_a_model_raises_naming_silero(pair):
    """JAX would download a silero model here; the port names the family
    and downloads nothing."""
    _, pm = pair
    with pytest.raises(RuntimeError, match="silero VAD.*set_vad_model"):
        pm.generate(np.zeros(16000, np.float32), vad=True)


def test_no_tokenizer_raises():
    from mlx_audio_tpu_torch.stt.models.cohere_asr import Model, ModelConfig

    pm = Model(ModelConfig.from_dict(config_dict()), device="cpu")
    with pytest.raises(RuntimeError, match="tokenizer not loaded"):
        pm.generate(np.zeros(1000, np.float32))


def test_max_tokens_clamped_to_the_decoder_length(pair):
    """max_tokens past max_sequence_length - prompt is clamped, as JAX's."""
    jm, pm = model_pair(transf_decoder=dict(config_dict=dict(
        hidden_size=24, inner_size=48, num_attention_heads=4, num_layers=2,
        max_sequence_length=16)))
    x = noise(8, 0.4)
    want, got = jm.generate(x, max_tokens=100), pm.generate(x, max_tokens=100)
    assert got.generation_tokens == want.generation_tokens <= 7
    assert got.text == want.text


# ----------------------------------------------------------------- loading


def _nemo_tree(pm):
    from chip_smoke import cohere_nemo_names

    return cohere_nemo_names({k: v.numpy() for k, v in
                              pm.state_dict().items()})


def test_sanitize_matches_jax(pair):
    """NeMo names and torch conv layouts through both packages' sanitize:
    the same names and arrays (the JAX tree's), and load_jax_params takes
    them back to the port's exact parameters."""
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.cohere_asr import Model

    jm, pm = pair
    tree = _nemo_tree(pm)
    tree["encoder.layers.1.conv.batch_norm.num_batches_tracked"] = np.zeros(())
    tree["preprocessor.featurizer.fb"] = np.zeros((1, 20, 65), np.float32)
    want = {k: np.asarray(v) for k, v in jm.sanitize(tree).items()}
    got = pm.sanitize(tree)
    assert set(got) == set(want) == set(flatten(jm.params))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    fresh = load_jax_params(Model(pm.config, device="cpu"), got)
    for k, v in pm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_post_load_hook_reads_tokens_and_preprocessor_buffers(pair, tmp_path):
    """tokens.json gives the piece-list tokenizer; the checkpoint's fb and
    window (npz) replace the analytic ones, as JAX's hook does for
    safetensors."""
    from chip_smoke import write_cohere_checkpoint
    from mlx_audio_tpu_torch.stt.models.cohere_asr import Model

    _, pm = pair
    write_cohere_checkpoint(pm, tmp_path)
    data = dict(np.load(tmp_path / "model.npz"))
    fb = data["preprocessor.featurizer.fb"] * 2.0
    win = np.ones(128, np.float32)[:pm.config.preprocessor.win_length]
    data["preprocessor.featurizer.fb"], data["preprocessor.featurizer.window"] \
        = fb, win
    np.savez(tmp_path / "model.npz", **data)
    m = Model.post_load_hook(Model(pm.config, device="cpu"), tmp_path)
    np.testing.assert_array_equal(m._fb(), fb[0])
    pad = 128 - len(win)
    np.testing.assert_array_equal(m._stft_window(), np.concatenate(
        [np.zeros(pad // 2), win, np.zeros(pad - pad // 2)]))
    assert m._tokenizer.decode([10, 11]) == "10 11"
    assert m._tokenizer.eos_id == 9


def test_tokenizer_model_needs_sentencepiece(tmp_path, monkeypatch):
    """A tokenizer.model goes through sentencepiece; without the package
    the hook raises, naming it, rather than passing as JAX's does."""
    import sys

    from mlx_audio_tpu_torch.stt.models.cohere_asr import Model, ModelConfig

    (tmp_path / "tokenizer.model").write_bytes(b"\0")
    np.savez(tmp_path / "w.npz", x=np.zeros(1))
    monkeypatch.setitem(sys.modules, "sentencepiece", None)
    m = Model(ModelConfig.from_dict(config_dict()), device="cpu")
    with pytest.raises(ImportError, match="sentencepiece"):
        Model.post_load_hook(m, tmp_path)
