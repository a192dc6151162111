"""SAM-Audio of the PyTorch port against the JAX package, on the CPU: the
cases of tests/test_sam_audio.py (T5 with a mask, the DiT, `separate` in
euler and midpoint, anchors, an invalid step size, `separate_long` and
`separate_streaming`, the server's separation route), each held to the
JAX package's on one weight set and the same noise; the departures pinned
(the frames the audio has rather than JAX's feature bucket, the text at
its own length, the tokenizer read from the directory only, conv layouts
read from shapes, q8 of the linears alone where JAX's q8 breaks).

Config: tests/test_sam_audio.py's `tiny_cfg` (hop 8, so 512 samples make
64 frames, JAX's smallest feature bucket); one parameter set drawn with
numpy over JAX's shapes (`test_torch_dacvae.draw_tree`: biases and alphas
drawn; the anchor gate 1 and the anchor table scaled by 50, so that
anchors count); the JAX side jitted by its own model. ATOL = 2e-4 (f32, summation order;
tests/test_torch_parity.py:19).
"""

import asyncio
import base64
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_sam_audio import FakeT5Tok, tiny_cfg  # noqa: E402
from test_torch_dacvae import draw_tree  # noqa: E402

ATOL = 2e-4
CFG = dict(
    in_channels=6 * 8,
    audio_codec=dict(encoder_dim=4, encoder_rates=[2, 4], latent_dim=16,
                     decoder_dim=8, decoder_rates=[4, 2], codebook_dim=8,
                     sample_rate=16000),
    text_encoder=dict(vocab_size=64, d_model=16, d_kv=4, d_ff=32,
                      num_layers=2, num_heads=4, dim=16),
    transformer=dict(dim=32, n_heads=4, n_layers=2, context_dim=32,
                     out_channels=16, ffn_exp=2, frequency_embedding_dim=16),
    num_anchors=3, anchor_embedding_dim=8)
EULER = {"step_size": 0.5, "method": "euler"}


@pytest.fixture(scope="module")
def pair():
    import jax.numpy as jnp

    from mlx_audio_tpu.sts.models.sam_audio import Model as JModel
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.sts.models.sam_audio import Model, ModelConfig

    jm = JModel(tiny_cfg())
    assert vars(jm.config.dit_cfg) == vars(ModelConfig.from_dict(CFG).dit_cfg)
    flat = draw_tree(jm.init_params, 0)
    flat["embed_anchors.embed.weight"] = flat["embed_anchors.embed.weight"] * 50
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    jm.tokenizer = FakeT5Tok()
    pm = load_jax_params(Model(ModelConfig.from_dict(CFG), device="cpu"),
                         flat)
    pm.tokenizer = FakeT5Tok()
    return jm, pm, flat


def _audio(seed, n, b=1):
    return np.random.RandomState(seed).randn(b, 1, n).astype(np.float32) * 0.1


def _noise(seed, frames, b=1):
    import jax

    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (b, frames, 16)))


# -- components -----------------------------------------------------------


def test_relative_buckets_equal_jax():
    """T5's bidirectional buckets over -300..300 at 32 buckets and
    distance 128 (the T5-base defaults) and at 16 / 20, equal to JAX's."""
    import jax.numpy as jnp

    from mlx_audio_tpu.sts.models.sam_audio.t5 import \
        _relative_position_bucket
    from mlx_audio_tpu_torch.sts.models.sam_audio.t5 import \
        relative_position_bucket

    rel = np.arange(-300, 301)
    for nb, md in ((32, 128), (16, 20)):
        want = np.asarray(_relative_position_bucket(jnp.asarray(rel), nb, md))
        got = relative_position_bucket(torch.from_numpy(rel), nb, md).numpy()
        np.testing.assert_array_equal(got, want)


def test_t5_encode_with_a_mask_matches_jax(pair):
    """T5 over (2, 10) ids, the second row padded after 6 (its padded keys
    masked with -inf): the valid rows within ATOL of JAX's."""
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.sts.models.sam_audio.t5 import t5_encode as j_encode
    from mlx_audio_tpu_torch.sts.models.sam_audio.t5 import t5_encode

    jm, pm, _ = pair
    ids = np.random.RandomState(0).randint(1, 64, (2, 10))
    mask = np.ones((2, 10), np.int64)
    mask[1, 6:] = 0
    want = np.asarray(jax.jit(lambda p, i, m: j_encode(
        p, jm.config.t5_cfg, i, m))(jm.params["text_encoder"],
                                    jnp.asarray(ids), jnp.asarray(mask)))
    got = t5_encode(pm.text_encoder, torch.from_numpy(ids),
                    torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, 10, 16)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)
    np.testing.assert_allclose(got[1, :6], want[1, :6], atol=ATOL)


def test_heads_sam_is_strided():
    """SAM-Audio's head split takes channels h, h + H, ... for head h: equal
    to JAX's `_heads_sam` and not to view(B, T, H, D)."""
    import jax.numpy as jnp

    from mlx_audio_tpu.sts.models.sam_audio.dit import _heads_sam
    from mlx_audio_tpu_torch.sts.models.sam_audio.dit import heads_sam

    x = np.arange(2 * 3 * 12, dtype=np.float32).reshape(2, 3, 12)
    got = heads_sam(torch.from_numpy(x), 4).numpy()
    np.testing.assert_array_equal(got, np.asarray(_heads_sam(jnp.asarray(x),
                                                             4)))
    assert got[0, 1, 0].tolist() == [1.0, 5.0, 9.0]
    usual = x.reshape(2, 3, 4, 3).transpose(0, 2, 1, 3)
    assert not np.array_equal(got, usual)


def test_dit_forward_matches_jax(pair):
    """The DiT on (2, 12, 32) with times, a text memory of 5 rows with a
    padding mask and a padding mask on x: within ATOL of JAX's."""
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.sts.models.sam_audio.dit import dit_forward as j_dit
    from mlx_audio_tpu_torch.sts.models.sam_audio.dit import dit_forward

    jm, pm, _ = pair
    rs = np.random.RandomState(0)
    x = rs.randn(2, 12, 32).astype(np.float32)
    t = np.asarray([0.1, 0.5], np.float32)
    mem = rs.randn(2, 5, 32).astype(np.float32)
    pad = np.ones((2, 12), bool)
    pad[1, 9:] = False
    mpad = np.ones((2, 5), bool)
    mpad[0, 3:] = False
    want = np.asarray(jax.jit(lambda p, *a: j_dit(
        p, jm.config.dit_cfg, a[0], a[1], padding_mask=a[2], memory=a[3],
        memory_padding_mask=a[4]))(jm.params["transformer"], x, t, pad, mem,
                                   mpad))
    got = dit_forward(pm.transformer, *(torch.from_numpy(a) for a in (
        x, t)), padding_mask=torch.from_numpy(pad),
        memory=torch.from_numpy(mem),
        memory_padding_mask=torch.from_numpy(mpad)).numpy()
    assert got.shape == want.shape == (2, 12, 16)
    np.testing.assert_allclose(got, want, atol=ATOL)


# -- separation -----------------------------------------------------------


def _same(a, b, atol=ATOL):
    assert len(a.target) == len(b.target)
    for x, y in zip(a.target + a.residual, b.target + b.residual):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, atol=atol)


@pytest.mark.parametrize("method,step", [("euler", 0.5), ("midpoint", 0.25)])
def test_separate_at_a_bucket_length_matches_jax(pair, method, step):
    """512 samples (64 frames, a JAX feature bucket), JAX's noise: target
    and residual within ATOL of JAX's, shapes (512, 1)."""
    jm, pm, _ = pair
    audio, noise = _audio(0, 512), _noise(3, 64)
    opt = {"step_size": step, "method": method}
    want = jm.separate(audio, ["a dog barking"], noise=noise, ode_opt=opt)
    got = pm.separate(audio, ["a dog barking"], noise=noise, ode_opt=opt)
    assert got.target[0].shape == (512, 1)
    _same(got, want)
    assert pm.last_run["evals"] == int(1 / step) * (1 if method == "euler"
                                                    else 2)


def test_anchors_match_jax(pair):
    """A `+` anchor over the first 10 ms (the gate drawn at 1, so it
    counts) within ATOL of JAX's, and not equal to the run without it."""
    jm, pm, _ = pair
    audio, noise = _audio(3, 512), _noise(1, 64)
    kw = dict(noise=noise, ode_opt=EULER, anchors=[[("+", 0.0, 0.01)]])
    want = jm.separate(audio, ["speech"], **kw)
    got = pm.separate(audio, ["speech"], **kw)
    _same(got, want)
    plain = pm.separate(audio, ["speech"], noise=noise, ode_opt=EULER)
    assert not np.allclose(plain.target[0], got.target[0], atol=1e-3)


def test_the_frames_the_audio_has(pair, monkeypatch):
    """The departure: 400 samples make 50 frames. JAX pads them to its
    64-frame bucket, whose GroupNorm(1) and edge convs read the padding, so
    its valid rows differ from the port's; with a 50-frame bucket added to
    JAX's list the two agree within ATOL."""
    from mlx_audio_tpu.sts.models.sam_audio import model as jmodel

    jm, pm, _ = pair
    audio, noise = _audio(0, 400), _noise(5, 64)
    got = pm.separate(audio, ["speech"], noise=noise, ode_opt=EULER)
    bucketed = jm.separate(audio, ["speech"], noise=noise, ode_opt=EULER)
    assert got.target[0].shape == bucketed.target[0].shape == (400, 1)
    assert np.abs(got.target[0] - bucketed.target[0]).max() > 10 * ATOL
    monkeypatch.setattr(jmodel, "FEATURE_BUCKETS", (50, 64, 128))
    _same(got, jm.separate(audio, ["speech"], noise=noise[:, :50],
                           ode_opt=EULER))


def test_text_padding_changes_nothing(pair):
    """Two descriptions of 13 and 5 tokens in one batch: the shorter row is
    padded (to 13 in the port, to JAX's 16-token bucket there) and masked
    out of T5 and the cross-attention. Both rows equal JAX's, and the
    padded row equals that description run alone, unpadded."""
    jm, pm, _ = pair
    audio, noise = _audio(1, 512, b=2), _noise(2, 64, b=2)
    texts = ["a dog barking!", "rain"]
    want = jm.separate(audio, texts, noise=noise, ode_opt=EULER)
    got = pm.separate(audio, texts, noise=noise, ode_opt=EULER)
    assert pm.last_run["text_len"] == 13
    _same(got, want)
    alone = pm.separate(audio[1:], texts[1:], noise=noise[1:], ode_opt=EULER)
    np.testing.assert_allclose(alone.target[0], got.target[1], atol=ATOL)


def test_sizes_mask_a_batch_row(pair):
    """Rows of 64 and 40 valid frames (sizes): the short row masked out of
    the DiT's self-attention and cut to 320 samples, as JAX's."""
    jm, pm, _ = pair
    audio, noise = _audio(4, 512, b=2), _noise(4, 64, b=2)
    sizes = np.asarray([64, 40])
    want = jm.separate(audio, ["x", "y"], sizes=sizes, noise=noise,
                       ode_opt=EULER)
    got = pm.separate(audio, ["x", "y"], sizes=sizes, noise=noise,
                      ode_opt=EULER)
    assert got.target[1].shape == (320, 1)
    _same(got, want)


def test_invalid_step_size_raises(pair):
    _, pm, _ = pair
    for step in (2.0, 0.0):
        with pytest.raises(ValueError, match="step_size"):
            pm.separate(np.zeros((1, 1, 512), np.float32), ["x"],
                        ode_opt={"step_size": step})


def _jax_draws(monkeypatch, pm):
    """The port's noise seam fed JAX's draws: normal(PRNGKey(seed)) at the
    chunk's feature bucket, cut to its frames."""
    import jax

    from mlx_audio_tpu.sts.models.sam_audio.model import (FEATURE_BUCKETS,
                                                          _bucket)

    def draw(shape, seed):
        b, t, c = shape
        full = jax.random.normal(jax.random.PRNGKey(seed),
                                 (b, _bucket(t, FEATURE_BUCKETS), c))
        return torch.from_numpy(np.array(full)[:, :t])

    monkeypatch.setattr(pm, "_draw_noise", draw)


def test_long_and_streaming_match_jax_chunks(pair, monkeypatch):
    """1,280 samples in chunks of 512 (64 frames) overlapping by 128, seed
    7 + i a chunk: the streamed chunks and the crossfaded whole equal
    JAX's within ATOL."""
    jm, pm, _ = pair
    _jax_draws(monkeypatch, pm)
    audio = _audio(4, 1280)
    kw = dict(chunk_seconds=512 / 16000, overlap_seconds=128 / 16000,
              ode_opt=EULER, seed=7)
    want = list(jm.separate_streaming(audio, ["speech"], **kw))
    got = list(pm.separate_streaming(audio, ["speech"], **kw))
    assert len(got) == len(want) == 3
    for (gt, gr), (wt, wr) in zip(got, want):
        np.testing.assert_allclose(gt, wt, atol=ATOL)
        np.testing.assert_allclose(gr, wr, atol=ATOL)
    long_ = pm.separate_long(audio, ["speech"], **kw)
    assert long_.target[0].shape == (1280, 1)
    np.testing.assert_allclose(long_.target[0],
                               np.concatenate([c[0] for c in want]),
                               atol=ATOL)
    short = pm.separate_long(audio[..., :512], ["speech"], **kw)
    assert len(short.target) == 1 and short.target[0].shape == (512, 1)


def test_default_noise_is_seeded_on_the_device(pair):
    """Without `noise`, the draw is a torch generator's seeded with `seed`:
    the same seed gives the same separation, another seed another."""
    _, pm, _ = pair
    audio = _audio(2, 512)
    a = pm.separate(audio, ["speech"], seed=5, ode_opt=EULER)
    b = pm.separate(audio, ["speech"], seed=5, ode_opt=EULER)
    c = pm.separate(audio, ["speech"], seed=6, ode_opt=EULER)
    np.testing.assert_array_equal(a.target[0], b.target[0])
    assert not np.allclose(a.target[0], c.target[0])
    assert a.noise.shape == (1, 64, 16)


# -- checkpoints, q8, the hook --------------------------------------------


def _write_dir(path, flat, quantization=None):
    path.mkdir(exist_ok=True)
    cfg = dict(CFG, model_type="sam_audio")
    if quantization:
        cfg["quantization"] = quantization
    (path / "config.json").write_text(json.dumps(cfg))
    np.savez(path / "model.npz", **flat)
    return path


def test_loaders_route_a_directory(pair, tmp_path):
    """`sam_audio` is ported: the STS loader and the top-level router load
    a tiny directory as SAM-Audio, strictly, with JAX's separation."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.sts import utils
    from mlx_audio_tpu_torch.sts.models.sam_audio import Model

    jm, _, flat = pair
    d = _write_dir(tmp_path / "sam-tiny", flat)
    audio, noise = _audio(6, 512), _noise(6, 64)
    want = jm.separate(audio, ["speech"], noise=noise, ode_opt=EULER)
    for m in (utils.load_model(d, device="cpu"),
              mlx_audio_tpu_torch.load_model(d, device="cpu")):
        assert type(m) is Model
        m.tokenizer = FakeT5Tok()
        _same(m.separate(audio, ["speech"], noise=noise, ode_opt=EULER), want)


def test_hook_reads_the_directory_only(pair, tmp_path):
    """A directory without tokenizer files loads with `tokenizer` None and
    `encode_text` raises naming the files and the directory (JAX's hook
    swallows every error and then reaches for the hub). A broken file
    raises at load (`local_tokenizer`, the TTS families' reader)."""
    from mlx_audio_tpu_torch.sts import utils

    _, _, flat = pair
    d = _write_dir(tmp_path / "sam-notok", flat)
    m = utils.load_model(d, device="cpu")
    assert m.tokenizer is None
    with pytest.raises(RuntimeError, match="tokenizer.json.*sam-notok"):
        m.encode_text(["speech"])


def test_sanitize_reads_conv_layouts_where_jax_misreads(pair):
    """The x_embedder's k = 3 convs given in MLX's (O, K, I): the port
    reads them from their shapes into the tree; JAX's sanitize takes them
    for torch's (O, I, K) and gives (I, K, O), no kernel of the model.
    Torch layouts read right in both, the tree itself in the port."""
    jm, pm, flat = pair
    key = "transformer.x_embedder.block.block1.project.weight"  # WIO (3,32,32)
    for layout, axes in (("mlx", (2, 0, 1)), ("torch", (2, 1, 0))):
        ck = dict(flat)
        ck[key] = np.ascontiguousarray(np.transpose(flat[key], axes))
        np.testing.assert_array_equal(pm.sanitize(ck)[key], flat[key])
        jw = np.asarray(jm.sanitize(ck)[key])
        if layout == "mlx":
            assert jw.shape == (32, 3, 32) != flat[key].shape
        else:
            np.testing.assert_array_equal(jw, flat[key])
    got = pm.sanitize(dict(flat))
    assert set(got) == set(flat)


def test_q8_directory_on_k2s_path_matches_jax_dense(pair, tmp_path):
    """A q8 directory (group 16): the port quantizes every Linear whose
    inputs the group divides (44, on kernel K2 on the card;
    `qmatmul_reference` here) and leaves the tables and convs dense; its
    separation equals JAX's model bound to the dequantized linears within
    ATOL. JAX's own q8 quantizes T5's table and the convs too (here its
    rule on the table and an x_embedder conv), and T5 then breaks
    (KeyError 'weight')."""
    import jax.numpy as jnp

    from mlx_audio_tpu.sts.models.sam_audio.t5 import t5_encode as j_encode
    from mlx_audio_tpu.utils import apply_quantization, unflatten
    from mlx_audio_tpu_torch.nn import Linear, QuantizedLinear
    from mlx_audio_tpu_torch.sts import utils

    jm, _, flat = pair
    q8 = {"bits": 8, "group_size": 16}
    d = _write_dir(tmp_path / "sam-q8", flat, q8)
    m = utils.load_model(d, device="cpu")
    m.tokenizer = FakeT5Tok()
    held = [n for n, x in m.named_modules() if isinstance(x, QuantizedLinear)]
    assert len(held) == 44
    assert [n for n, x in m.named_modules() if isinstance(x, Linear)] == [
        "embed_anchors.proj"]           # 8 inputs, not a multiple of 16
    assert isinstance(m.text_encoder.shared.weight, torch.nn.Parameter)
    deq = dict(flat)
    for n in held:           # w = scales q + biases a group (JAX's rule)
        x = m.get_submodule(n)
        out_f, in_f = x.w_q.shape
        codes = x.w_q.numpy().astype(np.float32).reshape(out_f, -1, 16)
        deq[n + ".weight"] = (codes * x.scales.numpy()[..., None]
                              + x.biases.numpy()[..., None]
                              ).reshape(out_f, in_f)
    audio, noise = _audio(7, 512), _noise(7, 64)
    dense = jm.params
    try:
        jm.params = unflatten({k: jnp.asarray(v) for k, v in deq.items()})
        want = jm.separate(audio, ["speech"], noise=noise, ode_opt=EULER)
    finally:
        jm.params = dense
    _same(m.separate(audio, ["speech"], noise=noise, ode_opt=EULER), want)
    te = dense["text_encoder"]
    conv = dense["transformer"]["x_embedder"]["block"]["block1"]["project"]
    jq = apply_quantization({"shared": te["shared"], "project": conv},
                            {"quantization": q8})
    assert "w_q" in jq["shared"] and "w_q" in jq["project"]
    with pytest.raises(KeyError, match="weight"):
        j_encode(dict(te, shared=jq["shared"]), jm.config.t5_cfg,
                 jnp.ones((1, 4), jnp.int32))


def test_separations_route(pair):
    """POST /v1/audio/separations with SAM-Audio (a counterpart of
    tests/test_sam_audio.py::test_sam_audio_separations_endpoint): the
    description, `steps` and `method` reach `separate_long`; 200 with the
    model's rate, the target equal to `separate_long` of the same audio."""
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.server import AudioServer

    _, pm, _ = pair
    x = np.random.RandomState(0).randn(4096).astype(np.float32) * 0.1
    wav = io.BytesIO()
    audio_io.write(wav, x, 16000)

    async def go():
        server = AudioServer(device="cpu")
        server.provider._models["sam-tiny"] = pm
        try:
            return await server.separate(
                {"model": "sam-tiny", "description": "a dog barking",
                 "steps": "2", "method": "euler"}, wav.getvalue())
        finally:
            server.close()

    reply = asyncio.run(go())
    assert reply.status == 200, reply.json
    assert reply.json["sample_rate"] == 16000
    tgt, sr = audio_io.read(io.BytesIO(base64.b64decode(
        reply.json["target"])), dtype="float32")
    x16, _ = audio_io.read(io.BytesIO(wav.getvalue()), dtype="float32")
    want = pm.separate_long(x16[None, None], ["a dog barking"],
                            ode_opt=EULER).target[0].reshape(-1)
    assert sr == 16000 and tgt.shape == want.shape
    assert np.abs(tgt - want).max() <= 1 / 32767 + 1e-6


def test_defaults_to_the_card():
    from mlx_audio_tpu_torch.sts.models.sam_audio import Model

    if torch.cuda.is_available():
        assert Model(CFG).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(CFG)
