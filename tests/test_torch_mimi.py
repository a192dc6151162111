"""The Mimi codec in the PyTorch port against the JAX package, on the CPU at
float32: `codec.models.blocks.vq_encode`, the causal conv helpers, encode /
decode / encode_to_latent, the streaming decode, `sanitize` on kyutai and
HF layouts (the depthwise frame-rate `convtr`, codebooks rebuilt from
cluster_usage / embedding_sum) and the local-directory load. Mirrors
tests/test_codecs.py::TestMimi on its config.

Both packages share one weight set: JAX's tree is drawn with numpy from a
seed over `jax.eval_shape(init_params)` (JAX's own eager init takes tens of
seconds on this CPU) and carried across by `load_jax_params`.

Tolerances: f32 tensors 2e-4 absolute (summation order only, the repo's
torch-parity precedent); audio also 1e-4 relative to its largest value
(its values are ~1e-4 under random weights, where an absolute bound says
nothing). Codes must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ATOL = 2e-4
AUDIO_REL = 1e-4

# tests/test_codecs.py::TestMimi's config
MIMI_CFG = dict(
    seanet=dict(dimension=32, channels=1, causal=True, nfilters=4,
                nresidual_layers=1, ratios=[4, 3], ksize=7, residual_ksize=3,
                last_ksize=3, dilation_base=2, pad_mode="constant",
                true_skip=True, compress=2),
    transformer=dict(d_model=32, num_heads=4, num_layers=2, layer_scale=0.01,
                     context=16, dim_feedforward=64),
    quantizer_nq=4, quantizer_bins=64, quantizer_dim=16, sample_rate=24000,
    frame_rate=1000.0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def numpy_params(init, seed: int):
    """A parameter tree of the shape `init(key)` gives (traced by
    jax.eval_shape, not run), drawn with numpy from `seed`: norms 1,
    biases and snake alpha / beta 0, layer scales and gammas 0.01,
    embeddings, codebooks, heads and the RVQ projections N(0, 0.02),
    linears (out, in) and the talker's stacked (L, out, in) uniform
    +-1/sqrt(in), conv kernels (k, I, O) uniform +-1/sqrt(k I)."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        shape, nd = s.shape, len(s.shape)
        if name.endswith(("['bias']", "['alpha']", "['beta']")):
            return jnp.zeros(shape, s.dtype)
        if name.endswith(("['scale']", "['gamma']")):
            return jnp.full(shape, 0.01, s.dtype)
        if "norm" in name or nd == 1:
            return jnp.ones(shape, s.dtype)
        if any(t in name for t in ("embed", "codebook", "head", "_proj']['w")
               ) and ("quantizer" in name or "proj" not in name):
            return jnp.asarray(rng.randn(*shape).astype(np.float32) * 0.02)
        stacked = nd == 3 and "talker" in name and "layers" in name
        fan = shape[-1] if nd == 2 or stacked else shape[0] * shape[1]
        return jnp.asarray(rng.uniform(-1, 1, shape).astype(np.float32)
                           / np.sqrt(fan))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def flat_numpy(params) -> dict:
    from mlx_audio_tpu.utils import flatten

    return {k: np.asarray(v) for k, v in flatten(params).items()}


def jit_mimi(m):
    """`m` with encode, encode_to_latent, decode and decode_step jitted
    (eager JAX compiles each op on this CPU: seconds a call)."""
    for name in ("encode", "encode_to_latent", "decode", "decode_step"):
        setattr(m, name, jax.jit(getattr(m, name)))
    return m


def jax_mimi(cfg: dict, seed: int, params=None):
    from mlx_audio_tpu.codec.models.mimi import Mimi, MimiConfig

    m = Mimi(MimiConfig(**cfg))
    m.bind(numpy_params(m.init_params, seed) if params is None else params)
    return jit_mimi(m)


def port_mimi(jm, cfg: dict, decoder: bool = True):
    from mlx_audio_tpu_torch.codec.models.mimi import Mimi, MimiConfig
    from mlx_audio_tpu_torch.model import load_jax_params

    pm = Mimi(MimiConfig(**cfg), device="cpu", decoder=decoder)
    names = set(pm.state_dict())
    return load_jax_params(pm, {k: v for k, v in flat_numpy(jm.params).items()
                                if k in names})


@pytest.fixture(scope="module")
def pair():
    jm = jax_mimi(MIMI_CFG, 0)
    return jm, port_mimi(jm, MIMI_CFG)


AUDIO = (np.random.RandomState(0).randn(1, 1, 24 * 10 + 7) * 0.1).astype(
    np.float32)


# ---------------------------------------------------------------------------
# vq_encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normalized", [False, True])
def test_vq_encode_matches_jax(normalized):
    """Euclidean and cosine nearest entries, ties included: a codebook with
    duplicate rows resolves to the first, as jnp.argmin does."""
    from mlx_audio_tpu.codec.models.blocks import vq_encode as jvq
    from mlx_audio_tpu_torch.codec.models.blocks import vq_encode

    rng = np.random.RandomState(1)
    cb = rng.randn(24, 8).astype(np.float32)
    cb[5] = cb[17] = cb[2]                  # three equal entries
    lat = rng.randn(2, 30, 8).astype(np.float32)
    lat[0, :4] = cb[2]                      # on the tied entry
    want = np.asarray(jvq(jnp.asarray(lat), jnp.asarray(cb), normalized))
    got = vq_encode(torch.from_numpy(lat), torch.from_numpy(cb), normalized)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, :4] == 2).all()


# ---------------------------------------------------------------------------
# causal conv helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad_mode,stride,kernel,t", [
    ("constant", 1, 7, 19), ("constant", 3, 6, 20), ("edge", 2, 4, 11),
    ("edge", 4, 8, 17), ("reflect", 1, 3, 9), ("reflect", 3, 6, 22)])
def test_causal_conv_matches_jax(pad_mode, stride, kernel, t):
    """`_causal_conv`: the left pad, the extra right cover at stride > 1,
    and the edge (replicate) and reflect modes."""
    from mlx_audio_tpu.codec.models.mimi.mimi import _causal_conv as jconv
    from mlx_audio_tpu_torch.codec.models.mimi.mimi import _causal_conv
    from mlx_audio_tpu_torch.nn import Conv1d

    rng = np.random.RandomState(2)
    x = rng.randn(2, t, 5).astype(np.float32)
    w = rng.randn(kernel, 5, 6).astype(np.float32) * 0.3   # WIO
    b = rng.randn(6).astype(np.float32)
    want = jconv({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                 jnp.asarray(x), kernel, stride=stride, pad_mode=pad_mode)
    conv = Conv1d(5, 6, kernel)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.transpose(w, (2, 1, 0))))
        conv.bias.copy_(torch.from_numpy(b))
        got = _causal_conv(conv, torch.from_numpy(x), kernel, stride=stride,
                           pad_mode=pad_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_tconv_step_carries_the_overflow_less_its_bias():
    """Chunks through `_tconv_step` (the overflow carried, its bias taken
    off so that it is added once; a fresh overflow is the bias) equal one
    `_causal_tconv`. JAX's steps from a zero overflow: its first
    kernel - stride frames lack the bias, the rest are equal."""
    from mlx_audio_tpu.codec.models.mimi.mimi import _tconv_step as jstep
    from mlx_audio_tpu_torch.codec.models.mimi.mimi import (_causal_tconv,
                                                            _tconv_step)
    from mlx_audio_tpu_torch.model import _conv_transpose_from_jax
    from mlx_audio_tpu_torch.nn import ConvTranspose1d

    rng = np.random.RandomState(3)
    x = rng.randn(1, 9, 4).astype(np.float32)
    w = rng.randn(6, 4, 3).astype(np.float32)     # pre-flipped (W, I, O)
    b = rng.randn(3).astype(np.float32)
    conv = ConvTranspose1d(4, 3, 6)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(_conv_transpose_from_jax(w, 1)
                                           .copy()))
        conv.bias.copy_(torch.from_numpy(b))
        whole = _causal_tconv(conv, torch.from_numpy(x), 6, 3)
        over = torch.zeros(1, 3, 3) + conv.bias
        jover = jnp.zeros((1, 3, 3))
        parts, jparts = [], []
        for a, e in ((0, 2), (2, 3), (3, 9)):
            y, over = _tconv_step(conv, torch.from_numpy(x[:, a:e]), over,
                                  6, 3)
            jy, jover = jstep({"weight": jnp.asarray(w),
                               "bias": jnp.asarray(b)},
                              jnp.asarray(x[:, a:e]), jover, 6, 3)
            parts.append(y.numpy())
            jparts.append(np.asarray(jy))
    got = np.concatenate(parts, axis=1)
    jgot = np.concatenate(jparts, axis=1)
    np.testing.assert_allclose(got, whole.numpy(), atol=ATOL)
    np.testing.assert_allclose(jgot[:, 3:], got[:, 3:], atol=ATOL)
    np.testing.assert_allclose(jgot[:, :3], got[:, :3] - b, atol=ATOL)


# ---------------------------------------------------------------------------
# the codec (tests/test_codecs.py::TestMimi)
# ---------------------------------------------------------------------------


def test_encode_decode_shapes(pair):
    _, pm = pair
    audio = (np.random.RandomState(0).randn(1, 1, pm.samples_per_frame * 10)
             * 0.1).astype(np.float32)
    codes = pm.encode(audio)
    assert codes.shape == (1, 4, 10) and codes.dtype == torch.int64
    rec = pm.decode(codes)
    assert rec.shape == (1, 1, pm.samples_per_frame * 10)


def test_encode_and_latents_match_jax(pair):
    """Codes equal (the extra cover of a clip that is not whole frames),
    latents within ATOL; 1-D and (B, T) input too."""
    jm, pm = pair
    want = np.asarray(jm.encode(AUDIO))
    np.testing.assert_array_equal(pm.encode(AUDIO).numpy(), want)
    np.testing.assert_array_equal(pm.encode(AUDIO[0, 0]).numpy(), want)
    np.testing.assert_array_equal(pm.encode(AUDIO[:, 0]).numpy(), want)
    np.testing.assert_allclose(pm.encode_to_latent(AUDIO).numpy(),
                               np.asarray(jm.encode_to_latent(AUDIO)),
                               atol=ATOL)


def test_decode_matches_jax(pair):
    jm, pm = pair
    codes = np.random.RandomState(4).randint(0, 64, (2, 4, 9))
    want = np.asarray(jm.decode(jnp.asarray(codes)))
    got = pm.decode(torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape == (2, 1, 9 * pm.samples_per_frame)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert _rel(got, want) < AUDIO_REL
    # the first books only (a decoder that takes fewer than nq)
    np.testing.assert_allclose(
        pm.decode(torch.from_numpy(codes[:, :2])).numpy(),
        np.asarray(jm.decode(jnp.asarray(codes[:, :2]))), atol=ATOL)


def test_streaming_decode_matches_full(pair):
    """decode_step over uneven chunks == one-shot decode (the Moshi
    streaming contract), and JAX's chunks."""
    jm, pm = pair
    codes = np.random.RandomState(3).randint(0, 64, (1, 4, 12))
    full = pm.decode(torch.from_numpy(codes)).numpy()
    state = pm.init_decode_stream_state(1, max_frames=64)
    jstate = jm.init_decode_stream_state(1, max_frames=64)
    outs, jouts = [], []
    for a, b in [(0, 1), (1, 4), (4, 12)]:
        state, chunk = pm.decode_step(state, torch.from_numpy(
            codes[:, :, a:b]))
        jstate, jchunk = jm.decode_step(jstate, jnp.asarray(codes[:, :, a:b]))
        outs.append(chunk.numpy())
        jouts.append(np.asarray(jchunk))
    streamed = np.concatenate(outs, axis=-1)
    np.testing.assert_allclose(streamed, full, atol=1e-5)
    np.testing.assert_allclose(streamed, np.concatenate(jouts, axis=-1),
                               atol=ATOL)
    assert state["offset"] == 12 * pm.downsample_stride
    with pytest.raises(ValueError, match="cache holds 64 frames"):
        pm.decode_step(state, torch.zeros(1, 4, 30, dtype=torch.long))


def test_stream_keeps_the_first_chunks_bias():
    """With every bias drawn (a trained checkpoint's are not zero), the
    port's stream equals its whole decode, which equals JAX's; JAX's stream
    takes each upsample's bias off the first chunk's first frames."""
    from mlx_audio_tpu.codec.models.mimi import Mimi as JMimi
    from mlx_audio_tpu.codec.models.mimi import MimiConfig as JCfg

    rng = np.random.RandomState(8)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                                    * 0.1)
        if jax.tree_util.keystr(path).endswith("['bias']") else v,
        numpy_params(JMimi(JCfg(**MIMI_CFG)).init_params, 0))
    jm = jax_mimi(MIMI_CFG, 0, params)
    pm = port_mimi(jm, MIMI_CFG)
    codes = np.random.RandomState(3).randint(0, 64, (1, 4, 6))
    want = np.asarray(jm.decode(jnp.asarray(codes)))
    whole = pm.decode(torch.from_numpy(codes)).numpy()
    np.testing.assert_allclose(whole, want, atol=ATOL)
    state = pm.init_decode_stream_state(1, 64)
    jstate = jm.init_decode_stream_state(1, 64)
    outs, jouts = [], []
    for a, b in ((0, 2), (2, 6)):
        state, y = pm.decode_step(state, torch.from_numpy(codes[:, :, a:b]))
        jstate, jy = jm.decode_step(jstate, jnp.asarray(codes[:, :, a:b]))
        outs.append(y.numpy())
        jouts.append(np.asarray(jy))
    np.testing.assert_allclose(np.concatenate(outs, -1), whole, atol=ATOL)
    jstream = np.concatenate(jouts, -1)
    assert np.abs(jstream - want).max() > 100 * ATOL


def test_encoder_only_mimi(pair):
    """decoder=False builds the encode path alone: the same codes, no
    decode weights, and decode raises."""
    jm, pm = pair
    enc = port_mimi(jm, MIMI_CFG, decoder=False)
    assert not any(k.startswith(("decoder", "upsample")) or "output_proj" in k
                   for k in enc.state_dict())
    np.testing.assert_array_equal(enc.encode(AUDIO).numpy(),
                                  pm.encode(AUDIO).numpy())
    with pytest.raises(ValueError, match="decoder=False"):
        enc.decode(torch.zeros(1, 4, 2, dtype=torch.long))


def test_default_device_is_the_card():
    from mlx_audio_tpu_torch.codec import Mimi

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Mimi(MIMI_CFG)


def test_exact_f32_restores_the_flags():
    from mlx_audio_tpu_torch.codec.models.mimi import exact_f32

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with exact_f32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _torch_state(pm) -> dict:
    return {k: v.numpy().copy() for k, v in pm.state_dict().items()}


def hf_mimi_state(pm, n_res: int = 1) -> dict:
    """The port Mimi's weights under HF `MimiModel` names, in torch
    layouts: the flattened SEANet indices, q/k/v split, the split-RVQ
    prefixes, codebooks as embed_sum and cluster_usage."""
    s = pm.config.seanet
    state = _torch_state(pm)
    out = {}
    rng = np.random.RandomState(7)
    enc_idx, dec_idx = {"init_conv1d": 0}, {"init_conv1d": 0}
    idx = 1
    for g in range(len(s.ratios)):
        enc_idx[f"layers.{g}.residuals.0"] = idx
        idx += n_res + 1
        enc_idx[f"layers.{g}.downsample"] = idx
        idx += 1
    enc_idx["final_conv1d"] = idx + 1
    idx = 1
    for g in range(len(s.ratios)):
        idx += 1
        dec_idx[f"layers.{g}.upsample"] = idx
        idx += 1
        dec_idx[f"layers.{g}.residuals.0"] = idx
        idx += n_res
    dec_idx["final_conv1d"] = idx + 1
    for k, v in state.items():
        parts = k.split(".")
        side = parts[0]
        if side in ("encoder", "decoder"):
            table = enc_idx if side == "encoder" else dec_idx
            if ".residuals." in k:
                base = ".".join(parts[1:5])
                blk = {"0": 1, "1": 3}[parts[6]]
                out[f"{side}.layers.{table[base]}.block.{blk}.conv."
                    f"{parts[-1]}"] = v
            else:
                base = ".".join(parts[1:-2]) if parts[1] == "layers" \
                    else parts[1]
                out[f"{side}.layers.{table[base]}.conv.{parts[-1]}"] = v
        elif side in ("encoder_transformer", "decoder_transformer"):
            pre = f"{side}.layers.{parts[3]}"
            rest = ".".join(parts[4:])
            if rest == "self_attn.in_proj.weight":
                for name, piece in zip("qkv", np.split(v, 3, axis=0)):
                    out[f"{pre}.self_attn.{name}_proj.weight"] = piece
            else:
                ren = {"self_attn.out_proj.weight": "self_attn.o_proj.weight",
                       "norm1.weight": "input_layernorm.weight",
                       "norm1.bias": "input_layernorm.bias",
                       "norm2.weight": "post_attention_layernorm.weight",
                       "norm2.bias": "post_attention_layernorm.bias",
                       "linear1.weight": "mlp.fc1.weight",
                       "linear2.weight": "mlp.fc2.weight",
                       "layer_scale_1.scale": "self_attn_layer_scale.scale",
                       "layer_scale_2.scale": "mlp_layer_scale.scale"}
                out[f"{pre}.{ren[rest]}"] = v
        elif side == "quantizer":
            q = ("semantic" if parts[1] == "rvq_first" else "acoustic") + \
                "_residual_vector_quantizer"
            if "codebook" in k:
                usage = rng.uniform(0.5, 2.0, v.shape[0]).astype(np.float32)
                base = f"quantizer.{q}.layers.{parts[4]}.codebook"
                out[f"{base}.cluster_usage"] = usage
                out[f"{base}.embed_sum"] = v * usage[:, None]
                out[f"{base}.initialized"] = np.ones(1, np.float32)
            else:
                out[f"quantizer.{q}.{parts[2]}.weight"] = v
        elif k == "downsample.conv.conv.weight":
            out["downsample.conv.weight"] = v
        elif k == "upsample.convtr.convtr.weight":
            out["upsample.conv.weight"] = v
        else:
            raise AssertionError(k)
    return out


def _decode_both(jm, pm, codes):
    return (np.asarray(jm.decode(jnp.asarray(codes))),
            pm.decode(torch.from_numpy(codes)).numpy())


def test_sanitize_hf_layout_matches_jax(pair):
    """HF `MimiModel` names and torch layouts (the depthwise upsample's
    (I, O/g, W) kernel, codebooks from cluster_usage / embed_sum): the
    port's sanitize rebuilds the model exactly, and the JAX package's
    sanitize of the same dict decodes the same audio (which holds the
    depthwise convtr's groups)."""
    from mlx_audio_tpu.codec.models.mimi import Mimi as JMimi
    from mlx_audio_tpu.codec.models.mimi import MimiConfig as JCfg
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.codec.models.mimi import Mimi, MimiConfig

    _, pm = pair
    hf = hf_mimi_state(pm)
    assert hf["upsample.conv.weight"].shape == (32, 1, 4)
    fresh = Mimi(MimiConfig(**MIMI_CFG), device="cpu")
    fresh.bind(fresh.sanitize(hf))
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, atol=1e-6,
                                   rtol=1e-6)
    jm2 = JMimi(JCfg(**MIMI_CFG))
    jm2 = jax_mimi(MIMI_CFG, 0, unflatten({
        k: jnp.asarray(v) for k, v in jm2.sanitize(hf).items()}))
    codes = np.random.RandomState(5).randint(0, 64, (1, 4, 7))
    want, got = _decode_both(jm2, fresh, codes)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(fresh.encode(AUDIO).numpy(),
                                  np.asarray(jm2.encode(AUDIO)))


def test_sanitize_kyutai_layout(pair):
    """The kyutai naming: this tree's names with leading underscores on
    some segments and codebooks as `_codebook.embedding_sum` /
    `cluster_usage`, rebuilt to the same weights."""
    from mlx_audio_tpu_torch.codec.models.mimi import Mimi, MimiConfig

    _, pm = pair
    ky = {}
    for k, v in _torch_state(pm).items():
        if k.endswith("codebook.embed.weight"):
            base = k[:-len(".codebook.embed.weight")]
            ky[f"{base}._codebook.embedding_sum"] = v * 2.0
            ky[f"{base}._codebook.cluster_usage"] = np.full(v.shape[0], 2.0,
                                                            np.float32)
            ky[f"{base}._codebook._initialized"] = np.ones(1, np.float32)
        else:
            ky[k.replace("encoder_transformer.", "_encoder_transformer.")] = v
    fresh = Mimi(MimiConfig(**MIMI_CFG), device="cpu")
    fresh.bind(fresh.sanitize(ky))
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v)


def test_config_from_hf_schema_matches_jax():
    import dataclasses

    from mlx_audio_tpu.codec.models.mimi import MimiConfig as JCfg
    from mlx_audio_tpu_torch.codec.models.mimi import MimiConfig

    hf = {"model_type": "mimi", "hidden_size": 512, "num_filters": 64,
          "upsampling_ratios": [8, 6, 5, 4], "num_quantizers": 32,
          "sliding_window": 250, "rope_theta": 10000.0,
          "intermediate_size": 2048, "num_hidden_layers": 8,
          "num_attention_heads": 8, "codebook_size": 2048,
          "vector_quantization_hidden_dimension": 256}
    got, want = MimiConfig.from_dict(hf), JCfg.from_dict(hf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.frame_rate == 12.5 and got.quantizer_nq == 32


def test_from_pretrained_local_directory(pair, tmp_path):
    """A directory of the HF config.json and HF-named weights (npz) loads
    to the same model; a missing directory raises, nothing downloads."""
    import json

    from mlx_audio_tpu_torch.codec.models.mimi import Mimi

    _, pm = pair
    s, t = pm.config.seanet, pm.config.transformer
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "mimi", "hidden_size": s.dimension,
        "num_filters": s.nfilters, "upsampling_ratios": s.ratios,
        "kernel_size": s.ksize, "num_attention_heads": t.num_heads,
        "num_hidden_layers": t.num_layers, "sliding_window": t.context,
        "intermediate_size": t.dim_feedforward, "num_quantizers": 4,
        "codebook_size": 64, "vector_quantization_hidden_dimension": 16,
        "frame_rate": 1000.0}))
    np.savez(tmp_path / "model.npz", **hf_mimi_state(pm))
    loaded = Mimi.from_pretrained(tmp_path, device="cpu")
    codes = torch.from_numpy(np.random.RandomState(6).randint(0, 64,
                                                              (1, 4, 5)))
    np.testing.assert_allclose(loaded.decode(codes).numpy(),
                               pm.decode(codes).numpy(), atol=1e-6)
    with pytest.raises(FileNotFoundError, match="not found"):
        Mimi.from_pretrained(tmp_path / "missing", device="cpu")
