"""EnCodec of the PyTorch port against the JAX package, on the CPU:
tests/test_codecs.py::TestEncodec (a round trip's shapes, a subset of
quantizers, the LSTM and codebook sanitize) with every output held to
JAX's, an HF `EncodecModel`-named checkpoint (weight-norm pairs, `.conv.`
names, LSTM and codebook keys, the decoder's transposed convs) sanitized
as JAX sanitizes it, and the codec loader on such a directory.

Config: TestEncodec's tiny EnCodec (8 filters, ratios [4, 2], hidden 16,
4 codebooks of 32 x 16; one LSTM layer there, and two, the published
count), one parameter set drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`). The JAX side runs jitted. Codes equal;
audio at ATOL = 2e-4 (f32, summation order).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
TINY = dict(num_filters=8, hidden_size=16, codebook_dim=16,
            codebook_size=32, num_quantizers=4, upsampling_ratios=[4, 2],
            num_lstm_layers=1)


def make_pair(cfg, seed=0):
    """(JAX EnCodec with encode / decode jitted, port EnCodec) on one
    numpy-drawn tree."""
    from mlx_audio_tpu.codec.models.encodec import Encodec as JEncodec
    from mlx_audio_tpu_torch.codec.models.encodec import Encodec
    from mlx_audio_tpu_torch.model import load_jax_params

    je = JEncodec(dict(cfg))
    je.bind(numpy_params(je.init_params, seed))
    pe = load_jax_params(Encodec(dict(cfg), device="cpu"),
                         flat_numpy(je.params))
    je.encode = jax.jit(je.encode, static_argnums=1)
    je.decode = jax.jit(je.decode)
    return je, pe


@pytest.fixture(scope="module", params=[1, 2], ids=["1 LSTM", "2 LSTMs"])
def pair(request):
    return make_pair(dict(TINY, num_lstm_layers=request.param))


def test_roundtrip_equals_jax(pair):
    je, pe = pair
    audio = np.random.RandomState(1).randn(1, 1, 640).astype(np.float32)
    jc = np.asarray(je.encode(jnp.asarray(audio)))
    pc = pe.encode(audio)
    assert tuple(pc.shape) == (1, 4, 80)
    np.testing.assert_array_equal(pc.numpy(), jc)
    rec = pe.decode(pc).numpy()
    assert rec.shape[1] >= 640
    np.testing.assert_allclose(rec, np.asarray(je.decode(jnp.asarray(jc))),
                               atol=ATOL)


def test_n_quantizers_subset(pair):
    je, pe = pair
    audio = np.random.RandomState(2).randn(1, 1, 320).astype(np.float32)
    pc = pe.encode(audio, n_quantizers=2)
    assert pc.shape[1] == 2
    np.testing.assert_array_equal(
        pc.numpy(), np.asarray(je.encode(jnp.asarray(audio), 2)))


def test_sanitize_lstm_and_codebook():
    """TestEncodec's case: an HF LSTM key renamed, a codebook rebuilt
    from embed_sum / cluster_size."""
    from mlx_audio_tpu_torch.codec.models.encodec import Encodec

    pe = Encodec(dict(TINY), device="cpu")
    out = pe.sanitize({
        "encoder.layers.13.lstm.weight_ih_l0": np.zeros((64, 16)),
        "quantizer.layers.0.codebook.embed_sum": np.ones((32, 16)) * 6,
        "quantizer.layers.0.codebook.cluster_size": np.full((32,), 3.0)})
    assert "encoder.layers.13.lstm.0.weight_ih" in out
    np.testing.assert_allclose(out["quantizer.layers.0.codebook.embed.weight"],
                               np.full((32, 16), 2.0))


def hf_state(pe) -> dict:
    """The port EnCodec's weights under HF `EncodecModel`'s names: convs
    under `.conv.` as weight-norm pairs (half in the parametrization
    form), LSTMs as `lstm.weight_ih_l{n}`, codebooks as `codebook.embed`
    but the first, rebuilt from embed_sum / cluster_size, and the
    `inited` flags."""
    out = {}
    for i, (k, v) in enumerate(pe.state_dict().items()):
        v = v.numpy()
        parts = k.split(".")
        if ".lstm." in k:
            n, leaf = parts[-2], parts[-1][: -len("_l0")]
            out[".".join(parts[:-2]) + f".{leaf}_l{n}"] = v
        elif k.endswith("codebook.embed.weight"):
            base = k[: -len(".embed.weight")]
            if base.startswith("quantizer.layers.0."):
                out[base + ".embed_sum"] = v * 4.0
                out[base + ".cluster_size"] = np.full((v.shape[0],), 4.0)
            else:
                out[base + ".embed"] = v
            out[base + ".inited"] = np.ones((1,))
        elif v.ndim == 3:
            base = ".".join(parts[:-1]) + ".conv"
            g = np.sqrt((v * v).sum(axis=(1, 2), keepdims=True))
            if i % 2:
                out[base + ".weight_g"], out[base + ".weight_v"] = g, 2 * v
            else:
                out[base + ".parametrizations.weight.original0"] = g
                out[base + ".parametrizations.weight.original1"] = 3 * v
        else:
            out[".".join(parts[:-1]) + ".conv." + parts[-1]] = v
    return out


def test_hf_sanitize_equals_jax(pair):
    """An HF-named checkpoint: the port's `sanitize` gives JAX's tree,
    name for name, which binds to the model it came from."""
    je, pe = pair
    from mlx_audio_tpu.codec.models.encodec import Encodec as JEncodec
    from mlx_audio_tpu_torch.codec.models.encodec import Encodec
    from mlx_audio_tpu_torch.model import load_jax_params

    cfg = vars(pe.config)
    hf = hf_state(pe)
    got = pe.sanitize(hf)
    want = JEncodec(dict(cfg)).sanitize(hf)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5,
                                   err_msg=k)
    again = load_jax_params(Encodec(dict(cfg), device="cpu"), got)
    for k, v in pe.state_dict().items():
        np.testing.assert_allclose(again.state_dict()[k].numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)


def test_codec_loader_reads_an_hf_directory(pair, tmp_path):
    """`codec.utils.load_model` on a directory of model_type "encodec"
    with HF names: its round trip equals JAX's."""
    je, pe = pair
    from mlx_audio_tpu_torch.codec.utils import load_model

    cfg = dict(vars(pe.config), model_type="encodec")
    cfg.pop("model_path")
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    np.savez(tmp_path / "model.npz", **hf_state(pe))
    m = load_model(tmp_path, device="cpu")
    assert type(m).__name__ == "Encodec" and m.sample_rate == 24000
    codes = np.random.RandomState(3).randint(0, 32, (1, 4, 10))
    np.testing.assert_allclose(m.decode(codes).numpy(),
                               np.asarray(je.decode(jnp.asarray(codes))),
                               atol=ATOL)
