"""The descript DAC of the PyTorch port against the JAX package, on the
CPU: tests/test_codecs.py::TestDAC (encode and decode shapes, the tanh
bound) with every output held to JAX's, a subset of quantizers, the HF
`DacModel` key remap with its weight-norm pairs, and the codec loader on
an HF-named directory.

Config: TestDAC's tiny DAC (encoder 16, rates [2, 4], latent 32, decoder
64, rates [4, 2], 3 codebooks of 64 x 4), one parameter set drawn with
numpy over JAX's shapes (`test_torch_mimi.numpy_params`). The JAX side
runs jitted. Codes equal; latents and audio at ATOL = 2e-4 (f32,
summation order).
"""

import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
TINY = dict(encoder_dim=16, encoder_rates=[2, 4], latent_dim=32,
            decoder_dim=64, decoder_rates=[4, 2], n_codebooks=3,
            codebook_size=64, codebook_dim=4, sample_rate=16000)


def make_pair(cfg=TINY, seed=0):
    """(JAX DAC with encode / from_codes / decode jitted, port DAC) on one
    numpy-drawn tree."""
    from mlx_audio_tpu.codec.models.descript import DAC as JDAC
    from mlx_audio_tpu_torch.codec.models.descript import DAC
    from mlx_audio_tpu_torch.model import load_jax_params

    jd = JDAC(dict(cfg))
    jd.bind(numpy_params(jd.init_params, seed))
    pd = load_jax_params(DAC(dict(cfg), device="cpu"), flat_numpy(jd.params))
    for name in ("from_codes", "decode"):
        setattr(jd, name, jax.jit(getattr(jd, name)))
    jd.encode = jax.jit(jd.encode, static_argnums=1)
    return jd, pd


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def test_encode_decode_equal_jax(pair):
    jd, pd = pair
    audio = np.random.RandomState(0).randn(1, 1, 800).astype(np.float32)
    jz, jc = jd.encode(jnp.asarray(audio[:, 0]))
    pz, pc = pd.encode(audio)
    assert tuple(pc.shape) == (1, 3, 100)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(pz.numpy(), np.asarray(jz), atol=ATOL)
    jl, pl = jd.from_codes(jc), pd.from_codes(pc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL)
    rec = pd.decode(pl).numpy()
    assert rec.shape == (1, 800, 1) and np.abs(rec).max() <= 1.0
    np.testing.assert_allclose(rec, np.asarray(jd.decode(jl)), atol=ATOL)


def test_odd_length_pads_to_the_hop_and_subset_of_quantizers(pair):
    jd, pd = pair
    audio = np.random.RandomState(1).randn(1, 795).astype(np.float32)
    _, jc = jd.encode(jnp.asarray(audio), 2)
    pz, pc = pd.encode(audio, n_quantizers=2)
    assert tuple(pc.shape) == (1, 2, 100)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(pd.decode(pz).numpy(),
                               np.asarray(jd.decode(jd.from_codes(jc))),
                               atol=ATOL)


def _hf_name(k: str, r_enc: int, r_dec: int) -> str:
    """The native (descript Sequential) name -> HF `DacModel`'s, the
    inverse of `DAC._remap_hf`."""
    m = re.match(r"^quantizer\.(\d+)\.(.+)$", k)
    if m:
        return f"quantizer.quantizers.{m.group(1)}.{m.group(2)}"
    side, idx, rest = re.match(r"^(encoder|decoder)\.(\d+)\.(.+)$", k).groups()
    idx = int(idx)
    last = r_enc if side == "encoder" else r_dec
    if idx == 0:
        return f"{side}.conv1.{rest}"
    if idx == last + 1:
        return f"{side}.snake1.{rest}"
    if idx == last + 2:
        return f"{side}.conv2.{rest}"
    stage = f"{side}.block.{idx - 1}"
    m = re.match(r"^block\.(\d)\.block\.(\d)\.(.+)$", rest)
    if m:
        r, inner, leaf = int(m.group(1)), m.group(2), m.group(3)
        unit = r + 1 if side == "encoder" else r - 1
        part = {"0": "snake1", "1": "conv1", "2": "snake2", "3": "conv2"}[
            inner]
        return f"{stage}.res_unit{unit}.{part}.{leaf}"
    j, leaf = re.match(r"^block\.(\d)\.(.+)$", rest).groups()
    part = ({"3": "snake1", "4": "conv1"} if side == "encoder"
            else {"0": "snake1", "1": "conv_t1"})[j]
    return f"{stage}.{part}.{leaf}"


def hf_state(pd, weight_norm: bool = True) -> dict:
    """The port DAC's weights as an HF `DacModel` checkpoint: torch
    layouts, snake alphas (1, C, 1), and with `weight_norm` every conv
    weight split into a weight-norm pair (g the norm over all axes but the
    first; half of them in the parametrization form)."""
    c = pd.config
    out = {}
    for i, (k, v) in enumerate(pd.state_dict().items()):
        v = v.numpy()
        name = _hf_name(k, len(c.encoder_rates), len(c.decoder_rates))
        if name.endswith(".alpha"):
            out[name] = v.reshape(1, -1, 1)
        elif weight_norm and name.endswith(".weight") and v.ndim == 3:
            g = np.sqrt((v * v).sum(axis=(1, 2), keepdims=True))
            base = name[: -len(".weight")]
            if i % 2:
                out[base + ".weight_g"], out[base + ".weight_v"] = g, 2 * v
            else:
                out[base + ".parametrizations.weight.original0"] = g
                out[base + ".parametrizations.weight.original1"] = 3 * v
        else:
            out[name] = v
    return out


def _assert_binds_back(pd, tree):
    from mlx_audio_tpu_torch.codec.models.descript import DAC
    from mlx_audio_tpu_torch.model import load_jax_params

    again = load_jax_params(DAC(dict(TINY), device="cpu"), tree)
    for k, v in pd.state_dict().items():
        np.testing.assert_allclose(again.state_dict()[k].numpy(), v.numpy(),
                                   atol=1e-6, err_msg=k)


def test_hf_remap_equals_jax(pair):
    """An HF-named checkpoint (weights folded): the port's `sanitize`
    gives JAX's tree, name for name, and binds to the model it came
    from."""
    jd, pd = pair
    from mlx_audio_tpu.codec.models.descript import DAC as JDAC

    hf = hf_state(pd, weight_norm=False)
    assert any(k.startswith("quantizer.quantizers.") for k in hf)
    assert any(".res_unit1." in k for k in hf)
    got = pd.sanitize(hf)
    want = JDAC(dict(TINY)).sanitize(hf)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-6,
                                   err_msg=k)
    _assert_binds_back(pd, got)


def test_hf_weight_norm_pairs_fold_before_the_remap(pair):
    """The departure: an HF checkpoint's weight-norm pairs (both forms)
    are folded before the remap, giving the tree JAX gives the folded
    checkpoint; JAX's remap passes the pairs' names unmapped."""
    jd, pd = pair
    from mlx_audio_tpu.codec.models.descript import DAC as JDAC

    paired = hf_state(pd)
    got = pd.sanitize(paired)
    want = JDAC(dict(TINY)).sanitize(hf_state(pd, weight_norm=False))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5,
                                   err_msg=k)
    _assert_binds_back(pd, got)
    jax_tree = JDAC(dict(TINY)).sanitize(paired)
    assert "encoder.0.weight" not in jax_tree
    assert any(".res_unit1." in k for k in jax_tree)


def test_codec_loader_reads_an_hf_directory(pair, tmp_path):
    """`codec.utils.load_model` on an HF-schema directory (model_type
    "dac", HF names in npz) routes to `descript` and decodes as JAX's."""
    jd, pd = pair
    from mlx_audio_tpu_torch.codec.utils import load_model

    hf = dict(model_type="dac", encoder_hidden_size=16,
              downsampling_ratios=[2, 4], hidden_size=32,
              decoder_hidden_size=64, upsampling_ratios=[4, 2],
              n_codebooks=3, codebook_size=64, codebook_dim=4,
              sampling_rate=16000)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    np.savez(tmp_path / "model.npz", **hf_state(pd))
    m = load_model(tmp_path, device="cpu")
    assert type(m).__name__ == "DAC" and m.config.encoder_rates == [2, 4]
    codes = np.random.RandomState(2).randint(0, 64, (1, 3, 12))
    np.testing.assert_allclose(
        m.decode(m.from_codes(codes)).numpy(),
        np.asarray(jd.decode(jd.from_codes(jnp.asarray(codes)))), atol=ATOL)


def test_config_defaults_and_hf_schema_equal_jax():
    """The native defaults (rates [2, 4, 5, 8], 44.1 kHz) and the HF
    schema's ([2, 4, 8, 8], 9 codebooks) read as JAX reads them."""
    from mlx_audio_tpu.codec.models.descript import ModelConfig as JConfig
    from mlx_audio_tpu_torch.codec.models.descript import ModelConfig

    assert vars(ModelConfig()) == vars(JConfig())
    for d in ({"encoder_hidden_size": 64}, {"downsampling_ratios": [2, 4]},
              dict(TINY)):
        assert vars(ModelConfig.from_dict(d)) == vars(JConfig.from_dict(d))
