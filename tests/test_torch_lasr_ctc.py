"""LASR-CTC of the PyTorch port against the JAX package, on the CPU: the
cases of tests/test_lasr_ctc.py (the 4x subsampling, the CTC collapse,
`sanitize`, the registry), each held to the JAX package's on one weight
set; the departures pinned (the unpadded run against JAX's unmasked
bucket, the layouts read from shapes, the tokenizer hook that raises);
and the loaders on a tiny directory.

Config: tests/test_lasr_ctc.py's `tiny_cfg` (vocabulary 40, d32 with 4
heads, 2 layers, FFN 64, conv kernel 8, 32 mels, subsampler channels 16,
kernel 5, stride 2); one parameter set drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`), the batch norms' statistics drawn too,
the JAX side jitted. Logits at ATOL = 2e-4 (f32, summation order;
tests/test_torch_parity.py:19); CTC ids and text equal.
"""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
CFG = dict(vocab_size=40, pad_token_id=0,
           encoder_config=dict(hidden_size=32, num_hidden_layers=2,
                               num_attention_heads=4, num_key_value_heads=4,
                               intermediate_size=64, conv_kernel_size=8,
                               num_mel_bins=32, subsampling_conv_channels=16,
                               subsampling_conv_kernel_size=5,
                               subsampling_conv_stride=2))


@pytest.fixture(autouse=True)
def no_hf_tokenizer(monkeypatch):
    """The JAX hook tries `transformers` on any directory; blocked, it
    fails at once to the same None tokenizer."""
    monkeypatch.setitem(sys.modules, "transformers", None)


@pytest.fixture(scope="module")
def pair():
    from mlx_audio_tpu.stt.models.lasr_ctc import Model as JModel
    from mlx_audio_tpu.stt.models.lasr_ctc import ModelConfig as JConfig
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.lasr_ctc import Model, ModelConfig

    jm = JModel(JConfig.from_dict(CFG))
    flat = flat_numpy(numpy_params(jm.init_params, 0))
    rs = np.random.RandomState(1)
    for k in [k for k in flat if k.endswith("norm.running_mean")]:
        flat[k] = rs.randn(32).astype(np.float32) * 0.1
        flat[k.replace("mean", "var")] = rs.uniform(0.5, 1.5, 32) \
            .astype(np.float32)
    import jax.numpy as jnp

    jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    pm = load_jax_params(Model(ModelConfig.from_dict(CFG), device="cpu"),
                         flat)
    return jm, pm


def jax_logits(jm, mel):
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.stt.models.lasr_ctc.lasr import lasr_forward

    return np.asarray(jax.jit(lambda p, m: lasr_forward(p, jm.config, m))(
        jm.params, jnp.asarray(mel)))


def audio(seed, n, scale=0.1):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


def test_logits_match_jax_and_subsample_4x(pair):
    """100 frames -> 22 rows (two unpadded stride-2 convs of 5), within
    ATOL of JAX's `lasr_forward`; the RoPE, the weighted residuals and the
    conv module's batch norm with drawn statistics included."""
    jm, pm = pair
    mel = np.random.RandomState(0).randn(100, 32).astype(np.float32)
    got = pm.logits(mel).numpy()
    want = jax_logits(jm, mel[None])[0]
    assert got.shape == want.shape == (22, 40) and pm._sub_len(100) == 22
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_generate_at_a_bucket_length_equals_jax(pair):
    """At 256 mel frames (a bucket: JAX pads nothing) `generate` equals
    JAX's: the collapsed ids (no blank, no adjacent repeat) and the
    segment."""
    jm, pm = pair
    x = audio(1, 256 * 160)
    got, want = pm.generate(x), jm.generate(x)
    assert pm.last_run["frames"] == 256
    assert got.text == want.text and got.text
    assert got.segments == want.segments
    toks = got.text.split()
    assert "0" not in toks and all(a != b for a, b in zip(toks, toks[1:]))
    assert got.generation_tokens == want.generation_tokens == len(toks)


def test_unpadded_run_departs_from_jax_bucket(pair):
    """A departure from a JAX fault: JAX pads 100 frames to the 256-frame
    bucket without a mask, so its valid rows read the padding. The port's
    rows equal JAX's forward on the unpadded mel, and `generate` the
    collapse of those, not JAX's bucketed rows."""
    from mlx_audio_tpu_torch.stt.models.lasr_ctc.lasr import ctc_collapse
    from mlx_audio_tpu_torch.stt.models.whisper.audio import \
        log_mel_spectrogram

    jm, pm = pair
    x = audio(2, 100 * 160)
    mel = log_mel_spectrogram(x, n_mels=32).numpy()
    assert mel.shape[0] == 100
    exact = jax_logits(jm, mel[None])[0]
    padded = np.zeros((1, 256, 32), np.float32)
    padded[0, :100] = mel
    bucket = jax_logits(jm, padded)[0, :22]
    assert np.abs(exact - bucket).max() > 1e-2
    np.testing.assert_allclose(pm.logits(mel).numpy(), exact, atol=ATOL)
    want = ctc_collapse(torch.tensor(exact).argmax(-1), 0)
    assert pm.generate(x).text == " ".join(map(str, want))


def test_sanitize_reads_layouts_from_shapes(pair):
    """JAX's cases (an HF conv1x1 head, a torch depthwise weight) give
    JAX's arrays; MLX and WIO layouts of the same weights give the same;
    the RoPE table and step counters are dropped."""
    jm, pm = pair
    rs = np.random.RandomState(3)
    w = {"ctc_head.weight": rs.randn(40, 32, 1).astype(np.float32),
         "encoder.layers.0.conv.depthwise_conv.weight":
             rs.randn(32, 1, 8).astype(np.float32),
         "encoder.subsampler.conv_1.weight":
             rs.randn(16, 32, 5).astype(np.float32)}
    got, want = pm.sanitize(w), jm.sanitize(w)
    for k in w:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    mlx = {k: (np.transpose(v, (0, 2, 1)) if v.shape[-1] != 1 else v)
           for k, v in w.items()}
    extra = {"encoder.layers.0.self_attn.rotary_emb.inv_freq": np.ones(4),
             "encoder.layers.0.conv.norm.num_batches_tracked": np.ones(())}
    for k, v in pm.sanitize({**mlx, **extra}).items():
        np.testing.assert_array_equal(v, got[k])
    assert not set(extra) & set(pm.sanitize({**got, **extra}))


def test_loaders_route_a_tiny_directory(pair, tmp_path):
    """An HF-named directory (torch conv layouts, the head as a conv1x1)
    through `stt.utils.load_model` and the top-level router: equal weights
    and text; `lasr` is among the ported families."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.model import jax_params
    from mlx_audio_tpu_torch.stt.models.lasr_ctc import Model
    from mlx_audio_tpu_torch.stt.utils import PORTED, load_model

    _, pm = pair
    state = {k: v.numpy() for k, v in pm.state_dict().items()}
    state["ctc_head.weight"] = state["ctc_head.weight"][..., None]
    d = tmp_path / "lasr-ctc-tiny"
    d.mkdir()
    np.savez(d / "model.npz", **state)
    (d / "config.json").write_text(json.dumps(dict(CFG, model_type="lasr")))
    assert "lasr_ctc" in PORTED and jax_params(pm)
    x = audio(4, 12000)
    want = pm.generate(x).text
    for loaded in (load_model(d, device="cpu"),
                   mlx_audio_tpu_torch.load_model(d, device="cpu")):
        assert isinstance(loaded, Model) and loaded._tokenizer is None
        for k, v in pm.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), k
        assert loaded.generate(x).text == want


def test_tokenizer_hook_raises_on_files_that_fail(tmp_path, monkeypatch):
    """A departure: tokenizer files that fail to load raise (JAX's hook
    swallows the error and leaves None); without them there is none."""
    import types

    from mlx_audio_tpu_torch.stt.models.lasr_ctc import Model

    m = Model(CFG, device="cpu")
    assert Model.post_load_hook(m, tmp_path)._tokenizer is None

    def broken(path, **kw):
        raise OSError(f"cannot read the tokenizer in {path}")

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=broken)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    (tmp_path / "tokenizer.json").write_text("{broken")
    with pytest.raises(OSError, match="tokenizer"):
        Model.post_load_hook(m, tmp_path)
