"""Moonshine of the PyTorch port against the JAX package, on the CPU: the
cases of tests/test_moonshine.py (the encoder and its frame count, bucket
invariance, the compiled greedy decode, `sanitize`), each held to the JAX
package's on one weight set; the departures pinned (the unpadded encoder
against JAX's masked bucket, the eager decode's stop and reads, the
layouts read from shapes, the tokenizer hook that raises); and the
loaders on a tiny HF-named directory.

Config: tests/test_moonshine.py's `_hf_config` (vocabulary 64, d32, FFN
64, 2 + 2 layers of 4 heads and 4 KV heads, start 1, EOS 2, tied), with 2
KV heads too; one parameter set drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`), the JAX side jitted. Encoder rows at
ATOL = 2e-4 (f32, summation order; tests/test_torch_parity.py:19); greedy
tokens and text equal.
"""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           encoder_num_hidden_layers=2, decoder_num_hidden_layers=2,
           encoder_num_attention_heads=4, decoder_num_attention_heads=4,
           max_position_embeddings=128, decoder_start_token_id=1,
           eos_token_id=2, bos_token_id=1)


@pytest.fixture(autouse=True)
def no_hf_tokenizer(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)


def make_pair(cfg, flat=None, seed=0):
    import jax.numpy as jnp

    from mlx_audio_tpu.stt.models.moonshine import Model as JModel
    from mlx_audio_tpu.stt.models.moonshine import ModelConfig as JConfig
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.moonshine import Model, ModelConfig

    jm = JModel(JConfig.from_dict(cfg))
    if flat is None:
        flat = flat_numpy(numpy_params(jm.init_params, seed))
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    pm = load_jax_params(Model(ModelConfig.from_dict(cfg), device="cpu"),
                         flat)
    return jm, pm, flat


@pytest.fixture(scope="module")
def pair():
    return make_pair(CFG)


def audio(seed, n, scale=0.1):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


def test_unpadded_encoder_equals_jax_bucket(pair):
    """3,200 samples -> encoder_frames(3200) rows: the port's unpadded
    encoder within ATOL of JAX's at the exact length and of its
    16,000-sample bucket's valid rows (the masked GroupNorm, convs and
    attention; a departure)."""
    import jax.numpy as jnp

    from mlx_audio_tpu_torch.stt.models.moonshine import encoder_frames

    jm, pm, _ = pair
    x = audio(0, 3200)
    got = pm.encode(x)[0].numpy()
    f = encoder_frames(3200)
    assert got.shape == (f, 32) and f == 7
    for width in (3200, 16000):             # JAX's bucket for 3,200: 16,000
        buf = np.zeros((1, width), np.float32)
        buf[0, :3200] = x
        want, n = jm._encode_fn(width)(jm.params, jnp.asarray(buf),
                                       jnp.asarray([3200]))
        assert int(n[0]) == f
        np.testing.assert_allclose(got, np.asarray(want)[0, :f], atol=ATOL)


@pytest.mark.parametrize("seed,n", [(1, 3200), (2, 9000)])
def test_greedy_generate_equals_jax(pair, seed, n):
    """`generate` greedy: the tokens (text by the chr fallback) and counts
    equal JAX's `lax.while_loop` decode; no EOS in 16 steps, so the loop
    runs its budget in one read."""
    jm, pm, _ = pair
    x = audio(seed, n)
    got, want = pm.generate(x, max_tokens=16), jm.generate(x, max_tokens=16)
    assert got.text == want.text and got.text
    assert got.generation_tokens == want.generation_tokens == 16
    assert pm.last_run["steps"] == 16 and pm.last_run["reads"] == 1


def test_eos_stops_the_loop_as_jax(pair):
    """EOS's table row set to the row of the token the decode first draws
    at step 6 (argmax ties go to the lower id, EOS's): JAX and the port
    keep the same 6 tokens; the port's loop ran at most STEPS_AFTER_EOS
    step past the EOS step, and read once a DEC_CHUNK (4 here)."""
    from mlx_audio_tpu_torch.stt.models.moonshine import moonshine

    jm, pm, flat = pair
    x = audio(6, 6400)
    toks = pm.greedy_decode(pm.encode(x), 12)
    k = next(i for i in range(1, 12) if toks[i] not in toks[:i])
    assert k == 6
    flat = dict(flat)
    table = flat["decoder.embed_tokens.weight"].copy()
    table[2] = table[toks[k]]
    flat["decoder.embed_tokens.weight"] = table
    jm2, pm2, _ = make_pair(CFG, flat)
    got, want = pm2.generate(x, max_tokens=12), jm2.generate(x, max_tokens=12)
    assert got.text == want.text and got.generation_tokens == k
    assert k < pm2.last_run["steps"] <= k + 1 + moonshine.STEPS_AFTER_EOS
    chunk = moonshine.DEC_CHUNK
    moonshine.DEC_CHUNK = 4
    try:
        run = {}
        assert pm2.greedy_decode(pm2.encode(x), 12, run=run) == toks[:k]
    finally:
        moonshine.DEC_CHUNK = chunk
    assert run["reads"] == -(-run["steps"] // 4)


def test_gqa_and_untied_head_match_jax():
    """Two KV heads a layer and a `proj_out` head: greedy tokens equal
    JAX's."""
    cfg = dict(CFG, encoder_num_key_value_heads=2,
               decoder_num_key_value_heads=2, tie_word_embeddings=False)
    jm, pm, _ = make_pair(cfg, seed=1)
    assert hasattr(pm, "proj_out")
    x = audio(4, 4000)
    assert pm.generate(x, max_tokens=10).text == \
        jm.generate(x, max_tokens=10).text


def test_sanitize_reads_layouts_from_shapes(pair):
    """HF names and torch layouts give JAX's arrays; MLX layouts the same;
    a tied `proj_out` is dropped."""
    jm, pm, _ = pair
    rs = np.random.RandomState(5)
    w = {"model.encoder.conv1.weight": rs.randn(32, 1, 127),
         "model.encoder.conv2.weight": rs.randn(64, 32, 7),
         "model.encoder.conv3.weight": rs.randn(32, 64, 3),
         "model.decoder.norm.weight": rs.randn(32),
         "proj_out.weight": rs.randn(64, 32)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    got, want = pm.sanitize(w), jm.sanitize(w)
    assert sorted(got) == sorted(want) and "proj_out.weight" not in got
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    mlx = {k: (np.transpose(v, (0, 2, 1)) if v.ndim == 3 else v)
           for k, v in w.items()}
    for k, v in pm.sanitize(mlx).items():
        np.testing.assert_array_equal(v, got[k])


def test_loaders_route_a_tiny_directory(pair, tmp_path):
    """An HF-named directory (`model.` prefix, torch conv layouts) through
    `stt.utils.load_model` and the top-level router: equal weights and
    greedy text."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.stt.models.moonshine import Model
    from mlx_audio_tpu_torch.stt.utils import load_model

    _, pm, _ = pair
    d = tmp_path / "moonshine-tiny"
    d.mkdir()
    np.savez(d / "model.npz", **{"model." + k: v.numpy()
                                 for k, v in pm.state_dict().items()})
    (d / "config.json").write_text(json.dumps(dict(CFG,
                                                   model_type="moonshine")))
    x = audio(6, 5000)
    want = pm.generate(x, max_tokens=8).text
    for loaded in (load_model(d, device="cpu"),
                   mlx_audio_tpu_torch.load_model(d, device="cpu")):
        assert isinstance(loaded, Model) and loaded._tokenizer is None
        for k, v in pm.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), k
        assert loaded.generate(x, max_tokens=8).text == want


def test_tokenizer_hook_raises_on_files_that_fail(tmp_path, monkeypatch):
    """A departure: tokenizer files that fail to load raise (JAX's hook
    swallows the error and leaves None); without them there is none."""
    import types

    from mlx_audio_tpu_torch.stt.models.moonshine import Model

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
