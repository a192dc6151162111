"""Granite Speech NAR of the PyTorch port against the JAX package, on the
CPU: the cases of tests/test_higgs3_granite_nar.py's TestNarDecoding and
TestNarModel (the CTC collapse, insertion slots, the single-pass
transcription, determinism, the feature shape), each held to the JAX
package's on one weight set; the departures pinned (the unpadded encoder,
projector and editor against JAX's masked buckets, the layouts read from
shapes, the tokenizer hook that raises); an MLX-packed q8 directory
through both packages' loaders; and the loaders on a tiny directory.

Config: tests/test_higgs3_granite_nar.py's `nar` (a 4-layer d32 conformer
of 2 heads of 16, context 50, conv kernel 5, 12 CTC ids, 40 BPE ids,
pooling window 4, self-conditioning at layer 2; a 2-layer d32 Q-former of
4 heads over blocks of 15, downsample 5; a 2-layer d32 Granite editor of
4 heads and 2 KV heads, 40 ids; layers [1, 2, 3, -1], blank 0); one
parameter set drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`), the JAX passes jitted as the JAX
package jits them. Features, audio rows and editor logits at ATOL = 2e-4
(f32, summation order; tests/test_torch_parity.py:19); token ids and text
equal.
"""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402
from test_torch_prequantized import packed_leaf  # noqa: E402

ATOL = 2e-4
CFG = dict(
    encoder_config=dict(input_dim=160, num_layers=4, hidden_dim=32,
                        feedforward_mult=2, num_heads=2, dim_head=16,
                        output_dim=12, context_size=50, max_pos_emb=64,
                        conv_kernel_size=5, conv_expansion_factor=2,
                        bpe_output_dim=40, bpe_pooling_window=4,
                        self_conditioning_layer=2, blank_token_id=0),
    projector_config=dict(num_layers=2, num_encoder_layers=4,
                          hidden_size=32, num_heads=4, block_size=15,
                          downsample_rate=5, encoder_dim=32, llm_dim=32,
                          mlp_ratio=2),
    text_config=dict(hidden_size=32, intermediate_size=64,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, vocab_size=40,
                     attention_multiplier=0.35, embedding_multiplier=12.0,
                     logits_scaling=8.0, residual_multiplier=0.22),
    encoder_layer_indices=[1, 2, 3, -1], blank_token_id=0)
Q8_GROUP = 32


@pytest.fixture(autouse=True)
def no_hf_tokenizer(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)


@pytest.fixture(scope="module")
def pair():
    from mlx_audio_tpu.stt.models.granite_speech_nar import Model as JModel
    from mlx_audio_tpu.stt.models.granite_speech_nar import \
        ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.granite_speech_nar import (
        Model, ModelConfig)

    jm = JModel(JConfig.from_dict(CFG))
    jm.bind(numpy_params(jm.init_params, 0))
    pm = load_jax_params(Model(ModelConfig.from_dict(CFG), device="cpu"),
                         flat_numpy(jm.params))
    return jm, pm


def audio(seed, n, scale=0.1):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


@pytest.mark.parametrize("toks,blank,min_len", [
    ([5, 5, 0, 3, 3, 0, 5], 0, 8), ([0, 0, 0, 0], 0, 8), ([7, 9], 0, 8),
    ([], 3, 4), ([1, 2, 2, 2, 4, 1, 1, 3, 3, 5], 2, 2)])
def test_collapse_and_slots_are_jax_s(toks, blank, min_len):
    from mlx_audio_tpu.stt.models.granite_speech_nar import \
        granite_speech_nar as J
    from mlx_audio_tpu_torch.stt.models.granite_speech_nar import \
        granite_speech_nar as P

    toks = np.asarray(toks, np.int64)
    got = P.ctc_collapse_decode(toks, blank)
    assert got.tolist() == J.ctc_collapse_decode(toks, blank).tolist()
    assert P.add_insertion_slots(got, blank, min_len).tolist() == \
        J.add_insertion_slots(got, blank, min_len).tolist()


def test_features_match_jax(pair):
    """1 s of noise and 1 s of silence (which meets the floor 8 below the
    maximum) -> 200 mel frames stacked by 2: (100, 160), within ATOL of
    JAX's."""
    jm, pm = pair
    x = np.concatenate([audio(0, 16000), np.zeros(16000, np.float32)])
    got = pm._extract_features(x).numpy()
    want = jm._extract_features(x)
    assert got.shape == want.shape == (100, 160)
    assert (want == want.min()).sum() > 100
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_unpadded_passes_equal_jax_buckets(pair):
    """A departure: the port runs the 70 feature rows (two blocks of 50,
    the last padded inside the block attention), JAX the 400-row bucket
    under its masks. The BPE argmax, the 15 audio rows (5 blocks of 15
    frames, 3 queries each) and the editor's logits over a 20-id slotted
    hypothesis (JAX's 128-row bucket) agree."""
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.stt.models.granite_speech_nar.granite_speech_nar \
        import editor_forward as jax_editor
    from mlx_audio_tpu_torch.stt.models.granite_speech_nar.\
        granite_speech_nar import editor_forward

    jm, pm = pair
    feats = np.random.RandomState(1).randn(70, 160).astype(np.float32)
    bpe, rows = pm._encode(feats)
    jbpe, jrows = jm._encode(feats)
    assert bpe.tolist() == jbpe.tolist() and len(bpe) == 17
    assert rows.shape == jrows.shape == (15, 32)
    np.testing.assert_allclose(rows.numpy(), jrows, atol=ATOL)
    ids = np.random.RandomState(2).randint(0, 40, 20)
    text = pm.editor.embed_tokens.weight[torch.as_tensor(ids)]
    embeds = torch.cat([rows / 12.0, text])[None]
    got = editor_forward(pm, embeds, 15)[0].numpy()
    buf = np.zeros((1, 128, 32), np.float32)
    buf[0, :35] = embeds[0].numpy()
    want = np.asarray(jax.jit(lambda p, e, v: jax_editor(
        p, jm.config.text, e, v, 15))(jm.params, jnp.asarray(buf),
                                      jnp.int32(35)))[0, :20]
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert pm._edit(rows, ids).tolist() == jm._edit(jrows, ids).tolist()


@pytest.mark.parametrize("seed,n", [(0, 16000), (1, 15000), (3, 22400)])
def test_generate_equals_jax(pair, seed, n):
    """`generate` end to end (two passes): the ids' text equals JAX's, and
    a second run gives the same (tests/test_higgs3_granite_nar.py's
    determinism)."""
    jm, pm = pair
    x = audio(seed, n)
    got = pm.generate(x)
    assert got.text == jm.generate(x).text and got.text
    assert pm.generate(x).text == got.text
    assert got.generation_tokens == len(got.text.split())
    assert pm.last_run["frames"] == n // 320


def test_sanitize_reads_layouts_from_shapes(pair):
    """The JAX tree's WIO conv weights pass as JAX's sanitize passes them;
    torch and MLX layouts of the same weights give the same; step counters
    dropped."""
    jm, pm = pair
    rs = np.random.RandomState(3)
    wio = {"encoder.layers.0.conv.up_conv.weight": rs.randn(1, 32, 128),
           "encoder.layers.0.conv.depth_conv.conv.weight":
               rs.randn(5, 1, 64),
           "encoder.layers.0.conv.down_conv.weight": rs.randn(1, 64, 32),
           "editor.norm.weight": rs.randn(32)}
    wio = {k: v.astype(np.float32) for k, v in wio.items()}
    want = jm.sanitize(dict(wio, **{
        "encoder.layers.0.conv.batch_norm.num_batches_tracked": np.ones(())}))
    assert sorted(want) == sorted(wio)
    for layout in ((2, 1, 0), (2, 0, 1), (0, 1, 2)):
        w = {k: (np.transpose(v, layout) if v.ndim == 3 else v)
             for k, v in wio.items()}
        got = pm.sanitize(w)
        for k in wio:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def write_dir(path, state, **extra):
    path.mkdir()
    np.savez(path / "model.npz", **state)
    (path / "config.json").write_text(json.dumps(dict(
        CFG, model_type="granite_speech_nar", **extra)))


def wio_state(pm):
    from mlx_audio_tpu_torch.model import jax_params

    return {k: v.numpy() for k, v in jax_params(pm).items()}


def test_q8_packed_directory_quantizes_the_editor(pair, tmp_path):
    """An MLX-packed q8 directory (every 2-D `editor.` weight packed, the
    table too) through `stt.utils.load_model` and the JAX package's
    loader: the editor's 7 x 2 linears quantized (K2 on the card), the
    encoder and projector dense, the table an Embedding; the q8 editor's
    pass over the dense audio rows and a slotted hypothesis equals JAX's
    q8 editor's, and `generate`'s text (both passes) equals JAX's q8
    model's."""
    from mlx_audio_tpu.stt.utils import load_model as jax_load
    from mlx_audio_tpu_torch.nn import Embedding, QuantizedLinear
    from mlx_audio_tpu_torch.stt.utils import load_model

    _, pm = pair
    ckpt = {}
    for k, v in wio_state(pm).items():
        if k.startswith("editor.") and v.ndim == 2:
            for part, arr in packed_leaf(v, 8, Q8_GROUP).items():
                ckpt[k[:-len("weight")] + part] = arr
        else:
            ckpt[k] = v
    d = tmp_path / "granite-speech-nar-q8"
    write_dir(d, ckpt, quantization={"group_size": Q8_GROUP, "bits": 8})
    q8, jq = load_model(d, device="cpu"), jax_load(str(d))
    held = [n for n, m in q8.named_modules()
            if isinstance(m, QuantizedLinear)]
    assert len(held) == 14 and all(n.startswith("editor.layers")
                                   for n in held)
    assert isinstance(q8.editor.embed_tokens, Embedding)
    rows = q8._encode(np.random.RandomState(6).randn(50, 160)
                      .astype(np.float32))[1]
    ids = np.random.RandomState(7).randint(0, 40, 17)
    got = q8._edit(rows, ids)
    assert got.tolist() == jq._edit(rows.numpy(), ids).tolist()
    x = audio(6, 16000)
    got, want = q8.generate(x), jq.generate(x)
    assert got.text == want.text and got.text
    assert got.generation_tokens == want.generation_tokens


def test_loaders_route_a_tiny_directory(pair, tmp_path):
    """A dense directory (the JAX tree's names, torch conv layouts)
    through `stt.utils.load_model` and the top-level router: equal
    weights and text."""
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.stt.models.granite_speech_nar import Model
    from mlx_audio_tpu_torch.stt.utils import load_model

    _, pm = pair
    d = tmp_path / "granite-speech-4.1-nar-tiny"
    write_dir(d, {k: v.numpy() for k, v in pm.state_dict().items()})
    x = audio(7, 20000)
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

    from mlx_audio_tpu_torch.stt.models.granite_speech_nar import Model

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
