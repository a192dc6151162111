"""The port's Canary against the JAX package, on the CPU at f32: the cases
of tests/test_canary.py on the port, then the host front end, the encoder
at its mel bucket, the greedy tokens (running to `max_tokens`, and stopping
at an EOS made likely by its logit's bias), `load_model` of a checkpoint
directory, and the departures: a prompt plus `max_tokens` past the
position table raises, a tokenizer file that fails to load raises at load
time, and `sanitize` reads torch's and MLX's conv layouts from the model's
own shapes.

Both packages run one weight set: the JAX model's random parameters
(tests/test_canary.py's `_cfg`) loaded into the port with
`model.load_jax_params`; `_FakeTok` in both. Tensors agree within ATOL =
2e-4, the repo's f32 precedent; tokens are equal.
"""

import dataclasses
import json
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from mlx_audio_tpu.stt.models.canary import Model as JModel  # noqa: E402
from mlx_audio_tpu.utils import flatten  # noqa: E402
from test_canary import _cfg, _FakeTok  # noqa: E402

ATOL = 2e-4
SR = 16000


def config_dict():
    """tests/test_canary.py's tiny config as a plain dict."""
    return json.loads(json.dumps(dataclasses.asdict(_cfg())))


def port_model(flat=None):
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.canary import Model, ModelConfig

    pm = Model(ModelConfig.from_dict(config_dict()), device="cpu")
    if flat is not None:
        load_jax_params(pm, flat)
    pm._tokenizer = _FakeTok()
    return pm


@pytest.fixture(scope="module")
def pair():
    jm = JModel(_cfg()).init_and_bind()
    jm._tokenizer = _FakeTok()
    return jm, port_model({k: np.asarray(v)
                           for k, v in flatten(jm.params).items()})


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def noise(seed, seconds, scale=0.1):
    return (scale * np.random.RandomState(seed).randn(int(SR * seconds))
            ).astype(np.float32)


def _caches(model, length):
    from mlx_audio_tpu_torch.ops.kvcache import KVCache

    cfg = model.dec_cfg
    d = model.config.enc_output_dim
    return KVCache.init(1, length, cfg.num_attention_heads,
                        d // cfg.num_attention_heads, dtype=torch.float32,
                        n_layers=cfg.num_layers)


def _forward(model, toks, enc, mask, caches, offset):
    from mlx_audio_tpu_torch.stt.models.canary import canary as pcn

    ckv = pcn.cross_kv(model.decoder, model.dec_cfg, enc)
    h = pcn.decoder_forward(model.decoder, model.dec_cfg, toks,
                            pcn.encoder_bias(mask), caches, ckv, offset,
                            model.pos_table)
    return pcn.logits(model.decoder, h)


# --------------------------------------------- tests/test_canary.py cases


class TestPositions:
    def test_interleaved_and_scaled(self):
        from mlx_audio_tpu_torch.stt.models.canary.canary import \
            _fixed_positions

        pe = _fixed_positions(8, 4)
        np.testing.assert_allclose(pe[0], [0, 0.5, 0, 0.5], atol=1e-6)


class TestDecoder:
    def test_prefill_then_step_matches_full(self, model):
        d = model.config.enc_output_dim
        enc = torch.from_numpy(np.random.RandomState(0)
                               .randn(1, 12, d).astype(np.float32) * 0.1)
        mask = torch.ones(1, 12, dtype=torch.bool)
        toks = torch.from_numpy(np.random.RandomState(1).randint(0, 64,
                                                                 (1, 6)))
        with torch.inference_mode():
            full = _forward(model, toks, enc, mask, _caches(model, 8), 0)
            caches = _caches(model, 8)
            pre = _forward(model, toks[:, :4], enc, mask, caches, 0)
            np.testing.assert_allclose(pre.numpy(), full[:, :4].numpy(),
                                       atol=2e-4)
            for i in range(4, 6):
                lg = _forward(model, toks[:, i:i + 1], enc, mask, caches, i)
                np.testing.assert_allclose(lg[:, 0].numpy(),
                                           full[:, i].numpy(), atol=2e-4)

    def test_encoder_mask_blocks_padding(self, model):
        d = model.config.enc_output_dim
        enc = np.random.RandomState(2).randn(1, 10, d).astype(np.float32)
        mask = torch.zeros(1, 10, dtype=torch.bool)
        mask[0, :6] = True
        toks = torch.tensor([[3, 4]])
        enc2 = enc.copy()
        enc2[0, 7:] += 100.0          # masked region
        with torch.inference_mode():
            a = _forward(model, toks, torch.from_numpy(enc), mask,
                         _caches(model, 4), 0)
            b = _forward(model, toks, torch.from_numpy(enc2), mask,
                         _caches(model, 4), 0)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


class TestGenerate:
    def test_end_to_end(self, model):
        out = model.generate(noise(3, 1.0), max_tokens=12)
        assert isinstance(out.text, str)
        assert out.prompt_tokens == 9
        assert out.generation_tokens <= 12
        assert out.language == "en"

    def test_language_kwarg_sets_prompt(self, model):
        out = model.generate(np.zeros(8000, np.float32), max_tokens=4,
                             language="de")
        assert out.language == "de"

    def test_no_tokenizer_errors(self):
        m = port_model()
        m._tokenizer = None
        with pytest.raises(RuntimeError, match="tokenizer"):
            m.generate(np.zeros(8000, np.float32))


class TestSanitize:
    def test_mlx_native_decoder_remap(self, model):
        out = model.sanitize({
            "transf_decoder.layers.0.first_sub_layer.linear_q.weight":
                np.ones((4, 4)),
            "transf_decoder.layers.0.second_sub_layer.linear_out.bias":
                np.ones((4,)),
            "transf_decoder.layers.0.third_sub_layer.dense_in.weight":
                np.ones((8, 4)),
            "head.classifier.weight": np.ones((64, 4)),
            "transf_decoder.embedding.token_embedding.weight":
                np.ones((64, 4)),
        })
        assert "decoder.blocks.0.self_attn.q_proj.weight" in out
        assert "decoder.blocks.0.cross_attn.out_proj.bias" in out
        assert "decoder.blocks.0.ff1.weight" in out
        assert "decoder.output_proj.weight" in out
        assert "decoder.embedding.weight" in out


# ------------------------------------------------------- against JAX


@pytest.mark.parametrize("seconds", [0.4, 1.0, 3.1])
def test_log_mel_matches_jax(pair, seconds):
    jm, pm = pair
    x = noise(int(seconds * 10), seconds, 0.5)
    want, got = jm._log_mel(x), pm._log_mel(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_encode_matches_jax(pair):
    """The encoder at the mel's bucket (300 frames -> 512) with the valid
    length: the valid rows within 2e-4, and the same mask."""
    from mlx_audio_tpu_torch.stt.models.canary.canary import mel_bucket

    jm, pm = pair
    mel = pm._log_mel(noise(4, 3.0))
    t = mel.shape[0]
    assert mel_bucket(t) == 512
    padded = np.zeros((1, 512, mel.shape[1]), np.float32)
    padded[0, :t] = mel
    encode, _ = jm._fns(512, 4)
    want, wmask = (np.asarray(a) for a in encode(
        jm.params, jnp.asarray(padded), jnp.asarray([t])))
    got, mask = pm.encode(mel)
    np.testing.assert_array_equal(mask.numpy(), wmask)
    np.testing.assert_allclose(got.numpy()[wmask], want[wmask], atol=ATOL,
                               rtol=0)


def _eos_biased(pair, scale):
    """Both models with the EOS row's output bias raised by `scale`."""
    jm, pm = pair
    bias = np.asarray(jm.params["decoder"]["output_proj"]["bias"]).copy()
    bias[_FakeTok.eos_id] += scale
    jm2 = JModel(_cfg())
    jm2.params = {**jm.params, "decoder": {
        **jm.params["decoder"],
        "output_proj": {**jm.params["decoder"]["output_proj"],
                        "bias": jnp.asarray(bias)}}}
    jm2._tokenizer = _FakeTok()
    flat = {k: np.asarray(v) for k, v in flatten(jm2.params).items()}
    return jm2, port_model(flat)


@pytest.mark.parametrize("seed,seconds,max_tokens,eos_bias",
                         [(5, 1.0, 20, 0.0), (6, 2.6, 30, 0.0),
                          (7, 1.5, 30, 0.9)])
def test_greedy_tokens_match_jax(pair, seed, seconds, max_tokens, eos_bias):
    jm, pm = _eos_biased(pair, eos_bias) if eos_bias else pair
    audio = noise(seed, seconds)
    want = jm.generate(audio, max_tokens=max_tokens)
    got = pm.generate(audio, max_tokens=max_tokens)
    assert (got.text, got.generation_tokens, got.prompt_tokens) == \
        (want.text, want.generation_tokens, want.prompt_tokens)
    if eos_bias:        # stopped at EOS, one step late at most
        assert 0 < got.generation_tokens < max_tokens
        assert pm.last_run["decode_steps"] <= got.generation_tokens + 2
    else:
        assert got.generation_tokens == max_tokens


def test_load_model_of_a_directory(pair, tmp_path):
    """A checkpoint directory (config.json, the JAX tree's names in torch
    layouts in an npz, a tokens.json piece list) through the STT router:
    the model's exact parameters, and its transcript under the piece
    list."""
    import mlx_audio_tpu_torch
    from chip_smoke import write_canary_checkpoint
    from mlx_audio_tpu_torch.stt.models.canary import CanaryTokenizer, Model

    _, pm = pair
    pieces = write_canary_checkpoint(pm, tmp_path / "canary-tiny")
    loaded = mlx_audio_tpu_torch.load_model(tmp_path / "canary-tiny",
                                            device="cpu")
    assert isinstance(loaded, Model)
    assert loaded._tokenizer.token2id == CanaryTokenizer(
        piece_list=pieces).token2id
    for k, v in pm.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    ref = port_model()
    ref.load_state_dict(pm.state_dict())
    ref._tokenizer = CanaryTokenizer(piece_list=pieces)
    audio = noise(8, 1.0)
    out = loaded.generate(audio, max_tokens=10)
    assert out.text == ref.generate(audio, max_tokens=10).text and out.text


# ----------------------------------------------------------- departures


def test_prompt_past_the_position_table_raises(pair):
    """JAX's gather clamps a position past the table's 64 rows and repeats
    the last; the port raises before the prefill."""
    from mlx_audio_tpu.stt.models.canary import canary as jcn

    jm, pm = pair
    table = jcn._fixed_positions(64, 16)
    clamped = np.asarray(jnp.asarray(table)[jnp.arange(60, 70)])
    np.testing.assert_array_equal(clamped[4:], np.repeat(table[-1:], 6, 0))
    audio = noise(9, 0.5)
    assert pm.generate(audio, max_tokens=55).generation_tokens == 55
    with pytest.raises(ValueError, match="64 positions"):
        pm.generate(audio, max_tokens=56)


def _fake_sentencepiece(monkeypatch):
    """A sentencepiece whose processor fails to load any model."""
    class Processor:
        def __init__(self, model_proto=None):
            if model_proto is not None:
                raise RuntimeError("corrupt tokenizer proto")

        def load(self, path):
            raise OSError(f"corrupt tokenizer file {path}")

    monkeypatch.setitem(sys.modules, "sentencepiece", types.SimpleNamespace(
        SentencePieceProcessor=Processor))


@pytest.mark.parametrize("where", ["tokenizer.model", "config.json"])
def test_a_tokenizer_that_fails_to_load_raises(pair, tmp_path, monkeypatch,
                                               where):
    """A tokenizer file (or config.json's base64 model) that is present but
    fails to load: JAX's post_load_hook swallows the error and generate()
    later says "tokenizer not loaded"; the port's raises at load time."""
    import base64

    from mlx_audio_tpu_torch.stt.models.canary import Model

    _fake_sentencepiece(monkeypatch)
    if where == "tokenizer.model":
        (tmp_path / "tokenizer.model").write_bytes(b"\0corrupt")
    else:
        (tmp_path / "config.json").write_text(json.dumps(
            {"tokenizer_model_base64": base64.b64encode(b"x").decode()}))
    jm = JModel(_cfg())
    JModel.post_load_hook(jm, tmp_path)
    assert jm._tokenizer is None
    with pytest.raises((OSError, RuntimeError), match="corrupt"):
        Model.post_load_hook(port_model(), tmp_path)


def _layouts(pm):
    """The port's tree under its (the JAX tree's) names in torch layouts,
    and under MLX community names in MLX layouts (conv1d (O, K, I), conv2d
    (O, H, W, I))."""
    torch_state = {k: v.numpy() for k, v in pm.state_dict().items()}
    mlx = {}
    for k, v in torch_state.items():
        if k.endswith("weight") and v.ndim == 3:
            v = np.transpose(v, (0, 2, 1))
        elif k.endswith("weight") and v.ndim == 4:
            v = np.transpose(v, (0, 2, 3, 1))
        for ours, theirs in ((".self_attn.", ".first_sub_layer."),
                             (".cross_attn.", ".second_sub_layer."),
                             (".q_proj.", ".linear_q."),
                             (".k_proj.", ".linear_k."),
                             (".v_proj.", ".linear_v."),
                             (".out_proj.", ".linear_out."),
                             (".ff1.", ".third_sub_layer.dense_in."),
                             (".ff2.", ".third_sub_layer.dense_out."),
                             ("decoder.blocks.", "transf_decoder.layers."),
                             ("decoder.output_proj.", "head.classifier."),
                             ("decoder.embedding.",
                              "transf_decoder.embedding.token_embedding.")):
            if k.startswith(("decoder.", "transf_decoder.", "head.")):
                k = k.replace(ours, theirs)
        mlx[k] = v
    return torch_state, mlx


def test_sanitize_reads_the_layout_from_the_model(pair):
    """One tree in torch's layout and one in MLX's (its community names
    too): both load to the model's exact parameters and give its
    transcript. JAX's sanitize guesses from the shapes, which is right for
    torch's layout and wrong for MLX's (a depthwise (16, 5, 1) becomes
    (1, 5, 16), where WIO is (5, 1, 16)), and renames the encoder's
    attention keys to the decoder's names."""
    from mlx_audio_tpu_torch.model import load_jax_params

    jm, pm = pair
    audio = noise(10, 1.0)
    want = pm.generate(audio, max_tokens=8).text
    for tree in _layouts(pm):
        fresh = load_jax_params(port_model(), port_model().sanitize(tree))
        for k, v in pm.state_dict().items():
            assert torch.equal(fresh.state_dict()[k], v), k
        assert fresh.generate(audio, max_tokens=8).text == want
    torch_state, mlx = _layouts(pm)
    dw = "encoder.layers.0.conv.depthwise_conv.weight"
    assert mlx[dw].shape == (16, 5, 1)
    assert jm.sanitize({dw: torch_state[dw]})[dw].shape == (5, 1, 16)
    assert jm.sanitize({dw: mlx[dw]})[dw].shape == (1, 5, 16)
    # JAX renames the encoder attention's linear_q to the decoder's q_proj
    q = "encoder.layers.0.self_attn.linear_q.weight"
    assert set(jm.sanitize({q: mlx[q]})) == {
        "encoder.layers.0.self_attn.q_proj.weight"}
    assert set(pm.sanitize({q: mlx[q]})) == {q}
