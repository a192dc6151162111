"""MLX pre-quantized checkpoints in the PyTorch port against the JAX
package, on the CPU: the cases of tests/test_prequantized.py (the unpack
at 2, 4 and 8 bits, a pre-quantized tree not re-quantized, embeddings made
dense, 3- and 6-bit packings refused with JAX's message), then whole
checkpoints written in the MLX layout and loaded by both packages: a tiny
Orpheus (4-bit, and its prefill logits at 2 and 8 bits) through the TTS
loaders, and a tiny Moshi LM (8-bit) through the STS loaders.

Inputs are drawn with numpy from fixed seeds. Codes are compared exactly;
floats at ATOL = 2e-4 (f32; the summation order differs).
"""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4


@pytest.fixture(autouse=True)
def no_hf_tokenizer(monkeypatch):
    """The checkpoints written here hold no tokenizer files, so the JAX
    package's Orpheus `post_load_hook`, which tries `transformers`'
    AutoTokenizer on any directory, finds none. With `transformers`
    blocked its import (seconds, with scikit-learn's) fails at once, to
    the same None tokenizer."""
    monkeypatch.setitem(sys.modules, "transformers", None)


def mlx_pack(w_q: np.ndarray, bits: int) -> np.ndarray:
    """uint8 codes (out, in) -> MLX uint32 words, least significant first
    (tests/test_prequantized.py::_mlx_pack)."""
    out_f, in_f = w_q.shape
    per = 32 // bits
    codes = w_q.reshape(out_f, in_f // per, per).astype(np.uint32)
    shifts = (np.arange(per, dtype=np.uint32) * bits)[None, None, :]
    return np.bitwise_or.reduce(codes << shifts, axis=-1)


def packed_leaf(w: np.ndarray, bits: int, group_size: int) -> dict:
    """An (out, in) weight as an MLX checkpoint ships it: {weight uint32,
    scales, biases}, by the JAX package's affine quantizer's arithmetic
    (quant.py:28-51) in numpy."""
    out_f, in_f = w.shape
    g = w.reshape(out_f, in_f // group_size, group_size).astype(np.float32)
    wmin = g.min(-1)
    scales = np.maximum((g.max(-1) - wmin) / ((1 << bits) - 1),
                        np.float32(1e-8)).astype(np.float32)
    q = np.clip(np.round((g - wmin[..., None]) / scales[..., None]), 0,
                (1 << bits) - 1).astype(np.uint8).reshape(out_f, in_f)
    return {"weight": mlx_pack(q, bits), "scales": scales, "biases": wmin}


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_unpack_roundtrip(bits):
    from mlx_audio_tpu.ops.quant import quantize_weight
    from mlx_audio_tpu.ops.quant import unpack_mlx_quantized as jax_unpack
    from mlx_audio_tpu_torch.ops.quant import (dequantize_weight,
                                               unpack_mlx_quantized)

    w = np.random.RandomState(0).randn(16, 128).astype(np.float32)
    q = quantize_weight(jnp.asarray(w), group_size=32, bits=bits)
    packed = mlx_pack(np.asarray(q["w_q"]), bits)
    un = unpack_mlx_quantized(packed, np.asarray(q["scales"]),
                              np.asarray(q["biases"]), group_size=32)
    ref = jax_unpack(jnp.asarray(packed), q["scales"], q["biases"], 32)
    assert un["w_q"].dtype == torch.uint8
    np.testing.assert_array_equal(un["w_q"].numpy(), np.asarray(q["w_q"]))
    np.testing.assert_array_equal(un["w_q"].numpy(), np.asarray(ref["w_q"]))
    np.testing.assert_allclose(dequantize_weight(un).numpy(),
                               np.asarray(dequantize_weight_jax(ref)),
                               atol=1e-6)


def dequantize_weight_jax(q):
    from mlx_audio_tpu.ops.quant import dequantize_weight

    return dequantize_weight(q)


def test_bf16_scales_become_f32():
    """Scales and biases of a bf16 checkpoint unpack to f32, as K2 takes
    them (quant.py:352-355)."""
    from mlx_audio_tpu_torch.ops.quant import unpack_mlx_quantized

    leaf = packed_leaf(np.random.RandomState(3).randn(8, 64)
                       .astype(np.float32), 4, 32)
    un = unpack_mlx_quantized(
        leaf["weight"], torch.from_numpy(leaf["scales"]).bfloat16(),
        torch.from_numpy(leaf["biases"]).bfloat16(), 32)
    assert un["scales"].dtype == un["biases"].dtype == torch.float32


class TwoLinears(torch.nn.Module):
    def __init__(self):
        super().__init__()
        from mlx_audio_tpu_torch.nn import Linear

        self.proj = Linear(64, 8, bias=True)
        self.other = Linear(64, 8, bias=False)


def test_prequantized_tree_not_requantized():
    """A packed leaf unpacks to the checkpoint's codes and is bound as a
    QuantizedLinear; a dense leaf of a pre-quantized checkpoint stays dense,
    whatever the predicate says."""
    from mlx_audio_tpu.utils import apply_quantization as jax_apply
    from mlx_audio_tpu_torch.nn import Linear, QuantizedLinear
    from mlx_audio_tpu_torch.utils import (apply_quantization,
                                           unpack_prequantized)

    rng = np.random.RandomState(1)
    leaf = packed_leaf(rng.randn(8, 64).astype(np.float32), 4, 64)
    dense = rng.randn(8, 64).astype(np.float32)
    weights = {"proj.weight": leaf["weight"], "proj.scales": leaf["scales"],
               "proj.biases": leaf["biases"], "proj.bias": np.zeros(8,
                                                                   np.float32),
               "other.weight": dense}
    config = {"quantization": {"group_size": 64, "bits": 4}}
    jout = jax_apply({"proj": {k.split(".")[1]: jnp.asarray(v)
                               for k, v in weights.items()
                               if k.startswith("proj")},
                      "other": {"weight": jnp.asarray(dense)}}, config,
                     weights)
    model = TwoLinears()
    flat = unpack_prequantized(model, config, weights)
    np.testing.assert_array_equal(flat["proj.w_q"].numpy(),
                                  np.asarray(jout["proj"]["w_q"]))
    assert "proj.weight" not in flat and "proj.bias" in flat
    np.testing.assert_array_equal(np.asarray(flat["other.weight"]), dense)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in flat.items()})
    apply_quantization(model, config, lambda p, w: True, pre_quantized=True)
    assert isinstance(model.proj, QuantizedLinear)
    assert type(model.other) is Linear
    x = rng.randn(3, 64).astype(np.float32)
    from mlx_audio_tpu.nn import apply_linear

    np.testing.assert_allclose(model.proj(torch.from_numpy(x)).numpy(),
                               np.asarray(apply_linear(jout["proj"],
                                                       jnp.asarray(x))),
                               atol=ATOL)


def test_prequantized_embedding_dequantized_dense():
    from mlx_audio_tpu.ops.quant import maybe_quantize_tree as jax_tree
    from mlx_audio_tpu_torch.ops.quant import maybe_quantize_tree

    leaf = packed_leaf(np.random.RandomState(2).randn(32, 64)
                       .astype(np.float32), 4, 64)
    out = maybe_quantize_tree({"embed_tokens": {
        k: torch.from_numpy(v.astype(np.int64) if k == "weight" else v)
        for k, v in leaf.items()}}, group_size=64, bits=4)
    ref = jax_tree({"embed_tokens": {k: jnp.asarray(v)
                                     for k, v in leaf.items()}}, 64, 4)
    emb = out["embed_tokens"]
    assert "w_q" not in emb and tuple(emb["weight"].shape) == (32, 64)
    assert emb["weight"].dtype == torch.float32
    np.testing.assert_allclose(emb["weight"].numpy(),
                               np.asarray(ref["embed_tokens"]["weight"]),
                               atol=1e-6)


@pytest.mark.parametrize("in_f,packed,match", [
    (256, 24, "cannot infer MLX quant bits"),    # 3-bit: 256 x 3 / 32 words
    (192, 36, "cannot infer MLX quant bits"),    # 6-bit: 192 x 6 / 32 words
    (320, 64, "unsupported MLX packing"),        # 5 codes a word
    (128, 64, "16-bit MLX packing")])
def test_unsupported_bits_raise(in_f, packed, match):
    """3- and 6-bit packings (their codes straddle words), and any width
    but 2, 4 and 8, raise with the JAX package's message, never unpack
    silently."""
    from mlx_audio_tpu.ops.quant import unpack_mlx_quantized as jax_unpack
    from mlx_audio_tpu_torch.ops.quant import unpack_mlx_quantized

    scales = np.ones((4, in_f // 64), np.float32)
    biases = np.zeros((4, in_f // 64), np.float32)
    w = np.zeros((4, packed), np.uint32)
    with pytest.raises(ValueError, match=match):
        unpack_mlx_quantized(w, scales, biases, group_size=64)
    with pytest.raises(ValueError, match=match):
        jax_unpack(jnp.asarray(w), jnp.asarray(scales), jnp.asarray(biases),
                   group_size=64)


# ---------------------------------------------------------------------------
# whole checkpoints through both packages' loaders
# ---------------------------------------------------------------------------

ORPHEUS = dict(model_type="llama", hidden_size=64, num_hidden_layers=2,
               intermediate_size=128, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, rope_theta=10000.0,
               vocab_size=128266 + 7 * 4096)
SNAC_TINY = dict(model_type="snac", sampling_rate=24000, encoder_dim=16,
                 encoder_rates=[2, 2], decoder_dim=32, decoder_rates=[2, 2],
                 attn_window_size=None, codebook_size=4096, codebook_dim=8,
                 vq_strides=[4, 2, 1], noise=True, depthwise=True)


class FakeTok:
    eos_token_id = 128001

    def encode(self, text):
        return [ord(c) % 100 + 10 for c in text]


def torch_snac_state(flat: dict) -> dict:
    """The JAX SNAC tree (WIO kernels, pre-flipped upsamplers) as a torch
    checkpoint in the weight-norm form (`weight_g`, `weight_v`), which
    both packages' `sanitize` fold."""
    import re

    out = {}
    for k, v in flat.items():
        if k.endswith(".weight") and v.ndim == 3:
            base = k[:-len(".weight")]
            if re.search(r"decoder\.\d+\.block\.1$", base):
                w = np.flip(v, 0).transpose(1, 2, 0)   # (I, O, W), g = 1
            else:
                w = v.transpose(2, 1, 0)
            g = np.sqrt((w.astype(np.float64) ** 2).sum(axis=(1, 2),
                                                        keepdims=True))
            out[base + ".weight_g"] = g.astype(np.float32)
            out[base + ".weight_v"] = np.ascontiguousarray(w)
        else:
            out[k] = v
    return out


def write_orpheus(path, bits: int, seed: int = 0, **over):
    """A tiny Orpheus in the mlx-community layout: every linear and the
    token table packed at `bits` (group 64), the norms dense, and a SNAC
    `snac/` subfolder in torch's weight-norm layout. -> the dense JAX
    parameters it was drawn from."""
    from safetensors.numpy import save_file

    from mlx_audio_tpu.codec.models.snac import SNAC
    from mlx_audio_tpu.tts.models.llama import Model, ModelConfig

    cfg = dict(ORPHEUS, **over)
    jm = Model(ModelConfig.from_dict(cfg))
    params = flat_numpy(numpy_params(jm.init_params, seed))
    ckpt = {}
    for k, v in params.items():
        if k.endswith(".weight") and v.ndim == 2:
            for part, arr in packed_leaf(v, bits, 64).items():
                ckpt[k[:-len("weight")] + part] = arr
        else:
            ckpt[k] = v
    path.mkdir(parents=True)
    save_file(ckpt, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(dict(
        cfg, quantization={"group_size": 64, "bits": bits})))
    snac = SNAC(dict(SNAC_TINY))
    sparams = flat_numpy(numpy_params(snac.init_params, seed + 1))
    (path / "snac").mkdir()
    save_file(torch_snac_state(sparams), str(path / "snac" /
                                              "model.safetensors"))
    (path / "snac" / "config.json").write_text(json.dumps(SNAC_TINY))


def load_both(path):
    from mlx_audio_tpu.tts.utils import load_model as jax_load
    from mlx_audio_tpu_torch.tts.utils import load_model

    jm = jax_load(path)
    pm = load_model(path, device="cpu")
    jm._tokenizer = pm.tokenizer = FakeTok()
    return jm, pm


def _prefill_logits(jm, pm, ids):
    from mlx_audio_tpu.tts.models.llama.llama import (llama_forward,
                                                      logits_from_hidden)
    from mlx_audio_tpu_torch.tts.models.llama import llama_forward as pf
    from mlx_audio_tpu_torch.tts.models.llama import logits_from_hidden as pl

    jh, _ = jax.jit(lambda p, x: llama_forward(p, jm.config, x))(
        jm.params, jnp.asarray(ids))
    jl = np.asarray(logits_from_hidden(jm.params, jm.config, jh))
    ph, _ = pf(pm, torch.from_numpy(ids))
    return jl, pl(pm, ph).numpy()


@pytest.mark.parametrize("bits", [2, 8])
def test_packed_orpheus_logits_match_jax(tmp_path, bits):
    """Both loaders unpack the same packed files: equal codes in every
    linear (K2's layout, bound as QuantizedLinear), the token table dense,
    and the same prefill logits."""
    from mlx_audio_tpu.utils import flatten
    from mlx_audio_tpu_torch.nn import Embedding, QuantizedLinear

    write_orpheus(tmp_path / "orpheus", bits, vocab_size=1024)
    jm, pm = load_both(tmp_path / "orpheus")
    jflat = flatten(jm.params)
    state = pm.state_dict()
    n_q = 0
    for name, m in pm.named_modules():
        if isinstance(m, QuantizedLinear):
            n_q += 1
            np.testing.assert_array_equal(
                m.w_q.numpy(), np.asarray(jflat[f"{name}.w_q"]))
    assert n_q == 7 * ORPHEUS["num_hidden_layers"] + 1      # + lm_head
    assert isinstance(pm.model.embed_tokens, Embedding)
    np.testing.assert_allclose(state["model.embed_tokens.weight"].numpy(),
                               np.asarray(jflat["model.embed_tokens.weight"]),
                               atol=1e-6)
    ids = np.random.RandomState(4).randint(0, 1000, (1, 12))
    jl, pl = _prefill_logits(jm, pm, ids)
    np.testing.assert_allclose(pl, jl, atol=ATOL)


def test_packed_orpheus_generates_as_jax(tmp_path):
    """A 4-bit packed Orpheus with its SNAC subfolder, loaded by both
    packages: the same greedy tokens, and the same audio with the port's
    SNAC fed JAX's noise."""
    write_orpheus(tmp_path / "orpheus4", 4)
    jm, pm = load_both(tmp_path / "orpheus4")
    assert pm.codec is not None and jm._codec is not None
    pm.codec._noise = lambda g, stage, shape: torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), shape)))
    ids = jm.prepare_input_ids("hi there", voice="tara")
    *_, jt = jm._decode_tokens(ids, 21, 0.0, 0.8, 0, 1.3, 0)
    *_, pt = pm._decode_tokens(ids, 21, 0.0, 0.8, 0, 1.3, 0)
    assert pt == jt and len(pt) == 21
    kw = dict(voice="tara", max_tokens=21, temperature=0.0, seed=0)
    (jr,) = list(jm.generate("hi there", **kw))
    (pr,) = list(pm.generate("hi there", **kw))
    assert pr.samples == jr.samples > 0
    np.testing.assert_allclose(pr.audio, np.asarray(jr.audio), atol=ATOL)


def test_packed_moshi_through_the_sts_loaders(tmp_path):
    """A tiny Moshi LM (kyutai MLX names) with every linear packed at 8 bits
    and its tables dense: both STS loaders unpack it, and the text logits
    of 6 tokens agree."""
    from mlx_audio_tpu.sts.models.moshi import Lm, LmConfig
    from mlx_audio_tpu.sts.utils import load_model as jax_load
    from mlx_audio_tpu_torch.nn import Linear, QuantizedLinear
    from mlx_audio_tpu_torch.sts.models.moshi import Lm as PortLm
    from mlx_audio_tpu_torch.sts.utils import load_model
    from safetensors.numpy import save_file

    from chip_smoke import MOSHI_Q8_SMALL

    lm = Lm(LmConfig.from_dict(MOSHI_Q8_SMALL))
    flat = flat_numpy(numpy_params(lm.init_params, 0))
    linears = {n for n, m in PortLm(LmConfig.from_dict(MOSHI_Q8_SMALL),
                                    device="cpu").named_modules()
               if isinstance(m, Linear)}
    ckpt = {}
    for k, v in flat.items():
        base = k[:-len(".weight")]
        if k.endswith(".weight") and base in linears:
            ckpt.update({f"{base}.{p}": a
                         for p, a in packed_leaf(v, 8, 64).items()})
        else:
            ckpt[k] = v
    d = tmp_path / "moshi-q8"
    d.mkdir()
    save_file(ckpt, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps({
        "model_type": "moshi", "lm_config": MOSHI_Q8_SMALL,
        "mimi_num_codebooks": 4,
        "quantization": {"group_size": 64, "bits": 8}}))
    jmodel, pmodel = jax_load(d), load_model(d, device="cpu")
    n_q = sum(isinstance(m, QuantizedLinear) for m in pmodel.modules())
    assert n_q == len(linears)
    ids = np.random.RandomState(2).randint(0, 63, (1, 6))
    jl = jmodel.lm
    _, jlog, _ = jax.jit(jl.forward_text)(jl.params, jnp.asarray(ids),
                                          jl.make_caches(1, max_steps=8), 0)
    _, plog = pmodel.lm.forward_text(torch.from_numpy(ids),
                                     pmodel.lm.make_caches(1, max_steps=8),
                                     0)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), atol=ATOL)


def test_a_packed_leaf_that_is_no_linear_raises():
    """An MLX-packed leaf must be a linear of the model: one that is not
    raises at load, naming it (the JAX package binds it as `w_q` and fails
    later, in the forward)."""
    from mlx_audio_tpu_torch.utils import unpack_prequantized

    leaf = packed_leaf(np.random.RandomState(4).randn(8, 64)
                       .astype(np.float32), 4, 64)
    weights = {f"gate.{k}": v for k, v in leaf.items()}
    weights["other.weight"] = np.zeros((8, 64), np.float32)
    with pytest.raises(ValueError, match=r"not linears.*gate\.w_q"):
        unpack_prequantized(TwoLinears(), {"quantization": {
            "group_size": 64, "bits": 4}}, weights)
