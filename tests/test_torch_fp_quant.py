"""The microscaling fp modes (mxfp4, nvfp4, mxfp8) and the mixed-bit
recipes of the PyTorch port against the JAX package, on the CPU: the cases
of tests/test_fp_quant.py. Codes and scales must equal JAX's for each mode
(the same E2M1 table, E8M0 and E4M3 scale rounding, fp8 bytes), `fp_matmul`
and the `FpQuantizedLinear` that stands for JAX's fp branch of
`apply_linear` must give JAX's product, the recipes JAX's bit widths, and
the convert CLI's quantize-and-reload must run in each mode.

Inputs are drawn with numpy from fixed seeds; f32 products at ATOL = 2e-4
(summation order; the weight is decoded exactly in both packages).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

ATOL = 2e-4
MODES = ["mxfp4", "nvfp4", "mxfp8"]


@pytest.fixture(scope="module")
def w():
    return np.random.RandomState(0).randn(16, 128).astype(np.float32)


def _codes(q):
    return q.get("w_fp4", q.get("w_fp8"))


@pytest.mark.parametrize("mode", MODES)
def test_codes_and_scales_equal_jax(w, mode):
    from mlx_audio_tpu.ops.quant import quantize_weight_fp as jax_q
    from mlx_audio_tpu_torch.ops.quant import (FP_MODE_DEFAULTS,
                                               quantize_weight_fp)

    q = quantize_weight_fp(torch.from_numpy(w), mode)
    ref = jax_q(jnp.asarray(w), mode)
    assert set(q) == set(ref)
    gs = FP_MODE_DEFAULTS[mode]
    assert tuple(q["scales"].shape) == (16, 128 // gs)
    assert _codes(q).dtype == torch.uint8
    np.testing.assert_array_equal(_codes(q).numpy(), np.asarray(_codes(ref)))
    np.testing.assert_array_equal(q["scales"].numpy(),
                                  np.asarray(ref["scales"]))


@pytest.mark.parametrize("mode,rel_tol", [
    ("mxfp4", 0.30), ("nvfp4", 0.25), ("mxfp8", 0.06)])
def test_roundtrip_error_bounds(w, mode, rel_tol):
    from mlx_audio_tpu_torch.ops.quant import (dequantize_weight_fp,
                                               quantize_weight_fp)

    deq = dequantize_weight_fp(quantize_weight_fp(torch.from_numpy(w),
                                                  mode)).numpy()
    err = np.abs(deq - w).mean() / np.abs(w).mean()
    assert err < rel_tol, (mode, err)


def test_mx_scales_are_powers_of_two(w):
    from mlx_audio_tpu_torch.ops.quant import quantize_weight_fp

    for mode in ("mxfp4", "mxfp8"):
        exps = np.log2(quantize_weight_fp(torch.from_numpy(w), mode)
                       ["scales"].numpy())
        np.testing.assert_allclose(exps, np.round(exps), atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_fp_matmul_and_linear_equal_jax(w, mode):
    """`fp_matmul` and an FpQuantizedLinear (with a bias) against JAX's
    `fp_matmul` and `apply_linear` on the same codes."""
    from mlx_audio_tpu.nn import apply_linear
    from mlx_audio_tpu.ops.quant import fp_matmul as jax_mm
    from mlx_audio_tpu.ops.quant import quantize_weight_fp as jax_q
    from mlx_audio_tpu_torch.nn import FpQuantizedLinear
    from mlx_audio_tpu_torch.ops.quant import fp_matmul, quantize_weight_fp

    rng = np.random.RandomState(1)
    x = rng.randn(3, 128).astype(np.float32)
    bias = rng.randn(16).astype(np.float32) * 0.1
    q = quantize_weight_fp(torch.from_numpy(w), mode)
    ref = jax_q(jnp.asarray(w), mode)
    np.testing.assert_allclose(fp_matmul(q, torch.from_numpy(x)).numpy(),
                               np.asarray(jax_mm(ref, jnp.asarray(x))),
                               atol=ATOL)
    codes = "w_fp4" if "w_fp4" in q else "w_fp8"
    lin = FpQuantizedLinear(128, 16, 128 // q["scales"].shape[1], codes,
                            bias=True)
    lin.load_state_dict({codes: q[codes], "scales": q["scales"],
                         "bias": torch.from_numpy(bias)})
    np.testing.assert_allclose(
        lin(torch.from_numpy(x)).numpy(),
        np.asarray(apply_linear(dict(ref, bias=jnp.asarray(bias)),
                                jnp.asarray(x))), atol=ATOL)


def test_tree_quantize_fp_mode(w):
    from mlx_audio_tpu.ops.quant import maybe_quantize_tree as jax_tree
    from mlx_audio_tpu_torch.ops.quant import maybe_quantize_tree

    t = torch.from_numpy(w)
    out = maybe_quantize_tree({"proj": {"weight": t},
                               "embed_tokens": {"weight": t}}, mode="mxfp4")
    ref = jax_tree({"proj": {"weight": jnp.asarray(w)},
                    "embed_tokens": {"weight": jnp.asarray(w)}},
                   mode="mxfp4")
    assert set(out["proj"]) == set(ref["proj"]) == {"w_fp4", "scales"}
    assert "weight" in out["embed_tokens"]      # embeddings skipped
    np.testing.assert_array_equal(out["proj"]["w_fp4"].numpy(),
                                  np.asarray(ref["proj"]["w_fp4"]))


PATHS = ["model.embed_tokens.weight", "lm_head.weight",
         "model.layers.0.self_attn.o_proj.weight",
         "model.layers.5.mlp.down_proj.weight",
         "model.layers.11.self_attn.out_proj.weight",
         "model.layers.2.mlp.down_proj.weight",
         "model.layers.1.self_attn.q_proj.weight", "codec_head.weight",
         "decoder.conv.weight"]


@pytest.mark.parametrize("recipe", ["mixed_2_6", "mixed_3_4", "mixed_3_6",
                                    "mixed_4_6"])
def test_mixed_recipes_equal_jax(recipe):
    from mlx_audio_tpu.ops.quant import mixed_quant_predicate as jax_pred
    from mlx_audio_tpu_torch.ops.quant import mixed_quant_predicate

    pred, ref = mixed_quant_predicate(recipe), jax_pred(recipe)
    assert [pred(p, None) for p in PATHS] == [ref(p, None) for p in PATHS]


def test_unknown_recipe_raises():
    from mlx_audio_tpu_torch.ops.quant import mixed_quant_predicate

    with pytest.raises(ValueError, match="unknown quant recipe"):
        mixed_quant_predicate("mixed_x")


def test_tree_mixed_bits_equal_jax(w):
    """An int from the predicate sets one layer's width: 2-bit codes stay
    in [0, 3], 6-bit ones go past; both equal JAX's."""
    from mlx_audio_tpu.ops.quant import maybe_quantize_tree as jax_tree
    from mlx_audio_tpu.ops.quant import mixed_quant_predicate as jax_pred
    from mlx_audio_tpu_torch.ops.quant import (maybe_quantize_tree,
                                               mixed_quant_predicate)

    def tree(x):
        return {"layers": {"1": {"q_proj": {"weight": x}},
                           "5": {"down_proj": {"weight": x}}}}

    out = maybe_quantize_tree(tree(torch.from_numpy(w)), group_size=32,
                              predicate=mixed_quant_predicate("mixed_2_6"))
    ref = jax_tree(tree(jnp.asarray(w)), group_size=32,
                   predicate=jax_pred("mixed_2_6"))
    low = out["layers"]["1"]["q_proj"]["w_q"].numpy()
    high = out["layers"]["5"]["down_proj"]["w_q"].numpy()
    assert low.max() <= 3 and high.max() > 3
    np.testing.assert_array_equal(low,
                                  np.asarray(ref["layers"]["1"]["q_proj"]
                                             ["w_q"]))
    np.testing.assert_array_equal(high,
                                  np.asarray(ref["layers"]["5"]["down_proj"]
                                             ["w_q"]))


LLAMA = dict(model_type="llama", hidden_size=64, num_hidden_layers=2,
             intermediate_size=128, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, vocab_size=128)


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    """A tiny llama (Orpheus) directory in the JAX tree's layout, marked
    converted, as tests/test_fp_quant.py writes it; and its dense model."""
    from safetensors.numpy import save_file

    from mlx_audio_tpu_torch.tts.models.llama import Model, ModelConfig

    d = tmp_path_factory.mktemp("llama-src")
    m = Model(ModelConfig.from_dict(LLAMA), device="cpu").init_params(0)
    save_file({k: v.numpy() for k, v in m.state_dict().items()},
              str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(dict(
        LLAMA, converted_by="mlx_audio_tpu.convert")))
    return d, m


@pytest.mark.parametrize("mode", MODES)
def test_convert_quantize_reload(llama_dir, mode, tmp_path):
    from mlx_audio_tpu_torch.convert import convert
    from mlx_audio_tpu_torch.nn import FpQuantizedLinear
    from mlx_audio_tpu_torch.tts.models.llama import (llama_forward,
                                                      logits_from_hidden)
    from mlx_audio_tpu_torch.tts.utils import load_model

    src, m = llama_dir
    out = convert(str(src), mlx_path=str(tmp_path / mode), dtype="float32",
                  quantize=True, q_mode=mode, domain="tts", device="cpu")
    assert json.loads((out / "config.json").read_text())[
        "quantization"]["mode"] == mode
    m2 = load_model(out, device="cpu")
    n_fp = sum(isinstance(x, FpQuantizedLinear) for x in m2.modules())
    assert n_fp == 7 * LLAMA["num_hidden_layers"] + 1
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 128, (1, 8)))
    ref = logits_from_hidden(m, llama_forward(m, toks)[0]).numpy()
    got = logits_from_hidden(m2, llama_forward(m2, toks)[0]).numpy()
    assert np.isfinite(got).all()
    tol = 0.15 if mode == "mxfp8" else 1.5
    assert np.abs(got - ref).mean() < tol


def test_apply_quantization_reads_the_mode():
    """The port's `apply_quantization` takes the quantization dict's `mode`
    (the JAX package's ignores it and quantizes affine; a directory its CLI
    converts is bound as written, so both load those alike): an nvfp4
    config makes FpQuantizedLinears with JAX's codes."""
    from mlx_audio_tpu.ops.quant import quantize_weight_fp as jax_q
    from mlx_audio_tpu_torch.nn import FpQuantizedLinear, Linear
    from mlx_audio_tpu_torch.utils import apply_quantization

    model = torch.nn.Module()
    model.proj = Linear(128, 16, bias=False)
    w = np.random.RandomState(5).randn(16, 128).astype(np.float32)
    with torch.no_grad():
        model.proj.weight.copy_(torch.from_numpy(w))
    apply_quantization(model, {"quantization": {"mode": "nvfp4",
                                                "group_size": 64}})
    assert isinstance(model.proj, FpQuantizedLinear)
    np.testing.assert_array_equal(model.proj.w_fp4.numpy(),
                                  np.asarray(jax_q(jnp.asarray(w),
                                                   "nvfp4")["w_fp4"]))
