"""The port's affine quantization (ops/quant.py, nn QuantizedLinear,
utils.apply_quantization) and its W8A8 layout (to_i8_layout, qmatmul_i8,
tree_to_i8_layout, nn Int8Linear, the mxu_int8 opt-in) against the JAX
package's, the arithmetic K2's
tensor-core path rests on (the per-group factored sum, codes exact in
bf16) and its dispatch rule, and kernel K2 (csrc/qmm.cu, each of its
paths) against its plain version where a GPU is present.

On the CPU the quantized linear takes K2's plain version
(`qmatmul_reference`); it is held to the JAX `qmatmul` and to
x @ dequantize_weight(q).T, the plain reference the JAX package's own K2
test uses (tests/test_llama_backbone.py:193-202). Tolerance: both sides in
f32, summation order only, 1e-5 relative. Codes, scales and biases must be
exactly JAX's.

JAX is imported inside the tests that use it, so on a GPU machine without
JAX the CUDA tests (marker `requires_cuda`, skipped without a GPU) run
alone: `python -m pytest --noconftest -m requires_cuda
tests/test_torch_quant.py`.
Their tolerances are chip_smoke.py's: 1e-4 relative in f32 (summation
order), 1e-2 in bf16 (the output rounds to 8 mantissa bits). W8A8: codes
equal, weight scales within 1e-7 relative, qmatmul_i8 within 1e-6 (the
int32 product is exact; the two f32 scale products round alike), and on
the card `torch._int_mm` equal to the exact plain product.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def _w(shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 0.05).astype(np.float32)


@pytest.mark.parametrize("bits,gs", [(8, 64), (4, 64), (8, 16), (4, 32)])
def test_quantize_weight_equals_jax(bits, gs):
    import jax.numpy as jnp

    from mlx_audio_tpu.ops.quant import quantize_weight as jq
    from mlx_audio_tpu_torch.ops.quant import quantize_weight

    w = _w((96, 256), bits)
    want = jq(jnp.asarray(w), group_size=gs, bits=bits)
    got = quantize_weight(torch.from_numpy(w), group_size=gs, bits=bits)
    assert got["w_q"].dtype == torch.uint8
    assert int(got["w_q"].max()) <= (1 << bits) - 1
    for k in ("w_q", "scales", "biases"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_dequantize_weight_matches_jax_stacked():
    import jax.numpy as jnp

    from mlx_audio_tpu.ops.quant import dequantize_weight as jdq
    from mlx_audio_tpu.ops.quant import quantize_weight as jq
    from mlx_audio_tpu_torch.ops.quant import dequantize_weight

    layers = [jq(jnp.asarray(_w((32, 64), i)), 16, 8) for i in range(3)]
    stacked = {k: jnp.stack([p[k] for p in layers]) for k in layers[0]}
    want = jdq(stacked)
    got = dequantize_weight({k: torch.from_numpy(np.array(v))
                             for k, v in stacked.items()})
    assert got.shape == (3, 32, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("bits,bias,lead", [(8, False, (1,)), (8, True, (2, 5)),
                                            (4, True, (7,))])
def test_qmatmul_reference_matches_jax(bits, bias, lead):
    import jax.numpy as jnp

    from mlx_audio_tpu.ops.quant import qmatmul as jqmm
    from mlx_audio_tpu.ops.quant import quantize_weight as jq
    from mlx_audio_tpu_torch.ops.quant import (dequantize_weight, qmatmul,
                                               qmatmul_reference)

    q = jq(jnp.asarray(_w((48, 128), 3)), group_size=64, bits=bits)
    if bias:
        q["bias"] = jnp.asarray(_w((48,), 4))
    x = np.random.RandomState(5).randn(*lead, 128).astype(np.float32)
    want = np.asarray(jqmm(q, jnp.asarray(x)))
    t = {k: torch.from_numpy(np.array(v)) for k, v in q.items()}
    xt = torch.from_numpy(x)
    got = qmatmul_reference(xt, t["w_q"], t["scales"], t["biases"],
                            t.get("bias"))
    assert got.shape == lead + (48,) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= REL
    dense = xt @ dequantize_weight(t).T + (t["bias"] if bias else 0)
    assert _rel(got.numpy(), dense.numpy()) <= REL
    # the dispatcher takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        qmatmul(xt, t["w_q"], t["scales"], t["biases"], t.get("bias")).numpy(),
        got.numpy())


def test_qmatmul_reference_rounds_once_to_bf16():
    from mlx_audio_tpu_torch.ops.quant import (dequantize_weight,
                                               qmatmul_reference,
                                               quantize_weight)

    q = quantize_weight(torch.from_numpy(_w((64, 128), 6)), 64, 8)
    x = torch.from_numpy(np.random.RandomState(7).randn(3, 128)
                         .astype(np.float32)).to(torch.bfloat16)
    got = qmatmul_reference(x, q["w_q"], q["scales"], q["biases"])
    want = (x.float() @ dequantize_weight(q).T).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("bits", [8, 4])
def test_per_group_factored_form_equals_reference(bits, gs, bias):
    """The sum K2's tensor-core path takes, per group g of gs columns:
    y = sum_g s[n,g] * (x . q)_g + sum_g b[n,g] * (sum of x)_g [+ bias],
    with its k order permuted inside each 16-column step as the kernel
    permutes it (columns 4t..4t+3 in fragment order 2t, 2t+1, 2t+8, 2t+9),
    equals qmatmul_reference in f32."""
    from mlx_audio_tpu_torch.ops.quant import qmatmul_reference, quantize_weight

    n, k = 48, 256
    q = quantize_weight(torch.from_numpy(_w((n, k), bits + gs)), gs, bits)
    b = torch.from_numpy(_w((n,), 15)) if bias else None
    x = torch.from_numpy(np.random.RandomState(16).randn(5, k)
                         .astype(np.float32))
    frag = np.array([4 * t + j for t in range(4) for j in range(4)])
    perm = torch.from_numpy((np.arange(k // 16)[:, None] * 16
                             + frag[None]).reshape(-1))
    xp, qp = x[:, perm], q["w_q"][:, perm].float()
    ng = k // gs
    xq = torch.einsum("mgk,ngk->mng", xp.reshape(5, ng, gs),
                      qp.reshape(n, ng, gs))
    xsum = xp.reshape(5, ng, gs).sum(-1)
    y = (xq * q["scales"]).sum(-1) + xsum @ q["biases"].T
    if bias:
        y = y + b
    want = qmatmul_reference(x, q["w_q"], q["scales"], q["biases"], b)
    assert _rel(y.numpy(), want.numpy()) <= REL


def test_codes_are_exact_in_bf16():
    """Every 8-bit code (so every 4-bit one) survives bf16 exactly, and the
    kernels' conversion (the bytes into 0x4b0000cc = 2^23 + c, minus 2^23)
    gives the code as an exact f32."""
    codes = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(codes.to(torch.bfloat16).to(torch.uint8), codes)
    assert torch.equal(codes.float().to(torch.bfloat16).float(),
                       codes.float())
    magic = (np.uint32(0x4B000000) | np.arange(256, dtype=np.uint32))
    got = magic.view(np.float32) - np.float32(2 ** 23)
    np.testing.assert_array_equal(got, np.arange(256, dtype=np.float32))


def test_dispatch_rule_and_tuning():
    """choose_path is a static rule on (dtype, M, group size); the gemv's
    warps per row and the mma path's K ranges are valid for every linear
    shape of the Qwen3-TTS slice."""
    from mlx_audio_tpu_torch.ops.qmm import (MMA_MIN_ROWS, choose_path,
                                             gemv_ksplit, mma_splits)

    f32, bf16 = torch.float32, torch.bfloat16
    assert choose_path(f32, 1, 64) == choose_path(bf16, 1, 32) == "gemv"
    assert choose_path(bf16, MMA_MIN_ROWS, 64) == "mma"
    assert choose_path(bf16, 120, 16) == choose_path(bf16, 16, 128) == "mma"
    assert choose_path(f32, 64, 64) == choose_path(f32, 2, 64) == "simt"
    assert choose_path(bf16, 1, 8) == choose_path(bf16, 16, 48) == "simt"
    shapes = [(2048, 1024), (1024, 1024), (1024, 2048), (3072, 1024),
              (1024, 3072), (2048, 2048), (96, 32)]
    for n, k in shapes:
        assert gemv_ksplit(n, k) in (1, 2, 4, 8)
        for gs in (16, 32, 64, 128):
            if k % gs:
                continue
            units = -(-k // max(gs, 64))
            for m in (2, 16, 64, 120, 4096):
                s = mma_splits(m, n, k, gs)
                per = -(-units // s)
                assert 1 <= s <= units and per * (s - 1) < units


def _tree(seed=0):
    return {
        "blk": {"q_proj": {"weight": _w((32, 64), seed)},
                "o_proj": {"weight": _w((64, 32), seed + 1),
                           "bias": _w((64,), seed + 2)},
                "norm": {"weight": np.ones(64, np.float32)}},
        "stack": {"up_proj": {"weight": _w((3, 48, 64), seed + 3)}},
        "embed_tokens": {"weight": _w((100, 64), seed + 4)},
        "odd": {"weight": _w((8, 40), seed + 5)},
    }


def _flat(tree, cast):
    from mlx_audio_tpu.utils import flatten

    return {k: cast(v) for k, v in flatten(tree).items()}


@pytest.mark.parametrize("predicate", ["none", "explicit", "int_bits"])
def test_maybe_quantize_tree_matches_jax(predicate):
    """Same leaves quantized to the same codes: 2-D linears, 3-D stacked
    leaves only under an explicit predicate, an int verdict overriding the
    width, embeddings and widths not divisible by the group left dense."""
    import jax.numpy as jnp

    from mlx_audio_tpu.ops.quant import maybe_quantize_tree as jmq
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.ops.quant import maybe_quantize_tree

    pred = {"none": None,
            "explicit": lambda p, w: "norm" not in p,
            "int_bits": lambda p, w: 4 if p.endswith("up_proj") else True
            }[predicate]
    tree = _tree()
    want = _flat(jmq(unflatten(_flat(tree, jnp.asarray)), 16, 8, pred),
                 np.asarray)
    got = _flat(maybe_quantize_tree(
        unflatten(_flat(tree, torch.from_numpy)), 16, 8, pred),
        lambda t: t.numpy())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ("stack.up_proj.w_q" in got) == (predicate != "none")
    assert "embed_tokens.weight" in got and "odd.weight" in got


def test_quantized_linear_cpu_takes_plain_version():
    from mlx_audio_tpu_torch.nn import Linear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.quant import qmatmul_reference
    from mlx_audio_tpu_torch.utils import apply_quantization

    holder = torch.nn.Module()
    holder.fc = Linear(128, 32, bias=True)
    holder.fc.weight.data = torch.from_numpy(_w((32, 128), 8))
    holder.fc.bias.data = torch.from_numpy(_w((32,), 9))
    apply_quantization(holder, {"quantization": {"bits": 8,
                                                 "group_size": 64}})
    q = holder.fc
    assert type(q).__name__ == "QuantizedLinear"
    assert q.w_q.dtype == torch.uint8 and q.scales.dtype == torch.float32
    assert q.bias.dtype == torch.float32
    assert not any(n in dict(q.named_parameters())
                   for n in ("w_q", "scales", "bias"))
    x = torch.from_numpy(np.random.RandomState(10).randn(4, 128)
                         .astype(np.float32))
    before = qmm_kernel.launches
    with torch.no_grad():
        y = q(x)
        want = qmatmul_reference(x, q.w_q, q.scales, q.biases, q.bias)
    assert qmm_kernel.launches == before
    np.testing.assert_array_equal(y.numpy(), want.numpy())
    with pytest.raises(ValueError, match="CUDA"):
        qmm_kernel(x, q.w_q, q.scales, q.biases)


def test_apply_quantization_options():
    from mlx_audio_tpu_torch.nn import Int8Linear, Linear, QuantizedLinear
    from mlx_audio_tpu_torch.utils import apply_quantization

    def holder():
        h = torch.nn.Module()
        h.a_proj = Linear(64, 16, bias=False)
        h.b_proj = Linear(64, 16, bias=False)
        h.c = Linear(40, 16, bias=False)       # 40 % 16 != 0: stays dense
        for m in (h.a_proj, h.b_proj, h.c):
            m.weight.data.normal_()
        return h

    h = holder()
    assert apply_quantization(h, {}) is h and isinstance(h.a_proj, Linear)
    apply_quantization(h, {"quantization": {"bits": 4, "group_size": 16,
                                            "b_proj": False}})
    assert isinstance(h.a_proj, QuantizedLinear)
    assert int(h.a_proj.w_q.max()) <= 15
    assert isinstance(h.b_proj, Linear) and isinstance(h.c, Linear)
    h = holder()
    apply_quantization(h, {"quantization": {"bits": 8, "group_size": 16}},
                       lambda path, w: path.startswith("b"))
    assert isinstance(h.a_proj, Linear)
    assert isinstance(h.b_proj, QuantizedLinear)
    # the W8A8 opt-in: bits 8 with mxu_int8 gives Int8Linear, and a name
    # the i8 predicate refuses stays on the affine per-group path
    h = apply_quantization(holder(), {"quantization": {
        "bits": 8, "group_size": 16, "mxu_int8": True}},
        i8_predicate=lambda path: path != "b_proj")
    assert isinstance(h.a_proj, Int8Linear)
    assert isinstance(h.b_proj, QuantizedLinear)
    assert isinstance(h.c, Linear)


# ---------------------------------------------------------------------------
# W8A8 (qmatmul_i8)
# ---------------------------------------------------------------------------


def _affine(shape, gs, bias=False, seed=20):
    """(torch affine 8-bit params, the same as a JAX dict)."""
    import jax.numpy as jnp

    from mlx_audio_tpu_torch.ops.quant import quantize_weight

    q = quantize_weight(torch.from_numpy(_w(shape, seed)).reshape(
        -1, shape[-1]), gs, 8)
    q = {k: v.reshape(shape[:-1] + v.shape[1:]) for k, v in q.items()}
    if bias:
        q["bias"] = torch.from_numpy(_w(shape[:-1], seed + 1))
    return q, {k: jnp.asarray(v.numpy()) for k, v in q.items()}


@pytest.mark.parametrize("shape,gs,bias", [((48, 128), 64, False),
                                           ((40, 64), 16, True),
                                           ((3, 16, 64), 32, False)])
def test_to_i8_layout_equals_jax(shape, gs, bias):
    """Per-channel symmetric codes equal and scales within 1e-7; a stacked
    (L, out, in) leaf converts layer by layer; other keys pass through."""
    from mlx_audio_tpu.ops.quant import to_i8_layout as jto
    from mlx_audio_tpu_torch.ops.quant import to_i8_layout

    q, jq = _affine(shape, gs, bias)
    want = jto(jq)
    got = to_i8_layout(q)
    assert set(got) == set(want)
    assert got["w_i8"].dtype == torch.int8 and got["scale"].dtype == \
        torch.float32
    np.testing.assert_array_equal(got["w_i8"].numpy(),
                                  np.asarray(want["w_i8"]))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]),
                               rtol=1e-7)
    assert int(got["w_i8"].abs().max()) == 127


def test_activation_quantization_rounds_half_to_even():
    """The per-token scale and round are JAX's: ties go to even, the clip
    is +-127, and a zero row keeps the 1e-12 floor."""
    import jax.numpy as jnp

    from mlx_audio_tpu_torch.ops.quant import quantize_activation_i8

    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 126.5, -127.0],
                  [0.0] * 8, [1e-3, -2e-3, 5e-4, 0, 0, 0, 0, 7e-4]],
                 np.float32)
    xq, sx = quantize_activation_i8(torch.from_numpy(x))
    xf = jnp.asarray(x)
    jsx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0,
                      1e-12)
    jq = jnp.clip(jnp.round(xf / jsx), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    assert xq[0].tolist() == [127, 0, 2, 2, 0, -4, 126, -127]


@pytest.mark.parametrize("lead,bias,dtype", [((5,), False, "float32"),
                                             ((2, 3), True, "float32"),
                                             ((1,), False, "bfloat16")])
def test_qmatmul_i8_equals_jax(lead, bias, dtype):
    import jax.numpy as jnp

    from mlx_audio_tpu.ops.quant import qmatmul_i8 as jmm
    from mlx_audio_tpu.ops.quant import to_i8_layout as jto
    from mlx_audio_tpu_torch.ops.quant import (int_mm, int_mm_reference,
                                               qmatmul_i8, to_i8_layout)

    q, jq = _affine((96, 128), 64, bias)
    p8 = to_i8_layout(q)
    x = np.random.RandomState(21).randn(*lead, 128).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jmm(jto(jq), jnp.asarray(xt.float().numpy()).astype(dtype))
    got = qmatmul_i8(xt, p8["w_i8"], p8["scale"], p8.get("bias"))
    assert got.dtype == xt.dtype and got.shape == lead + (96,)
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= (
        1e-6 if dtype == "float32" else 8e-3)
    xq = torch.randint(-127, 128, (7, 128), dtype=torch.int8)
    exact = xq.numpy().astype(np.int64) @ p8["w_i8"].numpy().astype(
        np.int64).T
    np.testing.assert_array_equal(int_mm(xq, p8["w_i8"]).numpy(), exact)
    assert int_mm_reference(xq, p8["w_i8"]).dtype == torch.int32


def test_tree_to_i8_layout_equals_jax():
    """Every affine leaf the predicate passes converts; the rest (a refused
    quantized leaf, a dense one) stay as they were."""
    from mlx_audio_tpu.ops.quant import tree_to_i8_layout as jtree
    from mlx_audio_tpu_torch.ops.quant import tree_to_i8_layout

    a, ja = _affine((32, 64), 16, seed=22)
    b, jb = _affine((32, 64), 16, True, seed=23)
    dense = torch.from_numpy(_w((8, 8), 24))
    tree = {"layers": {"0": {"q_proj": a, "head": b}},
            "norm": {"weight": dense}}
    jtree_in = {"layers": {"0": {"q_proj": ja, "head": jb}},
                "norm": {"weight": dense.numpy()}}
    keep = lambda path: not path.endswith("head")  # noqa: E731
    want = jtree(jtree_in, predicate=keep)
    got = tree_to_i8_layout(tree, predicate=keep)
    assert set(got["layers"]["0"]["q_proj"]) == {"w_i8", "scale"}
    np.testing.assert_array_equal(got["layers"]["0"]["q_proj"]["w_i8"],
                                  np.asarray(want["layers"]["0"]["q_proj"]
                                             ["w_i8"]))
    assert got["layers"]["0"]["head"] is b
    assert set(want["layers"]["0"]["head"]) == set(b)
    assert got["norm"]["weight"] is dense


@pytest.mark.parametrize("opt_in", ["config", "env", "config-off", "bits4"])
def test_apply_quantization_w8a8_opt_in(monkeypatch, opt_in):
    """mxu_int8 from the quantization dict, else MLX_AUDIO_TPU_MXU_INT8 (as
    the JAX package reads them); only with bits 8. The Int8Linear's output
    equals the JAX package's apply_linear on its apply_quantization tree."""
    import jax.numpy as jnp

    from mlx_audio_tpu.nn import apply_linear
    from mlx_audio_tpu.utils import apply_quantization as japply
    from mlx_audio_tpu_torch.nn import Int8Linear, Linear, QuantizedLinear
    from mlx_audio_tpu_torch.utils import apply_quantization

    h = torch.nn.Module()
    h.proj = Linear(64, 24, bias=True).requires_grad_(False)
    h.proj.weight.copy_(torch.from_numpy(_w((24, 64), 25)))
    h.proj.bias.copy_(torch.from_numpy(_w((24,), 26)))
    jparams = {"proj": {"weight": jnp.asarray(_w((24, 64), 25)),
                        "bias": jnp.asarray(_w((24,), 26))}}
    quant = {"bits": 4 if opt_in == "bits4" else 8, "group_size": 16}
    if opt_in != "env":
        quant["mxu_int8"] = opt_in != "config-off"
    monkeypatch.setenv("MLX_AUDIO_TPU_MXU_INT8", "1" if opt_in in (
        "env", "config-off") else "")
    apply_quantization(h, {"quantization": quant})
    jp = japply(jparams, {"quantization": dict(quant)})
    want_i8 = opt_in in ("config", "env")
    assert isinstance(h.proj, Int8Linear if want_i8 else QuantizedLinear)
    assert ("w_i8" in jp["proj"]) == want_i8
    x = np.random.RandomState(27).randn(3, 64).astype(np.float32)
    want = np.asarray(apply_linear(jp["proj"], jnp.asarray(x)))
    assert _rel(h.proj(torch.from_numpy(x)).numpy(), want) <= 1e-5


def test_int8_linear_from_jax_tree_takes_plain_version_on_cpu():
    """load_jax_params makes an Int8Linear of a {w_i8, scale, bias} leaf; on
    the CPU its forward is qmatmul_i8_reference, bit for bit."""
    from mlx_audio_tpu.ops.quant import to_i8_layout as jto
    from mlx_audio_tpu_torch.model import TorchModel, load_jax_params
    from mlx_audio_tpu_torch.nn import Int8Linear, Linear
    from mlx_audio_tpu_torch.ops.quant import qmatmul_i8_reference

    _, jq = _affine((32, 64), 16, True, seed=28)
    m = TorchModel(None)
    m.proj = Linear(64, 32, bias=True)
    load_jax_params(m, {f"proj.{k}": np.asarray(v)
                        for k, v in jto(jq).items()})
    assert isinstance(m.proj, Int8Linear)
    x = torch.from_numpy(np.random.RandomState(29).randn(4, 64)
                         .astype(np.float32))
    np.testing.assert_array_equal(
        m.proj(x).numpy(), qmatmul_i8_reference(
            x, m.proj.w_i8, m.proj.scale, m.proj.bias).numpy())


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _kernel_case(m, n, bits, bias, gs, dtype, path=None):
    """K2 (by `path`, default the dispatched one) and its plain version on
    one seeded input, K = 1024 -> (got, want); one launch counted."""
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.quant import qmatmul_reference, quantize_weight

    q = {k: v.cuda() for k, v in quantize_weight(
        torch.from_numpy(_w((n, 1024), 11)), gs, bits).items()}
    b = torch.from_numpy(_w((n,), 12)).cuda() if bias else None
    x = torch.from_numpy(np.random.RandomState(13).randn(m, 1024)
                         .astype(np.float32)).cuda().to(getattr(torch, dtype))
    before = qmm_kernel.launches
    got = qmm_kernel(x, q["w_q"], q["scales"], q["biases"], b, path=path)
    want = qmatmul_reference(x, q["w_q"], q["scales"], q["biases"], b)
    torch.cuda.synchronize()
    assert qmm_kernel.launches == before + 1
    assert got.dtype == x.dtype and got.shape == (m, n)
    return got, want


def _rel_cuda(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("m,bits,bias,n,gs", [
    (1, 8, False, 3072, 64), (5, 4, True, 3072, 64), (64, 8, True, 3072, 64),
    (2, 8, False, 3072, 64), (16, 4, True, 3072, 64), (17, 8, False, 1000, 64),
    (120, 8, True, 2048, 32), (130, 4, False, 1000, 32), (1, 4, True, 1000, 32)])
def test_kernel_matches_reference_on_cuda(dtype, tol, m, bits, bias, n, gs):
    """K2's dispatched path against its plain version at talker-like shapes
    (K = 1024), ragged N (1000) and group 32 among them, relative error
    max|a-b|/max|b|; one launch counted per call."""
    _cuda()
    got, want = _kernel_case(m, n, bits, bias, gs, dtype)
    assert _rel_cuda(got, want) <= tol


@pytest.mark.requires_cuda
@pytest.mark.parametrize("path,dtype,m", [
    ("gemv", "float32", 1), ("gemv", "bfloat16", 1), ("mma", "bfloat16", 1),
    ("mma", "bfloat16", 2), ("mma", "bfloat16", 130), ("simt", "float32", 17),
    ("simt", "bfloat16", 1), ("simt", "bfloat16", 120)])
def test_each_path_matches_reference_on_cuda(path, dtype, m):
    """Every path of K2, named explicitly, at a ragged N and group 32."""
    _cuda()
    got, want = _kernel_case(m, 1000, 8, True, 32, dtype, path)
    assert _rel_cuda(got, want) <= {"float32": 1e-4, "bfloat16": 1e-2}[dtype]


@pytest.mark.requires_cuda
def test_kernel_refuses_what_it_does_not_take():
    _cuda()
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.quant import quantize_weight

    q = {k: v.cuda() for k, v in quantize_weight(
        torch.from_numpy(_w((64, 128), 14)), 64, 8).items()}
    x = torch.ones(2, 128, device="cuda")
    with pytest.raises(ValueError, match="empty"):
        qmm_kernel(x[:0], q["w_q"], q["scales"], q["biases"])
    with pytest.raises(TypeError):
        qmm_kernel(x.half(), q["w_q"], q["scales"], q["biases"])
    with pytest.raises(ValueError):
        qmm_kernel(x[:, :64], q["w_q"], q["scales"], q["biases"])
    with pytest.raises(TypeError):
        qmm_kernel(x, q["w_q"], q["scales"].double(), q["biases"])
    with pytest.raises(ValueError, match="gemv path takes M = 1"):
        qmm_kernel(x, q["w_q"], q["scales"], q["biases"], path="gemv")
    with pytest.raises(TypeError, match="bfloat16"):
        qmm_kernel(x, q["w_q"], q["scales"], q["biases"], path="mma")
    with pytest.raises(ValueError, match="unknown"):
        qmm_kernel(x, q["w_q"], q["scales"], q["biases"], path="wgmma")


# the four W8A8 linear shapes (out, in) of a Higgs v2 layer at its published
# dims: q and o; k and v; gate and up; down
HIGGS_I8_SHAPES = [(3072, 3072), (1024, 3072), (8192, 3072), (3072, 8192)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m", [1, 17, 512])
@pytest.mark.parametrize("n,k", HIGGS_I8_SHAPES)
def test_int_mm_matches_reference_on_cuda(m, n, k):
    """torch._int_mm (rows padded where it refuses few) against the plain
    product (exact in float64), and qmatmul_i8 on the card against its
    plain version."""
    _cuda()
    from mlx_audio_tpu_torch.ops.quant import (int_mm, int_mm_reference,
                                               qmatmul_i8,
                                               qmatmul_i8_reference)

    g = torch.Generator(device="cuda").manual_seed(m + n + k)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device="cuda",
                      generator=g)
    xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda",
                       generator=g)
    got = int_mm(xq, w)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, int_mm_reference(xq, w))
    scale = torch.rand(n, device="cuda", generator=g) * 1e-3
    x = torch.randn(m, k, device="cuda", generator=g)
    y = qmatmul_i8(x, w, scale)
    assert _rel_cuda(y, qmatmul_i8_reference(x, w, scale)) <= 1e-5
