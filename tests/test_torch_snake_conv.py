"""The port of the fused AdaIN -> Snake -> dilated-conv1d Pallas kernel.

On the CPU the port's plain PyTorch version (`adain_snake_conv1d_reference`)
is held to the JAX Pallas kernel run in interpret mode, as
tests/test_snake_conv_pallas.py runs it, and the port's generator block
(`AdaINResBlock1`) to the JAX block on its fused (interpret) and unfused
branches. The host side of the kernel (the dispatch rule, the wgmma
path's weight packing, and its remaking when the weights change) is
checked on the CPU. The CUDA kernel itself is compared with the plain
version only where a GPU is present (marker `requires_cuda`): each path,
and wgmma at all 18 (C, k, dil) of the generator, forced and dispatched;
chip_smoke.py does the same at the main path's full shapes. JAX is imported
inside the tests that use it, so on a GPU machine without JAX the CUDA
tests run alone:
`python -m pytest --noconftest -m requires_cuda tests/test_torch_snake_conv.py`.

Tolerances: f32 2e-4 (summation order only; the values are O(1), as in
tests/test_snake_conv_pallas.py:125); bf16 0.05 (h and the output round to
8 mantissa bits; the precedent of tests/test_snake_conv_pallas.py:143-145);
on the card, relative error max|a-b|/max|b| as chip_smoke.py: f32 1e-4,
bf16 1e-2.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
# torch's fp32 precision settings that a CPU conv or matmul reads
_MKLDNN_FP32 = ("matmul", "conv")


# torch's fp32 precision parents, read where a child is left at "none"
_TORCH_FP32_PARENTS = ("backends", "backends.mkldnn")


def _torch_attr(path):
    obj = torch
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


@contextlib.contextmanager
def full_f32():
    """Both sides of an f32 comparison at full f32, restored on exit: JAX's
    default matmul precision "highest" (a dot left at DEFAULT may be lowered
    with a shorter mantissa), JAX's persistent compile cache off (an
    executable in it may have been compiled by another process on another
    host, with other machine features; inside this scope every program is
    compiled here), torch's float32 matmul precision "highest" and oneDNN's
    fp32 precision "ieee" on the conv and matmul children and on their
    parents (`torch.backends`, `torch.backends.mkldnn`), where this torch
    has those settings."""
    import jax
    from jax._src import compilation_cache

    mk = torch.backends.mkldnn
    has = [op for op in _MKLDNN_FP32
           if hasattr(getattr(mk, op, None), "fp32_precision")]
    parents = [p for p in _TORCH_FP32_PARENTS
               if hasattr(_torch_attr(p), "fp32_precision")]
    prev = (torch.get_float32_matmul_precision(),
            [getattr(mk, op).fp32_precision for op in has],
            [_torch_attr(p).fp32_precision for p in parents],
            jax.config.jax_enable_compilation_cache)
    for p in parents:
        _torch_attr(p).fp32_precision = "ieee"
    torch.set_float32_matmul_precision("highest")
    for op in has:
        getattr(mk, op).fp32_precision = "ieee"
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()     # the cache reads the flag once
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        jax.config.update("jax_enable_compilation_cache", prev[3])
        compilation_cache.reset_cache()
        for p, value in zip(parents, prev[2]):
            _torch_attr(p).fp32_precision = value
        torch.set_float32_matmul_precision(prev[0])
        for op, value in zip(has, prev[1]):
            getattr(mk, op).fp32_precision = value


def _inputs(seed, b, t, c, k, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(b, t, c).astype(np.float32),
        scale=(rng.randn(b, c) * 0.5 + 1.0).astype(np.float32),
        shift=(rng.randn(b, c) * 0.1).astype(np.float32),
        alpha=(np.abs(rng.randn(c)) + 0.5).astype(np.float32),
        w=(rng.randn(k, c, c) / np.sqrt(k * c)).astype(np.float32),
        bias=(rng.randn(c) * 0.05).astype(np.float32),
    )


def _port_call(inp, dilation, vlen, dtype=None):
    from mlx_audio_tpu_torch.ops.snake_conv import adain_snake_conv1d_reference

    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    return adain_snake_conv1d_reference(
        t["x"].to(dtype or torch.float32), t["scale"], t["shift"], t["alpha"], t["w"],
        t["bias"], dilation=dilation,
        valid_len=None if vlen is None else torch.tensor(vlen))


def _jax_call(inp, dilation, vlen, dtype=None):
    import jax.numpy as jnp

    from mlx_audio_tpu.ops.snake_conv_pallas import adain_snake_conv1d

    j = {k: jnp.asarray(v) for k, v in inp.items()}
    return adain_snake_conv1d(
        j["x"].astype(dtype or jnp.float32), j["scale"], j["shift"],
        j["alpha"], j["w"], j["bias"], dilation=dilation,
        valid_len=None if vlen is None else jnp.asarray(vlen, jnp.int32),
        block_t=128, interpret=True)


def _f64_call(inp, dilation, vlen):
    """The same function in float64 numpy: snake(x*scale + shift), the rows
    at/after `valid_len` zeroed, the dilated taps, the bias, the rows
    zeroed again."""
    x = inp["x"].astype(np.float64)
    b, t, _ = x.shape
    k = inp["w"].shape[0]
    a = inp["alpha"].astype(np.float64)
    h = x * inp["scale"][:, None, :] + inp["shift"][:, None, :]
    h = h + np.sin(a * h) ** 2 / a
    keep = (np.arange(t)[None, :] < np.asarray(vlen)[:, None])[..., None]
    h = np.where(keep, h, 0.0)
    pad = (k - 1) // 2 * dilation
    hp = np.pad(h, ((0, 0), (pad, pad), (0, 0)))
    w = inp["w"].astype(np.float64)
    out = sum(hp[:, j * dilation:j * dilation + t, :] @ w[j] for j in range(k))
    return np.where(keep, out + inp["bias"], 0.0)


@pytest.mark.parametrize("k,dilation", [(3, 1), (3, 3), (7, 1), (7, 3)])
def test_reference_matches_pallas_f32(k, dilation):
    """B=2 with ragged valid lengths (one row full, one cut); both sides
    pinned to full f32 (`full_f32`), the JAX kernel compiled in this scope.
    The float64 computation runs first, on a copy of the inputs, and the
    inputs must come back from both calls unchanged. Each side is then held
    to the float64 result, so that a failure names the side that strays,
    then to the other; every message carries all three errors and that of
    a second call of the port's reference on the copy, so that a failure
    also says whether it repeats within the test."""
    from mlx_audio_tpu.ops.snake_conv_pallas import adain_snake_conv1d

    inp = _inputs(4, 2, 300, 128, k)
    pristine = {name: v.copy() for name, v in inp.items()}
    vlen = [300, 170]
    exact = _f64_call(pristine, dilation, vlen)
    adain_snake_conv1d.clear_cache()    # no executable from an earlier file
    with full_f32():
        got = _port_call(inp, dilation, vlen).numpy()
        want = np.asarray(_jax_call(inp, dilation, vlen))
        again = _port_call(pristine, dilation, vlen).numpy()
    changed = sorted(n for n in inp if not np.array_equal(inp[n],
                                                          pristine[n]))
    report = (f"; max |port - f64| {np.abs(got - exact).max():.3e}, "
              f"|JAX - f64| {np.abs(want - exact).max():.3e}, "
              f"|port - JAX| {np.abs(got - want).max():.3e}, a second port "
              f"call |port - f64| {np.abs(again - exact).max():.3e}; inputs "
              f"changed by the calls: {changed or 'none'}")
    assert not changed, "the calls changed their inputs" + report
    np.testing.assert_allclose(got, exact, rtol=2e-4, atol=2e-4,
                               err_msg="the port's reference against float64"
                               + report)
    np.testing.assert_allclose(want, exact, rtol=2e-4, atol=2e-4,
                               err_msg="the JAX kernel against float64"
                               + report)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_full_f32_pins_and_restores_the_settings():
    """Inside `full_f32` JAX's and torch's f32 precision are the highest and
    JAX's persistent compile cache is off; on exit each setting is what it
    was, even one that a test left lowered (here torch's float32 matmul
    precision at "medium")."""
    import jax
    from jax._src import compilation_cache

    before = torch.get_float32_matmul_precision()
    jax_before = jax.config.jax_default_matmul_precision
    cache_before = jax.config.jax_enable_compilation_cache
    torch.set_float32_matmul_precision("medium")
    try:
        mk = torch.backends.mkldnn
        has = [op for op in _MKLDNN_FP32
               if hasattr(getattr(mk, op, None), "fp32_precision")]
        parents = [p for p in _TORCH_FP32_PARENTS
                   if hasattr(_torch_attr(p), "fp32_precision")]
        outer = [getattr(mk, op).fp32_precision for op in has]
        outer_parents = [_torch_attr(p).fp32_precision for p in parents]
        with full_f32():
            assert torch.get_float32_matmul_precision() == "highest"
            assert jax.config.jax_default_matmul_precision == "highest"
            assert all(getattr(mk, op).fp32_precision == "ieee"
                       for op in has)
            assert all(_torch_attr(p).fp32_precision == "ieee"
                       for p in parents)
            assert not jax.config.jax_enable_compilation_cache
            assert not compilation_cache.is_cache_used(
                jax.devices()[0].client)
        assert torch.get_float32_matmul_precision() == "medium"
        assert jax.config.jax_default_matmul_precision == jax_before
        assert jax.config.jax_enable_compilation_cache == cache_before
        assert [getattr(mk, op).fp32_precision for op in has] == outer
        assert [_torch_attr(p).fp32_precision for p in parents] == outer_parents
    finally:
        torch.set_float32_matmul_precision(before)


def test_reference_matches_pallas_bf16():
    import jax.numpy as jnp

    inp = _inputs(5, 2, 200, 128, 7)
    vlen = [200, 131]
    got = _port_call(inp, 1, vlen, torch.bfloat16)
    want = _jax_call(inp, 1, vlen, jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=0.05, atol=0.05)


def test_fold_adain_matches_jax():
    import jax.numpy as jnp

    from mlx_audio_tpu.ops.snake_conv_pallas import fold_adain as jfold
    from mlx_audio_tpu_torch.ops.snake_conv import fold_adain

    rng = np.random.RandomState(6)
    mean, gamma, beta = (rng.randn(2, 8).astype(np.float32) for _ in range(3))
    var = np.abs(rng.randn(2, 8)).astype(np.float32)
    want = jfold(*(jnp.asarray(a) for a in (mean, var, gamma, beta)))
    got = fold_adain(*(torch.from_numpy(a) for a in (mean, var, gamma, beta)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("jax_branch", ["fused_interpret", "unfused"])
def test_adain_res_block1_matches_jax(jax_branch):
    """The port's block (plain version on the CPU) against JAX's fused path
    in interpret mode and against its unfused XLA branch, B=2 ragged."""
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.tts.models.kokoro import istftnet as m
    from mlx_audio_tpu.utils import flatten
    from mlx_audio_tpu_torch.model import TorchModel, load_jax_params
    from mlx_audio_tpu_torch.tts.models.kokoro.istftnet import AdaINResBlock1

    c, style, kern = 128, 16, 3
    p = m.init_adain_res_block1(jax.random.PRNGKey(0), c, kern, [1, 3, 5], style)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 160, c).astype(np.float32)
    s = rng.randn(2, style).astype(np.float32)
    valid = np.arange(160)[None, :] < np.asarray([160, 120])[:, None]

    m._FORCE_FUSED_INTERPRET = jax_branch == "fused_interpret"
    try:
        want = m.adain_res_block1(p, jnp.asarray(x), jnp.asarray(s), kern,
                                  [1, 3, 5], jnp.asarray(valid))
    finally:
        m._FORCE_FUSED_INTERPRET = False

    holder = TorchModel(config=None)
    holder.blk = AdaINResBlock1(c, kern, [1, 3, 5], style).requires_grad_(False)
    load_jax_params(holder, {f"blk.{k}": np.asarray(v)
                             for k, v in flatten(p).items()})
    got = holder.blk(torch.from_numpy(x), torch.from_numpy(s),
                     torch.from_numpy(valid))
    # 2e-3 as tests/test_snake_conv_pallas.py:187: six legs of residual
    # accumulation, and the unfused branch normalises before the affine
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-3, atol=2e-3)


def test_cpu_dispatch_never_touches_the_kernel():
    """A CPU tensor takes the plain version; the kernel itself refuses CPU
    tensors rather than falling back."""
    from mlx_audio_tpu_torch.ops.snake_conv import (adain_snake_conv1d,
                                                    snake_conv_kernel)

    inp = {k: torch.from_numpy(v) for k, v in _inputs(8, 1, 40, 32, 3).items()}
    before = snake_conv_kernel.launches
    out = adain_snake_conv1d(inp["x"], inp["scale"], inp["shift"],
                             inp["alpha"], inp["w"], inp["bias"])
    assert out.shape == inp["x"].shape
    assert snake_conv_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        snake_conv_kernel(inp["x"], inp["scale"], inp["shift"], inp["alpha"],
                          inp["w"], inp["bias"])


@pytest.mark.parametrize("dtype,c,path", [
    (torch.float32, 256, "f32"), (torch.float32, 128, "f32"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 192, "wgmma"),
    (torch.bfloat16, 32, "wmma"), (torch.bfloat16, 96, "wmma"),
    (torch.bfloat16, 320, "wmma")])
def test_dispatch_rule(dtype, c, path):
    """f32 takes the CUDA-core kernel; bf16 takes wgmma at C a multiple of
    64 up to 256 (Kokoro's 256 and 128), the first design otherwise."""
    from mlx_audio_tpu_torch.ops.snake_conv import choose_path

    assert choose_path(dtype, c) == path


def test_pack_weight_round_trip():
    """pack_weight lays WIO w out as (C/64, k, 8, C, 8) tiles,
    packed[cc, j, q, o, e] = w[j, cc*64 + q*8 + e, o]; unpack_weight
    inverts it, and the other paths take w as it is."""
    from mlx_audio_tpu_torch.ops.snake_conv import (kernel_weight,
                                                    pack_weight,
                                                    unpack_weight)

    w = torch.from_numpy(np.random.RandomState(10).randn(3, 128, 128)
                         .astype(np.float32)).to(torch.bfloat16)
    packed = pack_weight(w)
    assert packed.shape == (2, 3, 8, 128, 8) and packed.is_contiguous()
    assert torch.equal(packed[1, 2, 3, 5], w[2, 64 + 24: 64 + 32, 5])
    assert torch.equal(unpack_weight(packed), w)
    assert torch.equal(kernel_weight(w, "wgmma"), packed)
    assert torch.equal(kernel_weight(w, "wmma"), w)
    with pytest.raises(ValueError):
        pack_weight(w[:, :96, :96])


def _tiny_kokoro(**istft):
    from mlx_audio_tpu_torch.tts.models.kokoro import Model, ModelConfig

    cfg = dict(resblock_kernel_sizes=[3, 7], upsample_rates=[2, 2],
               upsample_initial_channel=256,
               resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5]],
               upsample_kernel_sizes=[4, 4], gen_istft_n_fft=8,
               gen_istft_hop_size=2)
    cfg.update(istft)
    return Model(ModelConfig(
        istftnet=cfg, dim_in=16, hidden_dim=32, n_layer=1, n_mels=20,
        n_token=40, style_dim=16, decoder_bottleneck=24, decoder_res_dim=8,
        plbert=dict(num_hidden_layers=1, num_attention_heads=2,
                    hidden_size=24, intermediate_size=32,
                    max_position_embeddings=64, embedding_size=12),
        vocab={c: i + 1 for i, c in enumerate("abc ")}), device="cpu")


def _kernel_layouts_match(model):
    """Every leg's kernel operands unpack to its conv weight (WIO), alpha
    and bias; returns the number of legs laid out for wgmma."""
    from mlx_audio_tpu_torch.ops.snake_conv import unpack_weight
    from mlx_audio_tpu_torch.tts.models.kokoro.istftnet import AdaINResBlock1

    packed = 0
    for m in model.decoder.modules():
        if not isinstance(m, AdaINResBlock1):
            continue
        for i in range(len(m.dilations)):
            for leg, conv, alpha in ((2 * i, m.convs1[i], m.alpha1[i]),
                                     (2 * i + 1, m.convs2[i], m.alpha2[i])):
                kw, a32, b32 = m._kernel_ops[leg][1:]
                wio = conv.weight.permute(2, 1, 0)
                if kw.ndim == 5:
                    packed += 1
                    kw = unpack_weight(kw)
                assert kw.dtype == wio.dtype and torch.equal(kw, wio)
                assert a32.dtype == torch.float32
                assert torch.equal(a32, alpha.float())
                assert torch.equal(b32, conv.bias.float())
    return packed


def test_kernel_layout_is_made_at_bind_time():
    """init_params lays out each leg's operands once, in the layout of the
    path its dtype and width dispatch to, and the weight unpacks to
    conv.weight in WIO. Stage 0 runs C=128 and stage 1 C=64, both wgmma in
    bf16: 2 stages x 3 blocks x 3 dilations x 2 legs are packed."""
    model = _tiny_kokoro().init_params(seed=0)
    assert model.compute_dtype == torch.bfloat16
    assert _kernel_layouts_match(model) == 2 * 3 * 3 * 2


def test_kernel_layout_is_remade_when_weights_change():
    """bind() with new weights lays the kernel operands out again; an
    in-place change to one conv weight outside bind is caught on the
    leg's next CUDA call (_operands), not served stale."""
    from mlx_audio_tpu_torch.tts.models.kokoro.istftnet import AdaINResBlock1

    model = _tiny_kokoro(upsample_initial_channel=128).init_params(seed=0)
    _kernel_layouts_match(model)
    state = {k: v.float() + 0.5 if v.is_floating_point() else v
             for k, v in model.state_dict().items()}
    blk = next(m for m in model.decoder.modules()
               if isinstance(m, AdaINResBlock1))
    before = blk._kernel_ops[0][1].clone()
    model.bind(state)
    assert not torch.equal(blk._kernel_ops[0][1], before)
    _kernel_layouts_match(model)

    with torch.no_grad():
        blk.convs2[1].weight.mul_(2.0)
    stale = blk._kernel_ops[3][1]
    kw, _, _ = blk._operands(3, blk.convs2[1], blk.alpha2[1])
    assert not torch.equal(kw, stale)
    _kernel_layouts_match(model)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cuda_case(cuda, b, t, c, k, vlen, seed, amp=1.0):
    inp = {n: torch.from_numpy(v).to(cuda)
           for n, v in _inputs(seed, b, t, c, k).items()}
    inp["scale"] = inp["scale"] * amp
    x = inp["x"].to(torch.bfloat16)
    w = inp["w"].to(torch.bfloat16)
    vl = torch.tensor(vlen, dtype=torch.int32, device=cuda)
    return x, inp["scale"], inp["shift"], inp["alpha"], w, inp["bias"], vl


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_kernel_matches_reference_on_cuda(cuda, dtype, tol):
    """The CUDA-core (f32) and first-design (wmma, bf16) paths vs the plain
    version, B=2 ragged, odd T, k=11 dil=5 (the largest halo). Relative
    error max|a-b|/max|b|; the tolerances are chip_smoke.py's."""
    from mlx_audio_tpu_torch.ops.snake_conv import (
        adain_snake_conv1d_reference, kernel_weight, snake_conv_kernel)

    inp = {k: torch.from_numpy(v).to(cuda)
           for k, v in _inputs(9, 2, 1001, 128, 11).items()}
    x = inp["x"].to(getattr(torch, dtype))
    w = inp["w"].to(x.dtype)
    path = "f32" if dtype == "float32" else "wmma"
    vlen = torch.tensor([1001, 613], dtype=torch.int32, device=cuda)
    args = (x, inp["scale"], inp["shift"], inp["alpha"])
    got = snake_conv_kernel(*args, kernel_weight(w, path), inp["bias"],
                            dilation=5, valid_len=vlen, path=path)
    want = adain_snake_conv1d_reference(*args, w, inp["bias"], dilation=5,
                                        valid_len=vlen)
    torch.cuda.synchronize()
    assert _rel(got, want) <= tol


SHAPES = [(c, k, d) for c in (256, 128) for k in (3, 7, 11) for d in (1, 3, 5)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", ["forced", "dispatched"])
@pytest.mark.parametrize("c,k,dil", SHAPES)
def test_wgmma_matches_reference_on_cuda(cuda, c, k, dil, mode):
    """wgmma at each generator shape, B=2, T not a multiple of the tile:
    one row empty (valid_len 0), then one row shorter than the halo; by
    path="wgmma", or through adain_snake_conv1d's dispatch (counted)."""
    from mlx_audio_tpu_torch.ops.snake_conv import (
        adain_snake_conv1d, adain_snake_conv1d_reference, kernel_weight,
        snake_conv_kernel)

    halo = (k - 1) // 2 * dil
    for t, vlen in ((1001, [1001, 0]), (333, [max(halo - 1, 0), 333])):
        x, scale, shift, alpha, w, bias, vl = _cuda_case(
            cuda, 2, t, c, k, vlen, seed=c + k + dil)
        before = snake_conv_kernel.path_launches["wgmma"]
        if mode == "forced":
            got = snake_conv_kernel(x, scale, shift, alpha,
                                    kernel_weight(w, "wgmma"), bias,
                                    dilation=dil, valid_len=vl, path="wgmma")
        else:
            got = adain_snake_conv1d(x, scale, shift, alpha, w, bias,
                                     dilation=dil, valid_len=vl)
        want = adain_snake_conv1d_reference(x, scale, shift, alpha, w, bias,
                                            dilation=dil, valid_len=vl)
        torch.cuda.synchronize()
        assert snake_conv_kernel.path_launches["wgmma"] == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        assert _rel(got, want) <= 1e-2, (t, vlen)
        assert torch.all(got[1, vlen[1]:] == 0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("c,k,dil,t", [(256, 3, 1, 1), (128, 3, 1, 1),
                                       (128, 11, 5, 961), (128, 7, 3, 257),
                                       (64, 7, 3, 300), (192, 11, 5, 500)])
def test_wgmma_edge_lengths_on_cuda(cuda, c, k, dil, t):
    """T = 1; the stage-1 length 120F + 1 (F = 8); one past a 256-row
    tile; the two other widths the path takes (C = 64 and 192). Both rows
    fully valid, then the second at half."""
    from mlx_audio_tpu_torch.ops.snake_conv import (
        adain_snake_conv1d_reference, kernel_weight, snake_conv_kernel)

    for vlen in ([t, t], [t, t // 2]):
        x, scale, shift, alpha, w, bias, vl = _cuda_case(cuda, 2, t, c, k,
                                                         vlen, seed=t)
        got = snake_conv_kernel(x, scale, shift, alpha,
                                kernel_weight(w, "wgmma"), bias,
                                dilation=dil, valid_len=vl, path="wgmma")
        want = adain_snake_conv1d_reference(x, scale, shift, alpha, w, bias,
                                            dilation=dil, valid_len=vl)
        torch.cuda.synchronize()
        assert _rel(got, want) <= 1e-2, vlen


@pytest.mark.requires_cuda
def test_wgmma_large_snake_arguments_on_cuda(cuda):
    """The wgmma path reduces sin^2's argument by pi before the hardware
    sine; alpha*u up to about 1e4 must still meet the bf16 tolerance
    against torch.sin."""
    from mlx_audio_tpu_torch.ops.snake_conv import (
        adain_snake_conv1d_reference, kernel_weight, snake_conv_kernel)

    x, scale, shift, alpha, w, bias, vl = _cuda_case(
        cuda, 2, 500, 256, 3, [500, 321], seed=11, amp=2500.0)
    u = (x.float() * scale[:, None] + shift[:, None]).abs().max() * alpha.max()
    assert u >= 1e4
    got = snake_conv_kernel(x, scale, shift, alpha, kernel_weight(w, "wgmma"),
                            bias, valid_len=vl, path="wgmma")
    want = adain_snake_conv1d_reference(x, scale, shift, alpha, w, bias,
                                        valid_len=vl)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-2
