"""The port of the fused AdaIN -> Snake -> dilated-conv1d Pallas kernel.

On the CPU the port's plain PyTorch version (`adain_snake_conv1d_reference`)
is held to the JAX Pallas kernel run in interpret mode, as
tests/test_snake_conv_pallas.py runs it, and the port's generator block
(`AdaINResBlock1`) to the JAX block on its fused (interpret) and unfused
branches. The CUDA kernel itself is compared with the plain version only
where a GPU is present (marker `requires_cuda`); chip_smoke.py does the
same at the main path's shapes. JAX is imported inside the tests that use
it, so on a GPU machine without JAX the CUDA test runs alone:
`python -m pytest --noconftest -m requires_cuda tests/test_torch_snake_conv.py`.

Tolerances: f32 2e-4 (summation order only; the values are O(1), as in
tests/test_snake_conv_pallas.py:125); bf16 0.05 (h and the output round to
8 mantissa bits; the precedent of tests/test_snake_conv_pallas.py:143-145).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")


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


@pytest.mark.parametrize("k,dilation", [(3, 1), (3, 3), (7, 1), (7, 3)])
def test_reference_matches_pallas_f32(k, dilation):
    """B=2 with ragged valid lengths (one row full, one cut)."""
    inp = _inputs(4, 2, 300, 128, k)
    vlen = [300, 170]
    got = _port_call(inp, dilation, vlen)
    want = _jax_call(inp, dilation, vlen)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_kernel_matches_reference_on_cuda(dtype, tol):
    """CUDA kernel vs plain version, B=2 ragged, odd T, k=11 dil=5 (the
    largest halo). Relative error max|a-b|/max|b|; the tolerances are
    chip_smoke.py's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    from mlx_audio_tpu_torch.ops.snake_conv import (
        adain_snake_conv1d_reference, snake_conv_kernel)

    torch.backends.cudnn.allow_tf32 = False
    inp = {k: torch.from_numpy(v).cuda()
           for k, v in _inputs(9, 2, 1001, 128, 11).items()}
    x = inp["x"].to(getattr(torch, dtype))
    w = inp["w"].to(x.dtype)
    vlen = torch.tensor([1001, 613], dtype=torch.int32, device="cuda")
    args = (x, inp["scale"], inp["shift"], inp["alpha"], w, inp["bias"])
    got = snake_conv_kernel(*args, dilation=5, valid_len=vlen)
    want = adain_snake_conv1d_reference(*args, dilation=5, valid_len=vlen)
    torch.cuda.synchronize()
    rel = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    assert rel <= tol, rel
