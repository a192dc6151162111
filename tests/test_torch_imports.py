"""The PyTorch port stands without JAX and builds nothing at import.

Each check runs in a fresh interpreter, so nothing the test process has
already imported (the test suite imports jax) can hide an import.
"""

import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_tiny_synth_without_jax():
    """Import the port, synthesize on the CPU at a tiny size, and find no
    jax in sys.modules."""
    out = _run("""
        import sys
        import numpy as np
        from mlx_audio_tpu_torch.tts.models.kokoro import Model, ModelConfig

        cfg = ModelConfig(
            istftnet=dict(resblock_kernel_sizes=[3], upsample_rates=[4, 4],
                          upsample_initial_channel=16,
                          resblock_dilation_sizes=[[1, 3, 5]],
                          upsample_kernel_sizes=[8, 8], gen_istft_n_fft=12,
                          gen_istft_hop_size=3),
            dim_in=16, hidden_dim=32, n_layer=2, n_mels=20, n_token=40,
            style_dim=16, decoder_bottleneck=24, decoder_res_dim=8,
            plbert=dict(num_hidden_layers=2, num_attention_heads=2,
                        hidden_size=24, intermediate_size=32,
                        max_position_embeddings=128, embedding_size=12),
            vocab={c: i + 1 for i, c in enumerate("abcdefgh ")})
        model = Model(cfg).init_params(seed=0)
        audio, dur = model("abc def", np.zeros((1, 32), np.float32),
                           deterministic_noise=True)
        assert audio.shape == (int(dur.sum()) * model.samples_per_frame,)
        assert np.isfinite(audio).all()
        print("jax" in sys.modules, sorted(
            m for m in sys.modules if m == "jax" or m.startswith("jax.")))
    """)
    assert out.strip() == "False []", out


def test_tiny_qwen3_tts_generate_without_jax():
    """Qwen3-TTS on the CPU at a tiny size, quantized to 8 bits: seeded
    weights, text ids -> audio, and no jax in sys.modules."""
    out = _run("""
        import sys
        import numpy as np
        from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model, ModelConfig
        from mlx_audio_tpu_torch.utils import apply_quantization

        cfg = ModelConfig(
            talker_config=dict(
                vocab_size=300, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=8, num_code_groups=4,
                text_hidden_size=48, text_vocab_size=500,
                codec_eos_token_id=280, codec_think_id=284,
                codec_nothink_id=285, codec_think_bos_id=286,
                codec_think_eos_id=287, codec_pad_id=278, codec_bos_id=279,
                code_predictor_config=dict(
                    vocab_size=256, hidden_size=32, intermediate_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=8, num_code_groups=4)),
            tokenizer_config=dict(decoder_config=dict(
                latent_dim=32, codebook_dim=16, codebook_size=256,
                decoder_dim=64, hidden_size=24, intermediate_size=48,
                head_dim=8, num_attention_heads=3, num_hidden_layers=2,
                num_key_value_heads=3, num_quantizers=4,
                num_semantic_quantizers=1, sliding_window=16,
                upsample_rates=[4, 3], upsampling_ratios=[2, 2])),
            tts_bos_token_id=497, tts_eos_token_id=498, tts_pad_token_id=499)
        model = Model(cfg).init_params(seed=0)
        apply_quantization(model, {"quantization": {"bits": 8,
                                                    "group_size": 16}},
                           model.model_quant_predicate)
        (r,) = model.generate(text_ids=np.arange(10, 30)[None],
                              temperature=0.9, max_tokens=12, seed=0)
        assert r.samples == r.token_count * model.total_upsample > 0
        assert np.isfinite(r.audio).all()
        print("jax" in sys.modules, sorted(
            m for m in sys.modules if m == "jax" or m.startswith("jax.")))
    """)
    assert out.strip() == "False []", out


def test_every_module_imports_without_building():
    """Every module of the port imports on a machine without nvcc; the CUDA
    kernels are built only when first launched."""
    out = _run("""
        import importlib, pkgutil, sys
        import mlx_audio_tpu_torch as pkg

        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        from mlx_audio_tpu_torch.ops import cuda_build
        from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
        from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
        assert cuda_build._LOADED == {} and snake_conv_kernel._lib is None
        assert qmm_kernel._lib is None
        assert snake_conv_kernel.launches == 0 and qmm_kernel.launches == 0
        print(len(names), "jax" in sys.modules)
    """)
    n, has_jax = out.split()
    assert int(n) >= 15 and has_jax == "False", out
