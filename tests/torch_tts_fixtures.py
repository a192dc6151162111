"""Small KugelAudio and VibeVoice models, stand-in tokenizers and
checkpoint writers for the port's tests and for `chip_smoke.py`.

Imports torch and the port only (no JAX), so the CPU tests, the
fresh-interpreter checks of tests/test_torch_imports.py and the card's smoke
run share one copy. The configs are tests/test_kugelaudio.py's and
tests/test_vibevoice.py's; random weights rarely pick speech_diffusion, so
`force_diffusion` adds the lanes' lm_head bias, and `fixed_draws` feeds two
models one noise tensor through the `_draws` seam.
"""

from __future__ import annotations

import json
from pathlib import Path

# tests/test_kugelaudio.py:23-35: a 2-layer Qwen2 at d32 with the real
# vocabulary, a 2-layer head, a VAE of hop 4
KUGEL_SMALL = dict(
    acoustic_tokenizer_config=dict(vae_dim=8, decoder_n_filters=4,
                                   encoder_ratios=[2, 2],
                                   encoder_depths="1-1-1", channels=1),
    decoder_config=dict(hidden_size=32, num_hidden_layers=2,
                        intermediate_size=64, num_attention_heads=4,
                        num_key_value_heads=2, vocab_size=151700),
    diffusion_head_config=dict(hidden_size=32, head_layers=2,
                               head_ffn_ratio=2.0, latent_size=8,
                               ddpm_num_steps=1000,
                               ddpm_num_inference_steps=4),
    acoustic_vae_dim=8, tie_word_embeddings=False)
# tests/test_vibevoice.py:14-33: a 2-layer Qwen2 split 1 + 1 at d16, a
# 1-layer head, the same VAE
VIBEVOICE_SMALL = dict(
    sample_rate=16000, acoustic_vae_dim=8, tts_backbone_num_hidden_layers=1,
    decoder_config=dict(hidden_size=16, intermediate_size=32,
                        num_attention_heads=2, num_hidden_layers=2,
                        num_key_value_heads=2, vocab_size=64),
    diffusion_head_config=dict(hidden_size=16, head_layers=1,
                               head_ffn_ratio=2.0, latent_size=8,
                               freq_embed_size=8, ddpm_num_steps=50,
                               ddpm_num_inference_steps=4),
    acoustic_tokenizer_config=dict(vae_dim=8, decoder_n_filters=4,
                                   encoder_ratios=[2, 2],
                                   encoder_depths="1-1-1"))
# VibeVoice's EOS classifier bias that keeps random weights from stopping
VIBE_EOS_OFF = -50.0


class CharTok:
    """tests/test_kugelaudio.py's stand-in tokenizer (the Qwen2.5 tokenizer
    is not in the repository)."""

    def encode(self, s, **kwargs):
        return [100 + (ord(c) % 200) for c in s]


class VibeTok:
    """tests/test_vibevoice.py's stand-in tokenizer."""

    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 63) for c in text][:23]


def kugel_hf_state(model) -> dict:
    """A KugelAudio model's weights under the published checkpoint's names
    (the LM's layers without their inner `model.`, plus a rotary buffer
    that sanitize drops), conv kernels in torch's layouts, as numpy f32."""
    import numpy as np

    out = {}
    for k, v in model.state_dict().items():
        if k.startswith("language_model.model."):
            k = "language_model." + k[len("language_model.model."):]
        out[k] = v.float().cpu().numpy()
    out["language_model.layers.0.self_attn.rotary_emb.inv_freq"] = \
        np.ones(4, np.float32)
    return out


def vibevoice_hf_state(model) -> dict:
    """A VibeVoice model's weights under the published names: a `model.`
    prefix, the two LMs' layers without their inner `model.`, plus an
    `lm_head` and a rotary buffer that sanitize drops."""
    import numpy as np

    out = {}
    for k, v in model.state_dict().items():
        for pref in ("language_model.model.", "tts_language_model.model."):
            if k.startswith(pref):
                k = pref[:-len("model.")] + k[len(pref):]
        out["model." + k] = v.float().cpu().numpy()
    out["model.language_model.layers.0.self_attn.rotary_emb.inv_freq"] = \
        np.ones(4, np.float32)
    h = model.config.decoder_config.hidden_size
    out["lm_head.weight"] = np.zeros((8, h), np.float32)
    return out


def write_tts_checkpoint(model, state: dict, model_type: str, path: Path,
                         **extra) -> None:
    """config.json (the model's config, `model_type` set, `extra` keys such
    as `quantization` added) and `state` in one npz."""
    import dataclasses

    import numpy as np

    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "model.npz", **state)
    cfg = dataclasses.asdict(model.config)
    cfg.pop("model_path", None)
    cfg["model_type"] = model_type
    cfg.update(extra)
    (path / "config.json").write_text(json.dumps(cfg))


def fixed_draws(model, table):
    """Make `model` take its draws from `table` (a CPU tensor (N, ...)),
    indexed as the seam's start says, so two devices see one noise."""

    def draws(generator, start, n, shape):
        return table[start:start + n].reshape((n,) + tuple(shape)).to(
            model.device)

    model._draws = draws
    return model


def force_diffusion(model):
    """The lanes' +1e4 lm_head bias on SPEECH_DIFFUSION_ID (bench.py:
    593-596): every frame a diffusion frame, whatever the weights."""
    import torch

    from mlx_audio_tpu_torch.tts.models.kugelaudio.kugelaudio import \
        SPEECH_DIFFUSION_ID

    bias = torch.zeros(model.lm_head.weight.shape[0], device=model.device)
    bias[SPEECH_DIFFUSION_ID] = 1e4
    model.lm_head.bias = torch.nn.Parameter(bias)
    return model


def kugel_small(device: str, config: dict = KUGEL_SMALL):
    """The small KugelAudio (or `config`) at f32 from seed 0."""
    from mlx_audio_tpu_torch.tts.models.kugelaudio import Model

    model = Model(config, device=device).init_params(seed=0)
    model.tokenizer = CharTok()
    return model


def vibevoice_small(device: str):
    """The small VibeVoice at f32 from seed 0, its EOS classifier biased
    off."""
    from mlx_audio_tpu_torch.tts.models.vibevoice import Model

    model = Model(VIBEVOICE_SMALL, device=device).init_params(seed=0)
    model.tokenizer = VibeTok()
    model.tts_eos_classifier.fc2.bias.fill_(VIBE_EOS_OFF)
    return model
