"""TTS loader of the port (subset of mlx_audio_tpu/tts/utils.py): local
checkpoint directories of the families ported so far (Kokoro, Qwen3-TTS,
Higgs Audio v2, KugelAudio, VibeVoice, Sesame CSM).

`MODEL_REMAPPING` is the JAX package's registry of TTS model types, kept
whole so that a type the port does not have yet is named as such; the
families in `PORTED` are ported. A checkpoint's family comes from its
config's model_type, else from its directory name's parts, as the JAX
package's `get_model_class` finds it."""

from __future__ import annotations

from pathlib import Path
from typing import Union

from ..model import check_device
from ..utils import (apply_quantization, get_model_name_parts, load_config,
                     load_weights, resolve_family)

MODEL_REMAPPING = {
    "style_tts": "kokoro",
    "kokoro": "kokoro",
    "kitten": "kitten_tts",
    "kittentts": "kitten_tts",
    "qwen3_tts": "qwen3_tts",
    "qwen3tts": "qwen3_tts",
    "csm": "sesame",
    "sesame": "sesame",
    "higgs": "higgs_audio_v3",
    "higgs_audio_v3": "higgs_audio_v3",
    "higgs_audio": "higgs_audio",
    "bark": "bark",
    "dia": "dia",
    "spark": "spark",
    "llama": "llama",
    "orpheus": "llama",
    "svara": "llama",
    "outetts": "outetts",
    "soprano": "soprano",
    "vibevoice": "vibevoice",
    "vibevoice_streaming": "vibevoice",
    "chatterbox": "chatterbox",
    "chatterbox_turbo": "chatterbox_turbo",
    "chatterboxturbo": "chatterbox_turbo",
    "melotts": "melotts",
    "vits": "melotts",
    "pocket_tts": "pocket_tts",
    "pocket": "pocket_tts",
    "moss_tts": "moss_tts",
    "moss_tts_delay": "moss_tts_delay",
    "moss_ttsd": "moss_tts_delay",
    "moss_tts_local": "moss_tts_local",
    "moss_tts_nano": "moss_tts_nano",
    "mosstts": "moss_tts",
    "qwen3": "qwen3",
    "vyvo": "qwen3",
    "vyvotts": "qwen3",
    "bailingmm": "bailingmm",
    "ming_omni_tts": "bailingmm",
    "ming_omni": "bailingmm",
    "dense": "dense",
    "kugelaudio": "kugelaudio",
    "kugel": "kugelaudio",
    "voxcpm": "voxcpm",
    "voxcpm2": "voxcpm2",
    "tada": "tada",
    "fish_speech": "fish_qwen3_omni",
    "fish_qwen3_omni": "fish_qwen3_omni",
    "fishspeech": "fish_qwen3_omni",
    "confucius4": "confucius4",
    "confucius": "confucius4",
    "echo_tts": "echo_tts",
    "echo": "echo_tts",
    "echotts": "echo_tts",
    "indextts": "indextts",
    "index_tts": "indextts",
    "index-tts": "indextts",
    "omnivoice": "omnivoice",
    "omni_voice": "omnivoice",
    "voxtral_tts": "voxtral_tts",
    "voxtral": "voxtral_tts",
    "audiodit": "longcat_audiodit",
    "longcat_audiodit": "longcat_audiodit",
    "longcat": "longcat_audiodit",
    "zonos2": "zonos2",
    "zonos": "zonos2",
    "irodori_tts": "irodori_tts",
    "irodori": "irodori_tts",
    "dramabox-tts": "dramabox",
    "dramabox": "dramabox",
}
# families of MODEL_REMAPPING's values that the port has
PORTED = ("kokoro", "qwen3_tts", "higgs_audio", "kugelaudio", "vibevoice",
          "sesame")


def load_model(model_path: Union[str, Path], device="cuda",
               model_name_parts=None, **config_overrides):
    """Load a local model directory (config.json + weights) onto `device`:
    the card by default; without CUDA it raises, before reading the
    weights, unless given `device="cpu"`.

    The weights are the published torch-layout checkpoint; the family's
    `sanitize` maps them onto the port's parameter names. Qwen3-TTS also
    reads the codec and the reference encoder (with its `encoder_config`)
    from a `speech_tokenizer/` subfolder when there is one; Sesame builds
    the Mimi its HF checkpoint embeds. Qwen3-TTS, Higgs, KugelAudio and VibeVoice quantize per
    config["quantization"] (each family's predicate; W8A8 with the opt-in),
    and read an HF tokenizer from the directory. The family comes from the
    config's model_type, else from the directory name's parts
    (`model_name_parts`, which the router passes)."""
    device = check_device(device)
    path = Path(model_path).expanduser()
    if not path.is_dir():
        raise FileNotFoundError(f"Local model path not found: {model_path}")
    config = load_config(path)
    config["model_path"] = str(path)
    config.update(config_overrides)
    model_type = config.get("model_type") or config.get("architecture")
    family = resolve_family(model_type, model_name_parts
                            or get_model_name_parts(path), MODEL_REMAPPING)
    if family not in PORTED:
        raise ValueError(f"Model type {model_type!r} (family {family!r}) is "
                         f"not ported to mlx_audio_tpu_torch yet (ported: "
                         f"{', '.join(PORTED)})")
    if family == "qwen3_tts":
        return _load_qwen3_tts(path, config, device)
    if family in ("higgs_audio", "kugelaudio", "vibevoice"):
        return _load_quantizable(family, path, config, device)
    if family == "sesame":
        from .models.sesame import Model, ModelConfig

        model = Model(ModelConfig.from_dict(config), device=device)
        model.bind(model.sanitize(load_weights(path)))
        return Model.post_load_hook(model, path)
    from .models.kokoro import Model, ModelConfig

    model = Model(ModelConfig.from_dict(config), device=device)
    return model.bind(model.sanitize(load_weights(path)))


def _load_qwen3_tts(path: Path, config: dict, device):
    from .models.qwen3_tts import Model, ModelConfig

    weights = load_weights(path)
    if any(k.endswith(".scales") for k in weights):
        raise NotImplementedError("pre-quantized (MLX-packed) checkpoints are "
                                  "not ported yet; load the dense one")
    codec_dir = path / "speech_tokenizer"
    if codec_dir.is_dir():
        weights.update({f"speech_tokenizer.{k}": v
                        for k, v in load_weights(codec_dir).items()})
        tok = dict(config.get("tokenizer_config") or {})
        if (codec_dir / "config.json").is_file() and \
                not tok.get("encoder_config"):
            enc = load_config(codec_dir).get("encoder_config")
            if enc:
                config["tokenizer_config"] = dict(tok, encoder_config=enc)
    model = Model(ModelConfig.from_dict(config), device=device)
    model.bind(model.sanitize(weights))
    apply_quantization(model, config, model.model_quant_predicate)
    return Model.post_load_hook(model, path)


def _load_quantizable(family: str, path: Path, config: dict, device):
    """Higgs, KugelAudio or VibeVoice: the weights through the family's
    `sanitize`, its linears quantized per config["quantization"] with its
    predicates, then its `post_load_hook` (the local HF tokenizer)."""
    import importlib

    module = importlib.import_module(f".models.{family}", __package__)
    Model, ModelConfig = module.Model, module.ModelConfig
    weights = load_weights(path)
    if any(k.endswith(".scales") for k in weights):
        raise NotImplementedError("pre-quantized (MLX-packed) checkpoints are "
                                  "not ported yet; load the dense one")
    model = Model(ModelConfig.from_dict(config), device=device)
    model.bind(model.sanitize(weights))
    apply_quantization(model, config,
                       getattr(model, "model_quant_predicate", None),
                       getattr(model, "model_i8_predicate", None))
    return Model.post_load_hook(model, path)
