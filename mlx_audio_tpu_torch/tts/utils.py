"""TTS loader of the port (subset of mlx_audio_tpu/tts/utils.py): local
checkpoint directories of the families ported so far (Kokoro, Qwen3-TTS,
Higgs Audio v2, KugelAudio, VibeVoice, Sesame CSM, Orpheus, VyvoTTS,
OuteTTS, Pocket-TTS, KittenTTS, Soprano, Voxtral-4B-TTS, OmniVoice,
TADA, MOSS-TTS with its aliases), dense,
pre-quantized (MLX-packed) or written by the convert CLI. A family whose
`Model.SANITIZE_GIVES_JAX_TREE` is set maps a checkpoint onto the JAX
package's tree (as the JAX package's `sanitize` does), which
`model.load_jax_params` binds.

`MODEL_REMAPPING` is the JAX package's registry of TTS model types, kept
whole so that a type the port does not have yet is named as such; the
families in `PORTED` are ported. A checkpoint's family comes from its
config's model_type, else from its directory name's parts, as the JAX
package's `get_model_class` finds it."""

from __future__ import annotations

from pathlib import Path
from typing import Union

from ..model import check_device
from ..utils import (bind_checkpoint, get_model_name_parts, load_config,
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
          "sesame", "llama", "qwen3", "outetts", "pocket_tts", "kitten_tts",
          "soprano", "voxtral_tts", "omnivoice", "tada", "moss_tts",
          "moss_tts_delay", "moss_tts_local")


def load_model(model_path: Union[str, Path], device="cuda",
               model_name_parts=None, **config_overrides):
    """Load a local model directory (config.json + weights) onto `device`:
    the card by default; without CUDA it raises, before reading the
    weights, unless given `device="cpu"`.

    The weights are the published torch-layout checkpoint, which the
    family's `sanitize` maps onto the port's parameter names, then
    quantized per config["quantization"] with the family's predicates (a
    pre-quantized MLX checkpoint's packed leaves unpacked instead;
    `utils.bind_checkpoint`); or the JAX tree of a directory the convert
    CLI wrote. Qwen3-TTS also reads the codec and the reference encoder
    (with its `encoder_config`) from a `speech_tokenizer/` subfolder when
    there is one; Sesame builds the Mimi its HF checkpoint embeds; Orpheus
    (`llama`, `orpheus`, `svara`) and VyvoTTS (`qwen3`, `vyvo`,
    `vyvotts`) bind the SNAC of a `snac/` or `codec/` subfolder. The families with a text tokenizer read it from
    the directory. The family comes from the config's model_type, else
    from the directory name's parts (`model_name_parts`, which the router
    passes); a `llama` config with `acoustic_dim` is TADA, as in the JAX
    package (mlx_audio_tpu/utils.py:339-341)."""
    device = check_device(device)
    path = Path(model_path).expanduser()
    if not path.is_dir():
        raise FileNotFoundError(f"Local model path not found: {model_path}")
    config = load_config(path)
    config["model_path"] = str(path)
    config.update(config_overrides)
    model_type = config.get("model_type") or config.get("architecture")
    if model_type == "llama" and "acoustic_dim" in config:
        model_type = "tada"
    family = resolve_family(model_type, model_name_parts
                            or get_model_name_parts(path), MODEL_REMAPPING)
    if family not in PORTED:
        raise ValueError(f"Model type {model_type!r} (family {family!r}) is "
                         f"not ported to mlx_audio_tpu_torch yet (ported: "
                         f"{', '.join(PORTED)})")
    if family == "qwen3_tts":
        return _load_qwen3_tts(path, config, device)
    return _load_family(family, path, config, device, load_weights(path))


def _load_family(family: str, path: Path, config: dict, device,
                 weights: dict):
    import importlib

    from ..model import load_jax_params

    module = importlib.import_module(f".models.{family}", __package__)
    model = module.Model(module.ModelConfig.from_dict(config), device=device)
    bind_checkpoint(model, config, weights,
                    bind=(lambda w: load_jax_params(model, w))
                    if getattr(model, "SANITIZE_GIVES_JAX_TREE", False)
                    else None)
    post_load_hook = getattr(module.Model, "post_load_hook", None)
    return model if post_load_hook is None else post_load_hook(model, path)


def _load_qwen3_tts(path: Path, config: dict, device):
    """Qwen3-TTS, with the codec and reference-encoder weights of a
    `speech_tokenizer/` subfolder under `speech_tokenizer.`, and that
    folder's `encoder_config` in the tokenizer config."""
    weights = load_weights(path)
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
    return _load_family("qwen3_tts", path, config, device, weights)
