"""Domain-aware model conversion and quantization CLI.

Counterpart of mlx_audio_tpu/convert.py: `Domain`, `discover_model_types`
over the port's own packages, `detect_model_domain`, `convert()` and
`main()` with every option (dtype, `-q`, `--q-group-size`, `--q-bits`,
`--q-mode` affine / mxfp4 / nvfp4 / mxfp8, `--quant-predicate` mixed_L_H,
`--domain`, `-d/--dequantize`). It loads a checkpoint through the
domain's loader, quantizes or dequantizes the model's parameter tree, and
writes what the JAX package's CLI writes: `model.safetensors` holding the
JAX tree (`model.jax_params`, its layouts) with the metadata
{"format": "mlx_audio_tpu", "domain": ...}, `config.json` marked
`converted_by: "mlx_audio_tpu.convert"`, and the tokenizer and voice files
carried along. So one converted directory loads in both packages, bound
with no sanitize and no quantization.

    python -m mlx_audio_tpu_torch.convert --hf-path <dir> --mlx-path out \\
        -q --q-bits 4                         # loads on the card
    python -m mlx_audio_tpu_torch.convert --hf-path <dir> --mlx-path out \\
        --q-mode mxfp8 -q --device cpu

Departures from the JAX package: paths are local only (a missing
directory raises FileNotFoundError; the port never downloads, so
`--revision` is refused), and `--upload-repo` is refused (the port never
uploads); both raise ValueError before anything is read. The model loads
on `--device`, the card by default.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pkgutil
import shutil
from enum import Enum
from pathlib import Path
from typing import Optional

MODEL_CONVERSION_DTYPES = ["float16", "bfloat16", "float32"]
QUANT_RECIPES = ["mixed_2_6", "mixed_3_4", "mixed_3_6", "mixed_4_6"]
QUANT_MODES = ["affine", "mxfp4", "nvfp4", "mxfp8"]


class Domain(str, Enum):
    TTS = "tts"
    STT = "stt"
    STS = "sts"
    LID = "lid"
    VAD = "vad"
    CODEC = "codec"


def discover_model_types(domain: str) -> set:
    """The model family packages under mlx_audio_tpu_torch.{domain}.models
    (none for a domain the port lacks)."""
    try:
        pkg = importlib.import_module(f"{__package__}.{domain}.models")
    except ImportError:
        return set()
    return {m.name for m in pkgutil.iter_modules(pkg.__path__) if m.ispkg}


def detect_model_domain(config: dict, model_path: Path) -> Domain:
    """The domain from the model_type, the config's keys, or the directory
    name (mlx_audio_tpu/convert.py:49-75)."""
    model_type = str(config.get("model_type", "")).lower()
    for domain in Domain:
        if model_type in discover_model_types(domain.value):
            return domain
    keys = set(config)
    if {"talker_config", "istftnet", "tts_model_type"} & keys:
        return Domain.TTS
    if {"encoder_layers", "n_audio_ctx", "max_source_positions"} & keys:
        return Domain.STT
    if {"branch_16k", "threshold"} & keys:
        return Domain.VAD
    if {"num_classes", "id2label"} & keys:
        return Domain.LID
    name = Path(model_path).name.lower()
    for domain in Domain:
        if domain.value in name:
            return domain
    for domain in Domain:
        for mt in discover_model_types(domain.value):
            if mt in name.replace("-", "_"):
                return domain
    raise ValueError(
        f"Could not detect domain for {model_path} "
        f"(model_type={model_type!r}); pass --domain explicitly.")


def convert(hf_path: str, mlx_path: str = "mlx_model",
            dtype: str = "bfloat16", quantize: bool = False,
            q_group_size: Optional[int] = None, q_bits: int = 4,
            q_mode: str = "affine", quant_predicate: Optional[str] = None,
            domain: Optional[str] = None, upload_repo: Optional[str] = None,
            dequantize: bool = False, revision: Optional[str] = None,
            device="cuda") -> Path:
    """Convert a local checkpoint: load it through the domain's loader on
    `device`, optionally quantize (affine int-N, mxfp4/nvfp4/mxfp8, or a
    mixed_L_H recipe, under the model's own `model_quant_predicate`) or
    dequantize it, cast the other floating leaves to `dtype`, and write
    safetensors + config.json (mlx_audio_tpu/convert.py:78-170)."""
    import torch
    from safetensors.torch import save_file

    from .model import check_device, jax_params
    from .ops.quant import (FP_MODE_DEFAULTS, dequantize_tree,
                            maybe_quantize_tree, mixed_quant_predicate)
    from .utils import CONVERTED_BY, flatten, load_config, unflatten

    if quantize and dequantize:
        raise ValueError("--quantize and --dequantize are mutually exclusive")
    if upload_repo:
        raise ValueError(f"upload_repo={upload_repo!r}: the port never "
                         f"uploads; copy the converted directory yourself")
    if revision is not None:
        raise ValueError(f"revision={revision!r}: the port never downloads "
                         f"and reads local directories only")
    check_device(device)
    model_path = Path(hf_path).expanduser()
    if not model_path.is_dir():
        raise FileNotFoundError(f"Local model path not found: {hf_path} "
                                f"(the port never downloads)")
    config = load_config(model_path)
    dom = Domain(domain) if domain else detect_model_domain(config,
                                                            model_path)
    task_utils = importlib.import_module(f"{__package__}.{dom.value}.utils")
    target = {"float16": torch.float16, "bfloat16": torch.bfloat16,
              "float32": torch.float32}[dtype]
    model = task_utils.load_model(model_path, device=device)

    params = unflatten(jax_params(model))
    if quantize:
        gs = q_group_size or FP_MODE_DEFAULTS.get(q_mode, 64)
        predicate = (mixed_quant_predicate(quant_predicate)
                     if quant_predicate else None)
        model_pred = getattr(model, "model_quant_predicate", None)
        if model_pred is not None:
            inner = predicate

            def predicate(p, w, _inner=inner):  # noqa: E306
                if not model_pred(p, w):
                    return False
                return _inner(p, w) if _inner is not None else True

        params = maybe_quantize_tree(params, gs, q_bits, predicate,
                                     mode=q_mode)
        config["quantization"] = {
            "group_size": gs, "bits": q_bits, "mode": q_mode,
            **({"recipe": quant_predicate} if quant_predicate else {})}
    elif dequantize:
        params = dequantize_tree(params)
        config.pop("quantization", None)

    out = Path(mlx_path)
    out.mkdir(parents=True, exist_ok=True)
    flat = {k: (v.to(target) if v.is_floating_point() else v)
            .detach().cpu().contiguous() for k, v in flatten(params).items()}
    save_file(flat, str(out / "model.safetensors"),
              metadata={"format": "mlx_audio_tpu", "domain": dom.value})
    config["converted_by"] = CONVERTED_BY
    config.pop("model_path", None)
    (out / "config.json").write_text(json.dumps(config, indent=2))
    for pattern in ("tokenizer*", "*.tiktoken", "vocab*", "voices*",
                    "merges.txt"):
        for f in model_path.glob(pattern):
            dest = out / f.name
            if f.is_dir():
                shutil.copytree(f, dest, dirs_exist_ok=True)
            elif not dest.exists():
                shutil.copy2(f, dest)
    print(f"✅ Converted {hf_path} [{dom.value}] -> {out}")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert audio models to mlx_audio_tpu format")
    parser.add_argument("--hf-path", "--hf_path", "--model", dest="hf_path",
                        required=True)
    parser.add_argument("--mlx-path", "--mlx_path", "--output",
                        dest="mlx_path", default="mlx_model")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=MODEL_CONVERSION_DTYPES)
    parser.add_argument("-q", "--quantize", action="store_true")
    parser.add_argument("--q-group-size", type=int, default=None)
    parser.add_argument("--q-bits", type=int, default=4)
    parser.add_argument("--q-mode", default="affine", choices=QUANT_MODES)
    parser.add_argument("--quant-predicate", default=None,
                        choices=QUANT_RECIPES,
                        help="Mixed-bit quantization recipe.")
    parser.add_argument("--domain", "--model-domain", "--model_domain",
                        dest="domain", default=None,
                        choices=[d.value for d in Domain])
    parser.add_argument("--upload-repo", default=None,
                        help="Refused: the port never uploads")
    parser.add_argument("-d", "--dequantize", action="store_true",
                        help="Dequantize a quantized model")
    parser.add_argument("--revision", type=str, default=None,
                        help="Refused: the port reads local directories only")
    parser.add_argument("--device", default="cuda",
                        help="Device to load the model on (default the card)")
    args = parser.parse_args(argv)
    convert(
        hf_path=args.hf_path, mlx_path=args.mlx_path, dtype=args.dtype,
        quantize=args.quantize, q_group_size=args.q_group_size,
        q_bits=args.q_bits, q_mode=args.q_mode,
        quant_predicate=args.quant_predicate, domain=args.domain,
        upload_repo=args.upload_repo, dequantize=args.dequantize,
        revision=args.revision, device=args.device)


if __name__ == "__main__":
    main()
