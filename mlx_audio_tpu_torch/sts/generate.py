"""STS CLI: enhancement, separation or a duplex run over one audio file.

Counterpart of mlx_audio_tpu/sts/generate.py (`generate_sts`, `main`):

    python -m mlx_audio_tpu_torch.sts.generate --model <dir> --audio in.wav \
        --output-path out.wav

The model loads on the card (`sts.utils.load_model`); the CLI passes on
only the keyword arguments that the model's `generate` accepts (the JAX
CLI's :44-53; `--stream` reaches DeepFilterNet's) and writes the result
through the port's `audio_io`. Departure from the JAX package: a result of
two channels (Mel-Band-RoFormer's stereo stem, (2, samples)) is written as
a stereo file, where the JAX CLI flattens it (and the JAX Mel-Band-
RoFormer has no `generate` to call at all).
"""

from __future__ import annotations

import argparse
import inspect
import time

import numpy as np


def generate_sts(model_path: str, audio: str,
                 output_path: str = "output.wav", model=None,
                 verbose: bool = True, **kwargs):
    from .. import audio_io
    from .utils import load_model

    if model is None:
        if verbose:
            print(f"Loading model: {model_path}")
        load_kwargs = {k: kwargs[k] for k in ("subfolder", "version")
                       if kwargs.get(k) is not None}
        model = load_model(model_path, **load_kwargs)
    kwargs.pop("subfolder", None)
    kwargs.pop("version", None)

    sig = inspect.signature(model.generate).parameters
    has_var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                     for p in sig.values())
    kwargs = {k: v for k, v in kwargs.items()
              if v is not None and (has_var_kw or k in sig)}

    start = time.time()
    result = model.generate(audio, **kwargs)
    wall = time.time() - start

    if isinstance(result, dict):
        out = np.asarray(result.get("audio"))
        sr = result.get("sample_rate", getattr(model, "sample_rate", 24000))
    else:
        out = np.asarray(result.audio if hasattr(result, "audio")
                         else result)
        sr = getattr(result, "sample_rate",
                     getattr(model, "sample_rate", 24000))
    out = out.T if out.ndim == 2 and out.shape[0] == 2 else out.reshape(-1)
    audio_io.write(output_path, np.ascontiguousarray(out, np.float32),
                   int(sr))
    if verbose:
        print(f"Output saved to {output_path} ({wall:.2f}s)")
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description="Speech-to-speech processing")
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--audio", type=str, required=True)
    parser.add_argument("--output-path", "--output_path",
                        dest="output_path", type=str, default="output.wav")
    parser.add_argument("--verbose", action=argparse.BooleanOptionalAction,
                        default=True)
    dfn = parser.add_argument_group("DeepFilterNet options")
    dfn.add_argument("--version", type=int, default=None, choices=[1, 2, 3],
                     help="DeepFilterNet version override")
    dfn.add_argument("--subfolder", type=str, default=None,
                     help="Subfolder within the model repo (e.g. v1, v2, v3)")
    dfn.add_argument("--stream", action="store_true",
                     help="Streaming enhancement mode (DFN v2/v3)")
    args = parser.parse_args(argv)
    generate_sts(args.model, args.audio, args.output_path,
                 verbose=args.verbose, version=args.version,
                 subfolder=args.subfolder, stream=args.stream or None)


if __name__ == "__main__":
    main()
