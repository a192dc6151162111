"""STT transcription CLI and its output writers.

Counterpart of mlx_audio_tpu/stt/generate.py (`generate_transcription`,
`parse_args`, `main`, the txt/srt/vtt/json writers):

    python -m mlx_audio_tpu_torch.stt.generate --model <dir> --audio f.wav \
        --format srt --output-path out

The model loads on the card (`stt.utils.load_model`). Left out: the JAX
package's `maybe_profile`, a `jax.profiler` trace hook around the call.
`--stream` on Whisper runs its streaming session (`Model.generate` with
`stream=True` returns the `generate_streaming` generator), where the JAX
package's Whisper returns one result that the CLI then fails to iterate.
A streamed chunk may be a plain text delta (Voxtral Realtime's
`generate(stream=True)` yields strings): it is taken as an STTOutput of
that text, where the JAX package's CLI fails on it.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional


def _fmt_ts(seconds: float, vtt: bool = False) -> str:
    ms = int(round(seconds * 1000))
    h, ms = divmod(ms, 3_600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1000)
    sep = "." if vtt else ","
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def save_as_txt(output: "STTOutput", path: Path) -> None:
    path.write_text(output.text.strip() + "\n", encoding="utf-8")


def save_as_srt(output, path: Path) -> None:
    lines = []
    for i, seg in enumerate(output.segments or [], start=1):
        lines.append(str(i))
        lines.append(f"{_fmt_ts(seg['start'])} --> {_fmt_ts(seg['end'])}")
        lines.append(seg["text"].strip())
        lines.append("")
    path.write_text("\n".join(lines), encoding="utf-8")


def save_as_vtt(output, path: Path) -> None:
    lines = ["WEBVTT", ""]
    for seg in output.segments or []:
        lines.append(
            f"{_fmt_ts(seg['start'], vtt=True)} --> {_fmt_ts(seg['end'], vtt=True)}")
        lines.append(seg["text"].strip())
        lines.append("")
    path.write_text("\n".join(lines), encoding="utf-8")


def save_as_json(output, path: Path) -> None:
    payload = {
        "text": output.text,
        "segments": output.segments,
        "language": output.language,
    }
    path.write_text(json.dumps(payload, indent=2, ensure_ascii=False),
                    encoding="utf-8")


_WRITERS = {"txt": save_as_txt, "srt": save_as_srt, "vtt": save_as_vtt,
            "json": save_as_json}


def generate_transcription(
    model_path: str,
    audio: str,
    output_path: Optional[str] = None,
    format: str = "txt",
    model=None,
    verbose: bool = True,
    **generate_kwargs,
):
    """Load an STT model, transcribe `audio`, optionally write the result.

    Returns the STTOutput (reference stt/generate.py:243-385).
    """
    from .models.base import STTOutput
    from .utils import load_model

    if model is None:
        if verbose:
            print(f"Loading model: {model_path}")
        model = load_model(model_path)

    # signature-filtered forwarding (reference stt/generate.py:243-290):
    # model-specific knobs (--chunk-duration, --context, --prompt, ...) are
    # dropped for models whose generate() does not take them; --gen-kwargs
    # JSON is merged in raw.
    import inspect

    sig_params = inspect.signature(model.generate).parameters
    has_var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                     for p in sig_params.values())
    raw = generate_kwargs.pop("gen_kwargs", None) or {}
    stream = bool(generate_kwargs.pop("stream", False))
    gen_kwargs = {k: v for k, v in generate_kwargs.items()
                  if v is not None and v != "" and
                  (has_var_kw or k in sig_params)}
    gen_kwargs.update(raw)

    start = time.time()
    if stream and "stream" in sig_params:
        # streaming accumulation (reference stt/generate.py:293-332)
        output = None
        for chunk in model.generate(audio, stream=True, **gen_kwargs):
            if isinstance(chunk, str):
                chunk = STTOutput(text=chunk)
            if verbose and chunk.text:
                print(chunk.text, end="", flush=True)
            if output is None:
                output = chunk
            else:
                output.text = (output.text or "") + (chunk.text or "")
                if chunk.segments:
                    segs = list(output.segments or [])
                    segs.extend(chunk.segments)
                    output.segments = segs
                output.generation_tokens = getattr(
                    chunk, "generation_tokens", 0) or \
                    output.generation_tokens
        if verbose:
            print()
        if output is None:
            raise RuntimeError("streaming generate yielded no output")
    else:
        output = model.generate(audio, **gen_kwargs)
    wall = time.time() - start

    if verbose:
        print("=" * 10)
        print(output.text.strip())
        print("=" * 10)
        print(f"Language: {output.language}")
        print(f"Prompt: {output.prompt_tokens} tokens, "
              f"{output.prompt_tps:.2f} tokens-per-sec")
        print(f"Generation: {output.generation_tokens} tokens, "
              f"{output.generation_tps:.2f} tokens-per-sec")
        print(f"Total time: {wall:.2f}s")

    if output_path is not None:
        fmt = format.lower()
        if fmt not in _WRITERS:
            raise ValueError(
                f"Unsupported output format: {format} "
                f"(choose from {sorted(_WRITERS)})")
        path = Path(output_path)
        if path.suffix == "":
            path = path / f"transcription.{fmt}"
        path.parent.mkdir(parents=True, exist_ok=True)
        _WRITERS[fmt](output, path)
        if verbose:
            print(f"✅ Transcription saved to {path}")
    return output


def parse_args(argv=None):
    import json

    # dash-style names match the reference CLI (stt/generate.py:22-110);
    # underscore forms are accepted as aliases
    parser = argparse.ArgumentParser(description="Transcribe audio to text")
    parser.add_argument("--model", type=str,
                        default="mlx-community/whisper-large-v3-turbo")
    parser.add_argument("--audio", type=str, required=True)
    parser.add_argument("--output-path", "--output_path",
                        dest="output_path", type=str, default=None)
    parser.add_argument("--format", type=str, default="txt",
                        choices=["txt", "srt", "vtt", "json"])
    parser.add_argument("--language", type=str, default=None)
    parser.add_argument("--task", type=str, default="transcribe",
                        choices=["transcribe", "translate"])
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--initial-prompt", "--initial_prompt",
                        dest="initial_prompt", type=str, default=None)
    parser.add_argument("--word-timestamps", "--word_timestamps",
                        dest="word_timestamps", action="store_true")
    parser.add_argument("--max-tokens", "--max_tokens", dest="max_tokens",
                        type=int, default=None,
                        help="Maximum number of new tokens to generate")
    parser.add_argument("--max-parallel-segments", dest="batch_size",
                        type=int, default=None, metavar="SEGMENTS",
                        help="Parallel segment batching for models that "
                             "support it")
    parser.add_argument("--chunk-duration", "--chunk_duration",
                        dest="chunk_duration", type=float, default=None,
                        help="Chunk duration in seconds")
    parser.add_argument("--frame-threshold", "--frame_threshold",
                        dest="frame_threshold", type=int, default=None)
    parser.add_argument("--stream", action="store_true",
                        help="Stream the transcription as it is generated")
    parser.add_argument("--context", type=str, default=None,
                        help="Hotwords/metadata context string")
    parser.add_argument("--prefill-step-size", "--prefill_step_size",
                        dest="prefill_step_size", type=int, default=None)
    parser.add_argument("--prompt", type=str, default=None,
                        help="Custom prompt for prompt-driven models")
    parser.add_argument("--gen-kwargs", "--gen_kwargs", dest="gen_kwargs",
                        type=json.loads, default=None,
                        help='Additional generate kwargs as JSON')
    parser.add_argument("--text", type=str, default="",
                        help="Text to align (forced alignment models)")
    parser.add_argument("--verbose", action=argparse.BooleanOptionalAction,
                        default=True)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    generate_transcription(
        model_path=args.model,
        audio=args.audio,
        output_path=args.output_path,
        format=args.format,
        language=args.language,
        task=args.task,
        temperature=args.temperature,
        initial_prompt=args.initial_prompt,
        word_timestamps=args.word_timestamps or None,
        max_tokens=args.max_tokens,
        batch_size=args.batch_size,
        chunk_duration=args.chunk_duration,
        frame_threshold=args.frame_threshold,
        stream=args.stream,
        context=args.context,
        prefill_step_size=args.prefill_step_size,
        prompt=args.prompt,
        gen_kwargs=args.gen_kwargs,
        text=args.text,
        verbose=args.verbose,
    )


if __name__ == "__main__":
    main()
