"""TTS generation CLI + `generate_audio()` orchestration.

Counterpart of mlx_audio_tpu/tts/generate.py: the same flags, the same
stream/save/join matrix and output file naming, over the port's
`tts.utils.load_model`:

    python -m mlx_audio_tpu_torch.tts.generate --model <dir> \
        --text "Hello." --output_path out            # on the card
    python -m mlx_audio_tpu_torch.tts.generate --model <dir> \
        --text "Hello." --output_path out --device cpu

The model loads on `--device` (default the card; without CUDA it raises
unless given `--device cpu`). Left out: the JAX package's `maybe_profile`,
a `jax.profiler` trace hook around the call. `ref_audio` transcription
(`--stt_model`) loads the STT model on the same device.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np


def generate_audio(
    text: str,
    model_path: str = "prince-canuma/Kokoro-82M",
    model=None,
    voice: Optional[str] = None,
    speed: float = 1.0,
    lang_code: str = "a",
    file_prefix: str = "audio",
    audio_format: str = "wav",
    join_audio: bool = False,
    play: bool = False,
    verbose: bool = True,
    output_path: Optional[str] = None,
    ref_audio: Optional[str] = None,
    ref_text: Optional[str] = None,
    stt_model: Optional[str] = None,
    temperature: float = 0.7,
    top_p: float = 0.9,
    top_k: int = 50,
    repetition_penalty: float = 1.0,
    max_tokens: int = 1200,
    stream: bool = False,
    streaming_interval: float = 2.0,
    seed: Optional[int] = None,
    save: bool = False,
    device="cuda",
    **kwargs,
):
    """Load a TTS model onto `device` and synthesize `text`, writing
    segments.

    Returns the list of GenerationResult objects.
    """
    from .. import audio_io
    from .utils import load_model

    if model is None:
        if verbose:
            print(f"Loading model: {model_path}")
        model = load_model(model_path, device=device)

    gen_kwargs = dict(
        voice=voice,
        speed=speed,
        lang_code=lang_code,
    )
    # only forward sampler knobs to models that take them
    import inspect

    sig_params = inspect.signature(model.generate).parameters

    # normalize ref_audio path -> waveform; auto-transcribe missing ref_text
    if isinstance(ref_audio, (str, Path)):
        from ..utils import load_audio

        ref_audio = load_audio(str(ref_audio),
                               sample_rate=model.sample_rate)
        if ref_text is None and "ref_text" in sig_params:
            if stt_model is None:
                raise ValueError(
                    "stt_model must be provided when ref_text is missing "
                    "(used to transcribe ref_audio)")
            if verbose:
                print("Ref_text not found. Transcribing ref_audio...")
            if isinstance(stt_model, str):
                from ..stt.utils import load_model as load_stt

                stt_model = load_stt(stt_model, device=device)
            ref_text = stt_model.generate(ref_audio).text
            if verbose:
                print(f"Ref_text: {ref_text}")
    has_var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                     for p in sig_params.values())
    candidates = dict(
        temperature=temperature, top_p=top_p, top_k=top_k,
        repetition_penalty=repetition_penalty, max_tokens=max_tokens,
        ref_audio=ref_audio, ref_text=ref_text, stream=stream,
        streaming_interval=streaming_interval, seed=seed,
    )
    # model-specific knobs (prompt,
    # instruct, exaggeration, cfg_scale, ddpm_steps, gen_duration, steps,
    # stg_*, gender, pitch, sigma, min_p, ...) ride the same
    # signature-filtered forwarding: anything the model's generate() does
    # not accept is dropped here, never crashing a foreign checkpoint.
    candidates.update(kwargs)
    for k, v in candidates.items():
        if v is not None and (has_var_kw or k in sig_params):
            gen_kwargs[k] = v
    if gen_kwargs.get("voice") is None:
        gen_kwargs.pop("voice", None)

    out_dir = Path(output_path) if output_path else Path(".")
    out_dir.mkdir(parents=True, exist_ok=True)

    if play:
        print("Warning: --play requires an audio output device; "
              "falling back to file output.", file=sys.stderr)

    results = []
    segments = []
    sample_rate = None
    for result in model.generate(text, **gen_kwargs):
        results.append(result)
        sample_rate = result.sample_rate
        audio = np.asarray(result.audio)
        segments.append(audio)
        if verbose:
            print("=" * 10)
            print(f"Segment {result.segment_idx}: {result.samples} "
                  f"samples, {result.audio_duration}")
            print(f"Prompt: {result.prompt['tokens']} tokens, "
                  f"{result.prompt['tokens-per-sec']} tokens-per-sec")
            print(f"Audio: {result.audio_samples['samples']} samples, "
                  f"{result.audio_samples['samples-per-sec']} "
                  f"samples-per-sec")
            print(f"Real-time factor: {result.real_time_factor:.2f}x")
            print(f"Processing time: "
                  f"{result.processing_time_seconds:.2f}s")
            print(f"Peak memory: {result.peak_memory_usage:.2f}GB")
        # non-stream runs always write; streaming runs write only with
        # --save
        if not join_audio and (save or not stream):
            fname = out_dir / (f"{file_prefix}_"
                               f"{result.segment_idx:03d}.{audio_format}")
            audio_io.write(fname, audio, result.sample_rate,
                           format=audio_format)
            if verbose:
                print(f"✅ Audio saved to {fname}")

    if join_audio and segments:
        joined = np.concatenate(segments)
        fname = out_dir / f"{file_prefix}.{audio_format}"
        audio_io.write(fname, joined, sample_rate, format=audio_format)
        if verbose:
            print(f"✅ Joined audio saved to {fname}")
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Generate speech from text")
    parser.add_argument("--model", type=str, default="prince-canuma/Kokoro-82M",
                        help="Local model directory")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device the model loads onto (default: cuda)")
    parser.add_argument("--text", type=str, default=None, help="Text to synthesize")
    parser.add_argument("--voice", type=str, default=None)
    parser.add_argument("--speed", type=float, default=1.0)
    parser.add_argument("--lang_code", type=str, default="a")
    parser.add_argument("--file_prefix", type=str, default="audio")
    parser.add_argument("--audio_format", type=str, default="wav")
    parser.add_argument("--join_audio", action="store_true")
    parser.add_argument("--play", action="store_true")
    parser.add_argument("--output_path", type=str, default=None)
    parser.add_argument("--ref_audio", type=str, default=None)
    parser.add_argument("--ref_text", type=str, default=None)
    parser.add_argument("--stt_model", type=str, default=None)
    parser.add_argument("--temperature", type=float, default=0.7)
    parser.add_argument("--top_p", type=float, default=0.9)
    parser.add_argument("--top_k", type=int, default=50)
    parser.add_argument("--repetition_penalty", type=float, default=1.0)
    parser.add_argument("--max_tokens", type=int, default=1200)
    parser.add_argument("--stream", action="store_true")
    parser.add_argument("--streaming_interval", type=float, default=2.0)
    parser.add_argument("--save", action="store_true",
                        help="Save streamed audio to a file (with --stream)")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--verbose", action=argparse.BooleanOptionalAction,
                        default=True)
    # model-specific knobs, forwarded only to models whose generate()
    # accepts them
    parser.add_argument("--prompt", type=str, default=None,
                        help="Optional model-specific prompt prefix")
    parser.add_argument("--instruct", type=str, default=None,
                        help="CustomVoice/VoiceDesign instruction")
    parser.add_argument("--exaggeration", type=float, default=None,
                        help="Voice exaggeration factor (chatterbox)")
    parser.add_argument("--cfg_scale", type=float, default=None,
                        help="Classifier-free guidance scale")
    parser.add_argument("--ddpm_steps", type=int, default=None,
                        help="Diffusion step override")
    parser.add_argument("--gen_duration", type=float, default=None,
                        help="Model-specific generation duration (s)")
    parser.add_argument("--duration_multiplier", type=float, default=None)
    parser.add_argument("--steps", type=int, default=None,
                        help="Model-specific generation step count")
    parser.add_argument("--stg_scale", type=float, default=None,
                        help="Spatiotemporal guidance scale (dramabox)")
    parser.add_argument("--stg_block", type=int, default=None)
    parser.add_argument("--rescale_scale", type=float, default=None,
                        help="CFG rescale value")
    parser.add_argument("--gender", type=str, default=None,
                        help="Voice gender [male, female] (spark)")
    parser.add_argument("--pitch", type=float, default=None,
                        help="Voice pitch (spark)")
    parser.add_argument("--sigma", type=float, default=None,
                        help="Model-specific sigma (bailingmm)")
    parser.add_argument("--use_zero_spk_emb", action="store_true",
                        help="Zero speaker embedding mode (bailingmm)")
    parser.add_argument("--min_p", type=float, default=None,
                        help="Min-p sampling threshold")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    text = args.text
    if text is None:
        if not sys.stdin.isatty():
            text = sys.stdin.read().strip()
        else:
            text = "Hello from the audio framework."
    generate_audio(
        text=text,
        model_path=args.model,
        device=args.device,
        voice=args.voice,
        speed=args.speed,
        lang_code=args.lang_code,
        file_prefix=args.file_prefix,
        audio_format=args.audio_format,
        join_audio=args.join_audio,
        play=args.play,
        output_path=args.output_path,
        ref_audio=args.ref_audio,
        ref_text=args.ref_text,
        stt_model=args.stt_model,
        temperature=args.temperature,
        top_p=args.top_p,
        top_k=args.top_k,
        repetition_penalty=args.repetition_penalty,
        max_tokens=args.max_tokens,
        stream=args.stream,
        streaming_interval=args.streaming_interval,
        seed=args.seed,
        save=args.save,
        verbose=args.verbose,
        prompt=args.prompt,
        instruct=args.instruct,
        exaggeration=args.exaggeration,
        cfg_scale=args.cfg_scale,
        ddpm_steps=args.ddpm_steps,
        gen_duration=args.gen_duration,
        duration_multiplier=args.duration_multiplier,
        steps=args.steps,
        stg_scale=args.stg_scale,
        stg_block=args.stg_block,
        rescale_scale=args.rescale_scale,
        gender=args.gender,
        pitch=args.pitch,
        sigma=args.sigma,
        use_zero_spk_emb=args.use_zero_spk_emb or None,
        min_p=args.min_p,
    )


if __name__ == "__main__":
    main()
