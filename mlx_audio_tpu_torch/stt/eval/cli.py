"""`python -m mlx_audio_tpu_torch.stt.eval` — WER eval CLI.

The port's copy of mlx_audio_tpu/stt/eval/cli.py (reference
mlx_audio/stt/eval/cli.py, with --manifest for local jsonl/tsv datasets):

    python -m mlx_audio_tpu_torch.stt.eval --manifest data.jsonl \
        --model <local STT dir> --output-dir out

Departures: the model loads on `--device` (default the card), and
`--dataset-repo` names a local copy of the Seed-TTS eval set (the port
never downloads; a hub id raises).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

from .manifest import DEFAULT_DATASET_REPO, iter_samples_from_manifest
from .runner import SUPPORTED_METRICS, run_seed_tts_eval, run_stt_wer_eval


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Evaluate an STT model's WER on seed-tts or a local "
                    "manifest.")
    p.add_argument("--model", default="mlx-community/whisper-large-v3-turbo")
    p.add_argument("--manifest", default=None,
                   help="Local jsonl/tsv manifest (utt_id, audio_path, "
                        "text columns); overrides seed-tts streaming.")
    p.add_argument("--dataset-repo", default=DEFAULT_DATASET_REPO,
                   help="a local copy of the Seed-TTS eval set (en/meta.lst, "
                        "en/wavs/)")
    p.add_argument("--revision", default="main")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--language", default=None)
    p.add_argument("--gen-kwargs", type=json.loads, default=None,
                   help='JSON, e.g. \'{"temperature": 0}\'')
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--allow-missing-audio", action="store_true")
    p.add_argument("--metrics", nargs="+", default=["wer"],
                   choices=SUPPORTED_METRICS)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="the model's device (default: the card)")
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> None:
    args = parse_args(argv)
    common = dict(limit=args.limit, language=args.language,
                  gen_kwargs=args.gen_kwargs,
                  skip_existing=args.skip_existing, metrics=args.metrics,
                  verbose=args.verbose, device=args.device)
    if args.manifest:
        summary = run_stt_wer_eval(
            args.model, iter_samples_from_manifest(args.manifest),
            args.output_dir, dataset_name=args.manifest, **common)
    else:
        summary = run_seed_tts_eval(
            args.model, args.output_dir, dataset_repo=args.dataset_repo,
            revision=args.revision,
            fail_on_missing_audio=not args.allow_missing_audio, **common)
    print(json.dumps(summary, ensure_ascii=False, indent=2))


if __name__ == "__main__":
    main()
