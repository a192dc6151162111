"""The WER eval harness of the port: `python -m mlx_audio_tpu_torch.stt.eval
--manifest <file> --model <dir>` transcribes a local manifest with any of
the port's STT families and scores it (counterpart of
mlx_audio_tpu/stt/eval)."""

from .manifest import (iter_samples_from_manifest, iter_samples_from_rows,
                       iter_seed_tts_english_samples,
                       parse_seed_tts_meta_line, sample_from_row)
from .normalize import normalize_for_wer
from .runner import SUPPORTED_METRICS, run_seed_tts_eval, run_stt_wer_eval
from .schema import STTEvalSample
from .wer import WERResult, aggregate_wer, compute_wer

__all__ = [
    "STTEvalSample", "SUPPORTED_METRICS", "WERResult", "aggregate_wer",
    "compute_wer", "iter_samples_from_manifest", "iter_samples_from_rows",
    "iter_seed_tts_english_samples", "normalize_for_wer",
    "parse_seed_tts_meta_line", "run_seed_tts_eval", "run_stt_wer_eval",
    "sample_from_row",
]
