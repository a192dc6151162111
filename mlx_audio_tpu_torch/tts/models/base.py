"""TTS result schema and shared helpers (counterpart of
mlx_audio_tpu/tts/models/base.py)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch


def format_duration(seconds: float) -> str:
    hours = int(seconds // 3600)
    mins = int((seconds % 3600) // 60)
    secs = int(seconds % 60)
    ms = int((seconds % 1) * 1000)
    return f"{hours:02d}:{mins:02d}:{secs:02d}.{ms:03d}"


def peak_memory_gb() -> float:
    """Peak CUDA memory allocated by PyTorch on the current device, in GB
    (0.0 without CUDA)."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / 1e9


def local_tokenizer(model_path, **kwargs):
    """The HF tokenizer saved in `model_path`, never downloaded: None when
    the directory holds no tokenizer files or `transformers` is not
    installed; any other failure to read the files raises. `kwargs` go to
    `AutoTokenizer.from_pretrained` (`trust_remote_code=True` for a
    tokenizer whose code is in the directory)."""
    path = Path(model_path)
    if not any((path / f).exists() for f in (
            "tokenizer.json", "tokenizer_config.json", "tokenizer.model")):
        return None
    try:
        from transformers import AutoTokenizer
    except ImportError:
        return None
    return AutoTokenizer.from_pretrained(str(path), **kwargs)


@dataclass
class GenerationResult:
    audio: np.ndarray
    samples: int
    sample_rate: int
    segment_idx: int
    token_count: int
    audio_duration: str
    real_time_factor: float
    prompt: dict
    audio_samples: dict
    processing_time_seconds: float
    peak_memory_usage: float
    is_streaming_chunk: bool = False
    is_final_chunk: bool = False


@dataclass
class BatchGenerationResult:
    audio: np.ndarray
    sequence_idx: int
    samples: int
    sample_rate: int
    token_count: int
    audio_duration: str
    processing_time_seconds: float
    peak_memory_usage: float
    is_streaming_chunk: bool = False
    is_final_chunk: bool = False
