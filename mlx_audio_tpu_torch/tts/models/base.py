"""TTS result schema and shared helpers (counterpart of
mlx_audio_tpu/tts/models/base.py)."""

from __future__ import annotations

from dataclasses import dataclass

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
