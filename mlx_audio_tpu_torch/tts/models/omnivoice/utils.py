"""OmniVoice reference-audio preprocessing (host-side numpy).

The port's own copy of mlx_audio_tpu/tts/models/omnivoice/utils.py:
pydub-compatible silence detection and removal, long-audio trimming at the
widest silence gap, an RMS boost, and `create_voice_clone_prompt`, which
encodes the cleaned reference through the HiggsAudio codec. It reads audio
through the port's `audio_io` and resamples with the port's
`utils.resample_audio`; no other departure (tests/test_torch_omnivoice.py
holds the silence tools to the JAX package's).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _dur_ms(n: int, sr: int) -> int:
    return round(1000 * (n / sr))


def _to_sample(ms: int, sr: int) -> int:
    return int(ms * (sr / 1000.0))


def _window_rms(pcm: np.ndarray, start_ms: int, end_ms: int,
                sr: int) -> float:
    a, b = _to_sample(start_ms, sr), min(len(pcm), _to_sample(end_ms, sr))
    if b <= a:
        return 0.0
    w = pcm[a:b].astype(np.float64)
    return float(np.sqrt(np.mean(w * w)))


def detect_silent_ranges_ms(audio: np.ndarray, sr: int,
                            min_silence_len: int = 1000,
                            silence_thresh: float = -16.0,
                            seek_step: int = 1
                            ) -> List[Tuple[int, int]]:
    """pydub.silence.detect_silence semantics on mono float audio."""
    seg_len = _dur_ms(len(audio), sr)
    if seg_len < min_silence_len:
        return []
    pcm = (np.asarray(audio, np.float32) * 32767.0).clip(-32768, 32767)
    threshold = (10 ** (silence_thresh / 20.0)) * 32768.0

    starts = []
    last = seg_len - min_silence_len
    steps = list(range(0, last + 1, seek_step))
    if last % seek_step:
        steps.append(last)
    for s in steps:
        if _window_rms(pcm, s, s + min_silence_len, sr) <= threshold:
            starts.append(s)
    if not starts:
        return []

    ranges = []
    prev = starts.pop(0)
    cur_start = prev
    for s in starts:
        continuous = s == prev + seek_step
        has_gap = s > prev + min_silence_len
        if not continuous and has_gap:
            ranges.append((cur_start, prev + min_silence_len))
            cur_start = s
        prev = s
    ranges.append((cur_start, prev + min_silence_len))
    return ranges


def detect_nonsilent_ranges_ms(audio: np.ndarray, sr: int,
                               min_silence_len: int = 1000,
                               silence_thresh: float = -16.0,
                               seek_step: int = 1
                               ) -> List[Tuple[int, int]]:
    seg_len = _dur_ms(len(audio), sr)
    if seg_len == 0:
        return []
    silent = detect_silent_ranges_ms(audio, sr, min_silence_len,
                                     silence_thresh, seek_step)
    if not silent:
        return [(0, seg_len)]
    if silent[0] == (0, seg_len):
        return []
    out, prev_end = [], 0
    for a, b in silent:
        out.append((prev_end, a))
        prev_end = b
    if silent[-1][1] != seg_len:
        out.append((prev_end, seg_len))
    if out and out[0] == (0, 0):
        out.pop(0)
    return out


def _split_on_silence_ranges_ms(audio, sr, min_silence_len=1000,
                                silence_thresh=-16.0, keep_silence=100,
                                seek_step=1):
    if isinstance(keep_silence, bool):
        keep_silence = _dur_ms(len(audio), sr) if keep_silence else 0
    ranges = [(a - keep_silence, b + keep_silence)
              for a, b in detect_nonsilent_ranges_ms(
                  audio, sr, min_silence_len, silence_thresh, seek_step)]
    for i in range(len(ranges) - 1):
        if ranges[i + 1][0] < ranges[i][1]:
            mid = (ranges[i][1] + ranges[i + 1][0]) // 2
            ranges[i] = (ranges[i][0], mid)
            ranges[i + 1] = (mid, ranges[i + 1][1])
    seg_len = _dur_ms(len(audio), sr)
    return [(max(a, 0), min(b, seg_len)) for a, b in ranges]


def _slice_ms(audio: np.ndarray, sr: int, a: int, b: int) -> np.ndarray:
    return np.asarray(
        audio[max(0, _to_sample(a, sr)):min(len(audio), _to_sample(b, sr))],
        np.float32)


def remove_silence(audio: np.ndarray, sr: int, mid_sil: int = 300,
                   lead_sil: int = 100, trail_sil: int = 300) -> np.ndarray:
    out = np.asarray(audio, np.float32)
    if mid_sil > 0:
        ranges = _split_on_silence_ranges_ms(
            out, sr, min_silence_len=mid_sil, silence_thresh=-50,
            keep_silence=mid_sil, seek_step=10)
        if not ranges:
            return out[:0]
        out = np.concatenate([_slice_ms(out, sr, a, b) for a, b in ranges])
    ranges = detect_nonsilent_ranges_ms(out, sr, min_silence_len=1,
                                        silence_thresh=-50)
    if ranges:
        a = max(0, ranges[0][0] - lead_sil)
        b = min(_dur_ms(len(out), sr), ranges[-1][1] + trail_sil)
        out = _slice_ms(out, sr, a, b)
    return out


def trim_long_audio(audio: np.ndarray, sr: int, max_duration: float = 15.0,
                    trim_threshold: float = 20.0) -> np.ndarray:
    if len(audio) / sr <= trim_threshold:
        return np.asarray(audio, np.float32)
    ranges = detect_nonsilent_ranges_ms(audio, sr, min_silence_len=100,
                                        silence_thresh=-40, seek_step=10)
    if not ranges:
        return np.asarray(audio, np.float32)
    max_ms = int(max_duration * 1000)
    best = 0
    for a, b in ranges:
        if best < a <= max_ms:
            best = a
        if b > max_ms:
            break
    if best < 3000:
        best = min(max_ms, _dur_ms(len(audio), sr))
    return _slice_ms(audio, sr, 0, best)


def create_voice_clone_prompt(ref_audio_path: str, tokenizer=None,
                              ref_text: Optional[str] = None,
                              preprocess: bool = True,
                              max_duration_s: float = 15.0) -> np.ndarray:
    """Clean + encode reference audio -> (T', 8) codes (ref utils.py:221)."""
    if tokenizer is None:
        return np.zeros((0, 8), np.int32)
    path = Path(ref_audio_path)
    if not path.exists():
        raise FileNotFoundError(f"Reference audio not found: "
                                f"{ref_audio_path}")
    from ....audio_io import read as audio_read
    from ....utils import resample_audio

    audio, sr = audio_read(str(path), dtype="float32", always_2d=True)
    mono = np.asarray(audio).mean(axis=1).astype(np.float32)
    if sr != 24000:
        mono = np.asarray(resample_audio(mono, sr, 24000), np.float32)
    sr = 24000
    if preprocess:
        rms = float(np.sqrt(np.mean(mono ** 2))) if len(mono) else 0.0
        if 0 < rms < 0.1:
            mono = mono * (0.1 / rms)
        if ref_text is None:
            mono = trim_long_audio(mono, sr, max_duration=max_duration_s)
        elif len(mono) / sr > 20.0:
            logger.warning("Reference audio >20s with ref_text; skipping "
                           "automatic trimming.")
        mono = remove_silence(mono, sr)
    return np.asarray(tokenizer.encode(mono), np.int32)
