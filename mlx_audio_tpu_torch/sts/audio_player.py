"""Output-stream player with playback state + echo correlation.

The port's copy of mlx_audio_tpu/sts/audio_player.py (host numpy, no
departure; `playback_state` and `echo_correlation` :78-137 give the same
numbers on the same inputs). The reference it mirrors is mlx-audio's
sts/audio_player.py (345 LoC): an output
queue that records what was actually played (timestamped history ring) so
the voice pipeline can (a) know whether TTS audio is in flight and (b)
correlate suspected barge-in input against its own recent output to reject
acoustic echo (reference voice_pipeline.py:544-565,711).

Headless-first: playback is modeled as explicit `fetch_chunk()` pulls (the
server/speaker callback), each stamped on an injectable clock so tests are
deterministic; a sounddevice sink can wrap this without changing the
bookkeeping.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np


class AudioOutputStream:
    def __init__(self, sample_rate: int, history_seconds: float = 12.0,
                 clock: Optional[Callable[[], float]] = None):
        self.sample_rate = sample_rate
        self.history_seconds = history_seconds
        self.clock = clock or time.monotonic
        self._queue: "queue.Queue[np.ndarray]" = queue.Queue()
        self.history_lock = threading.Lock()
        # list of (start_ms, chunk) in playback order
        self.output_history: List[Tuple[float, np.ndarray]] = []
        self._buffered = 0
        self._last_output_ms: Optional[float] = None

    # -- producer ------------------------------------------------------------

    def queue_audio(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, np.float32).reshape(-1)
        if samples.size == 0:
            return
        self._queue.put(samples)
        self._buffered += samples.size

    # -- consumer (speaker callback / server pull) ----------------------------

    def fetch_chunk(self, timeout: float = 0.0) -> Optional[np.ndarray]:
        """Pull the next chunk and mark it as played now."""
        try:
            chunk = (self._queue.get(timeout=timeout) if timeout
                     else self._queue.get_nowait())
        except queue.Empty:
            return None
        self._buffered -= chunk.size
        now_ms = self.clock() * 1000.0
        with self.history_lock:
            self.output_history.append((now_ms, chunk))
            self._last_output_ms = now_ms + chunk.size / self.sample_rate \
                * 1000.0
            cutoff = now_ms - self.history_seconds * 1000.0
            self.output_history = [
                (s, c) for s, c in self.output_history
                if s + c.size / self.sample_rate * 1000.0 >= cutoff]
        return chunk

    def stop(self) -> None:
        try:
            while True:
                chunk = self._queue.get_nowait()
                self._buffered -= chunk.size
        except queue.Empty:
            pass

    # -- state ----------------------------------------------------------------

    def playback_state(self, now_ms: Optional[float] = None) -> dict:
        now_ms = self.clock() * 1000.0 if now_ms is None else now_ms
        last_age = (None if self._last_output_ms is None
                    else now_ms - self._last_output_ms)
        return {
            "player_enabled": True,
            "player_playing": self._buffered > 0 or (
                last_age is not None and last_age < 0),
            "sample_rate": self.sample_rate,
            "buffered_samples": max(self._buffered, 0),
            "buffered_ms": max(self._buffered, 0) / self.sample_rate * 1000.0,
            "last_output_age_ms": last_age,
        }

    # -- echo correlation -------------------------------------------------

    def echo_correlation(self, samples, *, input_sample_rate: int,
                         input_end_ms: float, min_delay_ms: float,
                         max_delay_ms: float, step_ms: float = 32.0) -> dict:
        """Best normalized correlation (raw or envelope) between `samples`
        and the output history shifted by candidate delays
        (reference sts/audio_player.py:203-259)."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        if samples.size < 8:
            return {"correlation": 0.0, "delay_ms": None, "method": None}
        duration_ms = samples.size / input_sample_rate * 1000.0
        best = {"correlation": 0.0, "delay_ms": None, "method": None}
        delay = float(min_delay_ms)
        while delay <= max_delay_ms:
            out_end = input_end_ms - delay
            out = self._history_segment(out_end - duration_ms, out_end)
            if out is not None and out.size >= 8:
                out = _resample(out, samples.size)
                raw = _normalized_correlation(samples, out)
                env = _normalized_correlation(_envelope(samples),
                                              _envelope(out))
                corr = max(raw, env)
                if corr > best["correlation"]:
                    best = {"correlation": corr, "delay_ms": delay,
                            "method": "raw" if raw >= env else "envelope"}
            delay += step_ms
        return best

    def _history_segment(self, start_ms: float,
                         end_ms: float) -> Optional[np.ndarray]:
        pieces = []
        with self.history_lock:
            history = list(self.output_history)
        for c_start, chunk in history:
            c_end = c_start + chunk.size / self.sample_rate * 1000.0
            if c_end <= start_ms or c_start >= end_ms:
                continue
            i0 = max(0, int(round((start_ms - c_start) / 1000.0
                                  * self.sample_rate)))
            i1 = min(chunk.size, int(round((end_ms - c_start) / 1000.0
                                           * self.sample_rate)))
            if i1 > i0:
                pieces.append(chunk[i0:i1])
        return np.concatenate(pieces) if pieces else None


def _resample(samples: np.ndarray, size: int) -> np.ndarray:
    if samples.size == size:
        return samples
    x_old = np.linspace(0.0, 1.0, samples.size)
    x_new = np.linspace(0.0, 1.0, size)
    return np.interp(x_new, x_old, samples).astype(np.float32)


def _envelope(samples: np.ndarray, win: int = 64) -> np.ndarray:
    mag = np.abs(samples)
    if mag.size < win:
        return mag
    kernel = np.ones(win, np.float32) / win
    return np.convolve(mag, kernel, mode="same")


def _normalized_correlation(a: np.ndarray, b: np.ndarray) -> float:
    a = a - a.mean()
    b = b - b.mean()
    denom = float(np.linalg.norm(a) * np.linalg.norm(b))
    if denom < 1e-9:
        return 0.0
    return float(np.clip(np.dot(a, b) / denom, -1.0, 1.0))


__all__ = ["AudioOutputStream"]
