"""Realtime audio playback with arrival-rate-adaptive buffering.

The port's copy of mlx_audio_tpu/tts/audio_player.py (host numpy, no
departure; `sounddevice` imported when a player is made, as there). The
reference it mirrors is mlx-audio's tts/audio_player.py:9-143: a sounddevice
callback player that estimates the incoming sample rate with an EMA and
holds >= a minimum buffer before starting playback. `sounddevice` is an
optional dependency (absent on headless servers); without it the player
degrades to a buffer sink usable in tests and the audio is retrievable via
`drain()`.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np


class AudioPlayer:
    def __init__(self, sample_rate: int = 24000, buffer_size: int = 2048,
                 min_buffer_seconds: float = 1.5, verbose: bool = False):
        self.sample_rate = sample_rate
        self.buffer_size = buffer_size
        self.min_buffer_seconds = min_buffer_seconds
        self.verbose = verbose
        self.audio_buffer = np.zeros(0, np.float32)
        self.buffer_lock = threading.Lock()
        self.playing = False
        self.drained: List[np.ndarray] = []
        self._arrival_rate = None  # EMA of samples/sec arriving
        self._last_arrival = None
        self._stream = None
        try:
            import sounddevice as sd

            self._sd = sd
        except ImportError:
            self._sd = None

    # -- arrival-rate model (reference audio_player.py:10-27) ---------------

    def _update_arrival_rate(self, n_samples: int) -> None:
        now = time.time()
        if self._last_arrival is not None:
            dt = max(now - self._last_arrival, 1e-4)
            rate = n_samples / dt
            self._arrival_rate = (rate if self._arrival_rate is None
                                  else 0.8 * self._arrival_rate + 0.2 * rate)
        self._last_arrival = now

    def _target_buffer(self) -> int:
        """Hold more buffer when generation is slower than realtime."""
        base = int(self.min_buffer_seconds * self.sample_rate)
        if self._arrival_rate and self._arrival_rate < self.sample_rate:
            deficit = self.sample_rate / max(self._arrival_rate, 1.0)
            base = int(base * min(deficit, 4.0))
        return base

    # -- playback -----------------------------------------------------------

    def queue_audio(self, samples) -> None:
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._update_arrival_rate(len(samples))
        with self.buffer_lock:
            self.audio_buffer = np.concatenate([self.audio_buffer, samples])
        if (not self.playing
                and len(self.audio_buffer) >= self._target_buffer()):
            self._start()

    def _callback(self, outdata, frames, time_info, status):
        with self.buffer_lock:
            n = min(frames, len(self.audio_buffer))
            out = self.audio_buffer[:n]
            self.audio_buffer = self.audio_buffer[n:]
        outdata[:n, 0] = out
        outdata[n:, 0] = 0.0

    def _start(self) -> None:
        self.playing = True
        if self._sd is None:
            return  # headless: act as a sink
        self._stream = self._sd.OutputStream(
            samplerate=self.sample_rate, channels=1,
            blocksize=self.buffer_size, callback=self._callback)
        self._stream.start()

    def wait_for_drain(self, timeout: float = 60.0) -> None:
        deadline = time.time() + timeout
        if self._sd is None:
            with self.buffer_lock:
                self.drained.append(self.audio_buffer)
                self.audio_buffer = np.zeros(0, np.float32)
            return
        while time.time() < deadline:
            with self.buffer_lock:
                if len(self.audio_buffer) == 0:
                    return
            time.sleep(0.05)

    def drain(self) -> np.ndarray:
        """Return and clear everything queued (headless test hook)."""
        with self.buffer_lock:
            parts = self.drained + [self.audio_buffer]
            self.drained = []
            self.audio_buffer = np.zeros(0, np.float32)
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)

    def stop(self) -> None:
        self.playing = False
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
            self._stream = None
