"""Persistent named reference-voice store for cloning-capable TTS.

The port's own copy of mlx_audio_tpu/voice_store.py, on the port's
`audio_io` (the port imports nothing of the JAX package): voices are named
WAVs + metadata persisted server-side, replayable over HTTP, and
referenced from any TTS/cloning request as ``ref_audio: "voice:<name>"``
so clients never re-upload reference audio.

Layout: ``$MLX_AUDIO_VOICE_DIR`` (default
``~/.cache/mlx_audio_tpu/voices``) holds ``<name>.wav`` + ``<name>.json``
({name, ref_text, sample_rate, duration_s, created}).
"""

from __future__ import annotations

import json
import os
import re
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import audio_io

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9 _.-]{0,63}$")
VOICE_PREFIX = "voice:"


def default_voice_dir() -> Path:
    env = os.environ.get("MLX_AUDIO_VOICE_DIR")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "mlx_audio_tpu" / "voices"


class VoiceStoreError(ValueError):
    """Invalid name / missing voice — maps to a 4xx response."""


class VoiceStore:
    def __init__(self, root: Optional[os.PathLike] = None):
        self.root = Path(root) if root else default_voice_dir()

    # -- helpers -------------------------------------------------------------

    def _check(self, name: str) -> str:
        if not isinstance(name, str) or not _NAME_RE.match(name):
            raise VoiceStoreError(
                "voice name must be 1-64 chars of letters, digits, "
                "space, '_', '.', '-' and start alphanumeric")
        return name

    def wav_path(self, name: str) -> Path:
        return self.root / f"{self._check(name)}.wav"

    def _meta_path(self, name: str) -> Path:
        return self.root / f"{self._check(name)}.json"

    # -- CRUD ----------------------------------------------------------------

    def save(self, name: str, wav: np.ndarray, sample_rate: int,
             ref_text: Optional[str] = None) -> Dict:
        self._check(name)
        wav = np.asarray(wav, np.float32)
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
        if wav.size < int(0.05 * sample_rate):
            raise VoiceStoreError("reference audio too short (<50 ms)")
        self.root.mkdir(parents=True, exist_ok=True)
        audio_io.write(str(self.wav_path(name)), wav, sample_rate)
        meta = {
            "name": name,
            "ref_text": ref_text or None,
            "sample_rate": int(sample_rate),
            "duration_s": round(wav.size / sample_rate, 3),
            "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        self._meta_path(name).write_text(json.dumps(meta, indent=1))
        return meta

    def list(self) -> List[Dict]:
        if not self.root.is_dir():
            return []
        out = []
        for f in sorted(self.root.glob("*.wav")):
            mp = f.with_suffix(".json")
            if mp.is_file():
                try:
                    out.append(json.loads(mp.read_text()))
                    continue
                except (json.JSONDecodeError, OSError):
                    pass
            out.append({"name": f.stem})
        return out

    def meta(self, name: str) -> Dict:
        mp = self._meta_path(name)
        if not mp.is_file():
            if self.wav_path(name).is_file():
                return {"name": name}
            raise VoiceStoreError(f"no saved voice named {name!r}")
        return json.loads(mp.read_text())

    def load(self, name: str, sample_rate: Optional[int] = None
             ) -> np.ndarray:
        """Read the stored waveform, resampled to `sample_rate` if given."""
        p = self.wav_path(name)
        if not p.is_file():
            raise VoiceStoreError(f"no saved voice named {name!r}")
        wav, sr = audio_io.read(str(p), dtype="float32")
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
        if sample_rate and sr != sample_rate:
            from .utils import resample_audio

            wav = np.asarray(resample_audio(wav, sr, sample_rate))
        return wav

    def delete(self, name: str) -> bool:
        found = False
        for p in (self.wav_path(name), self._meta_path(name)):
            if p.is_file():
                p.unlink()
                found = True
        return found

    # -- request resolution ----------------------------------------------------

    def resolve_ref(self, value) -> Optional[str]:
        """``"voice:<name>"`` -> stored voice name, else None."""
        if isinstance(value, str) and value.startswith(VOICE_PREFIX):
            return value[len(VOICE_PREFIX):]
        return None


__all__ = ["VoiceStore", "VoiceStoreError", "VOICE_PREFIX",
           "default_voice_dir"]
