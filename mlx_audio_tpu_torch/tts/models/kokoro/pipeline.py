"""KokoroPipeline: G2P + voice packs + segmentation.

Counterpart of mlx_audio_tpu/tts/models/kokoro/pipeline.py. G2P is `misaki`
when installed, else the built-in English rules of the port's `tts/g2p.py`
(its own copy of mlx_audio_tpu/tts/g2p.py). Voice packs are read from
`<model dir>/voices/<name>.safetensors` (when safetensors is installed) or
`<name>.npy`, and kept as float32 numpy arrays of shape (510, 1, 256).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Generator, Optional, Tuple

import numpy as np

LANG_CODES = {
    "a": "American English",
    "b": "British English",
    "e": "Spanish",
    "f": "French",
    "h": "Hindi",
    "i": "Italian",
    "j": "Japanese",
    "p": "Brazilian Portuguese",
    "z": "Mandarin Chinese",
}

MAX_PHONEMES = 510


def _try_misaki(lang_code: str):
    """A misaki G2P callable, or None when misaki is not installed."""
    try:
        if lang_code in ("a", "b"):
            from misaki import en

            g2p = en.G2P(trf=False, british=(lang_code == "b"), fallback=None)
            return lambda text: g2p(text)[0]
        from misaki import espeak

        g2p = espeak.EspeakG2P(language={
            "e": "es", "f": "fr-fr", "h": "hi", "i": "it", "p": "pt-br",
        }.get(lang_code, "en-us"))
        return lambda text: g2p(text)[0]
    except ImportError:
        return None


class KokoroPipeline:
    """Splits text, phonemizes, loads voice packs, synthesizes."""

    def __init__(self, model, repo_id: Optional[str] = None,
                 lang_code: str = "a"):
        self.model = model
        self.repo_id = repo_id
        self.lang_code = lang_code
        self.voices: Dict[str, np.ndarray] = {}
        self._misaki = _try_misaki(lang_code)
        if self._misaki is None and lang_code not in ("a", "b"):
            raise ValueError(
                f"Language '{lang_code}' ({LANG_CODES.get(lang_code)}) needs "
                "the optional `misaki`/`espeak` G2P packages, which are not "
                "installed. The built-in fallback G2P supports English only.")

    def phonemize(self, text: str) -> str:
        if self._misaki is not None:
            return self._misaki(text)
        from ...g2p import g2p

        return g2p(text)

    def _voice_dir(self) -> Optional[Path]:
        for base in (self.repo_id, getattr(self.model.config, "model_path", "")):
            if base and (Path(base) / "voices").exists():
                return Path(base) / "voices"
        return None

    def load_single_voice(self, voice: str) -> np.ndarray:
        if voice in self.voices:
            return self.voices[voice]
        vd = self._voice_dir()
        if vd is not None and (vd / f"{voice}.safetensors").exists():
            from safetensors import safe_open

            with safe_open(str(vd / f"{voice}.safetensors"),
                           framework="numpy") as f:
                key = "voice" if "voice" in f.keys() else list(f.keys())[0]
                pack = f.get_tensor(key)
        elif vd is not None and (vd / f"{voice}.npy").exists():
            pack = np.load(vd / f"{voice}.npy")
        else:
            raise FileNotFoundError(
                f"Voice '{voice}' not found under {vd} (expected "
                f"voices/{voice}.safetensors or voices/{voice}.npy)")
        pack = np.asarray(pack, dtype=np.float32)
        self.voices[voice] = pack
        return pack

    def load_voice(self, voice: str, delimiter: str = ",") -> np.ndarray:
        """Average comma-separated voices."""
        packs = [self.load_single_voice(v.strip())
                 for v in voice.split(delimiter)]
        if len(packs) == 1:
            return packs[0]
        return np.mean(np.stack(packs), axis=0)

    @staticmethod
    def split_segments(text: str, split_pattern: Optional[str]):
        if split_pattern:
            segs = [s.strip() for s in re.split(split_pattern, text.strip())]
            return [s for s in segs if s]
        return [text.strip()]

    @staticmethod
    def chunk_phonemes(ps: str, max_len: int = MAX_PHONEMES):
        """Split an over-long phoneme string at the last punctuation (else
        space) inside each max_len window."""
        if len(ps) <= max_len:
            return [ps]
        chunks = []
        while len(ps) > max_len:
            window = ps[:max_len]
            cut = -1
            for punct in ("!.?…", ":;", ",—"):
                matches = [m.end() for m in
                           re.finditer(f"[{re.escape(punct)}]", window)]
                if matches:
                    cut = matches[-1]
                    break
            if cut <= 0:
                cut = window.rfind(" ")
            if cut <= 0:
                cut = max_len
            chunks.append(ps[:cut].strip())
            ps = ps[cut:].strip()
        if ps:
            chunks.append(ps)
        return [c for c in chunks if c]

    def __call__(self, text: str, voice: str, speed: float = 1.0,
                 split_pattern: Optional[str] = r"\n+",
                 ) -> Generator[Tuple[str, str, np.ndarray], None, None]:
        pack = self.load_voice(voice)
        for segment in self.split_segments(text, split_pattern):
            for ps in self.chunk_phonemes(self.phonemize(segment)):
                n_ids = len(self.model.phonemes_to_ids(ps))
                if n_ids == 0:
                    continue
                ref_s = pack[min(n_ids - 1, pack.shape[0] - 1)].reshape(1, -1)
                audio, _ = self.model(ps, ref_s, speed=speed)
                yield segment, ps, audio
