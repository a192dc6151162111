"""The studio UI: the port's own copy of mlx_audio_tpu/ui/.

A buildless static single-page app (vanilla ES modules, no npm
dependencies) for text-to-speech, speech-to-text (realtime included),
separation and the voice library, served by the port's server at `/`.
`static/` holds the JAX package's files unchanged.
"""

from pathlib import Path


def ui_static_dir() -> Path:
    """Directory holding the studio's static assets."""
    return Path(__file__).parent / "static"


__all__ = ["ui_static_dir"]
