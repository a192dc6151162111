"""Audio codecs of the port (counterpart of mlx_audio_tpu/codec). `SNAC` is
exported as in the JAX package's codec/__init__.py (:6), `Mimi` lazily
(:13-30)."""

from .models.snac import SNAC

__all__ = ["SNAC"]


def __getattr__(name):
    if name == "Mimi":
        from .models.mimi import Mimi

        return Mimi
    raise AttributeError(name)
