"""Audio codecs of the port (counterpart of mlx_audio_tpu/codec). `Mimi` is
exported lazily, as in the JAX package's codec/__init__.py (:13-30)."""


def __getattr__(name):
    if name == "Mimi":
        from .models.mimi import Mimi

        return Mimi
    raise AttributeError(name)
