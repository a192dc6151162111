"""NVIDIA FastConformer (counterpart of mlx_audio_tpu/stt/models/parakeet):
so far the shared encoder (`conformer.py`), which Cohere ASR runs; the
Parakeet models themselves are not ported yet."""
