"""Audio codecs of the port (counterpart of mlx_audio_tpu/codec)."""
