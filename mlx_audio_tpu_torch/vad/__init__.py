"""Voice-activity detection of the port (counterpart of mlx_audio_tpu/vad)."""
