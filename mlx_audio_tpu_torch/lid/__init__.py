"""Spoken language identification of the port (counterpart of
mlx_audio_tpu/lid): ECAPA-TDNN (VoxLingua107) and wav2vec2 (MMS-LID),
loaded by `lid.utils.load_model`."""
