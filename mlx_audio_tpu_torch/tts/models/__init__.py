"""TTS model families of the port (so far: kokoro, qwen3_tts, higgs_audio,
kugelaudio, vibevoice, and the llama backbone of the last two)."""
