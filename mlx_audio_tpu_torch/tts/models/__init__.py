"""TTS model families of the port (so far: kokoro, qwen3_tts)."""
