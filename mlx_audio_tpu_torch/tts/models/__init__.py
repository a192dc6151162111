"""TTS model families of the port (so far: kokoro, qwen3_tts, higgs_audio,
kugelaudio, vibevoice, sesame, and the llama backbone of the last
three)."""
