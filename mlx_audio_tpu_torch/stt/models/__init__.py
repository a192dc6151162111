"""STT model families of the port (so far: whisper)."""
