"""STT model families of the port: whisper, voxtral_realtime and
cohere_asr, with the shared parakeet encoder and canary decoder."""
