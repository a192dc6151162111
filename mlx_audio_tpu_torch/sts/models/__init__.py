"""STS model families of the port: moshi, mel_roformer and
deepfilternet."""
