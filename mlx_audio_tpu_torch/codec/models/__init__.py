"""Codec families ported so far: `higgs_audio` (the Higgs Audio v2
acoustic tokenizer), `mimi` (Moshi's streaming codec, shared by
Qwen3-TTS's reference encoder, Sesame CSM and Pocket-TTS), `snac`
(Orpheus, VyvoTTS), `descript` (the DAC under OuteTTS), `encodec`, the
`ecapa_tdnn` backbone (ECAPA LID) and `dacvae` (SAM-Audio's codec)."""
