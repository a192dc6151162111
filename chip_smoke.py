"""Drive the PyTorch port's main paths once on one GPU: Kokoro-82M text ->
audio; Qwen3-TTS text ids -> audio with an 8-bit quantized talker, one
request at a time (whole and streamed) and through the continuous-batching
session and its broker; Whisper large-v3-turbo speech -> text, through
`generate`, its streaming session, `load_model` and the STT CLI; and
Voxtral-Mini-3B-Realtime streaming speech -> text (the model behind the
server's /v1/realtime), through its live session, offline `generate`,
`load_model` and the STT CLI; Cohere ASR long-file speech -> text
(a FastConformer encoder and a Canary decoder), through `generate`,
`load_model` and the STT CLI; and Higgs Audio v2 text -> audio with its
acoustic codec, in bf16, in W8A8 (`qmatmul_i8`) and on an affine-q8
backbone (kernel K2), through its frame loop, `generate` and
`load_model`; and KugelAudio-7B text -> audio (a Qwen2.5-7B LM on the
llama backbone, an SDE-DPM-Solver++ diffusion head under classifier-free
guidance, the VibeVoice causal VAE decoder) in bf16, W8A8 and on an
affine-q8 LM (K2), and VibeVoice on the same stack, through `generate`
and `load_model`; and the OpenAI-style server's request core (the code
behind every route, without aiohttp): Kokoro speech from a checkpoint
loaded by directory through the `load_model` router, a burst of Qwen3-TTS
requests through the broker's continuous-batching session, a Whisper
transcription, and `/v1/realtime` with Silero's `server_vad` turn
detection over Voxtral Realtime; and voice cloning on the Mimi stack:
Qwen3-TTS by ICL (a reference clip's Mimi codes in the prompt) and by the
ECAPA x-vector, whole, streamed and through the server's voice library,
and Sesame CSM-1B cloning a reference segment, whole and streamed; and
the NeMo ASR families: Parakeet TDT 0.6B v2 (TDT, RNN-T and CTC decoding,
a long file in overlapping windows), Canary-1B-v2 and Nemotron ASR
(`generate` and `stream_generate`), through `generate`, `load_model`, the
STT CLI and the server's transcription route; and speech to speech: Moshi
(a full-duplex 7B LM over Mimi codes) in bf16 and on an affine-q8 LM
(kernel K2), Mel-Band-RoFormer vocal separation and DeepFilterNet3
enhancement, offline and streamed, through `generate`, `load_model`, the
STS CLI and the server's separation route; and MLX pre-quantized
checkpoints, the convert CLI, and Orpheus-3B text -> audio over SNAC 24
kHz, in bf16 and with every linear on kernel K2 in 4 bits, through
`load_model`, `generate` whole and streamed, and the TTS CLI; and the
Qwen3 LM families: Qwen3-ASR speech -> text (a chunked audio encoder and
a Qwen3 LM) in bf16 and with every linear on K2 in 8 bits, its forced
aligner and MegaASR (an audio-quality router and a LoRA adapter), and
VyvoTTS text -> audio over SNAC, through `load_model`, `generate`, the
STT and TTS CLIs and the server's transcription route; and the
LLM-decoder STT families: offline Voxtral-Mini-3B speech -> text (a
Whisper-style tower and a Mistral LM) in bf16 and with its LM on K2 in 8
bits, Qwen2-Audio-7B with its LM on K2 in 4 bits, GLM-ASR, Granite Speech
and VibeVoice-ASR's long-form encoders, through `load_model`, `generate`,
the STT CLI and the server's transcription route; and OuteTTS text ->
audio (a llama over descript's DAC) in bf16 and with every linear on K2
in 8 bits, Pocket-TTS (Kyutai's flow-matching TTS over Mimi latents),
EnCodec, MMS speech recognition and language ID by wav2vec2 (MMS-LID) and
ECAPA-TDNN, through `load_model`, `generate`, `predict` and the TTS and
STT CLIs. Each phase's functions log their seconds as `[step]` lines.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit. Phases, each of which raises on failure:

1. device: requires CUDA; prints the card's name and power limit; turns
   TF32 off for matmuls and cuDNN convolutions, so every f32 reference below
   is full f32.
2. build: compiles the hand-written kernels (csrc/snake_conv.cu, K1, and
   csrc/qmm.cu, K2) with nvcc into build/kernels/, one nvcc per source, all
   started together, and reports the seconds.
3. K1 vs plain: the fused AdaIN -> snake -> conv1d kernel against its
   plain PyTorch version at every (C, k, dilation) the generator runs
   (C in {256, 128} x k in {3, 7, 11} x dil in {1, 3, 5}), B=2 with ragged
   valid lengths, at the time lengths of a 1024-frame bucket, by each path:
   f32 on f32 x, wgmma (the dispatched bf16 path) and wmma (the first
   design) on bf16 x; relative error, device time per launch (CUDA graph
   replay, so the host's launch cost is left out), the plain version's
   time (CUDA events), and beside each bf16 shape its bound and the time of
   cuDNN `F.conv1d` alone on a precomputed bf16 h (a yardstick: the conv
   without the affine, snake and masks). wgmma must beat wmma at every
   shape. Then wgmma where alpha*u reaches about 1e4 (its reduced sine).
4. Kokoro main path at the published dims with seeded random weights.
   First a small-input check, fed the same durations: the CUDA path against
   the same seeded model on the CPU (plain versions) at f32, and the bf16
   CUDA decoder against that f32 CPU one. Then three `generate()` requests
   through the pipeline, the built-in G2P and a seeded .npy voice pack, in
   the default bf16, twice over (cold, then warm): audio length,
   finiteness, and 48 K1 launches per synth, all by the wgmma path.
5. K2 vs plain: the fused dequantize + matmul kernel against
   `qmatmul_reference` at every linear shape of the Qwen3-TTS slice,
   M in {1, 2, 8, 16, 64, 120} (8 and 16: the b = 8 session's decode
   frame), bits in {8, 4}, x in f32 and bf16, by every path of K2 that
   takes the case (gemv at M = 1, mma for bf16, the first design, simt,
   for all); relative error, median device time per launch over a
   rotation of weight copies larger than the L2 cache (replayed as one CUDA
   graph, so host launch cost is left out), GB/s and the byte bound; then
   one line per M > 1 path with its times summed over the shapes.
6. Qwen3-TTS checks: on a small config at f32 from one seeded weight set,
   the CUDA path against the CPU path (prefill logits, the greedy codes of
   one chunk, decode_full audio); at full dims, the q8 model's prefill
   logits with K2 against the same model through `qmatmul_reference`.
7. Qwen3-TTS main path at the published dims of the 1.7B lane (bench.py
   qwen3_tts_1b7), seeded random bf16 weights quantized to affine 8-bit
   (group 64): `generate(text_ids=...)` requests of 20 ids / 30 frames
   (cold; 60 until phases 58-61 came) and the JAX lane's 50 ids cut to 30 frames from its 100 (50
   until phases 41-44 came; cold; it ran warm too until phases 45-48
   came, the short one until phase 26 came): audio length and
   finiteness, and K2's launch count against the count the config gives
   for the steps that ran (722 per decode step; the model must hold
   exactly the quantized linears the config gives), and the decode steps
   against the chunk schedule with its early exit. (Until the streaming
   phases came, a third request of 120 ids / 200 frames ran here; it was
   dropped to keep the run's time.)
8. K2 (the dispatched path) vs plain at each (M, out, in) that phases 7,
   10, 11, 21, 24, 26, 28, 32, 33 and 35-39 launched it with, run after
   phase 40
   (the prefill bucket, the code predictor's first sub-step,
   text_projection over the text ids, the session's M = 8 and 16 decode
   frame and its burst prefill at M = 8 x 16, Higgs's four shapes at M = 1
   and 512, KugelAudio's five at M = 2 and 1,024, the ICL prefill at M =
   512, the small and the full Moshi's at M = 1, Qwen3-ASR's LM at M = 1
   and the prefill's 512, its tower at the windows' M = 416 and conv_out
   at 390, the small Qwen3 LM families' packed checkpoints),
   8-bit codes, x in f32 and bf16 (f32 at K =
   18,944 by the simt path's K tiles); then at 4-bit codes each shape
   phases 35-37 launched it with on 4-bit (or mixed 4/6-bit) weights:
   Orpheus-3B's seven at M = 1 and at the prefill's 128-row bucket, the
   small Orpheus's.
9. Qwen3-TTS streaming on the small config at f32 from one seeded q8
   weight set, its codec's biases drawn N(0, 0.1) (a trained checkpoint's
   are not zero), CUDA against the CPU path: the greedy streamed chunks
   (same chunk sizes, audio), `streaming_step` over uneven chunks against
   `decode_full` on the card (within 2e-4), and a greedy two-slot session
   with a request admitted mid-stream (same codes, audio; each request's
   audio within 2e-4 of `decode_full` of its codes).
10. Full dims q8, `generate(stream=True)`: the JAX lane's streamed request
   (`np.arange(100, 150)`, max_tokens cut to 30 from its 100 (50 until
   phases 41-44 came),
   streaming_interval 2.0, seed 1; bench.py:303-305), cold then warm: time to first audio, wall, xRT,
   chunks, reads and the host's wait in them, finite audio of whole
   frames, and K2's launches against the config's count.
11. Full dims q8, the continuous-batching session at b = 8 (bench.py:
   761-803: 20 frames, cut from its 100 (to 50, then to 20 to make room for
   phases 38-40), streaming_interval 0.4, max_cache_len 1024,
   `warmup()` first) with a cold burst of 8 requests
   `np.arange(100 + i, 150 + i)`: aggregate xRT, time to first audio p50
   and max, wall per `step()`, K2's launches per step (against the
   config's count) and per path; every request ends `done` with finite
   audio of whole frames. (Requests through the `InferenceBroker` and
   the server's own TTS adapter run in phase 26; until the server was
   ported, three ran here through a stand-in adapter.)
12. Whisper, the small config of tests/test_whisper.py at f32 from one
   seeded weight set, CUDA against the CPU: the whole-file log-mel (cuFFT
   against the CPU's FFT, within 1e-4) and greedy `generate()` on 6 s of
   seeded noise with timestamps and word timestamps (tokens, segment and
   word times equal).
13. Whisper large-v3-turbo at full width (the JAX lane's dims, bench.py:
   892-895; 807 M parameters drawn on the card from seed 0 in f32, then
   cast to bf16): the bf16 encoder against f32 on one 30-s window (relative
   Frobenius error under 2e-2), the encoder's time a window (CUDA events)
   and its share of 989 TFLOP/s, the JAX lane's workload cut from 600 s
   to 90 s (300 until phases 41-44 came, 180 until phases 58-61;
   `randn * 0.1`, greedy, thresholds off, timestamps, `sample_len` 100;
   bench.py:898-905) cold then warm (wall, xRT, windows, segments, tokens,
   decode steps, ms a step), and the streaming session over six 1-s chunks
   then `close()` (step latency p50 and max; a final event must arrive).
   Neither K1 nor K2 may launch in phases 12-14 (phase 26 runs between
   16 and 17, and launches both).
14. The STT entry points on the card: a small checkpoint written with HF
   names and config (npz) and a 5-s WAV written with the port's audio_io;
   `python -m mlx_audio_tpu_torch.stt.generate --format json` in a
   subprocess must equal `mlx_audio_tpu_torch.load_model(...).generate()`
   in process (text and segments). Then the same for a small Voxtral
   Realtime checkpoint (mistral's consolidated names, torch conv layout,
   npz, a tekken.json) and a 3-s WAV, and for a small Cohere ASR checkpoint
   (NeMo's names, torch conv layouts, npz with the preprocessor's
   filterbank and window, a tokens.json) and a 5-s WAV. Last, a small
   Higgs Audio v2 checkpoint (HF names, config.json with model_type
   "higgs_audio", npz, no text head): `load_model(...)` on the card must
   tie the text head to embed_tokens and give the in-process model's
   greedy frames. Then small KugelAudio and VibeVoice checkpoints (HF
   names, torch conv layouts, npz, config.json with model_type
   "kugelaudio" and "vibevoice_streaming"): `load_model(...)` on the card
   must give the in-process models' audio.
15. Voxtral Realtime, the small config of tests/test_voxtral_realtime.py
   with a 2-layer encoder, at f32 from one seeded weight set, CUDA against
   the CPU: offline adapter frames (relative error within 1e-4) at 1 s,
   whose mel bucket's padding lies past the encoder's window (the JAX
   package's encoder gives NaN there), and at 4.5 s; greedy offline tokens
   equal; on the card the session fed in uneven pieces gives the offline
   tokens and text; everything finite.
16. Voxtral-Mini-3B-Realtime at full width (`ModelConfig()`, as bench.py:
   701; 4.43 B parameters drawn on the card in f32 from seed 0, then cast
   to bf16 in place): one ENC_CHUNK encoder step in bf16 against f32
   (relative Frobenius under 2e-2) and its time; the JAX lane's workload
   (bench.py:708-747: 30 s of `randn * 0.1` at seed 0 after a 6-s warm
   drive, 1-s feeds each followed by `step(max_decode_tokens=16)`, then
   `close()` and `step(32)` until done): step p50, p95 and max, EOT to
   final, xRT, decoded tokens, p95 < 1 s, peak device memory; a final
   event must arrive. Then an offline `generate()` of 20 s, a length where
   the JAX package's encoder gives NaN: its adapter frames must be finite.
   Neither K1 nor K2 may launch in phases 15-16.
17. Cohere ASR, the small config of tests/test_cohere_asr.py at f32 from
   one seeded weight set, CUDA against the CPU: the encoder rows of a
   ragged batch with a row of length 0 (relative error within 1e-4, all
   finite; the JAX package's length-0 row is NaN) and greedy `generate()`
   on 5 s of seeded noise (3 segments, a partial last batch): texts and
   segments equal.
18. Cohere ASR at the cohere_asr_10min lane's dims (bench.py:831-842:
   FastConformer 48 x d1280, decoder 8 x d1024, vocabulary 16,384; 2.07 B
   parameters drawn on the card in f32 from seed 0, then cast in place to
   bf16): the bf16 encoder against f32 on one 8-row batch of the 3,584-
   frame bucket (relative Frobenius under 2e-2), the encoder's time a
   batch (CUDA events) and its share of 989 TFLOP/s; the lane's workload
   (bench.py:856-869, its 600 s cut to 240: `randn * 0.1` at seed 0,
   language "en", max_tokens 150) cold, then warm: wall, xRT,
   segments (8, one batch of the 8-row encoder check),
   tokens, decode steps and ms a step, the host mel's time, peak device
   memory; every batch's encoder rows finite, the runs' texts equal.
   Neither K1 nor K2 may launch in phases 17-18.
19. Higgs Audio v2, the small config of tests/test_higgs_audio_v2.py at
   f32 from one seeded weight set, CUDA against the CPU: the cached
   prefill's hidden states of a mixed text/audio prompt (within 1e-4),
   greedy `generate_frames` with the EOS rows of the audio head scaled so
   that EOS comes after the delay ramp-in and the ramp-out runs (frames
   equal), and a greedy `generate()` through a small bound codec (same
   length, audio within 1e-4). Then `qmatmul_i8` on the card
   (`torch._int_mm`, rows padded where it refuses few) against its plain
   version at M in {1, 17, 512} and the four Higgs shapes: int32
   accumulators equal, the output within 1e-5.
20. Higgs Audio v2 at `ModelConfig()` dims (5.771 B parameters drawn
   N(0, 0.02) on the card in f32 from seed 0, as bench.py:369-390 draws
   every floating leaf, then cast in place to bf16): bf16 against f32 on
   the lane's 512-bucket prefill (relative Frobenius under 2e-2); the
   `higgs_v2_3b_bf16` workload (bench.py:428-464: 480 embeds of
   `randn * 0.02` at seed 0, cache 1,024, temperature 0.7, top_p 0.95, RAS
   7/2; 32 frames in 16-frame chunks through `prefill` and `chunk`
   whatever `done` says, then the codec at `CodecConfig()` dims in bf16 on
   the first 24 frames mod 1,024; the lane runs 250 frames and 242, cut
   here to keep the run's time: to 100 and 92 since the Orpheus phases
   came, to 50 and 42 since phases 41-44, to 32 and 24 since phases
   58-61), a warm-up
   then one timed run (best of 3 until the server phase came, of 2 until
   the cloning phases came; cut to keep the run's time): wall, ms a
   frame, xRT over 2 s, the prefill's and the codec's time, peak device
   memory, and from one profiled chunk of 4 frames (16 until phases
   58-61) the kernels a frame, device time and busy share against the
   frame's byte bound (1.72 ms). Then, after
   phase 21, the same model's affine codes converted in place to W8A8
   (`tree_to_i8_layout`, as bench.py:414-426), its audio logits on the
   prefill's last row against bf16 (relative Frobenius under 1e-1), and
   the `higgs_v2_3b_q8` workload the same way against its int8 bound.
   Audio finite and 88,320 samples in each. Neither K1 nor K2 may launch.
21. On phase 20's weights, between its two lanes: the backbone quantized
   through `apply_quantization` to affine 8 bits (group 64, no mxu_int8),
   one 32-frame request through `generate_frames` with a voice-clone-like
   mask. K2's launches must equal 28 x (4 + 3 + 3) = 280 for the prefill
   (both paths) plus 196 (28 layers x 7, the audio path) for each decode
   step run; every quantized linear the config gives must be one. Then K2
   (checked against `qmatmul_reference`), W8A8 and dense bf16 cuBLAS at
   the four Higgs shapes at M = 1 and 512, by CUDA graph replay, with the
   sums over one decode frame's 196 linears. These launches join K2's
   count in the `kernels` line, and the shapes phase 8's final check.

22. KugelAudio and VibeVoice, the small configs of tests/test_kugelaudio.py
   and tests/test_vibevoice.py at f32 from one seeded weight set, CUDA
   against the CPU: KugelAudio's CFG prefill (hidden rows and the K cache's
   written columns within 1e-4), a generate() with every frame forced to
   diffusion (the lanes' +1e4 lm_head bias), cfg_scale 3.0 and one noise
   tensor on both devices (equal frames, audio within 1e-4), and VibeVoice's
   generate() the same way with its EOS classifier biased off.
23. KugelAudio at the kugelaudio_7b lane's dims (bench.py:533-547: 8.642 B
   parameters drawn N(0, 0.02) on the card in f32 from seed 0, as the lane
   draws every floating leaf): bf16 against f32 on the lane's CFG prefill
   hidden rows and one head pass (relative Frobenius under 2e-2), then cast
   in place to bf16 and the lane's workload (bench.py:589-642: the stand-in
   tokenizer, the +1e4 bias on SPEECH_DIFFUSION_ID, its text, 16 frames of
   10 SDE steps at cfg_scale 3.0 (the lane's 64 cut to 32 for phases
   41-44, to 16 for phases 58-61); a warm-up, then seed 1, the lane's seed
   2 cut to keep the run's time): wall, xRT over 4.27 s, ms a frame, the prefill's, frame loop's and
   VAE decode's seconds, peak device memory, and from one profiled chunk
   of 2 frames (4 until phases 58-61) the kernels a frame, device time
   and busy share against
   the frame's byte bound (bench.py:645-656). After phase 24, the same
   weights in W8A8 (the LM's affine codes through to_i8_layout, every
   prediction_head linear quantized and converted the same way, as
   bench.py:559-579): prefill hidden and head pass against bf16 (under
   1e-1), then the workload again. 204,800 finite samples each; neither K1
   nor K2 may launch in phases 22, 23 and 25.
24. On phase 23's bf16 weights, between its two lanes: the LM quantized
   through `apply_quantization` with KugelAudio's predicate (affine 8 bits,
   group 64, no mxu_int8) and one 16-frame request; K2's launches must
   equal 28 x 7 = 196 a LM step, the prefill's (M = 1,024) included. Then
   K2 (checked against `qmatmul_reference`), W8A8 and dense bf16 cuBLAS at
   the LM's four shapes at M = 2 and 1,024 by CUDA graph replay, with the
   sums over one step's 196 linears. Last, `load_model` on a small f32
   checkpoint with the lane's FFN width (down_proj K = 18,944) whose
   config.json asks for affine 8 bits: on the card its LM runs through
   K2's simt path (f32 x at M = 2 and 2 x bucket, stepping over K), and
   its audio must be the same checkpoint's loaded on the CPU. These
   launches join K2's count in the `kernels` line, and the shapes phase
   8's final check.
25. VibeVoice at `ModelConfig()` dims (a 24-layer Qwen2 split 4 + 20 at
   d896, a 4-layer head, 20 DPM steps; drawn as phase 23, in bf16), no
   voice, its EOS classifier biased off: 24 latents (48 until phases 41-44
   came; wall, xRT, ms a
   latent) and a profiled request of one speech window (kernels a latent,
   busy share).
26. The server, run after phase 16 on models earlier phases built
   (`mlx_audio_tpu_torch.server.AudioServer` on the card, its request
   core called directly: the card machine has no aiohttp): a seeded
   Kokoro-82M checkpoint at the published dims (npz, no model_type, in a
   directory named for the family) loaded through `ModelProvider` and the
   `load_model` router with no category; a whole wav and a streamed pcm
   speech request (48 K1 launches each; the WAV and PCM of the model's
   own `generate()` for the same request, to 1 LSB); the q8 Qwen3-TTS of
   phases 6-11 with a stand-in tokenizer: 8 concurrent streamed requests
   to a cold server (the broker makes and warms up its session, timed; no
   error may be logged; time to first audio p50 and max, aggregate xRT,
   K2's launches against 722 a frame and admission); a json and an NDJSON
   transcription by phase 13's Whisper turbo (the text of its own
   `generate()`); `/v1/realtime` with `server_vad`: Silero at its
   published dims (seed 0) against the CPU on 8 s of seeded audio (within
   1e-4), the session fed 200-ms messages, its turn events equal to the
   CPU detector's over the card's probabilities, phase 16's Voxtral
   transcribing each turn (step latency p50 and p95), then one
   manual-commit turn. These launches join K1's and K2's counts in the
   `kernels` line.
27. Voice cloning, run after phase 18, on the small configs at f32 from
   one seeded weight set, CUDA against the CPU: Mimi (tests/test_codecs.py's
   config) codes equal, whole and streamed decode within 1e-4; the ECAPA
   x-vector (tests/test_qwen3_tts_icl.py's small encoders on phase 6's
   Qwen3-TTS, dense); a greedy Qwen3-TTS ICL request (the [reference;
   generated] codes handed to the codec equal, audio within 1e-4); a
   greedy Sesame request cloning a reference segment
   (tests/test_sesame_cloning.py's config; frames equal, audio whole and
   streamed within 1e-4).
28. Qwen3-TTS voice cloning on the q8 model of phases 6-11: the reference
   encoder at `encoder_mimi_config(None)`'s published dims (32 quantizers
   of 2,048 x 256, 16 valid) and the ECAPA at its default config, seeded,
   f32. The encoder's latents and codes on a 2-s clip against the same
   weights on the CPU, and the share of a 10-s clip's codes that TF32
   would flip; the 10-s reference's encode and x-vector (cold, warm); the
   ICL prefill alone at its 512-row bucket (120-character stand-in texts);
   30 frames by ICL whole and streamed (50 until phases 41-44 came; time to
   first audio), 16 by the
   x-vector alone (30 until phases 58-61 came), and one `AudioServer` speech request with
   ref_audio="voice:clone" from its voice library (serial path, no
   session; its WAV equal to generate()'s to 1 LSB). K2's launches each
   against the config's count (the prefill's 197, then 722 a frame), K1
   none; then K2, W8A8 and dense bf16 at the talker's shapes at M = 512.
29. Sesame CSM-1B at `ModelConfig()` (bf16; its Mimi at mimi_202407(32) in
   f32; codebook 0's EOS row zeroed so that the frames run): a 10-s
   reference segment, 8 frames (32 until phases 41-44 came, 16 until
   phases 58-61) whole and
   streamed every 0.5 s (the same
   frames; streamed audio within 1e-4 of whole): ms a frame, xRT, time to
   first audio, and from two profiled frames the kernels and device time
   a frame. Neither K1 nor K2 may launch in phases 27 and 29.
30. The NeMo ASR families, run after phase 25, on the small configs of
   tests/test_parakeet.py, tests/test_canary.py and
   tests/test_nemotron_asr.py at f32 from one seeded weight set, CUDA
   against the CPU: Parakeet TDT, RNN-T and CTC (encoder rows within 1e-4,
   tokens and frames equal), a 2-s file in 0.8-s windows (the merged
   result equal), Canary's greedy tokens, Nemotron's generate and
   stream_generate; then each tiny checkpoint directory through the
   `load_model` router on the card, the STT CLI on Parakeet with
   --chunk-duration and one Parakeet transcription (verbose_json) through
   `AudioServer`, each equal to in-process generate().
31. At full width, seeded random weights drawn on the card in f32, then
   cast to bf16 (the bf16 encoder against f32, relative Frobenius under
   2e-2; token agreement with f32 reported): Parakeet TDT 0.6B v2 (the
   encoder's ms a 120-s window and its share of 989 TFLOP/s; 225 s (cut
   from 600 to 300, then to 225 for phases 58-61) in 120-s windows with a
   15-s overlap, cold and warm: wall,
   xRT, windows,
   joint steps, tokens, ms a joint step, reads; one 60-s request; kernels
   and busy share a joint step from a profiled decode, the encoder's
   largest kernels), Canary-1B-v2 on a
   30-s clip with max_tokens 200 (encoder ms, decode steps, ms a step,
   wall, xRT) and Nemotron ASR at `ModelConfig()` on 60 s in 30-s chunks
   (wall, xRT, joint steps, stream_generate's first yield). Random
   transducers emit on nearly every step and Canary never ends, so the
   joints' blank logit is biased, by bisection over decodes of a window's
   first 200 frames, to emit on about a quarter of the steps, and Canary's
   EOS row is biased down. Neither K1 nor K2 may launch in
   phases 30-31.
32. Speech to speech, run after phase 31, on the small configs of
   tests/test_moshi.py (its Mimi: phase 27's), tests/test_mel_roformer.py
   and tests/test_deepfilternet.py at f32 from one seeded weight set,
   CUDA against the CPU: Moshi's 16 greedy LmGen steps (tokens equal) and
   a greedy generate over a 0.25-s clip (250 steps of the tiny Mimi's 1-ms
   frames, 500 until phases 58-61; text tokens equal, audio within 1e-4);
   the same LM at widths
   group 64 divides, affine q8 through K2 against the same model through
   `qmatmul_reference` on the card (tokens equal, first-step logits within
   phase 8's 1e-4; K2's launches the config's count a step);
   Mel-Band-RoFormer `separate` over several chunks and DeepFilterNet
   offline and streamed in 8-hop chunks (within 1e-4, and streamed against
   offline on the card); then each tiny checkpoint directory through the
   `load_model` router on the card (a loaded Moshi's generate asks for a
   Mimi), the STS CLI on DeepFilterNet and Mel-Band-RoFormer in a
   subprocess (TF32 off) writing the WAV of in-process generate(), and one
   Mel-Band-RoFormer separation through `AudioServer` equal to separate().
33. Moshi v0.1 (`config_v0_1()`, 7.69 B) drawn on the card in bf16 tensor
   by tensor, its Mimi at mimi_202407(8) in f32: generate over 2 s of
   seeded input (25 steps; 10 s until phases 41-44 came, 6 s until
   phases 45-48, 4 s until phases 58-61) at the default temperatures,
   seed 0, after a
   2-s warm-up: ms a step p50 and p95 against the 80-ms frame, wall,
   the steps' realtime factor, peak memory; kernels and device time a
   step from 4 profiled steps (8 until phases 45-48 came), and the busy
   share (that device time over
   the generate's mean step). Then the same model in affine q8 (group
   64): the same numbers, K2's launches exactly 337 a step (the model
   must hold the config's quantized linears), and the first step's text
   logits against bf16's (relative Frobenius under 0.1). The launches of
   the q8 parts of phases 32 and 33 join K2's count in the `kernels`
   line, and their shapes phase 8's final check.
34. Mel-Band-RoFormer kim_vocal_2 (dim 384, depth 6, 60 bands, n_fft
   2,048, hop 441, 8-s chunks), seeded on the card: bf16 against f32 on
   one chunk (relative Frobenius under 2e-2), then a 60-s stereo clip at
   44.1 kHz in bf16 (wall, xRT, ms a chunk, the chunk's counted operations
   as a share of 989 TFLOP/s); DeepFilterNet3 at `DeepFilterNetConfig()`
   (48 kHz, hop 480) with a seeded stand-in ERB filterbank, in f32: 60 s
   offline (wall, xRT), then streamed in 8-hop chunks (ms a chunk p50 and
   p95 against the 80-ms chunk; within 1e-4 of offline). Neither K1 nor K2
   may launch in phases 32-34 outside the q8 Moshi.
35. Pre-quantized checkpoints and the convert CLI, run after phase 34, on
   a small Orpheus (tests/test_orpheus.py's sizes at d64, the full
   156,938-id vocabulary, a stand-in tokenizer, its tiny SNAC) from seed
   0: written as mlx-community ships one (every linear and the token table
   MLX-packed, uint32 words, group 64, with a `snac/` subfolder) at 4 and
   8 bits, each loaded through `tts.utils.load_model` on the card and on
   the CPU: every linear unpacked onto K2, 40 greedy tokens equal, audio
   within 1e-4 (both SNACs fed the same noise). Then `python -m
   mlx_audio_tpu_torch.convert -q --q-bits 4` in a subprocess, and
   `--quant-predicate mixed_4_6`, `--q-mode mxfp8` and `-d` (of the 4-bit
   output), each output reloaded on the card with its prefill logits held
   to the dense model's; and the TTS CLI (`--voice`) on the packed 4-bit
   directory, whose WAV must be `generate()`'s audio to 2 LSB.
36. Orpheus-3B at canopylabs' published width (Llama-3.2-3B: 28 layers x
   d3072, GQA 24/8 of 128, FFN 8,192, tied embeddings, 156,940 ids; 3.30
   B parameters) drawn on the card in f32 from seed 0, the token table's
   code and SOS rows scaled by 4 so that the tied head draws codes, cast
   to bf16; SNAC at hubertsiuzdak/snac_24khz's settings in f32: after a
   32-token warm-up, one 64-token request (512 until phases 38-40 came,
   256 until phases 41-44, 128 until phases 58-61) streamed every 1.0 s (it also ran whole until
   phases 45-48 came; temperature 0.6, top_p 0.8, repetition penalty 1.3;
   time to first audio, ms a token p50 and p95 over its chunks, the share
   of tokens that are SNAC codes, at least 80%; wall, xRT, SNAC decode ms
   of as many frames, peak memory), then one profiled 32-token chunk
   (kernels, device ms and busy share a token) against the token's byte
   bound.
37. The same weights packed in memory to MLX's 4-bit layout (group 64, as
   mlx-community ships Orpheus) and loaded through `apply_quantization`'s
   pre-quantized path: every linear on K2 (the tied table dense), the
   first step's logits against bf16's, the numbers of phase 36, and K2's
   launches exactly 28 x 7 = 196 a token (the decode steps and prefills
   run), read from its counter. Neither phase launches K1, nor phase 36
   K2; these launches join K2's count in the `kernels` line, and their
   shapes phase 8's final check at 4 bits. Before the 4-bit requests the
   196 linears are timed alone at M = 1 (one CUDA graph of their K2
   launches replayed) beside their byte bound; phase 33 does the same for
   the q8 Moshi's 337 linears a step.
38. The Qwen3 LM families' small configs (tests/test_qwen3_asr.py's shapes
   at d64, two layers each side; stand-in tokenizers), each on the card
   against the CPU at f32: a Qwen3-ASR and a forced aligner written as
   MLX-packed 8-bit checkpoints (group 64) and loaded through
   `stt.utils.load_model` (every linear on K2, the token table dense):
   greedy tokens equal, encoder features within 1e-4, the aligner's
   timestamps equal; the STT CLI with `--stream`, then `--text` on the
   aligner, against in-process results; the Qwen3-ASR directory's
   transcription through `AudioServer`; a dense MegaASR directory with its
   router and LoRA in extras/ (the route and the text with the adapter on
   and off equal on both devices; the routed text through the STT CLI and
   the server, the aligner's words through the server); a VyvoTTS
   directory with its SNAC in
   snac/ (greedy codes equal, audio within 1e-4) and the TTS CLI's WAV
   against in-process `generate()`.
39. Qwen3-ASR at `ModelConfig()` (a 24 x d1024 tower, a 28 x d2048 LM with
   151,936 ids and a tied head; 2.0 B parameters) drawn on the card in f32
   from seed 0 and cast to bf16, then packed in memory to MLX's 8-bit
   layout (group 64) and loaded through the pre-quantized path (every
   linear on K2, the tied table dense): each on 30 s of `randn * 0.1` at
   seed 0, greedy, max_tokens 64 (256 until phases 41-44 came, 128
   until phases 58-61): encoder
   ms, prefill ms at its bucket,
   ms a token p50 and p95, xRT, peak memory, 8 profiled steps (a 32-step
   chunk until phases 45-48 came; kernels, device ms and busy share a
   token) and the token's byte bound; in q8,
   K2's launches a decode token read from its counter against the
   config's 28 x 7 = 196, the LM's 196 linears alone (one CUDA graph) and
   at the prefill's bucket against cuBLAS bf16, and the first step's
   logits against bf16's (relative, under 0.1).
40. At Qwen3-0.6B's text dims (28 x d1024, 16 heads, 8 KV heads, head 128,
   FFN 3,072) in bf16 from seeds on the card: the forced aligner (its
   tower at `AudioEncoderConfig()` with output_dim 1024) aligning 60
   words to 30 s, cold and warm; VyvoTTS (180,352 ids, the code rows
   scaled by 4 so that the tied head draws codes; SNAC 24 kHz in f32) on
   a 128-token request (256 until phases 41-44 came) streamed every 0.5 s
   (it also ran whole until phases 45-48 came; time to first audio, ms a
   token p50 and p95, the share of SNAC codes, at least 80%).
   K1 never launches in phases 38-40, K2 only on the q8 models; their
   shapes join phase 8's final check, their launches the `kernels` line.
41. The LLM-decoder STT families' small configs (the JAX tests' tiny
   configs, Voxtral's and Qwen2-Audio's at widths group 64 divides;
   stand-in tokenizers), each written as a checkpoint directory and loaded
   through `stt.utils.load_model` on the card and on the CPU: offline
   Voxtral MLX-packed q8 with a tekken.json and Qwen2-Audio MLX-packed
   4-bit (their LM and projector linears on K2), GLM-ASR, Granite Speech
   and VibeVoice-ASR dense: greedy tokens and text equal, encoder rows
   within 1e-4; the STT CLI (Qwen2-Audio's json, GLM-ASR's `--stream`)
   against in-process results; Granite Speech's directory through
   `AudioServer`'s transcription route.
42. Voxtral-Mini-3B-2507 at the dims of mistralai/Voxtral-Mini-3B-2507's
   config.json (a 32 x d1280 tower, the 5,120 -> 3,072 -> 3,072 projector,
   a 30 x d3072 Mistral LM with 131,072 ids and an untied head; 4.68 B
   parameters) seeded on the card in bf16, then its projector and LM
   packed in memory to MLX's 8-bit layout (group 64; the tower dense) and
   loaded through the pre-quantized path: each on 30 s of `randn * 0.1`
   at seed 0, greedy, max_tokens 64 (256 until phases 45-48 came, 128
   until phases 58-61): tower
   ms, prefill ms, ms a token p50 and p95, xRT, peak memory, 8 profiled
   steps (a 32-step chunk until phases 45-48 came; kernels, device ms and
   busy share a token), bytes and bound a token; in q8, K2's launches a
   token read from its counter against 30 x 7 + 1, the LM's linears alone
   (one CUDA graph) and at the prefill's M against cuBLAS bf16 with their
   bound, and the first step's logits against bf16's (relative, under
   0.1).
43. Qwen2-Audio-7B-Instruct at the dims of Qwen/Qwen2-Audio-7B-Instruct's
   config.json (the same tower with a 2x pool, a 32 x d4096 Qwen2 LM with
   32 KV heads, q/k/v biases and 156,032 ids; 8.40 B parameters) seeded on
   the card in bf16 and packed in memory to MLX's 4-bit layout (group 64):
   30 s, 64 tokens: ms a token p50, K2's launches a token from its
   counter against 32 x 7 + 1, bytes and bound a token (the f32 caches of
   32 KV heads included), peak memory, the first step's logits against
   bf16's (relative, under 0.5).
44. VibeVoice-ASR's acoustic and semantic tokenizer encoders at
   `TokenizerConfig()` dims in bf16 on 10 minutes of 24-kHz audio (ms,
   peak memory, 4,500 finite rows), and bf16 against f32 on its first 10
   s. K1 never launches in phases 41-44, K2 only on the packed models;
   their shapes join phase 8's final check, their launches the `kernels`
   line.
45. OuteTTS, Pocket-TTS, EnCodec, MMS and language ID on small configs
   (the JAX tests' tiny ones; OuteTTS a 2-layer llama at d64 over the
   tiny DAC with two codebooks, stand-in tokenizers) at f32 from one
   seeded weight set, the card against the CPU: the DAC's encode codes
   equal and its `from_codes` and decode within 1e-4; EnCodec's round
   trip; OuteTTS's 40 greedy tokens equal and its DAC audio; an
   MLX-packed q8 OuteTTS directory through `tts.utils.load_model` (every
   linear on K2; tokens equal to the CPU's and to the same model through
   `qmatmul_reference`; K2's launches printed); Pocket-TTS's latents and
   audio at temperature 0 (EOS on the first frame, eight frames after
   it); MMS's CTC ids; wav2vec2 and ECAPA LID's top-3 and probabilities;
   then tiny directories through `tts.utils`, `stt.utils`, `lid.utils`
   and the top-level `load_model` on the card (an "mms-lid" wav2vec2
   directory routes to LID), the TTS CLI's WAV on OuteTTS and the STT
   CLI's text on MMS against in-process `generate`.
46. Llama-OuteTTS-1.0-1B (Llama-3.2-1B's dims: 16 layers at d2048, GQA
   32/8 of 64, FFN 8,192, RoPE theta 500,000 with llama3 scaling, tied
   head; OuteTTS-1.0's 134,400 ids; 1.24 B parameters) seeded on the card
   in bf16, its code rows scaled by 4, over descript's 24-kHz DAC in f32
   (two of its 32 codebooks): a 64-token request at OuteTTS's sampling
   (ms a token p50 and p95, code share, wall, xRT, the DAC's ms), the
   same streamed every 0.5 s (first audio), 8 profiled steps (kernels,
   device ms and busy share a token), bytes and bound a token; then
   packed in memory to MLX's 8-bit layout and loaded through the
   pre-quantized path: its 112 linears alone at M = 1 (one CUDA graph)
   against their byte bound, the request again, K2's launches a token
   read from its counter against 16 x 7, the first step's logits against
   bf16's (relative, under 0.1).
47. Pocket-TTS at the JAX package's `ModelConfig()` (a 12 x d1024 flow
   LM, a 1,024 x 6 flow net, an 8,000-bin table, the default Mimi; not a
   published config.json) in f32 from seeds on the card, EOS biased off:
   one sentence of 11 words from the default 0.5-s silent voice, run to
   its max_gen frames (ms a frame p50 and p95 against the 80-ms frame,
   realtime factor, kernels a frame over 4 profiled frames); EnCodec at
   its 24-kHz dims (32 filters, ratios [8, 5, 4, 2], two LSTM layers, 32
   codebooks) in f32: a round trip of 10 s (ms, xRT).
48. MMS-1b-all's dims (48 layers at d1280, 16 heads, FFN 5,120, the
   stable layer norm, adapters of 16) on 30 s, f32 then bf16 (ms, xRT,
   the share of 989 TFLOP/s by counted operations, CTC ids bf16 against
   f32 on at least 90% of the frames); MMS-LID-256 on 10 s (top-1 equal
   in bf16 and f32); ECAPA VoxLingua107 (channels 1,024, embedding 256,
   107 languages) on 30 s in f32 (ms). K1 never launches in phases 45-48,
   K2 only on the q8 OuteTTS models; their shapes join phase 8's final
   check, their launches the `kernels` line.
49. The Kaldi fbank families' small configs (the JAX tests' tiny
   configs; Fun-ASR-Nano's LM at d64 so that group 64 divides its widths)
   at f32 from one seeded weight set, the card against the CPU: the Kaldi
   fbank (16 kHz at int16 scale, 48 kHz dithered), deltas and
   `ISTFTCache`; FSMN `detect` and a session fed in pieces; SenseVoice's
   CTC ids and rich tags; Fun-ASR-Nano's greedy tokens, and an MLX-packed
   q8 Fun-ASR-Nano through `stt.utils` (every LM linear on K2: tokens
   equal to `qmatmul_reference`'s and the CPU's, K2's launches printed);
   FireRedASR2's beam-3 hypotheses and scores; MossFormer2-SE's
   `enhance`; tiny directories through the `vad`, `stt` and `sts` loaders
   and the top-level `load_model` on the card; the STT CLI on SenseVoice
   and the STS CLI on MossFormer2-SE against in-process `generate`.
50. Fun-ASR-Nano-2512 (the SenseVoice encoder, 50 + 20 blocks at d512;
   the 2-block d1,024 adaptor; Qwen3-0.6B, 28 layers at d1,024, GQA 16/8
   of 128, FFN 3,072, 151,936 ids, tied) seeded on the card in bf16, the
   tied table's EOS rows zeroed: on 30 s of randn x 0.1, the encoder and
   adaptor's ms, a 64-token greedy transcription (ms a token p50 and
   p95, xRT), a profiled 8-step chunk (kernels, device ms and busy share
   a token), bytes a token and their bound; then `llm.model` packed to
   MLX's 8-bit layout in memory and loaded through the pre-quantized
   path: its 196 linears alone at M = 1 against their byte bound, the
   transcription again, K2's launches a token read from its counter
   against 28 x 7, the first step's logits against bf16's.
51. SenseVoiceSmall at the JAX defaults (25,055 ids, input 560) on 30 s,
   f32 then bf16 (ms, xRT, the share of 989 TFLOP/s by counted
   operations, CTC ids bf16 against f32); FireRedASR2-AED at the JAX
   defaults (16 + 16 layers at d1,280, 20 heads, conv kernel 33, 8,667
   ids; 1.1 B parameters) in bf16 on 10 s: the encoder's ms, then beam 3
   with max_len 64, EOS's projection row zeroed (ms a beam step p50 and
   p95 at M = 3, kernels a step over a profiled 8-step beam, bytes a
   step and their bound).
52. MossFormer2-SE 48K at the JAX defaults (24 blocks at d512, 961 bins)
   in f32 on a 10-s clip and a 30-s clip (sliding 4-s windows), cold then
   warm (ms, xRT); FSMN VAD at the JAX defaults (FunASR's fsmn-vad) on
   60 s: `detect` cold then warm (ms, xRT) and a session fed in pieces
   equal to it. K1 never launches in phases 49-52, K2 only on the q8
   Fun-ASR-Nano models; their shapes join phase 8's final check, their
   launches the `kernels` line.

Phases 53-66 (the last STT families, Smart Turn, Sortformer, LFM2-Audio,
DACVAE, SAM-Audio, the voice pipeline, the WER CLI, KittenTTS, Soprano,
Voxtral-4B-TTS, OmniVoice) are described by their functions' docstrings,
and so are phases 67-70: TADA and MOSS-TTS's small configs through
`load_model`, the card against the CPU (with q8 directories on K2);
TADA-1B in bf16 and q8 (K2); MOSS-TTS's delay layout at the JAX defaults
in bf16 and q8 (K2), and its v1.5 local layout in bf16.

The last two lines of stdout are a JSON line about the kernels and the
result line {"ok": true, "device": {...}}. Any failure exits non-zero
before either is printed.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# relative error max|a-b| / max|b| allowed against the plain version:
# f32 sums the same exact products in another order (~1e-6 seen); bf16
# output rounds to 8 mantissa bits, so one bf16 ulp at the largest value is
# 2**-8 = 3.9e-3, and an h element may round the other way where sinf and
# torch.sin differ in the last f32 bit
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# small-input end-to-end check, CUDA vs CPU at f32 with the same durations:
# the NSF phase is a cumsum over thousands of samples, summed in another
# order on the GPU
E2E_TOL = 1e-3
# the bf16 decoder on the GPU against the f32 CPU path: the bound of
# tests/test_kokoro.py:123-149 (relative error, and correlation)
BF16_TOL, BF16_CORR = 0.15, 0.999
# the generator's legs at the 1024-frame bucket: stage 0 runs 2F*10 rows at
# C=256, stage 1 2F*60+1 rows at C=128 (istftnet.py reflection pad)
KERNEL_FRAMES = 1024
# the H100 SXM's dense bf16 tensor-core rate and device-memory bandwidth at
# its full 700 W (NVIDIA's data sheet), for the kernels' bounds
PEAK_BF16, HBM_BPS = 989e12, 3.35e12
TEXTS = (
    "Hello world.",
    "The quick brown fox jumps over the lazy dog near the river bank.",
    "Machine learning systems now synthesize natural speech in real time, "
    "streaming audio to listeners across the planet with very low latency.",
)


def log(msg: str) -> None:
    print(msg, flush=True)


# the functions whose every call logs its seconds as a `[step]` line,
# indented by nesting: the phases, the model builds and their runs
_STEP_PREFIXES = ("phase_", "build_", "_linear_times", "k2_linears_alone",
                  "_profile")
_STEP_DEPTH = [0]


def _stepped(name: str, fn):
    import functools

    @functools.wraps(fn)
    def run(*args, **kwargs):
        _STEP_DEPTH[0] += 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            _STEP_DEPTH[0] -= 1
            log(f"[step] {'  ' * _STEP_DEPTH[0]}{name} "
                f"{time.perf_counter() - t0:.1f} s")
    return run


def time_steps() -> None:
    """Wrap this module's phases, builds and `_*_run` functions so that
    each call logs its seconds (the callers look them up at call time)."""
    import inspect

    g = globals()
    for name, fn in list(g.items()):
        if (inspect.isfunction(fn) and fn.__module__ == __name__
                and name not in ("phase_device", "time_steps")
                and (name.startswith(_STEP_PREFIXES)
                     or (name.startswith("_") and name.endswith("_run")))):
            g[name] = _stepped(name, fn)


def rel_err(a, b) -> float:
    """max|a - b| / max|b| of two tensors or numpy arrays."""
    import torch

    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")
    return card


def phase_build():
    """One nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from mlx_audio_tpu_torch.ops.cuda_build import build
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    t0 = time.perf_counter()
    names = ("snake_conv", "qmm")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(build, names))
    snake_conv_kernel.build()
    qmm_kernel.build()
    log(f"[build] {', '.join(f'{n}.cu -> {lib.name}' for n, lib in zip(names, libs))} "
        f"in {time.perf_counter() - t0:.2f} s")


def _time_ms(fn, reps: int) -> float:
    """Median ms of one call of `fn` between CUDA events (host cost
    included: for calls far longer than their launch, the plain version)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def k1_bound(c: int, k: int, t: int, vlen) -> tuple:
    """(ms, "operations" or "bytes") the card needs at least for one leg:
    the bf16 products of the rows this run's valid lengths keep, against
    989 TFLOP/s, or the bytes (those rows of x read once, w read once, all
    of out written once) against 3.35 TB/s, whichever is larger."""
    rows = sum(min(max(int(v), 0), t) for v in vlen)
    ops_ms = 2.0 * rows * c * c * k / PEAK_BF16 * 1e3
    bytes_ms = 2.0 * (rows * c + k * c * c + len(vlen) * t * c) / HBM_BPS * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def k1_bound_full(c: int, k: int) -> float:
    """k1_bound's ms for a leg of phase 3's shapes were every row valid."""
    t = 2 * KERNEL_FRAMES * (10 if c == 256 else 60) + (c == 128)
    return k1_bound(c, k, t, [t, t])[0]


def phase_kernels(card: str, reps: int = 5):
    """Every (C, k, dil) of the main path, by each path of K1 (f32 on f32
    x; wgmma, the dispatched bf16 path, and wmma, the first design, on bf16
    x) against the plain version, B=2 with ragged valid lengths. Kernel
    times are device times per launch from a CUDA graph replay (the host's
    launch cost left out); the plain version is timed by events. Beside
    each bf16 shape: the leg's bound and cuDNN `F.conv1d` alone on a
    precomputed bf16 h (the conv without the affine, snake and masks; a
    yardstick the port never calls). Returns ({(path, C, k, dil): (rel,
    abs, ms, plain_ms)}, {(C, k, dil): (cudnn_ms, bound_ms, bound_by)})."""
    import torch
    import torch.nn.functional as F

    from mlx_audio_tpu_torch.ops.snake_conv import (
        adain_snake_conv1d_reference, choose_path, kernel_weight,
        snake_conv_kernel)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results, extra = {}, {}
    for c, t in ((256, 2 * KERNEL_FRAMES * 10), (128, 2 * KERNEL_FRAMES * 60 + 1)):
        vlen = torch.tensor([t, (t * 3) // 5], dtype=torch.int32, device=dev)
        x32 = torch.randn(2, t, c, generator=g, device=dev)
        scale = 1.0 + 0.5 * torch.randn(2, c, generator=g, device=dev)
        shift = 0.1 * torch.randn(2, c, generator=g, device=dev)
        alpha = torch.rand(c, generator=g, device=dev) + 0.5
        bias = 0.05 * torch.randn(c, generator=g, device=dev)
        h16 = torch.randn(2, c, t, generator=g, device=dev).to(torch.bfloat16)
        if choose_path(torch.bfloat16, c) != "wgmma":
            raise AssertionError(f"bf16 C={c} dispatches to "
                                 f"{choose_path(torch.bfloat16, c)}")
        for k in (3, 7, 11):
            w32 = torch.randn(k, c, c, generator=g, device=dev) / (k * c) ** 0.5
            for dil in (1, 3, 5):
                for path in ("f32", "wgmma", "wmma"):
                    dtype = torch.float32 if path == "f32" else torch.bfloat16
                    x, w = x32.to(dtype), w32.to(dtype).contiguous()
                    kw = kernel_weight(w, path)

                    def kern():
                        return snake_conv_kernel(x, scale, shift, alpha, kw,
                                                 bias, dilation=dil,
                                                 valid_len=vlen, path=path)

                    def plain():
                        return adain_snake_conv1d_reference(
                            x, scale, shift, alpha, w, bias, dilation=dil,
                            valid_len=vlen)

                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    if got.dtype != dtype or got.shape != x.shape:
                        raise AssertionError(f"kernel output {got.dtype} "
                                             f"{tuple(got.shape)}")
                    if not torch.isfinite(got).all():
                        raise AssertionError("kernel output not finite")
                    rel = rel_err(got, want)
                    ab = float((got.float() - want.float()).abs().max())
                    name = str(dtype).split(".")[-1]
                    ms = _time_graph([kern] * 5, reps)
                    plain_ms = (results[("wgmma", c, k, dil)][3]
                                if path == "wmma" else _time_ms(plain, reps))
                    results[(path, c, k, dil)] = (rel, ab, ms, plain_ms)
                    line = (f"[kernel] {path:5s} C={c} k={k:2d} dil={dil} "
                            f"T={t} rel={rel:.3e} abs={ab:.3e} (tol "
                            f"{KERNEL_TOL[name]:g}) kernel {ms:.4f} ms, "
                            f"plain {plain_ms:.3f} ms")
                    if path == "wgmma":
                        wt = w.permute(2, 1, 0).contiguous()
                        b16 = bias.to(torch.bfloat16)
                        pad = (k - 1) // 2 * dil
                        lib_ms = _time_graph([lambda: F.conv1d(
                            h16, wt, b16, padding=pad, dilation=dil)] * 5,
                            reps)
                        bound_ms, by = k1_bound(c, k, t, vlen.tolist())
                        extra[(c, k, dil)] = (lib_ms, bound_ms, by)
                        line += (f", cuDNN conv1d alone {lib_ms:.4f} ms, "
                                 f"bound {bound_ms:.4f} ms ({by}), "
                                 f"{100 * bound_ms / ms:.1f}% of it")
                    log(line + f" ({card})")
                    if not rel <= KERNEL_TOL[name]:
                        raise AssertionError(
                            f"kernel vs plain {path} C={c} k={k} dil={dil}: "
                            f"rel {rel:.3e} > {KERNEL_TOL[name]}")
                fast, slow = (results[(p, c, k, dil)][2]
                              for p in ("wgmma", "wmma"))
                if not fast < slow:
                    raise AssertionError(f"wgmma {fast:.4f} ms not faster "
                                         f"than wmma {slow:.4f} ms at C={c} "
                                         f"k={k} dil={dil}")
    _k1_large_arguments()
    return results, extra


def _k1_large_arguments():
    """The wgmma path's reduced sine (csrc/snake_conv.cu::sin_sq) against
    the plain version's torch.sin where alpha*u reaches about 1e4."""
    import torch

    from mlx_audio_tpu_torch.ops.snake_conv import (
        adain_snake_conv1d_reference, kernel_weight, snake_conv_kernel)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    c, t, k = 256, 1000, 3
    x = torch.randn(2, t, c, generator=g, device=dev).to(torch.bfloat16)
    scale = 2500.0 * (1.0 + 0.5 * torch.rand(2, c, generator=g, device=dev))
    shift = torch.zeros(2, c, device=dev)
    alpha = torch.rand(c, generator=g, device=dev) + 0.5
    w = (torch.randn(k, c, c, generator=g, device=dev) / (k * c) ** 0.5
         ).to(torch.bfloat16)
    vlen = torch.tensor([t, 601], dtype=torch.int32, device=dev)
    got = snake_conv_kernel(x, scale, shift, alpha, kernel_weight(w, "wgmma"),
                            None, valid_len=vlen, path="wgmma")
    want = adain_snake_conv1d_reference(x, scale, shift, alpha, w,
                                        valid_len=vlen)
    u = float((x.float() * scale[:, None]).abs().max() * alpha.max())
    rel = rel_err(got, want)
    log(f"[kernel] wgmma C={c} k={k}, |alpha*u| up to {u:.3g}: rel={rel:.3e} "
        f"(tol {KERNEL_TOL['bfloat16']:g})")
    if not (rel <= KERNEL_TOL["bfloat16"] and u >= 1e4):
        raise AssertionError(f"wgmma at large arguments: rel {rel:.3e}, "
                             f"|alpha*u| {u:.3g}")


def synth_legs(cfg):
    """(C, k, dil) of the 48 generator legs of one synth."""
    ch0 = cfg.upsample_initial_channel
    legs = []
    for i in range(len(cfg.upsample_rates)):
        c = ch0 // 2 ** (i + 1)
        blocks = [(int(k), [int(d) for d in ds]) for k, ds in
                  zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)]
        blocks.append((7 if i + 1 < len(cfg.upsample_rates) else 11, [1, 3, 5]))
        for k, ds in blocks:
            for d in ds:
                legs += [(c, k, d), (c, k, 1)]
    return legs


def kokoro_config(compute_dtype="bfloat16", transfer_dtype="float16"):
    """Kokoro-82M at the published dims (hexgrad/Kokoro-82M config.json,
    as tests/real_configs.py)."""
    from mlx_audio_tpu_torch.tts.models.kokoro import ModelConfig

    vocab = {ch: i + 1 for i, ch in enumerate(
        "abcdefghijklmnopqrstuvwxyz ˈˌəɹʃʒðθæɑɔɛɜɪʊʌiuAIOWY.,!?;:'\"-")}
    return ModelConfig(
        istftnet=dict(
            resblock_kernel_sizes=[3, 7, 11], upsample_rates=[10, 6],
            upsample_initial_channel=512,
            resblock_dilation_sizes=[[1, 3, 5]] * 3,
            upsample_kernel_sizes=[20, 12], gen_istft_n_fft=20,
            gen_istft_hop_size=5),
        dim_in=64, hidden_dim=512, max_conv_dim=512, max_dur=50, n_layer=3,
        n_mels=80, n_token=178, style_dim=128, text_encoder_kernel_size=5,
        plbert=dict(num_hidden_layers=12, num_attention_heads=12,
                    hidden_size=768, intermediate_size=2048,
                    max_position_embeddings=512, embedding_size=128,
                    dropout=0.1),
        vocab=vocab, compute_dtype=compute_dtype, transfer_dtype=transfer_dtype)


def phase_reference_check():
    """Small input, f32: CUDA path vs the same seeded model on the CPU."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.tts.models.kokoro import FRAME_BUCKETS, Model
    from mlx_audio_tpu_torch.tts.models.kokoro.kokoro import _bucket

    cfg = kokoro_config("float32", "float32")
    gpu = Model(cfg, device="cuda").init_params(seed=0)
    cpu = Model(cfg, device="cpu").init_params(seed=0)
    bf16 = Model(kokoro_config("bfloat16", "float32"),
                 device="cuda").init_params(seed=0)
    ids_list = [0, *gpu.phonemes_to_ids("hɛlO"), 0]
    ids = torch.tensor([ids_list])
    valid = torch.ones_like(ids, dtype=torch.bool)
    ref_s = torch.from_numpy(
        (np.random.RandomState(1).randn(1, 256) * 0.1).astype(np.float32))
    with torch.inference_mode():
        dg, tg, pdg, totg = gpu._run_frontend(ids.cuda(), valid.cuda(),
                                              ref_s.cuda(), 1.0)
        dc, tc, _, _ = cpu._run_frontend(ids, valid, ref_s, 1.0)
        pred_dur = pdg.cpu()
        fb = _bucket(int(totg.item()), FRAME_BUCKETS)
        ag, _ = gpu._run_acoustic(dg, tg, pdg, ref_s.cuda(), fb)
        ac, _ = cpu._run_acoustic(dc, tc, pred_dur, ref_s, fb)
        ab, _ = bf16._run_acoustic(dg, tg, pdg, ref_s.cuda(), fb)
    errs = {"d": rel_err(dg.cpu(), dc), "t_en": rel_err(tg.cpu(), tc),
            "audio": rel_err(ag.cpu(), ac)}
    n = int(totg) * gpu.samples_per_frame
    b_rel = rel_err(ab[0, :n].cpu(), ac[0, :n])
    b_corr = float(torch.corrcoef(torch.stack(
        [ab[0, :n].cpu().double(), ac[0, :n].double()]))[0, 1])
    log(f"[reference] f32 {len(ids_list)} tokens, {int(totg)} frames "
        f"(bucket {fb}), CUDA vs CPU rel err: "
        + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (tol {E2E_TOL:g}); bf16 CUDA vs f32 CPU audio rel err "
        f"{b_rel:.3e} (tol {BF16_TOL:g}), corr {b_corr:.6f} "
        f"(min {BF16_CORR:g})")
    if not (torch.isfinite(ag).all() and torch.isfinite(ab).all()):
        raise AssertionError("CUDA audio not finite")
    if not (b_rel <= BF16_TOL and b_corr >= BF16_CORR):
        raise AssertionError(f"bf16 vs f32: rel {b_rel:.3e}, corr {b_corr}")
    for name, err in errs.items():
        if not err <= E2E_TOL:
            raise AssertionError(f"CUDA vs CPU {name}: rel {err:.3e}")


def phase_main_path(card: str, voice_dir: Path):
    """Three generate() requests at the published dims, bf16, cold and warm.
    Returns the kernel's launch count over the run."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.tts.models.kokoro import Model

    class Recording(Model):
        """Keeps each synth's total frame count."""

        def __call__(self, *args, **kwargs):
            audio, pred_dur = super().__call__(*args, **kwargs)
            self.frames.append(int(pred_dur.sum()))
            return audio, pred_dur

    t0 = time.perf_counter()
    model = Recording(kokoro_config(), device="cuda").init_params(seed=0)
    model.frames = []
    torch.cuda.synchronize()
    log(f"[main] Kokoro {model.num_params():,} params on cuda, decoder "
        f"{model.compute_dtype}, built in {time.perf_counter() - t0:.2f} s")
    (voice_dir / "voices").mkdir()
    pack = (np.random.RandomState(0).randn(510, 1, 256) * 0.1).astype(np.float32)
    np.save(voice_dir / "voices" / "af_smoke.npy", pack)
    model.config.model_path = str(voice_dir)
    legs_per_synth = len(synth_legs(model.istft_cfg))

    snake_conv_kernel.launches = 0
    snake_conv_kernel.path_launches = dict.fromkeys(
        snake_conv_kernel.path_launches, 0)
    total_launches = 0
    for run in ("cold", "warm"):
        for text in TEXTS:
            before = snake_conv_kernel.launches
            by_path = dict(snake_conv_kernel.path_launches)
            results = list(model.generate(text, voice="af_smoke"))
            launches = snake_conv_kernel.launches - before
            wgmma = snake_conv_kernel.path_launches["wgmma"] - by_path["wgmma"]
            total_launches += launches
            if len(results) != 1:
                raise AssertionError(f"{len(results)} segments for one line")
            r = results[0]
            frames = model.frames[-1]
            audio = np.asarray(r.audio)
            if r.samples != frames * model.samples_per_frame:
                raise AssertionError(f"{r.samples} samples for {frames} frames")
            if audio.shape != (r.samples,) or not np.isfinite(audio).all():
                raise AssertionError("audio has the wrong shape or is not finite")
            if launches != legs_per_synth or wgmma != legs_per_synth:
                raise AssertionError(f"{launches} kernel launches, {wgmma} "
                                     f"by wgmma; want {legs_per_synth}")
            audio_s = r.samples / r.sample_rate
            wall = r.processing_time_seconds
            log(f"[main] {run} {r.token_count:3d} phonemes {frames:5d} frames "
                f"{audio_s:7.2f} s audio: wall {wall * 1e3:9.2f} ms, "
                f"xRT {audio_s / wall:8.2f}, {launches} K1 launches "
                f"({wgmma} wgmma), "
                f"peak {r.peak_memory_usage:.2f} GB ({card})")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return total_launches, legs_per_synth, model.istft_cfg


# ---------------------------------------------------------------------------
# Qwen3-TTS with the 8-bit talker (kernel K2)
# ---------------------------------------------------------------------------

# every linear (out, in) of the slice: q; k, v; o; gate, up, codec_head;
# down; text_projection fc1 and fc2 (fc2 is o's shape)
QMM_SHAPES = ((2048, 1024), (1024, 1024), (1024, 2048), (3072, 1024),
              (1024, 3072), (2048, 2048))
QMM_ROWS = (1, 2, 8, 16, 64, 120)
QMM_GROUP = 64
# quantized linears of one qwen3 layer: q, k, v, o, gate, up, down
LINEARS_PER_LAYER = 7
# K2 launches at the qwen3_tts_1b7 dims: a talker pass 28*7 + 1
# (codec_head); step 0 the code predictor's 15 passes of 5*7; a decode step
# both (722); a text_projection call fc1 and fc2
K2_LAUNCHES_FULL_DIMS = {"prefill": 197, "step0": 525, "decode step": 722,
                         "text_projection": 2}
# K2 is timed over a rotation of weight copies of at least twice the 50 MB
# L2, as the decode step finds its weights: each read once per frame
L2_BYTES = 50 * 2 ** 20
HBM_GBS = 3350.0
# small config at f32, CUDA vs CPU: summation order only
QWEN3_E2E_TOL = 1e-4
# full-dims q8 prefill logits, K2 vs qmatmul_reference, both bf16: each
# linear rounds its f32 sum to bf16 (2**-8 relative), in another order, and
# 28 layers carry the difference on; bound and correlation as the Kokoro
# bf16 check's style
Q8_PREFILL_TOL, Q8_PREFILL_CORR = 0.05, 0.999
# (text ids, max_tokens) of phase 7: a short request and the JAX lane's
# (bench.py:285) cut from 100 frames to 50 to keep the run's time, then to
# 30 for phases 41-44; the short request 12 frames (60 until phases 58-61,
# 30 until phases 62-66); temperature 0.9, seed 0
QWEN3_SEED, LANE_TOKENS, SHORT_TOKENS = 0, 30, 12


def qwen3_requests():
    import numpy as np

    rng = np.random.RandomState(1)
    return ((rng.randint(0, 151936, 20), SHORT_TOKENS),
            (np.arange(100, 150), LANE_TOKENS))


def qwen3_config():
    """The qwen3_tts_1b7 lane's dims (bench.py:208-217, equal to the
    qwen3_tts/config.py defaults); codec decoder at its defaults."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import ModelConfig

    return ModelConfig(talker_config=dict(
        vocab_size=3072, hidden_size=1024, intermediate_size=3072,
        num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=8,
        head_dim=128, num_code_groups=16, text_hidden_size=2048,
        text_vocab_size=151936,
        code_predictor_config=dict(
            vocab_size=2048, hidden_size=1024, intermediate_size=3072,
            num_hidden_layers=5, num_attention_heads=16,
            num_key_value_heads=8, head_dim=128, num_code_groups=16)))


def qwen3_small_config():
    """tests/test_qwen3_tts.py::tiny_cfg, tts ids inside its text vocab."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import ModelConfig

    return ModelConfig(
        talker_config=dict(
            vocab_size=300, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=8, num_code_groups=4, text_hidden_size=48,
            text_vocab_size=500, codec_eos_token_id=280, codec_think_id=284,
            codec_nothink_id=285, codec_think_bos_id=286,
            codec_think_eos_id=287, codec_pad_id=278, codec_bos_id=279,
            code_predictor_config=dict(
                vocab_size=256, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=8, num_code_groups=4)),
        tokenizer_config=dict(decoder_config=dict(
            latent_dim=32, codebook_dim=16, codebook_size=256, decoder_dim=64,
            hidden_size=24, intermediate_size=48, head_dim=8,
            num_attention_heads=3, num_hidden_layers=2, num_key_value_heads=3,
            num_quantizers=4, num_semantic_quantizers=1, sliding_window=16,
            upsample_rates=[4, 3], upsampling_ratios=[2, 2])),
        tts_bos_token_id=497, tts_eos_token_id=498, tts_pad_token_id=499)


def _time_graph(fns, reps: int) -> float:
    """Median device ms per call of `fns` run back to back: the round is
    captured once in a CUDA graph and replayed between CUDA events, so the
    host's launch cost (tens of us per call here) is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(fns))
    times.sort()
    return times[len(times) // 2]


def qmm_paths(dtype, m: int):
    """The paths of K2 that take x of `dtype` with `m` rows at group 64,
    the dispatched one first."""
    import torch

    from mlx_audio_tpu_torch.ops.qmm import PATHS, choose_path

    chosen = choose_path(dtype, m, QMM_GROUP)
    takes = [p for p in PATHS if (p != "gemv" or m == 1)
             and (p != "mma" or dtype == torch.bfloat16)]
    return [chosen] + [p for p in takes if p != chosen]


def phase_qmm(card: str, reps: int = 7):
    """K2 against qmatmul_reference at every shape of the slice, by every
    path that takes the shape. Returns {(dtype, out, in, bits, M, path):
    (rel, abs, ms, plain_ms, GB/s)}; the dispatched path is
    qmm_paths(...)[0]."""
    from functools import partial

    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.quant import qmatmul_reference, quantize_weight

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for n, k in QMM_SHAPES:
        w = torch.randn(n, k, generator=g, device=dev) * k ** -0.5
        bias = (0.01 * torch.randn(n, generator=g, device=dev)
                if (n, k) == (2048, 2048) else None)
        for bits in (8, 4):
            q = quantize_weight(w, QMM_GROUP, bits)
            wbytes = n * k + 2 * n * (k // QMM_GROUP) * 4
            copies = [q] + [{name: v.clone() for name, v in q.items()}
                            for _ in range(-(-2 * L2_BYTES // wbytes) - 1)]
            for m in QMM_ROWS:
                x32 = torch.randn(m, k, generator=g, device=dev)
                for dtype in (torch.float32, torch.bfloat16):
                    x = x32.to(dtype)
                    name = str(dtype).split(".")[-1]
                    plain_ms = _time_graph(
                        [partial(qmatmul_reference, x, c["w_q"], c["scales"],
                                 c["biases"], bias) for c in copies], reps)
                    for path in qmm_paths(dtype, m):
                        rel, ab = _qmm_case(
                            x, q, bias, f"({n},{k}) q{bits} M={m} {path}",
                            path)
                        ms = _time_graph(
                            [partial(qmm_kernel, x, c["w_q"], c["scales"],
                                     c["biases"], bias, path=path)
                             for c in copies], reps)
                        nbytes = wbytes + (m * k + m * n) * x.element_size()
                        gbs = nbytes / (ms * 1e-3) / 1e9
                        results[(name, n, k, bits, m, path)] = (
                            rel, ab, ms, plain_ms, gbs)
                        log(f"[qmm] {name:8s} ({n:4d},{k:4d}) q{bits} "
                            f"M={m:3d} {path:4s} rel={rel:.3e} abs={ab:.3e} "
                            f"(tol {KERNEL_TOL[name]:g}) kernel "
                            f"{ms * 1e3:8.2f} us ({gbs:7.1f} GB/s, "
                            f"{100 * gbs / HBM_GBS:5.1f}% of 3.35 TB/s, bound "
                            f"{nbytes / HBM_BPS * 1e6:.3f} us) plain "
                            f"{plain_ms * 1e3:8.2f} us ({card})")
            del copies
    rows = [m for m in QMM_ROWS if m > 1]
    for path in ("mma", "simt"):
        ms, plain = (sum(results[("bfloat16", n, k, 8, m, path)][i]
                         for n, k in QMM_SHAPES for m in rows)
                     for i in (2, 3))
        log(f"[qmm] path {path}: bf16 x, 8-bit codes, M in {rows} at the "
            f"{len(QMM_SHAPES)} shapes, summed: kernel {ms * 1e3:.2f} us, "
            f"plain {plain * 1e3:.2f} us ({card})")
    return results


def _qmm_case(x, q, bias, label: str, path=None):
    """K2 (by `path`, default the dispatched one) vs qmatmul_reference on
    one input: output dtype, shape, finiteness and the relative tolerance
    of x's dtype. -> (rel, abs)."""
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.quant import qmatmul_reference

    args = (x, q["w_q"], q["scales"], q["biases"], bias)
    got, want = qmm_kernel(*args, path=path), qmatmul_reference(*args)
    torch.cuda.synchronize()
    if got.dtype != x.dtype or got.shape != (x.shape[0], q["w_q"].shape[0]):
        raise AssertionError(f"K2 {label}: output {got.dtype} "
                             f"{tuple(got.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"K2 {label}: output not finite")
    rel = rel_err(got, want)
    name = str(x.dtype).split(".")[-1]
    if not rel <= KERNEL_TOL[name]:
        raise AssertionError(f"K2 vs plain {name} {label}: rel {rel:.3e} > "
                             f"{KERNEL_TOL[name]}")
    return rel, float((got.float() - want.float()).abs().max())


def _codes_fed_to_codec(model, **kw):
    """generate() -> (result, the codes it handed decode_full)."""
    seen = []
    hook = model.speech_tokenizer.decoder.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].clone()))
    try:
        (r,) = list(model.generate(**kw))
    finally:
        hook.remove()
    return r, seen[0].cpu()


def phase_qwen3_reference():
    """Small config, f32, one seeded q8 weight set: CUDA vs CPU."""
    import copy

    import numpy as np
    import torch
    import torch.nn.functional as F

    from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.qwen3_tts import FIRST_CHUNK
    from mlx_audio_tpu_torch.utils import apply_quantization

    cpu = Model(qwen3_small_config(), device="cpu").init_params(seed=0)
    apply_quantization(cpu, {"quantization": {"bits": 8, "group_size": 16}},
                       cpu.model_quant_predicate)
    gpu = copy.deepcopy(cpu).to("cuda")
    ids = np.arange(10, 40)[None]
    logits = []
    with torch.inference_mode():
        for m in (cpu, gpu):
            emb, _, _ = m.prepare_inputs(text_ids=ids)
            plen = emb.shape[1]
            logits.append(m._prefill(F.pad(emb, (0, 0, 0, 16 - plen)), plen,
                                     64)[0].cpu())
    kw = dict(text_ids=ids, temperature=0.0, max_tokens=1 + FIRST_CHUNK)
    (rc, cc), (rg, cg) = (_codes_fed_to_codec(m, **kw) for m in (cpu, gpu))
    with torch.inference_mode():
        audio_g = gpu.speech_tokenizer.decoder(cc.cuda()).cpu()
        audio_c = cpu.speech_tokenizer.decoder(cc)
    errs = {"prefill logits": rel_err(logits[1], logits[0]),
            "decode_full audio": rel_err(audio_g, audio_c)}
    log(f"[qwen3 reference] small config f32, q8 gs16: CUDA vs CPU rel err "
        + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (tol {QWEN3_E2E_TOL:g}); greedy codes of one chunk "
        f"({tuple(cc.shape)}) equal: {torch.equal(cc, cg)}")
    for name, err in errs.items():
        if not err <= QWEN3_E2E_TOL:
            raise AssertionError(f"CUDA vs CPU {name}: rel {err:.3e}")
    if not torch.equal(cc, cg):
        raise AssertionError(f"greedy codes differ:\n{cc}\n{cg}")
    if not (np.isfinite(rg.audio).all() and rg.samples == rc.samples):
        raise AssertionError("CUDA audio not finite or of another length")


def build_qwen3():
    """Full dims, bf16 weights drawn on the card from seed 0, then the AR
    path quantized to affine 8-bit, group 64 (bench.py:225-279's order)."""
    import torch

    from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model
    from mlx_audio_tpu_torch.utils import apply_quantization

    t0 = time.perf_counter()
    model = Model(qwen3_config(), device="cuda").astype(torch.bfloat16)
    model.init_params(seed=0, on_device=True)
    n_dense = model.num_params()
    apply_quantization(model, {"quantization": {"bits": 8,
                                                "group_size": QMM_GROUP}},
                       model.model_quant_predicate)
    torch.cuda.synchronize()
    log(f"[qwen3] {n_dense:,} params, bf16 on cuda, AR path q8 gs{QMM_GROUP}, "
        f"built in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    return model


def phase_qwen3_q8_prefill(model):
    """Full dims: prefill logits with K2 vs the same q8 model through
    qmatmul_reference, on the card."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from mlx_audio_tpu_torch.ops import quant

    ids = np.arange(100, 150)[None]
    out = []
    with torch.inference_mode():
        emb, _, _ = model.prepare_inputs(text_ids=ids)
        plen = emb.shape[1]
        emb = F.pad(emb, (0, 0, 0, 16 - plen))
        out.append(model._prefill(emb, plen, 256)[0].float())
        kernel_qmatmul = quant.qmatmul
        quant.qmatmul = quant.qmatmul_reference
        try:
            out.append(model._prefill(emb, plen, 256)[0].float())
        finally:
            quant.qmatmul = kernel_qmatmul
    rel = rel_err(out[0], out[1])
    corr = float(torch.corrcoef(torch.stack(out)[:, 0].double())[0, 1])
    log(f"[qwen3 q8 prefill] full dims, bf16: K2 vs qmatmul_reference logits "
        f"rel err {rel:.3e} (tol {Q8_PREFILL_TOL:g}), corr {corr:.6f} "
        f"(min {Q8_PREFILL_CORR:g})")
    if not (torch.isfinite(out[0]).all() and rel <= Q8_PREFILL_TOL
            and corr >= Q8_PREFILL_CORR):
        raise AssertionError(f"q8 prefill: rel {rel:.3e}, corr {corr}")


def k2_per_pass(model):
    """K2 launches of (one talker pass, one code-predictor pass, one
    text_projection call), derived from the config: every qwen3 layer runs
    LINEARS_PER_LAYER quantized linears, the talker pass adds codec_head,
    text_projection is fc1 and fc2. Raises unless the model holds exactly
    that many QuantizedLinear modules in each part: a linear left dense
    would run through cuBLAS, and the launch count would not see it."""
    from mlx_audio_tpu_torch.nn import QuantizedLinear

    tc = model.tcfg
    want = (LINEARS_PER_LAYER * tc.num_hidden_layers + 1,
            LINEARS_PER_LAYER * tc.code_predictor_config.num_hidden_layers,
            2)

    def count(*modules):
        return sum(isinstance(m, QuantizedLinear)
                   for module in modules for m in module.modules())

    t = model.talker
    have = (count(t.model.layers, t.codec_head), count(t.code_predictor),
            count(t.text_projection))
    if have != want or count(model) != sum(want):
        raise AssertionError(
            f"quantized linears (talker, code predictor, text_projection) "
            f"{have}, {count(model)} in all; the config gives {want}")
    return want


def expected_k2_launches(model, run):
    """K2 launches of one generate(): the prefill is one talker pass; step 0
    runs the code predictor's G-1 passes; each decode step one talker pass
    and G-1 code-predictor passes; each text_projection call its two
    linears."""
    talker, cp, tp = k2_per_pass(model)
    g1 = model.tcfg.num_code_groups - 1
    return (talker + g1 * cp + (talker + g1 * cp) * run["decode_steps"]
            + tp * run["text_projection_calls"])


def expected_decode_steps(frames: int, max_tokens: int) -> int:
    """Steps the chunk loop runs for `frames` kept frames: FIRST_CHUNK, then
    CHUNK_TOKENS, each cut to the token budget; EOS at decode step s (then
    frames == s < max_tokens) stops the loop STEPS_AFTER_EOS steps later,
    or at the end of its chunk if that comes first."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.qwen3_tts import (
        CHUNK_TOKENS, FIRST_CHUNK, STEPS_AFTER_EOS)

    total, end = 1, 0
    while total < max_tokens:
        chunk = min(FIRST_CHUNK if total <= 1 else CHUNK_TOKENS,
                    max_tokens - total)
        end += chunk
        if total + chunk > frames:      # EOS in this chunk, at step frames
            return min(frames + STEPS_AFTER_EOS, end)
        total += chunk
    return end


class K2Recorder:
    """While active, counts K2's launches through `ops.quant.qmatmul` by
    (M, out, in, has bias) in `calls` and by the path `choose_path` gives
    them in `paths`; `shapes()` gives each of those shapes with the width
    of the codes it was launched on."""

    def __init__(self):
        from collections import Counter

        self.calls, self.paths = Counter(), Counter()
        # id(codes) -> (a weak reference to them, their largest code on the
        # card), read once a weight; (shape, id(largest)) -> largest
        self._top, self._seen = {}, {}

    def shapes(self) -> set:
        """{(M, out, in, has bias, bits)} of the launches recorded; `bits`
        from the largest code of the weight, which min-max affine codes
        (quantize_weight, an MLX packing) reach: 2**bits - 1."""
        return {(*key[:4], int(top).bit_length())
                for key, top in self._seen.items()}

    def __enter__(self):
        import weakref

        from mlx_audio_tpu_torch.ops import quant
        from mlx_audio_tpu_torch.ops.qmm import choose_path, qmm_kernel

        def recording(x, w_q, scales, biases, bias=None):
            key = (x.shape[0], *w_q.shape, bias is not None)
            self.calls[key] += 1
            self.paths[choose_path(x.dtype, x.shape[0],
                                   w_q.shape[1] // scales.shape[1])] += 1
            ref, top = self._top.get(id(w_q), (None, None))
            if ref is None or ref() is not w_q:
                top = w_q.max()             # no host sync: read at the end
                self._top[id(w_q)] = (weakref.ref(w_q), top)
            self._seen.setdefault((*key, id(top)), top)
            return qmm_kernel(x, w_q, scales, biases, bias)

        quant.qmm_kernel = recording
        return self

    def __exit__(self, *exc):
        from mlx_audio_tpu_torch.ops import quant
        from mlx_audio_tpu_torch.ops.qmm import qmm_kernel

        quant.qmm_kernel = qmm_kernel


def phase_qwen3_main(model, card: str, recorder: K2Recorder) -> int:
    """Three generate(text_ids=...) requests, q8: the short one cold, the
    JAX lane's cold then warm. Returns K2's launch count over them;
    `recorder` gathers the (M, out, in, has bias) K2 was launched with."""
    talker, cp, tp = k2_per_pass(model)
    g1 = model.tcfg.num_code_groups - 1
    counts = {"prefill": talker, "step0": g1 * cp,
              "decode step": talker + g1 * cp, "text_projection": tp}
    log(f"[qwen3 main] K2 launches per decode step: {talker} (talker) + "
        f"{g1} x {cp} (code predictor) = {counts['decode step']}")
    if counts != K2_LAUNCHES_FULL_DIMS:
        raise AssertionError(f"K2 launches {counts}, want "
                             f"{K2_LAUNCHES_FULL_DIMS} at full dims")
    with recorder:
        total = _qwen3_requests(model, card)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return total


def _qwen3_requests(model, card: str) -> int:
    """The two requests of phase 7, cold (the lane's ran warm too until
    phases 45-48 came); returns K2's launches over them."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel

    qmm_kernel.launches = 0
    total = 0
    short, lane = qwen3_requests()
    for run, (ids, max_tokens) in (("cold", short), ("cold", lane)):
        before = qmm_kernel.launches
        torch.cuda.reset_peak_memory_stats()
        (r,) = list(model.generate(text_ids=ids[None], temperature=0.9,
                                   max_tokens=max_tokens,
                                   seed=QWEN3_SEED))
        launches = qmm_kernel.launches - before
        total += launches
        frames, steps = r.token_count, model.last_run["decode_steps"]
        want = expected_k2_launches(model, model.last_run)
        if launches != want:
            raise AssertionError(f"{launches} K2 launches, want {want} "
                                 f"({model.last_run})")
        if frames > 1 and steps != expected_decode_steps(frames,
                                                         max_tokens):
            raise AssertionError(f"{steps} decode steps for {frames} "
                                 f"frames of {max_tokens}")
        audio = np.asarray(r.audio)
        if r.samples != frames * model.total_upsample:
            raise AssertionError(f"{r.samples} samples for {frames} "
                                 f"frames")
        if audio.shape != (r.samples,) or not np.isfinite(audio).all():
            raise AssertionError("audio has the wrong shape or is not "
                                 "finite")
        audio_s = r.samples / r.sample_rate
        wall = r.processing_time_seconds
        log(f"[qwen3 main] {run} {len(ids):3d} text ids max_tokens "
            f"{max_tokens:3d}: {frames:3d} frames ({steps} decode steps) "
            f"{audio_s:6.2f} s audio: wall {wall * 1e3:9.2f} ms "
            f"({wall * 1e3 / max(steps + 1, 1):6.2f} ms/frame), xRT "
            f"{audio_s / wall:6.3f}, {launches} K2 launches, peak "
            f"{r.peak_memory_usage:.2f} GB ({card})")
    return total


def phase_qmm_path(shapes) -> float:
    """K2 against qmatmul_reference at every (M, out, in, bias, bits)
    the main paths launched it with (the prefill bucket, the code
    predictor's first sub-step at M=2, text_projection over the text ids,
    the session's frame at M=8 and 16 and its burst prefill, Orpheus's
    linears at 4 bits, ...; `K2Recorder.shapes`), codes of that width,
    group 64, x in f32 and bf16. Returns the largest bf16 abs error."""
    import torch

    from mlx_audio_tpu_torch.ops.quant import quantize_weight

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    weights = {}
    worst = 0.0
    for m, n, k, has_bias, bits in sorted(shapes):
        if (n, k, bits) not in weights:
            weights[(n, k, bits)] = quantize_weight(
                torch.randn(n, k, generator=g, device=dev) * k ** -0.5,
                QMM_GROUP, bits)
        q = weights[(n, k, bits)]
        bias = (0.01 * torch.randn(n, generator=g, device=dev)
                if has_bias else None)
        x32 = torch.randn(m, k, generator=g, device=dev)
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            errs.append(_qmm_case(x32.to(dtype), q, bias,
                                  f"({n},{k}) q{bits} M={m}"))
        worst = max(worst, errs[1][1])
        log(f"[qmm path] ({n:5d},{k:5d}) q{bits} M={m:4d} "
            f"bias={has_bias!s:5s} rel f32 {errs[0][0]:.3e} bf16 "
            f"{errs[1][0]:.3e}")
    return worst


# ---------------------------------------------------------------------------
# Qwen3-TTS streaming and continuous batching (phases 9-11)
# ---------------------------------------------------------------------------

# phase 10: the JAX lane's streamed request (bench.py:303-305), and
# phase 11: its batched session (bench.py:761-803), each cut from 100
# frames to 50 to keep the run's time; the session's then to 20 to make
# room for phases 38-40, the stream's to 30 for phases 41-44
STREAM_IDS, STREAM_TOKENS, STREAM_INTERVAL, STREAM_SEED = (100, 150), 30, \
    2.0, 1
SESSION_B, SESSION_TOKENS, SESSION_INTERVAL, SESSION_CACHE = 8, 20, 0.4, \
    1024
# streamed against one-shot decode on the card, f32: the CPU tests' bound
STREAM_FULL_ATOL = 2e-4


def draw_codec_biases(model, seed: int = 0, scale: float = 0.1) -> int:
    """Every bias of the codec decoder (its convs, the upsample stages' and
    decoder blocks' transposed convs) drawn N(0, scale) from a numpy seed,
    in place: a trained checkpoint's are not zero, and a transposed conv's
    streamed overflow must carry its bias once. -> biases drawn."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    n = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("speech_tokenizer.decoder.") and \
                    name.endswith(".bias"):
                p.copy_(torch.from_numpy(
                    (rng.randn(*p.shape) * scale).astype(np.float32)))
                n += 1
    return n


def _small_pair():
    """The small config at f32 from one seeded q8 weight set, its codec's
    biases drawn N(0, 0.1): (CPU model, the same weights on the card)."""
    import copy

    from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model
    from mlx_audio_tpu_torch.utils import apply_quantization

    cpu = Model(qwen3_small_config(), device="cpu").init_params(seed=0)
    apply_quantization(cpu, {"quantization": {"bits": 8, "group_size": 16}},
                       cpu.model_quant_predicate)
    draw_codec_biases(cpu)
    return cpu, copy.deepcopy(cpu).to("cuda")


def _session_run(model, options, requests, admit_after=()):
    """Submit `requests` (text-id ranges) to a new session of `model`, the
    ones whose index is in `admit_after` after the first step; step until
    idle. -> ({slot: codes}, [audio of each request])."""
    import numpy as np

    from mlx_audio_tpu_torch.server_inference import InferenceRequest

    sess = model.create_tts_batch_session(options)
    seen = {}
    decode = type(sess)._decode_batch.__get__(sess)

    def recording(rows):
        for slot, _ in rows:
            seen[slot] = np.concatenate(sess.codes[slot], axis=0).copy()
        return decode(rows)

    sess._decode_batch = recording
    reqs = [InferenceRequest(endpoint_kind="tts", model_name="smoke",
                             payload=None,
                             normalized_kwargs={"text_ids": np.arange(*r)[None]})
            for r in requests]
    for i, r in enumerate(reqs):
        if i not in admit_after:
            sess.submit(r)
    sess.step()
    for i in admit_after:
        sess.submit(reqs[i])
    for _ in range(200):
        if sess.idle:
            break
        sess.step()
    if not sess.idle:
        raise AssertionError("session did not finish")
    audio = []
    for r in reqs:
        kinds, parts = [], []
        while not r.result_queue.empty():
            c = r.result_queue.get()
            kinds.append(c.kind)
            if c.kind == "data":
                parts.append(c.payload["audio"])
        if kinds[-1:] != ["done"] or "error" in kinds:
            raise AssertionError(f"request ended {kinds}")
        audio.append(np.concatenate(parts) if parts else np.zeros(0))
    return seen, audio


def phase_qwen3_streaming_reference():
    """Small config, f32, one seeded q8 weight set: the streaming path and
    the session on the card against the CPU."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.tts.continuous import TTSBatchOptions
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.speech_tokenizer import (
        init_stream_state)

    cpu, gpu = _small_pair()
    kw = dict(text_ids=np.arange(10, 40)[None], temperature=0.0,
              max_tokens=30, stream=True, streaming_interval=0.4)
    rc, rg = (list(m.generate(**kw)) for m in (cpu, gpu))
    sizes = [r.samples for r in rc]
    if [r.samples for r in rg] != sizes or not rc[-1].is_final_chunk \
            or not rg[-1].is_final_chunk:
        raise AssertionError(f"streamed chunks differ: "
                             f"{[r.samples for r in rg]} vs {sizes}")
    ac, ag = (np.concatenate([r.audio for r in rs]) for rs in (rc, rg))
    stream_rel = rel_err(torch.from_numpy(ag), torch.from_numpy(ac))
    # the streaming codec on the card against its one-shot decode
    dec = gpu.speech_tokenizer.decoder
    codes = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (2, 4, 24))).to(gpu.device)
    with torch.inference_mode():
        full = dec(codes)
        state = init_stream_state(gpu.dcfg, 2, device=gpu.device)
        parts = []
        for a, b in ((0, 5), (5, 6), (6, 14), (14, 24)):
            state, chunk = dec.streaming_step(state, codes[:, :, a:b])
            parts.append(chunk)
    codec_abs = float((torch.cat(parts, -1) - full).abs().max())
    opts = dict(max_batch_size=2, max_tokens=16, temperature=0.0,
                repetition_penalty=1.0, streaming_interval=0.4,
                max_cache_len=256)
    (cc, sa_c), (cg, sa_g) = (
        _session_run(m, TTSBatchOptions(**opts), [(10, 25), (30, 42)],
                     admit_after=(1,)) for m in (cpu, gpu))
    codes_equal = sorted(cc) == sorted(cg) and all(
        np.array_equal(cc[s], cg[s]) for s in cc)
    sess_rel = max(rel_err(torch.from_numpy(g), torch.from_numpy(c))
                   for g, c in zip(sa_g, sa_c))
    # each request's streamed audio against the one-shot decode of its codes
    with torch.inference_mode():
        sess_abs = max(float(np.abs(a - dec(torch.from_numpy(
            cg[slot].T[None]).to(gpu.device))[0].cpu().numpy()).max())
            for slot, a in enumerate(sa_g))
    log(f"[qwen3 stream reference] small config f32, q8 gs16, codec biases "
        f"N(0, 0.1), CUDA vs CPU: "
        f"greedy stream chunks {sizes} equal, audio rel {stream_rel:.3e} "
        f"(tol {QWEN3_E2E_TOL:g}); streaming_step over uneven chunks vs "
        f"decode_full on the card abs {codec_abs:.3e} (tol "
        f"{STREAM_FULL_ATOL:g}); two-slot session, one admitted mid-stream: "
        f"codes equal {codes_equal}, audio rel {sess_rel:.3e}, each "
        f"request's audio vs decode_full of its codes abs {sess_abs:.3e}")
    if not (stream_rel <= QWEN3_E2E_TOL and codec_abs <= STREAM_FULL_ATOL
            and codes_equal and sess_rel <= QWEN3_E2E_TOL
            and sess_abs <= STREAM_FULL_ATOL):
        raise AssertionError("streaming or session: CUDA vs CPU, or the "
                             "stream vs decode_full")
    if not all(len(a) > 0 and np.isfinite(a).all() for a in sa_g + [ag]):
        raise AssertionError("CUDA streamed audio empty or not finite")


def phase_qwen3_stream(model, card: str, recorder: K2Recorder) -> int:
    """The JAX lane's streamed request, cold then warm. Returns K2's
    launches over the two."""
    import numpy as np

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel

    spf = model.total_upsample
    qmm_kernel.launches = 0
    total = 0
    with recorder:
        for run in ("cold", "warm"):
            before = qmm_kernel.launches
            t0 = time.perf_counter()
            ttfa, results = None, []
            for r in model.generate(text_ids=np.arange(*STREAM_IDS)[None],
                                    temperature=0.9, max_tokens=STREAM_TOKENS,
                                    stream=True,
                                    streaming_interval=STREAM_INTERVAL,
                                    seed=STREAM_SEED):
                if ttfa is None and r.samples > 0:
                    ttfa = time.perf_counter() - t0
                results.append(r)
            wall = time.perf_counter() - t0
            launches = qmm_kernel.launches - before
            total += launches
            run_info = model.last_run
            want = expected_k2_launches(model, run_info)
            if launches != want:
                raise AssertionError(f"{launches} K2 launches, want {want} "
                                     f"({run_info})")
            frames = results[-1].token_count
            samples = sum(r.samples for r in results)
            audio = np.concatenate([r.audio for r in results])
            if not (results[-1].is_final_chunk and samples == frames * spf
                    and 0 < frames <= STREAM_TOKENS
                    and np.isfinite(audio).all()):
                raise AssertionError(f"stream: {samples} samples for "
                                     f"{frames} frames, final "
                                     f"{results[-1].is_final_chunk}")
            if frames == STREAM_TOKENS and \
                    run_info["decode_steps"] != STREAM_TOKENS - 1:
                raise AssertionError(f"{run_info['decode_steps']} decode "
                                     f"steps for {frames} frames")
            stats = model._last_stream_stats
            audio_s = samples / model.sample_rate
            log(f"[qwen3 stream] {run} {STREAM_IDS[1] - STREAM_IDS[0]} ids "
                f"max_tokens {STREAM_TOKENS} interval {STREAM_INTERVAL}: "
                f"{frames} frames {audio_s:.2f} s audio in "
                f"{sum(r.samples > 0 for r in results)} chunks: time to "
                f"first audio {ttfa * 1e3:.2f} ms, wall {wall * 1e3:.2f} ms "
                f"({wall * 1e3 / frames:.2f} ms/frame), xRT "
                f"{audio_s / wall:.3f}; {stats['n_fetches']} reads, host "
                f"wait {stats['stall_s'] * 1e3:.2f} ms; "
                f"{run_info['decode_steps']} decode steps, "
                f"{run_info['codec_blocks']} codec blocks run; {launches} K2 "
                f"launches ({card})")
    return total


class _SessionCounts:
    """Counts the frames a session's chunks ran and its admission groups,
    by wrapping the session class's methods while active."""

    def __enter__(self):
        from mlx_audio_tpu_torch.tts.models.qwen3_tts.continuous_batching \
            import Qwen3TTSBatchSession as S

        self.frames = self.groups = 0
        self._orig = (S._chunk, S._admit_many)
        chunk, admit = self._orig

        def counting_chunk(sess, k):
            self.frames += k
            return chunk(sess, k)

        def counting_admit(sess, group):
            self.groups += 1
            return admit(sess, group)

        S._chunk, S._admit_many = counting_chunk, counting_admit
        return self

    def __exit__(self, *exc):
        from mlx_audio_tpu_torch.tts.models.qwen3_tts.continuous_batching \
            import Qwen3TTSBatchSession as S

        S._chunk, S._admit_many = self._orig


def session_k2_launches(model, frames: int, groups: int, tp_calls: int):
    """K2 launches the config gives for a session: a decode frame and an
    admission group (its prefill and batched step 0) are each one talker
    pass and G-1 code-predictor passes; each text_projection call is two."""
    talker, cp, tp = k2_per_pass(model)
    per_frame = talker + (model.tcfg.num_code_groups - 1) * cp
    return per_frame * (frames + groups) + tp * tp_calls


def phase_qwen3_session(model, card: str, recorder: K2Recorder) -> int:
    """One session at b = 8 and a cold burst of 8 requests. Returns K2's
    launches over them."""
    import numpy as np

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.server_inference import InferenceRequest
    from mlx_audio_tpu_torch.tts.continuous import TTSBatchOptions

    spf = model.total_upsample
    t0 = time.perf_counter()
    sess = model.create_tts_batch_session(TTSBatchOptions(
        max_batch_size=SESSION_B, max_tokens=SESSION_TOKENS,
        streaming_interval=SESSION_INTERVAL, max_cache_len=SESSION_CACHE))
    sess.warmup()
    k = sess.frames_per_step
    log(f"[qwen3 session] b={SESSION_B}, {k} frames a step, timeline "
        f"{SESSION_CACHE}, codec stream KV "
        f"{sess.codec_state['tf_caches'][0].k.shape[1]} frames: built and "
        f"warmed up in {(time.perf_counter() - t0) * 1e3:.2f} ms")
    reqs = [InferenceRequest(
        endpoint_kind="tts", model_name="smoke", payload=None,
        normalized_kwargs={"text_ids": np.arange(100 + i, 150 + i)[None]})
        for i in range(SESSION_B)]
    ttfa, audio, kinds = {}, [[] for _ in reqs], [[] for _ in reqs]
    step_walls, per_path = [], {}
    qmm_kernel.launches = 0
    tp0 = model._text_projection_calls
    with recorder, _SessionCounts() as counts:
        t0 = time.perf_counter()
        for r in reqs:
            sess.submit(r)
        want = session_k2_launches(model, 0, 0,
                                   model._text_projection_calls - tp0)
        if qmm_kernel.launches != want:
            raise AssertionError(f"submit: {qmm_kernel.launches} K2 "
                                 f"launches, want {want}")
        for step in range(4 * SESSION_TOKENS):
            if sess.idle:
                break
            before = (qmm_kernel.launches, counts.frames, counts.groups,
                      dict(recorder.paths))
            ts = time.perf_counter()
            sess.step()
            now = time.perf_counter()
            step_walls.append(now - ts)
            for i, r in enumerate(reqs):
                while not r.result_queue.empty():
                    c = r.result_queue.get()
                    kinds[i].append(c.kind)
                    if c.kind == "data":
                        ttfa.setdefault(i, now - t0)
                        audio[i].append(c.payload["audio"])
            launches = qmm_kernel.launches - before[0]
            want = session_k2_launches(model, counts.frames - before[1],
                                       counts.groups - before[2], 0)
            if launches != want:
                raise AssertionError(f"step {step}: {launches} K2 launches, "
                                     f"want {want}")
            paths = {p: n - before[3].get(p, 0)
                     for p, n in recorder.paths.items()
                     if n != before[3].get(p, 0)}
            per_path[tuple(sorted(paths.items()))] = \
                per_path.get(tuple(sorted(paths.items())), 0) + 1
        wall = time.perf_counter() - t0
    launches = qmm_kernel.launches
    if not sess.idle:
        raise AssertionError("the b=8 session did not finish")
    total_s = 0.0
    for i in range(SESSION_B):
        a = np.concatenate(audio[i]) if audio[i] else np.zeros(0)
        if kinds[i][-1:] != ["done"] or "error" in kinds[i] or not len(a) \
                or len(a) % spf or not np.isfinite(a).all():
            raise AssertionError(f"request {i}: {kinds[i]}, {len(a)} "
                                 f"samples")
        total_s += len(a) / model.sample_rate
    if "mma" not in recorder.paths or not any(
            m == 8 for m, *_ in recorder.calls):
        raise AssertionError(f"no mma launch at M = 8: {recorder.paths}")
    tt = sorted(ttfa.values())
    walls = sorted(step_walls)
    log(f"[qwen3 session] cold burst of {SESSION_B} x {SESSION_TOKENS} "
        f"frames: {total_s:.2f} s of audio in {wall * 1e3:.2f} ms, aggregate "
        f"xRT {total_s / wall:.3f}; time to first audio p50 "
        f"{tt[len(tt) // 2] * 1e3:.2f} ms, max {tt[-1] * 1e3:.2f} ms; "
        f"{len(walls)} steps, wall per step median "
        f"{walls[len(walls) // 2] * 1e3:.2f} ms, max {walls[-1] * 1e3:.2f} "
        f"ms ({wall * 1e3 / counts.frames:.2f} ms per frame of all rows); "
        f"{launches} K2 launches ({card})")
    for paths, n in sorted(per_path.items(), key=lambda kv: -kv[1]):
        log(f"[qwen3 session] K2 launches per path in {n} step(s): "
            f"{dict(paths)}")
    return launches


def _qlinear_shapes(module):
    """(out, in) of each quantized linear in `module`, in module order."""
    from mlx_audio_tpu_torch.nn import QuantizedLinear

    return [tuple(m.w_q.shape) for m in module.modules()
            if isinstance(m, QuantizedLinear)]


def frame_linears(model):
    """(out, in) of every K2 launch of one decode step."""
    t = model.talker
    g1 = model.tcfg.num_code_groups - 1
    return (_qlinear_shapes(t.model.layers) + _qlinear_shapes(t.codec_head)
            + g1 * _qlinear_shapes(t.code_predictor))


def session_frame_linears(model, b: int):
    """(M, out, in) of every K2 launch of one decode frame of a session of
    b slots: the talker's linears at M = b, the code predictor's first
    sub-step ([hidden, code 0]) at M = 2b and its other sub-steps at b."""
    t = model.talker
    talker = _qlinear_shapes(t.model.layers) + _qlinear_shapes(t.codec_head)
    cp = _qlinear_shapes(t.code_predictor)
    g1 = model.tcfg.num_code_groups - 1
    return ([(b, n, k) for n, k in talker] + [(2 * b, n, k) for n, k in cp]
            + (g1 - 1) * [(b, n, k) for n, k in cp])


# ---------------------------------------------------------------------------
# Whisper (phases 12-14)
# ---------------------------------------------------------------------------

# tests/test_whisper.py:14-17: the small config of the CUDA-vs-CPU check
WHISPER_SMALL = dict(n_mels=80, n_audio_ctx=100, n_audio_state=32,
                     n_audio_head=2, n_audio_layer=2, n_vocab=51865,
                     n_text_ctx=64, n_text_state=32, n_text_head=2,
                     n_text_layer=2)
# large-v3-turbo, the JAX lane's dims (bench.py:892-895)
WHISPER_TURBO = dict(n_mels=128, n_audio_ctx=1500, n_audio_state=1280,
                     n_audio_head=20, n_audio_layer=32, n_vocab=51866,
                     n_text_ctx=448, n_text_state=1280, n_text_head=20,
                     n_text_layer=4)
# the JAX lane's workload (bench.py:898-905): randn * 0.1, seed 0, its
# 600 s cut to 300 s to make room for phases 38-40, then to 180 s for
# phases 41-44 and to 90 s for phases 58-61
WHISPER_SECONDS = 90
# the streaming session's 1-s chunks (ten until phases 62-66)
WHISPER_STREAM_CHUNKS = 6
WHISPER_KW = dict(language="en", temperature=0.0,
                  compression_ratio_threshold=None, logprob_threshold=None,
                  no_speech_threshold=None, return_timestamps=True,
                  sample_len=100)
# CUDA against the CPU at f32: log-mel (cuFFT against the CPU's FFT, f64)
MEL_ATOL = 1e-4
# bf16 encoder against f32 on one 30-s window, relative Frobenius error
WHISPER_BF16_REL = 2e-2
WHISPER_HF_NAMES = (
    (".blocks.", ".layers."),
    (".cross_attn.query.", ".encoder_attn.q_proj."),
    (".cross_attn.key.", ".encoder_attn.k_proj."),
    (".cross_attn.value.", ".encoder_attn.v_proj."),
    (".cross_attn.out.", ".encoder_attn.out_proj."),
    (".cross_attn_ln.", ".encoder_attn_layer_norm."),
    (".attn.query.", ".self_attn.q_proj."), (".attn.key.", ".self_attn.k_proj."),
    (".attn.value.", ".self_attn.v_proj."), (".attn.out.", ".self_attn.out_proj."),
    (".attn_ln.", ".self_attn_layer_norm."), (".mlp_ln.", ".final_layer_norm."),
    (".mlp1.", ".fc1."), (".mlp2.", ".fc2."),
    ("encoder.ln_post.", "encoder.layer_norm."),
    ("decoder.ln.", "decoder.layer_norm."),
    ("decoder.token_embedding.", "decoder.embed_tokens."),
    ("decoder.positional_embedding", "decoder.embed_positions.weight"))


def _whisper(dims: dict, device: str, like=None):
    """A Whisper model on `device`: seeded (seed 0, drawn on the CPU) or
    with the parameters of `like`."""
    from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions

    model = Model(ModelDimensions(**dims), device=device)
    if like is None:
        return model.init_params(seed=0)
    model.load_state_dict(like.state_dict())
    return model


def whisper_eval_small(device: str):
    """WHISPER_SMALL at seed 0 with the end-of-text row of its tied token
    table zeroed, so that a greedy decode writes text rather than ending
    at once: the eval CLI's model (phase 61, tests/test_torch_stt_eval.py)."""
    import torch

    model = _whisper(WHISPER_SMALL, device)
    with torch.no_grad():
        model.decoder.token_embedding.weight[50257] = 0.0
    return model


def _segments_equal(a, b, what: str) -> None:
    """Tokens, texts, seeks, segment times and word times equal."""
    if a.text != b.text or len(a.segments) != len(b.segments):
        raise AssertionError(f"{what}: texts or segment counts differ")
    for x, y in zip(a.segments, b.segments):
        for k in ("seek", "tokens", "text", "start", "end"):
            if x[k] != y[k]:
                raise AssertionError(f"{what}: segment {k} {x[k]!r} != "
                                     f"{y[k]!r}")
        wx = [(w["word"], w["start"], w["end"]) for w in x.get("words", [])]
        wy = [(w["word"], w["start"], w["end"]) for w in y.get("words", [])]
        if wx != wy:
            raise AssertionError(f"{what}: word times differ: {wx} != {wy}")


def phase_whisper_reference() -> None:
    """The small config at f32 from one seeded weight set, CUDA against the
    CPU: the whole-file log-mel, then greedy generate() on 6 s of seeded
    noise with timestamps and word timestamps."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.stt.models.whisper.audio import (
        log_mel_spectrogram)

    cpu = _whisper(WHISPER_SMALL, "cpu")
    gpu = _whisper(WHISPER_SMALL, "cuda", like=cpu)
    audio = (np.random.RandomState(0).randn(16000 * 6) * 0.05).astype(
        np.float32)
    mel_c = log_mel_spectrogram(audio, 80, padding=cpu.window_samples)
    mel_g = log_mel_spectrogram(audio, 80, padding=cpu.window_samples,
                                device="cuda")
    mel_err = float((mel_g.cpu() - mel_c).abs().max())
    if not mel_err <= MEL_ATOL:
        raise AssertionError(f"log-mel CUDA vs CPU {mel_err:.3e} > {MEL_ATOL}")
    kw = dict(language="en", temperature=0.0, word_timestamps=True)
    want = cpu.generate(audio, **kw)
    got = gpu.generate(audio, **kw)
    _segments_equal(got, want, "small Whisper CUDA vs CPU")
    n_words = sum(len(s["words"]) for s in got.segments)
    if not got.segments or not n_words:
        raise AssertionError("small Whisper: no segments or no words")
    log(f"[whisper-ref] small config f32, 6 s: log-mel CUDA vs CPU "
        f"{mel_err:.2e} abs (tol {MEL_ATOL}); {len(got.segments)} segments, "
        f"{sum(len(s['tokens']) for s in got.segments)} tokens, {n_words} "
        f"words: tokens, segment and word times equal; "
        f"{gpu.last_run['windows']} windows, {gpu.last_run['decode_steps']} "
        f"decode steps on the card")


def whisper_encoder_flops(d: dict) -> float:
    """Operations (2 per multiply-add) of one window through the encoder:
    the two stem convs, then per layer q, k, v, out, the two attention
    products and the MLP."""
    t, c, w = d["n_audio_ctx"], d["n_audio_state"], 2 * d["n_audio_ctx"]
    stem = 2 * w * d["n_mels"] * c * 3 + 2 * t * c * c * 3
    layer = 4 * 2 * t * c * c + 2 * 2 * t * t * c + 2 * 2 * t * c * 4 * c
    return stem + d["n_audio_layer"] * layer


def build_whisper_turbo():
    """(f32, bf16) large-v3-turbo models on the card with one weight set:
    drawn there in f32 from seed 0, the bf16 copy cast from it."""
    import torch

    from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions

    f32 = Model(ModelDimensions(**WHISPER_TURBO), device="cuda").init_params(
        seed=0, on_device=True)
    return f32, _whisper(WHISPER_TURBO, "cuda", like=f32).astype(
        torch.bfloat16)


def phase_whisper_turbo(card: str) -> dict:
    """Whisper large-v3-turbo at full width on the card: the bf16 encoder
    against f32 on one window, the encoder's time per window, the JAX
    lane's transcription (cut to WHISPER_SECONDS) cold then warm, and the streaming
    session over WHISPER_STREAM_CHUNKS 1-s chunks."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.stt.models.whisper.audio import pad_or_trim

    t0 = time.perf_counter()
    f32, model = build_whisper_turbo()
    torch.cuda.synchronize()
    n_params = model.num_params()
    log(f"[whisper] large-v3-turbo dims (32 x d1280 encoder, 4-layer "
        f"decoder, 128 mels): {n_params / 1e6:.1f} M parameters drawn on the "
        f"card from seed 0, cast to bf16 ({time.perf_counter() - t0:.2f} s)")
    audio = (np.random.RandomState(0).randn(WHISPER_SECONDS * 16000) * 0.1
             ).astype(np.float32)

    # one 30-s window, bf16 against f32
    mel, _ = model._prepare_audio(audio[:model.window_samples], padding=0)
    win = pad_or_trim(mel, model.window_frames)[None]
    with torch.inference_mode():
        ref = f32.embed_audio(win).float()
        got = model.embed_audio(win).float()
    rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    if not rel < WHISPER_BF16_REL:
        raise AssertionError(f"bf16 encoder vs f32: {rel:.3e} >= "
                             f"{WHISPER_BF16_REL}")
    del f32, ref
    torch.cuda.empty_cache()
    enc_ms = _time_ms(lambda: model.embed_audio(win), 10)
    flops = whisper_encoder_flops(WHISPER_TURBO)
    bound_ms = flops / PEAK_BF16 * 1e3
    log(f"[whisper] bf16 encoder vs f32 on one 30-s window: relative "
        f"Frobenius {rel:.3e} (limit {WHISPER_BF16_REL}); encoder "
        f"{enc_ms:.3f} ms a window (CUDA events, median of 10), "
        f"{flops / 1e12:.3f} TFLOP: {flops / enc_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * bound_ms / enc_ms:.1f}% of 989 TFLOP/s ({card})")

    out = {}
    for label in ("cold", "warm"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = model.generate(audio, **WHISPER_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        run = dict(model.last_run)
        n_tok = sum(len(s["tokens"]) for s in res.segments)
        if not res.segments or not all(
                np.isfinite([s["start"], s["end"], s["avg_logprob"]]).all()
                for s in res.segments):
            raise AssertionError("turbo transcription: no segments, or "
                                 "non-finite times or log-probabilities")
        if run["decodes"] != run["windows"]:
            raise AssertionError(f"{run}: a fallback ran with every "
                                 f"threshold off")
        step_ms = (wall * 1e3 - run["windows"] * enc_ms) / run["decode_steps"]
        log(f"[whisper] {label}: {WHISPER_SECONDS} s in {wall:.3f} s, xRT "
            f"{WHISPER_SECONDS / wall:.2f}; {run['windows']} windows, "
            f"{len(res.segments)} segments, {n_tok} tokens; "
            f"{run['decode_steps']} decode steps, {step_ms:.3f} ms a step "
            f"(wall less the windows' encoder time, per step); encoder "
            f"{run['windows'] * enc_ms / 1e3:.3f} s of it ({card})")
        out[label] = (wall, run, res)
    if out["warm"][2].text != out["cold"][2].text:
        raise AssertionError("turbo: warm transcription differs from cold")

    # the streaming session: WHISPER_STREAM_CHUNKS 1-s chunks, then close()
    sess = model.create_streaming_session(language="en")
    lat, events = [], []
    chunks = [audio[i * 16000:(i + 1) * 16000]
              for i in range(WHISPER_STREAM_CHUNKS)]
    for chunk in chunks + [None]:
        if chunk is None:
            sess.close()
        else:
            sess.feed(chunk)
        while True:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            evs = sess.step()
            lat.append(time.perf_counter() - t1)
            events += evs
            if chunk is not None or sess.done:
                break
    lat_ms = sorted(1e3 * v for v in lat)
    if not events or events[-1].kind != "final":
        raise AssertionError(f"streaming session: no final event "
                             f"({[e.kind for e in events]})")
    log(f"[whisper] streaming session, {WHISPER_STREAM_CHUNKS} 1-s chunks "
        f"then close(): "
        f"{len(lat)} steps, p50 {lat_ms[len(lat_ms) // 2]:.2f} ms, max "
        f"{lat_ms[-1]:.2f} ms a step; {len(events)} events, the last "
        f"'final' ({len(events[-1].text)} chars) ({card})")
    return {"enc_ms": enc_ms, "rel": rel, "warm": out["warm"][:2],
            "model": model}


def write_whisper_checkpoint(model, path: Path) -> None:
    """`model` as an HF-style checkpoint directory: config.json in HF keys
    and the weights under HF names in one npz (no safetensors needed)."""
    import numpy as np

    d = model.dims
    state = {}
    for k, v in model.state_dict().items():
        for a, b in WHISPER_HF_NAMES:
            k = k.replace(a, b)
        state["model." + k] = v.float().cpu().numpy()
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "weights.npz", **state)
    (path / "config.json").write_text(json.dumps(dict(
        model_type="whisper", d_model=d.n_audio_state,
        encoder_layers=d.n_audio_layer, decoder_layers=d.n_text_layer,
        encoder_attention_heads=d.n_audio_head,
        decoder_attention_heads=d.n_text_head, num_mel_bins=d.n_mels,
        vocab_size=d.n_vocab, max_source_positions=d.n_audio_ctx,
        max_target_positions=d.n_text_ctx)))


def start_stt_cli(ckpt: Path, wav: Path, out: Path, what: str):
    """`python -m mlx_audio_tpu_torch.stt.generate --format json` on
    `ckpt` and `wav`, started in a subprocess on the card. -> a function
    that waits for it and returns (its JSON, its seconds from the start)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mlx_audio_tpu_torch.stt.generate", "--model",
         str(ckpt), "--audio", str(wav), "--format", "json", "--output-path",
         str(out)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def wait() -> tuple:
        _, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"STT CLI on {what} failed: {err[-2000:]}")
        return (json.loads((out / "transcription.json").read_text()),
                time.perf_counter() - t0)

    return wait


def phase_whisper_cli(tmp: Path):
    """The normal entry points on the card: a small checkpoint (HF names,
    npz) and a 5-s WAV written with the port's audio_io, the STT CLI
    started in a subprocess. -> the check of its JSON against
    load_model(...).generate(...) here, to call once the CLIs of phase 14
    are started."""
    import numpy as np

    from mlx_audio_tpu_torch import audio_io

    ckpt, wav = tmp / "whisper-small", tmp / "whisper.wav"
    write_whisper_checkpoint(_whisper(WHISPER_SMALL, "cpu"), ckpt)
    audio_io.write(wav, (np.random.RandomState(5).randn(16000 * 5) * 0.05
                         ).astype(np.float32), 16000)
    wait = start_stt_cli(ckpt, wav, tmp / "whisper-out", "Whisper")
    return lambda: _check_whisper_cli(ckpt, wav, wait)


def _check_whisper_cli(ckpt: Path, wav: Path, wait) -> None:
    import mlx_audio_tpu_torch

    got, cli_s = wait()
    model = mlx_audio_tpu_torch.load_model(ckpt)
    if model.device.type != "cuda":
        raise AssertionError("load_model did not load onto the card")
    want = model.generate(str(wav), temperature=0.0)
    want_segs = json.loads(json.dumps(want.segments))
    if got["text"] != want.text or got["language"] != want.language:
        raise AssertionError("STT CLI text differs from load_model(...)")
    if len(got["segments"]) != len(want_segs) or not want_segs:
        raise AssertionError("STT CLI segment count differs")
    for a, b in zip(got["segments"], want_segs):
        for k in b:
            same = (abs(a[k] - b[k]) <= 1e-6 if isinstance(b[k], float)
                    else a[k] == b[k])
            if not same:
                raise AssertionError(f"STT CLI segment {k}: {a[k]!r} != "
                                     f"{b[k]!r}")
    log(f"[whisper-cli] python -m mlx_audio_tpu_torch.stt.generate --format "
        f"json on a small HF-named npz checkpoint and a 5-s WAV, on the card "
        f"({cli_s:.2f} s with its start-up, beside phase 14's other CLIs): "
        f"language {got['language']}, "
        f"{len(got['segments'])} segments, equal to "
        f"mlx_audio_tpu_torch.load_model(...).generate(...) in process")


# ---------------------------------------------------------------------------
# Voxtral Realtime (phases 15-16, and the checkpoint of phase 14)
# ---------------------------------------------------------------------------

# tests/test_voxtral_realtime.py:17-28 with a 2-layer encoder: its window of
# 64 conv frames ends inside a 512-frame mel bucket's padding for inputs
# under about 3.8 s, where the JAX package's bucketed encoder gives NaN
VOXTRAL_SMALL = dict(
    model_type="voxtral_realtime",
    encoder_args=dict(dim=16, n_layers=2, n_heads=2, head_dim=8,
                      hidden_dim=32, n_kv_heads=2, sliding_window=64,
                      downsample_factor=4,
                      audio_encoding_args=dict(num_mel_bins=16)),
    decoder=dict(dim=16, n_layers=1, n_heads=2, n_kv_heads=2, head_dim=8,
                 hidden_dim=32, vocab_size=64, ada_rms_norm_t_cond_dim=4),
    transcription_delay_ms=160, n_left_pad_tokens=2)
# CUDA against the CPU at f32: adapter frames, relative error max|a-b|/max|b|
VOXTRAL_REL = 1e-4
# the JAX lane's workload (bench.py:708-747): 30 s of randn * 0.1 at seed
# 0 (cut to 20 for phases 62-66) after a 6-s warm drive, 1-s feeds each
# followed by step(16), then close() and step(32) until done; then an
# offline generate() of 20 s, a length in the band where the JAX package's
# 32-layer bucketed encoder gives NaN
VOXTRAL_RT_SECONDS, VOXTRAL_WARM_SECONDS, VOXTRAL_OFFLINE_SECONDS = \
    20, 6, 20
# the published consolidated checkpoint's prefixes (voxtral_realtime.py:609)
VOXTRAL_ENC = "mm_streams_embeddings.embedding_module.whisper_encoder"
VOXTRAL_AD = "mm_streams_embeddings.embedding_module"


def voxtral_consolidated_names(flat: dict) -> dict:
    """A flat tree under the port's names (the JAX tree's) -> mistral's
    consolidated-checkpoint names, which `_remap_consolidated` maps back."""
    out = {}
    for key, v in flat.items():
        part, rest = key.split(".", 1)
        rest = rest.replace("feed_forward_w", "feed_forward.w")
        if key == "decoder.tok_embeddings.weight":
            key = f"{VOXTRAL_AD}.tok_embeddings.weight"
        elif key == "decoder.norm.weight":
            key = "norm.weight"
        elif part == "decoder":         # layers.N...
            key = rest.replace(".ada_down.", ".0.").replace(".ada_up.", ".2.")
        elif rest.startswith("conv_layers_"):       # conv_layers_I_conv.conv.p
            key = f"{VOXTRAL_ENC}.conv_layers.{rest[12]}.{rest[19:]}"
        elif rest.startswith("transformer_layers."):
            key = f"{VOXTRAL_ENC}.transformer.layers.{rest[19:]}"
        elif rest.startswith("transformer_norm."):
            key = f"{VOXTRAL_ENC}.transformer.norm.{rest[17:]}"
        else:                           # audio_language_projection_I.p
            key = f"{VOXTRAL_AD}.audio_language_projection.{rest[26:]}"
        out[key] = v
    return out


def write_tekken(path: Path, n_special: int, n_vocab: int) -> None:
    """A tekken.json (the format voxtral_realtime.py:155-176 reads): ids
    below `n_special` are special, id i above them decodes to f"{i} "."""
    import base64

    vocab = [{"token_bytes": base64.b64encode(f"{i} ".encode()).decode()}
             for i in range(n_special, n_vocab)]
    path.write_text(json.dumps({
        "vocab": vocab, "config": {"default_num_special_tokens": n_special},
        "special_tokens": [{"rank": 1}, {"rank": 2}, {"rank": 32}]}))


def write_mistral_tekken(path: Path, n_special: int, n_vocab: int) -> None:
    """A tekken.json for offline Voxtral's `TekkenEncoder`: the named
    special tokens of its transcription prompt at Mistral's ranks (<s> 1,
    </s> 2, [INST] 3, [/INST] 4, [BEGIN_AUDIO] 12, [AUDIO] 24,
    [TRANSCRIBE] 34), then the 256 single bytes and f"<{i}>" pieces up to
    `n_vocab` ids."""
    import base64

    pieces = [bytes([b]) for b in range(256)] + [
        f"<{i}>".encode() for i in range(n_special + 256, n_vocab)]
    names = {"<s>": 1, "</s>": 2, "[INST]": 3, "[/INST]": 4,
             "[BEGIN_AUDIO]": 12, "[AUDIO]": 24, "[TRANSCRIBE]": 34}
    path.write_text(json.dumps({
        "config": {"default_num_special_tokens": n_special},
        "vocab": [{"token_bytes": base64.b64encode(p).decode()}
                  for p in pieces[:n_vocab - n_special]],
        "special_tokens": [{"rank": r, "token_str": n}
                           for n, r in names.items()]}))


def write_voxtral_checkpoint(model, path: Path) -> None:
    """`model` as a checkpoint directory: config.json (audio_encoding_args
    nested in encoder_args, as published), the weights under the
    consolidated names in one npz with the convs in torch's (O, I, k)
    layout, and a tekken.json of 3 special ids (random weights favour low
    ids)."""
    import dataclasses

    import numpy as np

    cfg = dataclasses.asdict(model.config)
    cfg["encoder_args"]["audio_encoding_args"] = cfg.pop(
        "audio_encoding_args")
    del cfg["model_path"]
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "consolidated.npz", **voxtral_consolidated_names(
        {k: v.float().cpu().numpy() for k, v in model.state_dict().items()}))
    (path / "config.json").write_text(json.dumps(cfg))
    write_tekken(path / "tekken.json", 3, model.config.decoder.vocab_size)


def _voxtral_tokens(model, audio) -> list:
    """The offline decode's kept tokens."""
    return [t for new, _, _ in model._run(audio, 4096, None) for t in new]


def phase_voxtral_reference(tmp: Path) -> None:
    """The small config at f32 from one seeded weight set, CUDA against the
    CPU: the offline adapter frames (1 s, whose bucket padding lies past
    the window, and 4.5 s), the greedy offline tokens, and on the card the
    session's tokens and text from uneven feeds against the offline ones;
    everything finite."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        Model, ModelConfig, TekkenTokenizer, voxtral_realtime as vr)

    cfg = ModelConfig.from_dict(VOXTRAL_SMALL)
    cpu = Model(cfg, device="cpu").init_params(seed=0)
    gpu = Model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    write_tekken(tmp / "tekken.json", 3, 64)
    for m in (cpu, gpu):
        m._tokenizer = TekkenTokenizer(str(tmp / "tekken.json"))
    n_delay = vr._num_delay_tokens(cfg.transcription_delay_ms)
    errs = []
    for seconds in (1.0, 4.5):
        audio = (np.random.RandomState(0).randn(int(16000 * seconds))
                 ).astype(np.float32)
        padded = vr._pad_audio_streaming(audio, cfg.n_left_pad_tokens,
                                         n_delay + 11)
        (want, n), (got, n_g) = cpu.encode(padded), gpu.encode(padded)
        if n_g != n or not torch.isfinite(got).all():
            raise AssertionError(f"Voxtral {seconds} s: adapter frames not "
                                 f"finite or counts differ ({n_g}, {n})")
        errs.append(rel_err(got.cpu(), want))
        if not errs[-1] <= VOXTRAL_REL:
            raise AssertionError(f"Voxtral adapter CUDA vs CPU "
                                 f"{errs[-1]:.3e} > {VOXTRAL_REL}")
        toks = _voxtral_tokens(gpu, audio)
        if toks != _voxtral_tokens(cpu, audio) or not toks:
            raise AssertionError(f"Voxtral {seconds} s: offline tokens "
                                 f"differ between CUDA and the CPU, or none")
        sess = gpu.create_streaming_session()
        for i in range(0, len(audio), 3001):
            sess.feed(audio[i:i + 3001])
        sess.close()
        events = []
        while not sess.done:
            events += sess.step(max_decode_tokens=8)
        s_text = "".join(e.text for e in events if e.kind == "delta")
        text = gpu.generate(audio).text
        if events[-1].kind != "final" or not text:
            raise AssertionError("Voxtral session: no final event, or no "
                                 "text")
        if sess.generated != toks or s_text.strip() != text:
            raise AssertionError(f"Voxtral {seconds} s: session tokens or "
                                 f"text differ from offline on the card")
    log(f"[voxtral-ref] small config (2-layer encoder, window 64) f32: "
        f"adapter frames CUDA vs CPU {max(errs):.2e} relative (tol "
        f"{VOXTRAL_REL}), finite at 1 s (bucket padding past the window) "
        f"and 4.5 s; offline tokens equal ({len(toks)} at 4.5 s); the "
        f"session's tokens and text from uneven feeds equal offline")


def voxtral_bytes(model) -> tuple:
    """(encoder step, decode token) bytes of bf16 weights read: the
    encoder's transformer layers per ENC_CHUNK step; the decoder's layers
    and the tied embeddings (the logits) per token."""
    enc = sum(p.numel() for p in model.encoder.transformer_layers.parameters())
    dec = sum(p.numel() for p in model.decoder.parameters())
    return 2 * enc, 2 * dec


def build_voxtral_full():
    """Voxtral-Mini-3B-Realtime (ModelConfig() defaults) on the card, its
    4.43 B parameters drawn there in f32 from seed 0."""
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        Model, ModelConfig)

    return Model(ModelConfig(), device="cuda").init_params(seed=0,
                                                          on_device=True)


def phase_voxtral_full(card: str, tmp: Path) -> dict:
    """Voxtral-Mini-3B-Realtime at full width (ModelConfig() defaults, as
    bench.py:701), 4.43 B parameters drawn on the card in f32 from seed 0:
    one ENC_CHUNK encoder step in bf16 against f32, then in bf16 the JAX
    lane's workload and an offline generate() of 20 s."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.kvcache import KVCache
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        TekkenTokenizer, voxtral_realtime as vr)
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime.streaming import (
        ENC_CHUNK, RING_CAP, encoder_stream_step)

    base = torch.cuda.memory_allocated()       # what earlier phases hold
    t0 = time.perf_counter()
    model = build_voxtral_full()
    torch.cuda.synchronize()
    n_params = model.num_params()
    log(f"[voxtral] Voxtral-Mini-3B-Realtime dims (encoder 32 x d1280, "
        f"decoder 26 x d3072 GQA 32/8, vocabulary 131,072 tied): "
        f"{n_params / 1e9:.3f} B parameters drawn on the card in f32 from "
        f"seed 0 ({time.perf_counter() - t0:.2f} s)")
    e = model.config.encoder_args
    audio = (np.random.RandomState(0).randn(VOXTRAL_RT_SECONDS * 16000)
             * 0.1).astype(np.float32)

    # one ENC_CHUNK encoder step, bf16 against f32, on the conv stem's
    # frames of the workload's first 2 s
    def enc_step(x):
        caches = KVCache.init(1, RING_CAP, e.n_heads, e.head_dim,
                              dtype=torch.float32, device=x.device,
                              n_layers=e.n_layers)
        return encoder_stream_step(model, x, caches, 0, ENC_CHUNK)

    with torch.inference_mode():
        mel = vr.voxtral_mel(torch.from_numpy(audio[:32000]).to(model.device),
                             model.config.audio_encoding_args)
        x = vr.conv_stem(model.encoder, mel[None])[:, :ENC_CHUNK]
        ref = enc_step(x).float()
        model.astype(torch.bfloat16)
        torch.cuda.empty_cache()
        got = enc_step(x.to(torch.bfloat16)).float()
    rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    if not rel < WHISPER_BF16_REL:
        raise AssertionError(f"Voxtral bf16 encoder step vs f32: {rel:.3e} "
                             f">= {WHISPER_BF16_REL}")
    xb = x.to(torch.bfloat16)
    with torch.inference_mode():
        enc_ms = _time_ms(lambda: enc_step(xb), 10)
    enc_b, dec_b = voxtral_bytes(model)
    ring_b = 2 * e.n_layers * RING_CAP * e.n_heads * e.head_dim * 4
    log(f"[voxtral] bf16 ENC_CHUNK encoder step vs f32: relative Frobenius "
        f"{rel:.3e} (limit {WHISPER_BF16_REL}); {enc_ms:.3f} ms a step "
        f"(CUDA events, median of 10), bound {(enc_b + ring_b) / HBM_BPS * 1e3:.3f}"
        f" ms (weights and f32 ring caches read once) ({card})")

    write_tekken(tmp / "tekken.json", 1000, model.config.decoder.vocab_size)
    model._tokenizer = TekkenTokenizer(str(tmp / "tekken.json"))

    def drive(seconds: int):
        sess = model.create_streaming_session(max_tokens=4096)
        lat, events = [], []
        for i in range(seconds):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sess.feed(audio[i * 16000:(i + 1) * 16000])
            events += sess.step(max_decode_tokens=16)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        sess.close()
        for _ in range(500):
            events += sess.step(max_decode_tokens=32)
            if sess.done:
                break
        torch.cuda.synchronize()
        eot = time.perf_counter() - t1
        if not events or events[-1].kind != "final":
            raise AssertionError(f"Voxtral session: no final event "
                                 f"({[ev.kind for ev in events][-3:]})")
        return lat, eot, sess

    t1 = time.perf_counter()
    drive(VOXTRAL_WARM_SECONDS)
    warm_s = time.perf_counter() - t1
    torch.cuda.reset_peak_memory_stats()
    lat, eot, sess = drive(VOXTRAL_RT_SECONDS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ls = sorted(lat)
    p50, p95 = ls[len(ls) // 2], ls[min(len(ls) - 1, int(len(ls) * 0.95))]
    xrt = VOXTRAL_RT_SECONDS / (sum(lat) + eot)
    n_tok = len(sess.generated)
    log(f"[voxtral] realtime_stt lane: {VOXTRAL_RT_SECONDS} x 1-s feeds, "
        f"each "
        f"then step(16), after a {VOXTRAL_WARM_SECONDS}-s warm drive "
        f"({warm_s:.2f} s): step p50 {p50 * 1e3:.2f} ms, p95 "
        f"{p95 * 1e3:.2f} ms, max {ls[-1] * 1e3:.2f} ms; EOT to final "
        f"{eot * 1e3:.2f} ms; xRT {xrt:.3f}; {n_tok} tokens decoded "
        f"({(sum(lat) + eot) * 1e3 / n_tok:.2f} ms a token, the encoder "
        f"included); realtime (p95 < 1 s): {p95 < 1.0}; peak device memory "
        f"{peak_gb:.2f} GB, {peak_gb - base / 1e9:.2f} GB of it this phase's "
        f"(model and session); weights read a token {dec_b / 1e9:.3f} GB, "
        f"bound {dec_b / HBM_BPS * 1e3:.3f} ms ({card})")

    # offline generate() of 20 s: a length where JAX's encoder gives NaN
    off = audio[:VOXTRAL_OFFLINE_SECONDS * 16000]
    n_delay = vr._num_delay_tokens(model.config.transcription_delay_ms)
    adapter, n_audio = model.encode(vr._pad_audio_streaming(
        off, model.config.n_left_pad_tokens, n_delay + 11))
    if not torch.isfinite(adapter).all():
        raise AssertionError("Voxtral offline adapter frames not finite")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = model.generate(off)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    log(f"[voxtral] offline generate() of {VOXTRAL_OFFLINE_SECONDS} s: "
        f"{n_audio} adapter frames, all finite; {res.generation_tokens} "
        f"tokens in {wall:.3f} s, xRT {VOXTRAL_OFFLINE_SECONDS / wall:.2f} "
        f"({card})")
    del sess
    torch.cuda.empty_cache()
    return {"p95": p95, "xrt": xrt, "model": model}


def phase_voxtral_cli(tmp: Path):
    """A small Voxtral checkpoint (consolidated names, npz, tekken.json)
    and a 3-s WAV: the STT CLI started in a subprocess on the card. -> the
    check of its JSON against load_model(...).generate(...) here."""
    import numpy as np

    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        Model, ModelConfig)

    ckpt, wav = tmp / "voxtral-small", tmp / "voxtral.wav"
    write_voxtral_checkpoint(Model(ModelConfig.from_dict(VOXTRAL_SMALL),
                                   device="cpu").init_params(seed=0), ckpt)
    audio_io.write(wav, (np.random.RandomState(6).randn(16000 * 3) * 0.1
                         ).astype(np.float32), 16000)
    wait = start_stt_cli(ckpt, wav, tmp / "voxtral-out", "Voxtral")
    return lambda: _check_voxtral_cli(ckpt, wav, wait)


def _check_voxtral_cli(ckpt: Path, wav: Path, wait) -> None:
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import Model

    got, _ = wait()
    model = mlx_audio_tpu_torch.load_model(ckpt)
    if model.device.type != "cuda" or not isinstance(model, Model):
        raise AssertionError("load_model did not load Voxtral on the card")
    want = model.generate(str(wav))
    if (got["text"], got["language"], got["segments"]) != (
            want.text, want.language, json.loads(json.dumps(want.segments))):
        raise AssertionError("STT CLI on Voxtral differs from load_model")
    if not want.text:
        raise AssertionError("Voxtral CLI check: empty transcript")
    log(f"[voxtral-cli] python -m mlx_audio_tpu_torch.stt.generate --format "
        f"json on a small consolidated-name npz checkpoint with tekken.json "
        f"and a 3-s WAV, on the card: {len(want.text.split())} words, equal "
        f"to mlx_audio_tpu_torch.load_model(...).generate(...) in process")


# ---------------------------------------------------------------------------
# Cohere ASR (phases 17-18, and the checkpoint of phase 14)
# ---------------------------------------------------------------------------

# tests/test_cohere_asr.py:21-36: 2 conformer layers at d32, a 2-layer
# decoder at d24 (so `encoder_proj` runs), 2-s clips and batches of 2
COHERE_SMALL = dict(
    model_type="cohere_asr", vocab_size=64,
    encoder=dict(feat_in=20, n_layers=2, d_model=32, n_heads=4,
                 ff_expansion_factor=2, subsampling_factor=8,
                 subsampling_conv_channels=8, conv_kernel_size=9),
    transf_decoder=dict(config_dict=dict(
        hidden_size=24, inner_size=48, num_attention_heads=4, num_layers=2,
        max_sequence_length=128)),
    head=dict(hidden_size=24, num_classes=64, log_softmax=True),
    preprocessor=dict(features=20, n_fft=128, window_size=0.008,
                      window_stride=0.004),
    max_audio_clip_s=2.0, overlap_chunk_second=0.5,
    min_energy_window_samples=160, batch_size=2)
# the cohere_asr_10min lane's dims (bench.py:831-842): FastConformer 48 x
# d1280, 8 heads, FF x4, subsampling 8 with 256 channels, kernel 9; decoder
# 8 x d1024, 8 heads, inner 4096, max length 1024; vocabulary 16384
COHERE_FULL = dict(
    model_type="cohere_asr", vocab_size=16384,
    encoder=dict(feat_in=128, n_layers=48, d_model=1280, n_heads=8,
                 ff_expansion_factor=4, subsampling_factor=8,
                 subsampling_conv_channels=256, conv_kernel_size=9),
    transf_decoder=dict(config_dict=dict(
        hidden_size=1024, inner_size=4096, num_attention_heads=8,
        num_layers=8, max_sequence_length=1024)),
    head=dict(hidden_size=1024, num_classes=16384), batch_size=8)
# the lane's prompt pieces (bench.py:845-849); the ids after them decode to
# "▁<id>"
COHERE_SPECIALS = ("<|startofcontext|>", "<|startoftranscript|>",
                   "<|emo:undefined|>", "<|en|>", "<|pnc|>", "<|nopnc|>",
                   "<|noitn|>", "<|notimestamp|>", "<|nodiarize|>",
                   "<|endoftext|>")
# the lane's workload (bench.py:856-869): randn * 0.1 at seed 0, language
# "en", max_tokens 150, cold then warm; its 600 s (19 segments in
# 3 batches) cut to 300 s (10 segments: a full batch of 8 rows and a
# partial one of 2) to make room for phases 38-40
COHERE_SECONDS, COHERE_MAX_TOKENS, COHERE_SEGMENTS = 300, 150, 10
# CUDA against the CPU at f32: encoder rows, max|a-b| / max|b|
COHERE_REL = 1e-4
# NeMo's subsampling indices (torch.nn.Sequential, ReLUs between) of the
# JAX tree's named layers
COHERE_PRE_ENCODE = {"00_conv": 0, "01_dw": 2, "02_pw": 3, "03_dw": 5,
                     "04_pw": 6}
# the port's names (the JAX tree's) outside the encoder -> NeMo's, which
# `sanitize` maps back
COHERE_NEMO_NAMES = (
    ("decoder.blocks.", "transf_decoder._decoder.layers."),
    ("decoder.final_norm.", "transf_decoder._decoder.final_layer_norm."),
    ("decoder.embedding_layer_norm.", "transf_decoder._embedding.layer_norm."),
    ("decoder.embedding.", "transf_decoder._embedding.token_embedding."),
    (".self_attn_norm.", ".layer_norm_1."),
    (".cross_attn_norm.", ".layer_norm_2."), (".ff_norm.", ".layer_norm_3."),
    (".self_attn.", ".first_sub_layer."), (".cross_attn.", ".second_sub_layer."),
    (".q_proj.", ".query_net."), (".k_proj.", ".key_net."),
    (".v_proj.", ".value_net."), (".out_proj.", ".out_projection."),
    (".ff1.", ".third_sub_layer.dense_in."),
    (".ff2.", ".third_sub_layer.dense_out."),
    ("decoder.output_proj.", "log_softmax.mlp.layer0."),
    ("encoder_proj.", "encoder_decoder_proj."))


def cohere_pieces(vocab: int) -> list:
    """A tokens.json piece list: COHERE_SPECIALS, then "▁<id>"."""
    return list(COHERE_SPECIALS) + [f"▁{i}" for i in
                                    range(len(COHERE_SPECIALS), vocab)]


def cohere_nemo_names(state: dict) -> dict:
    """A flat tree under the port's names -> NeMo's checkpoint names."""
    out = {}
    pre = "encoder.pre_encode.layers."
    for k, v in state.items():
        if k.startswith(pre):
            name, rest = k[len(pre):].split(".", 1)
            k = f"encoder.pre_encode.conv.{COHERE_PRE_ENCODE[name]}.{rest}"
        elif not k.startswith("encoder."):
            for a, b in COHERE_NEMO_NAMES:
                k = k.replace(a, b)
        out[k] = v
    return out


def write_cohere_checkpoint(model, path: Path) -> None:
    """`model` as a checkpoint directory: config.json, the weights under
    NeMo's names in torch's conv layouts in one npz (with a
    num_batches_tracked and the preprocessor's filterbank and window, as
    NeMo saves them), and a tokens.json piece list."""
    import dataclasses

    import numpy as np

    from mlx_audio_tpu_torch.dsp import hanning

    state = {k: v.float().cpu().numpy() for k, v in model.state_dict().items()}
    state = cohere_nemo_names(state)
    state["encoder.layers.0.conv.batch_norm.num_batches_tracked"] = np.zeros(
        (), np.int64)
    state["preprocessor.featurizer.fb"] = model._fb()[None]
    pp = model.config.preprocessor
    state["preprocessor.featurizer.window"] = hanning(pp.win_length).numpy()
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "model.npz", **state)
    (path / "config.json").write_text(json.dumps(
        dataclasses.asdict(model.config)))
    (path / "tokens.json").write_text(json.dumps(
        cohere_pieces(model.config.head.num_classes)))


def _cohere_small(device: str, like=None):
    """The small Cohere model on `device`: seeded (seed 0, drawn on the
    CPU) or with the parameters of `like`; a piece-list tokenizer."""
    from mlx_audio_tpu_torch.stt.models.canary import CanaryTokenizer
    from mlx_audio_tpu_torch.stt.models.cohere_asr import Model, ModelConfig

    model = Model(ModelConfig.from_dict(COHERE_SMALL), device=device)
    if like is None:
        model.init_params(seed=0)
    else:
        model.load_state_dict(like.state_dict())
    model._tokenizer = CanaryTokenizer(piece_list=cohere_pieces(64))
    return model


def phase_cohere_reference() -> None:
    """The small config at f32 from one seeded weight set, CUDA against the
    CPU: the encoder rows of a ragged batch with a row of length 0, and
    greedy generate() on 5 s of seeded noise (3 segments, a partial last
    batch): texts and segments equal, everything finite."""
    import numpy as np
    import torch

    cpu = _cohere_small("cpu")
    gpu = _cohere_small("cuda", like=cpu)
    audio = (np.random.RandomState(0).randn(16000 * 5) * 0.5).astype(
        np.float32)
    segs, _ = cpu._prepare_segments([audio])
    feats, lens = cpu.features(segs + [audio[:0]])
    want, _ = cpu.encode(feats, lens)
    got, _ = gpu.encode(feats.cuda(), lens.cuda())
    err = rel_err(got.cpu(), want)
    if not torch.isfinite(got).all() or not err <= COHERE_REL:
        raise AssertionError(f"Cohere encoder CUDA vs CPU {err:.3e} > "
                             f"{COHERE_REL}, or rows not finite")
    kw = dict(language="en", max_tokens=24)
    want, got = cpu.generate(audio, **kw), gpu.generate(audio, **kw)
    if (got.text, got.segments) != (want.text, want.segments) or not got.text:
        raise AssertionError("small Cohere generate: CUDA differs from the "
                             "CPU, or no text")
    if len(got.segments) < 3 or gpu.last_run["batches"] < 2:
        raise AssertionError(f"small Cohere: {gpu.last_run}, wanted 3+ "
                             f"segments in 2+ batches")
    log(f"[cohere-ref] small config f32, 5 s: encoder rows CUDA vs CPU "
        f"{err:.2e} relative (tol {COHERE_REL}) over {len(segs)} segments "
        f"and a row of length 0, all finite; {len(got.segments)} segments "
        f"in {gpu.last_run['batches']} batches, {got.generation_tokens} "
        f"tokens, {gpu.last_run['decode_steps']} decode steps: texts and "
        f"segments equal")


def conformer_flops(e: dict, rows: int, frames: int) -> float:
    """Operations (2 per multiply-add) of `rows` rows of `frames` mel frames
    through the FastConformer of encoder config `e`: the subsampling convs
    and `out`, then per layer the two FFs, q/k/v/out, linear_pos over the
    2T-1 positions, the three attention products and the conv module."""
    d, ch, ff = e["d_model"], e["subsampling_conv_channels"], \
        e["d_model"] * e["ff_expansion_factor"]
    t, f = frames, e["feat_in"]
    sub = 0
    for stage in range(3):
        t, f = (t - 1) // 2 + 1, (f - 1) // 2 + 1
        sub += 2 * t * f * ch * 9 + (2 * t * f * ch * ch if stage else 0)
    sub += 2 * t * f * ch * d
    per_frame = (2 * 2 * 2 * d * ff + 4 * 2 * d * d + 2 * d * 2 * d
                 + 2 * d * e["conv_kernel_size"] + 2 * d * d
                 + 2 * (t + (2 * t - 1) + t) * d)
    layer = rows * t * per_frame + 2 * (2 * t - 1) * d * d
    return rows * sub + e["n_layers"] * layer


def cohere_encoder_flops(cfg: dict, rows: int, frames: int) -> float:
    """`conformer_flops` of Cohere's encoder, then `encoder_proj` if
    any."""
    e = cfg["encoder"]
    t = frames
    for _ in range(3):
        t = (t - 1) // 2 + 1
    hidden = cfg["transf_decoder"]["config_dict"]["hidden_size"]
    proj = 2 * rows * t * e["d_model"] * hidden if hidden != e["d_model"] \
        else 0
    return conformer_flops(e, rows, frames) + proj


def phase_cohere_full(card: str) -> dict:
    """Cohere ASR at the cohere_asr_10min lane's dims (2.05 B parameters
    drawn on the card in f32 from seed 0, then cast in place to bf16): the
    bf16 encoder against f32 on one 8-row batch of the 3,584-frame bucket,
    the encoder's time a batch, then the lane's file (cut to 300 s) cold and
    warm."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.stt.models.canary import CanaryTokenizer
    from mlx_audio_tpu_torch.stt.models.cohere_asr import Model, ModelConfig

    base = torch.cuda.memory_allocated()       # what earlier phases hold
    t0 = time.perf_counter()
    model = Model(ModelConfig.from_dict(COHERE_FULL), device="cuda")
    model.init_params(seed=0, on_device=True)
    torch.cuda.synchronize()
    log(f"[cohere] cohere_asr_10min dims (FastConformer 48 x d1280, decoder "
        f"8 x d1024, vocabulary 16,384): {model.num_params() / 1e9:.3f} B "
        f"parameters drawn on the card in f32 from seed 0 "
        f"({time.perf_counter() - t0:.2f} s)")
    audio = (np.random.RandomState(0).randn(COHERE_SECONDS * 16000) * 0.1
             ).astype(np.float32)

    # the 8 longest segments, one batch of the 3,584-frame bucket
    segs, _ = model._prepare_segments([audio])
    batch = sorted(segs, key=len, reverse=True)[:8]
    feats, lens = model.features(batch)
    if feats.shape[:2] != (8, 3584):
        raise AssertionError(f"Cohere batch {tuple(feats.shape)}: not 8 rows "
                             f"of the 3,584-frame bucket")
    ref = model.encode(feats, lens)[0].float()
    model.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    got = model.encode(feats, lens)[0].float()
    rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    if not torch.isfinite(got).all() or not rel < WHISPER_BF16_REL:
        raise AssertionError(f"Cohere bf16 encoder vs f32: {rel:.3e} >= "
                             f"{WHISPER_BF16_REL}, or not finite")
    del ref, got
    torch.cuda.empty_cache()
    enc_ms = _time_ms(lambda: model.encode(feats, lens), 5)
    flops = cohere_encoder_flops(COHERE_FULL, 8, 3584)
    log(f"[cohere] bf16 encoder vs f32 on one 8-row batch of the 3,584-frame "
        f"bucket: relative Frobenius {rel:.3e} (limit {WHISPER_BF16_REL}); "
        f"{enc_ms:.3f} ms a batch (CUDA events, median of 5), "
        f"{flops / 1e12:.3f} TFLOP: {flops / enc_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * flops / PEAK_BF16 * 1e3 / enc_ms:.1f}% of 989 TFLOP/s "
        f"({card})")

    model._tokenizer = CanaryTokenizer(piece_list=cohere_pieces(
        model.config.head.num_classes))
    t1 = time.perf_counter()
    for s in segs:
        model._log_mel(s)
    mel_s = time.perf_counter() - t1
    encode, finite = model.encode, []

    def checked_encode(f, n):              # every batch's rows finite
        enc, mask = encode(f, n)
        finite.append(bool(torch.isfinite(enc).all()))
        return enc, mask

    kw = dict(language="en", max_tokens=COHERE_MAX_TOKENS)
    walls, outs = [], []
    for i in range(2):
        model.encode = checked_encode if i == 0 else encode
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs.append(model.generate(audio, **kw))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    del model.encode
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    run, res = dict(model.last_run), outs[-1]
    if len(res.segments) != COHERE_SEGMENTS or not all(finite) \
            or len(finite) != run["batches"]:
        raise AssertionError(f"Cohere lane: {len(res.segments)} segments "
                             f"(want {COHERE_SEGMENTS}), encoder rows finite "
                             f"{finite}")
    if any(o.text != res.text for o in outs) or not res.text:
        raise AssertionError("Cohere lane: the runs' texts differ, or none")
    warm = walls[1]
    for label, wall in (("cold", walls[0]), ("warm", warm)):
        enc_s = run["batches"] * enc_ms / 1e3
        log(f"[cohere] {label}: {COHERE_SECONDS} s in {wall:.3f} s, xRT "
            f"{COHERE_SECONDS / wall:.2f}; {len(res.segments)} segments in "
            f"{run['batches']} batches, {res.generation_tokens} tokens, "
            f"{run['decode_steps']} decode steps, "
            f"{(wall - mel_s - enc_s) * 1e3 / run['decode_steps']:.3f} ms a "
            f"step (wall less the host mel's {mel_s:.3f} s and the batches' "
            f"encoder time at 8 rows, {enc_s:.3f} s) ({card})")
    log(f"[cohere] warm walls {[round(w, 3) for w in walls[1:]]} s; peak "
        f"device memory {peak_gb:.2f} GB in the warm runs, "
        f"{peak_gb - base / 1e9:.2f} GB of it this phase's (bf16 weights "
        f"{2 * model.num_params() / 1e9:.2f} GB); every batch's encoder rows "
        f"finite ({card})")
    del model
    torch.cuda.empty_cache()
    return {"warm": warm, "enc_ms": enc_ms, "rel": rel}


def phase_cohere_cli(tmp: Path):
    """A small Cohere checkpoint (NeMo names, torch conv layouts, npz with
    the preprocessor buffers, tokens.json) and a 5-s WAV: the STT CLI
    started in a subprocess on the card. -> the check of its JSON against
    load_model(...).generate(...) here."""
    import numpy as np

    from mlx_audio_tpu_torch import audio_io

    ckpt, wav = tmp / "cohere-small", tmp / "cohere.wav"
    write_cohere_checkpoint(_cohere_small("cpu"), ckpt)
    audio_io.write(wav, (np.random.RandomState(7).randn(16000 * 5) * 0.5
                         ).astype(np.float32), 16000)
    wait = start_stt_cli(ckpt, wav, tmp / "cohere-out", "Cohere")
    return lambda: _check_cohere_cli(ckpt, wav, wait)


def _check_cohere_cli(ckpt: Path, wav: Path, wait) -> None:
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.stt.models.cohere_asr import Model

    got, _ = wait()
    model = mlx_audio_tpu_torch.load_model(ckpt)
    if model.device.type != "cuda" or not isinstance(model, Model):
        raise AssertionError("load_model did not load Cohere on the card")
    want = model.generate(str(wav))
    if (got["text"], got["language"], got["segments"]) != (
            want.text, want.language, json.loads(json.dumps(want.segments))):
        raise AssertionError("STT CLI on Cohere differs from load_model")
    if not want.text or len(want.segments) < 3:
        raise AssertionError("Cohere CLI check: empty transcript or fewer "
                             "than 3 segments")
    log(f"[cohere-cli] python -m mlx_audio_tpu_torch.stt.generate --format "
        f"json on a small NeMo-name npz checkpoint with tokens.json and a "
        f"5-s WAV, on the card: {len(want.segments)} segments, "
        f"{len(want.text.split())} words, equal to "
        f"mlx_audio_tpu_torch.load_model(...).generate(...) in process")


# ---------------------------------------------------------------------------
# Higgs Audio v2 (phases 19-21, and the checkpoint of phase 14)
# ---------------------------------------------------------------------------

# tests/test_higgs_audio_v2.py:20-32: 2 dual-FFN layers at d32, GQA 4/2,
# llama3 RoPE scaling, 4 codebooks of 64
HIGGS_SMALL = dict(
    text_config=dict(hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2,
                     intermediate_size=64, vocab_size=300,
                     rope_theta=500000.0,
                     rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                   "low_freq_factor": 1.0,
                                   "high_freq_factor": 4.0,
                                   "original_max_position_embeddings": 8192}),
    audio_num_codebooks=4, audio_codebook_size=64, audio_stream_bos_id=64,
    audio_stream_eos_id=65)
# a codec with the small model's 4 books of 64 (hop 6)
HIGGS_CODEC_SMALL = dict(
    codebook_size=64, codebook_dim=4, dac_num_codebooks=4,
    dac_encoder_ratios=[2, 3], dac_encoder_hidden=4, dac_decoder_hidden=16,
    latent_dim=24, fusion_dim=8, downsample_factor=20)
# the small model's EOS rows of audio_lm_head scaled by this make greedy
# decoding sample EOS at frame 4 (seed 0), after the delay ramp-in, and run
# the ramp-out
HIGGS_EOS_SCALE = 2.5
HIGGS_TEXT = "hello world, this is a check"
# small config at f32, CUDA vs CPU: summation order only
HIGGS_REL = 1e-4
# W8A8 on the card: the int32 product is exact, the two f32 scale products
# round alike
I8_REL = 1e-5
I8_ROWS = (1, 17, 512)
# the linear shapes (out, in) of a layer at ModelConfig() dims: q and o; k
# and v; gate and up; down. A decode frame runs 28 x (2, 2, 2, 1) of them
HIGGS_SHAPES = ((3072, 3072), (1024, 3072), (8192, 3072), (3072, 8192))
HIGGS_FRAME_LINEARS = (2, 2, 2, 1)
# the higgs_v2_3b_* lanes (bench.py:428-464): a 480-token prompt of
# randn * 0.02 embeds (seed 0) in the 512 bucket, a 1,024-column cache,
# temperature 0.7, top_p 0.95, RAS 7/2; frames in 16-frame chunks, then
# the delayed frames less 8 mod 1,024 through the codec at CodecConfig()
# dims in bf16. The lane runs 250 frames (10 s at 25 frames a second) and
# 242 through the codec; here 32 and 24, to keep the run's time (100 and
# 92 from the Orpheus phases to phases 41-44, 50 and 42 until phases 58-61)
HIGGS_PLEN, HIGGS_FRAMES, HIGGS_FPS, HIGGS_CODEC_FRAMES = 480, 32, 25, 24
# frames of the profiled chunk (16, a whole chunk, until phases 58-61: the
# W8A8 lane's 4,500 kernels a frame took the profiler 20 s to gather; 4
# until phases 62-66)
HIGGS_PROFILE_FRAMES = 2
HIGGS_BF16_REL = 2e-2
# W8A8 against bf16 audio logits on the prefill's last row (per-channel
# int8 weights and per-token int8 activations, 28 layers deep)
HIGGS_I8_LOGITS_REL = 1e-1
# phase 21: one request of 32 frames on the affine-q8 backbone, with a
# voice-clone-like mask (rows 100-299 audio), so the prefill runs both paths
HIGGS_K2_FRAMES = 32
HIGGS_AUDIO_ROWS = (100, 300)
# timed runs of each Higgs lane after its warm-up (3 until phase 26 came,
# 2 until phases 27-29 came; cut to keep the whole run near half its time
# limit)
HIGGS_RUNS = 1


class HiggsTok:
    """A stand-in text tokenizer (tests/test_higgs_audio_v2.py's FakeTok):
    the HF tokenizer is not in the repository."""

    def encode(self, text, add_special_tokens=False):
        return [ord(c) % 290 for c in text][:80]


def _higgs_small(device: str, eos_scale=None):
    from mlx_audio_tpu_torch.tts.models.higgs_audio import Model

    import torch

    model = Model(HIGGS_SMALL, device=device).init_params(seed=0)
    model.tokenizer = HiggsTok()
    if eos_scale is not None:
        cfg = model.config
        rows = (torch.arange(cfg.audio_num_codebooks, device=device)
                * cfg.stride + cfg.audio_stream_eos_id)
        model.audio_decoder_proj.audio_lm_head.weight[rows] *= eos_scale
    return model


def _higgs_codec_small(device: str):
    from mlx_audio_tpu_torch.codec.models.higgs_audio import Model

    return Model(HIGGS_CODEC_SMALL, device=device).init_params(seed=1)


def _frames(gen):
    import numpy as np

    return np.concatenate(list(gen), axis=0)


def phase_higgs_reference() -> None:
    """Phase 19: the small configs at f32 from one seeded weight set, CUDA
    against the CPU: the cached prefill's hidden states, greedy frames with
    EOS reached and its ramp-out run, a generate() through a bound small
    codec; then qmatmul_i8 (torch._int_mm) against its plain version at the
    four Higgs shapes."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.kvcache import KVCache
    from mlx_audio_tpu_torch.ops.quant import (int_mm, int_mm_reference,
                                               qmatmul_i8,
                                               qmatmul_i8_reference)
    from mlx_audio_tpu_torch.tts.models.higgs_audio.higgs_audio import \
        higgs_forward

    t0 = time.perf_counter()
    models = [_higgs_small(d, HIGGS_EOS_SCALE) for d in ("cpu", "cuda")]
    cfg = models[0].config
    t = cfg.text
    rs = np.random.RandomState(0)
    emb = (rs.randn(1, 64, t.hidden_size) * 0.5).astype(np.float32)
    mask = np.zeros((1, 64), bool)
    mask[0, 10:40] = True
    plen, cache_len = 60, 128
    hidden = []
    for m in models:
        dev = m.device
        caches = KVCache.init(1, cache_len, t.num_key_value_heads,
                              t.head_dim, torch.float32, dev,
                              n_layers=t.num_hidden_layers)
        pad = torch.zeros(cache_len, device=dev).masked_fill(
            torch.arange(cache_len, device=dev) >= plen,
            float("-inf"))[None, None, None, :]
        h, _ = higgs_forward(m, torch.from_numpy(emb).to(dev),
                             torch.from_numpy(mask).to(dev), caches, 0,
                             pad_mask=pad)
        hidden.append(h[:, :plen].cpu())
    rel = rel_err(hidden[1], hidden[0])
    if not (torch.isfinite(hidden[1]).all() and rel <= HIGGS_REL):
        raise AssertionError(f"Higgs prefill hidden CUDA vs CPU rel {rel:.3e}")
    frames = [_frames(m.generate_frames(*m.build_prompt(HIGGS_TEXT),
                                        max_new_frames=64, temperature=0.0))
              for m in models]
    eos, k = cfg.audio_stream_eos_id, cfg.audio_num_codebooks
    if frames[0].shape != frames[1].shape or (frames[0] != frames[1]).any():
        raise AssertionError("Higgs greedy frames differ CUDA vs CPU")
    first_eos = int(np.argmax((frames[1] == eos).any(axis=1)))
    if not ((frames[1][-1] == eos).all() and len(frames[1]) < 65
            and first_eos >= k):
        raise AssertionError(f"Higgs frames: EOS at {first_eos} of "
                             f"{len(frames[1])}, no ramp-out seen")
    plain = [_higgs_small(d) for d in ("cpu", "cuda")]
    for m, d in zip(plain, ("cpu", "cuda")):
        m.codec = _higgs_codec_small(d)
    res = [next(m.generate(HIGGS_TEXT, temperature=0.0, max_new_frames=48))
           for m in plain]
    a_rel = rel_err(torch.from_numpy(res[1].audio),
                    torch.from_numpy(res[0].audio))
    if not (res[0].samples == res[1].samples > 0 and a_rel <= HIGGS_REL
            and np.isfinite(res[1].audio).all()):
        raise AssertionError(f"Higgs generate() audio CUDA vs CPU: "
                             f"{res[1].samples} vs {res[0].samples} samples, "
                             f"rel {a_rel:.3e}")
    log(f"[higgs small] f32 CUDA vs CPU: prefill hidden rel {rel:.3e} (tol "
        f"{HIGGS_REL:g}); greedy frames equal ({len(frames[1])}, EOS at "
        f"frame {first_eos}, ramp-out run); generate() through a small codec "
        f"{res[1].samples} samples, rel {a_rel:.3e}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for n, kin in HIGGS_SHAPES:
        w = torch.randint(-127, 128, (n, kin), dtype=torch.int8, device=dev,
                          generator=g)
        scale = torch.rand(n, device=dev, generator=g) * 1e-3
        for m in I8_ROWS:
            xq = torch.randint(-127, 128, (m, kin), dtype=torch.int8,
                               device=dev, generator=g)
            if not torch.equal(int_mm(xq, w), int_mm_reference(xq, w)):
                raise AssertionError(f"_int_mm ({n},{kin}) M={m}: int32 "
                                     f"accumulators differ")
            x = torch.randn(m, kin, device=dev, generator=g)
            r = rel_err(qmatmul_i8(x, w, scale),
                        qmatmul_i8_reference(x, w, scale))
            worst = max(worst, r)
            if not r <= I8_REL:
                raise AssertionError(f"qmatmul_i8 ({n},{kin}) M={m}: rel "
                                     f"{r:.3e}")
    log(f"[higgs w8a8] torch._int_mm at {len(HIGGS_SHAPES)} shapes x M in "
        f"{I8_ROWS}: int32 accumulators equal to the exact plain product; "
        f"qmatmul_i8 rel <= {worst:.3e} (tol {I8_REL:g}); phase 19 in "
        f"{time.perf_counter() - t0:.1f} s")


def write_higgs_checkpoint(model, path: Path) -> None:
    """`model` as a checkpoint directory: config.json with model_type
    "higgs_audio" and the weights under their HF names in one npz, without
    the text head (tied to embed_tokens) and with a rotary buffer that
    sanitize drops."""
    import dataclasses

    import numpy as np

    state = {k: v.float().cpu().numpy() for k, v in model.state_dict().items()
             if k != "audio_decoder_proj.text_lm_head.weight"}
    state["layers.0.self_attn.rotary_emb.inv_freq"] = \
        model.inv_freq.cpu().numpy()
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "model.npz", **state)
    cfg = dataclasses.asdict(model.config)
    cfg.pop("model_path")
    (path / "config.json").write_text(json.dumps(cfg))


def phase_higgs_load(tmp: Path) -> None:
    """Phase 14's Higgs checkpoint: load_model(...) on the card gives the
    in-process model's greedy frames."""
    import numpy as np
    import torch

    import mlx_audio_tpu_torch

    ckpt = tmp / "higgs-small"
    here = _higgs_small("cuda")
    write_higgs_checkpoint(here, ckpt)
    loaded = mlx_audio_tpu_torch.load_model(ckpt)
    if loaded.device.type != "cuda":
        raise AssertionError("load_model did not load Higgs onto the card")
    head = loaded.audio_decoder_proj.text_lm_head.weight
    if not torch.equal(head, loaded.embed_tokens.weight):
        raise AssertionError("Higgs text head not tied to embed_tokens")
    loaded.tokenizer = HiggsTok()
    want, got = (_frames(m.generate_frames(*m.build_prompt(HIGGS_TEXT),
                                           max_new_frames=32,
                                           temperature=0.0))
                 for m in (here, loaded))
    if want.shape != got.shape or (want != got).any():
        raise AssertionError("Higgs load_model frames differ from the "
                             "in-process model's")
    log(f"[higgs-load] mlx_audio_tpu_torch.load_model on a small Higgs "
        f"checkpoint (HF names, npz, tied text head): {len(got)} greedy "
        f"frames on the card, equal to the in-process model's "
        f"({np.count_nonzero(got == HIGGS_SMALL['audio_stream_eos_id'])} "
        f"EOS codes)")


def build_higgs_full():
    """Higgs Audio v2 at ModelConfig() dims on the card, every floating
    parameter drawn N(0, 0.02) there in f32 from seed 0, as the lane draws
    them (bench.py:369-390)."""
    import torch

    from mlx_audio_tpu_torch.tts.models.higgs_audio import Model, ModelConfig

    model = Model(ModelConfig(), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=g)
    return model


def higgs_frame_bytes(model, kv_cols: float) -> float:
    """Bytes a decode frame must read: per layer the attention, the audio
    norms and the audio MLP (parameters and quantized buffers), then the
    final norm and the audio head, and the K/V of the kv_cols cache columns
    it attends to."""
    t = model.config.text
    mods = [model.norm, model.audio_decoder_proj.audio_lm_head]
    for lp in model.layers:
        mods += [lp.self_attn, lp.audio_input_layernorm,
                 lp.audio_post_attention_layernorm, lp.audio_mlp]
    weights = sum(v.numel() * v.element_size() for m in mods
                  for v in list(m.parameters()) + list(m.buffers()))
    kv = (2 * t.num_hidden_layers * kv_cols * t.num_key_value_heads
          * t.head_dim * model.embed_tokens.weight.element_size())
    return weights + kv


def _higgs_run(model, emb, mask, sampling, cache_len: int):
    """The lane's generation: prefill, then HIGGS_FRAMES frames in chunks
    of 16 (the last 10), each chunk's frames copied to the host once.
    -> (frames (N, K), prefill s, generation s)."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.tts.models.higgs_audio.higgs_audio import \
        CHUNK_FRAMES

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = model.prefill(emb, mask, HIGGS_PLEN, cache_len, seed=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    blocks, left = [], HIGGS_FRAMES
    while left:
        frames, _ = model.chunk(carry, sampling, min(CHUNK_FRAMES, left))
        blocks.append(frames.cpu().numpy())
        left -= len(blocks[-1])
    return np.concatenate(blocks), t1 - t0, time.perf_counter() - t0


def _profile_chunk(model, emb, mask, sampling, cache_len: int) -> tuple:
    """A chunk of HIGGS_PROFILE_FRAMES frames under torch.profiler (the
    device's activity alone: the host's op events of a W8A8 chunk take a
    minute to gather) after a prefill and one such chunk unprofiled. ->
    (kernels a frame, device ms a frame, wall ms a frame unprofiled, busy
    share)."""
    import torch

    n = HIGGS_PROFILE_FRAMES
    carry, _ = model.prefill(emb, mask, HIGGS_PLEN, cache_len, seed=0)
    model.chunk(carry, sampling, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.chunk(carry, sampling, n)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = _device_kernels(lambda: model.chunk(carry, sampling, n),
                              cpu=False)
    device = sum(_dev_us(e) for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    return launches, device, wall, device / wall


def _higgs_lane(model, codec, name: str, emb, mask, card: str,
                bytes_frame: float) -> dict:
    """The lane's workload: a warm-up, then best of HIGGS_RUNS (generation
    and the codec, as bench.py:438-475), and one profiled chunk. Returns
    the numbers it logs."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.tts.models.higgs_audio.higgs_audio import (
        Sampling, cache_length, prompt_bucket)

    sampling = Sampling(0.7, 0.95, 0, 7, 2, 0)
    k = model.config.audio_num_codebooks
    cache_len = cache_length(prompt_bucket(HIGGS_PLEN), HIGGS_FRAMES, k)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _higgs_run(model, emb, mask, sampling, cache_len)          # warm-up
    runs = [_higgs_run(model, emb, mask, sampling, cache_len)
            for _ in range(HIGGS_RUNS)]
    frames, prefill_s, gen_s = min(runs, key=lambda r: r[2])
    if frames.shape != (HIGGS_FRAMES, k):
        raise AssertionError(f"{name}: frames {frames.shape}")
    codes = np.ascontiguousarray(frames.T)[:, :HIGGS_CODEC_FRAMES] % 1024
    codec.decode(codes.T)                                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio = codec.decode(codes.T)
    codec_s = time.perf_counter() - t0
    want = HIGGS_CODEC_FRAMES * codec.config.acoustic_hop
    if audio.shape != (want,) or not np.isfinite(audio).all():
        raise AssertionError(f"{name}: audio {audio.shape}, want ({want},), "
                             f"or not finite")
    peak = torch.cuda.max_memory_allocated()
    launches, device_ms, wall_ms, busy = _profile_chunk(
        model, emb, mask, sampling, cache_len)
    frame_ms = gen_s / HIGGS_FRAMES * 1e3
    bound_ms = bytes_frame / HBM_BPS * 1e3
    audio_s = HIGGS_FRAMES / HIGGS_FPS
    out = dict(wall_s=gen_s + codec_s, frame_ms=frame_ms,
               xrt=audio_s / (gen_s + codec_s), codec_s=codec_s,
               prefill_ms=prefill_s * 1e3, peak_gb=peak / 1e9,
               own_gb=(peak - base) / 1e9, launches=launches,
               device_ms=device_ms, busy=busy, bound_ms=bound_ms,
               walls=[r[2] for r in runs])
    log(f"[higgs {name}] {HIGGS_FRAMES} frames (the lane's {audio_s:.0f} s) + "
        f"codec of {HIGGS_CODEC_FRAMES} frames -> {want} samples: wall "
        f"{out['wall_s']:.3f} s best of {HIGGS_RUNS} (generation "
        f"{', '.join(f'{w:.3f}' for w in out['walls'])} s), "
        f"{frame_ms:.2f} ms a frame, xRT {out['xrt']:.3f}; prefill "
        f"{out['prefill_ms']:.2f} ms, codec {codec_s * 1e3:.2f} ms; peak "
        f"device memory {out['peak_gb']:.2f} GB ({out['own_gb']:.2f} GB "
        f"above the model and what earlier phases hold); profiled chunk: "
        f"{launches:.0f} kernels a frame, {device_ms:.3f} ms of device time "
        f"a frame against {wall_ms:.2f} ms of wall ({100 * busy:.1f}% busy); "
        f"bound {bound_ms:.3f} ms a frame ({bytes_frame / 1e9:.3f} GB), "
        f"{100 * bound_ms / frame_ms:.1f}% of it reached ({card})")
    return out


def phase_higgs_full(card: str):
    """Phase 20, first half: Higgs v2 at ModelConfig() dims (5.771 B
    parameters drawn on the card in f32 from seed 0, then cast in place to
    bf16): bf16 against f32 on the lane's 512-bucket prefill, then the
    higgs_v2_3b_bf16 workload. -> (model, codec, lane inputs, bf16 audio
    logits of the prefill's last row, the lane's numbers)."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.codec.models.higgs_audio import (
        Model as Codec, ModelConfig as CodecConfig)
    from mlx_audio_tpu_torch.ops.kvcache import KVCache
    from mlx_audio_tpu_torch.tts.models.higgs_audio.higgs_audio import (
        higgs_forward, prompt_bucket)

    t0 = time.perf_counter()
    model = build_higgs_full()
    torch.cuda.synchronize()
    t = model.config.text
    n_params = model.num_params()
    log(f"[higgs] Higgs Audio v2 ModelConfig() dims (28 dual-FFN layers x "
        f"d3072, GQA 24/8 of 128, FFN 8192, 8 books of 1,026): "
        f"{n_params / 1e9:.3f} B parameters drawn N(0, 0.02) on the card in "
        f"f32 from seed 0 ({time.perf_counter() - t0:.2f} s)")
    pb = prompt_bucket(HIGGS_PLEN)
    emb32 = torch.from_numpy((np.random.RandomState(0).randn(
        1, pb, t.hidden_size) * 0.02).astype(np.float32)).cuda()
    mask = torch.zeros(1, pb, dtype=torch.bool, device="cuda")
    pad = torch.zeros(1024, device="cuda").masked_fill(
        torch.arange(1024, device="cuda") >= HIGGS_PLEN,
        float("-inf"))[None, None, None, :]

    def prefill_hidden(emb):
        dtype = model.embed_tokens.weight.dtype
        caches = KVCache.init(1, 1024, t.num_key_value_heads, t.head_dim,
                              dtype, "cuda", n_layers=t.num_hidden_layers)
        h, _ = higgs_forward(model, emb.to(dtype), mask, caches, 0,
                             pad_mask=pad)
        return h[:, :HIGGS_PLEN].float()

    ref = prefill_hidden(emb32)
    model.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    got = prefill_hidden(emb32)
    rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    del ref
    logits = model._audio_logits(got[0, -1].to(torch.bfloat16)).float()
    if not (torch.isfinite(got).all() and rel < HIGGS_BF16_REL):
        raise AssertionError(f"Higgs bf16 vs f32 prefill hidden: relative "
                             f"Frobenius {rel:.3e}")
    log(f"[higgs] bf16 vs f32 on the lane's 512-bucket prefill ({HIGGS_PLEN} "
        f"rows): relative Frobenius {rel:.3e} (limit {HIGGS_BF16_REL:g})")
    codec = Codec(CodecConfig(), device="cuda").init_params(seed=0,
                                                            on_device=True)
    codec.astype(torch.bfloat16)
    emb = emb32.to(torch.bfloat16)
    lane = _higgs_lane(model, codec, "higgs_v2_3b_bf16", emb, mask, card,
                       higgs_frame_bytes(model, HIGGS_PLEN + 1
                                         + HIGGS_FRAMES / 2))
    return model, codec, emb, mask, logits, lane


def higgs_k2_launches(model, mask) -> tuple:
    """K2 launches of (the prefill, a decode frame) on the affine-q8
    backbone, from the config and the prompt's mask: each layer runs q, k,
    v, o and, for each path some row takes, gate, up and down (28 x (4 +
    3 + 3) = 280 with both, 196 with one); a decode frame runs the audio
    path only (196). The audio head stays dense, the text head never runs.
    Raises unless the model holds exactly the quantized linears the config
    gives (28 x 10 + the text head)."""
    from mlx_audio_tpu_torch.nn import QuantizedLinear

    layers = model.config.text.num_hidden_layers
    have = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    if have != layers * 10 + 1:
        raise AssertionError(f"{have} quantized linears, the config gives "
                             f"{layers * 10 + 1}")
    paths = int(bool(mask.any())) + int(bool((~mask).any()))
    return layers * (4 + 3 * paths), layers * 7


def phase_higgs_k2(model, emb, mask, card: str, recorder) -> int:
    """Phase 21, on phase 20's weights: the backbone quantized to affine 8
    bits (group 64, the model's predicate, no mxu_int8) through
    apply_quantization, one 32-frame request through generate_frames with
    K2's launches against the count higgs_k2_launches gives, then K2 at the
    four Higgs shapes, M = 1 (gemv) and 512 (mma), against
    qmatmul_reference, timed beside W8A8 (torch._int_mm) and dense bf16
    cuBLAS. Returns K2's launches in the request."""
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.utils import apply_quantization

    t0 = time.perf_counter()
    apply_quantization(model, {"quantization": {"bits": 8, "group_size": 64}},
                       model.model_quant_predicate)
    torch.cuda.empty_cache()
    mask = mask.clone()
    mask[0, HIGGS_AUDIO_ROWS[0]:HIGGS_AUDIO_ROWS[1]] = True
    prefill, frame = higgs_k2_launches(model, mask[:, :HIGGS_PLEN])
    before = qmm_kernel.launches
    with recorder:
        t1 = time.perf_counter()
        frames = _frames(model.generate_frames(
            emb[:, :HIGGS_PLEN], mask[:, :HIGGS_PLEN],
            max_new_frames=HIGGS_K2_FRAMES, temperature=0.7, top_p=0.95,
            seed=0))
        wall = time.perf_counter() - t1
    launches = qmm_kernel.launches - before
    steps = 16 * model.last_run["chunks"]
    want = prefill + frame * steps
    if launches != want:
        raise AssertionError(f"Higgs q8: {launches} K2 launches, want "
                             f"{prefill} + {frame} x {steps} = {want}")
    want_calls = {(m, n, k, False) for n, k in HIGGS_SHAPES for m in (1, 512)}
    if not want_calls <= set(recorder.calls):
        raise AssertionError(f"K2 not launched at {want_calls}")
    log(f"[higgs q8 K2] affine 8-bit backbone (group 64): one request, "
        f"{len(frames)} frames ({steps} decode steps) in {wall * 1e3:.1f} ms "
        f"({wall * 1e3 / (steps + 1):.2f} ms a step), {launches} K2 launches "
        f"= {prefill} (prefill, both paths) + {frame} x {steps} ({card})")
    _linear_times(card, "higgs", HIGGS_SHAPES, HIGGS_FRAME_LINEARS, 28,
                  (1, 512))
    log(f"[higgs q8 K2] phase 21 in {time.perf_counter() - t0:.1f} s")
    return launches


def _linear_times(card: str, tag: str, shapes, per_layer, layers: int,
                  rows, reps: int = 7) -> dict:
    """Each linear shape (out, in) at each M of `rows`: K2 (dispatched path,
    checked against qmatmul_reference), W8A8 qmatmul_i8 and dense bf16
    F.linear, each timed by CUDA graph replay over a rotation of weight
    copies larger than the L2 cache, and K2's plain version
    (qmatmul_reference) by CUDA events; then the sums over one decode
    step's linears (layers x per_layer of each shape) at M = rows[0] with
    their byte bounds. Returns {M: {"K2"|"W8A8"|"bf16"|"plain": ms}}
    summed over one step's linears at each M."""
    from functools import partial

    import torch
    import torch.nn.functional as F

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.quant import (qmatmul_i8, qmatmul_reference,
                                               quantize_weight, to_i8_layout)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    sums = {m: {"K2": 0.0, "W8A8": 0.0, "bf16": 0.0} for m in rows}
    plain = {m: 0.0 for m in rows}
    bounds = {"K2": 0.0, "W8A8": 0.0, "bf16": 0.0}
    for (n, k), count in zip(shapes, per_layer):
        w = torch.randn(n, k, generator=g, device=dev) * k ** -0.5
        q = quantize_weight(w, QMM_GROUP, 8)
        i8 = to_i8_layout(q)
        wb = w.to(torch.bfloat16)
        sizes = {"K2": n * k + 2 * n * (k // QMM_GROUP) * 4,
                 "W8A8": n * k + 4 * n, "bf16": 2 * n * k}
        reps_of = {name: -(-2 * L2_BYTES // size)
                   for name, size in sizes.items()}
        qs = [q] + [{a: v.clone() for a, v in q.items()}
                    for _ in range(reps_of["K2"] - 1)]
        i8s = [i8] + [{a: v.clone() for a, v in i8.items()}
                      for _ in range(reps_of["W8A8"] - 1)]
        wbs = [wb] + [wb.clone() for _ in range(reps_of["bf16"] - 1)]
        for m in rows:
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            rel, _ = _qmm_case(x, q, None, f"{tag} ({n},{k}) q8 M={m}")
            ms = {"K2": _time_graph([partial(qmm_kernel, x, c["w_q"],
                                             c["scales"], c["biases"])
                                     for c in qs], reps),
                  "W8A8": _time_graph([partial(qmatmul_i8, x, c["w_i8"],
                                               c["scale"]) for c in i8s],
                                      reps),
                  "bf16": _time_graph([partial(F.linear, x, c)
                                       for c in wbs], reps)}
            plain_ms = _time_ms(partial(qmatmul_reference, x, q["w_q"],
                                        q["scales"], q["biases"]), 3)
            bound = {name: (size + 2 * m * (n + k)) / HBM_BPS * 1e3
                     for name, size in sizes.items()}
            log(f"[{tag} linear] ({n:5d},{k:5d}) M={m:4d} bf16 x: K2 "
                f"{ms['K2'] * 1e3:8.2f} us (rel {rel:.2e}), W8A8 "
                f"{ms['W8A8'] * 1e3:8.2f} us, dense bf16 "
                f"{ms['bf16'] * 1e3:8.2f} us, K2's plain version "
                f"{plain_ms * 1e3:8.2f} us; byte bounds "
                f"{bound['K2'] * 1e3:.2f} / {bound['W8A8'] * 1e3:.2f} / "
                f"{bound['bf16'] * 1e3:.2f} us ({card})")
            for name in ms:
                sums[m][name] += layers * count * ms[name]
                if m == rows[0]:
                    bounds[name] += layers * count * bound[name]
            plain[m] += layers * count * plain_ms
        del qs, i8s, wbs
    n_step = layers * sum(per_layer)
    frame = sums[rows[0]]
    log(f"[{tag} linear] one step's {n_step} linears at M = "
        f"{rows[0]}, summed: " + ", ".join(
            f"{name} {frame[name]:.3f} ms (bound {bounds[name]:.3f} ms, "
            f"{100 * bounds[name] / frame[name]:.1f}%)" for name in frame)
        + f", K2's plain version {plain[rows[0]]:.3f} ms ({card})")
    for m in rows:
        sums[m]["plain"] = plain[m]
    return sums


def linears_bound(shapes, per_layer, layers: int, m: int) -> tuple:
    """The least time one step's linears (layers x per_layer of each (out,
    in) shape) could take at M = m rows with 8-bit codes: the larger of
    their operations (2 m out in) over 989 TFLOP/s and their bytes (codes
    one a byte, f32 scales and biases a group of 64, bf16 x in and y out)
    over 3.35 TB/s. -> (ms, "operations" or "bytes")."""
    ops = nbytes = 0
    for (n, k), count in zip(shapes, per_layer):
        ops += layers * count * 2 * m * n * k
        nbytes += layers * count * (n * k + 2 * n * (k // QMM_GROUP) * 4
                                    + 2 * m * (n + k))
    by_ops, by_bytes = ops / PEAK_BF16 * 1e3, nbytes / HBM_BPS * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def phase_higgs_w8a8(model, codec, emb, mask, logits_bf16, card: str):
    """Phase 20, second half: the same model's affine codes converted in
    place to W8A8 (tree_to_i8_layout, as bench.py:414-426), its audio
    logits on the prefill's last row against bf16, then the higgs_v2_3b_q8
    workload."""
    import torch

    from mlx_audio_tpu_torch.model import replace_module
    from mlx_audio_tpu_torch.nn import Int8Linear, QuantizedLinear
    from mlx_audio_tpu_torch.ops.kvcache import KVCache
    from mlx_audio_tpu_torch.tts.models.higgs_audio.higgs_audio import \
        higgs_forward

    for name, m in list(model.named_modules()):
        if isinstance(m, QuantizedLinear):
            replace_module(model, name, Int8Linear.from_quantized(m))
    torch.cuda.empty_cache()
    t = model.config.text
    caches = KVCache.init(1, 1024, t.num_key_value_heads, t.head_dim,
                          torch.bfloat16, "cuda", n_layers=t.num_hidden_layers)
    pad = torch.zeros(1024, device="cuda").masked_fill(
        torch.arange(1024, device="cuda") >= HIGGS_PLEN,
        float("-inf"))[None, None, None, :]
    h, _ = higgs_forward(model, emb, mask, caches, 0, pad_mask=pad)
    logits = model._audio_logits(h[0, HIGGS_PLEN - 1]).float()
    del caches
    rel = float(torch.linalg.norm(logits - logits_bf16)
                / torch.linalg.norm(logits_bf16))
    if not (torch.isfinite(logits).all() and rel < HIGGS_I8_LOGITS_REL):
        raise AssertionError(f"W8A8 vs bf16 audio logits: relative Frobenius "
                             f"{rel:.3e}")
    log(f"[higgs] W8A8 vs bf16 audio logits on the prefill's last row: "
        f"relative Frobenius {rel:.3e} (limit {HIGGS_I8_LOGITS_REL:g}); "
        f"{sum(isinstance(m, Int8Linear) for m in model.modules())} W8A8 "
        f"linears")
    return _higgs_lane(model, codec, "higgs_v2_3b_q8", emb, mask, card,
                       higgs_frame_bytes(model, HIGGS_PLEN + 1
                                         + HIGGS_FRAMES / 2))


# ---------------------------------------------------------------------------
# KugelAudio and VibeVoice (phases 22-25, and the checkpoints of phase 14)
# ---------------------------------------------------------------------------

# the kugelaudio_7b lane (bench.py:533-547, 589-642): KugelAudio-0-open at
# its published dims (a Qwen2.5-7B LM, a 4-layer head of 3584, hop 3,200),
# the lane's text, 64 frames of 10 SDE steps at cfg_scale 3.0, every frame
# forced to diffusion by a +1e4 lm_head bias on SPEECH_DIFFUSION_ID
KUGEL_LANE = dict(
    acoustic_tokenizer_config=dict(
        vae_dim=64, channels=1, causal=True, encoder_n_filters=32,
        encoder_ratios=[8, 5, 5, 4, 2, 2], encoder_depths="3-3-3-3-3-3-8"),
    decoder_config=dict(
        hidden_size=3584, intermediate_size=18944, num_attention_heads=28,
        num_hidden_layers=28, num_key_value_heads=4, vocab_size=152064,
        rope_theta=1000000.0),
    diffusion_head_config=dict(
        hidden_size=3584, head_layers=4, head_ffn_ratio=3.0, latent_size=64,
        ddpm_num_steps=1000, ddpm_num_inference_steps=10),
    acoustic_vae_dim=64, tie_word_embeddings=False)
KUGEL_TEXT = ("Machine learning systems now synthesize natural speech in "
              "real time on a single accelerator chip, streaming audio to "
              "listeners across the planet.")
# the lane's 64 frames cut to 32 to make room for phases 41-44, then to 16
# for phases 58-61
KUGEL_FRAMES, KUGEL_STEPS, KUGEL_CFG, KUGEL_HOP = 16, 10, 3.0, 3200
# the timed seeds after the warm-up (the lane's 1 and 2, cut to 1 to keep
# the run's time)
KUGEL_SEEDS = (1,)
# small configs at f32, CUDA vs CPU: summation order only
KUGEL_SMALL_REL = 1e-4
# bf16 against f32 on the lane's prefill hidden and one head pass (28
# layers, as Higgs's 2e-2); W8A8 against bf16 (per-channel int8 weights and
# per-token int8 activations, as Higgs's 1e-1)
KUGEL_BF16_REL, KUGEL_I8_REL = 2e-2, 1e-1
# the Qwen2.5-7B linear shapes (out, in): q and o; k and v; gate and up;
# down, 28 x (2, 2, 2, 1) a LM step
KUGEL_SHAPES = ((3584, 3584), (512, 3584), (18944, 3584), (3584, 18944))
KUGEL_LAYER_LINEARS = (2, 2, 2, 1)
# phase 24: one 16-frame request on the affine-q8 LM
KUGEL_K2_FRAMES = 16
# phase 24's checkpoint: the small config at d64 with the lane's FFN width,
# so the f32 LM's down_proj (K = 18,944) goes through K2's simt path
KUGEL_LONG_K = dict(
    acoustic_tokenizer_config=dict(vae_dim=8, decoder_n_filters=4,
                                   encoder_ratios=[2, 2],
                                   encoder_depths="1-1-1", channels=1),
    decoder_config=dict(hidden_size=64, num_hidden_layers=2,
                        intermediate_size=18944, num_attention_heads=4,
                        num_key_value_heads=2, vocab_size=151700),
    diffusion_head_config=dict(hidden_size=64, head_layers=2,
                               head_ffn_ratio=2.0, latent_size=8,
                               ddpm_num_steps=1000,
                               ddpm_num_inference_steps=4),
    acoustic_vae_dim=8, tie_word_embeddings=False)
# frames of the profiled chunk (W8A8 launches about 8,600 kernels a frame;
# the profiler's own cost grows with the events it records; 4 until phases
# 58-61, 2 until phases 62-66)
KUGEL_PROFILE_FRAMES = 1
# phase 25: VibeVoice at ModelConfig() dims, 24 latents (48 until phases
# 41-44 came) with the EOS
# classifier biased off, cfg_scale 1.5 (its default); a request of one
# speech window (6 latents) warms up, and is timed and profiled
VIBE_LATENTS, VIBE_WINDOW = 24, 6


def tts_fixtures():
    """tests/torch_tts_fixtures.py, the CPU tests' small KugelAudio and
    VibeVoice models, stand-in tokenizers and checkpoint writers (torch
    only), loaded from its file."""
    import importlib.util

    name = "torch_tts_fixtures"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "tests" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


class LaneTok:
    """bench.py:581-585's stand-in for the lanes: ids in the real
    vocabulary, a real prompt length."""

    def encode(self, s, **kwargs):
        return [1000 + (ord(c) % 5000) for c in s]


def phase_kugel_reference(card: str) -> None:
    """Phase 22: the small KugelAudio and VibeVoice at f32 from one seeded
    weight set, CUDA against the CPU: KugelAudio's CFG prefill (hidden
    rows and the caches' written columns), a forced-diffusion generate()
    at cfg_scale 3.0 with one noise tensor on both devices (frame counts
    equal, audio within 1e-4), and VibeVoice's generate() the same way
    with its EOS classifier biased off."""
    import numpy as np
    import torch

    fx = tts_fixtures()
    t0 = time.perf_counter()
    models = [fx.force_diffusion(fx.kugel_small(d)) for d in ("cpu", "cuda")]
    prompt = models[0]._build_prompt_tokens("hello world, this is a check")
    plen = len(prompt)
    ids = torch.zeros((2, 256), dtype=torch.int64)
    ids[0, :plen] = torch.tensor(prompt)
    ids[1, 0] = prompt[-1]
    carries = [m.prefill(ids.to(m.device), plen, 512) for m in models]
    rel_h = rel_err(carries[1].hidden.cpu(), carries[0].hidden)
    rel_k = rel_err(carries[1].caches.k[:, 0, :plen].cpu(),
                    carries[0].caches.k[:, 0, :plen])
    if not (rel_h <= KUGEL_SMALL_REL and rel_k <= KUGEL_SMALL_REL
            and torch.isfinite(carries[1].hidden).all()):
        raise AssertionError(f"KugelAudio prefill CUDA vs CPU: hidden rel "
                             f"{rel_h:.3e}, K cache rel {rel_k:.3e}")
    g = torch.Generator().manual_seed(4)
    table = torch.randn((8, 5, 8), generator=g)
    res = [next(fx.fixed_draws(m, table).generate(
        "hello world", cfg_scale=3.0, max_tokens=8, ddpm_steps=4, seed=3))
        for m in models]
    a_rel = rel_err(torch.from_numpy(res[1].audio),
                    torch.from_numpy(res[0].audio))
    if not (res[0].token_count == res[1].token_count
            and res[0].samples == res[1].samples == 8 * 4
            and a_rel <= KUGEL_SMALL_REL and np.isfinite(res[1].audio).all()):
        raise AssertionError(f"KugelAudio generate() CUDA vs CPU: "
                             f"{res[1].samples} vs {res[0].samples} samples, "
                             f"rel {a_rel:.3e}")
    vv = [fx.fixed_draws(fx.vibevoice_small(d), table[:, :1])
          for d in ("cpu", "cuda")]
    vres = [next(m.generate("hello world from the card", max_tokens=8,
                            seed=3)) for m in vv]
    v_rel = rel_err(torch.from_numpy(vres[1].audio),
                    torch.from_numpy(vres[0].audio))
    if not (vres[0].samples == vres[1].samples == 8 * 4
            and v_rel <= KUGEL_SMALL_REL
            and np.isfinite(vres[1].audio).all()):
        raise AssertionError(f"VibeVoice generate() CUDA vs CPU: "
                             f"{vres[1].samples} vs {vres[0].samples} "
                             f"samples, rel {v_rel:.3e}")
    log(f"[kugel small] f32 CUDA vs CPU: CFG prefill hidden rel {rel_h:.3e}, "
        f"K cache rel {rel_k:.3e} (tol {KUGEL_SMALL_REL:g}); forced-diffusion "
        f"generate() at cfg_scale 3.0, one noise: {res[1].token_count} tokens "
        f"and {res[1].samples} samples on both, audio rel {a_rel:.3e}; "
        f"VibeVoice generate() {vres[1].samples} samples on both, audio rel "
        f"{v_rel:.3e}; phase 22 in {time.perf_counter() - t0:.1f} s ({card})")


def phase_tts_loads(tmp: Path) -> None:
    """Phase 14's KugelAudio and VibeVoice checkpoints: HF names, torch
    conv layouts, npz, config.json with model_type "kugelaudio" (and the
    `acostic_vae_dim` alias) and "vibevoice_streaming"; load_model(...) on
    the card gives the in-process model's audio."""
    import torch

    import mlx_audio_tpu_torch

    fx = tts_fixtures()
    cases = [("kugelaudio", fx.kugel_small("cuda"), fx.kugel_hf_state,
              dict(cfg_scale=3.0, max_tokens=6, ddpm_steps=4, seed=1)),
             ("vibevoice_streaming", fx.vibevoice_small("cuda"),
              fx.vibevoice_hf_state, dict(max_tokens=6, seed=1))]
    lines = []
    for model_type, here, hf_state, kw in cases:
        ckpt = tmp / f"{model_type}-small"
        fx.write_tts_checkpoint(here, hf_state(here), model_type, ckpt)
        loaded = mlx_audio_tpu_torch.load_model(ckpt)
        if loaded.device.type != "cuda" or loaded.tokenizer is not None:
            raise AssertionError(f"{model_type}: load_model did not load "
                                 f"onto the card, or found a tokenizer")
        loaded.tokenizer = here.tokenizer
        if model_type == "kugelaudio":     # the same bias on both, after
            fx.force_diffusion(here)       # the checkpoint was written
            fx.force_diffusion(loaded)
        want, got = (next(m.generate("hello there", **kw))
                     for m in (here, loaded))
        rel = rel_err(torch.from_numpy(got.audio),
                      torch.from_numpy(want.audio))
        if not got.samples == want.samples == 6 * 4 or rel > 1e-5:
            raise AssertionError(f"{model_type}: load_model audio differs "
                                 f"({got.samples} vs {want.samples} samples, "
                                 f"rel {rel:.3e})")
        lines.append(f"{model_type} {got.samples} samples, rel {rel:.1e}")
    log(f"[tts-load] mlx_audio_tpu_torch.load_model on small KugelAudio and "
        f"VibeVoice checkpoints (HF names, torch conv layouts, npz) on the "
        f"card gives the in-process models' audio: {'; '.join(lines)}")


def build_kugel_full():
    """KugelAudio at the kugelaudio_7b lane's dims on the card, every
    floating parameter drawn N(0, 0.02) there in f32 from seed 0, as the
    lane draws every floating leaf (bench.py:559-566)."""
    import torch

    from mlx_audio_tpu_torch.tts.models.kugelaudio import Model

    model = Model(KUGEL_LANE, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=g)
    model.tokenizer = LaneTok()
    return model


def kugel_frame_bytes(model, cache_len: int) -> float:
    """Bytes a frame must read, as bench.py:645-656 counts them: the LM's
    layers once (both CFG rows share the read), the diffusion head once per
    SDE step, and the two rows' f32 K/V of the whole cache."""
    cfg = model.language_model.config

    def size(m):
        return sum(v.numel() * v.element_size()
                   for v in list(m.parameters()) + list(m.buffers()))

    kv = (2 * cfg.num_hidden_layers * 2 * cache_len * cfg.num_key_value_heads
          * cfg.resolved_head_dim * 4)
    return (size(model.language_model.model.layers)
            + KUGEL_STEPS * size(model.prediction_head) + kv)


def _kugel_inputs(model):
    """The lane's prompt bucket ids (2, pb), plen and cache length."""
    import torch

    from mlx_audio_tpu_torch.tts.models.kugelaudio.kugelaudio import (
        CACHE_BUCKETS, PROMPT_BUCKETS, SPEECH_START_ID, _bucket)

    prompt = model._build_prompt_tokens(KUGEL_TEXT)
    plen = len(prompt)
    pb = _bucket(plen, PROMPT_BUCKETS)
    ids = torch.zeros((2, pb), dtype=torch.int64)
    ids[0, :plen] = torch.tensor(prompt)
    ids[1, 0] = SPEECH_START_ID
    return (ids.cuda(), plen,
            _bucket(plen + KUGEL_FRAMES + 1, CACHE_BUCKETS))


def _kugel_probe(model):
    """The lane's prefill hidden rows (2, H) and one head pass on row 0
    (a seeded noisy latent at t = 999), in f32."""
    import torch

    from mlx_audio_tpu_torch.tts.models.vibevoice.vibevoice import \
        head_forward

    ids, plen, cache_len = _kugel_inputs(model)
    hidden = model.prefill(ids, plen, cache_len).hidden
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((1, 64), generator=g, device="cuda")
    t = torch.full((1,), 999.0, device="cuda")
    with torch.no_grad():
        v = head_forward(model.prediction_head, x, t, hidden[0:1])
    return hidden.float(), v.float()


def _frob(a, b) -> float:
    import torch

    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _profile_kugel_chunk(model) -> tuple:
    """KUGEL_PROFILE_FRAMES frames of the frame loop after a prefill, under
    torch.profiler (the device's activity alone). -> (kernels a frame,
    device ms a frame, wall ms a frame unprofiled, busy share)."""
    import torch

    from mlx_audio_tpu_torch.tts.models.vibevoice.scheduler import \
        sde_dpm_tables

    n = KUGEL_PROFILE_FRAMES
    ids, plen, cache_len = _kugel_inputs(model)
    carry = model.prefill(ids, plen, cache_len)
    tables = sde_dpm_tables(1000, KUGEL_STEPS)
    temb = model.prediction_head.t_embed(
        torch.from_numpy(tables["t"]).cuda())
    g = torch.Generator(device="cuda").manual_seed(6)
    draws = torch.randn((n, 1 + KUGEL_STEPS, 64), generator=g, device="cuda")

    def run():
        return model.chunk(carry, n, draws, int(carry.n_lat), tables, temb,
                           KUGEL_CFG)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = _device_kernels(run, cpu=False)
    device = sum(_dev_us(e) for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    return launches, device, wall, device / wall


def _kugel_lane(model, name: str, card: str) -> dict:
    """The lane's workload: a warm-up (seed 0), then KUGEL_SEEDS (the
    lane's best of seeds 1 and 2, bench.py:621-631, cut to seed 1), and one
    profiled chunk. Returns the numbers it logs."""
    import numpy as np
    import torch

    def run(seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = next(model.generate(KUGEL_TEXT, cfg_scale=KUGEL_CFG,
                                max_tokens=KUGEL_FRAMES,
                                ddpm_steps=KUGEL_STEPS, seed=seed))
        return r, time.perf_counter() - t0, dict(model.last_run)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run(0)
    runs = [run(seed) for seed in KUGEL_SEEDS]
    r, wall, stats = min(runs, key=lambda x: x[1])
    want = KUGEL_FRAMES * KUGEL_HOP
    if not (r.samples == want and np.isfinite(r.audio).all()
            and stats["frames"] == stats["latents"] == KUGEL_FRAMES):
        raise AssertionError(f"{name}: {r.samples} samples (want {want}), "
                             f"{stats['frames']} frames, {stats['latents']} "
                             f"latents, or audio not finite")
    peak = torch.cuda.max_memory_allocated()
    launches, device_ms, wall_ms, busy = _profile_kugel_chunk(model)
    bytes_frame = kugel_frame_bytes(model, stats["cache_len"])
    bound_ms = bytes_frame / HBM_BPS * 1e3
    audio_s = want / model.sample_rate
    frame_ms = stats["frames_s"] / KUGEL_FRAMES * 1e3
    out = dict(wall_s=wall, xrt=audio_s / wall, frame_ms=frame_ms,
               prefill_s=stats["prefill_s"], frames_s=stats["frames_s"],
               vae_s=stats["vae_s"], peak_gb=peak / 1e9,
               own_gb=(peak - base) / 1e9, launches=launches,
               device_ms=device_ms, busy=busy, bound_ms=bound_ms,
               walls=[w for _, w, _ in runs])
    log(f"[kugel {name}] {KUGEL_FRAMES} frames x {KUGEL_STEPS} SDE steps at "
        f"cfg_scale {KUGEL_CFG} -> {want} samples ({audio_s:.2f} s): wall "
        f"{wall:.3f} s best of {len(runs)} "
        f"({', '.join(f'{w:.3f}' for w in out['walls'])}"
        f" s), xRT {out['xrt']:.3f}, {frame_ms:.2f} ms a frame; prefill "
        f"{out['prefill_s'] * 1e3:.1f} ms (bucket {stats['prompt_bucket']}, "
        f"{stats['prompt_len']} tokens), frame loop {out['frames_s']:.3f} s "
        f"in {stats['chunks']} chunks, VAE decode {out['vae_s'] * 1e3:.1f} "
        f"ms; peak device memory {out['peak_gb']:.2f} GB "
        f"({out['own_gb']:.2f} GB above the model); profiled chunk of "
        f"{KUGEL_PROFILE_FRAMES}: {launches:.0f} kernels a frame, "
        f"{device_ms:.3f} ms of device time a frame against {wall_ms:.2f} ms "
        f"of wall ({100 * busy:.1f}% busy); bound {bound_ms:.3f} ms a frame "
        f"({bytes_frame / 1e9:.3f} GB), {100 * bound_ms / frame_ms:.1f}% of "
        f"it reached ({card})")
    return out


def phase_kugel_full(card: str):
    """Phase 23, first half: KugelAudio at the kugelaudio_7b lane's dims
    (8.64 B parameters drawn on the card in f32 from seed 0), bf16 against
    f32 on the lane's prefill hidden rows and one head pass, then cast in
    place to bf16 and the lane's workload. -> (model, the bf16 probe, the
    lane's numbers)."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    model = build_kugel_full()
    torch.cuda.synchronize()
    n_params = model.num_params()
    log(f"[kugel] KugelAudio kugelaudio_7b dims (Qwen2.5-7B LM 28 x d3584, "
        f"GQA 28/4 of 128, FFN 18944, vocab 152,064; head 4 x 3584; VAE hop "
        f"{KUGEL_HOP}): {n_params / 1e9:.3f} B parameters drawn N(0, 0.02) on "
        f"the card in f32 from seed 0 ({time.perf_counter() - t0:.2f} s)")
    if not 8.6e9 < n_params < 8.7e9:
        raise AssertionError(f"{n_params} parameters, the lane has 8.64 B")
    with torch.no_grad():
        ref_h, ref_v = _kugel_probe(model)
        model.astype(torch.bfloat16)
        torch.cuda.empty_cache()
        got_h, got_v = _kugel_probe(model)
    rel_h, rel_v = _frob(got_h, ref_h), _frob(got_v, ref_v)
    del ref_h, ref_v
    if not (torch.isfinite(got_h).all() and rel_h < KUGEL_BF16_REL
            and rel_v < KUGEL_BF16_REL):
        raise AssertionError(f"KugelAudio bf16 vs f32: prefill hidden "
                             f"{rel_h:.3e}, head pass {rel_v:.3e}")
    log(f"[kugel] bf16 vs f32, relative Frobenius: the lane's CFG prefill "
        f"hidden rows {rel_h:.3e}, one head pass on row 0 {rel_v:.3e} (limit "
        f"{KUGEL_BF16_REL:g}; {card})")
    tts_fixtures().force_diffusion(model)
    lane = _kugel_lane(model, "kugelaudio_7b bf16", card)
    return model, (got_h, got_v), lane


def phase_kugel_k2(model, card: str, recorder) -> int:
    """Phase 24, on phase 23's bf16 weights: the LM quantized to affine 8
    bits through apply_quantization with KugelAudio's predicate (group 64,
    no mxu_int8), one 16-frame request with K2's launches against 196 a LM
    step (the prefill's included), then K2 at the LM's four shapes, M = 2
    (a CFG frame) and the prefill's M, against qmatmul_reference, timed
    beside W8A8 and dense bf16 cuBLAS. Returns K2's launches in the
    request."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.utils import apply_quantization

    t0 = time.perf_counter()
    apply_quantization(model, {"quantization": {"bits": 8, "group_size": 64}},
                       model.model_quant_predicate)
    torch.cuda.empty_cache()
    layers = model.language_model.config.num_hidden_layers
    per_step = layers * LINEARS_PER_LAYER
    have = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    if have != per_step:
        raise AssertionError(f"{have} quantized linears, the config gives "
                             f"{per_step}")
    before = qmm_kernel.launches
    with recorder:
        t1 = time.perf_counter()
        r = next(model.generate(KUGEL_TEXT, cfg_scale=KUGEL_CFG,
                                max_tokens=KUGEL_K2_FRAMES,
                                ddpm_steps=KUGEL_STEPS, seed=1))
        wall = time.perf_counter() - t1
    launches = qmm_kernel.launches - before
    run = model.last_run
    want = per_step * (1 + run["frames"])
    pm = 2 * run["prompt_bucket"]
    if launches != want or run["frames"] != KUGEL_K2_FRAMES:
        raise AssertionError(f"KugelAudio q8: {launches} K2 launches over "
                             f"{run['frames']} frames, want {per_step} x (1 + "
                             f"{KUGEL_K2_FRAMES}) = {want}")
    want_calls = {(m, n, k, b) for m in (2, pm)
                  for n, k, b in ((3584, 3584, True), (512, 3584, True),
                                  (3584, 3584, False), (18944, 3584, False),
                                  (3584, 18944, False))}
    if not want_calls <= set(recorder.calls):
        raise AssertionError(f"K2 not launched at {want_calls}")
    if not (r.samples == KUGEL_K2_FRAMES * KUGEL_HOP
            and np.isfinite(r.audio).all()):
        raise AssertionError(f"KugelAudio q8: {r.samples} samples")
    log(f"[kugel q8 K2] affine 8-bit LM (group 64): one request of "
        f"{run['frames']} frames in {wall:.3f} s ({run['frames_s'] * 1e3 / run['frames']:.2f} "
        f"ms a frame, prefill {run['prefill_s'] * 1e3:.1f} ms at M = {pm}), "
        f"{launches} K2 launches = {per_step} x (1 + {run['frames']}) ({card})")
    _linear_times(card, "kugel", KUGEL_SHAPES, KUGEL_LAYER_LINEARS, layers,
                  (2, pm))
    log(f"[kugel q8 K2] phase 24 in {time.perf_counter() - t0:.1f} s "
        f"({card})")
    return launches


def phase_kugel_q8_load(tmp: Path, card: str, recorder) -> int:
    """Phase 24, last: a small f32 KugelAudio checkpoint whose LM has the
    lane's FFN width (KUGEL_LONG_K) and whose config.json asks for affine 8
    bits. load_model on the card quantizes the LM, whose f32 x at M = 2
    (a CFG step) and 2 x the prompt bucket (the prefill) take K2's simt
    path, stepping over down_proj's K = 18,944; its audio must be that of
    the same checkpoint loaded on the CPU (plain versions), one noise on
    both. Returns K2's launches."""
    import torch

    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import choose_path, qmm_kernel

    fx = tts_fixtures()
    ckpt = tmp / "kugelaudio-q8-long-k"
    here = fx.kugel_small("cpu", KUGEL_LONG_K)
    fx.write_tts_checkpoint(here, fx.kugel_hf_state(here), "kugelaudio", ckpt,
                            quantization={"bits": 8, "group_size": 64})
    del here
    dec = KUGEL_LONG_K["decoder_config"]
    per_step = dec["num_hidden_layers"] * LINEARS_PER_LAYER
    table = torch.randn((8, 5, 8), generator=torch.Generator().manual_seed(5))
    models = []
    for dev in ("cpu", "cuda"):
        m = mlx_audio_tpu_torch.load_model(ckpt, device=dev)
        have = sum(isinstance(x, QuantizedLinear) for x in m.modules())
        if have != per_step or m.device.type != dev:
            raise AssertionError(f"load_model on {dev}: {have} quantized "
                                 f"linears, the config gives {per_step}")
        m.tokenizer = fx.CharTok()
        models.append(fx.fixed_draws(fx.force_diffusion(m), table))
    kw = dict(cfg_scale=3.0, max_tokens=6, ddpm_steps=4, seed=1)
    want = next(models[0].generate("hello there", **kw))
    before = qmm_kernel.launches
    with recorder:
        got = next(models[1].generate("hello there", **kw))
    launches = qmm_kernel.launches - before
    run = models[1].last_run
    pm = 2 * run["prompt_bucket"]
    long_k = {(m, dec["hidden_size"], dec["intermediate_size"], False)
              for m in (2, pm)}
    rel = rel_err(torch.from_numpy(got.audio), torch.from_numpy(want.audio))
    if launches != per_step * (1 + run["frames"]) or \
            not long_k <= set(recorder.calls):
        raise AssertionError(f"q8 KugelAudio from load_model: {launches} K2 "
                             f"launches over {run['frames']} frames, want "
                             f"{per_step} x (1 + frames), down_proj at "
                             f"{sorted(long_k)}")
    if any(choose_path(torch.float32, m, 64) != "simt" for m in (2, pm)):
        raise AssertionError("f32 x at M > 1 no longer takes the simt path")
    if not (got.samples == want.samples == 6 * 4 and rel <= KUGEL_SMALL_REL):
        raise AssertionError(f"q8 KugelAudio from load_model: card vs CPU "
                             f"{got.samples} vs {want.samples} samples, rel "
                             f"{rel:.3e}")
    log(f"[kugel q8 load] load_model on a small f32 checkpoint with "
        f"quantization {{bits 8, group 64}} and FFN {dec['intermediate_size']}"
        f": {launches} K2 launches = {per_step} x (1 + {run['frames']}), "
        f"down_proj f32 at M = 2 and {pm} by the simt path's K tiles; audio "
        f"against the CPU load rel {rel:.3e} (tol {KUGEL_SMALL_REL:g}) "
        f"({card})")
    return launches


def phase_kugel_w8a8(model, probe_bf16, card: str) -> dict:
    """Phase 23, second half: the LM's affine codes converted in place to
    W8A8 (to_i8_layout) and every prediction_head linear quantized to 8
    bits and converted the same way, as the lane's leaves are
    (bench.py:559-579); the prefill hidden and the head pass against bf16,
    then the lane's workload."""
    import torch

    from mlx_audio_tpu_torch.model import replace_module
    from mlx_audio_tpu_torch.nn import Int8Linear, QuantizedLinear
    from mlx_audio_tpu_torch.utils import apply_quantization

    for name, m in list(model.named_modules()):
        if isinstance(m, QuantizedLinear):
            replace_module(model, name, Int8Linear.from_quantized(m))
    apply_quantization(
        model, {"quantization": {"bits": 8, "group_size": 64,
                                 "mxu_int8": True}},
        lambda path, w: path.startswith("prediction_head"))
    torch.cuda.empty_cache()
    n_i8 = sum(isinstance(m, Int8Linear) for m in model.modules())
    with torch.no_grad():
        got_h, got_v = _kugel_probe(model)
    rel_h, rel_v = _frob(got_h, probe_bf16[0]), _frob(got_v, probe_bf16[1])
    if not (torch.isfinite(got_h).all() and rel_h < KUGEL_I8_REL
            and rel_v < KUGEL_I8_REL):
        raise AssertionError(f"KugelAudio W8A8 vs bf16: prefill hidden "
                             f"{rel_h:.3e}, head pass {rel_v:.3e}")
    log(f"[kugel] W8A8 vs bf16, relative Frobenius: prefill hidden rows "
        f"{rel_h:.3e}, head pass {rel_v:.3e} (limit {KUGEL_I8_REL:g}); "
        f"{n_i8} W8A8 linears (196 in the LM, 22 in the head) ({card})")
    if n_i8 != 218:
        raise AssertionError(f"{n_i8} W8A8 linears, the lane has 218")
    return _kugel_lane(model, "kugelaudio_7b W8A8", card)


def phase_vibevoice_full(card: str) -> dict:
    """Phase 25: VibeVoice at ModelConfig() dims (a 24-layer Qwen2 split 4
    + 20 at d896, a 4-layer head, 20 DPM steps; every floating parameter
    drawn N(0, 0.02) on the card in f32 from seed 0, then cast in place to
    bf16), no voice, its EOS classifier biased off: a warm-up, then one
    request of VIBE_LATENTS latents (wall, xRT, ms a latent), and one of a speech
    window timed and then profiled (kernels a latent, device time over the
    unprofiled wall)."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.tts.models.vibevoice import Model, ModelConfig

    t0 = time.perf_counter()
    model = Model(ModelConfig(), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=g)
    model.astype(torch.bfloat16)
    model.tts_eos_classifier.fc2.bias.fill_(tts_fixtures().VIBE_EOS_OFF)
    model.tokenizer = LaneTok()
    n_params = model.num_params()
    next(model.generate(KUGEL_TEXT, max_tokens=VIBE_WINDOW, seed=0))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    r = next(model.generate(KUGEL_TEXT, max_tokens=VIBE_LATENTS, seed=1))
    wall = time.perf_counter() - t1
    want = VIBE_LATENTS * model.config.acoustic_tokenizer_config.hop_length
    if not (r.samples == want and np.isfinite(r.audio).all()
            and model.last_run["latents"] == VIBE_LATENTS):
        raise AssertionError(f"VibeVoice: {r.samples} samples, want {want}")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    next(model.generate(KUGEL_TEXT, max_tokens=VIBE_WINDOW, seed=2))
    wall_w = time.perf_counter() - t2
    kernels = _device_kernels(lambda: next(model.generate(
        KUGEL_TEXT, max_tokens=VIBE_WINDOW, seed=2)), cpu=False)
    device_s = sum(_dev_us(e) for e in kernels) / 1e6
    launches = sum(e.count for e in kernels) / VIBE_WINDOW
    audio_s = want / model.sample_rate
    log(f"[vibevoice] ModelConfig() dims ({n_params / 1e9:.3f} B parameters, "
        f"bf16; 4 + 20 Qwen2 layers at d896, head 4 x 896, 20 DPM steps, "
        f"cfg_scale 1.5, no voice, EOS off): {VIBE_LATENTS} latents -> "
        f"{want} samples ({audio_s:.2f} s) in {wall:.3f} s, xRT "
        f"{audio_s / wall:.3f}, {wall * 1e3 / VIBE_LATENTS:.2f} ms a latent "
        f"(text and speech windows and the VAE included); a request of "
        f"{VIBE_WINDOW} latents, profiled: {launches:.0f} kernels a latent, "
        f"{device_s * 1e3:.1f} ms of device time against {wall_w * 1e3:.1f} "
        f"ms of wall unprofiled ({100 * device_s / wall_w:.1f}% busy); phase "
        f"25 in {time.perf_counter() - t0:.1f} s ({card})")
    return dict(wall_s=wall, xrt=audio_s / wall,
                latent_ms=wall * 1e3 / VIBE_LATENTS,
                busy=device_s / wall_w)


# ---------------------------------------------------------------------------
# The server (phase 26, run after phase 16)
# ---------------------------------------------------------------------------

# Kokoro: one whole wav request and one streamed pcm request of this text
SERVER_TEXT = TEXTS[1]
# Qwen3-TTS: concurrent streamed requests through the broker's session,
# frames each (cut from 100 to 50 to keep the run's time, then to 20 with
# the session's, then to 12 for phases 58-61), streaming interval (the b = 8
# session's, phase 11)
SERVER_QWEN3_REQUESTS, SERVER_QWEN3_TOKENS = 8, 12
SERVER_QWEN3_TEXT = ("Request {} of the burst: the server streams this "
                     "sentence as audio.")
# Whisper turbo: seconds of seeded noise a transcription
SERVER_STT_SECONDS = 3
# /v1/realtime: seconds of seeded audio, 200 ms per WS message
SERVER_RT_SECONDS, SERVER_RT_PIECE = 8, 3200
# Silero's probabilities on the card against the CPU, f32 on both sides:
# cuDNN's and the CPU's convolutions sum in other orders, and the LSTM
# carries the difference over the chunks
SILERO_ATOL = 1e-4


class Qwen3Tok:
    """A stand-in for Qwen3-TTS's Qwen2 tokenizer (not in the repository),
    as tests/test_qwen3_tts_icl.py's FakeTokenizer: one id per character,
    inside the text vocabulary."""

    def encode(self, text):
        return [ord(c) % 400 for c in text]


def write_kokoro_checkpoint(path: Path) -> None:
    """Kokoro-82M at the published dims, seeded (seed 0), as a checkpoint
    directory: config.json without a model_type (the router reads the
    family from the directory's name), the weights under the published
    torch names in f32 in one npz, and a seeded voices/af_smoke.npy."""
    import dataclasses

    import numpy as np

    from mlx_audio_tpu_torch.tts.models.kokoro import Model

    model = Model(kokoro_config(), device="cpu").init_params(seed=0)
    path.mkdir(parents=True)
    np.savez(path / "model.npz", **{k: v.float().numpy() for k, v in
                                    model.state_dict().items()})
    cfg = dataclasses.asdict(model.config)
    cfg.pop("model_type", None)
    (path / "config.json").write_text(json.dumps(cfg))
    (path / "voices").mkdir()
    np.save(path / "voices" / "af_smoke.npy",
            (np.random.RandomState(0).randn(510, 1, 256) * 0.1).astype(
                np.float32))


def _percentile(values, q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(len(v) * q))]


def phase_server(card: str, qwen3, whisper, voxtral, tmp: Path,
                 recorder: K2Recorder):
    """The port's server core (`mlx_audio_tpu_torch.server.AudioServer`,
    the code behind every route, called without aiohttp) on the card.
    Returns (K1 launches, K2 launches) of its requests; `recorder` gathers
    the (M, out, in, has bias) K2 was launched with."""
    import asyncio

    t0 = time.perf_counter()
    with recorder:
        k1, k2 = asyncio.run(_server_phase(card, qwen3, whisper, voxtral,
                                           tmp))
    log(f"[server] phase 26 in {time.perf_counter() - t0:.1f} s ({card})")
    return k1, k2


async def _server_phase(card, qwen3, whisper, voxtral, tmp):
    import logging
    import os

    from mlx_audio_tpu_torch.server import AudioServer

    errors = []

    class Collect(logging.Handler):
        def emit(self, record):
            errors.append(record)

    handler = Collect(level=logging.ERROR)
    logging.getLogger("mlx_audio_tpu_torch.server").addHandler(handler)
    os.environ["MLX_AUDIO_TTS_MAX_BATCH_SIZE"] = str(SERVER_QWEN3_REQUESTS)
    server = AudioServer()          # device="cuda"
    try:
        k1 = await _server_kokoro(server, card, tmp)
        k2 = await _server_qwen3(server, card, qwen3)
        if errors:
            raise AssertionError(f"the server logged errors: "
                                 f"{[r.getMessage() for r in errors]}")
        await _server_stt(server, card, whisper)
        await _server_realtime(server, card, voxtral)
    finally:
        logging.getLogger("mlx_audio_tpu_torch.server").removeHandler(
            handler)
        os.environ.pop("MLX_AUDIO_TTS_MAX_BATCH_SIZE", None)
        os.environ.pop("MLX_AUDIO_VAD_MODEL", None)
        server.close()
    if errors:
        raise AssertionError(f"the server logged errors: "
                             f"{[r.getMessage() for r in errors]}")
    if "jax" in sys.modules or "aiohttp" in sys.modules:
        raise AssertionError("jax or aiohttp was imported")
    return k1, k2


async def _server_kokoro(server, card, tmp):
    """Kokoro-82M from a seeded checkpoint, loaded by directory with no
    category (POST /v1/models through the router); a whole wav request and
    a streamed pcm one, 48 K1 launches a synth, the audio of the model's
    own generate() for the same request."""
    import io

    import numpy as np

    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.tts.models.kokoro import Model

    ckpt = tmp / "kokoro-82m-smoke"
    write_kokoro_checkpoint(ckpt)
    t0 = time.perf_counter()
    reply = await server.load_model({"model": str(ckpt)})
    if reply.status != 200:
        raise AssertionError(f"POST /v1/models: {reply.json}")
    model = server.provider.get_cached(str(ckpt))
    if type(model) is not Model or \
            model.device.type != server.provider.device.type:
        raise AssertionError(f"the router loaded {type(model)} on "
                             f"{model.device}")
    log(f"[server] Kokoro-82M checkpoint loaded by directory through "
        f"ModelProvider and the router (no category): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    legs = len(synth_legs(model.istft_cfg))
    total = 0
    bodies = {}
    for fmt, stream in (("wav", False), ("pcm", True)):
        before = snake_conv_kernel.launches
        t1 = time.perf_counter()
        reply = await server.speech({"model": str(ckpt), "input": SERVER_TEXT,
                                     "voice": "af_smoke",
                                     "response_format": fmt,
                                     "stream": stream})
        body = await reply.read()
        wall = time.perf_counter() - t1
        launches = snake_conv_kernel.launches - before
        total += launches
        if reply.status != 200 or launches != legs:
            raise AssertionError(f"Kokoro {fmt}: status {reply.status}, "
                                 f"{launches} K1 launches, want {legs}")
        bodies[fmt] = body
        log(f"[server] Kokoro speech {fmt} ({'streamed' if stream else 'whole'}"
            f"): {len(body)} bytes, wall {wall * 1e3:.2f} ms, {launches} K1 "
            f"launches ({card})")
    before = snake_conv_kernel.launches
    (r,) = list(model.generate(SERVER_TEXT, voice="af_smoke"))
    total += snake_conv_kernel.launches - before
    buf = io.BytesIO()
    audio_io.write(buf, np.asarray(r.audio), r.sample_rate, format="wav")
    want_wav = buf.getvalue()
    want_pcm = np.clip(np.round(np.asarray(r.audio) * 32768.0), -32768,
                       32767).astype("<i2").tobytes()
    got, _ = audio_io.read(io.BytesIO(bodies["wav"]), dtype="float32")
    diff = np.abs(np.frombuffer(bodies["wav"][44:], "<i2").astype(int)
                  - np.frombuffer(want_wav[44:], "<i2").astype(int))
    if bodies["wav"][:44] != want_wav[:44] or len(bodies["wav"]) != \
            len(want_wav) or diff.max() > 1 or not np.isfinite(got).all():
        raise AssertionError(f"served WAV differs from generate(): "
                             f"{len(bodies['wav'])} vs {len(want_wav)} bytes, "
                             f"max diff {diff.max()} LSB")
    if len(bodies["pcm"]) != len(want_pcm):
        raise AssertionError("served PCM has the wrong length")
    log(f"[server] Kokoro: the served WAV against in-process generate() of "
        f"the same request: same header and length, bytes equal "
        f"{bodies['wav'] == want_wav}, max difference {diff.max()} LSB; the "
        f"streamed PCM's bytes equal {bodies['pcm'] == want_pcm}; "
        f"{legs} K1 launches a synth")
    server.provider.unload(str(ckpt))
    return total


async def _server_qwen3(server, card, qwen3):
    """SERVER_QWEN3_REQUESTS concurrent streamed speech requests (text,
    through the stand-in tokenizer) to the q8 Qwen3-TTS of phases 6-11:
    the broker's continuous-batching session takes them all; time to
    first audio, aggregate xRT, and K2's launches against the config's
    count (722 a frame)."""
    import asyncio

    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.continuous_batching \
        import Qwen3TTSBatchSession

    qwen3.tokenizer = Qwen3Tok()
    server.provider._models["qwen3-tts-1.7b-q8"] = qwen3
    spf = qwen3.total_upsample
    before, tp0 = qmm_kernel.launches, qwen3._text_projection_calls

    async def one(i):
        t1 = time.perf_counter()
        reply = await server.speech({
            "model": "qwen3-tts-1.7b-q8",
            "input": SERVER_QWEN3_TEXT.format(i + 1), "stream": True,
            "response_format": "pcm", "max_tokens": SERVER_QWEN3_TOKENS,
            "streaming_interval": SESSION_INTERVAL, "temperature": 0.9})
        ttfa = time.perf_counter() - t1
        if reply.status != 200:
            raise AssertionError(f"Qwen3 speech: {reply.status} "
                                 f"{reply.json}")
        body = await reply.read()
        if body[:1] == b"{":
            raise AssertionError(f"Qwen3 stream error: {body[:200]}")
        return ttfa, time.perf_counter() - t1, body

    # the burst finds no session: the broker makes one for its first
    # request and warms it up before any request joins it (timed here)
    S = Qwen3TTSBatchSession
    warmup, warm_s = S.warmup, []

    def timed_warmup(sess):
        t1 = time.perf_counter()
        warmup(sess)
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t1)

    S.warmup = timed_warmup
    try:
        with _SessionCounts() as counts:
            t0 = time.perf_counter()
            results = await asyncio.gather(*[one(i) for i in range(
                SERVER_QWEN3_REQUESTS)])
            wall = time.perf_counter() - t0
            # the broker's worker thread has answered every request; wait
            # for its idle loop so that the counts are final
            await asyncio.sleep(0.5)
    finally:
        S.warmup = warmup
    launches = qmm_kernel.launches - before
    want = session_k2_launches(qwen3, counts.frames, counts.groups,
                               qwen3._text_projection_calls - tp0)
    if launches != want:
        raise AssertionError(f"server Qwen3: {launches} K2 launches, want "
                             f"{want} ({counts.frames} frames, "
                             f"{counts.groups} admissions)")
    audio_s = 0.0
    for _, _, body in results:
        pcm = np.frombuffer(body, "<i2")
        if not len(pcm) or len(pcm) % spf:
            raise AssertionError(f"Qwen3 served {len(pcm)} samples")
        audio_s += len(pcm) / qwen3.sample_rate
    ttfa = [r[0] for r in results]
    if len(warm_s) != 1:
        raise AssertionError(f"{len(warm_s)} session warm-ups")
    log(f"[server] Qwen3-TTS q8, {SERVER_QWEN3_REQUESTS} concurrent "
        f"streamed pcm requests of {SERVER_QWEN3_TOKENS} frames to a cold "
        f"server: the broker made the continuous-batching session and "
        f"warmed it up in {warm_s[0] * 1e3:.2f} ms (no error logged), then "
        f"all joined it: {audio_s:.2f} s of audio in "
        f"{wall * 1e3:.2f} ms, aggregate xRT {audio_s / wall:.3f}; time to "
        f"first audio p50 {_percentile(ttfa, 0.5) * 1e3:.2f} ms, max "
        f"{max(ttfa) * 1e3:.2f} ms (the warm-up included); {launches} K2 "
        f"launches = 722 x "
        f"({counts.frames} frames + {counts.groups} admissions) + text "
        f"projections ({card})")
    server.provider.unload("qwen3-tts-1.7b-q8")
    return launches


async def _server_stt(server, card, whisper):
    """One transcription as json and one streamed as NDJSON through the
    STT adapter, on the large-v3-turbo model of phase 13; the text of
    the model's own generate() for the same audio."""
    import io

    import numpy as np

    from mlx_audio_tpu_torch import audio_io

    server.provider._models["whisper-large-v3-turbo"] = whisper
    buf = io.BytesIO()
    audio_io.write(buf, (np.random.RandomState(3).randn(
        SERVER_STT_SECONDS * 16000) * 0.1).astype(np.float32), 16000)
    wav = buf.getvalue()
    audio, _ = audio_io.read(io.BytesIO(wav), dtype="float32")
    fields = {"model": "whisper-large-v3-turbo", "language": "en",
              "temperature": "0.0"}
    t0 = time.perf_counter()
    reply = await server.transcribe(dict(fields), wav)
    wall = time.perf_counter() - t0
    want = whisper.generate(audio, language="en", temperature=0.0)
    if reply.status != 200 or reply.json["text"] != want.text:
        raise AssertionError(f"transcription {reply.status}: "
                             f"{reply.json} vs {want.text!r}")
    t0 = time.perf_counter()
    reply = await server.transcribe(
        {**fields, "stream": "true", "response_format": "ndjson"}, wav)
    lines = [json.loads(ln) for ln in
             (await reply.read()).decode().splitlines()]
    swall = time.perf_counter() - t0
    want_s = [o.text for o in whisper.generate(audio, language="en",
                                               temperature=0.0, stream=True)]
    if [ln.get("text") for ln in lines] != want_s:
        raise AssertionError(f"NDJSON {lines} vs {want_s}")
    log(f"[server] transcription of {SERVER_STT_SECONDS} s through the STT "
        f"adapter (Whisper large-v3-turbo, bf16): json {wall * 1e3:.2f} ms "
        f"({len(want.text)} chars, equal to generate()); NDJSON streamed "
        f"{swall * 1e3:.2f} ms, {len(lines)} lines equal to "
        f"generate(stream=True) ({card})")
    server.provider.unload("whisper-large-v3-turbo")


async def _server_realtime(server, card, voxtral):
    """/v1/realtime with server_vad: Voxtral-Mini-3B-Realtime (phase 16's
    model) and Silero at its published dims (seed 0), fed seeded audio in
    200-ms messages. Silero's probabilities on the card against the CPU;
    the session's turn events against the CPU turn detector over the
    card's probabilities; then one manual-commit turn."""
    import base64
    import os

    import numpy as np
    import torch

    from mlx_audio_tpu_torch.realtime_vad import (VAD_FRAME_MS,
                                                  ServerVadConfig,
                                                  TurnDetector)
    from mlx_audio_tpu_torch.vad.models.silero_vad import Model, ModelConfig

    silero = Model(ModelConfig(), device="cuda").init_params(seed=0)
    cpu = Model(ModelConfig(), device="cpu").init_params(seed=0)
    rs = np.random.RandomState(4)
    n = SERVER_RT_SECONDS * 16000
    env = np.repeat(rs.rand(n // 8000 + 1) > 0.4, 8000)[:n] * 0.5 + 0.02
    audio = np.clip(rs.randn(n) * env, -1, 1).astype(np.float32)
    pcm16 = (audio * 32767).astype("<i2")
    heard = pcm16.astype(np.float32) / 32768.0     # what the server decodes
    t0 = time.perf_counter()
    probs = silero.predict_proba(heard)
    torch.cuda.synchronize()
    off_ms = (time.perf_counter() - t0) * 1e3
    ref = cpu.predict_proba(heard)
    err = float(np.abs(probs - ref).max())
    if not err <= SILERO_ATOL:
        raise AssertionError(f"Silero card vs CPU: {err:.3e}")
    # random weights: pick the threshold (a quantile of this audio's
    # probabilities) whose turns the CPU detector counts most
    def turns(p, cfg):
        det = TurnDetector(cfg)
        return [(e.kind.value, e.audio_ms) for x in p
                for e in det.push(float(x), VAD_FRAME_MS)]

    cands = [ServerVadConfig(threshold=float(np.quantile(probs, q)),
                             prefix_padding_ms=100, silence_duration_ms=320)
             for q in (0.3, 0.4, 0.5, 0.6, 0.7)]
    cfg = max(cands, key=lambda c: sum(k == "speech_stopped"
                                       for k, _ in turns(probs, c)))
    log(f"[server] Silero ({sum(p.numel() for p in silero.parameters()):,} "
        f"parameters, seed 0) over {SERVER_RT_SECONDS} s: "
        f"{len(probs)} chunks in {off_ms:.2f} ms on the card, against the "
        f"CPU max |diff| {err:.3e} (tol {SILERO_ATOL:g}); threshold "
        f"{cfg.threshold:.6f}")

    seen = []                       # the card's per-frame probabilities
    feed = silero.feed

    def recording_feed(chunk, state=None, sample_rate=16000):
        p, state = feed(chunk, state, sample_rate=sample_rate)
        seen.append(float(p.reshape(-1)[0]))
        return p, state

    silero.feed = recording_feed
    lat = []
    make = voxtral.create_streaming_session

    def timed_session(**kw):
        sess = make(**kw)
        step = sess.step

        def timed_step(*a, **k):
            t1 = time.perf_counter()
            out = step(*a, **k)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
            return out

        sess.step = timed_step
        return sess

    voxtral.create_streaming_session = timed_session
    server.provider._models.update(voxtral=voxtral, silero=silero)
    os.environ["MLX_AUDIO_VAD_MODEL"] = "silero"
    events = []

    async def send(event):
        events.append(event)

    try:
        session = await server.open_realtime("voxtral", send)
        await session.on_event({"type": "session.update", "session": {
            "turn_detection": {**cfg.to_dict()}}})
        t0 = time.perf_counter()
        for off in range(0, n, SERVER_RT_PIECE):
            await session.on_event({
                "type": "input_audio_buffer.append",
                "audio": base64.b64encode(
                    pcm16[off:off + SERVER_RT_PIECE].tobytes()).decode()})
        vad_wall = time.perf_counter() - t0
        vad_events = [(e["type"].rsplit(".", 1)[-1],
                       e.get("audio_start_ms", e.get("audio_end_ms")))
                      for e in events if e["type"].startswith(
                          "input_audio_buffer.speech_")]
        want = turns(seen, cfg)
        if vad_events != want or not want:
            raise AssertionError(f"turn events {vad_events} vs the CPU "
                                 f"detector's {want}")
        seen_err = float(np.abs(np.asarray(seen) - ref[:len(seen)]).max())
        if len(seen) != len(probs) or seen_err > SILERO_ATOL:
            raise AssertionError(f"streamed Silero: {len(seen)} frames, "
                                 f"{seen_err:.3e} from the CPU's")
        n_done = sum(e["type"].endswith("transcription.completed")
                     for e in events)
        n_delta = sum(e["type"].endswith("transcription.delta")
                      for e in events)
        # one manual-commit turn
        await session.on_event({"type": "session.update", "session": {
            "turn_detection": None}})
        mark = len(events)
        for off in range(0, 2 * 16000, SERVER_RT_PIECE):
            await session.on_event({
                "type": "input_audio_buffer.append",
                "audio": base64.b64encode(
                    pcm16[off:off + SERVER_RT_PIECE].tobytes()).decode()})
        await session.on_event({"type": "input_audio_buffer.commit"})
        kinds = [e["type"] for e in events[mark:]]
        if kinds[-3:] != ["input_audio_buffer.committed",
                          "conversation.item.added",
                          "conversation.item.input_audio_transcription."
                          "completed"]:
            raise AssertionError(f"manual commit: {kinds}")
    finally:
        del voxtral.create_streaming_session
        del silero.feed
    n_turns = sum(k == "speech_stopped" for k, _ in vad_events)
    log(f"[server] /v1/realtime server_vad: {SERVER_RT_SECONDS} s in "
        f"{n // SERVER_RT_PIECE} messages of 200 ms ({vad_wall:.2f} s of "
        f"wall): {len(seen)} Silero frames on the card (max |diff| from the "
        f"CPU {seen_err:.3e}), {len(vad_events)} turn events (the first "
        f"{vad_events[:4]}) equal to the CPU detector's over the card's "
        f"probabilities, {n_turns} turns "
        f"completed by the VAD ({n_done} transcripts, {n_delta} deltas); "
        f"then a manual-commit turn of 2 s: committed, item added, "
        f"transcript; Voxtral step latency p50 "
        f"{_percentile(lat, 0.5) * 1e3:.2f} ms, p95 "
        f"{_percentile(lat, 0.95) * 1e3:.2f} ms over {len(lat)} steps "
        f"({card})")
    server.provider.unload("voxtral")
    server.provider.unload("silero")



# ---------------------------------------------------------------------------
# Voice cloning on the Mimi stack (phases 27-29)
# ---------------------------------------------------------------------------

# tests/test_codecs.py::TestMimi's config (frame rate 1 kHz: 24 samples a
# frame)
MIMI_SMALL = dict(
    seanet=dict(dimension=32, channels=1, causal=True, nfilters=4,
                nresidual_layers=1, ratios=[4, 3], ksize=7, residual_ksize=3,
                last_ksize=3, dilation_base=2, pad_mode="constant",
                true_skip=True, compress=2),
    transformer=dict(d_model=32, num_heads=4, num_layers=2, layer_scale=0.01,
                     context=16, dim_feedforward=64),
    quantizer_nq=4, quantizer_bins=64, quantizer_dim=16, sample_rate=24000,
    frame_rate=1000.0)
# tests/test_qwen3_tts_icl.py's TINY_ENCODER_CFG and TINY_SPK_CFG
QWEN3_ENCODER_SMALL = dict(
    hidden_size=16, num_filters=4, num_residual_layers=1,
    upsampling_ratios=[4, 3], kernel_size=3, residual_kernel_size=3,
    last_kernel_size=3, num_attention_heads=2, num_hidden_layers=1,
    intermediate_size=32, sliding_window=16, num_quantizers=4,
    codebook_size=64, codebook_dim=8, sampling_rate=24000,
    frame_rate=24000 / (4 * 3 * 2))
QWEN3_SPK_SMALL = dict(
    mel_dim=128, enc_dim=32, enc_channels=[8, 8, 8, 16],
    enc_kernel_sizes=[3, 3, 3, 1], enc_dilations=[1, 2, 3, 1],
    enc_attention_channels=8, enc_res2net_scale=4, enc_se_channels=8)
# tests/test_sesame_cloning.py's model (its Mimi: MIMI_SMALL at 40 bins)
SESAME_SMALL = dict(
    text_vocab_size=128, audio_vocab_size=40, audio_num_codebooks=4,
    backbone_config=dict(hidden_size=32, num_hidden_layers=2,
                         intermediate_size=64, num_attention_heads=4,
                         num_key_value_heads=2, head_dim=8),
    depth_decoder_config=dict(hidden_size=24, num_hidden_layers=1,
                              intermediate_size=48, num_attention_heads=4,
                              num_key_value_heads=2, head_dim=8))
# CUDA against the CPU at f32 on the small configs: summation order only
CLONE_REL = 1e-4
# phase 28: a seeded 10-s reference clip and 120-character stand-in texts
# (one id a character: a 512-row ICL prompt bucket); 20 frames whole and
# streamed every 1.0 s, two chunks (50 every 2.0 s until phases 41-44
# came, 30 until phases 62-66), 16 for the x-vector and the server's
# voice-library request (30 until phases 58-61)
ICL_REF_SECONDS, ICL_FRAMES, ICL_SHORT_FRAMES = 10, 20, 16
ICL_REF_TEXT = ("This reference clip was recorded for the voice cloning "
                "check; its words are read back as the prompt's transcript.")
ICL_TEXT = ("The cloned voice now reads a different sentence, long enough "
            "to fill the prompt bucket the chip run is meant to measure.")
ICL_STREAM_INTERVAL = 1.0
ICL_SEED = 5
# the Mimi reference encoder's codes on a 2-s clip, card against CPU
ICL_CHECK_SECONDS = 2
# phase 29: Sesame CSM-1B, 8 frames (0.64 s) whole and streamed every 0.5 s
# (cut from 64 to 32 to keep the run's time, then to 16 for phases 41-44
# and to 8 for phases 58-61)
SESAME_FRAMES, SESAME_INTERVAL, SESAME_SEED = 8, 0.5, 3
# frames under the profiler (about 9,000 kernels each; 2 until phases
# 62-66)
SESAME_PROFILE_FRAMES = 1
SESAME_REF_TEXT = "A ten second reference segment for the cloned voice."
SESAME_TEXT = "Sesame reads this sentence in the reference speaker's voice."


class CharTok:
    """A stand-in text tokenizer (none is in the repository): one id a
    character, inside every text vocabulary here, as the tests' fakes."""

    def encode(self, text):
        return [ord(c) % 100 + 3 for c in text]


def _clone_audio(seconds: float, seed: int):
    import numpy as np

    return (np.random.RandomState(seed).randn(int(seconds * 24000))
            * 0.1).astype(np.float32)


def _qwen3_clone_small(device: str):
    """The small Qwen3-TTS of phase 6 with the small reference and speaker
    encoders attached, dense f32 (no K2), seed 0."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.config import \
        Qwen3TTSSpeakerEncoderConfig

    cfg = qwen3_small_config()
    cfg.tokenizer_config.encoder_config = dict(QWEN3_ENCODER_SMALL)
    cfg.tokenizer_config.encoder_valid_num_quantizers = 4
    cfg.speaker_encoder_config = Qwen3TTSSpeakerEncoderConfig(
        **QWEN3_SPK_SMALL)
    model = Model(cfg, device=device)
    model.attach_ref_encoder()
    model.attach_speaker_encoder()
    model.init_params(seed=0)
    model.tokenizer = Qwen3Tok()
    return model


def phase_clone_reference():
    """Phase 27: the small configs at f32 from one seeded weight set, CUDA
    against the CPU: Mimi codes (equal) and audio, whole and streamed; the
    ECAPA x-vector; a greedy Qwen3-TTS ICL request (the codes handed to the
    codec equal, audio); a greedy Sesame request cloning a reference
    segment (frames equal, audio whole and streamed)."""
    import copy

    import numpy as np
    import torch

    from mlx_audio_tpu_torch.codec.models.mimi import Mimi, MimiConfig
    from mlx_audio_tpu_torch.tts.models.sesame import Model as Sesame
    from mlx_audio_tpu_torch.tts.models.sesame import ModelConfig as SCfg

    t0 = time.perf_counter()
    errs = {}
    cpu = Mimi(MimiConfig(**MIMI_SMALL), device="cpu").init_params(seed=0)
    gpu = copy.deepcopy(cpu).to("cuda")
    audio = _clone_audio(0.1, 1)[None]
    codes = [m.encode(audio).cpu() for m in (cpu, gpu)]
    if not torch.equal(*codes):
        raise AssertionError(f"Mimi codes differ: "
                             f"{(codes[0] != codes[1]).float().mean():.3%}")
    whole = [m.decode(codes[0]).cpu() for m in (cpu, gpu)]
    errs["Mimi decode"] = rel_err(whole[1], whole[0])
    state = gpu.init_decode_stream_state(
        1, codes[0].shape[-1] * gpu.downsample_stride)
    parts = []
    for a, b in ((0, 3), (3, 7), (7, codes[0].shape[-1])):
        state, piece = gpu.decode_step(state, codes[0][:, :, a:b])
        parts.append(piece.cpu())
    errs["Mimi streamed decode"] = rel_err(torch.cat(parts, -1), whole[0])

    q_cpu = _qwen3_clone_small("cpu")
    q_gpu = copy.deepcopy(q_cpu).to("cuda")
    q_gpu.tokenizer = Qwen3Tok()
    ref = _clone_audio(0.2, 2)
    xv = [m.extract_speaker_embedding(ref).cpu() for m in (q_cpu, q_gpu)]
    errs["ECAPA x-vector"] = rel_err(xv[1], xv[0])
    kw = dict(text="clone me", ref_audio=ref, ref_text="a reference",
              temperature=0.0, max_tokens=12)
    (rc, cc), (rg, cg) = (_codes_fed_to_codec(m, **kw)
                          for m in (q_cpu, q_gpu))
    if not torch.equal(cc, cg):
        raise AssertionError(f"Qwen3 ICL codes differ:\n{cc}\n{cg}")
    errs["Qwen3 ICL audio"] = rel_err(rg.audio, rc.audio)

    s_cpu = Sesame(SCfg(**SESAME_SMALL), device="cpu").init_params(seed=0)
    s_cpu.tokenizer = CharTok()
    s_cpu.set_codec(Mimi(MimiConfig(**dict(MIMI_SMALL, quantizer_bins=40)),
                         device="cpu").init_params(seed=1))
    s_gpu = copy.deepcopy(s_cpu).to("cuda")
    s_gpu.set_codec(copy.deepcopy(s_cpu._mimi).to("cuda"))
    kw = dict(text="hello there", ref_audio=_clone_audio(0.05, 3),
              ref_text="a reference", temperature=0.0,
              max_audio_length_ms=1600)
    (sc,), (sg,) = (list(m.generate(**kw)) for m in (s_cpu, s_gpu))
    if not np.array_equal(sc.prompt["codes"], sg.prompt["codes"]):
        raise AssertionError("Sesame greedy frames differ")
    errs["Sesame audio"] = rel_err(sg.audio, sc.audio)
    streamed = list(s_gpu.generate(stream=True, streaming_interval=0.2,
                                   **kw))
    errs["Sesame streamed audio"] = rel_err(
        np.concatenate([r.audio for r in streamed]), sc.audio)
    log(f"[clone reference] small configs f32, CUDA vs CPU: Mimi codes "
        f"{tuple(codes[0].shape)} equal, Qwen3 ICL codes "
        f"{tuple(cc.shape)} equal, Sesame frames "
        f"{sc.prompt['codes'].shape} equal; rel err "
        + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (tol {CLONE_REL:g}); {time.perf_counter() - t0:.1f} s")
    for name, err in errs.items():
        if not err <= CLONE_REL:
            raise AssertionError(f"CUDA vs CPU {name}: rel {err:.3e}")


def _tf32(on: bool):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _sync_s(fn):
    """(fn(), seconds with the card synchronised after)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_qwen3_clone(model, card: str, recorder: K2Recorder,
                      tmp: Path) -> int:
    """Phase 28: voice cloning on the q8 Qwen3-TTS of phases 6-11 at the
    qwen3_tts_1b7 lane's dims. Returns K2's launches; `recorder` gathers
    the (M, out, in, has bias) they ran at."""
    import asyncio
    import copy

    import numpy as np
    import torch
    import torch.nn.functional as F

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.qwen3_tts import (
        CACHE_BUCKETS, CHUNK_TOKENS, PROMPT_BUCKETS, _bucket)

    t_phase = time.perf_counter()
    k1_before = snake_conv_kernel.launches
    enc = model.attach_ref_encoder().init_params(seed=1, on_device=True)
    spk = model.attach_speaker_encoder().init_params(seed=2, on_device=True)
    model.tokenizer = Qwen3Tok()
    c = enc.config
    log(f"[qwen3 clone] reference encoder: Mimi encoder at "
        f"encoder_mimi_config(None) ({c.quantizer_nq} quantizers of "
        f"{c.quantizer_bins} x {c.quantizer_dim}, "
        f"{model.config.tokenizer_config.encoder_valid_num_quantizers} "
        f"valid; {enc.num_params():,} params), ECAPA at the default "
        f"config ({spk.num_params():,} params), both f32, seeded")
    # the full-width encoder on the card against the same weights on the
    # CPU, then the share of codes TF32 would flip
    clip2 = _clone_audio(ICL_CHECK_SECONDS, 11)
    enc_cpu = copy.deepcopy(enc).to("cpu")
    got, want = enc.encode(clip2).cpu(), enc_cpu.encode(clip2)
    lat = rel_err(enc.encode_to_latent(clip2).cpu(),
                  enc_cpu.encode_to_latent(clip2))
    del enc_cpu
    same = float((got == want).float().mean())
    clip = _clone_audio(ICL_REF_SECONDS, 12)
    exact = enc.encode(clip)
    _tf32(True)
    try:
        with torch.inference_mode():
            loose = enc.quantizer_encode(enc._latent(clip))
    finally:
        _tf32(False)
    flipped = float((loose != exact).float().mean())
    flipped0 = float((loose[:, 0] != exact[:, 0]).float().mean())
    log(f"[qwen3 clone] reference encoder on a {ICL_CHECK_SECONDS}-s clip, "
        f"card (TF32 off in its scope) against the CPU: latents rel err "
        f"{lat:.3e}, codes {tuple(got.shape)} equal {same:.2%}; on the "
        f"{ICL_REF_SECONDS}-s clip with TF32 on, {flipped:.2%} of its codes "
        f"differ ({flipped0:.2%} of book 0)")
    if not (lat <= CLONE_REL and torch.equal(got, want)):
        raise AssertionError(f"reference encoder card vs CPU: latents rel "
                             f"{lat:.3e}, codes equal {same:.2%}")
    # the 10-s reference's encode and x-vector, cold then warm
    times = {}
    for run in ("cold", "warm"):
        codes, times[f"Mimi encode {run}"] = _sync_s(
            lambda: model.encode_ref_audio(clip))
        _, times[f"x-vector {run}"] = _sync_s(
            lambda: model.extract_speaker_embedding(clip))
    if codes.shape != (1, 16, ICL_REF_SECONDS * 25 // 2):
        raise AssertionError(f"reference codes {tuple(codes.shape)}")

    qmm_kernel.launches = 0
    total = 0
    results = {}
    with recorder:
        # the ICL prefill alone at its bucket, cold and warm
        emb, _, _, _ = model.prepare_icl_inputs(ICL_TEXT, clip, ICL_REF_TEXT)
        plen = emb.shape[1]
        pb = _bucket(plen, PROMPT_BUCKETS)
        cache_len = min(_bucket(pb + ICL_FRAMES + CHUNK_TOKENS,
                                CACHE_BUCKETS), 4096)
        emb = F.pad(emb, (0, 0, 0, pb - plen))
        with torch.inference_mode():
            for run in ("cold", "warm"):
                _, times[f"prefill {run}"] = _sync_s(
                    lambda: model._prefill(emb, plen, cache_len))
        talker = k2_per_pass(model)[0]
        total += 2 * talker + 3 * k2_per_pass(model)[2]
        if pb != 512:
            raise AssertionError(f"ICL prompt of {plen} rows: bucket {pb}")
        # whole, streamed, x-vector only
        runs = (("ICL whole", dict(ref_text=ICL_REF_TEXT), ICL_FRAMES, False),
                ("ICL streamed", dict(ref_text=ICL_REF_TEXT), ICL_FRAMES,
                 True),
                ("x-vector", {}, ICL_SHORT_FRAMES, False))
        for name, extra, frames, stream in runs:
            before = qmm_kernel.launches
            t1 = time.perf_counter()
            out, ttfa = [], None
            for r in model.generate(ICL_TEXT, ref_audio=clip,
                                    temperature=0.9, max_tokens=frames,
                                    seed=ICL_SEED, stream=stream,
                                    streaming_interval=ICL_STREAM_INTERVAL,
                                    **extra):
                ttfa = ttfa or time.perf_counter() - t1
                out.append(np.asarray(r.audio))
            wall = time.perf_counter() - t1
            launches = qmm_kernel.launches - before
            total += launches
            run = model.last_run
            want = expected_k2_launches(model, run)
            audio = np.concatenate(out)
            n_frames = len(audio) // model.total_upsample
            if launches != want or len(audio) % model.total_upsample or \
                    not np.isfinite(audio).all() or not len(audio):
                raise AssertionError(
                    f"{name}: {launches} K2 launches (want {want}), "
                    f"{len(audio)} samples, finite "
                    f"{np.isfinite(audio).all()} ({run})")
            results[name] = dict(wall=wall, ttfa=ttfa, frames=n_frames,
                                 steps=run["decode_steps"],
                                 bucket=run["prompt_bucket"],
                                 launches=launches)
            log(f"[qwen3 clone] {name}: prompt bucket "
                f"{run['prompt_bucket']}, reference {run['ref_frames']} "
                f"frames, {n_frames} frames generated ({run['decode_steps']} "
                f"decode steps), {len(audio) / 24000:.2f} s of audio in "
                f"{wall * 1e3:.2f} ms (xRT {len(audio) / 24000 / wall:.3f}, "
                f"{wall * 1e3 / (run['decode_steps'] + 1):.2f} ms a frame"
                + (f", first audio {ttfa * 1e3:.2f} ms" if stream else "")
                + f"), {launches} K2 launches = config's count ({card})")
        total += asyncio.run(_server_clone(model, card, clip, tmp))
    if qmm_kernel.launches != total:
        raise AssertionError(f"K2 launched {qmm_kernel.launches} times in "
                             f"phase 28; the requests account for {total}")
    if snake_conv_kernel.launches != k1_before:
        raise AssertionError("K1 launched in phase 28")
    log(f"[qwen3 clone] the {ICL_REF_SECONDS}-s reference's "
        + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in times.items())
        + f"; the ICL prefill runs {talker} K2 launches at M = {pb} ({card})")
    # K2 against dense bf16 cuBLAS at the prefill's M, per talker shape
    _linear_times(card, "qwen3 icl prefill", QWEN3_TALKER_SHAPES,
                  QWEN3_TALKER_LINEARS, model.tcfg.num_hidden_layers,
                  (pb,))
    log(f"[time] phase 28 in {time.perf_counter() - t_phase:.1f} s")
    return total


# the talker layer's quantized linears by shape (out, in): q; k and v; o;
# gate and up; down
QWEN3_TALKER_SHAPES = ((2048, 1024), (1024, 1024), (1024, 2048),
                       (3072, 1024), (1024, 3072))
QWEN3_TALKER_LINEARS = (1, 2, 1, 2, 1)


async def _server_clone(model, card, clip, tmp) -> int:
    """One speech request through `AudioServer` with ref_audio
    "voice:<name>" from its voice library (stored with its ref_text): the
    adapter's serial generate, never the session; the WAV equal, to 1 LSB,
    to the model's own generate() of the same request. -> K2 launches."""
    import io

    import numpy as np

    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.server import AudioServer
    from mlx_audio_tpu_torch.voice_store import VoiceStore

    server = AudioServer()          # device="cuda"
    try:
        server.voices = VoiceStore(tmp / "voices")
        server.voices.save("clone", clip, 24000, ref_text=ICL_REF_TEXT)
        server.provider._models["qwen3-clone"] = model
        before = qmm_kernel.launches
        t0 = time.perf_counter()
        reply = await server.speech({
            "model": "qwen3-clone", "input": ICL_TEXT,
            "ref_audio": "voice:clone", "max_tokens": ICL_SHORT_FRAMES,
            "temperature": 0.9, "seed": ICL_SEED})
        body = await reply.read()
        wall = time.perf_counter() - t0
        launches = qmm_kernel.launches - before
        if reply.status != 200:
            raise AssertionError(f"clone speech: {reply.status} {body[:200]}")
        if launches != expected_k2_launches(model, model.last_run) or \
                server.broker._sessions:
            raise AssertionError(f"clone speech: {launches} K2 launches, "
                                 f"sessions {list(server.broker._sessions)}")
    finally:
        server.close()
    ref = server.voices.load("clone", sample_rate=24000)
    before = qmm_kernel.launches
    (r,) = list(model.generate(ICL_TEXT, ref_audio=ref,
                               ref_text=ICL_REF_TEXT,
                               max_tokens=ICL_SHORT_FRAMES, temperature=0.9,
                               seed=ICL_SEED))
    launches += qmm_kernel.launches - before
    buf = io.BytesIO()
    audio_io.write(buf, np.asarray(r.audio), r.sample_rate, format="wav")
    want = buf.getvalue()
    diff = np.abs(np.frombuffer(body[44:], "<i2").astype(int)
                  - np.frombuffer(want[44:], "<i2").astype(int))
    if len(body) != len(want) or diff.max() > 1:
        raise AssertionError(f"served clone WAV: {len(body)} vs {len(want)} "
                             f"bytes, max diff {diff.max()} LSB")
    log(f"[qwen3 clone] AudioServer speech with ref_audio=\"voice:clone\" "
        f"(its stored ref_text): 200, {len(body) - 44} bytes of WAV in "
        f"{wall * 1e3:.2f} ms through the serial path (no session), equal "
        f"to generate() of the same request to {diff.max()} LSB ({card})")
    return launches


def build_sesame_full():
    """Sesame CSM-1B at `ModelConfig()` (llama-1B backbone, llama-100M
    depth decoder, 32 codebooks), drawn on the card from seed 0 and cast to
    bf16; its Mimi at mimi_202407(32) in f32 from seed 1."""
    import torch

    from mlx_audio_tpu_torch.codec.models.mimi import Mimi, mimi_202407
    from mlx_audio_tpu_torch.tts.models.sesame import Model, ModelConfig

    t0 = time.perf_counter()
    model = Model(ModelConfig(), device="cuda").astype(torch.bfloat16)
    model.init_params(seed=0, on_device=True)
    mimi = Mimi(mimi_202407(32), device="cuda").init_params(seed=1,
                                                             on_device=True)
    model.set_codec(mimi)
    model.tokenizer = CharTok()
    with torch.no_grad():
        # codebook 0's EOS row zeroed: its logit 0 stays out of the top 50
        # of 2,051 random logits, so the frames run to the request's end
        model.codebook0_head.weight[model.config.codebook_eos_token_id] = 0
    torch.cuda.synchronize()
    log(f"[sesame] CSM-1B {model.num_params():,} params bf16 and Mimi "
        f"{mimi.num_params():,} params f32 on cuda, built in "
        f"{time.perf_counter() - t0:.2f} s")
    return model


def phase_sesame_full(card: str) -> dict:
    """Phase 29: Sesame CSM-1B cloning a 10-s reference segment, SESAME_FRAMES frames
    whole then streamed (the same seed: the same frames, so the streamed
    audio is held to the whole one), a warm-up first; then
    SESAME_PROFILE_FRAMES frames under the profiler."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    model = build_sesame_full()
    ref = _clone_audio(ICL_REF_SECONDS, 13)
    kw = dict(ref_audio=ref, ref_text=SESAME_REF_TEXT, temperature=0.9,
              max_audio_length_ms=SESAME_FRAMES * 80, seed=SESAME_SEED)
    list(model.generate(SESAME_TEXT, **dict(kw, max_audio_length_ms=320)))
    out = {}
    for mode in ("whole", "streamed"):
        t0 = time.perf_counter()
        res, ttfa = [], None
        for r in model.generate(SESAME_TEXT, stream=mode == "streamed",
                                streaming_interval=SESAME_INTERVAL, **kw):
            ttfa = ttfa or time.perf_counter() - t0
            res.append(r)
        wall = time.perf_counter() - t0
        audio = np.concatenate([np.asarray(r.audio) for r in res])
        codes = res[-1].prompt["codes"]
        out[mode] = dict(wall=wall, ttfa=ttfa, audio=audio, codes=codes,
                         chunks=len(res), run=dict(model.last_run))
    whole, streamed = out["whole"], out["streamed"]
    if not (whole["codes"].shape == (SESAME_FRAMES, 32)
            and np.array_equal(whole["codes"], streamed["codes"])):
        raise AssertionError(f"Sesame frames {whole['codes'].shape}, "
                             f"streamed equal "
                             f"{np.array_equal(whole['codes'], streamed['codes'])}")
    err = rel_err(streamed["audio"], whole["audio"])
    n = SESAME_FRAMES * 1920
    if not (len(whole["audio"]) == len(streamed["audio"]) == n
            and np.isfinite(whole["audio"]).all() and err <= CLONE_REL):
        raise AssertionError(f"Sesame audio: {len(whole['audio'])}, "
                             f"{len(streamed['audio'])} samples (want {n}), "
                             f"streamed vs whole rel {err:.3e}")
    # SESAME_PROFILE_FRAMES frames under the profiler, after a prefill
    tokens, mask = model.build_prompt(np.arange(10, 40))
    sampler = model._sampler(0.9, 50, 0)
    carry, _ = model.prefill(tokens, mask, sampler)
    model.chunk(carry, SESAME_PROFILE_FRAMES, sampler)
    torch.cuda.synchronize()
    kernels = _device_kernels(
        lambda: model.chunk(carry, SESAME_PROFILE_FRAMES, sampler),
        cpu=False)
    frame_ms = whole["wall"] * 1e3 / SESAME_FRAMES
    dev_us = sum(_dev_us(e) for e in kernels)
    per_frame = sum(e.count for e in kernels) / SESAME_PROFILE_FRAMES
    plen = whole["run"]["prompt_len"]
    log(f"[sesame] CSM-1B bf16 cloning a {ICL_REF_SECONDS}-s reference "
        f"({plen} prompt rows), {SESAME_FRAMES} frames: whole "
        f"{whole['wall'] * 1e3:.2f} ms ({frame_ms:.2f} ms a frame, xRT "
        f"{n / 24000 / whole['wall']:.3f}); streamed every "
        f"{SESAME_INTERVAL} s: {streamed['chunks']} chunks, first audio "
        f"{streamed['ttfa'] * 1e3:.2f} ms, wall "
        f"{streamed['wall'] * 1e3:.2f} ms, audio against whole rel "
        f"{err:.3e}; profiled chunk: {per_frame:.0f} kernels a frame, "
        f"{dev_us / 1e3 / SESAME_PROFILE_FRAMES:.2f} ms of device time a "
        f"frame ({100 * dev_us / 1e3 / frame_ms / SESAME_PROFILE_FRAMES:.1f}% "
        f"of the whole run's ms a frame); peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({card})")
    log(f"[time] phase 29 in {time.perf_counter() - t_phase:.1f} s")
    return dict(frame_ms=frame_ms, kernels=per_frame)


def phase_clone(model, card: str, recorder: K2Recorder) -> int:
    """Phases 27-29; neither K1 nor K2 may launch in 27 and 29. Returns
    phase 28's K2 launches."""
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    def counts():
        return snake_conv_kernel.launches, qmm_kernel.launches

    before = counts()
    phase_clone_reference()
    if counts() != before:
        raise AssertionError("phase 27 launched K1 or K2")
    with tempfile.TemporaryDirectory() as tmp:
        k2 = phase_qwen3_clone(model, card, recorder, Path(tmp))
    before = counts()
    phase_sesame_full(card)
    if counts() != before:
        raise AssertionError("phase 29 launched K1 or K2")
    return k2


# ---------------------------------------------------------------------------
# The NeMo ASR families: Parakeet, Canary, Nemotron ASR (phases 30-31)
# ---------------------------------------------------------------------------

# tests/test_parakeet.py's ENC and vocabulary: 2 layers at d64, subsampling
# 4, a 1-layer predictor of 32, a joint of 32
PARAKEET_SMALL = dict(
    model_type="parakeet", vocab_size=40,
    encoder=dict(feat_in=80, n_layers=2, d_model=64, n_heads=4,
                 ff_expansion_factor=2, subsampling_factor=4,
                 conv_kernel_size=9, subsampling_conv_channels=16),
    prediction=dict(pred_hidden=32, pred_rnn_layers=1),
    durations=[0, 1, 2, 3, 4],
    vocabulary=[chr(97 + i % 26) for i in range(40)])
# nvidia/parakeet-tdt-0.6b-v2: 128 mels, 24 x d1024, 8 heads, FF x4, conv
# kernel 9, dw-striding x8 with 256 channels; a 2-layer LSTM of 640; a joint
# of 640 over 1,024 tokens + blank + 5 durations (JAX's JointArgs default)
PARAKEET_FULL = dict(
    model_type="parakeet", decoding="tdt", vocab_size=1024,
    encoder=dict(feat_in=128, n_layers=24, d_model=1024, n_heads=8,
                 ff_expansion_factor=4, subsampling_factor=8,
                 conv_kernel_size=9, subsampling_conv_channels=256),
    prediction=dict(pred_hidden=640, pred_rnn_layers=2),
    joint=dict(joint_hidden=640, num_classes=1030),
    durations=[0, 1, 2, 3, 4])
# the long file: 225 s (cut from 600 to 300 to make room for phases 38-40,
# then to 225 for phases 58-61) in 120-s windows with a 15-s overlap (2
# windows); one 60-s request without windows; about 200 joint steps
# profiled
PARAKEET_SECONDS, PARAKEET_WINDOW, PARAKEET_OVERLAP = 225, 120.0, 15.0
PARAKEET_SHORT, PARAKEET_PROFILE_FRAMES = 60, 300
# the share of joint steps that emit a token, which the joints' blank bias
# aims at on random weights (about English speech's rate), found by
# bisection over decodes of a window's first frames
EMIT_SHARE, CALIBRATION_FRAMES, BLANK_BISECTIONS = 0.25, 200, 12
# tests/test_canary.py's _cfg: 1 conformer layer at d16, a 1-layer decoder
CANARY_SMALL = dict(
    model_type="canary", vocab_size=64, enc_output_dim=16,
    encoder=dict(feat_in=16, n_layers=1, d_model=16, n_heads=2,
                 conv_kernel_size=5, subsampling_conv_channels=4,
                 xscaling=True),
    transf_decoder=dict(num_layers=1, hidden_size=16, num_attention_heads=2,
                        inner_size=32, max_sequence_length=64),
    preprocessor=dict(features=16))
# nvidia/canary-1b-v2: 32 x d1024, 8 heads, FF x4, 128 mels; the decoder at
# JAX's DecoderConfig() (8 x d1024, 16 heads, inner 4096); 16,384 tokens
CANARY_FULL = dict(
    model_type="canary", vocab_size=16384, enc_output_dim=1024,
    encoder=dict(feat_in=128, n_layers=32, d_model=1024, n_heads=8,
                 ff_expansion_factor=4, subsampling_factor=8,
                 conv_kernel_size=9, subsampling_conv_channels=256),
    preprocessor=dict(features=128))
CANARY_SECONDS, CANARY_MAX_TOKENS = 30, 200
# tests/test_nemotron_asr.py's _cfg: 1 layer at d16, subsampling 4,
# chunked-limited [8, 1], a 1-layer predictor of 8, max_symbols 4
NEMOTRON_VOCAB_SMALL = (["<unk>", "<en-US>", "<de-DE>"]
                        + ["▁" + w for w in ("the", "cat", "sat", "ok.")]
                        + list("abcdefgh"))
NEMOTRON_SMALL = dict(
    model_type="nemotron_asr",
    preprocessor=dict(features=16, n_fft=256, window_size=0.016,
                      window_stride=0.01),
    encoder=dict(feat_in=16, n_layers=1, d_model=16, n_heads=2,
                 subsampling_factor=4, subsampling_conv_channels=4,
                 conv_kernel_size=5, att_context_size=[[8, 1]]),
    prompt=dict(num_prompts=4, prompt_hidden=8,
                prompt_dictionary={"auto": 0, "en-US": 1}),
    decoder=dict(pred_hidden=8, pred_rnn_layers=1, vocab_size=15),
    joint=dict(joint_hidden=8, encoder_hidden=16, pred_hidden=8,
               num_classes=15),
    vocabulary=NEMOTRON_VOCAB_SMALL, default_att_context_size=[8, 1],
    max_symbols=4)
# Nemotron ASR at JAX's ModelConfig() defaults (24 x d1024, chunked-limited
# [56, 13], a 128 -> 2,048 prompt MLP, a 2 x 640 predictor, 13,087 tokens,
# max_symbols 10), with a stand-in vocabulary of as many pieces
NEMOTRON_FULL = dict(model_type="nemotron_asr")
NEMOTRON_SECONDS, NEMOTRON_CHUNK = 60, 30.0
NEMO_REL = 1e-4


def parakeet_small(decoding: str) -> dict:
    """PARAKEET_SMALL for `decoding`: a joint with durations for TDT, none
    for RNN-T, no joint for CTC."""
    cfg = dict(PARAKEET_SMALL, decoding=decoding)
    if decoding != "ctc":
        cfg["joint"] = dict(joint_hidden=32,
                            num_classes=46 if decoding == "tdt" else 41)
    return cfg


def nemotron_pieces(vocab: int) -> list:
    """A stand-in vocabulary: <unk>, a language tag, then "▁<id>"."""
    return ["<unk>", "<en-US>"] + [f"▁{i}" for i in range(2, vocab)]


def _seeded_like(model, like):
    if like is None:
        return model.init_params(seed=0)
    model.load_state_dict(like.state_dict())
    return model


def _parakeet_small(decoding: str, device: str, like=None):
    from mlx_audio_tpu_torch.stt.models.parakeet import Model

    return _seeded_like(Model(parakeet_small(decoding), device=device), like)


def _canary_small(device: str, like=None):
    from mlx_audio_tpu_torch.stt.models.canary import CanaryTokenizer, Model

    model = _seeded_like(Model(CANARY_SMALL, device=device), like)
    model._tokenizer = CanaryTokenizer(piece_list=cohere_pieces(64))
    return model


def _nemotron_small(device: str, like=None):
    from mlx_audio_tpu_torch.stt.models.nemotron_asr import Model

    return _seeded_like(Model(NEMOTRON_SMALL, device=device), like)


def jax_layout_state(model) -> dict:
    """The model's parameters and buffers as numpy under its names (the
    JAX tree's), conv weights in the JAX tree's WIO / HWIO layouts."""
    from mlx_audio_tpu_torch.nn import Conv1d, Conv2d

    state = {k: v.float().cpu().numpy() for k, v in model.state_dict().items()}
    for name, m in model.named_modules():
        if isinstance(m, (Conv1d, Conv2d)):
            w = state[f"{name}.weight"]
            state[f"{name}.weight"] = w.transpose(
                (2, 1, 0) if w.ndim == 3 else (2, 3, 1, 0))
    return state


def _write_config(model, path: Path) -> None:
    import dataclasses

    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(
        dataclasses.asdict(model.config)))


def write_parakeet_checkpoint(model, path: Path) -> None:
    """`model` as a checkpoint directory: config.json (the native schema,
    its vocabulary included) and the JAX tree in an npz, which `sanitize`
    passes through."""
    import numpy as np

    _write_config(model, path)
    np.savez(path / "model.npz", **jax_layout_state(model))


def write_canary_checkpoint(model, path: Path) -> list:
    """`model` as a checkpoint directory: config.json, its parameters under
    the JAX tree's names in torch's layouts in an npz, and a tokens.json
    piece list. -> the pieces."""
    import numpy as np

    _write_config(model, path)
    np.savez(path / "model.npz", **{k: v.float().cpu().numpy() for k, v in
                                    model.state_dict().items()})
    pieces = cohere_pieces(model.config.vocab_size)
    (path / "tokens.json").write_text(json.dumps(pieces))
    return pieces


def write_nemotron_checkpoint(model, path: Path) -> None:
    """`model` as a converted checkpoint directory (config.json with the
    vocabulary; an npz with MLX conv layouts, (O, H, W, I) and (O, K, I),
    and the LSTMs' Wx / Wh / bias), which `sanitize` maps back."""
    import numpy as np

    _write_config(model, path)
    state = {}
    for k, v in model.state_dict().items():
        v = v.float().cpu().numpy()
        if k.endswith(".weight") and v.ndim == 4:
            v = v.transpose(0, 2, 3, 1)
        elif k.endswith(".weight") and v.ndim == 3:
            v = v.transpose(0, 2, 1)
        k = (k.replace(".weight_ih", ".Wx").replace(".weight_hh", ".Wh")
             .replace(".bias_ih", ".bias"))
        state[k] = v
    np.savez(path / "model.npz", **state)


def _noise(seed: int, seconds: float, scale: float = 0.1):
    import numpy as np

    return (np.random.RandomState(seed).randn(int(16000 * seconds))
            * scale).astype(np.float32)


def _aligned(result) -> dict:
    import dataclasses

    return dataclasses.asdict(result)


def phase_nemo_reference(tmp: Path) -> None:
    """Phase 30: the small configs at f32 from one seeded weight set, CUDA
    against the CPU: Parakeet TDT, RNN-T and CTC (encoder rows, tokens and
    frames), a long file in three windows or more (the merged result),
    Canary's greedy tokens, Nemotron's generate and stream_generate; then
    each tiny checkpoint directory through the `load_model` router on the
    card, the STT CLI on Parakeet with --chunk-duration, and one Parakeet
    transcription through `AudioServer`, each against in-process
    generate()."""
    import asyncio
    import io

    import numpy as np
    import torch

    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch import audio_io

    t0 = time.perf_counter()
    audio = _noise(0, 2.0)
    notes = []
    for decoding in ("tdt", "rnnt", "ctc"):
        cpu = _parakeet_small(decoding, "cpu")
        gpu = _parakeet_small(decoding, "cuda", like=cpu)
        want, got = cpu.encode(audio), gpu.encode(audio)
        err = rel_err(got.cpu(), want)
        if not torch.isfinite(got).all() or not err <= NEMO_REL:
            raise AssertionError(f"Parakeet {decoding} encoder CUDA vs CPU "
                                 f"{err:.3e} > {NEMO_REL}, or not finite")
        want, got = cpu._decode(audio), gpu._decode(audio)
        if got != want or not got[0]:
            raise AssertionError(f"Parakeet {decoding}: CUDA tokens/frames "
                                 f"differ from the CPU's, or none")
        notes.append(f"{decoding} {len(got[0])} tokens (rel {err:.1e})")
        if decoding == "tdt":
            kw = dict(chunk_duration=0.8, overlap_duration=0.2)
            want = cpu.transcribe_chunked(audio, **kw)
            got = gpu.transcribe_chunked(audio, **kw)
            windows = gpu.last_run["windows"]
            if _aligned(got) != _aligned(want) or windows < 3:
                raise AssertionError(f"Parakeet long file: CUDA differs "
                                     f"from the CPU, or {windows} windows")
            notes.append(f"{windows} windows merged equal")
            pk_cpu = cpu
    cpu = _canary_small("cpu")
    gpu = _canary_small("cuda", like=cpu)
    want = cpu.generate(audio, max_tokens=24)
    got = gpu.generate(audio, max_tokens=24)
    if (got.text, got.generation_tokens) != (want.text,
                                             want.generation_tokens):
        raise AssertionError("Canary: CUDA tokens differ from the CPU's")
    notes.append(f"Canary {got.generation_tokens} tokens")
    cn_cpu = cpu
    cpu = _nemotron_small("cpu")
    gpu = _nemotron_small("cuda", like=cpu)
    want, got = (m.generate(audio, chunk_duration=1.0) for m in (cpu, gpu))
    sw, sg = ([(o.text, o.segments) for o in m.stream_generate(
        audio, chunk_duration=1.0)] for m in (cpu, gpu))
    if (got.text, got.segments) != (want.text, want.segments) or sg != sw \
            or len(sg) < 3 or not got.text:
        raise AssertionError("Nemotron: CUDA generate or stream_generate "
                             "differs from the CPU's")
    notes.append(f"Nemotron {got.generation_tokens} tokens, {len(sg)} "
                 f"streamed chunks")
    nm_cpu = cpu

    # the loaders, the CLI (windows of 0.8 s, 0.2 s overlapping: three) and
    # the server (the whole file), on the card
    wav = tmp / "nemo.wav"
    audio_io.write(wav, audio, 16000)
    wav_audio, _ = audio_io.read(wav, dtype="float32")
    dirs = {"parakeet-tdt-tiny": (write_parakeet_checkpoint, pk_cpu),
            "canary-tiny": (write_canary_checkpoint, cn_cpu),
            "nemotron-tiny": (write_nemotron_checkpoint, nm_cpu)}
    for name, (write, model) in dirs.items():
        write(model, tmp / name)
        loaded = mlx_audio_tpu_torch.load_model(tmp / name)
        if loaded.device.type != "cuda" or type(loaded) is not type(model):
            raise AssertionError(f"load_model({name}) did not load its "
                                 f"family on the card")
        for k, v in model.state_dict().items():
            if not torch.equal(loaded.state_dict()[k].cpu(), v):
                raise AssertionError(f"load_model({name}): {k} differs")
    # the CLI's process would run cuDNN's convolutions in TF32 (PyTorch's
    # default); this one turned TF32 off, so the CLI's is turned off too
    ckpt, out = tmp / "parakeet-tdt-tiny", tmp / "cli-out"
    proc = subprocess.run(
        [sys.executable, "-m", "mlx_audio_tpu_torch.stt.generate", "--model",
         str(ckpt), "--audio", str(wav), "--format", "json",
         "--output-path", str(out), "--chunk-duration", "0.8",
         "--gen-kwargs", '{"overlap_duration": 0.2}'],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "NVIDIA_TF32_OVERRIDE": "0"})
    if proc.returncode != 0:
        raise AssertionError(f"STT CLI on Parakeet failed: "
                             f"{proc.stderr[-2000:]}")
    got = json.loads((out / "transcription.json").read_text())
    model = mlx_audio_tpu_torch.load_model(ckpt)
    want = model.generate(str(wav), chunk_duration=0.8, overlap_duration=0.2)
    if (got["text"], got["segments"]) != (
            want.text, json.loads(json.dumps(want.segments))) \
            or model.last_run["windows"] < 3:
        raise AssertionError("STT CLI on Parakeet differs from load_model")

    async def serve():
        from mlx_audio_tpu_torch.server import AudioServer

        server = AudioServer()
        try:
            buf = io.BytesIO()
            audio_io.write(buf, audio, 16000)
            return await server.transcribe(
                {"model": str(ckpt), "response_format": "verbose_json"},
                buf.getvalue())
        finally:
            server.close()

    reply = asyncio.run(serve())
    want = model.generate(wav_audio)
    if reply.status != 200 or (reply.json["text"], reply.json["segments"]) \
            != (want.text, json.loads(json.dumps(want.segments))) \
            or not want.segments:
        raise AssertionError(f"server transcription {reply.status}: "
                             f"{reply.json}")
    log(f"[nemo-ref] small configs f32, CUDA vs CPU on 2 s: Parakeet "
        f"{', '.join(notes[:4])}; {', '.join(notes[4:])}: equal; load_model "
        f"of the three tiny directories on the card (the same parameters); "
        f"the STT CLI with --chunk-duration 0.8 (3 windows) and an "
        f"AudioServer verbose_json transcription ({len(want.segments)} "
        f"segments) equal to generate(); phase 30 in "
        f"{time.perf_counter() - t0:.1f} s")


def _calibrate_blank(bias, blank: int, share) -> tuple:
    """Raise the joint's blank logit (`bias`, the output layer's bias
    vector, in place) until a decode emits on about EMIT_SHARE of its joint
    steps: bisection on the added bias in [0, 16], `share()` decoding a
    stretch of frames and returning its emitting share. The share is not
    smooth in the bias (an emitted token changes the prediction network's
    state), so of every bias tried the one that came nearest EMIT_SHARE is
    kept. -> (bias added, share reached)."""
    import torch

    base = bias[blank].item()
    tried = []

    def at(added: float) -> float:
        with torch.no_grad():
            bias[blank] = base + added
        tried.append((added, share()))
        return tried[-1][1]

    lo, hi = 0.0, 16.0
    at(lo)
    for _ in range(BLANK_BISECTIONS):
        mid = (lo + hi) / 2
        if at(mid) > EMIT_SHARE:
            lo = mid
        else:
            hi = mid
    best = min(tried, key=lambda p: abs(p[1] - EMIT_SHARE))
    with torch.no_grad():
        bias[blank] = base + best[0]
    return best


def _bf16_vs_f32(model, encode, what: str):
    """Cast `model` to bf16 in place; -> (f32 output, bf16 output, relative
    Frobenius error), raising past WHISPER_BF16_REL."""
    import torch

    ref = encode().float()
    model.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    got = encode().float()
    rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    if not torch.isfinite(got).all() or not rel < WHISPER_BF16_REL:
        raise AssertionError(f"{what} bf16 encoder vs f32: {rel:.3e} >= "
                             f"{WHISPER_BF16_REL}, or not finite")
    return rel


def _agreement(a: list, b: list) -> str:
    same = sum(x == y for x, y in zip(a, b))
    return f"{same}/{max(len(a), len(b))} positions equal"


def _device_kernels(fn, cpu: bool = True) -> list:
    """`fn` once under torch.profiler -> its CUDA kernels' key_averages
    rows. `cpu=False` records the CUDA activity alone: the host's op
    events of a long stretch take many seconds to gather."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]
                 + [ProfilerActivity.CPU] * cpu) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _dev_us(e) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, name):
            return float(getattr(e, name))
    return 0.0


def _profile_steps(fn, steps: int) -> tuple:
    """`fn` once unprofiled (wall) and once under torch.profiler -> (kernels
    a step, device ms a step, wall ms a step, busy share)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels = _device_kernels(fn, cpu=False)
    device = sum(_dev_us(e) for e in kernels) / 1e3 / steps
    return sum(e.count for e in kernels) / steps, device, wall, device / wall


def phase_parakeet_full(card: str) -> dict:
    """Phase 31a: Parakeet TDT 0.6B v2 (drawn on the card in f32 from seed
    0, the joint's blank biased to emit on about EMIT_SHARE of its steps,
    then cast to bf16)."""
    import torch

    from mlx_audio_tpu_torch.stt.models.parakeet import Model

    t_phase = time.perf_counter()
    model = Model(PARAKEET_FULL, device="cuda").init_params(seed=0,
                                                            on_device=True)
    window = _noise(1, PARAKEET_WINDOW)
    audio = _noise(0, PARAKEET_SECONDS)
    short = audio[:PARAKEET_SHORT * 16000]
    blank = model.config.vocab_size
    enc = model.encode(window)[:, :CALIBRATION_FRAMES]

    def share():
        tokens, _ = model.decode_tdt(enc)
        return len(tokens) / model.last_run["joint_steps"]

    bias, reached = _calibrate_blank(model.joint.out.bias, blank, share)
    tokens32 = model._decode(short)[0]
    rel = _bf16_vs_f32(model, lambda: model.encode(window), "Parakeet")
    kw = dict(chunk_duration=PARAKEET_WINDOW,
              overlap_duration=PARAKEET_OVERLAP)
    walls, outs = [], []
    for _ in range(2):
        o, wall = _sync_s(lambda: model.generate(audio, **kw))
        outs.append(o)
        walls.append(wall)
    run = dict(model.last_run)
    if outs[0].text != outs[1].text or not outs[1].text:
        raise AssertionError("Parakeet long file: the runs differ, or no text")
    enc_ms = _time_ms(lambda: model.encode(window), 5)
    mel_frames = len(window) // 160 + 1
    flops = conformer_flops(PARAKEET_FULL["encoder"], 1, mel_frames)
    log(f"[parakeet] parakeet-tdt-0.6b-v2 dims: {model.num_params() / 1e9:.3f}"
        f" B parameters, blank logit +{bias:.3f} (emitting on {reached:.3f} "
        f"of the joint steps over {CALIBRATION_FRAMES} frames, f32); bf16 "
        f"encoder vs f32 on one "
        f"{PARAKEET_WINDOW:.0f}-s window: relative Frobenius {rel:.3e} (limit "
        f"{WHISPER_BF16_REL}); {enc_ms:.3f} ms a window with its mel (CUDA "
        f"events, median of 5), {flops / 1e12:.3f} TFLOP: "
        f"{flops / enc_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * flops / PEAK_BF16 * 1e3 / enc_ms:.1f}% of 989 TFLOP/s "
        f"({card})")
    kernels = sorted(_device_kernels(lambda: model.encode(window)),
                     key=_dev_us, reverse=True)
    total = sum(_dev_us(e) for e in kernels) / 1e3
    log(f"[parakeet] profiled encoder, one window: {total:.3f} ms of device "
        f"time in {sum(e.count for e in kernels)} kernels; the largest: "
        + "; ".join(f"{e.key[:60]} x{e.count} {_dev_us(e) / 1e3:.3f} ms"
                    for e in kernels[:5]) + f" ({card})")
    for label, wall in (("cold (one bf16 window encoded before)", walls[0]),
                        ("warm", walls[1])):
        dec_s = wall - run["windows"] * enc_ms / 1e3
        log(f"[parakeet] {label}: {PARAKEET_SECONDS} s in {wall:.3f} s, xRT "
            f"{PARAKEET_SECONDS / wall:.1f}; {run['windows']} windows of "
            f"{PARAKEET_WINDOW:.0f} s ({PARAKEET_OVERLAP:.0f}-s overlap), "
            f"{run['joint_steps']} joint steps, "
            f"{outs[1].generation_tokens} tokens, {run['reads']} reads; "
            f"{dec_s * 1e3 / run['joint_steps']:.3f} ms a joint step (wall "
            f"less {run['windows']} windows' encoder at {enc_ms:.1f} ms), the "
            f"decode {100 * dec_s / wall:.1f}% of the wall ({card})")
    model.generate(short)
    out, short_wall = _sync_s(lambda: model.generate(short))
    run60 = dict(model.last_run)
    frames60 = model.encode(short).shape[1]
    tokens16 = model._decode(short)[0]
    log(f"[parakeet] one {PARAKEET_SHORT}-s request, no windows, warm: "
        f"{short_wall:.3f} s, xRT {PARAKEET_SHORT / short_wall:.1f}; "
        f"{out.generation_tokens} tokens over {frames60} frames "
        f"({out.generation_tokens / frames60:.3f} a frame), "
        f"{run60['joint_steps']} joint steps "
        f"({out.generation_tokens / run60['joint_steps']:.3f} of them emit), "
        f"{run60['reads']} reads; bf16 tokens against f32's: "
        f"{_agreement(tokens16, tokens32)} ({card})")
    with torch.inference_mode():
        enc = model.encode(window)[:, :PARAKEET_PROFILE_FRAMES]
        model.decode_tdt(enc)
        steps = model.last_run["joint_steps"]
        per, dev_ms, wall_ms, busy = _profile_steps(
            lambda: model.decode_tdt(enc), steps)
    log(f"[parakeet] profiled decode of {PARAKEET_PROFILE_FRAMES} frames, "
        f"{steps} joint steps: {per:.1f} kernels and {dev_ms:.4f} ms of "
        f"device time a step, {wall_ms:.3f} ms of wall unprofiled "
        f"({100 * busy:.1f}% busy) ({card})")
    del model
    torch.cuda.empty_cache()
    log(f"[time] phase 31 Parakeet in {time.perf_counter() - t_phase:.1f} s")
    return {"warm": walls[1], "step_ms": wall_ms, "kernels": per}


def phase_canary_full(card: str) -> dict:
    """Phase 31b: Canary-1B-v2 (drawn on the card in f32 from seed 0, the
    EOS row's bias lowered so that the 200 tokens run, then cast to bf16) on
    a 30-s clip."""
    import torch

    from mlx_audio_tpu_torch.stt.models.canary import CanaryTokenizer, Model

    t_phase = time.perf_counter()
    model = Model(CANARY_FULL, device="cuda").init_params(seed=0,
                                                          on_device=True)
    model._tokenizer = CanaryTokenizer(piece_list=cohere_pieces(
        model.config.vocab_size))
    with torch.no_grad():
        model.decoder.output_proj.bias[model._tokenizer.eos_id] -= 1e4
    clip = _noise(2, CANARY_SECONDS)
    t0 = time.perf_counter()
    mel = model._log_mel(clip)
    mel_s = time.perf_counter() - t0
    kw = dict(max_tokens=CANARY_MAX_TOKENS, language="en")
    out32 = model.generate(clip, **kw)
    rel = _bf16_vs_f32(model, lambda: model.encode(mel)[0], "Canary")
    enc_ms = _time_ms(lambda: model.encode(mel), 5)
    model.generate(clip, **kw)
    out, wall = _sync_s(lambda: model.generate(clip, **kw))
    steps = model.last_run["decode_steps"]
    if out.generation_tokens != CANARY_MAX_TOKENS:
        raise AssertionError(f"Canary: {out.generation_tokens} tokens, "
                             f"wanted {CANARY_MAX_TOKENS}")
    log(f"[canary] canary-1b-v2 dims: {model.num_params() / 1e9:.3f} B "
        f"parameters; bf16 encoder vs f32 on {CANARY_SECONDS} s (the "
        f"{model.last_run['mel_bucket']}-frame bucket): relative Frobenius "
        f"{rel:.3e}; encoder {enc_ms:.3f} ms; warm request {wall:.3f} s, xRT "
        f"{CANARY_SECONDS / wall:.1f}: {steps} decode steps, "
        f"{(wall - mel_s - enc_ms / 1e3) * 1e3 / steps:.3f} ms a step (wall "
        f"less the host mel's {mel_s * 1e3:.1f} ms and the encoder's); bf16 "
        f"tokens against f32's: {_agreement(out.text.split(), out32.text.split())} "
        f"({card})")
    del model
    torch.cuda.empty_cache()
    log(f"[time] phase 31 Canary in {time.perf_counter() - t_phase:.1f} s")
    return {"wall": wall, "step_ms": (wall - mel_s - enc_ms / 1e3) * 1e3
            / steps}


def phase_nemotron_full(card: str) -> dict:
    """Phase 31c: Nemotron ASR at `ModelConfig()` (drawn on the card in f32
    from seed 0, the joint's blank biased to emit on about EMIT_SHARE of its
    steps, then cast to bf16): 60 s in 30-s chunks through generate and
    stream_generate."""
    import torch

    from mlx_audio_tpu_torch.stt.models.nemotron_asr import Model, ModelConfig
    from mlx_audio_tpu_torch.stt.models.nemotron_asr.nemotron_asr import (
        MEL_BUCKETS, nemo_log_mel, subsampled_length)

    t_phase = time.perf_counter()
    cfg = ModelConfig.from_dict(NEMOTRON_FULL)
    cfg.vocabulary = nemotron_pieces(cfg.decoder.vocab_size)
    model = Model(cfg, device="cuda").init_params(seed=0, on_device=True)
    audio = _noise(3, NEMOTRON_SECONDS)
    blank = model.config.decoder.vocab_size
    mel = nemo_log_mel(torch.from_numpy(audio[:int(NEMOTRON_CHUNK * 16000)])
                       .to(model.device), model.config.preprocessor)
    bucket = next(b for b in MEL_BUCKETS if mel.shape[0] <= b)
    padded = torch.zeros(1, bucket, mel.shape[1], device=model.device)
    padded[0, :mel.shape[0]] = mel
    att = tuple(model.config.default_att_context_size)

    def encode():
        return model.encode(padded, mel.shape[0], att, 0)

    feats = encode()
    frames = min(CALIBRATION_FRAMES, subsampled_length(mel.shape[0]))

    def share():
        tokens, _, _, run = model.greedy_rnnt(feats, frames,
                                              model.initial_state())
        return len(tokens) / run["joint_steps"]

    bias, reached = _calibrate_blank(model.joint.joint_net["2"].bias, blank,
                                     share)
    out32 = model.generate(audio, chunk_duration=NEMOTRON_CHUNK)
    streamed = list(model.stream_generate(audio,
                                          chunk_duration=NEMOTRON_CHUNK))
    if streamed[-1].text != out32.text or not out32.text \
            or len(streamed) != model.last_run["audio_chunks"]:
        raise AssertionError("Nemotron f32: stream_generate's last text "
                             "differs from generate's, or none")
    rel = _bf16_vs_f32(model, encode, "Nemotron")
    enc_ms = _time_ms(encode, 5)
    model.generate(audio, chunk_duration=NEMOTRON_CHUNK)
    out, wall = _sync_s(lambda: model.generate(
        audio, chunk_duration=NEMOTRON_CHUNK))
    run = dict(model.last_run)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = model.stream_generate(audio, chunk_duration=NEMOTRON_CHUNK)
    first = next(stream)
    first_s = time.perf_counter() - t0
    rest = list(stream)
    if not out.text:
        raise AssertionError("Nemotron bf16: no text")
    log(f"[nemotron] ModelConfig() dims: {model.num_params() / 1e9:.3f} B "
        f"parameters, blank logit +{bias:.3f} (emitting on {reached:.3f} of "
        f"the joint steps over {frames} frames, f32); bf16 "
        f"encoder vs f32 on one "
        f"{NEMOTRON_CHUNK:.0f}-s chunk ({bucket}-frame bucket): relative "
        f"Frobenius {rel:.3e}, "
        f"{enc_ms:.3f} ms a chunk; {NEMOTRON_SECONDS} s warm in {wall:.3f} s, "
        f"xRT {NEMOTRON_SECONDS / wall:.1f}: {run['audio_chunks']} chunks, "
        f"{run['joint_steps']} joint steps, {out.generation_tokens} tokens, "
        f"{run['reads']} reads, "
        f"{(wall - run['audio_chunks'] * enc_ms / 1e3) * 1e3 / run['joint_steps']:.3f}"
        f" ms a joint step; stream_generate's first yield after "
        f"{first_s:.3f} s, its last text equal to generate's: "
        f"{(rest or [first])[-1].text == out.text} (in f32 too, where it is "
        f"asserted); bf16 tokens against f32's: "
        f"{_agreement(out.text.split(), out32.text.split())} ({card})")
    del model
    torch.cuda.empty_cache()
    log(f"[time] phase 31 Nemotron in {time.perf_counter() - t_phase:.1f} s")
    return {"wall": wall, "first": first_s}


def phase_nemo(card: str) -> None:
    """Phases 30-31; neither K1 nor K2 may launch in them."""
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        phase_nemo_reference(Path(tmp))
    phase_parakeet_full(card)
    phase_canary_full(card)
    phase_nemotron_full(card)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("phases 30-31 launched K1 or K2")
    log(f"[time] phases 30-31 in {time.perf_counter() - t0:.1f} s; neither "
        f"K1 nor K2 launched")


# ---------------------------------------------------------------------------
# Speech-to-speech: Moshi, Mel-Band-RoFormer, DeepFilterNet (phases 32-34)
# ---------------------------------------------------------------------------

# tests/test_moshi.py's LM_CFG (its Mimi: MIMI_SMALL)
MOSHI_SMALL = dict(
    transformer=dict(d_model=32, num_heads=4, num_layers=2,
                     dim_feedforward=64, context=32),
    depformer=dict(d_model=16, num_heads=2, num_layers=1, dim_feedforward=32,
                   num_slices=4),
    text_in_vocab_size=64, text_out_vocab_size=63, audio_vocab_size=65,
    audio_codebooks=8, audio_delays=[0, 1, 1, 1] + [0, 1, 1, 1])
# the same at widths that group 64 divides (the gating hiddens named), so
# that affine q8 at group 64 takes every linear and JAX's default tree rule
# every table
MOSHI_Q8_SMALL = dict(
    MOSHI_SMALL,
    transformer=dict(d_model=64, num_heads=4, num_layers=2,
                     dim_feedforward=128, hidden=128, context=32),
    depformer=dict(d_model=64, num_heads=2, num_layers=1,
                   dim_feedforward=128, hidden=64, num_slices=4))
# tests/test_mel_roformer.py's and tests/test_deepfilternet.py's configs
MEL_SMALL = dict(dim=16, depth=1, heads=2, dim_head=8, num_bands=6,
                 ff_mult=2, mlp_expansion_factor=2, mask_estimator_depth=2,
                 n_fft=64, hop_length=16, win_length=64, sample_rate=8000,
                 chunk_size=2048, num_overlap=2)
DFN_SMALL = dict(sample_rate=16000, fft_size=96, hop_size=48, nb_erb=8,
                 nb_df=16, df_order=3, conv_ch=4, emb_hidden_dim=16,
                 emb_num_layers=2, df_hidden_dim=16, df_num_layers=2,
                 df_pathway_kernel_size_t=3, linear_groups=2,
                 enc_linear_groups=4)
# CUDA against the CPU at f32 on the small configs: summation order only
STS_REL = 1e-4
MOSHI_GREEDY_STEPS = 16
# the small Moshi's generate, CUDA against the CPU: 1,000 steps a second
# (0.5 s until phases 58-61, 0.25 s until phases 62-66)
MOSHI_SMALL_SECONDS = 0.125
# phase 33: Moshi v0.1 at full width, 2 s of input (25 steps at 12.5 Hz;
# cut from 20 s to 10 to keep the run's time, then to 6 for phases 41-44,
# to 4 for phases 45-48 and to 2 for phases 58-61)
MOSHI_SECONDS, MOSHI_PROFILE_STEPS, MOSHI_FRAME_MS = 2, 2, 80.0
MOSHI_STEPS = int(MOSHI_SECONDS * 1000 / MOSHI_FRAME_MS)
# the q8 model's first-step text logits against bf16's, relative Frobenius:
# group-64 codes of 8 bits err by about 0.2% a weight, compounded over 32
# layers of random weights
MOSHI_Q8_REL = 0.1
# phase 34: a 60-s clip through Mel-Band-RoFormer kim_vocal_2 and
# DeepFilterNet3; bf16 against f32 by relative Frobenius (the Whisper
# bound), DeepFilterNet streamed in chunks of 8 hops (80 ms)
STS_SECONDS, MEL_BF16_REL, DFN_CHUNK_HOPS = 60, 2e-2, 8


def erb_filterbank(freqs: int, bands: int, seed: int):
    """A seeded stand-in for the ERB filterbank a checkpoint carries
    (tests/test_deepfilternet.py's): |N(0, 1)| columns summing to 1, and
    its transpose as the inverse."""
    import numpy as np

    fb = np.abs(np.random.RandomState(seed).randn(freqs, bands)).astype(
        np.float32)
    return fb / fb.sum(0, keepdims=True)


def _moshi_small(device: str, like=None, cfg=None):
    """Moshi on MOSHI_SMALL (or `cfg`) from seed 0, its Mimi at MIMI_SMALL
    from seed 1."""
    from mlx_audio_tpu_torch.codec.models.mimi import Mimi
    from mlx_audio_tpu_torch.sts.models.moshi import Model, ModelConfig

    model = _seeded_like(Model(ModelConfig(lm_config=cfg or MOSHI_SMALL,
                                           mimi_num_codebooks=4),
                               device=device), like)
    model.mimi = (Mimi(MIMI_SMALL, device=device).init_params(seed=1)
                  if like is None else
                  _seeded_like(Mimi(MIMI_SMALL, device=device), like.mimi))
    return model


def _mel_small(device: str, like=None):
    from mlx_audio_tpu_torch.sts.models.mel_roformer import Model

    return _seeded_like(Model(MEL_SMALL, device=device), like)


def _dfn_small(device: str, like=None):
    import torch

    from mlx_audio_tpu_torch.sts.models.deepfilternet import Model

    model = Model(DFN_SMALL, device=device)
    if like is not None:
        return _seeded_like(model, like)
    model.init_params(seed=0)
    fb = torch.from_numpy(erb_filterbank(DFN_SMALL["fft_size"] // 2 + 1,
                                         DFN_SMALL["nb_erb"], 0))
    with torch.no_grad():
        model.erb_fb.copy_(fb)
        model.mask.erb_inv_fb.copy_(fb.T)
    return model


def write_moshi_checkpoint(model, path: Path) -> None:
    """`model`'s LM as a kyutai MLX checkpoint directory (config.json with
    the LM config; the module tree's names in an npz). No Mimi is saved:
    a loaded Moshi has none bound."""
    import dataclasses

    import numpy as np

    path.mkdir(parents=True, exist_ok=True)
    cfg = dataclasses.asdict(model.config)
    cfg["lm_config"] = dataclasses.asdict(model.lm.config)
    (path / "config.json").write_text(json.dumps(cfg))
    np.savez(path / "model.npz", **{k: v.float().cpu().numpy() for k, v in
                                    model.lm.state_dict().items()})


def write_mel_checkpoint(model, path: Path) -> None:
    """`model` as a converted checkpoint directory (the stacked-band
    layout, which `sanitize` passes through)."""
    import dataclasses

    import numpy as np

    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(
        dataclasses.asdict(model.config)))
    np.savez(path / "model.npz", **{k: v.float().cpu().numpy() for k, v in
                                    model.state_dict().items()})


def write_dfn_checkpoint(model, path: Path) -> None:
    """`model` as a torch DeepFilterNet checkpoint directory: OIHW conv
    kernels, the depthwise transposed convs as torch ConvTranspose2d
    kernels (the forward kernel flipped), each squeezed GRU's layers as
    one torch GRU's `weight_ih_l<i>`, ...; `sanitize` maps them back."""
    import re

    import numpy as np

    _write_config(model, path)
    state = {}
    for k, v in model.state_dict().items():
        v = v.float().cpu().numpy()
        if re.search(r"\.convt[12]\.0\.weight$", k):
            v = np.ascontiguousarray(np.flip(v, axis=(2, 3)))
        m = re.match(r"(.*)\.gru_layers\.(\d+)\.(weight|bias)_(ih|hh)_l0$", k)
        if m:
            k = f"{m[1]}.{m[3]}_{m[4]}_l{m[2]}"
        state[k] = v
    np.savez(path / "model.npz", **state)


def _clip_audio(seed: int, seconds: float, sr: int, channels: int = 1):
    """A seeded test clip: two tones and noise, (samples,) or (channels,
    samples), float32."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    out = []
    for c in range(channels):
        out.append(0.2 * np.sin(2 * np.pi * (220 + 110 * c) * t)
                   + 0.1 * np.sin(2 * np.pi * 1500 * t)
                   + 0.05 * rng.randn(n))
    a = np.stack(out).astype(np.float32)
    return a[0] if channels == 1 else a


class K2AsReference:
    """While active, `ops.quant.qmatmul` on CUDA tensors runs
    `qmatmul_reference` in place of K2 (the same model through the plain
    version)."""

    def __enter__(self):
        from mlx_audio_tpu_torch.ops import quant

        self.prev = quant.qmm_kernel
        quant.qmm_kernel = lambda x, w_q, s, b, bias=None: \
            quant.qmatmul_reference(x, w_q, s, b, bias)
        return self

    def __exit__(self, *exc):
        from mlx_audio_tpu_torch.ops import quant

        quant.qmm_kernel = self.prev


def _moshi_greedy(lm, steps: int, seed: int = 0):
    """`steps` greedy LmGen steps on the other stream's seeded codes ->
    (text tokens, own frames or None)."""
    import numpy as np

    from mlx_audio_tpu_torch.sts.models.moshi import LmGen

    rng = np.random.RandomState(seed)
    gen = LmGen(lm, max_steps=steps + 8, text_temp=0.0, audio_temp=0.0)
    out = []
    for _ in range(steps):
        other = rng.randint(0, lm.config.audio_vocab_size - 1,
                            (1, lm.config.other_codebooks))
        text, own = gen.step(other)
        out.append((text.tolist(), None if own is None else own.tolist()))
    return out


def moshi_first_logits(lm):
    """The first step's text logits (1, V) f32: the text start token and
    every audio stream at its padding token, on a fresh cache."""
    import torch

    c = lm.config
    caches = lm.make_caches(1, max_steps=4)
    text = torch.full((1, 1), c.text_out_vocab_size, device=lm.device)
    audio = torch.full((1, c.audio_codebooks), c.audio_padding_token,
                       device=lm.device)
    _, _, out = lm.sample_step(text, audio, caches, 0, None, 0.0, 0.0)
    return out["text_logits"].float()


def phase_sts_reference(tmp: Path, recorder: K2Recorder) -> int:
    """Phase 32: the small configs at f32 from one seeded weight set, CUDA
    against the CPU: Moshi's greedy LmGen tokens and a generate over a 0.5-s
    clip through the tiny Mimi, the q8 Moshi through K2 against the same
    model through `qmatmul_reference`, Mel-Band-RoFormer `separate`,
    DeepFilterNet offline and streamed; then each tiny checkpoint directory
    through the `load_model` router on the card, the STS CLI on
    DeepFilterNet and Mel-Band-RoFormer against in-process generate(), and
    one separation through `AudioServer` against separate(). -> K2's
    launches in the q8 Moshi's steps through K2, as its counter read
    them."""
    import asyncio
    import base64
    import io

    import numpy as np
    import torch

    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.utils import apply_quantization

    t0 = time.perf_counter()
    notes = []
    # Moshi: greedy tokens, then generate over MOSHI_SMALL_SECONDS (its
    # steps the tiny Mimi's 1-ms frames)
    cpu = _moshi_small("cpu")
    gpu = _moshi_small("cuda", like=cpu)
    want, got = (_moshi_greedy(m.lm, MOSHI_GREEDY_STEPS) for m in (cpu, gpu))
    if got != want or sum(own is not None for _, own in got) < 8:
        raise AssertionError("Moshi greedy LmGen: CUDA tokens differ from "
                             "the CPU's")
    clip = _clip_audio(0, MOSHI_SMALL_SECONDS, 24000)
    kw = dict(text_temp=0.0, audio_temp=0.0)
    want, got = cpu.generate(clip, **kw), gpu.generate(clip, **kw)
    err = rel_err(got.audio, want.audio)
    if got.prompt["text_tokens"] != want.prompt["text_tokens"] \
            or not err <= STS_REL or not np.isfinite(got.audio).all() \
            or got.token_count != int(MOSHI_SMALL_SECONDS * 1000):
        raise AssertionError(f"Moshi generate: CUDA text tokens equal "
                             f"{got.prompt['text_tokens'] == want.prompt['text_tokens']}, "
                             f"audio rel {err:.3e}, {got.token_count} steps")
    step_ms = np.median(gpu.last_run["step_ms"])
    notes.append(f"Moshi {MOSHI_GREEDY_STEPS} greedy steps and a "
                 f"{MOSHI_SMALL_SECONDS:g}-s generate ({got.token_count} "
                 f"steps, {step_ms:.2f} ms a "
                 f"step on the card, audio rel {err:.1e})")
    # q8 through K2 against the same model through the plain version
    q8 = _moshi_small("cuda", cfg=MOSHI_Q8_SMALL)
    apply_quantization(q8.lm, {"quantization": {"bits": 8, "group_size": 64}})
    qmm_kernel.launches = 0
    with recorder:
        logits_k2 = moshi_first_logits(q8.lm)
        tokens_k2 = _moshi_greedy(q8.lm, MOSHI_GREEDY_STEPS)
    k2 = qmm_kernel.launches
    with K2AsReference():
        logits_ref = moshi_first_logits(q8.lm)
        tokens_ref = _moshi_greedy(q8.lm, MOSHI_GREEDY_STEPS)
    err = rel_err(logits_k2.cpu(), logits_ref.cpu())
    per_step = moshi_k2_per_step(q8.lm)
    if tokens_k2 != tokens_ref or not err <= KERNEL_TOL["float32"] \
            or k2 != per_step * (MOSHI_GREEDY_STEPS + 1):
        raise AssertionError(f"q8 Moshi: K2 tokens equal "
                             f"{tokens_k2 == tokens_ref}, logits rel "
                             f"{err:.3e}, {k2} K2 launches (want "
                             f"{per_step * (MOSHI_GREEDY_STEPS + 1)})")
    notes.append(f"q8 Moshi through K2 vs qmatmul_reference ({k2} K2 "
                 f"launches, {per_step} a step, logits rel {err:.1e}, tokens "
                 f"equal)")
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    # Mel-Band-RoFormer over three chunks and more
    mel_cpu = _mel_small("cpu")
    mel_gpu = _mel_small("cuda", like=mel_cpu)
    stereo = _clip_audio(1, 0.6, 8000, channels=2)
    want, got = mel_cpu.separate(stereo), mel_gpu.separate(stereo)
    err = rel_err(got.vocals, want.vocals)
    if not err <= STS_REL or not np.isfinite(got.vocals).all():
        raise AssertionError(f"Mel-Band-RoFormer separate CUDA vs CPU "
                             f"{err:.3e}")
    notes.append(f"Mel-Band-RoFormer separate (rel {err:.1e})")
    # DeepFilterNet offline and streamed
    dfn_cpu = _dfn_small("cpu")
    dfn_gpu = _dfn_small("cuda", like=dfn_cpu)
    noisy = _clip_audio(2, 1.0, 16000)
    want, got = dfn_cpu.enhance_array(noisy), dfn_gpu.enhance_array(noisy)
    err = rel_err(got, want)
    hop = DFN_SMALL["hop_size"] * DFN_CHUNK_HOPS
    streams = []
    for m in (dfn_cpu, dfn_gpu):
        s = m.create_streamer(DFN_CHUNK_HOPS)
        outs = [s.process_chunk(noisy[i: i + hop])
                for i in range(0, len(noisy), hop)] + [s.flush()]
        streams.append(np.concatenate(outs)[: len(noisy)])
    n = len(noisy) - DFN_SMALL["fft_size"]
    s_err = rel_err(streams[1], streams[0])
    so_err = rel_err(streams[1][:n], got[:n])
    if not (err <= STS_REL and s_err <= STS_REL and so_err <= STS_REL):
        raise AssertionError(f"DeepFilterNet CUDA vs CPU offline {err:.3e}, "
                             f"streamed {s_err:.3e}; streamed vs offline on "
                             f"the card {so_err:.3e}")
    notes.append(f"DeepFilterNet offline (rel {err:.1e}) and streamed "
                 f"(rel {s_err:.1e}; against offline {so_err:.1e})")

    # the loaders, the CLI and the server, on the card
    dirs = {"moshi-tiny": (write_moshi_checkpoint, cpu),
            "mel-band-roformer-tiny": (write_mel_checkpoint, mel_cpu),
            "deepfilternet-tiny": (write_dfn_checkpoint, dfn_cpu)}
    for name, (write, model) in dirs.items():
        write(model, tmp / name)
        loaded = mlx_audio_tpu_torch.load_model(tmp / name)
        if loaded.device.type != "cuda" or type(loaded) is not type(model):
            raise AssertionError(f"load_model({name}) did not load its "
                                 f"family on the card")
        for k, v in model.state_dict().items():
            if not torch.equal(loaded.state_dict()[k].cpu(), v):
                raise AssertionError(f"load_model({name}): {k} differs")
    try:
        mlx_audio_tpu_torch.load_model(tmp / "moshi-tiny").generate(clip)
        raise AssertionError("a loaded Moshi without a Mimi generated")
    except ValueError as e:
        if "Bind a Mimi codec" not in str(e):
            raise
    wavs = {"deepfilternet-tiny": (noisy, 16000),
            "mel-band-roformer-tiny": (stereo.T, 8000)}
    for name, (audio, sr) in wavs.items():
        wav, out = tmp / f"{name}-in.wav", tmp / f"{name}-out.wav"
        audio_io.write(wav, audio, sr)
        proc = subprocess.run(
            [sys.executable, "-m", "mlx_audio_tpu_torch.sts.generate",
             "--model", str(tmp / name), "--audio", str(wav),
             "--output-path", str(out)],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env={**os.environ, "NVIDIA_TF32_OVERRIDE": "0"})
        if proc.returncode != 0:
            raise AssertionError(f"STS CLI on {name} failed: "
                                 f"{proc.stderr[-2000:]}")
        res = mlx_audio_tpu_torch.load_model(tmp / name).generate(str(wav))
        res = np.asarray(getattr(res, "audio", res))
        buf = io.BytesIO()
        audio_io.write(buf, res.T if res.ndim == 2 else res, sr)
        if out.read_bytes() != buf.getvalue():
            raise AssertionError(f"STS CLI on {name}: its WAV differs from "
                                 f"in-process generate()")

    async def serve():
        from mlx_audio_tpu_torch.server import AudioServer

        server = AudioServer()
        try:
            return await server.separate(
                {"model": str(tmp / "mel-band-roformer-tiny")},
                (tmp / "mel-band-roformer-tiny-in.wav").read_bytes())
        finally:
            server.close()

    reply = asyncio.run(serve())
    wav_audio, _ = audio_io.read(tmp / "mel-band-roformer-tiny-in.wav",
                                 dtype="float32")
    want = mlx_audio_tpu_torch.load_model(
        tmp / "mel-band-roformer-tiny").separate(wav_audio.T)
    if reply.status != 200:
        raise AssertionError(f"separation {reply.status}: {reply.json}")
    target, sr = audio_io.read(io.BytesIO(base64.b64decode(
        reply.json["target"])), dtype="float32")
    buf = io.BytesIO()
    audio_io.write(buf, want.vocals.T, want.sample_rate)
    want_t, _ = audio_io.read(buf, dtype="float32")
    if sr != 8000 or not np.array_equal(target, want_t):
        raise AssertionError("server separation differs from separate()")
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("phase 32's Mel-Band-RoFormer, DeepFilterNet, "
                             "loaders, CLI or server launched K1 or K2")
    log(f"[sts-ref] small configs f32, CUDA vs CPU: {'; '.join(notes)}: "
        f"equal or within {STS_REL}; load_model of the three tiny "
        f"directories on the card (the same parameters; Moshi's generate "
        f"asks for a Mimi); the STS CLI on DeepFilterNet and "
        f"Mel-Band-RoFormer writing generate()'s WAV; an AudioServer "
        f"separation equal to separate(); phase 32 in "
        f"{time.perf_counter() - t0:.1f} s")
    return k2


def moshi_k2_per_step(lm) -> int:
    """K2 launches a step the config gives for a q8 Lm, checked against
    the QuantizedLinears the model holds: each main layer's and each
    depformer layer's in_proj, out_proj and gating pair, each slice's
    linear_in and linear_out, and text_linear."""
    from mlx_audio_tpu_torch.nn import QuantizedLinear

    c = lm.config
    t, dp = c.transformer, c.depformer
    want = t.num_layers * 4 + dp.num_slices * (dp.num_layers * 4 + 2) + 1
    held = sum(isinstance(m, QuantizedLinear) for m in lm.modules())
    if held != want:
        raise AssertionError(f"q8 Moshi holds {held} quantized linears, the "
                             f"config gives {want}")
    return want


def build_moshi_full():
    """Moshi v0.1 (`config_v0_1()`, 7.7 B) drawn on the card in bf16 from
    seed 0 tensor by tensor; its Mimi at mimi_202407(8) in f32 from seed
    1."""
    import torch

    from mlx_audio_tpu_torch.codec.models.mimi import Mimi, mimi_202407
    from mlx_audio_tpu_torch.sts.models.moshi import Model, ModelConfig

    t0 = time.perf_counter()
    model = Model(ModelConfig(lm_preset="v0_1"), device="cuda",
                  dtype=torch.bfloat16).init_params(seed=0, on_device=True)
    model.mimi = Mimi(mimi_202407(8), device="cuda").init_params(
        seed=1, on_device=True)
    torch.cuda.synchronize()
    log(f"[moshi] v0.1 {model.num_params():,} params bf16 and Mimi "
        f"{model.mimi.num_params():,} params f32 on cuda, built in "
        f"{time.perf_counter() - t0:.2f} s")
    return model


def _moshi_run(model, clip, label: str, card: str, base: int) -> dict:
    """A 2-s warm-up, then `generate` over `clip` at the default
    temperatures (seed 0), then MOSHI_PROFILE_STEPS steps under the
    profiler; the busy share is their device time a step over the
    generate's mean wall a step. The peak is the device memory allocated
    above `base` bytes (what earlier phases hold). -> the numbers, and the
    LM steps run in all."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.sts.models.moshi import LmGen

    model.generate(clip[: 2 * 24000], seed=0)
    warm = model.last_run["steps"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = model.generate(clip, seed=0)
    wall = time.perf_counter() - t0
    steps = np.asarray(model.last_run["step_ms"])
    if not (res.token_count == MOSHI_STEPS and np.isfinite(res.audio).all()
            and res.samples > 0):
        raise AssertionError(f"Moshi {label}: {res.token_count} steps, "
                             f"{res.samples} samples, or not finite")
    gen = LmGen(model.lm, max_steps=MOSHI_PROFILE_STEPS + 8)
    other = np.zeros((1, model.lm.config.other_codebooks), np.int64)

    def stretch():
        for _ in range(MOSHI_PROFILE_STEPS):
            gen.step(other)

    rows = _device_kernels(stretch, cpu=False)
    kernels = sum(e.count for e in rows) / MOSHI_PROFILE_STEPS
    dev_ms = sum(_dev_us(e) for e in rows) / 1e3 / MOSHI_PROFILE_STEPS
    if not (kernels > 0 and dev_ms > 0):
        raise AssertionError(f"Moshi {label}: the profiler saw no kernel")
    t_prof = time.perf_counter() - t0 - wall
    out = dict(p50=float(np.percentile(steps, 50)),
               p95=float(np.percentile(steps, 95)), wall=wall,
               rtf=len(steps) * MOSHI_FRAME_MS / steps.sum(),
               peak=(torch.cuda.max_memory_allocated() - base) / 1e9,
               kernels=kernels, dev_ms=dev_ms, busy=dev_ms / steps.mean(),
               steps_run=warm + len(steps) + MOSHI_PROFILE_STEPS)
    log(f"[moshi] {label}: generate over {MOSHI_SECONDS} s "
        f"({len(steps)} steps): {out['p50']:.2f} ms a step p50, "
        f"{out['p95']:.2f} ms p95, {steps.mean():.2f} ms mean (the frame is "
        f"{MOSHI_FRAME_MS:.0f} ms), wall {wall:.2f} s with Mimi encode and "
        f"decode, steps' realtime factor {out['rtf']:.2f}, peak "
        f"{out['peak']:.2f} GB above the earlier phases'; profiled "
        f"{MOSHI_PROFILE_STEPS} steps: {kernels:.0f} kernels and "
        f"{dev_ms:.2f} ms of device time a step (busy {100 * out['busy']:.1f}% "
        f"of the mean step; profiled in {t_prof:.1f} s) ({card})")
    return out


def phase_moshi_full(card: str, recorder: K2Recorder) -> int:
    """Phase 33: Moshi v0.1 at full width in bf16, then the same model in
    affine q8 (group 64) through K2: each a generate over MOSHI_SECONDS of input
    and a profiled stretch; K2's launches a step against the config's
    count; the first step's text logits q8 against bf16. -> K2's launches
    over the q8 model's run (warm-up, generate and profiled stretch), as
    its counter read them."""
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.utils import (apply_quantization,
                                           unpack_prequantized)

    t_phase = time.perf_counter()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    base = torch.cuda.memory_allocated()
    model = build_moshi_full()
    clip = _clip_audio(3, MOSHI_SECONDS, 24000)
    logits_bf16 = moshi_first_logits(model.lm)
    bf16 = _moshi_run(model, clip, "bf16", card, base)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the bf16 Moshi launched K1 or K2")
    t0 = time.perf_counter()
    apply_quantization(model.lm, {"quantization": {"bits": 8,
                                                   "group_size": 64}})
    torch.cuda.empty_cache()
    per_step = moshi_k2_per_step(model.lm)
    log(f"[moshi] quantized to affine q8 (group 64) in "
        f"{time.perf_counter() - t0:.2f} s: {per_step} quantized linears, "
        f"the embedding tables dense")
    logits_q8 = moshi_first_logits(model.lm)
    err = float(torch.linalg.norm(logits_q8 - logits_bf16)
                / torch.linalg.norm(logits_bf16))
    k2_linears_alone(model.lm, card, "moshi")
    k1 = snake_conv_kernel.launches
    qmm_kernel.launches = 0
    with recorder:
        q8 = _moshi_run(model, clip, "q8 (K2)", card, base)
    k2 = qmm_kernel.launches
    if k2 != per_step * q8["steps_run"] or snake_conv_kernel.launches != k1:
        raise AssertionError(f"q8 Moshi: {k2} K2 launches in "
                             f"{q8['steps_run']} steps, want {per_step} a "
                             f"step; or K1 launched")
    if not err < MOSHI_Q8_REL:
        raise AssertionError(f"q8 Moshi first-step text logits vs bf16: "
                             f"relative {err:.3e}")
    log(f"[moshi] q8 against bf16 on this card: {q8['p50']:.2f} vs "
        f"{bf16['p50']:.2f} ms a step p50, {q8['p95']:.2f} vs "
        f"{bf16['p95']:.2f} p95, {q8['kernels']:.0f} vs "
        f"{bf16['kernels']:.0f} kernels a step, busy {100 * q8['busy']:.1f}% "
        f"vs {100 * bf16['busy']:.1f}%, peak {q8['peak']:.2f} vs "
        f"{bf16['peak']:.2f} GB; K2 launched {k2} times over "
        f"{q8['steps_run']} steps, {per_step} a step (exactly the config's); "
        f"first-step text logits q8 vs bf16 relative {err:.3e} ({card})")
    del model
    torch.cuda.empty_cache()
    log(f"[time] phase 33 in {time.perf_counter() - t_phase:.1f} s")
    return k2


def mel_chunk_flops(cfg, lay, frames: int) -> float:
    """Operations of one chunk's network as run (padded band lanes
    included; the STFT and iSTFT left out), counting a multiply-add as
    two."""
    nb, mbd, d = lay.num_bands, lay.max_bd, cfg.dim
    inner, ff, h = cfg.dim_inner, cfg.ff_dim, cfg.mlp_hidden
    n = frames * nb
    per_tf = 2 * n * d * (3 * inner + cfg.heads) + 2 * n * inner * d \
        + 4 * n * d * ff
    attn = 4 * n * inner * (frames + nb)        # time then frequency
    mask = 2 * n * (d * h + (cfg.mask_estimator_depth - 1) * h * h
                    + h * 2 * mbd)
    return 2 * n * mbd * d + cfg.depth * (2 * per_tf + attn) + mask


def phase_separation_full(card: str) -> dict:
    """Phase 34: Mel-Band-RoFormer kim_vocal_2 and DeepFilterNet3 at their
    published dims with seeded random weights, on a 60-s clip."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.sts.models.deepfilternet import (
        DeepFilterNetConfig, Model as DFN)
    from mlx_audio_tpu_torch.sts.models.mel_roformer import (
        MelRoFormerConfig, Model as Mel)

    t_phase = time.perf_counter()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    cfg = MelRoFormerConfig.kim_vocal_2()
    mel = Mel(cfg, device="cuda").init_params(seed=0, on_device=True)
    stereo = _clip_audio(4, STS_SECONDS, cfg.sample_rate, channels=2)
    chunk = stereo[None, :, : cfg.chunk_size]
    ref = mel(chunk)
    mel.astype(torch.bfloat16)
    got = mel(chunk)
    rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    if not torch.isfinite(got).all() or not rel < MEL_BF16_REL:
        raise AssertionError(f"Mel-Band-RoFormer bf16 vs f32 {rel:.3e}")
    mel.separate(stereo[:, : cfg.chunk_size])
    res, wall = _sync_s(lambda: mel.separate(stereo))
    s = stereo.shape[1]
    hop = cfg.chunk_size // cfg.num_overlap
    chunks = len(range(0, s - cfg.chunk_size + 1, hop)) \
        + ((s - cfg.chunk_size) % hop != 0)
    frames = cfg.chunk_size // cfg.hop_length + 1
    flops = mel_chunk_flops(cfg, mel.layout, frames)
    chunk_ms = wall * 1e3 / chunks
    if res.vocals.shape != stereo.shape or not np.isfinite(res.vocals).all():
        raise AssertionError("Mel-Band-RoFormer 60-s separation")
    log(f"[mel-roformer] kim_vocal_2 ({mel.num_params():,} params, "
        f"{mel.layout.num_bands} bands, widest {mel.layout.max_bd}) bf16 vs "
        f"f32 on one 8-s chunk: relative Frobenius {rel:.3e}; a "
        f"{STS_SECONDS}-s stereo clip at {cfg.sample_rate} Hz in bf16: "
        f"{chunks} chunks in {wall:.3f} s (xRT {STS_SECONDS / wall:.1f}), "
        f"{chunk_ms:.2f} ms a chunk, {flops / 1e12:.3f} TFLOP a chunk as run "
        f"= {100 * flops / (chunk_ms * 1e-3) / PEAK_BF16:.2f}% of "
        f"{PEAK_BF16 / 1e12:.0f} TFLOP/s ({card})")
    del mel, ref, got
    torch.cuda.empty_cache()

    dcfg = DeepFilterNetConfig()
    dfn = DFN(dcfg, device="cuda").init_params(seed=0, on_device=True)
    fb = torch.from_numpy(erb_filterbank(dcfg.fft_size // 2 + 1,
                                         dcfg.nb_erb, 0)).cuda()
    with torch.no_grad():
        dfn.erb_fb.copy_(fb)
        dfn.mask.erb_inv_fb.copy_(fb.T)
    noisy = _clip_audio(5, STS_SECONDS, dcfg.sample_rate)
    dfn.enhance_array(noisy[: 2 * dcfg.sample_rate])
    out, off_wall = _sync_s(lambda: dfn.enhance_array(noisy))
    if out.shape != noisy.shape or not np.isfinite(out).all():
        raise AssertionError("DeepFilterNet3 offline over 60 s")
    hop = dcfg.hop_size * DFN_CHUNK_HOPS
    streamer = dfn.create_streamer(DFN_CHUNK_HOPS)
    for i in range(0, 10 * hop, hop):
        streamer.process_chunk(noisy[i: i + hop])
    streamer.reset()
    times, outs = [], []
    for i in range(0, len(noisy), hop):
        t0 = time.perf_counter()
        outs.append(streamer.process_chunk(noisy[i: i + hop]))
        times.append((time.perf_counter() - t0) * 1e3)
    outs.append(streamer.flush())
    streamed = np.concatenate(outs)[: len(noisy)]
    n = len(noisy) - dcfg.fft_size
    s_err = rel_err(streamed[:n], out[:n])
    chunk_ms = hop / dcfg.sample_rate * 1e3
    p50, p95 = np.percentile(times, 50), np.percentile(times, 95)
    if not s_err <= STS_REL:
        raise AssertionError(f"DeepFilterNet3 streamed vs offline {s_err:.3e}")
    log(f"[deepfilternet] DeepFilterNet3 ({dfn.num_params():,} params, f32) "
        f"over {STS_SECONDS} s at {dcfg.sample_rate} Hz: offline "
        f"{off_wall:.3f} s (xRT {STS_SECONDS / off_wall:.1f}); streamed in "
        f"{DFN_CHUNK_HOPS}-hop chunks ({len(times)} of {chunk_ms:.0f} ms): "
        f"{p50:.2f} ms a chunk p50, {p95:.2f} ms p95, against offline rel "
        f"{s_err:.1e} ({card})")
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("phase 34 launched K1 or K2")
    log(f"[time] phase 34 in {time.perf_counter() - t_phase:.1f} s")
    return dict(mel_chunk_ms=chunk_ms, dfn_p50=p50)


def phase_sts(card: str, recorder: K2Recorder) -> int:
    """Phases 32-34; K2 launches only in the q8 Moshi parts of 32 and 33,
    K1 never. -> K2's launches there, as its counter read them."""
    import torch

    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    t0 = time.perf_counter()
    k1 = snake_conv_kernel.launches
    with tempfile.TemporaryDirectory() as tmp:
        k2 = phase_sts_reference(Path(tmp), recorder)
    torch.cuda.empty_cache()
    k2 += phase_moshi_full(card, recorder)
    phase_separation_full(card)
    if snake_conv_kernel.launches != k1:
        raise AssertionError("phases 32-34 launched K1")
    log(f"[time] phases 32-34 in {time.perf_counter() - t0:.1f} s; K1 not "
        f"launched, K2 only on the q8 Moshi")
    return k2


# ---------------------------------------------------------------------------
# Pre-quantized checkpoints, the convert CLI, Orpheus over SNAC (35-37)
# ---------------------------------------------------------------------------

ORPHEUS_VOCAB = 128266 + 7 * 4096
# tests/test_orpheus.py's sizes at widths group 64 divides; its tiny SNAC
ORPHEUS_SMALL = dict(model_type="llama", hidden_size=64, num_hidden_layers=2,
                     intermediate_size=128, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=16, rope_theta=10000.0,
                     vocab_size=ORPHEUS_VOCAB)
SNAC_SMALL = dict(model_type="snac", sampling_rate=24000, encoder_dim=16,
                  encoder_rates=[2, 2], decoder_dim=32, decoder_rates=[2, 2],
                  attn_window_size=None, codebook_size=4096, codebook_dim=8,
                  vq_strides=[4, 2, 1], noise=True, depthwise=True)
# Orpheus-3B at canopylabs' published config (Llama-3.2-3B dims, tied
# embeddings, the vocabulary to CODE_OFFSET + 7 x 4096 and two more)
ORPHEUS_3B = dict(model_type="llama", hidden_size=3072, num_hidden_layers=28,
                  intermediate_size=8192, num_attention_heads=24,
                  num_key_value_heads=8, head_dim=128, rms_norm_eps=1e-5,
                  rope_theta=500000.0, tie_word_embeddings=True,
                  vocab_size=156940, max_position_embeddings=131072,
                  rope_scaling={"rope_type": "llama3", "factor": 32.0,
                                "low_freq_factor": 1.0,
                                "high_freq_factor": 4.0,
                                "original_max_position_embeddings": 8192})
# hubertsiuzdak/snac_24khz's settings, in f32
SNAC_24KHZ = dict(sampling_rate=24000, encoder_dim=48,
                  encoder_rates=[2, 4, 8, 8], decoder_dim=1024,
                  decoder_rates=[8, 8, 4, 2], attn_window_size=None,
                  codebook_size=4096, codebook_dim=8, vq_strides=[4, 2, 1],
                  noise=True, depthwise=True)
ORPHEUS_REL = 1e-4                  # small configs, CUDA vs CPU, f32
ORPHEUS_TEXT = ("The quick brown fox jumps over the lazy dog while the "
                "speaker reads this sentence aloud for the first request.")
# the whole request cut from 512 tokens to 256 to make room for phases
# 38-40, then it and the streamed one from 256 to 128 for phases 41-44, and
# to 64 for phases 58-61
ORPHEUS_TOKENS, ORPHEUS_INTERVAL = 64, 1.0
# the token table's rows of the code ids and SOS scaled this many times, so
# that the tied head draws codes from random weights
ORPHEUS_CODE_SCALE = 4.0
ORPHEUS_CODE_SHARE = 0.8
# the 4-bit model's first-step logits against bf16's (random 4-bit group-64
# codes through 28 layers read 0.27 on the H100; unrelated logits read about
# 1.4, so this catches a partly wrong unpack or wrong scales)
ORPHEUS_Q4_REL = 0.5
MLX_GROUP = 64                      # mlx-community's group size


class OrpheusTok:
    """A stand-in for the Llama-3 tokenizer: one id a character below the
    special ids, the EOS of tests/test_orpheus.py::FakeTok."""

    eos_token_id = 128001

    def encode(self, text):
        return [1000 + ord(c) % 1000 for c in text]


def mlx_pack(w_q, bits: int):
    """uint8 codes (out, in) (numpy or torch) -> MLX's packed words, 32 /
    bits codes a uint32, least significant first: numpy uint32 for numpy
    codes, int32 holding the same bits for torch codes (CUDA has no uint32
    arithmetic)."""
    import numpy as np
    import torch

    per = 32 // bits
    if isinstance(w_q, np.ndarray):
        out_f, in_f = w_q.shape
        codes = w_q.reshape(out_f, in_f // per, per).astype(np.uint32)
        shifts = (np.arange(per, dtype=np.uint32) * bits)[None, None, :]
        return np.bitwise_or.reduce(codes << shifts, axis=-1)
    out_f, in_f = w_q.shape
    shifts = torch.arange(per, device=w_q.device) * bits
    words = (w_q.reshape(out_f, in_f // per, per).long() << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def fixed_noise(codec):
    """Give `codec` the same standard-normal noise on every device: stage
    s draws from a CPU generator seeded s (through SNAC's `_noise`)."""
    import torch

    def noise(generator, stage, shape):
        g = torch.Generator().manual_seed(stage)
        return torch.randn(shape, generator=g).to(codec.device)

    codec._noise = noise
    return codec


def _orpheus_small(device: str):
    from mlx_audio_tpu_torch.codec.models.snac import SNAC
    from mlx_audio_tpu_torch.tts.models.llama import Model

    model = Model(ORPHEUS_SMALL, device=device).init_params(seed=0)
    model.tokenizer = OrpheusTok()
    return model.set_codec(SNAC(SNAC_SMALL, device=device).init_params(1))


def write_lm_weights(model, path: Path, bits=None) -> None:
    """A llama token-TTS `model`'s config.json and model.safetensors under
    its names (HF llama's). With `bits`, every linear and the token table
    ship MLX-packed at `bits` (group 64) with their f32 scales and biases,
    as mlx-community's quantized repos do, and config.json says so."""
    import dataclasses

    from safetensors.numpy import save_file

    from mlx_audio_tpu_torch.ops.quant import quantize_weight

    cfg = dataclasses.asdict(model.config)
    cfg.pop("model_path", None)
    flat = {}
    for k, v in model.state_dict().items():
        v = v.float().cpu()
        if bits and k.endswith(".weight") and v.ndim == 2:
            q = quantize_weight(v, MLX_GROUP, bits)
            base = k[:-len("weight")]
            flat[base + "weight"] = mlx_pack(q["w_q"].numpy(), bits)
            flat[base + "scales"] = q["scales"].numpy()
            flat[base + "biases"] = q["biases"].numpy()
        else:
            flat[k] = v.numpy()
    if bits:
        cfg["quantization"] = {"group_size": MLX_GROUP, "bits": bits}
    path.mkdir(parents=True, exist_ok=True)
    save_file(flat, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(cfg))


def write_orpheus_checkpoint(model, path: Path, bits=None) -> None:
    """`model` as a checkpoint directory: `write_lm_weights`, and its SNAC
    in `snac/` (torch layouts, config.json with model_type "snac")."""
    import numpy as np
    from safetensors.numpy import save_file

    write_lm_weights(model, path, bits)
    (path / "snac").mkdir(exist_ok=True)
    save_file({k: np.ascontiguousarray(v.float().cpu().numpy())
               for k, v in model.codec.state_dict().items()},
              str(path / "snac" / "model.safetensors"))
    (path / "snac" / "config.json").write_text(json.dumps(SNAC_SMALL))


def _load_orpheus(path: Path, device: str):
    from mlx_audio_tpu_torch.tts.utils import load_model

    model = load_model(path, device=device)
    model.tokenizer = OrpheusTok()
    if model.codec is not None:       # a converted directory carries none
        fixed_noise(model.codec)
    return model


def _orpheus_greedy(model, n: int = 40):
    ids = model.prepare_input_ids("hello from the card", voice="tara")
    *_, toks = model._decode_tokens(ids, n, 0.0, 0.8, 0, 1.3, 0)
    (r,) = list(model.generate("hello from the card", voice="tara",
                               temperature=0.0, max_tokens=n))
    return toks, r.audio


def _prefill_logits(model):
    ids = model.prepare_input_ids("hello from the card", voice="tara")
    return model.prefill(ids, 32)[0]


def phase_orpheus_reference(tmp: Path, recorder: K2Recorder) -> int:
    """Phase 35: the small Orpheus written as MLX-packed 4- and 8-bit
    checkpoints, each loaded through `tts.utils.load_model` on the card and
    on the CPU (greedy tokens equal, audio within ORPHEUS_REL, every linear
    on K2); the convert CLI (`-q --q-bits 4` in a subprocess, then
    `--quant-predicate mixed_4_6`, `--q-mode mxfp8` and `-d` of the 4-bit
    output), each output reloaded on the card with its prefill logits held
    to the dense model's; the TTS CLI's WAV against in-process `generate`.
    -> K2's launches, as its counter read them."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.convert import convert
    from mlx_audio_tpu_torch.nn import FpQuantizedLinear, QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.tts import generate as tts_generate
    from mlx_audio_tpu_torch.tts.models.llama import orpheus
    from mlx_audio_tpu_torch.tts.utils import load_model

    t0 = time.perf_counter()
    qmm_kernel.launches = 0
    src = _orpheus_small("cpu")
    n_linears = 7 * ORPHEUS_SMALL["num_hidden_layers"] + 1    # + lm_head
    for bits in (4, 8):
        d = tmp / f"orpheus-{bits}bit"
        write_orpheus_checkpoint(src, d, bits=bits)
        cpu = _load_orpheus(d, "cpu")
        with recorder:
            card = _load_orpheus(d, "cuda")
            held = sum(isinstance(m, QuantizedLinear) for m in card.modules())
            t_card, a_card = _orpheus_greedy(card)
        t_cpu, a_cpu = _orpheus_greedy(cpu)
        rel = rel_err(a_card, a_cpu)
        if not (held == n_linears and t_card == t_cpu and len(t_card) == 40
                and a_card.shape == a_cpu.shape and rel < ORPHEUS_REL):
            raise AssertionError(
                f"packed {bits}-bit Orpheus: {held} quantized linears (want "
                f"{n_linears}), tokens equal {t_card == t_cpu}, audio "
                f"{a_card.shape} vs {a_cpu.shape} rel {rel:.3e}")
        log(f"[orpheus small] MLX-packed {bits}-bit checkpoint through "
            f"load_model: {held} linears unpacked onto K2, the token table "
            f"dense; 40 greedy tokens equal on the card and the CPU, audio "
            f"({len(a_card)} samples) rel {rel:.3e}")
    # the convert CLI on the dense checkpoint, on the card
    dense_dir = tmp / "orpheus-dense"
    write_orpheus_checkpoint(src, dense_dir)
    dense = _prefill_logits(_load_orpheus(dense_dir, "cuda"))
    q4_dir = tmp / "orpheus-q4"
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0")
    proc = subprocess.run(
        [sys.executable, "-m", "mlx_audio_tpu_torch.convert", "--hf-path",
         str(dense_dir), "--mlx-path", str(q4_dir), "-q", "--q-bits", "4",
         "--dtype", "float32"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"convert CLI failed: {proc.stderr[-2000:]}")
    outs = {"-q --q-bits 4": (q4_dir, QuantizedLinear, 1.5)}
    for label, kw, kind, tol in (
            ("-q --quant-predicate mixed_4_6",
             dict(quantize=True, quant_predicate="mixed_4_6"),
             QuantizedLinear, 1.5),
            ("-q --q-mode mxfp8", dict(quantize=True, q_mode="mxfp8"),
             FpQuantizedLinear, 0.15)):
        out = tmp / f"orpheus-{label.split()[-1]}"
        convert(str(dense_dir), str(out), dtype="float32", **kw)
        outs[label] = (out, kind, tol)
    dq_dir = convert(str(q4_dir), str(tmp / "orpheus-dq"), dtype="float32",
                     dequantize=True)
    with recorder:
        got = {}
        for label, (out, kind, tol) in outs.items():
            m = _load_orpheus(out, "cuda")
            held = sum(isinstance(x, kind) for x in m.modules())
            got[label] = _prefill_logits(m)
            diff = float((got[label] - dense).abs().mean())
            if not (held == n_linears and torch.isfinite(got[label]).all()
                    and diff < tol):
                raise AssertionError(f"convert {label}: {held} "
                                     f"{kind.__name__}, logits mean abs "
                                     f"diff {diff:.3e} (limit {tol})")
            log(f"[orpheus small] convert {label}: {held} "
                f"{kind.__name__}s, prefill logits mean |diff| against the "
                f"dense model {diff:.3e} (limit {tol:g})")
    dq = _load_orpheus(dq_dir, "cuda")
    if any(isinstance(x, QuantizedLinear) for x in dq.modules()):
        raise AssertionError("convert -d left quantized linears")
    rel = rel_err(_prefill_logits(dq), got["-q --q-bits 4"])
    if not rel < ORPHEUS_REL:
        raise AssertionError(f"convert -d: logits rel {rel:.3e} against the "
                             f"4-bit model's")
    log(f"[orpheus small] convert -d of the 4-bit output: dense again, "
        f"prefill logits rel {rel:.3e} against the 4-bit model's (K2)")
    # the TTS CLI on the packed 4-bit directory against generate(): both
    # load it through load_model (the stand-in tokenizer in place of the
    # directory's), so both SNACs draw the same seeded noise
    d4 = tmp / "orpheus-4bit"
    prev = orpheus.local_tokenizer
    orpheus.local_tokenizer = lambda path: OrpheusTok()
    try:
        with recorder:
            tts_generate.main([
                "--model", str(d4), "--text", "hello from the card",
                "--voice", "tara", "--temperature", "0", "--max_tokens",
                "40", "--seed", "0", "--output_path", str(tmp / "cli"),
                "--no-verbose"])
            model = load_model(d4, device="cuda")
            (want,) = [r.audio for r in model.generate(
                "hello from the card", voice="tara", temperature=0.0,
                max_tokens=40, seed=0, top_p=0.9, top_k=50,
                repetition_penalty=1.0)]
    finally:
        orpheus.local_tokenizer = prev
    wav, sr = audio_io.read(str(tmp / "cli" / "audio_000.wav"),
                            dtype="float32")
    err = float(np.abs(wav - np.clip(want, -1, 1)).max()) if len(
        wav) == len(want) else float("inf")
    if not (sr == 24000 and err <= 2 / 32768):
        raise AssertionError(f"TTS CLI WAV vs generate: {len(wav)} vs "
                             f"{len(want)} samples, max error {err:.3e}")
    log(f"[orpheus small] TTS CLI (--voice, the packed 4-bit directory) "
        f"wrote generate()'s audio: {len(wav)} samples, max error "
        f"{err:.2e} (16-bit WAV)")
    launches = qmm_kernel.launches
    log(f"[time] phase 35 in {time.perf_counter() - t0:.1f} s; K2 launched "
        f"{launches} times")
    return launches


def build_orpheus_full():
    """Orpheus-3B (ORPHEUS_3B) drawn on the card in f32 from seed 0 tensor
    by tensor, the token table's code and SOS rows scaled by
    ORPHEUS_CODE_SCALE (the tied head then draws codes), cast in place to
    bf16; its SNAC at SNAC_24KHZ in f32 from seed 1; the stand-in
    tokenizer."""
    import torch

    from mlx_audio_tpu_torch.codec.models.snac import SNAC
    from mlx_audio_tpu_torch.tts.models.llama import Model, orpheus

    t0 = time.perf_counter()
    model = Model(ORPHEUS_3B, device="cuda").init_params(seed=0,
                                                         on_device=True)
    with torch.no_grad():
        emb = model.model.embed_tokens.weight
        emb[orpheus.CODE_OFFSET:orpheus.CODE_OFFSET + 7 * 4096] *= \
            ORPHEUS_CODE_SCALE
        emb[orpheus.SOS] *= ORPHEUS_CODE_SCALE
    model.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    model.tokenizer = OrpheusTok()
    model.set_codec(SNAC(SNAC_24KHZ, device="cuda").init_params(
        seed=1, on_device=True))
    torch.cuda.synchronize()
    log(f"[orpheus] Orpheus-3B {model.num_params():,} params bf16 (tied "
        f"head, vocabulary {ORPHEUS_3B['vocab_size']:,}) and SNAC 24 kHz "
        f"{model.codec.num_params():,} params f32 on cuda, built in "
        f"{time.perf_counter() - t0:.2f} s")
    return model


def orpheus_token_bytes(model, cache_cols: float) -> float:
    """Bytes a decode token must read: every linear's weight (bf16, or
    4-bit codes one a byte with f32 scales and biases), the tied head's
    bf16 table, the norms, and the f32 K and V of `cache_cols` columns."""
    from mlx_audio_tpu_torch.nn import Linear, QuantizedLinear

    c = model.config
    total = 0.0
    for m in model.modules():
        if isinstance(m, Linear):
            total += m.weight.numel() * m.weight.element_size()
        elif isinstance(m, QuantizedLinear):
            total += (m.w_q.numel() + 4 * (m.scales.numel()
                                           + m.biases.numel()))
    emb = model.model.embed_tokens.weight
    total += emb.numel() * emb.element_size()
    total += (2 * c.num_hidden_layers + 1) * c.hidden_size * 2
    total += (2 * c.num_hidden_layers * cache_cols * c.num_key_value_heads
              * c.resolved_head_dim * 4)
    return total


def _orpheus_profile(model) -> tuple:
    """One 32-token chunk unprofiled, then one under torch.profiler, after
    a prefill at the lane's sampling. -> (kernels a token, device ms a
    token, wall ms a token unprofiled, busy share)."""
    import torch

    from mlx_audio_tpu_torch.ops.sampling import sample
    from mlx_audio_tpu_torch.tts.models.llama import orpheus

    ids = model.prepare_input_ids(ORPHEUS_TEXT, voice="tara")
    logits, caches, _ = model.prefill(ids, 2 * PROFILE_STEPS)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(0)
    state = {"logits": logits, "caches": caches,
             "history": torch.full((1, orpheus.REP_WINDOW), -1,
                                   dtype=torch.long, device=dev),
             "done": torch.zeros(1, dtype=torch.bool, device=dev),
             "t": len(ids)}
    stops = torch.tensor(model.stop_ids(), device=dev)

    def chunk():
        model.chunk(state, PROFILE_STEPS,
                    lambda lg: sample(lg, 0.6, top_p=0.8, generator=gen),
                    stops, 1.3).cpu()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk()
    wall = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    rows = _device_kernels(chunk, cpu=False)
    device = sum(_dev_us(e) for e in rows) / 1e3 / PROFILE_STEPS
    kernels = sum(e.count for e in rows) / PROFILE_STEPS
    if not (kernels > 0 and device > 0):
        raise AssertionError("Orpheus: the profiler saw no kernel")
    return kernels, device, wall, device / wall


def _orpheus_run(model, label: str, card: str, base: int) -> dict:
    """A 32-token warm-up; one request of ORPHEUS_TOKENS tokens streamed
    every ORPHEUS_INTERVAL s (time to first audio, wall, xRT, ms a token
    p50 and p95 over its chunks after the first, the code share); a SNAC
    decode of as many frames (ms); one profiled chunk. -> the numbers, and
    the decode steps and prefills run in all."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.tts.models.llama import orpheus

    kw = dict(voice="tara", temperature=0.6, top_p=0.8, seed=0)
    list(model.generate(ORPHEUS_TEXT, max_tokens=WARM_STEPS, **kw))
    steps, prefills = model.last_run["steps"], 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = None
    samples = 0
    finite = True
    for c in model.generate(ORPHEUS_TEXT, max_tokens=ORPHEUS_TOKENS,
                            stream=True, streaming_interval=ORPHEUS_INTERVAL,
                            **kw):
        first = first or time.perf_counter() - t0
        samples += c.samples
        finite = finite and bool(np.isfinite(c.audio).all())
    wall = s_wall = time.perf_counter() - t0
    run = dict(model.last_run)
    steps, prefills = steps + run["steps"], prefills + 1
    per_token = np.asarray(run["chunk_ms"][1:]) / orpheus.CHUNK
    share = run["code_tokens"] / max(run["tokens"], 1)
    if not (run["steps"] == ORPHEUS_TOKENS and first and samples > 0
            and finite and share >= ORPHEUS_CODE_SHARE):
        raise AssertionError(f"Orpheus {label}: {run}, {samples} samples, "
                             f"code share {share:.3f}")
    # SNAC decode of the request's frame count, seeded codes
    frames = samples // (model.codec.hop_length
                         * model.codec.config.vq_strides[0])
    rng = np.random.RandomState(0)
    layers = [rng.randint(0, 4096, (1, frames * k)) for k in (1, 2, 4)]
    model.codec.decode(layers)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model.codec.decode(layers)
    torch.cuda.synchronize()
    snac_ms = (time.perf_counter() - t1) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    kernels, dev_ms, prof_wall, busy = _orpheus_profile(model)
    steps, prefills = steps + 2 * PROFILE_STEPS, prefills + 1
    cols = run["prompt_bucket"] + ORPHEUS_TOKENS / 2
    bound = orpheus_token_bytes(model, cols) / HBM_BPS * 1e3
    audio_s = samples / model.sample_rate
    out = dict(p50=float(np.percentile(per_token, 50)),
               p95=float(np.percentile(per_token, 95)), wall=wall,
               xrt=audio_s / wall, audio_s=audio_s, share=share,
               snac_ms=snac_ms, ttfa=first, s_wall=s_wall, peak=peak,
               kernels=kernels, dev_ms=dev_ms, busy=busy, bound=bound,
               steps=steps, prefills=prefills, whole_steps=run["steps"])
    log(f"[orpheus] {label}: {ORPHEUS_TOKENS} tokens ({run['prompt_len']}-"
        f"token prompt, bucket {run['prompt_bucket']}) streamed every "
        f"{ORPHEUS_INTERVAL:g} s: first audio {first:.3f} s; "
        f"{out['p50']:.2f} ms a token p50, {out['p95']:.2f} p95 (over "
        f"{len(per_token)} chunks of {orpheus.CHUNK}), {100 * share:.1f}% of "
        f"the tokens SNAC codes, {audio_s:.2f} s of audio in {wall:.2f} s "
        f"(xRT {out['xrt']:.3f}), SNAC decode of {frames} frames "
        f"{snac_ms:.2f} ms; peak "
        f"{peak:.2f} GB above the earlier phases'; profiled chunk: "
        f"{kernels:.0f} kernels and {dev_ms:.3f} ms of device time a token "
        f"against {prof_wall:.2f} ms of wall ({100 * busy:.1f}% busy); bound "
        f"{bound:.3f} ms a token (bytes), {100 * bound / out['p50']:.1f}% of "
        f"it reached at p50 ({card})")
    return out


def pack_mlx_in_memory(model, bits: int = 4, predicate=None) -> dict:
    """`model`'s state as an mlx-community checkpoint holds it, on the
    card: every linear's and the token table's weight MLX-packed at `bits`
    (group 64) with f32 scales and biases (only those whose name passes
    `predicate(name, weight)` where one is given); the norms as they are.
    Each dense weight is dropped from the dict as it is packed."""
    from mlx_audio_tpu_torch.ops.quant import quantize_weight

    flat = dict(model.state_dict())
    for k in [k for k, v in flat.items()
              if k.endswith(".weight") and v.ndim == 2 and (
                  predicate is None or predicate(k[:-len(".weight")], v))]:
        q = quantize_weight(flat.pop(k).float(), MLX_GROUP, bits)
        base = k[:-len("weight")]
        flat[base + "weight"] = mlx_pack(q["w_q"], bits)
        flat[base + "scales"], flat[base + "biases"] = q["scales"], \
            q["biases"]
    return flat


def phase_orpheus_full(card: str, recorder: K2Recorder) -> int:
    """Phases 36-37: Orpheus-3B at published width in bf16, then its
    weights packed to MLX's 4-bit layout in memory and loaded through the
    pre-quantized path of `apply_quantization` (every linear on K2, the
    tied table dense): each a whole and a streamed request and a profiled
    chunk; K2's launches a token, read from its counter, against 28 x 7;
    the first step's logits 4-bit against bf16. -> K2's launches, as its
    counter read them."""
    import torch

    from mlx_audio_tpu_torch.nn import Embedding, QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.utils import (apply_quantization,
                                           unpack_prequantized)

    t_phase = time.perf_counter()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    base = torch.cuda.memory_allocated()
    model = build_orpheus_full()
    ids = model.prepare_input_ids(ORPHEUS_TEXT, voice="tara")
    logits_bf16 = model.prefill(ids, 32)[0]
    bf16 = _orpheus_run(model, "bf16", card, base)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the bf16 Orpheus launched K1 or K2")
    log(f"[time] phase 36 in {time.perf_counter() - t_phase:.1f} s")
    t37 = time.perf_counter()
    packed = pack_mlx_in_memory(model, 4)
    torch.cuda.empty_cache()
    config = {"quantization": {"group_size": MLX_GROUP, "bits": 4}}
    flat = unpack_prequantized(model, config, packed)
    del packed
    model.bind(flat)
    del flat
    apply_quantization(model, config, pre_quantized=True)
    torch.cuda.empty_cache()
    per_token = 7 * ORPHEUS_3B["num_hidden_layers"]
    held = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    if held != per_token or not isinstance(model.model.embed_tokens,
                                           Embedding):
        raise AssertionError(f"4-bit Orpheus holds {held} quantized linears "
                             f"(want {per_token}) or a quantized table")
    log(f"[orpheus] packed to MLX 4-bit (group {MLX_GROUP}) in memory and "
        f"loaded through apply_quantization's pre-quantized path in "
        f"{time.perf_counter() - t37:.2f} s: {held} linears on K2, the tied "
        f"table dense ({model.model.embed_tokens.weight.dtype})")
    k2_linears_alone(model, card, "orpheus")
    k1 = snake_conv_kernel.launches
    qmm_kernel.launches = 0
    with recorder:
        logits_q4 = model.prefill(ids, 32)[0]
        q4 = _orpheus_run(model, "4-bit (K2)", card, base)
    k2 = qmm_kernel.launches
    rel = float(torch.linalg.norm(logits_q4 - logits_bf16)
                / torch.linalg.norm(logits_bf16))
    top1 = int(logits_q4.argmax()) == int(logits_bf16.argmax())
    if not (torch.isfinite(logits_q4).all() and rel < ORPHEUS_Q4_REL):
        raise AssertionError(f"4-bit Orpheus first-step logits vs bf16: "
                             f"relative {rel:.3e}")
    # the comparison's prefill and the requests' steps and prefills
    want = per_token * (1 + q4["steps"] + q4["prefills"])
    if k2 != want or snake_conv_kernel.launches != k1:
        raise AssertionError(f"4-bit Orpheus: {k2} K2 launches for "
                             f"{q4['steps']} decode steps and "
                             f"{q4['prefills']} prefills, want {want} "
                             f"({per_token} each); or K1 launched")
    log(f"[orpheus] 4-bit against bf16 on this card: {q4['p50']:.2f} vs "
        f"{bf16['p50']:.2f} ms a token p50, {q4['p95']:.2f} vs "
        f"{bf16['p95']:.2f} p95, xRT {q4['xrt']:.3f} vs {bf16['xrt']:.3f}, "
        f"first audio {q4['ttfa']:.3f} vs {bf16['ttfa']:.3f} s, "
        f"{q4['kernels']:.0f} vs {bf16['kernels']:.0f} kernels and "
        f"{q4['dev_ms']:.3f} vs {bf16['dev_ms']:.3f} ms of device time a "
        f"token, busy {100 * q4['busy']:.1f}% vs {100 * bf16['busy']:.1f}%, "
        f"peak {q4['peak']:.2f} vs {bf16['peak']:.2f} GB, bound "
        f"{q4['bound']:.3f} vs {bf16['bound']:.3f} ms a token; K2 launched "
        f"{k2} times over {q4['steps']} decode steps and "
        f"{1 + q4['prefills']} prefills (the comparison's included): "
        f"{k2 // (1 + q4['steps'] + q4['prefills'])} a token, read from "
        f"its counter; first-step logits 4-bit vs bf16 relative "
        f"{rel:.3e} (limit {ORPHEUS_Q4_REL:g}), top-1 "
        f"{'equal' if top1 else 'differs'} ({card})")
    del model
    torch.cuda.empty_cache()
    log(f"[time] phase 37 in {time.perf_counter() - t37:.1f} s; phases "
        f"36-37 in {time.perf_counter() - t_phase:.1f} s")
    return k2


def phase_orpheus(card: str, recorder: K2Recorder) -> int:
    """Phases 35-37; K1 never launches. -> K2's launches there."""
    import torch

    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    t0 = time.perf_counter()
    k1 = snake_conv_kernel.launches
    with tempfile.TemporaryDirectory() as tmp:
        k2 = phase_orpheus_reference(Path(tmp), recorder)
    torch.cuda.empty_cache()
    k2 += phase_orpheus_full(card, recorder)
    if snake_conv_kernel.launches != k1:
        raise AssertionError("phases 35-37 launched K1")
    log(f"[time] phases 35-37 in {time.perf_counter() - t0:.1f} s; K1 not "
        f"launched")
    return k2


# ---------------------------------------------------------------------------
# The Qwen3 LM families (phases 38-40): Qwen3-ASR with its forced aligner
# and MegaASR, VyvoTTS over SNAC
# ---------------------------------------------------------------------------

# the special tokens the stand-in tokenizers encode, at the Qwen3 tokenizer's
# ids (the full-size models) or past a small vocabulary's characters
ASR_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>",
                "<|audio_start|>", "<|audio_end|>", "<|audio_pad|>",
                "<asr_text>", "<timestamp>")
QWEN3_SPECIAL_IDS = dict(zip(ASR_SPECIALS, (151643, 151644, 151645, 151669,
                                            151670, 151676, 151704, 151705)))
SMALL_SPECIAL_IDS = {name: 240 + i for i, name in enumerate(ASR_SPECIALS)}
# tests/test_qwen3_asr.py's shapes at widths group 64 divides, two layers
# each side, a 200-frame attention window (two windows at 4 s)
QWEN3_ASR_SMALL = dict(
    model_type="qwen3_asr", audio_token_id=245, timestamp_token_id=247,
    classify_num=64,
    audio_config=dict(num_mel_bins=64, encoder_layers=2,
                      encoder_attention_heads=4, encoder_ffn_dim=128,
                      d_model=64, downsample_hidden_size=8, output_dim=64,
                      n_window=50, n_window_infer=200),
    text_config=dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=16,
                     tie_word_embeddings=True))
# Qwen3-0.6B's text dims (28 x d1024, 16 heads, 8 KV heads, head 128, FFN
# 3,072): the forced aligner's LM (its audio tower at AudioEncoderConfig()'s
# dims with output_dim 1024, the LM's width) and VyvoTTS's, whose
# vocabulary holds its SNAC code ids past 151,679 (180,352 rows)
QWEN3_06B_TEXT = dict(vocab_size=151936, hidden_size=1024,
                      intermediate_size=3072, num_hidden_layers=28,
                      num_attention_heads=16, num_key_value_heads=8,
                      head_dim=128, tie_word_embeddings=True)
# the code ids end at 151,679 + 7 x 4,096 - 1; rows rounded up to 64
VYVO_VOCAB = 180352
VYVO_SMALL = dict(vocab_size=VYVO_VOCAB, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, tie_word_embeddings=True)
# the table's code and START_OF_SPEECH rows scaled, so that a tied head on
# random weights draws codes (phase 36's device); VyvoTTS's share of codes
VYVO_CODE_SCALE, VYVO_CODE_SHARE = 4.0, 0.8
# Qwen3-ASR at ModelConfig(): 30 s of randn * 0.1 at seed 0, greedy,
# max_tokens 64 (256 until phases 41-44 came, 128 until phases 58-61); a
# decode chunk profiled
QWEN3_ASR_SECONDS, QWEN3_ASR_TOKENS = 30, 64
ASR_REL = 1e-4                      # small configs, CUDA vs CPU, f32
# the q8 model's first-step logits against bf16's (random 8-bit group-64
# codes through 28 layers; unrelated logits read about 1.4)
ASR_Q8_REL = 0.1
ALIGN_TEXT = " ".join(["the", "aligner", "places", "every", "word", "of",
                       "this", "sentence", "in", "time"] * 6)
VYVO_TEXT = ("VyvoTTS reads this sentence aloud, one SNAC frame of seven "
             "codes at a time.")
# VyvoTTS's request 128 tokens (256 until phases 41-44 came; at 64 its
# stream every 0.5 s yields one chunk, and the phase checks several)
VYVO_TOKENS, VYVO_INTERVAL = 128, 0.5


class AsrTok:
    """A stand-in for the Qwen3 tokenizer (not in the repository): the
    special tokens of ASR_SPECIALS at `ids`, one id a character below them;
    decode writes the ids."""

    unk_token_id = None

    def __init__(self, ids: dict, n_chars: int = 200):
        self.ids, self.n_chars = ids, n_chars
        self.eos_token_id = ids["<|im_end|>"]

    def encode(self, text, add_special_tokens=False):
        out, i = [], 0
        while i < len(text):
            for name, tid in self.ids.items():
                if text.startswith(name, i):
                    out.append(tid)
                    i += len(name)
                    break
            else:
                out.append(10 + ord(text[i]) % self.n_chars)
                i += 1
        return out

    def decode(self, toks, skip_special_tokens=True):
        return " ".join(str(t) for t in toks)

    def convert_tokens_to_ids(self, s):
        return self.ids.get(s)


class VyvoTok:
    """One id a character, below the special ids."""

    def encode(self, text, **kw):
        return [10 + ord(c) % 200 for c in text]


def _asr_small(family: str, device: str):
    """The small Qwen3-ASR, aligner or MegaASR at f32 from seed 0 with the
    stand-in tokenizer."""
    import importlib

    mod = importlib.import_module(f"mlx_audio_tpu_torch.stt.models.{family}")
    m = mod.Model(mod.ModelConfig.from_dict(QWEN3_ASR_SMALL),
                  device=device).init_params(seed=0)
    m._tokenizer = AsrTok(SMALL_SPECIAL_IDS)
    return m


def _vyvo_small(device: str):
    from mlx_audio_tpu_torch.codec.models.snac import SNAC
    from mlx_audio_tpu_torch.tts.models.qwen3 import Model

    m = Model(VYVO_SMALL, device=device).init_params(seed=0)
    _scale_code_rows(m)
    m.tokenizer = VyvoTok()
    return m.set_codec(fixed_noise(SNAC(SNAC_SMALL, device=device)
                                   .init_params(1)))


def _scale_code_rows(model) -> None:
    import torch

    from mlx_audio_tpu_torch.tts.models.qwen3 import qwen3

    with torch.no_grad():
        emb = model.model.embed_tokens.weight
        emb[qwen3.AUDIO_TOKENS_START:] *= VYVO_CODE_SCALE
        emb[qwen3.START_OF_SPEECH] *= VYVO_CODE_SCALE


def write_asr_checkpoint(model, path: Path, bits=None, extras=None,
                         group_size: int = MLX_GROUP) -> None:
    """A Qwen3 LM family's `model` as an HF checkpoint directory
    (`write_llm_stt_checkpoint` under the `thinker.` names, torch conv
    layouts, every linear and the token table MLX-packed with `bits`);
    `extras` {file name: state} go to extras/ (MegaASR's router and
    LoRA)."""
    from safetensors.numpy import save_file

    write_llm_stt_checkpoint(model, path, bits, group_size,
                             prefix="thinker.")
    for name, state in (extras or {}).items():
        (path / "extras").mkdir(exist_ok=True)
        save_file(state, str(path / "extras" / name))


def write_vyvo_checkpoint(model, path: Path) -> None:
    """VyvoTTS as a checkpoint directory: config.json (model_type qwen3),
    model.safetensors under HF names, its SNAC in snac/."""
    import dataclasses

    import numpy as np
    from safetensors.numpy import save_file

    path.mkdir(parents=True, exist_ok=True)
    save_file({k: v.float().cpu().numpy() for k, v in
               model.state_dict().items()}, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(
        dataclasses.asdict(model.config)))
    (path / "snac").mkdir(exist_ok=True)
    save_file({k: np.ascontiguousarray(v.float().cpu().numpy())
               for k, v in model.codec.state_dict().items()},
              str(path / "snac" / "model.safetensors"))
    (path / "snac" / "config.json").write_text(json.dumps(SNAC_SMALL))


def write_llm_stt_checkpoint(model, path: Path, bits=None,
                             group_size: int = MLX_GROUP,
                             conv: str = "torch", prefix: str = "") -> None:
    """An STT family's `model` (Voxtral, Qwen2-Audio, GLM-ASR, Granite
    Speech, VibeVoice-ASR; the Qwen3 LM families with `prefix` "thinker.")
    as a checkpoint directory: config.json and model.safetensors under the
    JAX tree's names after `prefix`, conv weights in
    torch's (O, I, K) layout or, with conv="mlx", MLX's (O, K, I), or with
    conv="jax" the JAX tree's WIO (K, I, O); with
    `bits` each linear the family's `model_quant_predicate` passes, and
    the token table, MLX-packed at `bits` (group `group_size`, f32 scales
    and biases), and config.json says so."""
    import dataclasses

    from safetensors.numpy import save_file

    from mlx_audio_tpu_torch.ops.quant import quantize_weight

    cfg = dataclasses.asdict(model.config)
    cfg.pop("model_path", None)
    convs = {name + ".weight" for name, m in model.named_modules()
             if type(m).__name__ == "Conv1d"}
    keep = getattr(model, "model_quant_predicate", None)
    flat = {}
    for k, v in model.state_dict().items():
        v = v.float().cpu()
        base = k[:-len("weight")]
        if k in convs and conv != "torch":
            v = v.permute(0, 2, 1) if conv == "mlx" else v.permute(2, 1, 0)
        if bits and k.endswith(".weight") and v.ndim == 2 and (
                keep is None or keep(base[:-1], v)) \
                and v.shape[1] % group_size == 0:
            q = quantize_weight(v, group_size, bits)
            flat[prefix + base + "weight"] = mlx_pack(q["w_q"].numpy(), bits)
            flat[prefix + base + "scales"] = q["scales"].numpy()
            flat[prefix + base + "biases"] = q["biases"].numpy()
        else:
            flat[prefix + k] = v.contiguous().numpy()
    if bits:
        cfg["quantization"] = {"group_size": group_size, "bits": bits}
    path.mkdir(parents=True, exist_ok=True)
    save_file(flat, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(cfg))


def router_state(seed: int = 2, d: int = 64, h: int = 32, ff: int = 128,
                 max_len: int = 850) -> dict:
    """MegaASR's router in its converted layout (tests/test_mega_asr.py's),
    seeded, with random batch-norm statistics."""
    import numpy as np

    rs = np.random.RandomState(seed)

    def r(*s, scale=1.0):
        return (rs.randn(*s) * scale).astype(np.float32)

    w = {"frontend.conv.0.weight": r(h, 3, 80, scale=0.1),
         "frontend.conv.0.bias": r(h),
         "frontend.conv.4.weight": r(d, 3, h, scale=0.1),
         "frontend.conv.4.bias": r(d), "pos_encoder.pe": r(1, max_len, d,
                                                            scale=0.1)}
    pre = "transformer.layers.0"
    for name, shape in (("self_attn.in_proj_weight", (3 * d, d)),
                        ("self_attn.out_proj.weight", (d, d)),
                        ("linear1.weight", (ff, d)),
                        ("linear2.weight", (d, ff))):
        w[f"{pre}.{name}"] = r(*shape, scale=shape[1] ** -0.5)
        w[f"{pre}.{name.replace('weight', 'bias')}"] = r(shape[0],
                                                         scale=0.1)
    for name in (f"{pre}.norm1", f"{pre}.norm2", "transformer.norm"):
        w[f"{name}.weight"], w[f"{name}.bias"] = 1 + r(d, scale=0.1), r(d)
    for name, (o, i) in (("pooling.query", (1, d)), ("classifier.0", (h, d)),
                         ("classifier.3", (2, h))):
        w[f"{name}.weight"], w[f"{name}.bias"] = r(o, i, scale=i ** -0.5), \
            r(o, scale=0.1)
    for i, n in ((1, h), (5, d)):
        w[f"frontend.conv.{i}.weight"] = 1 + r(n, scale=0.1)
        w[f"frontend.conv.{i}.bias"] = r(n, scale=0.1)
        w[f"frontend.conv.{i}.running_mean"] = r(n, scale=0.1)
        w[f"frontend.conv.{i}.running_var"] = 1 + abs(r(n, scale=0.1))
    return w


def lora_state(seed: int = 4) -> dict:
    import numpy as np

    rs = np.random.RandomState(seed)
    return {"model.layers.0.self_attn.q_proj.lora_A":
            (rs.randn(4, 64) * 0.5).astype(np.float32),
            "model.layers.0.self_attn.q_proj.lora_B":
            (rs.randn(64, 4) * 0.5).astype(np.float32)}


def _asr_outputs(model, audio) -> tuple:
    """Greedy tokens of `generate` (their ids, written by the stand-in
    tokenizer's decode) and the encoder's features."""
    out = model.generate(audio, language="English", max_tokens=48)
    feats, _ = model.encode(audio)
    return out.text, feats.float().cpu()


def phase_qwen3_lm_reference(tmp: Path, recorder: K2Recorder,
                             device: str = "cuda") -> int:
    """Phase 38: the small configs, each on the card against the CPU. A
    Qwen3-ASR and a forced aligner written as MLX-packed 8-bit checkpoints
    and loaded through `stt.utils.load_model` (every linear on K2, the token
    table dense): greedy tokens equal, encoder features within ASR_REL, the
    aligner's timestamps equal; the STT CLI (`--stream`, then `--text` on
    the aligner) against in-process results; the Qwen3-ASR directory's
    transcription through `AudioServer`. A dense MegaASR directory with its
    router and LoRA in extras/: the route and the text with the adapter on
    and off equal on both devices; its routed text through the STT CLI and
    `AudioServer`, and the aligner's words through `AudioServer`. A VyvoTTS directory with its SNAC: the
    greedy codes equal and audio within ASR_REL, and the TTS CLI's WAV
    against in-process `generate`. `device` is the card's ("cpu" checks
    the phase's own logic on a machine without one). -> K2's launches."""
    import asyncio

    import numpy as np
    import torch

    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.nn import Embedding, QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.server import AudioServer
    from mlx_audio_tpu_torch.stt import generate as stt_generate
    from mlx_audio_tpu_torch.stt.models.qwen3_asr import qwen3_asr
    from mlx_audio_tpu_torch.stt.utils import load_model
    from mlx_audio_tpu_torch.tts import generate as tts_generate
    from mlx_audio_tpu_torch.tts.models.qwen3 import qwen3
    from mlx_audio_tpu_torch.tts.utils import load_model as load_tts

    t0 = time.perf_counter()
    qmm_kernel.launches = 0
    audio = _noise(21, 4.0)
    wav = tmp / "asr.wav"
    audio_io.write(wav, audio, 16000)
    prev = (qwen3_asr.local_tokenizer, qwen3.local_tokenizer)
    qwen3_asr.local_tokenizer = lambda path: AsrTok(SMALL_SPECIAL_IDS)
    qwen3.local_tokenizer = lambda path: VyvoTok()
    try:
        # Qwen3-ASR and the aligner, MLX-packed q8
        n_linears = 1 + 6 * 2 + 2 + 7 * 2
        for family in ("qwen3_asr", "qwen3_forced_aligner"):
            d = tmp / f"{family}-q8"
            write_asr_checkpoint(_asr_small(family, "cpu"), d, bits=8)
            cpu = load_model(d, device="cpu")
            with recorder:
                card = load_model(d, device=device)
                held = sum(isinstance(m, QuantizedLinear)
                           for m in card.modules())
                if family == "qwen3_asr":
                    got = _asr_outputs(card, audio)
                else:
                    got = card.generate(audio, text=ALIGN_TEXT[:60],
                                        language="English").segments
            want = (_asr_outputs(cpu, audio) if family == "qwen3_asr" else
                    cpu.generate(audio, text=ALIGN_TEXT[:60],
                                 language="English").segments)
            extra = n_linears + (family != "qwen3_asr")
            if not (held == extra and isinstance(card.model.embed_tokens,
                                                 Embedding)):
                raise AssertionError(f"packed {family}: {held} quantized "
                                     f"linears, want {extra}")
            if family == "qwen3_asr":
                rel = rel_err(got[1].numpy(), want[1].numpy())
                if not (got[0] == want[0] and rel < ASR_REL):
                    raise AssertionError(f"packed Qwen3-ASR card vs CPU: "
                                         f"text equal {got[0] == want[0]}, "
                                         f"features rel {rel:.3e}")
                log(f"[qwen3-asr small] MLX-packed 8-bit checkpoint through "
                    f"load_model: {held} linears unpacked onto K2, the token "
                    f"table dense; {len(got[0].split())} greedy tokens equal "
                    f"on the card and the CPU, encoder features "
                    f"{tuple(got[1].shape)} rel {rel:.3e}")
            else:
                if got != want or not got:
                    raise AssertionError(f"aligner card vs CPU: {got} vs "
                                         f"{want}")
                log(f"[aligner small] MLX-packed 8-bit checkpoint: {held} "
                    f"linears on K2 (the timestamp head too); {len(got)} "
                    f"words' timestamps equal on the card and the CPU")
        # the STT CLI, streamed, and the aligner's --text, on the card
        d = tmp / "qwen3_asr-q8"
        with recorder:
            model = load_model(d, device=device)
            want = "".join(r.text for r in model.stream_transcribe(
                audio, language="English", max_tokens=48))
            stt_generate.main(["--model", str(d), "--audio", str(wav),
                               "--language", "English", "--max-tokens", "48",
                               "--stream", "--no-verbose", "--output-path",
                               str(tmp / "cli")])
            got = (tmp / "cli" / "transcription.txt").read_text().strip()
            stt_generate.main(["--model", str(tmp / "qwen3_forced_aligner-"
                                               "q8"),
                               "--audio", str(wav), "--text",
                               ALIGN_TEXT[:60], "--language", "English",
                               "--format", "json", "--no-verbose",
                               "--output-path", str(tmp / "align")])
            aligned = json.loads((tmp / "align" / "transcription.json")
                                 .read_text())
            server = AudioServer(device=device)
            try:
                buf = tmp / "served.wav"
                audio_io.write(buf, audio, 16000)
                reply = asyncio.run(server.transcribe(
                    {"model": str(d), "response_format": "json",
                     "language": "English", "max_tokens": "48"},
                    buf.read_bytes()))
            finally:
                server.close()
        heard, _ = audio_io.read(str(buf), dtype="float32")
        served_want = model.generate(heard, language="English",
                                     max_tokens=48).text
        if not (got == want.strip() and aligned["segments"]
                and reply.status == 200
                and reply.json["text"] == served_want):
            raise AssertionError(f"CLI --stream {got!r} vs {want!r}; aligner "
                                 f"{aligned}; server {reply.status}")
        log(f"[qwen3-asr small] STT CLI --stream wrote the streamed text "
            f"({len(got.split())} tokens); --text on the aligner wrote "
            f"{len(aligned['segments'])} words with their times; "
            f"AudioServer's transcription route gave generate()'s text")
        # MegaASR: dense, its router and LoRA in extras/
        d = tmp / "mega_asr"
        write_asr_checkpoint(_asr_small("mega_asr", "cpu"), d, extras={
            "router.safetensors": router_state(),
            "lora.safetensors": lora_state()})
        texts = {}
        for dev in ("cpu", device):
            m = load_model(d, device=dev)
            m._tokenizer = AsrTok(SMALL_SPECIAL_IDS)
            routed = m.generate(audio, language="English", max_tokens=24)
            route = dict(m.last_route)
            flipped = {"degraded_prob": route["degraded_prob"],
                       "use_lora": not route["use_lora"]}
            m._router.route = lambda a, f=flipped: f
            other = m.generate(audio, language="English", max_tokens=24)
            texts[dev] = (route, routed.text, other.text)
        (rc, a_cpu, b_cpu), (rg, a_gpu, b_gpu) = texts["cpu"], texts[device]
        if not (rc["use_lora"] == rg["use_lora"]
                and abs(rc["degraded_prob"] - rg["degraded_prob"]) < 1e-4
                and (a_cpu, b_cpu) == (a_gpu, b_gpu) and a_cpu != b_cpu):
            raise AssertionError(f"MegaASR card vs CPU: {texts}")
        log(f"[mega-asr small] router on the card: degraded probability "
            f"{rg['degraded_prob']:.6f} (CPU {rc['degraded_prob']:.6f}), "
            f"LoRA {'on' if rg['use_lora'] else 'off'}; the text with the "
            f"adapter on and off equal on both devices, and the two differ")
        # MegaASR through the STT CLI, MegaASR and the aligner through the
        # server's transcription route, each against in-process results
        heard, _ = audio_io.read(str(wav), dtype="float32")
        want = load_model(d, device=device).generate(
            heard, language="English", max_tokens=24).text
        stt_generate.main(["--model", str(d), "--audio", str(wav),
                           "--language", "English", "--max-tokens", "24",
                           "--format", "json", "--no-verbose",
                           "--output-path", str(tmp / "mega-cli")])
        cli = json.loads((tmp / "mega-cli" / "transcription.json")
                         .read_text())["text"]
        server = AudioServer(device=device)
        try:
            served = asyncio.run(server.transcribe(
                {"model": str(d), "response_format": "json",
                 "language": "English", "max_tokens": "24"},
                wav.read_bytes()))
            served_align = asyncio.run(server.transcribe(
                {"model": str(tmp / "qwen3_forced_aligner-q8"),
                 "response_format": "verbose_json", "text": ALIGN_TEXT[:60],
                 "language": "English"}, wav.read_bytes()))
        finally:
            server.close()
        if not (cli == want == served.json.get("text")
                and served_align.json.get("segments")
                == aligned["segments"]):
            raise AssertionError(f"MegaASR CLI {cli!r}, served "
                                 f"{served.json}, in process {want!r}; "
                                 f"served aligner {served_align.json}")
        log(f"[mega-asr small] the STT CLI and AudioServer's transcription "
            f"route gave the routed in-process text; the route served the "
            f"aligner's {len(aligned['segments'])} words with the CLI's "
            f"times")
        # VyvoTTS with its SNAC, and the TTS CLI
        d = tmp / "vyvotts"
        write_vyvo_checkpoint(_vyvo_small("cpu"), d)
        kw = dict(voice="zoe", temperature=0.0, max_tokens=60, seed=0)
        res = {}
        for dev in ("cpu", device):
            m = load_tts(d, device=dev)
            fixed_noise(m.codec)
            (r,) = list(m.generate(VYVO_TEXT, **kw))
            res[dev] = (m.last_run["tokens"], m.last_run["code_tokens"],
                        r.audio)
        rel = rel_err(res[device][2], res["cpu"][2])
        if not (res[device][:2] == res["cpu"][:2]
                and len(res[device][2]) == len(res["cpu"][2]) > 0
                and rel < ASR_REL):
            raise AssertionError(f"VyvoTTS card vs CPU: tokens "
                                 f"{res[device][:2]} vs {res['cpu'][:2]}, "
                                 f"audio rel {rel:.3e}")
        tts_generate.main(["--model", str(d), "--text", VYVO_TEXT, "--voice",
                           "zoe", "--temperature", "0", "--max_tokens", "60",
                           "--seed", "0", "--output_path", str(tmp / "tts"),
                           "--device", device, "--no-verbose"])
        m = load_tts(d, device=device)
        (want,) = [r.audio for r in m.generate(
            VYVO_TEXT, voice="zoe", temperature=0.0, max_tokens=60, seed=0,
            top_p=0.9, top_k=50, repetition_penalty=1.0)]
        wav_out, sr = audio_io.read(str(tmp / "tts" / "audio_000.wav"),
                                    dtype="float32")
        err = float(np.abs(wav_out - np.clip(want, -1, 1)).max()) if len(
            wav_out) == len(want) else float("inf")
        if not (sr == 24000 and err <= 2 / 32768):
            raise AssertionError(f"VyvoTTS CLI WAV vs generate: "
                                 f"{len(wav_out)} vs {len(want)} samples, "
                                 f"max error {err:.3e}")
        log(f"[vyvotts small] load_model with its snac/: greedy codes equal "
            f"on the card and the CPU ({res[device][0]} tokens, "
            f"{res[device][1]} of them SNAC codes), audio rel "
            f"{rel:.3e}; the TTS CLI wrote generate()'s audio "
            f"({len(wav_out)} samples, max error {err:.2e})")
    finally:
        qwen3_asr.local_tokenizer, qwen3.local_tokenizer = prev
    launches = qmm_kernel.launches
    torch.cuda.empty_cache()
    log(f"[time] phase 38 in {time.perf_counter() - t0:.1f} s; K2 launched "
        f"{launches} times")
    return launches


def k2_linears_alone(model, card: str, tag: str, reps: int = 7) -> tuple:
    """Every QuantizedLinear of `model` once at M = 1 on a bf16 row: their
    K2 launches captured in one CUDA graph and replayed (device time alone,
    no host; the weights together far larger than the L2, each read once a
    round), and the byte bound of the same work (codes one a byte, f32
    scales and biases, the bf16 row in and out). -> (ms, bound ms, the
    linears). The timing's launches are left out of K2's count."""
    from functools import partial

    import torch

    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel

    g = torch.Generator(device="cuda").manual_seed(4)
    fns, nbytes = [], 0
    for m in model.modules():
        if not isinstance(m, QuantizedLinear):
            continue
        n, k = m.w_q.shape
        x = torch.randn(1, k, generator=g, device="cuda").to(torch.bfloat16)
        fns.append(partial(qmm_kernel, x, m.w_q, m.scales, m.biases, m.bias))
        nbytes += (m.w_q.numel() + 4 * (m.scales.numel() + m.biases.numel())
                   + 2 * (n + k) + (4 * n if m.bias is not None else 0))
    before = qmm_kernel.launches
    ms = _time_graph(fns, reps) * len(fns)
    qmm_kernel.launches = before
    bound = nbytes / HBM_BPS * 1e3
    log(f"[{tag}] K2 alone: the {len(fns)} quantized linears of a step at "
        f"M = 1, one CUDA graph replayed: {ms:.3f} ms, bound {bound:.3f} ms "
        f"({nbytes / 1e9:.3f} GB; {100 * bound / ms:.1f}% of it reached) "
        f"({card})")
    return ms, bound, len(fns)


def build_qwen3_asr_full():
    """Qwen3-ASR at ModelConfig() (a 24 x d1024 tower, a 28 x d2048 LM
    with 151,936 ids and a tied head) drawn on the card in f32 from seed 0
    tensor by tensor, cast in place to bf16; the stand-in tokenizer."""
    import torch

    from mlx_audio_tpu_torch.stt.models.qwen3_asr import Model, ModelConfig

    t0 = time.perf_counter()
    model = Model(ModelConfig(), device="cuda").init_params(seed=0,
                                                            on_device=True)
    model.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    model._tokenizer = AsrTok(QWEN3_SPECIAL_IDS, n_chars=1000)
    torch.cuda.synchronize()
    log(f"[qwen3-asr] ModelConfig() dims (tower 24 x d1024, LM 28 x d2048 "
        f"GQA 16/8, vocabulary 151,936, tied head): {model.num_params():,} "
        f"params bf16 on cuda, built in {time.perf_counter() - t0:.2f} s")
    return model


def asr_token_bytes(model, cache_cols: float) -> float:
    """Bytes a decode token must read: the LM's linears (bf16, or 8-bit
    codes one a byte with f32 scales and biases), the tied head's bf16
    table, the norms, and the f32 K and V of `cache_cols` columns."""
    from mlx_audio_tpu_torch.nn import Linear, QuantizedLinear

    t = model.config.text_config
    total = 0.0
    for m in model.model.modules():
        if isinstance(m, Linear):
            total += m.weight.numel() * m.weight.element_size()
        elif isinstance(m, QuantizedLinear):
            total += (m.w_q.numel() + 4 * (m.scales.numel()
                                           + m.biases.numel()))
    emb = model.model.embed_tokens.weight
    total += emb.numel() * emb.element_size()
    total += (2 * t.num_hidden_layers + 1) * t.hidden_size * 2
    total += (2 * t.num_hidden_layers * cache_cols * t.num_key_value_heads
              * t.head_dim * 4)
    return total


def _sync_ms(fn, reps: int = 3) -> float:
    """Median wall ms of `fn` between device syncs."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


# decode steps a profiled chunk of the LM decodes runs (a whole 32-step
# chunk until phases 45-48 came, 8 until phases 62-66: the profiler's
# gathering of a stretch's kernel events takes about 0.18 ms an event);
# LFM2-Audio's profile keeps the first 8 steps of its interleaved schedule
PROFILE_STEPS = 2
LFM_PROFILE_STEPS = 8
# tokens of an LM run's warm-up (a whole 32-step chunk until phases 62-66)
WARM_STEPS = 8


class Laps:
    """The seconds of a function's stages, logged as one `[laps]` line."""

    def __init__(self, tag: str):
        self.tag, self.t, self.laps = tag, time.perf_counter(), []

    def __call__(self, stage: str) -> None:
        now = time.perf_counter()
        self.laps.append(f"{stage} {now - self.t:.1f} s")
        self.t = now

    def log(self) -> None:
        log(f"[laps] {self.tag}: {', '.join(self.laps)}")


def _asr_run(model, audio, label: str, card: str, base: int) -> dict:
    """Encoder ms; prefill ms at its bucket; a generate of
    QWEN3_ASR_TOKENS tokens (ms a token p50 and p95 over its chunks after
    the first, xRT, peak memory); one profiled chunk (kernels, device ms
    and busy share a token; K2's launches in it). -> the numbers."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.stt.models.qwen3_asr.qwen3_asr import \
        prompt_bucket
    from mlx_audio_tpu_torch.stt.models.qwen3_lm import DEC_CHUNK

    laps = Laps(f"qwen3-asr {label}")
    model.generate(audio, language="English", max_tokens=WARM_STEPS)
    laps("warm-up")
    enc_ms = _sync_ms(lambda: model.encode(audio))
    feats, n_audio = model.encode(audio)
    ids = model._build_prompt(n_audio, "English", None)
    n = len(ids)
    bucket = prompt_bucket(n)
    fns = model._decode_fns(bucket, QWEN3_ASR_TOKENS, 0.0, model._eos_ids())
    embeds = model.prompt_embeds(ids, feats, bucket)
    prefill_ms = _sync_ms(lambda: fns.prefill(embeds, n))
    logits = fns.prefill(embeds, n)[0]
    laps("encoder and prefill timed")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = model.generate(audio, language="English",
                         max_tokens=QWEN3_ASR_TOKENS)
    wall = time.perf_counter() - t0
    laps("the request")
    run = dict(model.last_run)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    per_token = np.asarray(run["chunk_ms"][1:]) / DEC_CHUNK
    if not (out.generation_tokens > 0 and len(per_token)):
        raise AssertionError(f"Qwen3-ASR {label}: {run}")
    # PROFILE_STEPS steps unprofiled, then as many profiled, after a
    # prefill
    state = fns.start(embeds, n, QWEN3_ASR_TOKENS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fns.chunk(state, PROFILE_STEPS)
    chunk_wall = (time.perf_counter() - t1) * 1e3 / PROFILE_STEPS
    k2 = qmm_kernel.launches
    fwd = state["forwards"]
    rows = _device_kernels(lambda: fns.chunk(state, PROFILE_STEPS),
                           cpu=False)
    k2_token = (qmm_kernel.launches - k2) / max(state["forwards"] - fwd, 1)
    dev_ms = sum(_dev_us(e) for e in rows) / 1e3 / PROFILE_STEPS
    kernels = sum(e.count for e in rows) / PROFILE_STEPS
    laps("profiled steps")
    laps.log()
    if not (kernels > 0 and dev_ms > 0):
        raise AssertionError("Qwen3-ASR: the profiler saw no kernel")
    # a step at column t reads the t + 1 columns written so far
    cols = n + run["steps"] / 2
    bound = asr_token_bytes(model, cols) / HBM_BPS * 1e3
    t_cfg = model.config.text_config
    col_bytes = (2 * t_cfg.num_hidden_layers * t_cfg.num_key_value_heads
                 * t_cfg.head_dim * 4)
    grown = state["caches"].k.shape[2]
    res = dict(enc_ms=enc_ms, prefill_ms=prefill_ms, bucket=bucket,
               p50=float(np.percentile(per_token, 50)),
               p95=float(np.percentile(per_token, 95)), wall=wall,
               xrt=QWEN3_ASR_SECONDS / wall, peak=peak, kernels=kernels,
               dev_ms=dev_ms, busy=dev_ms / chunk_wall, bound=bound,
               k2_token=k2_token, logits=logits, steps=run["steps"],
               tokens=out.generation_tokens, n_audio=n_audio, prompt=n)
    log(f"[qwen3-asr] {label}: {QWEN3_ASR_SECONDS} s, {n_audio} audio "
        f"tokens in a {n}-token prompt (bucket {bucket}): encoder "
        f"{enc_ms:.2f} ms, prefill {prefill_ms:.2f} ms; {res['tokens']} "
        f"tokens ({run['steps']} steps): {res['p50']:.2f} ms a token p50, "
        f"{res['p95']:.2f} p95 (over {len(per_token)} chunks of "
        f"{DEC_CHUNK}), wall {wall:.2f} s, xRT {res['xrt']:.2f}, peak "
        f"{peak:.2f} GB above the earlier phases'; profiled chunk: "
        f"{kernels:.0f} kernels and {dev_ms:.3f} ms of device time a token "
        f"against {chunk_wall:.2f} ms of wall ({100 * res['busy']:.1f}% "
        f"busy), {k2_token:.0f} K2 launches a token; bound {bound:.3f} ms a "
        f"token (bytes), {100 * bound / res['p50']:.1f}% of it reached at "
        f"p50; the f32 caches read {cols:.0f} columns a token on average "
        f"({cols * col_bytes / 1e6:.1f} MB) and held {grown} columns after "
        f"the profiled chunk ({grown * col_bytes / 1e9:.3f} GB); at the default max_tokens "
        f"8,192 they may grow to {bucket + 8192} columns "
        f"({(bucket + 8192) * col_bytes / 1e9:.3f} GB) ({card})")
    return res


def phase_qwen3_asr_full(card: str, recorder: K2Recorder) -> int:
    """Phase 39: Qwen3-ASR at ModelConfig() seeded on the card in bf16,
    then its weights packed to MLX's 8-bit layout in memory and loaded
    through the pre-quantized path (every linear on K2, the tied table
    dense): each on 30 s of randn * 0.1 at seed 0 with QWEN3_ASR_TOKENS
    (`_asr_run`); the LM's linears at the prefill's bucket, K2 against
    cuBLAS bf16 (`_linear_times`) and their bound; K2's launches a token read
    from its counter against the config's 196; the first-step logits q8
    against bf16. -> K2's launches, as its counter read them."""
    import torch

    from mlx_audio_tpu_torch.nn import Embedding, QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.utils import (apply_quantization,
                                           unpack_prequantized)

    t_phase = time.perf_counter()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    base = torch.cuda.memory_allocated()
    model = build_qwen3_asr_full()
    audio = _noise(0, QWEN3_ASR_SECONDS)
    bf16 = _asr_run(model, audio, "bf16", card, base)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the bf16 Qwen3-ASR launched K1 or K2")
    t = model.config.text_config
    per_token = 7 * t.num_hidden_layers
    t1 = time.perf_counter()
    packed = pack_mlx_in_memory(model, 8)
    torch.cuda.empty_cache()
    config = {"quantization": {"group_size": MLX_GROUP, "bits": 8}}
    flat = unpack_prequantized(model, config, packed)
    del packed
    model.bind(flat)
    del flat
    apply_quantization(model, config, pre_quantized=True)
    torch.cuda.empty_cache()
    lm_held = sum(isinstance(m, QuantizedLinear)
                  for m in model.model.modules())
    held = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    if lm_held != per_token or not isinstance(model.model.embed_tokens,
                                              Embedding):
        raise AssertionError(f"q8 Qwen3-ASR's LM holds {lm_held} quantized "
                             f"linears (want {per_token}) or a quantized "
                             f"table")
    log(f"[qwen3-asr] packed to MLX 8-bit (group {MLX_GROUP}) in memory and "
        f"loaded through the pre-quantized path in "
        f"{time.perf_counter() - t1:.2f} s: {held} linears on K2 ({lm_held} "
        f"in the LM, the rest the tower's), the tied table dense")
    k1 = snake_conv_kernel.launches
    qmm_kernel.launches = 0
    with recorder:
        q8 = _asr_run(model, audio, "q8 (K2)", card, base)
    k2 = qmm_kernel.launches
    if q8["k2_token"] != per_token or snake_conv_kernel.launches != k1:
        raise AssertionError(f"q8 Qwen3-ASR: {q8['k2_token']} K2 launches a "
                             f"token, want {per_token}; or K1 launched")
    rel = float(torch.linalg.norm(q8["logits"] - bf16["logits"])
                / torch.linalg.norm(bf16["logits"]))
    top1 = int(q8["logits"].argmax()) == int(bf16["logits"].argmax())
    if not (torch.isfinite(q8["logits"]).all() and rel < ASR_Q8_REL):
        raise AssertionError(f"q8 Qwen3-ASR first-step logits vs bf16: "
                             f"relative {rel:.3e}")
    alone, bound, n = k2_linears_alone(model.model, card, "qwen3-asr")
    shapes = ((2048, 2048), (1024, 2048), (6144, 2048), (2048, 6144))
    sums = _linear_times(card, "qwen3-asr", shapes, (2, 2, 2, 1),
                         t.num_hidden_layers, rows=(q8["bucket"],))
    pre = sums[q8["bucket"]]
    pre_bound, by = linears_bound(shapes, (2, 2, 2, 1),
                                  t.num_hidden_layers, q8["bucket"])
    log(f"[qwen3-asr] the prefill's {per_token} LM linears at M = "
        f"{q8['bucket']}: K2 (mma) {pre['K2']:.3f} ms against cuBLAS bf16 "
        f"{pre['bf16']:.3f} ms ({pre['K2'] / pre['bf16']:.2f}x); bound "
        f"{pre_bound:.3f} ms ({by}), {100 * pre_bound / pre['K2']:.1f}% of "
        f"it reached by K2, {100 * pre_bound / pre['bf16']:.1f}% by cuBLAS "
        f"({card})")
    log(f"[qwen3-asr] q8 against bf16 on this card: encoder "
        f"{q8['enc_ms']:.2f} vs {bf16['enc_ms']:.2f} ms, prefill "
        f"{q8['prefill_ms']:.2f} vs {bf16['prefill_ms']:.2f} ms, "
        f"{q8['p50']:.2f} vs {bf16['p50']:.2f} ms a token p50, "
        f"{q8['p95']:.2f} vs {bf16['p95']:.2f} p95, xRT {q8['xrt']:.2f} vs "
        f"{bf16['xrt']:.2f}, {q8['kernels']:.0f} vs {bf16['kernels']:.0f} "
        f"kernels and {q8['dev_ms']:.3f} vs {bf16['dev_ms']:.3f} ms of device "
        f"time a token, busy {100 * q8['busy']:.1f}% vs "
        f"{100 * bf16['busy']:.1f}%, peak {q8['peak']:.2f} vs "
        f"{bf16['peak']:.2f} GB, bound {q8['bound']:.3f} vs "
        f"{bf16['bound']:.3f} ms a token; K2 launched {k2} times, "
        f"{q8['k2_token']:.0f} a decode token (read from its counter; the "
        f"config gives {per_token}), the LM's {n} linears alone "
        f"{alone:.3f} ms a token (bound {bound:.3f} ms); first-step logits "
        f"q8 vs bf16 relative {rel:.3e} (limit {ASR_Q8_REL:g}), top-1 "
        f"{'equal' if top1 else 'differs'} ({card})")
    del model
    torch.cuda.empty_cache()
    log(f"[time] phase 39 in {time.perf_counter() - t_phase:.1f} s")
    return k2


def phase_aligner_vyvo_full(card: str) -> None:
    """Phase 40, in bf16 from seeds on the card at Qwen3-0.6B's text dims:
    the forced aligner (its tower at AudioEncoderConfig() with output_dim
    1024) on 30 s with 60 words, cold then warm (ms); VyvoTTS (vocabulary
    180,352, the code rows scaled, SNAC 24 kHz in f32) on a request of
    VYVO_TOKENS tokens streamed every VYVO_INTERVAL s (time to first audio,
    ms a token p50 and p95, code share, xRT). Neither K1 nor
    K2 launches."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.codec.models.snac import SNAC
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.stt.models.qwen3_forced_aligner import (
        Model as Aligner, ModelConfig as AlignerConfig)
    from mlx_audio_tpu_torch.stt.models.qwen3_lm import DEC_CHUNK
    from mlx_audio_tpu_torch.tts.models.qwen3 import Model as Vyvo

    t_phase = time.perf_counter()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    cfg = AlignerConfig.from_dict({"audio_config": {"output_dim": 1024},
                                   "text_config": QWEN3_06B_TEXT})
    al = Aligner(cfg, device="cuda").init_params(seed=0, on_device=True)
    al.astype(torch.bfloat16)
    al._tokenizer = AsrTok(QWEN3_SPECIAL_IDS, n_chars=1000)
    audio = _noise(1, QWEN3_ASR_SECONDS)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = al.generate(audio, text=ALIGN_TEXT, language="English")
        walls.append(time.perf_counter() - t0)
    times = [(it.start_time, it.end_time) for it in res]
    if not (len(res) == 60 and all(0 <= a <= b for a, b in times)):
        raise AssertionError(f"aligner: {len(res)} words, {times[:4]}")
    log(f"[aligner] Qwen3-0.6B text dims (28 x d1024, 16 heads, 8 KV, head "
        f"128, FFN 3,072) with the default tower: {al.num_params():,} params "
        f"bf16; one alignment of {QWEN3_ASR_SECONDS} s and 60 words: cold "
        f"{walls[0] * 1e3:.1f} ms, warm {walls[1] * 1e3:.1f} ms; the last "
        f"word {times[-1][0]:.2f}-{times[-1][1]:.2f} s ({card})")
    del al
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    vy = Vyvo(dict(QWEN3_06B_TEXT, vocab_size=VYVO_VOCAB),
              device="cuda").init_params(seed=0, on_device=True)
    _scale_code_rows(vy)
    vy.astype(torch.bfloat16)
    vy.tokenizer = VyvoTok()
    vy.set_codec(SNAC(SNAC_24KHZ, device="cuda").init_params(
        seed=1, on_device=True))
    kw = dict(voice="zoe", temperature=0.6, top_p=0.8, seed=0)
    list(vy.generate(VYVO_TEXT, max_tokens=DEC_CHUNK, **kw))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first, samples, chunks, finite = None, 0, 0, True
    for c in vy.generate(VYVO_TEXT, max_tokens=VYVO_TOKENS, stream=True,
                         streaming_interval=VYVO_INTERVAL, **kw):
        first = first or time.perf_counter() - t0
        samples += c.samples
        chunks += 1
        finite = finite and bool(np.isfinite(c.audio).all())
    wall = s_wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    run = dict(vy.last_run)
    per_token = np.asarray(run["chunk_ms"][1:]) / DEC_CHUNK
    share = run["code_tokens"] / max(run["tokens"], 1)
    if not (first and samples > 0 and chunks > 1 and finite
            and share >= VYVO_CODE_SHARE):
        raise AssertionError(f"VyvoTTS stream: {chunks} chunks, {samples} "
                             f"samples, {run}, code share {share:.3f}")
    audio_s = samples / vy.sample_rate
    log(f"[vyvotts] Qwen3-0.6B text dims, vocabulary {VYVO_VOCAB:,}: "
        f"{vy.num_params():,} params bf16, SNAC 24 kHz f32; {VYVO_TOKENS} "
        f"tokens ({run['prompt_len']}-token prompt, bucket "
        f"{run['prompt_bucket']}): {np.percentile(per_token, 50):.2f} ms a "
        f"token p50, {np.percentile(per_token, 95):.2f} p95 (over "
        f"{len(per_token)} chunks of {DEC_CHUNK}), {100 * share:.1f}% of the "
        f"tokens SNAC codes, {audio_s:.2f} s of audio in {wall:.2f} s (xRT "
        f"{audio_s / wall:.3f}); streamed every {VYVO_INTERVAL:g} s: "
        f"{chunks} chunks, first audio {first:.3f} s, wall {s_wall:.2f} s; "
        f"peak {peak:.2f} GB ({card})")
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("phase 40 launched K1 or K2")
    del vy
    torch.cuda.empty_cache()
    log(f"[time] phase 40 in {time.perf_counter() - t_phase:.1f} s "
        f"(VyvoTTS {time.perf_counter() - t1:.1f} s)")


def phase_qwen3_lm(card: str, recorder: K2Recorder) -> int:
    """Phases 38-40; K1 never launches, K2 only on the q8 models. -> K2's
    launches there."""
    import torch

    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    t0 = time.perf_counter()
    k1 = snake_conv_kernel.launches
    with tempfile.TemporaryDirectory() as tmp:
        k2 = phase_qwen3_lm_reference(Path(tmp), recorder)
    torch.cuda.empty_cache()
    k2 += phase_qwen3_asr_full(card, recorder)
    phase_aligner_vyvo_full(card)
    if snake_conv_kernel.launches != k1:
        raise AssertionError("phases 38-40 launched K1")
    log(f"[time] phases 38-40 in {time.perf_counter() - t0:.1f} s; K1 not "
        f"launched")
    return k2


# ---------------------------------------------------------------------------
# The LLM-decoder STT families (phases 41-44)
# ---------------------------------------------------------------------------

# Voxtral-Mini-3B-2507 at the dims of mistralai/Voxtral-Mini-3B-2507's
# config.json: a 32 x d1280 Whisper-style tower (20 heads, FFN 5,120, 128
# mels, 1,500 positions), the 5,120 -> 3,072 -> 3,072 projector, a 30 x
# d3072 Mistral LM (32 heads, 8 KV heads, head 128, FFN 8,192, 131,072 ids,
# rope_theta 1e8, an untied head); 4.68 B parameters
VOXTRAL_MINI_3B = dict(
    model_type="voxtral", audio_token_id=24,
    audio_config=dict(d_model=1280, encoder_layers=32,
                      encoder_attention_heads=20, encoder_ffn_dim=5120,
                      num_mel_bins=128, max_source_positions=1500,
                      intermediate_size=5120),
    text_config=dict(hidden_size=3072, num_hidden_layers=30,
                     intermediate_size=8192, num_attention_heads=32,
                     num_key_value_heads=8, head_dim=128, vocab_size=131072,
                     rope_theta=1e8, rms_norm_eps=1e-5,
                     tie_word_embeddings=False))
# Qwen2-Audio-7B-Instruct at the dims of Qwen/Qwen2-Audio-7B-Instruct's
# config.json: Voxtral's tower (fixed sinusoidal positions, a 2x pool), a
# 1,280 -> 4,096 projector, a 32 x d4096 Qwen2 LM (32 heads and 32 KV
# heads, FFN 11,008, 156,032 ids, q/k/v biases, rope_theta 1e4, an untied
# head); 8.40 B parameters
QWEN2_AUDIO_7B = dict(
    model_type="qwen2_audio", audio_token_id=151646,
    audio_bos_token_id=151647, audio_eos_token_id=151648,
    audio_config=dict(d_model=1280, encoder_layers=32,
                      encoder_attention_heads=20, encoder_ffn_dim=5120,
                      num_mel_bins=128, max_source_positions=1500),
    text_config=dict(hidden_size=4096, num_hidden_layers=32,
                     intermediate_size=11008, num_attention_heads=32,
                     num_key_value_heads=32, vocab_size=156032,
                     rope_theta=10000.0, rms_norm_eps=1e-5,
                     tie_word_embeddings=False))
# the JAX tests' tiny configs (tests/test_voxtral.py::tiny_cfg,
# test_qwen2_audio.py::tiny_cfg at widths group 64 divides, for the packed
# ones; test_glmasr.py::_cfg, test_granite_speech.py::tiny_cfg,
# test_vibevoice_asr.py::tiny_cfg as they are)
_TINY_TOWER = dict(d_model=64, encoder_layers=2, encoder_attention_heads=4,
                   encoder_ffn_dim=128, num_mel_bins=32,
                   max_source_positions=1500)
_TINY_LM = dict(hidden_size=64, num_hidden_layers=2, intermediate_size=128,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16)
LLM_STT_SMALL = {
    "voxtral": dict(model_type="voxtral", audio_token_id=24,
                    audio_config=dict(_TINY_TOWER, intermediate_size=256),
                    text_config=dict(_TINY_LM, vocab_size=1200,
                                     rope_theta=1e8)),
    "qwen2_audio": dict(model_type="qwen2_audio", audio_token_id=590,
                        audio_bos_token_id=591, audio_eos_token_id=592,
                        audio_config=_TINY_TOWER,
                        text_config=dict(_TINY_LM, vocab_size=640,
                                         rope_theta=10000.0)),
    "glmasr": dict(model_type="glmasr", merge_factor=2,
                   whisper_config=dict(d_model=16, encoder_attention_heads=2,
                                       encoder_ffn_dim=32, encoder_layers=1,
                                       num_mel_bins=16),
                   lm_config=dict(vocab_size=64, hidden_size=16,
                                  intermediate_size=32, num_hidden_layers=1,
                                  num_attention_heads=2,
                                  num_key_value_heads=2, head_dim=8,
                                  eos_token_id=[3])),
    "granite_speech": dict(
        model_type="granite_speech",
        encoder_config=dict(input_dim=20, num_layers=2, hidden_dim=32,
                            feedforward_mult=2, num_heads=4, dim_head=8,
                            output_dim=10, context_size=8, max_pos_emb=16,
                            conv_kernel_size=5, conv_expansion_factor=2),
        projector_config=dict(hidden_size=32, num_hidden_layers=1,
                              num_attention_heads=4, intermediate_size=64,
                              encoder_hidden_size=32),
        text_config=dict(model_type="granite", vocab_size=120,
                         hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, rope_theta=10000.0,
                         attention_multiplier=0.125,
                         embedding_multiplier=12.0, residual_multiplier=0.22,
                         logits_scaling=8.0),
        audio_token_index=110),
    "vibevoice_asr": dict(
        model_type="vibevoice_asr",
        acoustic_tokenizer_config=dict(vae_dim=8, encoder_n_filters=4,
                                       encoder_ratios=[4, 2],
                                       encoder_depths="1-1-2"),
        semantic_tokenizer_config=dict(vae_dim=12, encoder_n_filters=4,
                                       encoder_ratios=[4, 2],
                                       encoder_depths="1-1-2"),
        decoder_config=dict(vocab_size=151700, hidden_size=32,
                            intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2)),
}
# the stand-in tokenizers' special tokens, EOS and chat template use
LLM_STT_TOKS = {
    "qwen2_audio": ({"<|AUDIO|>": 590, "<|audio_bos|>": 591,
                     "<|audio_eos|>": 592}, 599, True),
    "glmasr": ({}, 3, False),
    "granite_speech": ({"<|audio|>": 110}, 2, False),
    "vibevoice_asr": ({"<|object_ref_start|>": 151646,
                       "<|object_ref_end|>": 151647,
                       "<|box_start|>": 151648}, 151645, True),
}
# small packed checkpoints: Voxtral MLX-packed q8, Qwen2-Audio 4-bit
LLM_STT_BITS = {"voxtral": 8, "qwen2_audio": 4}
LLM_STT_TOKENS = 24
# the full-width runs: 30 s of randn * 0.1 at seed 0, greedy; Voxtral's
# request 64 tokens, Qwen2-Audio's 64 (128 each until phases 58-61);
# VibeVoice-ASR's encoders on 10 minutes at 24 kHz
VOXTRAL_SECONDS, VOXTRAL_TOKENS, QWEN2_AUDIO_TOKENS = 30, 64, 64
VIBEVOICE_ASR_SECONDS = 600
# the q8 and 4-bit models' first-step logits against bf16's (random codes
# through 30 or 32 layers; unrelated logits read about 1.4)
LLM_Q8_REL, LLM_Q4_REL = 0.1, 0.5


class SttTok:
    """A stand-in for an HF tokenizer (none is in the repository): the
    `specials` at their ids, one id a character below 40 above 4; decode
    writes the ids; `chat` gives an `apply_chat_template` that joins the
    messages' contents."""

    unk_token_id = None

    def __init__(self, specials: dict, eos: int, chat: bool):
        self.specials, self.eos_token_id = specials, eos
        self.chat_template = "joined" if chat else None

    def encode(self, text, **kw):
        out, i = [], 0
        while i < len(text):
            for name, tid in self.specials.items():
                if text.startswith(name, i):
                    out.append(tid)
                    i += len(name)
                    break
            else:
                out.append(4 + ord(text[i]) % 40)
                i += 1
        return out

    def decode(self, toks, skip_special_tokens=True):
        return " ".join(str(t) for t in toks)

    def apply_chat_template(self, messages, tokenize=False,
                            add_generation_prompt=True):
        return "".join(m["content"] for m in messages)

    def convert_tokens_to_ids(self, s):
        return self.specials.get(s)


def llm_stt_tok(family: str) -> SttTok:
    specials, eos, chat = LLM_STT_TOKS[family]
    return SttTok(specials, eos, chat)


def _llm_small(family: str, device: str):
    """A small family model at f32 from seed 0 with its stand-in
    tokenizer."""
    import importlib

    mod = importlib.import_module(f"mlx_audio_tpu_torch.stt.models.{family}")
    m = mod.Model(LLM_STT_SMALL[family], device=device).init_params(seed=0)
    if family != "voxtral":
        setattr(m, "tokenizer" if family == "vibevoice_asr" else
                "_tokenizer", llm_stt_tok(family))
    return m


def _llm_outputs(model, family: str, audio) -> tuple:
    """(greedy text, generated tokens, the encoder's rows on the CPU)."""
    import numpy as np

    out = model.generate(audio, max_tokens=LLM_STT_TOKENS)
    if family == "voxtral":
        feats = model.get_audio_embeds(audio)
    elif family == "qwen2_audio":
        feats = model.get_audio_embeds(audio)[0]
    elif family == "glmasr":
        feats = model.encode(audio)[0][0]
    elif family == "granite_speech":
        feats = model.get_audio_features(model._extract_features(audio)[0])
    else:
        feats = model.encode_speech(model._preprocess_audio(
            np.asarray(audio), 16000))
    return out.text, out.generation_tokens, feats.float().cpu()


def phase_llm_stt_reference(tmp: Path, recorder: K2Recorder,
                            device: str = "cuda") -> int:
    """Phase 41: the small configs of the five families, each written as a
    checkpoint directory (Voxtral MLX-packed q8 with a tekken.json,
    Qwen2-Audio MLX-packed 4-bit, both at group 64, their LM and projector
    linears on K2; GLM-ASR, Granite Speech and VibeVoice-ASR dense) and
    loaded through `stt.utils.load_model` on the card and on the CPU (the
    stand-in tokenizers through the modules' `local_tokenizer`): greedy
    tokens and text equal, encoder rows within ASR_REL; the STT CLI on the
    card (Qwen2-Audio json, GLM-ASR `--stream`) against in-process results;
    Granite Speech's directory through `AudioServer`'s transcription route.
    -> K2's launches."""
    import asyncio
    import importlib

    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.server import AudioServer
    from mlx_audio_tpu_torch.stt import generate as stt_generate
    from mlx_audio_tpu_torch.stt.utils import load_model

    t0 = time.perf_counter()
    qmm_kernel.launches = 0
    audio = _noise(31, 4.0)
    wav = tmp / "llm-stt.wav"
    audio_io.write(wav, audio, 16000)
    modules = {f: importlib.import_module(
        f"mlx_audio_tpu_torch.stt.models.{f}.{f}") for f in LLM_STT_TOKS}
    prev = {f: m.local_tokenizer for f, m in modules.items()}
    for f, m in modules.items():
        m.local_tokenizer = lambda path, f=f, **kw: llm_stt_tok(f)
    try:
        for family in LLM_STT_SMALL:
            d = tmp / family
            src = _llm_small(family, "cpu")
            bits = LLM_STT_BITS.get(family)
            write_llm_stt_checkpoint(src, d, bits=bits)
            if family == "voxtral":
                write_mistral_tekken(d / "tekken.json", 40, 1200)
            cpu = load_model(d, device="cpu")
            with recorder:
                card = load_model(d, device=device)
                held = sum(isinstance(m, QuantizedLinear)
                           for m in card.modules())
                got = _llm_outputs(card, family, audio)
            want = _llm_outputs(cpu, family, audio)
            rel = rel_err(got[2], want[2])
            lm = LLM_STT_SMALL[family].get("text_config", {})
            # the LM's 7 a layer and its head, and the projector's
            n_q = {"voxtral": 7 * 2 + 1 + 2, "qwen2_audio": 7 * 2 + 1 + 1}
            if not (got[:2] == want[:2] and got[1] > 0 and rel < ASR_REL
                    and held == n_q.get(family, 0)):
                raise AssertionError(
                    f"{family} card vs CPU: text equal {got[0] == want[0]}, "
                    f"tokens {got[1]} vs {want[1]}, encoder rel {rel:.3e}, "
                    f"{held} quantized linears")
            log(f"[{family} small] "
                + (f"MLX-packed {bits}-bit checkpoint: {held} linears on "
                   f"K2; " if bits else "dense checkpoint; ")
                + f"{got[1]} greedy tokens equal on the card and the CPU, "
                f"encoder rows {tuple(got[2].shape)} rel {rel:.3e}"
                + (f" (LM {lm.get('hidden_size')} wide)" if lm else ""))
        # the STT CLI on the card: Qwen2-Audio's json, GLM-ASR streamed
        with recorder:
            m = load_model(tmp / "qwen2_audio", device=device)
            heard, _ = audio_io.read(str(wav), dtype="float32")
            want = m.generate(heard, max_tokens=LLM_STT_TOKENS).text
            stt_generate.main(["--model", str(tmp / "qwen2_audio"),
                               "--audio", str(wav), "--max-tokens",
                               str(LLM_STT_TOKENS), "--format", "json",
                               "--no-verbose", "--output-path",
                               str(tmp / "q2-cli")])
        cli = json.loads((tmp / "q2-cli" / "transcription.json")
                         .read_text())["text"]
        g = load_model(tmp / "glmasr", device=device)
        streamed = "".join(r.text for r in g.generate(
            heard, max_tokens=LLM_STT_TOKENS, stream=True))
        stt_generate.main(["--model", str(tmp / "glmasr"), "--audio",
                           str(wav), "--max-tokens", str(LLM_STT_TOKENS),
                           "--stream", "--no-verbose", "--output-path",
                           str(tmp / "glm-cli")])
        glm_cli = (tmp / "glm-cli" / "transcription.txt").read_text()
        server = AudioServer(device=device)
        try:
            served = asyncio.run(server.transcribe(
                {"model": str(tmp / "granite_speech"),
                 "response_format": "json",
                 "max_tokens": str(LLM_STT_TOKENS)}, wav.read_bytes()))
        finally:
            server.close()
        granite_want = load_model(tmp / "granite_speech", device=device) \
            .generate(heard, max_tokens=LLM_STT_TOKENS).text
        if not (cli == want and glm_cli.strip() == streamed.strip()
                and streamed and served.status == 200
                and served.json.get("text") == granite_want):
            raise AssertionError(f"CLI {cli!r} vs {want!r}; GLM --stream "
                                 f"{glm_cli!r} vs {streamed!r}; server "
                                 f"{served.status} {served.json}")
        log(f"[llm-stt small] the STT CLI wrote Qwen2-Audio's generate() "
            f"text as json and GLM-ASR's streamed text; AudioServer's "
            f"transcription route gave Granite Speech's generate() text")
    finally:
        for f, m in modules.items():
            m.local_tokenizer = prev[f]
    launches = qmm_kernel.launches
    log(f"[time] phase 41 in {time.perf_counter() - t0:.1f} s; K2 launched "
        f"{launches} times")
    return launches


def llm_token_bytes(lm, cache_cols: float) -> float:
    """Bytes a decode token of the llama LM `lm` must read: its linears
    (bf16, or codes one a byte with f32 scales and biases, and their f32
    q/k/v biases), the token's table row, the norms, and the f32 K and V
    of `cache_cols` columns."""
    from mlx_audio_tpu_torch.nn import Linear, QuantizedLinear

    t = lm.config
    total = 0.0
    for m in lm.modules():
        if isinstance(m, Linear):
            total += m.weight.numel() * m.weight.element_size()
            if m.bias is not None:
                total += m.bias.numel() * m.bias.element_size()
        elif isinstance(m, QuantizedLinear):
            total += (m.w_q.numel() + 4 * (m.scales.numel()
                                           + m.biases.numel()))
            if m.bias is not None:
                total += 4 * m.bias.numel()
    total += (t.hidden_size + (2 * t.num_hidden_layers + 1)
              * t.hidden_size) * 2
    total += (2 * t.num_hidden_layers * cache_cols * t.num_key_value_heads
              * t.resolved_head_dim * 4)
    return total


def _llm_run(model, audio, label: str, tag: str, tokens: int, card: str,
             base: int, encode) -> dict:
    """Encoder ms (`encode(audio)`), prefill ms, a generate of `tokens`
    tokens (ms a token p50 and p95 over its chunks after the first, xRT,
    peak memory), one profiled chunk (kernels, device ms and busy share a
    token, K2's launches a token) and the byte bound a token. -> the
    numbers."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.stt.models.llm_stt import (DEC_CHUNK, GREEDY,
                                                        decode_fns,
                                                        splice_embeds)

    lm = model.language_model
    laps = Laps(f"{tag} {label}")
    model.generate(audio, max_tokens=8)
    laps("warm-up")
    enc_ms = _sync_ms(lambda: encode(audio))
    feats, ids = model.prompt_inputs(audio)
    n = len(ids)
    fns = decode_fns(lm, n, tokens, GREEDY, model._eos_ids())
    with torch.inference_mode():
        embeds = splice_embeds(lm, ids, feats, audio_id=model.audio_id)
    prefill_ms = _sync_ms(lambda: fns.prefill(embeds, n))
    logits = fns.prefill(embeds, n)[0]
    laps("encoder and prefill timed")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = model.generate(audio, max_tokens=tokens)
    wall = time.perf_counter() - t0
    laps("the request")
    run = dict(model.last_run)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    per_token = np.asarray(run["chunk_ms"][1:]) / DEC_CHUNK
    if not (out.generation_tokens > 0 and len(per_token)):
        raise AssertionError(f"{tag} {label}: {run}")
    state = fns.start(embeds, n, tokens)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fns.chunk(state, PROFILE_STEPS)
    chunk_wall = (time.perf_counter() - t1) * 1e3 / PROFILE_STEPS
    k2, fwd = qmm_kernel.launches, state["forwards"]
    rows = _device_kernels(lambda: fns.chunk(state, PROFILE_STEPS),
                           cpu=False)
    k2_token = (qmm_kernel.launches - k2) / max(state["forwards"] - fwd, 1)
    dev_ms = sum(_dev_us(e) for e in rows) / 1e3 / PROFILE_STEPS
    kernels = sum(e.count for e in rows) / PROFILE_STEPS
    laps("profiled steps")
    laps.log()
    if not (kernels > 0 and dev_ms > 0):
        raise AssertionError(f"{tag}: the profiler saw no kernel")
    cols = n + run["steps"] / 2
    nbytes = llm_token_bytes(lm, cols)
    bound = nbytes / HBM_BPS * 1e3
    t = lm.config
    col_bytes = (2 * t.num_hidden_layers * t.num_key_value_heads
                 * t.resolved_head_dim * 4)
    seconds = len(audio) / 16000
    res = dict(enc_ms=enc_ms, prefill_ms=prefill_ms, prompt=n,
               p50=float(np.percentile(per_token, 50)),
               p95=float(np.percentile(per_token, 95)), wall=wall,
               xrt=seconds / wall, peak=peak, kernels=kernels, dev_ms=dev_ms,
               busy=dev_ms / chunk_wall, bound=bound, nbytes=nbytes,
               k2_token=k2_token, logits=logits, steps=run["steps"],
               tokens=out.generation_tokens, audio_tokens=feats.shape[0])
    log(f"[{tag}] {label}: {seconds:.0f} s, {feats.shape[0]} audio tokens in "
        f"a {n}-token prompt: encoder {enc_ms:.2f} ms, prefill "
        f"{prefill_ms:.2f} ms; {res['tokens']} tokens ({run['steps']} "
        f"steps): {res['p50']:.2f} ms a token p50, {res['p95']:.2f} p95 "
        f"(over {len(per_token)} chunks of {DEC_CHUNK}), wall {wall:.2f} s, "
        f"xRT {res['xrt']:.2f}, peak {peak:.2f} GB above the earlier "
        f"phases'; profiled chunk: {kernels:.0f} kernels and {dev_ms:.3f} ms "
        f"of device time a token against {chunk_wall:.2f} ms of wall "
        f"({100 * res['busy']:.1f}% busy), {k2_token:.0f} K2 launches a "
        f"token; {nbytes / 1e9:.3f} GB a token, bound {bound:.3f} ms "
        f"(bytes), {100 * bound / res['p50']:.1f}% of it reached at p50; "
        f"the f32 caches read {cols:.0f} columns a token on average "
        f"({cols * col_bytes / 1e9:.3f} GB) ({card})")
    return res


def _pack_into(model, bits: int) -> None:
    """`model`'s LM and projector (its `model_quant_predicate`) packed in
    memory to MLX's `bits`-bit layout (group 64) and loaded back through
    the pre-quantized path, on the card."""
    import torch

    from mlx_audio_tpu_torch.utils import (apply_quantization,
                                           unpack_prequantized)

    packed = pack_mlx_in_memory(model, bits, model.model_quant_predicate)
    torch.cuda.empty_cache()
    config = {"quantization": {"group_size": MLX_GROUP, "bits": bits}}
    flat = unpack_prequantized(model, config, packed)
    del packed
    model.bind(flat)
    del flat
    apply_quantization(model, config, pre_quantized=True)
    torch.cuda.empty_cache()


def phase_voxtral_mini(card: str, recorder: K2Recorder, tmp: Path) -> int:
    """Phase 42: Voxtral-Mini-3B-2507 at its published dims seeded on the
    card in bf16 (a stand-in tekken.json of 131,072 ids), then its
    projector and LM packed in memory to MLX's 8-bit layout (group 64; the
    tower dense, as `model_quant_predicate` says) and loaded through the
    pre-quantized path: each on 30 s of `randn * 0.1` at seed 0 with
    max_tokens 256 (`_llm_run`); the LM's linears at the prefill's M, K2
    against cuBLAS bf16 (`_linear_times`) and their bound; K2's launches a token
    read from its counter against the config's 30 x 7 + 1 (the head); the
    first step's logits q8 against bf16. -> K2's launches."""
    import torch

    from mlx_audio_tpu_torch.nn import Embedding, Linear, QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.stt.models.voxtral import Model, TekkenEncoder

    t_phase = time.perf_counter()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    base = torch.cuda.memory_allocated()
    model = Model(VOXTRAL_MINI_3B, device="cuda").init_params(
        seed=0, on_device=True)
    model.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    write_mistral_tekken(tmp / "tekken.json", 1000, 131072)
    model._tekken = TekkenEncoder(str(tmp / "tekken.json"))
    log(f"[voxtral-mini] Voxtral-Mini-3B-2507 dims (tower 32 x d1280, LM 30 "
        f"x d3072 GQA 32/8, 131,072 ids, untied head): "
        f"{model.num_params():,} params bf16 on cuda, built in "
        f"{time.perf_counter() - t_phase:.2f} s")
    audio = _noise(0, VOXTRAL_SECONDS)
    bf16 = _llm_run(model, audio, "bf16", "voxtral-mini", VOXTRAL_TOKENS,
                    card, base, model.get_audio_embeds)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the bf16 Voxtral launched K1 or K2")
    t = model.config.text
    per_token = 7 * t.num_hidden_layers + 1
    t1 = time.perf_counter()
    _pack_into(model, 8)
    lm_held = sum(isinstance(m, QuantizedLinear)
                  for m in model.language_model.modules())
    held = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    if not (lm_held == per_token and held == per_token + 2
            and isinstance(model.language_model.model.embed_tokens,
                           Embedding)
            and isinstance(model.audio_tower.layers[0].fc1, Linear)):
        raise AssertionError(f"q8 Voxtral: {held} quantized linears, "
                             f"{lm_held} in the LM (want {per_token})")
    log(f"[voxtral-mini] packed to MLX 8-bit (group {MLX_GROUP}) in memory "
        f"and loaded through the pre-quantized path in "
        f"{time.perf_counter() - t1:.2f} s: {held} linears on K2 "
        f"({lm_held} in the LM with its head, 2 in the projector), the "
        f"tower and the token table dense")
    k1 = snake_conv_kernel.launches
    qmm_kernel.launches = 0
    with recorder:
        q8 = _llm_run(model, audio, "q8 (K2)", "voxtral-mini",
                      VOXTRAL_TOKENS, card, base, model.get_audio_embeds)
    k2 = qmm_kernel.launches
    if q8["k2_token"] != per_token or snake_conv_kernel.launches != k1:
        raise AssertionError(f"q8 Voxtral: {q8['k2_token']} K2 launches a "
                             f"token, want {per_token}; or K1 launched")
    rel = float(torch.linalg.norm(q8["logits"] - bf16["logits"])
                / torch.linalg.norm(bf16["logits"]))
    top1 = int(q8["logits"].argmax()) == int(bf16["logits"].argmax())
    if not (torch.isfinite(q8["logits"]).all() and rel < LLM_Q8_REL):
        raise AssertionError(f"q8 Voxtral first-step logits vs bf16: "
                             f"relative {rel:.3e}")
    alone, bound, n = k2_linears_alone(model.language_model, card,
                                       "voxtral-mini")
    shapes = ((4096, 3072), (1024, 3072), (3072, 4096), (8192, 3072),
              (3072, 8192))
    sums = _linear_times(card, "voxtral-mini", shapes, (1, 2, 1, 2, 1),
                         t.num_hidden_layers, rows=(q8["prompt"],))
    pre = sums[q8["prompt"]]
    pre_bound, by = linears_bound(shapes, (1, 2, 1, 2, 1),
                                  t.num_hidden_layers, q8["prompt"])
    log(f"[voxtral-mini] the prefill's {7 * t.num_hidden_layers} LM linears "
        f"at M = {q8['prompt']}: K2 (mma) {pre['K2']:.3f} ms against cuBLAS "
        f"bf16 {pre['bf16']:.3f} ms ({pre['K2'] / pre['bf16']:.2f}x); bound "
        f"{pre_bound:.3f} ms ({by}), {100 * pre_bound / pre['K2']:.1f}% of "
        f"it reached by K2, {100 * pre_bound / pre['bf16']:.1f}% by cuBLAS "
        f"({card})")
    log(f"[voxtral-mini] q8 against bf16 on this card: encoder "
        f"{q8['enc_ms']:.2f} vs {bf16['enc_ms']:.2f} ms, prefill "
        f"{q8['prefill_ms']:.2f} vs {bf16['prefill_ms']:.2f} ms, "
        f"{q8['p50']:.2f} vs {bf16['p50']:.2f} ms a token p50, "
        f"{q8['p95']:.2f} vs {bf16['p95']:.2f} p95, xRT {q8['xrt']:.2f} vs "
        f"{bf16['xrt']:.2f}, {q8['kernels']:.0f} vs {bf16['kernels']:.0f} "
        f"kernels and {q8['dev_ms']:.3f} vs {bf16['dev_ms']:.3f} ms of device "
        f"time a token, busy {100 * q8['busy']:.1f}% vs "
        f"{100 * bf16['busy']:.1f}%, peak {q8['peak']:.2f} vs "
        f"{bf16['peak']:.2f} GB, {q8['nbytes'] / 1e9:.3f} vs "
        f"{bf16['nbytes'] / 1e9:.3f} GB and bound {q8['bound']:.3f} vs "
        f"{bf16['bound']:.3f} ms a token; K2 launched {k2} times, "
        f"{q8['k2_token']:.0f} a decode token (read from its counter; the "
        f"config gives {per_token}), the LM's {n} linears alone "
        f"{alone:.3f} ms a token (bound {bound:.3f} ms); first-step logits "
        f"q8 vs bf16 relative {rel:.3e} (limit {LLM_Q8_REL:g}), top-1 "
        f"{'equal' if top1 else 'differs'} ({card})")
    del model
    torch.cuda.empty_cache()
    log(f"[time] phase 42 in {time.perf_counter() - t_phase:.1f} s")
    return k2


def phase_qwen2_audio_7b(card: str, recorder: K2Recorder) -> int:
    """Phase 43: Qwen2-Audio-7B-Instruct at its published dims seeded on
    the card in bf16, its projector and LM packed in memory to MLX's 4-bit
    layout (group 64, as the mlx-community checkpoint ships it) and loaded
    through the pre-quantized path; 30 s of `randn * 0.1` at seed 0 with
    max_tokens 128 (`_llm_run`, no tokenizer: the bare audio prompt); K2's
    launches a token read from its counter against 32 x 7 + 1; the first
    step's logits 4-bit against bf16. -> K2's launches."""
    import torch

    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.stt.models.llm_stt import (GREEDY, decode_fns,
                                                        splice_embeds)
    from mlx_audio_tpu_torch.stt.models.qwen2_audio import Model

    t_phase = time.perf_counter()
    base = torch.cuda.memory_allocated()
    model = Model(QWEN2_AUDIO_7B, device="cuda").init_params(
        seed=0, on_device=True)
    model.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    n_params = model.num_params()
    audio = _noise(0, VOXTRAL_SECONDS)
    lm = model.language_model
    feats, ids = model.prompt_inputs(audio)
    with torch.inference_mode():
        embeds = splice_embeds(lm, ids, feats, audio_id=model.audio_id)
    fns = decode_fns(lm, len(ids), 1, GREEDY, model._eos_ids())
    logits_bf16 = fns.prefill(embeds, len(ids))[0]
    del fns, embeds
    t = lm.config
    per_token = 7 * t.num_hidden_layers + 1
    t1 = time.perf_counter()
    _pack_into(model, 4)
    held = sum(isinstance(m, QuantizedLinear) for m in lm.modules())
    if held != per_token:
        raise AssertionError(f"4-bit Qwen2-Audio's LM holds {held} quantized "
                             f"linears, want {per_token}")
    log(f"[qwen2-audio-7b] Qwen2-Audio-7B-Instruct dims (tower 32 x d1280, "
        f"LM 32 x d4096, 32 heads and 32 KV heads, 156,032 ids, q/k/v "
        f"biases, untied head): {n_params:,} params, seeded bf16 on cuda, "
        f"packed to MLX 4-bit (group {MLX_GROUP}) and loaded through the "
        f"pre-quantized path in {time.perf_counter() - t1:.2f} s: {held} LM "
        f"linears and the projector on K2")
    qmm_kernel.launches = 0
    with recorder:
        q4 = _llm_run(model, audio, "4-bit (K2)", "qwen2-audio-7b",
                      QWEN2_AUDIO_TOKENS, card, base,
                      lambda a: model.get_audio_embeds(a))
    k2 = qmm_kernel.launches
    if q4["k2_token"] != per_token:
        raise AssertionError(f"4-bit Qwen2-Audio: {q4['k2_token']} K2 "
                             f"launches a token, want {per_token}")
    rel = float(torch.linalg.norm(q4["logits"] - logits_bf16)
                / torch.linalg.norm(logits_bf16))
    if not (torch.isfinite(q4["logits"]).all() and rel < LLM_Q4_REL):
        raise AssertionError(f"4-bit Qwen2-Audio first-step logits vs bf16: "
                             f"relative {rel:.3e}")
    alone, bound, n = k2_linears_alone(lm, card, "qwen2-audio-7b")
    log(f"[qwen2-audio-7b] K2 launched {k2} times, {q4['k2_token']:.0f} a "
        f"decode token (read from its counter; the config gives "
        f"{per_token}); the LM's {n} linears alone {alone:.3f} ms a token "
        f"(bound {bound:.3f} ms); {q4['nbytes'] / 1e9:.3f} GB a token with "
        f"the f32 caches, bound {q4['bound']:.3f} ms against "
        f"{q4['p50']:.2f} ms p50; peak {q4['peak']:.2f} GB; first-step "
        f"logits 4-bit vs bf16 relative {rel:.3e} (limit {LLM_Q4_REL:g}) "
        f"({card})")
    del model, lm
    torch.cuda.empty_cache()
    log(f"[time] phase 43 in {time.perf_counter() - t_phase:.1f} s")
    return k2


def phase_vibevoice_asr_encoders(card: str) -> None:
    """Phase 44: VibeVoice-ASR's acoustic and semantic tokenizer encoders at
    `TokenizerConfig()` dims (32 filters, ratios 8-5-5-4-2-2, depths
    3-3-3-3-3-3-8; the LM small) in bf16 on 10 minutes of 24-kHz audio:
    ms and peak memory, the rows' count (ceil(T / 3,200)) and finiteness;
    the same model in f32 on the first 10 s against bf16 (relative)."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.stt.models.vibevoice_asr import Model
    from mlx_audio_tpu_torch.stt.models.vibevoice_asr.vibevoice_asr import \
        speech_token_count

    t_phase = time.perf_counter()
    cfg = dict(LLM_STT_SMALL["vibevoice_asr"])
    cfg.pop("acoustic_tokenizer_config")
    cfg.pop("semantic_tokenizer_config")
    model = Model(cfg, device="cuda").init_params(seed=0, on_device=True)
    n_enc = sum(p.numel() for name, p in model.named_parameters()
                if "tokenizer" in name)
    wav = (np.random.RandomState(0).randn(24000 * VIBEVOICE_ASR_SECONDS)
           * 0.1).astype(np.float32)
    f32 = model.encode_speech(wav[:240000])
    model.astype(torch.bfloat16)
    short = model.encode_speech(wav[:240000])
    rel = rel_err(short, f32)
    model.encode_speech(wav[:24000])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    feats = model.encode_speech(wav)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    n_tok = speech_token_count(len(wav), model.config.acoustic.encoder_ratios)
    if not (feats.shape[0] == n_tok and torch.isfinite(feats).all()
            and rel < 5e-2):
        raise AssertionError(f"VibeVoice-ASR encoders: {tuple(feats.shape)} "
                             f"(want {n_tok} rows), bf16 vs f32 rel {rel:.3e}")
    hour = 59 * 60 / VIBEVOICE_ASR_SECONDS
    log(f"[vibevoice-asr] the two tokenizer encoders at TokenizerConfig() "
        f"({n_enc:,} params) in bf16 on {VIBEVOICE_ASR_SECONDS} s at 24 kHz "
        f"({len(wav):,} samples): {ms:.1f} ms ({ms / VIBEVOICE_ASR_SECONDS:.3f}"
        f" ms a second of audio), peak {peak:.2f} GB above the model, "
        f"{n_tok} speech tokens, finite; on the first 10 s bf16 vs f32 rel "
        f"{rel:.3e}; at the 59-minute cap the peak would scale to about "
        f"{peak * hour:.1f} GB ({card})")
    del model, feats
    torch.cuda.empty_cache()
    log(f"[time] phase 44 in {time.perf_counter() - t_phase:.1f} s")


def phase_llm_stt(card: str, recorder: K2Recorder) -> int:
    """Phases 41-44; K1 never launches, K2 only on the packed models. ->
    K2's launches there."""
    import torch

    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    t0 = time.perf_counter()
    k1 = snake_conv_kernel.launches
    with tempfile.TemporaryDirectory() as tmp:
        k2 = phase_llm_stt_reference(Path(tmp), recorder)
        torch.cuda.empty_cache()
        k2 += phase_voxtral_mini(card, recorder, Path(tmp))
    k2 += phase_qwen2_audio_7b(card, recorder)
    phase_vibevoice_asr_encoders(card)
    if snake_conv_kernel.launches != k1:
        raise AssertionError("phases 41-44 launched K1")
    log(f"[time] phases 41-44 in {time.perf_counter() - t0:.1f} s; K1 not "
        f"launched")
    return k2


# ---------------------------------------------------------------------------
# OuteTTS over the DAC, Pocket-TTS and EnCodec, MMS and language ID
# (phases 45-48)
# ---------------------------------------------------------------------------

# the card the full-size phases 45-48 run on
DEVICE = "cuda"
# small configs: a llama whose widths group 64 divides (the q8 checkpoint),
# the tiny DAC of tests/test_codecs.py::TestDAC at 24 kHz with two
# codebooks of 1,024, TestEncodec's EnCodec with two LSTM layers,
# tests/test_pocket_tts.py's `tiny_cfg`, tests/test_wav2vec2.py's tiny
# wav2vec2 with the stable layer norm and adapters, TestLidEcapa's ECAPA
OUTE_SMALL = dict(model_type="outetts", hidden_size=64, num_hidden_layers=2,
                  intermediate_size=128, num_attention_heads=4,
                  num_key_value_heads=2, vocab_size=2304,
                  rope_theta=10000.0)
# the stand-in tokenizer's ids: characters from 3, c1 and c2 codes from
# these, the special strings from `special`
OUTE_SMALL_IDS = dict(c1=100, c2=1200, special=2240, chars=90)
DAC_SMALL = dict(model_type="dac", encoder_dim=16, encoder_rates=[2, 4],
                 latent_dim=32, decoder_dim=64, decoder_rates=[4, 2],
                 n_codebooks=2, codebook_size=1024, codebook_dim=4,
                 sample_rate=24000)
ENCODEC_SMALL = dict(model_type="encodec", num_filters=8, hidden_size=16,
                     codebook_dim=16, codebook_size=32, num_quantizers=4,
                     upsampling_ratios=[4, 2], num_lstm_layers=2)
POCKET_SMALL = dict(
    model_type="pocket_tts",
    flow_lm=dict(transformer=dict(d_model=32, num_heads=4, num_layers=2,
                                  hidden_scale=2, max_period=10000),
                 flow=dict(dim=32, depth=2),
                 lookup_table=dict(n_bins=64, dim=16)),
    mimi=dict(sample_rate=24000, channels=1, frame_rate=12.5,
              seanet=dict(dimension=16, channels=1, n_filters=4,
                          n_residual_layers=1, ratios=[8, 5, 4, 2],
                          kernel_size=7, residual_kernel_size=3,
                          last_kernel_size=3, dilation_base=2,
                          pad_mode="constant", compress=2),
              transformer=dict(d_model=16, num_heads=2, num_layers=1,
                               layer_scale=0.01, context=32,
                               dim_feedforward=32),
              quantizer=dict(dimension=8, output_dimension=16)))
MMS_SMALL = dict(model_type="wav2vec2", vocab_size=6, hidden_size=16,
                 num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=32, conv_dim=[8, 8], conv_stride=[5, 2],
                 conv_kernel=[10, 3], num_feat_extract_layers=2,
                 num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=4,
                 do_stable_layer_norm=True, feat_extract_norm="layer",
                 adapter_attn_dim=4)
MMS_SMALL_VOCAB = {"<pad>": 0, "a": 1, "b": 2, "|": 3, "c": 4, "d": 5}
LID_SMALL = dict({k: v for k, v in MMS_SMALL.items() if k != "vocab_size"},
                 classifier_proj_size=8,
                 id2label={"0": "en", "1": "fr", "2": "de"})
ECAPA_SMALL = dict(model_type="ecapa_tdnn", channels=32, embedding_dim=16,
                   attention_channels=8, res2net_scale=4, se_channels=8,
                   classifier_hidden_dim=16, num_classes=5,
                   id2label={"0": "en: English", "1": "fr: French",
                             "2": "de: German", "3": "es: Spanish",
                             "4": "zh: Chinese"})
# CUDA against the CPU at f32 on the small configs
OUTE_REL = 1e-4
OUTE_TEXT = "hello from the card"
# the head's (or tied table's) c1 and c2 rows scaled, so that random
# weights draw code pairs
OUTE_CODE_SCALE = 4.0
# Llama-OuteTTS-1.0-1B: Llama-3.2-1B's dims (16 layers at d2048, GQA 32/8
# of 64, FFN 8,192, RoPE theta 500,000 with llama3 scaling of factor 32,
# the head tied to the table) and OuteTTS-1.0's vocabulary of 134,400
OUTE_1B = dict(model_type="outetts", hidden_size=2048, num_hidden_layers=16,
               intermediate_size=8192, num_attention_heads=32,
               num_key_value_heads=8, head_dim=64, vocab_size=134400,
               rope_theta=500000.0, tie_word_embeddings=True,
               rope_scaling=dict(rope_type="llama3", factor=32.0,
                                 low_freq_factor=1.0, high_freq_factor=4.0,
                                 original_max_position_embeddings=8192))
# the stand-in tokenizer gives c1_i and c2_i one id, so that each code token
# random weights draw is a DAC frame of two codes (a trained model
# alternates c1 and c2 tokens)
OUTE_1B_IDS = dict(c1=128400, c2=128400, special=130450, chars=1000)
# descript's 24-kHz DAC (weights_24khz.pth's settings); OuteTTS decodes
# two of its 32 codebooks
DAC_24KHZ = dict(model_type="dac", encoder_dim=64, encoder_rates=[2, 4, 5, 8],
                 latent_dim=1024, decoder_dim=1536,
                 decoder_rates=[8, 5, 4, 2], n_codebooks=32,
                 codebook_size=1024, codebook_dim=8, sample_rate=24000)
# the request 64 tokens (128 until phases 58-61)
OUTE_TOKENS, OUTE_INTERVAL = 64, 0.5
OUTE_LONG_TEXT = ("OuteTTS reads this sentence aloud on the card, two DAC "
                  "codebooks a frame, seventy five frames a second")
# Pocket-TTS at the JAX package's ModelConfig() defaults (no published
# config.json is in the repository); one sentence of ten words from the
# default 0.5-s silent voice prompt, EOS biased off: max_gen frames
POCKET_TEXT = ("The small streaming voice speaks this short sentence "
               "for everyone today")
POCKET_EOS_BIAS = -1e4
POCKET_PROFILE_FRAMES = 4
# EnCodec at mlx-community/encodec-24khz-float32's dims (ModelConfig()),
# a round trip of ENCODEC_SECONDS in f32
ENCODEC_SECONDS = 10
# MMS-1b-all (wav2vec2 large: 48 layers at d1280, 16 heads, FFN 5,120, the
# stable layer norm, adapters of 16) over an English vocabulary of 154;
# MMS-LID-256 on the same backbone (projector 1,024, 256 labels);
# SpeechBrain's VoxLingua107 ECAPA (channels 1,024, embedding 256, 107
# languages)
MMS_1B = dict(model_type="wav2vec2", vocab_size=154, hidden_size=1280,
              num_hidden_layers=48, num_attention_heads=16,
              intermediate_size=5120, feat_extract_norm="layer",
              conv_bias=True, do_stable_layer_norm=True,
              num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16,
              adapter_attn_dim=16)
MMS_LID_256 = dict({k: v for k, v in MMS_1B.items()
                    if k not in ("vocab_size", "adapter_attn_dim")},
                   classifier_proj_size=1024,
                   id2label={str(i): f"lang{i}" for i in range(256)})
ECAPA_VOXLINGUA = dict(model_type="ecapa_tdnn", channels=1024,
                       embedding_dim=256, num_classes=107)
MMS_SECONDS, MMS_LID_SECONDS, ECAPA_SECONDS = 30, 10, 30
# the share of frames whose CTC ids agree, bf16 against f32, on random
# weights
MMS_BF16_AGREE = 0.9


class PocketTok:
    """A stand-in Pocket-TTS tokenizer: one id a character, inside the
    small config's 64-bin table (tests/test_pocket_tts.py's)."""

    def encode(self, text):
        return [ord(c) % 64 for c in text]


class OuteTok:
    """A stand-in OuteTTS tokenizer (no HF tokenizer is in the repository):
    each special string of the prompt one id from `special`, the c1 and c2
    codes at `c1` + i and `c2` + i, any other character one of `chars`
    ids from 3."""

    def __init__(self, c1: int, c2: int, special: int, chars: int):
        from mlx_audio_tpu_torch.tts.models.outetts.prompt import \
            SpecialTokens

        st = SpecialTokens()
        self.ids = {}
        for s in st.to_dict().values():
            if "{" not in s:
                self.ids[s] = special + len(self.ids)
        for i in range(1025):
            self.ids[st.c1.format(i)] = c1 + i
            self.ids[st.c2.format(i)] = c2 + i
        self.eos_token_id = self.ids[st.eos]
        self.chars = chars

    def encode(self, text, add_special_tokens=False):
        out, i = [], 0
        while i < len(text):
            j = text.find(">", i) if text[i] == "<" else -1
            if j != -1 and text[i:j + 1] in self.ids:
                out.append(self.ids[text[i:j + 1]])
                i = j + 1
            else:
                out.append(3 + ord(text[i]) % self.chars)
                i += 1
        return out


def _scale_outetts_codes(model, ids: dict) -> None:
    """The head's c1 and c2 rows (the table's where it is tied) times
    OUTE_CODE_SCALE."""
    import torch

    with torch.no_grad():
        w = (model.model.embed_tokens.weight
             if model.config.tie_word_embeddings else model.lm_head.weight)
        for start in sorted({ids["c1"], ids["c2"]}):
            w[start:start + 1025] *= OUTE_CODE_SCALE


def _small(kind: str, cfg: dict, device: str, like=None):
    """A small model of `kind` ("dac", "encodec", "pocket", "mms", "lid",
    "ecapa") on `device`: seeded from 0, or `like`'s weights."""
    import importlib

    module, cls = {
        "dac": ("codec.models.descript", "DAC"),
        "encodec": ("codec.models.encodec", "Encodec"),
        "pocket": ("tts.models.pocket_tts", "Model"),
        "mms": ("stt.models.mms", "Model"),
        "lid": ("lid.models.wav2vec2", "Model"),
        "ecapa": ("lid.models.ecapa_tdnn", "Model")}[kind]
    m = importlib.import_module(f"mlx_audio_tpu_torch.{module}")
    return _seeded_like(getattr(m, cls)(dict(cfg), device=device), like)


def _outetts_small(device: str, like=None):
    """The small OuteTTS (seed 0, its code rows scaled), the stand-in
    tokenizer, the small DAC (seed 1) bound."""
    from mlx_audio_tpu_torch.tts.models.outetts import Model

    model = Model(OUTE_SMALL, device=device)
    if like is None:
        model.init_params(seed=0)
        _scale_outetts_codes(model, OUTE_SMALL_IDS)
    else:
        model.load_state_dict(like.state_dict())
    model.tokenizer = OuteTok(**OUTE_SMALL_IDS)
    dac = _small("dac", DAC_SMALL, device)
    if like is None:
        dac.init_params(seed=1)
    else:
        dac.load_state_dict(like.codec.state_dict())
    return model.set_codec(dac)


def _outetts_greedy(model, n: int = 40) -> tuple:
    """n greedy tokens of OUTE_TEXT's prompt, and `generate`'s audio."""
    import numpy as np

    ids = np.asarray(model.tokenizer.encode(
        model._processor().get_completion_prompt(OUTE_TEXT)), np.int32)
    *_, toks = model._decode_tokens(ids, n, 0.0, 0.9, 40, 0.05, 1.1, 0)
    res = list(model.generate(OUTE_TEXT, temperature=0.0, max_tokens=n))
    audio = np.concatenate([r.audio for r in res]) if res else np.zeros(0)
    return toks, audio


def write_outetts_checkpoint(model, path: Path, bits=None) -> None:
    """`model` as a checkpoint directory: config.json and model.safetensors
    (HF llama names; with `bits` MLX-packed, `write_lm_weights`), its DAC
    in `codec/` (descript's names, torch layouts, config.json)."""
    import numpy as np
    from safetensors.numpy import save_file

    write_lm_weights(model, path, bits)
    (path / "codec").mkdir(exist_ok=True)
    save_file({k: np.ascontiguousarray(v.float().cpu().numpy())
               for k, v in model.codec.state_dict().items()},
              str(path / "codec" / "model.safetensors"))
    (path / "codec" / "config.json").write_text(json.dumps(DAC_SMALL))


def _load_outetts(path: Path, device: str):
    from mlx_audio_tpu_torch.tts.utils import load_model

    model = load_model(path, device=device)
    model.tokenizer = OuteTok(**OUTE_SMALL_IDS)
    return model


def _pocket_frames(model, **kw) -> tuple:
    """`generate` of a short sentence (EOS moved below its logit: it fires
    on the first frame, eight frames follow) -> (the frames' latents, the
    audio)."""
    import numpy as np

    latents = []
    frame = model.frame

    def recorded(*args):
        out = frame(*args)
        latents.append(out[0].float().cpu().numpy())
        return out

    model.frame = recorded
    try:
        res = list(model.generate("hello world test", temperature=0.0,
                                  frames_after_eos=8, eos_threshold=-1000.0,
                                  seed=0, **kw))
    finally:
        del model.frame
    return np.concatenate(latents), np.concatenate([r.audio for r in res])


def _write_state(model, path: Path, config: dict, jax_tree=False) -> None:
    """config.json and the model's weights in npz: its names in torch
    layouts (HF's, for wav2vec2), or the JAX tree (ECAPA's)."""
    import numpy as np

    from mlx_audio_tpu_torch.model import jax_params

    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(config))
    state = jax_params(model) if jax_tree else model.state_dict()
    np.savez(path / "model.npz", **{k: v.float().cpu().numpy()
                                    for k, v in state.items()})


def phase_outetts_lid_reference(tmp: Path, recorder: K2Recorder) -> int:
    """Phase 45: the small configs at f32 from one seeded weight set, the
    card against the CPU: the DAC (encode codes equal, `from_codes` and
    decode within OUTE_REL), EnCodec's round trip, OuteTTS (40 greedy
    tokens equal, the DAC audio), an MLX-packed q8 OuteTTS through
    `tts.utils.load_model` (every linear on K2: tokens equal to the CPU's
    and to the same model through `qmatmul_reference`), Pocket-TTS's frames
    at temperature 0, MMS's CTC ids, wav2vec2 and ECAPA LID's
    probabilities; then tiny directories through `tts.utils`,
    `stt.utils`, `lid.utils` and the top-level `load_model` on the card,
    the TTS CLI on OuteTTS and the STT CLI on MMS against in-process
    `generate`. -> K2's launches, as its counter read them."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch import load_model as route
    from mlx_audio_tpu_torch.lid.utils import load_model as lid_load
    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.stt import generate as stt_generate
    from mlx_audio_tpu_torch.stt.utils import load_model as stt_load
    from mlx_audio_tpu_torch.tts import generate as tts_generate
    from mlx_audio_tpu_torch.tts.models.outetts import outetts

    t0 = time.perf_counter()
    qmm_kernel.launches = 0
    notes = []
    # the codecs
    clip = _clip_audio(3, 0.1, 24000)
    cpu = _small("dac", DAC_SMALL, "cpu")
    card = _small("dac", DAC_SMALL, DEVICE, like=cpu)
    (zc, cc), (zg, cg) = cpu.encode(clip), card.encode(clip)
    errs = (rel_err(zg.cpu(), zc),
            rel_err(card.decode(card.from_codes(cg)).cpu(),
                    cpu.decode(cpu.from_codes(cc))))
    if not (torch.equal(cg.cpu(), cc) and max(errs) <= OUTE_REL):
        raise AssertionError(f"DAC CUDA vs CPU: codes equal "
                             f"{torch.equal(cg.cpu(), cc)}, rel {errs}")
    notes.append(f"DAC codes equal ({tuple(cc.shape)}), latent and audio "
                 f"rel {max(errs):.1e}")
    cpu = _small("encodec", ENCODEC_SMALL, "cpu")
    card = _small("encodec", ENCODEC_SMALL, DEVICE, like=cpu)
    cc, cg = cpu.encode(clip[:640]), card.encode(clip[:640])
    err = rel_err(card.decode(cg).cpu(), cpu.decode(cc))
    if not (torch.equal(cg.cpu(), cc) and err <= OUTE_REL):
        raise AssertionError(f"EnCodec CUDA vs CPU: codes equal "
                             f"{torch.equal(cg.cpu(), cc)}, audio rel {err}")
    notes.append(f"EnCodec codes equal ({tuple(cc.shape)}), audio rel "
                 f"{err:.1e}")
    # OuteTTS, dense, then MLX-packed q8 on K2
    cpu = _outetts_small("cpu")
    card = _outetts_small(DEVICE, like=cpu)
    (tc, ac), (tg, ag) = _outetts_greedy(cpu), _outetts_greedy(card)
    err = rel_err(ag, ac) if len(ac) and ag.shape == ac.shape else 1.0
    if not (tg == tc and len(tc) == 40 and err <= OUTE_REL):
        raise AssertionError(f"OuteTTS CUDA vs CPU: tokens equal {tg == tc}, "
                             f"audio {ag.shape} vs {ac.shape} rel {err}")
    notes.append(f"OuteTTS 40 greedy tokens equal, DAC audio ({len(ac)} "
                 f"samples) rel {err:.1e}")
    d8 = tmp / "outetts-q8"
    write_outetts_checkpoint(cpu, d8, bits=8)
    with recorder:
        q8 = _load_outetts(d8, DEVICE)
        held = sum(isinstance(m, QuantizedLinear) for m in q8.modules())
        k2 = qmm_kernel.launches
        t8, a8 = _outetts_greedy(q8)
        k2 = qmm_kernel.launches - k2
    with K2AsReference():
        tr, ar = _outetts_greedy(q8)
    tq, aq = _outetts_greedy(_load_outetts(d8, "cpu"))
    n_linears = 7 * OUTE_SMALL["num_hidden_layers"] + 1       # + lm_head
    err = rel_err(a8, aq) if len(aq) and a8.shape == aq.shape else 1.0
    if not (held == n_linears and t8 == tr == tq and err <= OUTE_REL
            and k2 > 0):
        raise AssertionError(f"q8 OuteTTS: {held} quantized linears (want "
                             f"{n_linears}), K2 tokens equal the plain "
                             f"version's {t8 == tr}, the CPU's {t8 == tq}, "
                             f"audio rel {err}, {k2} K2 launches")
    notes.append(f"MLX-packed q8 OuteTTS through load_model: {held} linears "
                 f"on K2 ({k2} launches over a greedy decode and generate), "
                 f"tokens equal to qmatmul_reference's and the CPU's")
    # Pocket-TTS at temperature 0
    cpu = _small("pocket", POCKET_SMALL, "cpu")
    card = _small("pocket", POCKET_SMALL, DEVICE, like=cpu)
    for m in (cpu, card):
        m.tokenizer = PocketTok()
    (lc, pc), (lg, pg) = _pocket_frames(cpu), _pocket_frames(card)
    errs = (rel_err(lg, lc), rel_err(pg, pc))
    if not (lg.shape == lc.shape == (9, 1, 8) and max(errs) <= OUTE_REL):
        raise AssertionError(f"Pocket-TTS CUDA vs CPU: frames {lg.shape} vs "
                             f"{lc.shape}, rel {errs}")
    notes.append(f"Pocket-TTS {len(lc)} frames at temperature 0, rel "
                 f"{max(errs):.1e}")
    # MMS, wav2vec2 LID, ECAPA LID
    speech = _noise(4, 1.0)
    cpu = _small("mms", MMS_SMALL, "cpu")
    card = _small("mms", MMS_SMALL, DEVICE, like=cpu)
    ids = cpu.transcribe_ids(speech)
    if card.transcribe_ids(speech) != ids or not ids:
        raise AssertionError("MMS CUDA vs CPU: CTC ids differ")
    mms_cpu = cpu
    lid_cpu = _small("lid", LID_SMALL, "cpu")
    ecapa_cpu = _small("ecapa", ECAPA_SMALL, "cpu")
    for cpu, kind, cfg in ((lid_cpu, "lid", LID_SMALL),
                           (ecapa_cpu, "ecapa", ECAPA_SMALL)):
        card = _small(kind, cfg, DEVICE, like=cpu)
        want, got = cpu.predict(speech, top_k=3), card.predict(speech,
                                                              top_k=3)
        err = max(abs(a[1] - b[1]) for a, b in zip(got, want))
        if [g[0] for g in got] != [w[0] for w in want] or err > OUTE_REL:
            raise AssertionError(f"{kind} LID CUDA vs CPU: {got} vs {want}")
    notes.append(f"MMS CTC ids equal ({len(ids)}), wav2vec2 and ECAPA LID "
                 f"top-3 equal, probabilities within {OUTE_REL:g}")
    # the loaders and the CLIs on the card
    d_oute = tmp / "outetts-tiny"
    write_outetts_checkpoint(_outetts_small("cpu"), d_oute)
    d_mms = tmp / "mms-1b-tiny"
    _write_state(mms_cpu, d_mms, MMS_SMALL)
    (d_mms / "vocab.json").write_text(json.dumps(MMS_SMALL_VOCAB))
    d_lid = tmp / "mms-lid-tiny"
    _write_state(lid_cpu, d_lid, LID_SMALL)
    d_ecapa = tmp / "voxlingua107-ecapa-tiny"
    _write_state(ecapa_cpu, d_ecapa, ECAPA_SMALL, jax_tree=True)
    oute = _load_outetts(d_oute, DEVICE)
    mms = stt_load(d_mms, device=DEVICE)
    lid = route(d_lid, device=DEVICE)
    ecapa = lid_load(d_ecapa, device=DEVICE)
    kinds = [type(m).__module__.rsplit(".", 2)[-2]
             for m in (oute, mms, lid, ecapa, route(d_oute, device=DEVICE),
                       route(d_ecapa, device=DEVICE))]
    if kinds != ["outetts", "mms", "wav2vec2", "ecapa_tdnn", "outetts",
                 "ecapa_tdnn"] or _outetts_greedy(oute)[0] != tc \
            or mms.transcribe_ids(speech) != ids \
            or [p[0] for p in lid.predict(speech, top_k=3)] != \
            [p[0] for p in lid_cpu.predict(speech, top_k=3)] \
            or [p[0] for p in ecapa.predict(speech, top_k=3)] != \
            [p[0] for p in ecapa_cpu.predict(speech, top_k=3)]:
        raise AssertionError(f"the loaders on the card: {kinds}")
    notes.append("tts.utils, stt.utils, lid.utils and the top-level "
                 "load_model on tiny directories (outetts, mms, wav2vec2 "
                 "and ecapa_tdnn LID), each as the CPU model")
    prev = outetts.local_tokenizer
    outetts.local_tokenizer = lambda path: OuteTok(**OUTE_SMALL_IDS)
    try:
        tts_generate.main([
            "--model", str(d_oute), "--text", OUTE_TEXT, "--temperature",
            "0", "--max_tokens", "40", "--seed", "0", "--output_path",
            str(tmp / "oute-cli"), "--no-verbose", "--device", DEVICE])
    finally:
        outetts.local_tokenizer = prev
    want = np.concatenate([r.audio for r in oute.generate(
        OUTE_TEXT, temperature=0.0, max_tokens=40, seed=0, top_p=0.9,
        top_k=50, repetition_penalty=1.0)])
    wav, sr = audio_io.read(str(tmp / "oute-cli" / "audio_000.wav"),
                            dtype="float32")
    err = float(np.abs(wav - np.clip(want, -1, 1)).max()) if len(
        wav) == len(want) else float("inf")
    wav16 = tmp / "speech.wav"
    audio_io.write(wav16, speech, 16000)
    stt_generate.main(["--model", str(d_mms), "--audio", str(wav16),
                       "--no-verbose", "--output-path", str(tmp / "mms")])
    text = (tmp / "mms" / "transcription.txt").read_text().strip()
    if not (sr == 24000 and err <= 2 / 32768
            and text == mms.generate(str(wav16)).text):
        raise AssertionError(f"the CLIs: TTS WAV {len(wav)} vs {len(want)} "
                             f"samples, max error {err:.3e}; STT {text!r}")
    notes.append(f"the TTS CLI wrote OuteTTS's generate() audio ({len(wav)} "
                 f"samples, max error {err:.1e}), the STT CLI MMS's text")
    launches = qmm_kernel.launches
    log(f"[outetts-lid small] {'; '.join(notes)}")
    log(f"[time] phase 45 in {time.perf_counter() - t0:.1f} s; K2 launched "
        f"{launches} times")
    return launches


def build_outetts_full():
    """Llama-OuteTTS-1.0-1B (OUTE_1B) drawn on the card in f32 from seed 0
    tensor by tensor, the tied table's code rows scaled by
    OUTE_CODE_SCALE, cast in place to bf16; the 24-kHz DAC in f32 from seed
    1; the stand-in tokenizer."""
    import torch

    from mlx_audio_tpu_torch.codec.models.descript import DAC
    from mlx_audio_tpu_torch.tts.models.outetts import Model

    t0 = time.perf_counter()
    model = Model(OUTE_1B, device=DEVICE).init_params(seed=0, on_device=True)
    _scale_outetts_codes(model, OUTE_1B_IDS)
    model.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    model.tokenizer = OuteTok(**OUTE_1B_IDS)
    model.set_codec(DAC(DAC_24KHZ, device=DEVICE).init_params(
        seed=1, on_device=True))
    torch.cuda.synchronize()
    log(f"[outetts] Llama-OuteTTS-1.0-1B dims: {model.num_params():,} params "
        f"bf16 (tied head, vocabulary {OUTE_1B['vocab_size']:,}) and the "
        f"24-kHz DAC {model.codec.num_params():,} params f32 on cuda, built "
        f"in {time.perf_counter() - t0:.2f} s")
    return model


def _outetts_profile(model, ids) -> tuple:
    """PROFILE_STEPS sampled steps unprofiled, then as many under
    torch.profiler, after a prefill. -> (kernels a token, device ms a
    token, wall ms a token unprofiled, busy share)."""
    import torch

    from mlx_audio_tpu_torch.ops.sampling import sample

    logits, caches, _ = model.prefill(ids, 4 * PROFILE_STEPS)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(0)
    state = {"logits": logits, "caches": caches,
             "history": torch.full((1, model.rep_window), -1,
                                   dtype=torch.long, device=dev),
             "done": torch.zeros(1, dtype=torch.bool, device=dev),
             "t": len(ids)}
    stops = torch.tensor(model.stop_ids(), device=dev)

    def chunk():
        model.chunk(state, PROFILE_STEPS, lambda lg: sample(
            lg, 0.4, top_k=40, top_p=0.9, min_p=0.05, generator=gen),
            stops, 1.1).cpu()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk()
    wall = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    rows = _device_kernels(chunk, cpu=False)
    device = sum(_dev_us(e) for e in rows) / 1e3 / PROFILE_STEPS
    kernels = sum(e.count for e in rows) / PROFILE_STEPS
    if not (kernels > 0 and device > 0):
        raise AssertionError("OuteTTS: the profiler saw no kernel")
    return kernels, device, wall, device / wall


def _outetts_run(model, label: str, card: str, base: int,
                 stream: bool) -> dict:
    """A 32-token warm-up; one request of OUTE_TOKENS tokens at OuteTTS's
    sampling (ms a token p50 and p95 over its chunks after the first, the
    code share, wall, xRT); with `stream`, the same request streamed every
    OUTE_INTERVAL s (time to first audio); the DAC's ms on the request's
    codes; a profiled stretch. -> the numbers, and the decode steps and
    prefills run in all."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.tts.models.llama import orpheus

    laps = Laps(f"outetts {label}")
    kw = dict(seed=0)
    list(model.generate(OUTE_LONG_TEXT, max_tokens=WARM_STEPS, **kw))
    steps, prefills = model.last_run["steps"], 1
    laps("warm-up")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = list(model.generate(OUTE_LONG_TEXT, max_tokens=OUTE_TOKENS, **kw))
    wall = time.perf_counter() - t0
    laps("the request")
    run = dict(model.last_run)
    steps, prefills = steps + run["steps"], prefills + 1
    samples = sum(r.samples for r in res)
    per_token = np.asarray(run["chunk_ms"][1:]) / orpheus.CHUNK
    share = run["code_tokens"] / max(run["tokens"], 1)
    if not (run["steps"] == OUTE_TOKENS and samples > 0
            and all(np.isfinite(r.audio).all() for r in res)):
        raise AssertionError(f"OuteTTS {label}: {run}, {samples} samples")
    # the DAC's decode of as many frames, seeded codes
    dac = model.codec
    frames = samples // dac.hop_length
    c = torch.as_tensor(np.random.RandomState(0).randint(
        0, 1024, (1, 2, frames)), device=DEVICE)
    dac.decode(dac.from_codes(c))
    dac_s = _sync_s(lambda: dac.decode(dac.from_codes(c)))[1]
    out = dict(wall=wall, samples=samples, share=share, dac_ms=dac_s * 1e3,
               frames=frames,
               p50=float(np.percentile(per_token, 50)),
               p95=float(np.percentile(per_token, 95)))
    if stream:
        t0 = time.perf_counter()
        first = None
        n = 0
        for r in model.generate(OUTE_LONG_TEXT, max_tokens=OUTE_TOKENS,
                                stream=True, streaming_interval=OUTE_INTERVAL,
                                **kw):
            first = first or time.perf_counter() - t0
            n += r.samples
        out.update(ttfa=first, s_wall=time.perf_counter() - t0,
                   s_samples=n)
        steps, prefills = steps + model.last_run["steps"], prefills + 1
        if not (first and n > 0):
            raise AssertionError(f"OuteTTS {label}: the stream yielded no "
                                 f"audio")
        laps("streamed")
    out["peak"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    ids = np.asarray(model.tokenizer.encode(
        model._processor().get_completion_prompt(OUTE_LONG_TEXT)), np.int32)
    kernels, dev_ms, prof_wall, busy = _outetts_profile(model, ids)
    steps, prefills = steps + 2 * PROFILE_STEPS, prefills + 1
    laps("profiled steps")
    laps.log()
    cols = run["prompt_bucket"] + OUTE_TOKENS / 2
    bound = orpheus_token_bytes(model, cols) / HBM_BPS * 1e3
    audio_s = samples / model.sample_rate
    out.update(xrt=audio_s / wall, kernels=kernels, dev_ms=dev_ms, busy=busy,
               bound=bound, steps=steps, prefills=prefills,
               nbytes=orpheus_token_bytes(model, cols))
    log(f"[outetts] {label}: {OUTE_TOKENS} tokens ({run['prompt_len']}-token "
        f"prompt, bucket {run['prompt_bucket']}): {out['p50']:.2f} ms a token "
        f"p50, {out['p95']:.2f} p95 (over {len(per_token)} chunks of "
        f"{orpheus.CHUNK}), {100 * share:.1f}% of the tokens codes, "
        f"{out['frames']} DAC frames, {audio_s:.2f} s of audio in {wall:.2f} "
        f"s (xRT {out['xrt']:.3f}), the DAC's decode of them "
        f"{out['dac_ms']:.2f} ms"
        + (f"; streamed every {OUTE_INTERVAL:g} s: first audio "
           f"{out['ttfa']:.3f} s, wall {out['s_wall']:.2f} s, "
           f"{out['s_samples']} samples (the whole request's {samples}; "
           f"every interval decodes every code so far)" if stream else "")
        + f"; peak {out['peak']:.2f} GB above the earlier phases'; profiled "
        f"{PROFILE_STEPS} steps: {kernels:.0f} kernels and {dev_ms:.3f} ms "
        f"of device time a token against {prof_wall:.2f} ms of wall "
        f"({100 * busy:.1f}% busy); {out['nbytes'] / 1e9:.3f} GB a token, "
        f"bound {bound:.3f} ms (bytes), {100 * bound / out['p50']:.1f}% of it "
        f"reached at p50 ({card})")
    return out


def phase_outetts_full(card: str, recorder: K2Recorder) -> int:
    """Phase 46: Llama-OuteTTS-1.0-1B at its published dims in bf16 over
    the 24-kHz DAC (a request whole and streamed), then its weights packed
    to MLX's 8-bit layout in memory and loaded through the pre-quantized
    path (every linear on K2, the tied table dense): the 112 linears alone
    at M = 1 against their byte bound, the request again, K2's launches a
    token read from its counter against 16 x 7, the first step's logits
    q8 against bf16. -> K2's launches, as its counter read them."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.nn import Embedding, QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.utils import (apply_quantization,
                                           unpack_prequantized)

    t_phase = time.perf_counter()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    base = torch.cuda.memory_allocated()
    model = build_outetts_full()
    ids = np.asarray(model.tokenizer.encode(
        model._processor().get_completion_prompt(OUTE_LONG_TEXT)), np.int32)
    logits_bf16 = model.prefill(ids, 32)[0]
    bf16 = _outetts_run(model, "bf16", card, base, stream=True)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the bf16 OuteTTS launched K1 or K2")
    t1 = time.perf_counter()
    packed = pack_mlx_in_memory(model, 8)
    torch.cuda.empty_cache()
    config = {"quantization": {"group_size": MLX_GROUP, "bits": 8}}
    flat = unpack_prequantized(model, config, packed)
    del packed
    model.bind(flat)
    del flat
    apply_quantization(model, config, pre_quantized=True)
    torch.cuda.empty_cache()
    per_token = 7 * OUTE_1B["num_hidden_layers"]
    held = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    if held != per_token or not isinstance(model.model.embed_tokens,
                                           Embedding):
        raise AssertionError(f"q8 OuteTTS holds {held} quantized linears "
                             f"(want {per_token}) or a quantized table")
    log(f"[outetts] packed to MLX 8-bit (group {MLX_GROUP}) in memory and "
        f"loaded through the pre-quantized path in "
        f"{time.perf_counter() - t1:.2f} s: {held} linears on K2, the tied "
        f"table dense")
    k2_linears_alone(model, card, "outetts")
    k1 = snake_conv_kernel.launches
    qmm_kernel.launches = 0
    with recorder:
        logits_q8 = model.prefill(ids, 32)[0]
        q8 = _outetts_run(model, "q8 (K2)", card, base, stream=False)
    k2 = qmm_kernel.launches
    rel = float(torch.linalg.norm(logits_q8 - logits_bf16)
                / torch.linalg.norm(logits_bf16))
    top1 = int(logits_q8.argmax()) == int(logits_bf16.argmax())
    want = per_token * (1 + q8["steps"] + q8["prefills"])
    if k2 != want or snake_conv_kernel.launches != k1:
        raise AssertionError(f"q8 OuteTTS: {k2} K2 launches for "
                             f"{q8['steps']} decode steps and "
                             f"{1 + q8['prefills']} prefills, want {want}; "
                             f"or K1 launched")
    if not (torch.isfinite(logits_q8).all() and rel < ASR_Q8_REL):
        raise AssertionError(f"q8 OuteTTS first-step logits vs bf16: "
                             f"relative {rel:.3e}")
    log(f"[outetts] q8 against bf16 on this card: {q8['p50']:.2f} vs "
        f"{bf16['p50']:.2f} ms a token p50, {q8['p95']:.2f} vs "
        f"{bf16['p95']:.2f} p95, xRT {q8['xrt']:.3f} vs {bf16['xrt']:.3f}, "
        f"{q8['kernels']:.0f} vs {bf16['kernels']:.0f} kernels and "
        f"{q8['dev_ms']:.3f} vs {bf16['dev_ms']:.3f} ms of device time a "
        f"token, busy {100 * q8['busy']:.1f}% vs {100 * bf16['busy']:.1f}%, "
        f"{q8['nbytes'] / 1e9:.3f} vs {bf16['nbytes'] / 1e9:.3f} GB a token, "
        f"bound {q8['bound']:.3f} vs {bf16['bound']:.3f} ms, peak "
        f"{q8['peak']:.2f} vs {bf16['peak']:.2f} GB; K2 launched {k2} times "
        f"over {q8['steps']} decode steps and {1 + q8['prefills']} prefills "
        f"(the comparison's included): "
        f"{k2 // (1 + q8['steps'] + q8['prefills'])} a token, read from its "
        f"counter (the config gives {per_token}); first-step logits q8 vs "
        f"bf16 relative {rel:.3e} (limit {ASR_Q8_REL:g}), top-1 "
        f"{'equal' if top1 else 'differs'} ({card})")
    del model
    torch.cuda.empty_cache()
    log(f"[time] phase 46 in {time.perf_counter() - t_phase:.1f} s")
    return k2


def phase_pocket_encodec_full(card: str) -> None:
    """Phase 47: Pocket-TTS at the JAX package's ModelConfig() (a 12 x
    d1024 flow LM, a 1,024 x 6 flow net, an 8,000-bin table, the default
    Mimi) drawn on the card in f32 from seed 0, EOS biased off: one
    sentence from the default 0.5-s silent voice, run to max_gen (ms a
    frame p50 and p95 against the 80-ms frame, realtime factor, kernels a
    frame); EnCodec at its 24-kHz dims in f32: a round trip of
    ENCODEC_SECONDS (ms, xRT)."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.codec.models.encodec import Encodec
    from mlx_audio_tpu_torch.tts.models.pocket_tts import Model
    from mlx_audio_tpu_torch.tts.models.pocket_tts.pocket_tts import \
        split_into_best_sentences

    t_phase = time.perf_counter()
    model = Model(dict(model_type="pocket_tts"), device=DEVICE).init_params(
        seed=0, on_device=True)
    with torch.no_grad():
        model.flow_lm.out_eos.bias.fill_(POCKET_EOS_BIAS)
    model.tokenizer = PocketTok()
    n_params = model.num_params()
    voice = np.zeros(int(0.5 * model.sample_rate), np.float32)
    (chunk,) = split_into_best_sentences(model.tokenizer, POCKET_TEXT)
    # a warm-up of a few frames, then the request frame by frame
    state = model.get_state_for_audio_prompt(voice)
    for _, _ in zip(range(3), model.generate_audio_stream(
            state, "Warm up.")):
        pass
    state = model.get_state_for_audio_prompt(voice)
    torch.cuda.synchronize()
    times, samples = [], 0
    t0 = t_last = time.perf_counter()
    for audio in model.generate_audio_stream(state, POCKET_TEXT):
        now = time.perf_counter()
        times.append((now - t_last) * 1e3)
        t_last = now
        samples += len(audio)
        if not np.isfinite(audio).all():
            raise AssertionError("Pocket-TTS: audio not finite")
    wall = time.perf_counter() - t0
    run = dict(model.last_run)
    frame_ms = 1e3 / model.frame_rate
    if not (len(times) == run["max_gen"] and run["eos_step"] is None):
        raise AssertionError(f"Pocket-TTS: {len(times)} frames, {run}")
    # POCKET_PROFILE_FRAMES frames under the profiler
    state = model.get_state_for_audio_prompt(voice)
    frames = model.generate_audio_stream(state, POCKET_TEXT)
    next(frames)
    rows = _device_kernels(lambda: [next(frames) for _ in range(
        POCKET_PROFILE_FRAMES)], cpu=False)
    frames.close()
    kernels = sum(e.count for e in rows) / POCKET_PROFILE_FRAMES
    dev_ms = sum(_dev_us(e) for e in rows) / 1e3 / POCKET_PROFILE_FRAMES
    p50, p95 = np.percentile(times[1:], 50), np.percentile(times[1:], 95)
    audio_s = samples / model.sample_rate
    log(f"[pocket-tts] ModelConfig() ({n_params:,} params f32, flow LM 12 x "
        f"d1024, flow net 1,024 x 6, the default Mimi): {len(times)} frames "
        f"of a {len(POCKET_TEXT.split())}-word sentence "
        f"({len(model.tokenizer.encode(chunk))} text tokens) from a 0.5-s "
        f"silent voice: {p50:.2f} ms a frame p50, {p95:.2f} p95 against the "
        f"{frame_ms:.0f}-ms frame, {audio_s:.2f} s of audio in {wall:.2f} s "
        f"(realtime factor {audio_s / wall:.2f}); profiled "
        f"{POCKET_PROFILE_FRAMES} frames: {kernels:.0f} kernels and "
        f"{dev_ms:.3f} ms of device time a frame ({card})")
    del model, state
    torch.cuda.empty_cache()
    codec = Encodec(dict(model_type="encodec"), device=DEVICE).init_params(
        seed=0, on_device=True)
    clip = _clip_audio(5, ENCODEC_SECONDS, codec.sample_rate)
    codec.decode(codec.encode(clip[:24000]))
    (codes, enc_s) = _sync_s(lambda: codec.encode(clip))
    audio, dec_s = _sync_s(lambda: codec.decode(codes))
    if not (codes.shape == (1, 32, ENCODEC_SECONDS * 75)
            and audio.shape[1] >= len(clip)
            and torch.isfinite(audio).all()):
        raise AssertionError(f"EnCodec: codes {tuple(codes.shape)}, audio "
                             f"{tuple(audio.shape)}")
    log(f"[encodec] 24-kHz dims ({codec.num_params():,} params f32, 32 "
        f"filters, ratios [8, 5, 4, 2], two LSTM layers, 32 codebooks): "
        f"{ENCODEC_SECONDS} s encoded in {enc_s * 1e3:.1f} ms and decoded in "
        f"{dec_s * 1e3:.1f} ms, round trip xRT "
        f"{ENCODEC_SECONDS / (enc_s + dec_s):.1f} ({card})")
    del codec
    torch.cuda.empty_cache()
    log(f"[time] phase 47 in {time.perf_counter() - t_phase:.1f} s")


def wav2vec2_flops(cfg: dict, samples: int) -> float:
    """Operations of one wav2vec2 forward over `samples`: the conv feature
    encoder, the projection, the positional conv and each layer's
    projections, attention and FFN (2 a multiply-add)."""
    from mlx_audio_tpu_torch.stt.models.wav2vec import ModelConfig

    c = ModelConfig.from_dict(cfg)
    ops, n, cin = 0.0, samples, 1
    for dim, k, s in zip(c.conv_dim, c.conv_kernel, c.conv_stride):
        n = (n - k) // s + 1
        ops += 2 * n * k * cin * dim
        cin = dim
    h = c.hidden_size
    ops += 2 * n * cin * h
    ops += 2 * n * c.num_conv_pos_embeddings * h * h \
        / c.num_conv_pos_embedding_groups
    ops += c.num_hidden_layers * (2 * n * 4 * h * h + 4 * n * n * h
                                  + 4 * n * h * c.intermediate_size)
    return ops


def phase_mms_lid_full(card: str) -> None:
    """Phase 48: MMS-1b-all (MMS_1B) on MMS_SECONDS of `randn * 0.1`, in
    bf16 and f32 (ms, xRT, the share of 989 TFLOP/s by counted operations,
    CTC ids bf16 against f32); MMS-LID-256 on MMS_LID_SECONDS (top-1 equal
    between bf16 and f32); ECAPA VoxLingua107 on ECAPA_SECONDS in f32
    (ms). All drawn on the card from seed 0."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.lid.models import ecapa_tdnn, wav2vec2
    from mlx_audio_tpu_torch.stt.models.mms import Model
    from mlx_audio_tpu_torch.stt.models.mms.mms import padded_wave

    t_phase = time.perf_counter()
    model = Model(MMS_1B, device=DEVICE).init_params(seed=0, on_device=True)
    audio = _noise(6, MMS_SECONDS)
    wave, n = padded_wave(audio, DEVICE)
    ids32, frames = model.forward_ids(wave, n)
    ms32 = _sync_ms(lambda: model.forward_ids(wave, n), reps=1)
    model.astype(torch.bfloat16)
    model.forward_ids(wave, n)
    ms16 = _sync_ms(lambda: model.forward_ids(wave, n), reps=1)
    ids16 = model.forward_ids(wave, n)[0]
    f = int(frames[0])
    agree = float((ids16[0, :f] == ids32[0, :f]).float().mean())
    text16 = model.transcribe_ids(audio)
    flops = wav2vec2_flops(MMS_1B, wave.shape[1])
    if not (agree >= MMS_BF16_AGREE and text16):
        raise AssertionError(f"MMS bf16 vs f32: {agree:.3f} of the frames' "
                             f"CTC ids agree (limit {MMS_BF16_AGREE})")
    log(f"[mms] MMS-1b-all dims ({model.num_params():,} params: 48 layers at "
        f"d1280, adapters of 16) on {MMS_SECONDS} s ({f} frames): bf16 "
        f"{ms16:.1f} ms (xRT {MMS_SECONDS * 1e3 / ms16:.0f}, "
        f"{flops / 1e12:.2f} TFLOP: {100 * flops / PEAK_BF16 * 1e3 / ms16:.1f}"
        f"% of 989 TFLOP/s), f32 {ms32:.1f} ms; CTC ids bf16 vs f32 agree on "
        f"{100 * agree:.1f}% of the frames, {len(text16)} ids after the "
        f"collapse ({card})")
    del model
    torch.cuda.empty_cache()
    lid = wav2vec2.Model(MMS_LID_256, device=DEVICE).init_params(
        seed=0, on_device=True)
    clip = _noise(7, MMS_LID_SECONDS)
    top32 = lid.predict(clip, top_k=3)
    ms32 = _sync_ms(lambda: lid.predict(clip, top_k=3), reps=1)
    lid.astype(torch.bfloat16)
    top16 = lid.predict(clip, top_k=3)
    ms16 = _sync_ms(lambda: lid.predict(clip, top_k=3), reps=1)
    if top16[0][0] != top32[0][0]:
        raise AssertionError(f"MMS-LID top-1 bf16 {top16[0]} vs f32 "
                             f"{top32[0]}")
    log(f"[mms-lid] MMS-LID-256 dims ({lid.num_params():,} params, projector "
        f"1,024, 256 labels) on {MMS_LID_SECONDS} s: bf16 {ms16:.1f} ms, f32 "
        f"{ms32:.1f} ms; top-1 {top16[0][0]} in both "
        f"({top16[0][1]:.4f} vs {top32[0][1]:.4f}) ({card})")
    del lid
    torch.cuda.empty_cache()
    ecapa = ecapa_tdnn.Model(ECAPA_VOXLINGUA, device=DEVICE).init_params(
        seed=0, on_device=True)
    clip = _noise(8, ECAPA_SECONDS)
    preds = ecapa.predict(clip, top_k=3)
    ms = _sync_ms(lambda: ecapa.predict(clip, top_k=3), reps=1)
    if not (len(preds) == 3 and all(np.isfinite(p) for _, p in preds)):
        raise AssertionError(f"ECAPA LID: {preds}")
    log(f"[ecapa-lid] VoxLingua107 dims ({ecapa.num_params():,} params, "
        f"channels 1,024, embedding 256, 107 languages) on {ECAPA_SECONDS} s "
        f"in f32: {ms:.1f} ms with the log-mel (xRT "
        f"{ECAPA_SECONDS * 1e3 / ms:.0f}), top-1 probability "
        f"{preds[0][1]:.4f} ({card})")
    del ecapa
    torch.cuda.empty_cache()
    log(f"[time] phase 48 in {time.perf_counter() - t_phase:.1f} s")


def phase_outetts_lid(card: str, recorder: K2Recorder) -> int:
    """Phases 45-48; K1 never launches, K2 only on the q8 OuteTTS models.
    -> K2's launches there."""
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    t0 = time.perf_counter()
    k1 = snake_conv_kernel.launches
    with tempfile.TemporaryDirectory() as tmp:
        k2 = phase_outetts_lid_reference(Path(tmp), recorder)
    torch.cuda.empty_cache()
    k2 += phase_outetts_full(card, recorder)
    before = qmm_kernel.launches
    phase_pocket_encodec_full(card)
    phase_mms_lid_full(card)
    if snake_conv_kernel.launches != k1 or qmm_kernel.launches != before:
        raise AssertionError("phases 45-48 launched K1, or K2 outside the "
                             "q8 OuteTTS")
    log(f"[time] phases 45-48 in {time.perf_counter() - t0:.1f} s; K1 not "
        f"launched")
    return k2


# ---------------------------------------------------------------------------
# Phases 49-52: the Kaldi fbank families
# ---------------------------------------------------------------------------

# the JAX tests' tiny configs (tests/test_fsmn.py, test_sensevoice.py,
# test_fireredasr2.py, test_mossformer2_se.py); Fun-ASR-Nano's at LM widths
# group 64 divides (K2), d64 with 4 heads and 2 KV heads of 16
FSMN_SMALL = dict(model_type="fsmn", n_mels=8, lfr_m=5, lfr_n=1,
                  encoder=dict(input_dim=40, input_affine_dim=16,
                               fsmn_layers=2, linear_dim=24, proj_dim=8,
                               lorder=4, output_affine_dim=16,
                               output_dim=12))
SV_SMALL = dict(model_type="sensevoice", vocab_size=64, input_size=40,
                encoder_conf=dict(output_size=16, attention_heads=2,
                                  linear_units=32, num_blocks=2, tp_blocks=1,
                                  kernel_size=5),
                frontend_conf=dict(n_mels=8, lfr_m=5, lfr_n=3))
FUN_SMALL = dict(
    model_type="fun_asr_nano", input_size=24,
    frontend_conf=dict(n_mels=8, lfr_m=3, lfr_n=2),
    audio_encoder_conf=dict(output_size=32, attention_heads=4,
                            linear_units=64, num_blocks=2, tp_blocks=1,
                            kernel_size=5),
    audio_adaptor_conf=dict(downsample_rate=2, ffn_dim=48, llm_dim=64,
                            encoder_dim=32, n_layer=1, attention_heads=4),
    llm_config=dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=16,
                    tie_word_embeddings=True))
FIRE_SMALL = dict(model_type="fireredasr2", idim=32, odim=50, d_model=32,
                  sos_id=3, eos_id=4,
                  encoder=dict(n_layers=2, n_head=4, d_model=32,
                               kernel_size=9),
                  decoder=dict(n_layers=2, n_head=4, d_model=32))
MOSS_SMALL = dict(model_type="mossformer2_se", sample_rate=8000,
                  win_len=256, win_inc=128, fft_len=256, num_mels=20,
                  in_channels=60, out_channels=32, out_channels_final=129,
                  num_blocks=2, group_size=16, query_key_dim=64,
                  fsmn_inner=16, fsmn_lorder=3, one_time_decode_length=2,
                  decode_window=1, chunk_seconds=1.0,
                  auto_chunk_threshold=8.0)
# Fun-ASR-Nano-2512: the SenseVoice encoder (d512, 4 heads, FFN 2,048,
# 50 + 20 blocks, kernel 11), the 2-block d1,024 adaptor (8 heads, its
# projector's FFN 2,048) and Qwen3-0.6B (the JAX package's defaults with
# Qwen3-0.6B's text config)
FUN_NANO = dict(model_type="fun_asr_nano", llm_config=dict(
    QWEN3_06B_TEXT, rope_theta=1000000.0))
# the request 64 tokens (128 until phases 58-61)
FUN_TOKENS, FUN_SECONDS = 64, 30
SV_SECONDS, FIRE_SECONDS, FIRE_STEPS = 30, 10, 64
MOSS_CLIPS, FSMN_SECONDS = (10, 30), 60
# card against CPU at f32 on the small configs: relative, as OUTE_REL
KALDI_REL = 1e-4
# the small FSMN's output layer is scaled so that its sil scores sit far
# from the decision thresholds; the small FireRed's output norm is biased
# toward EOS (tests/test_torch_fireredasr2.py) so that beams end apart
FSMN_OUT_SCALE, FIRE_EOS_BIAS = 8.0, 4.0


def _kaldi_small(kind: str, device: str, like=None):
    """A small FSMN, SenseVoice, Fun-ASR-Nano, FireRedASR2 or
    MossFormer2-SE on `device`: seeded from 0 (FSMN's output layer scaled,
    FireRed's output norm biased toward EOS), or `like`'s weights."""
    import importlib

    import torch

    module, cfg = {"fsmn": ("vad.models.fsmn", FSMN_SMALL),
                   "sensevoice": ("stt.models.sensevoice", SV_SMALL),
                   "fun": ("stt.models.fun_asr_nano", FUN_SMALL),
                   "fire": ("stt.models.fireredasr2", FIRE_SMALL),
                   "moss": ("sts.models.mossformer2_se", MOSS_SMALL)}[kind]
    m = importlib.import_module(f"mlx_audio_tpu_torch.{module}")
    model = m.Model(dict(cfg), device=device)
    if like is not None:
        model.load_state_dict(like.state_dict())
    else:
        model.init_params(seed=0)
        with torch.no_grad():
            if kind == "fsmn":
                model.encoder.out_linear2.weight.mul_(FSMN_OUT_SCALE)
            elif kind == "fire":
                dec = model.decoder
                dec.layer_norm_out.bias.copy_(
                    dec.tgt_word_prj.weight[cfg["eos_id"]] * FIRE_EOS_BIAS)
    if kind == "fun":
        model._tokenizer = AsrTok(SMALL_SPECIAL_IDS, n_chars=100)
    return model


def _write_kaldi_dir(model, path: Path, config: dict, bits=None,
                     packed=("llm.model",)) -> None:
    """`model` as a checkpoint directory: its torch-layout state in npz
    and its config; with `bits`, the weights under the `packed` prefixes
    MLX-packed."""
    import numpy as np

    path.mkdir(parents=True)
    if bits:
        flat = pack_mlx_in_memory(model, bits, lambda k, v: k.startswith(
            tuple(packed)))
        config = dict(config, quantization={"group_size": MLX_GROUP,
                                            "bits": bits})
    else:
        flat = model.state_dict()
    np.savez(path / "model.npz",
             **{k: v.detach().cpu().numpy() for k, v in flat.items()})
    (path / "config.json").write_text(json.dumps(config))


def phase_kaldi_reference(tmp: Path, recorder: K2Recorder) -> int:
    """Phase 49: the small configs at f32 from one seeded weight set, the
    card against the CPU: the Kaldi fbank (16 kHz at int16 scale, 48 kHz
    dithered), deltas and `ISTFTCache`; FSMN `detect` and a session fed in
    pieces; SenseVoice's CTC ids and rich tags; Fun-ASR-Nano's greedy
    tokens, and an MLX-packed q8 Fun-ASR-Nano through `stt.utils` (every
    LM linear on K2: tokens equal to the same model through
    `qmatmul_reference` and to the CPU's); FireRedASR2's beam-3 tokens and
    scores; MossFormer2-SE's `enhance`; then tiny directories through the
    `vad`, `stt` and `sts` loaders and the top-level `load_model` on the
    card, the STT CLI on SenseVoice and the STS CLI on MossFormer2-SE
    against in-process `generate`. -> K2's launches, as its counter read
    them."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch import audio_io, dsp
    from mlx_audio_tpu_torch import load_model as route
    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.sts import generate as sts_generate
    from mlx_audio_tpu_torch.sts.utils import load_model as sts_load
    from mlx_audio_tpu_torch.stt import generate as stt_generate
    from mlx_audio_tpu_torch.stt.utils import load_model as stt_load
    from mlx_audio_tpu_torch.vad.utils import load_model as vad_load

    t0 = time.perf_counter()
    qmm_kernel.launches = 0
    notes = []
    # the DSP
    speech = _noise(49, 2.0)
    fb = [dsp.compute_fbank_kaldi(speech * 32768.0, sample_rate=16000,
                                  win_len=400, win_inc=160, num_mels=80,
                                  dither=0.0, device=d) for d in (DEVICE,
                                                                  "cpu")]
    x48 = _clip_audio(49, 1.0, 48000) * 32768.0
    fb48 = [dsp.compute_fbank_kaldi(x48, device=d) for d in (DEVICE, "cpu")]
    deltas = [dsp.compute_deltas_kaldi(f.T, 5).T for f in fb48]
    spec = dsp.stft(x48, n_fft=1920, hop_length=384, win_length=1920,
                    window=dsp.hamming(1920), center=False)
    istft = [dsp.ISTFTCache().istft(
        spec.real.T[None].to(d), spec.imag.T[None].to(d), 1920, 384, 1920,
        dsp.hamming(1920), center=False, audio_length=len(x48) - 1920)
        for d in (DEVICE, "cpu")]
    errs = [rel_err(a.cpu(), b) for a, b in (fb, fb48, deltas, istft)]
    trip = rel_err(istft[1][0], torch.as_tensor(x48[:len(x48) - 1920]))
    if max(errs) > KALDI_REL or trip > 1e-4:
        raise AssertionError(f"Kaldi DSP CUDA vs CPU: rel {errs}, ISTFT "
                             f"round trip {trip}")
    notes.append(f"fbank (16 kHz int16, 48 kHz dithered), deltas and "
                 f"ISTFTCache rel {max(errs):.1e}, round trip {trip:.1e}")
    # FSMN
    cpu = _kaldi_small("fsmn", "cpu")
    card = _kaldi_small("fsmn", DEVICE, like=cpu)
    vad_audio = np.concatenate([_noise(50, 0.5, 0.002), _noise(51, 1.0, 0.3),
                                _noise(52, 1.0, 0.002), _noise(53, 0.6, 0.3),
                                _noise(54, 0.5, 0.002)])
    segs = cpu.detect(vad_audio)
    from mlx_audio_tpu_torch.vad.models.fsmn.fsmn import (compute_decibel,
                                                          extract_features)
    sil = card._sil_scores(card.scores(extract_features(
        vad_audio, card.config, None, card.device)))
    db = compute_decibel(vad_audio * 32768.0, 16000, 25, 10)[:len(sil)]
    sil = sil[:len(db)]
    session, streamed = card.create_session(), []
    for i in range(0, len(db), 40):
        streamed += session.feed(sil[i:i + 40], db[i:i + 40],
                                 is_final=i + 40 >= len(db))
    if not (segs and card.detect(vad_audio) == segs == streamed):
        raise AssertionError(f"FSMN CUDA vs CPU: {card.detect(vad_audio)} "
                             f"vs {segs}, streamed {streamed}")
    notes.append(f"FSMN detect {segs} equal, streamed in 40-frame pieces "
                 f"too")
    fsmn_cpu = cpu
    # SenseVoice
    cpu = _kaldi_small("sensevoice", "cpu")
    card = _kaldi_small("sensevoice", DEVICE, like=cpu)
    want = cpu.transcribe_ids(speech)
    if card.transcribe_ids(speech) != want or not want[0]:
        raise AssertionError(f"SenseVoice CUDA vs CPU: "
                             f"{card.transcribe_ids(speech)} vs {want}")
    notes.append(f"SenseVoice {len(want[0])} CTC ids and the tags "
                 f"{want[1]} equal")
    sv_cpu = cpu
    # Fun-ASR-Nano, dense, then MLX-packed q8 on K2
    cpu = _kaldi_small("fun", "cpu")
    card = _kaldi_small("fun", DEVICE, like=cpu)
    kw = dict(max_tokens=24)
    tc = cpu.generate(speech, **kw).text
    if card.generate(speech, **kw).text != tc or len(tc.split()) != 24:
        raise AssertionError("Fun-ASR-Nano CUDA vs CPU: greedy tokens "
                             "differ")
    d8 = tmp / "fun-asr-nano-q8"
    _write_kaldi_dir(cpu, d8, FUN_SMALL, bits=8)
    with recorder:
        q8 = stt_load(d8, device=DEVICE)
        q8._tokenizer = cpu._tokenizer
        held = sum(isinstance(m, QuantizedLinear) for m in q8.modules())
        k2 = qmm_kernel.launches
        t8 = q8.generate(speech, **kw).text
        k2 = qmm_kernel.launches - k2
        steps = q8.last_run["forwards"]
    with K2AsReference():
        tr = q8.generate(speech, **kw).text
    qc = stt_load(d8, device="cpu")
    qc._tokenizer = cpu._tokenizer
    tq = qc.generate(speech, **kw).text
    n_lm = 7 * FUN_SMALL["llm_config"]["num_hidden_layers"]
    if not (held == n_lm and t8 == tr == tq and k2 == n_lm * (1 + steps)):
        raise AssertionError(f"q8 Fun-ASR-Nano: {held} quantized linears "
                             f"(want {n_lm}), K2 tokens equal the plain "
                             f"version's {t8 == tr}, the CPU's {t8 == tq}, "
                             f"{k2} K2 launches over {steps} steps")
    notes.append(f"Fun-ASR-Nano 24 greedy tokens equal; MLX-packed q8 "
                 f"through stt.utils: {held} linears on K2, {k2} launches "
                 f"({n_lm} a forward over a prefill and {steps} steps), "
                 f"tokens equal to qmatmul_reference's and the CPU's")
    fun_cpu = cpu
    # FireRedASR2, beam 3
    cpu = _kaldi_small("fire", "cpu")
    card = _kaldi_small("fire", DEVICE, like=cpu)
    short = speech[:8000]
    oc = cpu.generate(short, beam_size=3)
    rc = dict(cpu.last_run)
    og = card.generate(short, beam_size=3)
    rg = card.last_run
    err = float(np.abs(rg["scores"] - rc["scores"]).max())
    if not (og.text == oc.text and np.array_equal(rg["ys"], rc["ys"])
            and err < 1e-3):
        raise AssertionError(f"FireRedASR2 CUDA vs CPU: {og.text!r} vs "
                             f"{oc.text!r}, scores {rg['scores']} vs "
                             f"{rc['scores']}")
    notes.append(f"FireRedASR2 beam 3: {rc['steps']} steps, hypotheses "
                 f"equal, scores within {err:.1e}")
    fire_cpu = cpu
    # MossFormer2-SE
    cpu = _kaldi_small("moss", "cpu")
    card = _kaldi_small("moss", DEVICE, like=cpu)
    clip = _clip_audio(55, 0.5, 8000)
    ec, eg = cpu.enhance(clip), card.enhance(clip)
    err = rel_err(eg, ec)
    if not (eg.shape == ec.shape and err <= KALDI_REL):
        raise AssertionError(f"MossFormer2-SE CUDA vs CPU: rel {err}")
    notes.append(f"MossFormer2-SE enhance of {len(clip)} samples rel "
                 f"{err:.1e}")
    moss_cpu = cpu
    # the loaders and the CLIs on the card
    dirs = {}
    for name, model, cfg in (("fsmn-vad-tiny", fsmn_cpu, FSMN_SMALL),
                             ("SenseVoiceSmall-tiny", sv_cpu, SV_SMALL),
                             ("Fun-ASR-Nano-tiny", fun_cpu, FUN_SMALL),
                             ("FireRedASR2-AED-tiny", fire_cpu, FIRE_SMALL),
                             ("MossFormer2_SE_48K-tiny", moss_cpu,
                              MOSS_SMALL)):
        dirs[name] = tmp / name
        _write_kaldi_dir(model, dirs[name], cfg)
    loaded = [vad_load(dirs["fsmn-vad-tiny"], device=DEVICE),
              stt_load(dirs["SenseVoiceSmall-tiny"], device=DEVICE),
              stt_load(dirs["Fun-ASR-Nano-tiny"], device=DEVICE),
              stt_load(dirs["FireRedASR2-AED-tiny"], device=DEVICE),
              sts_load(dirs["MossFormer2_SE_48K-tiny"], device=DEVICE)]
    loaded += [route(d, device=DEVICE) for d in dirs.values()]
    kinds = [type(m).__module__.rsplit(".", 1)[-1] for m in loaded]
    want_kinds = ["fsmn", "sensevoice", "fun_asr_nano", "fireredasr2",
                  "mossformer2_se"] * 2
    loaded[2]._tokenizer = fun_cpu._tokenizer
    if kinds != want_kinds or loaded[0].detect(vad_audio) != segs \
            or loaded[1].transcribe_ids(speech) != sv_cpu.transcribe_ids(
                speech) \
            or loaded[2].generate(speech, **kw).text != tc \
            or loaded[3].generate(short, beam_size=3).text != oc.text \
            or rel_err(loaded[4].enhance(clip), ec) > KALDI_REL:
        raise AssertionError(f"the loaders on the card: {kinds}")
    notes.append("vad.utils, stt.utils, sts.utils and the top-level "
                 "load_model on tiny directories (fsmn, sensevoice, "
                 "fun_asr_nano, fireredasr2, mossformer2_se), each as the "
                 "CPU model")
    wav16, wav8 = tmp / "speech16.wav", tmp / "clip8.wav"
    audio_io.write(wav16, speech, 16000)
    audio_io.write(wav8, clip, 8000)
    stt_generate.main(["--model", str(dirs["SenseVoiceSmall-tiny"]),
                       "--audio", str(wav16), "--no-verbose",
                       "--output-path", str(tmp / "sv")])
    text = (tmp / "sv" / "transcription.txt").read_text().strip()
    sts_generate.main(["--model", str(dirs["MossFormer2_SE_48K-tiny"]),
                       "--audio", str(wav8), "--output-path",
                       str(tmp / "moss.wav")])
    y, sr = audio_io.read(str(tmp / "moss.wav"), dtype="float32")
    x8, _ = audio_io.read(str(wav8), dtype="float32")
    want_y = np.clip(loaded[4].enhance(x8), -1, 1)
    err = float(np.abs(y - want_y).max()) if len(y) == len(want_y) \
        else float("inf")
    if not (text == loaded[1].generate(str(wav16)).text and sr == 8000
            and err <= 2 / 32768):
        raise AssertionError(f"the CLIs: STT {text!r}; STS WAV {len(y)} "
                             f"samples at {sr}, max error {err:.3e}")
    notes.append(f"the STT CLI wrote SenseVoice's text, the STS CLI "
                 f"MossFormer2-SE's enhance() audio (max error {err:.1e})")
    launches = qmm_kernel.launches
    log(f"[kaldi small] {'; '.join(notes)}")
    log(f"[time] phase 49 in {time.perf_counter() - t0:.1f} s; K2 launched "
        f"{launches} times")
    return launches


def build_fun_asr_nano_full():
    """Fun-ASR-Nano-2512 (FUN_NANO) drawn on the card in f32 from seed 0
    tensor by tensor, the EOS rows of the tied table zeroed (so that a
    greedy decode runs its whole budget), cast in place to bf16; the
    stand-in tokenizer."""
    import torch

    from mlx_audio_tpu_torch.stt.models.fun_asr_nano import Model
    from mlx_audio_tpu_torch.stt.models.fun_asr_nano.fun_asr_nano import \
        EOS_IDS

    t0 = time.perf_counter()
    model = Model(FUN_NANO, device=DEVICE).init_params(seed=0,
                                                       on_device=True)
    with torch.no_grad():
        model.llm.model.embed_tokens.weight[list(EOS_IDS)] = 0.0
    model.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    model._tokenizer = AsrTok(QWEN3_SPECIAL_IDS, n_chars=1000)
    torch.cuda.synchronize()
    log(f"[fun-asr-nano] Fun-ASR-Nano-2512 dims (SenseVoice encoder 50 + 20 "
        f"x d512, adaptor 2 x d1024, Qwen3-0.6B 28 x d1024 GQA 16/8 of 128, "
        f"FFN 3,072, vocabulary 151,936, tied head): {model.num_params():,} "
        f"params bf16 on cuda, built in {time.perf_counter() - t0:.2f} s")
    return model


def _lm_view(model):
    """Fun-ASR-Nano as `asr_token_bytes` reads a model: its text config
    and its Qwen3 LM."""
    from types import SimpleNamespace

    return SimpleNamespace(config=SimpleNamespace(
        text_config=model.config.text), model=model.llm.model)


def _fun_run(model, audio, label: str, card: str, base: int) -> dict:
    """The features; the encoder and adaptor's ms; a FUN_TOKENS-token
    greedy transcription (ms a token p50 and p95 over its chunks after the
    first, xRT, peak memory); one profiled chunk of PROFILE_STEPS steps
    (kernels, device ms and busy share a token; K2's launches a token).
    -> the numbers."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.stt.models.qwen3_lm import (DEC_CHUNK,
                                                         prompt_bucket)

    laps = Laps(f"fun-asr-nano {label}")
    model.generate(audio, max_tokens=WARM_STEPS)
    laps("warm-up")
    feats, _, fake_len = model._extract_features(audio)
    enc_ms = _sync_ms(lambda: model.get_audio_embeds(feats))
    rows = model.get_audio_embeds(feats)
    ids, beg = model._build_prompt_ids(fake_len, language=None,
                                       hotwords=None, itn=True)
    n = len(ids)
    bucket = prompt_bucket(n)
    greedy = (0.0, 0, 1.0, 0.0, 1.0, 20, 1)
    fns = model._decode_fns(bucket, FUN_TOKENS, greedy)
    embeds = model.prompt_embeds(ids, beg, rows, fake_len, bucket)
    logits = fns.prefill(embeds, n)[0]
    laps("encoder timed")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = model.generate(audio, max_tokens=FUN_TOKENS)
    wall = time.perf_counter() - t0
    laps("the request")
    run = dict(model.last_run)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    per_token = np.asarray(run["chunk_ms"][1:]) / DEC_CHUNK
    if not (out.generation_tokens == FUN_TOKENS and len(per_token)):
        raise AssertionError(f"Fun-ASR-Nano {label}: {out.generation_tokens}"
                             f" tokens, {run}")
    state = fns.start(embeds, n, FUN_TOKENS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fns.chunk(state, PROFILE_STEPS)
    chunk_wall = (time.perf_counter() - t1) * 1e3 / PROFILE_STEPS
    k2, fwd = qmm_kernel.launches, state["forwards"]
    prof = _device_kernels(lambda: fns.chunk(state, PROFILE_STEPS),
                           cpu=False)
    k2_token = (qmm_kernel.launches - k2) / max(state["forwards"] - fwd, 1)
    dev_ms = sum(_dev_us(e) for e in prof) / 1e3 / PROFILE_STEPS
    kernels = sum(e.count for e in prof) / PROFILE_STEPS
    laps("profiled steps")
    laps.log()
    if not (kernels > 0 and dev_ms > 0):
        raise AssertionError("Fun-ASR-Nano: the profiler saw no kernel")
    cols = n + FUN_TOKENS / 2
    nbytes = asr_token_bytes(_lm_view(model), cols)
    bound = nbytes / HBM_BPS * 1e3
    res = dict(enc_ms=enc_ms, bucket=bucket, logits=logits, wall=wall,
               p50=float(np.percentile(per_token, 50)),
               p95=float(np.percentile(per_token, 95)),
               xrt=FUN_SECONDS / wall, peak=peak, kernels=kernels,
               dev_ms=dev_ms, busy=dev_ms / chunk_wall, bound=bound,
               nbytes=nbytes, k2_token=k2_token, prompt=n,
               frames=feats.shape[0], audio_tokens=fake_len)
    log(f"[fun-asr-nano] {label}: {FUN_SECONDS} s, {feats.shape[0]} LFR "
        f"frames, {fake_len} audio rows in a {n}-token prompt (bucket "
        f"{bucket}): encoder and adaptor {enc_ms:.2f} ms; {FUN_TOKENS} greedy "
        f"tokens: {res['p50']:.2f} ms a token p50, {res['p95']:.2f} p95 "
        f"(over {len(per_token)} chunks of {DEC_CHUNK}), wall {wall:.2f} s, "
        f"xRT {res['xrt']:.2f}, peak {peak:.2f} GB above the earlier "
        f"phases'; profiled chunk: {kernels:.0f} kernels and {dev_ms:.3f} ms "
        f"of device time a token against {chunk_wall:.2f} ms of wall "
        f"({100 * res['busy']:.1f}% busy), {k2_token:.0f} K2 launches a "
        f"token; {nbytes / 1e9:.3f} GB a token, bound {bound:.3f} ms "
        f"(bytes), {100 * bound / res['p50']:.1f}% of it reached at p50 "
        f"({card})")
    return res


def phase_fun_asr_nano_full(card: str, recorder: K2Recorder) -> int:
    """Phase 50: Fun-ASR-Nano-2512 at its published dims seeded on the
    card in bf16, then its `llm.model` weights packed to MLX's 8-bit
    layout in memory and loaded through the pre-quantized path (every LM
    linear on K2, the tied table dense, the head one dense product): each
    a 64-token greedy transcription of 30 s of randn * 0.1 (`_fun_run`);
    the 196 LM linears alone at M = 1 against their byte bound; K2's
    launches a token read from its counter against 28 x 7; the first-step
    logits q8 against bf16. -> K2's launches, as its counter read them."""
    import torch

    from mlx_audio_tpu_torch.nn import Embedding, QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.utils import (apply_quantization,
                                           unpack_prequantized)

    t_phase = time.perf_counter()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    base = torch.cuda.memory_allocated()
    model = build_fun_asr_nano_full()
    audio = _noise(0, FUN_SECONDS)
    bf16 = _fun_run(model, audio, "bf16", card, base)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the bf16 Fun-ASR-Nano launched K1 or K2")
    per_token = 7 * model.config.text.num_hidden_layers
    t1 = time.perf_counter()
    packed = pack_mlx_in_memory(model, 8, lambda k, v: k.startswith(
        "llm.model"))
    torch.cuda.empty_cache()
    config = {"quantization": {"group_size": MLX_GROUP, "bits": 8}}
    flat = unpack_prequantized(model, config, packed)
    del packed
    model.bind(flat)
    del flat
    apply_quantization(model, config, model.model_quant_predicate,
                       pre_quantized=True)
    torch.cuda.empty_cache()
    held = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    if held != per_token or not isinstance(model.llm.model.embed_tokens,
                                           Embedding):
        raise AssertionError(f"q8 Fun-ASR-Nano holds {held} quantized "
                             f"linears (want {per_token}) or a quantized "
                             f"table")
    log(f"[fun-asr-nano] llm.model packed to MLX 8-bit (group {MLX_GROUP}) "
        f"in memory and loaded through the pre-quantized path in "
        f"{time.perf_counter() - t1:.2f} s: {held} LM linears on K2, the "
        f"encoder and adaptor bf16, the tied table dense")
    alone, abound, n = k2_linears_alone(model.llm.model, card,
                                        "fun-asr-nano")
    k1 = snake_conv_kernel.launches
    qmm_kernel.launches = 0
    with recorder:
        q8 = _fun_run(model, audio, "q8 (K2)", card, base)
    k2 = qmm_kernel.launches
    if q8["k2_token"] != per_token or snake_conv_kernel.launches != k1:
        raise AssertionError(f"q8 Fun-ASR-Nano: {q8['k2_token']} K2 "
                             f"launches a token, want {per_token}; or K1 "
                             f"launched")
    rel = float(torch.linalg.norm(q8["logits"] - bf16["logits"])
                / torch.linalg.norm(bf16["logits"]))
    top1 = int(q8["logits"].argmax()) == int(bf16["logits"].argmax())
    if not (torch.isfinite(q8["logits"]).all() and rel < ASR_Q8_REL):
        raise AssertionError(f"q8 Fun-ASR-Nano first-step logits vs bf16: "
                             f"relative {rel:.3e}")
    log(f"[fun-asr-nano] q8 against bf16 on this card: encoder and adaptor "
        f"{q8['enc_ms']:.2f} vs {bf16['enc_ms']:.2f} ms, {q8['p50']:.2f} vs "
        f"{bf16['p50']:.2f} ms a token p50, {q8['p95']:.2f} vs "
        f"{bf16['p95']:.2f} p95, xRT {q8['xrt']:.2f} vs {bf16['xrt']:.2f}, "
        f"{q8['kernels']:.0f} vs {bf16['kernels']:.0f} kernels and "
        f"{q8['dev_ms']:.3f} vs {bf16['dev_ms']:.3f} ms of device time a "
        f"token, busy {100 * q8['busy']:.1f}% vs {100 * bf16['busy']:.1f}%, "
        f"{q8['nbytes'] / 1e9:.3f} vs {bf16['nbytes'] / 1e9:.3f} GB a token, "
        f"bound {q8['bound']:.3f} vs {bf16['bound']:.3f} ms, peak "
        f"{q8['peak']:.2f} vs {bf16['peak']:.2f} GB; K2 launched {k2} times, "
        f"{q8['k2_token']:.0f} a decode token (read from its counter; the "
        f"config gives {per_token}), the {n} LM linears alone {alone:.3f} ms "
        f"a token (bound {abound:.3f} ms); first-step logits q8 vs bf16 "
        f"relative {rel:.3e} (limit {ASR_Q8_REL:g}), top-1 "
        f"{'equal' if top1 else 'differs'} ({card})")
    del model
    torch.cuda.empty_cache()
    log(f"[time] phase 50 in {time.perf_counter() - t_phase:.1f} s")
    return k2


def sensevoice_flops(cfg, t: int) -> float:
    """Multiply-adds x 2 of a SenseVoice forward over t rows: each SANM
    layer's q/k/v, output and FFN products, its attention's scores and
    weighted sum, its memory conv; the CTC head."""
    e = cfg.encoder_conf
    d, total = e.output_size, 0.0
    for i in range(e.num_blocks + e.tp_blocks):
        din = cfg.input_size if i == 0 else d
        total += 2 * t * (din * 3 * d + d * d + 2 * d * e.linear_units
                          + d * e.kernel_size) + 4 * t * t * d
    return total + 2 * t * d * cfg.vocab_size


def phase_sensevoice_firered_full(card: str) -> None:
    """Phase 51: SenseVoiceSmall at the JAX package's defaults (vocabulary
    25,055, input 560, 50 + 20 SANM blocks at d512) seeded on the card: 30
    s in f32 then bf16 (ms, xRT, the share of 989 TFLOP/s by counted
    operations, CTC ids bf16 against f32); FireRedASR2-AED at the JAX
    defaults (16 + 16 layers at d1,280, 20 heads, conv kernel 33, 8,667
    ids) in bf16, EOS's projection row zeroed: the encoder on 10 s (ms),
    then beam 3 with max_len 64 (ms a beam step p50 and p95, kernels a
    step over a profiled 8-step beam, bytes a step and their bound).
    Neither K1 nor K2 launches."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.stt.models.fireredasr2 import Model as Fire
    from mlx_audio_tpu_torch.stt.models.fireredasr2.fireredasr2 import \
        BeamSearch
    from mlx_audio_tpu_torch.stt.models.sensevoice import Model as SV
    from mlx_audio_tpu_torch.nn import Linear

    t_phase = time.perf_counter()
    sv = SV(dict(model_type="sensevoice"), device=DEVICE).init_params(
        seed=0, on_device=True)
    audio = _noise(2, SV_SECONDS)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        sv.astype(dtype)
        sv.transcribe_ids(audio)
        ms = _sync_ms(lambda: sv.transcribe_ids(audio))
        feats = sv._extract_features(audio)
        lp = sv.log_probs(sv._build_speech(feats, "auto", False))
        res[dtype] = (ms, lp[4:].argmax(-1), sv.transcribe_ids(audio))
    t_rows = lp.shape[0]
    flops = sensevoice_flops(sv.config, t_rows)
    agree = float((res[torch.float32][1] == res[torch.bfloat16][1]).float()
                  .mean())
    if agree < 0.9 or not torch.isfinite(lp).all():
        raise AssertionError(f"SenseVoice bf16 vs f32: {agree:.3f} of the "
                             f"frames' CTC ids equal")
    (f32_ms, _, _), (bf_ms, _, (ids, tags)) = res[torch.float32], \
        res[torch.bfloat16]
    log(f"[sensevoice] SenseVoiceSmall dims ({sv.num_params():,} params): "
        f"{SV_SECONDS} s -> {t_rows} rows; f32 {f32_ms:.2f} ms (xRT "
        f"{SV_SECONDS * 1e3 / f32_ms:.0f}), bf16 {bf_ms:.2f} ms (xRT "
        f"{SV_SECONDS * 1e3 / bf_ms:.0f}, {flops / 1e9:.1f} GFLOP: "
        f"{100 * flops / PEAK_BF16 * 1e3 / bf_ms:.2f}% of 989 TFLOP/s); the "
        f"frames' CTC ids bf16 vs f32 equal on {100 * agree:.1f}%, {len(ids)} "
        f"ids after the collapse, tags {tags} ({card})")
    del sv, res, lp
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    fire = Fire(dict(model_type="fireredasr2"), device=DEVICE).init_params(
        seed=0, on_device=True)
    with torch.no_grad():
        fire.decoder.tgt_word_prj.weight[fire.config.eos_id] = 0.0
    fire.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t1
    clip = _noise(3, FIRE_SECONDS)
    feats = fire._extract_fbank(clip)
    fire.encode(feats)
    enc_ms = _sync_ms(lambda: fire.encode(feats))
    out = fire.generate(clip, beam_size=3, max_len=FIRE_STEPS)
    out = fire.generate(clip, beam_size=3, max_len=FIRE_STEPS)
    run = fire.last_run
    steps = np.asarray(run["step_ms"])
    if run["steps"] != FIRE_STEPS or out.generation_tokens != FIRE_STEPS:
        raise AssertionError(f"FireRedASR2: {run['steps']} steps, "
                             f"{out.generation_tokens} tokens")
    enc_out = fire.encode(feats)
    search = BeamSearch(fire, enc_out, 3, 8, 1.25, 1.0)
    search.run()
    prof = _device_kernels(lambda: BeamSearch(fire, enc_out, 3, 8, 1.25,
                                              1.0).run(), cpu=False)
    kernels = sum(e.count for e in prof) / 8
    dev_ms = sum(_dev_us(e) for e in prof) / 1e3 / 8
    # a step reads the decoder's linears but the cross K and V projections
    # (made once), the embedding rows, the f32 self caches at about half
    # the steps' columns and the bf16 cross K and V
    dec, d = fire.decoder, fire.config.dec
    lin = sum(m.weight.numel() * 2 for name, m in dec.named_modules()
              if isinstance(m, Linear) and "cross_attn.w_ks" not in name
              and "cross_attn.w_vs" not in name)
    cache = d.n_layers * 2 * 3 * (FIRE_STEPS / 2) * d.d_model * 4
    cross = d.n_layers * 2 * enc_out.shape[1] * d.d_model * 2
    nbytes = lin + cache + cross + 3 * d.d_model * 2
    bound = nbytes / HBM_BPS * 1e3
    p50 = float(np.percentile(steps, 50))
    log(f"[fireredasr2] FireRedASR2-AED dims ({fire.num_params():,} params "
        f"bf16, built in {build_s:.1f} s): {FIRE_SECONDS} s -> {len(feats)} "
        f"frames, "
        f"{enc_out.shape[1]} encoder rows: encoder {enc_ms:.2f} ms; beam 3, "
        f"max_len {FIRE_STEPS}, EOS's row zeroed: {run['steps']} steps, "
        f"{p50:.2f} ms a beam step p50, {np.percentile(steps, 95):.2f} p95 "
        f"(M = 3); a profiled 8-step beam: {kernels:.0f} kernels and "
        f"{dev_ms:.3f} ms of device time a step; {nbytes / 1e9:.3f} GB a "
        f"step, bound {bound:.3f} ms (bytes), {100 * bound / p50:.1f}% of it "
        f"reached at p50 ({card})")
    del fire, enc_out, search
    torch.cuda.empty_cache()
    log(f"[time] phase 51 in {time.perf_counter() - t_phase:.1f} s")


def phase_mossformer_fsmn_full(card: str) -> None:
    """Phase 52: MossFormer2-SE 48K at the JAX defaults (24 blocks at
    d512, 961 bins) seeded on the card in f32: a 10-s clip (one chunk) and
    a 30-s clip (sliding 4-s windows past 20 s), each cold then warm (ms,
    xRT); FSMN VAD at the JAX defaults (FunASR's fsmn-vad: 4 FSMN layers,
    400 inputs, 248 pdfs) on 60 s of loud and quiet stretches, its output
    layer scaled by FSMN_OUT_SCALE: `detect` cold then warm (ms, xRT,
    segments) and a session fed 100-frame pieces equal to it."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.sts.models.mossformer2_se import Model as Moss
    from mlx_audio_tpu_torch.vad.models.fsmn import Model as Fsmn
    from mlx_audio_tpu_torch.vad.models.fsmn.fsmn import (compute_decibel,
                                                          extract_features)

    t_phase = time.perf_counter()
    moss = Moss(dict(model_type="mossformer2_se"), device=DEVICE) \
        .init_params(seed=0, on_device=True)
    parts = []
    for secs in MOSS_CLIPS:
        clip = _clip_audio(60 + secs, secs, 48000)
        walls = []
        for _ in range(2):
            out, s = _sync_s(lambda: moss.enhance(clip))
            walls.append(s)
        if not (out.shape == clip.shape and np.isfinite(out).all()):
            raise AssertionError(f"MossFormer2-SE on {secs} s: {out.shape}")
        parts.append(f"{secs} s ({moss.last_run['chunks']} chunks): cold "
                     f"{walls[0] * 1e3:.1f} ms, warm {walls[1] * 1e3:.1f} ms "
                     f"(xRT {secs / walls[1]:.1f})")
    log(f"[mossformer2-se] 48K dims ({moss.num_params():,} params f32): "
        f"{'; '.join(parts)} ({card})")
    del moss
    torch.cuda.empty_cache()
    vad = Fsmn(dict(model_type="fsmn"), device=DEVICE).init_params(
        seed=0, on_device=True)
    with torch.no_grad():
        vad.encoder.out_linear2.weight.mul_(FSMN_OUT_SCALE)
    rs = np.random.RandomState(7)
    pieces, loud = [], False
    while sum(map(len, pieces)) < FSMN_SECONDS * 16000:
        pieces.append(rs.randn(rs.randint(8000, 40000))
                      * (0.3 if loud else 0.002))
        loud = not loud
    audio = np.concatenate(pieces)[:FSMN_SECONDS * 16000].astype(np.float32)
    walls = []
    for _ in range(2):
        segs, s = _sync_s(lambda: vad.detect(audio))
        walls.append(s)
    sil = vad._sil_scores(vad.scores(extract_features(
        audio, vad.config, None, vad.device)))
    db = compute_decibel(audio * 32768.0, 16000, 25, 10)[:len(sil)]
    sil = sil[:len(db)]
    session, streamed = vad.create_session(), []
    for i in range(0, len(db), 100):
        streamed += session.feed(sil[i:i + 100], db[i:i + 100],
                                 is_final=i + 100 >= len(db))
    if streamed != segs:
        raise AssertionError(f"FSMN session {streamed} vs detect {segs}")
    log(f"[fsmn-vad] FunASR fsmn-vad dims ({vad.num_params():,} params "
        f"f32) on {FSMN_SECONDS} s: detect cold {walls[0] * 1e3:.1f} ms, warm "
        f"{walls[1] * 1e3:.1f} ms (xRT {FSMN_SECONDS / walls[1]:.0f}), "
        f"{len(segs)} segments, the session fed in 100-frame pieces equal "
        f"({card})")
    del vad
    torch.cuda.empty_cache()
    log(f"[time] phase 52 in {time.perf_counter() - t_phase:.1f} s")


def phase_kaldi_families(card: str, recorder: K2Recorder) -> int:
    """Phases 49-52; K1 never launches, K2 only on the q8 Fun-ASR-Nano
    models. -> K2's launches there."""
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    t0 = time.perf_counter()
    k1 = snake_conv_kernel.launches
    with tempfile.TemporaryDirectory() as tmp:
        k2 = phase_kaldi_reference(Path(tmp), recorder)
    torch.cuda.empty_cache()
    k2 += phase_fun_asr_nano_full(card, recorder)
    before = qmm_kernel.launches
    phase_sensevoice_firered_full(card)
    phase_mossformer_fsmn_full(card)
    if snake_conv_kernel.launches != k1 or qmm_kernel.launches != before:
        raise AssertionError("phases 49-52 launched K1, or K2 outside the "
                             "q8 Fun-ASR-Nano")
    log(f"[time] phases 49-52 in {time.perf_counter() - t0:.1f} s; K1 not "
        f"launched")
    return k2


# ---------------------------------------------------------------------------
# Phases 53-55: the last six STT families (LASR-CTC, Moonshine,
# MOSS-Transcribe-Diarize, Higgs Audio v3, Granite Speech NAR, MOSS-Music)
# ---------------------------------------------------------------------------

# the JAX tests' tiny configs (tests/test_lasr_ctc.py, test_moonshine.py,
# test_moss_stt.py, test_higgs3_granite_nar.py), their LMs and the NAR
# editor at widths group 64 divides (K2), d64 with 4 heads and 2 KV heads
# of 16; the stand-in AsrTok's special ids and 250-252 for the audio ids
_LM64 = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16)
_TOWER32 = dict(num_mel_bins=80, d_model=32, encoder_layers=2,
                encoder_attention_heads=4, encoder_ffn_dim=64)
LAST_STT_SMALL = {
    "lasr_ctc": dict(model_type="lasr", vocab_size=40, encoder_config=dict(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=4, intermediate_size=64, conv_kernel_size=8,
        num_mel_bins=32, subsampling_conv_channels=16)),
    "moonshine": dict(model_type="moonshine", vocab_size=64, hidden_size=32,
                      intermediate_size=64, encoder_num_hidden_layers=2,
                      decoder_num_hidden_layers=2,
                      encoder_num_attention_heads=4,
                      decoder_num_attention_heads=4),
    "moss_transcribe_diarize": dict(
        model_type="moss_transcribe_diarize", text_config=_LM64,
        audio_config=_TOWER32, audio_token_id=250),
    "higgs_audio_3": dict(model_type="higgs_audio_3",
                          audio_encoder_config=_TOWER32, text_config=_LM64,
                          chunk_size_seconds=1.0),
    "granite_speech_nar": dict(
        model_type="granite_speech_nar",
        encoder_config=dict(input_dim=160, num_layers=4, hidden_dim=32,
                            feedforward_mult=2, num_heads=2, dim_head=16,
                            output_dim=12, context_size=50, max_pos_emb=64,
                            conv_kernel_size=5, bpe_output_dim=40,
                            bpe_pooling_window=4, self_conditioning_layer=2,
                            blank_token_id=0),
        projector_config=dict(num_layers=2, num_encoder_layers=4,
                              hidden_size=32, num_heads=4, encoder_dim=32,
                              llm_dim=64, mlp_ratio=2),
        text_config=dict(hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, vocab_size=40,
                         attention_multiplier=0.35),
        encoder_layer_indices=[1, 2, 3, -1], blank_token_id=0),
    "moss_music": dict(
        model_type="moss_music", audio_config=dict(
            d_model=32, output_dim=32, encoder_layers=4,
            encoder_attention_heads=4, encoder_ffn_dim=64,
            downsample_hidden_size=8, n_window=50,
            deepstack_encoder_layer_indexes=[1, 2, 3]),
        language_config=_LM64, adapter_hidden_size=48,
        deepstack_num_inject_layers=2, audio_token_id=250,
        audio_start_id=251, audio_end_id=252, eos_token_id=242),
}
# the prefixes an MLX-packed q8 directory of each LM family packs: every
# LM linear (and Higgs's head; the tables unpack dense)
LAST_STT_PACKED = {"moss_transcribe_diarize": ("model.language_model",),
                   "higgs_audio_3": ("language_model", "lm_head"),
                   "granite_speech_nar": ("editor.",),
                   "moss_music": ("language_model",)}
# Qwen/Qwen3-8B's published text config (MOSS-Music-8B-Thinking's LM; the
# repository holds no MOSS-Music config.json, so this is an assumption)
QWEN3_8B_TEXT = dict(vocab_size=151936, hidden_size=4096,
                     intermediate_size=12288, num_hidden_layers=36,
                     num_attention_heads=32, num_key_value_heads=8,
                     head_dim=128, rope_theta=1000000.0, rms_norm_eps=1e-6,
                     tie_word_embeddings=False)
MUSIC_FULL = dict(model_type="moss_music", language_config=QWEN3_8B_TEXT)
# UsefulSensors/moonshine-base's published dims (the JAX defaults are
# moonshine-tiny's 288 / 6 / 6)
MOONSHINE_BASE = dict(model_type="moonshine", hidden_size=416,
                      intermediate_size=1664, encoder_num_hidden_layers=8,
                      decoder_num_hidden_layers=8,
                      encoder_num_attention_heads=8,
                      decoder_num_attention_heads=8,
                      partial_rotary_factor=0.62)
# phase 55's five: LASR-CTC, MOSS-Transcribe-Diarize and Higgs Audio v3
# (plain 4-s chunks: vad_cut off) at the JAX defaults, Moonshine at
# moonshine-base's dims, Granite Speech NAR at the JAX defaults but 16
# encoder layers (the defaults' 10 cannot hold `encoder_layer_indices`
# [4, 8, 12, -1])
LAST_STT_FULL = {
    "lasr_ctc": dict(model_type="lasr"),
    "moonshine": MOONSHINE_BASE,
    "moss_transcribe_diarize": dict(model_type="moss_transcribe_diarize"),
    "higgs_audio_3": dict(model_type="higgs_audio_3", vad_cut=False),
    "granite_speech_nar": dict(model_type="granite_speech_nar",
                               encoder_config=dict(num_layers=16))}
# MOSS-Music's request 64 tokens, the others' 64 (128 and 96 until phases
# 58-61)
LAST_STT_SECONDS, MUSIC_TOKENS, LAST_STT_TOKENS = 30, 64, 64
# the tokens of a warm-up request before a timed one
WARM_TOKENS = 4


def _stt_small(family: str, device: str, like=None):
    """The small config of `family` at f32 on `device`: seeded from 0, or
    `like`'s weights."""
    import importlib

    mod = importlib.import_module(f"mlx_audio_tpu_torch.stt.models.{family}")
    model = mod.Model(dict(LAST_STT_SMALL[family]), device=device)
    if like is None:
        return model.init_params(seed=0)
    model.load_state_dict(like.state_dict())
    return model


def _with_asr_tok(model, ids: dict, n_chars: int):
    """`model` with the stand-in AsrTok where its family reads a
    tokenizer, and the tokenizer's digit ids where it marks time."""
    from mlx_audio_tpu_torch.stt.models.moss_transcribe_diarize.\
        moss_transcribe_diarize import digit_ids

    name = type(model).__module__.rsplit(".", 1)[-1]
    if name in ("moss_transcribe_diarize", "higgs_audio_3", "moss_music"):
        model._tokenizer = AsrTok(ids, n_chars=n_chars)
        if name != "higgs_audio_3":
            model._digit_token_ids = digit_ids(model._tokenizer)
    return model


def _last_stt_out(model, audio):
    """What a family's greedy transcription gives: CTC ids, or text (24
    tokens at most) with the segments (Higgs's one segment ends at the
    wall time: its text alone)."""
    if type(model).__module__.endswith(".lasr"):
        return model.transcribe_ids(audio)
    out = model.generate(audio, max_tokens=24)
    if type(model).__module__.endswith(".higgs_audio_3"):
        return (out.text,)
    return out.text, out.segments


def phase_last_stt_reference(tmp: Path, recorder: K2Recorder) -> int:
    """Phase 53: the six families' small configs at f32 from one seeded
    weight set, the card against the CPU: LASR-CTC's CTC ids, Moonshine's
    greedy tokens, MOSS-Transcribe-Diarize's (whole and streamed), Higgs
    Audio v3's over a seeded Silero's chunks (the VAD seam on the card),
    Granite Speech NAR's two passes, MOSS-Music's with its deepstack
    prefill; an MLX-packed q8 directory of each LM family through
    `stt.utils` (every packed linear on K2: tokens equal to the same model
    through `qmatmul_reference` and to the CPU's); tiny directories of all
    six through `stt.utils` and the top-level `load_model` on the card;
    the STT CLI on Moonshine and on MOSS-Transcribe-Diarize with --stream
    against in-process `generate`. -> K2's launches, as its counter read
    them."""
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch import load_model as route
    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.stt import generate as stt_generate
    from mlx_audio_tpu_torch.stt import utils as stt_utils
    from mlx_audio_tpu_torch.vad.models.silero_vad import Model as Silero
    from mlx_audio_tpu_torch.vad.models.silero_vad import \
        ModelConfig as SileroConfig

    t0 = time.perf_counter()
    qmm_kernel.launches = 0
    speech = _noise(53, 2.0)
    notes, cpus = [], {}
    # one seeded Silero on each device, the same weights
    vads = {dev: Silero(SileroConfig(), device=dev).init_params(seed=0)
            for dev in ("cpu", DEVICE)}

    def ready(m):
        """The stand-in tokenizer; Higgs's Silero on the model's device."""
        if type(m).__module__.endswith(".higgs_audio_3"):
            m.set_vad_model(vads[m.device.type])
        return _with_asr_tok(m, SMALL_SPECIAL_IDS, 200)

    for family in LAST_STT_SMALL:
        cpu = ready(_stt_small(family, "cpu"))
        card = ready(_stt_small(family, DEVICE, like=cpu))
        want, got = _last_stt_out(cpu, speech), _last_stt_out(card, speech)
        if got != want or not want:
            raise AssertionError(f"{family} CUDA vs CPU: {got} vs {want}")
        if family == "moss_transcribe_diarize":
            parts = list(card.generate(speech, max_tokens=24, stream=True))
            if " ".join(p.text for p in parts[:-1]) != want[0] or \
                    not parts[-1].is_final:
                raise AssertionError("MOSS-Transcribe-Diarize's stream on "
                                     "the card differs from its generate")
        size = len(want) if family == "lasr_ctc" else len(want[0].split())
        notes.append(f"{family} equal ({size} "
                     f"{'CTC ids' if family == 'lasr_ctc' else 'tokens'})")
        cpus[family] = cpu
    # the LM families' MLX-packed q8 directories on K2
    for family, packed in LAST_STT_PACKED.items():
        d8 = tmp / f"{family}-q8"
        _write_kaldi_dir(cpus[family], d8, LAST_STT_SMALL[family], bits=8,
                         packed=packed)
        with recorder:
            q8 = ready(stt_utils.load_model(d8, device=DEVICE))
            held = sum(isinstance(m, QuantizedLinear) for m in q8.modules())
            k2 = qmm_kernel.launches
            got = _last_stt_out(q8, speech)
            k2 = qmm_kernel.launches - k2
        with K2AsReference():
            ref = _last_stt_out(q8, speech)
        qc = ready(stt_utils.load_model(d8, device="cpu"))
        if not (held and k2 and got == ref == _last_stt_out(qc, speech)):
            raise AssertionError(f"q8 {family}: {held} quantized linears, "
                                 f"{k2} K2 launches; K2's output equal to "
                                 f"the plain version's {got == ref}, the "
                                 f"CPU's {got == _last_stt_out(qc, speech)}")
        notes.append(f"q8 {family}: {held} linears on K2, {k2} launches")
    # the loaders and the CLI on the card
    dirs = {}
    for family, cpu in cpus.items():
        dirs[family] = tmp / f"{family}-tiny"
        _write_kaldi_dir(cpu, dirs[family], LAST_STT_SMALL[family])
    for family, d in dirs.items():
        for load in (stt_utils.load_model, route):
            m = ready(load(d, device=DEVICE))
            if type(m).__module__.rsplit(".", 1)[-1] != \
                    type(cpus[family]).__module__.rsplit(".", 1)[-1] or \
                    _last_stt_out(m, speech) != _last_stt_out(cpus[family],
                                                              speech):
                raise AssertionError(f"the loaders on the card: {family}")
    notes.append("stt.utils and the top-level load_model on the six tiny "
                 "directories, each as the CPU model")
    wav = tmp / "speech53.wav"
    audio_io.write(wav, speech, 16000)
    real = stt_utils.load_model
    stt_utils.load_model = lambda p: ready(real(p, device=DEVICE))
    try:
        for family, extra in (("moonshine", []),
                              ("moss_transcribe_diarize", ["--stream"])):
            out = tmp / f"cli-{family}"
            stt_generate.main(["--model", str(dirs[family]), "--audio",
                               str(wav), "--max-tokens", "24",
                               "--no-verbose", "--output-path", str(out)]
                              + extra)
            text = (out / "transcription.txt").read_text().strip()
            want = _last_stt_out(cpus[family], speech)[0]
            if extra:                   # the stream's pieces, one a token
                want = want.replace(" ", "")
            if text != want:
                raise AssertionError(f"the STT CLI on {family}: {text!r}")
    finally:
        stt_utils.load_model = real
    notes.append("the STT CLI wrote Moonshine's text and "
                 "MOSS-Transcribe-Diarize's streamed text")
    launches = qmm_kernel.launches
    log(f"[last stt small] {'; '.join(notes)}")
    log(f"[time] phase 53 in {time.perf_counter() - t0:.1f} s; K2 launched "
        f"{launches} times")
    return launches


def lm_token_bytes(lm, head, cfg, cache_cols: float) -> float:
    """Bytes a decode token must read from a Qwen3 LM: its layers' linears
    (bf16, or 8-bit codes one a byte with f32 scales and biases), the head
    (a dense `head`, or the tied table where it is None) and one table
    row, the norms, and the f32 K and V of `cache_cols` columns."""
    from mlx_audio_tpu_torch.nn import Linear, QuantizedLinear

    total = 0.0
    for m in lm.layers.modules():
        if isinstance(m, Linear):
            total += m.weight.numel() * m.weight.element_size()
        elif isinstance(m, QuantizedLinear):
            total += (m.w_q.numel() + 4 * (m.scales.numel()
                                           + m.biases.numel()))
    table = lm.embed_tokens.weight
    w = table if head is None else head.weight
    total += w.numel() * w.element_size()
    total += cfg.hidden_size * table.element_size()
    total += (4 * cfg.num_hidden_layers + 1) * cfg.hidden_size * 2
    total += (2 * cfg.num_hidden_layers * cache_cols
              * cfg.num_key_value_heads * cfg.head_dim * 4)
    return total


def build_moss_music_full():
    """MOSS-Music at MUSIC_FULL (the JAX defaults' 32 x d1280 encoder, its
    adapter and three deepstack mergers, Qwen3-8B's text config) drawn on
    the card in f32 from seed 0 tensor by tensor, EOS's head row zeroed
    (so that a greedy decode runs its budget), cast in place to bf16; the
    stand-in tokenizer."""
    import torch

    from mlx_audio_tpu_torch.stt.models.moss_music import Model

    t0 = time.perf_counter()
    model = Model(MUSIC_FULL, device=DEVICE).init_params(seed=0,
                                                         on_device=True)
    with torch.no_grad():
        model.lm_head.weight[model.config.eos_token_id] = 0.0
    model.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    _with_asr_tok(model, QWEN3_SPECIAL_IDS, 1000)
    torch.cuda.synchronize()
    log(f"[moss-music] MOSS-Music-8B dims (encoder 32 x d1280, adapter and 3 "
        f"mergers of 8,192, Qwen3-8B 36 x d4096 GQA 32/8 of 128, FFN "
        f"12,288, vocabulary 151,936, untied head): {model.num_params():,} "
        f"params bf16 on cuda, built in {time.perf_counter() - t0:.2f} s")
    return model


def _music_run(model, audio, label: str, card: str, base: int) -> dict:
    """The encoder's ms (with its deepstack captures); a MUSIC_TOKENS-token
    greedy decode (ms a token p50 and p95 over its chunks after the first,
    xRT, peak memory); one profiled chunk of PROFILE_STEPS steps (kernels,
    device ms and busy share a token; K2's launches a token). -> the
    numbers."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.stt.models.qwen3_lm import (DEC_CHUNK,
                                                         qwen3_decode_fns)

    laps = Laps(f"moss-music {label}")
    greedy = (0.0, 0, 1.0, 0.0, 1.0, 20, 1)
    ids, feats, ds, _ = model._prepare(audio, None, None)
    model._decode(ids, feats, ds, WARM_TOKENS, greedy)
    laps("warm-up")
    enc_ms = _sync_ms(lambda: model.encode_audio(audio), reps=2)
    embeds, full = model.prompt_embeds(ids, feats, ds)
    n = len(ids)
    lc = model.config.language_config
    fns = qwen3_decode_fns(model.language_model, lc, model.lm_head, n,
                           MUSIC_TOKENS, greedy, (model.config.eos_token_id,),
                           deepstack=full)
    logits = fns.prefill(embeds, n)[0]
    laps("encoder timed")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks = model._decode(ids, feats, ds, MUSIC_TOKENS, greedy)
    wall = time.perf_counter() - t0
    laps("the decode")
    run = dict(model.last_run)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    per_token = np.asarray(run["chunk_ms"][1:]) / DEC_CHUNK
    if not (len(toks) == MUSIC_TOKENS and len(per_token)):
        raise AssertionError(f"MOSS-Music {label}: {len(toks)} tokens, "
                             f"{run}")
    state = fns.start(embeds, n, MUSIC_TOKENS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fns.chunk(state, PROFILE_STEPS)
    chunk_wall = (time.perf_counter() - t1) * 1e3 / PROFILE_STEPS
    k2, fwd = qmm_kernel.launches, state["forwards"]
    prof = _device_kernels(lambda: fns.chunk(state, PROFILE_STEPS),
                           cpu=False)
    k2_token = (qmm_kernel.launches - k2) / max(state["forwards"] - fwd, 1)
    dev_ms = sum(_dev_us(e) for e in prof) / 1e3 / PROFILE_STEPS
    kernels = sum(e.count for e in prof) / PROFILE_STEPS
    laps("profiled steps")
    laps.log()
    if not (kernels > 0 and dev_ms > 0):
        raise AssertionError("MOSS-Music: the profiler saw no kernel")
    nbytes = lm_token_bytes(model.language_model, model.lm_head, lc,
                            n + MUSIC_TOKENS / 2)
    bound = nbytes / HBM_BPS * 1e3
    res = dict(enc_ms=enc_ms, logits=logits, wall=wall,
               p50=float(np.percentile(per_token, 50)),
               p95=float(np.percentile(per_token, 95)),
               xrt=LAST_STT_SECONDS / (wall + enc_ms / 1e3), peak=peak,
               kernels=kernels, dev_ms=dev_ms, busy=dev_ms / chunk_wall,
               bound=bound, nbytes=nbytes, k2_token=k2_token, prompt=n,
               audio_tokens=run["audio_tokens"])
    log(f"[moss-music] {label}: {LAST_STT_SECONDS} s, {run['audio_tokens']} "
        f"audio rows (3 deepstack features each) in a {n}-token prompt: "
        f"encoder and adapters {enc_ms:.2f} ms; {MUSIC_TOKENS} greedy tokens: "
        f"{res['p50']:.2f} ms a token p50, {res['p95']:.2f} p95 (over "
        f"{len(per_token)} chunks of {DEC_CHUNK}), decode wall {wall:.2f} s, "
        f"xRT {res['xrt']:.2f}, peak {peak:.2f} GB above the earlier "
        f"phases'; profiled chunk: {kernels:.0f} kernels and {dev_ms:.3f} ms "
        f"of device time a token against {chunk_wall:.2f} ms of wall "
        f"({100 * res['busy']:.1f}% busy), {k2_token:.0f} K2 launches a "
        f"token; {nbytes / 1e9:.3f} GB a token, bound {bound:.3f} ms "
        f"(bytes), {100 * bound / res['p50']:.1f}% of it reached at p50 "
        f"({card})")
    return res


def phase_moss_music_full(card: str, recorder: K2Recorder) -> int:
    """Phase 54: MOSS-Music-8B (MUSIC_FULL) seeded on the card in bf16,
    then its `language_model` weights packed to MLX's 8-bit layout in
    memory and loaded through the pre-quantized path (the bf16 linears
    replaced: every LM linear on K2, the table dense, the head, encoder,
    adapter and mergers bf16): each on 30 s of randn * 0.1 with 128 greedy
    tokens (`_music_run`); the 252 LM linears alone at M = 1 against their
    byte bound; K2's launches a token read from its counter against
    36 x 7; the first-step logits q8 against bf16. -> K2's launches, as
    its counter read them."""
    import torch

    from mlx_audio_tpu_torch.nn import Embedding, QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.utils import (apply_quantization,
                                           unpack_prequantized)

    t_phase = time.perf_counter()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    base = torch.cuda.memory_allocated()
    model = build_moss_music_full()
    audio = _noise(54, LAST_STT_SECONDS)
    bf16 = _music_run(model, audio, "bf16", card, base)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the bf16 MOSS-Music launched K1 or K2")
    per_token = 7 * model.config.language_config.num_hidden_layers
    t1 = time.perf_counter()
    packed = pack_mlx_in_memory(model, 8, lambda k, v: k.startswith(
        "language_model"))
    torch.cuda.empty_cache()
    config = {"quantization": {"group_size": MLX_GROUP, "bits": 8}}
    flat = unpack_prequantized(model, config, packed)
    del packed
    model.bind(flat)
    del flat
    apply_quantization(model, config, model.model_quant_predicate,
                       pre_quantized=True)
    torch.cuda.empty_cache()
    held = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    if held != per_token or not isinstance(
            model.language_model.embed_tokens, Embedding):
        raise AssertionError(f"q8 MOSS-Music holds {held} quantized linears "
                             f"(want {per_token}) or a quantized table")
    log(f"[moss-music] language_model packed to MLX 8-bit (group "
        f"{MLX_GROUP}) in memory and loaded through the pre-quantized path "
        f"in {time.perf_counter() - t1:.2f} s: {held} LM linears on K2, the "
        f"encoder, adapter, mergers and head bf16, the table dense")
    alone, abound, n = k2_linears_alone(model.language_model, card,
                                        "moss-music")
    k1 = snake_conv_kernel.launches
    qmm_kernel.launches = 0
    with recorder:
        q8 = _music_run(model, audio, "q8 (K2)", card, base)
    k2 = qmm_kernel.launches
    if q8["k2_token"] != per_token or snake_conv_kernel.launches != k1:
        raise AssertionError(f"q8 MOSS-Music: {q8['k2_token']} K2 launches "
                             f"a token, want {per_token}; or K1 launched")
    rel = float(torch.linalg.norm(q8["logits"] - bf16["logits"])
                / torch.linalg.norm(bf16["logits"]))
    top1 = int(q8["logits"].argmax()) == int(bf16["logits"].argmax())
    if not (torch.isfinite(q8["logits"]).all() and rel < ASR_Q8_REL):
        raise AssertionError(f"q8 MOSS-Music first-step logits vs bf16: "
                             f"relative {rel:.3e}")
    log(f"[moss-music] q8 against bf16 on this card: encoder "
        f"{q8['enc_ms']:.2f} vs {bf16['enc_ms']:.2f} ms, {q8['p50']:.2f} vs {bf16['p50']:.2f} "
        f"ms a token p50, {q8['p95']:.2f} vs {bf16['p95']:.2f} p95, xRT "
        f"{q8['xrt']:.2f} vs {bf16['xrt']:.2f}, {q8['kernels']:.0f} vs "
        f"{bf16['kernels']:.0f} kernels and {q8['dev_ms']:.3f} vs "
        f"{bf16['dev_ms']:.3f} ms of device time a token, busy "
        f"{100 * q8['busy']:.1f}% vs {100 * bf16['busy']:.1f}%, "
        f"{q8['nbytes'] / 1e9:.3f} vs {bf16['nbytes'] / 1e9:.3f} GB a token, "
        f"bound {q8['bound']:.3f} vs {bf16['bound']:.3f} ms, peak "
        f"{q8['peak']:.2f} vs {bf16['peak']:.2f} GB; K2 launched {k2} times, "
        f"{q8['k2_token']:.0f} a decode token (read from its counter; the "
        f"config gives {per_token}), the {n} LM linears alone {alone:.3f} ms "
        f"a token (bound {abound:.3f} ms); first-step logits q8 vs bf16 "
        f"relative {rel:.3e} (limit {ASR_Q8_REL:g}), top-1 "
        f"{'equal' if top1 else 'differs'} ({card})")
    del model
    torch.cuda.empty_cache()
    log(f"[time] phase 54 in {time.perf_counter() - t_phase:.1f} s")
    return k2


def _build_full(family: str, config: dict, zero_rows=None):
    """`family` at `config` drawn on the card in f32 from seed 0, the rows
    `zero_rows(model)` gives zeroed (EOS's, so that greedy decodes run
    their budget), cast to bf16, with the stand-in tokenizer."""
    import importlib

    import torch

    mod = importlib.import_module(f"mlx_audio_tpu_torch.stt.models.{family}")
    model = mod.Model(dict(config), device=DEVICE).init_params(
        seed=0, on_device=True)
    if zero_rows is not None:
        with torch.no_grad():
            for w, rows in zero_rows(model):    # ids past it never drawn
                w[[r for r in rows if r < w.shape[0]]] = 0.0
    model.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    return _with_asr_tok(model, QWEN3_SPECIAL_IDS, 1000)


def phase_last_stt_full(card: str) -> None:
    """Phase 55: the other five families at full width in bf16 on 30 s of
    randn * 0.1, each seeded on the card: LASR-CTC at the JAX defaults,
    Moonshine at moonshine-base's dims, MOSS-Transcribe-Diarize and Higgs
    Audio v3 (plain 4-s chunks, vad_cut off) at the JAX defaults, Granite
    Speech NAR at the JAX defaults with 16 encoder layers; EOS rows zeroed
    where a family decodes (LAST_STT_TOKENS greedy tokens). Each: the
    encoder's ms, ms a token p50 over the chunks after the first, xRT of
    the request and peak memory. Neither K1 nor K2 launches."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.stt.models.qwen3_lm import DEC_CHUNK

    audio = _noise(55, LAST_STT_SECONDS)
    # the EOS rows each decoding family's greedy pick could stop on
    eos_rows = {
        "moonshine": lambda m: [(m.decoder.embed_tokens.weight,
                                 [m.config.eos_token_id])],
        "moss_transcribe_diarize": lambda m: [
            (m.model.language_model.embed_tokens.weight, m._eos_ids())],
        "higgs_audio_3": lambda m: [(m.lm_head.weight, (151643, 151645))]}
    runs = [(family, config, eos_rows.get(family))
            for family, config in LAST_STT_FULL.items()]
    for family, config, zero in runs:
        t0 = time.perf_counter()
        base = torch.cuda.memory_allocated()
        model = _build_full(family, config, zero)
        build_s = time.perf_counter() - t0
        params = model.num_params()
        torch.cuda.reset_peak_memory_stats()
        kw = {} if family in ("lasr_ctc", "granite_speech_nar") else \
            dict(max_tokens=LAST_STT_TOKENS)
        model.generate(audio, **({**kw, "max_tokens": WARM_TOKENS} if kw
                                 else {}))
        out, wall = _sync_s(lambda: model.generate(audio, **kw))
        run = dict(model.last_run)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        part = (f"{params / 1e9:.3f} B params, built in {build_s:.1f} s: "
                f"{LAST_STT_SECONDS} s in {wall * 1e3:.1f} ms (xRT "
                f"{LAST_STT_SECONDS / wall:.1f})")
        if family == "lasr_ctc":
            part += (f", {run['frames']} mel frames, "
                     f"{len(out.text.split())} ids")
        elif family == "granite_speech_nar":
            part += (f": encoder and projector {run['encode_ms']:.1f} ms "
                     f"({run['frames']} rows -> {run['audio_rows']} audio "
                     f"rows), editor {run['edit_ms']:.1f} ms over "
                     f"{run['audio_rows'] + run['slots']} rows")
        else:
            if out.generation_tokens != LAST_STT_TOKENS:
                raise AssertionError(f"{family}: {out.generation_tokens} "
                                     f"tokens, {run}")
            per = np.asarray(run["chunk_ms"][1:]) / DEC_CHUNK
            part += (f": encoder {run['encode_ms']:.1f} ms, "
                     f"{LAST_STT_TOKENS} greedy tokens at "
                     f"{np.percentile(per, 50):.2f} ms a token p50 "
                     f"({len(per)} chunks after the first)")
        if not np.isfinite(wall) or not out.text:
            raise AssertionError(f"{family} gave no text")
        log(f"[{family}] {part}, peak {peak:.2f} GB ({card})")
        del model, out
        torch.cuda.empty_cache()


def phase_last_stt(card: str, recorder: K2Recorder) -> int:
    """Phases 53-55; K1 never launches, K2 only on the q8 models of phases
    53 and 54. -> K2's launches there."""
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    t0 = time.perf_counter()
    k1 = snake_conv_kernel.launches
    with tempfile.TemporaryDirectory() as tmp:
        k2 = phase_last_stt_reference(Path(tmp), recorder)
    torch.cuda.empty_cache()
    k2 += phase_moss_music_full(card, recorder)
    before = qmm_kernel.launches
    phase_last_stt_full(card)
    if snake_conv_kernel.launches != k1 or qmm_kernel.launches != before:
        raise AssertionError("phases 53-55 launched K1, or K2 outside the "
                             "q8 models")
    log(f"[time] phases 53-55 in {time.perf_counter() - t0:.1f} s; K1 not "
        f"launched")
    return k2


# ---------------------------------------------------------------------------
# Smart Turn, Sortformer and LFM2-Audio (phases 56-57)
# ---------------------------------------------------------------------------

# tests/test_smart_turn.py's, tests/test_sortformer.py's and
# tests/test_lfm_audio.py's tiny configs (the LFM one at group 16's widths)
SMART_TURN_SMALL = dict(
    encoder_config=dict(num_mel_bins=20, max_source_positions=50, d_model=16,
                        encoder_attention_heads=2, encoder_layers=2,
                        encoder_ffn_dim=32),
    processor_config=dict(max_audio_seconds=1, n_mels=20))
SORTFORMER_SMALL = dict(
    fc_encoder_config=dict(hidden_size=16, num_hidden_layers=1,
                           num_attention_heads=2, intermediate_size=32,
                           num_mel_bins=16, conv_kernel_size=5,
                           subsampling_conv_channels=4),
    tf_encoder_config=dict(d_model=8, encoder_layers=1,
                           encoder_attention_heads=2, encoder_ffn_dim=16,
                           max_source_positions=256),
    modules_config=dict(num_speakers=3, fc_d_model=16, tf_d_model=8,
                        chunk_len=8, spkcache_len=16),
    processor_config=dict(feature_size=16))
LFM_SMALL = dict(
    codebooks=4, audio_vocab_size=33, interleaved_n_text=2,
    interleaved_n_audio=3,
    encoder=dict(feat_in=20, n_layers=2, d_model=32, n_heads=4,
                 subsampling_conv_channels=16),
    lfm=dict(vocab_size=256, hidden_size=64, num_hidden_layers=4,
             num_attention_heads=4, num_key_value_heads=2, block_ff_dim=96,
             block_multiple_of=16, full_attn_idxs=[1, 3]),
    depthformer=dict(layers=2, dim=32, num_heads=4, num_kv_heads=2),
    adapter_hidden_dims=[48], max_decode_len=128,
    preprocessor=dict(features=20))
LFM_DETOK_SMALL = dict(
    hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
    num_key_value_heads=2,
    layer_types=["conv", "sliding_attention", "conv", "sliding_attention"],
    intermediate_size=48, output_size=2 * (64 // 2 + 1), num_codebooks=4,
    vocab_size=32, n_fft=64, hop_length=16, upsample_factor=2,
    sliding_window=8)
# the JAX defaults, taken as the published models' (ROADMAP.md, "Assumed
# dims"): Smart Turn v2's encoder 384 x 4 over an 8-s window; Sortformer
# 4-speaker streaming (FastConformer 512 x 18, transformer 192 x 18, chunk
# and speaker cache 188); LFM2-Audio-1.5B (LFM2 2,048 x 16 with attention at
# layers 2, 5, 8, 10, 12 and 14, a FastConformer 17 x 512, a depthformer
# 6 x 1,024, 8 codebooks of 2,049, the detokenizer 8 x 512)
SLICE7A_FULL = {"smart_turn": {}, "sortformer": {}, "lfm_audio": {},
                "detokenizer": {}}
SORTFORMER_SECONDS = 60
LFM_AUDIO_SECONDS = 2
LFM_TOKENS = 48
LFM_Q8 = {"quantization": {"group_size": MLX_GROUP, "bits": 8}}


class LfmTok:
    """A stand-in text tokenizer for LFM2-Audio's chat state: each
    character a token in 200..200+n, BOS 1, `decode` the characters."""

    bos_token_id = 1

    def __init__(self, n: int = 50):
        self.n = n

    def encode(self, text, add_special_tokens=False):
        return [200 + ord(ch) % self.n for ch in text]

    def decode(self, tokens):
        return "".join(chr(97 + (int(t) - 200) % 26) for t in tokens
                       if int(t) >= 200)


def _slice7a_small(kind: str, device: str, like=None):
    """The small config of `kind` ("smart_turn", "sortformer", "lfm_audio",
    "detokenizer") at f32 on `device`: seeded from 0, or `like`'s
    weights."""
    if kind == "smart_turn":
        from mlx_audio_tpu_torch.vad.models.smart_turn import Model
        cfg = SMART_TURN_SMALL
    elif kind == "sortformer":
        from mlx_audio_tpu_torch.vad.models.sortformer import Model
        cfg = SORTFORMER_SMALL
    elif kind == "lfm_audio":
        from mlx_audio_tpu_torch.sts.models.lfm_audio import Model
        cfg = LFM_SMALL
    else:
        from mlx_audio_tpu_torch.sts.models.lfm_audio import \
            LFM2AudioDetokenizer as Model
        cfg = LFM_DETOK_SMALL
    model = Model(json.loads(json.dumps(cfg)), device=device)
    if like is None:
        return model.init_params(seed=0)
    model.load_state_dict(like.state_dict())
    return model


def _lfm_ready(model, detok):
    """`model` with a processor on its device: the stand-in tokenizer and
    `detok` bound (the release's tokenizer and detokenizer files are not in
    the repository)."""
    from mlx_audio_tpu_torch.sts.models.lfm_audio import LFM2AudioProcessor

    model._processor = LFM2AudioProcessor(model.config, tokenizer=LfmTok(),
                                          detokenizer=detok,
                                          device=model.device)
    return model


def _lfm_out(model, audio, tokens: int = 12, mode: str = "interleaved"):
    """A greedy chat request (16-kHz audio, then a short text) through
    the model's chat state -> ([(token ids, modality)], the detokenizer's
    waveform of its frames)."""
    import numpy as np

    from mlx_audio_tpu_torch.sts.models.lfm_audio import (AUDIO_EOS_TOKEN,
                                                          ChatState)

    chat = ChatState(model.processor)
    chat.new_turn("user")
    chat.add_audio(audio, 16000)
    chat.add_text("hi")
    chat.end_turn()
    chat.new_turn("assistant")
    out = [(np.asarray(t).tolist(), int(m)) for t, m in
           model.generate_from_chat_state(chat, mode=mode,
                                          max_new_tokens=tokens,
                                          temperature=0.0,
                                          audio_temperature=0.0)]
    frames = [t for t, m in out if m == 3 and t[0] != AUDIO_EOS_TOKEN]
    wav = model.processor.decode_with_detokenizer(
        np.asarray(frames).T[None]) if frames else np.zeros((1, 0))
    return out, wav


def _lfm_same(a, b, tol: float = 1e-3) -> bool:
    """Two `_lfm_out`s: the same tokens, waveforms within `tol`."""
    import numpy as np

    return a[0] == b[0] and a[1].shape == b[1].shape and (
        not a[1].size or float(np.abs(a[1] - b[1]).max()) < tol)


def write_slice7a_checkpoint(model, path: Path, config: dict,
                             quantization=None) -> None:
    """`model` as a checkpoint directory: its torch-layout state in npz and
    its config (with `quantization`, a dense directory that the loader
    quantizes)."""
    import numpy as np

    path.mkdir(parents=True)
    config = dict(config)
    if quantization:
        config.update(quantization)
    np.savez(path / "model.npz", **{k: v.detach().cpu().numpy()
                                    for k, v in model.state_dict().items()})
    (path / "config.json").write_text(json.dumps(config))


def phase_slice7a_reference(tmp: Path) -> int:
    """Phase 56: the small configs at f32 from one seeded weight set, the
    card against the CPU: Smart Turn's `predict_endpoint` at 16 and 8 kHz;
    Sortformer's `generate` and its AOSC `generate_stream` (speaker
    probabilities within 1e-4, the segments and the speaker cache's frames
    equal); LFM2-Audio's greedy chat request (2 s of audio and text, the
    detokenizer's waveform) interleaved and sequential; a q8 LFM2-Audio
    directory at group 16 through the STS loader (every linear on K2:
    tokens and waveform equal to the same model through
    `qmatmul_reference` and to the CPU's); tiny
    directories through the `vad` and `sts` loaders and the top-level
    `load_model` on the card. -> K2's launches, as its counter read them."""
    import numpy as np

    from mlx_audio_tpu_torch import load_model as route
    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.sts import utils as sts_utils
    from mlx_audio_tpu_torch.vad import utils as vad_utils

    t0 = time.perf_counter()
    qmm_kernel.launches = 0
    notes = []
    speech = _noise(56, 2.0)
    cpus = {kind: _slice7a_small(kind, "cpu") for kind in
            ("smart_turn", "sortformer", "lfm_audio", "detokenizer")}
    cards = {kind: _slice7a_small(kind, DEVICE, like=m)
             for kind, m in cpus.items()}
    # Smart Turn
    for sr in (16000, 8000):
        a = cpus["smart_turn"].predict_endpoint(speech[:sr], sr)
        b = cards["smart_turn"].predict_endpoint(speech[:sr], sr)
        if abs(a.probability - b.probability) > 1e-4 or \
                a.prediction != b.prediction:
            raise AssertionError(f"Smart Turn CUDA vs CPU at {sr} Hz: {b} vs "
                                 f"{a}")
    notes.append(f"Smart Turn equal (p {a.probability:.4f})")
    # Sortformer, offline and streamed with AOSC
    tone = _clip_audio(56, 3.0, 16000)
    a, b = cpus["sortformer"].generate(tone), cards["sortformer"].generate(
        tone)
    err = float(np.abs(a.speaker_probs - b.speaker_probs).max())
    if err > 1e-4 or [(s.start, s.end, s.speaker) for s in a.segments] != \
            [(s.start, s.end, s.speaker) for s in b.segments]:
        raise AssertionError(f"Sortformer CUDA vs CPU: {err:.2e}")
    for m in (cpus["sortformer"], cards["sortformer"]):
        m.config.modules_config.use_aosc = True
        m.config.modules_config.spkcache_len = 12
        m.config.modules_config.spkcache_update_period = 8
        m.config.modules_config.spkcache_sil_frames_per_spk = 1
    a = list(cpus["sortformer"].generate_stream(tone))[-1]
    b = list(cards["sortformer"].generate_stream(tone))[-1]
    run = cards["sortformer"].last_run
    err2 = float(np.abs(a.speaker_probs - b.speaker_probs).max())
    if err2 > 1e-4 or not run["compressions"]:
        raise AssertionError(f"Sortformer stream CUDA vs CPU: {err2:.2e}, "
                             f"{run}")
    notes.append(f"Sortformer equal ({err:.1e}; the AOSC stream {err2:.1e} "
                 f"over {run['steps']} steps, {run['compressions']} "
                 f"compressions)")
    # LFM2-Audio
    for m in ("cpu", "card"):
        d = cpus if m == "cpu" else cards
        _lfm_ready(d["lfm_audio"], d["detokenizer"])
    for mode in ("interleaved", "sequential"):
        want = _lfm_out(cpus["lfm_audio"], speech, mode=mode)
        got = _lfm_out(cards["lfm_audio"], speech, mode=mode)
        if not _lfm_same(got, want):
            raise AssertionError(f"LFM2-Audio {mode} CUDA vs CPU: {got[0]} "
                                 f"vs {want[0]}")
        notes.append(f"LFM2-Audio {mode} equal ({len(want[0])} tokens, "
                     f"{want[1].shape[-1]} samples)")
    # the q8 directory on K2
    d8 = tmp / "lfm-q8"
    write_slice7a_checkpoint(cpus["lfm_audio"], d8,
                             dict(LFM_SMALL, model_type="lfm_audio"),
                             {"quantization": {"group_size": 16, "bits": 8}})
    # at group 16 (the JAX test's widths are 32 to 96): held here against
    # the plain version, not in phase 8's set, which quantizes at group 64
    q8 = _lfm_ready(sts_utils.load_model(d8, device=DEVICE),
                    cards["detokenizer"])
    held = sum(isinstance(m, QuantizedLinear) for m in q8.modules())
    k2 = qmm_kernel.launches
    got = _lfm_out(q8, speech)
    k2 = qmm_kernel.launches - k2
    with K2AsReference():
        ref = _lfm_out(q8, speech)
    qc = _lfm_ready(sts_utils.load_model(d8, device="cpu"),
                    cpus["detokenizer"])
    cpu_q8 = _lfm_out(qc, speech)
    if not (held and k2 and _lfm_same(got, ref) and _lfm_same(got, cpu_q8)):
        raise AssertionError(f"q8 LFM2-Audio: {held} quantized linears, {k2} "
                             f"K2 launches; equal to the plain version's "
                             f"{_lfm_same(got, ref)}, the CPU's "
                             f"{_lfm_same(got, cpu_q8)}")
    notes.append(f"q8 LFM2-Audio: {held} linears on K2, {k2} launches")
    # the loaders on the card
    for kind, load, cfg in (("smart_turn", vad_utils.load_model,
                             SMART_TURN_SMALL),
                            ("sortformer", vad_utils.load_model,
                             SORTFORMER_SMALL),
                            ("lfm_audio", sts_utils.load_model, LFM_SMALL)):
        d = tmp / f"{kind}-tiny"
        write_slice7a_checkpoint(cpus[kind], d, dict(cfg, model_type=kind))
        for loader in (load, route):
            m = loader(d, device=DEVICE)
            if type(m) is not type(cards[kind]):
                raise AssertionError(f"the loaders on the card: {kind}")
            if kind == "smart_turn":
                same = m(speech[:1600].reshape(-1, 20)[None]).tolist() == \
                    cards[kind](speech[:1600].reshape(-1, 20)[None]).tolist()
            elif kind == "sortformer":
                mel = speech[:640].reshape(40, 16)
                same = np.array_equal(m.predict(mel),
                                      _slice7a_small(kind, DEVICE,
                                                     like=cpus[kind])
                                      .predict(mel))
            else:
                same = _lfm_same(_lfm_out(_lfm_ready(m, cards["detokenizer"]),
                                          speech),
                                 _lfm_out(cards[kind], speech))
            if not same:
                raise AssertionError(f"the loaders on the card: {kind}")
    notes.append("vad.utils, sts.utils and the top-level load_model on the "
                 "three tiny directories, each as the card's model")
    log(f"[slice7a] small configs on the card against the CPU: "
        f"{'; '.join(notes)} ({time.perf_counter() - t0:.1f} s)")
    return qmm_kernel.launches


def _build_lfm_full():
    """LFM2-Audio-1.5B at the JAX defaults drawn on the card in f32 from
    seed 0, the rows that end a request zeroed (<|im_end|> and <|text_end|>
    in the tied table, the audio EOS in the first codebook's head), so that
    a greedy request runs its LFM_TOKENS steps, cast to bf16; the full
    detokenizer likewise; the stand-in tokenizer."""
    import torch

    from mlx_audio_tpu_torch.sts.models.lfm_audio import (
        AUDIO_EOS_TOKEN, IM_END_TOKEN, TEXT_END_TOKEN, LFM2AudioDetokenizer,
        Model)

    t0 = time.perf_counter()
    model = Model(SLICE7A_FULL["lfm_audio"], device=DEVICE).init_params(
        seed=0, on_device=True)
    with torch.no_grad():
        model.lfm.embed_tokens.weight[[IM_END_TOKEN, TEXT_END_TOKEN]] = 0.0
        if AUDIO_EOS_TOKEN < model.config.audio_vocab_size:
            model.depth_embeddings.to_logits[0, AUDIO_EOS_TOKEN] = 0.0
    model.astype(torch.bfloat16)
    detok = LFM2AudioDetokenizer(SLICE7A_FULL["detokenizer"],
                                 device=DEVICE).init_params(
        seed=1, on_device=True).astype(torch.bfloat16)
    torch.cuda.empty_cache()
    _lfm_ready(model, detok)
    torch.cuda.synchronize()
    log(f"[lfm-audio] LFM2-Audio-1.5B dims (LFM2 16 x d2048, attention at "
        f"layers 2, 5, 8, 10, 12, 14, GQA 32/8, FFN 8,192, vocabulary "
        f"65,536; FastConformer 17 x 512; depthformer 6 x 1,024; 8 codebooks "
        f"of 2,049; detokenizer 8 x 512): {model.num_params():,} + "
        f"{detok.num_params():,} params bf16 on cuda, built in "
        f"{time.perf_counter() - t0:.2f} s")
    return model


def lfm_step_bytes(model, cache_cols: float) -> tuple:
    """Bytes an LFM2-Audio decode step must read: (a text step, an audio
    step). Both read the LFM2's weights (every tensor of its layers once:
    bf16, or K2's codes one a byte with f32 scales and biases), the K and
    V of `cache_cols` columns of its attention layers, and the next input's
    embedding rows; a text step the tied table whole (its head), an audio
    step the frame's depthformer: `depth_linear` once, the 6 blocks' weights
    once a codebook (8 passes, each a separate step), each codebook's head
    table and one row of its input table."""
    c, lc, d = (model.config, model.config.lfm_config,
                model.config.depthformer_config)

    def size(module) -> float:
        return float(sum(t.numel() * t.element_size() for t in
                         list(module.parameters()) + list(module.buffers())))

    lfm = size(model.lfm.layers) + size(model.lfm.embedding_norm)
    kv = model.lfm.embed_tokens.weight.element_size()
    lfm += 2 * model.lfm.n_attn * cache_cols * lc.num_key_value_heads \
        * lc.head_dim * kv
    table = model.lfm.embed_tokens.weight
    text = lfm + table.numel() * table.element_size() + lc.hidden_size * kv
    tables = model.depth_embeddings
    audio = (lfm + size(model.depth_linear)
             + c.codebooks * size(model.audio_head.blocks)
             + tables.to_logits.numel() * tables.to_logits.element_size()
             + c.codebooks * (d.dim + lc.hidden_size) * kv)
    return text, audio


def _lfm_run(model, audio, label: str, card: str, base: int) -> dict:
    """One interleaved chat request of LFM_TOKENS greedy steps on
    `audio`: the ms to the first text token and the first audio frame,
    ms a step p50 over the decode's chunks after the first, peak memory;
    then the first LFM_PROFILE_STEPS decode steps from one prefill (6 text
    steps and 2 audio frames), timed, then profiled (kernels, device ms
    and busy share a step, K2's launches a step). -> the numbers."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.sts.models.lfm_audio.lfm_audio import (
        _Interleaved, _plan)

    laps = Laps(f"lfm-audio {label}")
    model.generate("hi", audio=audio, sample_rate=16000, max_new_tokens=8,
                   temperature=0.0, audio_temperature=0.0)
    laps("warm-up")
    torch.cuda.reset_peak_memory_stats()
    r = model.generate("hi", audio=audio, sample_rate=16000,
                       max_new_tokens=LFM_TOKENS, temperature=0.0,
                       audio_temperature=0.0)
    run = dict(model.last_run)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    laps("the request")
    per_step = [ms / n for n, ms in run["chunks"][1:]]
    if not (run["steps"] == LFM_TOKENS and run["audio_frames"] and
            run["text_tokens"] and np.isfinite(r.audio).all() and per_step):
        raise AssertionError(f"LFM2-Audio {label}: {run}")
    # the decode alone, from one prefill, timed then profiled
    c = model.config
    feats = model.processor.preprocess_audio(audio, 16000)[None]
    toks = np.asarray([[1] + LfmTok().encode("hi")], np.int32)
    n_audio = model.encode_audio(feats).shape[1]
    mods = np.asarray([[1] + [2] * n_audio + [1] * (toks.shape[1] - 1)],
                      np.int32)

    def decode():
        hidden, caches, off = model._prefill(toks, feats, None, mods,
                                             LFM_PROFILE_STEPS)
        sched = _Interleaved(c.interleaved_n_text, c.interleaved_n_audio,
                             LFM_PROFILE_STEPS)
        return hidden, caches, off, sched

    def steps(state):
        hidden, caches, off, sched = state
        list(model._decode(sched, hidden, caches, off, 0.0, 1, 0.0, 1, 0))

    state = decode()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps(state)
    wall = (time.perf_counter() - t1) * 1e3 / LFM_PROFILE_STEPS
    state = decode()
    k2 = qmm_kernel.launches
    prof = _device_kernels(lambda: steps(state), cpu=False)
    k2_step = (qmm_kernel.launches - k2) / LFM_PROFILE_STEPS
    dev_ms = sum(_dev_us(e) for e in prof) / 1e3 / LFM_PROFILE_STEPS
    kernels = sum(e.count for e in prof) / LFM_PROFILE_STEPS
    laps("profiled steps")
    laps.log()
    if not (kernels > 0 and dev_ms > 0):
        raise AssertionError("LFM2-Audio: the profiler saw no kernel")
    # the bytes of the profiled steps (the plan of the schedule's first
    # LFM_PROFILE_STEPS, no token changing it), over the card's memory rate
    text_b, audio_b = lfm_step_bytes(model, run["prompt"]
                                     + LFM_PROFILE_STEPS / 2)
    sched = _Interleaved(c.interleaved_n_text, c.interleaved_n_audio,
                         LFM_PROFILE_STEPS)
    n_audio = sum(m == 3 for m, _ in _plan(sched, sched.initial,
                                            LFM_PROFILE_STEPS))
    bound = ((LFM_PROFILE_STEPS - n_audio) * text_b + n_audio * audio_b) \
        / LFM_PROFILE_STEPS / HBM_BPS * 1e3
    res = dict(first_text=run["first_text_ms"],
               first_audio=run["first_audio_ms"],
               p50=float(np.percentile(per_step, 50)),
               p95=float(np.percentile(per_step, 95)), peak=peak,
               kernels=kernels, dev_ms=dev_ms, busy=dev_ms / wall,
               wall=wall, k2_step=k2_step, prompt=run["prompt"],
               text_gb=text_b / 1e9, audio_gb=audio_b / 1e9, bound=bound,
               text=run["text_tokens"], frames=run["audio_frames"],
               samples=r.samples)
    log(f"[lfm-audio] {label}: {LFM_AUDIO_SECONDS} s of audio and text in a "
        f"{res['prompt']}-row prompt, {LFM_TOKENS} greedy interleaved steps "
        f"({res['text']} text tokens, {res['frames']} audio frames -> "
        f"{res['samples']} samples): first text {res['first_text']:.1f} ms, "
        f"first audio {res['first_audio']:.1f} ms, {res['p50']:.2f} ms a "
        f"step p50, {res['p95']:.2f} p95, peak {peak:.2f} GB above the "
        f"earlier phases'; the first {LFM_PROFILE_STEPS} decode steps: "
        f"{kernels:.0f} kernels and {dev_ms:.3f} ms of device time a step "
        f"against {wall:.2f} ms of wall ({100 * res['busy']:.1f}% busy), "
        f"{k2_step:.1f} K2 launches a step; bytes a text step "
        f"{res['text_gb']:.3f} GB, an audio step {res['audio_gb']:.3f} GB, "
        f"bound of those steps {bound:.3f} ms a step (bytes; "
        f"{100 * bound / dev_ms:.1f}% of their device time) ({card})")
    return res


def phase_slice7a_full(card: str, recorder: K2Recorder) -> int:
    """Phase 57: the three families at the JAX defaults on the card, each
    seeded there: Smart Turn's `predict_endpoint` on 8 s and 3 s in bf16
    (against f32); Sortformer's `generate` on SORTFORMER_SECONDS of audio
    and its `generate_stream` over the same audio, which compresses the
    speaker cache (bf16 against f32); LFM2-Audio-1.5B in bf16, then with
    every linear quantized to q8 on K2 (`apply_quantization`), each on one
    interleaved chat request (`_lfm_run`), the first-step logits q8 against
    bf16. -> K2's launches, as its counter read them."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.nn import Linear, QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.sts.models.lfm_audio.lfm2 import lfm2_logits
    from mlx_audio_tpu_torch.utils import apply_quantization
    from mlx_audio_tpu_torch.vad.models.smart_turn import Model as SmartTurn
    from mlx_audio_tpu_torch.vad.models.sortformer import Model as Sortformer

    t_phase = time.perf_counter()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    # Smart Turn
    st = SmartTurn(SLICE7A_FULL["smart_turn"], device=DEVICE).init_params(
        seed=0, on_device=True)
    st16 = SmartTurn(SLICE7A_FULL["smart_turn"], device=DEVICE)
    st16.load_state_dict(st.state_dict())
    st16.astype(torch.bfloat16)
    parts = []
    for seconds in (8, 3):
        audio = _noise(57, seconds)
        st16.predict_endpoint(audio)
        out, s = _sync_s(lambda: st16.predict_endpoint(audio))
        ref = st.predict_endpoint(audio)
        if not (np.isfinite(out.probability)
                and abs(out.probability - ref.probability) < 0.02):
            raise AssertionError(f"Smart Turn bf16 {out} vs f32 {ref}")
        parts.append(f"{seconds} s in {s * 1e3:.2f} ms (p {out.probability:.4f}"
                     f", f32 {ref.probability:.4f})")
    log(f"[smart-turn] encoder 4 x d384 over 8 s, bf16: "
        f"{'; '.join(parts)} ({card})")
    del st, st16
    # Sortformer
    sf = Sortformer(SLICE7A_FULL["sortformer"], device=DEVICE).init_params(
        seed=0, on_device=True)
    sf16 = Sortformer(SLICE7A_FULL["sortformer"], device=DEVICE)
    sf16.load_state_dict(sf.state_dict())
    sf16.astype(torch.bfloat16)
    audio = _noise(57, SORTFORMER_SECONDS)
    sf16.generate(audio[:16000 * 4])
    out, s = _sync_s(lambda: sf16.generate(audio))
    run = dict(sf16.last_run)
    ref = sf.generate(audio)
    err = float(np.abs(out.speaker_probs - ref.speaker_probs).max())
    if not (np.isfinite(out.speaker_probs).all() and err < 0.05):
        raise AssertionError(f"Sortformer bf16 vs f32: {err:.3e}")
    chunks, s2 = _sync_s(lambda: list(sf16.generate_stream(audio)))
    srun = dict(sf16.last_run)
    if not (srun["compressions"] and np.isfinite(
            chunks[-1].speaker_probs).all()):
        raise AssertionError(f"Sortformer stream: {srun}")
    log(f"[sortformer] 4 speakers, FastConformer 18 x d512, transformer 18 "
        f"x d192, bf16: generate on {SORTFORMER_SECONDS} s in "
        f"{s * 1e3:.1f} ms ({run['mel_frames']} mel frames -> "
        f"{run['frames']} frames, forward {run['forward_ms']:.1f} ms, "
        f"max |bf16 - f32| {err:.2e}); generate_stream in {s2 * 1e3:.1f} ms "
        f"over {srun['steps']} chunks of 188 frames, {srun['compressions']} "
        f"speaker-cache compressions, cache {srun['spkcache']} frames "
        f"({card})")
    del sf, sf16, out, ref, chunks
    torch.cuda.empty_cache()
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("Smart Turn or Sortformer launched K1 or K2")
    # LFM2-Audio-1.5B, bf16 then q8 on K2
    base = torch.cuda.memory_allocated()
    model = _build_lfm_full()
    audio = _noise(57, LFM_AUDIO_SECONDS)
    bf16 = _lfm_run(model, audio, "bf16", card, base)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the bf16 LFM2-Audio launched K1 or K2")
    feats = model.processor.preprocess_audio(audio, 16000)[None]

    def first_logits():
        hidden, _, _ = model._prefill(np.asarray([[1, 5, 9]], np.int32),
                                      feats, None, None, 1)
        return lfm2_logits(model.lfm, hidden[:, -1])

    want = first_logits()
    t1 = time.perf_counter()
    apply_quantization(model, LFM_Q8)
    torch.cuda.empty_cache()
    held = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    dense = sum(isinstance(m, Linear) for m in model.modules())
    log(f"[lfm-audio] every linear quantized to 8 bits (group {MLX_GROUP}) "
        f"on the card in {time.perf_counter() - t1:.2f} s: {held} on K2, "
        f"{dense} dense; the tables, the short convs' taps and the "
        f"detokenizer bf16")
    qmm_kernel.launches = 0
    with recorder:
        q8 = _lfm_run(model, audio, "q8 (K2)", card, base)
        got = first_logits()
    k2 = qmm_kernel.launches
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    if dense or not (torch.isfinite(got).all() and rel < ASR_Q8_REL
                     and q8["k2_step"] > 0):
        raise AssertionError(f"q8 LFM2-Audio: {dense} dense linears, logits "
                             f"vs bf16 relative {rel:.3e}, {q8['k2_step']} "
                             f"K2 launches a step")
    log(f"[lfm-audio] q8 against bf16 on this card: first text "
        f"{q8['first_text']:.1f} vs {bf16['first_text']:.1f} ms, first "
        f"audio {q8['first_audio']:.1f} vs {bf16['first_audio']:.1f} ms, "
        f"{q8['p50']:.2f} vs {bf16['p50']:.2f} ms a step p50, "
        f"{q8['kernels']:.0f} vs {bf16['kernels']:.0f} kernels and "
        f"{q8['dev_ms']:.3f} vs {bf16['dev_ms']:.3f} ms of device time a "
        f"step, busy {100 * q8['busy']:.1f}% vs {100 * bf16['busy']:.1f}%, "
        f"peak {q8['peak']:.2f} vs {bf16['peak']:.2f} GB; K2 launched {k2} "
        f"times, {q8['k2_step']:.1f} a decode step; first-step logits q8 vs "
        f"bf16 relative {rel:.3e} (limit {ASR_Q8_REL:g}) ({card})")
    del model
    torch.cuda.empty_cache()
    log(f"[time] phase 57 in {time.perf_counter() - t_phase:.1f} s")
    return k2


def phase_slice7a(card: str, recorder: K2Recorder) -> int:
    """Phases 56-57; K1 never launches, K2 only on the q8 LFM2-Audio
    models. -> K2's launches there."""
    import torch

    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    t0 = time.perf_counter()
    k1 = snake_conv_kernel.launches
    with tempfile.TemporaryDirectory() as tmp:
        k2 = phase_slice7a_reference(Path(tmp))
    torch.cuda.empty_cache()
    k2 += phase_slice7a_full(card, recorder)
    if snake_conv_kernel.launches != k1:
        raise AssertionError("phases 56-57 launched K1")
    log(f"[time] phases 56-57 in {time.perf_counter() - t0:.1f} s; K1 not "
        f"launched")
    return k2


# ---------------------------------------------------------------------------
# DACVAE and SAM-Audio, the voice pipeline, the WER eval CLI (phases 58-61)
# ---------------------------------------------------------------------------

# tests/test_sam_audio.py:27-35: the small config of the card-against-CPU
# checks, its DACVAE's among them (hop 8: 512 samples make 64 frames)
SAM_SMALL = dict(
    in_channels=48,
    audio_codec=dict(encoder_dim=4, encoder_rates=[2, 4], latent_dim=16,
                     decoder_dim=8, decoder_rates=[4, 2], codebook_dim=8,
                     sample_rate=16000),
    text_encoder=dict(vocab_size=64, d_model=16, d_kv=4, d_ff=32,
                      num_layers=2, num_heads=4, dim=16),
    transformer=dict(dim=32, n_heads=4, n_layers=2, context_dim=32,
                     out_channels=16, ffn_exp=2, frequency_embedding_dim=16),
    num_anchors=3, anchor_embedding_dim=8)
# SAM-Audio at the JAX package's defaults, taken as the published
# SAM-Audio-large (an assumption; only its config.json would confirm it):
# the DiT 2,816 x 22, 22 heads, swiglu FFN 7,552, context 2,816, out 256,
# in_channels 768; T5-base; DACVAE at 48 kHz (hop 1,920)
SAM_FULL = {}
SAM_TEXT = "a dog barking in the rain"
SAM_SECONDS, SAM_LONG_SECONDS = 10, 30
SAM_SMALL_ATOL = 1e-4              # small configs at f32: summation order
# bf16 against f32 on one DiT evaluation (22 layers at d2,816), and the q8
# model's against bf16's (random 8-bit group-64 codes), relative Frobenius
SAM_BF16_REL, SAM_Q8_REL = 5e-2, 1e-1
SAM_Q8 = {"quantization": {"group_size": MLX_GROUP, "bits": 8}}
# the DiT's linears at the clip's rows a layer: self-attention's four and
# cross-attention's query and output (d x d), the FFN's w1 and w3, its w2
SAM_DIT_SHAPES = ((2816, 2816), (7552, 2816), (2816, 7552))
SAM_DIT_PER_LAYER = (6, 2, 1)
# the voice pipeline's turn: Silero at ModelConfig(), Smart Turn v2 at the
# JAX defaults, Whisper large-v3-turbo, an LM at Llama-3.2-1B's dims
# (meta-llama/Llama-3.2-1B's config.json: 16 x d2048, GQA 32/8 of 64, FFN
# 8,192, 128,256 ids, tied, RoPE 500,000 with llama3 scaling of 32) with a
# 32-token greedy reply, Kokoro-82M
LLAMA_1B = dict(hidden_size=2048, num_hidden_layers=16, intermediate_size=8192,
                num_attention_heads=32, num_key_value_heads=8, head_dim=64,
                vocab_size=128256, rope_theta=500000.0, rms_norm_eps=1e-5,
                tie_word_embeddings=True,
                rope_scaling=dict(rope_type="llama3", factor=32.0,
                                  low_freq_factor=1.0, high_freq_factor=4.0,
                                  original_max_position_embeddings=8192))
TURN_SPEECH_S, TURN_SILENCE_S, TURN_REPLY_TOKENS = 2.5, 1.5, 32
# the stand-in speech probability's RMS gate (the speech's frames read
# 0.1-0.5, the silence's 1e-3)
TURN_RMS = 0.02
TURN_WORDS = ("the", "voice", "answers", "you", "now", "with", "a", "short",
              "reply", "about", "your", "day", "and", "weather", "here")
# Whisper's greedy decode in the pipeline's STT (thresholds off: random
# weights would fall back to sampling at every temperature)
TURN_STT_KW = dict(language="en", temperature=0.0,
                   compression_ratio_threshold=None, logprob_threshold=None,
                   no_speech_threshold=None, return_timestamps=False,
                   sample_len=32)
EVAL_KW = {"temperature": 0.0, "return_timestamps": False}


class SamTok:
    """A stand-in T5 tokenizer: each character an id in 2..vocab-1, EOS
    1, padding 0 to the longest (tests/test_sam_audio.py's FakeT5Tok at
    any vocabulary)."""

    def __init__(self, vocab: int = 64):
        self.vocab = vocab

    def __call__(self, texts, truncation=True, max_length=512,
                 padding="longest", return_tensors="np"):
        import numpy as np

        ids = [[ord(c) % (self.vocab - 2) + 2 for c in t][:max_length - 1]
               + [1] for t in texts]
        n = max(len(i) for i in ids)
        input_ids = np.zeros((len(ids), n), np.int64)
        mask = np.zeros((len(ids), n), np.int64)
        for r, row in enumerate(ids):
            input_ids[r, :len(row)] = row
            mask[r, :len(row)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}


class WordTok:
    """A stand-in LM tokenizer for the voice pipeline's reply: characters
    in, ids out as words of TURN_WORDS (Kokoro can speak them); no EOS."""

    eos_token_id = None

    def encode(self, text):
        return [ord(c) % 1000 + 1 for c in text]

    def decode(self, ids):
        return " ".join(TURN_WORDS[int(i) % len(TURN_WORDS)] for i in ids)


def write_sam_checkpoint(model, path: Path, config: dict,
                         quantization=None) -> None:
    """`model` as a SAM-Audio directory: config.json (with a `quantization`
    entry the loader quantizes the linears) and the JAX tree
    (`model.jax_params`: WIO convs, pre-flipped transposed ones) in npz,
    which `sanitize` reads by shape."""
    import numpy as np

    from mlx_audio_tpu_torch.model import jax_params

    path.mkdir(parents=True, exist_ok=True)
    cfg = dict(config, model_type="sam_audio")
    if quantization:
        cfg.update(quantization)
    (path / "config.json").write_text(json.dumps(cfg))
    np.savez(path / "model.npz", **{k: v.float().cpu().numpy()
                                    for k, v in jax_params(model).items()})


def _sam_small(device: str, like=None):
    from mlx_audio_tpu_torch.sts.models.sam_audio import Model

    m = Model(SAM_SMALL, device=device)
    if like is None:
        m.init_params(seed=0)
    else:
        m.load_state_dict(like.state_dict())
    m.tokenizer = SamTok()
    return m


def _numpy_draws(model):
    """`model` drawing its ODE noise from numpy (seeded by the chunk's
    seed), so that the card and the CPU draw the same."""
    import numpy as np
    import torch

    model._draw_noise = lambda shape, seed: torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32)).to(
        model.device)
    return model


def _sam_same(a, b, atol=SAM_SMALL_ATOL) -> float:
    """The largest |difference| over two results' targets and residuals;
    raises past `atol` or on a shape mismatch."""
    import numpy as np

    worst = 0.0
    for x, y in zip(a.target + a.residual, b.target + b.residual):
        if x.shape != y.shape or not np.isfinite(x).all():
            raise AssertionError(f"SAM-Audio shapes {x.shape} vs {y.shape}")
        worst = max(worst, float(np.abs(x - y).max()))
    if worst > atol:
        raise AssertionError(f"SAM-Audio max |diff| {worst:.3e} > {atol:g}")
    return worst


def phase_sam_reference(tmp: Path) -> int:
    """Phase 58: the small configs at f32 from one seeded weight set, the
    card against the CPU: DACVAE's encode, decode and chunked decode;
    SAM-Audio's `separate` at 64 frames (euler and midpoint, an anchor),
    `separate_long` in three chunks (numpy-seeded draws on both), each
    within SAM_SMALL_ATOL; a q8 SAM-Audio directory at group 16 through the
    STS loader (every Linear whose inputs the group divides on K2: equal
    to the same model through `qmatmul_reference` and to the CPU's); tiny
    directories through the `sts` and `codec` loaders and the top-level
    `load_model` on the card; one `AudioServer` separation equal to
    `separate_long`. -> K2's launches, as its counter read them."""
    import asyncio
    import base64
    import io

    import numpy as np

    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch import load_model as route
    from mlx_audio_tpu_torch.codec import utils as codec_utils
    from mlx_audio_tpu_torch.nn import Linear, QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.server import AudioServer
    from mlx_audio_tpu_torch.sts import utils as sts_utils

    t0 = time.perf_counter()
    qmm_kernel.launches = 0
    notes = []
    cpu = _numpy_draws(_sam_small("cpu"))
    card = _numpy_draws(_sam_small(DEVICE, like=cpu))
    # DACVAE
    wav = _clip_audio(58, 0.05, 16000)
    z = np.random.RandomState(58).randn(1, 8, 64).astype(np.float32)
    errs = []
    for fn in (lambda m: m.encode(wav), lambda m: m.decode(z),
               lambda m: m.decode(z, chunk_size=16)):
        a, b = fn(cpu.audio_codec), fn(card.audio_codec).cpu()
        errs.append(float((a - b).abs().max()))
    if max(errs) > SAM_SMALL_ATOL:
        raise AssertionError(f"DACVAE CUDA vs CPU: {errs}")
    notes.append(f"DACVAE encode, decode and chunked decode "
                 f"{max(errs):.1e}")
    # SAM-Audio
    audio = _clip_audio(58, 512 / 16000, 16000)[None, None]
    noise = np.random.RandomState(5).randn(1, 64, 16).astype(np.float32)
    err = 0.0
    for method, step, anchors in (("euler", 0.5, None),
                                  ("midpoint", 0.25, None),
                                  ("euler", 0.5, [[("+", 0.0, 0.01)]])):
        kw = dict(noise=noise, anchors=anchors,
                  ode_opt={"step_size": step, "method": method})
        err = max(err, _sam_same(card.separate(audio, [SAM_TEXT], **kw),
                                 cpu.separate(audio, [SAM_TEXT], **kw)))
    long_audio = _clip_audio(59, 1280 / 16000, 16000)
    lkw = dict(chunk_seconds=512 / 16000, overlap_seconds=128 / 16000,
               ode_opt={"step_size": 0.5, "method": "euler"}, seed=7)
    err_l = _sam_same(card.separate_long(long_audio, [SAM_TEXT], **lkw),
                      cpu.separate_long(long_audio, [SAM_TEXT], **lkw))
    notes.append(f"SAM-Audio separate (euler, midpoint, an anchor) "
                 f"{err:.1e}, separate_long {err_l:.1e}")
    # the q8 directory on K2
    d8 = tmp / "sam-q8"
    write_sam_checkpoint(cpu, d8, SAM_SMALL,
                         {"quantization": {"group_size": 16, "bits": 8}})
    q8 = sts_utils.load_model(d8, device=DEVICE)
    q8.tokenizer = SamTok()
    held = sum(isinstance(m, QuantizedLinear) for m in q8.modules())
    dense = [n for n, m in q8.named_modules() if isinstance(m, Linear)]
    kw = dict(noise=noise, ode_opt={"step_size": 0.5, "method": "euler"})
    k2 = qmm_kernel.launches
    got = q8.separate(audio, [SAM_TEXT], **kw)
    k2 = qmm_kernel.launches - k2
    with K2AsReference():
        ref = q8.separate(audio, [SAM_TEXT], **kw)
    qc = sts_utils.load_model(d8, device="cpu")
    qc.tokenizer = SamTok()
    e_ref = _sam_same(got, ref)
    e_cpu = _sam_same(got, qc.separate(audio, [SAM_TEXT], **kw))
    if not (held == 44 and dense == ["embed_anchors.proj"] and k2):
        raise AssertionError(f"q8 SAM-Audio: {held} quantized linears, "
                             f"dense {dense}, {k2} K2 launches")
    notes.append(f"q8 SAM-Audio: {held} linears on K2 ({k2} launches; the "
                 f"anchors' 8-input proj dense), against the plain version "
                 f"{e_ref:.1e}, the CPU {e_cpu:.1e}")
    # the loaders on the card
    d = tmp / "sam-tiny"
    write_sam_checkpoint(cpu, d, SAM_SMALL)
    want = card.separate(audio, [SAM_TEXT], **kw)
    for loader in (sts_utils.load_model, route):
        m = loader(d, device=DEVICE)
        m.tokenizer = SamTok()
        _sam_same(m.separate(audio, [SAM_TEXT], **kw), want, atol=0.0)
    dv = tmp / "dacvae-tiny"
    dv.mkdir()
    (dv / "config.json").write_text(json.dumps(
        dict(SAM_SMALL["audio_codec"], model_type="dacvae")))
    with np.load(d / "model.npz") as tree:
        np.savez(dv / "model.npz", **{k[len("audio_codec."):]: tree[k]
                                      for k in tree.files
                                      if k.startswith("audio_codec.")})
    codec = codec_utils.load_model(dv, device=DEVICE)
    if not bool((codec.decode(z) == card.audio_codec.decode(z)).all()):
        raise AssertionError("the codec loader's DACVAE differs")
    notes.append("sts.utils, the top-level load_model and codec.utils on "
                 "the tiny directories, each as the card's model")
    # the server's separation route
    x = _clip_audio(60, 0.25, 16000)
    buf = io.BytesIO()
    audio_io.write(buf, x, 16000)

    async def serve():
        server = AudioServer(device=DEVICE)
        server.provider._models["sam-small"] = card
        try:
            return await server.separate(
                {"model": "sam-small", "description": SAM_TEXT, "steps": "2",
                 "method": "euler"}, buf.getvalue())
        finally:
            server.close()

    reply = asyncio.run(serve())
    heard, _ = audio_io.read(io.BytesIO(buf.getvalue()), dtype="float32")
    want = card.separate_long(heard[None, None], [SAM_TEXT],
                              ode_opt={"step_size": 0.5, "method": "euler"}
                              ).target[0].reshape(-1)
    tgt, _ = audio_io.read(io.BytesIO(base64.b64decode(
        reply.json["target"])), dtype="float32") if reply.status == 200 \
        else (None, None)
    if tgt is None or tgt.shape != want.shape or \
            float(np.abs(tgt - want).max()) > 1 / 32767 + 1e-6:
        raise AssertionError(f"the separation route: {reply.status}")
    notes.append("AudioServer's separation route equal to separate_long")
    log(f"[sam-audio small] small configs on the card against the CPU: "
        f"{'; '.join(notes)} ({time.perf_counter() - t0:.1f} s)")
    return qmm_kernel.launches


def sam_dit_bound(model, m: int, text: int, q8: bool) -> tuple:
    """The least time one DiT evaluation (the velocity: `proj`,
    `memory_proj`, the DiT) could take at `m` audio rows and `text` text
    rows, B = 1: the larger of its operations (each linear's 2 M out in at
    its rows, the attention's products, the x_embedder's convs) over 989
    TFLOP/s and its bytes (each weight once: bf16, or codes one a byte with
    f32 scales and biases a group of 64 when `q8`; each linear's x in and
    y out in bf16) over 3.35 TB/s. -> (ms, "operations" or "bytes", TFLOP,
    GB)."""
    cfg = model.config.dit_cfg
    d = cfg.dim
    ops = nbytes = 0.0
    for name, mod in model.named_modules():
        if not hasattr(mod, "in_features") or "text_encoder" in name \
                or "embed_anchors" in name:
            continue
        n = (mod.weight.shape[0] if hasattr(mod, "weight") and
             mod.weight is not None else mod.w_q.shape[0])
        k = mod.in_features
        if name.endswith("t_block") or "t_embedder" in name:
            mm = 1
        elif name == "memory_proj" or "y_embedder" in name or (
                "cross_attention" in name and name.endswith(("wk", "wv"))):
            mm = text
        else:
            mm = m
        ops += 2 * mm * n * k
        w = n * k + 2 * n * (k // QMM_GROUP) * 4 if q8 else 2 * n * k
        nbytes += w + 2 * mm * (n + k)
    ops += cfg.n_layers * 2 * 2 * m * (m + text) * d          # attention
    ops += 2 * 2 * m * 3 * d * d                              # x_embedder
    nbytes += 2 * 2 * 3 * d * d
    by_ops, by_bytes = ops / PEAK_BF16 * 1e3, nbytes / HBM_BPS * 1e3
    return (max(by_ops, by_bytes),
            "operations" if by_ops >= by_bytes else "bytes", ops / 1e12,
            nbytes / 1e9)


def _sam_inputs(model, seconds: float):
    """One DiT evaluation's inputs on `seconds` of seeded 48-kHz audio:
    (noisy f32, the audio features, T5's features and mask, t, the
    padding mask), in the model's dtype."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.codec.models.dacvae import dacvae_encode

    dev, dt = model.device, model.dtype
    n = int(seconds * model.sample_rate)
    wav = torch.from_numpy(_clip_audio(61, seconds, model.sample_rate)
                           ).to(dev)[None, :, None]
    feats = dacvae_encode(model.audio_codec, wav.to(dt)).transpose(1, 2)
    feats = torch.cat([feats, feats], dim=2)
    text, mask = model.encode_text([SAM_TEXT])
    g = torch.Generator(device=dev).manual_seed(0)
    noisy = torch.randn(feats.shape, generator=g, device=dev)
    pad = torch.ones(feats.shape[:2], dtype=torch.bool, device=dev)
    t = torch.tensor(0.25, device=dev)
    assert feats.shape[1] == -(-n // model.hop_length)
    return noisy, feats, text, mask, t, pad


def _sam_eval(model, inputs):
    """One DiT evaluation (`velocity`) on `_sam_inputs`' inputs."""
    import torch

    noisy, feats, text, mask, t, pad = inputs
    with torch.inference_mode():
        return model.velocity(noisy, feats.to(model.dtype),
                              text.to(model.dtype), t, mask, None, None, pad)


def _sam_run(model, label: str, card: str, base: int, long: bool) -> dict:
    """One `separate` of SAM_SECONDS at the default ODE (midpoint, 16
    steps) after a 2-step warm-up: wall, xRT, peak memory; the ms of the
    encode, the T5 pass, one DiT evaluation (CUDA events, median of 5) and
    the decode; one DiT evaluation profiled (kernels, device ms, busy
    share) against its bound; with `long`, `separate_long` of
    SAM_LONG_SECONDS too. -> the numbers."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.codec.models.dacvae import (dacvae_decode,
                                                         dacvae_encode)

    laps = Laps(f"sam-audio {label}")
    sr = model.sample_rate
    audio = _clip_audio(62, SAM_SECONDS, sr)
    model.separate(audio, [SAM_TEXT], ode_opt={"step_size": 0.5})
    laps("warm-up")
    torch.cuda.reset_peak_memory_stats()
    res, wall = _sync_s(lambda: model.separate(audio, [SAM_TEXT], seed=1))
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    run = dict(model.last_run)
    if not (run["evals"] == 32 and res.target[0].shape
            == (SAM_SECONDS * sr, 1) and np.isfinite(res.target[0]).all()
            and np.isfinite(res.residual[0]).all()):
        raise AssertionError(f"SAM-Audio {label}: {run}")
    laps("the separation")
    inputs = _sam_inputs(model, SAM_SECONDS)
    dev, dt = model.device, model.dtype
    wav = torch.from_numpy(audio).to(dev)[None, :, None].to(dt)
    gen = torch.randn(2, run["frames"], model.config.codec_cfg.codebook_dim,
                      device=dev).to(dt)
    with torch.inference_mode():
        ms = {"encode": _time_ms(lambda: dacvae_encode(model.audio_codec,
                                                       wav), 3),
              "t5": _time_ms(lambda: model.encode_text([SAM_TEXT]), 5),
              "dit": _time_ms(lambda: _sam_eval(model, inputs), 5),
              "decode": _time_ms(lambda: dacvae_decode(model.audio_codec,
                                                       gen), 3)}
    prof = _device_kernels(lambda: _sam_eval(model, inputs), cpu=False)
    dev_ms = sum(_dev_us(e) for e in prof) / 1e3
    kernels = sum(e.count for e in prof)
    laps("parts timed, one evaluation profiled")
    q8 = any(type(m).__name__ == "QuantizedLinear" for m in model.modules())
    bound, by, tflop, gb = sam_dit_bound(model, run["frames"],
                                         run["text_len"], q8)
    out = dict(wall=wall, xrt=SAM_SECONDS / wall, peak=peak, ms=ms,
               dev_ms=dev_ms, kernels=kernels, busy=dev_ms / ms["dit"],
               bound=bound, by=by, tflop=tflop, gb=gb, frames=run["frames"])
    log(f"[sam-audio] {label}: separate of {SAM_SECONDS} s at 48 kHz "
        f"({run['frames']} frames, a {run['text_len']}-token description, "
        f"midpoint, 16 steps, 32 DiT evaluations): wall {wall:.3f} s, xRT "
        f"{out['xrt']:.2f}, peak {peak:.2f} GB above the earlier phases'; "
        f"encode {ms['encode']:.2f} ms, T5 {ms['t5']:.2f} ms, one DiT "
        f"evaluation {ms['dit']:.2f} ms, decode of target and residual "
        f"{ms['decode']:.2f} ms; the profiled evaluation: {kernels} kernels, "
        f"{dev_ms:.3f} ms of device time ({100 * out['busy']:.1f}% of its "
        f"{ms['dit']:.2f} ms busy); its bound {bound:.3f} ms ({by}: "
        f"{tflop:.3f} TFLOP, {gb:.3f} GB; {100 * bound / ms['dit']:.1f}% of "
        f"it reached) ({card})")
    if long:
        audio = _clip_audio(63, SAM_LONG_SECONDS, sr)
        chunks, lwall = _sync_s(lambda: list(model.separate_streaming(
            audio, [SAM_TEXT])))
        total = sum(len(c[0]) for c in chunks)
        if not (len(chunks) == 4 and total == SAM_LONG_SECONDS * sr
                and all(np.isfinite(c[0]).all() for c in chunks)):
            raise AssertionError(f"SAM-Audio long: {len(chunks)} chunks, "
                                 f"{total} samples")
        out.update(long_wall=lwall, long_xrt=SAM_LONG_SECONDS / lwall)
        log(f"[sam-audio] {label}: separate_long of {SAM_LONG_SECONDS} s "
            f"(10-s chunks, 3-s overlap, cosine crossfade; 4 chunks, seeds "
            f"42-45): wall {lwall:.3f} s, xRT {out['long_xrt']:.2f} ({card})")
        laps("the long separation")
    laps.log()
    return out


def build_sam_full():
    """SAM-Audio at SAM_FULL drawn on the card in f32 from seed 0, with the
    stand-in tokenizer."""
    import torch

    from mlx_audio_tpu_torch.sts.models.sam_audio import Model

    t0 = time.perf_counter()
    meta = Model(SAM_FULL, device="meta")
    parts = {n: sum(p.numel() for p in getattr(meta, n).parameters())
             for n in ("transformer", "text_encoder", "audio_codec")}
    model = Model(SAM_FULL, device=DEVICE).init_params(seed=0, on_device=True)
    model.tokenizer = SamTok(model.config.t5_cfg.vocab_size)
    torch.cuda.synchronize()
    log(f"[sam-audio] SAM-Audio at the JAX defaults (DiT 2,816 x 22, 22 "
        f"heads, FFN 7,552; T5-base 768 x 12; DACVAE 48 kHz, hop 1,920): "
        f"{meta.num_params():,} params (counted on the meta device: DiT "
        f"{parts['transformer']:,}, T5 {parts['text_encoder']:,}, DACVAE "
        f"{parts['audio_codec']:,}) drawn on the card in f32 from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s")
    return model


def phase_sam_full(card: str, recorder: K2Recorder) -> int:
    """Phase 59: SAM-Audio at SAM_FULL seeded on the card: bf16 against
    f32 on one DiT evaluation of a 10-s clip; in bf16 one `separate` of
    10 s (`_sam_run`) and `separate_long` of 30 s (four chunks); then
    every Linear quantized to q8 on K2 (`apply_quantization`, group 64):
    the separation again, K2's launches a DiT evaluation read from its
    counter, q8 against bf16 on one evaluation, and the DiT's linears at
    the clip's 250 rows on K2 against cuBLAS bf16 (`_linear_times`) with
    their bound. -> K2's launches, as its counter read them."""
    import torch

    from mlx_audio_tpu_torch.nn import Linear, QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.utils import apply_quantization

    t_phase = time.perf_counter()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    base = torch.cuda.memory_allocated()
    model = build_sam_full()
    inputs = _sam_inputs(model, SAM_SECONDS)
    v32 = _sam_eval(model, inputs).float()
    model.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    inputs = _sam_inputs(model, SAM_SECONDS)
    v16 = _sam_eval(model, inputs).float()
    rel = float(torch.linalg.norm(v16 - v32) / torch.linalg.norm(v32))
    del v32
    if not (torch.isfinite(v16).all() and rel < SAM_BF16_REL):
        raise AssertionError(f"SAM-Audio bf16 vs f32: {rel:.3e}")
    log(f"[sam-audio] bf16 vs f32 on one DiT evaluation of the {SAM_SECONDS}"
        f"-s clip ({inputs[1].shape[1]} rows): relative Frobenius "
        f"{rel:.3e} (limit {SAM_BF16_REL:g}) ({card})")
    bf16 = _sam_run(model, "bf16", card, base, long=True)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the bf16 SAM-Audio launched K1 or K2")
    t1 = time.perf_counter()
    apply_quantization(model, SAM_Q8)
    torch.cuda.empty_cache()
    held = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    dense = sum(isinstance(m, Linear) for m in model.modules())
    log(f"[sam-audio] every linear quantized to 8 bits (group {MLX_GROUP}) "
        f"on the card in {time.perf_counter() - t1:.2f} s: {held} on K2, "
        f"{dense} dense; the tables, scale/shift tables and convs bf16")
    qmm_kernel.launches = 0
    with recorder:
        k2 = qmm_kernel.launches
        vq = _sam_eval(model, inputs).float()
        per_eval = qmm_kernel.launches - k2
        q8 = _sam_run(model, "q8 (K2)", card, base, long=False)
    k2 = qmm_kernel.launches
    relq = float(torch.linalg.norm(vq - v16) / torch.linalg.norm(v16))
    # the layers' 11 each, the time and text embedders' 3 each, t_block,
    # output, proj and memory_proj
    layers = model.config.dit_cfg.n_layers
    want = layers * 11 + 3 + 3 + 1 + 1 + 2
    if dense or per_eval != want or not (torch.isfinite(vq).all()
                                         and relq < SAM_Q8_REL):
        raise AssertionError(f"q8 SAM-Audio: {dense} dense linears, "
                             f"{per_eval} K2 launches a DiT evaluation (want "
                             f"{want}), q8 vs bf16 {relq:.3e}")
    sums = _linear_times(card, "sam-audio dit", SAM_DIT_SHAPES,
                         SAM_DIT_PER_LAYER, layers, rows=(q8["frames"],))
    pre = sums[q8["frames"]]
    lb, lby = linears_bound(SAM_DIT_SHAPES, SAM_DIT_PER_LAYER, layers,
                            q8["frames"])
    log(f"[sam-audio] the DiT's {layers * sum(SAM_DIT_PER_LAYER)} linears at "
        f"the clip's M = {q8['frames']} (an evaluation's but the text rows'"
        f" and M = 1's): K2 (mma) {pre['K2']:.3f} ms against cuBLAS bf16 "
        f"{pre['bf16']:.3f} ms ({pre['K2'] / pre['bf16']:.2f}x); bound "
        f"{lb:.3f} ms ({lby}), {100 * lb / pre['K2']:.1f}% of it reached by "
        f"K2, {100 * lb / pre['bf16']:.1f}% by cuBLAS ({card})")
    log(f"[sam-audio] q8 against bf16 on this card: separate of "
        f"{SAM_SECONDS} s {q8['wall']:.3f} vs {bf16['wall']:.3f} s (xRT "
        f"{q8['xrt']:.2f} vs {bf16['xrt']:.2f}), one DiT evaluation "
        f"{q8['ms']['dit']:.2f} vs {bf16['ms']['dit']:.2f} ms ({q8['kernels']}"
        f" vs {bf16['kernels']} kernels, {q8['dev_ms']:.3f} vs "
        f"{bf16['dev_ms']:.3f} ms of device time, bound {q8['bound']:.3f} vs "
        f"{bf16['bound']:.3f} ms), peak {q8['peak']:.2f} vs "
        f"{bf16['peak']:.2f} GB; K2 {per_eval} launches a DiT evaluation, "
        f"{k2} in all; one evaluation q8 vs bf16 relative {relq:.3e} (limit "
        f"{SAM_Q8_REL:g}) ({card})")
    if snake_conv_kernel.launches != before[0]:
        raise AssertionError("SAM-Audio launched K1")
    del model
    torch.cuda.empty_cache()
    log(f"[time] phase 59 in {time.perf_counter() - t_phase:.1f} s")
    return k2


class K1Recorder:
    """While active, keeps the arguments of K1's first launch at each (B,
    T, C, k, dilation, path) through `adain_snake_conv1d`; `hold()` then
    runs each again and against the plain version (launches made to
    compare are taken back off the counters). -> the largest relative
    error."""

    def __enter__(self):
        from mlx_audio_tpu_torch.ops import snake_conv

        self.kernel, self.cases = snake_conv.snake_conv_kernel, {}
        real = self.kernel

        class Recording:
            def __getattr__(self, name):
                return getattr(real, name)

            def __call__(inner, x, scale, shift, alpha, w, bias=None, *,
                         dilation=1, valid_len=None, path=None):
                key = (*x.shape, w.shape[1] if w.ndim == 5 else w.shape[0],
                       dilation, path)
                if key not in self.cases:
                    self.cases[key] = tuple(
                        None if a is None else a.clone() for a in
                        (x, scale, shift, alpha, w, bias, valid_len))
                return real(x, scale, shift, alpha, w, bias,
                            dilation=dilation, valid_len=valid_len,
                            path=path)

        snake_conv.snake_conv_kernel = Recording()
        return self

    def __exit__(self, *exc):
        from mlx_audio_tpu_torch.ops import snake_conv

        snake_conv.snake_conv_kernel = self.kernel

    def hold(self, tag: str) -> float:
        import torch

        from mlx_audio_tpu_torch.ops.snake_conv import (
            adain_snake_conv1d_reference, unpack_weight)

        k, worst = self.kernel, 0.0
        launches, by_path = k.launches, dict(k.path_launches)
        for (b, t, c, kk, dil, path), (x, scale, shift, alpha, w, bias,
                                       vlen) in sorted(self.cases.items()):
            got = k(x, scale, shift, alpha, w, bias, dilation=dil,
                    valid_len=vlen, path=path)
            wio = unpack_weight(w) if path == "wgmma" else w
            want = adain_snake_conv1d_reference(x, scale, shift, alpha, wio,
                                                bias, dilation=dil,
                                                valid_len=vlen)
            rel = rel_err(got, want)
            name = str(x.dtype).split(".")[-1]
            if not (torch.isfinite(got).all() and rel <= KERNEL_TOL[name]):
                raise AssertionError(f"{tag}: K1 ({path}) B={b} T={t} C={c} "
                                     f"k={kk} dil={dil}: rel {rel:.3e}")
            worst = max(worst, rel)
        k.launches, k.path_launches = launches, by_path
        log(f"[{tag}] K1 at the {len(self.cases)} shapes the run launched it "
            f"with (B, T, C, k, dilation, path: "
            f"{sorted({(c[1], c[2], c[3], c[4], c[5]) for c in self.cases})}"
            f") against the plain version: rel <= {worst:.3e} (tol "
            f"{KERNEL_TOL['bfloat16']:g})")
        return worst


class _Timed:
    """A component with its `method` timed: `ms` holds each call's ms
    (the card synchronised after); other attributes pass through."""

    def __init__(self, inner, method: str, **call_kw):
        self.inner, self.method, self.call_kw, self.ms = inner, method, \
            call_kw, []

    def __getattr__(self, name):
        if name == self.__dict__.get("method"):
            return self._call
        return getattr(self.inner, name)

    def _call(self, *args, **kwargs):
        import types

        import torch

        t0 = time.perf_counter()
        out = getattr(self.inner, self.method)(*args, **kwargs,
                                               **self.call_kw)
        if isinstance(out, types.GeneratorType):
            out = list(out)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


class _EnergyGatedSilero:
    """Silero's `feed` on every frame, timed (`ms`), its probability kept
    (`probs`, on the card); the pipeline's detector reads a stand-in
    instead: 0.9 where the frame's RMS is above TURN_RMS, else 0.1.
    Random weights hold Silero's probability near 0.503 on speech and
    silence alike (0.50303-0.50313 against 0.50312 on the CPU at seed 0),
    so it cannot start or end a turn."""

    def __init__(self, model):
        self.model, self.ms, self.probs = model, [], []

    def feed(self, frame, state):
        import numpy as np
        import torch

        t0 = time.perf_counter()
        prob, state = self.model.feed(frame, state)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.probs.append(prob.reshape(-1)[0])
        loud = float(np.sqrt(np.mean(np.square(frame)))) > TURN_RMS
        return np.asarray([[0.9 if loud else 0.1]]), state


def build_turn_models(tmp: Path) -> dict:
    """The voice pipeline's models on the card, each seeded there: Silero
    at ModelConfig(), Smart Turn at the JAX defaults, Whisper
    large-v3-turbo (its end-of-text row zeroed, bf16), the LM at
    LLAMA_1B's dims (bf16), Kokoro-82M with a seeded voice pack."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.stt.models.whisper import Model as Whisper
    from mlx_audio_tpu_torch.stt.models.whisper import ModelDimensions
    from mlx_audio_tpu_torch.tts.models.kokoro import Model as Kokoro
    from mlx_audio_tpu_torch.tts.models.llama import BackboneModel
    from mlx_audio_tpu_torch.vad.models.silero_vad import Model as Silero
    from mlx_audio_tpu_torch.vad.models.silero_vad import ModelConfig
    from mlx_audio_tpu_torch.vad.models.smart_turn import Model as SmartTurn

    t0 = time.perf_counter()
    silero = Silero(ModelConfig(), device=DEVICE).init_params(seed=0)
    turn = SmartTurn(SLICE7A_FULL["smart_turn"], device=DEVICE).init_params(
        seed=0, on_device=True)
    whisper = Whisper(ModelDimensions(**WHISPER_TURBO),
                      device=DEVICE).init_params(seed=0, on_device=True)
    with torch.no_grad():
        whisper.decoder.token_embedding.weight[50257] = 0.0
    whisper.astype(torch.bfloat16)
    lm = BackboneModel(LLAMA_1B, device=DEVICE).init_params(seed=0,
                                                            on_device=True)
    lm.astype(torch.bfloat16)
    kokoro = Kokoro(kokoro_config(), device=DEVICE).init_params(seed=0)
    (tmp / "voices").mkdir(exist_ok=True)
    np.save(tmp / "voices" / "af_smoke.npy",
            (np.random.RandomState(0).randn(510, 1, 256) * 0.1)
            .astype(np.float32))
    kokoro.config.model_path = str(tmp)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    models = dict(silero=silero, turn=turn, whisper=whisper, lm=lm,
                  kokoro=kokoro)
    log(f"[voice pipeline] models on the card, seeded: Silero "
        f"{silero.num_params():,}, Smart Turn {turn.num_params():,} (f32), "
        f"Whisper large-v3-turbo {whisper.num_params():,} (bf16), the LM at "
        f"Llama-3.2-1B's dims {lm.num_params():,} (bf16), Kokoro-82M "
        f"{kokoro.num_params():,}; built in {time.perf_counter() - t0:.2f} s")
    return models


def phase_voice_pipeline(card: str, tmp: Path) -> int:
    """Phase 60: one headless `VoicePipeline` turn on the card through
    `build_turn_models`' models: TURN_SPEECH_S of seeded speech-like audio
    then TURN_SILENCE_S of silence fed in 32-ms frames through Silero,
    Smart Turn on the candidate pause, Whisper's greedy transcript, a
    TURN_REPLY_TOKENS-token greedy reply, Kokoro's speech: the VAD's ms a
    frame, the endpoint's, the STT's, the LM's and the TTS's ms, and the
    time from the end of speech to the first audio chunk (the silence the
    detector waited for, plus the turn's compute). Every K1 launch of the
    turn is held against the plain version at its shapes. Silero's random
    weights cannot tell speech from silence: the detector reads an RMS
    stand-in (`_EnergyGatedSilero`) while Silero runs on every frame. ->
    K1's launches in the turn."""
    import numpy as np

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.sts.voice_pipeline import (
        LocalLLMResponseEngine, VadConfig, VoicePipeline)

    t_phase = time.perf_counter()
    models = build_turn_models(tmp)
    rs = np.random.RandomState(60)
    n_sp, n_si = int(TURN_SPEECH_S * 16000), int(TURN_SILENCE_S * 16000)
    env = np.repeat(rs.rand(n_sp // 4000 + 1) > 0.2, 4000)[:n_sp] * 0.4 \
        + 0.05
    speech = (_clip_audio(60, TURN_SPEECH_S, 16000) + rs.randn(n_sp) * env
              ).astype(np.float32)
    silence = (rs.randn(n_si) * 1e-3).astype(np.float32)
    audio = np.concatenate([speech, silence])
    vad_cfg = VadConfig(min_silence_ms=480.0, candidate_silence_ms=240.0)
    silero = _EnergyGatedSilero(models["silero"])
    stt = _Timed(models["whisper"], "generate", **TURN_STT_KW)
    turn = _Timed(models["turn"], "predict_endpoint")
    tts = _Timed(models["kokoro"], "generate")
    engine = LocalLLMResponseEngine(models["lm"], tokenizer=WordTok(),
                                    max_tokens=TURN_REPLY_TOKENS,
                                    temperature=0.0)
    lm = _Timed(engine, "generate")
    events, marks = [], {}
    pipe = VoicePipeline(
        vad_model=silero, stt_model=stt, llm_engine=lm, tts_model=tts,
        tts_voice="af_smoke", smart_turn_model=turn, vad_config=vad_cfg,
        on_event=lambda k, d: (events.append((k, d)), marks.setdefault(
            k, (time.perf_counter(), pipe._input_ms))))
    queue_audio = pipe.audio_output.queue_audio

    def queued(samples):
        marks.setdefault("first_audio", (time.perf_counter(),
                                         pipe._input_ms))
        queue_audio(samples)

    pipe.audio_output.queue_audio = queued
    k1, k2 = snake_conv_kernel.launches, qmm_kernel.launches
    try:
        with K1Recorder() as rec:
            for i in range(0, len(audio), 512):
                pipe.feed_audio(audio[i:i + 512])
        chunks = []
        while (c := pipe.fetch_speech()) is not None:
            chunks.append(c)
    finally:
        pipe.shutdown()
    k1 = snake_conv_kernel.launches - k1
    kinds = [k for k, _ in events]
    text = next((d["text"] for k, d in events if k == "transcription"), "")
    reply = next((d["text"] for k, d in events if k == "response"), "")
    if not ("speech_started" in kinds and "speech_stopped" in kinds and text
            and reply and not reply.startswith("You said:") and chunks
            and all(np.isfinite(c).all() for c in chunks) and k1
            and qmm_kernel.launches == k2
            and engine.last_run["tokens"] == TURN_REPLY_TOKENS):
        raise AssertionError(f"the voice pipeline's turn: events {kinds}, "
                             f"transcript {text!r}, reply {reply!r}, "
                             f"{len(chunks)} chunks, {k1} K1 launches")
    rec.hold("voice pipeline")
    t_stop, in_stop = marks["speech_stopped"]
    t_audio, _ = marks["first_audio"]
    waited = in_stop - 1000.0 * n_sp / 16000
    compute = (t_audio - t_stop) * 1e3
    vad_ms = float(np.median(silero.ms))
    early = next((d.get("early", False) for k, d in events
                  if k == "speech_stopped"), False)
    sil = np.asarray([float(p) for p in silero.probs])
    log(f"[voice pipeline] one headless turn: {TURN_SPEECH_S} s of speech, "
        f"{TURN_SILENCE_S} s of silence in 32-ms frames; Silero ran on all "
        f"{len(sil)} frames (probabilities {sil.min():.5f}-{sil.max():.5f}: "
        f"random weights), the detector read the stand-in (RMS above "
        f"{TURN_RMS:g}: 0.9, else 0.1); events "
        f"{[k for k in kinds]}; transcript {len(text)} characters, reply "
        f"{len(reply.split())} words of {TURN_REPLY_TOKENS} greedy tokens in "
        f"{engine.last_run['reads']} reads, {sum(len(c) for c in chunks)} "
        f"samples of speech in {len(chunks)} chunks, {k1} K1 launches")
    log(f"[voice pipeline] VAD {vad_ms:.3f} ms a frame (median of "
        f"{len(silero.ms)}), endpoint {sum(turn.ms):.2f} ms over "
        f"{len(turn.ms)} call(s), STT {sum(stt.ms):.2f} ms, LM "
        f"{sum(lm.ms):.2f} ms, TTS {sum(tts.ms):.2f} ms; end of speech to "
        f"the first audio chunk {waited + compute:.1f} ms = {waited:.0f} ms "
        f"of silence heard before the turn ended ("
        f"{'Smart Turn, early' if early else 'the VAD'}) + {compute:.1f} ms "
        f"of compute ({card})")
    del models
    log(f"[time] phase 60 in {time.perf_counter() - t_phase:.1f} s")
    return k1


def phase_eval_cli(card: str, tmp: Path) -> None:
    """Phase 61: `python -m mlx_audio_tpu_torch.stt.eval`'s `main` on the
    card over a two-row local manifest of generated WAVs with a small
    Whisper directory (`whisper_eval_small`): each hypothesis equal to the
    CPU's `generate` of that file, the summary's WER to its records'."""
    import contextlib
    import io

    import numpy as np

    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.stt.eval.__main__ import main as eval_main
    from mlx_audio_tpu_torch.stt.utils import load_model

    t0 = time.perf_counter()
    d = tmp / "whisper-eval"
    write_whisper_checkpoint(whisper_eval_small("cpu"), d)
    rows = (("a", "one two three", 1.0), ("b", "four five", 1.5))
    for u, _, s in rows:
        audio_io.write(str(tmp / f"{u}.wav"), _noise(61 + len(u), s), 16000)
    man = tmp / "manifest.jsonl"
    man.write_text("".join(json.dumps({"id": u, "audio": f"{u}.wav",
                                       "text": t}) + "\n" for u, t, _ in rows))
    out = tmp / "eval-out"
    printed = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        eval_main(["--manifest", str(man), "--model", str(d), "--output-dir",
                   str(out), "--gen-kwargs", json.dumps(EVAL_KW)])
    wall = time.perf_counter() - t1
    summary = json.loads(printed.getvalue())
    recs = [json.loads(line) for line in
            (out / "predictions.jsonl").read_text().splitlines()]
    cpu = load_model(d, device="cpu")
    for r in recs:
        want = cpu.generate(r["audio_path"], **EVAL_KW).text.strip()
        if r["hypothesis"] != want:
            raise AssertionError(f"eval CLI on the card: {r['hypothesis']!r} "
                                 f"vs the CPU's {want!r}")
    edits = sum(r["edits"] for r in recs)
    refs = sum(r["reference_tokens"] for r in recs)
    if not (summary["num_samples"] == 2 and np.isclose(
            summary["wer_micro"], edits / refs)):
        raise AssertionError(f"eval CLI summary {summary}")
    log(f"[stt eval] the WER CLI on the card over a two-row manifest (small "
        f"Whisper, greedy): {wall:.2f} s, WER micro "
        f"{summary['wer_micro']:.3f} ({edits} edits over {refs} words), "
        f"RTF {summary['rtf']:.3f}; hypotheses equal to the CPU's; phase 61 "
        f"in {time.perf_counter() - t0:.1f} s ({card})")


def phase_slice7b(card: str, recorder: K2Recorder) -> tuple:
    """Phases 58-61; K2 only on the q8 SAM-Audio models, K1 only in the
    voice pipeline's Kokoro. -> (K1's launches, K2's launches)."""
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    t0 = time.perf_counter()
    k1 = snake_conv_kernel.launches
    with tempfile.TemporaryDirectory() as tmp:
        k2 = phase_sam_reference(Path(tmp))
        torch.cuda.empty_cache()
        k2 += phase_sam_full(card, recorder)
        if snake_conv_kernel.launches != k1:
            raise AssertionError("phases 58-59 launched K1")
        before = qmm_kernel.launches
        k1_turn = phase_voice_pipeline(card, Path(tmp))
        torch.cuda.empty_cache()
        phase_eval_cli(card, Path(tmp))
    if qmm_kernel.launches != before or \
            snake_conv_kernel.launches != k1 + k1_turn:
        raise AssertionError("phases 60-61 launched K2, or K1 beyond the "
                             "turn's Kokoro")
    log(f"[time] phases 58-61 in {time.perf_counter() - t0:.1f} s; K1 "
        f"{k1_turn} launches (the turn's Kokoro), K2 {k2}")
    return k1_turn, k2


# ---------------------------------------------------------------------------
# KittenTTS, Soprano, Voxtral-4B-TTS and OmniVoice (phases 62-66)
# ---------------------------------------------------------------------------

# the JAX tests' tiny configs: tests/test_model_families.py::TestKittenTTS
# (its TINY_VOCAB; the generator 128 channels wide, where the JAX test's
# 16 give legs of 8 and 4, narrower than K1's 32-channel chunks),
# tests/test_soprano.py, tests/test_voxtral_tts.py and
# tests/test_omnivoice.py; the small OmniVoice decodes through
# HIGGS_CODEC_SMALL (4 books of 64)
TINY_PHONEMES = "abcdefghijklmnopqrstuvwxyz ˈˌəɹʃʒðθæɑɔɛɜɪʊʌiuAIOWY.,!?"
KITTEN_SMALL = dict(
    istftnet=dict(resblock_kernel_sizes=[3], upsample_rates=[4, 4],
                  upsample_initial_channel=128,
                  resblock_dilation_sizes=[[1, 3, 5]],
                  upsample_kernel_sizes=[8, 8], gen_istft_n_fft=12,
                  gen_istft_hop_size=3),
    hidden_dim=32, max_conv_dim=24, max_dur=50, n_layer=2, n_mels=20,
    n_token=len(TINY_PHONEMES) + 1, style_dim=16,
    text_encoder_kernel_size=5, asr_res_dim=8,
    plbert=dict(num_hidden_layers=2, num_attention_heads=2, hidden_size=24,
                intermediate_size=32, max_position_embeddings=128,
                embedding_size=12, dropout=0.0),
    vocab={c: i + 1 for i, c in enumerate(TINY_PHONEMES)},
    speed_priors={"carol": 1.2}, compute_dtype="float32",
    transfer_dtype="float32")
SOPRANO_SMALL = dict(
    hidden_size=16, num_hidden_layers=1, intermediate_size=32,
    num_attention_heads=2, num_key_value_heads=2, head_dim=8, vocab_size=64,
    sample_rate=16000,
    decoder_config=dict(decoder_num_layers=1, decoder_dim=16,
                        decoder_intermediate_dim=32, hop_length=64,
                        n_fft=256, upscale=4, input_kernel=1, dw_kernel=3))
# the JAX test's Voxtral-TTS with widths group 16 divides (the q8
# directory: the LM, the head's and the codec's linears on K2)
VOXTRAL_TTS_SMALL = dict(
    dim=32, n_layers=2, head_dim=8, hidden_dim=64, n_heads=4, n_kv_heads=2,
    vocab_size=128, semantic_codebook_size=64, acoustic_codebook_size=5,
    n_acoustic_codebook=6, num_codebooks=7, acoustic_dim=32,
    acoustic_n_layers=1, acoustic_head_dim=8, acoustic_hidden_dim=64,
    acoustic_n_heads=4, acoustic_n_kv_heads=2, tokenizer_dim=16,
    tokenizer_hidden_dim=32, tokenizer_n_heads=2, tokenizer_n_kv_heads=2,
    tokenizer_head_dim=8, tokenizer_patch_size=4,
    tokenizer_patch_proj_kernel_size=3, tokenizer_semantic_dim=8,
    tokenizer_acoustic_dim=6,
    tokenizer_decoder_transformer_lengths_str="1,1",
    tokenizer_decoder_convs_kernels_str="3,4",
    tokenizer_decoder_convs_strides_str="1,2")
OMNI_SMALL = dict(
    audio_vocab_size=17, audio_mask_id=16, num_audio_codebook=4,
    llm_config=dict(hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2,
                    intermediate_size=64, vocab_size=200, head_dim=8))
SLICE8A_TEXT = "This is a long enough sentence to synthesize nicely."
SLICE8A_ATOL = 1e-4               # small configs at f32: summation order
# KittenTTS at the JAX ModelConfig's defaults (hidden 128, FFN convs 512,
# asr-res 64, 178 ids, style 128); the dicts they leave empty filled with
# Kokoro-82M's istftnet and PL-BERT (tests/real_configs.py:11-31), an
# assumption; a 125-phoneme request as phase 4's
KITTEN_FULL = dict(hidden_dim=128, max_conv_dim=512, max_dur=50, n_layer=3,
                   n_mels=80, n_token=178, style_dim=128,
                   text_encoder_kernel_size=5, asr_res_dim=64)
# Soprano-1.1-80M at the JAX defaults (a Qwen3 LM 512 x 12, 4,096 ids;
# Vocos 768 x 8, n_fft 2,048, hop 512, 32 kHz); 64 greedy tokens, the
# [STOP] (pad) row zeroed so that the loop runs to its limit
SOPRANO_TOKENS, SOPRANO_STOP = 64, 2
# Voxtral-4B-TTS at the JAX defaults (a llama 3,072 x 26, 131,072 ids; an
# acoustic head 3 x 3,072; the codec decoder 1,024 x 8 layers); one chunk
# of 25 frames (2 s), the end-audio row of the semantic head zeroed
VOXTRAL_TTS_FRAMES, VOXTRAL_TTS_STEP_FRAMES = 25, 8
VOXTRAL_TTS_PROMPT = 64
VOXTRAL_TTS_BF16_REL, VOXTRAL_TTS_Q8_REL = 5e-2, 1e-1
# OmniVoice at the JAX defaults (a Qwen3 backbone 1,024 x 28, 151,676 ids,
# 8 codebooks of 1,025) over the Higgs codec at CodecConfig(): one 10-s
# request (250 target tokens, 32 steps, guidance 2.0) and a batch of 4
OMNI_SECONDS, OMNI_STEPS, OMNI_BATCH = 10.0, 32, (2.0, 4.0, 6.0, 8.0)


class SopranoTok:
    """A stand-in Soprano tokenizer (tests/test_soprano.py's _FakeTok at
    any vocabulary): each character an id below the vocabulary, the pad
    id the stop."""

    pad_token_id = SOPRANO_STOP

    def __init__(self, vocab: int = 64, cap: int = 40):
        self.vocab, self.cap = vocab, cap

    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), self.vocab - 1) for c in text][:self.cap]


class SpeechTok:
    """A stand-in Voxtral-TTS tokenizer (tests/test_voxtral_tts.py's
    FakeSpeechTok): BOS, characters, then `audio` AUDIO tokens and
    BEGIN_AUDIO."""

    def __init__(self, text_ids: int = 20, audio: int = 3):
        self.text_ids, self.audio = text_ids, audio

    def encode_speech(self, text, voice):
        return ([1] + [5 + (ord(c) % 40) for c in text][:self.text_ids]
                + [24] * self.audio + [25])


class OmniTok:
    """A stand-in OmniVoice text tokenizer (tests/test_omnivoice.py's
    FakeTok): `tok(text).input_ids`, each character an id."""

    class _R:
        def __init__(self, ids):
            self.input_ids = ids

    def __init__(self, cap: int = 64):
        self.cap = cap

    def __call__(self, text, add_special_tokens=False, **kw):
        return self._R([3 + (ord(c) % 40) for c in text][:self.cap])


def write_slice8a_checkpoint(model, path: Path, config: dict,
                             model_type: str, quantization=None,
                             torch_layout: bool = False) -> None:
    """`model` as a directory of its family: config.json (a `quantization`
    entry quantizes the linears at load) and npz weights: the port's
    torch-layout state (KittenTTS, as Kokoro's published checkpoint), else
    the JAX tree (`model.jax_params`), which the family's `sanitize`
    reads."""
    import numpy as np

    from mlx_audio_tpu_torch.model import jax_params

    path.mkdir(parents=True, exist_ok=True)
    cfg = dict(config, model_type=model_type)
    if quantization:
        cfg.update(quantization)
    (path / "config.json").write_text(json.dumps(cfg))
    state = model.state_dict() if torch_layout else jax_params(model)
    np.savez(path / "model.npz", **{k: v.float().cpu().numpy()
                                    for k, v in state.items()})


def _numpy_frame_draws(model, seed: int):
    """`model` drawing Voxtral-TTS's frame noise from numpy (one
    RandomState per request), so that the card and the CPU draw the
    same."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    model._draws = lambda generator: torch.from_numpy(rng.randn(
        1, model.config.n_acoustic_codebook).astype(np.float32)).to(
        model.device)
    return model


def _numpy_uniforms(model, seed: int):
    """`model` drawing OmniVoice's Gumbel uniforms from numpy."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    model._draws = lambda shape, generator: torch.from_numpy(
        rng.rand(*shape).astype(np.float32)).to(model.device)
    return model


def _close(tag: str, a, b, atol: float = SLICE8A_ATOL) -> float:
    """max |a - b| over max(1, max |b|) (a random generator's audio can
    reach 1e6), within `atol`. -> that error."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not np.isfinite(a).all():
        raise AssertionError(f"{tag}: shapes {a.shape} vs {b.shape}")
    err = float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max())) \
        if a.size else 0.0
    if err > atol:
        raise AssertionError(f"{tag}: max |diff| {err:.3e} of the peak")
    return err


def phase_slice8a_reference(tmp: Path) -> tuple:
    """Phase 62: the small configs at f32 from one seeded weight set, each
    through `load_model` on a written directory, the card against the CPU:
    KittenTTS's synth (the generator's noise off) and a voices.npz request;
    Soprano's greedy tokens and audio; Voxtral-TTS's frames (numpy draws)
    and audio, whole and streamed; OmniVoice's revealed codes (numpy
    uniforms) and audio through its `audio_tokenizer/` Higgs codec; then
    a q8 Voxtral-TTS directory at group 16 on K2 against the same model
    through the plain version and against the CPU. -> (K1's, K2's
    launches, as the counters read them)."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch import load_model as route
    from mlx_audio_tpu_torch.codec.models.higgs_audio import Model as Codec
    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.tts import utils as tts_utils
    from mlx_audio_tpu_torch.tts.models import (kitten_tts, omnivoice,
                                                soprano, voxtral_tts)

    t0 = time.perf_counter()
    k1, k2 = snake_conv_kernel.launches, qmm_kernel.launches
    notes = []

    def write(name, module, cfg, model_type, **kw):
        d = tmp / name
        src = module.Model(cfg, device="cpu").init_params(seed=0)
        write_slice8a_checkpoint(src, d, cfg, model_type, **kw)
        return d

    def pair(d):
        """The directory through the TTS loader on the CPU and the
        top-level router on the card."""
        return tts_utils.load_model(d, device="cpu"), route(d, device=DEVICE)

    # KittenTTS: a voices.npz beside npz weights
    d = write("kitten-small", kitten_tts, KITTEN_SMALL, "kitten",
              torch_layout=True)
    np.savez(d / "voices.npz", carol=np.random.RandomState(62).randn(
        1, 32).astype(np.float32))
    kc, kg = pair(d)
    ps = "hɛlO wɜɹld"
    ref = np.random.RandomState(1).randn(1, 32).astype(np.float32) * 0.1
    a = kg(ps, ref, deterministic_noise=True)[0]
    b = kc(ps, ref, deterministic_noise=True)[0]
    e_kit = _close("KittenTTS synth", a, b)
    res = list(kg.generate("Hello world.", voice="carol"))
    if not (len(res) == 1 and res[0].samples > 0
            and np.isfinite(res[0].audio).all()):
        raise AssertionError("KittenTTS generate on the card")
    notes.append(f"KittenTTS synth {e_kit:.1e} (K1 on the card)")
    # Soprano
    sc, sg = pair(write("soprano-1.1-small", soprano, SOPRANO_SMALL,
                        "soprano"))
    outs = []
    for m in (sc, sg):
        m._tokenizer, m._stop_token_id = SopranoTok(), None
        outs.append((list(m.generate(SLICE8A_TEXT, max_tokens=40,
                                     temperature=0.0))[0],
                     dict(m.last_run)))
    (rc, runc), (rg, rung) = outs
    if runc != rung or rc.token_count != rg.token_count:
        raise AssertionError(f"Soprano tokens: {runc} vs {rung}")
    e_sop = _close("Soprano audio", rg.audio, rc.audio)
    notes.append(f"Soprano {rg.token_count} greedy tokens equal, audio "
                 f"{e_sop:.1e}")
    # Voxtral-TTS
    vc, vg = pair(write("voxtral-tts-small", voxtral_tts,
                        VOXTRAL_TTS_SMALL, "voxtral_tts"))
    errs, frames = [], []
    for stream in (False, True):
        got = []
        for m in (vc, vg):
            m.tokenizer = SpeechTok()
            _numpy_frame_draws(m, 62)
            rs = list(m.generate("hello there", max_tokens=30, seed=0,
                                 stream=stream, streaming_interval=0.8))
            got.append((np.concatenate([r.audio for r in rs]),
                        m.last_run["frames"]))
        if got[0][1] != got[1][1]:
            raise AssertionError(f"Voxtral-TTS frames {got}")
        frames.append(got[1][1])
        errs.append(_close("Voxtral-TTS audio", got[1][0], got[0][0]))
    notes.append(f"Voxtral-TTS {frames[0]} frames equal, audio whole "
                 f"{errs[0]:.1e}, streamed {errs[1]:.1e}")
    # q8 Voxtral-TTS on K2
    d8 = tmp / "voxtral-tts-q8"
    write_slice8a_checkpoint(vc, d8, VOXTRAL_TTS_SMALL, "voxtral_tts",
                             {"quantization": {"group_size": 16,
                                               "bits": 8}})
    q8 = tts_utils.load_model(d8, device=DEVICE)
    qc = tts_utils.load_model(d8, device="cpu")
    held = sum(isinstance(m, QuantizedLinear) for m in q8.modules())
    res = []
    for m, ctx in ((q8, None), (q8, K2AsReference), (qc, None)):
        m.tokenizer = SpeechTok()
        _numpy_frame_draws(m, 63)
        before = qmm_kernel.launches
        if ctx is None:
            out = list(m.generate("hello there", max_tokens=12, seed=0))[0]
        else:
            with ctx():
                out = list(m.generate("hello there", max_tokens=12,
                                      seed=0))[0]
        res.append((out.audio, m.last_run["frames"],
                    qmm_kernel.launches - before))
    if not (held == 2 * 7 + 1 * 7 + 2 + 2 * 7 and res[0][2] > 0
            and res[1][2] == 0 and res[0][1] == res[1][1] == res[2][1]):
        raise AssertionError(f"q8 Voxtral-TTS: {held} quantized linears, "
                             f"{[r[1:] for r in res]}")
    e_ref = _close("q8 Voxtral-TTS vs plain", res[0][0], res[1][0])
    e_cpu = _close("q8 Voxtral-TTS vs CPU", res[0][0], res[2][0])
    notes.append(f"q8 Voxtral-TTS: {held} linears on K2 ({res[0][2]} "
                 f"launches over {res[0][1]} frames), against the plain "
                 f"version {e_ref:.1e}, the CPU {e_cpu:.1e}")
    # OmniVoice, with its Higgs codec in audio_tokenizer/
    d = write("omnivoice-small", omnivoice, OMNI_SMALL, "omnivoice")
    codec = Codec(HIGGS_CODEC_SMALL, device="cpu").init_params(seed=1)
    (d / "audio_tokenizer").mkdir()
    (d / "audio_tokenizer" / "config.json").write_text(json.dumps(
        dict(HIGGS_CODEC_SMALL, model_type="higgs_audio_v2_tokenizer")))
    np.savez(d / "audio_tokenizer" / "model.npz",
             **{k: v.numpy() for k, v in codec.state_dict().items()})
    oc, og = pair(d)
    outs = []
    for m in (oc, og):
        m.text_tokenizer = OmniTok()
        _numpy_uniforms(m, 64)
        outs.append(m.generate_batch(["hello world", "two words here"],
                                     duration_s=[0.4, 0.8], num_steps=4,
                                     class_temperature=1.0, seed=0))
    errs = [_close("OmniVoice audio", g.audio, c.audio)
            for g, c in zip(outs[1], outs[0])]
    notes.append(f"OmniVoice a batch of 2 ({[r.token_count for r in outs[1]]}"
                 f" tokens), audio {max(errs):.1e}")
    log(f"[slice8a small] small configs through load_model on the card "
        f"against the CPU: {'; '.join(notes)} "
        f"({time.perf_counter() - t0:.1f} s)")
    return snake_conv_kernel.launches - k1, qmm_kernel.launches - k2


def phase_kitten_full(card: str) -> int:
    """Phase 63: KittenTTS at KITTEN_FULL with Kokoro-82M's istftnet and
    PL-BERT, seeded on the card, bf16 decoder: a warm-up, then phase 4's
    125-phoneme text (126 with the period KittenTTS adds) through
    `generate` (wall, xRT, K1's launches and path), every leg K1
    ran held against the plain version at the model's own shapes
    (`K1Recorder`). -> K1's launches in the request."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.tts.models.kitten_tts import Model, ModelConfig

    t0 = time.perf_counter()
    kok = kokoro_config()
    cfg = ModelConfig(**KITTEN_FULL, istftnet=kok.istftnet,
                      plbert=kok.plbert, vocab=kok.vocab)
    model = Model(cfg, device=DEVICE).init_params(seed=0)
    model._voices = {"carol": (np.random.RandomState(63).randn(1, 256)
                               * 0.1).astype(np.float32)}
    list(model.generate(TEXTS[0], voice="carol"))
    torch.cuda.synchronize()
    before = snake_conv_kernel.launches
    paths = dict(snake_conv_kernel.path_launches)
    with K1Recorder() as rec:
        res, wall = _sync_s(lambda: list(model.generate(TEXTS[2],
                                                        voice="carol")))
    launches = snake_conv_kernel.launches - before
    (r,) = res
    audio, n_ps = r.audio, r.token_count
    by_path = {p: n - paths.get(p, 0)
               for p, n in snake_conv_kernel.path_launches.items()
               if n != paths.get(p, 0)}
    audio_s = len(audio) / model.sample_rate
    if not (np.isfinite(audio).all() and len(audio) > 0 and n_ps >= 120
            and launches == 48 and by_path == {"wgmma": 48}):
        raise AssertionError(f"KittenTTS: {launches} K1 launches "
                             f"{by_path}, {len(audio)} samples")
    rel = rec.hold("kitten")
    log(f"[kitten] KittenTTS (hidden 128, decoder 512 / res 64, Kokoro-82M's "
        f"generator and PL-BERT; {model.num_params():,} params, decoder "
        f"bf16): {n_ps} phonemes -> {audio_s:.2f} s of audio in "
        f"{wall * 1e3:.1f} ms (xRT {audio_s / wall:.1f}), K1 {launches} "
        f"launches {by_path}, held against the plain version at rel "
        f"<= {rel:.3e} ({card})")
    del model
    log(f"[time] phase 63 in {time.perf_counter() - t0:.1f} s")
    return launches


def phase_soprano_full(card: str) -> None:
    """Phase 64: Soprano-1.1-80M at the JAX defaults, seeded on the card in
    f32 then bf16, the stop row zeroed: a warm-up, then SOPRANO_TOKENS
    greedy tokens (ms a token p50/p95 over the chunks, the vocoder's ms,
    xRT), two decode steps profiled (kernels and device ms a token)."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.tts.models.soprano import Model
    from mlx_audio_tpu_torch.tts.models.soprano.soprano import (
        Decode, decode_hidden)

    t0 = time.perf_counter()
    model = Model(device=DEVICE).init_params(seed=0, on_device=True)
    with torch.no_grad():
        model.language_model.embed_tokens.weight[SOPRANO_STOP] = 0.0
    model.astype(torch.bfloat16)
    model._tokenizer = SopranoTok(model.config.vocab_size, cap=200)
    model._stop_token_id = SOPRANO_STOP
    text = ", ".join([SLICE8A_TEXT[:-1]] * 3) + "."
    list(model.generate(text, max_tokens=8, temperature=0.0))
    torch.cuda.synchronize()
    res, wall = _sync_s(lambda: list(model.generate(
        text, max_tokens=SOPRANO_TOKENS, temperature=0.0)))
    run = dict(model.last_run)
    (r,) = res
    if not (r.token_count == SOPRANO_TOKENS and np.isfinite(r.audio).all()):
        raise AssertionError(f"Soprano: {run}, {r.token_count} tokens")
    dec = Decode(model, 0.0, 1.0, SOPRANO_STOP)
    ids = model._tokenizer.encode(model.preprocess_text(text)[0])
    state = dec.start(ids, 64, 0)
    per_tok = [1e3 * _sync_s(lambda: dec.chunk(state, 16))[1] / 16
               for _ in range(2)]
    dev = model.device
    rows = torch.randn(1, SOPRANO_TOKENS + 1, model.config.hidden_size,
                       device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        voc = _time_ms(lambda: decode_hidden(model, rows), 3)
    kern, dev_ms, step_ms, busy = _profile_steps(
        lambda: dec.chunk(state, 2), 2)
    audio_s = r.samples / model.sample_rate
    log(f"[soprano] Soprano-1.1-80M ({model.num_params():,} params, bf16): "
        f"{SOPRANO_TOKENS} greedy tokens ({run['prompt_len']}-token prompt, "
        f"{run['chunks']} chunks) -> {audio_s:.2f} s of audio in "
        f"{wall:.3f} s (xRT {audio_s / wall:.2f}); ms a token over 16-step "
        f"chunks {np.percentile(per_tok, 50):.2f} p50, "
        f"{np.percentile(per_tok, 95):.2f} p95; the vocoder (Vocos 768 x 8, "
        f"ISTFT n_fft 2,048 hop 512) on {SOPRANO_TOKENS + 1} rows "
        f"{voc:.2f} ms; profiled steps: {kern:.0f} kernels and "
        f"{dev_ms:.3f} ms of device time a token against {step_ms:.2f} ms "
        f"({100 * busy:.1f}% busy) ({card})")
    del model, state
    log(f"[time] phase 64 in {time.perf_counter() - t0:.1f} s")


def voxtral_tts_frame_bound(model, cols: int) -> tuple:
    """The least time one frame could take, B = 1: its bytes (the LM's
    weights once, the acoustic head's linears once an Euler step (7), the
    semantic head once, the 37 codebook rows, the K/V of `cols` cache
    columns) over 3.35 TB/s, against its operations over 989 TFLOP/s.
    -> (ms, "bytes" or "operations", GB)."""
    from mlx_audio_tpu_torch.nn import QuantizedLinear

    cfg = model.config

    def weight_bytes(mods):
        return sum(v.numel() * v.element_size() for m in mods
                   for v in list(m.parameters(recurse=False))
                   + list(m.buffers(recurse=False)))

    lm = [m for n, m in model.language_model.named_modules()
          if "embed_tokens" not in n]
    head = model.acoustic_transformer
    sem = [head.semantic_codebook_output]
    rest = [m for m in head.modules() if m is not sem[0]]
    steps = cfg.n_denoising_steps - 1
    dt = model.language_model.model.embed_tokens.weight.element_size()
    nbytes = (weight_bytes(lm) + steps * weight_bytes(rest)
              + weight_bytes(sem) + cfg.num_codebooks * cfg.dim * dt
              + 2 * cfg.n_layers * cols * cfg.n_kv_heads * cfg.head_dim * dt)
    lin = [m for m in model.modules()
           if isinstance(m, QuantizedLinear) or type(m).__name__ == "Linear"]
    ops = 0.0
    for m in lin:
        rows = 6 if any(m is x for x in rest) else 1
        n, k = (m.w_q.shape if isinstance(m, QuantizedLinear)
                else m.weight.shape)
        if any(m is x for x in lm) or any(m is x for x in head.modules()):
            ops += 2 * rows * n * k * (steps if rows == 6 else 1)
    by_bytes, by_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_BF16 * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", nbytes / 1e9)


def _voxtral_tts_run(model, label: str, card: str, base: int,
                     recorder) -> dict:
    """A 4-frame warm-up; one request of VOXTRAL_TTS_FRAMES frames (one
    chunk: wall, xRT, peak); VOXTRAL_TTS_STEP_FRAMES single-frame chunks
    (ms a frame p50/p95, each with its read); the codec decode of the
    request's frames (ms); a chunk of two frames profiled (kernels, device
    ms, busy share a frame); K2's launches a frame by path. -> the
    numbers."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel

    laps = Laps(f"voxtral-tts {label}")
    text = " ".join([SLICE8A_TEXT] * 2)
    list(model.generate(text, max_tokens=4, seed=0))
    laps("warm-up")
    torch.cuda.reset_peak_memory_stats()
    k2 = qmm_kernel.launches
    with recorder:
        paths0 = dict(recorder.paths)
        res, wall = _sync_s(lambda: list(model.generate(
            text, max_tokens=VOXTRAL_TTS_FRAMES, seed=1)))
        paths = {p: n - paths0.get(p, 0) for p, n in recorder.paths.items()
                 if n != paths0.get(p, 0)}
    k2 = qmm_kernel.launches - k2
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    run = dict(model.last_run)
    (r,) = res
    spf = model.config.samples_per_frame
    if not (run["frames"] == VOXTRAL_TTS_FRAMES and r.samples ==
            VOXTRAL_TTS_FRAMES * spf and np.isfinite(r.audio).all()):
        raise AssertionError(f"Voxtral-TTS {label}: {run}")
    laps("the request")
    ids = np.asarray(model._encode_text(text, "casual_male"))
    state = model.start(model._build_input_embeddings(ids, "casual_male"),
                        VOXTRAL_TTS_STEP_FRAMES + 8, 2)
    per_frame = [1e3 * _sync_s(lambda: model.chunk(state, 1))[1]
                 for _ in range(VOXTRAL_TTS_STEP_FRAMES)]
    codes = np.full((VOXTRAL_TTS_FRAMES, model.config.num_codebooks), 3)
    codec_ms = _time_ms(lambda: model.decode_audio_codes(codes), 3)
    kern, dev_ms, step_ms, busy = _profile_steps(
        lambda: model.chunk(state, 2), 2)
    laps("frames timed, codec timed, a 2-frame chunk profiled")
    cols = run["prompt_len"] + 1 + VOXTRAL_TTS_FRAMES / 2
    bound, by, gb = voxtral_tts_frame_bound(model, int(cols))
    out = dict(wall=wall, xrt=r.samples / model.sample_rate / wall,
               p50=float(np.percentile(per_frame, 50)),
               p95=float(np.percentile(per_frame, 95)), codec_ms=codec_ms,
               kernels=kern, dev_ms=dev_ms, busy=busy, bound=bound, by=by,
               gb=gb, peak=peak, k2=k2, paths=paths)
    log(f"[voxtral-tts] {label}: {VOXTRAL_TTS_FRAMES} frames "
        f"({run['prompt_len']}-token prompt, {run['chunks']} chunk) -> "
        f"{r.samples / model.sample_rate:.2f} s of audio in {wall:.3f} s "
        f"(xRT {out['xrt']:.3f}); single-frame chunks "
        f"{out['p50']:.2f} ms a frame p50, {out['p95']:.2f} p95 (the frame "
        f"is 80 ms); a profiled chunk of 2 frames: {kern:.0f} kernels, "
        f"{dev_ms:.3f} ms of device time a frame against {step_ms:.2f} ms "
        f"({100 * busy:.1f}% busy); "
        f"bound {bound:.3f} ms a frame ({by}: {gb:.3f} GB), "
        f"{100 * bound / out['p50']:.1f}% of it reached at p50; the codec "
        f"decode of {VOXTRAL_TTS_FRAMES} frames {codec_ms:.2f} ms; K2 "
        f"{k2} launches ({k2 / VOXTRAL_TTS_FRAMES:.1f} a frame, by path "
        f"{paths}); peak {peak:.2f} GB above the earlier phases' ({card})")
    laps.log()
    return out


def phase_voxtral_tts_full(card: str, recorder: K2Recorder) -> int:
    """Phase 65: Voxtral-4B-TTS at the JAX defaults, seeded on the card in
    bf16, the semantic head's end-audio row zeroed: bf16 against f32 on
    the acoustic head's Euler state of one frame; the request in bf16
    (`_voxtral_tts_run`); then every Linear the group divides, but those
    named like a table, quantized to q8 on K2: the run again, K2's
    launches a frame against the config's (7 Euler steps x the head's 23
    plus the LM's 182), q8 against bf16 on the same Euler state. -> K2's
    launches, as its counter read them."""
    import torch

    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.tts.models.voxtral_tts import Model
    from mlx_audio_tpu_torch.tts.models.voxtral_tts.voxtral_tts import \
        acoustic_levels
    from mlx_audio_tpu_torch.utils import apply_quantization

    t0 = time.perf_counter()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    base = torch.cuda.memory_allocated()
    model = Model(device=DEVICE)
    head = model.acoustic_transformer
    model.astype(torch.bfloat16)
    model.init_params(seed=0, on_device=True)
    cfg = model.config
    with torch.no_grad():
        head.semantic_codebook_output.weight[1] = 0.0
    model.tokenizer = SpeechTok(text_ids=VOXTRAL_TTS_PROMPT - 5)
    log(f"[voxtral-tts] Voxtral-4B-TTS at the JAX defaults (llama 3,072 x "
        f"26, acoustic head 3 x 3,072, codec decoder 1,024 x 8): "
        f"{model.num_params():,} params drawn on the card in bf16 from seed "
        f"0 in {time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device=DEVICE).manual_seed(65)
    h = torch.randn(1, cfg.dim, generator=g, device=DEVICE)
    noise = torch.randn(1, cfg.n_acoustic_codebook, generator=g,
                        device=DEVICE)
    with torch.inference_mode():
        x16 = acoustic_levels(head, cfg, h.to(torch.bfloat16), noise)
        head.float()
        x32 = acoustic_levels(head, cfg, h, noise)
        head.to(torch.bfloat16)
    rel = rel_err(x16, x32)
    if not rel < VOXTRAL_TTS_BF16_REL:
        raise AssertionError(f"Voxtral-TTS bf16 vs f32: {rel:.3e}")
    bf16 = _voxtral_tts_run(model, "bf16", card, base, recorder)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the bf16 Voxtral-TTS launched K1 or K2")
    t1 = time.perf_counter()
    apply_quantization(model, {"quantization": {"group_size": MLX_GROUP,
                                                "bits": 8}})
    torch.cuda.empty_cache()
    held = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    lm_q = 7 * cfg.n_layers
    head_q = 7 * cfg.acoustic_n_layers + 2
    want = cfg.n_denoising_steps - 1
    want = want * head_q + lm_q
    with torch.inference_mode():
        xq = acoustic_levels(head, cfg, h.to(torch.bfloat16), noise)
    relq = rel_err(xq, x16)
    qmm_kernel.launches = 0
    q8 = _voxtral_tts_run(model, "q8 (K2)", card, base, recorder)
    k2 = qmm_kernel.launches
    codec_q = 7 * sum(cfg.decoder_tf_lengths)
    # the prefill's and the AUDIO step's LM passes, each frame's head and
    # (but the last's) LM step, the codec decode's layers
    request = 2 * lm_q + VOXTRAL_TTS_FRAMES * want - lm_q + codec_q
    per_frame = want
    if not (held == lm_q + head_q + codec_q and relq < VOXTRAL_TTS_Q8_REL
            and q8["k2"] == request):
        raise AssertionError(f"q8 Voxtral-TTS: {held} quantized linears, "
                             f"{q8['k2']} K2 launches in the request (want "
                             f"{request}: {want} a frame), q8 vs bf16 "
                             f"{relq:.3e}")
    log(f"[voxtral-tts] q8 (group {MLX_GROUP}, {held} linears on K2 in "
        f"{time.perf_counter() - t1:.2f} s; input_projection and the two "
        f"codebook heads dense) against bf16 on this card: "
        f"{q8['p50']:.2f} vs {bf16['p50']:.2f} ms a frame p50, "
        f"{q8['p95']:.2f} vs {bf16['p95']:.2f} p95, xRT {q8['xrt']:.3f} vs "
        f"{bf16['xrt']:.3f}, {q8['kernels']:.0f} vs {bf16['kernels']:.0f} "
        f"kernels and {q8['dev_ms']:.3f} vs {bf16['dev_ms']:.3f} ms of device "
        f"time a frame, bound {q8['bound']:.3f} vs {bf16['bound']:.3f} ms, "
        f"peak {q8['peak']:.2f} vs {bf16['peak']:.2f} GB; K2 {per_frame} "
        f"launches a frame (7 x {head_q} + {lm_q}; {request} in the "
        f"request with its prefill and codec), {k2} in all; "
        f"the Euler state q8 vs bf16 rel {relq:.3e}, bf16 vs f32 {rel:.3e} "
        f"(limits {VOXTRAL_TTS_Q8_REL:g}, {VOXTRAL_TTS_BF16_REL:g}) ({card})")
    if snake_conv_kernel.launches != before[0]:
        raise AssertionError("Voxtral-TTS launched K1")
    del model, head
    torch.cuda.empty_cache()
    log(f"[time] phase 65 in {time.perf_counter() - t0:.1f} s")
    return k2


def omni_step_bound(model, rows: int, u: int) -> tuple:
    """The least time one unmask step could take, B = 1: its operations
    (each backbone linear's 2 M out in at the conditional pass's `rows`
    and the unconditional one's `u`, the attention's products, the 8
    heads at the 2 u target rows) over 989 TFLOP/s, against its bytes
    (the backbone's and heads' weights twice, once a pass) over 3.35 TB/s.
    -> (ms, "operations" or "bytes", TFLOP)."""
    bc = model.config.backbone_config
    lin = sum(m.weight.numel() for n, m in model.backbone.named_modules()
              if type(m).__name__ == "Linear")
    heads = sum(m.weight.numel() for m in model.audio_heads.modules()
                if type(m).__name__ == "Linear")
    ops = 2 * lin * (rows + u) + 2 * heads * 2 * u
    ops += bc.num_hidden_layers * 4 * (rows * rows + u * u) * \
        bc.num_attention_heads * bc.head_dim
    dt = model.backbone.embed_tokens.weight.element_size()
    nbytes = 2 * (lin + heads) * dt
    by_ops, by_bytes = ops / PEAK_BF16 * 1e3, nbytes / HBM_BPS * 1e3
    return (max(by_ops, by_bytes),
            "operations" if by_ops >= by_bytes else "bytes", ops / 1e12)


def phase_omnivoice_full(card: str) -> None:
    """Phase 66: OmniVoice at the JAX defaults seeded on the card in bf16,
    over the Higgs codec at CodecConfig() dims (f32): one request of
    OMNI_SECONDS (250 target tokens, 32 steps, guidance 2.0: wall, xRT,
    ms a step, the codec's ms), one step profiled (kernels, device ms,
    busy share) against its bound; a batch of 4 mixed lengths (wall,
    xRT)."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.codec.models.higgs_audio import Model as Codec
    from mlx_audio_tpu_torch.tts.models.omnivoice import Model

    t0 = time.perf_counter()
    model = Model(device=DEVICE)
    model.astype(torch.bfloat16)
    model.init_params(seed=0, on_device=True)
    model.audio_tokenizer = Codec(device=DEVICE).init_params(
        seed=1, on_device=True)
    model.text_tokenizer = OmniTok(cap=400)
    text = " ".join([SLICE8A_TEXT] * 3)
    model.generate_batch([text], duration_s=1.0, num_steps=2)
    torch.cuda.synchronize()
    (r,), wall = _sync_s(lambda: model.generate_batch(
        [text], duration_s=OMNI_SECONDS, num_steps=OMNI_STEPS, seed=0))
    run = dict(model.last_run)
    if not (r.token_count == 250 and np.isfinite(r.audio).all()
            and len(r.audio) == r.samples):
        raise AssertionError(f"OmniVoice: {run}, {r.token_count} tokens, "
                             f"{len(r.audio)} samples")
    codes = np.zeros((250, 8), np.int64)
    codec_ms = _time_ms(lambda: model.audio_tokenizer.decode(codes), 3)
    # one step, profiled: both passes at the request's rows
    rows = run["L"]
    dev = model.device
    ids = torch.full((1, rows, 8), model.config.audio_mask_id,
                     dtype=torch.long, device=dev)
    ids[0, :rows - 250] = 5
    cond = torch.zeros((1, rows), dtype=torch.bool, device=dev)
    cond[0, rows - 250:] = True
    args = (ids, cond, torch.tensor([rows], device=dev),
            torch.tensor([rows - 250], device=dev),
            torch.tensor([250], device=dev),
            torch.tensor([[250 * 8]], device=dev), 250, 2.0, 0.0, 5.0, 5.0,
            torch.Generator(device=dev).manual_seed(0))
    kern, dev_ms, step_ms, busy = _profile_steps(
        lambda: model.unmask(*args), 1)
    bound, by, tflop = omni_step_bound(model, rows, 250)
    res, bwall = _sync_s(lambda: model.generate_batch(
        [text] * len(OMNI_BATCH), duration_s=list(OMNI_BATCH),
        num_steps=OMNI_STEPS, seed=1))
    brun = dict(model.last_run)
    if not [x.token_count for x in res] == [50, 100, 150, 200]:
        raise AssertionError(f"OmniVoice batch: {brun}")
    b_audio = sum(x.samples for x in res) / model.sample_rate
    log(f"[omnivoice] OmniVoice (backbone 1,024 x 28, 8 codebooks of "
        f"1,025; {model.num_params():,} params bf16; Higgs codec at "
        f"CodecConfig() f32): {OMNI_SECONDS:g} s ({run['L']} rows, 250 "
        f"target tokens, {OMNI_STEPS} steps, guidance 2.0) in {wall:.3f} s "
        f"(xRT {OMNI_SECONDS / wall:.2f}), {1e3 * wall / OMNI_STEPS:.2f} ms "
        f"a step with the codec's share; the codec decode of 250 frames "
        f"{codec_ms:.2f} ms; one profiled step: {kern:.0f} kernels, "
        f"{dev_ms:.3f} ms of device time against {step_ms:.2f} ms "
        f"({100 * busy:.1f}% busy), bound {bound:.3f} ms ({by}: "
        f"{tflop:.3f} TFLOP), {100 * bound / step_ms:.1f}% of it reached; a "
        f"batch of {len(OMNI_BATCH)} ({[x.token_count for x in res]} target "
        f"tokens, {brun['L']} rows padded and masked): {b_audio:.1f} s of "
        f"audio in {bwall:.3f} s (xRT {b_audio / bwall:.2f}) ({card})")
    del model
    log(f"[time] phase 66 in {time.perf_counter() - t0:.1f} s")


def phase_slice8a(card: str, recorder: K2Recorder) -> tuple:
    """Phases 62-66; K1 only on the KittenTTS models, K2 only on the q8
    Voxtral-TTS models. -> (K1's launches, K2's launches)."""
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        k1, k2 = phase_slice8a_reference(Path(tmp))
    torch.cuda.empty_cache()
    k1 += phase_kitten_full(card)
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    phase_soprano_full(card)
    torch.cuda.empty_cache()
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("Soprano launched K1 or K2")
    k2 += phase_voxtral_tts_full(card, recorder)
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    phase_omnivoice_full(card)
    torch.cuda.empty_cache()
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("OmniVoice launched K1 or K2")
    log(f"[time] phases 62-66 in {time.perf_counter() - t0:.1f} s; K1 {k1} "
        f"launches (the KittenTTS models), K2 {k2}")
    return k1, k2


# ---------------------------------------------------------------------------
# TADA and MOSS-TTS (phases 67-70)
# ---------------------------------------------------------------------------

# the JAX tests' tiny configs: tests/test_tada.py, and tests/test_moss_tts.py's
# three layouts with the pad code at 24, inside their 25-row channel tables
TADA_SMALL = dict(
    vocab_size=300, hidden_size=32, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=8,
    intermediate_size=64, acoustic_dim=16, num_time_classes=16,
    shift_acoustic=2, head_layers=2, head_ffn_ratio=2.0,
    decoder_hidden_dim=24, decoder_d_model=4, decoder_embed_dim=16,
    decoder_strides=[2, 2], decoder_num_attn_layers=1,
    decoder_num_attn_heads=4, decoder_attn_dim_feedforward=48,
    encoder_hidden_dim=24, encoder_embed_dim=16, encoder_strides=[2, 2],
    encoder_num_attn_layers=1, encoder_num_attn_heads=4,
    encoder_attn_dim_feedforward=48)
MOSS_LANG_SMALL = dict(vocab_size=151700, hidden_size=32,
                       intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2,
                       head_dim=8)
_MOSS_TTS_BASE = dict(language_config=MOSS_LANG_SMALL, n_vq=4,
                  audio_vocab_size=24, audio_pad_token_id=24)
MOSS_TTS_SMALL = {
    "delay": dict(_MOSS_TTS_BASE, model_type="moss_tts_delay"),
    "v15": dict(_MOSS_TTS_BASE, model_type="moss_tts_local",
                audio_codebook_sizes=[24] * 4,
                gpt2_config=dict(vocab_size=64, n_embd=32, n_layer=1,
                                 n_head=4, n_inner=64)),
    "legacy": dict(_MOSS_TTS_BASE, model_type="moss_tts",
                   additional_mlp_ffn_hidden_size=48,
                   local_ffn_hidden_size=48, local_hidden_size=32,
                   local_num_layers=1),
}
# TADA-1B at the JAX ModelConfig's defaults (Llama-3.2-1B: 2,048 x 16,
# GQA 32/8, 128,256 ids; a head of 6 x 2,048; a codec decoder 1,024 wide,
# strides [4, 4, 5, 6], 24 kHz): one request of TADA_STEPS steps, 20 flow
# steps, CFG 1.6; the head's `final.linear` given a bias whose duration
# outputs gray-code TADA_FRAMES frames a token (random weights give up
# to 255, 5 s a token)
TADA_STEPS, TADA_FM, TADA_CFG, TADA_FRAMES = 48, 20, 1.6, 6
TADA_TIMED_STEPS = 4
TADA_BF16_REL, TADA_Q8_REL = 5e-2, 1e-1
TADA_TEXT = ("TADA speaks this sentence on the card, one latent a text "
             "token, with durations between them.")
# MOSS-TTS at the JAX defaults: Qwen3LMConfig() (2,048 x 28, GQA 16/8,
# FFN 6,144, 151,936 ids, untied), 32 channels of 1,025 codes; the text
# head given a bias that starts the audio and keeps its slot token, so the
# decode stays in audio; the v1.5 GPT-2 one layer at the LM's width
# (16 heads, n_inner 8,192: assumed dims)
MOSS_FRAMES, MOSS_V15_FRAMES, MOSS_TIMED_FRAMES = 48, 24, 4
MOSS_GPT2 = dict(n_embd=2048, n_head=16, n_inner=8192)
MOSS_TEXT = "MOSS speaks this sentence on the card."
MOSS_Q8_REL = 1e-1
SLICE8B_ATOL = 1e-4               # small configs at f32: summation order


class TadaTok:
    """A stand-in TADA tokenizer: tests/test_tada.py's Tok (ids below 300)
    for the small config, Llama-3's special ids for the full one; each
    character one id."""

    def __init__(self, small: bool):
        self.small = small
        self.bos_token_id = 1 if small else 128000
        self.ids = ({"<|eot_id|>": 5, "<|start_header_id|>": 6,
                     "<|end_header_id|>": 7, "<|finetune_right_pad_id|>": 8}
                    if small else
                    {"<|eot_id|>": 128009, "<|start_header_id|>": 128006,
                     "<|end_header_id|>": 128007,
                     "<|finetune_right_pad_id|>": 128004})

    def encode(self, s, **kwargs):
        return [10 + (ord(c) % 200) if self.small else 1000 + ord(c) % 5000
                for c in s]

    def convert_tokens_to_ids(self, t):
        return self.ids.get(t, 9 if self.small else 128002)


class MossTok:
    """A stand-in MOSS-TTS tokenizer (tests/test_moss_tts.py's CharTok):
    the MOSS special tokens by name, each other character one id."""

    SPECIALS = {151643: "<pad>", 151644: "<|im_start|>", 151645: "<|im_end|>",
                151652: "<audio_start>", 151653: "<audio_end>",
                151654: "<u_slot>", 151656: "<a_slot>", 151662: "<d_slot>"}

    def convert_ids_to_tokens(self, i):
        return self.SPECIALS.get(i, f"<{i}>")

    def encode(self, s, **kwargs):
        rev = {v: k for k, v in self.SPECIALS.items()}
        ids, i = [], 0
        while i < len(s):
            for tok_str, tid in rev.items():
                if s.startswith(tok_str, i):
                    ids.append(tid)
                    i += len(tok_str)
                    break
            else:
                ids.append(100 + (ord(s[i]) % 200))
                i += 1
        return ids


class MossCodec:
    """A stand-in MOSS audio tokenizer (the MOSS codec is not ported): codes
    of an audio's 1,920-sample frames, and a sine a frame for codes."""

    spf = 1920

    def encode_audio(self, audio, sample_rate=None, num_quantizers=32):
        import numpy as np

        a = np.asarray(audio, np.float32).reshape(-1)
        n = max(1, len(a) // self.spf)
        x = np.resize(a, n * self.spf).reshape(n, self.spf)
        return (np.abs(x[:, :7 * num_quantizers:7]) * 997).astype(
            np.int64) % 24

    def decode_audio_codes(self, codes, num_quantizers=32):
        import numpy as np

        c = np.asarray(codes, np.int64)
        t = np.arange(self.spf)
        return np.concatenate([0.1 * np.sin(t * 1e-3 * (1 + r.sum()))
                               for r in c]).astype(np.float32)


def write_slice8b_checkpoint(model, path: Path, config: dict,
                             model_type: str, quantization=None) -> None:
    """`model` as a directory of its family: config.json (a `quantization`
    entry quantizes the linears at load) and the JAX tree in npz, a v1.5
    MOSS-TTS's channel tables under their upstream per-channel names (its
    `sanitize` stacks them)."""
    import numpy as np

    from mlx_audio_tpu_torch.model import jax_params

    path.mkdir(parents=True, exist_ok=True)
    cfg = dict(config, model_type=model_type)
    if quantization:
        cfg.update(quantization)
    (path / "config.json").write_text(json.dumps(cfg))
    state = {k: v.float().cpu().numpy() for k, v in jax_params(model).items()}
    if model_type == "moss_tts_local":
        n_vq = model.config.n_vq
        for name in ("audio_embeddings", "audio_lm_heads"):
            w = state.pop(f"{name}.weight")
            v = w.shape[0] // n_vq
            state.update({f"{name}.{c}.weight": w[v * c:v * (c + 1)]
                          for c in range(n_vq)})
    np.savez(path / "model.npz", **state)


def _tada_bias(model, frames: int, scale: float = 8.0):
    """`final.linear` of TADA's head given a bias whose duration outputs
    gray-code `frames` before and after each token (the acoustic outputs
    0), `scale` over the latent's noise and velocity."""
    import torch

    from mlx_audio_tpu_torch.tts.models.tada.tada import int_to_gray_bits

    cfg = model.config
    lin = model.prediction_head.final.linear
    dev = model.device
    bits = int_to_gray_bits(frames, cfg.num_time_bits) * 2
    b = torch.zeros(cfg.latent_size, device=dev)
    b[cfg.acoustic_dim:] = torch.tensor(bits, device=dev) * scale
    lin.bias = torch.nn.Parameter(b, requires_grad=False)
    return model


def _numpy_tada_draws(model, seed: int):
    """`model` drawing TADA's step noise from numpy (one RandomState a
    model), so that the card and the CPU draw the same."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    model._draws = lambda generator: torch.from_numpy(rng.randn(
        1, model.config.latent_size).astype(np.float32)).to(model.device)
    return model


def _numpy_gumbel(model, seed: int):
    """`model` drawing MOSS-TTS's Gumbel noise from numpy."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    model._gumbel = lambda kind, shape, generator: torch.from_numpy(
        -np.log(-np.log(np.clip(rng.rand(*shape), 1e-20, 1.0))).astype(
            np.float32)).to(model.device)
    return model


def _moss_text_bias(model, start: float, slot: float):
    """MOSS-TTS's text head given a bias: `start` on <audio_start> (the
    delay decode enters the audio at its first frame) and `slot` on the
    generation slot token (it stays there: the v1.5 frame keeps choosing
    it)."""
    import torch

    from mlx_audio_tpu_torch.nn import QuantizedLinear

    cfg = model.config
    lin = model.text_lm_head
    b = torch.zeros(cfg.language_config.vocab_size, device=model.device)
    b[cfg.audio_start_token_id] = start
    b[cfg.audio_assistant_gen_slot_token_id] = slot
    if isinstance(lin, QuantizedLinear):
        lin.bias = b
    else:
        lin.bias = torch.nn.Parameter(b, requires_grad=False)
    return model


def phase_slice8b_reference(tmp: Path) -> int:
    """Phase 67: the small configs at f32 from one seeded weight set, each
    through `load_model` on a written directory, the card against the CPU:
    TADA's zero-shot and cloned requests (numpy draws; the head's duration
    bias of `_tada_bias`, the same codec encoder on both); MOSS-TTS's
    three layouts: greedy and sampled (numpy Gumbel draws) continuations
    through `generate` with the stand-in codec, the v1.5 one streamed too
    (its text head's slot row biased by `_moss_text_bias`, so that its
    frames go on);
    then q8 directories at group 16 (TADA; MOSS-TTS delay and v1.5, whose
    per-channel head rows run on K2) on K2 against the same model through
    the plain version and against the CPU. -> K2's launches."""
    import numpy as np

    from mlx_audio_tpu_torch import load_model as route
    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.tts import utils as tts_utils
    from mlx_audio_tpu_torch.tts.models import moss_tts, tada
    from mlx_audio_tpu_torch.tts.models.tada.tada import CodecEncoder

    t0 = time.perf_counter()
    k2 = qmm_kernel.launches
    notes = []
    ref = np.random.RandomState(67).randn(4800).astype(np.float32) * 0.1

    def tada_out(m, **kw):
        m._tokenizer = TadaTok(small=True)
        _numpy_tada_draws(_tada_bias(m, 3), 67)
        r = list(m.generate("hello there card", max_tokens=24,
                            num_flow_matching_steps=4, **kw))[0]
        return r, dict(m.last_run)

    def check_tada(mc, mg, tag, **kw):
        (rc, runc), (rg, rung) = tada_out(mc, **kw), tada_out(mg, **kw)
        if rc.samples != rg.samples or runc["latent_rows"] != \
                rung["latent_rows"]:
            raise AssertionError(f"{tag}: {runc} vs {rung}")
        return _close(tag, rg.audio, rc.audio, SLICE8B_ATOL), rung

    d = tmp / "tada-small"
    write_slice8b_checkpoint(tada.Model(TADA_SMALL, device="cpu")
                             .init_params(seed=0), d, TADA_SMALL, "tada")
    tc, tg = tts_utils.load_model(d, device="cpu"), route(d, device=DEVICE)
    enc = tc.init_encoder_params(seed=1)
    tg.set_encoder(CodecEncoder(tc.config, device=DEVICE))
    tg.encoder.load_state_dict(enc.state_dict())
    e_zero, run = check_tada(tc, tg, "TADA zero-shot")
    e_clone, _ = check_tada(tc, tg, "TADA cloned", ref_audio=ref,
                            ref_text="prev words")
    notes.append(f"TADA {run['steps']} steps, {run['latent_rows']} latent "
                 f"rows equal, audio zero-shot {e_zero:.1e}, cloned "
                 f"{e_clone:.1e}")

    codes = np.random.RandomState(68).randint(0, 24, size=(6, 4))

    def moss_pair(layout, quantization=None):
        d = tmp / f"moss-{layout}{'-q8' if quantization else ''}"
        src = moss_tts.Model(MOSS_TTS_SMALL[layout], device="cpu").init_params(
            seed=0)
        write_slice8b_checkpoint(src, d, MOSS_TTS_SMALL[layout],
                                 MOSS_TTS_SMALL[layout]["model_type"],
                                 quantization)
        out = []
        for dev in ("cpu", DEVICE):
            m = tts_utils.load_model(d, device=dev)
            m.tokenizer, m.audio_tokenizer = MossTok(), MossCodec()
            if layout == "v15":
                _moss_text_bias(m, 0.0, 3.0)
            out.append(m)
        return out

    def moss_audio(m, sampled: bool, stream: bool = False):
        kw = dict(max_tokens=12, mode="continuation",
                  prompt_audio_codes=codes, seed=0)
        if not sampled:
            kw.update(text_temperature=0.0, audio_temperature=0.0,
                      do_sample=False)
        else:
            _numpy_gumbel(m, 68)
        rs = list(m.generate("hello", stream=stream, **kw))
        return np.concatenate([r.audio for r in rs]), \
            [r.token_count for r in rs], dict(m.last_run)

    for layout in ("delay", "v15", "legacy"):
        mc, mg = moss_pair(layout)
        runs = []
        for sampled, stream in ((False, False), (True, False)) + (
                ((False, True),) if layout == "v15" else ()):
            (ac, nc, rc), (ag, ng, rg) = (moss_audio(m, sampled, stream)
                                          for m in (mc, mg))
            if nc != ng or rc["frames"] != rg["frames"] or \
                    not np.array_equal(ac, ag):
                raise AssertionError(f"MOSS-TTS {layout} sampled={sampled} "
                                     f"stream={stream}: {rc} vs {rg}")
            runs.append(f"{rg['frames']}{'s' if sampled else ''}"
                        f"{' streamed' if stream else ''}")
        notes.append(f"MOSS-TTS {layout} frames {', '.join(runs)} equal")

    # q8 on K2
    q = {"quantization": {"group_size": 16, "bits": 8}}
    d8 = tmp / "tada-q8"
    write_slice8b_checkpoint(tada.Model(TADA_SMALL, device="cpu")
                             .init_params(seed=0), d8, TADA_SMALL, "tada", q)
    tq, tqc = tts_utils.load_model(d8, device=DEVICE), \
        tts_utils.load_model(d8, device="cpu")
    held = sum(isinstance(m, QuantizedLinear) for m in tq.modules())
    res = []
    for m, ctx in ((tq, None), (tq, K2AsReference), (tqc, None)):
        before = qmm_kernel.launches
        with (ctx() if ctx else contextlib.nullcontext()):
            r, run = tada_out(m)
        res.append((r.audio, run["latent_rows"],
                    qmm_kernel.launches - before))
    if not (res[0][2] > 0 and res[1][2] == 0
            and res[0][1] == res[1][1] == res[2][1]):
        raise AssertionError(f"q8 TADA: {[r[1:] for r in res]}")
    e_ref = _close("q8 TADA vs plain", res[0][0], res[1][0], SLICE8B_ATOL)
    e_cpu = _close("q8 TADA vs CPU", res[0][0], res[2][0], SLICE8B_ATOL)
    notes.append(f"q8 TADA: {held} linears on K2 ({res[0][2]} launches), "
                 f"against the plain version {e_ref:.1e}, the CPU "
                 f"{e_cpu:.1e}")
    for layout in ("delay", "v15"):
        mc, mg = moss_pair(layout, q)
        held = sum(isinstance(m, QuantizedLinear) for m in mg.modules())
        res = []
        for m, ctx in ((mg, None), (mg, K2AsReference), (mc, None)):
            before = qmm_kernel.launches
            with (ctx() if ctx else contextlib.nullcontext()):
                a, n, run = moss_audio(m, False)
            res.append((a, run["frames"], qmm_kernel.launches - before))
        if not (res[0][2] > 0 and res[1][2] == 0
                and res[0][1] == res[1][1] == res[2][1]
                and np.array_equal(res[0][0], res[1][0])
                and np.array_equal(res[0][0], res[2][0])):
            raise AssertionError(f"q8 MOSS-TTS {layout}: "
                                 f"{[r[1:] for r in res]}")
        notes.append(f"q8 MOSS-TTS {layout}: {held} linears on K2 "
                     f"({res[0][2]} launches over {res[0][1]} frames), "
                     f"frames equal to the plain version's and the CPU's")
    log(f"[slice8b small] small configs through load_model on the card "
        f"against the CPU: {'; '.join(notes)} "
        f"({time.perf_counter() - t0:.1f} s)")
    return qmm_kernel.launches - k2


def tada_step_bound(model, cols: int) -> tuple:
    """The least time one TADA step could take (batch 2 under CFG): its
    bytes (the llama's linears once, `acoustic_proj`, `cond_proj` and the
    adaLN linears once, the head's other linears once an Euler step, the
    five embedding rows of both streams, the K/V of `cols` cache columns)
    over 3.35 TB/s, against its operations (2 M N K over those products:
    M = 2 rows, 2 x flow steps for the adaLN) over 989 TFLOP/s.
    -> (ms, "bytes" or "operations", GB)."""
    cfg = model.config
    p = model.prediction_head
    steps = TADA_FM

    def wbytes(mods):
        return sum(v.numel() * v.element_size() for m in mods
                   for v in list(m.parameters(recurse=False))
                   + list(m.buffers(recurse=False)))

    def lin(mods):
        return [m for m in mods if hasattr(m, "in_features")]

    llama = lin(m for n, m in model.model.named_modules()
                if "embed_tokens" not in n)
    once = lin([model.acoustic_proj, p.cond_proj, p.final.adaLN]
               + [blk.adaLN for blk in p.layers.values()])
    each = lin([p.noisy_images_proj, p.final.linear]
               + [m for blk in p.layers.values()
                  for m in blk.ffn.modules()])
    dt = model.model.embed_tokens.weight.element_size()
    lc = model.__dict__["_lm"].config
    nbytes = (wbytes(llama) + wbytes(once) + steps * wbytes(each)
              + 2 * 5 * cfg.hidden_size * dt
              + 2 * 2 * lc.num_hidden_layers * cols
              * lc.num_key_value_heads * lc.resolved_head_dim * dt)

    def flops(mods, rows):
        return sum(2 * rows * m.in_features
                   * (m.w_q.shape[0] if hasattr(m, "w_q")
                      else m.weight.shape[0]) for m in mods)

    ops = (flops(llama, 2) + flops([model.acoustic_proj, p.cond_proj], 2)
           + flops(once[2:], 2 * steps) + steps * flops(each, 2))
    by_bytes, by_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_BF16 * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", nbytes / 1e9)


def _tada_run(model, label: str, card: str, base: int, recorder) -> dict:
    """A warm-up; one request of TADA_STEPS steps (wall, xRT, peak, K2's
    launches by path); TADA_TIMED_STEPS steps timed one by one (ms a step
    p50/p95); the codec decode of the request's latent rows (ms); one step
    profiled (kernels, device ms, busy share); the step's bound. -> the
    numbers."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.tts.models.llama.llama import init_caches

    laps = Laps(f"tada {label}")
    kw = dict(num_flow_matching_steps=TADA_FM, acoustic_cfg_scale=TADA_CFG)
    list(model.generate(TADA_TEXT, max_tokens=6, **kw))
    laps("warm-up")
    torch.cuda.reset_peak_memory_stats()
    k2 = qmm_kernel.launches
    with recorder:
        paths0 = dict(recorder.paths)
        (r,), wall = _sync_s(lambda: list(model.generate(
            TADA_TEXT, max_tokens=TADA_STEPS, seed=1, **kw)))
        paths = {p: n - paths0.get(p, 0) for p, n in recorder.paths.items()
                 if n != paths0.get(p, 0)}
    k2 = qmm_kernel.launches - k2
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    run = dict(model.last_run)
    if not (run["steps"] == TADA_STEPS and r.samples > 0
            and np.isfinite(r.audio).all()):
        raise AssertionError(f"TADA {label}: {run}, {r.samples} samples")
    laps("the request")
    dev = model.device
    lc = model.__dict__["_lm"].config
    plan = model.flow_plan(TADA_FM, TADA_CFG, 1.0, "cosine", "logsnr")
    caches = init_caches(lc, 2, TADA_STEPS + TADA_TIMED_STEPS + 4,
                         dtype=model.model.embed_tokens.weight.dtype,
                         device=dev)
    ids = torch.tensor([[1000], [128004]], device=dev)
    ac = torch.zeros((1, 1, model.config.acoustic_dim), device=dev)
    one = torch.ones((1, 1), dtype=torch.long, device=dev)
    noise = torch.randn((1, model.config.latent_size), device=dev)

    def step(i):
        with torch.inference_mode():
            return model.step(caches, i, ids, ac, one, one * 6, one * 6,
                              noise, plan)

    per_step = [1e3 * _sync_s(lambda i=i: step(i))[1]
                for i in range(TADA_TIMED_STEPS)]
    before = qmm_kernel.launches
    step(TADA_TIMED_STEPS)
    k2_step = qmm_kernel.launches - before
    kern, dev_ms, step_ms, busy = _profile_steps(
        lambda: step(TADA_TIMED_STEPS + 1), 1)
    rows = int(run["latent_rows"])
    lat = np.random.RandomState(0).randn(rows, model.config.acoustic_dim) \
        .astype(np.float32)
    codec_ms = _time_ms(lambda: model.decode_latents(
        lat, np.ones(rows, np.int64)), 3)
    laps("steps timed, one profiled, codec timed")
    bound, by, gb = tada_step_bound(model, TADA_STEPS // 2)
    out = dict(wall=wall, xrt=r.samples / model.sample_rate / wall,
               p50=float(np.percentile(per_step, 50)),
               p95=float(np.percentile(per_step, 95)), codec_ms=codec_ms,
               kernels=kern, dev_ms=dev_ms, busy=busy, bound=bound, by=by,
               gb=gb, peak=peak, k2=k2, k2_step=k2_step, paths=paths,
               rows=rows)
    log(f"[tada] {label}: {TADA_STEPS} steps ({TADA_FM} flow steps, CFG "
        f"{TADA_CFG}) -> {rows} latent rows, "
        f"{r.samples / model.sample_rate:.2f} s of audio in {wall:.3f} s (xRT {out['xrt']:.3f}); steps timed "
        f"alone {out['p50']:.2f} ms p50, {out['p95']:.2f} p95; a profiled "
        f"step: {kern:.0f} kernels, {dev_ms:.3f} ms of device time against "
        f"{step_ms:.2f} ms ({100 * busy:.1f}% busy); bound {bound:.3f} ms a "
        f"step ({by}: {gb:.3f} GB), {100 * bound / out['p50']:.1f}% of it "
        f"reached at p50; the codec decode of {rows} rows {codec_ms:.2f} ms; "
        f"K2 {k2} launches in the request ({k2_step} a step, by path "
        f"{paths}); peak {peak:.2f} GB above the earlier phases' ({card})")
    laps.log()
    return out


def phase_tada_full(card: str, recorder: K2Recorder) -> int:
    """Phase 68: TADA-1B at the JAX defaults, seeded on the card in bf16,
    the duration bias of `_tada_bias`: the head's velocity bf16 against
    f32; the request in bf16 (`_tada_run`); then every Linear the group
    divides quantized to q8 on K2 (`noisy_images_proj`, 528 wide, stays
    dense): the run again, K2's launches a step against the config's (the
    llama's 112, `acoustic_proj`, `cond_proj`, the 7 adaLN linears once,
    20 flow steps x the head's 19 others), q8 against bf16 on the same
    velocity. -> K2's launches."""
    import torch

    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.tts.models.tada import Model
    from mlx_audio_tpu_torch.tts.models.tada.tada import \
        diffusion_head_forward
    from mlx_audio_tpu_torch.utils import apply_quantization

    t0 = time.perf_counter()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    base = torch.cuda.memory_allocated()
    model = Model(device=DEVICE)
    model.astype(torch.bfloat16)
    model.init_params(seed=0, on_device=True)
    _tada_bias(model, TADA_FRAMES)
    model._tokenizer = TadaTok(small=False)
    cfg = model.config
    head = model.prediction_head
    log(f"[tada] TADA-1B at the JAX defaults (llama 2,048 x 16, head 6 x "
        f"2,048, codec decoder 1,024 with strides {cfg.decoder_strides}): "
        f"{model.num_params():,} params drawn on the card in bf16 from seed 0"
        f" in {time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device=DEVICE).manual_seed(68)
    x = torch.randn(2, cfg.latent_size, generator=g, device=DEVICE)
    t = torch.rand(2, generator=g, device=DEVICE)
    cond = torch.randn(2, cfg.hidden_size, generator=g, device=DEVICE)
    with torch.inference_mode():
        v16 = diffusion_head_forward(head, cfg, x, t, cond)
        head.float()
        v32 = diffusion_head_forward(head, cfg, x, t, cond)
        head.to(torch.bfloat16)
    rel = rel_err(v16, v32)
    if not rel < TADA_BF16_REL:
        raise AssertionError(f"TADA head bf16 vs f32: {rel:.3e}")
    bf16 = _tada_run(model, "bf16", card, base, recorder)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the bf16 TADA launched K1 or K2")
    t1 = time.perf_counter()
    apply_quantization(model, {"quantization": {"group_size": MLX_GROUP,
                                                "bits": 8}})
    torch.cuda.empty_cache()
    held = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    with torch.inference_mode():
        vq = diffusion_head_forward(head, cfg, x, t, cond)
    relq = rel_err(vq, v16)
    q8 = _tada_run(model, "q8 (K2)", card, base, recorder)
    # the llama, acoustic_proj; cond_proj and the adaLN linears once a step,
    # the FFNs, final.linear (and noisy_images_proj where the group divides
    # its width) once a flow step; t_embedder once a request; the codec's
    # decoder_proj and attention linears
    noisy = int(isinstance(head.noisy_images_proj, QuantizedLinear))
    lm_q = 7 * cfg.num_hidden_layers
    head_once = 1 + cfg.head_layers + 1
    head_each = 3 * cfg.head_layers + 1 + noisy
    want = lm_q + 1 + head_once + TADA_FM * head_each
    codec_q = 1 + 4 * cfg.decoder_num_attn_layers
    if not (q8["k2_step"] == want and relq < TADA_Q8_REL
            and held == lm_q + 1 + head_once + head_each + 2 + codec_q
            and q8["k2"] == TADA_STEPS * want + 2 + codec_q):
        raise AssertionError(f"q8 TADA: {held} quantized linears, "
                             f"{q8['k2_step']} K2 launches a step (want "
                             f"{want}), {q8['k2']} in the request, q8 vs "
                             f"bf16 {relq:.3e}")
    log(f"[tada] q8 (group {MLX_GROUP}, {held} linears on K2 in "
        f"{time.perf_counter() - t1:.2f} s; noisy_images_proj "
        f"{'on K2' if noisy else 'dense'}) against "
        f"bf16 on this card: {q8['p50']:.2f} vs {bf16['p50']:.2f} ms a step "
        f"p50, {q8['p95']:.2f} vs {bf16['p95']:.2f} p95, xRT {q8['xrt']:.3f} "
        f"vs {bf16['xrt']:.3f}, {q8['kernels']:.0f} vs {bf16['kernels']:.0f} "
        f"kernels and {q8['dev_ms']:.3f} vs {bf16['dev_ms']:.3f} ms of device "
        f"time a step, bound {q8['bound']:.3f} vs {bf16['bound']:.3f} ms, "
        f"peak {q8['peak']:.2f} vs {bf16['peak']:.2f} GB; K2 {want} launches "
        f"a step ({lm_q} + acoustic_proj + {head_once} once + {TADA_FM} x "
        f"{head_each}; {q8['k2']} in the request); the velocity q8 vs bf16 "
        f"rel {relq:.3e}, bf16 vs f32 "
        f"{rel:.3e} (limits {TADA_Q8_REL:g}, {TADA_BF16_REL:g}) ({card})")
    if snake_conv_kernel.launches != before[0]:
        raise AssertionError("TADA launched K1")
    k2 = qmm_kernel.launches - before[1]
    del model, head
    torch.cuda.empty_cache()
    log(f"[time] phase 68 in {time.perf_counter() - t0:.1f} s")
    return k2


def moss_frame_bound(model, cols: int) -> tuple:
    """The least time one MOSS-TTS frame could take, B = 1: its bytes (the
    LM's linears once; the text head once; the audio heads once; the
    v1.5 GPT-2's linears once for each of its n_vq + 1 positions; the
    n_vq + 1 embedding rows; the f32 K/V of `cols` cache columns) over
    3.35 TB/s, against its operations over 989 TFLOP/s. -> (ms, "bytes"
    or "operations", GB)."""
    cfg = model.config
    lc = cfg.language_config
    lm = model.lm()

    def wbytes(mods):
        return sum(v.numel() * v.element_size() for m in mods
                   for v in list(m.parameters(recurse=False))
                   + list(m.buffers(recurse=False)))

    def lin(root):
        return [m for m in root.modules() if hasattr(m, "in_features")]

    def params(mods):
        return sum((m.w_q.numel() if hasattr(m, "w_q")
                    else m.weight.numel()) for m in mods)

    lm_lin = lin(lm)
    heads = [model.text_lm_head, model.audio_lm_heads]
    passes = 1
    local = []
    if cfg.is_v15_local_transformer:
        local = lin(model.local_transformer)
        passes = cfg.n_vq + 1
    dt = lm.embed_tokens.weight.element_size()
    nbytes = (wbytes(lm_lin) + wbytes(heads) + passes * wbytes(local)
              + (cfg.n_vq + 1) * lc.hidden_size * dt
              + 2 * lc.num_hidden_layers * cols * lc.num_key_value_heads
              * lc.head_dim * 4)
    ops = 2 * (params(lm_lin) + params(heads) + passes * params(local))
    by_bytes, by_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_BF16 * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", nbytes / 1e9)


def _moss_run(model, label: str, card: str, base: int, recorder,
              frames: int) -> dict:
    """A warm-up; one request of `frames` frames through
    `generate_*_ids` (wall, its frames, peak, K2's launches by path);
    MOSS_TIMED_FRAMES single-frame chunks (ms a frame p50/p95, each with
    its read); a chunk of 2 frames profiled (kernels, device ms and busy
    share a frame); K2's launches a frame; the frame's bound. -> the
    numbers."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel

    cfg = model.config
    v15 = cfg.is_v15_local_transformer
    laps = Laps(f"moss-tts {label}")
    proc = model._processor()
    rows = proc([[proc.build_user_message(text=MOSS_TEXT)]])["input_ids"]
    ids = model.generate_v15_local_ids if v15 else \
        model.generate_delay_pattern_ids
    ids(rows, max_new_tokens=4)
    laps("warm-up")
    torch.cuda.reset_peak_memory_stats()
    k2 = qmm_kernel.launches
    with recorder:
        paths0 = dict(recorder.paths)
        out, wall = _sync_s(lambda: ids(rows, max_new_tokens=frames, seed=1))
        paths = {p: n - paths0.get(p, 0) for p, n in recorder.paths.items()
                 if n != paths0.get(p, 0)}
    k2 = qmm_kernel.launches - k2
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    run = dict(model.last_run)
    gen = out[0][1]
    if not (run["frames"] == frames and np.isfinite(gen).all()):
        raise AssertionError(f"MOSS-TTS {label}: {run}")
    if not v15 and not (gen[-frames + cfg.n_vq + 1:, 1:]
                        != cfg.audio_pad_code).all():
        raise AssertionError(f"MOSS-TTS {label}: the delay decode left the "
                             f"audio: {gen[-frames:, 0]}")
    laps("the request")
    n = MOSS_TIMED_FRAMES + 4
    if v15:
        s = model.start_local(rows, n + 4, 2)
        k = model.local_knobs()

        def chunk(m):
            with torch.inference_mode():
                return torch.stack([torch.cat(model.v15_frame(s, k))
                                    for _ in range(m)]).cpu()
    else:
        s = model.start_delay(rows, n + 4, 2)
        k = model.delay_knobs()

        def chunk(m):
            return model.delay_chunk(s, k, m)

    per = [1e3 * _sync_s(lambda: chunk(1))[1]
           for _ in range(MOSS_TIMED_FRAMES)]
    before = qmm_kernel.launches
    chunk(1)
    k2_frame = qmm_kernel.launches - before
    kern, dev_ms, step_ms, busy = _profile_steps(lambda: chunk(1), 1)
    laps("frames timed, one profiled")
    bound, by, gb = moss_frame_bound(model, rows.shape[1] + frames // 2)
    out = dict(wall=wall, p50=float(np.percentile(per, 50)),
               p95=float(np.percentile(per, 95)), kernels=kern,
               dev_ms=dev_ms, busy=busy, bound=bound, by=by, gb=gb, peak=peak,
               k2=k2, k2_frame=k2_frame, paths=paths)
    log(f"[moss-tts] {label}: {frames} frames ({rows.shape[1]}-row prompt, "
        f"{run['chunks']} chunks) in {wall:.3f} s ({1e3 * wall / frames:.2f} "
        f"ms a frame, {frames * 0.08 / wall:.3f} xRT of 80-ms frames); "
        f"single-frame chunks {out['p50']:.2f} ms a frame p50, "
        f"{out['p95']:.2f} p95 (the frame is 80 ms); a profiled frame: "
        f"{kern:.0f} kernels, {dev_ms:.3f} ms of device time against "
        f"{step_ms:.2f} ms ({100 * busy:.1f}% busy); bound {bound:.3f} ms a "
        f"frame ({by}: {gb:.3f} GB), {100 * bound / out['p50']:.1f}% of it "
        f"reached at p50; K2 {k2} launches in the request ({k2_frame} a "
        f"frame, by path {paths}); peak {peak:.2f} GB above the earlier "
        f"phases' ({card})")
    laps.log()
    return out


def _build_moss(layout: str):
    import torch

    from mlx_audio_tpu_torch.tts.models.moss_tts import Model

    cfg = {"model_type": "moss_tts_delay"} if layout == "delay" else \
        {"model_type": "moss_tts_local", "gpt2_config": MOSS_GPT2}
    model = Model(cfg, device=DEVICE)
    model.astype(torch.bfloat16)
    model.init_params(seed=0, on_device=True)
    _moss_text_bias(model, 30.0, 20.0)
    model.tokenizer, model.audio_tokenizer = MossTok(), MossCodec()
    return model


def phase_moss_full(card: str, recorder: K2Recorder) -> int:
    """Phases 69-70: MOSS-TTS at the JAX defaults seeded on the card in
    bf16, the text head's bias of `_moss_text_bias`: the delay layout's
    request of MOSS_FRAMES frames in bf16, then every Linear the
    predicate and the group pass quantized to q8 on K2 (K2's launches a
    frame against the config's: the LM's 196, the text head and the
    audio heads), q8 against bf16 on one step's logits; then the v1.5
    layout's request of MOSS_V15_FRAMES frames in bf16. -> K2's
    launches."""
    import torch

    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.utils import apply_quantization

    t0 = time.perf_counter()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    base = torch.cuda.memory_allocated()
    model = _build_moss("delay")
    cfg = model.config
    lc = cfg.language_config
    log(f"[moss-tts] MOSS-TTS delay at the JAX defaults (Qwen3 LM "
        f"{lc.hidden_size} x {lc.num_hidden_layers}, {lc.vocab_size:,} ids, {cfg.n_vq} "
        f"channels of {cfg.audio_vocab_size + 1}): {model.num_params():,} "
        f"params drawn on the card in bf16 from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s")
    proc = model._processor()
    rows = proc([[proc.build_user_message(text=MOSS_TEXT)]])["input_ids"]

    def logits():
        with torch.inference_mode():
            s = model.start_delay(rows, 1)
            h = model._lm_step(model._embed_rows_delay(s["row"]),
                               s["caches"], s["offset"])
            return torch.cat([model.text_lm_head(h),
                              model.audio_lm_heads(h)], dim=-1)

    l16 = logits()
    bf16 = _moss_run(model, "delay bf16", card, base, recorder, MOSS_FRAMES)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the bf16 MOSS-TTS launched K1 or K2")
    t1 = time.perf_counter()
    apply_quantization(model, {"quantization": {"group_size": MLX_GROUP,
                                                "bits": 8}},
                       model.model_quant_predicate)
    torch.cuda.empty_cache()
    held = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    relq = rel_err(logits(), l16)
    q8 = _moss_run(model, "delay q8 (K2)", card, base, recorder,
                   MOSS_FRAMES)
    want = 7 * lc.num_hidden_layers + 2
    if not (held == want and q8["k2_frame"] == want
            and relq < MOSS_Q8_REL):
        raise AssertionError(f"q8 MOSS-TTS: {held} quantized linears, "
                             f"{q8['k2_frame']} K2 launches a frame (want "
                             f"{want}), q8 vs bf16 logits {relq:.3e}")
    log(f"[moss-tts] delay q8 (group {MLX_GROUP}, {held} linears on K2 in "
        f"{time.perf_counter() - t1:.2f} s; audio_embeddings dense) against "
        f"bf16 on this card: {q8['p50']:.2f} vs {bf16['p50']:.2f} ms a frame "
        f"p50, {q8['p95']:.2f} vs {bf16['p95']:.2f} p95, {q8['kernels']:.0f} "
        f"vs {bf16['kernels']:.0f} kernels and {q8['dev_ms']:.3f} vs "
        f"{bf16['dev_ms']:.3f} ms of device time a frame, bound "
        f"{q8['bound']:.3f} vs {bf16['bound']:.3f} ms, peak {q8['peak']:.2f} "
        f"vs {bf16['peak']:.2f} GB; K2 {want} launches a frame; one step's "
        f"logits q8 vs bf16 rel {relq:.3e} (limit {MOSS_Q8_REL:g}) ({card})")
    k2 = qmm_kernel.launches - before[1]
    del model
    torch.cuda.empty_cache()
    log(f"[time] phase 69 in {time.perf_counter() - t0:.1f} s")
    t2 = time.perf_counter()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    base = torch.cuda.memory_allocated()
    model = _build_moss("v15")
    g = model.local_transformer.cfg
    log(f"[moss-tts] MOSS-TTS v1.5 local: the delay LM with a {g.n_layer}-"
        f"layer GPT-2 {g.n_embd} wide, {g.n_head} heads, n_inner "
        f"{g.n_inner}: {model.num_params():,} params in bf16")
    _moss_run(model, "v1.5 bf16", card, base, recorder, MOSS_V15_FRAMES)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the bf16 v1.5 MOSS-TTS launched K1 or K2")
    del model
    torch.cuda.empty_cache()
    log(f"[time] phase 70 in {time.perf_counter() - t2:.1f} s")
    return k2


def phase_slice8b(card: str, recorder: K2Recorder) -> int:
    """Phases 67-70; K2 only on the q8 models, K1 nowhere. -> K2's
    launches."""
    import torch

    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    t0 = time.perf_counter()
    k1 = snake_conv_kernel.launches
    with tempfile.TemporaryDirectory() as tmp:
        k2 = phase_slice8b_reference(Path(tmp))
    torch.cuda.empty_cache()
    k2 += phase_tada_full(card, recorder)
    k2 += phase_moss_full(card, recorder)
    if snake_conv_kernel.launches != k1:
        raise AssertionError("TADA or MOSS-TTS launched K1")
    log(f"[time] phases 67-70 in {time.perf_counter() - t0:.1f} s; K2 {k2} "
        f"launches (the q8 models)")
    return k2


def main() -> int:
    if not (ROOT / "mlx_audio_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(mlx_audio_tpu_torch/ not found beside this script)")
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    card = phase_device()
    time_steps()
    log(card)
    phase_build()
    kres, kextra = phase_kernels(card)
    phase_reference_check()
    with tempfile.TemporaryDirectory() as tmp:
        k1_launches, legs_per_synth, icfg = phase_main_path(card, Path(tmp))
    qres = phase_qmm(card)
    phase_qwen3_reference()
    model = build_qwen3()
    phase_qwen3_q8_prefill(model)
    recorder = K2Recorder()
    k2_launches = phase_qwen3_main(model, card, recorder)
    phase_qwen3_streaming_reference()
    k2_launches += phase_qwen3_stream(model, card, recorder)
    k2_launches += phase_qwen3_session(model, card, recorder)
    # Whisper: dense bf16 products, neither K1 nor K2 on its path
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    phase_whisper_reference()
    whisper = phase_whisper_turbo(card)["model"]
    with tempfile.TemporaryDirectory() as tmp:
        # phase 14's three STT CLIs run side by side, their checks after
        checks = [phase_whisper_cli(Path(tmp)), phase_voxtral_cli(Path(tmp)),
                  phase_cohere_cli(Path(tmp))]
        phase_higgs_load(Path(tmp))
        phase_tts_loads(Path(tmp))
        for check in checks:
            check()
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the Whisper phases or the CLI launched K1 or "
                             "K2")
    # Voxtral Realtime: dense bf16 products, neither K1 nor K2 on its path
    with tempfile.TemporaryDirectory() as tmp:
        phase_voxtral_reference(Path(tmp))
        voxtral = phase_voxtral_full(card, Path(tmp))["model"]
        if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
            raise AssertionError("the Voxtral phases launched K1 or K2")
        # the server: Kokoro (K1), Qwen3-TTS q8 (K2), Whisper, Voxtral and
        # Silero through its request core
        k1_server, k2_server = phase_server(card, model, whisper, voxtral,
                                            Path(tmp), recorder)
    k1_launches += k1_server
    k2_launches += k2_server
    del whisper, voxtral
    torch.cuda.empty_cache()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    # Cohere ASR: dense bf16 products, neither K1 nor K2 on its path
    phase_cohere_reference()
    phase_cohere_full(card)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the Cohere phases launched K1 or K2")
    log(f"[time] phases 1-18 and 26 in {time.perf_counter() - t_start:.1f} s")
    # voice cloning on the Mimi stack: K2 in phase 28 only (the q8
    # Qwen3-TTS of phases 6-11), neither kernel in phases 27 and 29
    t_clone = time.perf_counter()
    k2_launches += phase_clone(model, card, recorder)
    torch.cuda.empty_cache()
    log(f"[time] phases 27-29 in {time.perf_counter() - t_clone:.1f} s; "
        f"phases 1-18, 26-29 in {time.perf_counter() - t_start:.1f} s")
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    # Higgs Audio v2: dense bf16 and W8A8 (torch._int_mm) products in
    # phases 19-20, neither K1 nor K2; K2 in phase 21, on the affine-q8
    # backbone between phase 20's two lanes
    t_higgs = time.perf_counter()
    phase_higgs_reference()
    model_h, codec_h, emb_h, mask_h, logits_h, bf16_lane = \
        phase_higgs_full(card)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the Higgs bf16 phases launched K1 or K2")
    k2_launches += phase_higgs_k2(model_h, emb_h, mask_h, card, recorder)
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    q8_lane = phase_higgs_w8a8(model_h, codec_h, emb_h, mask_h, logits_h,
                               card)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the W8A8 lane launched K1 or K2")
    del model_h, codec_h
    log(f"[higgs] W8A8 against bf16 on this card: {q8_lane['frame_ms']:.2f} "
        f"vs {bf16_lane['frame_ms']:.2f} ms a frame, xRT "
        f"{q8_lane['xrt']:.3f} vs {bf16_lane['xrt']:.3f}, "
        f"{q8_lane['launches']:.0f} vs {bf16_lane['launches']:.0f} kernels a "
        f"frame ({card})")
    log(f"[time] phases 19-21 in {time.perf_counter() - t_higgs:.1f} s; "
        f"phases 1-21 in {time.perf_counter() - t_start:.1f} s")
    # KugelAudio and VibeVoice: dense bf16 and W8A8 products in phases 22,
    # 23 and 25, neither K1 nor K2; K2 in phase 24, on the affine-q8 LM
    # between phase 23's two lanes
    import torch

    t_kugel = time.perf_counter()
    torch.cuda.empty_cache()
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    phase_kugel_reference(card)
    model_k, probe_k, bf16_k = phase_kugel_full(card)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the KugelAudio bf16 phases launched K1 or K2")
    k2_launches += phase_kugel_k2(model_k, card, recorder)
    with tempfile.TemporaryDirectory() as tmp:
        k2_launches += phase_kugel_q8_load(Path(tmp), card, recorder)
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    w8_k = phase_kugel_w8a8(model_k, probe_k, card)
    del model_k, probe_k
    torch.cuda.empty_cache()
    phase_vibevoice_full(card)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the KugelAudio W8A8 lane or VibeVoice launched "
                             "K1 or K2")
    log(f"[kugel] W8A8 against bf16 on this card: {w8_k['frame_ms']:.2f} vs "
        f"{bf16_k['frame_ms']:.2f} ms a frame, xRT {w8_k['xrt']:.3f} vs "
        f"{bf16_k['xrt']:.3f}, {w8_k['launches']:.0f} vs "
        f"{bf16_k['launches']:.0f} kernels a frame ({card})")
    log(f"[time] phases 22-25 in {time.perf_counter() - t_kugel:.1f} s; "
        f"phases 1-25 in {time.perf_counter() - t_start:.1f} s ({card})")
    # the NeMo ASR families: dense products, neither K1 nor K2
    phase_nemo(card)
    log(f"[time] phases 1-31 in {time.perf_counter() - t_start:.1f} s "
        f"({card})")
    # speech-to-speech: K2 on the q8 Moshi only
    k2_launches += phase_sts(card, recorder)
    log(f"[time] phases 1-34 in {time.perf_counter() - t_start:.1f} s "
        f"({card})")
    # pre-quantized checkpoints, the convert CLI and Orpheus: K2 at 4 bits
    k2_launches += phase_orpheus(card, recorder)
    log(f"[time] phases 1-37 in {time.perf_counter() - t_start:.1f} s "
        f"({card})")
    # the Qwen3 LM families: K2 on the q8 Qwen3-ASR and the small packed
    # checkpoints
    k2_launches += phase_qwen3_lm(card, recorder)
    log(f"[time] phases 1-40 in {time.perf_counter() - t_start:.1f} s "
        f"({card})")
    # the LLM-decoder STT families: K2 on the packed Voxtral and
    # Qwen2-Audio
    k2_launches += phase_llm_stt(card, recorder)
    log(f"[time] phases 1-44 in {time.perf_counter() - t_start:.1f} s "
        f"({card})")
    # OuteTTS over the DAC, Pocket-TTS and EnCodec, MMS and language ID:
    # K2 on the q8 OuteTTS models
    k2_launches += phase_outetts_lid(card, recorder)
    log(f"[time] phases 1-48 in {time.perf_counter() - t_start:.1f} s "
        f"({card})")
    # the Kaldi fbank families: K2 on the q8 Fun-ASR-Nano models
    k2_launches += phase_kaldi_families(card, recorder)
    log(f"[time] phases 1-52 in {time.perf_counter() - t_start:.1f} s "
        f"({card})")
    # the last six STT families: K2 on the small q8 directories and the
    # q8 MOSS-Music-8B
    k2_launches += phase_last_stt(card, recorder)
    log(f"[time] phases 1-55 in {time.perf_counter() - t_start:.1f} s "
        f"({card})")
    # Smart Turn, Sortformer and LFM2-Audio: K2 on the q8 LFM2-Audio models
    k2_launches += phase_slice7a(card, recorder)
    log(f"[time] phases 1-57 in {time.perf_counter() - t_start:.1f} s "
        f"({card})")
    # DACVAE and SAM-Audio (K2 on the q8 models), the voice pipeline (K1 on
    # its Kokoro), the WER eval CLI
    k1_turn, k2_sam = phase_slice7b(card, recorder)
    k1_launches += k1_turn
    k2_launches += k2_sam
    log(f"[time] phases 1-61 in {time.perf_counter() - t_start:.1f} s "
        f"({card})")
    # KittenTTS (K1 on its generator's legs), Soprano, Voxtral-4B-TTS (K2
    # on the q8 models) and OmniVoice
    k1_kit, k2_vox = phase_slice8a(card, recorder)
    k1_launches += k1_kit
    k2_launches += k2_vox
    log(f"[time] phases 1-66 in {time.perf_counter() - t_start:.1f} s "
        f"({card})")
    # TADA and MOSS-TTS: K2 on the q8 models
    k2_launches += phase_slice8b(card, recorder)
    log(f"[time] phases 1-70 in {time.perf_counter() - t_start:.1f} s "
        f"({card})")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    k2_path_abs = phase_qmm_path(recorder.shapes())

    # K1: the 48 legs of one synth of two rows (B=2) at the 1024-frame
    # bucket, summed from the per-shape times of phase 3, by the dispatched
    # bf16 path (wgmma) and the first design (wmma)
    legs = synth_legs(icfg)
    k1_ms, k1_plain, k1_wmma = (
        sum(kres[(path, c, k, d)][i] for c, k, d in legs)
        for path, i in (("wgmma", 2), ("wgmma", 3), ("wmma", 2)))
    k1_lib, k1_bound = (sum(kextra[leg][i] for leg in legs) for i in (0, 1))
    k1_ops = sum(kextra[leg][1] for leg in legs
                 if kextra[leg][2] == "operations")
    k1_abs = max(v[1] for key, v in kres.items() if key[0] == "wgmma")
    full_bound = sum(k1_bound_full(c, k) for c, k, _ in legs)
    log(f"[kernel] K1: the {len(legs)} legs of one B=2 synth at the "
        f"{KERNEL_FRAMES}-frame bucket, bf16: wgmma {k1_ms:.3f} ms, wmma "
        f"{k1_wmma:.3f} ms, plain {k1_plain:.3f} ms, cuDNN conv1d alone "
        f"{k1_lib:.3f} ms; bound {k1_bound:.3f} ms for this run's rows "
        f"({100 * k1_bound / k1_ms:.1f}% of it reached), {full_bound:.3f} ms "
        f"were every row valid ({card})")
    if not k1_ms < k1_wmma:
        raise AssertionError(f"wgmma {k1_ms:.3f} ms not faster than wmma "
                             f"{k1_wmma:.3f} ms over the 48 legs")
    # K2: the linears of one decode step at M=1 (bf16 x, 8-bit codes),
    # summed from the per-shape medians of phase 5, by the dispatched path
    # and by the first design (simt); the error over every dispatched case
    import torch

    step = frame_linears(model)
    m1 = qmm_paths(torch.bfloat16, 1)[0]
    k2_ms, k2_plain, simt_ms = (
        sum(qres[("bfloat16", n, k, 8, 1, path)][i] for n, k in step)
        for path, i in ((m1, 2), (m1, 3), ("simt", 2)))
    k2_abs = max([k2_path_abs] + [
        v[1] for (name, _, _, _, m, path), v in qres.items()
        if name == "bfloat16" and path == qmm_paths(torch.bfloat16, m)[0]])
    # bytes of one M=1 launch: the codes, their f32 scales and biases, the
    # bf16 row of x in and of y out (and an f32 bias where there is one)
    k2_bound = sum(n * k + 2 * n * (k // QMM_GROUP) * 4 + 2 * (k + n)
                   for n, k in step) / HBM_BPS * 1e3
    log(f"[kernel] K2: the {len(step)} linears of one decode step, M=1, "
        f"bf16 x, 8-bit codes: kernel ({m1}) {k2_ms:.3f} ms, simt "
        f"{simt_ms:.3f} ms, plain {k2_plain:.3f} ms; bound {k2_bound:.3f} ms "
        f"(bytes) ({card})")
    # the same frame in the b = 8 session (phase 11): M = 8 and 16
    frame8 = session_frame_linears(model, SESSION_B)
    b8_ms, b8_plain = (
        sum(qres[("bfloat16", n, k, 8, m, qmm_paths(torch.bfloat16, m)[0])][i]
            for m, n, k in frame8) for i in (2, 3))
    b8_bound = sum(n * k + 2 * n * (k // QMM_GROUP) * 4 + 2 * m * (k + n)
                   for m, n, k in frame8) / HBM_BPS * 1e3
    log(f"[kernel] K2: the {len(frame8)} linears of one b={SESSION_B} "
        f"session frame (M = {SESSION_B} and {2 * SESSION_B}, mma), bf16 x, "
        f"8-bit codes: kernel {b8_ms:.3f} ms, plain {b8_plain:.3f} ms; bound "
        f"{b8_bound:.3f} ms (bytes); {b8_ms / k2_ms:.2f}x the M=1 frame "
        f"({card})")

    print(json.dumps({"kernels": [{
        "name": "adain_snake_conv1d",
        "route": "cuda",
        "source": "mlx_audio_tpu_torch/csrc/snake_conv.cu",
        "replaces": "mlx_audio_tpu/ops/snake_conv_pallas.py:159",
        "launches": k1_launches,
        "max_abs_err": k1_abs,
        "ms": k1_ms,
        "plain_ms": k1_plain,
        "bound_ms": k1_bound,
        "bound_by": "operations" if 2 * k1_ops >= k1_bound else "bytes",
        "library_ms": k1_lib,
    }, {
        "name": "qmm_pallas",
        "route": "cuda",
        "source": "mlx_audio_tpu_torch/csrc/qmm.cu",
        "replaces": "mlx_audio_tpu/ops/qmm_pallas.py:82",
        "launches": k2_launches,
        "max_abs_err": k2_abs,
        "ms": k2_ms,
        "plain_ms": k2_plain,
        "bound_ms": k2_bound,
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
