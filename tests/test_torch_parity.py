"""End-to-end numerical parity vs the HF torch implementations.

Real checkpoints for whisper/encodec/mimi ship in the HF transformers
layout; these tests build tiny *torch* models, push their state dicts
through this package's `sanitize` pipeline (the exact path a downloaded
checkpoint takes), and assert the JAX forward matches torch to fp32
tolerance.  This validates checkpoint numerics end-to-end without network
access (reference parity targets: mlx_audio/stt/models/whisper/whisper.py,
mlx_audio/codec/models/encodec, mlx_audio/codec/models/mimi).
"""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
transformers = pytest.importorskip("transformers")

ATOL = 2e-4


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Whisper: encoder features + decoder logits through sanitize()
# ---------------------------------------------------------------------------


class TestWhisperTorchParity:
    @pytest.fixture(scope="class")
    def pair(self):
        from transformers import WhisperConfig, WhisperForConditionalGeneration

        from mlx_audio_tpu.stt.models.whisper import Model, ModelDimensions
        from mlx_audio_tpu.utils import unflatten

        torch.manual_seed(0)
        hf_cfg = WhisperConfig(
            vocab_size=200, num_mel_bins=16, d_model=32,
            encoder_layers=2, encoder_attention_heads=2,
            decoder_layers=2, decoder_attention_heads=2,
            encoder_ffn_dim=128, decoder_ffn_dim=128,
            max_source_positions=40, max_target_positions=32,
            pad_token_id=0, bos_token_id=1, eos_token_id=2,
            decoder_start_token_id=1,
            dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
        hf = WhisperForConditionalGeneration(hf_cfg).eval()

        dims = ModelDimensions.from_dict(hf_cfg.to_dict())
        model = Model(dims)
        flat = model.sanitize(
            {k: _np(v) for k, v in hf.state_dict().items()})
        model.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
        return hf, model

    @pytest.fixture(scope="class")
    def mel(self):
        # encoder conv2 has stride 2: 80 input frames -> 40 positions
        return np.random.RandomState(0).randn(1, 80, 16).astype(
            np.float32) * 0.5

    def test_encoder_features_match(self, pair, mel):
        hf, model = pair
        with torch.no_grad():
            ref = _np(hf.model.encoder(
                torch.from_numpy(mel.transpose(0, 2, 1))).last_hidden_state)
        ours = np.asarray(model.embed_audio(mel))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=ATOL)

    def test_decoder_logits_match(self, pair, mel):
        from mlx_audio_tpu.stt.models.whisper.whisper import (
            cross_kv, decoder_forward, encoder_forward)

        hf, model = pair
        toks = np.array([[3, 17, 42, 99, 150]], dtype=np.int64)
        with torch.no_grad():
            ref = _np(hf(
                input_features=torch.from_numpy(mel.transpose(0, 2, 1)),
                decoder_input_ids=torch.from_numpy(toks)).logits)
        feats = encoder_forward(model.params, model.dims, jnp.asarray(mel))
        ckv = cross_kv(model.params, model.dims, feats)
        pos = jnp.arange(toks.shape[1], dtype=jnp.int32)[None]
        logits, _ = decoder_forward(model.params, model.dims,
                                    jnp.asarray(toks.astype(np.int32)),
                                    pos, ckv, None, 0, None)
        ours = np.asarray(logits)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=ATOL)

    def test_greedy_tokens_match(self, pair, mel):
        from mlx_audio_tpu.stt.models.whisper.whisper import (
            cross_kv, decoder_forward, encoder_forward)

        hf, model = pair
        steps = 8
        # torch greedy rollout from BOS=1
        t_toks = [1]
        with torch.no_grad():
            feats_t = torch.from_numpy(mel.transpose(0, 2, 1))
            for _ in range(steps):
                logits = hf(input_features=feats_t,
                            decoder_input_ids=torch.tensor([t_toks])).logits
                t_toks.append(int(logits[0, -1].argmax()))
        # ours, full-context re-forward each step (parity, not speed)
        j_toks = [1]
        feats = encoder_forward(model.params, model.dims, jnp.asarray(mel))
        ckv = cross_kv(model.params, model.dims, feats)
        for _ in range(steps):
            ids = jnp.asarray([j_toks], dtype=jnp.int32)
            pos = jnp.arange(len(j_toks), dtype=jnp.int32)[None]
            logits, _ = decoder_forward(model.params, model.dims, ids, pos,
                                        ckv, None, 0, None)
            j_toks.append(int(jnp.argmax(logits[0, -1])))
        assert j_toks == t_toks


# ---------------------------------------------------------------------------
# EnCodec: RVQ codes + decoded waveform through sanitize()
# ---------------------------------------------------------------------------


class TestEncodecTorchParity:
    @pytest.fixture(scope="class")
    def pair(self):
        from transformers import EncodecConfig, EncodecModel

        from mlx_audio_tpu.codec.models.encodec import Encodec
        from mlx_audio_tpu.utils import unflatten

        torch.manual_seed(1)
        hf_cfg = EncodecConfig(
            target_bandwidths=[4.0], sampling_rate=800, audio_channels=1,
            num_filters=8, kernel_size=7, last_kernel_size=7,
            residual_kernel_size=3, num_residual_layers=1,
            dilation_growth_rate=2, num_lstm_layers=2,
            upsampling_ratios=[4, 2], hidden_size=16, codebook_size=64,
            codebook_dim=16, use_causal_conv=True, normalize=False,
            pad_mode="reflect", compress=2)
        hf = EncodecModel(hf_cfg).eval()
        # HF derives num_quantizers from bandwidth/frame-rate
        nq = hf.quantizer.num_quantizers

        model = Encodec(dict(
            audio_channels=1, num_filters=8, kernel_size=7,
            last_kernel_size=7, residual_kernel_size=3,
            num_residual_layers=1, dilation_growth_rate=2, num_lstm_layers=2,
            upsampling_ratios=[4, 2], hidden_size=16, codebook_size=64,
            codebook_dim=16, use_causal_conv=True, normalize=False,
            pad_mode="reflect", compress=2, sampling_rate=800,
            num_quantizers=nq))
        flat = model.sanitize({k: _np(v) for k, v in hf.state_dict().items()})
        model.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
        return hf, model, nq

    @pytest.fixture(scope="class")
    def audio(self):
        t = np.linspace(0, 1, 800, dtype=np.float32)
        x = (0.4 * np.sin(2 * np.pi * 13 * t)
             + 0.1 * np.random.RandomState(3).randn(800)).astype(np.float32)
        return x[None]  # (1, T)

    def test_encode_codes_match(self, pair, audio):
        hf, model, nq = pair
        with torch.no_grad():
            enc = hf.encode(torch.from_numpy(audio)[:, None, :])
        ref_codes = _np(enc.audio_codes[0])  # (B, nq, F)
        ours = np.asarray(model.encode(audio))
        assert ours.shape == ref_codes.shape
        assert (ours == ref_codes).mean() > 0.99

    def test_decode_waveform_matches(self, pair, audio):
        hf, model, nq = pair
        codes = np.random.RandomState(5).randint(
            0, 64, (1, nq, 25)).astype(np.int64)
        with torch.no_grad():
            ref = _np(hf.decode(torch.from_numpy(codes)[None],
                                audio_scales=[None]).audio_values)
        ours = np.asarray(model.decode(codes))[..., 0]  # (B, samples)
        n = min(ours.shape[-1], ref.shape[-1])
        np.testing.assert_allclose(ours[0, :n], ref[0, 0, :n], atol=ATOL)

    def test_roundtrip_matches_hf(self, pair, audio):
        hf, model, nq = pair
        with torch.no_grad():
            ref = _np(hf(torch.from_numpy(audio)[:, None, :]).audio_values)
        ours, _ = model(audio)
        ours = np.asarray(ours)[..., 0]
        n = min(ours.shape[-1], ref.shape[-1])
        np.testing.assert_allclose(ours[0, :n], ref[0, 0, :n], atol=5 * ATOL)


# ---------------------------------------------------------------------------
# Mimi: split-RVQ codes + decoded waveform via the HF-layout sanitize path
# ---------------------------------------------------------------------------


class TestMimiTorchParity:
    @pytest.fixture(scope="class")
    def pair(self):
        from transformers import MimiConfig as HFMimiConfig, MimiModel

        from mlx_audio_tpu.codec.models.mimi import Mimi
        from mlx_audio_tpu.utils import unflatten

        torch.manual_seed(2)
        hf_cfg = HFMimiConfig(
            sampling_rate=1600, frame_rate=100.0, audio_channels=1,
            hidden_size=16, num_filters=4, num_residual_layers=1,
            upsampling_ratios=[4, 2], kernel_size=7, last_kernel_size=3,
            residual_kernel_size=3, dilation_growth_rate=2,
            use_causal_conv=True, pad_mode="constant", compress=2,
            codebook_size=32, codebook_dim=8, num_quantizers=4,
            vector_quantization_hidden_dimension=8,
            num_semantic_quantizers=1, upsample_groups=16,
            num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=2, head_dim=8,
            intermediate_size=32, sliding_window=16, rope_theta=10000.0,
            layer_scale_initial_scale=0.01, use_conv_shortcut=False)
        hf = MimiModel(hf_cfg).eval()

        model = Mimi(hf_cfg.to_dict())  # HF flat schema through from_dict
        flat = model.sanitize({k: _np(v) for k, v in hf.state_dict().items()})
        model.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
        return hf, model

    @pytest.fixture(scope="class")
    def audio(self):
        t = np.linspace(0, 1, 1600, dtype=np.float32)
        x = (0.3 * np.sin(2 * np.pi * 21 * t)
             + 0.05 * np.random.RandomState(7).randn(1600)).astype(np.float32)
        return x[None]  # (1, T)

    def test_encode_codes_match(self, pair, audio):
        hf, model = pair
        with torch.no_grad():
            ref = _np(hf.encode(torch.from_numpy(audio)[:, None, :],
                                num_quantizers=4).audio_codes)
        ours = np.asarray(model.encode(audio))
        assert ours.shape == ref.shape
        assert (ours == ref).mean() > 0.99

    def test_decode_waveform_matches(self, pair):
        hf, model = pair
        codes = np.random.RandomState(11).randint(
            0, 32, (1, 4, 20)).astype(np.int64)
        with torch.no_grad():
            ref = _np(hf.decode(torch.from_numpy(codes)).audio_values)
        ours = np.asarray(model.decode(codes))
        n = min(ours.shape[-1], ref.shape[-1])
        np.testing.assert_allclose(ours[0, 0, :n], ref[0, 0, :n], atol=ATOL)

    def test_from_pretrained_roundtrip(self, pair, audio, tmp_path):
        """Saving the HF state dict to disk and loading through
        Model.from_pretrained reproduces the in-memory model."""
        import json

        from safetensors.numpy import save_file

        from mlx_audio_tpu.codec import Mimi

        hf, model = pair
        save_file({k: _np(v) for k, v in hf.state_dict().items()},
                  str(tmp_path / "model.safetensors"))
        cfg = hf.config.to_dict()
        cfg["model_type"] = "mimi"
        (tmp_path / "config.json").write_text(json.dumps(cfg))
        loaded = Mimi.from_pretrained(tmp_path)
        np.testing.assert_array_equal(np.asarray(loaded.encode(audio)),
                                      np.asarray(model.encode(audio)))


# ---------------------------------------------------------------------------
# Qwen2-Audio: audio tower + projector + LM logits through sanitize()
# ---------------------------------------------------------------------------


class TestQwen2AudioTorchParity:
    @pytest.fixture(scope="class")
    def pair(self):
        from transformers import (Qwen2AudioConfig,
                                  Qwen2AudioForConditionalGeneration)

        from mlx_audio_tpu.stt.models.qwen2_audio import Model
        from mlx_audio_tpu.utils import unflatten

        torch.manual_seed(3)
        hf_cfg = Qwen2AudioConfig(
            audio_config=dict(
                num_mel_bins=16, encoder_layers=2, encoder_attention_heads=2,
                encoder_ffn_dim=32, d_model=16, max_source_positions=1500,
                scale_embedding=False, activation_function="gelu"),
            text_config=dict(
                hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                num_key_value_heads=2, intermediate_size=64, vocab_size=300,
                max_position_embeddings=128, rope_theta=10000.0,
                tie_word_embeddings=False),
            audio_token_index=290)
        hf = Qwen2AudioForConditionalGeneration(hf_cfg).eval()

        cfg = hf_cfg.to_dict()
        model = Model(dict(
            audio_config=cfg["audio_config"], text_config=cfg["text_config"],
            audio_token_id=290))
        flat = model.sanitize({k: _np(v) for k, v in hf.state_dict().items()})
        model.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
        return hf, model

    def test_audio_tower_and_projector_match(self, pair):
        from mlx_audio_tpu.stt.models.whisper.audio import (
            N_FRAMES, log_mel_spectrogram)

        hf, model = pair
        wav = (0.1 * np.random.RandomState(9).randn(16000)).astype(np.float32)
        embeds, n_tok = model.get_audio_embeds(wav)
        # identical mel into the HF tower (bypasses feature-extractor drift)
        mel = np.zeros((N_FRAMES, 16), np.float32)
        m = np.asarray(log_mel_spectrogram(wav, n_mels=16))
        mel[: m.shape[0]] = m[:N_FRAMES]
        with torch.no_grad():
            feats = hf.audio_tower(
                torch.from_numpy(mel.T[None])).last_hidden_state
            ref = _np(hf.multi_modal_projector(feats))[0]
        ours = np.asarray(embeds)
        assert ours.shape == ref.shape and n_tok == ref.shape[0]
        np.testing.assert_allclose(ours, ref, atol=5 * ATOL)

    def test_lm_logits_match(self, pair):
        from mlx_audio_tpu.tts.models.llama.llama import (
            llama_forward, logits_from_hidden)

        hf, model = pair
        ids = np.random.RandomState(13).randint(0, 300, (1, 12))
        with torch.no_grad():
            ref = _np(hf.language_model(
                input_ids=torch.from_numpy(ids)).logits)
        hidden, _ = llama_forward(model.params["language_model"],
                                  model.config.text,
                                  jnp.asarray(ids.astype(np.int32)),
                                  causal=True)
        ours = np.asarray(logits_from_hidden(
            model.params["language_model"], model.config.text, hidden))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=5 * ATOL)


# ---------------------------------------------------------------------------
# DAC: RVQ codes + decoded waveform via the HF DacModel sanitize path
# ---------------------------------------------------------------------------


class TestDacTorchParity:
    @pytest.fixture(scope="class")
    def pair(self):
        from transformers import DacConfig, DacModel

        from mlx_audio_tpu.codec.models.descript import DAC
        from mlx_audio_tpu.utils import unflatten

        torch.manual_seed(4)
        hf_cfg = DacConfig(
            encoder_hidden_size=8, downsampling_ratios=[2, 4],
            decoder_hidden_size=8, upsampling_ratios=[4, 2],
            n_codebooks=3, codebook_size=16, codebook_dim=4,
            hidden_size=16, sampling_rate=800)
        hf = DacModel(hf_cfg).eval()

        model = DAC(hf_cfg.to_dict())
        flat = model.sanitize({k: _np(v) for k, v in hf.state_dict().items()})
        model.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
        return hf, model

    @pytest.fixture(scope="class")
    def audio(self):
        t = np.linspace(0, 1, 800, dtype=np.float32)
        return (0.4 * np.sin(2 * np.pi * 17 * t)).astype(np.float32)[None]

    def test_encode_codes_match(self, pair, audio):
        hf, model = pair
        with torch.no_grad():
            ref = _np(hf.encode(torch.from_numpy(audio)[:, None, :])
                      .audio_codes)
        _, ours = model.encode(audio)
        ours = np.asarray(ours)
        assert ours.shape == ref.shape
        assert (ours == ref).mean() > 0.99

    def test_decode_waveform_matches(self, pair):
        hf, model = pair
        codes = np.random.RandomState(17).randint(
            0, 16, (1, 3, 25)).astype(np.int64)
        with torch.no_grad():
            ref = _np(hf.decode(audio_codes=torch.from_numpy(codes))
                      .audio_values)
        z_q = model.from_codes(codes)
        ours = np.asarray(model.decode(z_q))[..., 0]
        n = min(ours.shape[-1], ref.shape[-1])
        np.testing.assert_allclose(ours[0, :n], ref[0, :n], atol=ATOL)


# ---------------------------------------------------------------------------
# CSM (sesame): backbone + depth decoder via the HF-layout sanitize path
# ---------------------------------------------------------------------------


class TestCsmTorchParity:
    @pytest.fixture(scope="class")
    def pair(self):
        from transformers import CsmConfig, CsmForConditionalGeneration

        from mlx_audio_tpu.tts.models.sesame import Model, ModelConfig
        from mlx_audio_tpu.utils import unflatten

        torch.manual_seed(5)
        hf_cfg = CsmConfig(
            vocab_size=40, text_vocab_size=120, num_codebooks=4,
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=8, intermediate_size=64,
            rope_theta=10000.0,
            depth_decoder_config=dict(
                num_codebooks=4, vocab_size=40, backbone_hidden_size=32,
                hidden_size=24, intermediate_size=48, num_hidden_layers=1,
                num_attention_heads=4, num_key_value_heads=2, head_dim=8,
                rope_theta=10000.0, max_position_embeddings=5),
            codec_config=dict(
                model_type="mimi", sampling_rate=1600, audio_channels=1,
                hidden_size=16, num_filters=4, num_residual_layers=1,
                upsampling_ratios=[4, 2], kernel_size=7, last_kernel_size=3,
                residual_kernel_size=3, dilation_growth_rate=2,
                use_causal_conv=True, codebook_size=32, codebook_dim=8,
                num_quantizers=4, vector_quantization_hidden_dimension=8,
                num_semantic_quantizers=1, upsample_groups=16,
                num_hidden_layers=2, num_attention_heads=2,
                num_key_value_heads=2, head_dim=8, intermediate_size=32,
                sliding_window=16))
        hf = CsmForConditionalGeneration(hf_cfg).eval()
        model = Model(ModelConfig.from_dict(hf_cfg.to_dict()))
        flat = model.sanitize({k: _np(v) for k, v in hf.state_dict().items()})
        model.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
        return hf, model

    def test_backbone_and_codebook0_logits_match(self, pair):
        from mlx_audio_tpu.nn import apply_embedding, apply_linear
        from mlx_audio_tpu.tts.models.llama.llama import llama_forward

        hf, model = pair
        ids = np.random.RandomState(3).randint(0, 120, (1, 6))
        with torch.no_grad():
            emb = hf.embed_text_tokens(torch.from_numpy(ids))
            h = hf.backbone_model(inputs_embeds=emb).last_hidden_state
            ref_l0 = _np(hf.lm_head(h[:, -1]))
        ours_emb = apply_embedding(model.params["text_embeddings"],
                                   jnp.asarray(ids))
        ours_h, _ = llama_forward({"model": model.params["backbone"]},
                                  model.bb_cfg, ours_emb, causal=True)
        ours_l0 = np.asarray(apply_linear(model.params["codebook0_head"],
                                          ours_h[:, -1]))
        np.testing.assert_allclose(np.asarray(ours_h), _np(h), atol=ATOL)
        np.testing.assert_allclose(ours_l0, ref_l0, atol=ATOL)

    def test_depth_decoder_step_matches(self, pair):
        from mlx_audio_tpu.nn import apply_embedding, apply_linear
        from mlx_audio_tpu.tts.models.llama.llama import llama_forward

        hf, model = pair
        c0 = 7
        h_last = torch.randn(1, 32)
        with torch.no_grad():
            # position 0 embeds are replaced by the backbone hidden state
            ref = _np(hf.depth_decoder(
                input_ids=torch.tensor([[0, c0]]),
                backbone_last_hidden_state=h_last).logits)[:, -1]
        p = model.params
        table = p.get("decoder_audio_embeddings", p["audio_embeddings"])
        c0_embed = apply_embedding(table, jnp.asarray([[c0]]))
        curr_h = jnp.concatenate(
            [jnp.asarray(h_last.numpy())[:, None], c0_embed], axis=1)
        proj = apply_linear(p["projection"], curr_h)
        dec_h, _ = llama_forward({"model": p["decoder"]}, model.dec_cfg,
                                 proj, causal=True)
        ours = np.asarray(jnp.einsum("bd,dv->bv", dec_h[:, -1],
                                     p["audio_head"][0]))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=ATOL)

    def test_embedded_codec_builds_mimi(self, pair):
        hf, model = pair
        assert model._mimi is None  # post_load_hook not run via direct bind
        from mlx_audio_tpu.tts.models.sesame import Model as SesameModel

        m2 = SesameModel.post_load_hook(model, "/nonexistent")
        assert m2._mimi is not None
        codes = np.random.RandomState(19).randint(0, 32, (1, 4, 10))
        audio = np.asarray(m2._mimi.decode(codes))
        assert audio.shape[0] == 1 and np.isfinite(audio).all()


# ---------------------------------------------------------------------------
# Voxtral: whisper tower + 4-frame projector + LM logits through sanitize()
# ---------------------------------------------------------------------------


class TestVoxtralTorchParity:
    @pytest.fixture(scope="class")
    def pair(self):
        from transformers import VoxtralConfig, VoxtralForConditionalGeneration

        from mlx_audio_tpu.stt.models.voxtral import Model
        from mlx_audio_tpu.utils import unflatten

        torch.manual_seed(7)
        hf_cfg = VoxtralConfig(
            audio_config=dict(
                num_mel_bins=16, encoder_layers=2, encoder_attention_heads=2,
                encoder_ffn_dim=32, d_model=16, max_source_positions=1500,
                intermediate_size=64, activation_function="gelu"),
            text_config=dict(
                hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                num_key_value_heads=2, intermediate_size=64, vocab_size=300,
                head_dim=16, rope_theta=10000.0, tie_word_embeddings=False))
        hf = VoxtralForConditionalGeneration(hf_cfg).eval()

        cfg = hf_cfg.to_dict()
        model = Model(dict(audio_config=cfg["audio_config"],
                           text_config=cfg["text_config"]))
        flat = model.sanitize({k: _np(v) for k, v in hf.state_dict().items()})
        model.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
        return hf, model

    def test_tower_and_projector_match(self, pair):
        from mlx_audio_tpu.stt.models.whisper.audio import (
            N_FRAMES, log_mel_spectrogram)

        hf, model = pair
        wav = (0.1 * np.random.RandomState(31).randn(16000)).astype(
            np.float32)
        ours = np.asarray(model.get_audio_embeds(wav))
        mel = np.zeros((N_FRAMES, 16), np.float32)
        m = np.asarray(log_mel_spectrogram(wav, n_mels=16))
        mel[: m.shape[0]] = m[:N_FRAMES]
        with torch.no_grad():
            enc = hf.audio_tower(
                torch.from_numpy(mel.T[None])).last_hidden_state
            grouped = enc.reshape(1, -1, 64)
            ref = _np(hf.multi_modal_projector(grouped))[0]
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=5 * ATOL)

    def test_lm_logits_match(self, pair):
        from mlx_audio_tpu.tts.models.llama.llama import (
            llama_forward, logits_from_hidden)

        hf, model = pair
        ids = np.random.RandomState(37).randint(0, 300, (1, 10))
        with torch.no_grad():
            ref = _np(hf.language_model(
                input_ids=torch.from_numpy(ids)).logits)
        hidden, _ = llama_forward(
            model.params["language_model"], model.config.text,
            jnp.asarray(ids.astype(np.int32)), causal=True)
        ours = np.asarray(logits_from_hidden(
            model.params["language_model"], model.config.text, hidden))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=5 * ATOL)


# ---------------------------------------------------------------------------
# GraniteSpeech: blocked-conformer CTC encoder + qformer projector
# ---------------------------------------------------------------------------


class TestGraniteSpeechTorchParity:
    @pytest.fixture(scope="class")
    def pair(self):
        from transformers import (GraniteSpeechConfig,
                                  GraniteSpeechForConditionalGeneration)

        from mlx_audio_tpu.stt.models.granite_speech import Model
        from mlx_audio_tpu.utils import unflatten

        torch.manual_seed(8)
        hf_cfg = GraniteSpeechConfig(
            encoder_config=dict(
                hidden_dim=32, num_layers=2, num_heads=4, dim_head=8,
                feedforward_mult=2, input_dim=16, num_mel_bins=16,
                output_dim=12, context_size=20, conv_kernel_size=3,
                conv_expansion_factor=2),
            text_config=dict(
                model_type="granite", hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, num_key_value_heads=2,
                intermediate_size=64, vocab_size=300,
                tie_word_embeddings=False),
            projector_config=dict(
                model_type="blip_2_qformer", hidden_size=32,
                num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=64, cross_attention_frequency=1,
                encoder_hidden_size=32),
            downsample_rate=2, window_size=8, audio_token_index=290)
        hf = GraniteSpeechForConditionalGeneration(hf_cfg).eval()

        cfg = hf_cfg.to_dict()
        model = Model(dict(
            encoder_config=cfg["encoder_config"],
            text_config=cfg["text_config"],
            projector_config=cfg["projector_config"],
            downsample_rate=2, window_size=8, audio_token_index=290))
        flat = model.sanitize({k: _np(v) for k, v in hf.state_dict().items()})
        model.bind(unflatten({k: jnp.asarray(np.asarray(v))
                              for k, v in flat.items()}))
        return hf, model

    def test_encoder_matches(self, pair):
        from mlx_audio_tpu.stt.models.granite_speech.granite_speech import (
            encoder_forward)

        hf, model = pair
        feats = (0.3 * np.random.RandomState(41).randn(1, 40, 16)).astype(
            np.float32)
        with torch.no_grad():
            ref = _np(hf.encoder(torch.from_numpy(feats)))
        ours = np.asarray(encoder_forward(model.params, model.config,
                                          jnp.asarray(feats)))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=5 * ATOL)

    def test_projector_matches(self, pair):
        from mlx_audio_tpu.stt.models.granite_speech.granite_speech import (
            projector_forward)

        hf, model = pair
        enc = (0.3 * np.random.RandomState(43).randn(1, 40, 32)).astype(
            np.float32)
        with torch.no_grad():
            ref = _np(hf.projector(torch.from_numpy(enc)))
        ours = np.asarray(projector_forward(model.params, model.config,
                                            jnp.asarray(enc)))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=5 * ATOL)


# ---------------------------------------------------------------------------
# Bark: semantic/coarse GPT + fine GPT through sanitize() (suno/bark repo
# ships the HF BarkModel layout, which matches this tree's naming)
# ---------------------------------------------------------------------------


class TestBarkTorchParity:
    @pytest.fixture(scope="class")
    def pair(self):
        from transformers import BarkConfig, BarkModel

        from mlx_audio_tpu.tts.models.bark import Model, ModelConfig
        from mlx_audio_tpu.utils import unflatten

        torch.manual_seed(6)
        gpt = dict(hidden_size=32, num_layers=2, num_heads=2,
                   vocab_size=64, output_vocab_size=64, block_size=64,
                   input_vocab_size=64, bias=True, dropout=0.0)
        hf_cfg = BarkConfig(
            semantic_config=dict(gpt),
            coarse_acoustics_config=dict(gpt),
            fine_acoustics_config=dict(gpt, n_codes_total=4, n_codes_given=2),
            codec_config=dict(model_type="encodec"))
        hf = BarkModel(hf_cfg).eval()

        g = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=64,
                 output_vocab_size=64, block_size=64, input_vocab_size=64,
                 bias=True)
        model = Model(ModelConfig(
            semantic_config=dict(g), coarse_acoustics_config=dict(g),
            fine_acoustics_config=dict(g, n_codes_total=4, n_codes_given=2)))
        sd = {k: _np(v) for k, v in hf.state_dict().items()
              if not k.startswith("codec_model.")}
        flat = model.sanitize(sd)
        model.bind(unflatten({k: jnp.asarray(np.asarray(v))
                              for k, v in flat.items()}))
        return hf, model

    def test_semantic_prefill_logits_match(self, pair):
        from mlx_audio_tpu.ops.kvcache import KVCache
        from mlx_audio_tpu.tts.models.bark.bark import gpt_prefill

        hf, model = pair
        ids = np.random.RandomState(23).randint(0, 64, (1, 10))
        with torch.no_grad():
            ref = _np(hf.semantic(input_ids=torch.from_numpy(ids)).logits)
        cfg = model.config.semantic_config
        caches = [KVCache.init(1, 32, cfg.n_head,
                               cfg.n_embd // cfg.n_head, jnp.float32)
                  for _ in range(cfg.n_layer)]
        logits, _ = gpt_prefill(model.params["semantic"], cfg,
                                jnp.asarray(ids), jnp.int32(10), caches)
        np.testing.assert_allclose(np.asarray(logits), ref[:, -1],
                                   atol=ATOL)

    def test_fine_forward_matches(self, pair):
        from mlx_audio_tpu.tts.models.bark.bark import fine_gpt_forward

        hf, model = pair
        codes = np.random.RandomState(29).randint(0, 64, (1, 12, 4))
        pred_idx = 2
        with torch.no_grad():
            ref = _np(hf.fine_acoustics(
                pred_idx, input_ids=torch.from_numpy(codes)).logits)
        ours = np.asarray(fine_gpt_forward(
            model.params["fine_acoustics"], model.config.fine_acoustics_config,
            pred_idx, jnp.asarray(codes)))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=ATOL)



# ---------------------------------------------------------------------------
# Parakeet: FastConformer encoder + CTC head vs HF ParakeetForCTC
# ---------------------------------------------------------------------------


class TestParakeetTorchParity:
    @pytest.fixture(scope="class")
    def pair(self):
        if not hasattr(transformers, "ParakeetForCTC"):
            pytest.skip("transformers without Parakeet")
        from mlx_audio_tpu.stt.models.parakeet import Model, ModelConfig
        from mlx_audio_tpu.utils import unflatten

        ec = transformers.ParakeetEncoderConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, conv_kernel_size=9, num_mel_bins=32,
            subsampling_conv_channels=16, subsampling_factor=8,
            subsampling_conv_kernel_size=3, dropout=0.0,
            dropout_positions=0.0, layerdrop=0.0, attention_dropout=0.0,
            activation_dropout=0.0)
        cfg = transformers.ParakeetCTCConfig(
            encoder_config=ec.to_dict(), vocab_size=40)
        torch.manual_seed(0)
        hf = transformers.ParakeetForCTC(cfg).eval()
        m = Model(ModelConfig.from_dict(cfg.to_dict()))
        m.bind(unflatten(m.sanitize(
            {k: _np(v) for k, v in hf.state_dict().items()})))
        return hf, m

    def test_config_translation(self, pair):
        _, m = pair
        a = m.enc_args
        assert (a.d_model, a.n_layers, a.feat_in) == (32, 2, 32)
        assert a.xscaling is True          # HF scale_input default
        assert m.config.vocab_size == 39   # HF vocab includes blank

    def test_encoder_matches(self, pair):
        from mlx_audio_tpu.stt.models.parakeet.conformer import (
            conformer_forward)

        hf, m = pair
        mel = np.random.default_rng(0).standard_normal(
            (2, 64, 32)).astype(np.float32)
        with torch.no_grad():
            ref = hf.encoder(
                input_features=torch.tensor(mel)).last_hidden_state
        ours = np.asarray(conformer_forward(
            m.params["encoder"], m.enc_args, jnp.asarray(mel)))
        np.testing.assert_allclose(ours, _np(ref), atol=ATOL)

    def test_ctc_logits_match(self, pair):
        from mlx_audio_tpu.nn import apply_conv1d
        from mlx_audio_tpu.stt.models.parakeet.conformer import (
            conformer_forward)

        hf, m = pair
        mel = np.random.default_rng(1).standard_normal(
            (1, 80, 32)).astype(np.float32)
        with torch.no_grad():
            ref = hf(input_features=torch.tensor(mel)).logits
        enc = conformer_forward(m.params["encoder"], m.enc_args,
                                jnp.asarray(mel))
        ours = np.asarray(apply_conv1d(
            m.params["ctc_decoder"]["conv"], enc))
        np.testing.assert_allclose(ours, _np(ref), atol=ATOL)


# ---------------------------------------------------------------------------
# Moshi: main transformer text logits + depformer slice logits through
# sanitize() from the HF transformers layout (kmhf/hf-moshiko)
# ---------------------------------------------------------------------------


class TestMoshiTorchParity:
    @pytest.fixture(scope="class")
    def pair(self):
        from transformers import MoshiConfig, MoshiForConditionalGeneration

        from mlx_audio_tpu.sts.models.moshi import Lm, LmConfig
        from mlx_audio_tpu.sts.models.moshi.moshi import sanitize_lm
        from mlx_audio_tpu.utils import unflatten

        torch.manual_seed(0)
        hf_cfg = MoshiConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, head_dim=16, audio_vocab_size=33,
            vocab_size=101, ffn_dim=88, rope_theta=10000.0,
            sliding_window=64, max_position_embeddings=128, num_codebooks=4,
            tie_word_embeddings=False,
            audio_encoder_config=dict(model_type="mimi"),
            depth_decoder_config=dict(
                hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, head_dim=8, audio_vocab_size=33,
                vocab_size=101, ffn_dim=44, sliding_window=8,
                num_codebooks=4, input_size=64))
        hf = MoshiForConditionalGeneration(hf_cfg).eval()
        with torch.no_grad():
            # FlexibleLinear stacks init as raw randn -> |logits| ~ 1e3,
            # which turns fp32 matmul noise into tolerance failures
            for name, param in hf.named_parameters():
                if param.ndim == 3 and "depth_decoder" in name:
                    param.mul_(0.05)

        cfg = LmConfig(
            transformer=dict(d_model=64, num_heads=4, num_layers=2,
                             dim_feedforward=88, hidden=44, context=63,
                             max_period=10000.0),
            depformer=dict(d_model=32, num_heads=4, num_layers=2,
                           dim_feedforward=44, hidden=22, num_slices=4,
                           context=8),
            text_in_vocab_size=102, text_out_vocab_size=101,
            audio_vocab_size=34, audio_codebooks=8,
            audio_delays=[0, 1, 1, 1, 0, 1, 1, 1])
        lm = Lm(cfg)
        flat = sanitize_lm(
            {k: jnp.asarray(_np(v)) for k, v in hf.state_dict().items()
             if not k.startswith("audio_encoder")}, cfg)
        lm.bind(unflatten(dict(flat)))
        return hf, lm

    @pytest.fixture(scope="class")
    def tokens(self):
        rs = np.random.RandomState(0)
        return (rs.randint(0, 101, (1, 6)),
                rs.randint(0, 33, (1, 4, 6)),
                rs.randint(0, 33, (1, 4, 6)))

    def _hf_hidden(self, hf, text, own, other):
        emb = hf.decoder.model.embed_tokens(torch.from_numpy(text))
        codes = torch.from_numpy(np.concatenate([own, other], axis=1))
        for cb in range(8):
            emb = emb + hf.embed_tokens[cb](codes[:, cb])
        return hf.decoder.model(inputs_embeds=emb).last_hidden_state

    def _our_hidden(self, lm, text, own, other):
        from mlx_audio_tpu.sts.models.moshi.moshi import (
            apply_scaled_embedding)

        p = lm.params
        xs = apply_scaled_embedding(p["text_emb"], jnp.asarray(text), 102)
        codes = np.concatenate([own, other], axis=1)
        for cb in range(8):
            xs = xs + apply_scaled_embedding(
                p["audio_embs"][str(cb)], jnp.asarray(codes[:, cb]), 34)
        t = lm.config.transformer
        hidden, _ = lm._main_step(p, xs, [None] * t.num_layers, 0)
        return hidden

    def test_text_logits_match(self, pair, tokens):
        from mlx_audio_tpu.nn import apply_linear

        hf, lm = pair
        text, own, other = tokens
        with torch.no_grad():
            ref_h = self._hf_hidden(hf, text, own, other)
            ref = _np(hf.decoder.lm_head(ref_h))
        hidden = self._our_hidden(lm, text, own, other)
        ours = np.asarray(apply_linear(lm.params["text_linear"], hidden))
        np.testing.assert_allclose(ours, ref, atol=ATOL)

    def test_depformer_slice_logits_match(self, pair, tokens):
        hf, lm = pair
        text, own, other = tokens
        # depth input: [last text token, own cb0..cb2] teacher-forced
        depth_in = np.concatenate(
            [text[:, -1:], own[:, :3, -1]], axis=1)  # (1, 4)
        with torch.no_grad():
            ref_h = self._hf_hidden(hf, text, own, other)
            dd = hf.depth_decoder(
                input_ids=torch.from_numpy(depth_in),
                last_hidden_state=ref_h[:, -1:].expand(1, 4, 64),
                use_cache=False)
            ref = _np(dd.logits)
        hidden = self._our_hidden(lm, text, own, other)
        ours = np.asarray(lm.depformer_logits(
            lm.params, hidden[:, -1:], jnp.asarray(depth_in)))
        # randn-init FlexibleLinear stacks drive |logits| ~ 1e3; use rtol
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=ATOL)

    def test_kv_cached_decode_matches_prefill(self, pair, tokens):
        from mlx_audio_tpu.nn import apply_linear

        hf, lm = pair
        text, own, other = tokens
        full = self._our_hidden(lm, text, own, other)
        # replay one token at a time through the jitted KV-cached step
        from mlx_audio_tpu.sts.models.moshi.moshi import (
            apply_scaled_embedding)

        p = lm.params
        caches = lm.make_caches(1, max_steps=16)
        codes = np.concatenate([own, other], axis=1)
        outs = []
        for i in range(text.shape[1]):
            xs = apply_scaled_embedding(
                p["text_emb"], jnp.asarray(text[:, i: i + 1]), 102)
            for cb in range(8):
                xs = xs + apply_scaled_embedding(
                    p["audio_embs"][str(cb)],
                    jnp.asarray(codes[:, cb, i: i + 1]), 34)
            h, caches = lm._main_step(p, xs, caches, i)
            outs.append(np.asarray(h[:, 0]))
        np.testing.assert_allclose(
            np.stack(outs, axis=1), np.asarray(full), atol=1e-4)


class TestMoshiKyutaiPtLayout:
    """The kyutai PyTorch layout (moshiko-pytorch-bf16) maps exactly onto
    the param tree (reference lm.py:332-411 load_pytorch_weights)."""

    def test_sanitize_covers_param_tree(self):
        from mlx_audio_tpu.sts.models.moshi import Lm, LmConfig
        from mlx_audio_tpu.sts.models.moshi.moshi import sanitize_lm
        from mlx_audio_tpu.utils import flatten

        cfg = LmConfig(
            transformer=dict(d_model=64, num_heads=4, num_layers=2,
                             dim_feedforward=88, hidden=44, context=63),
            depformer=dict(d_model=32, num_heads=4, num_layers=2,
                           dim_feedforward=44, hidden=22, num_slices=4,
                           context=8),
            text_in_vocab_size=102, text_out_vocab_size=101,
            audio_vocab_size=34, audio_codebooks=8,
            audio_delays=[0, 1, 1, 1, 0, 1, 1, 1])
        lm = Lm(cfg).init_and_bind()
        want = {k: v.shape for k, v in flatten(lm.params).items()}

        rs = np.random.RandomState(0)
        w = {"out_norm.alpha": rs.randn(1, 1, 64),
             "text_emb.weight": rs.randn(102, 64),
             "text_linear.weight": rs.randn(101, 64),
             "depformer_text_emb.weight": rs.randn(102, 32)}
        for cb in range(8):
            w[f"emb.{cb}.weight"] = rs.randn(34, 64)
        for li in range(2):
            pre = f"transformer.layers.{li}"
            w[f"{pre}.norm1.alpha"] = rs.randn(1, 1, 64)
            w[f"{pre}.norm2.alpha"] = rs.randn(1, 1, 64)
            w[f"{pre}.self_attn.in_proj_weight"] = rs.randn(192, 64)
            w[f"{pre}.self_attn.out_proj.weight"] = rs.randn(64, 64)
            w[f"{pre}.gating.linear_in.weight"] = rs.randn(88, 64)
            w[f"{pre}.gating.linear_out.weight"] = rs.randn(64, 44)
        for s in range(4):
            w[f"depformer_in.{s}.weight"] = rs.randn(32, 64)
            w[f"linears.{s}.weight"] = rs.randn(33, 32)
            if s:
                w[f"depformer_emb.{s - 1}.weight"] = rs.randn(34, 32)
        for li in range(2):
            pre = f"depformer.layers.{li}"
            w[f"{pre}.norm1.alpha"] = rs.randn(1, 1, 32)
            w[f"{pre}.norm2.alpha"] = rs.randn(1, 1, 32)
            w[f"{pre}.self_attn.in_proj_weight"] = rs.randn(4 * 96, 32)
            w[f"{pre}.self_attn.out_proj.weight"] = rs.randn(4 * 32, 32)
            for s in range(4):
                w[f"{pre}.gating.{s}.linear_in.weight"] = rs.randn(44, 32)
                w[f"{pre}.gating.{s}.linear_out.weight"] = rs.randn(32, 22)

        got = sanitize_lm({k: jnp.asarray(v) for k, v in w.items()}, cfg)
        assert set(got) == set(want)
        for k, v in got.items():
            assert tuple(v.shape) == tuple(want[k]), k


class TestConfucius4W2vBertParity:
    """confucius4's w2v-BERT conditioner vs HF Wav2Vec2BertModel.

    The repo's `w2v_hidden17` (confucius4.py:107) consumes the HF
    w2v-bert-2.0 state-dict naming directly, so a tiny random-init
    Wav2Vec2BertModel is a bit-level oracle for the conformer stack
    (relative-key attention, causal GLU conv module, macaron FFNs).
    """

    @pytest.fixture(scope="class")
    def pair(self):
        torch = pytest.importorskip("torch")
        from transformers import Wav2Vec2BertConfig, Wav2Vec2BertModel

        from mlx_audio_tpu.tts.models.confucius4 import ModelConfig
        from mlx_audio_tpu.tts.models.confucius4.confucius4 import (
            w2v_hidden17,
        )

        hf_cfg = Wav2Vec2BertConfig(
            hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
            intermediate_size=128, feature_projection_input_dim=24,
            position_embeddings_type="relative_key",
            left_max_position_embeddings=64,
            right_max_position_embeddings=8,
            conv_depthwise_kernel_size=31,
            hidden_dropout=0.0, activation_dropout=0.0,
            attention_dropout=0.0, feat_proj_dropout=0.0,
            conformer_conv_dropout=0.0, output_hidden_size=None,
            add_adapter=False)
        torch.manual_seed(0)
        hf = Wav2Vec2BertModel(hf_cfg).eval()

        W = {k: jnp.asarray(v.detach().numpy())
             for k, v in hf.state_dict().items()}
        cfg = ModelConfig(w2v_hidden=64, w2v_heads=4, w2v_layers=3)
        return hf, W, cfg, w2v_hidden17

    def test_hidden_states_match(self, pair):
        torch = pytest.importorskip("torch")
        hf, W, cfg, w2v_hidden17 = pair
        rs = np.random.RandomState(0)
        feats = rs.randn(1, 37, 24).astype(np.float32)
        with torch.no_grad():
            ref = hf(torch.from_numpy(feats)).last_hidden_state.numpy()
        got = np.asarray(w2v_hidden17(W, cfg, jnp.asarray(feats)))
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)

    def test_intermediate_layer_matches(self, pair):
        """cfg.w2v_layers < depth: repo stops at hidden_states[k] like the
        reference's hidden-17 tap of the 24-layer encoder."""
        torch = pytest.importorskip("torch")
        hf, W, cfg, w2v_hidden17 = pair
        from mlx_audio_tpu.tts.models.confucius4 import ModelConfig

        cfg2 = ModelConfig(w2v_hidden=64, w2v_heads=4, w2v_layers=2)
        rs = np.random.RandomState(1)
        feats = rs.randn(1, 21, 24).astype(np.float32)
        with torch.no_grad():
            ref = hf(torch.from_numpy(feats),
                     output_hidden_states=True).hidden_states[2].numpy()
        got = np.asarray(w2v_hidden17(W, cfg2, jnp.asarray(feats)))
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)
