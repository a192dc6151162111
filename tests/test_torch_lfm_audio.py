"""LFM2-Audio of the PyTorch port against the JAX package, on the CPU: the
cases of tests/test_lfm_audio.py (the LFM2 backbone's prefill, steps and
conv cache, the depthformer frame, interleaved and sequential generation,
the audio-input prefill, the detokenizer, the processor and chat state,
`sanitize`), each held to the JAX package's on one weight set; the
decode's rollback at each token that changes the schedule; the q8
directory on K2's plain version; the departures pinned (the hook that
raises, the Mimi and detokenizer that are never random, the short convs
no quantization touches, the layouts read from shapes).

Config: tests/test_lfm_audio.py's `_cfg` (4 codebooks of 33, an encoder
of 2 x d32, LFM2 4 x d64 with attention at layers 1 and 3, a depthformer
2 x d32, adapter 48) and `TestDetokenizer._detok`; one parameter set
drawn with numpy over JAX's shapes (`test_torch_mimi.numpy_params`); the
JAX side jitted (its generate loops jit their own programs). Hidden rows,
logits and waveforms at ATOL = 2e-4 (f32, summation order;
tests/test_torch_parity.py:19); greedy tokens equal. Where a test needs a
token that changes the schedule, it sets the special id (<|text_end|>,
<|im_end|>, <|audio_start|>, the audio EOS) in both packages to a token
the greedy run draws, so that the tiny model draws it.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
CFG = dict(codebooks=4, audio_vocab_size=33, interleaved_n_text=2,
           interleaved_n_audio=3,
           encoder=dict(feat_in=20, n_layers=2, d_model=32, n_heads=4,
                        subsampling_conv_channels=16),
           lfm=dict(vocab_size=256, hidden_size=64, num_hidden_layers=4,
                    num_attention_heads=4, num_key_value_heads=2,
                    block_ff_dim=96, block_multiple_of=16,
                    full_attn_idxs=[1, 3]),
           depthformer=dict(layers=2, dim=32, num_heads=4, num_kv_heads=2),
           adapter_hidden_dims=[48], max_decode_len=128)
DETOK = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2,
             layer_types=["conv", "sliding_attention", "conv",
                          "sliding_attention"],
             intermediate_size=48, output_size=2 * (64 // 2 + 1),
             num_codebooks=4, vocab_size=32, n_fft=64, hop_length=16,
             upsample_factor=2, sliding_window=8)
PROMPT = np.array([[2, 8, 5, 9]], np.int32)
GREEDY = dict(temperature=0.0, audio_temperature=0.0)


@pytest.fixture(scope="module")
def pair():
    import jax.numpy as jnp

    from mlx_audio_tpu.sts.models.lfm_audio import Model as JModel
    from mlx_audio_tpu.sts.models.lfm_audio import ModelConfig as JConfig
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.sts.models.lfm_audio import Model, ModelConfig

    jm = JModel(JConfig.from_dict(CFG))
    flat = flat_numpy(numpy_params(jm.init_params, 0))
    rs = np.random.RandomState(1)
    for k in [k for k in flat if k.endswith(".bias")]:
        flat[k] = (rs.randn(*flat[k].shape) * 0.1).astype(np.float32)
    for k in [k for k in flat if k.endswith("norm.running_mean")]:
        flat[k] = (rs.randn(*flat[k].shape) * 0.1).astype(np.float32)
        flat[k.replace("mean", "var")] = rs.uniform(
            0.5, 1.5, flat[k].shape).astype(np.float32)
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    pm = load_jax_params(Model(ModelConfig.from_dict(CFG), device="cpu"),
                         flat)
    return jm, pm, flat


@pytest.fixture(scope="module")
def detok_pair():
    import jax.numpy as jnp

    from mlx_audio_tpu.sts.models.lfm_audio import (DetokenizerConfig as JD,
                                                    LFM2AudioDetokenizer as JT)
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.sts.models.lfm_audio import LFM2AudioDetokenizer

    jd = JT(JD.from_dict(DETOK))
    flat = flat_numpy(numpy_params(jd.init_params, 2))
    flat["lin.bias"] = np.random.RandomState(3).randn(
        *flat["lin.bias"].shape).astype(np.float32) * 0.1
    jd.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    pd = load_jax_params(LFM2AudioDetokenizer(DETOK, device="cpu"), flat)
    return jd, pd, flat


def _tokens(gen):
    return [(np.asarray(t).tolist(), int(m)) for t, m in gen]


# ------------------------------------------------------- LFM2 backbone

def _jax_lfm(jm, emb, t_total, steps=0):
    """JAX's lfm2_forward (jitted): a prefill of the first rows, then
    `steps` one-row steps; -> (prefill hidden, [step hiddens], caches)."""
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.sts.models.lfm_audio.lfm2 import (lfm2_forward,
                                                          make_lfm2_caches)

    c = jm.config.lfm_config
    fwd = jax.jit(lambda p, e, cs, o, n: lfm2_forward(p, c, e, cs, o, n))
    step = jax.jit(lambda p, e, cs, o: lfm2_forward(p, c, e, cs, o))
    n = t_total - steps
    h, caches = fwd(jm.params["lfm"], jnp.asarray(emb[:, :n]),
                    make_lfm2_caches(c, 1, 16), jnp.int32(0), jnp.int32(n))
    outs = []
    for i in range(n, t_total):
        hs, caches = step(jm.params["lfm"], jnp.asarray(emb[:, i:i + 1]),
                          caches, jnp.int32(i))
        outs.append(np.asarray(hs))
    return np.asarray(h), outs, caches


def test_lfm2_prefill_and_steps_match_jax(pair):
    """A 6-row prefill equals JAX's within ATOL; a 3-row prefill then 3
    steps equals the 6-row prefill (the conv taps cache and the KV cache
    carry on), and JAX's own steps; the conv cache after the prefill holds
    JAX's last K - 1 gated inputs."""
    from mlx_audio_tpu_torch.sts.models.lfm_audio.lfm2 import (
        lfm2_forward, make_lfm2_caches)

    jm, pm, _ = pair
    emb = np.random.RandomState(0).randn(1, 6, 64).astype(np.float32)
    full_j, _, _ = _jax_lfm(jm, emb, 6)
    part_j, steps_j, caches_j = _jax_lfm(jm, emb, 6, steps=3)
    with torch.inference_mode():
        caches = make_lfm2_caches(pm.lfm, 1, 16)
        full = lfm2_forward(pm.lfm, torch.from_numpy(emb), caches, 0)
        caches = make_lfm2_caches(pm.lfm, 1, 16)
        part = lfm2_forward(pm.lfm, torch.from_numpy(emb[:, :3]), caches, 0)
        conv0 = caches.conv.clone()
        steps = [lfm2_forward(pm.lfm, torch.from_numpy(emb[:, i:i + 1]),
                              caches, i) for i in range(3, 6)]
    np.testing.assert_allclose(full.numpy(), full_j, atol=ATOL)
    np.testing.assert_allclose(part.numpy(), part_j, atol=ATOL)
    inc = torch.cat(steps, dim=1).numpy()
    np.testing.assert_allclose(inc, full.numpy()[:, 3:], atol=ATOL)
    np.testing.assert_allclose(inc, np.concatenate(steps_j, 1), atol=ATOL)
    # layers 0 and 2 are the conv layers; JAX's caches after 3 steps
    _, _, caches3 = _jax_lfm(jm, emb[:, :3], 3)
    for slot, layer in enumerate((0, 2)):
        np.testing.assert_allclose(conv0[slot].numpy(),
                                   np.asarray(caches3[layer]), atol=ATOL)
    np.testing.assert_allclose(caches.conv[0].numpy(),
                               np.asarray(caches_j[0]), atol=ATOL)


def test_lfm2_layer_types_and_tied_logits(pair):
    """The layer pattern from full_attn_idxs, and the tied head's f32
    logits against JAX's."""
    from mlx_audio_tpu.sts.models.lfm_audio.lfm2 import lfm2_logits as jl
    from mlx_audio_tpu_torch.sts.models.lfm_audio.lfm2 import lfm2_logits

    jm, pm, _ = pair
    assert pm.lfm.config.layer_types == ["conv", "full_attention", "conv",
                                         "full_attention"]
    assert (pm.lfm.n_attn, pm.lfm.n_conv) == (2, 2)
    h = np.random.RandomState(1).randn(1, 2, 64).astype(np.float32)
    np.testing.assert_allclose(
        lfm2_logits(pm.lfm, torch.from_numpy(h)).numpy(),
        np.asarray(jl(jm.params["lfm"], h)), atol=ATOL)


# ----------------------------------------------------------- audio side

def test_depthformer_frame_matches_jax(pair):
    """The greedy frame of 4 codebooks from two hidden rows, each codebook
    conditioned on the last through the depthformer's 4-slot cache (an
    eager loop here, a lax.scan in JAX): equal codes."""
    import jax
    import jax.numpy as jnp

    from mlx_audio_tpu.sts.models.lfm_audio.lfm_audio import (
        sample_audio_frame)

    jm, pm, _ = pair
    h = np.random.RandomState(2).randn(2, 1, 64).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: sample_audio_frame(
        p, jm.config, x, jax.random.PRNGKey(0), 0.0, 4))(jm.params,
                                                          jnp.asarray(h)))
    with torch.inference_mode():
        got = pm.sample_audio_frame(torch.from_numpy(h), 0.0, 4).numpy()
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got, want)


def test_encoder_and_audio_prefill_match_jax(pair):
    """The FastConformer and adapter on 40 mel frames (-> 5 rows), and a
    generation prefilled from text and audio placed by modality flags:
    equal greedy tokens."""
    import jax.numpy as jnp

    from mlx_audio_tpu_torch.sts.models.lfm_audio.processor import (
        _subsampled_frames)

    jm, pm, _ = pair
    mel = np.random.RandomState(0).randn(1, 40, 20).astype(np.float32)
    want = np.asarray(jm.encode_audio(jnp.asarray(mel)))
    got = pm.encode_audio(mel).numpy()
    assert got.shape == (1, _subsampled_frames(40), 64) == (1, 5, 64)
    np.testing.assert_allclose(got, want, atol=ATOL)
    mods = np.array([[1] * 3 + [2] * 5], np.int32)
    toks = np.array([[1, 5, 9]], np.int32)
    kw = dict(text_tokens=toks, audio_features=mel, modalities=mods,
              max_new_tokens=6, **GREEDY)
    assert _tokens(pm.generate_interleaved(**kw)) == \
        _tokens(jm.generate_interleaved(**kw))


# ------------------------------------------------------------ generation

@pytest.mark.parametrize("mode", ["interleaved", "sequential"])
def test_greedy_generation_equals_jax(pair, mode):
    """14 greedy tokens (interleaved: 2 text, then 3 frames of 4 codes, in
    turn): tokens, frames and modalities equal JAX's; no rollback."""
    jm, pm, _ = pair
    kw = dict(text_tokens=PROMPT, max_new_tokens=14, **GREEDY)
    got = _tokens(getattr(pm, f"generate_{mode}")(**kw))
    want = _tokens(getattr(jm, f"generate_{mode}")(**kw))
    assert got == want and len(got) == 14
    if mode == "interleaved":
        assert [m for _, m in got[:5]] == [1, 1, 3, 3, 3]
    assert pm.last_run["rollbacks"] == 0
    assert pm.last_run["steps"] == pm.last_run["kept"] == 14


def _special(monkeypatch, **ids):
    """Set special token ids in both packages' generate modules."""
    from mlx_audio_tpu.sts.models.lfm_audio import lfm_audio as jmod
    from mlx_audio_tpu_torch.sts.models.lfm_audio import lfm_audio as pmod

    for name, value in ids.items():
        monkeypatch.setattr(jmod, name, value)
        monkeypatch.setattr(pmod, name, value)


@pytest.mark.parametrize("event", ["text_end", "audio_eos", "im_end"])
def test_interleaved_events_roll_back_like_jax(pair, monkeypatch, event):
    """A token that changes the schedule mid-chunk: <|text_end|> (the text
    turn ends early, audio to the end), the audio EOS (fed back as a frame
    of EOS codes; text resumes) and <|im_end|> (the request stops). The
    port drops the chunk's later steps and restores the conv taps and the
    hidden row; its tokens equal JAX's."""
    jm, pm, _ = pair
    kw = dict(text_tokens=PROMPT, max_new_tokens=24, **GREEDY)
    base = _tokens(jm.generate_interleaved(**kw))
    texts = [t[0] for t, m in base if m == 1]
    frames = [t for t, m in base if m == 3]
    ids = {"text_end": dict(TEXT_END_TOKEN=texts[2]),
           "audio_eos": dict(AUDIO_EOS_TOKEN=frames[4][0]),
           "im_end": dict(IM_END_TOKEN=texts[3])}[event]
    _special(monkeypatch, **ids)
    want = _tokens(jm.generate_interleaved(**kw))
    got = _tokens(pm.generate_interleaved(**kw))
    assert got == want and want != base
    if event != "im_end":
        assert pm.last_run["rollbacks"] >= 1


def test_sequential_audio_start_and_eos_like_jax(pair, monkeypatch):
    """Sequential mode switching on a drawn <|audio_start|> (not yielded,
    fed back) and back on an audio EOS; a prompt ending in
    <|audio_start|> starts with audio."""
    jm, pm, _ = pair
    kw = dict(text_tokens=PROMPT, max_new_tokens=16, **GREEDY)
    base = _tokens(jm.generate_sequential(**kw))
    _special(monkeypatch, AUDIO_START_TOKEN=base[1][0][0])
    mid = _tokens(jm.generate_sequential(**kw))
    frames = [t for t, m in mid if m == 3]
    _special(monkeypatch, AUDIO_EOS_TOKEN=frames[2][0])
    for prompt in (PROMPT, np.concatenate(
            [PROMPT, [[base[1][0][0]]]], axis=1).astype(np.int32)):
        kw["text_tokens"] = prompt
        want = _tokens(jm.generate_sequential(**kw))
        assert _tokens(pm.generate_sequential(**kw)) == want
        assert {m for _, m in want} == {1, 3}


# ------------------------------------------------------------ detokenizer

def test_detokenizer_waveform_matches_jax(detok_pair):
    """10 frames of 4 codebooks -> 10 * 2 * 16 samples: the embedding
    mean, the 2x upsample, the conv and sliding-window blocks, the
    log-magnitude/phase head and the COLA ISTFT, within ATOL of JAX's;
    (K, T) codes taken as one row."""
    jd, pd, _ = detok_pair
    codes = np.random.RandomState(1).randint(0, 32, (2, 4, 10))
    want = np.asarray(jd(codes))
    got = pd(codes)
    assert got.shape == want.shape == (2, 10 * 2 * 16)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(pd(codes[0]), want[:1], atol=ATOL)


def _detok_release(flat):
    """The detokenizer's tree as the release names it: `emb.emb.`,
    `lfm.layers.`, `o_proj`, torch depthwise taps (D, 1, K)."""
    out = {"lfm.embed_tokens.weight": np.zeros((4, 32), np.float32)}
    for k, v in flat.items():
        if k.endswith("conv.weight"):
            k, v = k.replace("conv.weight", "conv.conv.weight"), v.T[:, None]
        k = k.replace("self_attn.out_proj", "self_attn.o_proj")
        k = "lfm." + k if k.startswith(("layers.", "embedding_norm.")) else k
        out[k.replace("emb.weight", "emb.emb.weight")] = v
    return out


def test_detokenizer_sanitize_and_load_from_files(detok_pair, tmp_path):
    """The release's names sanitize to the JAX tree in both packages; an
    MLX (D, K, 1) tap, which JAX reads as torch's (D, 1, K), is read from
    its shape here (JAX's gives (1, 32)). A processor over a directory with
    `audio_detokenizer/{config.json, model.safetensors}` loads it and
    decodes JAX's waveform (codes clipped to the vocabulary)."""
    from safetensors.numpy import save_file

    from mlx_audio_tpu_torch.sts.models.lfm_audio import (LFM2AudioConfig,
                                                          LFM2AudioProcessor)

    jd, pd, flat = detok_pair
    rel = _detok_release(flat)
    got = pd.sanitize(rel)
    want = {k: np.asarray(v) for k, v in jd.sanitize(rel).items()}
    assert set(got) == set(want) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    key = "lfm.layers.0.conv.conv.weight"
    mlx = {key: np.transpose(rel[key], (0, 2, 1))}
    np.testing.assert_array_equal(pd.sanitize(mlx)["layers.0.conv.weight"],
                                  flat["layers.0.conv.weight"])
    assert np.asarray(jd.sanitize(mlx)["layers.0.conv.weight"]).shape \
        == (1, 32)
    sub = tmp_path / "audio_detokenizer"
    sub.mkdir()
    (sub / "config.json").write_text(json.dumps(DETOK))
    save_file({k: np.ascontiguousarray(v) for k, v in rel.items()},
              str(sub / "model.safetensors"))
    proc = LFM2AudioProcessor(LFM2AudioConfig.from_dict(CFG), device="cpu")
    proc.model_path = tmp_path
    codes = np.random.RandomState(4).randint(0, 40, (1, 4, 6))
    np.testing.assert_allclose(proc.decode_audio(codes),
                               np.asarray(jd(np.clip(codes, 0, 31))),
                               atol=ATOL)


# -------------------------------------------------------------- processor

class _StubTokenizer:
    bos_token_id = 1

    def encode(self, text, add_special_tokens=False):
        return [10 + (ord(ch) % 50) for ch in text][:8]

    def decode(self, tokens):
        return " ".join(str(t) for t in tokens)


PRE = dict(sample_rate=8000, features=20, n_fft=128, window_size=0.016,
           window_stride=0.008)


def test_preprocessor_and_chat_state_match_jax():
    """The mel front end (pre-emphasis, Hann STFT, slaney mels, log guard,
    normalisation over the audio's frames) within ATOL of JAX's; a chat
    state's tokens, features and modality flags equal JAX's."""
    from mlx_audio_tpu.sts.models.lfm_audio import processor as jp
    from mlx_audio_tpu.sts.models.lfm_audio import LFM2AudioConfig as JC
    from mlx_audio_tpu_torch.sts.models.lfm_audio import processor as pp
    from mlx_audio_tpu_torch.sts.models.lfm_audio import LFM2AudioConfig

    audio = np.random.RandomState(0).randn(1600).astype(np.float32)
    want = np.asarray(jp.AudioPreprocessor(jp.PreprocessorConfig(**PRE))(
        audio))
    got = pp.AudioPreprocessor(pp.PreprocessorConfig(**PRE),
                               device="cpu")(audio).numpy()
    assert got.shape == want.shape and got.shape[-1] == 20
    np.testing.assert_allclose(got, want, atol=ATOL)
    chats = []
    for mod, cfg in ((jp, JC.from_dict(dict(CFG, preprocessor=PRE))),
                     (pp, LFM2AudioConfig.from_dict(dict(CFG,
                                                         preprocessor=PRE)))):
        kw = {} if mod is jp else {"device": "cpu"}
        proc = mod.LFM2AudioProcessor(cfg, tokenizer=_StubTokenizer(), **kw)
        proc.audio_preprocessor = mod.AudioPreprocessor(
            mod.PreprocessorConfig(**PRE), **kw)
        chat = mod.ChatState(proc)
        chat.new_turn("user")
        chat.add_text("hi")
        chat.add_audio(audio, sample_rate=8000)
        chat.end_turn()
        chat.new_turn("assistant")
        chats.append(chat)
    jc, pc = chats
    assert np.array_equal(pc.get_text_tokens(), jc.get_text_tokens())
    assert np.array_equal(pc.get_modalities(), jc.get_modalities())
    np.testing.assert_allclose(pc.get_audio_features(),
                               jc.get_audio_features(), atol=ATOL)
    assert pc.get_text_tokens()[0, 0] == 1
    assert pp._subsampled_frames(40) == 5 and pp._subsampled_frames(41) == 6


def test_generate_from_chat_equals_jax(pair):
    """`generate_from_chat_state` over a chat state (the stand-in
    tokenizer, a user turn of text): the tokens and frames equal JAX's."""
    from mlx_audio_tpu.sts.models.lfm_audio import processor as jp
    from mlx_audio_tpu_torch.sts.models.lfm_audio import processor as pp

    jm, pm, _ = pair
    outs = []
    for m, mod in ((jm, jp), (pm, pp)):
        m._processor = mod.LFM2AudioProcessor(
            m.config, tokenizer=_StubTokenizer(),
            **({} if mod is jp else {"device": "cpu"}))
        chat = mod.ChatState(m._processor)
        chat.new_turn("user")
        chat.add_text("hello")
        chat.end_turn()
        chat.new_turn("assistant")
        outs.append(_tokens(m.generate_from_chat_state(
            chat, max_new_tokens=10, **GREEDY)))
    assert outs[0] == outs[1]


# ----------------------------------------------------------- quantization

def _release(flat):
    """The JAX tree under the release's names (conformer., torch conv
    layouts, the adapter's Sequential, linear1/2/3, fused depthformer qkv,
    per-codebook depth tables)."""
    out = {}
    sub = {"layers.00_conv.": "conv.0.", "layers.01_dw.": "conv.2.",
           "layers.02_pw.": "conv.3.", "layers.03_dw.": "conv.5.",
           "layers.04_pw.": "conv.6."}
    qkv = {}
    for k, v in flat.items():
        if k.startswith("audio_encoder."):
            k = k.replace("audio_encoder.", "conformer.")
            for new, old in sub.items():
                k = k.replace("pre_encode." + new, "pre_encode." + old)
            if np.ndim(v) == 4:
                v = np.transpose(v, (3, 2, 0, 1))
            elif np.ndim(v) == 3:
                v = np.transpose(v, (2, 1, 0))
        elif k.startswith("audio_adapter."):
            name, leaf = k.split(".")[1:]
            idx = 0 if name == "norm" else 1 + 2 * (int(name[2:]) - 1)
            k = f"audio_adapter.model.{idx}.{leaf}"
        elif k.startswith("lfm."):
            for i in "123":
                k = k.replace(f".feed_forward.w{i}.",
                              f".feed_forward.linear{i}.")
            if k.endswith(".conv.weight"):
                k, v = k.replace("conv.weight", "conv.conv.weight"), \
                    v.T[:, None]
        elif k.startswith("depth_embeddings."):
            name = k.split(".")[1]
            for i in range(v.shape[0]):
                out[f"depth_embeddings.{i}.{name}.weight"] = v[i]
            continue
        elif k.startswith("audio_head.blocks."):
            parts = k.split(".")
            li, rest = parts[2], ".".join(parts[3:])
            base = f"depthformer.layers.{li}."
            if rest in ("attn.q_proj.weight", "attn.k_proj.weight",
                        "attn.v_proj.weight"):
                qkv.setdefault(li, {})[rest.split(".")[1]] = v
                continue
            rest = {"attn.o_proj.weight": "operator.out_proj.weight",
                    "attn.q_norm.weight":
                        "operator.bounded_attention.q_layernorm.weight",
                    "attn.k_norm.weight":
                        "operator.bounded_attention.k_layernorm.weight"
                    }.get(rest, rest)
            rest = rest.replace("attn_norm.", "operator_norm.").replace(
                "ffn.", "feed_forward.")
            k = base + rest
        out[k] = v
    for li, parts in qkv.items():
        out[f"depthformer.layers.{li}.operator.qkv_proj.weight"] = \
            np.concatenate([parts["q_proj"], parts["k_proj"],
                            parts["v_proj"]])
    return out


def test_sanitize_release_names_equal_jax(pair):
    """The release's names and torch layouts sanitize to the JAX tree in
    both packages, leaf for leaf; the Mimi's leaves, which the loader reads
    with the model's files, are left out here (JAX keeps them)."""
    jm, pm, flat = pair
    rel = _release(flat)
    rel["encoder.model.0.conv.weight"] = np.zeros((4, 1, 7), np.float32)
    got = pm.sanitize(rel)
    want = {k: np.asarray(v) for k, v in jm.sanitize(rel).items()}
    assert "encoder.model.0.conv.weight" in want
    want.pop("encoder.model.0.conv.weight")
    assert set(got) == set(want) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _write_dir(path, flat, extra=None):
    from safetensors.numpy import save_file

    path.mkdir()
    (path / "config.json").write_text(json.dumps(
        {"model_type": "lfm_audio", **CFG, **(extra or {})}))
    rel = _release(flat)
    save_file({k: np.ascontiguousarray(v) for k, v in rel.items()},
              str(path / "model.safetensors"))
    return path


def test_q8_directory_quantizes_every_linear_and_matches(pair, tmp_path):
    """A directory whose config asks for 8-bit affine at group 16: every
    `Linear` the quantizer passes (each input width a multiple of 16)
    becomes a QuantizedLinear on K2's plain version, the short convs' taps
    stay dense. A departure from a JAX fault: JAX's quantizer also takes
    each short conv for a linear (its `weight` (3, 64) is 2-D), quantizes
    the taps, leaves that conv's in_proj and out_proj dense, and its
    forward then fails. The port's q8 greedy tokens equal JAX's dense run
    with the same linears quantized and dequantized."""
    import jax
    import jax.numpy as jnp

    import mlx_audio_tpu_torch
    from mlx_audio_tpu.ops.quant import (dequantize_weight,
                                         maybe_quantize_tree,
                                         quantize_weight)
    from mlx_audio_tpu.utils import flatten, unflatten
    from mlx_audio_tpu_torch.nn import Linear, QuantizedLinear

    jm, _, flat = pair
    q = {"quantization": {"bits": 8, "group_size": 16}}
    pm = mlx_audio_tpu_torch.load_model(_write_dir(tmp_path / "q8", flat, q),
                                        device="cpu")
    quantized = {n for n, m in pm.named_modules()
                 if isinstance(m, QuantizedLinear)}
    dense = {n for n, m in pm.named_modules() if isinstance(m, Linear)}
    assert not dense and len(quantized) > 40
    jq = jax.jit(lambda p: maybe_quantize_tree(p, 16, 8))(jm.params)
    jflat = flatten(jq)
    jax_q = {k[:-len(".w_q")] for k in jflat if k.endswith(".w_q")}
    convs = {f"lfm.layers.{i}.conv" for i in (0, 2)}
    assert jax_q - quantized == convs
    assert quantized - jax_q == {f"{c}.{p}" for c in convs
                                 for p in ("in_proj", "out_proj")}
    saved = jm.params
    try:
        jm.params = jq
        with pytest.raises(KeyError, match="weight"):
            list(jm.generate_interleaved(text_tokens=PROMPT,
                                         max_new_tokens=2, **GREEDY))
        deq = dict(flat)
        rt = jax.jit(lambda w: dequantize_weight(quantize_weight(w, 16, 8)))
        for name in quantized:
            deq[f"{name}.weight"] = np.asarray(rt(flat[f"{name}.weight"]))
        jm.params = unflatten({k: jnp.asarray(v) for k, v in deq.items()})
        kw = dict(text_tokens=PROMPT, max_new_tokens=8, **GREEDY)
        want = _tokens(jm.generate_interleaved(**kw))
    finally:
        jm.params = saved
    assert _tokens(pm.generate_interleaved(**kw)) == want


# ------------------------------------------------------------------ hooks

def test_post_load_hook_raises_where_jax_swallows(pair, tmp_path,
                                                  monkeypatch):
    """A departure from a JAX fault: a processor that fails to load. JAX's
    hook swallows the error and returns a model with no processor; the
    port's raises it. Loaded cleanly, the model has its processor (no
    tokenizer files: tokenizer None, asking for it raises)."""
    from mlx_audio_tpu.sts.models.lfm_audio import Model as JModel
    from mlx_audio_tpu.sts.models.lfm_audio import processor as jp
    from mlx_audio_tpu_torch.sts.models.lfm_audio import processor as pp
    from mlx_audio_tpu_torch.sts.utils import load_model

    jm, _, flat = pair
    d = _write_dir(tmp_path / "m", flat)
    m = load_model(d, device="cpu")
    assert m._processor is not None and m._processor._tokenizer is None
    with pytest.raises(ValueError, match="no text tokenizer"):
        m.processor.tokenizer

    def broken(*a, **k):
        raise OSError("unreadable processor files")

    monkeypatch.setattr(jp.LFM2AudioProcessor, "from_pretrained", broken)
    monkeypatch.setattr(pp.LFM2AudioProcessor, "from_pretrained", broken)
    jm._processor = None
    assert JModel.post_load_hook(jm, d) is jm and jm._processor is None
    with pytest.raises(OSError, match="unreadable"):
        load_model(d, device="cpu")


def test_mimi_and_detokenizer_are_never_random(pair, tmp_path, monkeypatch):
    """A departure from a JAX fault: with no `tokenizer-*.safetensors`
    JAX's `mimi` binds random weights (here at a tiny Mimi config, to keep
    it quick), as its `detokenizer` does without
    `audio_detokenizer/model.safetensors`; the port's raise and name the
    missing file."""
    from mlx_audio_tpu.codec.models.mimi import mimi as jax_mimi
    from mlx_audio_tpu.sts.models.lfm_audio import processor as jp
    from mlx_audio_tpu_torch.sts.models.lfm_audio import processor as pp
    from test_torch_mimi import MIMI_CFG

    from mlx_audio_tpu.codec.models.mimi import MimiConfig

    jm, pm, _ = pair
    monkeypatch.setattr(jax_mimi, "mimi_202407",
                        lambda num_codebooks=16: MimiConfig(**MIMI_CFG))
    jproc = jp.LFM2AudioProcessor(jm.config)
    jproc.model_path = tmp_path
    assert jproc.mimi.params          # random, without a word
    proc = pp.LFM2AudioProcessor(pm.config, device="cpu")
    proc.model_path = tmp_path
    with pytest.raises(FileNotFoundError, match=r"tokenizer-\*.safetensors"):
        proc.mimi
    with pytest.raises(FileNotFoundError,
                       match="audio_detokenizer/model.safetensors"):
        proc.detokenizer


def test_defaults_to_the_card():
    """The default device is the card: without CUDA it raises before any
    parameter is built."""
    from mlx_audio_tpu_torch.sts.models.lfm_audio import Model

    if torch.cuda.is_available():
        assert Model(CFG).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(CFG)
