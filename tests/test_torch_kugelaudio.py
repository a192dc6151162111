"""KugelAudio in the PyTorch port against the JAX package, on the CPU at
float32: the constrained 4-token pick over dense, W8A8 and affine heads,
the CFG prefill, the SDE-DPM-Solver++ sampler, `generate` (sampled at
cfg_scale 3.0 and unguided at 1.0), the LAT_MAX clamp, the prompt limit,
quantization, `sanitize`, `load_model` and `post_load_hook`.

Config: tests/test_kugelaudio.py::tiny_cfg (a 2-layer Qwen2 at d32 with the
real 151,700-token vocabulary, a 2-layer head, a VAE of hop 4), the JAX
model's random parameters bound into the port by `model.load_jax_params`.
The head's 4 speech rows are set from a seeded draw (HEAD_SEED) so that a
request runs diffusion frames, re-emitted SPEECH_STARTs, an END and the
final latent its margin admits.
Sampled runs feed the port JAX's own draws through `Model._draws`: JAX
splits its key once per emitted latent and once per SDE step
(kugelaudio.py:447-478), and the replay does the same.

Tolerances: 2e-4 absolute on logits, hidden states, caches and latents
(summation order only); audio 2e-3 absolute (JAX's own bound between its
two paths, tests/test_kugelaudio.py:235-236). Frame and sample counts must
be equal.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_kugelaudio import CharTok, tiny_cfg  # noqa: E402
from torch_tts_fixtures import kugel_hf_state  # noqa: E402

ATOL = 2e-4
AUDIO_ATOL = 2e-3
STEPS = 4
# the seed of the head's 4 speech rows: with JAX's draws at seed 7 the
# request at cfg_scale 3.0 runs 10 frames (6 diffusion, 3 re-emitted
# SPEECH_STARTs, on which the positive row alone advances, and an END whose
# margin admits a 7th latent), at 1.0 4 frames and 3 latents
HEAD_SEED = 35


def _np(t):
    return t.detach().float().cpu().numpy()


_JAX = {}


def _jax_model(head_seed=None):
    """(JAX model, flat numpy params) for the tiny config, the head's 4
    speech rows drawn from head_seed (None: the init's)."""
    if head_seed not in _JAX:
        from mlx_audio_tpu.tts.models.kugelaudio import Model
        from mlx_audio_tpu.utils import flatten

        jm = Model(tiny_cfg()).init_and_bind()
        jm.tokenizer = CharTok()
        if head_seed is not None:
            w = np.array(jm.params["lm_head"]["weight"])
            w[_ids()] = np.random.RandomState(head_seed).randn(4, 32)
            jm.params["lm_head"]["weight"] = jnp.asarray(w)
        _JAX[head_seed] = (jm, {k: np.asarray(v)
                                for k, v in flatten(jm.params).items()})
    return _JAX[head_seed]


def _ids():
    from mlx_audio_tpu.tts.models.kugelaudio.kugelaudio import \
        VALID_SPEECH_TOKENS

    return list(VALID_SPEECH_TOKENS)


def _port(head_seed=None, flat=None):
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.tts.models.kugelaudio import Model

    jm, jflat = _jax_model(head_seed)
    pm = load_jax_params(Model(dataclasses.asdict(jm.config), device="cpu"),
                         jflat if flat is None else flat)
    pm.tokenizer = CharTok()
    return pm


_DRAWS = {}


def _jax_draws(seed: int, n: int, steps: int, latent: int) -> np.ndarray:
    """The draws of JAX's first n emitted latents at `seed`: per latent one
    key split for the start noise and one per SDE step, each a (1, latent)
    normal. -> (n, 1 + steps, latent)."""
    key_ = (seed, steps, latent)
    have = _DRAWS.get(key_, np.zeros((0, 1 + steps, latent), np.float32))
    if len(have) < n:
        key = jax.random.PRNGKey(seed)
        out = []
        for _ in range(n):
            per = []
            for _ in range(1 + steps):
                key, sub = jax.random.split(key)
                per.append(np.asarray(jax.random.normal(
                    sub, (1, latent), jnp.float32))[0])
            out.append(np.stack(per))
        have = _DRAWS[key_] = np.stack(out)
    return have[:n]


def _feed_jax_draws(pm):
    """Make the port draw JAX's noise, keyed by its generator's seed; draws
    past the request's latents are zeros (never kept)."""

    def draws(generator, start, n, shape):
        table = _jax_draws(generator.initial_seed(), start + n,
                           shape[0] - 1, shape[1])
        return torch.from_numpy(table[start:start + n])

    pm._draws = draws
    return pm


# ---------------------------------------------------------------------------
# config and pieces
# ---------------------------------------------------------------------------


def test_config_alias_and_semantic_drop():
    from mlx_audio_tpu_torch.tts.models.kugelaudio import ModelConfig

    cfg = ModelConfig.from_dict(dict(acostic_vae_dim=32,
                                     semantic_tokenizer_config={"x": 1},
                                     decoder_config={"hidden_size": 64}))
    assert cfg.acoustic_vae_dim == 32
    assert cfg.decoder_config.hidden_size == 64


def _head_variant(kind: str):
    """Flat JAX params whose lm_head is dense, W8A8 or affine 8-bit, with a
    bias on every variant; and the matching port."""
    from mlx_audio_tpu.ops.quant import quantize_weight, to_i8_layout
    from mlx_audio_tpu_torch.nn import Int8Linear, QuantizedLinear

    jm, flat = _jax_model(HEAD_SEED)
    flat = dict(flat)
    bias = np.random.RandomState(5).randn(flat["lm_head.weight"].shape[0])
    bias = bias.astype(np.float32)
    if kind != "dense":
        q = quantize_weight(jnp.asarray(flat.pop("lm_head.weight")),
                            group_size=16, bits=8)
        if kind == "w8a8":
            q = to_i8_layout(q)
        flat.update({f"lm_head.{k}": np.asarray(v) for k, v in q.items()})
    jp = {k: jnp.asarray(v) for k, v in flat.items()}
    jp["lm_head.bias"] = jnp.asarray(bias)
    pm = _port(HEAD_SEED, flat)
    want_cls = {"w8a8": Int8Linear, "affine": QuantizedLinear}.get(kind)
    if want_cls is not None:
        assert isinstance(pm.lm_head, want_cls)
        pm.lm_head.bias = torch.from_numpy(bias)
    else:
        pm.lm_head.bias = torch.nn.Parameter(torch.from_numpy(bias))
    return jm, jp, pm


@pytest.mark.parametrize("kind", ["dense", "w8a8", "affine"])
@pytest.mark.parametrize("scaling", [1.0, 2.5])
def test_pick4_logits_match_jax(kind, scaling):
    from mlx_audio_tpu.utils import unflatten

    jm, jp, pm = _head_variant(kind)
    jcfg = dataclasses.replace(jm.config)
    jcfg.decoder_config = dataclasses.replace(jm.config.decoder_config,
                                              logits_scaling=scaling)
    pm.config.decoder_config.logits_scaling = scaling
    from mlx_audio_tpu.tts.models.kugelaudio import Model

    jx = Model(jcfg)
    h = np.random.RandomState(6).randn(32).astype(np.float32)
    want = jx._pick4_logits(unflatten(jp), jnp.asarray(h))
    got = pm._pick4_logits(torch.from_numpy(h))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    if kind == "dense":
        # the full-vocabulary logits agree with JAX's and with the pick
        full = pm._logits(torch.from_numpy(h)[None])[0]
        jfull = jx._logits(unflatten(jp), jnp.asarray(h)[None])[0]
        np.testing.assert_allclose(_np(full), np.asarray(jfull), atol=ATOL)
        np.testing.assert_allclose(_np(full[_ids()]), _np(got), atol=ATOL)


@pytest.mark.parametrize("use_cfg", [True, False])
def test_cfg_prefill_matches_jax(use_cfg):
    """Both CFG rows over the prompt bucket: row 0's hidden at plen - 1 and
    its cache over [0, plen), row 1's hidden and its cache at column 0 (the
    only column its mask admits) equal JAX's."""
    jm, _ = _jax_model()
    pm = _port()
    prompt = pm._build_prompt_tokens("parity check")
    plen, pb, cache_len = len(prompt), 256, 512
    rows = 2 if use_cfg else 1
    ids = np.zeros((rows, pb), np.int32)
    ids[0, :plen] = prompt
    if use_cfg:
        ids[1, 0] = prompt[-1]
    caches, want = jm._prefill2_fn(pb, use_cfg, cache_len)(
        jm.params, jnp.asarray(ids), jnp.int32(plen))
    carry = pm.prefill(torch.from_numpy(ids.astype(np.int64)), plen,
                       cache_len)
    np.testing.assert_allclose(_np(carry.hidden), np.asarray(want),
                               atol=ATOL)
    for i, c in enumerate(caches):
        for got, ref in ((carry.caches.k[i], c.k), (carry.caches.v[i], c.v)):
            np.testing.assert_allclose(_np(got[0, :plen]),
                                       np.asarray(ref[0, :plen]), atol=ATOL)
            if use_cfg:
                np.testing.assert_allclose(_np(got[1, :1]),
                                           np.asarray(ref[1, :1]), atol=ATOL)
    assert carry.offset == plen and int(carry.neg_pos) == 1
    assert carry.neg_mask.nonzero().flatten().tolist() == [0]


@pytest.mark.parametrize("cfg_scale", [3.0, 1.0])
def test_sde_sample_matches_jax(cfg_scale):
    """One latent from JAX's key: its start noise and step noises replayed
    into the port's sampler."""
    from mlx_audio_tpu_torch.tts.models.vibevoice.scheduler import \
        sde_dpm_tables

    jm, _ = _jax_model()
    pm = _port()
    rs = np.random.RandomState(7)
    cond, neg = (rs.randn(1, 32).astype(np.float32) for _ in range(2))
    want, _ = jm._sde_fn(STEPS, cfg_scale)(
        jm.params, jnp.asarray(cond), jnp.asarray(neg),
        jax.random.PRNGKey(11))
    draws = torch.from_numpy(_jax_draws(11, 1, STEPS, 8)[0])
    tables = sde_dpm_tables(1000, STEPS)
    temb = pm.prediction_head.t_embed(torch.from_numpy(tables["t"]))
    got = pm.sde_sample(torch.from_numpy(cond), torch.from_numpy(neg), draws,
                        tables, temb, cfg_scale)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_scale,chunk", [(3.0, 3), (3.0, 32), (1.0, 5)])
def test_sampled_generate_matches_jax(monkeypatch, cfg_scale, chunk):
    """A request fed JAX's draws: the frame count, the latents' samples and
    the audio equal JAX's. Chunks of 3 and 5 frames cross chunk
    boundaries and run frames past the END, which change nothing kept."""
    from mlx_audio_tpu_torch.tts.models.kugelaudio import kugelaudio

    monkeypatch.setattr(kugelaudio, "CHUNK_FRAMES", chunk)
    jm, _ = _jax_model(HEAD_SEED)
    pm = _feed_jax_draws(_port(HEAD_SEED))
    picks = []
    pick = pm._pick4_logits
    pm._pick4_logits = lambda h: picks.append(h) or pick(h)
    kw = dict(cfg_scale=cfg_scale, max_tokens=12, ddpm_steps=STEPS, seed=7)
    want = next(jm.generate("parity check", **kw))
    got = next(pm.generate("parity check", **kw))
    assert got.token_count == want.token_count
    assert got.samples == want.samples
    np.testing.assert_allclose(got.audio, np.asarray(want.audio),
                               atol=AUDIO_ATOL, rtol=0)
    run = pm.last_run
    frames = got.token_count - run["prompt_len"]
    # the request ends on END/EOS before the budget, after >= 2 latents
    # and at least one frame that emits nothing
    assert run["frames"] == frames < 12 and 2 <= run["latents"] < frames
    assert run["chunks"] == -(-frames // chunk)
    assert len(picks) == run["frames_run"] == min(chunk * run["chunks"], 12)
    assert (frames, run["latents"]) == ((10, 7) if cfg_scale > 1 else (4, 3))


def test_max_tokens_beyond_latent_capacity_warns_and_ends(monkeypatch):
    """A budget over LAT_MAX is clamped with a warning; with every frame
    forced to diffusion the request ends at LAT_MAX latents."""
    from mlx_audio_tpu_torch.tts.models.kugelaudio import kugelaudio

    monkeypatch.setattr(kugelaudio, "LAT_MAX", 4)
    pm = _port()
    bias = torch.zeros(pm.lm_head.weight.shape[0])
    bias[kugelaudio.SPEECH_DIFFUSION_ID] = 1e4
    pm.lm_head.bias = torch.nn.Parameter(bias)
    with pytest.warns(UserWarning, match="clamping"):
        res = next(pm.generate("hello there", max_tokens=10, cfg_scale=1.0,
                               ddpm_steps=STEPS))
    assert res.samples == 4 * 4
    assert pm.last_run["frames"] == 4 and pm.last_run["latents"] == 4


def test_overlong_prompt_raises_before_prefill(monkeypatch):
    """Over 1,024 prompt tokens: ValueError naming the limit, with no
    prefill run (JAX fails later in a numpy broadcast)."""
    pm = _port()
    monkeypatch.setattr(pm, "prefill", lambda *a: pytest.fail("prefilled"))
    with pytest.raises(ValueError, match="1024"):
        next(pm.generate("x" * 1000, max_tokens=4))
    with pytest.raises(ValueError, match="non-empty"):
        next(pm.generate("  "))


def test_rtf_convention_and_no_latent_request():
    """A request whose first frame ends emits no latent: empty audio, the
    prompt and one frame counted (JAX's convention: elapsed / audio)."""
    from mlx_audio_tpu_torch.tts.models.kugelaudio import kugelaudio

    jm, _ = _jax_model()
    pm = _port()
    bias = torch.zeros(pm.lm_head.weight.shape[0])
    bias[kugelaudio.EOS_TOKEN_ID] = 1e4
    pm.lm_head.bias = torch.nn.Parameter(bias)
    res = next(pm.generate("hi", max_tokens=8, cfg_scale=3.0,
                           ddpm_steps=STEPS))
    assert res.samples == 0 and pm.last_run["frames"] == 1
    assert res.token_count == len(pm._build_prompt_tokens("hi")) + 1
    pm.lm_head.bias = None
    forced = _port()
    fb = torch.zeros(forced.lm_head.weight.shape[0])
    fb[kugelaudio.SPEECH_DIFFUSION_ID] = 1e4
    forced.lm_head.bias = torch.nn.Parameter(fb)
    r = next(forced.generate("hi", max_tokens=3, cfg_scale=1.0,
                             ddpm_steps=STEPS))
    dur = r.samples / r.sample_rate
    assert r.samples == 12
    assert r.real_time_factor == round(r.processing_time_seconds / dur, 2)


# ---------------------------------------------------------------------------
# quantization and loading
# ---------------------------------------------------------------------------


def test_quant_predicate_and_apply_quantization_match_jax():
    """Only the LM is quantized (affine 8-bit here, W8A8 with the opt-in):
    the codes equal the JAX package's apply_quantization; lm_head, the
    head, the connector and the VAE stay dense."""
    from mlx_audio_tpu.utils import apply_quantization as japply
    from mlx_audio_tpu.utils import flatten
    from mlx_audio_tpu_torch.nn import Int8Linear, Linear, QuantizedLinear
    from mlx_audio_tpu_torch.utils import apply_quantization

    jm, _ = _jax_model()
    for path, want in (("language_model.model.layers.0.mlp.up_proj", True),
                       ("lm_head", False), ("prediction_head.cond_proj",
                                            False)):
        assert _port().model_quant_predicate(path, None) is want
        assert jm.model_quant_predicate(path, None) is want
    conf = {"quantization": {"bits": 8, "group_size": 16}}
    pm = apply_quantization(_port(), conf, _port().model_quant_predicate)
    jp = flatten(japply(jm.params, conf,
                        model_quant_predicate=jm.model_quant_predicate))
    qs = [n for n, m in pm.named_modules() if isinstance(m, QuantizedLinear)]
    assert len(qs) == 2 * 7
    state = pm.state_dict()
    for n in qs:
        np.testing.assert_array_equal(state[n + ".w_q"].numpy(),
                                      np.asarray(jp[n + ".w_q"]))
    for dense in (pm.lm_head, pm.prediction_head.cond_proj,
                  pm.acoustic_connector.fc1):
        assert isinstance(dense, Linear)
    conf["quantization"]["mxu_int8"] = True
    i8 = apply_quantization(_port(), conf, _port().model_quant_predicate)
    assert sum(isinstance(m, Int8Linear) for m in i8.modules()) == 14


def test_sanitize_keeps_torch_conv_layouts():
    """The port binds a torch-layout checkpoint as it is; JAX's sanitize
    renames the LM the same way but leaves the conv kernels in torch's
    (O, I/g, K), which its WIO convs do not take."""
    jm, _ = _jax_model()
    pm = _port()
    ckpt = kugel_hf_state(pm)
    conv = "acoustic_tokenizer.decoder.stages.0.0.mixer.conv.conv.conv.weight"
    jsan = jm.sanitize({k: jnp.asarray(v) for k, v in ckpt.items()})
    psan = pm.sanitize(ckpt)
    assert set(jsan) == set(psan)
    assert jsan[conv].shape == psan[conv].shape == (16, 1, 7)
    assert jm.params["acoustic_tokenizer"]["decoder"]["stages"]["0"]["0"][
        "mixer"]["conv"]["conv"]["conv"]["weight"].shape == (7, 1, 16)
    from mlx_audio_tpu_torch.tts.models.kugelaudio import Model

    fresh = Model(dataclasses.asdict(jm.config), device="cpu").bind(psan)
    for k, v in pm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


@pytest.mark.parametrize("model_type,quant", [("kugelaudio", None),
                                              ("kugel", "w8a8")])
def test_load_model_round_trip(tmp_path, model_type, quant):
    """load_model on a torch-layout checkpoint (npz, config.json with the
    `acostic_vae_dim` alias) gives the in-process model's request; with the
    W8A8 quantization entry the LM's linears are Int8Linear."""
    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.nn import Int8Linear
    from mlx_audio_tpu_torch.utils import apply_quantization

    jm, _ = _jax_model(HEAD_SEED)
    pm = _port(HEAD_SEED)
    np.savez(tmp_path / "model.npz", **kugel_hf_state(pm))
    cfg = dataclasses.asdict(jm.config)
    cfg.pop("model_path")
    cfg["model_type"] = model_type
    cfg["acostic_vae_dim"] = cfg.pop("acoustic_vae_dim")
    if quant:
        cfg["quantization"] = {"bits": 8, "group_size": 16, "mxu_int8": True}
        apply_quantization(pm, cfg, pm.model_quant_predicate)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    loaded = load_model(tmp_path, device="cpu")
    assert loaded.tokenizer is None
    assert isinstance(loaded.language_model.model.layers[0].mlp.up_proj,
                      Int8Linear) == bool(quant)
    loaded.tokenizer = CharTok()
    kw = dict(cfg_scale=3.0, max_tokens=6, ddpm_steps=STEPS, seed=1)
    want = next(pm.generate("hello", **kw))
    got = next(loaded.generate("hello", **kw))
    assert got.samples == want.samples > 0
    np.testing.assert_array_equal(got.audio, want.audio)


def test_post_load_hook_reads_only_the_local_directory(tmp_path):
    """No tokenizer files: None; files that do not load raise (JAX swallows
    every failure and leaves None)."""
    pytest.importorskip("transformers")
    from mlx_audio_tpu_torch.tts.models.kugelaudio import Model

    pm = _port()
    assert Model.post_load_hook(pm, tmp_path).tokenizer is None
    (tmp_path / "tokenizer.json").write_text("{not json")
    with pytest.raises(Exception):
        Model.post_load_hook(pm, tmp_path)


def test_entry_points_default_to_cuda(tmp_path):
    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.tts.models.kugelaudio import Model

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults do not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(dataclasses.asdict(tiny_cfg()))
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "kugelaudio"}))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(tmp_path)
