"""The llama/Qwen2 backbone of the PyTorch port against the JAX package, on
the CPU at float32.

Config: a 2-layer Qwen2-style backbone at d32 (GQA 4/2, head 8, q/k/v
biases), the JAX package's `init_llama` at seed 0, bound into the port by
`model.load_jax_params`. Tolerance 2e-4 absolute on hidden states and
logits (summation order only, as tests/test_torch_parity.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ATOL = 2e-4
CFG = dict(hidden_size=32, num_hidden_layers=2, intermediate_size=64,
           num_attention_heads=4, num_key_value_heads=2, vocab_size=64,
           head_dim=8, rope_theta=10000.0, attention_bias=True)


def _np(t):
    return t.detach().float().cpu().numpy()


_MODELS = {}


def _models(**over):
    """(JAX config, JAX params, port model) for CFG with `over`."""
    key = tuple(sorted(over.items()))
    if key not in _MODELS:
        from mlx_audio_tpu.tts.models.llama import BackboneConfig, init_llama
        from mlx_audio_tpu.utils import flatten
        from mlx_audio_tpu_torch.model import load_jax_params
        from mlx_audio_tpu_torch.tts.models.llama import Model

        cfg = dict(CFG, **over)
        jcfg = BackboneConfig(**cfg)
        params = init_llama(jax.random.PRNGKey(0), jcfg)
        flat = {k: np.asarray(v) for k, v in flatten(params).items()}
        pm = load_jax_params(Model(cfg, device="cpu"), flat)
        _MODELS[key] = (jcfg, params, pm)
    return _MODELS[key]


def _jit_forward(jcfg, **static):
    """JAX's llama_forward for jcfg, compiled once per call site (one
    program instead of one eager dispatch per op)."""
    from mlx_audio_tpu.tts.models.llama.llama import llama_forward

    return jax.jit(lambda params, x, **kw: llama_forward(params, jcfg, x,
                                                        **kw, **static))


def _tokens(shape, seed):
    return np.random.RandomState(seed).randint(0, 64, shape)


@pytest.mark.parametrize("final_norm", [True, False])
@pytest.mark.parametrize("interleaved", [False, True])
def test_forward_without_cache_matches_jax(final_norm, interleaved):
    """Causal prefill with an additive (B, 1, 1, S) row mask hiding each
    row's padded tail."""
    from mlx_audio_tpu_torch.tts.models.llama import llama_forward

    jcfg, params, pm = _models(rope_interleaved=interleaved)
    toks = _tokens((2, 9), 1)
    mask = np.zeros((2, 1, 1, 9), np.float32)
    mask[1, ..., 6:] = -np.inf
    want, _ = _jit_forward(jcfg, final_norm=final_norm)(
        params, jnp.asarray(toks), mask=jnp.asarray(mask))
    got, _ = llama_forward(pm, torch.from_numpy(toks),
                           mask=torch.from_numpy(mask), final_norm=final_norm)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_cached_prefill_and_masked_decode_match_jax():
    """A cached prefill with an additive (B, S) row mask (row 1 sees only
    column 0, as KugelAudio's negative CFG row), then t == 1 steps with a
    boolean keep-mask and explicit per-row positions."""
    from mlx_audio_tpu.tts.models.llama.llama import init_caches as jinit
    from mlx_audio_tpu_torch.tts.models.llama import (init_caches,
                                                       llama_forward)

    jcfg, params, pm = _models()
    jfwd = _jit_forward(jcfg)
    s = 24
    toks = _tokens((2, 8), 2)
    add = np.where(np.arange(s) < 6, 0.0, -np.inf).astype(np.float32)
    add = np.stack([add, np.where(np.arange(s) == 0, 0.0, -np.inf)])
    jc = jinit(jcfg, 2, s, dtype=jnp.float32)
    pc = init_caches(pm.config, 2, s, dtype=torch.float32)
    jh, jc = jfwd(params, jnp.asarray(toks), caches=jc, offset=0,
                  mask=jnp.asarray(add.astype(np.float32)))
    ph, pc = llama_forward(pm, torch.from_numpy(toks), caches=pc, offset=0,
                           mask=torch.from_numpy(add.astype(np.float32)))
    np.testing.assert_allclose(_np(ph[0, :6]), np.asarray(jh[0, :6]),
                               atol=ATOL)
    np.testing.assert_allclose(_np(ph[1, 0]), np.asarray(jh[1, 0]), atol=ATOL)
    rs = np.random.RandomState(3)
    keep = np.zeros((2, s), bool)
    keep[0, :6] = True
    keep[1, 0] = True
    neg_pos = 1
    for off in range(6, 10):
        x = (rs.randn(1, 1, 32) * 0.5).astype(np.float32).repeat(2, 0)
        keep[:, off] = True
        pos = np.array([[off], [neg_pos]], np.int64)
        jh, jc = jfwd(params, jnp.asarray(x), positions=jnp.asarray(pos),
                      caches=jc, offset=jnp.int32(off),
                      mask=jnp.asarray(keep))
        ph, pc = llama_forward(pm, torch.from_numpy(x),
                               positions=torch.from_numpy(pos), caches=pc,
                               offset=off, mask=torch.from_numpy(keep))
        np.testing.assert_allclose(_np(ph), np.asarray(jh), atol=ATOL)
        neg_pos += 1
    for i, c in enumerate(jc):
        np.testing.assert_allclose(_np(pc.k[i, 0, :10]),
                                   np.asarray(c.k[0, :10]), atol=ATOL)


def test_cached_decode_equals_full_forward_and_jax():
    """Prefill 5 tokens, then 3 decode steps through the cache: the logits
    equal one full causal forward's, and JAX's decode_step's."""
    from mlx_audio_tpu.tts.models.llama.llama import decode_step as jstep
    from mlx_audio_tpu.tts.models.llama.llama import init_caches as jinit
    from mlx_audio_tpu_torch.tts.models.llama import (decode_step,
                                                       init_caches,
                                                       llama_forward,
                                                       logits_from_hidden)

    jcfg, params, pm = _models()
    toks = torch.from_numpy(_tokens((1, 8), 4))
    full = logits_from_hidden(pm, llama_forward(pm, toks)[0])
    caches = init_caches(pm.config, 1, 16, dtype=torch.float32)
    h, caches = llama_forward(pm, toks[:, :5], caches=caches, offset=0)
    np.testing.assert_allclose(_np(logits_from_hidden(pm, h)),
                               _np(full[:, :5]), atol=ATOL)
    jc = jinit(jcfg, 1, 16, dtype=jnp.float32)
    _, jc = _jit_forward(jcfg)(params, jnp.asarray(toks[:, :5].numpy()),
                               caches=jc, offset=0)
    jstep1 = jax.jit(lambda p, t, c, o: jstep(p, jcfg, t, c, o))
    for i in range(5, 8):
        lg, caches = decode_step(pm, toks[:, i:i + 1], caches, i)
        jlg, jc = jstep1(params, jnp.asarray(toks[:, i:i + 1].numpy()), jc,
                         jnp.int32(i))
        np.testing.assert_allclose(_np(lg), _np(full[:, i]), atol=ATOL)
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=ATOL)


def test_tied_head_and_logits_scaling_match_jax():
    from mlx_audio_tpu.tts.models.llama.llama import \
        logits_from_hidden as jlogits
    from mlx_audio_tpu_torch.tts.models.llama import (llama_forward,
                                                       logits_from_hidden)

    jcfg, params, pm = _models(tie_word_embeddings=True, logits_scaling=2.0)
    assert not hasattr(pm, "lm_head") and "lm_head" not in params
    toks = _tokens((1, 5), 5)
    jh, _ = _jit_forward(jcfg)(params, jnp.asarray(toks))
    ph, _ = llama_forward(pm, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(logits_from_hidden(pm, ph)),
                               np.asarray(jlogits(params, jcfg, jh)),
                               atol=ATOL)


def test_backbone_switches_and_sanitize():
    """`embed`, `final_norm` and `lm_head` leave out those parameters; the
    rotary buffers of a checkpoint are dropped."""
    from mlx_audio_tpu_torch.tts.models.llama import Model

    names = set(Model(CFG, device="cpu", embed=False, final_norm=False,
                      lm_head=False).state_dict())
    assert not any(n.startswith(("model.embed_tokens", "model.norm",
                                 "lm_head")) for n in names)
    assert "model.layers.1.self_attn.q_proj.bias" in names
    _, _, pm = _models()
    out = pm.sanitize({"model.layers.0.self_attn.rotary_emb.inv_freq": 1,
                       "lm_head.weight": 2})
    assert out == {"lm_head.weight": 2}


def test_entry_point_defaults_to_cuda():
    from mlx_audio_tpu_torch.tts.models.llama import Model

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(CFG)
