"""Moshi in the PyTorch port against the JAX package, on the CPU at float32:
the scaled embedding (the zero index -1, low rank, demux), one block of the
temporal stack against a KV cache with its context window, `forward_text`,
`LmGen`'s greedy tokens over 16 steps with the per-codebook delays and the
undelaying, `depformer_logits`, `generate` through the port's Mimi,
`sanitize_lm` on the kyutai MLX, kyutai PyTorch and HF layouts, and the
affine-q8 model against JAX's q8 with its tables kept dense; then the
departure on quantized tables. Mirrors tests/test_moshi.py on its config
(`chip_smoke.MOSHI_SMALL`); the q8 cases run `chip_smoke.MOSHI_Q8_SMALL`,
whose widths group 64 divides.

One weight set, drawn with numpy over JAX's parameter shapes
(test_torch_mimi.numpy_params), reaches the port through
`load_jax_params`. Tokens must be equal; f32 tensors agree within 2e-4
absolute (summation order only, the repo's torch-parity precedent), audio
also within 1e-4 relative to its largest value.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import MIMI_SMALL, MOSHI_Q8_SMALL, MOSHI_SMALL  # noqa: E402
from test_torch_mimi import (flat_numpy, jax_mimi, numpy_params,  # noqa: E402
                             port_mimi)

ATOL = 2e-4
AUDIO_REL = 1e-4
GREEDY = dict(text_temp=0.0, audio_temp=0.0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def jax_lm(cfg: dict, seed: int = 0):
    from mlx_audio_tpu.sts.models.moshi import Lm, LmConfig

    lm = Lm(LmConfig.from_dict(cfg))
    lm.bind(numpy_params(lm.init_params, seed))
    return lm


def port_lm(jlm, cfg: dict):
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.sts.models.moshi import Lm, LmConfig

    return load_jax_params(Lm(LmConfig.from_dict(cfg), device="cpu"),
                           flat_numpy(jlm.params))


@pytest.fixture(scope="module")
def pair():
    jlm = jax_lm(MOSHI_SMALL)
    return jlm, port_lm(jlm, MOSHI_SMALL)


def _other(rng, n: int, lm) -> list:
    return [rng.randint(0, lm.config.audio_vocab_size - 1,
                        (1, lm.config.other_codebooks)) for _ in range(n)]


def _steps(gen, others) -> list:
    out = []
    for other in others:
        text, own = gen.step(other)
        out.append((np.asarray(text).tolist(),
                    None if own is None else np.asarray(own).tolist()))
    return out


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "low_rank", "demux"])
def test_scaled_embedding_matches_jax(kind):
    """Index -1 gives exact zeros; the low-rank factor and the
    second-stream demux (ids tok2 * vocab + tok1) as JAX's."""
    from mlx_audio_tpu.sts.models.moshi.moshi import apply_scaled_embedding
    from mlx_audio_tpu_torch.sts.models.moshi.moshi import ScaledEmbedding

    rng = np.random.RandomState(0)
    vocab, dim = 11, 8
    p = {"weight": rng.randn(vocab, 4 if kind == "low_rank" else dim)}
    if kind == "low_rank":
        p["low_rank"] = {"weight": rng.randn(dim, 4)}
    if kind == "demux":
        p["out1"] = {"weight": rng.randn(dim, dim)}
        p["out2"] = {"weight": rng.randn(dim, dim)}
    p = {k: ({"weight": v["weight"].astype(np.float32)} if isinstance(v, dict)
             else v.astype(np.float32)) for k, v in p.items()}
    hi = vocab * (vocab + 1) if kind == "demux" else vocab
    ids = rng.randint(0, hi, (2, 7))
    ids[0, 2] = ids[1, 5] = -1
    want = np.asarray(apply_scaled_embedding(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(ids), vocab,
        demux=kind == "demux"))
    emb = ScaledEmbedding(vocab, dim, low_rank=4 if kind == "low_rank"
                          else None, demux=kind == "demux")
    from mlx_audio_tpu_torch.utils import flatten

    emb.load_state_dict({k: torch.from_numpy(v)
                         for k, v in flatten(p).items()})
    got = emb(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (got[0, 2] == 0).all() and (got[1, 5] == 0).all()


def test_block_matches_jax_against_a_windowed_cache(pair):
    """One temporal block: 4 tokens at offset 0, then 3 at offset 4,
    against a KV cache, with a context of 3 so the window drops keys."""
    import dataclasses

    from mlx_audio_tpu.ops.kvcache import KVCache as JCache
    from mlx_audio_tpu.ops.rope import rope_freqs as jrope_freqs
    from mlx_audio_tpu.sts.models.moshi.moshi import _block_forward
    from mlx_audio_tpu_torch.ops.kvcache import KVCache
    from mlx_audio_tpu_torch.ops.rope import rope_cis, rope_freqs
    from mlx_audio_tpu_torch.sts.models.moshi.moshi import Block

    jlm, plm = pair
    d = dataclasses.replace(jlm.config.transformer, context=3)
    hd = d.d_model // d.num_heads
    block = Block(dataclasses.replace(plm.config.transformer, context=3))
    block.load_state_dict(plm.transformer.layers[0].state_dict())
    jp = jlm.params["transformer"]["layers"]["0"]
    jcache = JCache.init(1, 16, d.num_heads, hd, jnp.float32)
    pcache = KVCache.init(1, 16, d.num_heads, hd, torch.float32, "cpu",
                          n_layers=1).layer(0)
    x = np.random.RandomState(1).randn(1, 7, d.d_model).astype(np.float32)
    step = jax.jit(lambda p, x, pos, inv, cache, off: _block_forward(
        p, d, x, pos, inv, cache, off, d.context))
    for lo, hi in ((0, 4), (4, 7)):
        pos = np.arange(lo, hi)
        want, jcache = step(jp, jnp.asarray(x[:, lo:hi]),
                            jnp.asarray(pos)[None],
                            jrope_freqs(hd, d.max_period), jcache, lo)
        got = block(torch.from_numpy(x[:, lo:hi]),
                    rope_cis(torch.from_numpy(pos), rope_freqs(hd, d.max_period)),
                    pcache, lo)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL)


def test_forward_text_matches_jax(pair):
    """Hidden states and text logits of 6 tokens, then 5 more against the
    same cache."""
    jlm, plm = pair
    ids = np.random.RandomState(2).randint(0, 63, (1, 11))
    jcaches = jlm.make_caches(1, max_steps=16)
    pcaches = plm.make_caches(1, max_steps=16)
    forward = jax.jit(jlm.forward_text)
    for lo, hi in ((0, 6), (6, 11)):
        jh, jl, jcaches = forward(jlm.params, jnp.asarray(ids[:, lo:hi]),
                                  jcaches, lo)
        ph, pl = plm.forward_text(torch.from_numpy(ids[:, lo:hi]), pcaches,
                                  lo)
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=ATOL)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL)


def test_lmgen_greedy_tokens_match_jax(pair):
    """16 greedy steps on the other stream's seeded codes: the text tokens
    and the undelayed own frames (None while the delay fills) equal."""
    from mlx_audio_tpu.sts.models.moshi import LmGen as JGen
    from mlx_audio_tpu_torch.sts.models.moshi import LmGen

    jlm, plm = pair
    others = _other(np.random.RandomState(3), 16, plm)
    want = _steps(JGen(jlm, max_steps=32, **GREEDY), others)
    got = _steps(LmGen(plm, max_steps=32, **GREEDY), others)
    assert got == want
    assert got[0][1] is None and all(own is not None for _, own in got[1:])
    gen = LmGen(plm, max_steps=32, **GREEDY)
    _steps(gen, others[:5])
    # own codes sampled at step t land at t - delay: codebook 0 (delay 0)
    # is ahead of the delayed ones by a step
    assert (gen.gen[0, 1, :5] >= 0).all() and gen.gen[0, 2, 4] == -2
    assert (gen.gen[0, 2, :4] >= 0).all()


def test_depformer_logits_match_jax(pair):
    jlm, plm = pair
    rng = np.random.RandomState(4)
    hidden = rng.randn(2, 1, 32).astype(np.float32)
    tokens = rng.randint(0, 63, (2, 4))
    want = jax.jit(jlm.depformer_logits)(jlm.params, jnp.asarray(hidden),
                                         jnp.asarray(tokens))
    got = plm.depformer_logits(torch.from_numpy(hidden),
                               torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_generate_through_the_port_mimi_matches_jax():
    """The duplex run of tests/test_moshi.py (10 steps over the tiny Mimi,
    greedy): the text tokens equal, Moshi's audio within tolerance."""
    from mlx_audio_tpu.sts.models.moshi import Model as JModel
    from mlx_audio_tpu.sts.models.moshi import ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.sts.models.moshi import Model, ModelConfig

    jm = JModel(JConfig(lm_config=MOSHI_SMALL, mimi_num_codebooks=4))
    jm.bind(numpy_params(jm.init_params, 0))
    jm.mimi = jax_mimi(MIMI_SMALL, 1)
    pm = load_jax_params(Model(ModelConfig(lm_config=MOSHI_SMALL,
                                           mimi_num_codebooks=4),
                               device="cpu"), flat_numpy(jm.params))
    pm.mimi = port_mimi(jm.mimi, MIMI_SMALL)
    audio = (np.random.RandomState(0).randn(24 * 10) * 0.1).astype(
        np.float32)
    want = jm.generate(audio, max_steps=10, **GREEDY)
    got = pm.generate(audio, max_steps=10, **GREEDY)
    assert got.token_count == want.token_count == 10
    assert got.prompt["text_tokens"] == want.prompt["text_tokens"]
    assert got.samples == want.samples > 0
    a, b = np.asarray(got.audio), np.asarray(want.audio)
    assert np.abs(a - b).max() <= ATOL and _rel(a, b) <= AUDIO_REL
    assert pm.last_run["steps"] == 10 and len(pm.last_run["step_ms"]) == 10


def test_generate_without_a_mimi_raises():
    from mlx_audio_tpu_torch.sts.models.moshi import Model, ModelConfig

    m = Model(ModelConfig(lm_config=MOSHI_SMALL), device="cpu")
    with pytest.raises(ValueError, match="Bind a Mimi codec"):
        m.generate(np.zeros(240, np.float32))
    assert "mimi" not in dict(m.named_modules())


# ---------------------------------------------------------------------------
# sanitize_lm on three layouts
# ---------------------------------------------------------------------------


def _kyutai_pt(flat: dict, cfg) -> dict:
    """The JAX tree as a kyutai PyTorch checkpoint: `.alpha` norms,
    `emb.N`, `depformer_in.S` / `linears.S`, one depformer stack whose
    attention projections hold every slice's rows and whose gating is
    indexed by slice."""
    t, dp = cfg.transformer, cfg.depformer
    w = {"out_norm.alpha": flat["out_norm.weight"].reshape(1, 1, -1),
         "text_emb.weight": flat["text_emb.weight"],
         "text_linear.weight": flat["text_linear.weight"],
         "depformer_text_emb.weight": flat["depformer.slices.0.emb.weight"]}
    for cb in range(cfg.audio_codebooks):
        w[f"emb.{cb}.weight"] = flat[f"audio_embs.{cb}.weight"]
    for k, v in flat.items():
        if k.startswith("transformer."):
            if k.endswith(("norm1.weight", "norm2.weight")):
                w[k[: -len(".weight")] + ".alpha"] = v.reshape(1, 1, -1)
            else:
                w[k.replace(".in_proj.weight", ".in_proj_weight")] = v
    for s in range(dp.num_slices):
        pre = f"depformer.slices.{s}"
        w[f"depformer_in.{s}.weight"] = flat[f"{pre}.linear_in.weight"]
        w[f"linears.{s}.weight"] = flat[f"{pre}.linear_out.weight"]
        if s:
            w[f"depformer_emb.{s - 1}.weight"] = flat[f"{pre}.emb.weight"]
    for li in range(dp.num_layers):
        src = f"depformer.layers.{li}"
        lay = [f"depformer.slices.{s}.transformer.layers.{li}"
               for s in range(dp.num_slices)]
        w[f"{src}.norm1.alpha"] = flat[f"{lay[0]}.norm1.weight"].reshape(
            1, 1, -1)
        w[f"{src}.norm2.alpha"] = flat[f"{lay[0]}.norm2.weight"].reshape(
            1, 1, -1)
        w[f"{src}.self_attn.in_proj_weight"] = np.concatenate(
            [flat[f"{p}.self_attn.in_proj.weight"] for p in lay])
        w[f"{src}.self_attn.out_proj.weight"] = np.concatenate(
            [flat[f"{p}.self_attn.out_proj.weight"] for p in lay])
        for s, p in enumerate(lay):
            for n in ("linear_in", "linear_out"):
                w[f"{src}.gating.{s}.{n}.weight"] = \
                    flat[f"{p}.gating.{n}.weight"]
    return w


def _permute_hf_rope(w: np.ndarray, heads: int) -> np.ndarray:
    out, inp = w.shape
    hd = out // heads
    return w.reshape(heads, hd // 2, 2, inp).transpose(0, 2, 1, 3).reshape(
        out, inp)


def _hf(flat: dict, cfg) -> dict:
    """The JAX tree as an HF transformers Moshi checkpoint: split q/k/v/o
    with q and k permuted to half-split RoPE, FlexibleLinear stacks over
    the depth decoder's slices."""
    t, dp = cfg.transformer, cfg.depformer
    d = t.d_model
    w = {"decoder.model.embed_tokens.weight": flat["text_emb.weight"],
         "decoder.lm_head.weight": flat["text_linear.weight"],
         "decoder.model.norm.weight": flat["out_norm.weight"],
         "depth_decoder.text_embed_tokens.weight":
             flat["depformer.slices.0.emb.weight"]}
    for cb in range(cfg.audio_codebooks):
        w[f"embed_tokens.{cb}.weight"] = flat[f"audio_embs.{cb}.weight"]
    for li in range(t.num_layers):
        src, dst = f"transformer.layers.{li}", f"decoder.model.layers.{li}"
        q, k, v = np.split(flat[f"{src}.self_attn.in_proj.weight"], 3)
        w[f"{dst}.self_attn.q_proj.linear.weight"] = _permute_hf_rope(
            q, t.num_heads)
        w[f"{dst}.self_attn.k_proj.linear.weight"] = _permute_hf_rope(
            k, t.num_heads)
        w[f"{dst}.self_attn.v_proj.linear.weight"] = v
        w[f"{dst}.self_attn.o_proj.linear.weight"] = \
            flat[f"{src}.self_attn.out_proj.weight"]
        w[f"{dst}.input_layernorm.weight"] = flat[f"{src}.norm1.weight"]
        w[f"{dst}.post_attention_layernorm.weight"] = \
            flat[f"{src}.norm2.weight"]
        w[f"{dst}.mlp.fc1.weight"] = flat[f"{src}.gating.linear_in.weight"]
        w[f"{dst}.mlp.fc2.weight"] = flat[f"{src}.gating.linear_out.weight"]
    sl = [f"depformer.slices.{s}" for s in range(dp.num_slices)]
    w["depth_decoder.input_projections.weight"] = np.stack(
        [flat[f"{p}.linear_in.weight"] for p in sl])
    w["depth_decoder.lm_heads.weight"] = np.stack(
        [flat[f"{p}.linear_out.weight"] for p in sl])
    for s in range(1, dp.num_slices):
        w[f"depth_decoder.embed_tokens.{s - 1}.weight"] = \
            flat[f"{sl[s]}.emb.weight"]
    for li in range(dp.num_layers):
        dst = f"depth_decoder.layers.{li}"
        lay = [f"{p}.transformer.layers.{li}" for p in sl]
        qkv = [np.split(flat[f"{p}.self_attn.in_proj.weight"], 3)
               for p in lay]
        for j, n in enumerate("qkv"):
            w[f"{dst}.self_attn.{n}_proj.linear.weight"] = np.stack(
                [x[j] for x in qkv])
        w[f"{dst}.self_attn.o_proj.linear.weight"] = np.stack(
            [flat[f"{p}.self_attn.out_proj.weight"] for p in lay])
        w[f"{dst}.input_layernorm.weight"] = flat[f"{lay[0]}.norm1.weight"]
        w[f"{dst}.post_attention_layernorm.weight"] = \
            flat[f"{lay[0]}.norm2.weight"]
        w[f"{dst}.mlp.fc1.weight"] = np.stack(
            [flat[f"{p}.gating.linear_in.weight"] for p in lay])
        w[f"{dst}.mlp.fc2.weight"] = np.stack(
            [flat[f"{p}.gating.linear_out.weight"] for p in lay])
    return w


@pytest.mark.parametrize("layout", ["kyutai_mlx", "kyutai_pt", "hf"])
def test_sanitize_lm_matches_jax_and_loads(layout):
    """Each layout of one weight set: the port's `sanitize_lm` gives JAX's
    names and arrays, and they load strictly into the port's Lm and give
    back the weights (the HF RoPE permutation undone). The depformer's
    norms are shared across slices in the kyutai PyTorch and HF layouts,
    so the weight set draws them equal across slices."""
    from mlx_audio_tpu.sts.models.moshi.moshi import sanitize_lm as jsan
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.sts.models.moshi import Lm, LmConfig
    from mlx_audio_tpu_torch.sts.models.moshi.moshi import sanitize_lm

    cfg = LmConfig.from_dict(MOSHI_SMALL)
    flat = flat_numpy(jax_lm(MOSHI_SMALL, 5).params)
    for k in list(flat):
        if k.startswith("depformer.slices.") and k.endswith(
                ("norm1.weight", "norm2.weight")):
            s0 = k.split(".", 3)
            flat[k] = flat[f"depformer.slices.0.{s0[3]}"]
    if layout == "kyutai_mlx":
        ckpt = dict(flat, **{"audio_encoder.x": np.zeros(2, np.float32)})
    else:
        ckpt = (_kyutai_pt if layout == "kyutai_pt" else _hf)(flat, cfg)
    from mlx_audio_tpu.sts.models.moshi import LmConfig as JConfig

    want = jsan({k: jnp.asarray(v) for k, v in ckpt.items()},
                JConfig.from_dict(MOSHI_SMALL))
    got = sanitize_lm(ckpt, cfg)
    assert set(got) == set(want) == set(flat)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]))
        np.testing.assert_array_equal(np.asarray(v), flat[k])
    lm = load_jax_params(Lm(cfg, device="cpu"), got)
    assert np.array_equal(lm.text_linear.weight.numpy(),
                          flat["text_linear.weight"])


# ---------------------------------------------------------------------------
# affine q8
# ---------------------------------------------------------------------------


def _dense_tables(path, w):
    """JAX's quantization predicate that keeps Moshi's tables dense."""
    leaf = path.rsplit(".", 1)[-1]
    return not (leaf in ("text_emb", "emb") or path.startswith("audio_embs"))


@pytest.fixture(scope="module")
def q8_pair():
    from mlx_audio_tpu.ops.quant import maybe_quantize_tree
    from mlx_audio_tpu_torch.utils import apply_quantization

    jlm = jax_lm(MOSHI_Q8_SMALL, 1)
    dense = jlm.params
    plm = port_lm(jlm, MOSHI_Q8_SMALL)
    jlm.bind(maybe_quantize_tree(dense, 64, 8, _dense_tables))
    apply_quantization(plm, {"quantization": {"bits": 8, "group_size": 64}})
    return jlm, plm, dense


def test_q8_matches_jax_q8_with_dense_tables(q8_pair):
    """Every linear quantized (group 64, 8 bits), the tables dense on both
    sides: text logits of a forward and 12 greedy LmGen steps equal."""
    from mlx_audio_tpu.sts.models.moshi import LmGen as JGen
    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.sts.models.moshi import LmGen

    jlm, plm, _ = q8_pair
    assert "w_q" in jlm.params["transformer"]["layers"]["0"]["gating"][
        "linear_out"] and "weight" in jlm.params["text_emb"]
    c = plm.config
    t, dp = c.transformer, c.depformer
    assert sum(isinstance(m, QuantizedLinear) for m in plm.modules()) == \
        t.num_layers * 4 + dp.num_slices * (dp.num_layers * 4 + 2) + 1
    ids = np.random.RandomState(6).randint(0, 63, (1, 5))
    _, jl, _ = jax.jit(jlm.forward_text)(jlm.params, jnp.asarray(ids),
                                         jlm.make_caches(1, max_steps=8), 0)
    _, pl = plm.forward_text(torch.from_numpy(ids),
                             plm.make_caches(1, max_steps=8), 0)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL)
    others = _other(np.random.RandomState(7), 12, plm)
    assert _steps(LmGen(plm, max_steps=24, **GREEDY), others) == \
        _steps(JGen(jlm, max_steps=24, **GREEDY), others)


def test_quantization_keeps_the_tables_dense(q8_pair):
    """The departure: JAX's default tree rule, maybe_quantize_tree(params,
    64, 8), takes Moshi's tables (`text_emb`, `audio_embs.N`,
    `depformer.slices.S.emb`) for linears and quantizes them, and a step
    then fails on the missing `weight`; the port quantizes the linears
    only, and its q8 model runs."""
    from mlx_audio_tpu.ops.quant import maybe_quantize_tree
    from mlx_audio_tpu.sts.models.moshi import Lm as JLm
    from mlx_audio_tpu.sts.models.moshi import LmConfig as JConfig
    from mlx_audio_tpu.sts.models.moshi import LmGen as JGen
    from mlx_audio_tpu_torch.sts.models.moshi import LmGen
    from mlx_audio_tpu_torch.sts.models.moshi.moshi import ScaledEmbedding

    _, plm, dense = q8_pair
    q = maybe_quantize_tree(dense, 64, 8)
    assert "w_q" in q["text_emb"] and "w_q" in q["audio_embs"]["3"]
    assert "w_q" in q["depformer"]["slices"]["2"]["emb"]
    jlm = JLm(JConfig.from_dict(MOSHI_Q8_SMALL))
    jlm.bind(q)
    with pytest.raises(KeyError, match="weight"):
        JGen(jlm, max_steps=8).step(np.zeros((1, 4), np.int32))
    tables = [m for m in plm.modules() if isinstance(m, ScaledEmbedding)]
    assert len(tables) == 1 + 8 + 4
    assert all(t.weight.dtype == torch.float32 for t in tables)
    out = _steps(LmGen(plm, max_steps=8), [np.zeros((1, 4), np.int64)] * 4)
    assert all(0 <= t[0][0] < 63 for t in out)
