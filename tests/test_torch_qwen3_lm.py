"""The shared Qwen3 LM and its decode stepper in the PyTorch port against
the JAX package, on the CPU: `Qwen3LMConfig.from_dict`,
`qwen3_lm_forward` (a padded prompt into caches, then one-token steps),
`prompt_bucket`, and `make_decode_fns` / `run_decode` driven as the JAX
package's (greedy, with a carried repetition history, an EOS stop, a
max_tokens cut, `on_token`); then the port's rules (draws from a seeded
generator, the stop at most one step after EOS).

Config: a 2-layer Qwen3 LM at d32 (4 heads, 2 KV heads, head 8, FFN 64,
vocabulary 96), one parameter tree drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`). The JAX stepper is its own jitted pair.
Hidden states at ATOL = 2e-4 (f32, summation order); tokens equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
CFG = dict(vocab_size=96, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, head_dim=8, rope_theta=10000.0)
PROMPT = [5, 17, 23, 42, 8, 61, 3, 77, 12]


@pytest.fixture(scope="module")
def lms():
    """(JAX config and params, port config and LM) on one weight set."""
    from mlx_audio_tpu.tts.models.moss_tts.config import \
        Qwen3LMConfig as JConfig
    from mlx_audio_tpu.tts.models.moss_tts.moss_tts import init_qwen3_lm
    from mlx_audio_tpu_torch.model import load_jax_params, TorchModel
    from mlx_audio_tpu_torch.tts.models.moss_tts import (Qwen3LMConfig,
                                                         init_qwen3_lm as pi)

    jc = JConfig.from_dict(CFG)
    params = numpy_params(lambda k: init_qwen3_lm(k, jc), 0)
    pc = Qwen3LMConfig.from_dict(CFG)
    holder = TorchModel(pc)
    holder.model = pi(pc)
    load_jax_params(holder, {f"model.{k}": v for k, v in
                             flat_numpy(params).items()})
    return jc, params, pc, holder.model


def test_config_equals_jax():
    from mlx_audio_tpu.tts.models.moss_tts.config import \
        Qwen3LMConfig as JConfig
    from mlx_audio_tpu_torch.tts.models.moss_tts import Qwen3LMConfig

    for raw in ({}, CFG, {"hidden_size": 64, "num_attention_heads": 4,
                          "rope_parameters": {"rope_theta": 5e5}},
                {"rope_theta": 1.0, "rope_parameters": {"rope_theta": 2.0},
                 "head_dim": 16}):
        assert vars(Qwen3LMConfig.from_dict(raw)) == vars(
            JConfig.from_dict(raw))


def test_forward_equals_jax(lms):
    """A prompt right-padded to 16 into 24-column caches under the pad
    mask, then two one-token steps; and a forward with no cache."""
    from mlx_audio_tpu.ops.kvcache import KVCache
    from mlx_audio_tpu.tts.models.moss_tts.moss_tts import \
        qwen3_lm_forward as jfwd
    from mlx_audio_tpu_torch.tts.models.moss_tts import qwen3_lm_forward

    jc, params, pc, lm = lms
    n, bucket, cap = len(PROMPT), 16, 24
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :n] = PROMPT
    table = np.asarray(params["embed_tokens"]["weight"])
    emb = table[ids]
    pad = np.where(np.arange(cap)[None] < n, 0.0, -np.inf).astype(np.float32)
    caches = [KVCache.init(1, cap, 2, 8, jnp.float32) for _ in range(2)]
    jh, caches = jax.jit(lambda p, e, c: jfwd(
        p, jc, e, c, 0, jnp.asarray(pad)[:, None, None, :]))(
        params, jnp.asarray(emb), caches)
    pcache = lm.make_caches(pc, 1, cap)
    ph, _ = qwen3_lm_forward(lm, torch.from_numpy(emb), pcache, 0,
                             torch.from_numpy(pad))
    np.testing.assert_allclose(ph[:, :n].numpy(), np.asarray(jh)[:, :n],
                               atol=ATOL)
    step = jax.jit(lambda p, e, c, o: jfwd(p, jc, e, c, o, None))
    for i, tok in enumerate((30, 31)):
        e = table[[[tok]]]
        jh, caches = step(params, jnp.asarray(e), caches, n + i)
        ph, _ = qwen3_lm_forward(lm, torch.from_numpy(e), pcache, n + i)
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=ATOL)
    jh, _ = jax.jit(lambda p, e: jfwd(p, jc, e, None, 0))(
        params, jnp.asarray(table[[PROMPT]]))
    ph, _ = qwen3_lm_forward(lm, torch.from_numpy(table[[PROMPT]]), None, 0)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=ATOL)


def test_prompt_bucket_equals_jax():
    from mlx_audio_tpu.stt.models import qwen3_lm as jl
    from mlx_audio_tpu_torch.stt.models import qwen3_lm as pl

    for n in (1, 255, 256, 257, 8192, 8193, 9000, 20000):
        assert pl.prompt_bucket(n) == jl.prompt_bucket(n)
    assert (pl.DEC_CHUNK, pl.PROMPT_BUCKETS) == (jl.DEC_CHUNK,
                                                 jl.PROMPT_BUCKETS)


_JAX_FNS = {}


def _jax_decode(jc, params, **kw):
    """The JAX package's stepper on the same LM; its jitted pair made once
    per sampling config (the history is an argument, not a constant)."""
    from mlx_audio_tpu.stt.models.qwen3_lm import make_decode_fns, run_decode
    from mlx_audio_tpu.tts.models.moss_tts.moss_tts import qwen3_lm_forward

    history = kw.pop("history", None)
    max_tokens = kw.pop("max_tokens")
    key = tuple(sorted(kw.items()))
    if key not in _JAX_FNS:
        _JAX_FNS[key] = make_decode_fns(
            text_config=jc, lm_params=lambda p: p,
            logits_fn=lambda p, h: h @ p["embed_tokens"]["weight"].T,
            forward_fn=lambda p, e, c, o, m: qwen3_lm_forward(p, jc, e, c,
                                                              o, m),
            bucket=256, max_new=64, **kw)
    fns = _JAX_FNS[key]
    ids = np.zeros((1, 256), np.int64)
    ids[0, :len(PROMPT)] = PROMPT
    emb = np.asarray(params["embed_tokens"]["weight"])[ids]

    class M:
        pass

    m = M()
    m.params = params
    seen = []
    out = run_decode(m, fns, emb, len(PROMPT), max_tokens=max_tokens,
                     on_token=seen.append, history=history)
    assert seen == out
    return out


def _port_decode(pc, lm, **kw):
    from mlx_audio_tpu_torch.stt.models.qwen3_lm import (make_decode_fns,
                                                         run_decode)
    from mlx_audio_tpu_torch.tts.models.moss_tts import qwen3_lm_forward

    history = kw.pop("history", None)
    max_tokens = kw.pop("max_tokens")
    seed = kw.pop("seed", 0)
    fns = make_decode_fns(
        text_config=pc, embed_fn=lm.embed_tokens,
        logits_fn=lambda h: h @ lm.embed_tokens.weight.T,
        forward_fn=lambda e, c, o, m: qwen3_lm_forward(lm, e, c, o, m),
        make_caches=lambda cols: lm.make_caches(pc, 1, cols),
        bucket=256, max_new=64, **kw)
    ids = torch.zeros(1, 256, dtype=torch.long)
    ids[0, :len(PROMPT)] = torch.tensor(PROMPT)

    class M:
        last_run = None

    m = M()
    seen = []
    out = run_decode(m, fns, lm.embed_tokens(ids), len(PROMPT),
                     max_tokens=max_tokens, on_token=seen.append,
                     history=history, seed=seed)
    assert seen == out
    return out, m.last_run


@pytest.mark.parametrize("case", [
    dict(max_tokens=40),
    dict(max_tokens=64, repetition_penalty=1.3, repetition_context_size=6),
    dict(max_tokens=50, repetition_penalty=1.3, repetition_context_size=6,
         history=np.asarray([[61, 3, 77, 12, 30, 31]])),
], ids=["greedy", "penalty_carried", "history_given"])
def test_run_decode_equals_jax(lms, case):
    """Greedy decodes over two chunks; the repetition history rolls on
    across them (and starts from a given one)."""
    jc, params, pc, lm = lms
    want = _jax_decode(jc, params, **dict(case))
    got, run = _port_decode(pc, lm, **dict(case))
    assert got == want and len(got) == case["max_tokens"]
    assert run["steps"] == case["max_tokens"] and run["chunks"] == 2
    assert run["forwards"] == case["max_tokens"] - 1


def test_caches_grow_with_the_decode(lms):
    """The prefill's caches hold the bucket and one chunk; each chunk that
    would not fit doubles the decode columns, up to bucket + max_new, and
    keeps the columns already written."""
    from mlx_audio_tpu_torch.stt.models.qwen3_lm import (DEC_CHUNK,
                                                         make_decode_fns)
    from mlx_audio_tpu_torch.tts.models.moss_tts import qwen3_lm_forward

    _, _, pc, lm = lms
    bucket, max_new = 16, 100
    fns = make_decode_fns(
        text_config=pc, embed_fn=lm.embed_tokens,
        logits_fn=lambda h: h @ lm.embed_tokens.weight.T,
        forward_fn=lambda e, c, o, m: qwen3_lm_forward(lm, e, c, o, m),
        make_caches=lambda cols: lm.make_caches(pc, 1, cols),
        bucket=bucket, max_new=max_new)
    ids = torch.zeros(1, bucket, dtype=torch.long)
    ids[0, :len(PROMPT)] = torch.tensor(PROMPT)
    state = fns.start(lm.embed_tokens(ids), len(PROMPT), max_new)
    cols = [state["caches"].k.shape[2]]
    prompt_k = state["caches"].k[:, :, :len(PROMPT)].clone()
    while not fns.chunk(state)[1]:
        cols.append(state["caches"].k.shape[2])
    cols.append(state["caches"].k.shape[2])
    # the decode writes from column len(PROMPT) on: chunk 2 needs
    # len(PROMPT) + 64 columns, chunk 3 len(PROMPT) + 96
    assert len(PROMPT) <= bucket
    assert cols == [bucket + DEC_CHUNK, bucket + DEC_CHUNK,
                    bucket + 2 * DEC_CHUNK, bucket + max_new, bucket + max_new]
    assert torch.equal(state["caches"].k[:, :, :len(PROMPT)], prompt_k)
    assert state["step"] == max_new


def test_eos_stops_as_jax(lms):
    """An EOS id from the greedy run: the tokens before it, EOS not kept,
    at most one step more run."""
    jc, params, pc, lm = lms
    free, _ = _port_decode(pc, lm, max_tokens=40)
    eos = free[20]
    first = free.index(eos)
    want = _jax_decode(jc, params, max_tokens=40, eos_ids=(eos,))
    got, run = _port_decode(pc, lm, max_tokens=40, eos_ids=(eos,))
    assert got == want == free[:first]
    assert first + 1 <= run["steps"] <= first + 2


def test_sampled_decode_is_seeded(lms):
    _, _, pc, lm = lms
    kw = dict(max_tokens=12, temperature=1.0, top_p=0.9, min_p=0.05)
    a, _ = _port_decode(pc, lm, seed=7, **kw)
    b, _ = _port_decode(pc, lm, seed=7, **kw)
    c, _ = _port_decode(pc, lm, seed=8, **kw)
    assert a == b and a != c
    greedy, _ = _port_decode(pc, lm, max_tokens=12)
    assert _port_decode(pc, lm, seed=9, max_tokens=12, temperature=1.0,
                        top_k=1)[0] == greedy
    with pytest.raises(ValueError, match="max_tokens"):
        _port_decode(pc, lm, max_tokens=65)


def test_min_p_and_keep_equal_jax():
    """The filter chain: top-k, then min-p, then top-p, then at least
    min_tokens_to_keep of the largest."""
    from mlx_audio_tpu.ops.sampling import top_k_top_p_filter as jfilter
    from mlx_audio_tpu_torch.ops.sampling import top_k_top_p_filter

    lg = np.random.RandomState(0).randn(3, 50).astype(np.float32) * 3
    for kw in (dict(min_p=0.1), dict(top_k=10, min_p=0.2, top_p=0.8),
               dict(min_p=0.5, min_tokens_to_keep=5),
               dict(top_p=0.3, min_tokens_to_keep=4), dict()):
        got = top_k_top_p_filter(torch.from_numpy(lg), **kw).numpy()
        want = np.asarray(jfilter(jnp.asarray(lg), **kw))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got[~np.isinf(got)],
                                   want[~np.isinf(want)])
