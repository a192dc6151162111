"""MegaASR of the PyTorch port against the JAX package, on the CPU: the
router's log-mel, its converted-checkpoint layout and its degraded
probability over the time buckets; LoRA factor files, the deltas applied
and removed; the routed request, its LoRA toggle and its text; the loader
with the `extras/` files; then the port's rules (removal is exact in bf16,
an adapter on a quantized linear raises at load).

Configs: tests/test_mega_asr.py's `_router` and `_asr_cfg` with its
`_FakeTok`; one parameter tree drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`) for the ASR, the JAX package's
`init_router_params` for the router, each bound into both packages. The
JAX package runs its own jitted router and decode. Probabilities and
weights at ATOL = 2e-4 (f32; the log-mel's DFT runs in f64 here); greedy
text equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402

from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402
from test_torch_prequantized import no_hf_tokenizer  # noqa: E402,F401

ATOL = 2e-4
ASR_CFG = dict(
    model_type="mega_asr", audio_token_id=5,
    audio_config=dict(num_mel_bins=16, encoder_layers=1,
                      encoder_attention_heads=2, encoder_ffn_dim=32,
                      d_model=16, downsample_hidden_size=4, output_dim=16),
    text_config=dict(vocab_size=64, hidden_size=16, intermediate_size=32,
                     num_hidden_layers=1, num_attention_heads=2,
                     num_key_value_heads=2, head_dim=8,
                     tie_word_embeddings=True))
Q_PATH = "model.layers.0.self_attn.q_proj"


class FakeTok:
    """tests/test_mega_asr.py::_FakeTok."""

    eos_token_id = 3
    unk_token_id = 0

    def encode(self, text, add_special_tokens=False):
        return [7, 8] + [5] * text.count("<|audio_pad|>") + [9, 10, 11]

    def decode(self, toks, skip_special_tokens=True):
        return " ".join(str(t) for t in toks)

    def convert_tokens_to_ids(self, s):
        return 3 if s == "<|im_end|>" else 4


def jax_router():
    from mlx_audio_tpu.stt.models.mega_asr import AudioQualityRouter
    from mlx_audio_tpu.stt.models.mega_asr.router import init_router_params

    return AudioQualityRouter(init_router_params(
        jax.random.PRNGKey(0), d_model=16, nhead=4, dim_feedforward=32,
        num_layers=1, n_mels=80, frontend_hidden_dim=8,
        classifier_hidden_dim=8, max_len=850))


@pytest.fixture(scope="module")
def routers():
    from mlx_audio_tpu_torch.stt.models.mega_asr import AudioQualityRouter

    jr = jax_router()
    return jr, AudioQualityRouter(flat_numpy(jr.params), device="cpu")


def converted_router(seed: int = 2, d: int = 8, h: int = 4, ff: int = 16,
                     max_len: int = 850) -> dict:
    """tests/test_mega_asr.py's converted router layout, with random batch
    norm statistics."""
    rs = np.random.RandomState(seed)
    f = 80

    def r(*s):
        return rs.randn(*s).astype("f")

    w = {
        "frontend.conv.0.weight": r(h, 3, f), "frontend.conv.0.bias": r(h),
        "frontend.conv.4.weight": r(d, 3, h), "frontend.conv.4.bias": r(d),
        "pos_encoder.pe": r(1, max_len, d) * 0.1,
        "transformer.layers.0.self_attn.in_proj_weight": r(3 * d, d),
        "transformer.layers.0.self_attn.in_proj_bias": r(3 * d),
        "transformer.layers.0.self_attn.out_proj.weight": r(d, d),
        "transformer.layers.0.self_attn.out_proj.bias": r(d),
        "transformer.layers.0.linear1.weight": r(ff, d),
        "transformer.layers.0.linear1.bias": r(ff),
        "transformer.layers.0.linear2.weight": r(d, ff),
        "transformer.layers.0.linear2.bias": r(d),
        "transformer.layers.0.norm1.weight": 1 + 0.1 * r(d),
        "transformer.layers.0.norm1.bias": r(d),
        "transformer.layers.0.norm2.weight": 1 + 0.1 * r(d),
        "transformer.layers.0.norm2.bias": r(d),
        "transformer.norm.weight": 1 + 0.1 * r(d),
        "transformer.norm.bias": r(d),
        "pooling.query.weight": r(1, d), "pooling.query.bias": r(1),
        "classifier.0.weight": r(4, d), "classifier.0.bias": r(4),
        "classifier.3.weight": r(2, 4), "classifier.3.bias": r(2)}
    for i, n in ((1, h), (5, d)):
        w[f"frontend.conv.{i}.weight"] = 1 + 0.1 * r(n)
        w[f"frontend.conv.{i}.bias"] = r(n)
        w[f"frontend.conv.{i}.running_mean"] = r(n)
        w[f"frontend.conv.{i}.running_var"] = 1 + np.abs(r(n))
    return w


def _audio(seed: int, n: int) -> np.ndarray:
    return (np.random.RandomState(seed).randn(n) * 0.1).astype(np.float32)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


def test_log_mel80_equals_jax():
    import jax.numpy as jnp

    from mlx_audio_tpu.stt.models.mega_asr.router import log_mel80 as jmel
    from mlx_audio_tpu_torch.stt.models.mega_asr.router import log_mel80

    for audio in (np.zeros(16000, np.float32), _audio(0, 12345)):
        got = log_mel80(audio).numpy()
        want = np.asarray(jmel(jnp.asarray(audio)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL)
    assert log_mel80(np.zeros(16000, np.float32)).shape == (101, 80)


@pytest.mark.parametrize("n", [4000, 16000, 16000 * 6 + 321])
def test_degraded_prob_equals_jax(routers, n):
    """Three time buckets (64, 128 and 512)."""
    jr, pr = routers
    audio = _audio(n, n)
    assert abs(pr.degraded_prob(audio) - jr.degraded_prob(audio)) < ATOL
    route = pr.route(audio)
    assert route["use_lora"] == (route["degraded_prob"] >= 0.5)


def test_converted_router_equals_jax():
    """The converted layout: convs from MLX (O, K, I), the fused qkv
    split, the batch norms folded."""
    from mlx_audio_tpu.stt.models.mega_asr import \
        AudioQualityRouter as JRouter
    from mlx_audio_tpu.stt.models.mega_asr.router import \
        load_router_params as jload
    from mlx_audio_tpu.utils import flatten
    from mlx_audio_tpu_torch.stt.models.mega_asr import AudioQualityRouter
    from mlx_audio_tpu_torch.stt.models.mega_asr.router import \
        load_router_params

    w = converted_router()
    got = load_router_params(w)
    want = {k: np.asarray(v) for k, v in flatten(jload(w)).items()}
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    audio = _audio(3, 20000)
    p = AudioQualityRouter.from_converted(w, device="cpu")
    assert abs(p.degraded_prob(audio)
               - JRouter.from_converted(w).degraded_prob(audio)) < ATOL


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    from mlx_audio_tpu.stt.models.mega_asr import Model as JModel
    from mlx_audio_tpu.stt.models.mega_asr import ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.stt.models.mega_asr import Model, ModelConfig

    jm = JModel(JConfig.from_dict(ASR_CFG))
    jm.bind(numpy_params(jm.init_params, 0))
    pm = load_jax_params(Model(ModelConfig.from_dict(ASR_CFG),
                               device="cpu"), flat_numpy(jm.params))
    jm._tokenizer = pm._tokenizer = FakeTok()
    return jm, pm


def write_factors(path, scale: float = 1.0, seed: int = 4) -> None:
    from safetensors.numpy import save_file

    rs = np.random.RandomState(seed)
    save_file({f"{Q_PATH}.lora_A": (rs.randn(2, 16) * scale).astype("f"),
               f"{Q_PATH}.lora_B": (rs.randn(16, 2) * scale).astype("f")},
              str(path))


def test_deltas_apply_and_remove_as_jax(pair, tmp_path):
    from mlx_audio_tpu.stt.models.mega_asr import apply_deltas as japply
    from mlx_audio_tpu.stt.models.mega_asr import \
        load_lora_factors as jfactors
    from mlx_audio_tpu_torch.model import jax_params, load_jax_params
    from mlx_audio_tpu_torch.stt.models.mega_asr import (
        Model, ModelConfig, apply_deltas, load_lora_factors)

    jm, pm = pair
    write_factors(tmp_path / "lora.safetensors")
    deltas = load_lora_factors(tmp_path / "lora.safetensors")
    jd = jfactors(tmp_path / "lora.safetensors")
    assert set(deltas) == set(jd) == {Q_PATH}
    m = load_jax_params(Model(ModelConfig.from_dict(ASR_CFG), device="cpu"),
                        {k: v.numpy() for k, v in jax_params(pm).items()})
    base = m.get_submodule(Q_PATH).weight.clone()
    apply_deltas(m, deltas, 1.0)
    jparams = japply(jax.tree_util.tree_map(lambda x: x, jm.params), jd, 1.0)
    w1 = m.get_submodule(Q_PATH).weight
    np.testing.assert_allclose(
        w1.numpy(), np.asarray(jparams["model"]["layers"]["0"]["self_attn"]
                               ["q_proj"]["weight"]), atol=1e-6)
    assert not torch.allclose(w1, base)
    apply_deltas(m, deltas, -1.0)
    np.testing.assert_allclose(m.get_submodule(Q_PATH).weight.numpy(),
                               base.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="delta"):
        apply_deltas(m, {Q_PATH: {"A": np.zeros((2, 8), "f"),
                                  "B": np.zeros((4, 2), "f"),
                                  "scaling": 1.0}})
    with pytest.raises(TypeError, match="model.norm"):
        apply_deltas(m, {"model.norm": {"A": np.zeros((2, 16), "f"),
                                        "B": np.zeros((16, 2), "f"),
                                        "scaling": 1.0}})


def test_adapter_toggle_restores_bf16_weights_exactly(pair, tmp_path):
    """Switching the adapter off gives back the very weights (bf16, where
    an add and a subtract do not)."""
    from mlx_audio_tpu_torch.model import jax_params, load_jax_params
    from mlx_audio_tpu_torch.stt.models.mega_asr import (
        Model, ModelConfig, load_lora_factors)

    _, pm = pair
    write_factors(tmp_path / "lora.safetensors", scale=0.37)
    m = load_jax_params(Model(ModelConfig.from_dict(ASR_CFG), device="cpu"),
                        {k: v.numpy() for k, v in jax_params(pm).items()})
    m.astype(torch.bfloat16)
    m.set_lora(load_lora_factors(tmp_path / "lora.safetensors"))
    base = m.get_submodule(Q_PATH).weight.clone()
    m._set_lora(True)
    on = m.get_submodule(Q_PATH).weight.clone()
    m._set_lora(False)
    assert not torch.equal(on, base)
    assert torch.equal(m.get_submodule(Q_PATH).weight, base)
    # the JAX package's way, add then subtract in bf16, is not exact here
    d = (torch.from_numpy(np.asarray(m._deltas[Q_PATH]["B"]))
         @ torch.from_numpy(np.asarray(m._deltas[Q_PATH]["A"]))).to(
        torch.bfloat16)
    assert not torch.equal(base + d - d, base)


def test_routed_requests_toggle_and_decode_as_jax(pair, tmp_path,
                                                  monkeypatch):
    """A route forced each way: the adapter follows it and the greedy text
    is JAX's, with the adapter on and off."""
    from mlx_audio_tpu.stt.models.mega_asr import \
        load_lora_factors as jfactors
    from mlx_audio_tpu_torch.stt.models.mega_asr import (
        AudioQualityRouter, load_lora_factors)

    jm, pm = pair
    write_factors(tmp_path / "l.safetensors", scale=0.3, seed=5)
    jm._deltas = jfactors(tmp_path / "l.safetensors")
    pm.set_lora(load_lora_factors(tmp_path / "l.safetensors"))
    jm._router = jax_router()
    pm._router = AudioQualityRouter(flat_numpy(jm._router.params),
                                    device="cpu")
    audio = _audio(5, 16000)
    texts = []
    for use in (True, False, True):
        forced = {"degraded_prob": 0.9 if use else 0.1, "use_lora": use}
        monkeypatch.setattr(jm._router, "route", lambda a, f=forced: f)
        monkeypatch.setattr(pm._router, "route", lambda a, f=forced: f)
        kw = dict(max_tokens=16, language="English")
        want = jm.generate(audio, **kw).text
        got = pm.generate(audio, **kw).text
        assert got == want
        assert pm._lora_active == jm._lora_active == use
        assert pm.last_route == forced
        texts.append(got)
    assert texts[0] == texts[2]
    monkeypatch.undo()
    pm.generate(audio, max_tokens=4, language="English")
    real = pm._router.route(audio)
    assert pm._lora_active == real["use_lora"] and pm.last_route == real
    pm._set_lora(False)
    pm._deltas, pm._router = {}, None


def test_streamed_request_routes_once(pair, tmp_path, monkeypatch):
    """`generate(stream=True)` runs the router once, and the adapter's
    factors wait on the model's device as f32 tensors."""
    from mlx_audio_tpu_torch.stt.models.mega_asr import (
        AudioQualityRouter, load_lora_factors)

    jm, pm = pair
    write_factors(tmp_path / "l.safetensors", scale=0.3, seed=5)
    pm.set_lora(load_lora_factors(tmp_path / "l.safetensors"))
    for part in ("A", "B"):
        f = pm._deltas[Q_PATH][part]
        assert isinstance(f, torch.Tensor) and f.dtype == torch.float32
        assert f.device == pm.device
    pm._router = AudioQualityRouter(flat_numpy(jax_router().params),
                                    device="cpu")
    calls = []
    forced = {"degraded_prob": 0.9, "use_lora": True}
    monkeypatch.setattr(pm._router, "route",
                        lambda a: calls.append(1) or forced)
    list(pm.generate(_audio(5, 16000), max_tokens=4, language="English",
                     stream=True))
    assert len(calls) == 1 and pm._lora_active
    pm.generate(_audio(5, 16000), max_tokens=4, language="English")
    assert len(calls) == 2
    pm._set_lora(False)
    pm._deltas, pm._router = {}, None


def test_load_model_reads_the_extras(pair, tmp_path):
    """A directory with extras/router.safetensors and extras/lora.
    safetensors through the router: MegaASR with both; an adapter on a
    linear the checkpoint packs raises at load, naming it."""
    from safetensors.numpy import load_file

    from chip_smoke import write_asr_checkpoint
    from mlx_audio_tpu_torch.stt.models.mega_asr import Model
    from mlx_audio_tpu_torch.utils import load_model

    _, pm = pair
    d = tmp_path / "mega-asr"
    write_factors(tmp_path / "lora.safetensors")
    lora = load_file(str(tmp_path / "lora.safetensors"))
    write_asr_checkpoint(pm, d, extras={
        "router.safetensors": converted_router(d=8), "lora.safetensors": lora})
    m = load_model(d, device="cpu")
    assert isinstance(m, Model) and set(m._deltas) == {Q_PATH}
    assert 0.0 <= m._router.degraded_prob(_audio(1, 16000)) <= 1.0
    # the same files beside an MLX-packed checkpoint (group 8)
    q = tmp_path / "mega-q8"
    write_asr_checkpoint(pm, q, bits=8, group_size=8,
                         extras={"lora.safetensors": lora})
    with pytest.raises(TypeError, match=Q_PATH):
        load_model(q, device="cpu")
