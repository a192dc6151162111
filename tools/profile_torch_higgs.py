"""Profile Higgs Audio v2 (the higgs_v2_3b_bf16 and _q8 lanes) of the
PyTorch port on one GPU.

    python3 tools/profile_torch_higgs.py

Run from the repository root on a machine with an NVIDIA GPU. Builds the
model of chip_smoke.py's phase 20 (ModelConfig() dims, every floating
parameter drawn N(0, 0.02) on the card in f32 from seed 0, cast to bf16)
and the lane's prompt (480 embeds of `randn * 0.02`, seed 0, bucket 512,
cache 1,024). It times the prefill and one 16-frame chunk warm, then runs
each once more under torch.profiler with CPU and CUDA activities; then the
codec's decode of 242 frames at CodecConfig() dims in bf16; then the same
backbone in W8A8 (affine 8-bit codes, group 64, then the int8 layout, as
bench.py:414-426) for one more chunk. For each it prints the wall, the
device's busy time and share of the unprofiled wall, the kernels launched
(a frame for a chunk), and device time by kernel.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.profile_torch_voxtral import _profiled  # noqa: E402
from tools.profile_torch_whisper import _wall  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from mlx_audio_tpu_torch.codec.models.higgs_audio import (
        Model as Codec, ModelConfig as CodecConfig)
    from mlx_audio_tpu_torch.tts.models.higgs_audio.higgs_audio import (
        CHUNK_FRAMES, Sampling)
    from mlx_audio_tpu_torch.utils import apply_quantization

    card = cs.phase_device()
    print(card, flush=True)
    model = cs.build_higgs_full().astype(torch.bfloat16)
    torch.cuda.empty_cache()
    t = model.config.text
    emb = torch.from_numpy((np.random.RandomState(0).randn(
        1, 512, t.hidden_size) * 0.02).astype(np.float32)).cuda().to(
        torch.bfloat16)
    mask = torch.zeros(1, 512, dtype=torch.bool, device="cuda")
    sampling = Sampling(0.7, 0.95, 0, 7, 2, 0)

    def prefill():
        return model.prefill(emb, mask, cs.HIGGS_PLEN, 1024, seed=0)[0]

    _profiled(prefill, "bf16 prefill, 512 rows", _wall(prefill), card)

    def chunks(name: str):
        carry = prefill()

        def chunk():
            return model.chunk(carry, sampling)

        _profiled(chunk, f"{name} chunk of {CHUNK_FRAMES} frames",
                  _wall(chunk), card, (CHUNK_FRAMES, "frame"))

    chunks("bf16")
    codec = Codec(CodecConfig(), device="cuda").init_params(seed=0,
                                                            on_device=True)
    codec.astype(torch.bfloat16)
    codes = np.random.RandomState(1).randint(
        0, 1024, (cs.HIGGS_CODEC_FRAMES, 8)).astype(np.int32)

    def decode():
        return codec.decode(codes)

    _profiled(decode, f"codec decode of {cs.HIGGS_CODEC_FRAMES} frames, bf16",
              _wall(decode), card)
    apply_quantization(model, {"quantization": {
        "bits": 8, "group_size": 64, "mxu_int8": True}},
        model.model_quant_predicate)
    torch.cuda.empty_cache()
    chunks("W8A8")
    return 0


if __name__ == "__main__":
    sys.exit(main())
