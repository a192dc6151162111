"""DPM-Solver++ multistep tables for the VibeVoice diffusion head.

The port's own copy of mlx_audio_tpu/tts/models/vibevoice/scheduler.py
(numpy only), kept equal to it: `dpm_tables` (:24) for VibeVoice's ODE
solver and `sde_dpm_tables` (:77) for KugelAudio's stochastic one. Every
per-step scalar depends only on (num_train_timesteps, num_inference_steps,
beta_schedule), so the tables are computed once on the host; the order-1 /
order-2 choice is the `use_first` row, and exp(-h) = 0 and sigma_ratio = 0
at the last step are folded in. The samplers (vibevoice.py
`diffusion_sample`, kugelaudio.py `Model.sde_sample`) read them as host
floats.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=8)
def dpm_tables(num_train_timesteps: int, num_inference_steps: int,
               beta_schedule: str = "cosine") -> dict:
    """Per-inference-step DPM-Solver++ constants, stacked (N, ...) float32.

    Returns dict of np arrays keyed: t (train timestep as float), alpha,
    sigma (for v-pred x0), sigma_ratio, alpha_next, em1 (= exp(-h) - 1),
    inv_r0 (= h/h0, 0 where undefined), use_first (1.0 where the step is
    first-order: step 0 and the final step).
    """
    n_train, n = num_train_timesteps, num_inference_steps
    if beta_schedule in ("cosine", "scaled_linear", "squaredcos_cap_v2"):
        i = np.arange(n_train, dtype=np.float64)
        ab = lambda t: np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2  # noqa: E731
        betas = np.minimum(1 - ab((i + 1) / n_train) / ab(i / n_train), 0.999)
    elif beta_schedule == "linear":
        betas = np.linspace(1e-4, 0.02, n_train)
    else:
        raise ValueError(f"Unknown beta_schedule: {beta_schedule}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    alpha_bar_sqrt = np.sqrt(alphas_cumprod)

    timesteps = [int(round((n_train - 1) * (1.0 - k / n))) for k in range(n)]
    alpha, sigma, lam = [], [], []
    for t in timesteps:
        s = np.sqrt((1 - alpha_bar_sqrt[t] ** 2) / alpha_bar_sqrt[t] ** 2)
        a = 1.0 / np.sqrt(s ** 2 + 1.0)
        alpha.append(a)
        sigma.append(s * a)
        lam.append(np.log(a) - np.log(s * a))
    alpha.append(1.0)
    sigma.append(0.0)
    lam.append(np.inf)

    sigma_ratio = np.array([sigma[k + 1] / sigma[k] if sigma[k] > 0 else 0.0
                            for k in range(n)])
    alpha_next = np.array(alpha[1:n + 1])
    h = np.array([lam[k + 1] - lam[k] for k in range(n)])
    with np.errstate(over="ignore"):
        em1 = np.exp(-h) - 1.0          # exp(-inf) = 0 at the final step
    h0 = np.array([lam[k] - lam[k - 1] if k > 0 else 0.0 for k in range(n)])
    inv_r0 = np.where(h0 != 0, np.divide(h, np.where(h0 != 0, h0, 1.0)), 0.0)
    use_first = np.zeros(n)
    use_first[0] = 1.0
    use_first[-1] = 1.0                 # final_sigmas_type == "zero"

    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"t": f32(timesteps), "alpha": f32(alpha[:n]),
            "sigma": f32(sigma[:n]), "sigma_ratio": f32(sigma_ratio),
            "alpha_next": f32(alpha_next), "em1": f32(em1),
            "inv_r0": f32(inv_r0), "use_first": f32(use_first)}


@lru_cache(maxsize=8)
def sde_dpm_tables(num_train_timesteps: int, num_inference_steps: int,
                   beta_schedule: str = "cosine") -> dict:
    """SDE-DPM-Solver++ per-step constants (KugelAudio's stochastic variant,
    parity: tts/models/kugelaudio/scheduler.py :19-77).

    Update: prev = a_sample*x + b_x0*x0 + 0.5*b_x0*D1 (order 2)
                  + c_noise*N(0, I), with
      a_sample = (sigma_next/sigma) * exp(-h)
      b_x0     = alpha_next * (1 - exp(-2h))
      c_noise  = sigma_next * sqrt(1 - exp(-2h))
    All branch selection (order-1 at step 0 and the final step) is folded
    into `use_first`, so the sampler loop has no branch on the data.
    """
    base = dpm_tables(num_train_timesteps, num_inference_steps,
                      beta_schedule)
    n = num_inference_steps
    # rebuild alpha/sigma/lambda ladders (incl. the final zero-sigma entry)
    sigma = np.concatenate([base["sigma"], [0.0]]).astype(np.float64)
    alpha = np.concatenate([base["alpha"], [1.0]]).astype(np.float64)
    lam = np.where(sigma > 0, np.log(alpha) - np.log(np.maximum(sigma,
                                                                1e-30)),
                   np.inf)
    h = np.array([lam[k + 1] - lam[k] for k in range(n)])
    with np.errstate(over="ignore"):
        exp_h = np.exp(-h)
        exp_2h = np.exp(-2.0 * h)
    a_sample = np.array([sigma[k + 1] / sigma[k] if sigma[k] > 0 else 0.0
                         for k in range(n)]) * exp_h
    b_x0 = alpha[1:n + 1] * (1.0 - exp_2h)
    c_noise = sigma[1:n + 1] * np.sqrt(np.clip(1.0 - exp_2h, 0.0, None))

    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"t": base["t"], "alpha": base["alpha"], "sigma": base["sigma"],
            "a_sample": f32(a_sample), "b_x0": f32(b_x0),
            "c_noise": f32(c_noise), "inv_r0": base["inv_r0"],
            "use_first": base["use_first"]}
