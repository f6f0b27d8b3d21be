"""DDIM scheduler (functional).

JAX counterpart: ``dge_tpu/diffusion/ddim.py``. Reference analog: the
DDIMScheduler the guidance loads from SD-1.4's scheduler config
(dge_guidance.py:75-135): scaled-linear betas 0.00085 -> 0.012 over 1000
train steps, steps_offset=1, clip_sample=False, set_alpha_to_one=False, 20
inference steps, eta=0 (deterministic).

Result dtypes follow JAX's promotion: the schedule is f32, so bf16 noise
predictions, latents or noise give f32 results (``promote``).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from dge_tpu_torch import resolve_device


class DDIMSchedule(NamedTuple):
    betas: torch.Tensor  # [T]
    alphas_cumprod: torch.Tensor  # [T]
    final_alpha_cumprod: torch.Tensor  # scalar
    num_train_timesteps: int
    steps_offset: int


def make_schedule(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                  beta_end: float = 0.012, set_alpha_to_one: bool = False,
                  steps_offset: int = 1, device="cuda") -> DDIMSchedule:
    dev = resolve_device(device)
    # scaled_linear: linspace in sqrt-beta space
    betas = (np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                         num_train_timesteps) ** 2).astype(np.float32)
    alphas_cumprod = np.cumprod(1.0 - betas)
    final = np.float32(1.0) if set_alpha_to_one else alphas_cumprod[0]
    return DDIMSchedule(
        betas=torch.from_numpy(betas).to(dev),
        alphas_cumprod=torch.from_numpy(alphas_cumprod).to(dev),
        final_alpha_cumprod=torch.tensor(final, device=dev),
        num_train_timesteps=num_train_timesteps,
        steps_offset=steps_offset,
    )


def inference_timesteps(sched: DDIMSchedule,
                        num_inference_steps: int) -> np.ndarray:
    """Descending timesteps (diffusers set_timesteps 'leading' spacing +
    steps_offset)."""
    ratio = sched.num_train_timesteps // num_inference_steps
    ts = (np.arange(num_inference_steps) * ratio).round()[::-1].astype(
        np.int64)
    return ts + sched.steps_offset


def promote(*xs: torch.Tensor) -> List[torch.Tensor]:
    """The tensors cast to their common dtype by JAX's rule, in which an f32
    array of any rank promotes bf16 to f32. torch leaves a bf16 tensor bf16
    against a 0-dim f32 one (``bf16 * torch.tensor(0.5)`` is bf16), so a
    schedule entry indexed down to a scalar would keep bf16 latents bf16
    where JAX makes them f32."""
    dt = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    return [x.to(dt) for x in xs]


def add_noise(sched: DDIMSchedule, x0: torch.Tensor, noise: torch.Tensor,
              t: Union[int, torch.Tensor]) -> torch.Tensor:
    a = sched.alphas_cumprod[torch.as_tensor(t, device=x0.device)]
    shape = (-1,) + (1,) * (x0.dim() - 1)
    return (torch.sqrt(a).reshape(shape) * x0
            + torch.sqrt(1.0 - a).reshape(shape) * noise)


def step(sched: DDIMSchedule, model_output: torch.Tensor, t: int,
         sample: torch.Tensor, num_inference_steps: int, eta: float = 0.0,
         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One DDIM update x_t -> x_{t_prev} (epsilon parameterisation,
    clip_sample=False); ``t`` is the current timestep. f32 from bf16
    inputs, as in JAX."""
    ratio = sched.num_train_timesteps // num_inference_steps
    prev_t = int(t) - ratio
    a_t = sched.alphas_cumprod[int(t)]
    a_prev = (sched.alphas_cumprod[prev_t] if prev_t >= 0
              else sched.final_alpha_cumprod)
    model_output, sample, a_t, a_prev = promote(model_output, sample, a_t,
                                                a_prev)
    if noise is not None:
        noise = noise.to(sample.dtype)
    x0 = pred_x0(sched, model_output, int(t), sample)
    if eta > 0.0:
        var = (1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev)
        sigma = eta * torch.sqrt(var)
    else:
        sigma = 0.0
    dir_xt = torch.sqrt(1.0 - a_prev - sigma ** 2) * model_output
    prev = torch.sqrt(a_prev) * x0 + dir_xt
    if eta > 0.0 and noise is not None:
        prev = prev + sigma * noise
    return prev


def pred_x0(sched: DDIMSchedule, model_output: torch.Tensor,
            t: Union[int, torch.Tensor], sample: torch.Tensor
            ) -> torch.Tensor:
    """The clean sample that the predicted noise ``model_output`` implies at
    timestep ``t`` (a scalar): ``(x_t - sqrt(1 - a_t)·eps) / sqrt(a_t)``;
    f32 from bf16 inputs, as in JAX."""
    model_output, sample, a_t = promote(model_output, sample,
                                        sched.alphas_cumprod[t])
    return (sample - torch.sqrt(1.0 - a_t) * model_output) / torch.sqrt(a_t)
