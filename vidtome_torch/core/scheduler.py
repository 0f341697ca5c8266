"""DDIM scheduler: closed-form deterministic sampling and inversion updates.

Counterpart of ``vidtome_tpu/core/scheduler.py``: scaled-linear betas
8.5e-4 -> 1.2e-2 over 1000 train steps, ``steps_offset=1``, leading
timestep spacing, ``set_alpha_to_one=False``.  The tables are host numpy;
the two updates are plain tensor arithmetic in fp32 whose result the caller
casts back to the latent dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    """Deterministic DDIM schedule over a subsampled timestep grid.

    Attributes:
      timesteps: [S] int32, descending (sampling order), e.g. [981, ... 1].
      alphas_cumprod: [T] float32 over all train timesteps.
      final_alpha_cumprod: alpha-bar used at the boundary step.
    """

    num_train_timesteps: int
    timesteps: np.ndarray
    alphas_cumprod: np.ndarray
    final_alpha_cumprod: float

    @staticmethod
    def create(
        num_inference_steps: int,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        steps_offset: int = 1,
        set_alpha_to_one: bool = False,
    ) -> "DDIMScheduler":
        if beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                                num_train_timesteps, dtype=np.float64) ** 2
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                                dtype=np.float64)
        else:
            raise ValueError(f"unknown beta_schedule: {beta_schedule}")
        alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)

        step_ratio = num_train_timesteps // num_inference_steps
        timesteps = (np.arange(num_inference_steps) * step_ratio).round()[::-1]
        timesteps = (timesteps + steps_offset).astype(np.int32)

        final_alpha = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])
        return DDIMScheduler(
            num_train_timesteps=num_train_timesteps,
            timesteps=timesteps,
            alphas_cumprod=alphas_cumprod,
            final_alpha_cumprod=final_alpha,
        )

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    def sample_alpha_pair(self, i: int) -> tuple[float, float]:
        """(alpha_bar_t, alpha_bar_prev) for denoising step ``i`` (0 = most
        noisy); the last step's previous alpha-bar is ``final_alpha_cumprod``."""
        a_t = self.alphas_cumprod[self.timesteps[i]]
        a_prev = (self.alphas_cumprod[self.timesteps[i + 1]]
                  if i + 1 < self.num_steps else self.final_alpha_cumprod)
        return float(a_t), float(np.float32(a_prev))

    def inversion_alpha_pair(self, i: int) -> tuple[float, float]:
        """(alpha_bar_t, alpha_bar_prev) for inversion step ``i``, walking
        the timesteps in ascending order; step 0's previous alpha-bar is
        ``final_alpha_cumprod``."""
        ts_up = self.timesteps[::-1]
        a_t = self.alphas_cumprod[ts_up[i]]
        a_prev = (self.alphas_cumprod[ts_up[i - 1]] if i > 0
                  else self.final_alpha_cumprod)
        return float(a_t), float(np.float32(a_prev))


def _sqrt32(a: float) -> float:
    # sqrt in fp32, as the reference computes it on fp32 table entries
    return float(np.sqrt(np.float32(a)))


def ddim_step(x: torch.Tensor, eps: torch.Tensor, alpha_t: float,
              alpha_prev: float) -> torch.Tensor:
    """One deterministic DDIM denoising update x_t -> x_{t-1}, in fp32."""
    mu, sigma = _sqrt32(alpha_t), _sqrt32(1.0 - np.float32(alpha_t))
    mu_prev = _sqrt32(alpha_prev)
    sigma_prev = _sqrt32(1.0 - np.float32(alpha_prev))
    pred_x0 = (x.float() - sigma * eps.float()) / mu
    return mu_prev * pred_x0 + sigma_prev * eps.float()


def ddim_inverse_step(x: torch.Tensor, eps: torch.Tensor, alpha_t: float,
                      alpha_prev: float) -> torch.Tensor:
    """One DDIM inversion update x_{t-1} -> x_t, in fp32: reconstruct x0
    under the previous (less noisy) alpha-bar, renoise under the current."""
    mu, sigma = _sqrt32(alpha_t), _sqrt32(1.0 - np.float32(alpha_t))
    mu_prev = _sqrt32(alpha_prev)
    sigma_prev = _sqrt32(1.0 - np.float32(alpha_prev))
    pred_x0 = (x.float() - sigma_prev * eps.float()) / mu_prev
    return mu * pred_x0 + sigma * eps.float()

