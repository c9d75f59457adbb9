"""EDM Euler schedule (Karras et al. 2022); port of
gen3c_tpu/diffusion/scheduler.py. The sigma and c_noise tables are the
same fp32 numpy arrays; the preconditioning coefficients are scalars."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class EDMEulerSchedule:
    sigma_min: float = 0.0002
    sigma_max: float = 80.0
    sigma_data: float = 0.5
    rho: float = 7.0

    @property
    def init_noise_sigma(self) -> float:
        return float((self.sigma_max ** 2 + 1) ** 0.5)

    def sigmas(self, num_steps: int) -> np.ndarray:
        """num_steps + 1 karras sigmas, the last one 0."""
        ramp = np.linspace(0, 1, num_steps)
        min_inv = self.sigma_min ** (1 / self.rho)
        max_inv = self.sigma_max ** (1 / self.rho)
        s = (max_inv + ramp * (min_inv - max_inv)) ** self.rho
        return np.concatenate([s, [0.0]]).astype(np.float32)

    def timesteps(self, num_steps: int) -> np.ndarray:
        """c_noise fed to the network: 0.25 * ln(sigma)."""
        return (0.25 * np.log(self.sigmas(num_steps)[:-1])).astype(np.float32)

    def c_in(self, sigma):
        return 1.0 / (sigma ** 2 + self.sigma_data ** 2) ** 0.5

    def c_skip(self, sigma):
        return self.sigma_data ** 2 / (sigma ** 2 + self.sigma_data ** 2)

    def c_out(self, sigma):
        return sigma * self.sigma_data / (sigma ** 2 + self.sigma_data ** 2) ** 0.5

    def precondition_outputs(self, x, model_output, sigma):
        return self.c_skip(sigma) * x + self.c_out(sigma) * model_output

    def step(self, model_output, x, sigma, sigma_next):
        """One Euler step from sigma to sigma_next."""
        denoised = self.precondition_outputs(x, model_output, sigma)
        return x + (sigma_next - sigma) * ((x - denoised) / sigma)

    def reverse_precondition_output(self, latent, xt, sigma):
        """The model output that makes precondition_outputs return latent."""
        return (latent - self.c_skip(sigma) * xt) / self.c_out(sigma)
