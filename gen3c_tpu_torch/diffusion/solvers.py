"""ODE solvers over the EDM sigma schedule (port of gen3c_tpu/diffusion/solvers.py).

Every solver consumes a denoiser x0_fn(x, sigma) -> x0 prediction and
integrates the probability-flow ODE dx/dsigma = (x - x0(x, sigma)) / sigma
from sigma_max to 0: euler (= ddim with eta 0 in sigma space), heun (EDM's
2nd order), rk4, res2mid (an exponential-integrator RK2 through the
geometric midpoint), and the two multistep rules at one network call a
step, res2ab (exponential-integrator Adams-Bashforth 2) and dpm2m
(DPM-Solver++(2M)). ``dpm2m_x0_step`` and ``res_x0_rk2_step`` are also the
sampler's multistep finishes.

The step functions compute their coefficients from fp32 scalars, as the
JAX package does under jit, and keep its guards for degenerate lanes
(t = 0 on the last step, s1 == s on the first): there a guard decides what
a select evaluated both ways, here a Python branch would have been enough,
but the numbers stay JAX's.
"""

from __future__ import annotations

from typing import Callable

import torch

from gen3c_tpu_torch.diffusion.scheduler import EDMEulerSchedule

X0Fn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

SOLVERS = ("euler", "heun", "dpm2m", "rk4", "ddim", "res2ab", "res2mid")


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _phi1(t: torch.Tensor) -> torch.Tensor:
    """(exp(t) - 1) / t; 1 at t = 0."""
    t_safe = torch.where(t == 0.0, torch.ones_like(t), t)
    return torch.where(t == 0.0, torch.ones_like(t), torch.expm1(t_safe) / t_safe)


def _phi2(t: torch.Tensor) -> torch.Tensor:
    """(phi1(t) - 1) / t; 1/2 at t = 0."""
    t_safe = torch.where(t == 0.0, torch.ones_like(t), t)
    return torch.where(t == 0.0, torch.full_like(t, 0.5), (_phi1(t_safe) - 1.0) / t_safe)


def dpm2m_x0_step(x_s: torch.Tensor, t, s, x0_s: torch.Tensor, s1, x0_s1: torch.Tensor
                  ) -> torch.Tensor:
    """DPM-Solver++(2M) from sigma s to t: x0 extrapolated from the current
    (s) and previous (s1) predictions, then the first-order exponential
    step. t = 0 steps to x0; s1 == s degrades to the first-order step."""
    t, s, s1 = (_f32(v, x_s) for v in (t, s, s1))
    t = torch.clamp_min(t, 1e-10)
    h = torch.log(t) - torch.log(s)
    h_last = torch.log(s) - torch.log(s1)
    r = h_last / h
    r_safe = torch.where(r == 0.0, torch.ones_like(r), r)
    coef = torch.where(r == 0.0, torch.zeros_like(r), 1.0 / (2.0 * r_safe))
    x0_bar = (1 + coef) * x0_s - coef * x0_s1
    return x_s * (t / s) + (1 - t / s) * x0_bar


def res_x0_rk2_step(x_s: torch.Tensor, t, s, x0_s: torch.Tensor, s1, x0_s1: torch.Tensor
                    ) -> torch.Tensor:
    """The residual (exponential-integrator) 2nd-order step in -log sigma
    time, behind the reference sampler's "2ab" multistep. t = 0 steps to
    about x0_s; s1 == s zeroes the second-order term."""
    t, s, s1 = (_f32(v, x_s) for v in (t, s, s1))
    t = torch.clamp_min(t, 1e-10)
    s_ = -torch.log(s)
    t_ = -torch.log(t)
    m_ = -torch.log(s1)
    dt = t_ - s_
    c2 = (m_ - s_) / dt
    c2_safe = torch.where(c2 == 0.0, torch.ones_like(c2), c2)
    p1, p2 = _phi1(-dt), _phi2(-dt)
    b2 = torch.where(c2 == 0.0, torch.zeros_like(c2), p2 / c2_safe)
    b1 = p1 - b2
    return torch.exp(-dt) * x_s + dt * (b1 * x0_s + b2 * x0_s1)


@torch.no_grad()
def sample_ode(x0_fn: X0Fn, init_noise: torch.Tensor, num_steps: int = 35,
               solver: str = "euler", schedule: EDMEulerSchedule = EDMEulerSchedule()
               ) -> torch.Tensor:
    """Integrate the PF-ODE from sigma_max to 0 with ``solver``; x0_fn gets
    x and a 0-d fp32 sigma. Returns the fp32 sample."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; expected one of {SOLVERS}")
    sig = torch.from_numpy(schedule.sigmas(num_steps)).to(init_noise.device)
    x = init_noise.float() * schedule.init_noise_sigma

    def d(x, sigma):
        sigma = torch.clamp_min(sigma, 1e-10)
        return (x - x0_fn(x, sigma)) / sigma

    if solver in ("euler", "ddim"):  # DDIM (eta 0) in sigma space is Euler
        for i in range(num_steps):
            s, s1 = sig[i], sig[i + 1]
            x = x + (s1 - s) * d(x, s)
        return x

    if solver == "heun":  # trapezoidal correction except on the step to 0
        for i in range(num_steps):
            s, s1 = sig[i], sig[i + 1]
            d0 = d(x, s)
            x_euler = x + (s1 - s) * d0
            if s1 > 0:
                x = x + (s1 - s) * 0.5 * (d0 + d(x_euler, s1))
            else:
                x = x_euler
        return x

    if solver == "rk4":
        for i in range(num_steps):
            s, s1 = sig[i], sig[i + 1]
            h = s1 - s
            sm = s + 0.5 * h
            k1 = d(x, s)
            if s1 > 0:
                k2 = d(x + 0.5 * h * k1, sm)
                k3 = d(x + 0.5 * h * k2, sm)
                k4 = d(x + h * k3, torch.clamp_min(s1, 1e-8))
                x = x + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
            else:
                x = x + h * k1
        return x

    if solver == "res2mid":
        # Euler to the geometric midpoint, then the 2nd-order step from both
        # x0 predictions; the step to 0 is the plain first-order one
        for i in range(num_steps):
            s, t = sig[i], sig[i + 1]
            x0_s = x0_fn(x, torch.clamp_min(s, 1e-10))
            if t > 0:
                s1 = torch.sqrt(torch.clamp_min(s * t, 1e-20))
                x_s1 = x * (s1 / s) + (1 - s1 / s) * x0_s
                x = res_x0_rk2_step(x, t, s, x0_s, s1, x0_fn(x_s1, s1))
            else:
                x = x * (t / s) + (1 - t / s) * x0_s
        return x

    # res2ab / dpm2m: the first-order step on the first and the last step,
    # the multistep rule from the previous x0 in between
    step = res_x0_rk2_step if solver == "res2ab" else dpm2m_x0_step
    prev_x0 = x
    for i in range(num_steps):
        s, s1 = sig[i], sig[i + 1]
        x0 = x0_fn(x, s)
        if i > 0 and s1 > 0:
            x = step(x, s1, s, x0, sig[max(i - 1, 0)], prev_x0)
        else:
            x = x * (s1 / s) + (1 - s1 / s) * x0
        prev_x0 = x0
    return x
