"""What the card scripts and ``chip_smoke.py`` share: the card's name and
power limit as nvidia-smi gives them, and the seeded DiT's gates."""

from __future__ import annotations

import subprocess

import torch


def nvidia_smi_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    first line, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def randomize_gates(net: torch.nn.Module, gen: torch.Generator) -> None:
    """Random AdaLN output layers and final linear of a DiT (a fresh init has
    them zero, which makes the network's output identically zero)."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("adaLN_modulation.2.weight") or name == "final_layer.linear.weight":
                p.copy_(0.1 * torch.randn(p.shape, generator=gen, device=p.device))
