"""EMA weight tracking (port of gen3c_tpu/training/ema.py): the EMA is a
dict of fp32 tensors, one per trained parameter, updated in place."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Iterable[Tuple[str, torch.Tensor]],
               beta: torch.Tensor) -> None:
    """ema <- beta * ema + (1 - beta) * params, in the EMA's dtype (fp32),
    in place."""
    for name, p in params:
        e = ema[name]
        e.copy_(beta * e + (1.0 - beta) * p.to(e.dtype))


def power_ema_beta(iteration: int, exp: float = 0.6667) -> torch.Tensor:
    """PowerEMATracker beta (1 - 1/i)^(exp + 1) with i = max(iteration, 1),
    an fp32 scalar tensor as gen3c_tpu computes it."""
    i = torch.clamp(torch.tensor(float(iteration), dtype=torch.float32), min=1.0)
    return (1.0 - 1.0 / i) ** (exp + 1.0)
