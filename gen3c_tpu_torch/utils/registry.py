"""Experiment names and CLI-style dotted overrides (the part of
gen3c_tpu/utils/registry.py the port's trainer needs; that module's
built-in registrations import the JAX presets)."""

from __future__ import annotations

import ast
import dataclasses
from typing import Any, Iterable


def get_experiment(name: str) -> Any:
    """The port's preset for an experiment name: gen3c_tiny, gen3c_7b, or
    GEN3C_Cosmos_7B (the 7B)."""
    from gen3c_tpu_torch.pipelines.factory import GEN3C_7B_PRESET, PRESETS

    exps = {**PRESETS, "GEN3C_Cosmos_7B": GEN3C_7B_PRESET}
    if name not in exps:
        raise KeyError(f"unknown experiment '{name}'; available: {sorted(exps)}")
    return exps[name]


def apply_overrides(cfg: Any, overrides: Iterable[str]) -> Any:
    """Apply "a.b.c=value" overrides to nested dicts/dataclasses (values
    parsed as Python literals, else kept as strings). Dataclasses are
    rebuilt with dataclasses.replace (frozen-safe)."""

    def parse(v: str) -> Any:
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v

    def set_path(obj: Any, keys: list, value: Any) -> Any:
        k = keys[0]
        if len(keys) > 1:
            child = getattr(obj, k) if dataclasses.is_dataclass(obj) else obj[k]
            value = set_path(child, keys[1:], value)
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(obj, **{k: value})
        return {**obj, k: value}

    for ov in overrides:
        key, _, raw = ov.partition("=")
        cfg = set_path(cfg, key.strip().split("."), parse(raw.strip()))
    return cfg
