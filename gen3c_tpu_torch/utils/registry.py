"""Experiment names and CLI-style dotted overrides (the part of
gen3c_tpu/utils/registry.py the port's trainer needs: its built-in
experiment names, on the port's presets)."""

from __future__ import annotations

import ast
import dataclasses
from typing import Any, Dict, Iterable


def experiments() -> Dict[str, Any]:
    """Every experiment name gen3c_tpu registers (registry.py:104-151) and
    its preset: the GEN3C presets and GEN3C_Cosmos_7B (the 7B), the
    Cosmos text2world / video2world and multiview presets, the instruction
    family (the GEN3C DiT on [x | mask], 17 input channels) and the action
    family (an ActionDiTConfig on the same 17 channels)."""
    from gen3c_tpu_torch.models.dit_action import ActionDiTConfig
    from gen3c_tpu_torch.pipelines.factory import GEN3C_7B_PRESET, GEN3C_TINY_PRESET, PRESETS
    from gen3c_tpu_torch.pipelines.text2world import T2W_PRESETS
    from gen3c_tpu_torch.pipelines.text2world_multiview import MV_PRESETS

    exps = {**PRESETS, "GEN3C_Cosmos_7B": GEN3C_7B_PRESET, **T2W_PRESETS, **MV_PRESETS}
    for size, base in (("tiny", GEN3C_TINY_PRESET), ("7b", GEN3C_7B_PRESET)):
        dit = base.dit
        name = f"video2world_instruction_{size}"
        exps[name] = dataclasses.replace(base, name=name, dit=dataclasses.replace(
            dit, in_channels=dit.out_channels + 1))
        action = ActionDiTConfig(**{f.name: getattr(dit, f.name)
                                    for f in dataclasses.fields(type(dit))})
        name = f"video2world_action_{size}"
        exps[name] = dataclasses.replace(base, name=name, dit=dataclasses.replace(
            action, in_channels=dit.out_channels + 1))
    return exps


def get_experiment(name: str) -> Any:
    """The port's preset for an experiment name (``experiments``)."""
    exps = experiments()
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
