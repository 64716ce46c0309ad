"""YAML config composition engine (Hydra-like semantics, zero deps).

The port's copy of `iltpu/config/core.py`: the same composition, override
grammar, aliases and validation, reading its own copies of the YAML files
(`iltpu_torch/config/conf/`) through the in-package subset reader
(`yaml_subset`) instead of PyYAML.

Mirrors the reference's Hydra tree behaviour (conf/train_config.yaml:1-4,
SURVEY.md C21) without Hydra: composition order is

    base train.yaml
    -> algorithm overlay (algorithms.yaml[<ALG>])
    -> optional tuned overlay (tuned.yaml[<ALG>][<trajectories>])
    -> dotted CLI overrides ("a.b.c=value", YAML-parsed scalars)

plus the reference's startup invariants (train.py:28-48) in
`validate_config`. Configs are plain nested dicts wrapped in `DotDict` for
attribute access; `to_flat` serialises for logging/sweeps.
"""

import copy
import os
import re
from typing import Any, Dict, List, Optional

from iltpu_torch.config import yaml_subset

CONF_DIR = os.path.join(os.path.dirname(__file__), "conf")

ALGORITHMS = ["AdRIL", "BC", "DRIL", "GAIL", "GMMIL", "PWIL", "RED", "SAC"]


class DotDict(dict):
    """Nested dict with attribute access; mutations write through."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return DotDict(v) if isinstance(v, dict) and not isinstance(v, DotDict) else v

    def __setattr__(self, name: str, value: Any):
        self[name] = value


def deep_merge(base: Dict, overlay: Dict) -> Dict:
    """Recursive dict merge; overlay wins, nested dicts merge key-wise."""
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def set_by_path(cfg: Dict, path: str, value: Any):
    keys = path.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def get_by_path(cfg: Dict, path: str, default: Any = None) -> Any:
    node = cfg
    for k in path.split("."):
        if not isinstance(node, dict) or k not in node:
            return default
        node = node[k]
    return node


def parse_overrides(overrides: List[str]) -> Dict[str, Any]:
    """["a.b=1", "c=relu"] -> {"a.b": 1, "c": "relu"} with YAML scalar
    parsing (so 1e-4, true, .inf, null all become proper types)."""
    out = {}
    for item in overrides:
        assert "=" in item, f"override '{item}' is not of the form key=value"
        key, _, raw = item.partition("=")
        value = yaml_subset.scalar(raw) if raw != "" else None
        if isinstance(value, str):
            # YAML 1.1 misses bare scientific floats like "1e-4"
            try:
                value = float(value)
            except ValueError:
                pass
        out[key.strip()] = value
    return out


def _load_yaml(name: str, conf_dir: str) -> Dict:
    with open(os.path.join(conf_dir, name)) as f:
        return yaml_subset.loads(f.read()) or {}


def load_config(
    overrides: Optional[List[str]] = None,
    *,
    conf_dir: str = CONF_DIR,
    use_tuned: bool = False,
) -> DotDict:
    """Compose the training config. `overrides` are dotted key=value strings;
    `algorithm=X` must appear there (or default SAC applies) and selects the
    overlay, matching `python train.py algorithm=X` (README.md:66-98).
    `use_tuned` layers the published optimised hyperparameters for
    (algorithm, imitation.trajectories) when available."""
    overrides = parse_overrides(list(overrides or []))
    cfg = _load_yaml("train.yaml", conf_dir)

    algorithm = overrides.get("algorithm", cfg.get("algorithm", "SAC"))
    # Convenience aliases: in the reference these are option settings on
    # AdRIL/GAIL, not algorithm names (README.md:27,35-37).
    alias_overrides = {
        "SQIL": ("AdRIL", {"imitation.update_freq": 0}),
        "AIRL": (
            "GAIL",
            {
                "imitation.discriminator.reward_shaping": True,
                "imitation.discriminator.subtract_log_policy": True,
                "imitation.discriminator.reward_function": "AIRL",
            },
        ),
        "FAIRL": ("GAIL", {"imitation.discriminator.reward_function": "FAIRL"}),
    }
    if algorithm in alias_overrides:
        algorithm, extra = alias_overrides[algorithm]
        overrides["algorithm"] = algorithm  # resolved name drives dispatch
        for key, value in extra.items():
            overrides.setdefault(key, value)
    assert algorithm in ALGORITHMS, f"unknown algorithm {algorithm}"
    alg_overlays = _load_yaml("algorithms.yaml", conf_dir)
    cfg = deep_merge(cfg, alg_overlays.get(algorithm) or {})
    cfg["algorithm"] = algorithm

    # The reference's exact overlay syntax (README.md:73-76):
    # `optimised_hyperparameters=<ALG>_<N>_trajectories` selects the tuned
    # overlay for (algorithm, N trajectories) — equivalent to `--tuned` with
    # `imitation.trajectories=N`. Accepted verbatim so reference commands
    # run unchanged.
    # (`null` arrives as Python None already — parse_overrides YAML-parses
    # values — so a plain None check suffices.)
    opt_hp = overrides.pop("optimised_hyperparameters", None)
    tuned_n = None
    if opt_hp is not None:
        m = re.fullmatch(r"(\w+?)_(\d+)_trajectories", str(opt_hp))
        assert m, (
            "optimised_hyperparameters must be <ALG>_<N>_trajectories,"
            f" got {opt_hp!r}"
        )
        assert m.group(1) == algorithm, (
            f"optimised_hyperparameters names {m.group(1)} but"
            f" algorithm={algorithm} (the reference also requires both,"
            " README.md:73-74)"
        )
        # The NAMED overlay's hyperparameters apply even when
        # imitation.trajectories is overridden separately (Hydra semantics:
        # the config group is selected by name, the count is just a value).
        tuned_n = int(m.group(2))
        overrides.setdefault("imitation.trajectories", tuned_n)
        use_tuned = True

    if use_tuned:
        trajectories = tuned_n
        if trajectories is None:
            trajectories = overrides.get(
                "imitation.trajectories",
                get_by_path(cfg, "imitation.trajectories"),
            )
        tuned = _load_yaml("tuned.yaml", conf_dir)
        overlay = (tuned.get(algorithm) or {}).get(trajectories)
        if tuned_n is not None:
            # An explicitly named overlay that doesn't exist must fail fast
            # (the reference's Hydra config group does), not silently run
            # with untuned hyperparameters.
            assert overlay, (
                f"no tuned overlay for {algorithm} at {trajectories}"
                " trajectories (tuned.yaml)"
            )
        if overlay:
            cfg = deep_merge(cfg, overlay)

    for key, value in overrides.items():
        set_by_path(cfg, key, value)
    return DotDict(cfg)


def validate_config(cfg: Dict) -> DotDict:
    """Startup invariants, mirroring train.py:28-48 (including the runtime
    memory-size clamp at train.py:30)."""
    cfg = DotDict(copy.deepcopy(cfg))
    assert cfg["algorithm"] in ALGORITHMS
    set_by_path(cfg, "memory.size", min(cfg["steps"], get_by_path(cfg, "memory.size")))
    assert get_by_path(cfg, "bc_pretraining.iterations") >= 0
    assert get_by_path(cfg, "imitation.trajectories") >= 0
    assert get_by_path(cfg, "imitation.subsample") >= 1
    assert get_by_path(cfg, "imitation.mix_expert_data") in (
        "none",
        "mixed_batch",
        "prefill_memory",
    )
    alg = cfg["algorithm"]
    g = lambda p: get_by_path(cfg, p)
    if alg == "AdRIL":
        assert g("imitation.mix_expert_data") == "mixed_batch"
        assert g("imitation.update_freq") >= 0
    elif alg == "DRIL":
        assert 0 <= g("imitation.quantile_cutoff") <= 1
    elif alg == "GAIL":
        assert g("imitation.mix_expert_data") != "prefill_memory"
        assert g("imitation.discriminator.reward_function") in ("AIRL", "FAIRL", "GAIL")
        assert g("imitation.grad_penalty") >= 0
        assert g("imitation.entropy_bonus") >= 0
        assert g("imitation.loss_function") in ("BCE", "Mixup", "PUGAIL")
        if g("imitation.loss_function") == "Mixup":
            assert g("imitation.mixup_alpha") > 0
        if g("imitation.loss_function") == "PUGAIL":
            assert 0 <= g("imitation.pos_class_prior") <= 1
            assert g("imitation.nonnegative_margin") >= 0
    assert g("logging.interval") >= 0
    assert g("num_envs") >= 1
    return cfg


def to_flat(cfg: Dict, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in cfg.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(to_flat(v, key))
        else:
            out[key] = v
    return out
