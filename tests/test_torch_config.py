"""The port's config engine (iltpu_torch/config) against iltpu's: the same
dicts over the override lists of tests/test_config.py, the YAML subset
reader against yaml.safe_load on each copied file, and the copies
byte-equal to iltpu/config/conf/."""

import math
import os

import pytest
import torch
import yaml

import iltpu.config as J
import iltpu_torch.config as T
from iltpu_torch.config import yaml_subset

torch.set_num_threads(1)

FILES = ("train.yaml", "algorithms.yaml", "tuned.yaml", "search_space.yaml")

CASES = [
    ([], {}),
    (["algorithm=GAIL"], {}),
    (["algorithm=AdRIL"], {}),
    (["algorithm=GAIL", "training.learning_rate=1e-4", "imitation.grad_penalty=0",
      "check_time_usage=true", "env=hopper"], {}),
    (["algorithm=GAIL", "imitation.trajectories=5"], {"use_tuned": True}),
    (["algorithm=GAIL", "imitation.trajectories=7"], {"use_tuned": True}),
    (["algorithm=GAIL", "optimised_hyperparameters=GAIL_5_trajectories"], {}),
    (["algorithm=GAIL", "optimised_hyperparameters=GAIL_5_trajectories",
      "imitation.trajectories=5"], {}),
    (["algorithm=GAIL", "optimised_hyperparameters=GAIL_5_trajectories",
      "imitation.trajectories=10"], {}),
    (["algorithm=GAIL", "optimised_hyperparameters=null"], {}),
    (["algorithm=AIRL"], {}),
    (["algorithm=FAIRL", "platform=cpu", "memory.size=.inf"], {}),
    (["algorithm=SQIL", "seed=010", "imitation.subsample=0x2"], {}),
    *[([f"algorithm={alg}"], {}) for alg in J.ALGORITHMS],
    *[([f"algorithm={alg}", "steps=5000"], {}) for alg in J.ALGORITHMS],
    (["algorithm=RED"], {}),
]

FAILING = [
    ["algorithm=BC", "optimised_hyperparameters=GAIL_5_trajectories"],
    ["algorithm=GAIL", "optimised_hyperparameters=bogus"],
    ["algorithm=GAIL", "optimised_hyperparameters=GAIL_7_trajectories"],
    ["algorithm=NotAnAlg"],
]

INVALID = [
    ["algorithm=AdRIL", "imitation.mix_expert_data=none"],
    ["algorithm=GAIL", "imitation.loss_function=WGAN"],
    ["algorithm=GAIL", "imitation.mix_expert_data=prefill_memory"],
]


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("overrides,kw", CASES, ids=[" ".join(c[0]) or "defaults" for c in CASES])
def test_load_and_validate_equal(overrides, kw):
    j, t = J.load_config(overrides, **kw), T.load_config(overrides, **kw)
    assert _same(dict(t), dict(j))
    assert _same(T.to_flat(t), J.to_flat(j))
    assert _same(dict(T.validate_config(t)), dict(J.validate_config(j)))


@pytest.mark.parametrize("overrides", FAILING)
def test_same_failures(overrides):
    with pytest.raises(AssertionError):
        J.load_config(overrides)
    with pytest.raises(AssertionError):
        T.load_config(overrides)


@pytest.mark.parametrize("overrides", INVALID)
def test_same_validation_failures(overrides):
    with pytest.raises(AssertionError):
        J.validate_config(J.load_config(overrides))
    with pytest.raises(AssertionError):
        T.validate_config(T.load_config(overrides))


# Files whose comments describe the port: the same keys and defaults as iltpu's.
PORT_COMMENTS = ("train.yaml",)


@pytest.mark.parametrize("name", FILES)
def test_reader_equals_safe_load_and_copies_are_exact(name):
    with open(os.path.join(J.CONF_DIR, name), "rb") as f:
        original = f.read()
    with open(os.path.join(T.CONF_DIR, name), "rb") as f:
        copy = f.read()
    text = original.decode()
    if name in PORT_COMMENTS:
        assert _same(yaml.safe_load(copy.decode()), yaml.safe_load(text))
    else:
        assert copy == original
    for t in (text, copy.decode()):
        assert _same(yaml_subset.loads(t), yaml.safe_load(t))


@pytest.mark.parametrize(
    "raw", ["1e-4", "1.0e-4", "0", "-3", "true", "False", "yes", "off", "null", "~", ".inf",
            "-.inf", "0.5", "010", "0x1f", "1_000", "3:20", "hopper", "'quoted'", '"dq"',
            "[1, 2]", "{}", "[]", "GAIL_5_trajectories"],
)
def test_scalar_overrides_parse_as_pyyaml(raw):
    assert _same(T.parse_overrides([f"k={raw}"]), J.parse_overrides([f"k={raw}"]))
