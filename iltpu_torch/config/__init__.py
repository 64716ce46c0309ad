from iltpu_torch.config.core import (
    ALGORITHMS,
    CONF_DIR,
    DotDict,
    deep_merge,
    get_by_path,
    load_config,
    parse_overrides,
    set_by_path,
    to_flat,
    validate_config,
)

__all__ = [
    "ALGORITHMS",
    "CONF_DIR",
    "DotDict",
    "deep_merge",
    "get_by_path",
    "load_config",
    "parse_overrides",
    "set_by_path",
    "to_flat",
    "validate_config",
]
