"""A reader for the YAML subset the config files use, with no dependency.

Supported: block mappings by indentation, plain and quoted scalars, the
empty flow collections `{}` and `[]`, flat flow lists `[a, b]`, and `#`
comments. Plain scalars resolve as PyYAML's `safe_load` (YAML 1.1) resolves
them, so `1e-4` stays a string, `0.00003` is a float, `.inf` is infinity,
`null`/`~` is None and `yes`/`on`/`true` are booleans. Anchors, aliases,
block sequences and multi-line scalars are refused.
"""

import re
from typing import Any, Dict, List, Tuple

_BOOL = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")},
}
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)


def _sexagesimal(text: str, cast) -> Any:
    sign = -1 if text.startswith("-") else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t.startswith("-") else 1
    body = t.lstrip("+-")
    if ":" in body:
        return sign * _sexagesimal(body, int)
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body != "0" and body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    if t.endswith(".inf"):
        return float("-inf") if t.startswith("-") else float("inf")
    if t.endswith(".nan"):
        return float("nan")
    if ":" in t:
        return float(_sexagesimal(t, float))
    return float(t)


def _split_flow(body: str) -> List[str]:
    items, depth, cur, quote = [], 0, "", None
    for ch in body:
        if quote:
            cur += ch
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch in "[{":
            depth += 1
            cur += ch
        elif ch in "]}":
            depth -= 1
            cur += ch
        elif ch == "," and depth == 0:
            items.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        items.append(cur.strip())
    return items


def scalar(text: str) -> Any:
    """Resolve one flow value as `yaml.safe_load` would."""
    t = text.strip()
    if t in _NULL:
        return None
    if t[0] in "&*!|>":
        raise ValueError(f"unsupported YAML construct: {t!r}")
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        body = t[1:-1]
        return body.replace("''", "'") if t[0] == "'" else bytes(body, "utf-8").decode("unicode_escape")
    if t[0] == "[" and t[-1] == "]":
        return [scalar(x) for x in _split_flow(t[1:-1])]
    if t[0] == "{" and t[-1] == "}":
        out = {}
        for item in _split_flow(t[1:-1]):
            k, sep, v = item.partition(":")
            if not sep:
                raise ValueError(f"unsupported flow mapping item: {item!r}")
            out[scalar(k)] = scalar(v)
        return out
    if t in _BOOL:
        return _BOOL[t]
    if _INT.match(t):
        return _int(t)
    if _FLOAT.match(t):
        return _float(t)
    return t


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str) -> Tuple[str, str]:
    """'key: value' -> (key, value); the colon must end the text or be
    followed by a space."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == ":" and (i + 1 == len(text) or text[i + 1] in " \t"):
            return text[:i], text[i + 1 :]
    raise ValueError(f"expected 'key: value', got {text!r}")


def loads(text: str) -> Any:
    """Parse a document of nested block mappings; None when empty."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError("tabs are not allowed in YAML indentation")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body.startswith("- "):
            raise ValueError("block sequences are not supported")
        lines.append((indent, body))
    if not lines:
        return None
    root: Dict = {}
    # (indent of the mapping's keys, mapping), innermost last
    stack: List[Tuple[int, Dict]] = [(lines[0][0], root)]
    pending = None  # (indent, parent, key) of a 'key:' awaiting a block
    for indent, body in lines:
        if pending is not None:
            p_indent, parent, key = pending
            pending = None
            if indent > p_indent:
                child: Dict = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                parent[key] = None
        while stack[-1][0] > indent:
            stack.pop()
        if stack[-1][0] != indent:
            raise ValueError(f"inconsistent indentation at {body!r}")
        node = stack[-1][1]
        k, v = _split_key(body)
        key = scalar(k)
        if v.strip():
            node[key] = scalar(v)
        else:
            pending = (indent, node, key)
    if pending is not None:
        pending[1][pending[2]] = None
    return root
