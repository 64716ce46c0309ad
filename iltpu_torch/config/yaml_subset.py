"""A reader and a writer for the YAML subset the config files use, with no
dependency.

`loads` reads block mappings by indentation, block sequences (indented, or
indentless under a key, as PyYAML writes them) of scalars and of
collections, plain and quoted scalars, the empty flow collections `{}` and
`[]`, flat flow lists `[a, b]`, `#` comments, anchors (`&name`) on a scalar
or a block, and aliases (`*name`) to an earlier anchor, which give the
anchored object itself, as PyYAML's do. Plain scalars resolve as PyYAML's
`safe_load` (YAML 1.1) resolves them, so `1e-4` stays a string, `0.00003` is
a float, `.inf` is infinity, `null`/`~` is None and `yes`/`on`/`true` are
booleans. Merge keys (`<<`), tags, timestamps, complex keys and multi-line
scalars raise ValueError.

`dumps` writes dicts, lists, str, int, float, bool and None as
`yaml.safe_dump(x, sort_keys=False)` writes them: block style, a string
quoted wherever its plain form would read as another type or as YAML
syntax, and an anchor on each collection met twice. Where PyYAML would
fold a long or multi-line string, it writes one double-quoted line instead,
which reads back the same.
"""

import re
from typing import Any, Dict, List, Optional, Tuple

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
_TIMESTAMP = re.compile(
    r"^(?:[0-9]{4}-[0-9]{2}-[0-9]{2}"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}:[0-9]{2}(?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?)$"
)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}


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


def _unquoted(text: str, flow: bool = False) -> List[bool]:
    """For each character, whether it lies outside every quoted scalar: a
    quote opens one only where a token starts (after a space, or in a flow
    collection after `[`, `{` or `,`)."""
    out, quote, i = [True] * len(text), None, 0
    while i < len(text):
        ch = text[i]
        if quote:
            out[i] = False
            step = 2 if (quote == '"' and ch == "\\") or (
                quote == "'" and text[i : i + 2] == "''") else 1
            out[i : i + step] = [False] * len(out[i : i + step])
            if step == 1 and ch == quote:
                quote = None
            i += step
            continue
        if ch in "'\"" and (i == 0 or text[i - 1] in (" \t[{," if flow else " \t")):
            quote, out[i] = ch, False
        i += 1
    return out


def _split_flow(body: str) -> List[str]:
    items, depth, start = [], 0, 0
    for i, (ch, free) in enumerate(zip(body, _unquoted(body, flow=True))):
        if not free:
            continue
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i].strip())
            start = i + 1
    if body[start:].strip():
        items.append(body[start:].strip())
    return items


def _unescape(body: str) -> str:
    """The value of a one-line double-quoted scalar's body."""
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        code = body[i + 1 : i + 2]
        if code in _ESCAPES:
            out.append(_ESCAPES[code])
            i += 2
        elif code in _HEX:
            n = _HEX[code]
            out.append(chr(int(body[i + 2 : i + 2 + n], 16)))
            i += 2 + n
        else:
            raise ValueError(f"unknown escape in {body!r}")
    return "".join(out)


def scalar(text: str) -> Any:
    """Resolve one flow value as `yaml.safe_load` would."""
    t = text.strip()
    if t in _NULL:
        return None
    if t[0] in "&*!|>" or t == "-" or t.startswith("- "):
        raise ValueError(f"unsupported YAML construct: {t!r}")
    if t[0] in "'\"":
        if len(t) < 2 or t[-1] != t[0]:
            raise ValueError(f"unsupported multi-line or malformed quoted scalar: {t!r}")
        body = t[1:-1]
        return body.replace("''", "'") if t[0] == "'" else _unescape(body)
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
    if _TIMESTAMP.match(t) or t in ("=", "<<"):
        raise ValueError(f"unsupported YAML construct: {t!r}")
    return t


def _strip_comment(line: str) -> str:
    for i, (ch, free) in enumerate(zip(line, _unquoted(line))):
        if free and ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _key_split(text: str) -> Optional[Tuple[str, str]]:
    """'key: value' -> (key, value), or None where the text is a flow
    collection or no colon outside quotes ends it or is followed by a
    space."""
    if text[:1] in ("[", "{"):
        return None
    for i, (ch, free) in enumerate(zip(text, _unquoted(text))):
        if free and ch == ":" and (i + 1 == len(text) or text[i + 1] in " \t"):
            return text[:i], text[i + 1 :]
    return None


def _is_entry(body: str) -> bool:
    return body == "-" or body.startswith("- ")


class _Reader:
    """Recursive descent over (indent, text) lines; `anchors` holds every
    anchored node read so far."""

    def __init__(self, lines: List[Tuple[int, str]]):
        self.lines, self.i, self.anchors = lines, 0, {}

    def peek(self) -> Optional[Tuple[int, str]]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int) -> Any:
        """The collection whose first line is the next one, at `indent`."""
        if _is_entry(self.lines[self.i][1]):
            return self.sequence(indent)
        return self.mapping(indent)

    def sequence(self, indent: int) -> List:
        out = []
        while (line := self.peek()) and line[0] == indent and _is_entry(line[1]):
            rest = line[1][1:].lstrip(" ")
            if rest[:1] not in ("&", "*") and (_is_entry(rest) or _key_split(rest)):
                # the entry's collection starts on this line, at rest's column
                self.lines[self.i] = (indent + len(line[1]) - len(rest), rest)
                out.append(self.block(self.lines[self.i][0]))
            else:
                self.i += 1
                out.append(self.node(rest, indent, indentless=False))
        return out

    def mapping(self, indent: int) -> Dict:
        out: Dict = {}
        while (line := self.peek()) and line[0] >= indent:
            if line[0] > indent:
                raise ValueError(f"inconsistent indentation at {line[1]!r}")
            if _is_entry(line[1]):
                break
            split = _key_split(line[1])
            if split is None:
                raise ValueError(f"expected 'key: value', got {line[1]!r}")
            k = split[0].strip()
            if k in ("<<", "?") or k[:1] in ("&", "*") or k.startswith("? "):
                raise ValueError(f"unsupported YAML key: {k!r}")
            self.i += 1
            out[scalar(k)] = self.node(split[1], indent, indentless=True)
        return out

    def node(self, text: str, indent: int, indentless: bool) -> Any:
        """The value after `key:` or `- `: an alias, a scalar, or the block
        below (deeper, or an indentless sequence at `indent` after a key),
        with its anchor, if any."""
        text, anchor = text.strip(), None
        if text.startswith("&"):
            anchor, _, text = text[1:].partition(" ")
            text = text.strip()
        if text.startswith("*"):
            if anchor is not None or text[1:] not in self.anchors:
                raise ValueError(f"unsupported or unknown alias: {text!r}")
            return self.anchors[text[1:]]
        if text:
            if _key_split(text):
                raise ValueError(f"a mapping is not allowed here: {text!r}")
            value = scalar(text)
        elif (line := self.peek()) and line[0] > indent:
            value = self.block(line[0])
        elif line and indentless and line[0] == indent and _is_entry(line[1]):
            value = self.sequence(indent)
        else:
            value = None
        if anchor is not None:
            if not anchor:
                raise ValueError("an anchor needs a name")
            self.anchors[anchor] = value
        return value


def loads(text: str) -> Any:
    """Parse a document of nested block collections (or one scalar); None
    when empty."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError("tabs are not allowed in YAML indentation")
        lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    reader = _Reader(lines)
    first = lines[0][1]
    if len(lines) == 1 and not _is_entry(first) and not _key_split(first):
        return reader.node(first, lines[0][0], indentless=False)
    out = reader.block(lines[0][0])
    if reader.i != len(lines):
        raise ValueError(f"unexpected line {lines[reader.i][1]!r}")
    return out


# ------------------------------------------------------------------ writer


def _plain_allowed(s: str) -> bool:
    """PyYAML's emitter (`analyze_scalar` + `choose_scalar_style`) for a
    one-line printable ASCII string in block context: plain unless it reads
    as another type, starts or ends with a space, or carries an indicator."""
    if (s in _BOOL or s in _NULL or _INT.match(s) or _FLOAT.match(s) or _TIMESTAMP.match(s)
            or s in ("=", "<<")):
        return False
    if s[0] == " " or s[-1] == " " or s.startswith(("---", "...")):
        return False
    if s[0] in "#,[]{}&*!|>'\"%@`":
        return False
    ends = len(s) == 1 or s[1] == " "
    if s[0] in "?:-" and ends:
        return False
    for i in range(1, len(s)):
        if s[i] == ":" and (i + 1 == len(s) or s[i + 1] == " "):
            return False
        if s[i] == "#" and s[i - 1] == " ":
            return False
    return True


def _double_quoted(s: str) -> str:
    out = []
    for ch in s:
        if ch in '"\\':
            out.append("\\" + ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif " " <= ch <= "~":
            out.append(ch)
        elif ch <= "\xff":
            out.append(f"\\x{ord(ch):02X}")
        elif ch <= "\uffff":
            out.append(f"\\u{ord(ch):04X}")
        else:
            out.append(f"\\U{ord(ch):08X}")
    return '"' + "".join(out) + '"'


def _scalar_text(x: Any) -> str:
    if x is None:
        return "null"
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, int):
        return str(x)
    if isinstance(x, float):
        if x != x:
            return ".nan"
        if x in (float("inf"), float("-inf")):
            return ".inf" if x > 0 else "-.inf"
        r = repr(x).lower()
        return r.replace("e", ".0e", 1) if "." not in r and "e" in r else r
    if isinstance(x, str):
        if x == "":
            return "''"
        if not all(" " <= ch <= "~" for ch in x):
            return _double_quoted(x)
        return x if _plain_allowed(x) else "'" + x.replace("'", "''") + "'"
    raise TypeError(f"cannot write a {type(x).__name__} as YAML")


def _anchors(data: Any) -> Dict[int, str]:
    """`id001`, `id002`, ... for each collection met twice, numbered in the
    order PyYAML's serializer meets the second occurrences."""
    seen, names, open_ = set(), {}, set()

    def visit(x):
        if not isinstance(x, (dict, list)):
            return
        if id(x) in open_:
            raise ValueError("a recursive structure cannot be written")
        if id(x) in seen:
            names.setdefault(id(x), f"id{len(names) + 1:03d}")
            return
        seen.add(id(x))
        open_.add(id(x))
        for item in x.items() if isinstance(x, dict) else x:
            for y in item if isinstance(x, dict) else (item,):
                visit(y)
        open_.discard(id(x))

    visit(data)
    return names


class _Writer:
    def __init__(self, data: Any):
        self.names, self.written, self.lines = _anchors(data), set(), []

    def head(self, x: Any) -> Tuple[str, bool]:
        """The text after `key:`/`- ` for `x` (an anchor, alias or flow
        value) and whether a block follows on the next lines."""
        name = self.names.get(id(x))
        if name and id(x) in self.written:
            return f" *{name}", False
        anchor = ""
        if name:
            self.written.add(id(x))
            anchor = f" &{name}"
        if isinstance(x, (dict, list)):
            if x:
                return anchor, True
            return f"{anchor} {'{}' if isinstance(x, dict) else '[]'}", False
        return f"{anchor} {_scalar_text(x)}", False

    def mapping(self, d: Dict, indent: int, first: str = ""):
        """Lines of a non-empty mapping at `indent`; `first` replaces the
        first line's indentation (a sequence entry's `- `)."""
        for i, (k, v) in enumerate(d.items()):
            if isinstance(k, (dict, list)):
                raise TypeError("a collection cannot be a mapping key")
            pad = first if i == 0 and first else " " * indent
            text, block = self.head(v)
            self.lines.append(f"{pad}{_scalar_text(k)}:{text}")
            if block:
                self.collection(v, indent + 2 if isinstance(v, dict) else indent)

    def sequence(self, seq: List, indent: int, first: str = ""):
        for i, v in enumerate(seq):
            pad = (first if i == 0 and first else " " * indent) + "-"
            text, block = self.head(v)
            if block and not text:  # the collection starts on the entry's line
                self.collection(v, indent + 2, first=pad + " ")
            else:
                self.lines.append(pad + text)
                if block:
                    self.collection(v, indent + 2)

    def collection(self, x, indent: int, first: str = ""):
        (self.mapping if isinstance(x, dict) else self.sequence)(x, indent, first)


def dumps(data: Any) -> str:
    """`data` as `yaml.safe_dump(data, sort_keys=False)` writes it."""
    w = _Writer(data)
    text, block = w.head(data)
    if not block:
        text = text.strip()
        plain = text[0] not in "'\"&*" and not isinstance(data, (dict, list))
        return f"{text}\n" + ("...\n" if plain else "")
    if text:  # an anchor on the whole document
        w.lines.append(text.strip())
    w.collection(data, 0)
    return "\n".join(w.lines) + "\n"
