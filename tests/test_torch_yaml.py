"""The port's YAML subset (iltpu_torch/config/yaml_subset.py) against PyYAML:
`loads` equals `yaml.safe_load` on block sequences (indented and
indentless, of scalars and of collections), anchors and aliases (aliases
give the anchored object itself, as PyYAML's do) and refuses what it does
not read; `dumps` writes what `yaml.safe_dump(x, sort_keys=False)` writes
(byte for byte where PyYAML keeps a string on one line), and hypothesis
round trips `loads(dumps(x)) == x == yaml.safe_load(dumps(x))` with
adversarial strings."""

import math
import os

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

import iltpu.config as J
from iltpu_torch.config import yaml_subset as Y

DOCS = {
    "indentless scalars": "a:\n- 1\n- x\n- null\nb: 2\n",
    "indented scalars": "a:\n  - 1\n  - 2\nb:\n    - 'q'\n",
    "top-level sequence": "- 1\n- - 2\n  - 3\n- {}\n- []\n",
    "sequence of mappings": "- a: 1\n  b: [1, 2]\n- c:\n  - d: 3\n    e: 4\n  - 5\n",
    "nested sequences": "- - - 1\n    - 2\n  - 3\n- 4\n",
    "entry with a block below": "-\n  a: 1\n- \n  - 2\n-\n",
    "anchored block and alias": "x: &a\n  k: 1\n  l:\n  - 2\ny: *a\nz:\n- *a\n",
    "anchored scalar and flow": "a: &s hello\nb: *s\nc: &f [1, 2]\nd: *f\n",
    "anchors in a sequence": "- &a\n  x: 1\n- *a\n- &b\n  - 1\n- *b\n- &c 3\n- *c\n",
    "anchored indentless sequence": "k: &a\n- 1\n- 2\nj: *a\n",
    "comments and quotes": "# c\na: 'x: y' # c\nb: \"a\\tb\\xE9\\u00e9\"\nc: 'it''s'\n",
    "top-level scalars": "hello\n...\n",
    "quoted top-level": "'null'\n",
    "empty flows": "a: {}\nb: []\n",
}

REFUSED = {
    "merge key": "a: &a\n  x: 1\nb:\n  <<: *a\n",
    "tag": "a: !!str 1\n",
    "block scalar": "a: |\n  text\n",
    "folded scalar": "a: >\n  text\n",
    "multi-line plain": "a: one\n  two\n",
    "multi-line quoted": "a: 'one\n  two'\n",
    "unknown alias": "a: *nope\n",
    "alias to an open anchor": "a: &x\n  b: *x\n",
    "timestamp": "a: 2001-12-14\n",
    "mapping in a value": "a: b: c\n",
    "complex key": "? a\n: 1\n",
    "entry in a value": "a: - b\n",
    "bad indentation": "a:\n    b: 1\n  c: 2\n",
    "entry after a mapping": "a: 1\n- b\n",
}


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _shared_ids(x, out=None, path=()):
    """(path, path of the first occurrence) for every collection met again."""
    out = {} if out is None else out
    if isinstance(x, (dict, list)):
        if id(x) in out:
            out.setdefault("again", []).append((path, out[id(x)]))
            return out
        out[id(x)] = path
        for k, v in (x.items() if isinstance(x, dict) else enumerate(x)):
            _shared_ids(v, out, path + (k,))
    return out


@pytest.mark.parametrize("name", list(DOCS))
def test_loads_equals_safe_load(name):
    text = DOCS[name]
    got, want = Y.loads(text), yaml.safe_load(text)
    assert _same(got, want)
    assert _shared_ids(got).get("again") == _shared_ids(want).get("again")


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_constructs_raise(name):
    with pytest.raises(ValueError):
        Y.loads(REFUSED[name])


def test_search_space_aliases_are_pyyamls():
    """Each `*idNNN` of search_space.yaml gives the anchored dict itself,
    shared where PyYAML shares it."""
    with open(os.path.join(J.CONF_DIR, "search_space.yaml")) as f:
        text = f.read()
    got, want = Y.loads(text), yaml.safe_load(text)
    assert _same(got, want)
    shared = _shared_ids(got)["again"]
    assert shared == _shared_ids(want)["again"] and len(shared) > 30
    assert got["GAIL"]["training.start"] is got["AdRIL"]["training.start"]


@pytest.mark.parametrize("name", ["train.yaml", "algorithms.yaml", "tuned.yaml", "search_space.yaml"])
def test_dumps_equals_safe_dump_on_the_conf_files(name):
    with open(os.path.join(J.CONF_DIR, name)) as f:
        data = yaml.safe_load(f)
    text = Y.dumps(data)
    assert text == yaml.safe_dump(data, sort_keys=False)
    assert _same(Y.loads(text), data)


SHARED_LIST, SHARED_DICT, SHARED_EMPTY = [1, 2], {"x": 1}, []
DUMPS = {
    "shared in a sequence": [SHARED_LIST, SHARED_LIST, SHARED_DICT, [SHARED_DICT], {"k": SHARED_LIST}],
    "shared under keys": {"k": [[SHARED_LIST, SHARED_DICT]], "j": SHARED_LIST, "m": SHARED_DICT,
                          "e": SHARED_EMPTY, "f": [SHARED_EMPTY]},
    "scalars": {"n": None, "t": True, "i": -3, "f": 1e-5, "g": 1e17, "z": -0.0, "inf": float("inf"),
                "ninf": float("-inf"), "nan": float("nan")},
    "strings": {"a": "null", "b": "", "c": "- a", "d": "a: b", "e": "010", "f": "1e-4", "g": "yes",
                "h": " x", "i": "x #y", "j": "a\tb", "k": "#x", "l": "it's", "m": "2001-12-14",
                "n": "=", "o": "<<", "p": ":", "q": "a:", "r": "?x", "s": "-x", "t": "x,y", "u": "é",
                "v": "'q'", "w": '"', "x": "@", "y": "1.0", "z": "~", "aa": "---", "bb": "a  b"},
    "keys": {"1": 2, 1: 3, None: 4, 1.5: 6, "a b": 7, "x: y": 8},
    "top-level scalar": "a b",
    "top-level quoted": "null",
    "top-level int": 7,
    "empty dict": {},
    "empty list": [],
}


@pytest.mark.parametrize("name", list(DUMPS))
def test_dumps_equals_safe_dump(name):
    data = DUMPS[name]
    text = Y.dumps(data)
    assert text == yaml.safe_dump(data, sort_keys=False)
    assert _same(Y.loads(text), yaml.safe_load(text))


def test_dumps_refuses_recursion():
    x = []
    x.append(x)
    with pytest.raises(ValueError):
        Y.dumps(x)


ADVERSARIAL = ["null", "Null", "~", "yes", "No", "on", "true", "1e-4", "1.0", "010", "0x1f", "3:20",
               ".inf", "-.inf", ".nan", "- a", "-", "a: b", "a:", ":", "", " ", " lead", "trail ",
               "#c", "x #c", "&a", "*a", "!t", "|", ">", "'", '"', "[1]", "{a: 1}", "%", "@", "`",
               "?", "? x", "---", "...", "=", "<<", "2001-12-14", "a\nb", "tab\there", "é", "\x85"]
PRINTABLE = st.text(st.characters(min_codepoint=0x20, max_codepoint=0x7E), max_size=10)
SCALARS = (st.none() | st.booleans() | st.integers(-10**6, 10**6)
           | st.floats(allow_nan=False, width=64) | st.sampled_from(ADVERSARIAL) | PRINTABLE)
KEYS = st.sampled_from([k for k in ADVERSARIAL if k]) | st.text(
    st.characters(min_codepoint=0x21, max_codepoint=0x7E), min_size=1, max_size=8)
TREES = st.recursive(
    SCALARS,
    lambda inner: st.lists(inner, max_size=4) | st.dictionaries(KEYS, inner, max_size=4),
    max_leaves=16,
).filter(lambda x: isinstance(x, (dict, list)))


@settings(max_examples=300, deadline=None)
@given(TREES)
def test_round_trip(data):
    text = Y.dumps(data)
    assert _same(Y.loads(text), data)
    assert _same(yaml.safe_load(text), data)


def _one_line(x):
    """No string PyYAML would fold or break over lines."""
    if isinstance(x, dict):
        return all(_one_line(k) and _one_line(v) for k, v in x.items())
    if isinstance(x, list):
        return all(_one_line(v) for v in x)
    return not isinstance(x, str) or all(" " <= c <= "~" for c in x) or x in ("é",)


@settings(max_examples=300, deadline=None)
@given(TREES.filter(_one_line))
def test_dumps_is_safe_dumps_bytes(data):
    assert Y.dumps(data) == yaml.safe_dump(data, sort_keys=False)
