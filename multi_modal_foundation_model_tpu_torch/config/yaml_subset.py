"""A reader of the YAML subset the shipped config files use.

The port's configs are read without PyYAML (which is not everywhere the
port runs). The reader takes a whitelist and refuses everything else with
``ValueError`` and the line number; it never guesses:

- block mappings, nested by indentation (spaces), with identifier keys;
- on a key's line: nothing (a nested mapping follows, or None), a scalar,
  a one-line flow list of scalars (``["temporal"]``, ``[]``) or ``{}``;
- ``#`` comments, on their own line or after a space behind a value;
- scalars: ``null`` and ``~`` (None), ``true`` and ``false``, decimal
  ints, floats with a dot and, if any, a signed exponent (``1.e-7``,
  ``0.15``), quoted strings without escapes, and bare strings that start
  with a letter (``whisker-motion-energy``, ``include:baseline.yaml``) or
  are a uuid.

Each of these is what ``yaml.safe_load`` (YAML 1.1) gives the same text.
A plain scalar outside them is refused, whatever PyYAML makes of it:
``1e-5`` (a string there), ``yes`` (a boolean), ``012`` (an octal int),
``2001-12-14`` (a date).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?")
_WORD = re.compile(r"[A-Za-z_](?:[A-Za-z0-9_./:-]*[A-Za-z0-9_])?")
_UUID = re.compile(r"[0-9a-f]{8}(?:-[0-9a-f]{4}){3}-[0-9a-f]{12}")
# words PyYAML reads as a boolean or None in one of their spellings
_RESERVED = {"yes", "no", "on", "off", "true", "false", "null"}
_QUOTED = re.compile(r"'[^']*'|\"[^\"\\]*\"")
_LINE = re.compile(r"( *)([A-Za-z_][A-Za-z0-9_]*):"
                   r"(?: +('[^']*'|\"[^\"\\]*\"|\[[^\]#]*\]|[^\s#]+))?"
                   r"(?: +#.*)? *")
_BLANK = re.compile(r" *(?:#.*)?")


def _fail(number: int, why: str):
    raise ValueError(f"line {number}: {why} (outside the YAML subset the "
                     "port's config reader takes)")


def resolve_plain(text: str, number: int = 0) -> Any:
    """The value ``yaml.safe_load`` gives the plain scalar ``text``, or
    ValueError where ``text`` is not on the whitelist."""
    if text in ("~", "null"):
        return None
    if text in ("true", "false"):
        return text == "true"
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if (_WORD.fullmatch(text) and text.lower() not in _RESERVED) \
            or _UUID.fullmatch(text):
        return text
    _fail(number, f"scalar {text!r}")


def _scalar(text: str, number: int) -> Any:
    if _QUOTED.fullmatch(text):
        return text[1:-1]
    return resolve_plain(text, number)


def _value(text: str, number: int) -> Any:
    """A mapping value written on its key's line."""
    if text == "{}":
        return {}
    if not text.startswith("["):
        return _scalar(text, number)
    if not text.endswith("]"):
        _fail(number, f"flow list {text!r} not closed on its line")
    inner = text[1:-1].strip()
    if not inner:
        return []
    out = []
    for item in (part.strip() for part in inner.split(",")):
        if ":" in item or "[" in item or "{" in item:
            _fail(number, f"flow list item {item!r}")
        out.append(_scalar(item, number))
    return out


def _lines(source: str) -> List[Tuple[int, int, str, str]]:
    """(line number, indent, key, value text) of each line with content."""
    out = []
    for number, raw in enumerate(source.splitlines(), start=1):
        if _BLANK.fullmatch(raw):
            continue
        m = _LINE.fullmatch(raw)
        if not m:
            _fail(number, f"expected 'key: value', got {raw!r}")
        indent, key, value = m.groups()
        if key.lower() in _RESERVED:
            _fail(number, f"key {key!r}")
        out.append((number, len(indent), key, value or ""))
    return out


def _mapping(lines, pos: int, indent: int) -> Tuple[Dict[str, Any], int]:
    out: Dict[str, Any] = {}
    while pos < len(lines):
        number, ind, key, value = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            _fail(number, "unexpected indentation")
        if key in out:
            _fail(number, f"duplicate key {key!r}")
        pos += 1
        nxt = lines[pos] if pos < len(lines) else None
        if value:
            out[key] = _value(value, number)
            if nxt is not None and nxt[1] > indent:
                _fail(nxt[0], "indented line after a value")
        elif nxt is not None and nxt[1] > indent:
            out[key], pos = _mapping(lines, pos, nxt[1])
        else:
            out[key] = None
    return out, pos


def loads(source: str) -> Optional[Dict[str, Any]]:
    """The mapping ``source`` holds (None for a document with no
    content), as ``yaml.safe_load`` would give it."""
    lines = _lines(source)
    if not lines:
        return None
    if lines[0][1] != 0:
        _fail(lines[0][0], "the top-level mapping must start at column 0")
    out, pos = _mapping(lines, 0, 0)
    if pos != len(lines):
        _fail(lines[pos][0], "indentation does not match any mapping")
    return out


def load(path: str) -> Optional[Dict[str, Any]]:
    with open(path, "r") as f:
        return loads(f.read())
