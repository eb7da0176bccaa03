"""Read a configuration YAML without PyYAML (port of
``kinpoly_tpu/config/config.py`` ``load_yaml``).

``load_yaml(path)`` reads a YAML file. The repo's six configs (``uhc``,
``uhc_quatv2``, ``kin_poly``, ``kin_only``, ``kin_poly_wo_action``,
``use_of``) are not read from files: ``config/defaults.py`` keeps their
values, and ``UHCConfig.load`` takes a name or a path.

``parse_yaml`` reads the subset of YAML that the repo's configs use:
comments, block mappings nested by indentation, flow lists of scalars, and
plain or quoted scalars. Scalars resolve as PyYAML's ``safe_load`` resolves
them (YAML 1.1): ``1e-4`` has no dot and stays a string, ``5.0e-5`` is a
float, ``yes``/``on``/``true`` are True, ``~``/``null``/empty are None.
Anything else raises ``ValueError`` naming the line: the other YAML 1.1
numbers (octal, hex, binary, sexagesimal, ``1_000``, ``.inf``, ``.nan``),
block sequences, flow mappings, anchors, tags, multi-line scalars, dates
and tabs.
"""

from __future__ import annotations

import os
import re

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                 "off", "Off", "OFF")})
# PyYAML's int and float patterns, which split numbers from strings; of
# what they match, only decimal ints and plain floats are read
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
# PyYAML makes these dates; the configs have none
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
# a plain scalar may not start with these indicators
_INDICATORS = tuple("&*!|>{}[]%@`,#") + ("- ", "? ", ": ")


def _scalar(text: str, where: str):
    """One scalar, plain or quoted, resolved as safe_load resolves it."""
    if text[:1] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise ValueError(f"{where}: unterminated quoted scalar {text!r}")
        body = text[1:-1]
        if "'" in body.replace("''", ""):
            raise ValueError(f"{where}: unsupported quoted scalar {text!r}")
        return body.replace("''", "'")
    if text[:1] == '"':
        body = text[1:-1]
        if len(text) < 2 or text[-1] != '"' or '"' in body or "\\" in body:
            raise ValueError(f"{where}: unsupported quoted scalar {text!r}")
        return body
    if (text.startswith(_INDICATORS) or text in ("-", "?", "<<", "=")
            or ": " in text or text.endswith(":")):
        raise ValueError(f"{where}: unsupported YAML {text!r}")
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        if not _DECIMAL.match(text):
            raise ValueError(f"{where}: unsupported YAML 1.1 int {text!r}")
        return int(text)
    if _FLOAT.match(text):
        if "_" in text or ":" in text or text[-1].isalpha():
            raise ValueError(f"{where}: unsupported YAML 1.1 float {text!r}")
        return float(text)
    if _TIMESTAMP.match(text):
        raise ValueError(f"{where}: dates are not supported ({text!r})")
    return text


def _strip_comment(line: str) -> str:
    """The line without a comment: '#' at its start or after a space,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " :[,"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _value(text: str, where: str):
    """A mapping value on the key's line: a flow list of scalars or a
    scalar."""
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"{where}: unsupported flow collection {text!r}")
        inner = text[1:-1].strip()
        if not inner:
            return []
        items = [x.strip() for x in inner.split(",")]
        if items[-1] == "":                       # a trailing comma
            items.pop()
        if any(x == "" or x[:1] in "[{" for x in items):
            raise ValueError(f"{where}: unsupported flow list {text!r}")
        return [_scalar(x, where) for x in items]
    return _scalar(text, where)


def parse_yaml(text: str, source: str = "<yaml>") -> dict:
    """The mapping a config YAML holds, as ``yaml.safe_load`` reads it, for
    the subset the module docstring names."""
    root: dict = {}
    # (indent of this mapping's keys, the mapping); a key with no value
    # on its line opens a nested mapping if deeper lines follow
    stack = [(0, root)]
    pending = None                  # (indent, parent, key) of an open key
    if text.startswith("\ufeff"):
        text = text[1:]
    for no, raw in enumerate(text.splitlines(), 1):
        where = f"{source}:{no}"
        if raw.strip() in ("---", "...") and not raw.startswith(" "):
            if raw.strip() == "---" and no == 1:
                continue
            raise ValueError(f"{where}: multiple documents are not supported")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        if body.startswith("\t") or "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"{where}: tabs in indentation")
        indent = len(line) - len(body)
        if pending is not None:
            p_indent, parent, key = pending
            pending = None
            if indent > p_indent:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                parent[key] = None
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            raise ValueError(f"{where}: inconsistent indentation")
        mapping = stack[-1][1]
        if body.startswith("- ") or body == "-":
            raise ValueError(f"{where}: block sequences are not supported")
        m = re.match(r"^([^:]+?|'[^']*'|\"[^\"]*\"):(?:[ ]+(.*))?$", body)
        if m is None:
            raise ValueError(f"{where}: expected 'key: value', got {body!r}")
        key = _scalar(m.group(1).strip(), where)
        rest = (m.group(2) or "").strip()
        if rest:
            mapping[key] = _value(rest, where)
        else:
            pending = (indent, mapping, key)
    if pending is not None:
        pending[1][pending[2]] = None
    return root


def load_yaml(path: str) -> dict:
    """The mapping of the YAML file at `path`. The repo's named configs are
    read by no file: ``UHCConfig.named`` and ``KinPolyConfig.named`` hold
    their values."""
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path!r} is not a file (a named config goes through "
            f"UHCConfig.named or KinPolyConfig.named)")
    with open(path, encoding="utf-8") as f:
        return parse_yaml(f.read(), path)
