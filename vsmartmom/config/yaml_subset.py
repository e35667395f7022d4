"""Loader for the YAML subset the parameter files use (no PyYAML needed).

Covers block mappings and block sequences (including mappings inside
sequence items), flow sequences ``[...]`` that may span lines, single- and
double-quoted scalars, ``#`` comments, and unicode keys. Plain scalars are
resolved as YAML 1.1 (PyYAML's ``safe_load``) resolves them: null, bool,
decimal int and float — where a float needs a dot, and an exponent needs a
sign, so ``400e-6`` stays a string — else str. Base-prefixed and
sexagesimal integers are not part of the subset.
Anchors, tags, flow mappings, block scalars and multi-document streams are
not part of the subset and raise ValueError.
"""
from __future__ import annotations

import re

_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                        |[-+]?\.(?:inf|Inf|INF)
                        |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}


def resolve_plain(text: str):
    """Type a plain (unquoted) scalar the way YAML 1.1 does."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t[0] == "-" else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        return float(t)
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[,"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _depth(text: str) -> int:
    depth, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
    return depth


def _quoted(text: str) -> str:
    body = text[1:-1]
    if text[0] == "'":
        return body.replace("''", "'")
    return (body.replace('\\"', '"').replace("\\n", "\n")
            .replace("\\t", "\t").replace("\\\\", "\\"))


def _parse_flow(text: str, pos: int = 0):
    """Parse one flow node starting at text[pos]; returns (node, end)."""
    while text[pos] == " ":
        pos += 1
    if text[pos] == "[":
        out, pos = [], pos + 1
        while True:
            while text[pos] == " ":
                pos += 1
            if text[pos] == "]":
                return out, pos + 1
            node, pos = _parse_flow(text, pos)
            out.append(node)
            while text[pos] == " ":
                pos += 1
            if text[pos] == ",":
                pos += 1
            elif text[pos] != "]":
                raise ValueError(f"bad flow sequence: {text!r}")
    if text[pos] in "'\"":
        end = text.index(text[pos], pos + 1)
        return _quoted(text[pos:end + 1]), end + 1
    if text[pos] in "{&*!|>":
        raise ValueError(f"YAML feature outside the subset: {text!r}")
    end = pos
    while end < len(text) and text[end] not in ",]":
        end += 1
    return resolve_plain(text[pos:end].strip()), end


def _value(text: str):
    if text.startswith("["):
        node, end = _parse_flow(text)
        if text[end:].strip():
            raise ValueError(f"trailing text after flow node: {text!r}")
        return node
    if text[:1] in ("'", '"'):
        return _quoted(text)
    if text[:1] in "{&*!|>":
        raise ValueError(f"YAML feature outside the subset: {text!r}")
    return resolve_plain(text)


def _split_key(text: str):
    """'key: value' -> (key, value); None if the line is no mapping entry."""
    depth, quote = 0, None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif (ch == ":" and depth == 0
              and (i + 1 == len(text) or text[i + 1] in " \t")):
            key = text[:i].strip()
            key = _quoted(key) if key[:1] in "'\"" else resolve_plain(key)
            return key, text[i + 1:].strip()
    return None


def _lines(source: str):
    """(indent, text) of each logical line: comments and blank lines
    dropped, multi-line flow sequences joined."""
    out = []
    raw = source.splitlines()
    i = 0
    while i < len(raw):
        line = _strip_comment(raw[i])
        i += 1
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError("tabs in indentation")
        text = line.strip()
        while _depth(text) > 0 and i < len(raw):
            text += " " + _strip_comment(raw[i]).strip()
            i += 1
        out.append((len(line) - len(line.lstrip()), text))
    return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _parse_block(lines, i, indent):
    if _is_item(lines[i][1]):
        return _parse_seq(lines, i, indent)
    return _parse_map(lines, i, indent)


def _child(lines, i, indent):
    """The node below a 'key:' or '-' with nothing after it."""
    if i < len(lines) and (lines[i][0] > indent or (
            lines[i][0] == indent and _is_item(lines[i][1]))):
        return _parse_block(lines, i, lines[i][0])
    return None, i


def _parse_map(lines, i, indent):
    out = {}
    while i < len(lines) and lines[i][0] == indent \
            and not _is_item(lines[i][1]):
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = kv
        if rest:
            out[key], i = _value(rest), i + 1
        else:
            out[key], i = _child(lines, i + 1, indent)
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"bad indentation at {lines[i][1]!r}")
    return out, i


def _parse_seq(lines, i, indent):
    out = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        rest = lines[i][1][1:].lstrip()
        if not rest:
            node, i = (_parse_block(lines, i + 1, lines[i + 1][0])
                       if i + 1 < len(lines) and lines[i + 1][0] > indent
                       else (None, i + 1))
        elif _split_key(rest) is not None and not rest.startswith("["):
            # a mapping whose first key sits on the item's line
            sub = indent + len(lines[i][1]) - len(rest)
            node, i = _parse_map(
                lines[:i] + [(sub, rest)] + lines[i + 1:], i, sub)
        else:
            node, i = _value(rest), i + 1
        out.append(node)
    return out, i


def loads(source: str):
    """Parse a YAML document of the supported subset."""
    lines = _lines(source)
    if not lines:
        return None
    node, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unparsed YAML from {lines[i][1]!r}")
    return node


def load(path: str):
    with open(path, encoding="utf-8") as f:
        return loads(f.read())
