"""Config files, result tables and process introspection (counterpart of
ocl_tpu/utils/io.py).

The machine with the card has no pyyaml, pandas or psutil, so each has a
small stand-in here:

* `load_yaml` reads the subset of YAML that the recipes under `config/` and
  `config_CVPR/` are written in, and returns what
  `yaml.load(..., Loader=yaml.FullLoader)` returns for them: block mappings,
  block lists of scalars, and plain scalars resolved by YAML 1.1's rules
  (so `1.0e-05` is a float and `1e-5` a string, as in PyYAML). Anything
  outside the subset raises a ValueError that names the line;
* `save_csv` writes a list of row dicts as pandas' `DataFrame(rows).to_csv(
  index=False)` would (columns in order of first appearance, a missing or
  NaN value left empty);
* `check_ram_usage` reads the resident set size from /proc/self/statm.
"""

from __future__ import annotations

import csv
import math
import os
import re

import numpy as np

# YAML 1.1 implicit scalars as PyYAML's resolver matches them
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_DEC_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_OTHER_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
                        r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_SPECIAL_FLOAT = re.compile(r"^(?:[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_OTHER_FLOAT = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*$")
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?![0-9])")
# a plain scalar may not start with an indicator (a `-`, `?` or `:` only
# when a space or the line's end follows it)
_INDICATORS = set(",[]{}#&*!|>'\"%@`")


def _fail(lineno, path, why):
    raise ValueError("{}:{}: {}".format(path, lineno, why))


def _scalar(text, lineno, path):
    """A plain scalar's value under YAML 1.1's implicit resolution."""
    if text[:1] in _INDICATORS or text[:2] in ("- ", "? ", ": ") or text in ("-", "?", ":"):
        _fail(lineno, path, "{!r} is outside the YAML subset (quotes, flow collections, "
              "anchors, tags, block scalars)".format(text))
    if ": " in text or text.endswith(":") or text in ("<<", "="):
        _fail(lineno, path, "{!r}: a mapping inside a scalar".format(text))
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _DEC_INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _SPECIAL_FLOAT.match(text):
        return float(text.lower().replace(".", ""))
    if _OTHER_INT.match(text) or _OTHER_FLOAT.match(text) or _TIMESTAMP.match(text):
        _fail(lineno, path, "{!r}: octal, hex, binary, sexagesimal and timestamp scalars "
              "are outside the YAML subset".format(text))
    return text


def _strip_comment(text):
    """The line without a comment (`#` at its start or after a space)."""
    if text.startswith("#"):
        return ""
    cut = text.find(" #")
    return text if cut < 0 else text[:cut]


def _lines(stream, path):
    """(line number, indent, content) of every line that holds more than a
    comment."""
    out = []
    for lineno, raw in enumerate(stream.read().splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            _fail(lineno, path, "a tab in the indentation")
        body = _strip_comment(body).rstrip()
        if not body:
            continue
        if body in ("---", "..."):
            _fail(lineno, path, "document markers are outside the YAML subset")
        out.append((lineno, len(raw) - len(raw.lstrip(" ")), body))
    return out


def _block(lines, i, indent, path):
    """The block collection whose first line is lines[i], at `indent`;
    returns (value, index of the first line after it)."""
    if lines[i][2] == "-" or lines[i][2].startswith("- "):
        items = []
        while i < len(lines) and lines[i][1] == indent and \
                (lines[i][2] == "-" or lines[i][2].startswith("- ")):
            lineno, _, body = lines[i]
            item = body[1:].strip()
            if not item:
                _fail(lineno, path, "a nested list item is outside the YAML subset")
            items.append(_scalar(item, lineno, path))
            i += 1
        return items, i
    mapping = {}
    while i < len(lines) and lines[i][1] == indent:
        lineno, _, body = lines[i]
        if body == "-" or body.startswith("- "):
            _fail(lineno, path, "a list item where a mapping key was expected")
        if body.endswith(":"):
            key, rest = body[:-1], ""
        elif ": " in body:
            key, rest = body.split(": ", 1)
            rest = rest.strip()
        else:
            _fail(lineno, path, "{!r} is not a `key: value` line".format(body))
        key = _scalar(key.rstrip(), lineno, path)
        i += 1
        if rest:
            mapping[key] = _scalar(rest, lineno, path)
        elif i < len(lines) and (lines[i][1] > indent or (
                lines[i][1] == indent and (lines[i][2] == "-" or lines[i][2].startswith("- ")))):
            mapping[key], i = _block(lines, i, lines[i][1], path)
        else:
            mapping[key] = None
    if i < len(lines) and lines[i][1] > indent:
        _fail(lines[i][0], path, "unexpected indentation")
    return mapping, i


def parse_yaml(stream, path="<yaml>"):
    """The document in `stream` (a text file object), or None if it is
    empty."""
    lines = _lines(stream, path)
    if not lines:
        return None
    if lines[0][1] != 0:
        _fail(lines[0][0], path, "the document must start at column 0")
    doc, i = _block(lines, 0, 0, path)
    if i < len(lines):
        _fail(lines[i][0], path, "unexpected indentation")
    return doc


def load_yaml(path, key="parameters"):
    """The `key` section of a YAML config file (reference utils/io.py:7-12)."""
    with open(path, "r") as stream:
        return parse_yaml(stream, path)[key]


def _csv_cell(v):
    if v is None or (isinstance(v, (float, np.floating)) and math.isnan(v)):
        return ""
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


def save_csv(rows, path, name):
    """Write `rows` (a list of dicts) to path/name, one column per key in
    order of first appearance (reference utils/io.py:15-16, without
    pandas)."""
    columns = []
    for row in rows:
        columns += [k for k in row if k not in columns]
    with open(os.path.join(path, name), "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for row in rows:
            writer.writerow([_csv_cell(row.get(k)) for k in columns])


def check_ram_usage():
    """RSS of the current process in MB."""
    with open("/proc/self/statm") as f:
        resident_pages = int(f.read().split()[1])
    return resident_pages * os.sysconf("SC_PAGE_SIZE") / (1024 * 1024)
