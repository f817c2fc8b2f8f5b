"""Minimal YAML emitter/parser for configuration documents.

A copy of ``deeplearning4j_tpu/utils/yamlio.py`` (which imports no jax),
kept in the port so that it stands alone: both packages emit the same
text for the same tree. The reference round-trips configurations through
SnakeYAML via Jackson's ``mapperYaml()`` (NeuralNetConfiguration.java:
214-239 toYaml/fromYaml). The package takes no pyyaml dependency, so this
module implements the YAML subset those documents actually use — block
mappings, block sequences, JSON-style scalars (strings, ints, floats,
booleans, null) — with deterministic emission. It is NOT a general YAML
parser: anchors, tags, multi-line scalars, and flow collections beyond
empty ``{}``/``[]`` are rejected loudly rather than mis-parsed.
"""

from __future__ import annotations

import json
import re
from typing import Any, List, Tuple

_PLAIN_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_./+-]*$")


# ---------------------------------------------------------------------------
# emit
# ---------------------------------------------------------------------------

def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, (int, float)):
        return json.dumps(v)
    s = str(v)
    # quote anything YAML could reinterpret (numbers, booleans, null,
    # nan/inf spellings, leading specials, colons/hashes)
    if _PLAIN_RE.match(s) and s.lower() not in (
            "null", "true", "false", "yes", "no", "on", "off",
            "nan", "inf", "infinity", ".nan", ".inf") \
            and not re.match(r"^[0-9.+-]", s):
        return s
    return json.dumps(s)


def dump(obj: Any, indent: int = 0) -> str:
    """Emit ``obj`` (dict/list/scalar tree) as block-style YAML."""
    lines: List[str] = []
    _emit(obj, indent, lines)
    return "\n".join(lines) + "\n"


def _emit(obj: Any, indent: int, lines: List[str]) -> None:
    pad = "  " * indent
    if isinstance(obj, dict):
        if not obj:
            lines.append(f"{pad}{{}}")
            return
        for k, v in obj.items():
            key = _scalar(k)
            if isinstance(v, dict) and v:
                lines.append(f"{pad}{key}:")
                _emit(v, indent + 1, lines)
            elif isinstance(v, (list, tuple)) and len(v):
                lines.append(f"{pad}{key}:")
                _emit(list(v), indent + 1, lines)
            elif isinstance(v, dict):
                lines.append(f"{pad}{key}: {{}}")
            elif isinstance(v, (list, tuple)):
                lines.append(f"{pad}{key}: []")
            else:
                lines.append(f"{pad}{key}: {_scalar(v)}")
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            if isinstance(item, dict) and item:
                # first key inline with the dash, rest indented under it
                sub: List[str] = []
                _emit(item, indent + 1, sub)
                first = sub[0].lstrip()
                lines.append(f"{pad}- {first}")
                lines.extend(sub[1:])
            elif isinstance(item, (list, tuple)) and len(item):
                lines.append(f"{pad}-")
                _emit(list(item), indent + 1, lines)
            elif isinstance(item, dict):
                lines.append(f"{pad}- {{}}")
            elif isinstance(item, (list, tuple)):
                lines.append(f"{pad}- []")
            else:
                lines.append(f"{pad}- {_scalar(item)}")
    else:
        lines.append(f"{pad}{_scalar(obj)}")


# ---------------------------------------------------------------------------
# parse
# ---------------------------------------------------------------------------

class YamlError(ValueError):
    pass


def load(text: str) -> Any:
    """Parse the YAML subset emitted by :func:`dump` (and by typical
    Jackson/SnakeYAML block output)."""
    rows: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if raw.strip() in ("", "---") or raw.lstrip().startswith("#"):
            continue
        stripped = raw.lstrip(" ")
        rows.append((len(raw) - len(stripped), stripped))
    if not rows:
        return None
    value, nxt = _parse_block(rows, 0, rows[0][0])
    if nxt != len(rows):
        raise YamlError(f"trailing content at line {nxt}: {rows[nxt][1]!r}")
    return value


def _parse_scalar(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith('"'):
        return json.loads(tok)
    if tok.startswith("'") and tok.endswith("'") and len(tok) >= 2:
        return tok[1:-1].replace("''", "'")
    low = tok.lower()
    if low in ("null", "~", ""):
        return None
    if low == "true":
        return True
    if low == "false":
        return False
    if tok in ("{}",):
        return {}
    if tok in ("[]",):
        return []
    if tok.startswith("[") or tok.startswith("{"):
        try:
            return json.loads(tok)  # flow collections in JSON form
        except json.JSONDecodeError as e:
            raise YamlError(f"unsupported flow collection {tok!r}") from e
    if tok.startswith(("&", "*", "!", "|", ">")):
        raise YamlError(f"unsupported YAML feature in {tok!r}")
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


_KEY_RE = re.compile(r'^(?P<key>"(?:[^"\\]|\\.)*"|[^:#]+?):(?:\s+(?P<rest>.*))?$')


def _parse_block(rows, i: int, indent: int):
    """Parse rows[i:] at exactly ``indent``; returns (value, next_index)."""
    first = rows[i][1]
    if first.startswith("- "):
        return _parse_seq(rows, i, indent)
    if first == "-":
        return _parse_seq(rows, i, indent)
    return _parse_map(rows, i, indent)


def _parse_map(rows, i: int, indent: int):
    out = {}
    n = len(rows)
    while i < n:
        ind, line = rows[i]
        if ind < indent:
            break
        if ind > indent:
            raise YamlError(f"bad indentation at {line!r}")
        m = _KEY_RE.match(line)
        if not m or line.startswith("- "):
            raise YamlError(f"expected mapping entry, got {line!r}")
        key = _parse_scalar(m.group("key"))
        rest = m.group("rest")
        i += 1
        if rest is None or rest == "":
            # nested block (or empty value)
            if i < n and rows[i][0] > indent:
                out[key], i = _parse_block(rows, i, rows[i][0])
            elif i < n and rows[i][0] == indent and rows[i][1].startswith("-"):
                out[key], i = _parse_seq(rows, i, indent)
            else:
                out[key] = None
        else:
            out[key] = _parse_scalar(rest)
    return out, i


def _parse_seq(rows, i: int, indent: int):
    out = []
    n = len(rows)
    while i < n:
        ind, line = rows[i]
        if ind < indent or not line.startswith("-"):
            break
        if ind > indent:
            raise YamlError(f"bad sequence indentation at {line!r}")
        body = line[1:].lstrip()
        if body == "":
            i += 1
            if i < n and rows[i][0] > indent:
                item, i = _parse_block(rows, i, rows[i][0])
            else:
                item = None
            out.append(item)
            continue
        # a quoted scalar item ('- "conv: 1"') must not be mistaken for a
        # mapping: _KEY_RE would lazily match a prefix of the quoted token
        if body.startswith('"'):
            qm = re.match(r'^("(?:[^"\\]|\\.)*")\s*(.*)$', body)
            if qm and qm.group(2) == "":
                out.append(json.loads(qm.group(1)))
                i += 1
                continue
        # inline first entry: '- key: value' starts a nested map whose other
        # keys sit indented under the dash; '- scalar' is a plain item
        m = _KEY_RE.match(body)
        if m and m.group("rest") is not None or (m and body.endswith(":")):
            # re-inject as a virtual row at dash-body indentation
            virtual = [(ind + 2, body)]
            j = i + 1
            while j < n and rows[j][0] >= ind + 2:
                virtual.append(rows[j])
                j += 1
            item, used = _parse_map(virtual, 0, ind + 2)
            if used != len(virtual):
                raise YamlError(f"bad nested mapping under {line!r}")
            out.append(item)
            i = j
        else:
            out.append(_parse_scalar(body))
            i += 1
    return out, i
