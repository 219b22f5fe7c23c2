"""A YAML subset reader and writer, in place of PyYAML's ``safe_load`` /
``safe_dump`` for the port's model configs (.nemo and .qasr archives, NeMo
model YAMLs); the GPU machine has no PyYAML.

``safe_load`` reads block mappings and sequences (indentless ones too, and
compact ``- key: value`` entries), flow collections over one or more lines,
plain / single- / double-quoted scalars (multi-line ones folded), comments,
anchors and aliases (``safe_dump`` writes them for a shared list or dict)
and one document;
plain scalars resolve as PyYAML's YAML 1.1 resolver does (``yes`` / ``off``
are booleans, ``1e-05`` a string and ``1.0e-05`` a float, ``~`` and
``null`` None, ``.inf`` a float, ``0x1f`` / ``017`` / ``1_000`` integers,
``2020-01-02`` a date).  Anything else (tags, block scalars, complex
keys, merge keys) raises ``ValueError``.

``safe_dump`` writes dicts, lists, tuples, strings, ints, floats, bools,
dates and None in block style: a string goes plain only where it reads back as the
same string, else double-quoted; floats always carry a '.' (``1.0e-05``),
so ``safe_load`` and PyYAML's read back what was written.
"""
from __future__ import annotations

import datetime
import math
import re
from typing import Any, Dict, List, Optional, Tuple

_BOOL = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}
_BOOL_WORDS = {w for k in _BOOL for w in (k, k.capitalize(), k.upper())}
_NULL_WORDS = {"~", "null", "Null", "NULL", ""}
# PyYAML's implicit resolvers (resolver.py), tried in its order
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_DATE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]$")
_TIMESTAMP = re.compile(r"""^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
    (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?$""", re.X)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")


def _sexagesimal(value: str, conv):
    total, base = 0, 1
    for part in reversed(value.split(":")):
        total += conv(part) * base
        base *= 60
    return total


def _int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(value: str) -> Any:
    """A plain scalar's value under PyYAML's YAML 1.1 implicit resolvers."""
    if value in _BOOL_WORDS:
        return _BOOL[value.lower()]
    if value and value[0] in "-+0123456789.":
        if _FLOAT.match(value):
            return _float(value)
        if _INT.match(value):
            return _int(value)
    if value in _NULL_WORDS:
        return None
    if _DATE.match(value):
        return datetime.date(int(value[:4]), int(value[5:7]), int(value[8:]))
    if _TIMESTAMP.match(value):
        raise ValueError(f"yaml_io: timestamps are not supported: {value!r}")
    return value


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, text: str):
        self.lines = text.replace("\r\n", "\n").replace("\r", "\n").split("\n")
        self.li = 0
        self.anchors: Dict[str, Any] = {}

    # -- lines ------------------------------------------------------------------

    @staticmethod
    def _indent(line: str) -> int:
        return len(line) - len(line.lstrip(" "))

    def _skip_blank(self) -> None:
        while self.li < len(self.lines):
            s = self.lines[self.li].strip()
            if s and not s.startswith("#"):
                return
            self.li += 1

    def _at_end(self) -> bool:
        self._skip_blank()
        return self.li >= len(self.lines) or self.lines[self.li].rstrip() in ("---", "...")

    def _err(self, msg: str, col: int = 0) -> ValueError:
        return ValueError(f"yaml_io: line {self.li + 1} col {col + 1}: {msg}")

    # -- document ------------------------------------------------------------

    def document(self) -> Any:
        self._skip_blank()
        while self.li < len(self.lines) and self.lines[self.li].startswith("%"):
            self.li += 1
            self._skip_blank()
        if self.li < len(self.lines):
            line = self.lines[self.li]
            if line.rstrip() == "---":
                self.li += 1
            elif line.startswith("--- "):
                self.lines[self.li] = "    " + line[4:]
        value = self.block_node(0, -1)
        self._skip_blank()
        if self.li < len(self.lines) and self.lines[self.li].rstrip() == "...":
            self.li += 1
            self._skip_blank()
        if self.li < len(self.lines):
            raise self._err("expected the end of the document")
        return value

    # -- block collections -------------------------------------------------------

    def block_node(self, min_indent: int, parent: int, after_key: bool = False) -> Any:
        """The node whose first line is the next non-blank line, if it is
        indented at least ``min_indent``; else None (an empty node).
        ``after_key``: the node starts on its key's line, where no block
        collection may start."""
        if self._at_end():
            return None
        line = self.lines[self.li]
        ind = self._indent(line)
        if ind < min_indent:
            return None
        body = line[ind:]
        anchor, col = self._anchor(ind)
        rest = "" if line[col:].startswith("#") else line[col:].split(" #")[0].strip()
        if col != ind and not rest:     # an anchor alone on the line: the node follows
            self.li += 1
            return self._finish(anchor, self.block_node(parent + 1, parent))
        is_seq = body == "-" or body.startswith("- ")
        is_map = self._map_key_end(self.li, col) is not None
        if after_key and (is_seq or is_map):
            raise self._err("a block collection cannot start on its key's line", ind)
        if is_seq:
            return self.block_seq(ind)
        if is_map:
            return self.block_map(ind)      # an anchor here is the first key's
        return self._finish(anchor, self.inline_value(col, parent))

    def _finish(self, anchor, value):
        if anchor is not None:
            self.anchors[anchor] = value
        return value

    def _anchor(self, col: int) -> Tuple[Optional[str], int]:
        """An anchor ``&a`` at ``col``: (its name or None, the column after
        it).  Tags raise."""
        line = self.lines[self.li]
        if line[col:col + 1] == "!":
            raise self._err("tags are not supported", col)
        if line[col:col + 1] != "&":
            return None, col
        m = re.compile(r"&([^ \t,\[\]{}]*)").match(line, col)
        col = m.end()
        while col < len(line) and line[col] == " ":
            col += 1
        return m.group(1), col

    def block_seq(self, ind: int) -> List[Any]:
        out = []
        while not self._at_end():
            line = self.lines[self.li]
            if self._indent(line) != ind:
                break
            body = line[ind:]
            if not (body == "-" or body.startswith("- ")):
                break
            if body.strip() == "-":
                self.li += 1
                out.append(self.block_node(ind + 1, ind))
            else:
                # the entry's node starts after "- ": blank the indicator, so a
                # compact mapping's later keys line up with its first
                self.lines[self.li] = line[:ind] + " " + line[ind + 1:]
                out.append(self.block_node(ind + 1, ind))
        return out

    def block_map(self, ind: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        while not self._at_end():
            line = self.lines[self.li]
            if self._indent(line) != ind:
                if self._indent(line) > ind:
                    raise self._err("bad indentation of a mapping entry", self._indent(line))
                break
            anchor, kcol = self._anchor(ind)
            end = self._map_key_end(self.li, kcol)
            if end is None:
                break
            key_end, colon = end
            key = self._finish(anchor, self._key(line[kcol:key_end].rstrip(), kcol))
            col = colon + 1
            while col < len(line) and line[col] == " ":
                col += 1
            if col >= len(line) or line[col] == "#":
                self.li += 1
                if not self._at_end():
                    nxt = self.lines[self.li]
                    nb = nxt[self._indent(nxt):]
                    if self._indent(nxt) == ind and (nb == "-" or nb.startswith("- ")):
                        out[key] = self.block_seq(ind)
                        continue
                out[key] = self.block_node(ind + 1, ind)
            else:
                self.lines[self.li] = " " * col + line[col:]
                out[key] = self.block_node(col, ind, after_key=True)
        return out

    def _key(self, text: str, col: int) -> Any:
        if text[:1] in "'\"":
            return _Flow(text, self).quoted(0)[0]
        if text[:1] in _INDICATORS - {"-", "?", ":"} or text.startswith("? "):
            raise self._err(f"unsupported mapping key {text!r}", col)
        if text in ("<<",):
            raise self._err("merge keys are not supported", col)
        return resolve_plain(text)

    def _map_key_end(self, li: int, col: int) -> Optional[Tuple[int, int]]:
        """If the line holds a mapping key at ``col``: (the key's end, the
        column of its ':'), else None."""
        line = self.lines[li]
        if col >= len(line):
            return None
        c = line[col]
        if c in "'\"":
            try:
                _, end = _Flow(line, self).quoted(col)
            except ValueError:
                return None
            j = end
            while j < len(line) and line[j] == " ":
                j += 1
            if j < len(line) and line[j] == ":" and (j + 1 == len(line) or line[j + 1] == " "):
                return end, j
            return None
        if c in "[{|>#&*!%@`" or (c == "-" and line[col:col + 2] in ("- ", "-")):
            return None
        j = col
        while j < len(line):
            if line[j] == ":" and (j + 1 == len(line) or line[j + 1] == " "):
                return j, j
            if line[j] == "#" and j > col and line[j - 1] == " ":
                return None
            j += 1
        return None

    # -- scalars and flow collections on a block line ---------------------------------

    def inline_value(self, col: int, parent: int) -> Any:
        """The node at (current line, ``col``): a flow collection, a quoted,
        plain or block scalar or an alias; multi-line scalars continue on
        lines indented more than ``parent``."""
        line = self.lines[self.li]
        c = line[col]
        if c == "*":
            m = re.compile(r"\*([^ \t,\[\]{}]+)").match(line, col)
            name = m.group(1)
            if name not in self.anchors:
                raise self._err(f"unknown alias *{name}", col)
            self._expect_line_end(m.end())
            return self.anchors[name]
        if c in "|>!":
            raise self._err("block scalars and tags are not supported", col)
        if c in "[{'\"":
            fl = _Flow(None, self, self.li, col)
            value = fl.node() if c in "[{" else fl.multiline_quoted()
            self.li = fl.li
            self._expect_line_end(fl.col)
            return value
        return self._plain_multiline(col, parent)

    def _expect_line_end(self, col: int) -> None:
        rest = self.lines[self.li][col:]
        if rest.strip() and not rest.lstrip().startswith("#"):
            raise self._err(f"unexpected text after a node: {rest.strip()!r}", col)
        self.li += 1

    def _plain_multiline(self, col: int, parent: int) -> Any:
        line = self.lines[self.li]
        text = _plain_part(line[col:])
        if ": " in text or text.endswith(":"):
            raise self._err("a mapping value is not allowed here", col)
        parts = [text]
        self.li += 1
        breaks = 0
        while text == line[col:].strip() and self.li < len(self.lines):
            nxt = self.lines[self.li]
            s = nxt.strip()
            if not s:
                breaks += 1
                self.li += 1
                continue
            if self._indent(nxt) <= parent or s.startswith("#") or s in ("---", "..."):
                break
            part = _plain_part(s)
            if ": " in part or part.endswith(":"):
                raise self._err("a mapping value is not allowed here")
            parts.append("\n" * breaks if breaks else " ")
            parts.append(part)
            breaks = 0
            self.li += 1
            if part != s:       # a comment ends the scalar
                break
        return resolve_plain("".join(parts))


def _plain_part(s: str) -> str:
    """A plain scalar's text on one line: up to a comment, stripped."""
    i = s.find(" #")
    return (s if i < 0 else s[:i]).strip()


class _Flow:
    """A cursor over the text from (line, col) on, for flow collections and
    quoted scalars, which may span lines."""

    def __init__(self, text: Optional[str], reader: _Reader, li: int = 0, col: int = 0):
        self.reader = reader
        self.lines = [text] if text is not None else reader.lines
        self.li, self.col = li, col

    def _ch(self) -> str:
        line = self.lines[self.li]
        return line[self.col] if self.col < len(line) else "\n"

    def _skip(self) -> None:
        """Whitespace, line breaks and comments."""
        while self.li < len(self.lines):
            line = self.lines[self.li]
            while self.col < len(line) and line[self.col] in " \t":
                self.col += 1
            if self.col < len(line) and line[self.col] != "#":
                return
            self.li, self.col = self.li + 1, 0
        raise ValueError("yaml_io: unterminated flow collection")

    def node(self) -> Any:
        self._skip()
        c = self._ch()
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in "'\"":
            return self.multiline_quoted()
        if c == "*":
            m = re.compile(r"\*([^ \t,\[\]{}]+)").match(self.lines[self.li], self.col)
            self.col = m.end()
            return self.reader.anchors[m.group(1)]
        return resolve_plain(self._plain())

    def _plain(self) -> str:
        """A plain scalar in a flow collection: up to an indicator or a
        comment, its line breaks folded."""
        parts: List[str] = []
        while True:
            line = self.lines[self.li]
            j = self.col
            while j < len(line):
                c = line[j]
                if c in ",[]{}" or (c == ":" and (j + 1 == len(line) or line[j + 1] in " ,[]{}")):
                    break
                if c == "#" and (j == 0 or line[j - 1] == " "):
                    break
                j += 1
            parts.append(line[self.col:j].strip())
            self.col = j
            if j < len(line):
                break
            # the line ended inside the scalar: it goes on at the next
            # non-blank line unless that starts with an indicator or a comment
            k, breaks = self.li + 1, 0
            while k < len(self.lines) and not self.lines[k].strip():
                k, breaks = k + 1, breaks + 1
            if k == len(self.lines):
                break
            nxt = self.lines[k].lstrip(" \t")
            if nxt[0] in ",[]{}#" or nxt.startswith(": ") or nxt == ":":
                break
            parts.append("\n" * breaks if breaks else " ")
            self.li, self.col = k, len(self.lines[k]) - len(nxt)
        return "".join(parts)

    def _seq(self) -> List[Any]:
        self.col += 1
        out: List[Any] = []
        while True:
            self._skip()
            if self._ch() == "]":
                self.col += 1
                return out
            out.append(self.node())
            self._skip()
            c = self._ch()
            if c == ",":
                self.col += 1
            elif c != "]":
                raise ValueError(f"yaml_io: expected ',' or ']' in a flow sequence, got {c!r}")

    def _map(self) -> Dict[Any, Any]:
        self.col += 1
        out: Dict[Any, Any] = {}
        while True:
            self._skip()
            if self._ch() == "}":
                self.col += 1
                return out
            key = self.node()
            self._skip()
            if self._ch() == ":":
                self.col += 1
                self._skip()
                value = None if self._ch() in ",}" else self.node()
            else:
                value = None
            out[key] = value
            self._skip()
            c = self._ch()
            if c == ",":
                self.col += 1
            elif c != "}":
                raise ValueError(f"yaml_io: expected ',' or '}}' in a flow mapping, got {c!r}")

    def quoted(self, col: int) -> Tuple[str, int]:
        """A one-line quoted scalar at ``col`` of the first line: (value,
        the column after its closing quote)."""
        self.li, self.col = 0, col
        value = self.multiline_quoted()
        if self.li != 0:
            raise ValueError("yaml_io: a quoted key must end on its line")
        return value, self.col

    def multiline_quoted(self) -> str:
        q = self._ch()
        self.col += 1
        out: List[str] = []
        while True:
            if self.li >= len(self.lines):
                raise ValueError("yaml_io: unterminated quoted scalar")
            line = self.lines[self.li]
            if self.col >= len(line):
                # a line break inside the scalar: fold it
                while out and out[-1] in (" ", "\t"):
                    out.pop()
                breaks = 0
                while True:
                    self.li, self.col = self.li + 1, 0
                    if self.li >= len(self.lines):
                        raise ValueError("yaml_io: unterminated quoted scalar")
                    nxt = self.lines[self.li]
                    if nxt.strip():
                        break
                    breaks += 1
                nxt = self.lines[self.li]
                self.col = len(nxt) - len(nxt.lstrip(" \t"))
                out.append("\n" * breaks if breaks else " ")
                continue
            c = line[self.col]
            if q == "'":
                if c == "'":
                    if line[self.col + 1:self.col + 2] == "'":
                        out.append("'")
                        self.col += 2
                        continue
                    self.col += 1
                    return "".join(out)
                out.append(c)
                self.col += 1
                continue
            if c == '"':
                self.col += 1
                return "".join(out)
            if c == "\\":
                e = line[self.col + 1:self.col + 2]
                if e == "":         # an escaped line break: join without a space
                    self.li, self.col = self.li + 1, 0
                    if self.li >= len(self.lines):
                        raise ValueError("yaml_io: unterminated quoted scalar")
                    nxt = self.lines[self.li]
                    self.col = len(nxt) - len(nxt.lstrip(" \t"))
                    continue
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.col += 2
                    continue
                if e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    out.append(chr(int(line[self.col + 2:self.col + 2 + n], 16)))
                    self.col += 2 + n
                    continue
                raise ValueError(f"yaml_io: unknown escape \\{e}")
            out.append(c)
            self.col += 1


def safe_load(stream) -> Any:
    """The document in ``stream`` (a str or a text file), as PyYAML's
    ``yaml.safe_load`` reads the subset this module takes."""
    text = stream if isinstance(stream, str) else stream.read()
    if text.startswith("\ufeff"):
        text = text[1:]
    return _Reader(text).document()


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------


def _plain_ok(s: str) -> bool:
    return (bool(s) and s == s.strip() and s[0] not in _INDICATORS and s not in ("=", "<<")
            and not any(t in s for t in (": ", " #", "\t", "\n", "\r"))
            and not s.endswith(":") and not s.startswith(("---", "..."))
            and s.isprintable() and isinstance(_resolve_or_none(s), str))


def _resolve_or_none(s: str):
    try:
        return resolve_plain(s)
    except ValueError:
        return None


def _quote(s: str) -> str:
    out = ['"']
    for ch in s:
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif ch.isprintable() or ch == " ":
            out.append(ch)
        elif ord(ch) < 0x100:
            out.append(f"\\x{ord(ch):02x}")
        elif ord(ch) < 0x10000:
            out.append(f"\\u{ord(ch):04x}")
        else:
            out.append(f"\\U{ord(ch):08x}")
    out.append('"')
    return "".join(out)


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "." not in r and "e" in r:    # 1e-05 would read back as a string
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, str):
        return v if _plain_ok(v) else _quote(v)
    if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime):
        return v.isoformat()
    raise TypeError(f"yaml_io: cannot write a {type(v).__name__}")


def _emit(v: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for k, item in v.items():
            key = _scalar(k)
            if isinstance(item, (dict, list, tuple)) and item:
                out.append(f"{pad}{key}:")
                _emit(item, indent + 2, out)
            else:
                out.append(f"{pad}{key}: {_inline(item)}")
    else:
        for item in v:
            if isinstance(item, (dict, list, tuple)) and item:
                start = len(out)
                _emit(item, indent + 2, out)
                out[start] = pad + "- " + out[start][indent + 2:]
            else:
                out.append(f"{pad}- {_inline(item)}")


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def safe_dump(data: Any, stream=None) -> Optional[str]:
    """Write ``data`` in block style; to ``stream`` (a text file) if given,
    else return the text."""
    if isinstance(data, (dict, list, tuple)) and data:
        lines: List[str] = []
        _emit(data, 0, lines)
        text = "\n".join(lines) + "\n"
    else:
        text = _inline(data) + "\n"
    if stream is None:
        return text
    stream.write(text)
    return None
