"""rosbag2 metadata.yaml read/write, with no YAML package.

``write_metadata`` emits the text that ``yaml.safe_dump(meta,
sort_keys=False)`` gives for the same mapping, byte for byte: block
mappings, indentless block sequences, ``[]`` / ``{}`` for empty ones, and
each string plain, single- or double-quoted with PyYAML's choice of style,
its escapes and its folding at 80 columns. ``read_metadata`` reads that
text and the subset that rosbag2 itself writes: block mappings, block
sequences (indented or not) of mappings or scalars, plain, single- and
double-quoted scalars over one or more lines, ``[]`` / ``{}``, comments,
and the YAML 1.1 null, bool, int and float forms that ``yaml.safe_load``
resolves. Anchors, tags, flow collections with content and block scalars
(``|``, ``>``) are not part of that subset and raise ``ValueError``.
"""

from __future__ import annotations

import pathlib
import re
from typing import Dict, List, Optional

WIDTH = 80  # PyYAML's best_width
_BREAKS = "\n\x85\u2028\u2029"
_SPACE_OR_BREAK = "\0 \t\r\n\x85\u2028\u2029"

# YAML 1.1 implicit types as PyYAML resolves them (timestamps stay strings)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                        r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_OTHER = re.compile(r"^(?:<<|=)$")
_IMPLICIT = (_BOOL, _FLOAT, _INT, _NULL, _TIMESTAMP, _OTHER)
_KEY = re.compile(r"([^\s'\"#:\[{|>&*!%@`-][^:]*?):(?:\s+|$)")  # plain keys only

_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0a": "n", "\x0b": "v",
            "\x0c": "f", "\x0d": "r", "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N",
            "\xa0": "_", "\u2028": "L", "\u2029": "P"}
_UNESCAPES = {v: k for k, v in _ESCAPES.items()}
_UNESCAPES.update({" ": " ", "\t": "\t", "/": "/"})


# ---------------------------------------------------------------------------
# emitter
# ---------------------------------------------------------------------------


def _styles(s: str):
    """(block plain, single-quoted) allowed for ``s`` as a block value: the
    analysis of PyYAML's ``Emitter.analyze_scalar`` with ASCII output."""
    if not s:
        return True, True
    block_ind = s.startswith("---") or s.startswith("...")
    breaks = special = False
    lead_sp = s[0] == " "
    lead_br = s[0] in _BREAKS
    trail_sp = s[-1] == " "
    trail_br = s[-1] in _BREAKS
    break_space = space_break = False
    prev_sp = prev_br = False
    for i, ch in enumerate(s):
        before_ws = i == 0 or s[i - 1] in _SPACE_OR_BREAK
        after_ws = i + 1 >= len(s) or s[i + 1] in _SPACE_OR_BREAK
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`" or (ch in "?:-" and after_ws):
                block_ind = True
        elif (ch == ":" and after_ws) or (ch == "#" and before_ws):
            block_ind = True
        if ch in _BREAKS:
            breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7e"):
            special = True
        if ch == " ":
            break_space |= prev_br
            prev_sp, prev_br = True, False
        elif ch in _BREAKS:
            space_break |= prev_sp
            prev_sp, prev_br = False, True
        else:
            prev_sp = prev_br = False
    plain = not (lead_sp or lead_br or trail_sp or trail_br or break_space or space_break
                 or special or breaks or block_ind)
    single = not (break_space or space_break or special)
    return plain, single


class _Out:
    """The column-tracking writer of PyYAML's emitter, for one scalar."""

    def __init__(self, column: int, indent: int):
        self.parts: List[str] = []
        self.column = column
        self.indent = indent
        self.whitespace = False
        self.indention = False

    def write(self, data: str):
        self.column += len(data)
        self.parts.append(data)

    def line_break(self, data: str = "\n"):
        self.whitespace = self.indention = True
        self.column = 0
        self.parts.append(data)

    def write_indent(self):
        if not self.indention or self.column > self.indent or (
                self.column == self.indent and not self.whitespace):
            self.line_break()
        if self.column < self.indent:
            self.whitespace = True
            self.parts.append(" " * (self.indent - self.column))
            self.column = self.indent

    def plain(self, text: str):
        self.write(" ")
        spaces = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > WIDTH:
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch == " ":
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces = ch == " "
            end += 1

    def single_quoted(self, text: str):
        self.write(" '")
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > WIDTH and start != 0
                            and end != len(text)):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    if text[start] == "\n":
                        self.line_break()
                    for br in text[start:end]:
                        self.line_break(br)
                    self.write_indent()
                    start = end
            elif ch is None or ch in " " + _BREAKS or ch == "'":
                if start < end:
                    self.write(text[start:end])
                    start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces = ch == " "
                breaks = ch in _BREAKS
            end += 1
        self.write("'")

    def double_quoted(self, text: str):
        self.write(' "')
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\x85\u2028\u2029\ufeff' or not "\x20" <= ch <= "\x7e":
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _ESCAPES:
                        data = "\\" + _ESCAPES[ch]
                    elif ch <= "\xff":
                        data = "\\x%02X" % ord(ch)
                    elif ch <= "\uffff":
                        data = "\\u%04X" % ord(ch)
                    else:
                        data = "\\U%08X" % ord(ch)
                    self.write(data)
                    start = end + 1
            if (0 < end < len(text) - 1 and (ch == " " or start >= end)
                    and self.column + (end - start) > WIDTH):
                data = text[start:end] + "\\"
                if start < end:
                    start = end
                self.write(data)
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
            end += 1
        self.write('"')


def _scalar(value, column: int, indent: int) -> str:
    """`` value`` as PyYAML writes a block value that starts at ``column``
    (continuation lines at ``indent``)."""
    if value is None:
        return " null"
    if isinstance(value, bool):
        return " true" if value else " false"
    if isinstance(value, int):
        return f" {value}"
    if not isinstance(value, str):
        raise TypeError(f"metadata.yaml holds str, int, bool or None, not {type(value)}")
    plain, single = _styles(value)
    out = _Out(column, indent)
    if plain and not any(r.match(value) for r in _IMPLICIT):
        out.plain(value)
    elif single:
        out.single_quoted(value)
    else:
        out.double_quoted(value)
    return "".join(out.parts)


def _key(key) -> str:
    if not (isinstance(key, str) and key and _styles(key)[0] and "\n" not in key
            and not any(r.match(key) for r in _IMPLICIT)):
        raise ValueError(f"metadata.yaml key {key!r} is not a plain scalar")
    return key


def _mapping(m: Dict, indent: int, first_column: Optional[int] = None) -> List[str]:
    """Lines of a block mapping at ``indent``; the first key continues the
    current line when ``first_column`` is given (a sequence entry)."""
    lines = []
    for n, (key, value) in enumerate(m.items()):
        lead = "" if n == 0 and first_column is not None else " " * indent
        head = lead + _key(key) + ":"
        column = indent + len(key) + 1
        if isinstance(value, dict) and value:
            lines.append(head)
            lines.extend(_mapping(value, indent + 2))
        elif isinstance(value, list) and value:
            lines.append(head)
            lines.extend(_sequence(value, indent))
        elif isinstance(value, (dict, list)):
            lines.append(head + (" {}" if isinstance(value, dict) else " []"))
        else:
            lines.append(head + _scalar(value, column, indent + 2))
    return lines


def _sequence(seq: List, indent: int) -> List[str]:
    lines = []
    for item in seq:
        lead = " " * indent + "-"
        if isinstance(item, dict) and item:
            sub = _mapping(item, indent + 2, first_column=indent + 2)
            lines.append(lead + " " + sub[0])
            lines.extend(sub[1:])
        elif isinstance(item, list) and item:
            raise ValueError("metadata.yaml holds no sequence of sequences")
        elif isinstance(item, (dict, list)):
            lines.append(lead + (" {}" if isinstance(item, dict) else " []"))
        else:
            lines.append(lead + _scalar(item, indent + 1, indent + 2))
    return lines


def dump(mapping: Dict) -> str:
    """The block-style text of ``yaml.safe_dump(mapping, sort_keys=False)``
    for a mapping of mappings, sequences, str, int, bool and None."""
    return "\n".join(_mapping(mapping, 0)) + "\n"


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


def _indent_of(line: str) -> int:
    return len(line) - len(line.lstrip(" "))


def _resolve(s: str):
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s) and ":" not in s:
        t = s.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(s) and ":" not in s:
        t = s.replace("_", "").lower()
        if t.endswith((".inf", ".nan")):
            return float(t.replace(".", ""))
        return float(t)
    return s


class _Reader:
    def __init__(self, text: str):
        self.lines = text.splitlines()
        self.i = 0

    def _skip(self):
        while self.i < len(self.lines):
            s = self.lines[self.i].strip()
            if s and not s.startswith("#") and s not in ("---", "..."):
                return
            self.i += 1

    def _peek(self):
        self._skip()
        return self.lines[self.i] if self.i < len(self.lines) else None

    @staticmethod
    def _is_entry(content: str) -> bool:
        return content == "-" or content.startswith("- ")

    def node(self, min_indent: int):
        line = self._peek()
        if line is None or _indent_of(line) < min_indent:
            return None
        if self._is_entry(line.lstrip(" ")):
            return self.sequence(_indent_of(line))
        return self.mapping(_indent_of(line))

    def mapping(self, indent: int) -> Dict:
        out = {}
        while True:
            line = self._peek()
            if line is None or _indent_of(line) != indent or self._is_entry(line[indent:]):
                return out
            content = line[indent:]
            m = _KEY.match(content)
            if m is None:
                raise ValueError(f"metadata.yaml line {self.i + 1}: no key in {line!r}")
            key = m.group(1)
            rest = content[m.end():]
            self.i += 1
            if rest.strip() == "" or rest.lstrip().startswith("#"):
                nxt = self._peek()
                if nxt is not None and _indent_of(nxt) == indent and self._is_entry(nxt[indent:]):
                    out[key] = self.sequence(indent)
                else:
                    out[key] = self.node(indent + 1)
            else:
                out[key] = self.scalar(rest, indent)

    def sequence(self, indent: int) -> List:
        out = []
        while True:
            line = self._peek()
            if line is None or _indent_of(line) != indent or not self._is_entry(line[indent:]):
                return out
            rest = line[indent + 1:]
            content = rest.lstrip(" ")
            if content == "" or content.startswith("#"):
                self.i += 1
                out.append(self.node(indent + 1))
                continue
            column = indent + 1 + len(rest) - len(content)
            if _KEY.match(content):
                # a mapping that starts on the entry's line: parse it at its column
                self.lines[self.i] = " " * column + content
                out.append(self.mapping(column))
            else:
                self.i += 1
                out.append(self.scalar(content, indent))
        return out

    def _continuation(self, parent_indent: int) -> List[str]:
        """The following lines indented past ``parent_indent`` (blank ones
        included), consumed."""
        more = []
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.strip() and _indent_of(line) <= parent_indent:
                break
            more.append(line)
            self.i += 1
        while more and not more[-1].strip():
            more.pop()
            self.i -= 1
        return more

    def scalar(self, text: str, parent_indent: int):
        text = text.strip()
        if text[0] in "'\"":
            quote = text[0]
            body = text[1:]
            while not self._closed(body, quote):
                if self.i >= len(self.lines):
                    raise ValueError("metadata.yaml: unterminated quoted scalar")
                body += "\n" + self.lines[self.i]
                self.i += 1
            end = self._close_at(body, quote)
            tail = body[end + 1:].strip()
            if tail and not tail.startswith("#"):
                raise ValueError(f"metadata.yaml: text after a quoted scalar: {tail!r}")
            return _unquote(body[:end], quote)
        if text in ("[]", "{}"):
            return [] if text == "[]" else {}
        if text[0] in "[{|>&*!%@`":
            raise ValueError(f"metadata.yaml: unsupported scalar {text!r}")
        lines = [_strip_comment(text)] + [_strip_comment(s.strip())
                                          for s in self._continuation(parent_indent)]
        return _resolve(_fold(lines))

    @staticmethod
    def _close_at(body: str, quote: str) -> int:
        i = 0
        while i < len(body):
            if quote == "'" and body[i] == "'":
                if body[i + 1:i + 2] == "'":
                    i += 2
                    continue
                return i
            if quote == '"':
                if body[i] == "\\":
                    i += 2
                    continue
                if body[i] == '"':
                    return i
            i += 1
        return -1

    def _closed(self, body: str, quote: str) -> bool:
        return self._close_at(body, quote) >= 0


def _strip_comment(s: str) -> str:
    m = re.search(r"\s#", s)
    return s[:m.start()].rstrip() if m else s


def _fold(lines: List[str], closed: bool = False) -> str:
    """Flow folding: a single line break between two lines is a space, n+1
    breaks (n empty lines) are n newlines. With ``closed``, the last line
    holds the closing quote and counts as a line even when it is empty."""
    out = lines[0]
    empty = 0
    for j, s in enumerate(lines[1:], 1):
        if not s and not (closed and j == len(lines) - 1):
            empty += 1
            continue
        out += ("\n" * empty if empty else " ") + s
        empty = 0
    return out


def _unquote(body: str, quote: str) -> str:
    lines = body.split("\n")
    if quote == "'":
        parts = [lines[0].rstrip(" \t") if len(lines) > 1 else lines[0]]
        parts += [s.strip(" \t") for s in lines[1:-1]]
        if len(lines) > 1:
            parts.append(lines[-1].lstrip(" \t"))
        return _fold(parts, closed=True).replace("''", "'")
    out = []
    i = 0
    n = len(body)
    while i < n:
        ch = body[i]
        if ch == "\\":
            nxt = body[i + 1]
            if nxt == "\n":  # escaped line break: join, drop the indentation
                i += 2
                while i < n and body[i] in " \t":
                    i += 1
                continue
            if nxt in "xuU":
                width = {"x": 2, "u": 4, "U": 8}[nxt]
                out.append(chr(int(body[i + 2:i + 2 + width], 16)))
                i += 2 + width
                continue
            if nxt not in _UNESCAPES:
                raise ValueError(f"metadata.yaml: unknown escape \\{nxt}")
            out.append(_UNESCAPES[nxt])
            i += 2
            continue
        if ch == "\n":  # folded line break
            while out and out[-1] in (" ", "\t"):
                out.pop()
            empty = 0
            i += 1
            while True:
                while i < n and body[i] in " \t":
                    i += 1
                if i < n and body[i] == "\n":
                    empty += 1
                    i += 1
                    continue
                break
            out.append("\n" * empty if empty else " ")
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def load(text: str):
    """The document of a metadata.yaml text (see the module docstring for
    the subset read)."""
    r = _Reader(text)
    doc = r.node(0)
    if r._peek() is not None:
        raise ValueError(f"metadata.yaml line {r.i + 1}: unexpected {r.lines[r.i]!r}")
    return doc


# ---------------------------------------------------------------------------
# the rosbag2 file
# ---------------------------------------------------------------------------


def write_metadata(
    bag_dir: pathlib.Path,
    storage_identifier: str,
    relative_file_paths: List[str],
    topics: List[Dict],
    message_count: int,
    starting_time_ns: int = 0,
    duration_ns: int = 0,
):
    meta = {
        "rosbag2_bagfile_information": {
            "version": 5,
            "storage_identifier": storage_identifier,
            "relative_file_paths": relative_file_paths,
            "duration": {"nanoseconds": duration_ns},
            "starting_time": {"nanoseconds_since_epoch": starting_time_ns},
            "message_count": message_count,
            "topics_with_message_count": [
                {
                    "topic_metadata": {
                        "name": t["name"],
                        "type": t["type"],
                        "serialization_format": "cdr",
                        "offered_qos_profiles": t.get("qos", ""),
                    },
                    "message_count": t.get("message_count", 0),
                }
                for t in topics
            ],
            "compression_format": "",
            "compression_mode": "",
        }
    }
    with open(pathlib.Path(bag_dir) / "metadata.yaml", "w") as f:
        f.write(dump(meta))


def read_metadata(bag_dir: pathlib.Path) -> Optional[Dict]:
    p = pathlib.Path(bag_dir) / "metadata.yaml"
    if not p.exists():
        return None
    doc = load(p.read_text())
    return doc.get("rosbag2_bagfile_information") if doc else None
