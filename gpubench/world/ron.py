# Frozen copy of voxelraytracing_tpu_torch/resources/ron.py at commit 5046bbb1c27cf55a0e0985dd2724f80b90766057
# (the benchmark's yardstick: later changes to the program do not reach it).
# Copied unchanged.

"""A small RON (Rusty Object Notation) parser.

The engine's data packs use RON, the same data language the reference engine
reads with serde (common/src/resources/loader.rs). This is a from-scratch
recursive-descent parser for the subset RON packs actually use:

  * scalars: integers, floats, strings, ``true``/``false``
  * lists ``[a, b, c]`` and maps ``{key: value}``
  * tuples ``(a, b)`` and anonymous structs ``(field: value, ...)``
  * named structs / enum variants ``Name(...)``, unit variants ``Name``
  * line comments ``// ...`` and block comments ``/* ... */``
  * trailing commas everywhere

Parsed values map to Python as: list -> list, tuple -> tuple,
struct -> :class:`Struct` (dict-like with a ``.tag``), unit variant ->
:class:`Struct` with empty fields, map -> dict.

Port of ``voxelraytracing_tpu/resources/ron.py`` (pure Python, unchanged).
"""

import re


class RonError(ValueError):
    pass


class Struct(dict):
    """A (possibly named) RON struct: field dict plus a ``tag``.

    ``Struct("Map", {"freq": 0.1})`` models ``Map(freq: 0.1)``. Tuple-style
    payloads of named variants, e.g. ``Value(3.0)``, are stored under the
    key ``_args`` as a tuple.
    """

    def __init__(self, tag, fields=None, args=None):
        super().__init__(fields or {})
        self.tag = tag
        if args is not None:
            self["_args"] = tuple(args)

    @property
    def args(self):
        return self.get("_args", ())

    def __repr__(self):
        return f"Struct({self.tag!r}, {dict.__repr__(self)})"


_TOKEN_RE = re.compile(
    r"""
      (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
    | (?P<string>"(?:\\.|[^"\\])*")
    | (?P<number>[+-]?(?:\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?|0x[0-9a-fA-F]+))
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<punct>[()\[\]{},:])
    """,
    re.VERBOSE | re.DOTALL,
)


def _tokenize(src):
    tokens = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise RonError(f"Unexpected character {src[pos]!r} at offset {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        tokens.append((kind, m.group()))
    tokens.append(("eof", ""))
    return tokens


class _Parser:
    def __init__(self, tokens):
        self.tokens = tokens
        self.i = 0

    def peek(self):
        return self.tokens[self.i]

    def next(self):
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect(self, text):
        kind, val = self.next()
        if val != text:
            raise RonError(f"Expected {text!r}, got {val!r}")

    def parse_value(self):
        kind, val = self.peek()
        if kind == "string":
            self.next()
            return _unescape(val)
        if kind == "number":
            self.next()
            return _number(val)
        if kind == "ident":
            self.next()
            if val == "true":
                return True
            if val == "false":
                return False
            if self.peek()[1] == "(":
                fields, args = self._parse_paren_body()
                return Struct(val, fields, args)
            return Struct(val)  # unit variant
        if val == "(":
            fields, args = self._parse_paren_body()
            if fields is not None:
                return Struct(None, fields)
            return tuple(args)
        if val == "[":
            return self._parse_seq("[", "]")
        if val == "{":
            return self._parse_map()
        raise RonError(f"Unexpected token {val!r}")

    def _parse_paren_body(self):
        """Returns (fields|None, args|None) for the ``( ... )`` after a name."""
        self.expect("(")
        fields, args = None, None
        first = True
        while True:
            if self.peek()[1] == ")":
                self.next()
                break
            # field form? ident ':'
            kind, val = self.peek()
            is_field = (
                kind == "ident"
                and self.tokens[self.i + 1][1] == ":"
                and val not in ("true", "false")
            )
            if first:
                fields, args = ({}, None) if is_field else (None, [])
                first = False
            if is_field:
                if fields is None:
                    raise RonError("Mixed positional and named fields")
                name = self.next()[1]
                self.expect(":")
                fields[name] = self.parse_value()
            else:
                if args is None:
                    raise RonError("Mixed positional and named fields")
                args.append(self.parse_value())
            if self.peek()[1] == ",":
                self.next()
        if first:  # empty parens
            args = []
        return fields, args

    def _parse_seq(self, open_, close):
        self.expect(open_)
        out = []
        while True:
            if self.peek()[1] == close:
                self.next()
                return out
            out.append(self.parse_value())
            if self.peek()[1] == ",":
                self.next()

    def _parse_map(self):
        self.expect("{")
        out = {}
        while True:
            if self.peek()[1] == "}":
                self.next()
                return out
            key = self.parse_value()
            self.expect(":")
            out[key] = self.parse_value()
            if self.peek()[1] == ",":
                self.next()


_ESCAPES = {
    "n": "\n", "t": "\t", "r": "\r", "0": "\0",
    "\\": "\\", '"': '"', "'": "'",
}


def _unescape(s):
    # Targeted escape substitution: the unicode_escape codec would re-decode
    # UTF-8 bytes as latin-1, silently mangling any non-ASCII text (a world
    # name like "Café"); here non-ASCII characters pass through verbatim.
    body = s[1:-1]
    if "\\" not in body:
        return body
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        if i + 1 >= len(body):
            raise RonError("dangling backslash in string")
        e = body[i + 1]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e == "u":
            # RON uses \u{XXXX}; also accept bare \uXXXX (exactly 4 digits).
            if i + 2 < len(body) and body[i + 2] == "{":
                end = body.find("}", i + 3)
                if end < 0:
                    raise RonError("unterminated \\u{...} escape in string")
                hexs = body[i + 3 : end]
                i = end + 1
            else:
                hexs = body[i + 2 : i + 6]
                if len(hexs) != 4:
                    raise RonError("truncated \\uXXXX escape in string")
                i += 6
            try:
                out.append(chr(int(hexs, 16)))
            except (ValueError, OverflowError) as exc:
                raise RonError(f"bad unicode escape \\u{hexs!r}") from exc
        elif e == "x":
            hexs = body[i + 2 : i + 4]
            if len(hexs) != 2:
                raise RonError("truncated \\xNN escape in string")
            try:
                out.append(chr(int(hexs, 16)))
            except ValueError as exc:
                raise RonError(f"bad hex escape \\x{hexs!r}") from exc
            i += 4
        else:
            raise RonError(f"unknown escape \\{e} in string")
    return "".join(out)


def _number(s):
    if s.startswith(("0x", "0X")):
        return int(s, 16)
    if any(c in s for c in ".eE") and not s.lstrip("+-").isdigit():
        return float(s)
    return int(s)


def loads(src):
    """Parse a RON document into Python values."""
    p = _Parser(_tokenize(src))
    value = p.parse_value()
    if p.peek()[0] != "eof":
        # Allow concatenated top-level values (reference's meta.ron files
        # are single values; be strict).
        raise RonError(f"Trailing content at token {p.peek()[1]!r}")
    return value


def load(path):
    with open(path, "r", encoding="utf-8") as f:
        return loads(f.read())
