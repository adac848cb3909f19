"""Protobuf text-format parser (schema-free), the port's own copy.

The PyTorch port reads the same Caffe ``NetParameter`` prototxt files
as the JAX package, through its own copy of the parser so that it
imports nothing of ``sparknet_tpu``. Semantics are identical:

    message  := (field)*
    field    := ident ':' value | ident '{' message '}' | ident ':' '[' value (',' value)* ']'
    value    := scalar | '{' message '}'
    scalar   := number | 'true' | 'false' | ident (enum) | quoted-string+

Repeated fields accumulate in order; singular-field reads are last-wins
(protobuf semantics). Adjacent string literals concatenate. Bracket
lists expand to repeated values. Comments (``#`` to end of line) are
stripped. The result is a :class:`Message`: an ordered multimap with
convenience accessors, from which ``caffe_pb`` builds typed views.
"""

from __future__ import annotations

import re
from typing import Any, Iterator, List, Tuple

__all__ = ["Message", "parse", "parse_file", "ParseError"]


class ParseError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|\#[^\n]*)                       # whitespace / comment
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<punct>[{}\[\]:,;])
  | (?P<atom>[^\s{}\[\]:,;"'\#]+)
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> Iterator[Tuple[str, str]]:
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ParseError(f"bad character at offset {pos}: {text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        yield kind, m.group()


class Message:
    """Ordered multimap of field name -> values (scalars or Messages)."""

    __slots__ = ("fields",)

    def __init__(self) -> None:
        self.fields: List[Tuple[str, Any]] = []

    # -- construction -----------------------------------------------------
    def add(self, name: str, value: Any) -> None:
        self.fields.append((name, value))

    # -- access -----------------------------------------------------------
    def get_all(self, name: str) -> List[Any]:
        return [v for k, v in self.fields if k == name]

    def get(self, name: str, default: Any = None) -> Any:
        """Singular-field access: protobuf text-format is last-wins."""
        out = default
        for k, v in self.fields:
            if k == name:
                out = v
        return out

    def has(self, name: str) -> bool:
        return any(k == name for k, _ in self.fields)

    def __contains__(self, name: str) -> bool:
        return self.has(name)

    def __repr__(self) -> str:
        return f"Message({self.fields!r})"

    def to_dict(self) -> dict:
        """Lossy dict view (repeated fields become lists)."""
        grouped: dict = {}
        for k, v in self.fields:
            grouped.setdefault(k, []).append(
                v.to_dict() if isinstance(v, Message) else v
            )
        return {k: (vs[0] if len(vs) == 1 else vs) for k, vs in grouped.items()}


_ESCAPES = {
    "n": "\n", "t": "\t", "r": "\r", "a": "\a", "b": "\b",
    "f": "\f", "v": "\v", "\\": "\\", "'": "'", '"': '"', "?": "?",
}


def _unescape(body: str) -> str:
    """Protobuf string escapes, unicode-safe (no latin-1 round-trip)."""
    out: List[str] = []
    i, n = 0, len(body)
    while i < n:
        c = body[i]
        if c != "\\" or i + 1 >= n:
            out.append(c)
            i += 1
            continue
        e = body[i + 1]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e == "x" and i + 2 < n:
            j = i + 2
            while j < n and j < i + 4 and body[j] in "0123456789abcdefABCDEF":
                j += 1
            out.append(chr(int(body[i + 2 : j], 16)))
            i = j
        elif e == "u" and i + 5 < n:
            out.append(chr(int(body[i + 2 : i + 6], 16)))
            i += 6
        elif e.isdigit():
            j = i + 1
            while j < n and j < i + 4 and body[j] in "01234567":
                j += 1
            out.append(chr(int(body[i + 1 : j], 8)))
            i = j
        else:
            out.append(e)
            i += 2
    return "".join(out)


def _coerce_scalar(tok_kind: str, tok: str) -> Any:
    if tok_kind == "string":
        return _unescape(tok[1:-1])
    if tok == "true":
        return True
    if tok == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok  # enum identifier, e.g. MAX, LMDB, TRAIN


def parse(text: str) -> Message:
    tokens = list(_tokenize(text))
    msg, pos = _parse_message(tokens, 0, top=True)
    if pos != len(tokens):
        raise ParseError(f"trailing tokens at {pos}: {tokens[pos:pos+5]}")
    return msg


def _parse_message(tokens: List[Tuple[str, str]], pos: int, top: bool = False) -> Tuple[Message, int]:
    msg = Message()
    n = len(tokens)
    while pos < n:
        kind, tok = tokens[pos]
        if tok == "}":
            if top:
                raise ParseError("unexpected '}' at top level")
            return msg, pos
        if kind != "atom":
            raise ParseError(f"expected field name, got {tok!r}")
        name = tok
        pos += 1
        if pos >= n:
            raise ParseError(f"unexpected EOF after field name {name!r}")
        kind, tok = tokens[pos]
        if tok == ":":
            pos += 1
            if pos >= n:
                raise ParseError(f"unexpected EOF after '{name}:'")
            kind, tok = tokens[pos]
            if tok == "{":
                sub, pos = _parse_braced(tokens, pos)
                msg.add(name, sub)
            elif tok == "[":
                pos = _parse_list(tokens, pos, msg, name)
            else:
                val, pos = _parse_scalar(tokens, pos, name)
                msg.add(name, val)
        elif tok == "{":
            sub, pos = _parse_braced(tokens, pos)
            msg.add(name, sub)
        else:
            raise ParseError(f"expected ':' or '{{' after {name!r}, got {tok!r}")
        # optional separators
        while pos < n and tokens[pos][1] in (",", ";"):
            pos += 1
    if not top:
        raise ParseError("unexpected EOF inside message")
    return msg, pos


def _parse_scalar(tokens: List[Tuple[str, str]], pos: int, name: str) -> Tuple[Any, int]:
    kind, tok = tokens[pos]
    if kind not in ("string", "atom"):
        raise ParseError(f"expected scalar after '{name}:', got {tok!r}")
    val = _coerce_scalar(kind, tok)
    pos += 1
    # adjacent string literals concatenate, like C
    while kind == "string" and pos < len(tokens) and tokens[pos][0] == "string":
        val += _coerce_scalar("string", tokens[pos][1])
        pos += 1
    return val, pos


def _parse_list(tokens: List[Tuple[str, str]], pos: int, msg: Message, name: str) -> int:
    """``field: [v1, v2, ...]`` — each element adds as a repeated value."""
    assert tokens[pos][1] == "["
    pos += 1
    n = len(tokens)
    while pos < n and tokens[pos][1] != "]":
        if tokens[pos][1] == "{":
            sub, pos = _parse_braced(tokens, pos)
            msg.add(name, sub)
        else:
            val, pos = _parse_scalar(tokens, pos, name)
            msg.add(name, val)
        if pos < n and tokens[pos][1] == ",":
            pos += 1
    if pos >= n:
        raise ParseError(f"missing closing ']' for {name!r}")
    return pos + 1


def _parse_braced(tokens: List[Tuple[str, str]], pos: int) -> Tuple[Message, int]:
    assert tokens[pos][1] == "{"
    sub, pos = _parse_message(tokens, pos + 1)
    if pos >= len(tokens) or tokens[pos][1] != "}":
        raise ParseError("missing closing '}'")
    return sub, pos + 1


def parse_file(path: str) -> Message:
    with open(path, "r") as f:
        return parse(f.read())
