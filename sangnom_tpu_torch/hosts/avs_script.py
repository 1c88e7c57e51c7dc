"""A minimal AviSynth-script evaluator over the `hosts/avisynth` protocol.

The reference plugin's users drive it from AviSynth SCRIPT TEXT — lines
like ``SangNom2(order=1, aa=48)`` with the host's implicit-`last`
convention and OOP-style chaining (``clip.SangNom2(...)``).  This module
evaluates that surface against a `ScriptEnvironment`, so the exact lines
from existing .avs recipes run unmodified:

    AssumeTFF()
    SeparateFields()
    DoubleWeave()
    SangNom2(order=0)

Supported subset (everything the plugin's documented recipes use —
reference README.md usage lines and the double-rate recipe at
src/SangNom2.cpp:18-23):

* expression statements, assignments (``x = expr``), ``return expr``
* function calls with positional + named args; identifiers, function
  names and named args are case-insensitive (AviSynth semantics)
* implicit ``last``: a call whose signature starts with a clip slot and
  whose arguments don't supply one receives the current ``last``; a bare
  expression statement's clip result becomes the new ``last``
* OOP chaining: ``expr.Func(args)`` == ``Func(expr, args)``
* literals: integers, floats, strings ("..."), ``true``/``false``
  (and AviSynth's ``yes``/``no``).  As in AviSynth, a string has no
  escapes: it runs to the next double quote and a backslash in it is a
  literal backslash (the JAX package's evaluator reads ``\\"`` and
  ``\\\\`` as escapes)
* ``#`` comments; blank lines; ``\\`` line continuations (both the
  end-of-line and start-of-line AviSynth forms)

Deliberately out of scope (documented, fail-fast): control flow,
arithmetic/comparison operators, multi-line function definitions — the
plugin's own usage surface needs none of them.  `eval_script` raises
`AvisynthError` with a line-numbered message on anything outside the
subset.
"""

from __future__ import annotations

import re
from typing import Any, Optional

from sangnom_tpu_torch.hosts.avisynth import AvisynthError, parse_signature

_TOKEN = re.compile(r"""
    \s*(?:
        (?P<string>"[^"]*")
      | (?P<float>\d+\.\d+)
      | (?P<int>\d+)
      | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
      | (?P<op>[().,=-])
    )""", re.VERBOSE)

_BOOL_WORDS = {"true": True, "yes": True, "false": False, "no": False}


def _tokenize(line: str, lineno: int) -> list[tuple[str, Any]]:
    out, i = [], 0
    while i < len(line):
        while i < len(line) and line[i].isspace():
            i += 1
        if i >= len(line) or line[i] == "#":
            break  # end of line / comment to end of line
        m = _TOKEN.match(line, i)
        if m is None or m.end() == i:
            raise AvisynthError(
                f"script line {lineno}: cannot parse near "
                f"{line[i:i+12]!r} (operators/control flow are outside "
                "the supported subset)")
        i = m.end()
        kind = m.lastgroup
        if kind is None:
            break
        text = m.group(kind)
        if kind == "string":
            out.append(("str", text[1:-1]))
        elif kind == "float":
            out.append(("num", float(text)))
        elif kind == "int":
            out.append(("num", int(text)))
        elif kind == "name":
            low = text.lower()
            if low in _BOOL_WORDS:
                out.append(("bool", _BOOL_WORDS[low]))
            else:
                out.append(("name", low))
        else:
            out.append(("op", text))
    return out


class _Parser:
    """Recursive descent over one logical line's tokens."""

    def __init__(self, tokens, lineno, evaluator):
        self.toks = tokens
        self.i = 0
        self.lineno = lineno
        self.ev = evaluator

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def take(self):
        t = self.peek()
        self.i += 1
        return t

    def expect_op(self, op):
        kind, val = self.take()
        if kind != "op" or val != op:
            raise AvisynthError(
                f"script line {self.lineno}: expected {op!r}, got {val!r}")

    def expression(self):
        """atom ('.' call)* — OOP chaining binds left to right."""
        value = self.atom()
        while self.peek() == ("op", "."):
            self.take()
            kind, name = self.take()
            if kind != "name":
                raise AvisynthError(
                    f"script line {self.lineno}: expected a function name "
                    "after '.'")
            value = self.call(name, receiver=value, has_receiver=True)
        return value

    def atom(self):
        kind, val = self.take()
        if (kind, val) == ("op", "-"):
            # unary minus on a numeric literal (e.g. opt=-1); general
            # arithmetic stays outside the subset
            nkind, nval = self.take()
            if nkind != "num":
                raise AvisynthError(
                    f"script line {self.lineno}: '-' is only supported "
                    "as a numeric sign (operators are outside the "
                    "supported subset)")
            return -nval
        if kind in ("num", "str", "bool"):
            return val
        if kind == "name":
            if self.peek() == ("op", "("):
                return self.call(val, receiver=None, has_receiver=False)
            return self.ev.lookup(val, self.lineno)
        raise AvisynthError(
            f"script line {self.lineno}: unexpected token {val!r}")

    def call(self, name, receiver, has_receiver):
        self.expect_op("(")
        pos, named = [], {}
        if self.peek() != ("op", ")"):
            while True:
                # named arg lookahead: name '=' (not '==' — no operators
                # in the subset anyway)
                if (self.peek()[0] == "name"
                        and self.i + 1 < len(self.toks)
                        and self.toks[self.i + 1] == ("op", "=")):
                    _, argname = self.take()
                    self.take()  # '='
                    named[argname] = self.expression()
                else:
                    if named:
                        raise AvisynthError(
                            f"script line {self.lineno}: positional "
                            "argument after named argument")
                    pos.append(self.expression())
                if self.peek() == ("op", ","):
                    self.take()
                    continue
                break
        self.expect_op(")")
        return self.ev.invoke(name, pos, named, receiver, has_receiver,
                              self.lineno)


class ScriptEvaluator:
    """Line-oriented evaluation with AviSynth's `last` convention."""

    def __init__(self, env, last=None, variables: Optional[dict] = None):
        self.env = env
        self.last = last
        self.vars = {k.lower(): v for k, v in (variables or {}).items()}

    # -- parser callbacks --------------------------------------------------
    def lookup(self, name: str, lineno: int):
        if name == "last":
            if self.last is None:
                raise AvisynthError(
                    f"script line {lineno}: 'last' is not set")
            return self.last
        if name in self.vars:
            return self.vars[name]
        raise AvisynthError(
            f"script line {lineno}: I don't know what {name!r} means")

    def invoke(self, name, pos, named, receiver, has_receiver, lineno):
        if not self.env.function_exists(name):
            raise AvisynthError(
                f"script line {lineno}: there is no function named "
                f"{name!r}")
        signature = self.env.function_signature(name)
        if has_receiver:
            pos = [receiver] + pos
        else:
            # implicit last: the signature wants a leading clip and the
            # caller didn't supply one
            slots = parse_signature(signature)
            needs_clip = bool(slots) and slots[0][1] == "c"
            got_clip = bool(pos) and hasattr(pos[0], "get_video_info")
            if needs_clip and not got_clip:
                if self.last is None:
                    raise AvisynthError(
                        f"script line {lineno}: {name} needs a clip and "
                        "'last' is not set")
                pos = [self.last] + pos
        try:
            return self.env.invoke(name, *pos, **named)
        except AvisynthError as e:
            raise AvisynthError(f"script line {lineno}: {e}") from e

    # -- statements --------------------------------------------------------
    def run(self, text: str):
        lines = _logical_lines(text)
        result = None
        for lineno, line in lines:
            toks = _tokenize(line, lineno)
            if not toks:
                continue
            # return statement
            if toks[0] == ("name", "return"):
                p = _Parser(toks[1:], lineno, self)
                value = p.expression()
                _end_check(p)
                return value
            # assignment: name '=' expr
            if (toks[0][0] == "name" and len(toks) > 1
                    and toks[1] == ("op", "=")):
                p = _Parser(toks[2:], lineno, self)
                value = p.expression()
                _end_check(p)
                self.vars[toks[0][1]] = value
                result = value
                continue
            p = _Parser(toks, lineno, self)
            value = p.expression()
            _end_check(p)
            if hasattr(value, "get_video_info"):
                self.last = value  # a bare clip expression sets last
            result = value
        # AviSynth: a script without return yields last (or the final
        # expression when nothing clip-valued ran)
        return self.last if self.last is not None else result


def _end_check(p: _Parser):
    if p.i != len(p.toks):
        raise AvisynthError(
            f"script line {p.lineno}: unexpected trailing tokens "
            f"{p.toks[p.i:]!r} (operators/control flow are outside the "
            "supported subset)")


def _logical_lines(text: str):
    """Physical -> logical lines honoring AviSynth's two continuation
    forms: a trailing ``\\`` continues onto the next line, a leading
    ``\\`` continues from the previous one."""
    out: list[list] = []  # [lineno, text, open_continuation]
    for no, raw in enumerate(text.splitlines(), 1):
        stripped = raw.strip()
        cont_prev = stripped.startswith("\\")
        if cont_prev:
            stripped = stripped[1:].lstrip()
        trail = stripped.endswith("\\")
        if trail:
            stripped = stripped[:-1].rstrip()
        if out and (cont_prev or out[-1][2]):
            out[-1][1] += " " + stripped
            out[-1][2] = trail
        elif stripped or trail:
            out.append([no, stripped, trail])
    return [(no, text) for no, text, _ in out if text.strip()]


def eval_script(env, text: str, last=None, variables: Optional[dict] = None):
    """Evaluate AviSynth script text against ``env`` (a
    `ScriptEnvironment` with the plugin registered).  ``last`` seeds the
    implicit clip; ``variables`` pre-binds script variables (e.g. a
    source clip by name).  Returns the script result — the `return`
    value, else `last`."""
    return ScriptEvaluator(env, last=last, variables=variables).run(text)
