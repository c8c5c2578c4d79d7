"""DHDL — the DGen hardware description language (paper §5.1).

The paper's DGen consumes "user input architectures/technology represented
in a custom description language".  This module is that front-end: a small,
source-located ``.dhd`` text format that lowers onto the existing
differentiable parameter pytrees —

    .dhd text --parse--> ArchDef AST --compile--> (ArchSpec, ArchParams, TechParams)

``dgen.specialize`` consumes the result unchanged, so everything downstream
(DSim, the mapper, DOpt, popsim) works identically for text-described and
dataclass-built architectures, gradients included.  Only compilation makes
tensors: ``compile_arch``, ``parse_arch`` and ``load_arch`` take ``device``
(the card unless the caller names another); parsing and serializing run on
the host.

Grammar (EBNF; ``#`` and ``//`` start line comments)::

    file       := arch_decl*
    arch_decl  := "arch" IDENT ("inherits" IDENT)? "{" stmt* "}"
    stmt       := mem_block | comp_block | tech_block | assign
    mem_block  := "memory" MEMUNIT "{" assign* "}"
    comp_block := "compute" COMPUNIT "{" assign* "}"
    tech_block := "tech" "{" (assign | mem_block | comp_block)* "}"
    assign     := IDENT ("=" NUMBER UNIT? | "=" IDENT | "*=" NUMBER)
    MEMUNIT    := "localMem" | "globalBuf" | "mainMem"
    COMPUNIT   := "systolicArray" | "vector" | "macTree" | "fpu"

Semantics:

* ``inherits`` composes architectures: the parent chain is applied first
  (root to leaf) against the dataclass defaults, each child overriding
  field-by-field.  ``*=`` multiplies the *inherited* value, so a child can
  say ``capacity *= 2`` or ``cell_read_latency *= 0.5`` without repeating
  the parent's absolute numbers — the "per-tech multipliers" idiom.
* Values carry optional units (``GHz``/``MiB``/``ns``/``nm`` ...);
  each field accepts one unit family and is stored in the simulator's
  canonical unit (Hz, bytes, seconds, nm).
* ``memory`` blocks set the per-level hierarchy (type / capacity / banks
  or bank_size / read_ports / bw);  ``compute`` blocks set unit counts and
  dims;  ``tech`` holds technology: global ``node`` / ``peripheral_node`` /
  ``vdd`` plus per-memory and per-compute overrides.  ``vdd`` is folded
  into the energy reference fields at compile time (dgen fixes VDD and
  folds voltage dependence into the energy refs — the DSL keeps that
  contract).
* ``enabled = false`` in a memory/compute block removes the unit from the
  ArchSpec (its parameters remain in the pytrees, masked out by dgen).

Errors are precise and source-located::

    mobile.dhd:7:14: unknown unit 'GHzz' for field 'frequency' (expected one of: GHz, Hz, kHz, MHz)
          frequency = 2.0 GHzz
                          ^

``serialize_arch`` is the inverse of compile: it renders any
(spec, arch, tech) triple as canonical ``.dhd`` (base units, full float32
precision, fixed field order), so parse -> serialize -> parse is the
identity and text is a faithful interchange format for optimized designs.

The architecture library under ``repro_torch/configs/arch/*.dhd`` is loaded with
``load_arch(name)`` / ``library_archs()``; user text can ``inherit`` any
library architecture by default.
"""
from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.params import (
    COMP_CLS,
    MEM_CLS,
    MEM_TYPES,
    N_COMP,
    N_MEM,
    ArchParams,
    ArchSpec,
    TechParams,
)

__all__ = [
    "DhdlError",
    "CompiledArch",
    "parse",
    "parse_arch",
    "compile_arch",
    "serialize_arch",
    "library_dir",
    "library_archs",
    "load_arch",
    "load_library",
]

_REF_VDD = 0.9  # dgen's fixed reference VDD the energy refs are folded at


# --------------------------------------------------------------------------- #
# errors
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Span:
    filename: str
    line: int  # 1-based
    col: int  # 1-based
    text: str  # the full source line

    def format(self, msg: str) -> str:
        caret = " " * (self.col - 1) + "^"
        return (
            f"{self.filename}:{self.line}:{self.col}: {msg}\n"
            f"    {self.text}\n"
            f"    {caret}"
        )


class DhdlError(ValueError):
    """A .dhd parse/compile error with source location."""

    def __init__(self, msg: str, span: Span | None = None):
        self.msg = msg
        self.span = span
        super().__init__(span.format(msg) if span else msg)


# --------------------------------------------------------------------------- #
# lexer
# --------------------------------------------------------------------------- #

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t\r]+)
  | (?P<comment>(\#|//)[^\n]*)
  | (?P<nl>\n)
  | (?P<number>[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.]*)
  | (?P<muleq>\*=)
  | (?P<punct>[{}=])
    """,
    re.VERBOSE,
)


@dataclass(frozen=True)
class Token:
    kind: str  # number | ident | muleq | punct | eof
    value: str
    span: Span


def _tokenize(src: str, filename: str) -> list[Token]:
    lines = src.split("\n")
    toks: list[Token] = []
    line, col = 1, 1
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            span = Span(filename, line, col, lines[line - 1])
            raise DhdlError(f"unexpected character {src[pos]!r}", span)
        kind = m.lastgroup
        text = m.group()
        if kind == "nl":
            line += 1
            col = 1
        else:
            if kind not in ("ws", "comment"):
                toks.append(Token(kind, text, Span(filename, line, col, lines[line - 1])))
            col += len(text)
        pos = m.end()
    eof_line = max(1, min(line, len(lines)))
    toks.append(Token("eof", "", Span(filename, line, col, lines[eof_line - 1])))
    return toks


# --------------------------------------------------------------------------- #
# AST
# --------------------------------------------------------------------------- #


@dataclass
class Assign:
    key: str
    op: str  # "=" | "*="
    value: float | str  # number, or bare identifier (type / enabled values)
    unit: str | None
    span: Span


@dataclass
class Block:
    section: str  # "memory" | "compute"
    unit: str  # localMem / ... / systolicArray / ...
    assigns: list[Assign]
    span: Span


@dataclass
class ArchDef:
    name: str
    parent: str | None
    assigns: list[Assign] = field(default_factory=list)  # top-level
    blocks: list[Block] = field(default_factory=list)  # memory/compute
    tech_assigns: list[Assign] = field(default_factory=list)  # tech globals
    tech_blocks: list[Block] = field(default_factory=list)  # tech per-unit
    span: Span | None = None
    filename: str = "<dhd>"


class _Parser:
    def __init__(self, toks: list[Token]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, value: str | None = None, what: str = "") -> Token:
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            want = value if value is not None else kind
            got = t.value if t.kind != "eof" else "end of file"
            raise DhdlError(f"expected {want!r}{' ' + what if what else ''}, got {got!r}", t.span)
        return t

    # ---------------------------------------------------------------- file
    def parse_file(self, filename: str) -> list[ArchDef]:
        defs = []
        while self.peek().kind != "eof":
            t = self.peek()
            if t.kind == "ident" and t.value == "arch":
                defs.append(self.parse_arch_decl(filename))
            else:
                raise DhdlError(f"expected 'arch' declaration, got {t.value!r}", t.span)
        return defs

    def parse_arch_decl(self, filename: str) -> ArchDef:
        kw = self.expect("ident", "arch")
        name = self.expect("ident", what="(architecture name)")
        parent = None
        if self.peek().kind == "ident" and self.peek().value == "inherits":
            self.next()
            parent = self.expect("ident", what="(parent architecture name)").value
        self.expect("punct", "{")
        d = ArchDef(name=name.value, parent=parent, span=kw.span, filename=filename)
        while not (self.peek().kind == "punct" and self.peek().value == "}"):
            t = self.peek()
            if t.kind == "eof":
                raise DhdlError(f"unclosed '{{' in arch {d.name!r}", t.span)
            if t.kind == "ident" and t.value in ("memory", "compute"):
                d.blocks.append(self.parse_block())
            elif t.kind == "ident" and t.value == "tech":
                self.parse_tech(d)
            else:
                d.assigns.append(self.parse_assign())
        self.next()  # }
        return d

    # ---------------------------------------------------------------- blocks
    def parse_block(self) -> Block:
        kw = self.next()  # memory | compute
        unit = self.expect("ident", what=f"({kw.value} unit name)")
        universe = MEM_CLS if kw.value == "memory" else COMP_CLS
        if unit.value not in universe:
            raise DhdlError(
                f"unknown {kw.value} unit {unit.value!r} (expected one of: {', '.join(universe)})",
                unit.span,
            )
        self.expect("punct", "{")
        assigns = []
        while not (self.peek().kind == "punct" and self.peek().value == "}"):
            if self.peek().kind == "eof":
                raise DhdlError(f"unclosed '{{' in {kw.value} {unit.value!r}", self.peek().span)
            assigns.append(self.parse_assign())
        self.next()
        return Block(section=kw.value, unit=unit.value, assigns=assigns, span=kw.span)

    def parse_tech(self, d: ArchDef) -> None:
        self.next()  # tech
        self.expect("punct", "{")
        while not (self.peek().kind == "punct" and self.peek().value == "}"):
            t = self.peek()
            if t.kind == "eof":
                raise DhdlError("unclosed '{' in tech block", t.span)
            if t.kind == "ident" and t.value in ("memory", "compute"):
                d.tech_blocks.append(self.parse_block())
            else:
                d.tech_assigns.append(self.parse_assign())
        self.next()

    # ---------------------------------------------------------------- assign
    def parse_assign(self) -> Assign:
        key = self.next()
        if key.kind != "ident":
            raise DhdlError(f"expected a field name, got {key.value!r}", key.span)
        op = self.next()
        if not (op.kind == "muleq" or (op.kind == "punct" and op.value == "=")):
            raise DhdlError(f"expected '=' or '*=' after {key.value!r}, got {op.value!r}", op.span)
        val = self.next()
        if op.kind == "muleq":
            if val.kind != "number":
                raise DhdlError(f"'*=' takes a bare multiplier, got {val.value!r}", val.span)
            return Assign(key.value, "*=", float(val.value), None, key.span)
        if val.kind == "ident":
            return Assign(key.value, "=", val.value, None, key.span)
        if val.kind != "number":
            raise DhdlError(f"expected a value after '=', got {val.value!r}", val.span)
        unit = None
        if self.peek().kind == "ident" and self.peek().value not in _KEYWORDS:
            # a unit suffix — any identifier immediately following a number
            # that is not the start of the next statement
            nxt = self.toks[self.i + 1] if self.i + 1 < len(self.toks) else None
            follows_assign = nxt is not None and (
                nxt.kind == "muleq" or (nxt.kind == "punct" and nxt.value == "=")
            )
            if not follows_assign:
                unit = self.next().value
        return Assign(key.value, "=", float(val.value), unit, key.span)


_KEYWORDS = {"arch", "inherits", "memory", "compute", "tech"}


def parse(src: str, filename: str = "<dhd>") -> list[ArchDef]:
    """Parse ``.dhd`` source into a list of ArchDef ASTs."""
    return _Parser(_tokenize(src, filename)).parse_file(filename)


# --------------------------------------------------------------------------- #
# unit tables + field schemas
# --------------------------------------------------------------------------- #

_FREQ = {"hz": 1.0, "khz": 1e3, "mhz": 1e6, "ghz": 1e9}
_BYTES = {
    "b": 1.0, "kib": 2.0**10, "mib": 2.0**20, "gib": 2.0**30, "tib": 2.0**40,
    "kb": 1e3, "mb": 1e6, "gb": 1e9, "tb": 1e12,
}
_TIME = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9, "ps": 1e-12}
_NM = {"nm": 1.0}
_NONE: dict[str, float] = {}

# (pytree, field, unit-family) — index comes from the enclosing block's unit
_TOP_FIELDS = {"frequency": ("arch", "frequency", _FREQ)}

_MEM_FIELDS = {
    "capacity": ("arch", "capacity", _BYTES),
    "bank_size": ("arch", "bank_size", _BYTES),
    "read_ports": ("arch", "n_read_ports", _NONE),
    "bw": ("arch", "bw_scale", _NONE),
    "bw_scale": ("arch", "bw_scale", _NONE),
}
_MEM_SPECIAL = ("type", "banks", "enabled")

_COMP_FIELDS = {
    "systolicArray": {"x": "sys_arr_x", "y": "sys_arr_y", "count": "sys_arr_n"},
    "vector": {"width": "vect_width", "count": "vect_n"},
    "macTree": {"x": "mtree_x", "y": "mtree_y", "tile_x": "mtree_tile_x", "tile_y": "mtree_tile_y"},
    "fpu": {"count": "fpu_n"},
}

_TECH_GLOBAL = ("node", "peripheral_node", "vdd")

_TECH_MEM_FIELDS = {
    "wire_cap": ("tech", "mem_wire_cap", _NONE),
    "wire_resist": ("tech", "mem_wire_resist", _NONE),
    "cell_read_latency": ("tech", "cell_read_latency", _TIME),
    "cell_access_device": ("tech", "cell_access_device", _NONE),
    "cell_read_power": ("tech", "cell_read_power", _NONE),  # pJ/bit
    "cell_leakage_power": ("tech", "cell_leakage_power", _NONE),  # nW/bit
    "cell_area": ("tech", "cell_area", _NONE),  # um^2/bit
    "peripheral_node": ("tech", "peripheral_node", _NM),
}

_TECH_COMP_FIELDS = {
    "node": ("tech", "node", _NM),
    "wire_cap": ("tech", "comp_wire_cap", _NONE),
    "wire_resist": ("tech", "comp_wire_resist", _NONE),
}


def _unit_factor(a: Assign, family: dict[str, float]) -> float:
    if a.unit is None:
        return 1.0
    f = family.get(a.unit.lower())
    if f is None:
        expected = ", ".join(sorted(family, key=str.lower)) if family else "no unit"
        raise DhdlError(
            f"unknown unit {a.unit!r} for field {a.key!r} (expected: {expected})", a.span
        )
    return f


def _numeric(a: Assign) -> float:
    if isinstance(a.value, str):
        raise DhdlError(f"field {a.key!r} expects a number, got {a.value!r}", a.span)
    return float(a.value)


def _no_muleq(a: Assign) -> None:
    if a.op == "*=":
        raise DhdlError(f"field {a.key!r} does not support '*=' (use '=')", a.span)


def _as_bool(a: Assign) -> bool:
    _no_muleq(a)
    if isinstance(a.value, str):
        if a.value in ("true", "yes", "on"):
            return True
        if a.value in ("false", "no", "off"):
            return False
        raise DhdlError(f"field 'enabled' expects true/false or 0/1, got {a.value!r}", a.span)
    return bool(a.value)


# --------------------------------------------------------------------------- #
# compiler
# --------------------------------------------------------------------------- #


@dataclass
class CompiledArch:
    """A compiled .dhd architecture: the exact triple dgen.specialize eats."""

    name: str
    spec: ArchSpec
    arch: ArchParams
    tech: TechParams

    def specialize(self):
        from repro_torch.core.dgen import specialize

        return specialize(self.tech, self.arch, self.spec)

    def simulate(self, g, mcfg=None):
        from repro_torch.core.dsim import simulate
        from repro_torch.core.mapper import MapperCfg

        return simulate(self.tech, self.arch, g, self.spec, mcfg or MapperCfg())


class _State:
    """Mutable lowering state: numpy copies of the default pytrees."""

    def __init__(self) -> None:
        arch, tech = ArchParams.default("cpu"), TechParams.default("cpu")
        self.arch = {f.name: _host(getattr(arch, f.name)).copy() for f in dataclasses.fields(ArchParams)}
        self.tech = {f.name: _host(getattr(tech, f.name)).copy() for f in dataclasses.fields(TechParams)}
        self.mem_type = list(ArchSpec().mem_type)
        self.mem_enabled = [True] * N_MEM
        self.comp_enabled = [True] * N_COMP
        self.vdd = _REF_VDD

    # ------------------------------------------------------------- setters
    def set_field(self, tree: str, fname: str, idx: int | None, a: Assign, family: dict):
        store = self.arch if tree == "arch" else self.tech
        cur = store[fname]
        if a.op == "*=":
            mult = _numeric(a)
            if mult <= 0:
                raise DhdlError(f"multiplier for {a.key!r} must be > 0, got {mult}", a.span)
            if idx is None and cur.ndim == 0:
                store[fname] = np.float32(cur * mult)
            elif idx is None:
                cur *= np.float32(mult)
            else:
                cur[idx] = np.float32(cur[idx] * mult)
            return
        v = _numeric(a) * _unit_factor(a, family)
        if v <= 0 and a.key != "enabled":
            raise DhdlError(f"field {a.key!r} must be > 0, got {v}", a.span)
        if idx is None and cur.ndim == 0:
            store[fname] = np.float32(v)
        elif idx is None:
            cur[...] = np.float32(v)
        else:
            cur[idx] = np.float32(v)


def _apply_mem_block(st: _State, b: Block, tech_section: bool) -> None:
    i = MEM_CLS.index(b.unit)
    fields = _TECH_MEM_FIELDS if tech_section else _MEM_FIELDS
    seen = {a.key for a in b.assigns}
    if not tech_section and "banks" in seen and "bank_size" in seen:
        span = next(a.span for a in b.assigns if a.key == "banks")
        raise DhdlError(f"memory {b.unit!r} sets both 'banks' and 'bank_size'; pick one", span)
    deferred: list[Assign] = []
    for a in b.assigns:
        if not tech_section and a.key == "type":
            _no_muleq(a)
            if not isinstance(a.value, str) or a.value not in MEM_TYPES:
                raise DhdlError(
                    f"memory type must be one of: {', '.join(MEM_TYPES)}; got {a.value!r}", a.span
                )
            st.mem_type[i] = a.value
        elif not tech_section and a.key == "enabled":
            st.mem_enabled[i] = _as_bool(a)
        elif not tech_section and a.key == "banks":
            deferred.append(a)  # needs the block's capacity applied first
        elif a.key in fields:
            tree, fname, family = fields[a.key]
            st.set_field(tree, fname, i, a, family)
        else:
            where = "tech memory" if tech_section else "memory"
            known = sorted(fields) + ([] if tech_section else [k for k in _MEM_SPECIAL])
            raise DhdlError(
                f"unknown {where} field {a.key!r} (expected one of: {', '.join(known)})", a.span
            )
    for a in deferred:
        n = _numeric(a)
        if a.op == "*=" or n < 1:
            raise DhdlError(f"'banks' expects '=' and a count >= 1, got {a.op} {n}", a.span)
        st.arch["bank_size"][i] = np.float32(st.arch["capacity"][i] / np.float32(n))


def _apply_comp_block(st: _State, b: Block, tech_section: bool) -> None:
    i = COMP_CLS.index(b.unit)
    for a in b.assigns:
        if not tech_section and a.key == "enabled":
            st.comp_enabled[i] = _as_bool(a)
        elif tech_section and a.key in _TECH_COMP_FIELDS:
            tree, fname, family = _TECH_COMP_FIELDS[a.key]
            st.set_field(tree, fname, i, a, family)
        elif not tech_section and a.key in _COMP_FIELDS[b.unit]:
            st.set_field("arch", _COMP_FIELDS[b.unit][a.key], None, a, _NONE)
        else:
            known = sorted(_TECH_COMP_FIELDS) if tech_section else sorted(
                list(_COMP_FIELDS[b.unit]) + ["enabled"]
            )
            where = "tech compute" if tech_section else f"compute {b.unit!r}"
            raise DhdlError(
                f"unknown {where} field {a.key!r} (expected one of: {', '.join(known)})", a.span
            )


def _apply_def(st: _State, d: ArchDef) -> None:
    for a in d.assigns:
        if a.key in _TOP_FIELDS:
            tree, fname, family = _TOP_FIELDS[a.key]
            st.set_field(tree, fname, None, a, family)
        else:
            raise DhdlError(
                f"unknown architecture field {a.key!r} "
                f"(expected one of: {', '.join(sorted(_TOP_FIELDS))}, "
                "or a memory/compute/tech block)",
                a.span,
            )
    for b in d.blocks:
        (_apply_mem_block if b.section == "memory" else _apply_comp_block)(st, b, False)
    for a in d.tech_assigns:
        if a.key == "node":
            st.set_field("tech", "node", None, a, _NM)
        elif a.key == "peripheral_node":
            st.set_field("tech", "peripheral_node", None, a, _NM)
        elif a.key == "vdd":
            v = st.vdd * _numeric(a) if a.op == "*=" else _numeric(a)
            if not (0.1 <= v <= 2.0):
                raise DhdlError(f"vdd must be in [0.1, 2.0] volts, got {v}", a.span)
            st.vdd = v
        else:
            raise DhdlError(
                f"unknown tech field {a.key!r} (expected one of: {', '.join(_TECH_GLOBAL)}, "
                "or a memory/compute block)",
                a.span,
            )
    for b in d.tech_blocks:
        (_apply_mem_block if b.section == "memory" else _apply_comp_block)(st, b, True)


def _resolve_chain(d: ArchDef, env: dict[str, ArchDef]) -> list[ArchDef]:
    chain = [d]
    seen = {d.name}
    cur = d
    while cur.parent is not None:
        parent = env.get(cur.parent)
        if parent is None:
            raise DhdlError(
                f"arch {cur.name!r} inherits unknown architecture {cur.parent!r} "
                f"(known: {', '.join(sorted(env)) or 'none'})",
                cur.span,
            )
        if parent.name in seen:
            raise DhdlError(
                f"inheritance cycle: {' -> '.join(c.name for c in reversed(chain))} -> {parent.name}",
                cur.span,
            )
        seen.add(parent.name)
        chain.append(parent)
        cur = parent
    return list(reversed(chain))  # root first


def compile_arch(d: ArchDef | str, env: dict[str, ArchDef] | None = None, device=None) -> CompiledArch:
    """Lower an ArchDef (or a name looked up in ``env``) to the parameter
    trees, as float32 tensors on ``device``."""
    env = env or {}
    if isinstance(d, str):
        if d not in env:
            raise DhdlError(f"unknown architecture {d!r} (known: {', '.join(sorted(env)) or 'none'})")
        d = env[d]
    st = _State()
    for link in _resolve_chain(d, env):
        _apply_def(st, link)
    # fold VDD into the energy reference fields (dgen fixes VDD = 0.9 and
    # keeps voltage dependence inside the energy refs): dynamic energy ~ V^2,
    # leakage ~ V
    if st.vdd != _REF_VDD:
        r = np.float32(st.vdd / _REF_VDD)
        st.tech["cell_read_power"] = np.asarray(st.tech["cell_read_power"] * r * r, np.float32)
        st.tech["cell_leakage_power"] = np.asarray(st.tech["cell_leakage_power"] * r, np.float32)
    spec = ArchSpec(
        mem_units=tuple(m for m, e in zip(MEM_CLS, st.mem_enabled) if e),
        comp_units=tuple(c for c, e in zip(COMP_CLS, st.comp_enabled) if e),
        mem_type=tuple(st.mem_type),
    )
    if not spec.comp_units:
        raise DhdlError(f"arch {d.name!r} disables every compute unit", d.span)
    arch = ArchParams.from_numpy(st.arch, device)
    tech = TechParams.from_numpy(st.tech, device)
    return CompiledArch(name=d.name, spec=spec, arch=arch, tech=tech)


def build_env(defs) -> dict[str, ArchDef]:
    """Index ArchDefs by name, rejecting duplicates."""
    env: dict[str, ArchDef] = {}
    for d in defs:
        if d.name in env:
            raise DhdlError(
                f"duplicate architecture {d.name!r} (first defined in {env[d.name].filename})",
                d.span,
            )
        env[d.name] = d
    return env


def parse_arch(
    src: str,
    name: str | None = None,
    filename: str = "<dhd>",
    env: dict[str, ArchDef] | None = None,
    device=None,
) -> CompiledArch:
    """Parse + compile one architecture from source text.

    ``name`` selects among multiple declarations (default: the last one).
    ``env`` supplies inheritable architectures; by default the library is
    visible, so ``arch mine inherits datacenter { ... }`` just works.
    """
    defs = parse(src, filename)
    if not defs:
        raise DhdlError(f"no 'arch' declaration found in {filename}")
    base_env = dict(load_library()) if env is None else dict(env)
    base_env.update(build_env(defs))  # local declarations shadow the library;
    # duplicates *within* the source are an error (build_env raises)
    target = defs[-1].name if name is None else name
    if target not in base_env:
        raise DhdlError(f"architecture {target!r} not found in {filename}")
    return compile_arch(base_env[target], base_env, device)


# --------------------------------------------------------------------------- #
# serializer: (spec, arch, tech) -> canonical .dhd
# --------------------------------------------------------------------------- #


def _host(x) -> np.ndarray:
    """A parameter leaf as a float32 numpy array (tensors are copied to the host)."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _fmt(x) -> str:
    # full float32 precision: repr of the double that the float32 equals —
    # reparsing to float32 is bit-exact
    return repr(float(np.float32(x)))


def serialize_arch(
    ca: CompiledArch | None = None,
    *,
    name: str | None = None,
    spec: ArchSpec | None = None,
    arch: ArchParams | None = None,
    tech: TechParams | None = None,
) -> str:
    """Render an architecture as canonical ``.dhd`` text.

    Canonical form: every field explicit, base units (Hz / bytes / seconds /
    nm), fixed order, full float32 precision — so compile(parse(text)) is
    pytree-identical to the input and re-serialization is byte-identical.
    """
    if ca is not None:
        name, spec, arch, tech = ca.name, ca.spec, ca.arch, ca.tech
    assert spec is not None and arch is not None and tech is not None
    name = name or "anonymous"
    a = {f.name: _host(getattr(arch, f.name)) for f in dataclasses.fields(ArchParams)}
    t = {f.name: _host(getattr(tech, f.name)) for f in dataclasses.fields(TechParams)}

    out = [f"arch {name} {{", f"  frequency = {_fmt(a['frequency'])}"]
    for i, m in enumerate(MEM_CLS):
        out.append(f"  memory {m} {{")
        out.append(f"    enabled = {'true' if m in spec.mem_units else 'false'}")
        out.append(f"    type = {spec.mem_type[i]}")
        out.append(f"    capacity = {_fmt(a['capacity'][i])}")
        out.append(f"    bank_size = {_fmt(a['bank_size'][i])}")
        out.append(f"    read_ports = {_fmt(a['n_read_ports'][i])}")
        out.append(f"    bw_scale = {_fmt(a['bw_scale'][i])}")
        out.append("  }")
    comp_keys = _COMP_FIELDS
    for c in COMP_CLS:
        out.append(f"  compute {c} {{")
        out.append(f"    enabled = {'true' if c in spec.comp_units else 'false'}")
        for key, fname in comp_keys[c].items():
            out.append(f"    {key} = {_fmt(a[fname])}")
        out.append("  }")
    out.append("  tech {")
    for i, m in enumerate(MEM_CLS):
        out.append(f"    memory {m} {{")
        for key, (_, fname, _fam) in _TECH_MEM_FIELDS.items():
            out.append(f"      {key} = {_fmt(t[fname][i])}")
        out.append("    }")
    for i, c in enumerate(COMP_CLS):
        out.append(f"    compute {c} {{")
        for key, (_, fname, _fam) in _TECH_COMP_FIELDS.items():
            out.append(f"      {key} = {_fmt(t[fname][i])}")
        out.append("    }")
    out.append("  }")
    out.append("}")
    return "\n".join(out) + "\n"


# --------------------------------------------------------------------------- #
# architecture library (repro_torch/configs/arch/*.dhd)
# --------------------------------------------------------------------------- #

_LIB_CACHE: dict[str, ArchDef] | None = None


def library_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "arch")


def load_library(refresh: bool = False) -> dict[str, ArchDef]:
    """Parse every ``.dhd`` under the library dir into one environment."""
    global _LIB_CACHE
    if _LIB_CACHE is not None and not refresh:
        return _LIB_CACHE
    env: dict[str, ArchDef] = {}
    d = library_dir()
    if os.path.isdir(d):
        defs = []
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".dhd"):
                with open(os.path.join(d, fn)) as f:
                    defs.extend(parse(f.read(), filename=fn))
        env = build_env(defs)
    _LIB_CACHE = env
    return env


def library_archs() -> list[str]:
    return sorted(load_library())


def load_arch(name: str, device=None) -> CompiledArch:
    """Compile a named library architecture (e.g. ``load_arch("edge")``) on
    ``device``."""
    env = load_library()
    if name not in env:
        raise DhdlError(f"unknown library architecture {name!r} (known: {', '.join(sorted(env))})")
    return compile_arch(env[name], env, device)
