"""Wire-domain pass: the comm/wire.py protocol-constant invariants.

The frame vocabulary is a hand-maintained namespace: every ``*_MAGIC``
discriminates a frame type on a shared TCP stream, every ``*_DOMAIN``
(and the per-direction domains inside ``_STREAM_DOMAINS``) separates an
HMAC universe. Two constants silently sharing bytes is the
reflection-hole class — a client's own authenticated upload chunks
verified as "aggregate" bytes because up and down shared a domain. The
three rules here make that class a lint error:

``wire-domain-unique``
    All magic/domain byte values globally unique; magics exactly 4
    bytes (the framing layer sniffs a fixed-width discriminator);
    domain strings versioned (``...-v<N>`` suffix) so a semantic change
    can be expressed as a new disjoint domain instead of a silent
    reinterpretation of the old one.

``wire-magic-coverage``
    Every magic is consumed on both sides: referenced from at least two
    function scopes (its encode and its decode), and reachable from
    outside comm/wire.py — either the name itself is referenced by a
    dispatch module, or a wire.py function whose body uses it is.
    A magic nobody dispatches is a dead frame type; a frame type whose
    4-byte literal lives outside wire.py is an untracked one (also
    flagged: uppercase 4-byte bytes literals outside wire.py).

``wire-stream-direction``
    Every call to the stream frame codecs (``encode_stream_header``,
    ``decode_stream_chunk``, ...) outside wire.py must pass an explicit
    ``direction=`` keyword. The parameter defaults to ``"up"`` for the
    upload tier's history; a reply-side call site that forgets it gets
    upload-domain tags — exactly the reflection hole — and this rule
    makes the omission visible statically.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from .core import (
    Finding,
    Project,
    bytes_const,
    call_name,
    kwarg,
    register,
    str_const,
)

WIRE_REL = "comm/wire.py"
#: The wire layer: the modules allowed to DEFINE frame magics / HMAC
#: domains. comm/framing.py owns the transport envelope (FRAME_MAGIC,
#: ACK), comm/secure.py the secure-agg sub-protocol frames; everything
#: else must import, so uniqueness stays checkable in one pass.
WIRE_LAYER_RELS = ("comm/wire.py", "comm/framing.py", "comm/secure.py")
_DOMAIN_VERSION_RE = re.compile(rb"-v\d+$")
_MAGIC_LITERAL_RE = re.compile(rb"^[A-Z]{4}$")

#: Stream codecs whose ``direction`` kwarg selects the HMAC domain set.
DIRECTIONAL_FNS = frozenset(
    {
        "encode_stream_header",
        "decode_stream_header",
        "encode_stream_chunk",
        "decode_stream_chunk",
        "encode_stream_end",
        "decode_stream_end",
    }
)


def _wire_constants(
    project: Project,
) -> tuple[dict[str, tuple], dict[str, tuple]]:
    """(magics, domains): name -> (value, line, module). Collected
    across the wire-layer modules. Magics are ``*_MAGIC`` assignments
    plus any magic-shaped (4-byte uppercase) module-level bytes
    constant (framing's ``ACK``); domains are ``*_DOMAIN`` assignments
    plus the bytes literals inside wire.py's ``_STREAM_DOMAINS``
    direction table (keyed ``_STREAM_DOMAINS[dir][i]`` so a duplicate
    is nameable in a finding)."""
    magics: dict[str, tuple] = {}
    domains: dict[str, tuple] = {}
    for rel in WIRE_LAYER_RELS:
        mod = project.module(rel)
        if mod is None or mod.tree is None:
            continue
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target = node.targets[0]
            if not isinstance(target, ast.Name):
                continue
            name = target.id
            value = bytes_const(node.value)
            if value is not None and (
                name.endswith("_MAGIC") or _MAGIC_LITERAL_RE.match(value)
            ):
                magics[name] = (value, node.lineno, mod)
            elif value is not None and name.endswith("_DOMAIN"):
                domains[name] = (value, node.lineno, mod)
            elif name == "_STREAM_DOMAINS" and isinstance(node.value, ast.Dict):
                for key_node, val_node in zip(
                    node.value.keys, node.value.values
                ):
                    direction = (
                        key_node.value
                        if isinstance(key_node, ast.Constant)
                        else "?"
                    )
                    elts = (
                        val_node.elts
                        if isinstance(val_node, (ast.Tuple, ast.List))
                        else []
                    )
                    for i, elt in enumerate(elts):
                        v = bytes_const(elt)
                        # Name-valued entries alias *_DOMAIN constants
                        # picked up above; only literals add values here.
                        if v is not None:
                            domains[
                                f"_STREAM_DOMAINS[{direction!r}][{i}]"
                            ] = (v, elt.lineno, mod)
    return magics, domains


@register(
    "wire-domain-unique",
    "comm/wire.py magic/domain byte values globally unique, magics 4 "
    "bytes, HMAC domains versioned",
)
def check_domain_unique(project: Project) -> Iterator[Finding]:
    wire = project.module(WIRE_REL)
    if wire is None:
        return
    magics, domains = _wire_constants(project)
    if not magics or not domains:
        yield Finding(
            "wire-domain-unique",
            wire.rel,
            1,
            "no *_MAGIC/*_DOMAIN constants found in the wire layer — the "
            "wire-domain pass has lost its anchor (renamed constants?)",
        )
        return
    by_value: dict[bytes, str] = {}
    for name, (value, line, mod) in {**magics, **domains}.items():
        prior = by_value.get(value)
        if prior is not None:
            yield Finding(
                "wire-domain-unique",
                mod.rel,
                line,
                f"{name} duplicates the byte value of {prior} "
                f"({value!r}) — frame/HMAC universes must be disjoint",
            )
        else:
            by_value[value] = name
    for name, (value, line, mod) in magics.items():
        if len(value) != 4:
            yield Finding(
                "wire-domain-unique",
                mod.rel,
                line,
                f"{name} is {len(value)} bytes ({value!r}); frame magics "
                "are a fixed 4-byte discriminator",
            )
    for name, (value, line, mod) in domains.items():
        if not _DOMAIN_VERSION_RE.search(value):
            yield Finding(
                "wire-domain-unique",
                mod.rel,
                line,
                f"{name} ({value!r}) lacks a '-v<N>' version suffix — "
                "domain semantics changes must mint a NEW disjoint "
                "domain, not reinterpret the old bytes",
            )


def _function_scopes(module) -> list[tuple[str, ast.AST]]:
    """Top-level + nested function defs of a module (name, node)."""
    out = []
    for node in module.walk():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append((node.name, node))
    return out


def _names_in(node: ast.AST) -> set[str]:
    return {
        n.id for n in ast.walk(node) if isinstance(n, ast.Name)
    } | {
        n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)
    }


@register(
    "wire-magic-coverage",
    "every frame magic has encode+decode scopes and an out-of-module "
    "consumer; no ad-hoc 4-byte magic literals outside comm/wire.py",
)
def check_magic_coverage(project: Project) -> Iterator[Finding]:
    magics, _ = _wire_constants(project)
    if not magics:
        return
    # Per-module: every identifier referenced, and per-function-scope
    # identifier sets — one AST walk each, shared by all magics.
    all_idents: dict[str, set[str]] = {}
    fn_scope_names: dict[str, dict[str, set[str]]] = {}
    for m in project.modules:
        all_idents[m.rel] = _names_in(m.tree) if m.tree is not None else set()
        fn_scope_names[m.rel] = {
            name: _names_in(node) for name, node in _function_scopes(m)
        }

    for name, (_value, line, mod) in magics.items():
        # Encode+decode coverage: the magic must be consumed from at
        # least two distinct function scopes anywhere in the package
        # (its build side and its parse/dispatch side).
        scopes = {
            (rel, fn)
            for rel, fns in fn_scope_names.items()
            for fn, names in fns.items()
            if name in names
        }
        if len(scopes) < 2:
            yield Finding(
                "wire-magic-coverage",
                mod.rel,
                line,
                f"{name} is referenced from {len(scopes)} function "
                "scope(s) package-wide — a frame type needs both an "
                "encode and a decode/dispatch side",
            )
            continue
        # Dispatch coverage: the constant (or a defining-module function
        # that uses it) must be consumed outside its defining module.
        refs_outside = any(
            name in idents
            for rel, idents in all_idents.items()
            if rel != mod.rel
        )
        using_fns = {fn for rel, fn in scopes if rel == mod.rel}
        fn_used_outside = any(
            fn in idents
            for rel, idents in all_idents.items()
            if rel != mod.rel
            for fn in using_fns
        )
        if not refs_outside and not fn_used_outside:
            yield Finding(
                "wire-magic-coverage",
                mod.rel,
                line,
                f"{name} is never dispatched: neither the constant nor "
                f"any {mod.rel} function using it is referenced from "
                "another module (dead frame type?)",
            )

    wire_layer = {m.rel for m in project.select(WIRE_LAYER_RELS)}
    for m in project.modules:
        if m.rel in wire_layer:
            continue
        for node in m.walk():
            v = bytes_const(node)
            if v is not None and _MAGIC_LITERAL_RE.match(v):
                yield Finding(
                    "wire-magic-coverage",
                    m.rel,
                    node.lineno,
                    f"4-byte magic-shaped bytes literal {v!r} outside the "
                    "wire layer (comm/wire.py, comm/framing.py, "
                    "comm/secure.py) — frame magics live there so "
                    "uniqueness stays checkable",
                )


@register(
    "wire-stream-direction",
    "stream frame codec calls outside comm/wire.py must pass an "
    "explicit direction= (disjoint up/down HMAC domains)",
)
def check_stream_direction(project: Project) -> Iterator[Finding]:
    for m in project.modules:
        if m.rel.endswith(WIRE_REL):
            continue
        for node in m.walk():
            if not isinstance(node, ast.Call):
                continue
            target = call_name(node)
            fn = target.rsplit(".", 1)[-1]
            if fn not in DIRECTIONAL_FNS:
                continue
            if kwarg(node, "direction") is None:
                yield Finding(
                    "wire-stream-direction",
                    m.rel,
                    node.lineno,
                    f"{fn}() called without an explicit direction= — the "
                    "default ('up') selects upload-tier HMAC domains; a "
                    "reply-side caller inheriting it reopens the "
                    "reflection hole",
                )


#: Modules allowed to DECLARE wire meta keys — the plain-JSON capability
#: adverts and markers riding upload/reply meta (stream chunk advert,
#: streamed-reply advert, re-home marker, subtree contributor record).
#: obs/trace.py owns the trace-identity key. Everywhere else must
#: import, so key-string uniqueness stays checkable in one pass exactly
#: like the magic/domain byte universes.
META_KEY_RELS = ("comm/wire.py", "obs/trace.py")


@register(
    "wire-meta-key-unique",
    "*_META_KEY meta-field names declared only in the wire layer "
    "(comm/wire.py, obs/trace.py), non-empty string literals, globally "
    "unique",
)
def check_meta_key_unique(project: Project) -> Iterator[Finding]:
    wire = project.module(WIRE_REL)
    if wire is None:
        return
    seen: dict[str, str] = {}
    declared = 0
    for m in project.modules:
        in_layer = any(m.rel.endswith(rel) for rel in META_KEY_RELS)
        if m.tree is None:
            continue
        for node in m.tree.body:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target = node.targets[0]
            if not isinstance(target, ast.Name) or not target.id.endswith(
                "_META_KEY"
            ):
                continue
            if not in_layer:
                yield Finding(
                    "wire-meta-key-unique",
                    m.rel,
                    node.lineno,
                    f"{target.id} declared outside the wire layer "
                    f"({' | '.join(META_KEY_RELS)}) — meta keys must "
                    "live where their uniqueness is checkable in one "
                    "pass (import the constant instead)",
                )
                continue
            declared += 1
            value = str_const(node.value)
            if not value:
                yield Finding(
                    "wire-meta-key-unique",
                    m.rel,
                    node.lineno,
                    f"{target.id} must be a non-empty string literal "
                    "(meta keys are plain-JSON field names)",
                )
                continue
            prior = seen.get(value)
            if prior is not None:
                yield Finding(
                    "wire-meta-key-unique",
                    m.rel,
                    node.lineno,
                    f"{target.id} duplicates the meta-key string of "
                    f"{prior} ({value!r}) — two capabilities sharing one "
                    "meta field would silently shadow each other on old "
                    "peers",
                )
            else:
                seen[value] = target.id
    if declared == 0:
        yield Finding(
            "wire-meta-key-unique",
            wire.rel,
            1,
            "no *_META_KEY constants found in the wire layer — the "
            "meta-key pass has lost its anchor (renamed constants?)",
        )
