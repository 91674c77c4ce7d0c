"""torchlint rule registry.

The port of splink_tpu/analysis/rules/__init__.py. A rule is a plain
function ``check(mod: ModuleLint) -> Iterable[Finding]`` registered under a
stable id with :func:`rule`. The registry is the single catalog: the CLI's
``--list-rules`` and the twin tests enumerate it, so a rule cannot exist
without an id, a title and a doc line.

The rules keep the reference's ids and hazards, rewritten for PyTorch:
JL001 and JL003 (:mod:`.host_calls`), JL004 and JL005 (:mod:`.dtypes`),
JL006 (:mod:`.import_time`), JL009-JL012 (:mod:`.distributed`). Three of
the reference's rules have no counterpart, and their ids are not reused:

  JL002  Python ``if``/``while`` on a traced value. Under jit that raises
         or specialises the program; eager PyTorch evaluates the branch on
         a real value, and the read it costs is JL003's host sync.
  JL007  jit recompilation (a wrapper built per loop iteration, a
         loop-varying static argument). Eager PyTorch compiles nothing.
  JL008  a donated buffer read after the donating call. PyTorch has no
         buffer donation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Iterator


@dataclass(frozen=True)
class RuleSpec:
    id: str
    title: str
    check: Callable
    doc: str  # one-line hazard description for --list-rules


RULES: dict[str, RuleSpec] = {}


def rule(rule_id: str, title: str, doc: str):
    """Register a rule function under a stable id."""

    def deco(check: Callable) -> Callable:
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        RULES[rule_id] = RuleSpec(rule_id, title, check, doc)
        return check

    return deco


def iter_rules(only: Iterable[str] | None = None) -> Iterator[tuple[str, Callable]]:
    """(id, check) pairs, optionally restricted to the given ids."""
    if only is not None:
        only = list(only)
        unknown = [r for r in only if r not in RULES]
        if unknown:
            raise KeyError(f"unknown rule id(s): {', '.join(unknown)}")
        ids = only
    else:
        ids = sorted(RULES)
    for rule_id in ids:
        yield rule_id, RULES[rule_id].check


# importing the rule modules populates RULES
from . import distributed, dtypes, host_calls, import_time  # noqa: E402,F401
