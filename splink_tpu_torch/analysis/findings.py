"""Structured findings shared by both analysis layers.

A finding is one concrete hazard at one location: the lint layer anchors it
to ``file:line`` in source, the trace-audit layer to a kernel name in the
registry (line 0). Findings render as one grep-able text line each, or as
JSON (``--json``) for tooling — the same two output modes the reference's
SQL validation errors had (a human message and the offending SQL string).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field


@dataclass(frozen=True)
class Finding:
    """One hazard at one location."""

    rule: str  # rule id, e.g. "JL004", or audit check id, e.g. "TA-DTYPE"
    path: str  # source file (lint) or kernel name (audit)
    line: int  # 1-based source line; 0 for whole-kernel audit findings
    message: str  # what is wrong, with the offending names/dtypes inline
    hint: str = ""  # how to fix it
    col: int = 0  # 0-based column offset

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        text = f"{loc}: {self.rule}: {self.message}"
        if self.hint:
            text += f" [fix: {self.hint}]"
        return text


@dataclass
class Report:
    """All findings from one run of one or both layers."""

    findings: list[Finding] = field(default_factory=list)
    files_checked: int = 0
    kernels_audited: int = 0
    shard_kernels_audited: int = 0
    perf_shapes_audited: int = 0
    thread_classes_audited: int = 0
    num_kernels_audited: int = 0

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    @property
    def clean(self) -> bool:
        return not self.findings

    def sorted(self) -> list[Finding]:
        return sorted(
            self.findings, key=lambda f: (f.path, f.line, f.col, f.rule)
        )

    def format_text(self) -> str:
        lines = [f.format() for f in self.sorted()]
        tail = (
            f"{len(self.findings)} finding(s) in {self.files_checked} "
            f"file(s), {self.kernels_audited} kernel(s) audited"
        )
        if self.shard_kernels_audited:
            tail += f", {self.shard_kernels_audited} shard kernel(s) audited"
        if self.perf_shapes_audited:
            tail += (
                f", {self.perf_shapes_audited} perf shape(s) measured"
            )
        if self.thread_classes_audited:
            tail += (
                f", {self.thread_classes_audited} thread class(es) audited"
            )
        if self.num_kernels_audited:
            tail += (
                f", {self.num_kernels_audited} kernel(s) numerics-audited"
            )
        lines.append(tail)
        return "\n".join(lines)

    def format_json(self) -> str:
        return json.dumps(
            {
                "findings": [asdict(f) for f in self.sorted()],
                "files_checked": self.files_checked,
                "kernels_audited": self.kernels_audited,
                "shard_kernels_audited": self.shard_kernels_audited,
                "perf_shapes_audited": self.perf_shapes_audited,
                "thread_classes_audited": self.thread_classes_audited,
                "num_kernels_audited": self.num_kernels_audited,
                "clean": self.clean,
            },
            indent=2,
        )
