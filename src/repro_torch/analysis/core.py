"""Pass framework plumbing: violations, suppressions, the report (a copy
of ``repro.analysis.core``; only the walk differs, see
:func:`iter_source_files`).

Every pass — AST or step — reduces to a list of :class:`Violation`.
A :class:`Report` collects them, applies inline suppressions, and
renders deterministically (sorted, stable JSON) so two runs over the
same tree are byte-identical — the report itself must pass the
determinism bar it enforces.

Suppression syntax (one reviewed finding, one line)::

    t0 = time.time()   # lint: ignore[wall-clock] -- provenance stamp

``# lint: ignore[rule-a,rule-b]`` suppresses the named rules on that
physical line only. A bare ``# lint: skip-file`` on one of the first
ten lines exempts the whole file (reserved for vendored code).
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["Violation", "Report", "iter_source_files", "suppressed_lines",
           "SKIP_FILE_RE"]

_IGNORE_RE = re.compile(r"#\s*lint:\s*ignore\[([\w\-, ]+)\]")
SKIP_FILE_RE = re.compile(r"#\s*lint:\s*skip-file\b")

# what the port's AST walk covers, relative to the repo root: the
# package, its smoke script and its tests
SOURCE_GLOBS = ("src/repro_torch/**/*.py", "chip_smoke.py",
                "tests/test_torch_*.py")


@dataclass(frozen=True, order=True)
class Violation:
    """One finding. Ordered so reports sort deterministically."""

    path: str           # repo-relative file, or a program tag for a step
    line: int           # 1-based; 0 for whole-program findings
    rule: str           # e.g. "wall-clock", "donation-audit"
    message: str

    def to_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "message": self.message}

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"


def suppressed_lines(source: str) -> dict[int, set[str]]:
    """``{line_number: {rules}}`` for every inline suppression."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _IGNORE_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def file_skipped(source: str) -> bool:
    head = source.splitlines()[:10]
    return any(SKIP_FILE_RE.search(line) for line in head)


def iter_source_files(root: str | Path) -> list[Path]:
    """Every ``.py`` file of the port the lint covers, sorted: the package
    ``src/repro_torch``, ``chip_smoke.py`` and ``tests/test_torch_*.py``
    (the JAX package's walk covers ``src tests benchmarks examples``)."""
    root = Path(root)
    return sorted({f for pattern in SOURCE_GLOBS for f in root.glob(pattern)
                   if f.is_file()})


@dataclass
class Report:
    """Violations + run metadata, rendered deterministically."""

    violations: list[Violation] = field(default_factory=list)
    suppressed: list[Violation] = field(default_factory=list)
    # pass name -> summary counters (files scanned, programs certified...)
    summary: dict[str, dict] = field(default_factory=dict)

    def extend(self, violations, suppressions: dict[int, set[str]]
               | None = None) -> None:
        """Add findings, diverting any whose (line, rule) is suppressed."""
        for v in violations:
            rules = (suppressions or {}).get(v.line, ())
            if v.rule in rules:
                self.suppressed.append(v)
            else:
                self.violations.append(v)

    def note(self, pass_name: str, **counters) -> None:
        entry = self.summary.setdefault(pass_name, {})
        for k, v in counters.items():
            entry[k] = entry.get(k, 0) + v if isinstance(v, (int, float)) \
                else v

    @property
    def clean(self) -> bool:
        return not self.violations

    def merge_json(self, payload: str) -> None:
        """Fold a child process's :meth:`to_json` report into this one
        (the step passes run in a subprocess, whose fake process group
        must not outlive it)."""
        data = json.loads(payload)
        self.violations.extend(Violation(**v) for v in data["violations"])
        self.suppressed.extend(Violation(**v) for v in data["suppressed"])
        for name, counters in data["summary"].items():
            self.note(name, **counters)

    def to_json(self) -> str:
        payload = {
            "clean": self.clean,
            "violations": [v.to_dict() for v in sorted(self.violations)],
            "suppressed": [v.to_dict() for v in sorted(self.suppressed)],
            "summary": {k: dict(sorted(v.items()))
                        for k, v in sorted(self.summary.items())},
        }
        return json.dumps(payload, indent=1, sort_keys=True)

    def render_text(self) -> str:
        lines = []
        for v in sorted(self.violations):
            lines.append(v.render())
        lines.append(f"{len(self.violations)} violation(s), "
                     f"{len(self.suppressed)} suppressed")
        for name, counters in sorted(self.summary.items()):
            stats = ", ".join(f"{k}={v}" for k, v in sorted(counters.items()))
            lines.append(f"  [{name}] {stats}")
        return "\n".join(lines)
