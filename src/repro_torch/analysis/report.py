"""Report types for the contract engine, in the reference's JSON shape
(``repro.analysis.report``): standard library only, so the lint pass and
the CLI's argument handling import nothing else.

A :class:`Violation` is one broken contract, named precisely enough to act
on -- ``subject`` identifies the case, plan entry or file:line, ``message``
names the offending call or chunk.  A :class:`PassReport` is one pass's
sweep (how many cases ran, which were skipped and why, what broke);
:class:`Report` aggregates the three passes and serialises.
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class Violation:
    check: str    # contract name, e.g. "collective-count", "smem-budget"
    subject: str  # case / plan / file:line the contract was checked on
    message: str  # actionable: names the offending call or plan entry

    def __str__(self) -> str:
        return f"[{self.check}] {self.subject}: {self.message}"


@dataclasses.dataclass
class PassReport:
    name: str
    cases: list = dataclasses.field(default_factory=list)      # case names swept
    skipped: list = dataclasses.field(default_factory=list)    # (case, reason)
    violations: list = dataclasses.field(default_factory=list)  # Violation

    @property
    def ok(self) -> bool:
        return not self.violations

    def case(self, name: str) -> str:
        self.cases.append(name)
        return name

    def skip(self, name: str, reason: str) -> None:
        self.skipped.append((name, reason))

    def to_dict(self) -> dict:
        return {
            "name": self.name, "ok": self.ok, "n_cases": len(self.cases),
            "cases": list(self.cases),
            "skipped": [{"case": c, "reason": r} for c, r in self.skipped],
            "violations": [dataclasses.asdict(v) for v in self.violations],
        }


@dataclasses.dataclass
class Report:
    passes: list = dataclasses.field(default_factory=list)  # PassReport
    meta: dict = dataclasses.field(default_factory=dict)    # versions, shapes

    @property
    def ok(self) -> bool:
        return all(p.ok for p in self.passes)

    @property
    def violations(self) -> list:
        return [v for p in self.passes for v in p.violations]

    def to_dict(self) -> dict:
        return {"ok": self.ok, "meta": dict(self.meta),
                "passes": [p.to_dict() for p in self.passes]}

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)

    def summary(self) -> str:
        lines = []
        for p in self.passes:
            status = "ok" if p.ok else f"{len(p.violations)} violation(s)"
            extra = f", {len(p.skipped)} skipped" if p.skipped else ""
            lines.append(f"{p.name}: {len(p.cases)} case(s){extra} -- {status}")
            lines.extend(f"  {v}" for v in p.violations)
        lines.append("ANALYSIS " + ("PASS" if self.ok else "FAIL"))
        return "\n".join(lines)
