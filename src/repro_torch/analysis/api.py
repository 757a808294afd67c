"""Assertion helpers over a rank's record of its collective calls
(``Comm.counters()`` or ``collectives.WireTap.counters()``), so that
runtime tests and the contract pass read the same summary.

``expect_collectives`` asserts an exact count of the allowed kinds and
zero of any other; ``expect_clean`` is the zero-collective form.  Both
raise ``AssertionError`` naming what was found.
"""
from __future__ import annotations


def expect_collectives(counters: dict, count: int,
                       kinds: tuple = ("all_reduce",),
                       subject: str = "solve"):
    """Assert exactly ``count`` calls of ``kinds`` and none of any other
    kind; returns the :class:`~repro_torch.core.collectives.
    CollectiveSummary` for further inspection."""
    from repro_torch.core.collectives import collective_summary

    summary = collective_summary(counters)
    allowed = set(kinds)
    stray = {k: v for k, v in summary.by_kind.items() if k not in allowed}
    if stray:
        raise AssertionError(
            f"{subject}: disallowed collective(s) {stray} (allowed "
            f"{sorted(allowed)}): {summary}")
    n = sum(summary.calls(k) for k in allowed)
    if n != count:
        raise AssertionError(
            f"{subject}: expected exactly {count} {'+'.join(kinds)}, found "
            f"{n}: {summary}")
    return summary


def expect_clean(counters: dict, subject: str = "solve"):
    """Assert the record holds NO collective call at all."""
    return expect_collectives(counters, 0, kinds=(), subject=subject)
