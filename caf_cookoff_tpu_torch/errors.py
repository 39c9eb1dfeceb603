"""Typed engine errors.

The engines have legitimate reroutes (a doppler span outside the
segmented engine's envelope, a shape a kernel cannot take); these
classes name exactly the conditions a caller may catch and reroute.
All subclass ``ValueError`` so "raises ValueError on bad input" holds.
"""

from __future__ import annotations


class EngineError(ValueError):
    """Base class for engine-envelope conditions a caller may reroute."""


class SpanError(EngineError):
    """The doppler span is outside the segmented (Stein) engine's
    block-constant phase envelope (``models/_stein_plan._auto_block_len``).
    Legal reroutes: the filterbank paths."""


class EligibilityError(EngineError):
    """The shapes or backend violate a kernel's contract (non-512-multiple
    correlation length, an engine not ported yet, ...).  The same math is
    available on the filterbank tier — reroute there."""


class VmemBudgetError(EngineError):
    """A kernel's working set for this shape needs more shared memory or
    registers than the card has.  Reroute to the unfused path or use a
    larger block length."""
