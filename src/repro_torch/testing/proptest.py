"""Deterministic micro-implementation of the hypothesis API surface the
property suites use: the port's own copy of ``repro.testing.proptest``
(plain Python), drawing the same examples for the same seed.

Covers exactly what the suite needs — ``given``, ``settings`` and the
strategies ``integers``, ``sampled_from``, ``tuples``, ``lists`` — drawing
``max_examples`` pseudo-random examples from a fixed seed so failures are
reproducible run-to-run. It does NOT shrink counterexamples (the schedule
harness has its own minimizer, ``testing.schedules.shrink_schedule``) or
persist a failure database; where the real hypothesis is installed a suite
may prefer it.
"""
from __future__ import annotations

import random
from typing import Any, Callable

DEFAULT_MAX_EXAMPLES = 25
_SEED = 0xC0FFEE


class Strategy:
    """A strategy is just a draw(rng) -> value callable with combinators."""

    def __init__(self, draw: Callable[[random.Random], Any]):
        self._draw = draw

    def draw(self, rng: random.Random) -> Any:
        return self._draw(rng)


def integers(min_value: int = 0, max_value: int = 1 << 16) -> Strategy:
    return Strategy(lambda rng: rng.randint(min_value, max_value))


def sampled_from(options) -> Strategy:
    opts = list(options)
    return Strategy(lambda rng: rng.choice(opts))


def tuples(*strats: Strategy) -> Strategy:
    return Strategy(lambda rng: tuple(s.draw(rng) for s in strats))


def lists(elements: Strategy, *, min_size: int = 0, max_size: int = 10) -> Strategy:
    def draw(rng: random.Random):
        n = rng.randint(min_size, max_size)
        return [elements.draw(rng) for _ in range(n)]

    return Strategy(draw)


def settings(*, max_examples: int = DEFAULT_MAX_EXAMPLES, deadline=None, **_ignored):
    """Decorator recording the example budget on the test function."""

    def wrap(fn):
        fn._proptest_max_examples = max_examples
        return fn

    return wrap


def given(*strats: Strategy):
    """Run the test once per drawn example (seeded => deterministic order).

    Applied below ``settings`` like hypothesis; reads the budget the
    ``settings`` decorator stored (which wraps the function *after* given in
    the conventional ``@settings`` / ``@given`` stacking order, so given
    re-reads it lazily at call time via the outer wrapper attribute).
    """

    def deco(fn):
        # NOTE: no functools.wraps — the runner must present a ZERO-argument
        # signature to pytest, or the strategy-filled parameters would be
        # collected as (missing) fixtures.
        def runner():
            n = getattr(runner, "_proptest_max_examples",
                        getattr(fn, "_proptest_max_examples", DEFAULT_MAX_EXAMPLES))
            rng = random.Random(_SEED)
            for i in range(n):
                example = [s.draw(rng) for s in strats]
                try:
                    fn(*example)
                except Exception as e:  # pragma: no cover - failure path
                    raise AssertionError(
                        f"falsifying example #{i}: {example!r}"
                    ) from e

        runner.__name__ = fn.__name__
        runner.__qualname__ = fn.__qualname__
        runner.__doc__ = fn.__doc__
        runner.__module__ = fn.__module__
        return runner

    return deco


class strategies:  # noqa: N801 - namespace mimicking `hypothesis.strategies`
    integers = staticmethod(integers)
    sampled_from = staticmethod(sampled_from)
    tuples = staticmethod(tuples)
    lists = staticmethod(lists)
