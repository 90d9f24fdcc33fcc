"""Test-suite compatibility shims.

Several modules property-test with ``hypothesis``; bare environments may not
have it installed (the CI lane installs it, so the shim is the bare-machine
fallback — tests/test_conftest_shim.py exercises it directly either way).
When the real package is absent we install a minimal deterministic stand-in
into ``sys.modules`` *before* test collection imports the modules.  The stand-in covers exactly the API surface
this suite uses — ``given``/``settings`` and the ``integers``, ``floats``,
``booleans``, ``lists``, ``sampled_from``, ``data`` strategies — and replays
each property over ``max_examples`` seeded-random draws, so the property tests
still sweep their input space (deterministically) instead of being skipped.
"""

from __future__ import annotations

import functools
import inspect
import random
import sys
import types


def _install_hypothesis_fallback() -> None:
    class _Strategy:
        def __init__(self, draw):
            self.draw_from = draw

    class _DataObject:
        """Stand-in for hypothesis's interactive ``data()`` draw handle."""

        def __init__(self, rng):
            self._rng = rng

        def draw(self, strategy, label=None):
            return strategy.draw_from(self._rng)

    def integers(min_value=0, max_value=2**31 - 1):
        return _Strategy(lambda r: r.randint(min_value, max_value))

    def floats(min_value=0.0, max_value=1.0, **_):
        return _Strategy(lambda r: r.uniform(min_value, max_value))

    def booleans():
        return _Strategy(lambda r: r.random() < 0.5)

    def lists(elements, min_size=0, max_size=None):
        hi = min_size + 16 if max_size is None else max_size
        return _Strategy(
            lambda r: [elements.draw_from(r) for _ in range(r.randint(min_size, hi))]
        )

    def sampled_from(seq):
        choices = list(seq)
        return _Strategy(lambda r: r.choice(choices))

    def data():
        return _Strategy(lambda r: _DataObject(r))

    def given(**strategies):
        def decorate(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_max_examples", None) or getattr(
                    fn, "_max_examples", None
                ) or 20
                for example in range(n):
                    rng = random.Random((example + 1) * 7919)
                    drawn = {k: s.draw_from(rng) for k, s in strategies.items()}
                    fn(*args, **drawn, **kwargs)

            # hide the drawn parameters from pytest's fixture resolution
            sig = inspect.signature(fn)
            params = [p for p in sig.parameters.values() if p.name not in strategies]
            wrapper.__signature__ = sig.replace(parameters=params)
            del wrapper.__wrapped__
            return wrapper

        return decorate

    def settings(max_examples=20, **_):
        def decorate(fn):
            fn._max_examples = max_examples
            return fn

        return decorate

    st_mod = types.ModuleType("hypothesis.strategies")
    for name in ("integers", "floats", "booleans", "lists", "sampled_from", "data"):
        setattr(st_mod, name, locals()[name])

    mod = types.ModuleType("hypothesis")
    mod.given = given
    mod.settings = settings
    mod.strategies = st_mod
    mod.__is_repro_fallback__ = True
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st_mod


try:  # pragma: no cover - exercised implicitly by collection
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_fallback()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; the test skips itself where there is none")
