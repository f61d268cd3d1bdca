"""Shared test fixtures + an optional-dependency shim for ``hypothesis``.

Several test modules use hypothesis property tests. The package is optional
(it is absent from minimal CI images); when it is missing we install a tiny
deterministic stand-in into ``sys.modules`` *before* test collection so the
modules still import and the property tests run over a small fixed set of
examples instead of erroring at collection time.

The stub covers exactly the API surface these tests use:
``given``, ``settings``, and ``strategies.{integers,booleans,sampled_from,
floats}``. Real hypothesis, when installed, is always preferred.
"""
from __future__ import annotations

import functools
import random
import sys
import types

try:  # pragma: no cover - exercised only when hypothesis is installed
    import hypothesis  # noqa: F401
except ImportError:
    _STUB_EXAMPLES = 5  # deterministic examples per @given test

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def draw(self, rng: random.Random):
            return self._draw(rng)

    def _integers(min_value, max_value):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def _booleans():
        return _Strategy(lambda rng: rng.random() < 0.5)

    def _sampled_from(seq):
        seq = list(seq)
        return _Strategy(lambda rng: seq[rng.randrange(len(seq))])

    def _floats(min_value=0.0, max_value=1.0, **_kw):
        return _Strategy(lambda rng: rng.uniform(min_value, max_value))

    def _settings(max_examples=None, deadline=None, **_kw):
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn
        return deco

    def _given(*arg_strategies, **kw_strategies):
        def deco(fn):
            import inspect

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = (getattr(wrapper, "_stub_max_examples", None)
                     or getattr(fn, "_stub_max_examples", None)
                     or _STUB_EXAMPLES)
                n = min(int(n), _STUB_EXAMPLES)
                for i in range(n):
                    # one fixed rng per example index -> fully reproducible
                    rng = random.Random(0xC0FFEE + 7919 * i)
                    pos = tuple(s.draw(rng) for s in arg_strategies)
                    drawn = {k: s.draw(rng) for k, s in kw_strategies.items()}
                    fn(*args, *pos, **kwargs, **drawn)
            # hide strategy-filled parameters from pytest's fixture resolver
            # (functools.wraps would otherwise expose them as fixtures)
            sig = inspect.signature(fn)
            n_pos = len(arg_strategies)
            remaining = [p for i, (name, p) in enumerate(sig.parameters.items())
                         if i >= n_pos and name not in kw_strategies]
            wrapper.__signature__ = sig.replace(parameters=remaining)
            if hasattr(wrapper, "__wrapped__"):
                del wrapper.__wrapped__
            wrapper._hypothesis_stub = True
            return wrapper
        return deco

    _strategies = types.ModuleType("hypothesis.strategies")
    _strategies.integers = _integers
    _strategies.booleans = _booleans
    _strategies.sampled_from = _sampled_from
    _strategies.floats = _floats

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _strategies
    _hyp.__is_stub__ = True

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel, so needs a card; skips "
        "without one")
