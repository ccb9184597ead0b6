"""The ``Checker`` API every engine of the port offers.

The port's copy of ``stateright_tpu/checker/base.py``: state counts,
discovery lookup, joining, the status report, and the assertion helpers.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

from .model import Expectation
from .path import Path

__all__ = ["Checker"]


class Checker:
    """Model checking in progress or done. Instantiate through
    ``model.checker().spawn_cuda_bfs()`` or ``.spawn_bfs()``."""

    def model(self):
        raise NotImplementedError

    def state_count(self) -> int:
        """States generated, repeats included."""
        raise NotImplementedError

    def unique_state_count(self) -> int:
        """Distinct states generated."""
        raise NotImplementedError

    def discoveries(self) -> Dict[str, Path]:
        """Map from property name to its discovery path."""
        raise NotImplementedError

    def join(self) -> "Checker":
        """Blocks until checking is done."""
        raise NotImplementedError

    def is_done(self) -> bool:
        raise NotImplementedError

    def discovery(self, name: str) -> Optional[Path]:
        return self.discoveries().get(name)

    def report(self, w=None, period_s: float = 1.0) -> "Checker":
        """Writes a status line every ``period_s`` until done, then
        ``Done. states=N, unique=M, sec=S`` and one line per discovery."""
        w = sys.stdout if w is None else w
        start = time.monotonic()
        while not self.is_done():
            w.write(f"Checking. states={self.state_count()}, "
                    f"unique={self.unique_state_count()}\n")
            w.flush()
            time.sleep(period_s)
        w.write(f"Done. states={self.state_count()}, "
                f"unique={self.unique_state_count()}, "
                f"sec={int(time.monotonic() - start)}\n")
        for name, path in self.discoveries().items():
            w.write(f'Discovered "{name}" '
                    f"{self.discovery_classification(name)} {path}")
        w.flush()
        return self

    def discovery_classification(self, name: str) -> str:
        prop = self.model().property(name)
        if prop.expectation is Expectation.SOMETIMES:
            return "example"
        return "counterexample"

    def assert_properties(self) -> None:
        """Examples exist for every sometimes property, and no
        counterexample for any always or eventually property. The paths
        are rebuilt once for all the properties."""
        found = self.discoveries()
        for p in self.model().properties():
            if p.expectation is Expectation.SOMETIMES:
                self.assert_any_discovery(p.name, found)
            else:
                self.assert_no_discovery(p.name, found)

    def assert_any_discovery(self, name: str, discoveries=None) -> Path:
        """``discoveries``, where given, is ``self.discoveries()``."""
        found = (self.discovery(name) if discoveries is None
                 else discoveries.get(name))
        if found is not None:
            return found
        if not self.is_done():
            raise AssertionError(f'Discovery for "{name}" not found, but '
                                 "model checking is incomplete.")
        raise AssertionError(f'Discovery for "{name}" not found.')

    def assert_no_discovery(self, name: str, discoveries=None) -> None:
        """``discoveries`` as ``assert_any_discovery``'s."""
        found = (self.discovery(name) if discoveries is None
                 else discoveries.get(name))
        if found is not None:
            raise AssertionError(
                f'Unexpected "{name}" {self.discovery_classification(name)} '
                f"{found}Last state: {found.last_state()!r}\n")
        if not self.is_done():
            raise AssertionError(f'Discovery for "{name}" not found, but '
                                 "model checking is incomplete.")

    def assert_discovery(self, name: str, actions: List) -> None:
        """Raises unless ``actions``, replayed on the model's host
        transitions from an init state, demonstrate a discovery of
        ``name`` by its expectation (the reference's
        ``checker.rs:292-337``)."""
        additional_info: List[str] = []
        found = self.assert_any_discovery(name)
        model = self.model()
        prop = model.property(name)
        for init_state in model.init_states():
            path = Path.from_actions(model, init_state, actions)
            if path is None:
                continue
            if prop.expectation is Expectation.ALWAYS:
                if not prop.condition(model, path.last_state()):
                    return
            elif prop.expectation is Expectation.EVENTUALLY:
                states = path.into_states()
                is_liveness_satisfied = any(
                    prop.condition(model, s) for s in states)
                last_actions: List = []
                model.actions(states[-1], last_actions)
                is_path_terminal = not last_actions
                if not is_liveness_satisfied and is_path_terminal:
                    return
                if is_liveness_satisfied:
                    additional_info.append("incorrect counterexample "
                                           "satisfies eventually property")
                if not is_path_terminal:
                    additional_info.append(
                        "incorrect counterexample is nonterminal")
            elif prop.condition(model, path.last_state()):  # SOMETIMES
                return
        extra = f" ({'; '.join(additional_info)})" if additional_info else ""
        raise AssertionError(
            f'Invalid discovery for "{name}"{extra}, but a valid one was '
            f"found. found={found.into_actions()!r}")
