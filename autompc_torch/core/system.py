"""System metadata (port of ``autompc_tpu/core/system.py``).

The system is static, hashable metadata: dimensions, labels and ``dt``.
Pure Python, identical in behaviour to the JAX package's class.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


class System:
    """A robot system: named observation and control dimensions plus an
    optional time step ``dt``.

    Hashable and immutable (``dt`` may be set once on a dt-less
    system).
    """

    __slots__ = ("_observations", "_controls", "_dt")

    def __init__(
        self,
        observations: Sequence[str],
        controls: Sequence[str],
        dt: Optional[float] = None,
    ):
        obs = tuple(observations)
        ctrls = tuple(controls)
        obs_set, ctrl_set = set(obs), set(ctrls)
        err = ValueError("Observation and control labels must be unique")
        if len(obs_set) != len(obs) or len(ctrl_set) != len(ctrls):
            raise err
        if ctrl_set & obs_set:
            raise err
        object.__setattr__(self, "_observations", obs)
        object.__setattr__(self, "_controls", ctrls)
        object.__setattr__(self, "_dt", float(dt) if dt is not None else None)

    def __setattr__(self, name, value):
        # Allow the reference idiom `system.dt = 0.05` exactly once on a
        # dt-less system; otherwise the object is frozen.
        if name == "dt" and self._dt is None:
            object.__setattr__(self, "_dt", float(value))
            return
        raise AttributeError("System is immutable")

    # -- reference-parity API (system.py:52-90) -----------------------
    @property
    def observations(self) -> Tuple[str, ...]:
        return self._observations

    @property
    def controls(self) -> Tuple[str, ...]:
        return self._controls

    @property
    def obs_dim(self) -> int:
        return len(self._observations)

    @property
    def ctrl_dim(self) -> int:
        return len(self._controls)

    @property
    def dt(self) -> Optional[float]:
        return self._dt

    # Immutable: copies can share the instance.
    def __copy__(self):
        return self

    def __deepcopy__(self, memo):
        return self

    # -- hashing / equality -------------------------------------------
    def __eq__(self, other):
        return (
            isinstance(other, System)
            and self._observations == other._observations
            and self._controls == other._controls
            and self._dt == other._dt
        )

    def __hash__(self):
        return hash((self._observations, self._controls, self._dt))

    def obs_index(self, label: str) -> int:
        try:
            return self._observations.index(label)
        except ValueError:
            raise ValueError(
                f"Unknown observation label {label!r}; "
                f"observations are {list(self._observations)}"
            ) from None

    def ctrl_index(self, label: str) -> int:
        try:
            return self._controls.index(label)
        except ValueError:
            raise ValueError(
                f"Unknown control label {label!r}; "
                f"controls are {list(self._controls)}"
            ) from None

    def __repr__(self):
        dt_str = f", dt={self._dt}" if self._dt is not None else ""
        return (
            f"System(obs={list(self._observations)}, "
            f"ctrls={list(self._controls)}{dt_str})"
        )
