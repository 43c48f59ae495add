"""Configuration spaces (port of ``autompc_tpu/config/space.py``, a
numpy-only module kept here as the port's own copy, unchanged in
behaviour: the same hyperparameter classes, conditions, defaults,
``sample_configuration`` draws from a ``numpy.random.Generator`` and
unit-hypercube ``encode``/``decode``, so one seed asks the same
configurations in both packages).

Lightweight, self-contained configuration-space system.

Re-creates the capabilities AutoMPC gets from the ConfigSpace package
(see reference usage in autompc/utils/cs_utils.py:162-293 and the factory
`get_configuration_space` methods), with two TPU-motivated additions:

1. **Vectorized encode/decode** (`ConfigurationSpace.encode` /
   `decode`): configurations map to fixed-width unit-hypercube feature
   vectors so a batched Bayesian-optimization tuner can propose and score
   *batches* of configurations with array math instead of ConfigSpace's
   one-at-a-time object API.
2. **Shape signatures** (`Configuration.shape_signature`): tuners bucket
   configurations whose hyperparameters imply identical compiled array
   shapes, so jitted evaluation functions are reused instead of
   recompiled per configuration.

Supported features (mirroring the reference's usage of ConfigSpace):
  - Uniform float / integer hyperparameters with optional log scale
    (e.g. quad_cost_factory.py:738-750 uses log-scale 1e-3..1e4 floats).
  - Categorical hyperparameters and constants.
  - Conditional activation: ``InCondition`` / ``EqualsCondition``
    (e.g. sindy.py:66-67 conditions lasso_alpha on method=="lasso").
  - Forbidden clauses (AND-conjunctions of equality terms).
  - Prefix-merge of subspaces with optional parent conditioning
    (`add_configuration_space`, mirroring cs_utils.py:162-260) and
    extraction back out (`set_subspace_configuration`, cs_utils.py:142).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Hyperparameter",
    "UniformFloatHyperparameter",
    "UniformIntegerHyperparameter",
    "CategoricalHyperparameter",
    "Constant",
    "Condition",
    "EqualsCondition",
    "InCondition",
    "AndConjunction",
    "ForbiddenEqualsClause",
    "ForbiddenAndConjunction",
    "Configuration",
    "ConfigurationSpace",
    "add_configuration_space",
    "set_subspace_configuration",
    "set_parent_configuration",
    "set_hyper_bounds",
    "set_hyper_choices",
    "set_hyper_constant",
]


class Hyperparameter:
    """Base class for hyperparameters."""

    def __init__(self, name: str, default_value: Any):
        self.name = name
        self.default_value = default_value

    def copy(self, name: Optional[str] = None) -> "Hyperparameter":
        raise NotImplementedError

    # --- unit-interval encoding -------------------------------------
    def to_unit(self, value: Any) -> float:
        raise NotImplementedError

    def from_unit(self, u: float) -> Any:
        raise NotImplementedError

    def sample(self, rng: np.random.Generator) -> Any:
        return self.from_unit(float(rng.uniform()))

    def is_legal(self, value: Any) -> bool:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"


class UniformFloatHyperparameter(Hyperparameter):
    def __init__(self, name, lower, upper, default_value=None, log=False):
        if lower >= upper:
            raise ValueError(f"lower must be < upper for {name}")
        if log and lower <= 0:
            raise ValueError(f"log-scale hyperparameter {name} requires lower > 0")
        if default_value is None:
            default_value = (
                math.sqrt(lower * upper) if log else 0.5 * (lower + upper)
            )
        super().__init__(name, float(default_value))
        self.lower = float(lower)
        self.upper = float(upper)
        self.log = bool(log)

    def copy(self, name=None):
        return UniformFloatHyperparameter(
            name or self.name, self.lower, self.upper, self.default_value, self.log
        )

    def to_unit(self, value):
        if self.log:
            return (math.log(value) - math.log(self.lower)) / (
                math.log(self.upper) - math.log(self.lower)
            )
        return (value - self.lower) / (self.upper - self.lower)

    def from_unit(self, u):
        u = min(max(float(u), 0.0), 1.0)
        if self.log:
            v = float(
                math.exp(
                    math.log(self.lower)
                    + u * (math.log(self.upper) - math.log(self.lower))
                )
            )
        else:
            v = float(self.lower + u * (self.upper - self.lower))
        # exp(log(upper)) can land epsilon OUTSIDE the bounds (u=1.0
        # decoded 10000.00000000001 on a (1e-3, 1e4) log hp — an
        # is_legal violation that broke a checkpoint round-trip);
        # decode must land inside.
        return min(max(v, self.lower), self.upper)

    def is_legal(self, value):
        try:
            v = float(value)
        except (TypeError, ValueError):
            return False
        return self.lower <= v <= self.upper


class UniformIntegerHyperparameter(Hyperparameter):
    def __init__(self, name, lower, upper, default_value=None, log=False):
        if lower > upper:
            raise ValueError(f"lower must be <= upper for {name}")
        if default_value is None:
            default_value = int(round(0.5 * (lower + upper)))
        super().__init__(name, int(default_value))
        self.lower = int(lower)
        self.upper = int(upper)
        self.log = bool(log)

    def copy(self, name=None):
        return UniformIntegerHyperparameter(
            name or self.name, self.lower, self.upper, self.default_value, self.log
        )

    def to_unit(self, value):
        if self.upper == self.lower:
            return 0.0
        if self.log:
            return (math.log(value) - math.log(self.lower)) / (
                math.log(self.upper) - math.log(self.lower)
            )
        return (value - self.lower) / (self.upper - self.lower)

    def from_unit(self, u):
        u = min(max(float(u), 0.0), 1.0)
        if self.log:
            v = math.exp(
                math.log(self.lower) + u * (math.log(self.upper) - math.log(self.lower))
            )
        else:
            v = self.lower + u * (self.upper - self.lower)
        return int(min(max(int(round(v)), self.lower), self.upper))

    def is_legal(self, value):
        try:
            v = int(value)
        except (TypeError, ValueError):
            return False
        return self.lower <= v <= self.upper and v == value


class CategoricalHyperparameter(Hyperparameter):
    def __init__(self, name, choices: Sequence[Any], default_value=None):
        choices = list(choices)
        if not choices:
            raise ValueError(f"choices must be non-empty for {name}")
        if default_value is None:
            default_value = choices[0]
        if default_value not in choices:
            raise ValueError(f"default {default_value!r} not in choices for {name}")
        super().__init__(name, default_value)
        self.choices = choices

    def copy(self, name=None):
        return CategoricalHyperparameter(
            name or self.name, self.choices, self.default_value
        )

    def to_unit(self, value):
        idx = self.choices.index(value)
        if len(self.choices) == 1:
            return 0.0
        return idx / (len(self.choices) - 1)

    def from_unit(self, u):
        u = min(max(float(u), 0.0), 1.0)
        idx = int(round(u * (len(self.choices) - 1)))
        return self.choices[idx]

    def sample(self, rng: np.random.Generator):
        return self.choices[int(rng.integers(len(self.choices)))]

    def is_legal(self, value):
        return value in self.choices


class Constant(Hyperparameter):
    def __init__(self, name, value):
        super().__init__(name, value)
        self.value = value

    def copy(self, name=None):
        return Constant(name or self.name, self.value)

    def to_unit(self, value):
        return 0.0

    def from_unit(self, u):
        return self.value

    def sample(self, rng):
        return self.value

    def is_legal(self, value):
        return value == self.value


# ---------------------------------------------------------------------------
# Conditions
# ---------------------------------------------------------------------------


class Condition:
    """Activation condition: `child` is only active when the condition on
    `parent` holds (and the parent itself is active)."""

    def __init__(self, child: str, parent: str):
        # Stored by *name* so prefix-renaming is a pure string rewrite.
        self.child = child
        self.parent = parent

    def holds(self, parent_value: Any) -> bool:
        raise NotImplementedError

    def rename(self, mapper) -> "Condition":
        raise NotImplementedError


class EqualsCondition(Condition):
    def __init__(self, child, parent, value):
        super().__init__(_name_of(child), _name_of(parent))
        self.value = value

    def holds(self, parent_value):
        return parent_value == self.value

    def rename(self, mapper):
        return EqualsCondition(mapper(self.child), mapper(self.parent), self.value)

    def __repr__(self):
        return f"EqualsCondition({self.child} | {self.parent} == {self.value!r})"


class InCondition(Condition):
    def __init__(self, child, parent, values):
        super().__init__(_name_of(child), _name_of(parent))
        self.values = list(values)

    def holds(self, parent_value):
        return parent_value in self.values

    def rename(self, mapper):
        return InCondition(mapper(self.child), mapper(self.parent), self.values)

    def __repr__(self):
        return f"InCondition({self.child} | {self.parent} in {self.values!r})"


class AndConjunction(Condition):
    """All sub-conditions (sharing one child) must hold."""

    def __init__(self, *conditions: Condition):
        if not conditions:
            raise ValueError("AndConjunction requires conditions")
        child = conditions[0].child
        for c in conditions:
            if c.child != child:
                raise ValueError("AndConjunction conditions must share a child")
        super().__init__(child, conditions[0].parent)
        self.conditions = list(conditions)

    def rename(self, mapper):
        return AndConjunction(*[c.rename(mapper) for c in self.conditions])


def _name_of(hp_or_name) -> str:
    if isinstance(hp_or_name, Hyperparameter):
        return hp_or_name.name
    return str(hp_or_name)


# ---------------------------------------------------------------------------
# Forbidden clauses
# ---------------------------------------------------------------------------


class ForbiddenEqualsClause:
    def __init__(self, hyperparameter, value):
        self.name = _name_of(hyperparameter)
        self.value = value

    def violated(self, values: Dict[str, Any]) -> bool:
        return self.name in values and values[self.name] == self.value

    def rename(self, mapper):
        return ForbiddenEqualsClause(mapper(self.name), self.value)


class ForbiddenAndConjunction:
    def __init__(self, *clauses):
        self.clauses = list(clauses)

    def violated(self, values):
        return all(c.violated(values) for c in self.clauses)

    def rename(self, mapper):
        return ForbiddenAndConjunction(*[c.rename(mapper) for c in self.clauses])


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


class Configuration:
    """A concrete assignment of values to the active hyperparameters of a
    ConfigurationSpace. Dict-like (mirrors ConfigSpace.Configuration usage
    in the reference, e.g. ``cfg["horizon"]`` / ``cfg.get_dictionary()``).
    """

    def __init__(self, space: "ConfigurationSpace", values: Dict[str, Any]):
        self.space = space
        self._values = dict(values)

    # -- dict-like ----------------------------------------------------
    def __getitem__(self, key):
        return self._values[key]

    def __setitem__(self, key, value):
        if key not in self.space._hyperparameters:
            raise KeyError(f"Unknown hyperparameter {key}")
        self._values[key] = value
        # Re-resolve activity so dependent params appear/disappear.
        self._values = self.space._resolve(self._values)

    def __contains__(self, key):
        return key in self._values

    def __iter__(self):
        return iter(self._values)

    def __len__(self):
        return len(self._values)

    def __eq__(self, other):
        return isinstance(other, Configuration) and self._values == other._values

    def keys(self):
        return self._values.keys()

    def items(self):
        return self._values.items()

    def get(self, key, default=None):
        return self._values.get(key, default)

    def get_dictionary(self) -> Dict[str, Any]:
        return dict(self._values)

    def __repr__(self):
        body = ", ".join(f"{k}={v!r}" for k, v in sorted(self._values.items()))
        return f"Configuration({body})"

    # -- TPU-specific helpers ----------------------------------------
    def shape_signature(self, shape_params: Optional[Sequence[str]] = None) -> Tuple:
        """Hashable signature of the hyperparameters that change compiled
        array shapes. With no argument, every int/categorical value is part
        of the signature (conservative)."""
        if shape_params is None:
            shape_params = [
                name
                for name, hp in self.space._hyperparameters.items()
                if isinstance(
                    hp, (UniformIntegerHyperparameter, CategoricalHyperparameter)
                )
            ]
        return tuple(
            (name, self._values.get(name)) for name in sorted(shape_params)
        )


# ---------------------------------------------------------------------------
# ConfigurationSpace
# ---------------------------------------------------------------------------


class ConfigurationSpace:
    def __init__(self):
        self._hyperparameters: Dict[str, Hyperparameter] = {}
        self._conditions: List[Condition] = []
        self._forbidden: List[Any] = []

    # -- building -----------------------------------------------------
    def add_hyperparameter(self, hp: Hyperparameter) -> Hyperparameter:
        if hp.name in self._hyperparameters:
            raise ValueError(f"Duplicate hyperparameter {hp.name}")
        self._hyperparameters[hp.name] = hp
        return hp

    def add_hyperparameters(self, hps: Sequence[Hyperparameter]):
        for hp in hps:
            self.add_hyperparameter(hp)
        return hps

    def add_condition(self, cond: Condition):
        if cond.child not in self._hyperparameters:
            raise ValueError(f"Unknown child {cond.child}")
        for parent in self._parents_of_condition(cond):
            if parent not in self._hyperparameters:
                raise ValueError(f"Unknown parent {parent}")
        self._conditions.append(cond)
        cycle = self._find_condition_cycle()
        if cycle is not None:
            self._conditions.pop()
            raise ValueError(
                "Condition cycle: " + " -> ".join(cycle)
                + " (activity of each depends on the next)"
            )
        return cond

    def _find_condition_cycle(self) -> Optional[List[str]]:
        """DFS over the child->parent dependency graph; returns a cycle
        as a name path, or None. Guards ``_is_active``'s recursion —
        ConfigSpace likewise rejects cyclic conditions at build time."""
        graph: Dict[str, List[str]] = {}
        for cond in self._conditions:
            graph.setdefault(cond.child, []).extend(
                self._parents_of_condition(cond)
            )
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {name: WHITE for name in self._hyperparameters}
        stack_path: List[str] = []

        def dfs(node: str) -> Optional[List[str]]:
            color[node] = GRAY
            stack_path.append(node)
            for parent in graph.get(node, ()):
                if color[parent] == GRAY:
                    return stack_path[stack_path.index(parent):] + [parent]
                if color[parent] == WHITE:
                    found = dfs(parent)
                    if found is not None:
                        return found
            stack_path.pop()
            color[node] = BLACK
            return None

        for name in graph:
            if color[name] == WHITE:
                found = dfs(name)
                if found is not None:
                    return found
        return None

    def add_conditions(self, conds: Sequence[Condition]):
        for c in conds:
            self.add_condition(c)
        return conds

    def add_forbidden_clause(self, clause):
        self._forbidden.append(clause)
        return clause

    def add_forbidden_clauses(self, clauses):
        for c in clauses:
            self.add_forbidden_clause(c)
        return clauses

    @staticmethod
    def _parents_of_condition(cond: Condition) -> List[str]:
        if isinstance(cond, AndConjunction):
            return [c.parent for c in cond.conditions]
        return [cond.parent]

    # -- introspection ------------------------------------------------
    def get_hyperparameter(self, name: str) -> Hyperparameter:
        return self._hyperparameters[name]

    def get_hyperparameters(self) -> List[Hyperparameter]:
        return list(self._hyperparameters.values())

    def get_hyperparameter_names(self) -> List[str]:
        return list(self._hyperparameters.keys())

    def get_conditions(self) -> List[Condition]:
        return list(self._conditions)

    @property
    def forbidden_clauses(self):
        return list(self._forbidden)

    def get_parents_of(self, hp) -> List[Hyperparameter]:
        name = _name_of(hp)
        parents = []
        for cond in self._conditions:
            if cond.child == name:
                for p in self._parents_of_condition(cond):
                    parents.append(self._hyperparameters[p])
        return parents

    def _conditions_on(self, name: str) -> List[Condition]:
        return [c for c in self._conditions if c.child == name]

    # -- activity resolution -----------------------------------------
    def _is_active(self, name: str, values: Dict[str, Any]) -> bool:
        conds = self._conditions_on(name)
        for cond in conds:
            subconds = (
                cond.conditions if isinstance(cond, AndConjunction) else [cond]
            )
            for sc in subconds:
                if not self._is_active(sc.parent, values):
                    return False
                if sc.parent not in values or not sc.holds(values[sc.parent]):
                    return False
        return True

    def _resolve(self, raw: Dict[str, Any]) -> Dict[str, Any]:
        """Keep only active hyperparameters; fill missing active ones with
        defaults. Iterates to a fixed point over condition chains."""
        values = dict(raw)
        for _ in range(len(self._hyperparameters) + 1):
            changed = False
            for name, hp in self._hyperparameters.items():
                active = self._is_active(name, values)
                if active and name not in values:
                    values[name] = hp.default_value
                    changed = True
                elif not active and name in values:
                    del values[name]
                    changed = True
            if not changed:
                break
        return values

    def _check_forbidden(self, values: Dict[str, Any]) -> bool:
        return any(f.violated(values) for f in self._forbidden)

    # -- configurations ----------------------------------------------
    def get_default_configuration(self) -> Configuration:
        values = {n: hp.default_value for n, hp in self._hyperparameters.items()}
        return Configuration(self, self._resolve(values))

    def sample_configuration(
        self, rng: Optional[np.random.Generator] = None, size: Optional[int] = None
    ):
        if rng is None:
            rng = np.random.default_rng()
        n = 1 if size is None else size
        out = []
        for _ in range(n):
            for _attempt in range(100):
                values = {
                    name: hp.sample(rng)
                    for name, hp in self._hyperparameters.items()
                }
                values = self._resolve(values)
                if not self._check_forbidden(values):
                    break
            out.append(Configuration(self, values))
        return out[0] if size is None else out

    def configuration_from_dict(self, d: Dict[str, Any]) -> Configuration:
        # Coerce numpy scalars / 0-d arrays to Python scalars first:
        # checkpoint round-trips (utils/checkpoint.py npz serialization)
        # hand values back as 0-d arrays, which would otherwise fail
        # is_legal's type checks (found by a resumed examples/5 run).
        d = {
            key: (val.item() if isinstance(val, np.generic)
                  or (isinstance(val, np.ndarray) and val.ndim == 0)
                  else val)
            for key, val in d.items()
        }
        for key, val in list(d.items()):
            if key not in self._hyperparameters:
                raise KeyError(f"Unknown hyperparameter {key}")
            hp = self._hyperparameters[key]
            if isinstance(hp, UniformFloatHyperparameter) and isinstance(
                val, float
            ):
                # Tolerate epsilon bound violations from older
                # checkpoints (pre-fix from_unit could decode u=1.0 to
                # upper + ~1e-11 on log-scale hps).
                tol = 1e-8 * max(abs(hp.lower), abs(hp.upper), 1.0)
                if hp.upper < val <= hp.upper + tol:
                    d[key] = val = hp.upper
                elif hp.lower - tol <= val < hp.lower:
                    d[key] = val = hp.lower
            if not hp.is_legal(val):
                raise ValueError(f"Illegal value {val!r} for {key}")
        return Configuration(self, self._resolve(dict(d)))

    # -- vectorized encoding (for the batched BO tuner) ---------------
    @property
    def encoded_width(self) -> int:
        return len(self._hyperparameters)

    def encode(self, cfg: Configuration) -> np.ndarray:
        """Encode to a fixed-width vector in [0,1]^d; inactive slots -> -1."""
        vec = np.full(self.encoded_width, -1.0)
        for i, (name, hp) in enumerate(self._hyperparameters.items()):
            if name in cfg:
                vec[i] = hp.to_unit(cfg[name])
        return vec

    def encode_batch(self, cfgs: Sequence[Configuration]) -> np.ndarray:
        return np.stack([self.encode(c) for c in cfgs])

    def decode(self, vec: np.ndarray) -> Configuration:
        values = {}
        for i, (name, hp) in enumerate(self._hyperparameters.items()):
            if vec[i] >= 0.0:
                values[name] = hp.from_unit(vec[i])
        return Configuration(self, self._resolve(values))

    def __repr__(self):
        lines = ["ConfigurationSpace:"]
        for hp in self._hyperparameters.values():
            lines.append(f"  {hp!r}")
        for c in self._conditions:
            lines.append(f"  {c!r}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Subspace surgery (reference semantics: autompc/utils/cs_utils.py)
# ---------------------------------------------------------------------------


def _get_subkey(key: str, delimiter: str) -> str:
    return delimiter.join(key.split(delimiter)[1:])


def set_subspace_configuration(
    cfg: Configuration, prefix: str, sub_cfg: Configuration, delimiter: str = ":"
):
    """Copy values from `cfg` under `prefix:` into `sub_cfg` (stripping the
    prefix). Mirrors cs_utils.py:136-141."""
    pfx = prefix + delimiter
    for key, val in cfg.get_dictionary().items():
        if key.startswith(pfx):
            sub_cfg[_get_subkey(key, delimiter)] = val
    return sub_cfg


def set_parent_configuration(
    cfg: Configuration, prefix: str, sub_cfg: Configuration, delimiter: str = ":"
):
    """Copy values from `sub_cfg` into `cfg` under `prefix:`. Mirrors
    cs_utils.py:150-153."""
    pfx = prefix + delimiter
    for key, val in sub_cfg.get_dictionary().items():
        cfg[pfx + key] = val
    return cfg


def add_configuration_space(
    space: ConfigurationSpace,
    prefix: str,
    sub_space: ConfigurationSpace,
    delimiter: str = ":",
    parent_hyperparameter: Optional[Dict[str, Any]] = None,
):
    """Merge `sub_space` into `space`, renaming every hyperparameter,
    condition, and forbidden clause to ``prefix + delimiter + name``.

    If ``parent_hyperparameter={"parent": hp, "value": v}`` is given, every
    *top-level* imported hyperparameter is additionally conditioned on
    ``hp == v``. Mirrors cs_utils.py:162-260.
    """

    def mapper(name: str) -> str:
        if name == "":
            return prefix
        return f"{prefix}{delimiter}{name}"

    new_names = []
    for hp in sub_space.get_hyperparameters():
        space.add_hyperparameter(hp.copy(mapper(hp.name)))
        new_names.append(mapper(hp.name))

    for cond in sub_space.get_conditions():
        space.add_condition(cond.rename(mapper))

    for forb in sub_space.forbidden_clauses:
        space.add_forbidden_clause(forb.rename(mapper))

    if parent_hyperparameter is not None:
        parent = parent_hyperparameter["parent"]
        value = parent_hyperparameter["value"]
        for name in new_names:
            # Only condition top-level params of the subspace (those with
            # no parents inside the subspace) — matches cs_utils.py:246-257.
            if space.get_parents_of(name):
                continue
            space.add_condition(EqualsCondition(name, parent, value))
    return space


def set_hyper_bounds(cs: ConfigurationSpace, hp_name: str, lower, upper):
    """Rebind the bounds of a numeric hyperparameter (cs_utils.py:262-276)."""
    hp = cs.get_hyperparameter(hp_name)
    default = hp.default_value
    if not (lower < default < upper):
        default = lower
    if isinstance(hp, UniformFloatHyperparameter):
        new_hp = UniformFloatHyperparameter(hp_name, lower, upper, default, hp.log)
    elif isinstance(hp, UniformIntegerHyperparameter):
        new_hp = UniformIntegerHyperparameter(hp_name, lower, upper, default, hp.log)
    else:
        raise ValueError("set_hyper_bounds requires a numeric hyperparameter")
    cs._hyperparameters[hp_name] = new_hp


def set_hyper_choices(cs: ConfigurationSpace, hp_name: str, choices):
    """Rebind the choices of a categorical (cs_utils.py:278-287)."""
    hp = cs.get_hyperparameter(hp_name)
    if not isinstance(hp, CategoricalHyperparameter):
        raise ValueError("set_hyper_choices requires a categorical hyperparameter")
    default = hp.default_value if hp.default_value in choices else choices[0]
    cs._hyperparameters[hp_name] = CategoricalHyperparameter(
        hp_name, choices, default
    )


def set_hyper_constant(cs: ConfigurationSpace, hp_name: str, value):
    """Replace a hyperparameter with a constant (cs_utils.py:289-293)."""
    cs._hyperparameters[hp_name] = Constant(hp_name, value)
