"""Search-space primitives (``ray_lightning_tpu/tune/search.py``, a copy):
the domains, the grid cross product and PBT's mutation, all drawn from a
``random.Random``, so one seed gives the JAX package's configs."""
from __future__ import annotations

import itertools
import math
import random
from typing import Any, Dict, List, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        assert low > 0 and high > low
        self.low, self.high = low, high

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


class RandInt(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class GridSearch:
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(values)


def generate_trial_configs(
    config: Dict[str, Any], num_samples: int, seed: int = 0
) -> List[Dict[str, Any]]:
    """Expand grid axes (cross product) × num_samples random draws of the
    stochastic domains — ray.tune semantics."""
    config = dict(config or {})
    grid_keys = [k for k, v in config.items() if isinstance(v, GridSearch)]
    grids = (
        list(itertools.product(*[config[k].values for k in grid_keys]))
        if grid_keys
        else [()]
    )
    rng = random.Random(seed)
    out: List[Dict[str, Any]] = []
    for _ in range(num_samples):
        for combo in grids:
            trial_conf: Dict[str, Any] = {}
            for k, v in config.items():
                if isinstance(v, GridSearch):
                    trial_conf[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    trial_conf[k] = v.sample(rng)
                else:
                    trial_conf[k] = v
            out.append(trial_conf)
    return out


def mutate_config(
    config: Dict[str, Any],
    mutations: Dict[str, Any],
    rng: random.Random,
) -> Dict[str, Any]:
    """PBT explore step: resample or perturb (×0.8 / ×1.2) mutated keys."""
    new = dict(config)
    for key, spec in mutations.items():
        if rng.random() < 0.25 or key not in new or not isinstance(new[key], (int, float)):
            if isinstance(spec, Domain):
                new[key] = spec.sample(rng)
            elif isinstance(spec, (list, tuple)):
                new[key] = rng.choice(list(spec))
            elif callable(spec):
                new[key] = spec()
        else:
            factor = 0.8 if rng.random() < 0.5 else 1.2
            value = new[key] * factor
            if isinstance(new[key], int):
                value = max(1, int(round(value)))
            new[key] = value
    return new
