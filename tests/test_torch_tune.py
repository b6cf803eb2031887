"""The port's tune host logic (ray_lightning_tpu_torch/tune/search.py,
schedulers.py and the resource helpers of tune.py) held against the JAX
package's, exactly: the same configs from the same seed, the same
mutations from equal ``random.Random`` states, the same ASHA and PBT
decisions over the same result streams, the same bundles. Nothing here
starts a process."""
import random

import pytest

from ray_lightning_tpu import tune as jtune
from ray_lightning_tpu.tune import callbacks as jcallbacks
from ray_lightning_tpu.tune import schedulers as jsched
from ray_lightning_tpu.tune import search as jsearch
from ray_lightning_tpu_torch import tune
from ray_lightning_tpu_torch.tune import callbacks as tcallbacks
from ray_lightning_tpu_torch.tune import schedulers as tsched
from ray_lightning_tpu_torch.tune import search as tsearch


def _space(pkg, case):
    """One search space, built from ``pkg``'s own domains."""
    if case == "grid":
        return {"a": pkg.grid_search([1, 2, 3])}
    if case == "domains":
        return {"lr": pkg.loguniform(1e-5, 1e-1), "wd": pkg.uniform(0.0, 0.3),
                "layers": pkg.randint(1, 9), "act": pkg.choice(["relu", "gelu"])}
    if case == "mixed":
        return {"lr": pkg.loguniform(1e-4, 1e-1), "layer": pkg.grid_search([32, 64]),
                "fixed": 7, "drop": pkg.uniform(0.0, 0.5)}
    if case == "two_grids":
        return {"b": pkg.grid_search(["x", "y"]), "lr": pkg.uniform(0.1, 1.0),
                "c": pkg.grid_search([0.5, 1.5, 2.5]), "k": pkg.randint(0, 100)}
    return {"fixed": 1, "name": "n"}


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("num_samples", [1, 3])
@pytest.mark.parametrize("case", ["grid", "domains", "mixed", "two_grids", "fixed"])
def test_generate_trial_configs_matches_jax(case, num_samples, seed):
    got = tsearch.generate_trial_configs(_space(tsearch, case), num_samples, seed)
    want = jsearch.generate_trial_configs(_space(jsearch, case), num_samples, seed)
    assert got == want
    assert len(got) >= num_samples


def _const():
    return 0.125


def _mutations(pkg):
    return {"lr": pkg.loguniform(1e-4, 1e-1), "batch": [16, 32, 64],
            "layers": pkg.randint(1, 5), "momentum": _const,
            "absent": pkg.uniform(0.0, 1.0), "act": pkg.choice(["a", "b"])}


@pytest.mark.parametrize("seed", [0, 3, 11, 42])
def test_mutate_config_matches_jax(seed):
    """Fifty chained mutations from equal ``random.Random`` states: floats
    perturbed by 0.8/1.2, ints rounded, missing or non-numeric keys
    resampled; both rngs end in the same state."""
    config = {"lr": 1e-3, "batch": 32, "layers": 3, "momentum": 0.9, "act": "a"}
    trng, jrng = random.Random(seed), random.Random(seed)
    tconf, jconf = dict(config), dict(config)
    for _ in range(50):
        tconf = tsearch.mutate_config(tconf, _mutations(tsearch), trng)
        jconf = jsearch.mutate_config(jconf, _mutations(jsearch), jrng)
        assert tconf == jconf
    assert trng.random() == jrng.random()


def _stream(seed, n_trials, n_results, metric="loss"):
    """A seeded interleaving of results: (trial, metrics, iteration), with
    a missing metric now and then and an on_complete marker."""
    rng = random.Random(seed)
    iters = {f"t{i}": 0 for i in range(n_trials)}
    out = []
    for _ in range(n_results):
        trial = rng.choice(sorted(iters))
        iters[trial] += rng.choice([1, 1, 1, 2])
        if rng.random() < 0.05:
            out.append((trial, None, 0))  # on_complete
            iters[trial] = 0
            continue
        metrics = {"other": rng.random()}
        if rng.random() > 0.1:
            metrics[metric] = rng.choice([rng.random(), rng.uniform(-5, 5),
                                          float(rng.randint(0, 3))])
        out.append((trial, metrics, iters[trial]))
    return out


def _decisions(scheduler, stream):
    out = []
    for trial, metrics, iteration in stream:
        if metrics is None:
            scheduler.on_complete(trial)
            out.append("complete")
        else:
            out.append(scheduler.on_result(trial, metrics, iteration))
    return out


ASHA_CASES = [dict(metric="loss", mode="min", max_t=8, grace_period=2,
                   reduction_factor=2),
              dict(metric="loss", mode="max", max_t=100, grace_period=1,
                   reduction_factor=4),
              dict(metric="loss", mode="min", max_t=4, grace_period=1,
                   reduction_factor=2),
              dict(metric="loss", mode="min", max_t=27, grace_period=1,
                   reduction_factor=3)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("case", range(len(ASHA_CASES)))
def test_asha_decisions_match_jax(case, seed):
    stream = _stream(seed, n_trials=6, n_results=200)
    got = _decisions(tsched.ASHAScheduler(**ASHA_CASES[case]), stream)
    want = _decisions(jsched.ASHAScheduler(**ASHA_CASES[case]), stream)
    assert got == want
    assert any(d == ("STOP", None) for d in got)


PBT_CASES = [dict(metric="loss", mode="min", perturbation_interval=2,
                  quantile_fraction=0.34),
             dict(metric="loss", mode="max", perturbation_interval=3,
                  quantile_fraction=0.25),
             dict(metric="loss", mode="min", perturbation_interval=1,
                  quantile_fraction=0.5)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("case", range(len(PBT_CASES)))
def test_pbt_decisions_match_jax(case, seed):
    """Every decision, EXPLOIT's donor included, and the scheduler's rng
    afterwards (the controller mutates configs with it)."""
    stream = _stream(seed, n_trials=5, n_results=200)
    tpbt = tsched.PopulationBasedTraining(
        seed=seed, hyperparam_mutations=_mutations(tsearch), **PBT_CASES[case])
    jpbt = jsched.PopulationBasedTraining(
        seed=seed, hyperparam_mutations=_mutations(jsearch), **PBT_CASES[case])
    got, want = _decisions(tpbt, stream), _decisions(jpbt, stream)
    assert got == want
    assert any(d[0] == "EXPLOIT" for d in got if d != "complete")
    conf = {"lr": 1e-3, "batch": 32, "layers": 2, "momentum": 0.5, "act": "b"}
    assert tsearch.mutate_config(conf, tpbt.hyperparam_mutations, tpbt.rng) == \
        jsearch.mutate_config(conf, jpbt.hyperparam_mutations, jpbt.rng)


def test_fifo_always_continues():
    for sched in (tsched.FIFOScheduler(), jsched.FIFOScheduler()):
        assert sched.on_result("t", {"loss": 1.0}, 5) == ("CONTINUE", None)
    assert (tsched.CONTINUE, tsched.STOP, tsched.EXPLOIT) == (
        jsched.CONTINUE, jsched.STOP, jsched.EXPLOIT)


def test_get_tune_resources_bundles():
    """JAX's shape, the card's ``"GPU"`` in place of ``"TPU"``."""
    pgf = tune.get_tune_resources(num_workers=2, num_cpus_per_worker=3,
                                  use_gpu=True)
    jpgf = jtune.get_tune_resources(num_workers=2, num_cpus_per_worker=3,
                                    use_tpu=True)
    assert isinstance(pgf, tune.PlacementGroupFactory)
    assert pgf.strategy == jpgf.strategy == "PACK"
    assert pgf.bundles[0] == jpgf.bundles[0] == {"CPU": 1.0}
    assert len(pgf.bundles) == len(jpgf.bundles) == 3
    assert pgf.bundles[1] == {"CPU": 3.0, "GPU": 0.5}
    assert jpgf.bundles[1] == {"CPU": 3.0, "TPU": 0.5}
    assert pgf.total() == {"CPU": 7.0, "GPU": 1.0}
    cpu = tune.get_tune_resources(num_workers=2)
    assert cpu.bundles == jtune.get_tune_resources(num_workers=2).bundles
    assert all("GPU" not in b for b in cpu.bundles)
    assert tune.get_tune_resources(num_workers=4, use_gpu=True).total() == {
        "CPU": 5.0, "GPU": 1.0}


def test_get_tune_resources_refuses_use_tpu():
    with pytest.raises(ValueError, match="use_gpu"):
        tune.get_tune_resources(num_workers=2, use_tpu=True)


@pytest.mark.parametrize("demand,cluster,want", [
    ({"CPU": 7.0}, {"CPU": 64.0}, 9),
    ({"CPU": 7.0, "GPU": 1.0}, {"CPU": 64.0, "GPU": 2.0}, 2),
    ({"CPU": 128.0}, {"CPU": 64.0}, 1),
    ({}, {"CPU": 64.0}, 1),
    ({"CPU": 2.0, "GPU": 0.5}, {"CPU": 8.0, "GPU": 1.0}, 2),
    ({"CPU": 1.0, "GPU": 0.3}, {"CPU": 8.0, "GPU": 1.0}, 3),
    ({"CPU": 0.0, "GPU": 0.0}, {"CPU": 8.0}, 1),
])
def test_max_concurrent_for(demand, cluster, want):
    assert tune.max_concurrent_for(demand, cluster) == want
    jcluster = {("TPU" if k == "GPU" else k): v for k, v in cluster.items()}
    jdemand = {("TPU" if k == "GPU" else k): v for k, v in demand.items()}
    assert jtune.max_concurrent_for(jdemand, jcluster) == want


def test_exports_match_jax():
    assert tune.__all__ == jtune.__all__
    for name in tune.__all__:
        assert getattr(tune, name) is not None
    assert tune.TuneReportCallback is tcallbacks.TuneReportCallback
    assert tune.TuneReportCheckpointCallback is tcallbacks.TuneReportCheckpointCallback


@pytest.mark.parametrize("on", ["fit_end", "train_batch_end", ["validation_end", "x"]])
def test_tune_callback_refuses_unknown_hook_points(on):
    for mod in (tcallbacks, jcallbacks):
        with pytest.raises(ValueError, match="invalid hook point"):
            mod.TuneReportCallback("loss", on=on)
    assert tcallbacks.TuneCallback.VALID_ON == jcallbacks.TuneCallback.VALID_ON
