"""Shared pieces of the port's serving tests that hold it against the JAX
package: one tiny fp32 model in both packages, JAX's ``generate`` as the
reference, both packages' engines, and a fault script armed for both (the
port reads ``TORCHRT_FAULT``, the JAX package ``RLT_FAULT``)."""
import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ray_lightning_tpu.models.generation import generate
from ray_lightning_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from ray_lightning_tpu.models.llama import init_params as jax_init_params
from ray_lightning_tpu.runtime import faults as jax_faults
from ray_lightning_tpu.serving import EngineConfig as JaxEngineConfig
from ray_lightning_tpu.serving import InferenceEngine as JaxEngine
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.models.llama import LlamaConfig
from ray_lightning_tpu_torch.runtime import faults as port_faults
from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

# the paged engine both packages build in these tests (shipments are
# block chains)
PAGED_KW = dict(num_slots=4, max_prompt_len=16, max_len=32, max_queue=64,
                kv_layout="paged", block_size=4)


def tiny_models(dtype="float32"):
    """(jax params, jax cfg, port params, port cfg) of one tiny model."""
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jdtype)
    jparams = jax_init_params(jax.random.key(0), jcfg)
    tcfg = LlamaConfig.from_dict(jcfg.to_dict())
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, jcfg, params_from_jax(tree, tcfg, device="cpu"), tcfg


def reference(jparams, jcfg, prompt, n_new):
    out = generate(jparams, jnp.asarray([prompt], jnp.int32), jcfg,
                   max_new_tokens=n_new, temperature=0.0)
    return [int(t) for t in np.asarray(out)[0, len(prompt):]]


def port_engine(tparams, tcfg, replica_index=None, **kw):
    return InferenceEngine(tparams, tcfg, EngineConfig(**{**PAGED_KW, **kw}),
                           device="cpu", replica_index=replica_index)


def jax_engine(jparams, jcfg, replica_index=None, **kw):
    return JaxEngine(jparams, jcfg, JaxEngineConfig(**{**PAGED_KW, **kw}),
                     replica_index=replica_index)


def record_ticks(engine):
    """Wrap the engine's scheduler tick: returns the list that collects
    each tick's admitted request ids."""
    log = []
    tick = engine.scheduler.tick

    def recorded():
        plan = tick()
        log.append([req.request_id for req, _ in plan.prefills])
        return plan

    engine.scheduler.tick = recorded
    return log


def _reset_caches():
    for mod in (port_faults, jax_faults):
        mod._cache = (None, [])
        mod._serve_cache = (None, [])
        mod._migration_cache = (None, [])


@contextlib.contextmanager
def fault_env(spec):
    """Arm ``spec`` for both packages with no fuse directory; restore both
    variables and every parse cache on exit."""
    names = (port_faults.FAULT_ENV, jax_faults.FAULT_ENV,
             port_faults.FUSE_ENV, jax_faults.FUSE_ENV)
    old = {n: os.environ.pop(n, None) for n in names}
    os.environ[port_faults.FAULT_ENV] = spec
    os.environ[jax_faults.FAULT_ENV] = spec
    _reset_caches()
    try:
        yield
    finally:
        for n in names:
            os.environ.pop(n, None)
            if old[n] is not None:
                os.environ[n] = old[n]
        _reset_caches()


def two_threads():
    """Small shapes run fastest on two threads; returns the old count."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    return prev


def references(jparams, jcfg, reqs):
    """JAX ``generate``'s greedy stream of each ``(prompt, n_new)``: one
    batched call a prompt length at the group's largest ``n_new``, each row
    cut to its own (greedy decoding without EOS: the first n tokens of a
    longer stream are the n-token stream)."""
    by_len = {}
    for i, (prompt, n) in enumerate(reqs):
        by_len.setdefault(len(prompt), []).append(i)
    out = [None] * len(reqs)
    for plen, idx in by_len.items():
        n_max = max(reqs[i][1] for i in idx)
        batch = jnp.asarray([reqs[i][0] for i in idx], jnp.int32)
        toks = np.asarray(generate(jparams, batch, jcfg,
                                   max_new_tokens=n_max, temperature=0.0))
        for row, i in enumerate(idx):
            out[i] = [int(t) for t in toks[row, plen:plen + reqs[i][1]]]
    return out


def random_requests(vocab, n, seed, lo=4, hi=8, plen=5):
    """``n`` seeded ``(prompt, n_new)`` pairs: prompts of ``plen`` tokens in
    [1, vocab), budgets in [lo, hi)."""
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(1, vocab, plen)],
             int(rng.integers(lo, hi))) for _ in range(n)]
