"""Builders of the port's serving replicas for the fleet tests, importable
without JAX: a ``ServeReplicaActor`` unpickles its builder by reference in
its own process, so the builders live in a module of their own (a
``functools.partial`` of a module-level function, never a lambda)."""
import time

import torch

from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params


def wait_for(cond, timeout=60.0, poll=0.005):
    """Poll ``cond`` until it holds; fails after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not met in time"
        time.sleep(poll)


def save_model(path, params, cfg):
    """Write ``(params, cfg)`` where :func:`saved_builder` reads them."""
    torch.save({"params": params, "cfg": cfg.to_dict()}, path)


def saved_builder(path):
    """The ``(params, cfg)`` that :func:`save_model` wrote (on the CPU), on
    two threads."""
    torch.set_num_threads(2)
    blob = torch.load(path, weights_only=False)
    return blob["params"], LlamaConfig.from_dict(blob["cfg"])


def seeded_builder(cfg_dict, seed, device):
    """Random weights of the config ``cfg_dict`` from a seeded generator on
    ``device``."""
    cfg = LlamaConfig.from_dict(dict(cfg_dict))
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(cfg, gen, device=device), cfg
