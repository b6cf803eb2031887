"""Module-level helpers for the port's worker-process tests
(tests/test_torch_ray_strategy.py, tests/test_torch_expert_parallel.py,
tests/test_torch_cuda.py). Workers import them by reference from the main
process's sys.path, so this module imports neither JAX nor the JAX
package."""
import numpy as np
import torch

from ray_lightning_tpu_torch.callbacks import Callback

# what the main-process callables in the session queue append to
RECEIVED = []


class RankLosses(Callback):
    """Each step's loss of every rank (gathered over the process group in
    the workers); the list reaches the main process's copy of the callback
    through the callback states rank 0 sends back."""

    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        import torch.distributed as dist

        loss = outputs["loss"].detach().float().reshape(1).cpu()
        if dist.is_initialized():
            parts = [torch.zeros(1) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, loss)
            self.losses.append([float(p) for p in parts])
        else:
            self.losses.append([float(loss)])

    def state_dict(self):
        return {"losses": self.losses}

    def load_state_dict(self, state):
        self.losses = state["losses"]


class BroadcastProbe(Callback):
    """At the end of fit every rank calls the strategy's ``broadcast_host``
    (rank 0's object) and ``barrier``; what each rank received is gathered
    to rank 0 and comes back to the main process in the callback states."""

    def __init__(self):
        self.received = []

    def on_fit_end(self, trainer, module):
        import torch.distributed as dist

        got = trainer.strategy.broadcast_host(
            {"from": trainer.global_rank}, src=0)
        trainer.strategy.barrier()
        parts = [None] * trainer.world_size
        dist.all_gather_object(parts, got)
        self.received = parts

    def state_dict(self):
        return {"received": self.received}

    def load_state_dict(self, state):
        self.received = state["received"]


class GlobalBatchSampler:
    """The single-process reference of a world of ``world`` ranks: at step
    b, rank 0's batch b, then rank 1's, ... (each rank's indices are the
    DistributedSampler's: a strided slice of one seeded permutation per
    epoch), so a loader of batch ``world * batch`` sees the union of the
    ranks' batches."""

    def __init__(self, n, world, batch, seed, shuffle=True):
        self.n, self.world, self.batch, self.seed = n, world, batch, seed
        self.shuffle = shuffle  # False: the unshuffled validation shards
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return (self.n // self.world) // self.batch * self.batch * self.world

    def __iter__(self):
        perm = (np.random.default_rng(self.seed + self.epoch).permutation(self.n)
                if self.shuffle else np.arange(self.n))
        per_rank = [perm[r::self.world] for r in range(self.world)]
        out = []
        for b in range(len(per_rank[0]) // self.batch):
            for r in range(self.world):
                out.extend(per_rank[r][b * self.batch:(b + 1) * self.batch])
        return iter([int(i) for i in out])


class Echo:
    """A small actor: echoes, raises, and reports its rank's session."""

    def __init__(self, tag):
        self.tag = tag

    def echo(self, x):
        return (self.tag, x)

    def fail(self):
        raise ValueError("planted failure in an actor")

    def put_through_session(self, queue_handle, value):
        from ray_lightning_tpu_torch import session

        session.reset_session()
        session.init_session(rank=3, queue=queue_handle)
        session.put_queue(Record(session.get_actor_rank(), value))
        return session.get_actor_rank()


class Record:
    """A callable a worker puts into the session queue; the main process runs it."""

    def __init__(self, rank, value):
        self.rank, self.value = rank, value

    def __call__(self):
        RECEIVED.append((self.rank, self.value))


def ep_moe_worker(rank, world, init_method, inputs_path, out_path):
    """One member of an ep group of ``world`` processes over gloo: for each
    case of ``inputs_path`` (whole MoE params, x, the output's and the aux
    loss's cotangents, top_k, capacity_factor), ``moe_ffn_local_experts``
    on this member's slice of the experts, then backward; saves the
    output, aux and the gradients of the router, x and the slice to
    ``out_path.format(rank)``."""
    import torch.distributed as dist

    from ray_lightning_tpu_torch.parallel.moe import moe_ffn_local_experts

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    try:
        group = dist.new_group(list(range(world)))
        results = []
        for case in torch.load(inputs_path, weights_only=True):
            e_local = case["params"]["w_gate"].shape[0] // world
            local = {k: (v if k == "router" else
                         v[rank * e_local:(rank + 1) * e_local]).clone()
                     .requires_grad_(True)
                     for k, v in case["params"].items()}
            x = case["x"].clone().requires_grad_(True)
            out, aux = moe_ffn_local_experts(
                local, x, group, top_k=case["top_k"],
                capacity_factor=case["capacity_factor"])
            ((out * case["out_ct"]).sum() + aux * case["aux_ct"]).backward()
            results.append({"out": out.detach(), "aux": aux.detach(),
                            "x": x.grad,
                            **{k: v.grad for k, v in local.items()}})
        torch.save(results, out_path.format(rank))
    finally:
        dist.destroy_process_group()


class Probe:
    """An actor that reports on its own process (the zygote tests)."""

    def __init__(self, start=0):
        self.x = start

    def incr(self, by=1):
        self.x += by
        return self.x

    def facts(self, key):
        import os

        return {"pid": os.getpid(), "ppid": os.getppid(),
                "env": os.environ.get(key), "threads": torch.get_num_threads(),
                "cuda_initialized": torch.cuda.is_initialized()}


class Boom:
    """An actor whose constructor raises."""

    def __init__(self):
        raise RuntimeError("ctor kaboom")


class KernelProbe:
    """An actor that launches the RMSNorm kernel on the card and reports
    its launches (the zygote's card test)."""

    def rmsnorm_on_card(self):
        from ray_lightning_tpu_torch import kernels
        from ray_lightning_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_plain

        kernels.reset_launch_counts()
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(8, 4096, generator=g, device="cuda").bfloat16()
        w = torch.randn(4096, generator=g, device="cuda").bfloat16()
        err = float((rmsnorm(x, w, 1e-5).float()
                     - rmsnorm_plain(x, w, 1e-5).float()).abs().max())
        return {"launches": kernels.launch_counts(), "max_abs_err": err,
                "device": torch.cuda.get_device_name(0)}
