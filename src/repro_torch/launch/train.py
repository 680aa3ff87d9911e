"""Training entry point of the port (counterpart of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        --steps 3 --seq 4096 --batch 2 --microbatch 1 --remat full \\
        [--ckpt DIR] [--smoke] [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
        --steps 3 --seq 4096 --batch 8 --microbatch 4 --remat full

Wires together: config registry -> model with random float32 master
weights from a seed, drawn on the device -> train step (microbatch
accumulation, remat, AdamW with the arch's schedule) -> deterministic
synthetic token stream (``SyntheticSource(seed=1234)``, as the
reference) with a prefetch thread -> checkpoints with resume: with
``--ckpt DIR`` the run restores params and optimizer state from the
newest complete checkpoint there, starts the stream at its step, and
saves every ``TrainConfig.checkpoint_every`` steps in the background
(``checkpoint/checkpointer.py``) -> a ``HealthMonitor`` beat each step
(the reference builds its ``StragglerPolicy`` and drops it).  Prints the
reference's per-step line (loss, lr, grad-norm, tokens/s).  Runs on the
CUDA card unless ``--device cpu``; ``--smoke`` takes the reduced config
(seq <= 128, batch <= 8).

``--mesh DxM`` (data x model) or ``PxDxM`` (pod x data x model): a mesh
of size 1 keeps the single-device path, as the reference's ``use_dist =
mesh.size > 1``.  A larger mesh must be started by ``torchrun`` (one
process a rank; ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), whose world
must be the mesh:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2.5-3b --smoke --mesh 2x2 --steps 2          # NCCL, cuda:LOCAL_RANK
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2.5-3b --smoke --mesh 2x2 --steps 2 --device cpu   # gloo

Each rank draws the full params from the seed and keeps its shards
(``sharding.params_shardings``, profile "2d"), reads the same seeded
stream and takes its rows (``sharding.batch_pspec``), and trains through
the sharded step (``runtime/train_loop.py``); rank 0 prints.  ``--ckpt``
saves the full tree in the single-device layout: every rank gathers the
leaves one by one and rank 0 writes them; a restore reads the full tree
on every rank and keeps each rank's shards, so a checkpoint crosses
between mesh shapes (and packages).  Each rank beats its own
``HealthMonitor``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sharding as shd
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ARCH_IDS, get_config, get_optim, reduced_config
from repro_torch.configs.base import ModelConfig, OptimConfig, TrainConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticSource, TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.transformer import build_model
from repro_torch.runtime.elastic import HealthMonitor
from repro_torch.runtime.train_loop import init_opt_state, make_train_step
from repro_torch.tree import map_tree


def parse_mesh(spec: str):
    """"DxM" -> ((D, M), ("data", "model")); "PxDxM" adds "pod" in front."""
    dims = tuple(int(x) for x in spec.split("x"))
    axes = ("pod", "data", "model")[-len(dims):] if len(dims) == 3 else ("data", "model")
    return dims, axes


def build(cfg: ModelConfig, tcfg: TrainConfig, ocfg: OptimConfig, *,
          seed: int = 0, device=None, mesh=None):
    """(model, params, optimizer state, train step): float32 master weights
    drawn on the device from ``seed``.  With ``mesh`` (a ``Mesh`` of the
    world), params and state are this rank's shards and the step is the
    sharded one."""
    if mesh is None:
        model = build_model(cfg, device=device)
    else:
        model = build_model(cfg, device=device, dist=(mesh, shd.data_axes(mesh)))
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    params = model.init(gen)
    if mesh is None:
        return model, params, init_opt_state(tcfg, params), make_train_step(model, ocfg, tcfg)
    specs = shd.params_shardings(params, mesh)
    params = shd.local_shard_tree(params, specs, mesh)
    step = make_train_step(model, ocfg, tcfg, data_axes=shd.data_axes(mesh),
                           grad_shardings=specs)
    return model, params, init_opt_state(tcfg, params), step


class ShardedCheckpointer:
    """Checkpoints of a sharded run in the single-device layout.  ``save``
    gathers the leaves one by one on every rank (the same order on each)
    and rank 0 writes the full tree; ``restore`` reads the full tree on
    every rank and keeps the rank's shards."""

    def __init__(self, directory: str, mesh, specs):
        self.mesh, self.specs = mesh, specs
        # rank 0 first: a Checkpointer removes the .tmp dirs it finds
        self.inner = Checkpointer(directory) if mesh.rank == 0 else None
        dist.barrier()
        if self.inner is None:
            self.inner = Checkpointer(directory)

    def _state_specs(self, tree):
        """{"params", "opt"}'s spec tree: m, v (and ef) split like the params."""
        opt = {"adam": {"m": self.specs, "v": self.specs, "step": None}}
        if "ef" in tree["opt"]:
            opt["ef"] = self.specs
        return {"params": self.specs, "opt": opt}

    def save(self, step: int, tree):
        rank0 = self.mesh.rank == 0

        def host(t, spec):
            if not isinstance(t, torch.Tensor):
                return t
            full = shd.gather(t, spec, self.mesh)
            return full.cpu() if rank0 else None

        full = map_tree(host, tree, self._state_specs(tree))
        if rank0:
            self.inner.save(step, full)

    def wait(self):
        self.inner.wait()

    def latest_step(self):
        return self.inner.latest_step()

    def restore(self, step: int, like_tree):
        """The rank's shards of checkpoint ``step``, on ``like_tree``'s
        devices (``like_tree``: this rank's shards)."""
        specs = self._state_specs(like_tree)

        def full_like(t, spec):
            if not isinstance(t, torch.Tensor):
                return t
            shape = [n * self.mesh.axis_size(e) for n, e in zip(t.shape, spec)]
            return torch.empty(shape, dtype=t.dtype)

        full = self.inner.restore(step, map_tree(full_like, like_tree, specs))
        return map_tree(lambda f, t, spec: shd.local_shard(f, spec, self.mesh).to(t.device)
                        if isinstance(t, torch.Tensor) else f, full, like_tree, specs)


def shard_batch(batch, mesh):
    """This rank's rows of a {name: numpy [B, ...]} batch
    (``sharding.batch_pspec``; the whole batch where B does not divide)."""
    out = {}
    for k, v in batch.items():
        entry = shd.batch_pspec(v.shape, mesh)[0]
        if entry is not None:
            n = v.shape[0] // mesh.axis_size(entry)
            v = v[mesh.index(entry) * n:(mesh.index(entry) + 1) * n]
        out[k] = v
    return out


class _RankRows:
    """A batch source that hands out this rank's rows of ``source``'s."""

    def __init__(self, source, mesh):
        self.source, self.mesh = source, mesh

    def next(self):
        return shard_batch(self.source.next(), self.mesh)


def to_device(batch, device):
    """{"tokens", "labels"} numpy batch -> int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device=device,
                                                            dtype=torch.int64)
            for k, v in batch.items()}


def train(step_fn, params, opt, source, steps: int, *, device,
          log_every: int = 10, on_step=None, start: int = 0, ckpt=None,
          checkpoint_every: int = 0, monitor=None, scale_tokens: int = 1):
    """Run steps ``start + 1`` .. ``steps`` on batches from
    ``source.next()`` (a stream already at ``start``).  Each step's time
    runs from fetching its batch to its loss on the host (which waits for
    the device).  ``on_step(record)`` sees each step's record {"step",
    "loss", "lr", "grad_norm", "seconds", "tokens_per_s"}.  With ``ckpt``
    (a ``Checkpointer``), {"params", "opt"} is saved, non-blocking, after
    every step whose number ``checkpoint_every`` divides; ``monitor`` (a
    ``HealthMonitor``) gets a beat each step.  ``log_every`` 0 prints
    nothing; ``scale_tokens``: the data shards whose rows make the global
    batch (tokens/s counts them all).  Returns (params, opt, records)."""
    records = []
    for s in range(start, steps):
        t0 = time.perf_counter()
        batch = to_device(source.next(), device)
        params, opt, m = step_fn(params, opt, batch)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        if monitor is not None:
            monitor.beat(0)
        tokens = batch["tokens"].numel() * scale_tokens
        rec = {"step": s + 1, "loss": loss, "lr": m["lr"],
               "grad_norm": float(m["grad_norm"]), "seconds": dt,
               "tokens_per_s": tokens / max(dt, 1e-9)}
        if log_every and (s + 1) % log_every == 0:
            print(f"step {s + 1:5d} loss {loss:.4f} lr {rec['lr']:.2e} "
                  f"gnorm {rec['grad_norm']:.2f} tok/s {rec['tokens_per_s']:,.0f}",
                  flush=True)
        if on_step is not None:
            on_step(rec)
        records.append(rec)
        if ckpt is not None and checkpoint_every and (s + 1) % checkpoint_every == 0:
            ckpt.save(s + 1, {"params": params, "opt": opt})
    return params, opt, records


def init_world(args, size: int):
    """Join the ``torchrun`` world of a mesh of ``size`` ranks (NCCL on
    ``cuda:LOCAL_RANK``, gloo with ``--device cpu``); returns the rank's
    device.  Raises outside ``torchrun`` or when the world is not the
    mesh: nothing falls back to one process."""
    missing = [k for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--mesh {args.mesh} spans {size} ranks: start the run with "
                           f"torchrun, one process a rank (missing {', '.join(missing)})")
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if world != size:
        raise ValueError(f"--mesh {args.mesh} needs {size} ranks, torchrun started {world}")
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://", world_size=world, rank=rank)
    return device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM or PxDxM; a mesh of more than one rank runs under torchrun")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="full", choices=("none", "full", "dots"))
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda")
    args = ap.parse_args(argv)
    dims, axes = parse_mesh(args.mesh)
    size = int(np.prod(dims))
    use_dist = size > 1
    device = init_world(args, size) if use_dist else resolve_device(args.device)
    try:
        return _run(args, dims, axes, device, use_dist)
    finally:
        if use_dist:
            dist.destroy_process_group()


def _run(args, dims, axes, device, use_dist):
    mesh = make_mesh(dims, axes) if use_dist else None
    rank0 = mesh is None or mesh.rank == 0
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
        args.seq = min(args.seq, 128)
        args.batch = min(args.batch, 8)
    ocfg = get_optim(args.arch)
    tcfg = TrainConfig(seq_len=args.seq, global_batch=args.batch,
                       microbatch=args.microbatch, remat=args.remat)
    if rank0:
        print(f"arch={cfg.name} params={cfg.param_count() / 1e9:.2f}B "
              f"mesh={dims} remat={args.remat} device={device}", flush=True)
    _, params, opt, step_fn = build(cfg, tcfg, ocfg, seed=0, device=device, mesh=mesh)
    start = 0
    ck = None
    if args.ckpt:
        ck = (ShardedCheckpointer(args.ckpt, mesh, step_fn.specs) if use_dist
              else Checkpointer(args.ckpt))
    if ck is not None:
        latest = ck.latest_step()
        if latest is not None:
            if rank0:
                print(f"resuming from checkpoint step {latest}", flush=True)
            state = ck.restore(latest, {"params": params, "opt": opt})
            params, opt, start = state["params"], state["opt"], latest
    stream = TokenStream(SyntheticSource(cfg.vocab_size, seed=1234),
                         global_batch=args.batch, seq_len=args.seq, start_step=start)
    pf = Prefetcher(stream, depth=2)
    source = _RankRows(pf, mesh) if use_dist else pf
    rows_entry = shd.batch_pspec((args.batch,), mesh)[0] if use_dist else None
    shards = mesh.axis_size(rows_entry) if rows_entry else 1
    try:
        _, _, records = train(step_fn, params, opt, source, args.steps, device=device,
                              log_every=args.log_every if rank0 else 0, start=start,
                              ckpt=ck, checkpoint_every=tcfg.checkpoint_every,
                              monitor=HealthMonitor(), scale_tokens=shards)
    finally:
        pf.close()
        if ck is not None:
            ck.wait()
    return records


if __name__ == "__main__":
    main()
