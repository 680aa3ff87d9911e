"""Gloo worlds for the port's multi-process tests on the CPU.

:func:`run_world` starts ``world`` processes with ``torch.multiprocessing``
(spawn), each joins a gloo process group that rendezvous through a file
in the test's temporary directory (no TCP port, so concurrent test
workers never collide), runs one case of :data:`CASES` and saves its
numpy results with ``np.savez``; the caller gets every rank's results.
This module imports no JAX (the children import it), and its children
run one torch thread each.

Run as a script it is the ``torchrun`` entry of the launch test: it sets
``TrainConfig.checkpoint_every`` to 2 in ``repro_torch.launch.train``'s
namespace, so that a two-step run writes a checkpoint, and calls its
``main`` with the remaining arguments.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import sys
import time

import numpy as np

TIMEOUT = 240


def run_world(case: str, world: int, tmp, timeout: float = TIMEOUT, **kw) -> list:
    """Run ``CASES[case](**kw)`` on every rank of a gloo world of ``world``
    ranks; returns each rank's {name: array} in rank order."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_entry, args=(case, world, str(tmp), kw), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"gloo world {case!r} of {world} ranks took over {timeout} s")
    out = []
    for r in range(world):
        with np.load(os.path.join(str(tmp), f"{case}_{r}.npz")) as f:
            out.append({k: f[k] for k in f.files})
    return out


def _entry(rank, case, world, tmp, kw):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/{case}.store", rank=rank,
                            world_size=world)
    try:
        out = CASES[case](**kw)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(tmp, f"{case}_{rank}.npz"), **out)


# --- shared by the cases and the tests ----------------------------------------

def token_batch(vocab: int, rows: int, seq: int, seed: int = 0) -> dict:
    toks = np.random.default_rng(seed).integers(0, vocab, (rows, seq + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def moe_config(arch: str, **moe_kw):
    """The port's reduced ``arch`` with the MoE overrides ``moe_kw``."""
    from repro_torch.configs import get_config, reduced_config
    cfg = reduced_config(get_config(arch))
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))


def step_config(arch: str):
    """The step cases' config: reduced ``arch``; an MoE arch without its
    auxiliary loss (its per-shard form is not the single-device one) and
    dropless (capacity factor E / k, the reduced config's)."""
    from repro_torch.configs import get_config, reduced_config
    if arch == "mixtral-8x7b":
        return moe_config(arch, aux_loss_coef=0.0)
    return reduced_config(get_config(arch))


def flat(tree, prefix: str) -> dict:
    """{prefix/path: numpy} of a tree of tensors."""
    from repro_torch import sharding
    return {f"{prefix}/{p}": t.detach().cpu().numpy() for p, t in sharding.tree_paths(tree)}


def init_params(cfg, seed: int = 0):
    import torch
    from repro_torch.models.transformer import Model
    gen = torch.Generator()
    gen.manual_seed(seed)
    return Model(cfg, device="cpu").init(gen)


# --- cases --------------------------------------------------------------------

def _sharded_step_runs(mesh, arch, runs, rows, seq, ocfg_kw, fault=False):
    """For each (microbatch, compression, remat) of ``runs``: one sharded
    step on ``mesh`` from ``init_params``; the gathered params, m and v,
    loss and grad-norm."""
    import torch
    from repro_torch import collectives, sharding
    from repro_torch.configs.base import OptimConfig, TrainConfig
    from repro_torch.launch.train import shard_batch
    from repro_torch.models.transformer import Model
    from repro_torch.runtime.train_loop import init_opt_state, make_train_step

    cfg = step_config(arch)
    da = sharding.data_axes(mesh)
    model = Model(cfg, device="cpu", dist=(mesh, da))
    full = init_params(cfg)
    specs = sharding.params_shardings(full, mesh)
    batch = {k: torch.from_numpy(v) for k, v in
             shard_batch(token_batch(cfg.vocab_size, rows, seq), mesh).items()}
    real = collectives._ReduceFrom.backward
    if fault:   # the combine's cotangent summed over the model axis again
        collectives._ReduceFrom.backward = staticmethod(
            lambda ctx, g: (collectives.all_reduce(g.clone(), ctx.mesh, ctx.entry), None, None))
    out = {}
    try:
        for mb, comp, remat in runs:
            tcfg = TrainConfig(seq_len=seq, global_batch=rows, microbatch=mb,
                               grad_compression=comp, remat=remat)
            params = sharding.local_shard_tree(full, specs, mesh)
            opt = init_opt_state(tcfg, params)
            step = make_train_step(model, OptimConfig(**ocfg_kw), tcfg, data_axes=da,
                                   grad_shardings=specs)
            params, opt, m = step(params, opt, batch)
            tag = f"{arch}/{mb}/{comp}/{remat}"
            out.update(flat(sharding.gather_tree(params, specs, mesh), f"{tag}/p"))
            for k in ("m", "v"):
                out.update(flat(sharding.gather_tree(opt["adam"][k], specs, mesh), f"{tag}/{k}"))
            out[f"{tag}/loss"] = np.asarray(float(m["loss"]))
            out[f"{tag}/grad_norm"] = np.asarray(float(m["grad_norm"]))
            out[f"{tag}/local_bytes"] = np.asarray(sum(
                t.numel() * t.element_size() for _, t in sharding.tree_paths(params)))
    finally:
        collectives._ReduceFrom.backward = real
    return out


def case_steps(shape, steps, decode=None):
    """The (2, 2) world's cases: ``steps`` {name: (arch, runs, rows, seq,
    ocfg_kw, fault)}, then ``decode`` (an MoE arch, rows, max_len): the
    reduced model's first decode step on the rank's rows with params kept
    by the serve_tp profile and gathered, its logits gathered over the
    data axes."""
    import torch
    from repro_torch import collectives, sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model

    mesh = make_mesh(shape, ("data", "model"))
    out = {}
    for name, (arch, runs, rows, seq, ocfg_kw, fault) in steps.items():
        out.update({f"{name}/{k}": v for k, v in _sharded_step_runs(
            mesh, arch, runs, rows, seq, ocfg_kw, fault).items()})
    if decode is not None:
        arch, rows, max_len = decode
        cfg = moe_config(arch)
        full = init_params(cfg)
        specs = sharding.params_shardings(full, mesh, profile="serve_tp")
        kept = sharding.local_shard_tree(full, specs, mesh)
        params = sharding.gather_tree(kept, specs, mesh)
        da = sharding.data_axes(mesh)
        model = Model(cfg, device="cpu", dist=(mesh, da))
        entry = sharding.batch_pspec((rows,), mesh)[0]
        local = rows // mesh.axis_size(entry)
        cache = model.init_cache(local, max_len, kind="auto")
        with torch.no_grad():
            logits, _ = model.decode_step(params, cache, tokens=torch.ones(local, dtype=torch.long))
        out["decode/logits"] = collectives.all_gather(logits, mesh, entry, 0).numpy()
        out["decode/kept_bytes"] = np.asarray(sum(
            t.numel() * t.element_size() for _, t in sharding.tree_paths(kept)))
    return out


def case_moe(shape, inputs, configs):
    """``apply_sharded`` on ``shape`` (data, model) for each {name: moe
    overrides} of ``configs`` on the reduced mixtral: params and x [B, S,
    D] from ``inputs`` (an npz: ``<name>/x`` and the layer's leaves under
    ``<name>/p/...``); y gathered over the data axes, and aux."""
    import torch
    from repro_torch import collectives, sharding
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    mesh = make_mesh(shape, ("data", "model"))
    out = {}
    with np.load(inputs) as f:
        data = {k: f[k] for k in f.files}
    for name, kw in configs.items():
        cfg = ModelConfig(**{**kw["model"], "moe": MoEConfig(**kw["moe"])})
        p = {"router": {"kernel": torch.from_numpy(data[f"{name}/p/router/kernel"])}}
        for w in ("wi_gate", "wi_up", "wo"):
            p[w] = torch.from_numpy(data[f"{name}/p/{w}"])
        x = torch.from_numpy(data[f"{name}/x"])
        entry = sharding.batch_pspec(x.shape, mesh)[0]
        xl = sharding.local_shard(x, sharding.batch_pspec(x.shape, mesh), mesh)
        with torch.no_grad():
            y, aux = moe.apply_sharded(cfg, p, xl, mesh, sharding.data_axes(mesh))
        out[f"{name}/y"] = collectives.all_gather(y, mesh, entry, 0).numpy()
        out[f"{name}/aux"] = np.asarray(float(aux))
    return out


def case_layout(shape, axes, specs):
    """``local_shard`` and ``gather`` of one seeded tensor a spec: each
    rank's block and the gathered whole."""
    import torch
    from repro_torch import sharding
    from repro_torch.launch.mesh import make_mesh

    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_mesh(shape, axes)
    out = {"coords": np.asarray([mesh.coords[a] for a in axes])}
    for n in range(1, len(axes) + 1):
        for sub in itertools.combinations(axes, n):
            out["group/" + ",".join(sub)] = np.asarray(mesh.group_ranks(sub))
    refused = []
    for make in (lambda: make_mesh((2,) + tuple(shape), ("pod",) + tuple(axes)),
                 make_production_mesh, lambda: make_production_mesh(multi_pod=True)):
        try:
            make()
        except ValueError:
            refused.append(True)
    out["refused"] = np.asarray(len(refused))
    for i, (tshape, spec) in enumerate(specs):
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        gen = torch.Generator()
        gen.manual_seed(i)
        full = torch.randn(tshape, generator=gen)
        local = sharding.local_shard(full, spec, mesh)
        out[f"{i}/local"] = local.numpy()
        out[f"{i}/gathered"] = sharding.gather(local, spec, mesh).numpy()
    tree = {"a": torch.arange(8.0).reshape(4, 2), "b": [torch.arange(12.0)]}
    tspec = {"a": ("data", None), "b": [(tuple(axes),)]}
    back = sharding.gather_tree(sharding.local_shard_tree(tree, tspec, mesh), tspec, mesh)
    out["tree_equal"] = np.asarray(torch.equal(back["a"], tree["a"])
                                   and torch.equal(back["b"][0], tree["b"][0]))
    return out


def case_pipeline(inputs, micros):
    """``pipeline_apply`` on a (4,) "stage" mesh, with the params and x of
    ``inputs`` (an npz: w [S, D, D], b [S, D], x [B, D])."""
    import torch
    from repro_torch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.pipeline import pipeline_apply

    with np.load(inputs) as f:
        w, b, x = (torch.from_numpy(f[k]) for k in ("w", "b", "x"))
    mesh = make_mesh((w.shape[0],), ("stage",))
    params = sharding.local_shard_tree({"w": w, "b": b},
                                       {"w": ("stage", None, None), "b": ("stage", None)}, mesh)

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    return {f"y{m}": pipeline_apply(stage_fn, params, x, mesh=mesh, num_micro=m).numpy()
            for m in micros}


CASES = {"steps": case_steps, "moe": case_moe, "layout": case_layout,
         "pipeline": case_pipeline}


def _train_main(argv):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train
    train.TrainConfig = lambda **kw: TrainConfig(**{**kw, "checkpoint_every": 2})
    train.main(argv)


if __name__ == "__main__":
    _train_main(sys.argv[1:])
